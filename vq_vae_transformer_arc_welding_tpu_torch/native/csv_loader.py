"""Numpy-facing wrapper for the native ASIMoW CSV parser."""
from __future__ import annotations

import ctypes

import numpy as np

from .build import load_native_lib

CYCLE_LEN = 200   # samples per cycle, the parser's compiled-in row layout


def native_available() -> bool:
    return load_native_lib() is not None


def parse_asimow_csv_native(path: str):
    """CSV -> (vi (N, 200, 2) f32, labels, experiment, welding_run) via
    the C++ parser. Returns None if the native library is unavailable or
    the file cannot be parsed (callers fall back to the Python parser)."""
    lib = load_native_lib()
    if lib is None:
        return None
    bpath = path.encode()
    n = lib.asimow_count_rows(bpath)
    if n <= 0:
        return None
    vi = np.empty((n, CYCLE_LEN, 2), np.float32)
    labels = np.empty((n,), np.int64)
    experiment = np.empty((n,), np.int64)
    welding_run = np.empty((n,), np.int64)
    got = lib.asimow_parse(
        bpath,
        vi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        experiment.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        welding_run.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n)
    if got <= 0:
        return None
    if got < n:
        vi, labels = vi[:got], labels[:got]
        experiment, welding_run = experiment[:got], welding_run[:got]
    return vi, labels, experiment, welding_run
