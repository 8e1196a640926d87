"""ASIMoW dataset pipeline: CSV -> packed device-ready arrays.

Own copy of vq_vae_transformer_arc_welding_tpu/data/asimow.py, the same
arrays from the same file, and with `window_mode='ondevice'` the same
windows as a data/windowed.WindowedArray over the packed cycles.
Capability parity with reference
dataloader/asimow_dataloader.py:
column layout (3 id columns, then V_0..V_199, I_0..I_199 by position,
:240-246), id-based welding-run splits (:56-90), per-task label -1
filtering (:74-80), sliding multi-cycle windows labeled by the *next*
cycle (:185-206), train-only standard scaling applied after windowing
(:157-182), and class-balanced sampling weights (:106-121).

Differences from the reference: preprocessing happens once into packed
numpy arrays (cached as .npz, no pickle), windowing is a vectorized
gather instead of a Python loop, and batching and sampling run on the
device in the training loop: there are no DataLoader worker processes
to replace the reference's num_workers=8 (:357-365).
"""
from __future__ import annotations

import os
import warnings

import numpy as np

from .datasets import ArraySplit, sampling_weights, shuffle_arrays
from .scaler import StandardScaler
from .splits import DataSplitId

CYCLE_LEN = 200


def get_data_path() -> str:
    """.env-driven data root (reference dataloader/utils.py:109-119)."""
    cfg = {}
    if os.path.exists(".env"):
        with open(".env") as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#") and "=" in line:
                    k, v = line.split("=", 1)
                    cfg[k.strip()] = v.strip()
    if cfg.get("PLEIADES"):
        job = os.environ.get("SLURM_JOB_ID")
        return f"/tmp/hahn_{job}/" if job else "/tmp/hahn/"
    return "data"


def load_asimow_csv(path: str, use_native: bool = True):
    """Parse processed_asimow_dataset.csv.

    Returns (vi (N, 200, 2) float32 [V then I], labels (N,) int64,
    experiment (N,) int64, welding_run (N,) int64). Id columns are
    located by header name; V/I by position 3:203 / 203:403 like the
    reference (asimow_dataloader.py:240-246).

    The C++ streaming parser (native/csv_parser.cpp) is preferred: it
    replaces the reference's pandas parse + DataLoader worker pool with
    a single pass writing straight into packed arrays. It is a host
    parser, not a device path: without a compiler the pandas/numpy
    parser takes over, with a warning.
    """
    if use_native:
        # the fallback is automatic but loud: a broken library must not
        # silently cost the native parse
        try:
            from ..native.build import native_load_error
            from ..native.csv_loader import parse_asimow_csv_native
            result = parse_asimow_csv_native(path)
            if result is not None:
                return result
            reason = native_load_error() or "parser returned no rows"
            warnings.warn(
                f"native CSV parser unavailable ({reason}); "
                "falling back to the Python parser", RuntimeWarning,
                stacklevel=2)
        except Exception as e:
            warnings.warn(
                f"native CSV parser failed ({type(e).__name__}: {e}); "
                "falling back to the Python parser", RuntimeWarning,
                stacklevel=2)
    try:
        import pandas as pd
        df = pd.read_csv(path)
        header = list(df.columns)
        raw = df.to_numpy()
    except ImportError:
        with open(path) as f:
            header = f.readline().strip().split(",")
        raw = np.genfromtxt(path, delimiter=",", skip_header=1)
    col = {name: i for i, name in enumerate(header)}
    v = raw[:, 3:3 + CYCLE_LEN].astype(np.float32)
    i = raw[:, 3 + CYCLE_LEN:3 + 2 * CYCLE_LEN].astype(np.float32)
    vi = np.stack([v, i], axis=-1)
    labels = raw[:, col["labels"]].astype(np.int64)
    experiment = raw[:, col["experiment"]].astype(np.int64)
    welding_run = raw[:, col["welding_run"]].astype(np.int64)
    return vi, labels, experiment, welding_run


def _load_cached(data_dir: str, csv_name: str = "processed_asimow_dataset.csv",
                 cache: bool = True):
    cache_path = os.path.join(data_dir, "quality_prediction_data", "asimow",
                              "dataset.npz")
    if cache and os.path.exists(cache_path):
        z = np.load(cache_path)
        return z["vi"], z["labels"], z["experiment"], z["welding_run"]
    vi, labels, exp, run = load_asimow_csv(os.path.join(data_dir, csv_name))
    if cache:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        np.savez(cache_path, vi=vi, labels=labels, experiment=exp,
                 welding_run=run)
    return vi, labels, exp, run


def create_sequence_windows(x: np.ndarray, y: np.ndarray, seq_len: int,
                            window_size: int = CYCLE_LEN,
                            window_offset: int = 0):
    """Sliding n-cycle windows with next-cycle label.

    window i = cycles [i, i+seq_len), label = y[i + seq_len] (the cycle
    *after* the window — reference asimow_dataloader.py:185-206). Like
    the reference, windows may span welding-run boundaries within a
    split. Vectorized gather instead of the reference's Python loop.
    """
    n = x.shape[0] - seq_len
    idx = np.arange(n)[:, None] + np.arange(seq_len)[None, :]
    xw = x[idx][:, :, window_offset:window_offset + window_size, :]
    new_x = xw.reshape(n, seq_len * window_size, x.shape[-1])
    return np.ascontiguousarray(new_x), y[seq_len:].copy()


class ASIMoWDataModule:
    """Packed-array data module (reference ASIMoWDataModule,
    asimow_dataloader.py:296-365).

    After setup(): .train/.val/.test are ArraySplits, .train_sampling
    holds weighted-sampler weights for classification, .drop_last
    mirrors the reference's DataLoader settings (True on every split).
    """

    drop_last = True

    def __init__(self, task: str, n_cycles: int, val_data_ids, test_data_ids,
                 batch_size: int = 32, shuffle_val_test: bool = True,
                 window_size: int = CYCLE_LEN, window_offset: int = 0,
                 data_directory_path: str | None = None, seed: int = 42,
                 shuffle: bool = True, cache: bool = True,
                 window_mode: str = "materialize"):
        """window_mode: 'materialize' copies every n-cycle window into a
        dense array (reference semantics, seq_len-fold memory).
        'ondevice' keeps the packed cycles once and a table of window
        starts (data/windowed.py); the trainer gathers each batch's
        windows on the card by index. Bit-identical batches at about
        n_cycles times less host and device memory."""
        if task not in ("classification", "classification_ids",
                        "reconstruction"):
            raise NotImplementedError(f"Task {task} not implemented")
        if window_mode not in ("materialize", "ondevice"):
            raise ValueError(f"window_mode {window_mode!r}")
        self.task = task
        self.n_cycles = n_cycles
        self.val_ids = [DataSplitId(*v) if not isinstance(v, DataSplitId)
                        else v for v in val_data_ids]
        self.test_ids = [DataSplitId(*v) if not isinstance(v, DataSplitId)
                         else v for v in test_data_ids]
        self.batch_size = batch_size
        self.shuffle_val_test = shuffle_val_test
        self.window_size = window_size
        self.window_offset = window_offset
        self.data_dir = data_directory_path or get_data_path()
        self.seed = seed
        self.shuffle = shuffle
        self.cache = cache
        self.window_mode = window_mode
        self.scaler = StandardScaler()
        self.train = self.val = self.test = None
        self.train_sampling = None

    # -- split machinery --------------------------------------------------

    def _membership(self, exp, run, ids):
        m = np.zeros(exp.shape, bool)
        for s in ids:
            m |= (run == s.welding_run) & (exp == s.experiment)
        return m

    def _prepare_split(self, vi, labels, rng, ds_type: str):
        x, y = vi, labels
        if self.n_cycles > 1 and self.window_mode == "ondevice":
            return self._prepare_split_ondevice(vi, labels, rng, ds_type)
        if self.n_cycles > 1:
            x, y = create_sequence_windows(x, y, self.n_cycles,
                                           self.window_size,
                                           self.window_offset)
        else:
            x = x[:, self.window_offset:self.window_offset + self.window_size, :]
        if ds_type == "train":
            self.scaler.fit(x)
        x = self.scaler.transform(x)
        if self.shuffle:
            x, y = shuffle_arrays(rng, x, y)
        return x, y

    def _prepare_split_ondevice(self, vi, labels, rng, ds_type: str):
        """A windowed view instead of materialized windows: the same
        gather, the window-weighted scaler statistics, the same shuffle
        draws, so bit-identical batch values."""
        from .windowed import WindowedArray, fit_scaler_on_windows

        cycles = np.ascontiguousarray(
            vi[:, self.window_offset:self.window_offset + self.window_size, :])
        n = cycles.shape[0] - self.n_cycles
        starts = np.arange(n, dtype=np.int32)
        y = labels[self.n_cycles:].copy()
        if ds_type == "train":
            fit_scaler_on_windows(self.scaler, cycles, self.n_cycles)
        cycles = self.scaler.transform(cycles)
        if self.shuffle:
            starts, y = shuffle_arrays(rng, starts, y)
        return WindowedArray(cycles, starts, self.n_cycles), y

    def setup(self, stage: str = "fit"):
        vi, labels, exp, run = _load_cached(self.data_dir, cache=self.cache)
        val_m = self._membership(exp, run, self.val_ids)
        test_m = self._membership(exp, run, self.test_ids)
        train_m = ~(val_m | test_m)

        rng = np.random.default_rng(self.seed)
        splits = {}
        for name, m in (("train", train_m), ("val", val_m), ("test", test_m)):
            v, l = vi[m], labels[m]
            if self.task in ("classification", "classification_ids"):
                keep = l != -1
                v, l = v[keep], l[keep]
            x, y = self._prepare_split(v, l, rng, name)
            if self.task == "reconstruction":
                splits[name] = ArraySplit(x)
            else:
                splits[name] = ArraySplit(x, y.astype(np.int64))
        self.train, self.val, self.test = (splits["train"], splits["val"],
                                           splits["test"])
        if self.task in ("classification", "classification_ids"):
            self.train_sampling = sampling_weights(self.train.y)

    # -- shapes for model construction ------------------------------------

    def input_shape(self):
        return self.train.x.shape[1:]


def load_npy_data(config, val_ids, test_ids, task: str = "classification"):
    """Numpy export of the three splits (reference
    asimow_dataloader.py:369-409 — orphan helper kept for parity;
    notebook/TS2Vec-style experiments consume it). `config` needs
    .batch_size and .n_cycles. Returns
    (train_x, train_y, val_x, val_y, test_x, test_y), labels None for
    reconstruction."""
    dm = ASIMoWDataModule(task=task, batch_size=config.batch_size,
                          n_cycles=config.n_cycles, val_data_ids=val_ids,
                          test_data_ids=test_ids,
                          data_directory_path=getattr(config, "data_dir", None))
    dm.setup("fit")
    return (dm.train.x, dm.train.y, dm.val.x, dm.val.y, dm.test.x, dm.test.y)
