"""Build and load the port's CUDA kernels.

Plays the role of vq_vae_transformer_arc_welding_tpu/native/build.py
for the GPU: at first use, one nvcc call compiles every `csrc/*.cu`
for Hopper (sm_90a) into a shared library with a plain C interface,
which is loaded with ctypes. The library's name carries a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses
the build. The build directory (`_build/`, beside `csrc/`) is listed
in .gitignore. Nothing is built or imported at module import time.

Every C entry takes pointers and the CUDA stream as `c_void_p`, ints
as `c_int`, and returns `cudaGetLastError()` after its launches;
`check` raises on anything but 0.

`launches` counts, per kernel, the calls that went to the card. A
wrapper adds one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = SRC_DIR.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, weights, vecs, out, n_rows, c, n_blocks, use_bn, stream
    "encoder_chain_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w_qkv, w_proj, scales, vc, v3c, h8a, qkv, y8, x_mid, h8,
    # batch, t, c, n_head, sm_scale, stream
    "attn_block_quant": [_P] * 11 + [_I, _I, _I, _I, _F, _P],
}

launches = {name: 0 for name in _SIGNATURES}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = BUILD_DIR / f"libarcweld_cuda_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.arcweld_error_string.argtypes = [ctypes.c_int]
    lib.arcweld_error_string.restype = ctypes.c_char_p
    lib.attn_block_quant_head_dim.argtypes = []
    lib.attn_block_quant_head_dim.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().arcweld_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on `device`."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
