"""Build and load the port's CUDA kernels.

Plays the role of vq_vae_transformer_arc_welding_tpu/native/build.py
for the GPU: at first use, one nvcc process per `csrc/*.cu`, all
started together, compiles the sources for Hopper (sm_90a), and one
more links them into a shared library with a plain C interface, which
is loaded with ctypes. The library's name carries a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses
the build. The build directory (`_build/`, beside `csrc/`) is listed
in .gitignore. Nothing is built or imported at module import time.

Every C entry takes pointers and the CUDA stream as `c_void_p`, ints
as `c_int`, and returns `cudaGetLastError()` after its launches;
`check` raises on anything but 0.

`launches` counts, per kernel, the calls that went to the card. A
wrapper adds one where it launches its kernel and nowhere else. The
int8-attention variants of kernels #2 and #6 are counted apart
(`VARIANTS`), so that a run shows which of the two it launched.
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
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
_SIGNATURES = {
    # x, split weights (ops/fused_encoder.split_weights), vecs, out,
    # n_rows, c, n_blocks, use_bn, stream
    "encoder_chain_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, staged bf16 weights (ops/fused_encoder.stage_weights_bf16), vecs,
    # out, n_rows, c, n_blocks, use_bn, stream: both products on the bf16
    # tensor cores
    "encoder_chain_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, split weights of w1 and w2, vec, out, n_rows, c, use_bn, stream
    "resblock_f32": [_P] * 4 + [_I] * 3 + [_P],
    # patches, w_pe, b_pe, split weights, vecs, out, n_rows, patch, c,
    # n_blocks, use_bn, stream
    "encoder_entry_f32": [_P] * 6 + [_I] * 5 + [_P],
    # x, split weights, vecs, w_sep, b_sep, codebook, resid (the (N, C)
    # residual stream between the group's resblocks), ids, n_rows, c,
    # n_blocks, use_bn, d_emb, k_codes, stream
    "encoder_exit_f32": [_P] * 8 + [_I] * 6 + [_P],
    # the encoder's resblocks off the tiles' widths (csrc/encoder_wide.cu):
    # x, weights (2n, C, C) in (in, out) layout, f32 or bf16, vecs, h
    # (the (N, C) scratch between a resblock's products), out, n_rows, c,
    # n_blocks, use_bn, stream
    "encoder_wide_f32": [_P] * 5 + [_I] * 4 + [_P],
    "encoder_wide_bf16": [_P] * 5 + [_I] * 4 + [_P],
    # patches, w_pe, b_pe, weights, vecs, h, out, n_rows, patch, c,
    # n_blocks, use_bn, stream
    "encoder_wide_entry_f32": [_P] * 7 + [_I] * 5 + [_P],
    # x, weights, vecs, w_sep, b_sep, codebook, h, resid, ids, n_rows, c,
    # n_blocks, use_bn, d_emb, k_codes, stream
    "encoder_wide_exit_f32": [_P] * 9 + [_I] * 6 + [_P],
    # z, codebook, ids, n_rows, d_emb, k_codes, stream
    "nearest_codes_f32": [_P] * 3 + [_I] * 3 + [_P],
    # x, w_qkv, w_proj, scales, vc, v3c, h8a, qkv, y8, head_scales, qkv8,
    # x_mid, h8, rail_rows, batch, t, c, n_head, sm_scale, int8_attn,
    # stream
    "attn_block_quant": [_P] * 14 + [_I] * 4 + [_F, _I, _P],
    # x, w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c, h8a, qkv, y8,
    # head_scales, qkv8, x_mid, h8, g8, out, batch, t, c, c4, n_head,
    # sm_scale, int8_attn, stream
    "block_quant": [_P] * 18 + [_I] * 5 + [_F, _I, _P],
    # h, w_fc, w_mp, scales, v4c, vmp, h8, g8, out, rows, c, c4, stream
    "mlp_quant": [_P] * 9 + [_I] * 3 + [_P],
    # a, w, cs, cb, resid, qscale, clip_rows, out, rows, n, k, stream: the
    # int8 GEMM of #2, #6, #8 and #10 alone (the 'attn' paths' int8 MLP,
    # card tests and chip_smoke.py)
    "int8_gemm": [_P] * 8 + [_I] * 3 + [_P],
    # qkv, y_scale, y8, batch, t, c, n_head, sm_scale, stream
    "causal_attention_quant": [_P] * 3 + [_I] * 4 + [_F, _P],
    # h, w_qkv, scales, v3c, h8, qkv, y8, batch, t, c, n_head, sm_scale,
    # stream
    "qkv_attention_quant": [_P] * 7 + [_I] * 4 + [_F, _P],
    # q, k, v, out, batch, n_head, t, head width, the inputs' strides
    # (batch, head, row) and the output's, in floats, sm_scale, stream
    "flash_attention_f32": [_P] * 4 + [_I] * 4 + [_L] * 6 + [_F, _P],
    # x, scale, bias, qscale, out, rail_rows, rows, c, stream: #2's
    # LayerNorm+q8 rows alone (card tests and chip_smoke.py)
    "ln_q8": [_P] * 6 + [_I] * 2 + [_P],
    # the same on bf16 q, k, v and out, strides in elements
    "flash_attention_bf16": [_P] * 4 + [_I] * 4 + [_L] * 6 + [_F, _P],
    # the block's packed operands (ops/fused_decode.DecodeArgs), x, out,
    # pos, stream: one cooperative launch each
    "decode_attn_f32": [_P] * 3 + [_I, _P],
    "block_decode_f32": [_P] * 3 + [_I, _P],
}
# the C entries above whose int8_attn=1 launches are counted apart
VARIANTS = {"attn_block_quant": "attn_block_quant_int8attn",
            "block_quant": "block_quant_int8attn"}

launches = {name: 0 for name in (*_SIGNATURES, *VARIANTS.values())}

# The widest d_model C of the transformer's kernels (csrc/int8_block.cuh's
# MAX_C): every one of them (#2, #6, #8, #9 on f32 and bf16, #10 to #13,
# the int8 attention of #2 and #6 too) takes any C from 1 to it, split
# into any number of heads (`require_heads`' defaults).
MAX_WIDTH = 4096
# The widest head on the attention kernels' narrow tiles
# (csrc/int8_block.cuh's MAX_HEAD_DIM, which the library reports as
# attention_max_head_dim()). A narrower head runs on the tile of
# `padded_head_width(hd)`, its columns past hd zero; a wider one on the
# kernel's wide form, a block for each 128 output columns.
MAX_HEAD_DIM = 128


# The attention tiles' wide forms (heads past MAX_HEAD_DIM) run a block
# per WIDE_PIECE output columns, in clusters of `wide_cluster(hd)` blocks
# (csrc/attention_tc.cuh and csrc/attention_bf16.cuh::wide_cluster).
WIDE_PIECE = 128
WIDE_MAX_CLUSTER = 8
# the kernels whose f32 attention (csrc/int8_block.cu::launch_attention)
# or #9 tile runs the wide forms, and how the library reads back the
# cluster size of their last launch: (C entry, its argument or None)
_CLUSTER_READ = {
    "flash_attention_f32": ("flash_attention_cluster", 0),
    "flash_attention_bf16": ("flash_attention_cluster", 1),
    **{name: ("attention_cluster", None) for name in (
        "attn_block_quant", "block_quant", "qkv_attention_quant",
        "causal_attention_quant")}}


def wide_cluster(hd: int) -> int:
    """The cluster size of the wide tiles at head width hd > 128: 2 for
    two pieces of 128 columns, 4 for three or four, 8 from five (more
    than eight pieces take several clusters of 8)."""
    pieces = -(-hd // WIDE_PIECE)
    return 2 if pieces <= 2 else 4 if pieces <= 4 else WIDE_MAX_CLUSTER


def last_cluster(name: str) -> int:
    """The cluster size in which `name`'s last launch on the card ran its
    attention (#9's tile, or the f32 attention of #2, #6, #10, #11
    without int8_attn), as the library recorded it: `wide_cluster(hd)`
    where the wide tile ran, 0 where a narrow tile ran."""
    entry, arg = _CLUSTER_READ[name]
    fn = getattr(library(), entry)
    return int(fn() if arg is None else fn(arg))


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds: list) -> None:
    """Run the commands side by side; raise with the errors of any that
    failed, after all have ended."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


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
        objs = [so.with_name(f"{so.stem}.{src.stem}.{os.getpid()}.o")
                for src in sources]
        _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources, objs)])
        _run_all([[nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        for obj in objs:
            obj.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.arcweld_error_string.argtypes = [ctypes.c_int]
    lib.arcweld_error_string.restype = ctypes.c_char_p
    lib.attention_max_head_dim.argtypes = []
    lib.attention_max_head_dim.restype = ctypes.c_int
    lib.flash_attention_cluster.argtypes = [ctypes.c_int]
    lib.flash_attention_cluster.restype = ctypes.c_int
    lib.attention_cluster.argtypes = []
    lib.attention_cluster.restype = ctypes.c_int
    lib.decode_general_form.argtypes = [_P, _I, _I]
    lib.decode_general_form.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().arcweld_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def padded_head_width(hd: int) -> int:
    """The head width of the attention tile a head of width hd runs on:
    32, 64 or 128 (csrc/attention_tc.cuh::padded_head)."""
    return 32 if hd <= 32 else 64 if hd <= 64 else 128


def require_heads(name: str, c: int, n_head: int, *,
                  max_c: int | None = MAX_WIDTH,
                  max_head: int | None = None) -> None:
    """Raise unless a kernel takes width C with n_head heads: C from 1
    up to max_c (None: any), split into n_head heads of a width up to
    max_head (None: any). The defaults are every transformer kernel's
    limits. Needs no card."""
    if (n_head < 1 or c < 1 or c % n_head
            or (max_c is not None and c > max_c)
            or (max_head is not None and c // n_head > max_head)):
        limit = "C" + (f" up to {max_c}" if max_c is not None else "")
        if max_head is not None:
            limit += f" and a head width C / n_head up to {max_head}"
        raise ValueError(f"{name}: C={c} with {n_head} heads not supported: "
                         f"{limit}")


def pitch16(k: int) -> int:
    """The row pitch in bytes of an int8 matrix k values wide, as the
    kernels read and write int8 matrices (csrc/common.cuh): a tensor map
    wants rows a multiple of 16 bytes apart."""
    return -(-k // 16) * 16


def empty_pitched(shape: tuple, device) -> torch.Tensor:
    """An int8 tensor of `shape` whose rows lie pitch16(shape[-1]) bytes
    apart: a view of the first shape[-1] columns of wider rows (the
    tensor itself where the width is a multiple of 16)."""
    *lead, k = shape
    return torch.empty((*lead, pitch16(k)), dtype=torch.int8,
                       device=device)[..., :k]


def is_pitched(t: torch.Tensor) -> bool:
    """Whether t's rows lie pitch16(width) bytes apart, one after
    another (`empty_pitched`'s layout)."""
    want, step = [], 1
    for i, n in enumerate(reversed(t.shape)):
        want.append(step)
        step *= pitch16(n) if i == 0 else n
    return all(n == 1 or s == w for n, s, w in
               zip(t.shape, t.stride(), reversed(want)))


def pitched(t: torch.Tensor, name: str, shape: tuple,
            device: torch.device) -> torch.Tensor:
    """t, an int8 tensor of `shape` on `device`, laid out as the kernels
    read int8 operands (`empty_pitched`): t itself where it lies so, a
    copy where it is contiguous; raises as `require` does otherwise."""
    if (t.dtype == torch.int8 and tuple(t.shape) == tuple(shape)
            and t.device == device and is_pitched(t)):
        return t
    require(t, name, torch.int8, shape, device)
    out = empty_pitched(tuple(shape), device)
    out.copy_(t)
    return out


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
