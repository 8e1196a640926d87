#!/usr/bin/env python3
"""Time variants of the bf16 encoder chain kernel on an NVIDIA GPU.

    python3 scripts/bench_encoder_bf16_variants.py [--rows 25600] [--reps 10]

How the constants of
vq_vae_transformer_arc_welding_tpu_torch/csrc/encoder_chain_bf16.cu were
chosen, kept so that the choice can be measured again: each variant is
a copy of the source with some of its `constexpr int` tile constants
rewritten (THREADS, WARPS_M, BK, STAGES), and optionally with every
gelu replaced by 0.5 * x (what the epilogues' gelu costs; such a
variant computes another function and is only timed). The copies are
built side by side with nvcc into a temporary directory, each is held
against the plain PyTorch version on one resblock, and all are timed in
turns with CUDA events on the bench model's shapes (25,600 rows, hidden
512, eight resblocks in one launch). The committed constants are the
variant `final`. Also times `final` on the largest row count that fills
whole waves of blocks, to show what the last, partly filled wave costs.

Prints one line per variant and, last, one JSON object with the card's
name and power limit. Needs a CUDA device and the CUDA toolkit; imports
no jax.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
CSRC = REPO / "vq_vae_transformer_arc_welding_tpu_torch" / "csrc"
C, N_BLOCKS, BM = 512, 8, 64

# name: (tile constants to rewrite, replace gelu by 0.5 x)
VARIANTS = {
    "final": ({}, False),
    "final, no gelu": ({}, True),
    "32 warps 2x16, ring 4 x 32 rows": ({"BK": 32, "STAGES": 4}, False),
    "32 warps 1x32, ring 4 x 32 rows": (
        {"WARPS_M": 1, "BK": 32, "STAGES": 4}, False),
    "16 warps 1x16, ring 4 x 32 rows": (
        {"THREADS": 512, "WARPS_M": 1, "BK": 32, "STAGES": 4}, False),
    "16 warps 1x16, ring 9 x 16 rows": (
        {"THREADS": 512, "WARPS_M": 1, "BK": 16, "STAGES": 9}, False),
    "8 warps 1x8, ring 4 x 32 rows": (
        {"THREADS": 256, "WARPS_M": 1, "BK": 32, "STAGES": 4}, False),
    "8 warps 1x8, ring 9 x 16 rows": (
        {"THREADS": 256, "WARPS_M": 1, "BK": 16, "STAGES": 9}, False),
    "8 warps 1x8, ring 2 x 64 rows": (
        {"THREADS": 256, "WARPS_M": 1}, False),
    "8 warps 1x8, ring 4 x 32 rows, no gelu": (
        {"THREADS": 256, "WARPS_M": 1, "BK": 32, "STAGES": 4}, True),
}


def variant_source(consts: dict, no_gelu: bool) -> str:
    src = (CSRC / "encoder_chain_bf16.cu").read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"constant {name} not found once in the source")
    if no_gelu:
        src, n = re.subn(r"gelu_erf\(", "0.5f * (", src)
        if n == 0:
            raise RuntimeError("no gelu_erf call found in the source")
    return src


def build_all(tmp: Path) -> dict:
    """{name: (ctypes library, registers per thread)}, built side by side."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    procs = {}
    for i, (name, (consts, no_gelu)) in enumerate(VARIANTS.items()):
        cu, so = tmp / f"v{i}.cu", tmp / f"v{i}.so"
        cu.write_text(variant_source(consts, no_gelu))
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-I",
             str(CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        regs = re.search(r"Used (\d+) registers", out)
        lib = ctypes.CDLL(str(so))
        lib.encoder_chain_bf16.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
        lib.encoder_chain_bf16.restype = ctypes.c_int
        libs[name] = (lib, int(regs.group(1)) if regs else None)
    return libs


def main() -> int:
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_encoder as fenc)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=25600)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    bound = (6.0 / (2 * C * 3)) ** 0.5
    w = ((torch.rand(2 * N_BLOCKS, C, C, generator=gen) * 2 - 1) * bound)
    w = w.to(dev).bfloat16()
    v = torch.zeros(N_BLOCKS, 2, 5, C)
    v[:, :, 0] = torch.randn(N_BLOCKS, 2, C, generator=gen) * 0.1
    v = v.reshape(10 * N_BLOCKS, C).to(dev)
    x = torch.randn(args.rows, C, generator=gen).to(dev)
    ref = fenc.fused_encoder_eval_reference(
        x, w[:2], v[:10], use_bn=False, compute_dtype=torch.bfloat16)

    def run(lib, n_blocks=N_BLOCKS, rows=args.rows):
        out = torch.empty((rows, C), device=dev)
        err = lib.encoder_chain_bf16(
            x.data_ptr(), w.data_ptr(), v.data_ptr(), out.data_ptr(), rows, C,
            n_blocks, 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out

    def timed(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp))
        errs = {}
        for name, (lib, _) in libs.items():
            errs[name] = float((run(lib, 1) - ref).abs().max())
            if not VARIANTS[name][1] and errs[name] > 1e-3 * float(
                    ref.abs().max()):
                raise RuntimeError(f"{name!r} differs from the plain "
                                   f"version by {errs[name]}")
        times = {name: [] for name in libs}
        order = list(libs)
        for rep in range(3 + args.reps):       # three warm-up rounds
            for name in order if rep % 2 == 0 else order[::-1]:
                t = timed(lambda: run(libs[name][0]))
                if rep >= 3:
                    times[name].append(t)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        whole = args.rows // (BM * sms) * BM * sms
        final = libs["final"][0]
        whole_ms = statistics.median(
            [timed(lambda: run(final, rows=whole))
             for _ in range(3 + args.reps)][3:]) if whole else None
    record = {"gpu": smi, "rows": args.rows, "n_blocks": N_BLOCKS,
              "whole_wave_rows": whole, "whole_wave_ms": whole_ms,
              "variants": {}}
    for name, ts in times.items():
        q1, _, q3 = statistics.quantiles(ts, n=4)
        med = statistics.median(ts)
        record["variants"][name] = {"ms": med, "registers": libs[name][1],
                                    "one_resblock_err": errs[name]}
        print(f"{name}: {med:.4f} ms (quartiles {q1:.4f}-{q3:.4f}), "
              f"{libs[name][1]} registers; gpu {smi}", flush=True)
    if whole:
        print(f"final on {whole} rows (whole waves of {sms} blocks): "
              f"{whole_ms:.4f} ms; gpu {smi}", flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
