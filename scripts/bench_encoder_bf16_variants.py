#!/usr/bin/env python3
"""Time variants of the bf16 encoder chain kernel (1b) on an NVIDIA GPU.

    python3 scripts/bench_encoder_bf16_variants.py [--other DIR]
        [--rows 25600] [--reps 10]

Where the time of
vq_vae_transformer_arc_welding_tpu_torch/csrc/encoder_chain_bf16.cu
goes, and why it is laid out as it is, kept so that it can be measured
again: each variant is a copy of the source edited by pattern (`EDITS`):
"lockstep" syncs the two consumer warpgroups around every pass, so that
no epilogue runs beside the other warpgroup's products (the kernel runs
them in ping-pong); every GELU replaced by 0.5 x (what the epilogues'
GELU costs); parts of the epilogues cut (their traffic to shared and
device memory, the waits on the quarters of A); "products alone" (the
ring and the products, no epilogues) and "W stream alone" (the ring
alone, no products either), whose time gives the rate at which L2
feeds the W stream. Those two need fewer registers than the kernel's
`setmaxnreg` requests assume, so they are built without the requests
and without the wrapper's register check. Variants that compute another
function are only timed. (W shared by a cluster of two blocks through
TMA multicast was timed beside these and measured no faster: PERF.md,
PR 14; that path is not kept.)
With --other, the same file of another checkout (e.g. the parent
commit, unpacked with `git archive` into a git-ignored directory) is
built too and timed in the same turns; a tree whose kernel reads the
weights in (in, out) layout gets them so, this tree's the staged
operand (`ops/fused_encoder.py::stage_weights_bf16`).

The copies are built side by side with nvcc (`-Xptxas -v`: registers
and spills) into a temporary directory, each is held against the plain
PyTorch version on one resblock, and all are timed in turns with CUDA
events around one launch on the bench model's shapes (25,600 rows,
hidden 512, eight resblocks). Beside them, the 16 bf16 products alone
through `torch.matmul` (bf16 in, bf16 out: a reference point, not a
bar). Prints one line per variant and, last, one JSON object with the
card's name and power limit. Needs a CUDA device and the CUDA toolkit;
imports no jax.
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
PKG = "vq_vae_transformer_arc_welding_tpu_torch"
C, N_BLOCKS = 512, 8

# Edits of the source, each a list of (pattern, replacement): the proxy
# fence before A is read, the stores of A and of the output, the loads
# of the residual stream, the waits on the quarters of A, the epilogues
# (each quarter of the next A still marked written), the products, the
# setmaxnreg requests with the wrapper's check that the kernel has the
# registers they assume, and a sync of both consumer warpgroups before
# and after every pass. Only "lockstep" keeps the function.
SYNC = "gemm90::named_sync(1, CONSUMERS);"
EDITS = {
    "fence": [(r'asm volatile\("fence\.proxy\.async\.shared::cta;" ::: '
               r'"memory"\);', "")],
    "A stores": [(r"\*reinterpret_cast<uint32_t\*>\(a \+ a_off\([^;]*?\)\) ="
                  r"\s*pack_bf16", "(void)pack_bf16")],
    "output stores": [(r"\*reinterpret_cast<float2\*>\(out \+[^;]*?\) = "
                       r"xs\[2 \* j \+ e\];", "(void)0;")],
    "residual loads": [(r"\?\s*ld2\(src", "&& false ? ld2(src")],
    "gates": [(r"if \(j % 2 == 0\) mbar_wait\(ready[^;]*;", "")],
    "epilogues": [
        (r"(epi_gelu<BN>\(|prefetch_pass<BN>\()", r"if (false) \1"),
        (r"epi_residual<BN>\(([^;]*)\);",
         r"if (false) epi_residual<BN>(\1); "
         r"else { fence_a(); if (more) mbar_arrive(written); }")],
    "products": [(r"(wgmma_m64n128k16\(acc,|load_a_half\(a_tiles)",
                  r"if (false) \1")],
    "setmaxnreg": [(r'asm volatile\("setmaxnreg[^"]*"[^;]*;', ""),
                   (r"fa\.numRegs != REGS", "false")],
    "lockstep": [(r"(\n\s*)(prefetch_pass<BN>\()", rf"\1{SYNC}\1\2"),
                 (r"(\n\s*)(pass_product\(acc,[^;]*;)", rf"\1\2\1{SYNC}")],
}
MEMORY = ("fence", "A stores", "output stores", "residual loads")

# name: (replace gelu by 0.5 x, edits)
VARIANTS = {
    "ping-pong": (False, ()),
    "lockstep": (False, ("lockstep",)),
    "no gelu": (True, ()),
    "lockstep, no gelu": (True, ("lockstep",)),
    "no gelu, no epilogue memory traffic": (True, MEMORY),
    "no gelu, no epilogue memory traffic, no quarter waits": (
        True, MEMORY + ("gates",)),
    "products alone": (False, ("epilogues", "setmaxnreg")),
    "W stream alone": (False, ("epilogues", "products", "setmaxnreg")),
}
# the variants that compute the kernel's function
EXACT = {name for name, (no_gelu, edits) in VARIANTS.items()
         if not no_gelu and set(edits) <= {"lockstep"}}


def variant_source(src: str, no_gelu: bool, edits: tuple = ()) -> str:
    if no_gelu:
        src, n = re.subn(r"gelu_erf\(", "0.5f * (", src)
        if n == 0:
            raise RuntimeError("no gelu_erf call found in the source")
    for edit in edits:
        for pattern, new in EDITS[edit]:
            src, n = re.subn(pattern, new, src, flags=re.S)
            if n == 0:
                raise RuntimeError(f"edit {edit!r}: {pattern!r} not found "
                                   f"in the source")
    return src


def build_all(tmp: Path, other: Path | None) -> dict:
    """{name: (ctypes library, registers, spill line, staged)}, built
    side by side; `staged`: the kernel reads stage_weights_bf16's
    operand (else the (in, out) weights)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    this = REPO / PKG / "csrc"
    jobs = {name: (variant_source((this / "encoder_chain_bf16.cu")
                                  .read_text(), *spec), this)
            for name, spec in VARIANTS.items()}
    if other is not None:
        jobs["other"] = ((other / PKG / "csrc" / "encoder_chain_bf16.cu")
                         .read_text(), other / PKG / "csrc")
    procs = {}
    for i, (name, (src, inc)) in enumerate(jobs.items()):
        cu, so = tmp / f"v{i}.cu", tmp / f"v{i}.so"
        cu.write_text(src)
        procs[name] = (so, "stage_weights_bf16" in src or "staged" in src,
                       subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-I",
             str(inc), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, staged, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        regs = re.findall(r"Used (\d+) registers", out)
        spills = sorted(set(re.findall(r"\d+ bytes spill stores, \d+ bytes "
                                       r"spill loads", out)))
        lib = ctypes.CDLL(str(so))
        lib.encoder_chain_bf16.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
        lib.encoder_chain_bf16.restype = ctypes.c_int
        libs[name] = (lib, [int(r) for r in regs], spills, staged)
    return libs


def main() -> int:
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_encoder as fenc)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="another checkout whose kernel is timed in turns")
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
    staged = fenc.stage_weights_bf16(w)
    v = torch.zeros(N_BLOCKS, 2, 5, C)
    v[:, :, 0] = torch.randn(N_BLOCKS, 2, C, generator=gen) * 0.1
    v = v.reshape(10 * N_BLOCKS, C).to(dev)
    x = torch.randn(args.rows, C, generator=gen).to(dev)
    ref = fenc.fused_encoder_eval_reference(
        x, w[:2], v[:10], use_bn=False, compute_dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, n_blocks=N_BLOCKS):
        lib, _, _, is_staged = libs[name]
        out = torch.empty((args.rows, C), device=dev)
        wt = staged if is_staged else w
        err = lib.encoder_chain_bf16(x.data_ptr(), wt.data_ptr(),
                                     v.data_ptr(), out.data_ptr(), args.rows,
                                     C, n_blocks, 0, stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
        return out

    def timed(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    # the 16 products alone, bf16 through torch.matmul, on the same rows
    xb = x.bfloat16()

    def products():
        y = xb
        for m in range(2 * N_BLOCKS):
            y = y @ w[m]
        return y

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp), args.other)
        errs = {}
        for name in libs:
            errs[name] = float((run(name, 1) - ref).abs().max())
            print(f"{name}: one resblock, max abs err {errs[name]:.3e} of "
                  f"{float(ref.abs().max()):.3e}", flush=True)
            if (name in EXACT or name == "other") and errs[name] > 1e-3 * \
                    float(ref.abs().max()):
                raise RuntimeError(f"{name!r} differs from the plain "
                                   f"version by {errs[name]}")
        fns = {name: (lambda name=name: run(name)) for name in libs}
        fns["torch.matmul, the 16 products alone"] = products
        times = {name: [] for name in fns}
        order = list(fns)
        for rep in range(3 + args.reps):       # three warm-up rounds
            for name in order if rep % 2 == 0 else order[::-1]:
                t = timed(fns[name])
                if rep >= 3:
                    times[name].append(t)
    w_bytes = 2 * N_BLOCKS * C * C * 2
    tiles = -(-args.rows // 64)
    record = {"gpu": smi, "rows": args.rows, "n_blocks": N_BLOCKS,
              "variants": {}}
    for name, ts in times.items():
        q1, _, q3 = statistics.quantiles(ts, n=4)
        med = statistics.median(ts)
        entry = {"ms": med}
        line = f"{name}: {med:.4f} ms (quartiles {q1:.4f}-{q3:.4f})"
        if name in libs:
            _, regs, spills, _ = libs[name]
            entry.update(registers=regs, spills=spills,
                         one_resblock_err=errs[name])
            line += f", registers {regs}, {spills or 'no spill lines'}"
        if name == "W stream alone":
            # every tile reads all of W from L2
            rate = tiles * w_bytes / (med * 1e-3) / 1e12
            entry["l2_tb_per_s"] = rate
            line += (f"; {tiles * w_bytes / 1e9:.2f} GB of W from L2: "
                     f"{rate:.2f} TB/s")
        record["variants"][name] = entry
        print(line + f"; gpu {smi}", flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
