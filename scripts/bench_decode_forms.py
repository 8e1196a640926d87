#!/usr/bin/env python3
"""Kernel #13's two forms at the bench shape, on an NVIDIA GPU.

    python3 scripts/bench_decode_forms.py [--other DIR] [--reps 8]

csrc/decode.cu has a general form (the products' depths zero-padded to
multiples of 64, a block's columns walked in groups of 32: any C up to
4,096) and a first form, the code of the shapes it took before (C and
the MLP width multiples of 64, one column group a block), which the
launch picks where it takes the shape. This builds csrc/decode.cu
alone three ways into libraries of their own: as it is ("first form"),
with the first form never picked ("general form"), and, with --other,
another checkout's decode.cu (the parent commit, say, unpacked with
`git archive` into a git-ignored directory). It prints what ptxas says
of every decode_kernel instantiation (registers, spills), then runs
`block_decode_f32` of each library on one block of the bench model
(`entry.build(seed=0)`'s widths: C 512, 8 heads) at 16 streams, pos 160
of (16, 321, 512) caches: whether each output is bit-equal to the first
library's, and ms a call of 200 calls in a row between two CUDA events
(the host runs ahead), the libraries in turns, the order reversed every
repetition; the medians and quartiles, and the card's name and power
limit. Needs a CUDA device and the CUDA toolkit; imports no jax.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
PKG = "vq_vae_transformer_arc_welding_tpu_torch"
B, T, C, HEADS, POS, CALLS = 16, 321, 512, 8, 160, 200
# the edit that keeps the first form from being picked
GENERAL = ("    if (first_form(*a, MLP, grid))", "    if (false)")


def build(tmp: Path, csrc: Path, name: str, edit) -> subprocess.Popen:
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    d = tmp / name
    d.mkdir()
    for f in ("decode.cu", "attention_tc.cuh", "common.cuh"):
        shutil.copy(csrc / f, d / f)
    if edit is not None:
        text = (d / "decode.cu").read_text()
        assert edit[0] in text, edit[0]
        (d / "decode.cu").write_text(text.replace(*edit))
    return subprocess.Popen(
        [kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
         "-o", str(d / "lib.so"), str(d / "decode.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.entry import build as model
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_decode as fdec)
    tmp = Path(tempfile.mkdtemp())
    csrc = REPO / PKG / "csrc"
    builds = {"first form": build(tmp, csrc, "first", None),
              "general form": build(tmp, csrc, "general", GENERAL)}
    if args.other is not None:
        builds["other"] = build(tmp, args.other / PKG / "csrc", "other",
                                None)
    fns = {}
    for (name, proc), d in zip(builds.items(), ("first", "general",
                                                "other")):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(out[-3000:], file=sys.stderr)
            return 1
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "decode_kernel" in line:
                inst = line.split("decode_kernel")[1].split("E")[0]
                said = [x.split(":")[-1].strip() for x in lines[i + 1:i + 4]
                        if "registers" in x or "spill" in x]
                print(f"ptxas {name} decode_kernel{inst}: "
                      + " | ".join(said))
        fn = ctypes.CDLL(str(tmp / d / "lib.so")).block_decode_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    _, tr = model(d_model=C, n_blocks=1, n_heads=HEADS, hidden=64, n_res=1,
                  k=32, d=8, seed=0, device="cuda")
    g = torch.Generator().manual_seed(0)
    x, kc, vc = (torch.randn(*shape, generator=g).cuda()
                 for shape in ((B, 1, C), (B, T, C), (B, T, C)))
    ops = fdec._check_operands("block_decode_f32", tr.blocks[0], kc, vc,
                               (B, T, C), HEADS, True, x.device)
    scratch = fdec._scratch(B, C, ops[1], x.device)
    packed = fdec._pack(ops[0], kc, vc, (T * C, C // HEADS, C), scratch, B,
                        T, C, ops[1], HEADS)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn, n):
        for _ in range(n):
            err = fn(ctypes.addressof(packed), x.data_ptr(), out.data_ptr(),
                     POS, stream)
            assert err == 0, err

    ref = None
    for name, fn in fns.items():
        run(fn, 3)
        torch.cuda.synchronize()
        ref = out.clone() if ref is None else ref
        print(f"{name}: output bit-equal to the first form's: "
              f"{torch.equal(out, ref)}")
    times = {name: [] for name in fns}
    order = list(fns)
    for rep in range(args.reps):
        for name in order if rep % 2 == 0 else order[::-1]:
            run(fns[name], 20)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(fns[name], CALLS)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / CALLS)
    for name, t in times.items():
        q = statistics.quantiles(t, n=4)
        print(f"{name}: {statistics.median(t):.5f} ms a call (quartiles "
              f"{q[0]:.5f}-{q[2]:.5f}), {CALLS} in a row, {args.reps} reps")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
