#!/usr/bin/env python3
"""Time the nearest-code kernel (#7) against another checkout's, on an
NVIDIA GPU.

    python3 scripts/bench_nearest_codes.py [--other DIR] [--rows 25600]
        [--reps 10]

Builds vq_vae_transformer_arc_welding_tpu_torch/csrc/nearest_codes.cu of this
tree, variants of it with the lanes a row group (`LANES`), the rows a lane holds
(`rows_of`) or the blocks an SM (`BLOCKS_PER_SM`) rewritten, or without the scan
of the codes (what the rest costs), and, with --other, the same file of another
checkout (e.g. the parent commit, unpacked with `git archive` into a git-ignored
directory), each alone with nvcc (`-Xptxas -v`), checks that all give the plain
version's ids and each other's bit for bit on z (N, 32) and a (256, 32) codebook
drawn at z's spread (the bench model's shapes), and times them in turns: CUDA
events around one launch through ctypes, and device time by torch.profiler over
10 launches. Beside them, this tree's public wrapper
(`ops/fused_vq.nearest_codes_pallas`) between events, so that the wrapper's host
share shows, and its plain version.
Prints one line per measurement and, last, one JSON object with the
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
D, K = 32, 256
# name: (LANES, rows a lane holds up to D = 32, scan the codes, blocks an
# SM); "this"
# is the source as committed; without the scan a variant keeps the
# codebook's load, its norms, z's loads and the reduction (what the scan
# leaves), and its ids are not checked
VARIANTS = {"lanes 8, rows 4": (8, 4, True, 1),
            "lanes 4, rows 2": (4, 2, True, 1),
            "two blocks an SM": (None, None, True, 2),
            "no scan": (None, None, False, 1)}


def variant_source(src: str, lanes, rows, scan: bool, per_sm: int) -> str:
    subs = [(r"for \(int k = lane; k < k_codes; k \+= LANES\)",
             "for (int k = lane; k < 0; k += LANES)")] if not scan else []
    if per_sm != 1:
        subs += [(r"constexpr int BLOCKS_PER_SM = \d+;",
                  f"constexpr int BLOCKS_PER_SM = {per_sm};")]
    if lanes is not None:
        subs += [(r"constexpr int LANES = \d+;",
                  f"constexpr int LANES = {lanes};"),
                 (r"return dp <= 32 \? \d+ : dp <= 64",
                  f"return dp <= 32 ? {rows} : dp <= 64")]
    for pattern, new in subs:
        src, n = re.subn(pattern, new, src)
        if n != 1:
            raise RuntimeError(f"{pattern} not found once in the source")
    return src


def build(tmp: Path, trees: dict) -> dict:
    """{name: (ctypes library, ptxas lines)}, built side by side."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    procs = {}
    this = REPO / PKG / "csrc" / "nearest_codes.cu"
    jobs = {name: tree / PKG / "csrc" / "nearest_codes.cu"
            for name, tree in trees.items()}
    for i, (name, spec) in enumerate(VARIANTS.items()):
        jobs[name] = tmp / f"variant{i}.cu"
        jobs[name].write_text(variant_source(this.read_text(), *spec))
    for i, (name, src) in enumerate(jobs.items()):
        so = tmp / f"nc{i}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-I",
             str(this.parent), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.nearest_codes_f32.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p])
        lib.nearest_codes_f32.restype = ctypes.c_int
        libs[name] = (lib, re.findall(r"Used \d+ registers.*|\d+ bytes "
                                      r"spill stores.*", out))
    return libs


def main() -> int:
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import fused_vq as fvq
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, default=None)
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
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(args.rows, D, generator=gen).cuda()
    cb = (torch.randn(K, D, generator=gen) * 1.2).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    trees = {"this": REPO}
    if args.other is not None:
        trees["other"] = args.other

    def run(lib):
        ids = torch.empty(args.rows, dtype=torch.int32, device="cuda")
        err = lib.nearest_codes_f32(z.data_ptr(), cb.data_ptr(),
                                    ids.data_ptr(), args.rows, D, K, stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return ids

    def timed(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def device_ms(fn, calls=10):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0))
                    for e in prof.key_averages()
                    if "nearest_codes_kernel" in e.key)
        return total / 1e3 / calls if total else None

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), trees)
        ref = fvq.nearest_codes_pallas_reference(z, cb)
        ids = {name: run(lib) for name, (lib, _) in libs.items()}
        checked = [name for name in ids
                   if name not in VARIANTS or VARIANTS[name][2]]
        for name in checked:
            got = ids[name]
            flips = float((got != ref).float().mean())
            if flips > 1e-3:
                raise RuntimeError(f"{name}: ids differ from plain in "
                                   f"{flips}")
            print(f"{name}: ids differ from plain in {flips:.3e}; "
                  f"ptxas {libs[name][1]}", flush=True)
        for name in checked:
            if not torch.equal(ids["this"], ids[name]):
                raise RuntimeError(f"{name}: ids differ from this tree's")
        print(f"{', '.join(checked)}: the same ids bit for bit", flush=True)
        fns = {name: (lambda lib=lib: run(lib))
               for name, (lib, _) in libs.items()}
        fns["wrapper"] = lambda: fvq.nearest_codes_pallas(z, cb)
        fns["plain"] = lambda: fvq.nearest_codes_pallas_reference(z, cb)
        times = {name: [] for name in fns}
        order = list(fns)
        for rep in range(3 + args.reps):
            for name in order if rep % 2 == 0 else order[::-1]:
                t = timed(fns[name])
                if rep >= 3:
                    times[name].append(t)
        dev = {}
        for turn in (order, order[::-1]):
            for name in turn:
                if name != "plain":
                    dev.setdefault(name, []).append(device_ms(fns[name]))
    record = {"gpu": smi, "rows": args.rows, "d": D, "k": K, "ms": {},
              "device_ms": dev}
    for name, ts in times.items():
        q1, _, q3 = statistics.quantiles(ts, n=4)
        record["ms"][name] = statistics.median(ts)
        extra = (f", device {', '.join(f'{t:.4f}' for t in dev[name] if t)}"
                 f" ms a launch" if name in dev else "")
        print(f"{name}: events {statistics.median(ts):.4f} ms (quartiles "
              f"{q1:.4f}-{q3:.4f}){extra}; gpu {smi}", flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
