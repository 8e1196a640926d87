#!/usr/bin/env python3
"""Time variants of kernel #9's bf16 tile on an NVIDIA GPU.

    python3 scripts/bench_flash_bf16_variants.py [--other DIR] [--reps 10]

Where the time of the tile in
vq_vae_transformer_arc_welding_tpu_torch/csrc/attention_bf16.cuh goes,
and why it is laid out as it is, kept so that it can be measured again:
each variant is a copy of the header edited by pattern (`EDITS`), built
with csrc/flash_attn.cu into a library of its own.

Variants that compute another function are only timed: "no Q K^T" (the
scores' products skipped), "P@V one term" (only hi; the mid and lo
products skipped), "no P@V" (no product of P and V; P is still split),
"no exp" (p = s - max), "no split" (hi, mid and lo all bf16(p)), "loads
alone" (the stages copied and waited on, no arithmetic) and "compute
alone" (no copy of Q, K or V: the arithmetic on whatever shared memory
holds). The others compute the same function and are held to the gate
of tests/test_torch_cuda.py (at most 1e-3 of the entries differ from
the plain PyTorch version, each by one bf16 step or 2e-5): "expf" (the
library's exponential in place of the tile's ex2.approx), "4 blocks at
HD 64" (the launch bound that spills at head 64), "two stages" and
"two stages, two blocks at HD 128" (the depth of the ring of K and V
stages),
"eight warps" (128 query rows a block, one block an SM), "eight warps,
two blocks" (which spills at head 64) and "128 keys a stage" (two
stages), alone and with eight warps.

All are timed in turns with CUDA events around 20 launches in a row
(operands warm in L2) at four shapes of chip_smoke.py's
FLASH_BF16_SHAPES. With --other, the same files of another checkout
(e.g. the parent commit, unpacked with `git archive` into a git-ignored
directory) are built and timed in the same turns. Prints one line per
variant and shape and, last, one JSON object with the card's name and
power limit. Needs a CUDA device and the CUDA toolkit; imports no jax.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
PKG = "vq_vae_transformer_arc_welding_tpu_torch"
T, CALLS = 321, 20
SHAPES = ((16, 8, 64), (80, 8, 64), (16, 8, 24), (16, 2, 128))
_PV = "          mma_bf16(acc, {}, vf[2 * e], vf[2 * e + 1]);\n"
_EXP = ("  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\"\n      : \"=f\"(y)\n"
        "      : \"f\"(__fmul_rn(x, 1.4426950408889634f)));")

# (pattern, replacement) edits of csrc/attention_bf16.cuh; every pattern
# must occur in the source
EDITS = {
    "no Q K^T": [("      mma_bf16(s[2 * c], qf[kk], kf[0], kf[1]);\n"
                  "      mma_bf16(s[2 * c + 1], qf[kk], kf[2], kf[3]);",
                  "      s[2 * c][0] += __uint_as_float(kf[0] & 1u);")],
    "P@V one term": [(_PV.format("pl") + _PV.format("pm"), "")],
    "no P@V": [(_PV.format("pl") + _PV.format("pm") + _PV.format("ph"),
                "          acc[0] = __uint_as_float((pl[0] ^ pm[1] ^ ph[2]"
                " ^ vf[e]) & 0x3f800000u);\n")],
    "no exp": [(_EXP, "  y = x;")],
    "no split": [("  hi = pack_bf16(x, y);\n  take(x, y, hi);\n"
                  "  mid = pack_bf16(x, y);\n  take(x, y, mid);\n"
                  "  lo = pack_bf16(x, y);",
                  "  hi = mid = lo = pack_bf16(x, y);")],
    "loads alone": [("    if (nc > 0)\n      stage_step",
                     "    if (nc < 0)\n      stage_step")],
    "compute alone": [("    if (i < n_tiles) {\n      __nv_bfloat16* dst",
                       "    if (i < 0) {\n      __nv_bfloat16* dst"),
                      ("  q_rows.template rows<QROWS>(",
                       "  if (0) q_rows.template rows<QROWS>(")],
    "expf": [(_EXP, "  y = expf(x);")],
    "4 blocks at HD 64": [("HD <= 32 ? 4 : HD == 64 ? 3 : 1",
                           "HD <= 64 ? 4 : 1")],
    "two stages": [("STAGES = 3;", "STAGES = 2;")],
    "two stages, two blocks at HD 128": [
        ("STAGES = 3;", "STAGES = HD <= 64 ? 3 : 2;"),
        ("HD <= 32 ? 4 : HD == 64 ? 3 : 1", "HD <= 32 ? 4 : HD == 64 ? 3 : 2")],
    "eight warps": [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;"),
                    ("HD <= 32 ? 4 : HD == 64 ? 3 : 1", "HD <= 32 ? 2 : 1")],
    "eight warps, two blocks": [
        ("constexpr int WARPS = 4;", "constexpr int WARPS = 8;"),
        ("HD <= 32 ? 4 : HD == 64 ? 3 : 1", "HD <= 64 ? 2 : 1")],
    "128 keys a stage": [("constexpr int KT = 64;", "constexpr int KT = 128;"),
                         ("STAGES = 3;", "STAGES = 2;"),
                         ("HD <= 32 ? 4 : HD == 64 ? 3 : 1",
                          "HD <= 32 ? 3 : 2")],
    "eight warps, 128 keys a stage": [
        ("constexpr int WARPS = 4;", "constexpr int WARPS = 8;"),
        ("constexpr int KT = 64;", "constexpr int KT = 128;"),
        ("STAGES = 3;", "STAGES = 2;"),
        ("HD <= 32 ? 4 : HD == 64 ? 3 : 1", "HD <= 32 ? 2 : 1")],
}


def variant_dir(tmp: Path, tree: Path, name: str, edits: list) -> Path:
    """A copy of tree's csrc with attention_bf16.cuh edited."""
    out = tmp / name.replace(" ", "_").replace("@", "").replace("^", "")
    shutil.copytree(tree / PKG / "csrc", out)
    if edits:
        path = out / "attention_bf16.cuh"
        src = path.read_text()
        for pattern, repl in edits:
            if pattern not in src:
                raise RuntimeError(f"{name}: pattern not found: {pattern!r}")
            src = src.replace(pattern, repl)
        path.write_text(src)
    return out


def build_all(tmp: Path, other: Path | None) -> dict:
    """{variant: ctypes library}, built side by side; ptxas's register
    and spill lines of the bf16 kernels are printed."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    dirs = {"tree": variant_dir(tmp, REPO, "tree", [])}
    for name, edits in EDITS.items():
        dirs[name] = variant_dir(tmp, REPO, name, edits)
    if other is not None:
        dirs["other tree"] = variant_dir(tmp, other, "other", [])
    procs = {}
    for name, d in dirs.items():
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-o", str(d / "lib.so"), str(d / "flash_attn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out[-3000:]}")
        lines, fn = [], ""
        for line in out.splitlines():
            if "Function properties for" in line:
                fn = line.rsplit(" ", 1)[-1]
            elif "bf16_kernel" in fn and ("Used" in line or "spill" in line):
                head = fn.split("bf16_kernelILi")[1].split("E")[0]
                lines.append(f"HD {head}: " + line.replace(
                    "ptxas info    :", "").strip())
        print(f"ptxas {name}: " + "; ".join(lines), flush=True)
        lib = ctypes.CDLL(str(dirs[name] / "lib.so"))
        fn = lib.flash_attention_bf16
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        attention, fused_attn)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    record = {"variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp), args.other)
        for b, h, d in SHAPES:
            c = h * d
            gen = torch.Generator().manual_seed(0)
            qkv = (torch.randn(b, T, 3 * c, generator=gen) * 2).to(
                "cuda", torch.bfloat16)
            q, k, v = (attention.split_heads(z, h)
                       for z in qkv.split(c, dim=-1))
            ref = fused_attn.flash_causal_attention_reference(q, k, v)
            out = torch.empty((b, T, h, d), dtype=torch.bfloat16,
                              device="cuda")
            sb, sh, st, _ = q.stride()
            stream = torch.cuda.current_stream().cuda_stream

            def call(fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b, h, T, d, sb, sh, st, T * h * d,
                         d, h * d, 1.0 / math.sqrt(d), stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")

            gates = {}
            for name, fn in libs.items():
                call(fn)
                torch.cuda.synchronize()
                got = out.transpose(1, 2)
                ulps = (got.view(torch.int16).int()
                        - ref.view(torch.int16).int()).abs()
                err = (got.float() - ref.float()).abs()
                gates[name] = (float((ulps > 0).float().mean()),
                               int(((ulps > 1) & (err > 2e-5)).sum()))
            times = {name: [] for name in libs}
            order = list(libs)
            for _ in range(3):
                for fn in libs.values():
                    call(fn)
            for i in range(args.reps):
                for name in order if i % 2 == 0 else order[::-1]:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(CALLS):
                        call(libs[name])
                    end.record()
                    end.synchronize()
                    times[name].append(start.elapsed_time(end) / CALLS)
            base = statistics.median(times["tree"])
            for name in libs:
                ms = statistics.median(times[name])
                share, far = gates[name]
                print(f"({b}, {h}, {T}, {d}) {name}: {ms:.4f} ms a launch "
                      f"({ms / base:.3f} of the tree's), differing share "
                      f"{share:.2e}, beyond the gate {far}", flush=True)
                record["variants"].setdefault(name, {})[
                    f"{b}x{h}x{T}x{d}"] = {"ms": ms, "diff_share": share,
                                           "beyond_gate": far}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}")
    record["gpu"] = smi
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
