#!/usr/bin/env python3
"""Where the time of the int8 attention kernel goes, on an NVIDIA GPU.

    python3 scripts/bench_int8_attention_variants.py [--reps 10]

Each variant is a copy of
vq_vae_transformer_arc_welding_tpu_torch/csrc/attention_int8.cuh with
one part of `attention_int8_kernel`'s work changed by a text edit, built
with nvcc into a temporary directory beside the committed kernel
(`final`), and all are timed in turns at the shape of #2 and #6 on the
main path (batch 80, T = 321, 8 heads of 64), on int8 operands made by
the plain quantizing pass from a qkv drawn with seed 0:

- `fast_exp`: `__expf` (one MUFU.EX2 and a multiply) for `expf`;
- `no_pass1`: the row-max pass left out (the walk starts at its last
  stage);
- `no_pv`: the P@V products and their V loads left out (p8 stays live);
- `masked_only`: every stage takes the masked path, as if no stage lay
  wholly below a warp's rows;
- `min_blocks_6`: `__launch_bounds__(128, 6)`, six blocks an SM.

A variant other than `min_blocks_6` computes another function and is
only timed; `final` and `min_blocks_6` are held against the plain int8
attention first (one step in at most 1e-3 of y8). Each time is the
median of `--reps` runs of ten launches in a row between two CUDA
events, per launch. Prints one line per variant and, last, one JSON
object with the card's name and power limit. Needs a CUDA device and
the CUDA toolkit; imports no jax.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
CSRC = REPO / "vq_vae_transformer_arc_welding_tpu_torch" / "csrc"
B, T, N_HEAD = 80, 321, 8
CALLS = 10

KERNEL = "__global__ void __launch_bounds__(THREADS)\nattention_int8_kernel("
VARIANTS = {
    "final": [],
    "fast_exp": [("p = expf(", "p = __expf(")],
    "no_pass1": [("for (int step = 0; step < 2 * n_kt; ++step) {",
                  "for (int step = n_kt - 1; step < 2 * n_kt; ++step) {")],
    "no_pv": [("      mma_s8(o[n], pa, ld32(vr), ld32(vr + 16));",
               "      o[n][0] ^= (int)pa[n % 4];")],
    "masked_only": [("const bool full = k0 + TT - 1 <= r0 && k0 + TT <= t;",
                     "const bool full = false;")],
    "min_blocks_6": [(KERNEL, KERNEL.replace("(THREADS)", "(THREADS, 6)"))],
}
CHECKED = ("final", "min_blocks_6")
ENTRY = """
extern "C" int run(const void* qkv8, const void* head_scales,
                   const void* qscale, void* y8, int batch, int t,
                   int n_head, float sm_scale, void* stream) {
  namespace a8 = arcweld::attn8;
  a8::attention_int8_kernel<64, false>
      <<<dim3(n_head, batch, (t + a8::TT - 1) / a8::TT), a8::THREADS, 0,
         (cudaStream_t)stream>>>(
          (const int8_t*)qkv8, (const float*)head_scales,
          (const float*)qscale, (int8_t*)y8, t, n_head, sm_scale, 64);
  return cudaGetLastError();
}
"""


def variant_source(edits) -> str:
    """attention_int8.cuh with the edits made (each must apply) and the
    variant's C entry after it."""
    src = (CSRC / "attention_int8.cuh").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"attention_int8.cuh no longer holds {old!r}")
        src = src.replace(old, new)
    return src + ENTRY


def build(tmp: Path) -> dict:
    """nvcc every variant side by side (-Xptxas -v): {name: (loaded
    library, what ptxas said of the kernel)}."""
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    procs = {}
    for name, edits in VARIANTS.items():
        src = tmp / f"{name}.cu"
        src.write_text(variant_source(edits))
        procs[name] = subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
             "-I", str(CSRC), "-o", str(tmp / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name}: {text[-3000:]}")
        lines = text.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry function" in line
                  and "attention_int8_kernel" in line)
        said = "; ".join(line.replace("ptxas info    :", "").strip()
                         for line in lines[at + 1:at + 4]
                         if "spill" in line or "Used" in line)
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        lib.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        libs[name] = (lib, said)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn_quant as fattn, fused_block_quant as fbq)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.int8 import quantize_act
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    qkv = (torch.randn(B, T, 3 * N_HEAD * 64, generator=g) * 2).to(dev)
    qkv8, head_scales = fbq.quantize_heads_reference(qkv, N_HEAD)
    y_scale = torch.tensor(127.0 / 2.0, device=dev)
    ref = quantize_act(fattn.attention_core_reference(qkv, N_HEAD,
                                                      int8_attn=True),
                       y_scale)
    y8 = torch.empty((B, T, N_HEAD * 64), dtype=torch.int8, device=dev)
    sm = fattn.sm_scale(N_HEAD * 64, N_HEAD)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))

        def call(lib):
            def run():
                for _ in range(CALLS):
                    err = lib.run(qkv8.data_ptr(), head_scales.data_ptr(),
                                  y_scale.data_ptr(), y8.data_ptr(), B, T,
                                  N_HEAD, sm, stream)
                    if err:
                        raise RuntimeError(f"CUDA error {err}")
            return run

        for name in CHECKED:
            y8.zero_()
            call(libs[name][0])()
            d = (y8.int() - ref.int()).abs()
            frac, step = float(d.ne(0).float().mean()), int(d.max())
            print(f"{name} against plain: y8 differs in {frac:.3e} of "
                  f"entries, step {step}")
            if frac > 1e-3 or step > 1:
                print(f"{name} disagrees with the plain version",
                      file=sys.stderr)
                return 1
        fns = {name: call(lib) for name, (lib, _) in libs.items()}
        for fn in fns.values():
            fn()
        times = {name: [] for name in fns}
        order = list(fns)
        for i in range(args.reps):
            for name in order if i % 2 == 0 else order[::-1]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fns[name]()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / CALLS)
    for name, ts in times.items():
        q1, med, q3 = statistics.quantiles(ts, n=4)
        print(f"{name}: {med:.4f} ms a launch (quartiles {q1:.4f}-{q3:.4f}); "
              f"ptxas {libs[name][1]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"gpu": smi, "ms": {
        name: statistics.median(ts) for name, ts in times.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
