#!/usr/bin/env python3
"""Where the time of the split-TF32 encoder tile goes, on an NVIDIA GPU.

    python3 scripts/bench_encoder_tc_variants.py [--reps 10]

Each variant is a copy of
vq_vae_transformer_arc_welding_tpu_torch/csrc/encoder_tc.cuh with one
part of the tile's work cut out by a text edit, built with nvcc into a
temporary directory beside the committed tile (`final`), and all are
timed in turns with CUDA events at the shapes of #1 on the main path
(hidden 512, four resblocks a launch) on 25,344 rows (three whole
rounds of 64-row tiles on 132 SMs) and 25,600 (the 80-window request,
whose 400th tile opens a fourth round):

- `no_epilogues`: the two epilogue passes (bias, BN, GELU, residual)
  left out; the products, the stash and the barriers stay;
- `no_gelu`: every GELU of the tile replaced by the identity;
- `no_bn_code`: eval BN compiled out of the BN instantiation (the bench
  model has none and runs the other: a check that BN costs it nothing);
- `no_products`: the three wgmma of each k step left out;
- `no_loads`: the producer's TMA loads left out (each stage completes
  empty).

A variant computes another function and is only timed; `final` is held
against the plain PyTorch version first. Prints one line per variant
and, last, one JSON object with the card's name and power limit. Needs
a CUDA device and the CUDA toolkit; imports no jax.
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
C, N_BLOCKS = 512, 4
ROWS = (25344, 25600)

EPILOGUE_1 = "        epilogue_gelu<BN, C, V4>(a_s, v, cw, ct);\n"
EPILOGUE_2 = """        epilogue_residual<BN, C, V4>(a_s, blk == 0 && !Ends::ENTRY ? x : out,
                                 out, v, ct, row0, n_rows, cw,
                                 blk + 1 < n_blocks,
                                 Ends::EXIT && blk + 1 == n_blocks);
"""
PRODUCTS = """  wgmma_tf32<HALF>(acc, lo, w_hi);
  wgmma_tf32<HALF>(acc, hi, w_lo);
  wgmma_tf32<HALF>(acc, hi, w_hi);
"""
LOADS = """            mbar_expect_tx(bar, STAGE);
            tma_load(base + s * STAGE, tm_w, bar, 0,
                     (m * KSTEPS + ks) * BOX_ROWS);
"""
BN = "  return BN ? norm_affine(y, mean, var, sc, bi) : y;"
VARIANTS = {
    "final": [],
    "no_epilogues": [(EPILOGUE_1, ""), (EPILOGUE_2, "")],
    "no_gelu": [("gelu_erf(", "identity(")],
    "no_bn_code": [(BN, "  return y;")],
    "no_products": [(PRODUCTS, "")],
    "no_loads": [(LOADS, "            mbar_expect_tx(bar, 0);\n")],
}
ENTRY = """
__global__ void __launch_bounds__(arcweld::enc_tc::THREADS, 1)
variant_kernel(const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ x, const float* __restrict__ vecs,
               float* out, int n_rows, int cw, int n_blocks, int use_bn) {
  arcweld::enc_tc::encoder_tc<512, true>(&tm_w, x, vecs, out, n_rows, cw,
                                         n_blocks, use_bn);
}
extern "C" int run(const void* x, const void* split, const void* vecs,
                   void* out, int n_rows, int n_blocks, int use_bn,
                   void* stream) {
  return arcweld::enc_tc::launch<512>(
      variant_kernel, arcweld::enc_tc::Tile<512>::SMEM, (const float*)x,
      (const float*)split, (const float*)vecs, (float*)out, n_rows, 512,
      n_blocks, use_bn, (cudaStream_t)stream);
}
"""


def variant_source(edits) -> str:
    """encoder_tc.cuh with the edits made (each must apply) and the
    variant's kernel and C entry after it."""
    src = (CSRC / "encoder_tc.cuh").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"encoder_tc.cuh no longer holds {old!r}")
        src = src.replace(old, new)
    if "identity(" in src:      # the GELU stand-in, declared before use
        src = src.replace("namespace enc_tc {\n", "namespace enc_tc {\n"
                          "__device__ __forceinline__ float identity("
                          "float v) { return v; }\n", 1)
    return src + ENTRY


def build(tmp: Path) -> dict:
    """nvcc every variant side by side: {name: loaded library}."""
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    procs = {}
    for name, edits in VARIANTS.items():
        src = tmp / f"{name}.cu"
        src.write_text(variant_source(edits))
        procs[name] = subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(CSRC),
             "-o", str(tmp / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name}: {text[-3000:]}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        lib.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_encoder as fenc)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    bound = (6.0 / (2 * C * 3)) ** 0.5
    w = ((torch.rand(2 * N_BLOCKS, C, C, generator=g) * 2 - 1) * bound)
    v = torch.zeros(N_BLOCKS, 2, 5, C)
    v[:, :, 0] = torch.randn(N_BLOCKS, 2, C, generator=g) * 0.1
    x = torch.randn(max(ROWS), C, generator=g)
    w, v, x = w.to(dev), v.reshape(10 * N_BLOCKS, C).to(dev), x.to(dev)
    split = fenc.split_weights(w)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))

        def call(lib, rows):
            def run():
                err = lib.run(x.data_ptr(), split.data_ptr(), v.data_ptr(),
                              out.data_ptr(), rows, N_BLOCKS, 0, stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            return run

        call(libs["final"], max(ROWS))()
        ref = fenc.fused_encoder_eval_reference(x, w, v, use_bn=False)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        print(f"final against plain: max abs err {err:.3e} of {scale:.3e}")
        if not err <= 1e-4 * scale:
            print("final disagrees with the plain version", file=sys.stderr)
            return 1
        fns = {(name, rows): call(lib, rows)
               for rows in ROWS for name, lib in libs.items()}
        for fn in fns.values():
            for _ in range(3):
                fn()
        times = {key: [] for key in fns}
        order = list(fns)
        for i in range(args.reps):
            for key in order if i % 2 == 0 else order[::-1]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fns[key]()
                end.record()
                end.synchronize()
                times[key].append(start.elapsed_time(end))
    for (name, rows), ts in times.items():
        q1, med, q3 = statistics.quantiles(ts, n=4)
        print(f"{name} {rows} rows: {med:.4f} ms (quartiles {q1:.4f}-"
              f"{q3:.4f})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"gpu": smi, "ms": {
        f"{name} {rows}": statistics.median(ts)
        for (name, rows), ts in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
