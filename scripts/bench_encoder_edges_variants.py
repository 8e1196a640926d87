#!/usr/bin/env python3
"""Where the time of the encoder's ends (#4, #5) goes, on an NVIDIA GPU.

    python3 scripts/bench_encoder_edges_variants.py [--reps 10]

Each variant is a copy of
vq_vae_transformer_arc_welding_tpu_torch/csrc/encoder_edges.cu with one
part of the ends' work cut out by a text edit, built with nvcc into a
temporary directory against the committed tile (csrc/encoder_tc.cuh),
and all are timed in turns with CUDA events (10 launches in a row
between two events, so that the host's launches hide behind the card's
work) at the shapes of the edges path on the 80-window request: 25,600
rows, hidden 512, four resblocks a launch, patch 25, a (256, 32)
codebook drawn at the spread of z. Beside them #1 (`encoder_chain_f32`
from the port's library) on the same rows and resblocks: the same tile
without the ends.

- `final`: the committed source, held against the plain versions first
  (#4 within 1e-4 of the magnitude, #5's id flips at most 1e-3);
- `no_embed`: #4 without its prologue (the tile's input rows are then
  whatever the output buffer held);
- `no_search`: #5 without its epilogue (no ids written);
- `no_z`: #5 without the sep_conv product (z is b_sep);
- `no_scan`: #5 without the scan of the codebook (z, the codebook's
  staging and the norms stay);
- `inlined`: both ends inlined into the tile's body instead of
  `__noinline__`;
- `z_no_w`: #5's sep_conv product without its loads of w_sep (each
  chunk of w made from the one before, in registers);
- `z_no_x`: the same product without its shared-memory loads of x (x
  taken from w's registers).

A variant computes another function and is only timed. Prints one line
per kernel and variant and, last, one JSON object with the card's name
and power limit. Needs a CUDA device and the CUDA toolkit; imports no
jax.
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
C, N_BLOCKS, ROWS, PATCH, K, D = 512, 4, 25600, 25, 256, 32
CALLS = 10

EMBED = ("    embed_rows<C, V4>(patches, w_pe, b_pe, out, row0, n_rows, cw, "
         "patch,\n                      ct);\n")
SEARCH = """    nearest_rows<C>(w_sep, b_sep, codebook, ids, row0, n_rows, cw, d_emb,
                    k_codes, ct);
"""
NOINLINE = "__device__ __noinline__"
Z_LOOP = "      for (int k0 = 0; k0 < cw; k0 += Z_CHUNK) {"
# the scan of a chunk's codes (csrc/code_scan.cuh, included by the source:
# the variants carry it inline)
SCAN = "    for (int k = lane; k < kc; k += 32) {"
W_LOAD = """          wn[j] = live && kn + j < cw
                      ? __ldg(w_sep + (kn + j) * d_emb + col) : 0.0f;"""
X_LOAD = ("            const float4 xv = ld4(x0 + (h * NH + i) * RSTEP * C + "
          "k);")
VARIANTS = {
    "final": [],
    "no_embed": [(EMBED, "")],
    "no_search": [(SEARCH, "")],
    "no_z": [(Z_LOOP, Z_LOOP.replace("k0 < cw", "k0 < 0"))],
    "no_scan": [(SCAN, SCAN.replace("k < k_codes", "k < 0"))],
    "inlined": [(NOINLINE, "__device__ __forceinline__")],
    "z_no_w": [(W_LOAD, "      wn[j] = w[j] * 0.5f;")],
    "z_no_x": [(X_LOAD, "            const float4 xv = make_float4("
                        "w[kk + 1], w[kk], w[kk + 3], w[kk + 2 + 0 * k]);")],
}
# the kernels each variant is timed on: the end it changes
TIMED = {"final": ("entry", "exit"), "no_embed": ("entry",),
         "no_search": ("exit",), "no_z": ("exit",), "no_scan": ("exit",),
         "inlined": ("entry", "exit"), "z_no_w": ("exit",),
         "z_no_x": ("exit",)}


def variant_source(edits) -> str:
    """encoder_edges.cu, with csrc/code_scan.cuh inline, with the edits
    made (each must apply; an old text given as (first, last) is the
    text from first to last)."""
    scan = (CSRC / "code_scan.cuh").read_text().replace("#pragma once\n", "")
    src = (CSRC / "encoder_edges.cu").read_text().replace(
        '#include "code_scan.cuh"\n', scan)
    for old, new in edits:
        if isinstance(old, tuple):      # (first, last): the text between
            first, last = old
            if first not in src or last not in src:
                raise SystemExit(f"encoder_edges.cu no longer holds {old!r}")
            i = src.index(first)
            old = src[i:src.index(last, i) + len(last)]
        if old not in src:
            raise SystemExit(f"encoder_edges.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


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
        for fn in ("encoder_entry_f32", "encoder_exit_f32"):
            getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
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
    x = torch.randn(ROWS, C, generator=g)
    patches = torch.randn(ROWS, PATCH, generator=g)
    w_pe = (torch.rand(PATCH, C, generator=g) * 2 - 1) * 0.1
    b_pe = torch.randn(C, generator=g) * 0.1
    w_sep = (torch.rand(C, D, generator=g) * 2 - 1) * 0.1
    b_sep = torch.randn(D, generator=g) * 0.1
    noise = torch.randn(K, D, generator=g)
    w, v, x, patches, w_pe, b_pe, w_sep, b_sep, noise = (
        t.to(dev).contiguous() for t in (w, v.reshape(10 * N_BLOCKS, C), x,
                                         patches, w_pe, b_pe, w_sep, b_sep,
                                         noise))
    z = fenc.fused_encoder_eval_reference(x, w, v, use_bn=False) @ w_sep \
        + b_sep
    cb = (z.mean(0) + noise * z.std(0)).contiguous()
    split = fenc.split_weights(w)
    out = torch.empty_like(x)
    resid = torch.empty_like(x)
    ids = torch.empty(ROWS, dtype=torch.int32, device=dev)
    stream = kernels.stream_ptr(dev)
    lib = kernels.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()

    def entry(vlib):
        def run():
            kernels.check(vlib.encoder_entry_f32(
                patches.data_ptr(), w_pe.data_ptr(), b_pe.data_ptr(),
                split.data_ptr(), v.data_ptr(), out.data_ptr(), ROWS, PATCH,
                C, N_BLOCKS, 0, stream), "encoder_entry_f32")
        return run

    def exit_(vlib):
        def run():
            kernels.check(vlib.encoder_exit_f32(
                x.data_ptr(), split.data_ptr(), v.data_ptr(),
                w_sep.data_ptr(), b_sep.data_ptr(), cb.data_ptr(),
                resid.data_ptr(), ids.data_ptr(), ROWS, C, N_BLOCKS, 0, D, K,
                stream), "encoder_exit_f32")
        return run

    def chain():
        kernels.check(lib.encoder_chain_f32(
            x.data_ptr(), split.data_ptr(), v.data_ptr(), out.data_ptr(),
            ROWS, C, N_BLOCKS, 0, stream), "encoder_chain_f32")

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        with torch.inference_mode():
            entry(libs["final"])()
            ref = fenc.fused_encoder_entry_eval_reference(
                patches, w_pe, b_pe, w, v, use_bn=False)
            rel = float((out - ref).abs().max() / ref.abs().max())
            exit_(libs["final"])()
            flips = float((ids != fenc.fused_encoder_exit_eval_reference(
                x, w, v, w_sep, b_sep, cb, use_bn=False)).float().mean())
            torch.cuda.synchronize()
            if rel > 1e-4 or flips > 1e-3:
                raise SystemExit(f"final: #4 rel err {rel}, #5 flips {flips}")
            print(f"final against plain: #4 max rel err {rel:.3e}, #5 id "
                  f"flips {flips:.3e}", flush=True)
            fns = {"#1 (encoder_chain_f32)": chain}
            for name, ends in TIMED.items():
                for end in ends:
                    fns[f"{end} {name}"] = (entry if end == "entry"
                                            else exit_)(libs[name])
            for fn in fns.values():
                for _ in range(3):
                    fn()
            times = {name: [] for name in fns}
            for _ in range(args.reps):
                for name, fn in fns.items():
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(CALLS):
                        fn()
                    end.record()
                    end.synchronize()
                    times[name].append(start.elapsed_time(end) / CALLS)
    record = {"gpu": smi, "rows": ROWS, "resblocks": N_BLOCKS, "ms": {}}
    for name, ts in times.items():
        q = statistics.quantiles(ts, n=4)
        record["ms"][name] = statistics.median(ts)
        print(f"{name}: {statistics.median(ts):.4f} ms a launch (quartiles "
              f"{q[0]:.4f}-{q[2]:.4f}); gpu {smi}", flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
