#!/usr/bin/env python3
"""Where the time of the decode kernels #12 and #13 goes, on an NVIDIA GPU.

    python3 scripts/bench_decode_variants.py [--widths C:H,...] [--no-bench]
        [--variant NAME=FLAGS ...] [--out FILE]

Builds csrc/decode.cu alone with -DDECODE_PHASE_TIMES (each block
writes %globaltimer at its start and after every phase and grid
barrier) into the git-ignored _build/, once as it is and once for each
--variant (NAME=FLAGS: more nvcc flags, e.g. a -D macro that a trial
edit of decode.cu reads), all builds side by side. Then, for each build:

- the bench model (`entry.build(seed=0)`: the configuration of
  __graft_entry__._build, random weights), each block's caches filled
  by a prefill over the model's greedy ids at batch 16 (left out with
  --no-bench);
- one seed model of BLOCKS blocks at each (C, heads) of --widths (by
  default chip_smoke.py's NW_SHAPES, the transformer CLI's widths), its
  caches random, batch 16.

The build is launched through the same operands as ops/fused_decode.py
(#13's weights packed where the kernel runs its general form, as
BlockDecodeStack packs them; #12's in rows, as its wrapper hands them), a
token's blocks at a time (each block with its
own weights and caches, so that a call reads another block's operands
than the last one), at pos 160 and 320. After a warm-up token it keeps
TOKENS - 1 tokens, and prints per phase the mean and the largest
duration over the card's blocks and calls, and the span of a call (its
first stamp to its last, over all blocks), in microseconds.

Needs a CUDA device; imports no jax.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

BATCH, POSITIONS, TOKENS, BLOCKS = 16, (160, 320), 3, 2
STAMPS = ("start", "issue", "qkv", "barrier 1", "attention", "barrier 2",
          "c_proj", "barrier 3", "LN2 + c_fc", "barrier 4", "m_proj")


def build_variants(variants: dict) -> dict:
    """{name: ctypes library} of decode.cu built with the phase stamps
    and each variant's flags, the nvcc processes side by side."""
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        so = kernels.BUILD_DIR / f"decode_phase_times_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared",
             "-DDECODE_PHASE_TIMES", *flags, "-o", str(so),
             str(kernels.SRC_DIR / "decode.cu")]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name}")
        lib = ctypes.CDLL(str(so))
        for entry in ("decode_attn_f32", "block_decode_f32"):
            getattr(lib, entry).argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.c_void_p]
        lib.decode_phase_times.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.decode_general_form.argtypes = [ctypes.c_void_p] + [
            ctypes.c_int] * 2
        libs[name] = lib
    return libs


def stamps(lib, kernel, mlp, blocks, stores, x, nh, sms) -> dict:
    """{"pos P": {phase: (mean us, max us)}} of `lib` on the blocks."""
    import numpy as np
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_decode as fdec)
    b, _, c = x.shape
    entry = getattr(lib, "block_decode_f32" if mlp else "decode_attn_f32")
    n_st = len(STAMPS) if mlp else 7
    form = fdec.DecodeArgs(c=c, c4=blocks[0].mlp.c_fc.weight.shape[0] if mlp
                           else 0, n_head=nh)
    general = lib.decode_general_form(ctypes.addressof(form), int(mlp),
                                      torch.cuda.current_device())
    assert general >= 0, general
    packed = []
    for blk, (kc, vc) in zip(blocks, stores):
        t = kc.shape[1] if mlp else kc.shape[2]
        ops = fdec._check_operands(kernel, blk, kc, vc, tuple(kc.shape), nh,
                                   mlp, x.device,
                                   packed=mlp and general == 1)
        c4 = ops[1]
        strides = ((t * c, c // nh, c) if mlp
                   else (nh * t * (c // nh), t * (c // nh), c // nh))
        scratch = fdec._scratch(b, c, c4, nh, x.device)
        # ops holds the padded weights, which must outlive the launches
        packed.append((fdec._pack(ops, kc, vc, strides, scratch, b, t, c,
                                  c4, nh), ops, scratch))
    c4 = packed[0][1][1]
    xin = fdec._padded_rows(x, c, c4)
    out = fdec._rows_out(b, c, c4, x.device)
    host = np.zeros((sms, len(STAMPS)), dtype=np.uint64)
    record = {}
    for pos in POSITIONS:
        durations = [[] for _ in range(n_st - 1)]
        spans = []
        for token in range(TOKENS):
            for dargs, _, _ in packed:
                err = entry(ctypes.addressof(dargs), xin.data_ptr(),
                            out.data_ptr(), pos,
                            torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                torch.cuda.synchronize()
                assert lib.decode_phase_times(host.ctypes.data, sms) == 0
                if token == 0:
                    continue
                st = host[:, :n_st].astype(np.int64)
                d = np.diff(st, axis=1) / 1e3
                for i in range(n_st - 1):
                    durations[i].extend(d[:, i].tolist())
                spans.append((st[:, -1].max() - st[:, 0].min()) / 1e3)
        row = {STAMPS[i + 1]: (float(np.mean(durations[i])),
                               float(np.max(durations[i])))
               for i in range(n_st - 1)}
        row["span"] = (float(np.mean(spans)), float(np.max(spans)))
        record[f"pos {pos}"] = row
    return record


def main() -> int:
    import chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", default=",".join(
        f"{c}:{h}" for c, h in chip_smoke.NW_SHAPES),
        help="(C, heads) pairs as C:H,C:H ('' for none)")
    ap.add_argument("--no-bench", action="store_true",
                    help="leave out the bench model")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS, the flags space-separated")
    ap.add_argument("--out", type=Path, help="write the JSON here too")
    args = ap.parse_args()
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.entry import build
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        merge_heads)
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {"as is": []}
    for v in args.variant:
        name, _, flags = v.partition("=")
        variants[name] = flags.split()
    libs = build_variants({name.replace(" ", "_"): flags
                           for name, flags in variants.items()})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    widths = [tuple(map(int, w.split(":"))) for w in args.widths.split(",")
              if w]
    record = {}

    def run(what, blocks, flat, heads, x, nh):
        for name in variants:
            lib = libs[name.replace(" ", "_")]
            for kernel, mlp, store in (("#13", True, flat),
                                       ("#12", False, heads)):
                got = stamps(lib, kernel, mlp, blocks, store, x, nh, sms)
                for pos, row in got.items():
                    key = f"{what} {kernel} {pos} [{name}]"
                    record[key] = row
                    print(f"{key}, batch {BATCH}, us (mean / max over "
                          f"{sms} blocks and {(TOKENS - 1) * len(blocks)} "
                          f"calls): " + "; ".join(
                              f"{k} {m:.2f} / {mx:.2f}"
                              for k, (m, mx) in row.items()), flush=True)

    with torch.inference_mode():
        if not args.no_bench:
            _, tr = build(seed=0)
            nh, c, t = tr.n_head, tr.d_model, tr.seq_len
            start = torch.zeros((BATCH, 1), dtype=torch.int32, device=dev)
            ids = tr.generate_kv(start, num_steps=t - 1)
            heads = [tuple(torch.zeros(BATCH, nh, t, c // nh, device=dev)
                           for _ in range(2)) for _ in tr.blocks]
            tr._prefill(ids, heads)
            flat = [tuple(merge_heads(z).contiguous() for z in kv)
                    for kv in heads]
            run(f"bench d{c} ({nh} heads)", tr.blocks, flat, heads,
                tr._embed_token(ids[:, 1], 1), nh)
            del tr, heads, flat
        for c, nh in widths:
            _, tr = build(d_model=c, n_heads=nh, n_blocks=BLOCKS, hidden=16,
                          n_res=1, k=32, d=8, seed=0)
            t, hd = tr.seq_len, c // nh
            g = torch.Generator(device=dev).manual_seed(c)
            flat = [tuple(torch.randn(BATCH, t, c, device=dev, generator=g)
                          for _ in range(2)) for _ in tr.blocks]
            heads = [tuple(torch.randn(BATCH, nh, t, hd, device=dev,
                                       generator=g) for _ in range(2))
                     for _ in tr.blocks]
            x = torch.randn(BATCH, 1, c, device=dev, generator=g)
            run(f"d{c} ({nh} heads of {hd})", tr.blocks, flat, heads, x, nh)
            del tr, flat, heads
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}")
    if args.out is not None:
        args.out.write_text(json.dumps({"gpu": smi, **record}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
