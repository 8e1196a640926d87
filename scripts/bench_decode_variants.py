#!/usr/bin/env python3
"""Where the time of the decode kernels #12 and #13 goes, on an NVIDIA GPU.

    python3 scripts/bench_decode_variants.py [--out FILE]

Builds csrc/decode.cu alone with -DDECODE_PHASE_TIMES (each block
writes %globaltimer at its start and after every phase and grid
barrier) into the git-ignored _build/, builds the bench model
(`entry.build(seed=0)`: the configuration of __graft_entry__._build,
random weights), fills each block's caches by a prefill over the model's
greedy ids at batch 16, and launches that build through the same
packed operands as ops/fused_decode.py, a token's 8 blocks at a time
(each block with its own weights and caches, so every call reads cold
operands), at pos 160 and 320. After a warm-up token it keeps two
tokens, and prints per phase the mean and the largest duration over the
card's blocks and calls, and the span of a call (its first stamp to its
last, over all blocks).

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

BATCH, POSITIONS, TOKENS = 16, (160, 320), 3
STAMPS = ("start", "issue", "qkv", "barrier 1", "attention", "barrier 2",
          "c_proj", "barrier 3", "LN2 + c_fc", "barrier 4", "m_proj")


def build_variant(flags: list, name: str) -> ctypes.CDLL:
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    so = kernels.BUILD_DIR / f"{name}.so"
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared",
                    *flags, "-o", str(so),
                    str(kernels.SRC_DIR / "decode.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    for entry in ("decode_attn_f32", "block_decode_f32"):
        getattr(lib, entry).argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
    lib.decode_phase_times.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, help="write the JSON here too")
    args = ap.parse_args()
    import numpy as np
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.entry import build
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_decode as fdec)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        merge_heads)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build_variant(["-DDECODE_PHASE_TIMES"], "decode_phase_times")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    vq, tr = build(seed=0)
    nb, nh, c, t = tr.n_blocks, tr.n_head, tr.d_model, tr.seq_len
    hd = c // nh
    start = torch.full((BATCH, 1), 0, dtype=torch.int32, device="cuda")
    record = {}
    with torch.inference_mode():
        ids = tr.generate_kv(start, num_steps=t - 1)
        heads = [tuple(torch.zeros(BATCH, nh, t, hd, device="cuda")
                       for _ in range(2)) for _ in range(nb)]
        tr._prefill(ids, heads)
        flat = [tuple(merge_heads(z).contiguous() for z in kv)
                for kv in heads]
        x = tr._embed_token(ids[:, 1], 1)
        for kernel, mlp, store in (("#13", True, flat), ("#12", False,
                                                         heads)):
            entry = getattr(lib, "block_decode_f32" if mlp
                            else "decode_attn_f32")
            n_st = len(STAMPS) if mlp else 7
            packed = []
            for blk, (kc, vc) in zip(tr.blocks, store):
                shape = tuple(kc.shape)
                ptrs, c4 = fdec._check_operands(kernel, blk, kc, vc, shape,
                                                nh, mlp, x.device)
                strides = ((t * c, hd, c) if mlp
                           else (nh * t * hd, t * hd, hd))
                scratch = fdec._scratch(BATCH, c, c4, x.device)
                packed.append((fdec._pack(ptrs, kc, vc, strides, scratch,
                                          BATCH, t, c, c4, nh), scratch))
            out = torch.empty_like(x)
            host = np.zeros((sms, len(STAMPS)), dtype=np.uint64)
            for pos in POSITIONS:
                durations = [[] for _ in range(n_st - 1)]
                spans = []
                for token in range(TOKENS):
                    for dargs, _ in packed:
                        err = entry(ctypes.addressof(dargs), x.data_ptr(),
                                    out.data_ptr(), pos,
                                    torch.cuda.current_stream().cuda_stream)
                        assert err == 0, err
                        torch.cuda.synchronize()
                        assert lib.decode_phase_times(
                            host.ctypes.data, sms) == 0
                        if token == 0:
                            continue
                        st = host[:, :n_st].astype(np.int64)
                        d = np.diff(st, axis=1) / 1e3
                        for i in range(n_st - 1):
                            durations[i].extend(d[:, i].tolist())
                        spans.append((st[:, -1].max() - st[:, 0].min())
                                     / 1e3)
                row = {f"{STAMPS[i + 1]}": (float(np.mean(durations[i])),
                                            float(np.max(durations[i])))
                       for i in range(n_st - 1)}
                row["span"] = (float(np.mean(spans)), float(np.max(spans)))
                record[f"{kernel} pos {pos}"] = row
                print(f"{kernel} batch {BATCH}, pos {pos}, us "
                      f"(mean / max over {sms} blocks and {len(spans)} "
                      f"calls): "
                      + "; ".join(f"{k} {m:.2f} / {mx:.2f}"
                                  for k, (m, mx) in row.items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}")
    if args.out is not None:
        args.out.write_text(json.dumps({"gpu": smi, **record}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
