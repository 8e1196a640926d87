#!/usr/bin/env python3
"""The decode kernels #13 and #12 at the transformer CLI's widths against
another tree's, on an NVIDIA GPU: the same bits or not, and the time.

    python3 scripts/bench_decode_forms.py [--other DIR] [--widths C:H,...]
        [--calls 10]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory such
as vq_vae_transformer_arc_welding_tpu_torch/_build/parent). The script
runs one process per turn, in the order other / this tree / this tree /
other (this tree twice without --other), each on the same card; each
process imports its tree's package, builds its kernels and, for the
bench model's width (C 512, 8 heads: csrc/decode.cu's first form) and
each (C, heads) of --widths (by default chip_smoke.py's NW_SHAPES), on
one block of a seed model (`entry.build(seed=0)` at that width) and
operands made from seed C on the host (16 streams, pos 160 of
(16, 321, C) caches):

- #13 through `BlockDecodeStack` (the weights packed once where the
  general form runs, as generate_kv(decode_impl='fused') runs it) and
  through `fused_block_decode` (the per-call wrapper, the weights in
  rows), and #12 through `fused_decode_attn` on (16, heads, 321,
  C / heads) caches;
- a sha256 of each output and of the written cache rows, so that two
  trees whose arithmetic is the same can be seen to give the same bits;
- the kernel's device ms a call (its launches, decode_kernel or
  decode_general by name, by torch.profiler over `--calls` calls, each
  after a 64 MB write that evicts the operands from L2), and the call's
  ms and the plain version's between CUDA events (median of 5 after a
  warm-up);
- in a tree whose wrapper takes `packed=`, #13 at the bench width on
  the general form too (the weights packed, which only it reads).

Prints one row per case, the card's name and power limit, and last one
JSON object with every turn's numbers. Needs a CUDA device; imports no
jax.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
B, T, POS, BENCH = 16, 321, 160, (512, 8)
FLUSH_BYTES = 64 << 20


def sha(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def child(tree: Path, widths: list, calls: int) -> dict:
    """One turn: every case on `tree`'s package."""
    sys.path.insert(0, str(tree))
    import inspect

    import torch
    from torch.profiler import ProfilerActivity, profile
    from vq_vae_transformer_arc_welding_tpu_torch.entry import build
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_decode as fdec)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    forced = "packed" in inspect.signature(fdec._check_operands).parameters

    def device_ms(fn) -> float:
        """ms a call of the decode kernels' launches, cold operands."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()
                   if "decode_kernel" in e.key
                   or "decode_general" in e.key) / 1e3 / calls

    def events_ms(fn) -> float:
        fn()
        got = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            got.append(start.elapsed_time(end))
        return statistics.median(got)

    out = {}
    with torch.inference_mode():
        for c, nh in [BENCH, *widths]:
            _, tr = build(d_model=c, n_heads=nh, n_blocks=1, hidden=16,
                          n_res=1, k=32, d=8, seed=0)
            blk, hd = tr.blocks[0], c // nh
            g = torch.Generator().manual_seed(c)
            x = torch.randn(B, 1, c, generator=g).to(dev)
            flat = [torch.randn(B, T, c, generator=g).to(dev)
                    for _ in range(2)]
            heads = [torch.randn(B, nh, T, hd, generator=g).to(dev)
                     for _ in range(2)]
            at = f"C {c}, {nh} heads"
            stack = fdec.BlockDecodeStack([blk], [tuple(flat)], n_head=nh)
            y = stack(x, POS).clone()
            out[f"#13 {at}"] = {
                "sha": sha(y, flat[0][:, POS], flat[1][:, POS]),
                "device_ms": device_ms(lambda: stack(x, POS)),
                "ms": events_ms(lambda: stack(x, POS)),
                "plain_ms": events_ms(
                    lambda: fdec.fused_block_decode_reference(
                        x, blk, *flat, POS, n_head=nh))}
            if forced and (c, nh) == BENCH:
                ops = fdec._check_operands(
                    "block_decode_f32", blk, *flat, (B, T, c), nh, True,
                    x.device, packed=True)
                scratch = fdec._scratch(B, c, ops[1], nh, x.device)
                args = fdec._pack(ops, *flat, (T * c, hd, c), scratch, B, T,
                                  c, ops[1], nh)
                lib = fdec.kernels.library()
                o = torch.empty_like(x)
                stream = torch.cuda.current_stream().cuda_stream

                def general():
                    import ctypes
                    err = lib.block_decode_f32(ctypes.addressof(args),
                                               x.data_ptr(), o.data_ptr(),
                                               POS, stream)
                    assert err == 0, err
                general()
                out[f"#13 {at} general form"] = {
                    "sha": sha(o, flat[0][:, POS], flat[1][:, POS]),
                    "device_ms": device_ms(general),
                    "ms": events_ms(general), "plain_ms": None}
            del stack
            y, _, _ = fdec.fused_block_decode(x, blk, *flat, POS, n_head=nh)
            out[f"#13 {at} per call"] = {
                "sha": sha(y, flat[0][:, POS], flat[1][:, POS]),
                "device_ms": device_ms(lambda: fdec.fused_block_decode(
                    x, blk, *flat, POS, n_head=nh)),
                "ms": events_ms(lambda: fdec.fused_block_decode(
                    x, blk, *flat, POS, n_head=nh)),
                "plain_ms": None}
            y, _, _ = fdec.fused_decode_attn(x, blk, *heads, POS, n_head=nh)
            out[f"#12 {at}"] = {
                "sha": sha(y, heads[0][:, :, POS], heads[1][:, :, POS]),
                "device_ms": device_ms(lambda: fdec.fused_decode_attn(
                    x, blk, *heads, POS, n_head=nh)),
                "ms": events_ms(lambda: fdec.fused_decode_attn(
                    x, blk, *heads, POS, n_head=nh)),
                "plain_ms": events_ms(
                    lambda: fdec.fused_decode_attn_reference(
                        x, blk, *heads, POS, n_head=nh))}
            del tr, blk, flat, heads
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout")
    ap.add_argument("--widths", default=None,
                    help="(C, heads) pairs as C:H,C:H (default NW_SHAPES)")
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.widths is None:
        sys.path.insert(0, str(REPO))
        import chip_smoke
        args.widths = ",".join(f"{c}:{h}" for c, h in chip_smoke.NW_SHAPES)
    widths = [tuple(map(int, w.split(":"))) for w in args.widths.split(",")
              if w]
    if args.child is not None:
        print(json.dumps(child(args.child, widths, args.calls)))
        return 0
    trees = ([("other", args.other), ("this", REPO), ("this", REPO),
              ("other", args.other)] if args.other is not None
             else [("this", REPO), ("this", REPO)])
    turns = []
    for name, tree in trees:
        res = subprocess.run(
            [sys.executable, __file__, "--child", str(tree.resolve()),
             "--widths", args.widths, "--calls", str(args.calls)],
            capture_output=True, text=True, cwd=tree)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-6000:], file=sys.stderr)
            return 1
        turns.append((name, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"turn {len(turns)} ({name}) done", flush=True)
    for case in turns[0][1] if args.other is None else turns[1][1]:
        row = [(name, t[case]) for name, t in turns if case in t]
        shas = {name: {r["sha"] for n, r in row if n == name}
                for name, _ in row}
        print(f"{case}: device ms " + ", ".join(
            f"{name} {r['device_ms']:.4f}" for name, r in row)
            + "; events ms " + ", ".join(
                f"{name} {r['ms']:.4f}" for name, r in row)
            + ("" if row[0][1]["plain_ms"] is None else "; plain ms " + ", ".join(
                f"{r['plain_ms']:.4f}" for _, r in row))
            + "; sha " + "; ".join(f"{n} {sorted(s)}"
                                   for n, s in shas.items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}")
    print(json.dumps({"gpu": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
