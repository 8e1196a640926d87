#!/usr/bin/env python3
"""Time kernel #9 on bf16 q, k and v (`flash_attention_bf16`) against
another tree's, on an NVIDIA GPU.

    python3 scripts/bench_flash_bf16.py --other DIR [--out FILE]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory such
as vq_vae_transformer_arc_welding_tpu_torch/_build/parent). The script
runs one process per turn, in the order other / this tree / this tree /
other, each on the same card, so that a drift of clocks falls on both
alike. Each process builds its tree's kernels and, at every shape of
chip_smoke.py's FLASH_BF16_SHAPES (T = 321; q, k, v the views of a
packed bf16 qkv of spread 2, made from the seed), measures with this
tree's chip_smoke.py helpers:

- the share of output entries that differ from the plain version's and
  the entries beyond one bf16 step and 2e-5 (the card's gate);
- ms of one call, CUDA events, median of 10 in turns with
  `scaled_dot_product_attention(is_causal=True)` on the same operands;
- device ms of one call of each on cold operands (torch.profiler over
  20 calls, each after a 64 MB write: chip_smoke.kernel_trace);
- the bound of chip_smoke.kernel_work and the share of it reached.

Prints one line per shape and turn, the card's name and power limit,
and last one JSON object with every turn's numbers (also written to
FILE). Needs a CUDA device; imports no jax.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
T, SPREAD, CALLS = 321, 2.0, 20


def measure(tree: Path) -> list:
    """One turn: the numbers of the module docstring for `tree`'s kernel,
    one dict per shape."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        attention, fused_attn)
    assert Path(kernels.__file__).is_relative_to(tree), kernels.__file__
    kernels.library()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for b, h, d in cs.FLASH_BF16_SHAPES:
        c = h * d
        gen = torch.Generator().manual_seed(cs.SEED)
        qkv = (torch.randn(b, T, 3 * c, generator=gen) * SPREAD).to(
            "cuda", torch.bfloat16)
        q, k, v = (attention.split_heads(z, h) for z in qkv.split(c, dim=-1))
        with torch.inference_mode():
            out, counts = cs.counted(
                lambda: fused_attn.flash_causal_attention(q, k, v))
            ref = fused_attn.flash_causal_attention_reference(q, k, v)
            ulps = (out.view(torch.int16).int()
                    - ref.view(torch.int16).int()).abs()
            err = (out.float() - ref.float()).abs()
            tm = cs.timed_in_turns({
                "kernel": lambda: fused_attn.flash_causal_attention(q, k, v),
                "library": lambda: sdpa(q, k, v, is_causal=True)})
            traced = cs.kernel_trace({
                "kernel": lambda: fused_attn.flash_causal_attention(q, k, v),
                "library": lambda: sdpa(q, k, v, is_causal=True)},
                calls=CALLS)
        bound, by = cs.bound_of(cs.kernel_work(
            1, c, 1, 1, 25, 32, 256, b, T, h, 1, 1)[cs.FLASH_BF16])
        dev_ms = traced["kernel"][0]
        rows.append({
            "shape": [b, h, T, d], "launches": counts,
            "diff_share": float((ulps > 0).float().mean()),
            "beyond_gate": int(((ulps > 1) & (err > cs.MAX_ROW_ERR)).sum()),
            "ms": tm["kernel"][0], "library_ms": tm["library"][0],
            "device_ms": dev_ms, "library_device_ms": traced["library"][0],
            "kernels": [key for key, _, _ in traced["kernel"][2]],
            "bound_ms": bound, "bound_by": by,
            "bound_share": None if dev_ms is None else bound / dev_ms})
    return rows


def fmt(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path,
                    help="the other checkout, timed in turns with this one")
    ap.add_argument("--out", type=Path, help="write the JSON here too")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:           # one turn, in its own process
        print(json.dumps(measure(args.tree.resolve())), flush=True)
        return 0
    if args.other is None:
        ap.error("--other DIR is required")
    other = args.other.resolve()
    turns = []
    for label, tree in (("other", other), ("this", REPO), ("this", REPO),
                        ("other", other)):
        res = subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                             capture_output=True, text=True, cwd=tree)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        rows = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append({"turn": label, "tree": str(tree), "shapes": rows})
        for r in rows:
            print(f"{label} {tuple(r['shape'])}: device {fmt(r['device_ms'])}"
                  f" ms ({fmt(r['bound_share'])} of the bound "
                  f"{r['bound_ms']:.5f} by {r['bound_by']}), SDPA device "
                  f"{fmt(r['library_device_ms'])}; events {r['ms']:.4f}, "
                  f"SDPA {r['library_ms']:.4f}; differing share "
                  f"{r['diff_share']:.2e}, beyond the gate "
                  f"{r['beyond_gate']}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}")
    record = {"gpu": smi, "turns": turns}
    if args.out is not None:
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
