#!/usr/bin/env python3
"""Time the encoder kernels off the tiles' widths (csrc/encoder_wide.cu:
`encoder_wide_f32`, `encoder_wide_bf16`) against another tree's, on an
NVIDIA GPU.

    python3 scripts/bench_encoder_wide.py --other DIR [--out FILE]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory such
as vq_vae_transformer_arc_welding_tpu_torch/_build/parent). The script
runs one process per turn, in the order other / this tree / this tree /
other, each on the same card. Each process builds its tree's kernels
and, for each case of CASES (rows, hidden width, resblocks, f32 or
bf16; random weights at the encoder's init spread and eval BN rows,
seed 0), calls `fused_encoder_eval` (which runs the case on
encoder_wide.cu) and its plain version `fused_encoder_eval_reference`
and reports:

- device ms per call of the kernel's launches (every kernel whose name
  holds "product_kernel"), from torch.profiler over 5 calls after two
  warm-up rounds;
- ms of one call between CUDA events (host launch included), and of the
  plain version, each the median of 10 after 3 warm-up calls;
- the largest |kernel - plain| over the plain output's largest value,
  and a sha256 of the kernel's output bytes, so that two trees whose
  arithmetic is the same can be seen to give the same bits.

Prints one row per case and metric, the card's name and power limit,
and last one JSON object with every turn's numbers (also written to
FILE). Needs a CUDA device; imports no jax.
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
# (rows, hidden, resblocks, dtype): the served hidden-1,024 model's
# launches at 25,600 rows (one f32 resblock a launch, JAX's group rule;
# bf16 as chip_smoke.py's shapes phase times it), then the shapes
# phase's widths at 6,400 rows
CASES = ((25600, 1024, 1, "f32"), (25600, 1024, 2, "bf16"),
         (6400, 576, 2, "f32"), (6400, 768, 2, "f32"), (6400, 1024, 2, "f32"),
         (6400, 4096, 2, "f32"), (6400, 64, 2, "bf16"), (6400, 256, 2, "bf16"),
         (6400, 576, 2, "bf16"), (6400, 1024, 2, "bf16"))


def device_ms(fn, calls, word):
    """Device ms per call of fn's kernels whose name holds `word`, by
    torch.profiler (two warm-up rounds, then one traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=1,
                                   repeat=1)) as prof:
        for _ in range(3):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and word in e.name) / calls


def event_ms(fn, reps=10, warmup=3):
    """Median ms of one fn() between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def operands(rows, c, n_blocks, gen):
    """x (rows, c), weights (2 n, c, c) at the encoder's init spread and
    vector rows (10 n, c): a bias, then eval BN rows."""
    import torch
    bound = (6.0 / (2 * c * 3)) ** 0.5
    w = (torch.rand(2 * n_blocks, c, c, generator=gen) * 2 - 1) * bound
    v = torch.zeros(n_blocks, 2, 5, c)
    v[:, :, 0] = torch.randn(n_blocks, 2, c, generator=gen) * 0.1
    v[:, :, 1] = torch.randn(n_blocks, 2, c, generator=gen) * 0.1
    v[:, :, 2] = torch.rand(n_blocks, 2, c, generator=gen) + 0.5
    v[:, :, 3] = torch.rand(n_blocks, 2, c, generator=gen) + 0.5
    v[:, :, 4] = torch.randn(n_blocks, 2, c, generator=gen) * 0.1
    x = torch.randn(rows, c, generator=gen)
    return x.cuda(), w.cuda(), v.reshape(10 * n_blocks, c).cuda()


def measure(tree: Path) -> dict:
    """One turn: the numbers of the module docstring for `tree`."""
    sys.path.insert(0, str(tree))
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_encoder as fenc)
    assert Path(kernels.__file__).is_relative_to(tree), kernels.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    gen = torch.Generator().manual_seed(0)
    out = {"tree": str(tree)}
    with torch.inference_mode():
        for rows, c, nb, dt in CASES:
            x, w, v = operands(rows, c, nb, gen)
            cd = torch.bfloat16 if dt == "bf16" else None
            if cd is not None:
                w = w.to(cd)

            def kern():
                return fenc.fused_encoder_eval(x, w, v, use_bn=True,
                                               compute_dtype=cd)

            def plain():
                return fenc.fused_encoder_eval_reference(
                    x, w, v, use_bn=True, compute_dtype=cd)

            got, ref = kern(), plain()
            key = f"{dt} hidden {c} x{nb} {rows} rows"
            out[f"{key} device ms"] = device_ms(kern, 5, "product_kernel")
            out[f"{key} ms"] = event_ms(kern)
            out[f"{key} plain ms"] = event_ms(plain)
            out[f"{key} err"] = float((got - ref).abs().max()
                                      / ref.abs().max())
            out[f"{key} sha256"] = hashlib.sha256(
                got.cpu().numpy().tobytes()).hexdigest()[:16]
            del x, w, v, got, ref
    return out


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
        turns.append({"turn": label,
                      **json.loads(res.stdout.strip().splitlines()[-1])})
    keys = [k for k in turns[0] if k not in ("tree", "turn")]
    print("metric: " + " / ".join(t["turn"] for t in turns))
    for key in keys:
        print(f"{key}: " + " / ".join(
            f"{t[key]:.4f}" if isinstance(t[key], float) else str(t[key])
            for t in turns))
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
