#!/usr/bin/env python3
"""Time the decode kernels #12 and #13 and the 'attn' int8 paths against
another tree's, on an NVIDIA GPU.

    python3 scripts/bench_decode_sm90.py --other DIR [--out FILE]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory such
as vq_vae_transformer_arc_welding_tpu_torch/_build/parent). The script
runs one process per turn, in the order other / this tree / this tree /
other, each on the same card, so that a drift of clocks falls on both
alike. Each process builds its tree's kernels, builds the bench model
(`entry.build(seed=0)`: the configuration of __graft_entry__._build,
random weights), calibrates the int8 pipeline on 8 windows and
measures (seed 0 for every input):

- #13 (`fused_block_decode`) and #12 (`fused_decode_attn`): device ms a
  call and device operations a call, from torch.profiler over one
  token's 8 calls (each block with its own weights and caches, 100 MB of
  weights and 168 MB of caches a token against 50 MB of L2: every call
  reads cold operands), at batch 16 and pos 160 and 320;
- `generate_kv(decode_impl='fused')`, greedy, batch 16, 320 steps:
  device ms and device operations a token (torch.profiler over one
  generation), and ms a token at batch 16 and 1 (CUDA events around a
  generation, median and quartiles of 5 after a warm-up);
- `make_pipeline_quantized` 'attn' and 'attn8' at batch 80: device ms a
  call (torch.profiler over 3 calls) and windows/s (CUDA events around
  one call, median of 10 after 3 warm-ups); `classify` windows/s the
  same way, with the default in-path saturation monitor and without it;
- for the comparison across turns: the 'attn' logits at batch 80, and
  the 'fused' step logits and their argmax ids along a forced sequence
  (the 'xla' greedy ids of the same generation).

Prints one row per metric, the card's name and power limit, and last
one JSON object with every turn's numbers (also written to FILE).
Needs a CUDA device; imports no jax.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent.parent
BATCH, N_CALIB, N_CYCLES = 80, 8, 20
SAMPLE_BATCH, STEPS = 16, 320
POSITIONS = (160, 320)


def device_trace(fn):
    """torch.profiler over fn() (after two warm-up runs in the same
    session): (device ms, device operations) of the last run."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=1,
                                   repeat=1)) as prof:
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            prof.step()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")]
    return (sum(e.self_device_time_total for e in dev) / 1e3,
            sum(e.count for e in dev))


def event_ms(fn, reps=10, warmup=3):
    """(median, first quartile, third quartile) ms of one fn() between
    two CUDA events."""
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
    q1, med, q3 = statistics.quantiles(times, n=4)
    return statistics.median(times), q1, q3


def measure(tree: Path, save: Path) -> dict:
    """One turn: the numbers of the module docstring for `tree`; the
    logits and ids to compare go to `save`."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_decode as fdec)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        merge_heads)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline)
    assert Path(kernels.__file__).is_relative_to(tree), kernels.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    vq, tr = build(seed=0)
    rng = np.random.default_rng(0)
    width = N_CYCLES * CYCLE_LEN
    calib = rng.standard_normal((N_CALIB, width, 2)).astype(np.float32)
    req = rng.standard_normal((BATCH, width, 2)).astype(np.float32)
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=BATCH,
                                  precision="int8", encoder_impl="fused")
    pipe.calibrate(calib)
    qp = pipe.qparams
    out = {"tree": str(tree)}
    nb, nh, c, t = tr.n_blocks, tr.n_head, tr.d_model, tr.seq_len
    start = torch.full((SAMPLE_BATCH, 1), pipe.start_token,
                       dtype=torch.int32, device="cuda")
    saved = {}

    with torch.inference_mode():
        # -- #13 and #12 a call, cold: a token's 8 blocks, own operands --
        ids = tr.generate_kv(start, num_steps=STEPS)
        heads = [tuple(torch.zeros(SAMPLE_BATCH, nh, t, c // nh,
                                   device="cuda") for _ in range(2))
                 for _ in range(nb)]
        tr._prefill(ids[:, :t], heads)
        flat = [tuple(merge_heads(z).contiguous() for z in kv)
                for kv in heads]
        x = tr._embed_token(ids[:, 1], 1)
        for pos in POSITIONS:
            for name, fn, store in (
                    ("#13", fdec.fused_block_decode, flat),
                    ("#12", fdec.fused_decode_attn, heads)):
                def token(fn=fn, store=store, pos=pos):
                    for blk, (k_c, v_c) in zip(tr.blocks, store):
                        fn(x, blk, k_c, v_c, pos, n_head=nh)
                busy, n_ops = device_trace(token)
                out[f"{name} device ms a call, pos {pos}"] = busy / nb
                out[f"{name} device operations a call, pos {pos}"] = (
                    n_ops / nb)

        # -- 'fused' sampling: device time and operations, ms a token ----
        def fused(b=SAMPLE_BATCH):
            return tr.generate_kv(start[:b], num_steps=STEPS,
                                  decode_impl="fused")
        busy, n_ops = device_trace(fused)
        out["'fused' device ms a token, batch 16"] = busy / STEPS
        out["'fused' device operations a token, batch 16"] = n_ops / STEPS
        for b in (SAMPLE_BATCH, 1):
            med, q1, q3 = event_ms(lambda: fused(b), reps=5, warmup=1)
            out[f"'fused' ms a token, batch {b}"] = med / STEPS
            out[f"'fused' ms a token, batch {b}, quartiles"] = (
                f"{q1 / STEPS:.4f}-{q3 / STEPS:.4f}")

        # the step logits along the 'xla' ids: the sampler's own loop,
        # its draws replaced by the next forced id
        seen = []

        def draw(last, *_a, **_k):
            seen.append(last.float().clone())
            return ids[:, len(seen)]
        with mock.patch.object(tr, "_sample_from_logits", draw):
            fused()
        logits = torch.stack(seen)
        saved["fused logits"] = logits.cpu()
        saved["fused forced ids"] = logits.argmax(-1).cpu()

        # -- 'attn', 'attn8' and classify at batch 80 ---------------------
        xb = torch.from_numpy(req).cuda()
        for name in ("attn", "attn8"):
            fn = make_pipeline_quantized(vq, tr, qp, block_fusion=name)
            busy, n_ops = device_trace(lambda: [fn(xb) for _ in range(3)])
            out[f"'{name}' device ms a call"] = busy / 3
            out[f"'{name}' device operations a call"] = n_ops / 3
            med, q1, q3 = event_ms(lambda: fn(xb))
            out[f"'{name}' windows/s"] = BATCH / (med / 1e3)
            if name == "attn":
                saved["attn logits"] = fn(xb).cpu()
    for monitor in (True, False):
        pipe.monitor_saturation = monitor
        med, _, _ = event_ms(lambda: pipe.classify(req))
        out[f"classify windows/s, monitor_saturation={monitor}"] = (
            BATCH / (med / 1e3))
    torch.save(saved, save)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path,
                    help="the other checkout, timed in turns with this one")
    ap.add_argument("--out", type=Path, help="write the JSON here too")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:           # one turn, in its own process
        print(json.dumps(measure(args.tree.resolve(), args.save)),
              flush=True)
        return 0
    if args.other is None:
        ap.error("--other DIR is required")
    import torch
    other = args.other.resolve()
    turns, saved = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, tree) in enumerate((("other", other), ("this", REPO),
                                           ("this", REPO),
                                           ("other", other))):
            save = Path(tmp) / f"turn{i}.pt"
            res = subprocess.run(
                [sys.executable, __file__, "--tree", str(tree), "--save",
                 str(save)], capture_output=True, text=True, cwd=tree)
            if res.returncode != 0:
                print(res.stdout[-4000:], res.stderr[-4000:],
                      file=sys.stderr)
                return res.returncode
            turns.append({"turn": label,
                          **json.loads(res.stdout.strip().splitlines()[-1])})
            saved.append(torch.load(save))
    first = saved[0]
    for turn, got in zip(turns, saved):
        turn["'attn' logits bit-equal to the first turn's"] = torch.equal(
            got["attn logits"], first["attn logits"])
        turn["'fused' forced ids differing from the first turn's"] = int(
            (got["fused forced ids"] != first["fused forced ids"]).sum())
        turn["'fused' step logits, largest difference from the first "
             "turn's"] = float((got["fused logits"]
                                - first["fused logits"]).abs().max())
    keys = [k for k in turns[0] if k not in ("tree", "turn")]
    print("metric: " + " / ".join(t["turn"] for t in turns)
          + f" ('fused' forced ids: {first['fused forced ids'].numel()})")
    for key in keys:
        print(f"{key}: " + " / ".join(f"{t[key]:.6g}" if isinstance(
            t[key], float) else str(t[key]) for t in turns))
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
