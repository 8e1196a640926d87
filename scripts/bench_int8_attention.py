#!/usr/bin/env python3
"""Time the int8 attention of kernels #2 and #6 (`int8_attn=True`, the
'attn8' and 'full8' paths) against another tree's, on an NVIDIA GPU.

    python3 scripts/bench_int8_attention.py --other DIR [--out FILE]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory such
as vq_vae_transformer_arc_welding_tpu_torch/_build/parent). The script
runs one process per turn, in the order other / this tree / this tree /
other, each on the same card, so that a drift of clocks falls on both
alike. Each process builds its tree's kernels, builds the bench model
(`entry.build(seed=0)`: the configuration of __graft_entry__._build,
random weights), calibrates the int8 pipeline on 8 windows and
measures at batch 80 (seed 0 for every input):

- device ms per call of `make_pipeline_quantized` 'attn8' and 'full8',
  and of the int8 attention's two launches in it (the per-head scales
  or quantizing pass, every kernel whose name holds "head_", and
  attention_int8_kernel), from torch.profiler over 3 calls after 2
  warm-up calls;
- device ms per call of #2 and #6 with int8_attn on block 0's
  operands, over 10 calls, and the median ms a launch of the two
  kernels of the int8 attention in #2 ("a block");
- windows/s of 'attn8' and 'full8': CUDA events around one call (host
  launch included), median of 10 after 3 warm-up calls;
- y8, #2's int8 attention output on block 0, and the per-head scales,
  compared across turns: the share of y8 entries that differ from the
  first turn's (the other tree's) and the largest step.

Prints one table row per metric, the card's name and power limit, and
last one JSON object with every turn's numbers (also written to FILE).
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

REPO = Path(__file__).resolve().parent.parent
BATCH, N_CALIB, N_CYCLES = 80, 8, 20
SCALES, ATTENTION = "head_", "attention_int8_kernel"


def device_trace(fn, calls):
    """torch.profiler over `calls` calls of fn (after two warm-up rounds
    in the same session): device ms per call, and every device kernel as
    (name, ms) in launch order."""
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
    kernels = sorted(
        (e.time_range.start, e.name, e.time_range.elapsed_us() / 1e3)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.startswith("ProfilerStep"))
    return (sum(ms for _, _, ms in kernels) / calls,
            [(name, ms) for _, name, ms in kernels])


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


def measure(tree: Path, save: Path) -> dict:
    """One turn: the numbers of the module docstring for `tree`; y8 and
    the scales go to `save`."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_block_quant as fbq)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline, with_start_token)
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

    def attention_ms(launched, calls):
        """ms per call of the int8 attention's scales and attention
        launches in a trace."""
        return {what: sum(ms for key, ms in launched if pick in key) / calls
                for what, pick in (("scales", SCALES),
                                   ("attention", ATTENTION))}

    with torch.inference_mode():
        x = torch.from_numpy(req).cuda()
        for name in ("attn8", "full8"):
            fn = make_pipeline_quantized(vq, tr, qp, block_fusion=name)
            busy, launched = device_trace(lambda: fn(x), 3)
            out[f"'{name}' device ms"] = busy
            for what, ms in attention_ms(launched, 3).items():
                out[f"'{name}' int8 attention {what} device ms"] = ms
            out[f"'{name}' windows/s"] = BATCH / (event_ms(lambda: fn(x))
                                                  / 1e3)
        ids = torch.as_tensor(pipe.encode_tokens(req)).cuda()
        ids = with_start_token(ids.reshape(BATCH, -1), pipe.start_token)
        xs = (qp["tok_emb"][ids.long()] + tr.pe[None, :ids.shape[1]]
              ).contiguous()
        blk = qp["blocks"][0]
        scales, vc, v3c, v4c = blk["block_operands"]
        w = {k: blk[k].w_int8 for k in ("c_attn", "c_proj", "c_fc",
                                         "m_proj")}
        nh = tr.n_head
        calls = {
            "#2": lambda sc=None: fbq.attn_block_quant(
                xs, w["c_attn"], w["c_proj"], scales, vc[:6], v3c,
                n_head=nh, int8_attn=True, scratch=sc),
            "#6": lambda sc=None: fbq.block_quant(
                xs, w["c_attn"], w["c_proj"], w["c_fc"], w["m_proj"],
                scales, vc, v3c, v4c, n_head=nh, int8_attn=True,
                scratch=sc),
        }
        for name, fn in calls.items():
            busy, launched = device_trace(fn, 10)
            out[f"{name} int8_attn device ms"] = busy
            if name == "#2":
                for what, pick in (("scales", SCALES),
                                   ("attention", ATTENTION)):
                    out[f"#2 int8 attention {what} ms a block"] = (
                        statistics.median(ms for key, ms in launched
                                          if pick in key))
                out["#2 int8 attention + scales ms a block"] = (
                    out["#2 int8 attention scales ms a block"]
                    + out["#2 int8 attention attention ms a block"])
        sc = {}
        calls["#2"](sc)
        torch.cuda.synchronize()
        torch.save({"y8": sc["y8"].cpu(),
                    "head_scales": sc["head_scales"].cpu()}, save)
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
        diff = (got["y8"].int() - first["y8"].int()).abs()
        turn["y8 share differing from the first turn"] = float(
            diff.ne(0).float().mean())
        turn["y8 largest step from the first turn"] = int(diff.max())
        turn["y8 entries differing from the first turn"] = int(
            diff.ne(0).sum())
        turn["head_scales equal to the first turn's"] = float(torch.equal(
            got["head_scales"], first["head_scales"]))
    keys = [k for k in turns[0] if k not in ("tree", "turn")]
    print(f"metric: " + " / ".join(t["turn"] for t in turns)
          + f" (y8: {first['y8'].numel()} entries)")
    for key in keys:
        print(f"{key}: " + " / ".join(f"{t[key]:.4f}" if isinstance(
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
