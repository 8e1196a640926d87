#!/usr/bin/env python3
"""Time `classify` with its in-path saturation monitor, and the kernels
under it, against another tree's, on an NVIDIA GPU.

    python3 scripts/bench_classify_monitor.py --other DIR [--out FILE]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory such
as vq_vae_transformer_arc_welding_tpu_torch/_build/parent). The script
runs one process per turn, in the order other / this tree / this tree /
other, each on the same card, so that a drift of clocks falls on both
alike. Each process builds its tree's kernels, builds the bench model
(`entry.build(seed=0)`: the configuration of __graft_entry__._build,
random weights), calibrates `WeldingQualityPipeline(precision="int8",
encoder_impl="fused", max_batch=80)` on 8 windows and measures at batch
80 (seed 0 for every input):

- `classify` windows/s with the default monitor (`monitor_saturation`)
  and without it: CUDA events around one call, which returns numpy
  arrays (host work included), median and quartiles of 10 after 3
  warm-up calls; and its device ms a call with the monitor, from
  torch.profiler over 3 calls after 2 warm-up rounds;
- `make_pipeline_quantized('attn')`: device ms a call the same way,
  with the share of LN+q8 (every kernel whose name holds
  "ln_q8_kernel", #2's two launches a block) and its ms a launch;
- #2 (`fused_attn_block_quant`) on block 0 alone, and c_fc (the int8
  GEMM with the GELU+q8 epilogue on block 0's h8) at the calibrated act
  scale (where nothing clips) and at twice it (half the absmax, where
  the monitor's counts are not all 0), with and without the counts
  where the tree has them:
  device ms a call from torch.profiler over 10 calls, each after a 64
  MB write that evicts its operands from L2, with LN+q8's ms a launch
  inside #2;
- the monitor's rate on the request, and on the same request through a
  pipeline whose act scales come from half the calibrated absmax;
- for the comparison across turns: the 'attn' logits, classify's
  probabilities with the monitor, and the drifted pipeline's labels.

Prints one row per metric, the card's name and power limit, and last
one JSON object with every turn's numbers (also written to FILE).
Needs a CUDA device; imports no jax.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BATCH, N_CALIB, N_CYCLES = 80, 8, 20
LN_Q8 = "ln_q8_kernel"
FLUSH_BYTES, FLUSH_KEY = 64 << 20, "bitwise_not"


def device_trace(fn, leave_out=None):
    """torch.profiler over fn() (after two warm-up runs in the same
    session): (device ms, [(kernel name, launches, ms)]) of the last
    run; kernels whose name holds `leave_out` are left out."""
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
           and not e.key.startswith("ProfilerStep")
           and not (leave_out and leave_out in e.key)]
    return (sum(e.self_device_time_total for e in dev) / 1e3,
            [(e.key, e.count, e.self_device_time_total / 1e3) for e in dev])


def cold_trace(fn, calls=10):
    """device_trace of `calls` calls of fn, each after a 64 MB write:
    (device ms a call, [(kernel name, launches a call, ms a call)])."""
    import torch
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def run():
        for _ in range(calls):
            flush.bitwise_not_()
            fn()
    busy, names = device_trace(run, leave_out=FLUSH_KEY)
    return busy / calls, [(k, n / calls, ms / calls) for k, n, ms in names]


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


def ln_part(names):
    """(LN+q8 launches, their ms) in a trace's [(name, launches, ms)]."""
    got = [(n, ms) for key, n, ms in names if LN_Q8 in key]
    return tuple(sum(v) for v in zip(*got)) if got else (0, 0.0)


def measure(tree: Path, save: Path) -> dict:
    """One turn: the numbers of the module docstring for `tree`; what the
    turns compare goes to `save`."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.models.quantized import (
        quantize_transformer)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_block_quant as fbq, int8_gemm as ig)
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
    am = pipe.calibrate(calib)
    qp = pipe.qparams
    out = {"tree": str(tree)}
    saved = {}

    # -- classify with the monitor on and off --------------------------------
    for monitor in (True, False):
        pipe.monitor_saturation = monitor
        med, q1, q3 = event_ms(lambda: pipe.classify(req))
        out[f"classify windows/s, monitor {'on' if monitor else 'off'}"] = (
            BATCH / (med / 1e3))
        out[f"classify ms, monitor {'on' if monitor else 'off'}, "
            f"quartiles"] = f"{q1:.3f}-{q3:.3f}"
    pipe.monitor_saturation = True
    busy, _ = device_trace(lambda: [pipe.classify(req) for _ in range(3)])
    out["classify device ms a call, monitor on"] = busy / 3
    _, probs = pipe.classify(req)
    saved["classify probs"] = torch.from_numpy(probs)
    out["saturation rate"] = pipe.last_saturation_rate
    drifted = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES,
                                     max_batch=BATCH, precision="int8",
                                     encoder_impl="fused")
    with torch.inference_mode():
        drifted.qparams = quantize_transformer(
            tr, act_absmax={k: v / 2 for k, v in am.items()})
    labels, _ = drifted.classify(req)
    saved["drifted labels"] = torch.from_numpy(labels)
    out["saturation rate, act scales of half the absmax"] = (
        drifted.last_saturation_rate)

    with torch.inference_mode():
        # -- 'attn' a call, LN+q8's share -----------------------------------
        xb = torch.from_numpy(req).cuda()
        fn = make_pipeline_quantized(vq, tr, qp, block_fusion="attn")
        busy, names = device_trace(lambda: [fn(xb) for _ in range(3)])
        n_ln, ln_ms = ln_part(names)
        out["'attn' device ms a call"] = busy / 3
        out["'attn' LN+q8 launches a call"] = n_ln / 3
        out["'attn' LN+q8 device ms a call"] = ln_ms / 3
        out["'attn' LN+q8 device ms a launch"] = ln_ms / n_ln
        saved["attn logits"] = fn(xb).cpu()

        # -- #2 and c_fc on block 0, cold ------------------------------------
        ids = pipe._encode_fn(xb, fused=True)
        ids = with_start_token(ids, pipe.start_token)
        xs = (qp["tok_emb"][ids.long()]
              + tr.pe[None, :ids.shape[1]]).contiguous()
        blk = qp["blocks"][0]
        ms, names = cold_trace(lambda: fbq.fused_attn_block_quant(
            xs, blk, n_head=tr.n_head))
        n_ln, ln_ms = ln_part(names)
        out["#2 device ms a call, block 0, cold"] = ms
        out["#2 LN+q8 device ms a launch, cold"] = ln_ms / n_ln
        _, h8 = fbq.fused_attn_block_quant(xs, blk, n_head=tr.n_head)
        scales, _, _, v4c = blk["block_operands"]
        args = (h8.reshape(-1, h8.shape[-1]), blk["c_fc"].w_int8, v4c[0],
                v4c[1])
        counts = "clip_rows" in inspect.signature(ig.int8_gemm).parameters
        clip = torch.zeros(args[0].shape[0], dtype=torch.int32,
                           device="cuda")
        for what, qs in (("", scales[3]), (", drifted", scales[3] * 2)):
            out[f"c_fc device ms a call{what}, cold"] = cold_trace(
                lambda: ig.int8_gemm(*args, qscale=qs))[0]
            if counts:
                out[f"c_fc device ms a call{what}, counted, cold"] = (
                    cold_trace(lambda: ig.int8_gemm(
                        *args, qscale=qs, clip_rows=clip))[0])
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
        for what in ("attn logits", "classify probs", "drifted labels"):
            turn[f"{what} bit-equal to the first turn's"] = torch.equal(
                got[what], first[what])
    keys = list(dict.fromkeys(k for t in turns for k in t
                              if k not in ("tree", "turn")))
    print("metric: " + " / ".join(t["turn"] for t in turns))
    for key in keys:
        print(f"{key}: " + " / ".join(
            f"{t[key]:.6g}" if isinstance(t.get(key), float)
            else str(t.get(key, "not in this tree")) for t in turns))
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
