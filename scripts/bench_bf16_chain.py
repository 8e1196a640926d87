#!/usr/bin/env python3
"""Time the bf16 encoder chain (1b) and the nearest-code kernel (#7)
against another tree's, end to end too, on an NVIDIA GPU.

    python3 scripts/bench_bf16_chain.py --other DIR [--out FILE]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory such
as vq_vae_transformer_arc_welding_tpu_torch/_build/parent). The script
runs one process per turn, in the order other / this tree / this tree /
other, each on the same card. Each process builds its tree's kernels,
builds the bench model (`entry.build(seed=0)`: the configuration of
__graft_entry__._build, random weights), calibrates the int8 pipeline on
8 windows and measures at batch 80 (seed 0 for every input):

- device ms per launch of 1b (`fused_encoder_eval(compute_dtype=bf16)`,
  all eight resblocks on the 80-window request's 25,600 patch-embed
  rows, the bf16 pack's operand handed over where the tree's pack has
  one) and of #1 (the default group of four, the split handed over),
  from torch.profiler over 10 calls; and of #7
  (`fused_vq.nearest_codes_pallas` on the model's z of those rows and
  its (256, 32) codebook);
- ms of one 1b and one #7 launch between CUDA events (host launch
  included, the median of 10 after 3 warm-ups);
- device ms per call (torch.profiler over 3 calls) and windows/s (one
  call between events, the median of 10) of `make_pipeline_quantized`
  'full' with `encoder_dtype=torch.bfloat16` and with the f32 encoder,
  and of 'attn'; windows/s of `classify` (host work included); the
  labels of 'full' with the bf16 encoder, which the turns compare.

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
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BATCH, N_CALIB, N_CYCLES = 80, 8, 20


def device_ms(fn, calls, word=None):
    """torch.profiler over `calls` calls of fn after two warm-ups: device
    ms per call of every kernel, or of those whose name holds `word`,
    per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and (word is None or word in e.key)]
    total = sum(e.self_device_time_total for e in evs) / 1e3
    count = sum(e.count for e in evs)
    return total / calls if word is None else total / max(count, 1)


def event_ms(fn, reps=10, warmup=3):
    import torch
    times = []
    for i in range(warmup + reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def measure(tree: Path) -> dict:
    """One turn: the numbers of the module docstring for `tree`."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_encoder as fenc, fused_vq as fvq)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline)
    assert Path(kernels.__file__).is_relative_to(tree), kernels.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    bf = torch.bfloat16
    vq, tr = build(seed=0)
    rng = np.random.default_rng(0)
    width = N_CYCLES * CYCLE_LEN
    calib = rng.standard_normal((N_CALIB, width, 2)).astype(np.float32)
    req = rng.standard_normal((BATCH, width, 2)).astype(np.float32)
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=BATCH,
                                  precision="int8", encoder_impl="fused")
    pipe.calibrate(calib)
    out = {"tree": str(tree)}
    with torch.inference_mode():
        x = torch.from_numpy(req).cuda()
        h = vq.patch_embed_out(x.reshape(-1, CYCLE_LEN, 2))
        flat = h.reshape(-1, h.shape[-1]).contiguous()
        packed, packed_bf = fenc.pack_encoder(vq), fenc.pack_encoder(vq, bf)
        vecs = packed[1]
        grp = fenc.group_size_for(vq.hidden_dim)
        bf_kw = ({} if getattr(packed_bf, "split", None) is None
                 else {"split": packed_bf.split})

        def chain_bf16():
            return fenc.fused_encoder_eval(flat, packed_bf[0], vecs,
                                           use_bn=False, compute_dtype=bf,
                                           **bf_kw)

        def chain_f32():
            return fenc.fused_encoder_eval(
                flat, packed[0][:2 * grp], vecs[:10 * grp], use_bn=False,
                split=packed.split[:2 * grp])

        z = vq.sep_conv(fenc.fused_encoder_eval_reference(
            flat, packed[0], vecs, use_bn=False).reshape(h.shape))
        z = z.reshape(-1, vq.embedding_dim).contiguous()

        def nearest():
            return fvq.nearest_codes_pallas(z, vq.codebook)

        rows = flat.shape[0]
        out[f"1b {rows} rows x {vq.n_resblocks} device ms"] = device_ms(
            chain_bf16, 10, "encoder_chain_bf16")
        out[f"#1 {rows} rows x {grp} device ms"] = device_ms(
            chain_f32, 10, "encoder_chain_kernel")
        out[f"#7 {rows} rows device ms"] = device_ms(nearest, 10,
                                                     "nearest_codes")
        out[f"1b {rows} rows x {vq.n_resblocks} event ms"] = event_ms(
            chain_bf16)
        out[f"#7 {rows} rows event ms"] = event_ms(nearest)
        fns = {"'full' bf16 encoder": make_pipeline_quantized(
                   vq, tr, pipe.qparams, block_fusion="full",
                   encoder_dtype=bf),
               "'full'": make_pipeline_quantized(vq, tr, pipe.qparams,
                                                 block_fusion="full"),
               "'attn'": make_pipeline_quantized(vq, tr, pipe.qparams,
                                                 block_fusion="attn")}
        for name, fn in fns.items():
            out[f"{name} device ms"] = device_ms(lambda: fn(x), 3)
            out[f"{name} windows/s"] = BATCH / (event_ms(lambda: fn(x))
                                                / 1e3)
        labels = fns["'full' bf16 encoder"](x).argmax(-1)
        out["labels"] = labels.cpu().tolist()
    out["classify windows/s"] = BATCH / (event_ms(
        lambda: pipe.classify(req)) / 1e3)
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
    keys = [k for k in turns[0] if k not in ("tree", "turn", "labels")]
    print("metric: " + " / ".join(t["turn"] for t in turns))
    for key in keys:
        print(f"{key}: " + " / ".join(f"{t[key]:.4f}" for t in turns))
    same = [sum(a == b for a, b in zip(t["labels"], turns[0]["labels"]))
            for t in turns]
    print(f"'full' bf16 encoder labels equal to the first turn's: "
          + " / ".join(f"{n} of {BATCH}" for n in same))
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
