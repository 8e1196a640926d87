#!/usr/bin/env python3
"""Time the int8 GEMM of kernels #2, #6, #8 and #10 against another
tree's, on an NVIDIA GPU.

    python3 scripts/bench_int8_gemm.py --other DIR [--out FILE]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory such
as vq_vae_transformer_arc_welding_tpu_torch/_build/parent). The script
runs one process per turn, in the order other / this tree / this tree /
other, each on the same card, so that a drift of clocks falls on both
alike. Each process builds its tree's kernels, builds the bench model
(`entry.build(seed=0)`: the configuration of __graft_entry__._build,
random weights), calibrates the int8 pipeline on 8 windows and
measures at batch 80 (seed 0 for every input):

- device ms per call of `make_pipeline_quantized` 'attn' and 'full',
  and of the int8 GEMM launches in it (every kernel whose name holds
  "int8_gemm"), from torch.profiler over 3 calls after 2 warm-up calls;
- device ms per call of #2 (attn_block_quant), #6 (block_quant), #8
  (mlp_quant) and #10 (qkv_attention_quant) on block 0's operands, the
  same way over 10 calls, and of #6's four GEMM launches in launch order
  (qkv, c_proj, c_fc, m_proj);
- windows/s of 'attn' and 'full': CUDA events around one call (host
  launch included), median of 10 after 3 warm-up calls.

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
GEMM_SHAPES = ("qkv", "c_proj", "c_fc", "m_proj")


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


def measure(tree: Path) -> dict:
    """One turn: the numbers of the module docstring for `tree`."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn_quant as fattn, fused_block_quant as fbq,
        fused_mlp_quant as fmlp)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
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
    with torch.inference_mode():
        x = torch.from_numpy(req).cuda()
        for name in ("attn", "full"):
            fn = make_pipeline_quantized(vq, tr, qp, block_fusion=name)
            busy, launched = device_trace(lambda: fn(x), 3)
            out[f"'{name}' device ms"] = busy
            out[f"'{name}' GEMM device ms"] = sum(
                ms for key, ms in launched if "int8_gemm" in key) / 3
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
        h1 = layer_norm(xs, blk["ln1_scale"], blk["ln1_bias"]).contiguous()
        h2 = layer_norm(xs, blk["ln2_scale"], blk["ln2_bias"]).contiguous()
        calls = {
            "#2": lambda: fbq.attn_block_quant(
                xs, w["c_attn"], w["c_proj"], scales, vc[:6], v3c,
                n_head=nh),
            "#6": lambda: fbq.block_quant(
                xs, w["c_attn"], w["c_proj"], w["c_fc"], w["m_proj"],
                scales, vc, v3c, v4c, n_head=nh),
            "#8": lambda: fmlp.mlp_quant(h2, w["c_fc"], w["m_proj"],
                                         scales[2:], v4c, vc[6:]),
            "#10": lambda: fattn.qkv_attention_quant(
                h1, w["c_attn"], scales[:2], v3c, n_head=nh),
        }
        for name, fn in calls.items():
            busy, launched = device_trace(fn, 10)
            out[f"{name} device ms"] = busy
            if name == "#6":
                gemms = [ms for key, ms in launched if "int8_gemm" in key]
                for i, shape in enumerate(GEMM_SHAPES):
                    out[f"#6 GEMM {shape} device ms"] = statistics.median(
                        gemms[i::len(GEMM_SHAPES)])
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
        print(f"{key}: " + " / ".join(f"{t[key]:.4f}" for t in turns))
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
