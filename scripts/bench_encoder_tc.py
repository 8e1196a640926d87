#!/usr/bin/env python3
"""Time the f32 encoder kernels #1, #3, #4 and #5 against another tree's,
on an NVIDIA GPU.

    python3 scripts/bench_encoder_tc.py --other DIR [--out FILE]

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
  and of the #1 launches in it (every kernel whose name holds
  "encoder_chain"), from torch.profiler over 3 calls after 2 warm-up
  calls;
- device ms per launch of #1 (`fused_encoder_eval`, the default group
  of four resblocks) on the patch-embed output of the 80-, 37- and
  1-window requests (25,600, 11,840 and 320 rows), and of #3
  (`resblock_eval`, resblock 0) at 25,600 rows, the same way over 10
  calls; a tree whose pack carries the split-TF32 operand (`split`)
  hands it to the wrappers, as its encoder paths do;
- device ms per launch of the encoder's ends at 25,600 rows, as
  `encode_indices_fused_edges` calls them: #4 (`fused_encoder_entry_eval`,
  patch-embed and the first group) and #5 (`fused_encoder_exit_eval`,
  the last group, sep_conv and the nearest code, on the patch-embed
  output), the same way, handed the split where the tree's wrappers
  take it;
- ms of one #1 and one #3 launch at 25,600 rows between CUDA events
  (host launch included), and windows/s of 'attn' and 'full' (one call
  between events), of `classify` (host work included: it returns
  numpy) and of `encode_indices_fused_edges` followed by the 'full'
  transformer (as chip_smoke.py's phase 9), each the median of 10
  after 3 warm-up calls.

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
REQUEST_WINDOWS = (80, 37, 1)


def device_trace(fn, calls):
    """torch.profiler over `calls` calls of fn (after two warm-up rounds
    in the same session): device ms per call, and every device kernel as
    (name, ms)."""
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
    kernels = [(e.name, e.time_range.elapsed_us() / 1e3)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    return sum(ms for _, ms in kernels) / calls, kernels


def kernel_ms(fn, calls, word):
    """Device ms per call of fn's kernels whose name holds `word`."""
    _, launched = device_trace(fn, calls)
    return sum(ms for key, ms in launched if word in key) / calls


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
    import inspect
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.models.quantized import (
        quantized_classify)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_encoder as fenc)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.patching import (
        patchify)
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
    out = {"tree": str(tree)}
    with torch.inference_mode():
        x = torch.from_numpy(req).cuda()
        for name in ("attn", "full"):
            fn = make_pipeline_quantized(vq, tr, pipe.qparams,
                                         block_fusion=name)
            busy, launched = device_trace(lambda: fn(x), 3)
            out[f"'{name}' device ms"] = busy
            out[f"'{name}' #1 device ms"] = sum(
                ms for key, ms in launched if "encoder_chain" in key) / 3
            out[f"'{name}' windows/s"] = BATCH / (event_ms(lambda: fn(x))
                                                  / 1e3)
        h = vq.patch_embed_out(x.reshape(-1, CYCLE_LEN, 2))
        flat = h.reshape(-1, h.shape[-1]).contiguous()
        per_window = flat.shape[0] // BATCH
        packed = fenc.pack_encoder(vq)
        weights, vecs = packed[0], packed[1]
        split = getattr(packed, "split", None)
        grp = fenc.group_size_for(vq.hidden_dim)

        def chain(rows):
            kw = {} if split is None else {"split": split[:2 * grp]}
            return lambda: fenc.fused_encoder_eval(
                flat[:rows], weights[:2 * grp], vecs[:10 * grp],
                use_bn=False, **kw)

        def one():
            kw = {} if split is None else {"split": split[:2]}
            return fenc.resblock_eval(flat, weights[0], weights[1],
                                      vecs[:10], use_bn=False, **kw)

        for n in REQUEST_WINDOWS:
            rows = n * per_window
            out[f"#1 {rows} rows device ms"] = kernel_ms(chain(rows), 10,
                                                         "encoder_chain")
        out[f"#3 {flat.shape[0]} rows device ms"] = kernel_ms(one, 10,
                                                              "resblock")
        out[f"#1 {flat.shape[0]} rows event ms"] = event_ms(
            chain(flat.shape[0]))
        out[f"#3 {flat.shape[0]} rows event ms"] = event_ms(one)

        edges = fenc.pack_encoder_edges(vq)
        w_pe, b_pe, w_sep, b_sep = edges
        nb = vq.n_resblocks
        last = (nb - 1) // grp * grp
        cycles = x.reshape(-1, CYCLE_LEN, 2)
        patches = patchify(cycles, vq.patch_size).reshape(
            -1, vq.patch_size).contiguous()

        def split_kw(fn, i0, i1):
            takes = "split" in inspect.signature(fn).parameters
            return ({"split": split[2 * i0:2 * i1]}
                    if takes and split is not None else {})

        entry_kw = split_kw(fenc.fused_encoder_entry_eval, 0, grp)
        exit_kw = split_kw(fenc.fused_encoder_exit_eval, last, nb)
        out[f"#4 {flat.shape[0]} rows device ms"] = kernel_ms(
            lambda: fenc.fused_encoder_entry_eval(
                patches, w_pe, b_pe, weights[:2 * grp], vecs[:10 * grp],
                use_bn=False, **entry_kw), 10, "encoder_entry")
        out[f"#5 {flat.shape[0]} rows device ms"] = kernel_ms(
            lambda: fenc.fused_encoder_exit_eval(
                flat, weights[2 * last:], vecs[10 * last:], w_sep, b_sep,
                vq.codebook, use_bn=False, **exit_kw), 10, "encoder_exit")
        full = make_pipeline_quantized(vq, tr, pipe.qparams,
                                       block_fusion="full")

        def edges_full():
            ids = fenc.encode_indices_fused_edges(vq, packed, edges, cycles)
            return quantized_classify(
                tr, pipe.qparams, with_start_token(ids.reshape(BATCH, -1),
                                                   vq.num_embeddings),
                block_fusion="full")

        out["edges + 'full' windows/s"] = BATCH / (event_ms(edges_full)
                                                   / 1e3)
        out["'full' again windows/s"] = BATCH / (event_ms(lambda: full(x))
                                                 / 1e3)
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
