"""Batch quality-scoring CLI: serving artifact + ASIMoW CSV -> scores CSV.

    python -m vq_vae_transformer_arc_welding_tpu_torch.cli.score_quality \\
        --artifact DIR --data-path CSV [--out scores.csv]

Port of vq_vae_transformer_arc_welding_tpu/cli/score_quality.py: the
same flags and the same output file, plus `--device`. The reference
stops at training scripts and has no inference entry point; this one
scores a production CSV of welding cycles against a saved serving
artifact (`serve.WeldingQualityPipeline.save_artifact`). The pipeline
is built on the card unless `--device` names another device.

Semantics:
- Windows are built PER WELDING RUN and never span run boundaries:
  serving scores each run independently. (Training reproduces the
  reference's boundary-spanning window quirk,
  `data/asimow.py::create_sequence_windows`; that quirk is a training
  data-pipeline artifact, not a deploy behavior.)
- If the artifact carries the training scaler (`scaler.json`), raw
  sensor windows are normalized with the exact train-split statistics
  before classify; otherwise the CSV must already be scaled.
- Output row = (welding_run, start_cycle, label, p_bad, p_good) with
  label semantics from the dataset: 1 = good weld, 0 = bad
  (reference README / `data/synthetic.py:37`).
"""
from __future__ import annotations

import argparse
import logging as log

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser(
        description="Score welding quality from a serving artifact")
    a = parser.add_argument
    a("--artifact", type=str, required=True,
      help="directory from WeldingQualityPipeline.save_artifact")
    a("--data-path", type=str, required=True,
      help="CSV in the ASIMoW schema (processed_asimow_dataset.csv)")
    a("--out", type=str, default="quality_scores.csv",
      help="output CSV path")
    a("--stride", type=int, default=None,
      help="window stride in cycles (default: n_cycles, i.e. "
           "non-overlapping windows)")
    a("--max-batch", type=int, default=None,
      help="serving batch size override (default: artifact manifest)")
    a("--no-scaler", action="store_true",
      help="skip the artifact's scaler even if present (input already "
           "scaled)")
    a("--chunk", type=int, default=4096,
      help="windows materialized per classify flush (memory bound; "
           "results are identical for any value)")
    a("--device", type=str, default=None,
      help="device to serve on (default: the CUDA device; 'cpu' runs "
           "the plain PyTorch versions)")
    return parser


def main(args) -> str:
    import os

    from ..data.asimow import CYCLE_LEN, load_asimow_csv
    from ..serve import WeldingQualityPipeline

    pipe = WeldingQualityPipeline.load_artifact(args.artifact,
                                                max_batch=args.max_batch,
                                                device=args.device)
    vi, _labels, exp, run = load_asimow_csv(args.data_path)
    if pipe.scaler is not None and not args.no_scaler:
        vi = pipe.scaler.transform(vi)
        log.info("applied artifact scaler (train-split stats)")
    elif pipe.scaler is None and not args.no_scaler:
        log.warning("artifact has no scaler: assuming the CSV is "
                    "already scaled")

    nc = pipe.n_cycles
    stride = args.stride or nc
    if stride < 1:
        raise ValueError("--stride must be >= 1")
    # a welding_run id is only unique WITHIN an experiment (the split
    # table pairs them, data/splits.py); group by the pair or runs
    # with colliding ids would be concatenated across experiments
    keys = np.stack([exp, run], axis=1)
    groups = np.unique(keys, axis=0)
    # flush in bounded chunks: a production CSV can hold hundreds of
    # thousands of windows (n_cycles*200*2 f32 each): materializing
    # them all before classify would peak at multi-GB for no benefit
    # (classify already batches internally by max_batch)
    chunk = max(args.chunk, pipe.max_batch)
    windows, meta, skipped = [], [], []
    n_scored = n_bad = 0

    def flush(f):
        nonlocal n_scored, n_bad, windows, meta
        if not windows:
            return
        labels, probs = pipe.classify(np.stack(windows))
        for (e, r, s), lab, p in zip(meta, labels, probs):
            f.write(f"{e},{r},{s},{int(lab)},{p[0]:.6f},{p[1]:.6f}\n")
        n_scored += len(windows)
        n_bad += int((np.asarray(labels) == 0).sum())
        windows, meta = [], []

    with open(args.out, "w") as f:
        f.write("experiment,welding_run,start_cycle,label,p_bad,p_good\n")
        for e, r in groups:
            x = vi[(exp == e) & (run == r)]
            if x.shape[0] < nc:
                skipped.append((int(e), int(r)))
                continue
            for s in range(0, x.shape[0] - nc + 1, stride):
                windows.append(x[s:s + nc].reshape(nc * CYCLE_LEN, 2))
                meta.append((int(e), int(r), s))
                if len(windows) >= chunk:
                    flush(f)
        flush(f)
    if skipped:
        log.warning("skipped %d runs shorter than n_cycles=%d: %s",
                    len(skipped), nc, skipped[:20])
    if n_scored == 0:
        os.remove(args.out)
        raise SystemExit(
            f"no complete windows: every run is shorter than "
            f"n_cycles={nc}")
    log.info("scored %d windows from %d runs -> %s (%d flagged bad)",
             n_scored, len(groups) - len(skipped), args.out, n_bad)
    if pipe.needs_recalibration:
        log.warning("int8 saturation %.3f%% exceeded the calibrated "
                    "envelope: recalibrate on recent windows",
                    100.0 * (pipe.last_saturation_rate or 0.0))
    return args.out


def cli_main():
    """Console-script entry point (pyproject [project.scripts])."""
    FORMAT = "%(asctime)s - %(levelname)s - %(message)s"
    log.basicConfig(level=log.INFO, format=FORMAT)
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli_main()
