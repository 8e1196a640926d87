"""Synthetic ASIMoW-schema dataset generator.

Own copy of vq_vae_transformer_arc_welding_tpu/data/synthetic.py: the
same draws from the same seed, so both packages write the same CSV
byte for byte. Emits a CSV with the reference schema, three id columns
then V_0..V_199, I_0..I_199 (asimow_dataloader.py:240-246). The real
dataset (Zenodo 10017718) is not part of the repository, so the
generator follows the documented structure of short-arc GMAW process
data the dataset records:

- each 200-sample cycle is one short-circuit transfer period: a
  short-circuit phase (voltage collapses toward the wetting voltage
  while current ramps along the source inductance) followed by arc
  re-ignition (voltage spike, current decaying toward the background
  level);
- quality is a RUN-level property (the reference labels whole welding
  runs): bad runs carry a high fraction of defective cycles, good runs
  a low one — not i.i.d. per-cycle labels;
- defective cycles show the documented instability signatures:
  irregular short-circuit timing, re-ignition failures (voltage
  dropouts), spatter-like current spikes and harmonic ripple;
- a fraction of cycles is unlabeled (-1) like the real dataset.
"""
from __future__ import annotations

import os

import numpy as np

from .asimow import CYCLE_LEN
from .splits import get_val_test_ids


def synthetic_cycles(rng: np.random.Generator, n: int, labels: np.ndarray,
                     signature_strength: float = 1.0):
    """Short-arc GMAW cycles: (V (n, 200), I (n, 200)) float32.

    labels: 1 = good (stable transfer), 0 = bad (process instability).
    signature_strength scales every bad-cycle signature amplitude
    (1.0 = the loud default; ~0.5 overlaps the good-cycle morphology so
    per-cycle classification needs the full waveform, not one feature).
    """
    k = CYCLE_LEN
    s = float(signature_strength)
    ts = np.arange(k)[None, :]
    good = labels != 0
    # short-circuit length: stable ~28 samples for good cycles,
    # erratic for bad ones (irregular droplet transfer)
    sc_len = np.where(good, rng.normal(28.0, 2.0, n),
                      rng.normal(28.0 + 2.0 * s, 2.0 + 7.0 * s, n)
                      ).clip(8, 70)[:, None]
    in_sc = ts < sc_len

    # voltage: wetting (~3 V) during short circuit, re-ignition spike,
    # then arc voltage ~27 V with slight droop
    arc_t = (ts - sc_len).clip(0)
    v = np.where(
        in_sc,
        3.0 + 1.2 * rng.standard_normal((n, k)) * 0.3,
        27.0 + 9.0 * np.exp(-arc_t / 6.0)      # re-ignition peak
        - 2.0 * (arc_t / k)                     # droop toward next short
    )
    # current: ramps up along the inductance during the short circuit,
    # peaks at re-ignition, decays to the background current
    i_peak = np.where(good, rng.normal(420.0, 15.0, n),
                      rng.normal(420.0, 15.0 + 30.0 * s, n))[:, None]
    i_bg = 60.0
    ramp = i_bg + (i_peak - i_bg) * (ts / sc_len).clip(0, 1) ** 1.5
    decay = i_bg + (i_peak - i_bg) * np.exp(-arc_t / 45.0)
    i = np.where(in_sc, ramp, decay)

    # measurement noise
    v += 0.5 * rng.standard_normal((n, k))
    i += 4.0 * rng.standard_normal((n, k))

    bad = ~good
    if bad.any():
        nb = int(bad.sum())
        tb = ts.repeat(nb, axis=0)
        # harmonic ripple (arc wander) on both channels
        ph = rng.uniform(0, 2 * np.pi, (nb, 1))
        v[bad] += 2.5 * s * np.sin(2 * np.pi * 3 * tb / k + ph) \
            + 1.2 * s * rng.standard_normal((nb, k))
        i[bad] += 20.0 * s * np.sin(2 * np.pi * 5 * tb / k + ph)
        # re-ignition failures: voltage collapses mid-arc for a stretch
        drop_start = rng.integers(60, k - 40, nb)
        drop_len = rng.integers(10, 35, nb)
        spike_pos = rng.integers(40, k - 10, nb)
        rows = np.where(bad)[0]
        for row, st, ln, sp in zip(rows, drop_start, drop_len, spike_pos):
            v[row, st:st + ln] *= 1.0 - 0.75 * s
            i[row, st:st + ln] *= 1.0 + 0.4 * s  # current surge into short
            # spatter: brief current spike with voltage pop
            i[row, sp:sp + 4] += rng.normal(150.0 * s, 30.0 * s)
            v[row, sp:sp + 4] += rng.normal(6.0 * s, 2.0 * s)
    return v.astype(np.float32), i.astype(np.float32)


def make_synthetic_arrays(n_cycles_per_run: int = 60, seed: int = 0,
                          extra_train_runs: int = 6, bad_fraction: float = 0.3,
                          unlabeled_fraction: float = 0.1,
                          label_process: str = "iid",
                          signature_strength: float = 1.0,
                          markov_persistence: float = 0.85):
    """Build (vi, labels, experiment, welding_run) covering every
    benchmark val/test id plus extra train-only runs.

    label_process:
      "iid"    — per-cycle labels drawn i.i.d. around the run's quality
                 level (the original regime). Windows labeled with the
                 NEXT cycle's label then carry ~the run defect rate as
                 irreducible noise, which at high model capacity pulls
                 training into the constant-predictor attractor
                 (QUALITY.md Study B).
      "markov" — defects arrive in bursts: a 2-state Markov chain whose
                 stationary defect rate is the run's quality level and
                 whose persistence is `markov_persistence`. Real process
                 instabilities persist across neighboring cycles, and
                 the next-cycle label becomes genuinely predictable from
                 the current window (Bayes error ≈ 1 − persistence), so
                 high-capacity classifiers have a learnable target well
                 above the majority-class attractor.
    """
    rng = np.random.default_rng(seed)
    ids = get_val_test_ids()
    runs = list(ids["val_ids"]) + list(ids["test_ids"])
    runs += [(1, 100 + k) for k in range(extra_train_runs)]

    all_v, all_i, all_l, all_e, all_r = [], [], [], [], []
    for ri, (exp, run) in enumerate(runs):
        n = n_cycles_per_run
        # quality is a RUN-level property (the reference labels whole
        # welding runs): alternate run quality deterministically so
        # every split sees both classes, with per-cycle fractions drawn
        # around the run's quality level
        run_is_bad = ri % 3 == 1
        if label_process == "markov":
            # stationary defect rate from the run's quality level
            p_stat = (rng.uniform(0.55, 0.80) if run_is_bad
                      else rng.uniform(0.10, 0.25))
            stay_bad = markov_persistence
            # P(good→bad) chosen so the chain's stationary bad rate is
            # p_stat: π_bad = g2b / (g2b + 1 − stay_bad)
            g2b = min(0.95, (1.0 - stay_bad) * p_stat / (1.0 - p_stat))
            u = rng.random(n)
            state_bad = rng.random() < p_stat
            labels = np.empty(n, np.int64)
            for t in range(n):
                labels[t] = 0 if state_bad else 1
                state_bad = u[t] < (stay_bad if state_bad else g2b)
        else:
            # min() keeps the interval valid for bad_fraction < 0.05
            # (numpy's uniform silently samples an inverted interval);
            # the default 0.3 draws are unchanged
            frac = (rng.uniform(0.55, 0.85) if run_is_bad
                    else rng.uniform(min(0.05, bad_fraction), bad_fraction))
            labels = (rng.random(n) > frac).astype(np.int64)
        true_labels = labels.copy()
        unl = rng.random(n) < unlabeled_fraction
        labels[unl] = -1
        if label_process == "markov":
            # -1 masks the LABEL, not the physics: mid-burst unlabeled
            # cycles keep their true state so bursts stay coherent
            lab_for_signal = true_labels
            rng.integers(0, 2, n)  # keep the draw count stable
        else:
            lab_for_signal = np.where(labels == -1,
                                      rng.integers(0, 2, n), labels)
        v, i = synthetic_cycles(rng, n, lab_for_signal,
                                signature_strength=signature_strength)
        all_v.append(v); all_i.append(i); all_l.append(labels)
        all_e.append(np.full(n, exp)); all_r.append(np.full(n, run))
    v = np.concatenate(all_v); i = np.concatenate(all_i)
    vi = np.stack([v, i], axis=-1)
    return (vi, np.concatenate(all_l), np.concatenate(all_e),
            np.concatenate(all_r))


def write_synthetic_csv(path: str, **kwargs):
    vi, labels, exp, run = make_synthetic_arrays(**kwargs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = (["experiment", "welding_run", "labels"]
              + [f"V_{k}" for k in range(CYCLE_LEN)]
              + [f"I_{k}" for k in range(CYCLE_LEN)])
    table = np.concatenate([
        exp[:, None].astype(np.float64), run[:, None].astype(np.float64),
        labels[:, None].astype(np.float64), vi[:, :, 0], vi[:, :, 1]], axis=1)
    np.savetxt(path, table, delimiter=",", header=",".join(header),
               comments="", fmt="%.6g")
    return path
