#!/usr/bin/env python3
"""Drive the PyTorch port's int8 serving path once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from vq_vae_transformer_arc_welding_tpu_torch/csrc,
builds the bench model (__graft_entry__._build's configuration) at full
width from a seed, calibrates `WeldingQualityPipeline(precision="int8",
encoder_impl="fused", max_batch=80)` on 8 windows and answers requests
of 80, 37 and 1 windows through `classify`. Then it checks that both
kernels were launched by that run, compares each kernel with its plain
PyTorch version at the main path's shapes, compares the kernel path's
labels with the plain path's, and times kernels and classify with CUDA
events, each in turns with its plain version (median and quartiles of
10 after warm-up).

Every failed check raises. The last line of standard output is
{"ok": true, "device": {...}}; the line before it names the card and
its power limit as nvidia-smi reports them, and the one before that
is the kernels' JSON record. Needs one CUDA device; exits non-zero
without one. Imports no jax.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

SEED = 0
N_CYCLES = 20
REQUESTS = (80, 37, 1)
N_CALIB = 8
REPS = 10
# acceptance bounds
MAX_ID_FLIP = 1e-3          # kernel 1: id flip rate against the plain chain
MAX_H8_DIFF_FRAC = 1e-3     # kernel 2: share of h8 entries that differ
MAX_H8_STEP = 1             # kernel 2: largest |delta h8|
MAX_XMID_ERR = 1e-3         # kernel 2: largest |delta x_mid|
LABEL_MARGIN = 1e-3         # labels compared where |logit0 - logit1| > this
MIN_DISTINCT_FRAC = 0.25    # codebook scaled if fewer of K codes are used


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def gpu_name_and_power() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def timed_in_turns(fns: dict, reps: int = REPS, warmup: int = 3) -> dict:
    """Time of each fn() in ms, CUDA events around each call, after
    warm-up. The functions take turns and the order flips every
    repetition (a b, b a, ...), so that a drift of clocks or load falls
    on all of them alike. Returns {name: (median, first quartile,
    third quartile)}."""
    import torch
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    times = {name: [] for name in fns}
    order = list(fns)
    for i in range(reps):
        for name in order if i % 2 == 0 else order[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    out = {}
    for name, ts in times.items():
        q1, _, q3 = statistics.quantiles(ts, n=4)
        out[name] = (statistics.median(ts), q1, q3)
    return out


def fmt_ms(t: tuple) -> str:
    return f"{t[0]:.4f} ms (quartiles {t[1]:.4f}-{t[2]:.4f})"


def on_plain_path(fn):
    """fn run with every kernel wrapper replaced by its plain version."""
    def run():
        with plain_path():
            return fn()
    return run


@contextlib.contextmanager
def plain_path():
    """The same serving path with every kernel wrapper replaced by its
    plain PyTorch version (the CUDA wrappers would launch the kernels)."""
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_block_quant as fbq, fused_encoder as fenc)
    with mock.patch.object(fenc, "fused_encoder_eval",
                           fenc.fused_encoder_eval_reference), \
            mock.patch.object(fbq, "attn_block_quant",
                              fbq.fused_attn_block_quant_reference):
        yield


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.models.quantized import (
        qdot, qdot_prequantized)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_block_quant as fbq, fused_encoder as fenc)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import (
        new_gelu)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline, with_start_token)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power()
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    dev = torch.device("cuda")

    # -- 1. build the kernels from csrc/ ------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    log(f"build: kernels from {kernels.SRC_DIR.name}/ ready in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 2. the bench model at full width, random weights from SEED --------------
    t0 = time.perf_counter()
    vq, tr = build(seed=SEED, device=dev)
    k = vq.num_embeddings
    n_params = sum(p.numel() for m in (vq, tr) for p in m.parameters())
    log(f"model: VQ-VAE hidden {vq.hidden_dim}, {vq.n_resblocks} resblocks, "
        f"K={k}, D={vq.embedding_dim}; transformer d{tr.d_model}, "
        f"{tr.n_blocks} blocks, {tr.n_head} heads, T={tr.seq_len}; "
        f"{n_params} parameters; built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    width = N_CYCLES * CYCLE_LEN
    calib = rng.standard_normal((N_CALIB, width, 2)).astype(np.float32)
    reqs = [rng.standard_normal((n, width, 2)).astype(np.float32)
            for n in REQUESTS]

    with torch.no_grad():
        cyc = torch.from_numpy(reqs[0]).to(dev).reshape(-1, CYCLE_LEN, 2)
        used = torch.unique(vq.encode_indices(cyc)).numel()
        log(f"codebook: U(+-1/K) init uses {used} of {k} codes on request 0")
        if used < MIN_DISTINCT_FRAC * k:
            z = vq.encode(cyc)
            factor = float(z.std() / vq.codebook.std())
            vq.codebook.mul_(factor)
            used = torch.unique(vq.encode_indices(cyc)).numel()
            log(f"codebook: scaled by {factor:.6g} to the spread of z_e; "
                f"now {used} of {k} codes")
        check(used >= MIN_DISTINCT_FRAC * k,
              f"only {used} of {k} codes in use: the argmin is not exercised")

    # -- 3. the serving pipeline, calibrated on 8 windows -----------------------
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80,
                                  precision="int8", encoder_impl="fused")
    t0 = time.perf_counter()
    am = pipe.calibrate(calib)
    log(f"calibrate: {len(am)} activation sites on {N_CALIB} windows in "
        f"{time.perf_counter() - t0:.1f} s")
    for n, r in zip(REQUESTS, reqs):
        ids = pipe.encode_tokens(r)
        log(f"request of {n}: ids {ids.shape}, "
            f"{np.unique(ids).size} distinct ids")

    # -- 4. the main path: three requests through classify ---------------------
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = [pipe.classify(r) for r in reqs]
    counts = dict(kernels.launches)
    log(f"main path: launches {json.dumps(counts)}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched by classify")
    for n, (labels, probs) in zip(REQUESTS, outs):
        check(labels.shape == (n,) and probs.shape == (n, 2),
              f"classify({n}) shapes {labels.shape} {probs.shape}")
        check(bool(np.isfinite(probs).all()), f"classify({n}): non-finite")
        check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)),
              f"classify({n}): probs do not sum to 1")
        check(set(np.unique(labels).tolist()) <= {0, 1},
              f"classify({n}): labels {np.unique(labels)}")
        log(f"classify({n}): label counts {np.bincount(labels, minlength=2)}"
            f", probs[0] {probs[0].tolist()}")
    log(f"saturation monitor: last rate {pipe.last_saturation_rate}")

    with torch.inference_mode():
        x80 = torch.from_numpy(reqs[0]).to(dev)

        # -- 5. kernel 1 against its plain version ---------------------------
        h = vq.patch_embed_out(x80.reshape(-1, CYCLE_LEN, 2))
        b_, p_, c_ = h.shape
        flat = h.reshape(b_ * p_, c_).contiguous()
        weights, vecs = fenc.pack_encoder(vq)
        nb, grp = vq.n_resblocks, fenc.group_size_for(vq.hidden_dim)
        gen = torch.Generator().manual_seed(SEED)
        bn = vecs.clone().view(nb, 2, 5, c_)
        bn[:, :, 1] = (torch.randn(nb, 2, c_, generator=gen) * 0.2).to(dev)
        bn[:, :, 2] = (torch.rand(nb, 2, c_, generator=gen) * 1.5 + 0.5).to(dev)
        bn[:, :, 3] = (torch.rand(nb, 2, c_, generator=gen) + 0.5).to(dev)
        bn[:, :, 4] = (torch.randn(nb, 2, c_, generator=gen) * 0.1).to(dev)
        bn_vecs = bn.reshape(10 * nb, c_).contiguous()
        k1_err = None
        for use_bn, v in ((False, vecs), (True, bn_vecs)):
            def chain(fn):
                y = flat
                for s0 in range(0, nb, grp):
                    s1 = min(s0 + grp, nb)
                    y = fn(y, weights[2 * s0:2 * s1], v[10 * s0:10 * s1],
                           use_bn=use_bn)
                return y
            yk = chain(fenc.fused_encoder_eval)
            yp = chain(fenc.fused_encoder_eval_reference)
            err = float((yk - yp).abs().max())
            rel = err / float(yp.abs().max())
            ids_k = vq.nearest(vq.sep_conv(yk.reshape(b_, p_, c_)))
            ids_p = vq.nearest(vq.sep_conv(yp.reshape(b_, p_, c_)))
            flip = float((ids_k != ids_p).float().mean())
            log(f"kernel encoder_chain_f32 use_bn={use_bn}: {b_ * p_} rows x "
                f"{nb} resblocks, max abs err {err:.3e}, max rel err "
                f"{rel:.3e}, id flips {flip:.3e} "
                f"({int((ids_k != ids_p).sum())} of {ids_k.numel()}; "
                f"bound {MAX_ID_FLIP})")
            check(bool(torch.isfinite(yk).all()), "kernel 1: non-finite")
            check(flip <= MAX_ID_FLIP, f"kernel 1 id flip rate {flip}")
            if not use_bn:
                k1_err = err
        w0, v0 = weights[:2 * grp], vecs[:10 * grp]
        k1 = timed_in_turns({
            "kernel": lambda: fenc.fused_encoder_eval(flat, w0, v0,
                                                      use_bn=False),
            "plain": lambda: fenc.fused_encoder_eval_reference(
                flat, w0, v0, use_bn=False)})
        log(f"kernel encoder_chain_f32 time ({b_ * p_} x {c_}, {grp} "
            f"resblocks per call): {fmt_ms(k1['kernel'])}, plain "
            f"{fmt_ms(k1['plain'])}")

        # -- 6. kernel 2 against its plain version at B=80 ------------------------
        ids = fenc.encode_indices_fused(vq, (weights, vecs),
                                        x80.reshape(-1, CYCLE_LEN, 2))
        ids = with_start_token(ids.reshape(len(reqs[0]), -1),
                               pipe.start_token)
        qp = pipe.qparams
        xs = qp["tok_emb"][ids.long()] + tr.pe[None, :ids.shape[1]]
        worst = {"h8_diff_frac": 0.0, "h8_max_step": 0, "x_mid_err": 0.0}
        args0 = None
        for i, blk in enumerate(qp["blocks"]):
            scales, vc, v3c = blk["attn_operands"]
            args = (xs.contiguous(), blk["c_attn"].w_int8,
                    blk["c_proj"].w_int8, scales, vc, v3c)
            args0 = args0 or args
            xm_k, h8_k = fbq.attn_block_quant(*args, n_head=tr.n_head)
            xm_p, h8_p = fbq.fused_attn_block_quant_reference(
                *args, n_head=tr.n_head)
            d = (h8_k.int() - h8_p.int()).abs()
            frac, step = float(d.ne(0).float().mean()), int(d.max())
            xerr = float((xm_k - xm_p).abs().max())
            log(f"kernel attn_block_quant block {i} {tuple(xs.shape)}: h8 "
                f"differs in {frac:.3e} of entries (bound "
                f"{MAX_H8_DIFF_FRAC}), max |dh8| {step} (bound "
                f"{MAX_H8_STEP}), max |dx_mid| {xerr:.3e} (bound "
                f"{MAX_XMID_ERR})")
            worst = {"h8_diff_frac": max(worst["h8_diff_frac"], frac),
                     "h8_max_step": max(worst["h8_max_step"], step),
                     "x_mid_err": max(worst["x_mid_err"], xerr)}
            xs = xm_p + qdot(new_gelu(qdot_prequantized(h8_p, blk["c_fc"])),
                             blk["m_proj"])
        check(worst["h8_diff_frac"] <= MAX_H8_DIFF_FRAC,
              f"kernel 2 h8 differs in {worst['h8_diff_frac']}")
        check(worst["h8_max_step"] <= MAX_H8_STEP,
              f"kernel 2 |dh8| {worst['h8_max_step']}")
        check(worst["x_mid_err"] <= MAX_XMID_ERR,
              f"kernel 2 |dx_mid| {worst['x_mid_err']}")
        k2 = timed_in_turns({
            "kernel": lambda: fbq.attn_block_quant(*args0, n_head=tr.n_head),
            "plain": lambda: fbq.fused_attn_block_quant_reference(
                *args0, n_head=tr.n_head)})
        log(f"kernel attn_block_quant time (B={len(reqs[0])}, T={tr.seq_len}, "
            f"C={tr.d_model}): {fmt_ms(k2['kernel'])}, plain "
            f"{fmt_ms(k2['plain'])}")

        # -- 7. end to end: kernel path against the plain path -------------------
        fn = make_pipeline_quantized(vq, tr, qp, block_fusion="attn")
        checked = rest = 0
        max_dlogit = 0.0
        for r in reqs:
            xr = torch.from_numpy(r).to(dev)
            lk = fn(xr)
            with plain_path():
                lp = fn(xr)
            margin = (lp[:, 0] - lp[:, 1]).abs()
            sure = margin > LABEL_MARGIN
            same = lk.argmax(-1) == lp.argmax(-1)
            check(bool(same[sure].all()),
                  f"labels differ where the plain margin exceeds "
                  f"{LABEL_MARGIN}: {int((~same & sure).sum())}")
            checked += int(sure.sum())
            rest += int((~sure).sum())
            max_dlogit = max(max_dlogit, float((lk - lp).abs().max()))
        log(f"end to end: labels equal on all {checked} windows whose plain "
            f"|logit0-logit1| > {LABEL_MARGIN}; {rest} windows within the "
            f"margin; max |dlogit| {max_dlogit:.3e}")

    # -- 8. classify at batch 80: kernel path, plain path, f32 path -------------
    # classify returns numpy arrays, so each call ends synchronized and
    # the events span the whole request, host work included
    f32 = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80)
    f32_labels, _ = f32.classify(reqs[0])
    cls = timed_in_turns({
        "kernel path": lambda: pipe.classify(reqs[0]),
        "plain path": on_plain_path(lambda: pipe.classify(reqs[0])),
        "f32 path": lambda: f32.classify(reqs[0])})
    n80 = len(reqs[0])
    log(f"classify batch {n80}: " + ", ".join(
        f"{name} {n80 / (t[0] / 1e3):.1f} windows/s at {fmt_ms(t)}"
        for name, t in cls.items())
        + f"; int8 vs f32 label agreement "
        f"{float((outs[0][0] == f32_labels).mean()):.3f}; gpu {smi}")

    src = "vq_vae_transformer_arc_welding_tpu_torch/csrc/"
    record = {"kernels": [
        {"name": "encoder_chain_f32", "route": "cuda",
         "source": src + "encoder_chain.cu",
         "replaces": "vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py:311",
         "launches": counts["encoder_chain_f32"], "max_abs_err": k1_err,
         "ms": k1["kernel"][0], "plain_ms": k1["plain"][0]},
        {"name": "attn_block_quant", "route": "cuda",
         "source": src + "attn_block_quant.cu",
         "replaces": "vq_vae_transformer_arc_welding_tpu/ops/pallas_block_quant.py:255",
         "launches": counts["attn_block_quant"],
         "max_abs_err": worst["x_mid_err"], "ms": k2["kernel"][0],
         "plain_ms": k2["plain"][0]},
    ]}
    print(json.dumps(record), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
