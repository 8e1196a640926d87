"""The port's serving slice against the JAX package, end to end on the CPU.

`WeldingQualityPipeline(n_cycles=2, precision="int8",
encoder_impl="fused")` in both packages on bridged weights, one ragged
request. int8: the JAX calibration's qparams are bridged in, so both
run on identical scales; labels equal and probs within 1e-3 (the fused
attention normalizes after P@V, the JAX contract's 1e-3). f32: probs
within 1e-5. The saturation probe gives JAX's numbers on the rows it
is given. Each block_fusion and fused_attention option of
make_pipeline_quantized reaches its kernels' entries. A
`vq_impl='pallas'` model reaches the nearest-code kernel's wrapper
through `make_pipeline`, `encode_tokens`, `calibrate`, `classify` and
`ood_score`; `encoder_precision='int8'` serves every entry from the
int8 encoder after `calibrate()`. Also: the port imports without jax,
`build()` and the bridge without a device raise where there is no GPU,
and chip_smoke.py refuses to run without a CUDA device.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models import quantized as jq
from vq_vae_transformer_arc_welding_tpu.serve import (
    WeldingQualityPipeline as JaxPipeline)
from vq_vae_transformer_arc_welding_tpu_torch import bridge, entry
from vq_vae_transformer_arc_welding_tpu_torch.ops import (
    fused_attn_quant as fattn, fused_block_quant as fbq,
    fused_encoder as fenc, fused_mlp_quant as fmlp, fused_vq as fvq)
from vq_vae_transformer_arc_welding_tpu_torch.serve import (
    WeldingQualityPipeline)

import torch_port_helpers as H

REPO = Path(__file__).resolve().parent.parent
REQUEST = 5          # ragged against max_batch 4: chunks of 4 and 1


def _jax_pipeline(precision, batch_norm=False, **kw):
    jm, params, state = H.jax_vqvae(batch_norm)
    tm, tp = H.jax_transformer()
    return JaxPipeline((jm, params, state), (tm, tp), n_cycles=H.N_CYCLES,
                       max_batch=8, precision=precision,
                       encoder_impl="fused", **kw)


def _port_pipeline(precision, batch_norm=False, max_batch=4,
                   vq_impl="xla", **kw):
    return WeldingQualityPipeline(H.port_vqvae(batch_norm, vq_impl),
                                  H.port_transformer(), n_cycles=H.N_CYCLES,
                                  max_batch=max_batch, precision=precision,
                                  encoder_impl="fused", **kw)


@functools.cache
def _jax_int8():
    jp = _jax_pipeline("int8")
    am = jp.calibrate(H.windows(6, seed=4))
    return jp, am


def test_slice_int8_matches_jax():
    jp, _ = _jax_int8()
    x = H.windows(REQUEST, seed=5)
    ref_labels, ref_probs = jp.classify(x)
    pipe = _port_pipeline("int8")
    pipe.qparams = H.port_qparams(jp.qparams)
    labels, probs = pipe.classify(x)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-3)
    assert pipe.last_saturation_rate == pytest.approx(
        jp.last_saturation_rate, abs=1e-6)


def test_port_calibration_matches_jax():
    _, ref = _jax_int8()
    am = _port_pipeline("int8").calibrate(H.windows(6, seed=4))
    assert set(am) == set(ref)
    for site in ref:
        np.testing.assert_allclose(am[site], ref[site], rtol=1e-5)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_slice_f32_matches_jax(batch_norm):
    x = H.windows(REQUEST, seed=6)
    ref_labels, ref_probs = _jax_pipeline("f32", batch_norm).classify(x)
    labels, probs = _port_pipeline("f32", batch_norm).classify(x)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, ref_labels)


def test_encode_tokens_matches_jax():
    x = H.windows(REQUEST, seed=7)
    ref = _jax_pipeline("f32").encode_tokens(x)
    ids = _port_pipeline("f32").encode_tokens(x)
    assert ids.dtype == np.int32 and ids.shape == (REQUEST, H.N_CYCLES * 16)
    np.testing.assert_array_equal(ids, ref)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_ood_score_matches_jax(batch_norm):
    """Per-cycle scores in chunks of max_batch (9 cycles against 4), to
    1e-5."""
    cycles = H.windows(9, seed=16)[:, :200]
    ref = _jax_pipeline("f32", batch_norm).ood_score(cycles)
    ood = _port_pipeline("f32", batch_norm).ood_score(cycles)
    assert ood.shape == (9,) and ood.dtype == np.float32
    np.testing.assert_allclose(ood, np.asarray(ref), rtol=0, atol=1e-5)


def test_vq_impl_pallas_reaches_its_kernel(monkeypatch):
    """With the runtime option set, every entry that runs the plain
    encoder searches the nearest code through ops/fused_vq.py, once per
    chunk: encode_tokens, calibrate, classify(encoder_impl='xla'),
    ood_score and entry.make_pipeline. Ids, labels and scores equal the
    'xla' model's."""
    calls = []
    real = fvq.nearest_codes_pallas
    monkeypatch.setattr(fvq, "nearest_codes_pallas", lambda z, cb: (
        calls.append(z.shape[0]), real(z, cb))[1])
    x = H.windows(REQUEST, seed=17)
    tr = H.port_transformer()
    pipes = {impl: WeldingQualityPipeline(
        H.port_vqvae(False, impl), tr, n_cycles=H.N_CYCLES, max_batch=4,
        precision="int8") for impl in ("xla", "pallas")}
    out = {}
    for impl, pipe in pipes.items():
        pipe.calibrate(H.windows(6, seed=4))
        out[impl] = (pipe.encode_tokens(x), *pipe.classify(x),
                     pipe.ood_score(x[:, :200]),
                     entry.make_pipeline(pipe.vq_model, tr)(
                         torch.from_numpy(x)).numpy())
    # calibrate 2 chunks, then 2 chunks each of encode_tokens, classify
    # and ood_score, and make_pipeline's one call; none from 'xla'
    rows = H.N_CYCLES * 16      # z rows per window; 16 per single cycle
    assert calls == [4 * rows, 2 * rows] + [4 * rows, 1 * rows] * 2 + [
        4 * 16, 1 * 16, REQUEST * rows]
    for got, want in zip(out["pallas"], out["xla"]):
        np.testing.assert_array_equal(got, want)


@functools.cache
def _jax_int8_encoder():
    jp = _jax_pipeline("f32", encoder_precision="int8")
    jp.calibrate(H.windows(6, seed=4))
    return jp


def test_int8_encoder_pipeline_matches_jax():
    """encoder_precision='int8': calibrate() quantizes the encoder on
    the sample's cycles, then every entry serves from it. On bridged
    qenc the ids differ from JAX's in at most 1% of entries (measured:
    none); the port's own calibration gives the same int8 weights and
    act scales within rtol 1e-5."""
    jp = _jax_int8_encoder()
    x = H.windows(REQUEST, seed=18)
    ref = jp.encode_tokens(x)
    pipe = _port_pipeline("f32", encoder_precision="int8")
    pipe.calibrate(H.windows(6, seed=4))
    for q, jq_ in zip(
            [b[k] for b in pipe.qenc["blocks"] for k in ("c1", "c2")]
            + [pipe.qenc["sep"]],
            [b[k] for b in jp.qenc["blocks"] for k in ("c1", "c2")]
            + [jp.qenc["sep"]]):
        np.testing.assert_array_equal(q.w_int8.numpy(),
                                      np.asarray(jq_.w_int8).T)
        np.testing.assert_allclose(q.act_scale.item(),
                                   float(jq_.act_scale), rtol=1e-5)
    pipe.qenc = H.port_qenc(jp.qenc)
    ids = pipe.encode_tokens(x)
    assert ids.shape == ref.shape and ids.dtype == np.int32
    assert (ids != ref).mean() <= 0.01
    labels, probs = pipe.classify(x)
    ref_labels, ref_probs = jp.classify(x)
    if (ids == ref).all():
        np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(labels, ref_labels)


def test_int8_encoder_serves_every_entry(monkeypatch):
    """After calibrate() neither the fused nor the plain f32 encoder
    runs: classify, encode_tokens and the int8 calibration's own ids all
    come from encode_indices_quantized."""
    from vq_vae_transformer_arc_welding_tpu_torch.models import quantized
    pipe = _port_pipeline("int8", encoder_precision="int8")
    calls = []
    real = quantized.encode_indices_quantized
    monkeypatch.setattr(quantized, "encode_indices_quantized",
                        lambda *a: (calls.append(1), real(*a))[1])
    for mod, name in ((fenc, "fused_encoder_eval"),
                      (type(pipe.vq_model), "encode_indices")):
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail(
            "the f32 encoder ran"))
    pipe.calibrate(H.windows(6, seed=4))
    assert pipe.qenc is not None and pipe.qparams is not None
    n_calibrate = len(calls)
    labels, _ = pipe.classify(H.windows(REQUEST, seed=19))
    ids = pipe.encode_tokens(H.windows(REQUEST, seed=19))
    assert labels.shape == (REQUEST,) and ids.shape == (REQUEST, 32)
    assert n_calibrate == 2 and len(calls) == 6


def test_int8_encoder_requires_calibration():
    pipe = _port_pipeline("f32", encoder_precision="int8")
    for call in (pipe.classify, pipe.encode_tokens):
        with pytest.raises(RuntimeError, match="encoder_precision='int8'"):
            call(H.windows(1))
    with pytest.raises(ValueError):
        _port_pipeline("f32", encoder_precision="int4")


def test_build_without_a_device_needs_the_card():
    """device=None means the card in the entry points: on a host without
    one, build() and the bridge raise and return no CPU model; asked in
    words, they build on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    jm, params, state = H.jax_vqvae(False)
    tm, tp = H.jax_transformer()
    jp, _ = _jax_int8()
    small = dict(d_model=32, n_blocks=1, n_heads=4, hidden=64, n_res=1,
                 k=32, d=16)
    for call in (
            lambda: entry.build(**small),
            lambda: bridge.vqvae_from_jax(jm.hparams, params, state),
            lambda: bridge.transformer_from_jax(tm.hparams, tp),
            lambda: bridge.qparams_from_jax(jp.qparams),
            lambda: bridge.qenc_from_jax(_jax_int8_encoder().qenc)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    vq, tr = entry.build(**small, device="cpu", vq_impl="pallas")
    assert vq.codebook.device.type == tr.pe.device.type == "cpu"
    assert vq.vq_impl == "pallas"


def test_chunking_does_not_change_results():
    x = H.windows(REQUEST, seed=8)
    pipe = _port_pipeline("int8", max_batch=2)
    pipe.qparams = H.port_qparams(_jax_int8()[0].qparams)
    whole = _port_pipeline("int8", max_batch=8)
    whole.qparams = pipe.qparams
    np.testing.assert_array_equal(pipe.classify(x)[1], whole.classify(x)[1])


PIPELINE_OPTIONS = [
    {"block_fusion": "attn"}, {"block_fusion": "full"},
    {"block_fusion": "attn8"}, {"block_fusion": "full8"},
    {"block_fusion": "attn-bf16"}, {"block_fusion": "full-bf16"},
    {"block_fusion": None, "fused_attention": True},
    {"block_fusion": None, "fused_attention": True, "fused_mlp": True},
    {"block_fusion": None, "fused_attention": True, "fused_qkv": False},
]


def test_classify_packs_operands_once(monkeypatch):
    """The kernels' weight operands are packed at construction and at
    calibration, the full-block rows included; classify and every
    make_pipeline_quantized path repack nothing per call."""
    pipe = _port_pipeline("int8")
    pipe.calibrate(H.windows(6, seed=4))
    for blk in pipe.qparams["blocks"]:
        scales, vc, v3c, v4c = blk["block_operands"]
        assert vc.shape == (8, 32) and v4c.shape == (2, 128)
    fns = [entry.make_pipeline_quantized(pipe.vq_model, pipe.tr_model,
                                         pipe.qparams, **kw)
           for kw in PIPELINE_OPTIONS]
    calls = []
    for mod, name in ((fenc, "pack_encoder"), (fbq, "_block_operands")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    labels, _ = pipe.classify(H.windows(REQUEST, seed=12))
    assert labels.shape == (REQUEST,)
    x = torch.from_numpy(H.windows(2, seed=12))
    for fn in fns:
        assert fn(x).shape == (2, 2)
    assert calls == []


@pytest.mark.parametrize("kw", PIPELINE_OPTIONS + [{"block_fusion": None}],
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_make_pipeline_quantized_reaches_its_kernels(monkeypatch, kw):
    """Each option reaches the operand-level entries of its kernels
    (int8_attn as the option says), once per block, and no others."""
    vq, tr = H.port_vqvae(False), H.port_transformer()
    qparams = H.port_qparams(_jax_int8()[0].qparams)
    calls = []
    for mod, name in ((fbq, "attn_block_quant"), (fbq, "block_quant"),
                      (fmlp, "mlp_quant"), (fattn, "qkv_attention_quant"),
                      (fattn, "fused_causal_attention_quant")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append((_n, k.get("int8_attn", False))), _r(*a, **k))[1])
    fn = entry.make_pipeline_quantized(vq, tr, qparams, **kw)
    out = fn(torch.from_numpy(H.windows(3, seed=14)))
    assert out.shape == (3, 2) and torch.isfinite(out).all()
    bf = kw.get("block_fusion")
    if bf is not None:
        name = "block_quant" if bf.startswith("full") else "attn_block_quant"
        want = {(name, bf.split("-")[0].endswith("8"))}
    elif kw.get("fused_attention"):
        want = {("qkv_attention_quant" if kw.get("fused_qkv", True)
                 else "fused_causal_attention_quant", False)}
        if kw.get("fused_mlp"):
            want.add(("mlp_quant", False))
    else:
        want = set()
    assert set(calls) == want
    assert len(calls) == len(want) * tr.n_blocks


@functools.cache
def _jax_int8_tight():
    """A JAX int8 pipeline whose act scales were calibrated at half the
    absmax, so that every site clips."""
    jp = _jax_pipeline("int8")
    jp.qparams = jq.quantize_transformer(
        jp.tr_params, {k: v / 2 for k, v in _jax_int8()[1].items()})
    return jp


@pytest.mark.parametrize("n", [8, REQUEST])
def test_saturation_rate_matches_jax(n):
    """n = max_batch: against the JAX pipeline's saturation_rate, which
    pads nothing then. n = 5: against JAX saturation_stats on the same
    five rows, since the JAX pipeline would pad them to max_batch by
    repeating the last; the port computes the rows it is given."""
    jp = _jax_int8_tight()
    x = H.windows(n, seed=15)
    pipe = _port_pipeline("int8", max_batch=8)
    pipe.qparams = H.port_qparams(jp.qparams)
    rate, per_site = pipe.saturation_rate(x)
    if n == jp.max_batch:
        ref_rate, ref_sites = jp.saturation_rate(x)
    else:
        ids = np.concatenate([np.full((n, 1), jp.start_token, np.int32),
                              jp.encode_tokens(x)], axis=1)
        r, sites = jq.saturation_stats(jp.tr_model, jp.qparams,
                                        jnp.asarray(ids))
        ref_rate, ref_sites = float(r), {k: float(v) for k, v in
                                         sites.items()}
    assert per_site.keys() == ref_sites.keys()
    assert rate > 0
    assert rate == pytest.approx(ref_rate, abs=1e-6)
    for site, v in ref_sites.items():
        assert per_site[site] == pytest.approx(v, abs=1e-6), site


@pytest.mark.parametrize("n", [8, REQUEST])
def test_classify_monitor_rate_under_drift_matches_jax(monkeypatch, n):
    """classify's in-path saturation monitor when serving has drifted
    past calibration, against the JAX pipeline: last_saturation_rate
    within 1e-6 and above 0, labels equal, probs within the int8
    contract's 1e-3; the port's int8 MLP is the two int8 GEMM calls a
    block, c_fc counting what it clips. Scaled windows do not drift this
    model (the transformer sees codebook ids; the rate stays 0 for
    requests scaled by 2 to 16, and after calibrating on windows that
    map to a single id), so the drift is in the act scales: both
    pipelines serve the scales of half the calibrated absmax
    (`_jax_int8_tight`). n = 5 leaves the JAX pipeline three rows of
    padding, which its rate leaves out."""
    from vq_vae_transformer_arc_welding_tpu_torch.ops import int8_gemm
    jp = _jax_int8_tight()
    x = H.windows(n, seed=23)
    ref_labels, ref_probs = jp.classify(x)
    pipe = _port_pipeline("int8", max_batch=8)
    pipe.qparams = H.port_qparams(jp.qparams)
    calls = []
    real = int8_gemm.int8_gemm
    monkeypatch.setattr(int8_gemm, "int8_gemm", lambda *a, **k: (
        calls.append(k.get("clip_rows") is not None), real(*a, **k))[1])
    labels, probs = pipe.classify(x)
    assert calls == [True, False] * len(pipe.qparams["blocks"])
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-3)
    assert jp.last_saturation_rate > 0.001
    assert pipe.last_saturation_rate == pytest.approx(
        jp.last_saturation_rate, abs=1e-6)


def test_saturation_rate_refuses_without_calibration():
    with pytest.raises(RuntimeError):
        _port_pipeline("int8").saturation_rate(H.windows(1))
    pipe = _port_pipeline("int8")
    pipe.qparams = H.port_qparams(_jax_int8()[0].qparams)
    with pytest.raises(ValueError):
        pipe.saturation_rate(H.windows(0))


def test_int8_classify_requires_calibration():
    with pytest.raises(RuntimeError):
        _port_pipeline("int8").classify(H.windows(1))
    with pytest.raises(ValueError):
        _port_pipeline("f32").classify(H.windows(0))


def test_pipeline_keeps_the_callers_tf32_flags(monkeypatch):
    """A caller's TF32 flags (both on, as a training run may set them)
    survive building a pipeline, calibrating it and `classify`; the
    pipeline turns both off only inside its own calls, where the int8
    class head's exact products need them off."""
    def flags():
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    real = fbq.attn_block_quant

    def recording(*a, **k):
        seen.append(flags())
        return real(*a, **k)

    monkeypatch.setattr(fbq, "attn_block_quant", recording)
    pipe = _port_pipeline("int8")
    assert flags() == (True, True)
    pipe.calibrate(H.windows(6, seed=4))
    assert flags() == (True, True)
    labels, probs = pipe.classify(H.windows(REQUEST))
    assert flags() == (True, True)
    assert labels.shape == (REQUEST,) and np.isfinite(probs).all()
    assert seen and set(seen) == {(False, False)}


def test_entry_pipelines_agree():
    """entry.make_pipeline (f32) and make_pipeline_quantized (int8,
    fused) on the small models: finite (B, 2) logits, labels equal."""
    vq, tr = H.port_vqvae(False), H.port_transformer()
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=H.N_CYCLES, max_batch=8,
                                  precision="int8", encoder_impl="fused")
    pipe.calibrate(H.windows(6, seed=10))
    x = torch.from_numpy(H.windows(4, seed=11))
    f32 = entry.make_pipeline(vq, tr)(x)
    q = entry.make_pipeline_quantized(vq, tr, pipe.qparams)(x)
    assert f32.shape == q.shape == (4, 2)
    assert torch.isfinite(q).all()
    assert (q - f32).abs().max() < 1e-1
    assert torch.equal(q.argmax(-1), f32.argmax(-1))


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import vq_vae_transformer_arc_welding_tpu_torch.serve, "
            "vq_vae_transformer_arc_welding_tpu_torch.entry, "
            "vq_vae_transformer_arc_welding_tpu_torch.bridge, "
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_encoder, "
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_vq, "
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_block_quant, "
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_mlp_quant, "
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_attn_quant, "
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_decode, "
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_attn, "
            "vq_vae_transformer_arc_welding_tpu_torch.data, "
            "vq_vae_transformer_arc_welding_tpu_torch.data.synthetic, "
            "vq_vae_transformer_arc_welding_tpu_torch.native.csv_loader, "
            "vq_vae_transformer_arc_welding_tpu_torch.train.checkpoint, "
            "vq_vae_transformer_arc_welding_tpu_torch.train.torch_import, "
            "vq_vae_transformer_arc_welding_tpu_torch.train.loop, "
            "vq_vae_transformer_arc_welding_tpu_torch.train.optim, "
            "vq_vae_transformer_arc_welding_tpu_torch.train.tasks, "
            "vq_vae_transformer_arc_welding_tpu_torch.train.metrics, "
            "vq_vae_transformer_arc_welding_tpu_torch.utils.random, "
            "vq_vae_transformer_arc_welding_tpu_torch.cli.shared, "
            "vq_vae_transformer_arc_welding_tpu_torch.cli.score_quality\n"
            "assert not any(m in ('jax', 'flax', 'msgpack', 'orbax') or "
            "m.startswith(('jax.', 'flax.', 'orbax.', "
            "'vq_vae_transformer_arc_welding_tpu.')) for m in sys.modules "
            "if sys.modules[m] is not None)\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_chip_smoke_refuses_without_cuda():
    """No hidden CPU fallback: without a CUDA device the script exits
    non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
