"""The port's serving slice against the JAX package, end to end on the CPU.

`WeldingQualityPipeline(n_cycles=2, precision="int8",
encoder_impl="fused")` in both packages on bridged weights, one ragged
request. int8: the JAX calibration's qparams are bridged in, so both
run on identical scales; labels equal and probs within 1e-3 (the fused
attention normalizes after P@V, the JAX contract's 1e-3). f32: probs
within 1e-5. The saturation probe gives JAX's numbers on the rows it
is given. Each block_fusion and fused_attention option of
make_pipeline_quantized reaches its kernels' entries. Also: the port
imports without jax, and chip_smoke.py refuses to run without a CUDA
device.
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
    fused_encoder as fenc, fused_mlp_quant as fmlp)
from vq_vae_transformer_arc_welding_tpu_torch.serve import (
    WeldingQualityPipeline)

import torch_port_helpers as H

REPO = Path(__file__).resolve().parent.parent
REQUEST = 5          # ragged against max_batch 4: chunks of 4 and 1


def _jax_pipeline(precision, batch_norm=False):
    jm, params, state = H.jax_vqvae(batch_norm)
    tm, tp = H.jax_transformer()
    return JaxPipeline((jm, params, state), (tm, tp), n_cycles=H.N_CYCLES,
                       max_batch=8, precision=precision,
                       encoder_impl="fused")


def _port_pipeline(precision, batch_norm=False, max_batch=4):
    return WeldingQualityPipeline(H.port_vqvae(batch_norm),
                                  H.port_transformer(), n_cycles=H.N_CYCLES,
                                  max_batch=max_batch, precision=precision,
                                  encoder_impl="fused")


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
    pipe.qparams = bridge.qparams_from_jax(jp.qparams)
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


def test_chunking_does_not_change_results():
    x = H.windows(REQUEST, seed=8)
    pipe = _port_pipeline("int8", max_batch=2)
    pipe.qparams = bridge.qparams_from_jax(_jax_int8()[0].qparams)
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
    qparams = bridge.qparams_from_jax(_jax_int8()[0].qparams)
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
    pipe.qparams = bridge.qparams_from_jax(jp.qparams)
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


def test_saturation_rate_refuses_without_calibration():
    with pytest.raises(RuntimeError):
        _port_pipeline("int8").saturation_rate(H.windows(1))
    pipe = _port_pipeline("int8")
    pipe.qparams = bridge.qparams_from_jax(_jax_int8()[0].qparams)
    with pytest.raises(ValueError):
        pipe.saturation_rate(H.windows(0))


def test_int8_classify_requires_calibration():
    with pytest.raises(RuntimeError):
        _port_pipeline("int8").classify(H.windows(1))
    with pytest.raises(ValueError):
        _port_pipeline("f32").classify(H.windows(0))


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
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_block_quant, "
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_mlp_quant, "
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_attn_quant\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', "
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
