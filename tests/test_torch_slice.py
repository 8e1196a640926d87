"""The port's serving slice against the JAX package, end to end on the CPU.

`WeldingQualityPipeline(n_cycles=2, precision="int8",
encoder_impl="fused")` in both packages on bridged weights, one ragged
request. int8: the JAX calibration's qparams are bridged in, so both
run on identical scales; labels equal and probs within 1e-3 (the fused
attention normalizes after P@V, the JAX contract's 1e-3). f32: probs
within 1e-5. Also: the port imports without jax, and chip_smoke.py
refuses to run without a CUDA device.
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

from vq_vae_transformer_arc_welding_tpu.serve import (
    WeldingQualityPipeline as JaxPipeline)
from vq_vae_transformer_arc_welding_tpu_torch import bridge, entry
from vq_vae_transformer_arc_welding_tpu_torch.ops import (
    fused_block_quant as fbq, fused_encoder as fenc)
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


def test_classify_packs_operands_once(monkeypatch):
    """The kernels' weight operands are packed at construction and at
    calibration; classify repacks nothing."""
    pipe = _port_pipeline("int8")
    pipe.calibrate(H.windows(6, seed=4))
    calls = []
    for mod, name in ((fenc, "pack_encoder"), (fbq, "_block_operands")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    labels, _ = pipe.classify(H.windows(REQUEST, seed=12))
    assert labels.shape == (REQUEST,) and calls == []


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
            "vq_vae_transformer_arc_welding_tpu_torch.ops.fused_block_quant\n"
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
