"""The port's int8 transformer against the JAX package, on the CPU.

Quantized weights and scales must be bit-equal; calibration absmax
values within rtol 1e-5 (f32 forwards summed in another order); the
plain int8 chain's logits within 1e-4 on identical (bridged) qparams,
and labels equal.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models import quantized as jq
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.models import quantized as pq
from vq_vae_transformer_arc_welding_tpu_torch.ops import int8

import torch_port_helpers as H


def _np(t):
    return t.detach().cpu().numpy()


@functools.cache
def _calibrated():
    """JAX (model, params, act_absmax, qparams) and the port's
    (model, act_absmax) for the same ids."""
    jm, params = H.jax_transformer()
    ids = H.token_ids(6, seed=2)
    jam = jq.calibrate_activation_absmax(jm, params, jnp.asarray(ids))
    port = H.port_transformer()
    pam = pq.calibrate_activation_absmax(port, torch.from_numpy(ids))
    return jm, params, jam, jq.quantize_transformer(params, jam), port, pam


@pytest.mark.parametrize("shape", [(32, 96), (128, 32), (32, 1), (33, 2)])
def test_quantize_linear_bit_equal_to_jax(rng, shape):
    """(in, out) JAX weights; the port takes the transpose. A zero
    output column exercises the scale-1 rule."""
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[:, 0] = 0.0
    ref = jq.quantize_linear(jnp.asarray(w), act_absmax=3.7)
    q = pq.quantize_linear(torch.from_numpy(w.T.copy()), act_absmax=3.7)
    np.testing.assert_array_equal(_np(q.w_int8), np.asarray(ref.w_int8).T)
    np.testing.assert_array_equal(_np(q.scale), np.asarray(ref.scale))
    assert q.act_scale.dtype == torch.float32
    assert np.float32(q.act_scale.item()) == np.asarray(ref.act_scale)


def test_quantize_transformer_bit_equal_to_jax():
    _, _, jam, jqp, port, _ = _calibrated()
    qp = pq.quantize_transformer(port, jam)
    pairs = [(qp["lm_head"], jqp["lm_head"]),
             *((qp["class_head"][k], jqp["class_head"][k]) for k in ("l1",
                                                                     "l2"))]
    for blk, jblk in zip(qp["blocks"], jqp["blocks"]):
        pairs += [(blk[k], jblk[k]) for k in ("c_attn", "c_proj", "c_fc",
                                               "m_proj")]
    for q, ref in pairs:
        np.testing.assert_array_equal(_np(q.w_int8), np.asarray(ref.w_int8).T)
        np.testing.assert_array_equal(_np(q.scale), np.asarray(ref.scale))
        assert np.float32(q.act_scale.item()) == np.asarray(ref.act_scale)


def test_calibrate_activation_absmax_matches_jax():
    _, _, jam, _, _, pam = _calibrated()
    assert set(pam) == set(jam)
    for site in jam:
        np.testing.assert_allclose(pam[site], jam[site], rtol=1e-5)


@pytest.mark.parametrize("calibrated", [False, True])
def test_qdot_matches_jax(rng, calibrated):
    x = rng.standard_normal((4, 9, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32) * 0.1
    b = rng.standard_normal(24).astype(np.float32)
    am = 4.0 if calibrated else None
    ref = jq.qdot(jnp.asarray(x), jq.quantize_linear(
        jnp.asarray(w), jnp.asarray(b), act_absmax=am))
    out = pq.qdot(torch.from_numpy(x), pq.quantize_linear(
        torch.from_numpy(w.T.copy()), torch.from_numpy(b), act_absmax=am))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-6)


def test_int8_matmul_exact_on_cpu(rng):
    a = rng.integers(-127, 128, (5, 7, 300), dtype=np.int8)
    w = rng.integers(-127, 128, (11, 300), dtype=np.int8)
    out = int8.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(out), a.astype(np.int64) @ w.astype(np.int64).T)


def test_row_clip_fracs_match_jax(rng):
    a = rng.standard_normal((3, 5, 8)).astype(np.float32) * 3
    h8 = rng.integers(-127, 128, (3, 5, 8), dtype=np.int8)
    s = np.float32(50.0)
    np.testing.assert_array_equal(
        _np(pq._row_clip_frac(torch.from_numpy(a), torch.tensor(s))),
        np.asarray(jq._row_clip_frac(jnp.asarray(a), s)))
    np.testing.assert_array_equal(
        _np(pq._row_clip_frac_prequant(torch.from_numpy(h8))),
        np.asarray(jq._row_clip_frac_prequant(jnp.asarray(h8))))


@pytest.mark.parametrize("block_fusion,tol", [(None, 1e-4), ("attn", 1e-3)])
def test_quantized_classify_matches_jax(block_fusion, tol):
    """Bridged JAX qparams, so both run on identical scales. 'attn' on
    the JAX side is the Pallas kernel in interpret mode; its contract
    with the plain chain is 1e-3 (test_block_fusion_label_parity)."""
    jm, _, _, jqp, port, _ = _calibrated()
    ids = H.token_ids(4, seed=9)
    ref_rows, rows = [], []
    ref = jq.quantized_classify(jm, jqp, jnp.asarray(ids),
                                block_fusion=block_fusion, sat_rows=ref_rows)
    out = pq.quantized_classify(port, bridge.qparams_from_jax(jqp),
                                torch.from_numpy(ids),
                                block_fusion=block_fusion, sat_rows=rows)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=tol)
    np.testing.assert_array_equal(_np(out).argmax(-1),
                                  np.asarray(ref).argmax(-1))
    assert len(rows) == len(ref_rows)
    np.testing.assert_allclose(_np(torch.stack(rows)), np.stack(ref_rows),
                               atol=1e-6)


def test_quantized_classify_rejects_unported_fusion():
    _, _, jam, _, port, _ = _calibrated()
    qp = pq.quantize_transformer(port, jam)
    with pytest.raises(NotImplementedError):
        pq.quantized_classify(port, qp, torch.from_numpy(H.token_ids(1)),
                              block_fusion="full")


def test_fused_block_needs_calibration():
    port = H.port_transformer()
    qp = pq.quantize_transformer(port)      # dynamic scales
    with pytest.raises(ValueError):
        pq.quantized_classify(port, qp, torch.from_numpy(H.token_ids(2)),
                              block_fusion="attn")
