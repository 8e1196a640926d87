"""The port's int8 transformer against the JAX package, on the CPU.

Quantized weights and scales must be bit-equal; calibration absmax
values within rtol 1e-5 (f32 forwards summed in another order); the
plain int8 chain's logits within 1e-4 on identical (bridged) qparams,
and labels equal. The fused variants of quantized_classify keep the
JAX package's own contracts with the plain chain
(tests/test_quantized.py): 1e-3 for 'attn', 'full' and the
fused_attention paths, 2e-2 for 'attn8' and 'full8', 5e-2 for '-bf16'.
The int8 encoder: weights and scales bit-equal, absmax within rtol
1e-5, ids within 1% of JAX's on bridged qenc. The in-path saturation
monitor's rows (`sat_rows`) within 1e-6 of JAX's, on act scales that
clip at every site, and equal to the eager chain's.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models import quantized as jq
from vq_vae_transformer_arc_welding_tpu_torch.models import quantized as pq
from vq_vae_transformer_arc_welding_tpu_torch.ops import int8, int8_gemm
from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import new_gelu

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


CLASSIFY_CASES = [
    ({}, 1e-4), ({"block_fusion": "attn"}, 1e-3),
    ({"block_fusion": "full"}, 1e-3), ({"block_fusion": "attn8"}, 2e-2),
    ({"block_fusion": "full8"}, 2e-2), ({"block_fusion": "attn-bf16"}, 5e-2),
    ({"block_fusion": "full-bf16"}, 5e-2), ({"fused_attention": True}, 1e-3),
    ({"fused_attention": True, "fused_mlp": True}, 1e-3),
    ({"fused_attention": True, "fused_qkv": False}, 1e-3),
    ({"fused_attention": True, "attn_block_rows": 8}, 1e-3),
]


@pytest.mark.parametrize("kw,tol", CLASSIFY_CASES,
                         ids=lambda v: str(v) if isinstance(v, dict) else "")
def test_quantized_classify_matches_jax(kw, tol):
    """Bridged JAX qparams, so both run on identical scales. The fused
    variants on the JAX side are the Pallas kernels in interpret mode.
    The in-path saturation rows are compared where JAX collects them
    (the unfused and attention-half paths)."""
    jm, _, _, jqp, port, _ = _calibrated()
    ids = H.token_ids(4, seed=9)
    monitored = (kw.get("block_fusion") or "attn").startswith("attn") \
        and not kw.get("fused_attention")
    ref_rows = [] if monitored else None
    rows = [] if monitored else None
    ref = jq.quantized_classify(jm, jqp, jnp.asarray(ids), sat_rows=ref_rows,
                                **kw)
    out = pq.quantized_classify(port, H.port_qparams(jqp),
                                torch.from_numpy(ids), sat_rows=rows, **kw)
    assert out.dtype == torch.float32 and out.shape == (4, 2)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=tol)
    np.testing.assert_array_equal(_np(out).argmax(-1),
                                  np.asarray(ref).argmax(-1))
    if monitored:
        assert len(rows) == len(ref_rows)
        np.testing.assert_allclose(_np(torch.stack(rows)),
                                   np.stack(ref_rows), atol=1e-6)


@pytest.mark.parametrize("kw", [
    {"block_fusion": "attn", "fused_attention": True},
    {"block_fusion": "full", "fused_mlp": True},
    {"fused_attention": True, "sat_rows": []},
    {"fused_mlp": True},
    {"block_fusion": "full", "sat_rows": []},
], ids=lambda kw: ",".join(sorted(kw)))
def test_quantized_classify_raises_like_jax(kw):
    """The JAX package's ValueErrors: block_fusion with fused_attention
    or fused_* options, sat_rows with fused_attention, fused_* options
    without fused_attention, and in-path monitoring of a full block."""
    jm, _, _, jqp, port, _ = _calibrated()
    ids = H.token_ids(1)
    with pytest.raises(ValueError):
        jq.quantized_classify(jm, jqp, jnp.asarray(ids), **kw)
    with pytest.raises(ValueError):
        pq.quantized_classify(port, H.port_qparams(jqp),
                              torch.from_numpy(ids), **kw)


def test_saturation_stats_matches_jax():
    """The drift probe on bridged qparams whose act scales were
    calibrated at half the absmax, so that every site clips: the same
    sites in the same order, each fraction equal, and their mean."""
    jm, params, jam, _, port, _ = _calibrated()
    jqp = jq.quantize_transformer(params, {k: v / 2 for k, v in jam.items()})
    ids = H.token_ids(4, seed=13)
    ref_all, ref = jq.saturation_stats(jm, jqp, jnp.asarray(ids))
    got_all, got = pq.saturation_stats(port, H.port_qparams(jqp),
                                       torch.from_numpy(ids))
    assert list(got) == list(ref)
    assert sum(float(v) > 0 for v in got.values()) >= len(got) // 2
    for site in ref:
        assert float(got[site]) == pytest.approx(float(ref[site]), abs=1e-6)
    assert float(got_all) == pytest.approx(float(ref_all), abs=1e-6)


def test_saturation_stats_needs_calibration():
    port = H.port_transformer()
    with pytest.raises(ValueError):
        pq.saturation_stats(port, pq.quantize_transformer(port),
                            torch.from_numpy(H.token_ids(1)))


def test_fused_block_needs_calibration():
    port = H.port_transformer()
    qp = pq.quantize_transformer(port)      # dynamic scales
    with pytest.raises(ValueError):
        pq.quantized_classify(port, qp, torch.from_numpy(H.token_ids(2)),
                              block_fusion="attn")


# -- the 'attn' int8 MLP through the int8 GEMM ---------------------------------

def _eager_mlp(blk, h8, resid, clip_rows=None):
    """The int8 MLP after kernel #2 as the eager qdot chain (the routing
    before the GEMM): resid + qdot(new_gelu(qdot_prequantized(h8,
    c_fc)), m_proj). Without sat_rows nothing asks for counts."""
    assert clip_rows is None
    g = new_gelu(pq.qdot_prequantized(h8, blk["c_fc"]))
    return resid + pq.qdot(g, blk["m_proj"])


def _gemm_calls(monkeypatch):
    """The int8 GEMM wrapper's calls as (epilogue,) tuples; a GELU+q8
    call that counts the clipped values is "gelu_q8+count"."""
    calls = []
    real = int8_gemm.int8_gemm

    def spy(a8, w8, cs, cb, resid=None, qscale=None, clip_rows=None):
        calls.append("resid" if qscale is None else
                     "gelu_q8" if clip_rows is None else "gelu_q8+count")
        return real(a8, w8, cs, cb, resid, qscale, clip_rows)

    monkeypatch.setattr(int8_gemm, "int8_gemm", spy)
    return calls


@pytest.mark.parametrize("fusion,tol", [("attn", 1e-3), ("attn8", 2e-2),
                                        ("attn-bf16", 5e-2)])
def test_attn_mlp_runs_the_int8_gemm_bit_equal_to_the_eager_chain(
        monkeypatch, fusion, tol):
    """Without sat_rows the attention-half paths run their MLP as two
    int8 GEMM calls a block (c_fc with the GELU+q8 epilogue, m_proj with
    the residual): logits bit-equal to the eager chain's, and within the
    JAX tolerance of JAX's quantized_classify, as the eager chain is."""
    jm, _, _, jqp, port, _ = _calibrated()
    qp = H.port_qparams(jqp)
    ids = H.token_ids(4, seed=9)
    calls = _gemm_calls(monkeypatch)
    out = pq.quantized_classify(port, qp, torch.from_numpy(ids),
                                block_fusion=fusion)
    assert calls == ["gelu_q8", "resid"] * len(qp["blocks"])
    with monkeypatch.context() as m:
        m.setattr(pq, "_mlp_int8_gemm", _eager_mlp)
        eager = pq.quantized_classify(port, qp, torch.from_numpy(ids),
                                      block_fusion=fusion)
    assert len(calls) == 2 * len(qp["blocks"])
    assert torch.equal(out, eager)
    ref = jq.quantized_classify(jm, jqp, jnp.asarray(ids),
                                block_fusion=fusion)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=tol)
    np.testing.assert_array_equal(_np(out).argmax(-1),
                                  np.asarray(ref).argmax(-1))


@functools.cache
def _tight():
    """JAX qparams whose act scales were calibrated at half the absmax,
    so that every site clips, and the port's bridged copy."""
    _, params, jam, _, _, _ = _calibrated()
    jqp = jq.quantize_transformer(params, {k: v / 2 for k, v in jam.items()})
    return jqp, H.port_qparams(jqp)


@pytest.mark.parametrize("fusion", ["attn", "attn8"])
def test_attn_mlp_keeps_the_eager_chain_for_sat_rows(monkeypatch, fusion):
    """sat_rows no longer keeps the eager chain: the MLP runs as the two
    int8 GEMM calls a block, c_fc counting the m_proj inputs it clips,
    and #2 counting h8 at +-127. The rows keep the eager chain's values
    exactly (its `_row_clip_frac_prequant` of h8 and `_row_clip_frac` of
    the f32 new_gelu output, per block, then the class head's two), and
    the logits its bits. The act scales are calibrated at half the
    absmax, so that both sites clip."""
    _, qp = _tight()
    port = _calibrated()[4]
    ids = torch.from_numpy(H.token_ids(3, seed=21))
    calls = _gemm_calls(monkeypatch)
    rows = []
    out = pq.quantized_classify(port, qp, ids, block_fusion=fusion,
                                sat_rows=rows)
    assert calls == ["gelu_q8+count", "resid"] * len(qp["blocks"])
    assert len(rows) == 2 * len(qp["blocks"]) + 2
    seen, eager_rows = [], []

    def eager(blk, h8, resid, clip_rows=None):
        g = new_gelu(pq.qdot_prequantized(h8, blk["c_fc"]))
        seen.append(pq._row_clip_frac_prequant(h8))
        seen.append(pq._row_clip_frac(g, blk["m_proj"].act_scale))
        return resid + pq.qdot(g, blk["m_proj"])

    with monkeypatch.context() as m:
        m.setattr(pq, "_mlp_int8_gemm", eager)
        ref = pq.quantized_classify(port, qp, ids, block_fusion=fusion,
                                    sat_rows=eager_rows)
    assert torch.equal(out, ref)
    want = seen + eager_rows[-2:]
    for got, w in zip(rows, want):
        assert got.dtype == torch.float32 and torch.equal(got, w)
    assert all(float(r.max()) > 0 for r in rows[:-2])


@pytest.mark.parametrize("fusion,tol", [("attn", 1e-3), ("attn8", 2e-2),
                                        ("attn-bf16", 5e-2)])
def test_sat_rows_match_jax_where_every_site_clips(monkeypatch, fusion, tol):
    """The in-path monitor's rows through the GEMM path against JAX's
    quantized_classify (its Pallas kernels in interpret mode, its MLP
    and counters on XLA) on scales that clip at every site: the same
    sites in the same order, each within 1e-6; two int8 GEMM calls a
    block; the logits within the path's JAX tolerance, labels equal."""
    jqp, qp = _tight()
    jm, port = _calibrated()[0], _calibrated()[4]
    ids = H.token_ids(4, seed=22)
    calls = _gemm_calls(monkeypatch)
    rows, ref_rows = [], []
    out = pq.quantized_classify(port, qp, torch.from_numpy(ids),
                                block_fusion=fusion, sat_rows=rows)
    ref = jq.quantized_classify(jm, jqp, jnp.asarray(ids),
                                block_fusion=fusion, sat_rows=ref_rows)
    assert calls == ["gelu_q8+count", "resid"] * len(qp["blocks"])
    assert len(rows) == len(ref_rows) == 2 * len(qp["blocks"]) + 2
    np.testing.assert_allclose(_np(torch.stack(rows)), np.stack(ref_rows),
                               rtol=0, atol=1e-6)
    assert (np.stack(ref_rows)[:-2].max(-1) > 0).all()
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=tol)
    np.testing.assert_array_equal(_np(out).argmax(-1),
                                  np.asarray(ref).argmax(-1))


# -- the opt-in int8 encoder ----------------------------------------------------

@functools.cache
def _calibrated_encoder(batch_norm):
    """JAX (model, params, state, enc_absmax, qenc), the port's model and
    the calibration cycles."""
    jm, params, state = H.jax_vqvae(batch_norm)
    cyc = H.windows(8, seed=20).reshape(-1, 200, 2)
    jam = jq.calibrate_encoder_absmax(jm, params, state, jnp.asarray(cyc))
    return (jm, params, state, jam, jq.quantize_encoder(jm, params, jam),
            H.port_vqvae(batch_norm), cyc)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_calibrate_encoder_absmax_matches_jax(batch_norm):
    _, _, _, jam, _, port, cyc = _calibrated_encoder(batch_norm)
    am = pq.calibrate_encoder_absmax(port, torch.from_numpy(cyc))
    assert set(am) == set(jam) == {"b0_c1", "b0_c2", "b1_c1", "b1_c2", "sep"}
    for site in jam:
        np.testing.assert_allclose(am[site], jam[site], rtol=1e-5)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_quantize_encoder_bit_equal_to_jax(batch_norm):
    """On the JAX absmax table: int8 weights (transposed), per-channel
    scales, biases and act scales equal; the bridged qenc is the same."""
    _, _, _, jam, jqenc, port, _ = _calibrated_encoder(batch_norm)
    qenc = pq.quantize_encoder(port, jam)
    bridged = H.port_qenc(jqenc)
    refs = [b[k] for b in jqenc["blocks"] for k in ("c1", "c2")]
    refs.append(jqenc["sep"])
    for tree in (qenc, bridged):
        got = [b[k] for b in tree["blocks"] for k in ("c1", "c2")]
        got.append(tree["sep"])
        assert len(got) == len(refs) == 5
        for q, ref in zip(got, refs):
            np.testing.assert_array_equal(_np(q.w_int8),
                                          np.asarray(ref.w_int8).T)
            np.testing.assert_array_equal(_np(q.scale), np.asarray(ref.scale))
            np.testing.assert_array_equal(_np(q.bias), np.asarray(ref.bias))
            assert np.float32(q.act_scale.item()) == np.asarray(
                ref.act_scale)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_encode_indices_quantized_matches_jax(batch_norm):
    """ids on the bridged int8 weights and scales: at most 1% may differ
    from JAX's (the f32 steps between the int8 products are summed in
    another order, and a value at a rounding boundary moves by one
    step). Measured: 0 of 1,024 ids differ, with and without BatchNorm.
    Against the port's own f32 encoder the int8 encoder stays under the
    JAX package's 5% bound."""
    jm, params, state, _, jqenc, port, _ = _calibrated_encoder(batch_norm)
    x = H.windows(32, seed=21).reshape(-1, 200, 2)
    ref = np.asarray(jq.encode_indices_quantized(jm, jqenc, params, state,
                                                 jnp.asarray(x)))
    with torch.no_grad():
        ids = pq.encode_indices_quantized(port, H.port_qenc(jqenc),
                                          torch.from_numpy(x))
        ids_f = port.encode_indices(torch.from_numpy(x))
    assert ids.dtype == torch.int32 and ids.shape == ref.shape
    assert (_np(ids) != ref).mean() <= 0.01
    assert (_np(ids) != _np(ids_f)).mean() < 0.05
