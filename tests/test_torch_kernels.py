"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode, as the JAX package's own
tests do. tests/test_torch_cuda.py holds the kernel-against-plain
tests that need the card.
"""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models.quantized import (
    calibrate_activation_absmax as jax_calibrate,
    quantize_transformer as jax_quantize)
from vq_vae_transformer_arc_welding_tpu.models.quantized import qdot as jqdot
from vq_vae_transformer_arc_welding_tpu.models.quantized import (
    _row_clip_frac_prequant as jax_rail_frac)
from vq_vae_transformer_arc_welding_tpu.models import (
    VQVAEPatch as JaxVQVAEPatch)
from vq_vae_transformer_arc_welding_tpu.ops import (
    pallas_attn_quant as jattn, pallas_block_quant as jbq,
    pallas_encoder as jenc, pallas_mlp_quant as jmlp)
from vq_vae_transformer_arc_welding_tpu.ops.norm import layer_norm as jln
from vq_vae_transformer_arc_welding_tpu_torch import bridge, kernels
from vq_vae_transformer_arc_welding_tpu_torch.models.quantized import qdot
from vq_vae_transformer_arc_welding_tpu_torch.ops import (
    fused_attn as fflash, fused_attn_quant as fattn,
    fused_block_quant as fbq, fused_decode as fdec, fused_encoder as fenc,
    fused_mlp_quant as fmlp, fused_vq as fvq, int8_gemm as ig)
from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm

import torch_port_helpers as H


def _np(t):
    return t.detach().cpu().numpy()


# -- kernel 1: encoder resblock chain ---------------------------------------

@pytest.mark.parametrize("batch_norm", [False, True])
def test_pack_encoder_matches_jax(batch_norm):
    jm, params, state = H.jax_vqvae(batch_norm)
    w_ref, v_ref = jenc._pack_encoder(jm, params, state)
    w, v = fenc.pack_encoder(H.port_vqvae(batch_norm))
    np.testing.assert_array_equal(_np(w), np.asarray(w_ref))
    np.testing.assert_array_equal(_np(v), np.asarray(v_ref))


@pytest.mark.parametrize("batch_norm", [False, True])
def test_fused_encoder_chain_matches_jax(rng, batch_norm):
    """The chain's output against JAX fused_encoder_eval, 1e-5: both are
    f32; the Pallas kernel's A&S erf differs from the exact erf by at
    most 1.5e-7."""
    jm, params, state = H.jax_vqvae(batch_norm)
    w, v = (np.array(a) for a in jenc._pack_encoder(jm, params, state))
    x = rng.standard_normal((200, 64)).astype(np.float32)
    ref = jenc.fused_encoder_eval(jnp.asarray(x), w, v, tile_rows=64,
                                  use_bn=batch_norm)
    out = fenc.fused_encoder_eval(*map(torch.from_numpy, (x, w, v)),
                                  use_bn=batch_norm)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_encode_indices_fused_matches_jax(batch_norm):
    jm, params, state = H.jax_vqvae(batch_norm)
    x = H.windows(48, seed=1).reshape(-1, 200, 2)[:48]
    ref = jenc.encode_indices_fused(jm, params, state, jnp.asarray(x),
                                    tile_rows=64)
    vq = H.port_vqvae(batch_norm)
    with torch.no_grad():
        ids = fenc.encode_indices_fused(vq, fenc.pack_encoder(vq),
                                        torch.from_numpy(x))
    np.testing.assert_array_equal(_np(ids), np.asarray(ref))


@pytest.mark.parametrize("hidden,group", [(64, 256), (512, 4), (1024, 1)])
def test_group_size_follows_jax_rule(hidden, group):
    assert fenc.group_size_for(hidden) == group


# -- kernel 1's bf16 variant (compute_dtype) ---------------------------------
#
# Both products' inputs are rounded to bf16 and summed in f32. Against
# the Pallas kernel in interpret mode the plain version agrees to f32
# rounding (2e-7) but for the rows a flip reaches: the A&S erf of the
# Pallas gelu differs from the exact erf by up to 1.5e-7, which moves a
# gelu output across a bf16 rounding boundary in about one element of
# 10^4, and one moved input changes a row's sums by ~2^-9 x |h| x |w|,
# 1e-4 to 3e-4 here. So: every element within 5e-4, the mean difference
# within 5e-6, while the f32 chain is 1e-4 away on average (the rounding
# that the two share). The same flips can move an id at a near-tie: at
# most 1% of the ids may differ from JAX's.

@pytest.mark.parametrize("n_blocks", [1, 2])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_fused_encoder_bf16_chain_matches_jax(rng, batch_norm, n_blocks):
    jm, params, state = H.jax_vqvae(batch_norm)
    w, v = (np.array(a) for a in jenc._pack_encoder(jm, params, state))
    w, v = w[:2 * n_blocks], v[:10 * n_blocks]
    x = rng.standard_normal((200, 64)).astype(np.float32)
    ref = np.asarray(jenc.fused_encoder_eval(
        jnp.asarray(x), w, v, tile_rows=64, use_bn=batch_norm,
        compute_dtype=jnp.bfloat16))
    tx, tw, tv = map(torch.from_numpy, (x, w, v))
    out = fenc.fused_encoder_eval(tx, tw, tv, use_bn=batch_norm,
                                  compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=5e-4)
    assert np.abs(_np(out) - ref).mean() < 5e-6
    # a bf16 pack gives the bits of the f32 pack cast per call
    packed = fenc.fused_encoder_eval(tx, tw.bfloat16(), tv, use_bn=batch_norm,
                                     compute_dtype=torch.bfloat16)
    assert torch.equal(packed, out)
    # and the rounding is there: the f32 chain is much further away
    f32 = fenc.fused_encoder_eval(tx, tw, tv, use_bn=batch_norm)
    assert (out - f32).abs().mean() > 1e-4
    assert np.abs(ref - _np(f32)).mean() > 1e-4


@pytest.mark.parametrize("batch_norm", [False, True])
def test_encode_indices_fused_bf16_matches_jax(batch_norm):
    """Ids of the bf16 encoder: within 1% of JAX's bf16 ids, under the
    JAX test's 10% of the f32 encoder's on random weights, and
    group_size=1 takes the chain kernel too and gives the same ids."""
    jm, params, state = H.jax_vqvae(batch_norm)
    x = H.windows(48, seed=1).reshape(-1, 200, 2)[:48]
    ref = np.asarray(jenc.encode_indices_fused(
        jm, params, state, jnp.asarray(x), tile_rows=64,
        compute_dtype=jnp.bfloat16))
    vq = H.port_vqvae(batch_norm)
    packed = fenc.pack_encoder(vq, torch.bfloat16)
    assert packed[0].dtype == torch.bfloat16
    assert packed[1].dtype == torch.float32
    tx = torch.from_numpy(x)
    with torch.no_grad():
        ids = fenc.encode_indices_fused(vq, packed, tx,
                                        compute_dtype=torch.bfloat16)
        ids1 = fenc.encode_indices_fused(vq, packed, tx, group_size=1,
                                         compute_dtype=torch.bfloat16)
        from_f32 = fenc.encode_indices_fused(vq, fenc.pack_encoder(vq), tx,
                                             compute_dtype=torch.bfloat16)
        exact = vq.encode_indices(tx)
    assert ids.dtype == torch.int32 and ids.shape == ref.shape
    assert (_np(ids) != ref).mean() <= 0.01
    assert (ids != exact).float().mean() < 0.10
    assert torch.equal(ids, ids1) and torch.equal(ids, from_f32)


@pytest.mark.parametrize("group_size,want", [(None, 1), (1, 5), (2, 3)])
def test_bf16_encoder_takes_the_chain_at_every_group(monkeypatch,
                                                     group_size, want):
    """With a compute dtype the chain wrapper runs every group, 1
    included; the one-resblock wrapper is never called."""
    jm = JaxVQVAEPatch(hidden_dim=64, input_dim=2, num_embeddings=H.K,
                       embedding_dim=16, n_resblocks=5, learning_rate=1e-3,
                       batch_norm=False)
    vq = bridge.vqvae_from_jax(jm.hparams, *jm.init(1), device="cpu")
    calls = []
    real = fenc.fused_encoder_eval
    monkeypatch.setattr(fenc, "fused_encoder_eval", lambda *a, **k: (
        calls.append((a[1].dtype, k["compute_dtype"])), real(*a, **k))[1])
    monkeypatch.setattr(fenc, "resblock_eval", None)
    with torch.no_grad():
        fenc.encode_indices_fused(
            vq, fenc.pack_encoder(vq, torch.bfloat16),
            torch.from_numpy(H.windows(1, seed=2).reshape(-1, 200, 2)),
            group_size=group_size, compute_dtype=torch.bfloat16)
    assert calls == [(torch.bfloat16, torch.bfloat16)] * want


@pytest.mark.parametrize("hidden,group", [(64, 512), (512, 8), (1024, 2),
                                          (2048, 1)])
def test_group_size_of_bf16_weights_follows_jax_rule(hidden, group):
    assert fenc.group_size_for(hidden, 2) == group


def test_bf16_plain_product_sums_in_f32():
    """The plain version's product is bf16 inputs summed in f32, not a
    bf16 matmul (which would round the sum as well)."""
    g = torch.Generator().manual_seed(0)
    h, w = torch.randn(16, 64, generator=g), torch.randn(64, 64, generator=g)
    got = fenc._dot(h, w, torch.bfloat16)
    want = (h.bfloat16().double() @ w.bfloat16().double()).float()
    assert got.dtype == torch.float32
    assert (got - want).abs().max() < 1e-5
    assert (got - (h.bfloat16() @ w.bfloat16()).float()).abs().max() > 1e-3
    with pytest.raises(ValueError, match="compute_dtype"):
        fenc.fused_encoder_eval(h, w[None].repeat(2, 1, 1),
                                torch.zeros(10, 64), use_bn=False,
                                compute_dtype=torch.float16)


# -- kernels 3, 4 and 5: one resblock and the encoder's two ends -------------
#
# f32 outputs to 1e-5, as kernel 1 (the A&S erf of the Pallas kernels);
# ids equal: the two libraries sum the distances' dot products in other
# orders, which could move an argmin only at a near-tie, and these
# inputs hold none.

def _packed(batch_norm):
    """The JAX pack of the small encoder as numpy and as torch tensors."""
    jm, params, state = H.jax_vqvae(batch_norm)
    w, v = (np.array(a) for a in jenc._pack_encoder(jm, params, state))
    return params, w, v, torch.from_numpy(w), torch.from_numpy(v)


def _edge_operands(params):
    """w_pe (25, 64), b_pe, w_sep (64, 16), b_sep of the small encoder."""
    w_sep = np.asarray(params["sep_conv"]["w"])
    return tuple(np.array(a, np.float32) for a in (
        params["patch_embed"]["kernel"], params["patch_embed"]["bias"],
        w_sep[:, :, w_sep.shape[-1] // 2].T, params["sep_conv"]["b"]))


@pytest.mark.parametrize("batch_norm", [False, True])
def test_fused_resblock_eval_matches_jax(rng, batch_norm):
    """Kernel 3 with the JAX function's operands; no test of the JAX
    package runs it, so it runs here in interpret mode. The
    operand-level entry on views of the pack gives the same values."""
    _, w, v, tw, tv = _packed(batch_norm)
    x = rng.standard_normal((200, 64)).astype(np.float32)
    ref = jenc.fused_resblock_eval(
        jnp.asarray(x), w[0], v[0], tuple(v[1:5]), w[1], v[5], tuple(v[6:10]),
        tile_rows=64, use_bn=batch_norm)
    out = fenc.fused_resblock_eval(
        torch.from_numpy(x), tw[0], tv[0], tuple(tv[1:5]), tw[1], tv[5],
        tuple(tv[6:10]), use_bn=batch_norm)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-5)
    packed = fenc.resblock_eval(torch.from_numpy(x), tw[0], tw[1], tv[:10],
                                use_bn=batch_norm)
    torch.testing.assert_close(packed, out, rtol=0, atol=0)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_encoder_resblocks_fused_matches_jax(batch_norm):
    """One launch per resblock on views of the pack, against the JAX loop
    that repacks per call."""
    jm, params, state = H.jax_vqvae(batch_norm)
    vq = H.port_vqvae(batch_norm)
    h = np.random.default_rng(3).standard_normal((5, 16, 64)).astype(
        np.float32)
    ref = jenc.encoder_resblocks_fused(jm, params, state, jnp.asarray(h),
                                       tile_rows=64)
    with torch.no_grad():
        out = fenc.encoder_resblocks_fused(vq, fenc.pack_encoder(vq),
                                           torch.from_numpy(h))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_fused_encoder_entry_eval_matches_jax(rng, batch_norm):
    params, w, v, tw, tv = _packed(batch_norm)
    w_pe, b_pe, _, _ = _edge_operands(params)
    patches = rng.standard_normal((200, 25)).astype(np.float32)
    ref = jenc.fused_encoder_entry_eval(jnp.asarray(patches), w_pe, b_pe, w,
                                        v, tile_rows=64, use_bn=batch_norm)
    out = fenc.fused_encoder_entry_eval(
        *map(torch.from_numpy, (patches, w_pe, b_pe)), tw, tv,
        use_bn=batch_norm)
    assert out.shape == (200, 64)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tie"])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_fused_encoder_exit_eval_matches_jax(rng, batch_norm, tie):
    """ids bit-equal on a codebook drawn at the spread of z; with codes
    2 and 11 the same vector, the nearest to row 5, neither side ever
    answers 11."""
    params, w, v, tw, tv = _packed(batch_norm)
    _, _, w_sep, b_sep = _edge_operands(params)
    x = rng.standard_normal((200, 64)).astype(np.float32)
    z = _np(fenc.fused_encoder_eval(torch.from_numpy(x), tw, tv,
                                    use_bn=batch_norm)) @ w_sep + b_sep
    cb = (rng.standard_normal((32, 16)) * z.std()).astype(np.float32)
    if tie:
        cb[2] = cb[11] = z[5]       # row 5's own z: its nearest, twice
    ref = jenc.fused_encoder_exit_eval(jnp.asarray(x), w, v, w_sep, b_sep,
                                       cb, tile_rows=64, use_bn=batch_norm)
    ids = fenc.fused_encoder_exit_eval(
        torch.from_numpy(x), tw, tv,
        *map(torch.from_numpy, (w_sep, b_sep, cb)), use_bn=batch_norm)
    assert ids.dtype == torch.int32 and ids.shape == (200,)
    assert len(np.unique(_np(ids))) > 8
    np.testing.assert_array_equal(_np(ids), np.asarray(ref))
    if tie:
        assert (_np(ids) == 2).any() and not (_np(ids) == 11).any()


def _port_variant(name, vq, x):
    packed, edges = fenc.pack_encoder(vq), fenc.pack_encoder_edges(vq)
    if name == "group1":
        return fenc.encode_indices_fused(vq, packed, x, group_size=1)
    if name == "mono":
        return fenc.encode_indices_fused_mono(vq, packed, x)
    return fenc.encode_indices_fused_edges(
        vq, packed, edges, x, group_size=1 if name == "edges" else 2)


def _jax_variant(name, jm, params, state, x):
    if name == "group1":
        return jenc.encode_indices_fused(jm, params, state, x, tile_rows=64,
                                         group_size=1)
    if name == "mono":
        return jenc.encode_indices_fused_mono(jm, params, state, x,
                                              tile_rows=64)
    return jenc.encode_indices_fused_edges(
        jm, params, state, x, tile_rows=64,
        group_size=1 if name == "edges" else 2)


@pytest.mark.parametrize("name", ["group1", "mono", "edges",
                                  "edges-fallback"])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_encode_indices_variants_match_jax(batch_norm, name):
    """group_size=1 (kernel 3 per block), the mono chain, the edges at
    group 1 (entry, exit) and at group 2, where two resblocks are fewer
    than two groups and the edges fall back to encode_indices_fused: ids
    bit-equal to JAX's and to the default path's, as the JAX package's
    test_fused_encoder_resblock_parity holds them."""
    jm, params, state = H.jax_vqvae(batch_norm)
    x = H.windows(48, seed=1).reshape(-1, 200, 2)[:48]
    ref = _jax_variant(name, jm, params, state, jnp.asarray(x))
    vq = H.port_vqvae(batch_norm)
    with torch.no_grad():
        ids = _port_variant(name, vq, torch.from_numpy(x))
        default = fenc.encode_indices_fused(vq, fenc.pack_encoder(vq),
                                            torch.from_numpy(x))
    assert ids.dtype == torch.int32 and ids.shape == (48, 16)
    np.testing.assert_array_equal(_np(ids), np.asarray(ref))
    np.testing.assert_array_equal(_np(ids), _np(default))


@pytest.mark.parametrize("name,want", [
    ("default", {"fused_encoder_eval": 1}),
    ("group1", {"resblock_eval": 5}),
    ("mono", {"fused_encoder_eval": 1}),
    ("edges", {"fused_encoder_entry_eval": 1, "fused_encoder_eval": 1,
               "fused_encoder_exit_eval": 1}),
    ("edges-fallback", {"fused_encoder_eval": 2}),
])
def test_encoder_paths_reach_their_kernels(monkeypatch, name, want):
    """Five resblocks: each path calls the wrappers of its own kernels
    and no others. The edges at group 2 are entry (blocks 0-1), one
    middle chain group (2-3) and exit (4), with ids equal to JAX's; at
    group 3 five blocks are fewer than two groups, so two chain calls."""
    jm = JaxVQVAEPatch(hidden_dim=64, input_dim=2, num_embeddings=H.K,
                       embedding_dim=16, n_resblocks=5, learning_rate=1e-3,
                       batch_norm=False)
    params, state = jm.init(1)
    vq = bridge.vqvae_from_jax(jm.hparams, params, state, device="cpu")
    packed, edges = fenc.pack_encoder(vq), fenc.pack_encoder_edges(vq)
    calls = {}
    for fn in ("fused_encoder_eval", "resblock_eval",
               "fused_encoder_entry_eval", "fused_encoder_exit_eval"):
        real = getattr(fenc, fn)
        monkeypatch.setattr(fenc, fn, lambda *a, _r=real, _n=fn, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _r(*a, **k))[1])
    x = H.windows(3, seed=2).reshape(-1, 200, 2)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        if name == "default":
            ids = fenc.encode_indices_fused(vq, packed, tx)
        elif name in ("group1", "mono"):
            ids = _port_variant(name, vq, tx)
        else:
            gs = 2 if name == "edges" else 3
            ids = fenc.encode_indices_fused_edges(vq, packed, edges, tx,
                                                  group_size=gs)
            ref = jenc.encode_indices_fused_edges(
                jm, params, state, jnp.asarray(x), tile_rows=64,
                group_size=gs)
            np.testing.assert_array_equal(_np(ids), np.asarray(ref))
        plain = vq.encode_indices(tx)
    assert calls == want
    np.testing.assert_array_equal(_np(ids), _np(plain))


# -- kernel 7: nearest-code search --------------------------------------------

@pytest.mark.parametrize("n,d,k,tie", [(3000, 32, 256, False),
                                       (512, 8, 16, True),
                                       (77, 16, 32, False)])
def test_nearest_codes_pallas_matches_jax(rng, n, d, k, tie):
    """The three cases of the JAX package's tests/test_pallas.py: ids
    equal the JAX kernel's (interpret mode) and both packages' plain
    nearest_codes; with code 11 a copy of code 2, no id is 11."""
    from vq_vae_transformer_arc_welding_tpu.ops.pallas_vq import (
        nearest_codes_pallas as jax_nearest)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.vq import nearest_codes
    z = rng.standard_normal((n, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    if tie:
        cb[11] = cb[2]
    ref = np.asarray(jax_nearest(jnp.asarray(z), jnp.asarray(cb)))
    tz, tcb = torch.from_numpy(z), torch.from_numpy(cb)
    ids = fvq.nearest_codes_pallas(tz, tcb)
    assert ids.dtype == torch.int32 and ids.shape == (n,)
    np.testing.assert_array_equal(_np(ids), ref)
    np.testing.assert_array_equal(_np(ids), _np(nearest_codes(tz, tcb)))
    if tie:
        assert not (_np(ids) == 11).any()


# -- kernels 2 and 6: attention half and whole int8 block --------------------
#
# Tolerances. Int8 boundaries (h8, y8) equal except that at most 0.1% of
# entries may differ by one: LayerNorm's mean and variance, and the
# attention's sums, are taken in another order by XLA and PyTorch, and
# an ulp of difference can carry a value across a rounding boundary.
# f32 streams (x_mid, the block output) to 1e-3, the contract of the JAX
# package's test_block_fusion_label_parity, with int8_attn too (at these
# inputs every value came out bit-equal).

T_CASES = (11, 33)     # T=11 as the JAX package's tests; 33 is ragged


def _int8_close(port, ref, frac=1e-3):
    diff = np.abs(_np(port).astype(np.int32) - np.asarray(ref).astype(
        np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= frac, (
        diff.max(), (diff != 0).mean())


@functools.cache
def _calibrated_block():
    """The JAX model, qparams and the residual stream x entering block 0,
    with the bridged port qparams."""
    jm, params = H.jax_transformer()
    ids = jnp.asarray(H.token_ids(5, seed=3))
    jqp = jax_quantize(params, act_absmax=jax_calibrate(jm, params, ids))
    x = jnp.take(jqp["tok_emb"], ids, axis=0) + jm.pe[None, :ids.shape[1]]
    return jm, jqp, x, H.port_qparams(jqp)


@pytest.mark.parametrize("full", [False, True])
def test_block_operands_match_jax(full):
    """Bit-equal to the JAX packing, and packed once into the block by
    the bridge (as quantize_transformer does) with the same values: the
    full-block rows included."""
    _, jqp, x, qp = _calibrated_block()
    ref = jbq._block_operands(x, jqp["blocks"][0], full=full)
    blk = qp["blocks"][0]
    port = fbq._block_operands(blk, full=full)
    assert (port[3] is None) == (not full) == (ref[3] is None)
    for got, r in zip(port, ref):
        if r is not None:
            np.testing.assert_array_equal(_np(got), np.asarray(r))
    for packed, r in zip(blk["block_operands"],
                         jbq._block_operands(x, jqp["blocks"][0], full=True)):
        np.testing.assert_array_equal(_np(packed), np.asarray(r))


@pytest.mark.parametrize("t", T_CASES)
@pytest.mark.parametrize("int8_attn", [False, True])
def test_fused_attn_block_quant_matches_jax(int8_attn, t):
    """Both blocks, each fed the JAX x_mid stream of the block before."""
    jm, jqp, x, qp = _calibrated_block()
    x = x[:, :t]
    for jblk, blk in zip(jqp["blocks"], qp["blocks"]):
        xm_ref, h8_ref = jbq.fused_attn_block_quant(x, jblk, n_head=jm.n_head,
                                                    int8_attn=int8_attn)
        xm, h8 = fbq.fused_attn_block_quant(torch.from_numpy(np.array(x)),
                                            blk, n_head=jm.n_head,
                                            int8_attn=int8_attn)
        assert h8.dtype == torch.int8 and xm.shape == x.shape
        _int8_close(h8, h8_ref)
        assert np.abs(_np(xm) - np.asarray(xm_ref)).max() < 1e-3
        x = xm_ref


@pytest.mark.parametrize("t", T_CASES)
@pytest.mark.parametrize("int8_attn", [False, True])
def test_fused_attn_block_quant_rail_counts_match_jax(int8_attn, t):
    """`rail_rows`, the count of each row's h8 at +-127 that #2's plain
    version takes from its own h8, as per-sample fractions against JAX's
    `_row_clip_frac_prequant` of the JAX kernel's h8 (the in-path
    monitor's site on h8), within 1e-6; both blocks, each fed the JAX
    stream. The act scales are calibrated at a quarter of the absmax,
    so that h8 reaches its rails."""
    jm, params = H.jax_transformer()
    ids = jnp.asarray(H.token_ids(5, seed=3))
    am = jax_calibrate(jm, params, ids)
    jqp = jax_quantize(params, act_absmax={k: v / 4 for k, v in am.items()})
    qp = H.port_qparams(jqp)
    x = (jnp.take(jqp["tok_emb"], ids, axis=0)
         + jm.pe[None, :ids.shape[1]])[:, :t]
    for jblk, blk in zip(jqp["blocks"], qp["blocks"]):
        xm_ref, h8_ref = jbq.fused_attn_block_quant(x, jblk, n_head=jm.n_head,
                                                    int8_attn=int8_attn)
        rails = torch.full(x.shape[:2], -1, dtype=torch.int32)
        _, h8 = fbq.fused_attn_block_quant(
            torch.from_numpy(np.array(x)), blk, n_head=jm.n_head,
            int8_attn=int8_attn, rail_rows=rails)
        assert torch.equal(rails, (h8.int().abs() == 127).sum(
            -1, dtype=torch.int32))
        want = np.asarray(jax_rail_frac(h8_ref))
        assert want.max() > 0
        np.testing.assert_allclose(_np(rails.sum(-1).float() / h8[0].numel()),
                                   want, rtol=0, atol=1e-6)
        x = xm_ref


@pytest.mark.parametrize("t", T_CASES)
@pytest.mark.parametrize("int8_attn", [False, True])
def test_fused_block_quant_matches_jax(int8_attn, t):
    """Kernel #6, both blocks chained on the JAX stream."""
    jm, jqp, x, qp = _calibrated_block()
    x = x[:, :t]
    for jblk, blk in zip(jqp["blocks"], qp["blocks"]):
        ref = jbq.fused_block_quant(x, jblk, n_head=jm.n_head,
                                    int8_attn=int8_attn)
        out = fbq.fused_block_quant(torch.from_numpy(np.array(x)), blk,
                                    n_head=jm.n_head, int8_attn=int8_attn)
        assert out.dtype == torch.float32 and out.shape == x.shape
        assert np.abs(_np(out) - np.asarray(ref)).max() < 1e-3
        x = ref


@pytest.mark.parametrize("t", T_CASES)
def test_int8_attention_core_matches_jax(rng, t):
    """The plain int8 attention core against pallas_block_quant's
    _attn_core(int8_attn=True), one batch row at a time, on a qkv drawn
    at random: the scores are exact integer sums scaled once, so only
    exp and the row sums differ by ulps."""
    qkv = rng.standard_normal((3, t, 96)).astype(np.float32)
    sm_scale = 1.0 / np.sqrt(8)
    ref = np.stack([np.asarray(jbq._attn_core(jnp.asarray(q), 4, 8, t,
                                              sm_scale, int8_attn=True))
                    for q in qkv])
    out = fattn.attention_core_reference(torch.from_numpy(qkv), 4,
                                         int8_attn=True)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-5)


# -- kernel 8: int8 MLP -------------------------------------------------------

@pytest.mark.parametrize("t", T_CASES)
def test_fused_mlp_quant_matches_jax(t):
    """The port's fused_mlp_quant (its signature is JAX's, weights in the
    port's layout) on the ln2 output of block 0. h8 is the same q8 of the
    same h and the products are exact; a g8 = q8(new_gelu(.)) value at a
    rounding boundary may flip by one (tanh differs by ulps), which moves
    the output by one m_proj weight step: 1e-3."""
    jm, jqp, x, qp = _calibrated_block()
    x = x[:, :t]
    jblk, blk = jqp["blocks"][0], qp["blocks"][0]
    h = jln(x, jblk["ln2_scale"], jblk["ln2_bias"])
    fc, mp = jblk["c_fc"], jblk["m_proj"]
    ref = jmlp.fused_mlp_quant(h, fc.w_int8, fc.scale, fc.bias, fc.act_scale,
                               mp.w_int8, mp.scale, mp.bias, mp.act_scale)
    pfc, pmp = blk["c_fc"], blk["m_proj"]
    out = fmlp.fused_mlp_quant(torch.from_numpy(np.array(h)), pfc.w_int8,
                               pfc.scale, pfc.bias, pfc.act_scale, pmp.w_int8,
                               pmp.scale, pmp.bias, pmp.act_scale)
    assert out.shape == h.shape
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-3)
    # the packed operands give the same values as the per-call packing
    scales, vc, _, v4c = blk["block_operands"]
    packed = fmlp.mlp_quant(torch.from_numpy(np.array(h)), pfc.w_int8,
                            pmp.w_int8, scales[2:], v4c, vc[6:])
    torch.testing.assert_close(packed, out, rtol=0, atol=0)


# -- kernels 10 and 11: attention with an int8 output -------------------------

@pytest.mark.parametrize("t", T_CASES)
@pytest.mark.parametrize("block_rows", [None, 8])
def test_fused_qkv_attention_quant_matches_jax(block_rows, t):
    """y8 from the ln1 output of block 0; block_rows=8 tiles JAX's
    scores by causal row blocks and changes nothing in the port."""
    jm, jqp, x, qp = _calibrated_block()
    x = x[:, :t]
    jblk, blk = jqp["blocks"][0], qp["blocks"][0]
    h = jln(x, jblk["ln1_scale"], jblk["ln1_bias"])
    ca, cp = jblk["c_attn"], jblk["c_proj"]
    ref = jattn.fused_qkv_attention_quant(
        h, ca.w_int8, ca.scale / ca.act_scale, ca.bias, ca.act_scale,
        cp.act_scale, n_head=jm.n_head, block_rows=block_rows)
    pca = blk["c_attn"]
    out = fattn.fused_qkv_attention_quant(
        torch.from_numpy(np.array(h)), pca.w_int8, pca.scale / pca.act_scale,
        pca.bias, pca.act_scale, blk["c_proj"].act_scale, n_head=jm.n_head,
        block_rows=block_rows)
    assert out.dtype == torch.int8 and out.shape == h.shape
    _int8_close(out, ref)


@pytest.mark.parametrize("t", T_CASES)
def test_fused_causal_attention_quant_matches_jax(t):
    jm, jqp, x, qp = _calibrated_block()
    x = x[:, :t]
    jblk, blk = jqp["blocks"][0], qp["blocks"][0]
    qkv = jqdot(jln(x, jblk["ln1_scale"], jblk["ln1_bias"]), jblk["c_attn"])
    ref = jattn.fused_causal_attention_quant(qkv, jblk["c_proj"].act_scale,
                                             n_head=jm.n_head)
    pqkv = qdot(layer_norm(torch.from_numpy(np.array(x)), blk["ln1_scale"],
                           blk["ln1_bias"]), blk["c_attn"])
    out = fattn.fused_causal_attention_quant(pqkv, blk["c_proj"].act_scale,
                                             n_head=jm.n_head)
    assert out.dtype == torch.int8 and out.shape == x.shape
    _int8_close(out, ref)


def test_block_rows_must_be_a_multiple_of_8():
    h = torch.zeros(1, 3, 32)
    with pytest.raises(ValueError):
        fattn.qkv_attention_quant(h, None, None, None, n_head=4, block_rows=4)
    with pytest.raises(ValueError):
        jattn.fused_qkv_attention_quant(
            jnp.zeros((1, 3, 32)), jnp.zeros((32, 96), jnp.int8),
            jnp.ones(96), jnp.zeros(96), 1.0, 1.0, n_head=4, block_rows=4)


def test_kernel2_reference_normalizes_after_pv():
    """The plain version's attention equals softmax attention (the
    division by the row sum after P@V only moves ulps)."""
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        causal_attention_core, merge_heads, split_heads)
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 9, 96)).astype(np.float32))
    q, k, v = (split_heads(z, 4) for z in qkv.split(32, dim=-1))
    s = (q @ k.transpose(-1, -2)) * (1 / np.sqrt(8))
    s = s.masked_fill(~torch.ones(9, 9, dtype=torch.bool).tril(),
                      float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    y = merge_heads((p @ v) / p.sum(-1, keepdim=True))
    torch.testing.assert_close(y, merge_heads(causal_attention_core(q, k, v)),
                               rtol=0, atol=1e-6)


# -- dispatch and sources -----------------------------------------------------

def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on the card gets no
    silent fallback."""
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError):
        fenc.fused_encoder_eval(x, torch.empty((2, 64, 64), device="meta"),
                                torch.empty((10, 64), device="meta"),
                                use_bn=False)
    w, v = (torch.empty(s, device="meta") for s in ((2, 64, 64), (10, 64)))
    cb = torch.empty((32, 16), device="meta")
    for call in (
            lambda: fenc.resblock_eval(x, w[0], w[1], v, use_bn=False),
            lambda: fenc.fused_encoder_entry_eval(
                torch.empty((4, 25), device="meta"), None, None, w, v),
            lambda: fenc.fused_encoder_exit_eval(x, w, v, None, None, cb),
            lambda: fvq.nearest_codes_pallas(
                torch.empty((4, 16), device="meta"), cb)):
        with pytest.raises(ValueError):
            call()
    meta = torch.empty((1, 3, 64), device="meta")
    for call in (
            lambda: fbq.attn_block_quant(meta, *(None,) * 5, n_head=4),
            lambda: fbq.attn_block_quant(meta, *(None,) * 5, n_head=4,
                                         int8_attn=True),
            lambda: fbq.block_quant(meta, *(None,) * 8, n_head=4),
            lambda: fmlp.mlp_quant(meta, *(None,) * 5),
            lambda: fattn.qkv_attention_quant(meta, *(None,) * 3, n_head=4),
            lambda: fattn.fused_causal_attention_quant(
                torch.empty((1, 3, 192), device="meta"), None, n_head=4)):
        with pytest.raises(ValueError):
            call()


def test_kernel_sources_call_no_library_products():
    """The kernels compute their own products: no cuBLAS, SDPA,
    torch.matmul or _int_mm inside the sources or the CUDA branch."""
    for path in sorted(kernels.SRC_DIR.glob("*.cu*")):
        src = path.read_text().lower()
        for word in ("cublas", "cudnn", "cutlass::gemm"):
            assert word not in src, (path.name, word)
    assert set(kernels.launches) == {
        "encoder_chain_f32", "encoder_chain_bf16", "resblock_f32",
        "encoder_entry_f32", "encoder_exit_f32", "nearest_codes_f32",
        "encoder_wide_f32", "encoder_wide_bf16", "encoder_wide_entry_f32",
        "encoder_wide_exit_f32", "attn_block_quant",
        "attn_block_quant_int8attn", "block_quant", "block_quant_int8attn",
        "mlp_quant", "qkv_attention_quant", "causal_attention_quant",
        "flash_attention_f32", "flash_attention_bf16", "decode_attn_f32",
        "block_decode_f32", "int8_gemm", "ln_q8"}
    for mod in (fenc, fvq, fbq, fattn, fmlp, fdec, fflash, ig):
        src = Path(mod.__file__).read_text()
        cuda_branch = src[src.index("kernels.require"):]
        for word in ("_int_mm", "matmul", "scaled_dot_product", "compile",
                     " @ "):
            assert word not in cuda_branch, (mod.__name__, word)


def test_launch_counts_untouched_on_cpu():
    """Every wrapper on CPU tensors runs its plain version and counts
    nothing."""
    kernels.reset_launch_counts()
    x = torch.zeros((3, 64))
    w, v = torch.zeros((2, 64, 64)), torch.zeros((10, 64))
    fenc.fused_encoder_eval(x, w, v, use_bn=False)
    fenc.fused_encoder_eval(x, w, v, use_bn=False,
                            compute_dtype=torch.bfloat16)
    fenc.resblock_eval(x, w[0], w[1], v, use_bn=False)
    fenc.fused_encoder_entry_eval(torch.zeros((3, 25)), torch.zeros((25, 64)),
                                  torch.zeros(64), w, v, use_bn=False)
    fenc.fused_encoder_exit_eval(x, w, v, torch.zeros((64, 16)),
                                 torch.zeros(16), torch.ones((32, 16)),
                                 use_bn=False)
    fvq.nearest_codes_pallas(torch.zeros((3, 16)), torch.ones((32, 16)))
    vq = H.port_vqvae(False, vq_impl="pallas")
    cycles = torch.zeros((2, 200, 2))
    with torch.no_grad():
        vq.encode_indices(cycles)
        fenc.encode_indices_fused_edges(vq, fenc.pack_encoder(vq),
                                        fenc.pack_encoder_edges(vq), cycles,
                                        group_size=1)
    blk = _calibrated_block()[3]["blocks"][0]
    xs = torch.zeros((1, 5, 32))
    for int8_attn in (False, True):
        fbq.fused_attn_block_quant(xs, blk, n_head=4, int8_attn=int8_attn)
        fbq.fused_block_quant(xs, blk, n_head=4, int8_attn=int8_attn)
    scales, vc, v3c, v4c = blk["block_operands"]
    fmlp.mlp_quant(xs, blk["c_fc"].w_int8, blk["m_proj"].w_int8, scales[2:],
                   v4c, vc[6:])
    fattn.qkv_attention_quant(xs, blk["c_attn"].w_int8, scales[:2], v3c,
                              n_head=4)
    fattn.fused_causal_attention_quant(torch.zeros((1, 5, 96)), scales[1],
                                       n_head=4)
    tr = H.port_transformer()
    hd = tr.d_model // tr.n_head
    tok = torch.zeros((2, 1, tr.d_model))
    fdec.fused_decode_attn(tok, tr.blocks[0],
                           torch.zeros((2, tr.n_head, 8, hd)),
                           torch.zeros((2, tr.n_head, 8, hd)), 3,
                           n_head=tr.n_head)
    fdec.fused_block_decode(tok, tr.blocks[0], torch.zeros((2, 8, tr.d_model)),
                            torch.zeros((2, 8, tr.d_model)), 3,
                            n_head=tr.n_head)
    fflash.flash_causal_attention(*torch.zeros((3, 1, 2, 5, 8)))
    assert set(kernels.launches.values()) == {0}
