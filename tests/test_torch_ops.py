"""Port ops and f32 models against the JAX package, on the CPU.

Each op of vq_vae_transformer_arc_welding_tpu_torch/ops and the f32
models get the same numpy inputs as their JAX counterparts. Tolerance
1e-5 absolute for f32 values (the two libraries sum in other orders
and compute erf/tanh by other formulas, a few ulps apart); codebook
ids must be equal.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models.transformer import (
    sinusoidal_pe as jax_pe)
from vq_vae_transformer_arc_welding_tpu.ops import (activations as jact,
                                                    attention as jatt,
                                                    conv as jconv,
                                                    norm as jnorm,
                                                    pallas_block_quant as jbq,
                                                    patching as jpatch,
                                                    vq as jvq)
from vq_vae_transformer_arc_welding_tpu_torch.models import initializers
from vq_vae_transformer_arc_welding_tpu_torch.models.transformer import (
    sinusoidal_pe)
from vq_vae_transformer_arc_welding_tpu_torch.ops import (activations,
                                                          attention, conv,
                                                          norm, patching, vq)
from vq_vae_transformer_arc_welding_tpu_torch.ops.int8 import quantize_act

import torch_port_helpers as H

ATOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy()


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["gelu", "new_gelu"])
def test_activation_matches_jax(rng, name):
    x = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    _close(getattr(activations, name)(torch.from_numpy(x)),
           getattr(jact, name)(jnp.asarray(x)))


@pytest.mark.parametrize("side", ["port", "jax"])
def test_new_gelu_each_side_within_f32_of_exact(side):
    """Each library's new_gelu against the formula in float64, at the
    comparison test's input and at 260k wider ones. Measured: at most
    4.3e-7 (port) and 8.1e-7 (JAX); the two sides within 9.6e-7 of
    each other. Bound 2e-6. One full tier-1 run of PR 1 saw the two
    sides 1.7e-4 apart on 28% of entries; 12 runs of the tier-1 command
    and 90 concurrent runs of this file did not reproduce it, and no
    test or module changes jax config, XLA flags, torch dtype or
    threads. If it recurs, this test names the side that moved."""
    fn = (lambda x: activations.new_gelu(torch.from_numpy(x)).numpy()) \
        if side == "port" else (lambda x: np.asarray(jact.new_gelu(
            jnp.asarray(x))))
    for seed, scale, shape in ((0, 3, (64, 33)), (1, 3, (4096, 64)),
                               (2, 8, (4096, 64))):
        x = (np.random.default_rng(seed).standard_normal(shape)
             * scale).astype(np.float32)
        xd = x.astype(np.float64)
        exact = 0.5 * xd * (1 + np.tanh(math.sqrt(2 / math.pi)
                                        * (xd + 0.044715 * xd ** 3)))
        np.testing.assert_allclose(fn(x).astype(np.float64), exact, rtol=0,
                                   atol=2e-6)


@pytest.mark.parametrize("scale", [8.0, 30.0, 127.0 / 3.3])
def test_gelu_q8_epilogue_matches_jax(rng, scale):
    """The c_fc epilogue of the int8 MLP kernels (#6, #8) in its plain
    version, tanh GELU then q8, against the Pallas kernels'
    _q8(_new_gelu(.)), bit for bit: mid values as the int8 product's
    dequant + bias gives them, 8,320 of them."""
    acc = rng.integers(-60000, 60000, (64, 130)).astype(np.float32)
    deq = (rng.uniform(0.5, 2.0, 130) * 3e-5).astype(np.float32)
    bias = (rng.standard_normal(130) * 0.1).astype(np.float32)
    mid = acc * deq + bias
    s = np.float32(scale)
    port = quantize_act(activations.new_gelu(torch.from_numpy(mid)),
                        torch.tensor(s))
    ref = jbq._q8(jact.new_gelu(jnp.asarray(mid)), s)
    assert port.dtype == torch.int8
    np.testing.assert_array_equal(_np(port), np.asarray(ref))


def test_layer_norm_matches_jax(rng):
    x = rng.standard_normal((4, 33, 32)).astype(np.float32) * 2 + 0.5
    s = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    _close(norm.layer_norm(*map(torch.from_numpy, (x, s, b))),
           jnorm.layer_norm(*map(jnp.asarray, (x, s, b))))


def test_batch_norm_eval_matches_jax(rng):
    x, s, b, m = (rng.standard_normal((3, 16, 64)).astype(np.float32),
                  *(rng.standard_normal(64).astype(np.float32)
                    for _ in range(3)))
    v = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    ref, _ = jnorm.batch_norm_apply(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
        jnorm.BatchNormState(jnp.asarray(m), jnp.asarray(v)), train=False)
    _close(norm.batch_norm_apply(*map(torch.from_numpy, (x, s, b, m, v))),
           ref)


def test_patchify_and_patch_embed_match_jax(rng):
    x = rng.standard_normal((3, 200, 2)).astype(np.float32)
    k = rng.standard_normal((25, 64)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_array_equal(
        _np(patching.patchify(torch.from_numpy(x), 25)),
        np.asarray(jpatch.patchify(jnp.asarray(x), 25)))
    _close(patching.patch_embed(*map(torch.from_numpy, (x, k, b)), 25),
           jpatch.patch_embed(*map(jnp.asarray, (x, k, b)), 25))


def test_center_tap_dense_matches_jax(rng):
    x = rng.standard_normal((3, 16, 64)).astype(np.float32)
    w = rng.standard_normal((32, 64, 3)).astype(np.float32) * 0.1
    b = rng.standard_normal(32).astype(np.float32)
    _close(conv.center_tap_dense(*map(torch.from_numpy, (x, w, b))),
           jconv.center_tap_dense(*map(jnp.asarray, (x, w, b))))


def test_nearest_codes_matches_jax(rng):
    z = rng.standard_normal((500, 16)).astype(np.float32)
    cb = rng.standard_normal((32, 16)).astype(np.float32)
    ids = vq.nearest_codes(torch.from_numpy(z), torch.from_numpy(cb))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(ids), np.asarray(jvq.nearest_codes(jnp.asarray(z),
                                               jnp.asarray(cb))))


def test_nearest_codes_tie_takes_first_index(rng):
    """Codes 3, 7 and 12 are the same vector, the nearest to every z:
    both packages must return 3, the first index among the ties."""
    cb = rng.standard_normal((16, 8)).astype(np.float32) * 10
    cb[[3, 7, 12]] = 0.25
    z = np.full((6, 8), 0.25, np.float32) + rng.uniform(
        -1e-3, 1e-3, (6, 8)).astype(np.float32)
    port = _np(vq.nearest_codes(torch.from_numpy(z), torch.from_numpy(cb)))
    ref = np.asarray(jvq.nearest_codes(jnp.asarray(z), jnp.asarray(cb)))
    np.testing.assert_array_equal(port, np.full(6, 3))
    np.testing.assert_array_equal(port, ref)


def test_vq_lookup_matches_jax(rng):
    cb = rng.standard_normal((32, 16)).astype(np.float32)
    idx = rng.integers(0, 32, (4, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(vq.vq_lookup(torch.from_numpy(idx), torch.from_numpy(cb))),
        np.asarray(jvq.vq_lookup(jnp.asarray(idx), jnp.asarray(cb))))


def test_split_merge_heads_match_jax(rng):
    x = rng.standard_normal((2, 33, 32)).astype(np.float32)
    heads = attention.split_heads(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        _np(heads), np.asarray(jatt.split_heads(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(_np(attention.merge_heads(heads)), x)


def test_causal_attention_core_matches_jax(rng):
    q, k, v = (rng.standard_normal((2, 4, 33, 8)).astype(np.float32)
               for _ in range(3))
    _close(attention.causal_attention_core(*map(torch.from_numpy, (q, k, v))),
           jatt.causal_attention_core(*map(jnp.asarray, (q, k, v))))


def test_sinusoidal_pe_matches_jax():
    np.testing.assert_array_equal(sinusoidal_pe(512, 32), jax_pe(512, 32))


@pytest.mark.parametrize("kind", ["uniform", "xavier_conv1d", "gpt2_linear",
                                  "gpt2_embedding"])
def test_initializer_distributions(kind):
    """Same distributions as the JAX initializers (the bits differ):
    bounds of the uniform ones, mean and std of the normal ones."""
    gen = torch.Generator().manual_seed(0)
    if kind == "uniform":
        w, bound = initializers.uniform(gen, (256, 32), 1 / 256), 1 / 256
    elif kind == "xavier_conv1d":
        w, b = initializers.xavier_conv1d(gen, 64, 64, 3)
        bound = math.sqrt(6.0 / (64 * 3 + 64 * 3))
        assert w.shape == (64, 64, 3) and not b.any()
    elif kind == "gpt2_linear":
        w, b = initializers.gpt2_linear(gen, 128, 384)
        assert w.shape == (384, 128) and not b.any()
    else:
        w = initializers.gpt2_embedding(gen, 258, 64)
        assert w.shape == (258, 64)
    if kind in ("uniform", "xavier_conv1d"):
        assert w.abs().max() <= bound and w.abs().max() > 0.95 * bound
        assert abs(float(w.std()) - bound / math.sqrt(3)) < 0.05 * bound
    else:
        assert abs(float(w.mean())) < 2e-3
        assert abs(float(w.std()) - 0.02) < 1e-3


@pytest.mark.parametrize("batch_norm", [False, True])
def test_vqvae_encode_matches_jax(batch_norm):
    """z_e to 1e-5 and the codebook ids equal, through the bridge."""
    jm, params, state = H.jax_vqvae(batch_norm)
    port = H.port_vqvae(batch_norm)
    x = H.windows(6)[:, :200]
    z_ref, _ = jm.encode(params, state, jnp.asarray(x))
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x))
        ids = port.encode_indices(torch.from_numpy(x))
    _close(z, z_ref)
    np.testing.assert_array_equal(
        _np(ids), np.asarray(jm.encode_indices(params, state,
                                               jnp.asarray(x))))


def test_vq_impl_pallas_matches_xla_model():
    """The runtime option: ids equal the 'xla' model's and JAX's
    vq_impl='pallas' model's, hparams unchanged, as the JAX package's
    test_model_with_pallas_vq_matches_xla_model; the nearest-code search
    goes through ops/fused_vq.py."""
    from vq_vae_transformer_arc_welding_tpu.models import VQVAEPatch as JVQ
    from vq_vae_transformer_arc_welding_tpu_torch.ops import fused_vq
    jm, params, state = H.jax_vqvae(False)
    jp = JVQ(**jm.hparams, vq_impl="pallas")
    m_x, m_p = H.port_vqvae(False), H.port_vqvae(False, vq_impl="pallas")
    assert m_p.hparams == m_x.hparams and "vq_impl" not in m_p.hparams
    assert m_p._nearest_fn() is fused_vq.nearest_codes_pallas
    assert m_x._nearest_fn() is vq.nearest_codes
    x = H.windows(6, seed=3)[:, :200]
    with torch.no_grad():
        ids_x = m_x.encode_indices(torch.from_numpy(x))
        ids_p = m_p.encode_indices(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(ids_p), _np(ids_x))
    np.testing.assert_array_equal(
        _np(ids_p), np.asarray(jp.encode_indices(params, state,
                                                 jnp.asarray(x))))
    with pytest.raises(ValueError):
        H.port_vqvae(False, vq_impl="triton")


@pytest.mark.parametrize("vq_impl", ["xla", "pallas"])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_encode_zq_and_forward_ood_match_jax(batch_norm, vq_impl):
    """z_q (B, 16, D) and the per-cycle OOD score, the mean over (P, D)
    of (z_q - z_e)^2, to 1e-5."""
    jm, params, state = H.jax_vqvae(batch_norm)
    port = H.port_vqvae(batch_norm, vq_impl=vq_impl)
    x = H.windows(6, seed=4)[:, :200]
    with torch.no_grad():
        zq = port.encode_zq(torch.from_numpy(x))
        ood = port.forward_ood(torch.from_numpy(x))
    assert zq.shape == (6, 16, 16) and ood.shape == (6,)
    _close(zq, jm.encode_zq(params, state, jnp.asarray(x)))
    _close(ood, jm.forward_ood(params, state, jnp.asarray(x)))
    assert float(ood.min()) > 0


def test_port_state_dict_uses_reference_keys():
    """The keys vq_vae_transformer_arc_welding_tpu/train/torch_import.py
    reads from a reference Lightning checkpoint."""
    keys = set(H.port_vqvae(True).state_dict())
    for k in ("patch_embed.proj.weight", "encoder.0.shared_conv.1.block.1.bias",
              "encoder.0.shared_conv.0.block.2.running_var",
              "encoder.0.shared_conv.0.block.5.weight",
              "encoder.1.shared_conv.weight",
              "vector_quantization.embedding.weight"):
        assert k in keys, k
    keys = set(H.port_transformer().state_dict())
    for k in ("embedding.latent_embedding.weight",
              "transformer.h.1.attn.c_attn.weight",
              "transformer.h.0.mlp.c_proj.bias", "transformer.ln_f.weight",
              "lm_head.weight", "class_head.linear_2.weight"):
        assert k in keys, k


@pytest.mark.parametrize("generate", [False, True])
def test_transformer_matches_jax(generate):
    jm, params = H.jax_transformer()
    port = H.port_transformer()
    ids = H.token_ids(3)
    ref, _ = jm.apply(params, None, jnp.asarray(ids), generate=generate)
    with torch.no_grad():
        out = port.apply(torch.from_numpy(ids), generate=generate)
    _close(out, ref)
