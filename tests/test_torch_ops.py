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
                                                    patching as jpatch,
                                                    vq as jvq)
from vq_vae_transformer_arc_welding_tpu_torch.models import initializers
from vq_vae_transformer_arc_welding_tpu_torch.models.transformer import (
    sinusoidal_pe)
from vq_vae_transformer_arc_welding_tpu_torch.ops import (activations,
                                                          attention, conv,
                                                          norm, patching, vq)

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
