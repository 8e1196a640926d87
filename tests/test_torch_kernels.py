"""The port's two kernel modules against the JAX package's Pallas kernels.

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
from vq_vae_transformer_arc_welding_tpu.ops import (
    pallas_block_quant as jbq, pallas_encoder as jenc)
from vq_vae_transformer_arc_welding_tpu_torch import bridge, kernels
from vq_vae_transformer_arc_welding_tpu_torch.ops import (
    fused_block_quant as fbq, fused_encoder as fenc)

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


# -- kernel 2: attention half of an int8 block --------------------------------

@functools.cache
def _calibrated_block():
    """The JAX block-0 qparams and a matching residual stream x."""
    jm, params = H.jax_transformer()
    ids = jnp.asarray(H.token_ids(5, seed=3))
    jqp = jax_quantize(params, act_absmax=jax_calibrate(jm, params, ids))
    x = jnp.take(jqp["tok_emb"], ids, axis=0) + jm.pe[None, :ids.shape[1]]
    return jm, jqp, x


def test_block_operands_match_jax():
    """Bit-equal to the JAX packing, and packed once into the block by
    the bridge (as quantize_transformer does) with the same values."""
    _, jqp, x = _calibrated_block()
    ref = jbq._block_operands(x, jqp["blocks"][0], full=False)[:3]
    blk = bridge.qparams_from_jax(jqp)["blocks"][0]
    for port, packed, r in zip(fbq._block_operands(blk),
                               blk["attn_operands"], ref):
        np.testing.assert_array_equal(_np(port), np.asarray(r))
        np.testing.assert_array_equal(_np(packed), np.asarray(r))


def test_fused_attn_block_quant_matches_jax():
    """h8 equal except that at most 0.1% of entries may differ by one:
    LayerNorm's mean and variance are sums taken in another order by
    XLA and PyTorch, and an ulp of difference can carry a value across
    a rounding boundary. x_mid to 1e-3, the contract of the JAX
    package's test_block_fusion_label_parity."""
    jm, jqp, x = _calibrated_block()
    qp = bridge.qparams_from_jax(jqp)
    for jblk, blk in zip(jqp["blocks"], qp["blocks"]):
        xm_ref, h8_ref = jbq.fused_attn_block_quant(x, jblk, n_head=jm.n_head)
        xm, h8 = fbq.fused_attn_block_quant(torch.from_numpy(np.array(x)),
                                            blk, n_head=jm.n_head)
        assert h8.dtype == torch.int8 and xm.shape == x.shape
        diff = np.abs(_np(h8).astype(np.int32)
                      - np.asarray(h8_ref).astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
        assert np.abs(_np(xm) - np.asarray(xm_ref)).max() < 1e-3
        x = xm_ref


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
    with pytest.raises(ValueError):
        fbq.attn_block_quant(torch.empty((1, 3, 64), device="meta"),
                             *(None,) * 5, n_head=4)


def test_kernel_sources_call_no_library_products():
    """The kernels compute their own products: no cuBLAS, SDPA,
    torch.matmul or _int_mm inside the sources or the CUDA branch."""
    for path in sorted(kernels.SRC_DIR.glob("*.cu*")):
        src = path.read_text().lower()
        for word in ("cublas", "cudnn", "cutlass::gemm"):
            assert word not in src, (path.name, word)
    assert set(kernels.launches) == {"encoder_chain_f32", "attn_block_quant"}
    for mod in (fenc, fbq):
        src = Path(mod.__file__).read_text()
        cuda_branch = src[src.index("kernels.require"):]
        for word in ("_int_mm", "matmul", "scaled_dot_product", "compile",
                     " @ "):
            assert word not in cuda_branch, (mod.__name__, word)


def test_launch_counts_untouched_on_cpu():
    kernels.reset_launch_counts()
    x = torch.zeros((3, 64))
    fenc.fused_encoder_eval(x, torch.zeros((2, 64, 64)), torch.zeros((10, 64)),
                            use_bn=False)
    assert kernels.launches == {"encoder_chain_f32": 0, "attn_block_quant": 0}
