"""Shared setup of the PyTorch-port tests (tests/test_torch_*.py).

One small configuration is built in the JAX package from a seed and
bridged into the port, so both run on identical weights: hidden 64,
2 resblocks, K=32, D=16; transformer d32, 2 blocks, 4 heads, 2 cycles
(33 tokens). Inputs are made with numpy and handed to both. The bridge
builds on the card by default; these tests ask for the CPU in words.
"""
from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models import (TransformerDecoder,
                                                       VQVAEPatch)
from vq_vae_transformer_arc_welding_tpu.ops.norm import BatchNormState
from vq_vae_transformer_arc_welding_tpu_torch import bridge

N_CYCLES = 2
K = 32
SEQ_LEN = N_CYCLES * 16 + 1


@functools.cache
def jax_vqvae(batch_norm: bool):
    """(model, params, state); with BatchNorm, the eval statistics and
    affine parameters are drawn at random so that BN is not identity."""
    vq = VQVAEPatch(hidden_dim=64, input_dim=2, num_embeddings=K,
                    embedding_dim=16, n_resblocks=2, learning_rate=1e-3,
                    batch_norm=batch_norm)
    params, state = vq.init(0)
    if batch_norm:
        rng = np.random.default_rng(7)

        def r(lo, hi):
            return jnp.asarray(rng.uniform(lo, hi, 64), jnp.float32)

        for blk in params["encoder"]:
            for n in ("1", "2"):
                blk[f"bn{n}_scale"] = r(0.5, 1.5)
                blk[f"bn{n}_bias"] = r(-0.2, 0.2)
        state["encoder_bn"] = [
            {n: BatchNormState(r(-0.3, 0.3), r(0.5, 2.0))
             for n in ("bn1", "bn2")} for _ in params["encoder"]]
    return vq, params, state


@functools.cache
def jax_transformer():
    tr = TransformerDecoder(d_model=32, n_classes=K + 2, seq_len=SEQ_LEN,
                            n_blocks=2, n_head=4)
    params, _ = tr.init(0)
    return tr, params


def port_vqvae(batch_norm: bool, vq_impl: str = "xla"):
    vq, params, state = jax_vqvae(batch_norm)
    return bridge.vqvae_from_jax(vq.hparams, params, state, device="cpu",
                                 vq_impl=vq_impl)


def port_transformer():
    tr, params = jax_transformer()
    return bridge.transformer_from_jax(tr.hparams, params, device="cpu")


def port_qparams(jax_qparams) -> dict:
    """JAX quantize_transformer output -> the port's qparams, on the CPU."""
    return bridge.qparams_from_jax(jax_qparams, device="cpu")


def port_qenc(jax_qenc) -> dict:
    """JAX quantize_encoder output -> the port's qenc, on the CPU."""
    return bridge.qenc_from_jax(jax_qenc, device="cpu")


def windows(n: int, seed: int = 0) -> np.ndarray:
    """(n, N_CYCLES*200, 2) f32 welding windows."""
    return np.random.default_rng(seed).standard_normal(
        (n, N_CYCLES * 200, 2)).astype(np.float32)


def token_ids(n: int, seed: int = 0) -> np.ndarray:
    """(n, SEQ_LEN) ids: the start token K, then codes below K."""
    ids = np.random.default_rng(seed).integers(0, K, (n, SEQ_LEN))
    ids[:, 0] = K
    return ids.astype(np.int32)
