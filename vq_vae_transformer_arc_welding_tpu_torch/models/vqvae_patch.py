"""Encoder half of the patch VQ-VAE, eval mode.

Port of vq_vae_transformer_arc_welding_tpu/models/vqvae_patch.py
(`VQVAEPatch`: hparams, encoder parameters, `encode`,
`encode_indices`). Attribute paths are the reference Lightning keys
that vq_vae_transformer_arc_welding_tpu/train/torch_import.py reads:
`patch_embed.proj.*`, `encoder.0.shared_conv.{i}.block.{1,2,4,5}.*`,
`encoder.1.shared_conv.*` and `vector_quantization.embedding.weight`.
The decoder, training forward and losses are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.activations import gelu
from ..ops.conv import center_tap_dense
from ..ops.norm import batch_norm_apply
from ..ops.patching import patch_embed
from ..ops.vq import nearest_codes
from .base import BatchNormParams, Node, Params, assign
from .initializers import uniform, xavier_conv1d


class ResBlock(nn.Module):
    """GELU-conv-[BN]-GELU-conv-[BN] + residual (reference CNNBlock
    seperate=True resblock); `block` indices are the reference's."""

    def __init__(self, ch: int, batch_norm: bool, device=None):
        super().__init__()
        norm = ((lambda: BatchNormParams(ch, device)) if batch_norm
                else nn.Identity)
        self.batch_norm = batch_norm
        self.block = nn.Sequential(
            nn.GELU(), Params(device, weight=(ch, ch, 3), bias=(ch,)), norm(),
            nn.GELU(), Params(device, weight=(ch, ch, 3), bias=(ch,)), norm())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, bn1, conv2, bn2 = (self.block[i] for i in (1, 2, 4, 5))
        h = center_tap_dense(gelu(x), conv1.weight, conv1.bias)
        if self.batch_norm:
            h = batch_norm_apply(h, bn1.weight, bn1.bias, bn1.running_mean,
                                 bn1.running_var)
        h = center_tap_dense(gelu(h), conv2.weight, conv2.bias)
        if self.batch_norm:
            h = batch_norm_apply(h, bn2.weight, bn2.bias, bn2.running_mean,
                                 bn2.running_var)
        return x + h


class VQVAEPatch(nn.Module):
    """hparams mirror the JAX VQVAEPatch constructor; the classic VQ
    (codebook in `vector_quantization.embedding.weight`) only."""

    def __init__(self, hidden_dim: int, input_dim: int, num_embeddings: int,
                 embedding_dim: int, n_resblocks: int,
                 learning_rate: float = 1e-3, dropout_p: float = 0.1,
                 patch_size: int = 25, seq_len: int = 200,
                 batch_norm: bool = True, beta: float = 0.25, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if (seq_len * input_dim) % patch_size:
            raise ValueError(f"patch_size {patch_size} does not divide "
                             f"{seq_len} x {input_dim} samples")
        self.hidden_dim = hidden_dim
        self.input_dim = input_dim
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.n_resblocks = n_resblocks
        self.patch_size = patch_size
        self.seq_len = seq_len
        self.batch_norm = batch_norm
        # tokens per cycle: 200 // 25 * 2 = 16
        self.enc_out_len = seq_len // patch_size * input_dim
        self.hparams = dict(
            hidden_dim=hidden_dim, input_dim=input_dim,
            num_embeddings=num_embeddings, embedding_dim=embedding_dim,
            n_resblocks=n_resblocks, learning_rate=learning_rate,
            dropout_p=dropout_p, patch_size=patch_size, seq_len=seq_len,
            batch_norm=batch_norm, beta=beta)

        h, d = hidden_dim, embedding_dim
        self.patch_embed = Node(proj=Params(
            device, weight=(h, 1, patch_size), bias=(h,)))
        self.encoder = nn.Sequential(
            Node(shared_conv=nn.ModuleList(
                ResBlock(h, batch_norm, device) for _ in range(n_resblocks))),
            Node(shared_conv=Params(device, weight=(d, h, 1), bias=(d,))))
        self.vector_quantization = Node(embedding=Params(
            device, weight=(num_embeddings, d)))
        if generator is not None:
            self.init_weights(generator)

    @property
    def resblocks(self) -> nn.ModuleList:
        return self.encoder[0].shared_conv

    @property
    def codebook(self) -> torch.Tensor:
        return self.vector_quantization.embedding.weight

    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's init distributions: xavier-uniform convs with
        zero bias, U(-1/K, 1/K) codebook (reference vector_quantizer.py:74)."""
        h, d = self.hidden_dim, self.embedding_dim
        pe = self.patch_embed.proj
        w, b = xavier_conv1d(gen, h, 1, self.patch_size)
        assign(pe.weight, w), assign(pe.bias, b)
        for blk in self.resblocks:
            for conv in (blk.block[1], blk.block[4]):
                w, b = xavier_conv1d(gen, h, h, 3)
                assign(conv.weight, w), assign(conv.bias, b)
        sep = self.encoder[1].shared_conv
        w, b = xavier_conv1d(gen, d, h, 1)
        assign(sep.weight, w), assign(sep.bias, b)
        assign(self.codebook, uniform(gen, (self.num_embeddings, d),
                                      1.0 / self.num_embeddings))

    def patch_embed_out(self, x: torch.Tensor) -> torch.Tensor:
        """(B, seq_len, input_dim) -> (B, n_patches, hidden)."""
        pe = self.patch_embed.proj
        return patch_embed(x, pe.weight[:, 0, :].t(), pe.bias,
                           self.patch_size)

    def sep_conv(self, h: torch.Tensor) -> torch.Tensor:
        """(B, n_patches, hidden) -> z_e (B, n_patches, embedding_dim)."""
        sep = self.encoder[1].shared_conv
        return center_tap_dense(h, sep.weight, sep.bias)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, seq_len, input_dim) -> z_e (B, enc_out_len, embedding_dim)."""
        h = self.patch_embed_out(x)
        for blk in self.resblocks:
            h = blk(h)
        return self.sep_conv(h)

    def nearest(self, z_e: torch.Tensor) -> torch.Tensor:
        """z_e (B, P, D) -> (B, P) int32 codebook ids."""
        flat = z_e.reshape(-1, self.embedding_dim)
        return nearest_codes(flat, self.codebook).reshape(z_e.shape[:-1])

    def encode_indices(self, x: torch.Tensor) -> torch.Tensor:
        """Frozen-encoder token ids (B, enc_out_len), int32."""
        return self.nearest(self.encode(x))
