"""The patch VQ-VAE: encoder, classic VQ, decoder, and its training forward.

Port of vq_vae_transformer_arc_welding_tpu/models/vqvae_patch.py
(`VQVAEPatch`: hparams, every parameter and its init, `encode`,
`quantize`, `decode`, `apply`, `loss_fn`, `encode_indices`,
`encode_zq`, `forward_ood`, the `vq_impl` runtime option, and `save` / `load` through train/checkpoint.py). Attribute
paths are the reference Lightning keys that
vq_vae_transformer_arc_welding_tpu/train/torch_import.py reads:
`patch_embed.proj.*`, `encoder.0.shared_conv.{i}.block.{1,2,4,5}.*`,
`encoder.1.shared_conv.*`, `vector_quantization.embedding.weight`,
`decoder.0.*` (the decoder's input conv), `decoder.1.shared_conv.*` (its
resblocks) and `reverse_patch_embed.proj.{0,1,3}.*` (the inverse patch
embedding with its BatchNorm).

The training forward (`apply(train=True)`) normalizes every BatchNorm
by the batch and returns the new running statistics instead of writing
them: `apply` stays a function of its inputs, as in the JAX package,
and `commit_state` writes what it returned. Dropout is drawn from the
caller's torch.Generator, resblock by resblock.

The EMA (improved) VQ is not ported: `use_improved_vq=True` raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.activations import gelu
from ..ops.conv import center_tap_dense, conv1d_same
from ..ops.norm import batch_norm_apply, batch_norm_train
from ..ops.patching import (INVERSE_PATCH_PLANS, patch_embed,
                            patch_embed_inverse)
from ..ops.vq import VQOutput, nearest_codes, vq_lookup, vq_quantize
from ..utils.random import dropout
from .base import BatchNormParams, Checkpointed, Node, Params, assign
from .initializers import uniform, xavier_conv1d, xavier_conv_transpose1d


class VQVAEOut(NamedTuple):
    embedding_loss: torch.Tensor
    x_hat: torch.Tensor
    perplexity: torch.Tensor


def _bn_state(bn: BatchNormParams, prefix: str, mean, var) -> dict:
    """A BatchNorm's new running state under its state_dict keys, with
    the batch count BatchNorm1d keeps beside it."""
    return {f"{prefix}.running_mean": mean, f"{prefix}.running_var": var,
            f"{prefix}.num_batches_tracked": bn.num_batches_tracked + 1}


class ResBlock(nn.Module):
    """GELU-conv-[BN]-GELU-conv-[BN]-dropout + residual (reference
    CNNBlock resblock); `block` indices are the reference's."""

    def __init__(self, ch: int, batch_norm: bool, device=None):
        super().__init__()
        norm = ((lambda: BatchNormParams(ch, device)) if batch_norm
                else nn.Identity)
        self.batch_norm = batch_norm
        self.block = nn.Sequential(
            nn.GELU(), Params(device, weight=(ch, ch, 3), bias=(ch,)), norm(),
            nn.GELU(), Params(device, weight=(ch, ch, 3), bias=(ch,)), norm())

    def run(self, x: torch.Tensor, conv_fn, *, train: bool = False,
            dropout_p: float = 0.0, generator=None, prefix: str = "block"):
        """(x + the block's output, the new BN state under
        `{prefix}.{index}.*` keys, empty in eval). conv_fn(x, w, b): the
        encoder's center-tap dense or the decoder's k=3 conv."""
        h = x
        new = {}
        for conv, bn_idx in ((1, 2), (4, 5)):
            p = self.block[conv]
            h = conv_fn(gelu(h), p.weight, p.bias)
            if self.batch_norm:
                bn = self.block[bn_idx]
                if train:
                    h, (mean, var) = batch_norm_train(
                        h, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var)
                    new.update(_bn_state(bn, f"{prefix}.{bn_idx}", mean, var))
                else:
                    h = batch_norm_apply(h, bn.weight, bn.bias,
                                         bn.running_mean, bn.running_var)
        return x + dropout(h, dropout_p, train, generator), new


class VQVAEPatch(Checkpointed, nn.Module):
    """hparams mirror the JAX VQVAEPatch constructor; the classic VQ
    (codebook in `vector_quantization.embedding.weight`) only.

    vq_impl is a runtime option, not an hparam: 'xla' (the name is the
    JAX package's) searches the nearest code in plain PyTorch
    (ops/vq.nearest_codes); 'pallas' (again the JAX name) runs the fused
    nearest-code kernel, CUDA on the card (ops/fused_vq.py), in the
    serving paths and in the training forward alike. The JAX package's
    conv_impl has no counterpart: the decoder's k=3 conv is always one
    matmul (ops/conv.conv1d_same)."""

    def __init__(self, hidden_dim: int, input_dim: int, num_embeddings: int,
                 embedding_dim: int, n_resblocks: int,
                 learning_rate: float = 1e-3, dropout_p: float = 0.1,
                 patch_size: int = 25, seq_len: int = 200,
                 batch_norm: bool = True, beta: float = 0.25,
                 use_improved_vq: bool = False, *,
                 vq_impl: str = "xla",
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if use_improved_vq:
            raise NotImplementedError(
                "use_improved_vq=True: the EMA (improved) VQ of "
                "ops/vq_ema.py is not ported yet (ROADMAP.md, queue 1 "
                "item 3)")
        if vq_impl not in ("xla", "pallas"):
            raise ValueError(f"vq_impl {vq_impl!r}: 'xla' or 'pallas'")
        if patch_size not in INVERSE_PATCH_PLANS:
            raise NotImplementedError(f"Patch size not implemented: "
                                      f"{patch_size}")
        if (seq_len * input_dim) % patch_size:
            raise ValueError(f"patch_size {patch_size} does not divide "
                             f"{seq_len} x {input_dim} samples")
        self.hidden_dim = hidden_dim
        self.input_dim = input_dim
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.n_resblocks = n_resblocks
        self.learning_rate = learning_rate
        self.dropout_p = dropout_p
        self.patch_size = patch_size
        self.seq_len = seq_len
        self.batch_norm = batch_norm
        self.beta = beta
        self.vq_impl = vq_impl
        # tokens per cycle: 200 // 25 * 2 = 16
        self.enc_out_len = seq_len // patch_size * input_dim
        self.hparams = dict(
            hidden_dim=hidden_dim, input_dim=input_dim,
            num_embeddings=num_embeddings, embedding_dim=embedding_dim,
            n_resblocks=n_resblocks, learning_rate=learning_rate,
            dropout_p=dropout_p, patch_size=patch_size, seq_len=seq_len,
            batch_norm=batch_norm, beta=beta)

        h, d = hidden_dim, embedding_dim
        k1, k2 = INVERSE_PATCH_PLANS[patch_size]

        def blocks():
            return nn.ModuleList(ResBlock(h, batch_norm, device)
                                 for _ in range(n_resblocks))

        self.patch_embed = Node(proj=Params(
            device, weight=(h, 1, patch_size), bias=(h,)))
        self.encoder = nn.Sequential(
            Node(shared_conv=blocks()),
            Node(shared_conv=Params(device, weight=(d, h, 1), bias=(d,))))
        self.vector_quantization = Node(embedding=Params(
            device, weight=(num_embeddings, d)))
        self.decoder = nn.Sequential(
            Params(device, weight=(h, d, 1), bias=(h,)),
            Node(shared_conv=blocks()))
        self.reverse_patch_embed = Node(proj=nn.Sequential(
            Params(device, weight=(h, h, k1), bias=(h,)),
            BatchNormParams(h, device), nn.GELU(),
            Params(device, weight=(h, 1, k2), bias=(1,))))
        if generator is not None:
            self.init_weights(generator)

    @property
    def resblocks(self) -> nn.ModuleList:
        return self.encoder[0].shared_conv

    @property
    def decoder_resblocks(self) -> nn.ModuleList:
        return self.decoder[1].shared_conv

    @property
    def codebook(self) -> torch.Tensor:
        return self.vector_quantization.embedding.weight

    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's init distributions, in its order: xavier-
        uniform convs and transposed convs with zero bias, U(-1/K, 1/K)
        codebook (reference vector_quantizer.py:74); BatchNorms stay at
        unit scale and zero shift."""
        h, d = self.hidden_dim, self.embedding_dim

        def put(p, w_b):
            assign(p.weight, w_b[0]), assign(p.bias, w_b[1])

        put(self.patch_embed.proj, xavier_conv1d(gen, h, 1, self.patch_size))
        for blk in self.resblocks:
            for conv in (blk.block[1], blk.block[4]):
                put(conv, xavier_conv1d(gen, h, h, 3))
        put(self.encoder[1].shared_conv, xavier_conv1d(gen, d, h, 1))
        assign(self.codebook, uniform(gen, (self.num_embeddings, d),
                                      1.0 / self.num_embeddings))
        put(self.decoder[0], xavier_conv1d(gen, h, d, 1))
        for blk in self.decoder_resblocks:
            for conv in (blk.block[1], blk.block[4]):
                put(conv, xavier_conv1d(gen, h, h, 3))
        k1, k2 = INVERSE_PATCH_PLANS[self.patch_size]
        inv = self.reverse_patch_embed.proj
        put(inv[0], xavier_conv_transpose1d(gen, h, h, k1))
        put(inv[3], xavier_conv_transpose1d(gen, h, 1, k2))

    # -- forward pieces -----------------------------------------------------

    def patch_embed_out(self, x: torch.Tensor) -> torch.Tensor:
        """(B, seq_len, input_dim) -> (B, n_patches, hidden)."""
        pe = self.patch_embed.proj
        return patch_embed(x, pe.weight[:, 0, :].t(), pe.bias,
                           self.patch_size)

    def sep_conv(self, h: torch.Tensor) -> torch.Tensor:
        """(B, n_patches, hidden) -> z_e (B, n_patches, embedding_dim)."""
        sep = self.encoder[1].shared_conv
        return center_tap_dense(h, sep.weight, sep.bias)

    def _run_blocks(self, blocks: nn.ModuleList, prefix: str, x, conv_fn, *,
                    train: bool, generator):
        new = {}
        for i, blk in enumerate(blocks):
            x, st = blk.run(x, conv_fn, train=train, dropout_p=self.dropout_p,
                            generator=generator,
                            prefix=f"{prefix}.{i}.block")
            new.update(st)
        return x, new

    def encode_with_state(self, x: torch.Tensor, *, train: bool = False,
                          generator: torch.Generator | None = None):
        """(z_e (B, enc_out_len, embedding_dim), the encoder's new BN
        state, empty in eval)."""
        h, new = self._run_blocks(self.resblocks, "encoder.0.shared_conv",
                                  self.patch_embed_out(x), center_tap_dense,
                                  train=train, generator=generator)
        return self.sep_conv(h), new

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, seq_len, input_dim) -> z_e (B, enc_out_len, embedding_dim),
        eval mode."""
        return self.encode_with_state(x)[0]

    def _nearest_fn(self):
        if self.vq_impl == "pallas":
            from ..ops.fused_vq import nearest_codes_pallas
            return nearest_codes_pallas
        return nearest_codes

    def quantize(self, z_e: torch.Tensor) -> VQOutput:
        """The classic VQ of the training forward: loss, straight-through
        z_q, perplexity and ids, the search by `vq_impl`."""
        return vq_quantize(z_e, self.codebook, self.beta,
                           nearest_fn=self._nearest_fn())

    def decode(self, z_q: torch.Tensor, *, train: bool = False,
               generator: torch.Generator | None = None):
        """z_q (B, enc_out_len, D) -> (x_hat (B, seq_len, input_dim), the
        decoder's new BN state, the inverse patch embedding's included)."""
        dec_in = self.decoder[0]
        h = center_tap_dense(z_q, dec_in.weight, dec_in.bias)
        h, new = self._run_blocks(self.decoder_resblocks,
                                  "decoder.1.shared_conv", h, conv1d_same,
                                  train=train, generator=generator)
        inv = self.reverse_patch_embed.proj
        bn = inv[1]
        x_hat, (mean, var) = patch_embed_inverse(
            h, {"ct1_kernel": inv[0].weight, "ct1_bias": inv[0].bias,
                "bn_scale": bn.weight, "bn_bias": bn.bias,
                "ct2_kernel": inv[3].weight, "ct2_bias": inv[3].bias},
            (bn.running_mean, bn.running_var), patch_size=self.patch_size,
            input_dim=self.input_dim, train=train)
        if train:
            new.update(_bn_state(bn, "reverse_patch_embed.proj.1", mean, var))
        return x_hat, new

    # -- public API ------------------------------------------------------------

    def apply(self, x: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None):
        """(VQVAEOut(embedding_loss, x_hat, perplexity), new state): the
        running statistics every BatchNorm would hold after this batch,
        under their state_dict keys (empty in eval). Dropout at train
        time draws from `generator`, the encoder's resblocks first."""
        z_e, enc = self.encode_with_state(x, train=train, generator=generator)
        vq = self.quantize(z_e)
        x_hat, dec = self.decode(vq.z_q, train=train, generator=generator)
        return VQVAEOut(vq.loss, x_hat, vq.perplexity), {**enc, **dec}

    def loss_fn(self, x: torch.Tensor, *, train: bool,
                generator: torch.Generator | None = None):
        """MSE reconstruction + embedding loss (reference
        autencoder_lightning_base.py:80-84). Returns (loss, (metrics,
        new state))."""
        out, new = self.apply(x, train=train, generator=generator)
        recon_error = ((out.x_hat - x) ** 2).mean()
        loss = recon_error + out.embedding_loss
        metrics = {"loss": loss, "recon_error": recon_error,
                   "perplexity": out.perplexity}
        return loss, (metrics, new)

    @torch.no_grad()
    def commit_state(self, new_state: dict) -> None:
        """Write the running statistics `apply(train=True)` returned
        into the BatchNorm buffers."""
        for name, value in new_state.items():
            self.get_buffer(name).copy_(value)

    def nearest(self, z_e: torch.Tensor) -> torch.Tensor:
        """z_e (B, P, D) -> (B, P) int32 codebook ids, by `vq_impl`."""
        flat = z_e.reshape(-1, self.embedding_dim)
        return self._nearest_fn()(flat, self.codebook).reshape(z_e.shape[:-1])

    def encode_indices(self, x: torch.Tensor) -> torch.Tensor:
        """Frozen-encoder token ids (B, enc_out_len), int32."""
        return self.nearest(self.encode(x))

    def encode_zq(self, x: torch.Tensor) -> torch.Tensor:
        """Frozen-encoder quantized vectors (B, enc_out_len, D)."""
        return vq_lookup(self.encode_indices(x), self.codebook)

    def forward_ood(self, x: torch.Tensor) -> torch.Tensor:
        """Per-sample OOD score, the latent quantization error: the mean
        over (P, D) of (z_q - z_e)^2. x: (B, seq_len, C) -> (B,)."""
        z_e = self.encode(x)
        z_q = vq_lookup(self.nearest(z_e), self.codebook)
        return ((z_q - z_e) ** 2).mean(dim=(1, 2))
