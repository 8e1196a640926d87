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

`use_improved_vq=True` is the EMA VQ of ops/vq_ema.py: the codebook and
its EMAs are buffers under the reference's vector_quantize_pytorch keys
(`vector_quantization.vq.layers.0._codebook.{embed, cluster_size,
embed_avg, initted}`, one codebook), moved by the training forward's
returned state as the BatchNorms' are, and the search is the plain one
whatever `vq_impl` says, as in the JAX package.

`compute_dtype=torch.bfloat16` (bf16 training, a runtime option as in
the JAX package) rounds the inputs of every matmul of the encoder and
the decoder to bf16 and sums them in f32 (ops/precision.py); BatchNorm,
GELU, the VQ's distances and the losses stay f32, and so do the master
weights. `compute_scope` narrows it to the 'encoder' (with the patch
embedding and sep_conv) or the 'decoder' (with the inverse patch
embedding); the other half runs exactly as in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.activations import gelu
from ..ops.conv import center_tap_dense, conv1d_same
from ..ops import vq_ema
from ..ops.norm import batch_norm_apply, batch_norm_train
from ..ops.patching import (INVERSE_PATCH_PLANS, patch_embed,
                            patch_embed_inverse)
from ..ops.precision import check_compute_dtype
from ..ops.vq import nearest_codes, vq_lookup, vq_quantize
from ..utils.random import dropout
from .base import (BatchNormParams, Checkpointed, Node, Params, assign,
                   bn_state)
from .initializers import uniform, xavier_conv1d, xavier_conv_transpose1d


class VQVAEOut(NamedTuple):
    embedding_loss: torch.Tensor
    x_hat: torch.Tensor
    perplexity: torch.Tensor


class EMACodebook(nn.Module):
    """The EMA VQ's state as buffers under vector_quantize_pytorch's
    names (one codebook: a leading axis of 1)."""

    def __init__(self, k: int, d: int, device=None):
        super().__init__()
        self.register_buffer("initted", torch.zeros(1, device=device))
        self.register_buffer("cluster_size", torch.zeros(1, k, device=device))
        self.register_buffer("embed_avg", torch.zeros(1, k, d, device=device))
        self.register_buffer("embed", torch.zeros(1, k, d, device=device))

    def state(self) -> vq_ema.EMAState:
        return vq_ema.EMAState(self.embed[0], self.cluster_size[0],
                               self.embed_avg[0],
                               self.initted[0].to(torch.int32))


EMA_PREFIX = "vector_quantization.vq.layers.0._codebook"


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
                    new.update(bn_state(bn, f"{prefix}.{bn_idx}", mean, var))
                else:
                    h = batch_norm_apply(h, bn.weight, bn.bias,
                                         bn.running_mean, bn.running_var)
        return x + dropout(h, dropout_p, train, generator), new


class VQVAEPatch(Checkpointed, nn.Module):
    """hparams mirror the JAX VQVAEPatch constructor: the classic VQ
    (codebook in `vector_quantization.embedding.weight`) or the EMA VQ
    (`use_improved_vq`, `kmeans_iters`, `threshold_ema_dead_code`).

    vq_impl is a runtime option, not an hparam: 'xla' (the name is the
    JAX package's) searches the nearest code in plain PyTorch
    (ops/vq.nearest_codes); 'pallas' (again the JAX name) runs the fused
    nearest-code kernel, CUDA on the card (ops/fused_vq.py), in the
    serving paths and in the training forward alike. The JAX package's
    conv_impl has no counterpart: the decoder's k=3 conv is always one
    matmul (ops/conv.conv1d_same). compute_dtype / compute_scope: bf16
    training (the module docstring), runtime options as well."""

    def __init__(self, hidden_dim: int, input_dim: int, num_embeddings: int,
                 embedding_dim: int, n_resblocks: int,
                 learning_rate: float = 1e-3, dropout_p: float = 0.1,
                 patch_size: int = 25, seq_len: int = 200,
                 batch_norm: bool = True, beta: float = 0.25,
                 use_improved_vq: bool = False, kmeans_iters: int = 0,
                 threshold_ema_dead_code: int = 2, *,
                 vq_impl: str = "xla", compute_dtype=None,
                 compute_scope: str = "all",
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        check_compute_dtype(compute_dtype)
        if compute_scope not in ("all", "encoder", "decoder"):
            raise ValueError(f"compute_scope: {compute_scope}")
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
        self.use_improved_vq = use_improved_vq
        self.kmeans_iters = kmeans_iters
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.vq_impl = vq_impl
        self.compute_dtype = compute_dtype
        self.compute_scope = compute_scope
        # tokens per cycle: 200 // 25 * 2 = 16
        self.enc_out_len = seq_len // patch_size * input_dim
        self.hparams = dict(
            hidden_dim=hidden_dim, input_dim=input_dim,
            num_embeddings=num_embeddings, embedding_dim=embedding_dim,
            n_resblocks=n_resblocks, learning_rate=learning_rate,
            dropout_p=dropout_p, patch_size=patch_size, seq_len=seq_len,
            batch_norm=batch_norm, beta=beta, use_improved_vq=use_improved_vq,
            kmeans_iters=kmeans_iters,
            threshold_ema_dead_code=threshold_ema_dead_code)

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
        self.vector_quantization = (
            Node(vq=Node(layers=nn.ModuleList([Node(
                _codebook=EMACodebook(num_embeddings, d, device))])))
            if use_improved_vq else
            Node(embedding=Params(device, weight=(num_embeddings, d))))
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
    def ema(self) -> EMACodebook:
        return self.vector_quantization.vq.layers[0]._codebook

    @property
    def codebook(self) -> torch.Tensor:
        """(K, D): the classic VQ's parameter, or the EMA VQ's buffer."""
        if self.use_improved_vq:
            return self.ema.embed[0]
        return self.vector_quantization.embedding.weight

    def _dtype(self, half: str):
        """The compute dtype of 'encoder' or 'decoder' (None: f32)."""
        return (self.compute_dtype if self.compute_scope in ("all", half)
                else None)

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
        if not self.use_improved_vq:
            # the EMA codebook starts at zero and is bootstrapped by the
            # kmeans of the first training batch
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
                           self.patch_size, self._dtype("encoder"))

    def sep_conv(self, h: torch.Tensor) -> torch.Tensor:
        """(B, n_patches, hidden) -> z_e (B, n_patches, embedding_dim)."""
        sep = self.encoder[1].shared_conv
        return center_tap_dense(h, sep.weight, sep.bias,
                                self._dtype("encoder"))

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
        cd = self._dtype("encoder")
        h, new = self._run_blocks(
            self.resblocks, "encoder.0.shared_conv", self.patch_embed_out(x),
            lambda a, w, b: center_tap_dense(a, w, b, cd), train=train,
            generator=generator)
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

    def quantize(self, z_e: torch.Tensor, *, train: bool = False,
                 generator: torch.Generator | None = None, draws=None):
        """The VQ of the training forward: (VQOutput (loss, straight-
        through z_q, perplexity, ids), the EMA VQ's new state under its
        buffers' keys, empty for the classic VQ). The classic VQ searches
        by `vq_impl`; the EMA VQ (ops/vq_ema.quantize_ema) takes its row
        draws from `draws` or `generator`."""
        if not self.use_improved_vq:
            return vq_quantize(z_e, self.codebook, self.beta,
                               nearest_fn=self._nearest_fn()), {}
        out, st = vq_ema.quantize_ema(
            z_e, self.ema.state(), train=train,
            kmeans_iters=self.kmeans_iters,
            threshold_ema_dead_code=self.threshold_ema_dead_code,
            draws=draws, generator=generator)
        if not train:
            return out, {}
        return out, {f"{EMA_PREFIX}.embed": st.codebook[None],
                     f"{EMA_PREFIX}.cluster_size": st.cluster_size[None],
                     f"{EMA_PREFIX}.embed_avg": st.embed_avg[None],
                     f"{EMA_PREFIX}.initted": st.initialized[None].float()}

    def decode(self, z_q: torch.Tensor, *, train: bool = False,
               generator: torch.Generator | None = None):
        """z_q (B, enc_out_len, D) -> (x_hat (B, seq_len, input_dim), the
        decoder's new BN state, the inverse patch embedding's included)."""
        cd = self._dtype("decoder")
        dec_in = self.decoder[0]
        h = center_tap_dense(z_q, dec_in.weight, dec_in.bias, cd)
        h, new = self._run_blocks(self.decoder_resblocks,
                                  "decoder.1.shared_conv", h,
                                  lambda a, w, b: conv1d_same(a, w, b, cd),
                                  train=train, generator=generator)
        inv = self.reverse_patch_embed.proj
        bn = inv[1]
        x_hat, (mean, var) = patch_embed_inverse(
            h, {"ct1_kernel": inv[0].weight, "ct1_bias": inv[0].bias,
                "bn_scale": bn.weight, "bn_bias": bn.bias,
                "ct2_kernel": inv[3].weight, "ct2_bias": inv[3].bias},
            (bn.running_mean, bn.running_var), patch_size=self.patch_size,
            input_dim=self.input_dim, train=train, compute_dtype=cd)
        if train:
            new.update(bn_state(bn, "reverse_patch_embed.proj.1", mean, var))
        return x_hat, new

    # -- public API ------------------------------------------------------------

    def apply(self, x: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None, vq_draws=None):
        """(VQVAEOut(embedding_loss, x_hat, perplexity), new state): the
        running statistics every BatchNorm would hold after this batch,
        and the EMA VQ's state, under their state_dict keys (empty in
        eval). Dropout at train time draws from `generator`, the
        encoder's resblocks first, then the EMA VQ's rows (or
        `vq_draws`, see `quantize`), then the decoder's."""
        z_e, enc = self.encode_with_state(x, train=train, generator=generator)
        vq, vq_state = self.quantize(z_e, train=train, generator=generator,
                                     draws=vq_draws)
        x_hat, dec = self.decode(vq.z_q, train=train, generator=generator)
        return (VQVAEOut(vq.loss, x_hat, vq.perplexity),
                {**enc, **vq_state, **dec})

    def loss_fn(self, x: torch.Tensor, *, train: bool,
                generator: torch.Generator | None = None, vq_draws=None):
        """MSE reconstruction + embedding loss (reference
        autencoder_lightning_base.py:80-84). Returns (loss, (metrics,
        new state))."""
        out, new = self.apply(x, train=train, generator=generator,
                              vq_draws=vq_draws)
        recon_error = ((out.x_hat - x) ** 2).mean()
        loss = recon_error + out.embedding_loss
        metrics = {"loss": loss, "recon_error": recon_error,
                   "perplexity": out.perplexity}
        return loss, (metrics, new)

    def nearest(self, z_e: torch.Tensor) -> torch.Tensor:
        """z_e (B, P, D) -> (B, P) int32 codebook ids, by `vq_impl` (the
        EMA VQ's by the plain search)."""
        if self.use_improved_vq:
            return vq_ema.nearest_ema(z_e, self.ema.state())
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
