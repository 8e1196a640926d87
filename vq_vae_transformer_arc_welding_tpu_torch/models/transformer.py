"""minGPT-style causal transformer decoder over latent tokens.

Port of vq_vae_transformer_arc_welding_tpu/models/transformer.py
(`sinusoidal_pe`, `TransformerDecoder`: `embed`, the block body,
`backbone`, `heads`, `apply` in eval and in train mode, `decay_mask`,
`loss_gen`, `loss_class`, the `compute_dtype` runtime option of the
eval and the train forward, `save` / `load`, and the samplers: `_sample_from_logits`,
`_recompute_scan`, `generate`, `_attn_cached`, `_token_step`,
`_token_step_fused`, `_prefill`, `generate_kv`). Attribute paths are the
reference keys read by
vq_vae_transformer_arc_welding_tpu/train/torch_import.py:139-169
(`embedding.latent_embedding.weight`, `transformer.h.{i}.ln_1.*`,
`transformer.h.{i}.attn.c_attn.*`, `class_head.linear_1.weight`, ...).
Linear weights are in torch's (out, in) layout, so `x @ W.t()`.

At train time (`apply(train=True, generator=g)`) every block applies
attention dropout (`att_dropout`), and residual dropout (`res_dropout`)
after its attention and after its MLP, drawn from `g` block by block.
As in the JAX package and the reference, the class head's optional
dropout is created but never applied. The stacked block layout (a scan
layout for XLA) is not ported.

bf16 training (`compute_dtype=torch.bfloat16` with `train=True`) is the
JAX package's: the f32 parameters are cast in the forward (`cast_params`,
`.to`, through which the gradients reach them in f32), the stream and
the blocks' products are bf16, dropout scales in bf16, the attention's
scores and softmax are f32 (kernel #9 on the bf16 q, k and v at
attention_impl='pallas'), and the heads sum in f32.

Sampling draws as `jax.random.categorical` does: Gumbel noise added to
the logits, then argmax. The noise comes from an explicit
torch.Generator, or from the caller through `noise=`, (steps, B,
n_classes) f32, which takes the generator's place: a jax key and a
torch generator give different numbers, so a test hands both packages
the same noise. The token loops are Python loops over steps known on
the host; the sampled token stays on the device and no step waits for
it.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from ..ops.activations import gelu, new_gelu
from ..ops.attention import (causal_attention_core, causal_self_attention,
                             merge_heads, split_heads)
from ..ops.norm import layer_norm
from ..ops.precision import check_compute_dtype, matmul_f32
from ..utils.random import dropout
from .base import Checkpointed, Node, Params, assign
from .initializers import gpt2_embedding, gpt2_linear


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """Fixed sin/cos table (reference model/embedding.py:6-24), float32."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def linear(x: torch.Tensor, p: nn.Module) -> torch.Tensor:
    """x @ W.t() (+ b) for a Params holder in torch Linear layout."""
    y = x @ p.weight.t()
    return y + p.bias if hasattr(p, "bias") else y


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.t() for a weight (out, in) that may be stored narrower than
    f32 (generate_kv's param_dtype): the activation is rounded to the
    weight's type and the products are summed in f32, into an f32
    result. On the card the narrow operands go to the product as they
    are; on the CPU they are widened first, which gives the same sums."""
    if w.dtype == torch.float32:
        return x @ w.t()
    return matmul_f32(x, w.t(), w.dtype)


def cast_params(holder: nn.Module, dtype: torch.dtype):
    """A holder's tensors cast to `dtype`, under the same attribute
    paths: Params become namespaces of tensors, Nodes namespaces of
    their children, ModuleLists lists. Integer buffers keep their type."""
    if isinstance(holder, nn.ModuleList):
        return [cast_params(child, dtype) for child in holder]
    out = SimpleNamespace()
    for name, t in (*holder.named_parameters(recurse=False),
                    *holder.named_buffers(recurse=False)):
        setattr(out, name, t.to(dtype) if t.is_floating_point() else t)
    for name, child in holder.named_children():
        setattr(out, name, cast_params(child, dtype))
    return out


class Block(nn.Module):
    """Pre-LN block: ln_1 -> attn -> residual -> ln_2 -> tanh-GELU MLP."""

    def __init__(self, d: int, device=None):
        super().__init__()

        def ln():
            return Params(device, weight=(d,), bias=(d,))

        self.ln_1 = ln()
        self.attn = Node(
            c_attn=Params(device, weight=(3 * d, d), bias=(3 * d,)),
            c_proj=Params(device, weight=(d, d), bias=(d,)))
        self.ln_2 = ln()
        self.mlp = Node(
            c_fc=Params(device, weight=(4 * d, d), bias=(4 * d,)),
            c_proj=Params(device, weight=(d, 4 * d), bias=(d,)))


class TransformerDecoder(Checkpointed, nn.Module):
    """hparams mirror the JAX TransformerDecoder constructor."""

    def __init__(self, d_model: int = 64, n_classes: int = 131,
                 seq_len: int = 100, n_blocks: int = 2, n_head: int = 6,
                 res_dropout: float = 0.1, att_dropout: float = 0.0,
                 learning_rate: float = 1e-3, class_h_bias: bool = False,
                 class_h_dropout: bool = False, pe_max_len: int = 512,
                 attention_impl: str = "xla", *, compute_dtype=None,
                 generator: torch.Generator | None = None, device=None):
        """attention_impl: 'xla' (the plain attention core) or 'pallas'
        (the fused kernel of ops/fused_attn.py) in the block body; a
        runtime option, not an hparam, named as in the JAX package.

        compute_dtype: another runtime option (an attribute, as in the
        JAX package, so serving can set it on a loaded model). None
        keeps exact f32. torch.bfloat16: `apply` casts the parameters
        and the embedded stream to bf16, LayerNorm outputs and the
        blocks' products are bf16 (half the traffic between ops), the
        attention scores and softmax stay f32, and the heads sum in f32
        into f32 logits, at train time too. The samplers keep f32."""
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_head {n_head}")
        if attention_impl not in ("xla", "pallas"):
            raise ValueError(f"attention_impl {attention_impl!r}: 'xla' or "
                             f"'pallas'")
        check_compute_dtype(compute_dtype)
        pe_max_len = max(pe_max_len, seq_len)
        self.compute_dtype = compute_dtype
        self.d_model = d_model
        self.n_classes = n_classes
        self.seq_len = seq_len
        self.n_blocks = n_blocks
        self.n_head = n_head
        self.class_h_bias = class_h_bias
        self.res_dropout = res_dropout
        self.att_dropout = att_dropout
        self.learning_rate = learning_rate
        # the reference's RAdam settings (transformer_decoder.py:64-114),
        # read by train/optim.make_transformer_optimizer
        self.betas = (0.9, 0.95)
        self.weight_decay = 0.1
        self.attention_impl = attention_impl
        # the tensor-parallel group once parallel/sharding.shard_params
        # has cut the blocks' weights to this rank's shards
        self.tp = None
        self.hparams = dict(d_model=d_model, n_classes=n_classes,
                            seq_len=seq_len, n_blocks=n_blocks, n_head=n_head,
                            res_dropout=res_dropout, att_dropout=att_dropout,
                            learning_rate=learning_rate,
                            class_h_bias=class_h_bias,
                            class_h_dropout=class_h_dropout)
        d = d_model
        pos = Node()
        pos.register_buffer("pe", torch.as_tensor(
            sinusoidal_pe(pe_max_len, d), device=device)[None])
        # key positions of a cache, for the decode step's mask
        self.register_buffer("key_pos", torch.arange(seq_len, device=device),
                             persistent=False)
        self.embedding = Node(
            latent_embedding=Params(device, weight=(n_classes, d)),
            positional_embedding=pos)
        self.transformer = Node(
            h=nn.ModuleList(Block(d, device) for _ in range(n_blocks)),
            ln_f=Params(device, weight=(d,), bias=(d,)))
        self.lm_head = Params(device, weight=(n_classes, d))
        l1 = dict(weight=(1, d))
        l2 = dict(weight=(2, seq_len))
        if class_h_bias:
            l1["bias"], l2["bias"] = (1,), (2,)
        self.class_head = Node(linear_1=Params(device, **l1),
                               linear_2=Params(device, **l2))
        if generator is not None:
            self.init_weights(generator)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.transformer.h

    @property
    def pe(self) -> torch.Tensor:
        """(pe_max_len, d_model) positional table."""
        return self.embedding.positional_embedding.pe[0]

    def init_weights(self, gen: torch.Generator) -> None:
        """GPT-2 init: N(0, 0.02) weights, residual projections scaled by
        1/sqrt(2 n_blocks), zero biases, unit LayerNorms."""
        d = self.d_model
        proj_std = 0.02 / math.sqrt(2 * self.n_blocks)

        def put(p, w_b):
            assign(p.weight, w_b[0])
            if hasattr(p, "bias"):
                assign(p.bias, w_b[1])

        def unit(ln):
            assign(ln.weight, torch.ones(d)), assign(ln.bias, torch.zeros(d))

        for blk in self.blocks:
            put(blk.attn.c_attn, gpt2_linear(gen, d, 3 * d))
            put(blk.attn.c_proj, gpt2_linear(gen, d, d, std=proj_std))
            put(blk.mlp.c_fc, gpt2_linear(gen, d, 4 * d))
            put(blk.mlp.c_proj, gpt2_linear(gen, 4 * d, d, std=proj_std))
            unit(blk.ln_1), unit(blk.ln_2)
        unit(self.transformer.ln_f)
        put(self.lm_head, gpt2_linear(gen, d, self.n_classes))
        put(self.class_head.linear_1, gpt2_linear(gen, d, 1))
        put(self.class_head.linear_2, gpt2_linear(gen, self.seq_len, 2))
        assign(self.embedding.latent_embedding.weight,
               gpt2_embedding(gen, self.n_classes, d))

    # -- forward --------------------------------------------------------

    def embed(self, x_ids: torch.Tensor) -> torch.Tensor:
        """Token embedding + positional encoding, (B, T, d_model), summed
        in f32 and then cast to the compute dtype where one is set."""
        t = x_ids.shape[1]
        x = (self.embedding.latent_embedding.weight[x_ids.long()]
             + self.pe[None, :t])
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def block_body(self, x: torch.Tensor, blk, *, train: bool = False,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """blk: a Block, or its `cast_params`. Every product follows the
        stream's type; the attention core keeps f32 scores. At train
        time the dropouts draw from `generator`: the attention's, its
        residual's, then the MLP's. A tensor-parallel model
        (parallel/sharding.py) runs its rank's heads and MLP columns:
        each sublayer between Megatron's f and g, the output
        projections' biases added after g."""
        tp = self.tp
        h = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
        x = x + causal_self_attention(
            h, blk.attn, n_head=self.n_head, attn_dropout_p=self.att_dropout,
            resid_dropout_p=self.res_dropout, train=train,
            generator=generator, impl=self.attention_impl, tp=tp)
        h = layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
        if tp is not None:
            h = tp.copy_to(h)
        h = new_gelu(linear(h, blk.mlp.c_fc)) @ blk.mlp.c_proj.weight.t()
        if tp is not None:
            h = tp.reduce_from(h)
        return x + dropout(h + blk.mlp.c_proj.bias, self.res_dropout, train,
                           generator)

    def backbone(self, x_ids: torch.Tensor, *, train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.embed(x_ids)
        # with a compute dtype the parameters are cast per call, as the
        # JAX package casts them in `embed`: the f32 module stays the
        # one copy of the weights
        tf = (self.transformer if self.compute_dtype is None
              else cast_params(self.transformer, self.compute_dtype))
        for blk in tf.h:
            x = self.block_body(x, blk, train=train, generator=generator)
        return layer_norm(x, tf.ln_f.weight, tf.ln_f.bias)

    def heads(self, x: torch.Tensor, *, generate: bool = True) -> torch.Tensor:
        """lm_head logits (B, T, n_classes), or the class head's two-stage
        d -> 1, exact GELU, seq_len -> 2 logits (B, 2). With a compute
        dtype the weights are rounded to it and every product is summed
        in f32 into f32 logits."""
        if self.compute_dtype is None:
            if generate:
                return x @ self.lm_head.weight.t()
            h = gelu(linear(x, self.class_head.linear_1).squeeze(-1))
            return linear(h, self.class_head.linear_2)
        cdt = self.compute_dtype
        if generate:
            return dot_f32(x, self.lm_head.weight.to(cdt))
        l1, l2 = self.class_head.linear_1, self.class_head.linear_2
        h = dot_f32(x, l1.weight.to(cdt))
        if self.class_h_bias:
            h = h + l1.bias.to(cdt)
        logits = gelu(h.squeeze(-1)) @ l2.weight.to(cdt).float().t()
        return logits + l2.bias.to(cdt) if self.class_h_bias else logits

    def apply(self, x_ids: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None,
              generate: bool = True) -> torch.Tensor:
        """x_ids (B, T) -> lm_head logits (B, T, n_classes), or the class
        head's (B, 2) with generate=False. train: dropout on, drawn from
        `generator`."""
        return self.heads(self.backbone(x_ids, train=train,
                                        generator=generator),
                          generate=generate)

    forward = apply

    # -- training (reference :64-114, :226-230) --------------------------

    def decay_mask(self) -> tuple[list[str], list[str]]:
        """(names that take weight decay, names that do not), in
        parameter order: the minGPT split (reference
        transformer_decoder.py:72-107). The Linear weights decay,
        lm_head's and the class head's too; the token embedding, the
        biases and the LayerNorms do not."""
        decay, no_decay = [], []
        for name, p in self.named_parameters():
            linear_w = (name.endswith(".weight")
                        and name != "embedding.latent_embedding.weight"
                        and p.ndim == 2)
            (decay if linear_w else no_decay).append(name)
        return decay, no_decay

    @staticmethod
    def loss_gen(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Token-level cross entropy, labels of -1 ignored; 0 where no
        label counts."""
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        labels = labels.reshape(-1).long()
        valid = labels != -1
        safe = torch.where(valid, labels, 0)
        nll = -torch.log_softmax(flat, dim=-1).gather(1, safe[:, None])[:, 0]
        return (torch.where(valid, nll, 0.0).sum()
                / valid.sum().clamp_min(1))

    @staticmethod
    def loss_class(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Cross entropy of the class head's (B, 2) logits."""
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, labels.long()[:, None]).mean()

    # -- autoregressive sampling (reference :203-224) -------------------

    @staticmethod
    def _sample_from_logits(last: torch.Tensor, noise, do_sample: bool,
                            top_k: int | None) -> torch.Tensor:
        """Top-k filter, then argmax of the logits (greedy) or of the
        logits plus Gumbel noise (a categorical draw). last, noise:
        (B, n_classes). Ties at the k-th value are kept."""
        if top_k is not None:
            kth = torch.sort(last, dim=-1).values[:, -top_k][:, None]
            last = last.masked_fill(last < kth, float("-inf"))
        if do_sample:
            last = last + noise
        return torch.argmax(last, dim=-1)

    def _gumbel_noise(self, steps: int, b: int, generator, noise):
        """(steps, B, n_classes) f32 Gumbel noise on the model's device:
        the caller's `noise`, else drawn from `generator` (on that
        device), else from a generator seeded with 0."""
        dev = self.pe.device
        shape = (steps, b, self.n_classes)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise must be {shape}, got "
                                 f"{tuple(noise.shape)}")
            return noise
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        u = torch.rand(shape, generator=generator, device=dev)
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(u.clamp_min(tiny)))

    def _start(self, x_ids, num_steps, do_sample, generator, noise):
        """(steps, the (B, t0 + steps) id buffer, the noise or None)."""
        x_ids = torch.as_tensor(x_ids, device=self.pe.device)
        steps = self.seq_len if num_steps is None else num_steps
        b = x_ids.shape[0]
        buf = torch.cat([x_ids, x_ids.new_zeros((b, steps))], dim=1)
        noise = (self._gumbel_noise(steps, b, generator, noise)
                 if do_sample else None)
        return steps, buf, noise

    def _recompute_scan(self, buf: torch.Tensor, cur0: int, noise, *,
                        do_sample: bool, top_k: int | None,
                        logits_fn=None) -> torch.Tensor:
        """Full-forward-per-step sampling into the buffer from position
        cur0 to its end: the reference's context-cropping loop
        (transformer_decoder.py:203-224). The context is the last
        seq_len ids before the position; the JAX package reads a
        fixed-size window with a masked tail instead, which causal
        attention makes the same function. noise[i] belongs to position
        cur0 + i. buf is filled in place.

        logits_fn(window) overrides the forward (the int8 forward of
        models/quantized.py); the default is the f32 apply."""
        if logits_fn is None:
            logits_fn = self.apply
        for i, cur in enumerate(range(cur0, buf.shape[1])):
            window = buf[:, max(0, cur - self.seq_len):cur]
            last = logits_fn(window)[:, -1]
            buf[:, cur] = self._sample_from_logits(
                last, noise[i] if do_sample else None, do_sample, top_k)
        return buf

    @torch.inference_mode()
    def generate(self, x_ids, *, do_sample: bool = False,
                 top_k: int | None = None,
                 generator: torch.Generator | None = None,
                 num_steps: int | None = None, noise=None) -> torch.Tensor:
        """Append `num_steps` (default seq_len) sampled tokens to x_ids
        (B, t0), one full forward per token. Returns (B, t0 + steps)."""
        t0 = x_ids.shape[1]
        _, buf, noise = self._start(x_ids, num_steps, do_sample, generator,
                                    noise)
        return self._recompute_scan(buf, t0, noise, do_sample=do_sample,
                                    top_k=top_k)

    # -- KV-cached sampling (O(T^2) total vs the reference's O(T^3)) ----

    def _step_weights(self, param_dtype=None):
        """([(c_attn, attn c_proj, c_fc, mlp c_proj) weights per block],
        lm_head weight), cast to param_dtype once where it is given."""
        def cast(w):
            return w if param_dtype is None else w.to(param_dtype)

        return ([tuple(cast(p.weight) for p in (
            blk.attn.c_attn, blk.attn.c_proj, blk.mlp.c_fc, blk.mlp.c_proj))
            for blk in self.blocks], cast(self.lm_head.weight))

    def _attn_cached(self, blk: Block, x_tok, k_cache, v_cache, pos: int,
                     attn_len: int | None = None, weights=None):
        """One-token attention against a (B, H, T, D) cache; writes the
        new k/v at `pos`, in place, and attends to positions <= pos.

        attn_len restricts the score and P@V reads to the cache prefix
        [:attn_len]; callers guarantee pos < attn_len (generate_kv
        cache_buckets). weights: (c_attn, c_proj) matrices that may be
        stored in bf16 (generate_kv param_dtype); the caches may be
        stored in bf16 too (cache_dtype): K/V round to the cache's type
        at the write, scores and P@V are summed in f32."""
        w_attn, w_proj = weights or (blk.attn.c_attn.weight,
                                     blk.attn.c_proj.weight)
        qkv = dot_f32(x_tok, w_attn) + blk.attn.c_attn.bias
        q, k, v = (split_heads(z, self.n_head)
                   for z in qkv.split(self.d_model, dim=-1))
        k_cache[:, :, pos] = k[:, :, 0]
        v_cache[:, :, pos] = v[:, :, 0]
        k_r = k_cache if attn_len is None else k_cache[:, :, :attn_len]
        v_r = v_cache if attn_len is None else v_cache[:, :, :attn_len]
        att = (q @ k_r.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
        att = att.masked_fill(self.key_pos[:k_r.shape[2]] > pos,
                              float("-inf"))
        y = merge_heads(torch.softmax(att, dim=-1) @ v_r.float())
        return dot_f32(y, w_proj) + blk.attn.c_proj.bias, k_cache, v_cache

    def _embed_token(self, tok: torch.Tensor, pos: int) -> torch.Tensor:
        """(B,) ids at absolute position `pos` -> (B, 1, d_model)."""
        return (self.embedding.latent_embedding.weight[tok.long()][:, None]
                + self.pe[pos])

    def _token_step_fused(self, tok, pos: int, caches, stack):
        """_token_step with every block as one kernel call (#13,
        ops/fused_decode.py). Caches here are (B, T, C) time-major and
        updated in place. stack: the generation's BlockDecodeStack over
        these caches. Same function; logits agree to float tolerance."""
        x = stack(self._embed_token(tok, pos), pos)
        ln_f = self.transformer.ln_f
        x = layer_norm(x, ln_f.weight, ln_f.bias)
        return x[:, 0] @ self.lm_head.weight.t(), caches

    def _token_step(self, tok, pos: int, caches, attn_len: int | None = None,
                    weights=None):
        """Embed one token (B,) at absolute position `pos` and run all
        blocks against the (B, H, T, D) KV caches, which are updated in
        place. weights: `_step_weights(param_dtype)`. Returns
        (logits (B, n_classes), caches)."""
        block_w, lm_w = weights or self._step_weights()
        x = self._embed_token(tok, pos)
        for blk, (k_c, v_c), (w_attn, w_proj, w_fc, w_mp) in zip(
                self.blocks, caches, block_w):
            h = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
            a, _, _ = self._attn_cached(blk, h, k_c, v_c, pos,
                                        attn_len=attn_len,
                                        weights=(w_attn, w_proj))
            x = x + a
            h = layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
            h = new_gelu(dot_f32(h, w_fc) + blk.mlp.c_fc.bias)
            x = x + dot_f32(h, w_mp) + blk.mlp.c_proj.bias
        ln_f = self.transformer.ln_f
        x = layer_norm(x, ln_f.weight, ln_f.bias)
        return dot_f32(x[:, 0], lm_w), caches

    def _prefill(self, x_ids: torch.Tensor, caches):
        """One batched forward over the whole prompt (B, t0), writing
        every block's K/V into the (B, H, T, D) caches at positions
        [0, t0), in place. Returns (last-position logits, caches). The
        attention is the plain core, whatever attention_impl says, as in
        the JAX package."""
        t0 = x_ids.shape[1]
        x = self.embed(x_ids)
        for blk, (k_c, v_c) in zip(self.blocks, caches):
            h = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
            q, k, v = (split_heads(z, self.n_head) for z in
                       linear(h, blk.attn.c_attn).split(self.d_model, dim=-1))
            k_c[:, :, :t0] = k
            v_c[:, :, :t0] = v
            y = merge_heads(causal_attention_core(q, k, v))
            x = x + linear(y, blk.attn.c_proj)
            h = layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
            x = x + linear(new_gelu(linear(h, blk.mlp.c_fc)), blk.mlp.c_proj)
        ln_f = self.transformer.ln_f
        x = layer_norm(x, ln_f.weight, ln_f.bias)
        return x[:, -1] @ self.lm_head.weight.t(), caches

    @torch.inference_mode()
    def generate_kv(self, x_ids, *, do_sample: bool = False,
                    top_k: int | None = None,
                    generator: torch.Generator | None = None,
                    num_steps: int | None = None,
                    decode_impl: str = "xla", cache_dtype=None,
                    param_dtype=None, cache_buckets: int | None = None,
                    scan_unroll: int = 1, noise=None) -> torch.Tensor:
        """KV-cached autoregressive sampling; same output contract as
        `generate` for any prompt length and step count.

        The prompt is prefilled in one batched forward. Steps whose
        context still fits in seq_len run on the KV cache (O(T) per
        step); once the reference's context cropping would kick in
        (current length > seq_len, transformer_decoder.py:203-224) the
        remaining steps fall back to the full-window recompute, the only
        way to match the cropped positional embeddings exactly. The
        caches are allocated here, seq_len rows each, and updated in
        place. For the card's ms per token of each variant see PERF.md.

        decode_impl: 'xla' (default, the plain f32 chain; the name is
        the JAX package's) or 'fused' (one kernel launch per block per
        token, ops/fused_decode.BlockDecodeStack, the operands checked
        once per generation: same function, logits to float tolerance,
        so ids can differ at near-ties).

        cache_dtype: storage type of the K/V caches (torch.bfloat16
        halves the cache traffic; scores are still summed in f32, so
        logits drift by the rounding of the cached K/V). None = f32.

        param_dtype: storage type of the decode step's weight matrices
        (torch.bfloat16): cast once before the loop, products bf16 x
        bf16 summed in f32. The prefill and the recompute tail keep the
        f32 weights. None = f32.

        cache_buckets: a step whose context fits in the first G, 2G, ...
        cache positions reads only that prefix instead of the whole
        cache. Every step's masked softmax sees the same valid entries;
        the smaller product's summation order can differ in the last
        bits.

        scan_unroll: the JAX package's unroll factor of its decode scan.
        An eager loop has nothing to unroll: the value is validated and
        changes nothing.

        cache_dtype, param_dtype, cache_buckets and scan_unroll need
        decode_impl='xla'. generator, noise: see `_gumbel_noise`."""
        if decode_impl not in ("xla", "fused"):
            raise ValueError(f"decode_impl {decode_impl!r}: 'xla' or 'fused'")
        if not isinstance(scan_unroll, int) or scan_unroll < 1:
            raise ValueError(f"scan_unroll must be a positive int, got "
                             f"{scan_unroll!r}")
        if param_dtype is not None and decode_impl != "xla":
            raise ValueError("param_dtype requires decode_impl='xla'")
        if scan_unroll != 1 and decode_impl != "xla":
            raise ValueError("scan_unroll requires decode_impl='xla'")
        if cache_buckets is not None and decode_impl != "xla":
            raise ValueError("cache_buckets requires decode_impl='xla'")
        if cache_dtype is not None and decode_impl != "xla":
            raise ValueError("cache_dtype requires decode_impl='xla'")
        fused = decode_impl == "fused"
        steps, buf, noise = self._start(x_ids, num_steps, do_sample,
                                        generator, noise)
        b, t0 = buf.shape[0], buf.shape[1] - steps
        sample = dict(do_sample=do_sample, top_k=top_k)
        # a step appending at position `cur` can use the cache only while
        # the uncropped context [0, cur) fits: cur <= seq_len
        n_kv = max(0, min(steps, self.seq_len - t0 + 1))
        if n_kv == 0:  # prompt already longer than the context window
            return self._recompute_scan(buf, t0, noise, **sample)

        cache_len = self.seq_len
        shape = (b, self.n_head, cache_len, self.d_model // self.n_head)
        caches = [tuple(torch.zeros(shape, dtype=cache_dtype or torch.float32,
                                    device=buf.device) for _ in range(2))
                  for _ in self.blocks]
        logits, caches = self._prefill(buf[:, :t0], caches)
        if fused:
            # the kernel's cache layout: (B, T, C) time-major, one
            # relayout after the prefill; the operands checked once
            from ..ops import fused_decode
            caches = [tuple(merge_heads(z).contiguous() for z in kv)
                      for kv in caches]
            stack = fused_decode.BlockDecodeStack(self.blocks, caches,
                                                  n_head=self.n_head)
        weights = None if fused else self._step_weights(param_dtype)
        bounds = (range(cache_buckets, cache_len, cache_buckets)
                  if cache_buckets else ())
        for i in range(n_kv):
            cur = t0 + i
            nxt = self._sample_from_logits(
                logits, noise[i] if do_sample else None, **sample)
            buf[:, cur] = nxt
            # logits for the appended token (the clamp only ever fires on
            # the final KV step, whose logits are never consumed)
            pos = min(cur, cache_len - 1)
            if fused:
                logits, caches = self._token_step_fused(nxt, pos, caches,
                                                        stack)
            else:
                attn_len = next((bd for bd in bounds if cur + 1 <= bd), None)
                logits, caches = self._token_step(nxt, pos, caches,
                                                  attn_len=attn_len,
                                                  weights=weights)
        if steps > n_kv:  # context-cropping tail, reference semantics
            buf = self._recompute_scan(
                buf, t0 + n_kv, noise[n_kv:] if do_sample else None,
                **sample)
        return buf
