"""TS2Vec's dilated-convolution encoder.

Port of vq_vae_transformer_arc_welding_tpu/ts2vec/encoder.py
(`same_pad_conv`, `conv_block_apply`, the masks, `ts_encoder_init`,
`ts_encoder_apply`; the reference's vendored model/ts2vec/encoder.py
and dilated_conv.py): the input Linear, random timestamp masking, a
stack of residual dilated conv blocks (dilation 2^i, GELU-conv-GELU-conv,
a 1x1 projector where the width changes and on the last block), then
representation dropout. NaN timestamps are zeroed and always masked.

`TSEncoder` holds its weights under the reference's state_dict keys
(`input_fc.*`, `feature_extractor.net.{i}.conv1.conv.*`, ...). A conv is
one im2col matmul with the taps `dilation` apart (ops/conv.py's way),
not `F.conv1d`, whose cuDNN path takes TF32 by default; the even
receptive field's trim of SamePadConv is kept.

Randomness comes from the caller: the masks and the dropout are drawn
from a passed torch.Generator, or the mask is handed in as a (B, T)
boolean tensor (the EMA VQ's `draws=` idea), so that a test can give
both packages the same mask.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models.base import Node, Params, assign
from ..ops.activations import gelu
from ..utils.random import dropout


def dilated_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 dilation: int) -> torch.Tensor:
    """SamePadConv: x (B, T, I), w (O, I, k) torch layout -> (B, T, O)."""
    o, i, k = w.shape
    receptive = (k - 1) * dilation + 1
    pad = receptive // 2
    t = x.shape[1]
    length = t + 2 * pad - receptive + 1
    xp = F.pad(x, (0, 0, pad, pad))
    cols = torch.cat([xp[:, j * dilation:j * dilation + length]
                      for j in range(k)], dim=-1)
    y = cols @ w.permute(2, 1, 0).reshape(k * i, o) + b
    return y[:, :-1] if receptive % 2 == 0 else y


def generate_binomial_mask(b: int, t: int, generator, device,
                           p: float = 0.5) -> torch.Tensor:
    return torch.bernoulli(torch.full((b, t), p, device=device),
                           generator=generator).bool()


def generate_continuous_mask(b: int, t: int, generator, device, n=5,
                             l=0.1) -> torch.Tensor:
    """n spans of length l per row set False (reference encoder.py:7-21)."""
    if isinstance(n, float):
        n = int(n * t)
    n = max(min(n, t // 2), 1)
    if isinstance(l, float):
        l = int(l * t)
    l = max(l, 1)
    starts = torch.randint(0, t - l + 1, (b, n), generator=generator,
                           device=device)
    pos = torch.arange(t, device=device)[None, None]
    in_span = (pos >= starts[..., None]) & (pos < starts[..., None] + l)
    return ~in_span.any(dim=1)


def make_mask(mode, b: int, t: int, generator, device) -> torch.Tensor:
    """A mode's (B, T) mask, or a handed one as it is."""
    if isinstance(mode, torch.Tensor):
        return mode.to(device=device, dtype=torch.bool)
    if mode == "binomial":
        return generate_binomial_mask(b, t, generator, device)
    if mode == "continuous":
        return generate_continuous_mask(b, t, generator, device)
    if mode == "all_true":
        return torch.ones((b, t), dtype=torch.bool, device=device)
    if mode == "all_false":
        return torch.zeros((b, t), dtype=torch.bool, device=device)
    if mode == "mask_last":
        m = torch.ones((b, t), dtype=torch.bool, device=device)
        m[:, -1] = False
        return m
    raise ValueError(f"unknown mask mode {mode}")


class _SamePadConv(Node):
    def __init__(self, ci: int, co: int, k: int, device=None):
        super().__init__(conv=Params(device, weight=(co, ci, k), bias=(co,)))


class ConvBlock(nn.Module):
    def __init__(self, ci: int, co: int, dilation: int, final: bool,
                 device=None):
        super().__init__()
        self.dilation = dilation
        self.conv1 = _SamePadConv(ci, co, 3, device)
        self.conv2 = _SamePadConv(co, co, 3, device)
        self.projector = (Params(device, weight=(co, ci, 1), bias=(co,))
                          if ci != co or final else None)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        p = self.projector
        residual = x if p is None else dilated_conv(x, p.weight, p.bias, 1)
        c1, c2 = self.conv1.conv, self.conv2.conv
        h = dilated_conv(gelu(x), c1.weight, c1.bias, self.dilation)
        h = dilated_conv(gelu(h), c2.weight, c2.bias, self.dilation)
        return h + residual


class TSEncoder(nn.Module):
    """input_dims -> hidden_dims (Linear) -> depth dilated blocks at
    hidden_dims and one to output_dims."""

    def __init__(self, input_dims: int, output_dims: int = 320,
                 hidden_dims: int = 64, depth: int = 10,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.input_dims, self.output_dims = input_dims, output_dims
        self.hidden_dims, self.depth = hidden_dims, depth
        self.input_fc = Params(device, weight=(hidden_dims, input_dims),
                               bias=(hidden_dims,))
        channels = [hidden_dims] * depth + [output_dims]
        blocks, ci = [], hidden_dims
        for i, co in enumerate(channels):
            blocks.append(ConvBlock(ci, co, 2 ** i, i == len(channels) - 1,
                                    device))
            ci = co
        self.feature_extractor = Node(net=nn.ModuleList(blocks))
        if generator is not None:
            self.init_weights(generator)

    def init_weights(self, gen: torch.Generator) -> None:
        """torch's Linear / Conv1d default: U(+-1/sqrt(fan_in)) for the
        weights and the biases."""
        for mod in [self.input_fc, *(p for blk in self.feature_extractor.net
                                     for p in (blk.conv1.conv, blk.conv2.conv,
                                               blk.projector) if p is not None)]:
            w = mod.weight
            bound = 1.0 / math.sqrt(w[0].numel())
            for t in (mod.weight, mod.bias):
                assign(t, (torch.rand(t.shape, generator=gen) * 2 - 1) * bound)

    def forward(self, x: torch.Tensor, *, mask="all_true",
                train: bool = False, generator: torch.Generator | None = None,
                repr_dropout_p: float = 0.1) -> torch.Tensor:
        """x (B, T, input_dims), NaNs allowed -> (B, T, output_dims).
        mask: a mode ('binomial', 'continuous', 'all_true', 'all_false',
        'mask_last', 'auto' = binomial at train time, else all_true) or
        a (B, T) boolean tensor. The random modes and the dropout draw
        from `generator`."""
        b, t, _ = x.shape
        nan_mask = ~torch.isnan(x).any(dim=-1)
        x = torch.where(nan_mask[..., None], x, 0.0)
        h = x @ self.input_fc.weight.t() + self.input_fc.bias
        if isinstance(mask, str) and mask == "auto":
            mask = "binomial" if train else "all_true"
        m = make_mask(mask, b, t, generator, x.device) & nan_mask
        h = torch.where(m[..., None], h, 0.0)
        for blk in self.feature_extractor.net:
            h = blk.run(h)
        return dropout(h, repr_dropout_p, train, generator)
