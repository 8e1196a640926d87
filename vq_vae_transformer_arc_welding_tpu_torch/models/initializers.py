"""Weight initializers on an explicit torch.Generator.

Port of vq_vae_transformer_arc_welding_tpu/models/initializers.py
(`uniform`, `xavier_conv1d`, `xavier_conv_transpose1d`, `gpt2_linear`,
`gpt2_embedding`). The
distributions are the JAX package's (and the reference's); the bits
are not, since jax.random and torch draw differently from one seed.
Tensors are drawn on the CPU, where the generator lives; modules copy
them to their device.

Layouts are torch's: conv weights (O, I, k), transposed-conv weights
(I, O, k), linear weights (out, in).
"""
from __future__ import annotations

import math

import torch


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def xavier_conv1d(gen: torch.Generator, out_ch: int, in_ch: int, k: int):
    """xavier_uniform weight (O, I, k) + zero bias; fans in_ch*k, out_ch*k."""
    bound = math.sqrt(6.0 / (in_ch * k + out_ch * k))
    return uniform(gen, (out_ch, in_ch, k), bound), torch.zeros(out_ch)


def xavier_conv_transpose1d(gen: torch.Generator, in_ch: int, out_ch: int,
                            k: int):
    """xavier_uniform weight (I, O, k) + zero bias (O,); torch's fans on
    the raw (I, O, k) tensor are O*k and I*k."""
    bound = math.sqrt(6.0 / (out_ch * k + in_ch * k))
    return uniform(gen, (in_ch, out_ch, k), bound), torch.zeros(out_ch)


def gpt2_linear(gen: torch.Generator, fan_in: int, fan_out: int,
                std: float = 0.02):
    """normal(0, std) weight (fan_out, fan_in) + zero bias."""
    w = torch.empty(fan_out, fan_in).normal_(0.0, std, generator=gen)
    return w, torch.zeros(fan_out)


def gpt2_embedding(gen: torch.Generator, num: int, dim: int,
                   std: float = 0.02) -> torch.Tensor:
    return torch.empty(num, dim).normal_(0.0, std, generator=gen)
