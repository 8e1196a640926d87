"""Weight initializers on an explicit torch.Generator.

Port of vq_vae_transformer_arc_welding_tpu/models/initializers.py
(`uniform`, `torch_linear_weight` and `torch_linear_bias` as
`torch_linear`, `xavier_conv1d`, `xavier_conv_transpose1d`,
`gpt2_linear`, `gpt2_embedding`, `gru_params`). The
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


def torch_linear(gen: torch.Generator, fan_in: int, fan_out: int):
    """torch.nn.Linear's default: weight (fan_out, fan_in) and bias, each
    U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return (uniform(gen, (fan_out, fan_in), bound),
            uniform(gen, (fan_out,), bound))


def gru_params(gen: torch.Generator, input_size: int, hidden: int) -> dict:
    """One torch GRU layer, every tensor U(+-1/sqrt(hidden)), under
    nn.GRU's names without the layer suffix."""
    bound = 1.0 / math.sqrt(hidden)
    return {"weight_ih": uniform(gen, (3 * hidden, input_size), bound),
            "weight_hh": uniform(gen, (3 * hidden, hidden), bound),
            "bias_ih": uniform(gen, (3 * hidden,), bound),
            "bias_hh": uniform(gen, (3 * hidden,), bound)}


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
