"""Parameter holders that give modules the reference's state_dict keys.

The JAX package keeps parameters in pytrees
(vq_vae_transformer_arc_welding_tpu/models/base.py); here they live in
nn.Modules whose attribute paths are the reference Lightning keys
(`patch_embed.proj.weight`, `transformer.h.0.attn.c_attn.weight`, ...),
so a reference state_dict loads by name. The computation does not go
through nn.Conv1d / nn.Linear forwards: the forward paths are the ops
of this package. Tensors are allocated uninitialized; models fill them
from a torch.Generator.
"""
from __future__ import annotations

import torch
from torch import nn


class Params(nn.Module):
    """Named parameters, e.g. Params(weight=(O, I, k), bias=(O,))."""

    def __init__(self, device=None, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, device=device),
                                   requires_grad=False))


class Node(nn.Module):
    """A level of the key path, e.g. Node(proj=Params(...)) -> `proj.*`."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class BatchNormParams(Params):
    """BatchNorm1d's affine parameters and running statistics."""

    def __init__(self, ch: int, device=None):
        super().__init__(device=device, weight=(ch,), bias=(ch,))
        self.register_buffer("running_mean", torch.zeros(ch, device=device))
        self.register_buffer("running_var", torch.ones(ch, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


def serving_device(device=None) -> torch.device:
    """The device an entry point builds on: the one asked for, else the
    card. Without a card the allocation that follows raises; nothing
    carries on on the CPU unasked."""
    return torch.device("cuda" if device is None else device)


def assign(param: torch.Tensor, value: torch.Tensor) -> None:
    """Copy a CPU-drawn initial value into a parameter on its device."""
    with torch.no_grad():
        param.copy_(value)
