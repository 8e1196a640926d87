"""MLP binary classifier: Flatten, Linear+BatchNorm+LeakyReLU stacks,
dropout, a Linear head.

Port of vq_vae_transformer_arc_welding_tpu/models/mlp.py (`MLP`: hparams,
init, `apply` in eval and in train mode, the `compute_dtype` runtime
option). Attribute paths are the reference's (model/mlp.py,
tests/torch_twins.py::TwinMLP): `layers.{3i}.*` the Linear of stack i,
`layers.{3i+1}.*` its BatchNorm1d, `layers.{3i+2}` its LeakyReLU, then
the Dropout and the head `layers.{3n+1}.*` for n stacks.

As the VQ-VAE, the training forward normalizes each BatchNorm by the
batch and returns the new running statistics under their state_dict
keys, which `commit_state` writes; dropout draws from the caller's
torch.Generator. compute_dtype=torch.bfloat16 rounds every matmul's
inputs to bf16 and sums them in f32 (ops/precision.py); BatchNorm, the
activation and the logits stay f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import batch_norm_apply, batch_norm_train
from ..ops.precision import check_compute_dtype, matmul_f32
from ..utils.random import dropout
from .base import BatchNormParams, Checkpointed, Params, assign, bn_state
from .initializers import torch_linear


def linear_stacks(widths: list, out: int, p: float, device) -> nn.ModuleList:
    """[Linear, BatchNorm1d, LeakyReLU] for each step of `widths`, then
    Dropout and the Linear head: the reference's `layers` list."""
    layers = []
    for fan_in, fan_out in zip(widths[:-1], widths[1:]):
        layers += [Params(device, weight=(fan_out, fan_in), bias=(fan_out,)),
                   BatchNormParams(fan_out, device), nn.LeakyReLU()]
    layers += [nn.Dropout(p),
               Params(device, weight=(out, widths[-1]), bias=(out,))]
    return nn.ModuleList(layers)


def init_linear_stacks(layers: nn.ModuleList, gen: torch.Generator) -> None:
    """torch.nn.Linear's default init for every Linear of the list, in
    order; BatchNorms at unit scale and zero shift."""
    for m in layers:
        if isinstance(m, Params) and not isinstance(m, BatchNormParams):
            w, b = torch_linear(gen, m.weight.shape[1], m.weight.shape[0])
            assign(m.weight, w), assign(m.bias, b)


def run_linear_stacks(layers: nn.ModuleList, x: torch.Tensor, *,
                      train: bool, generator, dropout_p: float,
                      compute_dtype=None):
    """(logits, the BatchNorms' new state under `layers.{i}.*` keys,
    empty in eval) of a flat (B, F) input."""
    new = {}
    n_stacks = (len(layers) - 2) // 3
    for s in range(n_stacks):
        lin, bn = layers[3 * s], layers[3 * s + 1]
        x = matmul_f32(x, lin.weight.t(), compute_dtype) + lin.bias
        if train:
            x, (mean, var) = batch_norm_train(
                x, bn.weight, bn.bias, bn.running_mean, bn.running_var)
            new.update(bn_state(bn, f"layers.{3 * s + 1}", mean, var))
        else:
            x = batch_norm_apply(x, bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var)
        x = F.leaky_relu(x, 0.01)
    x = dropout(x, dropout_p, train, generator)
    head = layers[-1]
    return matmul_f32(x, head.weight.t(), compute_dtype) + head.bias, new


class MLP(Checkpointed, nn.Module):
    """hparams mirror the JAX MLP constructor; compute_dtype is a runtime
    option, not an hparam."""

    def __init__(self, input_size: int, output_size: int, in_dim: int,
                 hidden_sizes: int, n_hidden_layers: int = 4,
                 dropout_p: float = 0.1, learning_rate: float = 1e-3,
                 model_id: str = "", *, compute_dtype=None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        check_compute_dtype(compute_dtype)
        self.input_size = input_size
        self.output_size = output_size
        self.in_dim = in_dim
        self.hidden_sizes = hidden_sizes
        self.n_hidden_layers = n_hidden_layers
        self.dropout_p = dropout_p
        self.learning_rate = learning_rate
        self.model_id = model_id
        self.compute_dtype = compute_dtype
        self.hparams = dict(input_size=input_size, output_size=output_size,
                            in_dim=in_dim, hidden_sizes=hidden_sizes,
                            n_hidden_layers=n_hidden_layers,
                            dropout_p=dropout_p, learning_rate=learning_rate,
                            model_id=model_id)
        widths = ([input_size * in_dim]
                  + [hidden_sizes] * (n_hidden_layers + 1))
        self.layers = linear_stacks(widths, output_size, dropout_p, device)
        if generator is not None:
            init_linear_stacks(self.layers, generator)

    def apply(self, x: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None):
        """x (B, ...) -> (logits (B, output_size), new BN state)."""
        return run_linear_stacks(
            self.layers, x.reshape(x.shape[0], -1).float(), train=train,
            generator=generator, dropout_p=self.dropout_p,
            compute_dtype=self.compute_dtype)

    forward = apply
