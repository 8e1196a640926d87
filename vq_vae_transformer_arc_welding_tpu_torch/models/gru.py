"""GRU binary classifier: the windows as a sequence of in_dim features,
a stacked GRU from a zero state, its last step, dropout, a Linear head.

Port of vq_vae_transformer_arc_welding_tpu/models/gru.py (`GRU`: hparams,
init, `apply`). The recurrence is torch's `nn.GRU` (cuDNN's on the card;
the JAX package computes its GRU outside any Pallas kernel), with the
reference's keys `gru.{weight,bias}_{ih,hh}_l{k}` and `output_layer.*`
(tests/torch_twins.py::TwinGRU). The initial weights are drawn as the
JAX package's `initializers.gru_params` draws them: every tensor
U(+-1/sqrt(hidden)), and the head as torch.nn.Linear's default. The
JAX package's scan cell (ops/gru.py) has no counterpart here.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.random import dropout
from .base import Checkpointed, Params, assign
from .initializers import gru_params, torch_linear


class GRU(Checkpointed, nn.Module):
    """hparams mirror the JAX GRU constructor."""

    def __init__(self, input_size: int = 1, in_dim: int = 3,
                 output_size: int = 1, hidden_sizes: int = 64,
                 n_hidden_layers: int = 2, dropout_p: float = 0.2,
                 learning_rate: float = 1e-3, model_id: str = "", *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.input_size = input_size
        self.in_dim = in_dim
        self.output_size = output_size
        self.hidden_sizes = hidden_sizes
        self.n_hidden_layers = n_hidden_layers
        self.dropout_p = dropout_p
        self.learning_rate = learning_rate
        self.model_id = model_id
        self.hparams = dict(input_size=input_size, in_dim=in_dim,
                            output_size=output_size, hidden_sizes=hidden_sizes,
                            n_hidden_layers=n_hidden_layers,
                            dropout_p=dropout_p, learning_rate=learning_rate,
                            model_id=model_id)
        self.gru = nn.GRU(in_dim, hidden_sizes, n_hidden_layers,
                          batch_first=True, device=device)
        self.output_layer = Params(device, weight=(output_size, hidden_sizes),
                                   bias=(output_size,))
        # frozen until a Trainer turns the gradients on, as every model
        # of the port
        self.requires_grad_(False)
        if generator is not None:
            self.init_weights(generator)

    def init_weights(self, gen: torch.Generator) -> None:
        for k in range(self.n_hidden_layers):
            fan_in = self.in_dim if k == 0 else self.hidden_sizes
            for name, t in gru_params(gen, fan_in, self.hidden_sizes).items():
                assign(getattr(self.gru, f"{name}_l{k}"), t)
        w, b = torch_linear(gen, self.hidden_sizes, self.output_size)
        assign(self.output_layer.weight, w), assign(self.output_layer.bias, b)

    def apply(self, x: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None):
        """x (B, ...) -> (logits (B, output_size), {}): the GRU keeps no
        running state."""
        out, _ = self.gru(x.reshape(x.shape[0], -1, self.in_dim).float())
        h = dropout(out[:, -1, :], self.dropout_p, train, generator)
        head = self.output_layer
        return h @ head.weight.t() + head.bias, {}

    forward = apply
