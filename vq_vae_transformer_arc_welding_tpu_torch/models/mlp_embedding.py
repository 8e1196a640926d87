"""Token-id MLP classifier: an Embedding(256, 16) over codebook ids,
flattened into MLP's Linear+BatchNorm+LeakyReLU stacks.

Port of vq_vae_transformer_arc_welding_tpu/models/mlp_embedding.py
(`MLPEmbedding`, `EMBED_DIM`, `VOCAB`; reference model/mlp_embedding.py).
Keys: `embedding.weight`, then `layers.*` as models/mlp.py. Pairs with
the `classification_ids` latent task (`ClassificationTask(ids_input=
True)`). The embedding's initial rows are N(0, 1), nn.Embedding's.
"""
from __future__ import annotations

import torch
from torch import nn

from .base import Checkpointed, Params, assign
from .mlp import init_linear_stacks, linear_stacks, run_linear_stacks

EMBED_DIM = 16
VOCAB = 256


class MLPEmbedding(Checkpointed, nn.Module):
    """hparams mirror the JAX MLPEmbedding constructor."""

    def __init__(self, input_size: int, output_size: int, in_dim: int,
                 hidden_sizes: int, n_hidden_layers: int = 4,
                 dropout_p: float = 0.1, learning_rate: float = 1e-3,
                 model_id: str = "", *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.in_dim = in_dim
        self.hidden_sizes = hidden_sizes
        self.n_hidden_layers = n_hidden_layers
        self.dropout_p = dropout_p
        self.learning_rate = learning_rate
        self.model_id = model_id
        self.hparams = dict(input_size=input_size, output_size=output_size,
                            in_dim=in_dim, hidden_sizes=hidden_sizes,
                            n_hidden_layers=n_hidden_layers,
                            dropout_p=dropout_p, learning_rate=learning_rate,
                            model_id=model_id)
        self.embedding = Params(device, weight=(VOCAB, EMBED_DIM))
        widths = ([EMBED_DIM * in_dim * input_size]
                  + [hidden_sizes] * (n_hidden_layers + 1))
        self.layers = linear_stacks(widths, output_size, dropout_p, device)
        if generator is not None:
            assign(self.embedding.weight,
                   torch.empty(VOCAB, EMBED_DIM).normal_(generator=generator))
            init_linear_stacks(self.layers, generator)

    def apply(self, x_ids: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None):
        """x_ids (B, ...) int -> (logits (B, output_size), new BN state)."""
        x = self.embedding.weight[x_ids.long()]
        return run_linear_stacks(
            self.layers, x.reshape(x.shape[0], -1), train=train,
            generator=generator, dropout_p=self.dropout_p)

    forward = apply
