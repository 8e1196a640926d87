"""Embedding components: sinusoidal positions, token embedding with and
without a condition.

Port of vq_vae_transformer_arc_welding_tpu/models/embedding.py
(`positional_embedding`, `latent_embedding`, `latent_embedding_cond`;
reference model/embedding.py). The transformer embeds inline
(models/transformer.py); these are the standalone pieces, functions of
their tables.
"""
from __future__ import annotations

import torch

from .transformer import sinusoidal_pe


def positional_embedding(t: int, d_model: int, max_len: int = 5000,
                         device=None) -> torch.Tensor:
    """(1, t, d_model) slice of the fixed sin/cos table."""
    return torch.as_tensor(sinusoidal_pe(max_len, d_model),
                           device=device)[None, :t]


def latent_embedding(ids: torch.Tensor, tok_table: torch.Tensor, *,
                     max_len: int = 512) -> torch.Tensor:
    """Token embedding + sinusoidal positions. ids (B, T) int;
    tok_table (vocab, d)."""
    t, d = ids.shape[1], tok_table.shape[1]
    return tok_table[ids.long()] + positional_embedding(
        t, d, max_len, device=tok_table.device)


def latent_embedding_cond(ids: torch.Tensor, cond: torch.Tensor,
                          tok_table: torch.Tensor, cond_table: torch.Tensor,
                          *, max_len: int = 512) -> torch.Tensor:
    """Token + positions + the condition's embedding broadcast over T."""
    x = latent_embedding(ids, tok_table, max_len=max_len)
    return x + cond_table[cond.long()][:, None, :]
