"""Dropout on an explicit generator.

Port of vq_vae_transformer_arc_welding_tpu/utils/random.py (`dropout`).
The JAX package draws each mask from a key; here it comes from a
torch.Generator on the tensor's device (Philox on the card), never from
the global RNG, so that a training run decides every draw: the trainer
seeds one per epoch from (seed, epoch), and a resumed run draws what the
uninterrupted one drew. jax.random and torch draw different bits from
one seed; the distribution is the same.
"""
from __future__ import annotations

import torch


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout, as torch.nn.Dropout: at train time each element
    is kept with probability 1 - p and scaled by 1 / (1 - p); the
    identity otherwise. A draw needs a generator on x's device."""
    if not train or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout at train time needs a torch.Generator")
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return torch.where(mask.bool(), x / keep, 0.0)
