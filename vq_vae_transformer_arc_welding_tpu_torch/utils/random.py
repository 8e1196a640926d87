"""Dropout on an explicit generator.

Port of vq_vae_transformer_arc_welding_tpu/utils/random.py (`dropout`).
The JAX package draws each mask from a key; here it comes from a
torch.Generator on the tensor's device (Philox on the card), never from
the global RNG, so that a training run decides every draw: the trainer
seeds one per epoch from (seed, epoch), and a resumed run draws what the
uninterrupted one drew. jax.random and torch draw different bits from
one seed; the distribution is the same.

A slice of a larger tensor draws the larger tensor's mask and keeps its
own part of it (`parts`, and the data shard of a data-parallel step,
parallel/shard.py): a rank then drops what the one process holding the
whole tensor drops, and the ranks' generators stay in step.
"""
from __future__ import annotations

import torch


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: torch.Generator | None,
            parts: tuple = ()) -> torch.Tensor:
    """Inverted dropout, as torch.nn.Dropout: at train time each element
    is kept with probability 1 - p and scaled by 1 / (1 - p); the
    identity otherwise. A draw needs a generator on x's device.
    parts: (dim, index, count) triples: x is slice `index` of `count`
    equal slices along `dim` of the tensor whose mask is drawn (a
    tensor-parallel rank's heads). Inside a data-parallel step x is
    also its rank's slice of the batch (dim 0)."""
    if not train or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout at train time needs a torch.Generator")
    from ..parallel.shard import active
    shard = active()
    if shard is not None:
        parts = ((0, shard.index, shard.count), *parts)
    keep = 1.0 - p
    if parts:
        shape = list(x.shape)
        for dim, _, count in parts:
            shape[dim] *= count
        mask = torch.empty(shape, dtype=x.dtype, device=x.device)
        mask.bernoulli_(keep, generator=generator)
        for dim, index, _ in parts:
            mask = mask.narrow(dim, index * x.shape[dim], x.shape[dim])
    else:
        mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return torch.where(mask.bool(), x / keep, 0.0)
