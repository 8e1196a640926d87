"""Array-backed dataset containers and label-side transforms.

Own copy of vq_vae_transformer_arc_welding_tpu/data/datasets.py.

The reference wraps numpy in torch Dataset classes
(dataloader/base_dataloader.py:14-110); here a split is just a named
tuple of packed numpy arrays; batching happens on the device in the
training loop (no worker processes, no per-item __getitem__).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ArraySplit(NamedTuple):
    """One split's packed arrays. y is labels for classification tasks,
    shifted targets for autoregressive tasks, or None."""
    x: np.ndarray
    y: np.ndarray | None = None
    cond: np.ndarray | None = None  # condition labels (autoregressive tasks)

    def __len__(self):
        return len(self.x)


def make_autoregressive(ids: np.ndarray, labels: np.ndarray | None) -> tuple[ArraySplit, int]:
    """Start/end-token shift for autoregressive latent modeling.

    [start, t0..tn-1] predicts [t0..tn-1, end]; start = max_token+1,
    end = max_token+2, num_classes = max_token+3 — derived from the
    *observed* max id, reproducing reference
    base_dataloader.py:74-110 (including its dead-code mismatch quirk
    vs the script-level num_embeddings+2, SURVEY.md §7).
    Returns (split, num_classes); split.cond is zeros when no labels.
    """
    ids = ids.astype(np.int64)
    max_token = int(ids.max())
    start, end = max_token + 1, max_token + 2
    n = len(ids)
    x = np.concatenate([np.full((n, 1), start, np.int64), ids], axis=1)
    y = np.concatenate([ids, np.full((n, 1), end, np.int64)], axis=1)
    cond = (labels.astype(np.int64) if labels is not None
            else np.zeros((n,), np.int64))
    return ArraySplit(x, y, cond), max_token + 3


def sampling_weights(labels: np.ndarray) -> np.ndarray:
    """Class-balancing weights for the weighted sampler (reference
    asimow_dataloader.py:106-121): minority class gets the majority's
    frequency and vice versa."""
    ratio = float(np.mean(labels == 0))
    w = np.zeros_like(labels, dtype=np.float32)
    w[labels == 0] = 1.0 - ratio
    w[labels == 1] = ratio
    return w


def shuffle_arrays(rng: np.random.Generator, *arrays):
    idx = rng.permutation(len(arrays[0]))
    return tuple(a[idx] if a is not None else None for a in arrays)


def shuffle_and_undersample(rng: np.random.Generator, x: np.ndarray,
                            y: np.ndarray):
    """Shuffle, then balance classes by undersampling the majority to
    the minority count (reference dataloader/utils.py:18-30)."""
    x, y = shuffle_arrays(rng, x, y)
    min_len = min(int(np.sum(y == 1)), int(np.sum(y == 0)))
    x_zeros = x[(y == 0).reshape(-1)][:min_len]
    x_ones = x[(y == 1).reshape(-1)][:min_len]
    x = np.concatenate([x_zeros, x_ones])
    y = np.concatenate([np.zeros(min_len, y.dtype), np.ones(min_len, y.dtype)])
    return shuffle_arrays(rng, x, y)
