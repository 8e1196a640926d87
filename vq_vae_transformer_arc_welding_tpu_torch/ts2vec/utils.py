"""TS2Vec array utilities on numpy.

Port of vq_vae_transformer_arc_welding_tpu/ts2vec/utils.py (`pad_nan`,
`pad_nan_to_target`, `split_with_nan`, `take_per_row`,
`centerize_vary_length_series`, `data_dropout`), the same numpy code:
the crops and the padding happen on the host before a batch goes to
the device.
"""
from __future__ import annotations

import numpy as np


def pad_nan(arr: np.ndarray, left: int = 0, right: int = 0, axis: int = 0):
    """NaN-pad along an axis (reference torch_pad_nan, utils.py:16-25)."""
    if left <= 0 and right <= 0:
        return arr
    npad = [(0, 0)] * arr.ndim
    npad[axis] = (max(left, 0), max(right, 0))
    return np.pad(arr, npad, constant_values=np.nan)


def pad_nan_to_target(array, target_length, axis=0, both_side=False):
    pad_size = target_length - array.shape[axis]
    if pad_size <= 0:
        return array
    npad = [(0, 0)] * array.ndim
    npad[axis] = ((pad_size // 2, pad_size - pad_size // 2) if both_side
                  else (0, pad_size))
    return np.pad(array, npad, constant_values=np.nan)


def split_with_nan(x, sections, axis=0):
    arrs = np.array_split(x, sections, axis=axis)
    target = arrs[0].shape[axis]
    return [pad_nan_to_target(a, target, axis=axis) for a in arrs]


def take_per_row(a: np.ndarray, indx: np.ndarray, num_elem: int):
    """Per-row window gather (reference utils.py:47-49).
    a: (B, T, ...); indx: (B,) start per row; returns (B, num_elem, ...)."""
    all_indx = indx[:, None] + np.arange(num_elem)
    return a[np.arange(all_indx.shape[0])[:, None], all_indx]


def centerize_vary_length_series(x):
    """Center series that have NaN prefixes/suffixes (utils.py:51-58)."""
    prefix_zeros = np.argmax(~np.isnan(x).all(axis=-1), axis=1)
    suffix_zeros = np.argmax(~np.isnan(x[:, ::-1]).all(axis=-1), axis=1)
    offset = (prefix_zeros + suffix_zeros) // 2 - prefix_zeros
    rows, column_indices = np.ogrid[:x.shape[0], :x.shape[1]]
    offset[offset < 0] += x.shape[1]
    column_indices = column_indices - offset[:, np.newaxis]
    return x[rows, column_indices]


def data_dropout(arr, p, rng: np.random.Generator | None = None):
    """Randomly NaN out a fraction p of timestamps (utils.py:60-71)."""
    rng = rng or np.random.default_rng()
    b, t = arr.shape[0], arr.shape[1]
    mask = np.zeros(b * t, dtype=bool)
    sel = rng.choice(b * t, size=int(b * t * p), replace=False)
    mask[sel] = True
    res = arr.copy()
    res[mask.reshape(b, t)] = np.nan
    return res
