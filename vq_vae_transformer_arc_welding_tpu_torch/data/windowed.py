"""Sliding windows over packed welding cycles, gathered by index.

Port of vq_vae_transformer_arc_welding_tpu/data/windowed.py
(`WindowedArray`, `window_counts`, `fit_scaler_on_windows`). The
materialized path copies every n-cycle window into a dense array, an
n_cycles-fold duplication of every cycle on the host and, once the
trainer puts a split on the card, in device memory. A `WindowedArray`
keeps the packed (N, window, C) cycles once plus a table of window
starts, and indexing it with a batch's indices gathers that batch's
windows: on the host over numpy arrays, and on the card once a task has
moved it there (`to`), where the trainer gathers every batch by index
without materializing the split. The batches are bit-identical to the
materialized path's (the same values, the same scaling).
"""
from __future__ import annotations

import numpy as np
import torch


class WindowedArray:
    """cycles: (N, window, C) scaled cycles; starts: (M,) window starts
    (window i = cycles[starts[i] : starts[i] + seq_len]); both numpy
    arrays or both tensors of one device. Indexing with indices or a
    slice gives (B, seq_len * window, C) of the same kind."""

    def __init__(self, cycles, starts, seq_len: int):
        self.cycles = cycles
        self.starts = starts
        self.seq_len = int(seq_len)

    def __len__(self) -> int:
        return int(self.starts.shape[0])

    @property
    def shape(self) -> tuple:
        _, w, c = self.cycles.shape
        return (len(self), self.seq_len * w, c)

    @property
    def dtype(self):
        return self.cycles.dtype

    def to(self, device, dtype=torch.float32) -> "WindowedArray":
        """The same windows with cycles and starts as tensors on
        `device` (cycles in `dtype`)."""
        return WindowedArray(
            torch.as_tensor(self.cycles, dtype=dtype, device=device),
            torch.as_tensor(self.starts, dtype=torch.int64, device=device),
            self.seq_len)

    def __getitem__(self, idx):
        s = self.starts[idx]
        if isinstance(self.cycles, torch.Tensor):
            rows = s[:, None] + torch.arange(self.seq_len, device=s.device)
        else:
            rows = np.asarray(s)[:, None] + np.arange(self.seq_len)
        w = self.cycles[rows]                               # (B, s, w, C)
        return w.reshape(w.shape[0], self.seq_len * w.shape[2], w.shape[3])

    def materialize(self) -> np.ndarray:
        """All windows as one host array (for tests and interop)."""
        out = self[np.arange(len(self))]
        return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


def window_counts(n_cycles_total: int, seq_len: int) -> np.ndarray:
    """How many sliding windows contain each cycle (windows i in
    [0, N - seq_len), window i covers cycles [i, i + seq_len))."""
    n = n_cycles_total - seq_len
    j = np.arange(n_cycles_total)
    i_min = np.maximum(0, j - seq_len + 1)
    i_max = np.minimum(n - 1, j)
    return np.maximum(0, i_max - i_min + 1).astype(np.int64)


def fit_scaler_on_windows(scaler, cycles: np.ndarray, seq_len: int):
    """Fit the per-channel mean and std exactly as a fit on the
    materialized windows would (each cycle weighted by the number of
    windows that hold it: reference asimow_dataloader.py:174-177 fits on
    windows). cycles: (N, window, C), already cut to the window."""
    c = window_counts(cycles.shape[0], seq_len).astype(np.float64)
    x = cycles.astype(np.float64)
    total = c.sum() * cycles.shape[1]
    mean = np.einsum("n,ntc->c", c, x) / total
    e2 = np.einsum("n,ntc->c", c, x * x) / total
    scaler.mean_ = mean
    scale = np.sqrt(np.maximum(e2 - mean * mean, 0.0))
    scaler.scale_ = np.where(scale == 0.0, 1.0, scale)
    return scaler
