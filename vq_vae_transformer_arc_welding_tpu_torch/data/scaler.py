"""Per-channel standard scaler (sklearn StandardScaler semantics).

Own copy of vq_vae_transformer_arc_welding_tpu/data/scaler.py: the
reference fits sklearn's StandardScaler on the flattened (N*T, C) train
split only and applies it everywhere (dataloader/utils.py:81-98,
asimow_dataloader.py:174-177). Same math here, in numpy on the host.
"""
from __future__ import annotations

import numpy as np


class StandardScaler:
    def __init__(self):
        self.mean_: np.ndarray | None = None
        self.scale_: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "StandardScaler":
        """x: (N, T, C): stats over all samples and timesteps per channel."""
        flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
        self.mean_ = flat.mean(axis=0)
        # sklearn uses the biased (population) std
        self.scale_ = flat.std(axis=0)
        self.scale_ = np.where(self.scale_ == 0.0, 1.0, self.scale_)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return ((x - self.mean_) / self.scale_).astype(np.float32)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return (x * self.scale_ + self.mean_).astype(np.float32)
