"""CSV logger with Lightning CSVLogger's on-disk layout
(save_dir/name/version_N/{metrics.csv,hparams.json}) so downstream
tooling that reads the reference's logs keeps working.

Port of vq_vae_transformer_arc_welding_tpu/log/csv.py: given the same
calls, it writes the same bytes."""
from __future__ import annotations

import csv
import json
import os

from .base import Logger


class CSVLogger(Logger):
    def __init__(self, save_dir: str = "logs", name: str = "vq-vae-transformer"):
        self.save_dir = save_dir
        self.name = name
        base = os.path.join(save_dir, name)
        os.makedirs(base, exist_ok=True)
        existing = [int(d.split("_")[1]) for d in os.listdir(base)
                    if d.startswith("version_") and d.split("_")[1].isdigit()]
        self.version = max(existing, default=-1) + 1
        self.log_dir = os.path.join(base, f"version_{self.version}")
        os.makedirs(self.log_dir, exist_ok=True)
        self._rows: list[dict] = []
        self._keys: list[str] = []
        self._hparams: dict = {}

    def log_hyperparams(self, params: dict):
        self._hparams.update(params)
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump(self._hparams, f, indent=2, default=str)

    def log_metrics(self, metrics: dict, step: int | None = None):
        row = {k: float(v) for k, v in metrics.items()}
        if step is not None:
            row["step"] = step
        self._rows.append(row)
        for k in row:
            if k not in self._keys:
                self._keys.append(k)
        self._flush()

    def _flush(self):
        path = os.path.join(self.log_dir, "metrics.csv")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._keys)
            w.writeheader()
            w.writerows(self._rows)

    @property
    def experiment(self):
        return self

    def log_metrics_dict(self, d):  # convenience for summary dicts
        self.log_metrics(d)
