"""Weights & Biases adapter (reference uses lightning's WandbLogger,
e.g. train_reconstruction_embedding.py:144). Imported lazily; raises a
clear error when the wandb package isn't installed.

Port of vq_vae_transformer_arc_welding_tpu/log/wandb.py: the same calls
on the package."""
from __future__ import annotations

import os

from .base import Logger


class WandbLogger(Logger):
    def __init__(self, project: str, entity: str | None = None,
                 log_model: bool = True, run_name: str | None = None):
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "wandb is not installed in this environment; use the CSV "
                "logger (default) or MLflow instead") from e
        self._wandb = wandb
        self.run = wandb.init(project=project, entity=entity, name=run_name)
        self.log_model = log_model

    def log_hyperparams(self, params: dict):
        self.run.config.update(params, allow_val_change=True)

    def log_metrics(self, metrics: dict, step: int | None = None):
        self.run.log(metrics, step=step)

    def log_artifact(self, path: str, name: str | None = None,
                     type_: str = "model"):
        art = self._wandb.Artifact(name or os.path.basename(path),
                                   type=type_)
        art.add_file(path)
        self.run.log_artifact(art)

    def finalize(self, status: str = "success"):
        self.run.finish()

    @property
    def experiment(self):
        return self.run
