"""Logger protocol (parity with the reference's interchangeable
Lightning loggers — CSV default, wandb, MLflow; SURVEY.md §5).

Port of vq_vae_transformer_arc_welding_tpu/log/base.py."""
from __future__ import annotations


class Logger:
    def log_hyperparams(self, params: dict):
        raise NotImplementedError

    def log_metrics(self, metrics: dict, step: int | None = None):
        raise NotImplementedError

    def log_artifact(self, path: str, name: str | None = None,
                     type_: str = "model"):
        """Upload a file artifact (checkpoints on best/last save, parity
        with the reference's log_model=True loggers,
        train_reconstruction_embedding.py:144,150). Remote adapters
        override; file-based loggers (CSV) no-op."""

    def finalize(self, status: str = "success"):
        pass
