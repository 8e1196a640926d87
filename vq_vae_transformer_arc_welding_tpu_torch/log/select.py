"""Logger selection shared by the three CLI entry points (mirrors the
per-script selection blocks, e.g. train_reconstruction_embedding.py:141-153).

Port of vq_vae_transformer_arc_welding_tpu/log/select.py."""
from __future__ import annotations

from ..utils.names import generate_funny_name
from .csv import CSVLogger


def select_logger(*, use_wandb: bool = False, use_mlflow: bool = False,
                  logging_entity: str | None = None,
                  logging_project: str | None = None,
                  mlflow_url: str | None = None, tags: dict | None = None,
                  csv_name: str = "vq-vae-transformer"):
    if use_wandb:
        assert logging_entity is not None, "Wandb entity must be set"
        assert logging_project is not None, "Wandb project must be set"
        from .wandb import WandbLogger
        return WandbLogger(project=logging_project, entity=logging_entity)
    if use_mlflow:
        assert logging_project is not None, "MLflow project must be set"
        assert mlflow_url is not None, "MLflow URL must be set"
        from .mlflow import MLFlowLogger
        return MLFlowLogger(experiment_name=logging_project,
                            tracking_uri=mlflow_url,
                            run_name=generate_funny_name(), tags=tags)
    return CSVLogger("logs", name=csv_name)
