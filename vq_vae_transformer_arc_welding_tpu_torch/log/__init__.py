"""Loggers of the training CLIs (port of vq_vae_transformer_arc_welding_tpu/log/):
CSV by default, wandb and MLflow behind lazy imports."""
from .csv import CSVLogger
from .mlflow import MLFlowLogger
from .select import select_logger
from .wandb import WandbLogger
