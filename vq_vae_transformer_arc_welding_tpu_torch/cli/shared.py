"""Shared CLI plumbing (parity with reference utils.py:8-42).

Port of vq_vae_transformer_arc_welding_tpu/cli/shared.py: checkpoint
loading by content, split ids, the latent data module's factory, the
training CLIs' input-shape log and summary push, and the device a CLI
runs on.
"""
from __future__ import annotations

import logging as log
import os

import torch

from ..data.latent import LatentPredDataModule
from ..data.splits import DataSplitId
from ..models.base import serving_device
from ..train.checkpoint import is_port_checkpoint, read_payload


def cli_device(device: str | None) -> torch.device:
    """The device a training CLI runs on: `--device`, else the CUDA
    device. Raises RuntimeError when that is a CUDA device and the host
    has none: nothing falls back to the CPU unasked."""
    dev = serving_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: this host has no CUDA device; pass --device cpu "
            f"to run on the CPU")
    return dev


def print_training_input_shape(data_module):
    if data_module.train is None:
        data_module.setup("fit")
    sp = data_module.val
    for i, arr in enumerate((sp.x, sp.y, sp.cond)):
        if arr is not None:
            log.info(f"Input {i} shape: {arr.shape} type: {arr.dtype}")


def load_vqvae_any(model_path: str, device=None, vq_impl: str = "xla"):
    """Load a VQ-VAE checkpoint, this package's or a reference Lightning
    .ckpt, told apart by content (this package's names its model and
    format version). Returns a VQVAEPatch on the serving device."""
    from ..models.vqvae_patch import VQVAEPatch
    if is_port_checkpoint(read_payload(model_path)):
        return VQVAEPatch.load(model_path, device=device, vq_impl=vq_impl)
    from ..train.torch_import import load_vqvae_checkpoint
    return load_vqvae_checkpoint(model_path, device=device, vq_impl=vq_impl)


def load_transformer_any(model_path: str, device=None,
                         attention_impl: str = "xla"):
    """The same for a TransformerDecoder checkpoint."""
    from ..models.transformer import TransformerDecoder
    if is_port_checkpoint(read_payload(model_path)):
        return TransformerDecoder.load(model_path, device=device,
                                       attention_impl=attention_impl)
    from ..train.torch_import import load_transformer_checkpoint
    return load_transformer_checkpoint(model_path, device=device,
                                       attention_impl=attention_impl)


def get_metadata_and_artifact_dir(model_name: str):
    """Download a model artifact from wandb and parse its model name
    (parity: reference latentspace_dataloader.py:266-291). Requires the
    wandb package and an active run; raises ImportError otherwise."""
    try:
        import wandb
    except ImportError as e:
        raise ImportError("wandb is not installed; pass a local checkpoint "
                          "path instead of a wandb artifact link") from e
    artifact_dir = f"./artifacts/{model_name.split('/')[-1]}"
    artifact = wandb.use_artifact(model_name, type="model")
    if not os.path.exists(artifact_dir):
        artifact_dir = artifact.download()
    original = artifact.metadata["original_filename"]
    parts = original.split("-")
    if parts[:3] == ["VQ", "VAE", "Patch"]:
        parsed = "VQ-VAE-Patch"
    elif parts[0] == "VQ":
        parsed = f"{parts[0]}-{parts[1]}"
    else:
        raise ValueError(f"Model name: {model_name} not supported.")
    return parsed, artifact_dir + "/model.ckpt"


def get_latent_dataloader(use_wandb: bool, n_cycles: int, model_path: str,
                          val_ids: list[DataSplitId],
                          test_ids: list[DataSplitId], batch_size: int,
                          task: str,
                          data_directory_path: str | None = None,
                          device=None):
    """Build the latent data module over a frozen VQ-VAE checkpoint
    (reference utils.py:16-42), the model on `device` (the card when it
    is None). Returns (datamodule, config)."""
    if use_wandb:
        model_id = model_path.split("-")[-1]
        _, model_path = get_metadata_and_artifact_dir(model_path)
    else:
        model_id = model_path.split("/")[-1]
    model = load_vqvae_any(model_path, device=device)

    dm = LatentPredDataModule(
        model, task=task, n_cycles=n_cycles,
        val_data_ids=val_ids, test_data_ids=test_ids,
        model_name="VQ-VAE-Patch", model_id=model_id, batch_size=batch_size,
        data_directory_path=data_directory_path)
    config = {
        "num_embeddings": model.num_embeddings,
        "patch_size": int(model.patch_size),
        "latent_dim": model.embedding_dim * model.enc_out_len,
    }
    return dm, config


def parse_split_ids(pairs):
    return [DataSplitId(experiment=e, welding_run=w) for e, w in pairs]


def push_summary(logger, logdict: dict):
    """Final summary metrics push (reference
    train_classification_model.py:157-171)."""
    logger.log_metrics(logdict)
    logger.finalize()
