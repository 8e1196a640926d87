"""Checkpoint save/load with embedded hyperparameters.

Port of vq_vae_transformer_arc_welding_tpu/train/checkpoint.py
(`save_checkpoint`, `load_checkpoint`), the rebuild of Lightning's
ModelCheckpoint + save_hyperparameters contract: a single `.ckpt` file
carries the model class name, the constructor kwargs and all tensors,
so `Model.load(path)` reconstructs the module without external config.

The file is the port's own: `torch.save` of one dict in the Lightning
layout the modules already carry (`state_dict` under the reference
keys, `hyper_parameters`) plus the fields of the JAX format's header
(`model`, `extra`, `format_version`). It is written through a temporary
file and `os.replace`, and read with `weights_only=True`: tensors and
plain Python values only, no pickled code. The JAX package's msgpack
files are not read here; `bridge.py` carries weights across.

A checkpoint written by the trainer (`Trainer(save_last=True)`) also
carries the optimizer's `state_dict` and the learning-rate scheduler's
under Lightning's keys (`optimizer_states`, `lr_schedulers`), and the
epoch in `extra`; `Trainer.fit(resume_from=)` reads them back through
`load_training_state`. The sharded (orbax) backend is not ported
(multi-GPU, ROADMAP.md queue 1).
"""
from __future__ import annotations

import os

import torch

FORMAT_VERSION = 1


def save_checkpoint(path: str, model_name: str, hparams: dict,
                    state_dict: dict, extra: dict | None = None,
                    optimizer_state: dict | None = None,
                    scheduler_state: dict | None = None) -> None:
    """optimizer_state / scheduler_state: `state_dict()`s of a
    torch.optim optimizer and of its scheduler, or None."""
    payload = {
        "model": model_name,
        "hyper_parameters": dict(hparams),
        "extra": dict(extra or {}),
        "format_version": FORMAT_VERSION,
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
    }
    if optimizer_state is not None:
        payload["optimizer_states"] = [_to_cpu(optimizer_state)]
    if scheduler_state is not None:
        payload["lr_schedulers"] = [dict(scheduler_state)]
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _to_cpu(tree):
    """An optimizer state_dict with its tensors copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def read_payload(path: str) -> dict:
    """The dict a `.ckpt` file holds, this format's or a Lightning one's,
    tensors on the CPU. Raises ValueError on a file that is neither."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or "state_dict" not in payload:
        raise ValueError(f"{path}: no state_dict, not a checkpoint")
    return payload


def is_port_checkpoint(payload: dict) -> bool:
    return "format_version" in payload and "model" in payload


def load_checkpoint(path: str):
    """Returns (model_name, hparams, state_dict, extra) of a file written
    by `save_checkpoint`."""
    payload = read_payload(path)
    if not is_port_checkpoint(payload):
        raise ValueError(f"{path}: not a checkpoint of this package (no "
                         f"model name and format version)")
    if payload["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"{path}: checkpoint format {payload['format_version']} is newer "
            f"than this build supports ({FORMAT_VERSION})")
    return (payload["model"], dict(payload["hyper_parameters"]),
            payload["state_dict"], dict(payload.get("extra", {})))


def load_training_state(path: str):
    """(optimizer state_dict, scheduler state_dict or None, extra) of a
    file written with the optimizer's state; ValueError for a file
    without it."""
    payload = read_payload(path)
    if "optimizer_states" not in payload:
        raise ValueError(f"{path}: checkpoint carries no optimizer state")
    scheds = payload.get("lr_schedulers") or [None]
    return (payload["optimizer_states"][0], scheds[0],
            dict(payload.get("extra", {})))
