"""Task adapters: a model bound to its loss, metrics and batch layout.

Port of vq_vae_transformer_arc_welding_tpu/train/tasks.py (`Task`,
`ReconstructionTask`, `ClassificationTask`, `TransformerGenTask`,
`TransformerClassTask`); metric names are the reference's, the class
task's under `cl/`.

`batch_arrays(split)` puts a split's arrays on the model's device once;
the trainer then gathers every batch there. A data/windowed.WindowedArray
goes to the device as it is (its cycles and window starts), so that the
trainer's gather by index takes the windows there. `loss_and_metrics(batch, *,
train, generator)` returns (loss, {name: 0-d tensor}, new state): the
BatchNorm running statistics the step would leave (the VQ-VAE's, under
their state_dict keys), which the trainer commits.
"""
from __future__ import annotations

import torch

import numpy as np

from ..data.windowed import WindowedArray
from .metrics import classification_metrics, cross_entropy


class Task:
    """Interface: batch_arrays(split), loss_and_metrics(batch, ...)."""
    model = None
    weighted_sampler = False

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def batch_arrays(self, split) -> tuple:
        raise NotImplementedError

    def loss_and_metrics(self, batch, *, train: bool, generator=None):
        raise NotImplementedError


def as_device_f32(x, device: torch.device):
    """An f32 tensor of x on `device`; a WindowedArray stays one, on
    `device`."""
    if isinstance(x, WindowedArray):
        return x.to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class ReconstructionTask(Task):
    """VQ-VAE training (reference autencoder_lightning_base.py:80-120)."""

    def __init__(self, model):
        self.model = model

    def batch_arrays(self, split) -> tuple:
        return (as_device_f32(split.x, self._device()),)

    def loss_and_metrics(self, batch, *, train: bool, generator=None):
        (x,) = batch
        loss, (metrics, new_state) = self.model.loss_fn(
            x, train=train, generator=generator)
        return loss, metrics, new_state


class ClassificationTask(Task):
    """MLP / GRU / MLPEmbedding binary classification (reference
    classification_model.py:85-152): cross entropy, the reference's
    metrics, weighted sampling. ids_input: the split's x are token ids,
    flattened per sample (MLPEmbedding on the classification_ids latent
    task)."""

    weighted_sampler = True

    def __init__(self, model, ids_input: bool = False):
        self.model = model
        self.ids_input = ids_input

    def batch_arrays(self, split) -> tuple:
        dev = self._device()
        if self.ids_input:
            x = torch.as_tensor(split.x, dtype=torch.int64, device=dev)
            x = x.reshape(x.shape[0], -1)
        else:
            x = as_device_f32(split.x, dev)
        return x, torch.as_tensor(split.y, dtype=torch.int64, device=dev)

    def loss_and_metrics(self, batch, *, train: bool, generator=None):
        x, y = batch
        logits, new_state = self.model.apply(x, train=train,
                                             generator=generator)
        loss = cross_entropy(logits, y)
        metrics = {"loss": loss, **classification_metrics(logits, y)}
        return loss, metrics, new_state


class _TransformerTask(Task):

    def __init__(self, model):
        self.model = model

    def batch_arrays(self, split) -> tuple:
        dev = self._device()
        return tuple(torch.as_tensor(a, dtype=torch.int64, device=dev)
                     for a in (split.x, split.cond, split.y))


class TransformerGenTask(_TransformerTask):
    """Next-token generation over latent ids (reference
    transformer_decoder.py:145-149)."""

    def loss_and_metrics(self, batch, *, train: bool, generator=None):
        x, _, y = batch
        logits = self.model.apply(x, train=train, generator=generator,
                                  generate=True)
        loss = self.model.loss_gen(logits, y)
        return loss, {"loss": loss}, {}


class TransformerClassTask(_TransformerTask):
    """Binary quality classification through the class head (reference
    transformer_decoder.py:151-167), metrics under the reference's `cl/`
    prefix. acc_good / acc_bad show a head stuck on one class."""

    weighted_sampler = True
    metric_namespace = "cl"

    def loss_and_metrics(self, batch, *, train: bool, generator=None):
        x, cond, _ = batch
        logits = self.model.apply(x, train=train, generator=generator,
                                  generate=False)
        loss = self.model.loss_class(logits, cond)
        m = classification_metrics(logits, cond)
        metrics = {"loss": loss, "acc": m["acc"], "f1_score": m["f1_score"],
                   "acc_good": m["acc_good"], "acc_bad": m["acc_bad"]}
        return loss, metrics, {}
