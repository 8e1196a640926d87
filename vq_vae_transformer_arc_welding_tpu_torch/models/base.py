"""Parameter holders that give modules the reference's state_dict keys.

The JAX package keeps parameters in pytrees
(vq_vae_transformer_arc_welding_tpu/models/base.py); here they live in
nn.Modules whose attribute paths are the reference Lightning keys
(`patch_embed.proj.weight`, `transformer.h.0.attn.c_attn.weight`, ...),
so a reference state_dict loads by name. The computation does not go
through nn.Conv1d / nn.Linear forwards: the forward paths are the ops
of this package. Tensors are allocated uninitialized; models fill them
from a torch.Generator.
"""
from __future__ import annotations

import re

import torch
from torch import nn


class Params(nn.Module):
    """Named parameters, e.g. Params(weight=(O, I, k), bias=(O,))."""

    def __init__(self, device=None, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, device=device),
                                   requires_grad=False))


class Node(nn.Module):
    """A level of the key path, e.g. Node(proj=Params(...)) -> `proj.*`."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class BatchNormParams(Params):
    """BatchNorm1d's affine parameters and running statistics."""

    def __init__(self, ch: int, device=None):
        super().__init__(device=device, weight=(ch,), bias=(ch,))
        self.register_buffer("running_mean", torch.zeros(ch, device=device))
        self.register_buffer("running_var", torch.ones(ch, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


def bn_state(bn: BatchNormParams, prefix: str, mean, var) -> dict:
    """A BatchNorm's new running state under its state_dict keys, with
    the batch count BatchNorm1d keeps beside it."""
    return {f"{prefix}.running_mean": mean, f"{prefix}.running_var": var,
            f"{prefix}.num_batches_tracked": bn.num_batches_tracked + 1}


def serving_device(device=None) -> torch.device:
    """The device an entry point builds on: the one asked for, else the
    card. Without a card the allocation that follows raises; nothing
    carries on on the CPU unasked."""
    return torch.device("cuda" if device is None else device)


def assign(param: torch.Tensor, value: torch.Tensor) -> None:
    """Copy a CPU-drawn initial value into a parameter on its device."""
    with torch.no_grad():
        param.copy_(value)


def load_state_dict_checked(module: nn.Module, sd: dict,
                            skipped: re.Pattern | None = None) -> None:
    """`load_state_dict` that names what it lets pass: keys of `sd` that
    match `skipped` are left out, and any other unexpected or missing
    key raises KeyError."""
    if skipped is not None:
        sd = {k: v for k, v in sd.items() if not skipped.match(k)}
    missing, unexpected = module.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {list(missing)}, "
                       f"unexpected {list(unexpected)}")


class Checkpointed:
    """`save` / `load` of a model through train/checkpoint.py (the JAX
    package's `Module.save` / `Module.load`). A subclass has `hparams`,
    its constructor's keyword arguments; runtime options (`vq_impl`,
    `attention_impl`, `compute_dtype`) are not hparams and are given to
    `load` again."""

    hparams: dict

    def save(self, path: str, extra: dict | None = None,
             optimizer=None) -> None:
        """optimizer: a train/optim.TrainOptimizer whose state (moments,
        step counts, the scheduler's) goes into the file beside the
        weights, as the trainer's last checkpoint carries it."""
        from ..train.checkpoint import save_checkpoint
        opt, sched = ((None, None) if optimizer is None
                      else optimizer.state_dicts())
        save_checkpoint(path, type(self).__name__, self.hparams,
                        self.state_dict(), extra, optimizer_state=opt,
                        scheduler_state=sched)

    @torch.no_grad()
    def commit_state(self, new_state: dict) -> None:
        """Write the state a training forward returned (BatchNorm running
        statistics, the EMA VQ's codebook) into the buffers it names."""
        for name, value in new_state.items():
            self.get_buffer(name).copy_(value)

    @classmethod
    def load(cls, path: str, device=None, **runtime):
        """The model of a file written by `save`, in eval mode on
        `device`: the card when it is None (and an error where there is
        none). Raises ValueError on another model's checkpoint."""
        from ..train.checkpoint import load_checkpoint
        name, hparams, sd, _ = load_checkpoint(path)
        if name != cls.__name__:
            raise ValueError(f"checkpoint is for {name}, not {cls.__name__}")
        model = cls(**hparams, **runtime, device=serving_device(device))
        load_state_dict_checked(model, sd)
        return model.eval()
