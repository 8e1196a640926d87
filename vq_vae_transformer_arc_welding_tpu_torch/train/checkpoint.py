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
`load_training_state`.

The sharded backend (`save_checkpoint_sharded`,
`load_checkpoint_sharded`: JAX's `save_checkpoint_orbax` /
`load_checkpoint_orbax`) is a directory: `header.json` with JAX's keys
(`model`, `hparams`, `extra`, `format_version`, `backend`) and the
tensors under `arrays/` through torch.distributed.checkpoint, which
every rank of a mesh writes together, each its own shards. `params` is
a state_dict, `state` any tree of tensors (dicts, lists, NamedTuples
such as the EMA VQ's `EMAState`), which comes back in the template's
types. A tensor-parallel model's state_dict goes in through
`sharded_state_dict(model)`: its shards become DTensors over the
'model' group (c_attn viewed (3, C, C) so that a rank's heads are one
block of dim 1). Restored against such a template they come back as
the rank's shards; restored in one process against a dense template,
as the dense tensors.
"""
from __future__ import annotations

import json
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


# -- the sharded backend (torch.distributed.checkpoint) ----------------------

def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            _flatten(v, f"{prefix}{k}.", out)
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten(template, prefix: str, flat: dict):
    if isinstance(template, dict):
        return {k: _unflatten(v, f"{prefix}{k}.", flat)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        names = getattr(template, "_fields", range(len(template)))
        vals = [_unflatten(v, f"{prefix}{k}.", flat)
                for k, v in zip(names, template)]
        return (type(template)(*vals) if hasattr(template, "_fields")
                else type(template)(vals))
    if template is None:
        return None
    return flat[prefix[:-1]]


def _dcp_kwargs() -> dict:
    import torch.distributed as dist
    return {} if dist.is_available() and dist.is_initialized() else {
        "no_dist": True}


def save_checkpoint_sharded(path: str, model_name: str, hparams: dict,
                            params: dict, state=None,
                            extra: dict | None = None) -> None:
    """A directory checkpoint (module docstring); on a mesh every rank
    calls it, and rank 0 writes the header."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    flat = _flatten({"params": params, "state": state}, "", {})
    dcp.save(flat, checkpoint_id=os.path.join(path, "arrays"),
             **_dcp_kwargs())
    if not dist.is_initialized() or dist.get_rank() == 0:
        tmp = os.path.join(path, "header.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"model": model_name, "hparams": hparams,
                       "extra": extra or {}, "format_version": 1,
                       "backend": "torch.distributed.checkpoint"}, f)
        os.replace(tmp, os.path.join(path, "header.json"))
    if dist.is_initialized():
        dist.barrier()


def load_checkpoint_sharded(path: str, templates):
    """(header, params, state) of `save_checkpoint_sharded`'s directory,
    read into copies of `templates` = (params, state): their shapes,
    and their shardings where they are DTensors."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    with open(os.path.join(path, "header.json")) as f:
        header = json.load(f)
    t_params, t_state = templates
    tree = {"params": t_params, "state": t_state}
    flat = {k: _empty_like(v) for k, v in _flatten(tree, "", {}).items()}
    dcp.load(flat, checkpoint_id=os.path.join(path, "arrays"),
             **_dcp_kwargs())
    out = _unflatten(tree, "", flat)
    return header, out["params"], out["state"]


def _empty_like(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return DTensor.from_local(torch.empty_like(t.to_local()),
                                  t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return torch.empty_like(t)


def _dtensor_mesh(tp, device):
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(tp.group)
    return DeviceMesh.from_group(tp.group, device.type,
                                 mesh=torch.tensor(ranks),
                                 mesh_dim_names=("model",))


def sharded_state_dict(model) -> dict:
    """model.state_dict() for `save_checkpoint_sharded`, in the one
    layout every writer stores (`dense_view`: each c_attn viewed (3, C,
    ...)), a tensor-parallel model's shards as DTensors over its 'model'
    group: a reader needs no knowledge of how the writer was split."""
    sd = dense_view(model.state_dict())
    tp = getattr(model, "tp", None)
    if tp is None:
        return sd
    from torch.distributed.tensor import DTensor, Shard
    mesh = None
    out = {}
    for k, v in sd.items():
        how = tp.placement(k)
        if how is None:
            out[k] = v
            continue
        mesh = mesh or _dtensor_mesh(tp, v.device)
        dim = {"heads": 1, "column": 0, "row": 1}[how]
        out[k] = DTensor.from_local(v, mesh, [Shard(dim)], run_check=False)
    return out


def dense_view(sd: dict) -> dict:
    """A state_dict laid out as a sharded checkpoint stores it (each
    transformer c_attn viewed (3, C, ...)): the template of a
    one-process load. `model_state_dict` undoes it."""
    return {k: (v.view(3, v.shape[0] // 3, *v.shape[1:])
                if ".c_attn." in k else v) for k, v in sd.items()}


def model_state_dict(sd: dict) -> dict:
    """A restored state_dict in the model's own layout: DTensors as the
    rank's shards, c_attn as (3C, ...) rows, to `load_state_dict`."""
    from torch.distributed.tensor import DTensor
    out = {}
    for k, v in sd.items():
        if isinstance(v, DTensor):
            v = v.to_local()
        out[k] = v.reshape(-1, *v.shape[2:]) if ".c_attn." in k else v
    return out
