"""What a spawned rank runs for the multi-device checks.

`run_jobs(mesh, jobs)` is the function `parallel/launch.run` hands each
rank: `jobs` is a list of (name, kind, kwargs), each kind a function
below, and the rank returns {name: result}. Models come in as a spec
(`model_spec`: class name, hparams, runtime options and a numpy
state_dict), data as numpy arrays, results go out as numpy, so that a
caller on the CPU (the tests, `entry.dryrun_multichip`) or on the card
(`chip_smoke.py`) can hold them against a one-process run of the same
function. Several jobs share one spawn: a rank's start-up is the cost.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, all_reduce_


def model_spec(model, state_dict: dict | None = None, **runtime) -> dict:
    """What `build` rebuilds: the model's class, hparams, the runtime
    options given, and its weights (`state_dict`, default its own)."""
    dense = getattr(model, "dense", model)
    sd = dense.state_dict() if state_dict is None else state_dict
    return {"cls": type(dense).__name__, "hparams": dict(dense.hparams),
            "runtime": runtime,
            "state_dict": {k: v.detach().cpu().numpy()
                           for k, v in sd.items()}}


def build(spec: dict, device) -> torch.nn.Module:
    from .. import models
    model = getattr(models, spec["cls"])(**spec["hparams"], **spec["runtime"],
                                         device=device)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in spec["state_dict"].items()})
    return model


def _np(sd: dict) -> dict:
    return {k: v.detach().float().cpu().numpy() if v.is_floating_point()
            else v.detach().cpu().numpy() for k, v in sd.items()}


class DataModule:
    """The trainer's datamodule surface over numpy arrays."""
    drop_last = True
    train_sampling = None

    def __init__(self, x, y=None, cond=None, batch_size: int = 16,
                 val_rows: int | None = None):
        from ..data.datasets import ArraySplit
        self.train = ArraySplit(x, y, cond)
        n = val_rows if val_rows is not None else len(x) // 2
        self.val = ArraySplit(x[:n], None if y is None else y[:n],
                              None if cond is None else cond[:n])
        self.test = self.val
        self.batch_size = batch_size

    def setup(self, stage=None):
        pass


def fit(mesh: Mesh | None, spec: dict, task: str, data: dict,
        batch_size: int, epochs: int = 1, seed: int = 0, lr: float = 1e-2,
        optimizer: str = "radam", pipeline: int | None = None,
        param_rules: bool = False, val_every: int = 1,
        device=None) -> dict:
    """A Trainer fit of the spec's model; mesh None: one process on
    `device`. Returns the history, the dense weights and the EMA
    codebook (the latter on every rank)."""
    from ..train import tasks
    from ..train.loop import Trainer
    from ..train.optim import make_radam, make_transformer_optimizer
    from .pipeline import PipelinedDecoder
    from .sharding import transformer_tp_rules
    dev = mesh.device if mesh is not None else torch.device(device)
    model = build(spec, dev)
    if pipeline:
        model = PipelinedDecoder(model, mesh, n_micro=pipeline)
    task_of = {"classification": tasks.ClassificationTask,
               "reconstruction": tasks.ReconstructionTask,
               "gen": tasks.TransformerGenTask,
               "class": tasks.TransformerClassTask}
    t = task_of[task](model)
    tx = (make_transformer_optimizer(model, clip_norm=0.8)
          if optimizer == "transformer" else make_radam(lr))
    trainer = Trainer(max_epochs=epochs, seed=seed, verbose=False, mesh=mesh,
                      param_rules=transformer_tp_rules if param_rules
                      else None, check_val_every_n_epoch=val_every)
    res = trainer.fit(t, DataModule(**data, batch_size=batch_size), tx)
    out = {"history": res.history,
           "state_dict": _np(res.state_dict)}
    dense = getattr(model, "dense", model)
    if getattr(dense, "use_improved_vq", False):
        st = dense.ema.state()
        out["codebook"] = st.codebook.cpu().numpy()
        out["cluster_size"] = st.cluster_size.cpu().numpy()
    return out


def tp_step(mesh: Mesh, spec: dict, ids, labels, lr: float = 1e-2,
            train: bool = False, seed: int = 0) -> dict:
    """One SGD step of the generation loss on a (data, model) mesh: the
    forward's logits, the loss, the dense gradients (averaged over
    'data', the batch split over it) and the updated dense weights.
    train: the step's forward with dropout, drawn from a generator
    seeded with `seed`."""
    from .sharding import dense_state_dict, shard_params
    from .training import MeshTraining
    model = build(spec, mesh.device)
    model.requires_grad_(True)
    shard_params(model, mesh)
    par = MeshTraining(mesh, model)
    ids = torch.as_tensor(ids, device=mesh.device)
    labels = torch.as_tensor(labels, device=mesh.device)
    with torch.no_grad():
        logits = model.apply(ids)
    idx = torch.arange(len(ids), device=mesh.device)[None, None]
    (idx,), sliced = par.local(idx, len(ids))
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    with par.context(sliced):
        loss = model.loss_gen(model.apply(ids[idx[0]], train=train,
                                          generator=gen), labels[idx[0]])
        loss.backward()
    named = list(model.named_parameters())
    par.reduce_grads(model, named)
    loss = par.mean(loss.detach(), sliced)
    named = [(n, p) for n, p in named if p.grad is not None]
    grads = {n: model.tp.dense(n, p.grad) for n, p in named}
    with torch.no_grad():
        for _, p in named:
            p -= lr * p.grad
    return {"logits": logits.cpu().numpy(), "loss": float(loss.detach()),
            "grads": _np(grads), "state_dict": _np(dense_state_dict(model))}


def pp_step(mesh: Mesh, spec: dict, ids, labels, n_micro: int,
            data_axis: str | None = None, train: bool = False,
            seed: int = 0) -> dict:
    """The pipelined forward of both heads, and the generation loss's
    gradients (each parameter's from its owner stage, summed over the
    data axis where the batch is split over it)."""
    from .pipeline import PipelinedDecoder, pipeline_apply
    model = build(spec, mesh.device)
    model.requires_grad_(True)
    ids = torch.as_tensor(ids, device=mesh.device)
    labels = torch.as_tensor(labels, device=mesh.device)
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    with torch.no_grad():
        heads = {g: pipeline_apply(model, ids, mesh, n_micro=n_micro,
                                   data_axis=data_axis,
                                   generate=g).cpu().numpy()
                 for g in (True, False)}
    logits = pipeline_apply(model, ids, mesh, n_micro=n_micro,
                            data_axis=data_axis, train=train,
                            generator=gen)
    loss = model.loss_gen(logits, labels)
    loss.backward()
    piped = PipelinedDecoder(model, mesh, n_micro=n_micro)
    stage = mesh.axis_index("pipe")
    grads = {}
    for n, p in model.named_parameters():
        g = (p.grad if p.grad is not None and piped.owner(n) == stage
             else torch.zeros_like(p))
        grads[n] = all_reduce_(g.clone(), mesh.world)
    return {"gen": heads[True], "class": heads[False],
            "loss": float(loss.detach()),
            "grads": _np(grads)}


def ring(mesh: Mesh, q, k, v, axis_name: str = "model") -> np.ndarray:
    from .ring_attention import ring_causal_attention
    dev = mesh.device
    out = ring_causal_attention(*(torch.as_tensor(a, device=dev)
                                  for a in (q, k, v)), mesh, axis_name)
    return out.cpu().numpy()


def ring_raises(mesh: Mesh, t: int, axis_name: str = "model") -> str:
    """The error of a sequence the ring does not divide."""
    from .ring_attention import ring_causal_attention
    q = torch.zeros((1, 1, t, 8), device=mesh.device)
    try:
        ring_causal_attention(q, q, q, mesh, axis_name)
    except AssertionError as e:
        return f"AssertionError: {e}"
    return "no error"


def ema_axis(mesh: Mesh, z, k: int, draws: list, kmeans_iters: int = 3,
             threshold: int = 2) -> dict:
    """quantize_ema(group=) on this rank's rows of z (split over 'data'),
    with rank r's handed draws `draws[r]`: the codebook every rank ends
    with."""
    from ..ops.vq_ema import EMAState, quantize_ema
    dev = mesh.device
    n = mesh.shape["data"]
    i = mesh.axis_index("data")
    z = torch.as_tensor(z, device=dev)
    z = z.reshape(n, -1, *z.shape[1:])[i]
    state = EMAState.create(k, z.shape[-1], device=dev)
    _, new = quantize_ema(z, state, train=True, kmeans_iters=kmeans_iters,
                          threshold_ema_dead_code=threshold,
                          draws=tuple(torch.as_tensor(a) for a in draws[i]),
                          group=mesh.group("data"))
    return {"codebook": new.codebook.cpu().numpy(),
            "cluster_size": new.cluster_size.cpu().numpy()}


def sharded_checkpoint(mesh: Mesh, spec: dict, path: str) -> dict:
    """A tensor-parallel transformer saved with the sharded backend and
    restored against its sharded template: whether every shard came back
    as this rank's shard, and its largest difference."""
    from ..train.checkpoint import (load_checkpoint_sharded,
                                    model_state_dict,
                                    save_checkpoint_sharded,
                                    sharded_state_dict)
    from .sharding import shard_params
    model = shard_params(build(spec, mesh.device), mesh)
    sd = sharded_state_dict(model)
    save_checkpoint_sharded(path, spec["cls"], spec["hparams"], sd,
                            {}, {"epoch": 1})
    template = sharded_state_dict(shard_params(build(spec, mesh.device),
                                               mesh))
    for v in template.values():
        v.to_local().zero_() if hasattr(v, "to_local") else v.zero_()
    header, params, _ = load_checkpoint_sharded(path, (template, {}))
    from torch.distributed.tensor import DTensor
    local = model_state_dict(params)
    mine = model.state_dict()
    return {"header": header,
            "sharded": [k for k, v in params.items()
                        if isinstance(v, DTensor)],
            "max_err": max(float((local[k] - mine[k]).abs().max())
                           for k in mine if mine[k].is_floating_point())}


JOBS = {f.__name__: f for f in (fit, tp_step, pp_step, ring, ring_raises,
                                 ema_axis, sharded_checkpoint)}


def run_jobs(mesh: Mesh, jobs: list) -> dict:
    """The rank's results of (name, kind, kwargs) jobs, in order. A job
    whose kwargs hold `layout=(shape, axis_names)` runs on the same
    ranks laid out as another mesh (bound here, on every rank in one
    order), so that one spawn serves several meshes."""
    out = {}
    for name, kind, kw in jobs:
        kw = dict(kw)
        layout = kw.pop("layout", None)
        m = mesh
        if layout is not None:
            shape, names = layout
            devs = np.empty(len(mesh.devices.flat), dtype=object)
            devs[:] = list(mesh.devices.flat)
            m = Mesh(devs.reshape(shape), names).bind(mesh.rank)
        out[name] = JOBS[kind](m, **kw)
    return out
