"""What `Trainer(mesh=, param_rules=)` does on each rank.

JAX's mesh trainer computes the global batch's step on one controller
(vq_vae_transformer_arc_welding_tpu/train/loop.py:117-135, 411-415).
Every rank of the port draws the same batch indices (the same seeded
generators) and:

- takes the contiguous r-th slice of each batch along 'data' and runs
  its forward inside parallel/shard.data_shard, so that BatchNorm, the
  EMA VQ and dropout see the global batch; a batch that 'data' does not
  divide runs whole on every rank (replicated, as in JAX);
- averages the gradients over the data group before clipping and
  RAdam, once per optimizer step (after accumulation), in one flat
  all-reduce. A parameter no rank gave a gradient (the transformer's
  head of the other task) keeps none, as in one process. Under the
  pipeline, a parameter's gradient is its owner stage's
  (`PipelinedDecoder.owner`) and the sum runs over every rank;
- under tensor parallelism (`param_rules`, parallel/sharding.py) clips
  by the dense model's global norm: the shards' squares summed over the
  'model' group;
- averages the training losses and metrics over the data group (the
  classification metrics are the global batch's already:
  train/metrics.py); evaluates each whole evaluation batch on one data
  rank, in turn, and hands every rank every batch's metrics, so that
  the ranks log and stop early on the one process's numbers;
- writes logs and checkpoints on rank 0 only, a tensor-parallel model's
  gathered dense.
"""
from __future__ import annotations

import contextlib

import torch

from .mesh import Mesh, all_gather_object, all_reduce_
from .shard import data_shard


class MeshTraining:
    def __init__(self, mesh: Mesh, model, param_rules=None):
        if not mesh.bound:
            raise ValueError(
                "Trainer(mesh=) runs on a rank of the mesh: start the ranks "
                "with parallel/launch.run (or launch.in_process for a "
                "one-device mesh)")
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.data_index = mesh.axis_index("data")
        self.data_group = mesh.group("data")
        self.pipe = hasattr(model, "owner")
        if param_rules is not None and getattr(model, "tp", None) is None:
            from .sharding import shard_params
            shard_params(model, mesh, param_rules)
        self.tp = getattr(model, "tp", None)
        self.writer = mesh.rank == 0

    # -- the batch -------------------------------------------------------------

    def local(self, idx_groups: torch.Tensor, batch_size: int):
        """(this rank's part of the index groups, whether it is a slice)."""
        if batch_size % self.n_data:
            return idx_groups, False
        b = batch_size // self.n_data
        return idx_groups[..., self.data_index * b:
                          (self.data_index + 1) * b], True

    def context(self, sliced: bool):
        if not sliced or self.n_data == 1:
            return contextlib.nullcontext()
        return data_shard(self.data_group, self.data_index, self.n_data)

    # -- gradients ---------------------------------------------------------------

    def reduce_grads(self, model, named_params: list) -> None:
        if self.pipe:
            stage = self.mesh.axis_index(model.axis_name)
            for name, p in named_params:
                if model.owner(name) != stage:
                    p.grad = None
            group = self.mesh.world
        else:
            group = self.data_group
        params = [p for _, p in named_params]
        dev = params[0].device
        present = all_reduce_(torch.tensor(
            [float(p.grad is not None) for p in params], device=dev), group)
        used = [p for p, n in zip(params, present.tolist()) if n > 0]
        if not used:
            return
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in used])
        all_reduce_(flat, group).div_(self.n_data)
        # back into each parameter's own gradient tensor: a view into the
        # flat buffer would change the alignment the optimizer's kernels
        # see, and with it the bits of their reductions
        for p, g in zip(used, flat.split([p.numel() for p in used])):
            if p.grad is None:
                p.grad = torch.empty_like(p)
            p.grad.copy_(g.view_as(p))

    def grad_norm_fn(self, named_params: list):
        """The dense model's global gradient norm, for clipping: None
        where every parameter is whole on the rank."""
        if self.tp is None:
            return None
        tp = self.tp

        def norm() -> torch.Tensor:
            sharded = [p.grad for n, p in named_params
                       if p.grad is not None and tp.placement(n) is not None]
            whole = [p.grad for n, p in named_params
                     if p.grad is not None and tp.placement(n) is None]
            dev = named_params[0][1].device
            sq = torch.zeros((), device=dev)
            for g in sharded:
                sq = sq + g.float().pow(2).sum()
            sq = all_reduce_(sq, tp.group)
            for g in whole:
                sq = sq + g.float().pow(2).sum()
            return sq.sqrt()
        return norm

    # -- metrics, decisions, files -------------------------------------------------

    def mean(self, t: torch.Tensor, sliced: bool) -> torch.Tensor:
        if not sliced:
            return t
        return all_reduce_(t.clone(), self.data_group).div_(self.n_data)

    def gather_batches(self, values: dict, n: int, device) -> dict:
        """{metric: (batches,) float64} of every data rank's evaluation
        batches (rank r's are batches r, r + n_data, ...) -> every
        metric's n batches in order, on `device`."""
        got = all_gather_object({k: v.cpu().tolist()
                                 for k, v in values.items()},
                                self.data_group)
        keys = sorted({k for g in got for k in g})
        return {k: torch.tensor([got[j % self.n_data][k][j // self.n_data]
                                 for j in range(n)],
                                dtype=torch.float64, device=device)
                for k in keys}

    def dense_optimizer_state(self, opt) -> dict:
        """The optimizer's state_dict with the moments of sharded
        parameters gathered dense (collective)."""
        sd = opt.optimizer.state_dict()
        if self.tp is None:
            return sd
        names = self._names_by_index(opt)
        state = {}
        for i, st in sd["state"].items():
            state[i] = {k: (self.tp.dense(names[i], v)
                            if isinstance(v, torch.Tensor) and v.ndim else v)
                        for k, v in st.items()}
        return {**sd, "state": state}

    def shard_optimizer_state(self, opt, sd: dict) -> dict:
        if self.tp is None:
            return sd
        names = self._names_by_index(opt)
        state = {i: {k: (self.tp.shard(names[i], v)
                         if isinstance(v, torch.Tensor) and v.ndim else v)
                     for k, v in st.items()}
                 for i, st in sd["state"].items()}
        return {**sd, "state": state}

    @staticmethod
    def _names_by_index(opt) -> dict:
        name_of = {id(p): n for n, p in opt.named_params}
        flat = [p for g in opt.optimizer.param_groups for p in g["params"]]
        return {i: name_of[id(p)] for i, p in enumerate(flat)}
