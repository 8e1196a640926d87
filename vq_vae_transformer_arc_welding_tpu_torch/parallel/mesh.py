"""Device meshes, their process groups, and the collectives the parallel
paths use.

Port of vq_vae_transformer_arc_welding_tpu/parallel/mesh.py
(`make_mesh`, `make_mesh_dp_pp`). JAX runs one controller over every device of a
`jax.sharding.Mesh`; PyTorch runs one process per device
(parallel/launch.py starts them, as Lightning's DDP strategy starts the
reference's ranks). The port's `Mesh` is the same grid of devices with
the same axis names and `mesh.shape["data"]`; a process that is one of
its ranks `bind`s it, which makes one process group per axis line
through its rank (`torch.distributed.new_group`, every group on every
rank in one order). NCCL on CUDA devices, gloo on the CPU; two ranks on
one card run gloo, which NCCL refuses.

A serving mesh is never bound: `WeldingQualityPipeline(mesh=)` holds a
replica per 'data' device in one process. A device may appear more
than once there, so that a CPU host can stand in for a node of cards.
JAX's placements (`replicated`, `dp_spec`, `put_replicated`) have no
counterpart: a rank holds its own tensors, and the serving replicas are
the pipeline's (serve.py).

The collectives below stage a CUDA tensor through host memory where
the group is gloo's, so that every path runs on any backend; NCCL takes
the tensor where it lies. A group of one rank is called all the same
(NCCL and gloo run one-rank communicators), so that a one-card run
goes through the calls a node's ranks make.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A grid of torch.devices with named axes, e.g. ('data', 'model')."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(devices)[:len(axis_names)], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = _indexed(np.asarray(devices, dtype=object)[idx])
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.rank = None            # this process's flat index, once bound
        self.groups: dict = {}      # axis -> (ProcessGroup, global ranks)
        self.world = None           # the group of every rank of the mesh

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"

    # -- ranks ---------------------------------------------------------------

    def coords(self, rank: int) -> dict:
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(
                            rank, self.devices.shape))))

    @property
    def bound(self) -> bool:
        return self.rank is not None

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices.flat[self._rank()]

    def _rank(self) -> int:
        if self.rank is None:
            raise RuntimeError("the mesh is not bound to a rank: start the "
                               "ranks with parallel/launch.py")
        return self.rank

    def axis_index(self, axis: str) -> int:
        return self.coords(self._rank())[axis]

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        self._rank()
        return self.groups[axis][0]

    def group_ranks(self, axis: str) -> list:
        self._rank()
        return self.groups[axis][1]

    def bind(self, rank: int) -> "Mesh":
        """Make this process rank `rank` of the mesh: one process group
        per axis line (collective: every rank calls it, in one order,
        after `init_process_group` with the mesh's size)."""
        if dist.get_world_size() != self.size:
            raise ValueError(f"world size {dist.get_world_size()} is not the "
                             f"mesh's {self.size}")
        grid = np.arange(self.size).reshape(self.devices.shape)
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
            for line in lines:
                ranks = [int(r) for r in line]
                g = dist.new_group(ranks)
                if rank in ranks:
                    self.groups[name] = (g, ranks)
        self.world = dist.group.WORLD
        self.rank = rank
        return self

    def unbind(self) -> None:
        self.rank, self.groups, self.world = None, {}, None


def _indexed(device) -> torch.device:
    """`device` with its index: 'cuda' is the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _devices(devices) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """Mesh with ('data', 'model') axes over the CUDA devices, or over
    `devices`."""
    devices = _devices(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    need = n_data * n_model
    if n_data < 1 or len(devices) < need:
        platform = devices[0].type if devices else "none"
        raise ValueError(
            f"make_mesh needs n_data*n_model = {n_data}*{n_model} = {need} "
            f"devices but only {len(devices)} are available "
            f"(platform '{platform}'). To simulate a multi-device mesh, "
            f"pass devices=[torch.device('cpu')] * {max(need, 2)}.")
    arr = np.empty((n_data, n_model), dtype=object)
    arr.reshape(-1)[:] = devices[:need]
    return Mesh(arr, ("data", "model"))


def make_mesh_dp_pp(n_data: int | None = None, n_pipe: int = 1,
                    devices=None) -> Mesh:
    """Mesh with ('data', 'pipe') axes for dp x pipeline-parallel
    training (parallel/pipeline.py::PipelinedDecoder)."""
    devices = _devices(devices)
    if n_data is None:
        n_data = len(devices) // n_pipe
    need = n_data * n_pipe
    if n_pipe < 1 or n_data < 1 or len(devices) < need:
        raise ValueError(
            f"make_mesh_dp_pp needs n_data*n_pipe = {n_data}*{n_pipe} = "
            f"{need} devices but only {len(devices)} are available.")
    arr = np.empty((n_data, n_pipe), dtype=object)
    arr.reshape(-1)[:] = devices[:need]
    return Mesh(arr, ("data", "pipe"))


# -- collectives ------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` over `group`."""
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In-place broadcast of `t` from global rank `src` over `group`."""
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        return t.copy_(host)
    dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors of t's shape, concatenated along `dim` in the
    group's rank order."""
    n = dist.get_world_size(group)
    src = t.contiguous().cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def send(t: torch.Tensor, dst: int, group) -> None:
    """Blocking send of `t` to global rank `dst`."""
    dist.send(t.contiguous().cpu() if _staged(t, group) else t.contiguous(),
              dst=dst, group=group)


def recv(shape, dtype, device, src: int, group) -> torch.Tensor:
    """Blocking receive of a tensor of `shape` from global rank `src`."""
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged else device)
    dist.recv(buf, src=src, group=group)
    return buf.to(device)


def send_recv(t: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send `t` to global rank `dst` and receive a tensor of its shape
    from `src` at once (`batch_isend_irecv`): one step of a ring."""
    staged = _staged(t, group)
    out = t.contiguous().cpu() if staged else t.contiguous()
    buf = torch.empty_like(out)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, out, dst, group),
        dist.P2POp(dist.irecv, buf, src, group)])
    for r in reqs:
        r.wait()
    return buf.to(t.device)


def all_gather_object(obj, group) -> list:
    """Every rank's picklable `obj`, in the group's rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class AllReduceSum(torch.autograd.Function):
    """Differentiable sum over a group: the backward sums the gradients
    over it too (each rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None
