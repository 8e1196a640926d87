"""One process per mesh device: the port's counterpart of the
reference's Lightning DDP launch (`--use-all-gpus`).

`run(fn, mesh, *args)` spawns `mesh.size` processes (the spawn
context; a child imports the port, never the caller's module state),
joins them into one process group through a `file://` rendezvous in a
temporary directory (no TCP port, so runs side by side cannot collide),
binds the mesh (one group per axis line, parallel/mesh.py), and calls
`fn(mesh, *args)` in each. It returns every rank's return value, in
rank order; a rank's exception is raised in the caller with the rank's
traceback. `fn` must be importable by name (a function of a module, not
a lambda) and its result picklable.

`in_process(mesh)` makes the calling process the one rank of a
one-device mesh, with no spawn (the NCCL world of size 1 a single card
runs); it leaves the process's thread count as it is.

Backends: NCCL where every device of the mesh is a distinct CUDA
device; gloo otherwise (the CPU, or several ranks on one card). A CPU
rank runs torch on one thread, so that n ranks do not oversubscribe
the host.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

from .mesh import Mesh


def default_backend(mesh: Mesh) -> str:
    devs = list(mesh.devices.flat)
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def _init(mesh: Mesh, rank: int, init_method: str, backend: str,
          spawned: bool = True) -> None:
    device = mesh.devices.flat[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif spawned:
        torch.set_num_threads(1)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=mesh.size, **kw)
    mesh.bind(rank)


def _finish(mesh: Mesh) -> None:
    mesh.unbind()
    if dist.is_initialized():
        dist.destroy_process_group()


def _child(rank: int, fn, mesh: Mesh, args, init_method: str, backend: str,
           results) -> None:
    try:
        _init(mesh, rank, init_method, backend)
        out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        _finish(mesh)


def run(fn, mesh: Mesh, *args, timeout: float | None = None) -> list:
    """fn(mesh, *args) on every rank of `mesh`, each in its own process;
    the ranks' return values in rank order. timeout: seconds after which
    the ranks are stopped and TimeoutError raised (a rank waiting on a
    collective another never joins waits for ever)."""
    import time

    import torch.multiprocessing as mp

    backend = default_backend(mesh)
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="rdv-")
    try:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child,
                             args=(r, fn, mesh, args, init_method, backend,
                                   results))
                 for r in range(mesh.size)]
        for p in procs:
            p.start()
        got = {}
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(got) < mesh.size:
            if deadline is not None and time.monotonic() > deadline:
                for p in procs:
                    p.terminate()
                    p.join()
                raise TimeoutError(f"ranks of {mesh} ran past {timeout} s")
            if results.empty() and not any(p.is_alive() for p in procs):
                break
            if results.empty():
                for p in procs:
                    p.join(timeout=0.05)
                continue
            rank, ok, out = results.get()
            got[rank] = (ok, out)
            if not ok:
                break
        failed = [(r, out) for r, (ok, out) in sorted(got.items()) if not ok]
        if failed:
            for p in procs:
                p.terminate()
        for p in procs:
            p.join()
        if failed:
            rank, tb = failed[0]
            raise RuntimeError(f"rank {rank} of {mesh} failed:\n{tb}")
        if len(got) < mesh.size:
            codes = [p.exitcode for p in procs]
            raise RuntimeError(f"ranks of {mesh} ended without a result "
                               f"(exit codes {codes})")
        return [got[r][1] for r in range(mesh.size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def in_process(mesh: Mesh):
    """This process as the only rank of a one-device mesh."""
    if mesh.size != 1:
        raise ValueError(f"in_process runs a mesh of one device, not {mesh}")
    tmp = tempfile.mkdtemp(prefix="rdv-")
    try:
        _init(mesh, 0, "file://" + os.path.join(tmp, "rendezvous"),
              default_backend(mesh), spawned=False)
        yield mesh
    finally:
        _finish(mesh)
        shutil.rmtree(tmp, ignore_errors=True)
