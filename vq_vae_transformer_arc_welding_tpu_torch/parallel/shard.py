"""The data shard a data-parallel training step runs on.

JAX computes a mesh step on the global batch; the port's ranks each
hold a slice of it. While `Trainer(mesh=)` runs a step on a slice, this
context names the slice (the data group, this rank's index in it, the
group's size), and the ops whose result depends on the whole batch read
it: train-mode BatchNorm (ops/norm.py) reduces its sums over the group,
the EMA VQ (ops/vq_ema.py) its counts, sums and drawn rows, and dropout
(utils/random.py) draws the global batch's mask and keeps its rows. So
a step on n slices computes what one step on the whole batch computes.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass


@dataclass(frozen=True)
class DataShard:
    group: object      # the data axis's ProcessGroup
    index: int         # this rank's slice: rows [index * b, (index + 1) * b)
    count: int         # slices in the global batch


# a context variable, not a global: a thread or task sees only the
# shard its own step entered (mesh serving runs replicas on threads)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("data_shard",
                                                         default=None)


def active() -> DataShard | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def data_shard(group, index: int, count: int):
    token = _ACTIVE.set(DataShard(group, index, count))
    try:
        yield _ACTIVE.get()
    finally:
        _ACTIVE.reset(token)
