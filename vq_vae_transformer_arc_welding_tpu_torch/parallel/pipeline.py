"""GPipe pipeline parallelism over the transformer's block stack.

Port of vq_vae_transformer_arc_welding_tpu/parallel/pipeline.py
(`stage_blocks`, `pipeline_backbone`, `pipeline_apply`,
`PipelinedDecoder`). JAX stages the stacked blocks over a 'pipe' mesh
axis with shard_map and moves activations with `lax.ppermute`; a rank
of the port is one stage: it runs its `n_blocks / n_stages` blocks and
passes activations to the next stage with P2P send and recv
(parallel/mesh.py), in GPipe's fill-drain order: every microbatch
forward, stage after stage, then every microbatch backward in reverse,
stage before stage. The backward is written out (`_Pipeline`): each
stage keeps each microbatch's graph, receives the gradient of its
output from the next stage, back-propagates it into its blocks'
gradients and sends its input's gradient to the stage before. The
order is fixed on every rank, so the ranks cannot wait on each other
in a cycle.

The last stage's stream goes to every stage (a broadcast), and the
embedding, `ln_f` and the heads run replicated through the dense
model's own code (`embed`, `heads`), as in JAX. Every rank keeps the
whole model; a block's gradient is its stage's, the embedding's stage
0's and the rest's the last stage's (`PipelinedDecoder.owner`), and the
trainer sums them over the pipe so that each rank takes the same
optimizer step and holds the same weights: a checkpoint is the dense
model's, and a batch the pipeline cannot take runs the dense path.

At train time every microbatch and every block draws its dropout masks
from a generator of its own (`microbatch_generator`), seeded from one
number that the step's generator gives (`step_seed`, the same on every
rank, whose generators are in step) and the pair (microbatch, global
block index), as JAX folds the tick and the layer index into its key:
no two blocks share a mask, whichever stage runs them. The
microbatches' masks are not the full batch's (the standard GPipe
caveat); eval is exact.
"""
from __future__ import annotations

import torch

from ..ops.norm import layer_norm
from .mesh import Mesh, all_gather, broadcast_, recv, send


def stage_blocks(blocks, n_stages: int) -> list:
    """A list of n_blocks blocks -> n_stages lists of n_blocks/n_stages."""
    blocks = list(blocks)
    if len(blocks) % n_stages:
        raise ValueError(
            f"n_blocks={len(blocks)} not divisible by n_stages={n_stages}")
    per = len(blocks) // n_stages
    return [blocks[i * per:(i + 1) * per] for i in range(n_stages)]


class _Stage:
    """This rank's place in the pipe: its blocks and its neighbours."""

    def __init__(self, model, mesh: Mesh, axis_name: str):
        self.n = mesh.shape[axis_name]
        self.index = mesh.axis_index(axis_name)
        self.group = mesh.group(axis_name)
        self.ranks = mesh.group_ranks(axis_name)
        self.first, self.last = self.index == 0, self.index == self.n - 1
        self.block_ids = stage_blocks(range(model.n_blocks),
                                      self.n)[self.index]

    def prev(self) -> int:
        return self.ranks[self.index - 1]

    def next(self) -> int:
        return self.ranks[self.index + 1]


class _Pipeline(torch.autograd.Function):
    """x (n_micro, mb, T, C), the embedded microbatches (stage 0 reads
    them) -> the last stage's stream (n_micro * mb, T, C) on every
    stage."""

    @staticmethod
    def forward(ctx, x, run, stage: _Stage):
        ctx.run, ctx.stage = run, stage
        ctx.graphs = []
        n_micro, shape = x.shape[0], x.shape[1:]
        outs = []
        for m in range(n_micro):
            h = (x[m].detach() if stage.first else
                 recv(shape, x.dtype, x.device, stage.prev(), stage.group))
            h.requires_grad_(True)
            with torch.enable_grad():
                y = run(h, m)
            ctx.graphs.append((h, y))
            if stage.last:
                outs.append(y.detach())
            else:
                send(y.detach(), stage.next(), stage.group)
        out = (torch.cat(outs) if stage.last else
               x.new_empty((n_micro * shape[0],) + tuple(shape[1:])))
        return broadcast_(out, stage.ranks[-1], stage.group)

    @staticmethod
    def backward(ctx, g):
        stage = ctx.stage
        n_micro = len(ctx.graphs)
        g = g.reshape((n_micro, -1) + tuple(g.shape[1:]))
        gx = []
        for m in reversed(range(n_micro)):
            h, y = ctx.graphs[m]
            gy = (g[m] if stage.last else
                  recv(y.shape, y.dtype, y.device, stage.next(), stage.group))
            torch.autograd.backward(y, gy)
            if stage.first:
                gx.append(h.grad)
            else:
                send(h.grad, stage.prev(), stage.group)
        ctx.graphs = None
        return (torch.stack(gx[::-1]) if stage.first else None), None, None


class _Gather(torch.autograd.Function):
    """all_gather along dim 1; the backward keeps this rank's part."""

    @staticmethod
    def forward(ctx, y, group, index: int):
        ctx.index, ctx.size = index, y.shape[1]
        return all_gather(y, group, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.index * ctx.size, ctx.size), None, None


def step_seed(generator: torch.Generator) -> int:
    """The number a pipelined train step seeds its dropout from: one
    draw from the step's generator."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))


def microbatch_generator(seed: int, micro: int, block: int, n_blocks: int,
                         device) -> torch.Generator:
    """The generator of block `block`'s dropout on microbatch `micro`."""
    return torch.Generator(device=device).manual_seed(
        seed + micro * n_blocks + block)


def _run_stage(model, stage: _Stage, blocks, train: bool, generator):
    seed = step_seed(generator) if train and generator is not None else None

    def run(h, m):
        for i in stage.block_ids:
            gen = (None if seed is None else microbatch_generator(
                seed, m, i, model.n_blocks, h.device))
            h = model.block_body(h, blocks[i], train=train, generator=gen)
        return h
    return run


def _data_slice(x_ids, mesh: Mesh, n_micro: int, data_axis: str):
    """This rank's slice of every microbatch of the global batch."""
    n_data, i = mesh.shape[data_axis], mesh.axis_index(data_axis)
    b = x_ids.shape[0]
    if b % (n_micro * n_data):
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro} "
                         f"x {n_data} data shards")
    return x_ids.reshape(n_micro, n_data, -1, x_ids.shape[-1])[:, i].reshape(
        -1, x_ids.shape[-1])


def _data_gather(y, mesh: Mesh, n_micro: int, data_axis: str):
    """The global batch's rows from every rank's `_data_slice` rows."""
    y = y.reshape(n_micro, 1, -1, *y.shape[1:])
    out = _Gather.apply(y, mesh.group(data_axis), mesh.axis_index(data_axis))
    return out.reshape(-1, *y.shape[3:])


def pipeline_backbone(model, x_ids: torch.Tensor, mesh: Mesh, *,
                      n_micro: int, axis_name: str = "pipe",
                      data_axis: str | None = None, train: bool = False,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """TransformerDecoder.backbone with the block stack pipelined over
    `mesh[axis_name]` (this process is one of its ranks). x_ids: the
    batch this rank's pipeline runs; with `data_axis`, the global batch:
    the rank runs its slice of every microbatch (JAX's microbatch dim
    sharded over `data_axis`) and returns the global stream, gathered
    over that axis; its gradients are then its slice's part of the
    global loss's, to be summed over the data axis."""
    if data_axis is not None:
        y = pipeline_backbone(
            model, _data_slice(x_ids, mesh, n_micro, data_axis), mesh,
            n_micro=n_micro, axis_name=axis_name, train=train,
            generator=generator)
        return _data_gather(y, mesh, n_micro, data_axis)
    stage = _Stage(model, mesh, axis_name)
    b, t = x_ids.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    # embedding + dtype policy: the dense backbone's own code
    x = model.embed(x_ids)
    from ..models.transformer import cast_params
    tf = (model.transformer if model.compute_dtype is None
          else cast_params(model.transformer, model.compute_dtype))
    run = _run_stage(model, stage, tf.h, train, generator)
    xs = x.reshape(n_micro, b // n_micro, t, x.shape[-1])
    if torch.is_grad_enabled() and x.requires_grad:
        y = _Pipeline.apply(xs, run, stage)
    else:
        y = _forward_only(xs, run, stage)
    return layer_norm(y, tf.ln_f.weight, tf.ln_f.bias)


def _forward_only(xs, run, stage: _Stage) -> torch.Tensor:
    outs = []
    for m in range(xs.shape[0]):
        h = (xs[m] if stage.first else
             recv(xs.shape[1:], xs.dtype, xs.device, stage.prev(),
                  stage.group))
        y = run(h, m)
        if stage.last:
            outs.append(y)
        else:
            send(y, stage.next(), stage.group)
    out = (torch.cat(outs) if stage.last else
           xs.new_empty((xs.shape[0] * xs.shape[1],) + tuple(xs.shape[2:])))
    return broadcast_(out, stage.ranks[-1], stage.group)


def pipeline_apply(model, x_ids: torch.Tensor, mesh: Mesh, *, n_micro: int,
                   axis_name: str = "pipe", data_axis: str | None = None,
                   train: bool = False,
                   generator: torch.Generator | None = None,
                   generate: bool = True) -> torch.Tensor:
    """TransformerDecoder.apply (both heads) over the pipelined
    backbone; `data_axis` as there (the heads run on the rank's rows,
    so that every parameter's gradient is their part)."""
    if data_axis is not None:
        # the heads on the rank's rows, then the logits gathered: every
        # gradient is then the rank's rows' part
        out = pipeline_apply(
            model, _data_slice(x_ids, mesh, n_micro, data_axis), mesh,
            n_micro=n_micro, axis_name=axis_name, train=train,
            generator=generator, generate=generate)
        return _data_gather(out, mesh, n_micro, data_axis)
    x = pipeline_backbone(model, x_ids, mesh, n_micro=n_micro,
                          axis_name=axis_name, train=train,
                          generator=generator)
    return model.heads(x, generate=generate)


class PipelinedDecoder:
    """A TransformerDecoder whose `apply` pipelines the block stack over
    `mesh[axis_name]`, for the trainer (`--pipeline-stages`): tasks,
    optimizer, checkpoints (the dense model's: `save`, `state_dict`) and
    every other attribute are the wrapped model's. A batch that n_micro
    does not divide runs the dense path, the same function (JAX's own
    rule). The trainer hands each data rank its slice of the batch, so
    the pipeline runs the rank's rows (JAX's `data_axis` is the
    trainer's here)."""

    def __init__(self, model, mesh: Mesh, *, n_micro: int,
                 axis_name: str = "pipe"):
        self._model = model
        self.mesh = mesh
        self.n_micro = n_micro
        self.axis_name = axis_name

    def __getattr__(self, name):
        return getattr(self._model, name)

    @property
    def dense(self):
        return self._model

    def owner(self, name: str) -> int:
        """The pipe stage whose gradient a parameter takes."""
        n = self.mesh.shape[self.axis_name]
        if name.startswith("transformer.h."):
            i = int(name.split(".")[2])
            return i // (self._model.n_blocks // n)
        if name.startswith("embedding."):
            return 0
        return n - 1

    def apply(self, x_ids: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None,
              generate: bool = True) -> torch.Tensor:
        if x_ids.shape[0] % self.n_micro:
            return self._model.apply(x_ids, train=train, generator=generator,
                                     generate=generate)
        return pipeline_apply(self._model, x_ids, self.mesh,
                              n_micro=self.n_micro, axis_name=self.axis_name,
                              train=train, generator=generator,
                              generate=generate)

    forward = apply

    def __call__(self, *args, **kw):
        return self.apply(*args, **kw)
