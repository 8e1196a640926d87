"""LayerNorm and BatchNorm, written out as in the JAX package.

Port of vq_vae_transformer_arc_welding_tpu/ops/norm.py (`layer_norm`,
`batch_norm_apply` in eval and in train mode). The expressions follow
the JAX op order, `(x - mean) / sqrt(var + eps) * scale + bias` with the
biased variance, instead of `F.layer_norm`: its fused rsqrt rounds
differently, which moves values across the int8 quantization
boundaries that the int8 path keeps bit-comparable.

BatchNorm's running statistics are not mutated here: `batch_norm_train`
returns the new ones, so that a forward stays a function of its inputs
as in the JAX package, and the caller decides where they go (the
models' `commit_state`). Inside a data-parallel step
(parallel/shard.py) the batch statistics are the global batch's: the
sums reduce over the data group, with gradients through the reduction
(as SyncBatchNorm), so the ranks normalize as one process would.
"""
from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.LayerNorm over the last axis, JAX op order."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def batch_norm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mean: torch.Tensor, var: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.BatchNorm1d in eval mode, channels last: running stats."""
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mean: torch.Tensor, var: torch.Tensor, *,
                     momentum: float = 0.1, eps: float = 1e-5):
    """torch.nn.BatchNorm1d in train mode, channels last: the statistics
    reduce over every leading axis. Normalizes with the batch's biased
    variance; the running estimate takes the unbiased one, with torch's
    momentum convention running = (1 - m) * running + m * batch.
    mean, var: the running statistics. Returns (y, (new mean, new var)),
    the new ones without gradient."""
    from ..parallel.shard import active
    axes = tuple(range(x.ndim - 1))
    n = x.numel() // x.shape[-1]
    shard = active()
    if shard is None:
        b_mean = x.mean(dim=axes)
        b_var = ((x - b_mean) ** 2).mean(dim=axes)
    else:
        from ..parallel.mesh import AllReduceSum
        n = n * shard.count
        b_mean = AllReduceSum.apply(x.sum(dim=axes), shard.group) / n
        b_var = AllReduceSum.apply(((x - b_mean) ** 2).sum(dim=axes),
                                   shard.group) / n
    with torch.no_grad():
        unbiased = b_var * (n / max(n - 1, 1))
        new = ((1 - momentum) * mean + momentum * b_mean,
               (1 - momentum) * var + momentum * unbiased)
    return (x - b_mean) / torch.sqrt(b_var + eps) * scale + bias, new
