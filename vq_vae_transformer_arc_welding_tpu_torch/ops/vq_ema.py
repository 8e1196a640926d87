"""Improved VQ: kmeans bootstrap, EMA codebook, dead-code expiry.

Port of vq_vae_transformer_arc_welding_tpu/ops/vq_ema.py (`EMAState`,
`_kmeans`, `nearest_ema`, `quantize_ema`, `quantize_ood`), the
replacement of the reference's `vector_quantize_pytorch.ResidualVQ`
(one quantizer, kmeans init, EMA decay 0.8, dead-code threshold): the
codebook is state, moved by exponential moving averages of each batch's
code counts and vector sums, not by gradients. The loss is the
commitment term alone (weight 1.0); `beta` does not enter it.

Randomness: the JAX package draws two sets of K row indices with
`jax.random.randint`, the kmeans's initial means and the batch rows
that replace dead codes. Here the caller hands them (`draws=(init_idx,
expire_idx)`, int64 tensors of K indices into the batch's rows) or they
are drawn from the caller's torch.Generator on the batch's device, the
initial rows first; jax.random and torch draw different numbers, so a
test hands both packages the JAX draws.

The search is the plain one (ops/vq.nearest_codes), as in the JAX
package, where the EMA path never reaches the Pallas kernel. The batch
sums are the one-hot matmul of the JAX package.

Several devices keep one codebook in two ways:

- `group=` is the JAX function's `axis_name=`: each rank quantizes its
  own rows, the kmeans's initial means and the expiry's sampled rows
  are averaged over the group (`pmean`), and the code counts and sums
  summed (`psum`). Each rank draws (or is handed) indices into its own
  rows; the perplexity is its own rows'.
- Inside a data-parallel step of `Trainer(mesh=)` (parallel/shard.py)
  the result is the global batch's, as XLA computes it for a JAX mesh
  run: the draws index the global batch's rows (every rank draws the
  same from its generator, which the ranks keep in step), the rank
  that holds a drawn row puts it in and one all-reduce gives every
  rank the same rows, and counts, sums and the perplexity are the
  global batch's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .vq import VQOutput, nearest_codes

DECAY = 0.8       # vector_quantize_pytorch's default
EPS = 1e-5
COMMITMENT_WEIGHT = 1.0


class EMAState(NamedTuple):
    codebook: torch.Tensor      # (K, D)
    cluster_size: torch.Tensor  # (K,) EMA of the code counts
    embed_avg: torch.Tensor     # (K, D) EMA of the assigned vectors' sums
    initialized: torch.Tensor   # () int32, 1 once the kmeans ran

    @staticmethod
    def create(num_embeddings: int, dim: int, device=None) -> "EMAState":
        return EMAState(
            torch.zeros(num_embeddings, dim, device=device),
            torch.zeros(num_embeddings, device=device),
            torch.zeros(num_embeddings, dim, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _draw(n: int, k: int, given, generator, device) -> torch.Tensor:
    if given is not None:
        return torch.as_tensor(given, dtype=torch.int64, device=device)
    if generator is None:
        raise ValueError("the EMA VQ's row draws need a torch.Generator "
                         "or the indices (draws=)")
    return torch.randint(0, n, (k,), generator=generator, device=device)


def _counts_and_sums(z_flat: torch.Tensor, assign: torch.Tensor, k: int):
    onehot = F.one_hot(assign.long(), k).float()
    return onehot.sum(0), onehot.t() @ z_flat


class _Reduce:
    """How the statistics of one device's rows become the group's: the
    identity on one device; see the module docstring for `group=` (mode
    'axis') and the data-parallel step (mode 'global')."""

    def __init__(self, group=None):
        from ..parallel.shard import active
        self.mode, self.group = None, group
        if group is not None:
            self.mode = "axis"
        elif active() is not None:
            shard = active()
            self.mode, self.group = "global", shard.group
            self.index, self.count = shard.index, shard.count

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode is None:
            return t
        from ..parallel.mesh import all_reduce_
        return all_reduce_(t, self.group)

    def n_rows(self, n: int) -> int:
        """The rows the draws index: the global batch's in mode 'global'."""
        return n * self.count if self.mode == "global" else n

    def rows(self, data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """data[idx], the same on every rank."""
        if self.mode is None:
            return data[idx]
        import torch.distributed as dist
        if self.mode == "axis":
            return self.psum(data[idx].clone()) / dist.get_world_size(
                self.group)
        n = data.shape[0]
        local = idx - self.index * n
        mine = (local >= 0) & (local < n)
        picked = data[local.clamp(0, n - 1)] * mine[:, None]
        return self.psum(picked)


def _kmeans(z_flat: torch.Tensor, k: int, iters: int,
            init_idx: torch.Tensor, red: _Reduce | None = None):
    """Lloyd's kmeans on one batch from the rows `init_idx`: (means (K,
    D), counts (K,) of the last assignment). A code no row chose keeps
    its mean. red: the group's reduction (`_Reduce`)."""
    red = red or _Reduce()
    means = red.rows(z_flat, init_idx)
    for _ in range(max(iters, 1)):
        counts, sums = _counts_and_sums(
            z_flat, nearest_codes(z_flat, means), k)
        counts, sums = red.psum(counts), red.psum(sums)
        new = sums / counts[:, None].clamp_min(1.0)
        means = torch.where(counts[:, None] > 0, new, means)
    counts, _ = _counts_and_sums(z_flat, nearest_codes(z_flat, means), k)
    return means, red.psum(counts)


def nearest_ema(z_e: torch.Tensor, state: EMAState) -> torch.Tensor:
    """z_e (..., D) -> int32 ids (...,) against the EMA codebook."""
    flat = z_e.reshape(-1, z_e.shape[-1])
    return nearest_codes(flat, state.codebook).reshape(z_e.shape[:-1])


def quantize_ema(z_e: torch.Tensor, state: EMAState, *, train: bool,
                 kmeans_iters: int = 10, threshold_ema_dead_code: int = 2,
                 draws=None, generator: torch.Generator | None = None,
                 group=None):
    """EMA vector quantization: (VQOutput, new state). At train time the
    first call bootstraps the codebook by kmeans on the batch, and every
    call moves the EMAs and re-seeds the codes whose EMA count fell
    below the threshold from the batch's rows. draws: (init_idx,
    expire_idx), either may be None (then drawn from `generator`).
    group: a process group, the JAX function's `axis_name` (module
    docstring)."""
    k, d = state.codebook.shape
    flat = z_e.reshape(-1, d).float()
    data = flat.detach()
    n = data.shape[0]
    red = _Reduce(group)
    n_draw = red.n_rows(n)
    init_idx, expire_idx = draws if draws is not None else (None, None)
    with torch.no_grad():
        if train and not bool(state.initialized):
            means, counts = _kmeans(data, k, kmeans_iters, _draw(
                n_draw, k, init_idx, generator, data.device), red)
            state = EMAState(means, counts, means * counts[:, None],
                             torch.ones_like(state.initialized))
        idx = nearest_codes(data, state.codebook)
    z_q = state.codebook[idx.long()].reshape(z_e.shape)
    commit_loss = COMMITMENT_WEIGHT * ((z_q.detach() - z_e) ** 2).mean()
    z_q_st = z_e + (z_q - z_e).detach()
    with torch.no_grad():
        counts, sums = _counts_and_sums(data, idx, k)
        if red.mode == "global":
            counts = red.psum(counts)
        e_mean = counts / n_draw
        perplexity = torch.exp(-(e_mean * torch.log(e_mean + 1e-10)).sum())
        new_state = state
        if train:
            if red.mode == "axis":
                counts = red.psum(counts.clone())
            sums = red.psum(sums)
            cluster_size = state.cluster_size * DECAY + counts * (1 - DECAY)
            embed_avg = state.embed_avg * DECAY + sums * (1 - DECAY)
            total = cluster_size.sum()
            smoothed = (cluster_size + EPS) / (total + k * EPS) * total
            codebook = embed_avg / smoothed[:, None]
            if threshold_ema_dead_code > 0:
                dead = cluster_size < threshold_ema_dead_code
                samples = red.rows(data, _draw(
                    n_draw, k, expire_idx, generator, data.device))
                codebook = torch.where(dead[:, None], samples, codebook)
                cluster_size = torch.where(
                    dead, float(threshold_ema_dead_code), cluster_size)
                embed_avg = torch.where(
                    dead[:, None], samples * threshold_ema_dead_code,
                    embed_avg)
            new_state = EMAState(codebook, cluster_size, embed_avg,
                                 state.initialized)
    out = VQOutput(commit_loss, z_q_st, perplexity,
                   idx.reshape(z_e.shape[:-1]))
    return out, new_state


def quantize_ood(z_e: torch.Tensor, state: EMAState) -> torch.Tensor:
    """Per-sample OOD score: the mean over (T, D) of (z_q - z_e)^2
    against the EMA codebook. z_e (B, T, D) -> (B,)."""
    z_q = state.codebook[nearest_ema(z_e, state).long()]
    return ((z_q.detach() - z_e) ** 2).mean(dim=(1, 2))
