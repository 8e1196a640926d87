"""Sequence-parallel causal ring attention.

Port of vq_vae_transformer_arc_welding_tpu/parallel/ring_attention.py
(`_ring_body`, `ring_causal_attention`). The sequence is split over a
mesh axis: each rank holds a block of the queries and, in turn, every
block of the keys and values, which rotate around the ring (each step
one `batch_isend_irecv` to the next rank and from the one before,
parallel/mesh.send_recv). Each step is an online-softmax update in
f32, with JAX's guard for rows that every key so far masks. The
products are plain `torch.matmul`, as JAX's are `einsum`: no TPU
kernel stands behind this module.
"""
from __future__ import annotations

import math

import torch

from .mesh import Mesh, all_gather, send_recv


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, index: int, ranks: list) -> torch.Tensor:
    """This rank's queries' causal attention over the whole ring. q, k,
    v: (B, H, T_local, D), the rank's block `index` of the sequence;
    ranks: the ring's global ranks in order. Returns (B, H, T_local, D)."""
    n_dev = len(ranks)
    b, h, tl, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    q_pos = index * tl + torch.arange(tl, device=q.device)
    m = torch.full((b, h, tl, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, tl, 1), device=q.device)
    acc = torch.zeros((b, h, tl, d), device=q.device)
    k_blk, v_blk = k, v
    nxt, prv = ranks[(index + 1) % n_dev], ranks[(index - 1) % n_dev]
    for step in range(n_dev):
        src = (index - step) % n_dev
        k_pos = src * tl + torch.arange(tl, device=q.device)
        causal = (q_pos[:, None] >= k_pos[None, :])[None, None]
        s = (q32 @ k_blk.float().transpose(-1, -2)) * scale
        s = s.masked_fill(~causal, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.where(causal, torch.exp(s - m_safe), 0.0)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ v_blk.float()
        m = m_new
        if step < n_dev - 1:
            k_blk = send_recv(k_blk, nxt, prv, group)
            v_blk = send_recv(v_blk, nxt, prv, group)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def ring_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mesh: Mesh, axis_name: str = "model"
                          ) -> torch.Tensor:
    """q, k, v: (B, H, T, D), the whole sequence on every rank of the
    axis, T divisible by the axis size. Each rank computes its block of
    the queries around the ring; the blocks are gathered, so every rank
    returns (B, H, T, D), dense causal attention's result."""
    n_dev = mesh.shape[axis_name]
    t = q.shape[2]
    assert t % n_dev == 0, "sequence must divide the ring size"
    tl = t // n_dev
    i = mesh.axis_index(axis_name)
    group = mesh.group(axis_name)
    out = ring_attention_local(
        *(z[:, :, i * tl:(i + 1) * tl] for z in (q, k, v)),
        group, i, mesh.group_ranks(axis_name))
    return all_gather(out, group, dim=2)
