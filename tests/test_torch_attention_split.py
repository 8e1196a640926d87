"""The f32 attention tile's arithmetic (csrc/attention_tc.cuh) against the
JAX package, on the CPU.

Kernel #9 (csrc/flash_attn.cu) and the f32 attention of the int8 kernels
(csrc/int8_block.cu: #2, #6, #10, #11) sum Q K^T as an FP32 FMA chain over
the head dims in order, and run P V on the tensor cores in TF32 with a
3-term split: every f32 operand x is rounded to hi = tf32(x) (`cvt.rna`:
round to nearest on the magnitude, ties away from zero) and
lo = tf32(x - hi), and each 8-key step sums lo*hi + hi*lo + hi*hi into a
fresh accumulator that is added to the f32 running sum. The CUDA kernel
runs only on the card, so its arithmetic is emulated here in plain
PyTorch, tile by tile as the kernel walks T: blocks of query rows laid
from the end of the sequence, keys in stages, the row max kept online
and the division by the row sum after P V. Each 8-key step's three
products are summed in float64 and rounded once (the tensor core's own
rounding inside a step is finer than what these tolerances see).

Tolerances: the 3-term split within 2e-5 of
`ops/attention.py::causal_attention_core` (the bound chip_smoke holds
kernel #9 to), on q, k, v drawn with numpy at a spread whose scores
reach ~20 and |v| ~10; TF32 alone in P V misses it by more than 1e-3,
which is why the split is there. At larger scores any two f32 attentions
that sum in other orders part by more than 2e-5 (a score of 60 that
rounds elsewhere moves p by ~4e-6 of itself): there the emulation is
held to the plain core summed in a plain f32 GEMM's order, the order
its FMA chain keeps.
"""
import math

import numpy as np
import pytest
import torch

from vq_vae_transformer_arc_welding_tpu.ops import attention as jattention
from vq_vae_transformer_arc_welding_tpu_torch.ops import attention

# the kernels' tile (Tile<8, 1, 64, 2>): rows a block, keys a stage, and
# the k step of mma.m16n8k8
QROWS, KT, KSTEP = 128, 64, 8


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with
    ties away from zero (on the magnitude bits, so for either sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def fma_scores(q, k):
    """q (..., M, D) . k (..., N, D) summed over d = 0 .. D-1 in order,
    one f32 rounding per step, as an FMA chain does."""
    s = torch.zeros(*q.shape[:-1], k.shape[-2], dtype=torch.float64)
    for d in range(q.shape[-1]):
        s = (s + q[..., d, None].double() * k[..., None, :, d].double()
             ).float().double()
    return s.float()


def mma_acc(acc, a, b, terms: int):
    """acc + a @ b (f32) one 8-wide k step at a time: the step's products
    (3-term split or TF32 alone) summed and rounded to f32, then one f32
    add into acc."""
    if terms == 3:
        (ah, al), (bh, bl) = split(a), split(b)
        pairs = ((al, bh), (ah, bl), (ah, bh))
    else:
        pairs = ((tf32(a), tf32(b)),)
    for k0 in range(0, a.shape[-1], KSTEP):
        step = sum(x[..., k0:k0 + KSTEP].double()
                   @ y[..., k0:k0 + KSTEP, :].double() for x, y in pairs)
        acc = acc + step.float()
    return acc


def query_blocks(t: int, rows: int = QROWS):
    """The kernel's grid over T: block z holds rows [t - rows (z + 1),
    t - rows z); rows below 0 are idle, so a ragged T leaves its short
    block at the rows with the fewest keys."""
    return [range(t - rows * (z + 1), t - rows * z)
            for z in range(math.ceil(t / rows))]


def tile_attention(q, k, v, terms: int = 3, tc_scores: bool = False):
    """Causal softmax(q k^T / sqrt(64)) v as the kernel computes it, P V
    with `terms` TF32 products; tc_scores: Q K^T in split TF32 as well
    (the design the kernel does not take). q, k, v (B, H, T, 64) f32.
    Returns the output and how many times each row was written."""
    b, h, t, d = q.shape
    out = torch.zeros_like(q)
    written = torch.zeros(t, dtype=torch.int64)
    sm_scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    for rows in query_blocks(t):
        r = torch.tensor(list(rows))
        valid = r >= 0
        lim = r.clamp(min=0)            # an idle row attends to key 0
        qb = q[:, :, lim] * valid[:, None]
        m = torch.full((b, h, QROWS, 1), -math.inf)
        l = torch.zeros(b, h, QROWS, 1)
        o = torch.zeros(b, h, QROWS, d)
        for k0 in range(0, rows.stop, KT):
            kt = torch.zeros(b, h, KT, d)
            vt = torch.zeros(b, h, KT, d)
            n = min(KT, t - k0)
            kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
            s = (mma_acc(torch.zeros(b, h, QROWS, KT), qb,
                         kt.transpose(-1, -2), 3) if tc_scores
                 else fma_scores(qb, kt)) * sm_scale
            causal = (k0 + torch.arange(KT))[None, :] <= lim[:, None]
            s = s.masked_fill(~causal, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = mma_acc(o * alpha, p, vt, terms)
            m = m_new
        out[:, :, r[valid]] = (o / l)[:, :, valid]
        written[r[valid]] += 1
    return out, written


def _qkv(b: int, scale: float, seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 8, 321, 64)) * scale).astype(np.float32)
            for _ in range(3)]


def _jax_core(q, k, v) -> np.ndarray:
    return np.asarray(jattention.causal_attention_core(q, k, v))


@pytest.mark.parametrize("b", [1, 2])
def test_split_tf32_attention_matches_jax(b):
    q, k, v = _qkv(b, 2.0, seed=b)
    out, written = tile_attention(*map(torch.from_numpy, (q, k, v)))
    assert bool((written == 1).all())
    ref = _jax_core(q, k, v)
    assert np.abs(out.numpy() - ref).max() <= 2e-5


@pytest.mark.parametrize("b", [1, 2])
def test_tf32_alone_misses_the_f32_contract(b):
    q, k, v = _qkv(b, 2.0, seed=b)
    out, _ = tile_attention(*map(torch.from_numpy, (q, k, v)), terms=1)
    assert np.abs(out.numpy() - _jax_core(q, k, v)).max() > 1e-3


def _plain_f32_gemm_order(q, k, v):
    """The plain core with each product summed as an FMA chain in order,
    the order of a plain f32 GEMM (cuBLAS's on the card)."""
    t = q.shape[2]
    s = fma_scores(q, k) * torch.tensor(0.125)
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -math.inf)
    return fma_scores(torch.softmax(s, -1), v.transpose(-1, -2))


@pytest.mark.parametrize("scale", [2.0, 3.6])
def test_fma_chain_scores_keep_the_plain_rounding(scale):
    """Against the plain core summed in a plain GEMM's order, the
    kernel's arithmetic stays within 2e-5 up to chip_smoke's spread for
    #9 (x3.6: scores in the sixties); Q K^T in split TF32 parts from it
    by more there, though it is closer to float64."""
    q, k, v = map(torch.from_numpy, _qkv(1, scale, seed=3))
    plain = _plain_f32_gemm_order(q, k, v)
    kernel, _ = tile_attention(q, k, v)
    assert (kernel - plain).abs().max() <= 2e-5
    if scale > 3:
        split_scores, _ = tile_attention(q, k, v, tc_scores=True)
        assert (split_scores - plain).abs().max() > 2e-5
        exact = attention.causal_attention_core(q.double(), k.double(),
                                                v.double())
        assert ((split_scores.double() - exact).abs().max()
                < (plain.double() - exact).abs().max())


@pytest.mark.parametrize("first", [1, 351])
@pytest.mark.parametrize("rows", [64, QROWS])
def test_query_blocks_cover_each_row_once(first, rows):
    """For every T in 1..700 the blocks hold rows 0..T-1 once each, and
    only the block at the start of the sequence is short."""
    for t in range(first, first + 350):
        blocks = query_blocks(t, rows)
        held = [r for blk in blocks for r in blk if r >= 0]
        assert sorted(held) == list(range(t))
        assert all(blk.start >= 0 for blk in blocks[:-1])
        assert blocks[-1].stop == t - rows * (len(blocks) - 1) > 0


def test_tf32_rounds_ties_away_from_zero():
    # 1 + 2^-11 lies halfway between two TF32 values: away from zero
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3.0]
    hi, lo = split(torch.tensor([math.pi], dtype=torch.float32))
    assert abs(float(hi + lo) - math.pi) < 2 ** -21
