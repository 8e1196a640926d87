"""The bf16 attention tile's arithmetic (csrc/attention_bf16.cuh) against
the JAX package, on the CPU.

Kernel #9 on bf16 q, k and v (csrc/flash_attn.cu, flash_attention_bf16)
runs Q K^T and P V as bf16 mma.sync products with f32 sums: a product of
two bf16 values is exact in f32, so the scores are the f32 dot of the
widened operands up to the order of the sum; the scale multiplies that
sum afterwards, as the JAX kernel (ops/pallas_attn.py:_attn_kernel) does;
the softmax is f32, its e^x 2^(x log2 e) with the argument rounded once;
P, which is f32, goes into P V as three bf16 terms, hi = bf16(p),
mid = bf16(p - hi), lo = bf16(p - hi - mid), each 16-key chunk's three
products into a fresh accumulator added to the running f32 sum with one
rounded add. The CUDA kernel runs only on the card, so its arithmetic is
emulated here in plain PyTorch, tile by tile as the kernel walks T:
blocks of 64 query rows laid from the end of the sequence, 64-key
stages, the row max kept online and the division by the row sum after
P V. The tensor core's sums are modelled as exact and then truncated to
f32 (it truncates where a rounded add would round).

The gate is the card's (chip_smoke.py, tests/test_torch_cuda.py): at
most 1e-3 of the bf16 outputs differ from the other side's, each by one
bf16 step or, near 0 where a step is finer, by at most 2e-5. It holds
against the JAX kernel in interpret mode and against the port's plain
version (the f32 core on the widened operands, rounded to bf16) at head
widths 24, 64 and 128, with scores of order 1 and scaled x8. Three bf16
terms (8 significant bits each) hold an f32 p exactly; two leave ~2^-17
of it and miss the gate.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_transformer_arc_welding_tpu.ops import pallas_attn
from vq_vae_transformer_arc_welding_tpu_torch.ops import attention, fused_attn

# the tile (csrc/attention_bf16.cuh): rows a block and a warp, keys a
# stage, keys a P V product (the k of mma.m16n8k16), head dims a Q K^T step
QROWS, WROWS, KT, KC, KD = 64, 16, 64, 16, 16
MAX_SHARE, NEAR_ZERO = 1e-3, 2e-5          # the card's gate
T = 321


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 to nearest even, back in f32."""
    return x.to(torch.bfloat16).float()


def trunc32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> f32 rounded toward zero, as the tensor core ends a sum."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """The tile's e^x: 2^(x log2 e) with the argument rounded to f32, the
    power rounded once (ex2.approx's own error of up to 2 ulp is not
    modelled)."""
    arg = x * torch.tensor(1.4426950408889634, dtype=torch.float32)
    return torch.exp2(arg.double()).float()


def split_terms(p: torch.Tensor, n: int) -> list:
    """p as n bf16 terms: each the bf16 rounding of what the earlier
    ones left (exact f32 differences)."""
    terms = []
    for _ in range(n):
        terms.append(bf16(p))
        p = p - terms[-1]
    return terms


def padded_head(hd: int) -> int:
    """attention_bf16.cuh::padded_head."""
    return 16 if hd <= 16 else 32 if hd <= 32 else 64 if hd <= 64 else 128


def tc_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (..., M, D) . k (..., N, D) of bf16 values as the kernel sums
    them: one accumulator carried through the k16 steps over the head
    dims, each step's 16 exact products added and truncated to f32."""
    s = torch.zeros(*q.shape[:-1], k.shape[-2], dtype=torch.float32)
    for e in range(0, q.shape[-1], KD):
        s = trunc32(s.double() + q[..., e:e + KD].double()
                    @ k[..., e:e + KD].double().transpose(-1, -2))
    return s


def warp_chunks(w0: int, k0: int) -> int:
    """The 16-key chunks of the stage at k0 that the warp of rows
    [w0, w0 + 16) computes: keys below its last row + 1."""
    return min(max(-(-(w0 + WROWS - k0) // KC), 0), KT // KC)


def tile_attention(q, k, v, terms: int = 3) -> torch.Tensor:
    """Causal softmax(q k^T / sqrt(D)) v as the bf16 tile computes it,
    with P V on `terms` bf16 terms of P. q, k, v (B, H, T, D): bf16
    values in f32. Returns the output rounded to bf16. Chunks that a
    warp skips hold only masked keys, which add exact zeros here."""
    b, h, t, d = q.shape
    hd = padded_head(d)
    q, k, v = (torch.nn.functional.pad(z, (0, hd - d)) for z in (q, k, v))
    sm_scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    out = torch.zeros(b, h, t, hd)
    for z in range(math.ceil(t / QROWS)):
        rows = torch.arange(t - QROWS * (z + 1), t - QROWS * z)
        valid = rows >= 0
        lim = rows.clamp(min=0)            # an idle row attends to key 0
        qb = q[:, :, lim]
        m = torch.full((b, h, QROWS, 1), -math.inf)
        l = torch.zeros(b, h, QROWS, 1)
        o = torch.zeros(b, h, QROWS, hd)
        for k0 in range(0, int(rows[-1]) + 1, KT):
            kt = torch.zeros(b, h, KT, hd)
            vt = torch.zeros(b, h, KT, hd)
            n = min(KT, t - k0)
            kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
            s = tc_scores(qb, kt) * sm_scale
            causal = (k0 + torch.arange(KT))[None, :] <= lim[:, None]
            s = s.masked_fill(~causal, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = exp_f32(m - m_new)
            p = exp_f32(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha
            parts = split_terms(p, terms)
            for c0 in range(0, KT, KC):
                acc = torch.zeros_like(o)
                for x in parts[::-1]:          # lo, mid, hi
                    acc = trunc32(acc.double() + x[..., c0:c0 + KC].double()
                                  @ vt[:, :, c0:c0 + KC].double())
                o = o + acc
            m = m_new
        out[:, :, rows[valid]] = (o / l)[:, :, valid]
    return out[..., :d].to(torch.bfloat16)


def qkv(d: int, score_scale: float, seed: int, heads: int = 4):
    """bf16 q, k, v (1, heads, T, d) from numpy: q and k of spread
    sqrt(score_scale), so that the scores have a spread of score_scale;
    v of spread 1."""
    rng = np.random.default_rng(seed)
    qk = math.sqrt(score_scale)
    return [torch.from_numpy((rng.standard_normal((1, heads, T, d)) * sc)
                             .astype(np.float32)).to(torch.bfloat16)
            for sc in (qk, qk, 1.0)]


def jax_kernel(q, k, v) -> torch.Tensor:
    """The JAX Pallas kernel in interpret mode on the same bf16 operands."""
    out = pallas_attn.flash_causal_attention(
        *(jnp.asarray(z.float().numpy()).astype(jnp.bfloat16)
          for z in (q, k, v)))
    return torch.from_numpy(np.asarray(out.astype(jnp.float32))).to(
        torch.bfloat16)


def gate(out: torch.Tensor, ref: torch.Tensor):
    """(share of differing entries, entries beyond one bf16 step and
    NEAR_ZERO) of two bf16 tensors."""
    ulps = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    err = (out.float() - ref.float()).abs()
    return (float((ulps > 0).float().mean()),
            int(((ulps > 1) & (err > NEAR_ZERO)).sum()))


@pytest.mark.parametrize("score_scale", [1.0, 8.0], ids=["scores", "x8"])
@pytest.mark.parametrize("d", [24, 64, 128])
def test_bf16_tile_matches_jax_and_plain(d, score_scale):
    q, k, v = qkv(d, score_scale, seed=d)
    tile = tile_attention(q.float(), k.float(), v.float())
    for ref in (jax_kernel(q, k, v),
                fused_attn.flash_causal_attention_reference(q, k, v)):
        assert ref.dtype == torch.bfloat16
        share, far = gate(tile, ref)
        assert far == 0 and share <= MAX_SHARE, (share, far)


@pytest.mark.parametrize("d", [24, 128])
def test_uniform_scores_tile_equals_jax_where_plain_parts(d):
    """q = 0: every score of a row is 0, p = 1, and the output is the
    running mean of v. The tile, like the JAX kernel, divides by the row
    sum after P V and equals it bit for bit, within the gate of the
    float64 attention; the plain version normalises p first (1 / n
    rounded) and parts from both on more than 1e-3 of the entries, so
    the card holds this case against float64
    (tests/test_torch_cuda.py::test_flash_attention_bf16_tied_scores)."""
    _, k, v = qkv(d, 1.0, seed=d + 3)
    q = torch.zeros_like(k)
    tile = tile_attention(q.float(), k.float(), v.float())
    exact = attention.causal_attention_core(
        q.double(), k.double(), v.double()).to(torch.bfloat16)
    assert torch.equal(tile, jax_kernel(q, k, v))
    share, far = gate(tile, exact)
    assert far == 0 and share <= MAX_SHARE / 10
    plain = fused_attn.flash_causal_attention_reference(q, k, v)
    assert gate(plain, exact)[0] > MAX_SHARE


@pytest.mark.parametrize("d", [24, 64, 128])
def test_two_bf16_terms_of_p_miss_the_gate(d):
    """hi + mid leave ~2^-17 of each p: enough to move more than 1e-3 of
    the bf16 outputs across a rounding boundary, which is why the tile
    takes a third term."""
    q, k, v = qkv(d, 1.0, seed=d)
    plain = fused_attn.flash_causal_attention_reference(q, k, v)
    two = tile_attention(q.float(), k.float(), v.float(), terms=2)
    assert gate(two, plain)[0] > MAX_SHARE
    three = tile_attention(q.float(), k.float(), v.float(), terms=3)
    assert gate(three, plain)[0] <= MAX_SHARE / 2


def test_three_bf16_terms_hold_p():
    # softmax numerators exp(s - max) for s - max in [-30, 0]
    p = torch.exp(-torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 30.0, 100_000).astype(np.float32)))
    rel = lambda n: float(((sum(t.double() for t in split_terms(p, n))
                            - p.double()).abs() / p.double()).max())
    # bf16 keeps 8 significant bits of 24: three terms hold p exactly
    assert rel(1) <= 2 ** -8 and rel(2) <= 2 ** -16 and rel(3) == 0.0
    assert rel(2) > 2 ** -24       # two terms do not


def _sum_bound(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The classic bound of an f32 sum of D products: D u sum |q_e k_e|."""
    d = q.shape[-1]
    return d * 2.0 ** -24 * (q.double().abs() @ k.double().abs().T)


@pytest.mark.parametrize("d", [24, 64, 128])
def test_bf16_product_scores_equal_the_widened_dot(d):
    """The tile's scores (exact bf16 products, truncated f32 sums) and
    the widened f32 dot both lie within f32 summation rounding of the
    exact dot, and so within twice that of each other."""
    q, k, _ = (z[0, 0].float() for z in qkv(d, 8.0, seed=d + 1))
    hd = padded_head(d)
    pad = lambda z: torch.nn.functional.pad(z, (0, hd - d))
    tile = tc_scores(pad(q), pad(k)).double()
    widened = (q @ k.T).double()
    exact = q.double() @ k.double().T
    bound = _sum_bound(q, k)
    assert bool(((tile - exact).abs() <= bound).all())
    assert bool(((widened - exact).abs() <= bound).all())
    assert bool(((tile - widened).abs() <= 2 * bound).all())


def test_prescaled_q_moves_the_scores_at_d24():
    """1/sqrt(24) is not a power of two: q * scale rounded to bf16 before
    the product moves most scores by far more than f32 summation
    rounding, so the tile scales the f32 sum, as JAX does. At D = 64 the
    scale is 1/8 and a pre-scaled q is exact."""
    for d, moved in ((24, True), (64, False)):
        q, k, _ = (z[0, 0].float() for z in qkv(d, 8.0, seed=d + 2))
        hd = padded_head(d)
        pad = lambda z: torch.nn.functional.pad(z, (0, hd - d))
        scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
        after = tc_scores(pad(q), pad(k)) * scale
        before = tc_scores(pad(bf16(q * scale)), pad(k))
        beyond = ((after - before).double().abs()
                  > 2 * scale.double() * _sum_bound(q, k))
        if moved:
            assert float(beyond.float().mean()) > 0.5
        else:
            assert torch.equal(after, before)


@pytest.mark.parametrize("first", [1, 331])
def test_tile_walk_computes_every_needed_key(first):
    """For every T in a range of 330: the 64-row blocks laid from the end
    hold each row once, only the block at the start of the sequence is
    short, and each warp's chunks of a stage (warp_chunks, the kernel's
    nc) reach every key up to the warp's last row, while the chunks it
    skips hold only keys past that row (masked for all its rows)."""
    for t in range(first, first + 330):
        held = []
        for z in range(math.ceil(t / QROWS)):
            q_end = t - QROWS * z
            assert q_end - QROWS >= 0 or z == math.ceil(t / QROWS) - 1
            held += [r for r in range(q_end - QROWS, q_end) if r >= 0]
            for w in range(QROWS // WROWS):
                w0 = q_end - QROWS + WROWS * w
                last = w0 + WROWS - 1
                for k0 in range(0, q_end, KT):
                    stop = k0 + KC * warp_chunks(w0, k0)
                    assert stop > min(last, k0 + KT - 1) or last < k0
                    assert stop == k0 + KT or stop > last
        assert sorted(held) == list(range(t))
