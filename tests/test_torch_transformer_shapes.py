"""Every transformer the transformer CLI can build, on the CPU.

The transformer CLI takes any --d-model with any --n-heads that divides
it; the JAX package's Pallas kernels take every such width. The port's
int8 GEMM, LN+q8 and f32 attention take every C from 1 to 4,096 in any
heads (a head past 128 on the f32 attention's wide tile), and its plain
int8 product is exact at every K and N. The kernels run only on the
card (tests/test_torch_cuda.py, chip_smoke.py's transformer shapes
phase); here:

- one-block models at (C, heads) = (100, 4), (1,100, 4) and (192, 1):
  C off 16, C above 1,024, and heads of 25, 275 and 192, through the
  port's plain path against JAX's `quantized_classify` (block_fusion
  None, 'attn', 'full' and fused_attention=True, its Pallas kernels in
  interpret mode), with tests/test_torch_quantized.py's `CLASSIFY_CASES`
  tolerances, on the same weights (`bridge.transformer_from_jax`) and
  the same int8 qparams (`bridge.qparams_from_jax`);
- the new pieces emulated against their plain versions: the wide tile's
  score chain carried over 128-column chunks (bit for bit the unchunked
  chain) and its output, LN+q8's runtime-width sum order (the
  template's, where the template runs), and the operands of the repaired
  int8 products (`int8.int_mm_operands`, `int8.k_pieces`).
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models import (
    TransformerDecoder as JaxTransformer)
from vq_vae_transformer_arc_welding_tpu.models import quantized as jq
from vq_vae_transformer_arc_welding_tpu_torch import bridge, kernels
from vq_vae_transformer_arc_welding_tpu_torch.models import quantized as pq
from vq_vae_transformer_arc_welding_tpu_torch.ops import int8
from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
    causal_attention_core)
from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm

from test_torch_attention_split import fma_scores
from test_torch_quantized import CLASSIFY_CASES
from test_torch_widths import MAX_ATTN_ERR, padded_tile_attention

T = 33                        # two cycles and the start token
K_VQ = 32                     # codes; ids below it, the start token K_VQ
WIDTHS = [(100, 4), (1100, 4), (192, 1)]
PIECE = 128                   # csrc/attention_tc.cuh's wide tile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers', so these tests use one and give it back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def _ids(seed: int) -> np.ndarray:
    ids = np.random.default_rng(seed).integers(0, K_VQ, (2, T))
    ids[:, 0] = K_VQ
    return ids.astype(np.int32)


@functools.cache
def _models(c: int, n_head: int):
    """The JAX one-block transformer at (c, n_head) and its int8
    qparams, and the port's model and qparams bridged from them. The
    act absmax is the port's calibration on the same ids, the JAX one's
    (tests/test_torch_quantized.py holds the two equal)."""
    jm = JaxTransformer(d_model=c, n_classes=K_VQ + 2, seq_len=T,
                        n_blocks=1, n_head=n_head)
    params, _ = jm.init(c)
    port = bridge.transformer_from_jax(jm.hparams, params, device="cpu")
    am = pq.calibrate_activation_absmax(port, torch.from_numpy(_ids(1)))
    jqp = jq.quantize_transformer(params, am)
    return jm, jqp, port, bridge.qparams_from_jax(jqp, device="cpu")


FOUR_PATHS = [case for case in CLASSIFY_CASES if case[0] in (
    {}, {"block_fusion": "attn"}, {"block_fusion": "full"},
    {"fused_attention": True})]


@pytest.mark.parametrize("kw,tol", FOUR_PATHS,
                         ids=lambda v: str(v) if isinstance(v, dict) else "")
@pytest.mark.parametrize("c,n_head", WIDTHS, ids=lambda v: str(v))
def test_classify_matches_jax_at_any_width(c, n_head, kw, tol):
    """quantized_classify at widths the port's kernels once refused: the
    port's plain path against JAX's, whose fused variants are its Pallas
    kernels in interpret mode at these widths."""
    jm, jqp, port, qp = _models(c, n_head)
    ids = _ids(2)
    ref = np.asarray(jq.quantized_classify(jm, jqp, jnp.asarray(ids), **kw))
    out = _np(pq.quantized_classify(port, qp, torch.from_numpy(ids), **kw))
    assert out.shape == (2, 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


# -- the f32 attention's wide tile ----------------------------------------------

def fma_chain(q, k, s):
    """s carried on by the FMA chain over q's and k's columns in order
    (fma_scores from a given start)."""
    s = s.double()
    for d in range(q.shape[-1]):
        s = (s + q[..., d, None].double() * k[..., None, :, d].double()
             ).float().double()
    return s.float()


def wide_tile_scores(q, k):
    """The wide tile's scores: one accumulator per (row, key), carried
    across the head's 128-column chunks of Q and K in order, each chunk
    zero-filled past the head in shared memory."""
    hd = q.shape[-1]
    s = torch.zeros(*q.shape[:-1], k.shape[-2])
    for e0 in range(0, hd, PIECE):
        pad = (0, PIECE - min(PIECE, hd - e0))
        s = fma_chain(torch.nn.functional.pad(q[..., e0:e0 + PIECE], pad),
                      torch.nn.functional.pad(k[..., e0:e0 + PIECE], pad), s)
    return s


def _heads(h, t, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((1, h, t, hd)) * 2.0)
                             .astype(np.float32)) for _ in range(3)]


@pytest.mark.parametrize("hd", [192, 275, 300])
def test_wide_tile_scores_are_the_unchunked_chain(hd):
    """The chunked chain gives the unchunked chain's bits (a zero column
    adds an exact 0.0): the scores round as the narrow tile's and the
    plain GEMM's do."""
    q, k, _ = _heads(2, 40, hd, seed=hd)
    assert torch.equal(wide_tile_scores(q, k), fma_scores(q, k))


@pytest.mark.parametrize("hd,t", [(192, 70), (275, 45)])
def test_wide_tile_attention_matches_plain(hd, t):
    """The wide tile's output: each piece of 128 columns is P@V in split
    TF32 for its own columns of V on the same P, so the whole is the
    tile's arithmetic at the head padded to its pieces; within #9's 2e-5
    of the plain core."""
    q, k, v = _heads(1, t, hd, seed=t)
    width = PIECE * -(-hd // PIECE)
    out = padded_tile_attention(q, k, v, width)
    assert float((out - causal_attention_core(q, k, v)).abs().max()) \
        <= MAX_ATTN_ERR


def test_wide_tile_in_the_header():
    """The wide tile's piece and widest head as compiled, and the widest
    C of the kernels beside the wrappers' limit."""
    text = (kernels.SRC_DIR / "attention_tc.cuh").read_text()
    assert "constexpr int PIECE = MAX_HD;" in text
    assert f"constexpr int MAX_WIDE_HD = {kernels.MAX_WIDTH};" in text
    block = (kernels.SRC_DIR / "int8_block.cuh").read_text()
    assert f"constexpr int MAX_C = {kernels.MAX_WIDTH};" in block


# -- LN+q8 at a runtime width ----------------------------------------------------

def template_order(c: int) -> list:
    """The columns lane L of csrc/ln_q8.cuh's template sums, in order:
    it loads V neighbouring columns of every 32 V (V = 4, or 2 where C
    is an odd multiple of 64), stores them to shared memory where they
    stand, and reads back tile[32 i + lane], i = 0 .. C / 32 - 1."""
    v = 4 if c % 128 == 0 else 2
    n = c // (32 * v)
    tile = {}
    for lane in range(32):
        for i in range(n):
            for j in range(v):
                col = v * (32 * i + lane) + j
                tile[col] = col            # a lane's values, where they stand
    return [[tile[32 * i + lane] for i in range(c // 32)]
            for lane in range(32)]


def runtime_order(c: int) -> list:
    """The columns lane L of ln_q8_any_kernel sums, in order."""
    return [list(range(lane, c, 32)) for lane in range(32)]


def warp_sum(parts: torch.Tensor) -> torch.Tensor:
    """common.cuh's warp_sum on (..., 32) lane values: the xor butterfly
    over offsets 16, 8, 4, 2, 1, one f32 add a step."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        parts = parts + parts[..., lanes ^ o]
    return parts


def ln_q8_emulated(x, scale, bias, qs):
    """ln_q8_any_kernel on (rows, C) f32: lane sums in runtime_order,
    the butterfly, then the template's roundings for each value."""
    c = x.shape[-1]
    order = runtime_order(c)

    def lane_sums(vals):
        out = torch.zeros(*vals.shape[:-1], 32)
        for lane, cols in enumerate(order):
            for col in cols:
                out[..., lane] = out[..., lane] + vals[..., col]
        return warp_sum(out)[..., :1]
    c32 = torch.tensor(float(c))
    mean = lane_sums(x) / c32
    d = x - mean
    var = lane_sums(d * d) / c32
    sd = torch.sqrt(var + torch.tensor(1e-5))
    y = (x - mean) / sd
    return int8.quantize_act(y * scale + bias, qs)


def test_ln_q8_runtime_order_is_the_templates():
    """Where the template runs (C a multiple of 64 up to 1,024), the
    runtime-width kernel's lanes sum the same columns in the same order:
    h8 keeps its bits there."""
    for c in range(64, 1025, 64):
        assert template_order(c) == runtime_order(c), c


@pytest.mark.parametrize("c", [1, 6, 100, 1100, 1600, 4096])
def test_ln_q8_runtime_width_matches_plain(c):
    """The runtime-width kernel's arithmetic against the plain LayerNorm
    + q8 (torch's mean, another order): within the int8 contract, one
    step on at most 0.1% of the entries (none expected)."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn(48, c, generator=g) * 3 + 0.5
    scale = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g) * 0.1
    qs = torch.tensor(30.0)
    got = ln_q8_emulated(x, scale, bias, qs)
    ref = int8.quantize_act(layer_norm(x, scale, bias), qs)
    diff = (got.int() - ref.int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) <= 1e-3


# -- the exact int8 products -------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 258])
@pytest.mark.parametrize("k", [1041, 1600, 4096])
def test_int_mm_operands_give_the_int32_product(k, n):
    """The zero-padded operands torch._int_mm takes on the card (K and N
    to multiples of 8, the rows past 16): their product, cut back to
    (M, N), is the int32 product at K past the f32 product's 1,040."""
    rng = np.random.default_rng(k + n)
    for m in (3, 40):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (n, k), np.int8))
        a_p, w_p = int8.int_mm_operands(a, w)
        assert a_p.shape[0] > 16 and a_p.shape[1] % 8 == 0
        assert w_p.shape[0] % 8 == 0 and w_p.shape[1] == a_p.shape[1]
        assert a_p.is_contiguous() and w_p.is_contiguous()
        got = (a_p.long() @ w_p.long().t())[:m, :n]
        assert torch.equal(got, a.long() @ w.long().t())


@pytest.mark.parametrize("k", [1040, 1041, 1600, 4096])
def test_k_pieces_sum_exact_f32_products(k):
    """int8_bmm's product on the card: f32 products over pieces of at
    most 1,040 terms (each exact: |sum| < 2^24), summed in int32, equal
    the int32 product, with sums of +-127^2 K past 2^24."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(np.where(rng.random((2, 5, k)) < 0.9, 127,
                                  -127).astype(np.int8))
    b = torch.from_numpy(np.where(rng.random((2, k, 3)) < 0.9, 127,
                                  -127).astype(np.int8))
    pieces = int8.k_pieces(k)
    assert all(p.stop - p.start <= int8.F32_EXACT_K for p in pieces)
    assert int8.F32_EXACT_K * 127 * 127 < 2 ** 24 \
        <= (int8.F32_EXACT_K + 1) * 127 * 127
    got = sum((a[..., p].float() @ b[..., p, :].float()).to(torch.int32)
              for p in pieces)
    want = a.long() @ b.long()
    assert torch.equal(got.long(), want)
    if k >= 1600:
        assert int(want.abs().max()) >= 2 ** 24
