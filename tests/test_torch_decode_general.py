"""The general form of the decode kernels #12 and #13 (csrc/decode.cu),
emulated on the CPU.

The general form takes every (C, heads) the transformer CLI builds. Its
products walk each depth in pieces of up to `fused_decode.PIECE` = 512
floats (the last one shorter, a multiple of 64) over weights in rows of
pad64(k) floats or packed in the order it reads them
(`fused_decode._packed`: one bulk copy a chunk of 8 columns x a piece,
as BlockDecodeStack hands them), warp w taking the 16-column blocks w,
w + 8, .. of every piece, the warps' sums added in order; m_proj is
split over the grid in ranges of its pieces (`mp_ranges`). Heads past
128 spread their keys over the block's 8 warps, each with its own online
softmax, and over blocks in key ranges where the (sample, head) items
are fewer than half the grid (`wide_ranges`), the partials merged in
order. Held here:

- the packed layout, the blocks' shares of every product's columns and
  pieces on a 132-SM grid, the form csrc/decode.cu picks, and the
  weights the per-call wrappers hand it (their own, where k is a
  multiple of 64);
- the products' order of sums (split TF32 as the tensor core reads it,
  the short last piece, each warp's blocks, the warps in order, m_proj's
  ranges) and the wide attention (warps, key ranges, passes of 512
  columns) emulated, a whole #12 and #13 step at C 1,800 in heads of 300
  and C 200 in heads of 25 against the plain versions and JAX's
  `pallas_decode` kernels in interpret mode, within the card's gates
  (the stream 1e-4, the written cache row 2e-5);
- the wide attention alone at heads of 192, 300 and 4,096 against the
  plain softmax attention, at positions whose keys cross a range edge.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_transformer_arc_welding_tpu.ops import pallas_decode
from vq_vae_transformer_arc_welding_tpu_torch import entry
from vq_vae_transformer_arc_welding_tpu_torch.ops import fused_decode as fdec
from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import (
    new_gelu)

from test_torch_narrow_widths import _jax_model, _kernel_ln_stats

GRID = 132                  # an H100's SMs: the kernels' grid
WARPS, NCOL, MAX_CG = 8, fdec.NCOL, fdec.MAX_COLS // fdec.NCOL
MIN_RANGE_KEYS = 16
# the transformer CLI's widths (chip_smoke.py's NW_SHAPES) and the bench
# model's
WIDTHS = [(200, 8), (192, 1), (1100, 4), (1600, 25), (1800, 6), (2048, 8),
          (4096, 1), (512, 8)]


# -- the layout and the shares ------------------------------------------------

@pytest.mark.parametrize("n,k", [(5400, 1800), (1800, 7200), (600, 200),
                                 (13, 100)])
def test_packed_chunks_are_one_range(n, k):
    """`_packed` puts chunk j of piece q at 8 n8 PIECE q + 8 j kq floats,
    its 8 rows kq apart, the depth zero past k and the rows past n zero;
    `_unpacked` gives back the padded matrix."""
    piece = fdec.PIECE
    g = torch.Generator().manual_seed(n)
    w = torch.randn(n, k, generator=g)
    flat = fdec._packed(w, k)
    kp, n8 = fdec.pad64(k), -(-n // NCOL)
    assert flat.numel() == NCOL * n8 * kp
    for q, s in enumerate(range(0, kp, piece)):
        kq = min(piece, kp - s)
        for j in (0, n8 // 2, n8 - 1):
            at = NCOL * n8 * piece * q + NCOL * j * kq
            chunk = flat[at:at + NCOL * kq].view(NCOL, kq)
            rows = min(NCOL, n - NCOL * j)
            want = torch.zeros(NCOL, kq)
            want[:rows, :max(0, min(kq, k - s))] = w[
                NCOL * j:NCOL * j + rows, s:min(s + kq, k)]
            assert torch.equal(chunk, want)
    full = fdec._unpacked(flat, n, k)
    assert torch.equal(full[:, :k], w) and not full[:, k:].any()


def mp_ranges(nqt: int, n8: int, grid: int) -> int:
    """csrc/decode.cu::mp_ranges."""
    for s in range(nqt, 1, -1):
        per = grid // s
        if per >= 1 and -(-n8 // per) <= MAX_CG:
            return s
    return 1


def shares(c: int, c4: int, b: int, grid: int = GRID) -> list:
    """csrc/decode.cu::gshares for block b: per product (j0, ncol, ncg,
    q0, nq, nsplit, s, grp)."""
    out = []
    for i, (n, k) in enumerate(((3 * c, c), (c, c), (c4, c), (c, c4))):
        kp = fdec.pad64(k)
        n8, nqt = -(-n // NCOL), -(-kp // fdec.PIECE)
        ns = mp_ranges(nqt, n8, grid) if i == 3 else 1
        q0, nq, s, grp = 0, nqt, 0, 0
        if ns > 1:
            per = grid // ns
            s, grp = b // per, b % per
            if s < ns:
                j0, j1 = n8 * grp // per, n8 * (grp + 1) // per
                q0, nq = nqt * s // ns, nqt * (s + 1) // ns - nqt * s // ns
            else:
                j0 = j1 = 0
        else:
            j0, j1 = n8 * b // grid, n8 * (b + 1) // grid
        ncol = min(NCOL * j1, n) - NCOL * j0 if j1 > j0 else 0
        out.append((j0, ncol, j1 - j0 if ncol else 0, q0, nq, ns, s, grp))
    return out


@pytest.mark.parametrize("c,n_head", WIDTHS)
def test_shares_cover_every_chunk_and_piece_once(c, n_head):
    """Over the 132 blocks, every (column, piece) of every product is
    walked by exactly one block; m_proj's split keeps a block's columns
    one group (at most 32) and its count words within the barrier's; at
    C 1,800 each product takes 4 pieces and m_proj 15, in 2 ranges."""
    c4 = 4 * c
    seen = [np.zeros((n, -(-fdec.pad64(k) // fdec.PIECE)), np.int32)
            for n, k in ((3 * c, c), (c, c), (c4, c), (c, c4))]
    for b in range(GRID):
        for i, (j0, ncol, ncg, q0, nq, ns, s, grp) in enumerate(
                shares(c, c4, b)):
            assert ncg == -(-ncol // NCOL)
            seen[i][NCOL * j0:NCOL * j0 + ncol, q0:q0 + nq] += 1
            if ns > 1 and ncol:
                assert ncol <= fdec.MAX_COLS and grp < fdec.MAX_GRID
    assert all((s == 1).all() for s in seen)
    if c == 1800:
        assert [s.shape[1] for s in seen] == [4, 4, 4, 15]
        assert shares(c, c4, 0)[3][5] == 2


def wide_ranges(items: int, n: int, grid: int = GRID) -> int:
    """csrc/decode.cu::wide_ranges."""
    r = min(fdec.MAX_RANGES, grid // max(items, 1), n // MIN_RANGE_KEYS)
    return max(r, 1)


def first_form(c: int, c4: int, n_head: int, mlp: bool, grid: int) -> bool:
    """csrc/decode.cu::first_form."""
    if c % 64 or c4 % 64 or c // n_head > 128:
        return False
    cols = (3 * c, c, c4, c) if mlp else (3 * c, c)
    return all(-(-n // grid) <= fdec.MAX_COLS for n in cols)


@pytest.mark.parametrize("c,n_head", WIDTHS)
def test_form_and_scratch(c, n_head):
    """The first form takes only the bench model's width of these on 132
    SMs; the scratch holds every part the kernels address, the wide
    attention's units sized for every split the grid can make."""
    c4, b = 4 * c, 16
    assert first_form(c, c4, n_head, True, GRID) == (c == 512)
    assert first_form(c, 0, n_head, False, GRID) == (c == 512)
    hd, items = c // n_head, b * n_head
    cp, c4p = fdec.pad64(c), fdec.pad64(c4)
    units = fdec._wide_units(b, n_head, c)
    if hd > 128:
        most = max(items * wide_ranges(items, 321, g)
                   for g in (GRID, fdec.MAX_GRID))
        assert units >= most * (hd + 2)
    else:
        assert units == 0
    parts = max(shares(c, c4, blk)[3][5] for blk in range(GRID))
    assert (fdec._scratch(b, c, c4, n_head, torch.device("cpu")).numel()
            >= b * (c + 2 * cp + c4p + parts * c) + units)


@pytest.mark.parametrize("c,n_head", [(128, 2), (200, 8), (576, 3)])
def test_per_call_weights_in_rows_and_the_stack_packed(c, n_head):
    """The per-call wrappers hand the kernel a block's weights in rows of
    pad64(k) floats: the block's own tensors, no copy, where C and the
    MLP width are multiples of 64, zero-padded copies where not;
    BlockDecodeStack's check packs them (on the CPU, as for the general
    form) with the packed flag set in DecodeArgs."""
    _, tr = entry.build(d_model=c, n_blocks=1, n_heads=n_head, hidden=16,
                        n_res=1, k=32, d=8, seed=0, device="cpu")
    blk = tr.blocks[0]
    weights = [blk.attn.c_attn.weight, blk.attn.c_proj.weight,
               blk.mlp.c_fc.weight, blk.mlp.c_proj.weight]
    caches = torch.zeros(1, 4, c)
    rows = fdec._check_operands("block_decode_f32", blk, caches, caches,
                                (1, 4, c), n_head, True, caches.device)
    got = [rows.tensors[i] for i in (2, 4, 8, 10)]
    assert not rows.packed
    for w, t in zip(weights, got):
        kp = fdec.pad64(w.shape[1])
        assert tuple(t.shape) == (w.shape[0], kp)
        assert (t is w) == (kp == w.shape[1])
        assert torch.equal(t[:, :w.shape[1]], w) and not t[:, w.shape[1]:].any()
    (stack,) = fdec.check_stack([blk], [(caches, caches)], n_head=n_head)
    assert stack.packed
    for w, t in zip(weights, (stack.tensors[i] for i in (2, 4, 8, 10))):
        assert torch.equal(t, fdec._packed(w, w.shape[1]))
    args = fdec._pack(stack, caches, caches, (4 * c, c // n_head, c),
                      caches, 1, 4, c, stack[1], n_head)
    assert args.packed == 1
    assert fdec._pack(rows, caches, caches, (4 * c, c // n_head, c), caches,
                      1, 4, c, rows[1], n_head).packed == 0


# -- the products' order of sums ----------------------------------------------

def _split(x: np.ndarray):
    """csrc/decode.cu::split as the tensor core reads it: hi rounded to
    TF32 by integer arithmetic, lo = x - hi exactly, truncated to TF32."""
    u = x.astype(np.float32).view(np.uint32)
    hi = ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    lo = (x - hi).astype(np.float32)
    lo = (lo.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return hi, lo


# a 16-column block's columns in k8 step 0 and step 1 (thread tg's four
# columns 4 tg .. 4 tg + 3 are its fragment columns tg, tg + 4 of the two)
STEP_COLS = [np.array([0, 1, 4, 5, 8, 9, 12, 13]) + 2 * s for s in (0, 1)]


def emulate_sums(a: np.ndarray, w: np.ndarray, pieces) -> np.ndarray:
    """gproduct's sums of a (R, K) against w (N, K), K the padded depth,
    over the k pieces `pieces` ((start, extent), in order): per warp two
    accumulators (the k8 steps) over the pieces and its blocks w + 8 m in
    order, three TF32 products a step (lo hi, hi lo, hi hi) each added to
    the f32 accumulator; each warp's two added, the warps added in order.
    (R, N) f32."""
    ah, al = _split(a)
    wh, wl = _split(w)
    acc = np.zeros((WARPS, 2, a.shape[0], w.shape[0]), np.float32)
    for s0, kq in pieces:
        for m in range(-(-kq // (16 * WARPS))):
            for warp in range(WARPS):
                blk = warp + WARPS * m
                if 16 * blk >= kq:
                    continue
                for s in (0, 1):
                    cols = s0 + 16 * blk + STEP_COLS[s]
                    for x, y in ((al, wh), (ah, wl), (ah, wh)):
                        acc[warp, s] = (acc[warp, s].astype(np.float64)
                                        + x[:, cols].astype(np.float64)
                                        @ y[:, cols].T.astype(np.float64)
                                        ).astype(np.float32)
    total = np.zeros(acc.shape[2:], np.float32)
    for warp in range(WARPS):
        total = (total + (acc[warp, 0] + acc[warp, 1])).astype(np.float32)
    return total


def _pieces(k: int, q0: int = 0, nq: int | None = None) -> list:
    kp = fdec.pad64(k)
    all_ = [(s, min(fdec.PIECE, kp - s)) for s in range(0, kp, fdec.PIECE)]
    return all_[q0:len(all_) if nq is None else q0 + nq]


def _pad(x: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros((*x.shape[:-1], fdec.pad64(k)), np.float32)
    out[..., :x.shape[-1]] = x
    return out


def _ln(x: np.ndarray, scale, bias) -> np.ndarray:
    """The kernels' LayerNorm of each row (row_stats / tile_stats)."""
    c = x.shape[-1]
    rows = []
    for row in x:
        mean, rstd = _kernel_ln_stats(torch.from_numpy(_pad(row, c)), c)
        rows.append(((torch.from_numpy(row) - mean) * rstd
                     * torch.from_numpy(scale) + torch.from_numpy(bias))
                    .numpy())
    return np.stack(rows).astype(np.float32)


def emulate_mp(g, w, bias, resid, c4):
    """m_proj: split over the grid in mp_ranges ranges of its pieces,
    each range's partial sums (no bias) added in order by the last block,
    then resid + (sum + bias); else resid + (sum + bias)."""
    kp = fdec.pad64(c4)
    nqt = -(-kp // fdec.PIECE)
    ns = mp_ranges(nqt, -(-w.shape[0] // NCOL), GRID)
    total = np.zeros((g.shape[0], w.shape[0]), np.float32)
    for s in range(ns):
        q0 = nqt * s // ns
        part = emulate_sums(_pad(g, c4), _pad(w, c4),
                            _pieces(c4, q0, nqt * (s + 1) // ns - q0))
        total = (total + part).astype(np.float32)
    return (resid + (total + bias)).astype(np.float32)


# -- the wide attention --------------------------------------------------------

def _lane_dot(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """A warp's score: lane L sums q . k over the float4s at 4 L + 128 i
    in order of i (each float4's four products left to right), then the
    butterfly over the lanes."""
    hd = q.shape[0]
    pad = -hd % 128
    qp = torch.nn.functional.pad(q, (0, pad)).view(-1, 32, 4)
    kp = torch.nn.functional.pad(k, (0, pad)).view(-1, 32, 4)
    pr = qp * kp
    f4 = ((pr[..., 0] + pr[..., 1]) + pr[..., 2]) + pr[..., 3]
    lanes = torch.zeros(32)
    for i in range(f4.shape[0]):
        lanes = lanes + f4[i]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ off]
    return lanes[0]


def emulate_wide_attention(q, kc, vc, pos: int, items: int,
                           grid: int = GRID) -> torch.Tensor:
    """csrc/decode.cu::attention_wide for one (sample, head) item of
    `items`: its keys 0..pos in wide_ranges() ranges; in a range, warp w
    takes keys w, w + 8, .. two at a time with its own online softmax
    (passes of 512 columns of o give the same sums, as each column's are
    its own); the warps merged in order, then the ranges. q (hd,),
    kc, vc (T, hd) f32; y (hd,)."""
    hd, n = q.shape[0], pos + 1
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    ranges = wide_ranges(items, n, grid)
    parts = []
    for r in range(ranges):
        k0, k1 = n * r // ranges, n * (r + 1) // ranges
        nk = k1 - k0
        warps = []
        for w in range(WARPS):
            m, l, o = torch.tensor(-math.inf), torch.tensor(0.0), \
                torch.zeros(hd)
            for jj in range(w, nk, 2 * WARPS):
                js = [j for j in (jj, jj + WARPS) if j < nk]
                s = [_lane_dot(q, kc[k0 + j]) * scale for j in js]
                m_new = torch.maximum(m, torch.stack(s).max())
                alpha = torch.exp(m - m_new)
                l, o = l * alpha, o * alpha
                for j, sj in zip(js, s):
                    p = torch.exp(sj - m_new)
                    l = l + p
                    o = o + p * vc[k0 + j]
                m = m_new
            warps.append((m, l, o))
        parts.append(_merge(warps))
    if ranges == 1:
        m, l, o = parts[0]
        return o / l
    m, l, o = _merge(parts)
    return o / l


def _merge(parts):
    """(M, l, o) of partials merged in order: M the largest, each scaled
    by exp(m_i - M)."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    lv, ov = torch.tensor(0.0), torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        wt = torch.exp(m - mx)
        lv = lv + wt * l
        ov = ov + wt * o
    return mx, lv, ov


@pytest.mark.parametrize("hd,items,pos", [
    (192, 16, 255), (192, 16, 256), (300, 4, 320), (300, 96, 160),
    (300, 12, 37), (4096, 16, 200), (4096, 2, 320)])
def test_wide_attention_split_matches_plain(hd, items, pos):
    """Heads past 128 over warps and key ranges (8 ranges at 16 items and
    pos 255, 256: keys 0-31, 32-63, ..; 1 at 96 items), merged in order:
    within 1e-5 of softmax(q K^T / sqrt(hd)) V over rows 0..pos."""
    assert (wide_ranges(items, pos + 1) > 1) == (items < GRID // 2)
    rng = np.random.default_rng(hd + pos)
    t = 321
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((hd,), (t, hd), (t, hd)))
    got = emulate_wide_attention(q, kc, vc, pos, items)
    ref = fdec._attend(q[None, None, None], kc[None, None, :pos + 1],
                       vc[None, None, :pos + 1])[0, 0, 0]
    assert float((got - ref).abs().max()) <= 1e-5


# -- a whole step ---------------------------------------------------------------

def _weights(blk) -> dict:
    return {name: p.detach().numpy() for name, p in blk.named_parameters()}


def emulate_step(x, blk, kc, vc, pos: int, n_head: int, mlp: bool):
    """#13 (mlp, caches (B, T, C)) or #12 (caches (B, H, T, D)) on the
    general form, emulated: x (B, 1, C) f32; (out, kc, vc) with row pos
    written."""
    w = _weights(blk)
    x2 = x[:, 0]
    b, c = x2.shape
    hd = c // n_head
    h = _ln(x2, w["ln_1.weight"], w["ln_1.bias"])
    qkv = (emulate_sums(_pad(h, c), _pad(w["attn.c_attn.weight"], c),
                        _pieces(c)) + w["attn.c_attn.bias"]).astype(
        np.float32)
    q, k, v = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]
    kc, vc = kc.copy(), vc.copy()
    if mlp:
        kc[:, pos], vc[:, pos] = k, v
        kh = kc.reshape(b, -1, n_head, hd).transpose(0, 2, 1, 3)
        vh = vc.reshape(b, -1, n_head, hd).transpose(0, 2, 1, 3)
    else:
        kc[:, :, pos] = k.reshape(b, n_head, hd)
        vc[:, :, pos] = v.reshape(b, n_head, hd)
        kh, vh = kc, vc
    y = np.zeros((b, c), np.float32)
    for i in range(b):
        for j in range(n_head):
            qi = torch.from_numpy(q[i, j * hd:(j + 1) * hd].copy())
            ki = torch.from_numpy(np.ascontiguousarray(kh[i, j]))
            vi = torch.from_numpy(np.ascontiguousarray(vh[i, j]))
            if hd > 128:
                yi = emulate_wide_attention(qi, ki, vi, pos, b * n_head)
            else:                     # Attend, as the first form's
                yi = fdec._attend(qi[None, None, None],
                                  ki[None, None, :pos + 1],
                                  vi[None, None, :pos + 1])[0, 0, 0]
            y[i, j * hd:(j + 1) * hd] = yi.numpy()
    x_mid = (x2 + (emulate_sums(_pad(y, c), _pad(w["attn.c_proj.weight"], c),
                                _pieces(c)) + w["attn.c_proj.bias"])
             ).astype(np.float32)
    if not mlp:
        return x_mid[:, None], kc, vc
    c4 = w["mlp.c_fc.weight"].shape[0]
    h2 = _ln(x_mid, w["ln_2.weight"], w["ln_2.bias"])
    gv = new_gelu(torch.from_numpy(
        (emulate_sums(_pad(h2, c), _pad(w["mlp.c_fc.weight"], c),
                      _pieces(c)) + w["mlp.c_fc.bias"]).astype(np.float32)
    )).numpy()
    out = emulate_mp(gv, w["mlp.c_proj.weight"], w["mlp.c_proj.bias"],
                     x_mid, c4)
    return out[:, None], kc, vc


@pytest.fixture(scope="module", params=[(1800, 6), (200, 8)],
                ids=["1800x6", "200x8"])
def step_case(request):
    """A one-block model at (C, heads) from JAX's init, its inputs, and
    the JAX kernels' outputs in interpret mode (#13 on a 128-row cache,
    which JAX's kernel needs, #12 on a 40-row one), pos 37."""
    c, n_head = request.param
    _, params, port = _jax_model(c, n_head)
    rng = np.random.default_rng(c + 7)
    b, hd, pos = 2, c // n_head, 37
    x = rng.standard_normal((b, 1, c)).astype(np.float32)
    out = {}
    for fn, shape in (("fused_block_decode", (b, 128, c)),
                      ("fused_decode_attn", (b, n_head, 40, hd))):
        kc, vc = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2))
        ref = getattr(pallas_decode, fn)(
            jnp.asarray(x), params["blocks"][0], jnp.asarray(kc),
            jnp.asarray(vc), pos, n_head=n_head)
        out[fn] = (kc, vc, tuple(np.asarray(r) for r in ref))
    return c, n_head, port.blocks[0], x, pos, out


@pytest.mark.parametrize("fn", ["fused_block_decode", "fused_decode_attn"])
def test_emulated_step_matches_plain_and_jax(step_case, fn):
    """The general form's step emulated (pieces, warps, m_proj's ranges,
    the wide attention's warps and key ranges) against the plain version
    and JAX's kernel: the stream within 1e-4, the written cache row
    within 2e-5, every other row as it was (the card's gates)."""
    c, n_head, blk, x, pos, cases = step_case
    kc, vc, (jout, jk, jv) = cases[fn]
    mlp = fn == "fused_block_decode"
    out, ek, ev = emulate_step(x, blk, kc, vc, pos, n_head, mlp)
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ref, _, _ = getattr(fdec, fn + "_reference")(
        torch.from_numpy(x), blk, pk, pv, pos, n_head=n_head)
    at = (slice(None), pos) if mlp else (slice(None), slice(None), pos)
    for want, wk, wv in ((ref.detach().numpy(), pk.numpy(), pv.numpy()),
                         (jout, jk, jv)):
        assert np.abs(out - want).max() <= 1e-4
        assert np.abs(ek[at] - wk[at]).max() <= 2e-5
        assert np.abs(ev[at] - wv[at]).max() <= 2e-5
    rest = np.arange(kc.shape[1 if mlp else 2]) != pos
    keep = (slice(None), rest) if mlp else (slice(None), slice(None), rest)
    assert np.array_equal(ek[keep], kc[keep])
    assert np.array_equal(ev[keep], vc[keep])
