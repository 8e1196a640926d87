"""The attention tiles' wide forms (heads past 128) in clusters, on the CPU.

#9's f32 tile (csrc/attention_tc.cuh::causal_attention_tile_wide, also
the f32 attention of #2, #6, #10 and #11) and its bf16 tile
(csrc/attention_bf16.cuh::causal_attention_bf16_tile_wide) run a block
per 128 output columns, the blocks of a (head, row tile) in clusters of
2, 4 or 8 (`kernels.wide_cluster`). A cluster forms a stage's scores
once: the score tile is cut into units of 16 rows x 8 keys, each warp
of the cluster forms its share of them over the whole head, writes them
to a slot in its block's shared memory, and every warp reads its rows'
scores from the blocks that formed them. The kernels run only on the
card (tests/test_torch_cuda.py); here their index arithmetic and sums
are mirrored from the headers' constants:

- the shared memory each instantiation asks for, from the headers'
  shapes, within the 227 KB a block has, and the figures the headers
  state;
- the cluster sizes and groups cover every output column of every head
  width from 129 to 4,096 once, and the units cover each stage's score
  tile once, each read back from the block and slot place that wrote it;
- the f32 cluster's scores (each unit the FMA chain over the head dims
  in order, the 128-column chunks in turn) equal a block-a-piece tile's
  chunked chain, `wide_tile_scores`, bit for bit at heads of 192, 275, 300 and
  512; the sum order the kernel did not take (a fresh chain a chunk, the
  chunks added in order) is held beside it: at a head of 300 it parts
  from the plain core by more than half of #9's 2e-5;
- the bf16 forms' output (a fresh accumulator a chunk, the chunks added
  in order: per unit of the split score tile up to 4 pieces, by the
  blocks' sums of every chunk's partials from 5) equals
  `wide_tile_attention`, a block-a-piece tile's emulation, bit for bit at
  heads of 192, 300, 640 and 1,200; the chunked form's segments cover
  the head once at every width.
"""
import math
import re

import numpy as np
import pytest
import torch

from vq_vae_transformer_arc_welding_tpu_torch import kernels
from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
    causal_attention_core)

from test_torch_attention_split import fma_scores, mma_acc, query_blocks
from test_torch_flash_bf16_split import exp_f32, split_terms, trunc32
from test_torch_narrow_widths import wide_tile_attention
from test_torch_transformer_shapes import fma_chain, wide_tile_scores
from test_torch_widths import MAX_ATTN_ERR

BLOCK_SMEM = 232448           # 227 KB: the shared memory a block can have


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers', so these tests use one and give it back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(name: str) -> dict:
    """The `constexpr int NAME = <number>;` constants of a header."""
    text = (kernels.SRC_DIR / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


TC, BF = _ints("attention_tc.cuh"), _ints("attention_bf16.cuh")
PIECE = kernels.WIDE_PIECE


def _stages(name: str) -> list:
    """The ring places each wide form's struct states, in order: (Q
    resident, Q streamed) of the f32 Wide; Wide's and Chunks' of the bf16
    header."""
    text = (kernels.SRC_DIR / name).read_text()
    m = re.search(r"STAGES = QRES \? (\d+) : (\d+);", text)
    if m:
        return [int(m[1]), int(m[2])]
    return [int(x) for x in re.findall(r"int STAGES = (\d+);", text)]


class F32Wide:
    """attention_tc.cuh's Wide<n, qres>, in floats."""

    def __init__(self, n: int, qres: bool):
        self.n, self.qres = n, qres
        self.qrows = TC["WROWS"] * TC["WARPS"]
        self.warps, self.wrows, self.kt = TC["WARPS"], TC["WROWS"], TC["KT"]
        self.nb = self.kt // 8
        self.rs = PIECE + 4
        self.qr = self.qrows // n
        self.units = (self.qrows // self.wrows) * self.nb
        self.per_block = self.units // n
        self.u = self.units // (n * self.warps)
        self.stages = _stages("attention_tc.cuh")[0 if qres else 1]
        q = n * self.qr * self.rs if qres else 0
        ring = (0 if qres else self.qr * self.rs) + self.kt * self.rs
        self.slot = self.per_block * self.wrows * 8
        self.smem = 4 * (q + self.stages * ring + self.kt * self.rs
                         + 2 * self.slot)


class Bf16Wide:
    """attention_bf16.cuh's Wide<n> (n = 2, 4): elements of 2 bytes, f32
    slots."""

    def __init__(self, n: int):
        self.n = n
        self.warps, self.wrows, self.kt = BF["WARPS"], BF["WROWS"], BF["KT"]
        self.qrows = self.wrows * self.warps
        self.rs = PIECE + 8
        self.units = (self.qrows // self.wrows) * (self.kt // 8)
        self.per_block = self.units // n
        self.u = self.per_block // self.warps
        self.qr = self.per_block // 8 * self.wrows
        self.stages = _stages("attention_bf16.cuh")[0]
        self.slot = self.per_block * self.wrows * 8
        self.smem = (2 * (n * self.qr * self.rs + self.stages * self.kt
                          * self.rs + self.kt * self.rs) + 4 * 2 * self.slot)


class Bf16Chunks:
    """attention_bf16.cuh's Chunks (clusters of 8 from 5 pieces): a
    block's segment of chunks, Q of the tile's 64 rows for them, a ring
    of K's chunks, V's piece, a slot of f32 partials a chunk (64 x SRS)
    and the block's rows' sums."""

    def __init__(self):
        self.n = BF["WIDE_MAX_CLUSTER"]
        self.warps, self.wrows, self.kt = BF["WARPS"], BF["WROWS"], BF["KT"]
        self.qrows = self.wrows * self.warps
        self.rs, self.srs = PIECE + 8, self.kt + 8
        self.rows = self.qrows // self.n
        self.maxl = BF["MAX_WIDE_HD"] // PIECE // self.n
        self.stages = _stages("attention_bf16.cuh")[1]

    def seg(self, hd: int) -> int:
        return -(-pieces(hd) // self.n)

    def smem(self, seg: int) -> int:
        return (2 * (seg * self.qrows * self.rs + self.stages * self.kt
                     * self.rs + self.kt * self.rs)
                + 4 * (seg * self.qrows * self.srs + self.rows * self.srs))


# the instantiations the launches dispatch to (flash_attn.cu, int8_block.cu)
F32_FORMS = [(2, True), (4, True), (8, True), (8, False)]
BF16_FORMS = [2, 4]


def pieces(hd: int) -> int:
    return -(-hd // PIECE)


def test_the_headers_shared_memory_fits():
    """Every instantiation's shared memory, from the headers' shapes,
    within the 227 KB a block can have, and the headers' own figures."""
    tc = (kernels.SRC_DIR / "attention_tc.cuh").read_text()
    bf = (kernels.SRC_DIR / "attention_bf16.cuh").read_text()
    for n, qres in F32_FORMS:
        assert F32Wide(n, qres).smem <= BLOCK_SMEM, (n, qres)
    for n in BF16_FORMS:
        assert Bf16Wide(n).smem <= BLOCK_SMEM, n
    ch = Bf16Chunks()
    assert ch.smem(ch.maxl) <= BLOCK_SMEM
    assert "= 201,728 bytes" in tc and F32Wide(2, True).smem == 201728
    assert "= 210,944" in tc and F32Wide(8, False).smem == 210944
    assert "= 103,424 bytes" in bf and Bf16Wide(2).smem == 103424
    assert "215,296 bytes" in bf and ch.smem(4) == 215296
    assert "up to 8 pieces 107,776" in bf and ch.smem(1) == 107776
    # two bf16 blocks an SM up to 8 pieces (228 KB an SM, 1 KB of it a
    # block's own)
    assert all(2 * (s + 1024) <= 233472
               for s in [Bf16Wide(n).smem for n in BF16_FORMS] + [ch.smem(1)])
    assert TC["WIDE_MAX_CLUSTER"] == BF["WIDE_MAX_CLUSTER"] \
        == kernels.WIDE_MAX_CLUSTER == 8
    for text in (tc, bf):
        assert ("pieces(hd) <= 2 ? 2 : pieces(hd) <= 4 ? 4 : "
                "WIDE_MAX_CLUSTER") in text
        assert "static_assert(" in text and "232448" in text


def test_clusters_cover_every_column_once():
    """For every head width from 129 to 4,096: the cluster size the
    headers give, its groups, the pieces each block stores (every output
    column of the head once, no block past the head's pieces storing),
    Q resident up to 8 pieces, and the score work a cluster group's: at
    most ceil(pieces / 8) formings of the head's scores."""
    for hd in range(129, kernels.MAX_WIDTH + 1):
        p = pieces(hd)
        n = kernels.wide_cluster(hd)
        assert n == (2 if p <= 2 else 4 if p <= 4 else 8)
        groups = -(-p // n)
        assert groups == (1 if p <= 8 else -(-p // 8))
        owner = {}
        for x in range(groups * n):            # blockIdx.x of one head
            piece = x % (groups * n)
            if piece < p:
                for col in range(PIECE * piece,
                                 min(hd, PIECE * (piece + 1))):
                    assert col not in owner
                    owner[col] = x
        assert sorted(owner) == list(range(hd))
        assert (p <= 8) == (groups == 1)       # Q resident: one group


@pytest.mark.parametrize("n", [2, 4, 8])
def test_units_cover_the_score_tile_once(n):
    """The units of a stage's score tile (16 rows x 8 keys): each formed
    by one warp of one block, and read back from that block at the slot
    place it was written to, in the f32 tile and in the bf16 tile."""
    forms = [(F32Wide(n, True), TC["WARPS"])]
    if n in BF16_FORMS:
        forms.append((Bf16Wide(n), BF["WARPS"]))
    for lay, rowblocks in forms:
        written = {}
        for rank in range(n):
            first = rank * lay.per_block
            for warp in range(lay.warps):
                unit0 = first + warp * lay.u
                for j in range(lay.u):
                    urb, key_block = divmod(unit0 + j, 8)
                    assert (urb, key_block) not in written
                    written[urb, key_block] = (rank, warp * lay.u + j)
        assert len(written) == lay.units == rowblocks * 8
        for warp in range(rowblocks):          # the reading warp's row block
            for j in range(8):
                unit = 8 * warp + j
                owner = unit // lay.per_block
                assert written[warp, j] == (owner,
                                            unit - owner * lay.per_block)


def segments(np_: int, n: int = 8) -> list:
    """The bf16 chunked form's chunks of each block: [r np / n, (r + 1)
    np / n)."""
    return [range(r * np_ // n, (r + 1) * np_ // n) for r in range(n)]


def test_bf16_chunks_cover_the_head_once():
    """The bf16 chunked form (5 pieces and more): the blocks' segments
    cover the head's chunks once, in the head's order block by block, each
    at most seg(hd) long (the shared memory it was given); the blocks'
    rows of sums cover the 64 rows once, and each warp's rows g and g + 8
    lie in blocks 2 warp and 2 warp + 1 at local row g."""
    ch = Bf16Chunks()
    for hd in range(4 * PIECE + 1, kernels.MAX_WIDTH + 1):
        segs = segments(pieces(hd))
        assert [c for seg in segs for c in seg] == list(range(pieces(hd)))
        assert max(len(seg) for seg in segs) == ch.seg(hd) <= ch.maxl
    rows = [ch.rows * r + i for r in range(ch.n) for i in range(ch.rows)]
    assert rows == list(range(ch.qrows))
    for warp in range(ch.warps):
        for g in range(8):
            for half, row in enumerate((16 * warp + g, 16 * warp + g + 8)):
                assert divmod(row, ch.rows) == (2 * warp + half, g)


# -- the f32 tile: the cluster's scores ---------------------------------------

def _heads(h, t, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((1, h, t, hd)) * 2.0)
                             .astype(np.float32)) for _ in range(3)]


def f32_cluster_scores(qt, kt, hd, n, q_end, k0):
    """One stage's (128, 64) scores as the f32 cluster forms and reads
    them: each block's rows (q_first from the tile's first row) over the
    whole head, the chunks in turn zero-filled past the head, each unit
    of a warp written to its block's slot where the unit lies below its
    rows' last one, each warp's rows read back from the block that owns
    its row block. qt (128, hd) the tile's q (zero rows outside T), kt
    (64, hd) the stage's keys (zero past T). NaN where no warp reads."""
    lay = F32Wide(n, pieces(hd) <= 8)
    wrows, nb = lay.wrows, lay.nb
    slots = []
    for rank in range(n):
        rows = slice(lay.qr * rank, lay.qr * (rank + 1))
        s = torch.zeros(lay.qr, lay.kt)
        for c in range(pieces(hd)):
            pad = (0, PIECE - min(PIECE, hd - PIECE * c))
            cols = slice(PIECE * c, PIECE * (c + 1))
            s = fma_chain(torch.nn.functional.pad(qt[rows, cols], pad),
                          torch.nn.functional.pad(kt[:, cols], pad), s)
        slot = torch.full((lay.per_block, wrows, 8), math.nan)
        for warp in range(lay.warps):
            unit0 = (rank * lay.warps + warp) * lay.u
            urb, uj = divmod(unit0, nb)
            u_end = q_end - lay.qrows + wrows * (urb + 1)
            nu = min(max((u_end - k0 + 7) // 8, 0), nb) - uj
            for j in range(min(lay.u, nu)):
                r0 = wrows * urb - lay.qr * rank
                slot[warp * lay.u + j] = s[r0:r0 + wrows,
                                           8 * (uj + j):8 * (uj + j + 1)]
        slots.append(slot)
    tile = torch.full((lay.qrows, lay.kt), math.nan)
    for warp in range(lay.warps):
        w_end = q_end - lay.qrows + wrows * (warp + 1)
        nbw = min(max((w_end - k0 + 7) // 8, 0), nb)
        owner = warp * n // lay.warps
        for j in range(nbw):
            tile[wrows * warp:wrows * (warp + 1), 8 * j:8 * j + 8] = \
                slots[owner][nb * warp - owner * lay.per_block + j]
    return tile


@pytest.mark.parametrize("hd,t", [(192, 70), (275, 45), (300, 70),
                                  (512, 40)])
def test_f32_cluster_scores_are_the_unchunked_chain(hd, t):
    """Every score a warp reads equals a block-a-piece tile's chunked chain
    (`wide_tile_scores`, itself the unchunked chain) bit for bit, and
    every score a warp needs is read."""
    q, k, _ = _heads(1, t, hd, seed=hd)
    q, k = q[0, 0], k[0, 0]
    n = kernels.wide_cluster(hd)
    for rows in query_blocks(t):
        r = torch.tensor(list(rows))
        qt = q[r.clamp(min=0)] * (r >= 0)[:, None]
        for k0 in range(0, rows.stop, 64):
            kt = torch.zeros(64, hd)
            kt[:min(64, t - k0)] = k[k0:k0 + 64]
            tile = f32_cluster_scores(qt, kt, hd, n, rows.stop, k0)
            ref = wide_tile_scores(qt, kt)
            needed = ~torch.isnan(tile)
            lim = r.clamp(min=0)[:, None]
            causal = (k0 + torch.arange(64))[None, :] <= lim
            assert bool(needed[causal & (r >= 0)[:, None]].all())
            assert torch.equal(tile[needed], ref[needed])


def chunk_sum_attention(q, k, v):
    """The wide tile's output had each 128-column chunk its own FMA chain
    from 0, the chunks' sums added in order with rounded adds (the order
    the kernel did not take); P V in split TF32 as the tile's."""
    b, h, t, hd = q.shape
    width = PIECE * pieces(hd)
    q, k, v = (torch.nn.functional.pad(z, (0, width - hd)) for z in (q, k, v))
    out = torch.zeros(b, h, t, width)
    sm_scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    for rows in query_blocks(t):
        r = torch.tensor(list(rows))
        valid, lim = r >= 0, r.clamp(min=0)
        qb = q[:, :, lim] * valid[:, None]
        m = torch.full((b, h, len(r), 1), -math.inf)
        l = torch.zeros(b, h, len(r), 1)
        o = torch.zeros(b, h, len(r), width)
        for k0 in range(0, rows.stop, 64):
            kt = torch.zeros(b, h, 64, width)
            vt = torch.zeros(b, h, 64, width)
            n = min(64, t - k0)
            kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
            s = sum(fma_scores(qb[..., c:c + PIECE], kt[..., c:c + PIECE])
                    for c in range(0, width, PIECE)) * sm_scale
            causal = (k0 + torch.arange(64))[None, :] <= lim[:, None]
            s = s.masked_fill(~causal, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = mma_acc(o * alpha, p, vt, 3)
            m = m_new
        out[:, :, r[valid]] = (o / l)[:, :, valid]
    return out[..., :hd]


def test_chunk_sums_miss_the_margin_at_300():
    """Why the f32 cluster keeps the unchunked chain: chunk sums added in
    order part from the plain core by more than half of #9's 2e-5 at a
    head of 300 (T = 70, two heads), though within it."""
    q, k, v = _heads(2, 70, 300, seed=300)
    err = float((chunk_sum_attention(q, k, v)
                 - causal_attention_core(q, k, v)).abs().max())
    assert MAX_ATTN_ERR / 2 < err <= MAX_ATTN_ERR


# -- the bf16 tile: the cluster's output --------------------------------------

def chunk_partial(qt, kt, d, c):
    """Chunk c's partial scores of rows qt and keys kt: a fresh
    accumulator through the chunk's k16 steps (each step's sum truncated
    to f32), as the bf16 tiles form them."""
    acc = torch.zeros(qt.shape[0], kt.shape[0])
    cw = min(PIECE, d - PIECE * c)
    for kk in range(PIECE // 16):
        if 16 * kk < cw:
            e = PIECE * c + 16 * kk
            acc = trunc32(acc.double() + qt[:, e:e + 16].double()
                          @ kt[:, e:e + 16].double().T)
    return acc


def bf16_cluster_scores(qt, kt, d, n, q_end, k0):
    """One stage's (64, 64) f32 scores as the bf16 cluster forms and
    reads them. Up to 4 pieces (n = 2, 4): each block's units, per chunk
    of the head in order a chunk_partial added to the unit's scores,
    written where the unit lies below its rows' last one; each warp's
    rows read from the blocks that wrote them. From 5 (n = 8): each block
    writes its segment's partials (where its warp's rows need the
    stage), sums its 8 rows over every block's partials in the head's
    order from 0, and each warp reads its rows' sums from blocks 2 warp
    and 2 warp + 1. qt (64, hd16), kt (64, hd16): bf16 values in f32,
    zero-padded to a multiple of 16 columns (and zero outside T); d the
    real head width. Unread scores are 0."""
    wrows, kt_n = BF["WROWS"], BF["KT"]
    qrows = wrows * BF["WARPS"]
    nc_of = [min(max(-(-(q_end - qrows + wrows * (w + 1) - k0) // 16), 0),
                 4) for w in range(BF["WARPS"])]
    tile = torch.zeros(qrows, kt_n)
    if n == 8:
        ch = Bf16Chunks()
        parts = []
        for seg in segments(pieces(d)):
            slot = torch.full((len(seg), qrows, kt_n), math.nan)
            for i, c in enumerate(seg):
                p = chunk_partial(qt, kt, d, c)
                for w in range(ch.warps):
                    if nc_of[w]:
                        rows = slice(wrows * w, wrows * (w + 1))
                        slot[i, rows] = p[rows]
            parts.append(slot)
        sums = []
        for r in range(ch.n):
            acc = torch.zeros(ch.rows, kt_n)
            for slot in parts:
                for i in range(slot.shape[0]):
                    acc = acc + slot[i, ch.rows * r:ch.rows * (r + 1)]
            sums.append(acc)
        for w in range(ch.warps):
            for j in range(2 * nc_of[w]):
                for half in range(2):
                    got = sums[2 * w + half][:, 8 * j:8 * j + 8]
                    assert not bool(torch.isnan(got).any())
                    r0 = wrows * w + 8 * half
                    tile[r0:r0 + 8, 8 * j:8 * j + 8] = got
        return tile
    lay = Bf16Wide(n)
    slots = []
    for rank in range(n):
        first = rank * lay.per_block
        rb0 = first // 8
        rows = slice(wrows * rb0, wrows * rb0 + lay.qr)
        s = torch.zeros(lay.qr, kt_n)
        for c in range(pieces(d)):
            s = s + chunk_partial(qt[rows], kt, d, c)
        slot = torch.full((lay.per_block, wrows, 8), math.nan)
        for warp in range(lay.warps):
            unit0 = first + warp * lay.u
            urb, uj = divmod(unit0, 8)
            nu = 2 * nc_of[urb] - uj
            for j in range(min(lay.u, nu)):
                r0 = wrows * (urb - rb0)
                slot[warp * lay.u + j] = s[r0:r0 + wrows,
                                           8 * (uj + j):8 * (uj + j + 1)]
        slots.append(slot)
    for warp in range(lay.warps):
        for j in range(2 * nc_of[warp]):
            unit = 8 * warp + j
            owner = unit // lay.per_block
            got = slots[owner][unit - owner * lay.per_block]
            assert not bool(torch.isnan(got).any())
            tile[wrows * warp:wrows * (warp + 1), 8 * j:8 * j + 8] = got
    return tile


def bf16_cluster_attention(q, k, v):
    """#9 on bf16 q, k, v as the wide bf16 tile in clusters computes it:
    bf16_cluster_scores, then the narrow tile's online softmax and P V on
    three bf16 terms of P (wide_tile_attention's steps). q, k, v (B, H,
    T, D): bf16 values in f32; returns bf16."""
    b, h, t, d = q.shape
    hd = -(-d // 16) * 16
    q, k, v = (torch.nn.functional.pad(z, (0, hd - d)) for z in (q, k, v))
    sm_scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    n = kernels.wide_cluster(d)
    out = torch.zeros(b, h, t, hd)
    for z in range(math.ceil(t / 64)):
        rows = torch.arange(t - 64 * (z + 1), t - 64 * z)
        valid = rows >= 0
        lim = rows.clamp(min=0)
        qb = q[:, :, lim] * valid[:, None]
        m = torch.full((b, h, 64, 1), -math.inf)
        l = torch.zeros(b, h, 64, 1)
        o = torch.zeros(b, h, 64, hd)
        for k0 in range(0, int(rows[-1]) + 1, 64):
            kt = torch.zeros(b, h, 64, hd)
            vt = torch.zeros(b, h, 64, hd)
            nk = min(64, t - k0)
            kt[:, :, :nk], vt[:, :, :nk] = (k[:, :, k0:k0 + nk],
                                            v[:, :, k0:k0 + nk])
            q_end = int(rows[-1]) + 1
            s = torch.stack([torch.stack([
                bf16_cluster_scores(qb[i, j], kt[i, j], d, n, q_end, k0)
                for j in range(h)]) for i in range(b)])
            s = s * sm_scale
            causal = (k0 + torch.arange(64))[None, :] <= lim[:, None]
            s = s.masked_fill(~causal, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = exp_f32(m - m_new)
            p = exp_f32(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha
            parts = split_terms(p, 3)
            for c0 in range(0, 64, 16):
                acc = torch.zeros_like(o)
                for x in parts[::-1]:
                    acc = trunc32(acc.double() + x[..., c0:c0 + 16].double()
                                  @ vt[:, :, c0:c0 + 16].double())
                o = o + acc
            m = m_new
        out[:, :, rows[valid]] = (o / l)[:, :, valid]
    return out[..., :d].to(torch.bfloat16)


@pytest.mark.parametrize("d", [192, 300, 640, 1200])
def test_bf16_cluster_tile_keeps_the_chunk_order(d):
    """The bf16 cluster's output equals a block-a-piece tile's emulation
    (`wide_tile_attention`) bit for bit at heads of 192, 300 (clusters of
    2 and 4, the score tile split), 640 and 1,200 (the chunked form, one
    cluster of 8 with empty segments, two with segments of two chunks;
    T = 70, two heads): its scores' sums are that tile's, element by
    element."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 70, d))
                                .astype(np.float32)).to(torch.bfloat16)
               .float() for _ in range(3))
    assert torch.equal(bf16_cluster_attention(q, k, v),
                       wide_tile_attention(q, k, v))


def test_chip_smoke_checks_the_clusters_in_the_ptx():
    """chip_smoke.py holds both sources of the f32 wide tile, and #9's
    bf16 forms, to cluster barriers and distributed shared memory in
    their PTX, and reports ptxas on every wide kernel."""
    import sys
    sys.path.insert(0, str(kernels.SRC_DIR.parent.parent))
    import chip_smoke
    for src in ("flash_attn.cu", "int8_block.cu"):
        assert {"barrier.cluster.arrive", "mapa"} <= set(
            chip_smoke.PTX_OPS[src])
    assert {"attention_wide_kernel", "flash_attention_bf16_wide_kernel",
            "flash_attention_bf16_chunks_kernel"} <= set(
                chip_smoke.PTXAS_KERNELS)
