"""The int8 GEMM of kernels #2, #6, #8 and #10 on the CPU.

The GEMM (`csrc/int8_gemm_sm90.cuh`) runs only on the card, where
tests/test_torch_cuda.py holds it bit for bit against its plain stage.
Here, without a card:

- a Python mirror of its persistent tile walk and of its TMA boxes
  (read from the header's constants) visits every output tile once and
  stores every output element once, for M from 1 to 700 and from 25,600
  to 25,760 at each (N, K) that the transformer's blocks give it;
- the plain stage (`ops/int8_gemm.int8_gemm_reference`, what the
  wrapper runs on a CPU tensor) equals the JAX kernels' stage,
  `_idot(a8, w8).astype(float32) * scale + bias` of
  vq_vae_transformer_arc_welding_tpu/ops/pallas_block_quant.py with its
  residual add or its GELU and q8, bit for bit;
- chip_smoke.kernel_work gives the GEMM's four bounds at batch 80;
- the sources hold wgmma and TMA, and no mma.sync GEMM.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models import quantized as jq
from vq_vae_transformer_arc_welding_tpu.ops import pallas_block_quant as jbq
from vq_vae_transformer_arc_welding_tpu_torch import kernels
from vq_vae_transformer_arc_welding_tpu_torch.ops import int8_gemm as ig
from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import new_gelu

REPO = Path(__file__).resolve().parent.parent
HEADER = kernels.SRC_DIR / "int8_gemm_sm90.cuh"

# (N, K) of qkv, c_proj, c_fc and m_proj at C = 512, 128, 192 and 1024
NK = [(n, k) for c in (512, 128, 192, 1024)
      for n, k in ((3 * c, c), (c, c), (4 * c, c), (c, 4 * c))]
WALK_ROWS = [*range(1, 701), *range(25600, 25761)]
SMS = 132                           # an H100 SXM's SMs


def _constants() -> dict:
    """The tile constants of the header, as the kernel compiles them."""
    text = HEADER.read_text()
    out = {}
    for name in ("BM", "BN", "BK", "WG_ROWS", "F32_PANEL"):
        m = re.search(rf"constexpr int {name} = (\w+);", text)
        out[name] = int(m.group(1))
    for name in ("STAGES", "TEAMS"):        # Config<Q8>: int8 out, f32 out
        m = re.search(rf"int {name} = Q8 \? (\d+) : (\d+);", text)
        for q8 in (False, True):
            out[name, q8] = int(m.group(1 if q8 else 2))
    return out


def _walk(m, n, k, sms, q8, cst):
    """The kernel's work, mirrored: block b < grid takes the tiles b,
    b + grid, ... (row block tile / tiles_n, column block tile %
    tiles_n), its teams in turns; per tile the K stages its producer
    loads and the boxes its team's warpgroups store, 64 rows each, none
    where those rows start past M (TMA clips a box at M and N). A store
    covers a warpgroup's rows times the columns of its box, so the
    output is stored once where every tile is visited once, every row
    lies in one warpgroup's rows and every column in one box. Returns
    (visits per (row block, column block), stores per row, stores per
    column, the K stages a tile loads)."""
    bm, bn, bk, wg, panel = (
        cst[x] for x in ("BM", "BN", "BK", "WG_ROWS", "F32_PANEL"))
    teams = cst["TEAMS", q8]
    tn = (n + bn - 1) // bn
    tiles = (m + bm - 1) // bm * tn
    grid = min(tiles, sms)
    visits = np.zeros(((m + bm - 1) // bm, tn), np.int32)
    for b in range(grid):
        for team in range(teams):
            for tile in range(b + team * grid, tiles, teams * grid):
                visits[tile // tn, tile % tn] += 1
    rows = np.zeros(m, np.int32)
    for mb in range(visits.shape[0]):
        for half in range(bm // wg):
            m0 = mb * bm + half * wg
            if m0 < m:
                rows[m0:m0 + wg] += 1
    cols = np.zeros(n, np.int32)
    box = bn if q8 else panel
    for nb in range(tn):
        for c0 in range(nb * bn, nb * bn + bn, box):
            if c0 < n:
                cols[c0:c0 + box] += 1
    return visits, rows, cols, list(range(0, (k + bk - 1) // bk * bk, bk))


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "gelu_q8"])
@pytest.mark.parametrize("n,k", NK)
def test_tile_walk_covers_every_output_once(n, k, q8):
    cst = _constants()
    assert cst["BM"] % 64 == 0 and cst["BN"] % 64 == 0
    for m in WALK_ROWS:
        visits, rows, cols, stages = _walk(m, n, k, SMS, q8, cst)
        assert (visits == 1).all(), (m, n, k)
        assert (rows == 1).all() and (cols == 1).all(), (m, n, k)
        # the stages cover K; TMA zero-fills the columns past K in the last
        assert stages[0] == 0 and stages[-1] < k <= stages[-1] + cst["BK"]


@pytest.mark.parametrize("m,n,sms", [(1, 64, 132), (25680, 1536, 132),
                                     (300, 512, 7)])
def test_tile_walk_grid_is_one_block_per_sm_at_most(m, n, sms):
    """Fewer tiles than SMs: a block a tile; more: each SM walks
    several, and the blocks' shares differ by one tile at most."""
    cst = _constants()
    tiles = -(-m // cst["BM"]) * -(-n // cst["BN"])
    grid = min(tiles, sms)
    shares = [len(range(b, tiles, grid)) for b in range(grid)]
    assert sum(shares) == tiles and max(shares) - min(shares) <= 1
    visits, _, _, _ = _walk(m, n, 128, sms, False, cst)
    assert (visits == 1).all()


def _run_ring(stages, k_blocks, n_tiles, consumers, rng, turns=True):
    """One block's barrier protocol, mirrored from the kernel and run in
    a random interleaving: the producer fills ring slot q % stages with
    stage q after waiting on empty[slot] for parity (q / stages) % 2 ^ 1;
    team c (of `consumers`) takes tiles j = c, c + consumers, ..., waits
    on turn_done[c - 1] (the tile before) for parity ((j - 1) /
    consumers) % 2, then per stage on full[slot] for parity (q / stages)
    % 2, releases each stage after issuing the next, and signals
    turn_done after its last stage (the barriers count the team's
    threads, so a team acts as one here). An mbarrier wait on parity P passes when the
    number of completed phases is odd for P = 0, even for P = 1. Raises
    on a consumer that passes a wait with another stage in its slot, and
    on a deadlock."""
    full = [0] * stages          # completed phases
    empty = [0] * stages
    turn = [0] * consumers
    slot = [None] * stages
    passes = lambda done, parity: done % 2 != parity

    def producer():
        for q in range(n_tiles * k_blocks):
            s = q % stages
            while not passes(empty[s], (q // stages) % 2 ^ 1):
                yield
            assert slot[s] is None, ("producer overwrote", q, slot[s])
            slot[s] = q
            full[s] += 1
            yield

    def consumer(c):
        for j in range(c, n_tiles, consumers):
            if j > 0 and turns:
                o = (c - 1) % consumers
                while not passes(turn[o], ((j - 1) // consumers) % 2):
                    yield
            prev = None
            for kb in range(k_blocks):
                q = j * k_blocks + kb
                s = q % stages
                while not passes(full[s], (q // stages) % 2):
                    yield
                assert slot[s] == q, ("consumer read", q, "found", slot[s])
                if prev is not None:
                    slot[prev] = None
                    empty[prev] += 1
                prev = s
                yield
            turn[c] += 1
            slot[prev] = None
            empty[prev] += 1
            yield

    actors = [producer(), *(consumer(c) for c in range(consumers))]
    stalls = 0
    while actors:
        actor = actors[rng.integers(len(actors))]
        before = (tuple(full), tuple(empty), tuple(turn))
        try:
            next(actor)
        except StopIteration:
            actors.remove(actor)
            stalls = 0
            continue
        stalls = stalls + 1 if before == (tuple(full), tuple(empty),
                                          tuple(turn)) else 0
        assert stalls < 10000, "deadlock"


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "gelu_q8"])
@pytest.mark.parametrize("k_blocks", [1, 2, 3, 4, 16])
def test_ring_protocol_hands_each_stage_to_its_consumer(k_blocks, q8):
    """The ring and the consumers' turns, for 1 to 9 tiles a block in
    random interleavings: every stage reaches its own consumer, none is
    overwritten before it is released, nothing deadlocks."""
    cst = _constants()
    rng = np.random.default_rng(k_blocks)
    for n_tiles in range(1, 10):
        for _ in range(5):
            _run_ring(cst["STAGES", q8], k_blocks, n_tiles,
                      cst["TEAMS", q8], rng)


def test_ring_protocol_needs_the_turns():
    """Without the turns a team that skips the other's stages (8 of them,
    more than the ring holds) can find a slot whose parity reads as done
    before its stage is there: the mirror catches it."""
    cst = _constants()
    rng = np.random.default_rng(0)
    with pytest.raises(AssertionError, match="consumer read"):
        for _ in range(50):
            _run_ring(cst["STAGES", True], 8, 6, cst["TEAMS", True], rng,
                      turns=False)


def _operands(m, n, k, epilogue, seed):
    """As tests/test_torch_cuda.py::_gemm_operands: +-127 inputs whose
    rows lean to one sign, so that sums reach +-K * 127^2, with one entry
    in a hundred anywhere in -127..127."""
    rng = np.random.default_rng(seed)

    def lean(rows):
        x = np.where(rng.random((rows, k)) < rng.random((rows, 1)), 127, -127)
        # one entry in a hundred anywhere in -127..127: sums of +-127^2
        # alone are 16129 times an integer of K's parity, so at K = 2048
        # they are even and below 2^25, where f32 holds them exactly
        odd = rng.random((rows, k)) < 0.01
        x[odd] = rng.integers(-127, 128, int(odd.sum()))
        return x.astype(np.int8)
    a8, w8 = lean(m), lean(n)
    cs = (4.0 / (k * 127 * 127) * rng.uniform(0.5, 1.5, n)).astype(np.float32)
    cb = (rng.standard_normal(n) * 0.1).astype(np.float32)
    resid = (rng.standard_normal((m, n)).astype(np.float32)
             if epilogue == "f32+resid" else None)
    qscale = np.float32(30.0) if epilogue == "gelu_q8" else None
    return a8, w8, cs, cb, resid, qscale


def _jax_stage(a8, w8, cs, cb, resid, qscale):
    """The JAX kernels' stage (pallas_block_quant.py :163, :168, :192,
    :194): _idot with the weight in JAX's (K, N) layout, f32 scale and
    bias, then the residual add or GELU and q8."""
    y = (jbq._idot(jnp.asarray(a8), jnp.asarray(w8.T)).astype(jnp.float32)
         * jnp.asarray(cs) + jnp.asarray(cb))
    if qscale is not None:
        return np.asarray(jbq._q8(jbq._new_gelu(y), qscale))
    return np.asarray(y if resid is None else jnp.asarray(resid) + y)


@pytest.mark.parametrize("epilogue", ["f32", "f32+resid", "gelu_q8"])
@pytest.mark.parametrize("n,k", [(384, 128), (128, 128), (512, 128),
                                 (128, 512), (576, 192), (192, 768),
                                 (1536, 512), (512, 2048)])
@pytest.mark.parametrize("m", [1, 17, 65, 129])
def test_plain_stage_equals_jax_stage(m, n, k, epilogue):
    """The f32 stage bit for bit: both sum exactly in int32, convert to
    f32 with one rounding, then scale, add the bias and the residual in
    the same f32 order. GELU+q8: its input y is that stage, bit for bit;
    the int8 output may differ by one step in 0.1% of entries (the
    repo's int8 bound), because XLA's tanh on the CPU and torch's differ
    by a few ulps and q8 then rounds a value at a .5 boundary the other
    way (1 entry in 198,144 at (129, 1536, 512))."""
    ops = _operands(m, n, k, epilogue, seed=m * 7 + n + k)
    tensors = [None if v is None else torch.as_tensor(v) for v in ops]
    got = ig.int8_gemm(*tensors)
    want = _jax_stage(*ops)
    if epilogue != "gelu_q8":
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        return
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(ig.int8_gemm(*tensors[:4]).numpy(),
                                  _jax_stage(*ops[:4], None, None))
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3


@pytest.mark.parametrize("m,n,k", [(17, 2048, 512), (129, 512, 128),
                                   (65, 768, 192)])
def test_plain_clip_counts_equal_jax_row_clip_frac(m, n, k):
    """`clip_rows`, each row's count of |new_gelu(y)| * qscale > 127.5
    that the GELU+q8 stage adds, as fractions of the row against JAX's
    `_row_clip_frac` of the JAX stage's new_gelu(y), within 1e-6, at a
    qscale that clips a few percent; counts add to what clip_rows held,
    and the int8 output is the stage's without them."""
    a8, w8, cs, cb, _, _ = _operands(m, n, k, "gelu_q8", seed=m + n)
    qscale = np.float32(45.0)
    tensors = [torch.as_tensor(v) for v in (a8, w8, cs, cb)]
    clip = torch.full((m,), 5, dtype=torch.int32)
    out = ig.int8_gemm(*tensors, qscale=torch.as_tensor(qscale),
                       clip_rows=clip)
    assert torch.equal(out, ig.int8_gemm(*tensors,
                                         qscale=torch.as_tensor(qscale)))
    y = (jbq._idot(jnp.asarray(a8), jnp.asarray(w8.T)).astype(jnp.float32)
         * jnp.asarray(cs) + jnp.asarray(cb))
    want = np.asarray(jq._row_clip_frac(jbq._new_gelu(y), qscale))
    assert 0.01 <= want.mean() <= 0.1
    np.testing.assert_allclose(_np_frac(clip - 5, n), want, rtol=0,
                               atol=1e-6)


def test_plain_clip_count_leaves_the_tie_out():
    """p = new_gelu(y) * qscale = 127.5 exactly rounds to 128 and is
    clamped to 127, but is not counted: the criterion is JAX's `> 127.5`,
    not the clamp. y = cb on a zero row of a8: five values of y whose p
    are the two f32 values below 127.5, 127.5 itself and the two above,
    at qscale 31.875 (127.5 / 4, new_gelu of the third is 4.0)."""
    tie = np.float32(4.000070095062256)
    ys = tie + np.arange(-2, 3, dtype=np.float32) * np.float32(2 ** -21)
    cb = np.zeros(64, np.float32)
    cb[:5] = ys
    qscale = torch.tensor(31.875)
    a8 = torch.zeros((2, 64), dtype=torch.int8)
    w8 = torch.as_tensor(_operands(1, 64, 64, "f32", seed=3)[1])
    cs = torch.full((64,), 1e-4)
    g = new_gelu(torch.as_tensor(cb))
    assert float(g[2] * qscale) == 127.5
    assert (g[:2] * qscale < 127.5).all() and (g[3:5] * qscale > 127.5).all()
    clip = torch.zeros(2, dtype=torch.int32)
    out = ig.int8_gemm(a8, w8, cs, torch.as_tensor(cb), qscale=qscale,
                       clip_rows=clip)
    assert out[:, :5].tolist() == [[127] * 5] * 2
    assert clip.tolist() == [2, 2]
    want = np.asarray(jq._row_clip_frac(jnp.asarray(g.numpy()[None]),
                                        np.float32(31.875)))
    np.testing.assert_allclose(_np_frac(clip[:1], 64), want, rtol=0,
                               atol=1e-6)


def _np_frac(counts, width):
    return (counts.float() / width).numpy()


def test_plain_stage_rounds_sums_past_2_24():
    """The operands reach sums past 2^24 at K = 2048, so the s32 -> f32
    conversion rounds, identically on both sides."""
    a8, w8, *_ = _operands(129, 512, 2048, "f32", seed=0)
    acc = a8.astype(np.int64) @ w8.astype(np.int64).T
    assert np.abs(acc).max() > 2 ** 24
    assert (acc.astype(np.float32).astype(np.int64) != acc).any()


def test_wrapper_on_cpu_counts_no_launch():
    kernels.reset_launch_counts()
    a8, w8, cs, cb, _, qs = _operands(5, 128, 64, "gelu_q8", seed=1)
    ig.int8_gemm(*(torch.as_tensor(v) for v in (a8, w8, cs, cb)),
                 qscale=torch.as_tensor(qs))
    assert set(kernels.launches.values()) == {0}
    with pytest.raises(ValueError):
        ig.int8_gemm(torch.as_tensor(a8).to("meta"), torch.as_tensor(w8),
                     torch.as_tensor(cs), torch.as_tensor(cb))


def test_chip_smoke_gemm_bounds_at_batch_80():
    """kernel_work's four GEMM bounds at the bench model's batch 80:
    25,680 rows, C = 512; bytes as each input read once and each output
    written once, int8 operations at 1,979 TOP/s."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    work = chip_smoke.kernel_work(25600, 512, 4, 8, 25, 32, 256, 80, 321, 8,
                                  16, 160)
    m, c = 80 * 321, 512
    want = {  # shape: (bytes, int8 operations, bound ms, bound by)
        "qkv": (m * c + 3 * c * c + 2 * 3 * c * 4 + m * 3 * c * 4,
                2 * m * 3 * c * c, 0.0513, "bytes"),
        "c_proj": (m * c + c * c + 2 * c * 4 + 2 * m * c * 4,
                   2 * m * c * c, 0.0354, "bytes"),
        "c_fc": (m * c + 4 * c * c + 2 * 4 * c * 4 + m * 4 * c,
                 2 * m * 4 * c * c, 0.0272, "operations"),
        "m_proj": (m * 4 * c + 4 * c * c + 2 * c * 4 + 2 * m * c * 4,
                   2 * m * c * 4 * c, 0.0474, "bytes"),
    }
    for shape, (n_bytes, ops, ms, by) in want.items():
        got = work[f"{chip_smoke.GEMM} {shape}"]
        assert got == (n_bytes, {"int8": ops})
        bound, bound_by = chip_smoke.bound_of(got)
        assert round(bound, 4) == ms and bound_by == by, shape


def test_chip_smoke_ln_q8_bound_at_batch_80():
    """kernel_work's bound of one LN+q8 launch of #2 at the bench
    model's batch 80: 25,680 rows of 512 f32 read once and written as
    int8, the LayerNorm's scale and bias read once; 65.7 MB, 0.0196 ms
    at 3.35 TB/s."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    work = chip_smoke.kernel_work(25600, 512, 4, 8, 25, 32, 256, 80, 321, 8,
                                  16, 160)
    m, c = 80 * 321, 512
    assert work[chip_smoke.LN_Q8] == (m * c * 4 + 2 * c * 4 + m * c, {})
    bound, by = chip_smoke.bound_of(work[chip_smoke.LN_Q8])
    assert round(bound, 4) == 0.0196 and by == "bytes"


def test_sources_run_wgmma_and_tma_and_no_mma_sync_gemm():
    header = HEADER.read_text()
    for op in ("wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8",
               "cp.async.bulk.tensor.2d.shared::cluster.global",
               "cp.async.bulk.tensor.2d.global.shared::cta",
               "setmaxnreg"):
        assert op in header, op
    block = (kernels.SRC_DIR / "int8_block.cu").read_text()
    assert '#include "int8_gemm_sm90.cuh"' in block
    assert "gemm90::launch<false>" in block and "gemm90::launch<true>" in block
    for src in kernels.SRC_DIR.glob("*.cu*"):
        text = src.read_text()
        assert "int8_gemm_kernel" not in text, src
        # m16n8k32 is the int8 attention's product alone, never a GEMM's
        assert ("m16n8k32" in text) == (src.name == "attention_int8.cuh"), src
