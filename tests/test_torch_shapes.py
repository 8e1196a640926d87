"""Every VQ-VAE the VQ-VAE CLI can build, on the CPU: the encoder kernels
at any hidden width up to 4,096 and the nearest-code searches at any
codebook with D up to 256, against the JAX package.

The CLI's flags (`--hidden-dim`, `--num-embeddings`, `--embedding-dim`)
reach shapes the card's first kernels refused: hidden widths off the
multiples of 64 and above 512, and codebooks past a block's shared
memory. What runs there now:

- hidden 1 to 512: the f32 tile (csrc/encoder_tc.cuh) on its width of
  128, 256 or 512, every column past the hidden width zero (emulated
  here from the padded split, as tests/test_torch_widths.py does at 64);
- hidden 513 to 4,096, and 1b off 512: csrc/encoder_wide.cu, one launch
  a product: 64 x 128 output tiles, K in chunks of 32, each 8-wide k
  step's three split-TF32 terms added as three mma.sync products
  (emulated here block by block, chunk by chunk, each product rounded
  to f32 once);
- any (K, D): the codebook streamed through shared memory in chunks,
  each lane scanning its codes in increasing order with d < best, the
  lanes reduced to the smaller d and, on equal d, the smaller index
  (csrc/code_scan.cuh for #5, csrc/nearest_codes.cu for #7; emulated
  here chunk by chunk, lane by lane).

The plain versions (`*_reference`), which the CPU runs and chip_smoke.py
holds the kernels to, are held against the JAX kernels in interpret
mode at the new shapes.

Tolerances: the residual stream within 1e-4 of the JAX kernel's largest
magnitude (the f32 tile's bound: tests/test_torch_encoder_split.py);
ids equal but at near-ties, each flip within 1e-5 of |z|^2 in float64
(chip_smoke.py's bound); the emulated scans give exactly the ids of an
argmin with the first index on the same distances.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.ops import pallas_encoder as jenc
from vq_vae_transformer_arc_welding_tpu.ops.pallas_vq import (
    nearest_codes_pallas as jax_nearest)
from vq_vae_transformer_arc_welding_tpu_torch import entry, kernels
from vq_vae_transformer_arc_welding_tpu_torch.ops import (
    fused_encoder as fenc, fused_vq as fvq)
from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import gelu
from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import (
    batch_norm_apply)
from vq_vae_transformer_arc_welding_tpu_torch.ops.vq import nearest_codes

from test_torch_encoder_split import split, tile_product
from test_torch_widths import tile_chain_padded

MAX_REL = 1e-4
MAX_FLIP_GAP = 1e-5
ROWS = 128                  # two 64-row tiles of the kernels
# the (K, D) grid of chip_smoke.py's shapes phase: the CLI's
# --num-embeddings 1024 at D 64, codebooks past the old shared-memory
# limits, D off the padded widths, the one-code book
CODEBOOKS = [(1024, 64), (4096, 32), (512, 128), (256, 48), (300, 256),
             (1, 8), (895, 64)]
# csrc/encoder_wide.cu's plan
WIDE_ROWS, WIDE_COLS, WIDE_K = 64, 128, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers', so these tests use one and give it back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(c, n_blocks, use_bn, rows=ROWS, seed=0):
    """x (rows, c), weights (2n, c, c) at the encoder's init spread,
    vecs (10n, c) with eval BN rows where use_bn, as numpy."""
    rng = np.random.default_rng(seed)
    bound = (6.0 / (2 * c * 3)) ** 0.5
    w = rng.uniform(-bound, bound, (2 * n_blocks, c, c)).astype(np.float32)
    v = np.zeros((n_blocks, 2, 5, c), np.float32)
    v[:, :, 0] = rng.standard_normal((n_blocks, 2, c)) * 0.1
    if use_bn:
        v[:, :, 1] = rng.standard_normal((n_blocks, 2, c)) * 0.2
        v[:, :, 2] = rng.uniform(0.5, 2.0, (n_blocks, 2, c))
        v[:, :, 3] = rng.uniform(0.5, 1.5, (n_blocks, 2, c))
        v[:, :, 4] = rng.standard_normal((n_blocks, 2, c)) * 0.1
    x = rng.standard_normal((rows, c)).astype(np.float32)
    return x, w, v.reshape(10 * n_blocks, c)


# -- csrc/encoder_wide.cu's product, emulated -------------------------------

def wide_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (N, C) @ w (C, C) (in, out) as encoder_wide.cu sums it: per
    64 x 128 output tile, K in chunks of 32 zero-filled past C, each
    8-wide k step as three mma.sync products A_lo W_hi, A_hi W_lo,
    A_hi W_hi, each summed in float64 and added to the f32 accumulator
    with one rounding."""
    n, c = a.shape
    kp = -(-c // WIDE_K) * WIDE_K
    a = torch.nn.functional.pad(a, (0, kp - c))
    w = torch.nn.functional.pad(w, (0, 0, 0, kp - c))
    a_hi, a_lo = split(a)
    w_hi, w_lo = split(w)
    out = torch.empty(n, c)
    for r0 in range(0, n, WIDE_ROWS):
        rs = slice(r0, r0 + WIDE_ROWS)
        for c0 in range(0, c, WIDE_COLS):
            cs = slice(c0, c0 + WIDE_COLS)
            acc = torch.zeros(a[rs].shape[0], w[:, cs].shape[1])
            for k0 in range(0, kp, WIDE_K):
                for k8 in range(k0, k0 + WIDE_K, 8):
                    ks = slice(k8, k8 + 8)
                    for x, y in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)):
                        acc = (acc.double() + x[rs, ks].double()
                               @ y[ks, cs].double()).float()
            out[rs, cs] = acc
    return out


def wide_chain(x, weights, vecs, use_bn: bool) -> torch.Tensor:
    """The emulated encoder_wide_f32: per resblock h = gelu(gelu(x) @ W1
    + b1 [-> BN]) into the scratch, then x + (h @ W2 + b2 [-> BN])."""
    for i in range(weights.shape[0] // 2):
        v = vecs[10 * i:10 * (i + 1)]
        h = wide_product(gelu(x), weights[2 * i]) + v[0]
        if use_bn:
            h = batch_norm_apply(h, v[3], v[4], v[1], v[2])
        h = wide_product(gelu(h), weights[2 * i + 1]) + v[5]
        if use_bn:
            h = batch_norm_apply(h, v[8], v[9], v[6], v[7])
        x = x + h
    return x


# -- the chunked codebook scan, emulated ------------------------------------

def fma_dot(z: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """z (N, D) . cb (K, D) as one fmaf per d in index order from zero
    (a float64 product and sum, rounded to f32 once a step)."""
    acc = torch.zeros(z.shape[0], cb.shape[0])
    for i in range(z.shape[1]):
        acc = (z[:, i:i + 1].double() * cb[:, i].double()
               + acc.double()).float()
    return acc


def squares(v: torch.Tensor) -> torch.Tensor:
    s = torch.zeros(v.shape[0])
    for i in range(v.shape[1]):
        s = s + v[:, i] * v[:, i]
    return s


def chunked_scan(dist: torch.Tensor, chunk: int, lanes: int) -> torch.Tensor:
    """The kernels' search on an (N, K) distance table: chunks of
    `chunk` codes in increasing order; lane l takes codes l, l + lanes,
    ... of each chunk with d < best (best starts at +inf, index K); then
    the lanes' bests reduced to the smaller d and, on equal d, the
    smaller index; no finite d: code 0."""
    n, k = dist.shape
    best = torch.full((lanes, n), float("inf"))
    best_k = torch.full((lanes, n), k, dtype=torch.long)
    for c0 in range(0, k, chunk):
        for lane in range(lanes):
            for j in range(c0 + lane, min(c0 + chunk, k), lanes):
                better = dist[:, j] < best[lane]
                best[lane] = torch.where(better, dist[:, j], best[lane])
                best_k[lane] = torch.where(better, j, best_k[lane])
    d, i = best[0], best_k[0]
    for lane in range(1, lanes):
        take = (best[lane] < d) | ((best[lane] == d) & (best_k[lane] < i))
        d = torch.where(take, best[lane], d)
        i = torch.where(take, best_k[lane], i)
    return torch.where(i < k, i, 0).int()


def padded_d(d: int) -> int:
    """csrc/code_scan.cuh::padded and nearest_codes.cu's DP."""
    return next(p for p in (8, 16, 32, 64, 128, 256) if d <= p)


def exit_chunk(d: int) -> int:
    """Codes a chunk of #5's scan (csrc/code_scan.cuh::chunk_codes):
    the floats after z (64 x DP) of the 64 x 512 A tile, over rows of
    DP + 4 and a norm."""
    dp = padded_d(d)
    return (64 * 512 - 64 * dp) // (dp + 5)


def nearest_chunk(d: int, threads: int = 256) -> int:
    """Codes a chunk of #7's streamed codebook
    (csrc/nearest_codes.cu::chunk_for): two chunks of rows of DP + 4 and
    their norms in 227 KB, beside z's rows at DP = 256."""
    dp = padded_d(d)
    zs = threads // 4 * (dp + 4) if dp > 128 else 0
    return (227 * 1024 // 4 - zs - 4) // (2 * (dp + 5))


def test_chunk_sizes_keep_the_bench_codebook_whole():
    """At the bench model's (256, 32) one chunk holds the codebook in
    both searches, so it is read as before; the CLI's (1024, 64) takes
    three chunks of each; the widest codes still get dozens of codes a
    chunk."""
    assert exit_chunk(32) == 830 >= 256
    assert nearest_chunk(32) >= 256
    assert -(-1024 // exit_chunk(64)) == 3
    assert -(-1024 // nearest_chunk(64)) == 3
    assert exit_chunk(256) == 62 and nearest_chunk(256) == 79
    src = (kernels.SRC_DIR / "code_scan.cuh").read_text()
    assert "(floats - ROWS * dp) / (code_pitch(dp) + 1)" in src


@pytest.mark.parametrize("lanes,formula", [(32, "exit"), (4, "nearest")])
@pytest.mark.parametrize("k,d", [(1024, 64), (300, 256), (895, 64)])
def test_chunked_scan_keeps_the_first_index_across_chunks(k, d, lanes,
                                                          formula):
    """Row 5's z planted at the last code of the first chunk, the first
    of the second and one in the third; rows 0-3's at two codes of one
    chunk that different lanes scan: the emulated chunked scan returns
    the first of the equal codes, as the one-block argmin does, and
    equals the plain version on every row."""
    chunk = exit_chunk(d) if formula == "exit" else nearest_chunk(d)
    chunk = min(chunk, k // 3)         # at least three chunks here
    g = torch.Generator().manual_seed(k + d)
    z = torch.randn(64, d, generator=g)
    cb = torch.randn(k, d, generator=g)
    planted = [chunk - 1, chunk, 2 * chunk + 3]
    for i in planted:
        cb[i] = z[5]
    for r in range(4):
        cb[chunk + 7 + r] = cb[chunk + 7 + r + lanes + 1] = z[r]
    cross = fma_dot(z, cb)
    if formula == "exit":
        dist = (squares(z)[:, None] + squares(cb)[None]) + -2.0 * cross
        plain = nearest_codes(z, cb)
    else:
        dist = squares(cb)[None] + -2.0 * cross
        plain = fvq.nearest_codes_pallas_reference(z, cb)
    ids = chunked_scan(dist, chunk, lanes)
    assert int(ids[5]) == planted[0]
    assert [int(i) for i in ids[:4]] == [chunk + 7 + r for r in range(4)]
    assert torch.equal(ids, chunked_scan(dist, k, lanes))   # one chunk
    assert torch.equal(ids, plain)


def test_chunked_scan_gives_code_0_without_a_finite_distance():
    z = torch.randn(8, 16)
    z[3] = float("-inf")
    cb = torch.rand(100, 16) + 0.1
    dist = squares(cb)[None] + -2.0 * fma_dot(z, cb)
    dist = torch.where(torch.isnan(dist), torch.inf, dist)
    ids = chunked_scan(dist, 30, 4)
    assert int(ids[3]) == 0
    assert torch.equal(ids[:3], fvq.nearest_codes_pallas_reference(z, cb)[:3])


# -- the plain versions against the JAX kernels at the new shapes -----------

@pytest.mark.parametrize("k,d", CODEBOOKS)
def test_nearest_codes_plain_matches_jax_at_any_codebook(k, d):
    """#7's plain version against JAX's nearest_codes_pallas (interpret
    mode) at the shapes grid: equal ids but at near-ties."""
    rng = np.random.default_rng(k + d)
    z = rng.standard_normal((256, d)).astype(np.float32)
    cb = (rng.standard_normal((k, d)) * 0.9).astype(np.float32)
    ref = np.asarray(jax_nearest(jnp.asarray(z), jnp.asarray(cb)))
    got = fvq.nearest_codes_pallas_reference(torch.from_numpy(z),
                                             torch.from_numpy(cb)).numpy()
    _ids_equal_but_near_ties(got, ref, z, cb)


def _ids_equal_but_near_ties(got, ref, z, cb):
    rows = np.nonzero(got != ref)[0]
    assert len(rows) <= max(1, len(got) // 1000)
    for r in rows:
        zz = z[r].astype(np.float64)
        d = [((zz - cb[i].astype(np.float64)) ** 2).sum()
             for i in (got[r], ref[r])]
        assert abs(d[0] - d[1]) <= MAX_FLIP_GAP * (zz ** 2).sum()


@pytest.mark.parametrize("c,k,d", [(100, 1024, 64), (100, 300, 256),
                                   (576, 4096, 32), (1024, 895, 64),
                                   (64, 1, 8), (64, 256, 48), (64, 512, 128)])
def test_exit_plain_matches_jax_at_any_codebook(c, k, d):
    """#5's plain version against JAX's fused_encoder_exit_eval
    (interpret mode), one resblock, at hidden widths off the tile and
    the codebooks of the grid: equal ids but at near-ties."""
    x, w, v = _operands(c, 1, False, rows=64, seed=c + k)
    rng = np.random.default_rng(d)
    w_sep = rng.uniform(-0.1, 0.1, (c, d)).astype(np.float32)
    b_sep = (rng.standard_normal(d) * 0.1).astype(np.float32)
    z = fenc.fused_encoder_eval_reference(
        *map(torch.from_numpy, (x, w, v)), use_bn=False).numpy() @ w_sep
    cb = (z.mean(0) + rng.standard_normal((k, d)) * z.std(0)).astype(
        np.float32)
    ref = np.asarray(jenc.fused_encoder_exit_eval(
        jnp.asarray(x), w, v, w_sep, b_sep, cb, tile_rows=64, use_bn=False))
    got = fenc.fused_encoder_exit_eval_reference(
        *map(torch.from_numpy, (x, w, v, w_sep, b_sep, cb)),
        use_bn=False).numpy()
    _ids_equal_but_near_ties(got, ref, z + b_sep, cb)


@pytest.mark.parametrize("c,n_blocks,use_bn", [
    (100, 2, True), (576, 1, False), (576, 2, True), (1024, 1, True)])
def test_encoder_chain_matches_jax_at_any_width(c, n_blocks, use_bn):
    """fused_encoder_eval at hidden 100 (the 128 tile, zero-padded),
    576 and 1,024 (encoder_wide.cu): JAX's kernel in interpret mode, the
    port's plain version and the kernel's emulation within 1e-4 of the
    output's magnitude."""
    x, w, v = _operands(c, n_blocks, use_bn, rows=64, seed=c)
    ref = torch.from_numpy(np.array(jenc.fused_encoder_eval(
        jnp.asarray(x), w, v, tile_rows=64, use_bn=use_bn)))
    tx, tw, tv = map(torch.from_numpy, (x, w, v))
    plain = fenc.fused_encoder_eval_reference(tx, tw, tv, use_bn=use_bn)
    emu = (tile_chain_padded(tx, tw, tv, use_bn) if fenc.on_tile(c)
           else wide_chain(tx, tw, tv, use_bn))
    scale = float(ref.abs().max())
    assert float((plain - ref).abs().max()) <= MAX_REL * scale
    assert float((emu - ref).abs().max()) <= MAX_REL * scale


@pytest.mark.parametrize("c,use_bn", [(100, False), (576, True),
                                      (1024, False)])
def test_resblock_matches_jax_at_any_width(c, use_bn):
    """fused_resblock_eval's plain version (the JAX signature) against
    JAX's (interpret mode) within 1e-4 of the output's magnitude."""
    x, w, v = _operands(c, 1, use_bn, rows=64, seed=c + 1)
    vt = [jnp.asarray(r) for r in v]
    ref = np.asarray(jenc.fused_resblock_eval(
        jnp.asarray(x), w[0], vt[0], tuple(vt[1:5]), w[1], vt[5],
        tuple(vt[6:10]), tile_rows=64, use_bn=use_bn))
    tv = list(torch.from_numpy(v))
    got = fenc.fused_resblock_eval(
        torch.from_numpy(x), torch.from_numpy(w[0]), tv[0], tv[1:5],
        torch.from_numpy(w[1]), tv[5], tv[6:10], use_bn=use_bn).numpy()
    assert np.abs(got - ref).max() <= MAX_REL * np.abs(ref).max()


# -- the emulated plans -------------------------------------------------------

@pytest.mark.parametrize("c", [100, 576])
def test_wide_product_blocks_and_chunks_match_the_unsplit_walk(c):
    """encoder_wide.cu's 64 x 128 tiles and chunks of 32 of K (zeros past
    C) against the tile's unsplit walk over the same 8-wide k steps
    (tile_product, the three terms rounded once a step): the split only
    adds roundings of 2^-24, and both stay within 1e-6 of the float64
    product's magnitude."""
    x, w, _ = _operands(c, 1, False, rows=96, seed=c + 2)
    a, tw = gelu(torch.from_numpy(x)), torch.from_numpy(w[0])
    wide = wide_product(a, tw)
    whole = tile_product(a, *split(tw.T.contiguous()))
    exact = a.double() @ tw.double()
    scale = float(exact.abs().max())
    assert float((wide - whole).abs().max()) <= 1e-6 * scale
    assert float((wide.double() - exact).abs().max()) <= 1e-6 * scale
    # TF32 without the split is far off: the three terms are needed
    one = tile_product(a, *split(tw.T.contiguous()), terms=1)
    assert float((one.double() - exact).abs().max()) > 10 * float(
        (wide.double() - exact).abs().max())


@pytest.mark.parametrize("c,use_bn", [(3, False), (100, True), (258, False)])
def test_padded_tile_at_widths_off_the_multiples_of_64(c, use_bn):
    """Hidden 3, 100 and 258 on the tiles of 128 and 512: the zero-padded
    emulation (every column past the width stays 0) within 1e-4 of the
    unpadded plain version's magnitude, and the pack's split padded to
    the tile with the true hi and lo in its corner."""
    x, w, v = _operands(c, 2, use_bn, seed=c + 3)
    tx, tw, tv = map(torch.from_numpy, (x, w, v))
    emu = tile_chain_padded(tx, tw, tv, use_bn)
    plain = fenc.fused_encoder_eval_reference(tx, tw, tv, use_bn=use_bn)
    assert float((emu - plain).abs().max()) <= MAX_REL * float(
        plain.abs().max())
    width = fenc.kernel_width(c)
    assert fenc.split_weights(tw).shape == (4, 2 * width * width)


# -- dispatch and limits --------------------------------------------------------

def test_which_kernel_takes_each_width():
    """The tile of 128, 256 or 512 up to hidden 512, encoder_wide.cu
    above; 1b's tile at 512 only, encoder_wide_bf16 elsewhere."""
    for c, width in ((1, 128), (3, 128), (100, 128), (128, 128),
                     (129, 256), (256, 256), (257, 512), (500, 512),
                     (512, 512)):
        assert fenc.kernel_width(c) == width and fenc.on_tile(c)
        assert fenc.chain_kernel(c) == "encoder_chain_f32"
    for c in (513, 576, 640, 758, 768, 1024, 4096):
        assert fenc.kernel_width(c) == c and not fenc.on_tile(c)
        assert fenc.chain_kernel(c) == "encoder_wide_f32"
    for c in (1, 64, 256, 576, 1024, 4096):
        assert fenc.chain_kernel(c, torch.bfloat16) == "encoder_wide_bf16"
    assert fenc.chain_kernel(512, torch.bfloat16) == "encoder_chain_bf16"
    for name in ("encoder_wide_f32", "encoder_wide_bf16",
                 "encoder_wide_entry_f32", "encoder_wide_exit_f32"):
        assert name in kernels.launches
    with pytest.raises(ValueError, match="the f32 tile takes 1 to 512"):
        fenc.split_weights(torch.zeros(2, 576, 576))


def test_limits_are_named_in_the_errors():
    """Past hidden 4,096 and D 256 the wrappers' checks raise and name
    the limits (they run before any launch, on any device)."""
    for c in (1, 100, 4096):
        fenc._require_width("resblock_f32", c)
    with pytest.raises(ValueError, match="1 to 4096"):
        fenc._require_width("resblock_f32", 4097)
    w, v = torch.zeros(2, 4097, 1), torch.zeros(10, 4097)
    with pytest.raises(ValueError, match="hidden 1 to 4096"):
        fenc._require_chain("encoder_chain_f32", 4097, w, v, w.device)
    for k, d in ((1, 1), (5000, 256), (1024, 64)):
        fvq.require_codebook("nearest_codes_f32", k, d)
    for k, d in ((256, 257), (0, 32), (8, 0)):
        with pytest.raises(ValueError, match="D from 1 to 256"):
            fvq.require_codebook("nearest_codes_f32", k, d)


def test_packs_off_the_tiles_carry_no_split():
    """pack_encoder splits the weights only where the f32 tile reads the
    split (up to 512) and stages bf16 ones only at 1b's 512; a
    hidden-576 model's encoder paths on the CPU run the plain versions
    and count no launch."""
    vq, _ = entry.build(hidden=576, n_res=2, k=64, d=16, d_model=64,
                        n_heads=1, n_blocks=1, seed=0, device="cpu")
    packed = fenc.pack_encoder(vq)
    assert packed.split is None and packed[0].shape == (4, 576, 576)
    assert fenc.pack_encoder(vq, torch.bfloat16).split is None
    small, _ = entry.build(hidden=100, n_res=1, k=16, d=8, d_model=64,
                           n_heads=1, n_blocks=1, seed=0, device="cpu")
    assert fenc.pack_encoder(small).split.shape == (2, 2 * 128 * 128)
    cycles = torch.randn(2, 200, 2, generator=torch.Generator()
                         .manual_seed(0))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        exact = vq.encode_indices(cycles)
        ids = fenc.encode_indices_fused(vq, packed, cycles)
        edges = fenc.encode_indices_fused_edges(
            vq, packed, fenc.pack_encoder_edges(vq), cycles, group_size=1)
    assert not any(kernels.launches.values())
    assert torch.equal(ids, exact) and torch.equal(edges, exact)
