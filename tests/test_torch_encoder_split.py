"""The f32 encoder tile's arithmetic (csrc/encoder_tc.cuh) against the JAX
package, on the CPU.

Kernels #1 (`encoder_chain_f32`), #3 (`resblock_f32`) and the encoder's
two ends, #4 (`encoder_entry_f32`) and #5 (`encoder_exit_f32`), run the
resblock's two 512 x 512 products on the tensor cores in split TF32:
every f32 operand v is rounded to hi = tf32(v) (`cvt.rna`: round to
nearest on the magnitude, ties away from zero) and lo = tf32(v - hi);
W's hi and lo are made once with the pack (`ops/fused_encoder.py::
split_weights`), A's as the kernel loads its fragments, and each 8-wide
k step adds A_lo W_hi + A_hi W_lo + A_hi W_hi to the f32 accumulators.
The CUDA kernel runs only on the card, so its arithmetic is emulated
here in plain PyTorch, k step by k step, from the pack the kernel reads.
Each step's three products are summed in float64 and rounded once (the
tensor core's own rounding inside a step is finer than these tolerances
see); bias, eval BN, exact-erf GELU and the residual add are the plain
version's. The ends of #4 and #5 (csrc/encoder_edges.cu) are FP32 FMAs
in index order on the CUDA cores: the patch-embed, sep_conv and the
cross terms of the distances as one fmaf per step from zero (emulated
as a float64 product and sum rounded to f32 once), the squared norms
as rounded products added in index order, d = (|z|^2 + |e|^2) + (-2
z.e), and the first index among the minima.

Tolerances, at the full width of 512 (the error grows with it): the
residual stream within 1e-4 of the JAX kernel's largest magnitude (the
bound tests/test_torch_cuda.py holds the kernels to; the Pallas kernel's
A&S erf differs from the exact erf by 1.5e-7), and the codebook ids
through sep_conv may flip in at most 1e-3 of entries, each flip a
near-tie within 1e-5 of |z|^2 in float64 (chip_smoke.py's bounds).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.ops import pallas_encoder as jenc
from vq_vae_transformer_arc_welding_tpu_torch import entry
from vq_vae_transformer_arc_welding_tpu_torch.ops import fused_encoder as fenc
from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import gelu
from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import (
    batch_norm_apply)
from vq_vae_transformer_arc_welding_tpu_torch.ops.vq import nearest_codes
from vq_vae_transformer_arc_welding_tpu_torch.serve import (
    WeldingQualityPipeline)

import torch_port_helpers as H

C = 512          # the kernels' width
KSTEP = 8        # K of a TF32 wgmma: the tile's k step
ROWS = 640       # two windows of the bench model
EDGE_ROWS = 200  # the ends: three whole 64-row tiles and a part one
PATCH = 25       # the bench model's patch
MAX_REL = 1e-4
MAX_ID_FLIP = 1e-3
MAX_FLIP_GAP = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with
    ties away from zero (on the magnitude bits, so for either sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def unpack(pack: torch.Tensor) -> torch.Tensor:
    """The kernels' operand (2n, 2 C C), per matrix [k // 8][hi, lo]
    [out // 8][k % 8 // 4][out % 8][k % 4] -> (2n, 2, out, in)."""
    m = pack.shape[0]
    return pack.reshape(m, C // KSTEP, 2, C // 8, 2, 8, 4).permute(
        0, 2, 3, 5, 1, 4, 6).reshape(m, 2, C, C)


def tile_product(a: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor,
                 terms: int = 3) -> torch.Tensor:
    """a (N, C) @ W, W given as its hi and lo in (out, in) layout, summed
    as the tile sums: per 8-wide k step in order, A_lo W_hi + A_hi W_lo +
    A_hi W_hi in float64, rounded to f32 once and added to the f32
    accumulator. terms=1: A_hi W_hi alone, TF32 without the split."""
    a_hi, a_lo = split(a)
    pairs = ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi))[3 - terms:]
    acc = torch.zeros(a.shape[0], w_hi.shape[0])
    for k0 in range(0, a.shape[1], KSTEP):
        ks = slice(k0, k0 + KSTEP)
        step = sum(x[:, ks].double() @ w[:, ks].double().T for x, w in pairs)
        acc = acc + step.float()
    return acc


def tile_chain(x: torch.Tensor, weights: torch.Tensor, vecs: torch.Tensor,
               use_bn: bool, terms: int = 3) -> torch.Tensor:
    """The emulated kernel: n resblocks on (N, C) rows from the pack of
    `weights` ((2n, C, C), (in, out)) that the kernel reads."""
    parts = unpack(fenc.split_weights(weights))
    for i in range(weights.shape[0] // 2):
        v = vecs[10 * i:10 * (i + 1)]
        c = tile_product(gelu(x), *parts[2 * i], terms) + v[0]
        if use_bn:
            c = batch_norm_apply(c, v[3], v[4], v[1], v[2])
        c = tile_product(gelu(c), *parts[2 * i + 1], terms) + v[5]
        if use_bn:
            c = batch_norm_apply(c, v[8], v[9], v[6], v[7])
        x = x + c
    return x


def operands(n_blocks: int, use_bn: bool, seed: int = 0, rows: int = ROWS):
    """x (rows, C), weights (2n, C, C) at the encoder's init spread and
    vecs (10n, C), with eval BN rows drawn where use_bn, as numpy."""
    rng = np.random.default_rng(seed)
    bound = (6.0 / (2 * C * 3)) ** 0.5
    w = rng.uniform(-bound, bound, (2 * n_blocks, C, C)).astype(np.float32)
    v = np.zeros((n_blocks, 2, 5, C), np.float32)
    v[:, :, 0] = rng.standard_normal((n_blocks, 2, C)) * 0.1
    if use_bn:
        v[:, :, 1] = rng.standard_normal((n_blocks, 2, C)) * 0.2
        v[:, :, 2] = rng.uniform(0.5, 2.0, (n_blocks, 2, C))
        v[:, :, 3] = rng.uniform(0.5, 1.5, (n_blocks, 2, C))
        v[:, :, 4] = rng.standard_normal((n_blocks, 2, C)) * 0.1
    x = rng.standard_normal((rows, C)).astype(np.float32)
    return x, w, v.reshape(10 * n_blocks, C)


def fma_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, K) @ b (K, M) as the ends sum it: from zero, one fmaf per k
    in index order (a float64 product and sum, exact for the product,
    rounded to f32 once)."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(a.shape[1]):
        acc = (a[:, k:k + 1].double() * b[k].double() + acc.double()).float()
    return acc


def squares_in_order(v: torch.Tensor) -> torch.Tensor:
    """Per row of v, the squares rounded to f32 and added in index order
    (__fmul_rn, __fadd_rn)."""
    s = torch.zeros(v.shape[0])
    for i in range(v.shape[1]):
        s = s + v[:, i] * v[:, i]
    return s


def tile_entry(patches, w_pe, b_pe, weights, vecs, use_bn: bool):
    """The emulated #4: the patch-embed in index order, then the tile's
    resblocks."""
    return tile_chain(fma_rows(patches, w_pe) + b_pe, weights, vecs, use_bn)


def tile_exit(x, weights, vecs, w_sep, b_sep, codebook, use_bn: bool):
    """The emulated #5: the tile's resblocks, z in index order, the
    distances in the kernel's order and the first index among their
    minima (no finite distance: code 0). Returns (ids, z)."""
    z = fma_rows(tile_chain(x, weights, vecs, use_bn), w_sep) + b_sep
    d = ((squares_in_order(z)[:, None] + squares_in_order(codebook)[None])
         + -2.0 * fma_rows(z, codebook.T))
    d = torch.where(torch.isnan(d), torch.inf, d)
    return d.argmin(1).int(), z


def edge_operands(seed: int = 7, d: int = 32):
    """patches (EDGE_ROWS, PATCH), w_pe (PATCH, C), b_pe, w_sep (C, d),
    b_sep at xavier-like spreads, as numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((EDGE_ROWS, PATCH)).astype(f),
            rng.uniform(-0.1, 0.1, (PATCH, C)).astype(f),
            (rng.standard_normal(C) * 0.1).astype(f),
            rng.uniform(-0.1, 0.1, (C, d)).astype(f),
            (rng.standard_normal(d) * 0.1).astype(f))


def ids_and_gap(y, ref, seed: int = 1):
    """Codebook ids of y and of ref through a sep_conv (C -> 32) and a
    (256, 32) codebook drawn at the spread of ref's z: (flip share, the
    largest float64 distance gap of a flipped id, of |z|^2)."""
    rng = np.random.default_rng(seed)
    w_sep = torch.from_numpy(
        rng.uniform(-0.1, 0.1, (C, 32)).astype(np.float32))
    z_ref = ref @ w_sep
    cb = (z_ref.mean(0) + torch.from_numpy(
        rng.standard_normal((256, 32)).astype(np.float32)) * z_ref.std(0))
    ids, ids_ref = nearest_codes(y @ w_sep, cb), nearest_codes(z_ref, cb)
    rows = (ids != ids_ref).nonzero().squeeze(1)
    gap = 0.0
    if rows.numel():
        z = z_ref[rows].double()
        d = [((z - cb[i[rows].long()].double()) ** 2).sum(1)
             for i in (ids, ids_ref)]
        gap = float(((d[0] - d[1]).abs() / (z ** 2).sum(1)).max())
    return float((ids != ids_ref).float().mean()), gap


def test_tf32_rounds_as_cvt_rna():
    """The pack's rounding: 13 low bits dropped, to nearest, ties away
    from zero for either sign; the module's tf32 is this one."""
    bits = torch.tensor([0x3F800000, 0x3F801000, 0x3F800FFF, 0x3F803000,
                         0x3F7FF000], dtype=torch.int32)
    for sign in (0, -0x80000000):
        x = (bits | sign).view(torch.float32)
        got = tf32(x).view(torch.int32) & 0x7FFFFFFF
        assert got.tolist() == [0x3F800000, 0x3F802000, 0x3F800000,
                                0x3F804000, 0x3F800000]
        assert torch.equal(fenc.tf32(x), tf32(x))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        10000).astype(np.float32))
    assert torch.equal(fenc.tf32(x), tf32(x))


def test_split_weights_layout_and_exactness():
    """Per matrix hi = tf32(w) in (out, in) layout with 13 low mantissa
    bits zero, lo = tf32(w - hi) likewise, hi + lo = w within 2^-21 of
    |w|; the pack's order is the ring's: the first 32 KB of a matrix
    are k 0 .. 7, hi then lo, in core matrices of 8 outputs x 4 k."""
    _, w, _ = operands(2, False)
    tw = torch.from_numpy(w)
    pack = fenc.split_weights(tw)
    assert pack.shape == (4, 2 * C * C) and pack.dtype == torch.float32
    parts = unpack(pack)
    wt = tw.transpose(1, 2)
    hi, lo = parts[:, 0], parts[:, 1]
    assert torch.equal(hi, tf32(wt)) and torch.equal(lo, tf32(wt - hi))
    for p in (hi, lo):
        assert not (p.contiguous().view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - wt).abs() <= 2.0 ** -21 * wt.abs()).all()
    assert (hi - wt).abs().max() > 1e-5      # the split is really there
    # output 9, k 5 of matrix 1: k step 0, core matrix (9 // 8, 5 // 4)
    at = 1 * 64 + 1 * 32 + (9 % 8) * 4 + 5 % 4
    assert pack[1, at] == hi[1, 9, 5] and pack[1, 4096 + at] == lo[1, 9, 5]


@pytest.mark.parametrize("use_bn", [False, True])
def test_emulated_chain_matches_jax(use_bn):
    """#1 at a group of four resblocks: the emulated tile against JAX
    fused_encoder_eval in interpret mode within 1e-4 of its magnitude,
    and the ids it leads to, where TF32 alone misses the bound; the CPU
    wrapper, handed the split or not, runs the plain version."""
    x, w, v = operands(4, use_bn)
    ref = torch.from_numpy(np.array(jenc.fused_encoder_eval(
        jnp.asarray(x), w, v, tile_rows=64, use_bn=use_bn)))
    tx, tw, tv = map(torch.from_numpy, (x, w, v))
    emu = tile_chain(tx, tw, tv, use_bn)
    scale = float(ref.abs().max())
    assert float((emu - ref).abs().max()) <= MAX_REL * scale
    plain = fenc.fused_encoder_eval_reference(tx, tw, tv, use_bn=use_bn)
    assert float((emu - plain).abs().max()) <= MAX_REL * scale
    assert (emu - plain).abs().max() > 0     # not the plain f32 sums
    flip, gap = ids_and_gap(emu, ref)
    assert flip <= MAX_ID_FLIP and gap <= MAX_FLIP_GAP
    # TF32 alone (~1.2e-4 here) would miss the bound: hence the split
    alone = tile_chain(tx, tw, tv, use_bn, terms=1)
    assert float((alone - ref).abs().max()) > MAX_REL * scale
    cpu = fenc.fused_encoder_eval(tx, tw, tv, use_bn=use_bn,
                                  split=fenc.split_weights(tw))
    assert torch.equal(cpu, plain)


@pytest.mark.parametrize("use_bn", [False, True])
def test_emulated_resblock_matches_jax(use_bn):
    """#3: one resblock, the emulated tile against JAX
    fused_resblock_eval in interpret mode, as #1."""
    x, w, v = operands(1, use_bn, seed=3)
    ref = torch.from_numpy(np.array(jenc.fused_resblock_eval(
        jnp.asarray(x), w[0], v[0], tuple(v[1:5]), w[1], v[5],
        tuple(v[6:10]), tile_rows=64, use_bn=use_bn)))
    tx, tw, tv = map(torch.from_numpy, (x, w, v))
    emu = tile_chain(tx, tw, tv, use_bn)
    assert float((emu - ref).abs().max()) <= MAX_REL * float(ref.abs().max())
    flip, gap = ids_and_gap(emu, ref)
    assert flip <= MAX_ID_FLIP and gap <= MAX_FLIP_GAP
    cpu = fenc.resblock_eval(tx, tw[0], tw[1], tv, use_bn=use_bn,
                             split=fenc.split_weights(tw))
    assert torch.equal(cpu, fenc.fused_resblock_eval_reference(
        tx, tw[0], tw[1], tv, use_bn=use_bn))


def test_split_pack_is_made_once_per_pipeline(monkeypatch):
    """split_weights runs where the encoder is packed: once when a
    WeldingQualityPipeline is built and once per make_pipeline_quantized,
    never per classify call; every chain call gets a view of that pack's
    split, so the kernel wrappers split nothing per call."""
    made, handed = [], []
    real_split, real_eval = fenc.split_weights, fenc.fused_encoder_eval
    monkeypatch.setattr(fenc, "split_weights", lambda w: (
        made.append(tuple(w.shape)), real_split(w))[1])
    monkeypatch.setattr(fenc, "fused_encoder_eval", lambda *a, **k: (
        handed.append(k.get("split")), real_eval(*a, **k))[1])
    vq = H.port_vqvae(False)
    pipe = WeldingQualityPipeline(vq, H.port_transformer(),
                                  n_cycles=H.N_CYCLES, max_batch=4,
                                  precision="int8", encoder_impl="fused")
    assert made == [(2 * vq.n_resblocks, vq.hidden_dim, vq.hidden_dim)]
    pipe.calibrate(H.windows(6, seed=4))
    fn = entry.make_pipeline_quantized(vq, pipe.tr_model, pipe.qparams)
    assert len(made) == 2
    handed.clear()
    labels, _ = pipe.classify(H.windows(5, seed=12))
    assert labels.shape == (5,) and handed
    own = pipe._encoder_pack.split.untyped_storage().data_ptr()
    assert all(s is not None and s.untyped_storage().data_ptr() == own
               for s in handed)
    handed.clear()
    assert fn(torch.from_numpy(H.windows(2, seed=12))).shape == (2, 2)
    assert handed and all(s is not None for s in handed)
    assert len(made) == 2


@pytest.mark.parametrize("use_bn", [False, True])
def test_emulated_entry_matches_jax(use_bn):
    """#4 at a group of four resblocks on 200 rows: the emulated kernel
    against JAX fused_encoder_entry_eval in interpret mode within 1e-4
    of its largest magnitude; the CPU wrapper, handed the split or not,
    runs the plain version."""
    _, w, v = operands(4, use_bn, seed=5, rows=1)
    patches, w_pe, b_pe, _, _ = edge_operands()
    ref = torch.from_numpy(np.array(jenc.fused_encoder_entry_eval(
        jnp.asarray(patches), w_pe, b_pe, w, v, tile_rows=64,
        use_bn=use_bn)))
    tp, twp, tbp, tw, tv = map(torch.from_numpy, (patches, w_pe, b_pe, w, v))
    emu = tile_entry(tp, twp, tbp, tw, tv, use_bn)
    assert emu.shape == (EDGE_ROWS, C)
    assert float((emu - ref).abs().max()) <= MAX_REL * float(ref.abs().max())
    plain = fenc.fused_encoder_entry_eval_reference(tp, twp, tbp, tw, tv,
                                                    use_bn=use_bn)
    for split in (None, fenc.split_weights(tw)):
        assert torch.equal(fenc.fused_encoder_entry_eval(
            tp, twp, tbp, tw, tv, use_bn=use_bn, split=split), plain)


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tie"])
@pytest.mark.parametrize("use_bn", [False, True])
def test_emulated_exit_matches_jax(use_bn, tie):
    """#5 at a group of four resblocks on 200 rows and the bench model's
    (256, 32) codebook drawn at the spread of z: the emulated kernel's
    ids against JAX fused_encoder_exit_eval in interpret mode, flipping
    in at most 1e-3 of rows, each flip a near-tie within 1e-5 of |z|^2
    in float64; with codes 2 and 11 both row 5's own z, the answer is 2
    and never 11. The CPU wrapper, handed the split or not, runs the
    plain version."""
    x, w, v = operands(4, use_bn, seed=6, rows=EDGE_ROWS)
    _, _, _, w_sep, b_sep = edge_operands(seed=8)
    tx, tw, tv, tws, tbs = map(torch.from_numpy, (x, w, v, w_sep, b_sep))
    z = fenc.fused_encoder_eval_reference(tx, tw, tv, use_bn=use_bn) @ tws \
        + tbs
    rng = np.random.default_rng(9)
    cb = (z.mean(0) + torch.from_numpy(rng.standard_normal(
        (256, 32)).astype(np.float32)) * z.std(0))
    if tie:
        cb[2] = cb[11] = z[5]
    ref = torch.from_numpy(np.array(jenc.fused_encoder_exit_eval(
        jnp.asarray(x), w, v, w_sep, b_sep, cb.numpy(), tile_rows=64,
        use_bn=use_bn)))
    ids, z_emu = tile_exit(tx, tw, tv, tws, tbs, cb, use_bn)
    assert ids.shape == ref.shape == (EDGE_ROWS,)
    assert ids.unique().numel() > 256 // 4
    rows = (ids != ref).nonzero().squeeze(1)
    assert rows.numel() <= MAX_ID_FLIP * EDGE_ROWS
    if rows.numel():
        zz = z_emu[rows].double()
        gap = [((zz - cb[i[rows].long()].double()) ** 2).sum(1)
               for i in (ids, ref)]
        assert float(((gap[0] - gap[1]).abs() / (zz ** 2).sum(1)).max()) \
            <= MAX_FLIP_GAP
    if tie:
        assert ids[5] == 2 and not (ids == 11).any()
    plain = fenc.fused_encoder_exit_eval_reference(tx, tw, tv, tws, tbs, cb,
                                                   use_bn=use_bn)
    for split in (None, fenc.split_weights(tw)):
        assert torch.equal(fenc.fused_encoder_exit_eval(
            tx, tw, tv, tws, tbs, cb, use_bn=use_bn, split=split), plain)
