"""The bf16 encoder chain's operand layouts and k walk (kernel 1b,
csrc/encoder_chain_bf16.cu) against the plain version and the JAX
package, on the CPU.

The kernel multiplies with `wgmma` m64n128k16 bf16 -> f32, both operands read
from shared memory through descriptors of the K-major layout with the 128-byte
swizzle (rows of 64 of K, 16-byte chunk c of row r at c ^ (r % 8)). W is staged
once with the pack (`ops/fused_encoder.py::stage_weights_bf16`) in the order of
the kernel's TMA ring, which swizzles it on the way in; A, bf16(gelu(.)), is
written by the epilogues at `a_off`. The CUDA kernel runs only on the card, so
here the layouts are read back through the descriptors' parameters as the source
states them (parsed from it), and the chain is emulated stage by stage from the
staged pack: per pass of 128 outputs, k step of 16 by k step in the order the
kernel multiplies them (`k_step`), the bf16 products summed in float64 and
rounded to f32 once, added to the f32 accumulator (the tensor core's own order
inside a step is finer than the tolerance); bias, eval BN, exact-erf GELU and
the residual add are the plain version's.

Tolerances: one product walked from the pack equals the plain bf16
product to 1e-6 of its magnitude (the same bf16 products summed in f32,
in other orders). Through a chain the last-bit differences of those
sums reach the next product's bf16 rounding of a GELU output, and a
moved input changes a sum by ~2^-9 of a term: the chain is held within
1e-3 of the plain chain's magnitude (the card's per-resblock bound,
tests/test_torch_cuda.py) and within 5e-6 on average; against JAX's
kernel in interpret mode every element within 5e-4 and the mean within
5e-6 (the Pallas GELU's A&S erf moves about one bf16 input in 10^4
across a rounding boundary, as tests/test_torch_kernels.py sets out).
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.ops import pallas_encoder as jenc
from vq_vae_transformer_arc_welding_tpu_torch import kernels
from vq_vae_transformer_arc_welding_tpu_torch.ops import fused_encoder as fenc
from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import gelu
from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import (
    batch_norm_apply)

import torch_port_helpers as H

C = 512
SOURCE = (kernels.SRC_DIR / "encoder_chain_bf16.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


KSTEP = _const("KSTEP")
KSTEPS = C // KSTEP
HALF, QUARTER = C // 2, C // 4


def k_stage(j: int) -> int:
    """csrc/encoder_chain_bf16.cu::k_stage: the 64-wide stage of K a pass
    multiplies j-th, the quarters of K in the order the epilogues write
    them."""
    q = j // 2
    return ((q & 1) * 2 + (q >> 1)) * 2 + j % 2


def k_step(j: int) -> int:
    """The k step of 16 a pass multiplies j-th: the stages in k_stage's
    order, each k step by k step."""
    return 4 * k_stage(j // 4) + j % 4


# the descriptors as the product builds them: A's k step i of stage kb at
# a_s + kb * A_ATOM + i * 32, W's at the ring slot + i * 32, each a
# K-major operand with the 128-byte swizzle
_A_DESC = re.search(r"sw128_desc\(a_s \+ kb \* \(BM \* (\d+)\) \+ i \* "
                    r"(\d+)\)", SOURCE)
_W_DESC = re.search(r"sw128_desc\(ring\.base \+ s \* W_STAGE \+ i \* "
                    r"(\d+)\)", SOURCE)
A_ROW, A_STEP = (int(g) for g in _A_DESC.groups())
W_STEP = int(_W_DESC.group(1))


def sw128_offsets(rows: int, k: int, k_byte0: int):
    """Element offsets (2-byte elements) at which a K-major descriptor
    with the 128-byte swizzle, k_byte0 bytes into its 128-byte rows,
    reads a (rows, k) operand: row r, byte b = k_byte0 + 2 j of it at
    128 r + 16 ((b / 16) ^ (r % 8)) + b % 16."""
    r = torch.arange(rows)[:, None]
    b = k_byte0 + 2 * torch.arange(k)[None]
    return (128 * r + 16 * ((b // 16) ^ (r % 8)) + b % 16) // 2


def a_off(row, k):
    """csrc/encoder_chain_bf16.cu::a_off, where the epilogues write A."""
    return ((k >> 6) * (64 * 64) + row * 64 +
            ((((k >> 3) & 7) ^ (row & 7)) << 3) + (k & 7))


def stage_block(staged_m: torch.Tensor, ks: int, half: int,
                quarter: int) -> torch.Tensor:
    """The (QUARTER outputs, KSTEP) bf16 block of W^T that a pass's
    descriptor reads for k step ks of warpgroup `half`, pass `quarter`,
    from one staged matrix: the producer's ring stage (half, quarter,
    ks // 4), 128 rows of 64 of K, at byte (ks % 4) W_STEP of its rows.
    TMA writes a row-major box in the 128-byte swizzle, which the
    descriptor of the same swizzle undoes: the block is the stage's
    rows as they lie in the pack."""
    stage = (half * 2 + quarter) * (C // 64) + ks // 4
    r = torch.arange(QUARTER)[:, None]
    j = torch.arange(KSTEP)[None]
    return staged_m[stage * QUARTER * 64 + r * 64 + (ks % 4) * W_STEP // 2
                    + j]


def walk_product(a: torch.Tensor, staged_m: torch.Tensor) -> torch.Tensor:
    """bf16(a) (N, C) @ W as the kernel sums it from the staged matrix:
    per pass of 128 outputs, k step by k step in k_step's order, the
    step's products in float64, rounded to f32 once and added to the f32
    accumulator."""
    ab = a.to(torch.bfloat16).double()
    acc = torch.zeros(a.shape[0], C)
    for half in range(2):
        for quarter in range(2):
            c0 = half * HALF + quarter * QUARTER
            out = slice(c0, c0 + QUARTER)
            for j in range(KSTEPS):
                ks = k_step(j)
                cols = slice(ks * KSTEP, (ks + 1) * KSTEP)
                blk = stage_block(staged_m, ks, half, quarter).double()
                acc[:, out] = acc[:, out] + (ab[:, cols] @ blk.T).float()
    return acc


def walk_chain(x, staged, vecs, use_bn: bool) -> torch.Tensor:
    """The emulated 1b: the resblocks of the staged pack on (N, C) rows."""
    for i in range(staged.shape[0] // 2):
        v = vecs[10 * i:10 * (i + 1)]
        c = walk_product(gelu(x), staged[2 * i]) + v[0]
        if use_bn:
            c = batch_norm_apply(c, v[3], v[4], v[1], v[2])
        c = walk_product(gelu(c), staged[2 * i + 1]) + v[5]
        if use_bn:
            c = batch_norm_apply(c, v[8], v[9], v[6], v[7])
        x = x + c
    return x


def operands(n_blocks: int, use_bn: bool, rows: int, seed: int = 0):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_bf16_weights_round_trip(dtype):
    """Read through the W descriptor stage by stage, the staged pack is
    the bf16 weights, transposed; a k step's block is 4 KB."""
    _, w, _ = operands(2, False, 1)
    w = torch.from_numpy(w).to(dtype)
    staged = fenc.stage_weights_bf16(w)
    assert staged.dtype == torch.bfloat16 and staged.shape == (4, C * C)
    assert staged.is_contiguous()
    assert re.search(r"constexpr int W_STAGE = QUARTER \* STAGE_K \* 2;",
                     SOURCE)
    wb = w.to(torch.bfloat16)
    for m in range(w.shape[0]):
        back = torch.cat([torch.cat([stage_block(staged[m], ks, h, q)
                                     for h in range(2) for q in range(2)])
                          for ks in range(KSTEPS)], 1)
        assert torch.equal(back, wb[m].T)
    assert sorted(k_step(j) for j in range(KSTEPS)) == list(range(KSTEPS))
    assert [k_stage(j) for j in range(8)] == [0, 1, 4, 5, 2, 3, 6, 7]


def test_a_tile_layout_matches_its_descriptor():
    """Where the epilogues write A (a_off) is where the product's
    descriptors read it: k step i of stage kb A_ROW rows of 128 bytes
    (one 64-row block) per stage on and A_STEP bytes into the rows, in
    the 128-byte swizzle; every element has its own place."""
    rows = torch.arange(64)[:, None]
    for ks in range(KSTEPS):
        k = ks * KSTEP + torch.arange(KSTEP)[None]
        read = ((ks // 4) * 64 * A_ROW // 2
                + sw128_offsets(64, KSTEP, (ks % 4) * A_STEP))
        assert torch.equal(read, a_off(rows, k))
    every = a_off(torch.arange(64)[:, None], torch.arange(C)[None])
    assert torch.equal(every.flatten().sort().values, torch.arange(64 * C))


def test_bf16_k_walk_equals_plain_product():
    """One product walked stage by stage from the pack equals bf16(h) @
    bf16(W) summed in f32, to 1e-6 of its magnitude."""
    x, w, _ = operands(1, False, 96, seed=3)
    h, w = gelu(torch.from_numpy(x)), torch.from_numpy(w)
    staged = fenc.stage_weights_bf16(w)
    got = walk_product(h, staged[0])
    ref = fenc._dot(h, w[0], torch.bfloat16)
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()


@pytest.mark.parametrize("use_bn", [False, True])
def test_bf16_tile_walk_matches_plain_and_jax(use_bn):
    """Two resblocks at width 512 from the staged pack: the emulation
    is within the rounding-flip bounds of the plain bf16 chain and of
    JAX's bf16 kernel (interpret mode)."""
    x, w, v = operands(2, use_bn, 100)
    tx, tw, tv = map(torch.from_numpy, (x, w, v))
    staged = fenc.stage_weights_bf16(tw)
    got = walk_chain(tx, staged, tv, use_bn)
    plain = fenc.fused_encoder_eval_reference(tx, tw, tv, use_bn=use_bn,
                                              compute_dtype=torch.bfloat16)
    assert (got - plain).abs().max() <= 1e-3 * plain.abs().max()
    assert (got - plain).abs().mean() <= 5e-6
    ref = np.asarray(jenc.fused_encoder_eval(
        jnp.asarray(x), w, v, tile_rows=64, use_bn=use_bn,
        compute_dtype=jnp.bfloat16))
    diff = np.abs(got.numpy() - ref)
    assert diff.max() <= 5e-4 and diff.mean() <= 5e-6, (diff.max(),
                                                        diff.mean())


def test_bf16_pack_carries_the_staged_operand():
    """pack_encoder(model, bf16) stages its weights once, in `split`, at
    hidden 512, where 1b's tile reads them; at another width (the
    hidden-64 model here) the kernel (encoder_wide_bf16) reads the bf16
    weights as they are and `split` is None. The encoder paths hand its
    views to the wrapper, which on the CPU runs the plain version
    whatever it is given."""
    from vq_vae_transformer_arc_welding_tpu_torch import entry
    wide, _ = entry.build(hidden=C, n_res=1, k=16, d=8, d_model=64,
                          n_heads=1, n_blocks=1, seed=0, device="cpu")
    staged = fenc.pack_encoder(wide, torch.bfloat16)
    assert torch.equal(staged.split, fenc.stage_weights_bf16(staged[0]))
    vq = H.port_vqvae(False)
    packed = fenc.pack_encoder(vq, torch.bfloat16)
    weights, vecs = packed
    assert weights.dtype == torch.bfloat16 and packed.split is None
    x = torch.randn(70, vq.hidden_dim, generator=torch.Generator()
                    .manual_seed(0))
    a = fenc.fused_encoder_eval(x, weights, vecs, use_bn=False,
                                compute_dtype=torch.bfloat16,
                                split=packed.split)
    b = fenc.fused_encoder_eval(x, weights.float(), vecs, use_bn=False,
                                compute_dtype=torch.bfloat16)
    assert torch.equal(a, b)
