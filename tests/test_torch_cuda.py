"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips on a host without one.
The file imports no jax (the machine with the card has none), so it
runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: kernels 1, 3 and 4 keep the f32 residual stream within 1e-4
of its magnitude (the two sum 512-term dot products in other orders;
#1, #3, #4 and #5 in split TF32 on the tensor cores, 2^-21 of a
product);
kernels 5 and 7 may move at most 0.1% of their ids (an ulp of
difference moves an argmin only at a near-tie; 0 expected); the int8
kernels (#2 in both attention variants, #6, #8, #10, #11) may move at
most 0.1% of their int8 outputs, by one step, and their f32 outputs by
1e-3 (an ulp of LayerNorm, attention, exp or tanh difference can cross
a rounding boundary). The int8 attention's quantizing pass (#2 and #6
with int8_attn) is held bit for bit: its scales and int8 operands are
one rounding each, as in the plain version. The int8 GEMM that #2, #6, #8 and #10 share,
launched alone, is held bit for bit against its plain stage: its s32
sums are exact and its epilogue rounds as the plain version does. The
f32 attention kernel (#9) and the decode kernels (#12, #13; their
products in split TF32 on the tensor cores) sum 64- to 2048-term
products in other orders than the plain versions and may contract FMAs:
2e-5 on the attention output
and the written cache row, 1e-4 on the residual stream; every cache row
but `pos` must stay bit-equal. #9 on bf16 q, k and v rounds that f32
output to bf16: at most 1e-3 of the entries differ from the plain
version's, each by one bf16 step or, near 0, by no more than 2e-5. The bf16 encoder chain (#1's
`compute_dtype` variant) rounds each product input to bf16: an ulp of
f32 difference in a gelu output can move one input by 2^-8 of its
value, so a resblock's output is held within 1e-3 of its largest
magnitude (one such flip is ~2e-4 of it), per resblock and fed the same
x, and the whole chain by the ids it leads to. The saturation monitor's
counts (the c_fc GEMM's clip count, #2's rail count of h8) are integers
and held exactly against the plain count on the kernel's own operands
or output; `classify`'s rate, within 1e-3 of its plain path's (an h8
step there moves a count by one). At the shapes the VQ-VAE CLI's flags
reach (hidden 1 to 4,096 on the tiles and csrc/encoder_wide.cu, any
codebook with D up to 256 streamed in chunks) the same bounds hold: the
residual stream 1e-4 of its magnitude, 1b's resblocks 1e-3, ids 0.1%,
and of two equal codes in different chunks the first.
"""
import numpy as np
import pytest
import torch

from vq_vae_transformer_arc_welding_tpu_torch import entry, kernels
from vq_vae_transformer_arc_welding_tpu_torch.ops import (
    attention, fused_attn, fused_attn_quant as fattn,
    fused_block_quant as fbq, fused_decode,
    fused_encoder as fenc, fused_mlp_quant as fmlp, fused_vq as fvq, int8,
    int8_gemm)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _encoder_operands(c: int, n_blocks: int, use_bn: bool, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    bound = (6.0 / (2 * c * 3)) ** 0.5
    w = (torch.rand(2 * n_blocks, c, c, generator=g) * 2 - 1) * bound
    v = torch.zeros(n_blocks, 2, 5, c)
    v[:, :, 0] = torch.randn(n_blocks, 2, c, generator=g) * 0.1
    if use_bn:
        v[:, :, 1] = torch.randn(n_blocks, 2, c, generator=g) * 0.2
        v[:, :, 2] = torch.rand(n_blocks, 2, c, generator=g) * 1.5 + 0.5
        v[:, :, 3] = torch.rand(n_blocks, 2, c, generator=g) + 0.5
        v[:, :, 4] = torch.randn(n_blocks, 2, c, generator=g) * 0.1
    return w, v.reshape(10 * n_blocks, c)


@pytest.mark.parametrize("use_bn", [False, True])
def test_encoder_kernel_matches_plain(dev, use_bn):
    c = 512
    w, v = (a.to(dev) for a in _encoder_operands(c, 4, use_bn))
    x = torch.randn(1000, c, generator=torch.Generator().manual_seed(1))
    x = x.to(dev)           # 1000 rows: a ragged last tile of 40 in 64
    before = kernels.launches["encoder_chain_f32"]
    out = fenc.fused_encoder_eval(x, w, v, use_bn=use_bn)
    ref = fenc.fused_encoder_eval_reference(x, w, v, use_bn=use_bn)
    torch.cuda.synchronize()
    assert kernels.launches["encoder_chain_f32"] == before + 1
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("n,n_blocks", [
    (1000, 1), (77, 2), (25601, 1), (1, 1), (63, 2), (64, 1), (65, 2),
    ("a round + 1", 2), (25601, 8)])
def test_bf16_encoder_kernel_matches_plain(dev, n, n_blocks, use_bn):
    """Rows around a tile and a whole round of 64-row tiles on the card's
    SMs; the whole chain and each resblock within 1e-3 of the plain
    version's largest magnitude; the staged pack, the bf16 weights staged
    in the wrapper and f32 weights cast there give the same bits."""
    c = 512
    if n == "a round + 1":
        n = 64 * torch.cuda.get_device_properties(0).multi_processor_count + 1
    w, v = (a.to(dev) for a in _encoder_operands(c, n_blocks, use_bn))
    x = torch.randn(n, c, generator=torch.Generator().manual_seed(1)).to(dev)
    before = dict(kernels.launches)
    wb = w.bfloat16()
    out = fenc.fused_encoder_eval(x, wb, v, use_bn=use_bn,
                                  compute_dtype=torch.bfloat16)
    ref = fenc.fused_encoder_eval_reference(x, wb, v, use_bn=use_bn,
                                            compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert kernels.launches["encoder_chain_bf16"] == \
        before["encoder_chain_bf16"] + 1
    assert kernels.launches["encoder_chain_f32"] == before["encoder_chain_f32"]
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-3 * ref.abs().max()
    if n_blocks > 1:    # and per resblock, each fed the plain stream
        xi = x
        for i in range(n_blocks):
            wi, vi = wb[2 * i:2 * i + 2], v[10 * i:10 * i + 10]
            yk = fenc.fused_encoder_eval(xi, wi, vi, use_bn=use_bn,
                                         compute_dtype=torch.bfloat16)
            yp = fenc.fused_encoder_eval_reference(
                xi, wi, vi, use_bn=use_bn, compute_dtype=torch.bfloat16)
            assert (yk - yp).abs().max() <= 1e-3 * yp.abs().max()
            xi = yp
    # the pack's staged operand, and f32 weights cast (and staged) inside
    # the wrapper: the same launch, bit-equal
    packed = fenc.fused_encoder_eval(x, wb, v, use_bn=use_bn,
                                     compute_dtype=torch.bfloat16,
                                     split=fenc.stage_weights_bf16(wb))
    assert torch.equal(packed, out)
    again = fenc.fused_encoder_eval(x, w, v, use_bn=use_bn,
                                    compute_dtype=torch.bfloat16)
    assert torch.equal(again, out)
    # and the rounding is really there: the f32 chain is further away
    f32 = fenc.fused_encoder_eval_reference(x, w, v, use_bn=use_bn)
    assert (out - ref).abs().max() < (out - f32).abs().max()


def test_bf16_encoder_wrapper_rejects_bad_operands(dev):
    w, v = (a.to(dev) for a in _encoder_operands(512, 1, False))
    x = torch.randn(8, 512, device=dev)
    with pytest.raises(ValueError, match="compute_dtype"):
        fenc.fused_encoder_eval(x, w, v, use_bn=False,
                                compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        fenc.fused_encoder_eval(x, w.half(), v, use_bn=False,
                                compute_dtype=torch.bfloat16)
    wide = fenc.MAX_WIDTH + 1        # every narrower width runs
    with pytest.raises(ValueError, match="not supported"):
        fenc.fused_encoder_eval(
            torch.zeros(8, wide, device=dev),
            torch.zeros(2, wide, wide, device=dev, dtype=torch.bfloat16),
            torch.zeros(10, wide, device=dev), use_bn=False,
            compute_dtype=torch.bfloat16)


def test_bf16_encode_indices_launches_one_chain(dev):
    """The bf16 encoder at the bench model: one launch of the bf16 chain
    per encode whatever the group, ids within the JAX test's bar of the
    f32 encoder's (under 10% on random weights)."""
    vq, _ = entry.build(seed=0)
    packed = fenc.pack_encoder(vq, torch.bfloat16)
    x = torch.randn(40, 200, 2, generator=torch.Generator().manual_seed(2))
    x = x.to(dev)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        ids = fenc.encode_indices_fused(vq, packed, x,
                                        compute_dtype=torch.bfloat16)
        counts = {k: n for k, n in kernels.launches.items() if n}
        assert counts == {"encoder_chain_bf16": 1}
        kernels.reset_launch_counts()
        ids1 = fenc.encode_indices_fused(vq, packed, x, group_size=1,
                                         compute_dtype=torch.bfloat16)
        assert kernels.launches["encoder_chain_bf16"] == vq.n_resblocks
        assert torch.equal(ids, ids1)
        exact = vq.encode_indices(x)
    assert ids.dtype == torch.int32 and ids.shape == exact.shape
    assert (ids != exact).float().mean() < 0.10


RAGGED_ROWS = [77, 25601]     # a part tile, and one row past 800 tiles
# the ends of the encoder (#4, #5) on #1's 64-row tile and persistent
# walk: one row, a tile less one, one, one and a row, and (ROUND_ROWS)
# one row past a whole round of tiles on every SM
ROUND_ROWS = -1
EDGE_ROWS = [1, 63, 64, 65, *RAGGED_ROWS, ROUND_ROWS]


def _rows(n: int) -> int:
    """n, or for ROUND_ROWS 64 rows a tile x the card's SMs + 1."""
    if n != ROUND_ROWS:
        return n
    return 64 * torch.cuda.get_device_properties(0).multi_processor_count + 1


def _exit_limit(d: int) -> int:
    """The largest K of a (K, d) codebook the exit kernel takes: 64 d +
    K (d + 5) floats within its 64 x 512 A tile."""
    return (64 * 512 - 64 * d) // (d + 5)


def _edge_operands(c: int, d: int, patch: int = 25, seed: int = 7):
    """w_pe (patch, C), b_pe, w_sep (C, D), b_sep at xavier-like spreads."""
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand(patch, c, generator=g) * 2 - 1) * 0.1,
            torch.randn(c, generator=g) * 0.1,
            (torch.rand(c, d, generator=g) * 2 - 1) * 0.1,
            torch.randn(d, generator=g) * 0.1)


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("n", RAGGED_ROWS)
def test_resblock_kernel_matches_plain(dev, n, use_bn):
    c = 512
    w, v = (a.to(dev) for a in _encoder_operands(c, 1, use_bn))
    x = torch.randn(n, c, generator=torch.Generator().manual_seed(1)).to(dev)
    out = _launched("resblock_f32", lambda: fenc.resblock_eval(
        x, w[0], w[1], v, use_bn=use_bn))
    ref = fenc.fused_resblock_eval_reference(x, w[0], w[1], v, use_bn=use_bn)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    # the JAX signature stacks the same rows
    vt = tuple(v)
    same = fenc.fused_resblock_eval(x, w[0], vt[0], vt[1:5], w[1], vt[5],
                                    vt[6:10], use_bn=use_bn)
    assert torch.equal(same, out)


# the 1-window request, a ragged last tile, the 37-window request (185
# tiles: a second round of 53 on 132 SMs)
SPLIT_ROWS = [320, 1000, 11840]


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("n", SPLIT_ROWS)
def test_split_tf32_tile_ragged_tails(dev, n, use_bn):
    """#1 (a group of four) and #3 at the requests' row counts, with the
    split pack made once: within 1e-4 of the plain version's largest
    magnitude; a bare f32 pack, split by the wrapper per call, gives the
    same bits."""
    c = 512
    w, v = (a.to(dev) for a in _encoder_operands(c, 4, use_bn))
    x = torch.randn(n, c, generator=torch.Generator().manual_seed(5)).to(dev)
    split = fenc.split_weights(w)
    out = _launched("encoder_chain_f32", lambda: fenc.fused_encoder_eval(
        x, w, v, use_bn=use_bn, split=split))
    ref = fenc.fused_encoder_eval_reference(x, w, v, use_bn=use_bn)
    assert out.shape == (n, c) and torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(fenc.fused_encoder_eval(x, w, v, use_bn=use_bn), out)
    one = _launched("resblock_f32", lambda: fenc.resblock_eval(
        x, w[0], w[1], v[:10], use_bn=use_bn, split=split[:2]))
    ref1 = fenc.fused_resblock_eval_reference(x, w[0], w[1], v[:10],
                                              use_bn=use_bn)
    assert one.shape == (n, c) and torch.isfinite(one).all()
    assert (one - ref1).abs().max() <= 1e-4 * ref1.abs().max()
    assert torch.equal(fenc.resblock_eval(x, w[0], w[1], v[:10],
                                          use_bn=use_bn), one)


def test_split_pack_on_the_card(dev):
    """pack_encoder on the card carries the split of its weights: per
    matrix hi and lo in (out, in) layout, hi with 13 low mantissa bits
    zero, hi + lo within 2^-21 of w; the encoder paths hand its views to
    the kernels, which read nothing else of the weights (a split of the
    wrong shape is refused before a launch)."""
    vq, _ = entry.build(seed=0)
    weights, vecs = packed = fenc.pack_encoder(vq)
    split = packed.split
    m = weights.shape[0]
    assert split.shape == (m, 2 * 512 * 512)
    assert torch.equal(split, fenc.split_weights(weights))
    # [k // 8][hi, lo][out // 8][k % 8 // 4][out % 8][k % 4] per matrix
    parts = split.reshape(m, 64, 2, 64, 2, 8, 4).permute(
        0, 2, 3, 5, 1, 4, 6).reshape(m, 2, 512, 512)
    hi, lo = parts[:, 0], parts[:, 1]
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    wt = weights.transpose(1, 2)
    assert ((hi + lo - wt).abs() <= 2.0 ** -21 * wt.abs()).all()
    x = torch.randn(64, 512, device=dev)
    before = dict(kernels.launches)
    for bad in (torch.cat([split[:2]] * 2, 1)[:, ::2], split[:2, :-1],
                split[:2].double()):
        with pytest.raises(ValueError):
            fenc.fused_encoder_eval(x, weights[:2], vecs[:10], use_bn=False,
                                    split=bad)
        with pytest.raises(ValueError):
            fenc.resblock_eval(x, weights[0], weights[1], vecs[:10],
                               use_bn=False, split=bad)
    assert kernels.launches == before
    cycles = torch.randn(4, 200, 2, generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        ids = fenc.encode_indices_fused(vq, packed, cycles.to(dev))
        ids1 = fenc.encode_indices_fused(vq, packed, cycles.to(dev),
                                         group_size=1)
        exact = vq.encode_indices(cycles.to(dev))
    assert (ids != exact).float().mean() <= 1e-3
    assert (ids1 != exact).float().mean() <= 1e-3


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("n", EDGE_ROWS)
def test_entry_kernel_matches_plain(dev, n, use_bn):
    """#4 at a group of two: within 1e-4 of the plain version's largest
    magnitude at the row counts around a tile and a round of tiles; the
    pack's split (as the edges path hands it) and a bare pack, split by
    the wrapper per call, give the same bits."""
    c, n = 512, _rows(n)
    w, v = (a.to(dev) for a in _encoder_operands(c, 2, use_bn))
    w_pe, b_pe, _, _ = (a.to(dev) for a in _edge_operands(c, 32))
    g = torch.Generator().manual_seed(2)
    patches = torch.randn(n, 25, generator=g).to(dev)
    split = fenc.split_weights(w)
    out = _launched("encoder_entry_f32", lambda: fenc.fused_encoder_entry_eval(
        patches, w_pe, b_pe, w, v, use_bn=use_bn, split=split))
    ref = fenc.fused_encoder_entry_eval_reference(patches, w_pe, b_pe, w, v,
                                                  use_bn=use_bn)
    assert out.shape == (n, c) and torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(fenc.fused_encoder_entry_eval(
        patches, w_pe, b_pe, w, v, use_bn=use_bn), out)


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tie"])
@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("n,k,d", [
    *((n, 256, 32) for n in EDGE_ROWS), (1000, 32, 16), (1000, 100, 64),
    (1000, 50, 8), (1000, _exit_limit(32), 32), (1000, _exit_limit(64), 64),
    (1000, _exit_limit(8), 8)])
def test_exit_kernel_matches_plain(dev, n, k, d, use_bn, tie):
    """The codebook is drawn at the spread of z (over at least 256 rows);
    with codes 2 and 11 both row 5's own z, no id is 11 (where row 5
    is in the call, code 2 is). The bench model's (256, 32) codebook at
    the row counts around a tile and a round of tiles, the other widths
    the kernel takes, and each width's largest codebook. The pack's
    split and a bare pack give the same ids."""
    c, n = 512, _rows(n)
    w, v = (a.to(dev) for a in _encoder_operands(c, 2, use_bn))
    _, _, w_sep, b_sep = (a.to(dev) for a in _edge_operands(c, d))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(max(n, 256), c, generator=g).to(dev)
    z = fenc.fused_encoder_eval_reference(x, w, v, use_bn=use_bn) @ w_sep \
        + b_sep
    cb = z.mean(0) + torch.randn(k, d, generator=g).to(dev) * z.std(0)
    if tie:
        cb[2] = cb[11] = z[5]
    x = x[:n]
    ids = _launched("encoder_exit_f32", lambda: fenc.fused_encoder_exit_eval(
        x, w, v, w_sep, b_sep, cb, use_bn=use_bn,
        split=fenc.split_weights(w)))
    ref = fenc.fused_encoder_exit_eval_reference(x, w, v, w_sep, b_sep, cb,
                                                 use_bn=use_bn)
    assert ids.dtype == torch.int32 and ids.shape == (n,)
    assert ids.unique().numel() > min(n, k) // 4
    assert (ids != ref).float().mean() <= 1e-3
    assert torch.equal(fenc.fused_encoder_exit_eval(
        x, w, v, w_sep, b_sep, cb, use_bn=use_bn), ids)
    if tie:
        assert not (ids == 11).any()
        if n > 5:
            assert (ids == 2).any()


@pytest.mark.parametrize("n,d,k,tie", [
    (77, 16, 32, False), (512, 8, 16, True), (3000, 32, 256, False),
    (25601, 32, 256, True), (100, 20, 50, False), (100, 64, 300, False),
    (25600, 32, 256, "lanes"), (1000, 32, 50, "lanes"),
    (1000, 32, 300, "lanes"), (1000, 20, 50, "lanes"),
    (3000, 32, 256, "inf"), (300, 64, 300, "inf")])
def test_nearest_codes_kernel_matches_plain(dev, n, d, k, tie):
    """tie=True: codes 2 and 11 equal row 5's z. "lanes": codes 2, 3 (the
    next lane) and 2 + K // 8 equal row 5's z, and codes 8 and 9 each
    other. "inf": a codebook of positive entries and a row of -inf, whose
    distances are all +inf: code 0."""
    g = torch.Generator().manual_seed(4)
    z = torch.randn(n, d, generator=g).to(dev)
    cb = torch.randn(k, d, generator=g).to(dev)
    if tie is True:
        cb[2] = z[5]
        cb[11] = cb[2]
    elif tie == "lanes":
        cb[2] = cb[3] = cb[2 + k // 8] = z[5]
        cb[9] = cb[8]
    elif tie == "inf":
        cb = cb.abs() + 0.1
        z[7] = -torch.inf
    ids = _launched("nearest_codes_f32",
                    lambda: fvq.nearest_codes_pallas(z, cb))
    ref = fvq.nearest_codes_pallas_reference(z, cb)
    assert ids.dtype == torch.int32 and ids.shape == (n,)
    assert (ids != ref).float().mean() <= 1e-3
    if tie is True:
        assert (ids == 2).any() and not (ids == 11).any()
    elif tie == "lanes":
        assert ids[5] == 2 and not ((ids == 3) | (ids == 2 + k // 8)).any()
        assert not (ids == 9).any()
    elif tie == "inf":
        assert ids[7] == 0 and ref[7] == 0


def test_new_encoder_wrappers_reject_bad_operands(dev):
    """Wrong dtype, width, device, contiguity or codebook shape:
    ValueError before any launch."""
    c = 512
    w, v = (a.to(dev) for a in _encoder_operands(c, 1, False))
    w_pe, b_pe, w_sep, b_sep = (a.to(dev) for a in _edge_operands(c, 32))
    x = torch.zeros(64, c, device=dev)
    patches = torch.zeros(64, 25, device=dev)
    cb = torch.zeros(256, 32, device=dev)
    z = torch.zeros(64, 32, device=dev)
    # past the widest hidden width (every narrower one runs)
    cw = fenc.MAX_WIDTH + 1
    xw, ww, vw = (torch.zeros(s, device=dev)
                  for s in ((8, cw), (2, cw, cw), (10, cw)))
    wide_cb = torch.zeros(8, fvq.MAX_D + 1, device=dev)
    before = dict(kernels.launches)
    bad = [
        lambda: fenc.resblock_eval(x.double(), w[0], w[1], v, use_bn=False),
        lambda: fenc.resblock_eval(x, w[0].t(), w[1], v, use_bn=False),
        lambda: fenc.resblock_eval(x, w[0], w[1].cpu(), v, use_bn=False),
        lambda: fenc.resblock_eval(xw, ww[0], ww[1], vw, use_bn=False),
        lambda: fenc.fused_encoder_entry_eval(
            patches.t().contiguous().t(), w_pe, b_pe, w, v, use_bn=False),
        lambda: fenc.fused_encoder_entry_eval(patches, w_pe[:24], b_pe, w, v,
                                              use_bn=False),
        lambda: fenc.fused_encoder_entry_eval(patches.half(), w_pe, b_pe, w,
                                              v, use_bn=False),
        lambda: fenc.fused_encoder_exit_eval(x, w, v, w_sep, b_sep,
                                             cb[:, :24], use_bn=False),
        lambda: fenc.fused_encoder_exit_eval(x, w, v, w_sep.cpu(), b_sep, cb,
                                             use_bn=False),
        lambda: fenc.fused_encoder_exit_eval(
            x, w, v, torch.zeros(c, fvq.MAX_D + 1, device=dev),
            torch.zeros(fvq.MAX_D + 1, device=dev), wide_cb,
            use_bn=False),                  # D past 256
        lambda: fenc.fused_encoder_entry_eval(
            patches, torch.zeros(25, cw, device=dev),
            torch.zeros(cw, device=dev), ww, vw, use_bn=False),
        lambda: fenc.fused_encoder_exit_eval(
            xw, ww, vw, torch.zeros(cw, 32, device=dev), b_sep, cb,
            use_bn=False),
        # a split of another group's shape
        lambda: fenc.fused_encoder_entry_eval(
            patches, w_pe, b_pe, w, v, use_bn=False,
            split=fenc.split_weights(w)[:, :-1]),
        lambda: fenc.fused_encoder_exit_eval(
            x, w, v, w_sep, b_sep, cb, use_bn=False,
            split=torch.cat([fenc.split_weights(w)] * 2)),
        lambda: fvq.nearest_codes_pallas(z.double(), cb),
        lambda: fvq.nearest_codes_pallas(z, cb.cpu()),
        lambda: fvq.nearest_codes_pallas(z[:, ::2], cb[:, ::2]),
        lambda: fvq.nearest_codes_pallas(
            torch.zeros(4, fvq.MAX_D + 1, device=dev), wide_cb),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert kernels.launches == before


def _block_operands(c: int, seed: int = 0, full: bool = False):
    """w_qkv, w_proj, scales, vc, v3c (and w_fc, w_mp, v4c when full)
    at magnitudes like a calibrated block's."""
    rng = np.random.default_rng(seed)
    w_qkv = torch.from_numpy(rng.integers(-127, 128, (3 * c, c), np.int8))
    w_proj = torch.from_numpy(rng.integers(-127, 128, (c, c), np.int8))
    scales = torch.tensor([30.0, 200.0, 30.0, 30.0])
    rows = [rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
            rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
            np.full(c, 2e-5), rng.standard_normal(c) * 0.01]
    if full:
        rows += [np.full(c, 2e-5), rng.standard_normal(c) * 0.01]
    vc = torch.from_numpy(np.stack(rows).astype(np.float32))
    v3c = torch.from_numpy(np.stack([
        np.full(3 * c, 1e-3), rng.standard_normal(3 * c) * 0.1]).astype(
            np.float32))
    if not full:
        return w_qkv, w_proj, scales, vc, v3c
    w_fc = torch.from_numpy(rng.integers(-127, 128, (4 * c, c), np.int8))
    w_mp = torch.from_numpy(rng.integers(-127, 128, (c, 4 * c), np.int8))
    v4c = torch.from_numpy(np.stack([       # GELU inputs of order 1
        np.full(4 * c, 3e-5), rng.standard_normal(4 * c) * 0.1]).astype(
            np.float32))
    return w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c


def _int8_close(out, ref):
    diff = (out.int() - ref.int()).abs()
    assert diff.max() <= 1 and (diff != 0).float().mean() <= 1e-3


SHAPES = [(3, 45, 128, 2), (2, 321, 512, 8),
          # head widths off the bench model's 64: 24 (the quality study's
          # d192 / 8 heads) and 48 padded to 32 and 64, 128, and an odd 3
          (2, 65, 192, 8), (2, 40, 384, 8), (2, 70, 256, 2), (1, 33, 192, 64),
          (1, 33, 1024, 8)]


def _launched(name, fn):
    before = kernels.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    return out


@pytest.mark.parametrize("int8_attn", [False, True])
@pytest.mark.parametrize("b,t,c,n_head", SHAPES)
def test_attn_block_kernel_matches_plain(dev, b, t, c, n_head, int8_attn):
    x = torch.randn(b, t, c, generator=torch.Generator().manual_seed(2))
    args = [a.to(dev).contiguous() for a in (x, *_block_operands(c))]
    name = ("attn_block_quant_int8attn" if int8_attn
            else "attn_block_quant")
    xm, h8 = _launched(name, lambda: fbq.attn_block_quant(
        *args, n_head=n_head, int8_attn=int8_attn))
    xm_ref, h8_ref = fbq.fused_attn_block_quant_reference(
        *args, n_head=n_head, int8_attn=int8_attn)
    _int8_close(h8, h8_ref)
    assert (xm - xm_ref).abs().max() <= 1e-3


@pytest.mark.parametrize("int8_attn", [False, True])
@pytest.mark.parametrize("b,t,c,n_head", SHAPES)
def test_block_kernel_matches_plain(dev, b, t, c, n_head, int8_attn):
    x = torch.randn(b, t, c, generator=torch.Generator().manual_seed(3))
    args = [a.to(dev).contiguous()
            for a in (x, *_block_operands(c, full=True))]
    name = "block_quant_int8attn" if int8_attn else "block_quant"
    out = _launched(name, lambda: fbq.block_quant(
        *args, n_head=n_head, int8_attn=int8_attn))
    ref = fbq.fused_block_quant_reference(*args, n_head=n_head,
                                          int8_attn=int8_attn)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-3


@pytest.mark.parametrize("b,t,c,n_head", SHAPES)
def test_mlp_kernel_matches_plain(dev, b, t, c, n_head):
    h = torch.randn(b, t, c, generator=torch.Generator().manual_seed(4))
    _, _, w_fc, w_mp, scales, vc, _, v4c = _block_operands(c, full=True)
    args = [a.to(dev).contiguous()
            for a in (h, w_fc, w_mp, scales[2:], v4c, vc[6:])]
    out = _launched("mlp_quant", lambda: fmlp.mlp_quant(*args))
    ref = fmlp.mlp_quant_reference(*args)
    assert (out - ref).abs().max() <= 1e-3


@pytest.mark.parametrize("block_rows", [None, 8])
@pytest.mark.parametrize("b,t,c,n_head", SHAPES)
def test_qkv_attention_kernel_matches_plain(dev, b, t, c, n_head,
                                            block_rows):
    h = torch.randn(b, t, c, generator=torch.Generator().manual_seed(5))
    w_qkv, _, scales, _, v3c = _block_operands(c)
    args = [a.to(dev).contiguous() for a in (h, w_qkv, scales[:2], v3c)]
    y8 = _launched("qkv_attention_quant", lambda: fattn.qkv_attention_quant(
        *args, n_head=n_head, block_rows=block_rows))
    _int8_close(y8, fattn.qkv_attention_quant_reference(*args,
                                                        n_head=n_head))


@pytest.mark.parametrize("b,t,c,n_head", SHAPES)
def test_causal_attention_kernel_matches_plain(dev, b, t, c, n_head):
    g = torch.Generator().manual_seed(6)
    qkv = (torch.randn(b, t, 3 * c, generator=g) * 2).to(dev)
    y_scale = torch.tensor(200.0, device=dev)
    y8 = _launched("causal_attention_quant",
                   lambda: fattn.fused_causal_attention_quant(
                       qkv, y_scale, n_head=n_head))
    _int8_close(y8, fattn.causal_attention_quant_reference(qkv, y_scale,
                                                           n_head=n_head))


@pytest.mark.parametrize("m,k,n", [(321, 512, 1536), (80, 321, 2), (8, 512, 1),
                                   (16, 2048, 512), (1, 2048, 512),
                                   (16, 512, 258), (1, 512, 258),
                                   # past the f32 product's exact K of
                                   # 1,040: the class head at d_model
                                   # 1,600 and l2 at T = 1,041
                                   (80, 1041, 1), (80, 1600, 1),
                                   (2, 4096, 258), (33, 1041, 2)])
def test_int8_matmul_exact_on_cuda(dev, m, k, n):
    """_int_mm on operands zero-padded up to its shape rules (K and N to
    multiples of 8, the 1 to 16 rows of a decode step to its minimum):
    exact at every K and N (lm_head's 258 columns, the class head's one
    at any d_model)."""
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (m, k), np.int8)
    w = rng.integers(-127, 128, (n, k), np.int8)
    out = int8.int8_matmul(torch.from_numpy(a).to(dev),
                           torch.from_numpy(w).to(dev))
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64).T)


# -- the int8 GEMM of #2, #6, #8 and #10 ------------------------------------

# rows: ragged around the 64-row warpgroup and 128-row tile, one sequence
# (321) and batch 80 of the bench model (25,680 = 200 x 128 + 80)
GEMM_ROWS = [1, 17, 63, 64, 65, 127, 128, 129, 321, 25680]
# (N, K) of qkv, c_proj, c_fc and m_proj at C = 512, 128, 192 and 1024
GEMM_NK = [(n, k) for c in (512, 128, 192, 1024)
           for n, k in ((3 * c, c), (c, c), (4 * c, c), (c, 4 * c))]
GEMM_EPILOGUES = ["f32", "f32+resid", "gelu_q8"]


def _gemm_operands(m, n, k, epilogue, seed=0):
    """Inputs +-127, each row of a and w leaning to one sign by its own
    odds, so that sums reach +-K * 127^2, past 2^24 at K >= 2048, where
    the s32 -> f32 conversion rounds (the odd entries make it round).
    Scales put y near 1 (GELU inputs of order 1, q8 outputs across the
    int8 range)."""
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


@pytest.mark.parametrize("epilogue", GEMM_EPILOGUES)
@pytest.mark.parametrize("n,k", GEMM_NK)
@pytest.mark.parametrize("m", GEMM_ROWS)
def test_int8_gemm_bit_equal_to_plain(dev, m, n, k, epilogue):
    """The GEMM (wgmma, TMA, persistent tiles) against the plain stage,
    bit for bit: s32 sums are exact in any order and the epilogue rounds
    as the plain version does."""
    a8, w8, cs, cb, resid, qscale = (
        None if v is None else torch.as_tensor(v).to(dev)
        for v in _gemm_operands(m, n, k, epilogue, seed=m + n + k))
    out = _launched("int8_gemm", lambda: int8_gemm.int8_gemm(
        a8, w8, cs, cb, resid, qscale))
    ref = int8_gemm.int8_gemm_reference(a8, w8, cs, cb, resid, qscale)
    assert out.dtype == ref.dtype and out.shape == ref.shape == (m, n)
    assert torch.equal(out, ref)
    if epilogue == "gelu_q8" and m >= 128:     # the int8 range is used
        assert int(out.max()) > 60 and int(out.min()) < 0


@pytest.mark.parametrize("k", [1040, 1041, 4096])
def test_int8_bmm_exact_past_1040(dev, k):
    """The int8 attention's batched product, its K cut into f32 products
    of at most 1,040 terms: exact at a head or a T past 1,040."""
    rng = np.random.default_rng(k)
    a = rng.integers(-127, 128, (2, 3, 17, k), np.int8)
    b = rng.integers(-127, 128, (2, 3, k, 9), np.int8)
    a[..., ::2], b[..., ::2, :] = 127, 127      # sums past 2^24
    out = int8.int8_bmm(torch.from_numpy(a).to(dev),
                        torch.from_numpy(b).to(dev))
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_int8_gemm_sums_pass_2_24(dev):
    """The operands above reach sums past 2^24 at K = 2048, where the
    conversion to f32 rounds some of them."""
    a8, w8, *_ = _gemm_operands(129, 512, 2048, "f32")
    acc = int8.int8_matmul(torch.from_numpy(a8).to(dev),
                           torch.from_numpy(w8).to(dev))
    assert int(acc.abs().max()) > 2 ** 24
    assert bool((acc.float().long() != acc.long()).any())


@pytest.mark.parametrize("epilogue", GEMM_EPILOGUES)
@pytest.mark.parametrize("k_cols,n_rows", [(96, 128), (128, 96)],
                         ids=["K96", "N96"])
def test_int8_gemm_takes_n_and_k_off_64(dev, k_cols, n_rows, epilogue):
    """N or K off a multiple of 64 (once refused): the GEMM's general
    form, bit-equal to the plain stage on the same operands."""
    a8, w8, cs, cb, resid, qs = (
        None if v is None else torch.as_tensor(v).to(dev)
        for v in _gemm_operands(65, 128, 128, epilogue))
    a8, w8 = a8[:, :k_cols].contiguous(), w8[:n_rows, :k_cols].contiguous()
    cs, cb = cs[:n_rows].contiguous(), cb[:n_rows].contiguous()
    resid = None if resid is None else resid[:, :n_rows].contiguous()
    out = _launched("int8_gemm", lambda: int8_gemm.int8_gemm(
        a8, w8, cs, cb, resid, qs))
    assert torch.equal(out, int8_gemm.int8_gemm_reference(a8, w8, cs, cb,
                                                          resid, qs))


def test_int8_gemm_rejects_bad_operands(dev):
    """Wrong dtype, shape, device or layout, or both epilogues at once:
    ValueError before a launch."""
    a8, w8, cs, cb, resid, _ = (
        None if v is None else torch.as_tensor(v).to(dev)
        for v in _gemm_operands(65, 128, 128, "f32+resid"))
    qs = torch.tensor(30.0, device=dev)
    before = dict(kernels.launches)
    bad = [
        lambda: int8_gemm.int8_gemm(a8[:, :96].contiguous(), w8[:, :96],
                                    cs, cb),            # w8's rows 128 apart
        lambda: int8_gemm.int8_gemm(a8, w8[:96], cs, cb),
        lambda: int8_gemm.int8_gemm(a8.float(), w8, cs, cb),
        lambda: int8_gemm.int8_gemm(a8, w8.cpu(), cs, cb),
        lambda: int8_gemm.int8_gemm(a8[:, ::2], w8[:, :64].contiguous(),
                                    cs, cb),
        lambda: int8_gemm.int8_gemm(a8, w8, cs[:64], cb),
        lambda: int8_gemm.int8_gemm(a8, w8, cs, cb, resid[:64]),
        lambda: int8_gemm.int8_gemm(a8, w8, cs, cb, resid, qs),
        lambda: int8_gemm.int8_gemm(a8, w8, cs, cb, qscale=qs[None]),
        lambda: int8_gemm.int8_gemm(a8, w8, cs, cb, clip_rows=torch.zeros(
            65, dtype=torch.int32, device=dev)),
        lambda: int8_gemm.int8_gemm(a8, w8, cs, cb, qscale=qs,
                                    clip_rows=torch.zeros(65, device=dev)),
        lambda: int8_gemm.int8_gemm(a8, w8, cs, cb, qscale=qs,
                                    clip_rows=torch.zeros(
                                        64, dtype=torch.int32, device=dev)),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert kernels.launches == before


# the in-path monitor's count in the GELU+q8 epilogue: one sequence, a
# ragged batch and batch 80 of the bench model
CLIP_ROWS = [1, 321, 11877, 25680]


@pytest.mark.parametrize("m", CLIP_ROWS)
def test_int8_gemm_clip_counts_equal_plain(dev, m):
    """c_fc at C = 512 with clip_rows: each row's count of
    |new_gelu(y) * qscale| > 127.5 equals the plain stage's on the same
    operands, at a qscale that clips 1-10% of the values; rows past M
    (the last tile's zero rows, whose new_gelu(cb) clips in eight
    columns here) count nothing; two calls count the same; g8 stays
    bit-equal to the plain stage's."""
    a8, w8, cs, cb, _, _ = (
        None if v is None else torch.as_tensor(v).to(dev)
        for v in _gemm_operands(m, 2048, 512, "gelu_q8", seed=m))
    cb[:8] = 10.0
    qs = torch.tensor(45.0, device=dev)
    got = []
    for _ in range(2):
        buf = torch.zeros(m + 256, dtype=torch.int32, device=dev)
        g8 = _launched("int8_gemm", lambda: int8_gemm.int8_gemm(
            a8, w8, cs, cb, qscale=qs, clip_rows=buf[:m]))
        got.append((g8, buf))
    want = torch.zeros(m, dtype=torch.int32, device=dev)
    ref = int8_gemm.int8_gemm_reference(a8, w8, cs, cb, qscale=qs,
                                        clip_rows=want)
    for g8, buf in got:
        assert torch.equal(g8, ref)
        assert torch.equal(buf[:m], want)
        assert not buf[m:].any()
    if m >= 321:
        assert 0.01 <= float(want.sum()) / (m * 2048) <= 0.1


# C = 128, 512, 768 and 1024 take 16-byte pieces, C = 192 8-byte ones;
# 135 and 963 rows leave a part block of eight rows; every other width
# the runtime-width kernel (ln_q8_any_kernel), byte stores into rows
# pitch16(C) bytes apart
LN_SHAPES = [(3, 45, 128), (3, 321, 512), (3, 45, 768), (3, 45, 1024),
             (3, 45, 192), (3, 45, 100), (3, 45, 1100), (2, 33, 2048),
             (2, 33, 4096)]


@pytest.mark.parametrize("b,t,c", LN_SHAPES)
def test_ln_q8_rows_and_rail_counts(dev, b, t, c):
    """#2's two LN+q8 launches (csrc/ln_q8.cuh): h8a against the plain
    LayerNorm + q8 of x and h8 against that of the kernel's own x_mid,
    within the int8 contract; rail_rows equal to the count of the
    kernel's own h8 at +-127, overwritten (the buffer held -1), and
    some rows at a rail."""
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    x = torch.randn(b, t, c, generator=torch.Generator().manual_seed(c))
    args = [a.to(dev).contiguous() for a in (x, *_block_operands(c))]
    x, _, _, scales, vc, _ = args
    rails = torch.full((b, t), -1, dtype=torch.int32, device=dev)
    sc = {}
    xm, h8 = _launched("attn_block_quant", lambda: fbq.attn_block_quant(
        *args, n_head=c // 64 if c % 64 == 0 else 1, scratch=sc,
        rail_rows=rails))
    _int8_close(sc["h8a"], int8.quantize_act(layer_norm(x, vc[0], vc[1]),
                                             scales[0]))
    _int8_close(h8, int8.quantize_act(layer_norm(xm, vc[2], vc[3]),
                                      scales[2]))
    want = (h8.int().abs() == 127).sum(-1, dtype=torch.int32)
    assert torch.equal(rails, want)
    assert int(want.sum()) > 0


def test_classify_monitor_runs_the_gemm_and_matches_plain(dev):
    """classify with its default saturation monitor, on act scales of
    half the calibrated absmax (serving drifted past calibration):
    int8_gemm twice a block, and last_saturation_rate above 0 and within
    1e-3 of the same call with #2 and the GEMM replaced by their plain
    versions (h8 may move by a step in 0.1% of its entries)."""
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        WeldingQualityPipeline)
    vq, tr = entry.build(n_blocks=2, seed=0, device=dev)
    windows = np.random.default_rng(1).standard_normal(
        (6, entry.N_CYCLES * 200, 2)).astype(np.float32)
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=entry.N_CYCLES,
                                  precision="int8")
    am = pipe.calibrate(windows[:2])
    pipe._set_calibration({k: v / 2 for k, v in am.items()})
    kernels.reset_launch_counts()
    labels, _ = pipe.classify(windows)
    assert kernels.launches["int8_gemm"] == 2 * 2
    assert kernels.launches["attn_block_quant"] == 2
    rate = pipe.last_saturation_rate
    real = (int8_gemm.int8_gemm, fbq.attn_block_quant)
    int8_gemm.int8_gemm = int8_gemm.int8_gemm_reference
    fbq.attn_block_quant = fbq.fused_attn_block_quant_reference
    try:
        plain_labels, _ = pipe.classify(windows)
    finally:
        int8_gemm.int8_gemm, fbq.attn_block_quant = real
    assert rate > 0.001
    assert abs(rate - pipe.last_saturation_rate) <= 1e-3
    assert labels.shape == plain_labels.shape == (6,)


def test_wrapper_rejects_bad_operands(dev):
    x = torch.zeros(64, 512, device=dev)
    w, v = (a.to(dev) for a in _encoder_operands(512, 1, False))
    with pytest.raises(ValueError):
        fenc.fused_encoder_eval(x.double(), w, v, use_bn=False)
    with pytest.raises(ValueError):
        fenc.fused_encoder_eval(x[:, ::2], w, v, use_bn=False)
    with pytest.raises(ValueError):
        fenc.fused_encoder_eval(x, w.cpu(), v, use_bn=False)
    wide = fenc.MAX_WIDTH + 1       # past the widest hidden width
    with pytest.raises(ValueError, match=str(fenc.MAX_WIDTH)):
        fenc.fused_encoder_eval(torch.zeros(8, wide, device=dev),
                                torch.zeros(2, wide, wide, device=dev),
                                torch.zeros(10, wide, device=dev),
                                use_bn=False)


def test_int8_wrappers_reject_bad_operands(dev):
    """Wrong dtype, shape, device, contiguity or head width: ValueError
    before any launch."""
    c = 128
    w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c = (
        a.to(dev) for a in _block_operands(c, full=True))
    x = torch.zeros(2, 9, c, device=dev)
    before = dict(kernels.launches)
    bad = [
        lambda: fbq.attn_block_quant(x.double(), w_qkv, w_proj, scales,
                                     vc[:6], v3c, n_head=2),
        lambda: fbq.attn_block_quant(x, w_qkv, w_proj, scales, vc, v3c,
                                     n_head=2),             # vc (8, C)
        lambda: fbq.attn_block_quant(x, w_qkv, w_proj, scales, vc[:6], v3c,
                                     n_head=3),             # 128 / 3 heads
        lambda: fbq.block_quant(x, w_qkv, w_proj, w_fc, w_mp, scales,
                                vc[:6], v3c, v4c, n_head=2),
        lambda: fbq.block_quant(x, w_qkv, w_proj, w_fc.cpu(), w_mp, scales,
                                vc, v3c, v4c, n_head=2, int8_attn=True),
        lambda: fmlp.mlp_quant(x[:, ::2], w_fc, w_mp, scales[2:], v4c,
                               vc[6:]),
        lambda: fmlp.mlp_quant(x, w_fc, w_mp, scales, v4c, vc[6:]),
        lambda: fattn.qkv_attention_quant(x, w_qkv, scales[:2], v3c[:, :c],
                                          n_head=2),
        lambda: fattn.qkv_attention_quant(x, w_qkv, scales[:2], v3c,
                                          n_head=2, block_rows=12),
        lambda: fattn.fused_causal_attention_quant(
            torch.zeros(2, 9, 3 * c, device=dev, dtype=torch.float16),
            scales[1], n_head=2),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert kernels.launches == before


# -- kernel #9 ------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed"])
@pytest.mark.parametrize("b,h,t", [(3, 2, 45), (2, 8, 321), (1, 1, 64),
                                   (1, 3, 65)])
def test_flash_attention_kernel_matches_plain(dev, b, h, t, packed):
    """packed: q, k, v are the strided views split_heads cuts out of a
    (B, T, 3C) qkv, which the kernel reads in place."""
    g = torch.Generator().manual_seed(7)
    if packed:
        qkv = torch.randn(b, t, 3 * h * 64, generator=g).to(dev)
        q, k, v = (attention.split_heads(z, h)
                   for z in qkv.split(h * 64, dim=-1))
    else:
        q, k, v = (torch.randn(b, h, t, 64, generator=g).to(dev)
                   for _ in range(3))
    out = _launched("flash_attention_f32",
                    lambda: fused_attn.flash_causal_attention(q, k, v))
    ref = fused_attn.flash_causal_attention_reference(q, k, v)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 2e-5
    merged = attention.merge_heads(out)
    assert merged.data_ptr() == out.data_ptr()      # a view, no copy


# sequence lengths around the attention tile's edges: its 16-row warp
# tiles, its 64-row blocks and 64-key stages, the bench T = 321 = 5*64 + 1
RAGGED_T = [1, 15, 16, 17, 63, 64, 65, 320, 321, 385]


@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed"])
@pytest.mark.parametrize("t", RAGGED_T)
def test_flash_attention_ragged_t(dev, t, packed):
    g = torch.Generator().manual_seed(t)
    if packed:
        qkv = torch.randn(2, t, 3 * 3 * 64, generator=g).to(dev)
        q, k, v = (attention.split_heads(z, 3)
                   for z in qkv.split(3 * 64, dim=-1))
    else:
        q, k, v = (torch.randn(2, 3, t, 64, generator=g).to(dev)
                   for _ in range(3))
    out = _launched("flash_attention_f32",
                    lambda: fused_attn.flash_causal_attention(q, k, v))
    ref = fused_attn.flash_causal_attention_reference(q, k, v)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 2e-5


@pytest.mark.parametrize("int8_attn", [False, True])
@pytest.mark.parametrize("t", RAGGED_T)
def test_attn_block_kernel_ragged_t(dev, t, int8_attn):
    """q, k, v of order 2 and y quantized to their range, as calibration
    leaves them (_block_operands' qkv of order 50 saturates y8). Held
    stage by stage, as chip_smoke holds #2: each step against its plain
    version fed the kernel's own input, so that a y8 step allowed by the
    int8 contract does not count again in x_mid."""
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    x = torch.randn(2, t, 128, generator=torch.Generator().manual_seed(t))
    w_qkv, w_proj, scales, vc, v3c = _block_operands(128)
    scales[1] = 127.0 / 4.0
    v3c[0] = 4e-5
    x, w_qkv, w_proj, scales, vc, v3c = (
        a.to(dev).contiguous() for a in (x, w_qkv, w_proj, scales, vc, v3c))
    name = ("attn_block_quant_int8attn" if int8_attn
            else "attn_block_quant")
    sc = {}
    xm, h8 = _launched(name, lambda: fbq.attn_block_quant(
        x, w_qkv, w_proj, scales, vc, v3c, n_head=2, int8_attn=int8_attn,
        scratch=sc))
    y8 = int8.quantize_act(fattn.attention_core_reference(
        sc["qkv"], 2, int8_attn=int8_attn), scales[1])
    _int8_close(sc["y8"], y8)
    xm_ref = x + (int8.int8_matmul(sc["y8"], w_proj).float() * vc[4] + vc[5])
    assert (xm - xm_ref).abs().max() <= 1e-3
    _int8_close(h8, int8.quantize_act(layer_norm(xm, vc[2], vc[3]),
                                      scales[2]))


# past 384 rows the quantizing pass reads a head's rows a second time
INT8_ATTN_T = [1, 63, 64, 65, 321, 385, 1000]


def _int8_attention_scratch(dev, t, c, seed):
    """#2 with int8_attn on the card at batch 2, its scratch kept: q, k,
    v of order 2 and y quantized to its range, as in
    test_attn_block_kernel_ragged_t. Returns (scratch, y's scale)."""
    x = torch.randn(2, t, c, generator=torch.Generator().manual_seed(seed))
    w_qkv, w_proj, scales, vc, v3c = _block_operands(c)
    scales[1] = 127.0 / 4.0
    v3c[0] = 4e-5
    args = [a.to(dev).contiguous()
            for a in (x, w_qkv, w_proj, scales, vc, v3c)]
    sc = {}
    _launched("attn_block_quant_int8attn", lambda: fbq.attn_block_quant(
        *args, n_head=c // 64, int8_attn=True, scratch=sc))
    return sc, args[3][1]


@pytest.mark.parametrize("c", [128, 512])
@pytest.mark.parametrize("t", INT8_ATTN_T)
def test_int8_attention_quantizing_pass_bit_equal(dev, t, c):
    """head_quant_kernel's scales and int8 operands (qkv8, with its zero
    padding and key order) bit-equal to quantize_heads_reference on the
    kernel's own qkv."""
    sc, _ = _int8_attention_scratch(dev, t, c, seed=t)
    qkv8, head_scales = fbq.quantize_heads_reference(sc["qkv"], c // 64)
    assert torch.equal(sc["head_scales"], head_scales)
    assert torch.equal(sc["qkv8"], qkv8)


@pytest.mark.parametrize("c", [128, 512])
@pytest.mark.parametrize("t", INT8_ATTN_T)
def test_int8_attention_y8_matches_plain(dev, t, c):
    """attention_int8_kernel's y8 against the plain int8 attention on
    the kernel's own qkv: one step in at most 1e-3 of entries."""
    sc, y_scale = _int8_attention_scratch(dev, t, c, seed=t + 1)
    y8 = int8.quantize_act(fattn.attention_core_reference(
        sc["qkv"], c // 64, int8_attn=True), y_scale)
    _int8_close(sc["y8"], y8)


@pytest.mark.parametrize("scale", [2.0, 8.0], ids=["qkv", "qkv_x8"])
@pytest.mark.parametrize("t", RAGGED_T)
def test_causal_attention_kernel_ragged_t(dev, t, scale):
    """#11, the f32 attention launch alone; x8 gives scores in the tens,
    as chip_smoke's #9 inputs have."""
    g = torch.Generator().manual_seed(t)
    qkv = (torch.randn(2, t, 3 * 128, generator=g) * scale).to(dev)
    y_scale = torch.tensor(200.0 / scale, device=dev)
    y8 = _launched("causal_attention_quant",
                   lambda: fattn.fused_causal_attention_quant(
                       qkv, y_scale, n_head=2))
    _int8_close(y8, fattn.causal_attention_quant_reference(qkv, y_scale,
                                                           n_head=2))


def test_flash_attention_large_scores(dev):
    """The bench model's activations times 8, as chip_smoke feeds #9:
    scores reach the tens, where a score's rounding moves p the most."""
    from vq_vae_transformer_arc_welding_tpu_torch.models.transformer import (
        linear)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    _, tr = entry.build(n_blocks=1, seed=0, device=dev)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 321))).to(dev)
    ids[:, 0] = 256
    blk = tr.blocks[0]
    with torch.inference_mode():
        h = layer_norm(tr.embed(ids), blk.ln_1.weight, blk.ln_1.bias)
        qkv = linear(h, blk.attn.c_attn) * 8.0
        q, k, v = (attention.split_heads(z, 8) for z in qkv.split(512, -1))
        out = _launched("flash_attention_f32",
                        lambda: fused_attn.flash_causal_attention(q, k, v))
        ref = fused_attn.flash_causal_attention_reference(q, k, v)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 2e-5


@pytest.mark.parametrize("fusion", ["attn", "full"])
def test_d192_one_head_model_runs_on_the_kernels(dev, fusion):
    """A d_model 192 model with one head (head width 192, past the
    tile's 128: the f32 attention's wide tile) through
    make_pipeline_quantized on its kernels: labels equal the plain
    path's where its logit margin exceeds 1e-3. It once raised before
    the first attention kernel."""
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        WeldingQualityPipeline)
    vq, tr = entry.build(d_model=192, n_blocks=1, n_heads=1, seed=0,
                         device=dev)
    windows = np.random.default_rng(0).standard_normal(
        (6, entry.N_CYCLES * 200, 2)).astype(np.float32)
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=entry.N_CYCLES,
                                  precision="int8")
    pipe.calibrate(windows[:2])
    fn = entry.make_pipeline_quantized(vq, tr, pipe.qparams,
                                       block_fusion=fusion)
    x = torch.from_numpy(windows).to(dev)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        out = fn(x)
        torch.cuda.synchronize()
        kernel = "attn_block_quant" if fusion == "attn" else "block_quant"
        assert kernels.launches[kernel] == 1
        real = (fbq.attn_block_quant, fbq.block_quant, int8_gemm.int8_gemm)
        fbq.attn_block_quant = fbq.fused_attn_block_quant_reference
        fbq.block_quant = fbq.fused_block_quant_reference
        int8_gemm.int8_gemm = int8_gemm.int8_gemm_reference
        try:
            ref = fn(x)
        finally:
            (fbq.attn_block_quant, fbq.block_quant,
             int8_gemm.int8_gemm) = real
    sure = (ref[:, 0] - ref[:, 1]).abs() > 1e-3
    assert torch.isfinite(out).all()
    assert torch.equal(out.argmax(-1)[sure], ref.argmax(-1)[sure])


def test_flash_attention_gradients_on_cuda(dev):
    g = torch.Generator().manual_seed(8)

    def grads(fn):
        leaves = [torch.randn(2, 2, 70, 64, generator=g.manual_seed(8 + i))
                  .to(dev).requires_grad_(True) for i in range(3)]
        (fn(*leaves) ** 2).sum().backward()
        return [z.grad for z in leaves]

    for got, want in zip(grads(fused_attn.flash_causal_attention),
                         grads(attention.causal_attention_core)):
        assert (got - want).abs().max() <= 1e-4


def test_flash_wrapper_rejects_bad_operands(dev):
    q = torch.zeros(2, 2, 9, 64, device=dev)
    wide = torch.zeros(1, 1, 9, 4097, device=dev)   # a head past 4,096
    before = dict(kernels.launches)
    bad = [lambda: fused_attn.flash_causal_attention(wide, wide, wide),
           lambda: fused_attn.flash_causal_attention(q.double(), q, q),
           lambda: fused_attn.flash_causal_attention(q, q[:, :, :8], q),
           lambda: fused_attn.flash_causal_attention(q, q.cpu(), q)]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert kernels.launches == before


# -- kernels #12 and #13 -------------------------------------------------------

def _decode_block(dev, c, n_head, seed=0):
    """A transformer Block on the card with every operand random, the
    biases and LayerNorm rows included (GPT-2 init leaves them 0 and 1)."""
    _, tr = entry.build(d_model=c, n_blocks=1, n_heads=n_head, hidden=64,
                        n_res=1, k=32, d=16, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    blk = tr.blocks[0]
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if p.ndim == 1:
                noise = torch.randn(p.shape, generator=g).to(dev) * 0.1
                p.copy_(noise + (1.0 if "ln" in name and "weight" in name
                                 else 0.0))
            else:
                p.copy_(torch.randn(p.shape, generator=g).to(dev)
                        * p.shape[1] ** -0.5)
    return blk


DECODE_SHAPES = [(3, 128, 2, 45, (0, 17, 44)),
                 (16, 512, 8, 321, (0, 127, 128, 320)),
                 (1, 512, 8, 321, (160,)),
                 (20, 256, 4, 70, (69,)),      # two tiles of 16 rows
                 (80, 512, 8, 321, (320,)),    # five tiles, weights on chip
                 # weights streamed through the ring (more than fit on
                 # chip), over two row tiles, and a width the parent refused
                 (20, 768, 12, 40, (0, 39)),
                 (2, 1024, 16, 33, (32,)),
                 # an odd number of 64-wide heads: a warp's k slice ends
                 # in half a 16-column block
                 (5, 192, 3, 30, (0, 29)),
                 (2, 64, 1, 10, (9,)),
                 # head widths off the bench model's: 24 (16 lanes a key,
                 # padded), 128 (a warp a key), an odd 3 and 96
                 (16, 192, 8, 321, (0, 160, 320)),
                 (4, 256, 2, 70, (0, 69)),
                 (3, 192, 64, 30, (0, 29)),
                 (2, 384, 4, 40, (39,)),
                 (2, 1024, 8, 33, (0, 32))]


@pytest.mark.parametrize("b,c,n_head,t,positions", DECODE_SHAPES)
def test_block_decode_kernel_matches_plain(dev, b, c, n_head, t, positions):
    blk = _decode_block(dev, c, n_head)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(b, 1, c, generator=g).to(dev)
    kc = torch.randn(b, t, c, generator=g).to(dev)
    vc = torch.randn(b, t, c, generator=g).to(dev)
    for pos in positions:
        k0, v0 = kc.clone(), vc.clone()
        kr, vr = kc.clone(), vc.clone()
        out, ok, ov = _launched("block_decode_f32",
                                lambda: fused_decode.fused_block_decode(
                                    x, blk, kc, vc, pos, n_head=n_head))
        ref, _, _ = fused_decode.fused_block_decode_reference(
            x, blk, kr, vr, pos, n_head=n_head)
        assert ok is kc and ov is vc
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-4
        rest = torch.arange(t, device=dev) != pos
        for got, want, before in ((kc, kr, k0), (vc, vr, v0)):
            assert (got[:, pos] - want[:, pos]).abs().max() <= 2e-5
            assert torch.equal(got[:, rest], before[:, rest])


@pytest.mark.parametrize("b,c,n_head,t,positions", DECODE_SHAPES)
def test_decode_attn_kernel_matches_plain(dev, b, c, n_head, t, positions):
    blk = _decode_block(dev, c, n_head)
    g = torch.Generator().manual_seed(10)
    x = torch.randn(b, 1, c, generator=g).to(dev)
    kc = torch.randn(b, n_head, t, c // n_head, generator=g).to(dev)
    vc = torch.randn(b, n_head, t, c // n_head, generator=g).to(dev)
    for pos in positions:
        k0, v0 = kc.clone(), vc.clone()
        kr, vr = kc.clone(), vc.clone()
        out, _, _ = _launched("decode_attn_f32",
                              lambda: fused_decode.fused_decode_attn(
                                  x, blk, kc, vc, pos, n_head=n_head))
        ref, _, _ = fused_decode.fused_decode_attn_reference(
            x, blk, kr, vr, pos, n_head=n_head)
        assert (out - ref).abs().max() <= 1e-4
        rest = torch.arange(t, device=dev) != pos
        for got, want, before in ((kc, kr, k0), (vc, vr, v0)):
            assert (got[:, :, pos] - want[:, :, pos]).abs().max() <= 2e-5
            assert torch.equal(got[:, :, rest], before[:, :, rest])


def _decode_operands(dev, b=16, c=512, n_head=8, t=321, layout="flat"):
    g = torch.Generator().manual_seed(11)
    shape = (b, t, c) if layout == "flat" else (b, n_head, t, c // n_head)
    return (torch.randn(b, 1, c, generator=g).to(dev),
            torch.randn(*shape, generator=g).to(dev),
            torch.randn(*shape, generator=g).to(dev))


@pytest.mark.parametrize("fn,layout", [("fused_block_decode", "flat"),
                                       ("fused_decode_attn", "heads")])
def test_decode_kernels_give_the_same_bits_twice(dev, fn, layout):
    """Sums in a fixed order and no float atomics: two calls on the same
    operands give bit-equal outputs and cache rows."""
    blk = _decode_block(dev, 512, 8)
    x, kc, vc = _decode_operands(dev, layout=layout)
    k2, v2 = kc.clone(), vc.clone()
    out1, _, _ = getattr(fused_decode, fn)(x, blk, kc, vc, 160, n_head=8)
    out2, _, _ = getattr(fused_decode, fn)(x, blk, k2, v2, 160, n_head=8)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)


def test_decode_kernel_grid_barrier_holds_over_a_thousand_calls(dev):
    """1,000 launches of #13 in a row (every position of a 321-row cache,
    three times) finish: the grid barrier leaves its count at 0 after
    each launch and never hangs; the last output equals a fresh call's."""
    blk = _decode_block(dev, 512, 8)
    x, kc, vc = _decode_operands(dev, b=4)
    before = kernels.launches["block_decode_f32"]
    for i in range(1000):
        out, _, _ = fused_decode.fused_block_decode(x, blk, kc, vc, i % 321,
                                                    n_head=8)
    torch.cuda.synchronize()
    assert kernels.launches["block_decode_f32"] == before + 1000
    again, _, _ = fused_decode.fused_block_decode(x, blk, kc, vc, 999 % 321,
                                                  n_head=8)
    assert torch.equal(out, again)
    # the kernels' words on the caches' device (cuda:0: `dev` is "cuda",
    # another key of _barrier's cache)
    assert int(fused_decode._barrier(kc.device)[0]) == 0


def test_block_decode_stack_launches_once_a_block(dev):
    """BlockDecodeStack (the generation's path, operands checked once):
    one launch a block a token, the same bits as fused_block_decode per
    block, and the same cache rows."""
    _, tr = entry.build(d_model=512, n_blocks=3, n_heads=8, hidden=64,
                        n_res=1, k=32, d=16, seed=3, device=dev)
    g = torch.Generator().manual_seed(12)
    caches = [tuple(torch.randn(16, 321, 512, generator=g).to(dev)
                    for _ in range(2)) for _ in range(3)]
    ref_caches = [tuple(z.clone() for z in kv) for kv in caches]
    stack = fused_decode.BlockDecodeStack(tr.blocks, caches, n_head=8)
    x = torch.randn(16, 1, 512, generator=g).to(dev)
    for pos in (5, 200):
        before = kernels.launches["block_decode_f32"]
        got = stack(x, pos)
        torch.cuda.synchronize()
        assert kernels.launches["block_decode_f32"] == before + 3
        want = x
        for blk, (kc, vc) in zip(tr.blocks, ref_caches):
            want, _, _ = fused_decode.fused_block_decode(want, blk, kc, vc,
                                                         pos, n_head=8)
        assert torch.equal(got, want)
    for kv, ref in zip(caches, ref_caches):
        assert all(torch.equal(z, r) for z, r in zip(kv, ref))


@pytest.mark.parametrize("fusion", ["attn", "attn8", "attn-bf16"])
def test_attn_paths_run_their_mlp_through_the_int8_gemm(dev, fusion):
    """'attn', 'attn8' and 'attn-bf16' launch the int8 GEMM twice a block
    (c_fc with GELU+q8, m_proj with the residual), and their logits are
    bit-equal to the same path with the MLP as the eager qdot chain."""
    from vq_vae_transformer_arc_welding_tpu_torch.models import (
        quantized as pq)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import (
        new_gelu)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        WeldingQualityPipeline)
    vq, tr = entry.build(n_blocks=2, seed=0, device=dev)
    windows = np.random.default_rng(0).standard_normal(
        (6, entry.N_CYCLES * 200, 2)).astype(np.float32)
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=entry.N_CYCLES,
                                  precision="int8")
    pipe.calibrate(windows[:2])
    fn = entry.make_pipeline_quantized(vq, tr, pipe.qparams,
                                       block_fusion=fusion)
    x = torch.from_numpy(windows).to(dev)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        out = fn(x)
        torch.cuda.synchronize()
        assert kernels.launches["int8_gemm"] == 2 * 2

        def eager(blk, h8, resid, clip_rows=None):
            assert clip_rows is None
            g = new_gelu(pq.qdot_prequantized(h8, blk["c_fc"]))
            return resid + pq.qdot(g, blk["m_proj"])

        real = pq._mlp_int8_gemm
        pq._mlp_int8_gemm = eager
        try:
            ref = fn(x)
        finally:
            pq._mlp_int8_gemm = real
    assert torch.equal(out, ref)


def test_decode_wrappers_reject_bad_operands(dev):
    blk = _decode_block(dev, 128, 2)
    x = torch.zeros(2, 1, 128, device=dev)
    flat = torch.zeros(2, 9, 128, device=dev)
    heads = torch.zeros(2, 2, 9, 64, device=dev)
    before = dict(kernels.launches)
    bad = [
        lambda: fused_decode.fused_block_decode(x, blk, flat, flat, 9,
                                                n_head=2),      # pos == T
        lambda: fused_decode.fused_block_decode(x, blk, flat, flat, -1,
                                                n_head=2),
        lambda: fused_decode.fused_block_decode(
            x, blk, flat, flat, torch.tensor(3, device=dev), n_head=2),
        lambda: fused_decode.fused_block_decode(x, blk, heads, heads, 0,
                                                n_head=2),      # layout
        lambda: fused_decode.fused_block_decode(x, blk, flat.bfloat16(),
                                                flat.bfloat16(), 0, n_head=2),
        lambda: fused_decode.fused_block_decode(x, blk, flat, flat, 0,
                                                n_head=3),      # 128 / 3 heads
        lambda: fused_decode.fused_block_decode(x.expand(2, 2, 128), blk,
                                                flat, flat, 0, n_head=2),
        lambda: fused_decode.fused_decode_attn(x, blk, flat, flat, 0,
                                               n_head=2),       # layout
        lambda: fused_decode.fused_decode_attn(x, blk, heads, heads.cpu(), 0,
                                               n_head=2),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert kernels.launches == before


# -- widths off the bench model's -------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed"])
@pytest.mark.parametrize("h,d,t", [(8, 24, 321), (2, 128, 70), (4, 32, 65),
                                   (4, 48, 45), (64, 3, 33), (2, 96, 130)])
def test_flash_attention_at_other_head_widths(dev, h, d, t, packed):
    """#9 on the tile of 32, 64 or 128 with the head zero-filled past
    its width, and on 128 at one block an SM: within #9's 2e-5 of the
    plain core, each row of d floats written and no other."""
    g = torch.Generator().manual_seed(d)
    if packed:
        qkv = (torch.randn(2, t, 3 * h * d, generator=g) * 2).to(dev)
        q, k, v = (attention.split_heads(z, h)
                   for z in qkv.split(h * d, dim=-1))
    else:
        q, k, v = ((torch.randn(2, h, t, d, generator=g) * 2).to(dev)
                   for _ in range(3))
    out = _launched("flash_attention_f32",
                    lambda: fused_attn.flash_causal_attention(q, k, v))
    ref = fused_attn.flash_causal_attention_reference(q, k, v)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 2e-5


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per entry, how many bf16 steps apart two bf16 tensors of one sign
    pattern are (their bit patterns as integers)."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def _bf16_qkv(b, h, d, t, packed, seed):
    """bf16 q, k, v on the card: contiguous, or the views of a packed
    (B, T, 3C) qkv."""
    g = torch.Generator().manual_seed(seed)
    if packed:
        qkv = (torch.randn(b, t, 3 * h * d, generator=g) * 2).to(
            "cuda", torch.bfloat16)
        return tuple(attention.split_heads(z, h)
                     for z in qkv.split(h * d, dim=-1))
    return tuple((torch.randn(b, h, t, d, generator=g) * 2).to(
        "cuda", torch.bfloat16) for _ in range(3))


@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed"])
@pytest.mark.parametrize("b,h,d,t", [(16, 8, 64, 321), (80, 8, 64, 321),
                                     (2, 8, 24, 321), (2, 8, 32, 321),
                                     (2, 2, 128, 321), (3, 2, 64, 45),
                                     (1, 3, 64, 65), (2, 64, 3, 33),
                                     (2, 4, 48, 130), (1, 1, 64, 1)])
def test_flash_attention_bf16_matches_plain(dev, b, h, d, t, packed):
    """#9 on bf16 q, k and v: the bf16 output equals the plain version's
    (the f32 core on the widened operands, rounded to bf16) except on at
    most 1e-3 of the entries. The two f32 results part by up to #9's
    2e-5 and round alike unless they straddle a rounding boundary: a
    differing entry is one bf16 step apart, or, near 0 where a bf16 step
    is finer than that, within the f32 tile's 2e-5."""
    q, k, v = _bf16_qkv(b, h, d, t, packed, seed=d + t)
    out = _launched("flash_attention_bf16",
                    lambda: fused_attn.flash_causal_attention(q, k, v))
    ref = fused_attn.flash_causal_attention_reference(q, k, v)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    ulps = _bf16_ulps(out, ref)
    err = (out.float() - ref.float()).abs()
    share = float((ulps > 0).float().mean())
    far = (ulps > 1) & (err > 2e-5)
    stats = (f"differing share {share:.2e}, max ulps {int(ulps.max())}, "
             f"max abs {float(err.max()):.3e}, beyond both bounds "
             f"{int(far.sum())}")
    print(f"flash bf16 {(b, h, d, t, packed)}: {stats}")
    assert not far.any(), stats
    assert share <= 1e-3, stats


def test_flash_attention_bf16_gradients_on_cuda(dev):
    """The backward of the bf16 kernel's autograd function is the plain
    version's recompute on the saved bf16 operands: the same gradients,
    in bf16, as differentiating the plain version."""
    def grads(fn):
        leaves = [t.detach().requires_grad_(True)
                  for t in _bf16_qkv(2, 2, 64, 70, False, seed=9)]
        (fn(*leaves).float() ** 2).sum().backward()
        return [z.grad for z in leaves]

    for got, want in zip(grads(fused_attn.flash_causal_attention),
                         grads(fused_attn.flash_causal_attention_reference)):
        assert got.dtype == torch.bfloat16
        assert (got.float() - want.float()).abs().max() <= 1e-2


def test_flash_bf16_wrapper_rejects_mixed_operands(dev):
    q = torch.zeros(2, 2, 9, 64, device=dev, dtype=torch.bfloat16)
    before = dict(kernels.launches)
    for call in (lambda: fused_attn.flash_causal_attention(q, q.float(), q),
                 lambda: fused_attn.flash_causal_attention(q.half(), q, q),
                 lambda: fused_attn.flash_causal_attention(
                     torch.zeros(2, 2, 9, 192, device=dev,
                                 dtype=torch.bfloat16), q, q)):
        with pytest.raises(ValueError):
            call()
    assert kernels.launches == before


def _assert_bf16_gate(out, ref, what):
    """The bf16 #9 gate of test_flash_attention_bf16_matches_plain."""
    assert out.dtype == ref.dtype == torch.bfloat16
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    ulps = _bf16_ulps(out, ref)
    err = (out.float() - ref.float()).abs()
    share = float((ulps > 0).float().mean())
    far = int(((ulps > 1) & (err > 2e-5)).sum())
    stats = (f"{what}: differing share {share:.2e}, max ulps "
             f"{int(ulps.max())}, max abs {float(err.max()):.3e}, beyond "
             f"both bounds {far}")
    print(stats)
    assert far == 0 and share <= 1e-3, stats


def test_flash_attention_bf16_large_scores(dev):
    """The bench model's activations times 8, as test_flash_attention_
    large_scores feeds the f32 kernel, in bf16 through the packed views:
    scores in the tens, where a score's rounding moves p the most."""
    from vq_vae_transformer_arc_welding_tpu_torch.models.transformer import (
        linear)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    _, tr = entry.build(n_blocks=1, seed=0, device=dev)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (16, 321))).to(dev)
    ids[:, 0] = 256
    blk = tr.blocks[0]
    with torch.inference_mode():
        h = layer_norm(tr.embed(ids), blk.ln_1.weight, blk.ln_1.bias)
        qkv = (linear(h, blk.attn.c_attn) * 8.0).to(torch.bfloat16)
        q, k, v = (attention.split_heads(z, 8) for z in qkv.split(512, -1))
        out = _launched("flash_attention_bf16",
                        lambda: fused_attn.flash_causal_attention(q, k, v))
        ref = fused_attn.flash_causal_attention_reference(q, k, v)
    _assert_bf16_gate(out, ref, "large scores")


@pytest.mark.parametrize("d", [24, 64, 128])
def test_flash_attention_bf16_tied_scores(dev, d):
    """Rows of equal scores: every key is one of four rows, so each row's
    max is taken by many keys at once (ties in the online max, across
    stages); and q = 0, where every score of a row is 0 and the output is
    the running mean of v. Held against the float64 core rounded to
    bf16, and, with the keys of four rows, against the plain version. At
    q = 0 the plain version, which divides p by the row sum before P V,
    parts from float64 on ~1.2e-3 of the entries, while the kernel's and
    the JAX kernel's order (the division after P V) lands within 2e-5
    of it (tests/test_torch_flash_bf16_split.py)."""
    g = torch.Generator().manual_seed(d)
    b, h, t = 2, 8 if d == 24 else 4, 321      # C a multiple of 64
    base = torch.randn(b, h, 4, d, generator=g) * 3
    k = base[:, :, torch.arange(t) % 4].to(dev, torch.bfloat16)
    v = (torch.randn(b, h, t, d, generator=g) * 2).to(dev, torch.bfloat16)
    q = (torch.randn(b, h, t, d, generator=g) * 3).to(dev, torch.bfloat16)
    for what, qq in (("keys of four rows", q),
                     ("q = 0", torch.zeros_like(q))):
        out = _launched("flash_attention_bf16",
                        lambda: fused_attn.flash_causal_attention(qq, k, v))
        exact = attention.causal_attention_core(
            qq.double(), k.double(), v.double()).to(torch.bfloat16)
        _assert_bf16_gate(out, exact, f"tied scores, {what}, d {d}, float64")
        if what != "q = 0":
            _assert_bf16_gate(
                out, fused_attn.flash_causal_attention_reference(qq, k, v),
                f"tied scores, {what}, d {d}")


@pytest.mark.parametrize("t", [63, 64, 65, 128, 129])
def test_flash_attention_bf16_tile_edges(dev, t):
    """T at the edges of the bf16 tile's 64-row blocks, 16-row warps and
    64-key stages, q, k, v read in place from a packed qkv."""
    for h, d in ((8, 64), (2, 128), (8, 24)):
        q, k, v = _bf16_qkv(2, h, d, t, True, seed=t + d)
        out = _launched("flash_attention_bf16",
                        lambda: fused_attn.flash_causal_attention(q, k, v))
        _assert_bf16_gate(
            out, fused_attn.flash_causal_attention_reference(q, k, v),
            f"T {t}, {h} heads of {d}")


def test_bf16_transformer_step_kernel_path_against_plain(dev):
    """A bf16 training step of an attention_impl='pallas' transformer:
    #9's bf16 kernel once a block, and the loss and the global gradient
    norm within chip_smoke.py's gates (1e-5, 1e-4 relative) of the same
    step with the plain version in the kernel's place."""
    from unittest import mock

    from vq_vae_transformer_arc_welding_tpu_torch.models import (
        TransformerDecoder)

    ids = torch.randint(0, 34, (4, 65),
                        generator=torch.Generator().manual_seed(1)).to(dev)

    def step(plain: bool):
        tr = TransformerDecoder(
            d_model=128, n_classes=34, seq_len=65, n_blocks=2, n_head=2,
            res_dropout=0.0, attention_impl="pallas",
            compute_dtype=torch.bfloat16, device=dev,
            generator=torch.Generator().manual_seed(0)).requires_grad_(True)
        before = kernels.launches["flash_attention_bf16"]
        with mock.patch.object(
                fused_attn, "flash_causal_attention",
                fused_attn.flash_causal_attention_reference if plain
                else fused_attn.flash_causal_attention):
            loss = tr.loss_gen(tr.apply(ids, train=True), ids)
            loss.backward()
        torch.cuda.synchronize()
        norm = torch.stack([p.grad.double().norm() for p in tr.parameters()
                            if p.grad is not None]).norm()
        return (float(loss), float(norm),
                kernels.launches["flash_attention_bf16"] - before)

    loss_k, norm_k, n_k = step(False)
    loss_p, norm_p, n_p = step(True)
    assert (n_k, n_p) == (2, 0)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    assert abs(norm_k - norm_p) <= 1e-4 * norm_p


def test_streaming_fit_equals_resident_fit_on_the_card(dev, tmp_path):
    """Trainer(streaming=True) on the card: each batch gathered natively
    from the memory map into pinned memory and copied without blocking;
    losses and weights bit-equal to the fit over the resident split."""
    from vq_vae_transformer_arc_welding_tpu_torch.data import (
        ArraySplit, sampling_weights, streaming)
    from vq_vae_transformer_arc_welding_tpu_torch.models import MLP
    from vq_vae_transformer_arc_welding_tpu_torch.train.loop import Trainer
    from vq_vae_transformer_arc_welding_tpu_torch.train.optim import (
        make_radam)
    from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
        ClassificationTask)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 50, 2)).astype(np.float32)
    y = rng.integers(0, 2, 96)
    path = streaming.MmapDataset.write(str(tmp_path / "train"), x, y)

    def fit(train, **kw):
        class DM:
            batch_size, drop_last = 16, True
            train_sampling = sampling_weights(y)
            val = test = ArraySplit(x[:32], y[:32])
        DM.train = train
        model = MLP(50, 2, 2, 32, 2, dropout_p=0.1, device=dev,
                    generator=torch.Generator().manual_seed(0))
        res = Trainer(max_epochs=2, verbose=False, **kw).fit(
            ClassificationTask(model), DM(), make_radam(1e-3))
        return model, [h["train_epoch/loss"] for h in res.history]

    resident, l_res = fit(ArraySplit(x, y))
    split = streaming.StreamingSplit(streaming.MmapDataset(path))
    streamed, l_str = fit(split, streaming=True)
    assert split.x.gathers["native"] > 0 == split.x.gathers["numpy"]
    assert l_res == l_str
    for (k, a), b in zip(resident.state_dict().items(),
                         streamed.state_dict().values()):
        assert torch.equal(a, b), k


ENCODER_WIDTHS = [64, 128, 192, 256, 320, 448]


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("c", ENCODER_WIDTHS)
def test_encoder_kernels_at_other_hidden_widths(dev, c, use_bn):
    """#1 (a group of two), #3 and #4 at hidden widths on the tiles of
    128, 256 and 512, the pack's split zero-padded to the tile: within
    1e-4 of the plain version's largest magnitude; #5's ids within 0.1%
    of plain's. 1000 rows: a ragged last tile."""
    w, v = (a.to(dev) for a in _encoder_operands(c, 2, use_bn, seed=c))
    w_pe, b_pe, w_sep, b_sep = (a.to(dev) for a in _edge_operands(c, 32))
    g = torch.Generator().manual_seed(c)
    x = torch.randn(1000, c, generator=g).to(dev)
    patches = torch.randn(1000, 25, generator=g).to(dev)
    split = fenc.split_weights(w)
    w_ = fenc.kernel_width(c)
    assert split.shape == (4, 2 * w_ * w_)
    for name, kfn, pfn, args, kw in (
            ("encoder_chain_f32", fenc.fused_encoder_eval,
             fenc.fused_encoder_eval_reference, (x, w, v), {"split": split}),
            ("resblock_f32", fenc.resblock_eval,
             fenc.fused_resblock_eval_reference, (x, w[0], w[1], v[:10]),
             {"split": split[:2]}),
            ("encoder_entry_f32", fenc.fused_encoder_entry_eval,
             fenc.fused_encoder_entry_eval_reference,
             (patches, w_pe, b_pe, w, v), {"split": split})):
        out = _launched(name, lambda: kfn(*args, use_bn=use_bn, **kw))
        ref = pfn(*args, use_bn=use_bn)
        assert torch.isfinite(out).all(), name
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max(), name
    z = fenc.fused_encoder_eval_reference(x, w, v, use_bn=use_bn) @ w_sep \
        + b_sep
    cb = z.mean(0) + torch.randn(256, 32, generator=g).to(dev) * z.std(0)
    ids = _launched("encoder_exit_f32", lambda: fenc.fused_encoder_exit_eval(
        x, w, v, w_sep, b_sep, cb, use_bn=use_bn, split=split))
    ref = fenc.fused_encoder_exit_eval_reference(x, w, v, w_sep, b_sep, cb,
                                                 use_bn=use_bn)
    assert (ids != ref).float().mean() <= 1e-3


@pytest.mark.parametrize("hidden", [64, 256])
def test_other_hidden_width_encoder_paths(dev, hidden):
    """The encoder paths of a hidden-64 (the quality study's, 2
    resblocks, K=32, D=8) and a hidden-256 VQ-VAE on their kernels: ids
    within 0.1% of vq.encode_indices."""
    kw = (dict(hidden=64, n_res=2, k=32, d=8) if hidden == 64
          else dict(hidden=256))
    vq, _ = entry.build(d_model=64, n_heads=1, n_blocks=1, seed=0,
                        device=dev, **kw)
    packed, edges = fenc.pack_encoder(vq), fenc.pack_encoder_edges(vq)
    cycles = torch.randn(80, 200, 2, generator=torch.Generator()
                         .manual_seed(hidden)).to(dev)
    g = 1 if hidden == 64 else 2
    with torch.inference_mode():
        exact = vq.encode_indices(cycles)
        for name, run in (
                ("encoder_chain_f32",
                 lambda: fenc.encode_indices_fused(vq, packed, cycles)),
                ("resblock_f32",
                 lambda: fenc.encode_indices_fused(vq, packed, cycles,
                                                   group_size=1)),
                ("encoder_exit_f32",
                 lambda: fenc.encode_indices_fused_edges(
                     vq, packed, edges, cycles, group_size=g))):
            kernels.reset_launch_counts()
            ids = run()
            torch.cuda.synchronize()
            assert kernels.launches[name] >= 1, name
            assert (ids != exact).float().mean() <= 1e-3, name


@pytest.mark.parametrize("fusion", ["attn", "full", "attn8", "full8"])
def test_d192_model_runs_on_the_kernels(dev, fusion):
    """The quality study's transformer (d192, 8 heads of 24) and VQ-VAE
    (hidden 64) through make_pipeline_quantized on their kernels: labels
    equal the plain path's where its logit margin exceeds 1e-3 (the
    bench model's gate in chip_smoke.py)."""
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        WeldingQualityPipeline)
    vq, tr = entry.build(d_model=192, n_blocks=2, n_heads=8, hidden=64,
                         n_res=2, k=32, d=8, seed=0, device=dev)
    windows = np.random.default_rng(0).standard_normal(
        (6, entry.N_CYCLES * 200, 2)).astype(np.float32)
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=entry.N_CYCLES,
                                  precision="int8", encoder_impl="fused")
    pipe.calibrate(windows[:2])
    fn = entry.make_pipeline_quantized(vq, tr, pipe.qparams,
                                       block_fusion=fusion)
    x = torch.from_numpy(windows).to(dev)
    kernel = {"attn": "attn_block_quant", "full": "block_quant",
              "attn8": "attn_block_quant_int8attn",
              "full8": "block_quant_int8attn"}[fusion]
    with torch.inference_mode():
        kernels.reset_launch_counts()
        out = fn(x)
        torch.cuda.synchronize()
        assert kernels.launches[kernel] == 2
        assert kernels.launches["encoder_chain_f32"] == 1
        real = (fbq.attn_block_quant, fbq.block_quant, int8_gemm.int8_gemm,
                fenc.fused_encoder_eval)
        fbq.attn_block_quant = fbq.fused_attn_block_quant_reference
        fbq.block_quant = fbq.fused_block_quant_reference
        int8_gemm.int8_gemm = int8_gemm.int8_gemm_reference
        fenc.fused_encoder_eval = (lambda *a, split=None, **k:
                                   fenc.fused_encoder_eval_reference(*a, **k))
        try:
            ref = fn(x)
        finally:
            (fbq.attn_block_quant, fbq.block_quant, int8_gemm.int8_gemm,
             fenc.fused_encoder_eval) = real
    sure = (ref[:, 0] - ref[:, 1]).abs() > 1e-3
    assert torch.isfinite(out).all()
    assert torch.equal(out.argmax(-1)[sure], ref.argmax(-1)[sure])


# -- every VQ-VAE the VQ-VAE CLI can build: any hidden width up to 4,096,
# any codebook with D up to 256 (csrc/encoder_tc.cuh at widths 1 to 512,
# csrc/encoder_wide.cu above, csrc/code_scan.cuh, csrc/nearest_codes.cu)

# hidden widths off the multiples of 64 (on the tiles of 128, 256 and
# 512, rows moved a float at a time where C % 4 != 0) and above 512
# (encoder_wide.cu); 1,000 rows, 320 at 4,096
ANY_WIDTHS = [1, 3, 100, 130, 258, 500, 576, 640, 758, 768, 1024, 4096]


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("c", ANY_WIDTHS)
def test_encoder_kernels_at_any_hidden_width(dev, c, use_bn):
    """#1 (a group of two), #3, #4 and #5 at any hidden width: the
    residual stream within 1e-4 of the plain version's largest
    magnitude, #5's ids within 0.1% of plain's; the kernel each width
    runs on counted (the tile up to 512, encoder_wide.cu above)."""
    n = 320 if c > 1024 else 1000
    w, v = (a.to(dev) for a in _encoder_operands(c, 2, use_bn, seed=c))
    w_pe, b_pe, w_sep, b_sep = (a.to(dev) for a in _edge_operands(c, 32))
    g = torch.Generator().manual_seed(c)
    x = torch.randn(n, c, generator=g).to(dev)
    patches = torch.randn(n, 25, generator=g).to(dev)
    tile = fenc.on_tile(c)
    names = (("encoder_chain_f32", "resblock_f32", "encoder_entry_f32",
              "encoder_exit_f32") if tile else
             ("encoder_wide_f32", "encoder_wide_f32",
              "encoder_wide_entry_f32", "encoder_wide_exit_f32"))
    split = fenc.split_weights(w) if tile else None
    kw = {"split": split} if tile else {}
    for name, kfn, pfn, args, kwa in (
            (names[0], fenc.fused_encoder_eval,
             fenc.fused_encoder_eval_reference, (x, w, v), kw),
            (names[1], fenc.resblock_eval,
             fenc.fused_resblock_eval_reference, (x, w[0], w[1], v[:10]),
             {"split": split[:2]} if tile else {}),
            (names[2], fenc.fused_encoder_entry_eval,
             fenc.fused_encoder_entry_eval_reference,
             (patches, w_pe, b_pe, w, v), kw)):
        out = _launched(name, lambda: kfn(*args, use_bn=use_bn, **kwa))
        ref = pfn(*args, use_bn=use_bn)
        assert out.shape == ref.shape and torch.isfinite(out).all(), name
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max(), name
    z = fenc.fused_encoder_eval_reference(x, w, v, use_bn=use_bn) @ w_sep \
        + b_sep
    cb = z.mean(0) + torch.randn(256, 32, generator=g).to(dev) * z.std(0)
    ids = _launched(names[3], lambda: fenc.fused_encoder_exit_eval(
        x, w, v, w_sep, b_sep, cb, use_bn=use_bn, **kw))
    ref = fenc.fused_encoder_exit_eval_reference(x, w, v, w_sep, b_sep, cb,
                                                 use_bn=use_bn)
    assert (ids != ref).float().mean() <= 1e-3


# (K, D): the VQ-VAE CLI's --num-embeddings 1024 at D 64, codebooks past
# the old shared-memory limits, D off the padded widths, the one-code
# book and the first K past the old limit at D = 64
ANY_CODEBOOKS = [(1024, 64), (4096, 32), (512, 128), (256, 48), (300, 256),
                 (1, 8), (895, 64), (2000, 200), (5, 3)]


def _tied_codebook(z, k, d, g, dev):
    """A codebook at the spread of z with row 5's z planted at codes
    k // 2 + 1 and k - 1 (a later chunk) and at 0 where k > 2: the first
    index among the equal minima is the one the ids must hold."""
    cb = z.mean(0) + torch.randn(k, d, generator=g).to(dev) * z.std(0)
    first = None
    for i in sorted({k // 2 + 1, k - 1} if k > 2 else set()):
        cb[i] = z[5]
        first = i if first is None else first
    return cb, first


@pytest.mark.parametrize("k,d", ANY_CODEBOOKS)
def test_nearest_codes_kernel_any_codebook(dev, k, d):
    """#7 at any (K, D), D up to 256: the codebook resident where it fits
    and streamed in chunks where it does not; ids within 0.1% of plain's,
    and where row 5's z sits at two codes in different chunks, the first
    of them."""
    g = torch.Generator().manual_seed(k + d)
    z = torch.randn(3000, d, generator=g).to(dev)
    cb, first = _tied_codebook(z, k, d, g, dev)
    ids = _launched("nearest_codes_f32",
                    lambda: fvq.nearest_codes_pallas(z, cb))
    ref = fvq.nearest_codes_pallas_reference(z, cb)
    assert ids.dtype == torch.int32 and ids.shape == (3000,)
    assert (ids != ref).float().mean() <= 1e-3
    if first is not None:
        assert int(ids[5]) == first


@pytest.mark.parametrize("c", [512, 1024])
@pytest.mark.parametrize("k,d", ANY_CODEBOOKS)
def test_exit_kernel_any_codebook(dev, k, d, c):
    """#5 at any (K, D), on the tile (512) and on encoder_wide.cu (1024):
    the codebook streamed through shared memory in chunks; ids within
    0.1% of plain's, the first of two equal codes in different chunks."""
    w, v = (a.to(dev) for a in _encoder_operands(c, 1, False))
    _, _, w_sep, b_sep = (a.to(dev) for a in _edge_operands(c, d))
    g = torch.Generator().manual_seed(k + d)
    x = torch.randn(700, c, generator=g).to(dev)
    z = fenc.fused_encoder_eval_reference(x, w, v, use_bn=False) @ w_sep \
        + b_sep
    cb, first = _tied_codebook(z, k, d, g, dev)
    name = "encoder_exit_f32" if fenc.on_tile(c) else "encoder_wide_exit_f32"
    ids = _launched(name, lambda: fenc.fused_encoder_exit_eval(
        x, w, v, w_sep, b_sep, cb, use_bn=False))
    ref = fenc.fused_encoder_exit_eval_reference(x, w, v, w_sep, b_sep, cb,
                                                 use_bn=False)
    assert (ids != ref).float().mean() <= 1e-3
    if first is not None:
        assert int(ids[5]) == first


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("c", [64, 100, 256, 576, 1024])
def test_bf16_encoder_kernel_at_other_widths(dev, c, use_bn):
    """1b off hidden 512 (encoder_wide_bf16): each resblock within 1e-3
    of the plain bf16 version's largest magnitude, fed the same x, and
    the bf16 rounding really there (the f32 chain further away)."""
    w, v = (a.to(dev) for a in _encoder_operands(c, 2, use_bn, seed=c))
    x = torch.randn(1000, c, generator=torch.Generator().manual_seed(c))
    x = x.to(dev)
    wb = w.bfloat16()
    for i in range(2):
        wi, vi = wb[2 * i:2 * i + 2], v[10 * i:10 * i + 10]
        out = _launched("encoder_wide_bf16", lambda: fenc.fused_encoder_eval(
            x, wi, vi, use_bn=use_bn, compute_dtype=torch.bfloat16))
        ref = fenc.fused_encoder_eval_reference(
            x, wi, vi, use_bn=use_bn, compute_dtype=torch.bfloat16)
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-3 * ref.abs().max()
        f32 = fenc.fused_encoder_eval_reference(x, w[2 * i:2 * i + 2], vi,
                                                use_bn=use_bn)
        assert (out - ref).abs().max() < (out - f32).abs().max()
        x = ref


def test_hidden_1024_vqvae_paths(dev):
    """The VQ-VAE CLI's --hidden-dim 1024 --num-embeddings 1024
    --embedding-dim 64 model (8 resblocks, patch 25) through the encoder
    paths on encoder_wide.cu (JAX's group rule: one resblock a call) and
    a vq_impl='pallas' encode on #7's streamed codebook: ids within 0.1%
    of vq.encode_indices."""
    vq, _ = entry.build(hidden=1024, k=1024, d=64, d_model=64, n_heads=1,
                        n_blocks=1, seed=0, device=dev)
    packed, edges = fenc.pack_encoder(vq), fenc.pack_encoder_edges(vq)
    assert packed.split is None and fenc.group_size_for(1024) == 1
    cycles = torch.randn(20, 200, 2, generator=torch.Generator()
                         .manual_seed(11)).to(dev)
    with torch.inference_mode():
        exact = vq.encode_indices(cycles)
        for want, run in (
                ({"encoder_wide_f32": 8},
                 lambda: fenc.encode_indices_fused(vq, packed, cycles)),
                ({"encoder_wide_entry_f32": 1, "encoder_wide_f32": 6,
                  "encoder_wide_exit_f32": 1},
                 lambda: fenc.encode_indices_fused_edges(vq, packed, edges,
                                                         cycles)),
                ({"encoder_wide_bf16": 4},
                 lambda: fenc.encode_indices_fused(
                     vq, fenc.pack_encoder(vq, torch.bfloat16), cycles,
                     compute_dtype=torch.bfloat16))):
            kernels.reset_launch_counts()
            ids = run()
            torch.cuda.synchronize()
            assert {n: c for n, c in kernels.launches.items() if c} == want
            if "encoder_wide_bf16" not in want:
                assert (ids != exact).float().mean() <= 1e-3
        vq.vq_impl = "pallas"
        kernels.reset_launch_counts()
        ids = vq.encode_indices(cycles)
        torch.cuda.synchronize()
        assert kernels.launches["nearest_codes_f32"] == 1
        assert (ids != exact).float().mean() <= 1e-3


# -- every transformer the transformer CLI can build: d_model 1 to 4,096
# in any number of heads (the int8 GEMM's GENERAL form, LN+q8's runtime
# width, the f32 attention's wide tile; int8 rows pitch16 bytes apart)

# (B, T, C, n_head): C off 16 and 64 (heads of 25, 3, 1), C above 1,024
# (heads of 275, 200, 300), heads past 128 (192, 256, 4,096)
ANY_SHAPES = [(2, 33, 100, 4), (2, 33, 1100, 4), (2, 33, 192, 1),
              (2, 65, 6, 2), (1, 33, 1, 1), (2, 70, 1600, 8),
              (1, 40, 1800, 6), (1, 33, 2048, 8), (2, 45, 512, 2),
              (1, 33, 4096, 1), (3, 45, 200, 8), (2, 130, 1600, 25)]
ANY_KERNELS = ["attn_block_quant", "block_quant", "mlp_quant",
               "qkv_attention_quant", "causal_attention_quant"]


@pytest.mark.parametrize("kernel", ANY_KERNELS)
@pytest.mark.parametrize("b,t,c,n_head", ANY_SHAPES)
def test_any_width_int8_kernels_match_plain(dev, b, t, c, n_head, kernel):
    """#2, #6, #8, #10 and #11 at widths the kernels once refused,
    against their plain versions within the int8 contract (int8 outputs
    one step on at most 0.1% of the entries, f32 ones 1e-3). #6 is held
    stage by stage, each stage fed the kernel's own input: one h8 step
    (an ulp of LayerNorm) moves ~10% of a row's g8 entries and its
    output by ~0.07."""
    g = torch.Generator().manual_seed(c + n_head)
    x = torch.randn(b, t, c, generator=g).to(dev)
    w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c = (
        a.to(dev).contiguous() for a in _block_operands(c, full=True))
    if kernel == "attn_block_quant":
        args = (x, w_qkv, w_proj, scales, vc[:6], v3c)
        xm, h8 = _launched(kernel, lambda: fbq.attn_block_quant(
            *args, n_head=n_head))
        xm_ref, h8_ref = fbq.fused_attn_block_quant_reference(
            *args, n_head=n_head)
        _int8_close(h8, h8_ref)
        assert (xm - xm_ref).abs().max() <= 1e-3
    elif kernel == "block_quant":
        args = (x, w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c)
        sc = {}
        out = _launched(kernel, lambda: fbq.block_quant(
            *args, n_head=n_head, scratch=sc))
        xm_ref, h8_ref = fbq.fused_attn_block_quant_reference(
            x, w_qkv, w_proj, scales, vc[:6], v3c, n_head=n_head)
        _int8_close(sc["h8"], h8_ref)
        assert (sc["x_mid"] - xm_ref).abs().max() <= 1e-3
        g8_ref = fmlp.fc_gelu_q8_reference(sc["h8"], w_fc, v4c, scales[3])
        _int8_close(sc["g8"], g8_ref)
        ref = sc["x_mid"] + (int8.int8_matmul(sc["g8"], w_mp).float()
                             * vc[6] + vc[7])
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-3
    elif kernel == "mlp_quant":
        args = (x, w_fc, w_mp, scales[2:], v4c, vc[6:])
        out = _launched(kernel, lambda: fmlp.mlp_quant(*args))
        assert (out - fmlp.mlp_quant_reference(*args)).abs().max() <= 1e-3
    elif kernel == "qkv_attention_quant":
        args = (x, w_qkv, scales[:2], v3c)
        y8 = _launched(kernel, lambda: fattn.qkv_attention_quant(
            *args, n_head=n_head))
        _int8_close(y8, fattn.qkv_attention_quant_reference(
            *args, n_head=n_head))
    else:
        qkv = (torch.randn(b, t, 3 * c, generator=g) * 2).to(dev)
        y_scale = torch.tensor(200.0, device=dev)
        y8 = _launched(kernel, lambda: fattn.fused_causal_attention_quant(
            qkv, y_scale, n_head=n_head))
        _int8_close(y8, fattn.causal_attention_quant_reference(
            qkv, y_scale, n_head=n_head))


@pytest.mark.parametrize("c", [128, 512, 1024])
def test_general_forms_give_the_template_bits(dev, c):
    """#2 on an x one float off 16-byte alignment takes LN+q8's runtime
    width kernel and the GEMM's GENERAL form (c_proj's residual and
    output rows misaligned) where an aligned x takes the templates: h8a,
    qkv, x_mid and h8 are bit for bit the same."""
    x = torch.randn(2, 45, c, generator=torch.Generator().manual_seed(c))
    w_qkv, w_proj, scales, vc, v3c = (a.to(dev).contiguous()
                                      for a in _block_operands(c))
    x = x.to(dev)
    shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    got = []
    for xi in (x, shifted):
        sc = {}
        xm, h8 = _launched("attn_block_quant", lambda: fbq.attn_block_quant(
            xi, w_qkv, w_proj, scales, vc, v3c, n_head=c // 64,
            scratch=sc))
        got.append((sc["h8a"], sc["qkv"], xm, h8))
    for a, b in zip(*got):
        assert torch.equal(a, b)


# (B, heads, head width, T) of the wide tiles: every cluster size (2 for
# 130-256, 4 for 300 and 512, 8 from 640: one cluster with empty chunk
# segments in bf16, 1,100 in two, 4,096 in four, the f32 tile's Q
# streamed past 8 pieces), and the slice's path at batch 80 (8 heads of
# 256)
WIDE_GRID = [(2, 2, 192, 70), (2, 1, 256, 321), (2, 3, 130, 129),
             (2, 1, 300, 45), (2, 2, 512, 65), (2, 1, 640, 100),
             (2, 1, 1100, 70), (2, 1, 4096, 33), (80, 8, 256, 321)]


@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed"])
@pytest.mark.parametrize("b,h,d,t", WIDE_GRID)
def test_flash_attention_wide_heads_match_plain(dev, b, h, d, t, packed):
    """#9 at heads past 128 on the wide tile, launched in clusters of
    `kernels.wide_cluster(d)` (the library's read-back): within #9's
    2e-5 of the plain core."""
    g = torch.Generator().manual_seed(d + t)
    if packed:
        qkv = (torch.randn(b, t, 3 * h * d, generator=g) * 2).to(dev)
        q, k, v = (attention.split_heads(z, h)
                   for z in qkv.split(h * d, dim=-1))
    else:
        q, k, v = ((torch.randn(b, h, t, d, generator=g) * 2).to(dev)
                   for _ in range(3))
    out = _launched("flash_attention_f32",
                    lambda: fused_attn.flash_causal_attention(q, k, v))
    assert kernels.last_cluster("flash_attention_f32") == \
        kernels.wide_cluster(d)
    ref = fused_attn.flash_causal_attention_reference(q, k, v)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 2e-5


@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed"])
@pytest.mark.parametrize("b,h,d,t", WIDE_GRID)
def test_flash_attention_bf16_wide_heads_match_plain(dev, b, h, d, t,
                                                     packed):
    """#9 on bf16 q, k, v at the same grid, on the bf16 wide tile in
    clusters of `kernels.wide_cluster(d)`: the bf16 gate against the
    plain version (or the float64 attention where plain misses it)."""
    q, k, v = _bf16_qkv(b, h, d, t, packed, seed=d + t)
    out = _launched("flash_attention_bf16",
                    lambda: fused_attn.flash_causal_attention(q, k, v))
    assert kernels.last_cluster("flash_attention_bf16") == \
        kernels.wide_cluster(d)
    _assert_bf16_gate_wide(out, q, k, v, f"bf16 #9 at {(b, h, d, t)}")


@pytest.mark.parametrize("kernel", ["attn_block_quant",
                                    "causal_attention_quant"])
@pytest.mark.parametrize("b,h,d,t", WIDE_GRID)
def test_wide_attention_int8_kernels_match_plain(dev, b, h, d, t, kernel):
    """#2 and #11 at heads past 128, their f32 attention on the wide tile
    (csrc/int8_block.cu::attention_wide_kernel) in clusters of
    `kernels.wide_cluster(d)`: y8 within the int8 contract of the plain
    attention on the kernel's own qkv; #2 held stage by stage, each
    stage fed the kernel's own input (at T = 321 an h8a step, an ulp of
    LayerNorm, moves a score's argmax and with it a y8 row: a block-a-piece
    tile gave the same x_mid), qkv and x_mid within 1e-3, h8 within the
    contract; a narrow head's launch reads back 0."""
    c = h * d
    g = torch.Generator().manual_seed(c + t)
    if kernel == "attn_block_quant":
        x = torch.randn(b, t, c, generator=g).to(dev)
        w_qkv, w_proj, scales, vc, v3c = (a.to(dev).contiguous()
                                          for a in _block_operands(c))
        args = (x, w_qkv, w_proj, scales, vc, v3c)
        sc = {}
        xm, h8 = _launched(kernel, lambda: fbq.attn_block_quant(
            *args, n_head=h, scratch=sc))
        assert kernels.last_cluster(kernel) == kernels.wide_cluster(d)
        _int8_close(sc["h8a"], fbq.ln_q8_reference(x, vc[0], vc[1],
                                                   scales[0]))
        qkv = int8.int8_matmul(sc["h8a"], w_qkv).float() * v3c[0] + v3c[1]
        assert (sc["qkv"] - qkv).abs().max() <= 1e-3
        _int8_close(sc["y8"], fattn.causal_attention_quant_reference(
            sc["qkv"], scales[1], n_head=h))
        xm_ref = x + (int8.int8_matmul(sc["y8"], w_proj).float() * vc[4]
                      + vc[5])
        assert (xm - xm_ref).abs().max() <= 1e-3
        _int8_close(h8, fbq.ln_q8_reference(xm, vc[2], vc[3], scales[2]))
    else:
        qkv = (torch.randn(b, t, 3 * c, generator=g) * 2).to(dev)
        y_scale = torch.tensor(30.0, device=dev)
        y8 = _launched(kernel, lambda: fattn.fused_causal_attention_quant(
            qkv, y_scale, n_head=h))
        assert kernels.last_cluster(kernel) == kernels.wide_cluster(d)
        _int8_close(y8, fattn.causal_attention_quant_reference(
            qkv, y_scale, n_head=h))
        narrow = qkv[..., :3 * 64 * h].contiguous()
        _launched(kernel, lambda: fattn.fused_causal_attention_quant(
            narrow, y_scale, n_head=h))
        assert kernels.last_cluster(kernel) == 0


# every transformer width the CLI can build: heads of 25, one head of 192,
# heads of 275 (C above 1,024, no multiple of 64), 300, GPT-2 XL's 25
# heads of 64, heads of 256 and one head of 4,096
NEW_WIDTHS = [(200, 8), (192, 1), (1100, 4), (1800, 6), (1600, 25),
              (2048, 8), (4096, 1)]


@pytest.mark.parametrize("c,n_head", NEW_WIDTHS)
def test_int8_attention_at_every_width(dev, c, n_head):
    """The int8 attention ('attn8', 'full8') at widths once refused, held
    stage by stage on #2 with int8_attn: the quantizing pass bit-equal
    (qkv8 and the scales, a head past 128 in rows of a multiple of 32),
    y8 within the int8 contract of the plain int8 attention on the
    kernel's own qkv, x_mid within 1e-3 and h8 within the contract; then
    #6 with int8_attn stage by stage as test_any_width_int8_kernels_
    match_plain holds it (one h8 step moves a row's g8 and output)."""
    t = 45
    x = torch.randn(2, t, c, generator=torch.Generator().manual_seed(c))
    w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c = _block_operands(
        c, full=True)
    scales[1] = 127.0 / 4.0
    v3c[0] = 4e-5 * (512 / c) ** 0.5      # q, k, v of order 2
    args = [a.to(dev).contiguous()
            for a in (x, w_qkv, w_proj, scales, vc[:6], v3c)]
    sc = {}
    xm, h8 = _launched("attn_block_quant_int8attn",
                       lambda: fbq.attn_block_quant(
                           *args, n_head=n_head, int8_attn=True, scratch=sc))
    qkv8, head_scales = fbq.quantize_heads_reference(sc["qkv"], n_head)
    assert torch.equal(sc["head_scales"], head_scales)
    assert torch.equal(sc["qkv8"], qkv8)
    _int8_close(sc["y8"], int8.quantize_act(fattn.attention_core_reference(
        sc["qkv"], n_head, int8_attn=True), args[3][1]))
    xm_ref, h8_ref = fbq.fused_attn_block_quant_reference(
        *args, n_head=n_head, int8_attn=True)
    assert (xm - xm_ref).abs().max() <= 1e-3
    _int8_close(h8, h8_ref)
    full = [a.to(dev).contiguous() for a in (x, w_qkv, w_proj, w_fc, w_mp,
                                             scales, vc, v3c, v4c)]
    sc = {}
    out = _launched("block_quant_int8attn", lambda: fbq.block_quant(
        *full, n_head=n_head, int8_attn=True, scratch=sc))
    assert (sc["x_mid"] - xm_ref).abs().max() <= 1e-3
    _int8_close(sc["h8"], h8_ref)
    _int8_close(sc["g8"], fmlp.fc_gelu_q8_reference(
        sc["h8"], full[3], full[8], full[5][3]))
    ref = sc["x_mid"] + (int8.int8_matmul(sc["g8"], full[4]).float()
                         * full[6][6] + full[6][7])
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-3


def _bf16_gate_stats(out, ref):
    """(share of entries that differ, entries beyond one bf16 step and
    2e-5) of two bf16 tensors: the bf16 #9 gate's two numbers."""
    ulps = _bf16_ulps(out, ref)
    err = (out.float() - ref.float()).abs()
    return (float((ulps > 0).float().mean()),
            int(((ulps > 1) & (err > 2e-5)).sum()))


def _assert_bf16_gate_wide(out, q, k, v, what):
    """The bf16 #9 gate against the plain version, or, where the plain
    version's own f32 sums miss that gate against the float64 attention
    (a head of 4,096: 1.35e-3 of its entries on an H100), against the
    float64 attention: the kernel must then pass the gate there."""
    ref = fused_attn.flash_causal_attention_reference(q, k, v)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    share, far = _bf16_gate_stats(out, ref)
    print(f"{what}: against plain, differing share {share:.2e}, beyond "
          f"both bounds {far}")
    if far == 0 and share <= 1e-3:
        return
    exact = attention.causal_attention_core(
        q.double(), k.double(), v.double()).to(torch.bfloat16)
    plain = _bf16_gate_stats(ref, exact)
    kernel = _bf16_gate_stats(out, exact)
    print(f"{what}: against float64, plain {plain}, kernel {kernel}")
    assert plain[1] > 0 or plain[0] > 1e-3, (share, far, plain)
    assert kernel[1] == 0 and kernel[0] <= 1e-3, (kernel, plain)


@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed"])
@pytest.mark.parametrize("c,n_head", NEW_WIDTHS)
def test_flash_attention_bf16_at_every_width(dev, c, n_head, packed):
    """#9 on bf16 q, k and v at widths once refused (a head past 128 on
    the bf16 tile's wide form): the bf16 gate against the plain version,
    or against the float64 attention where the plain version misses it
    there (a head of 4,096)."""
    d = c // n_head
    q, k, v = _bf16_qkv(2, n_head, d, 70, packed, seed=c)
    out = _launched("flash_attention_bf16",
                    lambda: fused_attn.flash_causal_attention(q, k, v))
    _assert_bf16_gate_wide(out, q, k, v, f"bf16 #9 at {(c, n_head, packed)}")


@pytest.mark.parametrize("c,n_head", NEW_WIDTHS)
def test_decode_kernels_at_every_width(dev, c, n_head):
    """#13 and #12 at widths once refused, on the general form: C off the
    multiples of 64 (the products' depths zero-padded), above 1,024
    (LayerNorm in two passes from L2, more than 32 columns of a product a
    block, several k pieces) and heads past 128 (the keys over warps and,
    where the items are fewer than half the grid, key ranges over
    blocks), at T = 321 with pos 0, 255, 256 and 320, so that the ranges'
    edges move: the residual stream within 1e-4 of the plain version, the
    written cache row within 2e-5, every other row bit-equal."""
    blk = _decode_block(dev, c, n_head)
    b, t, hd = 16, 321, c // n_head
    g = torch.Generator().manual_seed(c + 1)
    x = torch.randn(b, 1, c, generator=g).to(dev)
    for fn, shape in (("fused_block_decode", (b, t, c)),
                      ("fused_decode_attn", (b, n_head, t, hd))):
        kc = torch.randn(*shape, generator=g).to(dev)
        vc = torch.randn(*shape, generator=g).to(dev)
        name = ("block_decode_f32" if fn == "fused_block_decode"
                else "decode_attn_f32")
        for pos in (0, 255, 256, t - 1):
            k0, v0 = kc.clone(), vc.clone()
            kr, vr = kc.clone(), vc.clone()
            out, _, _ = _launched(name, lambda: getattr(fused_decode, fn)(
                x, blk, kc, vc, pos, n_head=n_head))
            ref, _, _ = getattr(fused_decode, fn + "_reference")(
                x, blk, kr, vr, pos, n_head=n_head)
            assert out.shape == (b, 1, c) and torch.isfinite(out).all()
            assert (out - ref).abs().max() <= 1e-4, (fn, pos)
            at = (slice(None), pos) if len(shape) == 3 else (
                slice(None), slice(None), pos)
            rest = torch.arange(t, device=dev) != pos
            keep = (slice(None), rest) if len(shape) == 3 else (
                slice(None), slice(None), rest)
            for got, want, before in ((kc, kr, k0), (vc, vr, v0)):
                assert (got[at] - want[at]).abs().max() <= 2e-5
                assert torch.equal(got[keep], before[keep])


@pytest.mark.parametrize("c,n_head", [(200, 8), (1100, 4), (1800, 6)])
def test_block_decode_stack_at_padded_widths(dev, c, n_head):
    """BlockDecodeStack pads the weights once and a token's stream each
    call where C is no multiple of 64: one launch a block, the stream
    within 1e-4 of the plain stack over two blocks and three tokens."""
    blocks = [_decode_block(dev, c, n_head, seed=s) for s in (0, 1)]
    b, t = 4, 12
    g = torch.Generator().manual_seed(c)
    caches = [tuple(torch.randn(b, t, c, generator=g).to(dev)
                    for _ in range(2)) for _ in blocks]
    ref_caches = [tuple(z.clone() for z in kv) for kv in caches]
    stack = fused_decode.BlockDecodeStack(blocks, caches, n_head=n_head)
    run = fused_decode.block_decode_stack_reference(blocks, ref_caches,
                                                    n_head=n_head)
    for pos in (0, 5, t - 1):
        x = torch.randn(b, 1, c, generator=g).to(dev)
        before = kernels.launches["block_decode_f32"]
        out = stack(x, pos)
        torch.cuda.synchronize()
        assert kernels.launches["block_decode_f32"] == before + len(blocks)
        assert (out - run(x, pos)).abs().max() <= 1e-4


@pytest.mark.parametrize("c,n_head", [(1800, 6), (4096, 1)])
@pytest.mark.parametrize("fn", ["fused_block_decode", "fused_decode_attn"])
def test_general_form_gives_the_same_bits_twice(dev, c, n_head, fn):
    """The general form's sums run in a fixed order, the wide attention's
    key ranges merged by whichever block ends last in the ranges' order,
    and no float atomic: two calls give bit-equal outputs and cache
    rows (16 streams, pos 300: 8 key ranges at one head of 4,096)."""
    blk = _decode_block(dev, c, n_head)
    x, kc, vc = _decode_operands(
        dev, c=c, n_head=n_head,
        layout="flat" if fn == "fused_block_decode" else "heads")
    k2, v2 = kc.clone(), vc.clone()
    out1, _, _ = getattr(fused_decode, fn)(x, blk, kc, vc, 300,
                                           n_head=n_head)
    out2, _, _ = getattr(fused_decode, fn)(x, blk, k2, v2, 300,
                                           n_head=n_head)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)


def test_general_form_counts_back_at_zero_after_a_thousand_calls(dev):
    """1,000 launches of #13's general form at C 1,800 in heads of 300
    (m_proj split in two ranges of pieces; at batch 2 the 12 items'
    keys in up to 11 ranges) through BlockDecodeStack, every position of
    a 321-row cache three times over: the grid barrier's arrival count
    and every merge count are 0 after them, and the last output equals
    a fresh call's."""
    blk = _decode_block(dev, 1800, 6)
    x, kc, vc = _decode_operands(dev, b=2, c=1800, n_head=6)
    stack = fused_decode.BlockDecodeStack([blk], [(kc, vc)], n_head=6)
    before = kernels.launches["block_decode_f32"]
    for i in range(1000):
        out = stack(x, i % 321)
    torch.cuda.synchronize()
    assert kernels.launches["block_decode_f32"] == before + 1000
    out = out.clone()
    again, _, _ = fused_decode.fused_block_decode(x, blk, kc, vc, 999 % 321,
                                                  n_head=6)
    assert torch.equal(out, again)
    # the kernels' words on the caches' device (cuda:0: `dev` is "cuda",
    # another key of _barrier's cache)
    words = fused_decode._barrier(kc.device)
    assert int(words[0]) == 0 and not words[2:].any()


@pytest.mark.parametrize("c,n_head", [(200, 8), (1800, 6), (2048, 8),
                                      (4096, 1)])
def test_general_form_reads_rows_and_packed_weights_alike(dev, c, n_head):
    """The general form reads the weights in rows (the per-call wrappers:
    the block's own tensors where C is a multiple of 64) or packed
    (BlockDecodeStack, as csrc/decode.cu's decode_general_form asks):
    the same sums, so bit-equal outputs and cache rows, #13 and #12; and
    the form the card reports is the one csrc/decode.cu::first_form
    gives on its SMs."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for mlp in (True, False):
        c4 = 4 * c if mlp else 0
        first = (c % 64 == 0 and c // n_head <= 128
                 and all(-(-n // sms) <= fused_decode.MAX_COLS
                         for n in ((3 * c, c, c4, c) if mlp else (3 * c, c))))
        assert fused_decode._general(c, c4, n_head, mlp, dev) == (not first)
    blk = _decode_block(dev, c, n_head)
    x, kc, vc = _decode_operands(dev, c=c, n_head=n_head)
    k2, v2 = kc.clone(), vc.clone()
    stack = fused_decode.BlockDecodeStack([blk], [(kc, vc)], n_head=n_head)
    assert stack._args[0].packed == 1
    packed = stack(x, 300).clone()
    rows, _, _ = fused_decode.fused_block_decode(x, blk, k2, v2, 300,
                                                 n_head=n_head)
    torch.cuda.synchronize()
    assert torch.equal(packed, rows)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)
    # #12 on packed weights, launched as the wrapper launches its rows
    x, kc, vc = _decode_operands(dev, c=c, n_head=n_head, layout="heads")
    k2, v2 = kc.clone(), vc.clone()
    b, t, hd = x.shape[0], kc.shape[2], c // n_head
    ops = fused_decode._check_operands("decode_attn_f32", blk, kc, vc,
                                       tuple(kc.shape), n_head, False, dev,
                                       packed=True)
    scratch = fused_decode._scratch(b, c, 0, n_head, dev)
    out = fused_decode._rows_out(b, c, 0, dev)
    args = fused_decode._pack(ops, kc, vc, (n_head * t * hd, t * hd, hd),
                              scratch, b, t, c, 0, n_head)
    _launched("decode_attn_f32", lambda: fused_decode._launch(
        "decode_attn_f32", args, fused_decode._padded_rows(x, c, 0), out,
        300, kernels.stream_ptr(dev)))
    rows, _, _ = fused_decode.fused_decode_attn(x, blk, k2, v2, 300,
                                                n_head=n_head)
    torch.cuda.synchronize()
    assert torch.equal(out[..., :c], rows)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)


def test_widened_kernels_raise_past_4096(dev):
    """C = 4,097 in one head, past every kernel's widest row: the int8
    attention (#2 and #6 with int8_attn), #9 on bf16 and the decode
    kernels raise ValueError naming 4096 before any launch."""
    c = 4097
    x = torch.zeros(1, 9, c, device=dev)
    w_qkv = torch.zeros(3 * c, c, dtype=torch.int8, device=dev)
    w_sq = torch.zeros(c, c, dtype=torch.int8, device=dev)
    w_fc = torch.zeros(4 * c, c, dtype=torch.int8, device=dev)
    w_mp = torch.zeros(c, 4 * c, dtype=torch.int8, device=dev)
    scales = torch.ones(4, device=dev)
    vc, v3c, v4c = (torch.zeros(n, m, device=dev)
                    for n, m in ((8, c), (2, 3 * c), (2, 4 * c)))
    q = torch.zeros(1, 1, 9, c, device=dev, dtype=torch.bfloat16)
    blk = _decode_block(dev, 64, 1)
    blk.ln_1.weight.data = torch.zeros(c, device=dev)
    xd = torch.zeros(2, 1, c, device=dev)
    cache = torch.zeros(2, 9, c, device=dev)
    before = dict(kernels.launches)
    bad = [
        lambda: fbq.attn_block_quant(x, w_qkv, w_sq, scales, vc[:6], v3c,
                                     n_head=1, int8_attn=True),
        lambda: fbq.block_quant(x, w_qkv, w_sq, w_fc, w_mp, scales, vc, v3c,
                                v4c, n_head=1, int8_attn=True),
        lambda: fused_attn.flash_causal_attention(q, q, q),
        lambda: fused_decode.fused_block_decode(xd, blk, cache, cache, 0,
                                                n_head=1),
        lambda: fused_decode.fused_decode_attn(
            xd, blk, cache[:, None], cache[:, None], 0, n_head=1),
    ]
    for call in bad:
        with pytest.raises(ValueError, match="4096"):
            call()
    torch.cuda.synchronize()
    assert kernels.launches == before


def test_d1600_classify_runs_on_every_f32_attention_path(dev):
    """The width of GPT-2 XL (d_model 1,600, 25 heads of 64), one block:
    quantized_classify on the plain path (its class head's l1 a (1,600
    -> 1) int8 product, once refused on the card) and on 'attn', 'full'
    and fused_attention=True, whose labels equal the plain path's where
    its logit margin exceeds 1e-3."""
    from vq_vae_transformer_arc_welding_tpu_torch.models.quantized import (
        calibrate_activation_absmax, quantize_transformer,
        quantized_classify)
    _, tr = entry.build(d_model=1600, n_blocks=1, n_heads=25, hidden=64,
                        n_res=1, k=32, d=8, seed=0, device=dev)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 32, (6, entry.N_CYCLES * 16 + 1), generator=g)
    ids[:, 0] = 32
    ids = ids.to(dev)
    with torch.inference_mode():
        qp = quantize_transformer(tr, calibrate_activation_absmax(
            tr, ids[:2]))
        ref = quantized_classify(tr, qp, ids)
        assert ref.shape == (6, 2) and torch.isfinite(ref).all()
        sure = (ref[:, 0] - ref[:, 1]).abs() > 1e-3
        for kw in ({"block_fusion": "attn"}, {"block_fusion": "full"},
                   {"fused_attention": True}):
            out = quantized_classify(tr, qp, ids, **kw)
            assert torch.isfinite(out).all(), kw
            assert torch.equal(out.argmax(-1)[sure],
                               ref.argmax(-1)[sure]), kw


@pytest.mark.parametrize("c", [1, 6, 100, 512, 1100, 2048, 4096])
def test_ln_q8_alone_matches_plain(dev, c):
    """#2's LayerNorm+q8 rows launched alone at any C up to 4,096 (the
    template at multiples of 64 up to 1,024, ln_q8_any_kernel at every
    other): within the int8 contract of the plain version, the rail
    counts those of its own output, its rows pitch16(C) bytes apart."""
    g = torch.Generator().manual_seed(c)
    x = (torch.randn(3, 45, c, generator=g) * 3).to(dev)
    scale = (torch.rand(c, generator=g) + 0.5).to(dev)
    bias = (torch.randn(c, generator=g) * 0.1).to(dev)
    qs = torch.tensor(30.0, device=dev)
    rails = torch.full((3, 45), -1, dtype=torch.int32, device=dev)
    h8 = _launched("ln_q8", lambda: fbq.ln_q8(x, scale, bias, qs,
                                               rail_rows=rails))
    assert h8.shape == x.shape and kernels.is_pitched(h8)
    _int8_close(h8, fbq.ln_q8_reference(x, scale, bias, qs))
    assert torch.equal(rails, (h8.int().abs() == 127).sum(
        -1, dtype=torch.int32))


def test_wrappers_raise_past_4096(dev):
    """C = 4,097, past the kernels' widest row: #2, #6, #8, #10, #11 and
    LN+q8 raise ValueError naming 4096 before any launch."""
    c = 4097
    x = torch.zeros(1, 3, c, device=dev)
    w_qkv = torch.zeros(3 * c, c, dtype=torch.int8, device=dev)
    w_sq = torch.zeros(c, c, dtype=torch.int8, device=dev)
    w_fc = torch.zeros(4 * c, c, dtype=torch.int8, device=dev)
    w_mp = torch.zeros(c, 4 * c, dtype=torch.int8, device=dev)
    scales = torch.ones(4, device=dev)
    vc, v3c, v4c = (torch.zeros(n, m, device=dev)
                    for n, m in ((8, c), (2, 3 * c), (2, 4 * c)))
    before = dict(kernels.launches)
    bad = [
        lambda: fbq.attn_block_quant(x, w_qkv, w_sq, scales, vc[:6], v3c,
                                     n_head=1),
        lambda: fbq.block_quant(x, w_qkv, w_sq, w_fc, w_mp, scales, vc, v3c,
                                v4c, n_head=1),
        lambda: fmlp.mlp_quant(x, w_fc, w_mp, scales[2:], v4c, vc[6:]),
        lambda: fattn.qkv_attention_quant(x, w_qkv, scales[:2], v3c,
                                          n_head=1),
        lambda: fattn.fused_causal_attention_quant(
            torch.zeros(1, 3, 3 * c, device=dev), scales[1], n_head=1),
        lambda: fbq.ln_q8(x, vc[0], vc[1], scales[0]),
    ]
    for call in bad:
        with pytest.raises(ValueError, match="4096"):
            call()
    assert kernels.launches == before
