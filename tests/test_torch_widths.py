"""The port at widths off the bench model's, on the CPU.

The CUDA kernels take every head width up to 128 on tiles instantiated
at 32, 64 and 128, a narrower head zero-filled (the f32 attention, the
int8 attention and the decode kernels; the f32 attention also any wider
head, tests/test_torch_transformer_shapes.py) and every encoder hidden
width that is a multiple of 64 from 64 to 512 (the f32 encoder tile at
128, 256 and 512, the weights zero-padded by `split_weights`). The kernels
run only on the card (chip_smoke.py's `widths_phase`); here:

- the quality study's shapes (scripts/quality_study.py:76-86: a VQ-VAE
  at hidden 64 with 2 resblocks, K=32, D=8; a transformer at d192 with 8
  heads of 24, cut to 2 blocks and 2 cycles) through the port's plain
  path against the JAX package, its Pallas kernels in interpret mode,
  with tests/test_torch_quantized.py's `CLASSIFY_CASES` tolerances;
- the padded plans emulated against the unpadded plain versions: the
  f32 attention tile and the decode step with a zero-filled head (bit
  for bit the unpadded tile's where the head fits it, within the
  kernels' bounds of the plain core), the int8 attention's padded qkv8
  read back, and the encoder tile at width 128 on a hidden-64 pack.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from vq_vae_transformer_arc_welding_tpu.models import (
    TransformerDecoder as JaxTransformer, VQVAEPatch as JaxVQVAE)
from vq_vae_transformer_arc_welding_tpu.models import quantized as jq
from vq_vae_transformer_arc_welding_tpu.ops import pallas_encoder as jenc
from vq_vae_transformer_arc_welding_tpu.serve import (
    WeldingQualityPipeline as JaxPipeline)
from vq_vae_transformer_arc_welding_tpu_torch import bridge, entry, kernels
from vq_vae_transformer_arc_welding_tpu_torch.models import quantized as pq
from vq_vae_transformer_arc_welding_tpu_torch.ops import (
    fused_attn_quant as fattn, fused_block_quant as fbq, fused_decode as fdec,
    fused_encoder as fenc)
from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import gelu
from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
    causal_attention_core, merge_heads, split_heads)
from vq_vae_transformer_arc_welding_tpu_torch.ops.int8 import quantize_act
from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import batch_norm_apply

from test_torch_attention_split import (KT, QROWS, fma_scores, mma_acc,
                                        query_blocks)
from test_torch_encoder_split import KSTEP, tile_product
from test_torch_quantized import CLASSIFY_CASES

N_CYCLES = 2                  # 33 tokens
STUDY_VQ = dict(hidden_dim=64, input_dim=2, num_embeddings=32,
                embedding_dim=8, n_resblocks=2, learning_rate=1e-3,
                batch_norm=False)
STUDY_TR = dict(d_model=192, n_head=8, n_blocks=2)
MAX_ATTN_ERR = 2e-5           # the f32 attention tile against the plain core
MAX_DECODE_ERR = 1e-5         # the decode step's attention against plain
MAX_CHAIN_REL = 1e-4          # the encoder tile, of the output's magnitude


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


def _windows(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, N_CYCLES * 200, 2)).astype(np.float32)


@functools.cache
def _study():
    """The JAX pipeline of the study's shapes, calibrated in int8 with
    the fused encoder, and the port's models and qparams bridged from
    it."""
    vq = JaxVQVAE(**STUDY_VQ)
    vq_params, vq_state = vq.init(0)
    tr = JaxTransformer(n_classes=STUDY_VQ["num_embeddings"] + 2,
                        seq_len=N_CYCLES * 16 + 1, **STUDY_TR)
    tr_params, _ = tr.init(1)
    jp = JaxPipeline((vq, vq_params, vq_state), (tr, tr_params),
                     n_cycles=N_CYCLES, max_batch=4, precision="int8",
                     encoder_impl="fused")
    jp.calibrate(_windows(4, seed=3))
    port_vq = bridge.vqvae_from_jax(vq.hparams, vq_params, vq_state,
                                    device="cpu")
    port_tr = bridge.transformer_from_jax(tr.hparams, tr_params,
                                          device="cpu")
    return jp, port_vq, port_tr, bridge.qparams_from_jax(jp.qparams,
                                                         device="cpu")


def test_study_shapes_run_on_the_padded_tiles():
    """The study's head (24) runs on the attention tile of 32, its
    hidden width (64) on the encoder tile of 128; every transformer
    kernel (the f32 and int8 attentions, #9 on f32 and bf16, the decode
    kernels, the int8 GEMM and LN+q8) takes every C up to 4,096 in any
    heads, with `require_heads`' defaults, and refuses C = 4,097."""
    _, vq, tr, _ = _study()
    hd = tr.d_model // tr.n_head
    assert (hd, kernels.padded_head_width(hd)) == (24, 32)
    assert fenc.kernel_width(vq.hidden_dim) == 128
    assert [kernels.padded_head_width(w) for w in (1, 32, 33, 64, 65, 128)] \
        == [32, 32, 64, 64, 128, 128]
    assert [fenc.kernel_width(h) for h in range(64, 513, 64)] == [
        128, 128, 256, 256, 512, 512, 512, 512]
    assert not hasattr(kernels, "NARROW") and not hasattr(
        kernels, "INT8_ATTN") and not hasattr(fdec, "MAX_C")
    for c, n_head in ((192, 8), (1024, 8), (192, 64), (256, 2), (64, 64),
                      (192, 1), (1024, 4), (96, 2), (1088, 17), (1600, 25),
                      (4096, 1)):
        kernels.require_heads("check", c, n_head)
    for c, n_head in ((4097, 1), (128, 3), (128, 3 * 128), (0, 1)):
        with pytest.raises(ValueError, match="not supported"):
            kernels.require_heads("check", c, n_head)
    with pytest.raises(ValueError, match="4096"):
        kernels.require_heads("check", 4097, 1)


@pytest.mark.parametrize("kw,tol", CLASSIFY_CASES,
                         ids=lambda v: str(v) if isinstance(v, dict) else "")
def test_study_transformer_classify_matches_jax(kw, tol):
    """quantized_classify of the d192 / 8-head model on bridged qparams:
    the port's plain path against JAX's, whose fused variants are its
    Pallas kernels in interpret mode at head width 24."""
    jp, _, tr, qparams = _study()
    ids = np.random.default_rng(11).integers(
        0, STUDY_VQ["num_embeddings"], (2, N_CYCLES * 16 + 1))
    ids[:, 0] = STUDY_VQ["num_embeddings"]
    ids = ids.astype(np.int32)
    ref = jq.quantized_classify(jp.tr_model, jp.qparams, jnp.asarray(ids),
                                **kw)
    out = pq.quantized_classify(tr, qparams, torch.from_numpy(ids), **kw)
    assert out.shape == (2, 2)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=tol)
    np.testing.assert_array_equal(_np(out).argmax(-1),
                                  np.asarray(ref).argmax(-1))


@pytest.mark.parametrize("block_fusion,tol", [
    ("attn", 1e-3), ("full", 1e-3), ("attn8", 2e-2), ("full8", 2e-2)])
def test_study_pipeline_matches_jax(block_fusion, tol):
    """entry.make_pipeline_quantized on windows (the hidden-64 encoder
    through the fused encoder's plain path, then the int8 transformer)
    against the JAX entry with its Pallas encoder and block kernels in
    interpret mode: the same ids, logits within the contract."""
    jp, vq, tr, qparams = _study()
    x = _windows(2, seed=12)
    old = graft.N_CYCLES
    graft.N_CYCLES = N_CYCLES
    try:
        ref = np.asarray(graft.make_pipeline_quantized(
            jp.vq_model, jp.tr_model, jp.qparams, block_fusion=block_fusion)(
                jp.vq_params, jp.vq_state, jnp.asarray(x)))
    finally:
        graft.N_CYCLES = old
    out = _np(entry.make_pipeline_quantized(vq, tr, qparams,
                                            block_fusion=block_fusion)(
        torch.from_numpy(x)))
    cycles = x.reshape(-1, 200, 2)
    with torch.no_grad():
        ids = _np(fenc.encode_indices_fused(vq, fenc.pack_encoder(vq),
                                            torch.from_numpy(cycles)))
    jids = np.asarray(jenc.encode_indices_fused(
        jp.vq_model, jp.vq_params, jp.vq_state, jnp.asarray(cycles)))
    # f32 encoders summing in other orders may flip a near-tie id
    assert (ids != jids).mean() <= 0.01
    same = (ids.reshape(len(x), -1) == jids.reshape(len(x), -1)).all(1)
    assert same.any()
    np.testing.assert_allclose(out[same], ref[same], rtol=0, atol=tol)


# -- the f32 attention tile with a zero-filled head ---------------------------

def padded_tile_attention(q, k, v, width: int):
    """csrc/attention_tc.cuh's tile at head width `width` on heads of
    real width hd = q.shape[-1] <= width: q, k and v zero-filled to
    `width` as the tile's copies fill its shared memory, the scores an
    FMA chain over all `width` columns, sm_scale 1/sqrt(hd), P V in
    split TF32, and only the first hd columns of the output kept.
    q, k, v (B, H, T, hd) f32."""
    b, h, t, hd = q.shape
    pad = [torch.nn.functional.pad(z, (0, width - hd)) for z in (q, k, v)]
    q, k, v = pad
    out = torch.zeros(b, h, t, width)
    sm_scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    for rows in query_blocks(t):
        r = torch.tensor(list(rows))
        valid = r >= 0
        lim = r.clamp(min=0)
        qb = q[:, :, lim] * valid[:, None]
        m = torch.full((b, h, QROWS, 1), -math.inf)
        l = torch.zeros(b, h, QROWS, 1)
        o = torch.zeros(b, h, QROWS, width)
        for k0 in range(0, rows.stop, KT):
            kt = torch.zeros(b, h, KT, width)
            vt = torch.zeros(b, h, KT, width)
            n = min(KT, t - k0)
            kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
            s = fma_scores(qb, kt) * sm_scale
            causal = (k0 + torch.arange(KT))[None, :] <= lim[:, None]
            s = s.masked_fill(~causal, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = mma_acc(o * alpha, p, vt, 3)
            m = m_new
        out[:, :, r[valid]] = (o / l)[:, :, valid]
    assert not out[..., hd:].any()          # P V's padded columns are 0
    return out[..., :hd]


def _heads(b, h, t, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((b, h, t, hd)) * 2.0)
                             .astype(np.float32)) for _ in range(3)]


@pytest.mark.parametrize("hd", [24, 8, 40, 80, 3])
def test_zero_filled_head_attention_matches_plain(hd):
    """Heads of 24 and 8 on the tile of 32, 40 on 64, 80 and an odd 3
    on theirs: within 2e-5 of the plain core (#9's bound), and the tile
    one size up gives the same bits (a zero column adds an exact 0.0 to
    every score)."""
    q, k, v = _heads(1, 2, 70, hd, seed=hd)
    width = kernels.padded_head_width(hd)
    out = padded_tile_attention(q, k, v, width)
    ref = causal_attention_core(q, k, v)
    assert float((out - ref).abs().max()) <= MAX_ATTN_ERR
    if width < 128:
        assert torch.equal(padded_tile_attention(q, k, v, 2 * width), out)


def test_zero_filled_head_attention_matches_the_unpadded_tile():
    """A head of 32 on the tile of 32 and on the tile of 64, bit for
    bit: the 64-wide tile's columns 32 .. 63 are zero."""
    q, k, v = _heads(1, 1, 140, 32, seed=5)
    assert torch.equal(padded_tile_attention(q, k, v, 32),
                       padded_tile_attention(q, k, v, 64))


def test_attention_tiles_in_the_header():
    """The tile's widths and the host's choice of them as compiled."""
    text = (kernels.SRC_DIR / "attention_tc.cuh").read_text()
    assert "return hd <= 32 ? 32 : hd <= 64 ? 64 : 128;" in text
    assert "static constexpr int MIN_BLOCKS = HD <= 64 ? 2 : 1;" in text
    assert "constexpr int MAX_HD = 128;" in text
    block = (kernels.SRC_DIR / "int8_block.cuh").read_text()
    assert f"constexpr int MAX_HEAD_DIM = {kernels.MAX_HEAD_DIM};" in block


# -- the decode step with a zero-filled head ----------------------------------

def decode_attention_emulated(q, kc, vc, pos: int, lanes: int):
    """csrc/decode.cu's attention for one (sample, head): `lanes` lanes a
    key (16 for heads up to 64 wide, 32 up to 128), a float4 of the head
    each, zero past its width; the lane's four products summed in order,
    then a butterfly over the lanes; 256 / lanes groups of keys, each
    with its online softmax, merged in order. q (hd,), kc, vc (T, hd)."""
    hd = q.shape[0]
    width = 4 * lanes
    groups = 256 // lanes
    qp = torch.nn.functional.pad(q, (0, width - hd)).view(lanes, 4)
    kp = torch.nn.functional.pad(kc[:pos + 1], (0, width - hd))
    vp = torch.nn.functional.pad(vc[:pos + 1], (0, width - hd))
    ms, sums, parts = [], [], []
    for g in range(groups):
        m, s, acc = -math.inf, torch.tensor(0.0), torch.zeros(width)
        for j in range(g, pos + 1, groups):
            part = torch.zeros(lanes)
            kj = kp[j].view(lanes, 4)
            for e in range(4):
                part = part + qp[:, e] * kj[:, e]
            o = lanes // 2
            while o:
                part = part + part[torch.arange(lanes) ^ o]
                o //= 2
            score = float(part[0] * torch.tensor(1.0 / math.sqrt(hd)))
            m_new = max(m, score)
            alpha = math.exp(m - m_new) if m > -math.inf else 0.0
            p = math.exp(score - m_new)
            s = s * alpha + p
            acc = acc * alpha + p * vp[j]
            m = m_new
        ms.append(m)
        sums.append(s)
        parts.append(acc)
    mx = max(ms)
    w = [math.exp(m - mx) if m > -math.inf else 0.0 for m in ms]
    out = sum(wi * a for wi, a in zip(w, parts))
    den = sum(wi * s for wi, s in zip(w, sums))
    assert not out[hd:].any()
    return (out / den)[:hd]


@pytest.mark.parametrize("hd,lanes", [(24, 16), (3, 16), (80, 32),
                                      (24, 32), (64, 16)])
def test_zero_filled_decode_attention_matches_plain(hd, lanes):
    """The decode kernels' attention of a head of 24 (and an odd 3) on
    16 lanes a key, of 80 on 32, at three positions: within 1e-5 of
    softmax(q K^T / sqrt(hd)) V over rows 0..pos (fused_decode's plain
    step)."""
    rng = np.random.default_rng(hd + lanes)
    t = 40
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((hd,), (t, hd), (t, hd)))
    for pos in (0, 17, t - 1):
        got = decode_attention_emulated(q, kc, vc, pos, lanes)
        ref = fdec._attend(q[None, None, None], kc[None, None, :pos + 1],
                           vc[None, None, :pos + 1])[0, 0, 0]
        assert float((got - ref).abs().max()) <= MAX_DECODE_ERR


def test_decode_operands_at_the_study_width():
    """The decode kernels' checks take the d192 / 8-head block and its
    caches (#12: (B, H, T, 24); #13: (B, T, 192)); the plain stack
    writes each head's row of 24 floats in place."""
    _, tr = entry.build(d_model=192, n_blocks=2, n_heads=8, hidden=64,
                        n_res=1, k=32, d=8, seed=0, device="cpu")
    caches = [(torch.zeros(2, 9, 192), torch.zeros(2, 9, 192))
              for _ in range(2)]
    checked = fdec.check_stack(list(tr.blocks), caches, n_head=8)
    assert [c4 for _, c4 in checked] == [768, 768]
    heads = (torch.zeros(2, 8, 9, 24), torch.zeros(2, 8, 9, 24))
    x = torch.randn(2, 1, 192, generator=torch.Generator().manual_seed(1))
    fdec._checked("decode_attn_f32", x, tr.blocks[0], *heads, (2, 8, 9, 24),
                  3, 8, mlp=False)
    out, kc, vc = fdec.fused_decode_attn(x, tr.blocks[0], *heads, 3, n_head=8)
    assert out.shape == (2, 1, 192) and bool(kc[:, :, 3].abs().sum() > 0)
    assert not kc[:, :, :3].any() and not kc[:, :, 4:].any()


# -- the int8 attention's padded qkv8 -----------------------------------------

def _unpack_padded(qkv8, t, n_head, width):
    """q8, k8 (B, n_head, T, width) and v8 in key order (B, n_head, T,
    width) from the padded qkv8."""
    b = qkv8.shape[0]
    tp = qkv8.shape[-1] // width
    q8, k8 = (qkv8[:, :, i].reshape(b, n_head, tp, width)[:, :, :t]
              for i in (0, 1))
    vt = qkv8[:, :, 2].reshape(b, n_head, width, tp // 32, 32)
    v8 = torch.empty_like(vt)
    v8[..., fbq.v_key_order()] = vt
    return q8, k8, v8.reshape(b, n_head, width, tp).transpose(-1, -2)[:, :, :t]


@pytest.mark.parametrize("c,n_head,t", [(192, 8, 45), (192, 64, 70),
                                        (256, 2, 33), (192, 2, 65)])
def test_padded_qkv8_reads_back(c, n_head, t):
    """quantize_heads_reference at heads of 24, 3, 128 and 96 (padded to
    32, 32, 128 and 128): the real columns are each head's q8 with its
    own scale, every padded column (and v8's padded rows) and every row
    past T zero, the scales those of the unpadded heads; the integer
    scores and P V from the padded operands equal the unpadded ones."""
    rng = np.random.default_rng(c + n_head + t)
    qkv = torch.from_numpy(rng.standard_normal((2, t, 3 * c))
                           .astype(np.float32) * 2)
    hd, width = c // n_head, fbq.qkv8_head_width(c, n_head)
    qkv8, scales = fbq.quantize_heads_reference(qkv, n_head)
    assert qkv8.shape == (2, n_head, 3, fbq.padded_t(t) * width)
    q8, k8, v8 = _unpack_padded(qkv8, t, n_head, width)
    z = [split_heads(part, n_head) for part in qkv.split(c, dim=-1)]
    for i, (got, x) in enumerate(zip((q8, k8, v8), z)):
        am = x.abs().amax(dim=(-1, -2), keepdim=True).clamp(min=1e-6)
        s = torch.full_like(am, 127.0) / am
        assert torch.equal(got[..., :hd], quantize_act(x, s))
        assert not got[..., hd:].any()
        torch.testing.assert_close(scales[:, i], s[..., 0, 0], rtol=0,
                                   atol=0)
    full = qkv8.reshape(2, n_head, 3, -1, width)
    assert not full[:, :, :2, t:].any()
    s8 = q8.int() @ k8.int().transpose(-1, -2)
    assert torch.equal(s8, q8[..., :hd].int()
                       @ k8[..., :hd].int().transpose(-1, -2))
    p8 = torch.randint(0, 128, (2, n_head, t, t), dtype=torch.int32)
    assert torch.equal((p8 @ v8.int())[..., :hd], p8 @ v8[..., :hd].int())
    # and the int8 attention on them is the plain version's
    out = fattn.attention_core_reference(qkv, n_head, int8_attn=True)
    sq, sk, sv = (scales[:, i][..., None, None] for i in range(3))
    sm = torch.full_like(sq, fattn.sm_scale(c, n_head))
    sc = s8.float() * (sm / (sq * sk))
    sc = sc.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -math.inf)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    o = (quantize_act(p, 127.0).int() @ v8.int()).float()[..., :hd] / (
        127.0 * sv)
    torch.testing.assert_close(merge_heads(o / p.sum(-1, keepdim=True)), out,
                               rtol=0, atol=1e-5)


# -- the encoder tile at width 128 on a hidden-64 pack ------------------------

def _unpack_width(pack, width):
    m = pack.shape[0]
    return pack.reshape(m, width // KSTEP, 2, width // 8, 2, 8, 4).permute(
        0, 2, 3, 5, 1, 4, 6).reshape(m, 2, width, width)


def tile_chain_padded(x, weights, vecs, use_bn: bool):
    """csrc/encoder_tc.cuh's tile at the width `split_weights` pads the
    pack to: x and the vector rows zero past the hidden width, the
    products over the whole width, every epilogue on every column."""
    c = x.shape[1]
    width = fenc.kernel_width(c)
    parts = _unpack_width(fenc.split_weights(weights), width)
    x = torch.nn.functional.pad(x, (0, width - c))
    vecs = torch.nn.functional.pad(vecs, (0, width - c))
    for i in range(weights.shape[0] // 2):
        v = vecs[10 * i:10 * (i + 1)]
        h = tile_product(gelu(x), *parts[2 * i]) + v[0]
        if use_bn:
            h = batch_norm_apply(h, v[3], v[4], v[1], v[2])
        h = tile_product(gelu(h), *parts[2 * i + 1]) + v[5]
        if use_bn:
            h = batch_norm_apply(h, v[8], v[9], v[6], v[7])
        x = x + h
    assert not x[:, c:].any()            # the padded columns stay 0
    return x[:, :c]


def _encoder_operands(c, n_blocks, use_bn, rows=256, seed=0):
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


def test_split_weights_pads_to_the_tile():
    """Hidden 64 and 192: the split is the tile's (128 and 256), the
    real block hi and lo of the unpadded weights, zeros around it; 512
    and above unpadded."""
    for c, width in ((64, 128), (192, 256), (512, 512)):
        _, w, _ = _encoder_operands(c, 1, False)
        tw = torch.from_numpy(w)
        pack = fenc.split_weights(tw)
        assert pack.shape == (2, 2 * width * width)
        parts = _unpack_width(pack, width)
        hi = fenc.tf32(tw.transpose(1, 2))
        assert torch.equal(parts[:, 0, :c, :c], hi)
        assert torch.equal(parts[:, 1, :c, :c],
                           fenc.tf32(tw.transpose(1, 2) - hi))
        assert not parts[:, :, c:].any() and not parts[:, :, :, c:].any()


@pytest.mark.parametrize("c,use_bn", [(64, False), (64, True), (192, True)])
def test_padded_encoder_tile_matches_jax(c, use_bn):
    """A group of two resblocks at hidden 64 (tile 128) and 192 (tile
    256): the padded tile's emulation against JAX fused_encoder_eval in
    interpret mode within 1e-4 of its magnitude, and the CPU wrapper,
    handed the padded split, runs the plain version."""
    x, w, v = _encoder_operands(c, 2, use_bn)
    ref = torch.from_numpy(np.array(jenc.fused_encoder_eval(
        jnp.asarray(x), w, v, tile_rows=64, use_bn=use_bn)))
    tx, tw, tv = map(torch.from_numpy, (x, w, v))
    emu = tile_chain_padded(tx, tw, tv, use_bn)
    scale = float(ref.abs().max())
    assert float((emu - ref).abs().max()) <= MAX_CHAIN_REL * scale
    plain = fenc.fused_encoder_eval_reference(tx, tw, tv, use_bn=use_bn)
    assert float((emu - plain).abs().max()) <= MAX_CHAIN_REL * scale
    cpu = fenc.fused_encoder_eval(tx, tw, tv, use_bn=use_bn,
                                  split=fenc.split_weights(tw))
    assert torch.equal(cpu, plain)


def test_encoder_wrappers_check_the_padded_split():
    """The wrappers' checks on CPU-independent shapes: a hidden-64 pack
    carries a (2n, 2 x 128 x 128) split; a split of the unpadded size is
    refused on a card tensor's path (checked here by the same helper)."""
    _, w, _ = _encoder_operands(64, 1, False)
    tw = torch.from_numpy(w)
    split = fenc._split_operand("encoder_chain_f32", tw, None)
    assert split.shape == (2, 2 * 128 * 128)
    assert fenc._split_operand("encoder_chain_f32", tw, split) is split
    with pytest.raises(ValueError):
        fenc._split_operand("encoder_chain_f32", tw,
                            torch.zeros(2, 2 * 64 * 64))
    for c in (1, 3, 32, 64, 96, 192, 320, 512, 576, 1024, 4096):
        fenc._require_width("resblock_f32", c)
    for c in (0, 4097, 8192):
        with pytest.raises(ValueError, match="1 to 4096"):
            fenc._require_width("resblock_f32", c)
