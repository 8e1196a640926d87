"""The int8 attention, #9's bf16 tile and the decode kernels at every
transformer width the CLI can build, on the CPU.

The int8 attention of #2 and #6 ('attn8', 'full8'), #9 on bf16 q, k and
v, and the decode kernels #12 and #13 take any C from 1 to 4,096 in any
heads (`kernels.require_heads`' defaults), as the JAX kernels do. Held
here at C 200 in heads of 25, one head of 192, C 1,100 in heads of 275
(above 1,024, no multiple of 64) and C 1,800 in heads of 300, at T <= 70
and batch <= 2:

- the int8 attention's quantizing pass (its plain version,
  `quantize_heads_reference`, a head past 128 in qkv8 rows of a multiple
  of 32) bit for bit against JAX's `_q8` with 127 / absmax;
- the wide int8 tile (csrc/attention_int8.cuh::
  attention_int8_wide_kernel) emulated as it walks T: a block per 128
  output columns, the integer scores recomputed in each, over 128-column
  chunks; its integers equal `attention_core_reference(int8_attn=True)`'s
  and its y and y8 meet the int8 contract (1e-5, one y8 step in 1e-3 of
  entries) against JAX's `_attn_core(int8_attn=True)`;
- both decode wrappers' plain versions against JAX's `pallas_decode`
  kernels in interpret mode (1e-5 on the stream, 1e-6 on the cache
  rows), the padded depths of csrc/decode.cu (zeros add exact 0s, the
  weights packed for its general form, the LayerNorm over a padded row),
  and `generate_kv(decode_impl='fused')` against JAX's at C 200 (the
  general form's order of sums and its attention of heads past 128:
  tests/test_torch_decode_general.py);
- the wide bf16 tile (csrc/attention_bf16.cuh::
  causal_attention_bf16_tile_wide) emulated at heads of 192 and 300
  within the bf16 gate of the JAX kernel in interpret mode and of the
  plain version.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_transformer_arc_welding_tpu.models import (
    TransformerDecoder as JaxTransformerDecoder)
from vq_vae_transformer_arc_welding_tpu.ops import (
    pallas_attn, pallas_block_quant as jbq, pallas_decode)
from vq_vae_transformer_arc_welding_tpu_torch import bridge, entry, kernels
from vq_vae_transformer_arc_welding_tpu_torch.ops import (
    fused_attn, fused_attn_quant as fattn, fused_block_quant as fbq,
    fused_decode as fdec)
from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
    merge_heads, split_heads)
from vq_vae_transformer_arc_welding_tpu_torch.ops.int8 import (
    int8_bmm, quantize_act)
from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm

from test_torch_flash_bf16_split import (
    MAX_SHARE, bf16, exp_f32, gate, split_terms, trunc32)

WIDTHS = [(200, 8), (192, 1), (1100, 4), (1800, 6)]
IDS = [f"{c}x{h}" for c, h in WIDTHS]
TT, WROWS, PIECE = fbq.T_TILE, 16, 128
Y_SCALE = 127.0 / 3.0
INT_MIN = torch.iinfo(torch.int32).min
SEQ = 33


def _qkv(b, t, c, seed):
    """(B, T, 3C) f32 from numpy, q, k, v of order 1 to 3, each head at
    its own spread."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 3, c)).astype(np.float32)
    x *= rng.uniform(0.5, 3.0, (1, 1, 3, c)).astype(np.float32)
    return torch.from_numpy(x.reshape(b, t, 3 * c))


def _int8_close(out, ref, frac=1e-3):
    diff = (out.int() - ref.int()).abs()
    assert diff.max() <= 1 and (diff != 0).float().mean() <= frac, (
        int(diff.max()), float((diff != 0).float().mean()))


# -- limits -------------------------------------------------------------------

@pytest.mark.parametrize("c,n_head", WIDTHS + [(1600, 25), (2048, 8),
                                               (4096, 1), (1, 1)])
def test_every_kernel_takes_the_width(c, n_head):
    """`require_heads` with its defaults, the only width check of the
    int8 attention, #9 on bf16 and the decode kernels, takes the width;
    the qkv8 head is the tile's up to 128 and a multiple of 32 past it,
    the decode depths multiples of 64."""
    for name in ("attn_block_quant", "block_quant", "flash_attention_bf16",
                 "decode_attn_f32", "block_decode_f32"):
        kernels.require_heads(name, c, n_head)
    hd, width = c // n_head, fbq.qkv8_head_width(c, n_head)
    assert width >= hd and width % 32 == 0 and width - hd < (
        32 if hd > 128 else width)
    assert fdec.pad64(c) % 64 == 0 and 0 <= fdec.pad64(c) - c < 64


def test_c_4097_raises():
    with pytest.raises(ValueError, match="4096"):
        kernels.require_heads("block_decode_f32", 4097, 1)
    with pytest.raises(ValueError, match="not supported"):
        kernels.require_heads("flash_attention_bf16", 4097, 17)


# -- the int8 attention -------------------------------------------------------

def _unpack(qkv8, t, n_head, width):
    """q8, k8, v8 (B, n_head, T, width) int8 in key order, from qkv8."""
    b = qkv8.shape[0]
    tp = fbq.padded_t(t)
    q8, k8 = (qkv8[:, :, i].reshape(b, n_head, tp, width)[:, :, :t]
              for i in (0, 1))
    vt = qkv8[:, :, 2].reshape(b, n_head, width, tp // 32, 32)
    v8 = torch.empty_like(vt)
    v8[..., fbq.v_key_order()] = vt
    return q8, k8, v8.reshape(b, n_head, width, tp).transpose(-1, -2)[
        :, :, :t]


@pytest.mark.parametrize("c,n_head", WIDTHS, ids=IDS)
def test_quantize_heads_matches_jax_q8(c, n_head):
    """Bit-equal int8 operands and equal scales, per (batch, q/k/v,
    head), to JAX's 127 / max(absmax, 1e-6) and _q8; zero past the head
    in its padded rows."""
    t, hd = 45, c // n_head
    width = fbq.qkv8_head_width(c, n_head)
    qkv = _qkv(2, t, c, seed=c)
    qkv8, hs = fbq.quantize_heads_reference(qkv, n_head)
    assert qkv8.shape == (2, n_head, 3, fbq.padded_t(t) * width)
    got = _unpack(qkv8, t, n_head, width)
    x = qkv.numpy().reshape(2, t, 3, n_head, hd)
    for b in range(2):
        for which in range(3):
            for h in range(n_head):
                z = jnp.asarray(x[b, :, which, h])
                s = 127.0 / jnp.maximum(jnp.max(jnp.abs(z)), 1e-6)
                assert np.float32(hs[b, which, h]) == np.asarray(s)
                np.testing.assert_array_equal(
                    got[which][b, h, :, :hd].numpy(),
                    np.asarray(jbq._q8(z, s)))
                assert not got[which][b, h, :, hd:].any()


def _visited(t, q0, k0):
    """attention_int8_kernel's computed (row, key) pairs of a 64 x 64
    tile: a warp's 16 rows skip the tile past their last row and keep
    their first jn 8-key blocks (the wide tile's walk is the same)."""
    out = torch.zeros(TT, TT, dtype=torch.bool)
    for w in range(TT // WROWS):
        r0 = q0 + WROWS * w
        if k0 > r0 + 15:
            continue
        jn = min(8, (r0 + 15 - k0) // 8 + 1, (t - k0 + 7) // 8)
        out[WROWS * w:WROWS * (w + 1), :8 * jn] = True
    return out


def emulate_wide(qkv, n_head):
    """The wide int8 tile's arithmetic on qkv (B, T, 3C) f32, from the
    quantizing pass's qkv8: for each PIECE of 128 output columns, the
    int32 scores of each 64-key stage carried over the head's 128-column
    chunks of q8 and k8, pass 1 for the row max, pass 2 for p, l (a
    thread's keys in walk order, then (l0 + l1) + (l2 + l3)) and p8, P@V
    on the piece of v8 in the stored key order. Returns, per piece, the
    scores (B, n_head, T, T) where computed and causal, and o (B, n_head,
    T, width), l (B, n_head, T) and y (B, T, C) f32."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    hd, width = c // n_head, fbq.qkv8_head_width(c, n_head)
    tp = fbq.padded_t(t)
    qkv8, hs = fbq.quantize_heads_reference(qkv, n_head)
    q8 = qkv8[:, :, 0].reshape(b, n_head, tp, width).long()
    k8 = qkv8[:, :, 1].reshape(b, n_head, tp, width).long()
    vt = qkv8[:, :, 2].reshape(b, n_head, width, tp).long()
    sq, sk, sv = (hs[:, i, :, None, None] for i in range(3))
    factor = torch.full_like(sq, fattn.sm_scale(c, n_head)) / (sq * sk)
    keys = torch.arange(TT)
    pos = keys // 32 * 32 + fbq.v_key_order()[keys % 32]
    pieces = []
    for p0 in range(0, hd, PIECE):
        pw = min(PIECE, width - p0)
        s_all = torch.zeros(b, n_head, tp, tp, dtype=torch.int32)
        o = torch.zeros(b, n_head, tp, pw, dtype=torch.int64)
        l = torch.zeros(b, n_head, tp)
        for q0 in range(0, t, TT):
            rows = torch.arange(q0, q0 + TT)[:, None]
            n_kt = -(-min(t, q0 + TT) // TT)
            smax = torch.full((b, n_head, TT, 1), INT_MIN)
            lanes = torch.zeros(b, n_head, TT, 4)
            for pass2 in (False, True):
                for k0 in range(0, n_kt * TT, TT):
                    s = torch.zeros(b, n_head, TT, TT, dtype=torch.int64)
                    for e0 in range(0, width, PIECE):
                        s += (q8[:, :, q0:q0 + TT, e0:e0 + PIECE]
                              @ k8[:, :, k0:k0 + TT, e0:e0 + PIECE]
                              .transpose(-1, -2))
                    s = s.int()
                    kj = torch.arange(k0, k0 + TT)[None, :]
                    ok = _visited(t, q0, k0) & (kj <= rows) & (kj < t)
                    if not pass2:
                        s_all[:, :, q0:q0 + TT, k0:k0 + TT] = torch.where(
                            ok, s, 0)
                        smax = torch.maximum(smax, torch.where(
                            ok, s, INT_MIN).amax(-1, keepdim=True))
                        mx = smax.float() * factor
                        continue
                    p = torch.where(ok, torch.exp(s.float() * factor - mx),
                                    0.0)
                    blocks = p.reshape(b, n_head, TT, 8, 4, 2)
                    for j in range(8):
                        for i in range(2):
                            lanes += blocks[..., j, :, i]
                    p8 = quantize_act(p, 127.0)
                    o[:, :, q0:q0 + TT] += p8[..., pos].long() @ vt[
                        :, :, p0:p0 + pw, k0:k0 + TT].transpose(-1, -2)
            l[:, :, q0:q0 + TT] = ((lanes[..., 0] + lanes[..., 1])
                                   + (lanes[..., 2] + lanes[..., 3]))
        pieces.append((s_all[:, :, :t, :t], o[:, :, :t].int(),
                       l[:, :, :t]))
    o = torch.cat([piece[1] for piece in pieces], dim=-1)[..., :hd]
    y = merge_heads(o.float() / (127.0 * sv) / pieces[0][2][..., None])
    return pieces, o, y


def _plain_integers(qkv, n_head):
    """attention_core_reference(int8_attn=True)'s integer steps: the
    int32 scores (causal, 0 above the diagonal) and P@V sums."""
    c = qkv.shape[-1] // 3
    t = qkv.shape[1]
    q, k, v = (split_heads(z, n_head) for z in qkv.split(c, dim=-1))
    sq, sk, sv = fattn._scale127(q), fattn._scale127(k), fattn._scale127(v)
    s32 = int8_bmm(quantize_act(q, sq),
                   quantize_act(k, sk).transpose(-1, -2))
    s = s32.float() * (torch.full_like(sq, fattn.sm_scale(c, n_head))
                       / (sq * sk))
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = int8_bmm(quantize_act(p, 127.0), quantize_act(v, sv))
    return torch.where(causal, s32, 0), o


@pytest.mark.parametrize("c,n_head", WIDTHS, ids=IDS)
def test_wide_int8_tile_integers_equal_plain(c, n_head):
    """Every piece's scores and the pieces' P@V sums, put together,
    equal the plain version's integer sums exactly: each piece sees the
    same scores, row max, l and p8."""
    qkv = _qkv(2, 70, c, seed=100 + c)
    pieces, o, _ = emulate_wide(qkv, n_head)
    s_ref, o_ref = _plain_integers(qkv, n_head)
    for s32, _, l in pieces:
        assert torch.equal(s32, s_ref)
        assert torch.equal(l, pieces[0][2])
    assert torch.equal(o, o_ref)


@pytest.mark.parametrize("c,n_head", [WIDTHS[0], WIDTHS[3]],
                         ids=[IDS[0], IDS[3]])
def test_wide_int8_tile_matches_jax_attn_core(c, n_head):
    """y within 1e-5 and y8 within one step in 1e-3 of entries of JAX's
    _attn_core(int8_attn=True) and of the plain version: only l's order
    differs."""
    t, hd = 70, c // n_head
    qkv = _qkv(2, t, c, seed=300 + c)
    _, _, y = emulate_wide(qkv, n_head)
    sm = fattn.sm_scale(c, n_head)
    ref = torch.from_numpy(np.stack([
        np.asarray(jbq._attn_core(jnp.asarray(row), n_head, hd, t, sm,
                                  int8_attn=True)) for row in qkv.numpy()]))
    plain = fattn.attention_core_reference(qkv, n_head, int8_attn=True)
    for want in (ref, plain):
        assert float((y - want).abs().max()) <= 1e-5
        _int8_close(quantize_act(y, Y_SCALE), quantize_act(want, Y_SCALE))


# -- the decode kernels -------------------------------------------------------

def _jax_model(c, n_head, n_blocks=1):
    tr = JaxTransformerDecoder(d_model=c, n_classes=34, seq_len=SEQ,
                               n_blocks=n_blocks, n_head=n_head)
    params, _ = tr.init(0)
    return tr, params, bridge.transformer_from_jax(tr.hparams, params,
                                                   device="cpu")


@pytest.mark.parametrize("c,n_head", [WIDTHS[3]], ids=[IDS[3]])
def test_decode_plain_versions_match_jax_kernels(c, n_head):
    """#12 and #13's plain versions against JAX's pallas_decode kernels
    in interpret mode at C 1,800 in heads of 300 (C 200 in heads of 25:
    test_generate_kv_fused_equals_jax_at_c200; JAX's #13 takes caches of
    a multiple of 128 rows):
    the stream within 1e-5, the cache rows 0..pos within the JAX tests'
    1e-6 for every 200 terms of their sums (each row is a C-term f32 dot
    product, summed in another order on each side; its rounding grows
    with C, to 4.3e-6 at C 1,800)."""
    _, params, port = _jax_model(c, n_head)
    rng = np.random.default_rng(c)
    b, hd, pos = 2, c // n_head, 37
    x = rng.standard_normal((b, 1, c)).astype(np.float32)
    for fn, shape, at in (("fused_decode_attn", (b, n_head, 40, hd), 2),
                          ("fused_block_decode", (b, 128, c), 1)):
        kc, vc = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2))
        ref, rk, rv = getattr(pallas_decode, fn)(
            jnp.asarray(x), params["blocks"][0], jnp.asarray(kc),
            jnp.asarray(vc), pos, n_head=n_head)
        pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        out, _, _ = getattr(fdec, fn)(torch.from_numpy(x), port.blocks[0],
                                      pk, pv, pos, n_head=n_head)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)
        keep = (slice(None),) * at + (slice(0, pos + 1),)
        for got, want in ((pk, rk), (pv, rv)):
            np.testing.assert_allclose(got.numpy()[keep],
                                       np.asarray(want)[keep], rtol=0,
                                       atol=1e-6 * max(1, c / 200))


@pytest.mark.parametrize("c,n_head", [WIDTHS[0], WIDTHS[3]],
                         ids=[IDS[0], IDS[3]])
def test_padded_depths_give_the_same_sums(c, n_head):
    """The decode kernels' operands padded to depths of a multiple of 64
    (`fused_decode._padded_weights`, the weights packed for the general
    form, the stream in rows of pad64(C)): every added column is zero,
    and a product over the padded depth equals the unpadded one exactly
    (integer-valued operands, whose sums are exact in any order)."""
    _, tr = entry.build(d_model=c, n_blocks=1, n_heads=n_head, hidden=16,
                        n_res=1, k=32, d=8, seed=0, device="cpu")
    ops, c4, tensors = _operands(tr.blocks[0])
    cp, c4p = fdec.pad64(c), fdec.pad64(c4)
    shapes = [(cp,), (cp,), (3 * c, cp), (3 * c,), (c, cp), (c,), (cp,),
              (cp,), (c4, cp), (c4,), (c, c4p), (c,)]
    for t, (_, p, _), shape in zip(tensors, ops, shapes):
        if len(shape) == 2:          # packed: the padded matrix unpacked
            t = fdec._unpacked(t, shape[0], p.shape[1])
        assert tuple(t.shape) == shape
        assert torch.equal(t[..., :p.shape[-1]], p)
        assert not t[..., p.shape[-1]:].any()
    parts = max(c4p // fdec._chunk_k(c, c4), -(-c4p // fdec.PIECE))
    assert (fdec._scratch(2, c, c4, n_head, torch.device("cpu")).numel()
            == 2 * (c + 2 * cp + c4p + parts * c)
            + fdec._wide_units(2, n_head, c))
    g = torch.Generator().manual_seed(c)
    x = torch.randint(-8, 9, (3, c), generator=g).float()
    w = torch.randint(-8, 9, (5, c), generator=g).float()
    xp = fdec._padded_rows(x[:, None], c, c4)[:, 0]
    wp = fdec._pad_cols(w, cp)
    assert xp.shape == (3, cp) and not xp[:, c:].any()
    assert torch.equal(xp @ wp.T, x @ w.T)


def _operands(blk):
    c = blk.ln_1.weight.shape[0]
    caches = torch.zeros(1, 4, c)
    checked = fdec._check_operands("block_decode_f32", blk, caches, caches,
                                   (1, 4, c), 1, True,
                                   torch.device("cpu"), packed=None)
    mods = [blk.ln_1.weight, blk.ln_1.bias, blk.attn.c_attn.weight,
            blk.attn.c_attn.bias, blk.attn.c_proj.weight,
            blk.attn.c_proj.bias, blk.ln_2.weight, blk.ln_2.bias,
            blk.mlp.c_fc.weight, blk.mlp.c_fc.bias, blk.mlp.c_proj.weight,
            blk.mlp.c_proj.bias]
    return [(None, p, None) for p in mods], checked[1], checked.tensors


def _kernel_ln_stats(row: torch.Tensor, k: int):
    """csrc/decode.cu's row_stats on a row of pad64(k) floats (zero past
    k): lane L sums the float4s L + 32 i in order, a butterfly over the
    lanes; the squares of the last float4's columns past k, (0 - mean)^2
    each, taken off the lanes' sum (row_var)."""
    k4 = -(-k // 4)
    v = row[:4 * k4].view(k4, 4)

    def lane_sums(vals):
        lanes = [torch.tensor(0.0) for _ in range(32)]
        for i in range(k4):
            lanes[i % 32] = lanes[i % 32] + vals[i]
        for off in (16, 8, 4, 2, 1):
            lanes = [lanes[j] + lanes[j ^ off] for j in range(32)]
        return lanes[0]

    mean = lane_sums([(x[0] + x[1]) + (x[2] + x[3]) for x in v]) / k
    d = v - mean
    sq = [(x[0] * x[0] + x[1] * x[1]) + (x[2] * x[2] + x[3] * x[3])
          for x in d]
    var = (lane_sums(sq) - (4 * k4 - k) * mean * mean) / k
    return mean, 1.0 / torch.sqrt(var + 1e-5)


@pytest.mark.parametrize("c", [200, 1100, 1801])
def test_layer_norm_over_a_padded_row(c):
    """The decode kernels' LayerNorm statistics of a row padded with
    zeros to pad64(C) equal those of the row cut at C (the partial
    float4 read whole, the squares of its zeros taken off), and the
    normalised row is within 1e-6 of the plain LayerNorm."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn(c, generator=g) * 2 + 0.5
    padded = torch.cat([x, torch.zeros(fdec.pad64(c) - c)])
    mean, rstd = _kernel_ln_stats(padded, c)
    cut = torch.cat([x, torch.zeros(-c % 4)])
    assert torch.equal(torch.stack([mean, rstd]),
                       torch.stack(list(_kernel_ln_stats(cut, c))))
    ones = torch.ones(c)
    ref = layer_norm(x, ones, torch.zeros(c))
    assert float(((x - mean) * rstd - ref).abs().max()) <= 1e-6


def test_generate_kv_fused_equals_jax_at_c200():
    """generate_kv(decode_impl='fused') at C 200 in heads of 25 (its
    blocks through BlockDecodeStack, plain on the CPU): greedy ids equal
    JAX's fused sampler's (its Pallas kernel in interpret mode)."""
    jm, params, port = _jax_model(200, 8, n_blocks=2)
    ids = np.full((2, 1), 32, np.int32)
    ref = jm.generate_kv(params, jnp.asarray(ids), do_sample=False,
                         num_steps=12, decode_impl="fused")
    out = port.generate_kv(torch.from_numpy(ids), do_sample=False,
                           num_steps=12, decode_impl="fused")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- #9 on bf16: the wide tile ------------------------------------------------

def wide_tile_attention(q, k, v) -> torch.Tensor:
    """Causal softmax(q k^T / sqrt(D)) v as the wide bf16 tile computes
    it (D past 128): per block of 64 query rows laid from the end of T
    and per 64-key stage, the head's 128-column chunks in order, each
    into a fresh accumulator through its k16 steps (each step's 16 exact
    products added and truncated to f32; the head padded with zeros to
    16 columns), added to the f32 scores with one rounded add; then the
    online softmax and P V on three bf16 terms of P, 16 keys a product,
    for each 128-column piece alike (the pieces share the scores, so one
    pass gives every piece's). q, k, v (B, H, T, D): bf16 values in f32;
    returns bf16."""
    b, h, t, d = q.shape
    hd = -(-d // 16) * 16
    q, k, v = (torch.nn.functional.pad(z, (0, hd - d)) for z in (q, k, v))
    sm_scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    out = torch.zeros(b, h, t, hd)
    for z in range(math.ceil(t / 64)):
        rows = torch.arange(t - 64 * (z + 1), t - 64 * z)
        valid = rows >= 0
        lim = rows.clamp(min=0)
        qb = q[:, :, lim]
        m = torch.full((b, h, 64, 1), -math.inf)
        l = torch.zeros(b, h, 64, 1)
        o = torch.zeros(b, h, 64, hd)
        for k0 in range(0, int(rows[-1]) + 1, 64):
            kt = torch.zeros(b, h, 64, hd)
            vt = torch.zeros(b, h, 64, hd)
            n = min(64, t - k0)
            kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
            s = torch.zeros(b, h, 64, 64)
            for e0 in range(0, hd, PIECE):
                acc = torch.zeros(b, h, 64, 64)
                for e in range(e0, min(hd, e0 + PIECE), 16):
                    acc = trunc32(acc.double() + qb[..., e:e + 16].double()
                                  @ kt[..., e:e + 16].double().transpose(
                                      -1, -2))
                s = s + acc
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


@pytest.mark.parametrize("d", [192, 300])
def test_wide_bf16_tile_matches_jax_and_plain(d):
    """The wide bf16 tile's arithmetic at heads of 192 and 300 (T = 70,
    two heads): within the bf16 gate of the JAX kernel in interpret mode
    and of the plain version."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy((rng.standard_normal((1, 2, 70, d)) * sc)
                                .astype(np.float32)).to(torch.bfloat16)
               for sc in (1.0, 1.0, 1.0))
    tile = wide_tile_attention(q.float(), k.float(), v.float())
    jax_out = pallas_attn.flash_causal_attention(
        *(jnp.asarray(z.float().numpy()).astype(jnp.bfloat16)
          for z in (q, k, v)))
    for ref in (torch.from_numpy(np.array(jax_out.astype(jnp.float32)))
                .to(torch.bfloat16),
                fused_attn.flash_causal_attention_reference(q, k, v)):
        share, far = gate(tile, ref)
        assert far == 0 and share <= MAX_SHARE, (share, far)
    assert torch.equal(bf16(tile.float()), tile.float())
