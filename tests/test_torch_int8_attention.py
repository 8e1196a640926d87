"""The int8 attention of kernels #2 and #6 (`int8_attn=True`) on the CPU.

Its two kernels (csrc/attention_int8.cuh) run only on the card: a
per-head quantizing pass that writes the int8 operands once in the
tensor cores' layout (`qkv8`), and a causal attention whose two products
are s8 x s8 -> s32 `mma.sync` on those operands. Here the pass's plain
version (`ops/fused_block_quant.py::quantize_heads_reference`) is held
bit for bit against the JAX package's per-head `_q8` with 127 / absmax
(`pallas_block_quant.py:55-57, 120-136`), and the attention tile's
arithmetic is emulated in plain PyTorch as the kernel walks T: 64-query
tiles, 64-key stages, a warp's 16 rows skipping the 8-key blocks past
its last row and past T, pass 1 for the row max (of the integer scores, scaled once), pass 2
for p, its sum l
and p8, P@V on v8 in the stored key order, and l summed in the kernel's
order (a thread's keys in walk order, then (l0 + l1) + (l2 + l3) over
the four threads of a row).

Tolerances. The scores and P@V are integer sums: exactly equal to the
plain version's (`attention_core_reference(int8_attn=True)`). Only l is
summed in another order, so y8 may move by one step in at most 1e-3 of
entries (the int8 kernels' contract), and the f32 output by 1e-5 (an ulp
of l at outputs below 10). Against JAX's `_attn_core(int8_attn=True)`
the same 1e-5 and the same y8 contract (its exp may differ by an ulp).
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.ops import pallas_block_quant as jbq
from vq_vae_transformer_arc_welding_tpu_torch import kernels
from vq_vae_transformer_arc_welding_tpu_torch.ops import (
    fused_attn_quant as fattn, fused_block_quant as fbq)
from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
    merge_heads, split_heads)
from vq_vae_transformer_arc_welding_tpu_torch.ops.int8 import (
    int8_bmm, quantize_act)

REPO = Path(__file__).resolve().parent.parent
HEADER = kernels.SRC_DIR / "attention_int8.cuh"
HD = 64                         # the bench model's head width: the tile
                                # of 64, unpadded (qkv8 rows of HD bytes)
TT = fbq.T_TILE
WROWS = 16                      # query rows a warp
T_CASES = [1, 45, 63, 64, 65, 321]
Y_SCALE = 127.0 / 3.0           # y of order 1 quantized to its range
INT_MIN = torch.iinfo(torch.int32).min


def _qkv(b, t, n_head, seed):
    """(B, T, 3C) f32 from numpy: q, k, v of order 1 to 3, each head at
    its own spread so that the per-head scales differ."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 3, n_head, HD)).astype(np.float32)
    x *= rng.uniform(0.5, 3.0, (1, 1, 3, n_head, 1)).astype(np.float32)
    return torch.from_numpy(x.reshape(b, t, 3 * n_head * HD))


def _unpack(qkv8, t):
    """q8, k8, v8 (B, n_head, T, 64) int8 in key order, from qkv8."""
    b, n_head, _, n = qkv8.shape
    tp = n // HD
    q8, k8 = (qkv8[:, :, i].reshape(b, n_head, tp, HD)[:, :, :t]
              for i in (0, 1))
    vt = qkv8[:, :, 2].reshape(b, n_head, HD, tp // 32, 32)
    v8 = torch.empty_like(vt)
    v8[..., fbq.v_key_order()] = vt
    return q8, k8, v8.reshape(b, n_head, HD, tp).transpose(-1, -2)[:, :, :t]


def _header_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         HEADER.read_text()).group(1))


def _visited(t, q0, k0):
    """(64, 64) bool: the (row, key) pairs of query tile q0 and key tile
    k0 whose scores the kernel computes, mirrored from
    attention_int8_kernel: a warp takes 16 rows from r0 and skips the
    tile when k0 > r0 + 15, else keeps its first jn 8-key blocks."""
    out = torch.zeros(TT, TT, dtype=torch.bool)
    for w in range(TT // WROWS):
        r0 = q0 + WROWS * w
        if k0 > r0 + 15:
            continue
        jn = min(8, (r0 + 15 - k0) // 8 + 1, (t - k0 + 7) // 8)
        out[WROWS * w:WROWS * (w + 1), :8 * jn] = True
    return out


def emulate(qkv, n_head, y_scale):
    """The kernels' arithmetic on qkv (B, T, 3C) f32: returns the int32
    scores (B, n_head, T, T) where computed and causal (0 elsewhere), the
    int32 P@V sums o (B, n_head, T, 64), l (B, n_head, T), y (B, T, C)
    f32 and y8 = q8(y, y_scale)."""
    b, t, _ = qkv.shape
    tp = fbq.padded_t(t)
    qkv8, hs = fbq.quantize_heads_reference(qkv, n_head)
    q8 = qkv8[:, :, 0].reshape(b, n_head, tp, HD).int()
    k8 = qkv8[:, :, 1].reshape(b, n_head, tp, HD).int()
    vt = qkv8[:, :, 2].reshape(b, n_head, HD, tp).int()
    sq, sk, sv = (hs[:, i, :, None, None] for i in range(3))
    factor = torch.full_like(sq, fattn.sm_scale(n_head * HD, n_head)) / (
        sq * sk)
    keys = torch.arange(TT)
    pos = keys // 32 * 32 + fbq.v_key_order()[keys % 32]  # key at position
    s_all = torch.zeros(b, n_head, tp, tp, dtype=torch.int32)
    o = torch.zeros(b, n_head, tp, HD, dtype=torch.int32)
    l = torch.zeros(b, n_head, tp)
    for q0 in range(0, t, TT):
        rows = torch.arange(q0, q0 + TT)[:, None]
        n_kt = -(-min(t, q0 + TT) // TT)
        smax = torch.full((b, n_head, TT, 1), INT_MIN)
        lanes = torch.zeros(b, n_head, TT, 4)      # l of threads tg = 0..3
        for pass2 in (False, True):
            for k0 in range(0, n_kt * TT, TT):
                s = q8[:, :, q0:q0 + TT] @ k8[:, :, k0:k0 + TT].transpose(
                    -1, -2)
                kj = torch.arange(k0, k0 + TT)[None, :]
                ok = _visited(t, q0, k0) & (kj <= rows) & (kj < t)
                x = s.float() * factor
                if not pass2:
                    s_all[:, :, q0:q0 + TT, k0:k0 + TT] = torch.where(ok, s, 0)
                    smax = torch.maximum(smax, torch.where(
                        ok, s, INT_MIN).amax(-1, keepdim=True))
                    mx = smax.float() * factor   # the largest s, scaled once
                    continue
                p = torch.where(ok, torch.exp(x - mx), 0.0)
                blocks = p.reshape(b, n_head, TT, 8, 4, 2)
                for j in range(8):
                    for i in range(2):
                        lanes += blocks[..., j, :, i]
                p8 = quantize_act(p, 127.0)
                o[:, :, q0:q0 + TT] += p8[..., pos].int() @ vt[
                    ..., k0:k0 + TT].transpose(-1, -2)
        l[:, :, q0:q0 + TT] = ((lanes[..., 0] + lanes[..., 1])
                               + (lanes[..., 2] + lanes[..., 3]))
    y = o.float() / (127.0 * sv) / l[..., None]
    y = merge_heads(y[:, :, :t])
    return (s_all[:, :, :t, :t], o[:, :, :t], l[:, :, :t], y,
            quantize_act(y, y_scale))


def _plain_integers(qkv, n_head):
    """attention_core_reference(int8_attn=True)'s own integer steps:
    the int32 scores (causal, 0 above the diagonal) and P@V sums."""
    c = qkv.shape[-1] // 3
    t = qkv.shape[1]
    q, k, v = (split_heads(z, n_head) for z in qkv.split(c, dim=-1))
    sq, sk, sv = fattn._scale127(q), fattn._scale127(k), fattn._scale127(v)
    s32 = int8_bmm(quantize_act(q, sq), quantize_act(k, sk).transpose(-1, -2))
    s = s32.float() * (torch.full_like(sq, fattn.sm_scale(c, n_head))
                       / (sq * sk))
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = int8_bmm(quantize_act(p, 127.0), quantize_act(v, sv))
    return torch.where(causal, s32, 0), o


def _int8_close(out, ref, frac=1e-3):
    diff = (out.int() - ref.int()).abs()
    assert diff.max() <= 1 and (diff != 0).float().mean() <= frac, (
        int(diff.max()), float((diff != 0).float().mean()))


# -- layout -----------------------------------------------------------------

def test_header_constants_match():
    """The tile and the key order as the kernels compile them."""
    text = HEADER.read_text()
    assert "static_assert(HD == 32 || HD == 64 || HD == 128" in text
    assert [fbq.qkv8_head_width(w * n, n) for n, w in (
        (8, 64), (8, 24), (1, 32), (2, 33), (4, 128), (64, 1))] == [
            HD, 32, 32, 64, 128, 32]
    assert _header_int("TT") == TT
    assert _header_int("WARPS") * WROWS == TT
    expr = re.search(r"constexpr int key_of\(int p\) \{\s*return ([^;]+);",
                     HEADER.read_text()).group(1).replace("/", "//")
    assert [eval(expr, {"p": p}) for p in range(32)] == \
        fbq.v_key_order().tolist()


def test_v_key_order_is_the_accumulator_layout():
    """mma.m16n8k32's accumulator gives lane (g, tg) keys 8 j + 2 tg + i
    (i = 0, 1) of each 8-key block j; the kernel packs block j of a
    32-key step into register j // 2 * 2 (+1 for row g + 8), bytes
    j % 2 * 2 + i; the s8 A fragment reads register r, byte y as k
    position 16 (r // 2) + 4 tg + y. The key stored at each position
    must be the key the accumulator gave that byte."""
    order = fbq.v_key_order()
    assert sorted(order.tolist()) == list(range(32))
    for tg in range(4):
        for j in range(4):
            for i in range(2):
                reg, byte = j // 2 * 2, j % 2 * 2 + i
                position = 16 * (reg // 2) + 4 * tg + byte
                assert order[position] == 8 * j + 2 * tg + i


@pytest.mark.parametrize("t", [1, 2, 15, 16, 17, 63, 64, 65, 127, 128, 129,
                               200, 320, 321, 322, 385, 700])
def test_walk_covers_the_causal_scores_once(t):
    """Every (row, key) with key <= row < T is computed in exactly one
    (query tile, key tile) and every other computed pair is masked: the
    grid's tiles, each tile's n_kt key tiles and the warps' skips."""
    tp = fbq.padded_t(t)
    seen = torch.zeros(tp, tp, dtype=torch.int32)
    for q0 in range(0, t, TT):
        n_kt = -(-min(t, q0 + TT) // TT)
        for k0 in range(0, n_kt * TT, TT):
            seen[q0:q0 + TT, k0:k0 + TT] += _visited(t, q0, k0).int()
    causal = torch.zeros(tp, tp, dtype=torch.int32)
    causal[:t, :t] = torch.ones(t, t, dtype=torch.int32).tril()
    assert seen.max() <= 1
    assert bool((seen >= causal).all())
    assert tp == -(-t // 64) * 64


# -- the quantizing pass ----------------------------------------------------

@pytest.mark.parametrize("t", T_CASES)
def test_quantize_heads_matches_jax_q8(t):
    """Bit-equal int8 operands and equal scales, per (batch, q/k/v,
    head), to JAX's 127 / max(absmax, 1e-6) and _q8."""
    n_head = 2
    qkv = _qkv(2, t, n_head, seed=t)
    qkv8, hs = fbq.quantize_heads_reference(qkv, n_head)
    assert qkv8.shape == (2, n_head, 3, fbq.padded_t(t) * HD)
    assert qkv8.dtype == torch.int8 and hs.shape == (2, 3, n_head)
    got = _unpack(qkv8, t)
    x = qkv.numpy().reshape(2, t, 3, n_head, HD)
    for b in range(2):
        for which in range(3):
            for h in range(n_head):
                z = jnp.asarray(x[b, :, which, h])
                s = 127.0 / jnp.maximum(jnp.max(jnp.abs(z)), 1e-6)
                assert np.float32(hs[b, which, h]) == np.asarray(s)
                np.testing.assert_array_equal(
                    got[which][b, h].numpy(), np.asarray(jbq._q8(z, s)))


@pytest.mark.parametrize("t", [1, 45, 63, 65, 321])
def test_quantize_heads_zero_past_t(t):
    """q8 and k8 rows and v8's key positions past T are zero, and v8's
    positions hold the keys of v_key_order() (a head of v = key index)."""
    n_head, tp = 1, fbq.padded_t(t)
    qkv = torch.zeros(1, t, 3 * HD)
    qkv[0, :, :2 * HD] = 1.0 + torch.rand(t, 2 * HD)
    qkv[0, :, 2 * HD:] = torch.arange(1, t + 1, dtype=torch.float32)[:, None]
    qkv8, _ = fbq.quantize_heads_reference(qkv, n_head)
    q8, k8 = (qkv8[0, 0, i].reshape(tp, HD) for i in (0, 1))
    vt = qkv8[0, 0, 2].reshape(HD, tp)
    assert bool((q8[t:] == 0).all()) and bool((k8[t:] == 0).all())
    assert bool((q8[:t] != 0).all()) and bool((k8[:t] != 0).all())
    keys = (torch.arange(tp) // 32 * 32
            + fbq.v_key_order()[torch.arange(tp) % 32])
    want = quantize_act(torch.where(keys < t, keys + 1.0, 0.0),
                        127.0 / t)
    assert torch.equal(vt, want.expand(HD, tp))


def test_quantize_heads_zero_head():
    """A head of zeros: scale 127 / 1e-6 and zero operands, as JAX."""
    qkv = _qkv(1, 9, 2, seed=1)
    qkv[..., HD:2 * HD] = 0.0                   # q of head 1
    qkv8, hs = fbq.quantize_heads_reference(qkv, 2)
    assert np.float32(hs[0, 0, 1]) == np.float32(127.0) / np.float32(1e-6)
    assert bool((_unpack(qkv8, 9)[0][0, 1] == 0).all())


def test_attn_scratch_holds_the_int8_operands():
    """The wrappers' scratch: qkv8 and the scales only with int8_attn."""
    sc = fbq._attn_scratch(2, 45, 128, 2, True, torch.device("cpu"))
    assert sc[3].shape == (2, 3, 2) and sc[4].shape == (2, 2, 3, 64 * HD)
    assert sc[4].dtype == torch.int8
    sc = fbq._attn_scratch(2, 45, 128, 2, False, torch.device("cpu"))
    assert sc[3].numel() == 1 and sc[4].numel() == 1


# -- the attention tile -------------------------------------------------------

@pytest.mark.parametrize("n_head", [1, 2])
@pytest.mark.parametrize("t", T_CASES)
def test_emulation_integers_equal_plain(t, n_head):
    """Scores and P@V from the kernel's layout and walk equal the plain
    version's integer sums exactly."""
    qkv = _qkv(2, t, n_head, seed=100 + t)
    s32, o, _, _, _ = emulate(qkv, n_head, Y_SCALE)
    s_ref, o_ref = _plain_integers(qkv, n_head)
    assert torch.equal(s32, s_ref)
    assert torch.equal(o, o_ref)


@pytest.mark.parametrize("t", T_CASES)
def test_emulation_matches_attention_core_reference(t):
    """y within 1e-5 and y8 within one step in 1e-3 of entries of the
    plain version: only l's order differs."""
    n_head = 2
    qkv = _qkv(2, t, n_head, seed=200 + t)
    _, _, l, y, y8 = emulate(qkv, n_head, Y_SCALE)
    ref = fattn.attention_core_reference(qkv, n_head, int8_attn=True)
    assert bool(torch.isfinite(y).all()) and bool((l >= 1.0).all())
    assert float((y - ref).abs().max()) <= 1e-5
    _int8_close(y8, quantize_act(ref, Y_SCALE))


@pytest.mark.parametrize("t", [1, 45, 65, 321])
def test_emulation_matches_jax_attn_core(t):
    """Against pallas_block_quant._attn_core(int8_attn=True), one batch
    row at a time as tests/test_torch_kernels.py runs it, at two heads
    of 64."""
    n_head = 2
    qkv = _qkv(2, t, n_head, seed=300 + t)
    _, _, _, y, y8 = emulate(qkv, n_head, Y_SCALE)
    sm = fattn.sm_scale(n_head * HD, n_head)
    ref = np.stack([np.asarray(jbq._attn_core(jnp.asarray(row), n_head, HD,
                                              t, sm, int8_attn=True))
                    for row in qkv.numpy()])
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-5)
    _int8_close(y8, quantize_act(torch.from_numpy(ref), Y_SCALE))


@pytest.mark.parametrize("seed", range(4))
def test_scaled_max_is_the_max_scaled(seed):
    """Pass 1 keeps the largest integer score and scales it once: f32
    rounding is monotonic, so fl(max s * f) = max fl(s * f) for f > 0,
    here over scores up to 64 * 127^2 and factors over 40 binades."""
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.integers(-64 * 127 ** 2, 64 * 127 ** 2 + 1,
                                      (64, 321), dtype=np.int32))
    f = torch.from_numpy((10.0 ** rng.uniform(-18, 2, (64, 1))).astype(
        np.float32))
    assert torch.equal((s.float() * f).amax(-1),
                       s.amax(-1).float() * f[:, 0])


def test_emulation_l_order_is_the_kernels():
    """l is summed per thread in walk order and then as (l0 + l1) +
    (l2 + l3): on p spread over many binades, the emulation's l is that
    order's f32 sum, bit for bit."""
    t = 128
    qkv = torch.zeros(1, t, 3 * HD)
    qkv[0, :, :HD] = 1.0
    # scores spread over many binades: keys alternate large and tiny p
    qkv[0, :, HD:2 * HD] = torch.where(torch.arange(t)[:, None] % 3 == 0,
                                       1.0, -torch.rand(t, 1) * 30)
    _, _, l, _, _ = emulate(qkv, 1, Y_SCALE)
    qkv8, hs = fbq.quantize_heads_reference(qkv, 1)
    q8, k8, _ = _unpack(qkv8, t)
    s = (q8[0, 0].int() @ k8[0, 0].int().T).float() * (
        torch.full_like(hs[0, 0, 0], fattn.sm_scale(HD, 1))
        / (hs[0, 0, 0] * hs[0, 1, 0]))
    row = t - 1
    p = torch.exp(s[row] - s[row].max())
    lanes = [torch.tensor(0.0) for _ in range(4)]
    for key in range(t):
        lanes[key % 8 // 2] = lanes[key % 8 // 2] + p[key]
    want = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    assert float(l[0, 0, row]) == float(want)


# -- chip_smoke's bounds and checks ---------------------------------------

def test_chip_smoke_int8_attention_bounds_at_batch_80():
    """kernel_work's bounds of the int8 attention alone and of its
    quantizing pass at the bench model's batch 80 (T = 321, C = 512, 8
    heads): 8.47 G int8 operations and 52.6 MB (bytes bound, 0.0157 ms);
    the f32 qkv read and the int8 operands written, 197.2 MB (0.0589)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    work = chip_smoke.kernel_work(25600, 512, 4, 8, 25, 32, 256, 80, 321, 8,
                                  16, 160)
    m, c, scales = 80 * 321, 512, 80 * 3 * 8 * 4
    ops = 80 * 8 * (321 * 322 // 2) * 64 * 4
    assert ops == 8_467_415_040
    attn = work[chip_smoke.INT8_ATTENTION]
    quant = work[chip_smoke.QUANT_PASS]
    assert attn == (4 * m * c + scales, {"int8": ops})
    assert quant == (3 * m * c * 4 + 3 * m * c + scales, {})
    assert [round(v, 4) if isinstance(v, float) else v
            for v in chip_smoke.bound_of(attn)] == [0.0157, "bytes"]
    assert [round(v, 4) if isinstance(v, float) else v
            for v in chip_smoke.bound_of(quant)] == [0.0589, "bytes"]


def test_chip_smoke_reads_the_int8_attention():
    """chip_smoke reports on both kernels (ptxas, traces) and requires
    the s8 product in int8_block.cu's PTX; the kernel source runs its
    products there and nowhere on the FP32 cores."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    assert {chip_smoke.QUANT_PASS, chip_smoke.INT8_ATTENTION} <= set(
        chip_smoke.PTXAS_KERNELS)
    s8 = "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32"
    assert s8 in chip_smoke.PTX_OPS["int8_block.cu"]
    text = HEADER.read_text()
    assert s8 in text and "fmaf" not in text
    for name in (chip_smoke.QUANT_PASS, chip_smoke.INT8_ATTENTION):
        assert f"\n{name}(" in text
    block = (kernels.SRC_DIR / "int8_block.cu").read_text()
    assert '#include "attention_int8.cuh"' in block
    assert "head_absmax_kernel" not in block and "score_tile" not in block
