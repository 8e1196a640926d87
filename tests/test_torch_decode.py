"""The port's decode and attention kernels' modules against the JAX package.

ops/fused_decode.py (kernels #12 and #13) and ops/fused_attn.py (kernel
#9) on the CPU, where each wrapper runs its plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode, as the JAX package's
own tests do (tests/test_quantized.py:334, tests/test_pallas.py).
Tolerances are the JAX tests' own: 1e-5 on the residual stream (both
f32, other summation orders, the bias folded into the product on the
JAX side), 1e-6 on the cache rows; rtol 1e-4 / atol 1e-5 for the fused
attention. tests/test_torch_cuda.py holds the kernel-against-plain
tests that need the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models import (
    TransformerDecoder as JaxTransformerDecoder)
from vq_vae_transformer_arc_welding_tpu.ops import (attention as jattention,
                                                    pallas_attn, pallas_decode)
from vq_vae_transformer_arc_welding_tpu_torch import bridge, entry
from vq_vae_transformer_arc_welding_tpu_torch.ops import (attention,
                                                          fused_attn,
                                                          fused_decode)

import torch_port_helpers as H

B, HEADS, C = 3, 4, 32
D = C // HEADS


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


# -- kernels #12 and #13 -------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 5, 10])
def test_fused_decode_attn_matches_jax_kernel(rng, pos):
    _, params = H.jax_transformer()
    port = H.port_transformer()
    t = 11
    kc = rng.standard_normal((B, HEADS, t, D)).astype(np.float32)
    vc = rng.standard_normal((B, HEADS, t, D)).astype(np.float32)
    x = rng.standard_normal((B, 1, C)).astype(np.float32)
    ref, rk, rv = pallas_decode.fused_decode_attn(
        jnp.asarray(x), params["blocks"][0], jnp.asarray(kc),
        jnp.asarray(vc), pos, n_head=HEADS)
    pk, pv = _t(kc), _t(vc)
    out, ok, ov = fused_decode.fused_decode_attn(
        _t(x), port.blocks[0], pk, pv, pos, n_head=HEADS)
    assert ok is pk and ov is pv            # updated in place
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-5)
    for got, want, before in ((pk, rk, kc), (pv, rv, vc)):
        np.testing.assert_allclose(_np(got)[:, :, :pos + 1],
                                   np.asarray(want)[:, :, :pos + 1], rtol=0,
                                   atol=1e-6)
        rest = np.arange(t) != pos          # every other row untouched
        np.testing.assert_array_equal(_np(got)[:, :, rest], before[:, :, rest])


@pytest.mark.parametrize("pos", [0, 5, 10, 127])
def test_fused_block_decode_matches_jax_kernel(rng, pos):
    """JAX's cache length must be a multiple of 128; the port takes any.
    JAX's 8-row write-back window zeroes V rows past `pos`, so only rows
    <= pos compare; the port leaves every row but `pos` as it was."""
    _, params = H.jax_transformer()
    port = H.port_transformer()
    t = 128
    kc = rng.standard_normal((B, t, C)).astype(np.float32)
    vc = rng.standard_normal((B, t, C)).astype(np.float32)
    x = rng.standard_normal((B, 1, C)).astype(np.float32)
    ref, rk, rv = pallas_decode.fused_block_decode(
        jnp.asarray(x), params["blocks"][1], jnp.asarray(kc),
        jnp.asarray(vc), pos, n_head=HEADS)
    pk, pv = _t(kc), _t(vc)
    out, ok, ov = fused_decode.fused_block_decode(
        _t(x), port.blocks[1], pk, pv, pos, n_head=HEADS)
    assert ok is pk and ov is pv
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-5)
    for got, want, before in ((pk, rk, kc), (pv, rv, vc)):
        np.testing.assert_allclose(_np(got)[:, :pos + 1],
                                   np.asarray(want)[:, :pos + 1], rtol=0,
                                   atol=1e-6)
        rest = np.arange(t) != pos
        np.testing.assert_array_equal(_np(got)[:, rest], before[:, rest])


def test_fused_block_decode_takes_any_cache_length(rng):
    """No multiple-of-128 rule: a 33-row cache, against the block body of
    the port's own `_token_step`."""
    port = H.port_transformer()
    t, pos = H.SEQ_LEN, 20
    kc = _t(rng.standard_normal((B, HEADS, t, D)).astype(np.float32))
    vc = _t(rng.standard_normal((B, HEADS, t, D)).astype(np.float32))
    x = _t(rng.standard_normal((B, 1, C)).astype(np.float32))
    blk = port.blocks[0]
    flat_k = attention.merge_heads(kc).contiguous()
    flat_v = attention.merge_heads(vc).contiguous()
    out, _, _ = fused_decode.fused_block_decode(x, blk, flat_k, flat_v, pos,
                                                n_head=HEADS)
    mid, _, _ = fused_decode.fused_decode_attn(x, blk, kc, vc, pos,
                                               n_head=HEADS)
    from vq_vae_transformer_arc_welding_tpu_torch.models.transformer import (
        linear)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import (
        new_gelu)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    h = layer_norm(mid, blk.ln_2.weight, blk.ln_2.bias)
    ref = mid + linear(new_gelu(linear(h, blk.mlp.c_fc)), blk.mlp.c_proj)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(attention.merge_heads(kc)), _np(flat_k))


def test_generate_kv_fused_equals_jax_and_the_xla_step():
    jm, params = H.jax_transformer()
    port = H.port_transformer()
    prompt = np.random.default_rng(3).integers(0, H.K, (3, 4)).astype(
        np.int32)
    ref = jm.generate_kv(params, jnp.asarray(prompt), do_sample=False,
                         num_steps=12, decode_impl="fused")
    fused = port.generate_kv(_t(prompt), do_sample=False, num_steps=12,
                             decode_impl="fused")
    plain = port.generate_kv(_t(prompt), do_sample=False, num_steps=12)
    np.testing.assert_array_equal(_np(fused), np.asarray(ref))
    np.testing.assert_array_equal(_np(fused), _np(plain))


def test_generate_kv_fused_goes_through_the_wrapper(monkeypatch):
    """n_blocks calls per KV step, prompt cases included: the recompute
    tail makes none."""
    port = H.port_transformer()
    calls = []
    real = fused_decode.fused_block_decode

    def spy(x, blk, kc, vc, pos, *, n_head):
        calls.append(pos)
        return real(x, blk, kc, vc, pos, n_head=n_head)

    monkeypatch.setattr(fused_decode, "fused_block_decode", spy)
    start = torch.full((2, 1), H.K, dtype=torch.int32)
    port.generate_kv(start, num_steps=H.SEQ_LEN + 5, decode_impl="fused")
    n_kv = H.SEQ_LEN            # seq_len - t0 + 1 with t0 = 1
    want = [min(1 + i, H.SEQ_LEN - 1) for i in range(n_kv) for _ in range(2)]
    assert calls == want


@pytest.mark.parametrize("fn", ["fused_decode_attn", "fused_block_decode"])
def test_decode_wrappers_refuse_other_devices(fn):
    port = H.port_transformer()
    x = torch.zeros(2, 1, C, device="meta")
    cache = torch.zeros(2, 8, C, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        getattr(fused_decode, fn)(x, port.blocks[0], cache, cache, 0,
                                  n_head=HEADS)


def _block_stack(c=128, n_head=2, n_blocks=2, b=2, t=9):
    """A CPU model at a width the card's #13 takes, and (B, T, C) caches."""
    _, tr = entry.build(d_model=c, n_blocks=n_blocks, n_heads=n_head,
                        hidden=64, n_res=1, k=32, d=16, seed=0,
                        device="cpu")
    caches = [(torch.zeros(b, t, c), torch.zeros(b, t, c))
              for _ in range(n_blocks)]
    return tr, caches


def test_block_decode_stack_check_raises_before_any_launch():
    """The checks that BlockDecodeStack runs once a generation
    (check_stack) and once a token (check_step) refuse, on CPU tensors,
    each operand that tests/test_torch_cuda.py::
    test_decode_wrappers_reject_bad_operands gives the card; #12's
    layout and device cases through its wrapper's check."""
    tr, caches = _block_stack()
    blocks = list(tr.blocks)
    x = torch.zeros(2, 1, 128)
    heads = [tuple(torch.zeros(2, 2, 9, 64) for _ in range(2))] * 2
    fused_decode.check_stack(blocks, caches, n_head=2)
    fused_decode.check_step(x, 8, caches)
    bad = [
        lambda: fused_decode.check_step(x, 9, caches),           # pos == T
        lambda: fused_decode.check_step(x, -1, caches),
        lambda: fused_decode.check_step(x, torch.tensor(3), caches),
        lambda: fused_decode.check_stack(blocks, heads, n_head=2),  # layout
        lambda: fused_decode.check_stack(
            blocks, [tuple(z.bfloat16() for z in kv) for kv in caches],
            n_head=2),
        lambda: fused_decode.check_stack(blocks, caches, n_head=3),  # 128/3
        lambda: fused_decode.check_step(x.expand(2, 2, 128), 0, caches),
        lambda: fused_decode._checked(
            "decode_attn_f32", x, blocks[0], *caches[0], (2, 2, 9, 64), 0,
            2, mlp=False),                                        # layout
        lambda: fused_decode._checked(
            "decode_attn_f32", x, blocks[0], heads[0][0],
            heads[0][1].to("meta"), (2, 2, 9, 64), 0, 2, mlp=False),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def test_block_decode_stack_runs_the_plain_blocks_on_cpu(rng):
    """On the CPU the stack takes each block through the plain version;
    its reference factory gives the same bits, caches written alike."""
    tr, caches = _block_stack(b=3, t=11)
    ref_caches = [tuple(z.clone() for z in kv) for kv in caches]
    x = _t(rng.standard_normal((3, 1, 128)).astype(np.float32))
    stack = fused_decode.BlockDecodeStack(tr.blocks, caches, n_head=2)
    plain = fused_decode.block_decode_stack_reference(tr.blocks, ref_caches,
                                                      n_head=2)
    for pos in (0, 1, 7):
        got, want = stack(x, pos), plain(x, pos)
        assert torch.equal(got, want)
        x = got
    for kv, ref in zip(caches, ref_caches):
        for z, r in zip(kv, ref):
            assert torch.equal(z, r)
            assert bool(z[:, :2].abs().sum() > 0)


# -- kernel #9 ------------------------------------------------------------------

def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 3, 16, 8), (1, 2, 37, 16)])
def test_flash_attention_matches_jax_kernel_and_core(rng, shape):
    q, k, v = _qkv(rng, shape)
    kernel = pallas_attn.flash_causal_attention(*map(jnp.asarray, (q, k, v)))
    core = jattention.causal_attention_core(*map(jnp.asarray, (q, k, v)))
    out = fused_attn.flash_causal_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(_np(out), np.asarray(kernel), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_np(out), np.asarray(core), rtol=1e-4,
                               atol=1e-5)


def test_flash_attention_gradients_match_the_core(rng):
    """tests/test_pallas.py:51-65: the backward recomputes through the
    plain core; gradients against the core's and against JAX's."""
    q, k, v = _qkv(rng, (2, 2, 9, 8))

    def loss(fn):
        leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
        (fn(*leaves) ** 2).sum().backward()
        return [_np(z.grad) for z in leaves]

    got = loss(fused_attn.flash_causal_attention)
    want = loss(attention.causal_attention_core)
    ref = jax.grad(lambda a, b, c: jnp.sum(
        pallas_attn.flash_causal_attention(a, b, c) ** 2), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_causal_self_attention_matches_jax(rng, impl):
    _, params = H.jax_transformer()
    port = H.port_transformer()
    x = rng.standard_normal((2, 13, C)).astype(np.float32)
    ref = jattention.causal_self_attention(
        jnp.asarray(x), params["blocks"][0]["attn"], n_head=HEADS, impl=impl)
    out = attention.causal_self_attention(_t(x), port.blocks[0].attn,
                                          n_head=HEADS, impl=impl)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_attention_impl_pallas_model_matches_xla_and_jax(monkeypatch):
    """The block body goes through the fused attention once per block;
    logits within 1e-4 of the 'xla' model's and of the JAX 'pallas'
    model's. `_prefill` keeps the plain core, as in JAX."""
    jm, params = H.jax_transformer()
    jp = JaxTransformerDecoder(**jm.hparams, attention_impl="pallas")
    port = bridge.transformer_from_jax(jm.hparams, params, device="cpu",
                                       attention_impl="pallas")
    assert port.attention_impl == "pallas"
    calls = []
    real = fused_attn.flash_causal_attention
    monkeypatch.setattr(fused_attn, "flash_causal_attention",
                        lambda *a: calls.append(1) or real(*a))
    ids = H.token_ids(3, seed=9)
    for generate in (True, False):
        calls.clear()
        out = port.apply(_t(ids), generate=generate)
        assert len(calls) == port.n_blocks
        plain = H.port_transformer().apply(_t(ids), generate=generate)
        ref, _ = jp.apply(params, None, jnp.asarray(ids), generate=generate)
        np.testing.assert_allclose(_np(out), _np(plain), rtol=0, atol=1e-4)
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0,
                                   atol=1e-4)
    calls.clear()
    start = _t(ids[:, :4])
    greedy = port.generate_kv(start, num_steps=6)
    assert calls == []                      # prefill and steps: plain core
    np.testing.assert_array_equal(
        _np(greedy), _np(H.port_transformer().generate_kv(start,
                                                          num_steps=6)))
    port.generate(start, num_steps=2)
    assert len(calls) == 2 * port.n_blocks  # the recompute loop: apply


def test_attention_impl_is_validated():
    with pytest.raises(ValueError, match="attention_impl"):
        entry.build(d_model=32, n_blocks=1, n_heads=4, hidden=16, n_res=1,
                    k=8, d=4, device="cpu", attention_impl="flash")
    _, tr = entry.build(d_model=32, n_blocks=1, n_heads=4, hidden=16,
                        n_res=1, k=8, d=4, device="cpu",
                        attention_impl="pallas")
    assert tr.attention_impl == "pallas"
    with pytest.raises(ValueError, match="impl"):
        attention.causal_self_attention(torch.zeros(1, 2, 32),
                                        tr.blocks[0].attn, n_head=4,
                                        impl="flash")


def test_flash_wrapper_refuses_other_devices():
    q = torch.zeros(1, 2, 5, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_attn.flash_causal_attention(q, q, q)
