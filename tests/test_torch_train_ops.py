"""The port's training ops against the JAX package on the CPU.

Forward outputs within 1e-5, and gradients (torch.autograd.grad against
jax.grad of the same scalar, a fixed random projection of the output)
within atol 1e-5 / rtol 1e-4, for the decoder's convs, the inverse patch
embedding with its BatchNorm, train-mode BatchNorm and the classic VQ
with its straight-through estimator; the VQ's kernel hook (#7) as the
JAX package's tests run it, in interpret mode. Then the dropout's
contract, and the attention's dropout rule: an impl='pallas' layer
takes the plain core under attention dropout and the kernel without.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.ops import attention as jatt
from vq_vae_transformer_arc_welding_tpu.ops import conv as jconv
from vq_vae_transformer_arc_welding_tpu.ops import norm as jnorm
from vq_vae_transformer_arc_welding_tpu.ops import patching as jpatch
from vq_vae_transformer_arc_welding_tpu.ops import vq as jvq
from vq_vae_transformer_arc_welding_tpu.ops.pallas_vq import (
    nearest_codes_pallas as j_nearest_pallas)
from vq_vae_transformer_arc_welding_tpu_torch.ops import attention as tatt
from vq_vae_transformer_arc_welding_tpu_torch.ops import conv as tconv
from vq_vae_transformer_arc_welding_tpu_torch.ops import fused_attn
from vq_vae_transformer_arc_welding_tpu_torch.ops import norm as tnorm
from vq_vae_transformer_arc_welding_tpu_torch.ops import patching as tpatch
from vq_vae_transformer_arc_welding_tpu_torch.ops import vq as tvq
from vq_vae_transformer_arc_welding_tpu_torch.ops.fused_vq import (
    nearest_codes_pallas)
from vq_vae_transformer_arc_welding_tpu_torch.utils.random import dropout

FWD = dict(rtol=0, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers' (the lane runs six processes on the host's
    cores), so these tests use one and give it back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def grads_both(j_fn, t_fn, inputs, seed=0):
    """(outputs, grads) of both packages for the scalar sum(out * P), P a
    random projection of out's shape; inputs: numpy arrays, all
    differentiated."""
    out = np.asarray(j_fn(*map(jnp.asarray, inputs)))
    proj = np.random.default_rng(seed).standard_normal(out.shape).astype(
        np.float32)
    j_grads = jax.grad(lambda *a: jnp.sum(j_fn(*a) * proj),
                       argnums=tuple(range(len(inputs))))(
        *map(jnp.asarray, inputs))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    t_out = t_fn(*ts)
    t_grads = torch.autograd.grad((t_out * torch.from_numpy(proj)).sum(), ts)
    return ((out, t_out.detach().numpy()),
            [(np.asarray(j), t.numpy()) for j, t in zip(j_grads, t_grads)])


@pytest.mark.parametrize("name, k", [("conv1d_same", 3),
                                     ("conv1d_same", 5),
                                     ("conv1d_same_im2col", 3),
                                     ("conv1d_same_im2col", 1)])
def test_decoder_convs_match_jax(name, k):
    """The port's one conv1d_same against both of the JAX package's
    formulations (a lax convolution and an im2col matmul)."""
    rng = np.random.default_rng(k)
    x, w, b = arr(rng, 3, 16, 12), arr(rng, 10, 12, k, scale=0.3), arr(rng, 10)
    (jo, to), grads = grads_both(getattr(jconv, name), tconv.conv1d_same,
                                 [x, w, b])
    assert to.shape == (3, 16, 10)
    np.testing.assert_allclose(to, jo, **FWD)
    for j, t in grads:
        np.testing.assert_allclose(t, j, **GRAD)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv1d_same_is_the_convolution(k):
    """The matmul is torch's own 'same' convolution, in float64 to the
    last bits."""
    rng = np.random.default_rng(3)
    x, w, b = (torch.from_numpy(a).double() for a in (
        arr(rng, 2, 16, 8), arr(rng, 8, 8, k, scale=0.3), arr(rng, 8)))
    want = torch.nn.functional.conv1d(x.transpose(1, 2), w, b,
                                      padding=(k - 1) // 2).transpose(1, 2)
    torch.testing.assert_close(tconv.conv1d_same(x, w, b), want,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["conv_transpose_stride_eq_kernel",
                                  "conv_transpose_block"])
def test_conv_transpose_matches_jax(name):
    rng = np.random.default_rng(4)
    x, w, b = arr(rng, 2, 16, 12), arr(rng, 12, 6, 5, scale=0.3), arr(rng, 6)
    j_fn = (jpatch.conv_transpose_stride_eq_kernel if name.endswith("kernel")
            else jconv.conv_transpose_block)
    t_fn = (tpatch.conv_transpose_stride_eq_kernel if name.endswith("kernel")
            else tconv.conv_transpose_block)
    (jo, to), grads = grads_both(j_fn, t_fn, [x, w, b])
    assert to.shape == (2, 80, 6)
    np.testing.assert_allclose(to, jo, **FWD)
    for j, t in grads:
        np.testing.assert_allclose(t, j, **GRAD)


def test_conv_transpose_matches_torch_conv_transpose1d():
    rng = np.random.default_rng(5)
    x, w, b = (torch.from_numpy(a) for a in (
        arr(rng, 2, 4, 6), arr(rng, 6, 3, 5), arr(rng, 3)))
    ref = torch.nn.functional.conv_transpose1d(x.transpose(1, 2), w, b,
                                               stride=5)
    torch.testing.assert_close(tpatch.conv_transpose_stride_eq_kernel(x, w, b),
                               ref.transpose(1, 2), rtol=0, atol=1e-5)


def _bn_inputs(rng, c):
    return (arr(rng, 4, 7, c, scale=2.0) + 1.0,
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.uniform(-0.2, 0.2, c).astype(np.float32),
            rng.uniform(-0.3, 0.3, c).astype(np.float32),
            rng.uniform(0.5, 2.0, c).astype(np.float32))


def test_batch_norm_train_matches_jax_and_torch():
    rng = np.random.default_rng(6)
    x, scale, bias, mean, var = _bn_inputs(rng, 12)
    st = jnorm.BatchNormState(jnp.asarray(mean), jnp.asarray(var))
    j_y, j_new = jnorm.batch_norm_apply(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(bias), st, train=True)
    t_y, (t_mean, t_var) = tnorm.batch_norm_train(
        *(torch.from_numpy(a) for a in (x, scale, bias, mean, var)))
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), **FWD)
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(j_new.mean), **FWD)
    np.testing.assert_allclose(t_var.numpy(), np.asarray(j_new.var), **FWD)
    assert not t_mean.requires_grad and not t_var.requires_grad
    # torch.nn.BatchNorm1d in train mode, channels first
    bn = torch.nn.BatchNorm1d(12)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    ref = bn.train()(torch.from_numpy(x).reshape(-1, 12))
    torch.testing.assert_close(t_y.reshape(-1, 12), ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(t_mean, bn.running_mean, rtol=0, atol=1e-6)
    torch.testing.assert_close(t_var, bn.running_var, rtol=0, atol=1e-6)

    def j_fn(x, s, b):
        return jnorm.batch_norm_apply(x, s, b, st, train=True)[0]

    def t_fn(x, s, b):
        return tnorm.batch_norm_train(x, s, b, torch.from_numpy(mean),
                                      torch.from_numpy(var))[0]

    _, grads = grads_both(j_fn, t_fn, [x, scale, bias])
    for j, t in grads:
        np.testing.assert_allclose(t, j, **GRAD)


@pytest.mark.parametrize("train", [True, False])
def test_patch_embed_inverse_matches_jax(train):
    rng = np.random.default_rng(7)
    h = 12
    x = arr(rng, 3, 16, h)
    p = {"ct1_kernel": arr(rng, h, h, 5, scale=0.3), "ct1_bias": arr(rng, h),
         "bn_scale": rng.uniform(0.5, 1.5, h).astype(np.float32),
         "bn_bias": arr(rng, h, scale=0.1),
         "ct2_kernel": arr(rng, h, 1, 5, scale=0.3), "ct2_bias": arr(rng, 1)}
    mean = rng.uniform(-0.3, 0.3, h).astype(np.float32)
    var = rng.uniform(0.5, 2.0, h).astype(np.float32)
    st = jnorm.BatchNormState(jnp.asarray(mean), jnp.asarray(var))
    names = list(p)
    kw = dict(patch_size=25, input_dim=2, train=train)

    def j_fn(x, *vals):
        return jpatch.patch_embed_inverse(x, dict(zip(names, vals)), st,
                                          **kw)[0]

    def t_fn(x, *vals):
        return tpatch.patch_embed_inverse(
            x, dict(zip(names, vals)),
            (torch.from_numpy(mean), torch.from_numpy(var)), **kw)[0]

    (jo, to), grads = grads_both(j_fn, t_fn, [x, *p.values()])
    assert to.shape == (3, 200, 2)
    np.testing.assert_allclose(to, jo, **FWD)
    for j, t in grads:
        np.testing.assert_allclose(t, j, **GRAD)
    _, j_new = jpatch.patch_embed_inverse(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, st, **kw)
    _, (t_mean, t_var) = tpatch.patch_embed_inverse(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        (torch.from_numpy(mean), torch.from_numpy(var)), **kw)
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(j_new.mean), **FWD)
    np.testing.assert_allclose(t_var.numpy(), np.asarray(j_new.var), **FWD)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_vq_quantize_matches_jax(impl):
    rng = np.random.default_rng(8)
    z, cb = arr(rng, 4, 16, 6), arr(rng, 24, 6)
    j_find = j_nearest_pallas if impl == "pallas" else None
    t_find = nearest_codes_pallas if impl == "pallas" else None
    j_out = jvq.vq_quantize(jnp.asarray(z), jnp.asarray(cb), 0.25,
                            nearest_fn=j_find)
    t_out = tvq.vq_quantize(torch.from_numpy(z), torch.from_numpy(cb), 0.25,
                            nearest_fn=t_find)
    np.testing.assert_array_equal(t_out.indices.numpy(),
                                  np.asarray(j_out.indices))
    assert t_out.indices.dtype == torch.int32
    for name in ("loss", "z_q", "perplexity"):
        np.testing.assert_allclose(getattr(t_out, name).numpy(),
                                   np.asarray(getattr(j_out, name)), **FWD,
                                   err_msg=name)
    assert len(np.unique(t_out.indices.numpy())) > 4

    # straight-through: the gradient of a loss of z_q reaches z as it is,
    # the embedding loss's reaches z and the codebook. The JAX kernel is
    # given its operands behind stop_gradient: jax.grad cannot trace a
    # pallas_call in interpret mode (its ids carry no gradient anyway)
    sg = jax.lax.stop_gradient
    j_find_sg = (None if j_find is None
                 else lambda zf, c: j_find(sg(zf), sg(c)))

    def j_fn(z, cb):
        out = jvq.vq_quantize(z, cb, 0.25, nearest_fn=j_find_sg)
        return out.z_q * 1.5 + out.loss

    def t_fn(z, cb):
        out = tvq.vq_quantize(z, cb, 0.25, nearest_fn=t_find)
        return out.z_q * 1.5 + out.loss

    _, grads = grads_both(j_fn, t_fn, [z, cb])
    for j, t in grads:
        np.testing.assert_allclose(t, j, **GRAD)


def test_vq_ids_carry_no_gradient():
    rng = np.random.default_rng(9)
    z = torch.tensor(arr(rng, 2, 16, 6), requires_grad=True)
    cb = torch.tensor(arr(rng, 12, 6), requires_grad=True)
    seen = []

    def find(zf, c):
        seen.append((zf.requires_grad, c.requires_grad))
        return tvq.nearest_codes(zf, c)

    out = tvq.vq_quantize(z, cb, nearest_fn=find)
    assert seen == [(False, False)]
    assert not out.indices.requires_grad and out.z_q.requires_grad
    g_z, = torch.autograd.grad(out.z_q.sum(), [z])
    torch.testing.assert_close(g_z, torch.ones_like(z))


def test_dropout_contract():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    assert dropout(x, 0.0, True, gen) is x
    assert dropout(x, 0.1, False, gen) is x
    p = 0.1
    state = gen.get_state()
    y = dropout(x, p, True, gen)
    kept = (y != 0).float().mean().item()
    sigma = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(kept - (1 - p)) < 3 * sigma
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                          1 / (1 - p)))
    gen.set_state(state)
    assert torch.equal(dropout(x, p, True, gen), y)
    assert not torch.equal(dropout(x, p, True, gen), y)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, p, True, None)
    # the gradient is the mask's scale
    xr = torch.ones(64, requires_grad=True)
    gen.manual_seed(1)
    yr = dropout(xr, 0.5, True, gen)
    g, = torch.autograd.grad(yr.sum(), [xr])
    torch.testing.assert_close(g, yr.detach())


def _attn_holder(rng, c):
    from types import SimpleNamespace
    w = lambda *s: torch.from_numpy(arr(rng, *s, scale=0.2))  # noqa: E731
    return SimpleNamespace(c_attn=SimpleNamespace(weight=w(3 * c, c),
                                                  bias=w(3 * c)),
                           c_proj=SimpleNamespace(weight=w(c, c), bias=w(c)))


def test_self_attention_train_without_dropout_matches_jax():
    rng = np.random.default_rng(10)
    c, heads = 32, 4
    x = arr(rng, 2, 9, c)
    attn = _attn_holder(rng, c)
    jp = {"c_attn_w": attn.c_attn.weight.numpy().T,
          "c_attn_b": attn.c_attn.bias.numpy(),
          "c_proj_w": attn.c_proj.weight.numpy().T,
          "c_proj_b": attn.c_proj.bias.numpy()}
    ref = jatt.causal_self_attention(jnp.asarray(x), jp, n_head=heads,
                                     resid_dropout_p=0.0, train=True)
    gen = torch.Generator().manual_seed(0)
    for impl in ("xla", "pallas"):
        out = tatt.causal_self_attention(torch.from_numpy(x), attn,
                                         n_head=heads, resid_dropout_p=0.0,
                                         train=True, generator=gen, impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("att_dropout, kernel_calls", [(0.0, 1), (0.2, 0)])
def test_pallas_attention_takes_the_plain_core_under_attention_dropout(
        monkeypatch, att_dropout, kernel_calls):
    """JAX's rule (ops/attention.py:68-76): the fused kernel has no
    dropout, so a 'pallas' layer with attention dropout at train time
    runs the plain core; without it, the kernel."""
    calls = []
    real = fused_attn.flash_causal_attention

    def counting(q, k, v):
        calls.append(q.shape)
        return real(q, k, v)

    monkeypatch.setattr(fused_attn, "flash_causal_attention", counting)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(arr(rng, 2, 9, 32))
    gen = torch.Generator().manual_seed(0)
    out = tatt.causal_self_attention(x, _attn_holder(rng, 32), n_head=4,
                                     attn_dropout_p=att_dropout,
                                     resid_dropout_p=0.1, train=True,
                                     generator=gen, impl="pallas")
    assert len(calls) == kernel_calls
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_attention_dropout_draws_from_the_generator():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(arr(rng, 2, 9, 32))
    attn = _attn_holder(rng, 32)

    def run(seed):
        return tatt.causal_self_attention(
            x, attn, n_head=4, attn_dropout_p=0.3, resid_dropout_p=0.3,
            train=True, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
    ev = tatt.causal_self_attention(x, attn, n_head=4, attn_dropout_p=0.3,
                                    resid_dropout_p=0.3, train=False)
    torch.testing.assert_close(ev, tatt.causal_self_attention(
        x, attn, n_head=4), rtol=0, atol=0)


def test_flash_kernel_reads_the_train_forwards_split_heads_in_place():
    """The training forward hands #9 q, k and v as split_heads views of
    one (B, T, 3C) qkv that needs gradients: one set of strides, each
    head's row contiguous, so the kernel reads them in place (no copy);
    a view with other strides would be copied first."""
    qkv = torch.randn(2, 9, 3 * 32, requires_grad=True)
    q, k, v = (tatt.split_heads(z, 4) for z in qkv.split(32, dim=-1))
    assert all(fused_attn._strided_ok(z, q) for z in (q, k, v))
    assert not fused_attn._strided_ok(k.contiguous(), q)
    out = fused_attn.flash_causal_attention(q, k, v)
    g, = torch.autograd.grad(out.sum(), [qkv])
    ref = tatt.causal_attention_core(q, k, v)
    g_ref, = torch.autograd.grad(ref.sum(), [qkv])
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(g, g_ref, rtol=0, atol=0)
