"""bf16 training of the port against the JAX package on the CPU.

The port's `compute_dtype=torch.bfloat16` on the VQ-VAE, the transformer
and the MLP, against the JAX models on the same weights and inputs, in
two ways:

- against JAX's exact-f32 run, within tests/test_mixed_precision.py's
  envelopes (losses within 5e-3 relative, gradients f32 and within 15%
  (VQ-VAE) or 10% (transformer) of each leaf's largest magnitude where
  its norm exceeds 1e-3, ids flipping on under 3% of the rows, MLP
  logits within rtol 0.05, atol 0.02);
- against JAX's bf16 run, within measured bounds stated at each test.
  The port's products sum in f32 as JAX's `preferred_element_type=f32`
  dots do; the port's backward rounds the incoming gradient to bf16
  before its two products (the JAX transpose keeps it f32), and the
  port's decoder conv is the im2col matmul, so the JAX VQ-VAE runs with
  conv_impl='im2col' there.

JAX's own bf16 training with attention_impl='pallas' cannot take a
step: its `custom_vjp` hands the f32 recompute a bf16 cotangent, which
jax.vjp refuses. So the port's bf16 'pallas' path is held against its
bf16 'xla' path (bit-equal on the CPU, where #9's wrapper runs its plain
version), and against JAX's 'xla' bf16 run; #9's bf16 plain form is held
against JAX's Pallas kernel on bf16 operands in interpret mode (the
forward), and its backward against JAX's core differentiated on the
same bf16 operands.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models import (MLP,
                                                       TransformerDecoder,
                                                       VQVAEPatch)
from vq_vae_transformer_arc_welding_tpu.ops.attention import (
    causal_attention_core as jax_core)
from vq_vae_transformer_arc_welding_tpu.ops.pallas_attn import (
    flash_causal_attention as jax_flash)
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.ops import fused_attn

BF16 = torch.bfloat16
VQ = dict(hidden_dim=64, input_dim=2, num_embeddings=32, embedding_dim=8,
          n_resblocks=2, learning_rate=1e-3, batch_norm=False, dropout_p=0.0)
TR = dict(d_model=64, n_classes=34, seq_len=33, n_blocks=2, n_head=4,
          res_dropout=0.0, att_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-12))


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict / list tree, in order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _port_grads_as_jax(to_state_dict, jax_grads, port_grads: dict):
    """[(JAX gradient leaf, the port's gradient in the JAX layout, its
    name)] for every JAX leaf whose port parameter has a gradient. The
    leaves are numbered element by element (1, 2, ... across the whole
    tree, exact in f32 at these sizes) and mapped through the bridge
    once: each port parameter's numbers say which JAX leaf and element
    each of its elements is."""
    leaves = [(path, np.asarray(leaf)) for path, leaf in _leaves(jax_grads)]
    starts = np.cumsum([0] + [a.size for _, a in leaves])
    tree = jax.tree_util.tree_map(
        lambda a: np.zeros(np.shape(a), np.float32), jax_grads)
    for (path, a), start in zip(leaves, starts):
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = (start + 1 + np.arange(a.size, dtype=np.float32)
                          ).reshape(a.shape)
    mapped = to_state_dict(tree)
    out = {}
    for name, grad in port_grads.items():
        if grad is None:
            continue
        pos = mapped[name].reshape(-1).numpy().astype(np.int64) - 1
        leaf = int(np.searchsorted(starts, pos[0], side="right")) - 1
        got = np.empty(leaves[leaf][1].size, np.float32)
        got[pos - starts[leaf]] = grad.reshape(-1).numpy()
        out[leaf] = (leaves[leaf][1].reshape(-1), got, name)
    return [out[i] for i in sorted(out)]


def _x(n=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 200, 2)).astype(np.float32)


@functools.cache
def _jax_vq_run(cd, conv_impl="lax"):
    m = VQVAEPatch(**VQ, compute_dtype=cd, conv_impl=conv_impl)
    p, s = m.init(0)
    x = jnp.asarray(_x())

    def loss(p):
        return m.loss_fn(p, s, x, train=True, rng=jax.random.PRNGKey(1))[0]

    val, g = jax.jit(jax.value_and_grad(loss))(p)
    return m, p, s, float(val), g, np.asarray(m.encode_indices(p, s, x))


def _port_vq_run(cd, scope="all"):
    m, p, s = _jax_vq_run(None)[:3]
    port = bridge.vqvae_from_jax(m.hparams, p, s, device="cpu")
    port.compute_dtype, port.compute_scope = cd, scope
    port.requires_grad_(True)
    x = torch.from_numpy(_x())
    loss, _ = port.loss_fn(x, train=True, generator=torch.Generator())
    loss.backward()
    with torch.no_grad():
        ids = port.encode_indices(x).numpy()
    return (port, float(loss.detach()),
            {n: q.grad for n, q in port.named_parameters()}, ids)


def _vq_sd(tree):
    m, p, s = _jax_vq_run(None)[:3]
    return bridge.vqvae_state_dict(m.hparams, tree, s)


def test_port_bf16_vqvae_against_jax_f32_and_bf16():
    """Measured against JAX's bf16 run (conv_impl='im2col'): loss 1.0e-7
    relative, gradients 6.3e-3 of a leaf's magnitude (the bf16-rounded
    incoming gradient of the port's backward), no id flips. Bounds: 1e-6,
    1e-2, none."""
    _, _, _, l32, g32, i32 = _jax_vq_run(None)
    _, _, _, l16, g16, i16 = _jax_vq_run(jnp.bfloat16, "im2col")
    port, loss, grads, ids = _port_vq_run(BF16)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert abs(loss - l32) < 5e-3 * abs(l32)
    assert (ids != i32).mean() < 0.03
    for ref, got, name in _port_grads_as_jax(_vq_sd, g32, grads):
        if np.linalg.norm(ref) > 1e-3:
            assert _rel(ref, got) < 0.15, name
    assert abs(loss - l16) <= 1e-6 * abs(l16)
    np.testing.assert_array_equal(ids, i16)
    for ref, got, name in _port_grads_as_jax(_vq_sd, g16, grads):
        if np.linalg.norm(ref) > 1e-3:
            assert _rel(ref, got) <= 1e-2, name


def test_port_bf16_vqvae_decoder_scope_keeps_encoder_exact():
    m, p, s = _jax_vq_run(None)[:3]
    x = torch.from_numpy(_x(16, 3))

    def port(**kw):
        q = bridge.vqvae_from_jax(m.hparams, p, s, device="cpu")
        for k, v in kw.items():
            setattr(q, k, v)
        return q

    with torch.no_grad():
        z32 = port().encode(x)
        zdec = port(compute_dtype=BF16, compute_scope="decoder").encode(x)
        zenc = port(compute_dtype=BF16, compute_scope="encoder").encode(x)
        zall = port(compute_dtype=BF16).encode(x)
    assert torch.equal(z32, zdec)
    assert not torch.equal(z32, zenc) and torch.equal(zenc, zall)
    _, _, grads, _ = _port_vq_run(BF16, "decoder")
    assert all(g.dtype == torch.float32 for g in grads.values())
    with pytest.raises(ValueError):
        bridge.VQVAEPatch(**VQ, compute_dtype=BF16, compute_scope="half",
                          device="cpu")
    with pytest.raises(ValueError):
        bridge.VQVAEPatch(**VQ, compute_dtype=torch.float16, device="cpu")


@functools.cache
def _jax_tr_run(cd):
    m = TransformerDecoder(**TR, compute_dtype=cd)
    p, _ = m.init(0)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 32, (8, 33)).astype(np.int32)
    y = rng.integers(0, 32, (8, 33)).astype(np.int32)

    def loss(p):
        logits, _ = m.apply(p, None, jnp.asarray(ids), train=True,
                            rng=jax.random.PRNGKey(2), generate=True)
        return m.loss_gen(logits, jnp.asarray(y))

    val, g = jax.jit(jax.value_and_grad(loss))(p)
    return m, p, ids, y, float(val), g


def _port_tr_run(impl):
    """(logits, loss, gradients, the dtypes of the blocks' outputs)."""
    m, p, ids, y = _jax_tr_run(None)[:4]
    port = bridge.transformer_from_jax(m.hparams, p, device="cpu",
                                       attention_impl=impl)
    port.compute_dtype = BF16
    port.requires_grad_(True)
    streams, body = [], port.block_body

    def block_body(x, blk, **kw):
        out = body(x, blk, **kw)
        streams.append(out.dtype)
        return out

    port.block_body = block_body
    logits = port.apply(torch.from_numpy(ids), train=True,
                        generator=torch.Generator())
    loss = port.loss_gen(logits, torch.from_numpy(y))
    loss.backward()
    return logits, float(loss.detach()), {n: q.grad for n, q in
                                          port.named_parameters()}, streams


def _tr_sd(tree):
    m = _jax_tr_run(None)[0]
    return bridge.transformer_state_dict(m.hparams, tree)


def test_port_bf16_transformer_against_jax_f32_and_bf16():
    """The blocks' stream is bf16. Loss measured 6.7e-7 relative from
    JAX's bf16 'xla' run and 1.8e-5 from its f32 run (JAX's two runs are
    1.9e-5 apart). Bounds: within 4e-6 of bf16 and more than 4e-6 from
    f32, so an f32 port fails.

    Gradients, as a share of a leaf's largest magnitude. The products'
    leaves (weights, the embedding) are 9.5e-3 from JAX's bf16 run: the
    bf16 rounding of each product and of the cotangent it takes, in other
    places in the two backwards. Bound 1.2e-2. The leaves that are sums
    over the batch's rows (biases, LayerNorm scales and shifts) sit
    nearer JAX's f32 run (9.9e-3) than its bf16 run (2.9e-2): JAX's
    transpose of the broadcast is a reduce_sum in bf16, which XLA on the
    CPU accumulates in bf16, while the port's sum accumulates in f32 and
    rounds once, so only the port's stays within a bf16 step of the
    exact sum. Bounds: 1.2e-2 of f32 and 3.5e-2 of bf16. Every leaf
    stays within the mixed-precision envelope of f32 (10%). The class
    head, out of the gen loss's graph, has no gradient in the port and a
    zero one in JAX."""
    _, _, _, _, l32, g32 = _jax_tr_run(None)
    _, _, _, _, l16, g16 = _jax_tr_run(jnp.bfloat16)
    logits, loss, grads, streams = _port_tr_run("xla")
    assert streams == [BF16] * TR["n_blocks"]
    assert logits.dtype == torch.float32
    assert abs(loss - l32) < 5e-3 * abs(l32)
    assert abs(loss - l16) <= 4e-6 * abs(l16)
    assert abs(loss - l32) > 4e-6 * abs(l32)
    missing = {n for n, g in grads.items() if g is None}
    assert missing == {"class_head.linear_1.weight",
                       "class_head.linear_2.weight"}
    assert all(g.dtype == torch.float32 for g in grads.values()
               if g is not None)

    def row_sum(name):
        return name.endswith("bias") or ".ln_" in name

    for ref_tree, products, sums in ((g32, 0.10, 1.2e-2),
                                     (g16, 1.2e-2, 3.5e-2)):
        for ref, got, name in _port_grads_as_jax(_tr_sd, ref_tree, grads):
            if np.linalg.norm(ref) > 1e-3:
                bound = sums if row_sum(name) else products
                assert _rel(ref, got) <= bound, (name, _rel(ref, got))


def test_port_bf16_transformer_pallas_path_equals_xla_path():
    """On the CPU #9's wrapper runs its plain form, the f32 core on the
    widened q, k, v with its output rounded to bf16: the 'xla' path's
    arithmetic, so the two are bit-equal, gradients too."""
    la, loss_a, ga, _ = _port_tr_run("xla")
    lb, loss_b, gb, _ = _port_tr_run("pallas")
    assert torch.equal(la, lb) and loss_a == loss_b
    for n, g in ga.items():
        assert (g is None and gb[n] is None) or torch.equal(g, gb[n]), n


def test_port_bf16_mlp_logits_against_jax():
    """Measured against JAX's bf16 MLP: logits 3.0e-8 apart in eval and
    1.2e-7 at train time (the same rounded inputs, f32 sums in another
    order). Bound 1e-5."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    hp = dict(input_size=128, output_size=2, in_dim=1, hidden_sizes=64,
              n_hidden_layers=2, dropout_p=0.0)
    m32, m16 = MLP(**hp), MLP(**hp, compute_dtype=jnp.bfloat16)
    p, s = m32.init(0)
    port = bridge.mlp_from_jax(m32.hparams, p, s, device="cpu",
                               compute_dtype=BF16)
    for train in (False, True):
        l32, _ = m32.apply(p, s, jnp.asarray(x), train=train)
        l16, _ = m16.apply(p, s, jnp.asarray(x), train=train)
        with torch.no_grad():
            got, _ = port.apply(torch.from_numpy(x), train=train,
                                generator=torch.Generator())
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(l32), rtol=0.05,
                                   atol=0.02)
        np.testing.assert_allclose(got.numpy(), np.asarray(l16), rtol=0,
                                   atol=1e-5)


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int16).astype(np.int32)
                  - b.view(np.int16).astype(np.int32))


@pytest.mark.parametrize("b,h,t,d", [(2, 4, 33, 16), (1, 2, 45, 24)])
def test_flash_bf16_plain_form_against_jax_pallas(b, h, t, d):
    """#9's plain form on bf16 q, k, v against JAX's Pallas kernel on the
    same bf16 operands (interpret mode): both compute in f32 and round
    their output to bf16; measured 0 entries apart, bound: at most 1e-3
    of the entries, one bf16 step each. The backward (the plain core's
    recompute on the saved bf16 operands, bf16 gradients) against JAX's
    core differentiated on them: measured within 5.2e-3 of each
    gradient's largest magnitude (a bf16 step), bound 1e-2."""
    rng = np.random.default_rng(t)
    qkv = [rng.standard_normal((b, h, t, d)).astype(np.float32)
           for _ in range(3)]
    jq = [jnp.asarray(a, jnp.bfloat16) for a in qkv]
    tq = [torch.from_numpy(a).to(BF16) for a in qkv]
    ref = np.asarray(jax_flash(*jq)).view(np.uint16).view(np.int16)
    got = fused_attn.flash_causal_attention(*tq)
    assert got.dtype == BF16
    ulps = _bf16_ulps(got.view(torch.int16).numpy(), ref)
    assert ulps.max() <= 1 and (ulps > 0).mean() <= 1e-3

    g_out = rng.standard_normal((b, h, t, d)).astype(np.float32)
    _, vjp = jax.vjp(jax_core, *jq)
    j_grads = vjp(jnp.asarray(g_out))
    leaves = [z.clone().requires_grad_(True) for z in tq]
    out = fused_attn.flash_causal_attention(*leaves)
    out.backward(torch.from_numpy(g_out).to(BF16))
    for z, jg in zip(leaves, j_grads):
        assert z.grad.dtype == BF16
        assert _rel(np.asarray(jg, np.float32), z.grad.float().numpy()) <= 1e-2
