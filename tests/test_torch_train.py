"""The port's training forward, losses and SGD trajectories against the
JAX package on the CPU.

The VQ-VAE (hidden 16, 2 resblocks, K 8, D 4) and the transformer (d32,
2 blocks, 4 heads, T 9) are built in the JAX package from a seed, with
random BatchNorm parameters and statistics, and bridged into the port
(`bridge.*_from_jax`), so both run on identical weights. Forwards,
losses and new BatchNorm statistics within 1e-5 (dropout 0 at train
time); `decay_mask` as the JAX mask's lists; three SGD steps
(`tests/test_grad_parity.py`'s contract) within rtol 1e-3, atol 2e-4.
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vq_vae_transformer_arc_welding_tpu.models import (TransformerDecoder,
                                                       VQVAEPatch)
from vq_vae_transformer_arc_welding_tpu.ops.norm import BatchNormState
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.models import (
    TransformerDecoder as PortTransformer, VQVAEPatch as PortVQVAE)

FWD = dict(rtol=0, atol=1e-5)
TRAJ = dict(rtol=1e-3, atol=2e-4)
LR = 0.05
STEPS = 3
H, K, D, NRES = 16, 8, 4, 2
TR = dict(d_model=32, n_classes=18, seq_len=9, n_blocks=2, n_head=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers' (the lane runs six processes on the host's
    cores), so these tests use one and give it back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def jax_vqvae(batch_norm: bool, dropout_p: float = 0.0):
    """(model, params, state), BatchNorm parameters and statistics drawn
    at random so that none of the three BN sets is the identity."""
    vq = VQVAEPatch(hidden_dim=H, input_dim=2, num_embeddings=K,
                    embedding_dim=D, n_resblocks=NRES, learning_rate=1e-3,
                    dropout_p=dropout_p, batch_norm=batch_norm)
    params, state = vq.init(1)
    rng = np.random.default_rng(17)

    def r(lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, H), jnp.float32)

    def bn_state():
        return BatchNormState(r(-0.3, 0.3), r(0.5, 2.0))

    if batch_norm:
        for half in ("encoder", "decoder"):
            for blk in params[half]:
                for n in ("1", "2"):
                    blk[f"bn{n}_scale"] = r(0.5, 1.5)
                    blk[f"bn{n}_bias"] = r(-0.2, 0.2)
            state[f"{half}_bn"] = [{n: bn_state() for n in ("bn1", "bn2")}
                                   for _ in params[half]]
    params["inverse"]["bn_scale"] = r(0.5, 1.5)
    params["inverse"]["bn_bias"] = r(-0.2, 0.2)
    state["inverse_bn"] = bn_state()
    # codes at the spread of z_e, so that the batch uses several
    z = vq.encode(params, state, jnp.asarray(cycles(16, 99)))[0]
    params["vq"]["codebook"] = params["vq"]["codebook"] * float(
        jnp.std(z) / jnp.std(params["vq"]["codebook"]))
    return vq, params, state


def port_vqvae(batch_norm: bool, dropout_p: float = 0.0, **kw) -> PortVQVAE:
    vq, params, state = jax_vqvae(batch_norm, dropout_p)
    return bridge.vqvae_from_jax(vq.hparams, params, state, device="cpu",
                                 **kw)


@functools.cache
def jax_transformer():
    tr = TransformerDecoder(**TR, res_dropout=0.0, att_dropout=0.0)
    params, _ = tr.init(2)
    return tr, params


def port_transformer(**kw) -> PortTransformer:
    tr, params = jax_transformer()
    return bridge.transformer_from_jax(tr.hparams, params, device="cpu", **kw)


def cycles(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, 200, 2)).astype(np.float32)


def ids(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, TR["n_classes"], (n, TR["seq_len"])).astype(np.int64)


def _bn_new_state(j_state, batch_norm: bool) -> dict:
    """The JAX state's BN statistics under the port's state_dict keys."""
    out = {}
    if batch_norm:
        for half, prefix in (("encoder", "encoder.0.shared_conv"),
                             ("decoder", "decoder.1.shared_conv")):
            for i, st in enumerate(j_state[f"{half}_bn"]):
                for n, idx in (("bn1", 2), ("bn2", 5)):
                    pre = f"{prefix}.{i}.block.{idx}"
                    out[f"{pre}.running_mean"] = st[n].mean
                    out[f"{pre}.running_var"] = st[n].var
    inv = j_state["inverse_bn"]
    out["reverse_patch_embed.proj.1.running_mean"] = inv.mean
    out["reverse_patch_embed.proj.1.running_var"] = inv.var
    return out


# -- VQ-VAE ------------------------------------------------------------------

@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_vqvae_apply_and_loss_match_jax(batch_norm, train):
    vq, params, state = jax_vqvae(batch_norm)
    port = port_vqvae(batch_norm)
    x = cycles(8, 3)
    j_loss, (j_m, j_state) = vq.loss_fn(params, state, jnp.asarray(x),
                                        train=train, rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        loss, (m, new) = port.loss_fn(torch.from_numpy(x), train=train,
                                      generator=torch.Generator())
        out, new2 = port.apply(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), **FWD)
    for k in ("loss", "recon_error", "perplexity"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(j_m[k]), **FWD,
                                   err_msg=k)
    j_out, _ = vq.apply(params, state, jnp.asarray(x), train=train,
                        rng=jax.random.PRNGKey(0))
    np.testing.assert_allclose(out.x_hat.numpy(), np.asarray(j_out.x_hat),
                               **FWD)
    np.testing.assert_allclose(out.embedding_loss.numpy(),
                               np.asarray(j_out.embedding_loss), **FWD)
    assert out.x_hat.shape == (8, 200, 2)
    if not train:
        assert new == {} and new2 == {}
        return
    want = _bn_new_state(j_state, batch_norm)
    stats = {k: v for k, v in new.items() if "num_batches" not in k}
    assert set(stats) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(v), **FWD,
                                   err_msg=k)
    assert all(int(v) == 1 for k, v in new.items() if "num_batches" in k)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_vqvae_decode_matches_jax(batch_norm):
    vq, params, state = jax_vqvae(batch_norm)
    port = port_vqvae(batch_norm)
    z = np.random.default_rng(4).standard_normal((5, 16, D)).astype(
        np.float32)
    for train in (False, True):
        j_x, _, _ = vq.decode(params, state, jnp.asarray(z), train=train)
        with torch.no_grad():
            x_hat, _ = port.decode(torch.from_numpy(z), train=train)
        np.testing.assert_allclose(x_hat.numpy(), np.asarray(j_x), **FWD)
    j_im = copy.copy(vq)
    j_im.conv_impl = "im2col"
    with torch.no_grad():
        x_hat, _ = port.decode(torch.from_numpy(z))
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(
        j_im.decode(params, state, jnp.asarray(z))[0]), **FWD)


def test_vqvae_commit_state_writes_the_new_statistics():
    port = port_vqvae(True)
    x = torch.from_numpy(cycles(8, 5))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        _, new = port.apply(x, train=True)
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in before.items())
    port.commit_state(new)
    sd = port.state_dict()
    assert len(new) == (4 * NRES + 1) * 3
    for k, v in new.items():
        assert torch.equal(sd[k], v), k
    assert torch.equal(sd["decoder.1.shared_conv.0.block.2.num_batches_tracked"],
                       torch.tensor(1))


def test_vqvae_dropout_draws_per_resblock_from_the_generator():
    port = port_vqvae(False, dropout_p=0.3)
    x = torch.from_numpy(cycles(4, 6))

    def run(seed):
        with torch.no_grad():
            return port.apply(x, train=True, generator=torch.Generator()
                              .manual_seed(seed))[0].x_hat

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
    with torch.no_grad():
        ev = port.apply(x)[0].x_hat
        ev0 = port_vqvae(False).apply(x)[0].x_hat
    torch.testing.assert_close(ev, ev0, rtol=0, atol=0)


def test_vqvae_pallas_vq_impl_trains_through_its_kernel_hook(monkeypatch):
    """vq_impl='pallas' hands the training forward's search to #7's
    wrapper (its plain version on the CPU): same loss and ids as 'xla',
    and the gradient flows through the lookup and the straight-through."""
    from vq_vae_transformer_arc_welding_tpu_torch.ops import fused_vq
    calls = []
    real = fused_vq.nearest_codes_pallas

    def counting(z, cb):
        calls.append((z.requires_grad, tuple(z.shape)))
        return real(z, cb)

    monkeypatch.setattr(fused_vq, "nearest_codes_pallas", counting)
    x = torch.from_numpy(cycles(8, 7))
    losses, grads = [], []
    for impl in ("xla", "pallas"):
        port = port_vqvae(True, vq_impl=impl).requires_grad_(True)
        loss, _ = port.loss_fn(x, train=True)
        losses.append(loss)
        grads.append(torch.autograd.grad(loss, list(port.parameters())))
    assert calls == [(False, (8 * 16, D))]
    torch.testing.assert_close(losses[1], losses[0], rtol=0, atol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_vqvae_refuses_the_improved_vq():
    """The EMA VQ is ported (tests/test_torch_vq_ema.py): an EMA VQ-VAE
    refuses the classic codebook parameter and holds the EMA buffers
    under vector_quantize_pytorch's keys instead."""
    ema = PortVQVAE(H, 2, K, D, 1, use_improved_vq=True, device="cpu")
    keys = set(ema.state_dict())
    assert "vector_quantization.embedding.weight" not in keys
    assert {f"vector_quantization.vq.layers.0._codebook.{n}"
            for n in ("embed", "cluster_size", "embed_avg",
                      "initted")} <= keys
    with pytest.raises(RuntimeError, match="embedding.weight"):
        ema.load_state_dict(port_vqvae(False).state_dict())


def test_bridged_vqvae_with_batch_norm_serves_as_jax():
    vq, params, state = jax_vqvae(True)
    port = port_vqvae(True)
    x = cycles(6, 8)
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x))
        got = port.encode_indices(torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(
        vq.encode(params, state, jnp.asarray(x))[0]), **FWD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        vq.encode_indices(params, state, jnp.asarray(x))))


# -- transformer ---------------------------------------------------------------

@pytest.mark.parametrize("generate", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_transformer_train_forward_matches_jax(generate, impl):
    tr, params = jax_transformer()
    port = port_transformer(attention_impl=impl)
    x = ids(3, 9)
    ref, _ = tr.apply(params, None, jnp.asarray(x), train=True,
                      rng=jax.random.PRNGKey(0), generate=generate)
    with torch.no_grad():
        got = port.apply(torch.from_numpy(x), train=True,
                         generator=torch.Generator(), generate=generate)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


def test_transformer_losses_match_jax():
    tr, _ = jax_transformer()
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((3, 9, 18)).astype(np.float32)
    labels = rng.integers(0, 18, (3, 9))
    labels[0, :4] = -1
    labels[2, 8] = -1
    np.testing.assert_allclose(
        PortTransformer.loss_gen(torch.from_numpy(logits),
                                 torch.from_numpy(labels)).numpy(),
        np.asarray(tr.loss_gen(jnp.asarray(logits), jnp.asarray(labels))),
        **FWD)
    none = np.full_like(labels, -1)
    assert float(PortTransformer.loss_gen(torch.from_numpy(logits),
                                          torch.from_numpy(none))) == 0.0
    c_logits = rng.standard_normal((5, 2)).astype(np.float32)
    cond = rng.integers(0, 2, 5)
    np.testing.assert_allclose(
        PortTransformer.loss_class(torch.from_numpy(c_logits),
                                   torch.from_numpy(cond)).numpy(),
        np.asarray(tr.loss_class(jnp.asarray(c_logits), jnp.asarray(cond))),
        **FWD)


# the port's parameter name of each JAX leaf path
def _port_name(path) -> str:
    keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
    if keys[0] == "blocks":
        i, rest = keys[1], keys[2:]
        table = {("ln1_scale",): "ln_1.weight", ("ln1_bias",): "ln_1.bias",
                 ("ln2_scale",): "ln_2.weight", ("ln2_bias",): "ln_2.bias"}
        if tuple(rest) in table:
            return f"transformer.h.{i}.{table[tuple(rest)]}"
        sub, leaf = rest
        mod = {"c_attn_w": "c_attn.weight", "c_attn_b": "c_attn.bias",
               "c_proj_w": "c_proj.weight", "c_proj_b": "c_proj.bias",
               "c_fc_w": "c_fc.weight", "c_fc_b": "c_fc.bias"}[leaf]
        return f"transformer.h.{i}.{sub}.{mod}"
    return {"tok_emb": "embedding.latent_embedding.weight",
            "ln_f_scale": "transformer.ln_f.weight",
            "ln_f_bias": "transformer.ln_f.bias",
            "lm_head_w": "lm_head.weight",
            "l1_w": "class_head.linear_1.weight",
            "l2_w": "class_head.linear_2.weight",
            "l1_b": "class_head.linear_1.bias",
            "l2_b": "class_head.linear_2.bias"}[keys[-1]]


@pytest.mark.parametrize("class_h_bias", [False, True])
def test_decay_mask_matches_jax(class_h_bias):
    tr = TransformerDecoder(**TR, class_h_bias=class_h_bias)
    params, _ = tr.init(0)
    mask = tr.decay_mask(params)
    leaves = jax.tree_util.tree_leaves_with_path(mask)
    want_decay = sorted(_port_name(p) for p, m in leaves if m)
    want_rest = sorted(_port_name(p) for p, m in leaves if not m)
    port = PortTransformer(**TR, class_h_bias=class_h_bias, device="cpu")
    decay, rest = port.decay_mask()
    assert sorted(decay) == want_decay
    assert sorted(rest) == want_rest
    assert decay + rest != [] and set(decay).isdisjoint(rest)
    assert sorted(decay + rest) == sorted(n for n, _ in
                                          port.named_parameters())


# -- three SGD steps (tests/test_grad_parity.py's contract) -------------------

def _sgd_jax(loss_fn, params, state, batches):
    tx = optax.sgd(LR)
    opt = tx.init(params)
    for b in batches:
        (_, state), grads = jax.value_and_grad(
            lambda p: loss_fn(p, state, b), has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    return params, state


def _sgd_port(model, loss_fn, batches):
    model.requires_grad_(True)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    for b in batches:
        opt.zero_grad(set_to_none=True)
        loss, new = loss_fn(b)
        loss.backward()
        opt.step()
        if new:
            model.commit_state(new)
    return model


def _compare_sd(port, j_sd: dict):
    sd = port.state_dict()
    for k, v in j_sd.items():
        if "num_batches" in k or k.endswith(".attn.bias"):
            continue
        np.testing.assert_allclose(sd[k].detach().numpy(), v.numpy(), **TRAJ,
                                   err_msg=k)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_vqvae_sgd_trajectory_matches_jax(batch_norm):
    vq, params, state = jax_vqvae(batch_norm)
    batches = [cycles(8, 20 + s) for s in range(STEPS)]

    def j_loss(p, s, b):
        loss, (_, new) = vq.loss_fn(p, s, jnp.asarray(b), train=True,
                                    rng=jax.random.PRNGKey(0))
        return loss, new

    j_params, j_state = _sgd_jax(j_loss, params, state, batches)
    port = port_vqvae(batch_norm)

    def p_loss(b):
        loss, (_, new) = port.loss_fn(torch.from_numpy(b), train=True)
        return loss, new

    _sgd_port(port, p_loss, batches)
    # every parameter and BN statistic, through the bridge's key map
    ref = bridge.vqvae_from_jax(vq.hparams, j_params, j_state, device="cpu")
    _compare_sd(port, ref.state_dict())
    moved = port_vqvae(batch_norm).state_dict()
    assert not torch.equal(port.state_dict()["decoder.0.weight"],
                           moved["decoder.0.weight"])


@pytest.mark.parametrize("task", ["gen", "class"])
def test_transformer_sgd_trajectory_matches_jax(task):
    tr, params = jax_transformer()
    rng = np.random.default_rng(30)
    xs = [ids(4, 40 + s) for s in range(STEPS)]
    ys = [ids(4, 50 + s) for s in range(STEPS)]
    conds = [rng.integers(0, 2, 4) for _ in range(STEPS)]
    gen = task == "gen"

    def j_loss(p, s, b):
        x, y, c = b
        logits, _ = tr.apply(p, None, jnp.asarray(x), train=True, rng=None,
                             generate=gen)
        loss = (tr.loss_gen(logits, jnp.asarray(y)) if gen
                else tr.loss_class(logits, jnp.asarray(c)))
        return loss, s

    j_params, _ = _sgd_jax(j_loss, params, {}, list(zip(xs, ys, conds)))
    port = port_transformer()

    def p_loss(b):
        x, y, c = (torch.from_numpy(a) for a in b)
        logits = port.apply(x, train=True, generator=torch.Generator(),
                            generate=gen)
        return ((port.loss_gen(logits, y) if gen
                 else port.loss_class(logits, c)), {})

    _sgd_port(port, p_loss, list(zip(xs, ys, conds)))
    ref = bridge.transformer_from_jax(tr.hparams, j_params, device="cpu")
    _compare_sd(port, ref.state_dict())
    # the head off the task's graph has no gradient and did not move
    idle = "class_head.linear_1.weight" if gen else "lm_head.weight"
    assert torch.equal(port.state_dict()[idle],
                       port_transformer().state_dict()[idle])
