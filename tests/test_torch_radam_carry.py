"""A JAX run's RAdam state carried into the port mid-run
(`bridge.radam_state_from_jax`) on the CPU.

Three optimizer steps in the JAX package (its `make_radam` chain, the
transformer's with the decay mask and clipping), then its state, as
`flax.serialization.to_state_dict` gives it, goes into the port's
`TrainOptimizer` over the bridged weights, and three more steps run in
each package on the same gradients. The weights end within
tests/test_optim.py's bounds for torch.optim.RAdam against the JAX chain:
rtol 1e-4, atol 2e-5 at the default betas (past RAdam's rectification
switch, where torch's float64 scalars part from the chain's float32), and
1e-6 at the transformer's (0.9, 0.95). A parameter the JAX run never
stepped (count 0: the class head of a generation-only run) carries no
torch state and stays skipped.
"""
import copy
import functools

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp
import optax

from vq_vae_transformer_arc_welding_tpu.models import MLP, TransformerDecoder
from vq_vae_transformer_arc_welding_tpu.train import optim as joptim
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.train import optim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(params, rng, skip=()):
    """A random gradient tree like params; the leaves under `skip` keys
    zero (outside the loss graph)."""
    def leaf(path, a):
        keys = [getattr(k, "key", None) for k in path]
        if any(k in skip for k in keys):
            return jnp.zeros_like(a)
        return jnp.asarray(rng.standard_normal(np.shape(a)) * 0.1,
                           jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def _carry_and_continue(model, params, state, tx, spec_of, to_sd, from_jax,
                        skip=()):
    rng = np.random.default_rng(0)
    grads = [_grads(params, rng, skip) for _ in range(6)]
    st = tx.init(params)
    update = jax.jit(tx.update)
    for g in grads[:3]:
        up, st = update(g, st, params)
        params = optax.apply_updates(params, up)
    port = from_jax(params).requires_grad_(True)
    opt = spec_of(port).init(port)
    opt_sd, _ = bridge.radam_state_from_jax(
        flax.serialization.to_state_dict(st),
        functools.partial(to_sd, state=state), opt)
    opt_sd = copy.deepcopy(opt_sd)      # the live state moves on below
    for g in grads[3:]:
        up, st = update(g, st, params)
        params = optax.apply_updates(params, up)
        opt.zero_grad()
        mapped = to_sd(g, state=state)
        for name, p in port.named_parameters():
            if float(mapped[name].abs().sum()) > 0:
                p.grad = mapped[name].reshape(p.shape).clone()
        opt.step()
    return port, to_sd(params, state=state), opt, opt_sd


def test_radam_state_carried_at_the_default_betas():
    m = MLP(input_size=10, output_size=2, in_dim=2, hidden_sizes=16,
            n_hidden_layers=1)
    p, s = m.init(0)

    def to_sd(tree, state):
        return bridge.mlp_state_dict(m.hparams, tree, state)

    port, want, opt, opt_sd = _carry_and_continue(
        m, p, s, joptim.make_radam(1e-2, clip_norm=0.42),
        lambda _: optim.make_radam(1e-2, clip_norm=0.42), to_sd,
        lambda q: bridge.mlp_from_jax(m.hparams, q, s, device="cpu"))
    assert len(opt_sd["state"]) == len(list(port.parameters()))
    assert all(float(v["step"]) == 3 for v in opt_sd["state"].values())
    assert set(opt.step_counts().values()) == {6}
    for k, v in port.state_dict().items():
        if k in dict(port.named_parameters()):
            np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=2e-5, err_msg=k)


def test_radam_state_carried_at_the_transformer_betas():
    m = TransformerDecoder(d_model=32, n_classes=18, seq_len=9, n_blocks=2,
                           n_head=4)
    p, _ = m.init(0)
    tx = joptim.make_transformer_optimizer(m, p)

    def to_sd(tree, state=None):
        return bridge.transformer_state_dict(m.hparams, tree)

    port, want, opt, _ = _carry_and_continue(
        m, p, None, tx, optim.make_transformer_optimizer, to_sd,
        lambda q: bridge.transformer_from_jax(m.hparams, q, device="cpu"),
        skip=("class_head",))
    counts = opt.step_counts()
    assert counts["class_head.linear_1.weight"] == 0
    assert counts["lm_head.weight"] == 6
    for k, v in port.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_radam_state_sets_the_schedule_position():
    m = MLP(input_size=10, output_size=2, in_dim=2, hidden_sizes=16,
            n_hidden_layers=1)
    p, s = m.init(0)
    tx = joptim.make_radam(1e-3)
    st = tx.init(p)
    g = _grads(p, np.random.default_rng(1))
    for _ in range(4):
        _, st = tx.update(g, st, p)
    port = bridge.mlp_from_jax(m.hparams, p, s, device="cpu")
    sched = optim.cosine_warmup_schedule(2, 10)
    opt = optim.make_radam(1e-3, schedule=sched).init(port)
    tree = flax.serialization.to_state_dict(st)
    to_sd = functools.partial(bridge.mlp_state_dict, m.hparams, state=s)
    _, sched_sd = bridge.radam_state_from_jax(tree, to_sd, opt)
    assert sched_sd["last_epoch"] == 4
    assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(
        1e-3 * sched(4))
    bridge.radam_state_from_jax(tree, to_sd, opt, schedule_step=7)
    assert opt.scheduler.last_epoch == 7
    with pytest.raises(ValueError, match="scale_by_torch_radam"):
        bridge.radam_state_from_jax({"0": {}}, to_sd, opt)
