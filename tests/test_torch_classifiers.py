"""The port's classifiers, their task and the embedding helpers against
the JAX package and the reference twins on the CPU.

MLP, GRU and MLPEmbedding are built in the JAX package from a seed and
bridged into the port (`bridge.*_from_jax`), or loaded from a twin's
state_dict (tests/torch_twins.py: the reference keys): forwards and new
BatchNorm statistics within 1e-5, eval and train mode (dropout 0);
three SGD steps against the twin and against JAX within
tests/test_grad_parity.py's rtol 1e-3, atol 2e-4. `ClassificationTask`
through the port's Trainer: `evaluate` on identical weights equals the
JAX Trainer's within 1e-6 (no sampling enters it), and short fits of the
three models (raw windows, and MLPEmbedding on ids with `ids_input`)
lower their training loss.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vq_vae_transformer_arc_welding_tpu.data.datasets import (
    ArraySplit as JaxSplit)
from vq_vae_transformer_arc_welding_tpu.models import (GRU, MLP,
                                                       MLPEmbedding)
from vq_vae_transformer_arc_welding_tpu.models import embedding as jemb
from vq_vae_transformer_arc_welding_tpu.train import tasks as jtasks
from vq_vae_transformer_arc_welding_tpu.train.loop import Trainer as JaxTrainer
from vq_vae_transformer_arc_welding_tpu.train.metrics import (
    cross_entropy as jax_ce)
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.data import (ArraySplit,
                                                           sampling_weights)
from vq_vae_transformer_arc_welding_tpu_torch.models import (
    GRU as PortGRU, MLP as PortMLP, MLPEmbedding as PortMLPEmbedding)
from vq_vae_transformer_arc_welding_tpu_torch.models import embedding
from vq_vae_transformer_arc_welding_tpu_torch.train.loop import Trainer
from vq_vae_transformer_arc_welding_tpu_torch.train.optim import make_radam
from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
    ClassificationTask)

from torch_twins import TwinGRU, TwinMLP

FWD = dict(rtol=0, atol=1e-5)
TRAJ = dict(rtol=1e-3, atol=2e-4)
LR, STEPS = 0.05, 3
MLP_HP = dict(input_size=10, output_size=2, in_dim=2, hidden_sizes=16,
              n_hidden_layers=1, dropout_p=0.0)
GRU_HP = dict(input_size=5, in_dim=8, output_size=2, hidden_sizes=12,
              n_hidden_layers=2, dropout_p=0.0)
EMB_HP = dict(input_size=3, output_size=2, in_dim=4, hidden_sizes=16,
              n_hidden_layers=1, dropout_p=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_bn(params, state, rng):
    """BatchNorm affine parameters and statistics away from identity."""
    from vq_vae_transformer_arc_welding_tpu.ops.norm import BatchNormState
    for i, lay in enumerate(params["layers"]):
        n = lay["bn_scale"].shape[0]
        lay["bn_scale"] = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
        lay["bn_bias"] = jnp.asarray(rng.uniform(-0.2, 0.2, n), jnp.float32)
        state["bn"][i] = BatchNormState(
            jnp.asarray(rng.uniform(-0.3, 0.3, n), jnp.float32),
            jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32))
    return params, state


def _jax_and_port(kind):
    rng = np.random.default_rng(3)
    if kind == "mlp":
        m = MLP(**MLP_HP)
        p, s = _random_bn(*m.init(0), rng)
        return m, p, s, bridge.mlp_from_jax(m.hparams, p, s, device="cpu")
    if kind == "gru":
        m = GRU(**GRU_HP)
        p, s = m.init(0)
        return m, p, s, bridge.gru_from_jax(m.hparams, p, s, device="cpu")
    m = MLPEmbedding(**EMB_HP)
    p, s = _random_bn(*m.init(0), rng)
    return m, p, s, bridge.mlp_embedding_from_jax(m.hparams, p, s,
                                                  device="cpu")


def _inputs(kind, n=6, seed=4):
    rng = np.random.default_rng(seed)
    if kind == "mlp":
        return rng.standard_normal((n, 10, 2)).astype(np.float32)
    if kind == "gru":
        return rng.standard_normal((n, 5, 8)).astype(np.float32)
    return rng.integers(0, 256, (n, 3, 4)).astype(np.int64)


@pytest.mark.parametrize("kind", ["mlp", "gru", "mlp_embedding"])
@pytest.mark.parametrize("train", [False, True])
def test_port_classifier_forward_matches_jax(kind, train):
    m, p, s, port = _jax_and_port(kind)
    x = _inputs(kind)
    j_logits, j_state = m.apply(p, s, jnp.asarray(x), train=train,
                                rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        logits, new = port.apply(torch.from_numpy(x), train=train,
                                 generator=torch.Generator())
    assert logits.dtype == torch.float32 and logits.shape == (6, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **FWD)
    if kind == "gru" or not train:
        assert new == {}
        return
    for i, st in enumerate(j_state["bn"]):
        np.testing.assert_allclose(
            new[f"layers.{3 * i + 1}.running_mean"].numpy(),
            np.asarray(st.mean), **FWD)
        np.testing.assert_allclose(
            new[f"layers.{3 * i + 1}.running_var"].numpy(),
            np.asarray(st.var), **FWD)
    port.commit_state(new)
    assert int(port.state_dict()["layers.1.num_batches_tracked"]) == 1


def test_port_classifiers_carry_the_reference_keys():
    """The port's MLP and GRU take a twin's state_dict as they are, and
    the JAX bridge writes the same keys; a seeded init draws the JAX
    package's distributions (bounds 1/sqrt(fan_in), 1/sqrt(hidden))."""
    twins = {"mlp": TwinMLP(input_size=10, in_dim=2, hidden=16, n_hidden=1),
             "gru": TwinGRU(in_dim=8, hidden=12, n_layers=2)}
    ports = {"mlp": PortMLP(**MLP_HP, device="cpu"),
             "gru": PortGRU(**GRU_HP, device="cpu")}
    for kind, twin in twins.items():
        assert set(ports[kind].state_dict()) == set(twin.state_dict())
        ports[kind].load_state_dict(twin.state_dict())
        assert set(_jax_and_port(kind)[3].state_dict()) == set(
            twin.state_dict())
    g = torch.Generator().manual_seed(0)
    mlp = PortMLP(**MLP_HP, device="cpu", generator=g)
    assert float(mlp.layers[0].weight.abs().max()) <= 1 / np.sqrt(20)
    gru = PortGRU(**GRU_HP, device="cpu", generator=g)
    assert float(gru.gru.weight_hh_l1.abs().max()) <= 1 / np.sqrt(12)
    emb = PortMLPEmbedding(**EMB_HP, device="cpu", generator=g)
    assert set(emb.state_dict()) == set(_jax_and_port(
        "mlp_embedding")[3].state_dict())
    assert not any(q.requires_grad for q in gru.parameters())


def _sgd_port(port, batches):
    port.requires_grad_(True)
    opt = torch.optim.SGD(port.parameters(), lr=LR)
    for x, y in batches:
        opt.zero_grad()
        logits, new = port.apply(torch.from_numpy(x), train=True,
                                 generator=torch.Generator())
        torch.nn.functional.cross_entropy(logits,
                                          torch.from_numpy(y)).backward()
        port.commit_state(new)
        opt.step()
    return port


def _sgd_jax(model, params, state, batches):
    tx = optax.sgd(LR)
    opt = tx.init(params)
    for x, y in batches:
        def loss(p):
            logits, new = model.apply(p, state, jnp.asarray(x), train=True,
                                      rng=None)
            return jax_ce(logits, jnp.asarray(y, jnp.int32)), new

        (_, state), g = jax.value_and_grad(loss, has_aux=True)(params)
        up, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, up)
    return params, state


@pytest.mark.parametrize("kind", ["mlp", "gru"])
def test_port_classifier_sgd_steps_match_twin_and_jax(kind):
    """Three SGD steps from one set of weights: the port (its BatchNorm
    statistics committed after each step), the reference twin and the
    JAX model end within rtol 1e-3, atol 2e-4 of each other."""
    m, p, s, port = _jax_and_port(kind)
    twin = (TwinMLP(input_size=10, in_dim=2, hidden=16, n_hidden=1, p=0.0)
            if kind == "mlp" else TwinGRU(in_dim=8, hidden=12, n_layers=2,
                                          p=0.0))
    twin.load_state_dict(port.state_dict())
    twin.train()
    rng = np.random.default_rng(9)
    batches = [(_inputs(kind, 16, 10 + i), rng.integers(0, 2, 16))
               for i in range(STEPS)]
    opt = torch.optim.SGD(twin.parameters(), lr=LR)
    for x, y in batches:
        opt.zero_grad()
        torch.nn.functional.cross_entropy(
            twin(torch.from_numpy(x)), torch.from_numpy(y)).backward()
        opt.step()
    _sgd_port(port, batches)
    jp, js = _sgd_jax(m, p, s, batches)
    j_sd = (bridge.mlp_state_dict(m.hparams, jp, js) if kind == "mlp"
            else bridge.gru_state_dict(m.hparams, jp))
    t_sd = twin.state_dict()
    for k, v in port.state_dict().items():
        if "num_batches" in k:
            continue
        np.testing.assert_allclose(v.numpy(), t_sd[k].numpy(), **TRAJ,
                                   err_msg=k)
        np.testing.assert_allclose(v.numpy(), j_sd[k].numpy(), **TRAJ,
                                   err_msg=k)


def test_port_mlp_embedding_sgd_steps_match_jax():
    m, p, s, port = _jax_and_port("mlp_embedding")
    rng = np.random.default_rng(11)
    batches = [(_inputs("mlp_embedding", 16, 20 + i), rng.integers(0, 2, 16))
               for i in range(STEPS)]
    _sgd_port(port, batches)
    jp, js = _sgd_jax(m, p, s, batches)
    j_sd = bridge.mlp_embedding_state_dict(m.hparams, jp, js)
    for k, v in port.state_dict().items():
        if "num_batches" not in k:
            np.testing.assert_allclose(v.numpy(), j_sd[k].numpy(), **TRAJ,
                                       err_msg=k)


def _split(kind, n, seed):
    x = _inputs(kind, n, seed)
    y = np.random.default_rng(seed + 1).integers(0, 2, n).astype(np.int64)
    return x, y


@pytest.mark.parametrize("kind", ["mlp", "mlp_embedding"])
def test_classification_task_evaluate_matches_the_jax_trainer(kind):
    m, p, s, port = _jax_and_port(kind)
    x, y = _split(kind, 40, 30)
    ids = kind == "mlp_embedding"
    j_task = jtasks.ClassificationTask(m, ids_input=ids)
    got = Trainer(verbose=False).evaluate(
        ClassificationTask(port, ids_input=ids), ArraySplit(x, y), 16, False)
    want = JaxTrainer(verbose=False).evaluate(
        j_task, p, s, JaxSplit(x, y), 16, False)
    assert set(got) == set(want) and "val/f1_score_mean" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["mlp", "gru", "mlp_embedding"])
def test_classification_task_trains_through_the_port_trainer(kind):
    m, p, s, port = _jax_and_port(kind)
    x, y = _split(kind, 96, 40)
    vx, vy = _split(kind, 32, 41)

    class DM:
        batch_size, drop_last = 16, True
        train, val = ArraySplit(x, y), ArraySplit(vx, vy)
        test = val
        train_sampling = sampling_weights(y)

    task = ClassificationTask(port, ids_input=kind == "mlp_embedding")
    assert task.weighted_sampler
    res = Trainer(max_epochs=6, verbose=False, monitor="val/f1_score_mean",
                  mode="max").fit(task, DM(), make_radam(1e-2))
    losses = [h["train_epoch/loss"] for h in res.history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert {"train_epoch/acc", "train_epoch/f1_score", "val/acc_good",
            "val/acc_bad", "val/f1_score_mean"} <= set(res.history[-1])


def test_embedding_helpers_match_jax():
    rng = np.random.default_rng(12)
    tok = rng.standard_normal((20, 8)).astype(np.float32)
    cond_t = rng.standard_normal((3, 8)).astype(np.float32)
    ids = rng.integers(0, 20, (2, 7))
    cond = rng.integers(0, 3, 2)
    np.testing.assert_array_equal(
        embedding.positional_embedding(7, 8).numpy(),
        np.asarray(jemb.positional_embedding(7, 8)))
    np.testing.assert_allclose(
        embedding.latent_embedding(torch.from_numpy(ids),
                                   torch.from_numpy(tok)).numpy(),
        np.asarray(jemb.latent_embedding(jnp.asarray(ids),
                                         jnp.asarray(tok))), **FWD)
    np.testing.assert_allclose(
        embedding.latent_embedding_cond(
            torch.from_numpy(ids), torch.from_numpy(cond),
            torch.from_numpy(tok), torch.from_numpy(cond_t)).numpy(),
        np.asarray(jemb.latent_embedding_cond(
            jnp.asarray(ids), jnp.asarray(cond), jnp.asarray(tok),
            jnp.asarray(cond_t))), **FWD)
