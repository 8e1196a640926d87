"""The port's RAdam chains against the JAX package's on the CPU.

`make_radam` and `make_transformer_optimizer` of both packages take the
same gradients for 8 steps, through RAdam's rectification boundary,
with global-norm clipping, with the weight-decay split, and with a
parameter that has no gradient on alternate steps (torch's `grad is
None`, the JAX chain's all-zero gradient): the per-parameter step
counts equal, and the parameters within 1e-6 at the transformer's betas
(0.9, 0.95). At the default betas (0.9, 0.999) the bound is the JAX
package's own against torch (tests/test_optim.py:62-69, rtol 1e-4, atol
2e-5): the JAX chain computes rho_t = rho_inf - 2t b2^t / (1 - b2^t) in
f32, where 1 - 0.999^t cancels to about 1e-5 of relative error and rho_t
near 5 takes it from rho_inf ~ 2000, so its rectification factor is off
by ~1e-4 of the update; torch, and the port, compute it in float64.
Mirrors tests/test_optim.py.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vq_vae_transformer_arc_welding_tpu.models import TransformerDecoder
from vq_vae_transformer_arc_welding_tpu.train import optim as joptim
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.train import optim as toptim

STEPS = 8
TOL = dict(rtol=0, atol=1e-6)
# the JAX package's bound for its f32 rectification at betas (0.9, 0.999)
TOL_DEFAULT_BETAS = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers' (the lane runs six processes on the host's
    cores), so these tests use one and give it back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_counts(opt_state):
    """The per-leaf step counts of the chain's RAdam state."""
    radam = next(s for s in opt_state if isinstance(s, joptim._RAdamState))
    return radam.count


def _run(shapes: dict, spec_kw: dict, idle: set, lr=1e-2, scale=1.0,
         decay: set | None = None):
    """Both chains on the same random parameters and gradients; `idle`
    parameters get a gradient on odd steps only."""
    rng = np.random.default_rng(0)
    w0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    grads = [{n: (rng.standard_normal(s) * scale).astype(np.float32)
              for n, s in shapes.items()} for _ in range(STEPS)]

    mask = None if decay is None else {n: n in decay for n in shapes}
    tx = joptim.make_radam(lr, decay_mask=mask, **spec_kw)
    params = {n: jnp.asarray(w) for n, w in w0.items()}
    opt = tx.init(params)
    for i, g in enumerate(grads):
        g = {n: (jnp.zeros_like(v) if n in idle and i % 2 == 0
                 else jnp.asarray(v)) for n, v in g.items()}
        updates, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, updates)

    named = [(n, torch.nn.Parameter(torch.tensor(w))) for n, w in w0.items()]
    port = toptim.make_radam(lr, decay_mask=decay, **spec_kw).init(named)
    for i, g in enumerate(grads):
        port.zero_grad()
        for n, p in named:
            if not (n in idle and i % 2 == 0):
                p.grad = torch.tensor(g[n])
        port.step()
    return params, _jax_counts(opt), dict(named), port


@pytest.mark.parametrize("case", ["defaults", "clipped", "decay_split",
                                  "idle_head"])
def test_make_radam_matches_jax(case):
    shapes = {"w": (4, 3), "b": (3,), "head": (3, 2)}
    kw, idle, decay, scale = {}, set(), None, 1.0
    if case == "clipped":
        kw, scale = dict(clip_norm=0.8), 3.0
    elif case == "decay_split":
        kw = dict(betas=(0.9, 0.95), weight_decay=0.1, clip_norm=0.8)
        decay = {"w", "head"}
    elif case == "idle_head":
        kw = dict(betas=(0.9, 0.95), weight_decay=0.1, clip_norm=0.8)
        decay, idle = {"w", "head"}, {"head"}
    j_params, j_counts, t_params, port = _run(shapes, kw, idle, scale=scale,
                                              decay=decay)
    tol = TOL if "betas" in kw else TOL_DEFAULT_BETAS
    for n in shapes:
        np.testing.assert_allclose(t_params[n].detach().numpy(),
                                   np.asarray(j_params[n]), **tol, err_msg=n)
    counts = port.step_counts()
    assert counts == {n: int(j_counts[n]) for n in shapes}
    assert counts["w"] == STEPS
    assert counts["head"] == (STEPS // 2 if idle else STEPS)


def test_rectification_boundary_is_crossed():
    """RAdam's update leaves its momentum branch once rho_t > 5: after
    step 5 with betas (0.9, 0.999); 8 steps cross it."""
    b2 = 0.999
    rho_inf = 2 / (1 - b2) - 1

    def rho(t):
        return rho_inf - 2 * t * b2 ** t / (1 - b2 ** t)

    assert rho(5) <= 5 < rho(6) and 6 <= STEPS


def test_idle_parameter_is_untouched_by_decay_and_moments():
    w = torch.nn.Parameter(torch.ones(4, 4))
    idle = torch.nn.Parameter(torch.ones(4, 4))
    opt = toptim.make_radam(1e-1, betas=(0.9, 0.95), weight_decay=0.1,
                            clip_norm=0.8).init([("w", w), ("idle", idle)])
    for _ in range(20):
        opt.zero_grad()
        w.grad = torch.full((4, 4), 0.01)
        opt.step()
    assert torch.equal(idle, torch.ones(4, 4))
    assert idle not in opt.optimizer.state
    assert float((w.detach() - 1).abs().max()) > 1e-3
    assert opt.step_counts() == {"w": 20, "idle": 0}


def test_transformer_optimizer_matches_jax_on_the_alternating_tasks():
    """make_transformer_optimizer on a bridged model: the gen task's
    steps leave the class head without a gradient, the class task's the
    lm_head (the reference's alternating schedule)."""
    tr = TransformerDecoder(d_model=32, n_classes=18, seq_len=9, n_blocks=2,
                            n_head=4, res_dropout=0.0)
    params, _ = tr.init(3)
    tx = joptim.make_transformer_optimizer(tr, params, clip_norm=0.8)
    opt = tx.init(params)
    port = bridge.transformer_from_jax(tr.hparams, params, device="cpu")
    popt = toptim.make_transformer_optimizer(port, clip_norm=0.8).init(port)
    rng = np.random.default_rng(4)
    xn, yn, cn = (rng.integers(0, 18, (4, 9)), rng.integers(0, 18, (4, 9)),
                  rng.integers(0, 2, 4))
    x, y, c = jnp.asarray(xn), jnp.asarray(yn), jnp.asarray(cn)

    def loss(p, gen):
        logits, _ = tr.apply(p, None, x, generate=gen)
        return tr.loss_gen(logits, y) if gen else tr.loss_class(logits, c)

    grad = jax.jit(jax.grad(loss), static_argnums=1)
    update = jax.jit(tx.update)
    port.requires_grad_(True)
    for i in range(STEPS):
        gen = i % 3 != 2
        g = grad(params, gen)
        updates, opt = update(g, opt, params)
        params = optax.apply_updates(params, updates)
        popt.zero_grad()
        logits = port.apply(torch.from_numpy(xn), generate=gen)
        (port.loss_gen(logits, torch.from_numpy(yn)) if gen else
         port.loss_class(logits, torch.from_numpy(cn))).backward()
        popt.step()
    ref = bridge.transformer_from_jax(tr.hparams, params, device="cpu")
    sd = port.state_dict()
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(sd[k].detach().numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    counts = popt.step_counts()
    assert counts["lm_head.weight"] == 6
    assert counts["class_head.linear_1.weight"] == 2
    assert counts["transformer.h.0.attn.c_attn.weight"] == STEPS
    j_counts = _jax_counts(opt)
    assert int(j_counts["lm_head_w"]) == 6
    assert int(j_counts["class_head"]["l1_w"]) == 2


def test_cosine_warmup_schedule_matches_jax():
    j = joptim.cosine_warmup_schedule(5, 40)
    t = toptim.cosine_warmup_schedule(5, 40)
    for step in range(0, 45):
        assert math.isclose(t(step), float(j(step)), rel_tol=1e-6,
                            abs_tol=1e-7), step
    w = torch.nn.Parameter(torch.zeros(2))
    opt = toptim.make_radam(1e-2, schedule=t).init([("w", w)])
    lrs = []
    for _ in range(8):
        lrs.append(opt.optimizer.param_groups[0]["lr"])
        opt.zero_grad()
        w.grad = torch.ones(2)
        opt.step()
    assert lrs == pytest.approx([1e-2 * t(s) for s in range(8)])
