"""The port's ts2vec/ against the JAX package's, on the CPU.

Counterparts of tests/test_ts2vec.py's six tests, on JAX's weights
carried over by `bridge.ts2vec_from_jax` / `ts2vec_state_dict`:

- the encoder with a handed mask (and NaN timestamps, which both zero
  and mask): 1e-5;
- `hierarchical_contrastive_loss`: 1e-5; `take_per_row`: exact;
- `fit` for five iterations, each package's mask replaced by one
  handed pattern and the representation dropout off (JAX's by patching
  the name its fit calls, in this test only): the crops equal and the
  losses within 1e-4;
- `encode` in every pooling mode (full_series, none, an int window,
  multiscale, sliding with padding, causal): 1e-5 after that fit;
- `save` / `load`; `eval_classification` where scikit-learn is there.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vq_vae_transformer_arc_welding_tpu.ts2vec.ts2vec as jts
from vq_vae_transformer_arc_welding_tpu.ts2vec import (
    hierarchical_contrastive_loss as jax_loss, ts_encoder_apply,
    ts_encoder_init)
from vq_vae_transformer_arc_welding_tpu.ts2vec.utils import (
    take_per_row as jax_take_per_row)
import vq_vae_transformer_arc_welding_tpu_torch.ts2vec.ts2vec as pts
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.ts2vec import (
    TS2Vec, eval_classification, hierarchical_contrastive_loss)
from vq_vae_transformer_arc_welding_tpu_torch.ts2vec.utils import (
    take_per_row)


def pattern(b: int, t: int) -> np.ndarray:
    """The mask handed to both packages: every third step off, by row."""
    return (np.arange(t)[None] + np.arange(b)[:, None]) % 3 != 0


@pytest.mark.parametrize("mode", ["handed", "all_true", "mask_last",
                                  "all_false"])
def test_encoder_matches_jax(rng, mode):
    params = ts_encoder_init(jax.random.PRNGKey(0), 2, 12, 8, 3)
    enc = bridge.ts2vec_from_jax(params, device="cpu")
    x = rng.standard_normal((3, 40, 2)).astype(np.float32)
    x[0, 5] = np.nan
    x[2, 17, 1] = np.nan
    m = pattern(3, 40) if mode == "handed" else mode
    ref = np.asarray(ts_encoder_apply(
        params, jnp.asarray(x), train=False,
        mask=jnp.asarray(m) if mode == "handed" else m))
    with torch.no_grad():
        out = enc(torch.as_tensor(x), train=False,
                  mask=torch.as_tensor(m) if mode == "handed" else m).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_encoder_draws_its_masks_from_the_generator(rng):
    params = ts_encoder_init(jax.random.PRNGKey(0), 2, 12, 8, 2)
    enc = bridge.ts2vec_from_jax(params, device="cpu")
    x = torch.as_tensor(rng.standard_normal((4, 30, 2)).astype(np.float32))
    outs = [enc(x, mask=mode, train=True,
                generator=torch.Generator().manual_seed(3))
            for mode in ("binomial", "binomial", "continuous")]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])
    assert all(torch.isfinite(o).all() for o in outs)


def test_hierarchical_loss_matches_jax(rng):
    z1 = rng.standard_normal((4, 8, 6)).astype(np.float32)
    z2 = rng.standard_normal((4, 8, 6)).astype(np.float32)
    for kw in ({}, dict(alpha=0.0), dict(alpha=1.0), dict(temporal_unit=2)):
        ref = float(jax_loss(jnp.asarray(z1), jnp.asarray(z2), **kw))
        ours = float(hierarchical_contrastive_loss(torch.as_tensor(z1),
                                                   torch.as_tensor(z2), **kw))
        assert ours == pytest.approx(ref, abs=1e-5), kw


def test_take_per_row_matches_jax(rng):
    a = rng.standard_normal((4, 10, 2)).astype(np.float32)
    idx = np.array([0, 2, 1, 3])
    np.testing.assert_array_equal(take_per_row(a, idx, 5),
                                  jax_take_per_row(a, idx, 5))
    for i in range(4):
        np.testing.assert_array_equal(take_per_row(a, idx, 5)[i],
                                      a[i, idx[i]:idx[i] + 5])


@pytest.fixture(scope="module")
def fitted():
    """A JAX and a port TS2Vec from one init, each fit five iterations
    with the handed pattern as its mask, recording crops and losses."""
    mp = pytest.MonkeyPatch()
    data = np.random.default_rng(0).standard_normal((24, 32, 2)).astype(
        np.float32)
    orig = jts.ts_encoder_apply

    def jax_encoder(params, x, *, mask="all_true", train=False, rng=None,
                    repr_dropout_p=0.1):
        return orig(params, x, mask=jnp.asarray(pattern(*x.shape[:2])),
                    train=False)

    crops = {"jax": [], "port": []}
    for who, mod in (("jax", jts), ("port", pts)):
        take = mod.take_per_row
        mp.setattr(mod, "take_per_row",
                   lambda a, i, n, take=take, who=who: (
                       crops[who].append((i.tolist(), n)), take(a, i, n))[1])
    mp.setattr(jts, "ts_encoder_apply", jax_encoder)
    jm = jts.TS2Vec(input_dims=2, output_dims=16, hidden_dims=8, depth=2,
                    batch_size=8, seed=0)
    pm = TS2Vec(input_dims=2, output_dims=16, hidden_dims=8, depth=2,
                batch_size=8, seed=0, device="cpu")
    sd = bridge.ts2vec_state_dict(jm.params)
    pm.net.load_state_dict(sd)
    pm.avg_net.load_state_dict(sd)
    pm.repr_dropout_p = 0.0
    losses = {"jax": [], "port": []}
    jm.after_iter_callback = lambda m, loss: losses["jax"].append(loss)
    pm.after_iter_callback = lambda m, loss: losses["port"].append(loss)
    jm.fit(data, n_iters=5)
    pm.fit(data, n_iters=5,
           mask=lambda b, t: torch.as_tensor(pattern(b, t)))
    mp.undo()
    return jm, pm, data, crops, losses


def test_fit_matches_jax(fitted):
    jm, pm, _, crops, losses = fitted
    assert len(crops["port"]) == 10 and crops["port"] == crops["jax"]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=0,
                               atol=1e-4)
    assert pm.n_iters == jm.n_iters == 5 and pm.n_averaged == jm.n_averaged


@pytest.mark.parametrize("kw", [
    dict(encoding_window="full_series"), dict(), dict(encoding_window=4),
    dict(encoding_window=5), dict(encoding_window="multiscale"),
    dict(sliding_length=8, sliding_padding=4, encoding_window="full_series"),
    dict(sliding_length=8, sliding_padding=4, causal=True),
    dict(batch_size=5)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "none")
def test_encode_matches_jax(fitted, kw):
    jm, pm, data, _, _ = fitted
    ref = jm.encode(data, **kw)
    out = pm.encode(data, **kw)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_save_load(tmp_path, fitted):
    _, pm, data, _, _ = fitted
    fn = str(tmp_path / "ts2vec.pt")
    pm.save(fn)
    other = TS2Vec(input_dims=2, output_dims=16, hidden_dims=8, depth=2,
                   batch_size=8, seed=1, device="cpu")
    other.load(fn)
    np.testing.assert_array_equal(pm.encode(data, encoding_window="full_series"),
                                  other.encode(data,
                                               encoding_window="full_series"))


def test_eval_classification(rng):
    pytest.importorskip("sklearn")
    y = rng.integers(0, 2, 40)
    data = (rng.standard_normal((40, 16, 2)) * 0.1
            + y[:, None, None] * 1.0).astype(np.float32)
    model = TS2Vec(input_dims=2, output_dims=8, hidden_dims=8, depth=1,
                   batch_size=8, seed=0, device="cpu")
    model.fit(data, n_epochs=2)
    _, res = eval_classification(model, data, y, data, y, data, y,
                                 eval_protocol="linear")
    assert set(res) == {"0/val/acc", "0/test/acc", "0/val/auprc",
                        "0/test/auprc", "0/val/f1score", "0/test/f1score"}
    assert res["0/test/acc"] > 0.9
