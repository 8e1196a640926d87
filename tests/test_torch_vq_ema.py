"""The port's EMA VQ (ops/vq_ema.py, `VQVAEPatch(use_improved_vq=True)`)
against the JAX package on the CPU.

The JAX package draws two sets of row indices with jax.random.randint:
the kmeans's initial means and the rows that re-seed dead codes. The
tests draw them with the same JAX calls and hand them to the port
(`draws=`, `vq_draws=`), so both packages run on the same rows. Bounds:
ids equal; codebooks, EMA statistics, losses, perplexities and the OOD
score within 1e-5 absolute or 1e-6 relative (the batch sums are one-hot
matmuls in both, summed in other orders; a perplexity of ~27 moved by
7e-7 of itself); the VQ-VAE's forward and new state likewise.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.models import VQVAEPatch
from vq_vae_transformer_arc_welding_tpu.ops import vq_ema as jema
from vq_vae_transformer_arc_welding_tpu.train import torch_import as jimport
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.models import (
    VQVAEPatch as PortVQVAE)
from vq_vae_transformer_arc_welding_tpu_torch.models.vqvae_patch import (
    EMA_PREFIX)
from vq_vae_transformer_arc_welding_tpu_torch.ops import vq_ema
from vq_vae_transformer_arc_welding_tpu_torch.train import torch_import
from vq_vae_transformer_arc_welding_tpu_torch.train.loop import Trainer
from vq_vae_transformer_arc_welding_tpu_torch.train.optim import make_radam
from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
    ReconstructionTask)

TOL = dict(rtol=1e-6, atol=1e-5)
K, D = 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _z(shape=(4, 16, D), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _draws(key, n, k=K):
    """The JAX package's two draws from one key (quantize_ema's split)."""
    r_init, r_expire = jax.random.split(key)
    return (np.array(jax.random.randint(r_init, (k,), 0, n)),
            np.array(jax.random.randint(r_expire, (k,), 0, n)))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _port_state(st) -> vq_ema.EMAState:
    return vq_ema.EMAState(_t(st.codebook), _t(st.cluster_size),
                           _t(st.embed_avg),
                           torch.tensor(int(st.initialized), dtype=torch.int32))


def _same_state(port: vq_ema.EMAState, jst):
    for name in ("codebook", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(jst, name)), **TOL,
                                   err_msg=name)
    assert int(port.initialized) == int(jst.initialized)


@pytest.mark.parametrize("iters", [0, 1, 5])
def test_port_kmeans_matches_jax(iters):
    z = _z((256, D), 1)
    key = jax.random.PRNGKey(iters)
    idx = np.array(jax.random.randint(key, (K,), 0, len(z)))
    j_means, j_counts = jema._kmeans(jnp.asarray(z), K, iters, key)
    means, counts = vq_ema._kmeans(torch.from_numpy(z), K, iters,
                                   torch.from_numpy(idx))
    np.testing.assert_allclose(means.numpy(), np.asarray(j_means), **TOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


@pytest.mark.parametrize("threshold", [0, 2])
def test_port_quantize_ema_matches_jax(threshold):
    """Three calls: the bootstrap (kmeans on the first batch), a second
    training batch on the new state, and eval. 64 rows for 32 codes, so
    that codes starve and are re-seeded where the threshold is on."""
    jst = jema.EMAState.create(K, D)
    st = vq_ema.EMAState.create(K, D)
    for i, train in enumerate((True, True, False)):
        z = _z(seed=10 + i)
        key = jax.random.PRNGKey(20 + i)
        j_out, jst_new = jema.quantize_ema(
            jnp.asarray(z), jst, train=train, rng=key, kmeans_iters=3,
            threshold_ema_dead_code=threshold)
        out, st_new = vq_ema.quantize_ema(
            torch.from_numpy(z), st, train=train, kmeans_iters=3,
            threshold_ema_dead_code=threshold,
            draws=tuple(map(torch.from_numpy, _draws(key, 64))))
        np.testing.assert_array_equal(out.indices.numpy(),
                                      np.asarray(j_out.indices))
        for name in ("loss", "z_q", "perplexity"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(j_out, name)),
                                       **TOL, err_msg=name)
        _same_state(st_new, jst_new)
        if train and threshold:
            assert int((st_new.cluster_size == threshold).sum()) > 0
        jst, st = jst_new, st_new


def test_port_quantize_ema_draws_from_the_generator():
    z = torch.from_numpy(_z(seed=3))
    st = vq_ema.EMAState.create(K, D)

    def run(seed):
        return vq_ema.quantize_ema(
            z, st, train=True, kmeans_iters=2,
            generator=torch.Generator().manual_seed(seed))[1].codebook

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="Generator"):
        vq_ema.quantize_ema(z, st, train=True)
    # eval needs no draw
    vq_ema.quantize_ema(z, st, train=False)


def test_port_nearest_ema_and_ood_match_jax():
    z = _z(seed=5)
    jst = jema.quantize_ema(jnp.asarray(_z(seed=6)),
                            jema.EMAState.create(K, D), train=True,
                            rng=jax.random.PRNGKey(1), kmeans_iters=2)[1]
    st = _port_state(jst)
    np.testing.assert_array_equal(
        vq_ema.nearest_ema(torch.from_numpy(z), st).numpy(),
        np.asarray(jema.nearest_ema(jnp.asarray(z), jst)))
    np.testing.assert_allclose(
        vq_ema.quantize_ood(torch.from_numpy(z), st).numpy(),
        np.asarray(jema.quantize_ood(jnp.asarray(z), jst)), **TOL)


@functools.cache
def _jax_ema_vqvae():
    m = VQVAEPatch(hidden_dim=16, input_dim=2, num_embeddings=K,
                   embedding_dim=D, n_resblocks=1, learning_rate=1e-3,
                   dropout_p=0.0, batch_norm=True, use_improved_vq=True,
                   kmeans_iters=3, threshold_ema_dead_code=2)
    p, s = m.init(0)
    return m, p, s


def _cycles(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 200, 2)).astype(np.float32)


def test_port_ema_vqvae_trains_as_jax():
    """Two training forwards (the bootstrap, then the EMA moving) and the
    eval paths of an EMA VQ-VAE bridged from JAX: losses, metrics, x_hat
    and the new state (EMA buffers and BatchNorm statistics) within
    1e-5, ids equal."""
    m, p, s = _jax_ema_vqvae()
    port = bridge.vqvae_from_jax(m.hparams, p, s, device="cpu")
    assert port.use_improved_vq and int(port.ema.initted) == 0
    for step in range(2):
        x = _cycles(4, 30 + step)
        key = jax.random.PRNGKey(40 + step)
        j_loss, (j_m, s) = m.loss_fn(p, s, jnp.asarray(x), train=True,
                                     rng=key)
        r_vq = jax.random.split(key, 3)[1]
        with torch.no_grad():
            loss, (met, new) = port.loss_fn(
                torch.from_numpy(x), train=True,
                vq_draws=tuple(map(torch.from_numpy, _draws(r_vq, 64))))
        np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), **TOL)
        for k in ("recon_error", "perplexity"):
            np.testing.assert_allclose(met[k].numpy(), np.asarray(j_m[k]),
                                       **TOL, err_msg=k)
        port.commit_state(new)
        _same_state(port.ema.state(), s["vq"])
        np.testing.assert_allclose(
            port.state_dict()["reverse_patch_embed.proj.1.running_mean"]
            .numpy(), np.asarray(s["inverse_bn"].mean), **TOL)
    x = jnp.asarray(_cycles(3, 50))
    with torch.no_grad():
        xt = torch.from_numpy(np.array(x))
        np.testing.assert_array_equal(port.encode_indices(xt).numpy(),
                                      np.asarray(m.encode_indices(p, s, x)))
        np.testing.assert_allclose(port.encode_zq(xt).numpy(),
                                   np.asarray(m.encode_zq(p, s, x)), **TOL)
        np.testing.assert_allclose(port.forward_ood(xt).numpy(),
                                   np.asarray(m.forward_ood(p, s, x)), **TOL)
    assert torch.equal(port.codebook, port.ema.embed[0])


def test_ema_vqvae_checkpoints_carry_the_codebook(tmp_path):
    """The JAX exporter's Lightning file (no `initted` flag: read as
    bootstrapped, as the JAX reader does), the bridge and the port's own
    save / load all carry the EMA codebook and its statistics."""
    m, p, s = _jax_ema_vqvae()
    s = m.loss_fn(p, s, jnp.asarray(_cycles(4, 60)), train=True,
                  rng=jax.random.PRNGKey(2))[1][1]
    path = jimport.export_vqvae_to_lightning(m, p, s,
                                             str(tmp_path / "ema.ckpt"))
    loaded = torch_import.load_vqvae_checkpoint(path, device="cpu")
    bridged = bridge.vqvae_from_jax(m.hparams, p, s, device="cpu")
    assert loaded.use_improved_vq and int(loaded.ema.initted) == 1
    for k, v in bridged.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(loaded.state_dict()[k], v), k
    bridged.save(str(tmp_path / "port.ckpt"))
    again = PortVQVAE.load(str(tmp_path / "port.ckpt"), device="cpu")
    assert again.use_improved_vq and again.kmeans_iters == 3
    for k, v in bridged.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    assert set(again.state_dict()) >= {f"{EMA_PREFIX}.{n}" for n in (
        "embed", "cluster_size", "embed_avg", "initted")}


def test_ema_vqvae_fits_through_the_port_trainer():
    """The trainer commits the EMA state with the BatchNorm statistics:
    the codebook is bootstrapped by the first batch and moves after."""
    x = _cycles(64, 70)

    class DM:
        batch_size, drop_last, train_sampling = 16, True, None
        train = val = test = type("S", (), {"x": x, "__len__":
                                            lambda self: len(x)})()

    model = PortVQVAE(16, 2, K, D, 1, dropout_p=0.1, use_improved_vq=True,
                      kmeans_iters=2, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert float(model.codebook.abs().sum()) == 0.0
    res = Trainer(max_epochs=2, verbose=False).fit(
        ReconstructionTask(model), DM(), make_radam(1e-3))
    assert all(np.isfinite(h["train_epoch/loss"]) for h in res.history)
    assert int(model.ema.initted) == 1
    assert float(model.codebook.abs().sum()) > 0
