"""The port's Trainer on the CPU: against the JAX Trainer on full
batches, and the behaviour contracts of tests/test_train.py.

Full batch: with the batch the whole train split, one micro batch a
step, uniform sampling, dropout 0 and BatchNorm off, each epoch's only
batch is the same set of rows in both packages (the permutation only
reorders a mean), so `fit` for 3 epochs with make_radam(clip_norm=0.7)
must leave parameters within rtol 1e-3, atol 2e-4 of the JAX Trainer's,
and per-epoch val losses within 1e-4. Then, on the port's own Trainer:
reconstruction improves, early stopping, terminate_on_nan, resume from
last equals the uninterrupted run bit for bit with dropout on,
accumulation equals the mean of its micro batches' steps, best and last checkpoints with the
optimizer's state through `Model.load`, the transformer's two tasks on
one optimizer, and the options that raise.
"""
import os

import numpy as np
import pytest
import torch

import jax

from vq_vae_transformer_arc_welding_tpu.models import VQVAEPatch as JaxVQVAE
from vq_vae_transformer_arc_welding_tpu.train.loop import Trainer as JaxTrainer
from vq_vae_transformer_arc_welding_tpu.train.optim import (
    make_radam as jax_make_radam)
from vq_vae_transformer_arc_welding_tpu.train.tasks import (
    ReconstructionTask as JaxReconstructionTask)
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.data import (ArraySplit,
                                                           ASIMoWDataModule,
                                                           get_val_test_ids)
from vq_vae_transformer_arc_welding_tpu_torch.data.synthetic import (
    write_synthetic_csv)
from vq_vae_transformer_arc_welding_tpu_torch.models import (
    TransformerDecoder, VQVAEPatch)
from vq_vae_transformer_arc_welding_tpu_torch.train.checkpoint import (
    load_training_state)
from vq_vae_transformer_arc_welding_tpu_torch.train.loop import (
    Trainer, epoch_generators)
from vq_vae_transformer_arc_welding_tpu_torch.train.optim import (
    make_radam, make_transformer_optimizer)
from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
    ReconstructionTask, TransformerClassTask, TransformerGenTask)

TRAJ = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers' (the lane runs six processes on the host's
    cores), so these tests use one and give it back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("asimow_port_train")
    write_synthetic_csv(str(d / "processed_asimow_dataset.csv"),
                        n_cycles_per_run=8, extra_train_runs=4)
    return str(d)


def datamodule(data_dir, batch_size, **kw):
    ids = get_val_test_ids()
    dm = ASIMoWDataModule(task="reconstruction", n_cycles=1,
                          val_data_ids=ids["val_ids"],
                          test_data_ids=ids["test_ids"],
                          batch_size=batch_size,
                          data_directory_path=data_dir, **kw)
    dm.setup()
    return dm


def vqvae(dropout_p=0.0, batch_norm=False, seed=0, hidden=16):
    return VQVAEPatch(hidden, 2, 8, 4, 1, dropout_p=dropout_p,
                      batch_norm=batch_norm,
                      generator=torch.Generator().manual_seed(seed),
                      device="cpu")


def test_full_batch_fit_matches_the_jax_trainer(data_dir):
    dm = datamodule(data_dir, batch_size=1)
    dm.batch_size = n = len(dm.train.x)
    assert n == 32
    jm = JaxVQVAE(hidden_dim=16, input_dim=2, num_embeddings=8,
                  embedding_dim=4, n_resblocks=1, learning_rate=1e-3,
                  dropout_p=0.0, batch_norm=False)
    params, state = jm.init(5)
    port = bridge.vqvae_from_jax(jm.hparams, params, state, device="cpu")
    copy = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    j_res = JaxTrainer(max_epochs=3, monitor="val/loss", verbose=False).fit(
        JaxReconstructionTask(jm), dm, copy(params), copy(state),
        jax_make_radam(1e-3, clip_norm=0.7))
    res = Trainer(max_epochs=3, monitor="val/loss", verbose=False).fit(
        ReconstructionTask(port), dm, make_radam(1e-3, clip_norm=0.7))
    ref = bridge.vqvae_from_jax(jm.hparams, j_res.final_params,
                                j_res.final_state, device="cpu")
    sd = port.state_dict()
    moved = 0
    start = bridge.vqvae_from_jax(jm.hparams, params, state,
                                  device="cpu").state_dict()
    for k, v in ref.state_dict().items():
        if "num_batches_tracked" in k:      # BatchNorm1d's; JAX keeps none
            continue
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **TRAJ,
                                   err_msg=k)
        moved += not torch.equal(v, start[k])
    assert moved > 10
    j_val = [h["val/loss"] for h in j_res.history]
    val = [h["val/loss"] for h in res.history]
    assert len(val) == len(j_val) == 3
    np.testing.assert_allclose(val, j_val, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        [h["train_epoch/loss"] for h in res.history],
        [h["train_epoch/loss"] for h in j_res.history], rtol=0, atol=1e-4)
    assert not any(p.requires_grad for p in port.parameters())


def test_reconstruction_training_improves(data_dir, tmp_path):
    dm = datamodule(data_dir, batch_size=8)
    model = vqvae()
    res = Trainer(max_epochs=4, monitor="val/loss", mode="min", patience=8,
                  min_delta=1e-4, checkpoint_dir=str(tmp_path / "ck"),
                  save_last=True, verbose=False).fit(
        ReconstructionTask(model), dm, make_radam(2e-3, clip_norm=0.7))
    tls = [h["train_epoch/loss"] for h in res.history]
    assert len(tls) == 4 and tls[-1] < tls[0], tls
    assert np.isfinite([h["val/loss"] for h in res.history]).all()
    assert all(h["train_epoch/windows_per_s"] > 0 for h in res.history)
    assert os.path.exists(tmp_path / "ck" / "last.ckpt")
    assert os.path.exists(tmp_path / "ck" / "best.ckpt")


def test_early_stopping_triggers(data_dir):
    dm = datamodule(data_dir, batch_size=16)
    res = Trainer(max_epochs=30, monitor="val/loss", mode="min", patience=2,
                  min_delta=0.001, verbose=False).fit(
        ReconstructionTask(vqvae()), dm, make_radam(0.0))
    assert res.stopped_early
    assert len(res.history) == 3 and res.best_epoch == 0


def test_terminate_on_nan():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 200, 2)).astype(np.float32)
    x[5] = np.nan

    class DM:
        drop_last = True
        train_sampling = None
        batch_size = 8
        train = ArraySplit(x)
        val = ArraySplit(x[:8])
        test = val

    with pytest.raises(FloatingPointError, match="non-finite"):
        Trainer(max_epochs=2, verbose=False, terminate_on_nan=True).fit(
            ReconstructionTask(vqvae()), DM(), make_radam(1e-2))


def test_resume_from_last_matches_uninterrupted(data_dir, tmp_path):
    """3 epochs straight against 2 + resume 1, dropout on and BatchNorm
    on: the same parameters and statistics, bit for bit."""
    dm = datamodule(data_dir, batch_size=16)
    tx = make_radam(1e-3, clip_norm=0.7)
    a = vqvae(dropout_p=0.3, batch_norm=True)
    Trainer(max_epochs=3, seed=11, verbose=False).fit(
        ReconstructionTask(a), dm, tx)
    ck = str(tmp_path / "resume")
    b = vqvae(dropout_p=0.3, batch_norm=True)
    Trainer(max_epochs=2, seed=11, verbose=False, checkpoint_dir=ck,
            save_last=True).fit(ReconstructionTask(b), dm, tx)
    c = vqvae(dropout_p=0.3, batch_norm=True)
    res = Trainer(max_epochs=3, seed=11, verbose=False).fit(
        ReconstructionTask(c), dm, tx, resume_from=f"{ck}/last.ckpt")
    assert [h["epoch"] for h in res.history] == [2]
    for k, v in a.state_dict().items():
        assert torch.equal(c.state_dict()[k], v), k
    # another seed draws other masks and batches
    d = vqvae(dropout_p=0.3, batch_norm=True)
    Trainer(max_epochs=3, seed=12, verbose=False).fit(
        ReconstructionTask(d), dm, tx)
    assert not torch.equal(d.codebook, a.codebook)


def test_epoch_generators_depend_on_seed_and_epoch_only():
    a = [torch.rand(4, generator=g) for g in epoch_generators(3, 7, "cpu")]
    b = [torch.rand(4, generator=g) for g in epoch_generators(3, 7, "cpu")]
    c = [torch.rand(4, generator=g) for g in epoch_generators(3, 8, "cpu")]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])


def test_grad_accumulation_equivalent_to_mean_of_micro_batches():
    """accumulate_grad_batches=4: the mean of the four micro batches'
    gradients, then one step. Against the same index stream and the same
    step by hand; the inverse patch embedding's BatchNorm normalizes per
    micro batch, so this, not one 32-row batch, is the contract (as in
    tests/test_train.py::test_grad_accumulation_equivalent_to_large_batch)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 200, 2)).astype(np.float32)

    class DM:
        batch_size = 8
        drop_last = True
        train_sampling = None
        train = ArraySplit(x)
        val = ArraySplit(x[:8])
        test = val

    acc = vqvae(seed=3)
    tr = Trainer(max_epochs=1, accumulate_grad_batches=4, seed=7,
                 verbose=False)
    tr.fit(ReconstructionTask(acc), DM(), make_radam(1e-2))

    ref = vqvae(seed=3).requires_grad_(True)
    groups = tr._train_indices(epoch_generators(7, 0, "cpu")[0], 32, 8,
                               None, True)
    assert groups.shape == (1, 4, 8)
    params = list(ref.parameters())
    grads = [torch.zeros_like(p) for p in params]
    for idx in groups[0]:
        loss, (_, new) = ref.loss_fn(torch.from_numpy(x)[idx], train=True)
        for g, d in zip(grads, torch.autograd.grad(loss, params)):
            g += d
        ref.commit_state(new)
    opt = make_radam(1e-2).init(ref)
    for p, g in zip(params, grads):
        p.grad = g / 4
    opt.step()
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(acc.state_dict()[k], v, rtol=1e-5,
                                   atol=1e-6)
    assert not torch.equal(acc.codebook, vqvae(seed=3).codebook)


def test_best_and_last_checkpoints_round_trip(data_dir, tmp_path):
    class Logger:
        log_model = True

        def __init__(self):
            self.rows, self.artifacts = [], []

        def log_metrics(self, metrics, step=None):
            self.rows.append((step, metrics))

        def log_artifact(self, path, name=None, type_="model"):
            self.artifacts.append(name)

    dm = datamodule(data_dir, batch_size=16)
    model = vqvae(batch_norm=True)
    logger = Logger()
    seen = []
    ck = tmp_path / "ck"
    res = Trainer(max_epochs=3, monitor="val/loss", checkpoint_dir=str(ck),
                  checkpoint_name="vq-best", save_last=True, verbose=False,
                  logger=logger, log_every_n_batches=2,
                  epoch_metric_hook=lambda e, m: seen.append(e)).fit(
        ReconstructionTask(model), dm, make_radam(1e-3, clip_norm=0.7))
    assert seen == [0, 1, 2]
    assert {"vq-best.ckpt", "last.ckpt"} <= set(logger.artifacts)
    assert any("train/loss" in m for _, m in logger.rows)
    assert any("val/perplexity" in m for _, m in logger.rows)
    best = VQVAEPatch.load(res.best_ckpt_path, device="cpu")
    for k, v in res.state_dict.items():
        assert torch.equal(best.state_dict()[k], v), k
    last = VQVAEPatch.load(str(ck / "last.ckpt"), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(last.state_dict()[k], v), k
    # the optimizer's state comes back into a new optimizer of the model
    opt_state, sched_state, extra = load_training_state(str(ck / "last.ckpt"))
    assert extra["epoch"] == 2 and sched_state is None
    fresh = make_radam(1e-3, clip_norm=0.7).init(last)
    fresh.load_state_dicts(opt_state, sched_state)
    want = res.optimizer.optimizer.state_dict()["state"]
    got = fresh.optimizer.state_dict()["state"]
    assert set(got) == set(want) and want
    for i in want:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got[i][name], want[i][name]), (i, name)
    assert fresh.step_counts() == res.optimizer.step_counts()
    assert set(fresh.step_counts().values()) == {3 * (32 // 16)}
    with pytest.raises(ValueError, match="no optimizer state"):
        load_training_state(res.best_ckpt_path)


def test_transformer_tasks_share_one_optimizer():
    """The alternating schedule: gen then class on one optimizer. The
    class stage samples by class weight, leaves the lm_head without a
    gradient (its RAdam step count stays), and logs under cl/."""
    rng = np.random.default_rng(2)
    n, t, v = 48, 9, 18
    ids = rng.integers(0, v - 2, (n, t))
    cond = (rng.random(n) < 0.25).astype(np.int64)

    class DM:
        batch_size = 8
        drop_last = False
        train = ArraySplit(ids, np.roll(ids, -1, axis=1), cond)
        val = ArraySplit(ids[:20], np.roll(ids[:20], -1, axis=1), cond[:20])
        test = val
        train_sampling = np.where(cond == 1, 0.75, 0.25).astype(np.float32)

    model = TransformerDecoder(d_model=32, n_classes=v, seq_len=t,
                               n_blocks=2, n_head=4, res_dropout=0.1,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    tx = make_transformer_optimizer(model, clip_norm=0.8)
    opt = tx.init(model)
    gen = Trainer(max_epochs=2, accumulate_grad_batches=5, verbose=False)
    res = gen.fit(TransformerGenTask(model), DM(), tx, opt=opt)
    after_gen = opt.step_counts()
    assert after_gen["lm_head.weight"] == 2 * 2   # ceil(6 / 5) groups
    assert after_gen["class_head.linear_1.weight"] == 0
    assert "val/loss" in res.history[-1]
    head = model.lm_head.weight.detach().clone()
    cls = Trainer(max_epochs=1, accumulate_grad_batches=5, verbose=False,
                  monitor="val/cl/f1_score", mode="max")
    seen = []
    real = cls._train_indices

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out)
        return out

    cls._train_indices = spy
    res = cls.fit(TransformerClassTask(model), DM(), tx, opt=opt)
    counts = opt.step_counts()
    assert counts["lm_head.weight"] == after_gen["lm_head.weight"]
    assert counts["class_head.linear_1.weight"] == 2
    assert torch.equal(model.lm_head.weight, head)
    assert {"val/cl/loss", "val/cl/f1_score", "val/cl/acc_good"} <= set(
        res.history[-1])
    # weighted sampling with replacement: the minority class drawn ~half
    drawn = cond[seen[0].reshape(-1).numpy()]
    assert seen[0].shape == (2, 5, 8) and 0.3 < drawn.mean() < 0.7
    test = cls.test(TransformerClassTask(model), DM())
    assert set(test) == {"test/cl/loss", "test/cl/acc", "test/cl/f1_score",
                         "test/cl/acc_good", "test/cl/acc_bad"}


@pytest.mark.parametrize("kw, error, match", [
    # streaming is ported (tests/test_torch_streaming.py); over a mesh
    # it raises, as in the JAX package (the case keeps its id)
    pytest.param(dict(streaming=True, mesh=object()), NotImplementedError,
                 "streaming \\+ mesh", id="kw0-queue 1 item 2"),
    # mesh= and param_rules= are ported (tests/test_torch_parallel.py):
    # they raise only where they cannot run, a mesh this process is not
    # a rank of, and rules without a mesh (the cases keep their ids)
    pytest.param(dict(mesh=object()), ValueError, "rank of the mesh",
                 id="kw1-queue 1 item 6"),
    pytest.param(dict(param_rules={}), ValueError, "needs a mesh",
                 id="kw2-queue 1 item 6"),
    pytest.param(dict(dropout_prng="rbg"), NotImplementedError, "Philox",
                 id="kw3-Philox")])
def test_unported_trainer_options_raise(kw, error, match):
    with pytest.raises(error, match=match):
        Trainer(**kw)
    with pytest.raises(ValueError):
        Trainer(dropout_prng="philox")


def test_bf16_training_and_ondevice_windows_raise(data_dir):
    """Both are ported and no longer raise (tests/test_torch_train_bf16.py
    and tests/test_torch_windowed.py hold them against JAX): a bf16
    training forward gives f32 logits whose gradients reach the f32
    weights, and 'ondevice' windows come out as a WindowedArray."""
    model = TransformerDecoder(d_model=32, n_classes=18, seq_len=9,
                               n_blocks=1, n_head=4, device="cpu",
                               compute_dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    logits = model.apply(torch.zeros(2, 9, dtype=torch.long), train=True,
                         generator=torch.Generator())
    logits.float().sum().backward()
    assert logits.dtype == torch.float32
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert {n for n, g in grads.items() if g is None} == {
        "class_head.linear_1.weight", "class_head.linear_2.weight"}
    assert all(g.dtype == torch.float32 for g in grads.values()
               if g is not None)
    ids = get_val_test_ids()
    dm = ASIMoWDataModule(task="classification", n_cycles=2,
                          val_data_ids=ids["val_ids"],
                          test_data_ids=ids["test_ids"], batch_size=8,
                          data_directory_path=data_dir, window_mode="ondevice")
    dm.setup()
    assert type(dm.train.x).__name__ == "WindowedArray"


def test_profile_dir_traces_epoch_one(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 200, 2)).astype(np.float32)

    class DM:
        batch_size = 8
        drop_last = True
        train_sampling = None
        train = ArraySplit(x)
        val = ArraySplit(x[:8])
        test = val

    prof = tmp_path / "prof"
    res = Trainer(max_epochs=2, verbose=False, profile_dir=str(prof),
                  metric_prefix="vq_").fit(
        ReconstructionTask(vqvae()), DM(), make_radam(1e-3))
    assert sorted(os.listdir(prof)) == ["epoch1.trace.json"]
    assert os.path.getsize(prof / "epoch1.trace.json") > 0
    assert "vq_val/loss" in res.history[-1]
