"""The port's three training CLIs on the CPU, against the JAX CLIs.

Each CLI runs through `main` in a working directory of its own (the
CLIs write `logs/` and `model_checkpoints/` there) on data/synthetic.py's
CSV, with `--device cpu`. Where both packages must start from the same
weights, the model class in the port CLI's namespace is replaced by a
factory that builds the JAX model from the same flags and carries its
`init(seed)` over through `bridge.*_from_jax`.

- Parsers: every option of the JAX parser, with its dest, default,
  type, choices and action; `--device` is the only addition.
- VQ-VAE: at tests/test_cli.py's widths, dropout 0, the batch the whole
  train split, 2 epochs from carried weights: the same metrics.csv
  columns, every logged value within the full-batch Trainer contract of
  tests/test_torch_trainer.py (1e-4), best and last checkpoints at the
  same paths, the best weights within rtol 1e-3, atol 2e-4.
- Classifier: raw MLP (also on 'ondevice' windows) and the latent GRU
  over the port's VQ-VAE checkpoint run end to end with the summary's
  keys; the port's evaluation of the JAX CLI's best weights gives its
  summary within 1e-5. Trajectories are not compared:
  `ClassificationTask` draws a weighted sample each epoch, and the JAX
  package's threefry draws cannot be matched by torch's Philox.
- Transformer: with `Trainer.fit` / `test` replaced by recorders in
  both packages, the same stage schedule, each stage on a fresh
  optimizer; a real run and `--classification-only` from scratch and
  from a port checkpoint; the gen stage from carried weights (res
  dropout 0, full batch, one VQ-VAE's ids) logs the JAX CLI's rows
  within 1e-4.
- Refusals: the JAX CLI's mesh errors, the TPU's dropout PRNGs, and no
  CUDA device without `--device`; over several cards the JAX CLI's
  mesh (its runs: tests/test_torch_parallel.py).
"""
from __future__ import annotations

import contextlib
import csv
import functools
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.cli import (
    train_classification_model as jcls)
from vq_vae_transformer_arc_welding_tpu.cli import (
    train_reconstruction_embedding as jrec)
from vq_vae_transformer_arc_welding_tpu.cli import (
    train_transformer_mtasks as jtm)
from vq_vae_transformer_arc_welding_tpu.models import MLP as JaxMLP
from vq_vae_transformer_arc_welding_tpu.models import (
    TransformerDecoder as JaxTransformer)
from vq_vae_transformer_arc_welding_tpu.models import VQVAEPatch as JaxVQVAE
from vq_vae_transformer_arc_welding_tpu.train import loop as jloop
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.cli import (
    train_classification_model as pcls)
from vq_vae_transformer_arc_welding_tpu_torch.cli import (
    train_reconstruction_embedding as prec)
from vq_vae_transformer_arc_welding_tpu_torch.cli import (
    train_transformer_mtasks as ptm)
from vq_vae_transformer_arc_welding_tpu_torch.cli.shared import (
    load_vqvae_any, parse_split_ids)
from vq_vae_transformer_arc_welding_tpu_torch.data import (
    ASIMoWDataModule, get_val_test_ids)
from vq_vae_transformer_arc_welding_tpu_torch.data.synthetic import (
    write_synthetic_csv)
from vq_vae_transformer_arc_welding_tpu_torch.models import (
    TransformerDecoder)
from vq_vae_transformer_arc_welding_tpu_torch.train import loop as ploop
from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
    ClassificationTask)

TRAJ = dict(rtol=1e-3, atol=2e-4)   # weights after a full-batch fit
LOSS_ATOL = 1e-4                    # logged losses and metrics
EVAL_ATOL = 1e-5                    # evaluations of the same weights
N_TRAIN = 32                        # train cycles of the CSV below
SEED = 0
VQ_ARGS = ["--epochs", "2", "--batch-size", str(N_TRAIN),
           "--num-embeddings", "16", "--embedding-dim", "8",
           "--hidden-dim", "32", "--n-resblocks", "1", "--dropout-p", "0"]
MLP_ARGS = ["--model-name", "MLP", "--dataset", "asimow", "--epochs", "2",
            "--batch-size", "32", "--hidden-dim", "32",
            "--n-hidden-layer", "1", "--n-cycles", "2"]
TR_ARGS = ["--n-cycles", "2", "--d-model", "32", "--n-heads", "4",
           "--n-blocks", "2"]
BEST = os.path.join("model_checkpoints", "VQ-VAE-Patch",
                    "VQ-VAE-Patch-best.ckpt")
LAST = os.path.join("model_checkpoints", "VQ-VAE-Patch", "last.ckpt")
SUMMARY = {"val/mean_f1_score", "val/mean_acc", "test/mean_f1_score",
           "test/mean_acc"}
CLIS = {"reconstruction": (jrec, prec), "classification": (jcls, pcls),
        "transformer": (jtm, ptm)}


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
    d = tmp_path_factory.mktemp("cli_data")
    write_synthetic_csv(str(d / "processed_asimow_dataset.csv"),
                        n_cycles_per_run=8, extra_train_runs=4)
    return str(d)


@contextlib.contextmanager
def in_dir(path):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def metrics(root, version=None) -> tuple[list, list]:
    """(header, rows) of a run's metrics.csv under root/logs; the newest
    run by default. Rows are {column: float}, empty cells left out."""
    base = os.path.join(root, "logs", "vq-vae-transformer")
    if version is None:
        version = max(int(d.split("_")[1]) for d in os.listdir(base))
    with open(os.path.join(base, f"version_{version}", "metrics.csv")) as f:
        reader = csv.DictReader(f)
        rows = [{k: float(v) for k, v in row.items() if v != ""}
                for row in reader]
        return reader.fieldnames, rows


def assert_rows_close(rows, ref, atol):
    assert len(rows) == len(ref)
    for row, want in zip(rows, ref):
        assert row.keys() == want.keys()
        for k, v in want.items():
            assert math.isclose(row[k], v, rel_tol=0, abs_tol=atol), (k, row,
                                                                     want)


def carried(jax_cls, to_port, **fixed):
    """A factory for the port CLI's namespace: the JAX model of the same
    flags (and `fixed`), its init(SEED) carried over to the port."""
    def factory(*, generator, device, **kw):
        jm = jax_cls(**kw, **fixed)
        params, state = jm.init(SEED)
        return to_port(jm, params, state, device)
    return factory


def vqvae_to_port(jm, params, state, device):
    return bridge.vqvae_from_jax(jm.hparams, params, state, device=device)


def transformer_to_port(jm, params, state, device):
    return bridge.transformer_from_jax(jm.hparams, params, device=device)


@pytest.fixture(scope="module")
def vq_runs(tmp_path_factory, data_dir):
    """The reconstruction CLI of each package, the port's from the JAX
    init carried over."""
    root = tmp_path_factory.mktemp("vq_cli")
    args = VQ_ARGS + ["--data-dir", data_dir]
    with in_dir(root / "jax"):
        jax_out = jrec.main(jrec.build_parser().parse_args(args))
    with in_dir(root / "port"), pytest.MonkeyPatch.context() as mp:
        mp.setattr(prec, "VQVAEPatch", carried(JaxVQVAE, vqvae_to_port))
        port_out = prec.main(prec.build_parser().parse_args(
            args + ["--device", "cpu"]))
    return SimpleNamespace(jax_dir=root / "jax", port_dir=root / "port",
                           jax=jax_out, port=port_out)


# -- parsers -------------------------------------------------------------------


def options(parser) -> dict:
    return {tuple(a.option_strings): a for a in parser._actions
            if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("cli", list(CLIS))
def test_parser_has_every_option_of_the_jax_parser(cli):
    jmod, pmod = CLIS[cli]
    jp, pp = jmod.build_parser(), pmod.build_parser()
    theirs, ours = options(jp), options(pp)
    assert set(ours) - set(theirs) == {("--device",)}
    for key, want in theirs.items():
        got = ours[key]
        assert ((type(got), got.dest, got.default, got.type, got.choices,
                 got.nargs, got.const, got.required)
                == (type(want), want.dest, want.default, want.type,
                    want.choices, want.nargs, want.const, want.required)), key
    assert pp.description == jp.description
    defaults = vars(pp.parse_args([]))
    assert defaults.pop("device") is None
    assert defaults == vars(jp.parse_args([]))
    assert callable(pmod.cli_main) and callable(pmod.main)


# -- the VQ-VAE CLI ---------------------------------------------------------------


def test_vqvae_cli_logs_the_jax_clis_rows(vq_runs):
    j_head, j_rows = metrics(vq_runs.jax_dir)
    p_head, p_rows = metrics(vq_runs.port_dir)
    assert p_head == j_head
    assert sum("val/loss" in r for r in p_rows) == 2
    assert_rows_close(p_rows, j_rows, LOSS_ATOL)
    (j_res, j_test), (p_res, p_test) = vq_runs.jax, vq_runs.port
    assert p_test.keys() == j_test.keys()
    for k, v in j_test.items():
        assert math.isclose(p_test[k], v, rel_tol=0, abs_tol=LOSS_ATOL), k
    for key in ("train_epoch/loss", "val/loss"):
        np.testing.assert_allclose([h[key] for h in p_res.history],
                                   [h[key] for h in j_res.history],
                                   rtol=0, atol=LOSS_ATOL)
    assert p_res.best_epoch == j_res.best_epoch


def test_vqvae_cli_checkpoints_match_the_jax_clis(vq_runs):
    for root in (vq_runs.jax_dir, vq_runs.port_dir):
        assert os.path.exists(root / BEST) and os.path.exists(root / LAST)
    port = load_vqvae_any(str(vq_runs.port_dir / BEST), device="cpu")
    jm, params, state = JaxVQVAE.load(str(vq_runs.jax_dir / BEST))
    ref = bridge.vqvae_from_jax(jm.hparams, params, state, device="cpu")
    start = carried(JaxVQVAE, vqvae_to_port)(
        generator=None, device="cpu", **jm.hparams).state_dict()
    sd = port.state_dict()
    moved = 0
    for k, v in ref.state_dict().items():
        if "num_batches_tracked" in k:
            continue
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **TRAJ,
                                   err_msg=k)
        moved += not torch.equal(v, start[k])
    assert moved > 10
    assert all(port.hparams[k] == v for k, v in jm.hparams.items()
               if k in port.hparams)


@pytest.mark.parametrize("prng", ["rbg", "unsafe_rbg"])
def test_vqvae_cli_refuses_the_tpus_dropout_prng(data_dir, tmp_path,
                                                 monkeypatch, prng):
    monkeypatch.chdir(tmp_path)
    args = prec.build_parser().parse_args(
        VQ_ARGS + ["--data-dir", data_dir, "--device", "cpu",
                   "--dropout-prng", prng])
    with pytest.raises(NotImplementedError, match="hardware RNG"):
        prec.main(args)


# -- the classification CLI ---------------------------------------------------------


@pytest.mark.parametrize("case", ["mlp", "mlp_ondevice", "gru_latent"])
def test_classifier_cli_runs_end_to_end(vq_runs, data_dir, tmp_path,
                                        monkeypatch, case):
    monkeypatch.chdir(tmp_path)
    if case == "gru_latent":
        args = ["--model-name", "GRU", "--dataset", "latent_vq_vae",
                "--epochs", "2", "--batch-size", "32", "--hidden-dim", "16",
                "--n-hidden-layer", "1", "--n-cycles", "2",
                "--vqvae-model", str(vq_runs.port_dir / BEST)]
        ckpt = "model_checkpoints/GRU-latent_vq_vae-best.ckpt"
    else:
        args = MLP_ARGS + (["--window-mode", "ondevice"]
                           if case == "mlp_ondevice" else [])
        ckpt = "model_checkpoints/MLP-asimow-best.ckpt"
    result, test_metrics = pcls.main(pcls.build_parser().parse_args(
        args + ["--data-dir", data_dir, "--device", "cpu"]))
    assert os.path.exists(ckpt) and result.best_ckpt_path == ckpt
    assert np.isfinite(test_metrics["test/f1_score_mean"])
    _, rows = metrics(tmp_path)
    assert set(rows[-1]) == SUMMARY
    assert all(np.isfinite(list(r.values())).all() for r in rows)
    assert sum("train/loss" in r for r in rows) >= 2


def test_classifier_evaluation_matches_jax_on_carried_weights(
        data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = MLP_ARGS + ["--data-dir", data_dir]
    j_res, j_test = jcls.main(jcls.build_parser().parse_args(args))
    _, j_rows = metrics(tmp_path)
    j_summary = j_rows[-1]
    assert set(j_summary) == SUMMARY
    jm, params, state = JaxMLP.load(j_res.best_ckpt_path)
    model = bridge.mlp_from_jax(jm.hparams, params, state, device="cpu")
    ids = get_val_test_ids()
    dm = ASIMoWDataModule(task="classification", batch_size=32, n_cycles=2,
                          val_data_ids=parse_split_ids(ids["val_ids"]),
                          test_data_ids=parse_split_ids(ids["test_ids"]),
                          data_directory_path=data_dir)
    dm.setup("fit")
    trainer = ploop.Trainer(verbose=False)
    task = ClassificationTask(model)
    test_metrics, summary = pcls.summary_metrics(trainer, task, dm,
                                                 j_res.best_score)
    assert summary.keys() == j_summary.keys()
    for k, v in j_summary.items():
        assert math.isclose(summary[k], v, rel_tol=0, abs_tol=EVAL_ATOL), k
    assert test_metrics.keys() == j_test.keys()
    for k, v in j_test.items():
        assert math.isclose(test_metrics[k], v, rel_tol=0,
                            abs_tol=EVAL_ATOL), k
    val = trainer.evaluate(task, dm.val, dm.batch_size, dm.drop_last, "val")
    assert math.isclose(val["val/f1_score_mean"], j_res.best_score,
                        rel_tol=0, abs_tol=EVAL_ATOL)


# -- the transformer CLI -------------------------------------------------------------


def jax_recorders(calls: list):
    def fit(self, task, datamodule, params, state, tx, opt_state=None,
            resume_from=None):
        fresh = all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(opt_state),
            jax.tree_util.tree_leaves(tx.init(params))))
        calls.append(("fit", type(task).__name__, self.max_epochs, self.seed,
                      self.monitor, self.mode, self.patience, self.accum,
                      fresh))
        # a step on zero gradients, so that a stage that kept this state
        # would not find it fresh
        _, stepped = tx.update(jax.tree_util.tree_map(jnp.zeros_like, params),
                               opt_state, params)
        return jloop.FitResult(params, state, None, -1, final_params=params,
                               final_state=state, opt_state=stepped)

    def test(self, task, datamodule, params, state, split_name="test"):
        calls.append(("test", type(task).__name__))
        return {f"{split_name}/loss": 0.0}

    return fit, test


def port_recorders(calls: list):
    def fit(self, task, datamodule, tx, opt=None, resume_from=None):
        fresh = opt is None or not any(opt.step_counts().values())
        calls.append(("fit", type(task).__name__, self.max_epochs, self.seed,
                      self.monitor, self.mode, self.patience, self.accum,
                      fresh))
        opt = opt or tx.init(task.model)
        for p in task.model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        return ploop.FitResult(task.model.state_dict(), None, -1,
                               optimizer=opt)

    def test(self, task, datamodule, split_name="test"):
        calls.append(("test", type(task).__name__))
        return {f"{split_name}/loss": 0.0}

    return fit, test


def test_transformer_cli_runs_the_jax_clis_schedule(vq_runs, data_dir,
                                                    tmp_path, monkeypatch):
    args = TR_ARGS + ["--epoch_iter", "3", "--gen-epochs", "4",
                      "--class-epoch", "2", "--finetune-epochs", "3",
                      "--seed", "5", "--data-dir", data_dir]
    schedules = {}
    for name, mod, loop, recorders, vq_dir, extra in (
            ("jax", jtm, jloop, jax_recorders, vq_runs.jax_dir, []),
            ("port", ptm, ploop, port_recorders, vq_runs.port_dir,
             ["--device", "cpu"])):
        calls: list = []
        fit, test = recorders(calls)
        monkeypatch.setattr(loop.Trainer, "fit", fit)
        monkeypatch.setattr(loop.Trainer, "test", test)
        monkeypatch.chdir(tmp_path)
        _, results = mod.main(mod.build_parser().parse_args(
            args + extra + ["--vqvae-model", str(vq_dir / BEST)]))
        schedules[name] = (calls, sorted(results))
    assert schedules["port"] == schedules["jax"]
    calls = schedules["port"][0]
    fits = [c for c in calls if c[0] == "fit"]
    assert [c[1:4] for c in fits] == [
        ("TransformerGenTask", 4, 5), ("TransformerClassTask", 2, 5),
        ("TransformerGenTask", 4, 6), ("TransformerClassTask", 2, 6),
        ("TransformerGenTask", 4, 7), ("TransformerClassTask", 3, 7)]
    assert all(c[-1] for c in fits) and {c[-2] for c in fits} == {5}


def test_transformer_cli_trains_and_tests(vq_runs, data_dir, tmp_path,
                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    run, results = ptm.main(ptm.build_parser().parse_args(
        TR_ARGS + ["--epoch_iter", "1", "--gen-epochs", "1",
                   "--class-epoch", "1", "--finetune-epochs", "1",
                   "--batch-size", "16", "--vqvae-model",
                   str(vq_runs.port_dir / BEST), "--data-dir", data_dir,
                   "--device", "cpu"]))
    assert set(results) == {"class_test", "class_test_final", "gen_test"}
    assert np.isfinite(results["gen_test"]["test/loss"])
    assert "test/cl/f1_score" in results["class_test_final"]
    assert (run.model.seq_len, run.model.n_classes) == (2 * 16 + 1, 16 + 2)
    _, rows = metrics(tmp_path)
    assert any("train/loss" in r for r in rows)
    assert any("train/cl/loss" in r for r in rows)
    assert not os.path.exists("model_checkpoints")   # as the JAX CLI


@pytest.mark.parametrize("start", ["scratch", "checkpoint"])
def test_transformer_cli_classification_only(vq_runs, data_dir, tmp_path,
                                             monkeypatch, start):
    monkeypatch.chdir(tmp_path)
    extra = []
    if start == "checkpoint":
        saved = TransformerDecoder(
            d_model=16, seq_len=33, n_classes=18, n_head=2, n_blocks=1,
            generator=torch.Generator().manual_seed(3), device="cpu")
        saved.save("tr.ckpt")
        extra = ["--model-wandb-transformer", "tr.ckpt"]
    run, results = ptm.main(ptm.build_parser().parse_args(
        TR_ARGS + ["--classification-only", "--class-epoch", "1",
                   "--batch-size", "16", "--vqvae-model",
                   str(vq_runs.port_dir / BEST), "--data-dir", data_dir,
                   "--device", "cpu"] + extra))
    assert set(results) == {"class_test"}
    assert np.isfinite(results["class_test"]["test/cl/loss"])
    assert run.model.d_model == (16 if start == "checkpoint" else 32)
    assert run.opt is not None and any(run.opt.step_counts().values())


def test_transformer_gen_stage_matches_the_jax_cli(vq_runs, data_dir,
                                                   tmp_path, monkeypatch):
    # both CLIs encode with one VQ-VAE: the JAX CLI's best, and the same
    # weights in the port's checkpoint format
    jm, params, state = JaxVQVAE.load(str(vq_runs.jax_dir / BEST))
    vq_path = str(tmp_path / "vq.ckpt")
    vqvae_to_port(jm, params, state, "cpu").save(vq_path)
    ids = get_val_test_ids()
    gen = ASIMoWDataModule(task="reconstruction", n_cycles=2,
                           val_data_ids=ids["val_ids"],
                           test_data_ids=ids["test_ids"],
                           data_directory_path=data_dir)
    gen.setup()
    n = len(gen.train.x)                 # a full batch
    args = TR_ARGS + ["--epoch_iter", "1", "--gen-epochs", "2",
                      "--finetune-epochs", "0", "--batch-size", str(n),
                      "--data-dir", data_dir]
    monkeypatch.setattr(jtm, "TransformerDecoder",
                        functools.partial(JaxTransformer, res_dropout=0.0))
    monkeypatch.setattr(ptm, "TransformerDecoder", carried(
        JaxTransformer, transformer_to_port, res_dropout=0.0))
    with in_dir(tmp_path / "jax"):
        _, j_results = jtm.main(jtm.build_parser().parse_args(
            args + ["--vqvae-model", str(vq_runs.jax_dir / BEST)]))
    with in_dir(tmp_path / "port"):
        run, results = ptm.main(ptm.build_parser().parse_args(
            args + ["--vqvae-model", vq_path, "--device", "cpu"]))
    assert run.model.res_dropout == 0.0
    j_head, j_rows = metrics(tmp_path / "jax")
    p_head, p_rows = metrics(tmp_path / "port")
    assert p_head == j_head

    def gen_stage(rows):
        return [r for r in rows if not any("cl/" in k for k in r)][:-1]

    assert len(gen_stage(j_rows)) == 4   # a train and a val row an epoch
    assert_rows_close(gen_stage(p_rows), gen_stage(j_rows), LOSS_ATOL)
    assert set(results) == set(j_results)
    assert math.isclose(results["gen_test"]["test/loss"],
                        j_results["gen_test"]["test/loss"], rel_tol=0,
                        abs_tol=LOSS_ATOL)


# -- refusals ------------------------------------------------------------------------


@pytest.mark.parametrize("flags, error", [
    (["--pipeline-stages", "2", "--tensor-parallel", "2"],
     NotImplementedError),
    (["--pipeline-stages", "2"], ValueError),
    (["--tensor-parallel", "3"], ValueError)])
def test_transformer_cli_refuses_meshes_as_the_jax_cli(tmp_path, monkeypatch,
                                                       flags, error):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [object()])
    args = ptm.build_parser().parse_args(
        flags + ["--device", "cpu", "--data-dir", str(tmp_path / "none")])
    with pytest.raises(error) as ours:
        ptm.main(args)
    with pytest.raises(error) as theirs:
        jtm._maybe_mesh(False, args.pipeline_stages, args.tensor_parallel)
    assert str(ours.value) == str(theirs.value)
    assert not os.path.exists("logs")    # before any logger or data


@pytest.mark.parametrize("n_devices, kw", [
    (4, dict(use_all_devices=True)),
    (4, dict(use_all_devices=False, pipeline_stages=2)),
    (2, dict(use_all_devices=True, tensor_parallel=2))])
def test_a_mesh_over_several_cards_is_not_ported(monkeypatch, n_devices, kw):
    """Multi-GPU training is ported (tests/test_torch_parallel.py): over
    n cards the CLI builds the mesh the JAX CLI builds over n devices
    (the test keeps its name)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_devices)
    ours = ptm._maybe_mesh(**kw)
    devices = jax.devices()[:n_devices]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    theirs = jtm._maybe_mesh(**kw)
    assert ours.shape == dict(theirs.shape)
    assert ours.axis_names == tuple(theirs.axis_names)
    assert [d.index for d in ours.devices.flat] == list(range(ours.size))


@pytest.mark.parametrize("n_devices", [0, 1])
def test_one_device_builds_no_mesh(monkeypatch, n_devices):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_devices)
    assert ptm._maybe_mesh(True) is None
    assert ptm._maybe_mesh(False, 1, 1) is None


@pytest.mark.parametrize("cli", list(CLIS))
def test_cli_without_device_raises_before_reading_data(tmp_path, monkeypatch,
                                                       cli):
    """No card and no --device: a RuntimeError that names the device,
    before the logger or any data (the data directory does not exist),
    and no run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = CLIS[cli][1]
    args = mod.build_parser().parse_args(["--data-dir",
                                          str(tmp_path / "no_data")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("flags", [
    ["--use-all-gpus"], ["--use-all-gpus", "--tensor-parallel", "2"],
    ["--pipeline-stages", "2"]], ids=["dp", "tp", "pp"])
def test_transformer_cli_trains_over_a_mesh(vq_runs, data_dir, tmp_path,
                                            monkeypatch, flags):
    """Over two CPU devices the CLI starts two gloo ranks
    (parallel/launch.py), each runs the schedule on its mesh, and `main`
    returns rank 0's results with the dense weights, as on a node of
    cards."""
    monkeypatch.chdir(tmp_path)
    run, results = ptm.main(ptm.build_parser().parse_args(
        TR_ARGS + flags + ["--epoch_iter", "1", "--gen-epochs", "1",
                           "--class-epoch", "1", "--finetune-epochs", "1",
                           "--batch-size", "16", "--vqvae-model",
                           str(vq_runs.port_dir / BEST), "--data-dir",
                           data_dir, "--device", "cpu"]),
        devices=[torch.device("cpu")] * 2)
    assert set(results) == {"class_test", "class_test_final", "gen_test"}
    assert np.isfinite(results["gen_test"]["test/loss"])
    assert np.isfinite(results["class_test"]["test/cl/f1_score"])
    assert isinstance(run.model, ptm.TransformerDecoder)
    assert run.model.tp is None                  # gathered dense
    _, rows = metrics(tmp_path)                  # rank 0's log alone
    assert any("train/loss" in r for r in rows)
    assert os.listdir(tmp_path / "logs" / "vq-vae-transformer") == [
        "version_0"]
