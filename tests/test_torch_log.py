"""The port's loggers, run names and figure helper against the JAX
package's (vq_vae_transformer_arc_welding_tpu/log/, utils/names.py,
models/plot_helper.py).

The same calls give byte-equal `metrics.csv` and `hparams.json` in the
same `version_N`; against the fake wandb and MLflow modules of
tests/test_loggers_stub.py both packages make the same calls on the
package, and a missing package raises ImportError; `select_logger` has
the same asserts and the same CSV default; one `random.seed` gives the
same names; `plot_helper` draws the same line data. Importing every
module of the port loads neither matplotlib nor jax.
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from test_loggers_stub import _fake_mlflow, _fake_wandb
from vq_vae_transformer_arc_welding_tpu import log as jlog
from vq_vae_transformer_arc_welding_tpu.models import plot_helper as jplot
from vq_vae_transformer_arc_welding_tpu.utils import names as jnames
from vq_vae_transformer_arc_welding_tpu_torch import log as plog
from vq_vae_transformer_arc_welding_tpu_torch.models import plot_helper as pplot
from vq_vae_transformer_arc_welding_tpu_torch.utils import names as pnames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jlog, "port": plog}


def csv_calls(lg) -> None:
    """One training run's worth of calls, with new keys arriving late,
    an int step, numpy and python numbers and a non-JSON hparam."""
    lg.log_hyperparams({"val_ids": str(((3, 3), (2, 10))), "lr": 1e-3,
                        "model_name": "VQ-VAE-Patch"})
    lg.log_hyperparams({"path": os.path, "epochs": 2, "flag": None})
    lg.log_metrics({"train/loss": np.float32(1.25), "train/acc": 0.5},
                   step=0)
    lg.log_metrics({"val/loss": 1.0 / 3.0, "epoch": 0}, step=1)
    lg.log_metrics({"train/loss": np.float64(0.1)}, step=50)
    lg.log_metrics_dict({"test/f1_score_mean": 0.75})
    lg.finalize()


@pytest.mark.parametrize("existing", [(), ("version_0",),
                                      ("version_3", "version_x", "other")])
def test_csv_logger_writes_the_jax_loggers_bytes(tmp_path, existing):
    out = {}
    for name, pkg in PACKAGES.items():
        root = tmp_path / name
        for d in existing:
            (root / "runs" / d).mkdir(parents=True)
        lg = pkg.CSVLogger(str(root), name="runs")
        csv_calls(lg)
        assert lg.experiment is lg
        out[name] = (lg.version, os.path.relpath(lg.log_dir, root),
                     (root / "runs" / f"version_{lg.version}" /
                      "metrics.csv").read_bytes(),
                     (root / "runs" / f"version_{lg.version}" /
                      "hparams.json").read_bytes())
    assert out["port"] == out["jax"]
    assert json.loads(out["port"][3])["epochs"] == 2


def normalised(value):
    """A recorded call's argument, objects replaced by their type's name
    and their attributes, so that two packages' calls compare."""
    if isinstance(value, (list, tuple)):
        return type(value)(normalised(v) for v in value)
    if isinstance(value, dict):
        return {k: normalised(v) for k, v in value.items()}
    if hasattr(value, "__dict__") and not isinstance(value, type):
        return (type(value).__name__, normalised(vars(value)))
    return value


def drive_wandb(pkg, ckpt: str) -> None:
    lg = pkg.select_logger(use_wandb=True, logging_entity="tmdt",
                           logging_project="asimow")
    lg.log_hyperparams({"learning_rate": 1e-3, "epochs": 5})
    lg.log_metrics({"val/loss": 1.5, "train/recon_error": 0.2}, step=7)
    lg.log_artifact(ckpt)
    lg.log_artifact(ckpt, name="best", type_="checkpoint")
    assert lg.log_model and lg.experiment is lg.run
    lg.finalize()


def drive_mlflow(pkg, ckpt: str) -> None:
    random.seed(7)                      # the run name is drawn
    lg = pkg.select_logger(use_mlflow=True, logging_project="asimow",
                           mlflow_url="http://mlflow:5000",
                           tags={"team": "tmdt"})
    assert lg.run_id == "run-123"
    lg.log_hyperparams({"lr": 1e-3, "big": "x" * 600})
    lg.log_metrics({"val/loss": 1.5, "test/f1_score_mean": 0.9}, step=3)
    lg.log_artifact(ckpt)
    lg.log_notebook_html(ckpt)          # nbconvert fails: the raw file
    lg.finalize("success")
    lg.finalize("failed")


@pytest.mark.parametrize("which", ["wandb", "mlflow"])
def test_remote_loggers_make_the_jax_loggers_calls(tmp_path, monkeypatch,
                                                   which):
    ckpt = tmp_path / "best.ckpt"
    ckpt.write_text("x")
    monkeypatch.chdir(REPO)             # the commit tag is this checkout's

    def no_jupyter(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    # log_notebook_html's fallback, without a jupyter process
    monkeypatch.setattr(subprocess, "run", no_jupyter)
    for var, value in (("MINIO_ENDPOINT_URL", "http://minio:9000"),
                       ("MINIO_ACCESS_KEY", "ak"),
                       ("MINIO_SECRET_KEY", "sk")):
        monkeypatch.setenv(var, value)
    recorded = {}
    for name, pkg in PACKAGES.items():
        for var in ("MLFLOW_S3_ENDPOINT_URL", "AWS_ACCESS_KEY_ID",
                    "AWS_SECRET_ACCESS_KEY"):
            monkeypatch.delenv(var, raising=False)
        calls: list = []
        fake = (_fake_wandb if which == "wandb" else _fake_mlflow)(calls)
        monkeypatch.setitem(sys.modules, which, fake)
        (drive_wandb if which == "wandb" else drive_mlflow)(pkg, str(ckpt))
        recorded[name] = normalised(calls)
        if which == "mlflow":
            assert os.environ["AWS_SECRET_ACCESS_KEY"] == "sk"
    assert recorded["port"] == recorded["jax"]
    assert len(recorded["port"]) >= 6


@pytest.mark.parametrize("which", ["wandb", "mlflow"])
@pytest.mark.parametrize("package", list(PACKAGES))
def test_a_missing_remote_package_raises_import_error(monkeypatch, which,
                                                      package):
    monkeypatch.setitem(sys.modules, which, None)   # import -> ImportError
    kw = (dict(use_wandb=True, logging_entity="e", logging_project="p")
          if which == "wandb" else
          dict(use_mlflow=True, logging_project="p", mlflow_url="u"))
    with pytest.raises(ImportError, match="CSV") as err:
        PACKAGES[package].select_logger(**kw)
    other = "jax" if package == "port" else "port"
    with pytest.raises(ImportError) as ref:
        PACKAGES[other].select_logger(**kw)
    assert str(err.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    dict(use_wandb=True, logging_project="p"),
    dict(use_wandb=True, logging_entity="e"),
    dict(use_wandb=True, use_mlflow=True, logging_project="p"),
    dict(use_mlflow=True, mlflow_url="u"),
    dict(use_mlflow=True, logging_project="p"),
])
def test_select_logger_asserts_as_the_jax_one(kw):
    messages = []
    for pkg in PACKAGES.values():
        with pytest.raises(AssertionError) as err:
            pkg.select_logger(**kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and messages[0].endswith("must be set")


def test_select_logger_defaults_to_csv_in_logs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for i, pkg in enumerate(PACKAGES.values()):
        lg = pkg.select_logger()
        assert type(lg).__name__ == "CSVLogger"
        assert (lg.save_dir, lg.name) == ("logs", "vq-vae-transformer")
        named = pkg.select_logger(csv_name="other")
        assert named.log_dir == os.path.join("logs", "other", f"version_{i}")
    assert sorted(os.listdir(tmp_path / "logs" / "vq-vae-transformer")) == [
        "version_0", "version_1"]


@pytest.mark.parametrize("seed", [0, 1, 1234])
def test_names_agree_under_one_seed(seed):
    draws = {}
    for name, mod in (("jax", jnames), ("port", pnames)):
        random.seed(seed)
        draws[name] = ([mod.generate_funny_name() for _ in range(5)],
                       mod.name_generator(), mod.name_generator(3))
    assert draws["port"] == draws["jax"]
    assert len(draws["port"][1]) == 10


def line_data(fig) -> list:
    return [[(ln.get_label(), np.asarray(ln.get_ydata()).tolist(),
              ln.get_color()) for ln in ax.get_lines()]
            for ax in fig.axes]


@pytest.mark.parametrize("batched", [False, True])
def test_plot_helper_draws_the_jax_figures(tmp_path, batched):
    pytest.importorskip("matplotlib")
    from matplotlib import pyplot as plt
    rng = np.random.default_rng(3)
    shape = (2, 200, 2) if batched else (200, 2)
    target, pred = rng.normal(size=shape), rng.normal(size=shape)
    figs = {}
    for name, mod in (("jax", jplot), ("port", pplot)):
        out = tmp_path / name / "sub" / "recon.png"
        fig = mod.plot_recon_matplotlib(target, pred, str(out),
                                        title="cycle 0")
        assert out.stat().st_size > 0
        cv = mod.plot_single_cv(target[0] if batched else target, 1)
        figs[name] = (line_data(fig), fig._suptitle.get_text(),
                      line_data(cv), [ax.get_title() for ax in cv.axes])
        plt.close("all")
    assert figs["port"] == figs["jax"]
    assert len(figs["port"][0]) == 2 and "good" in figs["port"][3]


def test_plot_helper_threaded_and_table_fallback(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(200, 2))
    out = tmp_path / "threaded.png"
    pplot.plot_recon_threaded(x, x + 0.1, str(out)).join(timeout=60)
    assert out.stat().st_size > 0
    monkeypatch.setitem(sys.modules, "wandb", None)
    for mod in (jplot, pplot):
        assert mod.plot_recon_wandb_table(x[None], x[None], run=None) is None


def test_importing_the_port_loads_neither_matplotlib_nor_jax():
    """The card's machine has no matplotlib and no jax: every module of
    the port, the CLIs and plot_helper among them, imports without
    them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vq_vae_transformer_arc_welding_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('matplotlib', 'jax', 'vq_vae_transformer_arc_welding_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
