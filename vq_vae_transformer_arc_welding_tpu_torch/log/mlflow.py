"""MLflow adapter + credential bootstrap.

Parity with the reference's mlflow_helper.py:9-135: environment-driven
MLflow tracking + MinIO/S3 artifact-store credentials, git-commit
tagging, and artifact logging — behind a lazy import so the framework
runs without mlflow installed.

Port of vq_vae_transformer_arc_welding_tpu/log/mlflow.py: the same
calls on the package.
"""
from __future__ import annotations

import os
import subprocess
import tempfile

from .base import Logger


def setup_mlflow_env():
    """Export the credential env vars MLflow's S3 artifact client reads
    (reference mlflow_helper.py:28-66: MLFLOW_TRACKING_URI,
    MLFLOW_S3_ENDPOINT_URL, AWS_ACCESS_KEY_ID/SECRET from MinIO vars)."""
    mapping = {
        "MLFLOW_S3_ENDPOINT_URL": os.environ.get("MINIO_ENDPOINT_URL"),
        "AWS_ACCESS_KEY_ID": os.environ.get("MINIO_ACCESS_KEY"),
        "AWS_SECRET_ACCESS_KEY": os.environ.get("MINIO_SECRET_KEY"),
    }
    for k, v in mapping.items():
        if v and not os.environ.get(k):
            os.environ[k] = v


def current_git_commit() -> str | None:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], text=True,
            stderr=subprocess.DEVNULL).strip()
    except Exception:
        return None


class MLFlowLogger(Logger):
    def __init__(self, experiment_name: str, tracking_uri: str,
                 run_name: str | None = None, log_model: bool = True,
                 tags: dict | None = None):
        try:
            import mlflow
        except ImportError as e:
            raise ImportError(
                "mlflow is not installed in this environment; use the CSV "
                "logger (default) instead") from e
        setup_mlflow_env()
        self._mlflow = mlflow
        mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(experiment_name)
        self.run = mlflow.start_run(run_name=run_name)
        self.run_id = self.run.info.run_id
        self.log_model = log_model
        tags = dict(tags or {})
        commit = current_git_commit()
        if commit:
            tags["git_commit"] = commit
        if tags:
            mlflow.set_tags(tags)

    def log_hyperparams(self, params: dict):
        self._mlflow.log_params({k: str(v)[:250] for k, v in params.items()})

    def log_metrics(self, metrics: dict, step: int | None = None):
        self._mlflow.log_metrics(
            {k.replace("/", "_"): float(v) for k, v in metrics.items()},
            step=step)

    def log_artifact(self, path: str, name: str | None = None,
                     type_: str = "model"):
        self._mlflow.log_artifact(path)

    def log_notebook_html(self, notebook_path: str):
        """Convert a notebook to HTML and log it as an artifact
        (parity: reference mlflow_helper.py:86-111). Requires nbconvert;
        logs the raw .ipynb if conversion is unavailable."""
        try:
            out_dir = tempfile.mkdtemp()
            subprocess.run(
                ["jupyter", "nbconvert", "--to", "html", notebook_path,
                 "--output-dir", out_dir],
                check=True, capture_output=True, timeout=120)
            base = os.path.splitext(os.path.basename(notebook_path))[0]
            self._mlflow.log_artifact(os.path.join(out_dir, base + ".html"))
        except Exception:
            self._mlflow.log_artifact(notebook_path)

    def finalize(self, status: str = "success"):
        self._mlflow.end_run(status="FINISHED" if status == "success"
                             else "FAILED")

    @property
    def experiment(self):
        return self._mlflow
