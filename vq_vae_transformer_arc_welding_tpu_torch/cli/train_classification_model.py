"""MLP/GRU classification CLI (raw windows or VQ-VAE latents).

    python -m vq_vae_transformer_arc_welding_tpu_torch.cli.train_classification_model \\
        [--device cpu] [--model-name GRU] [--dataset asimow] ...

Port of vq_vae_transformer_arc_welding_tpu/cli/train_classification_model.py
(reference train_classification_model.py, flags :175-197, flow
:20-171): the same flags and defaults, plus `--device`; the same model
shape rules (MLP seq=200*n_cycles dim=2; GRU seq=n_cycles dim=400;
latent path input_dim = embedding_dim*enc_out_len), checkpoint on the
best val/f1_score_mean, the best checkpoint reloaded for the test, and
the summary push. Models and data go on the CUDA device unless
`--device` names another; without a card and without `--device`,
`main` raises before it reads any data.

The training trajectory is the port's own: `ClassificationTask` draws
a weighted sample each epoch (reference WeightedRandomSampler) from
torch's Philox generator, which cannot draw what the JAX package's
threefry draws, so the two packages' runs part after the first step.
Given the same weights, their evaluations agree.
"""
from __future__ import annotations

import argparse
import logging as log

import torch

from ..data.asimow import ASIMoWDataModule
from ..data.splits import get_val_test_ids
from ..log.select import select_logger
from ..models.base import load_state_dict_checked
from ..models.gru import GRU
from ..models.mlp import MLP
from ..train.loop import Trainer
from ..train.optim import make_radam
from ..train.tasks import ClassificationTask
from .shared import (cli_device, get_latent_dataloader, parse_split_ids,
                     print_training_input_shape, push_summary)


def build_parser():
    parser = argparse.ArgumentParser(description="Train Classification Model")
    a = parser.add_argument
    a("--epochs", type=int, help="Number of epochs to train", default=30)
    a("--batch-size", type=int, help="Batch size", default=512)
    a("--hidden-dim", type=int, help="Hidden dimension", default=758)
    a("--learning-rate", type=float, help="Learning rate", default=0.001)
    a("--clipping-value", type=float, help="Gradient Clipping", default=0.42)
    a("--dropout-p", type=float, help="Dropout propability",
      default=0.032015121309774644)
    a("--n-hidden-layer", type=int, help="Number of hidden layers", default=6)
    a("--model-name", type=str, help="Model name", default="GRU")
    a("--dataset", type=str, help="Dataset", default="asimow")
    a("--n-cycles", type=int, help="Number of cycles", default=5)
    a("--use-wandb", help="Use Weights and Bias for Logging",
      action=argparse.BooleanOptionalAction)
    a("--use-mlflow", help="Use MLflow for Logging",
      action=argparse.BooleanOptionalAction)
    a("--mlflow-url", type=str, help="URL of the MLflow server")
    a("--logging-entity", type=str, help="Weights and Bias or MLflow entity")
    a("--logging-project", type=str, help="Weights and Bias or MLflow project")
    a("--logging-tag", type=str, help="Logging Tag")
    a("--vqvae-model", type=str, help="Model URL for wandb or Path",
      default="model_checkpoints/VQ-VAE-Patch/vq_vae_patch_best_02.ckpt")
    a("--data-dir", type=str, default=None,
      help="Data root override (defaults to .env-driven path)")
    a("--seed", type=int, default=0, help="Model init / sampling seed")
    a("--window-mode", type=str, default="materialize",
      choices=("materialize", "ondevice"),
      help="'ondevice' keeps the packed cycles on the device and gathers "
           "each batch's n-cycle windows there by index (bit-identical "
           "batches, ~n_cycles-times less memory)")
    a("--device", type=str, default=None,
      help="device to train on (default: the CUDA device; 'cpu' runs "
           "the plain PyTorch versions)")
    return parser


def summary_metrics(trainer, task, data_module, best_score) -> tuple:
    """Test, then val, of task.model (the best weights). Returns (the test
    metrics, the summary the reference pushes,
    train_classification_model.py:146-171)."""
    test_metrics = trainer.test(task, data_module)
    val_metrics = trainer.evaluate(task, data_module.val,
                                   data_module.batch_size,
                                   getattr(data_module, "drop_last", False),
                                   "val")
    return test_metrics, {
        "val/mean_f1_score": best_score,
        "val/mean_acc": val_metrics.get("val/acc_mean"),
        "test/mean_f1_score": test_metrics.get("test/f1_score_mean"),
        "test/mean_acc": test_metrics.get("test/acc_mean")}


def main(hparams):
    device = cli_device(hparams.device)
    model_name = hparams.model_name
    classification_model = model_name.split("-")[0]
    dataset = hparams.dataset
    n_cycles = hparams.n_cycles

    tags = None
    if hparams.use_mlflow and hparams.logging_tag:
        tags = dict(tag.split(":") for tag in hparams.logging_tag.split(","))
    logger = select_logger(
        use_wandb=bool(hparams.use_wandb), use_mlflow=bool(hparams.use_mlflow),
        logging_entity=hparams.logging_entity,
        logging_project=hparams.logging_project,
        mlflow_url=hparams.mlflow_url, tags=tags)

    data_dict = get_val_test_ids()
    val_ids, test_ids = data_dict["val_ids"], data_dict["test_ids"]
    logger.log_hyperparams({"val_ids": str(val_ids), "test_ids": str(test_ids),
                            "model_name": model_name,
                            "artifact_name": hparams.vqvae_model})
    logger.log_hyperparams(vars(hparams))

    val_ids = parse_split_ids(val_ids)
    test_ids = parse_split_ids(test_ids)

    if dataset in ("asimow", "asimow_out_of_dist"):
        data_module = ASIMoWDataModule(
            task="classification", batch_size=hparams.batch_size,
            n_cycles=n_cycles, val_data_ids=val_ids, test_data_ids=test_ids,
            data_directory_path=hparams.data_dir,
            window_mode=hparams.window_mode)
        if classification_model == "MLP":
            seq_len, input_dim = 200 * n_cycles, 2
        elif classification_model == "GRU":
            seq_len, input_dim = n_cycles, 200 * 2
        else:
            raise ValueError(
                f"Classification model name: {classification_model} not supported")
    elif dataset in ("latent_vq_vae", "latent_vae"):
        data_module, model_conf = get_latent_dataloader(
            use_wandb=bool(hparams.use_wandb), model_path=hparams.vqvae_model,
            batch_size=hparams.batch_size, val_ids=val_ids, test_ids=test_ids,
            n_cycles=n_cycles, task="classification",
            data_directory_path=hparams.data_dir, device=device)
        seq_len, input_dim = n_cycles, model_conf["latent_dim"]
    else:
        raise ValueError(f"Invalid dataset name. {dataset} not supported")

    print_training_input_shape(data_module)

    if classification_model == "MLP":
        Model = MLP
    elif classification_model == "GRU":
        Model = GRU
    else:
        raise ValueError("model name not supported")
    model = Model(input_size=seq_len, in_dim=input_dim,
                  hidden_sizes=hparams.hidden_dim, dropout_p=hparams.dropout_p,
                  n_hidden_layers=hparams.n_hidden_layer, output_size=2,
                  learning_rate=hparams.learning_rate,
                  generator=torch.Generator().manual_seed(hparams.seed),
                  device=device)
    tx = make_radam(hparams.learning_rate, clip_norm=hparams.clipping_value)

    trainer = Trainer(
        max_epochs=hparams.epochs, logger=logger, monitor="val/f1_score_mean",
        mode="max", patience=5, min_delta=0.001,
        checkpoint_dir="model_checkpoints",
        checkpoint_name=f"{model_name}-{dataset}-best", seed=hparams.seed)
    task = ClassificationTask(model)
    result = trainer.fit(task, data_module, tx)

    best_score = result.best_score
    print(f"best score: {best_score}")
    print("------ Testing ------")

    # best-ckpt reload (reference train_classification_model.py:146-153)
    if result.best_ckpt_path:
        task = ClassificationTask(Model.load(result.best_ckpt_path,
                                             device=device))
    else:
        load_state_dict_checked(model, result.state_dict)
    test_metrics, logdict = summary_metrics(trainer, task, data_module,
                                            best_score)
    push_summary(logger, logdict)
    return result, test_metrics


def cli_main():
    """Console-script entry point (pyproject [project.scripts])."""
    FORMAT = "%(asctime)s - %(levelname)s - %(message)s"
    log.basicConfig(level=log.INFO, format=FORMAT)
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli_main()
