"""VQ-VAE reconstruction training CLI.

    python -m vq_vae_transformer_arc_welding_tpu_torch.cli.train_reconstruction_embedding \\
        [--device cpu] [--epochs 50] [--data-dir DIR] ...

Port of vq_vae_transformer_arc_welding_tpu/cli/train_reconstruction_embedding.py
(reference train_reconstruction_embedding.py, flags at :218-246, flow
at :116-215): the same flags and defaults, plus `--device`; the same
checkpoint layout (model_checkpoints/<model>/<model>-best.ckpt +
last.ckpt, in this package's checkpoint format), monitor val/loss with
early-stop patience 5, and the final test pass with the post-fit
weights. The model is built from `--seed` on the CUDA device unless
`--device` names another; without a card and without `--device`,
`main` raises before it reads any data.
"""
from __future__ import annotations

import argparse
import logging as log

import torch

from ..data.asimow import ASIMoWDataModule
from ..data.splits import get_val_test_ids
from ..log.select import select_logger
from ..models.vqvae_patch import VQVAEPatch
from ..train.loop import Trainer
from ..train.optim import make_radam
from ..train.tasks import ReconstructionTask
from .shared import cli_device, parse_split_ids


def build_parser():
    parser = argparse.ArgumentParser(description="Train VQ-VAE")
    a = parser.add_argument
    a("--epochs", type=int, help="Number of epochs to train", default=50)
    a("--batch-size", type=int, help="Batch size", default=1024)
    a("--num-embeddings", type=int, help="Number of embeddings", default=256)
    a("--embedding-dim", type=int, help="Dimension of one embedding", default=32)
    a("--hidden-dim", type=int, help="Hidden dimension", default=512)
    a("--learning-rate", type=float, help="Learning rate", default=0.001)
    a("--clipping-value", type=float, help="Gradient Clipping", default=0.7)
    a("--n-resblocks", type=int, help="Number of Residual Blocks", default=8)
    a("--patch-size", type=int, help="Patch size of the VQ-VAE Encoder", default=25)
    a("--dropout-p", type=float, help="Dropout probability", default=0.1)
    a("--batchnorm", type=int, help="Use the batch normalization layers", default=0)
    a("--use-improved-vq", help="Use the improved VQ mechanism",
      action=argparse.BooleanOptionalAction)
    a("--kmeans-iters", type=int, help="Number of K-Means iterations", default=10)
    a("--threshold-ema-dead-code", type=int, help="Threshold for EMA dead code",
      default=2)
    a("--model-name", type=str, help="Model name", default="VQ-VAE-Patch")
    a("--use-wandb", help="Use Weights and Bias for Logging",
      action=argparse.BooleanOptionalAction)
    a("--use-mlflow", help="Use MLflow for Logging",
      action=argparse.BooleanOptionalAction)
    a("--mlflow-url", type=str, help="URL of the MLflow server",
      default="http://mlflow.tmdt.uni-wuppertal.de/")
    a("--logging-entity", type=str, help="Weights and Bias or MLflow entity")
    a("--logging-project", type=str, help="Weights and Bias or MLflow project",
      default="asimow-vq-vae")
    a("--data-dir", type=str, default=None,
      help="Data root override (defaults to .env-driven path)")
    a("--seed", type=int, default=0, help="Model init / sampling seed")
    a("--dropout-prng", type=str, default="threefry",
      choices=["threefry", "rbg", "unsafe_rbg"],
      help="PRNG of the dropout masks: 'threefry' (the masks come from "
           "torch's Philox generator); 'rbg' and 'unsafe_rbg' are the "
           "TPU's hardware RNG and raise here")
    a("--device", type=str, default=None,
      help="device to train on (default: the CUDA device; 'cpu' runs "
           "the plain PyTorch versions)")
    return parser


def classify_latent_space(latent_model, logger, val_ids, test_ids,
                          n_cycles, model_name, dataset,
                          classification_model, learning_rate,
                          clipping_value, data_dir=None, max_epochs=1):
    """Chained latent-space classification eval after VQ-VAE training
    (reference train_reconstruction_embedding.py:30-111; its call site
    is commented out at :213 — same here, available but not invoked by
    main). Trains an MLP/GRU probe on the frozen VQ-VAE's latents, on
    the VQ-VAE's device, and pushes summary metrics. The latent data
    module keeps nothing on disk, so there is no cache to remove."""
    from ..data.latent import LatentPredDataModule
    from ..models.gru import GRU
    from ..models.mlp import MLP
    from ..train.tasks import ClassificationTask
    from .shared import print_training_input_shape, push_summary

    model = latent_model
    dm = LatentPredDataModule(
        model, task="classification", n_cycles=n_cycles,
        val_data_ids=val_ids, test_data_ids=test_ids, model_name=model_name,
        model_id=f"{model_name}-{dataset}", batch_size=128,
        data_directory_path=data_dir)
    print_training_input_shape(dm)

    input_dim = int(model.embedding_dim * model.enc_out_len)
    if classification_model == "MLP":
        Probe = MLP
    elif classification_model == "GRU":
        Probe = GRU
    else:
        raise ValueError(
            f"Invalid classification model name: {classification_model}")
    probe = Probe(input_size=n_cycles, in_dim=input_dim, hidden_sizes=128,
                  dropout_p=0.1, n_hidden_layers=4, output_size=2,
                  learning_rate=learning_rate,
                  generator=torch.Generator().manual_seed(0),
                  device=model.codebook.device)
    tx = make_radam(learning_rate, clip_norm=clipping_value)
    trainer = Trainer(
        max_epochs=max_epochs, logger=logger, monitor="val/f1_score_mean",
        mode="max", patience=10, min_delta=0.0001,
        checkpoint_dir=f"model_checkpoints/VQ-VAE-{classification_model}/",
        checkpoint_name=f"VQ-VAE-{classification_model}-{dataset}-best")
    task = ClassificationTask(probe)
    res = trainer.fit(task, dm, tx)
    print(f"best score: {res.best_score}")
    print("------ Testing ------")
    test_metrics = trainer.test(task, dm)
    val_metrics = trainer.evaluate(task, dm.val, dm.batch_size, False, "val")
    push_summary(logger, {
        "val/mean_f1_score": res.best_score,
        "val/mean_acc": val_metrics.get("val/acc_mean"),
        "test/mean_f1_score": test_metrics.get("test/f1_score_mean"),
        "test/mean_acc": test_metrics.get("test/acc_mean")})
    return test_metrics


def main(hparams):
    device = cli_device(hparams.device)
    model_name = hparams.model_name
    batch_norm = bool(hparams.batchnorm)

    logger = select_logger(
        use_wandb=bool(hparams.use_wandb), use_mlflow=bool(hparams.use_mlflow),
        logging_entity=hparams.logging_entity,
        logging_project=hparams.logging_project, mlflow_url=hparams.mlflow_url)

    dataset_dict = get_val_test_ids()
    val_ids, test_ids = dataset_dict["val_ids"], dataset_dict["test_ids"]
    logger.log_hyperparams({"val_ids": str(val_ids), "test_ids": str(test_ids),
                            "model_name": model_name,
                            "clipping_value": hparams.clipping_value})
    log.info(f"Val ids: {val_ids}")
    log.info(f"Test ids: {test_ids}")

    data_module = ASIMoWDataModule(
        task="reconstruction", batch_size=hparams.batch_size, n_cycles=1,
        val_data_ids=parse_split_ids(val_ids),
        test_data_ids=parse_split_ids(test_ids),
        data_directory_path=hparams.data_dir)
    data_module.setup("fit")
    log.info(f"Loaded Data - Train dataset size: {len(data_module.train.x)}")

    if model_name != "VQ-VAE-Patch":
        raise ValueError("Invalid model name")
    model = VQVAEPatch(
        hidden_dim=hparams.hidden_dim, input_dim=2,
        num_embeddings=hparams.num_embeddings,
        embedding_dim=hparams.embedding_dim, n_resblocks=hparams.n_resblocks,
        learning_rate=hparams.learning_rate, dropout_p=hparams.dropout_p,
        patch_size=hparams.patch_size, batch_norm=batch_norm,
        use_improved_vq=bool(hparams.use_improved_vq),
        kmeans_iters=hparams.kmeans_iters,
        threshold_ema_dead_code=hparams.threshold_ema_dead_code,
        generator=torch.Generator().manual_seed(hparams.seed), device=device)
    tx = make_radam(hparams.learning_rate, clip_norm=hparams.clipping_value)

    trainer = Trainer(
        max_epochs=hparams.epochs, logger=logger, monitor="val/loss",
        mode="min", patience=5, min_delta=0.0001,
        checkpoint_dir=f"model_checkpoints/{model_name}/",
        checkpoint_name=f"{model_name}-best", save_last=True,
        seed=hparams.seed, dropout_prng=hparams.dropout_prng)
    task = ReconstructionTask(model)
    result = trainer.fit(task, data_module, tx)

    # the model trains in place: the test sees the post-fit weights, as
    # the reference's does (train_reconstruction_embedding.py:204-211)
    test_metrics = trainer.test(task, data_module)
    logger.finalize()
    return result, test_metrics


def cli_main():
    """Console-script entry point (pyproject [project.scripts])."""
    FORMAT = "%(asctime)s - %(levelname)s - %(message)s"
    log.basicConfig(level=log.INFO, format=FORMAT)
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli_main()
