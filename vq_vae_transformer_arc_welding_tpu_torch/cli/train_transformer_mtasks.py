"""Multitask latent-transformer CLI (generation + classification).

    python -m vq_vae_transformer_arc_welding_tpu_torch.cli.train_transformer_mtasks \\
        [--device cpu] --vqvae-model CKPT [--epoch_iter 3] ...

Port of vq_vae_transformer_arc_welding_tpu/cli/train_transformer_mtasks.py
(reference train_transformer_mtasks.py, flags :211-238, flow :99-207):
the same flags and defaults, plus `--device`; the alternating task
schedule (per iteration: the generation epochs, then the
classification epochs; the last iteration runs the finetune stage),
a fresh RAdam (clip 0.8) at every stage, as each reference stage's
fresh Lightning Trainer re-runs configure_optimizers, with
accumulate_grad_batches=5, and the final test of both tasks. Like the
JAX CLI it writes no checkpoint: `main` returns the run, whose model a
caller saves with `run.model.save(path)`.

The model and data go on the CUDA device unless `--device` names
another; without a card and without `--device`, `main` raises before
it reads any data. `--use-all-gpus` on one device trains on it, as in
the JAX package. A mesh over several (`--use-all-gpus` on more,
`--pipeline-stages`, `--tensor-parallel`) is the JAX CLI's
(`_maybe_mesh`): `main` starts one process per device of it
(parallel/launch.py, NCCL), each runs the whole schedule on its rank
(data parallel over 'data', the transformer's weights sharded over
'model' by parallel/sharding.py's rules, or its blocks staged over
'pipe' by parallel/pipeline.PipelinedDecoder), rank 0 logs, and `main`
returns rank 0's results with the trained weights, dense, in `run.model`
on `--device`.
"""
from __future__ import annotations

import argparse
import logging as log
import os

import torch

from ..data.splits import get_val_test_ids
from ..log.select import select_logger
from ..models.transformer import TransformerDecoder
from ..train.loop import Trainer
from ..train.optim import make_transformer_optimizer
from ..train.tasks import TransformerClassTask, TransformerGenTask
from .shared import (cli_device, get_latent_dataloader, load_transformer_any,
                     parse_split_ids, print_training_input_shape)


def build_parser():
    parser = argparse.ArgumentParser(description="Train-Latent-Transformer")
    a = parser.add_argument
    a("--epoch_iter", type=int, default=3,
      help="Number of epochs iterations (15 epochs autoregressive train, "
           "2 epochs classification")
    a("--batch-size", type=int, help="Batch size", default=16)
    a("--n-cycles", type=int, help="Number of cycles", default=20)
    a("--d-model", type=int, help="Number of embeddings", default=512)
    a("--n-heads", type=int, help="Number of heads", default=8)
    a("--n-blocks", type=int, help="Number of transformer blocks", default=6)
    a("--use-class-head-bias", action=argparse.BooleanOptionalAction)
    a("--use-class-head-dropout", action=argparse.BooleanOptionalAction)
    a("--use-wandb", action=argparse.BooleanOptionalAction,
      help="Use Weights and Bias for Logging & loading the model from wandb")
    a("--use-wandb-for-logging", action=argparse.BooleanOptionalAction,
      help="Use Weights and Bias for Logging")
    a("--use-mlflow", action=argparse.BooleanOptionalAction,
      help="Use MLflow for Logging")
    a("--mlflow-url", type=str, help="URL of the MLflow server",
      default="http://mlflow.tmdt.uni-wuppertal.de/")
    a("--logging-entity", type=str, help="Weights and Bias or MLflow entity")
    a("--logging-project", type=str, help="Weights and Bias or MLflow project",
      default="asimow-vq-vae-transformer")
    a("--vqvae-model", type=str, help="Model URL for wandb or Path",
      default="model_checkpoints/VQ-VAE-Patch/vq_vae_patch_best_01.ckpt")
    a("--classification-only", action=argparse.BooleanOptionalAction)
    a("--no-early-stopping", action=argparse.BooleanOptionalAction)
    a("--class-epoch", type=int, default=2,
      help="Number of epochs for classification")
    a("--finetune-epochs", type=int, default=10,
      help="Number of epochs for classification")
    a("--model-wandb-transformer", type=str, default="",
      help="Transformer checkpoint (path, or wandb link with --use-wandb) "
           "for --classification-only")
    a("--use-all-gpus", action=argparse.BooleanOptionalAction)
    a("--pipeline-stages", type=int, default=0,
      help="Pipeline-parallel stages over the 'pipe' mesh axis; 0/1 = off")
    a("--pipeline-microbatches", type=int, default=0,
      help="Microbatches streamed through the pipeline (default = "
           "pipeline stages)")
    a("--tensor-parallel", type=int, default=0,
      help="Tensor-parallel ways over the 'model' mesh axis (Megatron "
           "rules); 0/1 = off")
    a("--gen-epochs", type=int, default=10,
      help="Generation epochs per iteration")
    a("--data-dir", type=str, default=None,
      help="Data root override (defaults to .env-driven path)")
    a("--seed", type=int, default=0, help="Model init / sampling seed")
    a("--device", type=str, default=None,
      help="device to train on (default: the CUDA device; 'cpu' runs "
           "the plain PyTorch versions)")
    return parser


def load_dataset(hparams, only_classify=False, device=None):
    data_dict = get_val_test_ids()
    val_ids = parse_split_ids(data_dict["val_ids"])
    test_ids = parse_split_ids(data_dict["test_ids"])

    gen_dm = None
    if not only_classify:
        gen_dm, _ = get_latent_dataloader(
            bool(hparams.use_wandb), hparams.n_cycles, hparams.vqvae_model,
            val_ids, test_ids, hparams.batch_size, task="autoregressive_ids",
            data_directory_path=hparams.data_dir, device=device)
        print_training_input_shape(gen_dm)
    class_dm, model_config = get_latent_dataloader(
        bool(hparams.use_wandb), hparams.n_cycles, hparams.vqvae_model,
        val_ids, test_ids, hparams.batch_size,
        task="autoregressive_ids_classification",
        data_directory_path=hparams.data_dir, device=device)
    return (model_config["num_embeddings"], model_config["patch_size"],
            class_dm, gen_dm)


def _make_trainer(epochs, logger, *, monitor=None, mode="max", patience=None,
                  min_delta=0.001, seed=0, mesh=None, param_rules=None):
    return Trainer(max_epochs=epochs, logger=logger, monitor=monitor,
                   mode=mode, patience=patience, min_delta=min_delta,
                   accumulate_grad_batches=5, seed=seed, mesh=mesh,
                   param_rules=param_rules)


def _maybe_mesh(use_all_devices: bool, pipeline_stages: int = 0,
                tensor_parallel: int = 0, devices=None):
    """--use-all-gpus == the reference's DDP switch: data parallel over
    every device (the CUDA devices, or `devices`); None on one device.
    --pipeline-stages > 1 adds a 'pipe' axis, --tensor-parallel > 1 a
    'model' axis, each with the remaining devices on 'data' under
    --use-all-gpus. The JAX CLI's choices and messages."""
    from ..parallel.mesh import _devices, make_mesh, make_mesh_dp_pp
    devices = _devices(devices)
    if pipeline_stages > 1 and tensor_parallel > 1:
        raise NotImplementedError(
            "--pipeline-stages and --tensor-parallel compose on "
            "different mesh axes ('pipe' vs 'model'); pick one per run")
    if pipeline_stages > 1:
        if len(devices) < pipeline_stages:
            raise ValueError(
                f"--pipeline-stages {pipeline_stages} needs at least that "
                f"many devices; {len(devices)} available")
        n_data = (len(devices) // pipeline_stages if use_all_devices else 1)
        return make_mesh_dp_pp(n_data=n_data, n_pipe=pipeline_stages,
                               devices=devices)
    if tensor_parallel > 1:
        if len(devices) < tensor_parallel:
            raise ValueError(
                f"--tensor-parallel {tensor_parallel} needs at least that "
                f"many devices; {len(devices)} available")
        n_data = (len(devices) // tensor_parallel if use_all_devices else 1)
        return make_mesh(n_data=n_data, n_model=tensor_parallel,
                         devices=devices)
    if not use_all_devices or len(devices) < 2:
        return None
    return make_mesh(n_data=len(devices), devices=devices)


class _NoLogger:
    """What a rank other than 0 logs to: nothing."""

    def log_metrics(self, metrics, step=None):
        pass

    def finalize(self, status: str = "success"):
        pass


class _TransformerRun:
    """The model trained across the alternating stages, its optimizer
    spec, and the last stage's optimizer."""

    def __init__(self, model):
        self.model = model
        self.tx = make_transformer_optimizer(model, clip_norm=0.8)
        self.opt = None

    def fit_stage(self, trainer, task, dm):
        # each reference stage builds a fresh Lightning Trainer, which
        # re-runs configure_optimizers: RAdam moments reset per stage
        # (train_transformer_mtasks.py:23-33,178-191), as `fit` without
        # an optimizer builds a new one from the spec
        res = trainer.fit(task, dm, self.tx)
        self.opt = res.optimizer
        return res


def classification_finetuning(run, classification_epoch, logger, class_dm,
                              no_early_stopping=False, seed=0, trainer=None,
                              task=None):
    if trainer is None:
        trainer = _make_trainer(classification_epoch, logger, seed=seed)
    trainer.max_epochs = classification_epoch
    trainer.monitor = "val/cl/f1_score"
    trainer.mode = "max"
    trainer.patience = None if no_early_stopping else 5
    trainer.seed = seed
    task = task or TransformerClassTask(run.model)
    run.fit_stage(trainer, task, class_dm)
    return trainer.test(task, class_dm)


def main(hparams, devices=None):
    """The run: (a _TransformerRun, {stage: test metrics}). devices: the
    devices a mesh may take (default: the CUDA devices)."""
    device = cli_device(hparams.device)
    mesh = _maybe_mesh(bool(hparams.use_all_gpus), hparams.pipeline_stages,
                       hparams.tensor_parallel, devices)
    if mesh is None:
        return _train(hparams, device)
    from ..parallel import jobs, launch
    spec, results = launch.run(_rank_main, mesh, hparams)[0]
    return _TransformerRun(jobs.build(spec, device).eval()), results


def _rank_main(mesh, hparams):
    """One rank of a mesh run: the schedule on its device; rank 0 returns
    the dense weights' spec beside the results."""
    from ..parallel.jobs import model_spec
    from ..parallel.sharding import dense_state_dict
    run, results = _train(hparams, mesh.device, mesh)
    sd = dense_state_dict(run.model)
    return (model_spec(run.model, state_dict=sd) if mesh.rank == 0
            else None), results


def _train(hparams, device, mesh=None):
    writer = mesh is None or mesh.rank == 0
    logger = (select_logger(
        use_wandb=bool(hparams.use_wandb or hparams.use_wandb_for_logging),
        use_mlflow=bool(hparams.use_mlflow),
        logging_entity=hparams.logging_entity,
        logging_project=hparams.logging_project, mlflow_url=hparams.mlflow_url)
        if writer else _NoLogger())
    if hasattr(logger, "log_hyperparams"):
        logger.log_hyperparams(vars(hparams))
    param_rules = None
    if mesh is not None and hparams.tensor_parallel > 1:
        from ..parallel.sharding import transformer_tp_rules
        param_rules = transformer_tp_rules

    def placed(model):
        """The model as the mesh trains it: pipelined over 'pipe'."""
        if mesh is None or "pipe" not in mesh.axis_names:
            return model
        from ..parallel.pipeline import PipelinedDecoder
        n_micro = hparams.pipeline_microbatches or hparams.pipeline_stages
        return PipelinedDecoder(model, mesh, n_micro=n_micro)

    def trainer(epochs, seed):
        return _make_trainer(epochs, logger, seed=seed, mesh=mesh,
                             param_rules=param_rules)

    num_embeddings, patch_size, class_dm, gen_dm = load_dataset(
        hparams, only_classify=bool(hparams.classification_only),
        device=device)
    print_training_input_shape(class_dm)

    seq_len = (hparams.n_cycles * (400 // patch_size)) + 1
    num_classes = num_embeddings + 2
    log.info(f"seq_len={seq_len} - num_classes={num_classes} - "
             f"num_embeddings={num_embeddings} - patch_size={patch_size}")

    model = TransformerDecoder(
        d_model=hparams.d_model, seq_len=seq_len, n_classes=num_classes,
        n_head=hparams.n_heads, n_blocks=hparams.n_blocks,
        class_h_bias=bool(hparams.use_class_head_bias),
        class_h_dropout=bool(hparams.use_class_head_dropout),
        generator=torch.Generator().manual_seed(hparams.seed), device=device)
    run = _TransformerRun(placed(model))
    n_params = sum(p.numel() for p in model.blocks.parameters())
    if writer:
        print("number of parameters: %.4fM" % (n_params / 1e6,))

    results = {}
    if hparams.classification_only:
        if hparams.model_wandb_transformer:
            model_path = hparams.model_wandb_transformer
            if hparams.use_wandb:
                # wandb artifact link -> local ckpt (reference
                # train_transformer_mtasks.py:164-171)
                import wandb
                artifact_dir = f"./artifacts/{model_path.split('/')[-1]}"
                artifact = wandb.use_artifact(model_path, type="model")
                if not os.path.exists(artifact_dir):
                    artifact_dir = artifact.download()
                model_path = artifact_dir + "/model.ckpt"
            run = _TransformerRun(placed(load_transformer_any(
                model_path, device=device)))
        results["class_test"] = classification_finetuning(
            run, hparams.class_epoch, logger, class_dm,
            no_early_stopping=bool(hparams.no_early_stopping),
            seed=hparams.seed,
            trainer=trainer(hparams.class_epoch, hparams.seed))
    else:
        gen_task = TransformerGenTask(run.model)
        class_task = TransformerClassTask(run.model)
        gen_trainer = trainer(hparams.gen_epochs, hparams.seed)
        class_trainer = trainer(hparams.class_epoch, hparams.seed + 1)
        for epoch in range(hparams.epoch_iter):
            log.info("Genrerating stage")
            gen_trainer.seed = hparams.seed + epoch
            run.fit_stage(gen_trainer, gen_task, gen_dm)

            if epoch == hparams.epoch_iter - 1:
                results["class_test"] = classification_finetuning(
                    run, hparams.finetune_epochs, logger, class_dm,
                    no_early_stopping=bool(hparams.no_early_stopping),
                    seed=hparams.seed + epoch, trainer=class_trainer,
                    task=class_task)
            else:
                log.info("Classification stage")
                class_trainer.seed = hparams.seed + epoch
                run.fit_stage(class_trainer, class_task, class_dm)

        results["class_test_final"] = class_trainer.test(class_task,
                                                         class_dm)
        results["gen_test"] = gen_trainer.test(gen_task, gen_dm)

    logger.finalize()
    if writer:
        print("Done")
    return run, results


def cli_main():
    """Console-script entry point (pyproject [project.scripts])."""
    FORMAT = "%(asctime)s - %(levelname)s - %(message)s"
    log.basicConfig(level=log.INFO, format=FORMAT)
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli_main()
