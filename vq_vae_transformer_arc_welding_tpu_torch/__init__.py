"""PyTorch / CUDA port of the arc-welding serving, deployment and
training paths for NVIDIA Hopper.

Counterpart of the JAX package `vq_vae_transformer_arc_welding_tpu/`,
which stays the reference every module here is tested against. This
package imports torch and numpy only, never jax. Module names mirror
the JAX package; every ported module names its counterpart by path.

What is ported: the f32 and calibrated-int8 serving path
(`serve.WeldingQualityPipeline` with `classify`, `encode_tokens`,
`ood_score`, `sample_tokens` and the int8 encoder;
`entry.make_pipeline*`), every configuration of the int8 transformer
(`models/quantized.py`), every encoder path (`ops/fused_encoder.py`,
`ops/fused_vq.py`), token sampling (`generate`, `generate_kv`,
`quantized_generate_kv`; `ops/fused_decode.py`, `ops/fused_attn.py`),
the deployment path: checkpoints (`train/checkpoint.py`, `Model.save`
/ `Model.load`), reference Lightning files (`train/torch_import.py`),
artifacts and `from_checkpoints` (`serve.py`), bf16 serving, the bf16
encoder, the numpy data modules and the native CSV parser (`data/`,
`native/`), the latent data module (`data/latent.py`) and the scorer
(`cli/score_quality.py`); and training of the VQ-VAE and the
transformer: the VQ-VAE's decoder and losses, the transformer's train
forward and losses, dropout on explicit generators (`utils/random.py`),
RAdam with clipping, decay split and schedule (`train/optim.py`), the
reconstruction and transformer tasks (`train/tasks.py`) and the
resident-data `Trainer` (`train/loop.py`), with #7 and #9 on the
training forward; the rest of training below the CLIs: the EMA VQ
(`ops/vq_ema.py`), the MLP, GRU and MLPEmbedding classifiers with
`ClassificationTask`, windows gathered on the device
(`data/windowed.py`), training data streamed from a memory map
(`data/streaming.py`), bf16 training (`ops/precision.py`) and a JAX
run's RAdam state (`bridge.radam_state_from_jax`); and the layer users
start from the shell: the loggers (`log/`: CSV, wandb, MLflow), run
names (`utils/names.py`), the figure helper (`models/plot_helper.py`,
matplotlib imported only inside its functions) and the three training
CLIs (`cli/train_reconstruction_embedding.py`,
`cli/train_classification_model.py`, `cli/train_transformer_mtasks.py`,
each `python -m ...` with `--device`); several devices (`parallel/`:
meshes and their process groups, one process a device, data, tensor
and pipeline parallel training through `Trainer(mesh=, param_rules=)`,
ring attention, serving over a mesh, sharded checkpoints,
`entry.dryrun_multichip`); and TS2Vec (`ts2vec/`).
Its hand-written CUDA kernels, one per TPU kernel of the JAX package
and variant, live in `csrc/` and are built on first use by
`kernels.library()`. Entry points
(`entry.build`, `bridge.*`, `Model.load`, `load_artifact`,
`from_checkpoints`, the scorer, the training CLIs) put their tensors on
the card unless the caller names another device.
"""
