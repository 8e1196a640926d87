"""PyTorch / CUDA port of the arc-welding serving path for NVIDIA Hopper.

Counterpart of the JAX package `vq_vae_transformer_arc_welding_tpu/`,
which stays the reference every module here is tested against. This
package imports torch and numpy only, never jax. Module names mirror
the JAX package; every ported module names its counterpart by path.

What is ported so far is the f32 and calibrated-int8 serving path
(`serve.WeldingQualityPipeline.classify`, `entry.make_pipeline*`).
Its two hand-written CUDA kernels live in `csrc/` and are built on
first use by `kernels.library()`.
"""
