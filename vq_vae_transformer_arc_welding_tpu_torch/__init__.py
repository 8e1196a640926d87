"""PyTorch / CUDA port of the arc-welding serving path for NVIDIA Hopper.

Counterpart of the JAX package `vq_vae_transformer_arc_welding_tpu/`,
which stays the reference every module here is tested against. This
package imports torch and numpy only, never jax. Module names mirror
the JAX package; every ported module names its counterpart by path.

What is ported: the f32 and calibrated-int8 serving path
(`serve.WeldingQualityPipeline` with `classify`, `encode_tokens`,
`ood_score`, `sample_tokens` and the int8 encoder;
`entry.make_pipeline*`), every configuration of the int8 transformer
(`models/quantized.py`), every encoder path (`ops/fused_encoder.py`,
`ops/fused_vq.py`), and token sampling (`generate`, `generate_kv`,
`quantized_generate_kv`; `ops/fused_decode.py`, `ops/fused_attn.py`).
Its hand-written CUDA kernels, one per TPU kernel of the JAX package,
live in `csrc/` and are built on first use by `kernels.library()`.
Training, the decoder and the EMA VQ are not ported yet. Entry points
(`entry.build`, `bridge.*`) put their tensors on the card unless the
caller names another device.
"""
