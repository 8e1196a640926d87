"""Tensor ops of the port (counterpart of vq_vae_transformer_arc_welding_tpu/ops/)."""
