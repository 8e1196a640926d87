"""Models of the port (counterpart of vq_vae_transformer_arc_welding_tpu/models/)."""
from .transformer import TransformerDecoder
from .vqvae_patch import VQVAEPatch

__all__ = ["TransformerDecoder", "VQVAEPatch"]
