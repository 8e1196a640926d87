"""Models of the port (counterpart of vq_vae_transformer_arc_welding_tpu/models/)."""
from .gru import GRU
from .mlp import MLP
from .mlp_embedding import MLPEmbedding
from .transformer import TransformerDecoder
from .vqvae_patch import VQVAEPatch

__all__ = ["GRU", "MLP", "MLPEmbedding", "TransformerDecoder", "VQVAEPatch"]
