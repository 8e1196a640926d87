"""TS2Vec (counterpart of vq_vae_transformer_arc_welding_tpu/ts2vec/)."""
from .encoder import TSEncoder
from .losses import hierarchical_contrastive_loss
from .ts2vec import TS2Vec, eval_classification

__all__ = ["TS2Vec", "TSEncoder", "eval_classification",
           "hierarchical_contrastive_loss"]
