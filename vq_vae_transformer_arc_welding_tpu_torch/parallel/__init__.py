"""Multi-device training and serving (counterpart of
vq_vae_transformer_arc_welding_tpu/parallel/): meshes and their process
groups, the rank launcher, tensor, pipeline and sequence parallelism."""
from .mesh import Mesh, make_mesh, make_mesh_dp_pp
from .pipeline import PipelinedDecoder, pipeline_apply, pipeline_backbone
from .sharding import shard_params, transformer_tp_rules

__all__ = ["Mesh", "PipelinedDecoder", "make_mesh", "make_mesh_dp_pp",
           "pipeline_apply", "pipeline_backbone", "shard_params",
           "transformer_tp_rules"]
