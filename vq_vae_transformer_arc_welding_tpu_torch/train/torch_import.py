"""Read reference PyTorch-Lightning checkpoints into the port's modules.

Port of the reading half of
vq_vae_transformer_arc_welding_tpu/train/torch_import.py
(`load_lightning_state_dict`, `load_vqvae_checkpoint`, and the
transformer's counterpart). The port's modules carry the reference's
state_dict keys, so a reference checkpoint loads by name, the VQ-VAE
whole, decoder and inverse patch embedding included, with the classic
codebook or the EMA VQ's (`vector_quantization.vq.layers.0._codebook.*`).
Two things are handled here: the attention blocks' causal-mask
buffers, which the port builds itself, are skipped, and an EMA codebook
written without its `initted` flag (the JAX package's exporter writes
none) counts as bootstrapped, as the JAX reader takes it. Any other
unexpected or missing key raises.
"""
from __future__ import annotations

import re

import torch

from ..models.base import load_state_dict_checked, serving_device
from .checkpoint import read_payload

# the reference registers each block's (1, 1, T, T) causal mask as a buffer
TRANSFORMER_MASK_KEYS = re.compile(r"^transformer\.h\.\d+\.attn\.bias$")
_EMA_PREFIX = "vector_quantization.vq.layers.0._codebook"

_VQ_HPARAMS = ("hidden_dim", "input_dim", "num_embeddings", "embedding_dim",
               "n_resblocks", "learning_rate", "dropout_p", "patch_size",
               "seq_len", "batch_norm", "beta", "use_improved_vq",
               "kmeans_iters", "threshold_ema_dead_code")
_TR_HPARAMS = ("d_model", "n_classes", "seq_len", "n_blocks", "n_head",
               "res_dropout", "att_dropout", "learning_rate", "class_h_bias",
               "class_h_dropout")


def load_lightning_state_dict(path: str):
    """A Lightning .ckpt -> (hyper_parameters dict, state_dict)."""
    payload = read_payload(path)
    return dict(payload.get("hyper_parameters", {})), payload["state_dict"]


def load_vqvae_checkpoint(path: str, device=None, vq_impl: str = "xla"):
    """Lightning .ckpt -> VQVAEPatch in eval mode on the serving device."""
    from ..models.vqvae_patch import VQVAEPatch
    hp, sd = load_lightning_state_dict(path)
    kw = {k: hp[k] for k in _VQ_HPARAMS if k in hp}
    if f"{_EMA_PREFIX}.embed" in sd:
        kw["use_improved_vq"] = True
        sd = dict(sd)
        sd.setdefault(f"{_EMA_PREFIX}.initted", torch.ones(1))
    model = VQVAEPatch(**kw, vq_impl=vq_impl, device=serving_device(device))
    load_state_dict_checked(model, sd)
    return model.eval()


def load_transformer_checkpoint(path: str, device=None,
                                attention_impl: str = "xla"):
    """Lightning .ckpt -> TransformerDecoder in eval mode on the serving
    device."""
    from ..models.transformer import TransformerDecoder
    hp, sd = load_lightning_state_dict(path)
    model = TransformerDecoder(**{k: hp[k] for k in _TR_HPARAMS if k in hp},
                               attention_impl=attention_impl,
                               device=serving_device(device))
    load_state_dict_checked(model, sd, skipped=TRANSFORMER_MASK_KEYS)
    return model.eval()
