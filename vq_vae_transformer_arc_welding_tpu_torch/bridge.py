"""Load the JAX package's parameter trees into the port's modules.

Plays the role of vq_vae_transformer_arc_welding_tpu/train/torch_import.py
in the other direction: the JAX package's `(vq_params, vq_state)` and
`tr_params` pytrees, and its `quantize_transformer` output, become the
port's modules and qparams, so that both packages run on identical
weights and identical int8 scales. Leaves may be numpy arrays or JAX
arrays (anything `np.asarray` takes); nothing here imports jax.
BatchNorm states and QLinears are read by attribute (`.mean`, `.var`,
`.w_int8`, `.scale`, `.bias`, `.act_scale`).
"""
from __future__ import annotations

import numpy as np
import torch

from .models import TransformerDecoder, VQVAEPatch
from .models.quantized import QLinear
from .ops.fused_block_quant import pack_block

_VQ_HPARAMS = ("hidden_dim", "input_dim", "num_embeddings", "embedding_dim",
               "n_resblocks", "learning_rate", "dropout_p", "patch_size",
               "seq_len", "batch_norm", "beta")
_TR_HPARAMS = ("d_model", "n_classes", "seq_len", "n_blocks", "n_head",
               "res_dropout", "att_dropout", "learning_rate", "class_h_bias",
               "class_h_dropout")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _load(module: torch.nn.Module, sd: dict, derived=()) -> None:
    """Strict load, except for buffers the module derives itself."""
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [k for k in missing if k not in derived]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")


def vqvae_from_jax(hparams: dict, params, state, device=None) -> VQVAEPatch:
    """JAX VQVAEPatch (hparams, params, state) -> the port's encoder."""
    if hparams.get("use_improved_vq"):
        raise NotImplementedError("the EMA (improved) VQ is not ported")
    model = VQVAEPatch(**{k: hparams[k] for k in _VQ_HPARAMS if k in hparams},
                       device=device)
    pe = np.asarray(params["patch_embed"]["kernel"])     # (patch, H)
    sd = {"patch_embed.proj.weight": _t(pe.T[:, None, :]),
          "patch_embed.proj.bias": _t(params["patch_embed"]["bias"])}
    for i, blk in enumerate(params["encoder"]):
        pre = f"encoder.0.shared_conv.{i}.block"
        sd[f"{pre}.1.weight"] = _t(blk["conv1_w"])
        sd[f"{pre}.1.bias"] = _t(blk["conv1_b"])
        sd[f"{pre}.4.weight"] = _t(blk["conv2_w"])
        sd[f"{pre}.4.bias"] = _t(blk["conv2_b"])
        if model.batch_norm:
            bns = state["encoder_bn"][i]
            for idx, n in ((2, "1"), (5, "2")):
                sd[f"{pre}.{idx}.weight"] = _t(blk[f"bn{n}_scale"])
                sd[f"{pre}.{idx}.bias"] = _t(blk[f"bn{n}_bias"])
                sd[f"{pre}.{idx}.running_mean"] = _t(bns[f"bn{n}"].mean)
                sd[f"{pre}.{idx}.running_var"] = _t(bns[f"bn{n}"].var)
                sd[f"{pre}.{idx}.num_batches_tracked"] = torch.tensor(0)
    sd["encoder.1.shared_conv.weight"] = _t(params["sep_conv"]["w"])
    sd["encoder.1.shared_conv.bias"] = _t(params["sep_conv"]["b"])
    sd["vector_quantization.embedding.weight"] = _t(params["vq"]["codebook"])
    _load(model, sd)
    return model.eval()


def transformer_from_jax(hparams: dict, params,
                         device=None) -> TransformerDecoder:
    """JAX TransformerDecoder (hparams, params) -> the port's decoder.
    JAX stores Linear weights (in, out); the port (out, in)."""
    model = TransformerDecoder(
        **{k: hparams[k] for k in _TR_HPARAMS if k in hparams}, device=device)
    ch = params["class_head"]
    sd = {"embedding.latent_embedding.weight": _t(params["tok_emb"]),
          "transformer.ln_f.weight": _t(params["ln_f_scale"]),
          "transformer.ln_f.bias": _t(params["ln_f_bias"]),
          "lm_head.weight": _t(params["lm_head_w"]).t(),
          "class_head.linear_1.weight": _t(ch["l1_w"]).t(),
          "class_head.linear_2.weight": _t(ch["l2_w"]).t()}
    if model.class_h_bias:
        sd["class_head.linear_1.bias"] = _t(ch["l1_b"])
        sd["class_head.linear_2.bias"] = _t(ch["l2_b"])
    for i, blk in enumerate(params["blocks"]):
        pre = f"transformer.h.{i}"
        a, m = blk["attn"], blk["mlp"]
        sd.update({
            f"{pre}.ln_1.weight": _t(blk["ln1_scale"]),
            f"{pre}.ln_1.bias": _t(blk["ln1_bias"]),
            f"{pre}.attn.c_attn.weight": _t(a["c_attn_w"]).t(),
            f"{pre}.attn.c_attn.bias": _t(a["c_attn_b"]),
            f"{pre}.attn.c_proj.weight": _t(a["c_proj_w"]).t(),
            f"{pre}.attn.c_proj.bias": _t(a["c_proj_b"]),
            f"{pre}.ln_2.weight": _t(blk["ln2_scale"]),
            f"{pre}.ln_2.bias": _t(blk["ln2_bias"]),
            f"{pre}.mlp.c_fc.weight": _t(m["c_fc_w"]).t(),
            f"{pre}.mlp.c_fc.bias": _t(m["c_fc_b"]),
            f"{pre}.mlp.c_proj.weight": _t(m["c_proj_w"]).t(),
            f"{pre}.mlp.c_proj.bias": _t(m["c_proj_b"]),
        })
    _load(model, sd, derived=("embedding.positional_embedding.pe",))
    return model.eval()


def qlinear_from_jax(q, device=None) -> QLinear:
    """A JAX QLinear ((in, out) int8) -> the port's ((out, in) int8)."""
    w = torch.from_numpy(np.array(np.asarray(q.w_int8).T, order="C"))
    act = (None if q.act_scale is None else torch.tensor(
        np.float32(np.asarray(q.act_scale)), device=device))
    return QLinear(w.to(torch.int8).to(device), _t(q.scale).to(device),
                   None if q.bias is None else _t(q.bias).to(device), act)


def qparams_from_jax(qp, device=None) -> dict:
    """JAX quantize_transformer(...) output -> the port's qparams, with
    calibrated blocks packed for the fused kernel as the port's
    quantize_transformer packs them."""
    def v(a):
        return _t(a).to(device)

    return {
        "tok_emb": v(qp["tok_emb"]),
        "ln_f_scale": v(qp["ln_f_scale"]), "ln_f_bias": v(qp["ln_f_bias"]),
        "lm_head": qlinear_from_jax(qp["lm_head"], device),
        "class_head": {k: qlinear_from_jax(qp["class_head"][k], device)
                       for k in ("l1", "l2")},
        "blocks": [pack_block({
            **{k: v(blk[k]) for k in ("ln1_scale", "ln1_bias", "ln2_scale",
                                       "ln2_bias")},
            **{k: qlinear_from_jax(blk[k], device)
               for k in ("c_attn", "c_proj", "c_fc", "m_proj")},
        }) for blk in qp["blocks"]],
    }
