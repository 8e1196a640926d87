"""Load the JAX package's parameter trees into the port's modules.

Plays the role of vq_vae_transformer_arc_welding_tpu/train/torch_import.py
in the other direction: the JAX package's `(vq_params, vq_state)` and
`tr_params` pytrees, and its `quantize_transformer` and
`quantize_encoder` outputs, become the port's modules, qparams and
qenc, so that both packages run on identical weights and identical
int8 scales; `artifact_from_jax` turns a whole JAX serving pipeline
(trees, manifest fields, absmax tables, scaler) into a port pipeline
that `save_artifact` can write. The classifiers (`MLP`, `GRU`,
`MLPEmbedding`) come across with their BatchNorm states, and the VQ-VAE
with the EMA codebook where it has one; `radam_state_from_jax` carries a
JAX run's optimizer state (the optax chain of `make_radam`) into the
port's `TrainOptimizer`, so that a run can move between the packages
mid-way. Every function builds on the card unless the caller names
another device (the tests pass `device="cpu"`). Leaves may be numpy
arrays or JAX arrays (anything `np.asarray` takes); nothing here
imports jax.
BatchNorm states and QLinears are read by attribute (`.mean`, `.var`,
`.w_int8`, `.scale`, `.bias`, `.act_scale`).
"""
from __future__ import annotations

import numpy as np
import torch

from .models import GRU, MLP, MLPEmbedding, TransformerDecoder, VQVAEPatch
from .models.base import serving_device
from .models.quantized import QLinear
from .ops.fused_block_quant import pack_block
from .serve import WeldingQualityPipeline

_VQ_HPARAMS = ("hidden_dim", "input_dim", "num_embeddings", "embedding_dim",
               "n_resblocks", "learning_rate", "dropout_p", "patch_size",
               "seq_len", "batch_norm", "beta", "use_improved_vq",
               "kmeans_iters", "threshold_ema_dead_code")
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


def _resblocks(sd: dict, prefix: str, blocks, bn_states, batch_norm: bool):
    """A JAX list of resblock dicts (and their BN states) under the
    reference keys `{prefix}.{i}.block.{1,2,4,5}.*`."""
    for i, blk in enumerate(blocks):
        pre = f"{prefix}.{i}.block"
        sd[f"{pre}.1.weight"] = _t(blk["conv1_w"])
        sd[f"{pre}.1.bias"] = _t(blk["conv1_b"])
        sd[f"{pre}.4.weight"] = _t(blk["conv2_w"])
        sd[f"{pre}.4.bias"] = _t(blk["conv2_b"])
        if batch_norm:
            for idx, n in ((2, "1"), (5, "2")):
                sd[f"{pre}.{idx}.weight"] = _t(blk[f"bn{n}_scale"])
                sd[f"{pre}.{idx}.bias"] = _t(blk[f"bn{n}_bias"])
                _bn(sd, f"{pre}.{idx}", bn_states[i][f"bn{n}"])


def _bn(sd: dict, prefix: str, st) -> None:
    sd[f"{prefix}.running_mean"] = _t(st.mean)
    sd[f"{prefix}.running_var"] = _t(st.var)
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def vqvae_state_dict(hparams: dict, params, state) -> dict:
    """A JAX VQVAEPatch's (params, state) under the port's state_dict
    keys: every parameter, every BatchNorm's running statistics
    (`encoder_bn`, `decoder_bn`, `inverse_bn`), and the EMA VQ's state
    (`state["vq"]`) where `use_improved_vq` is set."""
    pe = np.asarray(params["patch_embed"]["kernel"])     # (patch, H)
    sd = {"patch_embed.proj.weight": _t(pe.T[:, None, :]),
          "patch_embed.proj.bias": _t(params["patch_embed"]["bias"])}
    bn = hparams.get("batch_norm", True)
    _resblocks(sd, "encoder.0.shared_conv", params["encoder"],
               state.get("encoder_bn"), bn)
    sd["encoder.1.shared_conv.weight"] = _t(params["sep_conv"]["w"])
    sd["encoder.1.shared_conv.bias"] = _t(params["sep_conv"]["b"])
    if hparams.get("use_improved_vq"):
        from .models.vqvae_patch import EMA_PREFIX
        ema = state["vq"]
        sd[f"{EMA_PREFIX}.embed"] = _t(ema.codebook)[None]
        sd[f"{EMA_PREFIX}.cluster_size"] = _t(ema.cluster_size)[None]
        sd[f"{EMA_PREFIX}.embed_avg"] = _t(ema.embed_avg)[None]
        sd[f"{EMA_PREFIX}.initted"] = _t(ema.initialized).reshape(1)
    else:
        sd["vector_quantization.embedding.weight"] = _t(
            params["vq"]["codebook"])
    sd["decoder.0.weight"] = _t(params["decoder_in"]["w"])
    sd["decoder.0.bias"] = _t(params["decoder_in"]["b"])
    _resblocks(sd, "decoder.1.shared_conv", params["decoder"],
               state.get("decoder_bn"), bn)
    inv = params["inverse"]
    pre = "reverse_patch_embed.proj"
    sd.update({f"{pre}.0.weight": _t(inv["ct1_kernel"]),
               f"{pre}.0.bias": _t(inv["ct1_bias"]),
               f"{pre}.1.weight": _t(inv["bn_scale"]),
               f"{pre}.1.bias": _t(inv["bn_bias"]),
               f"{pre}.3.weight": _t(inv["ct2_kernel"]),
               f"{pre}.3.bias": _t(inv["ct2_bias"])})
    _bn(sd, f"{pre}.1", state["inverse_bn"])
    return sd


def vqvae_from_jax(hparams: dict, params, state, device=None,
                   vq_impl: str = "xla") -> VQVAEPatch:
    """JAX VQVAEPatch (hparams, params, state) -> the port's VQ-VAE
    (`vqvae_state_dict`). vq_impl is the runtime option of both models;
    it is not an hparam."""
    model = VQVAEPatch(**{k: hparams[k] for k in _VQ_HPARAMS if k in hparams},
                       vq_impl=vq_impl, device=serving_device(device))
    _load(model, vqvae_state_dict(hparams, params, state))
    return model.eval()


def transformer_from_jax(hparams: dict, params, device=None,
                         attention_impl: str = "xla") -> TransformerDecoder:
    """JAX TransformerDecoder (hparams, params) -> the port's decoder.
    JAX stores Linear weights (in, out); the port (out, in).
    attention_impl is the runtime option of both models; it is not an
    hparam."""
    model = TransformerDecoder(
        **{k: hparams[k] for k in _TR_HPARAMS if k in hparams},
        attention_impl=attention_impl, device=serving_device(device))
    _load(model, transformer_state_dict(hparams, params),
          derived=("embedding.positional_embedding.pe",))
    return model.eval()


def transformer_state_dict(hparams: dict, params) -> dict:
    """A JAX TransformerDecoder's params under the port's state_dict
    keys, the Linear weights transposed to (out, in)."""
    ch = params["class_head"]
    sd = {"embedding.latent_embedding.weight": _t(params["tok_emb"]),
          "transformer.ln_f.weight": _t(params["ln_f_scale"]),
          "transformer.ln_f.bias": _t(params["ln_f_bias"]),
          "lm_head.weight": _t(params["lm_head_w"]).t(),
          "class_head.linear_1.weight": _t(ch["l1_w"]).t(),
          "class_head.linear_2.weight": _t(ch["l2_w"]).t()}
    if hparams.get("class_h_bias", False):
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
    return sd


def _stacks_state_dict(params, state) -> dict:
    """The Linear+BatchNorm stacks and head of the JAX MLP and
    MLPEmbedding under the reference's `layers.*` keys."""
    layers = params["layers"]
    sd = {}
    for i, lay in enumerate(layers):
        sd[f"layers.{3 * i}.weight"] = _t(lay["w"]).t()
        sd[f"layers.{3 * i}.bias"] = _t(lay["b"])
        sd[f"layers.{3 * i + 1}.weight"] = _t(lay["bn_scale"])
        sd[f"layers.{3 * i + 1}.bias"] = _t(lay["bn_bias"])
        _bn(sd, f"layers.{3 * i + 1}", state["bn"][i])
    head = 3 * len(layers) + 1
    sd[f"layers.{head}.weight"] = _t(params["head"]["w"]).t()
    sd[f"layers.{head}.bias"] = _t(params["head"]["b"])
    return sd


def mlp_state_dict(hparams: dict, params, state) -> dict:
    """A JAX MLP's (params, state) under the reference's keys."""
    return _stacks_state_dict(params, state)


def mlp_embedding_state_dict(hparams: dict, params, state) -> dict:
    """A JAX MLPEmbedding's (params, state) under the reference's keys."""
    return {"embedding.weight": _t(params["embedding"]),
            **_stacks_state_dict(params, state)}


def gru_state_dict(hparams: dict, params, state=None) -> dict:
    """A JAX GRU's params under nn.GRU's and the reference's keys."""
    sd = {}
    for k, lay in enumerate(params["gru"]):
        for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                          ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
            sd[f"gru.{name}_l{k}"] = _t(lay[key])
    sd["output_layer.weight"] = _t(params["head"]["w"]).t()
    sd["output_layer.bias"] = _t(params["head"]["b"])
    return sd


def _classifier_from_jax(cls, to_sd, hparams, params, state, device,
                         **runtime):
    model = cls(**hparams, **runtime, device=serving_device(device))
    _load(model, to_sd(hparams, params, state))
    return model.eval()


def mlp_from_jax(hparams: dict, params, state, device=None,
                 compute_dtype=None) -> MLP:
    """JAX MLP (hparams, params, state) -> the port's MLP."""
    return _classifier_from_jax(MLP, mlp_state_dict, hparams, params, state,
                                device, compute_dtype=compute_dtype)


def gru_from_jax(hparams: dict, params, state=None, device=None) -> GRU:
    """JAX GRU (hparams, params) -> the port's GRU."""
    return _classifier_from_jax(GRU, gru_state_dict, hparams, params, state,
                                device)


def mlp_embedding_from_jax(hparams: dict, params, state,
                           device=None) -> MLPEmbedding:
    """JAX MLPEmbedding (hparams, params, state) -> the port's."""
    return _classifier_from_jax(MLPEmbedding, mlp_embedding_state_dict,
                                hparams, params, state, device)


def _lists(tree):
    """A flax state-dict tree with its lists back ({'0': a, '1': b} ->
    [a, b]), as the models' parameter trees hold them."""
    if isinstance(tree, dict):
        if tree and all(k == str(i) for i, k in enumerate(tree)):
            return [_lists(tree[str(i)]) for i in range(len(tree))]
        return {k: _lists(v) for k, v in tree.items()}
    return tree


def _radam_leaves(tree):
    """The `scale_by_torch_radam` state ({count, mu, nu}) in a flax
    state-dict tree of the optax chain."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for v in tree.values():
            found = _radam_leaves(v)
            if found is not None:
                return found
    return None


def _like(counts, mu):
    """counts (one scalar a leaf) broadcast to mu's leaves' shapes."""
    if isinstance(counts, dict):
        return {k: _like(counts[k], mu[k]) for k in counts}
    if isinstance(counts, list):
        return [_like(c, m) for c, m in zip(counts, mu)]
    return np.full(np.shape(mu), int(np.asarray(counts)), np.float32)


def radam_state_from_jax(tx_state: dict, to_state_dict, opt,
                         schedule_step: int | None = None):
    """Carry a JAX run's RAdam state into the port's optimizer.

    tx_state: the state of the JAX package's `make_radam` chain (clip,
    masked decay, `scale_by_torch_radam`, scale) as the numpy tree that
    `flax.serialization.to_state_dict` gives; its per-leaf `mu`, `nu`
    and step counts are carried, the clip and the decay hold no state.
    to_state_dict(tree): the model's mapping of a parameter-shaped JAX
    tree to the port's state_dict keys (e.g. `functools.partial(
    bridge.mlp_state_dict, hparams, state=state)` with the tree as
    `params`), through which the moments take the parameters' layouts.
    opt: the port's `TrainOptimizer` over the model's parameters
    (`spec.init(model)`); its RAdam state is replaced: `exp_avg`,
    `exp_avg_sq` and `step` per parameter, none where the JAX count is 0
    (torch keeps no state for a parameter that never had a gradient).
    schedule_step: the learning-rate schedule's position (default: the
    largest count, the chain's optimizer steps).

    Returns `opt.state_dicts()`: the RAdam state_dict and the
    scheduler's, as a trainer's last checkpoint carries them."""
    leaves = _radam_leaves(tx_state)
    if leaves is None:
        raise ValueError("no scale_by_torch_radam state (count, mu, nu) "
                         "in the tree")
    mu, nu = _lists(leaves["mu"]), _lists(leaves["nu"])
    counts = _like(_lists(leaves["count"]), mu)
    sd_mu, sd_nu, sd_n = (to_state_dict(t) for t in (mu, nu, counts))
    torch_opt = opt.optimizer
    steps = 0
    for name, p in opt.named_params:
        if name not in sd_mu:
            raise KeyError(f"{name}: no moments in the JAX state")
        n = int(sd_n[name].reshape(-1)[0]) if sd_n[name].numel() else 0
        torch_opt.state.pop(p, None)
        if n > 0:
            torch_opt.state[p] = {
                "step": torch.tensor(float(n)),
                "exp_avg": sd_mu[name].to(p.device, p.dtype).reshape(p.shape),
                "exp_avg_sq": sd_nu[name].to(p.device,
                                             p.dtype).reshape(p.shape)}
        steps = max(steps, n)
    sched = opt.scheduler
    if sched is not None:
        step = steps if schedule_step is None else int(schedule_step)
        sched.last_epoch = step
        lrs = [base * fn(step)
               for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
        for group, lr in zip(torch_opt.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs
    return opt.state_dicts()


def qlinear_from_jax(q, device=None) -> QLinear:
    """A JAX QLinear ((in, out) int8) -> the port's ((out, in) int8)."""
    device = serving_device(device)
    w = torch.from_numpy(np.array(np.asarray(q.w_int8).T, order="C"))
    act = (None if q.act_scale is None else torch.tensor(
        np.float32(np.asarray(q.act_scale)), device=device))
    return QLinear(w.to(torch.int8).to(device), _t(q.scale).to(device),
                   None if q.bias is None else _t(q.bias).to(device), act)


def qparams_from_jax(qp, device=None) -> dict:
    """JAX quantize_transformer(...) output -> the port's qparams, with
    calibrated blocks packed once for the fused kernels (the full-block
    operands included) as the port's quantize_transformer packs them."""
    device = serving_device(device)

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


def qenc_from_jax(qenc, device=None) -> dict:
    """JAX quantize_encoder(...) output -> the port's qenc."""
    return {
        "blocks": [{k: qlinear_from_jax(blk[k], device) for k in ("c1", "c2")}
                   for blk in qenc["blocks"]],
        "sep": qlinear_from_jax(qenc["sep"], device),
    }


def artifact_from_jax(vq_hparams: dict, vq_params, vq_state,
                      tr_hparams: dict, tr_params, manifest: dict,
                      act_absmax: dict | None = None,
                      enc_absmax: dict | None = None, scaler=None,
                      device=None) -> WeldingQualityPipeline:
    """A JAX WeldingQualityPipeline's state -> the port's pipeline.

    vq_* / tr_*: the JAX models' hparams and numpy (or JAX) trees.
    manifest: the fields of the JAX pipeline's manifest.json (`n_cycles`,
    `max_batch`, `precision`, `encoder_precision`, `encoder_impl`,
    `start_token`, `monitor_saturation`, `saturation_threshold`).
    act_absmax / enc_absmax: the tables its `calibrate` measured
    (`_act_absmax`, `_enc_absmax`), from which the int8 tables are
    derived here as `load_artifact` derives them. scaler: an object with
    `mean_` and `scale_`, copied into the port's StandardScaler."""
    from .data.scaler import StandardScaler
    vq = vqvae_from_jax(vq_hparams, vq_params, vq_state, device=device)
    tr = transformer_from_jax(tr_hparams, tr_params, device=device)
    pipe = WeldingQualityPipeline(
        vq, tr, manifest["n_cycles"], max_batch=manifest["max_batch"],
        precision=manifest["precision"], start_token=manifest["start_token"],
        encoder_precision=manifest["encoder_precision"],
        encoder_impl=manifest["encoder_impl"],
        monitor_saturation=manifest.get("monitor_saturation", True))
    pipe.saturation_threshold = manifest.get(
        "saturation_threshold", WeldingQualityPipeline.saturation_threshold)
    if enc_absmax:
        pipe._set_encoder_calibration(
            {k: float(v) for k, v in enc_absmax.items()})
    if act_absmax:
        pipe._set_calibration({k: float(v) for k, v in act_absmax.items()})
    if scaler is not None:
        pipe.scaler = StandardScaler()
        pipe.scaler.mean_ = np.asarray(scaler.mean_, np.float64)
        pipe.scaler.scale_ = np.asarray(scaler.scale_, np.float64)
    return pipe


def ts2vec_state_dict(params) -> dict:
    """A JAX TS2Vec encoder's params (`ts_encoder_init`) under the
    reference's keys, which ts2vec/encoder.TSEncoder carries."""
    sd = {"input_fc.weight": _t(np.asarray(params["input_fc"]["w"]).T),
          "input_fc.bias": _t(params["input_fc"]["b"])}
    for i, blk in enumerate(params["blocks"]):
        pre = f"feature_extractor.net.{i}"
        for conv in ("conv1", "conv2"):
            sd[f"{pre}.{conv}.conv.weight"] = _t(blk[conv]["w"])
            sd[f"{pre}.{conv}.conv.bias"] = _t(blk[conv]["b"])
        if blk.get("projector") is not None:
            sd[f"{pre}.projector.weight"] = _t(blk["projector"]["w"])
            sd[f"{pre}.projector.bias"] = _t(blk["projector"]["b"])
    return sd


def ts2vec_from_jax(params, device=None):
    """A TSEncoder with a JAX TS2Vec encoder's weights, its widths read
    from their shapes, on `device` (the card when it is None)."""
    from .ts2vec.encoder import TSEncoder
    blocks = params["blocks"]
    input_dims, hidden = np.shape(params["input_fc"]["w"])
    enc = TSEncoder(int(input_dims), int(np.shape(blocks[-1]["conv1"]["w"])[0]),
                    int(hidden), len(blocks) - 1,
                    device=serving_device(device))
    _load(enc, ts2vec_state_dict(params))
    return enc
