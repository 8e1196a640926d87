"""The port's deployment path against the JAX package's, on the CPU:
checkpoints, reference Lightning files, artifacts, bf16 serving and the
CSV scorer.

Tolerances. f32 probs and logits against JAX: 1e-5 (two f32 stacks that
sum in other orders). int8 probs: 1e-3 with labels equal (the JAX int8
contract, as tests/test_torch_slice.py). bf16 serving: logits within 2%
of the largest f32 logit of the JAX bf16 transformer's (bf16 keeps 8
bits, 0.4% a rounding, and the two round LayerNorm and the products at
other places; measured 0.4% to 0.7%), and probs within 2e-4 (the small
model's class logits are of order 1e-2, so that is 2% again).
Everything the port saves and loads again is bit-equal. The scorer's
output file is compared with the JAX scorer's line by line: run keys,
start cycles and labels as text, the two probabilities (printed to 6
places) as numbers to 1e-5, since the last printed digit of an f32 prob
may differ between the two frameworks.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.cli import score_quality as jscore
from vq_vae_transformer_arc_welding_tpu.data.scaler import (
    StandardScaler as JaxScaler)
from vq_vae_transformer_arc_welding_tpu.serve import (
    WeldingQualityPipeline as JaxPipeline)
from vq_vae_transformer_arc_welding_tpu.train import torch_import as jimport
from vq_vae_transformer_arc_welding_tpu_torch import bridge, entry
from vq_vae_transformer_arc_welding_tpu_torch.cli import score_quality, shared
from vq_vae_transformer_arc_welding_tpu_torch.data import asimow, synthetic
from vq_vae_transformer_arc_welding_tpu_torch.models import (
    TransformerDecoder, VQVAEPatch)
from vq_vae_transformer_arc_welding_tpu_torch.serve import (
    WeldingQualityPipeline)
from vq_vae_transformer_arc_welding_tpu_torch.train import (
    checkpoint, torch_import)

import torch_port_helpers as H

JSON_FILES = ("manifest.json", "calibration.json", "scaler.json")


def _jax_pipeline(precision="f32", batch_norm=False, **kw):
    jm, params, state = H.jax_vqvae(batch_norm)
    tm, tp = H.jax_transformer()
    return JaxPipeline((jm, params, state), (tm, tp), n_cycles=H.N_CYCLES,
                       max_batch=4, precision=precision, **kw)


def _port_of(jp, **kw) -> WeldingQualityPipeline:
    """A JAX pipeline through bridge.artifact_from_jax, on the CPU."""
    manifest = dict(
        n_cycles=jp.n_cycles, max_batch=jp.max_batch, precision=jp.precision,
        encoder_precision=jp.encoder_precision, encoder_impl=jp.encoder_impl,
        start_token=jp.start_token, monitor_saturation=jp.monitor_saturation,
        saturation_threshold=jp.saturation_threshold)
    return bridge.artifact_from_jax(
        jp.vq_model.hparams, jp.vq_params, jp.vq_state, jp.tr_model.hparams,
        jp.tr_params, manifest, act_absmax=getattr(jp, "_act_absmax", None),
        enc_absmax=getattr(jp, "_enc_absmax", None), scaler=jp.scaler,
        device="cpu", **kw)


def _equal_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _equal_qlinear(a, b):
    assert torch.equal(a.w_int8, b.w_int8) and torch.equal(a.scale, b.scale)
    for u, v in ((a.bias, b.bias), (a.act_scale, b.act_scale)):
        assert (u is None) == (v is None)
        assert u is None or torch.equal(u, v)


# -- checkpoints ---------------------------------------------------------------

@pytest.mark.parametrize("batch_norm", [False, True])
def test_vqvae_checkpoint_round_trip(tmp_path, batch_norm):
    vq = H.port_vqvae(batch_norm, vq_impl="pallas")
    path = str(tmp_path / "sub" / "vq.ckpt")
    vq.save(path, extra={"epoch": 3})
    assert os.listdir(tmp_path / "sub") == ["vq.ckpt"]    # no temporary left
    back = VQVAEPatch.load(path, device="cpu")
    _equal_state(vq, back)
    assert back.hparams == vq.hparams and not back.training
    # runtime options are not hparams: the default unless given again
    assert "vq_impl" not in back.hparams and back.vq_impl == "xla"
    assert VQVAEPatch.load(path, device="cpu",
                           vq_impl="pallas").vq_impl == "pallas"
    name, hparams, sd, extra = checkpoint.load_checkpoint(path)
    assert (name, extra) == ("VQVAEPatch", {"epoch": 3})
    x = torch.from_numpy(H.windows(2, seed=3).reshape(-1, 200, 2))
    with torch.no_grad():
        assert torch.equal(back.encode_indices(x), vq.encode_indices(x))


def test_transformer_checkpoint_round_trip(tmp_path):
    tr = H.port_transformer()
    tr.compute_dtype = torch.bfloat16
    path = str(tmp_path / "tr.ckpt")
    tr.save(path)
    tr.compute_dtype = None
    back = TransformerDecoder.load(path, device="cpu")
    _equal_state(tr, back)
    assert back.hparams == tr.hparams and back.compute_dtype is None
    assert "attention_impl" not in back.hparams
    ids = torch.from_numpy(H.token_ids(3, seed=1))
    with torch.no_grad():
        assert torch.equal(back.apply(ids), tr.apply(ids))


def test_checkpoint_refuses_what_it_should(tmp_path):
    vq_path, tr_path = str(tmp_path / "vq.ckpt"), str(tmp_path / "tr.ckpt")
    H.port_vqvae(False).save(vq_path)
    H.port_transformer().save(tr_path)
    with pytest.raises(ValueError, match="is for VQVAEPatch, not Transformer"):
        TransformerDecoder.load(vq_path, device="cpu")
    with pytest.raises(ValueError, match="is for TransformerDecoder"):
        VQVAEPatch.load(tr_path, device="cpu")
    payload = torch.load(vq_path, weights_only=True)
    newer = str(tmp_path / "newer.ckpt")
    torch.save({**payload, "format_version": 99}, newer)
    with pytest.raises(ValueError, match="newer"):
        VQVAEPatch.load(newer, device="cpu")
    extra_key = str(tmp_path / "extra.ckpt")
    torch.save({**payload, "state_dict": {**payload["state_dict"],
                                          "surprise.weight": torch.ones(1)}},
               extra_key)
    with pytest.raises(KeyError, match="surprise.weight"):
        VQVAEPatch.load(extra_key, device="cpu")
    missing = dict(payload["state_dict"])
    del missing["patch_embed.proj.bias"]
    torch.save({**payload, "state_dict": missing}, extra_key)
    with pytest.raises(KeyError, match="patch_embed.proj.bias"):
        VQVAEPatch.load(extra_key, device="cpu")
    junk = str(tmp_path / "junk.ckpt")
    torch.save([1, 2, 3], junk)
    with pytest.raises(ValueError, match="not a checkpoint"):
        VQVAEPatch.load(junk, device="cpu")
    # a Lightning file is not this package's format
    lightning = str(tmp_path / "lightning.ckpt")
    torch.save({"state_dict": payload["state_dict"],
                "hyper_parameters": payload["hyper_parameters"]}, lightning)
    with pytest.raises(ValueError, match="not a checkpoint of this package"):
        VQVAEPatch.load(lightning, device="cpu")


def test_loading_without_a_device_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    pipe = _port_of(_jax_pipeline())
    art = pipe.save_artifact(str(tmp_path / "art"))
    for call in (
            lambda: VQVAEPatch.load(os.path.join(art, "vqvae.ckpt")),
            lambda: WeldingQualityPipeline.load_artifact(art),
            lambda: WeldingQualityPipeline.from_checkpoints(
                os.path.join(art, "vqvae.ckpt"),
                os.path.join(art, "transformer.ckpt"), n_cycles=H.N_CYCLES)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()


# -- reference Lightning checkpoints --------------------------------------------

@pytest.mark.parametrize("batch_norm", [False, True])
def test_from_checkpoints_reads_lightning_files(tmp_path, batch_norm):
    """Files written by the JAX package's exporters in the reference
    layout: ids equal the JAX encoder's, logits to 1e-5."""
    jm, params, state = H.jax_vqvae(batch_norm)
    tm, tp = H.jax_transformer()
    vq_path = jimport.export_vqvae_to_lightning(
        jm, params, state, str(tmp_path / "vq.ckpt"))
    tr_path = jimport.export_transformer_to_lightning(
        tm, tp, str(tmp_path / "tr.ckpt"))
    pipe = WeldingQualityPipeline.from_checkpoints(
        vq_path, tr_path, n_cycles=H.N_CYCLES, max_batch=4, device="cpu")
    assert pipe.vq_model.hparams == {k: jm.hparams[k]
                                     for k in pipe.vq_model.hparams}
    _equal_state(pipe.vq_model, H.port_vqvae(batch_norm))
    _equal_state(pipe.tr_model, H.port_transformer())
    x = H.windows(5, seed=21)
    jp = _jax_pipeline(batch_norm=batch_norm)
    np.testing.assert_array_equal(pipe.encode_tokens(x), jp.encode_tokens(x))
    ids = H.token_ids(3, seed=2)
    ref, _ = tm.apply(tp, None, jnp.asarray(ids), generate=False)
    with torch.no_grad():
        logits = pipe.tr_model.apply(torch.from_numpy(ids), generate=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    labels, probs = pipe.classify(x)
    ref_labels, ref_probs = jp.classify(x)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, ref_labels)
    # told apart by content: the port's own files through the same door
    pipe.vq_model.save(vq_path)
    _equal_state(shared.load_vqvae_any(vq_path, device="cpu"), pipe.vq_model)


def test_lightning_reader_names_what_it_skips(tmp_path):
    jm, params, state = H.jax_vqvae(False)
    tm, tp = H.jax_transformer()
    vq_path = jimport.export_vqvae_to_lightning(
        jm, params, state, str(tmp_path / "vq.ckpt"))
    tr_path = jimport.export_transformer_to_lightning(
        tm, tp, str(tmp_path / "tr.ckpt"))
    ckpt = torch.load(vq_path, weights_only=True)
    # the VQ-VAE loads whole: every key of the file, the decoder's and
    # the inverse patch embedding's included, is one of the model's
    loaded = torch_import.load_vqvae_checkpoint(vq_path, device="cpu")
    assert set(loaded.state_dict()) == set(ckpt["state_dict"])
    assert any(k.startswith("decoder.1.shared_conv") for k in ckpt["state_dict"])
    assert any(k.startswith("reverse_patch_embed.") for k in ckpt["state_dict"])
    for k, v in ckpt["state_dict"].items():
        assert torch.equal(loaded.state_dict()[k], v), k
    masks =[k for k in torch.load(tr_path, weights_only=True)["state_dict"]
             if torch_import.TRANSFORMER_MASK_KEYS.match(k)]
    assert masks == [f"transformer.h.{i}.attn.bias" for i in range(2)]

    bad = str(tmp_path / "bad.ckpt")
    torch.save({**ckpt, "state_dict": {**ckpt["state_dict"],
                                       "encoder.2.weight": torch.ones(1)}},
               bad)
    with pytest.raises(KeyError, match="encoder.2.weight"):
        torch_import.load_vqvae_checkpoint(bad, device="cpu")
    sd = dict(ckpt["state_dict"])
    del sd["encoder.1.shared_conv.bias"]
    torch.save({**ckpt, "state_dict": sd}, bad)
    with pytest.raises(KeyError, match="encoder.1.shared_conv.bias"):
        shared.load_vqvae_any(bad, device="cpu")
    sd = dict(ckpt["state_dict"])
    sd["vector_quantization.vq.layers.0._codebook.embed"] = sd.pop(
        "vector_quantization.embedding.weight")[None]
    torch.save({**ckpt, "state_dict": sd}, bad)
    # an EMA codebook without its EMA statistics: the EMA VQ-VAE the
    # file asks for is built, and the reader names the keys it lacks
    with pytest.raises(KeyError, match="_codebook.cluster_size"):
        shared.load_vqvae_any(bad, device="cpu")


# -- artifacts -------------------------------------------------------------------

def _json_of(art):
    return {name: json.load(open(os.path.join(art, name)))
            for name in JSON_FILES if os.path.exists(os.path.join(art, name))}


def test_artifact_f32_round_trip_against_jax(tmp_path, rng):
    jp = _jax_pipeline(encoder_impl="fused")
    vi = rng.standard_normal((40, 200, 2)) * [3.0, 40.0] + [20.0, 100.0]
    jp.scaler = JaxScaler().fit(vi.astype(np.float32))
    jart = jp.save_artifact(str(tmp_path / "jax"))
    pipe = _port_of(jp)
    art = pipe.save_artifact(str(tmp_path / "port"))
    assert sorted(os.listdir(art)) == sorted(
        JSON_FILES + ("vqvae.ckpt", "transformer.ckpt"))
    assert _json_of(art) == _json_of(jart)
    back = WeldingQualityPipeline.load_artifact(art, device="cpu")
    _equal_state(back.vq_model, pipe.vq_model)
    _equal_state(back.tr_model, pipe.tr_model)
    for attr in ("n_cycles", "max_batch", "precision", "encoder_precision",
                 "encoder_impl", "start_token", "monitor_saturation",
                 "saturation_threshold"):
        assert getattr(back, attr) == getattr(pipe, attr) == getattr(jp, attr)
    np.testing.assert_array_equal(back.scaler.mean_, jp.scaler.mean_)
    np.testing.assert_array_equal(back.scaler.scale_, jp.scaler.scale_)
    x = H.windows(5, seed=31)
    labels, probs = pipe.classify(x)
    labels2, probs2 = back.classify(x)
    np.testing.assert_array_equal(probs2, probs)            # bit-equal
    np.testing.assert_array_equal(labels2, labels)
    ref_labels, ref_probs = jp.classify(x)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, ref_labels)
    wide = WeldingQualityPipeline.load_artifact(art, max_batch=16,
                                                device="cpu")
    assert wide.max_batch == 16
    np.testing.assert_array_equal(wide.classify(x)[1], probs)


@pytest.mark.parametrize("encoder_precision", ["f32", "int8"])
def test_artifact_int8_round_trip_without_calibration(tmp_path,
                                                      encoder_precision):
    """The absmax tables travel, the int8 tables are derived again at
    load, bit-equal, and no calibration window is needed."""
    jp = _jax_pipeline("int8", encoder_impl="fused",
                       encoder_precision=encoder_precision)
    jp.calibrate(H.windows(6, seed=4))
    jart = jp.save_artifact(str(tmp_path / "jax"))
    pipe = _port_of(jp)
    art = pipe.save_artifact(str(tmp_path / "port"))
    assert _json_of(art) == _json_of(jart)
    assert "scaler.json" not in _json_of(art)
    back = WeldingQualityPipeline.load_artifact(art, device="cpu")
    assert back._act_absmax == pipe._act_absmax == jp._act_absmax
    for blk, ref in zip(back.qparams["blocks"], pipe.qparams["blocks"]):
        for k in ("c_attn", "c_proj", "c_fc", "m_proj"):
            _equal_qlinear(blk[k], ref[k])
        for u, v in zip(blk["block_operands"], ref["block_operands"]):
            assert torch.equal(u, v)
    _equal_qlinear(back.qparams["lm_head"], pipe.qparams["lm_head"])
    if encoder_precision == "int8":
        assert back._enc_absmax == jp._enc_absmax
        _equal_qlinear(back.qenc["sep"], pipe.qenc["sep"])
        for blk, ref in zip(back.qenc["blocks"], pipe.qenc["blocks"]):
            _equal_qlinear(blk["c1"], ref["c1"])
    else:
        assert back.qenc is None and back._enc_absmax is None
    x = H.windows(5, seed=32)
    labels, probs = pipe.classify(x)
    labels2, probs2 = back.classify(x)
    np.testing.assert_array_equal(probs2, probs)
    np.testing.assert_array_equal(labels2, labels)
    assert back.last_saturation_rate == pipe.last_saturation_rate
    ref_labels, ref_probs = jp.classify(x)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(labels, ref_labels)
    # the port's own calibrate keeps the tables an artifact needs
    own = WeldingQualityPipeline(
        pipe.vq_model, pipe.tr_model, H.N_CYCLES, max_batch=4,
        precision="int8", encoder_precision=encoder_precision)
    am = own.calibrate(H.windows(6, seed=4))
    assert own._act_absmax == am
    assert (own._enc_absmax is not None) == (encoder_precision == "int8")
    own.save_artifact(str(tmp_path / "own"))
    again = WeldingQualityPipeline.load_artifact(str(tmp_path / "own"),
                                                 device="cpu")
    np.testing.assert_array_equal(again.classify(x)[1], own.classify(x)[1])


def test_artifact_guards(tmp_path):
    pipe = _port_of(_jax_pipeline("int8"))
    with pytest.raises(RuntimeError, match="calibrate"):
        pipe.classify(H.windows(1))
    art = pipe.save_artifact(str(tmp_path / "art"))
    manifest = json.load(open(os.path.join(art, "manifest.json")))
    assert manifest["calibrated"] is False
    assert json.load(open(os.path.join(art, "calibration.json"))) == {
        "act_absmax": None, "enc_absmax": None}

    def rewrite(**changes):
        with open(os.path.join(art, "manifest.json"), "w") as f:
            json.dump({**manifest, **changes}, f)

    rewrite(artifact_version=WeldingQualityPipeline.ARTIFACT_VERSION + 1)
    with pytest.raises(ValueError, match="newer than this build"):
        WeldingQualityPipeline.load_artifact(art, device="cpu")
    rewrite(calibrated=True)
    with pytest.raises(ValueError, match="no act_absmax"):
        WeldingQualityPipeline.load_artifact(art, device="cpu")
    rewrite(encoder_calibrated=True)
    with pytest.raises(ValueError, match="no enc_absmax"):
        WeldingQualityPipeline.load_artifact(art, device="cpu")
    rewrite()
    vq, tr = (os.path.join(art, n) for n in ("vqvae.ckpt",
                                             "transformer.ckpt"))
    shutil.copy(tr, vq)                  # the wrong model under the name
    with pytest.raises(ValueError, match="is for TransformerDecoder, not "
                                         "VQVAEPatch"):
        WeldingQualityPipeline.load_artifact(art, device="cpu")


# -- bf16 serving ------------------------------------------------------------------

@pytest.mark.parametrize("generate", [False, True])
def test_bf16_transformer_matches_jax(generate):
    tm, tp = H.jax_transformer()
    ids = H.token_ids(6, seed=5)
    tm.compute_dtype = jnp.bfloat16
    try:
        ref, _ = tm.apply(tp, None, jnp.asarray(ids), generate=generate)
    finally:
        tm.compute_dtype = None
    f32_ref, _ = tm.apply(tp, None, jnp.asarray(ids), generate=generate)
    tr = H.port_transformer()
    tr.compute_dtype = torch.bfloat16
    with torch.no_grad():
        out = tr.apply(torch.from_numpy(ids), generate=generate)
        hidden = tr.backbone(torch.from_numpy(ids))
    assert out.dtype == torch.float32 and hidden.dtype == torch.bfloat16
    assert np.asarray(ref).dtype == np.float32
    scale = float(np.abs(np.asarray(f32_ref)).max())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-2 * scale)
    # bf16 for real, and no further from f32 than JAX's bf16 is, twice over
    d_port = np.abs(out.numpy() - np.asarray(f32_ref)).max()
    d_jax = np.abs(np.asarray(ref) - np.asarray(f32_ref)).max()
    assert 1e-3 * scale < d_port < 2 * d_jax + 5e-3 * scale
    # the f32 parameters are untouched
    assert all(p.dtype == torch.float32 for p in tr.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        TransformerDecoder(d_model=32, n_head=4, compute_dtype=torch.float16,
                           device="cpu")


def test_bf16_serving_matches_jax():
    x = H.windows(6, seed=41)
    jp = _jax_pipeline("bf16")
    try:
        ref_labels, ref_probs = jp.classify(x)
    finally:
        jp.tr_model.compute_dtype = None       # the helper's model is shared
    f32_labels, f32_probs = _jax_pipeline().classify(x)
    pipe = WeldingQualityPipeline(H.port_vqvae(False), H.port_transformer(),
                                  n_cycles=H.N_CYCLES, max_batch=4,
                                  precision="bf16")
    assert pipe.tr_model.compute_dtype == torch.bfloat16
    labels, probs = pipe.classify(x)
    assert probs.dtype == np.float32
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=2e-4)
    np.testing.assert_allclose(probs, f32_probs, rtol=0, atol=2e-4)
    assert not np.array_equal(probs, f32_probs)
    sure = np.abs(f32_probs[:, 0] - f32_probs[:, 1]) > 8e-4
    np.testing.assert_array_equal(labels[sure], f32_labels[sure])
    # the tokens do not depend on the transformer's precision
    np.testing.assert_array_equal(pipe.encode_tokens(x), jp.encode_tokens(x))
    with pytest.raises(ValueError, match="precision"):
        WeldingQualityPipeline(pipe.vq_model, pipe.tr_model, 2,
                               precision="fp8")


def test_bf16_artifact_round_trip(tmp_path):
    pipe = _port_of(_jax_pipeline("bf16"))
    H.jax_transformer()[0].compute_dtype = None
    back = WeldingQualityPipeline.load_artifact(
        pipe.save_artifact(str(tmp_path / "art")), device="cpu")
    assert back.precision == "bf16"
    assert back.tr_model.compute_dtype == torch.bfloat16
    x = H.windows(3, seed=42)
    np.testing.assert_array_equal(back.classify(x)[1], pipe.classify(x)[1])


# -- the bf16 encoder in the int8 pipeline ---------------------------------------

def test_make_pipeline_quantized_bf16_encoder_matches_jax():
    """entry.make_pipeline_quantized(encoder_dtype=) against the JAX entry
    on bridged weights and scales: where the two bf16 encoders give the
    same ids the logits agree to 1e-3 (the int8 contract); at most 1% of
    the ids may differ (near-ties, see tests/test_torch_kernels.py)."""
    import __graft_entry__ as graft
    jp = _jax_pipeline("int8", encoder_impl="fused")
    jp.calibrate(H.windows(6, seed=4))
    x = H.windows(4, seed=43)
    old = graft.N_CYCLES
    graft.N_CYCLES = H.N_CYCLES
    try:
        ref = np.asarray(graft.make_pipeline_quantized(
            jp.vq_model, jp.tr_model, jp.qparams,
            encoder_dtype=jnp.bfloat16)(jp.vq_params, jp.vq_state,
                                        jnp.asarray(x)))
    finally:
        graft.N_CYCLES = old
    from vq_vae_transformer_arc_welding_tpu.ops.pallas_encoder import (
        encode_indices_fused as jax_encode)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_encoder as fenc)
    vq, tr = H.port_vqvae(False), H.port_transformer()
    qparams = H.port_qparams(jp.qparams)
    fn = entry.make_pipeline_quantized(vq, tr, qparams,
                                       encoder_dtype=torch.bfloat16)
    out = fn(torch.from_numpy(x)).numpy()
    assert out.shape == (4, 2) and out.dtype == np.float32
    cycles = x.reshape(-1, 200, 2)
    jids = np.asarray(jax_encode(jp.vq_model, jp.vq_params, jp.vq_state,
                                 jnp.asarray(cycles),
                                 compute_dtype=jnp.bfloat16)).reshape(4, -1)
    with torch.no_grad():
        ids = fenc.encode_indices_fused(
            vq, fenc.pack_encoder(vq, torch.bfloat16),
            torch.from_numpy(cycles),
            compute_dtype=torch.bfloat16).numpy().reshape(4, -1)
    assert (ids != jids).mean() <= 0.01
    same = (ids == jids).all(axis=1)
    assert same.any()
    np.testing.assert_allclose(out[same], ref[same], rtol=0, atol=1e-3)
    f32 = entry.make_pipeline_quantized(vq, tr, qparams)(
        torch.from_numpy(x)).numpy()
    assert np.abs(out - f32).max() < 1e-1


# -- the scorer ----------------------------------------------------------------------

def _scores(path):
    lines = open(path).read().strip().split("\n")
    return lines[0], [ln.split(",") for ln in lines[1:]]


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_scorer_output_equals_the_jax_scorers(tmp_path, precision):
    """The tiny size of tests/test_cli.py's scorer test: 16 runs of 8
    cycles, 2-cycle windows, the scaler from the artifact."""
    csv = str(tmp_path / "prod.csv")
    synthetic.write_synthetic_csv(csv, n_cycles_per_run=8,
                                  extra_train_runs=0, seed=3)
    vi, _, exp, run = asimow.load_asimow_csv(csv)
    jp = _jax_pipeline(precision, encoder_impl="fused")
    jp.scaler = JaxScaler().fit(vi)
    if precision == "int8":
        jp.calibrate(jp.scaler.transform(vi[:12]).reshape(6, 400, 2))
    jart = jp.save_artifact(str(tmp_path / "jax"))
    art = _port_of(jp).save_artifact(str(tmp_path / "port"))
    n_groups = np.unique(np.stack([exp, run], axis=1), axis=0).shape[0]
    assert n_groups > np.unique(run).shape[0]    # run ids repeat across exps

    for extra, per_run in (([], 4), (["--stride", "1"], 7)):
        ref_out, out = str(tmp_path / "ref.csv"), str(tmp_path / "out.csv")
        jscore.main(jscore.build_parser().parse_args(
            ["--artifact", jart, "--data-path", csv, "--out", ref_out,
             *extra]))
        args = score_quality.build_parser().parse_args(
            ["--artifact", art, "--data-path", csv, "--out", out,
             "--device", "cpu", *extra])
        assert score_quality.main(args) == out
        (head, rows), (ref_head, ref_rows) = _scores(out), _scores(ref_out)
        assert head == ref_head == \
            "experiment,welding_run,start_cycle,label,p_bad,p_good"
        assert len(rows) == len(ref_rows) == per_run * n_groups
        tol = 1e-5 if precision == "f32" else 1e-3
        for r, ref in zip(rows, ref_rows):
            assert r[:3] == ref[:3]
            assert len(r[4].split(".")[1]) == 6          # the row format
            assert abs(float(r[4]) + float(r[5]) - 1.0) < 1e-4
            np.testing.assert_allclose([float(r[4]), float(r[5])],
                                       [float(ref[4]), float(ref[5])],
                                       rtol=0, atol=tol)
            if abs(float(ref[4]) - float(ref[5])) > 2 * tol:
                assert r[3] == ref[3]
    # a tiny --chunk forces several flushes: the same file
    out2 = str(tmp_path / "chunked.csv")
    score_quality.main(score_quality.build_parser().parse_args(
        ["--artifact", art, "--data-path", csv, "--out", out2, "--stride",
         "1", "--chunk", "3", "--device", "cpu", "--max-batch", "2"]))
    assert open(out2).read() == open(out).read()
    # --no-scaler scores the raw values: other numbers, the same rows
    score_quality.main(score_quality.build_parser().parse_args(
        ["--artifact", art, "--data-path", csv, "--out", out2, "--stride",
         "1", "--no-scaler", "--device", "cpu"]))
    assert [r[:3] for r in _scores(out2)[1]] == [r[:3] for r in rows]
    assert open(out2).read() != open(out).read()


def test_scorer_refuses_runs_shorter_than_a_window(tmp_path):
    csv = str(tmp_path / "short.csv")
    synthetic.write_synthetic_csv(csv, n_cycles_per_run=1,
                                  extra_train_runs=0, seed=3)
    art = _port_of(_jax_pipeline()).save_artifact(str(tmp_path / "art"))
    out = str(tmp_path / "none.csv")
    with pytest.raises(SystemExit, match="no complete windows"):
        score_quality.main(score_quality.build_parser().parse_args(
            ["--artifact", art, "--data-path", csv, "--out", out,
             "--device", "cpu"]))
    assert not os.path.exists(out)
    with pytest.raises(ValueError, match="stride"):
        score_quality.main(score_quality.build_parser().parse_args(
            ["--artifact", art, "--data-path", csv, "--out", out,
             "--device", "cpu", "--stride", "-1"]))
