"""The port's parallel/ on the CPU: gloo ranks against one process, the
JAX package's mesh runs and its dense functions.

One spawn of 4 gloo ranks (parallel/launch.py) runs every multi-rank
job (parallel/jobs.py), each laid out as the mesh it needs; the tests
read its results. The JAX side runs on the 8 virtual CPU devices of
tests/conftest.py. Weights cross through `bridge.*_from_jax`, inputs
come from numpy seeds, and there is no dropout where a bound is
claimed.

- Data parallel `Trainer` (MLP, 2 epochs, full batch of 64 over 4
  ranks): against the port in one process, epoch-1 loss within 1e-6 and
  parameters within rtol 1e-5; against the JAX mesh run (4 devices),
  the Trainer contract of tests/test_torch_trainer.py.
- Data parallel VQ-VAE with the EMA VQ and BatchNorm (batch 16 over 4):
  codebook and cluster sizes equal on every rank and within 1e-5 of one
  process; the explicit-group `quantize_ema(group=)` against JAX's
  `shard_map(axis_name=)` on 4 devices with the same handed draws.
- Tensor parallel (d32, 4 heads, 4 ways) forward against JAX's dense
  forward, 1e-5; a 2 x 2 data x tensor step against the dense step:
  loss 1e-6, gradients 1e-5.
- Dropout under 2 x 2 data x tensor parallelism: the step against the
  dense step with the same generator, loss 1e-6, gradients 1e-5.
- Pipeline (4 stages, 2 microbatches; and 2 x 2 data x pipe): both
  heads against JAX's dense forward 1e-5, gradients against the dense
  backward 1e-5; with dropout, against the microbatched dense step
  drawing each (microbatch, block)'s masks from its own generator;
  `PipelinedDecoder` in the Trainer lands on the dense weights; its
  checkpoint loads dense.
- Ring attention over 4 ranks against the dense causal core, 1e-5; a T
  the ring does not divide raises AssertionError.
- Sharded checkpoints: the EMA state round trip; TP shards back as
  shards, and dense in one process; a one-process save loads through
  the same dense template.
- Evaluation on a mesh: every rank logs the one process's validation
  metrics.
- Mesh serving over 4 CPU replicas against the mesh-less pipeline, f32
  and calibrated int8, ragged batches; `load_artifact(mesh=)`.
- The CLI's mesh refusal as JAX's; `dryrun_multichip(4, "cpu")`.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.data.datasets import (
    ArraySplit as JaxArraySplit)
from vq_vae_transformer_arc_welding_tpu.models import MLP as JaxMLP
from vq_vae_transformer_arc_welding_tpu.models import (
    TransformerDecoder as JaxTransformer)
from vq_vae_transformer_arc_welding_tpu.ops.attention import (
    causal_attention_core as jax_causal_core)
from vq_vae_transformer_arc_welding_tpu.parallel import make_mesh as jax_mesh
from vq_vae_transformer_arc_welding_tpu.train.loop import Trainer as JaxTrainer
from vq_vae_transformer_arc_welding_tpu.train.optim import (
    make_radam as jax_make_radam)
from vq_vae_transformer_arc_welding_tpu.train.tasks import (
    ClassificationTask as JaxClassificationTask)
from vq_vae_transformer_arc_welding_tpu_torch import bridge
from vq_vae_transformer_arc_welding_tpu_torch.models import (
    TransformerDecoder, VQVAEPatch)
from vq_vae_transformer_arc_welding_tpu_torch.ops.vq_ema import EMAState
from vq_vae_transformer_arc_welding_tpu_torch.parallel import jobs, launch
from vq_vae_transformer_arc_welding_tpu_torch.parallel.mesh import make_mesh
from vq_vae_transformer_arc_welding_tpu_torch.parallel.pipeline import (
    PipelinedDecoder)
from vq_vae_transformer_arc_welding_tpu_torch.serve import (
    WeldingQualityPipeline)
from vq_vae_transformer_arc_welding_tpu_torch.train.checkpoint import (
    dense_view, load_checkpoint_sharded, model_state_dict,
    save_checkpoint_sharded)

CPU = torch.device("cpu")
DATA4, MODEL4, PIPE4 = (((4, 1), ("data", "model")), ((1, 4), ("data", "model")),
                        ((1, 4), ("data", "pipe")))
DP_TP, DP_PP = ((2, 2), ("data", "model")), ((2, 2), ("data", "pipe"))
EMA_K, EMA_D = 8, 4


@pytest.fixture(autouse=True)
def one_thread():
    """This process on one thread, as the ranks run: the one-process
    references then sum as a rank does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the inputs, each from a seed ------------------------------------------------

@functools.cache
def mlp_case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8, 2)).astype(np.float32)
    y = (x.sum((1, 2)) > 0).astype(np.int64)
    jm = JaxMLP(input_size=8, output_size=2, in_dim=2, hidden_sizes=16,
                n_hidden_layers=1, dropout_p=0.0, learning_rate=1e-2)
    params, state = jm.init(0)
    port = bridge.mlp_from_jax(jm.hparams, params, state, device="cpu")
    fit = dict(spec=jobs.model_spec(port), task="classification",
               data=dict(x=x, y=y, val_rows=64), batch_size=64, epochs=2,
               seed=3, lr=1e-2)
    return jm, params, state, x, y, fit


@functools.cache
def vq_case():
    vq = VQVAEPatch(hidden_dim=16, input_dim=2, num_embeddings=EMA_K,
                    embedding_dim=EMA_D, n_resblocks=1, learning_rate=1e-3,
                    batch_norm=True, use_improved_vq=True, kmeans_iters=2,
                    dropout_p=0.0, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    x = np.random.default_rng(1).standard_normal((64, 200, 2)).astype(
        np.float32)
    return dict(spec=jobs.model_spec(vq), task="reconstruction",
                data=dict(x=x), batch_size=16, epochs=2, seed=5, lr=1e-3)


@functools.cache
def transformer_case(n_blocks: int = 2, res_dropout: float = 0.0):
    jt = JaxTransformer(d_model=32, n_classes=20, seq_len=9,
                        n_blocks=n_blocks, n_head=4, res_dropout=res_dropout)
    params, _ = jt.init(0)
    port = bridge.transformer_from_jax(jt.hparams, params, device="cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 20, (8, 9))
    labels = rng.integers(0, 20, (8, 9))
    return jt, params, port, jobs.model_spec(port), ids, labels


@functools.cache
def ema_case():
    """z split over 4 devices, and the draws JAX's quantize_ema makes
    from PRNGKey(0) on each device (the same indices into each
    device's 16 x 6 rows)."""
    z = np.random.default_rng(3).standard_normal((64, 6, EMA_D)).astype(
        np.float32)
    r_init, r_expire = jax.random.split(jax.random.PRNGKey(0))
    n_local = 16 * 6
    draws = tuple(np.asarray(jax.random.randint(r, (EMA_K,), 0, n_local))
                  for r in (r_init, r_expire))
    return z, draws


@functools.cache
def pp_fit_case():
    _, _, _, spec, _, _ = transformer_case(4)
    rng = np.random.default_rng(4)
    data = dict(x=rng.integers(0, 20, (32, 9)), y=rng.integers(0, 20, (32, 9)),
                cond=rng.integers(0, 2, (32,)))
    return dict(spec=spec, task="gen", data=data, batch_size=8, epochs=1,
                seed=5, optimizer="transformer")


def dropout_spec():
    """The 2-block case with dropout on the residuals and the
    attention's probabilities."""
    _, _, _, spec, _, _ = transformer_case(2)
    return dict(spec, hparams={**spec["hparams"], "res_dropout": 0.2,
                               "att_dropout": 0.2})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank job, on one spawn of 4 gloo ranks: rank r's
    results, r = 0..3."""
    tmp = tmp_path_factory.mktemp("parallel")
    _, _, _, spec2, ids, labels = transformer_case(2)
    _, _, _, spec4, _, _ = transformer_case(4)
    _, _, _, spec_drop, _, _ = transformer_case(4, 0.2)
    z, draws = ema_case()
    q, k, v = (np.random.default_rng(5 + i).standard_normal(
        (2, 3, 64, 16)).astype(np.float32) for i in range(3))
    todo = [
        ("mlp", "fit", dict(mlp_case()[-1], layout=DATA4)),
        ("vq", "fit", dict(vq_case(), layout=DATA4)),
        ("ema_axis", "ema_axis", dict(z=z, k=EMA_K, draws=[draws] * 4,
                                      layout=DATA4)),
        ("tp", "tp_step", dict(spec=spec2, ids=ids, labels=labels,
                               layout=MODEL4)),
        ("dp_tp", "tp_step", dict(spec=spec2, ids=ids, labels=labels,
                                  layout=DP_TP)),
        ("pp", "pp_step", dict(spec=spec4, ids=ids, labels=labels, n_micro=2,
                               layout=PIPE4)),
        ("dp_pp", "pp_step", dict(spec=spec4, ids=ids, labels=labels,
                                  n_micro=2, data_axis="data", layout=DP_PP)),
        ("dp_tp_dropout", "tp_step", dict(spec=dropout_spec(), ids=ids,
                                          labels=labels, train=True,
                                          layout=DP_TP)),
        ("pp_dropout", "pp_step", dict(spec=spec_drop, ids=ids,
                                       labels=labels, n_micro=2, train=True,
                                       layout=PIPE4)),
        ("pp_fit", "fit", dict(pp_fit_case(), pipeline=2, layout=DP_PP)),
        ("ring", "ring", dict(q=q, k=k, v=v, layout=MODEL4)),
        ("ring_raises", "ring_raises", dict(t=62, layout=MODEL4)),
        ("ckpt", "sharded_checkpoint", dict(spec=spec2,
                                            path=str(tmp / "tp_ck"),
                                            layout=DP_TP)),
    ]
    res = launch.run(jobs.run_jobs, make_mesh(4, 1, devices=[CPU] * 4), todo,
                     timeout=600)
    return res, (q, k, v), str(tmp / "tp_ck")


def _metrics(history):
    """A history (or one epoch's row) without its wall times and rates."""
    if isinstance(history, list):
        return [_metrics(h) for h in history]
    return {k: v for k, v in history.items()
            if not (k.endswith("time_s") or k.endswith("_per_s"))}


# -- data parallel -----------------------------------------------------------------


def _jax_mesh_fit():
    jm, params, state, x, y, _ = mlp_case()

    class DM:
        drop_last = True
        train_sampling = None
        batch_size = 64

        def __init__(self):
            self.train = JaxArraySplit(x, y)
            self.val = JaxArraySplit(x, y)
            self.test = self.val

    tr = JaxTrainer(max_epochs=2, seed=3, verbose=False,
                    mesh=jax_mesh(n_data=4, devices=jax.devices()[:4]))
    return tr.fit(JaxClassificationTask(jm), DM(), params, state,
                  jax_make_radam(1e-2))


def test_dp_trainer_matches_one_process(ranks):
    res, _, _ = ranks
    one = jobs.fit(None, **mlp_case()[-1], device="cpu")
    dp = res[0]["mlp"]
    assert (dp["history"][0]["train_epoch/loss"]
            == pytest.approx(one["history"][0]["train_epoch/loss"], abs=1e-6))
    for ours, theirs in zip(dp["history"], one["history"]):
        assert set(ours) == set(theirs)
        for k, v in _metrics(theirs).items():  # f1, class accuracies too
            assert ours[k] == pytest.approx(v, abs=1e-5), k
    for k, v in one["state_dict"].items():
        np.testing.assert_allclose(dp["state_dict"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for r in res[1:]:                       # every rank holds the same
        assert _metrics(r["mlp"]["history"]) == _metrics(dp["history"])
        for k, v in dp["state_dict"].items():
            np.testing.assert_array_equal(r["mlp"]["state_dict"][k], v)


def test_dp_trainer_matches_the_jax_mesh_run(ranks):
    res, _, _ = ranks
    jres = _jax_mesh_fit()
    jm = mlp_case()[0]
    j_sd = bridge.mlp_state_dict(jm.hparams, jres.params, jres.final_state)
    dp = res[0]["mlp"]
    for k, v in j_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(dp["state_dict"][k], v.numpy(), rtol=1e-3,
                                   atol=2e-4, err_msg=k)
    for ours, theirs in zip(dp["history"], jres.history):
        assert ours["val/loss"] == pytest.approx(theirs["val/loss"], abs=1e-4)


def test_dp_vqvae_ema_codebook_on_every_rank(ranks):
    res, _, _ = ranks
    one = jobs.fit(None, **vq_case(), device="cpu")
    cb = res[0]["vq"]["codebook"]
    for r in res[1:]:
        assert _metrics(r["vq"]["history"]) == _metrics(res[0]["vq"]["history"])
        np.testing.assert_array_equal(r["vq"]["codebook"], cb)
        np.testing.assert_array_equal(r["vq"]["cluster_size"],
                                      res[0]["vq"]["cluster_size"])
    np.testing.assert_allclose(cb, one["codebook"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(res[0]["vq"]["cluster_size"],
                               one["cluster_size"], rtol=0, atol=1e-5)
    # BatchNorm's running statistics are the global batch's too
    for k, v in one["state_dict"].items():
        if "running" in k:
            np.testing.assert_allclose(res[0]["vq"]["state_dict"][k], v,
                                       rtol=0, atol=1e-5, err_msg=k)


def test_quantize_ema_group_matches_jax_shard_map(ranks):
    from vq_vae_transformer_arc_welding_tpu.ops.vq_ema import (
        EMAState as JaxEMAState, quantize_ema as jax_quantize_ema)
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    res, _, _ = ranks
    z, _ = ema_case()
    mesh = jax_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])

    def body(z, state):
        _, new = jax_quantize_ema(z, state, train=True,
                                  rng=jax.random.PRNGKey(0), kmeans_iters=3,
                                  threshold_ema_dead_code=2,
                                  axis_name="data")
        return new.codebook

    fn = shard_map(body, mesh=mesh, in_specs=(P("data", None, None), P()),
                   out_specs=P("data"))
    stacked = np.asarray(fn(jax.device_put(
        jnp.asarray(z), NamedSharding(mesh, P("data", None, None))),
        JaxEMAState.create(EMA_K, EMA_D))).reshape(4, EMA_K, EMA_D)
    for r, ref in zip(res, stacked):
        np.testing.assert_allclose(r["ema_axis"]["codebook"], ref, rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(r["ema_axis"]["codebook"],
                                      res[0]["ema_axis"]["codebook"])


# -- tensor parallel -----------------------------------------------------------------


def test_tp_forward_matches_jax_dense(ranks):
    res, _, _ = ranks
    jt, params, _, _, ids, _ = transformer_case(2)
    ref, _ = jt.apply(params, None, jnp.asarray(ids, jnp.int32))
    for r in res:
        np.testing.assert_allclose(r["tp"]["logits"], np.asarray(ref),
                                   rtol=0, atol=1e-5)


def _dense_step(n_blocks: int = 2):
    """The dense model's generation loss and gradients on the case."""
    jt, params, _, _, ids, labels = transformer_case(n_blocks)
    model = bridge.transformer_from_jax(jt.hparams, params, device="cpu")
    model.requires_grad_(True)
    loss = model.loss_gen(model.apply(torch.as_tensor(ids)),
                          torch.as_tensor(labels))
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in model.named_parameters()
                         if p.grad is not None}, model


def test_dp_tp_step_matches_dense(ranks):
    res, _, _ = ranks
    loss, grads, _ = _dense_step(2)
    for r in res:
        step = r["dp_tp"]
        assert step["loss"] == pytest.approx(loss, abs=1e-6)
        assert set(step["grads"]) == set(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(step["grads"][k], g, rtol=0,
                                       atol=1e-5, err_msg=k)


# -- pipeline ------------------------------------------------------------------------


def test_pipeline_forward_matches_jax_dense(ranks):
    res, _, _ = ranks
    jt, params, _, _, ids, _ = transformer_case(4)
    for generate, key in ((True, "gen"), (False, "class")):
        ref, _ = jt.apply(params, None, jnp.asarray(ids, jnp.int32),
                          generate=generate)
        for r in res:
            for job in ("pp", "dp_pp"):
                np.testing.assert_allclose(r[job][key], np.asarray(ref),
                                           rtol=0, atol=1e-5)


@pytest.mark.parametrize("job", ["pp", "dp_pp"])
def test_pipeline_grads_match_dense(ranks, job):
    res, _, _ = ranks
    loss, grads, model = _dense_step(4)
    for r in res:
        assert r[job]["loss"] == pytest.approx(loss, abs=1e-6)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(r[job]["grads"][n],
                                       grads.get(n, np.zeros(p.shape)),
                                       rtol=0, atol=1e-5, err_msg=n)


def test_dp_tp_dropout_step_matches_dense(ranks):
    """A rank keeps its heads' part of the layer's attention mask and
    its rows' part of the batch's: the dense step's draws."""
    res, _, _ = ranks
    _, _, _, _, ids, labels = transformer_case(2)
    model = jobs.build(dropout_spec(), CPU)
    model.requires_grad_(True)
    loss = model.loss_gen(model.apply(
        torch.as_tensor(ids), train=True,
        generator=torch.Generator().manual_seed(0)), torch.as_tensor(labels))
    loss.backward()
    for r in res:
        step = r["dp_tp_dropout"]
        assert step["loss"] == pytest.approx(loss.item(), abs=1e-6)
        for n, p in model.named_parameters():
            if p.grad is not None:          # the class head's is none
                np.testing.assert_allclose(step["grads"][n], p.grad.numpy(),
                                           rtol=0, atol=1e-5, err_msg=n)


def test_pipeline_train_mode_dropout_runs(ranks):
    """Each (microbatch, block) draws from its own generator: the
    pipelined step is the microbatched dense step with those draws, so
    no two stages share a mask."""
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    from vq_vae_transformer_arc_welding_tpu_torch.parallel.pipeline import (
        microbatch_generator, step_seed)
    res, _, _ = ranks
    _, _, _, spec, ids, labels = transformer_case(4, 0.2)
    model = jobs.build(spec, CPU)
    model.requires_grad_(True)
    seed = step_seed(torch.Generator().manual_seed(0))
    outs = []
    for m, x_ids in enumerate(torch.as_tensor(ids).chunk(2)):
        x = model.embed(x_ids)
        for i, blk in enumerate(model.transformer.h):
            x = model.block_body(x, blk, train=True,
                                 generator=microbatch_generator(
                                     seed, m, i, model.n_blocks, CPU))
        outs.append(x)
    ln_f = model.transformer.ln_f
    x = layer_norm(torch.cat(outs), ln_f.weight, ln_f.bias)
    loss = model.loss_gen(model.heads(x), torch.as_tensor(labels))
    loss.backward()
    dense_loss, _, _ = _dense_step(4)
    assert abs(loss.item() - dense_loss) > 1e-4      # dropout was on
    for r in res:
        out = r["pp_dropout"]
        assert out["loss"] == pytest.approx(loss.item(), abs=1e-6)
        for n, p in model.named_parameters():
            g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
            np.testing.assert_allclose(out["grads"][n], g, rtol=0,
                                       atol=1e-5, err_msg=n)


def test_pipelined_decoder_trainer_matches_dense(ranks):
    res, _, _ = ranks
    one = jobs.fit(None, **pp_fit_case(), device="cpu")
    for r in res:
        # two validation batches, one on each data rank
        for ours, theirs in zip(r["pp_fit"]["history"], one["history"]):
            assert ours["val/loss"] == pytest.approx(theirs["val/loss"],
                                                     abs=1e-5)
        assert (_metrics(r["pp_fit"]["history"])
                == _metrics(res[0]["pp_fit"]["history"]))
        for k, v in one["state_dict"].items():
            np.testing.assert_allclose(r["pp_fit"]["state_dict"][k], v,
                                       rtol=2e-4, atol=1e-5, err_msg=k)


def test_pipelined_checkpoint_loads_dense(tmp_path):
    _, _, port, _, ids, _ = transformer_case(4)
    piped = PipelinedDecoder(port, make_mesh(1, 1, devices=[CPU]),
                             n_micro=2)
    path = str(tmp_path / "piped.ckpt")
    piped.save(path)
    back = TransformerDecoder.load(path, device="cpu")
    x = torch.as_tensor(ids[:3])            # 3 rows: the dense path
    torch.testing.assert_close(back.apply(x), piped.apply(x), rtol=0, atol=0)


# -- ring attention -----------------------------------------------------------------


def test_ring_attention_matches_dense(ranks):
    res, (q, k, v), _ = ranks
    ref = np.asarray(jax_causal_core(*(jnp.asarray(a) for a in (q, k, v))))
    for r in res:
        np.testing.assert_allclose(r["ring"], ref, rtol=0, atol=1e-5)


def test_ring_attention_nondivisible_raises(ranks):
    res, _, _ = ranks
    assert all(r["ring_raises"].startswith("AssertionError") for r in res)


# -- sharded checkpoints ---------------------------------------------------------------


def test_sharded_checkpoint_ema_state_roundtrip(tmp_path):
    vq = VQVAEPatch(hidden_dim=16, input_dim=2, num_embeddings=8,
                    embedding_dim=4, n_resblocks=1, batch_norm=True,
                    use_improved_vq=True,
                    generator=torch.Generator().manual_seed(4), device="cpu")
    gen = torch.Generator().manual_seed(1)
    state = EMAState(torch.randn(8, 4, generator=gen),
                     torch.rand(8, generator=gen),
                     torch.randn(8, 4, generator=gen),
                     torch.tensor(1, dtype=torch.int32))
    d = str(tmp_path / "ck")
    save_checkpoint_sharded(d, "VQVAEPatch", vq.hparams, vq.state_dict(),
                            state, {"epoch": 2})
    template = (VQVAEPatch(**vq.hparams, device="cpu").state_dict(),
                EMAState.create(8, 4))
    hdr, params, st = load_checkpoint_sharded(d, template)
    assert hdr["model"] == "VQVAEPatch" and hdr["extra"]["epoch"] == 2
    assert hdr["backend"] == "torch.distributed.checkpoint"
    assert isinstance(st, EMAState)
    for a, b in zip(st, state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in vq.state_dict().items():
        torch.testing.assert_close(params[k], v, rtol=0, atol=0)


def test_sharded_checkpoint_tp_shards_and_dense(ranks):
    res, _, path = ranks
    for r in res:
        ck = r["ckpt"]
        assert ck["max_err"] == 0.0
        assert len(ck["sharded"]) == 6 * 2       # 6 split leaves a block
    _, _, port, _, _, _ = transformer_case(2)
    fresh = TransformerDecoder(**port.hparams, device="cpu")
    _, sd, _ = load_checkpoint_sharded(path, (dense_view(fresh.state_dict()),
                                              {}))
    for k, v in port.state_dict().items():
        torch.testing.assert_close(model_state_dict(sd)[k], v, rtol=0, atol=0)


def test_sharded_checkpoint_one_process_save_loads_dense_view(tmp_path):
    """A writer that was not tensor-parallel stores the layout a TP
    writer stores: one template reads both."""
    from vq_vae_transformer_arc_welding_tpu_torch.train.checkpoint import (
        sharded_state_dict)
    _, _, port, _, _, _ = transformer_case(2)
    d = str(tmp_path / "ck")
    save_checkpoint_sharded(d, "TransformerDecoder", port.hparams,
                            sharded_state_dict(port), {}, {})
    fresh = TransformerDecoder(**port.hparams, device="cpu")
    _, sd, _ = load_checkpoint_sharded(d, (dense_view(fresh.state_dict()),
                                           {}))
    fresh.load_state_dict(model_state_dict(sd))
    for k, v in port.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


# -- mesh serving -------------------------------------------------------------------


def _tiny_pipeline(max_batch: int, mesh=None):
    gen = torch.Generator().manual_seed(6)
    vq = VQVAEPatch(hidden_dim=16, input_dim=2, num_embeddings=8,
                    embedding_dim=4, n_resblocks=1, batch_norm=False,
                    generator=gen, device="cpu")
    tr = TransformerDecoder(d_model=16, n_classes=10,
                            seq_len=2 * vq.enc_out_len + 1, n_blocks=1,
                            n_head=2, generator=gen, device="cpu")
    return WeldingQualityPipeline(vq, tr, 2, max_batch=max_batch, mesh=mesh)


@pytest.mark.parametrize("max_batch, n", [(4, 7), (6, 9)])
def test_mesh_serving_matches_meshless(tmp_path, max_batch, n):
    mesh = make_mesh(4, 1, devices=[CPU] * 4)
    base, sharded = _tiny_pipeline(max_batch), _tiny_pipeline(max_batch, mesh)
    x = np.random.default_rng(7).standard_normal((n, 400, 2)).astype(
        np.float32)
    lb, pb = base.classify(x)
    ls, ps = sharded.classify(x)
    np.testing.assert_array_equal(lb, ls)
    np.testing.assert_allclose(pb, ps, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(base.encode_tokens(x),
                                  sharded.encode_tokens(x))
    cyc = x.reshape(-1, 200, 2)[:5]
    np.testing.assert_allclose(base.ood_score(cyc), sharded.ood_score(cyc),
                               rtol=0, atol=1e-6)
    for p in (base, sharded):                 # int8, calibrated alike
        p.precision = "int8"
        p.calibrate(x[:4])
    l8b, p8b = base.classify(x)
    l8s, p8s = sharded.classify(x)
    assert p8s.shape == (n, 2)
    np.testing.assert_array_equal(l8b, l8s)
    np.testing.assert_allclose(p8b, p8s, rtol=0, atol=1e-6)
    assert sharded.last_saturation_rate is not None
    assert sharded.last_saturation_rate == base.last_saturation_rate
    art = str(tmp_path / "art")
    base.save_artifact(art)
    loaded = WeldingQualityPipeline.load_artifact(art, mesh=mesh, device="cpu")
    assert loaded.mesh is mesh
    l8l, p8l = loaded.classify(x)
    np.testing.assert_array_equal(l8l, l8b)
    np.testing.assert_allclose(p8l, p8b, rtol=0, atol=1e-6)


# -- the CLI's mesh and the dryrun -------------------------------------------------------


def test_cli_mesh_refusal_matches_jax():
    from vq_vae_transformer_arc_welding_tpu.cli import (
        train_transformer_mtasks as jtm)
    from vq_vae_transformer_arc_welding_tpu_torch.cli import (
        train_transformer_mtasks as ptm)
    with pytest.raises(NotImplementedError) as ours:
        ptm._maybe_mesh(True, pipeline_stages=2, tensor_parallel=2,
                        devices=[CPU] * 8)
    with pytest.raises(NotImplementedError) as theirs:
        jtm._maybe_mesh(True, pipeline_stages=2, tensor_parallel=2)
    assert str(ours.value) == str(theirs.value)
    for kw in (dict(use_all_devices=True), dict(use_all_devices=True,
                                                 tensor_parallel=2),
               dict(use_all_devices=True, pipeline_stages=4),
               dict(use_all_devices=False, pipeline_stages=2)):
        ours = ptm._maybe_mesh(**kw, devices=[CPU] * 8)
        theirs = jtm._maybe_mesh(**kw)
        assert ours.shape == dict(theirs.shape), kw


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    from vq_vae_transformer_arc_welding_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    for check in ("dp-tp-train-step", "ring-attention-vs-dense",
                  "pipeline-parallel-grads-vs-dense",
                  "pipeline-parallel-trainer-step", "ema-vq-dp-codebook",
                  "shard-map-serving", "orbax-sharded-roundtrip"):
        assert f"sub-check {check}: ok" in out
    assert "dryrun_multichip OK on 4 devices" in out


def test_indivisible_batch_runs_replicated():
    """A batch that 'data' does not divide runs whole on every rank."""
    mesh = make_mesh(4, 1, devices=[CPU] * 4)
    mesh.rank, mesh.groups = 1, {"data": (None, [0, 1, 2, 3])}
    from vq_vae_transformer_arc_welding_tpu_torch.parallel.training import (
        MeshTraining)
    par = MeshTraining(mesh, torch.nn.Linear(2, 2))
    idx = torch.arange(2 * 3 * 6).reshape(2, 3, 6)
    same, sliced = par.local(idx, 6)
    assert not sliced and torch.equal(same, idx)
    idx = torch.arange(2 * 3 * 8).reshape(2, 3, 8)
    part, sliced = par.local(idx, 8)
    assert sliced and torch.equal(part, idx[..., 2:4])



def test_a_slice_draws_its_part_of_the_whole_mask():
    """Inside a data-parallel step (and for a tensor-parallel rank's
    heads) dropout draws the whole tensor's mask and keeps its part, so
    the ranks drop what one process drops."""
    from vq_vae_transformer_arc_welding_tpu_torch.parallel.shard import (
        data_shard)
    from vq_vae_transformer_arc_welding_tpu_torch.utils.random import dropout
    x = torch.randn(8, 4, 5, 3)
    whole = dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    for i in range(4):
        with data_shard(None, i, 4):
            part = dropout(x[2 * i:2 * i + 2, 2:4], 0.3, True,
                           torch.Generator().manual_seed(1),
                           parts=((1, 1, 2),))
        torch.testing.assert_close(part, whole[2 * i:2 * i + 2, 2:4],
                                   rtol=0, atol=0)
