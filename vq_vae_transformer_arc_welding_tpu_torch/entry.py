"""The bench model and its classify pipelines.

Port of __graft_entry__.py (`_build`, `make_pipeline`,
`make_pipeline_quantized` with its `encoder_dtype`): the VQ-VAE (hidden 512, 8 resblocks,
K=256, D=32, patch 25, no BatchNorm) and the transformer (d512,
8 blocks, 8 heads, 321 tokens: 20 cycles x 16 tokens + start token,
258 classes) that `bench.py` times. Weights are random, drawn from a
torch.Generator seeded with `seed`. `build` puts the models on the card
unless the caller names another device. `dryrun_multichip` is the JAX
entry's multi-device check (parallel/ on tiny models).
"""
from __future__ import annotations

import torch

from .models import TransformerDecoder, VQVAEPatch
from .models.base import serving_device
from .serve import CYCLE_LEN, WeldingQualityPipeline, with_start_token

N_CYCLES = 20
# seconds a dryrun's ranks may take before they are stopped
DRYRUN_TIMEOUT = 900


def build(d_model: int = 512, n_blocks: int = 8, n_heads: int = 8,
          hidden: int = 512, k: int = 256, d: int = 32, n_res: int = 8,
          seed: int = 0, device=None, vq_impl: str = "xla",
          attention_impl: str = "xla"
          ) -> tuple[VQVAEPatch, TransformerDecoder]:
    """(vq, tr) at the bench configuration, in eval mode on `device`:
    the card when it is None (and an error where there is none), the
    CPU only when asked. vq_impl: the VQ-VAE's nearest-code option;
    attention_impl: the transformer's attention option."""
    device = serving_device(device)
    gen = torch.Generator().manual_seed(seed)
    vq = VQVAEPatch(hidden_dim=hidden, input_dim=2, num_embeddings=k,
                    embedding_dim=d, n_resblocks=n_res, learning_rate=1e-3,
                    batch_norm=False, vq_impl=vq_impl, generator=gen,
                    device=device)
    seq_len = N_CYCLES * vq.enc_out_len + 1
    tr = TransformerDecoder(d_model=d_model, n_classes=k + 2,
                            seq_len=seq_len, n_blocks=n_blocks,
                            n_head=n_heads, attention_impl=attention_impl,
                            generator=gen, device=device)
    return vq.eval(), tr.eval()


def make_pipeline(vq: VQVAEPatch, tr: TransformerDecoder):
    """The f32 classify step: (B, n_cycles*200, 2) windows -> (B, 2)
    logits; the correctness anchor of the int8 path."""

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        ids = vq.encode_indices(x.reshape(-1, CYCLE_LEN, 2))
        return tr.apply(with_start_token(ids.reshape(b, -1),
                                         vq.num_embeddings), generate=False)

    return fn


def make_pipeline_quantized(vq: VQVAEPatch, tr: TransformerDecoder, qparams,
                            block_fusion: str | None = "attn",
                            encoder_dtype=None, **classify_kw):
    """The int8 classify step: fused f32 encoder (kernel #1) and the
    calibrated int8 transformer, `quantized_classify(block_fusion=...)`:
    'attn' (the default, kernel #2 per block), 'full' (#6), 'attn8' and
    'full8' (their int8-attention variants), each also with '-bf16', or
    None. `classify_kw` goes to quantized_classify as it is: with
    block_fusion=None, fused_attention=True and the fused_* options
    select the fused attention kernels (#10, #11) and the fused MLP
    (#8). `qparams` must carry calibrated activation scales.

    encoder_dtype: None = the f32 encoder (split TF32 on the card, f32
    accuracy: ids equal the plain encoder's but for near-ties, the
    default contract). torch.bfloat16 = the
    encoder's products on the bf16 tensor cores with f32 sums
    (`encode_indices_fused(compute_dtype=)`): ids can differ near
    Voronoi boundaries, so measure label agreement first.

    The encoder's kernel operands are packed once, here, in the
    encoder's dtype."""
    from .models.quantized import quantized_classify
    from .ops.fused_encoder import encode_indices_fused, pack_encoder

    with torch.no_grad():
        packed = pack_encoder(vq, encoder_dtype)

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        ids = encode_indices_fused(vq, packed, x.reshape(-1, CYCLE_LEN, 2),
                                   compute_dtype=encoder_dtype)
        return quantized_classify(
            tr, qparams, with_start_token(ids.reshape(b, -1),
                                          vq.num_embeddings),
            block_fusion=block_fusion, **classify_kw)

    return fn


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The JAX package's `dryrun_multichip` (__graft_entry__.py) on the
    port: one process per device (parallel/launch.py), tiny models, each
    parallel path held against the same function in this process, its
    sub-checks printed under JAX's names. device: 'cpu' runs n gloo
    ranks on the host; None takes n CUDA devices (NCCL). Raises
    AssertionError where a path disagrees."""
    import os
    import tempfile

    import numpy as np

    from .ops.attention import causal_attention_core
    from .parallel import jobs, launch
    from .parallel.mesh import make_mesh, make_mesh_dp_pp

    dev = torch.device("cuda" if device is None else device)
    devices = ([dev] * n_devices if dev.type == "cpu" else
               [torch.device(f"cuda:{i}") for i in range(n_devices)])
    n_model = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    mesh = make_mesh(n_devices // n_model, n_model, devices=devices)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    vq = VQVAEPatch(hidden_dim=32, input_dim=2, num_embeddings=16,
                    embedding_dim=8, n_resblocks=1, learning_rate=1e-3,
                    batch_norm=False, generator=gen, device=dev)
    n_cycles = 2
    seq_len = n_cycles * vq.enc_out_len + 1
    tr = TransformerDecoder(d_model=32, n_classes=18, seq_len=seq_len,
                            n_blocks=2, n_head=4, res_dropout=0.0,
                            generator=gen, device=dev)
    spec = jobs.model_spec(tr)
    batch = mesh.shape["data"] * 2
    x = torch.as_tensor(rng.standard_normal(
        (batch, n_cycles * 200, 2)).astype(np.float32), device=dev)
    with torch.no_grad():
        ids = with_start_token(
            vq.encode_indices(x.reshape(-1, 200, 2)).reshape(batch, -1),
            vq.num_embeddings).long()
    labels = torch.as_tensor(rng.integers(0, 18, (batch, seq_len)),
                             device=dev)
    t_sp = 8 * n_model
    q, k, v = (rng.standard_normal((2, 2, t_sp, 8)).astype(np.float32)
               for _ in range(3))
    with tempfile.TemporaryDirectory() as tmp:
        todo = [("step", "tp_step", dict(spec=spec, ids=ids.cpu().numpy(),
                                         labels=labels.cpu().numpy())),
                ("ckpt", "sharded_checkpoint",
                 dict(spec=spec, path=os.path.join(tmp, "ck")))]
        if n_model > 1:
            todo.append(("ring", "ring", dict(q=q, k=k, v=v)))
        out = launch.run(jobs.run_jobs, mesh, todo, timeout=DRYRUN_TIMEOUT)[0]
    ckpt = out["ckpt"]

    # the DP+TP step against the dense step on the whole batch
    tr.requires_grad_(True)
    loss = tr.loss_gen(tr.apply(ids), labels)
    loss.backward()
    step = out["step"]
    assert np.isfinite(step["loss"]), "dryrun produced non-finite loss"
    assert abs(step["loss"] - loss.item()) < 1e-5, \
        f"dp x tp loss {step['loss']} against dense {loss.item()}"
    gerr = max(float(np.abs(step["grads"][n] - p.grad.cpu().numpy()).max())
               for n, p in tr.named_parameters() if n in step["grads"])
    assert gerr < 1e-4, f"dp x tp gradient drift: {gerr}"
    print("  sub-check dp-tp-train-step: ok")

    if n_model > 1:
        ref = causal_attention_core(*(torch.as_tensor(a)
                                      for a in (q, k, v))).numpy()
        err = float(np.abs(out["ring"] - ref).max())
        assert err < 1e-4, f"ring attention mismatch: {err}"
        print("  sub-check ring-attention-vs-dense: ok")

    if n_devices >= 4:
        pp_mesh = make_mesh_dp_pp(2, 2, devices=devices)
        tr_pp = TransformerDecoder(d_model=32, n_classes=18, seq_len=seq_len,
                                   n_blocks=2, n_head=4, res_dropout=0.0,
                                   generator=torch.Generator().manual_seed(1),
                                   device=dev)
        pp_spec = jobs.model_spec(tr_pp)
        pp_ids = rng.integers(0, 17, (4, seq_len))
        pp_lbl = rng.integers(0, 18, (4, seq_len))
        tx = rng.integers(0, 17, (16, seq_len))
        ty = rng.integers(0, 18, (16, seq_len))
        tc = rng.integers(0, 2, (16,))
        fit_kw = dict(spec=pp_spec, task="gen", data=dict(x=tx, y=ty, cond=tc),
                      batch_size=8, epochs=1, seed=9, optimizer="transformer",
                      val_every=10**9)
        ema = VQVAEPatch(hidden_dim=16, input_dim=2, num_embeddings=8,
                         embedding_dim=4, n_resblocks=1, learning_rate=1e-3,
                         batch_norm=False, use_improved_vq=True,
                         kmeans_iters=2, generator=torch.Generator(
                             ).manual_seed(2), device=dev)
        ema_kw = dict(spec=jobs.model_spec(ema), task="reconstruction",
                      data=dict(x=np.random.default_rng(1).standard_normal(
                          (32, 200, 2)).astype(np.float32)),
                      batch_size=2 * pp_mesh.shape["data"], epochs=1, seed=5,
                      lr=1e-3, val_every=10**9)
        out = launch.run(jobs.run_jobs, pp_mesh, [
            ("pp", "pp_step", dict(spec=pp_spec, ids=pp_ids, labels=pp_lbl,
                                   n_micro=2, data_axis="data")),
            ("fit", "fit", dict(fit_kw, pipeline=2)),
            ("ema", "fit", ema_kw)], timeout=DRYRUN_TIMEOUT)[0]
        dense = jobs.build(pp_spec, dev)
        dense.requires_grad_(True)
        lp = torch.as_tensor(pp_lbl, device=dev)
        loss = dense.loss_gen(dense.apply(torch.as_tensor(pp_ids,
                                                          device=dev)), lp)
        loss.backward()
        assert abs(out["pp"]["loss"] - loss.item()) < 1e-5, \
            f"pp loss mismatch: {out['pp']['loss']} vs {loss.item()}"
        gerr = max(float(np.abs(out["pp"]["grads"][n]
                                - (0 if p.grad is None
                                   else p.grad.cpu().numpy())).max())
                   for n, p in dense.named_parameters())
        assert gerr < 1e-4, f"pp grad mismatch: {gerr}"
        print("  sub-check pipeline-parallel-grads-vs-dense: ok")
        ref = jobs.fit(None, **fit_kw, device=dev)["state_dict"]
        err = max(float(np.abs(out["fit"]["state_dict"][k] - ref[k]).max())
                  for k in ref)
        assert err < 1e-4, f"pp Trainer weight drift vs dense: {err}"
        print("  sub-check pipeline-parallel-trainer-step: ok")
        ref = jobs.fit(None, **ema_kw, device=dev)["codebook"]
        err = float(np.abs(out["ema"]["codebook"] - ref).max())
        assert err < 1e-4, f"EMA-VQ DP codebook drift: {err}"
        print("  sub-check ema-vq-dp-codebook: ok")

    # serving over the mesh's 'data' devices against one device
    base = WeldingQualityPipeline(vq, tr.eval(), n_cycles, max_batch=8)
    sharded = WeldingQualityPipeline(vq, tr, n_cycles, max_batch=8,
                                     mesh=mesh)
    xs = rng.standard_normal((5, n_cycles * 200, 2)).astype(np.float32)
    lb, pb = base.classify(xs)
    ls, ps = sharded.classify(xs)
    assert (lb == ls).all(), "mesh serving labels drift"
    err = float(np.abs(pb - ps).max())
    assert err < 1e-5, f"mesh serving probs drift: {err}"
    print("  sub-check shard-map-serving: ok")

    # the sharded checkpoint: restored against the sharded template,
    # every split weight comes back as the rank's shard, value for value
    assert ckpt["max_err"] == 0.0, f"sharded roundtrip drift {ckpt['max_err']}"
    assert len(ckpt["sharded"]) == 6 * tr.n_blocks, \
        f"sharded leaves: {ckpt['sharded']}"
    print("  sub-check orbax-sharded-roundtrip: ok")
    print(f"dryrun_multichip OK on {n_devices} devices "
          f"(mesh {mesh.shape}): loss={step['loss']:.4f}")
