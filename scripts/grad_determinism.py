#!/usr/bin/env python3
"""Which gradients of a training step are not bit-reproducible on the card?

    python3 scripts/grad_determinism.py [--repeats 3]

Builds the VQ-VAE and the transformer at chip_smoke.py's training widths
(TRAIN_VQ with vq_impl='pallas', TRAIN_TR with attention_impl='pallas'),
draws one batch each with numpy, and computes one training step's
gradients (forward with the dropouts drawn from a generator reseeded
each time, backward) `--repeats` times from the same weights, under
torch's default flags. It does so with the port's gathers (indexed:
`codebook[ids]` in ops/vq.vq_lookup, `weight[ids]` in
TransformerDecoder.embed) and with F.embedding in their place, each with
torch.backends.cudnn.deterministic off and on, and logs for each setting
the parameters whose gradient bits differ between repeats. Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path
from unittest import mock

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


@contextlib.contextmanager
def embedding_gathers(vq, transformer):
    """ops/vq.vq_lookup and TransformerDecoder.embed with F.embedding in
    place of their indexed gathers, for the block."""
    from torch.nn import functional as F

    def embed(self, x_ids):
        t = x_ids.shape[1]
        x = (F.embedding(x_ids.long(), self.embedding.latent_embedding.weight)
             + self.pe[None, :t])
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    with mock.patch.object(vq, "vq_lookup",
                           lambda ids, cb: F.embedding(ids.long(), cb)), \
            mock.patch.object(transformer.TransformerDecoder, "embed", embed):
        yield


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("grad_determinism: no CUDA device", file=sys.stderr)
        return 2
    from vq_vae_transformer_arc_welding_tpu_torch.models import (
        TransformerDecoder, VQVAEPatch, transformer)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import vq
    from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
        ReconstructionTask, TransformerGenTask)
    dev = torch.device("cuda")
    smi = chip_smoke.gpu_name_and_power()
    rng = np.random.default_rng(chip_smoke.SEED)
    seq = 321
    n_classes = chip_smoke.TRAIN_VQ["num_embeddings"] + 2
    vq_model = VQVAEPatch(**chip_smoke.TRAIN_VQ, vq_impl="pallas",
                          generator=torch.Generator().manual_seed(0),
                          device=dev).requires_grad_(True)
    tr_model = TransformerDecoder(
        **chip_smoke.TRAIN_TR, n_classes=n_classes, seq_len=seq,
        attention_impl="pallas", generator=torch.Generator().manual_seed(1),
        device=dev).requires_grad_(True)
    vq_batch = (torch.from_numpy(rng.standard_normal(
        (chip_smoke.TRAIN_VQ_BATCH, 200, 2)).astype(np.float32)).to(dev),)
    b = chip_smoke.TRAIN_TR_BATCH
    tr_batch = tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, n_classes, (b, seq)).astype(np.int32),
        rng.integers(0, 2, (b,)).astype(np.int64),
        rng.integers(0, n_classes, (b, seq)).astype(np.int64)))

    def grads(model, task, batch):
        gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
        model.zero_grad(set_to_none=True)
        loss, _, _ = task.loss_and_metrics(batch, train=True, generator=gen)
        loss.backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    for gather in ("embedding", "index"):
        for cudnn_det in (False, True):
            patches = (embedding_gathers(vq, transformer)
                       if gather == "embedding" else contextlib.nullcontext())
            prev = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = cudnn_det
            with patches:
                for name, model, task, batch in (
                        ("VQ-VAE", vq_model, ReconstructionTask(vq_model),
                         vq_batch),
                        ("transformer gen", tr_model,
                         TransformerGenTask(tr_model), tr_batch)):
                    first = grads(model, task, batch)
                    differ = set()
                    for _ in range(args.repeats - 1):
                        again = grads(model, task, batch)
                        differ |= {n for n in first
                                   if not torch.equal(first[n], again[n])}
                    chip_smoke.log(
                        f"grad_determinism {name}, gather {gather}, "
                        f"cudnn.deterministic {cudnn_det}: "
                        + (f"{len(differ)} of {len(first)} gradients differ "
                           f"between {args.repeats} repeats, e.g. "
                           f"{sorted(differ)[:6]}" if differ else
                           f"all {len(first)} gradients bit-equal over "
                           f"{args.repeats} repeats")
                        + f"; gpu {smi}")
            torch.backends.cudnn.deterministic = prev
    return 0


if __name__ == "__main__":
    sys.exit(main())
