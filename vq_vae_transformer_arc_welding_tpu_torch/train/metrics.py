"""Classification metrics with torchmetrics' semantics as the reference
uses them (model/classification_model.py:85-108).

Port of vq_vae_transformer_arc_welding_tpu/train/metrics.py
(`accuracy_micro`, `per_class_accuracy`, `binary_f1`,
`classification_metrics`, `cross_entropy`):

- accuracy: micro average over the two classes;
- binary F1 on the positive class, 0 when the denominator is 0;
- per-class accuracies acc_good (label 1) / acc_bad (label 0), 0 when
  the class is absent from the batch.

Each returns a 0-d f32 tensor on the inputs' device, so that a training
epoch reads its metrics back from the card once. The epoch's `*_mean`
is the mean over batches (reference :154-171), taken by the trainer.
Inside a data-parallel step (parallel/shard.py) the inputs are the
rank's slice of the batch, and the metrics are the whole batch's: the
predictions and labels are gathered over the data group first.
"""
from __future__ import annotations

import torch


def accuracy_micro(preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (preds == y).float().mean()


def per_class_accuracy(preds: torch.Tensor, y: torch.Tensor,
                       cls: int) -> torch.Tensor:
    in_cls = y == cls
    n = in_cls.sum()
    correct = ((preds == cls) & in_cls).sum()
    return torch.where(n > 0, correct / n.clamp_min(1), 0.0).float()


def binary_f1(preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    tp = ((preds == 1) & (y == 1)).sum().float()
    fp = ((preds == 1) & (y == 0)).sum().float()
    fn = ((preds == 0) & (y == 1)).sum().float()
    denom = 2 * tp + fp + fn
    return torch.where(denom > 0, 2 * tp / denom.clamp_min(1e-9), 0.0)


def classification_metrics(logits: torch.Tensor, y: torch.Tensor) -> dict:
    """The reference's per-batch metric dict (loss excluded)."""
    preds = logits.argmax(dim=-1)
    from ..parallel.shard import active
    shard = active()
    if shard is not None:
        from ..parallel.mesh import all_gather
        preds, y = (all_gather(t, shard.group) for t in (preds, y))
    return {
        "acc": accuracy_micro(preds, y),
        "acc_good": per_class_accuracy(preds, y, 1),
        "acc_bad": per_class_accuracy(preds, y, 0),
        "f1_score": binary_f1(preds, y),
    }


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch F.cross_entropy (mean reduction) for integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()
