"""Optimizers: torch.optim.RAdam with the reference's clipping, weight
decay split and schedule.

Port of vq_vae_transformer_arc_welding_tpu/train/optim.py (`make_radam`,
`cosine_warmup_schedule`, `make_transformer_optimizer`). The JAX package
rebuilds torch.optim.RAdam as an optax chain (clip -> masked L2 added to
the gradient -> `scale_by_torch_radam` -> -lr); here the chain is the
thing itself:

- global-norm clipping is `torch.nn.utils.clip_grad_norm_` before the
  step (Lightning's `gradient_clip_val`);
- weight decay is L2 added to the gradient (`decoupled_weight_decay=
  False`), on one parameter group, with the other group at 0: the
  transformer's minGPT split (`TransformerDecoder.decay_mask`);
- a parameter outside the loss graph keeps `grad is None`
  (`zero_grad(set_to_none=True)`), and torch.optim.RAdam skips it
  whole: no decay, no moment update, no step count. The JAX chain
  emulates that skip; its per-parameter step counts are torch's;
- a schedule is a `LambdaLR` factor.

`make_radam(...)` returns a spec, as the JAX package returns an optax
transformation: `spec.init(model)` builds the `TrainOptimizer` over the
model's parameters, as `tx.init(params)` builds the optimizer state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


class TrainOptimizer:
    """A torch.optim.RAdam with its clipping and its schedule: what the
    trainer steps once per accumulation group."""

    def __init__(self, named_params: list, optimizer: torch.optim.Optimizer,
                 clip_norm: float | None,
                 scheduler: torch.optim.lr_scheduler.LRScheduler | None):
        self.named_params = named_params
        self.optimizer = optimizer
        self.clip_norm = clip_norm
        self.scheduler = scheduler
        # () -> the global gradient norm, where the parameters are shards
        # of a tensor-parallel model (parallel/training.py); None: the
        # norm of the gradients on this device
        self.grad_norm_fn = None

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Clip the gradients by their global norm, step, advance the
        schedule."""
        if self.clip_norm:
            grads = [p for _, p in self.named_params if p.grad is not None]
            if self.grad_norm_fn is None:
                torch.nn.utils.clip_grad_norm_(grads, self.clip_norm)
            else:
                torch.nn.utils.clip_grads_with_norm_(
                    grads, self.clip_norm, self.grad_norm_fn())
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def state_dicts(self):
        """(the optimizer's state_dict, the scheduler's or None)."""
        return (self.optimizer.state_dict(),
                None if self.scheduler is None
                else self.scheduler.state_dict())

    def load_state_dicts(self, optimizer_state: dict,
                         scheduler_state: dict | None) -> None:
        self.optimizer.load_state_dict(optimizer_state)
        if self.scheduler is not None and scheduler_state is not None:
            self.scheduler.load_state_dict(scheduler_state)

    def step_counts(self) -> dict:
        """{parameter name: the steps RAdam took on it}, 0 where it never
        had a gradient."""
        state = self.optimizer.state
        return {name: int(state[p]["step"]) if p in state else 0
                for name, p in self.named_params}


@dataclass(frozen=True)
class RAdamSpec:
    """What `make_radam` returns; `init(model)` builds the optimizer."""
    learning_rate: float
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    decay_mask: frozenset | None = None
    clip_norm: float | None = None
    schedule: object = None

    def init(self, model) -> TrainOptimizer:
        """model: an nn.Module, or a list of (name, parameter)."""
        named = (list(model.named_parameters())
                 if hasattr(model, "named_parameters") else list(model))
        if self.weight_decay:
            mask = self.decay_mask
            decay = [p for n, p in named if mask is None or n in mask]
            rest = [p for n, p in named if not (mask is None or n in mask)]
            groups = [{"params": ps, "weight_decay": wd}
                      for ps, wd in ((decay, self.weight_decay), (rest, 0.0))
                      if ps]
        else:
            groups = [{"params": [p for _, p in named], "weight_decay": 0.0}]
        opt = torch.optim.RAdam(groups, lr=self.learning_rate,
                                betas=tuple(self.betas), eps=self.eps,
                                decoupled_weight_decay=False)
        sched = (None if self.schedule is None
                 else torch.optim.lr_scheduler.LambdaLR(opt, self.schedule))
        clip = self.clip_norm if self.clip_norm and self.clip_norm > 0 else None
        return TrainOptimizer(named, opt, clip, sched)


def make_radam(learning_rate: float, *, betas=(0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, decay_mask=None,
               clip_norm: float | None = None, schedule=None) -> RAdamSpec:
    """RAdam with optional global-norm clipping and L2 weight decay.
    decay_mask: the names of the parameters that decay (None: all of
    them, where weight_decay is set). schedule: step -> learning-rate
    factor (`cosine_warmup_schedule`), stepped once per optimizer step."""
    return RAdamSpec(learning_rate, tuple(betas), eps, weight_decay,
                     None if decay_mask is None else frozenset(decay_mask),
                     clip_norm, schedule)


def cosine_warmup_schedule(warmup: int, max_iters: int):
    """Cosine learning-rate factor with linear warmup (reference
    classification_model.py:10-24, CosineWarmupScheduler), a function of
    the step for `LambdaLR` (`make_radam(schedule=)`)."""
    def schedule(step: int) -> float:
        factor = 0.5 * (1 + math.cos(math.pi * step / max_iters))
        if step <= warmup:
            return factor * step / max(warmup, 1)
        return factor

    return schedule


def make_transformer_optimizer(model, *, clip_norm: float | None = 0.8
                               ) -> RAdamSpec:
    """RAdam with betas (0.9, 0.95) and weight decay 0.1 on the minGPT
    decay split (`model.decay_mask()`), clipped at 0.8."""
    decay, _ = model.decay_mask()
    return make_radam(model.learning_rate, betas=model.betas,
                      weight_decay=model.weight_decay, decay_mask=decay,
                      clip_norm=clip_norm)
