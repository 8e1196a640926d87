"""Training engine over data resident on the card.

Port of vq_vae_transformer_arc_welding_tpu/train/loop.py (`FitResult`,
`Trainer` with `fit`, `evaluate`, `test`): the Lightning Trainer surface
the reference relies on (ModelCheckpoint best + last, EarlyStopping,
gradient clipping through the optimizer, accumulate_grad_batches,
weighted sampling), as the JAX package rebuilt it:

- a split's arrays go to the model's device once (`task.batch_arrays`)
  and every batch is gathered there by index: no DataLoader, no worker
  processes, no host round trip per batch;
- an epoch's batch indices are drawn at its start on the device:
  weighted sampling with replacement (`torch.multinomial`, the
  reference's WeightedRandomSampler) or a permutation (RandomSampler),
  repeated and cut so that every accumulation group is full (the last
  one may see a few rows twice; nothing is dropped);
- the sampling and the dropout masks draw from two torch.Generators
  seeded from (seed, epoch), so that a run resumed from its last
  checkpoint draws what the uninterrupted run drew;
- `accumulate_grad_batches` sums the gradients of its micro batches and
  divides by their number before one optimizer step;
- losses and metrics stay on the device through the epoch and are read
  back once at its end; early stopping, the best checkpoint and the
  logs run between epochs on the host;
- the evaluation's drop_last=False tail is a batch of its own;
- a split of data/windowed.WindowedArray windows goes to the device as
  its packed cycles and window starts, and each batch's windows are
  gathered there by index, never the whole split;
- `streaming=True` leaves the training split on the host (a
  data/streaming.py memory map, or any array): each micro-batch is
  gathered there, by the native row gather into pinned memory for a
  memory map, and copied to the device without blocking. The indices,
  the dropout draws and so the losses are the resident path's.

The model trains in place: `fit` turns its parameters' gradients on for
the run and off again after it (the port's modules hold frozen weights
for serving). `logger` is duck-typed: `log_metrics(metrics, step=)`,
and `log_artifact(path, name=, type_=)` where it sets `log_model`.

`mesh=` (a bound parallel/mesh.Mesh: this process is one of its ranks,
started by parallel/launch.py) trains data parallel over its 'data'
axis and lands on the global batch's numbers, as a JAX mesh run does;
`param_rules=` (parallel/sharding.transformer_tp_rules) shards the
transformer over 'model', and a parallel/pipeline.PipelinedDecoder runs
its stages over 'pipe' (parallel/training.py says how). `streaming`
with a mesh raises NotImplementedError, as in the JAX package, and so
does the `rbg` dropout PRNG.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data.datasets import ArraySplit
from ..data.streaming import MmapRows
from ..models.base import load_state_dict_checked
from .tasks import Task


@dataclass
class FitResult:
    state_dict: dict                 # weights at the best epoch (or final)
    best_score: float | None
    best_epoch: int
    history: list = field(default_factory=list)
    best_ckpt_path: str | None = None
    stopped_early: bool = False
    optimizer: object = None         # the TrainOptimizer, moments included


def epoch_generators(seed: int, epoch: int, device: torch.device):
    """(sampling generator, dropout generator) of an epoch, on `device`,
    seeded from (seed, epoch) alone."""
    seeds = np.random.SeedSequence([seed, epoch]).generate_state(2)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in seeds)


class Trainer:
    def __init__(self, max_epochs: int = 1, logger=None,
                 monitor: str | None = None, mode: str = "min",
                 patience: int | None = None, min_delta: float = 0.0,
                 checkpoint_dir: str | None = None,
                 checkpoint_name: str = "best", save_last: bool = False,
                 accumulate_grad_batches: int = 1,
                 log_every_n_batches: int = 50,
                 check_val_every_n_epoch: int = 1, seed: int = 0,
                 metric_prefix: str = "", epoch_metric_hook=None,
                 verbose: bool = True, mesh=None, param_rules=None,
                 profile_dir: str | None = None,
                 terminate_on_nan: bool = False, streaming: bool = False,
                 dropout_prng: str = "threefry"):
        """As the JAX Trainer. dropout_prng: only "threefry" (the JAX
        package's default, by name; the port draws with torch's Philox
        generator). profile_dir: a torch.profiler trace of epoch 1 (the
        first after warm-up) is written there."""
        if streaming and mesh is not None:
            raise NotImplementedError("streaming + mesh is not supported")
        if mesh is not None and not getattr(mesh, "bound", False):
            raise ValueError(
                "Trainer(mesh=) runs on a rank of the mesh: start the ranks "
                "with parallel/launch.run (or launch.in_process for a "
                "one-device mesh)")
        if param_rules is not None and mesh is None:
            raise ValueError("param_rules needs a mesh with a 'model' axis")
        if dropout_prng in ("rbg", "unsafe_rbg"):
            raise NotImplementedError(
                f"dropout_prng={dropout_prng!r} is the TPU's hardware RNG; "
                f"the port draws its masks with torch's Philox generator "
                f"(\"threefry\"), ROADMAP.md 'Do not port'")
        if dropout_prng != "threefry":
            raise ValueError(f"dropout_prng: {dropout_prng}")
        if accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be >= 1")
        self.max_epochs = max_epochs
        self.logger = logger
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_name = checkpoint_name
        self.save_last = save_last
        self.accum = accumulate_grad_batches
        self.log_every = log_every_n_batches
        self.check_val_every = check_val_every_n_epoch
        self.seed = seed
        self.metric_prefix = metric_prefix
        self.epoch_metric_hook = epoch_metric_hook
        self.verbose = verbose
        self.profile_dir = profile_dir
        self.terminate_on_nan = terminate_on_nan
        self.dropout_prng = dropout_prng
        self.streaming = streaming
        self.mesh = mesh
        self.param_rules = param_rules
        self._par = None     # parallel/training.MeshTraining during a fit
        self._step_counter = 0
        # a split's arrays on the device, per (task, split); the strong
        # references keep the ids stable
        self._arrays_cache: dict = {}

    # -- data ------------------------------------------------------------------

    def _arrays(self, task: Task, split) -> tuple:
        key = (id(task), id(split))
        if key not in self._arrays_cache:
            self._arrays_cache[key] = (task.batch_arrays(split), task, split)
        return self._arrays_cache[key][0]

    def _train_indices(self, gen: torch.Generator, n: int, batch_size: int,
                       weights, drop_last: bool) -> torch.Tensor:
        """An epoch's batch indices (n_groups, accum, batch_size) on the
        generator's device. Weighted sampling with replacement ==
        WeightedRandomSampler; uniform == RandomSampler. A batch count
        that does not fill the last accumulation group is rounded up by
        more rows of another permutation."""
        n_batches = n // batch_size if drop_last else -(-n // batch_size)
        n_groups = max(1, -(-n_batches // self.accum))
        total = n_groups * self.accum * batch_size
        dev = gen.device
        if weights is not None:
            w = torch.as_tensor(np.asarray(weights, np.float64),
                                dtype=torch.float32, device=dev)
            idx = torch.multinomial(w, total, replacement=True, generator=gen)
        else:
            idx = torch.cat([torch.randperm(n, generator=gen, device=dev)
                             for _ in range(-(-total // n))])[:total]
        return idx.reshape(n_groups, self.accum, batch_size)

    @staticmethod
    def _stream_batch(task: Task, split, idx: np.ndarray,
                      device: torch.device) -> tuple:
        """One micro-batch of a host split on `device`: the rows gathered
        on the host (natively into a pinned buffer from a memory map)
        and copied without blocking, then laid out by the task."""
        pin = device.type == "cuda"

        def put(a) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t.pin_memory() if pin else t).to(device, non_blocking=pin)

        x = split.x
        if isinstance(x, MmapRows):
            buf = torch.empty((len(idx),) + x.sample_shape,
                              dtype=torch.float32, pin_memory=pin)
            x.gather(idx, buf.numpy())
            xs = buf.to(device, non_blocking=pin)
        else:
            xs = put(x[idx])
        y, cond = split.y, getattr(split, "cond", None)
        return task.batch_arrays(ArraySplit(
            xs, None if y is None else put(y[idx]),
            None if cond is None else put(cond[idx])))

    @staticmethod
    def _eval_batches(n: int, batch_size: int, drop_last: bool) -> list:
        """(start, stop) of each evaluation batch; without drop_last the
        remainder is a batch of its own."""
        full = n // batch_size
        out = [(i * batch_size, (i + 1) * batch_size) for i in range(full)]
        if not drop_last and n % batch_size:
            out.append((full * batch_size, n))
        return out

    # -- metric plumbing ---------------------------------------------------------

    def _ns(self, task, name: str, split: str) -> str:
        ns = getattr(task, "metric_namespace", None)
        core = f"{ns}/{name}" if ns else name
        return f"{self.metric_prefix}{split}/{core}"

    def _writes(self) -> bool:
        """Logs, prints and files come from rank 0 of a mesh only."""
        return self._par is None or self._par.writer

    def _log(self, metrics: dict, step: int) -> None:
        if self.logger is not None and self._writes():
            self.logger.log_metrics(metrics, step=step)

    def _log_ckpt_artifact(self, path: str) -> None:
        """Upload a saved checkpoint where the logger asks for it
        (`log_model`, reference WandbLogger(log_model=True))."""
        if (self.logger is None or not self._writes()
                or not getattr(self.logger, "log_model", False)):
            return
        log_artifact = getattr(self.logger, "log_artifact", None)
        if log_artifact is not None:
            log_artifact(path, name=os.path.basename(path), type_="model")

    # -- the steps -------------------------------------------------------------

    def _train_epoch(self, task: Task, opt, batch_of,
                     idx_groups: torch.Tensor, gen: torch.Generator,
                     sliced: bool = False):
        """One pass over the index groups: per group, the micro batches'
        gradients summed, divided by their number, one optimizer step.
        batch_of(idx): a micro batch's arrays on the device. sliced: on
        a mesh, the indices are this rank's slice of each batch. Returns
        (losses, {metric: values}), one entry per micro batch, on the
        device."""
        model = task.model
        params = [p for p in model.parameters() if p.requires_grad]
        par = self._par
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        losses, metrics = [], {}
        for group in idx_groups:
            opt.zero_grad()
            for idx in group:
                with (par.context(sliced) if par is not None
                      else contextlib.nullcontext()):
                    loss, m, new_state = task.loss_and_metrics(
                        batch_of(idx), train=True, generator=gen)
                    loss.backward()
                if new_state:
                    model.commit_state(new_state)
                losses.append(loss.detach())
                for k, v in m.items():
                    metrics.setdefault(k, []).append(v.detach())
            if par is not None:
                par.reduce_grads(model, named)
            if self.accum > 1:
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(self.accum)
            opt.step()
        return (torch.stack(losses),
                {k: torch.stack(v) for k, v in metrics.items()})

    @torch.no_grad()
    def evaluate(self, task: Task, split, batch_size: int, drop_last: bool,
                 split_name: str = "val") -> dict:
        """Per-batch metrics, then their mean over batches (the
        reference's f1_score_mean semantics, classification_model.py:
        154-171). On a mesh, data rank r evaluates batches r, r + n_data,
        ... whole, and every rank takes every batch's metrics from their
        ranks: the one process's numbers, on every rank."""
        arrays = self._arrays(task, split)
        batches = self._eval_batches(len(split.x), batch_size, drop_last)
        par = self._par
        mine = (batches if par is None
                else batches[par.data_index::par.n_data])
        per_batch: dict = {}
        for lo, hi in mine:
            _, m, _ = task.loss_and_metrics(tuple(a[lo:hi] for a in arrays),
                                            train=False)
            for k, v in m.items():
                per_batch.setdefault(k, []).append(v)
        per_batch = {k: torch.stack(v).double() for k, v in per_batch.items()}
        if par is not None:
            per_batch = par.gather_batches(per_batch, len(batches),
                                           arrays[0].device)
        # metric names in sorted order, as the JAX package's metric
        # dicts (pytrees) come, so that both write their logs' columns
        # in one order
        means = {k: float(v.mean().cpu())
                 for k, v in sorted(per_batch.items())}
        out = {self._ns(task, k, split_name): v for k, v in means.items()}
        if ("f1_score" in means
                and getattr(task, "metric_namespace", None) is None):
            out[f"{self.metric_prefix}{split_name}/f1_score_mean"] = \
                means["f1_score"]
            out[f"{self.metric_prefix}{split_name}/acc_mean"] = means["acc"]
        return out

    # -- fit / test --------------------------------------------------------------

    def fit(self, task: Task, datamodule, tx, opt=None,
            resume_from: str | None = None) -> FitResult:
        """Train task.model in place. tx: a train/optim spec
        (`make_radam`, `make_transformer_optimizer`); opt: an optimizer
        it built earlier, whose moments carry on (default: a new one).
        resume_from: a last.ckpt written with save_last: the weights, the
        BN statistics, the optimizer's and the scheduler's state and the
        epoch counter come back from it."""
        if datamodule.train is None:
            datamodule.setup("fit")
        model = task.model
        if self.mesh is not None:
            from ..parallel.training import MeshTraining
            self._par = MeshTraining(self.mesh, model, self.param_rules)
        flags = [(p, p.requires_grad) for p in model.parameters()]
        model.requires_grad_(True)
        try:
            return self._fit(task, datamodule, tx, opt, resume_from)
        finally:
            for p, flag in flags:
                p.requires_grad_(flag)
            self._par = None

    def _resume(self, model, opt, path: str) -> int:
        from .checkpoint import load_checkpoint, load_training_state
        name, _, sd, _ = load_checkpoint(path)
        dense = getattr(model, "dense", model)
        if name != type(dense).__name__:
            raise ValueError(f"{path} is for {name}, not "
                             f"{type(dense).__name__}")
        opt_state, sched_state, extra = load_training_state(path)
        tp = getattr(model, "tp", None)
        if tp is not None:
            sd = {k: tp.shard(k, v) for k, v in sd.items()}
            opt_state = self._par.shard_optimizer_state(opt, opt_state)
        load_state_dict_checked(model, sd)
        opt.load_state_dicts(opt_state, sched_state)
        return int(extra.get("epoch", -1)) + 1

    def _state(self, model) -> dict:
        """A copy of the weights (dense on a tensor-parallel mesh)."""
        from ..parallel.sharding import dense_state_dict
        sd = dense_state_dict(model)
        return {k: v.detach().clone() for k, v in sd.items()}

    def _save(self, model, path: str, extra: dict, opt=None) -> None:
        """model.save, from rank 0 of a mesh, with a tensor-parallel
        model's shards (and its moments) gathered dense."""
        par = self._par
        if par is None:
            model.save(path, extra=extra, optimizer=opt)
            return
        from ..parallel.sharding import dense_state_dict
        from .checkpoint import save_checkpoint
        sd = dense_state_dict(model)
        opt_sd = sched_sd = None
        if opt is not None:
            opt_sd = par.dense_optimizer_state(opt)
            sched_sd = opt.state_dicts()[1]
        if par.writer:
            dense = getattr(model, "dense", model)
            save_checkpoint(path, type(dense).__name__, dense.hparams, sd,
                            extra, optimizer_state=opt_sd,
                            scheduler_state=sched_sd)

    def _fit(self, task, datamodule, tx, opt, resume_from) -> FitResult:
        model = task.model
        par = self._par
        if opt is None:
            opt = tx.init(model)
        if par is not None:
            opt.grad_norm_fn = par.grad_norm_fn(opt.named_params)
        start_epoch = (0 if resume_from is None
                       else self._resume(model, opt, resume_from))
        train_split = datamodule.train
        batch_size = datamodule.batch_size
        weights = (datamodule.train_sampling if task.weighted_sampler
                   else None)
        drop_last = getattr(datamodule, "drop_last", False)
        device = task._device()
        if self.streaming:
            def batch_of(idx):
                return self._stream_batch(task, train_split, idx, device)
        else:
            arrays = self._arrays(task, train_split)

            def batch_of(idx):
                return tuple(a[idx] for a in arrays)

        best_score, best_epoch = None, -1
        best_state, best_path = None, None
        wait, history, stopped = 0, [], False
        sign = 1.0 if self.mode == "max" else -1.0

        epoch = start_epoch - 1
        for epoch in range(start_epoch, self.max_epochs):
            gen_samp, gen_drop = epoch_generators(self.seed, epoch, device)
            idx_groups = self._train_indices(gen_samp, len(train_split.x),
                                             batch_size, weights, drop_last)
            sliced = False
            if par is not None:
                idx_groups, sliced = par.local(idx_groups, batch_size)
            if self.streaming:
                idx_groups = idx_groups.cpu().numpy()
            profiler = self._profiler(epoch, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with profiler or contextlib.nullcontext():
                losses, tr_metrics = self._train_epoch(
                    task, opt, batch_of, idx_groups, gen_drop, sliced)
                if par is not None:
                    losses = par.mean(losses, sliced)
                    tr_metrics = {k: par.mean(v, sliced)
                                  for k, v in tr_metrics.items()}
                losses = losses.cpu().numpy()
            dt = time.perf_counter() - t0
            if profiler is not None:
                os.makedirs(self.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(
                    self.profile_dir, f"epoch{epoch}.trace.json"))
            if self.terminate_on_nan and not np.isfinite(losses).all():
                bad = int(np.flatnonzero(~np.isfinite(losses))[0])
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch}, "
                    f"micro-batch {bad}: {losses[bad]}")

            # train rows at the log_every cadence (the reference logs
            # every 50 batches, classification_model.py:115)
            tr_np = {k: v.cpu().numpy()
                     for k, v in sorted(tr_metrics.items())}
            for b in range(0, len(losses), self.log_every):
                self._log({self._ns(task, k, "train"): float(v[b])
                           for k, v in tr_np.items()},
                          step=self._step_counter + b)
            self._step_counter += len(losses)

            row = {f"train_epoch/{k}": float(np.mean(v))
                   for k, v in tr_np.items()}
            row["epoch"] = epoch
            row["train_epoch/time_s"] = dt
            row["train_epoch/batches_per_s"] = len(losses) / dt
            row["train_epoch/windows_per_s"] = len(losses) * batch_size / dt

            if (epoch + 1) % self.check_val_every == 0:
                val = self.evaluate(task, datamodule.val, batch_size,
                                    drop_last, "val")
                if self.epoch_metric_hook:
                    self.epoch_metric_hook(epoch, val)
                row.update(val)
                self._log({**val, "epoch": epoch}, step=self._step_counter)
                if self.verbose and self._writes():
                    mon = (f" {self.monitor}="
                           f"{val.get(self.monitor, float('nan')):.4f}"
                           if self.monitor else "")
                    print(f"epoch {epoch:3d} loss={float(np.mean(losses)):.4f}"
                          f"{mon} ({dt:.1f}s)")
                score = (val.get(self.monitor) if self.monitor is not None
                         else None)
                if score is not None:
                    if (best_score is None
                            or sign * (score - best_score) > self.min_delta):
                        best_score, best_epoch, wait = score, epoch, 0
                        best_state = self._state(model)
                        if self.checkpoint_dir:
                            best_path = os.path.join(
                                self.checkpoint_dir,
                                f"{self.checkpoint_name}.ckpt")
                            self._save(model, best_path, extra={
                                "epoch": epoch, self.monitor: score})
                            self._log_ckpt_artifact(best_path)
                    else:
                        wait += 1
                        if self.patience is not None and wait >= self.patience:
                            history.append(row)
                            stopped = True
                            break
            history.append(row)

        if self.checkpoint_dir and self.save_last:
            last_path = os.path.join(self.checkpoint_dir, "last.ckpt")
            self._save(model, last_path, extra={"epoch": epoch}, opt=opt)
            self._log_ckpt_artifact(last_path)
        if best_state is None:
            best_state = self._state(model)
        return FitResult(best_state, best_score, best_epoch, history,
                         best_path, stopped, opt)

    def _profiler(self, epoch: int, device: torch.device):
        """A torch.profiler session for epoch 1 where profile_dir is set."""
        if self.profile_dir is None or epoch != 1 or not self._writes():
            return None
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def test(self, task: Task, datamodule, split_name: str = "test") -> dict:
        if datamodule.train is None:
            datamodule.setup("test")
        split = getattr(datamodule, split_name)
        drop_last = getattr(datamodule, "drop_last", False)
        if self.mesh is not None:
            from ..parallel.training import MeshTraining
            self._par = MeshTraining(self.mesh, task.model, self.param_rules)
        try:
            metrics = self.evaluate(task, split, datamodule.batch_size,
                                    drop_last, split_name)
            self._log(metrics, step=self._step_counter)
            if self.verbose and self._writes():
                print(" ".join(f"{k}={v:.4f}"
                               for k, v in sorted(metrics.items())))
        finally:
            self._par = None
        return metrics

