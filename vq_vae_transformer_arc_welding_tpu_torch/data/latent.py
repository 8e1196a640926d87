"""Latent dataset materialization on the device, and the one chunking
helper of the port.

Port of vq_vae_transformer_arc_welding_tpu/data/latent.py. The
reference's offline encode loop (dataloader/latentspace_dataloader.py:
171-263) round-trips device -> host numpy per batch per cycle window;
here a whole split goes through the frozen VQ-VAE encoder in chunks:
reshape (N, n_cycles*window, C) -> (N*n_cycles, window, C), encode and
look up the nearest code on the model's device, reshape back. The host
sees only the final token or latent arrays.

Task semantics mirror the reference:
- 'classification': z_q vectors, (N, n_cycles, embedding_dim*enc_out_len)
- 'classification_ids': token ids, (N, n_cycles, enc_out_len)
- 'autoregressive_ids': ids flattened to (N, n_cycles*enc_out_len), no
  labels, built on the *reconstruction* base task (unfiltered labels,
  reference :41-48 quirk); 'autoregressive_ids_classification': same
  ids but with labels, built on the classification base task.
"""
from __future__ import annotations

import numpy as np
import torch

from .asimow import ASIMoWDataModule, CYCLE_LEN
from .datasets import ArraySplit, make_autoregressive, sampling_weights

_ENCODE_CHUNK = 4096

LATENT_TASKS = ("classification", "classification_ids", "autoregressive_ids",
                "autoregressive_ids_classification")


def _tree_map(fn, *trees):
    """fn over the leaves of tuples, lists and dicts of one structure."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _chunked_device_map(fn, x: np.ndarray, chunk: int = _ENCODE_CHUNK,
                        pipeline_depth: int = 2, device="cpu"):
    """fn over chunks of at most `chunk` rows of x on `device`; returns
    fn's outputs (a tensor, or tuples, lists and dicts of batch-leading
    tensors) concatenated along the batch, as numpy arrays.

    The JAX version pads every chunk up to `chunk` so that one compiled
    graph serves every size. PyTorch runs eagerly and compiles nothing,
    so a chunk keeps its own size and no padding rows are computed.

    The pipelining is kept: `pipeline_depth` chunks are in flight. On
    the card a chunk is staged in a pinned host buffer, copied over
    without blocking, fn is enqueued, and its outputs start their way
    back into pinned buffers, all on the current stream; the host waits
    for chunk i only after chunk i + 1 has been started, so staging and
    enqueueing one chunk overlap the card's work on the other. Outputs are
    bit-identical to the depth-1 schedule: the same fn sees the same
    chunks, only the order of the host's waits changes. The device
    holds at most `pipeline_depth` chunks' inputs and outputs."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    depth = max(pipeline_depth, 1)
    n = len(x)
    outs = []
    pending = []   # (host outputs, the event after their copy) not yet read
    staging = None
    if on_card:
        host_dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
        staging = [torch.empty((min(chunk, n),) + x.shape[1:],
                               dtype=host_dtype, pin_memory=True)
                   for _ in range(min(depth, -(-n // chunk)))]

    def to_host(y: torch.Tensor) -> torch.Tensor:
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        return host.copy_(y, non_blocking=True)

    def drain(keep: int) -> None:
        while len(pending) > keep:
            out, done = pending.pop(0)
            if done is not None:
                done.synchronize()
            outs.append(_tree_map(lambda y: y.numpy(), out))

    for i, s in enumerate(range(0, n, chunk)):
        block = x[s:s + chunk]
        if on_card:
            # buffer i % depth carried chunk i - depth, which was drained
            # before this point, so its copy to the card has ended
            buf = staging[i % len(staging)][:len(block)]
            buf.numpy()[...] = block
            out = fn(buf.to(device, non_blocking=True))
            out = _tree_map(to_host, out)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        else:
            out = fn(torch.from_numpy(np.ascontiguousarray(block)))
            done = None
        pending.append((out, done))
        drain(depth - 1)
    drain(0)
    # np.concatenate copies, so no result aliases a pinned buffer
    return _tree_map(lambda *ys: np.concatenate(ys), *outs)


class LatentPredDataModule:
    """Latent-space data module over a frozen VQ-VAE (reference
    LatentPredDataModule, latentspace_dataloader.py:294-343).

    `latent_space_model` is a VQVAEPatch of this package (`VQVAEPatch.load`,
    or cli/shared.load_vqvae_any for a reference .ckpt); the splits are
    encoded on its device, always through the exact plain encoder, so
    the tokens stay bit-comparable with `encode_tokens` and with what
    the transformer is trained on.
    """

    drop_last = False  # reference latent loaders don't set drop_last

    def __init__(self, latent_space_model, task: str, n_cycles: int,
                 val_data_ids, test_data_ids, model_name: str = "VQ-VAE-Patch",
                 model_id: str = "", batch_size: int = 32,
                 window_size: int = CYCLE_LEN, window_offset: int = 0,
                 shuffle_val_test: bool = True,
                 data_directory_path: str | None = None, seed: int = 42,
                 pipeline_depth: int = 2):
        if task not in LATENT_TASKS:
            raise ValueError(f"task {task} not supported")
        self.model = latent_space_model.eval()
        self.task = task
        self.n_cycles = n_cycles
        self.val_ids = val_data_ids
        self.test_ids = test_data_ids
        self.model_name = model_name
        self.model_id = model_id
        self.batch_size = batch_size
        self.window_size = window_size
        self.window_offset = window_offset
        self.shuffle_val_test = shuffle_val_test
        self.data_dir = data_directory_path
        self.seed = seed
        self.pipeline_depth = pipeline_depth
        self.train = self.val = self.test = None
        self.train_sampling = None
        self.num_classes = None  # set for autoregressive tasks

    @torch.inference_mode()
    def _encode_split(self, x: np.ndarray) -> np.ndarray:
        """(N, n_cycles*window, C) -> per-task latent arrays (numpy)."""
        n, _, c = x.shape
        per_cycle = x.reshape(n * self.n_cycles, self.window_size, c)
        fn = (self.model.encode_zq if self.task == "classification"
              else self.model.encode_indices)
        out = _chunked_device_map(fn, per_cycle,
                                  pipeline_depth=self.pipeline_depth,
                                  device=self.model.codebook.device)
        if self.task == "classification":              # (N*n, 16, D)
            return out.reshape(n, self.n_cycles, -1).astype(np.float32)
        ids = out.reshape(n, self.n_cycles, -1).astype(np.int64)
        if self.task == "classification_ids":
            return ids
        return ids.reshape(n, -1)                        # autoregressive

    def setup(self, stage: str = "fit"):
        base_task = ("reconstruction" if self.task == "autoregressive_ids"
                     else "classification")
        base = ASIMoWDataModule(
            task=base_task, n_cycles=self.n_cycles, val_data_ids=self.val_ids,
            test_data_ids=self.test_ids, batch_size=self.batch_size,
            window_size=self.window_size, window_offset=self.window_offset,
            data_directory_path=self.data_dir, seed=self.seed, shuffle=False)
        base.setup(stage)

        rng = np.random.default_rng(self.seed)
        splits = {}
        for name, sp in (("train", base.train), ("val", base.val),
                         ("test", base.test)):
            z = self._encode_split(sp.x)
            y = sp.y
            if self.task in ("autoregressive_ids",
                             "autoregressive_ids_classification"):
                split, num_classes = make_autoregressive(z, y)
                self.num_classes = num_classes
            else:
                split = ArraySplit(z, y)
            splits[name] = split

        # reference shuffles val/test after materialization (:56-60)
        for name in ("val", "test"):
            if self.shuffle_val_test:
                sp = splits[name]
                idx = rng.permutation(len(sp.x))
                splits[name] = ArraySplit(
                    sp.x[idx], None if sp.y is None else sp.y[idx],
                    None if sp.cond is None else sp.cond[idx])
        self.train, self.val, self.test = (splits["train"], splits["val"],
                                           splits["test"])
        if self.task != "autoregressive_ids":
            labels = (self.train.cond if self.train.cond is not None
                      else self.train.y)
            self.train_sampling = sampling_weights(labels)

    def input_shape(self):
        return self.train.x.shape[1:]
