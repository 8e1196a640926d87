"""The port's streaming path (data/streaming.py, native/batch_gather.cpp,
`Trainer(streaming=True)`) against the JAX package and the resident fit
on the CPU.

As tests/test_streaming.py: the memory-mapped dataset round-trips, its
gather equals numpy's, the native gather of the port's own library
equals numpy's and the JAX package's, the two packages read each
other's files, and a streaming fit reproduces the resident fit's losses
and weights bit for bit (weighted sampling, accumulation, dropout).
Streaming over a mesh raises, as in the JAX package.
"""
import numpy as np
import pytest
import torch

from vq_vae_transformer_arc_welding_tpu.data import streaming as jstream
from vq_vae_transformer_arc_welding_tpu_torch.data import (ArraySplit,
                                                           sampling_weights)
from vq_vae_transformer_arc_welding_tpu_torch.data import streaming
from vq_vae_transformer_arc_welding_tpu_torch.models import MLP
from vq_vae_transformer_arc_welding_tpu_torch.native import build
from vq_vae_transformer_arc_welding_tpu_torch.train.loop import Trainer
from vq_vae_transformer_arc_welding_tpu_torch.train.optim import make_radam
from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
    ClassificationTask)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_data(rng, n=200, t=40, c=2):
    y = rng.integers(0, 2, n).astype(np.int64)
    x = rng.standard_normal((n, t, c)).astype(np.float32)
    x[y == 1] += 0.8
    return x, y


def test_mmap_dataset_round_trip_and_the_jax_format(tmp_path, rng):
    x, y = _toy_data(rng)
    mine = streaming.MmapDataset.write(str(tmp_path / "port"), x, y)
    theirs = jstream.MmapDataset.write(str(tmp_path / "jax"), x, y)
    for path in (mine, theirs):
        ds = streaming.MmapDataset(path)
        assert len(ds) == len(x) and ds.x.shape == x.shape
        np.testing.assert_array_equal(ds.y, y)
        np.testing.assert_array_equal(np.asarray(ds.x), x)
    jds = jstream.MmapDataset(mine)
    idx = rng.integers(0, len(x), 37)
    ds = streaming.MmapDataset(mine)
    np.testing.assert_array_equal(ds.x[idx], x[idx])
    np.testing.assert_array_equal(ds.x[idx], jds.x[idx])
    split = streaming.StreamingSplit(ds)
    assert len(split) == len(x) and split.cond is None


def test_port_native_gather_equals_numpy_and_jax(rng):
    assert build.load_native_lib() is not None, build.native_load_error()
    assert "vq_vae_transformer_arc_welding_tpu_torch/_build/" in (
        build.build_native_lib())
    mm = np.ascontiguousarray(
        rng.standard_normal((500, 96)).astype(np.float32))
    for n in (333, 5000):       # one thread, then several
        idx = rng.integers(0, 500, n).astype(np.int64)
        out, ref = (np.empty((n, 96), np.float32) for _ in range(2))
        assert streaming._native_gather(mm, idx, out)
        np.testing.assert_array_equal(out, mm[idx])
        if jstream._native_gather(mm, idx, ref):
            np.testing.assert_array_equal(out, ref)


def test_gather_into_a_given_buffer_counts_its_path(tmp_path, rng,
                                                    monkeypatch):
    x, y = _toy_data(rng, n=50)
    ds = streaming.MmapDataset(streaming.MmapDataset.write(
        str(tmp_path / "d"), x, y))
    buf = torch.empty((7, 40, 2))
    ds.x.gather([4, 1, 1, 49, 0, 3, 2], buf.numpy())
    np.testing.assert_array_equal(buf.numpy(), x[[4, 1, 1, 49, 0, 3, 2]])
    assert ds.x.gathers == {"native": 1, "numpy": 0}
    monkeypatch.setattr(streaming, "_native_gather", lambda *a: False)
    np.testing.assert_array_equal(ds.x[[2, 2]], x[[2, 2]])
    assert ds.x.gathers == {"native": 1, "numpy": 1}


class _DM:
    drop_last = True
    batch_size = 16

    def __init__(self, train, val, weights):
        self.train, self.val, self.test = train, val, val
        self.train_sampling = weights


def test_port_streaming_fit_bit_equals_resident(tmp_path, rng):
    """Same seeds, same data: the streamed epoch (each micro-batch
    gathered on the host) reproduces the resident one's losses and
    weights bit for bit, with accumulation, weighted sampling and
    dropout."""
    x, y = _toy_data(rng)
    xv, yv = _toy_data(rng, n=64)
    weights = sampling_weights(y)
    path = streaming.MmapDataset.write(str(tmp_path / "train"), x, y)
    runs = {}
    for name, train, stream in (
            ("resident", ArraySplit(x, y), False),
            ("streamed", streaming.StreamingSplit(
                streaming.MmapDataset(path)), True)):
        model = MLP(input_size=40, output_size=2, in_dim=2, hidden_sizes=16,
                    n_hidden_layers=1, dropout_p=0.1, device="cpu",
                    generator=torch.Generator().manual_seed(0))
        res = Trainer(max_epochs=3, seed=5, verbose=False,
                      accumulate_grad_batches=2, streaming=stream,
                      monitor="val/f1_score_mean", mode="max").fit(
            ClassificationTask(model), _DM(train, ArraySplit(xv, yv),
                                           weights),
            make_radam(1e-3, clip_norm=0.5))
        runs[name] = ([h["train_epoch/loss"] for h in res.history],
                      res.best_score, model.state_dict(), train)
    assert runs["resident"][:2] == runs["streamed"][:2]
    for k, v in runs["resident"][2].items():
        assert torch.equal(v, runs["streamed"][2][k]), k
    # 3 epochs of 12 batches (200 // 16), rounded up to full groups of 2
    assert runs["streamed"][3].x.gathers == {"native": 36, "numpy": 0}


def test_port_streaming_with_a_mesh_raises():
    with pytest.raises(NotImplementedError, match="streaming"):
        Trainer(streaming=True, mesh=object())
