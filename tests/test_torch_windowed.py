"""The port's on-device windows (data/windowed.py and
`window_mode='ondevice'`) against the materialized path and the JAX
package on the CPU.

As tests/test_windowed.py: the windowed view's batches are bit-equal to
the materialized windows (numpy on the host, tensors once a task has put
it on a device), the window-weighted scaler equals a fit on the
materialized windows, `window_counts` equals the brute count, and the
port's modules equal the JAX package's array for array. A fit on the
windowed split reproduces the materialized fit's losses and weights bit
for bit, with the windows gathered by index on the device.
"""
import numpy as np
import pytest
import torch

from vq_vae_transformer_arc_welding_tpu.data import (
    ASIMoWDataModule as JaxModule)
from vq_vae_transformer_arc_welding_tpu.data import windowed as jwin
from vq_vae_transformer_arc_welding_tpu_torch.data import (
    ASIMoWDataModule, get_val_test_ids, synthetic)
from vq_vae_transformer_arc_welding_tpu_torch.data.scaler import (
    StandardScaler)
from vq_vae_transformer_arc_welding_tpu_torch.data.windowed import (
    WindowedArray, fit_scaler_on_windows, window_counts)
from vq_vae_transformer_arc_welding_tpu_torch.models import MLP
from vq_vae_transformer_arc_welding_tpu_torch.train.loop import Trainer
from vq_vae_transformer_arc_welding_tpu_torch.train.optim import make_radam
from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
    ClassificationTask, ReconstructionTask, as_device_f32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("asimow_windowed_port")
    synthetic.write_synthetic_csv(str(d / "processed_asimow_dataset.csv"),
                                  n_cycles_per_run=30, extra_train_runs=3)
    return str(d)


def _modules(data_dir, cls=ASIMoWDataModule, task="classification",
             n_cycles=5, offset=0, window=200):
    ids = get_val_test_ids()
    kw = dict(task=task, n_cycles=n_cycles, val_data_ids=ids["val_ids"],
              test_data_ids=ids["test_ids"], batch_size=16,
              data_directory_path=data_dir, window_offset=offset,
              window_size=window, cache=False)
    a, b = cls(**kw), cls(**kw, window_mode="ondevice")
    a.setup()
    b.setup()
    return a, b


@pytest.mark.parametrize("n_cycles,offset,window", [(5, 0, 200),
                                                    (3, 20, 150)])
def test_windowed_splits_bit_equal_materialized_and_jax(data_dir, n_cycles,
                                                        offset, window):
    mat, dev = _modules(data_dir, n_cycles=n_cycles, offset=offset,
                        window=window)
    jmat, jdev = _modules(data_dir, JaxModule, n_cycles=n_cycles,
                          offset=offset, window=window)
    for name in ("train", "val", "test"):
        sa, sb, jb = (getattr(m, name) for m in (mat, dev, jdev))
        assert isinstance(sb.x, WindowedArray)
        assert sb.x.shape == sa.x.shape and len(sb.x) == len(sa.x)
        np.testing.assert_array_equal(sb.x.materialize(), sa.x)
        np.testing.assert_array_equal(sb.y, sa.y)
        np.testing.assert_array_equal(sb.x.cycles, np.asarray(jb.x.cycles))
        np.testing.assert_array_equal(sb.x.starts, np.asarray(jb.x.starts))
        np.testing.assert_array_equal(sb.y, jb.y)
    np.testing.assert_array_equal(dev.scaler.mean_, jdev.scaler.mean_)
    np.testing.assert_array_equal(dev.scaler.scale_, jdev.scaler.scale_)
    np.testing.assert_allclose(dev.scaler.mean_, mat.scaler.mean_,
                               rtol=1e-10)
    np.testing.assert_allclose(dev.scaler.scale_, mat.scaler.scale_,
                               rtol=1e-10)
    np.testing.assert_array_equal(dev.train_sampling, jdev.train_sampling)


def test_windowed_batches_on_the_device_bit_equal(data_dir):
    """Gathered by index (a tensor of indices, as the trainer draws them)
    and by slice (the evaluation's batches) after `as_device_f32`."""
    mat, dev = _modules(data_dir, n_cycles=4)
    on = as_device_f32(dev.train.x, torch.device("cpu"))
    assert isinstance(on, WindowedArray)
    assert on.cycles.dtype == torch.float32 and on.starts.dtype == torch.int64
    idx = torch.tensor([3, 0, 17, 5, 5])
    np.testing.assert_array_equal(on[idx].numpy(), mat.train.x[idx.numpy()])
    np.testing.assert_array_equal(on[2:9].numpy(), mat.train.x[2:9])
    np.testing.assert_array_equal(dev.train.x[np.array([1, 4])],
                                  mat.train.x[[1, 4]])
    assert on.shape == mat.train.x.shape and len(on) == len(mat.train.x)


def test_port_window_counts_and_scaler_fit():
    for n_total, seq in ((23, 5), (40, 1), (9, 8)):
        c = window_counts(n_total, seq)
        brute = np.zeros(n_total, np.int64)
        for i in range(n_total - seq):
            brute[i:i + seq] += 1
        np.testing.assert_array_equal(c, brute)
        np.testing.assert_array_equal(c, jwin.window_counts(n_total, seq))
    rng = np.random.default_rng(0)
    cycles = rng.standard_normal((23, 7, 2)).astype(np.float32)
    idx = np.arange(18)[:, None] + np.arange(5)
    windows = cycles[idx].reshape(18, -1, 2)
    ref = StandardScaler().fit(windows)
    ours = fit_scaler_on_windows(StandardScaler(), cycles, 5)
    np.testing.assert_allclose(ours.mean_, ref.mean_, rtol=1e-12)
    np.testing.assert_allclose(ours.scale_, ref.scale_, rtol=1e-12)


@pytest.mark.parametrize("task", ["classification", "reconstruction"])
def test_windowed_fit_equals_materialized_fit(data_dir, task):
    """The same seeds over the two splits: bit-equal losses and weights
    (the windows are gathered on the device by index, never built)."""
    mat, dev = _modules(data_dir, task=task, n_cycles=3)
    results = []
    for dm in (mat, dev):
        if task == "classification":
            model = MLP(input_size=600, output_size=2, in_dim=2,
                        hidden_sizes=16, n_hidden_layers=1, dropout_p=0.1,
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
            t = ClassificationTask(model)
        else:
            from vq_vae_transformer_arc_welding_tpu_torch.models import (
                VQVAEPatch)
            model = VQVAEPatch(16, 2, 8, 4, 1, seq_len=600, device="cpu",
                               generator=torch.Generator().manual_seed(0))
            t = ReconstructionTask(model)
        res = Trainer(max_epochs=2, seed=3, verbose=False,
                      accumulate_grad_batches=2).fit(t, dm, make_radam(1e-3))
        results.append(([h["train_epoch/loss"] for h in res.history],
                        model.state_dict()))
    assert results[0][0] == results[1][0]
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k
