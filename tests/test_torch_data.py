"""The port's host-side data modules and its latent data module against
the JAX package's, array for array, on the CPU.

The numpy modules are the port's own copies: they must return the very
arrays the JAX package returns from the same file and seed (equality,
no tolerance). The synthetic CSV is compared byte for byte. The latent
data module encodes through bridged weights: token ids equal JAX's
exactly, z_q latents to 1e-5 (two f32 encoders that sum in other
orders), the val/test order (the same numpy stream) included.
`_chunked_device_map` is held to the JAX contract: any pipeline depth
gives the bits of depth 1.
"""
import warnings

import numpy as np
import pytest
import torch

from vq_vae_transformer_arc_welding_tpu.data import (
    asimow as jasimow, datasets as jdatasets, latent as jlatent,
    scaler as jscaler, splits as jsplits, synthetic as jsynthetic)
from vq_vae_transformer_arc_welding_tpu_torch.cli import shared
from vq_vae_transformer_arc_welding_tpu_torch.data import (
    asimow, datasets, latent, scaler, splits, synthetic)
from vq_vae_transformer_arc_welding_tpu_torch.native import (
    build as native_build, csv_loader)

import torch_port_helpers as H

CSV_KW = dict(n_cycles_per_run=12, extra_train_runs=2, seed=3)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A data root with the synthetic CSV under the name both data
    modules look for."""
    root = tmp_path_factory.mktemp("data")
    synthetic.write_synthetic_csv(
        str(root / "processed_asimow_dataset.csv"), **CSV_KW)
    return root


def _ids():
    ids = splits.get_val_test_ids()
    return ids["val_ids"], ids["test_ids"]


@pytest.mark.parametrize("label_process", ["iid", "markov"])
def test_synthetic_csv_byte_for_byte(tmp_path, label_process):
    kw = dict(CSV_KW, label_process=label_process)
    ours = synthetic.write_synthetic_csv(str(tmp_path / "a.csv"), **kw)
    ref = jsynthetic.write_synthetic_csv(str(tmp_path / "b.csv"), **kw)
    assert open(ours, "rb").read() == open(ref, "rb").read()


def test_split_ids_equal_jax():
    assert splits.get_val_test_ids() == jsplits.get_val_test_ids()
    assert repr(splits.DataSplitId(3, 32)) == repr(jsplits.DataSplitId(3, 32))
    ours = splits.select_random_val_test_ids(np.random.default_rng(5))
    ref = jsplits.select_random_val_test_ids(np.random.default_rng(5))
    assert ours == ref
    assert shared.parse_split_ids([(1, 2)]) == [splits.DataSplitId(1, 2)]


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_load_asimow_csv_equals_jax(data_dir, use_native):
    path = str(data_dir / "processed_asimow_dataset.csv")
    with warnings.catch_warnings():
        warnings.simplefilter("error")    # the native parser must be there
        ours = asimow.load_asimow_csv(path, use_native=use_native)
    ref = jasimow.load_asimow_csv(path, use_native=use_native)
    assert ours[0].shape == (12 * 18, 200, 2) and ours[0].dtype == np.float32
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_native_library_is_the_ports_own():
    """Built from the port's sources into the port's build directory."""
    assert csv_loader.native_available(), native_build.native_load_error()
    lib = native_build.build_native_lib()
    assert "vq_vae_transformer_arc_welding_tpu_torch/_build/" in lib
    assert csv_loader.parse_asimow_csv_native("/nonexistent.csv") is None


def test_native_failure_falls_back_loudly(data_dir, monkeypatch):
    path = str(data_dir / "processed_asimow_dataset.csv")
    monkeypatch.setattr(csv_loader, "parse_asimow_csv_native",
                        lambda p: None)
    with pytest.warns(RuntimeWarning, match="native CSV parser unavailable"):
        got = asimow.load_asimow_csv(path)
    np.testing.assert_array_equal(
        got[0], asimow.load_asimow_csv(path, use_native=False)[0])


def test_create_sequence_windows_equals_jax(rng):
    x = rng.standard_normal((30, 200, 2)).astype(np.float32)
    y = rng.integers(0, 2, 30)
    for kw in ({}, {"window_size": 150, "window_offset": 20}):
        ours = asimow.create_sequence_windows(x, y, 4, **kw)
        ref = jasimow.create_sequence_windows(x, y, 4, **kw)
        np.testing.assert_array_equal(ours[0], ref[0])
        np.testing.assert_array_equal(ours[1], ref[1])


def test_scaler_equals_jax(rng):
    x = (rng.standard_normal((50, 40, 2)) * [3.0, 40.0] + [20.0, 100.0])
    x = x.astype(np.float32)
    ours, ref = scaler.StandardScaler().fit(x), jscaler.StandardScaler().fit(x)
    np.testing.assert_array_equal(ours.mean_, ref.mean_)
    np.testing.assert_array_equal(ours.scale_, ref.scale_)
    np.testing.assert_array_equal(ours.transform(x), ref.transform(x))
    np.testing.assert_array_equal(ours.inverse_transform(ours.transform(x)),
                                  ref.inverse_transform(ref.transform(x)))


def test_label_transforms_equal_jax(rng):
    ids = rng.integers(0, 30, (12, 8))
    labels = rng.integers(0, 2, 12)
    for lab in (labels, None):
        (a, na), (b, nb) = (m.make_autoregressive(ids, lab)
                            for m in (datasets, jdatasets))
        assert na == nb
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(datasets.sampling_weights(labels),
                                  jdatasets.sampling_weights(labels))
    x = rng.standard_normal((12, 3))
    for fn in ("shuffle_arrays", "shuffle_and_undersample"):
        ours = getattr(datasets, fn)(np.random.default_rng(1), x, labels)
        ref = getattr(jdatasets, fn)(np.random.default_rng(1), x, labels)
        for u, v in zip(ours, ref):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("task,n_cycles", [("classification", 2),
                                           ("classification_ids", 1),
                                           ("reconstruction", 3)])
def test_asimow_data_module_equals_jax(data_dir, task, n_cycles):
    val, test = _ids()
    kw = dict(task=task, n_cycles=n_cycles, val_data_ids=val,
              test_data_ids=test, data_directory_path=str(data_dir),
              cache=False)
    ours, ref = asimow.ASIMoWDataModule(**kw), jasimow.ASIMoWDataModule(**kw)
    ours.setup()
    ref.setup()
    np.testing.assert_array_equal(ours.scaler.mean_, ref.scaler.mean_)
    np.testing.assert_array_equal(ours.scaler.scale_, ref.scaler.scale_)
    for name in ("train", "val", "test"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert len(a) == len(b) > 0
        for u, v in zip(a, b):
            assert (u is None) == (v is None)
            if u is not None:
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
    if task != "reconstruction":
        np.testing.assert_array_equal(ours.train_sampling,
                                      ref.train_sampling)
    assert ours.input_shape() == ref.input_shape()


def test_asimow_cache_and_npy_export(data_dir, tmp_path):
    """`_load_cached` writes the .npz once and reads it back equal;
    `load_npy_data` exports the module's six arrays."""
    import shutil
    root = tmp_path / "root"
    root.mkdir()
    shutil.copy(data_dir / "processed_asimow_dataset.csv", root)
    first = asimow._load_cached(str(root))
    assert (root / "quality_prediction_data" / "asimow"
            / "dataset.npz").exists()
    again = asimow._load_cached(str(root))
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)

    class Config:
        batch_size, n_cycles, data_dir = 8, 2, str(root)

    val, test = _ids()
    ours = asimow.load_npy_data(Config, val, test)
    ref = jasimow.load_npy_data(Config, val, test)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_ondevice_windows_wait_for_their_module():
    """data/windowed.py is ported: 'ondevice' builds (the windows
    themselves are held against the materialized ones in
    tests/test_torch_windowed.py); another mode is refused."""
    val, test = _ids()
    dm = asimow.ASIMoWDataModule("classification", 2, val, test,
                                 window_mode="ondevice")
    assert dm.window_mode == "ondevice"
    with pytest.raises(ValueError):
        asimow.ASIMoWDataModule("classification", 2, val, test,
                                window_mode="other")


def test_get_data_path_reads_dotenv(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert asimow.get_data_path() == jasimow.get_data_path() == "data"
    (tmp_path / ".env").write_text("# cluster\nPLEIADES=1\n")
    monkeypatch.setenv("SLURM_JOB_ID", "77")
    assert asimow.get_data_path() == jasimow.get_data_path()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_chunked_map_any_depth_gives_depth_one_bits(depth):
    """Multi-chunk and ragged-tail outputs, tensors and pytrees, and the
    fn sees every chunk exactly once, in order."""
    x = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)  # 3 chunks of 4
    calls = []

    def fn(b):
        calls.append(b[:, 0].numpy().copy())
        return b * 2.0, {"s": b.sum(-1), "pair": [b[:, :1], b[:, 1:]]}

    y, t = latent._chunked_device_map(fn, x, chunk=4, pipeline_depth=depth)
    assert [len(c) for c in calls] == [4, 4, 3]
    np.testing.assert_array_equal(np.concatenate(calls), x[:, 0])
    np.testing.assert_array_equal(y, x * 2.0)
    np.testing.assert_array_equal(t["s"], x.sum(-1))
    np.testing.assert_array_equal(t["pair"][1], x[:, 1:])
    one = latent._chunked_device_map(lambda b: b + 1, x[:3], chunk=4,
                                     pipeline_depth=depth)
    np.testing.assert_array_equal(one, x[:3] + 1)


@pytest.mark.parametrize("task", latent.LATENT_TASKS)
def test_latent_data_module_equals_jax(data_dir, task):
    jm, params, state = H.jax_vqvae(False)
    val, test = _ids()
    kw = dict(task=task, n_cycles=H.N_CYCLES, val_data_ids=val,
              test_data_ids=test, data_directory_path=str(data_dir))
    ref = jlatent.LatentPredDataModule((jm, params, state), **kw)
    ours = latent.LatentPredDataModule(H.port_vqvae(False), **kw)
    ref.setup()
    ours.setup()
    assert ours.num_classes == ref.num_classes
    for name in ("train", "val", "test"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert len(a) == len(b) > 0
        for u, v in zip(a, b):
            assert (u is None) == (v is None)
            if u is None:
                continue
            assert u.dtype == v.dtype and u.shape == v.shape
            if u.dtype == np.float32:      # z_q latents
                np.testing.assert_allclose(u, v, rtol=0, atol=1e-5)
            else:                          # ids and labels, val/test order
                np.testing.assert_array_equal(u, v)
    if task == "autoregressive_ids":
        assert ours.train_sampling is None
    else:
        np.testing.assert_array_equal(ours.train_sampling,
                                      ref.train_sampling)
    assert ours.input_shape() == ref.input_shape()


def test_latent_ids_are_encode_tokens(data_dir):
    """The data module's ids are the serving pipeline's tokens of the
    same windows, whatever the pipeline depth."""
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        WeldingQualityPipeline)
    vq = H.port_vqvae(False)
    val, test = _ids()
    mods = []
    for depth in (1, 2):
        dm = latent.LatentPredDataModule(
            vq, "autoregressive_ids_classification", H.N_CYCLES, val, test,
            data_directory_path=str(data_dir), shuffle_val_test=False,
            pipeline_depth=depth)
        dm.setup()
        mods.append(dm)
    base = asimow.ASIMoWDataModule(
        "classification", H.N_CYCLES, val, test,
        data_directory_path=str(data_dir), shuffle=False)
    base.setup()
    pipe = WeldingQualityPipeline(vq, H.port_transformer(),
                                  n_cycles=H.N_CYCLES, max_batch=7)
    for name in ("train", "test"):
        tokens = pipe.encode_tokens(getattr(base, name).x)
        for dm in mods:
            np.testing.assert_array_equal(getattr(dm, name).x[:, 1:], tokens)
            np.testing.assert_array_equal(getattr(dm, name).cond,
                                          getattr(base, name).y)


def test_get_latent_dataloader_from_a_checkpoint(data_dir, tmp_path):
    vq = H.port_vqvae(False)
    path = str(tmp_path / "VQ-VAE-Patch-best.ckpt")
    vq.save(path)
    val, test = _ids()
    dm, config = shared.get_latent_dataloader(
        False, H.N_CYCLES, path, val, test, batch_size=8,
        task="classification_ids", data_directory_path=str(data_dir),
        device="cpu")
    assert config == {"num_embeddings": H.K, "patch_size": 25,
                      "latent_dim": 16 * 16}
    assert dm.model_id == "VQ-VAE-Patch-best.ckpt"
    dm.setup()
    assert dm.train.x.shape[1:] == (H.N_CYCLES, 16)
    assert dm.train.x.dtype == np.int64 and dm.train.x.max() < H.K
    with pytest.raises(ImportError, match="wandb"):
        shared.get_latent_dataloader(True, H.N_CYCLES, "entity/model-v1",
                                     val, test, 8, "classification_ids")
    with pytest.raises(ValueError, match="not supported"):
        latent.LatentPredDataModule(vq, "reconstruction", 2, val, test)
