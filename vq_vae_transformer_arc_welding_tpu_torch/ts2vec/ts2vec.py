"""TS2Vec: a self-supervised representation learner for time series.

Port of vq_vae_transformer_arc_welding_tpu/ts2vec/ts2vec.py (`TS2Vec`
with `fit`, `encode`, `save`, `load`, and `eval_classification`; the
reference's vendored model/ts2vec/ts2vec.py, from yuezhihan/ts2vec):
random crop pairs with overlap alignment, the hierarchical contrastive
loss, an SWA average of the weights for inference, AdamW, and encoding
with full_series / int / multiscale pooling, causal and sliding
windows.

It draws what the JAX package draws, in its order: crops and offsets
from `np.random.default_rng(seed)`, then one integer per step, which
seeds the step's torch.Generator on the device (the JAX package makes
its PRNG key of it); the masks and the dropout come from that
generator, or `fit(mask=)` hands the masks in. `crop_buckets` (the
JAX package's option, on by default) rounds crop lengths to powers of
two and pads the windows with NaN as it does, so the two packages cut
the same crops.

The optimizer is torch's AdamW with `optax.adamw`'s defaults, which
the JAX package uses: weight decay 1e-4 (the reference's torch AdamW
default is 1e-2; ROADMAP.md lists the difference). The model builds on
the card unless the caller names another device; the pooling runs on
the host, in numpy, as in the JAX package.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..models.base import serving_device
from .encoder import TSEncoder
from .losses import hierarchical_contrastive_loss
from .utils import (centerize_vary_length_series, pad_nan, split_with_nan,
                    take_per_row)

WEIGHT_DECAY = 1e-4     # optax.adamw's default, the JAX package's


class TS2Vec:
    def __init__(self, input_dims, output_dims=320, hidden_dims=64, depth=10,
                 device=None, lr=0.001, batch_size=16, max_train_length=None,
                 temporal_unit=0, after_iter_callback=None,
                 after_epoch_callback=None, seed=0, crop_buckets=True):
        self.device = serving_device(device)
        self.input_dims = input_dims
        self.output_dims = output_dims
        self.hidden_dims = hidden_dims
        self.depth = depth
        self.lr = lr
        self.batch_size = batch_size
        self.max_train_length = max_train_length
        self.temporal_unit = temporal_unit
        self.after_iter_callback = after_iter_callback
        self.after_epoch_callback = after_epoch_callback
        self.crop_buckets = crop_buckets
        # the encoder's representation dropout at train time
        self.repr_dropout_p = 0.1

        self.net = TSEncoder(input_dims, output_dims, hidden_dims, depth,
                             generator=torch.Generator().manual_seed(seed),
                             device=self.device)
        # SWA running average of all optimizer steps (torch AveragedModel)
        self.avg_net = copy.deepcopy(self.net)
        self.net.requires_grad_(True)
        self.n_averaged = 1
        self.n_epochs = 0
        self.n_iters = 0
        self._np_rng = np.random.default_rng(seed)

    # -- training ----------------------------------------------------------

    def _step(self, opt, x1, x2, crop_l: int, seed: int, mask) -> float:
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        x1, x2 = (torch.as_tensor(a, device=dev) for a in (x1, x2))

        def mask_of(x):
            return mask(x.shape[0], x.shape[1]) if callable(mask) else mask

        o1 = self.net(x1, mask=mask_of(x1), train=True, generator=gen,
                      repr_dropout_p=self.repr_dropout_p)[:, -crop_l:]
        o2 = self.net(x2, mask=mask_of(x2), train=True, generator=gen,
                      repr_dropout_p=self.repr_dropout_p)[:, :crop_l]
        loss = hierarchical_contrastive_loss(
            o1, o2, temporal_unit=self.temporal_unit)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        with torch.no_grad():
            na = self.n_averaged
            for a, p in zip(self.avg_net.parameters(), self.net.parameters()):
                a.add_((p - a) / (na + 1))
        self.n_averaged += 1
        return float(loss.detach())

    def fit(self, train_data, n_epochs=None, n_iters=None, verbose=False,
            mask="binomial"):
        """mask: the training mask mode, or a function (B, T) -> a (B, T)
        boolean tensor that hands each window's mask in. Returns the
        epochs' mean losses."""
        assert train_data.ndim == 3
        if n_iters is None and n_epochs is None:
            n_iters = 200 if train_data.size <= 100000 else 600

        if self.max_train_length is not None:
            sections = train_data.shape[1] // self.max_train_length
            if sections >= 2:
                train_data = np.concatenate(
                    split_with_nan(train_data, sections, axis=1), axis=0)

        temporal_missing = np.isnan(train_data).all(axis=-1).any(axis=0)
        if temporal_missing[0] or temporal_missing[-1]:
            train_data = centerize_vary_length_series(train_data)
        train_data = train_data[
            ~np.isnan(train_data).all(axis=2).all(axis=1)]

        data = np.asarray(train_data, np.float32)
        n = len(data)
        bs = min(self.batch_size, n)
        rng = self._np_rng

        opt = torch.optim.AdamW(self.net.parameters(), lr=self.lr,
                                weight_decay=WEIGHT_DECAY)
        loss_log = []
        done = False
        while not done:
            if n_epochs is not None and self.n_epochs >= n_epochs:
                break
            perm = rng.permutation(n)
            cum_loss, n_epoch_iters = 0.0, 0
            for s in range(0, n - bs + 1, bs):
                if n_iters is not None and self.n_iters >= n_iters:
                    done = True
                    break
                x = data[perm[s:s + bs]]
                if (self.max_train_length is not None
                        and x.shape[1] > self.max_train_length):
                    off = rng.integers(x.shape[1] - self.max_train_length + 1)
                    x = x[:, off:off + self.max_train_length]
                ts_l = x.shape[1]
                lo = 2 ** (self.temporal_unit + 1)
                crop_l = int(rng.integers(lo, ts_l + 1))
                if self.crop_buckets:
                    crop_l = max(lo, min(ts_l, 2 ** int(np.log2(crop_l))))
                crop_left = int(rng.integers(ts_l - crop_l + 1))
                crop_right = crop_left + crop_l
                crop_eleft = int(rng.integers(crop_left + 1))
                crop_eright = int(rng.integers(crop_right, ts_l + 1))
                crop_offset = rng.integers(-crop_eleft,
                                           ts_l - crop_eright + 1, size=bs)

                x1 = take_per_row(x, crop_offset + crop_eleft,
                                  crop_right - crop_eleft)
                x2 = take_per_row(x, crop_offset + crop_left,
                                  crop_eright - crop_left)
                if self.crop_buckets:
                    # window lengths padded up to powers of two with NaN,
                    # as the JAX package pads them: x1 is read from its
                    # right end, x2 from its left
                    lb1 = 1 << int(np.ceil(np.log2(max(x1.shape[1], 1))))
                    lb2 = 1 << int(np.ceil(np.log2(max(x2.shape[1], 1))))
                    x1 = pad_nan(x1, left=lb1 - x1.shape[1], axis=1)
                    x2 = pad_nan(x2, right=lb2 - x2.shape[1], axis=1)
                loss = self._step(opt, x1, x2, crop_l,
                                  int(rng.integers(2 ** 31)), mask)
                cum_loss += loss
                n_epoch_iters += 1
                self.n_iters += 1
                if self.after_iter_callback is not None:
                    self.after_iter_callback(self, loss)
            if done or n_epoch_iters == 0:
                break
            cum_loss /= n_epoch_iters
            loss_log.append(cum_loss)
            if verbose:
                print(f"Epoch #{self.n_epochs}: loss={cum_loss}")
            self.n_epochs += 1
            if self.after_epoch_callback is not None:
                self.after_epoch_callback(self, cum_loss)
        return loss_log

    # -- inference ---------------------------------------------------------

    def _eval_with_pooling(self, x, mask=None, slicing=None,
                           encoding_window=None):
        with torch.no_grad():
            out = self.avg_net(
                torch.as_tensor(np.asarray(x, np.float32), device=self.device),
                mask=mask if mask is not None else "all_true",
                train=False).cpu().numpy()
        if encoding_window == "full_series":
            if slicing is not None:
                out = out[:, slicing]
            out = out.max(axis=1, keepdims=True)
        elif isinstance(encoding_window, int):
            k, pad = encoding_window, encoding_window // 2
            padded = np.pad(out, ((0, 0), (pad, pad), (0, 0)),
                            constant_values=-np.inf)
            t = out.shape[1] + 2 * pad - k + 1
            win = np.stack([padded[:, i:i + k] for i in range(t)], axis=1)
            out = win.max(axis=2)
            if encoding_window % 2 == 0:
                out = out[:, :-1]
            if slicing is not None:
                out = out[:, slicing]
        elif encoding_window == "multiscale":
            p, reprs = 0, []
            while (1 << p) + 1 < out.shape[1]:
                k = (1 << (p + 1)) + 1
                pad = 1 << p
                padded = np.pad(out, ((0, 0), (pad, pad), (0, 0)),
                                constant_values=-np.inf)
                t = out.shape[1]
                win = np.stack([padded[:, i:i + k] for i in range(t)], axis=1)
                t_out = win.max(axis=2)
                if slicing is not None:
                    t_out = t_out[:, slicing]
                reprs.append(t_out)
                p += 1
            out = np.concatenate(reprs, axis=-1)
        else:
            if slicing is not None:
                out = out[:, slicing]
        return out

    def encode(self, data, mask=None, encoding_window=None, causal=False,
               sliding_length=None, sliding_padding=0, batch_size=None):
        assert data.ndim == 3
        if batch_size is None:
            batch_size = self.batch_size
        n_samples, ts_l, _ = data.shape
        data = np.asarray(data, np.float32)

        outputs = []
        for s in range(0, n_samples, batch_size):
            x = data[s:s + batch_size]
            if sliding_length is not None:
                reprs = []
                for i in range(0, ts_l, sliding_length):
                    l = i - sliding_padding
                    r = i + sliding_length + (sliding_padding if not causal
                                              else 0)
                    sl = x[:, max(l, 0):min(r, ts_l)]
                    sl = pad_nan(sl, left=-l if l < 0 else 0,
                                 right=r - ts_l if r > ts_l else 0, axis=1)
                    out = self._eval_with_pooling(
                        sl, mask,
                        slicing=slice(sliding_padding,
                                      sliding_padding + sliding_length),
                        encoding_window=encoding_window)
                    reprs.append(out)
                out = np.concatenate(reprs, axis=1)
                if encoding_window == "full_series":
                    out = out.max(axis=1)
            else:
                out = self._eval_with_pooling(x, mask,
                                              encoding_window=encoding_window)
                if encoding_window == "full_series":
                    out = out.squeeze(1)
            outputs.append(out)
        return np.concatenate(outputs, axis=0)

    # -- persistence -------------------------------------------------------

    def save(self, fn: str) -> None:
        """The averaged weights, under the reference's keys (torch.save)."""
        torch.save({k: v.detach().cpu()
                    for k, v in self.avg_net.state_dict().items()}, fn)

    def load(self, fn: str) -> None:
        self.avg_net.load_state_dict(torch.load(fn, map_location="cpu",
                                                weights_only=True))


def eval_classification(model: TS2Vec, train_data, train_labels, val_data,
                        val_labels, test_data, test_labels,
                        eval_protocol="linear"):
    """Downstream classification eval (reference ts2vec.py:336-406):
    encode full-series representations, fit an sklearn probe, report
    acc/AUPRC/F1 with the reference's metric keys. scikit-learn is
    imported here, when it is called."""
    from sklearn.metrics import average_precision_score, f1_score
    from sklearn.preprocessing import label_binarize

    from .eval_protocols import fit_knn, fit_lr, fit_svm

    assert train_labels.ndim in (1, 2)
    window = "full_series" if train_labels.ndim == 1 else None
    train_repr = model.encode(train_data, encoding_window=window)
    val_repr = model.encode(val_data, encoding_window=window)
    test_repr = model.encode(test_data, encoding_window=window)

    fit_clf = {"linear": fit_lr, "svm": fit_svm, "knn": fit_knn}.get(
        eval_protocol)
    assert fit_clf is not None, "unknown evaluation protocol"

    def merge01(a):
        return a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])

    if train_labels.ndim == 2:
        train_repr, train_labels = merge01(train_repr), merge01(train_labels)
        val_repr, val_labels = merge01(val_repr), merge01(val_labels)
        test_repr, test_labels = merge01(test_repr), merge01(test_labels)

    clf = fit_clf(train_repr, train_labels)
    val_acc = clf.score(val_repr, val_labels)
    test_acc = clf.score(test_repr, test_labels)

    if eval_protocol in ("linear", "knn"):
        y_test_score = np.argmax(clf.predict_proba(test_repr), axis=1)
        y_val_score = np.argmax(clf.predict_proba(val_repr), axis=1)
    else:
        y_test_score = clf.predict(test_repr)
        y_val_score = clf.predict(val_repr)

    classes = np.arange(train_labels.max() + 1)
    val_auprc = average_precision_score(
        label_binarize(val_labels, classes=classes), y_val_score)
    test_auprc = average_precision_score(
        label_binarize(test_labels, classes=classes), y_test_score)
    val_f1 = f1_score(val_labels, y_val_score, average="binary")
    test_f1 = f1_score(test_labels, y_test_score, average="binary")

    return y_val_score, {
        "0/val/acc": val_acc, "0/test/acc": test_acc,
        "0/val/auprc": val_auprc, "0/test/auprc": test_auprc,
        "0/val/f1score": val_f1, "0/test/f1score": test_f1,
    }
