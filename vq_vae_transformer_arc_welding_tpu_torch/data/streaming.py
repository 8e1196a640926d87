"""Memory-mapped datasets for training on data larger than the card.

Port of vq_vae_transformer_arc_welding_tpu/data/streaming.py
(`MmapDataset`, `StreamingSplit`, `_native_gather`), in the same file
format (a flat float32 `.bin`, a `.json` with the sample shape, optional
`.labels.npy`), so the two packages read each other's files. The
resident trainer puts whole splits on the card once; with
`Trainer(streaming=True)` (train/loop.py) the training split stays in
the file, and each micro-batch is gathered on the host by the native
threaded row gather (native/batch_gather.cpp) straight from the mmap
into a pinned buffer, then copied to the card without blocking. The
batches, the sampling and so the losses are those of the resident path.

Each view counts its gathers by the path they took (`MmapRows.gathers`:
'native', or 'numpy', the fallback where the native library cannot be
built), so that a caller can tell the fallback was not taken.
"""
from __future__ import annotations

import ctypes
import json
import os

import numpy as np


class MmapDataset:
    """x: (N, *sample_shape) float32 rows in a flat .bin file (mmap);
    y: optional int64 labels, resident. `x[idx]` gathers a batch."""

    def __init__(self, path: str):
        with open(path + ".json") as f:
            meta = json.load(f)
        self.sample_shape = tuple(meta["sample_shape"])
        self.n = int(meta["n"])
        self._row_elems = int(np.prod(self.sample_shape))
        self._mm = np.memmap(path + ".bin", np.float32, mode="r",
                             shape=(self.n, self._row_elems))
        ypath = path + ".labels.npy"
        self.y = np.load(ypath) if os.path.exists(ypath) else None
        self.x = MmapRows(self._mm, self.sample_shape)

    def __len__(self) -> int:
        return self.n

    @staticmethod
    def write(path: str, x: np.ndarray, y: np.ndarray | None = None) -> str:
        """Write (N, *shape) float32 samples (and labels) for streaming."""
        x = np.ascontiguousarray(x, np.float32)
        x.reshape(len(x), -1).tofile(path + ".bin")
        with open(path + ".json", "w") as f:
            json.dump({"n": int(len(x)),
                       "sample_shape": list(x.shape[1:])}, f)
        if y is not None:
            np.save(path + ".labels.npy", np.asarray(y, np.int64))
        return path


class MmapRows:
    """The batch-gather view over the mmap: rows[idx] -> (B,
    *sample_shape) contiguous float32; `gather(idx, out)` writes into a
    buffer the caller owns (a pinned one, for a copy to the card)."""

    def __init__(self, mm: np.memmap, sample_shape):
        self._mm = mm
        self.sample_shape = tuple(sample_shape)
        self.gathers = {"native": 0, "numpy": 0}

    def __len__(self) -> int:
        return self._mm.shape[0]

    @property
    def shape(self) -> tuple:
        return (len(self),) + self.sample_shape

    @property
    def dtype(self):
        return np.float32

    def gather(self, idx, out: np.ndarray) -> np.ndarray:
        """Rows idx into out, a C-contiguous float32 array of (B,
        *sample_shape)."""
        idx = np.ascontiguousarray(idx, np.int64).ravel()
        flat = out.reshape(len(idx), self._mm.shape[1])
        if _native_gather(self._mm, idx, flat):
            self.gathers["native"] += 1
        else:
            self.gathers["numpy"] += 1
            flat[:] = self._mm[idx]
        return out

    def __getitem__(self, idx) -> np.ndarray:
        idx = np.asarray(idx, np.int64).ravel()
        return self.gather(idx, np.empty((len(idx),) + self.sample_shape,
                                         np.float32))

    def __array__(self, dtype=None, copy=None):
        # the whole split (evaluation of small val and test splits)
        a = np.asarray(self._mm).reshape(self.shape)
        return a.astype(dtype) if dtype is not None else a


def _native_gather(mm: np.memmap, idx: np.ndarray, out: np.ndarray) -> bool:
    from ..native.build import load_native_lib
    lib = load_native_lib()
    if lib is None:
        return False
    got = lib.gather_rows_f32(
        ctypes.cast(ctypes.c_void_p(mm.ctypes.data),
                    ctypes.POINTER(ctypes.c_float)),
        mm.shape[1],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return got == len(idx)


class StreamingSplit:
    """An ArraySplit-shaped view of an MmapDataset: x gathered on the
    host per batch, y resident."""

    def __init__(self, ds: MmapDataset):
        self.x = ds.x
        self.y = ds.y
        self.cond = None

    def __len__(self) -> int:
        return len(self.x)
