"""Batched serving: welding windows -> quality labels.

Port of vq_vae_transformer_arc_welding_tpu/serve.py
(`WeldingQualityPipeline`: `__init__`, `calibrate`, `classify`,
`encode_tokens`, the in-path saturation monitor). Artifacts, OOD
scores, sampling, meshes and the int8 encoder are not ported yet.

Chunking follows data/latent.py::_chunked_device_map: requests run in
chunks of at most `max_batch` windows. The JAX version padded every
chunk up to `max_batch` so that one compiled graph served every size;
PyTorch runs eagerly and compiles nothing, so a chunk keeps its own
size and no padding rows are computed.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .ops.fused_encoder import encode_indices_fused, pack_encoder

# samples per welding cycle (data/asimow.py::CYCLE_LEN of the JAX package)
CYCLE_LEN = 200


def with_start_token(ids: torch.Tensor, start_token: int) -> torch.Tensor:
    """(B, n) ids -> (B, n + 1) with the start token in front."""
    start = torch.full((ids.shape[0], 1), start_token, dtype=ids.dtype,
                       device=ids.device)
    return torch.cat([start, ids], dim=1)


class WeldingQualityPipeline:
    """Encode + VQ + transformer-classify over a VQVAEPatch and a
    TransformerDecoder of this package (their parameters' device is the
    serving device)."""

    #: classify() warns and sets needs_recalibration when the monitored
    #: clipped-activation fraction exceeds this
    saturation_threshold: float = 0.01

    def __init__(self, vqvae, transformer, n_cycles: int,
                 max_batch: int = 64, precision: str = "f32",
                 start_token: int | None = None, encoder_impl: str = "xla",
                 monitor_saturation: bool = True):
        """precision: 'f32' (exact) or 'int8' (calibrated int8 with the
        fused attention half per block; call calibrate() first).

        encoder_impl: 'xla' keeps classify()'s encoder on the plain
        PyTorch path (the name is the JAX package's); 'fused' runs the
        resblock chain through the encoder kernel. encode_tokens() and
        calibrate() always use the plain encoder, as in the JAX package.
        The kernel's weight operands are packed here, once: the pipeline
        serves the encoder weights it was constructed with, as the JAX
        pipeline serves the params it was given.

        start_token: the <start> id the transformer was trained with
        (observed max id + 1); the default assumes every code is used.

        TF32 is switched off for matmuls and cuDNN, process-wide: the
        codebook ids must stay bit-comparable with the exact f32
        reference, and the exact-f32 int8 products of the class head
        rely on full f32 accumulation."""
        if precision not in ("f32", "int8"):
            raise ValueError(f"precision {precision!r}: 'f32' or 'int8'")
        if encoder_impl not in ("xla", "fused"):
            raise ValueError(f"encoder_impl {encoder_impl!r}: 'xla' or "
                             f"'fused'")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.vq_model = vqvae.eval()
        self.tr_model = transformer.eval()
        self.device = vqvae.codebook.device
        self.n_cycles = n_cycles
        self.max_batch = max_batch
        self.precision = precision
        self.encoder_impl = encoder_impl
        self._encoder_pack = None
        if encoder_impl == "fused":
            with torch.no_grad():
                self._encoder_pack = pack_encoder(self.vq_model)
        self.monitor_saturation = monitor_saturation
        self.start_token = (start_token if start_token is not None
                            else vqvae.num_embeddings)
        self.qparams = None
        self.last_saturation_rate: float | None = None
        self.needs_recalibration = False

    # -- per-chunk cores ---------------------------------------------------

    def _encode_fn(self, x: torch.Tensor, *, fused: bool = False):
        b = x.shape[0]
        cycles = x.reshape(b * self.n_cycles, CYCLE_LEN, 2)
        if fused and self._encoder_pack is not None:
            ids = encode_indices_fused(self.vq_model, self._encoder_pack,
                                       cycles)
        else:
            ids = self.vq_model.encode_indices(cycles)
        return ids.reshape(b, self.n_cycles * self.vq_model.enc_out_len)

    def _classify_fn(self, x: torch.Tensor):
        ids = with_start_token(self._encode_fn(x, fused=True),
                               self.start_token)
        if self.precision == "int8":
            if self.qparams is None:
                raise RuntimeError(
                    "precision='int8' requires calibrate(sample) first")
            from .models.quantized import quantized_classify
            sat_rows = [] if self.monitor_saturation else None
            logits = quantized_classify(self.tr_model, self.qparams, ids,
                                        block_fusion="attn",
                                        sat_rows=sat_rows)
            if sat_rows:
                return (torch.softmax(logits, dim=-1),
                        torch.stack(sat_rows).mean(dim=0))
        else:
            logits = self.tr_model.apply(ids, generate=False)
        return torch.softmax(logits, dim=-1)

    # -- public API ------------------------------------------------------------

    @torch.inference_mode()
    def _batched(self, fn, x: np.ndarray):
        """fn over chunks of at most max_batch rows; outputs (an array or
        a tuple of arrays) are concatenated along the batch."""
        outs = [fn(torch.as_tensor(x[s:s + self.max_batch]).to(self.device))
                for s in range(0, len(x), self.max_batch)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts).cpu().numpy()
                         for parts in zip(*outs))
        return torch.cat(outs).cpu().numpy()

    @staticmethod
    def _windows(windows, what: str) -> np.ndarray:
        windows = np.ascontiguousarray(windows, np.float32)
        if windows.shape[0] == 0:
            raise ValueError(f"{what}: windows is empty")
        return windows

    def calibrate(self, sample_windows: np.ndarray,
                  max_samples: int | None = None) -> dict:
        """Calibrate the int8 activation scales on representative windows
        (required before classify() when precision='int8'). Returns the
        absmax table."""
        from .models.quantized import (calibrate_activation_absmax,
                                       quantize_transformer)
        if max_samples is not None:
            sample_windows = sample_windows[:max_samples]
        ids = self.encode_tokens(sample_windows)
        with torch.inference_mode():
            ids = with_start_token(torch.as_tensor(ids).to(self.device),
                                   self.start_token)
            am = calibrate_activation_absmax(self.tr_model, ids)
            self.qparams = quantize_transformer(self.tr_model, act_absmax=am)
        return am

    def _note_saturation(self, rate: float) -> None:
        self.last_saturation_rate = rate
        if rate > self.saturation_threshold:
            self.needs_recalibration = True
            warnings.warn(
                f"int8 activation saturation {rate:.2%} exceeds "
                f"{self.saturation_threshold:.2%}: serving distribution "
                "has drifted beyond calibration; recalibrate() on recent "
                "windows or fall back to precision='f32'",
                RuntimeWarning, stacklevel=3)

    def classify(self, windows: np.ndarray):
        """windows: (N, n_cycles*200, 2) scaled cycles. Returns
        (labels (N,), probs (N, 2)) as numpy arrays. int8 pipelines also
        update `last_saturation_rate` from the in-path counter."""
        out = self._batched(self._classify_fn,
                            self._windows(windows, "classify"))
        if isinstance(out, tuple):
            probs, sat = out
            self._note_saturation(float(np.mean(sat)))
        else:
            probs = out
        return probs.argmax(-1), probs

    def encode_tokens(self, windows: np.ndarray) -> np.ndarray:
        """(N, n_cycles*200, 2) -> (N, n_cycles*16) int32 codebook ids,
        always from the plain (exact) encoder."""
        return self._batched(self._encode_fn,
                             self._windows(windows, "encode_tokens"))
