"""Batched serving: welding windows -> quality labels.

Port of vq_vae_transformer_arc_welding_tpu/serve.py
(`WeldingQualityPipeline`: `__init__` with `precision` 'f32', 'bf16' and
'int8', `calibrate`, `classify`, `encode_tokens`, `ood_score`,
`sample_tokens`, the in-path saturation monitor, the `saturation_rate`
probe, the opt-in int8 encoder, `encoder_precision='int8'`, the
`scaler` attribute, and the deployment side: `save_artifact`,
`load_artifact`, `from_checkpoints`), and serving over a device mesh
(`mesh=`).

Requests run through data/latent.py::_chunked_device_map in chunks of
at most `max_batch` windows, two chunks in flight; a chunk keeps its
own size (nothing is compiled, so nothing is padded).

With a mesh (parallel/mesh.make_mesh) the pipeline holds one replica
per 'data' device: itself on its own device, elsewhere a copy of its
models with the int8 tables derived again from its absmax tables,
bit-identical. A chunk is padded to a multiple of the 'data' size,
split, run by the replicas at once (a thread each; replicas that share
a card share its stream), gathered on the pipeline's device and cropped
per output leaf, as the JAX pipeline's shard_map wrapper does. The int8
path's (probs, saturation) pair is cropped leaf by leaf, so
`last_saturation_rate` is the global count over the global total, the
value without a mesh.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import warnings

import numpy as np
import torch

from .data.latent import _chunked_device_map
from .ops.fused_encoder import encode_indices_fused, pack_encoder

# samples per welding cycle (data/asimow.py::CYCLE_LEN of the JAX package)
CYCLE_LEN = 200


@contextlib.contextmanager
def exact_f32():
    """Both TF32 flags (matmul and cuDNN) off inside, the caller's
    values back after: the codebook ids stay bit-comparable with the
    exact f32 reference, and the exact-f32 int8 products
    (ops/int8.py) need full f32 sums. The JAX package sets no global
    precision; neither does this one outside a pipeline's calls."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _exact(method):
    """The pipeline's method run under `exact_f32`."""
    @functools.wraps(method)
    def run(*args, **kwargs):
        with exact_f32():
            return method(*args, **kwargs)
    return run


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
                 start_token: int | None = None,
                 encoder_precision: str = "f32", encoder_impl: str = "xla",
                 monitor_saturation: bool = True, mesh=None):
        """precision: 'f32' (exact), 'bf16' (the transformer's
        `compute_dtype`: bf16 activations and products between the ops,
        f32 scores and logits; it sets the option on the transformer it
        is given, as the JAX pipeline does) or 'int8' (calibrated int8
        with the fused attention half per block; call calibrate()
        first).

        encoder_precision: 'int8' (opt-in, call calibrate() first)
        quantizes the encoder's center-tap products. It then serves
        every entry, encode_tokens() included, and the codebook ids are
        no longer bit-comparable with the f32 encoder's: measure the
        flip rate and the label agreement on your checkpoint first
        (models/quantized.encode_indices_quantized).

        encoder_impl: 'xla' keeps classify()'s encoder on the plain
        PyTorch path (the name is the JAX package's); 'fused' runs the
        resblock chain through the encoder kernel. encode_tokens() and
        calibrate() always use the plain encoder, as in the JAX package.
        With a `vq_impl='pallas'` model the plain encoder's nearest-code
        search is the fused kernel of ops/fused_vq.py.
        The kernel's weight operands are packed here, once: the pipeline
        serves the encoder weights it was constructed with, as the JAX
        pipeline serves the params it was given.

        start_token: the <start> id the transformer was trained with
        (observed max id + 1); the default assumes every code is used.

        mesh: a parallel/mesh.Mesh with a 'data' axis; every batched
        entry point (classify, encode_tokens, ood_score) splits its
        batch over it (the module docstring).

        TF32 is off for matmuls and cuDNN inside the pipeline's own
        calls (`exact_f32`), and the caller's flags are restored after
        each: the codebook ids must stay bit-comparable with the exact
        f32 reference, and the exact-f32 int8 products of the class head
        rely on full f32 accumulation."""
        if precision not in ("f32", "bf16", "int8"):
            raise ValueError(f"precision {precision!r}: 'f32', 'bf16' or "
                             f"'int8'")
        if encoder_precision not in ("f32", "int8"):
            raise ValueError(f"encoder_precision {encoder_precision!r}: "
                             f"'f32' or 'int8'")
        if encoder_impl not in ("xla", "fused"):
            raise ValueError(f"encoder_impl {encoder_impl!r}: 'xla' or "
                             f"'fused'")
        self.vq_model = vqvae.eval()
        self.tr_model = transformer.eval()
        if precision == "bf16":
            self.tr_model.compute_dtype = torch.bfloat16
        self.device = vqvae.codebook.device
        self.n_cycles = n_cycles
        self.max_batch = max_batch
        self.precision = precision
        self.encoder_precision = encoder_precision
        self.encoder_impl = encoder_impl
        self.qenc = None
        self._encoder_pack = None
        if encoder_impl == "fused":
            with torch.no_grad():
                self._encoder_pack = pack_encoder(self.vq_model)
        self.monitor_saturation = monitor_saturation
        self.start_token = (start_token if start_token is not None
                            else vqvae.num_embeddings)
        self.qparams = None
        # the absmax tables calibrate() measured; an artifact stores
        # them and the int8 tables are derived from them again at load
        self._act_absmax: dict | None = None
        self._enc_absmax: dict | None = None
        self.last_saturation_rate: float | None = None
        self.needs_recalibration = False
        # optional data.scaler.StandardScaler with the train split's
        # statistics. classify() takes scaled windows; a deployment
        # (save_artifact, cli/score_quality.py) attaches the training
        # scaler here to normalize raw sensor windows with it.
        self.scaler = None
        self.mesh = mesh
        self._replicas = None
        self._pool = None

    # -- artifacts ---------------------------------------------------------
    #
    # A deployed pipeline is more than its two checkpoints: the int8
    # path adds the activation absmax tables that a restart would have
    # to measure again on representative traffic. An artifact is one
    # directory with the whole serving state. manifest.json,
    # calibration.json and scaler.json carry the JAX package's keys and
    # values for the same pipeline; the two .ckpt files are this
    # package's (train/checkpoint.py). The int8 tables are derived from
    # weights and absmax at load, bit-identical to the saved pipeline's.

    ARTIFACT_VERSION = 1

    def save_artifact(self, artifact_dir: str) -> str:
        """Persist weights, serving configuration, int8 calibration and
        the scaler to a directory. `load_artifact` restores it without
        calibration windows."""
        os.makedirs(artifact_dir, exist_ok=True)
        self.vq_model.save(os.path.join(artifact_dir, "vqvae.ckpt"))
        self.tr_model.save(os.path.join(artifact_dir, "transformer.ckpt"))
        manifest = {
            "artifact_version": self.ARTIFACT_VERSION,
            "n_cycles": self.n_cycles,
            "max_batch": self.max_batch,
            "precision": self.precision,
            "encoder_precision": self.encoder_precision,
            "encoder_impl": self.encoder_impl,
            "start_token": int(self.start_token),
            "saturation_threshold": float(self.saturation_threshold),
            "monitor_saturation": bool(self.monitor_saturation),
            "calibrated": self.qparams is not None,
            "encoder_calibrated": self.qenc is not None,
            "has_scaler": self.scaler is not None,
        }
        with open(os.path.join(artifact_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        with open(os.path.join(artifact_dir, "calibration.json"), "w") as f:
            json.dump({"act_absmax": self._act_absmax,
                       "enc_absmax": self._enc_absmax}, f, indent=2)
        if self.scaler is not None:
            with open(os.path.join(artifact_dir, "scaler.json"), "w") as f:
                json.dump({"mean": np.asarray(self.scaler.mean_).tolist(),
                           "scale": np.asarray(self.scaler.scale_).tolist()},
                          f, indent=2)
        return artifact_dir

    @classmethod
    def load_artifact(cls, artifact_dir: str, mesh=None,
                      max_batch: int | None = None, device=None):
        """Rebuild a pipeline from `save_artifact`'s directory, on
        `device`: the card when it is None (and an error where there is
        none). The int8 tables are derived again from the stored
        weights and absmax tables; `mesh` and `max_batch` may be
        overridden for the new deployment."""
        from .models import TransformerDecoder, VQVAEPatch
        with open(os.path.join(artifact_dir, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["artifact_version"] > cls.ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {manifest['artifact_version']} is newer "
                f"than this build supports ({cls.ARTIFACT_VERSION})")
        vq = VQVAEPatch.load(os.path.join(artifact_dir, "vqvae.ckpt"),
                             device=device)
        tr = TransformerDecoder.load(
            os.path.join(artifact_dir, "transformer.ckpt"), device=device)
        pipe = cls(vq, tr, manifest["n_cycles"],
                   max_batch=(max_batch if max_batch is not None
                              else manifest["max_batch"]),
                   precision=manifest["precision"],
                   start_token=manifest["start_token"],
                   encoder_precision=manifest["encoder_precision"],
                   encoder_impl=manifest["encoder_impl"],
                   monitor_saturation=manifest.get("monitor_saturation",
                                                   True),
                   mesh=mesh)
        pipe.saturation_threshold = manifest.get(
            "saturation_threshold", cls.saturation_threshold)
        cal_path = os.path.join(artifact_dir, "calibration.json")
        cal = {}
        if os.path.exists(cal_path):
            with open(cal_path) as f:
                cal = json.load(f)
        if manifest.get("encoder_calibrated"):
            if not cal.get("enc_absmax"):
                raise ValueError("manifest says encoder_calibrated but "
                                 "calibration.json has no enc_absmax")
            pipe._set_encoder_calibration(cal["enc_absmax"])
        if manifest.get("calibrated"):
            if not cal.get("act_absmax"):
                raise ValueError("manifest says calibrated but "
                                 "calibration.json has no act_absmax")
            pipe._set_calibration(cal["act_absmax"])
        if manifest.get("has_scaler"):
            from .data.scaler import StandardScaler
            with open(os.path.join(artifact_dir, "scaler.json")) as f:
                sc = json.load(f)
            scaler = StandardScaler()
            scaler.mean_ = np.asarray(sc["mean"], np.float64)
            scaler.scale_ = np.asarray(sc["scale"], np.float64)
            pipe.scaler = scaler
        return pipe

    @classmethod
    def from_checkpoints(cls, vqvae_ckpt: str, transformer_ckpt: str,
                         n_cycles: int = 20, max_batch: int = 64,
                         precision: str = "f32",
                         start_token: int | None = None,
                         encoder_precision: str = "f32",
                         encoder_impl: str = "xla", mesh=None, device=None):
        """A pipeline from two checkpoint files, each this package's
        (`Model.save`) or a reference Lightning .ckpt, on `device` (the
        card when it is None)."""
        from .cli.shared import load_transformer_any, load_vqvae_any
        return cls(load_vqvae_any(vqvae_ckpt, device=device),
                   load_transformer_any(transformer_ckpt, device=device),
                   n_cycles, max_batch, precision=precision,
                   start_token=start_token,
                   encoder_precision=encoder_precision,
                   encoder_impl=encoder_impl, mesh=mesh)

    @_exact
    def _set_encoder_calibration(self, enc_absmax: dict) -> None:
        from .models.quantized import quantize_encoder
        self._enc_absmax = dict(enc_absmax)
        self._replicas = None
        with torch.inference_mode():
            self.qenc = quantize_encoder(self.vq_model, self._enc_absmax)

    @_exact
    def _set_calibration(self, act_absmax: dict) -> None:
        from .models.quantized import quantize_transformer
        self._act_absmax = dict(act_absmax)
        self._replicas = None
        with torch.inference_mode():
            self.qparams = quantize_transformer(self.tr_model,
                                                act_absmax=self._act_absmax)

    # -- per-chunk cores ---------------------------------------------------

    def _encode_cycles(self, cycles: torch.Tensor, *, fused: bool):
        if self.encoder_precision == "int8":
            if self.qenc is None:
                raise RuntimeError(
                    "encoder_precision='int8' requires calibrate(sample) "
                    "first")
            from .models.quantized import encode_indices_quantized
            return encode_indices_quantized(self.vq_model, self.qenc, cycles)
        if fused and self._encoder_pack is not None:
            return encode_indices_fused(self.vq_model, self._encoder_pack,
                                        cycles)
        return self.vq_model.encode_indices(cycles)

    def _encode_fn(self, x: torch.Tensor, *, fused: bool = False):
        b = x.shape[0]
        cycles = x.reshape(b * self.n_cycles, CYCLE_LEN, 2)
        ids = self._encode_cycles(cycles, fused=fused)
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

    def _ood_fn(self, cycles: torch.Tensor):
        return self.vq_model.forward_ood(cycles)

    def _saturation_fn(self, x: torch.Tensor):
        from .models.quantized import saturation_stats
        ids = with_start_token(self._encode_fn(x), self.start_token)
        return saturation_stats(self.tr_model, self.qparams, ids)

    # -- public API ------------------------------------------------------------

    @_exact
    @torch.inference_mode()
    def _batched(self, name: str, x: np.ndarray):
        """The per-chunk core `name` over chunks of at most max_batch
        rows, on the mesh's replicas where there is a mesh; outputs (an
        array or a tuple of arrays) are concatenated along the batch."""
        fn = getattr(self, name) if self.mesh is None else self._sharded(name)
        return _chunked_device_map(fn, x, chunk=self.max_batch,
                                   device=self.device)

    # -- the mesh's replicas -------------------------------------------------

    def _replica_on(self, device: torch.device):
        """This pipeline's serving state on `device`."""
        if device == self.device:
            return self
        with torch.no_grad():
            rep = WeldingQualityPipeline(
                copy.deepcopy(self.vq_model).to(device),
                copy.deepcopy(self.tr_model).to(device), self.n_cycles,
                self.max_batch, precision=self.precision,
                start_token=self.start_token,
                encoder_precision=self.encoder_precision,
                encoder_impl=self.encoder_impl,
                monitor_saturation=self.monitor_saturation)
        if self._enc_absmax is not None:
            rep._set_encoder_calibration(self._enc_absmax)
        if self._act_absmax is not None:
            rep._set_calibration(self._act_absmax)
        return rep

    def _sharded(self, name: str):
        """The core `name` over a chunk split across the replicas."""
        from concurrent.futures import ThreadPoolExecutor
        devices = [torch.device(d) for d in self.mesh.devices[:, 0]]
        n_data = len(devices)
        if self._replicas is None:
            self._replicas = [self._replica_on(d) for d in devices]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=n_data)
        for rep in self._replicas:
            rep.monitor_saturation = self.monitor_saturation

        def run(rep, part):
            with torch.inference_mode():
                return getattr(rep, name)(part.to(rep.device))

        def call(x: torch.Tensor):
            n = x.shape[0]
            pad = (-n) % n_data
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            parts = x.chunk(n_data)
            outs = list(self._pool.map(run, self._replicas, parts))
            if isinstance(outs[0], tuple):
                return tuple(
                    torch.cat([o[i].to(self.device) for o in outs])[:n]
                    for i in range(len(outs[0])))
            return torch.cat([o.to(self.device) for o in outs])[:n]
        return call

    @staticmethod
    def _windows(windows, what: str) -> np.ndarray:
        windows = np.ascontiguousarray(windows, np.float32)
        if windows.shape[0] == 0:
            raise ValueError(f"{what}: windows is empty")
        return windows

    @_exact
    def calibrate(self, sample_windows: np.ndarray,
                  max_samples: int | None = None) -> dict:
        """Calibrate the int8 activation scales on representative windows
        (required before classify() when precision='int8'). Returns the
        absmax table. With encoder_precision='int8' it first calibrates
        and quantizes the encoder on the sample's cycles; the ids the
        transformer is calibrated on then come from the int8 encoder."""
        from .models.quantized import calibrate_activation_absmax
        if max_samples is not None:
            sample_windows = sample_windows[:max_samples]
        if self.encoder_precision == "int8":
            from .models.quantized import calibrate_encoder_absmax
            cyc = torch.as_tensor(self._windows(sample_windows, "calibrate")
                                  ).reshape(-1, CYCLE_LEN, 2).to(self.device)
            with torch.inference_mode():
                enc_am = calibrate_encoder_absmax(self.vq_model, cyc)
            self._set_encoder_calibration(enc_am)
        ids = self.encode_tokens(sample_windows)
        with torch.inference_mode():
            ids = with_start_token(torch.as_tensor(ids).to(self.device),
                                   self.start_token)
            am = calibrate_activation_absmax(self.tr_model, ids)
        self._set_calibration(am)
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
        out = self._batched("_classify_fn",
                            self._windows(windows, "classify"))
        if isinstance(out, tuple):
            probs, sat = out
            self._note_saturation(float(np.mean(sat)))
        else:
            probs = out
        return probs.argmax(-1), probs

    @_exact
    def saturation_rate(self, windows: np.ndarray):
        """Clipped-activation fraction of the calibrated int8 path on
        `windows` (up to max_batch of them): (overall, per_site dict),
        from the plain int8 chain (`saturation_stats`).

        0 on the calibration distribution; rises when serving drifts
        beyond what calibrate() saw. Past saturation_threshold,
        recalibrate on recent windows or serve precision='f32'. The JAX
        version padded the windows up to max_batch by repeating the
        last one, to compile once; this one computes the rows it is
        given."""
        if self.qparams is None:
            raise RuntimeError("saturation_rate requires calibrate() first")
        x = self._windows(windows, "saturation_rate")[: self.max_batch]
        with torch.inference_mode():
            overall, per_site = self._saturation_fn(
                torch.as_tensor(x).to(self.device))
        return float(overall), {k: float(v) for k, v in per_site.items()}

    def encode_tokens(self, windows: np.ndarray) -> np.ndarray:
        """(N, n_cycles*200, 2) -> (N, n_cycles*16) int32 codebook ids,
        from the plain (exact) encoder, or from the int8 encoder when
        encoder_precision='int8'."""
        return self._batched("_encode_fn",
                             self._windows(windows, "encode_tokens"))

    def ood_score(self, cycles: np.ndarray) -> np.ndarray:
        """(N, 200, 2) single cycles -> per-sample quantization-error
        OOD score (N,), `VQVAEPatch.forward_ood` in chunks of
        max_batch."""
        return self._batched("_ood_fn", self._windows(cycles, "ood_score"))

    @_exact
    def sample_tokens(self, n: int | None = None, *,
                      prompt: np.ndarray | None = None,
                      top_k: int | None = None, seed: int = 0,
                      num_steps: int | None = None,
                      cache_dtype=None, param_dtype=None,
                      cache_buckets: int | None = None) -> np.ndarray:
        """Autoregressively sample latent token sequences from the
        generation head (KV-cached: batched prefill, recompute tail once
        the context outgrows seq_len).

        Either `n` fresh sequences from the start token, or
        continuations of `prompt` (N, t) token ids: the prompt is
        prefixed with the start token, prefilled in one forward, and
        `num_steps` (default seq_len) tokens are appended. Returns the
        sampled ids without the start token (prompt included when
        given), as a numpy array. `seed` seeds a torch.Generator on the
        serving device.

        cache_dtype=torch.bfloat16 stores the K/V caches in bf16 (scores
        are still summed in f32); param_dtype=torch.bfloat16 also
        streams the decode step's weight matrices in bf16; cache_buckets
        lets early steps read only a cache prefix. Each can move ids
        near probability ties, so the default stays the exact f32 path;
        see `TransformerDecoder.generate_kv`, and PERF.md for the card's
        ms per token of each.

        Sampling stays f32 even in an int8 pipeline, which keeps the
        ids equal to the reference's; models/quantized.py's
        quantized_generate_kv exists for full-int8 deployments where the
        weights' memory matters more."""
        if prompt is not None:
            prompt = torch.as_tensor(np.asarray(prompt, np.int32)).to(
                self.device)
            start = with_start_token(prompt, self.start_token)
        else:
            if n is None:
                raise ValueError("pass n (fresh samples) or prompt")
            start = torch.full((n, 1), self.start_token, dtype=torch.int32,
                               device=self.device)
        out = self.tr_model.generate_kv(
            start, do_sample=True, top_k=top_k,
            generator=torch.Generator(device=self.device).manual_seed(seed),
            num_steps=num_steps, cache_dtype=cache_dtype,
            param_dtype=param_dtype, cache_buckets=cache_buckets)
        return out[:, 1:].cpu().numpy()
