"""Nearest-code search as one kernel: distances and argmin fused.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_vq.py
(`nearest_codes_pallas`, the pallas_call at :59, kernel #7). The kernel
is `csrc/nearest_codes.cu` (`nearest_codes_f32`);
`nearest_codes_pallas_reference` is its plain PyTorch version. The name
keeps the JAX package's, so that a reader finds the counterpart; what
runs on the card is the CUDA kernel.

Both follow the TPU kernel's formula, d = sum e^2 - 2 z.e with the first
index among equal minima; the row-constant sum z^2 of ops/vq.nearest_codes
is left out. It cannot change an argmin in exact arithmetic; in f32 the
two can differ at a near-tie, which the tests do not find on random
data (as the JAX package's own tests).

Shapes: any K and D from 1 to 256. A codebook too large for shared
memory streams through it in chunks (csrc/nearest_codes.cu), with the
same first index among equal minima.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.
"""
from __future__ import annotations

import torch

from .. import kernels

_KERNEL = "nearest_codes_f32"
MAX_D = 256        # the widest code the kernel takes (any K)


def require_codebook(name: str, k: int, d: int) -> None:
    """Raise unless the kernels (#7, and #5's exit) take a (k, d)
    codebook: D from 1 to MAX_D, K at least 1. Needs no card."""
    if not 1 <= d <= MAX_D or k < 1:
        raise ValueError(f"{name}: a ({k}, {d}) codebook is not "
                         f"supported: D from 1 to {MAX_D} and K at least 1")


def nearest_codes_pallas_reference(z_flat: torch.Tensor,
                                   codebook: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel. (N, D) x (K, D) -> (N,) int32."""
    z = z_flat.float()
    cb = codebook.float()
    d = (cb * cb).sum(dim=1) - 2.0 * (z @ cb.t())
    return torch.argmin(d, dim=1).to(torch.int32)


def nearest_codes_pallas(z_flat: torch.Tensor,
                         codebook: torch.Tensor) -> torch.Tensor:
    """(N, D) f32 x (K, D) f32 -> (N,) int32 nearest-codebook indices.
    Drop-in for ops/vq.nearest_codes."""
    if z_flat.device.type == "cpu":
        return nearest_codes_pallas_reference(z_flat, codebook)
    if z_flat.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: no kernel for device {z_flat.device}")
    n, d = z_flat.shape
    k = codebook.shape[0]
    dev = z_flat.device
    require_codebook(_KERNEL, k, d)
    kernels.require(z_flat, "z_flat", torch.float32, (n, d), dev)
    kernels.require(codebook, "codebook", torch.float32, (k, d), dev)
    ids = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return ids
    lib = kernels.library()
    kernels.launches[_KERNEL] += 1
    err = lib.nearest_codes_f32(z_flat.data_ptr(), codebook.data_ptr(),
                                ids.data_ptr(), n, d, k,
                                kernels.stream_ptr(dev))
    kernels.check(err, _KERNEL)
    return ids
