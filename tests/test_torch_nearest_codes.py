"""The nearest-code kernel's lane-split scan (kernel #7,
csrc/nearest_codes.cu) against the JAX package, on the CPU.

The kernel gives each row LANES lanes (the constant is read from the
source); lane l scans the codes l, l + LANES, ... with `d < best` from
best = +inf and code 0, and the row's lanes then reduce their (d,
index) pairs by shuffles, keeping the smaller d and, on equal d, the
smaller index. The CUDA kernel runs only on the card, so the walk is
emulated here in plain PyTorch on the plain version's distances
(d = sum e^2 - 2 z.e, as `fused_vq.nearest_codes_pallas_reference`
forms them): ids must equal the plain version's first index among the
minima, and JAX's `nearest_codes_pallas` in interpret mode, bit for bit,
with ties placed inside a lane and across lanes, K not a multiple of
LANES, and a row whose distances are all +inf (code 0).
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vq_vae_transformer_arc_welding_tpu.ops.pallas_vq import (
    nearest_codes_pallas as jax_nearest)
from vq_vae_transformer_arc_welding_tpu_torch import kernels
from vq_vae_transformer_arc_welding_tpu_torch.ops import fused_vq as fvq

LANES = int(re.search(r"constexpr int LANES = (\d+);",
                      (kernels.SRC_DIR / "nearest_codes.cu").read_text())
            .group(1))


def distances(z: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    return (cb * cb).sum(1) - 2.0 * (z @ cb.t())


def lane_split_ids(d: torch.Tensor, lanes: int = LANES) -> torch.Tensor:
    """The kernel's walk over an (N, K) distance matrix: each lane's scan
    with d < best, then the shuffle reduction (xor 1, 2, ...)."""
    n, k = d.shape
    best = torch.full((n, lanes), torch.inf)
    best_k = torch.zeros((n, lanes), dtype=torch.int64)
    for code in range(k):
        lane = code % lanes
        take = d[:, code] < best[:, lane]      # NaN and +inf never taken
        best[take, lane] = d[take, code]
        best_k[take, lane] = code
    o = 1
    while o < lanes:
        partner = torch.arange(lanes) ^ o
        od, ok = best[:, partner], best_k[:, partner]
        take = (od < best) | ((od == best) & (ok < best_k))
        best = torch.where(take, od, best)
        best_k = torch.where(take, ok, best_k)
        o <<= 1
    assert (best_k == best_k[:, :1]).all()   # every lane holds the answer
    return best_k[:, 0].int()


def operands(n: int, d: int, k: int, case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    if case == "lanes":
        # row 5's code at 2, in the next lane (3) and K // 8 further on;
        # codes 8 and 9 equal each other
        cb[2] = cb[3] = cb[2 + k // 8] = z[5]
        cb[9] = cb[8]
    elif case == "inf":
        # positive codes and a row of -inf: every distance +inf
        cb = np.abs(cb) + 0.1
        z[7] = -np.inf
    return z, cb


@pytest.mark.parametrize("n,d,k,case", [
    (500, 32, 256, "random"), (500, 32, 256, "lanes"), (300, 32, 50, "lanes"),
    (300, 16, 300, "lanes"), (200, 20, 50, "random"), (200, 32, 256, "inf"),
    (100, 8, 5, "random")])
def test_lane_split_scan_matches_plain_and_jax(n, d, k, case):
    z, cb = operands(n, d, k, case)
    tz, tcb = torch.from_numpy(z), torch.from_numpy(cb)
    ids = lane_split_ids(distances(tz, tcb))
    plain = fvq.nearest_codes_pallas_reference(tz, tcb)
    ref = np.asarray(jax_nearest(jnp.asarray(z), jnp.asarray(cb)))
    np.testing.assert_array_equal(ids.numpy(), plain.numpy())
    np.testing.assert_array_equal(ids.numpy(), ref)
    if case == "lanes":
        assert ids[5] == 2
        assert not np.isin(ids.numpy(), [3, 2 + k // 8, 9]).any()
    if case == "inf":
        assert ids[7] == 0


def test_lane_reduction_takes_the_first_index_on_equal_distances():
    """Equal distances in every lane: the smallest index wins whichever
    lane holds it; no finite distance at all: code 0."""
    k = 4 * LANES + 3
    d = torch.zeros(3, k)
    d[1, :LANES + 1] = 1.0                 # the first minimum at LANES + 1
    d[2] = torch.inf
    d[2, -1] = torch.nan
    np.testing.assert_array_equal(lane_split_ids(d).numpy(),
                                  [0, LANES + 1, 0])
