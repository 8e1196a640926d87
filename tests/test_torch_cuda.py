"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips on a host without one.
The file imports no jax (the machine with the card has none), so it
runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: kernel 1 keeps the f32 residual stream within 1e-4 of its
magnitude (the two sum 512-term dot products in other orders); kernel 2
may move at most 0.1% of the int8 outputs, by one step, and x_mid by
1e-3 (an ulp of LayerNorm or attention difference can cross a rounding
boundary).
"""
import numpy as np
import pytest
import torch

from vq_vae_transformer_arc_welding_tpu_torch import kernels
from vq_vae_transformer_arc_welding_tpu_torch.ops import (
    fused_block_quant as fbq, fused_encoder as fenc, int8)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _encoder_operands(c: int, n_blocks: int, use_bn: bool, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    bound = (6.0 / (2 * c * 3)) ** 0.5
    w = (torch.rand(2 * n_blocks, c, c, generator=g) * 2 - 1) * bound
    v = torch.zeros(n_blocks, 2, 5, c)
    v[:, :, 0] = torch.randn(n_blocks, 2, c, generator=g) * 0.1
    if use_bn:
        v[:, :, 1] = torch.randn(n_blocks, 2, c, generator=g) * 0.2
        v[:, :, 2] = torch.rand(n_blocks, 2, c, generator=g) * 1.5 + 0.5
        v[:, :, 3] = torch.rand(n_blocks, 2, c, generator=g) + 0.5
        v[:, :, 4] = torch.randn(n_blocks, 2, c, generator=g) * 0.1
    return w, v.reshape(10 * n_blocks, c)


@pytest.mark.parametrize("use_bn", [False, True])
def test_encoder_kernel_matches_plain(dev, use_bn):
    c = 512
    w, v = (a.to(dev) for a in _encoder_operands(c, 4, use_bn))
    x = torch.randn(1000, c, generator=torch.Generator().manual_seed(1))
    x = x.to(dev)           # 1000 rows: a ragged last tile of 32
    before = kernels.launches["encoder_chain_f32"]
    out = fenc.fused_encoder_eval(x, w, v, use_bn=use_bn)
    ref = fenc.fused_encoder_eval_reference(x, w, v, use_bn=use_bn)
    torch.cuda.synchronize()
    assert kernels.launches["encoder_chain_f32"] == before + 1
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


def _block_operands(c: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    w_qkv = torch.from_numpy(rng.integers(-127, 128, (3 * c, c), np.int8))
    w_proj = torch.from_numpy(rng.integers(-127, 128, (c, c), np.int8))
    scales = torch.tensor([30.0, 200.0, 30.0, 30.0])
    vc = torch.from_numpy(np.stack([
        rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
        rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
        np.full(c, 2e-5), rng.standard_normal(c) * 0.01]).astype(np.float32))
    v3c = torch.from_numpy(np.stack([
        np.full(3 * c, 1e-3), rng.standard_normal(3 * c) * 0.1]).astype(
            np.float32))
    return w_qkv, w_proj, scales, vc, v3c


@pytest.mark.parametrize("b,t,c,n_head", [(3, 45, 128, 2), (2, 321, 512, 8)])
def test_attn_block_kernel_matches_plain(dev, b, t, c, n_head):
    x = torch.randn(b, t, c, generator=torch.Generator().manual_seed(2))
    args = [a.to(dev).contiguous() for a in (x, *_block_operands(c))]
    xm, h8 = fbq.attn_block_quant(*args, n_head=n_head)
    xm_ref, h8_ref = fbq.fused_attn_block_quant_reference(*args,
                                                          n_head=n_head)
    torch.cuda.synchronize()
    diff = (h8.int() - h8_ref.int()).abs()
    assert diff.max() <= 1 and (diff != 0).float().mean() <= 1e-3
    assert (xm - xm_ref).abs().max() <= 1e-3


@pytest.mark.parametrize("m,k,n", [(321, 512, 1536), (80, 321, 2), (8, 512, 1)])
def test_int8_matmul_exact_on_cuda(dev, m, k, n):
    """_int_mm where its shape rules hold, exact f32 otherwise."""
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (m, k), np.int8)
    w = rng.integers(-127, 128, (n, k), np.int8)
    out = int8.int8_matmul(torch.from_numpy(a).to(dev),
                           torch.from_numpy(w).to(dev))
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64).T)


def test_wrapper_rejects_bad_operands(dev):
    x = torch.zeros(64, 512, device=dev)
    w, v = (a.to(dev) for a in _encoder_operands(512, 1, False))
    with pytest.raises(ValueError):
        fenc.fused_encoder_eval(x.double(), w, v, use_bn=False)
    with pytest.raises(ValueError):
        fenc.fused_encoder_eval(x[:, ::2], w, v, use_bn=False)
    with pytest.raises(ValueError):
        fenc.fused_encoder_eval(x, w.cpu(), v, use_bn=False)
    with pytest.raises(ValueError):      # the kernel is built for hidden 512
        fenc.fused_encoder_eval(x[:, :256].contiguous(), w[:, :256, :256],
                                v[:, :256], use_bn=False)
