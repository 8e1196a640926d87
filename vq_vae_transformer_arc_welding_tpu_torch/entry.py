"""The bench model and its classify pipelines.

Port of __graft_entry__.py (`_build`, `make_pipeline`,
`make_pipeline_quantized`): the VQ-VAE (hidden 512, 8 resblocks,
K=256, D=32, patch 25, no BatchNorm) and the transformer (d512,
8 blocks, 8 heads, 321 tokens: 20 cycles x 16 tokens + start token,
258 classes) that `bench.py` times. Weights are random, drawn from a
torch.Generator seeded with `seed`.
"""
from __future__ import annotations

import torch

from .models import TransformerDecoder, VQVAEPatch
from .serve import CYCLE_LEN, with_start_token

N_CYCLES = 20


def build(d_model: int = 512, n_blocks: int = 8, n_heads: int = 8,
          hidden: int = 512, k: int = 256, d: int = 32, n_res: int = 8,
          seed: int = 0,
          device=None) -> tuple[VQVAEPatch, TransformerDecoder]:
    """(vq, tr) at the bench configuration, in eval mode on `device`."""
    gen = torch.Generator().manual_seed(seed)
    vq = VQVAEPatch(hidden_dim=hidden, input_dim=2, num_embeddings=k,
                    embedding_dim=d, n_resblocks=n_res, learning_rate=1e-3,
                    batch_norm=False, generator=gen, device=device)
    seq_len = N_CYCLES * vq.enc_out_len + 1
    tr = TransformerDecoder(d_model=d_model, n_classes=k + 2,
                            seq_len=seq_len, n_blocks=n_blocks,
                            n_head=n_heads, generator=gen, device=device)
    return vq.eval(), tr.eval()


def make_pipeline(vq: VQVAEPatch, tr: TransformerDecoder):
    """The f32 classify step: (B, n_cycles*200, 2) windows -> (B, 2)
    logits; the correctness anchor of the int8 path."""

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        ids = vq.encode_indices(x.reshape(-1, CYCLE_LEN, 2))
        return tr.apply(with_start_token(ids.reshape(b, -1),
                                         vq.num_embeddings), generate=False)

    return fn


def make_pipeline_quantized(vq: VQVAEPatch, tr: TransformerDecoder, qparams,
                            block_fusion: str | None = "attn"):
    """The int8 classify step: fused f32 encoder (kernel 1) and the
    calibrated int8 transformer with the fused attention half per block
    (kernel 2). `qparams` must carry calibrated activation scales. The
    encoder's kernel operands are packed once, here."""
    from .models.quantized import quantized_classify
    from .ops.fused_encoder import encode_indices_fused, pack_encoder

    with torch.no_grad():
        packed = pack_encoder(vq)

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        ids = encode_indices_fused(vq, packed, x.reshape(-1, CYCLE_LEN, 2))
        return quantized_classify(
            tr, qparams, with_start_token(ids.reshape(b, -1),
                                          vq.num_embeddings),
            block_fusion=block_fusion)

    return fn
