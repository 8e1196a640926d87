"""The bench model and its classify pipelines.

Port of __graft_entry__.py (`_build`, `make_pipeline`,
`make_pipeline_quantized` with its `encoder_dtype`): the VQ-VAE (hidden 512, 8 resblocks,
K=256, D=32, patch 25, no BatchNorm) and the transformer (d512,
8 blocks, 8 heads, 321 tokens: 20 cycles x 16 tokens + start token,
258 classes) that `bench.py` times. Weights are random, drawn from a
torch.Generator seeded with `seed`. `build` puts the models on the card
unless the caller names another device.
"""
from __future__ import annotations

import torch

from .models import TransformerDecoder, VQVAEPatch
from .models.base import serving_device
from .serve import CYCLE_LEN, with_start_token

N_CYCLES = 20


def build(d_model: int = 512, n_blocks: int = 8, n_heads: int = 8,
          hidden: int = 512, k: int = 256, d: int = 32, n_res: int = 8,
          seed: int = 0, device=None, vq_impl: str = "xla",
          attention_impl: str = "xla"
          ) -> tuple[VQVAEPatch, TransformerDecoder]:
    """(vq, tr) at the bench configuration, in eval mode on `device`:
    the card when it is None (and an error where there is none), the
    CPU only when asked. vq_impl: the VQ-VAE's nearest-code option;
    attention_impl: the transformer's attention option."""
    device = serving_device(device)
    gen = torch.Generator().manual_seed(seed)
    vq = VQVAEPatch(hidden_dim=hidden, input_dim=2, num_embeddings=k,
                    embedding_dim=d, n_resblocks=n_res, learning_rate=1e-3,
                    batch_norm=False, vq_impl=vq_impl, generator=gen,
                    device=device)
    seq_len = N_CYCLES * vq.enc_out_len + 1
    tr = TransformerDecoder(d_model=d_model, n_classes=k + 2,
                            seq_len=seq_len, n_blocks=n_blocks,
                            n_head=n_heads, attention_impl=attention_impl,
                            generator=gen, device=device)
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
                            block_fusion: str | None = "attn",
                            encoder_dtype=None, **classify_kw):
    """The int8 classify step: fused f32 encoder (kernel #1) and the
    calibrated int8 transformer, `quantized_classify(block_fusion=...)`:
    'attn' (the default, kernel #2 per block), 'full' (#6), 'attn8' and
    'full8' (their int8-attention variants), each also with '-bf16', or
    None. `classify_kw` goes to quantized_classify as it is: with
    block_fusion=None, fused_attention=True and the fused_* options
    select the fused attention kernels (#10, #11) and the fused MLP
    (#8). `qparams` must carry calibrated activation scales.

    encoder_dtype: None = the f32 encoder (split TF32 on the card, f32
    accuracy: ids equal the plain encoder's but for near-ties, the
    default contract). torch.bfloat16 = the
    encoder's products on the bf16 tensor cores with f32 sums
    (`encode_indices_fused(compute_dtype=)`): ids can differ near
    Voronoi boundaries, so measure label agreement first.

    The encoder's kernel operands are packed once, here, in the
    encoder's dtype."""
    from .models.quantized import quantized_classify
    from .ops.fused_encoder import encode_indices_fused, pack_encoder

    with torch.no_grad():
        packed = pack_encoder(vq, encoder_dtype)

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        ids = encode_indices_fused(vq, packed, x.reshape(-1, CYCLE_LEN, 2),
                                   compute_dtype=encoder_dtype)
        return quantized_classify(
            tr, qparams, with_start_token(ids.reshape(b, -1),
                                          vq.num_embeddings),
            block_fusion=block_fusion, **classify_kw)

    return fn
