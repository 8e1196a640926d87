"""The eval-mode encoder on fused kernels: resblock groups and the edges.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_encoder.py:

- `fused_encoder_eval` (pallas_call at :311), kernel #1 ->
  `fused_encoder_eval`, `encoder_chain_f32` in csrc/encoder_chain.cu,
  its products in split TF32 on the tensor cores (csrc/encoder_tc.cuh);
  with `compute_dtype=torch.bfloat16` (`_resblock_chain`'s `cdt`,
  :209-232) `encoder_chain_bf16` in csrc/encoder_chain_bf16.cu: both
  products' inputs rounded to bf16 and multiplied on the tensor cores,
  sums and everything else in f32;
- `fused_resblock_eval` (:106), #3 -> `resblock_eval` and
  `fused_resblock_eval`, `resblock_f32` in csrc/encoder_resblock.cu, the
  same tile at one resblock a launch;
- `fused_encoder_entry_eval` (:404), #4 -> `fused_encoder_entry_eval`,
  `encoder_entry_f32` in csrc/encoder_edges.cu;
- `fused_encoder_exit_eval` (:436), #5 -> `fused_encoder_exit_eval`,
  `encoder_exit_f32` in csrc/encoder_edges.cu (#4 and #5 are #1's tile
  with the patch-embed before, or sep_conv and the nearest code after,
  each tile's resblocks);

and `_pack_encoder` as `pack_encoder`, `encoder_resblocks_fused`,
`encode_indices_fused`, `encode_indices_fused_mono` and
`encode_indices_fused_edges`. Each `*_reference` is its kernel's plain
PyTorch version.

Widths: every hidden width from 1 to 4,096 (`MAX_WIDTH`), and at the
exit any codebook with D from 1 to 256. Up to 512 the f32 kernels (#1,
#3, #4, #5) run on their tile, instantiated at 128, 256 and 512
(`kernel_width`): hidden 1 to 128 on 128, 129 to 256 on 256, 257 to
512 on 512, the split weights (`split_weights`) padded with zeros to
that width; x, out and the vector rows keep the hidden width. Above
512 they run on csrc/encoder_wide.cu (`encoder_wide_f32`,
`encoder_wide_entry_f32`, `encoder_wide_exit_f32`: one launch a
product, the pack's weights as they are, an (N, C) scratch between a
resblock's two products). The bf16 chain (1b) runs its own tile at
hidden 512 and `encoder_wide_bf16` at every other width. Wider
hidden widths and wider codes raise `ValueError`.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back.

The weights are packed once (`pack_encoder` and, for the edges,
`pack_encoder_edges`, at pipeline construction) and passed to the
`encode_indices_*` functions, not repacked per request as the JAX
functions repack them under jit; the per-resblock path takes views of
the same pack. An f32 pack carries the split-TF32 operand of the f32 kernels
(`split_weights`, in `EncoderPack.split`), made with it; the paths hand
its views to the wrappers, which split a bare f32 pack per call. A bf16
pack (`pack_encoder(model, torch.bfloat16)`) is made once too, and
carries in the same place the bf16 chain's operand (`stage_weights_bf16`:
the weights in the order of that kernel's TMA ring); the functions cast
(and stage) an f32 pack they are handed with a compute dtype, per call,
as the JAX kernel recasts under jit. The split serves #4 and #5 too.

GELU: the kernels use the exact erf (`erff`), like the plain versions
and the JAX package's XLA encoder. The Pallas kernels' Abramowitz &
Stegun erf was a workaround for Mosaic and is not carried over.

Group size: the default keeps the JAX rule, as many blocks per call as
fit 8 MB of weights, i.e. 4 at hidden 512 in f32 and all 8 in bf16, so
the port makes the same calls as the reference. On Hopper the weights come from L2
whatever the group, so the group size only sets how often the (N, C)
residual stream crosses device memory between calls.
"""
from __future__ import annotations

import torch

from .. import kernels
from .activations import gelu
from .fused_vq import require_codebook
from .norm import batch_norm_apply
from .patching import patchify
from .vq import nearest_codes

_CHAIN, _RESBLOCK = "encoder_chain_f32", "resblock_f32"
_CHAIN_BF16 = "encoder_chain_bf16"
_ENTRY, _EXIT = "encoder_entry_f32", "encoder_exit_f32"
# the same functions off the tiles' widths (csrc/encoder_wide.cu)
_WIDE, _WIDE_BF16 = "encoder_wide_f32", "encoder_wide_bf16"
_WIDE_ENTRY, _WIDE_EXIT = "encoder_wide_entry_f32", "encoder_wide_exit_f32"
MAX_WIDTH = 4096       # the widest hidden width the kernels take
TILE_WIDTH = 512       # the f32 tile's widest (csrc/encoder_tc.cuh::MAX_C)
_BF16_WIDTH = 512      # 1b's own tile's


def kernel_width(hidden: int) -> int:
    """The width of the f32 encoder tile that hidden width runs on: 128,
    256 or 512 (csrc/encoder_tc.cuh::tile_width); above 512, where no
    tile runs (csrc/encoder_wide.cu), the hidden width itself."""
    if hidden > TILE_WIDTH:
        return hidden
    return 128 if hidden <= 128 else 256 if hidden <= 256 else 512


def _width_ok(hidden: int) -> bool:
    return 1 <= hidden <= MAX_WIDTH


def on_tile(hidden: int) -> bool:
    """Whether the f32 kernels run that hidden width on their tile (up
    to 512), not on csrc/encoder_wide.cu."""
    return hidden <= TILE_WIDTH


def chain_kernel(hidden: int, compute_dtype=None) -> str:
    """The kernel `fused_encoder_eval` launches at that hidden width:
    the f32 tile up to 512 and encoder_wide_f32 above; 1b's tile at 512
    and encoder_wide_bf16 at every other width."""
    if compute_dtype is None:
        return _CHAIN if on_tile(hidden) else _WIDE
    return _CHAIN_BF16 if hidden == _BF16_WIDTH else _WIDE_BF16


def _center_tap(kernel: torch.Tensor) -> torch.Tensor:
    return kernel[:, :, kernel.shape[-1] // 2]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna.tf32.f32 rounds: 10 mantissa bits
    kept, to nearest with ties away from zero (on the magnitude bits,
    so for either sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_weights(weights: torch.Tensor) -> torch.Tensor:
    """The split-TF32 operand of the f32 tile (#1, #3, #4, #5 up to
    hidden 512): (2n, C, C) f32 weights in (in, out) layout -> (2n,
    2 W W) at the tile's width W = `kernel_width(C)`, the weights padded
    with zero rows and columns to (W, W); per matrix hi = tf32(w) and
    lo = tf32(w - hi) (hi + lo is w to 2^-21 of its magnitude), in (out,
    in) layout, the
    K-major one in which TF32 wgmma reads its shared-memory operand, and
    in the order the kernels' ring reads them: 8-wide k steps in order,
    each hi then lo over all W outputs, each as wgmma's core matrices of
    8 outputs x 4 k (128 bytes), i.e. [k // 8][hi, lo][out // 8][k % 8
    // 4][out % 8][k % 4]."""
    m, c, _ = weights.shape
    if not on_tile(c):
        raise ValueError(f"split_weights: hidden {c}: the f32 tile takes "
                         f"1 to {TILE_WIDTH} (wider runs on the weights)")
    width = kernel_width(c)
    if width != c:
        weights = torch.nn.functional.pad(weights,
                                          (0, width - c, 0, width - c))
        c = width
    wt = weights.transpose(1, 2)
    hi = tf32(wt)
    parts = torch.stack([hi, tf32(wt - hi)], 1)      # (2n, 2, out, in)
    return (parts.reshape(m, 2, c // 8, 8, c // 8, 2, 4)
            .permute(0, 4, 1, 2, 5, 3, 6).reshape(m, 2 * c * c))


def stage_weights_bf16(weights: torch.Tensor) -> torch.Tensor:
    """The operand of the bf16 chain kernel (1b): (2n, C, C) weights in
    (in, out) layout, f32 or bf16 -> (2n, C C) bf16, rounded to bf16
    (to nearest even), in (out, in) layout, the K-major one in which
    bf16 wgmma reads its shared-memory operands, and in the order the
    kernel's ring reads them: per matrix, the two 256-output halves (one
    a consumer warpgroup), each as two passes of 128 outputs, each as
    stages of 64 of K, each 128 rows (outputs) of 64 bf16 (128 bytes,
    which TMA swizzles on the way in), i.e. [out // 256]
    [out % 256 // 128][k // 64][out % 128][k % 64]. A stage (16 KB) is
    contiguous."""
    m, c, _ = weights.shape
    wt = weights.to(torch.bfloat16).transpose(1, 2)   # (2n, out, in)
    return (wt.reshape(m, 2, 2, c // 4, c // 64, 64)
            .permute(0, 1, 2, 4, 3, 5).reshape(m, c * c).contiguous())


class EncoderPack(tuple):
    """What `pack_encoder` returns: the pair (weights, vecs), and in
    `split` the kernel's operand made from the weights: the split-TF32
    weights of the f32 tile (`split_weights(weights)`) for an f32 pack
    up to hidden 512, the staged bf16 weights of 1b's tile
    (`stage_weights_bf16(weights)`) for a bf16 one at hidden 512; None at
    the other widths, whose kernels read the weights as they are."""

    def __new__(cls, weights: torch.Tensor, vecs: torch.Tensor,
                split: torch.Tensor | None = None):
        pack = super().__new__(cls, (weights, vecs))
        pack.split = split
        return pack


def pack_encoder(model, compute_dtype: torch.dtype | None = None
                 ) -> EncoderPack:
    """Stack every resblock's center-tap weights, transposed to (in, out),
    as (2n, C, C), and its vector rows [b1, bn1 mean, var, scale, bias,
    b2, bn2 mean, var, scale, bias] as (10n, C); BN rows are zeros when
    the model has no BatchNorm. An f32 pack up to hidden 512 also
    carries the weights' split (`split_weights`), made here once.
    compute_dtype (torch.bfloat16): the weights rounded to it, for the
    functions' `compute_dtype` variant, and in `split` at hidden 512 the
    same weights staged for 1b's tile (`stage_weights_bf16`); the vector
    rows stay f32."""
    ws, vs = [], []
    c = model.hidden_dim
    zero = torch.zeros(c, device=model.codebook.device)
    for blk in model.resblocks:
        conv1, bn1, conv2, bn2 = (blk.block[i] for i in (1, 2, 4, 5))
        ws += [_center_tap(conv1.weight).t(), _center_tap(conv2.weight).t()]
        for conv, bn in ((conv1, bn1), (conv2, bn2)):
            if model.batch_norm:
                vs += [conv.bias, bn.running_mean, bn.running_var, bn.weight,
                       bn.bias]
            else:
                vs += [conv.bias, zero, zero, zero, zero]
    weights = torch.stack(ws).contiguous()
    vecs = torch.stack(vs).contiguous()
    if compute_dtype is not None:
        wb = weights.to(_compute_dtype(compute_dtype))
        return EncoderPack(wb, vecs, stage_weights_bf16(wb)
                           if c == _BF16_WIDTH else None)
    return EncoderPack(weights, vecs,
                       split_weights(weights) if on_tile(c) else None)


def pack_encoder_edges(model) -> tuple[torch.Tensor, ...]:
    """The operands of the encoder's two ends, contiguous: patch-embed
    w_pe (patch, C) and b_pe (C,), sep_conv's center tap w_sep (C, D) in
    (in, out) layout and b_sep (D,)."""
    pe, sep = model.patch_embed.proj, model.encoder[1].shared_conv
    return (pe.weight[:, 0, :].t().contiguous(), pe.bias,
            _center_tap(sep.weight).t().contiguous(), sep.bias)


# -- plain versions ------------------------------------------------------------

def _compute_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype {compute_dtype}: None (f32) or "
                         f"torch.bfloat16")
    return compute_dtype


def _dot(h: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """h @ w in f32; with a compute dtype both inputs are rounded to it
    first and the products are still summed in f32 (a bf16 `@` would
    round the sum as well)."""
    if compute_dtype is None:
        return h @ w
    return h.to(compute_dtype).float() @ w.to(compute_dtype).float()


def fused_resblock_eval_reference(x: torch.Tensor, w1: torch.Tensor,
                                  w2: torch.Tensor, vec: torch.Tensor, *,
                                  use_bn: bool,
                                  compute_dtype=None) -> torch.Tensor:
    """Plain version of the one-resblock kernel. x (N, C); w1, w2 (C, C)
    in (in, out) layout; vec (10, C). Returns (N, C). compute_dtype: the
    type both products' inputs are rounded to (see `_dot`)."""
    c = _dot(gelu(x), w1, compute_dtype) + vec[0]
    if use_bn:
        c = batch_norm_apply(c, vec[3], vec[4], vec[1], vec[2])
    c = _dot(gelu(c), w2, compute_dtype) + vec[5]
    if use_bn:
        c = batch_norm_apply(c, vec[8], vec[9], vec[6], vec[7])
    return x + c


def fused_encoder_eval_reference(x: torch.Tensor, weights: torch.Tensor,
                                 vecs: torch.Tensor, *, use_bn: bool,
                                 compute_dtype=None) -> torch.Tensor:
    """Plain version of the chain kernels. x: (N, C) f32; weights
    (2n, C, C) in (in, out) layout, f32 or already in the compute dtype;
    vecs (10n, C). Returns (N, C) f32."""
    if compute_dtype is not None:
        _compute_dtype(compute_dtype)
    for i in range(weights.shape[0] // 2):
        x = fused_resblock_eval_reference(
            x, weights[2 * i], weights[2 * i + 1],
            vecs[10 * i:10 * (i + 1)], use_bn=use_bn,
            compute_dtype=compute_dtype)
    return x


def fused_encoder_entry_eval_reference(patches, w_pe, b_pe, weights, vecs, *,
                                       use_bn: bool) -> torch.Tensor:
    """Plain version of the entry kernel: patch-embed, then the chain."""
    return fused_encoder_eval_reference(patches @ w_pe + b_pe, weights, vecs,
                                        use_bn=use_bn)


def fused_encoder_exit_eval_reference(x, weights, vecs, w_sep, b_sep,
                                      codebook, *,
                                      use_bn: bool) -> torch.Tensor:
    """Plain version of the exit kernel: the chain, sep_conv, and the
    nearest code by the z^2 + e^2 - 2 z.e distances with the first index
    among the minima, which is ops/vq.nearest_codes. Returns (N,) int32."""
    x = fused_encoder_eval_reference(x, weights, vecs, use_bn=use_bn)
    return nearest_codes(x @ w_sep + b_sep, codebook)


# -- wrappers ------------------------------------------------------------------

def _on_card(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version's case); raises for any
    device that is neither."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def _require_width(name: str, c: int) -> None:
    if not _width_ok(c):
        raise ValueError(f"{name}: hidden {c} not supported (1 to "
                         f"{MAX_WIDTH})")


def _require_chain(name: str, c: int, weights, vecs, dev,
                   dtype: torch.dtype = torch.float32) -> int:
    """Check a group's packed operands (weights of `dtype`); returns its
    number of blocks."""
    nb = weights.shape[0] // 2
    if not _width_ok(c) or weights.shape[0] != 2 * nb or nb < 1:
        raise ValueError(f"{name}: hidden {c} / {weights.shape[0]} "
                         f"matrices not supported (hidden 1 to "
                         f"{MAX_WIDTH}, an even count)")
    kernels.require(weights, "weights", dtype, (2 * nb, c, c), dev)
    kernels.require(vecs, "vecs", torch.float32, (10 * nb, c), dev)
    return nb


def _split_operand(name: str, weights: torch.Tensor,
                   split: torch.Tensor | None) -> torch.Tensor:
    """The split weights the f32 kernel reads: `split` checked against
    the (2n, C, C) weights (its (2n, 2 W W) at the tile's width), or
    made from them (per call)."""
    if split is None:
        return split_weights(weights)
    m, c, _ = weights.shape
    w = kernel_width(c)
    kernels.require(split, f"{name} split", torch.float32, (m, 2 * w * w),
                    weights.device)
    return split


def _staged_operand(weights: torch.Tensor,
                    staged: torch.Tensor | None) -> torch.Tensor:
    """The staged bf16 weights the bf16 chain reads: `staged` checked
    against the (2n, C, C) weights, or made from them (per call)."""
    if staged is None:
        return stage_weights_bf16(weights)
    m, c, _ = weights.shape
    kernels.require(staged, f"{_CHAIN_BF16} split", torch.bfloat16,
                    (m, c * c), weights.device)
    return staged


def _aligned(name: str, **tensors) -> None:
    """Raise unless each tensor starts on 16 bytes, as the f32 kernels'
    float4 and TMA reads need."""
    for what, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def fused_encoder_eval(x: torch.Tensor, weights: torch.Tensor,
                       vecs: torch.Tensor, *, use_bn: bool,
                       compute_dtype=None,
                       split: torch.Tensor | None = None) -> torch.Tensor:
    """n = weights.shape[0] // 2 eval resblocks on (N, C) f32 rows.

    compute_dtype: None = f32 products (`encoder_chain_f32`: split TF32
    on the tensor cores, f32 accuracy; ids as the plain encoder's but
    for near-ties). torch.bfloat16 = both products' inputs rounded to
    bf16, sums in f32 (`encoder_chain_bf16`, on the tensor cores);
    everything else stays f32. f32 weights are cast here, per call;
    pass a bf16 pack (`pack_encoder(model, torch.bfloat16)`) to cast
    once.

    split: the kernel's operand made from `weights` (the view of
    `pack_encoder(model[, torch.bfloat16]).split` that matches them):
    `split_weights(weights)` for the f32 tile, `stage_weights_bf16(
    weights)` for 1b's. Without it the wrapper makes it here, per call,
    which a bare pack (tests, chip_smoke.py) pays for; the CPU path does
    not read it, nor do the kernels of the other widths
    (`encoder_wide_f32` above hidden 512, `encoder_wide_bf16` off 512:
    the weights as they are, an (N, C) scratch made here)."""
    if compute_dtype is None:
        name, dtype = _CHAIN, torch.float32
    else:
        name, dtype = _CHAIN_BF16, _compute_dtype(compute_dtype)
    if not _on_card(name, x):
        return fused_encoder_eval_reference(x, weights, vecs, use_bn=use_bn,
                                            compute_dtype=compute_dtype)
    if compute_dtype is not None and weights.dtype == torch.float32:
        weights = weights.to(dtype)
    n, c = x.shape
    nb = _require_chain(name, c, weights, vecs, x.device, dtype)
    kernels.require(x, "x", torch.float32, (n, c), x.device)
    if chain_kernel(c, compute_dtype) != name:
        return _wide_chain(chain_kernel(c, compute_dtype), x,
                           weights.data_ptr(), vecs, nb, use_bn)
    operand = (_staged_operand(weights, split) if compute_dtype is not None
               else _split_operand(name, weights, split))
    _aligned(name, weights=operand, **(
        {"x": x, "vecs": vecs} if compute_dtype is not None else {}))
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = kernels.library()
    kernels.launches[name] += 1
    err = getattr(lib, name)(x.data_ptr(), operand.data_ptr(),
                             vecs.data_ptr(), out.data_ptr(), n, c, nb,
                             int(use_bn), kernels.stream_ptr(x.device))
    kernels.check(err, name)
    return out


def _wide_chain(name: str, x: torch.Tensor, w_ptr: int, vecs: torch.Tensor,
                nb: int, use_bn: bool) -> torch.Tensor:
    """nb resblocks of csrc/encoder_wide.cu (`name`: encoder_wide_f32 or
    _bf16) on x, its (2 nb, C, C) weights at w_ptr; returns out."""
    n, c = x.shape
    out = torch.empty_like(x)
    if n == 0:
        return out
    h = torch.empty_like(x)
    lib = kernels.library()
    kernels.launches[name] += 1
    err = getattr(lib, name)(x.data_ptr(), w_ptr, vecs.data_ptr(),
                             h.data_ptr(), out.data_ptr(), n, c, nb,
                             int(use_bn), kernels.stream_ptr(x.device))
    kernels.check(err, name)
    return out


def resblock_eval(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  vec: torch.Tensor, *, use_bn: bool,
                  split: torch.Tensor | None = None) -> torch.Tensor:
    """One eval resblock on (N, C) f32 rows, operand-level: w1, w2 (C, C)
    in (in, out) layout, vec (10, C) as a resblock's rows of
    `pack_encoder`. split: `split_weights` of [w1, w2], (2, 2 C C), as
    for `fused_encoder_eval`: made here, per call, when not given, and
    not read above hidden 512 (`encoder_wide_f32`, one resblock)."""
    if not _on_card(_RESBLOCK, x):
        return fused_resblock_eval_reference(x, w1, w2, vec, use_bn=use_bn)
    n, c = x.shape
    dev = x.device
    _require_width(_RESBLOCK, c)
    kernels.require(x, "x", torch.float32, (n, c), dev)
    kernels.require(w1, "w1", torch.float32, (c, c), dev)
    kernels.require(w2, "w2", torch.float32, (c, c), dev)
    kernels.require(vec, "vec", torch.float32, (10, c), dev)
    if not on_tile(c):
        # the pack's w1 and w2 lie one after the other: no copy
        pair = (w1 if w2.data_ptr() == w1.data_ptr() + w1.numel() * 4
                else torch.stack([w1, w2]))
        return _wide_chain(_WIDE, x, pair.data_ptr(), vec, 1, use_bn)
    if split is None:
        split = split_weights(torch.stack([w1, w2]))
    w = kernel_width(c)
    kernels.require(split, "split", torch.float32, (2, 2 * w * w), dev)
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = kernels.library()
    kernels.launches[_RESBLOCK] += 1
    err = lib.resblock_f32(x.data_ptr(), split.data_ptr(), vec.data_ptr(),
                           out.data_ptr(), n, c, int(use_bn),
                           kernels.stream_ptr(dev))
    kernels.check(err, _RESBLOCK)
    return out


def fused_resblock_eval(x, w1, b1, bn1, w2, b2, bn2, *,
                        use_bn: bool = True) -> torch.Tensor:
    """The JAX function's signature: x (N, C) f32; w1/w2 (C, C) center-tap
    matrices already in (in, out) layout; b1/b2 (C,); bn1/bn2 (mean, var,
    scale, bias) tuples of (C,) eval statistics (zeros when use_bn is
    False). Stacks the (10, C) vector rows and runs `resblock_eval`."""
    vec = torch.stack([b1, *bn1, b2, *bn2]).float()
    return resblock_eval(x, w1, w2, vec, use_bn=use_bn)


def fused_encoder_entry_eval(patches, w_pe, b_pe, weights, vecs, *,
                             use_bn: bool = True,
                             split: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """patch-embed + the first resblock group in one kernel. patches
    (N, patch) f32 from ops/patching.patchify; w_pe (patch, C); b_pe
    (C,). Returns (N, C) f32; the patch-embed output stays in the
    kernel. split: `split_weights(weights)`, as for
    `fused_encoder_eval` (made here, per call, when not given). Above
    hidden 512, `encoder_wide_entry_f32`: the patch-embed, then the
    resblocks, one launch each."""
    if not _on_card(_ENTRY, patches):
        return fused_encoder_entry_eval_reference(patches, w_pe, b_pe,
                                                  weights, vecs,
                                                  use_bn=use_bn)
    n, pz = patches.shape
    c = w_pe.shape[1]
    dev = patches.device
    nb = _require_chain(_ENTRY, c, weights, vecs, dev)
    if not 1 <= pz <= kernel_width(c):
        raise ValueError(f"{_ENTRY}: patch size {pz} not supported (1 to "
                         f"{kernel_width(c)} at hidden {c})")
    kernels.require(patches, "patches", torch.float32, (n, pz), dev)
    kernels.require(w_pe, "w_pe", torch.float32, (pz, c), dev)
    kernels.require(b_pe, "b_pe", torch.float32, (c,), dev)
    if not on_tile(c):
        out = torch.empty((n, c), dtype=torch.float32, device=dev)
        if n == 0:
            return out
        h = torch.empty_like(out)
        lib = kernels.library()
        kernels.launches[_WIDE_ENTRY] += 1
        err = lib.encoder_wide_entry_f32(
            patches.data_ptr(), w_pe.data_ptr(), b_pe.data_ptr(),
            weights.data_ptr(), vecs.data_ptr(), h.data_ptr(),
            out.data_ptr(), n, pz, c, nb, int(use_bn),
            kernels.stream_ptr(dev))
        kernels.check(err, _WIDE_ENTRY)
        return out
    operand = _split_operand(_ENTRY, weights, split)
    _aligned(_ENTRY, w_pe=w_pe, b_pe=b_pe, weights=operand)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = kernels.library()
    kernels.launches[_ENTRY] += 1
    err = lib.encoder_entry_f32(patches.data_ptr(), w_pe.data_ptr(),
                                b_pe.data_ptr(), operand.data_ptr(),
                                vecs.data_ptr(), out.data_ptr(), n, pz, c, nb,
                                int(use_bn), kernels.stream_ptr(dev))
    kernels.check(err, _ENTRY)
    return out


def fused_encoder_exit_eval(x, weights, vecs, w_sep, b_sep, codebook, *,
                            use_bn: bool = True,
                            split: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The last resblock group + sep_conv + the nearest code in one
    kernel. x (N, C) f32; w_sep (C, D); b_sep (D,); codebook (K, D).
    Returns (N,) int32 ids; z and the distances stay in the kernel (the
    residual stream between the group's resblocks goes through an
    (N, C) buffer made here, as #1's output). Any K, D from 1 to
    256 (ops/fused_vq.MAX_D). split: as for `fused_encoder_entry_eval`. Above hidden
    512, `encoder_wide_exit_f32`: the resblocks, one launch each, then
    sep_conv and the nearest code."""
    if not _on_card(_EXIT, x):
        return fused_encoder_exit_eval_reference(x, weights, vecs, w_sep,
                                                 b_sep, codebook,
                                                 use_bn=use_bn)
    n, c = x.shape
    k, d = codebook.shape
    dev = x.device
    nb = _require_chain(_EXIT, c, weights, vecs, dev)
    require_codebook(_EXIT, k, d)
    kernels.require(x, "x", torch.float32, (n, c), dev)
    kernels.require(w_sep, "w_sep", torch.float32, (c, d), dev)
    kernels.require(b_sep, "b_sep", torch.float32, (d,), dev)
    kernels.require(codebook, "codebook", torch.float32, (k, d), dev)
    if not on_tile(c):
        ids = torch.empty((n,), dtype=torch.int32, device=dev)
        if n == 0:
            return ids
        h, resid = torch.empty_like(x), torch.empty_like(x)
        lib = kernels.library()
        kernels.launches[_WIDE_EXIT] += 1
        err = lib.encoder_wide_exit_f32(
            x.data_ptr(), weights.data_ptr(), vecs.data_ptr(),
            w_sep.data_ptr(), b_sep.data_ptr(), codebook.data_ptr(),
            h.data_ptr(), resid.data_ptr(), ids.data_ptr(), n, c, nb,
            int(use_bn), d, k, kernels.stream_ptr(dev))
        kernels.check(err, _WIDE_EXIT)
        return ids
    operand = _split_operand(_EXIT, weights, split)
    _aligned(_EXIT, x=x, codebook=codebook, weights=operand)
    ids = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return ids
    resid = torch.empty_like(x)
    lib = kernels.library()
    kernels.launches[_EXIT] += 1
    err = lib.encoder_exit_f32(x.data_ptr(), operand.data_ptr(),
                               vecs.data_ptr(), w_sep.data_ptr(),
                               b_sep.data_ptr(), codebook.data_ptr(),
                               resid.data_ptr(), ids.data_ptr(), n, c, nb,
                               int(use_bn), d, k, kernels.stream_ptr(dev))
    kernels.check(err, _EXIT)
    return ids


# -- the encoder on the kernels ------------------------------------------------

def group_size_for(hidden: int, weight_bytes: int = 4) -> int:
    """Resblocks per call: as many as fit 8 MB of weights of
    `weight_bytes` each (the JAX rule): 4 in f32 and 8 in bf16 at
    hidden 512."""
    return max(1, (8 << 20) // (2 * hidden * hidden * weight_bytes))


def _split_of(packed, i0: int, i1: int) -> dict:
    """The keyword that hands resblocks i0..i1 of an f32 pack's split to
    a wrapper; none for a pack without one."""
    split = getattr(packed, "split", None)
    return {} if split is None else {"split": split[2 * i0:2 * i1]}


def _chain_groups(flat, packed, s0: int, s1: int, group_size: int,
                  use_bn: bool, compute_dtype=None) -> torch.Tensor:
    """Resblocks s0..s1 of `packed` through the chain kernel, group_size
    per call."""
    weights, vecs = packed
    for g0 in range(s0, s1, group_size):
        g1 = min(g0 + group_size, s1)
        flat = fused_encoder_eval(
            flat, weights[2 * g0:2 * g1], vecs[10 * g0:10 * g1],
            use_bn=use_bn, compute_dtype=compute_dtype,
            **_split_of(packed, g0, g1))
    return flat


def _sep_nearest(model, flat: torch.Tensor, b: int, p: int) -> torch.Tensor:
    """sep_conv and the plain nearest-code search on the chain's output,
    whatever the model's vq_impl (as the JAX functions)."""
    z_e = model.sep_conv(flat.reshape(b, p, -1))
    return nearest_codes(z_e.reshape(-1, model.embedding_dim),
                         model.codebook).reshape(b, p)


def encoder_resblocks_fused(model, packed, h: torch.Tensor) -> torch.Tensor:
    """All encoder resblocks, one launch of the one-resblock kernel each,
    on views of `packed`. h: (B, P, C) patch-embed output -> (B, P, C),
    the input to sep_conv."""
    b, p, c = h.shape
    weights, vecs = packed
    flat = h.reshape(b * p, c)
    for i in range(model.n_resblocks):
        flat = resblock_eval(flat, weights[2 * i], weights[2 * i + 1],
                             vecs[10 * i:10 * (i + 1)],
                             use_bn=model.batch_norm,
                             **_split_of(packed, i, i + 1))
    return flat.reshape(b, p, c)


def encode_indices_fused(model, packed: tuple[torch.Tensor, torch.Tensor],
                         x: torch.Tensor, *,
                         group_size: int | None = None,
                         compute_dtype=None) -> torch.Tensor:
    """VQVAEPatch.encode_indices with the resblock chain on the fused
    kernels; patch-embed, sep_conv and the nearest-code argmin stay
    plain PyTorch. group_size: resblocks per call (default
    `group_size_for(hidden)`); above 1 the chain kernel runs each group,
    at 1 the one-resblock kernel runs each block. packed:
    `pack_encoder(model)`. x: (B, seq_len, input_dim) -> (B,
    enc_out_len) int32.

    compute_dtype: None = f32 products (split TF32 on the card), the
    default serving contract.
    torch.bfloat16 = the products' inputs in bf16 (see
    `fused_encoder_eval`): ids may differ from the f32 encoder's near
    Voronoi boundaries. The chain kernel then runs at every group size,
    1 included, and the default group is 8 MB of bf16 weights. packed:
    `pack_encoder(model, torch.bfloat16)`; an f32 pack is cast here."""
    wbytes = 4
    if compute_dtype is not None:
        wbytes = 2
        if packed[0].dtype != _compute_dtype(compute_dtype):
            packed = (packed[0].to(compute_dtype), packed[1])
    if group_size is None:
        group_size = group_size_for(model.hidden_dim, wbytes)
    h = model.patch_embed_out(x)
    b, p, c = h.shape
    if group_size > 1 or compute_dtype is not None:
        flat = _chain_groups(h.reshape(b * p, c), packed, 0,
                             model.n_resblocks, group_size, model.batch_norm,
                             compute_dtype)
    else:
        flat = encoder_resblocks_fused(model, packed, h)
    return _sep_nearest(model, flat, b, p)


def encode_indices_fused_mono(model, packed,
                              x: torch.Tensor) -> torch.Tensor:
    """encode_indices_fused with the whole resblock stack in one launch
    of the chain kernel."""
    h = model.patch_embed_out(x)
    b, p, c = h.shape
    weights, vecs = packed
    flat = fused_encoder_eval(h.reshape(b * p, c), weights, vecs,
                              use_bn=model.batch_norm,
                              **_split_of(packed, 0, model.n_resblocks))
    return _sep_nearest(model, flat, b, p)


def encode_indices_fused_edges(model, packed, edges, x: torch.Tensor, *,
                               group_size: int | None = None) -> torch.Tensor:
    """encode_indices_fused with the encoder's ends in the kernels too:
    patch-embed rides the first group's kernel, sep_conv and the
    nearest-code argmin the last one's: cycles in, int32 ids out, and
    only the residual stream between launches. Needs at least two
    groups; with fewer it is encode_indices_fused. packed:
    `pack_encoder(model)`; edges: `pack_encoder_edges(model)`."""
    if group_size is None:
        group_size = group_size_for(model.hidden_dim)
    nb = model.n_resblocks
    if nb < 2 * group_size:
        return encode_indices_fused(model, packed, x, group_size=group_size)
    b = x.shape[0]
    patches = patchify(x, model.patch_size)
    n_p = patches.shape[1]
    weights, vecs = packed
    w_pe, b_pe, w_sep, b_sep = edges
    use_bn = model.batch_norm
    last = (nb - 1) // group_size * group_size     # the last group's start
    flat = fused_encoder_entry_eval(
        patches.reshape(b * n_p, model.patch_size), w_pe, b_pe,
        weights[:2 * group_size], vecs[:10 * group_size], use_bn=use_bn,
        **_split_of(packed, 0, group_size))
    flat = _chain_groups(flat, packed, group_size, last, group_size, use_bn)
    ids = fused_encoder_exit_eval(flat, weights[2 * last:], vecs[10 * last:],
                                  w_sep, b_sep, model.codebook, use_bn=use_bn,
                                  **_split_of(packed, last, nb))
    return ids.reshape(b, n_p)
