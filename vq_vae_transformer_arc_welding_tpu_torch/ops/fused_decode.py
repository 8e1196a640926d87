"""One token of KV-cached sampling through a block, as one kernel launch.

Port of vq_vae_transformer_arc_welding_tpu/ops/pallas_decode.py:
`fused_decode_attn` (the pallas_call at :149, kernel #12), a block's
attention half against (B, H, T, D) caches, and `fused_block_decode`
(the pallas_call at :371, kernel #13), the whole block against (B, T, C)
time-major caches. The kernels are `csrc/decode.cu` (`decode_attn_f32`,
`block_decode_f32`), one cooperative launch a call each;
`fused_decode_attn_reference` and `fused_block_decode_reference` are
their plain PyTorch versions. `BlockDecodeStack` runs #13 through every
block of a model for one generation, its operands checked and its
scratch allocated once (`block_decode_stack_reference`: its plain
version).

    h = LN1(x); q, k, v = h Wqkv + b; row `pos` of K and V written;
    y = softmax(q K[:pos+1]^T / sqrt(D)) V[:pos+1], per head;
    x_mid = x + y Wproj + b                                      (#12)
    x_out = x_mid + new_gelu(LN2(x_mid) Wfc + b) Wmp + b         (#13)

`blk` is a transformer Block of this package (models/transformer.py),
its weights f32 in torch's (out, in) layout. `pos` is a Python int, known
on the host: nothing here waits for the device.

The caches are updated IN PLACE and returned: only row `pos` is
written, every other row stays bit for bit as it was, and only rows
0..pos are read.

What the TPU shaped and this port drops:
- `DECODE_CHUNK = 128` and the ValueError for a cache length that is no
  multiple of it were DMA tiling; any T is taken here.
- The token row padded to 8 rows, and the 8-row write-back window of
  #13. In the JAX kernel that window returns V rows pos+1 ..
  8*(pos//8)+7 as zeros and leaves K rows there as they were; rows
  beyond `pos` are never read before their own step writes them, so
  only rows <= pos compare between the two packages.
- The bias folded into the product through a ones column: the bias is
  added after the sum, which moves the last bits.
- The kernels may contract a product and a sum into one FMA: the JAX
  package's contract for these kernels is a tolerance, not bits (as
  for the encoder kernels, whose ids must equal the plain encoder's but
  for near-ties).

Widths: any C from 1 to `kernels.MAX_WIDTH` in any heads, any MLP
width. The kernels read every product's depth zero-padded to a multiple
of 64 (`pad64`; zeros add exact 0s to every sum): the LayerNorm vectors
padded to pad64(C), and the stream x and the outputs in rows of pad64(C)
floats (`_padded_rows`). A weight (n, k) is read in rows of pad64(k)
floats, as it is where k is a multiple of 64 (`_pad_cols`), or packed
(`_packed`). csrc/decode.cu has two forms and picks one for the shape:
the first form, at the shapes it took first (C and the MLP width
multiples of 64 up to C 1,024, heads up to 128: the bench model), reads
the rows; the general form, at every other shape, walks the depth in
pieces of up to `PIECE` floats and the columns in chunks of 8, and
reads either, the packed weights one bulk copy a chunk and the rows a
copy a row. `BlockDecodeStack` packs a generation's weights once, where
the kernel says it runs the general form (`_general`), a second copy of
them for the generation; the per-call wrappers copy nothing where C and
the MLP width are multiples of 64, and pad the rows per call where not.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. Nothing falls back. For the card's times see
PERF.md.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import kernels
from .activations import new_gelu
from .attention import merge_heads, split_heads
from .norm import layer_norm

_ATTN = "decode_attn_f32"
_BLOCK = "block_decode_f32"
MAX_KC = 512        # the widest k piece of csrc/decode.cu's products
PIECE = MAX_KC      # the general form's k piece (decode.cu's PIECE_K)
MAX_GRID = 1024     # its blocks; the barrier holds a count for each
NCOL = 8            # output columns a chunk of a product
MAX_COLS = 32       # a column group's columns
# the general form's attention of heads past kernels.MAX_HEAD_DIM: the
# key ranges an item may be split in (decode.cu's MAX_RANGES)
MAX_RANGES = 16


class DecodeArgs(ctypes.Structure):
    """csrc/decode.cu's DecodeArgs: one block's operands for a launch,
    packed once. Pointers are device addresses; the caches' element (b,
    h, t, e) is at b*sb + h*sh + t*st + e (floats)."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "ln1_s", "ln1_b", "w_qkv", "b_qkv", "w_proj", "b_proj", "ln2_s",
        "ln2_b", "w_fc", "b_fc", "w_mp", "b_mp", "kc", "vc", "scratch",
        "barrier")]
        + [(name, ctypes.c_longlong) for name in ("sb", "sh", "st")]
        + [(name, ctypes.c_int) for name in ("batch", "t", "c", "c4",
                                             "n_head")]
        + [("sm_scale", ctypes.c_float), ("packed", ctypes.c_int)])


def _dense(x: torch.Tensor, p) -> torch.Tensor:
    return x @ p.weight.t() + p.bias


def _attend(q, k_rows, v_rows):
    """q (B, H, 1, D) against k_rows, v_rows (B, H, P, D): all P valid."""
    att = (q @ k_rows.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.softmax(att, dim=-1) @ v_rows


def fused_decode_attn_reference(x, blk, kc, vc, pos: int, *, n_head: int):
    """Plain version of #12. x (B, 1, C); kc, vc (B, H, T, D), row `pos`
    written in place. Returns (x_mid (B, 1, C), kc, vc)."""
    c = x.shape[-1]
    h = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
    q, k, v = (split_heads(z, n_head)
               for z in _dense(h, blk.attn.c_attn).split(c, dim=-1))
    kc[:, :, pos] = k[:, :, 0]
    vc[:, :, pos] = v[:, :, 0]
    y = merge_heads(_attend(q, kc[:, :, :pos + 1], vc[:, :, :pos + 1]))
    return x + _dense(y, blk.attn.c_proj), kc, vc


def fused_block_decode_reference(x, blk, kc, vc, pos: int, *, n_head: int):
    """Plain version of #13. x (B, 1, C); kc, vc (B, T, C) time-major,
    row `pos` written in place. Returns (x_out (B, 1, C), kc, vc)."""
    b, _, c = x.shape
    h = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
    q, k, v = _dense(h, blk.attn.c_attn).split(c, dim=-1)
    kc[:, pos] = k[:, 0]
    vc[:, pos] = v[:, 0]
    y = merge_heads(_attend(split_heads(q, n_head),
                            split_heads(kc[:, :pos + 1], n_head),
                            split_heads(vc[:, :pos + 1], n_head)))
    x_mid = x + _dense(y, blk.attn.c_proj)
    h = layer_norm(x_mid, blk.ln_2.weight, blk.ln_2.bias)
    return (x_mid + _dense(new_gelu(_dense(h, blk.mlp.c_fc)),
                           blk.mlp.c_proj), kc, vc)


def _check_pos(name, pos, t):
    if not isinstance(pos, int) or not 0 <= pos < t:
        raise ValueError(f"{name}: pos must be an int in [0, {t}), got "
                         f"{pos!r}")


def _check_x(name, x, b, c, dev):
    if x.dim() != 3 or x.shape[1] != 1:
        raise ValueError(f"{name}: x must be (B, 1, C), got {tuple(x.shape)}")
    kernels.require(x, "x", torch.float32, (b, 1, c), dev)


def pad64(n: int) -> int:
    """n rounded up to a multiple of 64: a product's padded depth
    (csrc/decode.cu::pad64)."""
    return -(-n // 64) * 64


def _pad_cols(p: torch.Tensor, k: int) -> torch.Tensor:
    """p (..., n) with zero columns up to k; p itself where n == k."""
    if p.shape[-1] == k:
        return p
    out = p.new_zeros((*p.shape[:-1], k))
    out[..., :p.shape[-1]] = p
    return out


def _packed(w: torch.Tensor, k: int) -> torch.Tensor:
    """w (n, k_real) as csrc/decode.cu's general form reads it, flat: the
    depth zero-padded to k = pad64(k_real) and cut in pieces of PIECE
    floats (the last one shorter), the rows zero-padded to 8 n8; piece q
    holds the chunks j = 0 .. n8 - 1 in turn, chunk j its 8 rows of the
    piece's kq floats, so chunk j of piece q lies at 8 n8 PIECE q + 8 j kq
    floats, one range."""
    n, kp = w.shape[0], pad64(k)
    rows = -(-n // NCOL) * NCOL
    full = w.new_zeros((rows, kp))
    full[:n, :w.shape[1]] = w
    return torch.cat([full[:, s:s + PIECE].reshape(-1)
                      for s in range(0, kp, PIECE)])


def _unpacked(flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The (n, pad64(k)) matrix that `_packed` laid out in `flat`."""
    kp = pad64(k)
    rows = -(-n // NCOL) * NCOL
    parts, at = [], 0
    for s in range(0, kp, PIECE):
        kq = min(PIECE, kp - s)
        parts.append(flat[at:at + rows * kq].view(rows, kq))
        at += rows * kq
    return torch.cat(parts, dim=1)[:n]


def _padded_weights(operands, c: int, c4: int, packed: bool) -> list:
    """The block's tensors in DecodeArgs' order, each product's depth
    padded with zeros to pad64, the weights packed (`_packed`) where
    `packed`; the LayerNorm vectors padded to pad64(C)."""
    depth = {"ln_1.weight": c, "ln_1.bias": c, "c_attn.weight": c,
             "attn.c_proj.weight": c, "ln_2.weight": c, "ln_2.bias": c,
             "c_fc.weight": c, "mlp.c_proj.weight": c4}
    out = []
    for label, p, _ in operands:
        if label not in depth:
            out.append(p)
        elif packed and p.dim() == 2:
            out.append(_packed(p, depth[label]))
        else:
            out.append(_pad_cols(p, pad64(depth[label])))
    return out


def _general(c: int, c4: int, n_head: int, mlp: bool, dev) -> bool:
    """Whether csrc/decode.cu runs its general form at this shape on
    `dev`, the only one that reads packed weights (where its first form
    does not take the shape; a CPU tensor: the general one)."""
    if dev.type != "cuda":
        return True
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    args = DecodeArgs(c=c, c4=c4, n_head=n_head)
    form = kernels.library().decode_general_form(ctypes.addressof(args),
                                                 int(mlp), index)
    if form < 0:
        kernels.check(-form, "decode_general_form")
    return bool(form)


class _Operands(tuple):
    """(the pointers of a block's weights in DecodeArgs' order, c4);
    `.tensors`: the (padded, packed) tensors behind the pointers, which
    must outlive every launch that reads them; `.packed`: whether the
    weights are packed (`_packed`)."""

    def __new__(cls, ptrs, c4, tensors, packed):
        self = super().__new__(cls, (ptrs, c4))
        self.tensors = tensors
        self.packed = packed
        return self


def _check_operands(name, blk, kc, vc, cache_shape, n_head, mlp, dev, *,
                    packed: bool | None = False):
    """Raise unless the kernel takes the block and the caches; the
    block's `_Operands`, the weights in rows of pad64(k) floats or, where
    `packed`, packed (which only the general form reads; None: packed
    where the kernel runs the general form on `dev`)."""
    c = blk.ln_1.weight.shape[0]
    kernels.require_heads(name, c, n_head)
    kernels.require(kc, "kc", torch.float32, cache_shape, dev)
    kernels.require(vc, "vc", torch.float32, cache_shape, dev)
    c4 = blk.mlp.c_fc.weight.shape[0] if mlp else 0
    operands = [("ln_1.weight", blk.ln_1.weight, (c,)),
                ("ln_1.bias", blk.ln_1.bias, (c,)),
                ("c_attn.weight", blk.attn.c_attn.weight, (3 * c, c)),
                ("c_attn.bias", blk.attn.c_attn.bias, (3 * c,)),
                ("attn.c_proj.weight", blk.attn.c_proj.weight, (c, c)),
                ("attn.c_proj.bias", blk.attn.c_proj.bias, (c,))]
    if mlp:
        operands += [("ln_2.weight", blk.ln_2.weight, (c,)),
                     ("ln_2.bias", blk.ln_2.bias, (c,)),
                     ("c_fc.weight", blk.mlp.c_fc.weight, (c4, c)),
                     ("c_fc.bias", blk.mlp.c_fc.bias, (c4,)),
                     ("mlp.c_proj.weight", blk.mlp.c_proj.weight, (c, c4)),
                     ("mlp.c_proj.bias", blk.mlp.c_proj.bias, (c,))]
    for label, p, shape in operands:
        kernels.require(p, label, torch.float32, shape, dev)
    if packed is None:
        packed = _general(c, c4, n_head, mlp, dev)
    padded = _padded_weights(operands, c, c4, packed)
    for (label, _, _), p in zip(operands, padded):
        if p.data_ptr() % 16:
            raise ValueError(f"{name}: {label} is not 16-byte aligned")
    return _Operands([p.data_ptr() for p in padded]
                     + [None] * (12 - len(padded)), c4, padded, packed)


def _checked(name, x, blk, kc, vc, cache_shape, pos, n_head, mlp: bool):
    """Raise unless the kernel takes these operands; as _check_operands."""
    b, c = x.shape[0], x.shape[-1]
    _check_x(name, x, b, c, x.device)
    checked = _check_operands(name, blk, kc, vc, cache_shape, n_head, mlp,
                              x.device)
    _check_pos(name, pos, cache_shape[2] if len(cache_shape) == 4
               else cache_shape[1])
    return checked


@functools.cache
def _barrier(device: torch.device) -> torch.Tensor:
    """The kernels' grid barrier on `device`: an arrival count and a
    generation, then m_proj's count per column range (csrc/decode.cu);
    every launch leaves the counts at 0. One per device, zeroed once; the
    launches on a device run one after another."""
    return torch.zeros(2 + MAX_GRID, dtype=torch.int32, device=device)


def _chunk_k(c: int, c4: int) -> int:
    """The kernels' k piece: the largest multiple of 64 up to MAX_KC that
    divides pad64(C) and pad64(c4)."""
    return next(kc for kc in range(MAX_KC, 0, -64)
                if pad64(c) % kc == 0 and pad64(c4) % kc == 0)


def _is_padded(c: int, c4: int) -> bool:
    return pad64(c) != c or pad64(c4) != c4


def _wide_units(b: int, n_head: int, c: int) -> int:
    """The floats of the general form's wide attention (heads past
    kernels.MAX_HEAD_DIM) in the scratch: (max, sum, output) of every
    (sample, head, key range) unit where the items may be split
    (decode.cu::wide_unit_floats)."""
    hd, items = c // n_head, b * n_head
    if hd <= kernels.MAX_HEAD_DIM or items >= MAX_GRID:
        return 0
    return min(items * MAX_RANGES, MAX_GRID) * (hd + 2)


def _scratch(b, c, c4, n_head, dev) -> torch.Tensor:
    """q (b x C), y, x_mid (b x pad64(C) each), g (b x pad64(c4)), the
    wide attention's units (`_wide_units`) and m_proj's partial sums (up
    to its pieces of either form x b x C), f32; zero where the rows are
    padded (the kernels never write the columns past C, c4)."""
    cp, c4p = pad64(c), pad64(c4)
    parts = (max(c4p // _chunk_k(c, c4), -(-c4p // PIECE)) * c if c4
             else 0)
    make = torch.zeros if _is_padded(c, c4) else torch.empty
    return make(b * (c + 2 * cp + c4p + parts) + _wide_units(b, n_head, c),
                dtype=torch.float32, device=dev)


def _padded_rows(x: torch.Tensor, c: int, c4: int) -> torch.Tensor:
    """x (B, 1, C) as the kernels read the stream: rows of pad64(C)
    floats, zero past C (x itself where nothing is padded)."""
    return _pad_cols(x, pad64(c)) if _is_padded(c, c4) else x


def _rows_out(b: int, c: int, c4: int, dev) -> torch.Tensor:
    """An output buffer for the stream (B, 1, pad64(C)), zero past C."""
    make = torch.zeros if _is_padded(c, c4) else torch.empty
    return make((b, 1, pad64(c)), dtype=torch.float32, device=dev)


def _pack(ops: _Operands, kc, vc, strides, scratch, b, t, c, c4,
          n_head) -> DecodeArgs:
    return DecodeArgs(*ops[0], kc.data_ptr(), vc.data_ptr(),
                      scratch.data_ptr(), _barrier(kc.device).data_ptr(),
                      *strides, b, t, c, c4, n_head,
                      1.0 / math.sqrt(c // n_head), int(ops.packed))


def _launch(name, args: DecodeArgs, x, out, pos, stream) -> None:
    lib = kernels.library()
    kernels.launches[name] += 1
    err = getattr(lib, name)(ctypes.addressof(args), x.data_ptr(),
                             out.data_ptr(), pos, stream)
    kernels.check(err, name)


def fused_decode_attn(x, blk, kc, vc, pos: int, *, n_head: int):
    """One block's attention half for a single decode token (#12).

    x: (B, 1, C) f32 residual stream entering the block. blk: a
    transformer Block. kc/vc: (B, H, T, D) f32 caches, row `pos`
    written in place. pos: int. Returns (x_mid (B, 1, C), kc, vc)."""
    if x.device.type == "cpu":
        return fused_decode_attn_reference(x, blk, kc, vc, pos,
                                           n_head=n_head)
    if x.device.type != "cuda":
        raise ValueError(f"{_ATTN}: no kernel for device {x.device}")
    b, _, c = x.shape
    t = kc.shape[2] if kc.dim() == 4 else -1
    hd = c // n_head
    # `checked` holds the padded weights until the launch is queued
    checked = _checked(_ATTN, x, blk, kc, vc, (b, n_head, t, hd), pos,
                       n_head, mlp=False)
    scratch = _scratch(b, c, 0, n_head, x.device)
    x_mid = _rows_out(b, c, 0, x.device)
    args = _pack(checked, kc, vc, (n_head * t * hd, t * hd, hd), scratch, b,
                 t, c, 0, n_head)
    _launch(_ATTN, args, _padded_rows(x, c, 0), x_mid, pos,
            kernels.stream_ptr(x.device))
    return x_mid[..., :c].contiguous(), kc, vc


def fused_block_decode(x, blk, kc, vc, pos: int, *, n_head: int):
    """One whole transformer block for a single decode token (#13).

    x: (B, 1, C) f32 residual stream entering the block. blk: a
    transformer Block. kc/vc: (B, T, C) f32 caches, time-major with the
    heads packed along C, any T; row `pos` written in place. pos: int.
    Returns (x_out (B, 1, C), kc, vc). Same function as the block body
    of TransformerDecoder._token_step."""
    if x.device.type == "cpu":
        return fused_block_decode_reference(x, blk, kc, vc, pos,
                                            n_head=n_head)
    if x.device.type != "cuda":
        raise ValueError(f"{_BLOCK}: no kernel for device {x.device}")
    b, _, c = x.shape
    t = kc.shape[1] if kc.dim() == 3 else -1
    # `checked` holds the padded weights until the launch is queued
    checked = _checked(_BLOCK, x, blk, kc, vc, (b, t, c), pos, n_head,
                       mlp=True)
    c4 = checked[1]
    scratch = _scratch(b, c, c4, n_head, x.device)
    out = _rows_out(b, c, c4, x.device)
    args = _pack(checked, kc, vc, (t * c, c // n_head, c), scratch, b, t, c,
                 c4, n_head)
    _launch(_BLOCK, args, _padded_rows(x, c, c4), out, pos,
            kernels.stream_ptr(x.device))
    return out[..., :c].contiguous(), kc, vc


def check_stack(blocks, caches, *, n_head: int) -> list:
    """Raise unless kernel #13 takes every block with its caches, (B, T,
    C) f32 each: the checks of `fused_block_decode` but x and pos, once
    for a generation. The `_Operands` (pointers of the block's weights in
    DecodeArgs' order, c4) per block, the weights packed where the kernel
    runs its general form. Device-agnostic: on CPU tensors it checks what
    the card would refuse (and packs)."""
    kc0 = caches[0][0]
    if kc0.dim() != 3:
        raise ValueError(f"{_BLOCK}: the caches must be (B, T, C), got "
                         f"{tuple(kc0.shape)}")
    return [_check_operands(_BLOCK, blk, kc, vc, tuple(kc0.shape), n_head,
                            True, kc0.device, packed=None)
            for blk, (kc, vc) in zip(blocks, caches)]


def check_step(x, pos, caches) -> None:
    """Raise unless #13 takes x (B, 1, C) and pos against these caches:
    the checks of a token step."""
    b, t, c = caches[0][0].shape
    _check_x(_BLOCK, x, b, c, caches[0][0].device)
    _check_pos(_BLOCK, pos, t)


class BlockDecodeStack:
    """Kernel #13 through every block of a model, for one generation.

    blocks: the model's transformer Blocks; caches: [(kc, vc)] per
    block, (B, T, C) f32 time-major, updated in place. On the card the
    operands of every block are checked here, once (`check_stack`), and
    packed into one DecodeArgs each (the weights packed, `_packed`, where
    the kernel runs its general form), with the
    scratch and two output rows allocated once. A call `stack(x, pos)`
    then checks x and pos (`check_step`) and costs one C call (one
    launch, counted in kernels.launches) a block. It returns the stream
    after the last block, in (a view of) a buffer that the next call
    reuses. On the CPU each block goes through `fused_block_decode`, the
    plain version."""

    def __init__(self, blocks, caches, *, n_head: int):
        self.blocks, self.caches, self.n_head = list(blocks), caches, n_head
        self.device = caches[0][0].device
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"{_BLOCK}: no kernel for device {self.device}")
        checked = check_stack(self.blocks, caches, n_head=n_head)
        b, t, c = caches[0][0].shape
        c4 = checked[0][1]
        self._c = c
        self._weights = [ops.tensors for ops in checked]
        self._scratch = _scratch(b, c, c4, n_head, self.device)
        # the stream in the kernel's rows where C is padded
        self._x = (_rows_out(b, c, c4, self.device)
                   if _is_padded(c, c4) else None)
        self._outs = [_rows_out(b, c, c4, self.device) for _ in range(2)]
        self._args = [_pack(ops, kc, vc, (t * c, c // n_head, c),
                            self._scratch, b, t, c, c4, n_head)
                      for ops, (kc, vc) in zip(checked, caches)]
        self._fn = getattr(kernels.library(), _BLOCK)

    def __call__(self, x, pos: int):
        if self.device.type == "cpu":
            for blk, (kc, vc) in zip(self.blocks, self.caches):
                x, _, _ = fused_block_decode(x, blk, kc, vc, pos,
                                             n_head=self.n_head)
            return x
        check_step(x, pos, self.caches)
        if self._x is not None:
            self._x[..., :self._c] = x
            x = self._x
        stream = kernels.stream_ptr(self.device)
        for i, args in enumerate(self._args):
            out = self._outs[i % 2]
            kernels.launches[_BLOCK] += 1
            err = self._fn(ctypes.addressof(args), x.data_ptr(),
                           out.data_ptr(), pos, stream)
            kernels.check(err, _BLOCK)
            x = out
        return x[..., :self._c]


def block_decode_stack_reference(blocks, caches, *, n_head: int):
    """Plain version of BlockDecodeStack: `run(x, pos)` takes x through
    every block with `fused_block_decode_reference`."""
    def run(x, pos):
        for blk, (kc, vc) in zip(blocks, caches):
            x, _, _ = fused_block_decode_reference(x, blk, kc, vc, pos,
                                                   n_head=n_head)
        return x
    return run
