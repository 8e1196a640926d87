#!/usr/bin/env python3
"""The transformer's int8 kernels and the f32 attention at the bench
model's shapes, against another tree's, on an NVIDIA GPU: the same bits
and the time of each.

    python3 scripts/bench_transformer_shapes.py --other DIR [--out FILE]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive` into a git-ignored directory such
as vq_vae_transformer_arc_welding_tpu_torch/_build/parent). The script
runs one process per turn, in the order other / this tree / this tree /
other, each on the same card. Each process builds its tree's kernels
and, on operands made from seed 0 at the bench model's shapes (batch
80, T=321, C=512, 8 heads of 64; #9 at batch 16), calls #2
(`attn_block_quant`, with its scratch), #6 (`block_quant`, with its
scratch), both also with `int8_attn` (the int8 attention, its quantizing
pass's qkv8 and scales among the outputs), #8 (`mlp_quant`), #9
(`flash_attention_forward` on f32 q, k, v, and on the same q, k, v in
bf16), #10 (`qkv_attention_quant`), #11 (`fused_causal_attention_quant`),
the int8 GEMM alone at its four shapes in a block (c_fc also with the
monitor's clip counts) and #13 (`fused_block_decode` on a block built
from seed 0, 16 streams at pos 160 of (16, 321, 512) caches; its output
and the written cache rows). Then the wide attention tiles (heads past
128) at WIDE_SHAPES (batch, heads, T, head width): #9 on f32 and on
bf16 q, k, v, each beside its plain version
(`flash_causal_attention_reference`) and
`scaled_dot_product_attention(is_causal=True)` on the same operands
(both the same code in every tree: torch's), and #2 at C 2,048 in 8
heads of 256 (WIDE_BLOCK), whose f32 attention runs the f32 wide tile.
It reports for each:

- a sha256 of every output and intermediate it returns, so that two
  trees whose arithmetic is the same can be seen to give the same bits;
- ms of one call between CUDA events (host launch included), the
  median of 10 after 3 warm-up calls;
- ms a call of 20 calls in a row between two CUDA events (the host
  runs ahead, so the card's own pace), the median of 10;
- device ms per call of all its launches, from torch.profiler over 5
  calls after two warm-up rounds.

Prints one row per case and metric, the card's name and power limit,
and last one JSON object with every turn's numbers (also written to
FILE). Needs a CUDA device; imports no jax.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
B, T, C, HEADS = 80, 321, 512, 8
FLASH_B = 16                # #9's batch, and #13's streams
DECODE_POS = 160
# the wide tiles' shapes: (batch, heads, T, head width)
WIDE_SHAPES = ((4, 1, T, 4096), (4, 6, T, 300), (80, 8, T, 256))
WIDE_BLOCK = (2048, 8)      # #2's (C, heads) on the f32 wide tile


def device_ms(fn, calls=5):
    """(device ms per call of all of fn's kernels, their names), by
    torch.profiler (two warm-up rounds, then one traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=1,
                                   repeat=1)) as prof:
        for _ in range(3):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() / 1e3 for e in events) / calls,
            sorted({e.name[:60] for e in events}))


def event_ms(fn, reps=10, warmup=3):
    """Median ms of one fn() between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def row_ms(fn, calls=20, reps=10):
    """Median ms a call of `calls` calls in a row between two CUDA
    events, after a warm-up round."""
    return event_ms(lambda: [fn() for _ in range(calls)], reps=reps,
                    warmup=1) / calls


def operands(c: int = C):
    """A calibrated block's operands at width c, at magnitudes like the
    card tests' (tests/test_torch_cuda.py::_block_operands; the
    dequantization rows scaled by sqrt(C / c), so that the products keep
    their size at every width), and x."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    r = (C / c) ** 0.5

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()
    w_qkv = t(rng.integers(-127, 128, (3 * c, c), np.int8))
    w_proj = t(rng.integers(-127, 128, (c, c), np.int8))
    w_fc = t(rng.integers(-127, 128, (4 * c, c), np.int8))
    w_mp = t(rng.integers(-127, 128, (c, 4 * c), np.int8))
    scales = t(np.array([30.0, 200.0, 30.0, 30.0], np.float32))
    vc = t(np.stack([rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
                     rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
                     np.full(c, 2e-5 * r), rng.standard_normal(c) * 0.01,
                     np.full(c, 2e-5 * r), rng.standard_normal(c) * 0.01]
                    ).astype(np.float32))
    v3c = t(np.stack([np.full(3 * c, 1e-3 * r),
                      rng.standard_normal(3 * c) * 0.1]).astype(np.float32))
    v4c = t(np.stack([np.full(4 * c, 3e-5 * r),
                      rng.standard_normal(4 * c) * 0.1]).astype(np.float32))
    x = t(rng.standard_normal((B, T, c)).astype(np.float32))
    return x, w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c


def measure(tree: Path) -> dict:
    """One turn: the numbers of the module docstring for `tree`."""
    sys.path.insert(0, str(tree))
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import entry, kernels
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn as fflash, fused_attn_quant as fattn,
        fused_block_quant as fbq, fused_decode as fdec,
        fused_mlp_quant as fmlp, int8_gemm)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        split_heads)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    assert Path(kernels.__file__).is_relative_to(tree), kernels.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    x, w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c = operands()
    h = layer_norm(x, vc[0], vc[1])
    sc = {}
    fbq.attn_block_quant(x, w_qkv, w_proj, scales, vc[:6], v3c,
                         n_head=HEADS, scratch=sc)
    qkv = sc["qkv"].clone()
    q, k, v = (split_heads(z, HEADS)[:FLASH_B].contiguous()
               for z in qkv.split(C, dim=-1))
    q16, k16, v16 = (z.to(torch.bfloat16) for z in (q, k, v))
    _, tr = entry.build(d_model=C, n_blocks=1, n_heads=HEADS, hidden=64,
                        n_res=1, k=32, d=8, seed=0, device="cuda")
    g = torch.Generator().manual_seed(0)
    xd, kc, vc_ = (torch.randn(*shape, generator=g).cuda()
                   for shape in ((FLASH_B, 1, C), (FLASH_B, T, C),
                                 (FLASH_B, T, C)))
    rows = B * T
    a_fc = sc["h8a"].reshape(rows, C).clone()
    clip = torch.zeros(rows, dtype=torch.int32, device="cuda")
    g8 = fmlp.fc_gelu_q8_reference(a_fc, w_fc, v4c, scales[3]).reshape(
        rows, 4 * C).contiguous()
    x2 = x.reshape(rows, C)

    def attn():
        s = {}
        xm, h8 = fbq.attn_block_quant(x, w_qkv, w_proj, scales, vc[:6], v3c,
                                      n_head=HEADS, scratch=s)
        return [xm, h8, s["h8a"], s["qkv"], s["y8"]]

    def full():
        s = {}
        out = fbq.block_quant(x, w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c,
                              v4c, n_head=HEADS, scratch=s)
        return [out, s["x_mid"], s["h8"], s["g8"]]

    def attn8():
        s = {}
        xm, h8 = fbq.attn_block_quant(x, w_qkv, w_proj, scales, vc[:6], v3c,
                                      n_head=HEADS, int8_attn=True,
                                      scratch=s)
        return [xm, h8, s["h8a"], s["qkv"], s["head_scales"], s["qkv8"],
                s["y8"]]

    def full8():
        s = {}
        out = fbq.block_quant(x, w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c,
                              v4c, n_head=HEADS, int8_attn=True, scratch=s)
        return [out, s["head_scales"], s["qkv8"], s["y8"], s["x_mid"],
                s["h8"], s["g8"]]

    def decode():
        out, k_c, v_c = fdec.fused_block_decode(xd, tr.blocks[0], kc, vc_,
                                                DECODE_POS, n_head=HEADS)
        return [out, k_c[:, DECODE_POS], v_c[:, DECODE_POS]]

    def clipped():
        clip.zero_()
        g = int8_gemm.int8_gemm(a_fc, w_fc, v4c[0], v4c[1], qscale=scales[3],
                                clip_rows=clip)
        return [g, clip]

    cases = {
        "#2 attn_block_quant": attn,
        "#6 block_quant": full,
        "#2 attn_block_quant int8_attn": attn8,
        "#6 block_quant int8_attn": full8,
        "#8 mlp_quant": lambda: [fmlp.mlp_quant(h, w_fc, w_mp, scales[2:],
                                                v4c, vc[6:])],
        "#9 flash_attention_f32": lambda: [fflash.flash_attention_forward(
            q, k, v)],
        "#9 flash_attention_bf16": lambda: [fflash.flash_attention_forward(
            q16, k16, v16)],
        "#13 block_decode_f32": decode,
        "#10 qkv_attention_quant": lambda: [fattn.qkv_attention_quant(
            h, w_qkv, scales[:2], v3c, n_head=HEADS)],
        "#11 causal_attention_quant": lambda: [
            fattn.fused_causal_attention_quant(qkv, scales[1],
                                               n_head=HEADS)],
        "gemm qkv": lambda: [int8_gemm.int8_gemm(a_fc, w_qkv, v3c[0],
                                                 v3c[1])],
        "gemm c_proj": lambda: [int8_gemm.int8_gemm(a_fc, w_proj, vc[4],
                                                    vc[5], resid=x2)],
        "gemm c_fc": lambda: [int8_gemm.int8_gemm(a_fc, w_fc, v4c[0],
                                                  v4c[1], qscale=scales[3])],
        "gemm c_fc clip_rows": clipped,
        "gemm m_proj": lambda: [int8_gemm.int8_gemm(g8, w_mp, vc[6], vc[7],
                                                    resid=x2)],
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(0)
    for b, nh, t, hd in WIDE_SHAPES:
        c = nh * hd
        qkv_w = (torch.randn(b, t, 3 * c, generator=gen) * 2).cuda()
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16,
                                                     "bf16")):
            qw, kw, vw = (split_heads(z, nh) for z in
                          qkv_w.to(dtype).split(c, dim=-1))
            shape = f"({b}, {nh}, {t}, {hd})"
            cases[f"#9 flash_attention_{name} {shape}"] = (
                lambda a=(qw, kw, vw): [fflash.flash_attention_forward(*a)])
            cases[f"#9 {name} plain {shape}"] = (
                lambda a=(qw, kw, vw): [
                    fflash.flash_causal_attention_reference(*a)])
            cases[f"#9 {name} sdpa {shape}"] = (
                lambda a=(qw, kw, vw): [sdpa(*a, is_causal=True)])
    cw, hw = WIDE_BLOCK
    xw, wqw, wpw, _, _, sw, vcw, v3w, _ = operands(cw)

    def attn_wide():
        s = {}
        xm, h8 = fbq.attn_block_quant(xw, wqw, wpw, sw, vcw[:6], v3w,
                                      n_head=hw, scratch=s)
        return [xm, h8, s["h8a"], s["qkv"], s["y8"]]

    cases[f"#2 attn_block_quant C={cw} {hw} heads"] = attn_wide
    out = {"tree": str(tree)}
    plain = {}
    with torch.inference_mode():
        for name, fn in cases.items():
            got = fn()
            torch.cuda.synchronize()
            if " plain " in name:
                plain[name.replace(" plain ", " sdpa ")] = got[0]
            if name in plain:       # SDPA's largest difference from plain
                out[f"{name} max err"] = float(
                    (got[0].float() - plain.pop(name).float()).abs().max())
            digest = hashlib.sha256()
            for t in got:
                digest.update(t.contiguous().cpu().view(torch.uint8)
                              .numpy().tobytes())
            out[f"{name} sha256"] = digest.hexdigest()[:16]
            out[f"{name} ms"] = event_ms(fn)
            out[f"{name} in a row ms"] = row_ms(fn)
            out[f"{name} device ms"], names = device_ms(fn)
            if " sdpa " in name:    # the backend torch chose, by its kernels
                out[f"{name} kernels"] = ", ".join(names)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path,
                    help="the other checkout, timed in turns with this one")
    ap.add_argument("--out", type=Path, help="write the JSON here too")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:           # one turn, in its own process
        print(json.dumps(measure(args.tree.resolve())), flush=True)
        return 0
    if args.other is None:
        ap.error("--other DIR is required")
    other = args.other.resolve()
    turns = []
    for label, tree in (("other", other), ("this", REPO), ("this", REPO),
                        ("other", other)):
        res = subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                             capture_output=True, text=True, cwd=tree)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        turns.append({"turn": label,
                      **json.loads(res.stdout.strip().splitlines()[-1])})
    keys = [k for k in turns[0] if k not in ("tree", "turn")]
    print("metric: " + " / ".join(t["turn"] for t in turns))
    for key in keys:
        print(f"{key}: " + " / ".join(
            f"{t[key]:.4f}" if isinstance(t[key], float) else str(t[key])
            for t in turns))
    same = all(len({t[k] for t in turns}) == 1 for k in keys
               if k.endswith("sha256"))
    print(f"every output bit-equal across the turns: {same}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}")
    record = {"gpu": smi, "bit_equal": same, "turns": turns}
    if args.out is not None:
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
