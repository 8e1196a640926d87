#!/usr/bin/env python3
"""How #9's wide bf16 tile sums its scores, held to the bf16 gate on an
NVIDIA GPU.

    python3 scripts/bench_flash_bf16_wide_sums.py

csrc/attention_bf16.cuh's wide tile (heads past 128) forms each score
over the whole head, 128 columns at a time, on bf16 mma.sync whose f32
accumulator the tensor core truncates at every k16 step. It sums
WIDE_SUM_STEPS k16 steps (8: a 128-column chunk) into a fresh
accumulator and adds that to the running f32 scores with one rounded
add. This builds csrc/flash_attn.cu with the header edited by text into
libraries of their own: as it is (a chunk, rounded adds), a step with
rounded adds, a step with compensated adds (Neumaier's sum, its
compensation added at the stage's end), and one accumulator carried
over the whole head as the narrow tile carries it; and runs each on
bf16 q, k, v of spread 2
(batch 2, T = 70 and batch 4, T = 321) at (C, heads) (4,096, 1), (2,048,
1), (2,048, 8), (1,800, 6) and (1,100, 4), contiguous and as views of a
packed qkv. For each it prints the bf16
gate's two numbers (the share of entries that differ, the entries more
than one bf16 step and 2e-5 apart) against the plain version and
against the float64 attention, and those of the plain version against
float64. Needs a CUDA device and the CUDA toolkit; imports no jax.
"""
from __future__ import annotations

import ctypes
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
PKG = "vq_vae_transformer_arc_welding_tpu_torch"
STEPS = "constexpr int WIDE_SUM_STEPS = 8;"
A_STEP = (STEPS, STEPS.replace("8", "1"))
ADD = "              s[j][i] = __fadd_rn(s[j][i], part[j][i]);"
COMPENSATED = [
    ("    float s[2 * NC][4] = {};",
     "    float s[2 * NC][4] = {}, comp[2 * NC][4] = {};"),
    (ADD, "              {\n"
          "                const float t_ = __fadd_rn(s[j][i], part[j][i]);\n"
          "                comp[j][i] = __fadd_rn(comp[j][i],\n"
          "                    fabsf(s[j][i]) >= fabsf(part[j][i])\n"
          "                        ? __fadd_rn(__fsub_rn(s[j][i], t_), part[j][i])\n"
          "                        : __fadd_rn(__fsub_rn(part[j][i], t_), s[j][i]));\n"
          "                s[j][i] = t_;\n"
          "              }"),
    ("    if (nc > 0)\n      softmax_pv<HD>(s, o, m, l, v_s, nc",
     "    for (int j = 0; j < 2 * NC; ++j)\n"
     "      for (int i = 0; i < 4; ++i)\n"
     "        s[j][i] = __fadd_rn(s[j][i], comp[j][i]);\n"
     "    if (nc > 0)\n      softmax_pv<HD>(s, o, m, l, v_s, nc")]
CARRIED = [("          float part[2 * NC][4] = {};",
            "          float (&part)[2 * NC][4] = s;"),
           (ADD, "              s[j][i] = part[j][i];")]
VARIANTS = {"a chunk, rounded adds": [],
            "a step, rounded adds": [A_STEP],
            "a step, compensated": [A_STEP, *COMPENSATED],
            "carried": CARRIED}
SHAPES = ((4096, 1), (2048, 1), (2048, 8), (1800, 6), (1100, 4))
BATCH_T = ((2, 70), (4, 321))


def gate(out, ref):
    import torch
    ulps = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    err = (out.float() - ref.float()).abs()
    return (f"{float((ulps > 0).float().mean()):.2e} differ, "
            f"{int(((ulps > 1) & (err > 2e-5)).sum())} beyond")


def main() -> int:
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        attention, fused_attn)
    tmp = Path(tempfile.mkdtemp())
    procs = {}
    for name, edits in VARIANTS.items():
        d = tmp / name.replace(" ", "_").replace(",", "")
        d.mkdir()
        for f in ("flash_attn.cu", "attention_bf16.cuh", "attention_tc.cuh",
                  "common.cuh"):
            shutil.copy(REPO / PKG / "csrc" / f, d / f)
        text = (d / "attention_bf16.cuh").read_text()
        for a, b in edits:
            assert a in text, a
            text = text.replace(a, b)
        (d / "attention_bf16.cuh").write_text(text)
        procs[name] = (d, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "flash_attn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(name, out[-3000:], file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(d / "lib.so")).flash_attention_bf16
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6 + [ctypes.c_float,
                                                    ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    def run(fn, q, k, v):
        b, h, t, d = q.shape
        o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
        sb, sh, st, _ = q.stride()
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                 h, t, d, sb, sh, st, t * h * d, d, h * d, 1 / math.sqrt(d),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return o.transpose(1, 2)

    for (c, nh), (b, t), packed in ((s, bt, p) for s in SHAPES
                                     for bt in BATCH_T
                                     for p in (False, True)):
        d = c // nh
        g = torch.Generator().manual_seed(c)
        if packed:
            qkv = (torch.randn(b, t, 3 * c, generator=g) * 2).to(
                "cuda", torch.bfloat16)
            q, k, v = (attention.split_heads(z, nh)
                       for z in qkv.split(c, dim=-1))
        else:
            q, k, v = ((torch.randn(b, nh, t, d, generator=g) * 2).to(
                "cuda", torch.bfloat16) for _ in range(3))
        ref = fused_attn.flash_causal_attention_reference(q, k, v)
        exact = attention.causal_attention_core(
            q.double(), k.double(), v.double()).to(torch.bfloat16)
        print(f"(C, heads) {(c, nh)}, batch {b}, T {t}, "
              f"{'packed' if packed else 'contiguous'}: plain against "
              f"float64 {gate(ref, exact)}")
        for name, fn in fns.items():
            o = run(fn, q, k, v)
            print(f"  {name}: against plain {gate(o, ref)}; against "
                  f"float64 {gate(o, exact)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
