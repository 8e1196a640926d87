#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from vq_vae_transformer_arc_welding_tpu_torch/csrc,
builds the bench model (__graft_entry__._build's configuration) at full
width from a seed, calibrates `WeldingQualityPipeline(precision="int8",
encoder_impl="fused", max_batch=80)` on 8 windows and answers requests
of 80, 37 and 1 windows through `classify` (block_fusion='attn', with
its in-path saturation monitor: per block kernel #2, whose last
LayerNorm+q8 launch counts h8 at +-127, and the int8 MLP as two int8
GEMM calls, c_fc counting the m_proj inputs it clips). A drifted
request (the same pipeline's act scales at half the calibrated absmax)
must give a saturation rate above 0 and within 1e-3 of its plain
path's, with equal labels where the plain probabilities differ by more
than 1e-3. Then it drives
every other int8 path of `entry.make_pipeline_quantized` on the same
requests: block_fusion 'attn' (whose int8 MLP is two int8 GEMM calls a
block, as on 'attn8' and 'attn-bf16'), 'full', 'attn8', 'full8',
'attn-bf16', 'full-bf16', and fused_attention=True with fused_mlp both
ways and fused_qkv=False. Each path's launch counts are set to 0 just
before it and read just after: a path must launch exactly its own
kernels (the attention-half paths the GEMM twice a block), every kernel
must be launched by some path, and each path's labels must equal its
plain path's where the plain margin exceeds 1e-3.

Then the encoder paths on the same requests, each with its counts set
to 0 before it: `encode_indices_fused` at the default group and at
group_size=1, `encode_indices_fused_mono`, and
`encode_indices_fused_edges` at the default group and at group_size=2.
Each must launch exactly its own kernels, as often as its groups say,
and its ids must equal the plain encoder's (flips at most 1e-3). A
`vq_impl='pallas'` model goes through `entry.make_pipeline`,
`WeldingQualityPipeline.classify`, `encode_tokens` and `ood_score`,
which must launch the nearest-code kernel and answer as the 'xla'
model does. A pipeline with `encoder_precision='int8'` calibrates and
answers the requests through none of the encoder kernels.

Then every kernel is held against its plain PyTorch version at the main
paths' shapes (25,600 encoder rows; B=80, T=321, C=512 on the bench
model's activations), and timed with CUDA events in turns with it
(median and quartiles of 10 after warm-up), as are the encoder paths
against each other, classify and the 'attn', 'full', 'attn8' and
'full8' pipelines at batch 80, each against its plain path, and the
edges encoder followed by the 'full' transformer against the 'full'
pipeline. Each kernel's bound, the least time the card could take for
the same work, is computed from the shapes of this run (`kernel_work`):
the f32 attention (#2, #6, #9, #10, #11) counts both of its products in
split TF32 on the tensor cores, and beside that bound the log gives two
more: with the scores on the FP32 cores (as the tile computes them) and
with both products there (as before the tile used the tensor cores).
The f32 encoder kernels (#1, #3, and the ends #4 and #5 on the same
tile) count their resblocks' products in split TF32 too, as the tile
(csrc/encoder_tc.cuh) runs them, and the ends' own products once on the
FP32 cores; the log gives each bound with every product on the FP32
cores beside it. #1, #3 and #4 are held within 1e-4 of the plain
version's largest magnitude, and the id flips of #1 and #5 must be
near-ties.
The int8 GEMM that #2, #6, #8 and #10 share (csrc/int8_gemm_sm90.cuh)
is launched alone at its four shapes in a block (qkv, c_proj, c_fc,
m_proj; 25,680 rows at batch 80) on block 0's own operands, and must be
bit-equal to the plain stage and to what #6 wrote at that stage; the
int8 MLP of the main path (c_fc with the monitor's counts, then m_proj)
is the record's `int8_gemm` entry, timed in turns with its plain
version there. With
int8_attn (#2 and #6 on 'attn8' and 'full8'), the attention's quantizing
pass (csrc/attention_int8.cuh) must write int8 operands and scales
bit-equal to its plain version (`quantize_heads_reference`) on each
block's own qkv, and its y8 is held stage by stage as every int8 stage.
Right after the build, `-Xptxas -v` of every instantiation of the
attention tile (csrc/attention_tc.cuh: heads of 32, 64 padded and
unpadded, and 128, in two files), of #9's bf16 tile
(csrc/attention_bf16.cuh: heads of 16, 32, 64 and 128), of the GEMM's three, of the encoder
tile's kernels (#1, #3, #4, #5 at widths 128, 256 and 512, with the
ends' two device functions), of the int8 attention's and of the decode
kernels' and of LN+q8's (csrc/ln_q8.cuh) gives their
registers and spills (a spill fails the run), and the GEMM's PTX must
hold `wgmma.mma_async` and `cp.async.bulk.tensor` and the int8 attention's s8 `mma.sync`
m16n8k32, flash_attn.cu's the bf16 `mma.sync` m16n8k16 and
`ldmatrix.trans` of its bf16 tile beside the f32 tile's TF32 m16n8k8, the encoder chain's and the encoder's ends'
(csrc/encoder_edges.cu) its TF32 `wgmma` at n256, n128 and n64, the
TMA copy and `cvt.rna.tf32.f32`. The f32 attention kernels
and scaled_dot_product_attention on #9's inputs are timed again ten
calls in a row between two events, so that the host's launch hides
behind the card's work; at the end, torch.profiler traces give their
device time per call (with each kernel's launches, so that a lost event
shows), the f32 attention's, the int8 GEMM's and the encoder chain's
(#1) device time per call of the 'attn' and 'full' pipelines (of
'attn8' and 'full8' with the int8 attention's and its quantizing pass's;
LN+q8's on all four),
#1's, #3's, #4's and #5's device time per launch at 25,600 rows in one
trace (#4 and #5 beside #1 and beside their own split-TF32 bounds), the
GEMM's device
time per launch at each shape beside its bound and beside torch._int_mm
on the same operands (s32 out, no epilogue), c_fc at its act scale
and at the drifted one with and without the monitor's counts, LN+q8's
device time a
launch in #2 with the monitor's counts beside its bound, and #2's and
#6's with int8_attn per call, with the device time a launch of the
quantizing pass and of the int8 attention beside their own bounds.

Then token sampling, at the sampling batch of 16 and 320 KV-cached
steps: `sample_tokens` on the calibrated pipeline (fresh and from a
prompt), `generate_kv` greedy as 'xla', 'fused' (which must launch the
block-decode kernel, one cooperative launch a call, once per block and
token and nothing else), with a
bf16 cache, bf16 weights and `cache_buckets=64`, `quantized_generate_kv`
at batch 16 and 1, the attention-half kernel driven through
`fused_decode_attn` per block, and an `attention_impl='pallas'` model
through `make_pipeline` and `generate`. Free-running ids part for good
after one flip, so each variant is held by forced sequence: along the
'xla' ids its step logits against the plain step's at every position,
and where a free run leaves the 'xla' ids the plain top-2 margin there
must be a near-tie. The three kernels are held against their plain
versions on the model's own activations (every cache row but `pos`
bit-equal to before), every variant's ms per token is timed, and a
device trace counts the operations and the device time of a token. At
the end torch.profiler gives #12's and #13's device time a call over a
token's 8 blocks (cold operands) at pos 160 and 320, beside their
bounds; and every kernel-level trace writes 64 MB between calls, so that
no call reads the operands its predecessor left in L2.

Then the deployment path. The bf16 encoder (kernel #1's `compute_dtype`
variant): `encode_indices_fused(compute_dtype=torch.bfloat16)` on the
three requests must launch the bf16 chain once per encode and nothing
else, `group_size=1` must give the same ids, the ids are held against
the plain bf16 path and against the f32 encoder (flips near-ties), and
`make_pipeline_quantized(encoder_dtype=torch.bfloat16)` against the
f32-encoder pipeline; the kernel is held against its plain version at
25,600 rows per resblock (each fed the plain stream) and over all
eight, with and without BatchNorm, and timed in turns with #1's two f32
launches and end to end. bf16 serving: `precision='bf16'` `classify`
against f32. Deployment: the int8 pipeline gets a scaler fitted on a
synthetic CSV, `save_artifact`, and `load_artifact` without a device or
calibration windows must answer bit-equal, with bit-equal int8 tables;
`from_checkpoints` on the artifact's two files gives the f32 answers;
`cli.score_quality.main` scores the CSV at stride 1 (at least 4,000
windows), its file is checked and must not depend on `--chunk`. The
latent data module encodes whole splits on the card for two tasks:
tokens as `encode_tokens` gives them, `pipeline_depth=2` bit-equal to 1.

Then training (`training_phase`), at the CLIs' default widths on
synthetic data made from the seed: the VQ-VAE (hidden 512, 8 resblocks,
K=256, D=32, dropout 0.1, BN off, vq_impl='pallas', batch 1,024,
make_radam(1e-3, clip_norm=0.7)) over an `ASIMoWDataModule`, then the
transformer (d512, 8 heads, 6 blocks, T=321, attention_impl='pallas',
att_dropout 0, res_dropout 0.1, batch 16, `make_transformer_optimizer`)
over `LatentPredDataModule`s encoded by the trained VQ-VAE, the gen
task, then the class task on the same optimizer. For each model: one
step with the dropouts off on the kernel path and on the plain path
from the same weights and batch (#7 launched once a step, #9 six times
a forward; loss within 1e-5 and global gradient norm within 1e-4
relative; the VQ's ids equal), and #9 at T=320 with gradients against
plain; a whole training step timed in turns with the plain path and
traced by torch.profiler
(busy ms, idle share, the kernels that take most of it); `Trainer.fit`
with the launch counts set to 0 before each fit (every train and eval
forward launches its kernel, nothing else launches), every loss finite
and the last epoch's train loss below the first's, and a run resumed
from its last checkpoint bit-equal to the uninterrupted one (with
torch's defaults: no deterministic-algorithms flag); the class stage
leaves lm_head's RAdam step count where the gen stage left it.

The training phase also trains in bf16 (`bf16_steps`): the VQ-VAE with
compute_dtype=bf16 at compute_scope 'all' and 'decoder' and the
transformer with attention_impl='pallas' (kernel #9 on bf16 q, k, v,
six launches a forward), each one step against its plain bf16 path with
the f32 gates, and against the f32 step from the same weights within
tests/test_mixed_precision.py's envelopes (loss 5e-3, each gradient 15%
or 10% of its magnitude, ids 3%); a training step of each in turns with
f32 and traced (recorded, not claimed). Then #9 on bf16 q, k, v alone
(`flash_bf16_phase`) at the bf16 training shape (16, 8, 321, 64), the
serving bench's batch 80 and heads of 24, 32 and 128: bf16 outputs equal
to the plain version's but on at most 1e-3 of the entries, each one bf16
step or, near 0, within 2e-5; timed in turns with its plain version and
with scaled_dot_product_attention(is_causal=True) on the same bf16 q, k,
v, traced (each trace taken again while it lacks a device event, up to
TRACE_TRIES times: a missing time fails the run), beside its bound (bf16
bytes) and the share of it reached. Then `classification_phase`
at the classification CLI's defaults (hidden 758, 6 hidden layers,
batch 512, 5 cycles): the MLP and the GRU on raw windows with
window_mode='ondevice', the MLP again with its training split streamed
from a memory map (Trainer(streaming=True): the native row gather into
pinned memory, asserted, and the fit bit-equal to the resident one),
the MLP on a frozen VQ-VAE's z_q and MLPEmbedding on its ids through
LatentPredDataModule (vq_impl='pallas', #7's launches counted), each a
short Trainer.fit whose losses are finite and fall; and a few steps of
the EMA VQ-VAE at the reconstruction CLI's widths (kmeans bootstrap on
the first batch, dead codes re-seeded).

Then models off the bench widths (`widths_phase`): the repo's quality
study's VQ-VAE (hidden 64, 2 resblocks, K=32, D=8) and transformer
(d192, 8 heads of 24, 4 blocks) through `classify` (int8, the fused
encoder) and `make_pipeline_quantized` ('attn', 'full', 'attn8',
'full8'), labels against the plain path's outside the 1e-3 margin; the
encoder paths at hidden 64 and at a hidden-256 VQ-VAE's (ids against
the plain encoder, flips at most 1e-3, each a near-tie);
`generate_kv(decode_impl='fused')` on forced sequences, step logits
within 1e-4 of plain; one training step of the d192 transformer with
`attention_impl='pallas'` against plain (#9 once a block). Then every
extended kernel (#1-#6, #9-#13) against its plain version at head
widths 24, 32 and 128 and hidden widths 64, 192 and 256, with its
launches counted, timed in turns with its plain version (events) and
on the device (torch.profiler), beside its bound at those shapes and
the tile it ran on. The record lists the widths each kernel was held
at.

Then every VQ-VAE the VQ-VAE CLI can build (`shapes_phase`): its `main`
at --hidden-dim 1024 --num-embeddings 1024 --embedding-dim 64 (8
resblocks, patch 25) for one epoch on `cli_phase`'s CSV; its checkpoint
with a transformer from the seed (d512, 8 heads, 8 blocks, T=321, K + 2
classes) through `from_checkpoints(precision="int8",
encoder_impl="fused")`: `classify` of 80 windows (the hidden-1024
resblocks on csrc/encoder_wide.cu, one launch a product; JAX's group
rule gives one resblock a call), the edges encoder into the 'attn'
transformer and `make_pipeline_quantized(encoder_dtype=bf16)` (1b off
512, `encoder_wide_bf16`), each launching exactly its kernels, labels
equal to its plain path's outside the 1e-3 margin, the f32 encoders'
ids within 1e-3 of `vq.encode_indices` (each flip a near-tie), the bf16
ones held as at 512; one `vq_impl='pallas'` training step at those
widths against plain (#7 streaming the (1,024, 64) codebook; loss 1e-5,
gradient norm 1e-4). Then every kernel this slice widened against its
plain version: #1, #3, #4 and #5 at hidden 100, 512, 576, 640, 758,
768, 1,024 and 4,096 (the tiles off the multiples of 64, encoder_wide.cu
above 512), #5 (at hidden 512 and 1,024) and #7 at (K, D) of (1024,
64), (4096, 32), (512, 128), (256, 48), (300, 256), (1, 8) and (895,
64), 1b at hidden 64, 256, 576 and 1,024, at 6,400 rows, timed in turns
with plain beside the bound; the encoder_wide.cu kernels again on the
served model's rows, which the record's entries for them report.

Then every transformer the transformer CLI can build
(`transformer_shapes_phase`): the VQ-VAE CLI for one epoch on
`cli_phase`'s CSV, then the transformer CLI's `main` at --d-model 1600
--n-heads 25 (GPT-2 XL's width; 2 blocks, one epoch a stage) on its
latents; the checkpoint served in int8 through `cli/score_quality` at
--stride 4 (#1, #2 and the int8 GEMM; the class head's (1,600 -> 1)
int8 product exact on the card) with labels equal to the plain path's
outside the 1e-3 margin, and its first block on #6, fed the request's
own tokens, held against plain stage by stage. Seed models (one block, hidden-64 VQ-VAE) at
C 200 (8 heads of 25), 2,048 (8 of 256) and 1,800 (6 of 300) through
`classify` and `make_pipeline_quantized` 'attn' and 'full' (1,800 also
fused_attention=True), each launching exactly its kernels, labels
against plain; one `attention_impl='pallas'` training step at heads of
256 against plain (loss 1e-5, gradient norm 1e-4). Then the widened
kernels against their plain versions, timed in turns beside their
bounds: the int8 GEMM at its four shapes of a block (bit-equal) and
LN+q8 launched alone (`ln_q8`, the record's entry) at C 200, 1,000,
1,600, 2,048 and 4,096 on 1,284 rows, and #9 and #11 at head widths 25,
125, 192, 256, 300, 512 and 4,096 (heads past 128 on the f32
attention's wide tile); the record's `transformer_shapes` lists each
kernel's C or head widths there.

Then the int8 attention ('attn8', 'full8'), #9 on bf16 and the decode
kernels (#12, #13) at those widths (`narrow_widths_phase`): the d1600
CLI model of the phase before, kept in memory, through
`make_pipeline_quantized(block_fusion='attn8')` and 'full8' (exactly
their kernels, labels against plain outside the margin), its block 0 on
#2 and #6 with int8_attn held stage by stage (the quantizing pass
bit-equal), and 64 forced steps of `generate_kv(decode_impl='fused')`
(one launch of #13 a block and step, logits within 1e-4 of 'xla'); the
seed models at C 200, 2,048 and 1,800 the same (32 steps); one bf16
`attention_impl='pallas'` training step at heads of 256 and of 25 (#9
bf16 once a block; loss 1e-5, gradient norm 1e-4 against the plain bf16
step); then the int8 attention (#2 and #6 stage by stage), #9 on bf16
(the bf16 gate) and #12, #13 (residual 1e-4, written row 2e-5, at three
positions) alone at (C, heads) (200, 8), (192, 1), (1,100, 4), (1,600,
25), (1,800, 6), (2,048, 8) and (4,096, 1), timed in turns with plain
beside their bounds (#13 through `BlockDecodeStack`, the decode
kernels' device ms their own launches'); the record's
`transformer_shapes` of those kernels lists the (C, heads) they ran at.

Then the decode kernels' general form on its path (`wide_decode_phase`):
an 8-block transformer at d_model 1,800 in 6 heads of 300 (a width the
transformer CLI builds) on the bench VQ-VAE's codebook, weights from
seed 0, sampled by `generate_kv` at batch 16 for 320 steps: 'fused'
must launch #13 exactly 8 x 320 times and nothing else, its forced step
logits within 1e-4 of 'xla''s; ms per token of both in turns, #13's
device ms a launch and its share of a token's device time; #12 through
`fused_decode_attn` on every block for 64 forced steps, logits within
1e-4 (the record's `wide_decode_*` keys).

Last, the training CLIs chained into the scorer (`cli_phase`), in a
temporary working directory on one synthetic CSV (24 runs of 160
cycles): `cli/train_reconstruction_embedding.main` (hidden 512, 8
resblocks, K=256, batch 1,024, one epoch), `cli/train_classification_model.main`
at its defaults (GRU, hidden 758, 6 layers, one epoch) and on the
latents of the VQ-VAE CLI's best checkpoint (MLP), and
`cli/train_transformer_mtasks.main` (d512, 8 heads, 6 blocks, T=321,
batch 16, one gen and one finetune epoch), each with `--device cuda`,
timed on the host's clock, its checkpoints and its metrics.csv checked
(a training row, finite losses). The returned transformer is saved,
and the two checkpoints go through `from_checkpoints(precision="int8",
encoder_impl="fused")`, calibrated on training windows, with the VQ-VAE
CLI's scaler, into an artifact that `cli/score_quality.main` scores at
`--stride 1`: it must launch #1, #2 and the int8 GEMM and nothing else
(the record's `cli_launches`), and the same artifact scored on the
plain path must give equal labels wherever its logit margin exceeds
1e-3, and p_bad + p_good within 1e-4 of 1 in both files. The plain
path's labels outside the margin must hold both classes (CLI_ARGS
trains the VQ-VAE CLI for 60 epochs at batch 64 and the transformer CLI
for 20 class epochs without its early stop, so that they do).

Every failed check raises. The last line of standard output is
{"ok": true, "device": {...}}; the line before it names the card and
its power limit as nvidia-smi reports them, and the one before that
is the kernels' JSON record. Needs one CUDA device; exits non-zero
without one. Imports no jax.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

SEED = 0
N_CYCLES = 20
REQUESTS = (80, 37, 1)
N_CALIB = 8
REPS = 10
# acceptance bounds
MAX_ID_FLIP = 1e-3          # encoder kernels and paths: id flips against plain
MAX_FLIP_GAP = 1e-5         # a flipped id's float64 distance gap, of |z|^2
MAX_OOD_ERR = 1e-5          # OOD scores of the 'pallas' against the 'xla' model
MAX_INT8_DIFF_FRAC = 1e-3   # int8 outputs (h8, g8, y8): share that differs
MAX_INT8_STEP = 1           # int8 outputs: largest |delta|
MAX_F32_ERR = 1e-3          # f32 outputs (x_mid, block and MLP out)
LABEL_MARGIN = 1e-3         # labels compared where |logit0 - logit1| > this
MIN_DISTINCT_FRAC = 0.25    # codebook scaled if fewer of K codes are used
TILE_ROWS = 64              # rows a tile of #1 and #3 (csrc/encoder_tc.cuh)
MAX_CHAIN_REL = 1e-4        # #1, #3 against plain, of the output's magnitude
SAMPLE_BATCH = 16           # streams per generation (scripts/bench_decode.py)
SAMPLE_STEPS = 320          # KV-cached steps from one start token
DECODE_POSITIONS = (0, 127, 128, 320)   # the decode kernels are held here
TIMED_POSITIONS = (160, 320)            # and timed here; the record: the first
MAX_STEP_ERR = 1e-4         # f32 step logits against the plain step's
MAX_BF16_STEP_ERR = 5e-2    # the same with a bf16 cache or bf16 weights
MAX_Q_STEP_ERR = 5e-2       # int8 cached step against the full int8 forward
NEAR_TIE = 1e-3             # a plain top-2 margin below this may flip
MAX_DECODE_ERR = 1e-4       # #12, #13: residual stream against plain
MAX_ROW_ERR = 2e-5          # #12, #13: the written K/V row; #9: its output
# the bf16 encoder chain: a last-bit difference in a gelu output can move
# one product input by 2^-8 of its value, ~2e-4 of the output's scale
MAX_BF16_BLOCK_ERR = 1e-3   # a resblock or the chain, of its largest |output|
MAX_BF16_ID_FLIP = 5e-3     # ids against the plain bf16 path
MAX_BF16_FLIP_GAP = 1e-2    # such a flip's float64 distance gap, of |z|^2
MAX_BF16_F32_FLIP = 0.10    # ids against the f32 encoder (the JAX test's bar)
MAX_BF16_F32_GAP = 0.1      # their gap: bf16 rounding of z, no wrong argmin
BF16_PROB_MARGIN = 1e-2     # bf16 serving: labels held where |p0 - p1| > this
CSV_CYCLES_PER_RUN = 300    # 22 runs: 6,600 cycles, 6,182 windows at stride 1
MIN_SCORED_WINDOWS = 4000

ENC, ATTN, ATTN8 = ("encoder_chain_f32", "attn_block_quant",
                    "attn_block_quant_int8attn")
ENC_BF16 = "encoder_chain_bf16"
RES, ENTRY, EXIT, NEAREST = ("resblock_f32", "encoder_entry_f32",
                             "encoder_exit_f32", "nearest_codes_f32")
FULL, FULL8 = "block_quant", "block_quant_int8attn"
MLP, QKV, CAUSAL = ("mlp_quant", "qkv_attention_quant",
                    "causal_attention_quant")
FLASH, DEC_ATTN, DEC_BLOCK = ("flash_attention_f32", "decode_attn_f32",
                              "block_decode_f32")
# #9 on bf16 q, k and v (the bf16 transformer's training forward)
FLASH_BF16 = "flash_attention_bf16"
# the encoder off the tiles' widths (csrc/encoder_wide.cu): #1 and #3
# above hidden 512, 1b off 512, #4 and #5 above 512
WIDE, WIDE_BF16 = "encoder_wide_f32", "encoder_wide_bf16"
WIDE_ENTRY, WIDE_EXIT = "encoder_wide_entry_f32", "encoder_wide_exit_f32"
# training_phase: the CLIs' default widths (the JAX package's
# cli/train_reconstruction_embedding.py:27-36 and
# cli/train_transformer_mtasks.py:32-36)
TRAIN_VQ = dict(hidden_dim=512, input_dim=2, num_embeddings=256,
                embedding_dim=32, n_resblocks=8, learning_rate=1e-3,
                dropout_p=0.1, patch_size=25, seq_len=200, batch_norm=False)
TRAIN_VQ_BATCH = 1024
TRAIN_VQ_CLIP = 0.7
TRAIN_VQ_EPOCHS = 6         # 4,096 train cycles: 4 steps an epoch, 24 in all
TRAIN_VQ_CSV = dict(n_cycles_per_run=256, extra_train_runs=16)
TRAIN_TR = dict(d_model=512, n_head=8, n_blocks=6, res_dropout=0.1,
                att_dropout=0.0)
TRAIN_TR_BATCH = 16
TRAIN_GEN_EPOCHS = 2        # 300 train windows of 20 cycles: 19 steps an epoch
TRAIN_CLASS_EPOCHS = 1
TRAIN_TR_CSV = dict(n_cycles_per_run=40, extra_train_runs=8)
MAX_TRAIN_LOSS_REL = 1e-5   # one step, kernel path against plain: the loss
MAX_TRAIN_GNORM_REL = 1e-4  # and the global gradient norm
# bf16 training against the f32 step from the same weights and batch:
# tests/test_mixed_precision.py's envelopes (the loss, each gradient
# whose norm exceeds 1e-3 against its largest magnitude, the VQ's ids)
MAX_BF16_LOSS_REL = 5e-3
MAX_BF16_GRAD_REL = {"VQ-VAE": 0.15, "transformer": 0.10}
MIN_BF16_GRAD_NORM = 1e-3
MAX_BF16_TRAIN_FLIP = 0.03
# #9 on bf16 q, k, v against its plain version: the bf16 outputs equal
# but on at most this share of entries, each one bf16 step apart or, near
# 0 where a step is finer, within MAX_ROW_ERR (the f32 tile's bound)
MAX_BF16_DIFF_SHARE = 1e-3
# (batch, heads, head width) at T=321: the bf16 transformer's training
# shape, the serving bench's batch, and heads of 24, 32 and 128 (the
# widths of WIDTH_HEADS)
FLASH_BF16_SHAPES = ((16, 8, 64), (80, 8, 64), (16, 8, 24), (16, 8, 32),
                     (16, 2, 128))
# flash_bf16_phase's device traces: calls a trace, and traces taken while
# one lacks a device event (torch.profiler drops some of a short
# trace's events: once SDPA's all)
TRACE_CALLS, TRACE_TRIES = 20, 5
# classification_phase: the classification CLI's defaults
# (cli/train_classification_model.py:30-38 of the JAX package: hidden
# 758, 6 hidden layers, batch 512, 5 cycles, clip 0.42) on raw windows
# with window_mode='ondevice' (MLP: 1,000 x 2 samples; GRU: 5 steps of
# 400), on the latents of a VQ-VAE at the reconstruction CLI's widths
# (TRAIN_VQ, vq_impl='pallas'), and MLPEmbedding on its ids
CLS = dict(hidden_sizes=758, n_hidden_layers=6, dropout_p=0.032015121309774644,
           learning_rate=1e-3)
CLS_BATCH, CLS_CYCLES, CLS_CLIP, CLS_EPOCHS = 512, 5, 0.42, 4
CLS_CSV = dict(n_cycles_per_run=100, extra_train_runs=16,
               label_process="markov")
# the EMA VQ: a few steps of the VQ-VAE at TRAIN_VQ's widths with
# use_improved_vq, the kmeans bootstrap and dead-code expiry
EMA_VQ = dict(use_improved_vq=True, kmeans_iters=10,
              threshold_ema_dead_code=2)
EMA_STEPS = 6               # steps over the train split's batches in turn
# cli_phase: the three training CLIs through `main` at their default
# widths on one synthetic CSV, their checkpoints served by the int8
# scorer. 8 val, 8 test and 8 train runs of 160 cycles: 1,280 cycles a
# split, so that the VQ-VAE's batch of 1,024 and the classifiers' of 512
# fill a batch in every split (the raw data modules drop the last,
# partial, batch); 22 runs, 3,102 windows of 20 cycles at stride 1
CLI_CSV = dict(n_cycles_per_run=160, extra_train_runs=8)
# each CLI's arguments besides --data-dir and --device (the transformer
# and the latent MLP also get --vqvae-model, the VQ-VAE CLI's best). The
# VQ-VAE and transformer CLIs train long enough that the plain scorer's
# labels outside the margin hold both classes: at the VQ-VAE CLI's batch
# of 1,024 an epoch of the CSV's 1,280 train cycles is one step, and its
# early stop (5 epochs without a better val loss) ends it after 6; the
# transformer CLI's class stage stops after 5 epochs without a better
# val F1 (--no-early-stopping). Probed on the card (PERF.md's Findings):
# one epoch each labels every window alike, as does the VQ-VAE at batch
# 128 for 30 epochs with 10 class epochs; these arguments give both
CLI_ARGS = {
    "reconstruction": ["--epochs", "60", "--batch-size", "64"],
    "classification": ["--epochs", "1"],
    "latent MLP": ["--epochs", "1", "--model-name", "MLP",
                   "--dataset", "latent_vq_vae"],
    "transformer": ["--epoch_iter", "1", "--gen-epochs", "3",
                    "--finetune-epochs", "20", "--no-early-stopping"],
}
# widths_phase: models off the bench widths. The repo's quality study's
# (scripts/quality_study.py:76-86: a VQ-VAE at hidden 64 with 2
# resblocks, K=32, D=8; a transformer at d192 with 8 heads of 24 and 4
# blocks) and a VQ-VAE at hidden 256 (build's other defaults)
WIDTH_MODEL = dict(hidden=64, n_res=2, k=32, d=8, d_model=192, n_heads=8,
                   n_blocks=4)
WIDTH_VQ = dict(hidden=256)
WIDTH_REQUEST = 40          # windows of a request: 6,400 encoder rows
WIDTH_SAMPLE = (8, 320)     # generate_kv: streams and forced steps
WIDTH_TRAIN_BATCH = 8
# each extended kernel is held at these: (C, n_head) for head widths 24,
# 32 and 128, and the encoder's hidden widths
WIDTH_HEADS = ((192, 8), (256, 8), (256, 2))
WIDTH_HIDDEN = (64, 192, 256)
WIDTH_BATCH = 16            # the attention kernels' batch there, T=321
WIDTH_REPS = 5              # timed calls a kernel and plain version there
# the widths the main paths hold each extended kernel at: head 64 for
# the attention kernels, hidden 512 for the f32 encoder's
BENCH_HEAD, BENCH_HIDDEN = 64, 512
# shapes_phase: a VQ-VAE the JAX package serves and the port's first
# kernels refused, as the VQ-VAE CLI builds it from its flags (the JAX
# package's cli/train_reconstruction_embedding.py:29-31): hidden 1,024,
# K = 1,024, D = 64, 8 resblocks, patch 25, one epoch through its main
# on cli_phase's CSV; served in int8 with a transformer from the seed at
# the CLI chain's widths (d512, 8 heads, 8 blocks, T=321, K + 2 classes)
SHAPES_CLI_ARGS = ["--epochs", "1", "--hidden-dim", "1024",
                   "--num-embeddings", "1024", "--embedding-dim", "64"]
SHAPES_TR = dict(d_model=512, n_head=8, n_blocks=8)
SHAPES_REQUEST = 80         # windows of the served request: 25,600 rows
SHAPES_TRAIN_BATCH = 1024   # the CLI's batch, one vq_impl='pallas' step
# then every changed kernel against its plain version and timed: the f32
# encoder kernels at these hidden widths (the tiles off the multiples
# of 64, and encoder_wide.cu above 512), #7 and #5 at these (K, D), 1b
# at these hidden widths; SHAPES_ROWS rows a call (40 windows)
SHAPES_HIDDEN = (100, 512, 576, 640, 758, 768, 1024, 4096)
SHAPES_CODEBOOKS = ((1024, 64), (4096, 32), (512, 128), (256, 48),
                    (300, 256), (1, 8), (895, 64))
SHAPES_BF16 = (64, 256, 576, 1024)
SHAPES_ROWS = 6400
SHAPES_REPS = 5             # timed calls a kernel and plain version
# transformer_shapes_phase: every transformer the transformer CLI can
# build (the JAX package's cli/train_transformer_mtasks.py:34-35 takes any
# --d-model with any --n-heads that divides it). The CLI at GPT-2 XL's
# width (d1600, 25 heads of 64), its depth cut to 2 blocks and each of
# its stages to one epoch, on cli_phase's CSV and a VQ-VAE the VQ-VAE CLI
# trains there for one epoch; its checkpoint scored every TSHAPES_STRIDE
# windows. Seed models (entry.build, one block, the quality study's
# hidden-64 VQ-VAE) at C off 64 and above 1,024 and heads past 128; one
# attention_impl='pallas' step at heads of 256
TSHAPES_VQ_ARGS = ["--epochs", "1"]
TSHAPES_CLI_ARGS = ["--d-model", "1600", "--n-heads", "25", "--n-blocks",
                    "2", "--epoch_iter", "1", "--gen-epochs", "1",
                    "--class-epoch", "1", "--finetune-epochs", "1",
                    "--no-early-stopping"]
TSHAPES_STRIDE = 4
TSHAPES_MODELS = ((200, 8), (2048, 8), (1800, 6))   # (C, heads)
TSHAPES_FUSED = (1800, 6)   # the seed model also run with fused_attention
TSHAPES_TRAIN = (512, 2)    # the training step's (C, heads): heads of 256
# then every widened kernel against its plain version, timed in turns:
# the int8 GEMM at its four shapes of a block and LN+q8 at these C, on
# TSHAPES_ROWS rows (4 windows of T=321); the f32 attention (#9 and #11)
# at these head widths on batch 4, T=321, in max(1, 512 // hd) heads
TSHAPES_C = (200, 1000, 1600, 2048, 4096)
TSHAPES_HEADS = (25, 125, 192, 256, 300, 512, 4096)
TSHAPES_BATCH = 4
TSHAPES_ROWS = TSHAPES_BATCH * 321
# the record's LN+q8 entry: its launch alone (fused_block_quant.ln_q8),
# held and timed at the CLI model's width
LN_ALONE = "ln_q8"
TSHAPES_LN_RECORD = 1600
# narrow_widths_phase: the int8 attention ('attn8', 'full8'), #9 on bf16
# and the decode kernels (#12, #13), which once took only C a multiple of
# 64 (up to 1,024) in heads up to 128, at every width the transformer CLI
# can build. transformer_shapes_phase's d1600 CLI checkpoint through
# 'attn8' and 'full8' (its block 0 stage by stage) and NW_STEPS forced
# steps of generate_kv(decode_impl='fused') against 'xla'; the
# TSHAPES_MODELS seed models likewise (NW_SEED_STEPS steps); one bf16
# attention_impl='pallas' training step at each NW_TRAIN; then each
# kernel alone at NW_SHAPES (C, heads) against plain, timed in turns
# beside its bound: the int8 attention and #9 on bf16 on NW_BATCH
# sequences of T=321, the decode kernels at SAMPLE_BATCH streams, pos 160
NW_STEPS = 64
NW_SEED_STEPS = 32
NW_SAMPLE_BATCH = 8
NW_TRAIN = (TSHAPES_TRAIN, (200, 8))
NW_SHAPES = ((200, 8), (192, 1), (1100, 4), (1600, 25), (1800, 6),
             (2048, 8), (4096, 1))
NW_BATCH = 4
NW_POS = 160
NW_REPS = 3
# wide_heads_phase: the wide attention tiles (heads past 128, clusters of
# kernels.wide_cluster(hd) blocks) on their slice's path, a transformer
# of WIDE_TR (8 heads of 256, the bench model's depth) on the bench
# VQ-VAE from seed 0 (entry.build), served at WIDE_REQUEST windows
# through classify, 'attn', 'full' and fused_attention (#2, #6, #10, #11
# on the f32 wide tile, a launch a block) and trained one step at
# WIDE_TRAIN_BATCH in f32 and in bf16 with attention_impl='pallas' (#9's
# two wide tiles, a launch a block); then each wide tile alone (#9 f32
# and bf16, #11) at WIDE_ALONE (batch, heads, T, head width): the
# TSHAPES_HEADS past 128 at NW_BATCH, and the path's own shape
WIDE_TR = dict(d_model=2048, n_heads=8, n_blocks=8)
WIDE_REQUEST = 80
WIDE_TRAIN_BATCH = 16
WIDE_ALONE = tuple((NW_BATCH, max(1, 512 // hd), 321, hd)
                   for hd in TSHAPES_HEADS if hd > 128) + ((80, 8, 321, 256),)
WIDE_REPS = 3
# wide_decode_phase: the decode kernels' general form on its slice's
# path, an 8-block transformer of WDEC_TR (6 heads of 300, a width the
# transformer CLI builds; T=321) on the bench VQ-VAE's codebook from seed
# 0, sampled by generate_kv at SAMPLE_BATCH streams for SAMPLE_STEPS
# steps: 'fused' (#13 a block and token) against 'xla' by forced
# sequence, ms per token of both in turns (WDEC_REPS), #13's device ms a
# launch and its share of a token's device time; then #12 through
# fused_decode_attn on every block for WDEC_ATTN_STEPS forced steps
WDEC_TR = dict(d_model=1800, n_heads=6, n_blocks=8)
WDEC_ATTN_STEPS = 64
WDEC_REPS = 2
# torch's defaults, which the training phase runs under
TORCH_DEFAULT_TF32 = dict(matmul=False, cudnn=True)
# the int8 GEMM of #2, #6, #8 and #10, launched alone by the GEMM phase;
# its four shapes in a block of width C: (N / C, K / C, int8 GELU+q8
# output, f32 residual read)
GEMM = "int8_gemm"
# the int8 attention's two kernels in #2 and #6 with int8_attn
# (csrc/attention_int8.cuh): the per-head quantizing pass and the
# attention on s8 tensor cores; kernel_work bounds each alone
QUANT_PASS, INT8_ATTENTION = "head_quant_kernel", "attention_int8_kernel"
# #2's LayerNorm+q8 rows (csrc/ln_q8.cuh), launched twice a call, the
# second time with the saturation monitor's count of h8 at +-127
LN_Q8 = "ln_q8_kernel"
MAX_RATE_DIFF = 1e-3        # the monitor's rate against the plain path's
GEMM_SHAPES = {"qkv": (3, 1, False, False), "c_proj": (1, 1, False, True),
               "c_fc": (4, 1, True, False), "m_proj": (1, 4, False, True)}
# name, make_pipeline_quantized options, the kernels the path launches
# (the attention-half paths run their int8 MLP as two int8 GEMM calls a
# block: models/quantized.py::_mlp_int8_gemm)
PATHS = (
    ("attn", {"block_fusion": "attn"}, {ENC, ATTN, GEMM}),
    ("full", {"block_fusion": "full"}, {ENC, FULL}),
    ("attn8", {"block_fusion": "attn8"}, {ENC, ATTN8, GEMM}),
    ("full8", {"block_fusion": "full8"}, {ENC, FULL8}),
    ("attn-bf16", {"block_fusion": "attn-bf16"}, {ENC, ATTN, GEMM}),
    ("full-bf16", {"block_fusion": "full-bf16"}, {ENC, FULL}),
    ("fused_attention", {"block_fusion": None, "fused_attention": True},
     {ENC, QKV}),
    ("fused_attention+fused_mlp", {"block_fusion": None,
                                   "fused_attention": True,
                                   "fused_mlp": True}, {ENC, QKV, MLP}),
    ("fused_attention+fused_qkv=False", {"block_fusion": None,
                                         "fused_attention": True,
                                         "fused_qkv": False}, {ENC, CAUSAL}),
)
TIMED_PATHS = ("attn", "full", "attn8", "full8")
# encoder path: launches per encode at the bench model (8 resblocks,
# default group 4)
ENCODER_PATHS = {
    "encode_indices_fused": {ENC: 2},
    "encode_indices_fused(group_size=1)": {RES: 8},
    "encode_indices_fused_mono": {ENC: 1},
    "encode_indices_fused_edges": {ENTRY: 1, EXIT: 1},
    "encode_indices_fused_edges(group_size=2)": {ENTRY: 1, ENC: 2, EXIT: 1},
}
# the output whose error against the plain version the record reports
OUTPUT = {ATTN: "end.x_mid", ATTN8: "end.x_mid", FULL: "end.out",
          FULL8: "end.out", MLP: "out", QKV: "y8", CAUSAL: "y8"}
SRC = "vq_vae_transformer_arc_welding_tpu_torch/csrc/"
TPU = "vq_vae_transformer_arc_welding_tpu/ops/"
# kernel: (source, the pallas_call it replaces)
RECORD = {
    ENC: ("encoder_chain.cu", "pallas_encoder.py:311"),
    ENC_BF16: ("encoder_chain_bf16.cu", "pallas_encoder.py:311"),
    RES: ("encoder_resblock.cu", "pallas_encoder.py:106"),
    ENTRY: ("encoder_edges.cu", "pallas_encoder.py:404"),
    EXIT: ("encoder_edges.cu", "pallas_encoder.py:436"),
    NEAREST: ("nearest_codes.cu", "pallas_vq.py:59"),
    WIDE: ("encoder_wide.cu", "pallas_encoder.py:311"),
    WIDE_BF16: ("encoder_wide.cu", "pallas_encoder.py:311"),
    WIDE_ENTRY: ("encoder_wide.cu", "pallas_encoder.py:404"),
    WIDE_EXIT: ("encoder_wide.cu", "pallas_encoder.py:436"),
    ATTN: ("attn_block_quant.cu", "pallas_block_quant.py:255"),
    ATTN8: ("attn_block_quant.cu", "pallas_block_quant.py:255"),
    FULL: ("block_quant.cu", "pallas_block_quant.py:307"),
    FULL8: ("block_quant.cu", "pallas_block_quant.py:307"),
    MLP: ("mlp_quant.cu", "pallas_mlp_quant.py:67"),
    QKV: ("attn_quant.cu", "pallas_attn_quant.py:164"),
    CAUSAL: ("attn_quant.cu", "pallas_attn_quant.py:214"),
    FLASH: ("flash_attn.cu", "pallas_attn.py:73"),
    FLASH_BF16: ("flash_attn.cu", "pallas_attn.py:73"),
    DEC_ATTN: ("decode.cu", "pallas_decode.py:149"),
    DEC_BLOCK: ("decode.cu", "pallas_decode.py:371"),
    # the int8 MLP after #2 on the main path, two calls of the GEMM (c_fc
    # with GELU+q8 and the monitor's counts, m_proj with the residual):
    # the function #8 fuses (the JAX 'attn' path runs it on XLA)
    GEMM: ("int8_gemm.cu", "pallas_mlp_quant.py:67"),
    # #2's LayerNorm+q8 rows launched alone (the transformer shapes phase)
    LN_ALONE: ("attn_block_quant.cu", "pallas_block_quant.py:255"),
}

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# FP32 outside the tensor cores, TF32, bf16 and int8 in them, device memory
PEAK_OPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
# an f32-accurate product on the tensor cores: three TF32 products
# (hi*hi + hi*lo + lo*hi, csrc/attention_tc.cuh)
TF32_SPLIT = 3
F32_ATTENTION = (FLASH, ATTN, FULL, QKV, CAUSAL)
# the f32 encoder kernels on the split-TF32 tile (csrc/encoder_tc.cuh)
F32_ENCODER = (ENC, RES, ENTRY, EXIT)
# the same functions above hidden 512 (csrc/encoder_wide.cu), and the
# kernel each of F32_ENCODER's is there
WIDE_OF = {ENC: WIDE, RES: WIDE, ENTRY: WIDE_ENTRY, EXIT: WIDE_EXIT}
# the kernels that take widths off the bench model's (widths_phase)
EXTENDED = (*F32_ENCODER, *F32_ATTENTION, ATTN8, FULL8, DEC_ATTN, DEC_BLOCK)


def kernel_work(n_rows, c, grp, n_res, patch, d, k, b, t, n_head, dec_b,
                dec_pos, fp32_products=0):
    """{kernel: (bytes, {type: operations})} at this run's shapes: the
    bytes each kernel must move (every input read once, every output
    written once) and the operations of its products by operand type (a
    multiply-add is two; LayerNorm, GELU, softmax and the other
    elementwise work are left out, so a bound is a lower one).
    n_rows x c encoder rows, grp resblocks per f32 chain call and all
    n_res per bf16 chain call, a (k, d) codebook; the transformer's
    (b, t, c) stream with n_head heads; a decode step of dec_b streams
    at position dec_pos, which reads the dec_pos cache rows before it
    and writes one. `int8_gemm <shape>`: the int8 GEMM alone at the
    four shapes of a block (GEMM_SHAPES). LN_Q8: one launch of #2's
    LayerNorm+q8 rows alone, the f32 rows and the LayerNorm's scale and
    bias read once, the int8 rows written once (the monitor's count, 4
    bytes a row, left out). GEMM: the int8 MLP after #2 on the main path
    as one function, h8, the weights, their scales and biases and the
    residual read once, the f32 output and the monitor's counts written
    once (the int8 intermediate stays out, as #8's bound leaves it). The int8 attention of #2 and
    #6 alone (INT8_ATTENTION): q8, k8, v8 and the scales read once, y8
    written once, its two products in int8; its quantizing pass alone
    (QUANT_PASS): the f32 qkv read once, the int8 operands and the
    scales written once. The f32 attention
    (F32_ATTENTION) has two products of equal size over its causal
    scores, Q K^T and P@V: each counts TF32_SPLIT times as TF32, but the
    first `fp32_products` of them (0, 1 or 2) once as FP32 on the CUDA
    cores. Its bf16 form (FLASH_BF16) needs less: Q K^T once as bf16,
    P@V twice as TF32. The f32 encoder kernels (F32_ENCODER: #1, #3 and the
    encoder's two ends, #4 and #5, all on one tile; above hidden 512
    WIDE_OF's on encoder_wide.cu, the same functions) count their
    resblocks' products TF32_SPLIT times as TF32, or once as FP32 with
    fp32_products=2; the ends' own products (#4's patch-embed, #5's
    sep_conv and distances) run on the FP32 cores and count once as
    FP32 either way."""
    f4 = 4
    x = n_rows * c * f4                         # the encoder's residual stream
    block_w = 2 * c * c * f4 + 10 * c * f4      # a resblock's operands
    block_ops = n_rows * 2 * (2 * c * c)
    m = b * t
    xs = m * c * f4                             # the transformer's stream
    attn = b * n_head * (t * (t + 1) // 2) * (c // n_head) * 2 * 2
    f32_attn = {kind: n for kind, n in (
        ("f32", fp32_products * (attn // 2)),
        ("tf32", (2 - fp32_products) * TF32_SPLIT * (attn // 2))) if n}

    def f32_enc(ops, ends=0):
        work = ({"f32": ops} if fp32_products == 2
                else {"tf32": TF32_SPLIT * ops})
        if ends:
            work["f32"] = work.get("f32", 0) + ends
        return work
    qkv, proj, mlp = (2 * m * c * 3 * c, 2 * m * c * c, 2 * 2 * m * c * 4 * c)
    w_attn, w_mlp = 4 * c * c, 8 * c * c        # int8 weights
    # a decode step: f32 weights with their biases and LayerNorm rows,
    # the token rows in and out, the K and V rows read and written
    dec_attn_w = (w_attn + 6 * c) * f4
    dec_mlp_w = (w_mlp + 7 * c) * f4
    dec_io = (2 * dec_b * c + 2 * dec_b * (dec_pos + 1) * c) * f4
    dec_attn_ops = dec_b * 2 * (w_attn + 2 * (dec_pos + 1) * c)
    # the GEMM alone: a, w, the column scale and bias, the output (int8
    # or f32) and the residual where it reads one
    gemm = {f"{GEMM} {shape}": (
        m * kc * c + nc * c * kc * c + 2 * nc * c * f4
        + m * nc * c * (1 if q8 else f4) + (m * nc * c * f4 if resid else 0),
        {"int8": 2 * m * nc * c * kc * c})
        for shape, (nc, kc, q8, resid) in GEMM_SHAPES.items()}
    head_scales = b * 3 * n_head * f4
    work = {
        **gemm,
        LN_Q8: (xs + 2 * c * f4 + m * c, {}),
        LN_ALONE: (xs + 2 * c * f4 + m * c, {}),
        GEMM: (m * c + w_mlp + 10 * c * f4 + 2 * xs + m * f4,
               {"int8": mlp}),
        INT8_ATTENTION: (4 * m * c + head_scales, {"int8": attn}),
        QUANT_PASS: (3 * xs + 3 * m * c + head_scales, {}),
        FLASH: (4 * xs, f32_attn),
        # on bf16 q, k, v and output: half the bytes; Q K^T is one bf16
        # product (a product of two bf16 values is exact in f32), P@V two
        # TF32 products (P's hi and lo terms on V, which TF32 holds exactly)
        FLASH_BF16: (4 * m * c * 2,
                     {"bf16": attn // 2, "tf32": 2 * (attn // 2)}),
        DEC_ATTN: (dec_attn_w + dec_io, {"f32": dec_attn_ops}),
        DEC_BLOCK: (dec_attn_w + dec_mlp_w + dec_io,
                    {"f32": dec_attn_ops + dec_b * 2 * w_mlp}),
        ENC: (2 * x + grp * block_w, f32_enc(grp * block_ops)),
        ENC_BF16: (2 * x + n_res * (2 * c * c * 2 + 10 * c * f4),
                   {"bf16": n_res * block_ops}),
        # 1b off hidden 512 (encoder_wide.cu), grp resblocks a call
        WIDE_BF16: (2 * x + grp * (2 * c * c * 2 + 10 * c * f4),
                    {"bf16": grp * block_ops}),
        RES: (2 * x + block_w, f32_enc(block_ops)),
        ENTRY: (n_rows * patch * f4 + (patch + 1) * c * f4 + x
                + grp * block_w,
                f32_enc(grp * block_ops, n_rows * 2 * patch * c)),
        EXIT: (x + grp * block_w + (c + 1) * d * f4 + k * d * f4
               + n_rows * 4,
               f32_enc(grp * block_ops, n_rows * 2 * d * (c + k))),
        NEAREST: (n_rows * d * f4 + k * d * f4 + n_rows * 4,
                  {"f32": n_rows * 2 * d * k}),
        ATTN: (2 * xs + m * c + w_attn, {"int8": qkv + proj, **f32_attn}),
        ATTN8: (2 * xs + m * c + w_attn, {"int8": qkv + proj + attn}),
        FULL: (2 * xs + w_attn + w_mlp,
               {"int8": qkv + proj + mlp, **f32_attn}),
        FULL8: (2 * xs + w_attn + w_mlp, {"int8": qkv + proj + mlp + attn}),
        MLP: (2 * xs + w_mlp, {"int8": mlp}),
        QKV: (xs + m * c + 3 * c * c, {"int8": qkv, **f32_attn}),
        CAUSAL: (3 * xs + m * c, f32_attn),
    }
    # above hidden 512 the same functions run on encoder_wide.cu (#3's
    # one resblock a call is WIDE at grp = 1)
    work.update({WIDE_OF[name]: work[name] for name in (ENC, ENTRY, EXIT)})
    return work


def bound_of(work) -> tuple[float, str]:
    """(the least time in ms, what sets it): the larger of bytes over the
    memory rate and operations over the peak rate of their type."""
    n_bytes, ops = work
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def gpu_name_and_power() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def timed_in_turns(fns: dict, reps: int = REPS, warmup: int = 3,
                   per: int = 1) -> dict:
    """Time of each fn() in ms, CUDA events around each call, after
    warm-up. The functions take turns and the order flips every
    repetition (a b, b a, ...), so that a drift of clocks or load falls
    on all of them alike. `per`: the units of work in one fn() (tokens
    of a generation, kernel calls of a loop); times are per unit.
    Returns {name: (median, first quartile, third quartile)}."""
    import torch
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    times = {name: [] for name in fns}
    order = list(fns)
    for i in range(reps):
        for name in order if i % 2 == 0 else order[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / per)
    out = {}
    for name, ts in times.items():
        q1, _, q3 = statistics.quantiles(ts, n=4)
        out[name] = (statistics.median(ts), q1, q3)
    return out


def device_profile(fn, leave_out: str | None = None):
    """What one fn() puts on the card, from torch.profiler's device
    trace: (operations, their summed device time in ms, every name as
    [(name, count, ms)], most time first). (0, None, []) where the trace
    holds no device event. fn() runs three times in the session and only
    the last is kept: a trace loses some of the first events it should
    record (up to half of ten short calls on an H100), and the two
    warm-up runs take that loss. Kernels whose name holds `leave_out`
    are left out of all three."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=1,
                                   repeat=1)) as prof:
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # the step's own range may be drawn on the device's timeline too
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")
           and not (leave_out and leave_out in e.key)]
    n = sum(e.count for e in dev)
    if not n:
        return 0, None, []
    dev.sort(key=lambda e: -e.self_device_time_total)
    return (n, sum(e.self_device_time_total for e in dev) / 1e3,
            [(e.key.replace("(anonymous namespace)::", "").replace(
                "void ", ""), e.count, e.self_device_time_total / 1e3)
             for e in dev])


# the sources that instantiate csrc/attention_tc.cuh (and #9's bf16
# tile, csrc/attention_bf16.cuh), the int8 GEMM
# (csrc/int8_gemm_sm90.cuh), the encoder tile (csrc/encoder_tc.cuh: #1,
# #3, and #4 and #5 with their ends' two device functions) and the
# decode kernels (#12, #13), and the functions ptxas reports on
PTXAS_SOURCES = ("flash_attn.cu", "int8_block.cu", "encoder_chain.cu",
                 "encoder_resblock.cu", "encoder_edges.cu", "decode.cu",
                 "encoder_chain_bf16.cu", "nearest_codes.cu",
                 "encoder_wide.cu")
PTXAS_KERNELS = ("attention_kernel", "flash_attention_bf16_kernel",
                 "int8_gemm_sm90_kernel",
                 "encoder_chain_kernel", "resblock_kernel",
                 "encoder_entry_kernel", "encoder_exit_kernel", "embed_rows",
                 "nearest_rows", QUANT_PASS, INT8_ATTENTION, "decode_kernel",
                 "decode_general",
                 LN_Q8, "encoder_chain_bf16_kernel", "nearest_codes_kernel",
                 "nearest_codes_chunked", "product_kernel", "embed_kernel",
                 "exit_kernel", "attention_wide_kernel", "ln_q8_any_kernel",
                 "q8_rows_kernel", "head_quant_wide_kernel",
                 "attention_int8_wide_kernel",
                 "flash_attention_bf16_wide_kernel",
                 "flash_attention_bf16_chunks_kernel")
# the sources whose kernels must use no stack either (1b and #7)
NO_STACK = ("encoder_chain_bf16.cu", "nearest_codes.cu")
# kernels whose setmaxnreg requests assume ptxas gave them 65536 / 384
# registers a thread (fewer would leave the requests unmet: a hang): 1b
# and every instantiation of the f32 tile (matched within ptxas's
# mangled names)
SETMAXNREG_REGS = {"encoder_chain_bf16_kernel": 168,
                   "encoder_chain_kernel": 168, "resblock_kernel": 168,
                   "encoder_entry_kernel": 168, "encoder_exit_kernel": 168}
# what each source's PTX must hold: Hopper's tensor-core product (in
# TF32, with A split by cvt.rna, for the f32 encoder; bf16 for 1b), TMA
# copies, the int8 attention's s8 products, #9's bf16 tile's bf16
# mma.sync fed by ldmatrix beside the f32 tile's split TF32, the wide
# tiles' cluster barriers and distributed shared memory (mapa), the
# decode kernels' split-TF32 mma.sync fed by 1-D bulk copies and their
# grid barrier's arrival
PTX_OPS = {
    "encoder_chain_bf16.cu": (
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
        "cp.async.bulk.tensor"),
    "flash_attn.cu": ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                      "barrier.cluster.arrive", "mapa"),
    "int8_block.cu": ("wgmma.mma_async", "cp.async.bulk.tensor",
                      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32",
                      "barrier.cluster.arrive", "mapa"),
    "encoder_chain.cu": ("wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32",
                         "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32",
                         "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32",
                         "cp.async.bulk.tensor", "cvt.rna.tf32.f32"),
    "encoder_edges.cu": ("wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32",
                         "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32",
                         "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32",
                         "cp.async.bulk.tensor", "cvt.rna.tf32.f32"),
    # the encoder off the tiles' widths: split TF32 and bf16 mma.sync,
    # fed by ldmatrix
    "encoder_wide.cu": ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                        "cvt.rna.tf32.f32",
                        "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
                        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16"),
    # #7's streamed codebook
    "nearest_codes.cu": ("cp.async.cg.shared.global",),
    "decode.cu": ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                  "cp.async.bulk.shared::cluster.global.mbarrier",
                  "atom.acq_rel.gpu.inc.u32"),
}


def ptxas_start() -> list:
    """nvcc -Xptxas -v on PTXAS_SOURCES, and nvcc -ptx on the sources of
    PTX_OPS, started beside the library's build: [(source, process)]."""
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    out = kernels.BUILD_DIR / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    cmds = [(src, [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                   "-c", "-o", str(out / f"{src}.o"),
                   str(kernels.SRC_DIR / src)]) for src in PTXAS_SOURCES]
    cmds += [(f"{src}.ptx", [
        kernels.nvcc(), *kernels.NVCC_FLAGS, "-ptx", "-o",
        str(out / f"{src}.ptx"), str(kernels.SRC_DIR / src)])
        for src in PTX_OPS]
    return [(src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for src, cmd in cmds]


def ptxas_report(procs: list) -> None:
    """Log what ptxas says of the attention tiles, the int8 GEMM and the
    encoder tile (registers, stack and spills, and any warning of
    serialized wgmma), fail on a spill, and count the tensor-core and
    TMA instructions in the PTX of PTX_OPS."""
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    for src, proc in procs:
        text, _ = proc.communicate()
        if src.endswith(".ptx"):
            name = src[:-len(".ptx")]
            check(proc.returncode == 0, f"nvcc -ptx {name}: {text[-2000:]}")
            body = (kernels.BUILD_DIR / "ptxas" / src).read_text()
            found = {op: body.count(op) for op in PTX_OPS[name]}
            check(all(found.values()), f"{name}'s PTX lacks one of "
                                       f"{PTX_OPS[name]}: {found}")
            log(f"{name} PTX: " + ", ".join(
                f"{op} x {n}" for op, n in found.items()))
            continue
        check(proc.returncode == 0, f"nvcc -Xptxas -v {src}: {text[-2000:]}")
        kernel, said = None, {}
        for line in text.splitlines():
            if "wgmma" in line and "arning" in line:
                log(f"ptxas {src}: {line.strip()}")
            if ("Compiling entry function" in line
                    or "Function properties for" in line):
                # a kernel's name in quotes, a device function's after
                # "for"
                fn = (line.split("'")[1] if "'" in line
                      else line.rsplit(" ", 1)[-1])
                kernel = next((fn for name in PTXAS_KERNELS if name in fn),
                              None)
            elif kernel and ("spill" in line or "Used" in line):
                said.setdefault(kernel, []).append(
                    line.replace("ptxas info    :", "").strip())
        check(bool(said), f"nvcc -Xptxas -v {src}: none of {PTXAS_KERNELS}")
        for kernel, lines in said.items():
            log(f"ptxas {src} {kernel}: " + "; ".join(lines))
            spills = [int(n) for line in lines
                      for n in re.findall(r"(\d+) bytes spill", line)]
            check(not any(spills), f"ptxas {src} {kernel} spills")
            want = next((n for name, n in SETMAXNREG_REGS.items()
                         if name in kernel), None)
            if want is not None:
                regs = [int(n) for line in lines
                        for n in re.findall(r"Used (\d+) registers", line)]
                check(bool(regs) and all(n == want for n in regs),
                      f"ptxas {src} {kernel}: {regs} registers, not "
                      f"{want}: setmaxnreg would hang")
            if src in NO_STACK:
                stack = [int(n) for line in lines for n in re.findall(
                    r"(\d+) bytes (?:stack frame|cumulative stack)", line)]
                check(not any(stack), f"ptxas {src} {kernel} uses a stack")


def fmt_ms(t: tuple) -> str:
    return f"{t[0]:.4f} ms (quartiles {t[1]:.4f}-{t[2]:.4f})"


def on_plain_path(fn):
    """fn run with every kernel wrapper replaced by its plain version."""
    def run():
        with plain_path():
            return fn()
    return run


def without_split(plain):
    """plain, taking and ignoring the f32 encoder wrappers' `split`
    operand (the split-TF32 weights only their kernels read)."""
    return lambda *a, split=None, **k: plain(*a, **k)


@contextlib.contextmanager
def plain_path():
    """The same serving paths with every kernel wrapper replaced by its
    plain PyTorch version (the CUDA wrappers would launch the kernels)."""
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn as fflash, fused_attn_quant as fattn,
        fused_block_quant as fbq, fused_decode as fdec,
        fused_encoder as fenc, fused_mlp_quant as fmlp, fused_vq as fvq,
        int8_gemm as igemm)
    with contextlib.ExitStack() as stack:
        for mod, name, plain in (
                (fflash, "flash_causal_attention",
                 fflash.flash_causal_attention_reference),
                (fdec, "fused_decode_attn", fdec.fused_decode_attn_reference),
                (fdec, "fused_block_decode",
                 fdec.fused_block_decode_reference),
                (fdec, "BlockDecodeStack",
                 fdec.block_decode_stack_reference),
                (igemm, "int8_gemm", igemm.int8_gemm_reference),
                (fenc, "fused_encoder_eval",
                 without_split(fenc.fused_encoder_eval_reference)),
                (fenc, "resblock_eval",
                 without_split(fenc.fused_resblock_eval_reference)),
                (fenc, "fused_encoder_entry_eval",
                 without_split(fenc.fused_encoder_entry_eval_reference)),
                (fenc, "fused_encoder_exit_eval",
                 without_split(fenc.fused_encoder_exit_eval_reference)),
                (fvq, "nearest_codes_pallas",
                 fvq.nearest_codes_pallas_reference),
                (fbq, "attn_block_quant",
                 fbq.fused_attn_block_quant_reference),
                (fbq, "block_quant", fbq.fused_block_quant_reference),
                (fmlp, "mlp_quant", fmlp.mlp_quant_reference),
                (fattn, "qkv_attention_quant",
                 fattn.qkv_attention_quant_reference),
                (fattn, "fused_causal_attention_quant",
                 fattn.causal_attention_quant_reference)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        yield


def counted(fn):
    """(fn(), the kernels it launched): the launch counts are set to 0
    just before the call and read just after it."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: n for name, n in kernels.launches.items() if n}


def flip_rate(ids, ref) -> float:
    """Share of ids (two tensors or two arrays of one shape) that differ."""
    diff = ids != ref
    return float(diff.mean() if isinstance(diff, np.ndarray)
                 else diff.float().mean())


def worst_flip_gap(z, codebook, ids, ref) -> float:
    """Over the rows where ids and ref differ: the largest gap between the
    two chosen codes' squared distances to z, computed in float64,
    relative to |z|^2. A flip at a near-tie has a gap of f32 rounding
    size (~1e-7); a wrong argmin has one of order 1."""
    rows = (ids != ref).nonzero().squeeze(1)
    if rows.numel() == 0:
        return 0.0
    zz = z[rows].double()
    d_ids, d_ref = (((zz - codebook[i[rows].long()].double()) ** 2).sum(1)
                    for i in (ids, ref))
    return float(((d_ids - d_ref).abs() / (zz ** 2).sum(1)).max())


def int8_diff(a, b) -> tuple[float, int]:
    """(share of entries that differ, largest |difference|)."""
    d = (a.int() - b.int()).abs()
    return float(d.ne(0).float().mean()), int(d.max())


class Worst:
    """The worst differences seen per (kernel, tensor), checked against
    the bounds; `bound=False` records a difference without a bound."""

    def __init__(self):
        self.frac, self.step, self.err, self.free = {}, {}, {}, {}

    def int8(self, key, a, b) -> str:
        frac, step = int8_diff(a, b)
        self.frac[key] = max(self.frac.get(key, 0.0), frac)
        self.step[key] = max(self.step.get(key, 0), step)
        return f"{key.split('.')[-1]} differs in {frac:.3e}, step {step}"

    def f32(self, key, a, b, bound=True) -> str:
        err = float((a - b).abs().max())
        table = self.err if bound else self.free
        table[key] = max(table.get(key, 0.0), err)
        return f"{key.split('.')[-1]} err {err:.3e}"

    def check(self) -> None:
        for key, frac in self.frac.items():
            check(frac <= MAX_INT8_DIFF_FRAC,
                  f"{key}: int8 output differs in {frac} of entries")
            check(self.step[key] <= MAX_INT8_STEP,
                  f"{key}: int8 step {self.step[key]}")
        for key, err in self.err.items():
            check(err <= MAX_F32_ERR, f"{key}: f32 error {err}")

    def output_err(self, name, out) -> float:
        """The kernel's error at its output `out` against the plain
        version on the same input: f32, or the largest int8 step."""
        key = f"{name}.{out}"
        for table in (self.err, self.free):
            if key in table:
                return table[key]
        return float(self.step[key])


def block_stages(worst: Worst, name: str, x, sc: dict, w: dict, scales, vc,
                 v3c, v4c, n_head: int, int8_attn: bool) -> str:
    """#2's or #6's intermediates (sc, its scratch, with "out" for #6),
    each held in `worst` against the plain step fed the kernel's own
    input to that step, so that a one-step flip upstream does not count
    downstream. w: the block's int8 weights by Linear name."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn_quant as fattn, fused_block_quant as fbq,
        fused_mlp_quant as fmlp)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.int8 import (
        int8_matmul, quantize_act)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    notes = [
        worst.int8(f"{name}.h8a", sc["h8a"], quantize_act(
            layer_norm(x, vc[0], vc[1]), scales[0])),
        worst.f32(f"{name}.qkv", sc["qkv"], int8_matmul(
            sc["h8a"], w["c_attn"]).float() * v3c[0] + v3c[1]),
        worst.int8(f"{name}.y8", sc["y8"], quantize_act(
            fattn.attention_core_reference(
                sc["qkv"], n_head, int8_attn=int8_attn), scales[1]))]
    if int8_attn:
        qkv8, head_scales = fbq.quantize_heads_reference(sc["qkv"], n_head)
        same = (torch.equal(sc["qkv8"], qkv8),
                torch.equal(sc["head_scales"], head_scales))
        check(all(same), f"{name}: the quantizing pass's qkv8 and "
                         f"scales bit-equal to plain: {same}")
        notes.append("qkv8 and head_scales bit-equal")
    x_mid = sc["x_mid"]
    notes += [
        worst.f32(f"{name}.x_mid", x_mid, x + (int8_matmul(
            sc["y8"], w["c_proj"]).float() * vc[4] + vc[5])),
        worst.int8(f"{name}.h8", sc["h8"], quantize_act(
            layer_norm(x_mid, vc[2], vc[3]), scales[2]))]
    if "g8" in sc:
        notes += [
            worst.int8(f"{name}.g8", sc["g8"], fmlp.fc_gelu_q8_reference(
                sc["h8"], w["c_fc"], v4c, scales[3])),
            worst.f32(f"{name}.out", sc["out"], x_mid + (
                int8_matmul(sc["g8"], w["m_proj"]).float() * vc[6]
                + vc[7]))]
    return ", ".join(notes)


def first_departures(ids, ref):
    """Per row, the first index where ids leaves ref, or -1."""
    diff = ids != ref
    first = diff.int().argmax(dim=1)
    return [int(f) if bool(d.any()) else -1 for f, d in zip(first, diff)]


def sampling_phase(vq, tr, pipe, req, smi: str) -> dict:
    """Token sampling at full width (see the module docstring). Returns
    what the kernels' record needs of #9, #12 and #13: `launched`
    {kernel: (path, launches)}, `err`, `times`, `library_ms` and
    `flash_qkv`, #9's q, k, v at the request's batch."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline)
    from vq_vae_transformer_arc_welding_tpu_torch.models.quantized import (
        quantized_generate_kv, quantized_lm_logits)
    from vq_vae_transformer_arc_welding_tpu_torch.models.transformer import (
        linear)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn as fflash, fused_decode as fdec)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import (
        new_gelu)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        merge_heads, split_heads)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm

    dev = tr.pe.device
    qp = pipe.qparams
    nb, nh, c, t = tr.n_blocks, tr.n_head, tr.d_model, tr.seq_len
    bs, steps = SAMPLE_BATCH, SAMPLE_STEPS
    launched, err, times = {}, {}, {}

    def valid_ids(ids, shape, what):
        check(tuple(ids.shape) == shape, f"{what}: ids {tuple(ids.shape)}")
        check(0 <= int(ids.min()) and int(ids.max()) < tr.n_classes,
              f"{what}: ids out of range")

    # -- S1. sample_tokens on the calibrated pipeline: no decode kernel ----
    prompt = pipe.encode_tokens(req[:bs])[:, :32]
    (fresh, cont), counts = counted(lambda: (
        pipe.sample_tokens(bs, top_k=5, seed=SEED, num_steps=steps),
        pipe.sample_tokens(prompt=prompt, top_k=5, seed=SEED, num_steps=64)))
    check(counts == {}, f"sample_tokens launched {json.dumps(counts)}")
    valid_ids(fresh, (bs, steps), "sample_tokens(n)")
    valid_ids(cont, (bs, 32 + 64), "sample_tokens(prompt)")
    check(bool((cont[:, :32] == prompt).all()),
          "sample_tokens(prompt): the prompt is not kept")
    check(bool((fresh == pipe.sample_tokens(bs, top_k=5, seed=SEED,
                                            num_steps=steps)).all()),
          "sample_tokens: the same seed gave other ids")
    log(f"sample_tokens: {bs} fresh sequences of {steps} ids, "
        f"{np.unique(fresh).size} distinct; a 32-id prompt continued by 64; "
        f"no kernel launched")

    # -- S2. generate_kv greedy, every variant, free and forced --------------
    start = torch.full((bs, 1), pipe.start_token, dtype=torch.int32,
                       device=dev)
    variants = {
        "xla": {},
        "fused": {"decode_impl": "fused"},
        "bf16 cache": {"cache_dtype": torch.bfloat16},
        "bf16 weights": {"param_dtype": torch.bfloat16},
        "cache_buckets=64": {"cache_buckets": 64},
    }
    bound_of_variant = {"bf16 cache": MAX_BF16_STEP_ERR,
                        "bf16 weights": MAX_BF16_STEP_ERR}
    free = {}
    for name, kw in variants.items():
        free[name], counts = counted(
            lambda: tr.generate_kv(start, num_steps=steps, **kw))
        valid_ids(free[name], (bs, 1 + steps), f"generate_kv {name}")
        want = {DEC_BLOCK: nb * steps} if name == "fused" else {}
        check(counts == want, f"generate_kv {name} launched "
                              f"{json.dumps(counts)}, expected {want}")
        if name == "fused":
            launched[DEC_BLOCK] = ("generate_kv(decode_impl='fused')",
                                   counts[DEC_BLOCK])
    ids = free["xla"]

    def forced(run, model=tr):
        """The step logits (steps, B, n_classes) of `run` when every draw
        is replaced by the next id of `ids`: the sampler's own loop, its
        `_sample_from_logits` handed the forced ids."""
        seen = []

        def draw(last, *_args, **_kw):
            seen.append(last.float().clone())
            return ids[:, len(seen)]

        with mock.patch.object(model, "_sample_from_logits", draw):
            run()
        check(len(seen) == steps, f"forced run drew {len(seen)} times")
        return torch.stack(seen)

    plain = forced(lambda: tr.generate_kv(start, num_steps=steps))
    top2 = plain.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]               # (steps, B)
    check(bool((plain.argmax(-1).t() == ids[:, 1:])[margin.t() > 1e-6].all()),
          "the 'xla' ids are not the argmax of their own step logits")
    for name, kw in variants.items():
        if name == "xla":
            continue
        bound = bound_of_variant.get(name, MAX_STEP_ERR)
        tie = max(NEAR_TIE, 2 * bound)
        got = forced(lambda: tr.generate_kv(start, num_steps=steps, **kw))
        worst = float((got - plain).abs().max())
        check(worst <= bound, f"generate_kv {name}: forced step logits "
                              f"differ from the plain step's by {worst}")
        same = got.argmax(-1) == plain.argmax(-1)
        check(bool(same[margin > tie].all()),
              f"generate_kv {name}: argmax differs where the plain top-2 "
              f"margin exceeds {tie}")
        firsts = first_departures(free[name], ids)
        for row, j in enumerate(firsts):
            if j < 0:
                continue
            m = float(margin[j - 1, row])      # the logits that drew id j
            check(m <= tie, f"generate_kv {name}: row {row} leaves the "
                            f"'xla' ids at {j}, where the plain top-2 "
                            f"margin is {m}, no near-tie")
        gone = [j for j in firsts if j >= 0]
        log(f"generate_kv {name}: batch {bs}, {steps} steps; forced step "
            f"logits within {worst:.3e} of the plain step's (bound {bound}); "
            f"argmax differs at {int((~same).sum())} of {same.numel()} "
            f"draws, none with a plain margin above {tie}; the free run "
            f"leaves the 'xla' ids in {len(gone)} of {bs} rows"
            + (f", first at step {min(gone)}" if gone else "")
            + f"; {int((margin <= NEAR_TIE).sum())} of {margin.numel()} "
              f"plain margins are below {NEAR_TIE}")
        if name == "fused":
            err["generate_kv fused"] = worst

    # -- S3. kernel #12 driven through its own function -------------------
    hd = c // nh

    def caches_bhtd(b):
        return [(torch.zeros(b, nh, t, hd, device=dev),
                 torch.zeros(b, nh, t, hd, device=dev)) for _ in range(nb)]

    def step_attn_half(tok, pos, caches):
        """A token step with fused_decode_attn per block and the plain
        MLP after it."""
        x = tr._embed_token(tok, pos)
        for blk, (k_c, v_c) in zip(tr.blocks, caches):
            x, _, _ = fdec.fused_decode_attn(x, blk, k_c, v_c, pos,
                                             n_head=nh)
            h = layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
            x = x + linear(new_gelu(linear(h, blk.mlp.c_fc)), blk.mlp.c_proj)
        ln_f = tr.transformer.ln_f
        return layer_norm(x, ln_f.weight, ln_f.bias)[:, 0] \
            @ tr.lm_head.weight.t()

    n12 = min(64, steps - 1)
    with torch.inference_mode():
        caches = caches_bhtd(bs)
        tr._prefill(ids[:, :1], caches)
        got12, counts = counted(lambda: torch.stack(
            [step_attn_half(ids[:, p], p, caches)
             for p in range(1, 1 + n12)]))
    check(counts == {DEC_ATTN: nb * n12},
          f"fused_decode_attn steps launched {json.dumps(counts)}")
    launched[DEC_ATTN] = (f"fused_decode_attn per block, {n12} token steps",
                          counts[DEC_ATTN])
    worst = float((got12 - plain[1:1 + n12]).abs().max())
    check(worst <= MAX_STEP_ERR, f"fused_decode_attn steps: logits differ "
                                 f"from the plain step's by {worst}")
    log(f"fused_decode_attn per block over {n12} forced steps: launches "
        f"{json.dumps(counts)}; step logits within {worst:.3e} of the plain "
        f"step's (bound {MAX_STEP_ERR})")

    # -- S4. #12 and #13 against plain on the model's activations ----------
    # caches filled by a prefill over the 'xla' ids; each block fed the
    # plain output of the block before; row `pos` zeroed before the call
    with torch.inference_mode():
        full = caches_bhtd(bs)
        tr._prefill(ids[:, :t], full)
        flat = [tuple(merge_heads(z).contiguous() for z in kv) for kv in full]
        err[DEC_ATTN] = err[DEC_BLOCK] = 0.0
        row_err = {DEC_ATTN: 0.0, DEC_BLOCK: 0.0}
        for pos in DECODE_POSITIONS:
            x = tr._embed_token(ids[:, pos], pos)
            for i, blk in enumerate(tr.blocks):
                for name, kfn, pfn, src, row in (
                        (DEC_ATTN, fdec.fused_decode_attn,
                         fdec.fused_decode_attn_reference, full[i],
                         lambda z: z[:, :, pos]),
                        (DEC_BLOCK, fdec.fused_block_decode,
                         fdec.fused_block_decode_reference, flat[i],
                         lambda z: z[:, pos])):
                    before = [z.clone() for z in src]
                    for z in before:
                        row(z).zero_()
                    kk, kv = (z.clone() for z in before)
                    pk, pv = (z.clone() for z in before)
                    out_k, _, _ = kfn(x, blk, kk, kv, pos, n_head=nh)
                    out_p, _, _ = pfn(x, blk, pk, pv, pos, n_head=nh)
                    e = float((out_k - out_p).abs().max())
                    check(bool(torch.isfinite(out_k).all())
                          and e <= MAX_DECODE_ERR,
                          f"kernel {name} block {i} pos {pos}: output "
                          f"differs from plain by {e}")
                    err[name] = max(err[name], e)
                    for got, ref, was in ((kk, pk, before[0]),
                                          (kv, pv, before[1])):
                        e = float((row(got) - row(ref)).abs().max())
                        check(e <= MAX_ROW_ERR,
                              f"kernel {name} block {i} pos {pos}: the "
                              f"written row differs from plain by {e}")
                        row_err[name] = max(row_err[name], e)
                        row(got).zero_()
                        check(torch.equal(got, was),
                              f"kernel {name} block {i} pos {pos}: a cache "
                              f"row other than {pos} changed")
                    if name == DEC_BLOCK:
                        nxt = out_p
                x = nxt
        for name in (DEC_ATTN, DEC_BLOCK):
            log(f"kernel {name}: {nb} blocks at pos {DECODE_POSITIONS}, batch "
                f"{bs}: output within {err[name]:.3e} of plain (bound "
                f"{MAX_DECODE_ERR}), the written K/V row within "
                f"{row_err[name]:.3e} (bound {MAX_ROW_ERR}), every other "
                f"cache row bit-equal to before")

        # times: one token's calls over the 8 blocks, each with its own
        # caches, so that weights and caches come from device memory as in
        # a generation (270 MB a token against 50 MB of L2)
        x = tr._embed_token(ids[:, 1], 1)
        for pos in TIMED_POSITIONS:
            for name, kfn, pfn, store in (
                    (DEC_ATTN, fdec.fused_decode_attn,
                     fdec.fused_decode_attn_reference, full),
                    (DEC_BLOCK, fdec.fused_block_decode,
                     fdec.fused_block_decode_reference, flat)):
                def token(fn, store=store, pos=pos):
                    for blk, (k_c, v_c) in zip(tr.blocks, store):
                        fn(x, blk, k_c, v_c, pos, n_head=nh)
                tm = timed_in_turns({"kernel": lambda: token(kfn),
                                     "plain": lambda: token(pfn)}, per=nb)
                if pos == TIMED_POSITIONS[0]:
                    times[name] = tm
                log(f"kernel {name} time (batch {bs}, pos {pos}, mean of one "
                    f"token's {nb} calls): {fmt_ms(tm['kernel'])}, plain "
                    f"{fmt_ms(tm['plain'])}")
        decode_operands = (x, full, flat)

    # -- S5. kernel #9: against the plain core, then through the entries ----
    library_ms = {}
    with torch.inference_mode():
        ids80 = torch.cat([torch.full((len(req), 1), pipe.start_token,
                                      device=dev, dtype=torch.int32),
                           torch.from_numpy(pipe.encode_tokens(req)).to(dev)],
                          dim=1)
        blk = tr.blocks[0]
        err[FLASH] = 0.0
        for b in (len(req), bs):
            h = layer_norm(tr.embed(ids80[:b]), blk.ln_1.weight,
                           blk.ln_1.bias)
            qkv = linear(h, blk.attn.c_attn) * 8.0   # scores of order 1
            q, k, v = (split_heads(z, nh) for z in qkv.split(c, dim=-1))
            out = fflash.flash_causal_attention(q, k, v)
            ref = fflash.flash_causal_attention_reference(q, k, v)
            e = float((out - ref).abs().max())
            check(out.shape == (b, nh, t, hd) and bool(
                torch.isfinite(out).all()) and e <= MAX_ROW_ERR,
                f"kernel {FLASH} at batch {b}: differs from plain by {e}")
            err[FLASH] = max(err[FLASH], e)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            tm = timed_in_turns({
                "kernel": lambda: fflash.flash_causal_attention(q, k, v),
                "plain": lambda: fflash.flash_causal_attention_reference(
                    q, k, v),
                "library": lambda: sdpa(q, k, v, is_causal=True)})
            e_lib = float((sdpa(q, k, v, is_causal=True) - ref).abs().max())
            if b == len(req):
                times[FLASH], library_ms[FLASH] = tm, tm["library"][0]
                flash_qkv = (q, k, v)
            log(f"kernel {FLASH} ({b}, {nh}, {t}, {hd}), q, k, v read in "
                f"place from the packed qkv: within {e:.3e} of plain (bound "
                f"{MAX_ROW_ERR}); {fmt_ms(tm['kernel'])}, plain "
                f"{fmt_ms(tm['plain'])}, scaled_dot_product_attention "
                f"{fmt_ms(tm['library'])} (within {e_lib:.3e} of plain)")

        _, tr_p = build(seed=SEED, attention_impl="pallas")
        tr_p.load_state_dict(tr.state_dict())
        x80 = torch.from_numpy(req).to(dev)
        lp, counts = counted(lambda: make_pipeline(vq, tr_p)(x80))
        check(counts == {FLASH: nb}, f"make_pipeline of the 'pallas' model "
                                     f"launched {json.dumps(counts)}")
        launched[FLASH] = ("attention_impl='pallas' make_pipeline",
                           counts[FLASH])
        lx = make_pipeline(vq, tr)(x80)
        worst = float((lp - lx).abs().max())
        sure = (lx[:, 0] - lx[:, 1]).abs() > LABEL_MARGIN
        check(worst <= MAX_STEP_ERR, f"'pallas' model: logits differ from "
                                     f"the 'xla' model's by {worst}")
        check(bool((lp.argmax(-1) == lx.argmax(-1))[sure].all()),
              "'pallas' model: labels differ from the 'xla' model's")
        short, counts = counted(lambda: tr_p.generate(start, num_steps=4))
        check(counts == {FLASH: nb * 4},
              f"generate of the 'pallas' model launched {json.dumps(counts)}")
        valid_ids(short, (bs, 5), "generate of the 'pallas' model")
        log(f"attention_impl='pallas': make_pipeline batch {len(req)} "
            f"launches {FLASH} x {nb}, logits within {worst:.3e} of the "
            f"'xla' model's (bound {MAX_STEP_ERR}), labels equal on "
            f"{int(sure.sum())} windows outside the margin; generate of 4 "
            f"steps launches it {nb * 4} times, ids equal the 'xla' "
            f"model's: {bool((short == tr.generate(start, num_steps=4)).all())}")
        f32_times = timed_in_turns({
            "pallas": lambda: make_pipeline(vq, tr_p)(x80),
            "xla": lambda: make_pipeline(vq, tr)(x80)})
        log(f"make_pipeline (f32) batch {len(req)}: attention_impl='pallas' "
            f"{fmt_ms(f32_times['pallas'])}, 'xla' "
            f"{fmt_ms(f32_times['xla'])}; gpu {smi}")

    # -- S6. quantized_generate_kv at batch 16 and 1 ------------------------
    for b in (bs, 1):
        st = start[:b]
        qids, counts = counted(lambda: quantized_generate_kv(
            tr, qp, st, num_steps=steps))
        check(counts == {}, f"quantized_generate_kv launched "
                            f"{json.dumps(counts)}")
        valid_ids(qids, (b, 1 + steps), f"quantized_generate_kv batch {b}")
        ids = qids                       # forced() follows these ids now
        got = forced(lambda: quantized_generate_kv(tr, qp, st,
                                                   num_steps=steps))
        with torch.inference_mode():
            ref = quantized_lm_logits(tr, qp, qids[:, :steps]).transpose(0, 1)
        worst = float((got - ref).abs().max())
        check(worst <= MAX_Q_STEP_ERR,
              f"quantized_generate_kv batch {b}: cached step logits differ "
              f"from the full int8 forward's by {worst}")
        top2 = ref.topk(2, dim=-1).values
        sure = top2[..., 0] - top2[..., 1] > 2 * MAX_Q_STEP_ERR
        check(bool((got.argmax(-1) == ref.argmax(-1))[sure].all()),
              f"quantized_generate_kv batch {b}: argmax differs from the "
              f"full int8 forward's outside the margin")
        log(f"quantized_generate_kv batch {b}, {steps} steps: ids valid, "
            f"{np.unique(qids.cpu().numpy()).size} distinct; cached step "
            f"logits within {worst:.3e} of quantized_lm_logits on the same "
            f"ids (bound {MAX_Q_STEP_ERR}); argmax equal on "
            f"{int(sure.sum())} draws outside the margin")

    # -- S7. ms per token of every variant, batch 16 and batch 1 -------------
    for b in (bs, 1):
        st = start[:b]
        runs = {name: (lambda kw=kw: tr.generate_kv(st, num_steps=steps,
                                                    **kw))
                for name, kw in variants.items()}
        runs["bf16 cache + weights, cache_buckets=64"] = (
            lambda: tr.generate_kv(st, num_steps=steps,
                                   cache_dtype=torch.bfloat16,
                                   param_dtype=torch.bfloat16,
                                   cache_buckets=64))
        runs["fused, plain version"] = on_plain_path(runs["fused"])
        runs["quantized_generate_kv"] = (
            lambda: quantized_generate_kv(tr, qp, st, num_steps=steps))
        tm = timed_in_turns(runs, reps=5, warmup=1, per=steps)
        log(f"ms per token, batch {b}, {steps} steps (prefill of the start "
            f"token included): "
            + "; ".join(f"{name} {fmt_ms(v)}" for name, v in tm.items())
            + f"; gpu {smi}")

    return {"launched": launched, "err": err, "times": times,
            "library_ms": library_ms, "flash_qkv": flash_qkv,
            "decode_operands": decode_operands}



def sampling_trace(tr, pipe) -> None:
    """Where a token's time goes: the device operations and the device
    time of a token of 'xla', 'fused' and the int8 sampler, from
    torch.profiler. It runs after every timing of the script: a process
    that has traced once launches more slowly afterwards."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.models.quantized import (
        quantized_generate_kv)
    bs, steps, qp = SAMPLE_BATCH, SAMPLE_STEPS, pipe.qparams
    start = torch.full((bs, 1), pipe.start_token, dtype=torch.int32,
                       device=tr.pe.device)
    # the fused step reads the cache up to `pos`, so it is traced over the
    # whole generation; the eager steps read the whole cache at every
    # position, and a fifth of the steps says the same of them in less time
    few = max(1, steps // 5)
    for name, n, run in (
            ("xla", few, lambda: tr.generate_kv(start, num_steps=few)),
            ("fused", steps, lambda: tr.generate_kv(
                start, num_steps=steps, decode_impl="fused")),
            ("quantized_generate_kv", few, lambda: quantized_generate_kv(
                tr, qp, start, num_steps=few))):
        n_ops, busy, top = device_profile(run)
        if busy is None:
            log(f"device trace of {name}: no device event, not measured")
            continue
        log(f"device trace of {name}, batch {bs}, {n} steps and the "
            f"prefill of the start token: "
            f"{n_ops / n:.1f} device operations and {busy / n:.4f} ms of "
            f"device time per token; most of it: "
            + "; ".join(f"{key[:60]} x {cnt / n:.1f} a token, "
                        f"{ms / n:.4f} ms" for key, cnt, ms in top[:5]))


def decode_trace(tr, operands, bounds: dict, smi: str) -> dict:
    """Device time of a call of #13 and #12 (one cooperative launch each)
    from torch.profiler, over one token's calls through the model's 8
    blocks, each with its own weights and caches (at batch 16 a token's
    calls read 270 MB against 50 MB of L2: every call is cold), at
    TIMED_POSITIONS, beside the bound of `kernel_work` at each position
    (`bounds`: {(kernel, pos): (ms, by)}). Returns {kernel: ms a call} at
    the first position."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_decode as fdec)
    x, full, flat = operands
    nb, nh = tr.n_blocks, tr.n_head
    out = {}
    with torch.inference_mode():
        for pos in TIMED_POSITIONS:
            for name, fn, store in (
                    (DEC_BLOCK, fdec.fused_block_decode, flat),
                    (DEC_ATTN, fdec.fused_decode_attn, full)):
                def token(fn=fn, store=store, pos=pos):
                    for blk, (k_c, v_c) in zip(tr.blocks, store):
                        fn(x, blk, k_c, v_c, pos, n_head=nh)
                n_ops, busy, names = device_profile(token)
                bound, by = bounds[name, pos]
                if busy is None:
                    log(f"device trace of {name} at pos {pos}: no device "
                        f"event, not measured")
                    continue
                if pos == TIMED_POSITIONS[0]:
                    out[name] = busy / nb
                log(f"device trace of {name} (batch {SAMPLE_BATCH}, pos "
                    f"{pos}, a token's {nb} calls, cold): {busy / nb:.4f} "
                    f"ms and {n_ops / nb:.1f} device operations a call, "
                    f"bound {bound:.4f} ms by {by} ({bound / (busy / nb):.1%} "
                    f"of the time taken): "
                    + "; ".join(f"{key[:50]} x {cnt / nb:.1f}"
                                for key, cnt, _ in names)
                    + f"; gpu {smi}")
    return out


def in_a_row(fns: dict, calls: int = 10) -> dict:
    """Time of one call of each fn when `calls` calls run in a row
    between two CUDA events, in turns (timed_in_turns, per=calls): once
    the host runs ahead of the card, the card's own time per call."""
    return timed_in_turns({name: (lambda fn=fn: [fn() for _ in range(calls)])
                           for name, fn in fns.items()}, per=calls)


# written between the calls of a kernel trace, larger than the card's L2
# (50 MB), so that no call reads the operands its predecessor left there;
# its kernel (the only bitwise_not of the script) is left out by name
FLUSH_BYTES, FLUSH_KEY = 64 << 20, "bitwise_not"


def kernel_trace(fns: dict, calls: int = 10) -> dict:
    """Device time of one call of each fn, from torch.profiler over
    `calls` calls, each after a 64 MB write that evicts its operands from
    L2: what CUDA events around one call see without the host's launch,
    on cold operands. {name: (ms, device operations, [(kernel, launches,
    ms a launch)]) per call}, (None, 0, []) where the trace holds no
    device event."""
    import torch
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def cold(fn):
        flush.bitwise_not_()
        return fn()

    out = {}
    for name, fn in fns.items():
        n_ops, busy, names = device_profile(
            lambda: [cold(fn) for _ in range(calls)], leave_out=FLUSH_KEY)
        out[name] = (None, 0, []) if busy is None else (
            busy / calls, n_ops / calls,
            [(key, cnt / calls, ms / cnt) for key, cnt, ms in names])
    return out


def log_library(what: str, times: tuple, lib, plain, smi: str) -> tuple:
    """Log scaled_dot_product_attention's time (events, in turns with the
    kernel and plain: `times`), its device time a call on cold operands
    (kernel_trace), the backend its kernels show (the trace's names) and
    its largest difference from the plain version. Returns (its device
    ms or None, the difference)."""
    import torch
    ms, _, names = kernel_trace({what: lib})[what]
    with torch.inference_mode():
        err = float((lib().float() - plain().float()).abs().max())
    log(f"{what}: scaled_dot_product_attention(is_causal=True) on the same "
        f"operands {fmt_ms(times)}; device "
        + ("not measured" if ms is None else f"{ms:.4f} ms a call")
        + f"; its kernels: "
        + ("; ".join(f"{key[:60]} x {cnt:.1f}" for key, cnt, _ in names[:4])
           or "none traced")
        + f"; largest difference from plain {err:.3e}; gpu {smi}")
    return ms, err


def is_decode(key: str) -> bool:
    """Whether a trace's kernel is #12's or #13's, on either form
    (csrc/decode.cu's decode_kernel, decode_general)."""
    return "decode_kernel" in key or "decode_general" in key


def is_kernel(key: str, name: str) -> bool:
    """Whether a trace's kernel name is `name`'s, any instantiation of
    it (its template arguments) and any namespace."""
    return re.search(rf"(^|::){name}[<(]", key) is not None


def pipeline_trace(fns: dict, x) -> None:
    """Where a batch's device time goes on TIMED_PATHS, from
    torch.profiler over three calls: device time per call, and the parts
    of it of the f32 attention (attention_kernel: attention_tc.cuh's
    tile with the int8 epilogue), of the int8 attention and of its
    quantizing pass ('attn8', 'full8': attention_int8.cuh), of the int8
    GEMM (int8_gemm_sm90_kernel, both epilogues) and of the f32 encoder
    chain (encoder_chain_kernel, #1) and of LN+q8 (#2's and #6's rows),
    each also per launch; a part the path does not launch is left
    out."""
    calls = 3
    for name in TIMED_PATHS:
        fn = fns[name]
        n_ops, busy, names = device_profile(
            lambda: [fn(x) for _ in range(calls)])
        if busy is None:
            log(f"device trace of make_pipeline_quantized({name}): no device "
                f"event, not measured")
            continue
        parts = []
        for what, pick in (
                ("the f32 attention (attention_kernel)",
                 lambda key: is_kernel(key, "attention_kernel")),
                (f"the int8 attention ({INT8_ATTENTION})",
                 lambda key: is_kernel(key, INT8_ATTENTION)),
                (f"its quantizing pass ({QUANT_PASS})",
                 lambda key: is_kernel(key, QUANT_PASS)),
                ("the int8 GEMM (int8_gemm_sm90_kernel)",
                 lambda key: "int8_gemm" in key),
                (f"LN+q8 rows ({LN_Q8})", lambda key: LN_Q8 in key),
                ("the f32 encoder chain (encoder_chain_kernel)",
                 lambda key: is_kernel(key, "encoder_chain_kernel"))):
            got = [(cnt, ms) for key, cnt, ms in names if pick(key)]
            if not got:
                continue
            n, ms = (sum(v) for v in zip(*got))
            parts.append(f"{what} x {n / calls:.1f} a call, "
                         f"{ms / calls:.4f} ms a call ({ms / busy:.1%})"
                         + f", {ms / n:.4f} ms a launch")
        log(f"device trace of make_pipeline_quantized({name}) batch {len(x)}, "
            f"{calls} calls: {n_ops / calls:.1f} device operations and "
            f"{busy / calls:.4f} ms of device time per call; "
            + "; ".join(parts) + "; most of it: " + "; ".join(
                f"{key[:60]} x {cnt / calls:.1f}, {ms / calls:.4f} ms"
                for key, cnt, ms in names[:10]))


def gemm_cases(x, sc, w, scales, vc, v3c, v4c) -> dict:
    """The int8 GEMM's four calls in #6 (block_quant) on block input x
    and the block's scratch sc: {shape: (int8_gemm's operands, the
    output #6 itself wrote at that stage)}."""
    m = x.shape[0] * x.shape[1]

    def rows(t):
        return t.reshape(m, t.shape[-1])
    return {
        "qkv": ((rows(sc["h8a"]), w["c_attn"], v3c[0], v3c[1], None, None),
                rows(sc["qkv"])),
        "c_proj": ((rows(sc["y8"]), w["c_proj"], vc[4], vc[5], rows(x),
                    None), rows(sc["x_mid"])),
        "c_fc": ((rows(sc["h8"]), w["c_fc"], v4c[0], v4c[1], None,
                  scales[3]), rows(sc["g8"])),
        "m_proj": ((rows(sc["g8"]), w["m_proj"], vc[6], vc[7],
                    rows(sc["x_mid"]), None), rows(sc["out"])),
    }


def gemm_phase(cases: dict) -> dict:
    """The int8 GEMM alone at the four shapes of a block at batch 80, on
    the bench model's block 0 operands (gemm_cases): each launch must be
    bit-equal to the plain stage and to what #6 wrote at that stage;
    then c_fc at twice its act scale with the saturation monitor's
    counts, which must equal the plain stage's. Returns ({shape: (the
    GEMM's call, torch._int_mm's call on the same a and w)}, {c_fc at
    its own and at twice its act scale, each without and with the
    counts: its call}, the int8 MLP of the main path (c_fc with the
    counts, then m_proj) as "kernel" and "plain" calls and the largest
    difference of their outputs as "err"), for the traces and the
    record at the end."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import int8_gemm as ig
    calls = {}
    for shape, (args, in_kernel) in cases.items():
        out, counts = counted(lambda: ig.int8_gemm(*args))
        check(counts == {GEMM: 1}, f"{GEMM} {shape} launched {counts}")
        ref = ig.int8_gemm_reference(*args)
        a, w = args[:2]
        same = [torch.equal(out, ref), torch.equal(out, in_kernel)]
        log(f"{GEMM} {shape} ({a.shape[0]} x {w.shape[0]} x {a.shape[1]}, "
            f"{'GELU+q8 int8' if out.dtype == torch.int8 else 'f32'}"
            f"{' + residual' if args[4] is not None else ''}): "
            f"bit-equal to the plain stage {same[0]}, to #6's own output "
            f"{same[1]}")
        check(all(same), f"{GEMM} {shape}: not bit-equal ({same})")
        calls[shape] = (lambda args=args: ig.int8_gemm(*args),
                        lambda a=a, w=w: torch._int_mm(a, w.t()))
    # c_fc at the drifted act scale (twice the calibrated one: half the
    # absmax), where the monitor's counts are not all 0: with them, the
    # same g8 and the plain stage's counts on the same operands
    args = (*cases["c_fc"][0][:5], cases["c_fc"][0][5] * 2)
    clip = torch.zeros(args[0].shape[0], dtype=torch.int32,
                       device=args[0].device)
    (out, plain_out), counts = counted(lambda: (
        ig.int8_gemm(*args, clip_rows=clip), ig.int8_gemm(*args)))
    check(counts == {GEMM: 2}, f"{GEMM} c_fc drifted launched {counts}")
    want = torch.zeros_like(clip)
    ref = ig.int8_gemm_reference(*args, clip_rows=want)
    same = [torch.equal(out, ref), torch.equal(plain_out, ref),
            torch.equal(clip, want)]
    log(f"{GEMM} c_fc at twice the act scale with the monitor's counts: "
        f"g8 bit-equal to the plain stage {same[0]} (without the counts "
        f"{same[1]}), counts equal to the plain stage's {same[2]} "
        f"({int(want.sum())} clipped of {ref.numel()}, "
        f"{int((want > 0).sum())} of {len(want)} rows)")
    check(all(same), f"{GEMM} c_fc counts: not equal ({same})")
    check(int(want.sum()) > 0, f"{GEMM} c_fc at twice the act scale clips "
                               f"nothing: the counts are not exercised")
    calibrated = cases["c_fc"][0]
    clip0 = torch.zeros_like(clip)
    counted_fc = {
        "c_fc": lambda: ig.int8_gemm(*calibrated),
        "c_fc, counted": lambda: ig.int8_gemm(*calibrated, clip_rows=clip0),
        "c_fc drifted": lambda: ig.int8_gemm(*args),
        "c_fc drifted, counted": lambda: ig.int8_gemm(*args, clip_rows=clip)}
    # the int8 MLP as the main path runs it, and its plain version
    mp = cases["m_proj"][0]

    def mlp(gemm):
        return lambda: gemm(gemm(*calibrated, clip_rows=clip0), *mp[1:])
    mlp_err = float((mlp(ig.int8_gemm)() - mlp(ig.int8_gemm_reference)())
                    .abs().max())
    return calls, counted_fc, {"kernel": mlp(ig.int8_gemm),
                               "plain": mlp(ig.int8_gemm_reference),
                               "err": mlp_err}


def bf16_encoder_phase(vq, tr, qp, xreqs, full_fn, smi: str) -> dict:
    """The bf16 encoder at full width (see the module docstring). Returns
    what the kernels' record needs of the bf16 chain: `launched`, `err`
    and `times`."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_encoder as fenc)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import CYCLE_LEN

    bf = torch.bfloat16
    nb, c, d = vq.n_resblocks, vq.hidden_dim, vq.embedding_dim
    dev = vq.codebook.device
    launched, err, times = {}, {}, {}
    with torch.inference_mode():
        packed = fenc.pack_encoder(vq)
        packed_bf = fenc.pack_encoder(vq, bf)
        check(packed_bf[0].dtype == bf and packed_bf[1].dtype == torch.float32,
              "pack_encoder(compute_dtype=) types")
        check(fenc.group_size_for(c, 2) >= nb,
              "the default bf16 group does not hold the whole stack")
        cycles = [xr.reshape(-1, CYCLE_LEN, 2) for xr in xreqs]

        def encode(cyc, **kw):
            return fenc.encode_indices_fused(vq, packed_bf, cyc,
                                             compute_dtype=bf, **kw)

        # -- B1. the encoder path: one launch per encode, nothing else -----
        ids, counts = counted(lambda: [encode(cyc) for cyc in cycles])
        check(counts == {ENC_BF16: len(cycles)},
              f"encode_indices_fused(bf16) launched {json.dumps(counts)}")
        ids1, counts1 = counted(lambda: [encode(cyc, group_size=1)
                                         for cyc in cycles])
        check(counts1 == {ENC_BF16: nb * len(cycles)},
              f"encode_indices_fused(bf16, group_size=1) launched "
              f"{json.dumps(counts1)}")
        check(all(torch.equal(a, b) for a, b in zip(ids, ids1)),
              "bf16 encoder: group_size=1 gives other ids than the default")
        with plain_path():
            plain = [encode(cyc) for cyc in cycles]
        exact = [vq.encode_indices(cyc) for cyc in cycles]
        for n, cyc, i, pl, ex in zip(REQUESTS, cycles, ids, plain, exact):
            check(i.shape == ex.shape and i.dtype == torch.int32,
                  f"bf16 encoder ids {tuple(i.shape)} {i.dtype}")
            h = vq.patch_embed_out(cyc)
            z_plain = vq.sep_conv(fenc.fused_encoder_eval_reference(
                h.reshape(-1, c), *packed_bf, use_bn=vq.batch_norm,
                compute_dtype=bf).reshape(h.shape)).reshape(-1, d)
            z_exact = vq.encode(cyc).reshape(-1, d)
            flat = i.reshape(-1)
            f_plain, f_exact = flip_rate(i, pl), flip_rate(i, ex)
            g_plain = worst_flip_gap(z_plain, vq.codebook, flat,
                                     pl.reshape(-1))
            g_exact = worst_flip_gap(z_exact, vq.codebook, flat,
                                     ex.reshape(-1))
            check(f_plain <= MAX_BF16_ID_FLIP and g_plain <= MAX_BF16_FLIP_GAP,
                  f"bf16 encoder, request of {n}: ids differ from the plain "
                  f"bf16 path's in {f_plain}, worst gap {g_plain}")
            check(f_exact <= MAX_BF16_F32_FLIP and g_exact <= MAX_BF16_F32_GAP,
                  f"bf16 encoder, request of {n}: ids differ from the f32 "
                  f"encoder's in {f_exact}, worst gap {g_exact}")
            log(f"bf16 encoder, request of {n}: {ENC_BF16} x 1 per encode "
                f"(x {nb} at group_size=1, the same ids); id flips against "
                f"the plain bf16 path {f_plain:.3e} (bound "
                f"{MAX_BF16_ID_FLIP}), each a near-tie within {g_plain:.3e} "
                f"of |z|^2 (bound {MAX_BF16_FLIP_GAP}); against the f32 "
                f"encoder {f_exact:.3e} (bound {MAX_BF16_F32_FLIP}), within "
                f"{g_exact:.3e} (bound {MAX_BF16_F32_GAP})")

        # -- B2. make_pipeline_quantized(encoder_dtype=) ----------------------
        fn_bf = make_pipeline_quantized(vq, tr, qp, encoder_dtype=bf)
        fn_32 = make_pipeline_quantized(vq, tr, qp)
        logits, counts = counted(lambda: [fn_bf(xr) for xr in xreqs])
        check(set(counts) == {ENC_BF16, ATTN, GEMM}
              and counts[ENC_BF16] == len(xreqs),
              f"make_pipeline_quantized(encoder_dtype=bf16) launched "
              f"{json.dumps(counts)}")
        launched[ENC_BF16] = (
            "make_pipeline_quantized(encoder_dtype=torch.bfloat16)",
            counts[ENC_BF16])
        agree = sure_n = 0
        for xr, lk in zip(xreqs, logits):
            check(lk.shape == (len(xr), 2) and bool(torch.isfinite(lk).all()),
                  "bf16-encoder pipeline: logits")
            l32 = fn_32(xr)
            sure = (l32[:, 0] - l32[:, 1]).abs() > LABEL_MARGIN
            agree += int((lk.argmax(-1) == l32.argmax(-1))[sure].sum())
            sure_n += int(sure.sum())
        log(f"make_pipeline_quantized(encoder_dtype=bf16): launches "
            f"{json.dumps(counts)}; labels equal the f32-encoder pipeline's "
            f"on {agree} of {sure_n} windows whose f32-encoder "
            f"|logit0-logit1| > {LABEL_MARGIN} (not forced: ids may differ)")

        # -- B3. the kernel against its plain version at 25,600 rows ----------
        h = vq.patch_embed_out(cycles[0])
        flat = h.reshape(-1, c).contiguous()
        n_rows = flat.shape[0]
        weights, vecs = packed
        wb = packed_bf[0]
        gen = torch.Generator().manual_seed(SEED + 1)
        bn = vecs.clone().view(nb, 2, 5, c)
        bn[:, :, 1] = (torch.randn(nb, 2, c, generator=gen) * 0.2).to(dev)
        bn[:, :, 2] = (torch.rand(nb, 2, c, generator=gen) * 1.5 + 0.5).to(dev)
        bn[:, :, 3] = (torch.rand(nb, 2, c, generator=gen) + 0.5).to(dev)
        bn[:, :, 4] = (torch.randn(nb, 2, c, generator=gen) * 0.1).to(dev)
        bn_vecs = bn.reshape(10 * nb, c).contiguous()
        err[ENC_BF16] = 0.0
        for use_bn, v in ((True, bn_vecs), (False, vecs)):
            x, worst_rel, worst_abs = flat, 0.0, 0.0
            for i in range(nb):     # each resblock fed the plain stream
                wi, vi = wb[2 * i:2 * i + 2], v[10 * i:10 * i + 10]
                yk = fenc.fused_encoder_eval(
                    x, wi, vi, use_bn=use_bn, compute_dtype=bf,
                    split=packed_bf.split[2 * i:2 * i + 2])
                yp = fenc.fused_encoder_eval_reference(
                    x, wi, vi, use_bn=use_bn, compute_dtype=bf)
                e, scale = float((yk - yp).abs().max()), float(yp.abs().max())
                check(bool(torch.isfinite(yk).all())
                      and e <= MAX_BF16_BLOCK_ERR * scale,
                      f"kernel {ENC_BF16} use_bn={use_bn} resblock {i}: "
                      f"differs from plain by {e} of {scale}")
                worst_rel = max(worst_rel, e / scale)
                worst_abs = max(worst_abs, e)
                x = yp
            err[ENC_BF16] = max(err[ENC_BF16], worst_abs)
            y8 = fenc.fused_encoder_eval(flat, wb, v, use_bn=use_bn,
                                         compute_dtype=bf,
                                         split=packed_bf.split)
            e8, scale8 = float((y8 - x).abs().max()), float(x.abs().max())
            check(bool(torch.isfinite(y8).all())
                  and e8 <= MAX_BF16_BLOCK_ERR * scale8,
                  f"kernel {ENC_BF16} x{nb}: differs from the plain chain "
                  f"by {e8} of {scale8}")
            f32_8 = fenc.fused_encoder_eval_reference(flat, weights, v,
                                                      use_bn=use_bn)
            note = ""
            if not use_bn:      # the model's own codebook fits these z only
                ids_k = vq.nearest(vq.sep_conv(y8.reshape(h.shape)))
                ids_p = vq.nearest(vq.sep_conv(x.reshape(h.shape)))
                flip = flip_rate(ids_k, ids_p)
                check(flip <= MAX_BF16_ID_FLIP,
                      f"kernel {ENC_BF16} x{nb}: id flips {flip}")
                note = (f", id flips {flip:.3e} (bound {MAX_BF16_ID_FLIP})")
            log(f"kernel {ENC_BF16} use_bn={use_bn}: {n_rows} rows, per "
                f"resblock on the plain stream max abs err {worst_abs:.3e}, "
                f"{worst_rel:.3e} of the output's scale (bound "
                f"{MAX_BF16_BLOCK_ERR}); all {nb} in one launch against the "
                f"plain chain {e8:.3e} of {scale8:.3e}, {e8 / scale8:.3e} of "
                f"it (bound {MAX_BF16_BLOCK_ERR}){note}; "
                f"the plain bf16 chain against the plain f32 chain "
                f"{float((x - f32_8).abs().max()):.3e}")

        # -- B4. times, in turns -------------------------------------------
        grp = fenc.group_size_for(c)

        def f32_groups():
            y = flat
            for s0 in range(0, nb, grp):
                y = fenc.fused_encoder_eval(
                    y, weights[2 * s0:2 * (s0 + grp)],
                    vecs[10 * s0:10 * (s0 + grp)], use_bn=False,
                    split=packed.split[2 * s0:2 * (s0 + grp)])
            return y

        tm = timed_in_turns({
            "kernel": lambda: fenc.fused_encoder_eval(
                flat, wb, vecs, use_bn=False, compute_dtype=bf,
                split=packed_bf.split),
            "plain": lambda: fenc.fused_encoder_eval_reference(
                flat, wb, vecs, use_bn=False, compute_dtype=bf),
            "f32": f32_groups,
            "one": lambda: fenc.fused_encoder_eval(
                flat, wb[:2], vecs[:10], use_bn=False, compute_dtype=bf,
                split=packed_bf.split[:2])})
        times[ENC_BF16] = tm
        ops = n_rows * nb * 2 * (2 * c * c)
        log(f"kernel {ENC_BF16} time ({n_rows} x {c}, {nb} resblocks in one "
            f"launch): {fmt_ms(tm['kernel'])}, "
            f"{ops / tm['kernel'][0] / 1e9:.1f} TFLOP/s; plain bf16 "
            f"{fmt_ms(tm['plain'])}; {ENC} x {nb // grp} launches of {grp} "
            f"{fmt_ms(tm['f32'])}; one resblock {fmt_ms(tm['one'])}; "
            f"gpu {smi}")
        c80, x80 = cycles[0], xreqs[0]
        enc = timed_in_turns({
            "bf16": lambda: encode(c80),
            "f32": lambda: fenc.encode_indices_fused(vq, packed, c80)})
        log(f"encode_indices_fused, {len(c80)} cycles: compute_dtype=bf16 "
            f"{fmt_ms(enc['bf16'])}, f32 {fmt_ms(enc['f32'])}; gpu {smi}")
        fn_bf_full = make_pipeline_quantized(vq, tr, qp, block_fusion="full",
                                             encoder_dtype=bf)
        e2e = timed_in_turns({"bf16": lambda: fn_bf_full(x80),
                              "f32": lambda: full_fn(x80)})
        n80 = len(x80)
        log(f"make_pipeline_quantized(full) batch {n80}: encoder_dtype=bf16 "
            f"{n80 / (e2e['bf16'][0] / 1e3):.1f} windows/s at "
            f"{fmt_ms(e2e['bf16'])}, f32 encoder "
            f"{n80 / (e2e['f32'][0] / 1e3):.1f} windows/s at "
            f"{fmt_ms(e2e['f32'])}; gpu {smi}")
    return {"launched": launched, "err": err, "times": times}


def same_qlinear(a, b) -> bool:
    import torch
    pairs = ((a.w_int8, b.w_int8), (a.scale, b.scale), (a.bias, b.bias),
             (a.act_scale, b.act_scale))
    return all((u is None and v is None) or (
        u is not None and v is not None and torch.equal(u, v))
        for u, v in pairs)


def same_qparams(a: dict, b: dict) -> bool:
    """Two qparams bit-equal: every int8 table, scale and packed operand."""
    import torch
    ok = all(torch.equal(a[k], b[k]) for k in ("tok_emb", "ln_f_scale",
                                               "ln_f_bias"))
    ok = ok and same_qlinear(a["lm_head"], b["lm_head"])
    ok = ok and all(same_qlinear(a["class_head"][k], b["class_head"][k])
                    for k in ("l1", "l2"))
    for x, y in zip(a["blocks"], b["blocks"]):
        ok = ok and all(same_qlinear(x[k], y[k])
                        for k in ("c_attn", "c_proj", "c_fc", "m_proj"))
        ok = ok and all(torch.equal(u, v) for u, v in zip(
            x["block_operands"], y["block_operands"]))
    return ok and len(a["blocks"]) == len(b["blocks"])


def host_seconds(fn) -> float:
    """Host clock around fn() and a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def deployment_phase(vq, tr, pipe, f32, req, smi: str) -> None:
    """bf16 serving, artifacts, checkpoints, the CSV scorer and the latent
    data module at full width (see the module docstring)."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.cli import score_quality
    from vq_vae_transformer_arc_welding_tpu_torch.data import (
        asimow, latent, synthetic)
    from vq_vae_transformer_arc_welding_tpu_torch.data.scaler import (
        StandardScaler)
    from vq_vae_transformer_arc_welding_tpu_torch.data.splits import (
        get_val_test_ids)
    from vq_vae_transformer_arc_welding_tpu_torch.entry import build
    from vq_vae_transformer_arc_welding_tpu_torch.native.build import (
        native_load_error)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        WeldingQualityPipeline)

    n80 = len(req)
    f32_labels, f32_probs = f32.classify(req)

    # -- D1. bf16 serving ---------------------------------------------------
    # the pipeline sets the option on the transformer it is given, so it
    # gets one of its own with the same weights
    _, tr_b = build(seed=SEED)
    tr_b.load_state_dict(tr.state_dict())
    pipe_b = WeldingQualityPipeline(vq, tr_b, n_cycles=N_CYCLES, max_batch=80,
                                    precision="bf16")
    check(tr_b.compute_dtype == torch.bfloat16 and tr.compute_dtype is None,
          "precision='bf16' did not set its own transformer's compute_dtype")
    (labels_b, probs_b), counts = counted(lambda: pipe_b.classify(req))
    check(counts == {}, f"bf16 classify launched {json.dumps(counts)}")
    check(probs_b.shape == (n80, 2) and probs_b.dtype == np.float32
          and bool(np.isfinite(probs_b).all())
          and bool(np.allclose(probs_b.sum(-1), 1.0, atol=1e-5)),
          "bf16 classify: probs")
    sure = np.abs(f32_probs[:, 0] - f32_probs[:, 1]) > BF16_PROB_MARGIN
    check(bool((labels_b == f32_labels)[sure].all()),
          f"bf16 classify: labels differ from f32 where |p0-p1| exceeds "
          f"{BF16_PROB_MARGIN}")
    check(not np.array_equal(probs_b, f32_probs),
          "bf16 classify gave the f32 bits: the option did nothing")
    tm = timed_in_turns({"bf16": lambda: pipe_b.classify(req),
                         "f32": lambda: f32.classify(req)})
    log(f"classify precision='bf16' batch {n80}: labels equal f32's on all "
        f"{int(sure.sum())} windows with |p0-p1| > {BF16_PROB_MARGIN} "
        f"({int((labels_b != f32_labels).sum())} differ within it), worst "
        f"|dprob| {float(np.abs(probs_b - f32_probs).max()):.3e}; "
        f"{n80 / (tm['bf16'][0] / 1e3):.1f} windows/s at "
        f"{fmt_ms(tm['bf16'])}, f32 {n80 / (tm['f32'][0] / 1e3):.1f} "
        f"windows/s at {fmt_ms(tm['f32'])}; gpu {smi}")

    with tempfile.TemporaryDirectory() as tmp:
        # -- D2. a synthetic CSV in the ASIMoW schema, and the scaler ------
        csv = os.path.join(tmp, "processed_asimow_dataset.csv")
        t0 = time.perf_counter()
        synthetic.write_synthetic_csv(csv, n_cycles_per_run=CSV_CYCLES_PER_RUN,
                                      seed=SEED)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        vi, _, exp, run = asimow.load_asimow_csv(csv)
        parse_s = time.perf_counter() - t0
        check(native_load_error() is None,
              f"the native CSV parser did not load: {native_load_error()}")
        check(vi.shape[1:] == (200, 2) and vi.dtype == np.float32
              and bool(np.isfinite(vi).all()), "load_asimow_csv: arrays")
        log(f"synthetic CSV: {len(vi)} cycles, "
            f"{os.path.getsize(csv) / 1e6:.1f} MB, written in "
            f"{write_s:.1f} s, "
            f"parsed by the native parser in {parse_s:.3f} s; gpu {smi}")
        pipe.scaler = StandardScaler().fit(vi)

        # -- D3. artifact: save, load without a device, bit-equal answers --
        (labels, probs) = pipe.classify(req)
        art = pipe.save_artifact(os.path.join(tmp, "artifact"))
        t0 = time.perf_counter()
        loaded = WeldingQualityPipeline.load_artifact(art)
        load_s = time.perf_counter() - t0
        check(loaded.device.type == "cuda"
              and loaded.tr_model.pe.device.type == "cuda",
              "load_artifact without a device did not build on the card")
        check(loaded.precision == "int8" and loaded.encoder_impl == "fused"
              and loaded.max_batch == pipe.max_batch
              and loaded.start_token == pipe.start_token,
              "load_artifact: serving configuration")
        check(same_qparams(loaded.qparams, pipe.qparams),
              "load_artifact: the int8 tables are not bit-equal to the "
              "saved pipeline's")
        check(bool(np.array_equal(loaded.scaler.mean_, pipe.scaler.mean_))
              and bool(np.array_equal(loaded.scaler.scale_,
                                      pipe.scaler.scale_)),
              "load_artifact: scaler")
        (labels2, probs2), counts = counted(lambda: loaded.classify(req))
        check(set(counts) == {ENC, ATTN, GEMM},
              f"the loaded pipeline launched {sorted(counts)}")
        check(bool(np.array_equal(probs2, probs))
              and bool(np.array_equal(labels2, labels)),
              "the loaded artifact does not answer bit-equal to the saved "
              "pipeline")
        log(f"artifact: saved ({', '.join(sorted(os.listdir(art)))}), loaded "
            f"on {loaded.device} in {load_s:.2f} s without calibration "
            f"windows; int8 tables bit-equal; classify({n80}) bit-equal to "
            f"the saved pipeline's, launches {json.dumps(counts)}; gpu {smi}")
        from_ckpt = WeldingQualityPipeline.from_checkpoints(
            os.path.join(art, "vqvae.ckpt"),
            os.path.join(art, "transformer.ckpt"), n_cycles=N_CYCLES,
            max_batch=80)
        check(from_ckpt.device.type == "cuda",
              "from_checkpoints without a device did not build on the card")
        labels3, probs3 = from_ckpt.classify(req)
        check(bool(np.array_equal(labels3, f32_labels))
              and bool(np.array_equal(probs3, f32_probs)),
              "from_checkpoints does not give the f32 pipeline's answers")
        log(f"from_checkpoints on the artifact's two .ckpt files: f32 "
            f"classify({n80}) bit-equal to the f32 pipeline's")

        # -- D4. the scorer over the CSV at stride 1 ----------------------------
        keys, sizes = np.unique(np.stack([exp, run], axis=1), axis=0,
                                return_counts=True)
        expected = int(np.maximum(sizes - N_CYCLES + 1, 0).sum())
        check(expected >= MIN_SCORED_WINDOWS,
              f"the CSV holds only {expected} windows")
        out = os.path.join(tmp, "scores.csv")
        parser = score_quality.build_parser()
        args = parser.parse_args(["--artifact", art, "--data-path", csv,
                                  "--out", out, "--stride", "1"])
        total_s = [0.0]

        def score():
            total_s[0] = host_seconds(lambda: score_quality.main(args))

        _, counts = counted(score)
        check(set(counts) == {ENC, ATTN, GEMM},
              f"the scorer launched {sorted(counts)}, expected {ENC}, "
              f"{ATTN} and {GEMM}")
        lines = open(out).read().strip().split("\n")
        check(lines[0] ==
              "experiment,welding_run,start_cycle,label,p_bad,p_good",
              f"scorer header {lines[0]!r}")
        rows = [ln.split(",") for ln in lines[1:]]
        check(len(rows) == expected,
              f"scorer wrote {len(rows)} rows, expected {expected}")
        check(all(len(r) == 6 and r[3] in ("0", "1")
                  and abs(float(r[4]) + float(r[5]) - 1.0) < 1e-5
                  for r in rows), "scorer rows")
        check({(int(r[0]), int(r[1])) for r in rows}
              == {(int(e), int(w)) for e, w in keys},
              "scorer: runs are not grouped by (experiment, welding_run)")
        out2 = os.path.join(tmp, "scores_chunked.csv")
        score_quality.main(parser.parse_args(
            ["--artifact", art, "--data-path", csv, "--out", out2,
             "--stride", "1", "--chunk", "512"]))
        check(open(out2).read() == open(out).read(),
              "the scorer's output depends on --chunk")
        n_bad = sum(r[3] == "0" for r in rows)
        log(f"score_quality: {len(rows)} windows of {N_CYCLES} cycles from "
            f"{len(keys)} runs at --stride 1 in {total_s[0]:.2f} s, "
            f"{len(rows) / total_s[0]:.1f} windows/s end to end (artifact "
            f"load, CSV parse, scaling, classify, writing); parsing takes "
            f"{parse_s:.3f} s, {parse_s / total_s[0]:.1%} of it; "
            f"{n_bad} flagged bad; the same file at --chunk 512; launches "
            f"{json.dumps(counts)}; gpu {smi}")

        # -- D5. the latent data module: whole splits encoded on the card -------
        split_ids = get_val_test_ids()
        val_ids, test_ids = split_ids["val_ids"], split_ids["test_ids"]
        base = asimow.ASIMoWDataModule(
            "classification", N_CYCLES, val_ids, test_ids,
            data_directory_path=tmp, shuffle=False)
        base.setup()
        tokens = {name: f32.encode_tokens(getattr(base, name).x)
                  for name in ("train", "val", "test")}
        mods = {}
        for task in ("autoregressive_ids_classification", "classification"):
            for depth in (1, 2):
                dm = latent.LatentPredDataModule(
                    vq, task, N_CYCLES, val_ids, test_ids,
                    data_directory_path=tmp, shuffle_val_test=False,
                    pipeline_depth=depth)
                secs = [0.0]

                def setup(dm=dm, secs=secs):
                    secs[0] = host_seconds(dm.setup)

                _, counts = counted(setup)
                check(counts == {}, f"LatentPredDataModule({task}) launched "
                                    f"{json.dumps(counts)}: its encoder is "
                                    f"the plain exact one")
                mods[task, depth] = dm
                log(f"LatentPredDataModule({task}, pipeline_depth={depth})"
                    f".setup(): train {dm.train.x.shape} {dm.train.x.dtype}, "
                    f"val {dm.val.x.shape}, test {dm.test.x.shape} in "
                    f"{secs[0]:.2f} s (CSV cache, windows, scaling, encode); "
                    f"gpu {smi}")
            one, two = mods[task, 1], mods[task, 2]
            for name in ("train", "val", "test"):
                a, b = getattr(one, name), getattr(two, name)
                check(all((u is None and v is None) or np.array_equal(u, v)
                          for u, v in zip(a, b)),
                      f"LatentPredDataModule({task}): pipeline_depth=2 is "
                      f"not bit-equal to 1 on {name}")
        ar = mods["autoregressive_ids_classification", 2]
        zq = mods["classification", 2]
        codebook = vq.codebook.detach().cpu().numpy()
        for name in ("train", "val", "test"):
            sp, want = getattr(ar, name), tokens[name]
            got = sp.x[:, 1:]
            check(got.shape == want.shape and sp.x.dtype == np.int64
                  and bool((sp.x[:, 0] == ar.num_classes - 2).all()),
                  f"latent ids of {name}: shape or start token")
            # encode_tokens runs chunks of 80 windows, the data module of
            # 4,096 cycles: the same plain encoder on other batch sizes,
            # whose products may be summed in another order
            flips = flip_rate(got, want.astype(np.int64))
            check(flips <= MAX_ID_FLIP,
                  f"latent ids of {name} differ from encode_tokens in "
                  f"{flips}")
            check(bool(np.array_equal(sp.cond, getattr(base, name).y)),
                  f"latent labels of {name}")
            lat = getattr(zq, name).x
            n = len(lat)
            check(lat.dtype == np.float32 and bool(np.array_equal(
                lat, codebook[got.reshape(n, N_CYCLES, -1)].reshape(
                    n, N_CYCLES, -1))),
                f"latent z_q of {name} is not the codebook rows of its ids")
            log(f"latent {name}: {n} windows, ids differ from "
                f"pipe.encode_tokens in {flips:.3e} of entries (bound "
                f"{MAX_ID_FLIP}), z_q bit-equal to the codebook rows of "
                f"the ids")
        allx = np.concatenate([base.train.x, base.val.x, base.test.x])
        n_cyc = len(allx) * N_CYCLES
        secs = {1: [], 2: []}
        for rep in range(4):
            for depth in (1, 2) if rep % 2 == 0 else (2, 1):
                dm = mods["autoregressive_ids_classification", depth]
                s = host_seconds(lambda: dm._encode_split(allx))
                if rep:                       # the first round warms up
                    secs[depth].append(s)
        med = {k: statistics.median(v) for k, v in secs.items()}
        log(f"latent encode of {len(allx)} windows ({n_cyc} cycles, chunks "
            f"of 4096): pipeline_depth=1 {n_cyc / med[1]:.0f} cycles/s "
            f"({med[1]:.3f} s), pipeline_depth=2 {n_cyc / med[2]:.0f} "
            f"cycles/s ({med[2]:.3f} s), medians of 3; gpu {smi}")


def drift_phase(pipe, vq, tr, am: dict, req) -> None:
    """classify after serving drifted past calibration: a pipeline like
    `pipe` whose act scales come from half the calibrated absmax
    (`quantize_transformer`), so that every monitored site clips. It
    must launch the main path's kernels (the GEMM twice a block) and
    report a saturation rate above 0 and within MAX_RATE_DIFF of its
    plain path's (h8 may move by one step in 0.1% of its entries), with
    labels equal where the plain probabilities differ by more than
    LABEL_MARGIN."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.models.quantized import (
        quantize_transformer)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        WeldingQualityPipeline)
    drifted = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES,
                                     max_batch=pipe.max_batch,
                                     precision="int8", encoder_impl="fused")
    with torch.inference_mode():
        drifted.qparams = quantize_transformer(
            tr, act_absmax={k: v / 2 for k, v in am.items()})
    (labels, _), counts = counted(lambda: drifted.classify(req))
    rate = drifted.last_saturation_rate
    check(set(counts) == {ENC, ATTN, GEMM}
          and counts[GEMM] == 2 * tr.n_blocks,
          f"drifted classify launched {json.dumps(counts)}")
    with plain_path():
        plain_labels, plain_probs = drifted.classify(req)
    plain_rate = drifted.last_saturation_rate
    sure = np.abs(plain_probs[:, 0] - plain_probs[:, 1]) > LABEL_MARGIN
    same = labels == plain_labels
    log(f"drifted request of {len(req)} (act scales of half the calibrated "
        f"absmax): launches {json.dumps(counts)}; saturation rate {rate:.6f}"
        f", plain path {plain_rate:.6f} (bound {MAX_RATE_DIFF}); labels "
        f"equal on all {int(sure.sum())} windows whose plain |p0-p1| > "
        f"{LABEL_MARGIN}: {bool(same[sure].all())}")
    check(rate > 0, "the drifted request's saturation rate is 0")
    check(abs(rate - plain_rate) <= MAX_RATE_DIFF,
          f"drifted saturation rate {rate} against the plain path's "
          f"{plain_rate}")
    check(bool(same[sure].all()), "drifted classify: labels differ from the "
                                  "plain path's")


def grads_of(model) -> dict:
    """{name: gradient} of the parameters that have one."""
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def global_norm(grads: dict) -> float:
    import torch
    return float(torch.linalg.vector_norm(torch.stack(
        [g.double().norm() for g in grads.values()])))


def one_step_against_plain(name: str, model, task, batch, kernel: str,
                           per_step: int, smi: str,
                           loss_gate: bool = True) -> tuple:
    """One training forward and backward of `task` on `batch` with the
    dropouts off, through the kernel path at the TF32 flags the caller
    set and through the plain path with both flags off (f32
    everywhere), from the same weights (no optimizer step, no BN state
    written).
    Checks the kernel's launches, the loss (MAX_TRAIN_LOSS_REL) and the
    global gradient norm (MAX_TRAIN_GNORM_REL) against plain; prints the
    largest per-tensor gradient difference. Returns (the ids the VQ's
    search gave on each path, empty for the transformer; the kernel
    path's loss and gradients). A bf16 model's plain path is bf16 too:
    only the kernels are replaced. loss_gate=False logs the loss against
    plain and leaves its check to the caller."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import fused_vq as fvq
    ids = {}

    def step(path):
        def recording(find):
            def run(z, cb):
                out = find(z, cb)
                ids[path] = out
                return out
            return run

        with mock.patch.object(fvq, "nearest_codes_pallas",
                               recording(fvq.nearest_codes_pallas)):
            model.zero_grad(set_to_none=True)
            loss, _, _ = task.loss_and_metrics(batch, train=True,
                                               generator=None)
            loss.backward()
        return float(loss.detach()), grads_of(model)

    (loss_k, g_k), counts = counted(lambda: step("kernel"))
    check(counts == {kernel: per_step},
          f"{name}: one training step launched {json.dumps(counts)}, "
          f"expected {kernel} x {per_step}")
    with plain_path(), tf32_flags(matmul=False, cudnn=False):
        (loss_p, g_p), counts = counted(lambda: step("plain"))
    check(counts == {}, f"{name}: the plain step launched {counts}")
    model.zero_grad(set_to_none=True)
    check(set(g_k) == set(g_p), f"{name}: the two paths' gradients are "
                                f"not of the same parameters")
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    n_k, n_p = global_norm(g_k), global_norm(g_p)
    rel_norm = abs(n_k - n_p) / n_p
    worst = max(((float((g_k[n] - g_p[n]).abs().max()), n) for n in g_k))
    log(f"{name} training step, dropout off, kernel path (TF32 flags: "
        f"matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
        f"{torch.backends.cudnn.allow_tf32}) against plain (both off): "
        f"{kernel} x {per_step}; loss {loss_k:.9g} / {loss_p:.9g} "
        f"(relative {rel_loss:.3e}, bound {MAX_TRAIN_LOSS_REL}); global "
        f"gradient norm {n_k:.9g} / {n_p:.9g} (relative {rel_norm:.3e}, "
        f"bound {MAX_TRAIN_GNORM_REL}); largest gradient difference "
        f"{worst[0]:.3e} in {worst[1]} (of {len(g_k)} tensors); gpu {smi}")
    check(math.isfinite(loss_k)
          and (rel_loss <= MAX_TRAIN_LOSS_REL or not loss_gate),
          f"{name}: loss {loss_k} against plain {loss_p}")
    check(math.isfinite(n_k) and rel_norm <= MAX_TRAIN_GNORM_REL,
          f"{name}: gradient norm {n_k} against plain {n_p}")
    return ids, loss_k, g_k


def timed_train_steps(name: str, model, task, batch, opt, units: int,
                      unit: str, smi: str) -> dict:
    """ms of a whole training step (zero_grad, forward, backward, BN
    state, clipped RAdam step) on the kernel path and the plain path in
    turns, CUDA events, median and quartiles of 10 after warm-up, with
    the step's `units` a second. Then torch.profiler's device trace of one kernel-path
    step: device-busy ms, the idle share of the step's median, and the
    kernels that take most of it."""
    import torch
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(SEED)

    def step():
        opt.zero_grad()
        loss, _, new = task.loss_and_metrics(batch, train=True, generator=gen)
        loss.backward()
        if new:
            model.commit_state(new)
        opt.step()

    fns = {"kernel": step, "plain": on_plain_path(step)}
    t = timed_in_turns(fns, warmup=2)
    log(f"{name} train step (batch {len(batch[0])}): "
        + "; ".join(f"{label} {fmt_ms(t[label])}, "
                    f"{units / t[label][0] * 1e3:.1f} {unit}/s"
                    for label in fns)
        + f"; medians and quartiles of 10 after warm-up, in turns; gpu {smi}")
    n_ops, busy, top = device_profile(step)
    if busy is None:
        log(f"{name} train step device trace: not measured (no device "
            f"events in the trace)")
    else:
        log(f"{name} train step device trace: {n_ops} operations, "
            f"{busy:.3f} ms busy, idle {1 - busy / t['kernel'][0]:.1%} of "
            f"the step's median; most time: " + "; ".join(
                f"{key[:60]} x {n}, {ms:.3f} ms ({ms / busy:.1%})"
                for key, n, ms in top[:8]) + f"; gpu {smi}")
    t["device_busy_ms"] = busy
    return t


def fit_checked(name: str, trainer, task, dm, tx, kernel: str,
                per_forward: int, opt=None, resume_from=None):
    """Trainer.fit with the launch counts set to 0 just before it and
    read just after; every forward (train and eval) launches `kernel`
    `per_forward` times and nothing else does. Returns (FitResult,
    launches)."""
    res, counts = counted(lambda: trainer.fit(task, dm, tx, opt=opt,
                                              resume_from=resume_from))
    epochs = len(res.history)
    n_train, bs = len(dm.train.x), dm.batch_size
    drop = getattr(dm, "drop_last", False)
    n_batches = n_train // bs if drop else -(-n_train // bs)
    micro = max(1, -(-n_batches // trainer.accum)) * trainer.accum
    n_val = len(dm.val.x)
    evals = n_val // bs + (0 if drop or n_val % bs == 0 else 1)
    want = per_forward * epochs * (micro + evals)
    check(counts == {kernel: want},
          f"{name}: Trainer.fit launched {json.dumps(counts)}, expected "
          f"{kernel} x {want} ({per_forward} a forward, {epochs} epochs of "
          f"{micro} train and {evals} val batches)")
    losses = [h["train_epoch/loss"] for h in res.history]
    check(all(math.isfinite(v) for h in res.history for k, v in h.items()
              if k.endswith("loss")), f"{name}: a loss is not finite: "
                                      f"{res.history}")
    return res, counts[kernel], losses


def same_weights(a, b) -> bool:
    """a's state_dict bit-equal to b's; the keys that differ are logged."""
    import torch
    sa, sb = a.state_dict(), b.state_dict()
    diff = [k for k in sa if not torch.equal(sa[k], sb[k])]
    if diff:
        log(f"{len(diff)} of {len(sa)} tensors differ, e.g. {diff[:3]}, by "
            f"up to {max(float((sa[k].double() - sb[k].double()).abs().max()) for k in diff):.3e}")
    return sa.keys() == sb.keys() and not diff


@contextlib.contextmanager
def tf32_flags(matmul: bool, cudnn: bool):
    """torch.backends' two TF32 flags (matmuls, cuDNN) set for the block
    and restored after it; usable as a decorator."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@tf32_flags(**TORCH_DEFAULT_TF32)
def training_phase(smi: str, device: str = "cuda") -> dict:
    """Training at the CLIs' default widths (see the module docstring),
    under torch's default TF32 flags, as a user's Trainer runs (the
    serving phases before it turn both off for the process):
    the VQ-VAE with vq_impl='pallas' (#7 in every forward) and the
    transformer with attention_impl='pallas' (#9 in every block's
    forward), each held one step against the plain path, timed a step,
    and trained by Trainer.fit, with a resume from its last checkpoint
    against the uninterrupted run. Returns {kernel: (path, launches in
    fit, launches a training forward)} and the step times."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.data import (
        ASIMoWDataModule, LatentPredDataModule, get_val_test_ids, synthetic)
    from vq_vae_transformer_arc_welding_tpu_torch.models import (
        TransformerDecoder, VQVAEPatch)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn as fflash)
    from vq_vae_transformer_arc_welding_tpu_torch.train.loop import Trainer
    from vq_vae_transformer_arc_welding_tpu_torch.train.optim import (
        make_radam, make_transformer_optimizer)
    from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
        ReconstructionTask, TransformerClassTask, TransformerGenTask)

    dev = torch.device(device)
    ids = get_val_test_ids()
    out = {"launches": {}, "times": {}}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # -- the VQ-VAE -------------------------------------------------
        vq_dir = os.path.join(tmp, "vq")
        synthetic.write_synthetic_csv(
            os.path.join(vq_dir, "processed_asimow_dataset.csv"),
            **TRAIN_VQ_CSV)
        dm = ASIMoWDataModule(task="reconstruction", n_cycles=1,
                              val_data_ids=ids["val_ids"],
                              test_data_ids=ids["test_ids"],
                              batch_size=TRAIN_VQ_BATCH,
                              data_directory_path=vq_dir)
        dm.setup()

        def new_vq(**runtime):
            return VQVAEPatch(**TRAIN_VQ, vq_impl="pallas",
                              generator=torch.Generator().manual_seed(SEED),
                              device=dev, **runtime)

        vq = new_vq().requires_grad_(True)
        task = ReconstructionTask(vq)
        batch = (torch.from_numpy(dm.train.x[:TRAIN_VQ_BATCH]).to(dev),)
        log(f"training: VQ-VAE hidden {vq.hidden_dim}, {vq.n_resblocks} "
            f"resblocks, K={vq.num_embeddings}, D={vq.embedding_dim}, "
            f"dropout {vq.dropout_p}, BN off, vq_impl='pallas', batch "
            f"{TRAIN_VQ_BATCH}; synthetic ASIMoW split: train "
            f"{dm.train.x.shape}, val {dm.val.x.shape}")
        vq.dropout_p = 0.0
        vq_step = one_step_against_plain("VQ-VAE", vq, task, batch,
                                         NEAREST, 1, smi)
        ids_of = vq_step[0]
        vq.dropout_p = TRAIN_VQ["dropout_p"]
        flips = int((ids_of["kernel"] != ids_of["plain"]).sum())
        log(f"VQ-VAE training step: {NEAREST} ids equal the plain "
            f"path's on {ids_of['kernel'].numel() - flips} of "
            f"{ids_of['kernel'].numel()} rows, "
            f"{torch.unique(ids_of['kernel']).numel()} distinct codes")
        check(flips == 0, f"VQ-VAE training step: {flips} ids differ "
                          f"from the plain path's")
        tx = make_radam(TRAIN_VQ["learning_rate"], clip_norm=TRAIN_VQ_CLIP)
        out["times"]["VQ-VAE"] = timed_train_steps(
            "VQ-VAE", vq, task, batch, tx.init(vq), TRAIN_VQ_BATCH,
            "windows", smi)
        bf16 = bf16_steps(
            "VQ-VAE", new_vq, ReconstructionTask, batch, vq_step,
            {"all": dict(compute_dtype=torch.bfloat16),
             "decoder": dict(compute_dtype=torch.bfloat16,
                             compute_scope="decoder")},
            NEAREST, 1, lambda m: tx, {"dropout_p": 0.0}, TRAIN_VQ_BATCH,
            "windows", smi)
        out["times"]["VQ-VAE bf16"] = bf16["times"]

        runs = {}
        for key, epochs, ck, resume in (
                ("straight", TRAIN_VQ_EPOCHS, "a", None),
                ("first", TRAIN_VQ_EPOCHS - 1, "b", None),
                ("resumed", TRAIN_VQ_EPOCHS, None, "b")):
            model = new_vq()
            trainer = Trainer(
                max_epochs=epochs, seed=SEED, verbose=False,
                monitor="val/loss", save_last=ck is not None,
                checkpoint_dir=os.path.join(tmp, ck) if ck else None)
            runs[key] = (model,) + fit_checked(
                f"VQ-VAE fit ({key})", trainer, ReconstructionTask(model),
                dm, tx, NEAREST, 1,
                resume_from=(os.path.join(tmp, resume, "last.ckpt")
                             if resume else None))
        model, res, n7, losses = runs["straight"]
        rate = [h["train_epoch/windows_per_s"] for h in res.history]
        log(f"VQ-VAE Trainer.fit: {len(losses)} epochs of "
            f"{len(dm.train.x) // TRAIN_VQ_BATCH} steps, train loss by "
            f"epoch {[round(v, 6) for v in losses]}, val/loss "
            f"{[round(h['val/loss'], 6) for h in res.history]}; "
            f"{NEAREST} x {n7}; windows/s by epoch (host clock, the "
            f"first epoch warms up) {[round(r, 1) for r in rate]}; "
            f"gpu {smi}")
        check(losses[-1] < losses[0], f"VQ-VAE: train loss did not fall "
                                      f"({losses})")
        check(same_weights(runs["resumed"][0], model),
              "VQ-VAE: the run resumed from last.ckpt is not the "
              "uninterrupted run bit for bit")
        log(f"VQ-VAE resume: {TRAIN_VQ_EPOCHS - 1} epochs, save_last, "
            f"resume_from for epoch {TRAIN_VQ_EPOCHS - 1}: parameters "
            f"and statistics bit-equal to the {TRAIN_VQ_EPOCHS}-epoch "
            f"run")
        out["launches"][NEAREST] = (
            f"VQ-VAE Trainer.fit, {TRAIN_VQ_EPOCHS} epochs", n7, 1)
        trained_vq = model.eval()
        del runs

        # -- the transformer on the trained VQ-VAE's latents --------------
        tr_dir = os.path.join(tmp, "tr")
        synthetic.write_synthetic_csv(
            os.path.join(tr_dir, "processed_asimow_dataset.csv"),
            **TRAIN_TR_CSV)
        dms = {}
        for task_name in ("autoregressive_ids",
                          "autoregressive_ids_classification"):
            dms[task_name] = LatentPredDataModule(
                trained_vq, task_name, N_CYCLES, ids["val_ids"],
                ids["test_ids"], batch_size=TRAIN_TR_BATCH,
                data_directory_path=tr_dir)
            dms[task_name].setup()
        gen_dm = dms["autoregressive_ids"]
        class_dm = dms["autoregressive_ids_classification"]
        seq_len = N_CYCLES * (400 // TRAIN_VQ["patch_size"]) + 1
        n_classes = TRAIN_VQ["num_embeddings"] + 2

        def new_tr(**runtime):
            return TransformerDecoder(
                **TRAIN_TR, n_classes=n_classes, seq_len=seq_len,
                attention_impl="pallas",
                generator=torch.Generator().manual_seed(SEED + 1),
                device=dev, **runtime)

        tr = new_tr().requires_grad_(True)
        nb = tr.n_blocks
        gen_task = TransformerGenTask(tr)
        x, c, y = (torch.as_tensor(a[:TRAIN_TR_BATCH], device=dev)
                   for a in (gen_dm.train.x, gen_dm.train.cond,
                             gen_dm.train.y))
        t_in = x.shape[1]
        log(f"training: transformer d{tr.d_model}, {nb} blocks, "
            f"{tr.n_head} heads, {n_classes} classes, T={t_in} "
            f"(start token and {t_in - 1} ids), att_dropout "
            f"{TRAIN_TR['att_dropout']}, res_dropout "
            f"{TRAIN_TR['res_dropout']}, attention_impl='pallas', batch "
            f"{TRAIN_TR_BATCH}; latent splits of the trained VQ-VAE: gen "
            f"train {gen_dm.train.x.shape}, class train "
            f"{class_dm.train.x.shape}")
        tr.res_dropout = 0.0
        tr_step = one_step_against_plain("transformer gen", tr, gen_task,
                                         (x, c, y), FLASH, nb, smi)
        one_step_against_plain("transformer class",
                               tr, TransformerClassTask(tr), (x, c, y),
                               FLASH, nb, smi)
        tr.res_dropout = TRAIN_TR["res_dropout"]
        # #9 at 320 tokens, forward and the backward's recompute
        q, k, v = (torch.randn(TRAIN_TR_BATCH, tr.n_head, t_in - 1,
                               tr.d_model // tr.n_head, device=dev,
                               requires_grad=True) for _ in range(3))
        (o, gq), counts = counted(lambda: (
            lambda o: (o, torch.autograd.grad(o.sum(), [q, k, v])))(
                fflash.flash_causal_attention(q, k, v)))
        ref = fflash.flash_causal_attention_reference(q, k, v)
        g_ref = torch.autograd.grad(ref.sum(), [q, k, v])
        e = float((o - ref).detach().abs().max())
        eg = max(float((a - b).abs().max()) for a, b in zip(gq, g_ref))
        check(counts == {FLASH: 1} and e <= MAX_ROW_ERR,
              f"{FLASH} at T={t_in - 1}: launches {counts}, within {e}")
        log(f"kernel {FLASH} with gradients at ({TRAIN_TR_BATCH}, "
            f"{tr.n_head}, {t_in - 1}, {tr.d_model // tr.n_head}): "
            f"output within {e:.3e} of plain (bound {MAX_ROW_ERR}), "
            f"gradients (the plain core's recompute) within {eg:.3e}")
        out["times"]["transformer"] = timed_train_steps(
            "transformer gen", tr, gen_task, (x, c, y),
            make_transformer_optimizer(tr).init(tr),
            TRAIN_TR_BATCH * t_in, "tokens", smi)
        bf16 = bf16_steps(
            "transformer", new_tr, TransformerGenTask, (x, c, y), tr_step,
            {"all": dict(compute_dtype=torch.bfloat16)}, FLASH_BF16, nb,
            make_transformer_optimizer, {"res_dropout": 0.0},
            TRAIN_TR_BATCH * t_in, "tokens", smi)
        out["launches"].update(bf16["launches"])
        out["times"]["transformer bf16"] = bf16["times"]

        runs = {}
        for key, epochs, ck, resume in (
                ("straight", TRAIN_GEN_EPOCHS, "ga", None),
                ("first", TRAIN_GEN_EPOCHS - 1, "gb", None),
                ("resumed", TRAIN_GEN_EPOCHS, None, "gb")):
            model = new_tr()
            tx_tr = make_transformer_optimizer(model)
            opt = tx_tr.init(model)
            trainer = Trainer(
                max_epochs=epochs, seed=SEED, verbose=False,
                save_last=ck is not None,
                checkpoint_dir=os.path.join(tmp, ck) if ck else None)
            runs[key] = (model, opt, tx_tr) + fit_checked(
                f"transformer gen fit ({key})", trainer,
                TransformerGenTask(model), gen_dm, tx_tr, FLASH, nb,
                opt=opt, resume_from=(os.path.join(tmp, resume, "last.ckpt")
                                      if resume else None))
        model, opt, tx_tr, res, n9, losses = runs["straight"]
        log(f"transformer gen Trainer.fit: {len(losses)} epochs of "
            f"{-(-len(gen_dm.train.x) // TRAIN_TR_BATCH)} steps, train "
            f"loss by epoch {[round(v, 6) for v in losses]}, val/loss "
            f"{[round(h['val/loss'], 6) for h in res.history]}; "
            f"{FLASH} x {n9}; gpu {smi}")
        check(losses[-1] < losses[0], f"transformer gen: train loss did "
                                      f"not fall ({losses})")
        check(same_weights(runs["resumed"][0], model),
              "transformer gen: the run resumed from last.ckpt is not "
              "the uninterrupted run bit for bit")
        log(f"transformer gen resume: {TRAIN_GEN_EPOCHS - 1} epoch, "
            f"save_last, resume_from for epoch {TRAIN_GEN_EPOCHS - 1}: "
            f"parameters bit-equal to the {TRAIN_GEN_EPOCHS}-epoch run")
        before = opt.step_counts()
        trainer = Trainer(max_epochs=TRAIN_CLASS_EPOCHS, seed=SEED + 1,
                          verbose=False, monitor="val/cl/f1_score",
                          mode="max")
        res_c, n9c, losses_c = fit_checked(
            "transformer class fit", trainer, TransformerClassTask(model),
            class_dm, tx_tr, FLASH, nb, opt=opt)
        after = opt.step_counts()
        moved = after["class_head.linear_1.weight"]
        check(after["lm_head.weight"] == before["lm_head.weight"] > 0
              and moved > 0 and before["class_head.linear_1.weight"] == 0,
              f"transformer class: RAdam step counts lm_head "
              f"{before['lm_head.weight']} -> {after['lm_head.weight']}, "
              f"class head {before['class_head.linear_1.weight']} -> "
              f"{moved}")
        last = res_c.history[-1]
        log(f"transformer class Trainer.fit (weighted sampling, the "
            f"gen stage's optimizer): train loss {losses_c}, val/cl/loss "
            f"{last['val/cl/loss']:.6f}, val/cl/f1_score "
            f"{last['val/cl/f1_score']:.4f}; {FLASH} x {n9c}; RAdam "
            f"steps of lm_head {before['lm_head.weight']} before and "
            f"after, of the class head 0 -> {moved}; gpu {smi}")
        out["launches"][FLASH] = (
            f"transformer Trainer.fit, gen {TRAIN_GEN_EPOCHS} epochs "
            f"then class {TRAIN_CLASS_EPOCHS}", n9 + n9c, nb)
    log(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def bf16_steps(name: str, make, task_of, batch, f32_step: tuple,
               variants: dict, kernel: str, per_step: int, tx_of,
               quiet: dict, units: int, unit: str, smi: str) -> dict:
    """bf16 training of `name` at the CLIs' widths: for each variant
    (label: runtime options, compute_dtype and the VQ-VAE's scope), a
    model made from the seed (`make(**options)`) takes one step with
    its dropouts off (`quiet`: attribute: value) through
    one_step_against_plain (the kernel path against the plain bf16
    path, its gates) and is held against the f32 step of the same
    weights and batch (`f32_step`: its (ids, loss, gradients) from
    one_step_against_plain) within tests/test_mixed_precision.py's
    envelopes: the loss (MAX_BF16_LOSS_REL), each gradient of norm above
    MIN_BF16_GRAD_NORM against its largest magnitude
    (MAX_BF16_GRAD_REL), f32 gradients, and the VQ's ids
    (MAX_BF16_TRAIN_FLIP). Then a whole training step of the f32 model
    and of every variant in turns (recorded, not claimed). Returns
    {"times": ..., "launches": {kernel: (path, launches, per step)}}."""
    import torch
    ids32, loss32, g32 = f32_step
    out = {"launches": {}, "times": {}}
    for label, kw in variants.items():
        m = make(**kw).requires_grad_(True)
        saved = {a: getattr(m, a) for a in quiet}
        for a, v in quiet.items():
            setattr(m, a, v)
        ids16, loss16, g16 = one_step_against_plain(
            f"{name} bf16 {label}", m, task_of(m), batch, kernel, per_step,
            smi)
        for a, v in saved.items():
            setattr(m, a, v)
        rel_loss = abs(loss16 - loss32) / abs(loss32)
        check(set(g16) == set(g32) and all(
            g.dtype == torch.float32 for g in g16.values()),
            f"{name} bf16 {label}: gradients not f32 or not of the f32 "
            f"step's parameters")
        rel = {n: float((g16[n] - g).abs().max() / g.abs().max())
               for n, g in g32.items()
               if float(g.norm()) > MIN_BF16_GRAD_NORM}
        worst = max(rel.items(), key=lambda kv: kv[1])
        flips = (float((ids16["kernel"] != ids32["kernel"]).float().mean())
                 if ids32 else 0.0)
        log(f"{name} bf16 {label} against the f32 step (same weights and "
            f"batch, dropout off): loss {loss16:.9g} / {loss32:.9g} "
            f"(relative {rel_loss:.3e}, bound {MAX_BF16_LOSS_REL}); worst "
            f"gradient {worst[1]:.3e} of its magnitude in {worst[0]} "
            f"({len(rel)} tensors of norm > {MIN_BF16_GRAD_NORM}, bound "
            f"{MAX_BF16_GRAD_REL[name]})"
            + (f"; ids flipped {flips:.4f} (bound {MAX_BF16_TRAIN_FLIP})"
               if ids32 else ""))
        check(rel_loss <= MAX_BF16_LOSS_REL,
              f"{name} bf16 {label}: loss {loss16} against f32 {loss32}")
        check(worst[1] <= MAX_BF16_GRAD_REL[name],
              f"{name} bf16 {label}: gradient {worst}")
        check(flips <= MAX_BF16_TRAIN_FLIP,
              f"{name} bf16 {label}: ids flipped {flips}")
        out["launches"][kernel] = (
            f"{name} bf16 ({label}) training step against plain", per_step,
            per_step)
    gen = torch.Generator(device=batch[0].device)

    def train_step(model):
        task, opt = task_of(model), tx_of(model).init(model)
        model.requires_grad_(True)

        def step():
            opt.zero_grad()
            loss, _, new = task.loss_and_metrics(batch, train=True,
                                                 generator=gen)
            loss.backward()
            if new:
                model.commit_state(new)
            opt.step()
        return step

    fns = {"f32": train_step(make()),
           **{f"bf16 {label}": train_step(make(**kw))
              for label, kw in variants.items()}}
    t = timed_in_turns(fns, warmup=2)
    log(f"{name} train step (batch {len(batch[0])}), f32 and bf16 in turns: "
        + "; ".join(f"{label} {fmt_ms(t[label])}, "
                    f"{units / t[label][0] * 1e3:.1f} {unit}/s"
                    for label in fns)
        + f"; medians and quartiles of 10 after warm-up; gpu {smi}")
    for label in fns:
        if label == "f32":
            continue
        n_ops, busy, top = device_profile(fns[label])
        t[label + " device_busy_ms"] = busy
        log(f"{name} {label} train step device trace: " + (
            "not measured (no device events in the trace)" if busy is None
            else f"{n_ops} operations, {busy:.3f} ms busy, idle "
            f"{1 - busy / t[label][0]:.1%} of the step's median; most time: "
            + "; ".join(f"{key[:60]} x {n}, {ms:.3f} ms ({ms / busy:.1%})"
                        for key, n, ms in top[:8])) + f"; gpu {smi}")
    out["times"] = t
    return out


def flash_bf16_phase(smi: str) -> dict:
    """#9 on bf16 q, k, v at FLASH_BF16_SHAPES (T=321; q, k, v read in
    place from a packed bf16 qkv): one launch a call, against its plain
    version (MAX_BF16_DIFF_SHARE), timed in turns with it and with
    scaled_dot_product_attention(is_causal=True) on the same bf16 q, k, v
    (CUDA events), and traced (device ms on cold operands, TRACE_CALLS
    calls; a trace without a device event is taken again, up to
    TRACE_TRIES times, and one still without fails), beside the bound of
    kernel_work and the share of it reached. Returns the record's numbers
    at the first shape, the bf16 transformer's training shape: its times,
    its work (kernel_work), its error and the device times."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        attention, fused_attn as fflash)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(SEED)
    t = 321
    rec = None
    for b, h, d in FLASH_BF16_SHAPES:
        c = h * d
        qkv = (torch.randn(b, t, 3 * c, generator=gen) * 2).to(
            "cuda", torch.bfloat16)
        q, k, v = (attention.split_heads(z, h) for z in qkv.split(c, dim=-1))
        with torch.inference_mode():
            out, counts = counted(
                lambda: fflash.flash_causal_attention(q, k, v))
            ref = fflash.flash_causal_attention_reference(q, k, v)
            lib = sdpa(q, k, v, is_causal=True)
        check(counts == {FLASH_BF16: 1} and out.dtype == torch.bfloat16
              and out.shape == (b, h, t, d)
              and bool(torch.isfinite(out.float()).all()),
              f"{FLASH_BF16} ({b}, {h}, {t}, {d}): launches {counts}, "
              f"{out.dtype} {tuple(out.shape)}")
        ulps = (out.view(torch.int16).int() - ref.view(torch.int16).int()
                ).abs()
        err = (out.float() - ref.float()).abs()
        share = float((ulps > 0).float().mean())
        far = int(((ulps > 1) & (err > MAX_ROW_ERR)).sum())
        e = float(err.max())
        e_lib = float((lib.float() - ref.float()).abs().max())
        check(far == 0 and share <= MAX_BF16_DIFF_SHARE,
              f"{FLASH_BF16} ({b}, {h}, {t}, {d}): {share:.2e} of the "
              f"entries differ from plain, {far} by more than one bf16 "
              f"step and {MAX_ROW_ERR}")
        with torch.inference_mode():
            tm = timed_in_turns({
                "kernel": lambda: fflash.flash_causal_attention(q, k, v),
                "plain": lambda: fflash.flash_causal_attention_reference(
                    q, k, v),
                "library": lambda: sdpa(q, k, v, is_causal=True)})
            fns = {"kernel": lambda: fflash.flash_causal_attention(q, k, v),
                   "library": lambda: sdpa(q, k, v, is_causal=True)}
            traced, tries = {}, {}
            for name, fn in fns.items():
                for tries[name] in range(1, TRACE_TRIES + 1):
                    traced[name] = kernel_trace({name: fn},
                                                calls=TRACE_CALLS)[name]
                    if traced[name][0] is not None:
                        break
        dev_ms, lib_dev = traced["kernel"][0], traced["library"][0]
        check(dev_ms is not None and lib_dev is not None,
              f"{FLASH_BF16} ({b}, {h}, {t}, {d}): no device event in "
              f"{TRACE_TRIES} traces (kernel {dev_ms}, "
              f"scaled_dot_product_attention {lib_dev})")
        work = kernel_work(1, c, 1, 1, 25, 32, 256, b, t, h, 1, 1)[FLASH_BF16]
        bound, by = bound_of(work)
        log(f"kernel {FLASH_BF16} ({b}, {h}, {t}, {d}), bf16 q, k, v read "
            f"in place from the packed qkv: {share:.2e} of the entries "
            f"differ from plain (bound {MAX_BF16_DIFF_SHARE}), largest "
            f"{e:.3e}; {fmt_ms(tm['kernel'])}, plain {fmt_ms(tm['plain'])}, "
            f"scaled_dot_product_attention {fmt_ms(tm['library'])} (within "
            f"{e_lib:.3e} of plain); device {dev_ms:.4f} ms "
            f"({traced['kernel'][2][0][0][:40]} x "
            f"{traced['kernel'][2][0][1]:.1f}), scaled_dot_product_attention "
            f"{lib_dev:.4f} ms a call (traces taken {tries['kernel']}, "
            f"{tries['library']}); bound {bound:.5f} ms by {by}, "
            f"{bound / dev_ms:.1%} of the device time; kernel / "
            f"scaled_dot_product_attention {dev_ms / lib_dev:.2f}x; "
            f"gpu {smi}")
        if rec is None:
            rec = {"shape": [b, h, t, d], "max_abs_err": e,
                   "diff_share": share, "times": tm, "work": work,
                   "device_ms": dev_ms, "library_device_ms": lib_dev}
    return rec


@tf32_flags(**TORCH_DEFAULT_TF32)
def classification_phase(smi: str, device: str = "cuda") -> dict:
    """The second stage's models and the trainer's data paths, at the
    classification CLI's defaults (CLS) on a synthetic ASIMoW CSV made
    from the seed, under torch's default TF32 flags as a user's Trainer
    runs: the MLP and the GRU on raw windows with window_mode='ondevice'
    (the windows gathered on the card by index), the MLP again with its
    training split streamed from a memory map (Trainer(streaming=True),
    the native row gather into pinned memory: bit-equal to the resident
    fit), the MLP on a frozen VQ-VAE's z_q and MLPEmbedding on its ids
    through LatentPredDataModule (vq_impl='pallas': #7 launched by the
    encode and by nothing else), each a short Trainer.fit with every loss
    finite and the last epoch's below the first's; then a few steps of
    the EMA VQ-VAE (EMA_VQ) at TRAIN_VQ's widths: the kmeans bootstrap
    on the first batch, the EMAs moving, dead codes re-seeded. Returns
    {"launches": {NEAREST: ...}}."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.data import (
        ASIMoWDataModule, ArraySplit, LatentPredDataModule,
        get_val_test_ids, streaming, synthetic)
    from vq_vae_transformer_arc_welding_tpu_torch.models import (
        GRU, MLP, MLPEmbedding, VQVAEPatch)
    from vq_vae_transformer_arc_welding_tpu_torch.train.loop import Trainer
    from vq_vae_transformer_arc_welding_tpu_torch.train.optim import (
        make_radam)
    from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
        ClassificationTask, ReconstructionTask)

    dev = torch.device(device)
    ids = get_val_test_ids()
    tx = make_radam(CLS["learning_rate"], clip_norm=CLS_CLIP)
    out = {"launches": {}}
    t_phase = time.perf_counter()

    def seeded(cls, **kw):
        return cls(**kw, **CLS, output_size=2, device=dev,
                   generator=torch.Generator().manual_seed(SEED))

    def fit(label, task, dm, **trainer_kw):
        trainer = Trainer(max_epochs=CLS_EPOCHS, seed=SEED, verbose=False,
                          monitor="val/f1_score_mean", mode="max",
                          **trainer_kw)
        res, counts = counted(lambda: trainer.fit(task, dm, tx))
        losses = [h["train_epoch/loss"] for h in res.history]
        check(counts == {}, f"{label}: Trainer.fit launched {counts}")
        check(all(math.isfinite(v) for h in res.history
                  for k, v in h.items() if k.endswith("loss")),
              f"{label}: a loss is not finite: {res.history}")
        log(f"classification {label}: train {dm.train.x.shape}, val "
            f"{dm.val.x.shape}, {len(losses)} epochs, train loss by epoch "
            f"{[round(v, 6) for v in losses]}, val f1 "
            f"{[round(h['val/f1_score_mean'], 4) for h in res.history]}, "
            f"windows/s by epoch (host clock) "
            f"{[round(h['train_epoch/windows_per_s'], 1) for h in res.history]}"
            f"; gpu {smi}")
        check(losses[-1] < losses[0],
              f"{label}: train loss did not fall ({losses})")
        return res, losses

    with tempfile.TemporaryDirectory() as tmp:
        synthetic.write_synthetic_csv(
            os.path.join(tmp, "processed_asimow_dataset.csv"), **CLS_CSV)
        dm = ASIMoWDataModule(task="classification", n_cycles=CLS_CYCLES,
                              val_data_ids=ids["val_ids"],
                              test_data_ids=ids["test_ids"],
                              batch_size=CLS_BATCH, data_directory_path=tmp,
                              window_mode="ondevice")
        dm.setup()
        check(type(dm.train.x).__name__ == "WindowedArray",
              "window_mode='ondevice' gave no WindowedArray")
        n_cyc = dm.train.x.cycles.shape[0]
        log(f"classification data: window_mode='ondevice', train "
            f"{len(dm.train.x)} windows of {CLS_CYCLES} cycles over "
            f"{n_cyc} packed cycles ({len(dm.train.x) * CLS_CYCLES / n_cyc:.2f}"
            f"x less than materialized)")
        mlp_kw = dict(input_size=200 * CLS_CYCLES, in_dim=2)
        res_mlp, _ = fit("MLP on raw windows", ClassificationTask(
            seeded(MLP, **mlp_kw)), dm)
        fit("GRU on raw windows", ClassificationTask(seeded(
            GRU, input_size=CLS_CYCLES, in_dim=400)), dm)

        # -- the same MLP fit with its training split streamed -----------
        x_train, y_train = dm.train.x.materialize(), dm.train.y
        path = streaming.MmapDataset.write(os.path.join(tmp, "train"),
                                           x_train, y_train)

        class StreamedDM:
            batch_size, drop_last = dm.batch_size, dm.drop_last
            train_sampling = dm.train_sampling
            train = streaming.StreamingSplit(streaming.MmapDataset(path))
            val, test = dm.val, dm.test

        class ResidentDM(StreamedDM):
            train = ArraySplit(x_train, y_train)

        runs = {}
        for label, dm_, kw in (("resident", ResidentDM(), {}),
                               ("streamed", StreamedDM(), {"streaming":
                                                           True})):
            model = seeded(MLP, **mlp_kw)
            res, losses = fit(f"MLP, train split {label}",
                              ClassificationTask(model), dm_, **kw)
            runs[label] = (model, losses)
        gathered = StreamedDM.train.x.gathers
        check(gathered["native"] > 0 and gathered["numpy"] == 0,
              f"the streamed fit's gathers: {gathered}")
        check(runs["streamed"][1] == runs["resident"][1]
              and same_weights(runs["streamed"][0], runs["resident"][0]),
              "the streamed fit is not the resident fit bit for bit")
        log(f"streaming: Trainer(streaming=True) over a memory map of "
            f"{x_train.nbytes / 2**20:.1f} MiB, {gathered['native']} native "
            f"row gathers into pinned memory, none by numpy; losses and "
            f"weights bit-equal to the resident fit; the MLP on the "
            f"ondevice windows reached val f1 "
            f"{res_mlp.history[-1]['val/f1_score_mean']:.4f}")

        # -- the latent classifiers on a frozen VQ-VAE -------------------
        vq = VQVAEPatch(**TRAIN_VQ, vq_impl="pallas", device=dev,
                        generator=torch.Generator().manual_seed(SEED)).eval()
        n7 = 0
        for task_name, label in (("classification", "MLP on z_q"),
                                 ("classification_ids",
                                  "MLPEmbedding on ids")):
            ldm = LatentPredDataModule(vq, task_name, CLS_CYCLES,
                                       ids["val_ids"], ids["test_ids"],
                                       batch_size=CLS_BATCH,
                                       data_directory_path=tmp)
            _, counts = counted(ldm.setup)
            check(set(counts) == {NEAREST},
                  f"{task_name} latents: the encode launched {counts}")
            n7 += counts[NEAREST]
            if task_name == "classification":
                model = seeded(MLP, input_size=CLS_CYCLES,
                               in_dim=ldm.train.x.shape[-1])
                task = ClassificationTask(model)
            else:
                model = seeded(MLPEmbedding, input_size=CLS_CYCLES,
                               in_dim=ldm.train.x.shape[-1])
                task = ClassificationTask(model, ids_input=True)
            log(f"{task_name} latents of a VQ-VAE at hidden "
                f"{vq.hidden_dim} (vq_impl='pallas'): {NEAREST} x "
                f"{counts[NEAREST]} for the encode, train "
                f"{ldm.train.x.shape}")
            fit(label, task, ldm)
        out["launches"][NEAREST] = ("LatentPredDataModule.setup, two latent "
                                    "tasks", n7, None)

        # -- the EMA VQ --------------------------------------------------
        rdm = ASIMoWDataModule(task="reconstruction", n_cycles=1,
                               val_data_ids=ids["val_ids"],
                               test_data_ids=ids["test_ids"],
                               batch_size=TRAIN_VQ_BATCH,
                               data_directory_path=tmp)
        rdm.setup()
        ema = VQVAEPatch(**TRAIN_VQ, **EMA_VQ, device=dev,
                         generator=torch.Generator().manual_seed(SEED))
        ema.requires_grad_(True)
        task = ReconstructionTask(ema)
        opt = make_radam(TRAIN_VQ["learning_rate"],
                         clip_norm=TRAIN_VQ_CLIP).init(ema)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        cycles = torch.from_numpy(rdm.train.x).to(dev)
        n_batches = max(1, len(cycles) // TRAIN_VQ_BATCH)
        thr = EMA_VQ["threshold_ema_dead_code"]
        seen, rows = [], []
        for i in range(EMA_STEPS):
            lo = (i % n_batches) * TRAIN_VQ_BATCH
            batch = (cycles[lo:lo + TRAIN_VQ_BATCH],)
            before = ema.codebook.clone()
            opt.zero_grad()
            (loss, m, new), counts = counted(
                lambda: task.loss_and_metrics(batch, train=True,
                                              generator=gen))
            loss.backward()
            ema.commit_state(new)
            opt.step()
            check(counts == {} and math.isfinite(float(loss.detach())),
                  f"EMA VQ step {i}: launches {counts}, loss {loss}")
            refreshed = int((ema.ema.cluster_size[0] == thr).sum())
            moved = int((ema.codebook != before).any(dim=1).sum())
            seen.append(refreshed)
            rows.append(f"step {i}: loss {float(loss.detach()):.6f}, perplexity "
                        f"{float(m['perplexity']):.2f}, {moved} codes moved, "
                        f"{refreshed} re-seeded")
            if i == 0:
                check(bool(ema.ema.initted[0] == 1)
                      and float(before.abs().sum()) == 0.0
                      and float(ema.codebook.abs().sum()) > 0,
                      "EMA VQ: the first training batch did not bootstrap "
                      "the codebook")
        log(f"EMA VQ (hidden {ema.hidden_dim}, K={ema.num_embeddings}, "
            f"kmeans_iters {ema.kmeans_iters}, dead-code threshold {thr}, "
            f"batch {TRAIN_VQ_BATCH} of {len(cycles)} train cycles): "
            + "; ".join(rows) + f"; gpu {smi}")
        check(any(seen), f"EMA VQ: no dead code re-seeded in {EMA_STEPS} "
                         f"steps")
    log(f"classification phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def _random_bn(vecs, gen):
    """vecs (10 n, C) with random eval BatchNorm rows (mean, var, scale,
    bias of both convs), as section 6 draws them, so that the encoder
    kernels' BN path runs."""
    import torch
    nb, c = vecs.shape[0] // 10, vecs.shape[1]
    bn = vecs.clone().view(nb, 2, 5, c)
    dev = vecs.device
    bn[:, :, 1] = (torch.randn(nb, 2, c, generator=gen) * 0.2).to(dev)
    bn[:, :, 2] = (torch.rand(nb, 2, c, generator=gen) * 1.5 + 0.5).to(dev)
    bn[:, :, 3] = (torch.rand(nb, 2, c, generator=gen) + 0.5).to(dev)
    bn[:, :, 4] = (torch.randn(nb, 2, c, generator=gen) * 0.1).to(dev)
    return bn.reshape(10 * nb, c).contiguous()


def _spread_codebook(vq, cycles, what: str) -> None:
    """Scale a random model's codebook to the spread of z_e where it
    uses fewer than MIN_DISTINCT_FRAC of its codes, as main() does, so
    that the argmin is exercised."""
    import torch
    k = vq.num_embeddings
    with torch.no_grad():
        used = torch.unique(vq.encode_indices(cycles)).numel()
        if used < MIN_DISTINCT_FRAC * k:
            vq.codebook.mul_(float(vq.encode(cycles).std()
                                   / vq.codebook.std()))
            used = torch.unique(vq.encode_indices(cycles)).numel()
    log(f"widths: {what} uses {used} of {k} codes")
    check(used >= MIN_DISTINCT_FRAC * k,
          f"widths: {what} uses {used} of {k} codes")


def widths_phase(smi: str, device: str = "cuda") -> dict:
    """Models off the bench widths on their kernels (see the module
    docstring): the quality study's VQ-VAE (hidden 64) and transformer
    (d192, 8 heads of 24) through classify, make_pipeline_quantized's
    int8 paths, the encoder paths (and a hidden-256 VQ-VAE's),
    generate_kv(decode_impl='fused') and a training step with
    attention_impl='pallas'; then every extended kernel against its
    plain version and timed at the head widths of WIDTH_HEADS and the
    hidden widths of WIDTH_HIDDEN. Returns {"launched": {kernel: (path,
    launches)}, "widths": {kernel: [widths held]}}."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn as fflash, fused_attn_quant as fattn,
        fused_block_quant as fbq, fused_decode as fdec,
        fused_encoder as fenc)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        split_heads)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.fused_mlp_quant import (
        mlp_from_h8_reference)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    from vq_vae_transformer_arc_welding_tpu_torch.ops.patching import patchify
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline)
    from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
        TransformerGenTask)

    t_phase = time.perf_counter()
    dev = torch.device(device)
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator().manual_seed(SEED + 1)
    width = N_CYCLES * CYCLE_LEN
    calib = rng.standard_normal((N_CALIB, width, 2)).astype(np.float32)
    req = rng.standard_normal((WIDTH_REQUEST, width, 2)).astype(np.float32)
    xreq = torch.from_numpy(req).to(dev)
    cycles = xreq.reshape(-1, CYCLE_LEN, 2)
    launched, held = {}, {}

    def note(counts, path, head=None, hidden=None):
        """Record a run's launches, and the width each extended kernel
        ran at: the head width, or the encoder's hidden width."""
        for name, n in counts.items():
            launched.setdefault(name, (path, n))
            w = hidden if name in F32_ENCODER else head
            if name in EXTENDED and w is not None:
                held.setdefault(name, set()).add(w)

    # -- W1. the study's models through the serving entry points -----------
    vq, tr = build(**WIDTH_MODEL, seed=SEED)
    vq2, _ = build(**WIDTH_VQ, seed=SEED)
    check(tr.pe.device.type == dev.type, "build() did not build on the card")
    hd = tr.d_model // tr.n_head
    log(f"widths: VQ-VAE hidden {vq.hidden_dim} ({vq.n_resblocks} "
        f"resblocks, K={vq.num_embeddings}, D={vq.embedding_dim}, encoder "
        f"tile {fenc.kernel_width(vq.hidden_dim)}); transformer "
        f"d{tr.d_model}, {tr.n_head} heads of {hd} (attention tile "
        f"{kernels.padded_head_width(hd)}), {tr.n_blocks} blocks, "
        f"T={tr.seq_len}; VQ-VAE hidden {vq2.hidden_dim} "
        f"({vq2.n_resblocks} resblocks, K={vq2.num_embeddings}, "
        f"D={vq2.embedding_dim}, encoder tile "
        f"{fenc.kernel_width(vq2.hidden_dim)})")
    for model in (vq, vq2):
        _spread_codebook(model, cycles, f"the hidden-{model.hidden_dim} "
                                        f"VQ-VAE")
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80,
                                  precision="int8", encoder_impl="fused")
    pipe.calibrate(calib)
    (labels, probs), counts = counted(lambda: pipe.classify(req))
    check(set(counts) == {ENC, ATTN, GEMM},
          f"widths classify launched {sorted(counts)}")
    note(counts, "widths classify (d192, hidden 64)", head=hd,
         hidden=vq.hidden_dim)
    with plain_path():
        labels_p, probs_p = pipe.classify(req)
    sure = np.abs(probs_p[:, 0] - probs_p[:, 1]) > LABEL_MARGIN
    check(bool(np.isfinite(probs).all())
          and bool((labels == labels_p)[sure].all()),
          f"widths classify: labels differ from the plain path's where "
          f"its margin exceeds {LABEL_MARGIN}")
    log(f"widths classify (int8, encoder_impl='fused') of {len(req)} "
        f"windows: launches {json.dumps(counts)}; labels equal the plain "
        f"path's on all {int(sure.sum())} windows with |p0 - p1| > "
        f"{LABEL_MARGIN}")
    want = {name: kernels_of for name, _, kernels_of in PATHS}
    with torch.inference_mode():
        for name in TIMED_PATHS:
            fn = make_pipeline_quantized(vq, tr, pipe.qparams,
                                         block_fusion=name)
            lk, counts = counted(lambda: fn(xreq))
            check(set(counts) == want[name],
                  f"widths path {name} launched {sorted(counts)}")
            note(counts, f"widths make_pipeline_quantized({name})",
                 head=hd, hidden=vq.hidden_dim)
            with plain_path():
                lp = fn(xreq)
            sure = (lp[:, 0] - lp[:, 1]).abs() > LABEL_MARGIN
            same = lk.argmax(-1) == lp.argmax(-1)
            check(bool(torch.isfinite(lk).all()) and bool(same[sure].all()),
                  f"widths path {name}: labels differ where the plain "
                  f"margin exceeds {LABEL_MARGIN}")
            log(f"widths path {name}: launches {json.dumps(counts)}; labels "
                f"equal the plain path's on all {int(sure.sum())} windows "
                f"whose plain |logit0-logit1| > {LABEL_MARGIN}; max "
                f"|dlogit| {float((lk - lp).abs().max()):.3e}")

        # -- W2. the encoder paths at hidden 64 and 256 -----------------------
        for model, g in ((vq, 1), (vq2, 2)):
            packed, edges = fenc.pack_encoder(model), fenc.pack_encoder_edges(
                model)
            nb, h = model.n_resblocks, model.hidden_dim
            grp = fenc.group_size_for(h)
            last = (nb - 1) // g * g
            paths = {
                "encode_indices_fused": (
                    lambda: fenc.encode_indices_fused(model, packed, cycles),
                    {ENC: -(-nb // grp)}),
                "encode_indices_fused(group_size=1)": (
                    lambda: fenc.encode_indices_fused(model, packed, cycles,
                                                      group_size=1),
                    {RES: nb}),
                f"encode_indices_fused_edges(group_size={g})": (
                    lambda: fenc.encode_indices_fused_edges(
                        model, packed, edges, cycles, group_size=g),
                    {ENTRY: 1, EXIT: 1,
                     **({ENC: len(range(g, last, g))}
                        if range(g, last, g) else {})})}
            ref = model.encode_indices(cycles).reshape(-1)
            z = model.encode(cycles).reshape(-1, model.embedding_dim)
            for name, (run, expect) in paths.items():
                ids, counts = counted(run)
                check(counts == expect, f"widths {name} at hidden {h} "
                                        f"launched {json.dumps(counts)}, "
                                        f"expected {json.dumps(expect)}")
                note(counts, f"widths {name} (hidden {h})", hidden=h)
                ids = ids.reshape(-1)
                flips = flip_rate(ids, ref)
                gap = worst_flip_gap(z, model.codebook, ids, ref)
                check(flips <= MAX_ID_FLIP and gap <= MAX_FLIP_GAP,
                      f"widths {name} at hidden {h}: id flips {flips}, "
                      f"worst gap {gap}")
                log(f"widths encoder path {name} at hidden {h}: launches "
                    f"{json.dumps(counts)}; id flips against "
                    f"vq.encode_indices {flips:.3e} (bound {MAX_ID_FLIP}), "
                    f"worst flip gap {gap:.3e} (bound {MAX_FLIP_GAP})")

    # -- W3. generate_kv(decode_impl='fused') on forced sequences -----------
    bs, steps = WIDTH_SAMPLE
    start = torch.full((bs, 1), pipe.start_token, dtype=torch.int32,
                       device=dev)
    ids = tr.generate_kv(start, num_steps=steps)

    def forced(run):
        seen = []

        def draw(last, *_args, **_kw):
            seen.append(last.float().clone())
            return ids[:, len(seen)]

        with mock.patch.object(tr, "_sample_from_logits", draw):
            out, counts = counted(run)
        check(len(seen) == steps, f"forced run drew {len(seen)} times")
        return torch.stack(seen), counts

    plain, _ = forced(lambda: tr.generate_kv(start, num_steps=steps))
    got, counts = forced(lambda: tr.generate_kv(start, num_steps=steps,
                                                decode_impl="fused"))
    check(counts == {DEC_BLOCK: tr.n_blocks * steps},
          f"widths generate_kv fused launched {json.dumps(counts)}")
    note(counts, "widths generate_kv(decode_impl='fused') (d192)", head=hd)
    worst = float((got - plain).abs().max())
    check(worst <= MAX_STEP_ERR, f"widths generate_kv fused: forced step "
                                 f"logits within {worst} of plain")
    log(f"widths generate_kv(decode_impl='fused') d{tr.d_model}, batch "
        f"{bs}, {steps} forced steps: launches {json.dumps(counts)}; step "
        f"logits within {worst:.3e} of the plain step's (bound "
        f"{MAX_STEP_ERR})")

    # -- W4. a training step with attention_impl='pallas' --------------------
    _, trp = build(**WIDTH_MODEL, seed=SEED, attention_impl="pallas")
    trp.requires_grad_(True)
    trp.res_dropout = trp.att_dropout = 0.0
    b, t = WIDTH_TRAIN_BATCH, trp.seq_len
    batch = (torch.randint(0, trp.n_classes, (b, t), generator=gen),
             torch.randint(0, 2, (b,), generator=gen),
             torch.randint(0, trp.n_classes, (b, t), generator=gen))
    batch = tuple(a.to(dev) for a in batch)
    with tf32_flags(**TORCH_DEFAULT_TF32):
        # checks #9's launches: one a block
        one_step_against_plain(f"widths d{trp.d_model} transformer gen",
                               trp, TransformerGenTask(trp), batch, FLASH,
                               trp.n_blocks, smi)
    note({FLASH: trp.n_blocks},
         "widths training step (d192, attention_impl='pallas')", head=hd)
    trp.requires_grad_(False)

    # -- W5. every extended kernel at each width, against plain -------------
    worst_of = Worst()
    fns, bounds, tiles = {}, {}, {}
    ids_bt = torch.randint(0, tr.n_classes, (WIDTH_BATCH, tr.seq_len),
                           generator=gen).to(dev)
    with torch.inference_mode():
        for c, nh in WIDTH_HEADS:
            w = c // nh
            tile = kernels.padded_head_width(w)
            vq_w, tr_w = build(d_model=c, n_heads=nh, n_blocks=1,
                               hidden=64, n_res=1, k=WIDTH_MODEL["k"],
                               d=WIDTH_MODEL["d"], seed=SEED)
            pipe_w = WeldingQualityPipeline(vq_w, tr_w, n_cycles=N_CYCLES,
                                            precision="int8")
            pipe_w.calibrate(calib[:2])
            blk_q = pipe_w.qparams["blocks"][0]
            scales, vc, v3c, v4c = fbq.packed_operands(blk_q)
            wq, wp, wf, wm = (blk_q[n].w_int8 for n in
                              ("c_attn", "c_proj", "c_fc", "m_proj"))
            x = tr_w.embed(ids_bt).contiguous()
            bt, t = x.shape[:2]
            # #2 and #6, f32 and int8 attention; the f32 qkv of #2's run
            # feeds #9 and #11
            scratch = {}
            for int8_attn in (False, True):
                a_name, f_name = (ATTN8, FULL8) if int8_attn else (ATTN, FULL)
                (xm, h8), counts = counted(lambda: fbq.attn_block_quant(
                    x, wq, wp, scales, vc[:6], v3c, n_head=nh,
                    int8_attn=int8_attn, scratch=scratch))
                xm_p, h8_p = fbq.fused_attn_block_quant_reference(
                    x, wq, wp, scales, vc[:6], v3c, n_head=nh,
                    int8_attn=int8_attn)
                worst_of.f32(f"{a_name}.end.x_mid", xm, xm_p)
                worst_of.int8(f"{a_name}.end.h8", h8, h8_p)
                note(counts, f"widths kernels (C={c}, {nh} heads)", head=w)
                fns[a_name, w] = (
                    lambda i=int8_attn, x=x, a=(wq, wp, scales, vc[:6], v3c),
                    nh=nh: fbq.attn_block_quant(x, *a, n_head=nh,
                                                int8_attn=i),
                    lambda i=int8_attn, x=x, a=(wq, wp, scales, vc[:6], v3c),
                    nh=nh: fbq.fused_attn_block_quant_reference(
                        x, *a, n_head=nh, int8_attn=i))
                # stage by stage, as section 7 holds #6: an int8 step
                # upstream carries into every f32 value after it
                full = {}
                out, counts = counted(lambda: fbq.block_quant(
                    x, wq, wp, wf, wm, scales, vc, v3c, v4c, n_head=nh,
                    int8_attn=int8_attn, scratch=full))
                worst_of.f32(f"{f_name}.x_mid", full["x_mid"], xm_p)
                worst_of.int8(f"{f_name}.h8", full["h8"], h8_p)
                worst_of.f32(f"{f_name}.end.out", out, full["x_mid"]
                             + mlp_from_h8_reference(full["h8"], wf, wm,
                                                     scales[3], v4c, vc[6:]))
                note(counts, f"widths kernels (C={c}, {nh} heads)", head=w)
                args = (x, wq, wp, wf, wm, scales, vc, v3c, v4c)
                fns[f_name, w] = (
                    lambda i=int8_attn, a=args, nh=nh: fbq.block_quant(
                        *a, n_head=nh, int8_attn=i),
                    lambda i=int8_attn, a=args, nh=nh:
                    fbq.fused_block_quant_reference(*a, n_head=nh,
                                                    int8_attn=i))
                if not int8_attn:
                    qkv = scratch["qkv"].clone()
            h = layer_norm(x, vc[0], vc[1])
            for name, kfn, pfn, a in (
                    (QKV, fattn.qkv_attention_quant,
                     fattn.qkv_attention_quant_reference,
                     (h, wq, scales[:2], v3c)),
                    (CAUSAL, fattn.fused_causal_attention_quant,
                     fattn.causal_attention_quant_reference,
                     (qkv, scales[1]))):
                y8, counts = counted(lambda: kfn(*a, n_head=nh))
                worst_of.int8(f"{name}.y8", y8, pfn(*a, n_head=nh))
                note(counts, f"widths kernels (C={c}, {nh} heads)", head=w)
                fns[name, w] = (lambda kfn=kfn, a=a, nh=nh: kfn(*a, n_head=nh),
                                lambda pfn=pfn, a=a, nh=nh: pfn(*a,
                                                                n_head=nh))
            q, k, v = (split_heads(z, nh) for z in qkv.split(c, dim=-1))
            o, counts = counted(lambda: fflash.flash_attention_forward(
                q, k, v))
            e = float((o - fflash.flash_causal_attention_reference(
                q, k, v)).abs().max())
            check(e <= MAX_ROW_ERR, f"widths {FLASH} at head {w}: {e}")
            worst_of.free[f"{FLASH}.out"] = max(
                worst_of.free.get(f"{FLASH}.out", 0.0), e)
            note(counts, f"widths kernels (C={c}, {nh} heads)", head=w)
            fns[FLASH, w] = (
                lambda q=q, k=k, v=v: fflash.flash_attention_forward(q, k, v),
                lambda q=q, k=k, v=v:
                fflash.flash_causal_attention_reference(q, k, v))
            # #12 and #13 on random caches at three positions
            blk = tr_w.blocks[0]
            db, tc = SAMPLE_BATCH, tr_w.seq_len
            xt = torch.randn(db, 1, c, generator=gen).to(dev)
            for name, kfn, pfn, shape, row in (
                    (DEC_ATTN, fdec.fused_decode_attn,
                     fdec.fused_decode_attn_reference, (db, nh, tc, w),
                     lambda z, p: z[:, :, p]),
                    (DEC_BLOCK, fdec.fused_block_decode,
                     fdec.fused_block_decode_reference, (db, tc, c),
                     lambda z, p: z[:, p])):
                kv = [torch.randn(*shape, generator=gen).to(dev)
                      for _ in range(2)]
                for pos in (0, 127, tc - 1):
                    kk, kv_ = (z.clone() for z in kv)
                    pk, pv = (z.clone() for z in kv)
                    out, counts = counted(lambda: kfn(xt, blk, kk, kv_, pos,
                                                      n_head=nh)[0])
                    ref = pfn(xt, blk, pk, pv, pos, n_head=nh)[0]
                    e = float((out - ref).abs().max())
                    er = max(float((row(a, pos) - row(r, pos)).abs().max())
                             for a, r in ((kk, pk), (kv_, pv)))
                    check(e <= MAX_DECODE_ERR and er <= MAX_ROW_ERR,
                          f"widths {name} at head {w} pos {pos}: output "
                          f"{e}, written row {er}")
                    worst_of.free[f"{name}.out"] = max(
                        worst_of.free.get(f"{name}.out", 0.0), e)
                    note(counts, f"widths kernels (C={c}, {nh} heads)", head=w)
                pos = tc // 2
                fns[name, w] = (
                    lambda kfn=kfn, a=(xt, blk, *kv, pos), nh=nh:
                    kfn(*a, n_head=nh),
                    lambda pfn=pfn, a=(xt, blk, *kv, pos), nh=nh:
                    pfn(*a, n_head=nh))
            tiles.update({(name, w): tile for name in
                          (ATTN, ATTN8, FULL, FULL8, QKV, CAUSAL, FLASH,
                           DEC_ATTN, DEC_BLOCK)})
            # (the encoder's terms of this call are not read)
            work = kernel_work(len(cycles), c, 1, 1, vq_w.patch_size, 8, 32,
                               bt, t, nh, db, pos)
            for name in (ATTN, ATTN8, FULL, FULL8, QKV, CAUSAL, FLASH,
                         DEC_ATTN, DEC_BLOCK):
                bounds[name, w] = bound_of(work[name])

        # the f32 encoder kernels at WIDTH_HIDDEN, with BatchNorm rows
        for hw in WIDTH_HIDDEN:
            vq_h, _ = build(hidden=hw, n_res=2, d_model=64, n_heads=1,
                            n_blocks=1, seed=SEED)
            _spread_codebook(vq_h, cycles, f"the hidden-{hw} VQ-VAE")
            packed = fenc.pack_encoder(vq_h)
            weights, _ = packed
            split = packed.split
            vecs = _random_bn(packed[1], gen)
            w_pe, b_pe, w_sep, b_sep = fenc.pack_encoder_edges(vq_h)
            cb = vq_h.codebook
            flat = vq_h.patch_embed_out(cycles)
            flat = flat.reshape(-1, hw).contiguous()
            patches = patchify(cycles, vq_h.patch_size).reshape(
                -1, vq_h.patch_size).contiguous()
            for name, kfn, pfn, a, kw in (
                    (ENC, fenc.fused_encoder_eval,
                     fenc.fused_encoder_eval_reference,
                     (flat, weights, vecs), {"split": split}),
                    (RES, fenc.resblock_eval,
                     fenc.fused_resblock_eval_reference,
                     (flat, weights[0], weights[1], vecs[:10]),
                     {"split": split[:2]}),
                    (ENTRY, fenc.fused_encoder_entry_eval,
                     fenc.fused_encoder_entry_eval_reference,
                     (patches, w_pe, b_pe, weights, vecs), {"split": split}),
                    (EXIT, fenc.fused_encoder_exit_eval,
                     fenc.fused_encoder_exit_eval_reference,
                     (flat, weights, vecs, w_sep, b_sep, cb),
                     {"split": split})):
                got, counts = counted(lambda: kfn(*a, use_bn=True, **kw))
                ref = pfn(*a, use_bn=True)
                note(counts, f"widths kernels (hidden {hw})", hidden=hw)
                if name == EXIT:
                    zz = fenc.fused_encoder_eval_reference(
                        flat, weights, vecs, use_bn=True) @ w_sep + b_sep
                    flips = flip_rate(got, ref)
                    gap = worst_flip_gap(zz, cb, got, ref)
                    check(flips <= MAX_ID_FLIP and gap <= MAX_FLIP_GAP,
                          f"widths {EXIT} at hidden {hw}: flips {flips}, "
                          f"gap {gap}")
                    worst_of.free[f"{EXIT}.ids"] = max(
                        worst_of.free.get(f"{EXIT}.ids", 0.0), flips)
                else:
                    rel = float((got - ref).abs().max() / ref.abs().max())
                    check(rel <= MAX_CHAIN_REL,
                          f"widths {name} at hidden {hw}: {rel} of the "
                          f"output's magnitude")
                    worst_of.free[f"{name}.out"] = max(
                        worst_of.free.get(f"{name}.out", 0.0), rel)
                fns[name, hw] = (
                    lambda kfn=kfn, a=a, kw=kw: kfn(*a, use_bn=True, **kw),
                    lambda pfn=pfn, a=a: pfn(*a, use_bn=True))
                tiles[name, hw] = fenc.kernel_width(hw)
            # (the transformer's terms of this call are not read)
            work = kernel_work(len(flat), hw, 2, 2, vq_h.patch_size,
                               vq_h.embedding_dim, vq_h.num_embeddings,
                               WIDTH_BATCH, tr.seq_len, 1, 1, 1)
            for name in (ENC, RES, ENTRY, EXIT):
                bounds[name, hw] = bound_of(work[name])
        worst_of.check()

        # times: kernel and plain in turns (CUDA events around a call);
        # the kernels' own pace, ten calls in a row between two events
        # (the host's launch hidden behind the card's work); and their
        # device time from torch.profiler on cold operands, whose short
        # sessions can lose events at these sizes
        kfns = {key: pair[0] for key, pair in fns.items()}
        rows = in_a_row(kfns)
        traced = kernel_trace(kfns)
        for (name, w), (kfn, pfn) in fns.items():
            t_k = timed_in_turns({"kernel": kfn, "plain": pfn},
                                 reps=WIDTH_REPS, warmup=1)
            bound, by = bounds[name, w]
            row_ms, ms = rows[name, w][0], traced[name, w][0]
            what = "hidden" if name in F32_ENCODER else "head"
            log(f"widths kernel {name} at {what} {w} (tile "
                f"{tiles[name, w]}): {fmt_ms(t_k['kernel'])}, plain "
                f"{fmt_ms(t_k['plain'])}; 10 in a row {row_ms:.4f} ms a "
                f"call; device "
                + ("not measured" if ms is None else f"{ms:.4f} ms a call")
                + f"; bound {bound:.4f} ms by {by} ({bound / row_ms:.1%} of "
                f"the in-a-row time); gpu {smi}")
    for key, err in sorted({**worst_of.err, **worst_of.free}.items()):
        log(f"widths {key}: worst difference from plain {err:.3e}")
    for key, frac in sorted(worst_of.frac.items()):
        log(f"widths {key}: int8 entries that differ {frac:.3e}, largest "
            f"step {worst_of.step[key]}")
    log(f"widths phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launched": launched,
            "widths": {name: sorted(ws) for name, ws in held.items()}}


# -- every VQ-VAE the VQ-VAE CLI can build ------------------------------------

def _shape_operands(c: int, n_blocks: int, gen, dev):
    """Random resblock weights (2n, c, c) at the encoder's init spread and
    vector rows (10n, c) with eval BN rows, on the card."""
    import torch
    bound = (6.0 / (2 * c * 3)) ** 0.5
    w = (torch.rand(2 * n_blocks, c, c, generator=gen) * 2 - 1) * bound
    v = torch.zeros(n_blocks, 2, 5, c)
    v[:, :, 0] = torch.randn(n_blocks, 2, c, generator=gen) * 0.1
    return w.to(dev), _random_bn(v.reshape(10 * n_blocks, c).to(dev), gen)


def shapes_phase(smi: str, device: str = "cuda") -> dict:
    """A VQ-VAE at the VQ-VAE CLI's --hidden-dim 1024 --num-embeddings
    1024 --embedding-dim 64 (see the module docstring), trained one epoch
    through the CLI's main and served in int8 with a transformer from
    the seed through classify, the edges encoder and the bf16 encoder,
    each against its plain path; one vq_impl='pallas' training step at
    those widths against plain; then every kernel this slice widened
    against its plain version at the grid of SHAPES_HIDDEN,
    SHAPES_CODEBOOKS and SHAPES_BF16, timed in turns with it beside its
    bound. Returns {"launched": {kernel: (path, launches)}, "held":
    {kernel: [shapes]}, and for the encoder_wide.cu kernels "times",
    "work", "err" (and "flips" of the exit's ids) at the served model's
    shape}."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.cli import (
        train_reconstruction_embedding)
    from vq_vae_transformer_arc_welding_tpu_torch.data import (
        ASIMoWDataModule, get_val_test_ids, synthetic)
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.models import (
        TransformerDecoder, VQVAEPatch)
    from vq_vae_transformer_arc_welding_tpu_torch.models.quantized import (
        quantized_classify)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_encoder as fenc, fused_vq as fvq)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.patching import patchify
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline, with_start_token)
    from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
        ReconstructionTask)

    t_phase = time.perf_counter()
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(SEED + 2)
    bf = torch.bfloat16
    out = {"launched": {}, "held": {}, "times": {}, "work": {}, "err": {},
           "flips": {}}

    def note(counts, path, shape=None):
        for name, n in counts.items():
            out["launched"].setdefault(name, (path, n))
            if shape is not None:
                out["held"].setdefault(name, [])
                if shape not in out["held"][name]:
                    out["held"][name].append(shape)

    def labels_hold(what, got, plain):
        """Labels of logits `got` equal plain's outside the margin."""
        sure = (plain[:, 0] - plain[:, 1]).abs() > LABEL_MARGIN
        same = got.argmax(-1) == plain.argmax(-1)
        check(bool(torch.isfinite(got).all()) and bool(same[sure].all()),
              f"shapes {what}: labels differ from the plain path's on "
              f"{int((~same)[sure].sum())} windows outside the margin")
        return int(sure.sum())

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # -- S1. the VQ-VAE CLI at the flags ------------------------------
            data_dir = os.path.join(tmp, "data")
            csv_path = os.path.join(data_dir, "processed_asimow_dataset.csv")
            synthetic.write_synthetic_csv(csv_path, seed=SEED, **CLI_CSV)
            args = train_reconstruction_embedding.build_parser().parse_args(
                SHAPES_CLI_ARGS + ["--data-dir", data_dir, "--device", device])
            secs = host_seconds(
                lambda: train_reconstruction_embedding.main(args))
            vq_best = os.path.join(tmp, "model_checkpoints", "VQ-VAE-Patch",
                                   "VQ-VAE-Patch-best.ckpt")
            check(os.path.exists(vq_best),
                  "shapes: the VQ-VAE CLI wrote no best checkpoint")
            vq = VQVAEPatch.load(vq_best, device=dev).eval()
            c, k, d = vq.hidden_dim, vq.num_embeddings, vq.embedding_dim
            check((c, k, d, vq.n_resblocks, vq.patch_size)
                  == (1024, 1024, 64, 8, 25),
                  f"shapes: the CLI built hidden {c}, K={k}, D={d}")
            log(f"shapes: VQ-VAE CLI main({' '.join(SHAPES_CLI_ARGS)}) in "
                f"{secs:.2f} s wall: hidden {c}, {vq.n_resblocks} resblocks, "
                f"K={k}, D={d}, patch {vq.patch_size}; gpu {smi}")
            ids_split = get_val_test_ids()
            dm = ASIMoWDataModule(task="reconstruction", n_cycles=1,
                                  val_data_ids=ids_split["val_ids"],
                                  test_data_ids=ids_split["test_ids"],
                                  batch_size=SHAPES_TRAIN_BATCH,
                                  data_directory_path=data_dir)
            dm.setup()
            # the request: consecutive scaled cycles of the three splits
            # (1,280 cycles each), 20 a window
            n_win = SHAPES_REQUEST
            cyc = np.concatenate([dm.train.x, dm.val.x, dm.test.x])[
                :n_win * N_CYCLES]
            check(len(cyc) == n_win * N_CYCLES, "shapes: too few cycles")
            x = torch.from_numpy(np.ascontiguousarray(cyc).reshape(
                n_win, N_CYCLES * CYCLE_LEN, 2)).to(dev)
            cycles = x.reshape(-1, CYCLE_LEN, 2)
            # -- S2. served in int8 with a transformer from the seed -------
            tr = TransformerDecoder(
                **SHAPES_TR, n_classes=k + 2, seq_len=N_CYCLES
                * vq.enc_out_len + 1,
                generator=torch.Generator().manual_seed(SEED), device=dev)
            tr_ckpt = os.path.join(tmp, "transformer.ckpt")
            tr.save(tr_ckpt)
            pipe = WeldingQualityPipeline.from_checkpoints(
                vq_best, tr_ckpt, n_cycles=N_CYCLES, max_batch=n_win,
                precision="int8", encoder_impl="fused", device=device)
            pipe.calibrate(x[:N_CALIB].cpu().numpy())
            vq, tr, qp = pipe.vq_model, pipe.tr_model, pipe.qparams
            xn = x.cpu().numpy()
            (labels, probs), counts = counted(lambda: pipe.classify(xn))
            check(set(counts) == {WIDE, ATTN, GEMM}
                  and counts[WIDE] == vq.n_resblocks,
                  f"shapes classify launched {json.dumps(counts)}")
            note(counts, "shapes classify (hidden 1024, K=1024, D=64)")
            with plain_path():
                labels_p, probs_p = pipe.classify(xn)
            sure = np.abs(probs_p[:, 0] - probs_p[:, 1]) > LABEL_MARGIN
            check(bool(np.isfinite(probs).all())
                  and bool((labels == labels_p)[sure].all()),
                  "shapes classify: labels differ from the plain path's "
                  "outside the margin")
            t = timed_in_turns({"kernel": lambda: pipe.classify(xn),
                                "plain": on_plain_path(
                                    lambda: pipe.classify(xn))},
                               reps=SHAPES_REPS, warmup=1)
            log(f"shapes classify (int8, encoder_impl='fused') of {n_win} "
                f"windows: launches {json.dumps(counts)}; labels equal the "
                f"plain path's on all {int(sure.sum())} windows with |p0 - "
                f"p1| > {LABEL_MARGIN}; {fmt_ms(t['kernel'])} a call, "
                f"{n_win / t['kernel'][0] * 1e3:.1f} windows/s (plain "
                f"{fmt_ms(t['plain'])}, {n_win / t['plain'][0] * 1e3:.1f} "
                f"windows/s); gpu {smi}")
            with torch.inference_mode():
                packed = fenc.pack_encoder(vq)
                edges = fenc.pack_encoder_edges(vq)
                exact = vq.encode_indices(cycles).reshape(-1)
                z = vq.encode(cycles).reshape(-1, d)
                check(packed.split is None and fenc.group_size_for(c) == 1,
                      "shapes: the pack or the group rule")
                grouped, counts = counted(lambda: fenc.encode_indices_fused(
                    vq, packed, cycles))
                check(counts == {WIDE: vq.n_resblocks},
                      f"shapes encode_indices_fused launched "
                      f"{json.dumps(counts)}")
                edged, counts = counted(
                    lambda: fenc.encode_indices_fused_edges(
                        vq, packed, edges, cycles))
                want = {WIDE_ENTRY: 1, WIDE: vq.n_resblocks - 2,
                        WIDE_EXIT: 1}
                check(counts == want, f"shapes encode_indices_fused_edges "
                                      f"launched {json.dumps(counts)}")
                note(counts, "shapes encode_indices_fused_edges "
                             "(hidden 1024)")
                for name, ids in (("encode_indices_fused", grouped),
                                  ("encode_indices_fused_edges", edged)):
                    flips = flip_rate(ids.reshape(-1), exact)
                    gap = worst_flip_gap(z, vq.codebook, ids.reshape(-1),
                                         exact)
                    check(flips <= MAX_ID_FLIP and gap <= MAX_FLIP_GAP,
                          f"shapes {name}: id flips {flips}, gap {gap}")
                    log(f"shapes {name} at hidden {c}: id flips against "
                        f"vq.encode_indices {flips:.3e} (bound "
                        f"{MAX_ID_FLIP}), worst flip gap {gap:.3e} (bound "
                        f"{MAX_FLIP_GAP})")
                # the edges encoder into the int8 transformer
                def edges_classify(x_):
                    ids_ = fenc.encode_indices_fused_edges(
                        vq, packed, edges, x_.reshape(-1, CYCLE_LEN, 2))
                    return quantized_classify(
                        tr, qp, with_start_token(ids_.reshape(len(x_), -1),
                                                 k), block_fusion="attn")
                le, counts = counted(lambda: edges_classify(x))
                check(set(counts) == {WIDE_ENTRY, WIDE, WIDE_EXIT, ATTN,
                                      GEMM},
                      f"shapes edges + 'attn' launched {json.dumps(counts)}")
                with plain_path():
                    lp = edges_classify(x)
                n_sure = labels_hold("edges + 'attn'", le, lp)
                log(f"shapes encode_indices_fused_edges + 'attn': launches "
                    f"{json.dumps(counts)}; labels equal the plain path's "
                    f"on all {n_sure} windows whose |logit0-logit1| > "
                    f"{LABEL_MARGIN}")
                # the bf16 encoder (1b off 512: encoder_wide_bf16)
                fn_bf = make_pipeline_quantized(vq, tr, qp, encoder_dtype=bf)
                lb, counts = counted(lambda: fn_bf(x))
                grp_bf = fenc.group_size_for(c, 2)
                check(set(counts) == {WIDE_BF16, ATTN, GEMM}
                      and counts[WIDE_BF16] == -(-vq.n_resblocks // grp_bf),
                      f"shapes make_pipeline_quantized(encoder_dtype=bf16) "
                      f"launched {json.dumps(counts)}")
                note(counts, "shapes make_pipeline_quantized("
                             "encoder_dtype=torch.bfloat16) (hidden 1024)")
                lbp = on_plain_path(lambda: fn_bf(x))()
                n_sure = labels_hold("encoder_dtype=bf16", lb, lbp)
                packed_bf = fenc.pack_encoder(vq, bf)
                ids_bf = fenc.encode_indices_fused(
                    vq, packed_bf, cycles, compute_dtype=bf).reshape(-1)
                with plain_path():
                    ids_bfp = fenc.encode_indices_fused(
                        vq, packed_bf, cycles, compute_dtype=bf).reshape(-1)
                h = vq.patch_embed_out(cycles)
                z_bf = vq.sep_conv(fenc.fused_encoder_eval_reference(
                    h.reshape(-1, c), *packed_bf, use_bn=vq.batch_norm,
                    compute_dtype=bf).reshape(h.shape)).reshape(-1, d)
                f_bf = flip_rate(ids_bf, ids_bfp)
                g_bf = worst_flip_gap(z_bf, vq.codebook, ids_bf, ids_bfp)
                check(f_bf <= MAX_BF16_ID_FLIP and g_bf <= MAX_BF16_FLIP_GAP,
                      f"shapes bf16 encoder: ids differ from the plain bf16 "
                      f"path's in {f_bf}, worst gap {g_bf}")
                log(f"shapes make_pipeline_quantized(encoder_dtype=bf16): "
                    f"launches {json.dumps(counts)}; labels equal its plain "
                    f"path's on all {n_sure} windows outside the margin; "
                    f"ids against the plain bf16 path {f_bf:.3e} (bound "
                    f"{MAX_BF16_ID_FLIP}), worst gap {g_bf:.3e} (bound "
                    f"{MAX_BF16_FLIP_GAP}); gpu {smi}")

            # -- S3. one training step on #7 at those widths ----------------
            with tf32_flags(**TORCH_DEFAULT_TF32):
                vq_t = VQVAEPatch.load(vq_best, device=dev, vq_impl="pallas")
                vq_t.dropout_p = 0.0
                vq_t.requires_grad_(True)
                batch = (torch.from_numpy(
                    dm.train.x[:SHAPES_TRAIN_BATCH]).to(dev),)
                ids_of, _, _ = one_step_against_plain(
                    f"shapes VQ-VAE (hidden {c}, K={k}, D={d})", vq_t,
                    ReconstructionTask(vq_t), batch, NEAREST, 1, smi)
                flips = int((ids_of["kernel"] != ids_of["plain"]).sum())
                check(flips == 0, f"shapes training step: {flips} ids "
                                  f"differ from the plain path's")
                note({NEAREST: 1}, "shapes vq_impl='pallas' training step "
                                   "(K=1024, D=64)", (k, d))
                del vq_t
        finally:
            os.chdir(cwd)

    # -- S4. every widened kernel against plain at the grid -----------------
    fns, bounds, errs = {}, {}, {}
    n = SHAPES_ROWS
    with torch.inference_mode():
        for hw in SHAPES_HIDDEN:
            w, v = _shape_operands(hw, 2, gen, dev)
            xr = torch.randn(n, hw, generator=gen).to(dev)
            patches = torch.randn(n, 25, generator=gen).to(dev)
            w_pe = ((torch.rand(25, hw, generator=gen) * 2 - 1) * 0.1).to(dev)
            b_pe = (torch.randn(hw, generator=gen) * 0.1).to(dev)
            w_sep = ((torch.rand(hw, 64, generator=gen) * 2 - 1)
                     * 0.1).to(dev)
            b_sep = (torch.randn(64, generator=gen) * 0.1).to(dev)
            zz = fenc.fused_encoder_eval_reference(xr, w, v, use_bn=True) \
                @ w_sep + b_sep
            cb = zz.mean(0) + torch.randn(1024, 64, generator=gen).to(dev) \
                * zz.std(0)
            kw = ({"split": fenc.split_weights(w)} if fenc.on_tile(hw)
                  else {})
            kw1 = {"split": kw["split"][:2]} if kw else {}
            for base, kfn, pfn, a, kwa in (
                    (ENC, fenc.fused_encoder_eval,
                     fenc.fused_encoder_eval_reference, (xr, w, v), kw),
                    (RES, fenc.resblock_eval,
                     fenc.fused_resblock_eval_reference,
                     (xr, w[0], w[1], v[:10]), kw1),
                    (ENTRY, fenc.fused_encoder_entry_eval,
                     fenc.fused_encoder_entry_eval_reference,
                     (patches, w_pe, b_pe, w, v), kw),
                    (EXIT, fenc.fused_encoder_exit_eval,
                     fenc.fused_encoder_exit_eval_reference,
                     (xr, w, v, w_sep, b_sep, cb), kw)):
                name = base if fenc.on_tile(hw) else WIDE_OF[base]
                got, counts = counted(lambda: kfn(*a, use_bn=True, **kwa))
                ref = pfn(*a, use_bn=True)
                check(counts == {name: 1}, f"shapes {base} at hidden {hw} "
                                           f"launched {json.dumps(counts)}")
                note(counts, f"shapes kernels (hidden {hw})", hw)
                if base == EXIT:
                    flips = flip_rate(got, ref)
                    gap = worst_flip_gap(zz, cb, got, ref)
                    check(flips <= MAX_ID_FLIP and gap <= MAX_FLIP_GAP,
                          f"shapes {name} at hidden {hw}: flips {flips}, "
                          f"gap {gap}")
                    err = flips
                else:
                    err = float((got - ref).abs().max() / ref.abs().max())
                    check(err <= MAX_CHAIN_REL, f"shapes {name} at hidden "
                                                f"{hw}: {err} of the output's "
                                                f"magnitude")
                key = (name, f"hidden {hw}" + (" (#3)" if base == RES else ""))
                errs[key] = err
                fns[key] = (lambda kfn=kfn, a=a, kwa=kwa:
                            kfn(*a, use_bn=True, **kwa),
                            lambda pfn=pfn, a=a: pfn(*a, use_bn=True))
                work = kernel_work(n, hw, 1 if base == RES else 2, 2, 25, 64,
                                   1024, 1, 1, 1, 1, 1)
                bounds[key] = bound_of(work[name if base != RES else
                                            (RES if fenc.on_tile(hw)
                                             else WIDE)])
            del w, v, xr, zz
        # #7 and #5 at each (K, D): #5 on the tile (hidden 512) and on
        # encoder_wide.cu (hidden 1024), one resblock
        for hw in (512, 1024):
            w, v = _shape_operands(hw, 1, gen, dev)
            xr = torch.randn(n, hw, generator=gen).to(dev)
            for kk, dd in SHAPES_CODEBOOKS:
                w_sep = ((torch.rand(hw, dd, generator=gen) * 2 - 1)
                         * 0.1).to(dev)
                b_sep = (torch.randn(dd, generator=gen) * 0.1).to(dev)
                zz = fenc.fused_encoder_eval_reference(
                    xr, w, v, use_bn=True) @ w_sep + b_sep
                cb = zz.mean(0) + torch.randn(kk, dd, generator=gen).to(
                    dev) * zz.std(0)
                name = EXIT if fenc.on_tile(hw) else WIDE_EXIT
                kw = ({"split": fenc.split_weights(w)} if fenc.on_tile(hw)
                      else {})
                a = (xr, w, v, w_sep, b_sep, cb)
                cases = [(name, fenc.fused_encoder_exit_eval,
                          fenc.fused_encoder_exit_eval_reference, a, kw,
                          lambda zz=zz, cb=cb: (zz, cb))]
                if hw == 512:     # #7 on the same z and codebook
                    zc = zz.contiguous()
                    cases.append((NEAREST, lambda z_, c_, use_bn:
                                  fvq.nearest_codes_pallas(z_, c_),
                                  lambda z_, c_, use_bn:
                                  fvq.nearest_codes_pallas_reference(z_, c_),
                                  (zc, cb), {}, lambda zc=zc, cb=cb: (zc, cb)))
                for nm, kfn, pfn, args, kwa, zcb in cases:
                    got, counts = counted(lambda: kfn(*args, use_bn=True,
                                                      **kwa))
                    ref = pfn(*args, use_bn=True)
                    check(counts == {nm: 1}, f"shapes {nm} at ({kk}, {dd}) "
                                             f"launched {json.dumps(counts)}")
                    note(counts, f"shapes kernels (K={kk}, D={dd})",
                         (kk, dd))
                    flips = flip_rate(got, ref)
                    gap = worst_flip_gap(*zcb(), got, ref)
                    check(flips <= MAX_ID_FLIP and gap <= MAX_FLIP_GAP,
                          f"shapes {nm} at ({kk}, {dd}): flips {flips}, "
                          f"gap {gap}")
                    key = (nm, f"K={kk}, D={dd}"
                           + (f", hidden {hw}" if nm != NEAREST else ""))
                    errs[key] = flips
                    fns[key] = (lambda kfn=kfn, a=args, kwa=kwa:
                                kfn(*a, use_bn=True, **kwa),
                                lambda pfn=pfn, a=args: pfn(*a, use_bn=True))
                    work = kernel_work(n, hw, 1, 1, 25, dd, kk, 1, 1, 1, 1, 1)
                    bounds[key] = bound_of(work[nm])
            del w, v, xr
        # 1b off hidden 512, each resblock fed the plain stream and the
        # two in one launch
        for hw in SHAPES_BF16:
            w, v = _shape_operands(hw, 2, gen, dev)
            wb = w.to(bf)
            xr = torch.randn(n, hw, generator=gen).to(dev)
            xi, worst = xr, 0.0
            for i in range(2):
                wi, vi = wb[2 * i:2 * i + 2], v[10 * i:10 * i + 10]
                yk, counts = counted(lambda: fenc.fused_encoder_eval(
                    xi, wi, vi, use_bn=True, compute_dtype=bf))
                yp = fenc.fused_encoder_eval_reference(
                    xi, wi, vi, use_bn=True, compute_dtype=bf)
                check(counts == {WIDE_BF16: 1},
                      f"shapes 1b at hidden {hw} launched "
                      f"{json.dumps(counts)}")
                worst = max(worst, float((yk - yp).abs().max()
                                         / yp.abs().max()))
                xi = yp
            note(counts, f"shapes kernels (bf16, hidden {hw})", hw)
            yk = fenc.fused_encoder_eval(xr, wb, v, use_bn=True,
                                         compute_dtype=bf)
            yp = fenc.fused_encoder_eval_reference(xr, wb, v, use_bn=True,
                                                   compute_dtype=bf)
            worst = max(worst, float((yk - yp).abs().max() / yp.abs().max()))
            check(worst <= MAX_BF16_BLOCK_ERR,
                  f"shapes 1b at hidden {hw}: {worst} of the output's "
                  f"magnitude")
            key = (WIDE_BF16, f"hidden {hw}")
            errs[key] = worst
            fns[key] = (lambda a=(xr, wb, v): fenc.fused_encoder_eval(
                *a, use_bn=True, compute_dtype=bf),
                lambda a=(xr, wb, v): fenc.fused_encoder_eval_reference(
                    *a, use_bn=True, compute_dtype=bf))
            bounds[key] = bound_of(kernel_work(n, hw, 2, 2, 25, 64, 1024,
                                               1, 1, 1, 1, 1)[WIDE_BF16])
        # times, in turns with the plain versions (CUDA events)
        for key, (kfn, pfn) in fns.items():
            t = timed_in_turns({"kernel": kfn, "plain": pfn},
                               reps=SHAPES_REPS, warmup=1)
            bound, by = bounds[key]
            log(f"shapes kernel {key[0]} at {key[1]} ({n} rows): "
                f"{fmt_ms(t['kernel'])}, plain {fmt_ms(t['plain'])}; bound "
                f"{bound:.4f} ms by {by} ({bound / t['kernel'][0]:.1%} of the "
                f"time taken); worst difference from plain {errs[key]:.3e}; "
                f"gpu {smi}")

        # -- S5. the encoder_wide.cu kernels at the served model's shape ----
        with torch.inference_mode():
            h = vq.patch_embed_out(cycles)
            flat = h.reshape(-1, c).contiguous()
            rows = flat.shape[0]
            weights, vecs = packed
            pz = patchify(cycles, vq.patch_size).reshape(
                -1, vq.patch_size).contiguous()
            w_pe, b_pe, w_sep, b_sep = edges
            wb = packed_bf[0]
            served = {
                WIDE: (lambda: fenc.fused_encoder_eval(
                    flat, weights[:2], vecs[:10], use_bn=False),
                    lambda: fenc.fused_encoder_eval_reference(
                        flat, weights[:2], vecs[:10], use_bn=False), 1),
                WIDE_ENTRY: (lambda: fenc.fused_encoder_entry_eval(
                    pz, w_pe, b_pe, weights[:2], vecs[:10], use_bn=False),
                    lambda: fenc.fused_encoder_entry_eval_reference(
                        pz, w_pe, b_pe, weights[:2], vecs[:10],
                        use_bn=False), 1),
                WIDE_EXIT: (lambda: fenc.fused_encoder_exit_eval(
                    flat, weights[-2:], vecs[-10:], w_sep, b_sep,
                    vq.codebook, use_bn=False),
                    lambda: fenc.fused_encoder_exit_eval_reference(
                        flat, weights[-2:], vecs[-10:], w_sep, b_sep,
                        vq.codebook, use_bn=False), 1),
                WIDE_BF16: (lambda: fenc.fused_encoder_eval(
                    flat, wb[:2 * grp_bf], vecs[:10 * grp_bf], use_bn=False,
                    compute_dtype=bf),
                    lambda: fenc.fused_encoder_eval_reference(
                        flat, wb[:2 * grp_bf], vecs[:10 * grp_bf],
                        use_bn=False, compute_dtype=bf), grp_bf)}
            for name, (kfn, pfn, grp) in served.items():
                got, ref = kfn(), pfn()
                # the ids' largest difference, as the record has it for #5
                out["err"][name] = float((got.float() - ref.float()).abs()
                                         .max())
                if name == WIDE_EXIT:
                    out["flips"][name] = flip_rate(got, ref)
                    check(out["flips"][name] <= MAX_ID_FLIP,
                          f"shapes {name} on the served model: id flips "
                          f"{out['flips'][name]}")
                out["times"][name] = timed_in_turns(
                    {"kernel": kfn, "plain": pfn}, reps=SHAPES_REPS,
                    warmup=1)
                out["work"][name] = kernel_work(
                    rows, c, grp, grp, vq.patch_size, d, k, 1, 1, 1, 1,
                    1)[name]
                bound, by = bound_of(out["work"][name])
                t = out["times"][name]
                log(f"shapes kernel {name} on the served model ({rows} x "
                    f"{c}, {grp} resblock(s) a call): {fmt_ms(t['kernel'])}, "
                    f"plain {fmt_ms(t['plain'])}; bound {bound:.4f} ms by "
                    f"{by} ({bound / t['kernel'][0]:.1%} of the time taken); "
                    f"difference from plain {out['err'][name]:.3e}; gpu {smi}")
    log(f"shapes phase: {time.perf_counter() - t_phase:.1f} s; gpu {smi}")
    return out


# -- every transformer the transformer CLI can build ----------------------

def transformer_shapes_phase(smi: str, device: str = "cuda") -> dict:
    """The transformer CLI at TSHAPES_CLI_ARGS (see the constants), its
    checkpoint scored in int8 by cli/score_quality against the plain
    path; seed models at TSHAPES_MODELS through classify and
    make_pipeline_quantized 'attn' and 'full' (TSHAPES_FUSED also
    fused_attention=True) against their plain paths; one
    attention_impl='pallas' training step at TSHAPES_TRAIN against plain;
    then every widened kernel against its plain version, timed in turns
    beside its bound: the int8 GEMM and LN+q8 at TSHAPES_C, #9 and #11 at
    TSHAPES_HEADS. Returns {"launched": {kernel: (path, launches)},
    "held": {kernel: [C or head widths]}, LN+q8's "times", "device_ms",
    "work" and "err" at TSHAPES_LN_RECORD, and "cli": the CLI model's
    pipeline, transformer, windows and their tokens}."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.cli import (
        score_quality, train_reconstruction_embedding,
        train_transformer_mtasks)
    from vq_vae_transformer_arc_welding_tpu_torch.data import (
        ASIMoWDataModule, get_val_test_ids, load_asimow_csv, synthetic)
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn as fflash, fused_attn_quant as fattn,
        fused_block_quant as fbq, int8_gemm as igemm)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        split_heads)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline, with_start_token)
    from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
        TransformerGenTask)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    t_phase = time.perf_counter()
    dev = torch.device(device)
    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator().manual_seed(SEED + 3)
    out = {"launched": {}, "held": {}}

    def note(counts, path, shape):
        """Record a run's launches, and the shape (C or head width) each
        of the transformer's kernels ran at."""
        for name, n in counts.items():
            out["launched"].setdefault(name, (path, n))
            if name != ENC:
                held = out["held"].setdefault(name, [])
                if shape not in held:
                    held.append(shape)

    def labels_hold(what, got, plain) -> int:
        """Labels of logits `got` equal plain's outside the margin."""
        sure = (plain[:, 0] - plain[:, 1]).abs() > LABEL_MARGIN
        same = got.argmax(-1) == plain.argmax(-1)
        check(bool(torch.isfinite(got).all()) and bool(same[sure].all()),
              f"transformer shapes {what}: labels differ from the plain "
              f"path's on {int((~same)[sure].sum())} windows outside the "
              f"margin")
        return int(sure.sum())

    # -- X1. the transformer CLI at d1600 / 25 heads, scored in int8 -------
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            data_dir = os.path.join(tmp, "data")
            csv_path = os.path.join(data_dir, "processed_asimow_dataset.csv")
            synthetic.write_synthetic_csv(csv_path, seed=SEED, **CLI_CSV)
            vi, _, exp, run = load_asimow_csv(csv_path)
            common = ["--data-dir", data_dir, "--device", device]
            vq_best = os.path.join(tmp, "model_checkpoints", "VQ-VAE-Patch",
                                   "VQ-VAE-Patch-best.ckpt")
            secs_vq = host_seconds(lambda: train_reconstruction_embedding.main(
                train_reconstruction_embedding.build_parser().parse_args(
                    TSHAPES_VQ_ARGS + common)))
            check(os.path.exists(vq_best),
                  "transformer shapes: the VQ-VAE CLI wrote no checkpoint")
            got = [None]
            args = train_transformer_mtasks.build_parser().parse_args(
                TSHAPES_CLI_ARGS + ["--vqvae-model", vq_best] + common)

            def train():
                got[0] = train_transformer_mtasks.main(args)

            secs_tr = host_seconds(train)
            tm_run, results = got[0]
            tr = tm_run.model
            check((tr.d_model, tr.n_head, len(tr.blocks))
                  == (args.d_model, args.n_heads, args.n_blocks)
                  and math.isfinite(results["gen_test"]["test/loss"]),
                  f"transformer shapes: the CLI built d{tr.d_model}, "
                  f"{tr.n_head} heads, {len(tr.blocks)} blocks; {results}")
            tr_ckpt = os.path.join(tmp, "transformer.ckpt")
            tr.save(tr_ckpt)
            log(f"transformer shapes: VQ-VAE CLI main("
                f"{' '.join(TSHAPES_VQ_ARGS)}) {secs_vq:.2f} s, transformer "
                f"CLI main({' '.join(TSHAPES_CLI_ARGS)}) {secs_tr:.2f} s "
                f"wall: d{tr.d_model}, {tr.n_head} heads of "
                f"{tr.d_model // tr.n_head}, {len(tr.blocks)} blocks, "
                f"T={tr.seq_len}; gen test loss "
                f"{results['gen_test']['test/loss']:.5f}; gpu {smi}")
            pipe = WeldingQualityPipeline.from_checkpoints(
                vq_best, tr_ckpt, n_cycles=N_CYCLES, max_batch=80,
                precision="int8", encoder_impl="fused", device=device)
            ids_split = get_val_test_ids()
            dm = ASIMoWDataModule(task="reconstruction", n_cycles=1,
                                  val_data_ids=ids_split["val_ids"],
                                  test_data_ids=ids_split["test_ids"],
                                  data_directory_path=data_dir)
            dm.setup()
            pipe.scaler = dm.scaler
            cyc = dm.scaler.transform(vi[:N_CALIB * N_CYCLES])
            pipe.calibrate(cyc.reshape(N_CALIB, N_CYCLES * CYCLE_LEN, 2))
            art = pipe.save_artifact(os.path.join(tmp, "artifact"))
            argv = ["--artifact", art, "--data-path", csv_path, "--stride",
                    str(TSHAPES_STRIDE), "--device", device]
            parser = score_quality.build_parser()
            kernel_out = os.path.join(tmp, "scores.csv")
            plain_out = os.path.join(tmp, "scores_plain.csv")
            secs = [0.0]

            def score():
                secs[0] = host_seconds(lambda: score_quality.main(
                    parser.parse_args(argv + ["--out", kernel_out])))

            _, counts = counted(score)
            check(set(counts) == {ENC, ATTN, GEMM},
                  f"transformer shapes: the scorer launched "
                  f"{json.dumps(counts)}, expected {ENC}, {ATTN}, {GEMM}")
            note(counts, f"transformer shapes: score_quality on the "
                         f"d{tr.d_model} CLI checkpoint", f"C={tr.d_model}")
            _, plain_counts = counted(on_plain_path(
                lambda: score_quality.main(
                    parser.parse_args(argv + ["--out", plain_out]))))
            check(plain_counts == {},
                  f"the plain scorer launched {json.dumps(plain_counts)}")
            rows, plain = read_scores(kernel_out), read_scores(plain_out)
            check(len(rows) > 0
                  and [r[:3] for r in rows] == [r[:3] for r in plain],
                  "transformer shapes: the scorer's windows differ from the "
                  "plain scorer's")
            q = np.array([[float(r[4]), float(r[5])] for r in plain])
            p = np.array([[float(r[4]), float(r[5])] for r in rows])
            margin = np.abs(np.log(np.maximum(q[:, 0], 1e-6))
                            - np.log(np.maximum(q[:, 1], 1e-6)))
            sure = margin > LABEL_MARGIN
            lab = np.array([r[3] for r in rows])
            plain_lab = np.array([r[3] for r in plain])
            check(bool(np.isfinite(p).all())
                  and bool((lab == plain_lab)[sure].all()),
                  f"transformer shapes: the scorer's labels differ from the "
                  f"plain path's on {int((lab != plain_lab)[sure].sum())} "
                  f"windows outside the {LABEL_MARGIN} logit margin")
            log(f"transformer shapes score_quality (int8) on the CLI's "
                f"checkpoint: {len(rows)} windows at --stride "
                f"{TSHAPES_STRIDE} in {secs[0]:.2f} s; launches "
                f"{json.dumps(counts)}; labels equal the plain path's on all "
                f"{int(sure.sum())} windows with a logit margin above "
                f"{LABEL_MARGIN}, worst |dp| {float(np.abs(p - q).max()):.3e};"
                f" the plain path outside the margin: "
                f"{int((plain_lab[sure] == '0').sum())} bad, "
                f"{int((plain_lab[sure] == '1').sum())} good; gpu {smi}")
            # the trained model's first block on the request's own
            # tokens, #6 held stage by stage as the main path holds it
            # (a class head that gives every window one logit leaves the
            # label gate no window to hold)
            win = cyc.reshape(N_CALIB, N_CYCLES * CYCLE_LEN, 2)
            ids = with_start_token(torch.from_numpy(pipe.encode_tokens(
                win)).to(dev), pipe.start_token)
            blk = pipe.qparams["blocks"][0]
            scales, vc, v3c, v4c = fbq.packed_operands(blk)
            w = dict(zip(("c_attn", "c_proj", "c_fc", "m_proj"),
                         fbq.packed_weights(blk)))
            worst = Worst()
            with torch.inference_mode():
                x = pipe.tr_model.embed(ids).float().contiguous()
                sc = {}
                sc["out"], counts = counted(lambda: fbq.block_quant(
                    x, w["c_attn"], w["c_proj"], w["c_fc"], w["m_proj"],
                    scales, vc, v3c, v4c, n_head=tr.n_head, scratch=sc))
                held = block_stages(worst, FULL, x, sc, w, scales, vc, v3c,
                                    v4c, tr.n_head, False)
            check(counts == {FULL: 1}, f"transformer shapes: the CLI "
                                       f"model's block 0 launched {counts}")
            worst.check()
            note(counts, f"transformer shapes: block_quant on the "
                         f"d{tr.d_model} CLI checkpoint's block 0",
                 f"C={tr.d_model}")
            log(f"transformer shapes: the d{tr.d_model} CLI checkpoint's "
                f"block 0 on #6, {N_CALIB} windows of its own tokens, "
                f"stage by stage against plain: {held}; gpu {smi}")
            # the model, held in memory, for narrow_widths_phase
            out["cli"] = {"pipe": pipe, "tr": tr, "windows": win,
                          "ids": ids}
            del pipe, tr, tm_run, got
        finally:
            os.chdir(cwd)

    # -- X2. seed models through the serving entry points ------------------
    width = N_CYCLES * CYCLE_LEN
    calib = rng.standard_normal((2, width, 2)).astype(np.float32)
    req = rng.standard_normal((WIDTH_REQUEST, width, 2)).astype(np.float32)
    xreq = torch.from_numpy(req).to(dev)
    for c, nh in TSHAPES_MODELS:
        vq, tr = build(d_model=c, n_heads=nh, n_blocks=1, hidden=64,
                       n_res=1, k=WIDTH_MODEL["k"], d=WIDTH_MODEL["d"],
                       seed=SEED)
        what = f"d{c} ({nh} heads of {c // nh})"
        pipe = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80,
                                      precision="int8", encoder_impl="fused")
        pipe.calibrate(calib)
        (labels, probs), counts = counted(lambda: pipe.classify(req))
        check(set(counts) == {ENC, ATTN, GEMM},
              f"transformer shapes classify {what} launched {sorted(counts)}")
        note(counts, f"transformer shapes classify {what}", f"C={c}")
        with plain_path():
            labels_p, probs_p = pipe.classify(req)
        sure = np.abs(probs_p[:, 0] - probs_p[:, 1]) > LABEL_MARGIN
        check(bool(np.isfinite(probs).all())
              and bool((labels == labels_p)[sure].all()),
              f"transformer shapes classify {what}: labels differ from the "
              f"plain path's outside the margin")
        parts = [f"classify {json.dumps(counts)}, {int(sure.sum())} sure"]
        paths = [("attn", {"block_fusion": "attn"}, {ENC, ATTN, GEMM}),
                 ("full", {"block_fusion": "full"}, {ENC, FULL})]
        if (c, nh) == TSHAPES_FUSED:
            paths.append(("fused_attention", {"block_fusion": None,
                                              "fused_attention": True},
                          {ENC, QKV}))
        with torch.inference_mode():
            for name, kw, want in paths:
                fn = make_pipeline_quantized(vq, tr, pipe.qparams, **kw)
                lk, counts = counted(lambda: fn(xreq))
                check(set(counts) == want, f"transformer shapes {name} "
                                           f"{what} launched {sorted(counts)}")
                note(counts, f"transformer shapes {name} {what}", f"C={c}")
                with plain_path():
                    lp = fn(xreq)
                n_sure = labels_hold(f"{name} {what}", lk, lp)
                parts.append(f"{name} {json.dumps(counts)}, {n_sure} sure, "
                             f"max |dlogit| "
                             f"{float((lk - lp).abs().max()):.3e}")
        log(f"transformer shapes seed model {what}, 1 block, T="
            f"{tr.seq_len}, {len(req)} windows: labels equal the plain "
            f"path's outside the {LABEL_MARGIN} margin on every path: "
            + "; ".join(parts) + f"; gpu {smi}")
        del vq, tr, pipe

    # -- X3. a training step at heads of 256 ---------------------------------
    c, nh = TSHAPES_TRAIN
    _, trp = build(d_model=c, n_heads=nh, n_blocks=1, hidden=64, n_res=1,
                   k=WIDTH_MODEL["k"], d=WIDTH_MODEL["d"], seed=SEED,
                   attention_impl="pallas")
    trp.requires_grad_(True)
    trp.res_dropout = trp.att_dropout = 0.0
    t = trp.seq_len
    batch = (torch.randint(0, trp.n_classes, (WIDTH_TRAIN_BATCH, t),
                           generator=gen),
             torch.randint(0, 2, (WIDTH_TRAIN_BATCH,), generator=gen),
             torch.randint(0, trp.n_classes, (WIDTH_TRAIN_BATCH, t),
                           generator=gen))
    batch = tuple(a.to(dev) for a in batch)
    with tf32_flags(**TORCH_DEFAULT_TF32):
        one_step_against_plain(
            f"transformer shapes d{c} ({nh} heads of {c // nh})", trp,
            TransformerGenTask(trp), batch, FLASH, trp.n_blocks, smi)
    note({FLASH: trp.n_blocks}, f"transformer shapes training step (d{c}, "
                                f"heads of {c // nh})", f"head {c // nh}")
    del trp

    # -- X4. every widened kernel against plain, timed in turns ----------
    # (#9 also beside scaled_dot_product_attention on its operands)
    fns, bounds, errs, libs = {}, {}, {}, {}
    m = TSHAPES_ROWS
    with torch.inference_mode():
        for c in TSHAPES_C:
            work = kernel_work(1, c, 1, 1, 1, 1, 1, TSHAPES_BATCH, 321, 1, 1,
                               1)
            for shape, (nc, kc, q8, with_resid) in GEMM_SHAPES.items():
                n_out, k_in = nc * c, kc * c
                a8 = torch.randint(-127, 128, (m, k_in), generator=gen,
                                   dtype=torch.int8).to(dev)
                w8 = torch.randint(-127, 128, (n_out, k_in), generator=gen,
                                   dtype=torch.int8).to(dev)
                cs = (torch.rand(n_out, generator=gen) + 0.5).to(dev) \
                    * (4.0 / (k_in ** 0.5 * 127 * 127))
                cb = (torch.randn(n_out, generator=gen) * 0.1).to(dev)
                resid = (torch.randn(m, n_out, generator=gen).to(dev)
                         if with_resid else None)
                qs = torch.tensor(30.0, device=dev) if q8 else None
                args = (a8, w8, cs, cb, resid, qs)
                got, counts = counted(lambda: igemm.int8_gemm(*args))
                check(counts == {GEMM: 1}, f"transformer shapes {GEMM} "
                                           f"{shape} C={c} launched {counts}")
                check(torch.equal(got, igemm.int8_gemm_reference(*args)),
                      f"transformer shapes {GEMM} {shape} at C={c}: not "
                      f"bit-equal to the plain stage")
                note(counts, "transformer shapes kernels", f"C={c}")
                key = (GEMM, f"{shape} C={c} (N={n_out}, K={k_in})")
                errs[key] = 0.0
                fns[key] = (lambda a=args: igemm.int8_gemm(*a),
                            lambda a=args: igemm.int8_gemm_reference(*a))
                bounds[key] = bound_of(work[f"{GEMM} {shape}"])
            x = (torch.randn(m, c, generator=gen) * 3).to(dev)
            scale = (torch.rand(c, generator=gen) + 0.5).to(dev)
            bias = (torch.randn(c, generator=gen) * 0.1).to(dev)
            qs = torch.tensor(30.0, device=dev)
            rails = torch.full((m,), -1, dtype=torch.int32, device=dev)
            a = (x, scale, bias, qs)
            h8, counts = counted(lambda: fbq.ln_q8(*a, rail_rows=rails))
            check(counts == {LN_ALONE: 1}, f"transformer shapes {LN_ALONE} "
                                           f"C={c} launched {counts}")
            frac, step = int8_diff(h8, fbq.ln_q8_reference(*a))
            check(frac <= MAX_INT8_DIFF_FRAC and step <= MAX_INT8_STEP
                  and torch.equal(rails, (h8.int().abs() == 127).sum(
                      -1, dtype=torch.int32)),
                  f"transformer shapes {LN_ALONE} at C={c}: h8 differs in "
                  f"{frac} by {step}, or its rail counts")
            note(counts, "transformer shapes kernels", f"C={c}")
            key = (LN_ALONE, f"C={c}")
            errs[key] = float(step)
            fns[key] = (lambda a=a: fbq.ln_q8(*a),
                        lambda a=a: fbq.ln_q8_reference(*a))
            bounds[key] = bound_of(work[LN_ALONE])
            if c == TSHAPES_LN_RECORD:
                out["err"], out["work"] = float(step), work[LN_ALONE]
        for hd in TSHAPES_HEADS:
            nh = max(1, 512 // hd)
            c = nh * hd
            qkv = (torch.randn(TSHAPES_BATCH, 321, 3 * c, generator=gen)
                   * 2).to(dev)
            q, k, v = (split_heads(z, nh) for z in qkv.split(c, dim=-1))
            o, counts = counted(lambda: fflash.flash_attention_forward(
                q, k, v))
            ref = fflash.flash_causal_attention_reference(q, k, v)
            e = float((o - ref).abs().max())
            if e > MAX_ROW_ERR:
                exact = fflash.flash_causal_attention_reference(
                    q.double(), k.double(), v.double())
                log(f"transformer shapes {FLASH} at head {hd}: {e:.3e} from "
                    f"plain; against float64 the kernel "
                    f"{float((o - exact).abs().max()):.3e}, plain "
                    f"{float((ref - exact).abs().max()):.3e}")
            check(e <= MAX_ROW_ERR, f"transformer shapes {FLASH} at head "
                                    f"{hd}: {e} from plain")
            note(counts, "transformer shapes kernels", f"head {hd}")
            ys = torch.tensor(30.0, device=dev)
            y8, counts2 = counted(lambda: fattn.fused_causal_attention_quant(
                qkv, ys, n_head=nh))
            frac, step = int8_diff(y8, fattn.causal_attention_quant_reference(
                qkv, ys, n_head=nh))
            check(frac <= MAX_INT8_DIFF_FRAC and step <= MAX_INT8_STEP,
                  f"transformer shapes {CAUSAL} at head {hd}: y8 differs in "
                  f"{frac} by {step}")
            note(counts2, "transformer shapes kernels", f"head {hd}")
            work = kernel_work(1, c, 1, 1, 1, 1, 1, TSHAPES_BATCH, 321, nh,
                               1, 1)
            for name, err, kfn, pfn in (
                    (FLASH, e,
                     lambda q=q, k=k, v=v: fflash.flash_attention_forward(
                         q, k, v),
                     lambda q=q, k=k, v=v:
                     fflash.flash_causal_attention_reference(q, k, v)),
                    (CAUSAL, float(step),
                     lambda a=(qkv, ys), nh=nh:
                     fattn.fused_causal_attention_quant(*a, n_head=nh),
                     lambda a=(qkv, ys), nh=nh:
                     fattn.causal_attention_quant_reference(*a, n_head=nh))):
                key = (name, f"head {hd} ({nh} heads)")
                errs[key], fns[key] = err, (kfn, pfn)
                bounds[key] = bound_of(work[name])
            libs[FLASH, f"head {hd} ({nh} heads)"] = (
                lambda q=q, k=k, v=v: sdpa(q, k, v, is_causal=True))
        # the kernels' device time a call (torch.profiler, cold operands):
        # events around one call hold the host's launch
        traced = kernel_trace({key: pair[0] for key, pair in fns.items()})
        for key, (kfn, pfn) in fns.items():
            lib = libs.get(key)
            t_k = timed_in_turns({"kernel": kfn, "plain": pfn,
                                  **({"library": lib} if lib else {})},
                                 reps=SHAPES_REPS, warmup=1)
            bound, by = bounds[key]
            ms = traced[key][0]
            if key == (LN_ALONE, f"C={TSHAPES_LN_RECORD}"):
                out["times"], out["device_ms"] = t_k, ms
            log(f"transformer shapes kernel {key[0]} at {key[1]}: "
                f"{fmt_ms(t_k['kernel'])}, plain {fmt_ms(t_k['plain'])}; "
                f"device " + ("not measured" if ms is None
                              else f"{ms:.4f} ms a call")
                + f"; bound {bound:.4f} ms by {by}"
                + ("" if ms is None else f" ({bound / ms:.1%} of the device "
                                         f"time)")
                + f"; worst difference from plain {errs[key]:.3e}; gpu {smi}")
            if lib:
                log_library(f"transformer shapes {key[0]} at {key[1]}",
                            t_k["library"], lib, pfn, smi)
    log(f"transformer shapes phase: {time.perf_counter() - t_phase:.1f} s; "
        f"gpu {smi}")
    return out


def bf16_gate(out, ref) -> tuple[float, int]:
    """(the share of entries of two bf16 tensors that differ, the
    entries more than one bf16 step and MAX_ROW_ERR apart): the numbers
    of #9's bf16 gate."""
    import torch
    ulps = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    err = (out.float() - ref.float()).abs()
    return (float((ulps > 0).float().mean()),
            int(((ulps > 1) & (err > MAX_ROW_ERR)).sum()))


def _int8_block_operands(c: int, gen, dev):
    """A calibrated int8 block's operands at width c, in the kernels'
    rows (w_qkv, w_proj, w_fc, w_mp, scales, vc, v3c, v4c, as
    fused_block_quant packs them), its dequantization rows scaled by
    1 / sqrt(c) so that q, k and v (of order 2), the GELU inputs and the
    block's output keep their size at every width."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels

    def w8(n, k):
        w = torch.randint(-127, 128, (n, k), generator=gen,
                          dtype=torch.int8).to(dev)
        return kernels.pitched(w, "w", (n, k), w.device)

    r = (512 / c) ** 0.5
    rand = [torch.rand(c, generator=gen) + 0.5 for _ in range(2)]
    small = [torch.randn(n, generator=gen) * 0.1 for n in (c, c, 3 * c,
                                                           4 * c)]
    tail = [torch.randn(c, generator=gen) * 0.01 for _ in range(2)]
    vc = torch.stack([rand[0], small[0], rand[1], small[1],
                      torch.full((c,), 2e-5 * r), tail[0],
                      torch.full((c,), 1e-5 * r), tail[1]])
    v3c = torch.stack([torch.full((3 * c,), 4e-5 * r), small[2]])
    v4c = torch.stack([torch.full((4 * c,), 3e-5 * r), small[3]])
    scales = torch.tensor([30.0, 127.0 / 4.0, 30.0, 30.0])
    return (w8(3 * c, c), w8(c, c), w8(4 * c, c), w8(c, 4 * c),
            *(z.to(dev).contiguous() for z in (scales, vc, v3c, v4c)))


def narrow_widths_phase(smi: str, cli: dict, device: str = "cuda") -> dict:
    """The int8 attention, #9 on bf16 and the decode kernels at every
    transformer width (see the NW_* constants): the d1600 CLI model that
    transformer_shapes_phase trained (`cli`: its pipeline, transformer,
    windows and their tokens) and the seed models through 'attn8',
    'full8' and generate_kv(decode_impl='fused'), bf16 training steps,
    then each kernel alone against plain, timed in turns beside its
    bound. Returns {"launched": {kernel: (path, launches)}, "held":
    {kernel: [C and heads]}}."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn as fflash, fused_block_quant as fbq,
        fused_decode as fdec)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        causal_attention_core, split_heads)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline)
    from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
        TransformerGenTask)

    t_phase = time.perf_counter()
    dev = torch.device(device)
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator().manual_seed(SEED + 4)
    out = {"launched": {}, "held": {}}

    def note(counts, path, shape):
        """Record a run's launches, and the (C, heads) each of this
        phase's kernels ran at."""
        for name, n in counts.items():
            out["launched"].setdefault(name, (path, n))
            if name in (ATTN8, FULL8, FLASH_BF16, DEC_ATTN, DEC_BLOCK):
                held = out["held"].setdefault(name, [])
                if shape not in held:
                    held.append(shape)

    def serve(what, vq, tr, qparams, xreq) -> list:
        """'attn8' and 'full8' on xreq: exactly their kernels, labels
        equal to the plain path's outside the margin."""
        shape = f"C={tr.d_model}, {tr.n_head} heads"
        parts = []
        with torch.inference_mode():
            for name, want in (("attn8", {ENC, ATTN8, GEMM}),
                               ("full8", {ENC, FULL8})):
                fn = make_pipeline_quantized(vq, tr, qparams,
                                             block_fusion=name)
                lk, counts = counted(lambda: fn(xreq))
                check(set(counts) == want, f"narrow widths {name} {what} "
                                           f"launched {sorted(counts)}")
                note(counts, f"narrow widths {name} {what}", shape)
                with plain_path():
                    lp = fn(xreq)
                sure = (lp[:, 0] - lp[:, 1]).abs() > LABEL_MARGIN
                same = lk.argmax(-1) == lp.argmax(-1)
                check(bool(torch.isfinite(lk).all())
                      and bool(same[sure].all()),
                      f"narrow widths {name} {what}: labels differ from the "
                      f"plain path's on {int((~same)[sure].sum())} windows "
                      f"outside the {LABEL_MARGIN} margin")
                parts.append(f"{name} {json.dumps(counts)}, "
                             f"{int(sure.sum())} of {len(lk)} windows sure, "
                             f"max |dlogit| "
                             f"{float((lk - lp).abs().max()):.3e}")
        return parts

    def forced_decode(what, tr, start_token, steps) -> str:
        """generate_kv(decode_impl='fused') on the ids of the plain
        sampler: one launch of #13 a block and step, each step's logits
        within MAX_STEP_ERR of the 'xla' step's."""
        start = torch.full((NW_SAMPLE_BATCH, 1), start_token,
                           dtype=torch.int32, device=dev)
        ids = tr.generate_kv(start, num_steps=steps)

        def forced(run):
            seen = []

            def draw(last, *_args, **_kw):
                seen.append(last.float().clone())
                return ids[:, len(seen)]

            with mock.patch.object(tr, "_sample_from_logits", draw):
                _, counts = counted(run)
            check(len(seen) == steps, f"forced run drew {len(seen)} times")
            return torch.stack(seen), counts

        plain, _ = forced(lambda: tr.generate_kv(start, num_steps=steps))
        got, counts = forced(lambda: tr.generate_kv(
            start, num_steps=steps, decode_impl="fused"))
        check(counts == {DEC_BLOCK: tr.n_blocks * steps},
              f"narrow widths generate_kv fused {what} launched "
              f"{json.dumps(counts)}")
        note(counts, f"narrow widths generate_kv(decode_impl='fused') "
                     f"{what}", f"C={tr.d_model}, {tr.n_head} heads")
        e = float((got - plain).abs().max())
        check(e <= MAX_STEP_ERR, f"narrow widths generate_kv fused {what}: "
                                 f"forced step logits within {e} of 'xla'")
        return (f"generate_kv(decode_impl='fused') {json.dumps(counts)}, "
                f"{steps} forced steps of {NW_SAMPLE_BATCH} streams, logits "
                f"within {e:.3e} of 'xla' (bound {MAX_STEP_ERR})")

    # -- N1. the d1600 CLI checkpoint ---------------------------------------
    pipe, tr = cli["pipe"], cli["tr"]
    what = f"d{tr.d_model} CLI checkpoint"
    parts = serve(what, pipe.vq_model, tr, pipe.qparams,
                  torch.from_numpy(cli["windows"]).to(dev))
    blk = pipe.qparams["blocks"][0]
    scales, vc, v3c, v4c = fbq.packed_operands(blk)
    w = dict(zip(("c_attn", "c_proj", "c_fc", "m_proj"),
                 fbq.packed_weights(blk)))
    worst = Worst()
    with torch.inference_mode():
        x = tr.embed(cli["ids"]).float().contiguous()
        sc, sc6 = {}, {}
        (sc["x_mid"], sc["h8"]), counts = counted(
            lambda: fbq.attn_block_quant(
                x, w["c_attn"], w["c_proj"], scales, vc[:6], v3c,
                n_head=tr.n_head, int8_attn=True, scratch=sc))
        held = [block_stages(worst, ATTN8, x, sc, w, scales, vc[:6], v3c,
                             None, tr.n_head, True)]
        sc6["out"], counts6 = counted(lambda: fbq.block_quant(
            x, w["c_attn"], w["c_proj"], w["c_fc"], w["m_proj"], scales,
            vc, v3c, v4c, n_head=tr.n_head, int8_attn=True, scratch=sc6))
        held.append(block_stages(worst, FULL8, x, sc6, w, scales, vc, v3c,
                                 v4c, tr.n_head, True))
    check(counts == {ATTN8: 1} and counts6 == {FULL8: 1},
          f"narrow widths: the CLI model's block 0 launched {counts}, "
          f"{counts6}")
    worst.check()
    parts.append(forced_decode(what, tr, pipe.start_token, NW_STEPS))
    log(f"narrow widths {what} ({tr.n_head} heads of "
        f"{tr.d_model // tr.n_head}, {len(tr.blocks)} blocks), "
        f"{len(cli['windows'])} windows: " + "; ".join(parts)
        + f"; block 0 on #2 and #6 with int8_attn, stage by stage against "
        f"plain: {held[0]} | {held[1]}; gpu {smi}")

    # -- N2. seed models ----------------------------------------------------
    width = N_CYCLES * CYCLE_LEN
    calib = rng.standard_normal((2, width, 2)).astype(np.float32)
    xreq = torch.from_numpy(rng.standard_normal(
        (WIDTH_REQUEST, width, 2)).astype(np.float32)).to(dev)
    for c, nh in TSHAPES_MODELS:
        vq, trs = build(d_model=c, n_heads=nh, n_blocks=1, hidden=64,
                        n_res=1, k=WIDTH_MODEL["k"], d=WIDTH_MODEL["d"],
                        seed=SEED)
        what = f"seed model d{c} ({nh} heads of {c // nh})"
        pipe_s = WeldingQualityPipeline(vq, trs, n_cycles=N_CYCLES,
                                        max_batch=80, precision="int8",
                                        encoder_impl="fused")
        pipe_s.calibrate(calib)
        parts = serve(what, vq, trs, pipe_s.qparams, xreq)
        parts.append(forced_decode(what, trs, pipe_s.start_token,
                                   NW_SEED_STEPS))
        log(f"narrow widths {what}, 1 block, {len(xreq)} windows: "
            + "; ".join(parts) + f"; gpu {smi}")
        del vq, trs, pipe_s

    # -- N3. bf16 training steps on #9's bf16 tile ---------------------------
    for c, nh in NW_TRAIN:
        _, trp = build(d_model=c, n_heads=nh, n_blocks=1, hidden=64, n_res=1,
                       k=WIDTH_MODEL["k"], d=WIDTH_MODEL["d"], seed=SEED,
                       attention_impl="pallas")
        trp.compute_dtype = torch.bfloat16
        trp.requires_grad_(True)
        trp.res_dropout = trp.att_dropout = 0.0
        t = trp.seq_len
        batch = tuple(a.to(dev) for a in (
            torch.randint(0, trp.n_classes, (WIDTH_TRAIN_BATCH, t),
                          generator=gen),
            torch.randint(0, 2, (WIDTH_TRAIN_BATCH,), generator=gen),
            torch.randint(0, trp.n_classes, (WIDTH_TRAIN_BATCH, t),
                          generator=gen)))
        with tf32_flags(**TORCH_DEFAULT_TF32):
            one_step_against_plain(
                f"narrow widths bf16 d{c} ({nh} heads of {c // nh})", trp,
                TransformerGenTask(trp), batch, FLASH_BF16, trp.n_blocks,
                smi)
        note({FLASH_BF16: trp.n_blocks}, f"narrow widths bf16 training step "
                                         f"(d{c}, heads of {c // nh})",
             f"C={c}, {nh} heads")
        del trp

    # -- N4. each kernel alone at NW_SHAPES ----------------------------------
    # (#9 bf16 also beside scaled_dot_product_attention on its operands)
    fns, bounds, errs, libs = {}, {}, {}, {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = 321
    with torch.inference_mode():
        for c, nh in NW_SHAPES:
            shape = f"C={c}, {nh} heads"
            hd = c // nh
            work = kernel_work(1, c, 1, 1, 1, 1, 1, NW_BATCH, t, nh,
                               SAMPLE_BATCH, NW_POS)
            # the int8 attention inside #2 and #6
            wq, wp, wf, wm, scales, vc, v3c, v4c = _int8_block_operands(
                c, gen, dev)
            x = torch.randn(NW_BATCH, t, c, generator=gen).to(dev)
            sc, full = {}, {}
            (sc["x_mid"], sc["h8"]), counts = counted(
                lambda: fbq.attn_block_quant(
                    x, wq, wp, scales, vc[:6], v3c, n_head=nh,
                    int8_attn=True, scratch=sc))
            sc6 = {}
            sc6["out"], counts6 = counted(lambda: fbq.block_quant(
                x, wq, wp, wf, wm, scales, vc, v3c, v4c, n_head=nh,
                int8_attn=True, scratch=sc6))
            check(counts == {ATTN8: 1} and counts6 == {FULL8: 1},
                  f"narrow widths kernels at {shape}: {counts}, {counts6}")
            worst = Worst()
            wd = dict(zip(("c_attn", "c_proj", "c_fc", "m_proj"),
                          (wq, wp, wf, wm)))
            block_stages(worst, ATTN8, x, sc, wd, scales, vc[:6], v3c, None,
                         nh, True)
            block_stages(worst, FULL8, x, sc6, wd, scales, vc, v3c, v4c, nh,
                         True)
            worst.check()
            note({ATTN8: 1, FULL8: 1}, "narrow widths kernels", shape)
            errs[ATTN8, shape] = worst.err[f"{ATTN8}.x_mid"]
            errs[FULL8, shape] = worst.err[f"{FULL8}.out"]
            a2 = (x, wq, wp, scales, vc[:6], v3c)
            a6 = (x, wq, wp, wf, wm, scales, vc, v3c, v4c)
            fns[ATTN8, shape] = (
                lambda a=a2, nh=nh: fbq.attn_block_quant(
                    *a, n_head=nh, int8_attn=True),
                lambda a=a2, nh=nh: fbq.fused_attn_block_quant_reference(
                    *a, n_head=nh, int8_attn=True))
            fns[FULL8, shape] = (
                lambda a=a6, nh=nh: fbq.block_quant(
                    *a, n_head=nh, int8_attn=True),
                lambda a=a6, nh=nh: fbq.fused_block_quant_reference(
                    *a, n_head=nh, int8_attn=True))
            # #9 on bf16 q, k, v read in place from a packed qkv
            qkv = (torch.randn(NW_BATCH, t, 3 * c, generator=gen) * 2).to(
                dev, torch.bfloat16)
            q, k, v = (split_heads(z, nh) for z in qkv.split(c, dim=-1))
            o, counts = counted(lambda: fflash.flash_causal_attention(
                q, k, v))
            ref = fflash.flash_causal_attention_reference(q, k, v)
            share, far = bf16_gate(o, ref)
            against = "plain"
            if far or share > MAX_BF16_DIFF_SHARE:
                # the plain version's f32 sums may themselves miss the
                # gate against the float64 attention (a head of 4,096):
                # the kernel is then held there
                exact = causal_attention_core(
                    q.double(), k.double(), v.double()).to(torch.bfloat16)
                plain = bf16_gate(ref, exact)
                against = (f"float64 (plain there: {plain[0]:.2e} differ, "
                           f"{plain[1]} beyond)")
                check(plain[1] > 0 or plain[0] > MAX_BF16_DIFF_SHARE,
                      f"narrow widths {FLASH_BF16} at {shape}: {share:.2e} "
                      f"of the entries differ from plain, {far} beyond one "
                      f"bf16 step and {MAX_ROW_ERR}")
                share, far = bf16_gate(o, exact)
            check(counts == {FLASH_BF16: 1} and far == 0
                  and share <= MAX_BF16_DIFF_SHARE,
                  f"narrow widths {FLASH_BF16} at {shape}: launches "
                  f"{counts}, {share:.2e} of the entries differ from "
                  f"{against}, {far} beyond one bf16 step and {MAX_ROW_ERR}")
            log(f"narrow widths {FLASH_BF16} at {shape}: {share:.2e} of the "
                f"entries differ from {against}, none beyond one bf16 step "
                f"and {MAX_ROW_ERR}")
            note(counts, "narrow widths kernels", shape)
            errs[FLASH_BF16, shape] = float((o.float() - ref.float()).abs()
                                            .max())
            fns[FLASH_BF16, shape] = (
                lambda a=(q, k, v): fflash.flash_attention_forward(*a),
                lambda a=(q, k, v): fflash.flash_causal_attention_reference(
                    *a))
            libs[FLASH_BF16, shape] = (
                lambda a=(q, k, v): sdpa(*a, is_causal=True))
            # #12 and #13 on random caches
            _, trd = build(d_model=c, n_heads=nh, n_blocks=1, hidden=16,
                           n_res=1, k=WIDTH_MODEL["k"], d=WIDTH_MODEL["d"],
                           seed=SEED)
            blk = trd.blocks[0]
            tc = trd.seq_len
            xt = torch.randn(SAMPLE_BATCH, 1, c, generator=gen).to(dev)
            for name, kfn, pfn, cshape, row in (
                    (DEC_ATTN, fdec.fused_decode_attn,
                     fdec.fused_decode_attn_reference,
                     (SAMPLE_BATCH, nh, tc, hd), lambda z, p: z[:, :, p]),
                    (DEC_BLOCK, fdec.fused_block_decode,
                     fdec.fused_block_decode_reference, (SAMPLE_BATCH, tc, c),
                     lambda z, p: z[:, p])):
                kv = [torch.randn(*cshape, generator=gen).to(dev)
                      for _ in range(2)]
                worst_e = 0.0
                for pos in (0, NW_POS, tc - 1):
                    kk, kv_ = (z.clone() for z in kv)
                    pk, pv = (z.clone() for z in kv)
                    o, counts = counted(lambda: kfn(xt, blk, kk, kv_, pos,
                                                    n_head=nh)[0])
                    ref = pfn(xt, blk, pk, pv, pos, n_head=nh)[0]
                    e = float((o - ref).abs().max())
                    er = max(float((row(a, pos) - row(r, pos)).abs().max())
                             for a, r in ((kk, pk), (kv_, pv)))
                    check(counts == {name: 1} and e <= MAX_DECODE_ERR
                          and er <= MAX_ROW_ERR,
                          f"narrow widths {name} at {shape} pos {pos}: "
                          f"launches {counts}, output {e}, written row {er}")
                    worst_e = max(worst_e, e)
                note({name: 1}, "narrow widths kernels", shape)
                errs[name, shape] = worst_e
                # #13 timed as generate_kv runs it: through a stack that
                # packs the weights once where the general form runs (the
                # per-call wrapper hands them in rows, padded per call
                # where C is no multiple of 64)
                kernel = (
                    lambda kfn=kfn, a=(xt, blk, *kv, NW_POS), nh=nh:
                    kfn(*a, n_head=nh)) if name == DEC_ATTN else (
                    lambda st=fdec.BlockDecodeStack([blk], [tuple(kv)],
                                                    n_head=nh), xt=xt:
                    st(xt, NW_POS))
                fns[name, shape] = (
                    kernel,
                    lambda pfn=pfn, a=(xt, blk, *kv, NW_POS), nh=nh:
                    pfn(*a, n_head=nh))
            for name in (ATTN8, FULL8, FLASH_BF16, DEC_ATTN, DEC_BLOCK):
                bounds[name, shape] = bound_of(work[name])
            del trd
        traced = kernel_trace({key: pair[0] for key, pair in fns.items()})
        for key, (kfn, pfn) in fns.items():
            lib = libs.get(key)
            t_k = timed_in_turns({"kernel": kfn, "plain": pfn,
                                  **({"library": lib} if lib else {})},
                                 reps=NW_REPS, warmup=1)
            bound, by = bounds[key]
            ms = call_ms = traced[key][0]
            alone = ""
            if key[0] in (DEC_ATTN, DEC_BLOCK) and ms is not None:
                # the kernel's launches alone, beside the whole call's
                # (the padding copies of a width off the multiples of 64)
                ms = sum(cnt * each for k, cnt, each in traced[key][2]
                         if is_decode(k))
                alone = f" ({ms:.4f} ms the kernel's launches)"
            log(f"narrow widths kernel {key[0]} at {key[1]}: "
                f"{fmt_ms(t_k['kernel'])}, plain {fmt_ms(t_k['plain'])}; "
                f"device " + ("not measured" if ms is None
                              else f"{call_ms:.4f} ms a call{alone}")
                + f"; bound {bound:.4f} ms by {by}"
                + ("" if ms is None else f" ({bound / ms:.1%} of the device "
                                         f"time)")
                + f"; worst difference from plain {errs[key]:.3e}; gpu {smi}")
            if lib:
                log_library(f"narrow widths {key[0]} at {key[1]}",
                            t_k["library"], lib, pfn, smi)
    log(f"narrow widths phase: {time.perf_counter() - t_phase:.1f} s; "
        f"gpu {smi}")
    return out


def wide_heads_phase(smi: str, device: str = "cuda") -> dict:
    """The wide attention tiles on their slice's path (see the WIDE_*
    constants): the d2048 model of 8 heads of 256 served through
    classify, 'attn', 'full', fused_attention (#10) and fused_attention
    with fused_qkv=False (#11), each launching exactly its kernels, a
    launch a block, its f32 attention in clusters of
    kernels.wide_cluster(256) (the library's record), labels equal to
    the plain path's outside the margin, classify's device time and the
    wide tile's share of it (torch.profiler); an f32 and a bf16
    attention_impl='pallas' training step against plain (#9's two wide
    tiles); then #9 f32, #9 bf16 and #11 alone at WIDE_ALONE against
    plain, timed in turns with it and with scaled_dot_product_attention
    (#9), device ms on cold operands, beside the bound of kernel_work.
    Returns {"launched": {kernel: (path, launches)}, "cluster": {kernel:
    cluster size}, "held": {kernel: [shapes]}, "device_ms": {kernel:
    ms a launch on the path's shape}, "library_ms": {kernel: SDPA's}}."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn as fflash, fused_attn_quant as fattn)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        causal_attention_core, split_heads)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline)
    from vq_vae_transformer_arc_welding_tpu_torch.train.tasks import (
        TransformerGenTask)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    t_phase = time.perf_counter()
    dev = torch.device(device)
    rng = np.random.default_rng(SEED + 5)
    gen = torch.Generator().manual_seed(SEED + 5)
    out = {"launched": {}, "cluster": {}, "held": {}, "device_ms": {},
           "library_ms": {}}
    c, nh, depth = (WIDE_TR[k] for k in ("d_model", "n_heads", "n_blocks"))
    what = f"d{c} ({nh} heads of {c // nh}, {depth} blocks)"

    def note(counts, path, shape):
        """Record a run's launches and the cluster its wide tile ran in."""
        for name, n in counts.items():
            out["launched"].setdefault(name, (path, n))
            if name in (ENC, GEMM):
                continue
            n_cl = kernels.last_cluster(name)
            check(n_cl == kernels.wide_cluster(shape[3]),
                  f"wide heads {path}: {name} ran its attention in clusters "
                  f"of {n_cl}, expected {kernels.wide_cluster(shape[3])}")
            out["cluster"][name] = n_cl
            held = out["held"].setdefault(name, [])
            if list(shape) not in held:
                held.append(list(shape))

    # -- W1. the d2048 model served ------------------------------------------
    vq, tr = build(d_model=c, n_heads=nh, n_blocks=depth, seed=SEED)
    t = tr.seq_len
    shape = (WIDE_REQUEST, nh, t, c // nh)
    width = N_CYCLES * CYCLE_LEN
    calib = rng.standard_normal((2, width, 2)).astype(np.float32)
    req = rng.standard_normal((WIDE_REQUEST, width, 2)).astype(np.float32)
    xreq = torch.from_numpy(req).to(dev)
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80,
                                  precision="int8", encoder_impl="fused")
    pipe.calibrate(calib)
    (labels, probs), counts = counted(lambda: pipe.classify(req))
    check(set(counts) == {ENC, ATTN, GEMM} and counts[ATTN] == depth,
          f"wide heads classify {what} launched {json.dumps(counts)}")
    note(counts, f"wide heads classify {what}", shape)
    with plain_path():
        labels_p, probs_p = pipe.classify(req)
    sure = np.abs(probs_p[:, 0] - probs_p[:, 1]) > LABEL_MARGIN
    check(bool(np.isfinite(probs).all())
          and bool((labels == labels_p)[sure].all()),
          f"wide heads classify {what}: labels differ from the plain "
          f"path's on {int((labels != labels_p)[sure].sum())} windows "
          f"outside the margin")
    parts = [f"classify {json.dumps(counts)}, {int(sure.sum())} of "
             f"{len(labels)} windows sure, max |dp| "
             f"{float(np.abs(probs - probs_p).max()):.3e}"]
    with torch.inference_mode():
        for name, kw, want in (
                ("attn", {"block_fusion": "attn"}, {ENC, ATTN, GEMM}),
                ("full", {"block_fusion": "full"}, {ENC, FULL}),
                ("fused_attention", {"block_fusion": None,
                                     "fused_attention": True}, {ENC, QKV}),
                ("fused_attention+fused_qkv=False",
                 {"block_fusion": None, "fused_attention": True,
                  "fused_qkv": False}, {ENC, CAUSAL})):
            fn = make_pipeline_quantized(vq, tr, pipe.qparams, **kw)
            lk, counts = counted(lambda: fn(xreq))
            check(set(counts) == want and all(
                counts[k] == depth for k in want - {ENC, GEMM}),
                f"wide heads {name} {what} launched {json.dumps(counts)}")
            note(counts, f"wide heads {name} {what}", shape)
            with plain_path():
                lp = fn(xreq)
            ok = (lp[:, 0] - lp[:, 1]).abs() > LABEL_MARGIN
            same = lk.argmax(-1) == lp.argmax(-1)
            check(bool(torch.isfinite(lk).all()) and bool(same[ok].all()),
                  f"wide heads {name} {what}: labels differ from the plain "
                  f"path's on {int((~same)[ok].sum())} windows outside the "
                  f"margin")
            parts.append(f"{name} {json.dumps(counts)}, {int(ok.sum())} "
                         f"sure, max |dlogit| "
                         f"{float((lk - lp).abs().max()):.3e}")
    n_ops, busy, names = device_profile(lambda: pipe.classify(req))
    if busy is None:
        parts.append("classify's device trace: no device event, not "
                     "measured")
    else:
        got = [(cnt, ms) for key, cnt, ms in names
               if is_kernel(key, "attention_wide_kernel")]
        n, ms = (sum(v) for v in zip(*got)) if got else (0, 0.0)
        check(n == depth, f"wide heads classify's trace holds {n} "
                          f"launches of attention_wide_kernel")
        out["device_ms"][ATTN] = ms / n
        parts.append(f"classify's device time {busy:.4f} ms a call "
                     f"({n_ops} device operations), the f32 wide tile "
                     f"(attention_wide_kernel) x {n}: {ms:.4f} ms "
                     f"({ms / busy:.1%}), {ms / n:.4f} ms a launch")
    log(f"wide heads {what} on the bench VQ-VAE, {len(req)} windows, "
        f"T={t}: " + "; ".join(parts) + f"; gpu {smi}")
    del pipe, vq, tr

    # -- W2. training steps on #9's two wide tiles -------------------------
    # f32 and bf16 at the model's depth; through 8 bf16 blocks the kernel
    # path's loss parts from the plain bf16 path's by ~1.2e-5 of itself
    # though each launch is within the bf16 gate (the parts add up over
    # the blocks), so there the bf16 loss is held, as training_phase's
    # bf16 steps are, to the f32 step's within MAX_BF16_LOSS_REL, and the
    # 1e-5 gate against plain to a one-block model of the same width
    loss32 = None
    for dtype, kernel, blocks in ((torch.float32, FLASH, depth),
                                  (torch.bfloat16, FLASH_BF16, depth),
                                  (torch.bfloat16, FLASH_BF16, 1)):
        _, trp = build(d_model=c, n_heads=nh, n_blocks=blocks, seed=SEED,
                       attention_impl="pallas")
        if dtype == torch.bfloat16:
            trp.compute_dtype = dtype
        trp.requires_grad_(True)
        trp.res_dropout = trp.att_dropout = 0.0
        batch = tuple(a.to(dev) for a in (
            torch.randint(0, trp.n_classes, (WIDE_TRAIN_BATCH, t),
                          generator=torch.Generator().manual_seed(SEED)),
            torch.randint(0, 2, (WIDE_TRAIN_BATCH,),
                          generator=torch.Generator().manual_seed(SEED)),
            torch.randint(0, trp.n_classes, (WIDE_TRAIN_BATCH, t),
                          generator=torch.Generator().manual_seed(SEED + 1))))
        step = (f"wide heads {str(dtype)[6:]} d{c} ({nh} heads of "
                f"{c // nh}, {blocks} blocks)")
        gated = dtype == torch.float32 or blocks == 1
        with tf32_flags(**TORCH_DEFAULT_TF32):
            _, loss_k, _ = one_step_against_plain(
                step, trp, TransformerGenTask(trp), batch, kernel, blocks,
                smi, loss_gate=gated)
        if dtype == torch.float32:
            loss32 = loss_k
        elif not gated:
            rel = abs(loss_k - loss32) / abs(loss32)
            log(f"{step}: loss {loss_k:.9g} against the f32 step's "
                f"{loss32:.9g} (relative {rel:.3e}, bound "
                f"{MAX_BF16_LOSS_REL})")
            check(rel <= MAX_BF16_LOSS_REL,
                  f"{step}: loss {loss_k} against the f32 step's {loss32}")
        note({kernel: blocks}, step, (WIDE_TRAIN_BATCH, nh, t, c // nh))
        del trp

    # -- W3. each wide tile alone ------------------------------------------------
    fns, errs, bounds, libs = {}, {}, {}, {}
    with torch.inference_mode():
        for b, h, tt, hd in WIDE_ALONE:
            cw = h * hd
            at = f"({b}, {h}, {tt}, {hd})"
            qkv = (torch.randn(b, tt, 3 * cw, generator=gen) * 2).to(dev)
            work = kernel_work(1, cw, 1, 1, 1, 1, 1, b, tt, h, 1, 1)
            exact = None
            for dtype, kernel in ((torch.float32, FLASH),
                                  (torch.bfloat16, FLASH_BF16)):
                q, k, v = (split_heads(z, h) for z in
                           qkv.to(dtype).split(cw, dim=-1))
                o, counts = counted(lambda: fflash.flash_attention_forward(
                    q, k, v))
                check(counts == {kernel: 1}, f"wide heads {kernel} at {at} "
                                             f"launched {counts}")
                note(counts, "wide heads kernels", (b, h, tt, hd))
                ref = fflash.flash_causal_attention_reference(q, k, v)
                if dtype == torch.float32:
                    e = float((o - ref).abs().max())
                    check(e <= MAX_ROW_ERR, f"wide heads {kernel} at {at}: "
                                            f"{e} from plain")
                else:
                    share, far = bf16_gate(o, ref)
                    against = "plain"
                    if far or share > MAX_BF16_DIFF_SHARE:
                        # where plain's own f32 sums miss the gate against
                        # the float64 attention (a head of 4,096)
                        exact = causal_attention_core(
                            q.double(), k.double(), v.double()).to(dtype)
                        plain = bf16_gate(ref, exact)
                        check(plain[1] > 0 or plain[0] > MAX_BF16_DIFF_SHARE,
                              f"wide heads {kernel} at {at}: {share:.2e} "
                              f"differ from plain, {far} beyond")
                        share, far = bf16_gate(o, exact)
                        against = "float64"
                    check(far == 0 and share <= MAX_BF16_DIFF_SHARE,
                          f"wide heads {kernel} at {at}: {share:.2e} of the "
                          f"entries differ from {against}, {far} beyond one "
                          f"bf16 step and {MAX_ROW_ERR}")
                    e = float((o.float() - ref.float()).abs().max())
                    log(f"wide heads {kernel} at {at}: {share:.2e} of the "
                        f"entries differ from {against}, none beyond one "
                        f"bf16 step and {MAX_ROW_ERR}")
                key = (kernel, at)
                errs[key] = e
                fns[key] = (lambda a=(q, k, v): fflash.flash_attention_forward(
                    *a), lambda a=(q, k, v):
                    fflash.flash_causal_attention_reference(*a))
                libs[key] = lambda a=(q, k, v): sdpa(*a, is_causal=True)
                bounds[key] = bound_of(work[kernel])
            ys = torch.tensor(30.0, device=dev)
            y8, counts = counted(lambda: fattn.fused_causal_attention_quant(
                qkv, ys, n_head=h))
            frac, step8 = int8_diff(y8, fattn.causal_attention_quant_reference(
                qkv, ys, n_head=h))
            check(counts == {CAUSAL: 1} and frac <= MAX_INT8_DIFF_FRAC
                  and step8 <= MAX_INT8_STEP,
                  f"wide heads {CAUSAL} at {at}: launches {counts}, y8 "
                  f"differs in {frac} by {step8}")
            note(counts, "wide heads kernels", (b, h, tt, hd))
            key = (CAUSAL, at)
            errs[key] = float(step8)
            fns[key] = (lambda a=(qkv, ys), h=h:
                        fattn.fused_causal_attention_quant(*a, n_head=h),
                        lambda a=(qkv, ys), h=h:
                        fattn.causal_attention_quant_reference(*a, n_head=h))
            bounds[key] = bound_of(work[CAUSAL])
        traced = kernel_trace({key: pair[0] for key, pair in fns.items()})
        for key, (kfn, pfn) in fns.items():
            lib = libs.get(key)
            t_k = timed_in_turns({"kernel": kfn, "plain": pfn,
                                  **({"library": lib} if lib else {})},
                                 reps=WIDE_REPS, warmup=1)
            bound, by = bounds[key]
            ms = traced[key][0]
            log(f"wide heads kernel {key[0]} at {key[1]}: "
                f"{fmt_ms(t_k['kernel'])}, plain {fmt_ms(t_k['plain'])}; "
                f"device " + ("not measured" if ms is None
                              else f"{ms:.4f} ms a call")
                + f"; bound {bound:.4f} ms by {by}"
                + ("" if ms is None else f" ({bound / ms:.1%} of the device "
                                         f"time)")
                + f"; worst difference from plain {errs[key]:.3e}; gpu {smi}")
            lib_ms = None
            if lib:
                lib_ms, _ = log_library(f"wide heads {key[0]} at {key[1]}",
                                        t_k["library"], lib, pfn, smi)
            if key[1] == str(WIDE_ALONE[-1]):
                out["device_ms"].setdefault(key[0], ms)
                if lib_ms is not None:
                    out["library_ms"][key[0]] = lib_ms
    log(f"wide heads phase: {time.perf_counter() - t_phase:.1f} s; "
        f"gpu {smi}")
    return out


def wide_decode_phase(smi: str, device: str = "cuda") -> dict:
    """The decode kernels' general form on its slice's path (see the
    WDEC_* constants): generate_kv(decode_impl='fused') of the d1800
    model, exactly n_blocks x SAMPLE_STEPS launches of #13 and nothing
    else, its forced step logits within MAX_STEP_ERR of 'xla''s; ms per
    token of both; #13's device ms a launch and its share of a token's
    device time (torch.profiler); #12 through fused_decode_attn per block
    over WDEC_ATTN_STEPS forced steps within MAX_STEP_ERR. Returns
    {"launched": {kernel: (path, launches)}, "device_ms": {kernel: ms a
    launch}, "ms_per_token": {"xla": ms, "fused": ms}}."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.entry import build
    from vq_vae_transformer_arc_welding_tpu_torch.models.transformer import (
        linear)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_decode as fdec)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.activations import (
        new_gelu)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm

    t_phase = time.perf_counter()
    dev = torch.device(device)
    c, nh, depth = (WDEC_TR[k] for k in ("d_model", "n_heads", "n_blocks"))
    bs, steps = SAMPLE_BATCH, SAMPLE_STEPS
    what = f"d{c} ({nh} heads of {c // nh}, {depth} blocks)"
    out = {"launched": {}, "device_ms": {}, "ms_per_token": {}}
    vq, tr = build(d_model=c, n_heads=nh, n_blocks=depth, seed=SEED)
    t, hd = tr.seq_len, c // nh
    start = torch.full((bs, 1), vq.num_embeddings, dtype=torch.int32,
                       device=dev)
    ids, counts = counted(lambda: tr.generate_kv(start, num_steps=steps))
    check(counts == {} and tuple(ids.shape) == (bs, 1 + steps),
          f"wide decode 'xla' {what}: ids {tuple(ids.shape)}, launches "
          f"{json.dumps(counts)}")

    def forced(run):
        seen = []

        def draw(last, *_args, **_kw):
            seen.append(last.float().clone())
            return ids[:, len(seen)]

        with mock.patch.object(tr, "_sample_from_logits", draw):
            _, counts = counted(run)
        check(len(seen) == steps, f"forced run drew {len(seen)} times")
        return torch.stack(seen), counts

    plain, _ = forced(lambda: tr.generate_kv(start, num_steps=steps))
    got, counts = forced(lambda: tr.generate_kv(start, num_steps=steps,
                                                decode_impl="fused"))
    check(counts == {DEC_BLOCK: depth * steps},
          f"wide decode generate_kv fused {what} launched "
          f"{json.dumps(counts)}, expected {depth * steps} of {DEC_BLOCK}")
    out["launched"][DEC_BLOCK] = (
        f"wide decode generate_kv(decode_impl='fused') {what}",
        counts[DEC_BLOCK])
    e13 = float((got - plain).abs().max())
    check(e13 <= MAX_STEP_ERR, f"wide decode generate_kv fused {what}: "
                               f"forced step logits within {e13} of 'xla'")

    # #12 per block, the plain MLP after it, on the same forced ids
    def step_attn_half(tok, pos, caches):
        x = tr._embed_token(tok, pos)
        for blk, (k_c, v_c) in zip(tr.blocks, caches):
            x, _, _ = fdec.fused_decode_attn(x, blk, k_c, v_c, pos,
                                             n_head=nh)
            h = layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
            x = x + linear(new_gelu(linear(h, blk.mlp.c_fc)), blk.mlp.c_proj)
        ln_f = tr.transformer.ln_f
        return layer_norm(x, ln_f.weight, ln_f.bias)[:, 0] \
            @ tr.lm_head.weight.t()

    n12 = min(WDEC_ATTN_STEPS, steps - 1)
    with torch.inference_mode():
        caches = [(torch.zeros(bs, nh, t, hd, device=dev),
                   torch.zeros(bs, nh, t, hd, device=dev))
                  for _ in range(depth)]
        tr._prefill(ids[:, :1], caches)
        got12, counts12 = counted(lambda: torch.stack(
            [step_attn_half(ids[:, p], p, caches)
             for p in range(1, 1 + n12)]))
        del caches
    check(counts12 == {DEC_ATTN: depth * n12},
          f"wide decode fused_decode_attn {what} launched "
          f"{json.dumps(counts12)}")
    out["launched"][DEC_ATTN] = (
        f"wide decode fused_decode_attn per block {what}, {n12} token steps",
        counts12[DEC_ATTN])
    e12 = float((got12 - plain[1:1 + n12]).abs().max())
    check(e12 <= MAX_STEP_ERR, f"wide decode fused_decode_attn {what}: "
                               f"step logits within {e12} of 'xla'")

    tm = timed_in_turns(
        {"xla": lambda: tr.generate_kv(start, num_steps=steps),
         "fused": lambda: tr.generate_kv(start, num_steps=steps,
                                         decode_impl="fused")},
        reps=WDEC_REPS, warmup=1, per=steps)
    out["ms_per_token"] = {name: v[0] for name, v in tm.items()}
    n_ops, busy, names = device_profile(lambda: tr.generate_kv(
        start, num_steps=steps, decode_impl="fused"))
    if busy is None:
        traced = "device trace: no device event, not measured"
    else:
        # the launches are counted exactly above (`counts`); the trace
        # may lose an event (device_profile), which the count logged
        # here shows, and holds no more than were launched
        mine = [(cnt, ms) for key, cnt, ms in names if is_decode(key)]
        n, ms = (sum(v) for v in zip(*mine)) if mine else (0, 0.0)
        check(0 < n <= depth * steps, f"wide decode: the trace holds {n} "
                                      f"launches of the decode kernels")
        out["device_ms"][DEC_BLOCK] = ms / n
        traced = (f"device time {busy / steps:.4f} ms a token ({n_ops / steps:.1f} "
                  f"device operations), #13 {ms / n:.4f} ms a launch over "
                  f"the {n} of {depth * steps} launches the trace holds, "
                  f"{ms / busy:.1%} of it")
    log(f"wide decode {what}, batch {bs}, {steps} steps: generate_kv "
        f"fused {json.dumps(counts)}, forced step logits within {e13:.3e} "
        f"of 'xla' (bound {MAX_STEP_ERR}); fused_decode_attn per block "
        f"{json.dumps(counts12)} over {n12} steps, logits within "
        f"{e12:.3e}; ms per token 'xla' {fmt_ms(tm['xla'])}, 'fused' "
        f"{fmt_ms(tm['fused'])}; {traced}; gpu {smi}")
    log(f"wide decode phase: {time.perf_counter() - t_phase:.1f} s; "
        f"gpu {smi}")
    return out


def newest_metrics(log_root: str) -> tuple[str, list]:
    """(path, rows) of the newest run's metrics.csv under log_root, each
    row {column: float} without its empty cells."""
    import csv
    runs = [d for d in os.listdir(log_root) if d.startswith("version_")]
    newest = max(runs, key=lambda d: int(d.split("_")[1]))
    path = os.path.join(log_root, newest, "metrics.csv")
    with open(path) as f:
        return path, [{k: float(v) for k, v in row.items() if v != ""}
                      for row in csv.DictReader(f)]


def read_scores(path: str) -> list:
    with open(path) as f:
        lines = f.read().strip().split("\n")
    check(lines[0] == "experiment,welding_run,start_cycle,label,p_bad,p_good",
          f"{path}: header {lines[0]!r}")
    return [ln.split(",") for ln in lines[1:]]


@tf32_flags(**TORCH_DEFAULT_TF32)
def cli_phase(smi: str, device: str = "cuda") -> dict:
    """The training CLIs chained into the scorer (see the module
    docstring), in a temporary directory that is the working directory
    while the phase runs (the CLIs write logs/ and model_checkpoints/
    there). Returns {"launches": {kernel: (path, launches)}, "seconds":
    {cli: wall seconds}, "windows_per_s": the scorer's}."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.cli import (
        score_quality, train_classification_model, train_reconstruction_embedding,
        train_transformer_mtasks)
    from vq_vae_transformer_arc_welding_tpu_torch.data import (
        ASIMoWDataModule, get_val_test_ids, load_asimow_csv, synthetic)
    from vq_vae_transformer_arc_welding_tpu_torch.data.asimow import CYCLE_LEN
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        WeldingQualityPipeline)

    t_phase = time.perf_counter()
    ids = get_val_test_ids()
    out = {"launches": {}, "seconds": {}}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # -- C1. one synthetic CSV for every CLI ------------------------
            data_dir = os.path.join(tmp, "data")
            csv_path = os.path.join(data_dir, "processed_asimow_dataset.csv")
            synthetic.write_synthetic_csv(csv_path, seed=SEED, **CLI_CSV)
            vi, labels, exp, run = load_asimow_csv(csv_path)
            log(f"cli phase: synthetic CSV of {len(vi)} cycles "
                f"({int((labels != -1).sum())} labelled) in "
                f"{len(np.unique(np.stack([exp, run], 1), axis=0))} runs "
                f"({json.dumps(CLI_CSV)})")
            common = ["--data-dir", data_dir, "--device", device]
            ckpts = os.path.join(tmp, "model_checkpoints")
            vq_best = os.path.join(ckpts, "VQ-VAE-Patch",
                                   "VQ-VAE-Patch-best.ckpt")

            # -- C2, C3. the CLIs through main, each checked ----------------
            def run_cli(name, module, extra=()):
                args = module.build_parser().parse_args(
                    CLI_ARGS[name] + list(extra) + common)
                got = [None]

                def call():
                    got[0] = module.main(args)

                secs = host_seconds(call)
                out["seconds"][name] = secs
                path, rows = newest_metrics(
                    os.path.join(tmp, "logs", "vq-vae-transformer"))
                train = [r for r in rows
                         if "train/loss" in r or "train/cl/loss" in r]
                losses = [v for r in rows for k, v in r.items()
                          if k.endswith("loss")]
                check(bool(train), f"cli {name}: no training row in {path}")
                check(all(math.isfinite(v) for v in losses),
                      f"cli {name}: a loss in {path} is not finite")
                shown = CLI_ARGS[name] + [os.path.basename(e) if os.sep in e
                                          else e for e in extra]
                log(f"cli {name}: main({' '.join(shown)}) in "
                    f"{secs:.2f} s wall; {os.path.relpath(path, tmp)}: "
                    f"{len(rows)} rows, {len(train)} training rows, losses "
                    f"{[round(v, 5) for v in losses[:6]]}...; gpu {smi}")
                return got[0]

            _, rec_test = run_cli("reconstruction",
                                  train_reconstruction_embedding)
            check(os.path.exists(vq_best) and os.path.exists(
                os.path.join(ckpts, "VQ-VAE-Patch", "last.ckpt")),
                "the VQ-VAE CLI wrote no best or last checkpoint")
            check(math.isfinite(rec_test["test/loss"]),
                  f"the VQ-VAE CLI's test: {rec_test}")
            for name, extra, ckpt in (
                    ("classification", (), "GRU-asimow-best.ckpt"),
                    ("latent MLP", ("--vqvae-model", vq_best),
                     "MLP-latent_vq_vae-best.ckpt")):
                res, test = run_cli(name, train_classification_model, extra)
                check(res.best_ckpt_path == os.path.join(
                    "model_checkpoints", ckpt)
                    and os.path.exists(os.path.join(ckpts, ckpt)),
                    f"cli {name}: no best checkpoint {ckpt}")
                check(math.isfinite(test["test/f1_score_mean"]),
                      f"cli {name}: test {test}")

            # -- C3. the transformer CLI ---------------------------------
            tm_run, results = run_cli(
                "transformer", train_transformer_mtasks,
                ("--vqvae-model", vq_best))
            tr = tm_run.model
            check(sorted(results) == ["class_test", "class_test_final",
                                      "gen_test"]
                  and math.isfinite(results["gen_test"]["test/loss"])
                  and tr.seq_len == N_CYCLES * 16 + 1,
                  f"cli transformer: results {results}, T={tr.seq_len}")
            # -- C4. the JAX CLI writes no transformer checkpoint: the phase
            tr_ckpt = os.path.join(tmp, "transformer.ckpt")
            tr.save(tr_ckpt)
            log(f"cli transformer: d{tr.d_model}, {tr.n_head} heads, "
                f"{len(tr.blocks)} blocks, T={tr.seq_len}, saved by the "
                f"phase to {os.path.basename(tr_ckpt)}")

            # -- C5. the checkpoints served by the int8 scorer -------------
            pipe = WeldingQualityPipeline.from_checkpoints(
                vq_best, tr_ckpt, n_cycles=N_CYCLES, max_batch=80,
                precision="int8", encoder_impl="fused", device=device)
            # the VQ-VAE CLI's scaler: fitted on the train split's cycles
            dm = ASIMoWDataModule(task="reconstruction", n_cycles=1,
                                  val_data_ids=ids["val_ids"],
                                  test_data_ids=ids["test_ids"],
                                  data_directory_path=data_dir)
            dm.setup()
            pipe.scaler = dm.scaler
            # calibration: the first N_CALIB windows of the train runs
            held_out = {tuple(v) for v in (*ids["val_ids"], *ids["test_ids"])}
            calib = []
            for e, r in np.unique(np.stack([exp, run], 1), axis=0):
                if (int(e), int(r)) in held_out:
                    continue
                cyc = dm.scaler.transform(vi[(exp == e) & (run == r)])
                calib += [cyc[s:s + N_CYCLES].reshape(N_CYCLES * CYCLE_LEN, 2)
                          for s in range(0, len(cyc) - N_CYCLES + 1,
                                         N_CYCLES)]
            pipe.calibrate(np.stack(calib[:N_CALIB]))
            art = pipe.save_artifact(os.path.join(tmp, "artifact"))
            argv = ["--artifact", art, "--data-path", csv_path,
                    "--stride", "1", "--device", device]
            parser = score_quality.build_parser()
            kernel_out = os.path.join(tmp, "scores.csv")
            plain_out = os.path.join(tmp, "scores_plain.csv")
            secs = [0.0]

            def score():
                secs[0] = host_seconds(lambda: score_quality.main(
                    parser.parse_args(argv + ["--out", kernel_out])))

            # -- C6. the kernels the scorer launched -------------------------
            _, counts = counted(score)
            check(set(counts) == {ENC, ATTN, GEMM}
                  and all(n > 0 for n in counts.values()),
                  f"the scorer on the trained checkpoints launched "
                  f"{json.dumps(counts)}, expected {ENC}, {ATTN}, {GEMM}")
            for name in (ENC, ATTN, GEMM):
                out["launches"][name] = (
                    "cli_phase: score_quality on the CLIs' checkpoints",
                    counts[name])
            # -- C7. the same artifact on the plain path: the label gate ----
            _, plain_counts = counted(on_plain_path(
                lambda: score_quality.main(
                    parser.parse_args(argv + ["--out", plain_out]))))
            check(plain_counts == {},
                  f"the plain scorer launched {json.dumps(plain_counts)}")
            rows, plain = read_scores(kernel_out), read_scores(plain_out)
            check([r[:3] for r in rows] == [r[:3] for r in plain]
                  and len(rows) == int(np.maximum(np.unique(
                      np.stack([exp, run], 1), axis=0,
                      return_counts=True)[1] - N_CYCLES + 1, 0).sum()),
                  "the scorer's windows differ from the plain scorer's, or "
                  "from the CSV's")
            p = np.array([[float(r[4]), float(r[5])] for r in rows])
            q = np.array([[float(r[4]), float(r[5])] for r in plain])
            check(bool((np.abs(p.sum(1) - 1) <= 1e-4).all()
                       and (np.abs(q.sum(1) - 1) <= 1e-4).all()),
                  "p_bad + p_good is not within 1e-4 of 1")
            margin = np.abs(np.log(np.maximum(q[:, 0], 1e-6))
                            - np.log(np.maximum(q[:, 1], 1e-6)))
            sure = margin > LABEL_MARGIN
            lab = np.array([r[3] for r in rows])
            plain_lab = np.array([r[3] for r in plain])
            check(bool((lab == plain_lab)[sure].all()),
                  f"the scorer's labels differ from the plain path's on "
                  f"{int((lab != plain_lab)[sure].sum())} windows outside "
                  f"the {LABEL_MARGIN} logit margin")
            # -- C8. times ---------------------------------------------
            out["windows_per_s"] = len(rows) / secs[0]
            log(f"cli score_quality (int8, encoder_impl='fused') on the "
                f"CLIs' checkpoints: {len(rows)} windows of {N_CYCLES} "
                f"cycles at --stride 1 in {secs[0]:.2f} s, "
                f"{out['windows_per_s']:.1f} windows/s end to end (artifact "
                f"load, CSV parse, scaling, classify, writing); launches "
                f"{json.dumps(counts)}; labels equal the plain path's on "
                f"all {int(sure.sum())} windows with a logit margin above "
                f"{LABEL_MARGIN} ({int((lab != plain_lab).sum())} differ "
                f"within it), worst |dp| {float(np.abs(p - q).max()):.3e}, "
                f"{int((lab == '0').sum())} flagged bad; the plain path "
                f"outside the margin: {int((plain_lab[sure] == '0').sum())}"
                f" bad, {int((plain_lab[sure] == '1').sum())} good; "
                f"gpu {smi}")
            # a label gate held on one class would be met by any model
            # that labels every window alike
            check(len(set(plain_lab[sure])) == 2,
                  f"cli phase: the plain path labels all {int(sure.sum())} "
                  f"windows outside the margin alike")
        finally:
            os.chdir(cwd)
    log(f"cli phase: {time.perf_counter() - t_phase:.1f} s (CLIs "
        + ", ".join(f"{k} {v:.2f} s" for k, v in out["seconds"].items())
        + f"); gpu {smi}")
    return out


# -- the parallel paths and TS2Vec ------------------------------------------

# parallel_phase: the transformer at the CLI's widths (TRAIN_TR) on
# windows of T=321 and the VQ-VAE at TRAIN_VQ, a few Trainer steps each
PAR_TR_WINDOWS, PAR_TR_BATCH = 64, 16      # 4 optimizer steps
PAR_VQ_CYCLES, PAR_VQ_BATCH = 1024, 256    # 4 optimizer steps
PAR_REQUEST = 37                           # windows of the served request
PAR_GLOO_BATCH = 8                         # the gloo ranks' global batch
PAR_RING = (2, 8, 320, 64)                 # ring attention's (B, H, T, D)
MAX_PAR_LOSS = 1e-5        # gloo ranks against one process: the loss
MAX_PAR_GNORM_REL = 1e-4   # and the global gradient norm
MAX_PAR_FWD = 1e-5         # TP forward, and TP x 1 / PP x 1 weights
MAX_PAR_GRAD = 1e-4        # PP gradients
MAX_RING_ERR = 1e-4        # the JAX dryrun's bound
MAX_REPLICA_PROB = 1e-6    # a serving mesh's probabilities
# ts2vec_phase: TS2Vec's defaults on single synthetic cycles
TS2VEC_SERIES, TS2VEC_ITERS = 256, 8
MAX_TS2VEC_ERR = 1e-4      # the card's representations against the CPU's


def nccl_version() -> str:
    import torch
    v = torch.cuda.nccl.version()
    return ".".join(map(str, v)) if isinstance(v, tuple) else str(v)


NCCL_CALLS = ("all_reduce", "broadcast", "all_gather", "all_gather_object")


@contextlib.contextmanager
def collective_calls():
    """{name: calls} of the torch.distributed collectives in NCCL_CALLS
    made inside the block (the port's parallel/mesh.py calls them
    through the module, so wrapping its attributes counts them)."""
    import torch.distributed as dist
    calls, saved = {}, {name: getattr(dist, name) for name in NCCL_CALLS}

    def counting(name, fn):
        def call(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return call
    for name, fn in saved.items():
        setattr(dist, name, counting(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def parallel_phase(smi: str, device: str = "cuda") -> dict:
    """The port's parallel/ paths on one card. First an NCCL world of
    size 1 (this process): `Trainer(mesh=)` fits of the transformer at
    the CLI's widths with attention_impl='pallas' (#9) and of the
    VQ-VAE with vq_impl='pallas' (#7), each bit-equal to the
    one-process fit; the same fit tensor-parallel x 1 and pipelined x 1
    (the same code as more ranks run); int8 serving ('attn',
    encoder_impl='fused': #1, #2, the int8 GEMM) over a one-device
    mesh, bit-equal to the mesh-less pipeline; a sharded checkpoint
    round trip. Then two gloo ranks on the one card (NCCL refuses two
    ranks on one GPU): a data-parallel step, a tensor-parallel forward,
    a pipelined step and ring attention, each against the one-process
    function; then a serving mesh of two replicas on the card. Returns
    {"launches": {kernel: (path, launches)}, "seconds": ...}."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.entry import build
    from vq_vae_transformer_arc_welding_tpu_torch.models import (
        TransformerDecoder, VQVAEPatch)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.attention import (
        causal_attention_core)
    from vq_vae_transformer_arc_welding_tpu_torch.parallel import (
        jobs, launch)
    from vq_vae_transformer_arc_welding_tpu_torch.parallel.mesh import (
        make_mesh)
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline)
    from vq_vae_transformer_arc_welding_tpu_torch.train.checkpoint import (
        dense_view, load_checkpoint_sharded, model_state_dict)

    t_phase = time.perf_counter()
    dev = torch.device(device)
    log(f"parallel phase: torch {torch.__version__}, NCCL {nccl_version()}; "
        f"gpu {smi}")
    out = {"launches": {}, "seconds": {}}
    rng = np.random.default_rng(SEED)
    seq_len = N_CYCLES * 16 + 1

    def transformer(**kw):
        return TransformerDecoder(
            **{**TRAIN_TR, **kw}, n_classes=258, seq_len=seq_len,
            generator=torch.Generator().manual_seed(SEED), device=dev)

    def weights_diff(a: dict, b: dict) -> float:
        return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
                   for k in b)

    tr_data = dict(x=rng.integers(0, 256, (PAR_TR_WINDOWS, seq_len)),
                   y=rng.integers(0, 258, (PAR_TR_WINDOWS, seq_len)),
                   cond=rng.integers(0, 2, (PAR_TR_WINDOWS,)))
    tr_fit = dict(spec=jobs.model_spec(transformer(),
                                       attention_impl="pallas"),
                  task="gen", data=tr_data, batch_size=PAR_TR_BATCH,
                  epochs=1, seed=SEED, optimizer="transformer")
    # without dropout for the pipeline: its microbatches draw their own
    # masks, so only the dropout-free fit is the dense one's function
    pp_fit = dict(tr_fit, spec=jobs.model_spec(transformer(res_dropout=0.0),
                                               attention_impl="pallas"))
    vq_model = VQVAEPatch(**TRAIN_VQ, generator=torch.Generator(
        ).manual_seed(SEED), device=dev)
    vq_fit = dict(spec=jobs.model_spec(vq_model, vq_impl="pallas"),
                  task="reconstruction",
                  data=dict(x=rng.standard_normal(
                      (PAR_VQ_CYCLES, CYCLE_LEN, 2)).astype(np.float32)),
                  batch_size=PAR_VQ_BATCH, epochs=1, seed=SEED, lr=1e-3)

    # -- P1. one rank: NCCL at world size 1 ---------------------------------
    t0 = time.perf_counter()
    one = {name: jobs.fit(None, **kw, device=dev)
           for name, kw in (("transformer", tr_fit), ("VQ-VAE", vq_fit),
                            ("transformer without dropout", pp_fit))}
    vq, tr = build(seed=SEED)
    calib = rng.standard_normal((N_CALIB, N_CYCLES * CYCLE_LEN, 2)).astype(
        np.float32)
    req = rng.standard_normal((PAR_REQUEST, N_CYCLES * CYCLE_LEN, 2)).astype(
        np.float32)
    base = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80,
                                  precision="int8", encoder_impl="fused")
    base.calibrate(calib)
    lb, pb = base.classify(req)
    rate = base.last_saturation_rate
    with launch.in_process(make_mesh(1, 1, devices=[dev])) as mesh, \
            collective_calls() as calls:
        log(f"parallel phase: NCCL world of 1 on {mesh.device} "
            f"(backend {torch.distributed.get_backend()}) in "
            f"{time.perf_counter() - t0:.1f} s with the one-process fits")
        for name, kw, kernel in (("transformer", tr_fit, FLASH),
                                 ("VQ-VAE", vq_fit, NEAREST)):
            got, counts = counted(lambda: jobs.fit(mesh, **kw))
            check(counts.get(kernel, 0) > 0,
                  f"Trainer(mesh=) {name}: {kernel} not launched "
                  f"({json.dumps(counts)})")
            out["launches"][kernel] = (f"Trainer(mesh=) {name}",
                                       counts[kernel])
            diff = weights_diff(got["state_dict"], one[name]["state_dict"])
            check(diff == 0.0 and [h["train_epoch/loss"] for h in
                                   got["history"]]
                  == [h["train_epoch/loss"] for h in one[name]["history"]],
                  f"Trainer(mesh=) {name} is not the one-process fit: "
                  f"weights differ by {diff}")
            log(f"parallel: Trainer(mesh=) {name} bit-equal to one process "
                f"over {len(got['history'])} epoch(s); launches "
                f"{json.dumps(counts)}")
        tp = jobs.fit(mesh, **tr_fit, param_rules=True)
        diff = weights_diff(tp["state_dict"], one["transformer"]["state_dict"])
        check(diff <= MAX_PAR_FWD, f"TP x 1 fit: weights differ by {diff}")
        pp = jobs.run_jobs(mesh, [("pp", "fit", dict(
            pp_fit, pipeline=2, layout=((1, 1), ("data", "pipe"))))])["pp"]
        diff_pp = weights_diff(pp["state_dict"],
                               one["transformer without dropout"]
                               ["state_dict"])
        check(diff_pp <= MAX_PAR_FWD, f"PP x 1 fit: weights differ by "
                                      f"{diff_pp}")
        log(f"parallel: tensor-parallel x 1 fit within {diff:.3e}, "
            f"pipelined x 1 (2 microbatches) within {diff_pp:.3e} of the "
            f"one-process fit's weights")
        # int8 serving over a one-device mesh against the mesh-less one
        meshed = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES,
                                        max_batch=80, precision="int8",
                                        encoder_impl="fused", mesh=mesh)
        meshed._set_calibration(base._act_absmax)
        (lm, pm), counts = counted(lambda: meshed.classify(req))
        check(set(counts) == {ENC, ATTN, GEMM},
              f"mesh serving launched {sorted(counts)}")
        for kernel, n in counts.items():
            out["launches"][kernel] = ("mesh serving int8 'attn'", n)
        check(bool((lm == lb).all() and (pm == pb).all())
              and meshed.last_saturation_rate == rate,
              "mesh serving is not the mesh-less pipeline to the bit")
        log(f"parallel: int8 serving over a one-device mesh bit-equal to "
            f"the mesh-less pipeline on {PAR_REQUEST} windows (saturation "
            f"rate {rate}); launches {json.dumps(counts)}")
        with tempfile.TemporaryDirectory() as tmp:
            ck = jobs.sharded_checkpoint(mesh, tr_fit["spec"],
                                         os.path.join(tmp, "ck"))
            dense_tr = transformer()
            _, sd, _ = load_checkpoint_sharded(
                os.path.join(tmp, "ck"), (dense_view(dense_tr.state_dict()),
                                          {}))
            back = model_state_dict(sd)
            ref = transformer().state_dict()
            dense_err = max(float((back[k] - ref[k]).abs().max())
                            for k in ref if ref[k].is_floating_point())
        check(ck["max_err"] == 0.0 and dense_err == 0.0
              and len(ck["sharded"]) == 6 * TRAIN_TR["n_blocks"],
              f"sharded checkpoint: {ck['max_err']}, {dense_err}, "
              f"{len(ck['sharded'])} sharded leaves")
        log(f"parallel: sharded checkpoint (torch.distributed.checkpoint) "
            f"round trip on the card: {len(ck['sharded'])} TP leaves back "
            f"as shards, and dense in one process, bit-equal")
    # the fits above went through the collectives a node's ranks call,
    # on CUDA tensors over NCCL (a one-rank communicator): gradients and
    # train metrics (all_reduce), TP's f and g (all_reduce), the
    # pipeline's last stage (broadcast), dense weights of a TP model
    # and the gathered rows of the pipeline (all_gather), and the
    # evaluation's batches (all_gather_object). P2P send and recv need
    # a neighbour, and are not run here.
    check(all(calls.get(name, 0) > 0 for name in NCCL_CALLS),
          f"NCCL world of 1: collectives not called: {json.dumps(calls)}")
    log(f"parallel: NCCL calls in the world of 1 {json.dumps(calls)}")
    out["nccl_calls"] = dict(calls)
    out["seconds"]["nccl world 1"] = time.perf_counter() - t0

    # -- P2. two gloo ranks on the one card ---------------------------------
    t0 = time.perf_counter()
    small = transformer(res_dropout=0.0)
    spec = jobs.model_spec(small)
    ids = rng.integers(0, 256, (PAR_GLOO_BATCH, seq_len))
    labels = rng.integers(0, 258, (PAR_GLOO_BATCH, seq_len))
    q, k, v = (rng.standard_normal(PAR_RING).astype(np.float32)
               for _ in range(3))
    res = launch.run(jobs.run_jobs, make_mesh(2, 1, devices=[dev, dev]), [
        ("dp", "tp_step", dict(spec=spec, ids=ids, labels=labels,
                               layout=((2, 1), ("data", "model")))),
        ("tp", "tp_step", dict(spec=spec, ids=ids, labels=labels,
                               layout=((1, 2), ("data", "model")))),
        ("pp", "pp_step", dict(spec=spec, ids=ids, labels=labels, n_micro=2,
                               layout=((1, 2), ("data", "pipe")))),
        ("ring", "ring", dict(q=q, k=k, v=v,
                              layout=((1, 2), ("data", "model"))))],
        timeout=600)
    spawn_s = time.perf_counter() - t0
    small.requires_grad_(True)
    it, lt = (torch.as_tensor(a, device=dev) for a in (ids, labels))
    with torch.no_grad():
        ref_logits = small.apply(it).cpu().numpy()
    loss = small.loss_gen(small.apply(it), lt)
    loss.backward()
    grads = {n: p.grad.cpu().numpy() for n, p in small.named_parameters()
             if p.grad is not None}
    gnorm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                              for g in grads.values())))
    dp = res[0]["dp"]
    dp_norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                for g in dp["grads"].values())))
    check(abs(dp["loss"] - loss.item()) <= MAX_PAR_LOSS
          and abs(dp_norm - gnorm) <= MAX_PAR_GNORM_REL * gnorm,
          f"gloo DP step: loss {dp['loss']} against {loss.item()}, gradient "
          f"norm {dp_norm} against {gnorm}")
    tp_err = max(float(np.abs(r["tp"]["logits"] - ref_logits).max())
                 for r in res)
    check(tp_err <= MAX_PAR_FWD, f"gloo TP forward: {tp_err}")
    pp = res[0]["pp"]
    pp_gerr = max(float(np.abs(pp["grads"][n] - grads.get(n, 0.0)).max())
                  for n in pp["grads"])
    check(abs(pp["loss"] - loss.item()) <= MAX_PAR_LOSS
          and pp_gerr <= MAX_PAR_GRAD,
          f"gloo PP: loss {pp['loss']} against {loss.item()}, gradients "
          f"{pp_gerr}")
    ring_ref = causal_attention_core(*(torch.as_tensor(a, device=dev)
                                       for a in (q, k, v))).cpu().numpy()
    ring_err = max(float(np.abs(r["ring"] - ring_ref).max()) for r in res)
    check(ring_err <= MAX_RING_ERR, f"gloo ring attention: {ring_err}")
    log(f"parallel: two gloo ranks on {dev} (host-staged collectives): "
        f"DP 2 step loss {dp['loss']:.7f} against one process's "
        f"{loss.item():.7f}, gradient norm {dp_norm:.6g} against "
        f"{gnorm:.6g}; TP 2 forward within {tp_err:.3e}; PP 2 loss "
        f"{pp['loss']:.7f}, gradients within {pp_gerr:.3e}; ring attention "
        f"{PAR_RING} within {ring_err:.3e}; spawn and jobs "
        f"{spawn_s:.1f} s")
    # two replicas of an f32 pipeline on the one card
    f32 = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80)
    two = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80,
                                 mesh=make_mesh(2, 1, devices=[dev, dev]))
    la, pa = f32.classify(req)
    lt2, pt2 = two.classify(req)
    perr = float(np.abs(pa - pt2).max())
    check(bool((la == lt2).all()) and perr <= MAX_REPLICA_PROB,
          f"two-replica serving: labels equal {bool((la == lt2).all())}, "
          f"probabilities {perr}")
    log(f"parallel: two serving replicas on {dev}: labels equal on "
        f"{PAR_REQUEST} windows, probabilities within {perr:.3e}")
    out["seconds"]["gloo x 2"] = time.perf_counter() - t0
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"parallel phase: {out['seconds']['phase']:.1f} s (NCCL world 1 "
        f"{out['seconds']['nccl world 1']:.1f} s, gloo x 2 "
        f"{out['seconds']['gloo x 2']:.1f} s); gpu {smi}")
    return out


def ts2vec_phase(smi: str, device: str = "cuda") -> dict:
    """TS2Vec at its defaults (hidden 64, depth 10, output 320, batch
    16) fits a few iterations on synthetic single cycles on the card
    and encodes them (full_series); the same averaged weights on the CPU
    give the same representations."""
    import torch
    from vq_vae_transformer_arc_welding_tpu_torch.data import synthetic
    from vq_vae_transformer_arc_welding_tpu_torch.data.asimow import (
        CYCLE_LEN, load_asimow_csv)
    from vq_vae_transformer_arc_welding_tpu_torch.ts2vec import TS2Vec

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "processed_asimow_dataset.csv")
        synthetic.write_synthetic_csv(csv_path, seed=SEED,
                                      n_cycles_per_run=TS2VEC_SERIES // 16,
                                      extra_train_runs=0)
        cycles = load_asimow_csv(csv_path)[0][:TS2VEC_SERIES]
    data = np.asarray(cycles, np.float32).reshape(-1, CYCLE_LEN, 2)
    data = (data - data.mean((0, 1))) / data.std((0, 1))
    with tf32_flags(matmul=False, cudnn=False):
        model = TS2Vec(input_dims=2, seed=SEED, device=device)
        t0 = time.perf_counter()
        losses = []
        model.after_iter_callback = lambda m, loss: losses.append(loss)
        model.fit(data, n_iters=TS2VEC_ITERS)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = model.encode(data, encoding_window="full_series")
        enc_s = time.perf_counter() - t0
        cpu = TS2Vec(input_dims=2, seed=SEED, device="cpu")
        cpu.avg_net.load_state_dict(model.avg_net.state_dict())
        ref = cpu.encode(data, encoding_window="full_series")
    err = float(np.abs(rep - ref).max())
    check(rep.shape == (len(data), 320) and bool(np.isfinite(rep).all())
          and bool(np.isfinite(losses).all()),
          f"TS2Vec: representations {rep.shape}, losses {losses}")
    check(err <= MAX_TS2VEC_ERR, f"TS2Vec: card against CPU {err}")
    seconds = time.perf_counter() - t_phase
    log(f"ts2vec phase: {len(data)} cycles {data.shape[1:]}, {TS2VEC_ITERS} "
        f"iterations at batch {model.batch_size} in {fit_s:.2f} s (losses "
        f"{[round(x, 4) for x in losses]}), full_series encode "
        f"{rep.shape} in {enc_s:.3f} s, within {err:.3e} of the CPU's; "
        f"phase {seconds:.1f} s; NCCL {nccl_version()}; gpu {smi}")
    return {"seconds": seconds}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    from vq_vae_transformer_arc_welding_tpu_torch import kernels
    from vq_vae_transformer_arc_welding_tpu_torch.entry import (
        build, make_pipeline, make_pipeline_quantized)
    from vq_vae_transformer_arc_welding_tpu_torch.models.quantized import (
        qdot, quantized_classify)
    from vq_vae_transformer_arc_welding_tpu_torch.ops import (
        fused_attn as fflash, fused_attn_quant as fattn,
        fused_block_quant as fbq, fused_encoder as fenc,
        fused_mlp_quant as fmlp, fused_vq as fvq)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.int8 import (
        int8_matmul, quantize_act)
    from vq_vae_transformer_arc_welding_tpu_torch.ops.norm import layer_norm
    from vq_vae_transformer_arc_welding_tpu_torch.ops.patching import patchify
    from vq_vae_transformer_arc_welding_tpu_torch.ops.vq import nearest_codes
    from vq_vae_transformer_arc_welding_tpu_torch.serve import (
        CYCLE_LEN, WeldingQualityPipeline, with_start_token)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power()
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    dev = torch.device("cuda")

    # -- 1. build the kernels from csrc/ ------------------------------------
    t0 = time.perf_counter()
    ptxas = ptxas_start()
    kernels.library()
    log(f"build: kernels from {kernels.SRC_DIR.name}/ ready in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas_report(ptxas)

    # -- 2. the bench model at full width, random weights from SEED --------------
    t0 = time.perf_counter()
    vq, tr = build(seed=SEED)
    check(vq.codebook.device.type == "cuda" and tr.pe.device.type == "cuda",
          "build() without a device did not build on the card")
    k = vq.num_embeddings
    n_params = sum(p.numel() for m in (vq, tr) for p in m.parameters())
    log(f"model: VQ-VAE hidden {vq.hidden_dim}, {vq.n_resblocks} resblocks, "
        f"K={k}, D={vq.embedding_dim}; transformer d{tr.d_model}, "
        f"{tr.n_blocks} blocks, {tr.n_head} heads, T={tr.seq_len}; "
        f"{n_params} parameters; built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    width = N_CYCLES * CYCLE_LEN
    calib = rng.standard_normal((N_CALIB, width, 2)).astype(np.float32)
    reqs = [rng.standard_normal((n, width, 2)).astype(np.float32)
            for n in REQUESTS]

    with torch.no_grad():
        cyc = torch.from_numpy(reqs[0]).to(dev).reshape(-1, CYCLE_LEN, 2)
        used = torch.unique(vq.encode_indices(cyc)).numel()
        log(f"codebook: U(+-1/K) init uses {used} of {k} codes on request 0")
        if used < MIN_DISTINCT_FRAC * k:
            z = vq.encode(cyc)
            factor = float(z.std() / vq.codebook.std())
            vq.codebook.mul_(factor)
            used = torch.unique(vq.encode_indices(cyc)).numel()
            log(f"codebook: scaled by {factor:.6g} to the spread of z_e; "
                f"now {used} of {k} codes")
        check(used >= MIN_DISTINCT_FRAC * k,
              f"only {used} of {k} codes in use: the argmin is not exercised")

    # -- 3. the serving pipeline, calibrated on 8 windows -----------------------
    pipe = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80,
                                  precision="int8", encoder_impl="fused")
    t0 = time.perf_counter()
    am = pipe.calibrate(calib)
    log(f"calibrate: {len(am)} activation sites on {N_CALIB} windows in "
        f"{time.perf_counter() - t0:.1f} s")
    for n, r in zip(REQUESTS, reqs):
        ids = pipe.encode_tokens(r)
        log(f"request of {n}: ids {ids.shape}, "
            f"{np.unique(ids).size} distinct ids")

    # -- 4. the main path: three requests through classify ('attn') --------
    outs, counts = counted(lambda: [pipe.classify(r) for r in reqs])
    log(f"main path: classify launches {json.dumps(counts)}")
    check(set(counts) == {ENC, ATTN, GEMM},
          f"classify launched {sorted(counts)}, expected {ENC}, {ATTN} and "
          f"{GEMM}")
    n_gemm = 2 * tr.n_blocks * len(reqs)
    check(counts[GEMM] == n_gemm,
          f"classify launched {GEMM} {counts[GEMM]} times, expected two a "
          f"block: {n_gemm}")
    launched = {name: ("classify", n) for name, n in counts.items()}
    for n, (labels, probs) in zip(REQUESTS, outs):
        check(labels.shape == (n,) and probs.shape == (n, 2),
              f"classify({n}) shapes {labels.shape} {probs.shape}")
        check(bool(np.isfinite(probs).all()), f"classify({n}): non-finite")
        check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)),
              f"classify({n}): probs do not sum to 1")
        check(set(np.unique(labels).tolist()) <= {0, 1},
              f"classify({n}): labels {np.unique(labels)}")
        log(f"classify({n}): label counts {np.bincount(labels, minlength=2)}"
            f", probs[0] {probs[0].tolist()}")
    log(f"saturation monitor: last rate {pipe.last_saturation_rate}")
    qp = pipe.qparams
    drift_phase(pipe, vq, tr, am, reqs[0])

    # -- 5. every int8 path end to end, against its plain path --------------
    fns = {}
    with torch.inference_mode():
        xreqs = [torch.from_numpy(r).to(dev) for r in reqs]
        for name, kw, want in PATHS:
            fn = fns[name] = make_pipeline_quantized(vq, tr, qp, **kw)
            logits, counts = counted(lambda: [fn(xr) for xr in xreqs])
            check(set(counts) == want,
                  f"path {name} launched {sorted(counts)}, expected "
                  f"{sorted(want)}")
            if GEMM in want:
                n_gemm = 2 * tr.n_blocks * len(xreqs)
                check(counts[GEMM] == n_gemm,
                      f"path {name} launched {GEMM} {counts[GEMM]} times, "
                      f"expected two a block: {n_gemm}")
            for kernel, n in counts.items():
                launched.setdefault(kernel, (name, n))
            checked = rest = 0
            max_dlogit = 0.0
            for xr, lk in zip(xreqs, logits):
                check(lk.shape == (len(xr), 2) and bool(
                    torch.isfinite(lk).all()), f"path {name}: logits")
                with plain_path():
                    lp = fn(xr)
                sure = (lp[:, 0] - lp[:, 1]).abs() > LABEL_MARGIN
                same = lk.argmax(-1) == lp.argmax(-1)
                check(bool(same[sure].all()),
                      f"path {name}: labels differ where the plain margin "
                      f"exceeds {LABEL_MARGIN}: {int((~same & sure).sum())}")
                checked += int(sure.sum())
                rest += int((~sure).sum())
                max_dlogit = max(max_dlogit, float((lk - lp).abs().max()))
            log(f"path {name}: launches {json.dumps(counts)}; labels equal "
                f"the plain path's on all {checked} windows whose plain "
                f"|logit0-logit1| > {LABEL_MARGIN}; {rest} within the "
                f"margin; max |dlogit| {max_dlogit:.3e}")

        # -- 5b. the encoder paths, each against the plain encoder ----------
        packed = fenc.pack_encoder(vq)
        edges = fenc.pack_encoder_edges(vq)
        encoders = {
            "encode_indices_fused":
                lambda c: fenc.encode_indices_fused(vq, packed, c),
            "encode_indices_fused(group_size=1)":
                lambda c: fenc.encode_indices_fused(vq, packed, c,
                                                    group_size=1),
            "encode_indices_fused_mono":
                lambda c: fenc.encode_indices_fused_mono(vq, packed, c),
            "encode_indices_fused_edges":
                lambda c: fenc.encode_indices_fused_edges(vq, packed, edges,
                                                          c),
            "encode_indices_fused_edges(group_size=2)":
                lambda c: fenc.encode_indices_fused_edges(vq, packed, edges,
                                                          c, group_size=2),
        }
        cycles = [xr.reshape(-1, CYCLE_LEN, 2) for xr in xreqs]
        plain_ids = [vq.encode_indices(c) for c in cycles]
        for name, per_encode in ENCODER_PATHS.items():
            ids, counts = counted(lambda: [encoders[name](c)
                                           for c in cycles])
            want = {kernel: n * len(cycles)
                    for kernel, n in per_encode.items()}
            check(counts == want, f"{name} launched {json.dumps(counts)}, "
                                  f"expected {json.dumps(want)}")
            for kernel, n in counts.items():
                launched.setdefault(kernel, (name, n))
            flips = [flip_rate(i, p) for i, p in zip(ids, plain_ids)]
            for i, p in zip(ids, plain_ids):
                check(i.shape == p.shape and i.dtype == torch.int32,
                      f"{name}: ids {tuple(i.shape)} {i.dtype}")
            check(max(flips) <= MAX_ID_FLIP,
                  f"{name}: id flip rate {max(flips)} against the plain "
                  f"encoder")
            log(f"encoder path {name}: launches {json.dumps(counts)} over "
                f"{len(cycles)} encodes; id flips against vq.encode_indices "
                f"{flips} (bound {MAX_ID_FLIP})")

    # -- 5c. vq_impl='pallas' through the entry points ----------------------
    vq_p, _ = build(seed=SEED, vq_impl="pallas")
    vq_p.load_state_dict(vq.state_dict())        # the scaled codebook
    f32 = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80)
    f32_p = WeldingQualityPipeline(vq_p, tr, n_cycles=N_CYCLES, max_batch=80)
    one_cycle = reqs[1].reshape(-1, CYCLE_LEN, 2)       # 740 single cycles
    entries = {
        "make_pipeline": lambda v, pl: [
            make_pipeline(v, tr)(xr).argmax(-1).cpu().numpy()
            for xr in xreqs],
        "classify": lambda v, pl: [pl.classify(r)[0] for r in reqs],
        "encode_tokens": lambda v, pl: [pl.encode_tokens(r) for r in reqs],
        "ood_score": lambda v, pl: [pl.ood_score(one_cycle)],
    }
    for name, entry_fn in entries.items():
        ref, counts = counted(lambda: entry_fn(vq, f32))
        check(counts == {}, f"{name} of the 'xla' model launched "
                            f"{json.dumps(counts)}")
        got, counts = counted(lambda: entry_fn(vq_p, f32_p))
        n_chunks = (-(-len(one_cycle) // 80) if name == "ood_score"
                    else len(reqs))
        check(counts == {NEAREST: n_chunks},
              f"{name} of the 'pallas' model launched {json.dumps(counts)}, "
              f"expected {NEAREST} x {n_chunks}")
        launched.setdefault(NEAREST, (f"vq_impl='pallas' {name}", n_chunks))
        if name == "ood_score":
            worst_diff = float(np.abs(got[0] - ref[0]).max())
            check(got[0].shape == (len(one_cycle),)
                  and bool(np.isfinite(got[0]).all()), "ood_score: values")
            check(worst_diff <= MAX_OOD_ERR,
                  f"ood_score: 'pallas' and 'xla' differ by {worst_diff}")
            note = (f"scores of {len(one_cycle)} cycles within "
                    f"{worst_diff:.3e} of the 'xla' model's (bound "
                    f"{MAX_OOD_ERR}), mean {float(got[0].mean()):.6g}")
        else:
            flips = [flip_rate(g, r) for g, r in zip(got, ref)]
            bound = MAX_ID_FLIP if name == "encode_tokens" else 0.0
            check(max(flips) <= bound,
                  f"{name}: 'pallas' and 'xla' models differ in {flips}")
            note = (f"{'ids' if name == 'encode_tokens' else 'labels'} "
                    f"differ from the 'xla' model's in {flips} of entries "
                    f"(bound {bound})")
        log(f"vq_impl='pallas' {name}: launches {json.dumps(counts)}; "
            + note)

    # -- 5d. the int8 encoder: no encoder kernel on its path ---------------------
    pipe8 = WeldingQualityPipeline(vq, tr, n_cycles=N_CYCLES, max_batch=80,
                                   precision="int8",
                                   encoder_precision="int8")
    t0 = time.perf_counter()
    pipe8.calibrate(calib)
    log(f"int8 encoder: calibrated {len(pipe8.qenc['blocks'])} resblocks "
        f"and sep_conv on {N_CALIB * N_CYCLES} cycles in "
        f"{time.perf_counter() - t0:.1f} s")
    (outs8, ids8), counts = counted(lambda: (
        [pipe8.classify(r) for r in reqs],
        [pipe8.encode_tokens(r) for r in reqs]))
    check(set(counts) == {ATTN, GEMM},
          f"the int8-encoder pipeline launched {sorted(counts)}, expected "
          f"only {ATTN} and {GEMM}")
    for n, (labels, probs), ids, r in zip(REQUESTS, outs8, ids8, reqs):
        check(labels.shape == (n,) and bool(np.isfinite(probs).all())
              and set(np.unique(labels).tolist()) <= {0, 1},
              f"int8 encoder classify({n})")
        ref_ids = f32.encode_tokens(r)
        check(ids.shape == ref_ids.shape and ids.dtype == np.int32
              and 0 <= ids.min() and ids.max() < vq.num_embeddings,
              f"int8 encoder ids of request {n}")
        log(f"int8 encoder request of {n}: ids differ from the f32 "
            f"encoder's in {flip_rate(ids, ref_ids):.4f} of entries; "
            f"label counts {np.bincount(labels, minlength=2)}")

    # -- 5e. token sampling, kernels #9, #12 and #13 ---------------------
    sampling = sampling_phase(vq, tr, pipe, reqs[0], smi)
    launched.update(sampling["launched"])

    # -- 5f. the bf16 encoder, kernel #1's compute_dtype variant -------------
    bf16 = bf16_encoder_phase(vq, tr, qp, xreqs, fns["full"], smi)
    launched.update(bf16["launched"])

    # every serving kernel; #9 on bf16 operands is the bf16 training
    # step's, checked there, encoder_wide.cu's run at hidden widths off
    # the bench model's, checked by shapes_phase, and LN+q8 alone is
    # launched by transformer_shapes_phase (on the paths, inside #2)
    wide = (WIDE, WIDE_BF16, WIDE_ENTRY, WIDE_EXIT)
    apart = {FLASH_BF16, LN_ALONE, *wide}
    check(set(launched) == set(kernels.launches) - apart,
          f"kernels no path launched: "
          f"{sorted(set(kernels.launches) - apart - set(launched))}")

    with torch.inference_mode():
        x80 = xreqs[0]

        # -- 6. kernel 1 against its plain version ---------------------------
        h = vq.patch_embed_out(x80.reshape(-1, CYCLE_LEN, 2))
        b_, p_, c_ = h.shape
        flat = h.reshape(b_ * p_, c_).contiguous()
        weights, vecs = packed
        split = packed.split          # #1's and #3's operand, made once
        nb, grp = vq.n_resblocks, fenc.group_size_for(vq.hidden_dim)
        gen = torch.Generator().manual_seed(SEED)
        bn = vecs.clone().view(nb, 2, 5, c_)
        bn[:, :, 1] = (torch.randn(nb, 2, c_, generator=gen) * 0.2).to(dev)
        bn[:, :, 2] = (torch.rand(nb, 2, c_, generator=gen) * 1.5 + 0.5).to(dev)
        bn[:, :, 3] = (torch.rand(nb, 2, c_, generator=gen) + 0.5).to(dev)
        bn[:, :, 4] = (torch.randn(nb, 2, c_, generator=gen) * 0.1).to(dev)
        bn_vecs = bn.reshape(10 * nb, c_).contiguous()
        k1_err, k1_flip = None, 0.0
        for use_bn, v in ((False, vecs), (True, bn_vecs)):
            def chain(kernel):
                y = flat
                for s0 in range(0, nb, grp):
                    s1 = min(s0 + grp, nb)
                    args = (y, weights[2 * s0:2 * s1], v[10 * s0:10 * s1])
                    y = (fenc.fused_encoder_eval(
                        *args, use_bn=use_bn, split=split[2 * s0:2 * s1])
                        if kernel else fenc.fused_encoder_eval_reference(
                            *args, use_bn=use_bn))
                return y
            yk, yp = chain(True), chain(False)
            err = float((yk - yp).abs().max())
            rel = err / float(yp.abs().max())
            z_p = vq.sep_conv(yp.reshape(b_, p_, c_)).reshape(b_ * p_, -1)
            ids_k = vq.nearest(vq.sep_conv(yk.reshape(b_, p_, c_)))
            ids_p = vq.nearest(z_p.reshape(b_, p_, -1))
            flip = flip_rate(ids_k, ids_p)
            gap = worst_flip_gap(z_p, vq.codebook, ids_k.reshape(-1),
                                 ids_p.reshape(-1))
            log(f"kernel {ENC} use_bn={use_bn}: {b_ * p_} rows x "
                f"{nb} resblocks, max abs err {err:.3e}, max rel err "
                f"{rel:.3e} (bound {MAX_CHAIN_REL}), id flips {flip:.3e} "
                f"({int((ids_k != ids_p).sum())} of {ids_k.numel()}; "
                f"bound {MAX_ID_FLIP}), each a near-tie within {gap:.3e} "
                f"of |z|^2 (bound {MAX_FLIP_GAP})")
            check(bool(torch.isfinite(yk).all()), "kernel 1: non-finite")
            check(rel <= MAX_CHAIN_REL, f"kernel 1: max rel err {rel}")
            check(flip <= MAX_ID_FLIP, f"kernel 1 id flip rate {flip}")
            check(gap <= MAX_FLIP_GAP,
                  f"kernel 1: a flipped id is no near-tie: its distance "
                  f"differs by {gap} of |z|^2")
            k1_flip = max(k1_flip, flip)
            if not use_bn:
                k1_err = err
        w0, v0, sp0 = weights[:2 * grp], vecs[:10 * grp], split[:2 * grp]
        times = {ENC: timed_in_turns({
            "kernel": lambda: fenc.fused_encoder_eval(flat, w0, v0,
                                                      use_bn=False, split=sp0),
            "plain": lambda: fenc.fused_encoder_eval_reference(
                flat, w0, v0, use_bn=False)})}
        log(f"kernel {ENC} time ({b_ * p_} x {c_}, {grp} resblocks per "
            f"call): {fmt_ms(times[ENC]['kernel'])}, plain "
            f"{fmt_ms(times[ENC]['plain'])}")

        # -- 6b. kernels 3, 4, 5 and 7 against their plain versions -----------
        # at the same 25,600 rows: #3 on block 0, #4 on the first group,
        # #5 on the last group fed the plain first group's output, #7 on
        # the plain encoder's z
        n_rows = b_ * p_
        patches = patchify(x80.reshape(-1, CYCLE_LEN, 2),
                           vq.patch_size).reshape(n_rows, vq.patch_size)
        w_pe, b_pe, w_sep, b_sep = edges
        last = (nb - 1) // grp * grp
        # #4's and #5's views of the pack's split, as the edges path
        # hands them
        sp_first, sp_final = split[:2 * grp], split[2 * last:]
        enc_err = {ENC: k1_err, RES: 0.0, ENTRY: 0.0, EXIT: 0.0, NEAREST: 0.0}
        id_flips = {ENC: k1_flip, EXIT: 0.0, NEAREST: 0.0}
        # the bench model's own operands (no BatchNorm) last: the timings
        # below reuse that pass's activations
        for use_bn, v in ((True, bn_vecs), (False, vecs)):
            first = (weights[:2 * grp], v[:10 * grp])
            final = (weights[2 * last:], v[10 * last:])
            rk = fenc.resblock_eval(flat, weights[0], weights[1], v[:10],
                                    use_bn=use_bn, split=split[:2])
            rp = fenc.fused_resblock_eval_reference(
                flat, weights[0], weights[1], v[:10], use_bn=use_bn)
            ek = fenc.fused_encoder_entry_eval(patches, w_pe, b_pe, *first,
                                               use_bn=use_bn, split=sp_first)
            ep = fenc.fused_encoder_entry_eval_reference(
                patches, w_pe, b_pe, *first, use_bn=use_bn)
            z = vq.sep_conv(fenc.fused_encoder_eval_reference(
                ep, *final, use_bn=use_bn).reshape(b_, p_, c_)).reshape(
                    n_rows, -1)
            # the random BatchNorm rows move z away from the model's
            # codebook: that pass searches K of its own z rows instead
            cb = (z[::n_rows // len(vq.codebook)][:len(vq.codebook)]
                  .contiguous() if use_bn else vq.codebook)
            xk = fenc.fused_encoder_exit_eval(ep, *final, w_sep, b_sep, cb,
                                              use_bn=use_bn, split=sp_final)
            xp = fenc.fused_encoder_exit_eval_reference(
                ep, *final, w_sep, b_sep, cb, use_bn=use_bn)
            nk = fvq.nearest_codes_pallas(z, cb)
            npl = fvq.nearest_codes_pallas_reference(z, cb)
            nxla = nearest_codes(z, cb)
            for name, yk, yp in ((RES, rk, rp), (ENTRY, ek, ep)):
                err = float((yk - yp).abs().max())
                check(bool(torch.isfinite(yk).all()) and yk.shape == yp.shape,
                      f"kernel {name}: output")
                check(err <= MAX_F32_ERR, f"kernel {name}: f32 error {err}")
                check(err <= MAX_CHAIN_REL * float(yp.abs().max()),
                      f"kernel {name}: max abs err {err} of "
                      f"{float(yp.abs().max())}")
                enc_err[name] = max(enc_err[name], err)
                log(f"kernel {name} use_bn={use_bn}: {n_rows} rows, max abs "
                    f"err {err:.3e} of {float(yp.abs().max()):.3e} (bounds "
                    f"{MAX_F32_ERR}, and {MAX_CHAIN_REL} of the magnitude)")
            for name, ik, ip in ((EXIT, xk, xp), (NEAREST, nk, npl)):
                check(ik.shape == (n_rows,) and ik.dtype == torch.int32
                      and 0 <= int(ik.min()) and int(ik.max()) < len(cb),
                      f"kernel {name}: ids")
                check(ik.unique().numel() >= MIN_DISTINCT_FRAC * len(cb),
                      f"kernel {name}: only {ik.unique().numel()} codes in "
                      f"use: the argmin is not exercised")
                flip = flip_rate(ik, ip)
                gap = worst_flip_gap(z, cb, ik, ip)
                check(flip <= MAX_ID_FLIP, f"kernel {name}: id flips {flip}")
                check(gap <= MAX_FLIP_GAP,
                      f"kernel {name}: a flipped id is no near-tie: its "
                      f"distance differs by {gap} of |z|^2")
                id_flips[name] = max(id_flips[name], flip)
                enc_err[name] = max(enc_err[name],
                                    float((ik - ip).abs().max()))
                log(f"kernel {name} use_bn={use_bn}: {n_rows} rows, id flips "
                    f"against plain {flip:.3e} (bound {MAX_ID_FLIP}), each a "
                    f"near-tie within {gap:.3e} of |z|^2 (bound "
                    f"{MAX_FLIP_GAP}), {ik.unique().numel()} distinct ids; "
                    f"against "
                    f"ops/vq.nearest_codes {flip_rate(ik, nxla):.3e}")
        v0 = vecs[:10]
        first = (weights[:2 * grp], vecs[:10 * grp])
        final = (weights[2 * last:], vecs[10 * last:])
        for name, args, kfn, pfn in (
                (RES, (flat, weights[0], weights[1], v0),
                 lambda *a, use_bn: fenc.resblock_eval(*a, use_bn=use_bn,
                                                       split=split[:2]),
                 fenc.fused_resblock_eval_reference),
                (ENTRY, (patches, w_pe, b_pe, *first),
                 lambda *a, use_bn: fenc.fused_encoder_entry_eval(
                     *a, use_bn=use_bn, split=sp_first),
                 fenc.fused_encoder_entry_eval_reference),
                (EXIT, (ep, *final, w_sep, b_sep, cb),
                 lambda *a, use_bn: fenc.fused_encoder_exit_eval(
                     *a, use_bn=use_bn, split=sp_final),
                 fenc.fused_encoder_exit_eval_reference)):
            times[name] = timed_in_turns({
                "kernel": lambda: kfn(*args, use_bn=False),
                "plain": lambda: pfn(*args, use_bn=False)})
        times[NEAREST] = timed_in_turns({
            "kernel": lambda: fvq.nearest_codes_pallas(z, cb),
            "plain": lambda: fvq.nearest_codes_pallas_reference(z, cb)})
        for name in (RES, ENTRY, EXIT, NEAREST):
            log(f"kernel {name} time ({n_rows} rows, C={c_}): "
                f"{fmt_ms(times[name]['kernel'])}, plain "
                f"{fmt_ms(times[name]['plain'])}")

        # -- 6c. how the tile fills the card, and #4 and #5 beside #1 -------
        # #1's persistent walk: the rows of each request, and the rows of
        # the whole rounds of tiles (TILE_ROWS x SMs) below them, so that
        # the last round's cost shows; #4 and #5 (#1's tile with the
        # encoder's ends) at 1 and at `grp` resblocks, beside #1 at the
        # same rows and resblocks: what the ends cost
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_window = n_rows // len(reqs[0])
        rounds = TILE_ROWS * sms
        fill_rows = sorted({m for n in REQUESTS for m in (
            n * per_window, max(n * per_window // rounds * rounds, 1))},
            reverse=True)
        ends = (w_sep, b_sep, vq.codebook)
        fill = timed_in_turns({
            **{f"#1 x{grp} {m} rows ({-(-m // TILE_ROWS)} tiles)":
               (lambda m=m: fenc.fused_encoder_eval(
                   flat[:m], *first, use_bn=False, split=sp0))
               for m in fill_rows},
            f"#4 x{grp} {n_rows} rows": lambda: fenc.fused_encoder_entry_eval(
                patches, w_pe, b_pe, *first, use_bn=False, split=sp0),
            f"#5 x{grp} {n_rows} rows": lambda: fenc.fused_encoder_exit_eval(
                flat, *first, *ends, use_bn=False, split=sp0),
            f"#1 x1 {n_rows} rows": lambda: fenc.fused_encoder_eval(
                flat, weights[:2], vecs[:10], use_bn=False, split=split[:2]),
            f"#4 x1 {n_rows} rows": lambda: fenc.fused_encoder_entry_eval(
                patches, w_pe, b_pe, weights[:2], vecs[:10], use_bn=False,
                split=split[:2]),
            f"#5 x1 {n_rows} rows": lambda: fenc.fused_encoder_exit_eval(
                flat, weights[:2], vecs[:10], *ends, use_bn=False,
                split=split[:2])})
        log(f"tile fill ({sms} SMs, {TILE_ROWS} rows a tile, a round of "
            f"tiles {rounds} rows): "
            + "; ".join(f"{name} {fmt_ms(t)}" for name, t in fill.items())
            + f"; gpu {smi}")

        # -- 7. the int8 kernels against their plain versions at B=80 -------
        # each block fed the plain stream of the block before, on the
        # bench model's activations for request 0
        ids = fenc.encode_indices_fused(vq, packed,
                                        x80.reshape(-1, CYCLE_LEN, 2))
        ids = with_start_token(ids.reshape(len(reqs[0]), -1),
                               pipe.start_token)
        xs = qp["tok_emb"][ids.long()] + tr.pe[None, :ids.shape[1]]
        nh = tr.n_head
        worst = Worst()

        def kernel_calls(attn_args, full_args, mlp_args, qkv_args,
                         causal_args):
            """Each int8 kernel's call and its plain version's."""
            return {
                ATTN: (lambda: fbq.attn_block_quant(*attn_args, n_head=nh),
                       lambda: fbq.fused_attn_block_quant_reference(
                           *attn_args, n_head=nh)),
                ATTN8: (lambda: fbq.attn_block_quant(
                    *attn_args, n_head=nh, int8_attn=True),
                    lambda: fbq.fused_attn_block_quant_reference(
                        *attn_args, n_head=nh, int8_attn=True)),
                FULL: (lambda: fbq.block_quant(*full_args, n_head=nh),
                       lambda: fbq.fused_block_quant_reference(
                           *full_args, n_head=nh)),
                FULL8: (lambda: fbq.block_quant(*full_args, n_head=nh,
                                                int8_attn=True),
                        lambda: fbq.fused_block_quant_reference(
                            *full_args, n_head=nh, int8_attn=True)),
                MLP: (lambda: fmlp.mlp_quant(*mlp_args),
                      lambda: fmlp.mlp_quant_reference(*mlp_args)),
                QKV: (lambda: fattn.qkv_attention_quant(*qkv_args,
                                                        n_head=nh),
                      lambda: fattn.qkv_attention_quant_reference(
                          *qkv_args, n_head=nh)),
                CAUSAL: (lambda: fattn.fused_causal_attention_quant(
                    *causal_args, n_head=nh),
                    lambda: fattn.causal_attention_quant_reference(
                        *causal_args, n_head=nh)),
            }

        calls = {}
        for i, blk in enumerate(qp["blocks"]):
            scales, vc, v3c, v4c = blk["block_operands"]
            w = {k: blk[k].w_int8 for k in ("c_attn", "c_proj", "c_fc",
                                             "m_proj")}
            xs = xs.contiguous()
            attn_args = (xs, w["c_attn"], w["c_proj"], scales, vc[:6], v3c)
            full_args = (xs, w["c_attn"], w["c_proj"], w["c_fc"],
                         w["m_proj"], scales, vc, v3c, v4c)
            notes = []
            for name, int8_attn in ((ATTN, False), (ATTN8, True)):
                sc = {}
                rails = torch.full(xs.shape[:2], -1, dtype=torch.int32,
                                   device=dev)
                xm_k, h8_k = fbq.attn_block_quant(
                    *attn_args, n_head=nh, int8_attn=int8_attn, scratch=sc,
                    rail_rows=rails)
                check(torch.equal(rails, (h8_k.int().abs() == 127).sum(
                    -1, dtype=torch.int32)),
                    f"{name}: rail counts differ from its own h8's")
                notes.append(f"{name}: rail counts exact "
                             f"({int(rails.sum())} of {h8_k.numel()})")
                xm_p, h8_p = fbq.fused_attn_block_quant_reference(
                    *attn_args, n_head=nh, int8_attn=int8_attn)
                sc.update(x_mid=xm_k, h8=h8_k)
                # end to end: PR 1's bounds for the f32 attention; the
                # int8 attention's x_mid is held stage by stage
                end = [worst.int8(f"{name}.end.h8", h8_k, h8_p),
                       worst.f32(f"{name}.end.x_mid", xm_k, xm_p,
                                 bound=not int8_attn)]
                notes.append(f"{name}: end to end {', '.join(end)}; stages "
                             + block_stages(worst, name, xs, sc, w, scales,
                                            vc, v3c, v4c, nh, int8_attn))
                if not int8_attn:
                    x_mid = xm_p
            for name, int8_attn in ((FULL, False), (FULL8, True)):
                sc = {}
                out_k = fbq.block_quant(*full_args, n_head=nh,
                                        int8_attn=int8_attn, scratch=sc)
                out_p = fbq.fused_block_quant_reference(
                    *full_args, n_head=nh, int8_attn=int8_attn)
                sc["out"] = out_k
                end = worst.f32(f"{name}.end.out", out_k, out_p, bound=False)
                notes.append(f"{name}: end to end {end}; stages "
                             + block_stages(worst, name, xs, sc, w, scales,
                                            vc, v3c, v4c, nh, int8_attn))
                if not int8_attn:
                    nxt = out_p
                    if i == 0:
                        gemm_calls, counted_fc, mlp = gemm_phase(
                            gemm_cases(xs, sc, w, scales, vc, v3c, v4c))
            h2 = layer_norm(x_mid, blk["ln2_scale"], blk["ln2_bias"])
            mlp_args = (h2.contiguous(), w["c_fc"], w["m_proj"], scales[2:],
                        v4c, vc[6:])
            sc = {}
            out_k = fmlp.mlp_quant(*mlp_args, scratch=sc)
            h8_p = quantize_act(h2, scales[2])
            g8_p = fmlp.fc_gelu_q8_reference(h8_p, w["c_fc"], v4c, scales[3])
            out_p = fmlp.mlp_quant_reference(*mlp_args)
            notes.append(f"{MLP}: " + ", ".join([
                worst.int8(f"{MLP}.h8", sc["h8"], h8_p),
                worst.int8(f"{MLP}.g8", sc["g8"], g8_p),
                worst.f32(f"{MLP}.out", out_k, out_p)]))
            h1 = layer_norm(xs, blk["ln1_scale"], blk["ln1_bias"]).contiguous()
            qkv_args = (h1, w["c_attn"], scales[:2], v3c)
            notes.append(f"{QKV}: " + worst.int8(
                f"{QKV}.y8", fattn.qkv_attention_quant(*qkv_args, n_head=nh),
                fattn.qkv_attention_quant_reference(*qkv_args, n_head=nh)))
            qkv = qdot(h1, blk["c_attn"]).contiguous()
            y_scale = blk["c_proj"].act_scale
            notes.append(f"{CAUSAL}: " + worst.int8(
                f"{CAUSAL}.y8", fattn.fused_causal_attention_quant(
                    qkv, y_scale, n_head=nh),
                fattn.causal_attention_quant_reference(qkv, y_scale,
                                                       n_head=nh)))
            log(f"block {i} {tuple(xs.shape)}: " + "; ".join(notes))
            if i == 0:
                calls = kernel_calls(attn_args, full_args, mlp_args,
                                     qkv_args, (qkv, y_scale))
                rails0 = torch.zeros(xs.shape[:2], dtype=torch.int32,
                                     device=dev)
                counted_attn = (lambda args=attn_args: fbq.attn_block_quant(
                    *args, n_head=nh, rail_rows=rails0))
            xs = nxt
        worst.check()
        log(f"int8 kernels: worst int8 share {json.dumps(worst.frac)}, "
            f"worst int8 step {json.dumps(worst.step)}, worst f32 err "
            f"{json.dumps(worst.err)}; bounds {MAX_INT8_DIFF_FRAC}, "
            f"{MAX_INT8_STEP}, {MAX_F32_ERR}; end to end without a bound "
            f"(downstream of an int8 step) {json.dumps(worst.free)}")
        shape = f"B={len(reqs[0])}, T={tr.seq_len}, C={tr.d_model}"
        enc_err[GEMM] = mlp.pop("err")
        calls[GEMM] = (mlp["kernel"], mlp["plain"])
        for name, (kfn, pfn) in calls.items():
            times[name] = timed_in_turns({"kernel": kfn, "plain": pfn})
            log(f"kernel {name} time ({shape}, block 0): "
                f"{fmt_ms(times[name]['kernel'])}, plain "
                f"{fmt_ms(times[name]['plain'])}")

    # -- 8. windows/s at batch 80: classify and the fused pipelines ---------
    # classify returns numpy arrays, so each call ends synchronized and
    # the events span the whole request, host work included; the
    # pipelines return device logits, and the events span their launches
    f32_labels, _ = f32.classify(reqs[0])
    def monitor_off():
        pipe.monitor_saturation = False
        try:
            return pipe.classify(reqs[0])
        finally:
            pipe.monitor_saturation = True

    cls = timed_in_turns({
        "kernel path": lambda: pipe.classify(reqs[0]),
        "kernel path, monitor off": monitor_off,
        "plain path": on_plain_path(lambda: pipe.classify(reqs[0])),
        "f32 path": lambda: f32.classify(reqs[0])})
    n80 = len(reqs[0])

    def rate(t):
        return f"{n80 / (t[0] / 1e3):.1f} windows/s at {fmt_ms(t)}"

    log(f"classify batch {n80}: " + ", ".join(
        f"{name} {rate(t)}" for name, t in cls.items())
        + f"; int8 vs f32 label agreement "
        f"{float((outs[0][0] == f32_labels).mean()):.3f}; gpu {smi}")
    with torch.inference_mode():
        for name in TIMED_PATHS:
            fn = fns[name]
            t = timed_in_turns({"kernel": lambda: fn(x80),
                                "plain": on_plain_path(lambda: fn(x80))})
            log(f"make_pipeline_quantized({name}) batch {n80}: kernel path "
                f"{rate(t['kernel'])}, plain path {rate(t['plain'])}; "
                f"gpu {smi}")

    # -- 9. the encoder paths against each other, and the edges end to end ----
    with torch.inference_mode():
        c80 = cycles[0]
        enc_times = timed_in_turns({
            "vq.encode_indices (plain)": lambda: vq.encode_indices(c80),
            **{name: (lambda fn=fn: fn(c80))
               for name, fn in encoders.items()}})
        log(f"encoder paths, {len(c80)} cycles ({n_rows} rows): "
            + "; ".join(f"{name} {fmt_ms(t)}"
                        for name, t in enc_times.items()) + f"; gpu {smi}")

        def edges_full(x):
            """encode_indices_fused_edges, then the 'full' int8
            transformer: make_pipeline_quantized('full') with the
            encoder's ends inside the kernels."""
            ids = fenc.encode_indices_fused_edges(
                vq, packed, edges, x.reshape(-1, CYCLE_LEN, 2))
            return quantized_classify(
                tr, qp, with_start_token(ids.reshape(len(x), -1),
                                         vq.num_embeddings),
                block_fusion="full")

        le, lf = edges_full(x80), fns["full"](x80)
        check(bool((le.argmax(-1) == lf.argmax(-1)).all()),
              "edges + 'full' and the 'full' pipeline disagree on labels")
        t = timed_in_turns({"edges": lambda: edges_full(x80),
                            "grouped": lambda: fns["full"](x80)})
        log(f"encode_indices_fused_edges + 'full' batch {n80}: "
            f"{rate(t['edges'])}; make_pipeline_quantized(full) "
            f"{rate(t['grouped'])}; max |dlogit| "
            f"{float((le - lf).abs().max()):.3e}; gpu {smi}")

    # -- 10. bf16 serving, artifacts, the scorer, the latent data module ------
    deployment_phase(vq, tr, pipe, f32, reqs[0], smi)

    # -- 11. the f32 attention kernels and SDPA without the host's launch ----
    fq, fk, fv = sampling["flash_qkv"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attention_fns = {
        FLASH: lambda: fflash.flash_causal_attention(fq, fk, fv),
        "scaled_dot_product_attention": lambda: sdpa(fq, fk, fv,
                                                     is_causal=True),
        **{name: calls[name][0] for name in F32_ATTENTION if name != FLASH}}
    with torch.inference_mode():
        row = in_a_row(attention_fns)
    log(f"ms per call, 10 calls in a row between two events ({shape}; #9 "
        f"and scaled_dot_product_attention on the same q, k, v): "
        + "; ".join(f"{name} {fmt_ms(t)}" for name, t in row.items())
        + f"; gpu {smi}")

    sampling_trace(tr, pipe)
    dec_bounds = {
        (name, pos): bound_of(kernel_work(
            n_rows, c_, grp, nb, vq.patch_size, vq.embedding_dim,
            vq.num_embeddings, n80, tr.seq_len, tr.n_head, SAMPLE_BATCH,
            pos)[name])
        for name in (DEC_ATTN, DEC_BLOCK) for pos in TIMED_POSITIONS}
    device_ms = decode_trace(tr, sampling["decode_operands"], dec_bounds,
                             smi)
    pipeline_trace(fns, x80)
    with torch.inference_mode():
        traced = kernel_trace(attention_fns)
    device_ms.update({name: ms for name, (ms, _, _) in traced.items()})
    for name, (ms, n_ops, kernels_of) in traced.items():
        log(f"device trace of {name} ({shape}), 10 calls: "
            + ("not measured" if ms is None else
               f"{ms:.4f} ms and {n_ops:.1f} device operations a call: "
               + "; ".join(f"{key[:50]} x {n:.1f}, {each:.4f} ms each"
                           for key, n, each in kernels_of))
            + f"; gpu {smi}")
    # #1 at the default group, #3 on block 0, #4 on the first group and
    # #5 on the last (the edges path's calls), at 25,600 rows, in one
    # trace
    work, scores_fp32, both_fp32 = (
        kernel_work(n_rows, c_, grp, nb, vq.patch_size, vq.embedding_dim,
                    vq.num_embeddings, n80, tr.seq_len, tr.n_head,
                    SAMPLE_BATCH, TIMED_POSITIONS[0], fp32_products=n)
        for n in (0, 1, 2))
    # 1b (all the resblocks in one launch, its pack's staged weights) and
    # #7 on the bench model's z and codebook in the same trace
    packed_bf = fenc.pack_encoder(vq, torch.bfloat16)
    with torch.inference_mode():
        traced = kernel_trace({
            ENC: lambda: fenc.fused_encoder_eval(
                flat, weights[:2 * grp], vecs[:10 * grp], use_bn=False,
                split=split[:2 * grp]),
            ENC_BF16: lambda: fenc.fused_encoder_eval(
                flat, packed_bf[0], vecs, use_bn=False,
                compute_dtype=torch.bfloat16, split=packed_bf.split),
            NEAREST: lambda: fvq.nearest_codes_pallas(z, cb),
            RES: lambda: fenc.resblock_eval(
                flat, weights[0], weights[1], vecs[:10], use_bn=False,
                split=split[:2]),
            ENTRY: lambda: fenc.fused_encoder_entry_eval(
                patches, w_pe, b_pe, *first, use_bn=False, split=sp_first),
            EXIT: lambda: fenc.fused_encoder_exit_eval(
                ep, *final, w_sep, b_sep, cb, use_bn=False,
                split=sp_final)})
    for name, (ms, n_ops, kernels_of) in traced.items():
        if ms is not None:
            device_ms[name] = ms
        beside = ""
        if ms is not None and name == NEAREST:
            bound, by = bound_of(work[name])
            beside = (f"; bound {bound:.4f} ms by {by} ({bound / ms:.1%} of "
                      f"the time taken)")
        if ms is not None and name in (ENTRY, EXIT, ENC_BF16) and \
                traced[ENC][0]:
            bound, by = bound_of(work[name])
            beside = (f"; {ms / traced[ENC][0]:.3f}x {ENC}'s, bound "
                      f"{bound:.4f} ms by {by} ({bound / ms:.1%} of the time "
                      f"taken)")
        what = (f"{n_rows} rows, D={z.shape[1]}, K={len(cb)}"
                if name == NEAREST else
                f"{n_rows} x {c_}, "
                f"{ {RES: 1, ENC_BF16: nb}.get(name, grp)} resblocks a launch")
        log(f"device trace of {name} ({what}), 10 calls: "
            + ("not measured" if ms is None else
               f"{ms:.4f} ms and {n_ops:.1f} device operations a call: "
               + "; ".join(f"{key[:50]} x {n:.1f}, {each:.4f} ms each"
                           for key, n, each in kernels_of))
            + beside + f"; gpu {smi}")
    times.update(sampling["times"])
    times.update(bf16["times"])
    enc_err.update({name: e for name, e in sampling["err"].items()
                    if name in RECORD})
    enc_err.update(bf16["err"])
    with torch.inference_mode():
        gemm_traced = kernel_trace({
            **{(shape, what): fn for shape, fns in gemm_calls.items()
               for what, fn in zip(("kernel", "_int_mm"), fns)},
            **{(name, "counts"): fn for name, fn in counted_fc.items()},
            (ATTN, "counted"): counted_attn})
    fc_ms = [gemm_traced[name, "counts"][0] for name in counted_fc]
    log(f"device trace of {GEMM} c_fc with and without the monitor's "
        f"counts, at its act scale (no value clipped) and at twice it, 10 "
        f"calls: " + "; ".join(f"{name} " + (
            "not measured" if ms is None else f"{ms:.4f} ms a launch")
            for name, ms in zip(counted_fc, fc_ms))
        + ("" if None in fc_ms else
           f"; with the counts {fc_ms[1] / fc_ms[0]:.3f}x and "
           f"{fc_ms[3] / fc_ms[2]:.3f}x without")
        + f"; gpu {smi}")
    ms, n_ops, kernels_of = gemm_traced[ATTN, "counted"]
    ln = [(n, each) for key, n, each in kernels_of if LN_Q8 in key]
    bound, by = bound_of(work[LN_Q8])
    log(f"device trace of {ATTN} with the monitor's counts (B={n80}, "
        f"T={tr.seq_len}, C={tr.d_model}, block 0), 10 calls: "
        + ("not measured" if ms is None else
           f"{ms:.4f} ms a call; {LN_Q8} " + (
               f"x {ln[0][0]:.1f} a call, {ln[0][1]:.4f} ms a launch, bound "
               f"{bound:.4f} ms by {by} ({bound / ln[0][1]:.1%} of the time "
               f"taken)" if ln else "not in the trace"))
        + f"; gpu {smi}")
    for shape, (nc, kc, _, _) in GEMM_SHAPES.items():
        ms, lib_ms = (gemm_traced[shape, what][0]
                      for what in ("kernel", "_int_mm"))
        bound, by = bound_of(work[f"{GEMM} {shape}"])
        log(f"device trace of {GEMM} {shape} (M={n80 * tr.seq_len}, "
            f"N={nc * c_}, K={kc * c_}), 10 calls: "
            + ("not measured" if None in (ms, lib_ms) else
               f"{ms:.4f} ms a launch, bound {bound:.4f} ms by {by} "
               f"({bound / ms:.1%} of the time taken); torch._int_mm "
               f"(s32 out, no epilogue) {lib_ms:.4f} ms, the GEMM "
               f"{ms / lib_ms:.3f}x of it")
            + f"; gpu {smi}")
    # the int8 attention of #2 and #6 (int8_attn), block 0: its two
    # launches beside their own bounds
    with torch.inference_mode():
        traced = kernel_trace({name: calls[name][0]
                               for name in (ATTN8, FULL8)})
    for name, (ms, n_ops, kernels_of) in traced.items():
        parts = []
        for part in (QUANT_PASS, INT8_ATTENTION):
            each = [e for key, _, e in kernels_of if is_kernel(key, part)]
            bound, by = bound_of(work[part])
            parts.append(f"{part} " + (
                f"{each[0]:.4f} ms a launch, bound {bound:.4f} ms by {by} "
                f"({bound / each[0]:.1%} of the time taken)" if each
                else "not in the trace"))
        if ms is not None:
            device_ms[name] = ms
        log(f"device trace of {name} (B={n80}, T={tr.seq_len}, "
            f"C={tr.d_model}, block 0), 10 calls: "
            + ("not measured" if ms is None else
               f"{ms:.4f} ms and {n_ops:.1f} device operations a call; "
               + "; ".join(parts))
            + f"; gpu {smi}")
    # -- 12. training at the CLIs' widths: #7 and #9 with gradients, in
    # f32 and bf16; #9 on bf16 operands; the classifiers, the windowed and
    # streamed data paths and the EMA VQ -------------------------------------
    training = training_phase(smi)
    flash_bf16 = flash_bf16_phase(smi)
    classification_phase(smi)
    # #9 on bf16 operands: launched by the bf16 transformer's training
    # step, held and timed at that step's shape by flash_bf16_phase
    launched[FLASH_BF16] = training["launches"][FLASH_BF16][:2]
    times[FLASH_BF16], work[FLASH_BF16] = (flash_bf16["times"],
                                           flash_bf16["work"])
    enc_err[FLASH_BF16] = flash_bf16["max_abs_err"]
    if flash_bf16["device_ms"] is not None:
        device_ms[FLASH_BF16] = flash_bf16["device_ms"]
    library_ms = {**sampling["library_ms"],
                  FLASH_BF16: flash_bf16["times"]["library"][0]}
    library_device_ms = {
        FLASH: device_ms["scaled_dot_product_attention"],
        FLASH_BF16: flash_bf16["library_device_ms"]}
    extra = {FLASH_BF16: {key: flash_bf16[key]
                          for key in ("diff_share", "shape")}}
    # -- 13. models off the bench widths, and every extended kernel there --
    widths = widths_phase(smi)
    # -- 13b. every VQ-VAE the VQ-VAE CLI can build: its hidden-1024,
    # K=1024, D=64 model served and trained a step, and every widened
    # kernel at the grid of shapes ---------------------------------------
    shapes = shapes_phase(smi)
    check(all(name in shapes["launched"] for name in wide),
          f"shapes: no path launched "
          f"{[n for n in wide if n not in shapes['launched']]}")
    for name in wide:
        launched[name] = shapes["launched"][name]
        times[name], work[name] = shapes["times"][name], shapes["work"][name]
        enc_err[name] = shapes["err"][name]
    id_flips[WIDE_EXIT] = shapes["flips"][WIDE_EXIT]
    # -- 13c. every transformer the transformer CLI can build: its d1600
    # model trained and scored, seed models at C off 64 and above 1,024
    # and heads past 128, a training step at heads of 256, and every
    # widened kernel at the grid ------------------------------------------
    tshapes = transformer_shapes_phase(smi)
    # -- 13d. the int8 attention, #9 on bf16 and the decode kernels at
    # those widths: the d1600 CLI model and the seed models through
    # 'attn8', 'full8' and fused decode, bf16 training steps, each kernel
    # alone ---------------------------------------------------------------
    narrow = narrow_widths_phase(smi, tshapes.pop("cli"))
    for name, first in narrow["launched"].items():
        tshapes["launched"].setdefault(name, first)
    for name, ran_at in narrow["held"].items():
        tshapes_at = tshapes["held"].setdefault(name, [])
        tshapes_at += [x for x in ran_at if x not in tshapes_at]
    # -- 13e. the wide attention tiles (heads past 128, in clusters) on
    # their slice's path: a d2048 model of 8 heads of 256 served and
    # trained a step, then each wide tile alone ----------------------------
    wheads = wide_heads_phase(smi)
    # -- 13f. the decode kernels' general form on its slice's path: a
    # d1800 model of 6 heads of 300 sampled through generate_kv, 'fused'
    # against 'xla', and #12 per block ------------------------------------
    wdec = wide_decode_phase(smi)
    launched[LN_ALONE] = tshapes["launched"][LN_ALONE]
    times[LN_ALONE], work[LN_ALONE] = tshapes["times"], tshapes["work"]
    enc_err[LN_ALONE] = tshapes["err"]
    if tshapes["device_ms"] is not None:
        device_ms[LN_ALONE] = tshapes["device_ms"]
    # -- 14. the training CLIs, their checkpoints scored in int8 --------
    cli = cli_phase(smi)
    # -- 15. parallel/: mesh training, serving, checkpoints; TS2Vec -------
    parallel = parallel_phase(smi)
    ts2vec_phase(smi)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SRC + src,
         "replaces": TPU + replaces, "path": launched[name][0],
         "launches": launched[name][1],
         "max_abs_err": enc_err[name] if name in enc_err
         else worst.output_err(name, OUTPUT[name]),
         **({"id_flip_rate": id_flips[name]} if name in id_flips else {}),
         "ms": times[name]["kernel"][0], "plain_ms": times[name]["plain"][0],
         "bound_ms": bound_of(work[name])[0],
         "bound_by": bound_of(work[name])[1],
         # but for #9, no single PyTorch call computes these functions
         "library_ms": library_ms.get(name),
         **({"device_ms": device_ms[name]} if name in device_ms else {}),
         **({"library_device_ms": library_device_ms[name]}
            if name in library_device_ms else {}),
         **extra.get(name, {}),
         # the widths this run held the kernel at against its plain
         # version: head widths, or the encoder's hidden widths
         **({"widths": sorted({BENCH_HIDDEN if name in F32_ENCODER
                               else BENCH_HEAD,
                               *widths["widths"][name]})}
            if name in widths["widths"] else {}),
         # the training phase's own run: its fits' launches, and a
         # training forward's
         **({"training_path": training["launches"][name][0],
             "training_launches": training["launches"][name][1],
             "training_launches_per_forward": training["launches"][name][2]}
            if name in training["launches"] else {}),
         # the shapes phase: its paths' launches, and the shapes this
         # run held the kernel at there (hidden widths or (K, D))
         **({"shapes_path": shapes["launched"][name][0],
             "shapes_launches": shapes["launched"][name][1]}
            if name in shapes["launched"] else {}),
         **({"shapes": [list(x) if isinstance(x, tuple) else x
                        for x in shapes["held"][name]]}
            if name in shapes["held"] else {}),
         # the transformer shapes phase: its paths' launches, and the C
         # or head widths this run held the kernel at there
         **({"transformer_shapes_path": tshapes["launched"][name][0],
             "transformer_shapes_launches": tshapes["launched"][name][1],
             "transformer_shapes": tshapes["held"].get(name, [])}
            if name in tshapes["launched"] else {}),
         # the wide heads phase: its paths' launches, the cluster its
         # wide tile ran in, the shapes held there and, at the path's
         # shape, its device ms a launch and SDPA's
         **({"wide_heads_path": wheads["launched"][name][0],
             "wide_heads_launches": wheads["launched"][name][1],
             "wide_heads_cluster": wheads["cluster"].get(name),
             "wide_heads_shapes": wheads["held"].get(name, []),
             "wide_heads_device_ms": wheads["device_ms"].get(name),
             "wide_heads_library_ms": wheads["library_ms"].get(name)}
            if name in wheads["launched"] else {}),
         # the wide decode phase: its paths' launches and #13's device ms
         # a launch there, and ms per token of 'xla' and 'fused'
         **({"wide_decode_path": wdec["launched"][name][0],
             "wide_decode_launches": wdec["launched"][name][1],
             "wide_decode_device_ms": wdec["device_ms"].get(name),
             **({"wide_decode_ms_per_token": wdec["ms_per_token"]}
                if name == DEC_BLOCK else {})}
            if name in wdec["launched"] else {}),
         # the CLI phase's scorer, over the checkpoints the CLIs wrote
         **({"cli_path": cli["launches"][name][0],
             "cli_launches": cli["launches"][name][1]}
            if name in cli["launches"] else {}),
         # the parallel phase: Trainer(mesh=) fits and mesh serving
         **({"parallel_path": parallel["launches"][name][0],
             "parallel_launches": parallel["launches"][name][1]}
            if name in parallel["launches"] else {})}
        for name, (src, replaces) in RECORD.items()]}
    for entry in record["kernels"]:
        name = entry["name"]
        fp32 = ""
        if name in F32_ATTENTION:
            fp32 = "; ".join(
                f"{what} {ms:.4f} ms by {by}" for what, (ms, by) in (
                    ("; the attention's scores on the FP32 cores",
                     bound_of(scores_fp32[name])),
                    ("both its products there", bound_of(both_fp32[name]))))
        elif name in F32_ENCODER:
            fp32 = ("; its products on the FP32 cores {:.4f} ms by {}"
                    .format(*bound_of(both_fp32[name])))
        log(f"kernel {name}: {entry['ms']:.4f} ms, bound "
            f"{entry['bound_ms']:.4f} ms by {entry['bound_by']} "
            f"({entry['bound_ms'] / entry['ms']:.1%} of the time taken)"
            + fp32)
    print(json.dumps(record), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
