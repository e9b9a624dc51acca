"""Card check of the PyTorch/CUDA port: builds the CUDA kernels, holds each
against its plain PyTorch version, and serves llama3-8b (under memory
pressure, on a three-node cluster with migration and failure, and
tensor-parallel on shards of the card, as yi-6b and minicpm-2b are, up to
16 shards), codeqwen1.5-7b, zamba2-2.7b, mamba2-2.7b, xlstm-1.3b and
phi-3-vision-4.2b at full width (and full depth, but where a phase below names
the depth it keeps) through the port's entry points; granite-moe-3b,
qwen3-moe-30b (12 of 48 layers) and seamless-m4t-medium prefill and decode at
full width; trains llama3-8b at full width (4 of 32 layers), holds
zamba2-2.7b's gradient at full width (12 of 54 layers) through the scan kernel
to the plain path, and holds training on the card to the CPU.

Run from the repository root on a machine with an NVIDIA card:

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 1,2,3
    python3 chip_smoke.py --phases 11,12     # B.4 and the cluster
    python3 chip_smoke.py --phases 3,4,14    # B.3, with phase 4's replay
    python3 chip_smoke.py --phases 15,16     # xlstm-1.3b
    python3 chip_smoke.py --phases 17,18,19,20   # vlm, moe, encdec
    python3 chip_smoke.py --phases 1,2,21,22     # tensor-parallel serving
    python3 chip_smoke.py --phases 23,24         # training
    python3 chip_smoke.py --phases 25            # the launcher, the roofline
    python3 chip_smoke.py --phases 21,22,26,27   # minicpm-2b at tp 16,
                                                 # codeqwen1.5-7b, mamba2-2.7b

Phases:
  1. environment: the card's name and power limit;
  2. build: nvcc for sm_90a, one process per kernel source, all started
     together, with the registers, shared memory and spills that ptxas
     reports (no instantiation of B.3 or the scan may spill);
  3. kernel 1's and B.2's bodies as ptxas built them and as the runtime
     reports them, and their machine code (every bf16 instantiation runs
     wgmma, no fp32 one a tensor-core product); kernel vs plain version at
     llama3-8b widths (H=32, Hkv=8, D=128, page 16) in bf16 and fp32:
     decode at B=8 and 32 (ctx up to 4096), chunks of 128 and 512 at
     q_offsets > 0, ctx=0 lanes, permuted tables
     with last-valid padding; the int8 kernel (B.2) at decode B=8 with 3/4
     of each lane's pages flagged and at a 512-token chunk with mixed
     flags, and with every flag clear bit-identical to the fp kernel;
     kernel 1 at D=64 (decode B=8, a 128-token chunk); times of each
     kernel, the plain version, the bound and a library yardstick, and the
     achieved TFLOP/s, share of the bound and ratio to SDPA (also in phases
     4, 6, 8 and 9, per main-path shape and summed); kernel 1 and B.2 at
     D=64 and 128 bit for bit to KERNEL1_DIGESTS; both kernels unchanged
     bit for bit when every page outside the lanes' relevant ones is NaN;
     every bf16 call's split count (``pa.chunk_split_plan``: keys split
     over a cluster where the grid is short of the card); a decode sweep
     at ctx 4096, B = 1, 8, 32, kernel 1 and B.2 with 3/4 flagged, each
     with its splits, cluster and share of the bound;
  4. serve llama3-8b (32 layers, bf16, random weights from --seed) with
     NodeEngine + NodeManager + RealBackend: 4 sessions x 3 turns, chunked
     prompts, a shared system prompt adopted across sessions with a
     copy-on-write fork.  The kernel's launches must cover every layer of
     every dispatch; a lockstep twin on the plain attention must agree;
     the main path's kernel calls are re-timed against their bound;
  5. exact tokens in fp32 (full width, 2 layers): served turns equal the
     dense prefill/decode recompute (`dense_reference`, B.4 on every layer
     of its prefills);
  6. the memory-pressure path: llama3-8b (32 layers, bf16) on a node whose
     fp byte budget (hbm_pages) is about 40 % of its sessions' pages, with
     twice that many physical pages and a disk spool: 6 sessions x 3 turns,
     advisories that make idle sessions int8 (NodeManager._quantize_pass),
     layer evictions to host, an advisory-led prefetch, cold swap-ins; the
     measured host-link bandwidths and the cold and advisory-led stalls;
     one session persisted, the node crashed and the session recovered from
     the spool by a second node on the same card, another session migrated
     to that node (export/import); both serve their next turn.  Once the
     int8 tier is active the int8 kernel must run on every layer of every
     dispatch; a lockstep twin on the plain attention must agree as in
     phase 4, and the main path's int8-kernel calls are re-timed;
  7. exact tokens in fp32 (full width, 2 layers) through the tiers: a
     session swapped out and back, persisted and recovered after a crash,
     and migrated to a third node serves the dense recompute's tokens; a
     session served from int8 pages equals a twin whose pages were
     re-materialized to fp by a host round trip;
  8. the SSD scan kernels (B.5): their runtime resources and machine code
     (no tensor-core product), then the scan against its plain version at
     zamba2-2.7b's SSD shapes (H=80, P=64, N=64, G=1) and mamba2-2.7b's
     (N=128): lanes 1, 2, 8; 1 (the decode path), 256, 513 and 1024 steps
     (the chunk path); zero and random initial state; bf16 and fp32; y and
     the final state each within 3e-2 (bf16) / 2e-4 (fp32) x max |plain|;
     timed cases (and phase 9's) with their device and host time, GB/s,
     TFLOP/s, share of the bound, the kernel's and the plain version's
     distance from float64 and the time of each device kernel.  Kernel 1
     and B.2 at zamba2-2.7b's shared attention (H=Hkv=32, D=80): decode B=8
     and a 512-token chunk;
  9. serve zamba2-2.7b (full width, 18 of its 54 Mamba2 layers: 3 of its
     9 shared applications; the depth cut pays for phases 26-27, and
     phase 27 serves mamba2-2.7b's 64 layers; bf16, random weights from
     --seed) with NodeEngine + NodeManager +
     StateBackend: 4 sessions x 3 turns, one session swapped out and back,
     one persisted, the node crashed and the session recovered from the
     spool on a second node.  At every step ssd_scan runs on every Mamba
     layer and kernel 1 on every shared application of every dispatch, and
     no plain version runs; a lockstep twin on the plain versions (and in
     float64) must agree; one more turn on a fresh node runs under
     torch.profiler (device time by kernel family, idle share); the main
     path's kernel calls are re-timed;
 10. exact tokens in fp32 (zamba2 at full width, 12 Mamba layers, 2 shared
     applications) through swap-out/in, eviction and promotion, and spool
     recovery after a crash: the dense prefill/decode recompute's tokens;
 11. the prefill kernel (B.4): its two bodies as ptxas built them and as
     the runtime reports them (registers, spills, shared memory, CTAs per
     SM), and their machine code (the bf16 body runs wgmma, the fp32 body
     no tensor-core product); the fp32 body's outputs bit for bit to
     FLASH_FP32_DIGESTS; then B.4 against its plain version at llama3-8b
     widths in bf16 and fp32: one lane at Sq = Skv in {1, 100, 512, 1568,
     4096}, two lanes of 256 tokens at q_offset 512 over 1024 keys
     (padding past 768), and that continuation as kernel 1's input
     (identity tables), where kernel 1 must agree; times against the
     bound and SDPA, achieved TFLOP/s and share of the bound;
 12. llama3-8b (32 layers, bf16) on a three-node `ClusterRuntime` in real
     mode: (a) 2 sessions x 3 turns of 512-token prompts, a turn-2
     advisory that migrates a session to the idle node, and the node that
     served s0's turn 2 failed and its session recovered from the spool;
     (b) on a fresh cluster a shared-prefix cohort of 4 routed to its
     donor's node.  Then the full-history recompute (`dense_reference`) of
     both traces, B.4 on every layer of every prefill, held against its
     plain and float64 twins; the cluster's turns against the reference's
     (flips held to the tolerance), and the prefill tokens of both;
 13. exact tokens in fp32 through the cluster: phase 12(a) with llama3-8b
     at full width and 2 layers, and a mixed cluster (2 of that llama, 2
     mamba2-2.7b at full width and 4 layers) whose recurrent session
     migrates and whose node fails: each session equals its family's dense
     reference;
 14. the decode kernel (B.3) against its plain version and against kernel 1
     at Sq = 1 on the same inputs, at llama3-8b widths (H=32, Hkv=8, D=128,
     page 16) in bf16 and fp32: decode at B = 1, 8 and 32 with ctx up to
     4096, ctx = 0 lanes (exact zeros), permuted tables with last-valid
     padding; zamba2-2.7b's shared attention (H=Hkv=32, D=80) and a G = 1
     case at D = 64; B.3's runtime resources and machine code first; times
     of B.3 (ms, device, host), kernel 1 at Sq = 1 (ms, device), the plain
     version, SDPA and the bound, summed per dtype and over the replayed
     calls.  Then every decode-only kernel-1 call phase 4
     captured, replayed through B.3 and held against kernel 1; each B.3
     call here adds exactly one to its count, and the count over every
     other phase (the serving paths, which decode through kernel 1) must
     stay 0;
 15. serve xlstm-1.3b (full width, 16 of its 48 blocks: 2 of its 6 groups
     of 7 mLSTM + 1 sLSTM, the depth cut paying for phases 26-27; bf16,
     random weights from --seed) with NodeEngine + NodeManager +
     StateBackend and 8 slots: 4 sessions x 3 turns of 256-1024 tokens, one
     session swapped out and back cold and one advisory-led (both stalls
     and the bytes moved), one persisted, the node crashed and the session
     recovered from the spool by a second node; each session's first turn
     against the dense prefill/decode recompute (phase 12's flip rule); the
     sLSTM scan's share of a 512-token prefill step;
 16. exact tokens in fp32 (xlstm at full width, 8 blocks) through a swap,
     a spool recovery after a crash and an export/import migration to a
     third node: the dense prefill/decode recompute's tokens;
 17. phi-3-vision-4.2b (full width, 8 of its 32 layers, the depth cut
     paying for phases 26-27; bf16, H = Hkv = 32, D = 96): (a) a
     prefill of 576 random 1024-d patch embeddings and 128 tokens at B = 2,
     B.4 at D = 96 on every layer, its input held against the plain
     version and timed; (b) phase 4's serve through `make_backend`'s
     RealBackend (kernel 1 at D = 96 on every layer of every dispatch,
     the lockstep twins, the main path's calls re-timed); (c) one pass of
     phase 6's pressure rounds (4 sessions x 3 turns, no host link, spool
     or migration): B.2 at D = 96 on every layer once the int8 tier is
     active, held and re-timed as in phase 6;
 18. granite-moe-3b-a800m (32 layers, 40 experts padded to 48, top-8) and
     qwen3-moe-30b-a3b at full width and 12 of its 48 layers (128 experts,
     D = 128, G = 8, qk-norm), bf16: a prefill of B = 2 x 512 tokens with
     B.4 at G = 3 and G = 8 on every layer (held and timed), 16 greedy
     decode steps, and the shares of expert assignments dropped by
     capacity and dumped by the reference's last-write rule;
 19. seamless-m4t-medium (12 + 12 layers, vocab 256206, bf16): encode 2 x
     256 random frames, prefill 64 decoder tokens (B.4 at D = 64, G = 1 on
     the decoder's layers, held and timed), 16 greedy decode steps;
 20. exact tokens in fp32 at full width and 2 layers (2 + 2 for
     seamless): phi-3-vision (with patches), both MoE models and
     seamless-m4t greedy for 16 tokens with the kernels equal
     kernel_mode="ref"; phi-3-vision served through RealBackend with a
     swap-out between turns equals the dense recompute;
 21. tensor-parallel serving on a mesh whose shards all live on the card
     (`make_serving_mesh(tp, devices=["cuda:0"] * tp)`), bf16, full width,
     random weights from --seed (llama3-8b and yi-6b at 8 of their 32
     layers, the depth cut paying for phases 26-27; minicpm-2b at its
     40): phase 4's traffic on llama3-8b at tp 2
     and 4 (the kv-head rung: kernel 1 on each shard's 16 or 8 q heads
     over its 4 or 2 kv heads) and on yi-6b (Hkv = 4) at tp 8 (the
     split-K rung: each shard holds 2 rows of every 16-row page, and in a
     second pass 1 row of every 8-row page, and runs kernel 1's partial
     mode for all 32 heads, its keys cut into splits; every shard's and
     split's float32 partials merged by their log-sum-exp in one merge
     launch a call), and at tp 16, page 8 (the head-feature rung: each
     shard holds 8 of the 128 features of every row; the shards share the
     card, so one launch a layer computes the full heads from the 16
     pools, kernel 1 loading each key row's features from them by TMA),
     and on minicpm-2b (MHA, 36 heads of 64, 40 layers, tied embeddings,
     vocab 122753) at tp 16, page 8 (the head-feature rung at 4 of the 64
     features a shard, where kernel 1 gathers them by cp.async), each
     against the single device: where the tokens first diverge, and the
     first traced logits within 2e-2 x max|logits| (or twice the
     kernel-vs-plain floor); launches one a layer, shard and sub-dispatch
     (one a layer and sub-dispatch on the head-feature rung), merges one
     a layer and sub-dispatch on the split-K rung; the memory each run
     reckons, holds and gives back.  A pressure pass (phase 6's rounds, 4
     sessions x 3 turns, and a turn of a session compressed just before
     it; full width, 8 layers) at tp 2 on llama3-8b, at tp 8 and tp 16,
     page 8 on yi-6b and at tp 16, page 8 on minicpm-2b: B.2, its partial
     mode and its feature route (by TMA and by the gather) on lanes that
     read int8 pages.  Every partial call shape held
     against its plain version shard by shard (its splits combined), the
     merge kernel against the plain merge, timed per shard (the slowest
     shard too) and summed with the merge, beside the unsplit kernel on
     the same call and SDPA on the gathered K/V; every feature call shape
     held through both routes: the one-launch route against its plain
     version and bit-equal to kernel 1 / B.2 on the concatenated pools,
     replayed with the shards' pools in one allocation as the main path
     holds them (so by the producer the main path took, checked on every
     call: TMA at yi-6b's dr 8, the cp.async gather at minicpm-2b's dr
     4), and where TMA is open by both producers,
     each bit-equal and timed; and the per-shard route of shards on distinct cards (F1 summing the
     shards' partial scores into one float32 buffer, F2 each shard's
     softmax times its V features) with F1's summed scores and each
     shard's F2 against their plain versions, both timed (wall, device,
     host) beside the unsplit kernel, SDPA and each route's bound;
     kernel 1's per-shard shapes at tp 4 and B.2's at tp 2 re-timed;
 22. exact fp32 tokens at full width and 2 layers on the mesh: llama3-8b
     at tp 1, 2 and 4, yi-6b at tp 8 (and at tp 8 with page 8: 1-row
     shard pages) and at tp 16 with page 8, and minicpm-2b at tp 16 with
     page 8 (the head-feature rung at dr 8 and dr 4: its one-launch
     route, and its per-shard route with the shards taken as on distinct
     cards), with a mid-decode preemption (a swap-out and back),
     equal to the single device's and to kernel_mode="ref"; a session
     exported at tp 2 resumes at tp 4; one payload imported and quantized
     on one device and on each mesh: int8 scales and codes bit-equal to
     one device's at the same page size, and its next turn read from the
     int8 pages gives the same tokens;
 23. training at full width: llama3-8b at its published widths, bf16,
     random weights from --seed, its depth cut to 4 of 32 layers (its
     training state, ~20 bytes a parameter, would not fit one card at 32),
     6 `make_train_step` steps (2 microbatches, AdamW's default lr) on one
     repeated batch of 8 x 1024 tokens and a 7th under torch.profiler:
     every loss finite, the last below the first, every parameter leaf
     given a gradient; step ms, tokens/s, the model-FLOPs share, peak
     memory, the profiled step's device time by kernel family, its largest
     kernels and idle share, and one AdamW update timed alone; then
     zamba2-2.7b at its published widths, 12 of 54 Mamba layers: loss and
     gradient on 2 x 1024 tokens in bf16 and float32 with the CUDA scan
     forward (2 launches a Mamba layer, counted from 0), each held per
     leaf to kernel_mode="ref" (float32: 2e-4 of max |g| or twice plain's
     own distance at half the chunk; bf16: plain bf16's distance from
     float32);
 24. training held at reduced size, float32: llama3-8b and zamba2-2.7b
     take 3 `make_train_step` steps (2 microbatches) on the card and on the
     CPU from the same weights and batches, losses within 1e-4 relative;
     the hybrid's gradients with the CUDA scan forward (ssd_scan launched
     on every Mamba layer of every forward and recompute) within 2e-4 of
     max |g| per leaf of the all-plain path's; a checkpoint written on the
     card restores on the CPU bit for bit; `train()` run to step 6 and
     rerun to step 8 takes exactly 2 steps; the scan under autograd at
     zamba2-2.7b's SSD shapes, y and the gradients of sum(y²) with the
     kernel's forward held to the plain's (2e-4 of max |plain|), both
     timed;
 25. the launchers and the roofline counter: (a) `launch.serve`'s
     simulation at paper scale (llama3-8b, 8 nodes, 256 users) for
     symphony and stateless, host only; (b) `launch.serve --real` on the
     card (llama3-8b at full width, 2 layers, fp32, on 3 nodes with a
     migration and a failure): its own checks, kernel 1 on every layer of
     every dispatch, B.4 on every layer of the dense reference's prefills,
     no plain call; (c) run with phases 4, 6 and 12 on their llama3-8b (32
     layers, bf16): phase 4's first two rounds served, their largest
     chunked-prefill step and largest decode step replayed under
     `roofline.cost.count` through the kernels and through the plain
     versions, which must be charged identical work; each step's counted
     FLOPs and bytes, bound, device time (torch.profiler), host wall time
     and share of the bound;
 26. codeqwen1.5-7b (32 layers, MHA: 32 heads of 128, d_ff 13440, bf16,
     random weights from --seed) at full width and depth on one card:
     phase 4's serve, checks and re-timing (kernel 1 at G = 1, D = 128),
     then one pressure pass of phase 6's rounds at full depth (4 sessions x
     3 turns, a turn of a session compressed just before it): B.2 at G =
     1, D = 128 on every layer once the int8 tier is active, on lanes
     that read int8 pages, its calls held and re-timed;
 27. mamba2-2.7b (64 Mamba2 layers, d_state 128, no attention, bf16,
     random weights from --seed) at full width and depth, served as phase 9
     serves zamba2-2.7b: ssd_scan at N = 128 on every layer of every
     dispatch and no plain call, the swap round trip, persist + crash +
     spool recovery on a second node, the lockstep twins under phase 9's
     flip-floor rule, a profiled turn, the main path's scan calls
     re-timed; the weights', the node's pools' and the peak device memory
     logged apart (as in phase 9).

It prints progress lines, then one line with the kernels' JSON record, the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core.advisory import (AdvisoryRequest,  # noqa: E402
                                       InferenceRequest)
from repro_torch.core.node_manager import NodeManager  # noqa: E402
from repro_torch.distributed.sharding import (ShardingPlan,  # noqa: E402
                                              unshard)
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.quant import quantize_int8  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving.backend import (RealBackend,  # noqa: E402
                                         make_backend)
from repro_torch.roofline import cost as roofline  # noqa: E402
# the H100 SXM data sheet's peaks (dense, at 700 W) and each kernel's
# analytic work, as the roofline counter charges the kernel entries
from repro_torch.roofline.cost import (HBM_BYTES_PER_S,  # noqa: E402
                                       PEAK_FLOPS, attention_work, bound,
                                       feature_pv_work, feature_scores_work,
                                       flash_work, merge_work, partial_work,
                                       scan_work)
from repro_torch.serving.cost_model import CostModel  # noqa: E402
from repro_torch.serving.engine import NodeEngine  # noqa: E402
from repro_torch.serving.scenario import (MixedTrace,  # noqa: E402
                                          MultiTurnRealTrace,
                                          SharedPrefixTrace,
                                          dense_reference, session_outputs)
from repro_torch.serving.simulator import ClusterRuntime  # noqa: E402
from repro_torch.serving.state_backend import StateBackend  # noqa: E402
from repro_torch.serving.transfer import IN, OUT  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            adamw_init, adamw_update,
                                            make_train_step, value_and_grad)
from repro_torch.training.train_loop import TrainConfig, train  # noqa: E402
from repro_torch.training.tree import (flatten, leaves,  # noqa: E402
                                       tree_map)

# tests/test_kernels.py's tolerances, scaled by max |plain| on real rows
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# its ssd_scan sweep's tolerances (test_ssd_scan_sweep), scaled by max
# |plain| of y and of the final state
SSD_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}
KERNEL = pa.paged_chunk_attention          # the wrapper; it counts pa.launches
QKERNEL = pa.paged_chunk_attention_quant   # counts pa.quant_launches
KPART = pa.paged_chunk_attention_partial   # counts pa.partial_launches
# the head-feature rung's one-launch route: pa.features_launches (kernel 1)
# or pa.quant_features_launches (B.2, with the int8 state)
FKERNEL = pa.paged_chunk_attention_features
QKPART = pa.paged_chunk_attention_quant_partial  # pa.quant_partial_launches
# sha256 (first 16 hex digits) of kernel 1's and B.2's outputs at head dims
# 64 and 128 on the fixed inputs of kernel1_digests(): the float32 entries
# recorded from the kernel source as it was before head dim 80 was added
# (the float32 body keeps that arithmetic), the bfloat16 entries from the
# tensor-core body, the bf16 decode entries re-recorded when decode grids
# short of the card began to split each lane's keys over a cluster
# (``pa.chunk_split_plan``: 4 splits at these B = 8 calls, whose merge sums
# in another order).  The plan reads the card's SM count, so these four
# hold on a card of 132 SMs (the H100 SXM's); one with another count may
# split those calls otherwise.  Those outputs must stay bit for bit as they
# are.
# Change an entry only with a change to the kernel's arithmetic at that head
# dim and dtype, and say so where the change is recorded.
DIGEST_SEED = 80
KERNEL1_DIGESTS = {
    "decode B=8 ctx<=4096 D=64 bfloat16": "68ffd51a3bcf6f9d",
    "int8 decode B=8 ctx<=4096 D=64 bfloat16": "40d4f004d8c8be70",
    "decode B=8 ctx<=4096 D=64 float32": "542a894bde973065",
    "int8 decode B=8 ctx<=4096 D=64 float32": "5d1908190f26ef66",
    "decode B=8 ctx<=4096 D=128 bfloat16": "67f7d7464af771db",
    "int8 decode B=8 ctx<=4096 D=128 bfloat16": "2421fdf62256ad64",
    "decode B=8 ctx<=4096 D=128 float32": "e9c7179ae9d8c868",
    "int8 decode B=8 ctx<=4096 D=128 float32": "c002effb04babd60",
    "chunk Sq=128 q_offset>0 D=64 bfloat16": "bf91264a980e2bad",
    "int8 chunk Sq=128 q_offset>0 D=64 bfloat16": "bacfaecb43515fb9",
    "chunk Sq=128 q_offset>0 D=64 float32": "6f07af5dde41cd7c",
    "int8 chunk Sq=128 q_offset>0 D=64 float32": "8e8d74067d660890",
    "chunk Sq=128 q_offset>0 D=128 bfloat16": "9484efd5998d838f",
    "int8 chunk Sq=128 q_offset>0 D=128 bfloat16": "d938a80677f2a021",
    "chunk Sq=128 q_offset>0 D=128 float32": "3b728f01c6afbcc7",
    "int8 chunk Sq=128 q_offset>0 D=128 float32": "250ba4077152caf0",
}


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 20) -> float:
    """The host's time to issue one call of ``fn`` (no synchronisation
    inside the window): what bounds `cuda_ms` when it exceeds the device
    time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / iters


def device_ms(fn, iters: int = 20):
    """The device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph and replayed, so without the host's time between launches,
    which `cuda_ms` includes whenever the wrapper takes longer on the host
    than the kernel on the card.  None if the calls cannot be captured."""
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        log(f"  (device_ms: not captured: {str(e).splitlines()[0]})")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters






def sdpa_yardstick(q, k_pages, v_pages, tables, q_offsets, ctx_lens,
                   quant=None):
    """One PyTorch call computing the same attention on densely gathered
    K/V (dequantized to q's dtype where flagged):
    F.scaled_dot_product_attention with a causal-and-context mask.  The
    gather, dequant and mask are built here, outside the timed call; the
    port never calls this."""
    B, Sq, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    S = tables.shape[1] * page
    t = tables.long()
    k, v = k_pages[t], v_pages[t]
    if quant is not None:
        kq, vq, ks, vs, flags = quant
        isq = (flags[t] > 0)[..., None, None, None]
        k = torch.where(isq, (kq[t].float() * ks[t][..., None, None, None])
                        .to(q.dtype), k)
        v = torch.where(isq, (vq[t].float() * vs[t][..., None, None, None])
                        .to(q.dtype), v)
    k = k.reshape(B, S, Hkv, D).transpose(1, 2)
    v = v.reshape(B, S, Hkv, D).transpose(1, 2)
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    qt = q.transpose(1, 2).contiguous()
    qpos = q_offsets.long()[:, None] + torch.arange(Sq, device=q.device)
    kpos = torch.arange(S, device=q.device)
    mask = (qpos[:, :, None] >= kpos) & (kpos < ctx_lens.long()[:, None, None])
    mask = mask[:, None]
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def compare(q, kp, vp, tables, qoff, ctx, q_lens, dtype, label, quant=None):
    """Kernel vs plain on one input — the int8 kernel when ``quant`` is
    given; returns a record with the error on real rows, the times and the
    bound.  The error must be within TOL x max |plain| over the real rows:
    the outputs are averages of V rows, far below 1 at long contexts,
    where a fixed tolerance would pass a kernel that drops a page or shifts
    the causal mask."""
    if quant is None:
        def kern():
            return KERNEL(q, kp, vp, tables, qoff, ctx)
    else:
        def kern():
            return QKERNEL(q, kp, vp, *quant, tables, qoff, ctx)
    out_k = kern()
    torch.cuda.synchronize()
    out_r = ref.paged_chunk_attention_ref(q, kp, vp, tables, qoff, ctx,
                                          quant=quant)
    check(bool(torch.isfinite(out_k.float()).all()),
          f"{label}: kernel output not finite")
    err, scale = 0.0, 0.0
    cx = ctx.cpu().numpy()
    for b in range(q.shape[0]):
        if cx[b] == 0:
            check(bool((out_k[b] == 0).all()),
                  f"{label}: ctx=0 lane {b} is not exactly zero")
            continue
        n = int(q_lens[b])
        check(bool((out_k[b, n:] == 0).all()),
              f"{label}: lane {b}'s padding rows are not zeros")
        want = out_r[b, :n].float()
        err = max(err, (out_k[b, :n].float() - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
    lim = TOL[dtype] * scale
    check(err <= lim, f"{label}: max abs err {err:.3g} > {TOL[dtype]} x "
          f"max|plain| {scale:.3g} = {lim:.3g}")
    _, page, hkv, d = kp.shape
    nbytes, flops = attention_work(q, tables, qoff, ctx, page, hkv, d,
                                   q.element_size(), q_lens,
                                   None if quant is None else quant[4])
    b_ms, b_by, t_b, t_f = bound(nbytes, flops, dtype)
    rec = dict(
        label=label, max_abs_err=err, err_rel=err / scale,
        ms=cuda_ms(kern, 20), device_ms=device_ms(kern),
        host_ms=host_ms(kern),
        plain_ms=cuda_ms(lambda: ref.paged_chunk_attention_ref(
            q, kp, vp, tables, qoff, ctx, quant=quant), 5),
        library_ms=cuda_ms(sdpa_yardstick(q, kp, vp, tables, qoff, ctx,
                                          quant), 20),
        bound_ms=b_ms, bound_by=b_by, bytes_ms=t_b, ops_ms=t_f, flops=flops,
        decode=q.shape[1] == 1, splits=split_count(q, kp, tables))
    if quant is not None:
        # the fp kernel over the same context, in turns with the int8 one:
        # int8, fp, fp, int8
        def fp():
            return KERNEL(q, kp, vp, tables, qoff, ctx)
        t = [cuda_ms(f, 20) for f in (kern, fp, fp, kern)]
        rec.update(ms=0.5 * (t[0] + t[3]), fp_ms=0.5 * (t[1] + t[2]),
                   fp_device_ms=device_ms(fp))
    return rec


def split_count(q, kp, tables) -> int:
    """The splits (CTAs of one cluster) over which kernel 1 and B.2 cut each
    (query tile, kv head, lane)'s keys on this call
    (``pa.chunk_split_plan``; 1: no cluster)."""
    B, Sq, H, _ = q.shape
    return pa.chunk_split_plan(B, Sq, H, kp.shape[2], tables.shape[1],
                               kp.shape[1], q.dtype,
                               pa._sm_count(q.get_device()))[0]


def fmt(rec) -> str:
    keys = ("max_abs_err", "err_rel", "ms", "device_ms", "host_ms",
            "fp_ms", "fp_device_ms", "clear_ms", "clear_device_ms",
            "plain_ms", "library_ms", "bound_ms")
    parts = [f"{k}={rec[k]:.4g}" for k in keys if rec.get(k) is not None]
    if "bound_by" in rec:
        parts.append(f"bound_by={rec['bound_by']}")
    if "splits" in rec:
        parts.append(f"splits={rec['splits']}")
    return f"  {rec['label']}: " + " ".join(parts)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    check(torch.cuda.is_available(), "no CUDA device: torch.cuda.is_available() "
          "is False")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[1] device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return kind, card


def phase_build():
    """Every kernel source, one nvcc each, started together; returns
    {name: (library, nvcc and ptxas output)}."""
    t0 = time.perf_counter()
    built = build.build_all([pa.NAME, pa.DECODE_NAME, ssd.NAME, fp.NAME,
                             pa.FEATURES_NAME])
    log(f"[2] {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (path, text) in built.items():
        log(f"[2] {'built' if text else 'up to date:'} {path}")
        spills = []
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers")):
                log(f"[2] {name}: {line.strip()}")
            if "spill" in line:
                spills.append(line.strip())
        if text:
            log(f"[2] {name}: spills: "
                f"{'; '.join(spills) or 'none reported by ptxas'}")
        if text and name in (pa.DECODE_NAME, ssd.NAME):
            spilled = [x for x in spills
                       if any(int(n) for n in re.findall(
                           r"(\d+) bytes spill (?:stores|loads)", x))]
            check(not spilled, f"{name}: an instantiation spills: {spilled}")
    return built


def make_case(rng, B, Sq, ctxs, q_lens, dtype, page=16, H=32, Hkv=8, D=128,
              extra_pages=64, host=False):
    """Random q and pools; lane b holds ctxs[b] tokens on a permuted page
    set, its last q_lens[b] tokens are this step's chunk; ctx 0 = padded
    lane.  Tables are last-valid padded to a power-of-two width.  q and the
    pools are drawn on the card, or with ``host`` from ``rng`` itself."""
    dev = "cuda"
    need = [-(-c // page) for c in ctxs]
    T = 1
    while T < max(max(need), 1):
        T <<= 1
    P = sum(need) + extra_pages
    if host:
        def randn(*shape):
            a = rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(a).to(dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(
            int(rng.integers(1 << 30)))

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
    kp = randn(P + 1, page, Hkv, D).to(dtype)
    vp = randn(P + 1, page, Hkv, D).to(dtype)
    q = randn(B, Sq, H, D).to(dtype)
    perm = rng.permutation(P)
    tables = np.zeros((B, T), np.int32)
    qoff = np.zeros((B,), np.int32)
    used = 0
    for b, c in enumerate(ctxs):
        if c == 0:
            continue
        tables[b, :need[b]] = perm[used:used + need[b]]
        tables[b, need[b]:] = tables[b, need[b] - 1]
        used += need[b]
        qoff[b] = c - q_lens[b]
    as_t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return q, kp, vp, as_t(tables), as_t(qoff), as_t(np.asarray(ctxs, np.int32))


def attention_cases(rng, decode_bs=(8, 32), chunks=((128, 4), (512, 2))):
    """(label, B, Sq, ctxs, q_lens) of the decode and chunk cases: decode
    lanes with ctx up to 4096 and one padded lane; ragged chunks at
    q_offsets > 0 and one padded lane."""
    cases = []
    for B in decode_bs:
        ctxs = [int(c) for c in rng.integers(1024, 4097, B)]
        ctxs[-1] = 0                                   # padded lane
        ctxs[0] = 4096
        cases.append((f"decode B={B} ctx<=4096", B, 1, ctxs, [1] * B))
    for Sq, B in chunks:
        ctxs, qls = [], []
        for b in range(B):
            n = Sq if b % 2 == 0 else Sq - 27           # ragged chunk
            ctxs.append(int(rng.integers(256, 1537)) + n)
            qls.append(n)
        ctxs.append(0)
        qls.append(0)
        cases.append((f"chunk Sq={Sq} q_offset>0", B + 1, Sq, ctxs, qls))
    return cases


def digest(t) -> str:
    a = t.detach().cpu().contiguous()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return hashlib.sha256(a.numpy().tobytes()).hexdigest()[:16]


def kernel1_digests():
    """{case: digest} of kernel 1 and B.2 (half the pages int8) at D = 64
    and 128, bf16 and fp32, on a decode and a chunk batch drawn on the host
    from DIGEST_SEED, whatever --seed is."""
    rng = np.random.default_rng(DIGEST_SEED)
    out = {}
    for label, B, Sq, ctxs, qls in attention_cases(rng, (8,), ((128, 4),)):
        for D in (64, 128):
            for dtype in (torch.bfloat16, torch.float32):
                q, kp, vp, tab, qoff, ctx = make_case(
                    rng, B, Sq, ctxs, qls, dtype, D=D, host=True)
                name = f"{label} D={D} {str(dtype).split('.')[-1]}"
                out[name] = digest(KERNEL(q, kp, vp, tab, qoff, ctx))
                quant = int8_state(kp, vp, tab, ctx, 0.5)
                out["int8 " + name] = digest(
                    QKERNEL(q, kp, vp, *quant, tab, qoff, ctx))
                del q, kp, vp, quant
    torch.cuda.empty_cache()
    return out


def sass_counts(name):
    """[(kernel, counts)] of library ``name``'s machine code: which products
    each kernel runs, HGMMA (wgmma), HMMA (mma.sync), FFMA (CUDA-core
    float32)."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.build(name)[0])],
                          capture_output=True, text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()}")
    return [(part.split("\n", 1)[0].strip(),
             {op: part.count(op) for op in ("HGMMA", "HMMA", "FFMA")})
            for part in sass.stdout.split("Function : ")[1:]]


def paged_resources(built):
    """Kernel 1's and B.2's bodies as ptxas built them (when phase 2
    compiled them in this run), as the runtime reports them, and their
    machine code: every bfloat16 instantiation runs wgmma (HGMMA), no
    float32 one (nor the split-K merge) runs a tensor-core product (HGMMA
    or HMMA)."""
    text = built.get(pa.NAME, (None, ""))[1] if built else ""
    lines = text.splitlines()

    def body(name):
        if "split_kv_merge" in name:    # the split-K merge, CUDA cores
            out = "bf16" if "nv_bfloat16" in name else "fp32"
            return f"the split-K merge ({out} output)", False
        tc = "paged_chunk_attention_tc" in name
        # template arguments <D, kQuant, kFeat> or, for the bf16 body, <D,
        # kQuant, kOneRow, kFeat>
        dim, quant, rest = re.search(r"Li(\d+)ELb([01])E((?:Lb[01]E)*)",
                                     name).groups()
        flags = re.findall(r"Lb([01])E", rest)
        one_row = tc and flags[0] == "1"
        feat = flags[-1] == "1"
        return (f"{'bf16 tensor-core' if tc else 'fp32 CUDA-core'} "
                f"{'B.2' if quant == '1' else 'kernel 1'} at D = {dim}"
                f"{' (1-row pages)' if one_row else ''}"
                f"{' (head-feature gather)' if feat else ''}"), tc
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            info = [x.strip() for x in lines[i + 1:i + 4]
                    if "spill" in x or "Used" in x]
            log(f"[3] ptxas, {body(line)[0]}: {'; '.join(info)}")
    for quant in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            for d in pa.HEAD_DIMS:
                log(f"[3] runtime, {'B.2' if quant else 'kernel 1'} "
                    f"{str(dtype).split('.')[-1]} at D = {d}: "
                    f"{pa.resources(dtype, d, quant)}; head-feature gather "
                    f"{pa.features_resources(dtype, d, quant)}"
                    + (f"; 1-row pages "
                       f"{pa.resources(dtype, d, quant, one_row=True)}"
                       if dtype == torch.bfloat16 else ""))
    kernels = sass_counts(pa.NAME)
    for name, counts in kernels:
        label, tc = body(name)
        log(f"[3] SASS, {label}: {counts}")
        check(counts["HGMMA"] > 0 if tc
              else counts["HGMMA"] == 0 and counts["HMMA"] == 0,
              f"{label} runs {counts}")
    # per head dim: fp32 and bf16 kernel 1 and B.2, and the bf16 bodies
    # of 1-row pages, each with and without the head-feature gather; then
    # the merge's two
    check(len(kernels) == 12 * len(pa.HEAD_DIMS) + 2,
          f"cuobjdump shows {len(kernels)} kernels of {pa.NAME}, not "
          f"{12 * len(pa.HEAD_DIMS) + 2} (the merge's two among them)")


def log_rates(recs, tag, what):
    """Achieved TFLOP/s, share of the bound and ratio to SDPA of each
    record, then summed over all of them, the decode-only (Sq = 1) shapes
    and the chunk shapes."""
    for r in recs:
        log(f"[{tag}]   {r['label']}: {fmt_rate(r)}")
    for part, sub in (("all", recs),
                      ("decode-only", [r for r in recs if r["decode"]]),
                      ("chunk", [r for r in recs if not r["decode"]])):
        if sub:
            log(f"[{tag}] {what}, {part} shapes ({len(sub)}): kernel "
                f"{sum(r['ms'] for r in sub):.4g} ms (device "
                f"{sum(r['device_ms'] or 0.0 for r in sub):.4g}, host "
                f"{sum(r['host_ms'] for r in sub):.4g} ms), SDPA "
                f"{sum(r['library_ms'] for r in sub):.4g} ms, bound "
                f"{sum(r['bound_ms'] for r in sub):.4g} ms; {fmt_rate(sub)}")


def phase_kernel_vs_plain(rng, built=None):
    """Kernel 1's and B.2's bodies (``paged_resources``); kernel 1 at
    llama3-8b widths (D = 128), B.2, then kernel 1 at D = 64 (the random
    stream of the first two is as before D = 64 was added), then
    ``untouched_pages``; then every D = 64 and 128 output of
    kernel1_digests() is held bit for bit to KERNEL1_DIGESTS."""
    def run(D, cases, recs):
        for label, B, Sq, ctxs, qls in cases:
            for dtype in (torch.bfloat16, torch.float32):
                q, kp, vp, tab, qoff, ctx = make_case(rng, B, Sq, ctxs, qls,
                                                      dtype, D=D)
                rec = compare(q, kp, vp, tab, qoff, ctx, qls, dtype,
                              f"{label} D={D} {str(dtype).split('.')[-1]}")
                log("[3]" + fmt(rec))
                recs.append(rec)
                del q, kp, vp
        torch.cuda.empty_cache()

    paged_resources(built)
    recs, recs64 = [], []
    run(128, attention_cases(rng), recs)
    qrecs = phase_quant_vs_plain(rng)
    run(64, attention_cases(rng, (8,), ((128, 4),)), recs64)
    untouched_pages(rng)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split('.')[-1]
        log_rates([r for r in recs + recs64 if r["label"].endswith(name)], 3,
                  f"kernel 1 {name}")
        log_rates([r for r in qrecs if r["label"].endswith(name)], 3,
                  f"B.2 {name}")
    got = kernel1_digests()
    changed = sorted(k for k in got.keys() | KERNEL1_DIGESTS.keys()
                     if got.get(k) != KERNEL1_DIGESTS.get(k))
    check(not changed, f"kernel 1 / B.2 outputs at D = 64 and 128 are not "
          f"bit-identical to the recorded ones: "
          f"{ {k: got.get(k) for k in changed} }")
    log(f"[3] {len(got)} outputs of kernel 1 / B.2 at D = 64 and 128 "
        f"bit-identical to the recorded digests")
    decode_sweep(rng)
    return recs, qrecs


def decode_sweep(rng):
    """Kernel 1 and B.2 (3/4 of each lane's pages flagged) at decode with
    every lane at ctx 4096, B = 1, 8 and 32 (llama3-8b's heads, bf16): each
    against its plain version (B.2 beside kernel 1 on the same call, in
    turns), with the splits ``pa.chunk_split_plan`` gives the call, the
    cluster they run in (one CTA a split) and the share of the bound by
    device time."""
    recs = []
    for B in (1, 8, 32):
        q, kp, vp, tab, qoff, ctx = make_case(rng, B, 1, [4096] * B,
                                              [1] * B, torch.bfloat16)
        quant = int8_state(kp, vp, tab, ctx, 0.75)
        for what, qt in (("kernel 1", None), ("B.2 3/4 flagged", quant)):
            rec = compare(q, kp, vp, tab, qoff, ctx, [1] * B,
                          torch.bfloat16,
                          f"decode sweep {what} B={B} ctx=4096 bfloat16",
                          quant=qt)
            share = (rec["bound_ms"] / rec["device_ms"]
                     if rec["device_ms"] else float("nan"))
            log(f"[3]{fmt(rec)} cluster={rec['splits']} "
                f"share_of_bound={share:.4f}")
            recs.append(rec)
        del q, kp, vp, quant
    torch.cuda.empty_cache()
    return recs


def untouched_pages(rng):
    """Kernel 1 and B.2 read no page outside the lanes' relevant ones: on a
    batch of ragged chunks whose table columns past the relevant pages (and
    the ctx = 0 lane's row) name other pages, filling every other page with
    NaN (and, for B.2, its scales, with half of them flagged) must leave
    both outputs bit for bit as they are on the clean pools."""
    label, B, Sq, ctxs, qls = attention_cases(rng, (), ((128, 4),))[0]
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, tab, qoff, ctx = make_case(rng, B, Sq, ctxs, qls, dtype)
        quant = int8_state(kp, vp, tab, ctx, 0.5)
        page = kp.shape[1]
        tabs, cx = tab.cpu().numpy(), ctx.cpu().numpy()
        used = {int(p) for b in range(B)
                for p in tabs[b, :-(-int(cx[b]) // page)]}
        junk = [p for p in range(kp.shape[0]) if p not in used]
        for b in range(B):
            tabs[b, -(-int(cx[b]) // page):] = junk[b]
        tab = torch.from_numpy(tabs).to(q.device)
        want = KERNEL(q, kp, vp, tab, qoff, ctx)
        want_q = QKERNEL(q, kp, vp, *quant, tab, qoff, ctx)
        j = torch.tensor(junk, device=q.device)
        kp[j], vp[j] = float("nan"), float("nan")
        kq, vq, ks, vs, flags = quant
        ks[j], vs[j] = float("nan"), float("nan")
        flags[j[::2]] = 1
        name = f"{label} {str(dtype).split('.')[-1]}"
        check(torch.equal(KERNEL(q, kp, vp, tab, qoff, ctx), want),
              f"{name}: kernel 1 read a page outside the relevant ones")
        check(torch.equal(QKERNEL(q, kp, vp, kq, vq, ks, vs, flags, tab,
                                  qoff, ctx), want_q),
              f"{name}: B.2 read a page outside the relevant ones")
        log(f"[3] {name}: {len(junk)} pages outside the relevant ones (and "
            f"the table columns past them) NaN: kernel 1 and B.2 unchanged "
            f"bit for bit")
        del q, kp, vp, quant
    torch.cuda.empty_cache()


def int8_state(kp, vp, tables, ctx, share):
    """The int8 shadow pools of kp/vp with their per-page scales, and flags
    on the first ``share`` of each lane's relevant pages (its oldest
    history, as the serving tier quantizes full pages of idle sessions)."""
    kq, ks = quantize_int8(kp, axis=(1, 2, 3))
    vq, vs = quantize_int8(vp, axis=(1, 2, 3))
    flags = torch.zeros(kp.shape[0], dtype=torch.int32, device=kp.device)
    page = kp.shape[1]
    tab, cx = tables.cpu().numpy(), ctx.cpu().numpy()
    for b in range(tab.shape[0]):
        n = -(-int(cx[b]) // page)
        ids = tab[b, :int(share * n)]
        if len(ids):
            flags[torch.as_tensor(ids, device=kp.device).long()] = 1
    return kq, vq, ks, vs, flags


def phase_quant_vs_plain(rng):
    """The int8 kernel (B.2) against its plain version, beside the fp
    kernel on the same context, and with every flag clear bit-identical to
    the fp kernel."""
    dec = [int(c) for c in rng.integers(1024, 4097, 8)]
    dec[0], dec[-1] = 4096, 0
    chunk_q = [512, 512 - 27, 0]
    chunk = [int(rng.integers(256, 1537)) + n for n in chunk_q[:2]] + [0]
    cases = [("int8 decode B=8 ctx<=4096 3/4 flagged", 8, 1, dec,
              [1] * 7 + [0], 0.75),
             ("int8 chunk Sq=512 q_offset>0 1/2 flagged", 3, 512, chunk,
              chunk_q, 0.5)]
    recs = []
    for label, B, Sq, ctxs, qls, share in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, tab, qoff, ctx = make_case(rng, B, Sq, ctxs, qls, dtype)
            quant = int8_state(kp, vp, tab, ctx, share)
            name = f"{label} {str(dtype).split('.')[-1]}"
            rec = compare(q, kp, vp, tab, qoff, ctx, qls, dtype, name,
                          quant=quant)
            clear = quant[:4] + (torch.zeros_like(quant[4]),)
            same = torch.equal(QKERNEL(q, kp, vp, *clear, tab, qoff, ctx),
                               KERNEL(q, kp, vp, tab, qoff, ctx))
            check(same, f"{name}: with every flag clear the int8 kernel is "
                  f"not bit-identical to the fp kernel")
            rec["clear_ms"] = cuda_ms(
                lambda: QKERNEL(q, kp, vp, *clear, tab, qoff, ctx), 20)
            rec["clear_device_ms"] = device_ms(
                lambda: QKERNEL(q, kp, vp, *clear, tab, qoff, ctx))
            log("[3]" + fmt(rec) + " bit-identical with flags clear: True")
            recs.append(rec)
            del q, kp, vp, quant, clear
    torch.cuda.empty_cache()
    return recs


def _turns(rng, vocab, n_sessions=4, n_turns=3, system=200):
    """Token ids of every (session, turn) prompt: 256-1024 tokens each;
    sessions 0 and 1 open with the same `system`-token system prompt."""
    sys_ids = [int(t) for t in rng.integers(0, vocab, system)]
    prompts = []
    for s in range(n_sessions):
        turns = []
        for t in range(n_turns):
            n = int(rng.integers(256, 1025))
            if t == 0 and s < 2:
                user = [int(x) for x in rng.integers(0, vocab, n - system)]
                turns.append(sys_ids + user)
            else:
                turns.append([int(x) for x in rng.integers(0, vocab, n)])
        prompts.append(turns)
    return prompts


def make_node(cfg, model, params, *, n_pages, page_size=16, hbm_pages=None,
              spool=None, node_id=0, kernel_mode="auto", trace_logits=False,
              max_batch=8, token_budget=512, mesh=None):
    """(NodeEngine, RealBackend, NodeManager) on the model's device (or on
    ``mesh``), as a user of the port would build them (`make_backend`
    picks RealBackend for the dense and vlm families)."""
    cost = CostModel(cfg)
    cost.set_param_count(model.param_count())
    mgr = NodeManager(node_id, cfg, cost)
    be = make_backend(cfg, model, params, n_pages=n_pages,
                      page_size=page_size, hbm_pages=hbm_pages,
                      spool_dir=spool, mgr=mgr, trace_logits=trace_logits,
                      kernel_mode=kernel_mode, device=model.device,
                      mesh=mesh)
    check(isinstance(be, RealBackend), f"make_backend gave {type(be)}")
    eng = NodeEngine(node_id, cfg, cost, mgr, max_batch=max_batch,
                     backend=be, token_budget=token_budget)
    return eng, be, mgr


def rounds(prompts):
    """(session, turn) pairs submitted together: round 0 is session 0's
    first turn alone (finished, and indexed as a prefix donor, before
    session 1 arrives); round r >= 1 submits every session's next turn."""
    n_s, n_t = len(prompts), len(prompts[0])
    out = [[(0, 0)]]
    for r in range(1, n_t + 1):
        out.append([(s, r - (s != 0)) for s in range(n_s)
                    if r - (s != 0) < n_t])
    return out


def request(be, sid, ids, gen):
    """The session's next turn: ``ids`` new prompt tokens, ``gen`` to
    generate, on top of the KV the backend holds for it."""
    return InferenceRequest(session_id=sid, prompt_tokens=len(ids),
                            max_new_tokens=gen, prompt_ids=list(ids),
                            cached_tokens=be.session_tokens(sid))


def run_main_path(cfg, model, params, prompts, gen):
    eng, be, _ = make_node(cfg, model, params, n_pages=1024)
    reqs, steps = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0                           # counts of the main path only
    now = 0.0
    for rnd in rounds(prompts):
        for s, t in rnd:
            reqs.append(request(be, f"s{s}", prompts[s][t], gen))
            eng.submit(reqs[-1])
        while eng.waiting or eng.running:
            t0 = time.perf_counter()
            now += eng.step(now)
            steps.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = pa.launches
    return eng, be, reqs, steps, launches


def _ref64(q, k_pages, v_pages, tables, q_offsets, ctx_lens, quant=None):
    """The plain version's math in float64 (the port's plain version
    computes in float32): the rounding reference the bf16 noise floor is
    measured against.  Flagged pages read int8 x scale in float64."""
    B, Sq, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    S = tables.shape[1] * page
    t = tables.long()
    k, v = k_pages[t].double(), v_pages[t].double()
    if quant is not None:
        kq, vq, ks, vs, flags = quant
        isq = (flags[t] > 0)[..., None, None, None]
        k = torch.where(isq, kq[t].double() * ks[t].double()[
            ..., None, None, None], k)
        v = torch.where(isq, vq[t].double() * vs[t].double()[
            ..., None, None, None], v)
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).double()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / D ** 0.5
    qpos = q_offsets.long()[:, None] + torch.arange(Sq, device=q.device)
    kpos = torch.arange(S, device=q.device)
    mask = (qpos[:, :, None] >= kpos) & (kpos < ctx_lens.long()[:, None, None])
    s = s.masked_fill(~mask[:, None, None], ref.MASK_VALUE)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v)
    o = o * (ctx_lens > 0).double()[:, None, None, None, None]
    return o.reshape(B, Sq, H, D).to(q.dtype)


class Float64Attention:
    """While active, the plain attention (``kernels.ref``'s public function,
    which kernels/ops.py calls for ``kernel_mode="ref"``) is _ref64; counts
    its calls so a path that stops going through it is caught.
    ``per_dispatch(cfg)``: the calls one serving dispatch makes."""

    def __init__(self):
        self.n = 0

    @staticmethod
    def per_dispatch(cfg):
        if cfg.family == "hybrid":
            return cfg.n_layers // cfg.shared_every
        return cfg.n_layers

    @contextlib.contextmanager
    def __call__(self):
        orig = ref.paged_chunk_attention_ref

        def plain64(*args, quant=None):
            self.n += 1
            return _ref64(*args, quant=quant)

        ref.paged_chunk_attention_ref = plain64
        try:
            yield
        finally:
            ref.paged_chunk_attention_ref = orig


class Float64Scan:
    """While active, the plain SSD scan (``kernels.ref``'s public function)
    computes in float64; counts its calls like `Float64Attention`."""

    def __init__(self):
        self.n = 0

    @staticmethod
    def per_dispatch(cfg):
        return cfg.n_layers

    @contextlib.contextmanager
    def __call__(self):
        orig = ref.ssd_scan_chunked_ref

        def plain64(*args, **kw):
            self.n += 1
            y, h = orig(*args, **kw, compute_dtype=torch.float64)
            return y, h.float()

        ref.ssd_scan_chunked_ref = plain64
        try:
            yield
        finally:
            ref.ssd_scan_chunked_ref = orig


class PlainCalls:
    """Counts the calls of the plain versions (kernels.ref's public
    functions, which kernels/ops.py calls in their place) while active: the
    kernel path must make none."""

    NAMES = ("paged_chunk_attention_ref", "ssd_scan_chunked_ref",
             "flash_prefill_ref")

    def __init__(self):
        self.n = 0

    @contextlib.contextmanager
    def __call__(self):
        origs = {name: getattr(ref, name) for name in self.NAMES}

        def counted(f):
            def call(*args, **kw):
                self.n += 1
                return f(*args, **kw)
            return call

        for name, f in origs.items():
            setattr(ref, name, counted(f))
        try:
            yield
        finally:
            for name, f in origs.items():
                setattr(ref, name, f)


def drained(be, mgr):
    """The allocator and store invariants, checked at a drain point."""
    if isinstance(be, StateBackend):
        be.slots.check()
        allocs = be.kv_alloc
    else:
        allocs = be.alloc
    for a in allocs:
        a.check()
    mgr.store.check()


class Lockstep:
    """Three nodes in step, all tracing logits: the kernel path (K), the
    plain path (P) and the plain path with its attention in float64 (R).
    After every step P's and R's emitted tokens are compared with K's and
    then replaced by them (teacher forcing), so a near-tie that flips one
    token cannot desynchronise the rest of the comparison.  Submissions and
    advisories go to all three at the same virtual time.

    Each emitted token's logit vector is compared norm-wise, as max |x - y|
    over 2e-2 x max |y| (the bf16 tolerance, scaled by the logits): the
    logits are themselves bf16 (one ulp is 0.0625 at |logit| in [8, 16)),
    and a one-ulp difference in any attention output reaches every logit
    after 32 bf16 layers.  P vs R is the noise floor of two correct
    roundings (measured on the card at 1.03 of the tolerance on final
    chunks and 1.11 on decode tokens).  K must be within the tolerance of P
    on the final chunks, or within twice that floor where the floor is the
    larger, and no further from R than twice P's distance from R.

    A token K emits that P or R does not is a flip; the twin's logit gap
    between the two tokens must be within the tolerance.  With
    ``flip_floor`` (zamba2-2.7b: 54 bf16 Mamba layers put the noise floor
    at about 4x the tolerance, measured on the card) the gap is held at
    the end, like the logits, to the tolerance or twice the floor of its
    kind, whichever is larger."""

    PAIRS = ("KP", "PR", "KR")

    def __init__(self, nodes, dtype, captures=(), dt=None,
                 f64=(Float64Attention,), flip_floor=False):
        self.nodes = nodes                    # "K"/"P"/"R" -> (eng, be, mgr)
        self.captures = captures
        self.dt = dt                          # None: K's measured step time
        self.f64 = [f() for f in f64]         # R's float64 plain versions
        self.flip_floor = flip_floor
        self.tol = TOL[dtype]
        self.reqs = {x: {} for x in "KPR"}
        self.res = {f"{pr}_{kind}": 0.0 for pr in self.PAIRS
                    for kind in ("chunk", "decode")}
        self.res.update(flips=[], tokens=0)
        self.now = 0.0

    def submit(self, sid, ids, gen):
        for x in "KPR":
            eng, be, _ = self.nodes[x]
            self.reqs[x][sid] = request(be, sid, ids, gen)
            eng.submit(self.reqs[x][sid])

    def advise(self, sid, lead):
        for x in "KPR":
            self.nodes[x][2].on_advisory(
                AdvisoryRequest(session_id=sid, expected_arrival=lead),
                kv_node=self.nodes[x][2].node_id, now=self.now)

    def step(self):
        (ek, bk, mk), (ep, bp, mp), (er, br, mr) = (self.nodes[x]
                                                   for x in "KPR")
        n = [len(b.logit_trace) for b in (bk, bp, br)]
        with contextlib.ExitStack() as stack:
            for c in self.captures:
                stack.enter_context(c())
            dt = ek.step(self.now)
        ep.step(self.now)
        with contextlib.ExitStack() as stack:
            for f in self.f64:
                stack.enter_context(f())
            er.step(self.now)
        self.now += dt if self.dt is None else self.dt
        for be, mgr in ((bk, mk), (bp, mp), (br, mr)):
            drained(be, mgr)
        new = dict(K=bk.logit_trace[n[0]:], P=bp.logit_trace[n[1]:],
                   R=br.logit_trace[n[2]:])
        sids = [sid for sid, _ in new["K"]]
        check(all([sid for sid, _ in new[x]] == sids for x in "PR"),
              "lockstep engines diverged in their schedules")
        tol, res = self.tol, self.res
        for i, sid in enumerate(sids):
            lg = {x: new[x][i][1] for x in "KPR"}
            kind = ("chunk" if len(self.reqs["K"][sid].output_ids) == 1
                    else "decode")
            for pr in self.PAIRS:
                y = lg[pr[1]]
                err = float(np.abs(lg[pr[0]] - y).max())
                res[f"{pr}_{kind}"] = max(
                    res[f"{pr}_{kind}"], err / (tol * float(np.abs(y).max())))
            tk = self.reqs["K"][sid].output_ids[-1]
            res["tokens"] += 1
            for x, be in (("P", bp), ("R", br)):
                rq = self.reqs[x][sid]
                tx = rq.output_ids[-1]
                if tx == tk:
                    continue
                gap = float(lg[x][tx] - lg[x][tk])
                units = gap / (tol * float(np.abs(lg[x]).max()))
                res["flips"].append((x, sid, tk, tx, gap, kind, units))
                check(self.flip_floor or units <= 1.0,
                      f"{sid}: token {tk} (kernel) vs {tx} ({x}) with a "
                      f"logit gap {gap:.3g} beyond tolerance")
                be.seqs[sid].last_token = tk
                rq.output_ids[-1] = tk

    def run(self):
        ek = self.nodes["K"][0]
        while ek.waiting or ek.running:
            self.step()
        check(not any(self.nodes[x][0].waiting or self.nodes[x][0].running
                      for x in "PR"), "a twin engine has work left")

    def verdict(self, cfg):
        res, br = self.res, self.nodes["R"][1]
        subs = br.stats["sub_dispatches"]
        for f in self.f64:
            per = f.per_dispatch(cfg)
            check(f.n == per * subs, f"the float64 twin ran {f.n} calls of "
                  f"{type(f).__name__}, not {per} x {subs}")
        check(res["KP_chunk"] <= max(1.0, 2 * res["PR_chunk"]),
              f"final-chunk logits: kernel vs plain at {res['KP_chunk']:.3g}"
              f" x the tolerance, noise floor {res['PR_chunk']:.3g} x")
        for kind in ("chunk", "decode"):
            check(res[f"KR_{kind}"] <= 2 * max(res[f"PR_{kind}"], 1e-3),
                  f"{kind} logits: the kernel path is "
                  f"{res[f'KR_{kind}']:.3g} x the tolerance from the float64 "
                  f"path, the plain path {res[f'PR_{kind}']:.3g} x")
        if self.flip_floor:
            for x, sid, tk, tx, gap, kind, units in res["flips"]:
                floor = max(1.0, 2 * res[f"PR_{kind}"])
                check(units <= floor,
                      f"{sid}: token {tk} (kernel) vs {tx} ({x}) with a logit "
                      f"gap {units:.3g} x the tolerance, beyond the {kind} "
                      f"floor's {floor:.3g} x")
        return res

    def log(self, tag):
        res = self.res
        log(f"[{tag}] lockstep, {res['tokens']} tokens; max |logit diff| in "
            f"units of 2e-2 x max|logit|, final chunks / decode: kernel vs "
            f"plain {res['KP_chunk']:.3g} / {res['KP_decode']:.3g}; plain vs "
            f"its float64 twin {res['PR_chunk']:.3g} / "
            f"{res['PR_decode']:.3g}; kernel vs the float64 twin "
            f"{res['KR_chunk']:.3g} / {res['KR_decode']:.3g}")
        log(f"[{tag}] token flips (twin, sid, kernel, twin, twin's logit "
            f"gap, kind, gap in units of the tolerance): {res['flips']}")


def lockstep_nodes(make):
    """K, P and R nodes from ``make(kernel_mode)``, all tracing logits."""
    return dict(K=make("auto"), P=make("ref"), R=make("ref"))


def _attention_key(args, kw):
    q, tables = args[0], args[-3]
    return (tuple(q.shape), tuple(tables.shape), q.dtype)


def _scan_key(args, kw):
    x, Bm = args[0], args[2]
    return (tuple(x.shape), tuple(Bm.shape), x.dtype,
            kw.get("init_state") is not None)


class Capture:
    """Records one call of each distinct shape of one kernel wrapper
    (``module.name``: kernels/ops.py launches through the module attribute)
    with copies of its inputs, and counts the calls it sees: the first
    call, or with ``score`` the call that scores highest (for the int8
    kernel, the one whose lanes read the most int8 pages).  Captures happen
    only in runs that hold a kernel path against its twins (the lockstep
    nodes, the dense reference's prefills in phase 12)."""

    def __init__(self, name, score=None, module=pa, key=_attention_key):
        self.name = name
        self.score = score
        self.module = module
        self.key = key
        self.calls = {}
        self.scores = {}
        self.n = 0

    @contextlib.contextmanager
    def __call__(self):
        orig = getattr(self.module, self.name)

        def recording(*args, **kw):
            self.n += 1
            key = self.key(args, kw)
            sc = 0.0 if self.score is None else self.score(args)
            if key not in self.calls or sc > self.scores[key]:
                # inputs only: a partial call's ``out`` (its slots of the
                # step's workspace) is not kept
                self.calls[key] = (tuple(t.clone() if isinstance(
                    t, torch.Tensor) else t for t in args),
                                   {k: t.clone() if isinstance(
                                       t, torch.Tensor) else t
                                    for k, t in kw.items() if k != "out"})
                self.scores[key] = sc
            return orig(*args, **kw)

        setattr(self.module, self.name, recording)
        try:
            yield
        finally:
            setattr(self.module, self.name, orig)


def llama3_8b(seed, tag):
    """llama3-8b at its published widths and depth, bf16, random weights
    drawn on the card from ``seed``."""
    cfg = configs.get_config("llama3-8b")
    model = get_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in
                 [params["emb"], params["lm_head"], params["ln_f"],
                  *params["blocks"].values()])
    log(f"[{tag}] llama3-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}: {nbytes / 1e9:.2f} GB of weights in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def phase_serve(cfg, model, params, seed, tag=4):
    rng = np.random.default_rng(seed)
    prompts = _turns(rng, cfg.vocab)
    gen = 16
    eng, be, reqs, steps, launches = run_main_path(cfg, model, params,
                                                   prompts, gen)
    subs = be.stats["sub_dispatches"]
    n_tok = sum(len(r.output_ids) for r in reqs)
    log(f"[{tag}] main path: {len(reqs)} requests, {n_tok} generated tokens, "
        f"{eng.stats['prefill_tokens']} prefill tokens in "
        f"{eng.stats['chunks']} chunks, {len(steps)} steps, mean step "
        f"{1e3 * sum(steps) / len(steps):.2f} ms, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"[{tag}] backend stats: {be.stats}; buckets: {be.compile_counts()}")
    log(f"[{tag}] kernel launches {launches} = n_layers {cfg.n_layers} x "
        f"sub-dispatches {subs}: {launches == cfg.n_layers * subs}")
    check(launches == cfg.n_layers * subs and launches > 0,
          f"kernel launches {launches} != {cfg.n_layers} x {subs}")
    check(all(len(r.output_ids) == gen for r in reqs),
          "a request did not generate all its tokens")
    check(be.stats["prefix_hits"] >= 1 and be.stats["cow_forks"] >= 1,
          f"no prefix adoption / CoW fork on the card: {be.stats}")
    check(eng.stats["chunks"] > len(reqs), "no prompt was chunked")
    for a in be.alloc:
        a.check()
    buckets = be.compile_counts()["step"]     # the main path's buckets only
    del be, eng

    cap = Capture("paged_chunk_attention")
    launches0 = pa.launches
    lock = Lockstep(lockstep_nodes(lambda mode: make_node(
        cfg, model, params, n_pages=1024, kernel_mode=mode,
        trace_logits=True)), torch.bfloat16, captures=(cap,))
    for rnd in rounds(prompts):
        for s, t in rnd:
            lock.submit(f"s{s}", prompts[s][t], gen)
        lock.run()
    check(cap.n > 0 and cap.n == pa.launches - launches0,
          f"the capture saw {cap.n} kernel calls of the "
          f"{pa.launches - launches0} the kernel path launched")
    lock.verdict(cfg)
    log(f"[{tag}] captured {len(cap.calls)} distinct main-path kernel shapes "
        f"from {cap.n} calls")
    check(len(cap.calls) == buckets,
          f"captured {len(cap.calls)} distinct kernel shapes, the main path "
          f"ran {buckets} step buckets")
    lock.log(tag)
    del lock
    torch.cuda.empty_cache()
    decode = decode_calls(cap)
    recs = retime(cap, "main path", tag)
    torch.cuda.empty_cache()
    return launches, recs, decode


def decode_calls(cap):
    """The captured kernel-1 calls whose real lanes are all decode (Sq = 1,
    q_offset = ctx - 1): phase 14 replays them through B.3."""
    out = []
    for key, (args, _) in sorted(cap.calls.items(), key=lambda kv: kv[0]):
        q, kp, vp, tab, qoff, ctx = args
        real = ctx > 0
        if q.shape[1] == 1 and bool((qoff[real] == ctx[real] - 1).all()):
            out.append(args)
    return out


def retime(cap, what, tag):
    """The captured calls, one per distinct shape, held against the plain
    version and timed (the int8 kernel's with their flags)."""
    recs = []
    for key, (args, _) in sorted(cap.calls.items(), key=lambda kv: kv[0]):
        q, kp, vp = args[:3]
        tab, qoff, ctx = args[-3:]
        quant = tuple(args[3:8]) if len(args) == 11 else None
        q_lens = (ctx - qoff).clamp(min=0).cpu().tolist()
        label = f"{what} B={q.shape[0]} Sq={q.shape[1]} T={tab.shape[1]}"
        if quant is not None:
            label += f" int8 pages {flag_share(tab, ctx, quant[4], kp.shape[1]):.2f}"
        rec = compare(q, kp, vp, tab, qoff, ctx, q_lens, q.dtype, label,
                      quant=quant)
        log(f"[{tag}]" + fmt(rec))
        recs.append(rec)
    cap.calls.clear()
    log_rates(recs, tag, what)
    return recs


def flag_share(tables, ctx, flags, page):
    """Share of the lanes' relevant pages that are read from the int8
    pools."""
    tab, cx, fl = tables.cpu().numpy(), ctx.cpu().numpy(), flags.cpu().numpy()
    pages = [tab[b, i] for b in range(tab.shape[0])
             for i in range(-(-int(cx[b]) // page))]
    return float(np.mean([fl[p] for p in pages])) if pages else 0.0


def reference_turns(cfg, model, params, turns, gen):
    """The dense recompute (`dense_reference`) of one session's turns.  On
    a dense model its prefill runs B.4 on every layer of every turn (held
    here); the hybrid's windowed shared attention keeps the plain
    version."""
    f0 = fp.launches
    expect = dense_reference(cfg, model, params, {"chat": turns}, gen)["chat"]
    want = (cfg.n_layers * len(turns) if cfg.family in ("dense", "vlm")
            else 0)
    check(fp.launches - f0 == want, f"the dense recompute launched B.4 "
          f"{fp.launches - f0} times, not {want}")
    return expect


def fp32_2layer(seed):
    cfg = dataclasses.replace(configs.get_config("llama3-8b"), n_layers=2,
                              dtype="float32", name="llama3-8b-2layer-fp32")
    model = get_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    return cfg, model, params


def serve_turn(eng, be, sid, ids, gen, now):
    """Serve one turn of ``sid`` to the end; returns (tokens, now)."""
    req = request(be, sid, ids, gen)
    eng.submit(req)
    while eng.waiting or eng.running:
        now += eng.step(now)
    return list(req.output_ids), now


def phase_exact_fp32(seed):
    rng = np.random.default_rng(seed + 1)
    cfg, model, params = fp32_2layer(seed + 1)
    gen = 16
    turns = [[int(x) for x in rng.integers(0, cfg.vocab, int(n))]
             for n in rng.integers(100, 300, 3)]
    expect = reference_turns(cfg, model, params, turns, gen)
    eng, be, _ = make_node(cfg, model, params, n_pages=128, max_batch=4,
                           token_budget=128)
    got, now = [], 0.0
    before = pa.launches
    for turn in turns:
        toks, now = serve_turn(eng, be, "chat", turn, gen, now)
        got.append(toks)
    ran = pa.launches - before
    log(f"[5] fp32 2-layer full width: served {got}")
    log(f"[5] dense recompute            {expect}; kernel launches {ran}")
    check(ran == cfg.n_layers * be.stats["sub_dispatches"],
          "the fp32 serve did not go through the kernel on every layer")
    check(got == expect, "fp32 served tokens differ from dense recompute")


# ---------------------------------------------------------------------------
# phase 6: the memory-pressure path
# ---------------------------------------------------------------------------

STEP_S = 0.05       # virtual seconds per engine step: the policy reads `now`
LEAD = 0.5          # advisory lead (virtual s): reuse predicted that soon
PAGE = 16


class Single:
    """One node driven through the pressure scenario on the virtual clock
    (so quantize-or-swap decisions repeat run to run), with the allocator
    and store invariants at every drain point and the launch rule at every
    step: the kernels run on every layer of every sub-dispatch, and once
    the int8 tier is active, only the int8 kernel."""

    def __init__(self, node, cfg, now=0.0, max_steps=None):
        self.eng, self.be, self.mgr = node
        self.L = cfg.n_layers
        self.now = now
        self.steps = []
        self.max_steps = max_steps      # fail, rather than spin, past it

    def submit(self, sid, ids, gen):
        req = request(self.be, sid, ids, gen)
        self.eng.submit(req)
        return req

    def advise(self, sid, lead):
        self.mgr.on_advisory(AdvisoryRequest(session_id=sid,
                                             expected_arrival=lead),
                             kv_node=self.mgr.node_id, now=self.now)
        drained(self.be, self.mgr)

    def step(self):
        be = self.be
        # a meshed node launches once a shard, kernel 1 / B.2 or their
        # partial mode (the split-K rung) or, shards on distinct cards,
        # their F1, each F1 with its F2 (the head-feature rung); shards of
        # the head-feature rung on one card launch once (the one-launch
        # route)
        f0 = (pa.launches + pa.partial_launches + pa.scores_launches
              + pa.features_launches)
        q0 = (pa.quant_launches + pa.quant_partial_launches
              + pa.quant_scores_launches + pa.quant_features_launches)
        pv0 = (pa.pv_launches - pa.scores_launches,
               pa.quant_pv_launches - pa.quant_scores_launches)
        s0 = be.stats["sub_dispatches"]
        active = be._quant_active
        t0 = time.perf_counter()
        self.eng.step(self.now)
        self.steps.append(time.perf_counter() - t0)
        self.now += STEP_S
        check(self.max_steps is None or len(self.steps) <= self.max_steps,
              f"no end after {len(self.steps)} steps: {len(self.eng.waiting)}"
              f" waiting, {len(self.eng.running)} running")
        drained(be, self.mgr)
        if be.device.type != "cuda":
            return                  # CPU tensors take the plain versions
        df = (pa.launches + pa.partial_launches + pa.scores_launches
              + pa.features_launches - f0)
        dq = (pa.quant_launches + pa.quant_partial_launches
              + pa.quant_scores_launches + pa.quant_features_launches - q0)
        ds = be.stats["sub_dispatches"] - s0
        check((pa.pv_launches - pa.scores_launches,
               pa.quant_pv_launches - pa.quant_scores_launches) == pv0,
              "the head-feature rung's F2 did not follow each F1")
        keys, _ = expected_counts(be)
        per = 1 if keys[0].endswith("_feat") else be.tp
        check(df + dq == self.L * ds * per,
              f"{df} fp + {dq} int8 kernel launches for {ds} sub-dispatches "
              f"of {self.L} layers on {be.tp} shards ({per} a layer)")
        check(not active or df == 0,
              f"the int8 tier is active but the fp kernel ran {df} times")

    def run(self):
        while self.eng.waiting or self.eng.running:
            self.step()

    def run_while(self, sid):
        """Step until session ``sid`` has no request waiting or running."""
        eng = self.eng
        while (any(r.req.session_id == sid for r in eng.running)
               or any(r.session_id == sid for r in eng.waiting)):
            self.step()


def pressure_prompts(rng, vocab, n_sessions=6, n_turns=3):
    return [[[int(x) for x in rng.integers(0, vocab, int(rng.integers(
        256, 1025)))] for _ in range(n_turns)] for _ in range(n_sessions)]


def pressure_rounds(d, prompts, gen):
    """Every turn in waves of two sessions, the last sessions first.  In
    turn 1 every idle session gets an advisory — a predicted reuse — before
    each wave, so the wave's pressure compresses idle sessions to int8
    (`NodeManager._quantize_pass`) instead of evicting them, and the later
    waves are served from their own int8 pages.  In turn 2 nobody is
    advised ahead of the first wave, whose pressure sends idle sessions'
    layers to the host; before each later wave its first session gets an
    advisory that prefetches it back, and the others swap in cold."""
    S, T = len(prompts), len(prompts[0])
    waves = [list(range(max(0, e - 2), e)) for e in range(S, 0, -2)]
    for t in range(T):
        for w, wave in enumerate(waves):
            if t == 1:
                for s in range(S):
                    if s not in wave:
                        d.advise(f"p{s}", LEAD)
            elif t >= 2 and w:
                d.advise(f"p{wave[0]}", LEAD)
            for s in wave:
                d.submit(f"p{s}", prompts[s][t], gen)
            d.run()


def timed_copy(fn, stream, reps=5):
    """Median seconds of one copy on ``stream``, CUDA events."""
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            e0.record()
            fn()
            e1.record()
        stream.synchronize()
        out.append(e0.elapsed_time(e1) / 1e3)
    return float(np.median(out))


def host_link(d, bg_ids, rng, vocab):
    """The host link and the stalls, on the largest session (``vip``),
    with a background lane admitted first and kept running: pinned copies
    of vip's KV bytes each way (CUDA events); the backend's swap-out and
    advisory prefetch of vip, host clock to the drain, over the bytes the
    backend counted; and the residual stall of a swap-in the engine pays
    cold next to one an advisory prefetched two steps ahead."""
    eng, be, mgr = d.eng, d.be, d.mgr
    d.submit("bg", bg_ids, 64)
    for _ in range(4):
        d.step()
    vip = max((s for s in be.seqs if s != "bg"),
              key=lambda s: be.seqs[s].n_kv)
    mgr.promote(vip, d.now)
    be.drain_transfers()
    check(all(vip in a.seqs for a in be.alloc), f"{vip} is not resident")
    nbytes = int(be.seqs[vip].n_kv * be._token_bytes)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    side = torch.cuda.Stream()
    d2h = timed_copy(lambda: host.copy_(dev, non_blocking=True), side)
    h2d = timed_copy(lambda: dev.copy_(host, non_blocking=True), side)
    del dev, host
    rates = []
    for move in (lambda: be.swap_out(vip, be.session_tokens(vip)),
                 lambda: mgr.promote(vip, d.now)):
        torch.cuda.synchronize()
        c0, t0 = be.stats["copied_bytes"], time.perf_counter()
        move()
        be.drain_transfers()
        rates.append((be.stats["copied_bytes"] - c0)
                     / (time.perf_counter() - t0) / 1e9)
    drained(be, mgr)
    check(all(vip in a.seqs for a in be.alloc), f"{vip} did not come back")
    stalls = []
    for lead_steps in (0, 2):
        be.swap_out(vip, be.session_tokens(vip))
        be.drain_transfers(OUT)
        stall0 = eng.stats["stall_s"]
        if lead_steps:
            d.advise(vip, LEAD)                   # the prefetch is launched
            check(be.transfers.pending_for(vip, IN), "no prefetch launched")
            for _ in range(lead_steps):
                d.step()
        d.submit(vip, [int(x) for x in rng.integers(0, vocab, 4)], 2)
        d.run_while(vip)
        stalls.append(eng.stats["stall_s"] - stall0)
    d.run()                                       # the background lane ends
    return dict(vip=vip, bytes=nbytes, d2h_GBps=nbytes / d2h / 1e9,
                h2d_GBps=nbytes / h2d / 1e9, swap_out_GBps=rates[0],
                prefetch_GBps=rates[1], stall_cold_ms=1e3 * stalls[0],
                stall_advisory_ms=1e3 * stalls[1])


def phase_pressure(cfg, model, params, seed):
    rng = np.random.default_rng(seed + 6)
    gen = 16
    prompts = pressure_prompts(rng, cfg.vocab)
    total = sum(-(-(sum(map(len, turns)) + len(turns) * gen) // PAGE)
                for turns in prompts)
    hbm_pages = int(0.4 * total)
    n_pages = 2 * hbm_pages
    log(f"[6] {len(prompts)} sessions x {len(prompts[0])} turns, "
        f"{sum(len(t) for p in prompts for t in p)} prompt tokens, "
        f"{total} fp pages at the end; hbm_pages {hbm_pages}, n_pages "
        f"{n_pages}, page {PAGE}")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pa.launches = pa.quant_launches = 0   # counts of the main path only
        node = make_node(cfg, model, params, n_pages=n_pages,
                         hbm_pages=hbm_pages, spool=f"{tmp}/node0")
        d = Single(node, cfg)
        pressure_rounds(d, prompts, gen)
        eng, be, mgr = node
        n_steps, mean_ms = len(d.steps), 1e3 * float(np.mean(d.steps))
        peak = torch.cuda.max_memory_allocated() / 1e9
        link = host_link(d, [int(x) for x in rng.integers(0, cfg.vocab, 8)],
                         rng, cfg.vocab)
        # persist one session, migrate another to a second node, crash the
        # first and recover the persisted one on the second from the spool
        persisted, migrated = "p5", "p4"
        mgr.flush_session(persisted, d.now)
        be.drain_transfers()
        check(be.spool_exists(persisted), "the persist wrote no spool file")
        node2 = make_node(cfg, model, params, n_pages=n_pages,
                          hbm_pages=hbm_pages, spool=f"{tmp}/node1",
                          node_id=1)
        eng2, be2, mgr2 = node2
        mgr2.register_peers({0: mgr})
        mgr2.on_advisory(AdvisoryRequest(session_id=migrated), kv_node=0,
                         now=d.now)
        check(be2.stats["migrations_in"] == 1 and migrated in be2.seqs,
              "the advisory did not migrate the session to the second node")
        stats1 = dict(be.stats)
        be.crash()
        mgr.crash(d.now)
        check(mgr2.recover_from_spool(persisted, mgr, d.now),
              "the second node could not recover the session from the spool")
        d2 = Single(node2, cfg, now=d.now)
        reqs = [d2.submit(s, prompts[s_i][-1][:256], gen)
                for s, s_i in ((persisted, 5), (migrated, 4))]
        d2.run()
        fp_launches, q_launches = pa.launches, pa.quant_launches
    check(all(len(r.output_ids) == gen for r in reqs),
          "a recovered or migrated session did not serve its next turn")
    tot = {k: stats1[k] + be2.stats[k] for k in (
        "quantized_pages", "swaps_out", "swaps_in", "layer_evictions",
        "layer_promotions", "disk_writes", "migrations_in", "admit_quantized",
        "quant_dispatches", "dequant_forks", "copied_bytes")}
    log(f"[6] main path: {n_steps} steps, mean step {mean_ms:.2f} ms, "
        f"max_memory_allocated {peak:.2f} GB; kernel launches: fp {fp_launches}"
        f", int8 {q_launches}")
    log(f"[6] node 0 stats {stats1}; manager {mgr.stats}")
    log(f"[6] node 1 stats {be2.stats}; manager {mgr2.stats}")
    log(f"[6] host link, session {link['vip']} of {link['bytes'] / 1e6:.1f} "
        f"MB: pinned "
        f"copies device->host {link['d2h_GBps']:.2f} GB/s, host->device "
        f"{link['h2d_GBps']:.2f} GB/s (HardwareSpec.d2h_bw assumes 64); "
        f"backend swap-out to the drain {link['swap_out_GBps']:.2f} GB/s, "
        f"advisory prefetch to the drain {link['prefetch_GBps']:.2f} GB/s")
    log(f"[6] swap-in stall: cold {link['stall_cold_ms']:.3f} ms, advisory "
        f"two steps ahead {link['stall_advisory_ms']:.3f} ms")
    for k in ("quantized_pages", "swaps_out", "swaps_in", "layer_promotions",
              "disk_writes", "migrations_in"):
        check(tot[k] > 0, f"the pressure path never moved {k}: {tot}")
    check(q_launches > 0, "the int8 kernel never ran on the main path")

    recs = pressure_lockstep(cfg, model, params, prompts, gen, n_pages,
                             hbm_pages, 6)
    return q_launches, recs, link


def pressure_lockstep(cfg, model, params, prompts, gen, n_pages, hbm_pages,
                      tag):
    """The pressure rounds again in lockstep (kernel path vs plain vs
    float64), then the int8 kernel's captured main-path calls re-timed."""
    capq = Capture("paged_chunk_attention_quant", score=lambda a: flag_share(
        a[-3], a[-1], a[7], a[1].shape[1]))
    capf = Capture("paged_chunk_attention")
    q0, f0 = pa.quant_launches, pa.launches
    lock = Lockstep(lockstep_nodes(lambda mode: make_node(
        cfg, model, params, n_pages=n_pages, hbm_pages=hbm_pages,
        kernel_mode=mode, trace_logits=True)), torch.bfloat16,
        captures=(capf, capq), dt=STEP_S)
    pressure_rounds(lock, prompts, gen)
    bk = lock.nodes["K"][1]
    check(capq.n == pa.quant_launches - q0 and capf.n == pa.launches - f0
          and capq.n + capf.n == cfg.n_layers * bk.stats["sub_dispatches"],
          f"the captures saw {capf.n} + {capq.n} kernel calls of "
          f"{cfg.n_layers} x {bk.stats['sub_dispatches']}")
    check(capq.n > 0 and max(capq.scores.values()) > 0,
          "the lockstep twin never read an int8 page")
    lock.verdict(cfg)
    lock.log(tag)
    log(f"[{tag}] captured {len(capq.calls)} distinct int8-kernel shapes "
        f"from {capq.n} calls")
    del lock
    capf.calls.clear()
    torch.cuda.empty_cache()
    recs = retime(capq, "pressure", tag)
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 7: exact tokens through the tiers
# ---------------------------------------------------------------------------

def phase_exact_tiers(seed):
    rng = np.random.default_rng(seed + 7)
    cfg, model, params = fp32_2layer(seed + 7)
    gen = 16
    turns = [[int(x) for x in rng.integers(0, cfg.vocab, int(n))]
             for n in rng.integers(100, 300, 4)]
    expect = reference_turns(cfg, model, params, turns, gen)
    kw = dict(n_pages=256, max_batch=4, token_budget=128)
    got, now = [], 0.0
    with tempfile.TemporaryDirectory() as tmp:
        a = make_node(cfg, model, params, spool=f"{tmp}/a", **kw)
        b = make_node(cfg, model, params, spool=f"{tmp}/b", node_id=1, **kw)
        c = make_node(cfg, model, params, spool=f"{tmp}/c", node_id=2, **kw)
        toks, now = serve_turn(a[0], a[1], "chat", turns[0], gen, now)
        got.append(toks)
        a[1].swap_out("chat", a[1].session_tokens("chat"))  # to the host
        a[1].drain_transfers()
        toks, now = serve_turn(a[0], a[1], "chat", turns[1], gen, now)
        got.append(toks)                                   # swapped back in
        a[2].flush_session("chat", now)                    # to the spool
        a[1].drain_transfers()
        a[1].crash()
        a[2].crash(now)
        check(b[2].recover_from_spool("chat", a[2], now),
              "no recovery from the spool")
        toks, now = serve_turn(b[0], b[1], "chat", turns[2], gen, now)
        got.append(toks)
        c[2].register_peers({1: b[2]})                     # migration
        c[2].on_advisory(AdvisoryRequest(session_id="chat"), kv_node=1,
                         now=now)
        toks, now = serve_turn(c[0], c[1], "chat", turns[3], gen, now)
        got.append(toks)
        moved = dict(swaps_out=a[1].stats["swaps_out"],
                     swaps_in=a[1].stats["swaps_in"],
                     disk_writes=a[1].stats["disk_writes"],
                     recovered=b[1].stats["migrations_in"],
                     migrated=c[1].stats["migrations_in"])
    log(f"[7] fp32 2-layer, swap out/in -> spool, crash, recover -> "
        f"migrate: served {got}")
    log(f"[7] dense recompute {expect}; {moved}")
    check(all(v > 0 for v in moved.values()), f"a tier was not used: {moved}")
    check(got == expect, "tokens through the tiers differ from dense "
          "recompute")

    # int8 pages served by the int8 kernel == the same values materialized
    # to fp by a host round trip and served from the fp pools
    outs = []
    for materialize in (False, True):
        eng, be, mgr = make_node(cfg, model, params, **kw)
        serve_turn(eng, be, "q", turns[0], gen, 0.0)
        check(be.quantize_session("q") > 0, "nothing to quantize")
        if materialize:
            be.swap_out("q", be.session_tokens("q"))
            be.drain_transfers()
            mgr.promote("q", 1.0)
            be.drain_transfers()
            check(not any(a.quantized for a in be.alloc),
                  "the host round trip left int8 pages")
        q0, s0 = pa.quant_launches, be.stats["sub_dispatches"]
        toks, _ = serve_turn(eng, be, "q", turns[1], gen, 1.0)
        check(pa.quant_launches - q0
              == cfg.n_layers * (be.stats["sub_dispatches"] - s0),
              "the int8 kernel did not run on every layer of every dispatch")
        outs.append(toks)
    log(f"[7] int8 pages in the kernel {outs[0]}; materialized to fp "
        f"{outs[1]}")
    check(outs[0] == outs[1], "int8 pages read in the kernel and the same "
          "values materialized to fp give different tokens")


# ---------------------------------------------------------------------------
# phase 8: ssd_scan (B.5) and kernel 1 / B.2 at head dim 80 against plain
# ---------------------------------------------------------------------------

def scan_inputs(gen, B, S, H, P, G, N, dtype, init):
    """The TPU sweep's distributions (tests/test_kernels.py): x, B, C
    standard normal, dA = -|N(0, 0.1)|; a standard-normal initial state."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(B, S, H, P).to(dtype)
    dA = -(0.1 * randn(B, S, H)).abs()
    Bm, Cm = randn(B, S, G, N).to(dtype), randn(B, S, G, N).to(dtype)
    h0 = randn(B, H, N, P) if init else None
    return x, dA, Bm, Cm, h0




def compare_scan(x, dA, Bm, Cm, h0, label, chunk=256, timed=False):
    """ssd_scan vs its plain version on one input: y and the final state,
    each within SSD_TOL x max |plain| of its own.  ``timed``: the kernel's
    and the plain version's times and the bound."""
    def kern():
        return ssd.ssd_scan(x, dA, Bm, Cm, init_state=h0)

    def plain():
        return ref.ssd_scan_chunked_ref(x, dA, Bm, Cm, chunk, init_state=h0)

    yk, hk = kern()
    torch.cuda.synchronize()
    yr, hr = plain()
    tol = SSD_TOL[x.dtype]
    rec = dict(label=label, max_abs_err=0.0, err_rel=0.0)
    for what, a, b in (("y", yk, yr), ("state", hk, hr)):
        check(bool(torch.isfinite(a.float()).all()),
              f"{label}: kernel {what} not finite")
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        check(err <= tol * scale, f"{label}: {what} max abs err {err:.3g} > "
              f"{tol} x max|plain| {scale:.3g} = {tol * scale:.3g}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["err_rel"] = max(rec["err_rel"], err / max(scale, 1e-30))
    if timed:
        nbytes, flops = scan_work(x, Bm, h0 is not None)
        b_ms, b_by, t_b, t_f = bound(nbytes, flops, torch.float32)
        rec.update(ms=cuda_ms(kern, 20), device_ms=device_ms(kern),
                   host_ms=host_ms(kern), plain_ms=cuda_ms(plain, 5),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   bytes_ms=t_b, ops_ms=t_f, nbytes=nbytes, flops=flops,
                   S=x.shape[1])
        # the kernel's and the plain version's distance from float64: which
        # of the two the error above is made of
        y64, h64 = ref.ssd_scan_chunked_ref(x, dA, Bm, Cm, chunk,
                                            init_state=h0,
                                            compute_dtype=torch.float64)
        f64 = []
        for got in ((yk, hk), (yr, hr)):
            f64.append(max(
                ((a.double() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(got, (y64, h64))))
        split = kernel_split(kern)
        log(f"  {label}: kernel / plain vs float64 {f64[0]:.3g} / "
            f"{f64[1]:.3g} of max|float64|; device ms per kernel "
            + ", ".join(f"{k} {v:.4g}" for k, v in split.items()))
    return rec


def kernel_split(fn, calls: int = 5):
    """{device kernel: ms per call of ``fn``} from torch.profiler over
    ``calls`` calls: how a wrapper's time divides among the kernels it
    issues."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        m = re.search(r"((?:ssd|split_kv|paged)_\w+)(<[^(]*>)?", e.key)
        name = (m.group(1) + (m.group(2) or "")) if m else e.key[:40]
        out[name] = out.get(name, 0.0) + t / 1e3 / calls
    return out


SCAN_PEAK = (f"peak used: float32 on the CUDA cores, "
             f"{PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s (the scan's "
             f"products run there), and {HBM_BYTES_PER_S / 1e12:.2f} TB/s")


def log_scan_rates(recs, tag, what):
    """Per timed scan record and summed (all, S = 1, S > 1): achieved GB/s
    and TFLOP/s of the function's own bytes and operations over the device
    time, and the share of the bound over the device time and over ms."""
    def rate(sub):
        dev = sum(r["device_ms"] or r["ms"] for r in sub)
        ms = sum(r["ms"] for r in sub)
        b = sum(r["bound_ms"] for r in sub)
        return (f"{sum(r['nbytes'] for r in sub) / dev / 1e6:.1f} GB/s, "
                f"{sum(r['flops'] for r in sub) / dev / 1e9:.2f} TFLOP/s, "
                f"{b / dev:.4f} of the bound (device), {b / ms:.4f} (ms)")
    for r in recs:
        log(f"[{tag}]   {r['label']}: {rate([r])}")
    log(f"[{tag}] {SCAN_PEAK}")
    for part, sub in (("all", recs),
                      ("decode (S = 1)", [r for r in recs if r["S"] == 1]),
                      ("chunks (S > 1)", [r for r in recs if r["S"] > 1])):
        if sub:
            log(f"[{tag}] {what}, {part} shapes ({len(sub)}): kernel "
                f"{sum(r['ms'] for r in sub):.4g} ms (device "
                f"{sum(r['device_ms'] or 0.0 for r in sub):.4g}, host "
                f"{sum(r['host_ms'] for r in sub):.4g} ms), bound "
                f"{sum(r['bound_ms'] for r in sub):.4g} ms; {rate(sub)}")


def scan_resources():
    """The scan's kernels as the runtime reports them at N = 64 and 128 in
    both dtypes (no local memory: no spills), and their machine code: no
    tensor-core product (HGMMA, HMMA) in any instantiation."""
    for kernel in ssd.KERNELS:
        for dtype in (torch.float32, torch.bfloat16):
            for N in (64, 128):
                res = ssd.resources(kernel, dtype, N)
                log(f"[8] runtime, ssd_scan {kernel} "
                    f"{str(dtype).split('.')[-1]} N = {N}: {res}")
                check(res["local_bytes"] == 0,
                      f"ssd_scan {kernel} at N = {N} uses local memory")
    kernels = sass_counts(ssd.NAME)
    for name, counts in kernels:
        log(f"[8] SASS, {name[:60]}: {counts}")
        check(counts["HGMMA"] == 0 and counts["HMMA"] == 0,
              f"{name} runs {counts}")


def phase_scan_vs_plain(seed):
    """B.5 at zamba2-2.7b's SSD shapes (H = 80, P = 64, N = 64, G = 1) and
    mamba2-2.7b's (N = 128): lanes 1, 2, 8; 1, 256, 513 and 1024 steps;
    zero and random initial state; bf16 and fp32.  Timed: decode of 8
    lanes and one 1024-step lane, with a state, in fp32 (the model's
    working dtype)."""
    scan_resources()
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    recs, n = [], 0
    for model, N in (("zamba2", 64), ("mamba2", 128)):
        for B in (1, 2, 8):
            for S in (1, 256, 513, 1024):
                for init in (False, True):
                    for dtype in (torch.bfloat16, torch.float32):
                        args = scan_inputs(gen, B, S, 80, 64, 1, N, dtype,
                                           init)
                        timed = (dtype == torch.float32 and init
                                 and (B, S) in ((8, 1), (1, 1024)))
                        label = (f"ssd_scan {model} N={N} B={B} S={S} "
                                 f"{'state' if init else 'zero state'} "
                                 f"{str(dtype).split('.')[-1]}")
                        rec = compare_scan(*args, label, timed=timed)
                        n += 1
                        if timed:
                            log("[8]" + fmt(rec))
                            recs.append(rec)
                        del args
    worst = max(r["err_rel"] for r in recs)
    log(f"[8] ssd_scan: {n} cases within tolerance (timed cases' worst "
        f"error {worst:.3g} of max|plain|)")
    log_scan_rates(recs, 8, "ssd_scan fp32")
    torch.cuda.empty_cache()
    return recs


def phase_d80_vs_plain(rng):
    """Kernel 1 and B.2 at zamba2-2.7b's shared attention: H = Hkv = 32,
    D = 80, page 16; decode B = 8 with ctx up to 4096 and a 512-token chunk
    at q_offset > 0, bf16 and fp32; B.2 with 3/4 (decode) and 1/2 (chunk)
    of the pages int8, and bit-identical to kernel 1 with flags clear."""
    recs = []
    shares = (0.75, 0.5)
    for (label, B, Sq, ctxs, qls), share in zip(
            attention_cases(rng, (8,), ((512, 2),)), shares):
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, tab, qoff, ctx = make_case(rng, B, Sq, ctxs, qls,
                                                  dtype, H=32, Hkv=32, D=80)
            name = f"{label} H=Hkv=32 D=80 {str(dtype).split('.')[-1]}"
            rec = compare(q, kp, vp, tab, qoff, ctx, qls, dtype, name)
            log("[8]" + fmt(rec))
            recs.append(rec)
            quant = int8_state(kp, vp, tab, ctx, share)
            rq = compare(q, kp, vp, tab, qoff, ctx, qls, dtype,
                         f"int8 {name} {share:.2f} flagged", quant=quant)
            clear = quant[:4] + (torch.zeros_like(quant[4]),)
            check(torch.equal(QKERNEL(q, kp, vp, *clear, tab, qoff, ctx),
                              KERNEL(q, kp, vp, tab, qoff, ctx)),
                  f"{name}: with every flag clear the int8 kernel is not "
                  f"bit-identical to the fp kernel")
            log("[8]" + fmt(rq) + " bit-identical with flags clear: True")
            recs.append(rq)
            del q, kp, vp, quant, clear
    torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        log_rates([r for r in recs if "int8" not in r["label"]
                   and dtype in r["label"]], 8, f"kernel 1 D=80 {dtype}")
        log_rates([r for r in recs if "int8" in r["label"]
                   and dtype in r["label"]], 8, f"B.2 D=80 {dtype}")
    return recs


# ---------------------------------------------------------------------------
# phase 9: zamba2-2.7b through StateBackend
# ---------------------------------------------------------------------------

def zamba2(seed, tag, n_layers=None, dtype=None):
    """zamba2-2.7b at its published widths (optionally fewer layers and
    another dtype), random weights drawn on the card from ``seed``."""
    cfg = configs.get_config("zamba2-2.7b")
    if n_layers is not None or dtype is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=n_layers or cfg.n_layers,
            dtype=dtype or cfg.dtype,
            name=f"zamba2-2.7b-{n_layers or cfg.n_layers}layer-"
                 f"{dtype or cfg.dtype}")
    model = get_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in [
        params["emb"], params["lm_head"], params["ln_f"],
        *params["mamba"].values(), *params["shared"].values()])
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} Mamba2 layers ({model.nh} SSD "
        f"heads of {cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}), "
        f"{model.n_groups_outer} shared applications ({cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.d_head}), d_model {cfg.d_model}, "
        f"{cfg.dtype}: {nbytes / 1e9:.2f} GB of weights in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def make_state_node(cfg, model, params, *, n_slots=8, n_pages=1024,
                    page_size=16, spool=None, node_id=0, kernel_mode="auto",
                    trace_logits=False, max_batch=8, token_budget=512):
    """(NodeEngine, StateBackend, NodeManager) on the model's device, as a
    user of the port would build them."""
    cost = CostModel(cfg)
    cost.set_param_count(model.param_count())
    mgr = NodeManager(node_id, cfg, cost)
    be = StateBackend(cfg, model, params, n_slots=n_slots, n_pages=n_pages,
                      page_size=page_size, spool_dir=spool, mgr=mgr,
                      trace_logits=trace_logits, kernel_mode=kernel_mode,
                      device=model.device)
    eng = NodeEngine(node_id, cfg, cost, mgr, max_batch=max_batch,
                     backend=be, token_budget=token_budget)
    return eng, be, mgr


class Counted:
    """Steps one StateBackend node and holds the launch rule at every step:
    ssd_scan on every Mamba layer and (hybrid) kernel 1 on every shared
    application of every dispatch, and no plain version anywhere."""

    def __init__(self, node, cfg, plain, now=0.0):
        self.eng, self.be, self.mgr = node
        self.L = cfg.n_layers
        self.A = self.be.n_apps
        self.plain = plain
        self.now = now
        self.steps = []

    def step(self):
        s0, a0 = ssd.launches, pa.launches
        d0 = self.be.stats["sub_dispatches"]
        t0 = time.perf_counter()
        with self.plain():
            self.now += self.eng.step(self.now)
        self.steps.append(time.perf_counter() - t0)
        drained(self.be, self.mgr)
        ds = self.be.stats["sub_dispatches"] - d0
        check(ssd.launches - s0 == self.L * ds,
              f"{ssd.launches - s0} ssd_scan launches for {ds} dispatches "
              f"of {self.L} Mamba layers")
        check(pa.launches - a0 == self.A * ds,
              f"{pa.launches - a0} attention launches for {ds} dispatches "
              f"of {self.A} shared applications")
        check(self.plain.n == 0, f"a plain version ran {self.plain.n} times "
              f"on the kernel path")

    def serve(self, sid, ids, gen):
        req = request(self.be, sid, ids, gen)
        self.eng.submit(req)
        while self.eng.waiting or self.eng.running:
            self.step()
        return req


def state_pool_bytes(be):
    """Device bytes of a StateBackend node's own pools: the slot pools
    (the SSM and conv state of every slot and the trash slot) and, for a
    hybrid, the shared attention's KV pools."""
    pools = list(be.pools.values()) + (
        [be.k_pool, be.v_pool] if be.has_kv else [])
    return sum(t.numel() * t.element_size() for t in pools)


def phase_hybrid(cfg, model, params, seed, tag=9, what="zamba2"):
    """A recurrent model (zamba2-2.7b in phase 9 at 18 of its 54 layers,
    mamba2-2.7b in phase 27 at its 64; bf16, full width) served through
    NodeEngine + NodeManager + StateBackend: 4 sessions x 3 turns of
    256-1024-token prompts and 16 generated tokens; one session swapped out
    after its first turn and back in at its second; at the end one session
    persisted, the node crashed and the session recovered from the spool by a
    second node, where it serves a fourth turn.  Then the rounds again in
    lockstep (kernel path, plain path, float64 plain) and the main path's
    kernel calls re-timed.  The device memory held before the first node (the
    weights), the node's own pools and the peak are logged apart."""
    rng = np.random.default_rng(seed + tag)
    prompts = _turns(rng, cfg.vocab, system=0)
    gen = 16
    plain = PlainCalls()
    with tempfile.TemporaryDirectory() as tmp:
        free_device_memory()
        before = torch.cuda.memory_allocated()
        node = make_state_node(cfg, model, params, spool=f"{tmp}/a")
        eng, be, mgr = node
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pools = torch.cuda.memory_allocated() - before
        check(abs(pools - state_pool_bytes(be)) <= 16 << 20,
              f"the node took {pools} bytes of device memory, its pools "
              f"hold {state_pool_bytes(be)}")
        ssd.launches = pa.launches = 0        # counts of the main path only
        d = Counted(node, cfg, plain)
        reqs = []
        for r, rnd in enumerate(rounds(prompts)):
            for s, t in rnd:
                reqs.append(request(be, f"s{s}", prompts[s][t], gen))
                eng.submit(reqs[-1])
            while eng.waiting or eng.running:
                d.step()
            if r == 1:
                be.swap_out("s1", be.session_tokens("s1"))
                be.drain_transfers()
                drained(be, mgr)
                check("s1" not in be.slots.seqs, "s1 did not leave its slot")
        swaps_in = be.stats["swaps_in"]
        mgr.flush_session("s3", d.now)
        be.drain_transfers()
        check(be.spool_exists("s3"), "the persist wrote no spool file")
        node_b = make_state_node(cfg, model, params, spool=f"{tmp}/b",
                                 node_id=1)
        stats_a = dict(be.stats)
        be.crash()
        mgr.crash(d.now)
        check(node_b[2].recover_from_spool("s3", mgr, d.now),
              "the second node could not recover s3 from the spool")
        d_b = Counted(node_b, cfg, plain, now=d.now)
        extra = [int(x) for x in rng.integers(0, cfg.vocab, 300)]
        reqs.append(d_b.serve("s3", extra, gen))
        torch.cuda.synchronize()
        launches, attn_launches = ssd.launches, pa.launches
        stats_b = dict(node_b[1].stats)
    subs = stats_a["sub_dispatches"] + stats_b["sub_dispatches"]
    steps = d.steps + d_b.steps
    n_tok = sum(len(r.output_ids) for r in reqs)
    log(f"[{tag}] main path: {len(reqs)} requests, {n_tok} generated "
        f"tokens, {eng.stats['prefill_tokens']} prefill tokens in "
        f"{eng.stats['chunks']} chunks, {len(steps)} steps, mean step "
        f"{1e3 * sum(steps) / len(steps):.2f} ms; device memory: "
        f"{before / 1e9:.2f} GB allocated before the phase's nodes, "
        f"{pools / 1e9:.2f} GB of the first node's pools ({be.n_slots} "
        f"slots and the trash slot, {be._state_bytes / 1e6:.1f} MB of state "
        f"each{', and the shared attention KV' if be.has_kv else ''}), "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    log(f"[{tag}] node 0 stats {stats_a}; node 1 stats {stats_b}; buckets "
        f"{be.compile_counts()}")
    log(f"[{tag}] ssd_scan launches {launches} = {cfg.n_layers} Mamba "
        f"layers x {subs} dispatches: {launches == cfg.n_layers * subs}; "
        f"kernel 1 launches {attn_launches} = {be.n_apps} applications x "
        f"{subs}: {attn_launches == be.n_apps * subs}; plain calls "
        f"{plain.n}")
    check(launches == cfg.n_layers * subs > 0
          and attn_launches == be.n_apps * subs,
          "the main path did not run the kernels on every layer")
    check(all(len(r.output_ids) == gen for r in reqs),
          "a request did not generate all its tokens")
    check(stats_a["swaps_out"] >= 1 and swaps_in >= 1
          and stats_a["disk_writes"] >= 1 and stats_b["migrations_in"] == 1,
          f"a tier was not used: {stats_a} / {stats_b}")
    check(eng.stats["chunks"] > len(reqs), "no prompt was chunked")
    has_attn = be.n_apps > 0
    del node, node_b, eng, be, mgr, d, d_b
    free_device_memory()

    # the float64 twin's plain versions: the scan's, and the shared
    # attention's where the model has one
    capa = Capture("paged_chunk_attention")
    caps = Capture("ssd_scan", module=ssd, key=_scan_key)
    a0, s0 = pa.launches, ssd.launches
    lock = Lockstep(lockstep_nodes(lambda mode: make_state_node(
        cfg, model, params, kernel_mode=mode, trace_logits=True)),
        torch.bfloat16, captures=(capa, caps) if has_attn else (caps,),
        f64=((Float64Attention, Float64Scan) if has_attn
             else (Float64Scan,)), flip_floor=True)
    for rnd in rounds(prompts):
        for s, t in rnd:
            lock.submit(f"s{s}", prompts[s][t], gen)
        lock.run()
    check(capa.n == pa.launches - a0 and caps.n == ssd.launches - s0
          and (capa.n > 0) == has_attn and caps.n > 0,
          f"the captures saw {capa.n} / {caps.n} kernel calls of "
          f"{pa.launches - a0} / {ssd.launches - s0}")
    lock.verdict(cfg)
    lock.log(tag)
    log(f"[{tag}] captured {len(capa.calls)} attention and "
        f"{len(caps.calls)} ssd_scan shapes from {capa.n} / {caps.n} calls")
    del lock
    free_device_memory()
    profile_turn(cfg, model, params, rng, gen, tag)
    free_device_memory()
    arecs = (retime(capa, f"{what} main path D={cfg.d_head}", tag)
             if has_attn else [])
    srecs = retime_scan(caps, cfg.ssm.chunk, tag, what)
    torch.cuda.empty_cache()
    return launches, srecs, attn_launches, arecs


KERNEL_FAMILIES = (("ssd_scan", ("ssd_scan", "ssd_decode", "ssd_chunk",
                                 "ssd_state_pass")),
                   ("paged_chunk_attention", ("paged_chunk_attention",)),
                   ("matmul", ("gemm", "cutlass", "cublas", "xmma", "sm90",
                               "nvjet")),
                   ("copy", ("memcpy", "memset")))


def profile_turn(cfg, model, params, rng, gen, tag=9):
    """One turn of a fresh session on a fresh node — a 512-token prompt in
    one chunk, then ``gen`` - 1 decode steps — under torch.profiler, after
    a warm-up turn of the same shapes: device time by kernel family and
    the device's idle share of the window's wall time (1 - device time /
    wall; copies on the side stream could overlap, none run here)."""
    from torch.profiler import ProfilerActivity, profile
    eng, be, _ = make_state_node(cfg, model, params)
    ids = [int(x) for x in rng.integers(0, cfg.vocab, 512)]

    def turn(sid):
        eng.submit(request(be, sid, ids, gen))
        while eng.waiting or eng.running:
            eng.step(0.0)
        torch.cuda.synchronize()

    turn("warm")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        turn("profiled")
        wall = time.perf_counter() - t0
    fam, total, kernels = device_families(prof, KERNEL_FAMILIES)
    other = [(ms, n, name[:60]) for ms, n, name, g in kernels
             if g == "other"]
    if total == 0.0:
        log(f"[{tag}] profile: the trace holds no device time")
        return None
    log(f"[{tag}] profile of one turn (512-token chunk + {gen - 1} decode "
        f"steps): wall {1e3 * wall:.2f} ms, device {total:.2f} ms, idle "
        f"share {1 - total / (1e3 * wall):.3f}; device time by family: "
        f"{fmt_families(fam, total)}")
    log(f"[{tag}] profile: largest 'other' kernels (ms, launches, name): "
        f"{sorted(other, reverse=True)[:6]}")
    return dict(wall_ms=1e3 * wall, device_ms=total, families=fam)


def device_families(prof, families):
    """A torch.profiler trace's device time (ms) by kernel family (the
    first family one of whose words the kernel's name holds, else
    "other"), the total, and every kernel as (ms, launches, name,
    family)."""
    from torch.autograd import DeviceType
    fam, total, kernels = {}, 0.0, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        name = e.key.lower()
        g = next((f for f, words in families
                  if any(w in name for w in words)), "other")
        fam[g] = fam.get(g, 0.0) + t / 1e3              # us -> ms
        total += t / 1e3
        kernels.append((t / 1e3, e.count, e.key, g))
    return fam, total, kernels


def fmt_families(fam, total):
    return ", ".join(f"{g} {ms:.2f} ms ({100 * ms / total:.1f} %)"
                     for g, ms in sorted(fam.items(), key=lambda kv: -kv[1]))


def retime_scan(cap, chunk, tag=9, what="zamba2"):
    """The captured ssd_scan calls, one per distinct shape, held against
    the plain version and timed."""
    recs = []
    for key, (args, kw) in sorted(cap.calls.items(),
                                  key=lambda kv: str(kv[0])):
        x, dA, Bm, Cm = args
        h0 = kw.get("init_state")
        S = x.shape[1]
        label = (f"{what} main path ssd_scan B={x.shape[0]} S={S}"
                 f"{'' if h0 is not None else ' zero state'}")
        rec = compare_scan(x, dA, Bm, Cm, h0, label, chunk=chunk,
                           timed=True)
        log(f"[{tag}]" + fmt(rec))
        recs.append(rec)
    cap.calls.clear()
    log_scan_rates(recs, tag, f"{what} main path ssd_scan")
    return recs


# ---------------------------------------------------------------------------
# phase 10: exact fp32 tokens of zamba2 through the tiers
# ---------------------------------------------------------------------------

def phase_exact_hybrid(seed):
    """zamba2 at full width, 2 groups (12 Mamba layers, 2 shared
    applications), fp32: a session swapped out and back, evicted by memory
    pressure and promoted back, persisted and recovered from the spool
    after a crash serves the dense prefill/decode recompute's tokens."""
    rng = np.random.default_rng(seed + 10)
    cfg, model, params = zamba2(seed + 10, 10, n_layers=12, dtype="float32")
    gen = 16
    turns = [[int(x) for x in rng.integers(0, cfg.vocab, int(n))]
             for n in rng.integers(100, 300, 4)]
    expect = reference_turns(cfg, model, params, turns, gen)
    plain = PlainCalls()
    got = []
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(n_slots=4, n_pages=256, max_batch=4, token_budget=128)
        a = make_state_node(cfg, model, params, spool=f"{tmp}/a", **kw)
        b = make_state_node(cfg, model, params, spool=f"{tmp}/b", node_id=1,
                            **kw)
        da = Counted(a, cfg, plain)
        got.append(da.serve("chat", turns[0], gen).output_ids)
        a[1].swap_out("chat", a[1].session_tokens("chat"))    # to the host
        a[1].drain_transfers()
        got.append(da.serve("chat", turns[1], gen).output_ids)  # back in
        a[2].on_memory_pressure(a[1].hbm_kv_budget() * 10, now=da.now)
        a[1].drain_transfers()
        check("chat" not in a[1].slots.seqs, "pressure did not evict")
        a[2].promote("chat", da.now)                           # prefetch
        a[1].drain_transfers()
        check("chat" in a[1].slots.seqs, "promotion did not bring it back")
        got.append(da.serve("chat", turns[2], gen).output_ids)
        a[2].flush_session("chat", da.now)                     # to the spool
        a[1].drain_transfers()
        moved = {k: a[1].stats[k] for k in (
            "swaps_out", "swaps_in", "layer_evictions", "layer_promotions",
            "disk_writes")}
        a[1].crash()
        a[2].crash(da.now)
        check(b[2].recover_from_spool("chat", a[2], da.now),
              "no recovery from the spool")
        got.append(Counted(b, cfg, plain, now=da.now).serve(
            "chat", turns[3], gen).output_ids)
        moved["recovered"] = b[1].stats["migrations_in"]
    log(f"[10] fp32 12-layer full width, swap out/in -> evict/promote -> "
        f"spool, crash, recover: served {got}")
    log(f"[10] dense recompute {expect}; {moved}")
    check(all(v > 0 for v in moved.values()), f"a tier was not used: {moved}")
    check(got == expect, "fp32 served tokens through the tiers differ from "
          "dense recompute")


# ---------------------------------------------------------------------------
# phase 11: flash_prefill (B.4) against its plain version
# ---------------------------------------------------------------------------

# sha256 (first 16 hex digits) of B.4's float32 output on the fixed inputs
# of flash_fp32_digests(), recorded on the card from the CUDA-core body as
# it was before the bfloat16 body moved to the tensor cores: the float32
# body keeps its arithmetic, so its output must stay bit for bit as it was.
FLASH_FP32_DIGESTS = {
    "B=1 Sq=512 Skv=512 H=32/8 D=128 q_offset=0": "c535f9d946817c36",
    "B=2 Sq=256 Skv=1024 H=32/8 D=128 q_offset=512": "389b29838cbb5f04",
    "B=1 Sq=130 Skv=130 H=36/36 D=64 q_offset=0": "18bb1e583fe94730",
    "B=2 Sq=33 Skv=40 H=16/1 D=128 q_offset=7": "bc790051762f7910",
}
# B, Sq, Skv, H, Hkv, D, q_offset of flash_fp32_digests()
FLASH_DIGEST_CASES = ((1, 512, 512, 32, 8, 128, 0),
                      (2, 256, 1024, 32, 8, 128, 512),
                      (1, 130, 130, 36, 36, 64, 0),
                      (2, 33, 40, 16, 1, 128, 7))


def flash_fp32_digests():
    """{case: digest} of B.4's float32 output on FLASH_DIGEST_CASES, drawn
    on the host from DIGEST_SEED whatever --seed is."""
    rng = np.random.default_rng(DIGEST_SEED + 11)
    out = {}
    for B, Sq, Skv, H, Hkv, D, qo in FLASH_DIGEST_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).cuda()
            for shape in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
        out[f"B={B} Sq={Sq} Skv={Skv} H={H}/{Hkv} D={D} q_offset={qo}"] = \
            digest(fp.flash_prefill(q, k, v, qo))
    return out




def sdpa_prefill(q, k, v, q_offset):
    """One PyTorch call computing the same attention:
    F.scaled_dot_product_attention on head-major copies made here, outside
    the timed call, with is_causal where the queries are the whole
    sequence and an explicit causal mask at q_offset otherwise, GQA through
    enable_gqa.  The port never calls it."""
    Sq, Skv = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    F = torch.nn.functional
    if q_offset == 0 and Sq == Skv:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    mask = qpos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def compare_flash(q, k, v, q_offset, label):
    """B.4 vs its plain version on one input, within TOL x max |plain|;
    the kernel's, the plain version's and SDPA's times, and the bound."""
    def kern():
        return fp.flash_prefill(q, k, v, q_offset)

    def plain():
        return ref.flash_prefill_ref(q, k, v, q_offset)

    out = kern()
    torch.cuda.synchronize()
    want = plain()
    check(bool(torch.isfinite(out.float()).all()),
          f"{label}: kernel output not finite")
    err = (out.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    lim = TOL[q.dtype] * scale
    check(err <= lim, f"{label}: max abs err {err:.3g} > {TOL[q.dtype]} x "
          f"max|plain| {scale:.3g} = {lim:.3g}")
    nbytes, flops = flash_work(q, k, q_offset)
    b_ms, b_by, t_b, t_f = bound(nbytes, flops, q.dtype)
    return dict(label=label, max_abs_err=err, err_rel=err / scale,
                ms=cuda_ms(kern, 10), device_ms=device_ms(kern, 10),
                plain_ms=cuda_ms(plain, 3),
                library_ms=cuda_ms(sdpa_prefill(q, k, v, q_offset), 10),
                bound_ms=b_ms, bound_by=b_by, bytes_ms=t_b, ops_ms=t_f,
                flops=flops)


def fmt_rate(recs) -> str:
    """Achieved TFLOP/s, share of the bound and ratio to SDPA of one
    record or, for a list, of their sums."""
    recs = recs if isinstance(recs, list) else [recs]
    ms = sum(r["ms"] for r in recs)
    return (f"{sum(r['flops'] for r in recs) / ms / 1e9:.1f} TFLOP/s, "
            f"{sum(r['bound_ms'] for r in recs) / ms:.4f} of the bound, "
            f"{ms / sum(r['library_ms'] for r in recs):.3f} x SDPA")


def flash_resources(built):
    """B.4's bodies as ptxas built them (when phase 2 compiled them in
    this run) and as the runtime reports them."""
    text = built.get(fp.NAME, (None, ""))[1] if built else ""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "flash_prefill" in line:
            body = "tc" if "flash_prefill_tc" in line else "fp32 CUDA-core"
            dim = next(d for d in fp.HEAD_DIMS if f"Li{d}E" in line)
            info = [x.strip() for x in lines[i + 1:i + 4]
                    if "spill" in x or "Used" in x]
            log(f"[11] ptxas, {body} body at D = {dim}: {'; '.join(info)}")
    for dtype in (torch.bfloat16, torch.float32):
        for d in fp.HEAD_DIMS:
            log(f"[11] runtime, {str(dtype).split('.')[-1]} at D = {d}: "
                f"{fp.resources(dtype, d)}")
    for name, counts in sass_counts(fp.NAME):
        body = "tc" if "flash_prefill_tc" in name else "fp32 CUDA-core"
        dim = next(d for d in fp.HEAD_DIMS if f"Li{d}E" in name)
        log(f"[11] SASS, {body} body at D = {dim}: {counts}")
        check((counts["HGMMA"] > 0) == (body == "tc") and not counts["HMMA"],
              f"B.4's {body} body at D = {dim} runs {counts}")


def phase_flash_vs_plain(seed, built=None):
    """B.4 at llama3-8b widths (H = 32, Hkv = 8, D = 128), bf16 and fp32:
    one lane at Sq = Skv in {1, 100, 512, 1568, 4096}; two lanes of 256 new
    tokens at q_offset 512 over Skv = 1024 keys (the last 256 padding).
    The continuation, seen as pages of 16 with identity tables, q_offsets
    512 and ctx_lens 768, is kernel 1's input: kernel 1 must agree.  The
    float32 body's outputs on flash_fp32_digests() must equal
    FLASH_FP32_DIGESTS bit for bit."""
    flash_resources(built)
    got = flash_fp32_digests()
    changed = sorted(c for c in got.keys() | FLASH_FP32_DIGESTS.keys()
                     if got.get(c) != FLASH_FP32_DIGESTS.get(c))
    check(not changed, f"B.4's float32 output moved on {changed}")
    log(f"[11] float32 B.4 on {len(got)} cases: bit-identical to the "
        f"recorded digests")
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases = [(f"B=1 Sq=Skv={S}", 1, S, S, 0) for S in (1, 100, 512, 1568,
                                                       4096)]
    cases.append(("B=2 q_offset=512 Sq=256 Skv=1024", 2, 256, 1024, 512))
    H, Hkv, D, page = 32, 8, 128, 16
    recs = []
    for label, B, Sq, Skv, qo in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(B, Sq, H, D).to(dtype)
            k, v = randn(B, Skv, Hkv, D).to(dtype), randn(B, Skv, Hkv,
                                                          D).to(dtype)
            name = f"flash_prefill {label} {str(dtype).split('.')[-1]}"
            rec = compare_flash(q, k, v, qo, name)
            log("[11]" + fmt(rec))
            log(f"[11]   {fmt_rate(rec)}")
            recs.append(rec)
            if qo:
                n = Skv // page
                tab = torch.arange(B * n, dtype=torch.int32,
                                   device="cuda").view(B, n)
                qoffs = torch.full((B,), qo, dtype=torch.int32,
                                   device="cuda")
                ctx = torch.full((B,), qo + Sq, dtype=torch.int32,
                                 device="cuda")
                k1 = KERNEL(q, k.view(B * n, page, Hkv, D),
                            v.view(B * n, page, Hkv, D), tab, qoffs, ctx)
                out = fp.flash_prefill(q, k, v, qo)
                err = (out.float() - k1.float()).abs().max().item()
                lim = TOL[dtype] * k1.float().abs().max().item()
                check(err <= lim, f"{name}: B.4 and kernel 1 on identity "
                      f"tables differ by {err:.3g} > {lim:.3g}")
                log(f"[11]   kernel 1 on identity tables: max abs diff "
                    f"{err:.3g} (limit {lim:.3g})")
            del q, k, v
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 12: the cluster runtime at full width, and its dense reference
# ---------------------------------------------------------------------------

def cluster(cfg, model, params, **kw):
    """A real-mode cluster on the model's device (three nodes unless
    ``node_groups`` says otherwise), as a user of the port builds it: the
    SYMPHONY policy, the nodes of a group sharing one ``params``."""
    kw = {**dict(n_nodes=3, device=model.device), **kw}
    return ClusterRuntime(cfg, policy="symphony", mode="real", max_batch=8,
                          page_size=16, n_pages=1024, token_budget=512,
                          model=model, params=params, trace_logits=False,
                          **kw)


def run_cluster(rt, trace, tag):
    """``rt.run(trace)`` with the invariants of every live node after it
    (allocators, slots, store) and the kernel-1 launches of its dense
    nodes (its mamba2 nodes have no attention); returns (result, dead
    nodes, seconds)."""
    dense = [i for i, c in rt.cfgs.items() if c.family == "dense"]
    torch.cuda.synchronize()
    a0, t0 = pa.launches, time.perf_counter()
    res = rt.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dead = [i for i, st in rt.sched.nodes.items() if not st.alive]
    for i in rt.managers:
        if i not in dead:
            drained(rt.backends[i], rt.managers[i])
    want = sum(rt.cfgs[i].n_layers * rt.backends[i].stats["sub_dispatches"]
               for i in dense)
    check(pa.launches - a0 == want and want > 0,
          f"[{tag}] kernel 1 launched {pa.launches - a0} times, not "
          f"n_layers x sub-dispatches = {want}")
    return res, dead, wall


def cluster_summary(rt, res, trace):
    """Migrations, recoveries, the recompute path's extra prefill tokens,
    the cluster's prefill tokens, and its engines' measured busy seconds
    over their dispatches (the mean wall time of a dispatch)."""
    m = res.metrics()
    per = m["per_node"].values()
    prompt = sum(len(t) for turns in trace.prompts.values() for t in turns)
    prefill = sum(n["prefill_tokens"] for n in per)
    shared = sum(e.stats["shared_prefix_tokens"]
                 for e in rt.engines.values())
    busy = sum(n["busy_s"] for n in per)
    dispatches = sum(be.stats["sub_dispatches"] for be in rt.backends.values())
    return dict(completed=m["completed"],
                migrations=sum(n["migrations"] for n in per),
                recoveries=sum(n["recoveries"] for n in per),
                recompute_tokens=prefill + shared - prompt,
                prefill_tokens=prefill, shared_prefix_tokens=shared,
                disk_writes=sum(n["disk_writes"] for n in per),
                busy_s=busy, dispatches=dispatches,
                ms_per_dispatch=1e3 * busy / max(dispatches, 1))


def reference_prefill_tokens(prompts, gen):
    """Tokens the full-history recompute prefills: every turn re-prefills
    the session's whole history."""
    total = 0
    for turns in prompts.values():
        hist = 0
        for t in turns:
            hist += len(t)
            total += hist
            hist += gen
    return total


def _flash64(q, k, v, q_offset=0):
    """The plain prefill attention's math in float64 (the port's plain
    version computes in float32): the rounding reference of the twin."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).double()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / D ** 0.5
    qpos = q_offset + torch.arange(Sq, device=q.device)
    mask = qpos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
    s = s.masked_fill(~mask, ref.MASK_VALUE)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1),
                     v.double())
    return o.reshape(B, Sq, H, D).to(q.dtype)


class ReferenceTwin:
    """While active, the dense reference's prefills run on the kernel path
    (K: B.4 on every layer and no plain call, checked at each prefill), and
    each is repeated on the same tokens on the plain path (P) and on the
    plain path with its attention in float64 (R).  The last-position logits
    are held as `Lockstep` holds final chunks: K within the tolerance of P
    or twice P's distance from R, K no further from R than twice P is; a
    token K picks that P or R does not is a flip, whose twin logit gap must
    be within the tolerance.  The reference goes on with K's tokens.  Every
    logit vector the reference reads, prefill and decode, is kept on the
    host in call order (``trail``)."""

    def __init__(self, model, dtype, captures=()):
        self.model = model
        self.tol = TOL[dtype]
        self.captures = captures
        self.plain = PlainCalls()
        self.res = dict(KP=0.0, PR=0.0, KR=0.0, flips=[], prefills=0)
        self.trail = []

    def _hold(self, lk, lp, lr):
        vocab = self.model.cfg.vocab
        lg = {x: t[0, :vocab].float().cpu().numpy()
              for x, t in (("K", lk), ("P", lp), ("R", lr))}
        for pr in ("KP", "PR", "KR"):
            y = lg[pr[1]]
            err = float(np.abs(lg[pr[0]] - y).max())
            self.res[pr] = max(self.res[pr],
                               err / (self.tol * float(np.abs(y).max())))
        tk = int(lg["K"].argmax())
        for x in "PR":
            tx = int(lg[x].argmax())
            if tx != tk:
                gap = float(lg[x][tx] - lg[x][tk])
                units = gap / (self.tol * float(np.abs(lg[x]).max()))
                self.res["flips"].append((x, self.res["prefills"], tk, tx,
                                          units))
                check(units <= 1.0, f"reference prefill {self.res['prefills']}"
                      f": token {tk} (kernel) vs {tx} ({x}) with a logit "
                      f"gap {units:.3g} x the tolerance")
        return lg["K"]

    @contextlib.contextmanager
    def __call__(self):
        model = self.model
        orig_p, orig_d = model.prefill, model.decode_step
        vocab = model.cfg.vocab

        def prefill(params, tokens, kernel_mode="auto"):
            f0, n0 = fp.launches, self.plain.n
            with contextlib.ExitStack() as stack:
                stack.enter_context(self.plain())
                for c in self.captures:
                    stack.enter_context(c())
                lk, cache = orig_p(params, tokens, kernel_mode=kernel_mode)
            check(fp.launches - f0 == model.cfg.n_layers
                  and self.plain.n == n0,
                  f"a reference prefill launched B.4 {fp.launches - f0} "
                  f"times for {model.cfg.n_layers} layers, with "
                  f"{self.plain.n - n0} plain calls")
            lp, _ = orig_p(params, tokens, kernel_mode="ref")
            saved = ref.flash_prefill_ref
            ref.flash_prefill_ref = _flash64
            try:
                lr, _ = orig_p(params, tokens, kernel_mode="ref")
            finally:
                ref.flash_prefill_ref = saved
            self.trail.append(self._hold(lk, lp, lr))
            self.res["prefills"] += 1
            return lk, cache

        def decode_step(params, cache, tokens):
            logits, cache = orig_d(params, cache, tokens)
            self.trail.append(logits[0, :vocab].float().cpu().numpy())
            return logits, cache

        model.prefill, model.decode_step = prefill, decode_step
        try:
            yield
        finally:
            del model.prefill, model.decode_step

    def verdict(self):
        res = self.res
        check(res["KP"] <= max(1.0, 2 * res["PR"]),
              f"reference prefill logits: kernel vs plain at "
              f"{res['KP']:.3g} x the tolerance, noise floor "
              f"{res['PR']:.3g} x")
        check(res["KR"] <= 2 * max(res["PR"], 1e-3),
              f"reference prefill logits: the kernel path is "
              f"{res['KR']:.3g} x the tolerance from the float64 path, the "
              f"plain path {res['PR']:.3g} x")


def served_vs_reference(prompts, got, want, trail, gen, tol):
    """Turns the cluster served equal to the reference's, and each
    session's first differing token held to the flip rule by the
    reference's logit gap at that position (later turns of that session
    have another history, so they are not compared).  ``trail`` holds the
    reference's logits in its call order: per turn, the prefill's and then
    one per decode step."""
    equal, total, firsts, idx = 0, 0, [], 0
    for sid, turns in prompts.items():
        diverged = False
        for t in range(len(turns)):
            seg = trail[idx:idx + gen + 1]
            idx += gen + 1
            g, w = got[sid][t], want[sid][t]
            total += 1
            if g == w:
                equal += 1
                continue
            if diverged:
                continue
            diverged = True
            i = next(j for j in range(gen) if g[j] != w[j])
            lg = seg[i]
            units = float(lg[w[i]] - lg[g[i]]) / (tol * float(
                np.abs(lg).max()))
            firsts.append((sid, t, i, g[i], w[i], units))
            check(units <= 1.0, f"{sid} turn {t} token {i}: the cluster "
                  f"served {g[i]}, the reference {w[i]}, whose logit gap is "
                  f"{units:.3g} x the tolerance")
    check(idx == len(trail), f"the reference read {len(trail)} logit "
          f"vectors, not {idx}")
    return equal, total, firsts


def phase_cluster(cfg, model, params, seed, card):
    """llama3-8b (32 layers, bf16) on a three-node cluster: (a) the
    deterministic migration + failure trace, (b) a shared-prefix cohort on
    a fresh cluster; then the dense reference of both, B.4 on every layer
    of every prefill, held against its plain twins, and the cluster's
    turns against the reference's."""
    gen = 16
    traces = dict(
        a=MultiTurnRealTrace(cfg, n_sessions=2, n_turns=3, prompt_len=512,
                             gen=gen, seed=seed + 12, fail_after_turn=2),
        b=SharedPrefixTrace(cfg, n_sessions=4, shared_len=512,
                            suffix_len=128, gen=gen, seed=seed + 12))
    served, sums = {}, {}
    for name, trace in traces.items():
        rt = cluster(cfg, model, params)
        try:
            res, dead, wall = run_cluster(rt, trace, f"12{name}")
            served[name] = session_outputs(res)
            sums[name] = s = cluster_summary(rt, res, trace)
            log(f"[12{name}] {s['completed']} turns in {wall:.2f} s; "
                f"{s}; dead nodes {dead}")
            log(f"[12{name}] per node: " + "; ".join(
                f"{i}: {rt.engines[i].stats['prefill_tokens']} prefill, "
                f"{rt.managers[i].stats.get('migrations', 0)} migrations, "
                f"{rt.managers[i].stats.get('recoveries', 0)} recoveries, "
                f"{rt.backends[i].stats['sub_dispatches']} dispatches"
                for i in sorted(rt.engines)))
            check(all(len(t) == gen for turns in served[name].values()
                      for t in turns), "a turn did not generate all its "
                  "tokens")
            if name == "a":
                check(s["completed"] == 6, f"{s['completed']} of 6 turns")
                path = ("spool recovery" if s["recoveries"] else
                        "full-history recompute" if s["recompute_tokens"] > 0
                        else None)
                check(s["migrations"] >= 1 and path is not None,
                      f"no advisory migration or no recovery path: {s}")
                check(len(dead) == 1
                      and rt.sched.nodes[dead[0]].outstanding == 0,
                      f"dead nodes {dead}, outstanding "
                      f"{[rt.sched.nodes[i].outstanding for i in dead]}")
                log(f"[12a] the orphaned session came back by {path}")
            else:
                nodes = {r.node_id for r in res.completed}
                check(len(nodes) == 1, f"cohort split across {nodes}")
                node = nodes.pop()
                hits = rt.backends[node].stats["prefix_hits"]
                check(s["shared_prefix_tokens"] == 3 * 512 and hits == 3,
                      f"node {node}: {s['shared_prefix_tokens']} shared "
                      f"prefix tokens, {hits} prefix hits")
        finally:
            rt.cleanup()
            del rt
            free_device_memory()

    cap = Capture("flash_prefill", module=fp,
                  key=lambda args, kw: (tuple(args[0].shape),
                                        tuple(args[1].shape)))
    twin = ReferenceTwin(model, cfg_dtype(cfg), captures=(cap,))
    torch.cuda.synchronize()
    fp.launches = 0                          # counts of the main path only
    t0 = time.perf_counter()
    want = {}
    with twin():
        for name, trace in traces.items():
            want[name] = dense_reference(cfg, model, params, trace.prompts,
                                         gen)
    torch.cuda.synchronize()
    launches = fp.launches
    n_pre = twin.res["prefills"]
    log(f"[12] dense reference: {n_pre} prefills in "
        f"{time.perf_counter() - t0:.2f} s with its twins; B.4 launches "
        f"{launches} = {cfg.n_layers} layers x {n_pre} prefills: "
        f"{launches == cfg.n_layers * n_pre}; plain calls on its path "
        f"{twin.plain.n}")
    check(launches == cfg.n_layers * n_pre == cfg.n_layers * sum(
        len(t) for tr in traces.values() for t in tr.prompts.values()),
        "B.4 did not run on every layer of every reference prefill")
    twin.verdict()
    log(f"[12] reference prefill logits in units of 2e-2 x max|logit|: "
        f"kernel vs plain {twin.res['KP']:.3g}, plain vs float64 attention "
        f"{twin.res['PR']:.3g}, kernel vs float64 {twin.res['KR']:.3g}; "
        f"flips (twin, prefill, kernel, twin, gap in units) "
        f"{twin.res['flips']}")
    idx = 0
    for name, trace in traces.items():
        n = sum(len(t) for t in trace.prompts.values()) * (gen + 1)
        equal, total, firsts = served_vs_reference(
            trace.prompts, served[name], want[name],
            twin.trail[idx:idx + n], gen, TOL[cfg_dtype(cfg)])
        idx += n
        ref_tok = reference_prefill_tokens(trace.prompts, gen)
        got_tok = sums[name]["prefill_tokens"]
        log(f"[12{name}] cluster vs dense reference, bf16: {equal} of "
            f"{total} turns equal ({equal / total:.3f}); first differing "
            f"tokens (sid, turn, position, cluster, reference, reference "
            f"logit gap in units of the tolerance): {firsts}")
        log(f"[12{name}] prefill tokens: cluster {got_tok}, full-history "
            f"recompute {ref_tok}: recompute prefills "
            f"{ref_tok - got_tok} redundant tokens, "
            f"{1 - got_tok / ref_tok:.4f} of its prefill ({card})")
    del twin
    free_device_memory()
    recs = []
    for key, (args, _) in sorted(cap.calls.items()):
        q, k, v = args[:3]
        qo = int(args[3]) if len(args) > 3 else 0
        rec = compare_flash(q, k, v, qo, f"reference prefill B={q.shape[0]} "
                            f"Sq={q.shape[1]} Skv={k.shape[1]}")
        log("[12]" + fmt(rec))
        log(f"[12]   {fmt_rate(rec)}")
        recs.append(rec)
    if recs:
        log(f"[12] B.4 over the reference's {len(recs)} shapes: "
            f"{sum(r['ms'] for r in recs):.4g} ms, SDPA "
            f"{sum(r['library_ms'] for r in recs):.4g} ms, bound "
            f"{sum(r['bound_ms'] for r in recs):.4g} ms; {fmt_rate(recs)}")
    cap.calls.clear()
    torch.cuda.empty_cache()
    return launches, recs


def cfg_dtype(cfg):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


# ---------------------------------------------------------------------------
# phase 13: exact fp32 tokens through the cluster
# ---------------------------------------------------------------------------

def mamba2_4layer(seed):
    """mamba2-2.7b at its published widths, 4 layers, float32, random
    weights drawn on the card from ``seed``."""
    cfg = dataclasses.replace(configs.get_config("mamba2-2.7b"), n_layers=4,
                              shared_every=4, dtype="float32",
                              name="mamba2-2.7b-4layer-fp32")
    model = get_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    return cfg, model, params


def phase_exact_cluster(seed):
    """(i) The cluster of phase 12(a) with llama3-8b at full width, 2
    layers, fp32: served tokens equal the dense reference exactly.  (ii)
    The mixed cluster of tests/test_cluster_mixed.py at full width: 2
    RealBackend nodes (that llama) and 2 StateBackend nodes (mamba2-2.7b,
    4 layers, fp32); the recurrent session migrates on an advisory and the
    node that served its turn 2 fails.  Every session equals its family's
    dense reference."""
    cfg, model, params = fp32_2layer(seed + 13)
    gen = 16
    trace = MultiTurnRealTrace(cfg, n_sessions=2, n_turns=3, prompt_len=512,
                               gen=gen, seed=seed + 13, fail_after_turn=2)
    rt = cluster(cfg, model, params)
    try:
        res, dead, _ = run_cluster(rt, trace, "13")
        s = cluster_summary(rt, res, trace)
    finally:
        rt.cleanup()
    got = session_outputs(res)
    want = dense_reference(cfg, model, params, trace.prompts, gen)
    log(f"[13] fp32 2-layer cluster: {s}; dead {dead}; served {got}")
    log(f"[13] dense reference {want}")
    check(s["migrations"] >= 1 and (s["recoveries"] >= 1
                                    or s["recompute_tokens"] > 0)
          and len(dead) == 1, f"no migration or recovery: {s}")
    check(got == want, "fp32 cluster tokens differ from the dense reference")
    del rt, res
    free_device_memory()

    mcfg, mmodel, mparams = mamba2_4layer(seed + 14)
    gen = 8
    ttrace = MultiTurnRealTrace(cfg, n_sessions=2, n_turns=2, prompt_len=128,
                                gen=gen, seed=seed + 13, sid_prefix="t")
    mtrace = MultiTurnRealTrace(mcfg, n_sessions=1, n_turns=3,
                                prompt_len=128, gen=gen, seed=seed + 14,
                                group="mamba2", sid_prefix="m",
                                fail_after_turn=2, fail_session="m0")
    rt = cluster(cfg, model, params, node_groups={
        "default": dict(cfg=cfg, n_nodes=2, model=model, params=params),
        "mamba2": dict(cfg=mcfg, n_nodes=2, model=mmodel, params=mparams)})
    try:
        res, dead, _ = run_cluster(rt, MixedTrace(ttrace, mtrace), "13")
        mnodes = [i for i, g in rt.node_group.items() if g == "mamba2"]
        moved = sum(rt.managers[i].stats.get("migrations", 0)
                    + rt.managers[i].stats.get("recoveries", 0)
                    for i in mnodes)
        placed = all(rt.node_group[r.node_id] == ("mamba2" if r.session_id
                                                  .startswith("m")
                                                  else "default")
                     for r in res.completed)
        outstanding = [rt.sched.nodes[i].outstanding for i in dead]
    finally:
        rt.cleanup()
    got = session_outputs(res)
    want = dense_reference(cfg, model, params, ttrace.prompts, gen)
    want.update(dense_reference(mcfg, mmodel, mparams, mtrace.prompts, gen))
    log(f"[13] mixed cluster (2 llama3-8b 2-layer + 2 mamba2-2.7b 4-layer "
        f"nodes, fp32): recurrent migrations + recoveries {moved}, dead "
        f"{dead}; served {got}")
    log(f"[13] dense references {want}")
    check(placed, "a session was served outside its group")
    check(moved >= 1 and len(dead) == 1 and dead[0] in mnodes
          and outstanding == [0], f"recurrent state did not move, or the "
          f"failure was not the recurrent node's: moved {moved}, dead "
          f"{dead}, outstanding {outstanding}")
    check(got == want, "mixed cluster tokens differ from the dense "
          "references")
    del rt, res, model, params, mmodel, mparams
    free_device_memory()


# ---------------------------------------------------------------------------
# phase 14: the decode kernel (B.3) against its plain version and kernel 1
# ---------------------------------------------------------------------------

DKERNEL = pa.paged_attention              # counts pa.decode_launches


def decode_cases(rng):
    """(label, B, ctxs, H, Hkv, D) of phase 14: llama3-8b's heads at B = 1,
    8 and 32 with ctx up to 4096 (a ctx = 0 lane in the batches),
    zamba2-2.7b's shared attention (H = Hkv = 32, D = 80) and a G = 1 case
    at D = 64 (minicpm's 36 heads)."""
    cases = [("decode B=1 ctx=4096", 1, [4096], 32, 8, 128)]
    for B in (8, 32):
        ctxs = [int(c) for c in rng.integers(1024, 4097, B)]
        ctxs[0], ctxs[-1] = 4096, 0
        cases.append((f"decode B={B} ctx<=4096", B, ctxs, 32, 8, 128))
    ctxs = [int(c) for c in rng.integers(256, 2049, 8)]
    ctxs[-1] = 0
    cases.append(("zamba2 shared decode B=8 H=Hkv=32 D=80", 8, ctxs, 32, 32,
                  80))
    ctxs = [int(c) for c in rng.integers(256, 2049, 8)]
    ctxs[-1] = 0
    cases.append(("G=1 decode B=8 H=Hkv=36 D=64", 8, ctxs, 36, 36, 64))
    return cases


def compare_decode(q4, kp, vp, tab, qoff, ctx, dtype, label):
    """B.3 on q4[:, 0] against its plain version and against kernel 1 at
    Sq = 1 on the same inputs: each within TOL x max |plain| over the real
    lanes, ctx = 0 lanes exactly zero; times of B.3, the plain version,
    SDPA on gathered K/V, kernel 1 at Sq = 1, and the bound.  The record's
    ``calls`` counts the B.3 calls made here."""
    q = q4[:, 0].contiguous()
    calls = [0]

    def kern():
        calls[0] += 1
        return DKERNEL(q, kp, vp, tab, ctx)

    def k1():
        return KERNEL(q4, kp, vp, tab, qoff, ctx)
    out_k = kern()
    out_1 = k1()[:, 0]
    torch.cuda.synchronize()
    out_r = ref.paged_attention_ref(q, kp, vp, tab, ctx)
    check(bool(torch.isfinite(out_k.float()).all()),
          f"{label}: B.3 output not finite")
    real = ctx > 0
    check(bool((out_k[~real] == 0).all()),
          f"{label}: a ctx=0 lane is not exactly zero")
    scale = float(out_r[real].float().abs().max())
    err = float((out_k[real].float() - out_r[real].float()).abs().max())
    err1 = float((out_k[real].float() - out_1[real].float()).abs().max())
    lim = TOL[dtype] * scale
    check(err <= lim, f"{label}: max abs err {err:.3g} > {TOL[dtype]} x "
          f"max|plain| {scale:.3g} = {lim:.3g}")
    check(err1 <= lim, f"{label}: B.3 and kernel 1 at Sq = 1 differ by "
          f"{err1:.3g} > {lim:.3g}")
    _, page, hkv, d = kp.shape
    q_lens = real.int().cpu().tolist()
    nbytes, flops = attention_work(q4, tab, qoff, ctx, page, hkv, d,
                                   q.element_size(), q_lens)
    b_ms, b_by, t_b, t_f = bound(nbytes, flops, dtype)
    t = [cuda_ms(f, 20) for f in (kern, k1, k1, kern)]   # in turns
    return dict(
        label=label, max_abs_err=err, err_rel=err / scale, k1_err=err1,
        ms=0.5 * (t[0] + t[3]), k1_ms=0.5 * (t[1] + t[2]),
        device_ms=device_ms(kern), host_ms=host_ms(kern),
        k1_device_ms=device_ms(k1), flops=flops, nbytes=nbytes,
        plain_ms=cuda_ms(lambda: ref.paged_attention_ref(q, kp, vp, tab,
                                                         ctx), 5),
        library_ms=cuda_ms(sdpa_yardstick(q4, kp, vp, tab, qoff, ctx), 20),
        bound_ms=b_ms, bound_by=b_by, bytes_ms=t_b, ops_ms=t_f,
        calls=calls[0])


def fmt_decode(rec) -> str:
    return fmt(rec) + f" kernel1_ms={rec['k1_ms']:.4g} " \
        f"kernel1_device_ms={rec['k1_device_ms'] or 0.0:.4g} " \
        f"|B.3 - kernel1|={rec['k1_err']:.3g}"


def log_decode_rates(recs, what):
    """B.3's summed ms, device and host ms against kernel 1 at Sq = 1, SDPA
    and the bound, with the achieved GB/s and the share of the (bytes)
    bound over the device time, per record and summed."""
    def rate(sub):
        dev = sum(r["device_ms"] or r["ms"] for r in sub)
        ms = sum(r["ms"] for r in sub)
        lib = sum(r["library_ms"] for r in sub)
        return (f"{sum(r['nbytes'] for r in sub) / dev / 1e6:.1f} GB/s, "
                f"{sum(r['bound_ms'] for r in sub) / dev:.4f} of the bound "
                f"(device), {ms / lib:.3f} x SDPA (ms), "
                f"{dev / sum(r['k1_device_ms'] or 0.0 for r in sub):.3f} x "
                f"kernel 1 (device)")
    for r in recs:
        log(f"[14]   {r['label']}: {rate([r])}")
    log(f"[14] {what} ({len(recs)}): B.3 {sum(r['ms'] for r in recs):.4g} "
        f"ms (device {sum(r['device_ms'] or 0.0 for r in recs):.4g}, host "
        f"{sum(r['host_ms'] for r in recs):.4g}), kernel 1 at Sq = 1 "
        f"{sum(r['k1_ms'] for r in recs):.4g} ms (device "
        f"{sum(r['k1_device_ms'] or 0.0 for r in recs):.4g}), SDPA "
        f"{sum(r['library_ms'] for r in recs):.4g} ms, bound "
        f"{sum(r['bound_ms'] for r in recs):.4g} ms; {rate(recs)}")


def decode_resources():
    """B.3's split kernel as the runtime reports it at every head dim in
    both dtypes (no local memory: no spills), and the library's machine
    code: no tensor-core product (HGMMA, HMMA) in the split kernel or the
    merge."""
    for dtype in (torch.bfloat16, torch.float32):
        for d in pa.DECODE_HEAD_DIMS:
            res = pa.decode_resources(dtype, d)
            log(f"[14] runtime, B.3 {str(dtype).split('.')[-1]} at D = {d}: "
                f"{res}")
            check(res["local_bytes"] == 0,
                  f"B.3 at D = {d} uses local memory")
    for name, counts in sass_counts(pa.DECODE_NAME):
        log(f"[14] SASS, {name[:60]}: {counts}")
        check(counts["HGMMA"] == 0 and counts["HMMA"] == 0,
              f"{name} runs {counts}")


def phase_decode_vs_plain(rng, replay):
    """B.3 on phase 14's cases in bf16 and fp32, then on every decode-only
    kernel-1 call phase 4 captured (``replay``; empty when phase 4 did not
    run).  Each B.3 call made here must add exactly one to
    ``pa.decode_launches``.  Returns (the cases' records, the replayed
    calls' records)."""
    decode_resources()
    d0, recs = pa.decode_launches, []
    for label, B, ctxs, H, Hkv, D in decode_cases(rng):
        for dtype in (torch.bfloat16, torch.float32):
            q4, kp, vp, tab, qoff, ctx = make_case(
                rng, B, 1, ctxs, [int(c > 0) for c in ctxs], dtype, H=H,
                Hkv=Hkv, D=D)
            rec = compare_decode(q4, kp, vp, tab, qoff, ctx, dtype,
                                 f"{label} {str(dtype).split('.')[-1]}")
            log("[14]" + fmt_decode(rec))
            recs.append(rec)
            del q4, kp, vp
        torch.cuda.empty_cache()
    rrecs = []
    for q4, kp, vp, tab, qoff, ctx in replay:
        rec = compare_decode(q4, kp, vp, tab, qoff, ctx, q4.dtype,
                             f"phase 4 decode B={q4.shape[0]} "
                             f"T={tab.shape[1]}")
        log("[14]" + fmt_decode(rec))
        rrecs.append(rec)
    for dtype in ("bfloat16", "float32"):
        log_decode_rates([r for r in recs if r["label"].endswith(dtype)],
                         f"phase 14 cases, {dtype}")
    if rrecs:
        log_decode_rates(rrecs, "phase 4's decode calls replayed")
    made = sum(r["calls"] for r in recs + rrecs)
    check(pa.decode_launches - d0 == made,
          f"B.3's count rose by {pa.decode_launches - d0} over {made} calls")
    log(f"[14] {len(recs)} cases within tolerance; replayed "
        f"{len(rrecs)} decode-only kernel-1 calls of phase 4 through B.3, "
        f"all within tolerance of kernel 1; {made} B.3 calls, each counted "
        f"once")
    replay.clear()
    torch.cuda.empty_cache()
    return recs, rrecs


# ---------------------------------------------------------------------------
# phase 15: xlstm-1.3b through StateBackend
# ---------------------------------------------------------------------------

def xlstm(seed, tag, n_layers=None, dtype=None):
    """xlstm-1.3b at its published widths (optionally fewer blocks and
    another dtype), random weights drawn on the card from ``seed``."""
    cfg = configs.get_config("xlstm-1.3b")
    if n_layers is not None or dtype is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=n_layers or cfg.n_layers, dtype=dtype or cfg.dtype,
            name=f"xlstm-1.3b-{n_layers or cfg.n_layers}block-"
                 f"{dtype or cfg.dtype}")
    model = get_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in [
        params["emb"], params["lm_head"], params["ln_f"],
        *params["mlstm"].values(), *params["slstm"].values()])
    log(f"[{tag}] {cfg.name}: {model.n_m} mLSTM + {model.n_s} sLSTM blocks "
        f"in {model.n_groups} groups, d_model {cfg.d_model}, {model.nh} "
        f"heads (d_qk {model.d_qk}, d_v {model.d_v}), sLSTM FFN "
        f"{model.d_ffn_s}, {cfg.dtype}: {nbytes / 1e9:.2f} GB of weights in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, params


class Trail:
    """While active, every logit vector the dense reference reads
    (prefill and decode) is kept on the host in call order."""

    def __init__(self, model):
        self.model = model
        self.trail = []

    @contextlib.contextmanager
    def __call__(self):
        model, vocab = self.model, self.model.cfg.vocab
        orig_p, orig_d = model.prefill, model.decode_step

        def keep(out):
            self.trail.append(out[0][0, :vocab].float().cpu().numpy())
            return out

        model.prefill = lambda *a, **kw: keep(orig_p(*a, **kw))
        model.decode_step = lambda *a, **kw: keep(orig_d(*a, **kw))
        try:
            yield
        finally:
            del model.prefill, model.decode_step


class SLSTMClock:
    """While active, each sLSTM scan is timed between two synchronizes."""

    def __init__(self, model):
        self.model = model
        self.s = 0.0
        self.n = 0

    @contextlib.contextmanager
    def __call__(self):
        model = self.model
        orig = model._slstm_scan

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            torch.cuda.synchronize()
            self.s += time.perf_counter() - t0
            self.n += 1
            return out

        model._slstm_scan = timed
        try:
            yield
        finally:
            del model._slstm_scan


def serve_all(d, reqs):
    """Submit ``reqs`` ((sid, ids, gen)) to node ``d`` and step it until it
    is idle; returns the requests.  Each step's wall time goes to
    d["steps"] with whether it was decode-only (no prompt token)."""
    eng, be, mgr = d["node"]
    out = [request(be, sid, ids, gen) for sid, ids, gen in reqs]
    for r in out:
        eng.submit(r)
    while eng.waiting or eng.running:
        p0, t0 = eng.stats["prefill_tokens"], time.perf_counter()
        d["now"] += eng.step(d["now"])
        d["steps"].append((time.perf_counter() - t0,
                           eng.stats["prefill_tokens"] == p0))
        drained(be, mgr)
    return out


def first_turns_vs_reference(cfg, model, params, firsts, got, gen):
    """Each session's served first turn (``got``) against the dense
    prefill/decode recompute in bf16 (P), with the same weights upcast to
    fp32 (R) as the rounding reference.  The noise floor of each kind
    (the prefill's token, decode tokens) is max |P - R| over 2e-2 x
    max |R| on the logit vectors where P and R have read the same history.
    A served token that differs from P's first is held by phase 12's flip
    rule, P's logit gap in units of the tolerance, to the tolerance or
    twice the floor of its kind, whichever is larger (phase 9's rule for a
    deep bf16 recurrent stack)."""
    tol = TOL[torch.bfloat16]
    turns = {sid: [ids] for sid, ids in firsts.items()}
    trail_p = Trail(model)
    with trail_p():
        want = dense_reference(cfg, model, params, turns, gen)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = get_model(cfg32, device="cuda")
    params32 = {k: ({n: t.float() for n, t in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in params.items()}
    trail_r = Trail(model32)
    with trail_r():
        want32 = dense_reference(cfg32, model32, params32, turns, gen)
    del params32
    floor = dict(prefill=0.0, decode=0.0)
    for n, sid in enumerate(firsts):
        p, r = want[sid][0], want32[sid][0]
        for i in range(gen):
            if p[:i] != r[:i]:
                break
            lp, lr = trail_p.trail[n * (gen + 1) + i], \
                trail_r.trail[n * (gen + 1) + i]
            kind = "prefill" if i == 0 else "decode"
            floor[kind] = max(floor[kind], float(np.abs(lp - lr).max())
                              / (tol * float(np.abs(lr).max())))
    flips, equal, equal32 = [], 0, 0
    for n, sid in enumerate(firsts):
        g, w = got[sid], want[sid][0]
        equal += g == w
        equal32 += g == want32[sid][0]
        if g == w:
            continue
        i = next(j for j in range(gen) if g[j] != w[j])
        lg = trail_p.trail[n * (gen + 1) + i]
        units = float(lg[w[i]] - lg[g[i]]) / (tol * float(np.abs(lg).max()))
        kind = "prefill" if i == 0 else "decode"
        limit = max(1.0, 2 * floor[kind])
        flips.append((sid, i, g[i], w[i], round(units, 4), kind))
        check(units <= limit, f"{sid} token {i}: served {g[i]}, the "
              f"reference {w[i]}, whose logit gap is {units:.3g} x the "
              f"tolerance, beyond the {kind} floor's {limit:.3g} x")
    log(f"[15] first turns against the dense prefill/decode recompute: "
        f"{equal} of {len(firsts)} equal to the bf16 reference, {equal32} to "
        f"its fp32 twin; bf16 noise floor (bf16 vs fp32 reference logits, "
        f"units of 2e-2 x max|logit|): prefill {floor['prefill']:.3g}, "
        f"decode {floor['decode']:.3g}; first differing tokens (sid, index, "
        f"served, reference, gap in units, kind): {flips}")
    log(f"[15] served first turns {got}; bf16 reference "
        f"{ {s: w[0] for s, w in want.items()} }; fp32 twin "
        f"{ {s: w[0] for s, w in want32.items()} }")


def slstm_share(cfg, model, params, rng):
    """One 512-token prefill step (a fresh session, one chunk) with each
    sLSTM scan timed between synchronizes, after a warm-up turn of the
    same shape: the scan's share of the step's wall time."""
    d = dict(node=make_state_node(cfg, model, params), now=0.0, steps=[])
    ids = [int(x) for x in rng.integers(0, cfg.vocab, 512)]
    serve_all(d, [("warm", ids, 1)])
    clock = SLSTMClock(model)
    eng = d["node"][0]
    eng.submit(request(d["node"][1], "probe", ids, 1))
    torch.cuda.synchronize()
    with clock():
        t0 = time.perf_counter()
        eng.step(0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(clock.n == model.n_s, f"{clock.n} sLSTM scans timed, not "
          f"{model.n_s}")
    return dict(step_ms=1e3 * d["steps"][0][0], timed_step_ms=1e3 * wall,
                slstm_ms=1e3 * clock.s, share=clock.s / wall)


def phase_xlstm(cfg, model, params, seed):
    """xlstm-1.3b (bf16, the blocks ``cfg`` keeps: 16 of 48 in phase 15)
    served through NodeEngine + NodeManager
    + StateBackend with 8 slots: 4 sessions x 3 turns of 256-1024-token
    prompts and 16 generated tokens.  After every session's first turn, s1
    is swapped out and comes back cold at its second turn, and s2 is
    swapped out and prefetched by an advisory while s3's second turn runs;
    then every session's third turn; s3 persisted, the node crashed, and
    s3 recovered from the spool by a second node, which serves a fourth
    turn.  Each session's first turn is held against the dense
    prefill/decode recompute by phase 12's flip rule; the sLSTM scan's
    share of a prefill step is timed."""
    rng = np.random.default_rng(seed + 15)
    prompts = _turns(rng, cfg.vocab, system=0)
    gen = 16
    served = {}

    def serve(d, batch):
        for r, (sid, t) in zip(serve_all(d, [(sid, prompts[int(sid[1])][t],
                                              gen) for sid, t in batch]),
                               batch):
            served[(sid, t)] = r

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        d = dict(node=make_state_node(cfg, model, params, spool=f"{tmp}/a"),
                 now=0.0, steps=[])
        eng, be, mgr = d["node"]
        state_mb = be.session_kv_bytes(0) / 1e6
        serve(d, [("s0", 0)])
        serve(d, [("s0", 1), ("s1", 0), ("s2", 0), ("s3", 0)])
        stalls, moved = {}, {}
        for sid, lead in (("s1", False), ("s2", True)):
            c0 = be.stats["copied_bytes"]
            be.swap_out(sid, be.session_tokens(sid))
            be.drain_transfers(OUT)
            drained(be, mgr)
            check(sid not in be.slots.seqs, f"{sid} did not leave its slot")
            c1 = be.stats["copied_bytes"]
            stall0 = eng.stats["stall_s"]
            if lead:                 # s3's turn runs while s2 comes back
                mgr.on_advisory(AdvisoryRequest(session_id=sid,
                                                expected_arrival=LEAD),
                                kv_node=mgr.node_id, now=d["now"])
                check(be.transfers.pending_for(sid, IN),
                      "the advisory launched no prefetch")
                served[("s3", 1)] = request(be, "s3", prompts[3][1], gen)
                eng.submit(served[("s3", 1)])
                for _ in range(2):
                    d["now"] += eng.step(d["now"])
                    drained(be, mgr)
            serve(d, [(sid, 1)])
            stalls[sid] = 1e3 * (eng.stats["stall_s"] - stall0)
            moved[sid] = (c1 - c0, be.stats["copied_bytes"] - c1)
        serve(d, [(f"s{s}", 2) for s in range(4)])
        mgr.flush_session("s3", d["now"])
        be.drain_transfers()
        check(be.spool_exists("s3"), "the persist wrote no spool file")
        stats_a = dict(be.stats)
        d_b = dict(node=make_state_node(cfg, model, params, spool=f"{tmp}/b",
                                        node_id=1), now=d["now"], steps=[])
        be.crash()
        mgr.crash(d["now"])
        check(d_b["node"][2].recover_from_spool("s3", mgr, d["now"]),
              "the second node could not recover s3 from the spool")
        extra = [int(x) for x in rng.integers(0, cfg.vocab, 300)]
        served[("s3", 3)] = serve_all(d_b, [("s3", extra, gen)])[0]
        torch.cuda.synchronize()
        stats_b = dict(d_b["node"][1].stats)
        steps = d["steps"] + d_b["steps"]
        chunks = eng.stats["chunks"]
        peak = torch.cuda.max_memory_allocated()
        del d, d_b, eng, be, mgr
    free_device_memory()
    n_tok = sum(len(r.output_ids) for r in served.values())
    dec = [t for t, only in steps if only]
    pre = [t for t, only in steps if not only]
    log(f"[15] main path: {len(served)} requests, {n_tok} generated tokens, "
        f"{chunks} chunks on node 0, {len(steps)} steps, mean step "
        f"{1e3 * sum(t for t, _ in steps) / len(steps):.2f} ms ("
        f"{len(dec)} decode-only steps, mean {1e3 * np.mean(dec):.2f} ms; "
        f"{len(pre)} steps with prompt tokens, mean "
        f"{1e3 * np.mean(pre):.2f} ms), max_memory_allocated "
        f"{peak / 1e9:.2f} GB, of which {base / 1e9:.2f} GB were allocated "
        f"before the phase's nodes")
    log(f"[15] one session's state {state_mb:.1f} MB; swap out / back in "
        f"(bytes): cold s1 {moved['s1']}, advisory-led s2 {moved['s2']}; "
        f"stall cold {stalls['s1']:.3f} ms, advisory-led "
        f"{stalls['s2']:.3f} ms")
    log(f"[15] node 0 stats {stats_a}; node 1 stats {stats_b}")
    check(all(len(r.output_ids) == gen for r in served.values()),
          "a request did not generate all its tokens")
    check(stats_a["swaps_out"] >= 2 and stats_a["swaps_in"] >= 1
          and stats_a["layer_promotions"] >= 1
          and stats_a["disk_writes"] >= 1 and stats_b["migrations_in"] == 1,
          f"a tier was not used: {stats_a} / {stats_b}")
    check(all(min(v) >= 0.99 * state_mb * 1e6 for v in moved.values()),
          f"a swap moved less than the session's state: {moved}")
    check(chunks > len(served), "no prompt was chunked")

    firsts = {f"s{s}": prompts[s][0] for s in range(4)}
    got = {sid: list(served[(sid, 0)].output_ids) for sid in firsts}
    first_turns_vs_reference(cfg, model, params, firsts, got, gen)
    free_device_memory()
    share = slstm_share(cfg, model, params, rng)
    log(f"[15] a 512-token prefill step: {share['step_ms']:.2f} ms "
        f"unclocked (the warm-up), {share['timed_step_ms']:.2f} ms with each "
        f"sLSTM scan timed between synchronizes, of which the {model.n_s} "
        f"scans take {share['slstm_ms']:.2f} ms: share {share['share']:.3f}")
    free_device_memory()


# ---------------------------------------------------------------------------
# phase 16: exact fp32 tokens of xlstm through the tiers
# ---------------------------------------------------------------------------

def phase_exact_xlstm(seed):
    """xlstm at full width, one group (7 mLSTM + 1 sLSTM blocks), fp32: a
    session swapped out and back, persisted and recovered from the spool by
    a second node after a crash, and exported to a third node serves the
    dense prefill/decode recompute's tokens."""
    rng = np.random.default_rng(seed + 16)
    cfg, model, params = xlstm(seed + 16, 16, n_layers=8, dtype="float32")
    gen = 16
    turns = [[int(x) for x in rng.integers(0, cfg.vocab, int(n))]
             for n in rng.integers(100, 300, 4)]
    expect = reference_turns(cfg, model, params, turns, gen)
    got = []
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(n_slots=4, max_batch=4, token_budget=128)
        a, b, c = (dict(node=make_state_node(cfg, model, params,
                                             spool=f"{tmp}/{x}", node_id=i,
                                             **kw), now=0.0, steps=[])
                   for i, x in enumerate("abc"))
        be_a, mgr_a = a["node"][1], a["node"][2]
        got.append(serve_all(a, [("chat", turns[0], gen)])[0].output_ids)
        be_a.swap_out("chat", be_a.session_tokens("chat"))    # to the host
        be_a.drain_transfers()
        check("chat" not in be_a.slots.seqs, "the swap-out left the slot")
        got.append(serve_all(a, [("chat", turns[1], gen)])[0].output_ids)
        mgr_a.flush_session("chat", a["now"])                 # to the spool
        be_a.drain_transfers()
        moved = {k: be_a.stats[k] for k in ("swaps_out", "swaps_in",
                                            "disk_writes")}
        be_a.crash()
        mgr_a.crash(a["now"])
        check(b["node"][2].recover_from_spool("chat", mgr_a, a["now"]),
              "no recovery from the spool")
        b["now"] = a["now"]
        got.append(serve_all(b, [("chat", turns[2], gen)])[0].output_ids)
        be_b, be_c = b["node"][1], c["node"][1]
        tokens = be_b.session_tokens("chat")
        payload = be_b.export_session("chat")                 # migration
        be_c.import_session("chat", payload)
        c["node"][2].mark_resident("chat", tokens,
                                   be_c.session_kv_bytes(tokens), priority=0)
        c["now"] = b["now"]
        got.append(serve_all(c, [("chat", turns[3], gen)])[0].output_ids)
        moved["recovered"] = be_b.stats["migrations_in"]
        moved["imported"] = be_c.stats["migrations_in"]
    log(f"[16] fp32 8-block full width, swap out/in -> spool, crash, "
        f"recover -> export/import: served {got}")
    log(f"[16] dense recompute {expect}; {moved}")
    check(all(v > 0 for v in moved.values()), f"a tier was not used: {moved}")
    check(got == expect, "fp32 served tokens through the tiers differ from "
          "dense recompute")
    del model, params
    free_device_memory()


# ---------------------------------------------------------------------------
# phases 17-20: phi-3-vision (vlm), the MoE models, seamless-m4t (encdec)
# ---------------------------------------------------------------------------

def tensors(tree):
    """The tensors of a nested parameter dictionary."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tensors(v)
        else:
            yield v


def published(name, seed, tag, **cut):
    """The registered config ``name`` at its published widths, random
    weights drawn on the card from ``seed``; ``cut`` replaces fields (fewer
    layers, another dtype) and is printed."""
    cfg = configs.get_config(name)
    if cut:
        cfg = dataclasses.replace(cfg, name=name + "-" + "-".join(
            f"{k}={v}" for k, v in cut.items()), **cut)
    model = get_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tensors(params))
    depth = (f"{cfg.n_enc_layers} + {cfg.n_dec_layers} layers"
             if cfg.family == "encdec" else f"{cfg.n_layers} layers")
    extra = (f", {cfg.moe.n_experts} experts (padded to {model.e_pad}) "
             f"top-{cfg.moe.top_k} of d_ff {cfg.moe.d_expert_ff}, capacity "
             f"factor {cfg.moe.capacity_factor}" if cfg.moe else "")
    log(f"[{tag}] {cfg.name}: {cfg.family}, {depth}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}{extra}, vocab "
        f"{cfg.vocab}, {cfg.dtype}: {nbytes / 1e9:.2f} GB of weights in "
        f"{time.perf_counter() - t0:.1f} s" + (
            f"; cut from the published config: {cut}" if cut else ""))
    return cfg, model, params


def attn_layers(cfg):
    """Layers whose causal self-attention prefill runs B.4."""
    return cfg.n_dec_layers if cfg.family == "encdec" else cfg.n_layers


def held_prefill(model, params, args, tag, what):
    """One prefill on the kernel path with B.4's count set to 0 just before
    and read just after: B.4 on every layer and no plain call; its input
    (one call of each distinct shape) held against the plain version and
    timed; the logits finite.  Returns (logits, cache, launches, recs)."""
    cfg = model.cfg
    cap = Capture("flash_prefill", module=fp,
                  key=lambda a, kw: (tuple(a[0].shape), tuple(a[1].shape)))
    plain = PlainCalls()
    torch.cuda.synchronize()
    fp.launches = 0                          # counts of this main path only
    t0 = time.perf_counter()
    with cap(), plain():
        logits, cache = model.prefill(params, *args)
    torch.cuda.synchronize()
    launches, wall = fp.launches, time.perf_counter() - t0
    log(f"[{tag}] {what}: prefill {1e3 * wall:.1f} ms; B.4 launches "
        f"{launches} = {attn_layers(cfg)} layers: "
        f"{launches == attn_layers(cfg)}; plain calls {plain.n}")
    check(launches == attn_layers(cfg) and plain.n == 0 and cap.n == launches,
          f"{what}: B.4 ran {launches} times for {attn_layers(cfg)} layers "
          f"({plain.n} plain calls)")
    check(bool(torch.isfinite(logits.float()).all()),
          f"{what}: prefill logits not finite")
    recs = []
    for key, (a, _) in sorted(cap.calls.items()):
        q, k, v = a[:3]
        G = q.shape[2] // k.shape[2]
        rec = compare_flash(q, k, v, int(a[3]) if len(a) > 3 else 0,
                            f"{what} B={q.shape[0]} Sq={q.shape[1]} "
                            f"D={q.shape[3]} G={G}")
        log(f"[{tag}]" + fmt(rec))
        log(f"[{tag}]   {fmt_rate(rec)}")
        recs.append(rec)
    cap.calls.clear()
    return logits, cache, launches, recs


def greedy(model, params, logits, cache, n):
    """``n`` greedy decode steps after a prefill; (tokens per step, mean
    step ms on the host clock to a synchronisation, last logits)."""
    vocab, out, times = model.cfg.vocab, [], []
    cache = model.grow_cache(cache, n)
    for _ in range(n):
        nxt = torch.argmax(logits[:, :vocab], -1).to(torch.int32)
        out.append(nxt.cpu().tolist())
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, nxt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, 1e3 * float(np.mean(times)), logits


def phase_vlm_prefill(cfg, model, params, seed, tag=17):
    """phi-3-vision's prefill at B = 2: 576 random 1024-d patch embeddings
    in front of 128 text tokens (B.4 at D = 96 on every layer)."""
    rng = np.random.default_rng(seed + 17)
    dev = model.device
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128))).to(dev)
    patches = torch.randn((2, cfg.n_patches, cfg.d_frontend), device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(seed + 17))
    logits, cache, launches, recs = held_prefill(
        model, params, (tokens, patches), tag,
        f"vlm prefill ({cfg.n_patches} patches + 128 tokens)")
    check(tuple(cache["k"].shape[3:]) == (cfg.n_patches + 128, cfg.d_head),
          f"the cache holds {tuple(cache['k'].shape)}")
    return launches, recs


def phase_vlm_pressure(cfg, model, params, seed, tag=17):
    """One pressure pass of phase 6's rounds (4 sessions x 3 turns, the
    fp budget at 40 % of the sessions' pages; no host-link timing, spool
    or migration): the second turn's advisories make idle sessions int8,
    so B.2 serves every layer once the tier is active, and the third
    turn's lanes read their own int8 pages; then held like phase 6
    (lockstep twins, the int8 kernel's calls re-timed)."""
    rng = np.random.default_rng(seed + 17)
    gen = 16
    prompts = pressure_prompts(rng, cfg.vocab, n_sessions=4, n_turns=3)
    total = sum(-(-(sum(map(len, turns)) + len(turns) * gen) // PAGE)
                for turns in prompts)
    hbm_pages = int(0.4 * total)
    n_pages = 2 * hbm_pages
    torch.cuda.synchronize()
    pa.launches = pa.quant_launches = 0   # counts of this main path only
    node = make_node(cfg, model, params, n_pages=n_pages,
                     hbm_pages=hbm_pages)
    d = Single(node, cfg)
    pressure_rounds(d, prompts, gen)
    fl, ql = pa.launches, pa.quant_launches
    be = node[1]
    log(f"[{tag}] pressure pass: {len(prompts)} sessions x "
        f"{len(prompts[0])} turns, hbm_pages {hbm_pages} of {total}, "
        f"{len(d.steps)} steps, mean step {1e3 * float(np.mean(d.steps)):.2f}"
        f" ms; kernel launches: fp {fl}, int8 {ql}; backend stats "
        f"{be.stats}")
    check(be.stats["quantized_pages"] > 0 and ql > 0,
          "the pressure pass put no int8 page on the path")
    del d, node, be
    free_device_memory()
    return fl, ql, pressure_lockstep(cfg, model, params, prompts, gen,
                                     n_pages, hbm_pages, tag)


class RouteStats:
    """While active, counts each MoE layer's dispatch (``route_stats``):
    assignments, those dropped by capacity, and kept ones the reference's
    dump discards."""

    def __init__(self, model):
        self.model = model
        self.n = dict(assignments=0, dropped=0, dumped=0)

    @contextlib.contextmanager
    def __call__(self):
        model, ffn = self.model, self.model._ffn

        def counted(x, w):
            for k, v in model.route_stats(x, w).items():
                self.n[k] += v
            return ffn(x, w)

        model._ffn = counted
        try:
            yield
        finally:
            del model._ffn

    def shares(self):
        a = max(self.n["assignments"], 1)
        return (f"{self.n['assignments']} assignments, dropped by capacity "
                f"{self.n['dropped'] / a:.4f}, kept but dumped "
                f"{self.n['dumped'] / a:.4f}")


def phase_moe(seed, tag=18):
    """granite-moe-3b-a800m in full and qwen3-moe-30b-a3b at full width and
    12 of its 48 layers, bf16: prefill B = 2 x 512 tokens (B.4 at G = 3 and
    G = 8 on every layer, held against the plain version), then 16 greedy
    decode steps; each model's share of assignments dropped by capacity."""
    launches, recs = 0, []
    for name, cut in (("granite-moe-3b-a800m", {}),
                      ("qwen3-moe-30b-a3b", dict(n_layers=12))):
        cfg, model, params = published(name, seed, tag, **cut)
        rng = np.random.default_rng(seed + 18)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 512))).to(
            model.device)
        stats = RouteStats(model)
        with stats():
            logits, cache, n, r = held_prefill(model, params, (tokens,), tag,
                                               f"{name} prefill")
            pre = stats.shares()
            toks, step_ms, last = greedy(model, params, logits, cache, 16)
        check(bool(torch.isfinite(last.float()).all()),
              f"{name}: decode logits not finite")
        log(f"[{tag}] {name}: 16 decode steps at B = 2, mean "
            f"{step_ms:.2f} ms; tokens {toks[:4]} ...; prefill routing: "
            f"{pre}; prefill and decode: {stats.shares()}")
        launches += n
        recs += r
        del cfg, model, params, cache, logits, last
        free_device_memory()
    return launches, recs


def phase_encdec(seed, tag=19):
    """seamless-m4t-medium in full, bf16: encode 2 x 256 random 1024-d
    frames, prefill 64 decoder tokens (B.4 at D = 64, G = 1 on the
    decoder's 12 layers), then 16 greedy decode steps."""
    cfg, model, params = published("seamless-m4t-medium", seed, tag)
    rng = np.random.default_rng(seed + 19)
    dev = model.device
    frames = torch.randn((2, 256, cfg.d_frontend), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(seed + 19))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
    logits, cache, launches, recs = held_prefill(
        model, params, (frames, tokens), tag, "encdec prefill (256 frames + "
        "64 tokens)")
    toks, step_ms, last = greedy(model, params, logits, cache, 16)
    check(bool(torch.isfinite(last.float()).all()),
          "encdec: decode logits not finite")
    log(f"[{tag}] 16 decode steps at B = 2 over 256 encoder positions, mean "
        f"{step_ms:.2f} ms; tokens {toks[:4]} ...")
    del cfg, model, params, cache, logits, last
    free_device_memory()
    return launches, recs


EXACT_A9 = (("phi-3-vision-4.2b", dict(n_layers=2)),
            ("granite-moe-3b-a800m", dict(n_layers=2)),
            ("qwen3-moe-30b-a3b", dict(n_layers=2)),
            ("seamless-m4t-medium", dict(n_layers=4, n_enc_layers=2,
                                         n_dec_layers=2)))


def phase_exact_a9(seed, tag=20):
    """Exact tokens in fp32 at full width and 2 layers (2 encoder and 2
    decoder layers for encdec): 16 greedy tokens with the kernels equal
    ``kernel_mode="ref"``'s, for phi-3-vision (with patches), both MoE
    models and seamless-m4t; then phi-3-vision served through RealBackend
    with a swap-out between turns equals the dense recompute."""
    rng = np.random.default_rng(seed + 20)
    gen = 16
    for name, cut in EXACT_A9:
        cfg, model, params = published(name, seed + 20, tag, dtype="float32",
                                       **cut)
        dev = model.device
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 100))).to(dev)
        if cfg.family == "vlm":
            args = (tokens, torch.randn((1, cfg.n_patches, cfg.d_frontend),
                                        device=dev))
        elif cfg.family == "encdec":
            args = (torch.randn((1, 256, cfg.d_frontend), device=dev),
                    tokens[:, :64])
        else:
            args = (tokens,)
        got = {}
        for mode in ("auto", "ref"):
            f0 = fp.launches
            logits, cache = model.prefill(params, *args, kernel_mode=mode)
            got[mode], _, _ = greedy(model, params, logits, cache, gen)
            ran = fp.launches - f0
            want = attn_layers(cfg) if mode == "auto" else 0
            check(ran == want, f"{name} fp32 ({mode}): B.4 ran {ran} times, "
                  f"not {want}")
        log(f"[{tag}] {cfg.name}: kernels {sum(got['auto'], [])}")
        log(f"[{tag}] {cfg.name}: plain   {sum(got['ref'], [])}")
        check(got["auto"] == got["ref"], f"{name} fp32: tokens with the "
              f"kernels differ from kernel_mode='ref'")
        if cfg.family == "vlm":
            turns = [[int(x) for x in rng.integers(0, cfg.vocab, int(n))]
                     for n in rng.integers(100, 300, 3)]
            expect = reference_turns(cfg, model, params, turns, gen)
            eng, be, _ = make_node(cfg, model, params, n_pages=256,
                                   max_batch=4, token_budget=128)
            served, now = [], 0.0
            before = pa.launches
            for i, turn in enumerate(turns):
                toks, now = serve_turn(eng, be, "chat", turn, gen, now)
                served.append(toks)
                if i == 0:
                    be.swap_out("chat", be.session_tokens("chat"))
                    be.drain_transfers()
            ran = pa.launches - before
            log(f"[{tag}] {cfg.name} served with a swap: {served}")
            log(f"[{tag}] dense recompute {expect}; swaps out/in "
                f"{be.stats['swaps_out']}/{be.stats['swaps_in']}, kernel "
                f"launches {ran}")
            check(be.stats["swaps_out"] > 0 and be.stats["swaps_in"] > 0,
                  "the session was not swapped out and back in")
            check(ran == cfg.n_layers * be.stats["sub_dispatches"],
                  "the fp32 serve did not go through kernel 1 on every layer")
            check(served == expect, f"{name} fp32: served tokens differ "
                  f"from the dense recompute")
            del eng, be
        del cfg, model, params
        free_device_memory()


# ---------------------------------------------------------------------------
# phases 21-22: tensor-parallel serving on a mesh of shards on the card
# ---------------------------------------------------------------------------

# memory a finished tp run may leave allocated beyond its base (the model's
# census and small index tensors; the pools and shards are freed)
TP_SLACK = 64 << 20


def tp_mesh(tp):
    """A serving mesh of ``tp`` shards, every one on card 0 (the script
    needs one card); None for a single-device node."""
    return None if tp is None else make_serving_mesh(
        tp, devices=["cuda:0"] * tp)


def zero_counts():
    pa.launches = pa.quant_launches = 0
    pa.partial_launches = pa.quant_partial_launches = 0
    pa.merge_launches = 0
    pa.scores_launches = pa.pv_launches = 0
    pa.quant_scores_launches = pa.quant_pv_launches = 0
    pa.features_launches = pa.quant_features_launches = 0


def counts():
    """The attention kernels' launch counts (the merge's apart)."""
    return dict(k1=pa.launches, b2=pa.quant_launches,
                k1_partial=pa.partial_launches,
                b2_partial=pa.quant_partial_launches,
                k1_scores=pa.scores_launches, k1_pv=pa.pv_launches,
                b2_scores=pa.quant_scores_launches,
                b2_pv=pa.quant_pv_launches,
                k1_feat=pa.features_launches,
                b2_feat=pa.quant_features_launches)


def expected_counts(be, kind="k1"):
    """Launches a run on ``be`` must have made: (keys, n), each key of
    `counts` launched n times, one a layer, a shard and a sub-dispatch, and
    no other: kernel 1 / B.2 (``kind`` k1 or b2), on the split-K rung their
    partial mode; on the head-feature rung, shards on one card, their
    one-launch route, one a layer and sub-dispatch (across cards their F1
    and F2 a shard, the scores buffer of a call on these paths within
    ops.SCORES_CAP, so that no call is cut into tiles of lanes)."""
    lay = be._layout
    n = be.cfg.n_layers * be.stats["sub_dispatches"] * be.tp
    rung = None if lay is None else lay.rung
    if rung == "rows":
        return (kind + "_partial",), n
    if rung == "features":
        if ops.one_device([p.device for p in be.k_pool]):
            return (kind + "_feat",), n // be.tp
        return (kind + "_scores", kind + "_pv"), n
    return (kind,), n


def launched(got, keys, n):
    """Whether the counts ``got`` are n launches of each of ``keys`` and
    nothing else."""
    return all(got[k] == n for k in keys) and sum(got.values()) == n * len(
        keys)


def check_merges(be, what, mode="auto"):
    """The split-K merge's launches of a run on ``be``: one an attention
    call (a layer and a sub-dispatch) on the rows rung on the kernel path,
    none otherwise.  Returns the count."""
    lay = be._layout
    rows = lay is not None and lay.rung == "rows" and mode == "auto"
    want = be.cfg.n_layers * be.stats["sub_dispatches"] if rows else 0
    check(pa.merge_launches == want, f"{what}: {pa.merge_launches} merge "
          f"launches, want {want} (one an attention call on the rows rung)")
    return pa.merge_launches


def _partial_key(args, kw):
    q, kp, tables = args[0], args[1], args[-5]
    return (tuple(q.shape), tuple(kp.shape), tuple(tables.shape), q.dtype,
            args[-2])


def held_bytes(obj) -> int:
    """Bytes of the tensors in a nest of dicts, lists and tuples (a
    capture's inputs)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        obj = obj.values()
    if isinstance(obj, (list, tuple, type({}.values()))):
        return sum(held_bytes(x) for x in obj)
    return 0


def reckon(cfg, params, n_pages, page):
    """The device bytes a tp run should take: the weights (shards are views
    of them on the one card) and its pools."""
    w = sum(t.numel() * t.element_size() for t in tensors(params))
    pools = (2 * cfg.n_layers * (n_pages + 1) * page * cfg.n_kv_heads
             * cfg.d_head * torch.tensor([], dtype=getattr(
                 torch, cfg.dtype)).element_size())
    return w, pools


def tp_serve(cfg, model, params, prompts, gen, tp, tag, captures=(),
             page=PAGE):
    """Phase 4's traffic (``rounds(prompts)``) on a node of ``tp`` shards
    (None: one device) with its logits traced, at ``page`` rows a page
    (the pool holding 16384 tokens); its kernel launches, checked against
    one a layer, shard and sub-dispatch, and its merges against one a
    layer and sub-dispatch on the split-K rung; the memory it held, which
    must return to its base once the node is freed."""
    free_device_memory()
    base = torch.cuda.memory_allocated()
    n_pages = 1024 * PAGE // page
    w, pools = reckon(cfg, params, n_pages, page)
    log(f"[{tag}] tp={tp} page {page}: reckoned {w / 1e9:.2f} GB of weights "
        f"(the shards are views of them) + {pools / 1e9:.2f} GB of pools; "
        f"allocated before {base / 1e9:.2f} GB")
    eng, be, mgr = make_node(cfg, model, params, n_pages=n_pages,
                             page_size=page, trace_logits=True,
                             mesh=tp_mesh(tp))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()                       # counts of this main path only
    reqs, steps, now = [], [], 0.0
    with contextlib.ExitStack() as stack:
        for c in captures:
            stack.enter_context(c())
        for rnd in rounds(prompts):
            for s, t in rnd:
                reqs.append(request(be, f"s{s}", prompts[s][t], gen))
                eng.submit(reqs[-1])
            while eng.waiting or eng.running:
                t0 = time.perf_counter()
                now += eng.step(now)
                steps.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    keys, want = expected_counts(be)
    lay = be._layout
    rung = "single device" if lay is None else \
        f"{lay.rung}, {lay.pl} rows and {lay.dr} features a shard page"
    log(f"[{tag}] tp={tp} ({rung}): {len(reqs)} requests, {len(steps)} "
        f"steps, mean step {1e3 * sum(steps) / len(steps):.2f} ms, "
        f"{be.stats['sub_dispatches']} sub-dispatches; launches {got}, "
        f"merges {pa.merge_launches}; "
        f"pool bytes a shard {be.pool_device_bytes() / 1e9:.3f} GB; "
        f"max_memory_allocated {peak / 1e9:.2f} GB")
    check(launched(got, keys, want),
          f"tp={tp}: launches {got}, want {keys} = {want}")
    merges = check_merges(be, f"tp={tp} page {page}")
    check(all(len(r.output_ids) == gen for r in reqs),
          f"tp={tp}: a request did not generate all its tokens")
    # an adopted prefix that ends inside a page forks it (the 200-token
    # system prompt at page 16); at page 8 it ends on a page's edge
    fork = be.stats["shared_tokens"] % page != 0
    check(be.stats["prefix_hits"] >= 1
          and (be.stats["cow_forks"] >= 1 or not fork),
          f"tp={tp}: no prefix adoption / CoW fork: {be.stats}")
    for a in be.alloc:
        a.check()
    out = dict(tokens=[list(r.output_ids) for r in reqs],
               first=be.logit_trace[0], launches=want, keys=keys, got=got,
               merges=merges,
               step_ms=1e3 * sum(steps) / len(steps), steps=len(steps),
               subs=be.stats["sub_dispatches"],
               shard_bytes=be.pool_device_bytes(), peak=peak)
    del eng, be, mgr, reqs
    free_device_memory()
    held = sum(held_bytes(c.calls) for c in captures)
    after = torch.cuda.memory_allocated()
    log(f"[{tag}] tp={tp}: allocated after {after / 1e9:.2f} GB (captured "
        f"inputs {held / 1e6:.1f} MB)")
    check(after - base <= held + TP_SLACK,
          f"tp={tp}: {(after - base - held) / 1e6:.1f} MB still allocated "
          f"after the node was freed")
    return out


def first_logits_floor(cfg, model, params, prompts, gen, single, tag):
    """The bf16 noise floor of the first traced logits (session 0's first
    turn, a final chunk's): the single device's kernel path against its
    plain path (``kernel_mode="ref"``), two correct roundings, as max
    |diff| over max |logit| in units of the bf16 tolerance.  Only that
    turn's first token is served on the plain path."""
    eng, be, mgr = make_node(cfg, model, params, n_pages=1024,
                             trace_logits=True, kernel_mode="ref")
    eng.submit(request(be, "s0", prompts[0][0], gen))
    now = 0.0
    while not be.logit_trace:
        now += eng.step(now)
    sid, lg = be.logit_trace[0]
    del eng, be, mgr
    free_device_memory()
    sid0, l0 = single["first"]
    check(sid == sid0, f"the plain path's first traced token is {sid}'s")
    floor = float(np.abs(l0 - lg).max()) / float(np.abs(l0).max()) \
        / TOL[torch.bfloat16]
    log(f"[{tag}] {cfg.name}: first logits, kernel vs plain on one device: "
        f"{floor:.4g} x the bf16 tolerance (2e-2 x max|logit|)")
    return floor


def held_to_single(ref, run, tp, tag, floor):
    """Where tp's tokens first diverge from the single device's, and its
    first traced logits (a final chunk's) held to 2e-2 x max |logits|, or
    to twice the floor where that is larger (the lockstep rule of phases
    4 and 6): bf16 row-parallel sums and split-K merges round differently,
    as in the JAX package, and on these random 32-layer models a
    one-rounding change already moves the logits by about the tolerance
    (``first_logits_floor``)."""
    div = []
    for i, (a, b) in enumerate(zip(ref["tokens"], run["tokens"])):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            div.append((i, j))
    (sid0, l0), (sid1, l1) = ref["first"], run["first"]
    err = float(np.abs(l0 - l1).max())
    units = err / float(np.abs(l0).max()) / TOL[torch.bfloat16]
    lim = max(1.0, 2 * floor)
    log(f"[{tag}] tp={tp} vs one device: {len(div)} of "
        f"{len(ref['tokens'])} requests diverge (request, first token): "
        f"{div}; first logits max |diff| {err:.4g} = {units:.4g} x the "
        f"tolerance (limit {lim:.4g}: the floor {floor:.4g})")
    check(sid0 == sid1 and units <= lim,
          f"tp={tp}: first logits {units:.3g} x the tolerance from the "
          f"single device's, beyond {lim:.3g}")
    return dict(diverged=len(div), first_units=units)






def compare_partial(group, label):
    """One split-K call, captured shard by shard (one layer of one
    dispatch), run as the main path runs it: every shard's partials
    written into one workspace, then merged in place.  Each shard's
    kernel, its splits combined, against its plain version (real rows
    within TOL x max|plain|, padding rows zeros, -inf lse where the plain
    one is, lse within 1e-2), the merge kernel against the plain merge on
    the same partials, and the merged output against the unsplit kernel
    and its plain version on the whole pool; times per shard (wall and
    device), the slowest shard's, the merge's, the unsplit kernel's on the
    same call and SDPA's on the gathered K/V."""
    quant = len(group[0]) == 13
    kern = QKPART if quant else KPART
    q = group[0][0]
    dtype = q.dtype
    tab, qoff, ctx = group[0][-5:-2]
    n = group[0][-1]
    q_lens = (ctx - qoff).clamp(min=0).cpu().tolist()
    cx = ctx.cpu().tolist()
    ws, slots_of = ops.partial_workspace(q, group[0][1], tab, [q.device] * n)
    n_split = ws[0].shape[0] // n
    outs, lses = [], []
    err, scale, lerr = 0.0, 0.0, 0.0
    ms = dev = plain = host = 0.0
    devs = []
    nbytes = flops = 0
    dev_ok = True
    for r, args in enumerate(group):
        slots = slots_of[r]
        o, lse = kern(*args, out=slots)
        torch.cuda.synchronize()
        qt = tuple(args[3:8]) if quant else None
        wo, wl = ref.paged_chunk_attention_partial_ref(
            args[0], args[1], args[2], tab, qoff, ctx, args[-2], n, quant=qt)
        wo, wl = wo[0], wl[0]
        check(bool(torch.isfinite(o).all()),
              f"{label} shard {args[-2]}: partials not finite")
        co, cl = ref.combine_partials(o, lse)   # the shard's splits merged
        check(torch.equal(torch.isfinite(cl), torch.isfinite(wl)),
              f"{label} shard {args[-2]}: rows with no key differ from the "
              f"plain version's")
        for b in range(q.shape[0]):
            m = int(q_lens[b]) if cx[b] else 0
            check(bool((o[:, b, m:] == 0).all())
                  and bool(torch.isneginf(lse[:, b, m:]).all()),
                  f"{label} shard {args[-2]}: lane {b}'s padding rows are "
                  f"not zeros with lse -inf")
            if m:
                err = max(err, (co[b, :m] - wo[b, :m]).abs().max().item())
                scale = max(scale, wo[b, :m].abs().max().item())
        fin = torch.isfinite(wl)
        if bool(fin.any()):
            lerr = max(lerr, (cl[fin] - wl[fin]).abs().max().item())
        outs.append(o)
        lses.append(lse)
        ms += cuda_ms(lambda a=args, sl=slots: kern(*a, out=sl), 5)
        host += host_ms(lambda a=args, sl=slots: kern(*a, out=sl), 5)
        d_ms = device_ms(lambda a=args, sl=slots: kern(*a, out=sl), 5)
        dev_ok = dev_ok and d_ms is not None
        dev += d_ms or 0.0
        devs.append(d_ms or 0.0)
        plain += cuda_ms(lambda a=args: ref.paged_chunk_attention_partial_ref(
            a[0], a[1], a[2], tab, qoff, ctx, a[-2], n, quant=qt), 1,
            warmup=0)
        kp = args[1]
        nb, fl = partial_work(q, tab, qoff, ctx, kp.shape[1] * n,
                              kp.shape[1], args[-2], kp.shape[2],
                              kp.shape[3], q.element_size(), q_lens,
                              args[7] if quant else None)
        nbytes += nb
        flops += fl
    lim = TOL[dtype] * scale
    check(err <= lim, f"{label}: max abs err {err:.3g} > {TOL[dtype]} x "
          f"max|plain| {scale:.3g} = {lim:.3g}")
    check(lerr <= 1e-2, f"{label}: lse off the plain version's by {lerr:.3g}")

    def merge():
        return ops.merge_partials(*ws, dtype)
    before = pa.merge_launches
    merged = merge()
    torch.cuda.synchronize()
    merge_launches = pa.merge_launches - before
    check(merge_launches == 1, f"{label}: the merge made {merge_launches} "
          f"launches, not one")
    plain_merged = ref.merge_partials_ref(*ws, dtype).float()
    mg_err = (merged.float() - plain_merged).abs().max().item()
    mg_scale = max(plain_merged.abs().max().item(), 1e-30)
    mg_tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    check(mg_err <= mg_tol * mg_scale, f"{label}: the merge kernel off the "
          f"plain merge by {mg_err:.3g} > {mg_tol:.3g} x {mg_scale:.3g}")
    merge_ms = cuda_ms(merge, 10)
    merge_host = host_ms(merge, 10)
    merge_dev = device_ms(merge, 10)
    merge_plain = cuda_ms(lambda: ref.merge_partials_ref(*ws, dtype), 5)
    mb_ms, _, mt_b, _ = bound(merge_work(*ws, q.element_size()), 0, dtype)
    kp = torch.cat([a[1] for a in group], dim=1)
    vp = torch.cat([a[2] for a in group], dim=1)
    full = None
    if quant:
        full = (torch.cat([a[3] for a in group], dim=1),
                torch.cat([a[4] for a in group], dim=1), *group[0][5:8])

    def unsplit():
        if full is None:
            return KERNEL(q, kp, vp, tab, qoff, ctx)
        return QKERNEL(q, kp, vp, *full, tab, qoff, ctx)
    whole = unsplit()
    plain_whole = ref.paged_chunk_attention_ref(q, kp, vp, tab, qoff, ctx,
                                                quant=full)
    merr, mscale = 0.0, 0.0
    for b in range(q.shape[0]):
        m = int(q_lens[b]) if cx[b] else 0
        if m:
            want = plain_whole[b, :m].float()
            merr = max(merr, (merged[b, :m].float() - want).abs().max()
                       .item(), (whole[b, :m].float() - want).abs().max()
                       .item())
            mscale = max(mscale, want.abs().max().item())
        check(bool((merged[b, m:] == 0).all()),
              f"{label}: lane {b}'s merged padding rows are not zeros")
    check(merr <= TOL[dtype] * mscale,
          f"{label}: merged shards or the unsplit kernel off the plain "
          f"version by {merr:.3g} > {TOL[dtype]} x {mscale:.3g}")
    b_ms, b_by, t_b, t_f = bound(nbytes, flops, dtype)
    rec = dict(
        label=label, splits=n_split, max_abs_err=err,
        err_rel=err / max(scale, 1e-30), lse_err=lerr,
        merged_err_rel=merr / max(mscale, 1e-30),
        ms=ms, device_ms=dev if dev_ok else None, host_ms=host,
        plain_ms=plain, slowest_device_ms=(max(devs) + merge_dev
                           if dev_ok and merge_dev is not None else None),
        merge_ms=merge_ms, merge_device_ms=merge_dev, merge_host_ms=merge_host,
        merge_launches=merge_launches,
        merge_err=mg_err, merge_plain_ms=merge_plain, merge_bound_ms=mb_ms,
        merge_bytes_ms=mt_b, split_ms=ms + merge_ms,
        unsplit_ms=cuda_ms(unsplit, 20), unsplit_device_ms=device_ms(unsplit),
        library_ms=cuda_ms(sdpa_yardstick(q, kp, vp, tab, qoff, ctx, full),
                           20),
        bound_ms=b_ms, bound_by=b_by, bytes_ms=t_b, ops_ms=t_f, flops=flops,
        decode=q.shape[1] == 1, shards=n)
    return rec


def fmt_partial(rec) -> str:
    keys = ("max_abs_err", "err_rel", "lse_err", "merged_err_rel", "ms",
            "device_ms", "host_ms", "slowest_device_ms", "merge_ms",
            "merge_device_ms", "merge_host_ms", "merge_err",
            "merge_bound_ms", "split_ms", "unsplit_ms", "unsplit_device_ms",
            "plain_ms", "library_ms", "bound_ms")
    parts = [f"{k}={rec[k]:.4g}" for k in keys if rec.get(k) is not None]
    return (f"  {rec['label']}: splits={rec['splits']} merge_launches="
            f"{rec['merge_launches']} " + " ".join(parts)
            + f" bound_by={rec['bound_by']}")


def merge_record(rec):
    """The merge's part of a partial record, as a kernel record."""
    return dict(max_abs_err=rec["merge_err"], ms=rec["merge_ms"],
                device_ms=rec["merge_device_ms"],
                plain_ms=rec["merge_plain_ms"], bound_ms=rec["merge_bound_ms"],
                bytes_ms=rec["merge_bytes_ms"], ops_ms=0.0, library_ms=None)


def retime_partial(cap, what, tag):
    """The captured partial calls, grouped by shape (shard 0..n-1 of one
    layer of one dispatch), held and timed by `compare_partial`."""
    groups = {}
    for key, (args, _) in cap.calls.items():
        groups.setdefault(key[:-1], {})[key[-1]] = args
    recs = []
    for key in sorted(groups):
        by_shard = groups[key]
        n = next(iter(by_shard.values()))[-1]
        check(sorted(by_shard) == list(range(n)),
              f"{what}: shards {sorted(by_shard)} captured of {n}")
        group = [by_shard[r] for r in range(n)]
        q, tab = group[0][0], group[0][-5]
        label = (f"{what} B={q.shape[0]} Sq={q.shape[1]} T={tab.shape[1]} "
                 f"x {n} shards of {group[0][1].shape[1]} rows")
        if len(group[0]) == 13:
            g = group[0]
            label += (f" int8 pages "
                      f"{flag_share(tab, g[-3], g[7], g[1].shape[1] * n):.2f}")
        rec = compare_partial(group, label)
        log(f"[{tag}]" + fmt_partial(rec))
        recs.append(rec)
    cap.calls.clear()
    if recs:
        tot = {k: sum(r[k] for r in recs) for k in (
            "ms", "merge_ms", "split_ms", "unsplit_ms", "library_ms",
            "bound_ms", "plain_ms", "merge_bound_ms", "host_ms",
            "merge_host_ms")}

        def dsum(k):
            v = [r[k] for r in recs]
            return sum(v) if None not in v else "n/a"
        log(f"[{tag}] {what}, {len(recs)} shapes: shards {tot['ms']:.4g} ms"
            f" (device {dsum('device_ms')}, host {tot['host_ms']:.4g}) + "
            f"merge {tot['merge_ms']:.4g} (device {dsum('merge_device_ms')}, "
            f"host {tot['merge_host_ms']:.4g}, bound "
            f"{tot['merge_bound_ms']:.4g}) = {tot['split_ms']:.4g} ms; the "
            f"slowest shard + merge, device {dsum('slowest_device_ms')}; "
            f"splits {[r['splits'] for r in recs]}; unsplit kernel "
            f"{tot['unsplit_ms']:.4g} ms (device "
            f"{dsum('unsplit_device_ms')}); SDPA {tot['library_ms']:.4g} ms;"
            f" bound {tot['bound_ms']:.4g} ms; plain {tot['plain_ms']:.4g} "
            f"ms")
    return recs


class FeatureCapture:
    """Records one head-feature call of the one-launch route
    (``pa.paged_chunk_attention_features``) for each distinct shape: q,
    every shard's K and V pools (and int8 shadows), the tables and lanes,
    cloned when the call is made, or, with ``score``, when a call whose
    lanes read more int8 pages comes.  A side's pools that lie at one
    stride (slices of one allocation, as `PoolLayout.zeros` makes them) are
    cloned into one allocation again, so that the replay takes the
    producer the main path took (`pa.features_producer`, kept with the
    call and counted over every call in ``producers``).  ``quant`` picks
    B.2's calls (int8 state given) or kernel 1's."""

    def __init__(self, quant: bool, score=None):
        self.quant = quant
        self.score = score
        self.calls = {}
        self.scores = {}
        self.producers = collections.Counter()
        self.n = 0

    @contextlib.contextmanager
    def __call__(self):
        orig = pa.paged_chunk_attention_features

        def keep(x):
            if isinstance(x, (list, tuple)):
                if len(x) > 1 and all(isinstance(u, torch.Tensor)
                                      for u in x) \
                        and pa.pools_stride(x) > 0:
                    return type(x)(torch.stack(x).unbind(0))
                return type(x)(keep(u) for u in x)
            return x.clone() if isinstance(x, torch.Tensor) else x

        def rec(q, k_pools, v_pools, tables, q_offsets, ctx_lens, quant=None):
            args = (q, k_pools, v_pools, tables, q_offsets, ctx_lens, quant)
            if (quant is not None) == self.quant:
                self.n += 1
                prod = pa.features_producer(q, k_pools, v_pools)
                self.producers[prod] += 1
                key = (tuple(q.shape), tuple(k_pools[0].shape),
                       tuple(tables.shape), q.dtype, len(k_pools))
                sc = 0.0 if self.score is None else self.score(args)
                if key not in self.calls or sc > self.scores[key]:
                    self.calls[key] = (keep(args), prod)
                    self.scores[key] = sc
            return orig(q, k_pools, v_pools, tables, q_offsets, ctx_lens,
                        quant=quant)

        pa.paged_chunk_attention_features = rec
        try:
            yield
        finally:
            pa.paged_chunk_attention_features = orig


def compare_features(call, label, producer):
    """One head-feature call through both routes.  The one-launch route
    (``FKERNEL``) against its plain version on real rows within TOL x
    max|plain| (padding rows and ctx = 0 lanes zeros), and bit-equal to
    kernel 1 / B.2 on the pools concatenated along D; the replay must take
    ``producer``, the one the main path took on the call, and where TMA is
    open both producers are run, held bit for bit and timed.  The per-shard route
    of shards on distinct cards, run as on one card with one scores
    buffer: every shard's F1 into it (shard 0 writes, the others add),
    then every shard's F2 on it; the summed scores against the shards'
    plain partial scores summed, on every entry a row sees; each shard's
    F2 against its plain version on the same scores; the joined output
    against the plain attention; each within TOL x max|plain|.  Times
    (wall, device, host) of both routes and their plain versions, the
    unsplit kernel's and SDPA's on the gathered K/V; each route's bound
    from ``roofline.cost``."""
    q0, kps, vps, tab, qoff, ctx, qt = call
    n = len(kps)
    quant = qt is not None
    dtype = q0.dtype
    B, Sq, H, D = q0.shape
    dr = D // n
    page, hkv = kps[0].shape[1], kps[0].shape[2]
    T = tab.shape[1] * page
    q_lens = (ctx - qoff).clamp(min=0).cpu().tolist()
    cx = ctx.cpu().tolist()

    def held(got, want, what):
        """max |got - want| and max |want| over real rows, checked within
        TOL; padding rows and ctx = 0 lanes of ``got`` zeros."""
        err, scale = 0.0, 0.0
        for b in range(B):
            m = int(q_lens[b]) if cx[b] else 0
            check(bool((got[b, m:] == 0).all()), f"{label}: {what}: lane "
                  f"{b}'s padding rows are not zeros")
            if m:
                err = max(err, (got[b, :m].float() - want[b, :m].float())
                          .abs().max().item())
                scale = max(scale, want[b, :m].float().abs().max().item())
        check(err <= TOL[dtype] * scale, f"{label}: {what} off its plain "
              f"version by {err:.3g} > {TOL[dtype]} x {scale:.3g}")
        return err, scale

    # the one-launch route, by the main path's producer
    prod = pa.features_producer(q0, kps, vps)
    check(prod == producer, f"{label}: the replay takes the {prod} "
          f"producer, the main path took {producer}")
    # both producers where TMA is open (the route then takes TMA)
    prods = ["tma", "gather"] if prod == "tma" else [prod]

    def fused(p=None):
        return FKERNEL(q0, kps, vps, tab, qoff, ctx, quant=qt, producer=p)
    got = fused()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), f"{label}: the one-launch "
          f"route's output is not finite")
    plain_whole = ref.paged_chunk_attention_features_ref(
        q0, kps, vps, tab, qoff, ctx, quant=qt)
    err, scale = held(got, plain_whole, "the one-launch route")
    kp, vp = torch.cat(kps, dim=-1), torch.cat(vps, dim=-1)
    full = None if not quant else (torch.cat(qt[0], dim=-1),
                                   torch.cat(qt[1], dim=-1), *qt[2:])

    def unsplit():
        if full is None:
            return KERNEL(q0, kp, vp, tab, qoff, ctx)
        return QKERNEL(q0, kp, vp, *full, tab, qoff, ctx)
    whole = unsplit()
    torch.cuda.synchronize()
    for p in prods:
        o = fused(p)
        torch.cuda.synchronize()
        n_diff = int((o != whole).sum())
        check(n_diff == 0, f"{label}: the one-launch route ({p}) differs "
              f"from {'B.2' if quant else 'kernel 1'} on the concatenated "
              f"pools in {n_diff} of {o.numel()} elements")
    check(torch.equal(got, whole), f"{label}: the main path's producer "
          f"differs from the forced one")
    del got, whole, o

    # the per-shard route, shard by shard
    f1 = [(q0[..., r * dr:(r + 1) * dr], kps[r], tab, qoff, ctx,
           None if qt is None else (qt[0][r], qt[1][r], *qt[2:]))
          for r in range(n)]
    qpos = qoff.long()[:, None] + torch.arange(Sq, device=q0.device)
    vis = (ref._visible(qoff, ctx, Sq, T, q0.device)
           & (qpos < ctx.long()[:, None])[:, :, None])[:, None]
    vis = vis.expand(B, H, Sq, T)
    ws = torch.empty((B, H, Sq, T), dtype=torch.float32, device=q0.device)

    def kf1(r):
        q, k, t, o, c, sq = f1[r]
        return pa.paged_chunk_scores(q, k, t, o, c, quant=sq, out=ws,
                                     accumulate=r > 0)

    def kf2(r):
        return pa.paged_chunk_softmax_pv(ws, vps[r], tab, qoff, ctx, D,
                                         dtype, quant=f1[r][5])
    for r in range(n):
        kf1(r)
    torch.cuda.synchronize()
    want_s = torch.zeros_like(ws)
    for r in range(n):
        q, k, t, o, c, sq = f1[r]
        want_s += ref.paged_chunk_scores_partial_ref(q, k, t, o, c, quant=sq)
    s_scale = want_s[vis].abs().max().item() if bool(vis.any()) else 0.0
    s_err = (ws[vis] - want_s[vis]).abs().max().item() \
        if bool(vis.any()) else 0.0
    check(bool(torch.isfinite(ws[vis]).all()), f"{label}: F1's scores are "
          f"not finite")
    check(s_err <= TOL[dtype] * s_scale, f"{label}: F1's summed scores off "
          f"the plain ones by {s_err:.3g} > {TOL[dtype]} x {s_scale:.3g}")
    del want_s
    outs, f_err, f_scale = [], 0.0, 0.0
    for r in range(n):
        o = kf2(r)
        torch.cuda.synchronize()
        w = ref.paged_chunk_softmax_pv_ref(ws, vps[r], tab, qoff, ctx, D,
                                           dtype, quant=f1[r][5])
        check(bool(torch.isfinite(o.float()).all()),
              f"{label} shard {r}: F2's output not finite")
        e, sc = held(o, w, f"shard {r}'s F2")
        f_err, f_scale = max(f_err, e), max(f_scale, sc)
        outs.append(o)
    merr, mscale = held(torch.cat(outs, dim=-1), plain_whole,
                        "the shards' joined output")
    del plain_whole, outs

    # times and bounds
    by_prod = {p: (cuda_ms(lambda p=p: fused(p), 20),
                   device_ms(lambda p=p: fused(p))) for p in prods}
    ms = dict(fused=cuda_ms(fused, 20), f1=0.0, f2=0.0)
    host = dict(fused=host_ms(fused), f1=0.0, f2=0.0)
    dev = dict(fused=device_ms(fused), f1=0.0, f2=0.0)
    plain = dict(fused=cuda_ms(lambda: ref.paged_chunk_attention_features_ref(
        q0, kps, vps, tab, qoff, ctx, quant=qt), 1, warmup=0), f1=0.0,
        f2=0.0)
    shards_dev_ok = True
    nbytes = flops = 0
    f_work = dict(f1=[0, 0], f2=[0, 0])
    for r in range(n):
        for what, fn in (("f1", lambda r=r: kf1(r)), ("f2",
                                                      lambda r=r: kf2(r))):
            ms[what] += cuda_ms(fn, 5)
            host[what] += host_ms(fn, 5)
            d_ms = device_ms(fn, 5)
            shards_dev_ok = shards_dev_ok and d_ms is not None
            dev[what] += d_ms or 0.0
        qr, kpr, t, o, c, sq = f1[r]
        plain["f1"] += cuda_ms(lambda: ref.paged_chunk_scores_partial_ref(
            qr, kpr, t, o, c, quant=sq), 1, warmup=0)
        plain["f2"] += cuda_ms(lambda: ref.paged_chunk_softmax_pv_ref(
            ws, vps[r], tab, qoff, ctx, D, dtype, quant=sq), 1, warmup=0)
        flags = None if sq is None else sq[4]
        b1, o1 = feature_scores_work(qr, tab, qoff, ctx, page, hkv, dr,
                                     q0.element_size(), q_lens, flags,
                                     accumulate=r > 0)
        b2, o2 = feature_pv_work(ws, tab, qoff, ctx, page, hkv, dr,
                                 q0.element_size(), q_lens, flags)
        nbytes += b1 + b2
        flops += o1 + o2
        f_work["f1"] = [f_work["f1"][0] + b1, f_work["f1"][1] + o1]
        f_work["f2"] = [f_work["f2"][0] + b2, f_work["f2"][1] + o2]
    s_ms, s_by, s_tb, s_tf = bound(nbytes, flops, dtype)
    n_sm = pa._sm_count(q0.get_device())
    f2_plan = pa.feature_pv_plan(B, Sq, H, hkv, tab.shape[1], page, dr, dtype,
                                 n_sm)
    (fb, ff), _ = roofline.paged_chunk_attention_features_work(
        q0, kps, vps, tab, qoff, ctx, quant=qt)
    b_ms, b_by, t_b, t_f = bound(fb, ff, dtype)
    return dict(
        label=label, shards=n, producer=prod, max_abs_err=err,
        tma_ms=by_prod.get("tma", (None, None))[0],
        tma_device_ms=by_prod.get("tma", (None, None))[1],
        gather_ms=by_prod.get("gather", (None, None))[0],
        gather_device_ms=by_prod.get("gather", (None, None))[1],
        err_rel=err / max(scale, 1e-30),
        ms=ms["fused"], device_ms=dev["fused"], host_ms=host["fused"],
        plain_ms=plain["fused"], bound_ms=b_ms, bound_by=b_by, bytes_ms=t_b,
        ops_ms=t_f, flops=ff,
        shards_max_abs_err=max(s_err, f_err),
        scores_err_rel=s_err / max(s_scale, 1e-30),
        f2_err_rel=f_err / max(f_scale, 1e-30),
        joined_err_rel=merr / max(mscale, 1e-30),
        shards_ms=ms["f1"] + ms["f2"], f1_ms=ms["f1"], f2_ms=ms["f2"],
        shards_device_ms=dev["f1"] + dev["f2"] if shards_dev_ok else None,
        f1_device_ms=dev["f1"] if shards_dev_ok else None,
        f2_device_ms=dev["f2"] if shards_dev_ok else None,
        shards_host_ms=host["f1"] + host["f2"],
        shards_plain_ms=plain["f1"] + plain["f2"],
        shards_bound_ms=s_ms, shards_bound_by=s_by, shards_bytes_ms=s_tb,
        shards_ops_ms=s_tf, scores_gb=ws.numel() * 4 / 1e9,
        f1_bound_ms=bound(*f_work["f1"], dtype)[0],
        f2_bound_ms=bound(*f_work["f2"], dtype)[0],
        f1_row_split=pa.feature_scores_plan(B, Sq, H, hkv, tab.shape[1],
                                            page, n_sm),
        f2_split=f2_plan.n_split, f2_cta=(f2_plan.npg, f2_plan.kw),
        unsplit_ms=cuda_ms(unsplit, 20), unsplit_device_ms=device_ms(unsplit),
        library_ms=cuda_ms(sdpa_yardstick(q0, kp, vp, tab, qoff, ctx, full),
                           20),
        decode=Sq == 1)


def shard_record(rec):
    """The per-shard route's part of a feature record (F1 and F2 of every
    shard), as a kernel record."""
    return dict(max_abs_err=rec["shards_max_abs_err"], ms=rec["shards_ms"],
                device_ms=rec["shards_device_ms"],
                plain_ms=rec["shards_plain_ms"],
                bound_ms=rec["shards_bound_ms"],
                bytes_ms=rec["shards_bytes_ms"], ops_ms=rec["shards_ops_ms"],
                library_ms=rec["library_ms"])


def fmt_features(rec) -> str:
    keys = ("max_abs_err", "err_rel", "ms", "device_ms", "host_ms",
            "tma_ms", "tma_device_ms", "gather_ms", "gather_device_ms",
            "plain_ms", "bound_ms", "unsplit_ms", "unsplit_device_ms",
            "library_ms", "shards_max_abs_err", "scores_err_rel",
            "f2_err_rel", "joined_err_rel", "scores_gb", "shards_ms",
            "f1_ms", "f2_ms", "shards_device_ms", "f1_device_ms",
            "f2_device_ms", "shards_host_ms", "shards_plain_ms",
            "shards_bound_ms", "f1_bound_ms", "f2_bound_ms")
    parts = [f"{k}={rec[k]:.4g}" for k in keys if rec.get(k) is not None]
    return f"  {rec['label']}: producer={rec['producer']} " + \
        " ".join(parts) + f" bound_by={rec['bound_by']} " \
        f"shards_bound_by={rec['shards_bound_by']} f1_row_split=" \
        f"{rec['f1_row_split']} f2_split={rec['f2_split']} f2_cta=(npg, " \
        f"kw) {rec['f2_cta']}"


def retime_features(cap, what, tag):
    """The captured head-feature calls, one a distinct shape, held and
    timed through both routes by `compare_features`; their sums logged
    (all, decode-only and chunk shapes)."""
    recs = []
    for key in sorted(cap.calls, key=str):
        call, prod = cap.calls[key]
        q, kps, tab = call[0], call[1], call[3]
        label = (f"{what} B={q.shape[0]} Sq={q.shape[1]} T={tab.shape[1]} "
                 f"x {len(kps)} shards of {kps[0].shape[-1]} features")
        if call[6] is not None:
            label += (f" int8 pages "
                      f"{flag_share(tab, call[5], call[6][4], kps[0].shape[1]):.2f}")
        rec = compare_features(call, label, prod)
        log(f"[{tag}]" + fmt_features(rec))
        recs.append(rec)
        free_device_memory()
    cap.calls.clear()

    def dsum(sub, k):
        v = [r[k] for r in sub]
        return f"{sum(v):.4g}" if None not in v else "n/a"
    for part, sub in (("all", recs),
                      ("decode-only", [r for r in recs if r["decode"]]),
                      ("chunk", [r for r in recs if not r["decode"]])):
        if not sub:
            continue
        tot = {k: sum(r[k] for r in sub) for k in (
            "ms", "host_ms", "plain_ms", "bound_ms", "shards_ms", "f1_ms",
            "f2_ms", "shards_host_ms", "shards_plain_ms", "shards_bound_ms",
            "f1_bound_ms", "f2_bound_ms", "unsplit_ms", "library_ms")}
        log(f"[{tag}] {what}, {part} shapes ({len(sub)}): one-launch route "
            f"{tot['ms']:.4g} ms (device {dsum(sub, 'device_ms')}, host "
            f"{tot['host_ms']:.4g}), bound {tot['bound_ms']:.4g} ms, plain "
            f"{tot['plain_ms']:.4g} ms; per-shard F1 + F2 "
            f"{tot['shards_ms']:.4g} ms (F1 {tot['f1_ms']:.4g}, F2 "
            f"{tot['f2_ms']:.4g}; device {dsum(sub, 'shards_device_ms')}, "
            f"F1 {dsum(sub, 'f1_device_ms')}, F2 {dsum(sub, 'f2_device_ms')};"
            f" host {tot['shards_host_ms']:.4g}), bound "
            f"{tot['shards_bound_ms']:.4g} ms (F1 {tot['f1_bound_ms']:.4g}, "
            f"F2 {tot['f2_bound_ms']:.4g}), plain "
            f"{tot['shards_plain_ms']:.4g} ms; unsharded kernel "
            f"{tot['unsplit_ms']:.4g} ms (device "
            f"{dsum(sub, 'unsplit_device_ms')}); SDPA "
            f"{tot['library_ms']:.4g} ms; largest scores buffer "
            f"{max(r['scores_gb'] for r in sub):.3g} GB")
        both = [r for r in sub if r["tma_ms"] is not None
                and r["gather_ms"] is not None]
        if both:
            log(f"[{tag}] {what}, {part} shapes, the {len(both)} where TMA "
                f"is open: TMA {sum(r['tma_ms'] for r in both):.4g} ms "
                f"(device {dsum(both, 'tma_device_ms')}), gather "
                f"{sum(r['gather_ms'] for r in both):.4g} ms (device "
                f"{dsum(both, 'gather_device_ms')}); the main path's "
                f"producers {dict(collections.Counter(r['producer'] for r in both))}")
    log(f"[{tag}] {what}: the main path's producers over its "
        f"{cap.n} calls: {dict(cap.producers)}")
    return recs


def tp_pressure(cfg, model, params, seed, tp, tag, page=PAGE):
    """One pressure pass of phase 6's rounds (4 sessions x 3 turns, the fp
    budget at 40 % of the sessions' pages) on a node of ``tp`` shards (None:
    one device) at ``page`` rows a page, and one more turn of a session
    compressed just before it: B.2 (or its partial or feature mode) on
    every layer and shard once the int8 tier is active; checks that its
    lanes read int8 pages, and returns the launches and the captured
    calls."""
    rng = np.random.default_rng(seed + 21)
    gen = 16
    prompts = pressure_prompts(rng, cfg.vocab, n_sessions=4, n_turns=3)
    total = sum(-(-(sum(map(len, turns)) + len(turns) * gen) // page)
                for turns in prompts)
    hbm_pages = int(0.4 * total)
    n_pages = 2 * hbm_pages
    free_device_memory()
    base = torch.cuda.memory_allocated()
    rung = "one device" if tp is None else ShardingPlan(
        cfg, tp_mesh(tp)).pool_rung(
        (cfg.n_layers, n_pages + 1, page, cfg.n_kv_heads, cfg.d_head))
    if rung == "rows":
        cap = Capture("paged_chunk_attention_quant_partial",
                      score=lambda a: flag_share(a[-5], a[-3], a[7],
                                                 a[1].shape[1] * a[-1]),
                      key=_partial_key)
    elif rung == "features":
        cap = FeatureCapture(True, score=lambda a: flag_share(
            a[3], a[5], a[6][4], a[1][0].shape[1]))
    else:
        cap = Capture("paged_chunk_attention_quant", score=lambda a:
                      flag_share(a[-3], a[-1], a[7], a[1].shape[1]))
    zero_counts()
    node = make_node(cfg, model, params, n_pages=n_pages,
                     hbm_pages=hbm_pages, page_size=page, mesh=tp_mesh(tp))
    d = Single(node, cfg, max_steps=1000)     # phase 6's rounds: ~160
    be = node[1]
    with cap():
        pressure_rounds(d, prompts, gen)
        # whether the rounds' own lanes read int8 pages depends on the
        # prompts (the turn-2 layer evictions dequantize idle sessions): a
        # session resident in every layer is compressed and serves one more
        # turn, so B.2's lanes read int8 pages whatever the rounds did
        sid = next(f"p{s}" for s in reversed(range(len(prompts)))
                   if all(f"p{s}" in a.seqs for a in be.alloc))
        be.quantize_session(sid)        # 0 if already compressed
        check(all(a.quantized_pages_of(sid) for a in be.alloc),
              f"tp={tp}: {sid} holds no int8 page")
        d.submit(sid, [int(x) for x in rng.integers(0, cfg.vocab, 64)], gen)
        d.run()
    got = counts()
    log(f"[{tag}] pressure pass at tp={tp} ({rung}): "
        f"{len(prompts)} sessions x {len(prompts[0])} turns and {sid}'s "
        f"turn from its int8 pages, hbm_pages "
        f"{hbm_pages} of {total}, {len(d.steps)} steps, mean step "
        f"{1e3 * float(np.mean(d.steps)):.2f} ms; launches {got}; "
        f"backend stats {be.stats}")
    keys, n = expected_counts(be, "b2")
    key = keys[0]
    mixed = {k[2:]: got["k1" + k[2:]] + got[k] for k in keys}
    check(all(v == n for v in mixed.values())
          and sum(got.values()) == n * len(mixed),
          f"tp={tp} pressure: launches {got}, want {n} of kernel 1's and "
          f"B.2's {sorted(mixed)} together")
    got["merges"] = check_merges(be, f"tp={tp} pressure")
    check(be.stats["quantized_pages"] > 0 and got[key] > 0,
          f"tp={tp}: the pressure pass put no int8 page on the path")
    check(cap.n == got[key] and max(cap.scores.values()) > 0,
          f"tp={tp}: B.2's lanes never read an int8 page ({cap.n} calls "
          f"captured of {got[key]})")
    log(f"[{tag}] tp={tp}: B.2's lanes read int8 pages: the most of any "
        f"captured call {max(cap.scores.values()):.2f} of its relevant "
        f"pages")
    del d, node, be
    free_device_memory()
    held = held_bytes(cap.calls)
    after = torch.cuda.memory_allocated()
    check(after - base <= held + TP_SLACK,
          f"tp={tp} pressure: {(after - base - held) / 1e6:.1f} MB still "
          f"allocated after the node was freed")
    return got, cap


def feature_producer(cfg, tp, page):
    """The producer every one-launch feature call of a ``tp``-shard node at
    ``page`` rows must take (`pa.features_producer`): "tma" where a shard
    holds dr = 8 features and pages hold a multiple of 8 rows (the card's
    shards lie at one stride), else "gather" (minicpm-2b's dr 4 at tp
    16)."""
    return "tma" if cfg.d_head // tp == 8 and page % 8 == 0 else "gather"


def phase_tp(seed, tag=21):
    """Phase 21: llama3-8b (kv-head rung at tp 2 and 4), yi-6b (split-K rung at
    tp 8, page 16 and 8; head-feature rung at tp 16, page 8, dr 8, by TMA),
    both at 8 of their 32 layers, and minicpm-2b (head-feature rung at tp 16,
    page 8, dr 4, by the cp.async gather) at its 40, served at full width in
    bf16 on shards of the one card; pressure passes at tp 2, 8 and 16 (full
    width, 8 layers); every kernel call of the tp paths held against its plain
    version and timed.  Returns the launches and records of kernel 1 and B.2 on
    the kv-head rung, of their partial modes and of their feature modes."""
    rng = np.random.default_rng(seed)
    gen = 16
    out = dict(k1=0, k1_recs=[], b2=0, b2_recs=[], k1p=0, k1p_recs=[],
               b2p=0, b2p_recs=[], merges=0, k1f=0, k1f_recs=[], b2f=0,
               b2f_recs=[], k1fs=0, b2fs=0, table=[])
    # (tp, page): RealBackend's default page 8 gives yi-6b 1-row shard
    # pages at tp 8 and the head-feature rung (8 % 16 and 4 kv heads % 16
    # are not 0: 8 of 128 features a shard) at tp 16
    runs = {"llama3-8b": ((2, PAGE), (4, PAGE)),
            "yi-6b": ((8, PAGE), (8, 8), (16, 8)),
            "minicpm-2b": ((16, 8),)}
    # the runs' depth: llama3-8b and yi-6b keep 8 of their 32 layers (a
    # call's shapes, so the kernels' records, do not depend on the depth,
    # and the tp step is host-bound: the cut pays for phases 26-27);
    # minicpm-2b, this slice's, keeps its 40
    depth = {"llama3-8b": 8, "yi-6b": 8}
    # the pressure passes' (tp, page, layers): widths as published; a tp
    # step is host-bound, one process issuing every shard's operations, so
    # the passes keep 8 of the 32 layers (16 until the tp-16 pass came,
    # whose time they give back)
    passes = {"llama3-8b": ((2, PAGE, 8),),
              "yi-6b": ((8, PAGE, 8), (16, 8, 8)),
              "minicpm-2b": ((16, 8, 8),)}
    for name in runs:
        cfg, model, params = published(
            name, seed, tag, **({"n_layers": depth[name]} if name in depth
                                else {}))
        prompts = _turns(rng, cfg.vocab)
        single = tp_serve(cfg, model, params, prompts, gen, None, tag)
        floor = first_logits_floor(cfg, model, params, prompts, gen, single,
                                   tag)
        out["table"].append((name, None, PAGE, single["step_ms"],
                             single["launches"] / single["steps"],
                             single["shard_bytes"]))
        for tp, page in runs[name]:
            rung = ShardingPlan(cfg, tp_mesh(tp)).pool_rung(
                (cfg.n_layers, 2, page, cfg.n_kv_heads, cfg.d_head))
            cap = {"rows": lambda: Capture("paged_chunk_attention_partial",
                                           key=_partial_key),
                   "features": lambda: FeatureCapture(False),
                   "heads": lambda: Capture("paged_chunk_attention")}[rung]()
            timed = rung != "heads" or tp == 4
            run = tp_serve(cfg, model, params, prompts, gen, tp, tag,
                           captures=(cap,) if timed else (), page=page)
            held_to_single(single, run, tp, tag, floor)
            out["table"].append((name, tp, page, run["step_ms"],
                                 run["launches"] * len(run["keys"])
                                 / run["steps"], run["shard_bytes"]))
            out["merges"] += run["merges"]
            out["k1fs"] += run["got"]["k1_scores"] + run["got"]["k1_pv"]
            what = f"{name} tp={tp} page {page}"
            if rung == "rows":
                out["k1p"] += run["launches"]
                out["k1p_recs"] += retime_partial(cap, what, tag)
            elif rung == "features":
                out["k1f"] += run["launches"]
                want = feature_producer(cfg, tp, page)
                check(cap.n > 0 and dict(cap.producers) == {want: cap.n},
                      f"{what}: the main path's {cap.n} calls took "
                      f"{dict(cap.producers)}, not {want} on every call")
                out["k1f_recs"] += retime_features(cap, what, tag)
            else:
                out["k1"] += run["launches"]
                if timed:
                    out["k1_recs"] += retime(cap, f"{name} tp={tp} shard",
                                             tag)
            free_device_memory()
        del cfg, model, params
        free_device_memory()
        for ptp, page, layers in passes[name]:
            cfg, model, params = published(name, seed, tag, n_layers=layers)
            got, cap = tp_pressure(cfg, model, params, seed, ptp, tag,
                                   page=page)
            out["merges"] += got["merges"]
            what = f"{name} pressure tp={ptp} page {page}"
            out["k1fs"] += got["k1_scores"] + got["k1_pv"]
            out["b2fs"] += got["b2_scores"] + got["b2_pv"]
            if isinstance(cap, FeatureCapture):
                want = feature_producer(cfg, ptp, page)
                check(cap.n > 0 and dict(cap.producers) == {want: cap.n},
                      f"{what}: B.2's {cap.n} calls took "
                      f"{dict(cap.producers)}, not {want} on every call")
                out["b2f"] += got["b2_feat"]
                out["k1f"] += got["k1_feat"]
                out["b2f_recs"] += retime_features(cap, what, tag)
            elif cfg.n_kv_heads % ptp:
                out["b2p"] += got["b2_partial"]
                out["k1p"] += got["k1_partial"]
                out["b2p_recs"] += retime_partial(cap, what, tag)
            else:
                out["b2"] += got["b2"]
                out["k1"] += got["k1"]
                out["b2_recs"] += retime(cap, f"{what} shard", tag)
            del cfg, model, params
            free_device_memory()
    log(f"[{tag}] step ms and launches a step (model, tp, page, mean step "
        f"ms, attention kernel launches a step, pool bytes a shard): "
        f"{out['table']}")
    return out


def exact_serve(cfg, model, params, turns, gen, tp, mode, page=PAGE):
    """The session's turns on a node of ``tp`` shards at ``page`` rows a
    page, the second one preempted halfway through its decode (swapped out
    and back in); its tokens, launch rule (and merge rule) checked."""
    eng, be, mgr = make_node(cfg, model, params, n_pages=128 * PAGE // page,
                             page_size=page, max_batch=4, token_budget=128,
                             kernel_mode=mode, mesh=tp_mesh(tp))
    zero_counts()
    got, now = [], 0.0
    for i, turn in enumerate(turns):
        req = request(be, "chat", turn, gen)
        eng.submit(req)
        preempted = i != 1
        while eng.waiting or eng.running:
            now += eng.step(now)
            if not preempted and eng.running and \
                    len(req.output_ids) >= gen // 2:
                eng.preempt_one(now)
                preempted = True
        got.append(list(req.output_ids))
    ran = counts()
    keys, want = expected_counts(be)
    if mode == "ref":
        want = 0
    check(launched(ran, keys, want),
          f"{cfg.name} tp={tp} {mode}: launches {ran}, want {keys} = {want}")
    check_merges(be, f"{cfg.name} tp={tp} page {page} {mode}", mode)
    check(be.stats["swaps_out"] > 0 and be.stats["swaps_in"] > 0,
          f"{cfg.name} tp={tp}: the preemption swapped nothing out and in")
    del eng, be, mgr
    free_device_memory()
    return got


def int8_snapshot(be, pages):
    """(k codes, v codes, k scales, v scales) of ``pages`` in every layer,
    full heads and rows (one tensor whatever the shard count)."""
    lay = be._layout
    if lay is None:
        parts = (be.kq_pool, be.vq_pool, be.k_scale, be.v_scale)
    else:
        parts = (unshard(be.kq_pool, lay.spec), unshard(be.vq_pool, lay.spec),
                 be.k_scale[0], be.v_scale[0])
    return [t[:, pages].clone() for t in parts]


@contextlib.contextmanager
def shards_apart():
    """The mesh's shards taken as on distinct cards (`ops.one_device`
    false): the head-feature rung then serves by its per-shard route, F1,
    the all-reduce, F2 and the all-gather, as shards on distinct cards
    do."""
    orig = ops.one_device
    ops.one_device = lambda devices: False
    try:
        yield
    finally:
        ops.one_device = orig


def phase_exact_tp(seed, tag=22):
    """Phase 22: exact fp32 tokens at full width and 2 layers through the mesh
    — llama3-8b at tp 1, 2, 4 (the kv-head rung), yi-6b at tp 8, page 16 and 8
    (split-K) and at tp 16, page 8 (the head-feature rung, dr 8), and
    minicpm-2b at tp 16, page 8 (the head-feature rung, dr 4, MHA, tied
    embeddings), each rung by its one-launch route and, shards taken as on
    distinct cards, by its per-shard route: served with a mid-decode preemption
    (a swap-out and back), equal to the single device and to
    ``kernel_mode="ref"``; a session exported at tp 2 resumes at tp 4; one
    payload imported on one device and on the mesh, quantized: the int8 scales
    and codes bit-equal to one device's at the same page size, and its next
    turn served from its int8 pages gives the same tokens.  Returns the
    per-shard route's launches of kernel 1's F1 + F2 and B.2's (k1fs, b2fs)."""
    rng = np.random.default_rng(seed + 22)
    out = dict(k1fs=0, b2fs=0)
    # the per-shard route's (tp, page), where a model's runs hold it
    apart = (16, 8)
    gen = 16
    for name, runs in (("llama3-8b", ((1, PAGE), (2, PAGE), (4, PAGE))),
                       ("yi-6b", ((8, PAGE), (8, 8), (16, 8))),
                       ("minicpm-2b", ((16, 8),))):
        cfg, model, params = published(name, seed + 22, tag, n_layers=2,
                                       dtype="float32")
        turns = [[int(x) for x in rng.integers(0, cfg.vocab, int(n))]
                 for n in rng.integers(100, 300, 3)]
        want = exact_serve(cfg, model, params, turns, gen, None, "auto")
        got_ref = exact_serve(cfg, model, params, turns, gen, None, "ref")
        log(f"[{tag}] {cfg.name} one device: {want}")
        check(got_ref == want, f"{cfg.name}: the kernels' tokens differ "
              f"from kernel_mode='ref'")
        for tp, page in runs:
            for mode in ("auto", "ref"):
                got = exact_serve(cfg, model, params, turns, gen, tp, mode,
                                  page=page)
                check(got == want, f"{cfg.name} tp={tp} page {page} {mode}:"
                      f" tokens {got} differ from one device's {want}")
            rung = ShardingPlan(cfg, tp_mesh(tp)).pool_rung(
                (2, 2, page, cfg.n_kv_heads, cfg.d_head))
            log(f"[{tag}] {cfg.name} tp={tp} page {page} ({rung}): auto and "
                f"ref equal one device's tokens")
        if apart in runs:
            tp, page = apart
            with shards_apart():
                for mode in ("ref", "auto"):
                    got = exact_serve(cfg, model, params, turns, gen, tp,
                                      mode, page=page)
                    check(got == want, f"{cfg.name} tp={tp} page {page} "
                          f"{mode}, shards apart: tokens {got} differ from "
                          f"one device's {want}")
            ran = counts()
            out["k1fs"] += ran["k1_scores"] + ran["k1_pv"]
            log(f"[{tag}] {cfg.name} tp={tp} page {page}, the per-shard "
                f"route (shards as on distinct cards): auto and ref equal "
                f"one device's tokens; launches {ran}")
        tps = [tp for tp, _ in runs]
        if 2 in tps and 4 in tps:
            eng2, be2, mgr2 = make_node(cfg, model, params, n_pages=128,
                                        max_batch=4, token_budget=128,
                                        mesh=tp_mesh(2))
            now, got = 0.0, []
            for turn in turns[:2]:
                toks, now = serve_turn(eng2, be2, "chat", turn, gen, now)
                got.append(toks)
            tokens = be2.session_tokens("chat")
            payload = be2.export_session("chat")
            check(all(p["k"].shape[1:] == (cfg.n_kv_heads, cfg.d_head)
                      for p in payload["layers"].values()),
                  "the tp=2 export is not full-head")
            eng4, be4, mgr4 = make_node(cfg, model, params, n_pages=128,
                                        max_batch=4, token_budget=128,
                                        mesh=tp_mesh(4))
            be4.import_session("chat", payload)
            mgr4.mark_resident("chat", tokens, be4.session_kv_bytes(tokens),
                               priority=0)
            toks, _ = serve_turn(eng4, be4, "chat", turns[2], gen, now)
            got.append(toks)
            check(got == want, f"{cfg.name}: exported at tp=2 and resumed "
                  f"at tp=4: {got}, one device {want}")
            log(f"[{tag}] {cfg.name}: exported at tp=2, resumed at tp=4: "
                f"equal")
            del eng2, be2, mgr2, eng4, be4, mgr4
        # one payload on one device and on each mesh, quantized; a mesh is
        # held to one device at its own page size
        eng, be, mgr = make_node(cfg, model, params, n_pages=128,
                                 max_batch=4, token_budget=128)
        toks, now = serve_turn(eng, be, "chat", turns[0], gen, 0.0)
        tokens = be.session_tokens("chat")
        payload = be.export_session("chat")
        del eng, be, mgr
        res = {}
        pages = sorted({p for _, p in runs})
        meshes = [(None, p, False) for p in pages] + \
            [(tp, page, False) for tp, page in runs] + \
            ([apart + (True,)] if apart in runs else [])
        for tp, page, sep in meshes:
            with shards_apart() if sep else contextlib.nullcontext():
                eng, be, mgr = make_node(cfg, model, params,
                                         n_pages=128 * PAGE // page,
                                         page_size=page, max_batch=4,
                                         token_budget=128,
                                         mesh=tp_mesh(tp))
                be.import_session("chat", payload)
                mgr.mark_resident("chat", tokens,
                                  be.session_kv_bytes(tokens), priority=0)
                be._ensure_resident("chat")
                be.drain_transfers()
                check(be.quantize_session("chat") > 0,
                      f"{cfg.name} tp={tp}: nothing quantized")
                snap = int8_snapshot(be, be.alloc[0].seqs["chat"].pages[
                    :payload["n_kv"] // page])
                zero_counts()
                t2, _ = serve_turn(eng, be, "chat", turns[1], gen, now)
                ran = counts()
                keys, n = expected_counts(be, "b2")
            check(all(ran[k] == n for k in keys),
                  f"{cfg.name} tp={tp}: B.2 ran {ran} for {n} {keys}")
            if sep:
                out["b2fs"] += ran["b2_scores"] + ran["b2_pv"]
            res[tp, page, sep] = (snap, t2)
            del eng, be, mgr
        for tp, page, sep in meshes[len(pages):]:
            what = f"{cfg.name} tp={tp} page {page}" + \
                (", shards apart" if sep else "")
            for a, b, part in zip(res[tp, page, sep][0],
                                  res[None, page, False][0],
                                  ("k codes", "v codes", "k scales",
                                   "v scales")):
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"{what}: int8 {part} differ from one device's")
            check(res[tp, page, sep][1] == res[None, page, False][1],
                  f"{what}: the turn served from int8 pages differs from "
                  f"one device's")
        log(f"[{tag}] {cfg.name}: int8 scales and codes at (tp, page, "
            f"shards apart) {meshes[len(pages):]} bit-equal to one "
            f"device's; the turn read from int8 pages at every tp equal to "
            f"one device's at its page size: "
            f"{[res[None, p, False][1] for p in pages]}")
        del cfg, model, params, res
        free_device_memory()
    return out


# ---------------------------------------------------------------------------
# phases 26-27: codeqwen1.5-7b and mamba2-2.7b at full width and depth
# ---------------------------------------------------------------------------

def phase_codeqwen(seed, tag=26):
    """Phase 26: codeqwen1.5-7b (MHA: 32 heads of 128, each its own kv
    head; 32 layers, d_ff 13440, vocab 92416), bf16, at its published
    widths and depth on one card.  Phase 4's serve (`phase_serve`: 4
    sessions x 3 turns, chunked prompts, a shared system prompt adopted
    with a copy-on-write fork, kernel 1 at G = 1, D = 128 on every layer
    of every dispatch, the lockstep twins, the main path's calls re-timed),
    then one pressure pass at full depth (`tp_pressure` on one device:
    phase 6's rounds with the fp budget at 40 % of the sessions' pages,
    and a turn of a session compressed just before it): B.2 at G = 1, D =
    128 on lanes that read int8 pages, its calls held and re-timed.
    Returns kernel 1's launches and records, then B.2's."""
    cfg, model, params = published("codeqwen1.5-7b", seed, tag)
    k1, k1_recs = phase_serve(cfg, model, params, seed, tag=tag)[:2]
    free_device_memory()
    got, cap = tp_pressure(cfg, model, params, seed, None, tag)
    b2_recs = retime(cap, "codeqwen1.5-7b pressure", tag)
    del cfg, model, params, cap
    free_device_memory()
    return k1 + got["k1"], k1_recs, got["b2"], b2_recs


def phase_mamba2(seed, tag=27):
    """Phase 27: mamba2-2.7b (64 Mamba2 layers, 80 SSD heads of 64, d_state
    128, no attention), bf16, at its published widths and full depth,
    served as phase 9 serves zamba2-2.7b (`phase_hybrid`): ssd_scan on
    every layer of every dispatch and no plain call, a session's state
    swapped out and back, one persisted, the node crashed and the session
    recovered from the spool by a second node; the tokens held in lockstep
    to the plain path and to the plain path in float64 under phase 9's
    flip-floor rule (64 layers fit the time, so no dense recompute stands
    in for the lockstep); the main path's scan calls re-timed against the
    plain version and the bound from ``roofline.cost``.  Returns the scan's
    launches and records."""
    cfg, model, params = published("mamba2-2.7b", seed, tag)
    launches, srecs, _, _ = phase_hybrid(cfg, model, params, seed, tag,
                                         "mamba2")
    del cfg, model, params
    free_device_memory()
    return launches, srecs


# ---------------------------------------------------------------------------
# phases 23-24: training
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4        # phase 23's depth: llama3-8b keeps 4 of its 32
# and zamba2-2.7b 12 of its 54 Mamba layers: two groups of shared_every 6,
# so both shared parameter sets are applied and trained
TRAIN_HYBRID_LAYERS = 12
TRAIN_FAMILIES = (("matmul", ("gemm", "cutlass", "cublas", "xmma", "sm90",
                              "nvjet")),
                  ("softmax", ("softmax",)),
                  ("reduce", ("reduce",)),
                  ("elementwise", ("elementwise", "vectorized")),
                  ("copy", ("memcpy", "memset")))


def phase_train_full(seed, card, tag=23):
    """llama3-8b at its published widths, 4 of its 32 layers, bf16:
    `make_train_step` (2 microbatches, AdamW at its default lr 3e-4) for 6
    steps on one repeated batch of 8 x 1024 tokens; returns the losses.
    `train()` fixes the reference's lr of 3e-3, under which this model's
    loss rose over 6 steps of fresh batches (PERF.md §6); phase 24 runs
    `train()`."""
    base = configs.get_config("llama3-8b")
    cfg = dataclasses.replace(base, n_layers=TRAIN_LAYERS)
    model = get_model(cfg, device="cuda")
    n = model.param_count()
    log(f"[{tag}] llama3-8b at its published widths: d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}; depth cut to "
        f"{cfg.n_layers} of {base.n_layers} layers ({n / 1e9:.3f} B "
        f"parameters; training state ~20 bytes a parameter, ~"
        f"{20 * get_model(base, device='meta').param_count() / 1e9:.0f} GB "
        f"at 32 layers, more than one card holds)")
    dc = DataConfig(vocab=cfg.vocab, seq_len=1024, global_batch=8, seed=seed)
    batch = TokenPipeline(dc).batch(0)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(model.device).manual_seed(seed))
    opt = adamw_init(params)
    step = make_train_step(model, AdamWConfig(), n_microbatches=2)
    losses, stamps = [], [time.perf_counter()]
    for _ in range(6):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))              # the host waits for the step
        stamps.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated() - base_mem
    state = sum(t.numel() * t.element_size() for t in leaves((params, opt)))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        wall = time.perf_counter() - t0
    check(all(np.isfinite(losses)), f"[{tag}] a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"[{tag}] the loss did not fall: {losses}")
    silent = [k for k, m in flatten(opt["mu"]).items()
              if not bool(m.abs().amax() > 0)]
    check(not silent, f"[{tag}] leaves that never got a gradient: {silent}")
    steps_s = np.diff(stamps)[1:]             # steps 1-5; step 0 warms up
    step_s = float(np.median(steps_s))
    tokens = dc.global_batch * dc.seq_len
    # the untied input embedding is a gather: no matmul FLOPs (lm_head's
    # table stays counted)
    n_mm = n - (0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model)
    share = 6 * n_mm * tokens / (step_s * PEAK_FLOPS[torch.bfloat16])
    log(f"[{tag}] losses {[round(x, 4) for x in losses]}; every leaf got a "
        f"gradient (AdamW's first moment nonzero)")
    log(f"[{tag}] step ms (median of steps 1-5; step 0 "
        f"{1e3 * (stamps[1] - stamps[0]):.1f}) {1e3 * step_s:.1f} "
        f"({', '.join(f'{1e3 * t:.1f}' for t in steps_s)}); "
        f"{tokens / step_s:.0f} tokens/s; model-FLOPs share "
        f"6·N·tokens / (step s · 989 TFLOP/s) = {share:.4f} "
        f"(N = {n_mm}, the parameters that do matmuls: the layers and "
        f"lm_head, not the {n - n_mm}-parameter input embedding of the "
        f"{n} in all; recompute and attention not counted); peak memory "
        f"allocated {peak / 1e9:.2f} GB (params and optimizer state "
        f"{state / 1e9:.2f} GB); card: {card}")
    fam, total, kernels = device_families(prof, TRAIN_FAMILIES)
    check(total > 0, f"[{tag}] the profiled step holds no device time")
    log(f"[{tag}] profile of step 6 (under torch.profiler): wall "
        f"{1e3 * wall:.1f} ms, device {total:.1f} ms, idle share "
        f"{1 - total / (1e3 * wall):.3f}; device time by family: "
        f"{fmt_families(fam, total)}")
    for ms, count, name, g in sorted(kernels, reverse=True)[:12]:
        log(f"[{tag}]   {ms:8.2f} ms {count:5d} launches  {g:11s} "
            f"{name[:160]}")
    # the optimizer's share: one AdamW update on float32 gradients (what a
    # step with microbatches hands it), timed alone
    grads = tree_map(lambda p: torch.full(p.shape, 1e-3, device=p.device),
                     params)
    opt_ms = cuda_ms(lambda: adamw_update(params, grads, opt, AdamWConfig()),
                     iters=3, warmup=1)
    log(f"[{tag}] one AdamW update alone (float32 gradients of "
        f"{n / 1e9:.3f} B parameters): {opt_ms:.1f} ms, "
        f"{opt_ms / (1e3 * step_s):.3f} of the step")
    del params, opt, grads
    free_device_memory()
    return losses


def phase_train_hybrid(seed, card, tag=23):
    """zamba2-2.7b at its published widths, 12 of its 54 Mamba layers: the
    loss and its gradient (`value_and_grad`, the training step's own) on
    one batch of 2 x 1024 tokens, the scan's forward on the kernel, in the
    published bfloat16 and in float32 on the same weights, each held to
    kernel_mode='ref' per leaf.  Float32: within 2e-4 of max |g|, or twice
    the distance of the plain scan at half the chunk length from the
    plain scan (two exact forms of one function: a_log's and dt_bias's
    gradients sum long chains of decays and differ by more than 1e-4
    between them).  Bfloat16: no farther from ref than the plain bfloat16
    gradient is from the float32 one (a forward that differs in its last
    float32 bits flips bfloat16 roundings downstream).  Returns the scan's
    launches."""
    base = configs.get_config("zamba2-2.7b")
    cfg = dataclasses.replace(base, n_layers=TRAIN_HYBRID_LAYERS)
    model = get_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    half = dataclasses.replace(cfg32, ssm=dataclasses.replace(
        cfg.ssm, chunk=cfg.ssm.chunk // 2))
    params32 = tree_map(lambda t: t.float(), params)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=1024,
                                     global_batch=2, seed=seed)).batch(0)
    log(f"[{tag}] zamba2-2.7b at its published widths (d_model "
        f"{cfg.d_model}, {model.nh} SSD heads of {cfg.ssm.head_dim}, "
        f"d_state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk}, shared blocks "
        f"{cfg.n_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}); depth cut to {cfg.n_layers} of {base.n_layers} "
        f"Mamba layers ({model.n_groups_outer} shared applications, "
        f"{model.param_count() / 1e9:.3f} B parameters); batch 2 x 1024")
    res, launches = {}, 0
    for key, c, p, mode in (
            (("bfloat16", "auto"), cfg, params, "auto"),
            (("bfloat16", "ref"), cfg, params, "ref"),
            (("float32", "auto"), cfg32, params32, "auto"),
            (("float32", "ref"), cfg32, params32, "ref"),
            (("float32", "ref, half chunk"), half, params32, "ref")):
        m = model if c is cfg else get_model(c, device="cuda")
        ssd.launches = 0
        t0 = time.perf_counter()
        loss, grads = value_and_grad(m, p, batch, kernel_mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, want = ssd.launches, 2 * cfg.n_layers if mode == "auto" else 0
        check(n == want, f"[{tag}] {key}: ssd_scan launched {n} times, "
              f"{want} expected (the forward and the recompute of each "
              f"Mamba layer)")
        launches += n
        check(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads),
            f"[{tag}] {key}: loss {loss.item()} or a gradient not finite")
        res[key] = (loss.item(), grads)
        log(f"[{tag}] {key[0]} kernel_mode={key[1]}: loss {loss.item():.6f}, "
            f"loss and gradient {1e3 * wall:.1f} ms (wall, first call of "
            f"its kind)")
    keys = list(flatten(params))
    silent = [k for k, g in zip(keys, res["bfloat16", "auto"][1])
              if not bool(g.abs().amax() > 0)]
    check(not silent, f"[{tag}] leaves with a zero gradient: {silent}")
    (l16, g16), (l16r, r16), (l32, g32), (l32r, r32), (_, h32) = (
        res[k] for k in (("bfloat16", "auto"), ("bfloat16", "ref"),
                         ("float32", "auto"), ("float32", "ref"),
                         ("float32", "ref, half chunk")))
    check(abs(l32 - l32r) <= 1e-5 * abs(l32r), f"[{tag}] float32 loss "
          f"{l32} with the kernel, {l32r} plain")
    check(abs(l16 - l16r) <= max(abs(l16r - l32r), 1e-5 * abs(l32r)),
          f"[{tag}] bfloat16 loss {l16} with the kernel, {l16r} plain, "
          f"{l32r} in float32")
    w32, w16, worst = 0.0, 0.0, ""
    for k, a32, b32, c32, a16, b16 in zip(keys, g32, r32, h32, g16, r16):
        scale = b32.abs().max().item()
        err32 = (a32 - b32).abs().max().item()
        chunks = (c32 - b32).abs().max().item()
        tol32 = max(2e-4 * scale, 2 * chunks)
        check(err32 <= tol32, f"[{tag}] float32 gradient of {k} "
              f"{err32:.3e} from plain (max |g| {scale:.3e}; plain at half "
              f"the chunk {chunks:.3e} from plain)")
        floor = (b16.float() - b32).abs().max().item()
        err16 = (a16.float() - b16.float()).abs().max().item()
        check(err16 <= max(floor, 2e-4 * scale), f"[{tag}] bfloat16 "
              f"gradient of {k} {err16:.3e} from plain, farther than plain "
              f"bfloat16 from float32 ({floor:.3e})")
        if err32 / scale > w32:
            w32, worst = err32 / scale, (f"{k}, where plain at half the "
                                         f"chunk is {chunks / scale:.2e}")
        w16 = max(w16, err16 / max(floor, 2e-4 * scale))
    log(f"[{tag}] zamba2-2.7b: {launches} ssd_scan launches; every leaf got "
        f"a nonzero gradient; float32 gradients with the kernel within "
        f"{w32:.2e} of max |g| of plain ({worst}); bfloat16 within "
        f"{w16:.3f} of plain bfloat16's distance from float32 (at most 1); "
        f"losses {l16:.6f} / {l16r:.6f} (bf16 kernel / plain), {l32:.6f} / "
        f"{l32r:.6f} (float32); card: {card}")
    del model, params, params32, res
    free_device_memory()
    return launches


def scan_train_times(seed, tag=24):
    """The scan under autograd at zamba2-2.7b's SSD shapes (one lane of
    1024 steps, H = 80, P = 64, N = 64), with the kernel's forward and with
    the plain one: y and the gradients of sum(y²) (which carry the
    forward's y into the backward) held within SSD_TOL of max |plain|
    each, then forward, and forward + backward, timed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, dA, Bm, Cm, _ = scan_inputs(g, 1, 1024, 80, 64, 1, 64,
                                   torch.float32, False)
    ins = [t.requires_grad_(True) for t in (x, dA, Bm, Cm)]
    out, got = {}, {}
    for mode in ("auto", "ref"):
        def fwd():
            return ops.ssd_scan_grad(*ins, 256, mode=mode)

        def fwd_bwd():
            y, _ = fwd()
            return y.detach(), torch.autograd.grad(y.square().sum(), ins)
        got[mode] = fwd_bwd()
        out[mode] = (cuda_ms(fwd, 5), cuda_ms(fwd_bwd, 3))
    tol, worst = SSD_TOL[torch.float32], 0.0
    for what, a, b in zip(("y", "dx", "ddA", "dB", "dC"),
                          (got["auto"][0], *got["auto"][1]),
                          (got["ref"][0], *got["ref"][1])):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        check(bool(torch.isfinite(a).all()) and err <= tol * scale,
              f"[{tag}] scan under autograd: {what} with the kernel forward "
              f"{err:.3g} from plain (max |plain| {scale:.3g}, tolerance "
              f"{tol})")
        worst = max(worst, err / scale)
    log(f"[{tag}] scan under autograd at zamba2-2.7b's SSD shapes (1 x 1024 "
        f"steps, H 80, P 64, N 64, float32): y and the gradients of sum(y²) "
        f"with the kernel forward within {worst:.3g} of max |plain| "
        f"(tolerance {tol}); forward {out['auto'][0]:.3f} ms with the "
        f"kernel, {out['ref'][0]:.3f} plain; forward + backward (the "
        f"backward recomputes the plain scan) {out['auto'][1]:.3f} and "
        f"{out['ref'][1]:.3f}")
    return out


def phase_train_held(seed, card, tag=24):
    """Training on the card held to the CPU and to the plain path at
    reduced size, float32; returns the scan's launches on the hybrid's
    training path."""
    t0 = time.perf_counter()
    launches = 0
    for arch in ("llama3-8b", "zamba2-2.7b"):
        cfg = configs.get_config(arch).reduced(dtype="float32")
        cmodel, model = get_model(cfg, device="cpu"), get_model(cfg)
        cparams = cmodel.init(torch.Generator().manual_seed(seed))
        params = tree_map(lambda t: t.to(model.device), cparams)
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=128,
                                        global_batch=4, seed=seed))
        hybrid = cfg.family == "hybrid"
        if hybrid:
            # the kernel's training use: gradients with the CUDA scan
            # forward against the all-plain path, on the same inputs
            b = pipe.batch(0)
            got, want = (dict(zip(flatten(params), value_and_grad(
                model, params, b, kernel_mode=m)[1])) for m in ("auto", "ref"))
            worst = 0.0
            for k, a in got.items():
                scale = want[k].abs().max().item()
                err = (a - want[k]).abs().max().item()
                check(err <= 2e-4 * scale, f"[{tag}] {arch}: gradient of "
                      f"{k} {err:.3e} from the plain path's (max |g| "
                      f"{scale:.3e})")
                worst = max(worst, err / scale if scale else 0.0)
            log(f"[{tag}] {arch}: every gradient with the CUDA scan forward "
                f"within {worst:.2e} of max |g| of the plain path's "
                f"(tolerance 2e-4)")
        opt_cfg = AdamWConfig(lr=3e-3)
        cstep = make_train_step(cmodel, opt_cfg, n_microbatches=2)
        step = make_train_step(model, opt_cfg, n_microbatches=2)
        copt, opt = adamw_init(cparams), adamw_init(params)
        ssd.launches = 0
        for s in range(3):
            b = pipe.batch(s)
            cparams, copt, closs = cstep(cparams, copt, b)
            params, opt, loss = step(params, opt, b)
            rel = abs(loss.item() - closs.item()) / abs(closs.item())
            check(rel <= 1e-4, f"[{tag}] {arch} step {s}: loss {loss.item()} "
                  f"on the card, {closs.item()} on the CPU")
            log(f"[{tag}] {arch} step {s}: loss {loss.item():.6f} on the "
                f"card, {closs.item():.6f} on the CPU (rel {rel:.2e})")
        if hybrid:
            # each microbatch's forward and its recompute run the scan on
            # every Mamba layer
            want_n = 3 * 2 * 2 * cfg.n_layers
            check(ssd.launches == want_n, f"[{tag}] ssd_scan launched "
                  f"{ssd.launches} times in 3 steps, {want_n} expected")
            launches += ssd.launches
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp)
            mgr.save(3, dict(params=params, opt=opt), blocking=True)
            like = tree_map(torch.zeros_like, dict(params=cparams, opt=copt))
            back = mgr.restore(3, like)
            for (k, a), b in zip(flatten(back).items(),
                                 leaves(dict(params=params, opt=opt))):
                check(a.device.type == "cpu" and a.dtype == b.dtype
                      and torch.equal(a, b.cpu()), f"[{tag}] {arch}: "
                      f"checkpoint leaf {k} not restored bit for bit")
        log(f"[{tag}] {arch}: a checkpoint written on the card restores on "
            f"the CPU bit for bit")
    cfg = configs.get_config("llama3-8b").reduced(dtype="float32")
    model = get_model(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        train(model, cfg, TrainConfig(steps=6, checkpoint_every=3,
                                      log_every=100, ckpt_dir=tmp), dc)
        _, opt, losses = train(model, cfg, TrainConfig(
            steps=8, checkpoint_every=3, log_every=100, ckpt_dir=tmp), dc)
    check(len(losses) == 2 and int(opt["step"]) == 8,
          f"[{tag}] the resumed run took {len(losses)} steps to step "
          f"{int(opt['step'])}, not 2 to step 8")
    log(f"[{tag}] crash and resume: train() to step 6, rerun to step 8, "
        f"ran exactly 2 steps")
    scan_train_times(seed, tag)
    log(f"[{tag}] in {time.perf_counter() - t0:.1f} s; card: {card}")
    free_device_memory()
    return launches


class StepCapture:
    """Records the arguments of one model's `step_paged` calls while
    active: the first step with the most tokens that carries a prompt
    chunk (Sq > 1) and the decode-only step (Sq = 1) with the most lanes.
    Small tensors are cloned; the pools are kept by reference."""

    def __init__(self, model):
        self.model = model
        self.steps = {}

    @contextlib.contextmanager
    def __call__(self):
        orig = self.model.step_paged

        def recording(params, token_ids, k_pool, v_pool, *rest, **kw):
            B, Sq = token_ids.shape
            kind = "chunk" if Sq > 1 else "decode"
            have = self.steps.get(kind)
            if have is None or B * Sq > have[0]:
                self.steps[kind] = (B * Sq, (params, token_ids.clone(),
                                             k_pool, v_pool,
                                             *(t.clone() if isinstance(
                                                 t, torch.Tensor) else t
                                               for t in rest)), dict(kw))
            return orig(params, token_ids, k_pool, v_pool, *rest, **kw)

        self.model.step_paged = recording
        try:
            yield
        finally:
            del self.model.step_paged


def step_device_ms(fn):
    """One call of ``fn`` after a warm-up, under torch.profiler: the
    device time of its kernels (ms), or None when the trace holds none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    _, total, _ = device_families(prof, ())
    return total or None


def step_host_ms(fn, reps=5):
    """Median host wall time (ms) of ``fn`` ending in a synchronise."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


def phase_roofline(cfg, model, params, seed, card, tag=25):
    """Phase 25(c): phase 4's first two rounds of traffic on llama3-8b
    (32 layers, bf16); its largest chunked-prefill step and its largest
    decode step replayed under the roofline counter through the kernels
    and through the plain versions (kernel_mode="ref", the lockstep twin's
    route), which must be charged identical work; each step's counted
    FLOPs and bytes, its bound, its device time (torch.profiler) and host
    wall time, and its share of the bound."""
    rng = np.random.default_rng(seed)
    prompts = _turns(rng, cfg.vocab)
    eng, be, _ = make_node(cfg, model, params, n_pages=1024)
    cap = StepCapture(model)
    now = 0.0
    with cap():
        for rnd in rounds(prompts)[:2]:
            for s, t in rnd:
                eng.submit(request(be, f"s{s}", prompts[s][t], 16))
            while eng.waiting or eng.running:
                now += eng.step(now)
    torch.cuda.synchronize()
    check(set(cap.steps) == {"chunk", "decode"},
          f"captured the step kinds {sorted(cap.steps)}")
    out = {}
    for kind in ("chunk", "decode"):
        _, args, kw = cap.steps[kind]
        B, Sq = args[1].shape

        def step(mode="auto"):
            return model.step_paged(*args, **{**kw, "kernel_mode": mode})
        kc = roofline.count(step)
        rc = roofline.count(step, "ref")
        kj, rj = kc.to_json(), rc.to_json()
        same = ({k: v for k, v in kj.items() if k != "peak_live_bytes"}
                == {k: v for k, v in rj.items() if k != "peak_live_bytes"})
        check(same, f"[{tag}] the {kind} step is charged different work "
              f"through the kernels ({kj}) and the plain versions ({rj})")
        check(kj["kernels"].get("paged_chunk_attention", {}).get("calls")
              == cfg.n_layers, f"[{tag}] the {kind} step charged "
              f"{kj['kernels']} kernel calls, not {cfg.n_layers}")
        b_ms, by, t_b, t_f = kc.bound()
        dev = step_device_ms(step)
        host = step_host_ms(step)
        share = None if not dev else b_ms / dev
        log(f"[{tag}] {kind} step B={B} Sq={Sq} (tokens {int(B * Sq)}, "
            f"real {int((args[6] - args[5]).clamp(min=0).sum())}): counted "
            f"{kc.flops / 1e12:.4f} TFLOP, {kc.hbm_bytes / 1e9:.4f} GB "
            f"(the same through the plain versions: {same}); kernel 1's "
            f"share {kj['kernels']['paged_chunk_attention']}; bound "
            f"{b_ms:.4f} ms by {by} (bytes {t_b:.4f} ms, operations "
            f"{t_f:.4f} ms); device {dev if dev is None else f'{dev:.4f}'} "
            f"ms (torch.profiler), host wall {host:.4f} ms; share of the "
            f"bound {share if share is None else f'{share:.4f}'} of the "
            f"device time, {b_ms / host:.4f} of the wall; card {card}")
        out[kind] = dict(flops=kc.flops, bytes=kc.hbm_bytes, bound_ms=b_ms,
                         bound_by=by, device_ms=dev, host_ms=host)
    del eng, be, cap
    free_device_memory()
    return out


def phase_launchers(seed, card, tag=25):
    """Phase 25(a) and (b): ``repro_torch.launch.serve`` as a user runs
    it.  (a) The simulation at paper scale (llama3-8b, 8 nodes, 256 users)
    for symphony and stateless: host only, no device.  (b) ``--real`` on the
    card: the 3-node cluster with a migration and a failure, its own checks
    (tokens equal the dense recompute's); kernel 1 on every layer of every
    dispatch, B.4 on every layer of the reference's prefills, no plain
    call.  Returns (kernel-1 launches, B.4 launches) of (b)."""
    from repro_torch.launch import serve
    # the two simulations run side by side, one process each, as a user
    # would start them
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    procs = {policy: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3-8b", "--policy", policy, "--nodes", "8", "--users", "256"],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for policy in ("symphony", "stateless")}
    done = {}
    for policy, proc in procs.items():
        try:
            done[policy] = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            done[policy] = proc.communicate()
    for policy, (so, se) in done.items():
        rc = procs[policy].returncode
        check(rc == 0, f"launch.serve --policy {policy} exited {rc}: "
              f"{se[-800:]}")
        rec = json.loads(so)
        log(f"[{tag}a] host only, no device: launch.serve --policy {policy}"
            f" (llama3-8b, 8 nodes, 256 users), both in "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(rec)}")
        check(rec["completed"] > 0, f"{policy}: no request completed")
    plain = PlainCalls()
    pa.launches = fp.launches = 0          # counts of the main path only
    buf = io.StringIO()
    t0 = time.perf_counter()
    with plain(), contextlib.redirect_stdout(buf):
        rec = serve.main(["--real"])
    torch.cuda.synchronize()
    k1, b4 = pa.launches, fp.launches
    for line in buf.getvalue().splitlines()[:3]:
        log(f"[{tag}b] {line}")
    log(f"[{tag}b] launch.serve --real in {time.perf_counter() - t0:.1f} s:"
        f" kernel 1 launched {k1} = {rec['n_layers']} layers x "
        f"{rec['sub_dispatches']} dispatches; B.4 {b4} = {rec['n_layers']} "
        f"layers x {rec['reference_prefills']} reference prefills; plain "
        f"calls {plain.n}; card {card}")
    check(rec["tokens_match"] and rec["migrations"] >= 1 and rec["dead"],
          f"launch.serve --real: {rec}")
    check(k1 == rec["n_layers"] * rec["sub_dispatches"] and k1 > 0,
          f"kernel 1 launched {k1} times, not {rec['n_layers']} x "
          f"{rec['sub_dispatches']}")
    check(b4 == rec["n_layers"] * rec["reference_prefills"],
          f"B.4 launched {b4} times, not {rec['n_layers']} x "
          f"{rec['reference_prefills']}")
    check(plain.n == 0, f"the plain versions ran {plain.n} times on the "
          f"launcher's path")
    free_device_memory()
    return k1, b4


def free_device_memory():
    """Release what a finished phase held: its nodes form reference cycles
    (backend <-> node manager) that only the cyclic collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def kernel_entry(name, source, replaces, launches, recs):
    entry = dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max((r["max_abs_err"] for r in recs), default=None),
        ms=sum(r["ms"] for r in recs) if recs else None,
        device_ms=(sum(r["device_ms"] for r in recs) if recs and all(
            r.get("device_ms") is not None for r in recs) else None),
        plain_ms=sum(r["plain_ms"] for r in recs) if recs else None,
        bound_ms=sum(r["bound_ms"] for r in recs) if recs else None,
        bound_by=None, library_ms=None)
    if recs:
        t_b = sum(r["bytes_ms"] for r in recs)
        t_f = sum(r["ops_ms"] for r in recs)
        entry["bound_by"] = "bytes" if t_b >= t_f else "operations"
        if all(r["library_ms"] is not None for r in recs):
            entry["library_ms"] = sum(r["library_ms"] for r in recs)
    return entry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(map(str, range(1, 28))))
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    t_start = time.perf_counter()
    mark = [t_start]

    def lap(what):
        now = time.perf_counter()
        log(f"[{what}] in {now - mark[0]:.1f} s")
        mark[0] = now
    try:
        kind, card = phase_env()
        built = phase_build() if 2 in phases else {}
        shape_recs, shape_qrecs = (
            phase_kernel_vs_plain(np.random.default_rng(args.seed), built)
            if 3 in phases else ([], []))
        lap("phases 1-3")
        flash_shape_recs = (phase_flash_vs_plain(args.seed, built)
                            if 11 in phases else [])
        lap("phase 11")
        launches, main_recs, qlaunches, qrecs = 0, [], 0, []
        flaunches, flash_recs, decode = 0, [], []
        # B.3 lies on no serving path: its count over every serving phase
        # (all but 14, which compares it) is read and must stay 0
        pa.decode_launches = 0
        if phases & {4, 6, 12, 25}:
            cfg, model, params = llama3_8b(args.seed,
                                           min(phases & {4, 6, 12, 25}))
            if 4 in phases:
                launches, main_recs, decode = phase_serve(cfg, model, params,
                                                          args.seed)
            if 6 in phases:
                qlaunches, qrecs, _ = phase_pressure(cfg, model, params,
                                                     args.seed)
            if 12 in phases:
                flaunches, flash_recs = phase_cluster(cfg, model, params,
                                                      args.seed, card)
            if 25 in phases:            # phase 25(c), on phase 4's model
                phase_roofline(cfg, model, params, args.seed, card)
            del cfg, model, params
            free_device_memory()
        lap("phases 4, 6, 12, 25(c)")
        dlaunches = pa.decode_launches
        decode_recs, replay_recs = (
            phase_decode_vs_plain(np.random.default_rng(args.seed + 14),
                                  decode) if 14 in phases else ([], []))
        decode.clear()
        lap("phase 14")
        pa.decode_launches = 0
        # a phase's nodes are freed by the cyclic collector only: every
        # phase ends with free_device_memory(), here or in its own body, so
        # none of its tensors is allocated when the next measures memory
        if 5 in phases:
            phase_exact_fp32(args.seed)
            free_device_memory()
        if 7 in phases:
            phase_exact_tiers(args.seed)
            free_device_memory()
        if 13 in phases:
            phase_exact_cluster(args.seed)
        lap("phases 5, 7, 13")
        scan_recs, d80_recs = [], []
        if 8 in phases:
            scan_recs = phase_scan_vs_plain(args.seed)
            d80_recs = phase_d80_vs_plain(np.random.default_rng(args.seed + 8))
            free_device_memory()
        lap("phase 8")
        slaunches, hybrid_srecs, hlaunches, hybrid_arecs = 0, [], 0, []
        if 9 in phases:
            # 18 of 54 layers: the depth cut that pays for phases 26-27
            cfg, model, params = zamba2(args.seed, 9, n_layers=18)
            slaunches, hybrid_srecs, hlaunches, hybrid_arecs = phase_hybrid(
                cfg, model, params, args.seed)
            del cfg, model, params
            free_device_memory()
        if 10 in phases:
            phase_exact_hybrid(args.seed)
            free_device_memory()
        lap("phases 9, 10")
        if 15 in phases:
            # 16 of 48 blocks: the depth cut that pays for phases 26-27
            cfg, model, params = xlstm(args.seed, 15, n_layers=16)
            phase_xlstm(cfg, model, params, args.seed)
            del cfg, model, params
            free_device_memory()
        if 16 in phases:
            phase_exact_xlstm(args.seed)
            free_device_memory()
        lap("phases 15, 16")
        # phases 17-19: each main path is driven with its counts set to 0
        # just before it and read just after, inside the phase
        vk1, vk1_recs, vq, vq_recs, af, af_recs = 0, [], 0, [], 0, []
        if 17 in phases:
            # 8 of 32 layers: the depth cut that pays for phases 26-27
            cfg, model, params = published("phi-3-vision-4.2b", args.seed,
                                           17, n_layers=8)
            af, af_recs = phase_vlm_prefill(cfg, model, params, args.seed)
            # phase 4's decode replays are phase 14's: phi-3-vision's
            # (copies of whole pools, 1.65 GB) are not kept
            vk1, vk1_recs = phase_serve(cfg, model, params, args.seed,
                                        tag=17)[:2]
            free_device_memory()
            fl, vq, vq_recs = phase_vlm_pressure(cfg, model, params,
                                                 args.seed)
            vk1 += fl
            del cfg, model, params
            free_device_memory()
            lap("phase 17")
        for ph, fn in ((18, phase_moe), (19, phase_encdec)):
            if ph in phases:
                n, recs = fn(args.seed)
                af += n
                af_recs += recs
                lap(f"phase {ph}")
        if 20 in phases:
            phase_exact_a9(args.seed)
            lap("phase 20")
        # phase 21 drives each tp main path with the counts set to 0 just
        # before it and reads them just after, inside the phase
        tp = dict(k1=0, k1_recs=[], b2=0, b2_recs=[], k1p=0, k1p_recs=[],
                  b2p=0, b2p_recs=[], merges=0, k1f=0, k1f_recs=[], b2f=0,
                  b2f_recs=[], k1fs=0, b2fs=0)
        if 21 in phases:
            tp = phase_tp(args.seed)
            check(tp["k1p"] > 0 and tp["b2p"] > 0 and tp["merges"] > 0,
                  f"the partial modes ran {tp['k1p']} and {tp['b2p']} "
                  f"times, their merge {tp['merges']}, on phase 21's "
                  f"split-K paths")
            check(tp["k1f"] > 0 and tp["b2f"] > 0,
                  f"the one-launch feature route ran {tp['k1f']} and "
                  f"{tp['b2f']} times on phase 21's head-feature paths")
            lap("phase 21")
        if 22 in phases:
            # the per-shard route's launches: its fp32 serve at tp 16
            # (counts set to 0 just before, read just after, inside)
            apart = phase_exact_tp(args.seed)
            check(apart["k1fs"] > 0 and apart["b2fs"] > 0,
                  f"the per-shard feature route ran {apart} on phase 22's "
                  f"shards-apart serves")
            tp["k1fs"] += apart["k1fs"]
            tp["b2fs"] += apart["b2fs"]
            free_device_memory()
            lap("phase 22")
        # phases 23-24 drive the hybrid's training paths with the scan's
        # count set to 0 just before each and read just after, inside them
        tlaunches = 0
        if 23 in phases:
            phase_train_full(args.seed, card)
            tlaunches += phase_train_hybrid(args.seed, card)
            lap("phase 23")
        if 24 in phases:
            tlaunches += phase_train_held(args.seed, card)
            lap("phase 24")
        # phase 25(b) drives the launcher's real cluster with the counts
        # set to 0 just before it and reads them just after, inside it
        lk1 = lb4 = 0
        if 25 in phases:
            lk1, lb4 = phase_launchers(args.seed, card)
            lap("phase 25(a, b)")
        # phases 26-27 set their counts to 0 just before each main path and
        # read them just after, inside the phase
        cq1, cq1_recs, cqq, cqq_recs, mlaunches, m_srecs = 0, [], 0, [], 0, []
        if 26 in phases:
            cq1, cq1_recs, cqq, cqq_recs = phase_codeqwen(args.seed)
            lap("phase 26")
        if 27 in phases:
            mlaunches, m_srecs = phase_mamba2(args.seed)
            lap("phase 27")
        dlaunches += pa.decode_launches
        check(dlaunches == 0, f"B.3 launched {dlaunches} times on the "
              f"serving paths, which decode through kernel 1")
    except PhaseFailed as e:
        log(f"FAILED: {e}")
        return 1
    # each record holds its kernel's main-path shapes whenever that main
    # path ran, and the kernel-vs-plain phase's shapes otherwise; kernel 1
    # serves four main paths on one device (llama3-8b at D = 128,
    # zamba2-2.7b at D = 80, phi-3-vision at D = 96, codeqwen1.5-7b at G =
    # 1, D = 128), B.2 three (llama3-8b, phi-3-vision and codeqwen1.5-7b
    # under pressure); the scan two (zamba2-2.7b at N = 64, mamba2-2.7b at
    # N = 128); B.4's main paths are the dense reference of phase 12 and
    # the prefills of phases 17-19 (D = 96, G = 3, G = 8, D = 64); B.3
    # lies on no serving path (its launches there, counted, are 0): its
    # record holds
    # phase 4's decode-only kernel-1 calls replayed through it when phase 4
    # ran, phase 14's cases otherwise
    src = "src/repro_torch/csrc/paged_chunk_attention.cu"
    k1_recs = ((main_recs if 4 in phases else shape_recs)
               + (hybrid_arecs if 9 in phases
                  else [r for r in d80_recs if "int8" not in r["label"]]))
    entries = [
        kernel_entry(pa.NAME, src, "src/repro/kernels/paged_attention.py:291",
                     launches + hlaunches + vk1 + tp["k1"] + lk1 + cq1,
                     k1_recs + vk1_recs + tp["k1_recs"] + cq1_recs),
        kernel_entry(pa.QUANT_NAME, src,
                     "src/repro/kernels/paged_attention.py:239",
                     qlaunches + vq + tp["b2"] + cqq,
                     (qrecs if 6 in phases else shape_qrecs) + vq_recs
                     + tp["b2_recs"] + cqq_recs),
        # the split-K partial mode of both (phase 21's yi-6b at tp 8): its
        # records sum the shards' calls of each captured shape; library_ms
        # is SDPA over the whole call's gathered K/V
        kernel_entry(pa.NAME + "_partial", src,
                     "src/repro/kernels/paged_attention.py:291", tp["k1p"],
                     tp["k1p_recs"]),
        kernel_entry(pa.QUANT_NAME + "_partial", src,
                     "src/repro/kernels/paged_attention.py:239", tp["b2p"],
                     tp["b2p_recs"]),
        # the merge of both partial modes' calls (one launch a call): the
        # softmax combine that GSPMD inserts around the TPU kernel on the
        # split-K rung, so no pallas_call stands behind it (replaces null);
        # no single PyTorch call computes it
        # the head-feature rung of both (phase 21's yi-6b at tp 16, page
        # 8): the one-launch route its shards take on the one card, and the
        # per-shard route of shards on distinct cards (F1 and F2 of every
        # shard, launches and times summed; its launches are phase 22's fp32
        # serves at tp 16 with the shards taken as apart) held and timed on
        # phase 21's calls; library_ms is SDPA over the whole call's
        # gathered K/V
        kernel_entry(pa.NAME + "_features", src,
                     "src/repro/kernels/paged_attention.py:291", tp["k1f"],
                     tp["k1f_recs"]),
        kernel_entry(pa.QUANT_NAME + "_features", src,
                     "src/repro/kernels/paged_attention.py:239", tp["b2f"],
                     tp["b2f_recs"]),
        kernel_entry(pa.NAME + "_features_shards",
                     "src/repro_torch/csrc/paged_chunk_features.cu",
                     "src/repro/kernels/paged_attention.py:291", tp["k1fs"],
                     [shard_record(r) for r in tp["k1f_recs"]]),
        kernel_entry(pa.QUANT_NAME + "_features_shards",
                     "src/repro_torch/csrc/paged_chunk_features.cu",
                     "src/repro/kernels/paged_attention.py:239", tp["b2fs"],
                     [shard_record(r) for r in tp["b2f_recs"]]),
        kernel_entry(pa.MERGE_NAME, "src/repro_torch/csrc/split_kv.cuh",
                     None, tp["merges"],
                     [merge_record(r) for r in tp["k1p_recs"]
                      + tp["b2p_recs"]]),
        kernel_entry(ssd.NAME, "src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:62",
                     slaunches + tlaunches + mlaunches,
                     (hybrid_srecs if 9 in phases else scan_recs) + m_srecs),
        kernel_entry(fp.NAME, "src/repro_torch/csrc/flash_prefill.cu",
                     "src/repro/kernels/flash_prefill.py:81",
                     flaunches + af + lb4,
                     (flash_recs if 12 in phases else flash_shape_recs)
                     + af_recs),
        kernel_entry(pa.DECODE_NAME, "src/repro_torch/csrc/paged_attention.cu",
                     "src/repro/kernels/paged_attention.py:351", dlaunches,
                     replay_recs or decode_recs)]
    log(f"done in {time.perf_counter() - t_start:.1f} s; kernel times are "
        f"one call of each distinct main-path shape, summed (kernel 1: "
        f"{launches} launches on the llama3-8b path, {hlaunches} on the "
        f"zamba2-2.7b path, {vk1} on the phi-3-vision paths; int8 kernel: "
        f"{qlaunches} on llama3-8b's pressure path, {vq} on phi-3-vision's; "
        f"phase 21's shards: kernel 1 {tp['k1']}, int8 kernel {tp['b2']}, "
        f"their partial modes {tp['k1p']} and {tp['b2p']}, merged by "
        f"{tp['merges']} merge launches, their one-launch feature route "
        f"{tp['k1f']} and {tp['b2f']}, the per-shard F1 + F2 {tp['k1fs']} "
        f"and {tp['b2fs']}; phase 25's launcher: kernel 1 "
        f"{lk1}, flash_prefill {lb4}; codeqwen1.5-7b (phase 26): kernel 1 "
        f"{cq1}, int8 kernel {cqq}; "
        f"flash_prefill: {flaunches} on the dense reference's prefills, "
        f"{af} on the prefills of phases 17-19; ssd_scan: {slaunches} on "
        f"zamba2-2.7b's serving path, {mlaunches} on mamba2-2.7b's, "
        f"{tlaunches} on the hybrid's training paths (phases 23-24); "
        f"paged_attention (B.3): "
        f"{dlaunches} on the "
        f"serving paths, {len(replay_recs)} replayed decode calls of phase "
        f"4)")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
