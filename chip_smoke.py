#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a card, ``nvcc`` and
PyTorch built for CUDA. It imports the port (``src/repro_torch``) and
nothing of JAX. Phases, each fatal on failure:

1. device  - the card's name and power limit from ``nvidia-smi``;
             float32 products in full precision (TF32 off for matmul and
             cuDNN, so the plain versions are exact references);
2. build   - ``nvcc`` builds every kernel from ``src/repro_torch/kernels/csrc``;
3. kernels - each kernel against its plain version: the JAX package's
             kernel test cases, attention in f32 (max abs 2e-5) and bf16
             (2e-2, and within half a bf16 step of the f32 result plus
             2^-16 max|v|; K1's bf16 path also at ragged lengths with
             B = 2, S = 37, 100, 300, 511, hd 128, 64 and 256, at hd 256
             also as MHA, and with windows that start inside a 64-key
             tile, with softcap 50; the build fails unless ptxas built
             K1's tensor-core kernel at hd 64, 128 and 256, each with
             and without a softcap, and every K2 instance (the CUDA-core
             split pass at G <= 8, the tensor-core one at G = 16, f32 and
             bf16 caches, hd 64, 128 and 256), with no spill; each K2
             instance's registers printed), the SSD scan
             in f32 against the sequential recurrence (5e-3 on y and on
             the state, also at ragged lengths; the CUDA-core kernel),
             its bf16 tensor-core path at B = 2 (S = 8, 64, 65, 300, 512
             at mamba2's head shape, and P = 80, 32) within 5e-3 and 1e-4
             of the largest magnitude of the f32 recurrence, the
             flash-decoding kernel also at its split edges (DEC_SPLIT_CASES:
             ragged per-row lengths at B = 4, max_len 1024, windows across
             splits, softcap, hd 64 and 256, G = 8; the colocate
             phase's B = 2, max_len 64 with an f32 cache; G = 16, glm4-9b's
             32 q over 2 kv heads, at hd 128 and 256), int8 quantize /
             dequantize bit-equal (q, scales and the dequantized values,
             f32 and bf16 in and out, n = 1, 255, 257, 1,000,003 and the
             path's 805,306,368), and the main paths' shapes (K1 at the
             engine's bucket lengths 8 to 1024, and its wrapper's host
             time per call; K2 at the serve path's decode lengths and at
             uniform fills 1 to 1024, beside its one-split schedule (the
             same kernel with a block per (b, kv head)), also with the
             card spun before each start event (``device_ms``), with the
             host time per call and the device time of its one launch
             (the merge is folded into the split pass); K3 at the
             serve pass's lengths 8 to 1024, beside the CUDA-core kernel
             and the wrapper it had on the same inputs, also spun, with
             the host time per call and each launch's device time; K1 at
             head dim 256, gemma2-9b's prefill shape with its window and
             softcap at S = 512 and 4,608 and gemma-7b's at 512, it and
             SDPA also spun, and every other zoo prefill instance at S =
             512: hd 64 (granite-moe, musicgen), hd 128 at G = 16
             (glm4-9b) and G = 1 (moonshot); K2 at
             glm4-9b's decode shape, G = 16, on the tensor cores, at the
             serve path's lengths and fills 64 and 1024, and at the
             other zoo decode shapes (ZOO_DEC_CASES: hd 256 gemma2-9b with
             its window and softcap and gemma-7b, hd 64 granite-moe and
             musicgen, moonshot's hd 128 at G = 1) at the serve path's
             lengths);
             kernel, plain version and the library
             yardstick where one PyTorch call computes the same function
             (``scaled_dot_product_attention``, ``torch.mul``, which the
             port never calls) timed with CUDA events;
4. serve   - full-width internlm2-1.8b (24 layers), then full-width
             mamba2-2.7b (64 layers), random weights from seed 0, each
             serves 8 greedy requests through ``ServeEngine``, once
             checking every logit row is finite, then again timed on the
             host clock alone; the timed pass's launch counts (all set to
             0 just before it) show internlm2's prefill went through the
             flash-attention kernel and its decode through the
             flash-decoding kernel, and mamba2's prefill through the
             SSD-scan kernel, once per layer and request or step; the
             first request's prefill logits and three teacher-forced
             decode steps agree between kernels and plain versions; for
             mamba2, along a ragged prompt, each layer's scan and mixer
             output with the kernel agree with the plain versions, and
             at the shortest prompt past request 0's the plain path on
             the card is read against the plain path on the CPU (the
             model's bf16 noise floor, held to no limit);
   staged  - right after internlm2's serve phase, from its bf16 weights and
             the same eight prompts (16 greedy tokens each, 4 slots, 1024
             rows, f32 cache), on the §5.2 KV fabric (``kv_fabric()``):
             the sync ``ServeEngine`` on a ``FabricRuntime`` and the
             ``StagedServeEngine`` with per-request placement, for a burst
             at t = 0 and for arrivals 0.5 simulated s apart, then the
             staged engine's decode replica pool on kv_fabric() merged
             with two spare SoC read paths, one replica added while
             decoding and retired with a shard in flight; each run's
             tokens must equal the timed ServeEngine pass's, K1 launch
             24 x 8 times and K2 24 x the run's decode steps (counts set
             to 0 just before each run), and each staged run's
             per-request TTFT, finish time, placement and token count
             equal those of the ``compute="sim"`` engine on the same
             requests and fabric; "[staged]" lines give the simulated
             TTFT p50/p99, makespan and placements, the host wall, tok/s
             and host ms per decode step beside the sync pass's;
5. train   - full-width internlm2-1.8b (24 layers), random init from seed
             0, trains 3 steps of 8 x 4096 tokens (2 microbatches) from
             the seed-0 ``TokenPipeline`` through the port's ``Trainer``,
             first with int8 AdamW moments, then with f32 moments; the
             int8 run's launch counts (set to 0 just before it) show
             every moment went through the quantize kernel at init and
             each step and through the dequantize kernel each step, and
             no attention or SSD kernel ran; every loss is finite, the
             first equal in both runs and the others within rel 1e-2;
             ``param_count_tree`` of the params on the card equals
             ``cfg.param_count()``; after the int8 run's last step, the
             moment values whose v is int8 0 under a nonzero m and the
             step's largest |dp| / lr are printed (no limit: JAX's
             arithmetic). The int8
             run also advances simulated time (``ClusterTimeModel`` of one
             node of one H100, ``core/hw.py``): each step's line adds its
             simulated seconds and tok/s, labelled as the fabric model's;
6. train_cluster - full-width internlm2-1.8b cut to 2 layers, the same
             batch, int8 moments, as 3 simulated nodes of a ``TrainCluster``
             on ``TRAIN_FABRICS["h100"]`` (heartbeats every 0.2 s, 1 s
             timeout), uncompressed checkpoints every 2 steps under a
             temporary directory (removed at the end), 4 steps: once
             without failure, once with node2 silent from step 2. The
             failure must be detected, the cluster resized and the
             checkpoint of step 0 restored, so step 1 runs again; the
             failure run's losses and every final param, int8 moment and
             scale must be bit-equal to the uninterrupted run's, and each
             run's launch counts (set to 0 just before it) must be 2 x
             leaves x (numeric steps run + 1) quantizes and 2 x leaves x
             steps run dequantizes. Prints each save's and restore's
             seconds, the checkpoint's bytes and the simulated timeline;
7. colocate - serve + train colocation on one fabric and one budget
             ledger (``repro_torch.tenancy``), as
             ``repro_torch.launch.colocate`` builds it with its headline
             flags (8 requests of 8 tokens, 4 new tokens each, 0.3
             simulated s apart; 4 train steps; QoS 16:1, SLO 1.2 x solo
             p99 TTFT, occupancy limit 0.4 on host:0): the serve tenant
             full-width internlm2-1.8b (24 layers, bf16 weights from seed
             0) in ``StagedServeEngine(slots=2, max_len=64, impl="auto")``
             (K1, K2), the train tenant a ``TrainCluster(2)`` running
             internlm2 cut to 2 layers on the train phase's batch with
             int8 moments (K4a, K4b). Solo serve, solo train, unmanaged
             and managed, each once with real compute and once with a
             ``compute="sim"`` engine and a timing-only cluster: each
             real run's simulated report must equal its sim twin's; the
             colocated runs' tokens, losses and final params, int8
             moments and scales must equal the solo runs', and the
             managed run must throttle; each run's launch counts (set to
             0 just before it) must be K1 24 x 8 per serving run, K2 24 x
             its decode steps, K4a 2 x 11 x (numeric steps + 1) and K4b
             2 x 11 x numeric steps per training run, K3 none; request
             0's prefill logits, kernels against plain, within
             MODEL_REL_TOL. Prints the launcher's lines (the fabric
             model's simulated figures under ``core/hw.py``), each run's
             host wall and the phase's peak device memory;
8. zoo     - every other arch one card holds (``ZOO``: glm4-9b, gemma2-9b,
             gemma-7b, granite-moe-1b-a400m, moonshot-v1-16b-a3b cut to
             16 layers, internvl2-2b, musicgen-large), full width, random
             weights from seed 0, one at a time: 4 greedy requests (numpy
             seed 0 lengths in [8, 512], 8 new tokens) through
             ``ServeEngine(slots=4, max_len=1024)``, checked for finite
             logits, then timed with the launch counts set to 0 (K1 once
             per attention layer and request, K2 once per attention layer
             and decode step); request 0 kernels vs plain (MoE: routing
             pinned to the plain run's, the unpinned errors and routing
             flips printed; internvl2-2b also after 256 frontend rows);
             each MoE's dropped fraction (0 at lossless capacity) and
             expert load; gemma2-9b's 4,608-token prompt past its
             4096-token window, kernels vs plain, and its prefill's host
             time with the kernels and plain; prefill ms per bucket and
             peak memory per arch;
9. dist     - the multi-device path as 4 SPMD ranks spawned on the one
             card (``repro_torch.parallel.ranks``: gloo through host
             memory, not NVLink; 600 s for the run and each collective):
             (a) the bidirectional all-gather (exact), the hierarchical
             all-reduce (4x within 1e-5 relative) and the int8 ring over
             pods (2x within 0.02) on one full-width internlm2 layer's
             w_in gradient, 2048 x 2 x 8192 f32, on (pod 2, data 2);
             (b) full-width internlm2-1.8b served with its 4,096-row KV
             cache split on the sequence over (data 4): each rank
             prefills a seeded 300-token prompt through K1 and keeps its
             quarter, then 16 greedy ``decode_step``s with
             ``cp_axis="data"``; layer 0's CP attention against the local
             decode in f32 (1e-4), and the logits against the one-rank
             path (prefill K1, decode K2, teacher-forced) within
             MODEL_REL_TOL; (c) one granite-moe-1b-a400m MoE layer at full
             width, expert-parallel on (data 2, model 2) with the FSDP
             gathers, B=4 S=512, lossless, against the dense f32 oracle
             (5e-2, dropped 0); (d) internlm2 cut to 2 layers, batch 8 x
             512, int8 moments, one step with ``pod_sync="auto"`` and one
             ``"compressed"`` from the same params on (pod 2, data 2): the
             synced grads of the ring against the exact mean within 2
             int8 steps of each leaf's largest |grad| and the grad norm
             rel 1e-2; the exact mean against one rank's step on the
             whole batch, each leaf rel 4e-2 by norm; loss
             rel 1e-3, params 5e-3; (e) (d)'s params resharded from
             ``best_mesh_for(4, model=2)`` to ``best_mesh_for(2,
             model=2)``, bit-equal; (f) reduced granite-moe's train step
             on (data 2, model 2) through the EP branch's backward, with
             UserWarning an error, aux weight 1, against one rank's step
             in 2 microbatches (the mesh's data shards): each leaf rel
             4e-2 by norm, loss rel 1e-3; (g) full-width internlm2-1.8b
             (all 24 layers) trained one step from sharded state on
             (data 2, model 2), int8 moments, batch 4 x 512, seed-0
             params: each rank builds through ``launch/train.py::build``
             and holds only its blocks (FSDP over data, tensor-parallel
             over model, the int8 moments flat over both), exactly the
             dry-run's ``argument_bytes`` for the mesh less the batch and
             the two step scalars; against rank 0's one-rank step on the
             whole batch (run first, its grads kept in host memory): loss
             rel 1e-3, every rank's grad blocks rel 4e-2 by norm of the
             same blocks of the one-rank grads (DIST_SHARD_TOL); each
             rank's held bytes, card memory peak, the step's ms, the
             host-staged bytes and K4a/K4b launches printed. "[dist]"
             lines give each figure with the card, and the host-staged
             and ring bytes;
10. dryrun  - the port's dry-run (``repro_torch.launch.dryrun``: a fake
             process group of 256 or 512 ranks, fake tensors, nothing on
             the card), started in subprocesses as the script starts and
             read here: full-width internlm2-1.8b at every applicable
             shape on both production meshes (16x16, 2x16x16), and
             granite-moe-1b-a400m train_4k on 16x16 (the expert-parallel
             path), their "[dryrun]" lines printed; then the dry-run held
             to the card: the train phase's cell (internlm2 full width, 8
             x 4096 tokens, 2 microbatches, remat minimal, int8 moments)
             on a 1x1 mesh, traced at full depth, predicts a peak (its
             arguments and the peak of the live tensors) within
             ``DRYRUN["peak_tol"]`` of the peak the int8 train run
             measured (less what was allocated before it); the same cell
             cut to 2 layers, traced, counts exactly the FLOPs that
             ``FlopCounterMode`` counts around one real step of it on the
             card.

The line before the last is a JSON object with each kernel's launches,
error, times and bound (K1 and K3 once per timed length, K2 at the path's
lengths and once per fill; K1's and K2's rows also carry the staged
runs' launches, ``staged_launches``, K4a's and K4b's the train_cluster
failure run's, ``cluster_launches``, every row the colocate phase's
four runs' together, ``colocate_launches``, the zoo phase's timed
passes', ``zoo_launches``, and a zoo shape's row its arch's,
``arch_zoo_launches``, the dist phase's per rank,
``dist_launches``, and the dryrun phase's real 2-layer step's,
``dryrun_launches``); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor cores
F32_FLOPS = 67e12               # f32 outside the tensor cores

# tests/test_kernels.py: FA_CASES (B, S, Hq, Hkv, d, window, softcap) and
# DEC_CASES (B, S, Hq, Hkv, d, window, softcap, cache_len)
FA_CASES = [(2, 256, 4, 2, 64, None, None), (1, 512, 8, 8, 128, 128, 50.0),
            (2, 512, 4, 1, 64, None, 30.0), (1, 256, 2, 2, 32, 100, None),
            (1, 256, 4, 2, 64, None, None)]
# K1's bf16 path at ragged lengths with B = 2: a partial last tile, and a
# tensor map that must not read across the batch boundary; at hd 256
# (gemma) with G = 2 and as MHA, and windows that start inside a 64-key
# tile and cross tile edges, with softcap 50. An optional eighth item
# scales q's rows in every second group of 16 (ragged_q): their scores
# reach the cap, as gemma2's do, so in each 64-row tile two warps cap
# through tanhf and two through the polynomial (cap_scores)
FA_RAGGED = [(2, s, 4, hkv, d, None, None) for s in (37, 100, 300, 511)
             for d, hkv in ((128, 2), (64, 2), (256, 2), (256, 4))] + [
    (2, 300, 4, 2, 256, 100, 50.0), (2, 511, 4, 4, 256, 70, 50.0),
    (2, 300, 4, 2, 256, None, 50.0, 40.0), (2, 511, 4, 4, 256, 70, 50.0, 40.0)]
# K1 timed at internlm2-1.8b's prefill shape (B=1, 16 q / 8 kv heads, hd
# 128, bf16) at the engine's buckets and its max_len of 1024
FA_PATH_LENS = (8, 32, 64, 256, 512, 1024)
DEC_CASES = [(2, 512, 4, 2, 64, None, None, 300), (1, 256, 8, 8, 128, 128, 50.0, 256),
             (2, 512, 4, 1, 64, None, None, 1), (1, 1024, 16, 2, 64, None, 30.0, 777)]
# K2 at its split edges (B, S, Hq, Hkv, hd, window, softcap, per-row
# lengths): ragged lengths at the serve path's decode shape, lengths on and
# off the 64-row split edges, windows that start inside a split and cross
# split edges, softcap, hd 64 and 256 with G = 8; each holds 1 and max_len.
# Then the colocate phase's decode shape (2 slots, max_len 64): an optional
# ninth item keeps the cache in that dtype while q takes the loop's, so the
# bf16 pass runs the path's bf16 q against an f32 cache. The last four run
# G = 16 (glm4-9b: 32 q heads over 2 kv heads) at split edges, with a
# window and softcap, at hd 256, and at the zoo path's dtypes
DEC_SPLIT_CASES = [(4, 1024, 16, 8, 128, None, None, (1, 1024, 300, 77)),
                   (4, 1024, 16, 8, 128, None, None, (64, 65, 1024, 1)),
                   (4, 1024, 16, 8, 128, 200, None, (1024, 130, 1, 700)),
                   (4, 1024, 16, 8, 128, 100, 30.0, (1, 1024, 257, 640)),
                   (4, 1024, 32, 4, 64, None, 50.0, (1, 1024, 129, 500)),
                   (4, 1024, 16, 2, 256, 300, None, (1024, 1, 333, 64)),
                   (2, 64, 16, 8, 128, None, None, (9, 12), "float32"),
                   (2, 64, 16, 8, 128, None, None, (1, 64), "float32"),
                   (4, 1024, 32, 2, 128, None, None, (1, 1024, 300, 77)),
                   (4, 1024, 32, 2, 128, 200, 30.0, (64, 65, 1024, 1)),
                   (4, 1024, 32, 2, 256, 300, None, (1024, 1, 333, 64)),
                   (4, 1024, 32, 2, 128, None, None, (9, 1024, 130, 1), "float32")]
# K2 timed at internlm2-1.8b's decode shape (4 slots, max_len 1024, 16 q / 8
# kv heads of 128, f32 cache, bf16 q): the serve path's lengths, and
# uniform fills (every row the same length); and at glm4-9b's (32 q / 2 kv
# heads, G = 16) at the serve path's lengths
DEC_PATH_LENS = (1, 1024, 300, 77)
DEC_FILLS = (1, 64, 256, 512, 1024)
GLM4_FILLS = (64, 1024)
# K1 timed at the zoo's prefill shapes (B=1, bf16, its tensor-core
# instances): at head dim 256 gemma2-9b's (16 q / 8 kv heads, the local
# layers' 4096-token window and softcap 50) at a bucket and at the zoo
# phase's long prompt, and gemma-7b's (16 q = 16 kv heads, causal); at hd
# 64 granite-moe's (16 / 8) and musicgen's (32 / 32); at hd 128 glm4-9b's
# (32 / 2, G = 16) and moonshot's (16 / 16): (arch, Hq, Hkv, hd, window,
# softcap, lengths)
ZOO_FA_CASES = [("gemma2-9b", 16, 8, 256, 4096, 50.0, (512, 4608)),
                ("gemma-7b", 16, 16, 256, None, None, (512,)),
                ("granite-moe-1b-a400m", 16, 8, 64, None, None, (512,)),
                ("musicgen-large", 32, 32, 64, None, None, (512,)),
                ("glm4-9b", 32, 2, 128, None, None, (512,)),
                ("moonshot-v1-16b-a3b", 16, 16, 128, None, None, (512,))]
# K2 timed at the zoo's decode shapes beside internlm2's and glm4-9b's
# (check_decode: 4 slots, max_len 1024, f32 cache, bf16 q, the serve
# path's lengths): gemma2-9b's hd 256 with its window and softcap,
# gemma-7b's hd 256 MHA, hd 64 (granite-moe, musicgen), moonshot's hd 128
# at G = 1: (arch, Hq, Hkv, hd, window, softcap)
ZOO_DEC_CASES = [("gemma2-9b", 16, 8, 256, 4096, 50.0), ("gemma-7b", 16, 16, 256, None, None),
                 ("granite-moe-1b-a400m", 16, 8, 64, None, None),
                 ("musicgen-large", 32, 32, 64, None, None),
                 ("moonshot-v1-16b-a3b", 16, 16, 128, None, None)]
# tests/test_kernels.py: SSD_CASES (B, S, H, P, N, chunk, head tile)
SSD_CASES = [(2, 64, 4, 8, 16, 16, 2), (1, 128, 6, 16, 8, 32, 3),
             (2, 256, 8, 16, 32, 64, 8)]
SSD_RAGGED = [(2, 100, 8, 16, 32, 128), (1, 300, 4, 64, 128, 128)]
SSD_TOL = 5e-3                  # the scan against the recurrence, f32 math
# K3's bf16 tensor-core path (B, S, H, P, N) at B=2: one chunk (S = 8,
# 64), a chunk edge (65), ragged lengths, at mamba2-2.7b's head shape; and
# head dims that are not a whole 64-wide tile. Held to SSD_TOL and to
# SSM_LAYER_TOL's 1e-4 of the largest magnitude against the f32 recurrence
SSD_TC_CASES = [(2, s, 80, 64, 128) for s in (8, 64, 65, 300, 512)] + [
    (2, 100, 3, 80, 64), (2, 130, 2, 32, 128)]
# K3 timed at mamba2-2.7b's prefill shape (B=1, H=80, P=64, N=128, bf16
# x/B/C) at the serve pass's lengths and the engine's max_len of 1024
SSD_PATH_LENS = (8, 29, 64, 144, 300, 436, 512, 1024)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 outputs also stay within half a bf16 step of the f32 result plus
# EXCESS_TOL * max|v|: softmax weights kept to 16 bits (K1's tensor-core
# path) leave at most 2^-18 max|v|, weights rounded to bf16 about 2^-9
EXCESS_TOL = 2.0 ** -16
MODEL_REL_TOL = 4e-2            # as tests/test_models.py: bf16 rounds differently
STAGED_SPACING = 0.5            # simulated s between arrivals; a 512-token prefill
#                                 takes ~1.7 s on kv_fabric()'s DMA path
# the decode pool's scale-out and scale-in instants (simulated s): both fall
# in the decode window at 5.889-5.94 s of the burst at these prompts, and
# the scale-in cancels a shard in flight (checked on every run)
POOL_SCALE_OUT_T, POOL_SCALE_IN_T = 5.890, 5.893
# K4: n = 1 and the ragged 255 / 257 / 1,000,003, and the path shape,
# internlm2-1.8b's largest leaf layers.mlp.w_in (24, 2048, 2, 8192)
QUANT_SIZES = (1, 255, 257, 1_000_003)
QUANT_PATH_N = 24 * 2048 * 2 * 8192
# the train phase: train_4k's sequence, global batch 8 in 2 microbatches
TRAIN = dict(arch="internlm2-1.8b", seq=4096, batch=8, microbatch=2, steps=3, lr=3e-4)
LOSS_REL_TOL = 1e-2             # int8 against f32 moments, every step
# the train_cluster phase: full-width internlm2 cut to 2 layers (a checkpoint
# of f32 masters, int8 moments and their scales is ~3.1 GB), the train
# phase's batch, 3 simulated nodes on TRAIN_FABRICS["h100"], checkpoints
# every 2 steps; node2 goes silent at step 2, after the checkpoint of step 0
# and the update of step 1, so step 1 is computed again from the checkpoint
TRAIN_CLUSTER = dict(arch="internlm2-1.8b", layers=2, seq=4096, batch=8, microbatch=2,
                     steps=4, lr=3e-4, nodes=3, every=2, keep=2, fail=("node2", 2),
                     heartbeat_every=0.2, heartbeat_timeout=1.0)
# K3 inside each mamba2 layer, kernel vs plain, relative to the largest
# plain magnitude: y and state in f32, about 5x the largest readings on an
# H100 (1.8e-5, 9.6e-6); the mixer output after bf16, two bf16 steps of
# its largest element (read 5.4e-3: one step, where y rounded the other way)
SSM_LAYER_TOL = {"y": 1e-4, "state": 1e-4, "mixer": 2.0 ** -6}
# the colocate phase: the colocation launcher's headline flags (README),
# the other flags at their defaults; the serve tenant full-width
# internlm2-1.8b (24 layers, bf16 weights from seed 0), the train tenant
# internlm2 cut to 2 layers at the train phase's batch with int8 moments
COLOCATE_ARGV = ["--arch", "internlm2-1.8b", "--requests", "8", "--train-steps", "4",
                 "--serve-weight", "16", "--slo-factor", "1.2", "--occupancy-limit", "0.4"]
COLOCATE_TRAIN = dict(layers=2, seq=4096, batch=8, microbatch=2, lr=3e-4)
COLOCATE_RUNS = ("solo_serve", "solo_train", "unmanaged", "managed")
# the zoo phase: the archs one card holds, at full width, in the JAX
# registry's order; moonshot-v1-16b-a3b cut from 48 to 16 layers (its 28.06B
# params as f32 masters plus the bf16 copy would be 168 GB; at 16 layers
# ~59 GB, its stacked w_in alone 23.6 GB in f32). (arch, layers or None)
ZOO = [("glm4-9b", None), ("gemma2-9b", None), ("gemma-7b", None),
       ("granite-moe-1b-a400m", None), ("moonshot-v1-16b-a3b", 16),
       ("internvl2-2b", None), ("musicgen-large", None)]
ZOO_SERVE = dict(slots=4, max_len=1024, requests=4, max_new=8, low=8, high=512)
# gemma2-9b's long prompt: past its local layers' 4096-token window
ZOO_LONG = dict(arch="gemma2-9b", tokens=4608, max_len=4672, steps=3)
# the dist phase: 4 SPMD ranks on the one card, gloo through host memory
DIST = dict(ranks=4, timeout=600.0,
            # (a) one full-width internlm2 layer's w_in gradient, f32
            grad_shape=(2048, 2, 8192),
            # (b) context-parallel serve: cache rows, prompt, decode steps
            cp_max_len=4096, cp_prompt=300, cp_steps=16,
            # (c) one MoE layer of granite-moe-1b-a400m at full width
            moe_arch="granite-moe-1b-a400m", moe_batch=(4, 512),
            # (d) pod sync: internlm2 cut to 2 layers, batch 8 x 512
            sync_layers=2, sync_batch=(8, 512),
            # (f) the EP train step: reduced granite-moe, batch 4 x 64
            ep_batch=(4, 64),
            # (g) the sharded train state: full-width internlm2 (every
            # layer) on (data 2, model 2), batch 4 x 512, int8 moments
            shard_mesh=(2, 2), shard_batch=(4, 512))
DIST_COLL_TOL = dict(hier=10 ** -5, comp=0.02)  # scripts/dist_checks.py:24-42
DIST_ATTN_TOL = 1e-4                            # dist_checks.py:91, f32
DIST_MOE_TOL = 5e-2                             # dist_checks.py:66
# (d): loss and params as dist_checks.py:121-125; the synced grads: the
# ring against the exact mean in int8 steps of a leaf's largest |grad| (two
# roundings at two pods, each within half a step of its own scale), the
# grad norm rel, and the exact mean against the one-rank step on the whole
# batch, each leaf rel by norm (bf16 compute copies round at other places
# in a 2-row shard: the limit of every grad held to JAX's), as
# tests/test_torch_distributed.py holds them
DIST_SYNC_TOL = dict(loss=1e-3, params=5e-3, int8=2.0, norm=1e-2, exact=4e-2)
# (f): the EP train step's grads against the one-rank step of the same
# objective, the worst leaf rel by norm (the limit (d) holds the exact mean
# to against one rank: bf16 products round at other places in a shard,
# and on a reduced MoE a rounding that flips a near-tied route moves every
# grad by a few percent; a backward that misses a rank's experts or takes
# a wrong share of the aux loss reads tenths), and its loss rel
DIST_EP_TOL = dict(grads=DIST_SYNC_TOL["exact"], loss=1e-3)
# (g): the step from sharded state against the one-rank step on the whole
# batch: the loss rel as (d)'s, each rank's grad blocks rel by norm as (d)
# holds the exact mean (bf16 products round at other places in a shard
# and in a tensor-parallel block), and each rank's held bytes equal,
# exactly, to the dry-run's argument_bytes for the mesh less the batch and
# the two step scalars
DIST_SHARD_TOL = dict(loss=DIST_SYNC_TOL["loss"], grads=DIST_SYNC_TOL["exact"], held_bytes=0)
# the dryrun phase: cells traced in subprocesses while the card works;
# the train phase's cell (TRAIN) checked against the card, whole and cut
# to check_layers layers
DRYRUN = dict(arch="internlm2-1.8b", moe_arch="granite-moe-1b-a400m", check_layers=2,
              peak_tol=0.10, timeout=1000.0)
#: figures a phase measures for a later one (the dryrun phase's checks)
MEASURED: dict = {}
# the dryrun phase's subprocess beside the prefill cells: internlm2's other
# shapes on both meshes, granite-moe's EP cell, and the train phase's cell
# on a 1x1 mesh (whole depth and the depth fit) and cut to 2 layers
DRYRUN_SCRIPT = r'''
import dataclasses, json, sys
from repro_torch.configs import RunConfig, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D

spec, train = json.loads(sys.argv[1]), json.loads(sys.argv[2])
for shape in SHAPES:
    if shape == "prefill_32k":
        continue
    for mp in (False, True):
        r = D.lower_cell(spec["arch"], shape, multi_pod=mp)
        if "skipped" in r:
            print(f"[dryrun] SKIP {spec['arch']} x {shape}: {r['skipped']}", flush=True)
D.lower_cell(spec["moe_arch"], "train_4k")
cfg = get_config(train["arch"])
shape = ShapeConfig("train_4k_b8", train["seq"], train["batch"], "train")
run = RunConfig(microbatch=train["microbatch"], moments_int8=True)
one = (("data", 1), ("model", 1))
out = {}
for name, c, ext in (("whole", cfg, False), ("fit", cfg, True),
                     ("cut", dataclasses.replace(cfg, num_layers=spec["check_layers"]), False)):
    r = D.lower_cell(train["arch"], f"{shape.name}_{name}", cfg=c, shape=shape, run=run,
                     mesh_shape=one, extrapolate=ext)
    out[name] = {k: r[k] for k in ("flops_per_chip", "compute_s", "memory", "groups_traced",
                                   "compile_s")}
print("DRYRUN " + json.dumps(out), flush=True)
'''

def fail(msg: str) -> int:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    return 1


def ragged_q(q, qscale: float = 1.0):
    """q with the rows of every second group of 16 (one warp's rows of a
    64-row tile) times ``qscale``, rounded back to q's dtype."""
    import torch
    odd = (torch.arange(q.shape[1], device=q.device) // 16) % 2 == 1
    return torch.where(odd[None, :, None, None], q.float() * qscale, q.float()).to(q.dtype)


def cuda_ms(fn, iters: int = 20, flush=None, spin: bool = False) -> float:
    """Median milliseconds of ``fn`` over ``iters`` launches timed with
    CUDA events, after warm-up; ``flush`` (a large tensor) is rewritten
    before each launch so the inputs come from device memory, not L2.
    With ``spin``, the card also spins about 50 us before each start
    event, so the stream is busy while the host enqueues ``fn``: the time
    of its kernels alone, without any gap the host's work leaves."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for start, end in ev:
        if flush is not None:
            flush.zero_()
        if spin:
            torch.cuda._sleep(100_000)                  # clock cycles
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def host_us_per_call(fns, calls: int = 200, rounds: int = 3):
    """Host microseconds per call of each of ``fns`` (the time to enqueue
    ``calls`` calls with no sync between, the card waited for before and
    after each round), the median of ``rounds`` rounds taken in turns."""
    import torch
    times = [[] for _ in fns]
    for _ in range(rounds):
        for fn, t in zip(fns, times):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t.append((time.perf_counter() - t0) * 1e6 / calls)
            torch.cuda.synchronize()
    return [float(np.median(t)) for t in times]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bf16_excess(out, ref32) -> float:
    """How far a bf16 result lies beyond half a bf16 step of the f32
    result on the same inputs: at most a few f32 roundings when the
    kernel computes in f32 and rounds once at its output."""
    import torch
    o, r = out.float(), ref32.float()
    _, e = torch.frexp(torch.maximum(o.abs(), r.abs()))
    half_step = torch.ldexp(torch.ones_like(o), e - 9)     # bf16 keeps 8 bits
    return ((o - r).abs() - half_step).max().item()


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
def phase_kernels(torch, dev):
    """Kernels against their plain versions; timings at the path shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_sequential_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def check(name, out, ref, ref32, v, tol, what):
        """max abs error against the plain version at ``tol``; a bf16
        output also against the f32 plain result (``bf16_excess``)."""
        e = err(out, ref)
        line = f"[kernels] {name} {what}: max abs err {e:.3g} (tol {tol})"
        if out.dtype == torch.bfloat16:
            x, x_tol = bf16_excess(out, ref32), EXCESS_TOL * v.abs().max().item()
            line += f", beyond half a bf16 step of f32 {x:.3g} (tol {x_tol:.3g})"
            if not x <= x_tol:
                raise AssertionError(f"{name} {what} rounds off the f32 result: {x}")
        print(line)
        if not e < tol:
            raise AssertionError(f"{name} {what} disagrees: {e} >= {tol}")
        return e

    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for b, s, hq, hkv, d, win, cap in FA_CASES:
            q, k, v = randn((b, s, hq, d), dtype), randn((b, s, hkv, d), dtype), randn((b, s, hkv, d), dtype)
            check("flash_attention", flash_attention(q, k, v, window=win, softcap=cap),
                  attention_ref(q, k, v, window=win, softcap=cap),
                  attention_ref(q.float(), k.float(), v.float(), window=win, softcap=cap),
                  v, tol, f"{dtype} B={b} S={s} Hq={hq} Hkv={hkv} hd={d} window={win} "
                  f"softcap={cap}")
        for b, s, hq, hkv, d, win, cap, *qs in FA_RAGGED if dtype == torch.bfloat16 else ():
            q, k, v = randn((b, s, hq, d), dtype), randn((b, s, hkv, d), dtype), randn((b, s, hkv, d), dtype)
            q = ragged_q(q, *qs)
            check("flash_attention", flash_attention(q, k, v, window=win, softcap=cap),
                  attention_ref(q, k, v, window=win, softcap=cap),
                  attention_ref(q.float(), k.float(), v.float(), window=win, softcap=cap), v,
                  tol, f"ragged {dtype} B={b} S={s} Hq={hq} Hkv={hkv} hd={d} window={win} "
                  f"softcap={cap}" + (f" q rows x{qs[0]:g}" if qs else ""))
        for b, s, hq, hkv, d, win, cap, clen in DEC_CASES:
            q, kc, vc = randn((b, 1, hq, d), dtype), randn((b, s, hkv, d), dtype), randn((b, s, hkv, d), dtype)
            check("decode_attention",
                  decode_attention_kernel(q, kc, vc, clen, window=win, softcap=cap),
                  decode_attention(q, kc, vc, clen, window=win, softcap=cap),
                  decode_attention(q.float(), kc.float(), vc.float(), clen, window=win,
                                   softcap=cap),
                  vc, tol, f"{dtype} B={b} S={s} Hq={hq} Hkv={hkv} hd={d} window={win} "
                  f"softcap={cap} cache_len={clen}")
        for b, s, hq, hkv, d, win, cap, lens, *cache in DEC_SPLIT_CASES:
            cdt = getattr(torch, cache[0]) if cache else dtype
            q, kc, vc = randn((b, 1, hq, d), dtype), randn((b, s, hkv, d), cdt), randn((b, s, hkv, d), cdt)
            clen = torch.tensor(lens, dtype=torch.int32, device=dev)
            check("decode_attention",
                  decode_attention_kernel(q, kc, vc, clen, window=win, softcap=cap),
                  decode_attention(q, kc, vc, clen, window=win, softcap=cap),
                  decode_attention(q.float(), kc.float(), vc.float(), clen, window=win,
                                   softcap=cap),
                  vc, tol, f"split edges {dtype} (cache {cdt}) B={b} S={s} Hq={hq} Hkv={hkv} hd={d} "
                  f"window={win} softcap={cap} cache_len={list(lens)}")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB > L2
    rows = {}
    # K1 at the model's prefill shapes: B=1, Hq=16, Hkv=8, hd=128, bf16
    for s in FA_PATH_LENS:
        q = randn((1, s, 16, 128), torch.bfloat16)
        k, v = randn((1, s, 8, 128), torch.bfloat16), randn((1, s, 8, 128), torch.bfloat16)
        e = check("flash_attention", flash_attention(q, k, v), attention_ref(q, k, v),
                  attention_ref(q.float(), k.float(), v.float()), v, TOL["bfloat16"],
                  f"path B=1 S={s} Hq=16 Hkv=8 hd=128 bf16")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k.repeat_interleave(2, 2),
                                                                 v.repeat_interleave(2, 2)))
        ms = cuda_ms(lambda: flash_attention(q, k, v), flush=flush)
        plain = cuda_ms(lambda: attention_ref(q, k, v), flush=flush)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                      flush=flush)
        ops = 4.0 * 16 * 128 * s * (s + 1) / 2          # QK and PV on the causal half
        b_ms, b_by = bound(nbytes(q, k, v, q), ops, BF16_FLOPS)
        print(f"[kernels] flash_attention path B=1 S={s} Hq=16 Hkv=8 hd=128 bf16: "
              f"err {e:.3g} kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        rows[("flash_attention", s)] = dict(max_abs_err=e, ms=ms, plain_ms=plain,
                                            bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    # the wrapper's host cost per call (checks, output allocation, three
    # tensor-map encodes, launch): 1,000 calls at S=64, whose kernels are
    # shorter than the host's work, so the host sets the pace
    q, k, v = (randn((1, 64, h, 128), torch.bfloat16) for h in (16, 8, 8))
    flash_attention(q, k, v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        flash_attention(q, k, v)
    host_us = (time.perf_counter() - t0) * 1e3          # seconds * 1e6 / 1000 calls
    torch.cuda.synchronize()
    print(f"[kernels] flash_attention wrapper: {host_us:.2f} us of host time per call "
          f"(1000 calls at S=64, no sync between)")
    # K1 at the zoo path's shapes (ZOO_FA_CASES)
    for arch, hq, hkv, d, win, cap, lens in ZOO_FA_CASES:
        for s in lens:
            q = randn((1, s, hq, d), torch.bfloat16)
            k, v = randn((1, s, hkv, d), torch.bfloat16), randn((1, s, hkv, d), torch.bfloat16)
            shape = f"B=1 S={s} Hq={hq} Hkv={hkv} hd={d} bf16 window={win} softcap={cap}"
            e = check("flash_attention", flash_attention(q, k, v, window=win, softcap=cap),
                      attention_ref(q, k, v, window=win, softcap=cap),
                      attention_ref(q.float(), k.float(), v.float(), window=win, softcap=cap),
                      v, TOL["bfloat16"], f"{arch} path {shape}")
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (
                q, k.repeat_interleave(hq // hkv, 2), v.repeat_interleave(hq // hkv, 2)))

            def fa():
                return flash_attention(q, k, v, window=win, softcap=cap)

            pos = torch.arange(s, device=dev)
            mask = None if win is None else \
                (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)

            # SDPA has no softcap: with one it computes another function and
            # is timed as the yardstick only, under its own key
            def sdpa_fn():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=mask is None,
                                                      attn_mask=mask)

            ms = cuda_ms(fa, flush=flush)
            plain = cuda_ms(lambda: attention_ref(q, k, v, window=win, softcap=cap), flush=flush)
            sdpa = cuda_ms(sdpa_fn, flush=flush)
            # also with the card spun before each start event, so that neither
            # time holds any of the host's enqueue (the wrapper's checks and
            # tensor-map encodes, or SDPA's dispatch)
            dev_ms, sdpa_dev = (cuda_ms(fn, flush=flush, spin=True) for fn in (fa, sdpa_fn))
            pairs = sum(min(i + 1, win or s) for i in range(s))   # visible (q, k) pairs
            ops = 4.0 * hq * d * pairs
            b_ms, b_by = bound(nbytes(q, k, v, q), ops, BF16_FLOPS)
            print(f"[kernels] flash_attention {arch} path {shape}: err {e:.3g} kernel "
                  f"{ms:.4f} ms (spun {dev_ms:.4f}), plain {plain:.4f} ms, "
                  f"sdpa{' without the softcap' if cap else ''} {sdpa:.4f} ms (spun "
                  f"{sdpa_dev:.4f}), bound {b_ms:.4f} ms ({b_by})")
            rows[("flash_attention", arch, s)] = dict(
                max_abs_err=e, ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None if cap else sdpa, shape=shape,
                **({"sdpa_without_softcap_ms": sdpa, "sdpa_without_softcap_device_ms": sdpa_dev}
                   if cap else {"library_device_ms": sdpa_dev}))
    # what the softcap costs K1 at S=4,608 (B=1, 16 q / 8 kv heads, causal):
    # hd 128 caps through tanhf of a quotient, hd 256 through cap_scores
    for d in (128, 256):
        q = randn((1, 4608, 16, d), torch.bfloat16)
        k, v = randn((1, 4608, 8, d), torch.bfloat16), randn((1, 4608, 8, d), torch.bfloat16)
        capped, plain_cap = (cuda_ms(lambda c=c: flash_attention(q, k, v, softcap=c), flush=flush,
                                     spin=True) for c in (50.0, None))
        print(f"[kernels] flash_attention softcap cost B=1 S=4608 Hq=16 Hkv=8 hd={d} bf16: "
              f"softcap 50 {capped:.4f} ms, none {plain_cap:.4f} ms (spun)")
    rows.update(check_decode(torch, dev, randn, err, flush))
    rows.update(check_decode(torch, dev, randn, err, flush, hq=32, hkv=2, fills=GLM4_FILLS,
                             label="glm4-9b"))
    for arch, hq, hkv, d, win, cap in ZOO_DEC_CASES:
        rows.update(check_decode(torch, dev, randn, err, flush, hq=hq, hkv=hkv, fills=(),
                                 label=arch, d=d, window=win, softcap=cap))
    rows.update(check_ssd(torch, dev, gen, randn, err, flush))
    rows.update(check_quant(torch, randn, flush))
    del flush
    return rows


def one_split_decode(q, k_cache, v_cache, cache_len, window=None, softcap=None):
    """K2 in its one-split schedule: the same kernel with split_rows = S,
    so a block per (b, kv head), the grid it had before its split, behind
    the wrapper's checks, through the C entry. Timed beside
    ``decode_attention_kernel``; it counts no launch of the path."""
    from repro_torch.kernels import refuse_grad
    from repro_torch.kernels.decode_attention.ops import _check, _row_lengths, launch

    _check(q, k_cache, v_cache, window, softcap)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    clen = _row_lengths(cache_len, q.shape[0], q.device)
    return launch(q, k_cache, v_cache, clen, k_cache.shape[1], window, softcap)


def check_decode(torch, dev, randn, err, flush, hq=16, hkv=8, fills=DEC_FILLS, label="",
                 d=128, window=None, softcap=None):
    """K2 at a decode shape of the serve path (4 slots, max_len 1024, hd
    ``d``; internlm2-1.8b's 16 q / 8 kv heads, or ``label``'s, with its
    window and softcap: SDPA, without a softcap, is then timed as the
    yardstick only and ``library_ms`` is None), at the serve
    path's lengths (DEC_PATH_LENS) and at each uniform fill of ``fills``:
    against the plain version, and timed beside its one-split schedule
    (``one_split_decode``), the plain version and SDPA: ``ms`` as for every
    kernel, ``device_ms`` with the card spun before each start event (no
    gap the host leaves is timed), both schedules in turns over seven
    rounds; the host time per call and the device time of its one launch
    (the split pass with the merge folded in). One row per setting, keyed
    ``label path`` and ``label fill n`` for another arch's shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_kernel, split_rows
    from repro_torch.kernels.decode_attention.ref import decode_attention

    b, s = 4, 1024
    rows_per_split = split_rows(b, s, hkv, d)
    q = randn((b, 1, hq, d), torch.bfloat16)
    kc, vc = randn((b, s, hkv, d), torch.float32), randn((b, s, hkv, d), torch.float32)
    qf = q.float().transpose(1, 2).contiguous()                       # exact upcast
    ke, ve = (x.repeat_interleave(hq // hkv, 2).transpose(1, 2).contiguous() for x in (kc, vc))
    rows = {}
    for key, lens in [(f"{label} path".strip(), DEC_PATH_LENS)] + [
            (f"{label} fill {n}" if label else n, (n,) * b) for n in fills]:
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        ref = decode_attention(q, kc, vc, lens, window=window, softcap=softcap)
        e = err(decode_attention_kernel(q, kc, vc, lens, window=window, softcap=softcap), ref)
        e_one = err(one_split_decode(q, kc, vc, lens, window, softcap), ref)
        if not max(e, e_one) < TOL["float32"]:
            raise AssertionError(f"decode_attention at lengths {lens.tolist()} disagrees: "
                                 f"split {e}, one split {e_one}")
        new, old = (lambda: decode_attention_kernel(q, kc, vc, lens, window=window,
                                                    softcap=softcap)), \
            (lambda: one_split_decode(q, kc, vc, lens, window, softcap))
        # both schedules in turns, seven rounds of 30 launches, each time
        # the median over the rounds: a stall of the shared host shifts a
        # whole round, and the two differ by a few tenths of a us at low fills
        times = [[] for _ in range(4)]
        for r in range(7):
            order = (0, 1, 2, 3) if r % 2 == 0 else (1, 0, 3, 2)
            for i in order:
                times[i].append(cuda_ms((new, old)[i % 2], iters=30, flush=flush,
                                        spin=i >= 2))
        ms, one, dev_ms, one_dev = (float(np.median(t)) for t in times)
        plain = cuda_ms(lambda: decode_attention(q, kc, vc, lens, window=window,
                                                 softcap=softcap), flush=flush)
        pos = torch.arange(s, device=dev)[None, :]
        mask = (pos < lens[:, None]) & (pos >= lens[:, None] - (window or s))
        mask = mask[:, None, None, :]
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qf, ke, ve, attn_mask=mask),
                      flush=flush)
        host, one_host = host_us_per_call([new, old])
        passes = kernel_us(torch, new)
        if len(passes) != 1:
            raise AssertionError(f"decode_attention launched {sorted(passes)}, not one kernel")
        (kname, launch_us), = passes.items()
        rows_read = int(lens.clamp(max=window or s).sum().item())   # rows this run needs
        kv_bytes = 2 * rows_read * hkv * d * 4
        ops = 4.0 * rows_read * hq * d
        b_ms, b_by = bound(nbytes(q, lens) + kv_bytes + b * hq * d * 4, ops, F32_FLOPS)
        heads = f" Hq={hq} Hkv={hkv} hd={d} window={window} softcap={softcap}" if label else ""
        print(f"[kernels] decode_attention {key if isinstance(key, str) else 'fill'} B={b} "
              f"max_len={s} lens={lens.tolist()}{heads} "
              f"f32 cache: err {e:.3g} (one split "
              f"{e_one:.3g}) kernel {ms:.4f} ms ({dev_ms:.4f} spun; split_rows "
              f"{rows_per_split}; one launch, {kname} {launch_us} us), one split {one:.4f} ms ({one_dev:.4f} "
              f"spun), host {host:.2f} against {one_host:.2f} us a call, plain {plain:.4f} ms, "
              f"sdpa{' without the softcap' if softcap else ''} {lib:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; {kv_bytes / 1e6:.2f} MB of cache rows)")
        rows[("decode_attention", key)] = dict(
            max_abs_err=e, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=None if softcap else lib,
            **({"sdpa_without_softcap_ms": lib} if softcap else {}),
            device_ms=dev_ms, split_rows=rows_per_split, one_split_ms=one,
            one_split_device_ms=one_dev, host_us=host, one_split_host_us=one_host,
            launch_us=launch_us, kernel=kname,
            shape=f"B={b} max_len={s} lens={lens.tolist()} Hq={hq} Hkv={hkv} hd={d} "
                  f"window={window} softcap={softcap} f32 cache, bf16 q")
    return rows


def cuda_core_ssd_scan(x, dt, A, Bm, C):
    """K3 as the serve path ran it before its tensor-core kernels: the
    wrapper of that time (the same checks, outputs and one launch) around
    the CUDA-core kernel, which the tensor-core path replaced on bf16
    inputs, through its own C entry. Timed beside ``ssd_scan``; it counts
    no launch of the path."""
    import torch
    from repro_torch.kernels import _build, refuse_grad
    from repro_torch.kernels.ssd_scan.ops import DTYPES, _check

    _check(x, dt, A, Bm, C)
    refuse_grad("ssd_scan", x, dt, A, Bm, C)
    b, s, h, p = x.shape
    n = Bm.shape[2]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    hout = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if hout.numel() == 0:
        return y, hout
    lib = _build.library("ssd_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_cuda_core_forward(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                             Bm.data_ptr(), C.data_ptr(), y.data_ptr(),
                                             hout.data_ptr(), DTYPES[x.dtype], b, s, h, p, n,
                                             stream)
    _build.check(err, "ssd_scan CUDA-core launch")
    return y, hout


def kernel_us(torch, fn, calls: int = 5):
    """Device microseconds of each of the port's kernels per call of
    ``fn``, from a ``torch.profiler`` pass over ``calls`` calls (a pass
    that records no kernel, as one in eight did, is taken again, at most
    twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            name = re.search(r"repro::\(anonymous namespace\)::(\w+)", e.key)
            if e.device_type != DeviceType.CPU and name:
                out[name.group(1)] = round(e.self_device_time_total / calls, 2)
        if out:
            break
    return out


def check_ssd(torch, dev, gen, randn, err, flush):
    """K3 against its plain versions: the f32 SSD_CASES and ragged
    lengths (the CUDA-core kernel), the bf16 tensor-core path's
    SSD_TC_CASES; at mamba2-2.7b's prefill shape at every length of
    SSD_PATH_LENS, timed beside ``cuda_core_ssd_scan`` on the same inputs
    (its "earlier" time: the path's kernel and wrapper before the
    tensor-core kernels) and the plain chunked scan: device time with and
    without the spin (``cuda_ms``), host time per call, and each launch's
    device time. One row per length."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, tensor_core_path
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_sequential_ref

    def inputs(b, s, h, p, n, dtype):
        x = randn((b, s, h, p), dtype)
        dt = F.softplus(randn((b, s, h), torch.float32))
        a = -torch.exp(randn((h,), torch.float32))
        return x, dt, a, randn((b, s, n), dtype), randn((b, s, n), dtype)

    def mamba2_inputs(b, s, h, p, n):
        """bf16 x/B/C and f32 dt/A distributed as the model makes them"""
        x = F.silu(randn((b, s, h, p), torch.float32)).to(torch.bfloat16)
        dt = F.softplus(randn((b, s, h), torch.float32) - 4.0)
        a = -(1.0 + 15.0 * torch.rand((h,), generator=gen, device=dev))
        bm, cm = (F.silu(randn((b, s, n), torch.float32)).to(torch.bfloat16) for _ in range(2))
        return x, dt, a, bm, cm

    for b, s, h, p, n, chunk in [c[:6] for c in SSD_CASES] + SSD_RAGGED:
        x, dt, a, bm, cm = inputs(b, s, h, p, n, torch.float32)
        if tensor_core_path(x, bm):
            raise AssertionError(f"ssd_scan float32 B={b} S={s} takes the tensor-core path")
        y, hf = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        yr, hr = ssd_sequential_ref(x, dt, a, bm, cm)
        ey, eh = err(y, yr), err(hf, hr)
        print(f"[kernels] ssd_scan float32 B={b} S={s} H={h} P={p} N={n} chunk={chunk}: "
              f"max abs err y {ey:.3g}, h {eh:.3g} (tol {SSD_TOL}) against ssd_ref")
        if not max(ey, eh) < SSD_TOL:
            raise AssertionError(f"ssd_scan disagrees at S={s}: y {ey}, h {eh}")
    for b, s, h, p, n in SSD_TC_CASES:
        x, dt, a, bm, cm = mamba2_inputs(b, s, h, p, n)
        if not tensor_core_path(x, bm):
            raise AssertionError(f"ssd_scan B={b} S={s} H={h} P={p} N={n} bf16 does not "
                                 "take the tensor-core path")
        y, hf = ssd_scan(x, dt, a, bm, cm, chunk=256)
        yr, hr = ssd_sequential_ref(x.float(), dt, a, bm.float(), cm.float())
        errs = [(err(o, r), err(o, r) / r.abs().max().item()) for o, r in ((y, yr), (hf, hr))]
        print(f"[kernels] ssd_scan tensor cores bf16 B={b} S={s} H={h} P={p} N={n}: max abs "
              f"err y {errs[0][0]:.3g} (rel {errs[0][1]:.3g}), h {errs[1][0]:.3g} (rel "
              f"{errs[1][1]:.3g}) against ssd_ref (tol {SSD_TOL} abs, "
              f"{SSM_LAYER_TOL['y']} rel)")
        if not all(e < SSD_TOL and r < SSM_LAYER_TOL["y"] for e, r in errs):
            raise AssertionError(f"ssd_scan's tensor-core path disagrees at B={b} S={s} "
                                 f"H={h} P={p} N={n}: {errs}")

    rows = {}
    h, p, n, chunk = 80, 64, 128, 256
    for s in SSD_PATH_LENS:
        x, dt, a, bm, cm = args = mamba2_inputs(1, s, h, p, n)
        y, hf = ssd_scan(*args, chunk=chunk)
        yr, hr = ssd_chunked_ref(x.float(), dt, a, bm, cm, chunk=chunk)
        e = max(err(y, yr), err(hf, hr))
        ye, he = cuda_core_ssd_scan(*args)
        e_cc = max(err(ye, yr), err(he, hr))
        if not max(e, e_cc) < SSD_TOL:
            raise AssertionError(f"ssd_scan at the path shape S={s} disagrees: tensor cores "
                                 f"{e}, CUDA cores {e_cc}")
        new, old = (lambda: ssd_scan(*args, chunk=chunk)), (lambda: cuda_core_ssd_scan(*args))
        ms, earlier = cuda_ms(new, flush=flush), cuda_ms(old, flush=flush)
        dev_ms = cuda_ms(new, flush=flush, spin=True)
        earlier_dev = cuda_ms(old, flush=flush, spin=True)
        plain = cuda_ms(lambda: ssd_chunked_ref(x.float(), dt, a, bm, cm, chunk=chunk),
                        flush=flush)
        host, earlier_host = host_us_per_call([new, old])
        passes = kernel_us(torch, new)
        # the least work the function needs: per token and head, the
        # recurrence's state update and its read into y, one FMA per state
        # element each (4PN flops); a chunked scan does the same per token and
        # adds its intra-chunk products, at any chunk length
        ops = 4.0 * s * h * p * n
        moved = nbytes(x, dt, a, bm, cm, y, hf)
        b_ms, b_by = bound(moved, ops, BF16_FLOPS)
        f32_ms = bound(moved, ops, F32_FLOPS)[0]
        print(f"[kernels] ssd_scan path B=1 S={s} H={h} P={p} N={n} chunk={chunk} bf16 x/B/C: "
              f"err {e:.3g} (max |y| {yr.abs().max().item():.3g}; CUDA cores {e_cc:.3g}) "
              f"kernel {ms:.4f} ms ({dev_ms:.4f} spun; launches {passes} us), CUDA-core "
              f"kernel {earlier:.4f} ms ({earlier_dev:.4f} spun), host {host:.2f} against "
              f"{earlier_host:.2f} us a call, plain {plain:.4f} ms, library none, bound "
              f"{b_ms:.4f} ms ({b_by}; {moved / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP as 4PN "
              f"per token and head; {f32_ms:.4f} ms at the CUDA cores' "
              f"{F32_FLOPS / 1e12:.0f} TFLOP/s)")
        rows[("ssd_scan", s)] = dict(max_abs_err=e, ms=ms, plain_ms=plain, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None, device_ms=dev_ms,
                                     launch_us=passes, host_us=host, earlier_ms=earlier,
                                     earlier_device_ms=earlier_dev, earlier_host_us=earlier_host,
                                     cuda_core_bound_ms=f32_ms)
    return rows


def check_quant(torch, randn, flush):
    """K4a / K4b against their plain versions: q, the scales and the
    dequantized values bit-equal, the f32 round trip within half a step
    of x per block (plus 2^-22 |x| for its two f32 roundings); timed at
    the path shape."""
    from repro_torch.kernels.quant.ops import dequantize, quantize
    from repro_torch.kernels.quant.ref import dequantize_flat_ref, quantize_flat_ref

    def same(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.view(torch.int16 if a.dtype == torch.bfloat16 else a.dtype),
            b.view(torch.int16 if b.dtype == torch.bfloat16 else b.dtype))

    def check(x, what):
        n = x.numel()
        q, s = quantize(x)
        qr, sr = quantize_flat_ref(x)
        if not (same(q, qr) and torch.equal(s.view(torch.int32), sr.view(torch.int32))):
            raise AssertionError(f"quantize {what}: q differs in {(q != qr).sum().item()}, "
                                 f"scale in {(s != sr).sum().item()} places")
        worst = 0.0
        for dt in (torch.float32, torch.bfloat16):
            d = dequantize(q, s, (n,), dt)
            if not same(d, dequantize_flat_ref(q, s, (n,), dt)):
                raise AssertionError(f"dequantize {what} to {dt} differs from the plain version")
            if dt == torch.float32:
                step = s.repeat_interleave(256)[:n]
                xf = x.float()
                excess = ((d - xf).abs() - 0.5 * step - 2.0 ** -22 * xf.abs()).max().item()
                worst = max(worst, excess)
                if excess > 0:
                    raise AssertionError(f"round trip {what} exceeds half a step by {excess}")
        print(f"[kernels] quant {what}: q, scales and dequantized f32/bf16 bit-equal to the "
              f"plain versions; round trip within half a step (largest excess {worst:.3g})")

    for n in QUANT_SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            check(randn((n,), dtype), f"n={n} {dtype}")
    x = randn((QUANT_PATH_N,), torch.float32)
    check(x, f"path n={QUANT_PATH_N} f32 (w_in)")
    q, s = quantize(x)
    rows = {}
    ms = cuda_ms(lambda: quantize(x), flush=flush)
    plain = cuda_ms(lambda: quantize_flat_ref(x), flush=flush)
    b_ms, b_by = bound(nbytes(x, q, s), 2.0 * x.numel(), F32_FLOPS)
    print(f"[kernels] quantize path n={QUANT_PATH_N} f32: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library none, bound {b_ms:.4f} ms ({b_by}; "
          f"{nbytes(x, q, s) / 1e9:.3f} GB)")
    rows["quantize"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None)
    del x
    d = dequantize(q, s, (QUANT_PATH_N,))
    ms = cuda_ms(lambda: dequantize(q, s, (QUANT_PATH_N,)), flush=flush)
    plain = cuda_ms(lambda: dequantize_flat_ref(q, s, (QUANT_PATH_N,)), flush=flush)
    lib = cuda_ms(lambda: torch.mul(q, s[:, None]), flush=flush)
    b_ms, b_by = bound(nbytes(q, s, d), 1.0 * d.numel(), F32_FLOPS)
    print(f"[kernels] dequantize path n={QUANT_PATH_N} to f32: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, torch.mul {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{nbytes(q, s, d) / 1e9:.3f} GB)")
    rows["dequantize"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib)
    return rows


class _Probe:
    """Mixed into an engine. While ``checking``, every logit row's
    finiteness is folded into one device flag. Otherwise it only reads
    the host clock, adding no device work and no sync: prefill per
    bucket (``_prefill_request`` ends in ``int(token)``, a host sync) and
    decode per step, the time inside ``_decode_compute`` plus the time
    inside ``_finish_decode`` (whose ``.cpu()`` is the step's host sync;
    the staged engine runs other stages between the two)."""

    checking = False

    def _probe_reset(self, torch):
        self._torch = torch
        self.finite = torch.ones((), dtype=torch.bool, device=self.device)
        self.prefill_ms, self.decode_ms = {}, []

    def _sample(self, logits, temperature):
        if self.checking:
            self.finite &= self._torch.isfinite(logits).all()
        return super()._sample(logits, temperature)

    def _prefill_request(self, req):
        t0 = time.perf_counter()
        out = super()._prefill_request(req)
        bucket = self._bucket_len(len(req.prompt))
        self.prefill_ms.setdefault(bucket, []).append((time.perf_counter() - t0) * 1e3)
        return out

    def _decode_compute(self, act):
        t0 = time.perf_counter()
        logits = super()._decode_compute(act)
        if self.checking:
            self.finite &= self._torch.isfinite(logits).all()
        self._decode_host_ms = (time.perf_counter() - t0) * 1e3
        return logits

    def _finish_decode(self, act, logits):
        t0 = time.perf_counter()
        retired = super()._finish_decode(act, logits)
        self.decode_ms.append(self._decode_host_ms + (time.perf_counter() - t0) * 1e3)
        return retired


def launch_counters():
    """Each kernel wrapper by name; ``.launches`` is its launch count."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.quant.ops import dequantize, quantize
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention_kernel, "ssd_scan": ssd_scan,
            "quantize": quantize, "dequantize": dequantize}


def phase_serve(torch, dev, arch, path_kernels):
    """Serve 8 requests of full-width ``arch``; every kernel named in
    ``path_kernels`` must launch in the timed pass. Returns the timed
    pass's launch counts and what the staged phase compares with: the
    engine's bf16 weights, the prompts, the timed pass's tokens and its
    host figures."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params, layer_period, num_groups, slot_kind
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)

    class Engine(_Probe, ServeEngine):
        pass

    eng = Engine(cfg, params, slots=4, max_len=1024, device=dev)
    del params                                   # the engine keeps its bf16 copy
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f}B params, set up in "
          f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(0)
    lens = [8, 512] + rng.integers(9, 512, 6).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]

    def submit_all():
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        return reqs

    # a checked pass: every logit row finite (it also warms the engine up)
    eng._probe_reset(torch)
    eng.checking = True
    checked = submit_all()
    eng.run()
    eng.checking = False
    if not bool(eng.finite):
        raise AssertionError(f"non-finite logits in the {arch} serve run")
    # the timed pass: the same requests again, the counts set to 0 just
    # before it and read just after
    eng._probe_reset(torch)
    reqs = submit_all()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps0 = eng.stats["decode_steps"]
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    toks = sum(len(r.out_tokens) for r in reqs)
    print(f"[serve] {arch}: prompt lengths {lens}, prefill lengths (buckets) "
          f"{sorted(eng.prefill_ms)}")
    print(f"[serve] {arch}: {len(reqs)} requests, {toks} tokens in {wall:.3f} s = "
          f"{toks / wall:.2f} tok/s; decode_steps {eng.stats['decode_steps'] - steps0}, "
          f"prefill_compilations {eng.stats['prefill_compilations']}; "
          f"peak memory {peak / 2 ** 30:.3f} GiB")
    print(f"[serve] {arch}: prefill ms per length (bucket): " + ", ".join(
        f"{b}: {np.mean(v):.2f} (n={len(v)})" for b, v in sorted(eng.prefill_ms.items())))
    d = np.asarray(eng.decode_ms)
    print(f"[serve] {arch}: decode ms per step: median {np.median(d):.2f}, "
          f"mean {d.mean():.2f}, first {d[0]:.2f}, n={len(d)}")
    print(f"[serve] {arch}: kernel launches on the main path: {launches}; the checked "
          f"pass's logits all finite, its tokens the timed pass's: "
          f"{[r.out_tokens for r in checked] == [r.out_tokens for r in reqs]}")
    if not all(r.done and len(r.out_tokens) == 16 for r in checked + reqs):
        raise AssertionError("not every request finished with 16 tokens")
    for name in path_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched on the {arch} path")
    # one launch per layer of its kind per request (prefill) or step (decode)
    kinds = [slot_kind(cfg, i)["kind"] for i in range(layer_period(cfg))] * num_groups(cfg)
    n_attn, n_ssm = kinds.count("attn"), len(kinds) - kinds.count("attn")
    expect = {"flash_attention": n_attn * len(reqs),
              "decode_attention": n_attn * (eng.stats["decode_steps"] - steps0),
              "ssd_scan": n_ssm * len(reqs), "quantize": 0, "dequantize": 0}
    if launches != expect:
        raise AssertionError(f"{arch} launches {launches}, not one per layer and "
                             f"request or decode step: {expect}")

    # kernels vs plain versions on the whole model: the first request's
    # prefill logits and three teacher-forced decode steps, same weights
    r0 = reqs[0]
    rel, same_top, _ = kernels_vs_plain(torch, dev, cfg, eng.params, r0.prompt,
                                        r0.out_tokens[:3], eng.max_len,
                                        bucket=eng._bucket_len(len(r0.prompt)))
    print(f"[serve] {arch}: kernels vs plain, request 0 (prompt {len(r0.prompt)}): rel "
          f"err of prefill + 3 decode logits {[f'{x:.3g}' for x in rel]} "
          f"(tol {MODEL_REL_TOL}), same argmax {same_top}")
    if not max(rel) < MODEL_REL_TOL:
        raise AssertionError(f"{arch} model logits with kernels disagree: {rel}")
    if n_ssm:
        check_ssm_layers(torch, dev, cfg, eng.params,
                         max((p for p in prompts if len(p) % cfg.ssm_chunk), key=len))
        bf16_floor(torch, dev, cfg, eng.params,
                   min((p for p in prompts if len(p) > len(r0.prompt)), key=len))
    sync = dict(params=eng.params, prompts=prompts,
                tokens=[list(r.out_tokens) for r in reqs], wall=wall, tok_s=toks / wall,
                decode_ms=float(np.median(d)))
    return launches, sync


class PinnedRouting:
    """The MoE router's top-k choices of one run, recorded and then
    compared with or replayed in another run of the same calls
    (``repro_torch.models.moe.router_topk`` wrapped while the context is
    open). ``mode``: "record" keeps each call's expert indices; "compare"
    counts the routed tokens whose top-k set differs from the record's;
    "replay" routes every token to the recorded experts, its weights
    renormalized from its own router probabilities over them. ``calls``
    may also be set from another framework's run (a list of (T,k) index
    tensors, one per call, in call order)."""

    def __init__(self):
        import torch
        from repro_torch.models import moe
        self.torch, self.moe, self.router_topk = torch, moe, moe.router_topk
        self.calls, self.mode, self.at, self.flips, self.routed = [], None, 0, 0, 0

    def __enter__(self):
        self.moe.router_topk = self._router
        return self

    def __exit__(self, *exc):
        self.moe.router_topk = self.router_topk

    def start(self, mode):
        self.mode, self.at = mode, 0

    def _router(self, x2d, w_router, k):
        weights, idx, probs = self.router_topk(x2d, w_router, k)
        if self.mode == "record":
            self.calls.append(idx)
            return weights, idx, probs
        ref = self.calls[self.at].to(idx.device)
        self.at += 1
        if self.mode == "compare":
            self.routed += idx.shape[0]
            self.flips += int((idx.sort(-1).values != ref.sort(-1).values).any(-1).sum())
            return weights, idx, probs
        kept = probs.gather(1, ref)
        return kept / self.torch.clamp(kept.sum(-1, keepdim=True), min=1e-9), ref, probs


def kernels_vs_plain(torch, dev, cfg, params, prompt, forced, max_len, *, bucket=None,
                     frontend=None):
    """Kernels against plain versions on the whole model, same weights:
    the prefill logits of ``prompt`` (right-padded to ``bucket`` with
    ``length=``, or after the ``frontend`` embeddings (F, D)) and one
    teacher-forced decode step for each token of ``forced`` (an int is
    fed to every codebook, as the engine feeds a prefill's token). Returns
    the relative error of each step's logits (largest difference over the
    plain path's largest magnitude), whether each step's argmax agrees
    (every codebook's), and for an MoE config what its router did: a
    router picks each token's top-k experts, a discrete choice that a
    bf16 step in its input flips where two experts' probabilities nearly
    tie, and a flipped token's FFN output changes by its whole size. So
    for MoE the errors returned are the kernels' with every token routed
    to the plain run's experts (``PinnedRouting``), and the dict holds
    the unpinned errors and the number of routed tokens (of the prefill,
    pad included, and each decode step) whose top-k set differs."""
    from repro_torch.models import model as M

    cb = cfg.num_codebooks
    toks = np.asarray(prompt)
    n = toks.shape[0]
    if bucket and bucket > n:
        toks = np.concatenate([toks, np.zeros((bucket - n,) + toks.shape[1:], toks.dtype)])
    toks = torch.as_tensor(toks, device=dev)[None]
    fe = None if frontend is None else torch.as_tensor(frontend, device=dev)[None]

    def run(impl):
        out, cache, npos = M.prefill(cfg, params, toks, max_len, frontend_embeds=fe, impl=impl,
                                     cache_dtype=torch.float32,
                                     length=n if fe is None else None)
        steps = [out[:, -1]]
        for i, t in enumerate(forced):
            shape = (1, 1, cb) if cb > 1 else (1, 1)
            tok = torch.as_tensor(np.array(np.broadcast_to(t, shape[2:])).reshape(shape),
                                  device=dev)
            pos = torch.tensor([npos + i], dtype=torch.int32, device=dev)
            out, cache = M.decode_step(cfg, params, tok, cache, pos, impl=impl)
            steps.append(out[:, 0])
        return torch.cat(steps).view(len(steps), -1, out.shape[-1])   # (steps, C, V)

    def rel(auto, ref):
        return ((auto - ref).abs().amax((1, 2)) / ref.abs().amax((1, 2))).tolist()

    with PinnedRouting() as routing:
        routing.start("record")
        ref = run("ref")
        routing.start("compare")
        auto = run("auto")
        routing.start("replay")
        pinned = run("auto") if cfg.num_experts else auto
    same_top = (pinned.argmax(-1) == ref.argmax(-1)).all(-1).tolist()
    moe = (dict(unpinned=rel(auto, ref), flips=routing.flips, routed=routing.routed)
           if cfg.num_experts else None)
    return rel(pinned, ref), same_top, moe


def check_ssm_layers(torch, dev, cfg, params, prompt):
    """K3 where it does real work inside the model: along the plain
    path's hidden stream of one ragged prompt, at every layer, K3's f32 y
    and final state against ``ssd_chunked``'s on that layer's own scan
    inputs, and the layer's mixer output with the kernel against the
    plain version (both round y to bf16), each relative to the plain
    result's largest magnitude. Then the whole model's prefill logits,
    kernels against plain, are read but held to no limit: over 64 layers
    they carry the model's bf16 noise, not the kernel's error."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    from repro_torch.models import model as M
    from repro_torch.models.layers import rmsnorm

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    toks = torch.as_tensor(prompt, device=dev)[None]
    x = M.embed_tokens(cfg, params, toks)
    positions = torch.arange(x.shape[1], device=dev)
    worst = dict.fromkeys(SSM_LAYER_TOL, 0.0)
    for slot, _, p in M._layers(cfg, params):
        hn = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps)
        x_in, z, b_in, c_in, dt_raw, A = M._ssm_inputs(cfg, p["ssm"], hn)
        xh, dt, bm, cm, _ = M._ssm_scan_inputs(cfg, p["ssm"], x_in, b_in, c_in, dt_raw)
        y, hf = ssd_scan(xh, dt, A, bm, cm, chunk=cfg.ssm_chunk)
        yr, hr = ssd_chunked_ref(xh.float(), dt, A, bm, cm, chunk=cfg.ssm_chunk)
        mix = [M._ssm_mixer(cfg, p["ssm"], hn, impl=impl) for impl in ("auto", "ref")]
        for key, e in (("y", rel(y, yr)), ("state", rel(hf, hr)), ("mixer", rel(*mix))):
            worst[key] = max(worst[key], e)
        x, _ = M.apply_layer(cfg, slot, p, x, positions=positions, impl="ref")
    print(f"[serve] {cfg.name}: K3 in each of {cfg.num_layers} layers, prompt "
          f"{len(prompt)}, kernel vs plain on the layer's inputs, largest rel err: " +
          ", ".join(f"{k} {v:.3g} (tol {SSM_LAYER_TOL[k]})" for k, v in worst.items()))
    if not all(worst[k] < SSM_LAYER_TOL[k] for k in worst):
        raise AssertionError(f"{cfg.name}: K3 inside the model disagrees: {worst}")
    logits = [M.prefill(cfg, params, toks, toks.shape[1], impl=impl,
                        cache_dtype=torch.float32)[0][0, 0] for impl in ("auto", "ref")]
    print(f"[serve] {cfg.name}: kernels vs plain, prefill logits of the same prompt: "
          f"rel err {rel(*logits):.3g} (the model's bf16 noise at {cfg.num_layers} "
          f"layers; no limit)")


def bf16_floor(torch, dev, cfg, params, prompt):
    """The model's own bf16 noise at one prompt: the plain path's prefill
    logits on the card against the same path on the CPU, with the same
    weights (the engine's copy moved to the host), printed beside kernels
    against plain on the card. Held to no limit: it reads the floor under
    the kernels-vs-plain gap, which MODEL_REL_TOL holds at request 0."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_map

    def rel(a, b):
        return ((a.float().cpu() - b.float().cpu()).abs().max() / b.float().abs().max()).item()

    toks = torch.as_tensor(prompt, device=dev)[None]
    card = {impl: M.prefill(cfg, params, toks, toks.shape[1], impl=impl,
                            cache_dtype=torch.float32)[0][0, 0] for impl in ("auto", "ref")}
    t0 = time.perf_counter()
    host = tree_map(lambda t: t.cpu(), params)
    cpu = M.prefill(cfg, host, toks.cpu(), toks.shape[1], impl="ref",
                    cache_dtype=torch.float32)[0][0, 0]
    del host
    print(f"[serve] {cfg.name}: prompt {len(prompt)}: prefill logits, plain on the card vs "
          f"plain on the CPU: rel err {rel(card['ref'], cpu):.3g}; kernels vs plain on the "
          f"card {rel(card['auto'], card['ref']):.3g} (the model's bf16 noise floor; no "
          f"limit; the CPU pass {time.perf_counter() - t0:.1f} s)")


def _timeline(reqs):
    """What simulated time decides, per request."""
    return [(r.rid, r.first_token_time, r.finish_time, r.placement, len(r.out_tokens))
            for r in reqs]


def phase_staged(torch, dev, sync):
    """Full-width internlm2-1.8b on the §5.2 KV fabric (``kv_fabric()``)
    through the port's sync and staged engines, from ``phase_serve``'s
    bf16 weights (``compute_copy`` keeps bf16 leaves as they are, so no
    second copy exists) and its eight prompts: a burst at t = 0, arrivals
    STAGED_SPACING simulated s apart, and the staged engine's decode
    replica pool on kv_fabric() merged with two spare SoC read paths,
    scaled out while decoding and in with a shard in flight. Each run's
    tokens must be the timed ServeEngine pass's, K1 must launch once per
    layer and request and K2 once per layer and decode step (counts set
    to 0 just before each run), and each staged run's per-request
    simulated timeline must equal that of the ``compute="sim"`` engine on
    the same requests and fabric. Returns the staged runs' launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.fabric import OPS_PER_S, Fabric, Path, merge_fabrics
    from repro_torch.core.runtime import FabricRuntime
    from repro_torch.serve.disagg import PathCosts, kv_fabric, kv_serve_time_model
    from repro_torch.serve.engine import Request, ServeEngine, StagedServeEngine

    class Sync(_Probe, ServeEngine):
        pass

    class Staged(_Probe, StagedServeEngine):
        pass

    cfg = get_config("internlm2-1.8b")
    n_layers = cfg.num_layers
    spare = Fabric.of(*(Path(f"spare_read:{i}", PathCosts().read_soc_rate, OPS_PER_S,
                             latency=1e-6, kind="rdma") for i in range(2)))
    # the pool serves the SoC-cache reads; host-placed reads keep host_read
    pool_tm = dataclasses.replace(kv_serve_time_model(), decode_path="soc_read",
                                  placement_paths={"host": "host_read"})
    kw = dict(slots=4, max_len=1024)
    counters = launch_counters()
    staged_launches = {"flash_attention": 0, "decode_attention": 0}

    def requests(spacing):
        return [Request(rid=i, prompt=p, max_new_tokens=16, arrival=i * spacing)
                for i, p in enumerate(sync["prompts"])]

    def pool_events(eng, seen):
        rt = eng.runtime
        rt.clock.at(POOL_SCALE_OUT_T, lambda: (
            seen.update(active=sum(a is not None for a in eng.active)),
            eng.add_decode_replica("spare_read:0")))
        rt.clock.at(POOL_SCALE_IN_T, lambda: (
            seen.update(inflight=len(eng._extras()[-1].inflight)),
            eng.retire_decode_replica()))

    def build(kind, compute, spacing):
        """(engine, requests, pool-event record) of one run, submitted."""
        dev_kw = dict(device=dev) if compute == "torch" else {}
        args = (cfg, sync["params"]) if compute == "torch" else (None, None)
        seen = {}
        if kind == "sync":
            eng = Sync(*args, fabric=kv_fabric(), runtime=FabricRuntime(kv_fabric()),
                       time_model=kv_serve_time_model(), **dev_kw, **kw)
        elif kind == "staged":
            cls = Staged if compute == "torch" else StagedServeEngine
            eng = cls(*args, compute=compute, fabric=kv_fabric(),
                      time_model=kv_serve_time_model(), plan_placement=True, **dev_kw, **kw)
        else:
            cls = Staged if compute == "torch" else StagedServeEngine
            eng = cls(*args, compute=compute,
                      runtime=FabricRuntime(merge_fabrics(kv_fabric(), spare)),
                      time_model=pool_tm, plan_placement=True, decode_pool=True,
                      **dev_kw, **kw)
            pool_events(eng, seen)
        reqs = requests(spacing)
        for r in reqs:
            eng.submit(r)
        return eng, reqs, seen

    runs = [("sync", "burst", 0.0), ("staged", "burst", 0.0),
            ("sync", "spaced", STAGED_SPACING), ("staged", "spaced", STAGED_SPACING),
            ("pool", "burst", 0.0)]
    figures = {}
    for kind, label, spacing in runs:
        name = f"{kind} {label}"
        eng, reqs, seen = build(kind, "torch", spacing)
        eng._probe_reset(torch)
        torch.cuda.synchronize()
        steps0 = eng.stats["decode_steps"]
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: counters[n].launches for n in ("flash_attention", "decode_attention")}
        steps = eng.stats["decode_steps"] - steps0
        toks = sum(len(r.out_tokens) for r in reqs)
        ttft = [r.ttft for r in reqs]
        p50, p99 = np.percentile(ttft, [50, 99])
        makespan = max(r.finish_time for r in reqs)
        placements = (eng.placements if kind != "sync"
                      else {eng.placement.location: len(reqs)})
        d = np.asarray(eng.decode_ms)
        figures[name] = (p50, p99)
        print(f"[staged] internlm2-1.8b {name}: simulated TTFT p50={p50:.6f} s "
              f"p99={p99:.6f} s makespan={makespan:.6f} s placements={placements}"
              + (f" scale events {[(e['event'], e['t']) for e in eng.scale_events]}, "
                 f"{seen['active']} slots decoding at the scale-out, {seen['inflight']} "
                 f"shard(s) in flight at the scale-in" if kind == "pool" else ""))
        print(f"[staged] internlm2-1.8b {name}: host wall {wall:.3f} s, {toks} tokens = "
              f"{toks / wall:.2f} tok/s, {steps} decode steps, host ms per decode step "
              f"median {np.median(d):.2f} mean {d.mean():.2f}; the sync ServeEngine's "
              f"timed pass: {sync['wall']:.3f} s, {sync['tok_s']:.2f} tok/s, "
              f"{sync['decode_ms']:.2f} ms; launches {launches}")
        if not all(r.done and len(r.out_tokens) == 16 for r in reqs):
            raise AssertionError(f"{name}: not every request finished with 16 tokens")
        if [r.out_tokens for r in reqs] != sync["tokens"]:
            parted = [r.rid for r, t in zip(reqs, sync["tokens"]) if r.out_tokens != t]
            raise AssertionError(f"{name}: tokens of requests {parted} differ from the "
                                 "timed ServeEngine pass's")
        expect = {"flash_attention": n_layers * len(reqs),
                  "decode_attention": n_layers * steps}
        if launches != expect:
            raise AssertionError(f"{name}: launches {launches}, expected {expect}")
        if kind == "sync":
            continue
        for n in staged_launches:
            staged_launches[n] += launches[n]
        if sum(eng.placements.values()) != len(reqs):
            raise AssertionError(f"{name}: placements {eng.placements} do not sum to "
                                 f"{len(reqs)}")
        if kind == "pool" and not (seen["active"] > 0 and seen["inflight"] > 0):
            raise AssertionError(f"{name}: the scale events missed the decode: {seen}")
        sim, sim_reqs, sim_seen = build(kind, "sim", spacing)
        sim.run()
        if _timeline(reqs) != _timeline(sim_reqs) or sim_seen != seen:
            raise AssertionError(f"{name}: simulated timeline differs from the sim "
                                 f"engine's: {_timeline(reqs)} != {_timeline(sim_reqs)}")
        print(f"[staged] internlm2-1.8b {name}: per-request TTFT, finish time, placement "
              f"and token count equal the compute='sim' engine's: True")
        del eng
        gc.collect()
    for label in ("burst", "spaced"):
        print(f"[staged] internlm2-1.8b {label}: simulated TTFT p99 sync "
              f"{figures['sync ' + label][1]:.6f} s, staged "
              f"{figures['staged ' + label][1]:.6f} s (on kv_fabric() two 30 M ops/s DMA "
              f"prefills share the path and the 512-token prompts set the tail)")
    return staged_launches


def phase_train(torch, dev):
    """Train full-width internlm2-1.8b for TRAIN["steps"] steps through the
    port's ``Trainer``, with int8 and then f32 AdamW moments. Returns the
    int8 run's launch counts."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import build
    from repro_torch.models.params import param_count_tree
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.cluster import ClusterTimeModel
    from repro_torch.train.trainer import Trainer

    cfg = get_config(TRAIN["arch"])
    shape = ShapeConfig("train_4k_b8", TRAIN["seq"], TRAIN["batch"], "train")
    steps = TRAIN["steps"]
    tokens = shape.global_batch * shape.seq_len
    losses, launches = {}, {}
    for moments in ("int8", "f32"):
        run = RunConfig(learning_rate=TRAIN["lr"], total_steps=steps,
                        warmup_steps=max(2, steps // 10), microbatch=TRAIN["microbatch"],
                        moments_int8=moments == "int8")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        params, opt, step_fn = build(cfg, run, dev)
        counted = param_count_tree(params)
        if moments == "int8":
            print(f"[train] {cfg.name}: param_count_tree {counted:,} values on the card, "
                  f"cfg.param_count() {cfg.param_count():,}")
        if counted != cfg.param_count():
            raise AssertionError(f"param_count_tree {counted} != cfg.param_count() "
                                 f"{cfg.param_count()}")
        # the int8 run also advances simulated time: one node of one H100
        # (core/hw.py's constants) on train_fabric(1)
        tm = (ClusterTimeModel.from_config(cfg, shape, nodes=1, devices_per_node=1)
              if moments == "int8" else None)
        tr = Trainer(cfg, run, shape, step_fn=step_fn, params=params, opt_state=opt,
                     time_model=tm)
        del params, opt
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        tr.run_steps(steps - 1)
        # the params before the last step, in host memory (the card's peak
        # stays the run's own), for the int8 run's |dp| (int8_moment_hazard)
        before = [p.cpu() for p in tree_leaves(tr.params)] if moments == "int8" else None
        tr.run_steps(1)
        torch.cuda.synchronize()
        launches[moments] = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        hist = tr.history
        losses[moments] = [h["loss"] for h in hist]
        n_leaves = len(tree_leaves(tr.params))
        print(f"[train] {cfg.name} {moments} moments: {cfg.num_layers} layers, "
              f"{cfg.param_count() / 1e9:.3f}B params ({n_leaves} leaves), batch "
              f"{shape.global_batch} x seq {shape.seq_len} in {run.microbatch} microbatches, "
              f"remat {run.remat_policy}; set up in {setup:.2f} s")
        for h in hist:
            sim = (f"; simulated (fabric model, H100 constants) {h['sim_seconds']:.6f} s = "
                   f"{h['tokens_per_s']:.1f} tok/s" if "sim_seconds" in h else "")
            print(f"[train] {moments} step {h['step']}: loss {h['loss']:.6f} lr {h['lr']:.3g} "
                  f"grad_norm {h['grad_norm']:.4g} {h['seconds'] * 1e3:.1f} ms "
                  f"({tokens / h['seconds']:.1f} tok/s host clock){sim}")
        if tm is not None and not all("sim_seconds" in h for h in hist):
            raise AssertionError("the int8 run's records carry no simulated seconds")
        steady = [h["seconds"] for h in hist[1:]]
        print(f"[train] {moments}: steps 1..{steps - 1} {np.mean(steady) * 1e3:.1f} ms/step = "
              f"{tokens / np.mean(steady):.1f} tok/s; peak memory {peak / 2 ** 30:.3f} GiB "
              f"({held / 2 ** 30:.3f} GiB allocated before the run); "
              f"kernel launches {launches[moments]}")
        if moments == "int8":
            MEASURED.update(train_peak=peak, train_held=held)
        if not all(math.isfinite(x) for x in losses[moments]):
            raise AssertionError(f"non-finite loss with {moments} moments: {losses[moments]}")
        quant = 2 * n_leaves * (1 + steps) if moments == "int8" else 0
        expect = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0,
                  "quantize": quant, "dequantize": 2 * n_leaves * steps if quant else 0}
        if launches[moments] != expect:
            raise AssertionError(f"train launches {launches[moments]}, want {expect}: m and "
                                 f"v of each leaf quantized at init and every step, "
                                 f"dequantized every step, no attention or SSD kernel")
        if moments == "int8":
            int8_moment_hazard(torch, tr, before, hist[-1])
            del before
        del tr, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["int8"], losses["f32"])]
    print(f"[train] int8 vs f32 moments: losses {losses['int8']} vs {losses['f32']}, rel "
          f"{[f'{x:.3g}' for x in rel]} (tol {LOSS_REL_TOL}; step 0 equal: "
          f"{losses['int8'][0] == losses['f32'][0]})")
    if losses["int8"][0] != losses["f32"][0]:
        raise AssertionError("step 0's loss differs between int8 and f32 moments")
    if not max(rel) < LOSS_REL_TOL:
        raise AssertionError(f"int8 moments part from f32 moments: rel {rel}")
    return launches["int8"]


def int8_moment_hazard(torch, tr, before, last):
    """After the int8 run's last step: the moment values whose v rounds to
    int8 0 under a nonzero m (the update divides m by eps there; JAX's
    int8 update does the same, ``tests/test_torch_quant.py::
    test_int8_moments_zero_v_matches_jax``), out of all of them, and the
    step's largest |dp| / lr. Printed without a limit."""
    from repro_torch.optim.adamw import tree_leaves

    hazard = total = 0
    for m, v in zip(tree_leaves(tr.opt_state.m), tree_leaves(tr.opt_state.v)):
        hazard += int(((v.q == 0) & (m.q != 0)).sum().item())
        total += m.q.numel()
    dp = max((p - b.to(p.device)).abs().max().item()
             for p, b in zip(tree_leaves(tr.params), before))
    print(f"[train] int8 moments after step {last['step']}: {hazard:,} of {total:,} moment "
          f"values ({100 * hazard / total:.4f}%) with v's int8 0 under a nonzero m; largest "
          f"|dp| {dp:.6g} = {dp / last['lr']:.6g} x lr (lr {last['lr']:.6g})")


def phase_train_cluster(torch, dev, spec=TRAIN_CLUSTER):
    """Full-width internlm2-1.8b cut to ``spec["layers"]`` layers through the
    port's ``TrainCluster`` on ``TRAIN_FABRICS["h100"]``: a run without
    failure, then one where ``spec["fail"]`` goes silent. Real checkpoints
    (uncompressed, every ``spec["every"]`` steps) under a temporary
    directory; the failure must be detected, the cluster resized and the
    newest checkpoint restored, and the failure run's per-step losses and
    every final param and moment must equal the uninterrupted run's bit
    for bit. Returns the failure run's launch counts."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.compression import Quantized
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import build
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.cluster import TRAIN_FABRICS, ClusterTimeModel, TrainCluster

    class TimedCheckpoints(CheckpointManager):
        """Host seconds of each save (staging to the host included) and
        restore (the tensors back on the card included)."""
        saves: list
        restores: list

        def save(self, step, tree, *, blocking=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().save(step, tree, blocking=blocking)
            self.saves.append((step, time.perf_counter() - t0))

        def restore(self, like, step=None):
            t0 = time.perf_counter()
            out = super().restore(like, step)
            torch.cuda.synchronize()
            self.restores.append((out[1], time.perf_counter() - t0))
            return out

    cfg = dataclasses.replace(get_config(spec["arch"]), num_layers=spec["layers"])
    shape = ShapeConfig("train_4k_b8", spec["seq"], spec["batch"], "train")
    steps, every = spec["steps"], spec["every"]
    run = RunConfig(learning_rate=spec["lr"], total_steps=steps,
                    warmup_steps=max(2, steps // 10), microbatch=spec["microbatch"],
                    moments_int8=True)
    tm = ClusterTimeModel.from_config(cfg, shape, nodes=spec["nodes"])
    pipeline = TokenPipeline(cfg, shape, seed=run.seed)
    tokens = shape.global_batch * shape.seq_len
    counters = launch_counters()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    runs = {}
    try:
        for label, fail in (("uninterrupted", None), ("failure", spec["fail"])):
            for fn in counters.values():
                fn.launches = 0
            params, opt, step_fn = build(cfg, run, dev)
            executed, walls = [], []

            def counted_step(*a, step_fn=step_fn, executed=executed, walls=walls, **kw):
                t0 = time.perf_counter()
                out = step_fn(*a, **kw)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                executed.append(a[3])
                return out

            ckpt = TimedCheckpoints(str(Path(root) / label), every=every, keep=spec["keep"],
                                    compress=False)
            ckpt.saves, ckpt.restores = [], []
            cluster = TrainCluster(
                spec["nodes"], tm, fabric=TRAIN_FABRICS["h100"](spec["nodes"]),
                step_fn=counted_step, params=params, opt_state=opt,
                batch_at=lambda s: {k: torch.as_tensor(v, device=dev)
                                    for k, v in pipeline.batch_at(s).items()},
                ckpt=ckpt, heartbeat_every=spec["heartbeat_every"],
                heartbeat_timeout=spec["heartbeat_timeout"], fail_at=fail)
            del params, opt
            t0 = time.perf_counter()
            summary = cluster.run(steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            runs[label] = cluster, summary, launches, executed
            n_leaves = len(tree_leaves(cluster.params))
            raw = [st["raw_bytes"] for st in ckpt.stats]
            print(f"[train_cluster] {label}: {cfg.name} cut to {cfg.num_layers} layers "
                  f"({cfg.param_count() / 1e9:.3f}B params, {n_leaves} leaves), batch "
                  f"{shape.global_batch} x seq {shape.seq_len} in {run.microbatch} "
                  f"microbatches, int8 moments, {spec['nodes']} nodes on "
                  f"TRAIN_FABRICS['h100']; fail_at {fail}; host wall {wall:.2f} s")
            for h in cluster.history:
                print(f"[train_cluster] {label} step {h['step']}: loss {h['loss']!r} "
                      f"simulated (fabric model, H100 constants) t {h['sim_t']:.6f} s, "
                      f"{h['sim_seconds']:.6f} s = {h.get('tokens_per_s', 0.0):.1f} tok/s "
                      f"on {h['nodes']} nodes")
            print(f"[train_cluster] {label}: numeric steps run {executed}, host s each "
                  f"{[round(w, 3) for w in walls]}; saves (step, host s) "
                  f"{[(k, round(t, 3)) for k, t in ckpt.saves]}, restores "
                  f"{[(k, round(t, 3)) for k, t in ckpt.restores]}; checkpoint "
                  f"{raw[0] / 1e9 if raw else 0.0:.3f} GB raw each; simulated "
                  f"{summary['sim_seconds']:.6f} s = {summary.get('tokens_per_s', 0.0):.1f} "
                  f"tok/s; events {[(e['event'], round(e['t'], 6)) for e in summary['events']]}; "
                  f"kernel launches {launches}")
            expect = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0,
                      "quantize": 2 * n_leaves * (len(executed) + 1),
                      "dequantize": 2 * n_leaves * len(executed)}
            if launches != expect:
                raise AssertionError(f"train_cluster {label} launches {launches}, want "
                                     f"{expect}: m and v of each leaf quantized at init and "
                                     f"every step run, dequantized every step run")
            if label == "uninterrupted":
                shutil.rmtree(Path(root) / label, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    (ref, s_ref, _, _), (fl, s_fl, launches, executed) = runs["uninterrupted"], runs["failure"]
    kinds = [e["event"] for e in s_fl["events"]]
    if kinds != ["node_silent", "failure_detected", "elastic_resize"] or s_ref["events"]:
        raise AssertionError(f"train_cluster events {kinds}, without failure "
                             f"{s_ref['events']}")
    fail_step = spec["fail"][1]
    resume = s_fl["events"][2]["resume_step"]
    if resume != (fail_step - 1) // every * every + 1 or resume >= fail_step:
        raise AssertionError(f"resumed at step {resume}: want the step after the last "
                             f"checkpoint before step {fail_step}, with a step re-run")
    losses = {h["step"]: h["loss"] for h in fl.history}
    ref_losses = {h["step"]: h["loss"] for h in ref.history}
    if losses != ref_losses or sorted(losses) != list(range(steps)):
        raise AssertionError(f"losses after the failure {losses} differ from the "
                             f"uninterrupted run's {ref_losses}")

    def leaves(c):
        return [x for leaf in tree_leaves((c.params, c.opt_state.m, c.opt_state.v))
                for x in (leaf if isinstance(leaf, Quantized) else [leaf])]

    pairs = list(zip(leaves(fl), leaves(ref)))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    if differ or fl.opt_state.step != ref.opt_state.step:
        raise AssertionError(f"{differ} of {len(pairs)} final tensors differ from the "
                             f"uninterrupted run's")
    print(f"[train_cluster] failure run: events {kinds}, resumed at step {resume} "
          f"(numeric steps {executed}); losses of all {steps} steps and all {len(pairs)} "
          f"final tensors (f32 masters, int8 q and f32 scales of m and v) bit-equal to "
          f"the uninterrupted run's; simulated {s_fl['sim_seconds']:.6f} s against "
          f"{s_ref['sim_seconds']:.6f} s")
    return launches


def _sim_view(rep):
    """A run's simulated report without the train tenant's losses (the
    only figure compute adds to it)."""
    rep = rep if isinstance(rep, dict) else rep.to_dict()
    if isinstance(rep.get("train"), dict):
        rep = {**rep, "train": {k: v for k, v in rep["train"].items() if k != "loss"}}
    return {k: v for k, v in rep.items() if k != "loss"}


def phase_colocate(torch, dev, argv=COLOCATE_ARGV, spec=COLOCATE_TRAIN):
    """Serve + train colocation on one fabric (``repro_torch.tenancy``), as
    ``repro_torch.launch.colocate`` builds it from ``argv``: the serve
    tenant (full-width internlm2-1.8b, ``StagedServeEngine(slots=2,
    max_len=64, impl="auto")``: K1 and K2) and a 2-node ``TrainCluster``
    running the numeric stream (internlm2 cut to ``spec["layers"]`` layers,
    int8 moments: K4a and K4b). Four runs: solo serve, solo train,
    unmanaged (equal shares) and managed (QoS weights, the SLO and the
    occupancy limit); each again with a ``compute="sim"`` engine and a
    timing-only cluster on the same fabric and requests. Fatal: a real
    run's simulated report differs from its sim twin's; colocated tokens,
    losses or final tensors differ from the solo runs'; the managed run
    never throttles; a run's launch counts (set to 0 just before it)
    differ from one K1 per layer and request, one K2 per layer and decode
    step, 2 x leaves x (numeric steps + 1) K4a and 2 x leaves x numeric
    steps K4b; request 0's prefill logits with kernels part from the plain
    versions' by MODEL_REL_TOL. Returns the launch counts summed over the
    four runs."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.compression import Quantized
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import colocate as L
    from repro_torch.launch.train import build
    from repro_torch.models import model as M
    from repro_torch.models.params import compute_copy, init_params
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.tenancy import Colocation, QoSPolicy, solo_serve, solo_train

    args = L.parser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg = get_config(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    serve_params = compute_copy(init_params(cfg, gen, dev))   # the engines keep these
    tcfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    shape = ShapeConfig("train_4k_b8", spec["seq"], spec["batch"], "train")
    steps = args.train_steps
    run = RunConfig(learning_rate=spec["lr"], total_steps=steps,
                    warmup_steps=max(2, steps // 10), microbatch=spec["microbatch"],
                    moments_int8=True)
    pipeline = TokenPipeline(tcfg, shape, seed=run.seed)
    torch.cuda.synchronize()
    print(f"[colocate] serve tenant {cfg.name}: {cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f}B params, StagedServeEngine(slots={args.slots}, "
          f"max_len=64, impl='auto'); train tenant {tcfg.num_layers} layers "
          f"({tcfg.param_count() / 1e9:.3f}B params), batch {shape.global_batch} x seq "
          f"{shape.seq_len} in {run.microbatch} microbatches, int8 moments, "
          f"TrainCluster({args.nodes}); flags {' '.join(argv)}; set up in "
          f"{time.perf_counter() - t0:.2f} s")

    numeric = []                                   # per cluster: steps run, host s each

    def cluster_kw():
        params, opt, step_fn = build(tcfg, run, dev)
        executed, walls = [], []
        numeric.append((executed, walls))

        def counted_step(*a, **kw):
            t1 = time.perf_counter()
            out = step_fn(*a, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            executed.append(a[3])
            return out
        return dict(step_fn=counted_step, params=params, opt_state=opt,
                    batch_at=lambda s: {k: torch.as_tensor(v, device=dev)
                                        for k, v in pipeline.batch_at(s).items()})

    pieces = {"real": L.build_pieces(args, device=dev, params=serve_params,
                                     cluster_kw=cluster_kw),
              "sim": L.build_pieces(args, compute="sim")}

    def drive(name, mode, solo_p99):
        """(report, requests, engine, cluster) of one run."""
        fabric, make_engine, make_cluster, requests = pieces[mode]
        built = {}

        def rec_engine(rt):
            built["engine"] = make_engine(rt)
            return built["engine"]

        def rec_cluster(rt):
            built["cluster"] = make_cluster(rt)
            return built["cluster"]
        reqs = requests()
        if name == "solo_serve":
            return solo_serve(fabric(), rec_engine, reqs), reqs, built["engine"], None
        if name == "solo_train":
            return solo_train(fabric(), rec_cluster, steps), [], None, built["cluster"]
        kw = ({} if name == "unmanaged" else
              dict(qos=QoSPolicy.serve_train(args.serve_weight, args.train_weight),
                   admission=L.managed_config(args, solo_p99)))
        h = Colocation(fabric=fabric(), make_engine=rec_engine, make_cluster=rec_cluster, **kw)
        return h.run(reqs, steps), reqs, h.engine, h.cluster

    counters = launch_counters()
    total = dict.fromkeys(counters, 0)
    out, walls = {}, {}
    for name in COLOCATE_RUNS:
        p99 = {m: out[("solo_serve", m)][0]["p99_ttft"] if ("solo_serve", m) in out else None
               for m in ("real", "sim")}
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        n_numeric = len(numeric)
        t1 = time.perf_counter()
        rep, reqs, eng, cluster = out[(name, "real")] = drive(name, "real", p99["real"])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t1
        launches = {k: fn.launches for k, fn in counters.items()}
        sim = out[(name, "sim")] = drive(name, "sim", p99["sim"])
        # 1. compute moves nothing on the simulated clock
        if _sim_view(rep) != _sim_view(sim[0]):
            raise AssertionError(f"colocate {name}: the simulated report differs from the "
                                 f"compute='sim' twin's: {_sim_view(rep)} != "
                                 f"{_sim_view(sim[0])}")
        # 4. K1 per layer and request, K2 per layer and decode step, K4a at
        #    init and each numeric step, K4b each numeric step
        ran, step_walls = numeric[n_numeric] if len(numeric) > n_numeric else ([], [])
        leaves = len(tree_leaves(cluster.params)) if cluster is not None else 0
        decode_steps = eng.stats["decode_steps"] if eng is not None else 0
        expect = {"flash_attention": cfg.num_layers * len(reqs),
                  "decode_attention": cfg.num_layers * decode_steps, "ssd_scan": 0,
                  "quantize": 2 * leaves * (len(ran) + 1) if cluster is not None else 0,
                  "dequantize": 2 * leaves * len(ran)}
        print(f"[colocate] {name}: host wall {walls[name]:.3f} s; "
              f"{sum(len(r.out_tokens) for r in reqs)} tokens, {decode_steps} decode steps; "
              f"numeric steps {ran}, host s each {[round(w, 3) for w in step_walls]}; "
              f"launches {launches}; simulated report equals the compute='sim' twin's "
              f"(sim_seconds, serve p50/p99/tokens/s, train summary without losses, "
              f"occupancy, events, throttles)")
        if launches != expect:
            raise AssertionError(f"colocate {name}: launches {launches}, want {expect}")
        for k in total:
            total[k] += launches[k]

    # the launcher's lines, from the real runs' reports
    solo_s, solo_t = out[("solo_serve", "real")][0], out[("solo_train", "real")][0]
    managed = out[("managed", "real")][0]
    for line in ([L.solo_line(solo_s, solo_t)]
                 + [L.run_line(n, out[(n, "real")][0], solo_s, solo_t)
                    for n in ("unmanaged", "managed")] + L.managed_lines(managed)):
        print(f"[colocate] simulated (fabric model, core/hw.py H100 constants) {line}")

    # 2. and 3. colocation moves TTFT and step times, never a token, a
    #    loss, a param, a moment or a scale
    solo_tokens = [r.out_tokens for r in out[("solo_serve", "real")][1]]
    solo_c = out[("solo_train", "real")][3]

    def state(c):
        return [x for leaf in tree_leaves((c.params, c.opt_state.m, c.opt_state.v))
                for x in (leaf if isinstance(leaf, Quantized) else [leaf])]

    solo_losses = {h["step"]: h["loss"] for h in solo_c.history}
    if sorted(solo_losses) != list(range(steps)) or \
            not all(math.isfinite(x) for x in solo_losses.values()):
        raise AssertionError(f"colocate solo_train losses {solo_losses}")
    for name in ("unmanaged", "managed"):
        rep, reqs, _, c = out[(name, "real")]
        tokens = [r.out_tokens for r in reqs]
        if tokens != solo_tokens:
            raise AssertionError(f"colocate {name}: serve tokens {tokens} differ from solo's "
                                 f"{solo_tokens}")
        losses = {h["step"]: h["loss"] for h in c.history}
        pairs = list(zip(state(c), state(solo_c)))
        differ = sum(not (a.dtype == b.dtype and torch.equal(a, b)) for a, b in pairs)
        if losses != solo_losses or differ or c.opt_state.step != solo_c.opt_state.step:
            raise AssertionError(f"colocate {name}: losses {losses} against solo's "
                                 f"{solo_losses}, {differ} of {len(pairs)} final tensors differ")
        print(f"[colocate] {name}: serve tokens equal solo's, token for token; losses "
              f"{[losses[k] for k in sorted(losses)]} and all {len(pairs)} final tensors "
              f"(f32 masters, int8 q and f32 scales of m and v) bit-equal to solo's; "
              f"throttles {rep.throttles}")
    if not managed.throttles > 0:
        raise AssertionError("colocate managed: the admission controller never throttled")

    # 5. request 0's prefill logits, kernels against plain versions
    _, reqs, eng, _ = out[("solo_serve", "real")]
    r0 = reqs[0]
    bucket = eng._bucket_len(len(r0.prompt))
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(r0.prompt)] = r0.prompt
    logits = {impl: M.prefill(cfg, serve_params, torch.as_tensor(toks, device=dev),
                              eng.max_len, impl=impl, cache_dtype=torch.float32,
                              length=len(r0.prompt))[0][:, -1]
              for impl in ("auto", "ref")}
    ref = logits["ref"]
    rel = float(((logits["auto"] - ref).abs().amax() / ref.abs().amax()).item())
    same = int(logits["auto"].argmax()) == int(ref.argmax()) == r0.out_tokens[0]
    print(f"[colocate] kernels vs plain, request 0 (prompt {len(r0.prompt)}, bucket "
          f"{bucket}): rel err of the prefill logits {rel:.3g} (tol {MODEL_REL_TOL}); "
          f"both argmaxes the served first token: {same}")
    if not rel < MODEL_REL_TOL:
        raise AssertionError(f"colocate: request 0's logits with kernels disagree: {rel}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[colocate] host wall per run (s): "
          f"{', '.join(f'{k} {v:.3f}' for k, v in walls.items())}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches over the four runs {total}")
    return total


def moe_prefill_metrics(torch, dev, cfg, params, prompt):
    """Every MoE layer's ``MoEMetrics`` in one prefill of ``prompt`` with
    the kernels (lossless capacity, as a prefill dispatches): the model's
    ``moe_ffn`` is wrapped for the call to record them."""
    from repro_torch.models import model as M

    seen, moe_ffn = [], M.moe_ffn

    def recording(*args, **kw):
        y, metrics = moe_ffn(*args, **kw)
        seen.append(metrics)
        return y, metrics
    M.moe_ffn = recording
    try:
        M.prefill(cfg, params, torch.as_tensor(prompt, device=dev)[None], len(prompt),
                  cache_dtype=torch.float32)
    finally:
        M.moe_ffn = moe_ffn
    return seen


def zoo_long_prompt(torch, dev, cfg, params, spec=ZOO_LONG):
    """gemma2-9b past its local layers' window: one prompt of
    ``spec["tokens"]`` tokens (numpy seed 0) through ``M.prefill`` and
    ``spec["steps"]`` teacher-forced ``decode_step``s in a cache of
    ``spec["max_len"]`` rows, kernels against plain versions (K1's
    window masks keys 4096 back in the prefill, K2's in each decode).
    Then the prompt's prefill alone, with the kernels and plain, in
    turns, on the host clock (synced): the fastest of two each."""
    from repro_torch.models import model as M

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, spec["tokens"]).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, spec["steps"]).tolist()
    counters = launch_counters()
    before = {k: counters[k].launches for k in ("flash_attention", "decode_attention")}
    t0 = time.perf_counter()
    rel, same, _ = kernels_vs_plain(torch, dev, cfg, params, prompt, forced, spec["max_len"])
    ran = {k: counters[k].launches - n for k, n in before.items()}
    print(f"[zoo] {cfg.name}: long prompt of {spec['tokens']} tokens (window "
          f"{cfg.window_size} on the local layers), max_len {spec['max_len']}, kernels vs "
          f"plain: rel err of prefill + {spec['steps']} decode logits "
          f"{[f'{x:.3g}' for x in rel]} (tol {MODEL_REL_TOL}), same argmax {same}; "
          f"kernel launches {ran}; {time.perf_counter() - t0:.1f} s")
    if not max(rel) < MODEL_REL_TOL:
        raise AssertionError(f"{cfg.name}: the long prompt's logits with kernels disagree: {rel}")
    toks, ms = torch.as_tensor(prompt, device=dev)[None], {}
    for impl in ("auto", "ref", "ref", "auto"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        M.prefill(cfg, params, toks, spec["max_len"], impl=impl, cache_dtype=torch.float32)
        torch.cuda.synchronize()
        ms.setdefault(impl, []).append((time.perf_counter() - t1) * 1e3)
    print(f"[zoo] {cfg.name}: prefill of the {spec['tokens']}-token prompt (host clock, "
          f"synced, fastest of 2): kernels {min(ms['auto']):.2f} ms, plain "
          f"{min(ms['ref']):.2f} ms")


def phase_zoo(torch, dev):
    """The archs of the registry that one card holds (``ZOO``), each at
    full width (moonshot-v1-16b-a3b cut to 16 of its 48 layers: 28.06B
    params would be 168 GB as f32 masters plus the bf16 copy), random
    weights from seed 0, freed before the next. Each serves
    ``ZOO_SERVE["requests"]`` greedy requests (prompt lengths from numpy
    seed 0 in [8, 512], tiled over musicgen's codebooks as the JAX
    launcher tiles them, 8 new tokens each) through ``ServeEngine(slots=4,
    max_len=1024)`` with an f32 cache, once checking that every logit row
    is finite, then again timed on the host clock. Fatal: the timed
    pass's launch counts (set to 0 just before it) are not one K1 per
    attention layer and request and one K2 per attention layer and
    decode step; request 0's prefill logits and three teacher-forced
    decode steps, kernels against plain, part by MODEL_REL_TOL (for
    internvl2-2b also after 256 frontend rows, numpy seed 0 x 0.02,
    through ``M.prefill``; the engine, as JAX's, passes none; for the MoE
    archs with every token routed to the plain run's experts, the
    unpinned errors and the routing flips printed beside them:
    ``kernels_vs_plain``); an MoE prefill drops an assignment (lossless
    capacity); gemma2-9b's long prompt (``zoo_long_prompt``) disagrees.
    Prints each arch's tokens/s, prefill ms per bucket, decode ms, peak
    device memory, seconds, and each MoE's dropped fraction and expert
    load. Returns the launch counts summed over the timed passes, and
    each arch's."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params, layer_period, num_groups, slot_kind
    from repro_torch.serve.engine import Request, ServeEngine

    class Engine(_Probe, ServeEngine):
        pass

    spec = ZOO_SERVE
    counters = launch_counters()
    total, by_arch = dict.fromkeys(counters, 0), {}
    for arch, layers in ZOO:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        # the engine keeps a bf16 copy; the f32 masters go when it is made
        eng = Engine(cfg, init_params(cfg, gen, dev), slots=spec["slots"],
                     max_len=spec["max_len"], device=dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        lens = rng.integers(spec["low"], spec["high"] + 1, spec["requests"]).tolist()
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
        if cfg.num_codebooks > 1:
            prompts = [np.tile(p[:, None], (1, cfg.num_codebooks)) for p in prompts]

        def submit_all():
            reqs = [Request(rid=i, prompt=p, max_new_tokens=spec["max_new"])
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            return reqs

        eng._probe_reset(torch)
        eng.checking = True
        checked = submit_all()
        eng.run()
        eng.checking = False
        if not bool(eng.finite):
            raise AssertionError(f"non-finite logits in the {arch} serve run")
        eng._probe_reset(torch)
        reqs = submit_all()
        torch.cuda.synchronize()
        steps0 = eng.stats["decode_steps"]
        for fn in counters.values():
            fn.launches = 0
        t1 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {k: fn.launches for k, fn in counters.items()}
        steps = eng.stats["decode_steps"] - steps0
        kinds = [slot_kind(cfg, i)["kind"] for i in range(layer_period(cfg))] * num_groups(cfg)
        n_attn = kinds.count("attn")
        expect = {"flash_attention": n_attn * len(reqs), "decode_attention": n_attn * steps,
                  "ssd_scan": 0, "quantize": 0, "dequantize": 0}
        toks = sum(len(r.out_tokens) for r in reqs)
        d = np.asarray(eng.decode_ms)
        print(f"[zoo] {arch}: {cfg.num_layers} layers{f' (cut from {get_config(arch).num_layers})' if layers else ''}, "
              f"d_model {cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} kv heads of "
              f"{cfg.head_dim}, {cfg.param_count() / 1e9:.3f}B params, set up in {setup:.2f} s; "
              f"prompt lengths {lens}, buckets {sorted(eng.prefill_ms)}; {len(reqs)} requests, "
              f"{toks} tokens in {wall:.3f} s = {toks / wall:.2f} tok/s, {steps} decode steps, "
              f"decode ms median {np.median(d):.2f}; launches {launches}; the checked pass's "
              f"tokens the timed pass's: {[r.out_tokens for r in checked] == [r.out_tokens for r in reqs]}")
        if not all(r.done and len(r.out_tokens) == spec["max_new"] for r in checked + reqs):
            raise AssertionError(f"{arch}: not every request finished with {spec['max_new']} tokens")
        print(f"[zoo] {arch}: prefill ms per length (bucket): " + ", ".join(
            f"{b}: {np.mean(v):.2f} (n={len(v)})" for b, v in sorted(eng.prefill_ms.items())))
        if launches != expect:
            raise AssertionError(f"{arch} launches {launches}, not one per attention layer and "
                                 f"request or decode step: {expect}")
        if cfg.num_codebooks > 1 and not all(
                isinstance(r.out_tokens[0], int) and
                all(len(t) == cfg.num_codebooks for t in r.out_tokens[1:]) for r in reqs):
            raise AssertionError(f"{arch}: codebook tokens are not JAX's (an int, then lists)")
        r0 = reqs[0]
        rel, same, moe = kernels_vs_plain(torch, dev, cfg, eng.params, r0.prompt,
                                          r0.out_tokens[:3], eng.max_len,
                                          bucket=eng._bucket_len(len(r0.prompt)))
        pinned = ", every token routed to the plain run's experts" if moe else ""
        print(f"[zoo] {arch}: kernels vs plain, request 0 (prompt {len(r0.prompt)}): rel err of "
              f"prefill + 3 decode logits {[f'{x:.3g}' for x in rel]} (tol {MODEL_REL_TOL}"
              f"{pinned}), same argmax {same}" + (
                  f"; unpinned (each run routing by its own router, no limit) "
                  f"{[f'{x:.3g}' for x in moe['unpinned']]}, {moe['flips']} of {moe['routed']} "
                  f"routed tokens with another top-{cfg.num_experts_per_tok} set" if moe else ""))
        if not max(rel) < MODEL_REL_TOL:
            raise AssertionError(f"{arch} model logits with kernels disagree: {rel}")
        if cfg.frontend == "vision":
            fe = (np.random.default_rng(0).standard_normal((cfg.frontend_tokens, cfg.d_model))
                  * 0.02).astype(np.float32)
            rel, same, _ = kernels_vs_plain(torch, dev, cfg, eng.params, r0.prompt,
                                            r0.out_tokens[:3], eng.max_len, frontend=fe)
            print(f"[zoo] {arch}: kernels vs plain after {cfg.frontend_tokens} frontend rows, "
                  f"request 0: rel err {[f'{x:.3g}' for x in rel]} (tol {MODEL_REL_TOL}), "
                  f"same argmax {same}")
            if not max(rel) < MODEL_REL_TOL:
                raise AssertionError(f"{arch} frontend logits with kernels disagree: {rel}")
        if cfg.num_experts:
            metrics = moe_prefill_metrics(torch, dev, cfg, eng.params, prompts[0])
            drop = [float(m.dropped_frac) for m in metrics]
            load = metrics[0].expert_load
            print(f"[zoo] {arch}: MoE prefill of request 0 ({len(prompts[0])} tokens, top-"
                  f"{cfg.num_experts_per_tok} of {cfg.num_experts}): dropped_frac per layer max "
                  f"{max(drop):.3g} over {len(drop)} layers; layer 0 expert_load min "
                  f"{load.min().item():.4f} max {load.max().item():.4f}: "
                  f"{[round(x, 4) for x in load.tolist()]}")
            if max(drop) != 0.0:
                raise AssertionError(f"{arch}: a lossless prefill dropped assignments: {drop}")
        if arch == ZOO_LONG["arch"]:
            zoo_long_prompt(torch, dev, cfg, eng.params)
        for k in total:
            total[k] += launches[k]
        by_arch[arch] = launches
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[zoo] {arch}: peak memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} "
              f"GiB; {time.perf_counter() - t0:.1f} s")
    print(f"[zoo] launches over the timed passes: {total}")
    return total, by_arch


def _dist_rank(rank: int, world: int, root: str, card: str) -> dict:
    """One rank of the dist phase (``phase_dist``), on ``cuda:0`` beside
    the other ranks. Returns its launch counts, figures and checks, on the
    host."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import collectives as C
    from repro_torch.ft.elastic import best_mesh_for, make_mesh, reshard
    from repro_torch.kernels.decode_attention.ref import decode_attention
    from repro_torch.models import model as M
    from repro_torch.models.attention import decode_attention_context_parallel
    from repro_torch.models.moe import moe_ffn, moe_ffn_dense_ref
    from repro_torch.models.params import _logical_only, _moe_shapes, compute_copy, init_params
    from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_unflatten
    from repro_torch.parallel.sharding import (CONTEXT_PARALLEL_OVERRIDES, Mesh, full_tensor,
                                               local_shard, logical_to_spec, use_mesh)
    from repro_torch.train import train_step as TS
    from repro_torch.train.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tag = f"({card}; {world} ranks on one card, gloo through host memory, not NVLink)"
    lead = rank == 0
    out = {"checks": {}}
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0

    def say(msg):
        if lead:
            print(f"[dist] {msg} {tag}", flush=True)

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    peaks = {}

    def mark(part):
        """Frees the caches (the card's, and the pinned host memory a part's
        staged copies leave cached where torch can free it) and keeps the
        most card memory (GiB) this rank held since the last mark."""
        torch.cuda.empty_cache()
        getattr(torch._C, "_host_emptyCache", lambda: None)()
        peaks[part] = round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2)
        torch.cuda.reset_peak_memory_stats(dev)

    def timed(fn):
        torch.cuda.synchronize()
        dist.barrier()
        b0, s0 = C.host_staged.bytes, C.shift.bytes
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3, C.host_staged.bytes - b0, C.shift.bytes - s0

    # (a) collectives at a gradient's size, on (pod 2, data 2)
    mesh = Mesh((2, 2), ("pod", "data"), device=dev)
    x = torch.randn(DIST["grad_shape"], generator=gen(0), device=dev)
    rows = x.shape[0] // mesh.shape["data"]
    xs = x[mesh.index("data") * rows:(mesh.index("data") + 1) * rows]
    coll = {}
    got, ms, st, ring = timed(lambda: C.all_gather_bidirectional(xs, mesh, "data"))
    coll["all_gather"] = dict(err=float((got - x).abs().max()), ms=ms, staged=st, ring=ring)
    del got
    got, ms, st, ring = timed(lambda: C.all_reduce_hierarchical(x, mesh, "data", "pod"))
    coll["hierarchical"] = dict(err=float((got - 4 * x).abs().max() / (4 * x).abs().max()),
                                ms=ms, staged=st, ring=ring)
    del got
    got, ms, st, ring = timed(lambda: C.all_reduce_compressed(x, mesh, "pod"))
    coll["compressed"] = dict(err=float((got - 2 * x).abs().max() / (2 * x).abs().max()),
                              ms=ms, staged=st, ring=ring)
    del got, x, xs
    for name, c in coll.items():
        say(f"(a) {name} of {DIST['grad_shape']} f32 ({4 * math.prod(DIST['grad_shape']) / 2 ** 20:.0f}"
            f" MiB): err {c['err']:.3g}, {c['ms']:.1f} ms, host-staged {c['staged']} bytes, "
            f"ring-sent {c['ring']} bytes")
    out["coll"] = coll
    out["checks"]["all_gather exact"] = coll["all_gather"]["err"] == 0.0
    out["checks"]["hierarchical"] = coll["hierarchical"]["err"] < DIST_COLL_TOL["hier"]
    out["checks"]["compressed"] = coll["compressed"]["err"] < DIST_COLL_TOL["comp"]
    mark("a")

    # (b) context-parallel serve of full-width internlm2-1.8b, the cache
    #     split on the sequence over data
    mesh = Mesh((world,), ("data",), device=dev)
    cfg = get_config("internlm2-1.8b")
    params = None
    for r in range(world):                  # one f32 init at a time on the card
        if r == rank:
            params = compute_copy(init_params(cfg, gen(0), dev))
            torch.cuda.empty_cache()
        dist.barrier()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, DIST["cp_prompt"])
    toks = torch.as_tensor(prompt, device=dev)[None]
    with torch.no_grad():
        logits, cache, npos = M.prefill(cfg, params, toks, DIST["cp_max_len"])   # K1
        # layer 0 at the full-width shape: CP attention against local decode, f32
        q = torch.randn((1, 1, cfg.num_heads, cfg.head_dim), generator=gen(1), device=dev)
        k0, v0 = cache[0]["k"][0].float(), cache[0]["v"][0].float()
        spec = logical_to_spec(("decode_batch", "kv_seq", "kv_heads", None), mesh,
                               dim_sizes=k0.shape, overrides=CONTEXT_PARALLEL_OVERRIDES)
        cp0 = decode_attention_context_parallel(
            q, local_shard(k0, mesh, spec), local_shard(v0, mesh, spec), torch.tensor(npos),
            mesh=mesh, axis="data")
        out["layer0_err"] = float((cp0 - decode_attention(q, k0, v0, npos)).abs().max())
        del k0, v0
        local = M.shard_cache(cfg, cache, mesh, "data")
        del cache
        torch.cuda.empty_cache()
        tok = logits[:, -1].argmax(-1)
        cp_tokens, cp_logits, step_ms = [], [], []
        b0 = C.host_staged.bytes
        for i in range(DIST["cp_steps"]):
            cp_tokens.append(int(tok))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, local = M.decode_step(cfg, params, tok[:, None], local,
                                          torch.tensor([npos + i], device=dev),
                                          cp_axis="data", mesh=mesh)
            tok = logits[:, 0].argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            cp_logits.append(logits[0, 0].float())
        staged = C.host_staged.bytes - b0
        del local
    out["cp_tokens"], out["cp_ms"] = cp_tokens, step_ms
    # the one-rank path on the same card, teacher-forced on the CP tokens:
    # prefill (K1) and decode_step (K2) against the whole cache
    if lead:
        with torch.no_grad():
            logits, cache, npos = M.prefill(cfg, params, toks, DIST["cp_max_len"])
            rel, agree = [], 0
            for i, t in enumerate(cp_tokens):
                logits, cache = M.decode_step(cfg, params, torch.tensor([[t]], device=dev),
                                              cache, torch.tensor([npos + i], device=dev))
                ref = logits[0, 0].float()
                rel.append(float((cp_logits[i] - ref).abs().max() / ref.abs().max()))
                nxt = cp_tokens[i + 1] if i + 1 < len(cp_tokens) else int(cp_logits[i].argmax())
                agree += int(ref.argmax()) == nxt
            del cache
        out["cp_rel"], out["cp_agree"] = rel, agree
        say(f"(b) context-parallel serve, full-width internlm2-1.8b: prompt {DIST['cp_prompt']}, "
            f"cache {DIST['cp_max_len']} rows split {world} ways on the sequence, "
            f"{DIST['cp_steps']} greedy decode steps: {np.median(step_ms):.1f} ms a step "
            f"(median; first {step_ms[0]:.1f}), host-staged {staged} bytes a rank; "
            f"layer 0 CP vs local decode (f32) err {out['layer0_err']:.3g} (tol {DIST_ATTN_TOL}); "
            f"logits vs the one-rank K2 path rel max {max(rel):.3g} (tol {MODEL_REL_TOL}); "
            f"next-token agreement {agree}/{len(cp_tokens)}")
        out["checks"]["cp logits"] = max(rel) < MODEL_REL_TOL
    out["checks"]["cp layer 0"] = out["layer0_err"] < DIST_ATTN_TOL
    del params, logits, cp_logits
    mark("b")
    dist.barrier()

    # (c) expert-parallel MoE: one granite-moe layer at full width on
    #     (data 2, model 2), each rank's shards, FSDP gathers inside
    mcfg = get_config(DIST["moe_arch"])
    mesh = Mesh((2, 2), ("data", "model"), device=dev)
    d, e, f = mcfg.d_model, mcfg.num_experts, mcfg.d_ff
    g = gen(2)
    full = {"router": torch.randn((d, e), generator=g, device=dev) / math.sqrt(d),
            "w_in": torch.randn((e, d, 2, f), generator=g, device=dev) / math.sqrt(d),
            "w_out": torch.randn((e, f, d), generator=g, device=dev) / math.sqrt(f)}
    b, s = DIST["moe_batch"]
    xm = torch.randn((b, s, d), generator=g, device=dev).to(torch.bfloat16)
    shards = {k: local_shard(v, mesh, logical_to_spec(_moe_shapes(mcfg)[k][1], mesh,
                                                      dim_sizes=v.shape))
              for k, v in full.items()}
    bspec = logical_to_spec(("batch", None, None), mesh, dim_sizes=xm.shape)
    xl = local_shard(xm, mesh, bspec)
    with torch.no_grad():
        with use_mesh(mesh):
            (y, met), ms, st, _ = timed(lambda: moe_ffn(
                xl, shards, num_experts=e, top_k=mcfg.num_experts_per_tok,
                activation=F.silu, capacity_factor=None))
        yref = local_shard(moe_ffn_dense_ref(xm.float(), full, num_experts=e,
                                             top_k=mcfg.num_experts_per_tok,
                                             activation=F.silu), mesh, bspec)
    out["moe_err"] = float((y.float() - yref).abs().max())
    out["moe_dropped"] = float(met.dropped_frac)
    say(f"(c) expert-parallel MoE, one {DIST['moe_arch']} layer (d_model {d}, {e} experts, "
        f"top-{mcfg.num_experts_per_tok}, d_ff {f}) at B={b} S={s} on {mesh.shape}, "
        f"{e // 2} experts a rank: vs dense f32 oracle err {out['moe_err']:.3g} "
        f"(tol {DIST_MOE_TOL}), dropped {out['moe_dropped']}, {ms:.1f} ms, host-staged {st} bytes")
    out["checks"]["moe"] = out["moe_err"] < DIST_MOE_TOL and out["moe_dropped"] == 0.0
    del full, shards, y, yref, xm, xl
    mark("c")

    # (d) compressed pod sync: internlm2 cut to 2 layers on (pod 2, data 2),
    #     int8 AdamW moments (K4a, K4b); one step each way from the same
    #     params. What is only compared (the start params, the auto step's
    #     params and synced grads) waits in host memory, so a rank holds one
    #     training state on the card at a time.
    scfg = dataclasses.replace(cfg, num_layers=DIST["sync_layers"])
    mesh = Mesh((2, 2), ("pod", "data"), device=dev)
    p0 = init_params(scfg, gen(0), dev)
    p0 = tree_unflatten(p0, [p.to("cpu", copy=True) for p in tree_leaves(p0)])
    b, s = DIST["sync_batch"]
    tk = torch.randint(0, scfg.vocab_size, (b, s), generator=gen(3), device=dev)
    batch = {"tokens": tk, "labels": tk, "loss_mask": torch.ones((b, s), device=dev)}
    res = {}
    # the synced grads each step hands its optimizer, read by wrapping it:
    # ``look`` maps them to what is kept; its seconds (``aside``) are taken
    # out of the step's time
    adamw, kept, look, aside = TS.adamw_update, [], [None], [0.0]

    def adamw_keeping_grads(grads, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept.append(look[0](tree_leaves(grads)))
        torch.cuda.synchronize()
        aside[0] += time.perf_counter() - t0
        return adamw(grads, *a, **k)

    def on_card(tree):
        return tree_unflatten(tree, [p.to(dev, copy=True) for p in tree_leaves(tree)])

    def to_host(leaves):
        return [g.to("cpu", copy=True) for g in leaves]

    def ring_steps_of(leaves):          # int8 steps of each leaf's largest |exact grad|
        worst = 0.0
        for c, a in zip(leaves, auto_g):
            a = a.to(dev)
            worst = max(worst, float((c - a).abs().max() / (a.abs().max() / 127)))
        return worst

    def exact_rel_of(leaves):           # each leaf rel by norm
        return max(float((a.to(dev) - o).norm() / o.norm()) for a, o in zip(auto_g, leaves))

    TS.adamw_update = adamw_keeping_grads
    try:
        for mode, keep in (("auto", to_host), ("compressed", ring_steps_of)):
            look[0], aside[0] = keep, 0.0
            run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, pod_sync=mode,
                            moments_int8=True)
            own = on_card(p0)
            step = make_train_step(scfg, run, mesh=mesh)
            opt = adamw_init(own, moments="int8")
            (own, _, met), ms, st, ring = timed(lambda: step(own, opt, batch, 1))
            res[mode] = dict(params=own, loss=float(met["loss"]), ms=ms - aside[0] * 1e3,
                             staged=st, ring=ring, grad_norm=float(met["grad_norm"]))
            if mode == "auto":
                auto_g = kept[0]
                res[mode]["params"] = tree_unflatten(own, to_host(tree_leaves(own)))
            del opt, own
            torch.cuda.empty_cache()
        ring_steps = kept[1]
        if lead:                            # the exact mean against one rank's whole batch
            run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                            moments_int8=True)
            own = on_card(p0)
            look[0] = exact_rel_of
            make_train_step(scfg, run)(own, adamw_init(own, moments="int8"), batch, 1)
            exact = kept[2]
            del own
        del auto_g
        kept.clear()
    finally:
        TS.adamw_update = adamw
    torch.cuda.empty_cache()
    la, lc = res["auto"]["loss"], res["compressed"]["loss"]
    ga, gc = res["auto"]["grad_norm"], res["compressed"]["grad_norm"]
    pdiff = max(float((a.to(dev) - c).abs().max()) for a, c in
                zip(tree_leaves(res["auto"]["params"]), tree_leaves(res["compressed"]["params"])))
    out["sync"] = dict(loss_rel=abs(la - lc) / abs(la), params=pdiff, ring_steps=ring_steps,
                       norm_rel=abs(gc - ga) / ga,
                       **{f"{m}_{k}": res[m][k] for m in res for k in ("loss", "ms", "staged", "ring")})
    if lead:
        out["sync"]["exact_rel"] = exact
        say(f"(d) pod sync, internlm2-1.8b cut to {DIST['sync_layers']} layers, batch {b} x {s} "
            f"on {mesh.shape}, int8 moments: auto {res['auto']['ms']:.0f} ms (host-staged "
            f"{res['auto']['staged']} bytes), compressed {res['compressed']['ms']:.0f} ms "
            f"(host-staged {res['compressed']['staged']} bytes, int8 ring sent "
            f"{res['compressed']['ring']} bytes); synced grads: ring vs exact mean "
            f"{ring_steps:.3g} int8 steps (tol {DIST_SYNC_TOL['int8']}), grad norm {gc:.6g} vs "
            f"{ga:.6g} rel {out['sync']['norm_rel']:.3g} (tol {DIST_SYNC_TOL['norm']}), exact mean "
            f"vs one rank's whole batch, worst leaf rel by norm {exact:.3g} (tol "
            f"{DIST_SYNC_TOL['exact']}); loss "
            f"{la:.6f} vs {lc:.6f} rel {out['sync']['loss_rel']:.3g} (tol "
            f"{DIST_SYNC_TOL['loss']}), params max diff {pdiff:.3g} (tol {DIST_SYNC_TOL['params']})")
        out["checks"]["pod sync exact mean"] = exact < DIST_SYNC_TOL["exact"]
    out["checks"]["pod sync ring"] = ring_steps < DIST_SYNC_TOL["int8"]
    out["checks"]["pod sync grad norm"] = out["sync"]["norm_rel"] < DIST_SYNC_TOL["norm"]
    out["checks"]["pod sync"] = (out["sync"]["loss_rel"] < DIST_SYNC_TOL["loss"]
                                 and pdiff < DIST_SYNC_TOL["params"])
    params = res["compressed"]["params"]
    del res, p0
    mark("d")

    # (e) elastic reshard: (d)'s params from best_mesh_for(4, model=2) to
    #     best_mesh_for(2, model=2), bit-equal
    _, logical = _logical_only(scfg)
    m4 = make_mesh(*best_mesh_for(world, model=2), device=dev)
    m2 = make_mesh(*best_mesh_for(world // 2, model=2), device=dev)
    (p2, ms, st, _) = timed(lambda: reshard(reshard(params, logical, m4), logical, m2))
    if m2.member:
        same = all(torch.equal(full_tensor(a), b) for a, b in
                   zip(tree_leaves(p2), tree_leaves(params)))
    else:
        same = all(a is None for a in tree_leaves(p2))
    out["checks"]["reshard bit-equal"] = same
    say(f"(e) elastic reshard of (d)'s params {m4.shape} -> {m2.shape}: bit-equal {same} on "
        f"rank 0, {ms:.0f} ms, host-staged {st} bytes")
    del params, p2
    mark("e")

    # (f) the EP train step: reduced granite-moe on (data 2, model 2) under
    #     use_mesh (the EP branch and its backward), UserWarning an error
    #     (torch warns when it backprops through a collective with no
    #     autograd kernel), an aux weight of 1 so the aux loss's backward
    #     shows, capacity None; against the one-rank step in 2 microbatches,
    #     each a data shard of the mesh (the same objective)
    ecfg = dataclasses.replace(get_config(DIST["moe_arch"]).reduced(), router_aux_loss=1.0)
    mesh = Mesh((2, 2), ("data", "model"), device=dev)
    p0 = init_params(ecfg, gen(5), dev)
    b, s = DIST["ep_batch"]
    tk = torch.randint(0, ecfg.vocab_size, (b, s), generator=gen(6), device=dev)
    batch = {"tokens": tk, "labels": tk, "loss_mask": torch.ones((b, s), device=dev)}
    kept, losses, times = [], [], []

    def adamw_keeping(grads, *a, **k):
        kept.append([g.clone() for g in tree_leaves(grads)])
        return adamw(grads, *a, **k)

    TS.adamw_update = adamw_keeping
    try:
        for mm, mb in ((mesh, 0), (None, 2)):
            own = tree_unflatten(p0, [p.clone() for p in tree_leaves(p0)])
            run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, microbatch=mb)
            with warnings.catch_warnings(), use_mesh(mm):
                warnings.simplefilter("error", UserWarning)
                (_, _, met), ms, st, _ = timed(lambda: make_train_step(
                    ecfg, run, mesh=mm, capacity_factor=None)(own, adamw_init(own), batch, 1))
            losses.append(float(met["loss"]))
            times.append((ms, st))
    finally:
        TS.adamw_update = adamw
    rel = max(float((a - o).norm() / o.norm()) for a, o in zip(*kept))
    lrel = abs(losses[0] - losses[1]) / abs(losses[1])
    say(f"(f) EP train step, {ecfg.name} ({ecfg.num_experts} experts, top-"
        f"{ecfg.num_experts_per_tok}, aux weight 1) batch {b} x {s} on {mesh.shape}, UserWarning "
        f"an error: {times[0][0]:.0f} ms (host-staged {times[0][1]} bytes), one rank in 2 "
        f"microbatches {times[1][0]:.0f} ms; grads vs one rank, worst leaf rel by norm {rel:.3g} "
        f"(tol {DIST_EP_TOL['grads']}), loss {losses[0]:.6f} vs {losses[1]:.6f} rel {lrel:.3g} "
        f"(tol {DIST_EP_TOL['loss']})")
    out["ep_step"] = dict(grads_rel=rel, loss_rel=lrel, ms=times[0][0], one_rank_ms=times[1][0])
    out["checks"]["EP train step"] = rel < DIST_EP_TOL["grads"] and lrel < DIST_EP_TOL["loss"]
    del kept, p0, batch
    mark("f")

    # (g) the sharded train state: full-width internlm2-1.8b, every layer,
    #     on (data 2, model 2), int8 moments, one step from seed-0 params.
    #     Rank 0 first runs the one-rank step on the whole batch and keeps
    #     its loss and grads in host memory; then every rank builds its
    #     blocks (launch/train.py::build) and steps them; rank 0 receives
    #     each rank's grad blocks, one leaf at a time, and holds them to
    #     the same blocks of its grads
    out["shard"] = _dist_shard(rank, world, dev, cfg, gen, timed, say, counters)
    mark("g")
    torch.cuda.synchronize()
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    out["staged_bytes"] = C.host_staged.bytes
    out["peak_gib"] = peaks
    return out


def tree_nbytes(tree) -> int:
    """The bytes of every tensor of a tree of dicts, tuples and lists."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    return sum(tree_nbytes(v) for v in tree) if isinstance(tree, (tuple, list)) else 0


def _dist_shard(rank, world, dev, cfg, gen, timed, say, counters) -> dict:
    """Part (g) of the dist phase on one rank (``_dist_rank``): its
    figures, and on rank 0 the reference's and the grad blocks' checks."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.inputs import train_layout
    from repro_torch.launch.train import build
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.train import train_step as TS

    lead = rank == 0
    b, s = DIST["shard_batch"]
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, moments_int8=True)
    tk = torch.randint(0, cfg.vocab_size, (b, s), generator=gen(7), device=dev)
    batch = {"tokens": tk, "labels": tk, "loss_mask": torch.ones((b, s), device=dev)}
    adamw, aside = TS.adamw_update, [0.0]
    ref, res, worst = None, {}, [0.0]

    def adamw_keeping(grads, *a, **k):
        """The one-rank step's grads to rank 0's host memory; the sharded
        step's grad blocks sent to rank 0 leaf by leaf and held to the
        same blocks of them there; off the step's time."""
        nonlocal ref
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = tree_leaves(grads)
        if ref is None:
            ref = [g.to("cpu", copy=True) for g in leaves]
        else:
            for i, (g, bs) in enumerate(zip(leaves, tree_leaves(play))):
                for r in range(world):
                    if lead:
                        blk = g if r == 0 else torch.empty(g.shape, dtype=g.dtype)
                        if r:
                            dist.recv(blk, src=r)
                        coord = dict(zip(mesh.axis_names, divmod(r, mesh.shape["model"])))
                        o = ref[i]
                        for dim, entry in enumerate(bs.spec if bs.is_block(g) else ()):
                            if entry is not None:
                                o = o.narrow(dim, coord[entry] * g.shape[dim], g.shape[dim])
                        o, blk = o.to(dev), blk.to(dev)
                        worst[0] = max(worst[0], float((blk - o).norm() / o.norm()))
                        ref[i] = None if r == world - 1 else ref[i]
                        del o, blk
                    elif r == rank:
                        dist.send(g.to("cpu").contiguous(), dst=0)
        aside[0] += time.perf_counter() - t0
        return adamw(grads, *a, **k)

    def host_gib():                              # this process's host memory high-water mark
        import resource
        return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, 2)

    TS.adamw_update = adamw_keeping
    try:
        if lead:                                 # the one-rank step, the whole batch
            own, opt, step = build(cfg, run, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = step(own, opt, batch, 1)[2]
            torch.cuda.synchronize()
            res["ref_ms"] = (time.perf_counter() - t0 - aside[0]) * 1e3
            res["ref_loss"] = float(met["loss"])
            del own, opt, step, met
        else:
            ref = ()
        torch.cuda.empty_cache()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        mesh = Mesh(DIST["shard_mesh"], ("data", "model"), device=dev)
        k0 = {n: counters[n].launches for n in ("quantize", "dequantize")}
        for r in range(world):                   # one whole f32 init at a time on the card
            if r == rank:
                params, opt, step = build(cfg, run, dev, mesh)
                torch.cuda.empty_cache()
            dist.barrier()
        res["build_launches"] = {n: counters[n].launches - k0[n] for n in k0}
        res["held"] = tree_nbytes(params) + tree_nbytes((opt.m, opt.v))
        play, olay = train_layout(cfg, mesh, "int8")
        res["whole"] = sum(4 * math.prod(x.shape) for x in tree_leaves(play)) + 2 * sum(
            math.prod(q.q.shape) + 4 * math.prod(q.scale.shape) for q in tree_leaves(olay.m))
        with FakeTensorMode():                   # the dry-run's arguments on this mesh
            args, sizes, _ = D._stand_ins(cfg, ShapeConfig("g", s, b, "train"), mesh, run)
            res["want_held"] = (sizes["argument_bytes"] - D._local_bytes(D._flat(args["batch"]))
                                - 2 * D.SCALAR_BYTES)
        k0 = {n: counters[n].launches for n in ("quantize", "dequantize")}
        aside[0] = 0.0
        (params, opt, met), ms, st, _ = timed(lambda: step(params, opt, batch, 1))
        res["ms"] = ms - aside[0] * 1e3
        res["staged"], res["loss"] = st, float(met["loss"])
        res["grad_norm"] = float(met["grad_norm"])
        res["launches"] = {n: counters[n].launches - k0[n] for n in k0}
        res["peak_gib"] = round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2)
        res["host_gib"] = host_gib()
    finally:
        TS.adamw_update = adamw
    del params, opt, step, batch
    torch.cuda.empty_cache()
    if lead:
        res["grads_rel"] = worst[0]
        res["loss_rel"] = abs(res["loss"] - res["ref_loss"]) / abs(res["ref_loss"])
        say(f"(g) sharded train state, full-width {cfg.name} ({cfg.num_layers} layers) on "
            f"{mesh.shape}, int8 moments, batch {b} x {s}: rank 0 holds {res['held']} bytes of "
            f"the whole state's {res['whole']} (dry-run argument_bytes less the batch and the "
            f"step scalars: {res['want_held']}), card peak {res['peak_gib']} GiB; the step "
            f"{res['ms']:.0f} ms (one rank on the whole batch {res['ref_ms']:.0f} ms), host-staged "
            f"{res['staged']} bytes, K4a {res['launches']['quantize']} / K4b "
            f"{res['launches']['dequantize']} launches (build: K4a "
            f"{res['build_launches']['quantize']}); grad blocks vs one rank, worst leaf rel by "
            f"norm {worst[0]:.3g} (tol {DIST_SHARD_TOL['grads']}), loss {res['loss']:.6f} vs "
            f"{res['ref_loss']:.6f} rel {res['loss_rel']:.3g} (tol {DIST_SHARD_TOL['loss']})")
    return res


def phase_dist(torch, dev, card: str):
    """The multi-device path: ``DIST["ranks"]`` SPMD ranks spawned on the
    one card (``repro_torch.parallel.ranks.spawn``: gloo through host
    memory, a file rendezvous, ``DIST["timeout"]`` s for the whole run and
    each collective), one process per mesh position. (a) the collectives
    at a gradient's size; (b) context-parallel serve of full-width
    internlm2-1.8b; (c) the expert-parallel MoE of granite-moe at full
    width; (d) the compressed pod sync against the exact one; (e) the
    elastic reshard; (f) reduced granite-moe's EP train step against one
    rank's; (g) full-width internlm2-1.8b's step from the train state held
    in blocks (FSDP over data, tensor-parallel over model) against one
    rank's, each rank's held bytes against the dry-run's. Fails if any
    rank fails, hangs or a check does not hold. Returns each kernel's
    launches per rank."""
    from repro_torch.parallel import ranks
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(dev) / 2 ** 30
    import resource
    with open("/proc/meminfo") as f:
        avail = next((int(ln.split()[1]) / 2 ** 20 for ln in f
                      if ln.startswith("MemAvailable")), float("nan"))
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"[dist] before the ranks: host memory {avail:.2f} GiB available, this process's "
          f"high-water {rss:.2f} GiB, {held:.2f} GiB of card memory reserved", flush=True)
    t0 = time.perf_counter()
    got = ranks.spawn(_dist_rank, DIST["ranks"], str(ROOT), card, timeout=DIST["timeout"])
    wall = time.perf_counter() - t0
    bad = {f"rank {r}: {k}" for r, g in enumerate(got) for k, ok in g["checks"].items() if not ok}
    if any(g["cp_tokens"] != got[0]["cp_tokens"] for g in got):
        bad.add("the ranks' CP tokens differ")
    launches = {k: [g["launches"][k] for g in got] for k in got[0]["launches"]}
    peaks = ", ".join(f"({k}) {[g['peak_gib'][k] for g in got]}" for k in "abcdefg")
    most = max(sum(g["peak_gib"][k] for g in got) for k in "abcdefg")
    shard = [g["shard"] for g in got]
    ref = shard[0]
    print(f"[dist] (g) per rank: held bytes {[x['held'] for x in shard]} of {ref['whole']}, "
          f"card peak {[x['peak_gib'] for x in shard]} GiB, step ms "
          f"{[round(x['ms'], 1) for x in shard]}, host-staged bytes "
          f"{[x['staged'] for x in shard]}, K4a/K4b launches "
          f"{[(x['launches']['quantize'], x['launches']['dequantize']) for x in shard]}, "
          f"loss {[x['loss'] for x in shard]}, grad norm {[x['grad_norm'] for x in shard]}, "
          f"host memory high-water {[x['host_gib'] for x in shard]} GiB "
          f"({card}; gloo through host memory, not NVLink)")
    for r, x in enumerate(shard):
        if x["held"] - x["want_held"] != DIST_SHARD_TOL["held_bytes"]:
            bad.add(f"rank {r}: (g) holds {x['held']} bytes, the dry-run says {x['want_held']}")
        if abs(x["loss"] - ref["ref_loss"]) / abs(ref["ref_loss"]) >= DIST_SHARD_TOL["loss"]:
            bad.add(f"rank {r}: (g) loss {x['loss']} vs one rank's {ref['ref_loss']}")
        if not x["launches"]["quantize"] or not x["launches"]["dequantize"]:
            bad.add(f"rank {r}: (g) K4a/K4b did not launch in the sharded step")
    if ref["grads_rel"] >= DIST_SHARD_TOL["grads"]:
        bad.add(f"(g) grad blocks vs one rank, rel {ref['grads_rel']}")
    print(f"[dist] {DIST['ranks']} ranks in {wall:.1f} s; launches per rank {launches}; "
          f"host-staged bytes per rank {[g['staged_bytes'] for g in got]}; peak memory (GiB) "
          f"per part and rank: {peaks}, at most {most:.2f} summed over the ranks of one part; "
          f"this process keeps {held:.2f} GiB reserved ({card}; gloo through host memory, "
          "not NVLink)")
    if not all(n > 0 for n in launches["flash_attention"]) or launches["decode_attention"][0] <= 0 \
            or not all(n > 0 for n in launches["quantize"] + launches["dequantize"]):
        bad.add(f"a kernel of the path never launched: {launches}")
    if bad:
        raise AssertionError(f"dist phase failed: {sorted(bad)}")
    return launches


def start_dryrun():
    """Start the dryrun phase's subprocesses (nothing on the card): the
    prefill_32k cell of ``DRYRUN["arch"]`` on each production mesh, each
    in a process of its own, and ``DRYRUN_SCRIPT``. Returns (name,
    process, log path) triples; the processes write into a temporary
    directory and are killed when the script exits."""
    import atexit
    import os
    logs = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    spec = {k: DRYRUN[k] for k in ("arch", "moe_arch", "check_layers")}
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN["arch"],
           "--shape", "prefill_32k"]
    jobs = []
    for name, argv in (("prefill 16x16", cli), ("prefill 2x16x16", cli + ["--multi-pod"]),
                       ("cells", [sys.executable, "-c", DRYRUN_SCRIPT, json.dumps(spec),
                                  json.dumps(TRAIN)])):
        log = logs / (name.replace(" ", "_") + ".log")
        with open(log, "w") as f:
            jobs.append((name, subprocess.Popen(argv, cwd=ROOT, env=env, stdout=f,
                                                stderr=subprocess.STDOUT), log))

    def stop():
        for _, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(logs, ignore_errors=True)
    atexit.register(stop)
    return jobs


def phase_dryrun(torch, dev, jobs):
    """Wait for ``start_dryrun``'s processes and print their "[dryrun]"
    lines; then hold the dry-run to the card: the train phase's cell's
    predicted peak against the int8 run's measured peak
    (``DRYRUN["peak_tol"]``), the 2-layer cut's traced FLOPs against
    ``FlopCounterMode`` around one real step of it. Returns the real
    step's launch counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch.train import build

    deadline = T_START + DRYRUN["timeout"]
    result, bad = None, []
    for name, proc, log in jobs:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "killed at the phase's timeout"
        text = log.read_text()
        for line in text.splitlines():
            if line.startswith(("[dryrun]", "  memory_analysis", "  collectives")):
                print(line)
            elif line.startswith("DRYRUN "):
                result = json.loads(line[len("DRYRUN "):])
        if rc != 0:
            bad.append(f"{name}: exit {rc}: {text[-2000:]}")
    if bad or result is None:
        raise AssertionError(f"dryrun phase failed: {bad or 'no DRYRUN line'}")
    for name, r in result.items():
        print(f"[dryrun] the train phase's cell ({name}, groups traced {r['groups_traced']}): "
              f"{r['flops_per_chip']:.6e} FLOPs, compute {r['compute_s'] * 1e3:.3f} ms, "
              f"arguments {r['memory']['argument_bytes'] / 2 ** 30:.3f} GiB + live peak "
              f"{r['memory']['temp_bytes'] / 2 ** 30:.3f} GiB = "
              f"{r['memory']['peak_bytes'] / 2 ** 30:.3f} GiB predicted; traced in "
              f"{r['compile_s']:.1f} s")

    # memory: the whole-depth trace against the int8 train run
    measured = MEASURED["train_peak"] - MEASURED["train_held"]
    predicted = result["whole"]["memory"]["peak_bytes"]
    rel = predicted / measured - 1.0
    print(f"[dryrun] memory: predicted peak {predicted / 2 ** 30:.3f} GiB (depth fit "
          f"{result['fit']['memory']['peak_bytes'] / 2 ** 30:.3f}) against the int8 train "
          f"run's {measured / 2 ** 30:.3f} GiB ({MEASURED['train_peak'] / 2 ** 30:.3f} peak less "
          f"{MEASURED['train_held'] / 2 ** 30:.3f} held before it): {100 * rel:+.2f}% "
          f"(tol {100 * DRYRUN['peak_tol']:.0f}%)")
    if not abs(rel) <= DRYRUN["peak_tol"]:
        raise AssertionError(f"the dry-run's peak is {100 * rel:+.2f}% off the measured one")

    # FLOPs: one real step of the 2-layer cut on the card
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), num_layers=DRYRUN["check_layers"])
    run = RunConfig(learning_rate=TRAIN["lr"], microbatch=TRAIN["microbatch"],
                    moments_int8=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN["batch"], TRAIN["seq"]), generator=gen,
                           device=dev, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
             "loss_mask": torch.ones(tokens.shape, device=dev)}
    params, opt, step_fn = build(cfg, run, dev)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    with FlopCounterMode(display=False) as fc:
        _, _, metrics = step_fn(params, opt, batch, 0)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    real, traced = fc.get_total_flops(), result["cut"]["flops_per_chip"]
    print(f"[dryrun] FLOPs of one train step of {cfg.name} cut to {cfg.num_layers} layers, "
          f"{TRAIN['batch']} x {TRAIN['seq']}: traced {int(traced)}, counted on the card "
          f"{real} (loss {float(metrics['loss']):.6f}; launches {launches})")
    if not (real == traced > 0 and math.isfinite(float(metrics["loss"]))):
        raise AssertionError(f"traced FLOPs {traced} != the card's {real}")
    del params, opt, step_fn, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()

    return launches


def phase_timer():
    """``lap(name)`` prints the seconds since the last lap (the first
    since the script started) and since the script started."""
    last = [T_START]

    def lap(name: str) -> None:
        now = time.perf_counter()
        print(f"[time] {name}: {now - last[0]:.1f} s (script so far {now - T_START:.1f} s)")
        last[0] = now
    return lap


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this smoke test runs only on a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
                    "from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    lap = phase_timer()

    # 1. device. TF32 off: the plain versions' f32 products stay exact.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    dev = torch.device("cuda", 0)
    print(smi[0])
    print(f"[device] {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s), torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; TF32 off for matmul and cuDNN")

    # the dryrun phase's traces run in subprocesses beside every phase
    dryrun_jobs = start_dryrun()

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {sorted(built) or 'nothing new'} in {time.perf_counter() - t0:.2f} s "
          f"(per kernel, all at once: {{{', '.join(f'{k}: {v:.2f}' for k, v in built.items())}}})")
    for name in _build.SIGNATURES:
        log = _build.build_log(name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[build] {name}: {len(regs)} kernel instances, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)} per thread, "
              f"spill stores up to {max(spills, default=0)} bytes (ptxas -v)")
    # K1's tensor-core kernel per instance: <head dim, softcap>
    wg = re.findall(r"Compiling entry function '\w*fa_fwd_wgmma_kernelILi(\d+)ELb([01])E[^']*'"
                    r".*?(\d+) bytes spill stores.*?Used (\d+) registers",
                    _build.build_log("flash_attention"), re.S)
    print("[build] flash_attention wgmma kernel: " + ", ".join(
        f"hd {hd}{' softcap' if cap == '1' else ''}: {r} registers, {sp} bytes spilled"
        for hd, cap, sp, r in wg))
    # every bf16 head dim of the model zoo on the tensor cores, none spilled
    if sorted((int(hd), cap) for hd, cap, _, _ in wg) != [
            (hd, cap) for hd in (64, 128, 256) for cap in "01"] or any(int(sp) for _, _, sp, _ in wg):
        raise AssertionError(f"flash_attention's wgmma instances are not hd 64, 128 and 256 "
                             f"with and without a softcap, each unspilled: {wg}")

    # K2 per instance: <cache dtype, head dim(, groups)>, CUDA-core and
    # tensor-core split passes; none may spill
    dec = re.findall(r"Compiling entry function '\w*?(decode_split(?:_tc)?_kernel)I(f|13__nv_bfloat16)"
                     r"Li(\d+)E(?:Li(\d+)E)?[^']*'.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                     _build.build_log("decode_attention"), re.S)
    print("[build] decode_attention: " + ", ".join(
        f"{'tc' if 'tc' in k else 'cuda-core'} {'bf16' if 'bf16' in t else 'f32'} hd {hd}"
        f"{f' G {g}' if g else ' G 16'}: {r} registers, {sp} bytes spilled"
        for k, t, hd, g, sp, r in dec))
    if len(dec) != 2 * 3 * 5 or any(int(sp) for *_, sp, _ in dec) or \
            sum("tc" in k for k, *_ in dec) != 2 * 3:
        raise AssertionError(f"decode_attention's instances are not f32 and bf16 x hd 64, 128 "
                             f"and 256 x G 1, 2, 4, 8 on the CUDA cores and 16 on the tensor "
                             f"cores, each unspilled: {dec}")

    # 3. kernels
    lap("device and build")
    rows = phase_kernels(torch, dev)
    lap("kernels")

    # 4. serve: internlm2 (K1, K2), then mamba2 (K3) once internlm2's
    #    engine is freed
    launches, sync = phase_serve(torch, dev, "internlm2-1.8b",
                                 ("flash_attention", "decode_attention"))
    lap("serve internlm2-1.8b")
    gc.collect()
    staged_launches = phase_staged(torch, dev, sync)
    del sync
    lap("serve staged internlm2-1.8b")
    gc.collect()
    torch.cuda.empty_cache()
    launches_ssm = phase_serve(torch, dev, "mamba2-2.7b", ("ssd_scan",))[0]
    lap("serve mamba2-2.7b")
    gc.collect()
    torch.cuda.empty_cache()

    # 5. train: internlm2 with int8 AdamW moments (K4a, K4b), then f32
    launches_train = phase_train(torch, dev)
    lap("train internlm2-1.8b")
    gc.collect()
    torch.cuda.empty_cache()

    # 6. train_cluster: fail, detect, resize, restore and resume (K4a, K4b)
    launches_cluster = phase_train_cluster(torch, dev)
    lap("train_cluster internlm2-1.8b")
    gc.collect()
    torch.cuda.empty_cache()

    # 7. colocate: a serve tenant (K1, K2) beside a train tenant (K4a, K4b)
    launches_coloc = phase_colocate(torch, dev)
    lap("colocate internlm2-1.8b")
    gc.collect()
    torch.cuda.empty_cache()

    # 8. zoo: every other arch one card holds, served through K1 and K2
    launches_zoo, zoo_by_arch = phase_zoo(torch, dev)
    lap("zoo")
    gc.collect()
    torch.cuda.empty_cache()

    # 9. dist: SPMD ranks on the card (K1, K2, K4a, K4b)
    launches_dist = phase_dist(torch, dev, smi[0])
    lap("dist")

    # 10. dryrun: the traces started at the top, held to the card
    launches_dryrun = phase_dryrun(torch, dev, dryrun_jobs)
    lap("dryrun")

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:28",
             launches=launches["flash_attention"],
             staged_launches=staged_launches["flash_attention"],
             colocate_launches=launches_coloc["flash_attention"],
             zoo_launches=launches_zoo["flash_attention"],
             dist_launches=launches_dist["flash_attention"],
             dryrun_launches=launches_dryrun["flash_attention"],
             shape=f"B=1 S={s} Hq=16 Hkv=8 hd=128 bf16",
             **rows[("flash_attention", s)])
        for s in FA_PATH_LENS
    ] + [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:28",
             launches=launches["flash_attention"],
             staged_launches=staged_launches["flash_attention"],
             colocate_launches=launches_coloc["flash_attention"],
             zoo_launches=launches_zoo["flash_attention"],
             dist_launches=launches_dist["flash_attention"],
             dryrun_launches=launches_dryrun["flash_attention"],
             arch=arch, arch_zoo_launches=zoo_by_arch[arch]["flash_attention"],
             **rows[("flash_attention", arch, s)])
        for arch, *_, lens in ZOO_FA_CASES for s in lens
    ] + [
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:26",
             launches=launches["decode_attention"],
             staged_launches=staged_launches["decode_attention"],
             colocate_launches=launches_coloc["decode_attention"],
             zoo_launches=launches_zoo["decode_attention"],
             dist_launches=launches_dist["decode_attention"],
             dryrun_launches=launches_dryrun["decode_attention"],
             **({} if arch is None else
                dict(arch=arch, arch_zoo_launches=zoo_by_arch[arch]["decode_attention"])),
             **rows[("decode_attention", key)])
        for key, arch in [("path", None)] + [(n, None) for n in DEC_FILLS] + [
            (f"{a} path", a) for a in ["glm4-9b", *(c[0] for c in ZOO_DEC_CASES)]] + [
            (f"glm4-9b fill {n}", "glm4-9b") for n in GLM4_FILLS]
    ] + [
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:28",
             launches=launches_ssm["ssd_scan"], colocate_launches=launches_coloc["ssd_scan"],
             zoo_launches=launches_zoo["ssd_scan"],
             dist_launches=launches_dist["ssd_scan"],
             dryrun_launches=launches_dryrun["ssd_scan"],
             shape=f"B=1 S={s} H=80 P=64 N=128 bf16",
             **rows[("ssd_scan", s)])
        for s in SSD_PATH_LENS
    ] + [
        dict(name="quantize", route="cuda",
             source="src/repro_torch/kernels/csrc/quant.cu",
             replaces="src/repro/kernels/quant/kernel.py:15",
             launches=launches_train["quantize"],
             cluster_launches=launches_cluster["quantize"],
             colocate_launches=launches_coloc["quantize"],
             zoo_launches=launches_zoo["quantize"],
             dist_launches=launches_dist["quantize"],
             dryrun_launches=launches_dryrun["quantize"], **rows["quantize"]),
        dict(name="dequantize", route="cuda",
             source="src/repro_torch/kernels/csrc/quant.cu",
             replaces="src/repro/kernels/quant/kernel.py:22",
             launches=launches_train["dequantize"],
             cluster_launches=launches_cluster["dequantize"],
             colocate_launches=launches_coloc["dequantize"],
             zoo_launches=launches_zoo["dequantize"],
             dist_launches=launches_dist["dequantize"],
             dryrun_launches=launches_dryrun["dequantize"], **rows["dequantize"]),
    ]
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite measurement for {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
