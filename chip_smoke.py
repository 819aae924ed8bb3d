#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA
H100: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:
  1. print the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc with nvcc and print the build time, and
     the registers, spills and HGMMA (tensor-core) instruction count of the
     redesigned kernels: both K7 routes (the bf16 tensor-core kernel and
     the f32 CUDA-core one) and the staged row walk of K2 and K3 (ptxas's
     report and cuobjdump -sass), and for K2's staged walk (width 1024)
     and the f32 K7 (the prefill's 3 query heads a kv head) the launch's
     shared memory and resident CTAs an SM; the bf16 flash-attention kernel
     must hold HGMMA;
  2. hold each kernel against its plain PyTorch version, exactly, and time
     kernel, plain version, bound and (where one exists) a library call:
     K1 block_topk on the 8-client layers/mlp/w_up stack (614,400 rows of
     1024, f32, k 16), at a ragged length (f32 and bf16) and at narrow odd
     blocks (13 and 51), with torch.topk + scatter timed beside it as a
     yardstick only (it keeps exactly k, another tie rule); K2
     ef21_sgdm_update, K3 ef21_sgdm_topk_quant at 8 and 4 bits, each with
     f32 and with bfloat16 EF state (on the staged kernel: the launchers'
     rule is asked and must say so), and K4
     dequant_add at the shapes the fused path gives them (the
     layers/mlp/w_up leaf, 8 clients folded into rows of 1024), K4 also
     at path B's downlink shape (one copy of the leaf in rows of 256); K5
     block_quantize and K6 block_dequantize at 8 and 4 bits at every width
     the quantized carriers give them (16, 51, 256, 1024 and one row of
     2,359,296) and at the cases of each of their three mappings (rows of
     16, 32, 256 and 1024 with a partial last pass, a base off a 16-byte
     boundary, odd widths 1, 17 and 51), each with an all-zero row and
     inf/NaN inputs, then timed where the main paths run them (A's two
     sparse payloads, B's dense payload both ways, the fused path's K6 up
     and K5 down), by CUDA events around the wrapper and by the profiler's
     kernel rows; and the wide route of K1-K3 (rows wider than 1024,
     csrc/wide.cuh), bit for bit: K2 and K3 (bits 8 and 4, f32 and bf16
     state) on rows of 2048, 3000, 65,536 and 1,048,576 (the last two
     past one CTA's shared memory), K1 at blocks 2048, 4097 (ragged),
     65,536 and 1,048,576, each on the layout the launcher names
     (``ops.ef_layout``, ``ops.topk_layout``), and all three on the
     8-client w_up stack in rows of 4096 (k 64), timed there against
     their bounds (K1 beside torch.topk + scatter);
  2b. the K1 path: the public wrapper ops.block_topk (the reference's
     ops.block_topk, which its kernel bench drives; nothing in training
     calls it) on the 8-client w_up stack, one launch;
  3. check the paths against a reference on a small input: smoke-size
     Sessions on the card and on the CPU (the CPU runs the plain versions,
     which the CPU tests hold against the JAX package) agree for 2 steps,
     with fused_quant8/fused_quant4, with quant8/quant4, with
     quant8/quant4 under the identity compressor, on the dense plan
     (the clients in one pass) with block_quant and with block_topk, and
     for the shipped mixed_schedule, sampled_quarter and
     hierarchy_quant4_cross specs; the card's run must launch each path's
     kernels. Then two checks torch against torch on the card, bit for
     bit over two rounds: a one-group schedule against the ungrouped
     fused_quant8/fused_quant4 round, and a fraction-1.0 cohort against
     the full round on carrier fused;
  4. main path A: full-width smollm-360m, 8 clients, EF21-SGDM with
     Block-TopK, carrier quant8 up and quant4 down (the sparse payload both
     ways), 3 training steps;
  5. main path B: the same with the identity compressor (the dense
     payload, K4 on the downlink), 2 steps;
  6. the fused paths: carrier fused_quant8 up and fused_quant4 down, 3
     steps, then one more step timed and one under torch.profiler after
     one that warms the tracer up (device busy ms, idle share, the five
     ops with the most device time); and
     carrier fused, 2 steps, after which the live training tree
     serves one small batch (batch 2, prompt 256, 8 decode steps) whose
     first token must be the argmax of a prefill with the trained params;
  6b. the resumable path: full-width smollm-360m cut to 2 of its 32
     layers (RESUME_CUT: the script's time limit), 8 clients,
     bf16 EF state, AdamW at lr 1e-3, fused_quant8 up and fused_quant4
     down; 2 steps, a save (about 5.6 GB on disk, in a temporary directory
     that is deleted at the end), per-leaf checksums of params, opt_state and ef_state, step
     3; then a new Session from Session.resume, whose checksums must equal
     the saved ones exactly and whose step 3 must match within rtol 1e-3;
     prints step ms, peak bytes, the EF state's bytes (exactly half of
     f32's), the checkpoint's bytes and the save and restore seconds;
  6c. the grouped, sampled and two-tier rounds at full width (d_model
     960, weights from seed 0; cut to 8 of the 32 layers, GMSH_CUT, to
     make room for W), 3 steps each, each printing what it
     adds (the resolved group table with its wire words, the cohort, the
     cross-pod and flat words a round): G, fused_quickstart's 8 clients
     with the norms dense and the embedding and the matrices on
     fused_quant8 up and fused_quant4 down, the embedding's EF state in
     bf16; M, mixed_schedule.json with smoke off (4 clients, batch 8, seq
     64); S, carrier fused with sampled participation (fraction 0.25, seed
     7): each step's cohort, and every non-sampled client's v and g
     bit-unchanged on the card (a bit-sum per client and leaf before and
     after the step), every sampled one moved; H,
     hierarchy_quant4_cross.json with smoke off (8 clients, 2 pods, the
     quant4 cross hop); W, fused_quickstart's 8 clients at Block-TopK
     block 4096 (k 64: K3 on the wide route, the downlink's K5 and K4 on
     rows of 4096), fused_quant8 up and fused_quant4 down, recompute on, 2
     steps, every K3-K6 call of the steps held bit for bit against its
     plain version on random inputs of its shapes;
  6d. phase R, block recompute: full-width smollm-360m, 8 clients,
     fused_quant8 up and fused_quant4 down, one step with ``cfg.remat``
     off and one with it on, each from seed 0 (the batch-0 gradients under
     its own setting): params and every EF state leaf equal bit for bit,
     the peak lower with recompute; each run's step ms and peak, and the
     client pass alone (median of 3) with its ms and peak. Phase DR: the
     dry run of the step with recompute on (``Session.lower``: the
     Session's own step traced on meta tensors, launch/trace_analysis.py)
     before it runs: its argument bytes must equal the live state's and
     the step batch's exactly, its kernel launches the step's
     ``ops.launches``, and its predicted peak (arguments + the trace's
     temporaries) must lie within DR_PEAK_TOL of the step's
     ``torch.cuda.max_memory_allocated``; the trace's seconds, FLOPs and
     both peaks printed;
  6e. the other configs: h2o-danube-3-4b, granite-34b, gemma2-9b,
     musicgen-medium, olmoe-1b-7b, falcon-mamba-7b, zamba2-1.2b,
     internvl2-76b, grok-1-314b and olmoe on the dense-expert
     ``moe_impl``, at smoke size on the card against the CPU through
     phase 7's check (f32, a sequence of 160 past the smoke window of
     128, or for the two SSM archs 192, three chunks of their smoke
     scan's 64: under MoE the chosen experts of every layer
     equal at the fresh weights on batch 0; 2 fused_quant8/fused_quant4
     steps within rtol 1e-3, then both serve the CPU's trained tree, a
     prefill (after a frontend's prefix) and 8 decode steps: the chosen
     experts equal, greedy tokens equal, prefill logits within rtol
     1e-4); then each D cell at full width cut in depth and clients (the
     Session's config replaced before the first step), D_STEPS (2) steps
     of fused_quant8/fused_quant4 and a serve of the trained model:
     D-danube 2 layers, 8 clients, serve batch 2, prompt 6144 (past the
     4096 window: the banded prefill and the ring cache wrap), 32 decode
     steps; D-granite 1 layer, 4 clients, serve batch 8, prompt 1024, 32
     decode steps (K7 in the prefill: 48 query heads on 1 kv head, hd
     128); D-gemma2 2 layers (one [local, global] super-layer), 2
     clients, serve batch 2, prompt 6144, 32 decode steps; D-musicgen 6
     layers (cut from 12 for time), 8 clients, a training prefix of 8 zero rows
     (frontend_proj's params and EF state bit-unchanged after every step:
     its gradient is exactly zero), serve batch 8, prompt 1024 after a
     prefix of 64 (K7 6 times a prefill); D-olmoe 1 layer of 64 experts (top 8), 8
     clients, each step's aux values (every client's dropped_frac) from a
     forward of the step's batch, serve batch 8, prompt 1024 with the
     prefill's and decode's drop fractions; D-falcon-mamba 1 of 64
     Mamba1 layers (371,646,464 parameters), 8 clients, serve batch 8,
     prompt 1024 (two scan chunks of 512), no K7; D-zamba2 13 of 38
     layers (two groups of 6 Mamba2 blocks, each ending in the shared
     attention block, and a tail block; 465,220,544 parameters), 8
     clients, serve batch 8, prompt 1024 (K7 twice a prefill, once an
     application of the shared block); D-internvl2 1 layer (1.97 B
     parameters), serve only (training does not fit the card): a fresh
     init drawn, placed and cast (timed apart), serve batch 8, prompt
     1024 after a prefix of 256, no training state built. Each prints
     its parameters, peak, step breakdown, launches, prefill and decode
     tok/s and cache_bytes; K7's launches a prefill are the layers whose
     prefill runs it (``model.flash_layers``: no window, no soft cap, hd
     32, 64 or 128), on every serving path. The shapes of each D phase's
     K3-K6 calls are recorded, and once its Session is freed every
     distinct call runs again on random inputs of its shapes and is held
     bit for bit against its plain version (gemma2's embedding: K3 and K6
     on 1,792,000 rows, K5 and K4 on 896,000);
  6f. phase P, the paper's simulator (core/simulate.py, core/problems.py,
     participation.run_async) at the experiments' shapes, each run's
     launches equal to ``expected_launches`` of its EF config a round, its
     ms a step, one round's device busy ms and idle share under
     torch.profiler (the mean of 5 rounds after 5 that warm the tracer
     up), its peak bytes and ‖∇f‖²,
     and one more round with every kernel wrapper's call recorded and held
     bit for bit against the plain version on the same inputs (each
     kernel at the widths, k and row counts the run gives it):
     P-fig1 (Theorem 1's
     quadratic, Top-1, n 1 and 8, EF21-SGD and EF21-SGDM, 8000 steps, 2
     seeds at n 1 and 1 at n 8; Figure 1's inequalities must hold),
     P-exp1 (logistic
     regression at MNIST's shape, EF21-SGDM with BlockTopK(1024, 1) on
     carriers fused and quant4 at B 1 and 128, 500 steps), P-async
     (run_async on P-exp1's problem, heavy-tailed arrivals, 20 rounds: the
     events equal a CPU run's and beat the barrier), P-exp3 (Algorithm 2's
     quadratics at n 100, d 1000, EF14 and EF21-SGDM, TopK 50, 1000 steps),
     P-exp4 (the MLP at CIFAR-10's width and d 10,510,346 on fused_quant8
     up and fused_quant4 down, B 32, 100 steps), and the simulator free of
     randomness on card and CPU (fused, fused_quant8/fused_quant4, quant4;
     50 steps within rtol 1e-3); then phase P-rates: the paper's Tables
     1-2 (experiments/complexity_check.py at Ts 500/2000/8000, 66,000
     rounds): the log-log slopes of EF21-SGDM's running-average ‖∇f‖²
     against T with σ 0 and σ 1, both claims must hold;
  7. serving, card against CPU at smoke size (f32 activations, the same
     fresh weights): the greedy tokens must be equal and the prefill
     logits agree within rtol 1e-4;
  8. serving full-width smollm-360m from fresh weights: batch 8, prompt
     1024, 32 decode steps, nothing cut, twice (the second reading is free
     of warm-up); K7 must launch exactly 32 times in the prefill (once a
     layer) and never in decode; then torch.profiler reads one more
     prefill and two decode steps, each after as many that warm the
     tracer up, on the tree serve() ran (its matrices
     cast to bf16 once for the params version): device busy time, the
     decode's idle share, device time by op and of aten::copy_. Then one
     f32 prefill of the same fresh weights and prompts
     (Session(spec, dtype="float32")): K7's f32 route must launch exactly
     32 times and the logits must be finite; torch.profiler reads one more
     such prefill after one that warms the tracer up: device busy ms and
     K7's kernel row, which must hold its 32 launches;
  F. the wire stream and the serving fleet (core/stream.py,
     launch/transport.py, launch/fleet.py, launch/replica_worker.py):
     full-width smollm-360m on fused_quant8 up and fused_quant4 down, 2
     clients (F_CLIENTS: the script's time limit), publishes into a
     temporary stream directory (a bootstrap at step 0, about 10 GB,
     deleted at the end; it needs 40 GB free), then
     3 steps, each published (re-encoded, verified bit for bit against the
     step's own h, written as npz; publish ms, of it the npz write, the
     record's bytes against a dense f32 push); two in-process replicas
     (launch/fleet.py ServeReplica, lags 0 and 1) join from the bootstrap
     and after every sync equal the trainer's post-step params at their
     step (torch.equal, all 11 leaves; apply ms); Fleet.run serves 16
     requests of 1024 tokens, 8 new, decode budget 64, batches of 8
     (every request completes, each batch's first tokens the argmax of a
     prefill under that replica's params, K7 32 launches a prefill; p50,
     p99, staleness); the trainer takes a step while r0 decodes with
     continuous sync (mid_applied at least 1, params equal after); one
     publish's K5 and K4 calls and one replica apply's K4 calls are
     recorded and held bit for bit against kernels/ref.py, their counts
     derived from the EF config (``stream_launches``); two worker
     processes on the card (lags 0 and 1) digest-match the trainer, serve
     8 requests while one is killed by SIGKILL and restarted, and
     digest-match again; a smoke-size stream (quant8 up, quant4 down: K6
     in each apply) served over a TailServer on loopback, a tcp:// replica
     and a directory replica equal to the trainer bit for bit; the phase's
     seconds, peak bytes, bootstrap and join seconds.
  6h. phases MD1 and MD4, the multi-device runtime (one client a rank,
     core/distributed.py::ef_round_sharded over torch.distributed):
     MD1, an NCCL world of one in this process: ef_round_sharded called
     directly on full-width smollm-360m leaves for fused_quant8/
     fused_quant4, fused_quant4/fused_quant4, quant8/quant4 and quant8
     with overlap, each bit for bit the single-device round of one client
     (its initial state too), its launches the derived counts, and a
     checkpoint's gather_to_first on NCCL; MD4, 4 rank
     processes (launch/multiproc.py::spawn, gloo, the card shared, the
     kernels built once here), full-width smollm-360m cut to 2 of its 32
     layers (MD_CUT: the script's time limit), 2 steps a run:
     results/specs/fused_quant8_overlap.json (mesh pod: data 4, model 1),
     quant8 with the overlap ring and with the blocking gather (the same
     bits), and mesh multi_pod (pod 2, data 2) with
     hierarchy_quant4_cross.json's hops; every rank's loss, g_norm and
     replicated-state digest equal after every step, each run within
     MD_TOL of the same spec's single-process run on the smoke mesh with
     4 clients, each rank's launches the derived counts, rank 0's
     distinct K3-K6 calls (every rank's have its shapes) bit for bit their
     plain versions; per rank the step ms,
     the EF round's ms and its collectives' share, the bytes on the wire
     and staged through the host a step, the peak; which gloo collectives
     take CUDA tensors, and an all-reduce of the embedding leaf by gloo's
     CUDA route and by the host staging. Then MD4_FAULTS's planted faults
     (the round's collectives keeping the local client alone, on the
     fused and the quant8 wire; parameters put back after every step)
     must each read above MD_TOL on every rank. MD4-publish:
     fused_quant8 up and fused_quant4 down on (data 4, model 1), full
     width cut as the runs, rank 0 publishing a bootstrap and one
     step's record (its re-encode's and verify's K5 and K4 calls among
     rank 0's, held to their plain versions); a single-device replica
     (launch/fleet.py) joins from the stream in this process, applies the
     record (each K4 call held to its plain version) and must hold the
     trainer's params bit for bit; the bootstrap s, publish ms, the
     record's bytes, the join and apply s.
  6i. phase MT, the 'model' axis: 4 rank processes sharing the card over
     gloo on (data 2, model 2) (the production geometry narrowed in each
     rank), full-width smollm-360m cut to 2 of its 32 layers
     (MT_SMOLLM_CUT: the script's time limit), 8 rows of 256 a client, f32
     EF state,
     recompute on, fused_quant8/fused_quant4: 2 steps with tp_pad_heads 2
     (16 heads, 8 a rank) and 1 without (15 heads, attention replicated).
     At the initial parameters each rank's gradient shards are held, in
     f32, against the unsharded pass of its rows in the same process
     (MT_GRAD_TOL), and two planted faults (Megatron's f the identity
     both ways; a replicated leaf's gradient summed over 'model') must
     read above it; every round's client state is bit for bit the
     single-device ef_round over the rank's shard tree; loss and g_norm
     equal on every rank, the replicated state's digest equal among the
     ranks of a 'model' coordinate every step; the launches the derived
     counts; rank 0's distinct K3-K6 calls bit for bit their plain
     versions; per rank the step ms, the EF round's ms and its
     collectives' share, the client pass's 'model' collectives and their
     ms, and the peak beside MD4's. The same for the SSM families at full
     width cut in depth, 1 step each: MT-falcon-mamba (1 of its 64 Mamba1
     layers, d_inner split: in_proj's x and z re-split among the ranks)
     and MT-zamba2 (6 of its 38 Mamba2 layers and the shared block once,
     d_inner, heads and the shared block split), each with one more
     planted fault (the f after Mamba1's x_proj sum dropped; the f on
     Mamba2's split out_norm mean square dropped). MT-serve: after
     its step MT-replicated's 4 ranks serve its trained params, batch 8 of
     1024 prompt tokens and 8 decode steps (4 rows a data rank, K7 on
     every rank's (4, 1024, 15, 5, 64) once a layer, 2 a prefill), and
     so do
     MT-falcon-mamba and MT-zamba2 (8 decode steps; K7 once on the shared
     block's (4, 1024, 16, 16, 64)): tokens equal on every rank; against
     rank 0's single-device serve of the same params (gathered over
     'model') and prompts the prefill logits within SERVE_BF16_TOL of each
     row's largest and every first token equal, the decode tokens that
     agree counted; the prefill's and a decode step's 'model'
     collectives, the times, the global and per-rank cache bytes and the
     peak. Each rank's cache bytes must be its shard in the reference's
     layout (``shardings.cache_pspecs``): smollm's 5 kv heads do not
     divide 'model', so its sequence splits over 'model' (5,283,840
     bytes a rank at 2 layers and 1032 slots; 43,253,760 at 16 layers and
     1056); then MT-replicated's ranks serve one row
     (MT_SERVE_B1: B 1 does not divide the data ranks, so every rank
     serves it and the sequence splits over all four), held to the
     single-device serve as above. Each MT-serve run prints the
     yardstick, one device's bf16 prefill against its f32 prefill; the
     dense runs the split's own rounding (:func:`f32_partials`: the
     prefill again on the 4 ranks with each rank's MLP w_down partial
     product summed in f32, against one device). Then granite-34b,
     gemma2-9b, olmoe-1b-7b, falcon-mamba-7b and zamba2-1.2b at smoke size
     on (data 2, model 2), the card within P_TOL of the CPU over 2 steps,
     and each serving a fresh f32 tree of its seed (4 rows, 4 decode
     steps), card against CPU: greedy tokens and every MoE call's drop
     count equal, prefill logits within P_SERVE_TOL; and MT-single:
     MT-padded's spec on one device with 2 clients (no 'model' axis), as
     many steps, its losses printed beside MT-padded's.
Phase 2 also holds K7 flash_attention against its plain version within
2e-5 (f32) and 2e-2 (bf16) at the smoke shape, the full-width prefill's
shape (B 8, S 1024, H 15, KV 5, hd 64) in bf16 and f32, each D phase's
prefill in bf16 (granite-34b's B 8, S 1024, H 48, KV 1, hd 128;
musicgen-medium's 8, 1088, 24, 24, 64; olmoe-1b-7b's 8, 1024, 16, 16,
128; internvl2-76b's 8, 1280, 64, 8, 128; zamba2-1.2b's shared block's 8,
1024, 32, 32, 64), MT-serve's prefills on a rank (FLASH_MT: smollm's 4,
1024, 15, 5, 64 and zamba2's shared block's 4, 1024, 16, 16, 64), a
ragged S of 1000, hd 128
and hd 32; the bf16 (tensor-core) route also within a stated
elementwise bound of the plain version that rounds P as it does
(round_p=True); and times both routes at the full-width shape, and the
bf16 route at each D phase's prefill, beside the library's
scaled_dot_product_attention in the same dtype (a yardstick, never the
path), the two in turns over three rounds, medians kept.
Each training or serving path resets the launch counts just before it,
checks that every kernel launched exactly as often as the path's code
calls it (and the others not at all; a training path's counts are derived
from its EF config by ``expected_launches``: per group of a schedule, per
leaf its plans, per pod its cross hop), that losses, parameters and logits
are finite, and prints its times, peak memory and step breakdown. Then the
script prints a ``kernels`` JSON line (each kernel's launches on the main
path and, under ``launches_by_phase``, on phases G, M, S, H, W, R, the D
phases, each cell of P, F, MD1, MD4 and MT (summed over ranks)), the card
line, and the final ``{"ok": true, ...}`` line. Imports nothing of JAX or
of src/repro.
"""
import contextlib
import dataclasses
import gc
import inspect
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

# as the training CLI (repro_torch/launch/train.py) sets it: near a
# training path's peak, fixed segments make the caching allocator free its
# cache and retry (a synchronize each)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
SPECS = os.path.join(ROOT, "results", "specs")
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (published)
F32_OPS_S = 67e12              # H100 SXM f32 outside the tensor cores
BF16_TC_OPS_S = 989e12         # H100 SXM bf16 tensor cores, dense
CLIENTS, BLOCK = 8, 1024
W_UP = (32, 960, 2560)         # layers/mlp/w_up of full-width smollm-360m
QBLOCK = 256                   # the quantized carriers' dense-payload row
TOPK_EMBED_K = 2_359_296       # plain TopK's k at ratio 0.05 on the embed leaf
SERVE_FULL = dict(batch=8, prompt_len=1024, decode_steps=32)
FLASH_FULL = (8, 1024, 15, 5, 64)   # (B, S, H, KV, hd) of its prefill
FLASH_GRANITE = (8, 1024, 48, 1, 128)   # phase D-granite's prefill
FLASH_MUSICGEN = (8, 1088, 24, 24, 64)  # D-musicgen's: a prefix of 64
FLASH_OLMOE = (8, 1024, 16, 16, 128)    # D-olmoe's
FLASH_INTERNVL2 = (8, 1280, 64, 8, 128)  # D-internvl2's: a prefix of 256
FLASH_ZAMBA2 = (8, 1024, 32, 32, 64)    # D-zamba2's shared block, twice
# K7 at each D phase's prefill shape, bf16: (results key, shape, phase)
FLASH_D = [("flash_attention/granite", FLASH_GRANITE, "D-granite"),
           ("flash_attention/musicgen", FLASH_MUSICGEN, "D-musicgen"),
           ("flash_attention/olmoe", FLASH_OLMOE, "D-olmoe"),
           ("flash_attention/internvl2", FLASH_INTERNVL2, "D-internvl2"),
           ("flash_attention/zamba2", FLASH_ZAMBA2, "D-zamba2")]
# K7 at MT-serve's prefills on (data 2, model 2), bf16: 4 rows a data
# rank (the one-row serve: its row on every rank); smollm's 15 heads whole
# on every rank (they do not split over 2), zamba2's shared block on its 16
# of 32 heads: (results key, shape, run)
FLASH_MT = [("flash_attention/mt_smollm_b1", (1, 1024, 15, 5, 64),
             "MT-replicated B1"),
            ("flash_attention/mt_smollm", (4, 1024, 15, 5, 64),
             "MT-replicated"),
            ("flash_attention/mt_zamba2", (4, 1024, 16, 16, 64),
             "MT-zamba2")]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the resumable path: bf16 EF state and AdamW on the fused quantized wire
RESUME_PATH = dict(carrier="fused_quant8", downlink_carrier="fused_quant4",
                   ef_state_dtype="bfloat16", optimizer="adamw", lr=1e-3)
# its depth cut, full width (the script's time limit; the
# save and the restore of 32 layers took 40 and 54 s, of 16 layers 24 and
# 34 s, of 4 layers 11 and 20 s): 2 of smollm's 32 layers, the leaves and
# the kernels' launches unchanged
RESUME_CUT = {"num_layers": 2}
# phases R and D: the fused quantized wire, fused_quant8 up and
# fused_quant4 down, on fused_quickstart.json
R_PATH = dict(carrier="fused_quant8", downlink_carrier="fused_quant4")
# phase DR: the dry run's predicted peak (its arguments and the trace's
# temporaries, in PyTorch's eager order) against the step's measured
# max_memory_allocated, as a share of the measured. A sound trace read
# -0.15 % on an H100 80GB HBM3 (PERF.md, phase DR); the smallest buffer the
# step holds whole, one client's v or g (1,447,284,480 bytes), is 3.1 % of
# the peak, so a trace that leaves one out fails.
DR_PEAK_TOL = 0.01
# 2 steps (3 before phase P-rates: the script's time limit)
D_STEPS = 2
D_CELLS = [  # (phase, arch, depth cut, clients or None: serve only, serve)
    ("D-danube", "h2o-danube-3-4b", {"num_layers": 2}, 8,
     dict(batch=2, prompt_len=6144, decode_steps=32)),
    ("D-granite", "granite-34b", {"num_layers": 1}, 4,
     dict(batch=8, prompt_len=1024, decode_steps=32)),
    ("D-gemma2", "gemma2-9b", {"num_layers": 2}, 2,
     dict(batch=2, prompt_len=6144, decode_steps=32)),
    # 6 of 48 layers (12 before: the script's time limit)
    ("D-musicgen", "musicgen-medium", {"num_layers": 6}, 8,
     dict(SERVE_FULL)),
    ("D-olmoe", "olmoe-1b-7b", {"num_layers": 1}, 8, dict(SERVE_FULL)),
    # Mamba1, attention-free: no K7
    ("D-falcon-mamba", "falcon-mamba-7b", {"num_layers": 1}, 8,
     dict(SERVE_FULL)),
    # two groups of 6 Mamba2 blocks, each ending in the shared attention
    # block (applied twice: its gradient sums both), and a tail block
    ("D-zamba2", "zamba2-1.2b", {"num_layers": 13}, 8, dict(SERVE_FULL)),
    # 1.97 B parameters at one layer: training does not fit the card
    ("D-internvl2", "internvl2-76b", {"num_layers": 1}, None,
     dict(SERVE_FULL)),
]
D_SMOKE = dict(seq_len=160, prompt_len=160)  # past the smoke window of 128
# the SSM archs' chunked scan takes a multiple of its smoke chunk of 64
# (the reference asserts it): three chunks
D_SMOKE_SCAN = dict(seq_len=192, prompt_len=192)
SCAN_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")
# the smoke check's runs (card against CPU): each D phase's arch, grok-1
# (CPU parity alone at full width) and olmoe on the dense-expert impl
D_SMOKE_RUNS = [(arch, {}) for _, arch, *_ in D_CELLS] + [
    ("grok-1-314b", {}), ("olmoe-1b-7b", {"moe_impl": "dense"})]
# phase G: the norms dense, the embedding and the matrices on the fused
# wire, the embedding's EF state in bf16 beside the others' f32
G_GROUPS = [{"pattern": "norm|bias", "carrier": "dense"},
            {"pattern": "embed", "carrier": "fused_quant8",
             "downlink_carrier": "fused_quant4",
             "ef_state_dtype": "bfloat16"},
            {"pattern": "*", "carrier": "fused_quant8",
             "downlink_carrier": "fused_quant4"}]
CKPT_FREE_BYTES = 40e9         # a full-width checkpoint is about 30 GB
# phase W: a Block-TopK block wider than the warp routes' 1024 (K3 on the
# wide route, csrc/wide.cuh), fused_quant8 up and fused_quant4 down
W_BLOCK, W_K = 4096, 64
W_PATH = dict(carrier="fused_quant8", downlink_carrier="fused_quant4",
              compressor_kw={"block": W_BLOCK, "k_per_block": W_K})
W_STEPS = 2
# phases G, M, S and H cut in depth to make room for W (the script's time
# limit; at 32 layers G, S and H took 9.2, 9.2 and 11.0 s, at 16 layers
# G, S and H 5.0, 5.2 and 5.7 s): 8 of smollm's 32 layers, the leaves and
# the launches unchanged
GMSH_CUT = {"num_layers": 8}
# the wide route's checks (phase 2): (rows, width, layout) of K2/K3, the
# last two past one CTA's shared memory (28,672 values); the 8-client w_up
# stack at W_BLOCK is checked and timed apart
WIDE_EF = [(20_000, 2048, "wide_shared"), (12_000, 3000, "wide_shared"),
           (64, 65_536, "wide_global"), (2, 1_048_576, "wide_global")]
# K1's: (values, block, layout): a ragged 4097, past shared memory (57,344)
WIDE_TOPK = [(20_000 * 2048 - 333, 2048, "wide_shared"),
             (9_000 * 4097 - 1000, 4097, "wide_shared"),
             (64 * 65_536 + 77, 65_536, "wide_global"),
             (2 * 1_048_576, 1_048_576, "wide_global")]
# phase P: the paper's simulator at the experiments' published shapes
# seeds a client count: 2 at n 1 (Figure 1a's inequalities), 1 at n 8
# (Figure 1b's EF21-SGD ending above twice its start, a margin of 10x on
# an H100; 2 before phase P-rates: the script's time limit)
P_FIG1 = dict(gamma=1e-3, steps=8000, seeds={1: 2, 8: 1}, ns=(1, 8))
P_EXP1 = dict(n=10, m_per_client=6000, l=784, c=10)       # MNIST's shape
P_EXP1_STEPS = 500
P_EXP3 = dict(n=100, d=1000)                              # Algorithm 2's
P_EXP3_STEPS = 1000
P_EXP4 = dict(n=5, m_per_client=10000, in_dim=3072, hidden=2048, c=10)
# 100 steps (200 before phase P-rates: the script's time limit)
P_EXP4_STEPS = 100
P_ASYNC_ROUNDS = 20
P_TOL = 1e-3                   # card against CPU, as phase 3's smoke paths
P_PROFILED = 5                 # rounds a P run times and profiles after it


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.time()
    try:
        yield
    except Exception:                               # noqa: BLE001 - boundary
        traceback.print_exc()
        fail(f"phase '{name}' raised")
    print(f"== {name}: ok ({time.time() - t0:.1f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi gave no answer"


def time_ms(fn, reps: int) -> float:
    fn()                                            # warm up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def max_abs_err(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in
               zip(got, want))


def check_equal(name: str, got, want) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            fail(f"{name}: output {i} differs from the plain version "
                 f"(max abs err {max_abs_err([a], [b])})")


def kernel_checks(ops, ref, results):
    """Phase 2: every kernel against its plain version, at the main path's
    shapes, on the same inputs: outputs must be bit-identical."""
    d = math.prod(W_UP)
    rows = CLIENTS * d // BLOCK
    eta, k = 0.2, 16            # the spec's eta and k_per_block
    gen = torch.Generator(device="cuda").manual_seed(0)
    grad, v, g = (torch.randn(rows, BLOCK, generator=gen, device="cuda")
                  for _ in range(3))
    for x in (grad, v, g):
        x[5] = 0.0                                  # an all-zero row
    n = rows * BLOCK
    ops_per_elem = 3 + 2 + 2 * 26 + 2               # momentum, delta, 26 counts, select/add

    got = ops.ef21_sgdm_update(grad, v, g, eta=eta, k=k)
    if ops.ef_layout(grad, v, g, *got) != "staged":
        fail("ef21_sgdm_update: the w_up rows do not take the staged kernel")
    want = ref.ef21_sgdm_update_plain(grad, v, g, eta=eta, k=k)
    check_equal("ef21_sgdm_update", got, want)
    err = max_abs_err(got, want)
    del got, want
    b_ms, b_by = bound(n * 24, n * ops_per_elem)
    results["ef21_sgdm_update"] = {
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        "ms": time_ms(lambda: ops.ef21_sgdm_update(grad, v, g, eta=eta, k=k), 5),
        "plain_ms": time_ms(lambda: ref.ef21_sgdm_update_plain(
            grad, v, g, eta=eta, k=k), 2),
        "library_ms": None}

    for bits in (8, 4):
        err = 0.0
        for kk in ((k, 51) if bits == 8 else (k,)):  # 51: ratio 0.05 of 1024
            got = ops.ef21_sgdm_topk_quant(grad, v, g, eta=eta, k=kk, bits=bits)
            if ops.ef_layout(grad, v, g, *got[:3]) != "staged":
                fail("ef21_sgdm_topk_quant: the w_up rows do not take the "
                     "staged kernel")
            want = ref.ef21_sgdm_topk_quant_plain(grad, v, g, eta=eta, k=kk,
                                                  bits=bits)
            check_equal(f"ef21_sgdm_topk_quant bits={bits} k={kk}", got, want)
            err = max(err, max_abs_err(got, want))
            del got, want
        b_ms, b_by = bound(n * (20 + bits / 8) + rows * 4, n * (ops_per_elem + 6))
        results[f"ef21_sgdm_topk_quant/{bits}"] = {
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: ops.ef21_sgdm_topk_quant(
                grad, v, g, eta=eta, k=k, bits=bits), 5),
            "plain_ms": time_ms(lambda: ref.ef21_sgdm_topk_quant_plain(
                grad, v, g, eta=eta, k=k, bits=bits), 2),
            "library_ms": None}

    # the same with bfloat16 EF state: grad f32, v and g bf16
    v16, g16 = v.to(torch.bfloat16), g.to(torch.bfloat16)
    got = ops.ef21_sgdm_update(grad, v16, g16, eta=eta, k=k)
    if ops.ef_layout(grad, v16, g16, *got) != "staged":
        fail("ef21_sgdm_update bf16 state: the w_up rows do not take the "
             "staged kernel")
    want = ref.ef21_sgdm_update_plain(grad, v16, g16, eta=eta, k=k)
    check_equal("ef21_sgdm_update bf16 state", got, want)
    err = max_abs_err(got, want)
    del got, want
    b_ms, b_by = bound(n * 14, n * ops_per_elem)
    results["ef21_sgdm_update/bf16"] = {
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        "ms": time_ms(lambda: ops.ef21_sgdm_update(grad, v16, g16, eta=eta,
                                                   k=k), 5),
        "plain_ms": time_ms(lambda: ref.ef21_sgdm_update_plain(
            grad, v16, g16, eta=eta, k=k), 2),
        "library_ms": None}
    for bits in (8, 4):
        got = ops.ef21_sgdm_topk_quant(grad, v16, g16, eta=eta, k=k,
                                       bits=bits)
        want = ref.ef21_sgdm_topk_quant_plain(grad, v16, g16, eta=eta, k=k,
                                              bits=bits)
        check_equal(f"ef21_sgdm_topk_quant bf16 state bits={bits}", got,
                    want)
        err = max_abs_err(got, want)
        del got, want
        b_ms, b_by = bound(n * (12 + bits / 8) + rows * 4,
                           n * (ops_per_elem + 6))
        results[f"ef21_sgdm_topk_quant/{bits}/bf16"] = {
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: ops.ef21_sgdm_topk_quant(
                grad, v16, g16, eta=eta, k=k, bits=bits), 5),
            "plain_ms": time_ms(lambda: ref.ef21_sgdm_topk_quant_plain(
                grad, v16, g16, eta=eta, k=k, bits=bits), 2),
            "library_ms": None}
    del grad, v, g, v16, g16
    wide_ef_checks(ops, ref, results, gen)

    # K4 at the downlinks' shapes: one copy of the leaf, in rows of 1024
    # (fused_quant4's block-dense payload) and of 256 (path B's dense
    # payload, 4 bits; 8 bits as well)
    base = torch.randn(d, generator=gen, device="cuda")
    for blk, suffix in ((BLOCK, ""), (QBLOCK, f" block {QBLOCK}")):
        rows1 = d // blk
        scales = torch.rand(rows1, generator=gen, device="cuda") * 1e-3
        scales[3] = 0.0
        for bits in (8, 4):
            hi = 256 if bits == 4 else 128
            q = torch.randint(0 if bits == 4 else -127, hi,
                              (rows1, blk if bits == 8 else blk // 2),
                              generator=gen, device="cuda").to(
                torch.uint8 if bits == 4 else torch.int8)
            err = 0.0
            for alpha in (1.0, -0.5):
                got = ops.dequant_add(q, scales, base, block=blk, bits=bits,
                                      alpha=alpha)
                want = ref.dequant_add_plain(q, scales, base, block=blk,
                                             bits=bits, alpha=alpha)
                check_equal(f"dequant_add block={blk} bits={bits} "
                            f"alpha={alpha}", [got], [want])
                err = max(err, max_abs_err([got], [want]))
            b_ms, b_by = bound(d * (8 + bits / 8) + rows1 * 4, d * 3)
            lib = None
            if bits == 8:      # one PyTorch call computes base + q*scale
                b2 = base.view(rows1, blk)
                lib = time_ms(lambda: torch.addcmul(b2, q, scales[:, None]),
                              10)
            results[f"dequant_add/{bits}{suffix}"] = {
                "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: ops.dequant_add(
                    q, scales, base, block=blk, bits=bits), 10),
                "plain_ms": time_ms(lambda: ref.dequant_add_plain(
                    q, scales, base, block=blk, bits=bits), 3),
                "library_ms": lib}
    for name, r in results.items():
        print(f"kernel {name}: ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) library_ms "
              f"{r['library_ms']} max_abs_err {r['max_abs_err']}", flush=True)


def _check_wide(ops, name, fn, plain, args, kw, layout):
    """One wide-route call (K2 or K3) against its plain version, bit for
    bit, on the layout the launcher names."""
    got = fn(*args, **kw)
    if ops.ef_layout(*args, *got[:3]) != layout:
        fail(f"{name}: rows of {args[0].shape[1]} take "
             f"{ops.ef_layout(*args, *got[:3])}, not {layout}")
    want = plain(*args, **kw)
    check_equal(name, got, want)
    err = max_abs_err(got, want)
    del got, want
    return err


def wide_ef_checks(ops, ref, results, gen):
    """Phase 2, K2 and K3 on rows wider than 1024 (the wide route,
    csrc/wide.cuh), f32 and bf16 state, bits 8 and 4: bit-identical to the
    plain versions at WIDE_EF's widths and on the 8-client w_up stack in
    rows of W_BLOCK (k W_K), where each is timed against its bound (the
    same bytes as the rows of 1024)."""
    eta = 0.2
    for rows, width, layout in WIDE_EF:
        k = max(16, width // 64)
        grad, v, g = (torch.randn(rows, width, generator=gen, device="cuda")
                      for _ in range(3))
        grad[1], v[1], g[1] = 0.0, 0.0, 0.0         # an all-zero row
        for state in (torch.float32, torch.bfloat16):
            args = (grad, v.to(state), g.to(state))
            tag = f"width {width} {str(state)[6:]} state"
            _check_wide(ops, f"ef21_sgdm_update {tag}", ops.ef21_sgdm_update,
                        ref.ef21_sgdm_update_plain, args, dict(eta=eta, k=k),
                        layout)
            for bits in (8, 4):
                _check_wide(ops, f"ef21_sgdm_topk_quant bits={bits} {tag}",
                            ops.ef21_sgdm_topk_quant,
                            ref.ef21_sgdm_topk_quant_plain, args,
                            dict(eta=eta, k=k, bits=bits), layout)
        print(f"wide route, K2 and K3 (bits 8, 4; f32 and bf16 state) on "
              f"{rows} rows of {width} ({layout}): bit-identical to the "
              "plain versions", flush=True)
        del grad, v, g, args
    rows = CLIENTS * math.prod(W_UP) // W_BLOCK
    n = rows * W_BLOCK
    grad, v, g = (torch.randn(rows, W_BLOCK, generator=gen, device="cuda")
                  for _ in range(3))
    for x in (grad, v, g):
        x[5] = 0.0
    ops_per_elem = 3 + 2 + 2 * 26 + 2
    for state, sfx, state_bytes in ((torch.float32, "", 4),
                                    (torch.bfloat16, "/bf16", 2)):
        args = (grad, v.to(state), g.to(state))
        kw = dict(eta=eta, k=W_K)
        for bits in (0, 8, 4):
            if bits == 0:
                fn, plain, key = (ops.ef21_sgdm_update,
                                  ref.ef21_sgdm_update_plain,
                                  f"ef21_sgdm_update{sfx}/w{W_BLOCK}")
                n_bytes = n * (4 + 5 * state_bytes)
                n_ops = n * ops_per_elem
                bkw = kw
            else:
                fn, plain = (ops.ef21_sgdm_topk_quant,
                             ref.ef21_sgdm_topk_quant_plain)
                key = f"ef21_sgdm_topk_quant/{bits}{sfx}/w{W_BLOCK}"
                n_bytes = n * (4 + 4 * state_bytes + bits / 8) + rows * 4
                n_ops = n * (ops_per_elem + 6)
                bkw = dict(kw, bits=bits)
            err = _check_wide(ops, key, fn, plain, args, bkw, "wide_shared")
            b_ms, b_by = bound(n_bytes, n_ops)
            results[key] = {
                "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: fn(*args, **bkw), 5),
                "plain_ms": time_ms(lambda: plain(*args, **bkw), 2),
                "library_ms": None}
    del grad, v, g, args


def wide_topk_checks(ops, ref, results, gen):
    """Phase 2, K1 on blocks wider than 1024 (the wide route): bit for bit
    at WIDE_TOPK's widths (ragged last rows, f32 and bf16) and on the
    8-client w_up stack in rows of W_BLOCK (k W_K, a tie across k), timed
    there beside torch.topk + scatter (a yardstick, another tie rule)."""
    for n, block, layout in WIDE_TOPK:
        if ops.topk_layout(block) != layout:
            fail(f"block_topk: rows of {block} take "
                 f"{ops.topk_layout(block)}, not {layout}")
        y = torch.randn(n, generator=gen, device="cuda")
        y[:block] = 0.0                             # an all-zero row
        for dtype in (torch.float32, torch.bfloat16):
            inp = y.to(dtype)
            k = max(16, block // 64)
            got = ops.block_topk(inp, block=block, k=k)
            want = ref.block_topk_plain(inp, block=block, k=k)
            check_equal(f"block_topk block {block} {dtype}", [got], [want])
            del got, want
        print(f"block_topk wide route ({n} values, block {block}, "
              f"{layout}, f32 and bf16): bit-identical to the plain "
              "version", flush=True)
        del y, inp
    x = torch.randn(CLIENTS, *W_UP, generator=gen, device="cuda")
    xb = x.view(-1, W_BLOCK)
    xb[5] = 0.0
    xb[9, :W_K + 4] = 4.5                           # ties across k
    if ops.topk_layout(W_BLOCK) != "wide_shared":
        fail(f"block_topk: rows of {W_BLOCK} off the wide route")
    got = ops.block_topk(x, block=W_BLOCK, k=W_K)
    want = ref.block_topk_plain(x, block=W_BLOCK, k=W_K)
    check_equal(f"block_topk block {W_BLOCK}", [got], [want])
    if int((got.view(-1, W_BLOCK)[9] != 0).sum()) < W_K + 4:
        fail("block_topk dropped a tie at the threshold on the wide route")
    err = max_abs_err([got], [want])
    del got, want
    n = x.numel()
    b_ms, b_by = bound(n * 8, n * (2 + 26 + 1))

    def topk_scatter():
        idx = torch.topk(xb.abs(), W_K, dim=1).indices
        return torch.zeros_like(xb).scatter_(1, idx, xb.gather(1, idx))
    key = f"block_topk/w{W_BLOCK}"
    results[key] = {
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        "ms": time_ms(lambda: ops.block_topk(x, block=W_BLOCK, k=W_K), 20),
        "plain_ms": time_ms(lambda: ref.block_topk_plain(
            x, block=W_BLOCK, k=W_K), 2),
        "library_ms": None,
        "yardstick_topk_scatter_ms": time_ms(topk_scatter, 5)}
    del x, xb
    r = results[key]
    print(f"kernel {key} [{n // W_BLOCK} rows of {W_BLOCK}, k {W_K}]: ms "
          f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
          f"{r['bound_ms']:.4f} ({r['bound_by']}); torch.topk + scatter "
          f"(yardstick, another tie rule) "
          f"{r['yardstick_topk_scatter_ms']:.4f} ms", flush=True)


def topk_checks(ops, ref, results):
    """Phase 2, K1: bit-identical to its plain version at the main shape
    (the 8-client w_up stack, an all-zero row and a tie of 20 values across
    k 16), at a ragged length in f32 and bf16 and at narrow odd blocks
    (lane groups of 16, and a warp holding two values a lane); then timed
    at the main shape beside torch.topk + scatter, a yardstick only: it
    keeps exactly k with no stated tie order, where K1 keeps ties."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    k = 16
    x = torch.randn(CLIENTS, *W_UP, generator=gen, device="cuda")
    flat = x.view(-1)
    flat[5 * BLOCK:6 * BLOCK] = 0.0                 # an all-zero row
    flat[9 * BLOCK:9 * BLOCK + 20] = 4.5            # 20 tied values
    err = 0.0
    cases = [("main", x, BLOCK, k)]
    y = torch.randn(3_000_017, generator=gen, device="cuda")
    cases += [("ragged f32", y, BLOCK, k),
              ("ragged bf16", y.to(torch.bfloat16), BLOCK, k),
              ("block 13", y[:1_000_003], 13, 3),
              ("block 51", y[:1_000_003], 51, 3)]
    for label, inp, block, kk in cases:
        got = ops.block_topk(inp, block=block, k=kk)
        want = ref.block_topk_plain(inp, block=block, k=kk)
        check_equal(f"block_topk {label}", [got], [want])
        err = max(err, max_abs_err([got], [want]))
        print(f"block_topk {label} ({inp.numel()} values, block {block}, k "
              f"{kk}, {inp.dtype}): bit-identical to the plain version",
              flush=True)
        del got, want
    if int((ops.block_topk(x, block=BLOCK, k=k).view(-1, BLOCK)[9] != 0)
           .sum()) < 20:
        fail("block_topk dropped a tie at the threshold")
    del y, cases
    n = x.numel()
    b_ms, b_by = bound(n * 8, n * (2 + 26 + 1))     # abs, 26 counts, select
    xb = x.view(-1, BLOCK)

    def topk_scatter():
        idx = torch.topk(xb.abs(), k, dim=1).indices
        return torch.zeros_like(xb).scatter_(1, idx, xb.gather(1, idx))
    results["block_topk"] = {
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        "ms": time_ms(lambda: ops.block_topk(x, block=BLOCK, k=k), 20),
        "plain_ms": time_ms(lambda: ref.block_topk_plain(x, block=BLOCK,
                                                         k=k), 2),
        "library_ms": None,
        "yardstick_topk_scatter_ms": time_ms(topk_scatter, 5)}
    r = results["block_topk"]
    print(f"kernel block_topk [{tuple(x.shape)}, block {BLOCK}, k {k}]: ms "
          f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
          f"{r['bound_ms']:.4f} ({r['bound_by']}); torch.topk + scatter "
          f"(yardstick, another tie rule) "
          f"{r['yardstick_topk_scatter_ms']:.4f} ms", flush=True)
    del x, xb
    wide_topk_checks(ops, ref, results, gen)


def topk_path(ops):
    """Phase 2b: K1 through its public entry, as the reference's kernel
    bench drives it, on the 8-client w_up stack: exactly one launch; every
    row keeps at least k values, each equal to its input."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(CLIENTS, *W_UP, generator=gen, device="cuda")
    ops.reset_launches()
    out = ops.block_topk(x, block=BLOCK, k=16)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    print(f"K1 path: launches {launches}", flush=True)
    for name, count in launches.items():
        if count != (1 if name == "block_topk" else 0):
            fail(f"{name} launched {count} times on the K1 path")
    kept = out != 0
    per_row = kept.view(-1, BLOCK).sum(1)
    if out.shape != x.shape or not bool(torch.isfinite(out).all()) or \
            int(per_row.min()) < 16 or \
            not torch.equal(out[kept], x[kept]):
        fail("K1 path: the output is not a Block-TopK of its input")
    print(f"K1 path: kept per row min {int(per_row.min())} max "
          f"{int(per_row.max())} of {BLOCK}", flush=True)
    del x, out, kept
    return launches


def kernel_row_ms(fn, match: str, reps: int):
    """The mean device time of the kernels whose name holds ``match`` over
    ``reps`` calls of ``fn``, from torch.profiler's kernel rows (CUDA
    activity only): the kernel's own time, without the wrapper's host
    cost that an event bracket around back-to-back calls can include.
    None when the trace holds no such kernel (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and match in e.key]
    count = sum(e.count for e in rows)
    return sum(e.device_time_total for e in rows) / count / 1e3 if count \
        else None


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary: a view into a larger buffer."""
    n = t.numel()
    pad = 4 // t.element_size()
    buf = torch.empty(n + pad, dtype=t.dtype, device=t.device)
    view = buf[pad:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


# K5/K6 at every width the quantized carriers give them and the cases of
# each mapping: (rows, cols, unaligned). 614,400 x 16 is path A's uplink
# sparse payload, 76,800 x 51 its downlink's, 2,457,600 x 256 path B's
# dense payload, 4,096 x 1024 the fused path's rows, 2,359,296 plain TopK's
# single block; 1,000,003 rows leave the last CTA and the last grid-stride
# pass partial; 1, 17 and 51 are odd widths.
CODEC_CASES = [(614_400, 16, False), (76_800, 51, False),
               (2_457_600, 256, False), (4096, 1024, False),
               (1, TOPK_EMBED_K, False), (1_000_003, 16, False),
               (70_001, 32, False), (33_333, 256, False), (3001, 1024, False),
               (10_007, 16, True), (1001, 256, True), (20_000, 1, False),
               (20_000, 17, False), (1000, 51, True)]
# where the main paths run them: (label, rows, cols, bits, K5 and/or K6)
CODEC_TIMED = [
    ("A uplink sparse payload", 614_400, 16, 8, ("block_quantize",
                                                 "block_dequantize")),
    ("A downlink sparse payload", 76_800, 51, 4, ("block_quantize",
                                                  "block_dequantize")),
    ("B uplink dense payload", 2_457_600, QBLOCK, 8, ("block_quantize",
                                                      "block_dequantize")),
    ("B downlink dense payload", 307_200, QBLOCK, 4, ("block_quantize",)),
    ("fused_quant8 uplink mean", 614_400, BLOCK, 8, ("block_dequantize",)),
    ("fused_quant4 downlink", 76_800, BLOCK, 4, ("block_quantize",))]


def codec_checks(ops, ref, results):
    """Phase 2, K5 and K6: bit-identical to their plain versions at every
    case of CODEC_CASES (an inf, a NaN and an all-zero row in each), each
    of the three mappings run at least once by both; then timed where the
    main paths run them, by CUDA events around back-to-back calls of the
    wrapper and by the profiler's kernel rows."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    err = {"block_quantize": 0.0, "block_dequantize": 0.0}
    mappings = {"block_quantize": set(), "block_dequantize": set()}
    for rows, cols, misaligned in CODEC_CASES:
        x = torch.randn(rows, cols, generator=gen, device="cuda")
        x[0, 0], x[0, -1] = float("inf"), float("nan")
        if rows > 1:
            x[1] = 0.0                                  # an all-zero row
        if misaligned:
            x = unaligned(x)
        for bits in (8, 4):
            got = ops.block_quantize(x, bits)
            want = ref.block_quantize_plain(x, bits)
            check_equal(f"block_quantize {rows}x{cols} bits={bits}", got, want)
            err["block_quantize"] = max(err["block_quantize"],
                                        max_abs_err(got, want))
            q = unaligned(got[0]) if misaligned else got[0]
            dec = ops.block_dequantize(q, got[1], bits, cols)
            want = ref.block_dequantize_plain(*got, bits=bits, cols=cols)
            check_equal(f"block_dequantize {rows}x{cols} bits={bits}", [dec],
                        [want])
            err["block_dequantize"] = max(err["block_dequantize"],
                                          max_abs_err([dec], [want]))
            maps = (ops.codec_mapping(x, got[0], cols),
                    ops.codec_mapping(q, dec, cols))
            mappings["block_quantize"].add(maps[0])
            mappings["block_dequantize"].add(maps[1])
            del got, want, dec, q
        print(f"codec {rows}x{cols}{' unaligned' if misaligned else ''}: "
              f"K5 ({maps[0]}) and K6 ({maps[1]}) bit-identical at bits 8 "
              "and 4", flush=True)
        del x
    for name, seen in mappings.items():
        if seen != {"vector", "scalar", "wide"}:
            fail(f"{name} ran the mappings {sorted(seen)}, not all three")
    shapes = {}
    for label, rows, cols, bits, names in CODEC_TIMED:
        x = torch.randn(rows, cols, generator=gen, device="cuda")
        q, scales = ops.block_quantize(x, bits)
        n = rows * cols
        io = q.numel() + rows * 4 + n * 4          # mantissas, scales, f32
        calls = {
            "block_quantize": (lambda: ops.block_quantize(x, bits),
                               lambda: ref.block_quantize_plain(x, bits),
                               None, n * 6),   # abs, max, div, rint, clamp
            "block_dequantize": (
                lambda: ops.block_dequantize(q, scales, bits, cols),
                lambda: ref.block_dequantize_plain(q, scales, bits=bits,
                                                   cols=cols),
                # int8 x f32 promotes to f32: one PyTorch call at bits 8
                (lambda: torch.mul(q, scales[:, None])) if bits == 8
                else None, n * 2)}                 # unpack, multiply
        reps = 20 if n * 4 < 1e9 else 5
        for name in names:
            fn, plain, lib, n_ops = calls[name]
            b_ms, b_by = bound(io, n_ops)
            r = {"max_abs_err": err[name], "bound_ms": b_ms, "bound_by": b_by,
                 "ms": time_ms(fn, reps),
                 "kernel_row_ms": kernel_row_ms(fn, name, reps),
                 "plain_ms": time_ms(plain, 3),
                 "library_ms": time_ms(lib, reps) if lib else None,
                 # K6's output is a fresh (rows, cols) f32, as x is
                 "mapping": ops.codec_mapping(
                     *((x, q) if name == "block_quantize"
                       else (q, torch.empty_like(x))), cols)}
            shapes.setdefault(name, {})[f"{rows}x{cols}/{bits}"] = r
            print(f"kernel {name} [{label}, {rows}x{cols}, bits {bits}, "
                  f"{r['mapping']}]: ms {r['ms']:.4f} kernel_row_ms "
                  f"{r['kernel_row_ms']} plain_ms {r['plain_ms']:.4f} "
                  f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"library_ms {r['library_ms']}", flush=True)
        del x, q, scales
    # the kernels line's entries: main path A's uplink, with every shape
    for name in ("block_quantize", "block_dequantize"):
        results[name] = dict(shapes[name][f"{614_400}x16/8"],
                             shapes=shapes[name])


def p_rounding_bound(q, k, v, want):
    """The elementwise bound that holds K7's bf16 route against the
    P-rounding plain version (tests/test_torch_cuda.py states the
    argument): 1.01 * 2^-7 * (sum_j p_j |v_j| / l + |want|) + 1e-5."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    out = torch.empty(B, S, H, hd, device=q.device)
    for h in range(H):                      # a head at a time: S x S scores
        kf, vf = k[:, :, h // G].float(), v[:, :, h // G].float()
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(), kf) * hd ** -0.5
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, :, h] = torch.einsum("bqk,bkd->bqd", p, vf.abs())
    return 1.01 * 2 ** -7 * (out + want.float().abs()) + 1e-5


def flash_checks(ops, ref, results):
    """Phase 2, K7: against its plain version at every shape of the serving
    paths and the ragged and hd-128 cases, within the tolerance of the
    reference's flash test, and (bf16) within the stated bound of the
    P-rounding plain version; then both routes timed at the full-width
    prefill's shape beside the library's attention in the same dtype."""
    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(B, S, H, KV, hd, dtype):
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda")
        k, v = (torch.randn(B, S, KV, hd, generator=gen, device="cuda")
                for _ in range(2))
        return [x.to(dtype) for x in (q, k, v)]

    smoke = (2, 64, 3, 1, 64)          # the smoke config's heads
    err = {}
    for shape, dtype in ((smoke, torch.float32), (smoke, torch.bfloat16),
                         (FLASH_FULL, torch.bfloat16),
                         (FLASH_FULL, torch.float32),
                         *((shape, torch.bfloat16)
                           for _, shape, _ in FLASH_D + FLASH_MT),
                         ((8, 1000, 15, 5, 64), torch.bfloat16),
                         ((2, 512, 8, 2, 128), torch.bfloat16),
                         ((2, 512, 8, 2, 128), torch.float32),
                         ((1, 70, 4, 2, 32), torch.bfloat16)):
        q, k, v = inputs(*shape, dtype)
        got = ops.flash_attention(q, k, v)
        want = ref.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        e, tol = max_abs_err([got], [want]), FLASH_TOL[dtype]
        if got.dtype != dtype or got.shape != want.shape or not \
                torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            fail(f"flash_attention {shape} {dtype}: differs from the plain "
                 f"version beyond {tol} (max abs err {e})")
        line = f"within {tol} of the plain version, max abs err {e}"
        if dtype == torch.bfloat16:
            want_r = ref.flash_attention_plain(q, k, v, round_p=True)
            e_r = max_abs_err([got], [want_r])
            ratio = float(((got.float() - want_r.float()).abs()
                           / p_rounding_bound(q, k, v, want_r)).max())
            if ratio > 1:
                fail(f"flash_attention {shape} bf16: outside the bound of "
                     f"the P-rounding plain version (err/bound {ratio})")
            line += (f"; P-rounding plain version: max abs err {e_r}, "
                     f"worst err/bound {ratio:.4f}")
            del want_r
        print(f"flash_attention {shape} {dtype}: {line}", flush=True)
        if shape == FLASH_FULL or shape in [f for _, f, _ in
                                            FLASH_D + FLASH_MT]:
            err[shape, dtype] = e
        del q, k, v, got, want

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape, dtype, peak, key in (
            (FLASH_FULL, torch.bfloat16, BF16_TC_OPS_S, "flash_attention"),
            (FLASH_FULL, torch.float32, F32_OPS_S, "flash_attention/f32"),
            *((shape, torch.bfloat16, BF16_TC_OPS_S, key)
              for key, shape, _ in FLASH_D + FLASH_MT)):
        B, S, H, KV, hd = shape
        n_ops = 4 * B * H * hd * S * (S + 1) / 2              # causal
        q, k, v = inputs(B, S, H, KV, hd, dtype)
        size = 2 if dtype == torch.bfloat16 else 4
        n_bytes = size * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / peak
        # the library's fused attention on kv heads expanded as the plain
        # version expands them, in its (B, H, S, hd) layout, prepared untimed
        qt, kt, vt = (x.repeat_interleave(H // x.shape[2], dim=2)
                      .transpose(1, 2).contiguous() for x in (q, k, v))
        lib_out = sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
        want = ref.flash_attention_plain(q, k, v)
        lib_err = max_abs_err([lib_out], [want])
        if not torch.allclose(lib_out.float(), want.float(), atol=2e-2,
                              rtol=2e-2):
            fail(f"scaled_dot_product_attention {dtype} differs from the "
                 f"plain version (max abs err {lib_err})")
        del lib_out, want
        round_p = dtype == torch.bfloat16
        reps = 50 if round_p else 20
        # kernel and library in turns, three rounds each: the medians
        turns = {"ms": [], "library_ms": []}
        for _ in range(3):
            turns["ms"].append(time_ms(lambda: ops.flash_attention(q, k, v),
                                       reps))
            turns["library_ms"].append(time_ms(
                lambda: sdpa(qt, kt, vt, is_causal=True), reps))
        results[key] = {
            "max_abs_err": err[shape, dtype],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ms": sorted(turns["ms"])[1],
            "plain_ms": time_ms(lambda: ref.flash_attention_plain(
                q, k, v, round_p=round_p), 3),
            "library_ms": sorted(turns["library_ms"])[1]}
        r = results[key]
        print(f"kernel flash_attention [{shape} {dtype}, causal, "
              f"{'tensor cores' if round_p else 'CUDA cores'}]: ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms']:.4f} (medians of the turns "
              f"{[round(t, 4) for t in turns['ms']]} and "
              f"{[round(t, 4) for t in turns['library_ms']]}; sdpa max abs "
              f"err {lib_err} vs plain); bytes {n_bytes} -> "
              f"{t_bytes * 1e3:.4f} ms; ops {n_ops:.4e} -> "
              f"{t_ops * 1e3:.4f} ms at {peak:.3g} op/s; bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
        del q, k, v, qt, kt, vt


def kernel_resources(build, lib):
    """Registers and spill bytes of every kernel from the build's ptxas
    report (-Xptxas -v), and the HGMMA count of each function in the
    library's SASS (cuobjdump -sass): {demangled name: {...}}."""
    funcs, cur = {}, None
    for line in build.build_log().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            cur.setdefault("hgmma", 0)
        elif cur is not None and "HGMMA" in line:
            cur["hgmma"] += 1
    try:
        names = subprocess.run(["c++filt"], input="\n".join(funcs),
                               capture_output=True, text=True
                               ).stdout.split("\n")
    except FileNotFoundError:
        names = []
    if len(names) < len(funcs):
        names = list(funcs)
    return {re.sub(r"\(.*", "", n): funcs[m]
            for n, m in zip(names, funcs)}


def check_serve_launches(ops, launches, label, want_flash) -> None:
    """Serving runs K7 once a layer in the prefill and no other kernel."""
    for name, count in launches.items():
        want = want_flash if name == "flash_attention" else 0
        if count != want:
            fail(f"{name} launched {count} times on {label}, expected {want}")


def serve_batch(cfg, tokens):
    """A prefill's batch as Session.serve builds it: the tokens after the
    frontend's zero prefix at serving's padding (none without a
    frontend); and the prefix's length."""
    from repro_torch.data import pipeline as pipe_lib
    pad = pipe_lib.PREFIX_PAD_SPEC
    return (pipe_lib.with_prefix_embeds(cfg, {"tokens": tokens}, pad_to=pad),
            pipe_lib.prefix_token_count(cfg, pad))


def first_token_check(model_lib, cfg, params, tokens, out, label) -> None:
    """The served first tokens are the argmax of a prefill's logits under
    ``params`` (after the frontend's prefix, as served), and the logits
    are finite."""
    B, S = tokens.shape
    batch, n_prefix = serve_batch(cfg, tokens)
    cache = model_lib.init_cache(cfg, B, n_prefix + S, device=tokens.device)
    logits, _ = model_lib.prefill(cfg, params, batch, cache)
    if not bool(torch.isfinite(logits).all()):
        fail(f"{label}: non-finite prefill logits")
    first = logits[:, -1].argmax(-1).cpu().numpy()
    if (first != out["tokens"][:, 0]).any():
        fail(f"{label}: first tokens {out['tokens'][:, 0]} are not the "
             f"argmax {first} of the prefill under these params")


def serve_smoke_check(Session, spec_lib, model_lib, ops, label="smoke",
                      prompt_len=64, train_steps=0, **overrides):
    """Phase 7 (and 6e's smoke part, ``train_steps`` 2 on another arch):
    Sessions at smoke size on the card and on the CPU, f32 activations,
    through the same calls. ``train_steps`` steps first when given, their
    loss and g_norm within phase 3's rtol 1e-3 (:func:`compare_runs`) and
    the card's launches those of ``expected_launches``; then a serve of a
    (2, ``prompt_len``) prompt and 8 decode steps, both Sessions serving
    the same weights (the fresh ones of the spec's seed, or the CPU's
    trained tree: the two trained trees differ where the runs' roundings
    did): the greedy tokens equal, K7 ``model.flash_layers`` launches a
    prefill, the prefill logits within rtol 1e-4. A frontend's prefix goes
    before the prompts, as served. Under MoE the chosen experts of every
    layer are held equal first, at the fresh weights on batch 0 and in the
    prefill of the served tree, so that a routing flip is told apart from
    an arithmetic error."""
    from repro_torch.launch import build as build_lib
    from repro_torch.models import moe as moe_lib
    spec = load_spec(spec_lib, smoke=True, **overrides)
    sessions, runs, outs, logits, routes = {}, {}, {}, {}, {}
    for device in ("cuda", "cpu"):
        sess = sessions[device] = Session(spec, device=device,
                                          dtype="float32")
        if sess.cfg.family == "moe":
            # the state first: its batch-0 gradients run under the vmap
            params, batch = sess.params, sess.batch_for(0)
            with torch.no_grad(), moe_lib.capture_routing() as seen:
                model_lib.train_loss(sess.cfg, params, batch)
            routes[device] = seen
        if train_steps:
            per_step = expected_launches(build_lib.ef_config(spec),
                                         sess.params)
            ops.reset_launches()
            runs[device] = sess.train(train_steps, log_every=1)
            if device == "cuda":
                check_launches(dict(ops.launches), per_step, train_steps,
                               label)
    same_routes(routes, label, "the fresh weights on batch 0")
    if train_steps:
        compare_runs(runs, label)
        sessions["cuda"].set_serve_params(
            {k: t.to("cuda") for k, t in
             sessions["cpu"].serve_source().items()})
    tokens = torch.randint(0, sessions["cpu"].cfg.vocab_size,
                           (2, prompt_len),
                           generator=torch.Generator().manual_seed(0))
    for device, sess in sessions.items():
        ops.reset_launches()
        outs[device] = sess.serve(tokens=tokens, decode_steps=8)
        if device == "cuda":
            check_serve_launches(ops, dict(ops.launches),
                                 f"the {label} serve",
                                 model_lib.flash_layers(sess.cfg))
        batch, n_prefix = serve_batch(sess.cfg, tokens.to(device))
        cache = model_lib.init_cache(sess.cfg, 2, n_prefix + prompt_len,
                                     device=device)
        with moe_lib.capture_routing() as seen:
            logits[device] = model_lib.prefill(
                sess.cfg, sess.serve_source(), batch, cache)[0].cpu()
        routes[device] = seen
    same_routes(routes, label, "the served tree's prefill")
    a, b = outs["cuda"]["tokens"], outs["cpu"]["tokens"]
    print(f"{label} serve tokens: cuda {a.tolist()} cpu {b.tolist()}",
          flush=True)
    if a.shape != (2, 9) or (a != b).any():
        fail(f"{label} serve: the card's greedy tokens differ from the CPU's")
    # rtol 1e-4, and atol 1e-4 of the largest logit for the ones near zero
    diff = (logits["cuda"] - logits["cpu"]).abs()
    lim = 1e-4 * (logits["cpu"].abs() + logits["cpu"].abs().max())
    print(f"{label} serve prefill logits: max abs diff {float(diff.max())} "
          f"(largest {float(logits['cpu'].abs().max())})", flush=True)
    if not bool(torch.isfinite(logits["cuda"]).all()) or \
            bool((diff > lim).any()):
        fail(f"{label} serve: prefill logits on the card differ from the "
             "CPU's beyond rtol 1e-4")


def same_routes(routes, label, where) -> None:
    """The card's and the CPU's chosen experts (models/moe.py
    ``capture_routing``), every routed call, equal; nothing without MoE."""
    if not routes or not routes.get("cuda"):
        return
    a, b = routes["cuda"], routes["cpu"]
    if len(a) != len(b):
        fail(f"{label}: {len(a)} routed calls on the card, {len(b)} on the "
             "CPU")
    for i, ((ea, _), (eb, pb)) in enumerate(zip(a, b)):
        diff = (ea.cpu() != eb).any(-1)
        if bool(diff.any()):
            n = int(diff.nonzero()[0])
            fail(f"{label}: routing flip at {where}, call {i}, token {n}: "
                 f"card {ea[n].tolist()} cpu {eb[n].tolist()} (cpu router "
                 f"probabilities {pb[n].tolist()})")
    print(f"{label} routing at {where}: {len(a)} calls, "
          f"{sum(e.shape[0] for e, _ in a)} tokens, the chosen experts equal "
          "on card and CPU", flush=True)


def serve_full(Session, spec_lib, model_lib, ops):
    """Phase 8: full-width smollm-360m, batch 8, prompt 1024, 32 decode
    steps, from fresh weights; served twice; then the f32 prefill
    (:func:`prefill_f32`). Returns the launches of the bf16 serve and of
    the f32 prefill."""
    spec = load_spec(spec_lib)
    sess = Session(spec, device="cuda")
    B, S, steps = (SERVE_FULL[k] for k in ("batch", "prompt_len",
                                           "decode_steps"))
    # the prompts serve() draws when given none, drawn here to check them
    tokens = torch.randint(0, sess.cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(spec.seed))
    for run in range(2):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        at_decode = {}

        def hook(i):
            if i == 0:                          # the prefill's launches
                at_decode.update(ops.launches)
        out = sess.serve(tokens=tokens, decode_steps=steps, decode_hook=hook)
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        print(f"serve full width run {run}: prefill_ms "
              f"{out['prefill_s'] * 1e3:.3f} prefill_tok_s "
              f"{out['prefill_tok_s']:.1f} decode_ms_per_token "
              f"{out['decode_s'] * 1e3 / steps:.3f} decode_tok_s "
              f"{out['decode_tok_s']:.1f} cache_bytes {out['cache_bytes']} "
              f"max_memory_allocated {peak} launches {launches}", flush=True)
        check_serve_launches(ops, at_decode, "the full-width prefill",
                             model_lib.flash_layers(sess.cfg))
        check_serve_launches(ops, launches, "the full-width serve (prefill "
                             "and decode)", model_lib.flash_layers(sess.cfg))
        toks = out["tokens"]
        if toks.shape != (B, steps + 1) or toks.min() < 0 or \
                toks.max() >= sess.cfg.vocab_size:
            fail(f"full-width serve: tokens of shape {toks.shape} in "
                 f"[{toks.min()}, {toks.max()}]")
    # the fresh weights of spec.seed, drawn again to check what was served
    fresh = model_lib.init_params(
        sess.cfg, torch.Generator().manual_seed(spec.seed), "cuda")
    first_token_check(model_lib, sess.cfg, fresh, tokens.cuda(), out,
                      "full-width serve")
    # the tree serve() ran: the matrices cast to bf16 once for this version
    served_tree = sess.serving_params()
    dtypes = {str(t.dtype) for k, t in served_tree.items()
              if not k.endswith("norm")}
    print(f"served tree: matrices in {sorted(dtypes)}, norm scales in "
          f"{sorted({str(t.dtype) for k, t in served_tree.items() if k.endswith('norm')})}",
          flush=True)
    serve_profile(model_lib, sess.cfg, served_tree, tokens.cuda(),
                  out["decode_s"] / steps)
    del sess, fresh, served_tree
    gc.collect()
    torch.cuda.empty_cache()
    return launches, prefill_f32(Session, spec, model_lib, ops, tokens.cuda())


def prefill_f32(Session, spec, model_lib, ops, tokens):
    """Phase 8, f32: one prefill of the same fresh weights and prompts in
    f32 activations, the path of K7's f32 route: exactly 32 launches (one
    a layer), finite logits; then torch.profiler around two more
    prefills, the first while the tracer warms up, reads the second's
    device busy ms and K7's kernel row. Returns the launches."""
    from torch.autograd import DeviceType
    sess = Session(spec, device="cuda", dtype="float32")
    cfg, params = sess.cfg, sess.serving_params()
    B, S = tokens.shape

    def run():
        cache = model_lib.init_cache(cfg, B, S, device="cuda")
        return model_lib.prefill(cfg, params, {"tokens": tokens}, cache)[0]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.time()
    logits = run()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    launches = dict(ops.launches)
    check_serve_launches(ops, launches, "the full-width f32 prefill",
                         model_lib.flash_layers(cfg))
    if logits.dtype != torch.float32 or \
            tuple(logits.shape) != (B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"full-width f32 prefill: logits {logits.dtype} "
             f"{tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    prof = profiled(run)
    busy, by_op = device_ms(prof)
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and "flash_attention_kernel" in e.key]
    count = sum(e.count for e in rows)
    k7_ms = sum(e.device_time_total for e in rows) / 1e3
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:5]
    print(f"f32 prefill full width (B {B}, S {S}): wall_ms {wall:.3f} "
          f"launches {launches}; profile: device busy ms {busy:.3f}; K7 "
          f"kernel row {count} launches, {k7_ms:.3f} ms "
          f"({k7_ms / count if count else float('nan'):.4f} ms a launch); "
          f"by op {[(k[:40], round(t, 3)) for k, t in top]}", flush=True)
    if count != model_lib.flash_layers(cfg):
        kernels = sorted(((e.key[:60], e.count) for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda kc: -kc[1])
        fail(f"the f32 prefill's trace holds {count} K7 kernel rows, "
             f"expected {model_lib.flash_layers(cfg)}; the trace's kernel "
             f"rows by launches: {kernels[:12]}")
    del sess, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def device_ms(prof):
    """(device busy ms, {op: ms of the kernels it launched}) of a
    torch.profiler run. Busy time sums the kernel rows only: an aten op's
    row repeats the time of the kernels it launched, and so does the
    device row of a profiler schedule's step (``ProfilerStep#n``)."""
    from torch.autograd import DeviceType
    busy, by_op = 0.0, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and \
                not e.key.startswith("ProfilerStep"):
            busy += e.device_time_total / 1e3
        # K7's kernels (flash_attention_kernel, flash_tc_kernel) and the ops
        if "flash_" in e.key or e.device_type != DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            if t > 0:
                by_op[e.key] = t / 1e3
    return busy, by_op


def profiled(fn):
    """torch.profiler (CPU and CUDA activity) around ``fn()`` run twice,
    the first while the tracer warms up (its events dropped): a fresh trace
    can lose the kernels at its very start. Returns the profile of the
    second run."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def serve_profile(model_lib, cfg, params, tokens, decode_s_per_step) -> None:
    """Where serving's time goes, from torch.profiler (CPU and CUDA
    activity, :func:`profiled`) around one full-width prefill and 2 decode
    steps: the device's busy time, K7's share of the prefill, the casts'
    (aten::copy_) device time, and the decode step's device time against
    its unprofiled wall time (the idle share)."""
    B, S = tokens.shape
    state = {}

    def prefill():
        cache = model_lib.init_cache(cfg, B, S + 4, device="cuda")
        state["logits"], state["cache"] = model_lib.prefill(
            cfg, params, {"tokens": tokens}, cache)
        state["pos"] = S
    busy, by_op = device_ms(profiled(prefill))
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile prefill: device busy ms {busy:.3f}; by op "
          f"{[(k[:40], round(t, 3)) for k, t in top]}; aten::copy_ "
          f"{by_op.get('aten::copy_', 0.0):.3f}", flush=True)

    def decode_2():
        for _ in range(2):
            tok = state["logits"][:, -1].argmax(-1)[:, None]
            state["logits"], state["cache"] = model_lib.decode_step(
                cfg, params, state["cache"], tok, state["pos"])
            state["pos"] += 1
    busy, by_op = device_ms(profiled(decode_2))
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:5]
    wall = decode_s_per_step * 1e3
    if busy > 0:
        print(f"profile decode: device busy ms a step {busy / 2:.3f} of "
              f"{wall:.3f} unprofiled wall ms (idle share "
              f"{1 - busy / 2 / wall:.3f}); by op a step "
              f"{[(k[:40], round(t / 2, 3)) for k, t in top]}; aten::copy_ "
              f"{by_op.get('aten::copy_', 0.0) / 2:.3f}", flush=True)
    else:
        print("profile decode: no device time in the trace (not measured)",
              flush=True)


def serve_trained(sess, model_lib, ops) -> None:
    """Serve one small batch from the live training tree: its first tokens
    must be those of the trained params."""
    tokens = torch.randint(0, sess.cfg.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(1))
    ops.reset_launches()
    out = sess.serve(tokens=tokens, decode_steps=8)
    check_serve_launches(ops, dict(ops.launches), "the trained-model serve",
                         model_lib.flash_layers(sess.cfg))
    first_token_check(model_lib, sess.cfg, sess.params, tokens.cuda(), out,
                      "trained-model serve")
    print(f"served the trained model (step {sess.step}): tokens "
          f"{out['tokens'].tolist()}", flush=True)


def recompute_phase(Session, spec_lib, ops):
    """Phase R: full-width smollm-360m, 8 clients, fused_quant8 up and
    fused_quant4 down, one step from seed 0 with block recompute off, then
    one with it on (each Session builds its state from the batch-0
    gradients under its own setting). Params and every EF state leaf must
    be equal bit for bit (the first run's leaves kept on the host,
    compared leaf by leaf on the card), and the peak lower with recompute.
    Prints each run's step ms and peak, and the client pass alone (the
    next batch, median of 3) with its ms and peak. Returns the launches of
    the step with recompute."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.ef import flatten
    from repro_torch.launch import build as build_lib
    from repro_torch.models import model as model_lib
    spec = load_spec(spec_lib, **R_PATH)
    want, peaks, out = None, {}, {}
    for on in (False, True):
        label = f"R remat={on}"
        sess = Session(spec, device="cuda")
        sess.cfg = dataclasses.replace(sess.cfg, remat=on)
        per_step = expected_launches(build_lib.ef_config(spec), sess.params)
        predicted = dryrun_predict(sess) if on else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        ops.reset_launches()
        t0 = time.time()
        m = sess.step_once()
        torch.cuda.synchronize()
        step_ms = (time.time() - t0) * 1e3
        out[on] = dict(ops.launches)
        check_launches(out[on], per_step, 1, label)
        peaks[on] = torch.cuda.max_memory_allocated()
        if predicted is not None:
            dryrun_check(predicted, out[on], peaks[on])
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - \
            retries
        batch = sess.batch_for(sess.step)
        pass_ms = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            _, _, grads = dist.per_client_value_and_grad(
                lambda p, b: model_lib.train_loss(sess.cfg, p, b),
                sess.params, batch, sess.n_clients)
            torch.cuda.synchronize()
            pass_ms.append((time.time() - t0) * 1e3)
            del grads
        pass_peak = torch.cuda.max_memory_allocated()
        print(f"{label}: loss {float(m['loss']):.6f} step_ms {step_ms:.1f} "
              f"max_memory_allocated {peaks[on]} alloc_retries {retries}; "
              f"client pass ms {[round(t, 1) for t in pass_ms]} (median "
              f"{sorted(pass_ms)[1]:.1f}) max_memory_allocated {pass_peak}",
              flush=True)
        flat = flatten({"params": sess.params, "ef_state": sess.ef_state})
        if want is None:
            want = {k: t.cpu() for k, t in flat.items()}
        else:
            bad = [k for k in want
                   if not torch.equal(flat[k], want[k].to("cuda"))]
            if sorted(flat) != sorted(want) or bad:
                fail(f"R: leaves differ with recompute: {bad[:5]}")
            print(f"R: {len(flat)} leaves of params and EF state bit-"
                  f"identical with and without recompute; peak "
                  f"{peaks[False]} -> {peaks[True]} bytes", flush=True)
        del sess, m, flat
        gc.collect()
        torch.cuda.empty_cache()
    if peaks[True] >= peaks[False]:
        fail(f"R: the peak with recompute {peaks[True]} is not below "
             f"{peaks[False]}")
    return out[True]


def dryrun_predict(sess):
    """Phase DR, before the step: the dry run of this Session's next step
    (``Session.lower()``, traced on meta tensors on the host) and the
    bytes the live state and the step's batch hold on the card now (every
    distinct storage once). The argument bytes must be equal exactly."""
    from repro_torch.data import pipeline as pipe_lib
    from repro_torch.launch import trace_analysis as ta
    t0 = time.time()
    pred = sess.lower()
    trace_s = time.time() - t0
    tr = sess._ensure_train()
    batch = sess._rank_rows(pipe_lib.with_prefix_embeds(
        sess.cfg, tr["pipe"].batch(sess.step)))
    live = {"params": tr["params"], "opt_state": tr["opt_state"],
            "ef_state": tr["ef_state"], "batch": batch}
    held = {k: ta.storage_bytes(v) for k, v in live.items()}
    print(f"DR: Session.lower() traced the step in {trace_s:.1f} s on the "
          f"host: flops {pred['flops']:.4e}, arguments {pred['arguments']}, "
          f"temp {pred['memory']['temp_bytes']}, output "
          f"{pred['memory']['output_bytes']}, alias "
          f"{pred['memory']['alias_bytes']}, launches "
          f"{pred['kernel_launches']}; the live state and batch {held}",
          flush=True)
    if held != pred["arguments"]:
        fail(f"DR: the dry run's argument bytes {pred['arguments']} are "
             f"not the live state's {held}")
    return pred


def dryrun_check(pred, launches, peak) -> None:
    """Phase DR, after the step: the dry run's launches against the
    step's, its predicted peak against the measured one."""
    got = {k: v for k, v in launches.items() if v}
    if pred["kernel_launches"] != got:
        fail(f"DR: the dry run launches {pred['kernel_launches']}, the step "
             f"{got}")
    predicted = pred["memory"]["argument_bytes"] + \
        pred["memory"]["temp_bytes"]
    share = predicted / peak - 1
    print(f"DR: predicted peak {predicted} bytes (arguments "
          f"{pred['memory']['argument_bytes']} + temporaries "
          f"{pred['memory']['temp_bytes']}) against the step's "
          f"max_memory_allocated {peak}: {share:+.4f} of it (limit "
          f"±{DR_PEAK_TOL}); launches equal {got}", flush=True)
    if abs(share) > DR_PEAK_TOL:
        fail(f"DR: the predicted peak {predicted} is {share:+.4f} of the "
             f"measured {peak} (limit ±{DR_PEAK_TOL})")


def routed_drops(cfg, seen):
    """dropped_frac of each captured routing call (models/moe.py
    ``capture_routing``): an expert keeps its first C assignments in the
    stable sort's order, C from the call's tokens."""
    from repro_torch.models import moe as moe_lib
    out = []
    for top_e, _ in seen:
        N, k = top_e.shape
        counts = torch.bincount(top_e.reshape(-1),
                                minlength=cfg.num_experts)
        over = (counts - moe_lib.capacity(cfg, N)).clamp(min=0)
        out.append(float(over.sum()) / (N * k))
    return out


def serve_dense(sess, model_lib, ops, label, batch, prompt_len,
                decode_steps):
    """A D phase's serve of its model (trained, or a fresh init): K7
    exactly ``model.flash_layers`` launches in the prefill and none in
    decode; prefill and decode tok/s, cache_bytes and the peak; under MoE
    the prefill's and the decode steps' drop fractions (from the captured
    routing); the first tokens the argmax of a prefill under the served
    tree (that check prefill's launches do not count). Returns the serve's
    launches."""
    from repro_torch.models import moe as moe_lib
    tokens = torch.randint(0, sess.cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    at_decode = {}

    def hook(i):
        if i == 0:                              # the prefill's launches
            at_decode.update(ops.launches)
    with moe_lib.capture_routing() as seen:
        out = sess.serve(tokens=tokens, decode_steps=decode_steps,
                         decode_hook=hook)
    launches = dict(ops.launches)
    want = model_lib.flash_layers(sess.cfg)
    check_serve_launches(ops, at_decode, f"the {label} prefill", want)
    check_serve_launches(ops, launches, f"the {label} serve", want)
    print(f"{label} serve (batch {batch}, prompt {prompt_len}, "
          f"{decode_steps} decode steps): prefill_ms "
          f"{out['prefill_s'] * 1e3:.3f} prefill_tok_s "
          f"{out['prefill_tok_s']:.1f} decode_ms_per_token "
          f"{out['decode_s'] * 1e3 / decode_steps:.3f} decode_tok_s "
          f"{out['decode_tok_s']:.1f} cache_bytes {out['cache_bytes']} "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} "
          f"launches {launches} (K7 layers {want} of "
          f"{sess.cfg.num_layers})", flush=True)
    if seen:
        L = sess.cfg.num_layers
        drops = routed_drops(sess.cfg, seen)
        n_pre = seen[0][0].shape[0]
        print(f"{label} serve routing: prefill {n_pre} tokens, capacity "
              f"{moe_lib.capacity(sess.cfg, n_pre)}, dropped_frac "
              f"{drops[:L]}; decode {seen[L][0].shape[0]} tokens a step, "
              f"capacity {moe_lib.capacity(sess.cfg, seen[L][0].shape[0])}"
              f", dropped_frac mean {np.mean(drops[L:]):.4f} min "
              f"{min(drops[L:]):.4f} max {max(drops[L:]):.4f}", flush=True)
    toks = out["tokens"]
    if toks.shape != (batch, decode_steps + 1) or toks.min() < 0 or \
            toks.max() >= sess.cfg.vocab_size:
        fail(f"{label} serve: tokens of shape {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    first_token_check(model_lib, sess.cfg, sess.serving_params(),
                      tokens.cuda(), out, f"{label} serve")
    return launches


def serve_phase(Session, spec_lib, model_lib, ops, label, arch, cut,
                shape):
    """A serve-only D phase: the Session has no training tree and serves a
    fresh init of the spec's seed at full width cut in depth. The draw on
    the host's generator, its move to the card and the cast are timed
    apart from the serve (:func:`serve_dense`). Returns the serve's
    launches."""
    spec = load_spec(spec_lib, arch=arch, **R_PATH)
    sess = Session(spec, device="cuda")
    sess.cfg = dataclasses.replace(sess.cfg, **cut)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tree = sess.serving_params()
    torch.cuda.synchronize()
    print(f"{label}: {arch} cut {cut}, serve only: "
          f"{sum(t.numel() for t in tree.values())} parameters drawn on the "
          f"host's generator, placed and cast in {time.time() - t0:.1f} s "
          f"(max_memory_allocated {torch.cuda.max_memory_allocated()})",
          flush=True)
    del tree
    launches = serve_dense(sess, model_lib, ops, label, **shape)
    if sess._tr is not None:
        fail(f"{label}: the serve-only phase built a training state")
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def frontend_unchanged(sess):
    """D-musicgen's step hook: a zero prefix gives ``frontend_proj`` an
    exactly zero gradient, so after each step its params and every EF
    state leaf of it (the clients' v and g, the server's g and h) must be
    what they were, bit for bit (K3-K6 on all-zero rows)."""
    from repro_torch.core.ef import flatten

    def leaves():
        return {k: t for k, t in flatten({"params": sess.params,
                                          "ef_state": sess.ef_state}).items()
                if "frontend_proj" in k}
    before = {k: t.clone() for k, t in leaves().items()}
    step = sess.step

    def after():
        now = leaves()
        changed = [k for k, t in before.items() if not torch.equal(now[k], t)]
        print(f"step {step}: frontend_proj's {len(before)} leaves (params "
              f"and EF state) bit-unchanged: {not changed}", flush=True)
        if changed or len(before) < 4:
            fail(f"step {step}: frontend_proj changed at {changed} (of "
                 f"{sorted(before)})")
    return after


def moe_step_aux(sess):
    """D-olmoe's step hook: the aux values of the step about to run, from
    the clients' forward on its batch at its params (the vmap the step's
    gradients run, without the gradients): each client's dropped_frac
    and the means of the three values over the clients."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib
    batch, dp, params = sess.batch_for(sess.step), sess.n_clients, \
        sess.params
    sub = {n: x.reshape(dp, x.shape[0] // dp, *x.shape[1:])
           for n, x in batch.items()}
    with torch.no_grad():
        _, aux = torch.func.vmap(
            lambda b: model_lib.train_loss(sess.cfg, params, b))(sub)
    n = sub["tokens"].shape[1] * sub["tokens"].shape[2]
    print(f"step {sess.step} routing: {n} tokens a client, capacity "
          f"{moe_lib.capacity(sess.cfg, n)}; dropped_frac a client "
          f"{[round(float(x), 5) for x in aux['dropped_frac']]} (mean "
          f"{float(aux['dropped_frac'].mean()):.5f}); load_balance mean "
          f"{float(aux['load_balance'].mean()):.5f}; router_z mean "
          f"{float(aux['router_z'].mean()):.5f}", flush=True)


D_HOOKS = {"D-musicgen": frontend_unchanged, "D-olmoe": moe_step_aux}


def load_spec(spec_lib, name="fused_quickstart", **overrides):
    with open(os.path.join(SPECS, f"{name}.json")) as f:
        return spec_lib.RunSpec.from_dict(dict(json.load(f), **overrides))


def _codec_down(carrier_lib, comp_lib, car, comp):
    """Launches of one leaf's broadcast (``ef.downlink_sync``): the
    carrier's wire (K5 to encode; K6 to decode the sparse payload, K4 to
    integrate the dense one) or, on the dense plan, C itself."""
    out = {}
    if car.plan_down(comp) == "wire":
        if isinstance(car, carrier_lib.QuantCarrier):
            sparse = carrier_lib.has_block_wire(comp) and not isinstance(
                car, carrier_lib.FusedQuantCarrier)
            if not sparse:
                out = _compressor_launches(comp_lib, comp)
            out["block_quantize"] = out.get("block_quantize", 0) + 1
            key = "block_dequantize" if sparse else "dequant_add"
            out[key] = out.get(key, 0) + 1
        return out
    return _compressor_launches(comp_lib, comp)


def _compressor_launches(comp_lib, comp):
    """C applied as a function: BlockQuant runs K5 and K6 (the codec is
    its compressor), every other ported compressor is plain PyTorch."""
    if isinstance(comp, comp_lib.BlockQuant):
        return {"block_quantize": 1, "block_dequantize": 1}
    return {}


def expected_launches(efc, tree, gathered=0):
    """The kernel launches of one training step, derived from the EF config:
    per group of the schedule's resolution (or the whole tree without one),
    each leaf's uplink plan, its downlink and, under a non-trivial cross
    hop, each pod's cross hop. {kernel: launches a step}. ``gathered`` > 0
    counts one rank of the sharded round instead: its one pod's cross hop,
    and for the sparse quantized payload one K6 more a leaf for each of the
    ``gathered`` clients' wires its aggregate decodes."""
    from repro_torch.core import carriers as carrier_lib
    from repro_torch.core import compressors as comp_lib
    from repro_torch.core import hierarchy as hier_lib
    from repro_torch.core import schedule as sched_lib
    hops = efc.effective_hops
    pods = 0 if hops is None or hier_lib.cross_is_trivial(
        hops, efc.schedule) else hops.pods
    if efc.schedule is not None:
        legs = [(sched_lib.group_method(efc.method, g), g.carrier,
                 g.down_carrier if g.has_downlink else None, g.down_comp(),
                 None if g.trivial_cross else (g.cross_carrier,
                                               g.cross_comp()), keys)
                for g, keys in zip(efc.schedule.groups,
                                   sched_lib.group_keys(efc.schedule, tree))]
    else:
        legs = [(efc.method, efc.carrier,
                 efc.down_carrier if efc.has_downlink else None,
                 efc.down_comp(),
                 None if not pods else (hops.cross_carrier,
                                        hops.cross_comp()), list(tree))]
    counts = {}

    def add(launches, times):
        for name, n in launches.items():
            counts[name] = counts.get(name, 0) + n * times
    for method, carrier, down, down_comp, cross, keys in legs:
        car = carrier_lib.make(carrier)
        plan = car.plan(method)
        up = {"fused": {"ef21_sgdm_update": 1},
              "fused_wire": {"ef21_sgdm_topk_quant": 1,
                             "block_dequantize": 1}}.get(plan, {})
        if plan == "wire" and isinstance(car, carrier_lib.QuantCarrier):
            up = dict(_compressor_launches(comp_lib, method.compressor)
                      if not carrier_lib.has_block_wire(method.compressor)
                      or isinstance(car, carrier_lib.FusedQuantCarrier)
                      else {})
            up["block_quantize"] = up.get("block_quantize", 0) + 1
            up["block_dequantize"] = up.get("block_dequantize", 0) + 1
            if gathered and carrier_lib.has_block_wire(method.compressor) \
                    and not isinstance(car, carrier_lib.FusedQuantCarrier):
                up["block_dequantize"] += gathered
        elif plan == "dense":
            up = _compressor_launches(comp_lib, method.compressor)
        add(up, len(keys))
        if down is not None:
            add(_codec_down(carrier_lib, comp_lib, carrier_lib.make(down),
                            down_comp), len(keys))
        if cross is not None and pods:
            add(_codec_down(carrier_lib, comp_lib,
                            carrier_lib.make(cross[0]), cross[1]),
                len(keys) * (1 if gathered else pods))
    return counts


SMOKE_PATHS = [  # (label, spec, overrides, kernels the cuda run launches)
    ("fused_quant8/fused_quant4", "fused_quickstart",
     {"carrier": "fused_quant8", "downlink_carrier": "fused_quant4"},
     ("ef21_sgdm_topk_quant", "dequant_add")),
    ("quant8/quant4", "fused_quickstart",
     {"carrier": "quant8", "downlink_carrier": "quant4"},
     ("block_quantize", "block_dequantize")),
    ("quant8/quant4 identity", "fused_quickstart",
     {"carrier": "quant8", "downlink_carrier": "quant4",
      "compressor": "identity", "compressor_kw": {}},
     ("block_quantize", "dequant_add")),
    # the dense plan: the clients in one pass, C through Compressor.batched
    ("dense block_quant", "fused_quickstart",
     {"carrier": "dense", "downlink_carrier": "dense",
      "compressor": "block_quant", "compressor_kw": {"bits": 8, "block": 256}},
     ("block_quantize", "block_dequantize")),
    ("dense block_topk", "fused_quickstart",
     {"carrier": "dense", "downlink_carrier": "dense"}, ()),
    # the shipped specs of the grouped, sampled and two-tier rounds
    ("mixed_schedule", "mixed_schedule", {},
     ("block_quantize", "block_dequantize")),
    ("sampled_quarter", "sampled_quarter", {}, ()),
    ("hierarchy_quant4_cross", "hierarchy_quant4_cross", {},
     ("block_quantize", "block_dequantize")),
]


def reference_check(Session, spec_lib, ops):
    """Phase 3: the CUDA paths against the CPU paths on a small input; the
    cuda run must launch the path's kernels."""
    for label, name, overrides, kernels in SMOKE_PATHS:
        spec = load_spec(spec_lib, name, **dict(
            {"smoke": True, "seq_len": 64}, **overrides))
        runs = {}
        for device in ("cuda", "cpu"):
            sess = Session(spec, device=device, dtype="float32")
            ops.reset_launches()
            runs[device] = sess.train(2, log_every=1)
            if device == "cuda":
                idle = [k for k in kernels if not ops.launches[k]]
                if idle:
                    fail(f"smoke {label}: {idle} never launched on cuda")
        compare_runs(runs, f"smoke {label}")


def compare_runs(runs, label) -> None:
    """Phase 3's tolerance: each step's loss and g_norm on the card finite
    and within rtol 1e-3 of the CPU's."""
    for key in ("loss", "g_norm"):
        a = [r[key] for r in runs["cuda"]]
        b = [r[key] for r in runs["cpu"]]
        print(f"{label} {key}: cuda {a} cpu {b}", flush=True)
        if not all(math.isfinite(x) for x in a) or any(
                abs(x - y) > 1e-3 * abs(y) for x, y in zip(a, b)):
            fail(f"{label} {key} on cuda {a} != cpu {b} (rtol 1e-3)")


def card_bit_checks(spec_lib):
    """Phase 3, torch against torch on the card, bit for bit, over two
    rounds from the same state and gradients (smoke shapes, 8 clients): a
    one-group schedule against the ungrouped fused_quant8/fused_quant4
    round (K3, K6, K5, K4), and a fraction-1.0 cohort against the full
    round on carrier fused (K2 on the gathered cohort rows)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import ef as ef_lib
    from repro_torch.launch import build as build_lib
    from repro_torch.launch.session import Session
    fq = {"carrier": "fused_quant8", "downlink_carrier": "fused_quant4"}
    pairs = [
        ("one-group schedule vs ungrouped fused_quant8/fused_quant4", fq,
         dict(fq, groups=[dict(fq, pattern="*")])),
        ("fraction 1.0 vs full on fused", {"carrier": "fused"},
         {"carrier": "fused", "participation": {
             "mode": "sampled", "fraction": 1.0, "seed": 7}})]
    for label, a, b in pairs:
        specs = [load_spec(spec_lib, smoke=True, seq_len=64, **o)
                 for o in (a, b)]
        efcs = [build_lib.ef_config(sp) for sp in specs]
        params = Session(specs[0], device="cuda").serve_source()
        gen = torch.Generator(device="cuda").manual_seed(5)
        n = specs[0].clients

        def stack():
            return {k: torch.randn((n, *p.shape), generator=gen,
                                   device="cuda") for k, p in params.items()}
        g0 = stack()
        states = [dist.init_ef_state(efc, params, n, init_grads={
            k: v.clone() for k, v in g0.items()}) for efc in efcs]
        for step in range(2):
            grads = stack()
            outs = [dist.ef_round(efc, {k: v.clone() for k, v in
                                        grads.items()}, st, step=step)
                    for efc, st in zip(efcs, states)]
            states = [o[1] for o in outs]
            flat = [ef_lib.flatten({"g_est": o[0], **o[1]}) for o in outs]
            bad = [k for k in flat[0] if not torch.equal(flat[0][k],
                                                         flat[1][k])]
            if sorted(flat[0]) != sorted(flat[1]) or bad:
                fail(f"card bit check {label}, round {step}: {bad[:5]}")
        print(f"card bit check {label}: {len(flat[0])} leaves bit-identical "
              "over 2 rounds", flush=True)


def describe(sess, spec, efc) -> None:
    """What a path adds to the flat round: the resolved group table (leaf
    and parameter counts, plans, wire words up and down a group), the
    cohort size, and the cross-pod words a round beside the flat
    topology's (every client's uplink message crossing)."""
    from repro_torch.core import hierarchy as hier_lib
    from repro_torch.core import schedule as sched_lib
    table = sess.schedule_table()
    if table is not None:
        print("plan_table:\n" + table, flush=True)
    if efc.participation is not None:
        part = efc.participation
        print(f"participation {part.mode} fraction {part.fraction} seed "
              f"{part.seed}: cohort {part.cohort_size(sess.n_clients)} of "
              f"{sess.n_clients} a round", flush=True)
    hops = efc.effective_hops
    if hops is not None:
        sched = efc.schedule or sched_lib.CompressionSchedule.uniform(
            efc.method.compressor, efc.carrier)
        _, up = sched_lib.wire_words_tree(sched, efc.method, sess.params)
        cross = hier_lib.wire_words_cross(hops, efc.schedule, efc.method,
                                          sess.params)
        flat = sess.n_clients * up
        print(f"hops pods {hops.pods} cross {hops.cross_carrier}: cross-pod "
              f"words a round {cross:.0f}; flat words a round {flat:.0f} "
              f"({sess.n_clients} clients x {up:.0f}); ratio "
              f"{flat / cross:.2f}", flush=True)


def main_path(Session, spec_lib, ops, steps, serve=None, profile=False,
              spec_name="fused_quickstart", step_hook=None, cut=None,
              plain_check=False, **overrides):
    """Phases 4-6, 6c and D: a full-width arch through the port's Session.
    Every kernel must launch exactly as often as ``expected_launches``
    derives from the path's EF config, and no other. ``cut`` replaces
    fields of the Session's arch config (the depth) before the state is
    built. ``profile`` adds a torch.profiler reading of one more step;
    ``serve(sess)``, when given, runs on the trained session at the end
    and may return its launches, which join the path's; ``step_hook(sess)``,
    when given, runs before each step and returns a check run after it.
    ``plain_check`` records the shapes of the steps' kernel calls and, once
    the Session is freed, holds each distinct call against its plain
    version on random inputs of those shapes (:func:`check_shapes_plain`);
    those launches come after the path's count and are not in it."""
    from repro_torch.launch import build as build_lib
    spec = load_spec(spec_lib, spec_name, **overrides)
    label = (f"{spec_name} " if spec_name != "fused_quickstart" else "") + \
        (f"{spec.arch} " if spec.arch != "smollm-360m" else "") + \
        f"{spec.carrier}/{spec.downlink_carrier} {spec.compressor}" + \
        (" grouped" if spec.groups else "")
    sess = Session(spec, device="cuda")
    if cut:
        sess.cfg = dataclasses.replace(sess.cfg, **cut)
        label += f" cut {cut}"
    t0 = time.time()
    n_leaves = len(sess.params)                     # builds the train state
    torch.cuda.synchronize()
    efc = build_lib.ef_config(spec)
    per_step = expected_launches(efc, sess.params)
    print(f"{label}: {n_leaves} leaves, {spec.clients} clients, "
          f"{sum(p.numel() for p in sess.params.values())} parameters, "
          f"state built in {time.time() - t0:.1f} s; expected launches a "
          f"step {per_step}", flush=True)
    describe(sess, spec, efc)
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    ops.reset_launches()
    step_ms = []
    with (recorded_calls(ops, ROW_KERNELS, shapes_only=True) if plain_check
          else contextlib.nullcontext([])) as calls:
        for _ in range(steps):
            after = step_hook(sess) if step_hook is not None else None
            t0 = time.time()
            m = sess.step_once()
            loss, g_norm = float(m["loss"]), float(m["g_norm"])
            torch.cuda.synchronize()
            step_ms.append((time.time() - t0) * 1e3)
            print(f"step {sess.step - 1} loss {loss:.6f} g_norm "
                  f"{g_norm:.6e} step_ms {step_ms[-1]:.1f}", flush=True)
            if not (math.isfinite(loss) and math.isfinite(g_norm)):
                fail(f"non-finite loss/g_norm at step {sess.step - 1}")
            if after is not None:
                after()
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    # allocations the caching allocator retried after freeing its cache
    # (each one synchronizes the card): memory pressure near the peak
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    print(f"{label}: step_ms {step_ms} max_memory_allocated {peak} "
          f"alloc_retries {retries} launches {launches}", flush=True)
    check_launches(launches, per_step, steps, label)
    if not all(bool(torch.isfinite(p).all()) for p in sess.params.values()):
        fail("non-finite parameters after training")
    step_breakdown(sess, spec, label)
    if profile:
        step_profile(sess, label)
    if serve is not None:
        launches = _merged(launches, serve(sess) or {})
    del sess, m
    gc.collect()
    torch.cuda.empty_cache()
    if plain_check:
        from repro_torch.kernels import ref
        if _call_counts(calls) != {k: v * steps for k, v in per_step.items()
                                   if v}:
            fail(f"{label}: recorded calls {_call_counts(calls)}, expected "
                 f"{per_step} a step")
        t0 = time.time()
        shapes = check_shapes_plain(ops, ref, label, calls)
        print(f"{label}: every distinct kernel call of the steps "
              f"bit-identical to the plain version on random inputs of its "
              f"shapes ({time.time() - t0:.1f} s): {shapes}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def check_launches(launches, per_step, steps, label) -> None:
    for name, count in launches.items():
        want = per_step.get(name, 0) * steps
        if count != want:
            fail(f"{name} launched {count} times on the {label} path, "
                 f"expected {per_step.get(name, 0)} a step x {steps} "
                 f"steps = {want}")


def client_checksums(sess):
    """Per client, EF state entry and leaf: the integer sum of the bit
    patterns (exact: any changed bit shows), on the card."""
    out = {}
    for name, tree in sess.ef_state["clients"].items():
        for key, t in tree.items():
            bits = t.view(torch.int16 if t.element_size() == 2
                          else torch.int32).reshape(t.shape[0], -1)
            for i in range(t.shape[0]):
                out[(name, key, i)] = int(bits[i].sum(dtype=torch.int64))
    return out


def frozen_check(part_lib, build_lib):
    """Phase S's step hook: print the step's cohort (the port's
    ``cohort_mask_np``), checksum every client's v and g before the step,
    and after it require the non-sampled clients' bits unchanged and every
    sampled client's state moved."""
    def hook(sess):
        mask = part_lib.cohort_mask_np(
            build_lib.make_participation(sess.spec), sess.n_clients,
            sess.step)
        cohort = [int(i) for i in mask.nonzero()[0]]
        before = client_checksums(sess)
        step = sess.step

        def after():
            now = client_checksums(sess)
            frozen = [k for k in before if k[2] not in cohort]
            changed = [k for k in frozen if now[k] != before[k]]
            moved = {k[2] for k in before
                     if k[2] in cohort and now[k] != before[k]}
            print(f"step {step} cohort {cohort} (cohort_mask_np "
                  f"{mask.tolist()}): {len(frozen)} frozen client leaves "
                  f"bit-unchanged: {not changed}; sampled clients moved "
                  f"{sorted(moved)}", flush=True)
            if changed:
                fail(f"step {step}: non-sampled client state changed at "
                     f"{changed[:5]}")
            if moved != set(cohort):
                fail(f"step {step}: sampled clients {cohort} moved only "
                     f"{sorted(moved)}")
        return after
    return hook


def step_breakdown(sess, spec, label) -> None:
    """One more step, split by the host clock (each part ends in a
    synchronize) into client gradients, the EF round and the optimizer —
    run after the launch counts were read, from the same public functions
    the step is made of."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch import build as build_lib
    from repro_torch.models import model as model_lib
    from repro_torch.optim import optimizer as opt_lib
    efc = build_lib.ef_config(spec)
    opt = opt_lib.make(spec.optimizer, lr=spec.lr)
    batch = sess.batch_for(sess.step)
    t = [time.time()]
    _, _, grads = dist.per_client_value_and_grad(
        lambda p, b: model_lib.train_loss(sess.cfg, p, b), sess.params, batch,
        sess.n_clients)
    torch.cuda.synchronize()
    t.append(time.time())
    g_est, _ = dist.ef_round(efc, grads, sess.ef_state, step=sess.step)
    del grads
    torch.cuda.synchronize()
    t.append(time.time())
    updates, _ = opt.update(g_est, sess.opt_state, sess.params, sess.step)
    opt_lib.apply_updates(sess.params, updates)
    torch.cuda.synchronize()
    t.append(time.time())
    ms = [round((b - a) * 1e3, 1) for a, b in zip(t, t[1:])]
    print(f"{label} step breakdown ms: "
          f"client_grads {ms[0]} ef_round {ms[1]} optimizer {ms[2]} "
          f"(EF round share {ms[1] / max(sum(ms), 1e-9):.3f})", flush=True)


def step_profile(sess, label) -> None:
    """Where a training step's time goes: one more step timed by the host
    clock (ending in a synchronize), then torch.profiler (CPU and CUDA
    activity) around the next two, the second read (:func:`profiled`): the
    device's busy ms against the unprofiled wall ms (the idle share) and
    the five ops with the most device time."""
    torch.cuda.synchronize()
    t0 = time.time()
    sess.step_once()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    busy, by_op = device_ms(profiled(sess.step_once))
    if busy <= 0:
        print(f"profile {label} step: no device time in the trace (not "
              "measured)", flush=True)
        return
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile {label} step: device busy ms {busy:.3f} of {wall:.3f} "
          f"unprofiled wall ms (idle share {1 - busy / wall:.3f}); top ops "
          f"by device ms {[(k[:40], round(t, 3)) for k, t in top]}",
          flush=True)


def leaf_checksums(sess):
    """Per leaf of params, opt_state and ef_state: the f64 sum of its
    values and the integer sum of its bit patterns (exact, so any changed
    bit shows)."""
    from repro_torch.core.ef import flatten
    flat = flatten({"params": sess.params, "opt_state": sess.opt_state,
                    "ef_state": sess.ef_state})
    out = {}
    for key, t in flat.items():
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        out[key] = (float(t.double().sum()), int(bits.long().sum()))
    return out


def resume_path(Session, spec_lib, ops):
    """Phase 6b: the resumable full-width path; see the module doc."""
    base = tempfile.gettempdir()
    free = shutil.disk_usage(base).free
    print(f"checkpoint directory under {base}: {free} bytes free", flush=True)
    if free < CKPT_FREE_BYTES:
        fail(f"{base} has {free} bytes free; the checkpoint needs "
             f"{CKPT_FREE_BYTES:.0f}")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base)
    try:
        with arch_cut(RESUME_CUT):
            return _resume_path(Session, spec_lib, ops, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _resume_path(Session, spec_lib, ops, ckpt_dir):
    from repro_torch.launch import build as build_lib
    spec = load_spec(spec_lib, ckpt_dir=ckpt_dir, **RESUME_PATH)
    label = (f"resumable bf16/adamw fused_quant8/fused_quant4 "
             f"({RESUME_CUT['num_layers']} layers)")
    sess = Session(spec, device="cuda")
    per_step = expected_launches(build_lib.ef_config(spec), sess.params)
    clients = [t for tree in sess.ef_state["clients"].values()
               for t in tree.values()]
    ef_bytes = sum(t.numel() * t.element_size() for t in clients)
    ef_f32 = sum(t.numel() * 4 for t in clients)
    print(f"{label}: EF state {ef_bytes} bytes in "
          f"{sorted({str(t.dtype) for t in clients})} (f32 would be "
          f"{ef_f32})", flush=True)
    if any(t.dtype != torch.bfloat16 for t in clients) or \
            2 * ef_bytes != ef_f32:
        fail("the EF state is not bfloat16 at half of f32's bytes")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()

    def step(s):
        t0 = time.time()
        m = s.step_once()
        loss, g_norm = float(m["loss"]), float(m["g_norm"])
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        print(f"{label} step {s.step - 1} loss {loss:.6f} g_norm "
              f"{g_norm:.6e} step_ms {ms:.1f}", flush=True)
        if not (math.isfinite(loss) and math.isfinite(g_norm)):
            fail(f"non-finite loss/g_norm at step {s.step - 1}")
        return loss, g_norm, ms

    steps = [step(sess) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.time()
    path = sess.save()
    save_s = time.time() - t0
    disk = os.path.getsize(path)
    saved = leaf_checksums(sess)
    # what the npz holds: every leaf as f32 (bf16 is stored widened)
    leaf_bytes = sum(t.numel() * 4 for t in (
        list(sess.params.values())
        + [t for tree in sess.opt_state.values() for t in tree.values()]
        + clients + list(sess.ef_state["server"].values())
        + list(sess.ef_state["h"].values())))
    print(f"{label}: saved {path} ({disk} bytes on disk, {leaf_bytes} of "
          f"them leaves) in {save_s:.2f} s", flush=True)
    for key, (total, bits) in saved.items():
        print(f"  checksum {key}: f64 sum {total!r} bit sum {bits}",
              flush=True)
    steps.append(step(sess))
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: step_ms {[round(s[2], 1) for s in steps]} "
          f"max_memory_allocated {peak} launches {launches}", flush=True)
    check_launches(launches, per_step, 3, label)
    del sess
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.time()
    sess = Session.resume(ckpt_dir, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    print(f"{label}: resumed at step {sess.step} in {restore_s:.2f} s",
          flush=True)
    got = leaf_checksums(sess)
    bad = [k for k in saved if got.get(k) != saved[k]]
    if sess.step != 2 or sorted(got) != sorted(saved) or bad:
        fail(f"the resumed state differs from the saved one at step "
             f"{sess.step}: leaves {bad[:5]}")
    print(f"{label}: all {len(saved)} restored leaves equal the saved ones "
          "(f64 and bit sums)", flush=True)
    ops.reset_launches()
    loss, g_norm, ms = step(sess)
    resumed_launches = dict(ops.launches)
    check_launches(resumed_launches, per_step, 1, f"{label} resumed step")
    for name, a, b in (("loss", loss, steps[2][0]),
                       ("g_norm", g_norm, steps[2][1])):
        if abs(a - b) > 1e-3 * abs(b):
            fail(f"resumed step 2 {name} {a} != uninterrupted {b} "
                 "(rtol 1e-3)")
    print(f"{label}: resumed step 2 loss {loss:.6f} g_norm {g_norm:.6e} "
          f"against uninterrupted {steps[2][0]:.6f} {steps[2][1]:.6e}; "
          f"save_s {save_s:.2f} restore_s {restore_s:.2f} checkpoint_bytes "
          f"{disk} ef_state_bytes {ef_bytes} (f32 {ef_f32}) launches "
          f"K1 {launches['block_topk']} K2 {launches['ef21_sgdm_update']} "
          f"K3 {launches['ef21_sgdm_topk_quant']}", flush=True)
    step_breakdown(sess, sess.spec, label)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase P: the paper's simulator (core/problems.py, core/simulate.py,
# participation.run_async) on the card
# ---------------------------------------------------------------------------

SIM_KERNELS = ("block_topk", "ef21_sgdm_update", "ef21_sgdm_topk_quant",
               "dequant_add", "block_quantize", "block_dequantize")


@contextlib.contextmanager
def recorded_calls(ops, names=SIM_KERNELS, shapes_only=False):
    """Within: every call of the wrappers ``names`` runs as before and is
    kept as (name, bound arguments, outputs), the tensors cloned at the
    call (a state update in place overwrites its inputs). ``shapes_only``
    keeps each tensor argument as a meta tensor of its shape and dtype (one
    that is an earlier argument, as ``v_out`` is ``v`` in place, as that
    argument's name) and no outputs."""
    calls, saved = [], {n: getattr(ops, n) for n in names}

    def shapes(arguments):
        args, seen = {}, {}
        for k, v in arguments.items():
            if isinstance(v, torch.Tensor) and id(v) in seen:
                args[k] = seen[id(v)]
            elif isinstance(v, torch.Tensor):
                seen[id(v)] = k
                args[k] = torch.empty(v.shape, dtype=v.dtype, device="meta")
            else:
                args[k] = v
        return args

    def wrap(name, fn):
        sig = inspect.signature(fn)

        def rec(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            if shapes_only:
                calls.append((name, shapes(bound.arguments), ()))
                return fn(*a, **kw)
            args = {k: v.clone() if isinstance(v, torch.Tensor) else v
                    for k, v in bound.arguments.items()}
            out = fn(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            calls.append((name, args, tuple(t.clone() for t in outs)))
            return out
        return rec
    for n, fn in saved.items():
        setattr(ops, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def _call_shape(name, args) -> str:
    if name in ("ef21_sgdm_update", "ef21_sgdm_topk_quant"):
        return f"{tuple(args['grad'].shape)} k {args['k']}" + (
            f" bits {args['bits']}" if "bits" in args else "")
    if name == "dequant_add":
        return (f"{tuple(args['q'].shape)} d {args['base'].numel()} block "
                f"{args['block']} bits {args['bits']} alpha {args['alpha']}")
    if name == "block_quantize":
        return f"{tuple(args['x_rows'].shape)} bits {args['bits']}"
    if name == "block_dequantize":
        return f"{tuple(args['q'].shape)} cols {args['cols']} bits " \
               f"{args['bits']}"
    return f"{tuple(args['x'].shape)} block {args['block']} k {args['k']}"


def check_calls_plain(ref, label, calls):
    """Each recorded wrapper call against its kernel's plain version
    (``ref.<name>_plain``) on the same inputs: bit for bit, or the run
    fails. Returns {kernel: sorted shapes it ran at}."""
    shapes = {}
    for name, args, outs in calls:
        plain = getattr(ref, f"{name}_plain")
        params = inspect.signature(plain).parameters
        kw = {p: args["x_rows" if p == "x" and name == "block_quantize"
                      else p] for p in params}
        want = plain(**kw)
        want = want if isinstance(want, tuple) else (want,)
        where = _call_shape(name, args)
        check_equal(f"{label}: {name} {where}", outs, want)
        shapes.setdefault(name, set()).add(where)
    return {k: sorted(v) for k, v in shapes.items()}


ROW_KERNELS = SIM_KERNELS[1:]   # K2-K6: (rows, ...) in, rows independent
PLAIN_ROWS = 1 << 18            # rows a plain-version call of a leaf check


def _random_input(arg, t, gen, device):
    """A tensor of meta tensor ``t``'s shape and dtype: mantissas over their
    whole range, scales in [0, 1e-3), other values normal."""
    if t.dtype in (torch.int8, torch.uint8):
        lo, hi = (-127, 128) if t.dtype == torch.int8 else (0, 256)
        return torch.randint(lo, hi, t.shape, generator=gen, device=device,
                             dtype=t.dtype)
    if arg == "scales":
        return torch.rand(t.shape, generator=gen, device=device) * 1e-3
    return torch.randn(t.shape, generator=gen, device=device).to(t.dtype)


def _rows(name, args, r0, r1, outs=None):
    """Rows r0:r1 of a K2-K6 call's tensor arguments (``outs``: of its
    outputs); K4's flat base and output hold ``block`` values a row."""
    def cut(k, t):
        if name == "dequant_add" and k in ("base", None):
            return t[r0 * args["block"]:r1 * args["block"]]
        return t[r0:r1]
    if outs is not None:
        return [cut(None, t) for t in outs]
    return {k: cut(k, v) if isinstance(v, torch.Tensor) else v
            for k, v in args.items()}


def check_shapes_plain(ops, ref, label, calls, device="cuda"):
    """Each distinct call of a shape-only record (:func:`recorded_calls`)
    of K2-K6, run again on random inputs of its shapes and dtypes (in place
    where the recorded call was) and held bit for bit against the plain
    version on the same inputs, ``PLAIN_ROWS`` rows at a time (a leaf's
    plain temporaries stay small beside its inputs). Returns {kernel:
    sorted shapes}."""
    distinct = {}
    for name, meta, _ in calls:
        key = repr((name, {k: (tuple(v.shape), v.dtype)
                           if isinstance(v, torch.Tensor) else v
                           for k, v in meta.items()}))
        distinct.setdefault(key, (name, meta))
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = {}
    for name, meta in distinct.values():
        args = {k: _random_input(k, v, gen, device)
                if isinstance(v, torch.Tensor) else v
                for k, v in meta.items() if not isinstance(v, str)}
        # the kernel writes copies of what it updates in place; the plain
        # version reads the originals
        kw = dict(args)
        for k, v in meta.items():
            if isinstance(v, str):                  # v_out is v
                if kw[v] is args[v]:
                    kw[v] = args[v].clone()
                kw[k] = kw[v]
        outs = getattr(ops, name)(**kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        del kw
        plain = getattr(ref, f"{name}_plain")
        params = inspect.signature(plain).parameters
        where = _call_shape(name, args)
        rows = args["x_rows" if name == "block_quantize" else
                    "q" if "q" in args else "grad"].shape[0]
        for r0 in range(0, rows, PLAIN_ROWS):
            r1 = min(rows, r0 + PLAIN_ROWS)
            part = _rows(name, args, r0, r1)
            want = plain(**{p: part["x_rows" if p == "x" and
                                    name == "block_quantize" else p]
                            for p in params})
            want = want if isinstance(want, tuple) else (want,)
            check_equal(f"{label}: {name} {where} rows {r0}:{r1}",
                        _rows(name, args, r0, r1, outs), want)
            del part, want
        shapes.setdefault(name, set()).add(where)
        del args, outs
    return {k: sorted(v) for k, v in shapes.items()}


def sim_run(ops, label, problem, method, cfg, seed=0):
    """One simulator run on the card through ``simulate.Simulation`` (the
    entry point ``simulate.run`` drives): the launches of its rounds must
    equal ``expected_launches`` of the run's EF config a round; prints the
    steps, ms a step (host clock, ending in a synchronize), one round's
    device busy ms and idle share under torch.profiler (the mean of
    ``P_PROFILED`` more rounds against as many timed unprofiled), the peak
    bytes and the ‖∇f‖² of the first and last rounds; one more round's
    kernel calls are held against the plain versions
    (:func:`check_calls_plain`). Returns (result, launches)."""
    from repro_torch.core import simulate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sim = simulate.Simulation(problem, method, cfg, seed)
    per_step = expected_launches(sim.efc, sim.x)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.time()
    for _ in range(cfg.steps):
        sim.step()
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / cfg.steps
    launches = dict(ops.launches)
    check_launches(launches, per_step, cfg.steps, label)
    out = sim.result()
    gn = out["grad_norm_sq"].cpu()
    if gn.shape != (cfg.steps,) or not bool(torch.isfinite(gn).all()) or \
            not bool(torch.isfinite(out["loss"]).all()):
        fail(f"{label}: non-finite or misshapen metrics")
    peak = torch.cuda.max_memory_allocated()
    # one more round with every wrapper call kept: each kernel at the
    # shapes this run gives it, against its plain version on the same
    # inputs, bit for bit
    from repro_torch.kernels import ref
    with recorded_calls(ops) as calls:
        sim.step()
    torch.cuda.synchronize()
    counts = {}
    for name, _, _ in calls:
        counts[name] = counts.get(name, 0) + 1
    if counts != {k: v for k, v in per_step.items() if v}:
        fail(f"{label}: the recorded round called {counts}, expected "
             f"{per_step}")
    shapes = check_calls_plain(ref, label, calls)
    del calls
    if shapes:
        print(f"{label}: one round's {sum(counts.values())} kernel calls "
              f"bit-identical to the plain versions on the same inputs: "
              f"{shapes}", flush=True)
    # P_PROFILED more rounds by the host clock, then as many under the
    # profiler: one round's device busy ms and idle share, their mean
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(P_PROFILED):
        sim.step()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3 / P_PROFILED
    busy = device_ms(profiled(
        lambda: [sim.step() for _ in range(P_PROFILED)]))[0] / P_PROFILED
    prof_txt = (f"device busy ms {busy:.4f} of {wall:.4f} unprofiled wall "
                f"ms (idle share {1 - busy / wall:.3f}; mean of "
                f"{P_PROFILED} rounds)" if busy > 0 else
                "device busy not measured (no device time in the trace)")
    print(f"{label}: steps {cfg.steps} ms_a_step {ms:.4f}; one step "
          f"{prof_txt}; max_memory_allocated {peak}; grad_norm_sq "
          f"{float(gn[0]):.6e} -> {float(gn[-1]):.6e}; launches "
          f"{ {k: v for k, v in launches.items() if v} } (expected a step "
          f"{per_step})", flush=True)
    return out, launches


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


# the problem of each simulator cell: (class in core/problems.py, kwargs)
P_PROBLEMS = {"P-fig1": ("QuadraticT1", {}),
              "P-exp1": ("LogisticRegression", P_EXP1),
              "P-exp3": ("RandomQuadratics", P_EXP3),
              "P-exp4": ("MLPClassification", P_EXP4)}


def p_runs(simulate, ef_lib, comp_lib):
    """Phase P's simulator runs, [(cell, label, method, SimConfig)]: the
    launch counts of each are derived from its config
    (tests/test_torch_chip_smoke.py holds the derivation to the wrappers'
    calls)."""
    top1 = comp_lib.TopK(k=1)
    btk1 = comp_lib.BlockTopK(block=1024, k_per_block=1)
    runs = []
    for n in P_FIG1["ns"]:
        for name, m in (("ef21_sgd", ef_lib.EF21SGD(compressor=top1)),
                        ("ef21_sgdm", ef_lib.EF21SGDM(compressor=top1,
                                                      eta=1e-3))):
            runs.append(("P-fig1", f"n {n} {name}", m, simulate.SimConfig(
                n=n, batch_size=1, gamma=P_FIG1["gamma"],
                steps=P_FIG1["steps"])))
    m1 = ef_lib.EF21SGDM(compressor=btk1, eta=0.1)
    for carrier in ("fused", "quant4"):
        for B in (1, 128):
            runs.append(("P-exp1", f"{carrier} B {B}", m1, simulate.SimConfig(
                n=P_EXP1["n"], batch_size=B, gamma=0.05, steps=P_EXP1_STEPS,
                carrier=carrier)))
    topk = comp_lib.TopK(k=50)
    for name, m in (("ef14_sgd", ef_lib.EF14SGD(compressor=topk)),
                    ("ef21_sgdm", ef_lib.EF21SGDM(compressor=topk,
                                                  eta=0.02))):
        runs.append(("P-exp3", name, m, simulate.SimConfig(
            n=P_EXP3["n"], batch_size=1, gamma=0.05, steps=P_EXP3_STEPS,
            b_init=4)))
    runs.append(("P-exp4", "fused_quant8/fused_quant4 B 32",
                 ef_lib.EF21SGDM(compressor=comp_lib.BlockTopK(
                     block=1024, ratio=0.2), eta=0.1),
                 simulate.SimConfig(
                     n=P_EXP4["n"], batch_size=32, gamma=0.05,
                     steps=P_EXP4_STEPS, carrier="fused_quant8",
                     down_carrier="fused_quant4",
                     down_compressor=comp_lib.BlockTopK(block=1024,
                                                        ratio=0.05))))
    btk = comp_lib.BlockTopK(block=16, k_per_block=4)
    for up, down, _ in P_SMOKE:
        runs.append(("P-smoke", f"{up}/{down}",
                     ef_lib.EF21SGDM(compressor=btk, eta=0.2),
                     simulate.SimConfig(
                         n=4, gamma=0.05, steps=50, carrier=up,
                         down_carrier=down,
                         down_compressor=btk if down != "dense" else None)))
    return runs


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def p_fig1(ops, problems, runs):
    """P-fig1: Theorem 1's quadratic, Top-1, B 1, n 1 and 8, EF21-SGD and
    EF21-SGDM, seeds on the card's generator; test_fig1's two inequalities
    at n 1, and at every n EF21-SGD ends above twice its start (Figure
    1b)."""
    prob = problems.QuadraticT1(device="cuda")
    total, ends, starts = {}, {}, {}
    for _, label, m, cfg in runs:
        curves = []
        for seed in range(P_FIG1["seeds"][cfg.n]):
            out, launches = sim_run(ops, f"P-fig1 {label} seed {seed}", prob,
                                    m, cfg, seed)
            _add(total, launches)
            curves.append(out["grad_norm_sq"].cpu().numpy())
        ends[(cfg.n, m.name)] = _median([float(c[-500:].mean())
                                         for c in curves])
        starts[(cfg.n, m.name)] = _median([float(c[0]) for c in curves])
    for n in P_FIG1["ns"]:
        sgd, sgdm = ends[(n, "ef21_sgd")], ends[(n, "ef21_sgdm")]
        start = starts[(n, "ef21_sgd")]
        print(f"P-fig1 n {n}: start {start:.6e}; end (last 500 steps, "
              f"median over seeds) ef21_sgd {sgd:.6e} ef21_sgdm {sgdm:.6e}",
              flush=True)
        if n == 1 and not (sgd > 10 * start and sgdm < sgd / 3):
            fail("P-fig1: Figure 1's inequalities do not hold on the card")
        if sgd <= 2 * start:
            fail(f"P-fig1: EF21-SGD converged at n {n} (Figure 1b)")
    return total


def p_exp1(ops, problems, runs):
    """P-exp1: logistic regression at MNIST's shape (n 10, 6000 samples a
    client, 784 features, 10 classes: d 7,850, 188 MB of data), EF21-SGDM
    η 0.1 with BlockTopK(1024, k_per_block 1), on carrier fused (K2) and
    quant4 (K5/K6), at B 1 and 128."""
    t0 = time.time()
    prob = problems.LogisticRegression(device="cuda", **P_EXP1)
    torch.cuda.synchronize()
    print(f"P-exp1 problem: d {prob.dim}, data bytes "
          f"{prob._A.numel() * 4 + prob._Y.numel() * 4}, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    total = {}
    for _, label, m, cfg in runs:
        out, launches = sim_run(ops, f"P-exp1 {label}", prob, m, cfg)
        _add(total, launches)
        print(f"P-exp1 {label}: coords a round {out['coords_per_round']}, "
              f"wire words up {out['wire_words_up_per_round']}", flush=True)
    return prob, total


def p_exp3(ops, problems, runs):
    """P-exp3: Algorithm 2's quadratics at its size (n 100, d 1000: Q is
    400 MB), EF14-SGD against EF21-SGDM (η 0.02), TopK(k 50), the dense
    plan, every client's Qᵢx one batched product."""
    t0 = time.time()
    prob = problems.RandomQuadratics(device="cuda", **P_EXP3)
    torch.cuda.synchronize()
    print(f"P-exp3 problem: Q bytes {prob._Q.numel() * 4}, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    total, ends = {}, {}
    for _, label, m, cfg in runs:
        out, launches = sim_run(ops, f"P-exp3 {label}", prob, m, cfg)
        _add(total, launches)
        ends[label] = float(out["grad_norm_sq"][-200:].mean())
    print(f"P-exp3 end grad_norm_sq (last 200): {ends}", flush=True)
    return total


def p_exp4(ops, problems, runs):
    """P-exp4: the MLP at CIFAR-10's input width and ResNet-18's size (n 5,
    10,000 samples a client, 3072 in, 2048 hidden, 10 classes: d
    10,510,346, 614 MB of data), EF21-SGDM η 0.1, BlockTopK(1024, ratio
    0.2) on fused_quant8 up (K3, K6) and fused_quant4 down at ratio 0.05
    (K5, K4), B 32, f32 products."""
    t0 = time.time()
    prob = problems.MLPClassification(device="cuda", **P_EXP4)
    d = sum(v.numel() for v in prob.init_x().values())
    torch.cuda.synchronize()
    print(f"P-exp4 problem: d {d}, data bytes {prob._A.numel() * 4}, "
          f"built in {time.time() - t0:.1f} s", flush=True)
    ((_, label, m, cfg),) = runs
    out, launches = sim_run(ops, f"P-exp4 {label}", prob, m, cfg)
    acc = float(prob.accuracy(out["x_final"]))
    print(f"P-exp4: loss {float(out['loss'][0]):.6f} -> "
          f"{float(out['loss'][-1]):.6f}, accuracy {acc:.4f}; wire words up "
          f"{out['wire_words_up_per_round']} down "
          f"{out['wire_words_down_per_round']} a round", flush=True)
    return launches


def p_async(ops, problems, ef_lib, comp_lib, part_lib, prob):
    """P-async: run_async on P-exp1's problem, 10 clients, heavy-tailed
    arrivals, 20 rounds; the event accounting must equal a CPU run's with
    the same seed (the event queue is numpy's), and the async wall clock
    must beat the barrier's."""
    m = ef_lib.EF21SGDM(compressor=comp_lib.BlockTopK(block=1024,
                                                      k_per_block=1),
                        eta=0.1)
    kw = dict(n=P_EXP1["n"], gamma=0.05, rounds=P_ASYNC_ROUNDS,
              arrival=part_lib.ArrivalModel(kind="heavy_tail"), seed=3)
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    card = part_lib.run_async(prob, m, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    busy = device_ms(profiled(lambda: part_lib.run_async(prob, m, **kw)))[0]
    small = problems.LogisticRegression(n=P_EXP1["n"], m_per_client=32, l=8,
                                        c=10, device="cpu")
    cpu = part_lib.run_async(small, m, **kw)
    keys = ("wall_clock", "rounds", "arrivals_applied", "arrivals_dropped",
            "arrivals_discarded", "max_staleness", "mean_staleness",
            "sync_wall_clock")
    diff = [k for k in keys if card[k] != cpu[k]]
    if diff or not (card["stale_age_hist"] == cpu["stale_age_hist"]).all():
        fail(f"P-async: event accounting differs from the CPU run's: {diff}")
    if not card["wall_clock"] < card["sync_wall_clock"]:
        fail("P-async: the async wall clock does not beat the barrier's")
    if any(launches.values()):
        fail(f"P-async: kernels launched {launches}; the single-client "
             "update runs none")
    prof_txt = (f"device busy ms {busy:.3f} over a second run (idle share "
                f"{1 - busy / (wall * 1e3):.3f})" if busy > 0 else
                "device busy not measured (no device time in the trace)")
    print(f"P-async: {card['arrivals_applied']} uploads in {wall * 1e3:.1f} "
          f"ms ({wall * 1e3 / card['arrivals_applied']:.3f} ms an upload); "
          f"{prof_txt}; max_memory_allocated {peak}; "
          f"wall_clock {card['wall_clock']:.4f} sync_wall_clock "
          f"{card['sync_wall_clock']:.4f}; max_staleness "
          f"{card['max_staleness']} mean {card['mean_staleness']:.3f}; "
          f"grad_norm_sq {card['grad_norm_sq']:.6e}; equal to the CPU run's "
          f"events", flush=True)
    return launches


P_SMOKE = [  # (carrier, downlink carrier, kernels the card run launches)
    ("fused", "dense", ("ef21_sgdm_update",)),
    ("fused_quant8", "fused_quant4", ("ef21_sgdm_topk_quant", "dequant_add",
                                      "block_quantize", "block_dequantize")),
    ("quant4", "dense", ("block_quantize", "block_dequantize")),
]


def p_card_vs_cpu(ops, problems, simulate, runs):
    """The simulator free of randomness (σ = 0 quadratics: the noise is
    drawn and multiplied by 0) on the card and on the CPU, 50 steps, per
    carrier: ‖∇f‖² and loss within rtol 1e-3; each card run launches its
    carrier's kernels."""
    total = {}
    for (_, label, m, cfg), (_, _, kernels) in zip(runs, P_SMOKE):
        out = {}
        for device in ("cuda", "cpu"):
            prob = problems.RandomQuadratics(n=cfg.n, d=64, lam=0.05,
                                             sigma=0.0, seed=0, device=device)
            ops.reset_launches()
            out[device] = simulate.run_numpy(prob, m, cfg, seed=0)
            if device == "cuda":
                _add(total, ops.launches)
                idle = [k for k in kernels if not ops.launches[k]]
                if idle:
                    fail(f"P smoke {label}: {idle} never launched")
        for key in ("grad_norm_sq", "loss"):
            a, b = out["cuda"][key], out["cpu"][key]
            err = float(np.max(np.abs(a - b) / np.abs(b)))
            print(f"P smoke {label} {key}: max rel err card vs cpu "
                  f"{err:.3e} over {cfg.steps} steps", flush=True)
            if not np.isfinite(a).all() or err > P_TOL:
                fail(f"P smoke {label} {key}: card vs cpu {err} > {P_TOL}")
    return total


def sim_phase(ops):
    """Phase P, cell by cell; returns {cell: launches}."""
    from repro_torch.core import compressors as comp_lib
    from repro_torch.core import ef as ef_lib
    from repro_torch.core import participation as part_lib
    from repro_torch.core import problems, simulate
    t0 = time.time()
    runs = {}
    for row in p_runs(simulate, ef_lib, comp_lib):
        runs.setdefault(row[0], []).append(row)
    cells = {"P-fig1": p_fig1(ops, problems, runs["P-fig1"])}
    prob, cells["P-exp1"] = p_exp1(ops, problems, runs["P-exp1"])
    cells["P-async"] = p_async(ops, problems, ef_lib, comp_lib, part_lib,
                               prob)
    del prob
    cells["P-exp3"] = p_exp3(ops, problems, runs["P-exp3"])
    cells["P-exp4"] = p_exp4(ops, problems, runs["P-exp4"])
    cells["P-smoke"] = p_card_vs_cpu(ops, problems, simulate,
                                     runs["P-smoke"])
    print(f"phase P: {time.time() - t0:.1f} s; launches by cell "
          f"{ {c: {k: v for k, v in n.items() if v} for c, n in cells.items()} }",
          flush=True)
    return cells


def rates_phase(ops):
    """P-rates: the paper's Tables 1–2 check
    (``experiments/complexity_check.py``) at its full horizons on the
    card: the log-log slope of EF21-SGDM's running-average ‖∇f‖² against
    T on QuadraticT1, σ 0 (about −1) and σ 1 with η ∝ T^−1/2 (about −1/2).
    Fails unless both claims hold; returns its launches (none: TopK(1)
    runs no kernel)."""
    from repro_torch.experiments import complexity_check as cc
    ops.reset_launches()
    t0 = time.time()
    out = cc.run(device="cuda")
    seconds = time.time() - t0
    rounds = cc.DET_SEEDS * max(cc.TS) + cc.STOCH_SEEDS * sum(cc.TS)
    launches = {k: v for k, v in ops.launches.items() if v}
    det, st = out["deterministic"], out["stochastic"]
    print(f"P-rates: Ts {list(cc.TS)}: σ 0 slope {det['slope']:.4f} "
          f"(theory −1; values {det['vals']}), σ 1 slope {st['slope']:.4f} "
          f"(theory −1/2; values {st['vals']}); claims {out['claims']}; "
          f"{rounds} rounds in {seconds:.1f} s "
          f"({seconds / rounds * 1e3:.3f} ms a round); launches {launches}",
          flush=True)
    if not all(out["claims"].values()):
        fail(f"P-rates: a claim of the paper's rates fails: "
             f"{out['claims']} (slopes {det['slope']:.4f}, "
             f"{st['slope']:.4f})")
    return launches


# ---------------------------------------------------------------------------
# phase F: the wire stream and the serving fleet (core/stream.py,
# launch/transport.py, launch/fleet.py, launch/replica_worker.py)
# ---------------------------------------------------------------------------

F_PATH = dict(carrier="fused_quant8", downlink_carrier="fused_quant4")
# its clients (the script's time limit: 8 clients' EF state made a
# bootstrap of 27.5 GB, saved in 40 s). A depth cut would not reach the
# worker processes, which build their Session from the stream's spec; the
# client count is in that spec, and no replica restores a client's state
F_CLIENTS = 2
F_STEPS = 3                    # published steps before the serve
# 8 new tokens a request (32 until the script passed its limit on a slow
# host: the time limit)
F_SERVE = dict(n=16, prompt_len=1024, max_new_tokens=8)
F_BUDGET, F_BATCH = 64, 8      # decode budget, max batch (8 x 8 = 64)
F_PROC = dict(n=8, rate=4.0, max_batch=4, kill_after_s=1.0)
# the smoke-size stream served over tcp://: the sparse payload down (K6
# integrates it)
F_TCP = dict(smoke=True, seq_len=64, carrier="quant8",
             downlink_carrier="quant4")
STREAM_KERNELS = ("block_quantize", "block_dequantize", "dequant_add")


def _codec_apply(carrier_lib, car, comp):
    """Launches of one leaf's integrate (``carriers.downlink_apply``): K6
    decodes the sparse payload, K4 integrates the dense one; the dense plan
    adds C(δ) as it is."""
    if car.plan_down(comp) == "wire" and isinstance(
            car, carrier_lib.QuantCarrier):
        sparse = carrier_lib.has_block_wire(comp) and not isinstance(
            car, carrier_lib.FusedQuantCarrier)
        return {"block_dequantize" if sparse else "dequant_add": 1}
    return {}


def stream_launches(efc, tree):
    """(publish, apply): the kernel launches of one publish (the re-encode
    and its verify run ``ef.downlink_sync``'s operations a leaf) and of one
    replica apply (``downlink_apply`` a leaf), derived from the EF config's
    downlink legs (``stream.resolve_legs``)."""
    from repro_torch.core import carriers as carrier_lib
    from repro_torch.core import compressors as comp_lib
    from repro_torch.core import stream as stream_lib
    pub, app = {}, {}
    for leg in stream_lib.resolve_legs(
            tree, schedule=efc.schedule, down_carrier=efc.down_carrier,
            down_compressor=efc.down_compressor):
        if leg.carrier is None:
            continue
        for counts, launches in (
                (pub, _codec_down(carrier_lib, comp_lib, leg.carrier,
                                  leg.comp)),
                (app, _codec_apply(carrier_lib, leg.carrier, leg.comp))):
            for name, n in launches.items():
                counts[name] = counts.get(name, 0) + n * len(leg.keys)
    return pub, app


def _merged(*counts):
    out = {}
    for c in counts:
        _add(out, c)
    return out


def _call_counts(calls):
    out = {}
    for name, _, _ in calls:
        out[name] = out.get(name, 0) + 1
    return out


def publish_call_check(ops, ref, sess, h_prev, label):
    """One publish of the trainer's latest step again (verified equal to the
    record on disk: nothing written), every kernel call recorded and held
    bit for bit against its plain version on the same inputs
    (:func:`check_calls_plain`); the calls must equal
    :func:`stream_launches`' publish. ``h_prev`` is the trainer's h before
    its latest step. Returns {kernel: shapes}."""
    from repro_torch.launch import build as build_lib
    pub, _ = stream_launches(build_lib.ef_config(sess.spec), sess.params)
    with recorded_calls(ops, STREAM_KERNELS) as calls:
        written = sess.publisher.publish(
            sess.step, sess.ef_state["server"], h_prev, sess.ef_state["h"])
    if written:
        fail(f"{label}: the republish of step {sess.step} wrote {written} "
             "records; the log already holds them")
    if _call_counts(calls) != {k: v for k, v in pub.items() if v}:
        fail(f"{label}: one publish called {_call_counts(calls)}, expected "
             f"{pub}")
    return check_calls_plain(ref, f"{label} publish", calls)


def apply_call_check(ops, ref, rep, label):
    """One replica apply (the replica's next record), every kernel call
    recorded and held against its plain version; the calls must equal
    :func:`stream_launches`' apply. Returns {kernel: shapes}."""
    from repro_torch.launch import build as build_lib
    _, app = stream_launches(build_lib.ef_config(rep.spec), rep.params)
    step = rep.step
    with recorded_calls(ops, STREAM_KERNELS) as calls:
        rep.sync(upto=step + 1)
    if rep.step != step + 1:
        fail(f"{label}: the replica went from step {step} to {rep.step}, "
             "expected one record")
    if _call_counts(calls) != {k: v for k, v in app.items() if v}:
        fail(f"{label}: one apply called {_call_counts(calls)}, expected "
             f"{app}")
    return check_calls_plain(ref, f"{label} apply", calls)


def _equal_trees(a, b) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def _timed(obj, name, sink, device="cuda"):
    """Wrap ``obj.name`` to append its ms (from and to a synchronize of
    ``device``) to ``sink``."""
    real = getattr(obj, name)

    def timed(*a, **kw):
        _sync(device)
        t0 = time.time()
        out = real(*a, **kw)
        _sync(device)
        sink.append((time.time() - t0) * 1e3)
        return out
    setattr(obj, name, timed)


def fleet_phase(Session, spec_lib, ops, model_lib):
    """Phase F: the wire stream and the serving fleet on the card; see the
    module doc. Returns the launches of its runs (the comparisons with
    the plain versions not counted)."""
    base = tempfile.gettempdir()
    free = shutil.disk_usage(base).free
    print(f"F: stream directory under {base}: {free} bytes free", flush=True)
    if free < CKPT_FREE_BYTES:
        fail(f"{base} has {free} bytes free; the stream's bootstrap needs "
             f"{CKPT_FREE_BYTES:.0f}")
    stream_dir = tempfile.mkdtemp(prefix="chip_smoke_wire_", dir=base)
    try:
        return _fleet_phase(Session, spec_lib, ops, model_lib, stream_dir)
    finally:
        shutil.rmtree(stream_dir, ignore_errors=True)


def _fleet_phase(Session, spec_lib, ops, model_lib, stream_dir):
    from repro_torch.core import stream as stream_lib
    from repro_torch.kernels import ref
    from repro_torch.launch import build as build_lib
    from repro_torch.launch import fleet as fleet_lib
    from repro_torch.launch import replica_worker as worker_lib
    t_phase = time.time()
    total = {}
    spec = load_spec(spec_lib, clients=F_CLIENTS, **F_PATH)
    sess = Session(spec, device="cuda")
    n_params = sum(p.numel() for p in sess.params.values())
    efc = build_lib.ef_config(spec)
    per_step = expected_launches(efc, sess.params)
    pub, app = stream_launches(efc, sess.params)
    label = f"F {spec.carrier}/{spec.downlink_carrier}"
    print(f"{label}: {len(sess.params)} leaves, {n_params} parameters; "
          f"launches a step {per_step}, a publish {pub}, a replica apply "
          f"{app}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # 1. publish: the bootstrap at step 0, then every step's records
    t0 = time.time()
    log = sess.publish_to(stream_dir)
    bootstrap_s = time.time() - t0
    boot_bytes = os.path.getsize(log.bootstrap_path(0))
    print(f"{label}: bootstrap at step 0: {boot_bytes} bytes, saved in "
          f"{bootstrap_s:.2f} s", flush=True)
    pub_ms, append_ms, apply_ms = [], [], []
    _timed(sess.publisher, "publish", pub_ms)
    _timed(sess.publisher.log, "append", append_ms)
    words = stream_lib.legs_wire_words(sess.publisher.legs, sess.params)

    # 2. join: two in-process replicas at lags 0 and 1
    t0 = time.time()
    fleet = fleet_lib.Fleet(stream_dir, n_replicas=2, lags=(0, 1),
                            decode_budget=F_BUDGET, max_batch=F_BATCH,
                            prompt_len=F_SERVE["prompt_len"], device="cuda")
    torch.cuda.synchronize()
    join_s = time.time() - t0
    r0, r1 = fleet.replicas
    print(f"{label}: 2 replicas joined at steps {r0.step}, {r1.step} in "
          f"{join_s:.2f} s (each restores params, opt_state and h alone)",
          flush=True)
    for rep in fleet.replicas:
        _timed(rep.sub, "sync", apply_ms)
    prev = None
    for _ in range(F_STEPS):
        ops.reset_launches()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        t0 = time.time()
        m = sess.step_once()
        torch.cuda.synchronize()
        step_ms = (time.time() - t0) * 1e3
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - \
            retries
        launches = dict(ops.launches)
        check_launches(launches, _merged(per_step, pub), 1,
                       f"{label} published step")
        _add(total, launches)
        if not math.isfinite(float(m["loss"])):
            fail(f"{label}: non-finite loss at step {sess.step - 1}")
        rec = log.read_step(sess.step)
        nbytes = sum(stream_lib.record_nbytes(r) for r in rec)
        disk = sum(os.path.getsize(log.record_path(sess.step, r.group_index))
                   for r in rec)
        if nbytes != 4 * words:
            fail(f"{label}: a record holds {nbytes} bytes, the legs' wire "
                 f"words say {4 * words:.0f}")
        ops.reset_launches()
        r0.sync()
        r1.sync()
        launches = dict(ops.launches)
        check_launches(launches, app, 1 + (sess.step > 1),
                       f"{label} replica apply")
        _add(total, launches)
        if r0.step != sess.step or not _equal_trees(r0.params, sess.params):
            fail(f"{label}: replica r0 at step {r0.step} differs from the "
                 f"trainer at step {sess.step}")
        if prev is not None and (r1.step != sess.step - 1
                                 or not _equal_trees(r1.params, prev)):
            fail(f"{label}: replica r1 at step {r1.step} differs from the "
                 f"trainer at step {sess.step - 1}")
        print(f"{label}: step {sess.step} step_ms {step_ms:.1f} (publish "
              f"{pub_ms[-1]:.1f} ms, of it the npz write {append_ms[-1]:.1f}"
              f"; alloc_retries {retries}); record {nbytes} bytes ({disk} on disk) against a dense "
              f"f32 push of {4 * n_params} ({4 * n_params / nbytes:.2f}x "
              f"fewer); replica apply_ms {[round(x, 2) for x in apply_ms[-2:]]}"
              f"; replicas at {r0.step}, {r1.step}, all "
              f"{len(sess.params)} leaves equal", flush=True)
        prev = {k: v.clone() for k, v in sess.params.items()}

    # 3. serve: 16 requests of 1024 tokens, 8 new, batches of 8
    served = []
    for rep in fleet.replicas:
        def serve_batch(batch, prompt_len, decode_steps,
                        sync_during_decode=False, _rep=rep,
                        _real=rep.serve_batch):
            ops.reset_launches()
            out = _real(batch, prompt_len, decode_steps,
                        sync_during_decode=sync_during_decode)
            served.append((_rep, batch, out, dict(ops.launches)))
            return out
        rep.serve_batch = serve_batch
    reqs = fleet_lib.synthetic_requests(
        F_SERVE["n"], prompt_len=F_SERVE["prompt_len"],
        max_new_tokens=F_SERVE["max_new_tokens"],
        vocab_size=sess.cfg.vocab_size)
    out = fleet.run(reqs, sync_every=1)
    if len(out["requests"]) != F_SERVE["n"] or out["short_requests"]:
        fail(f"{label}: {len(out['requests'])} of {F_SERVE['n']} requests "
             f"completed, {out['short_requests']} short")
    for rep, batch, res, launches in served:
        check_serve_launches(ops, launches, f"{label} {rep.name} serve",
                             model_lib.flash_layers(sess.cfg))
        _add(total, launches)
        tokens = torch.from_numpy(np.stack([r.tokens for r in batch]))
        first_token_check(model_lib, sess.cfg, rep.params, tokens.cuda(),
                          res, f"{label} {rep.name} batch")
    print(f"{label}: served {len(out['requests'])} requests in "
          f"{out['batches']} batches ({[len(s[1]) for s in served]} a batch)"
          f": qps {out['qps']:.3f} p50_ms {out['p50_ms']:.1f} p99_ms "
          f"{out['p99_ms']:.1f} staleness mean {out['staleness_mean']} max "
          f"{out['staleness_max']}; K7 {[s[3]['flash_attention'] for s in served]}"
          f" launches a prefill; first tokens the argmax under each "
          f"replica's params", flush=True)

    # 4. the trainer steps while r0 decodes (continuous sync)
    state = {}
    real_sync = r0.sync

    def sync_after_a_step(upto=None):
        if "h_prev" not in state:
            state["h_prev"] = sess.ef_state["h"]
            sess.step_once()
        return real_sync(upto)
    r0.sync = sync_after_a_step
    snap = prev
    served.clear()
    res = r0.serve_batch(reqs[:F_BATCH], F_SERVE["prompt_len"],
                         F_SERVE["max_new_tokens"], sync_during_decode=True)
    r0.sync = real_sync
    launches = served[-1][3]
    want = _merged(per_step, pub, app,
                   {"flash_attention": model_lib.flash_layers(sess.cfg)})
    check_launches(launches, want, 1, f"{label} mid-decode serve")
    _add(total, launches)
    if res["mid_applied"] < 1 or r0.step != sess.step or \
            not _equal_trees(r0.params, sess.params):
        fail(f"{label}: mid-decode sync applied {res['mid_applied']}, "
             f"replica at {r0.step}, trainer at {sess.step}")
    print(f"{label}: the trainer took step {sess.step} while r0 decoded: "
          f"mid_applied {res['mid_applied']}, r0 at step {r0.step}, params "
          f"equal; decode_ms_per_token "
          f"{res['decode_s'] * 1e3 / F_SERVE['max_new_tokens']:.2f}",
          flush=True)

    # 6. one publish and one replica apply, every kernel call against its
    # plain version (r1 applies step head - 1)
    shapes = {"publish": publish_call_check(ops, ref, sess, state["h_prev"],
                                            label),
              "apply": apply_call_check(ops, ref, r1, label)}
    if not _equal_trees(r1.params, snap):
        fail(f"{label}: r1 at step {r1.step} differs from the trainer")
    print(f"{label}: one publish's and one apply's kernel calls "
          f"bit-identical to the plain versions: {shapes}", flush=True)
    digests = {sess.step: worker_lib.params_digest(sess.params),
               sess.step - 1: worker_lib.params_digest(snap)}
    peak = torch.cuda.max_memory_allocated()
    del fleet, r0, r1, served, prev, snap, state, real_sync
    gc.collect()
    torch.cuda.empty_cache()

    # 5. two worker processes on the card, one killed and restarted
    t0 = time.time()
    with fleet_lib.ProcessFleet(stream_dir, n_workers=2, lags=(0, 1),
                                decode_budget=F_BUDGET,
                                max_batch=F_PROC["max_batch"],
                                prompt_len=F_SERVE["prompt_len"],
                                device="cuda") as pf:
        start_s = time.time() - t0
        pf.sync()
        got = pf.digests()
        steps = [w.call({"cmd": "sync"})["step"] for w in pf.workers]
        if steps != [sess.step, sess.step - 1] or \
                got != [digests[s] for s in steps]:
            fail(f"{label}: worker digests at steps {steps} differ from the "
                 "trainer's")
        preqs = fleet_lib.synthetic_requests(
            F_PROC["n"], rate=F_PROC["rate"],
            prompt_len=F_SERVE["prompt_len"],
            max_new_tokens=F_SERVE["max_new_tokens"],
            vocab_size=sess.cfg.vocab_size, seed=1)
        killer = threading.Timer(F_PROC["kill_after_s"],
                                 pf.workers[1].kill)
        killer.start()
        pout = pf.run(preqs)
        killer.cancel()
        pf.sync()
        after = pf.digests()
        if sorted(r.rid for r in pout["requests"]) != list(range(
                F_PROC["n"])) or pout["restarts"] < 1 or \
                pout["short_requests"] or after != got:
            fail(f"{label}: worker processes: "
                 f"{len(pout['requests'])} of {F_PROC['n']} requests, "
                 f"restarts {pout['restarts']}, digests after "
                 f"{'equal' if after == got else 'differ'}")
        print(f"{label}: 2 worker processes on the card (lags 0, 1) up in "
              f"{start_s:.1f} s at steps {steps}, digests equal the "
              f"trainer's; served {len(pout['requests'])} requests with w1 "
              f"killed by SIGKILL after {F_PROC['kill_after_s']} s: restarts "
              f"{pout['restarts']}, p50_ms {pout['p50_ms']:.1f} p99_ms "
              f"{pout['p99_ms']:.1f}, mid_applied {pout['mid_applied']}; "
              f"digests after the restart equal", flush=True)
    del sess
    gc.collect()
    torch.cuda.empty_cache()

    # 7. smoke size over tcp:// (the sparse payload down: K6 integrates)
    _add(total, fleet_tcp_smoke(Session, spec_lib, ops, stream_lib,
                                fleet_lib))
    print(f"{label}: phase F {time.time() - t_phase:.1f} s; peak "
          f"max_memory_allocated {peak} (trainer, 2 replicas, serving); "
          f"bootstrap_s {bootstrap_s:.2f} join_s {join_s:.2f} publish_ms "
          f"{[round(x, 1) for x in pub_ms]} (npz write "
          f"{[round(x, 1) for x in append_ms]}) apply_ms "
          f"{[round(x, 2) for x in apply_ms]}", flush=True)
    return total


def fleet_tcp_smoke(Session, spec_lib, ops, stream_lib, fleet_lib):
    """Phase F, 7: a smoke-size stream on the card (``F_TCP``), served over
    a TailServer on loopback: a replica over ``tcp://`` and one on the
    directory land on the trainer's params bit for bit after every record;
    each apply launches :func:`stream_launches`. Returns the launches."""
    from repro_torch.launch import build as build_lib
    from repro_torch.launch import transport as transport_lib
    spec = load_spec(spec_lib, **F_TCP)
    d = tempfile.mkdtemp(prefix="chip_smoke_tcp_")
    srv = None
    total = {}
    try:
        sess = Session(spec, device="cuda")
        sess.publish_to(os.path.join(d, "wire"))
        srv = transport_lib.TailServer(os.path.join(d, "wire")).start()
        tail = transport_lib.make_tail(srv.address,
                                       cache_dir=os.path.join(d, "mirror"))
        reps = [fleet_lib.ServeReplica(tail, name="tcp", device="cuda"),
                fleet_lib.ServeReplica(os.path.join(d, "wire"), name="dir",
                                       device="cuda")]
        efc = build_lib.ef_config(spec)
        pub, app = stream_launches(efc, sess.params)
        per_step = _merged(expected_launches(efc, sess.params), pub)
        for _ in range(3):
            ops.reset_launches()
            sess.step_once()
            check_launches(dict(ops.launches), per_step, 1,
                           "F tcp smoke published step")
            _add(total, dict(ops.launches))
            for rep in reps:
                ops.reset_launches()
                rep.sync()
                check_launches(dict(ops.launches), app, 1,
                               f"F tcp smoke {rep.name} apply")
                _add(total, dict(ops.launches))
                if rep.step != sess.step or not _equal_trees(rep.params,
                                                             sess.params):
                    fail(f"F tcp smoke: replica {rep.name} at step "
                         f"{rep.step} differs from the trainer")
        print(f"F tcp smoke ({spec.carrier}/{spec.downlink_carrier}, "
              f"{srv.address}): the tcp:// and directory replicas equal the "
              f"trainer bit for bit after each of 3 records; an apply "
              f"launches {app}", flush=True)
        tail.close()
    finally:
        if srv is not None:
            srv.stop()
        shutil.rmtree(d, ignore_errors=True)
    return total

# ---------------------------------------------------------------------------
# phases MD1 and MD4: the multi-device runtime (core/distributed.py::
# ef_round_sharded over torch.distributed, launch/mesh.py, multiproc.py)
# ---------------------------------------------------------------------------

MD_PATHS = [  # MD1: (label, fused_quickstart.json overrides)
    ("fused_quant8/fused_quant4", dict(carrier="fused_quant8",
                                       downlink_carrier="fused_quant4")),
    ("fused_quant4/fused_quant4", dict(carrier="fused_quant4",
                                       downlink_carrier="fused_quant4")),
    ("quant8/quant4", dict(carrier="quant8", downlink_carrier="quant4")),
    ("quant8/quant4 overlap", dict(carrier="quant8",
                                   downlink_carrier="quant4", overlap=True)),
]
MD_RANKS = 4
# MD4's runs, planted faults and their single-process runs: full width, 2
# of smollm's 32 layers (the script's time limit; 16 until the script
# passed its limit on a slow host)
MD_CUT = {"num_layers": 2}
# 2 steps a run (the script's time limit): every planted fault reads
# above MD_TOL by its second step
MD_STEPS = 2
# MD4 against the single-process run, relative, on each step's loss,
# g_norm and ‖params − initial params‖: each client's gradients come from a pass of its own rows instead
# of one vmap pass of all four (other bf16 products), and the means sum in
# the all-reduce's order. The sound runs read at most 1.12e-4 on the H100;
# the planted faults of MD4_FAULTS must read above the limit.
MD_TOL = 1e-3
MD4_RUNS = [  # (label, spec, overrides): one client a rank, full width
    ("MD4-pod", "fused_quant8_overlap", {}),
    ("MD4-quant8-ring", "fused_quant8_overlap",
     dict(carrier="quant8", overlap=True)),
    ("MD4-quant8-blocking", "fused_quant8_overlap",
     dict(carrier="quant8", overlap=False)),
    # the hops of hierarchy_quant4_cross.json on (pod 2, data 2); the
    # multi_pod geometry's 32 production clients set the batch's multiple
    ("MD4-multi_pod", "hierarchy_quant4_cross",
     dict(mesh="multi_pod", smoke=False, global_batch=32)),
    # one client a pod on (pod 2, data 2): each pod's 8 rows split over its
    # 2 data ranks, the shares' gradients all-reduced over the pair, the
    # round over 'pod'; held against the single-process run of MD_PODS
    # clients
    ("MD4-pod-clients", "fused_quant8_overlap",
     dict(mesh="multi_pod", client_granularity="pod")),
]
MD_PODS = 2
# MD4's planted faults, runs that its check against the single-process run
# must fail (a reading above MD_TOL on every rank): (label, spec, overrides,
# fault). "local": the round's collectives keep this rank's client alone
# (an all-reduce returns n times its operand, a gather n copies of it, a
# ring hop its own chunk); "frozen": the parameters are put back after
# every step, as if no round reached them; "pod-unreduced": a pod client's
# gradient is each data rank's own share (the data group's sum skipped).
MD4_FAULTS = [
    ("MD4-fault-local-fused", "fused_quant8_overlap", {}, "local"),
    ("MD4-fault-local-quant8", "fused_quant8_overlap",
     dict(carrier="quant8", overlap=False), "local"),
    ("MD4-fault-frozen", "fused_quant8_overlap",
     dict(carrier="quant8", overlap=False), "frozen"),
    ("MD4-fault-pod-unreduced", "fused_quant8_overlap",
     dict(mesh="multi_pod", client_granularity="pod"), "pod-unreduced"),
]
# the faults that read above MD_TOL from their first step run 1 step (the
# script's time limit; "local" reads 1.1e-4 at its first step): "frozen"
# (the parameters moved 0, a reading of 1.0 on an H100) and
# "pod-unreduced" (the first estimate from each rank's share, about half
# its pod's gradient: 0.282)
MD4_FAULT_STEPS = {"frozen": 1, "pod-unreduced": 1}
# MD4-publish: (label, spec, overrides, steps, depth cut): the pod run on
# fused_quant8 up and fused_quant4 down, publishing from its first rank
# (the bootstrap, then each step's record); a single-device replica
# (launch/fleet.py) joins from the stream after the ranks end, applies the
# record and must hold the trainer's params bit for bit. Full width, cut
# as MD4's runs (MD_CUT: the bootstrap of 4 clients' f32 state, about
# 2.7 GB at 2 layers; the script's time limit)
MD4_PUBLISH = ("MD4-publish", "fused_quant8_overlap",
               dict(downlink_carrier="fused_quant4"), 1, MD_CUT)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _equal_states(a, b) -> bool:
    from repro_torch.core.ef import flatten
    fa, fb = flatten(a), flatten(b)
    return sorted(fa) == sorted(fb) and all(torch.equal(fa[k], fb[k])
                                            for k in fa)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def md1_phase(ops, spec_lib, device="cuda", backend="nccl", smoke=False):
    """An NCCL world of one: ef_round_sharded, called directly on
    full-width smollm-360m leaves (random gradients and first gradients),
    must give bit for bit what the single-device round gives one client,
    on each MD_PATHS path; its collectives are real NCCL calls on the
    world's one rank. Returns the kernels' launches of the sharded rounds.
    (``device``/``backend``/``smoke``: the CPU tests' gloo run at smoke
    size.)"""
    from repro_torch.core import comm
    from repro_torch.core import distributed as dist_lib
    from repro_torch.core import rng as rng_lib
    from repro_torch.launch import build as build_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import multiproc
    from repro_torch.models import model as model_lib
    multiproc.distributed_init(f"localhost:{_free_port()}", 1, 0,
                               backend=backend)
    total = {}
    try:
        import torch.distributed as tdist
        mesh = mesh_lib.make_production_mesh()
        print(f"MD1: backend {tdist.get_backend()} mesh {mesh.shape}",
              flush=True)
        from repro_torch.configs import base as cb
        cfg = (cb.get_smoke if smoke else cb.get)("smollm-360m")
        shapes = {k: v.shape for k, v in model_lib.init_params(
            cfg, None, "meta").items()}
        gen = torch.Generator(device=device).manual_seed(0)
        params = {k: torch.zeros(s, device=device) for k, s in shapes.items()}
        for label, overrides in MD_PATHS:
            spec = load_spec(spec_lib, **overrides)
            efc = build_lib.ef_config(spec, client_axes=mesh.client_axes())
            g0 = {k: torch.randn((1, *s), generator=gen, device=device)
                  for k, s in shapes.items()}
            grads = {k: torch.randn((1, *s), generator=gen, device=device)
                     for k, s in shapes.items()}
            st_v = dist_lib.init_ef_state(
                efc, params, 1, init_grads={k: g.clone()
                                            for k, g in g0.items()})
            st_s = dist_lib.init_ef_state_sharded(efc, params, mesh,
                                                  init_grads=g0)
            if not _equal_states(st_s, st_v):
                fail(f"MD1 {label}: the sharded initial state is not the "
                     "single-device one bit for bit")
            ops.reset_launches()
            comm.reset_stats()
            _sync(device)
            t0 = time.time()
            est_s, st_s = dist_lib.ef_round_sharded(
                efc, grads, st_s, mesh, eta=None, step=0,
                rng=rng_lib.round_generator(0, 0, device),
                overlap=spec.overlap)
            _sync(device)
            ms = (time.time() - t0) * 1e3
            launches = {k: v for k, v in ops.launches.items() if v}
            stats = dict(comm.STATS)
            est_v, st_v = dist_lib.ef_round(
                efc, grads, st_v, step=0,
                rng=rng_lib.round_generator(0, 0, device))
            if not (_equal_states(est_s, est_v)
                    and _equal_states(st_s, st_v)):
                fail(f"MD1 {label}: the sharded round is not the "
                     "single-device round of one client bit for bit")
            want = expected_launches(efc, params, gathered=1)
            check_launches(launches, want, 1, f"MD1 {label}")
            print(f"MD1 {label}: bit for bit the single-device round of "
                  f"one client; round_ms {ms:.1f} launches {launches} "
                  f"collectives {stats['collectives']} wire_bytes "
                  f"{stats['wire_bytes']} staged_bytes "
                  f"{stats['staged_bytes']}", flush=True)
            total = _merged(total, launches)
            del g0, grads, st_v, st_s, est_s, est_v
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        # a checkpoint's gather of the client leaves, on this backend
        leaf = torch.randn((3, 1000), generator=gen, device=device).to(
            torch.bfloat16)
        got = comm.gather_to_first(mesh.axes(mesh.client_axes()), leaf)
        if not (got.shape == (1, 3, 1000) and got.device.type == "cpu"
                and torch.equal(got[0], leaf.cpu())):
            fail(f"MD1: gather_to_first gave {tuple(got.shape)} on "
                 f"{got.device}, not the leaf on the CPU bit for bit")
        print(f"MD1: gather_to_first on {tdist.get_backend()} bit for bit",
              flush=True)
    finally:
        multiproc.shutdown()
    return total


MD_ROUTE_WORDS = 47_185_920    # the embedding leaf: the largest all-reduce
MD_GATHER_BYTES = 18_373_732   # one client's quant8 wire a step (MD1)


def gloo_cuda_probe(n: int):
    """Which gloo collectives take CUDA tensors as they are (core/comm.py's
    GLOO_CUDA_OPS), and an all-reduce of the embedding leaf's size and an
    all-gather of a client's quant8 wire both ways, gloo's own CUDA route
    and staging through pinned host memory (ms, median of 3).
    send/recv are not called with a CUDA tensor: gloo's send hands the
    tensor's raw pointer to its transport with no device check."""
    import torch.distributed as tdist
    from repro_torch.core import comm
    x = torch.ones(4, device="cuda")
    out = {}
    for name, fn in (
            ("all_reduce", lambda: tdist.all_reduce(x.clone())),
            ("broadcast", lambda: tdist.broadcast(x.clone(), 0)),
            ("all_gather", lambda: tdist.all_gather(
                [torch.empty_like(x) for _ in range(n)], x))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "takes cuda tensors"
        except Exception as e:                     # noqa: BLE001 - a probe
            out[name] = f"refuses them ({type(e).__name__})"
        tdist.barrier()
    big = torch.ones(MD_ROUTE_WORDS, device="cuda")
    wire = torch.ones(MD_GATHER_BYTES, dtype=torch.uint8, device="cuda")

    def reduce_direct():
        tdist.all_reduce(big)

    def reduce_staged():
        host = comm._host(big)
        tdist.all_reduce(host)
        big.copy_(host)

    def gather_direct():
        tdist.all_gather([torch.empty_like(wire) for _ in range(n)], wire)

    def gather_staged():
        host = comm._host(wire)
        outs = [torch.empty_like(host) for _ in range(n)]
        tdist.all_gather(outs, host)
        torch.stack(outs).to("cuda")
    for name, fn in (("all_reduce_direct_ms", reduce_direct),
                     ("all_reduce_staged_ms", reduce_staged),
                     ("all_gather_direct_ms", gather_direct),
                     ("all_gather_staged_ms", gather_staged)):
        times = []
        for _ in range(3):
            tdist.barrier()
            torch.cuda.synchronize()
            t = time.time()
            fn()
            torch.cuda.synchronize()
            times.append((time.time() - t) * 1e3)
        out[name] = sorted(times)[1]
    del big, wire
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _unreduced_shares():
    """MD4's planted fault "pod-unreduced": while it is on, a pod client's
    gradient is this data rank's own share (core/distributed.py's
    ``sum_shares`` the identity), as if the data group never summed."""
    from repro_torch.core import distributed as dist_lib
    saved = dist_lib.sum_shares
    dist_lib.sum_shares = lambda axes, grads: grads
    try:
        yield
    finally:
        dist_lib.sum_shares = saved


@contextlib.contextmanager
def _local_collectives():
    """MD4's planted fault "local": while it is on, core/comm.py's
    collectives keep this rank's operand alone (an all-reduce sums n copies
    of it, a gather stacks n copies, a ring hop hands back its own chunk),
    as a round that never hears from the other clients."""
    from repro_torch.core import comm
    saved = comm.all_reduce_sum, comm.all_gather, comm._ring_step
    comm.all_reduce_sum = lambda axes, x: x * axes.size
    comm.all_gather = lambda axes, x: x[None].expand(
        axes.size, *x.shape).clone()
    comm._ring_step = lambda axes, x: x.clone()
    try:
        yield
    finally:
        comm.all_reduce_sum, comm.all_gather, comm._ring_step = saved


@contextlib.contextmanager
def arch_cut(cut):
    """Within: every Session's config cut by ``cut`` (fields of its arch
    config) from its construction, so that a replica built from a stream's
    spec runs the trainer's cut too."""
    from repro_torch.launch import session as session_lib
    saved = session_lib.Session.__dict__["_arch_config"]
    if cut:
        session_lib.Session._arch_config = staticmethod(
            lambda spec: dataclasses.replace(saved.__func__(spec), **cut))
    try:
        yield
    finally:
        session_lib.Session._arch_config = saved


def md4_run(ops, ref, label, spec_name, overrides, device="cuda",
            plain=True, fault=None, steps=MD_STEPS, publish=None):
    """One MD4 run on this rank: a Session of one client a rank (or, under
    client granularity 'pod', a pod's client split over its data ranks),
    ``steps`` steps; per step the loss, g_norm, the replicated state's and
    the client state's digests, the step and EF-round times, the
    collectives' share and bytes, the data group's all-reduce of the
    gradient shares (ms, bytes); the launches against
    ``expected_launches``; then (``plain``) each distinct K3-K6 call of
    the steps held bit for bit against its plain version. ``fault``: one
    of MD4_FAULTS's planted faults, on for the whole run ("pod-unreduced"
    put on by md4_rank around it). ``publish``: a stream directory the
    Session publishes to (MD4-publish): the bootstrap's seconds, each
    publish's ms (every rank's part: the first rank writes), the records'
    bytes; the first rank's launches add the publish's (its re-encode and
    verify) and it leaves its params in ``trainer.pt`` beside the stream."""
    from repro_torch.core import comm
    from repro_torch.core import distributed as dist_lib
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import spec as spec_lib
    from repro_torch.launch.session import Session
    spec = load_spec(spec_lib, spec_name, **overrides)
    cuda = device == "cuda"
    sess = Session(spec, device=device)
    t0 = time.time()
    n_params = sum(p.numel() for p in sess.params.values())
    _sync(device)
    init_s = time.time() - t0
    efc = sess._tr["efc"]
    # the clients whose wires this rank's aggregate gathers: its pod's
    # under a non-trivial cross hop, else all
    intra = sess.client_group.names
    if efc.effective_hops is not None and not _trivial(efc):
        intra = tuple(a for a in intra if a != "pod")
    gathered = sess.mesh.axes(intra).size
    per_step = expected_launches(efc, sess.params, gathered=gathered)
    rec = {"mesh": dict(sess.mesh.shape), "n": sess.n_clients,
           "coord": sess.mesh.coordinate(), "params": n_params,
           "init_s": init_s, "steps": []}
    publish_ms = []
    if publish is not None:
        t0 = time.time()
        sess.publish_to(publish)
        rec["bootstrap_s"] = time.time() - t0
        _timed(sess, "_publish", publish_ms, device)
        if sess.mesh.rank == 0:
            pub, _ = stream_launches(efc, sess.params)
            per_step = _merged(per_step, pub)
    orig = dist_lib.ef_round_sharded
    round_ms, round_coll_ms = [], []

    def timed(*a, **kw):
        _sync(device)
        t, c = time.time(), comm.STATS["seconds"]
        if fault == "local":
            with _local_collectives():
                out = orig(*a, **kw)
        else:
            out = orig(*a, **kw)
        _sync(device)
        round_ms.append((time.time() - t) * 1e3)
        round_coll_ms.append((comm.STATS["seconds"] - c) * 1e3)
        return out
    dist_lib.ef_round_sharded = timed
    comm.TIMED = True
    p0 = _host_copy(sess.params)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        with recorded_calls(ops, ROW_KERNELS, shapes_only=True) as calls:
            for _ in range(steps):
                comm.reset_stats()
                _sync(device)
                t = time.time()
                m = sess.step_once()
                loss, g_norm = float(m["loss"]), float(m["g_norm"])
                _sync(device)
                step_ms = (time.time() - t) * 1e3
                if fault == "frozen":
                    for k, v in sess.params.items():
                        v.copy_(p0[k])
                rec["steps"].append(dict(
                    loss=loss, g_norm=g_norm,
                    moved=_distance(sess.params, p0), step_ms=step_ms,
                    round_ms=round_ms[-1],
                    collective_ms=round_coll_ms[-1],
                    step_collective_ms=comm.STATS["seconds"] * 1e3,
                    collectives=comm.STATS["collectives"],
                    wire_bytes=comm.STATS["wire_bytes"],
                    staged_bytes=comm.STATS["staged_bytes"],
                    data_ms=comm.STATS["data_seconds"] * 1e3,
                    data_collectives=comm.STATS["data_collectives"],
                    data_bytes=comm.STATS["data_wire_bytes"],
                    digest=sh.replicated_digest(sess.params,
                                                sess.ef_state),
                    client_digest=sh.tree_digest(
                        sess.ef_state["clients"])))
    finally:
        dist_lib.ef_round_sharded = orig
        comm.TIMED = False
    rec["launches"] = {k: v for k, v in ops.launches.items() if v}
    rec["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
    rec["expected"] = {k: v * steps for k, v in per_step.items() if v}
    if cuda:
        check_launches(rec["launches"], per_step, steps, label)
    if publish is not None:
        rec["publish_ms"] = publish_ms
        if sess.mesh.rank == 0:
            recs = os.path.join(publish, "records")
            rec["record_bytes"] = sum(
                os.path.getsize(os.path.join(recs, f))
                for f in os.listdir(recs))
            torch.save({k: v.detach().cpu() for k, v in sess.params.items()},
                       os.path.join(os.path.dirname(publish), "trainer.pt"))
    del sess, m, p0
    gc.collect()
    if _call_counts(calls) != rec["expected"]:
        fail(f"{label}: recorded calls {_call_counts(calls)}, expected "
             f"{per_step} a step")
    if cuda and plain:
        torch.cuda.empty_cache()
        rec["plain"] = check_shapes_plain(ops, ref, label, calls)
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def _trivial(efc) -> bool:
    from repro_torch.core import hierarchy as hier_lib
    return hier_lib.cross_is_trivial(efc.effective_hops, efc.schedule)


def md4_rank(rank, runs, device="cuda", faults=(), publish=None,
             stream=None, cut=None):
    """One of MD4's rank processes (``multiproc.spawn``, gloo, the card
    shared): the kernels' library from the parent's build (no nvcc here),
    the gloo probe, then each run, MD4-publish (``publish``, into
    ``stream``), then each planted fault's run, every Session's config
    cut by ``cut``. Every rank's calls have the same shapes, so rank 0
    holds them against the plain versions."""
    with arch_cut(cut):
        return _md4_rank(rank, runs, device, faults, publish, stream)


def _md4_rank(rank, runs, device, faults, publish, stream):
    import torch.distributed as tdist
    from repro_torch.kernels import build, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"backend": tdist.get_backend(), "probe": {}, "runs": {},
           "faults": {}}
    if device == "cuda":
        build.build()
        out["probe"] = gloo_cuda_probe(tdist.get_world_size())
    for label, spec_name, overrides in runs:
        out["runs"][label] = md4_run(ops, ref, label, spec_name, overrides,
                                     device, plain=rank == 0)
    if publish is not None:
        label, spec_name, overrides, steps, cut = publish
        with arch_cut(cut):
            out["publish"] = md4_run(ops, ref, label, spec_name, overrides,
                                     device, plain=rank == 0, steps=steps,
                                     publish=stream)
    for label, spec_name, overrides, fault in faults:
        with _unreduced_shares() if fault == "pod-unreduced" \
                else contextlib.nullcontext():
            out["faults"][label] = md4_run(
                ops, ref, label, spec_name, overrides, device, plain=False,
                fault=fault, steps=MD4_FAULT_STEPS.get(fault, MD_STEPS))
    return out


def _single_key(name, overrides):
    """The single-process run a run compares against (``overlap`` does
    not change it)."""
    return (name, json.dumps({k: v for k, v in overrides.items()
                              if k != "overlap"}, sort_keys=True))


def _pod_clients(overrides) -> bool:
    return overrides.get("client_granularity") == "pod"


def _relative_diffs(steps, want):
    """Each step's |a − b| / |b| for the loss, g_norm and the distance the
    parameters moved, against the single-process run's ``want``."""
    return [abs(a[i] - b[i]) / abs(b[i]) for a, b in zip(steps, want)
            for i in (0, 1, 2)]


def _host_copy(params):
    """The parameters on the host (pinned when they are on the card), for
    :func:`_distance`: no card memory is held for them."""
    return {k: v.detach().cpu().pin_memory() if v.is_cuda
            else v.detach().clone() for k, v in params.items()}


def _distance(params, p0) -> float:
    """‖params − p0‖ summed in f64, leaf by leaf (``p0`` from
    :func:`_host_copy`): how far the steps have moved the parameters."""
    total = 0.0
    for k, v in params.items():
        d = v.detach() - p0[k].to(v.device, non_blocking=True)
        total += float(torch.linalg.vector_norm(d, dtype=torch.float64)) ** 2
    return math.sqrt(total)


def md4_single(Session, spec_lib, spec_name, overrides, device="cuda"):
    """The single-process run MD4 compares against: the same spec on the
    smoke mesh with MD_RANKS emulated clients (MD_PODS under client
    granularity 'pod': one a pod) (the vmap round); a step's (loss,
    g_norm, ‖params − initial params‖)."""
    over = {k: v for k, v in overrides.items()
            if k not in ("overlap", "client_granularity")}
    clients = MD_PODS if _pod_clients(overrides) else MD_RANKS
    spec = load_spec(spec_lib, spec_name,
                     **dict(over, mesh="smoke", clients=clients))
    sess = Session(spec, device=device)
    p0 = _host_copy(sess.params)
    out = []
    for _ in range(MD_STEPS):
        m = sess.step_once()
        out.append((float(m["loss"]), float(m["g_norm"]),
                    _distance(sess.params, p0)))
    del sess, m, p0
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def md4_phase(Session, spec_lib, ops, runs=MD4_RUNS, device="cuda",
              faults=MD4_FAULTS, publish=MD4_PUBLISH, cut=MD_CUT):
    """MD4: MD_RANKS rank processes on the one card (gloo on the card's
    tensors, the ring's send/recv staged through pinned host memory), each
    one client, the runs of MD4_RUNS at full width: every rank's loss,
    g_norm and replicated-state digest equal after every step, the ring's
    run bit for bit the blocking gather's, each run within MD_TOL of the
    single-process vmap run; then each of ``faults`` (MD4_FAULTS) must read
    above MD_TOL on every rank, or the check could not tell it from a sound
    run. MD4-publish (``publish``) publishes from its first rank, and a
    single-device replica joins from the stream here and must hold the
    trainer's params bit for bit after applying its records (each K4 call
    of the apply held to its plain version on the card). Returns the
    launches of ``runs`` and ``publish`` summed over ranks. Every run's
    config, the single-process ones too, is cut by ``cut``. (``runs``,
    ``faults``, ``publish``, ``device`` and ``cut``: the CPU tests'
    smoke-size run.)"""
    from repro_torch.launch import multiproc
    singles = {}
    for label, name, overrides in list(runs) + [f[:3] for f in faults]:
        key = _single_key(name, overrides)
        if key not in singles:
            t0 = time.time()
            with arch_cut(cut):
                singles[key] = md4_single(Session, spec_lib, name,
                                          overrides, device)
            clients = MD_PODS if _pod_clients(overrides) else MD_RANKS
            print(f"{label}: single-process run (smoke mesh, {clients} "
                  f"clients) {singles[key]} in {time.time() - t0:.1f} s",
                  flush=True)
    work = tempfile.mkdtemp(prefix="md4_")
    stream = os.path.join(work, "wire")
    t0 = time.time()
    try:
        ranks = multiproc.spawn(md4_rank, MD_RANKS, work,
                                args=(runs, device, faults, publish, stream,
                                      cut),
                                threads=2, timeout_s=900)
        if publish is not None:
            replica = md4_replica(ops, publish, stream, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"MD4: {MD_RANKS} ranks in {time.time() - t0:.1f} s, backend "
          f"{ranks[0]['backend']}; gloo with CUDA tensors: "
          f"{ranks[0]['probe']}", flush=True)
    total = {}
    worst = {}
    for label, name, overrides in runs:
        recs = [r["runs"][label] for r in ranks]
        traj = [[(s["loss"], s["g_norm"], s["moved"], s["digest"])
                 for s in rec["steps"]] for rec in recs]
        if any(t != traj[0] for t in traj[1:]):
            fail(f"{label}: the ranks disagree on loss, g_norm, the "
                 f"parameters' distance moved or the replicated state's "
                 f"digest: {traj}")
        for step in traj[0]:
            if not all(math.isfinite(x) for x in step[:3]):
                fail(f"{label}: non-finite loss, g_norm or distance {step}")
        if _pod_clients(overrides):
            # a pod's client is one state on each of its data ranks, and
            # the two pods hold two clients
            by_pod = {}
            for rec in recs:
                by_pod.setdefault(rec["coord"]["pod"], set()).add(
                    tuple(s["client_digest"] for s in rec["steps"]))
            if any(len(d) != 1 for d in by_pod.values()) \
                    or len(set.union(*by_pod.values())) != len(by_pod):
                fail(f"{label}: the client state differs among a pod's "
                     f"data ranks, or is one across pods: {by_pod}")
            print(f"{label}: client state equal on each pod's "
                  f"{MD_RANKS // MD_PODS} data ranks every step, one "
                  f"client a pod ({len(by_pod)} pods)", flush=True)
        worst[label] = max(_relative_diffs(
            traj[0], singles[_single_key(name, overrides)]))
        if worst[label] > MD_TOL:
            fail(f"{label}: loss/g_norm/moved {traj[0]} vs the single-"
                 f"process run {singles[_single_key(name, overrides)]}: relative "
                 f"difference {worst[label]:.3e} > {MD_TOL}")
        for rank, rec in enumerate(recs):
            st = rec["steps"]
            print(f"{label} rank {rank}: mesh {rec['mesh']} n {rec['n']} "
                  f"{rec['params']} parameters, state built in "
                  f"{rec['init_s']:.1f} s; step_ms "
                  f"{[round(s['step_ms'], 1) for s in st]} round_ms "
                  f"{[round(s['round_ms'], 1) for s in st]} collective_ms "
                  f"{[round(s['collective_ms'], 1) for s in st]} "
                  f"(the step's, with the loss's all-reduce "
                  f"{[round(s['step_collective_ms'], 1) for s in st]}; "
                  f"share of the round "
                  f"{[round(s['collective_ms'] / s['round_ms'], 3) for s in st]}"
                  f") collectives a step {st[-1]['collectives']} wire_bytes "
                  f"a step {st[-1]['wire_bytes']} staged_bytes a step "
                  f"{st[-1]['staged_bytes']} peak {rec['peak']} launches "
                  f"{rec['launches']}", flush=True)
            if st[-1]["data_collectives"]:
                print(f"{label} rank {rank}: the data group's all-reduce "
                      f"of the gradient shares: "
                      f"{st[-1]['data_collectives']} collectives a step, "
                      f"{st[-1]['data_bytes']} bytes a step, data_ms "
                      f"{[round(s['data_ms'], 1) for s in st]} beside "
                      f"round_ms {[round(s['round_ms'], 1) for s in st]}",
                      flush=True)
            total = _merged(total, rec["launches"])
        print(f"{label}: loss/g_norm/params moved "
              f"{[(a, b, c) for a, b, c, _ in traj[0]]} on "
              f"every rank, replicated state equal on every rank every "
              f"step; largest relative difference from the single-process "
              f"run {worst[label]:.3e} (tolerance {MD_TOL}); every distinct "
              f"K3-K6 call bit for bit its plain version: "
              f"{recs[0].get('plain')}", flush=True)
    pair = ("MD4-quant8-ring", "MD4-quant8-blocking")
    if all(label in worst for label in pair):
        ring, blocking = ([[(s["loss"], s["g_norm"], s["digest"])
                            for s in r["runs"][label]["steps"]]
                           for r in ranks] for label in pair)
        if ring != blocking:
            fail(f"MD4: the ring's run {ring[0]} is not the blocking "
                 f"gather's {blocking[0]} bit for bit")
        print("MD4: the overlap ring bit for bit the blocking gather (loss, "
              "g_norm and the replicated state's digest, every step, every "
              "rank)", flush=True)
    print(f"MD4: worst relative difference a run {worst}", flush=True)
    if publish is not None:
        total = _merged(total, md4_publish_checks(ranks, publish, replica))
    caught = {}
    for label, name, overrides, fault in faults:
        want = singles[_single_key(name, overrides)]
        per_rank = [_relative_diffs(
            [(s["loss"], s["g_norm"], s["moved"])
             for s in r["faults"][label]["steps"]], want) for r in ranks]
        caught[label] = min(max(d) for d in per_rank)
        if caught[label] <= MD_TOL:
            fail(f"{label}: the planted fault {fault!r} reads "
                 f"{caught[label]:.3e} against the single-process run, "
                 f"within MD_TOL {MD_TOL}: MD4's check would pass it")
        print(f"{label}: planted fault {fault!r}, relative differences "
              f"(loss, g_norm, params moved a step) rank 0 "
              f"{[float(f'{x:.3e}') for x in per_rank[0]]}; the least "
              f"rank's largest {caught[label]:.3e} > MD_TOL {MD_TOL}: "
              "caught", flush=True)
    if faults:
        print(f"MD4: every planted fault caught, readings {caught}; the "
              f"sound runs' {worst}, limit {MD_TOL}", flush=True)
    return total


def md4_replica(ops, publish, stream, device):
    """MD4-publish's replica: one device, joined from the 4-rank stream's
    bootstrap (the join's seconds), the records applied (on the card each
    apply's K4 calls recorded and held to the plain version), its params
    against the trainer's (``trainer.pt``, rank 0's) bit for bit."""
    from repro_torch.kernels import ref
    from repro_torch.launch import fleet as fleet_lib
    label, _, _, steps, cut = publish
    with arch_cut(cut):
        t0 = time.time()
        rep = fleet_lib.ServeReplica(stream, device=device)
        _sync(device)
        join_s = time.time() - t0
        t0 = time.time()
        if device == "cuda":
            plain = [apply_call_check(ops, ref, rep, label)
                     for _ in range(steps)]
        else:
            plain = rep.sync()
        _sync(device)
        apply_s = time.time() - t0
    trainer = torch.load(os.path.join(os.path.dirname(stream),
                                      "trainer.pt"))
    equal = _equal_trees({k: v.cpu() for k, v in rep.params.items()},
                         trainer)
    out = dict(join_s=join_s, apply_s=apply_s, step=rep.step, equal=equal,
               plain=plain, params=sum(v.numel() for v in trainer.values()))
    del rep, trainer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def md4_publish_checks(ranks, publish, replica):
    """MD4-publish's checks and lines: the ranks' loss, g_norm and digest
    equal every step; the replica at the last step and bit for bit the
    trainer's params. Returns its launches summed over the ranks."""
    label, _, _, steps, cut = publish
    recs = [r["publish"] for r in ranks]
    traj = [[(s["loss"], s["g_norm"], s["digest"]) for s in rec["steps"]]
            for rec in recs]
    if any(t != traj[0] for t in traj[1:]):
        fail(f"{label}: the ranks disagree on loss, g_norm or digest")
    if replica["step"] != steps or not replica["equal"]:
        fail(f"{label}: the replica joined from the 4-rank stream is at "
             f"step {replica['step']} (want {steps}); params bit for bit "
             f"the trainer's: {replica['equal']}")
    total = {}
    for rank, rec in enumerate(recs):
        st = rec["steps"]
        print(f"{label} rank {rank}: mesh {rec['mesh']} {rec['params']} "
              f"parameters (cut {cut}); bootstrap "
              f"{rec['bootstrap_s']:.2f} s; step_ms "
              f"{[round(s['step_ms'], 1) for s in st]}, of it publish_ms "
              f"{[round(t, 1) for t in rec['publish_ms']]}; launches "
              f"{rec['launches']}", flush=True)
        total = _merged(total, rec["launches"])
    print(f"{label}: {steps} published step(s), record bytes "
          f"{recs[0]['record_bytes']} ({replica['params']} parameters: a "
          f"dense f32 push {4 * replica['params']}); a single-device "
          f"replica joined in {replica['join_s']:.2f} s, applied in "
          f"{replica['apply_s']:.2f} s, params bit for bit the trainer's; "
          f"rank 0's K3-K6 calls (the publish's among them) bit for bit "
          f"their plain versions: {recs[0].get('plain')}; the apply's: "
          f"{replica['plain']}", flush=True)
    return total


# phase MT: the 'model' axis (tensor parallelism over the attention
# families) on 4 rank processes sharing the card over gloo, the production
# geometry narrowed to (data 2, model 2) in each rank
MT_RANKS = 4
MT_GEOM = {"data": 2, "model": 2}
MT_PATH = dict(carrier="fused_quant8", downlink_carrier="fused_quant4",
               mesh="pod", smoke=False, seq_len=256, global_batch=16,
               seed=0)           # 8 rows of 256 a client, f32 EF state
# each rank's gradient shards at the initial parameters against the
# unsharded pass of the same rows in the same process, both in f32
# activations: the largest leaf's ||tp - whole|| / ||whole||. Only the
# order of the sums differs (the split products' partial sums, the
# vocabulary's log-sum-exp); the planted faults (f the identity both ways;
# a replicated leaf's gradient summed over 'model'; an SSM run's g without
# its f: Mamba1's x_proj sum, Mamba2's out_norm mean square) must read
# above it
MT_GRAD_TOL = 1e-3
MT_FAULTS = ("f-identity", "replicated-summed")
# smollm's runs: full width, 2 of its 32 layers (the script's time limit;
# 16 until the script passed its limit on a slow host); MT-pod-zero and
# MT-single take MT-padded's
MT_SMOLLM_CUT = {"num_layers": 2}
MT_RUNS = [  # (label, arch, tp_pad_heads, depth cut, steps, planted faults)
    # 16 heads, 8 a rank: attention split (2 steps: the script's time
    # limit)
    ("MT-padded", "smollm-360m", 2, MT_SMOLLM_CUT, 2, MT_FAULTS),
    # 15 heads: attention replicated whole (1 step: the script's time
    # limit)
    ("MT-replicated", "smollm-360m", 0, MT_SMOLLM_CUT, 1, ()),
    # 1 of 64 Mamba1 layers, as D-falcon-mamba: d_inner 8192, 4096 a rank;
    # the SSM runs take 1 step (the script's time limit)
    ("MT-falcon-mamba", "falcon-mamba-7b", 0, {"num_layers": 1}, 1,
     MT_FAULTS + ("x_proj-f-dropped",)),
    # one group: 6 Mamba2 blocks (64 heads, 32 a rank), the shared block
    ("MT-zamba2", "zamba2-1.2b", 0, {"num_layers": 6}, 1,
     MT_FAULTS + ("out_norm-f-dropped",)),
]
# the split dims a rank holds: (name, leaf, dim), where the leaf exists
MT_SPLIT_LEAVES = (("heads", "layers/attn/wq", -2),
                   ("heads", "shared_attn/attn/wq", -2),
                   ("d_inner", "layers/mamba/out_proj", -2),
                   ("ssm_heads", "layers/mamba/in_dt", -1))
MT_SMOKE_ARCHS = ("granite-34b", "gemma2-9b", "olmoe-1b-7b",
                  "falcon-mamba-7b", "zamba2-1.2b")
MT_SMOKE = dict(smoke=True, mesh="pod", seq_len=160, global_batch=4)
MT_SMOKE_STEPS = 2
# client granularity 'pod' on the multi_pod mesh narrowed to (pod 2, data
# 1, model 2), one client a pod: MT-padded's spec with state sharding
# 'zero', which adds no split with one data rank a pod (the reference's
# run of this pair is bit for bit its 'client' run), 1 step held bit for
# bit to MT-padded's first (the same ranks form each client's group)
MT_POD_ZERO = dict(mesh="multi_pod", client_granularity="pod",
                   state_sharding="zero")
MT_POD_ZERO_GEOM = {"pod": 2, "data": 1, "model": 2}
# the smoke check's runs on (pod 2, data 2, model 1), card against CPU:
# (label, arch, client granularity, activation dtype (None: the spec's,
# bf16), tolerance or None). A pod's rows split over its data ranks in f32
# within MT_POD_TOL, and in bf16; the bf16 'group' run on the same mesh,
# one client a rank on the same rows a rank, is the bf16 run's control,
# measured, not held: its gap is bf16's rounding without the split (1.5e-3
# on an H100, above P_TOL, a drop count flipping on a rank). The bf16 pod
# run is held within the larger of P_TOL and its control's gap
# (MT_POD_CONTROL). Each step's drop count a client, card and CPU, is
# printed beside.
MT_SMOKE_POD_GEOM = {"pod": 2, "data": 2, "model": 1}
MT_POD_TOL = 1e-4
MT_SMOKE_POD = (
    ("olmoe-1b-7b pod f32", "olmoe-1b-7b", "pod", "float32", MT_POD_TOL),
    ("olmoe-1b-7b pod bf16", "olmoe-1b-7b", "pod", None, None),
    ("olmoe-1b-7b group bf16", "olmoe-1b-7b", "group", None, None),
)
MT_POD_CONTROL = ("olmoe-1b-7b pod bf16", "olmoe-1b-7b group bf16")
MD4_PEAK = 10.51e9               # MD4's peak a rank, measured on four H100s
# MT-serve: after its steps each of these runs serves on its 4 ranks, (B,
# prompt, decode steps); B 8 splits over the 2 data ranks (4 rows a rank)
# and the prompts come from one seed. Each decodes 8 steps (the script's
# time limit; MT-replicated decoded 32 until the script passed its limit on
# a slow host); the CPU rehearsal serves MT_SERVE_SMOKE
MT_SERVE = {"MT-replicated": (8, 1024, 8), "MT-falcon-mamba": (8, 1024, 8),
            "MT-zamba2": (8, 1024, 8)}
MT_SERVE_SMOKE = (4, 64, 4)
# then MT-replicated's ranks serve one row: B 1 does not divide the data
# ranks, every rank serves it and the cache's sequence splits over all
# four (smollm's kv heads do not divide 'model'); 8 decode steps
MT_SERVE_B1 = {"MT-replicated": (1, 1024, 8)}
MT_SERVE_B1_SMOKE = (1, 64, 4)
# the served prefill logits against the single-device serve of the same
# params and prompts on the card, bf16: each row within this share of its
# largest magnitude (the first tokens that agree counted: in bf16 a row's
# top two logits can lie within it, and the argmax of a near-tie flips).
# Every row's first token is held equal on an f32 prefill of the same
# params and prompts on both sides, its logits within P_SERVE_TOL
SERVE_BF16_TOL = 2e-2
# the smoke check's serve, card against CPU, f32 from the fresh weights of
# the spec's seed: 4 rows, the smoke sequence, 4 decode steps; greedy
# tokens and MoE drop counts equal, the prefill logits within P_SERVE_TOL
# of each row's largest magnitude
MT_SMOKE_SERVE = (4, 4)
P_SERVE_TOL = 1e-4


def _mt_narrow(multi_pod=None):
    """The production geometry narrowed in this rank: the pod mesh to
    MT_GEOM, and with ``multi_pod`` (a geometry) the two-pod mesh."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import spec as spec_lib
    mesh_lib.PROD_DATA = MT_GEOM["data"]
    spec_lib.MESH_GEOM["pod"] = dict(MT_GEOM)
    if multi_pod is not None:
        mesh_lib.PROD_DATA = multi_pod["data"]
        spec_lib.MESH_GEOM["multi_pod"] = dict(multi_pod)


def _rel(got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()).clamp_min(1e-30))


@contextlib.contextmanager
def _mt_fault(fault):
    """A planted fault of the tensor-parallel pass: "f-identity" makes
    Megatron's f the identity both ways (the split regions' input
    gradients never summed); "x_proj-f-dropped" and "out_norm-f-dropped"
    leave ``comm.reduce_to_all`` its g alone, which a mamba block calls
    once (Mamba1's x_proj partial sums, Mamba2's split mean square): the
    whole sum's gradient stays each rank's share."""
    from repro_torch.core import comm
    saved = comm.copy_to, comm.reduce_to_all
    if fault == "f-identity":
        comm.copy_to = lambda axes, x: x
    elif fault in ("x_proj-f-dropped", "out_norm-f-dropped"):
        comm.reduce_to_all = comm.reduce_from
    try:
        yield
    finally:
        comm.copy_to, comm.reduce_to_all = saved


def mt_grad_check(sess, device, faults=()):
    """At the Session's initial parameters: this rank's tensor-parallel
    gradient shards of its client's rows against the unsharded pass of the
    same rows (the whole tree, drawn from the same seed, in this process),
    both with f32 activations; the largest leaf's relative difference,
    then each planted fault's. The whole trees are drawn on every rank at
    once; the unsharded passes run two ranks at a time (the ranks share the
    card: four full-width f32 passes at once do not fit it at
    falcon-mamba's d_inner), each rank's cache emptied after its own."""
    import torch.distributed as tdist
    from repro_torch.core import comm
    from repro_torch.core import distributed as dist_lib
    from repro_torch.launch import shardings as sh
    from repro_torch.models import model as model_lib
    spec = sess.spec
    cfg = dataclasses.replace(sess.cfg, dtype="float32")
    axes = sess.client_group
    rows = dist_lib.client_rows(sess.batch_for(sess.step), axes.size,
                                axes.index)
    whole = model_lib.init_params(
        cfg, torch.Generator().manual_seed(spec.seed), device)
    for turn in range((tdist.get_world_size() + 1) // 2):
        if turn == tdist.get_rank() // 2:
            _, _, want = dist_lib.client_value_and_grad(
                lambda p, b: model_lib.train_loss(cfg, p, b), whole, rows)
            del whole
            want = {k: sh.shard_leaf(g[0], sess.pspecs[k],
                                     sess.model_axes.index,
                                     sess.model_axes.size)
                    for k, g in want.items()}
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        tdist.barrier()
    def loss_fn(p, b):
        return model_lib.train_loss(cfg, p, b, tp=sess.tp)

    def reading(fault=None):
        with _mt_fault(fault):
            _, _, got = dist_lib.client_value_and_grad(loss_fn, sess.params,
                                                       rows)
        if fault == "replicated-summed":
            got = {k: comm.all_reduce_sum(sess.model_axes, g)
                   if "model" not in sess.pspecs[k] else g
                   for k, g in got.items()}
        worst = max((_rel(got[k][0], want[k]), k) for k in want)
        return {"rel": worst[0], "leaf": worst[1]}
    out = {"sound": reading()}
    for fault in faults:
        out[fault] = reading(fault)
    del want
    gc.collect()
    return out


def mt_run(ops, ref, label, arch, pad, cut, steps, device="cuda",
           smoke=False, plain=True, faults=(), spec_over=None,
           grad_check=True, serve=None, serve_b1=None):
    """One MT run on this rank: a Session of ``arch`` on (data 2, model 2)
    with ``tp_pad_heads`` ``pad``, its config cut by ``cut`` before the
    first step; the gradient check (with ``faults``), then
    ``steps`` steps, each round's client state held bit for bit against
    the single-device ``ef_round`` of this client over its shard tree (its
    inputs kept in pinned host memory during the round; its launches,
    time and card bytes taken back out of the counts, the step ms and the
    peak: a comparison), per step the loss, g_norm, digest, step and round
    ms and the collectives' seconds;
    the launches against ``expected_launches``; then (``plain``) each
    distinct K3-K6 call bit for bit its plain version. ``spec_over``:
    fields over MT_PATH's (MT-pod-zero's); ``grad_check`` off skips the
    gradient check (a run whose pass is another run's); ``serve`` (B,
    prompt, decode steps): MT-serve after the steps (:func:`mt_serve`)."""
    from repro_torch.core import comm
    from repro_torch.core import distributed as dist_lib
    from repro_torch.core import ef as ef_lib
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import spec as spec_lib
    from repro_torch.launch.session import Session
    over = dict(MT_PATH, arch=arch, tp_pad_heads=pad, **(spec_over or {}))
    if smoke:
        over.update(smoke=True, seq_len=64, global_batch=4)
    spec = load_spec(spec_lib, **over)
    cuda = device == "cuda"
    sess = Session(spec, device=device)
    if cut and not smoke:
        sess.cfg = dataclasses.replace(sess.cfg, **cut)
    t0 = time.time()
    n_local = sum(p.numel() for p in sess.params.values())
    _sync(device)
    rec = {"mesh": dict(sess.mesh.shape), "coord": sess.mesh.coordinate(),
           "split": {n: sess.params[k].shape[d]
                     for n, k, d in MT_SPLIT_LEAVES if k in sess.params},
           "params_local": n_local, "init_s": time.time() - t0,
           "steps": [], "client_state_equal": []}
    t0 = time.time()
    if grad_check:
        rec["grads"] = mt_grad_check(sess, device, faults)
    rec["grad_check_s"] = time.time() - t0
    efc = sess._tr["efc"]
    per_step = expected_launches(efc, sess.params,
                                 gathered=sess.client_group.size)
    orig = dist_lib.ef_round_sharded
    timing, peaks = {}, []

    def to_dev(tree):
        return {k: v.to(device) for k, v in tree.items()}

    def checked(efc_, grads, ef_state, mesh, **kw):
        # the round's inputs the check needs, kept in pinned host memory so
        # that they hold no card memory while the round runs
        t_c = time.time()
        clients = {f: _host_copy(t) for f, t in ef_state["clients"].items()}
        g_host = _host_copy(grads)
        _sync(device)
        check_s = time.time() - t_c
        t, c = time.time(), comm.STATS["seconds"]
        out = orig(efc_, grads, ef_state, mesh, **kw)
        _sync(device)
        timing["round_ms"] = (time.time() - t) * 1e3
        timing["collective_ms"] = (comm.STATS["seconds"] - c) * 1e3
        if cuda:
            peaks.append(torch.cuda.max_memory_allocated())
        t_c = time.time()
        saved = dict(ops.launches)
        before = {p: ef_lib.tree_clone(v) for p, v in out[1].items()
                  if p != "clients"}
        before["clients"] = {f: to_dev(t) for f, t in clients.items()}
        _, single = dist_lib.ef_round(efc_, to_dev(g_host), before,
                                      eta=kw.get("eta"), step=kw.get("step"),
                                      rng=kw.get("rng"))
        rec["client_state_equal"].append(
            _equal_states(single["clients"], out[1]["clients"]))
        ops.launches.update(saved)
        del before, single, clients, g_host
        _sync(device)
        if cuda:             # the check's own bytes are not the path's
            torch.cuda.reset_peak_memory_stats()
        timing["check_ms"] = (check_s + time.time() - t_c) * 1e3
        return out
    dist_lib.ef_round_sharded = checked
    comm.TIMED = True
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        with recorded_calls(ops, ROW_KERNELS, shapes_only=True) as calls:
            for _ in range(steps):
                comm.reset_stats()
                _sync(device)
                t = time.time()
                m = sess.step_once()
                loss, g_norm = float(m["loss"]), float(m["g_norm"])
                _sync(device)
                rec["steps"].append(dict(
                    loss=loss, g_norm=g_norm,
                    step_ms=(time.time() - t) * 1e3 - timing["check_ms"],
                    tp_ms=comm.STATS["tp_seconds"] * 1e3,
                    tp_collectives=comm.STATS["tp_collectives"],
                    digest=sh.replicated_digest(sess.params, sess.ef_state),
                    client_digest=sh.tree_digest(sess.ef_state["clients"]),
                    **timing))
    finally:
        dist_lib.ef_round_sharded = orig
        comm.TIMED = False
    rec["launches"] = {k: v for k, v in ops.launches.items() if v}
    rec["peak"] = max(peaks + [torch.cuda.max_memory_allocated()]) \
        if cuda else 0
    if cuda:
        check_launches(rec["launches"], per_step, steps, label)
    if serve is not None:
        rec["serve"] = mt_serve(sess, ops, label, serve, device)
    if serve_b1 is not None:
        rec["serve_b1"] = mt_serve(sess, ops, label + " B1", serve_b1,
                                   device)
    del sess, m
    gc.collect()
    if cuda and plain:
        torch.cuda.empty_cache()
        rec["plain"] = check_shapes_plain(ops, ref, label, calls)
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def _client_drops(sess):
    """The assignments this rank's client drops at the step about to run,
    summed over the layers: the forward at the step's params on the
    client's rows (under pod clients this rank's block, the shares summed
    over its data group)."""
    from repro_torch.core import comm
    from repro_torch.core import distributed as dist_lib
    from repro_torch.models import model as model_lib
    group, split = sess.client_group, sess.data_axes
    rows = dist_lib.client_rows(sess.batch_for(sess.step), group.size,
                                group.index)
    rows = dist_lib.client_rows(rows, split.size, split.index)
    with torch.no_grad():
        _, aux = model_lib.train_loss(sess.cfg, sess.params, rows,
                                      split=split if split.size > 1
                                      else None)
    frac = comm.share_sum(split, aux["dropped_frac"]) if split.size > 1 \
        else aux["dropped_frac"]
    return round(float(frac) * rows["tokens"].numel() * split.size
                 * sess.cfg.num_experts_per_tok)


@contextlib.contextmanager
def serve_record(drops=None):
    """Within: the first serving logits of each serve (the prefill's last
    position, f32 on the host) are appended to the list it yields; with
    ``drops`` (a list), each MoE call's dropped assignments among this
    rank's tokens (under a row split ``dropped_frac`` is this rank's share
    of the call's)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib
    seen, orig, orig_moe = [], model_lib._serve_logits, moe_lib.moe_apply

    def logits(*a, **kw):
        lg = orig(*a, **kw)
        seen.append(lg[:, -1].float().cpu())
        return lg

    def moe(p, x, **kw):
        out, aux = orig_moe(p, x, **kw)
        split = kw.get("split")
        n = x.shape[0] * x.shape[1] * kw["k"] * (split.size if split else 1)
        drops.append(round(float(aux["dropped_frac"]) * n))
        return out, aux
    model_lib._serve_logits = logits
    if drops is not None:
        moe_lib.moe_apply = moe
    try:
        yield seen
    finally:
        model_lib._serve_logits, moe_lib.moe_apply = orig, orig_moe


@contextlib.contextmanager
def f32_partials():
    """Within: each MLP's row-parallel ``w_down`` product under a 'model'
    split summed over the axis in f32 and rounded to the activation dtype
    once, as one device rounds the whole product; as served, each rank's
    partial product is rounded to bf16 before the f32 sum
    (``comm._model_all_reduce``), as the reference's compiled prefill
    rounds it (tests/test_torch_tensor_parallel.py)."""
    import torch.nn.functional as F
    from repro_torch.core import comm
    from repro_torch.models import layers
    orig = layers.mlp_apply

    def mlp(p, x, eps, tp=None):
        if tp is None or not tp.ff:
            return orig(p, x, eps, tp)
        h = comm.copy_to(tp.axes, layers.rms_norm(x, p["norm"], eps))
        act = (F.silu(h @ p["w_gate"].to(h.dtype))
               * (h @ p["w_up"].to(h.dtype)))
        out = act.float() @ p["w_down"].float()
        return comm.reduce_from(tp.axes, out).to(x.dtype)
    layers.mlp_apply = mlp
    try:
        yield
    finally:
        layers.mlp_apply = orig


def _moved(got, want) -> float:
    """The share of the logits that differ at all."""
    return float((got != want).float().mean())


def _row_rel(got, want) -> float:
    """The largest |got − want| of a row over the row's largest |want|."""
    return float(((got - want).abs().amax(-1)
                  / want.abs().amax(-1).clamp_min(1e-30)).max())


def mt_serve(sess, ops, label, shape, device="cuda"):
    """MT-serve on this rank: the Session's trained params served on the 4
    ranks ((data 2, model 2): each data rank its rows, on its shards and
    cache slice, the tokens gathered), the prompts from one seed; the
    launches (K7 ``model.flash_layers`` times, in the prefill only), the
    'model' collectives of the prefill and of one decode step, the times,
    the global and the rank's cache bytes and the peak. Then the first rank
    of each data coordinate gathers the params over 'model' and rank 0
    serves them on one device (the smoke mesh) on the same prompts: the
    prefill logits' largest row-relative gap, the first tokens, and how
    many decode tokens agree. The yardstick: one device's bf16 prefill
    against its f32 prefill. Where the family is dense and 'model' splits
    the MLP, the split's own rounding: the prefill again on the 4 ranks
    under :func:`f32_partials`, against one device."""
    from repro_torch.core import comm
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.session import Session
    from repro_torch.models import model as model_lib
    B, S, steps = shape
    cuda = device == "cuda"
    tokens = torch.randint(0, sess.cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    marks = []

    def hook(i):
        if i < 2:
            _sync(device)
            marks.append(dict(comm.STATS))
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    comm.reset_stats()
    ops.reset_launches()
    with serve_record() as seen:
        out = sess.serve(tokens=tokens, decode_steps=steps, decode_hook=hook)
    rec = {k: out[k] for k in ("prefill_s", "decode_s", "prefill_tok_s",
                               "decode_tok_s", "cache_bytes",
                               "local_cache_bytes")}
    rec.update(
        tokens=out["tokens"], cuda=cuda,
        peak=torch.cuda.max_memory_allocated() if cuda else 0,
        launches={k: v for k, v in ops.launches.items() if v},
        flash_layers=model_lib.flash_layers(sess.cfg),
        tp_prefill=marks[0]["tp_collectives"],
        tp_prefill_ms=marks[0]["tp_seconds"] * 1e3,
        tp_decode=marks[1]["tp_collectives"] - marks[0]["tp_collectives"],
        tp_decode_ms=(marks[1]["tp_seconds"] - marks[0]["tp_seconds"]) * 1e3)
    rec["shard_bytes"] = reference_shard_bytes(
        sess.cfg, sess.mesh, B, S + steps,
        {k: t.element_size() for k, t in model_lib.init_cache(
            sess.cfg, 1, 1, device="meta").items()})
    rows = sh.serve_rows(sess.mesh, B)
    logits = sh.gather_rows(rows, seen[0].to(device)).cpu()
    saved = dict(ops.launches)
    cfg32 = dataclasses.replace(sess.cfg, dtype="float32")
    logits32 = sh.gather_rows(rows, prefill_f32_logits(
        model_lib, cfg32, sess.params, sh.local_rows(tokens, rows), device,
        sess.tp, rows)).cpu()
    partials32 = None
    if sess.cfg.family == "dense" and sess.tp.ff:
        with f32_partials(), serve_record() as seen_op:
            sess.serve(tokens=tokens, decode_steps=0)
        partials32 = sh.gather_rows(rows, seen_op[0].to(device)).cpu()
    if sess.mesh.coordinate()["data"] == 0:
        whole = sh.unshard_tree(sess.params, sess.pspecs, sess.model_axes)
        if sess.mesh.rank == 0:
            one = Session(dataclasses.replace(sess.spec, mesh="smoke",
                                              clients=2), device=device)
            one.cfg = sess.cfg
            one.set_serve_params(whole)
            with serve_record() as seen1:
                want = one.serve(tokens=tokens, decode_steps=steps)
            del one
            want32 = prefill_f32_logits(
                model_lib, cfg32, {k: v.to(device) for k, v in whole.items()},
                tokens, device).cpu()
            del whole
            first = out["tokens"][:, 0] == want["tokens"][:, 0]
            top = seen1[0].topk(2, dim=-1).values
            rec["single"] = dict(
                rel=_row_rel(logits, seen1[0]),
                moved=_moved(logits, seen1[0]),
                partials32=None if partials32 is None else (
                    _row_rel(partials32, seen1[0]),
                    _moved(partials32, seen1[0])),
                # what bf16 costs one device: its prefill against f32's
                yardstick=_row_rel(seen1[0], want32),
                first_equal=int(first.sum()),
                # a differing row's top-two gap in the single-device
                # logits, over the row's largest magnitude
                first_gaps=[float((top[i, 0] - top[i, 1])
                                  / seen1[0][i].abs().max())
                            for i in np.flatnonzero(~first)],
                rel32=_row_rel(logits32, want32),
                first32_equal=bool((logits32.argmax(-1)
                                    == want32.argmax(-1)).all()),
                decode_equal=int((out["tokens"][:, 1:]
                                  == want["tokens"][:, 1:]).sum()),
                decode_total=int(out["tokens"][:, 1:].size),
                prefill_ms=want["prefill_s"] * 1e3,
                decode_ms=want["decode_s"] * 1e3)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    ops.launches.update(saved)
    return rec


def reference_shard_bytes(cfg, mesh, B, slots, itemsize):
    """A rank's bytes of a serving cache of ``B`` rows and ``slots`` in
    the reference's layout (``shardings.cache_pspecs``: each split dim
    divided by its axes' sizes), the leaves ``itemsize`` bytes an element;
    a hybrid's conv state in the port's order (its d_inner block, then B
    and C's 2N columns whole)."""
    from repro_torch.launch import shardings as sh
    from repro_torch.models import model as model_lib
    whole = model_lib.init_cache(cfg, B, slots, device="meta")
    total = 0
    for key, spec in sh.cache_pspecs(cfg, mesh, B).items():
        shape = list(whole[key].shape)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            n = math.prod(mesh.shape[a] for a in ((entry,) if isinstance(
                entry, str) else entry))
            if key == "conv" and cfg.family == "hybrid" \
                    and dim == len(shape) - 1:
                shape[dim] = cfg.d_inner // n + 2 * cfg.ssm_state
            else:
                shape[dim] //= n
        total += math.prod(shape) * itemsize[key]
    return total


def prefill_f32_logits(model_lib, cfg32, params, tokens, device, tp=None,
                       rows=None):
    """The last position's logits of an f32 prefill of ``tokens`` (this
    rank's rows) on ``params`` (this rank's shards under ``tp``, cast to
    f32 as the f32 serve casts them), from a zero cache."""
    cache = model_lib.init_cache(cfg32, tokens.shape[0], tokens.shape[1],
                                 device=device, tp=tp)
    params = model_lib.cast_matrices(cfg32, params)
    lg, _ = model_lib.prefill(cfg32, params, {"tokens": tokens.to(device)},
                              cache, tp=tp, split=rows)
    return lg[:, -1].float()


def mt_serve_checks(ranks, label, shape, key="serve"):
    """MT-serve's checks and lines: the tokens equal on every rank and of
    the requested shape; each rank's launches K7 ``flash_layers`` times
    and nothing else (on the card; the CPU runs the plain version,
    uncounted); each rank's cache bytes its shard in the reference's
    layout (``reference_shard_bytes``); rank 0's comparison with the
    single-device serve: bf16 prefill logits within SERVE_BF16_TOL (the
    first tokens that agree counted, each differing row's top-two gap
    printed), and an f32 prefill of the same params within P_SERVE_TOL,
    every first token equal. Returns the launches summed over the
    ranks."""
    recs = [r["runs"][label][key] for r in ranks]
    if key != "serve":                  # the one-row serve
        label = f"{label} B{shape[0]}"
    B, S, steps = shape
    if any(not np.array_equal(rec["tokens"], recs[0]["tokens"])
           for rec in recs) or recs[0]["tokens"].shape != (B, steps + 1):
        fail(f"{label} serve: the ranks' tokens differ or are not "
             f"({B}, {steps + 1})")
    total = {}
    for rank, rec in enumerate(recs):
        want = {"flash_attention": rec["flash_layers"]} \
            if rec["flash_layers"] and rec["cuda"] else {}
        if rec["launches"] != want:
            fail(f"{label} serve rank {rank}: launches {rec['launches']}, "
                 f"expected {want} (K7 once a layer it runs in, in the "
                 "prefill)")
        total = _merged(total, rec["launches"])
        if rec["local_cache_bytes"] != rec["shard_bytes"]:
            fail(f"{label} serve rank {rank}: the rank's cache holds "
                 f"{rec['local_cache_bytes']} bytes, its shard in the "
                 f"reference's layout {rec['shard_bytes']}")
        print(f"{label} serve rank {rank}: B {B} × {S}, {steps} decode "
              f"steps: prefill {rec['prefill_s'] * 1e3:.1f} ms "
              f"({rec['prefill_tok_s']:.1f} tok/s), decode "
              f"{rec['decode_s'] * 1e3:.1f} ms ({rec['decode_tok_s']:.1f} "
              f"tok/s); 'model' collectives a prefill {rec['tp_prefill']} "
              f"({rec['tp_prefill_ms']:.1f} ms), a decode step "
              f"{rec['tp_decode']} ({rec['tp_decode_ms']:.1f} ms); "
              f"cache_bytes {rec['cache_bytes']} (this rank's "
              f"{rec['local_cache_bytes']}); peak {rec['peak']}; launches "
              f"{rec['launches']}", flush=True)
    one = recs[0]["single"]
    if one["rel"] > SERVE_BF16_TOL or one["rel32"] > P_SERVE_TOL \
            or not one["first32_equal"]:
        fail(f"{label} serve: against the single-device serve of the same "
             f"params and prompts, bf16 prefill logits {one['rel']:.3e} of "
             f"a row's largest (limit {SERVE_BF16_TOL}); f32 prefill logits "
             f"{one['rel32']:.3e} (limit {P_SERVE_TOL}), every first token "
             f"equal: {one['first32_equal']}")
    print(f"{label} serve: tokens equal on every rank; against one device "
          f"(prefill {one['prefill_ms']:.1f} ms, decode "
          f"{one['decode_ms']:.1f} ms): bf16 prefill logits within "
          f"{one['rel']:.3e} of each row's largest (limit "
          f"{SERVE_BF16_TOL}), {one['first_equal']} of {B} first tokens "
          f"equal (the others' top-two gaps {one['first_gaps']} of the "
          f"row's largest), {one['decode_equal']} of {one['decode_total']} "
          f"decode tokens equal; f32 prefill logits within "
          f"{one['rel32']:.3e} (limit {P_SERVE_TOL}), every first token "
          "equal", flush=True)
    print(f"{label} serve: the yardstick, one device's bf16 prefill "
          f"against its f32 prefill: {one['yardstick']:.3e} of each row's "
          "largest", flush=True)
    if one["partials32"] is not None:
        rel, moved = one["partials32"]
        print(f"{label} serve: the split's own rounding, each rank's MLP "
              "w_down partial product rounded to bf16 before the f32 sum "
              "over 'model' (comm._model_all_reduce; the reference rounds "
              "it alike): summed in f32 and rounded once (f32_partials), "
              "the prefill logits differ from one device's in a share "
              f"{moved:.4f} (as served {one['moved']:.4f}), within "
              f"{rel:.3e} of a row's largest (as served {one['rel']:.3e}); "
              "the rest of the gap is bf16 rounding spread over the ops, "
              "no one op (tools/bf16_upcast.py --serve)", flush=True)
    return total


def mt_smoke_serve(Session, spec, device):
    """The smoke check's serve on this rank: a fresh f32 Session of the
    spec (the seed's weights) serves MT_SMOKE_SERVE's rows of the smoke
    sequence: the tokens, the prefill logits of this rank's rows and each
    MoE call's drop count."""
    B, steps = MT_SMOKE_SERVE
    sess = Session(spec, device=device, dtype="float32")
    tokens = torch.randint(0, sess.cfg.vocab_size, (B, spec.seq_len),
                           generator=torch.Generator().manual_seed(2))
    drops = []
    with serve_record(drops) as seen:
        out = sess.serve(tokens=tokens, decode_steps=steps)
    return {"tokens": out["tokens"], "logits": seen[0], "drops": drops}


def mt_smoke(arch, granularity=None, dtype=None):
    """One arch at smoke size on (data 2, model 2), or with a client
    ``granularity`` on (pod 2, data 2, model 1) (MT_SMOKE_POD_GEOM) with
    the activation ``dtype`` (None: the spec's), on the card and on the
    CPU in the same gloo world: each step's loss and g_norm (the card
    run's launches taken back out: a comparison), and under a granularity
    each step's drop count of this rank's client (:func:`_client_drops`).
    The SSM archs run three scan chunks (D_SMOKE_SCAN's sequence)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import spec as spec_lib
    from repro_torch.launch.session import Session
    over = dict(MT_SMOKE)
    if granularity:
        over.update(mesh="multi_pod", client_granularity=granularity)
    if arch in SCAN_ARCHS:
        over["seq_len"] = D_SMOKE_SCAN["seq_len"]
    spec = load_spec(spec_lib, **dict(R_PATH, arch=arch, **over))
    out = {"drops": {}, "serve": {}}
    for device in ("cuda", "cpu"):
        saved = dict(ops.launches)
        sess = Session(spec, device=device, dtype=dtype)
        steps, drops = [], []
        for _ in range(MT_SMOKE_STEPS):
            if granularity:
                drops.append(_client_drops(sess))
            m = sess.step_once()
            steps.append((float(m["loss"]), float(m["g_norm"])))
        out[device], out["drops"][device] = steps, drops
        del sess
        if not granularity:
            out["serve"][device] = mt_smoke_serve(Session, spec, device)
        ops.launches.update(saved)
        gc.collect()
    return out


def mt_rank(rank, runs, device="cuda", smoke=False,
            smoke_archs=MT_SMOKE_ARCHS, smoke_pod=MT_SMOKE_POD):
    """One of MT's rank processes (``multiproc.spawn``, gloo, the card
    shared, the kernels' library from the parent's build): each run of
    ``runs`` with its planted faults' gradient readings, MT-pod-zero on
    (pod 2, data 1, model 2) where ``runs`` holds MT-padded (its
    reference), then the smoke archs on card and CPU, and ``smoke_pod``'s
    runs on (pod 2, data 2, model 1). Rank 0 holds the distinct K3-K6
    calls against the plain versions."""
    from repro_torch.kernels import build, ops, ref
    _mt_narrow()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        build.build()
    out = {"runs": {}, "smoke": {}, "smoke_pod": {}}
    for label, arch, pad, cut, steps, faults in runs:
        serve, serve_b1 = MT_SERVE.get(label), MT_SERVE_B1.get(label)
        if serve is not None and smoke:
            serve = MT_SERVE_SMOKE
        if serve_b1 is not None and smoke:
            serve_b1 = MT_SERVE_B1_SMOKE
        out["runs"][label] = mt_run(ops, ref, label, arch, pad, cut, steps,
                                    device, smoke, plain=rank == 0,
                                    faults=faults, serve=serve,
                                    serve_b1=serve_b1)
    if _has_padded(runs):
        _mt_narrow(MT_POD_ZERO_GEOM)
        out["pod_zero"] = mt_run(ops, ref, "MT-pod-zero", "smollm-360m", 2,
                                 MT_SMOLLM_CUT, 1, device, smoke,
                                 plain=rank == 0,
                                 spec_over=MT_POD_ZERO, grad_check=False)
        _mt_narrow()
    t0 = time.time()
    for arch in smoke_archs:
        out["smoke"][arch] = mt_smoke(arch)
    if smoke_pod:
        _mt_narrow(MT_SMOKE_POD_GEOM)
        for label, arch, granularity, dtype, _ in smoke_pod:
            out["smoke_pod"][label] = mt_smoke(arch, granularity, dtype)
        _mt_narrow()
    out["smoke_s"] = time.time() - t0
    return out


def _has_padded(runs) -> bool:
    """MT-pod-zero runs only beside MT-padded, the run it must equal."""
    return any(run[0] == "MT-padded" for run in runs)


def mt_phase(ops, runs=MT_RUNS, device="cuda", smoke=False,
             smoke_archs=MT_SMOKE_ARCHS, smoke_pod=MT_SMOKE_POD):
    """MT: MT_RANKS rank processes on the one card (gloo), the mesh (data
    2, model 2), full width (recompute on, f32 EF state, 8 rows of 256 a
    client), MT_RUNS: smollm-360m padded (attention split over the axis)
    and unpadded (attention replicated), falcon-mamba-7b and zamba2-1.2b
    cut in depth. Checks: each rank's gradient shards within MT_GRAD_TOL
    of the unsharded pass and each run's planted faults above it; every
    round's client state bit for bit the
    single-device round over the shard tree; loss and g_norm equal on
    every rank and the replicated state's digest equal among the ranks of
    a 'model' coordinate every step; the launches; rank 0's distinct K3-K6
    calls bit for bit their plain versions; MT-pod-zero, where ``runs``
    holds MT-padded, bit for bit MT-padded's first step (loss, g_norm,
    each rank's client state); the smoke archs on the card within P_TOL
    of the CPU and each of ``smoke_pod`` within its own tolerance, its
    drop counts printed. Returns the runs' launches summed over ranks and
    each run's losses and MT-serve's launches by run. (``device``/
    ``smoke``: the CPU rehearsal at smoke size.)"""
    from repro_torch.launch import multiproc
    work = tempfile.mkdtemp(prefix="mt_")
    t0 = time.time()
    try:
        ranks = multiproc.spawn(mt_rank, MT_RANKS, work,
                                args=(runs, device, smoke, smoke_archs,
                                      smoke_pod),
                                threads=2, timeout_s=900)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"MT: {MT_RANKS} ranks in {time.time() - t0:.1f} s "
          f"(smoke archs {ranks[0]['smoke_s']:.1f} s of it)", flush=True)
    total, readings, losses, serve_launches = {}, {}, {}, {}
    for label, _, _, _, steps, faults in runs:
        recs = [r["runs"][label] for r in ranks]
        if any(rec["mesh"] != MT_GEOM for rec in recs):
            fail(f"{label}: meshes {[rec['mesh'] for rec in recs]}")
        traj = [[(s["loss"], s["g_norm"]) for s in rec["steps"]]
                for rec in recs]
        if any(t != traj[0] for t in traj[1:]):
            fail(f"{label}: the ranks disagree on loss or g_norm: {traj}")
        if not all(math.isfinite(x) for st in traj[0] for x in st):
            fail(f"{label}: non-finite loss or g_norm {traj[0]}")
        losses[label] = [loss for loss, _ in traj[0]]
        for step in range(steps):
            for m in range(MT_GEOM["model"]):
                digests = {rec["steps"][step]["digest"] for rec in recs
                           if rec["coord"]["model"] == m}
                if len(digests) != 1:
                    fail(f"{label} step {step}: the replicated state differs "
                         f"among the ranks of model coordinate {m}")
        for rec in recs:
            if not (len(rec["client_state_equal"]) == steps
                    and all(rec["client_state_equal"])):
                fail(f"{label} rank {rec['coord']}: a round's client state "
                     "is not the single-device round's over the shard tree "
                     f"bit for bit: {rec['client_state_equal']}")
            sound = rec["grads"]["sound"]
            if sound["rel"] > MT_GRAD_TOL:
                fail(f"{label} rank {rec['coord']}: gradient shards "
                     f"{sound['rel']:.3e} from the unsharded pass (leaf "
                     f"{sound['leaf']}) > MT_GRAD_TOL {MT_GRAD_TOL}")
        readings[label] = max(rec["grads"]["sound"]["rel"] for rec in recs)
        for fault in faults:
            caught = min(rec["grads"][fault]["rel"] for rec in recs)
            if caught <= MT_GRAD_TOL:
                fail(f"{label}: the planted fault {fault!r} reads "
                     f"{caught:.3e}, within MT_GRAD_TOL {MT_GRAD_TOL}: the "
                     "gradient check would pass it")
            readings[f"{label}/{fault}"] = caught
            print(f"{label}: planted fault {fault!r}: the least rank's "
                  f"reading {caught:.3e} (leaf "
                  f"{recs[0]['grads'][fault]['leaf']}) > MT_GRAD_TOL "
                  f"{MT_GRAD_TOL}: caught", flush=True)
        for rec in recs:
            st = rec["steps"]
            print(f"{label} rank {rec['coord']}: split a rank "
                  f"{rec['split']}, {rec['params_local']} parameters held, "
                  f"gradient shards {rec['grads']['sound']['rel']:.3e} from "
                  f"the unsharded pass (check {rec['grad_check_s']:.1f} s); "
                  f"step_ms {[round(s['step_ms'], 1) for s in st]} (the "
                  f"client-state check's "
                  f"{[round(s['check_ms'], 1) for s in st]} ms taken out) "
                  f"round_ms "
                  f"{[round(s['round_ms'], 1) for s in st]} round "
                  f"collective_ms {[round(s['collective_ms'], 1) for s in st]}"
                  f" (share of the round "
                  f"{[round(s['collective_ms'] / s['round_ms'], 3) for s in st]}"
                  f") client-pass tp collectives a step "
                  f"{st[-1]['tp_collectives']} tp_ms "
                  f"{[round(s['tp_ms'], 1) for s in st]} peak {rec['peak']} "
                  f"({rec['peak'] / MD4_PEAK:.3f} of MD4's {MD4_PEAK:.4g}) "
                  f"launches {rec['launches']}", flush=True)
            total = _merged(total, rec["launches"])
        print(f"{label}: loss/g_norm {traj[0]} on every rank; replicated "
              f"state equal per model coordinate every step; client state "
              f"bit for bit the single-device round every step; every "
              f"distinct K3-K6 call bit for bit its plain version: "
              f"{recs[0].get('plain')}", flush=True)
        if "serve" in recs[0]:
            shape = MT_SERVE_SMOKE if smoke else MT_SERVE[label]
            serve_launches[label] = mt_serve_checks(ranks, label, shape)
            total = _merged(total, serve_launches[label])
        if "serve_b1" in recs[0]:
            shape = MT_SERVE_B1_SMOKE if smoke else MT_SERVE_B1[label]
            b1 = mt_serve_checks(ranks, label, shape, key="serve_b1")
            serve_launches[label + " B1"] = b1
            total = _merged(total, b1)
    if _has_padded(runs):
        total = _merged(total, _mt_pod_zero(ranks, losses))
    else:
        print("MT-pod-zero: not run (its reference MT-padded is not among "
              "the runs)", flush=True)
    gaps = {}
    for label, _, _, _, tol in smoke_pod:
        runs_ = [r["smoke_pod"][label] for r in ranks]
        if any((r["cuda"], r["cpu"]) != (runs_[0]["cuda"], runs_[0]["cpu"])
               for r in runs_[1:]):
            fail(f"MT {label}: the ranks disagree on loss or g_norm")
        if not all(math.isfinite(x) for dev in ("cuda", "cpu")
                   for st in runs_[0][dev] for x in st):
            fail(f"MT smoke {label}: non-finite loss or g_norm {runs_[0]}")
        diffs = [max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(ca, cb))
                 for ca, cb in zip(runs_[0]["cuda"], runs_[0]["cpu"])]
        gaps[label] = max(diffs)
        drops = {dev: [r["drops"][dev] for r in runs_]
                 for dev in ("cuda", "cpu")}
        print(f"MT smoke {label} on {MT_SMOKE_POD_GEOM}, card against CPU: "
              f"loss/g_norm card {runs_[0]['cuda']} CPU {runs_[0]['cpu']}, "
              f"largest relative difference a step "
              f"{[float(f'{d:.4g}') for d in diffs]} (limit "
              f"{'its control' if tol is None else tol}); drop "
              f"counts a rank's client a step, card {drops['cuda']} CPU "
              f"{drops['cpu']}", flush=True)
        if tol is not None and gaps[label] > tol:
            fail(f"MT smoke {label} on {MT_SMOKE_POD_GEOM}: card against "
                 f"CPU {gaps[label]:.3e} > {tol}")
    run, control = MT_POD_CONTROL
    if run in gaps and control in gaps:
        bar = max(P_TOL, gaps[control])
        if gaps[run] > bar:
            fail(f"MT smoke {run}: card against CPU {gaps[run]:.3e} above "
                 f"the larger of P_TOL {P_TOL} and its control {control}'s "
                 f"{gaps[control]:.3e}: the split adds to bf16's rounding")
        print(f"MT smoke {run}: card against CPU {gaps[run]:.3e}, within "
              f"the larger of P_TOL {P_TOL} and the gap of its control "
              f"{control} without the split, {gaps[control]:.3e}; the "
              "control's gap is the MoE layer's bf16, its router input "
              "included, and a drop count flips at a router near tie "
              "(tools/bf16_upcast.py --pod reads both)", flush=True)
    worst, served = {}, {}
    for arch in smoke_archs:
        runs_ = ranks[0]["smoke"][arch]
        if any((r["smoke"][arch]["cuda"], r["smoke"][arch]["cpu"])
               != (runs_["cuda"], runs_["cpu"]) for r in ranks[1:]):
            fail(f"MT {arch}: the ranks disagree at smoke size")
        d = [abs(a - b) / max(abs(b), 1e-12)
             for ca, cb in zip(runs_["cuda"], runs_["cpu"])
             for a, b in zip(ca, cb)]
        worst[arch] = max(d)
        if worst[arch] > P_TOL:
            fail(f"MT {arch} smoke: card {runs_['cuda']} vs CPU "
                 f"{runs_['cpu']}: {worst[arch]:.3e} > {P_TOL}")
        served[arch] = mt_smoke_serve_check(ranks, arch)
    if smoke_archs:
        print(f"MT smoke on (data 2, model 2), card against CPU over "
              f"{MT_SMOKE_STEPS} steps, largest relative difference "
              f"{worst} (limit {P_TOL}); the serve's prefill logits "
              f"{served} of a row's largest (limit {P_SERVE_TOL}), greedy "
              "tokens and drop counts equal", flush=True)
    print(f"MT: gradient readings {readings} (limit {MT_GRAD_TOL})",
          flush=True)
    return total, losses, serve_launches


def mt_smoke_serve_check(ranks, arch):
    """The smoke check's serve of ``arch``, card against CPU on every
    rank: the tokens equal (and equal among the ranks), the drop counts
    of every MoE call equal, the prefill logits of the rank's rows within
    P_SERVE_TOL. Returns the largest logits gap."""
    gap = 0.0
    for rank, r in enumerate(ranks):
        card, cpu = (r["smoke"][arch]["serve"][d] for d in ("cuda", "cpu"))
        if not np.array_equal(card["tokens"], cpu["tokens"]) or \
                not np.array_equal(card["tokens"],
                                   ranks[0]["smoke"][arch]["serve"]["cpu"]
                                   ["tokens"]):
            fail(f"MT {arch} smoke serve rank {rank}: greedy tokens differ, "
                 f"card {card['tokens'].tolist()} CPU "
                 f"{cpu['tokens'].tolist()}")
        if card["drops"] != cpu["drops"]:
            fail(f"MT {arch} smoke serve rank {rank}: drop counts card "
                 f"{card['drops']} CPU {cpu['drops']}")
        gap = max(gap, _row_rel(card["logits"], cpu["logits"]))
    drops = [r["smoke"][arch]["serve"]["cuda"]["drops"] for r in ranks]
    if any(drops):
        # ranks 0 and 2 are the data ranks of 'model' coordinate 0
        print(f"MT {arch} smoke serve: each MoE call's drop count (the "
              f"prefill's, then each decode step's, a layer each), the two "
              f"data ranks' summed {[a + b for a, b in zip(*drops[::2])]}, "
              "equal on card and CPU", flush=True)
    if gap > P_SERVE_TOL:
        fail(f"MT {arch} smoke serve: prefill logits card against CPU "
             f"{gap:.3e} of a row's largest > {P_SERVE_TOL}")
    return float(f"{gap:.4g}")


def _mt_pod_zero(ranks, losses):
    """MT-pod-zero's checks: the mesh, the ranks' agreement, every round's
    client state bit for bit the single-device round over the shard tree,
    and its one step bit for bit MT-padded's first (loss, g_norm and each
    rank's client state: rank r is client r // 2's shard r % 2 on both
    meshes); where they differ, the failure names what. Returns its
    launches summed over ranks."""
    recs = [r["pod_zero"] for r in ranks]
    pads = [r["runs"]["MT-padded"] for r in ranks]
    if any(rec["mesh"] != MT_POD_ZERO_GEOM for rec in recs):
        fail(f"MT-pod-zero: meshes {[rec['mesh'] for rec in recs]}")
    if any(not all(rec["client_state_equal"]) for rec in recs):
        fail("MT-pod-zero: a round's client state is not the single-device "
             "round's over the shard tree bit for bit")
    got = [(s["loss"], s["g_norm"]) for s in recs[0]["steps"]]
    if any([(s["loss"], s["g_norm"]) for s in rec["steps"]] != got
           for rec in recs):
        fail("MT-pod-zero: the ranks disagree on loss or g_norm")
    want = (pads[0]["steps"][0]["loss"], pads[0]["steps"][0]["g_norm"])
    differ = [f"loss/g_norm {got[0]} vs {want}"] if got[0] != want else []
    differ += [f"rank {i} client state" for i, (a, b) in
               enumerate(zip(recs, pads)) if a["steps"][0]["client_digest"]
               != b["steps"][0]["client_digest"]]
    if differ:
        fail(f"MT-pod-zero (pod + zero on {MT_POD_ZERO_GEOM}) is not "
             f"MT-padded's first step bit for bit: {differ}")
    losses["MT-pod-zero"] = [g[0] for g in got]
    total = {}
    for rec in recs:
        st = rec["steps"]
        print(f"MT-pod-zero rank {rec['coord']}: {rec['params_local']} "
              f"parameters held; step_ms "
              f"{[round(s['step_ms'], 1) for s in st]} round_ms "
              f"{[round(s['round_ms'], 1) for s in st]} peak {rec['peak']} "
              f"launches {rec['launches']}", flush=True)
        total = _merged(total, rec["launches"])
    print(f"MT-pod-zero: pod clients with state sharding 'zero' on "
          f"{MT_POD_ZERO_GEOM}: loss/g_norm {got[0]}, each rank's client "
          f"state, bit for bit MT-padded's first step; client state bit for "
          f"bit the single-device round; every distinct K3-K6 call bit for "
          f"bit its plain version: {recs[0].get('plain')}", flush=True)
    return total


def mt_single(Session, spec_lib, mt_losses, device="cuda", smoke=False):
    """MT-single: MT-padded's spec (MT_PATH, tp_pad_heads 2, seed 0, 8 rows
    of 256 a client, its depth cut, as many steps) on one device, the smoke mesh with 2
    clients: no 'model' axis. Prints its losses beside MT-padded's, to
    tell a rise that the spec gives on one device from one the
    tensor-parallel pass would add; fails on a non-finite loss."""
    over = dict(MT_PATH, tp_pad_heads=2, mesh="smoke", clients=2)
    if smoke:
        over.update(smoke=True, seq_len=64, global_batch=4)
    sess = Session(load_spec(spec_lib, **over), device=device)
    if not smoke:
        sess.cfg = dataclasses.replace(sess.cfg, **MT_SMOLLM_CUT)
    t0 = time.time()
    steps = next(run[4] for run in MT_RUNS if run[0] == "MT-padded")
    losses = [float(sess.step_once()["loss"]) for _ in range(steps)]
    if not all(math.isfinite(x) for x in losses):
        fail(f"MT-single: non-finite loss {losses}")
    print(f"MT-single (one device, 2 clients, no 'model' axis): losses "
          f"{losses} in {time.time() - t0:.1f} s; MT-padded's on (data 2, "
          f"model 2): {mt_losses.get('MT-padded')}", flush=True)
    del sess
    gc.collect()
    return losses



def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "kernels", "csrc")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import spec as spec_lib
    from repro_torch.launch.session import Session
    from repro_torch.models import model as model_lib
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    with phase("build kernels"):
        t0 = time.time()
        lib = build.build()
        print(f"built {lib} in {time.time() - t0:.1f} s", flush=True)
        for line in build.build_log().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.strip(), flush=True)
        resources = kernel_resources(build, lib)
        redesigned = {n: r for n, r in resources.items()
                      if "flash_tc_kernel" in n or "staged_rows_kernel" in n
                      or "efk_flash::flash_attention_kernel" in n}
        B, S, H, KV, hd = FLASH_FULL
        for name, r in sorted(redesigned.items()):
            # the launch's dynamic shared memory and resident CTAs an SM
            if "UpdateEpilogue" in name and "kernel<true" in name:
                r["ctas_per_sm"], r["smem_bytes"] = ops.staged_occupancy(
                    BLOCK, "bfloat16" in name)
            print(f"resources {name}: {r}", flush=True)
        # the f32 K7 instantiation the prefill's shape launches
        geo = ops.flash_f32_geometry(hd, H // KV)
        f32_name = f"void efk_flash::flash_attention_kernel<{hd}, " \
                   f"{geo['rows']}>"
        if f32_name not in redesigned:
            fail(f"no {f32_name} in the build's report")
        redesigned[f32_name].update(geo)
        print(f"resources {f32_name} at the prefill's shape: "
              f"{redesigned[f32_name]}", flush=True)
        tc64 = [r for n, r in redesigned.items()
                if "flash_tc_kernel<64>" in n]
        if not tc64 or not tc64[0].get("hgmma"):
            fail("the bf16 flash-attention kernel at hd 64 has no HGMMA in "
                 "its SASS")
    results = {}
    with phase("kernels against their plain versions"):
        kernel_checks(ops, ref, results)
        gc.collect()
        torch.cuda.empty_cache()
        codec_checks(ops, ref, results)
        gc.collect()
        torch.cuda.empty_cache()
        flash_checks(ops, ref, results)
        gc.collect()
        torch.cuda.empty_cache()
        topk_checks(ops, ref, results)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("K1 path: ops.block_topk on the 8-client w_up stack"):
        k1 = topk_path(ops)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("cuda paths against the cpu paths (smoke size); card bit "
               "checks"):
        reference_check(Session, spec_lib, ops)
        card_bit_checks(spec_lib)
    gc.collect()
    torch.cuda.empty_cache()
    # each path's launches are derived from its EF config
    # (expected_launches): A runs K5 and K6 twice a leaf (quant8 up, the
    # sparse payload down), B K5 twice, K6 and K4 once, the fused path K3,
    # K6, K5 and K4 once, carrier fused K2 once
    with phase("main path A: quant8 up, quant4 down, block_topk, 3 steps"):
        path_a = main_path(Session, spec_lib, ops, 3, carrier="quant8",
                           downlink_carrier="quant4")
    with phase("main path B: quant8 up, quant4 down, identity, 2 steps"):
        main_path(Session, spec_lib, ops, 2, carrier="quant8",
                  downlink_carrier="quant4", compressor="identity",
                  compressor_kw={})
    with phase("fused path: fused_quant8 up, fused_quant4 down, 3 steps, "
               "then a profiled step"):
        up = main_path(Session, spec_lib, ops, 3, profile=True,
                       carrier="fused_quant8", downlink_carrier="fused_quant4")
    with phase("fused carrier, 2 steps, then serve the trained model"):
        fused = main_path(Session, spec_lib, ops, 2,
                          serve=lambda s: serve_trained(s, model_lib, ops),
                          carrier="fused", downlink_carrier="dense")
    with phase("resumable path: bf16 EF state, adamw, fused_quant8 up, "
               "fused_quant4 down; save, resume, step"):
        resumed = resume_path(Session, spec_lib, ops)
    by_phase = {}
    with phase("G: groups on the fused wire (norms dense, embed on bf16 "
               f"state), 8 clients, {GMSH_CUT}, 3 steps"):
        by_phase["G"] = main_path(Session, spec_lib, ops, 3, cut=GMSH_CUT,
                                  groups=G_GROUPS)
    with phase(f"M: mixed_schedule.json at full width, 4 clients, "
               f"{GMSH_CUT}, 3 steps"):
        by_phase["M"] = main_path(Session, spec_lib, ops, 3, cut=GMSH_CUT,
                                  spec_name="mixed_schedule", smoke=False)
    with phase("S: sampled participation 0.25 on carrier fused, 8 clients, "
               f"{GMSH_CUT}, 3 steps"):
        from repro_torch.core import participation as part_lib
        from repro_torch.launch import build as build_lib
        by_phase["S"] = main_path(
            Session, spec_lib, ops, 3, cut=GMSH_CUT,
            step_hook=frozen_check(part_lib, build_lib),
            participation={"mode": "sampled", "fraction": 0.25, "seed": 7})
    with phase("H: hierarchy_quant4_cross.json at full width, 8 clients, "
               f"2 pods, {GMSH_CUT}, 3 steps"):
        by_phase["H"] = main_path(Session, spec_lib, ops, 3, cut=GMSH_CUT,
                                  spec_name="hierarchy_quant4_cross",
                                  smoke=False)
    with phase(f"W: a Block-TopK block of {W_BLOCK} (k {W_K}), "
               "fused_quant8 up and fused_quant4 down, 8 clients, "
               f"{W_STEPS} steps; every K3-K6 call held to its plain "
               "version"):
        by_phase["W"] = main_path(Session, spec_lib, ops, W_STEPS,
                                  plain_check=True, **W_PATH)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("R and DR: block recompute on the full-width fused_quant8/"
               "fused_quant4 path, 8 clients: a step without and one with, "
               "bit for bit; the dry run of the step with, against it"):
        by_phase["R"] = recompute_phase(Session, spec_lib, ops)
    with phase("D smoke: the other dense configs, the frontends, MoE "
               "(both moe_impl) and the SSM families, cuda against cpu "
               "(smoke size, past the window and over several scan "
               "chunks)"):
        for arch, extra in D_SMOKE_RUNS:
            sizes = D_SMOKE_SCAN if arch in SCAN_ARCHS else D_SMOKE
            serve_smoke_check(Session, spec_lib, model_lib, ops,
                              label=" ".join([arch, *map(str, extra.values()),
                                              "smoke"]),
                              train_steps=2, arch=arch, **sizes, **R_PATH,
                              **extra)
    for name, arch, cut, clients, serve in D_CELLS:
        t0 = time.time()
        if clients is None:
            with phase(f"{name}: {arch} at full width cut to {cut}, serve "
                       f"only {serve}"):
                by_phase[name] = serve_phase(Session, spec_lib, model_lib,
                                             ops, name, arch, cut, serve)
        else:
            with phase(f"{name}: {arch} at full width cut to {cut}, "
                       f"{clients} clients, {D_STEPS} fused_quant8/"
                       f"fused_quant4 steps, then serve {serve}"):
                by_phase[name] = main_path(
                    Session, spec_lib, ops, D_STEPS, arch=arch,
                    clients=clients, cut=cut, plain_check=True,
                    step_hook=D_HOOKS.get(name),
                    serve=lambda s, name=name, shape=serve: serve_dense(
                        s, model_lib, ops, name, **shape), **R_PATH)
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    with phase("P: the paper's simulator on the card (fig1, exp1, async, "
               "exp3, exp4 at the experiments' shapes; card against cpu)"):
        by_phase.update(sim_phase(ops))
    with phase("P-rates: the paper's Tables 1-2 rate exponents "
               "(complexity_check at Ts 500/2000/8000, 66,000 rounds) on "
               "the card"):
        by_phase["P-rates"] = rates_phase(ops)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("serving, cuda against cpu (smoke size)"):
        serve_smoke_check(Session, spec_lib, model_lib, ops)
    with phase("serving full-width smollm-360m: batch 8, prompt 1024, "
               "32 decode steps; then one f32 prefill"):
        served, served_f32 = serve_full(Session, spec_lib, model_lib, ops)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("F: the wire stream and the serving fleet (3 published "
               "full-width fused_quant8/fused_quant4 steps, 2 replicas, 16 "
               "requests, a step mid-decode, 2 worker processes with one "
               "killed, tcp:// at smoke size)"):
        by_phase["F"] = fleet_phase(Session, spec_lib, ops, model_lib)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("MD1: an NCCL world of one; ef_round_sharded on full-width "
               "smollm-360m leaves, bit for bit the single-device round of "
               "one client"):
        by_phase["MD1"] = md1_phase(ops, spec_lib)
    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"MD4: {MD_RANKS} rank processes on the one card (gloo), "
               f"one client each, full-width smollm-360m cut to {MD_CUT}, "
               f"{MD_STEPS} steps "
               "a run: fused_quant8_overlap.json, quant8 with the ring and "
               "the blocking gather, multi_pod with hierarchy_quant4_cross"
               f".json's hops; MD4-publish ({MD_CUT}) and a single-device "
               "replica joined from its stream"):
        by_phase["MD4"] = md4_phase(Session, spec_lib, ops)
    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"MT: {MT_RANKS} rank processes on the one card (gloo), "
               "mesh (data 2, model 2), full width tensor-parallel, "
               f"fused_quant8/fused_quant4: smollm-360m ({MT_SMOLLM_CUT}) "
               "with tp_pad_heads 2 (attention split) for 2 steps, then 1 "
               "step unpadded "
               "(attention replicated); falcon-mamba-7b (1 layer) and "
               "zamba2-1.2b (6 layers and the shared block), 1 step each; "
               "MT-serve after the unpadded and SSM runs; granite, gemma2, "
               "olmoe, falcon-mamba, zamba2 at smoke size, card against CPU, "
               "training and serving"):
        by_phase["MT"], mt_losses, mt_served = mt_phase(ops)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("MT-single: MT-padded's spec on one device, 2 clients, 2 "
               "steps"):
        mt_single(Session, spec_lib, mt_losses)

    csrc = "src/repro_torch/kernels/csrc"
    rows = [
        ("block_topk", "block_topk", f"{csrc}/topk.cu",
         "src/repro/kernels/topk_compress.py:60", k1),
        ("ef21_sgdm_update", "ef21_sgdm_update", f"{csrc}/ef_update.cu",
         "src/repro/kernels/ef_update.py:55", fused),
        ("ef21_sgdm_topk_quant", "ef21_sgdm_topk_quant/8",
         f"{csrc}/fused_round.cu", "src/repro/kernels/fused_round.py:111", up),
        ("dequant_add", "dequant_add/4", f"{csrc}/fused_round.cu",
         "src/repro/kernels/fused_round.py:164", up),
        ("block_quantize", "block_quantize", f"{csrc}/codec.cu",
         "src/repro/kernels/quantize.py:92", path_a),
        ("block_dequantize", "block_dequantize", f"{csrc}/codec.cu",
         "src/repro/kernels/quantize.py:112", path_a),
        ("flash_attention", "flash_attention", f"{csrc}/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:83", served),
    ]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[name],
                    launches_by_phase={p: c.get(name, 0)
                                       for p, c in by_phase.items()},
                    **{k: results[key][k] for k in keys})
               for name, key, src, rep, counts in rows]
    kernels[0]["yardstick_topk_scatter_ms"] = \
        results["block_topk"]["yardstick_topk_scatter_ms"]
    kernels[0]["design"] = (
        "warp (or lane group) a row in registers, strided layout; the "
        "bisection stops early once the kept set is decided")
    kernels[1]["design"] = (
        "K3's staged row walk (staged.cuh) with its own epilogue: a warp "
        "walks rows; the next row's grad, v, g staged by cp.async.bulk + "
        "mbarrier during the bisection (g double-buffered, read back for "
        "g' = g + c); 16-byte runs of 4/8 consecutive values a lane for "
        "every load and for the v', c, g' stores; early-exit bisection; "
        "rows of another width or alignment keep the strided kernel")
    kernels[1]["resources"] = {n: r for n, r in redesigned.items()
                               if "UpdateEpilogue" in n}
    # K2 and K3 with bfloat16 EF state: K3 runs it on the resumable path
    kernels[1]["bf16_state"] = {k: results["ef21_sgdm_update/bf16"][k]
                                for k in keys}
    kernels[2]["bf16_state"] = {k: results["ef21_sgdm_topk_quant/8/bf16"][k]
                                for k in keys}
    kernels[2]["bf16_state"]["launches"] = resumed["ef21_sgdm_topk_quant"]
    kernels[2]["bits4"] = {k: results["ef21_sgdm_topk_quant/4"][k]
                           for k in keys}
    kernels[2]["bits4_bf16_state"] = {
        k: results["ef21_sgdm_topk_quant/4/bf16"][k] for k in keys}
    # rows of W_BLOCK on the wide route (csrc/wide.cuh): K3 on phase W's
    # path, K1 and K2 on none
    wide = f"wide_{W_BLOCK}"
    for i, name, variants in (
            (0, "block_topk", (("", ""),)),
            (1, "ef21_sgdm_update", (("", ""), ("_bf16_state", "/bf16"))),
            (2, "ef21_sgdm_topk_quant", (
                ("", "/8"), ("_bits4", "/4"), ("_bf16_state", "/8/bf16"),
                ("_bits4_bf16_state", "/4/bf16")))):
        for suffix, key in variants:
            row = results[f"{name}{key}/w{W_BLOCK}"]
            # phase W runs f32 state and 8-bit mantissas up
            kernels[i][wide + suffix] = dict(
                {k: row[k] for k in keys}, route="cuda",
                source=f"{csrc}/wide.cuh",
                launches=by_phase["W"][name] if key in ("", "/8") else 0)
    kernels[0][wide]["yardstick_topk_scatter_ms"] = \
        results[f"block_topk/w{W_BLOCK}"]["yardstick_topk_scatter_ms"]
    kernels[2]["design"] = (
        "the staged row walk shared with K2 (staged.cuh), quantizing "
        "epilogue: a warp walks rows; the next row's grad, v, g "
        "staged by cp.async.bulk + mbarrier during the bisection (g "
        "double-buffered, read back after it); 16-byte runs of 4/8 "
        "consecutive values a lane; early-exit bisection; full rows count "
        "with no presence test")
    kernels[2]["resources"] = {n: r for n, r in redesigned.items()
                               if "QuantEpilogue" in n}
    kernels[4]["design"] = (
        "by shape and alignment: vector (width a multiple of 4 up to 1024 "
        "from a 16-byte boundary: a lane group a row, 16-byte loads kept in "
        "registers, packed 4- or 2-byte stores, a grid-stride walk with the "
        "next row's loads in flight), scalar (other widths up to 1024: a "
        "lane group a row, values in registers), wide (one CTA a row)")
    kernels[5]["design"] = (
        "by shape and alignment: vector (a lane group a row, 4- or 2-byte "
        "mantissa loads, float4 stores), scalar (a lane group a row), wide "
        "(one CTA a row)")
    kernels[6]["design"] = (
        "bf16 on the tensor cores (wgmma m64n64k16 for "
        "Q.K^T, m64n{hd}k16 for P.V with P from registers), one CTA a "
        "query tile for the query heads of a kv head (a consumer "
        "warpgroup each, one TMA producer warp, 4-stage K/V ring; the "
        "next tile's softmax runs during P.V)")
    kernels[6]["f32_route"] = {k: results["flash_attention/f32"][k]
                               for k in keys}
    kernels[6]["f32_route"]["launches"] = served_f32["flash_attention"]
    kernels[6]["f32_route"]["design"] = (
        "f32 on the CUDA cores, P in f32: one CTA a 64-query tile for the "
        "query heads of a kv head (up to 3), K/V by 16-byte cp.async into "
        "a 2-stage ring (one barrier a tile); at hd 64 with 3 heads 12 "
        "rows x 8 keys a thread for Q.K^T and 12 rows x 8 dims for P.V "
        "(128 threads, two CTAs an SM), else 8 x 8; swizzled row-major Q "
        "and K; P kept in registers and passed by shuffle, V as float4; m "
        "and l of a row in one lane")
    kernels[6]["resources"] = {n: r for n, r in redesigned.items()
                               if "flash_tc_kernel" in n}
    # each D phase's prefill: granite-34b's 48 query heads on one kv
    # head (hd 128), musicgen's 1088 positions (a prefix of 64), olmoe's
    # 16 heads of 128, internvl2's 64 query heads on 8 (a prefix of 256)
    for key, shape, name in FLASH_D:
        kernels[6][key.split("/")[1] + "_prefill"] = dict(
            shape=list(shape), launches=by_phase[name]["flash_attention"],
            **{k: results[key][k] for k in keys})
    # MT-serve's prefills on (data 2, model 2), summed over the 4 ranks
    for key, shape, name in FLASH_MT:
        kernels[6][key.split("/")[1] + "_prefill"] = dict(
            shape=list(shape),
            launches=mt_served[name].get("flash_attention", 0),
            **{k: results[key][k] for k in keys})
    kernels[6]["f32_route"]["resources"] = {
        n: r for n, r in redesigned.items()
        if "efk_flash::flash_attention_kernel" in n}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
