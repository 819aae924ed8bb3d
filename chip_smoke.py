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
     kernel rows;
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
  6b. the resumable path: full-width smollm-360m, 8 clients, bf16 EF state,
     AdamW at lr 1e-3, fused_quant8 up and fused_quant4 down; 2 steps, a
     save (about 30 GB on disk, in a temporary directory that is deleted at
     the end), per-leaf checksums of params, opt_state and ef_state, step
     3; then a new Session from Session.resume, whose checksums must equal
     the saved ones exactly and whose step 3 must match within rtol 1e-3;
     prints step ms, peak bytes, the EF state's bytes (exactly half of
     f32's), the checkpoint's bytes and the save and restore seconds;
  6c. the grouped, sampled and two-tier rounds at full width (32 layers,
     d_model 960, weights from seed 0), 3 steps each, each printing what it
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
     quant4 cross hop);
  6d. phase R, block recompute: full-width smollm-360m, 8 clients,
     fused_quant8 up and fused_quant4 down, one step with ``cfg.remat``
     off and one with it on, each from seed 0 (the batch-0 gradients under
     its own setting): params and every EF state leaf equal bit for bit,
     the peak lower with recompute; each run's step ms and peak, and the
     client pass alone (median of 3) with its ms and peak;
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
     Session's config replaced before the first step), 3 steps of
     fused_quant8/fused_quant4 and a serve of the trained model:
     D-danube 2 layers, 8 clients, serve batch 2, prompt 6144 (past the
     4096 window: the banded prefill and the ring cache wrap), 32 decode
     steps; D-granite 1 layer, 4 clients, serve batch 8, prompt 1024, 32
     decode steps (K7 in the prefill: 48 query heads on 1 kv head, hd
     128); D-gemma2 2 layers (one [local, global] super-layer), 2
     clients, serve batch 2, prompt 6144, 32 decode steps; D-musicgen 12
     layers, 8 clients, a training prefix of 8 zero rows (frontend_proj's
     params and EF state bit-unchanged after every step: its gradient is
     exactly zero), serve batch 8, prompt 1024 after a prefix of 64 (K7
     12 times a prefill); D-olmoe 1 layer of 64 experts (top 8), 8
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
     seeds; Figure 1's inequalities must hold), P-exp1 (logistic
     regression at MNIST's shape, EF21-SGDM with BlockTopK(1024, 1) on
     carriers fused and quant4 at B 1 and 128, 500 steps), P-async
     (run_async on P-exp1's problem, heavy-tailed arrivals, 20 rounds: the
     events equal a CPU run's and beat the barrier), P-exp3 (Algorithm 2's
     quadratics at n 100, d 1000, EF14 and EF21-SGDM, TopK 50, 1000 steps),
     P-exp4 (the MLP at CIFAR-10's width and d 10,510,346 on fused_quant8
     up and fused_quant4 down, B 32, 200 steps), and the simulator free of
     randomness on card and CPU (fused, fused_quant8/fused_quant4, quant4;
     50 steps within rtol 1e-3);
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
     full-width smollm-360m on fused_quant8 up and fused_quant4 down, 8
     clients, publishes into a temporary stream directory (a bootstrap at
     step 0, about 27.5 GB, deleted at the end; it needs 40 GB free), then
     3 steps, each published (re-encoded, verified bit for bit against the
     step's own h, written as npz; publish ms, of it the npz write, the
     record's bytes against a dense f32 push); two in-process replicas
     (launch/fleet.py ServeReplica, lags 0 and 1) join from the bootstrap
     and after every sync equal the trainer's post-step params at their
     step (torch.equal, all 11 leaves; apply ms); Fleet.run serves 16
     requests of 1024 tokens, 32 new, decode budget 256, batches of 8
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
     kernels built once here), full-width smollm-360m, 3 steps a run:
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
     must each read above MD_TOL on every rank.
Phase 2 also holds K7 flash_attention against its plain version within
2e-5 (f32) and 2e-2 (bf16) at the smoke shape, the full-width prefill's
shape (B 8, S 1024, H 15, KV 5, hd 64) in bf16 and f32, each D phase's
prefill in bf16 (granite-34b's B 8, S 1024, H 48, KV 1, hd 128;
musicgen-medium's 8, 1088, 24, 24, 64; olmoe-1b-7b's 8, 1024, 16, 16,
128; internvl2-76b's 8, 1280, 64, 8, 128; zamba2-1.2b's shared block's 8,
1024, 32, 32, 64), a ragged S of 1000, hd 128
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
path and, under ``launches_by_phase``, on phases G, M, S, H, R, the D
phases, each cell of P, F, MD1 and MD4 (summed over ranks)), the card
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
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the resumable path: bf16 EF state and AdamW on the fused quantized wire
RESUME_PATH = dict(carrier="fused_quant8", downlink_carrier="fused_quant4",
                   ef_state_dtype="bfloat16", optimizer="adamw", lr=1e-3)
# phases R and D: the fused quantized wire, fused_quant8 up and
# fused_quant4 down, on fused_quickstart.json
R_PATH = dict(carrier="fused_quant8", downlink_carrier="fused_quant4")
D_STEPS = 3
D_CELLS = [  # (phase, arch, depth cut, clients or None: serve only, serve)
    ("D-danube", "h2o-danube-3-4b", {"num_layers": 2}, 8,
     dict(batch=2, prompt_len=6144, decode_steps=32)),
    ("D-granite", "granite-34b", {"num_layers": 1}, 4,
     dict(batch=8, prompt_len=1024, decode_steps=32)),
    ("D-gemma2", "gemma2-9b", {"num_layers": 2}, 2,
     dict(batch=2, prompt_len=6144, decode_steps=32)),
    ("D-musicgen", "musicgen-medium", {"num_layers": 12}, 8,
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
# phase P: the paper's simulator at the experiments' published shapes
P_FIG1 = dict(gamma=1e-3, steps=8000, seeds=2, ns=(1, 8))
P_EXP1 = dict(n=10, m_per_client=6000, l=784, c=10)       # MNIST's shape
P_EXP1_STEPS = 500
P_EXP3 = dict(n=100, d=1000)                              # Algorithm 2's
P_EXP3_STEPS = 1000
P_EXP4 = dict(n=5, m_per_client=10000, in_dim=3072, hidden=2048, c=10)
P_EXP4_STEPS = 200
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
                         *((shape, torch.bfloat16) for _, shape, _ in FLASH_D),
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
        if shape == FLASH_FULL or shape in [f for _, f, _ in FLASH_D]:
            err[shape, dtype] = e
        del q, k, v, got, want

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape, dtype, peak, key in (
            (FLASH_FULL, torch.bfloat16, BF16_TC_OPS_S, "flash_attention"),
            (FLASH_FULL, torch.float32, F32_OPS_S, "flash_attention/f32"),
            *((shape, torch.bfloat16, BF16_TC_OPS_S, key)
              for key, shape, _ in FLASH_D)):
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
        return _resume_path(Session, spec_lib, ops, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _resume_path(Session, spec_lib, ops, ckpt_dir):
    from repro_torch.launch import build as build_lib
    spec = load_spec(spec_lib, ckpt_dir=ckpt_dir, **RESUME_PATH)
    label = "resumable bf16/adamw fused_quant8/fused_quant4"
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
        for seed in range(P_FIG1["seeds"]):
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


# ---------------------------------------------------------------------------
# phase F: the wire stream and the serving fleet (core/stream.py,
# launch/transport.py, launch/fleet.py, launch/replica_worker.py)
# ---------------------------------------------------------------------------

F_PATH = dict(carrier="fused_quant8", downlink_carrier="fused_quant4")
F_STEPS = 3                    # published steps before the serve
F_SERVE = dict(n=16, prompt_len=1024, max_new_tokens=32)
F_BUDGET, F_BATCH = 256, 8     # decode budget, max batch (8 x 32 = 256)
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


def _timed(obj, name, sink):
    """Wrap ``obj.name`` to append its ms (ending in a synchronize) to
    ``sink``."""
    real = getattr(obj, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = real(*a, **kw)
        torch.cuda.synchronize()
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
    spec = load_spec(spec_lib, **F_PATH)
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

    # 3. serve: 16 requests of 1024 tokens, 32 new, batches of 8
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
MD_STEPS = 3
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
]
# MD4's planted faults, runs that its check against the single-process run
# must fail (a reading above MD_TOL on every rank): (label, spec, overrides,
# fault). "local": the round's collectives keep this rank's client alone
# (an all-reduce returns n times its operand, a gather n copies of it, a
# ring hop its own chunk); "frozen": the parameters are put back after
# every step, as if no round reached them.
MD4_FAULTS = [
    ("MD4-fault-local-fused", "fused_quant8_overlap", {}, "local"),
    ("MD4-fault-local-quant8", "fused_quant8_overlap",
     dict(carrier="quant8", overlap=False), "local"),
    ("MD4-fault-frozen", "fused_quant8_overlap",
     dict(carrier="quant8", overlap=False), "frozen"),
]


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
            efc = build_lib.ef_config(spec)
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


def md4_run(ops, ref, label, spec_name, overrides, device="cuda",
            plain=True, fault=None):
    """One MD4 run on this rank: a Session of one client a rank, MD_STEPS
    steps; per step the loss, g_norm, the replicated state's digest, the
    step and EF-round times, the collectives' share and bytes; the
    launches against ``expected_launches``; then (``plain``) each distinct
    K3-K6 call of the steps held bit for bit against its plain version.
    ``fault``: one of MD4_FAULTS's planted faults, on for the whole run."""
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
    intra = sess.mesh.client_axes()
    if efc.effective_hops is not None and not _trivial(efc):
        intra = tuple(a for a in intra if a != "pod")
    gathered = sess.mesh.axes(intra).size
    per_step = expected_launches(efc, sess.params, gathered=gathered)
    rec = {"mesh": dict(sess.mesh.shape), "n": sess.n_clients,
           "params": n_params, "init_s": init_s, "steps": []}
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
            for _ in range(MD_STEPS):
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
                    digest=sh.replicated_digest(sess.params,
                                                sess.ef_state)))
    finally:
        dist_lib.ef_round_sharded = orig
        comm.TIMED = False
    rec["launches"] = {k: v for k, v in ops.launches.items() if v}
    rec["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
    rec["expected"] = {k: v * MD_STEPS for k, v in per_step.items() if v}
    if cuda:
        check_launches(rec["launches"], per_step, MD_STEPS, label)
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


def md4_rank(rank, runs, device="cuda", faults=()):
    """One of MD4's rank processes (``multiproc.spawn``, gloo, the card
    shared): the kernels' library from the parent's build (no nvcc here),
    the gloo probe, then each run, then each planted fault's run. Every
    rank's calls have the same shapes, so rank 0 holds them against the
    plain versions."""
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
    for label, spec_name, overrides, fault in faults:
        out["faults"][label] = md4_run(ops, ref, label, spec_name, overrides,
                                       device, plain=False, fault=fault)
    return out


def _single_key(name, overrides):
    """The single-process run a run compares against (``overlap`` does
    not change it)."""
    return (name, json.dumps({k: v for k, v in overrides.items()
                              if k != "overlap"}, sort_keys=True))


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
    smoke mesh with MD_RANKS emulated clients (the vmap round); a step's
    (loss, g_norm, ‖params − initial params‖)."""
    over = {k: v for k, v in overrides.items() if k != "overlap"}
    spec = load_spec(spec_lib, spec_name,
                     **dict(over, mesh="smoke", clients=MD_RANKS))
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
              faults=MD4_FAULTS):
    """MD4: MD_RANKS rank processes on the one card (gloo on the card's
    tensors, the ring's send/recv staged through pinned host memory), each
    one client, the runs of MD4_RUNS at full width: every rank's loss,
    g_norm and replicated-state digest equal after every step, the ring's
    run bit for bit the blocking gather's, each run within MD_TOL of the
    single-process vmap run; then each of ``faults`` (MD4_FAULTS) must read
    above MD_TOL on every rank, or the check could not tell it from a sound
    run. Returns the launches of ``runs`` summed over ranks. (``runs``,
    ``faults`` and ``device``: the CPU tests' smoke-size run.)"""
    from repro_torch.launch import multiproc
    singles = {}
    for label, name, overrides in list(runs) + [f[:3] for f in faults]:
        key = _single_key(name, overrides)
        if key not in singles:
            t0 = time.time()
            singles[key] = md4_single(Session, spec_lib, name, overrides,
                                      device)
            print(f"{label}: single-process run (smoke mesh, {MD_RANKS} "
                  f"clients) {singles[key]} in {time.time() - t0:.1f} s",
                  flush=True)
    work = tempfile.mkdtemp(prefix="md4_")
    t0 = time.time()
    try:
        ranks = multiproc.spawn(md4_rank, MD_RANKS, work,
                                args=(runs, device, faults), threads=2,
                                timeout_s=900)
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
            total = _merged(total, rec["launches"])
        print(f"{label}: loss/g_norm/params moved "
              f"{[(a, b, c) for a, b, c, _ in traj[0]]} on "
              f"every rank, replicated state equal on every rank every "
              f"step; largest relative difference from the single-process "
              f"run {worst[label]:.3e} (tolerance {MD_TOL}); every distinct "
              f"K3-K6 call bit for bit its plain version: "
              f"{recs[0].get('plain')}", flush=True)
    ring = [[(s["loss"], s["g_norm"], s["digest"]) for s in r["runs"][
        "MD4-quant8-ring"]["steps"]] for r in ranks]
    blocking = [[(s["loss"], s["g_norm"], s["digest"]) for s in r["runs"][
        "MD4-quant8-blocking"]["steps"]] for r in ranks]
    if ring != blocking:
        fail(f"MD4: the ring's run {ring[0]} is not the blocking gather's "
             f"{blocking[0]} bit for bit")
    print("MD4: the overlap ring bit for bit the blocking gather (loss, "
          "g_norm and the replicated state's digest, every step, every "
          f"rank); worst relative difference a run {worst}", flush=True)
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
               "state), 8 clients, 3 steps"):
        by_phase["G"] = main_path(Session, spec_lib, ops, 3,
                                  groups=G_GROUPS)
    with phase("M: mixed_schedule.json at full width, 4 clients, 3 steps"):
        by_phase["M"] = main_path(Session, spec_lib, ops, 3,
                                  spec_name="mixed_schedule", smoke=False)
    with phase("S: sampled participation 0.25 on carrier fused, 8 clients, "
               "3 steps"):
        from repro_torch.core import participation as part_lib
        from repro_torch.launch import build as build_lib
        by_phase["S"] = main_path(
            Session, spec_lib, ops, 3,
            step_hook=frozen_check(part_lib, build_lib),
            participation={"mode": "sampled", "fraction": 0.25, "seed": 7})
    with phase("H: hierarchy_quant4_cross.json at full width, 8 clients, "
               "2 pods, 3 steps"):
        by_phase["H"] = main_path(Session, spec_lib, ops, 3,
                                  spec_name="hierarchy_quant4_cross",
                                  smoke=False)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("R: block recompute on the full-width fused_quant8/"
               "fused_quant4 path, 8 clients: a step without and one with, "
               "bit for bit"):
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
               f"one client each, full-width smollm-360m, {MD_STEPS} steps "
               "a run: fused_quant8_overlap.json, quant8 with the ring and "
               "the blocking gather, multi_pod with hierarchy_quant4_cross"
               ".json's hops"):
        by_phase["MD4"] = md4_phase(Session, spec_lib, ops)

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
