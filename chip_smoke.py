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
     steps, then one more step timed and one under torch.profiler (device
     busy ms, idle share, the five ops with the most device time); and
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
  7. serving, card against CPU at smoke size (f32 activations): the greedy
     tokens must be equal and the prefill logits agree within rtol 1e-4;
  8. serving full-width smollm-360m from fresh weights: batch 8, prompt
     1024, 32 decode steps, nothing cut, twice (the second reading is free
     of warm-up); K7 must launch exactly 32 times in the prefill (once a
     layer) and never in decode; then torch.profiler reads one more
     prefill and two decode steps on the tree serve() ran (its matrices
     cast to bf16 once for the params version): device busy time, the
     decode's idle share, device time by op and of aten::copy_. Then one
     f32 prefill of the same fresh weights and prompts
     (Session(spec, dtype="float32")): K7's f32 route must launch exactly
     32 times and the logits must be finite; torch.profiler reads one more
     such prefill: device busy ms and K7's kernel row.
Phase 2 also holds K7 flash_attention against its plain version within
2e-5 (f32) and 2e-2 (bf16) at the smoke shape, the full-width prefill's
shape (B 8, S 1024, H 15, KV 5, hd 64) in bf16 and f32, a ragged S of 1000,
hd 128 and hd 32; the bf16 (tensor-core) route also within a stated
elementwise bound of the plain version that rounds P as it does
(round_p=True); and times both routes at the full-width shape beside the
library's scaled_dot_product_attention in the same dtype (a yardstick,
never the path), the two in turns over three rounds, medians kept.
Each training or serving path resets the launch counts just before it,
checks that every kernel launched exactly as often as the path's code
calls it (and the others not at all; a training path's counts are derived
from its EF config by ``expected_launches``: per group of a schedule, per
leaf its plans, per pod its cross hop), that losses, parameters and logits
are finite, and prints its times, peak memory and step breakdown. Then the
script prints a ``kernels`` JSON line (each kernel's launches on the main
path and, under ``launches_by_phase``, on phases G, M, S and H), the card
line, and the final ``{"ok": true, ...}`` line. Imports nothing of JAX or
of src/repro.
"""
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

# as the training CLI (repro_torch/launch/train.py) sets it: the training
# paths' peak is some 67 GB, where fixed segments make the caching
# allocator free its cache and retry (a synchronize each)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

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
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the resumable path: bf16 EF state and AdamW on the fused quantized wire
RESUME_PATH = dict(carrier="fused_quant8", downlink_carrier="fused_quant4",
                   ef_state_dtype="bfloat16", optimizer="adamw", lr=1e-3)
# phase G: the norms dense, the embedding and the matrices on the fused
# wire, the embedding's EF state in bf16 beside the others' f32
G_GROUPS = [{"pattern": "norm|bias", "carrier": "dense"},
            {"pattern": "embed", "carrier": "fused_quant8",
             "downlink_carrier": "fused_quant4",
             "ef_state_dtype": "bfloat16"},
            {"pattern": "*", "carrier": "fused_quant8",
             "downlink_carrier": "fused_quant4"}]
CKPT_FREE_BYTES = 40e9         # a full-width checkpoint is about 30 GB


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
        if shape == FLASH_FULL:
            err[dtype] = e
        del q, k, v, got, want

    B, S, H, KV, hd = FLASH_FULL
    n_ops = 4 * B * H * hd * S * (S + 1) / 2                  # causal
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype, peak, key in ((torch.bfloat16, BF16_TC_OPS_S, "flash_attention"),
                             (torch.float32, F32_OPS_S, "flash_attention/f32")):
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
            "max_abs_err": err[dtype], "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ms": sorted(turns["ms"])[1],
            "plain_ms": time_ms(lambda: ref.flash_attention_plain(
                q, k, v, round_p=round_p), 3),
            "library_ms": sorted(turns["library_ms"])[1]}
        r = results[key]
        print(f"kernel flash_attention [{FLASH_FULL} {dtype}, causal, "
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


def first_token_check(model_lib, cfg, params, tokens, out, label) -> None:
    """The served first tokens are the argmax of a prefill's logits under
    ``params``, and the logits are finite."""
    B, S = tokens.shape
    cache = model_lib.init_cache(cfg, B, S, device="cuda")
    logits, _ = model_lib.prefill(cfg, params, {"tokens": tokens}, cache)
    if not bool(torch.isfinite(logits).all()):
        fail(f"{label}: non-finite prefill logits")
    first = logits[:, -1].argmax(-1).cpu().numpy()
    if (first != out["tokens"][:, 0]).any():
        fail(f"{label}: first tokens {out['tokens'][:, 0]} are not the "
             f"argmax {first} of the prefill under these params")


def serve_smoke_check(Session, spec_lib, model_lib, ops):
    """Phase 7: serving on the card against the CPU at smoke size, f32."""
    spec = load_spec(spec_lib, smoke=True)
    outs, logits, tokens = {}, {}, None
    for device in ("cuda", "cpu"):
        sess = Session(spec, device=device, dtype="float32")
        if tokens is None:
            tokens = torch.randint(0, sess.cfg.vocab_size, (2, 64),
                                   generator=torch.Generator().manual_seed(0))
        ops.reset_launches()
        outs[device] = sess.serve(tokens=tokens, decode_steps=8)
        if device == "cuda":
            check_serve_launches(ops, dict(ops.launches), "the smoke serve",
                                 sess.cfg.num_layers)
        cache = model_lib.init_cache(sess.cfg, 2, 64, device=device)
        logits[device] = model_lib.prefill(
            sess.cfg, sess.serve_source(), {"tokens": tokens.to(device)},
            cache)[0].cpu()
    a, b = outs["cuda"]["tokens"], outs["cpu"]["tokens"]
    print(f"smoke serve tokens: cuda {a.tolist()} cpu {b.tolist()}",
          flush=True)
    if a.shape != (2, 9) or (a != b).any():
        fail("smoke serve: the card's greedy tokens differ from the CPU's")
    # rtol 1e-4, and atol 1e-4 of the largest logit for the ones near zero
    diff = (logits["cuda"] - logits["cpu"]).abs()
    lim = 1e-4 * (logits["cpu"].abs() + logits["cpu"].abs().max())
    print(f"smoke serve prefill logits: max abs diff {float(diff.max())}",
          flush=True)
    if not bool(torch.isfinite(logits["cuda"]).all()) or \
            bool((diff > lim).any()):
        fail("smoke serve: prefill logits on the card differ from the CPU's "
             "beyond rtol 1e-4")


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
                             sess.cfg.num_layers)
        check_serve_launches(ops, launches, "the full-width serve (prefill "
                             "and decode)", sess.cfg.num_layers)
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
    a layer), finite logits; then torch.profiler around one more prefill
    reads the device busy ms and K7's kernel row. Returns the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
                         cfg.num_layers)
    if logits.dtype != torch.float32 or \
            tuple(logits.shape) != (B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"full-width f32 prefill: logits {logits.dtype} "
             f"{tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
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
    if count != cfg.num_layers:
        fail(f"the f32 prefill's trace holds {count} K7 kernel rows, "
             f"expected {cfg.num_layers}")
    del sess, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def device_ms(prof):
    """(device busy ms, {op: ms of the kernels it launched}) of a
    torch.profiler run. Busy time sums the kernel rows only: an aten op's
    row repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType
    busy, by_op = 0.0, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            busy += e.device_time_total / 1e3
        # K7's kernels (flash_attention_kernel, flash_tc_kernel) and the ops
        if "flash_" in e.key or e.device_type != DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            if t > 0:
                by_op[e.key] = t / 1e3
    return busy, by_op


def serve_profile(model_lib, cfg, params, tokens, decode_s_per_step) -> None:
    """Where serving's time goes, from torch.profiler (CPU and CUDA
    activity) around one full-width prefill and 2 decode steps: the
    device's busy time, K7's share of the prefill, the casts' (aten::copy_)
    device time, and the decode step's device time against its unprofiled
    wall time (the idle share)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    B, S = tokens.shape
    cache = model_lib.init_cache(cfg, B, S + 2, device="cuda")
    with profile(activities=acts) as prof:
        logits, cache = model_lib.prefill(cfg, params, {"tokens": tokens},
                                          cache)
        torch.cuda.synchronize()
    busy, by_op = device_ms(prof)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile prefill: device busy ms {busy:.3f}; by op "
          f"{[(k[:40], round(t, 3)) for k, t in top]}; aten::copy_ "
          f"{by_op.get('aten::copy_', 0.0):.3f}", flush=True)
    tok = logits[:, -1].argmax(-1)[:, None]
    with profile(activities=acts) as prof:
        for i in range(2):
            logits, cache = model_lib.decode_step(cfg, params, cache, tok,
                                                  S + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
    busy, by_op = device_ms(prof)
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
                         sess.cfg.num_layers)
    first_token_check(model_lib, sess.cfg, sess.params, tokens.cuda(), out,
                      "trained-model serve")
    print(f"served the trained model (step {sess.step}): tokens "
          f"{out['tokens'].tolist()}", flush=True)


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


def expected_launches(efc, tree):
    """The kernel launches of one training step, derived from the EF config:
    per group of the schedule's resolution (or the whole tree without one),
    each leaf's uplink plan, its downlink and, under a non-trivial cross
    hop, each pod's cross hop. {kernel: launches a step}."""
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
        elif plan == "dense":
            up = _compressor_launches(comp_lib, method.compressor)
        add(up, len(keys))
        if down is not None:
            add(_codec_down(carrier_lib, comp_lib, carrier_lib.make(down),
                            down_comp), len(keys))
        if cross is not None and pods:
            add(_codec_down(carrier_lib, comp_lib,
                            carrier_lib.make(cross[0]), cross[1]),
                len(keys) * pods)
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
        for key in ("loss", "g_norm"):
            a = [r[key] for r in runs["cuda"]]
            b = [r[key] for r in runs["cpu"]]
            print(f"smoke {label} {key}: cuda {a} cpu {b}", flush=True)
            if not all(math.isfinite(x) for x in a) or any(
                    abs(x - y) > 1e-3 * abs(y) for x, y in zip(a, b)):
                fail(f"smoke {label} {key} on cuda {a} != cpu {b} "
                     "(rtol 1e-3)")


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
              spec_name="fused_quickstart", step_hook=None, **overrides):
    """Phases 4-6 and 6c: full-width smollm-360m through the port's Session.
    Every kernel must launch exactly as often as ``expected_launches``
    derives from the path's EF config, and no other. ``profile`` adds a
    torch.profiler reading of one more step; ``serve(sess)``, when given,
    runs on the trained session at the end; ``step_hook(sess)``, when
    given, runs before each step and returns a check run after it."""
    from repro_torch.launch import build as build_lib
    spec = load_spec(spec_lib, spec_name, **overrides)
    label = (f"{spec_name} " if spec_name != "fused_quickstart" else "") + \
        f"{spec.carrier}/{spec.downlink_carrier} {spec.compressor}" + \
        (" grouped" if spec.groups else "")
    sess = Session(spec, device="cuda")
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
    for _ in range(steps):
        after = step_hook(sess) if step_hook is not None else None
        t0 = time.time()
        m = sess.step_once()
        loss, g_norm = float(m["loss"]), float(m["g_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        print(f"step {sess.step - 1} loss {loss:.6f} g_norm {g_norm:.6e} "
              f"step_ms {step_ms[-1]:.1f}", flush=True)
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
        serve(sess)
    del sess, m
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
    _, grads = dist.per_client_value_and_grad(
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
    activity) around the next one: the device's busy ms against the
    unprofiled wall ms (the idle share) and the five ops with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    sess.step_once()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.step_once()
        torch.cuda.synchronize()
    busy, by_op = device_ms(prof)
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
    with phase("serving, cuda against cpu (smoke size)"):
        serve_smoke_check(Session, spec_lib, model_lib, ops)
    with phase("serving full-width smollm-360m: batch 8, prompt 1024, "
               "32 decode steps; then one f32 prefill"):
        served, served_f32 = serve_full(Session, spec_lib, model_lib, ops)

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
                    launches_by_phase={p: c[name]
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
