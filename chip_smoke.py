#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA
H100: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:
  1. print the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc with nvcc and print the build time;
  2. hold each kernel (K2 ef21_sgdm_update, K3 ef21_sgdm_topk_quant at 8 and
     4 bits, K4 dequant_add) against its plain PyTorch version at the shape
     the main path gives it — the layers/mlp/w_up leaf, 8 clients folded
     into rows of 1024 — exactly, and time kernel, plain version and bound;
  3. check the path against a reference on a small input: a smoke-size
     Session on the card and on the CPU (the CPU runs the plain versions,
     which the CPU tests hold against the JAX package) agree for 2 steps;
  4. the main path: full-width smollm-360m, 8 clients, EF21-SGDM with
     Block-TopK, carrier fused_quant8 up and fused_quant4 down, 3 training
     steps; losses finite, K3 and K4 launched once per leaf per step;
  5. the same Session with carrier fused for 2 steps; K2 launched once per
     leaf per step;
then print a ``kernels`` JSON line, the card line, and the final
``{"ok": true, ...}`` line. Imports nothing of JAX or of src/repro.
"""
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
SPEC = os.path.join(ROOT, "results", "specs", "fused_quickstart.json")
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (published)
F32_OPS_S = 67e12              # H100 SXM f32 outside the tensor cores
CLIENTS, BLOCK = 8, 1024
W_UP = (32, 960, 2560)         # layers/mlp/w_up of full-width smollm-360m


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
    del grad, v, g

    # K4 at the downlink's shape: one copy of the leaf, rows of 1024
    rows1 = d // BLOCK
    base = torch.randn(d, generator=gen, device="cuda")
    scales = torch.rand(rows1, generator=gen, device="cuda") * 1e-3
    scales[3] = 0.0
    for bits in (8, 4):
        hi = 256 if bits == 4 else 128
        q = torch.randint(0 if bits == 4 else -127, hi,
                          (rows1, BLOCK if bits == 8 else BLOCK // 2),
                          generator=gen, device="cuda").to(
            torch.uint8 if bits == 4 else torch.int8)
        err = 0.0
        for alpha in (1.0, -0.5):
            got = ops.dequant_add(q, scales, base, block=BLOCK, bits=bits,
                                  alpha=alpha)
            want = ref.dequant_add_plain(q, scales, base, block=BLOCK,
                                         bits=bits, alpha=alpha)
            check_equal(f"dequant_add bits={bits} alpha={alpha}", [got], [want])
            err = max(err, max_abs_err([got], [want]))
        b_ms, b_by = bound(d * (8 + bits / 8) + rows1 * 4, d * 3)
        lib = None
        if bits == 8:          # one PyTorch call computes base + q*scale
            b2 = base.view(rows1, BLOCK)
            lib = time_ms(lambda: torch.addcmul(b2, q, scales[:, None]), 10)
        results[f"dequant_add/{bits}"] = {
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: ops.dequant_add(q, scales, base, block=BLOCK,
                                                  bits=bits), 10),
            "plain_ms": time_ms(lambda: ref.dequant_add_plain(
                q, scales, base, block=BLOCK, bits=bits), 3),
            "library_ms": lib}
    for name, r in results.items():
        print(f"kernel {name}: ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) library_ms "
              f"{r['library_ms']} max_abs_err {r['max_abs_err']}", flush=True)


def load_spec(spec_lib, **overrides):
    with open(SPEC) as f:
        return spec_lib.RunSpec.from_dict(dict(json.load(f), **overrides))


def reference_check(Session, spec_lib):
    """Phase 3: the CUDA path against the CPU path on a small input."""
    spec = load_spec(spec_lib, smoke=True, seq_len=64, carrier="fused_quant8",
                     downlink_carrier="fused_quant4")
    runs = {}
    for device in ("cuda", "cpu"):
        sess = Session(spec, device=device, dtype="float32")
        runs[device] = sess.train(2, log_every=1)
    for key in ("loss", "g_norm"):
        a = [r[key] for r in runs["cuda"]]
        b = [r[key] for r in runs["cpu"]]
        print(f"smoke {key}: cuda {a} cpu {b}", flush=True)
        if not all(math.isfinite(x) for x in a) or any(
                abs(x - y) > 1e-3 * abs(y) for x, y in zip(a, b)):
            fail(f"smoke {key} on cuda {a} != cpu {b} (rtol 1e-3)")


def main_path(Session, spec_lib, ops, carrier, downlink, steps, counted):
    """Phases 4-5: full-width smollm-360m through the port's Session."""
    spec = load_spec(spec_lib, carrier=carrier, downlink_carrier=downlink)
    sess = Session(spec, device="cuda")
    t0 = time.time()
    n_leaves = len(sess.params)                     # builds the train state
    torch.cuda.synchronize()
    print(f"{carrier}/{downlink}: {n_leaves} leaves, "
          f"{sum(p.numel() for p in sess.params.values())} parameters, "
          f"state built in {time.time() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    step_ms = []
    for _ in range(steps):
        t0 = time.time()
        m = sess.step_once()
        loss, g_norm = float(m["loss"]), float(m["g_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        print(f"step {sess.step - 1} loss {loss:.6f} g_norm {g_norm:.6e} "
              f"step_ms {step_ms[-1]:.1f}", flush=True)
        if not (math.isfinite(loss) and math.isfinite(g_norm)):
            fail(f"non-finite loss/g_norm at step {sess.step - 1}")
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"{carrier}/{downlink}: step_ms {step_ms} max_memory_allocated "
          f"{peak} launches {launches}", flush=True)
    for name in counted:
        if launches[name] != n_leaves * steps:
            fail(f"{name} launched {launches[name]} times on the main path, "
                 f"expected {n_leaves} leaves x {steps} steps")
    if not all(bool(torch.isfinite(p).all()) for p in sess.params.values()):
        fail("non-finite parameters after training")
    step_breakdown(sess, spec)
    del sess, m
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def step_breakdown(sess, spec) -> None:
    """One more step, split by the host clock (each part ends in a
    synchronize) into client gradients, the EF round and the optimizer —
    run after the launch counts were read, from the same public functions
    the step is made of."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch import build as build_lib
    from repro_torch.models import model as model_lib
    from repro_torch.optim import optimizer as opt_lib
    efc, opt = build_lib.ef_config(spec), opt_lib.make("sgd", lr=spec.lr)
    batch = sess.batch_for(sess.step)
    t = [time.time()]
    _, grads = dist.per_client_value_and_grad(
        lambda p, b: model_lib.train_loss(sess.cfg, p, b), sess.params, batch,
        sess.n_clients)
    torch.cuda.synchronize()
    t.append(time.time())
    g_est, _ = dist.ef_round(efc, grads, sess.ef_state)
    del grads
    torch.cuda.synchronize()
    t.append(time.time())
    updates, _ = opt.update(g_est, {}, sess.params, sess.step)
    opt_lib.apply_updates(sess.params, updates)
    torch.cuda.synchronize()
    t.append(time.time())
    ms = [round((b - a) * 1e3, 1) for a, b in zip(t, t[1:])]
    print(f"{spec.carrier}/{spec.downlink_carrier} step breakdown ms: "
          f"client_grads {ms[0]} ef_round {ms[1]} optimizer {ms[2]}",
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "kernels", "csrc")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import spec as spec_lib
    from repro_torch.launch.session import Session
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
    results = {}
    with phase("kernels against their plain versions"):
        kernel_checks(ops, ref, results)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("cuda path against the cpu path (smoke size)"):
        reference_check(Session, spec_lib)
    with phase("main path: fused_quant8 up, fused_quant4 down, 3 steps"):
        up = main_path(Session, spec_lib, ops, "fused_quant8", "fused_quant4",
                       3, ("ef21_sgdm_topk_quant", "dequant_add"))
    with phase("fused carrier, 2 steps"):
        fused = main_path(Session, spec_lib, ops, "fused", "dense", 2,
                          ("ef21_sgdm_update",))

    csrc = "src/repro_torch/kernels/csrc"
    rows = [
        ("ef21_sgdm_update", "ef21_sgdm_update", f"{csrc}/ef_update.cu",
         "src/repro/kernels/ef_update.py:55", fused),
        ("ef21_sgdm_topk_quant", "ef21_sgdm_topk_quant/8",
         f"{csrc}/fused_round.cu", "src/repro/kernels/fused_round.py:111", up),
        ("dequant_add", "dequant_add/4", f"{csrc}/fused_round.cu",
         "src/repro/kernels/fused_round.py:164", up),
    ]
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[name], **{
                        k: results[key][k] for k in
                        ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")})
               for name, key, src, rep, counts in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
