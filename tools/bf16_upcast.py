#!/usr/bin/env python3
"""The upcasting instrument: where a bf16 gap on many ranks comes from,
read by raising one model op at a time to f32 on both sides of the
comparison. It reuses chip_smoke.py's MT phase and needs one CUDA card.

``--serve N``: MT-serve's bf16 gap. This is chip_smoke.py's MT-replicated
run alone, cut to N of its 32 layers: smollm-360m, unpadded, on (data 2,
model 2), 4 rank processes over gloo, 1 step, then its serve of 8 rows of
1024 with 8 decode steps. The run prints chip_smoke.py's serve lines.
Then the prefill runs again on the 4 ranks and on one device, with each
op the family runs raised to f32 (and the blocks together). For each op
it prints the gap between the two and the share of the logits that
differ.

``--pod``: olmoe-1b-7b's bf16 pod run and its group control on (pod 2,
data 2, model 1), card against CPU over chip_smoke.py's MT_SMOKE_STEPS.
Each runs as it is and again with the attention or the MoE layer raised
to f32 on both devices; the MoE layer's f32 takes its router's input with
it. For each it prints the first step's largest relative difference of
loss and g_norm, and every token whose chosen experts differ between
card and CPU, with the card's router gap between the experts swapped.

    python3 tools/bf16_upcast.py --serve 16 --pod
"""
import argparse
import contextlib
import dataclasses
import os
import shutil
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each model op the instrument raises, by the families that run it
UPCAST_OPS = {"MLP": ("dense", "hybrid"),
              "attention": ("dense", "moe", "hybrid"),
              "MoE": ("moe",),
              "mamba": ("ssm", "hybrid"),
              "logits": ("dense", "moe", "ssm", "hybrid")}
POD_OPS = ("attention", "MoE")


def _in_f32(fn):
    """``fn(p, x, ...)`` run on f32 copies of its params and input, its
    output (the first of a tuple) rounded to x's dtype once."""
    def run(p, x, *a, **kw):
        out = fn({k: v.float() for k, v in p.items()}, x.float(), *a, **kw)
        if isinstance(out, tuple):
            return (out[0].to(x.dtype), *out[1:])
        return out.to(x.dtype)
    return run


@contextlib.contextmanager
def upcast(ops_):
    """Within: each model op of ``ops_`` (keys of UPCAST_OPS joined by
    '+', or None: nothing) runs in f32 and rounds its output to the
    activation dtype once. An MLP, an attention block, a MoE layer or a
    mamba block runs on f32 copies of its params and input; under a
    'model' split each rank's partial product stays f32 through the f32
    sum over the axis. The logits' product runs on f32 copies of the
    embedding and the hidden state."""
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm as ssm_lib
    by_op = {"MLP": [(layers, "mlp_apply")],
             "attention": [(layers, "attn_apply")],
             "MoE": [(moe_lib, "moe_apply")],
             "mamba": [(ssm_lib, "mamba1_apply"), (ssm_lib, "mamba2_apply")],
             "logits": [(model_lib, "_logits")]}
    targets = [t for op in (ops_.split("+") if ops_ else ())
               for t in by_op[op]]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name, fn in saved:
        setattr(mod, name, (lambda cfg, e, h, fn=fn: fn(cfg, e.float(),
                                                         h.float()))
                if name == "_logits" else _in_f32(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def upcast_ops(cfg):
    """The UPCAST_OPS ``cfg``'s family runs, one at a time, then its
    blocks (every op but the logits) together where it runs several."""
    ops_ = [op for op, fams in UPCAST_OPS.items() if cfg.family in fams]
    blocks = [op for op in ops_ if op != "logits"]
    return ops_ + (["+".join(blocks)] if len(blocks) > 1 else [])


# ---------------------------------------------------------------------------
# --serve: MT-replicated's prefill, each op raised, 4 ranks against one
# ---------------------------------------------------------------------------

def _serve_sweep(cs, sess, shape, device):
    """On every rank: the served prefill again with each op of
    :func:`upcast_ops` raised; on rank 0 the gap (largest over a row's
    largest) and share of logits moved of each against one device's
    prefill under the same op, ``None`` raised: as served."""
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.session import Session
    B, S, _ = shape
    # mt_serve's prompts
    tokens = torch.randint(0, sess.cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    rows = sh.serve_rows(sess.mesh, B)
    ops_ = [None] + upcast_ops(sess.cfg)
    many = {}
    for op in ops_:
        with upcast(op), cs.serve_record() as seen:
            sess.serve(tokens=tokens, decode_steps=0)
        many[op] = sh.gather_rows(rows, seen[0].to(device)).cpu()
    out = None
    if sess.mesh.coordinate()["data"] == 0:
        whole = sh.unshard_tree(sess.params, sess.pspecs, sess.model_axes)
        if sess.mesh.rank == 0:
            one = Session(dataclasses.replace(sess.spec, mesh="smoke",
                                              clients=2), device=device)
            one.cfg = sess.cfg
            one.set_serve_params(whole)
            out = {}
            for op in ops_:
                with upcast(op), cs.serve_record() as seen:
                    one.serve(tokens=tokens, decode_steps=0)
                out[op] = (cs._row_rel(many[op], seen[0]),
                           cs._moved(many[op], seen[0]))
    return out


def serve_rank(rank, layers):
    """One rank: chip_smoke.py's MT-replicated run cut to ``layers``, its
    B 8 serve followed by :func:`_serve_sweep`."""
    import chip_smoke as cs
    orig, sweeps = cs.mt_serve, []

    def mt_serve(sess, ops, label, shape, device="cuda"):
        rec = orig(sess, ops, label, shape, device)
        if shape == cs.MT_SERVE.get(label):
            sweeps.append(_serve_sweep(cs, sess, shape, device))
        return rec
    cs.mt_serve = mt_serve
    label, arch, pad, _, steps, faults = next(
        r for r in cs.MT_RUNS if r[0] == "MT-replicated")
    out = cs.mt_rank(rank, [(label, arch, pad, {"num_layers": layers},
                             steps, faults)], smoke_archs=(), smoke_pod=())
    out["sweep"] = sweeps[0]
    return out


def serve_gap(cs, me, layers):
    from repro_torch.launch import multiproc
    label = "MT-replicated"
    work = tempfile.mkdtemp(prefix="bf16_serve_")
    try:
        ranks = multiproc.spawn(me.serve_rank, cs.MT_RANKS, work,
                                args=(layers,), threads=2, timeout_s=1200)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.mt_serve_checks(ranks, label, cs.MT_SERVE[label])
    sweep = ranks[0]["sweep"]
    rel, moved = sweep.pop(None)
    op = min((k for k in sweep if k != "logits"), key=lambda k: sweep[k][1])
    print(f"{label} serve at {layers} layers, the bf16 gap's op, each op "
          f"raised to f32 on the 4 ranks and on one device: prefill logits "
          f"within { {k: float(f'{v[0]:.4g}') for k, v in sweep.items()} } "
          f"of a row's largest (as served {rel:.4g}), the share of them "
          f"that differ { {k: round(v[1], 4) for k, v in sweep.items()} } "
          f"(as served {moved:.4f}); raised, {op} moves the fewest (the "
          "logits raised come out in f32 and differ in their last bits "
          "everywhere)", flush=True)


# ---------------------------------------------------------------------------
# --pod: olmoe's bf16 pod run and its group control, card against CPU
# ---------------------------------------------------------------------------

def pod_rank(rank):
    """One rank: each MT_POD_CONTROL run of chip_smoke.py's mt_smoke as it
    is and with each of POD_OPS raised, the chosen experts and router
    probabilities of each drop count's forward recorded."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models import moe as moe_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    cs._mt_narrow(cs.MT_SMOKE_POD_GEOM)
    orig, routing = cs._client_drops, []

    def client_drops(sess):
        sess._ensure_train()        # its first vmapped pass not captured
        with moe_lib.capture_routing() as seen:
            n = orig(sess)
        routing.append([(e.cpu(), p.float().cpu()) for e, p in seen])
        return n
    cs._client_drops = client_drops
    out = {}
    for label, arch, granularity, dtype, _ in cs.MT_SMOKE_POD:
        if label not in cs.MT_POD_CONTROL:
            continue
        for op in (None, *POD_OPS):
            routing.clear()
            with upcast(op):
                run = cs.mt_smoke(arch, granularity, dtype)
            n = cs.MT_SMOKE_STEPS
            run["routing"] = {"cuda": list(routing[:n]),
                              "cpu": list(routing[n:])}
            out[(label, op)] = run
    return out


def _first_gap(run) -> float:
    """The first step's largest relative difference of loss and g_norm,
    card against CPU."""
    return max(abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(run["cuda"][0], run["cpu"][0]))


def routing_flips(run):
    """The tokens whose chosen experts differ between the card's and the
    CPU's forward: (step, MoE call, token, the experts the card chose
    alone, the CPU's alone, the gap of their router probabilities and of
    their router logits on the card)."""
    flips = []
    for step, (card, cpu) in enumerate(zip(run["routing"]["cuda"],
                                           run["routing"]["cpu"])):
        for call, ((e1, p1), (e2, _)) in enumerate(zip(card, cpu)):
            for n in torch.nonzero((e1.sort(-1).values
                                    != e2.sort(-1).values).any(-1)).ravel():
                a = sorted(set(e1[n].tolist()) - set(e2[n].tolist()))
                b = sorted(set(e2[n].tolist()) - set(e1[n].tolist()))
                pa, pb = p1[n, a].min(), p1[n, b].max()
                flips.append((step, call, int(n), a, b,
                              float(pa - pb), float(torch.log(pa / pb))))
    return flips


def pod_gap(cs, me):
    from repro_torch.launch import multiproc
    work = tempfile.mkdtemp(prefix="bf16_pod_")
    try:
        ranks = multiproc.spawn(me.pod_rank, cs.MT_RANKS, work, threads=2,
                                timeout_s=1200)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for label in cs.MT_POD_CONTROL:
        gaps = {op: max(_first_gap(r[(label, op)]) for r in ranks)
                for op in (None, *POD_OPS)}
        base = gaps.pop(None)
        op = min(gaps, key=gaps.get)

        def flips(op_):
            return {rank: routing_flips(r[(label, op_)])
                    for rank, r in enumerate(ranks)
                    if routing_flips(r[(label, op_)])}
        print(f"MT smoke {label}: the gap's op, each op raised to f32 on "
              f"card and CPU: the first step's largest relative difference "
              f"{ {k: float(f'{v:.4g}') for k, v in gaps.items()} } (as run "
              f"{base:.4g}); raised, {op} takes the most of it; routing "
              "flips card against CPU (rank: [(step, MoE call, token, "
              "experts the card chose alone, the CPU's alone, their router "
              "probability gap, their router logit gap on the card)]): as "
              f"run {flips(None)}, with {op} in f32 {flips(op)}",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve", type=int, metavar="LAYERS",
                    help="read MT-serve's gap at this many of smollm-360m's "
                         "32 layers")
    ap.add_argument("--pod", action="store_true",
                    help="read olmoe's bf16 pod run and its group control")
    args = ap.parse_args()
    if args.serve is None and not args.pod:
        ap.error("nothing to read: give --serve LAYERS, --pod or both")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.dirname(os.path.abspath(__file__))]
    if not torch.cuda.is_available():
        sys.exit("this run needs a CUDA card")
    import bf16_upcast as me
    import chip_smoke as cs
    from repro_torch.kernels import build
    print(f"card: {cs.card_line()}", flush=True)
    build.build()
    if args.serve is not None:
        serve_gap(cs, me, args.serve)
    if args.pod:
        pod_gap(cs, me)


if __name__ == "__main__":
    main()
