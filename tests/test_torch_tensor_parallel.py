"""The 'model' axis of the port (tensor parallelism) on the CPU:
``models/model.py::param_pspecs`` and ``tp_plan``, ``tp_pad_heads``, the
tensor-parallel client pass (core/comm.py's f, g and resplit),
the EF round on each rank's shards, and the Session on a (data 2, model 2)
mesh, against the reference.

The 4 gloo ranks are spawned once for the module (``multiproc.spawn``, one
torch thread a rank), and ONE reference subprocess runs beside them on 4
forced host devices; both narrow the production geometry to (data 2,
model 2) (``PROD_DATA`` 2 and ``MESH_GEOM['pod']``) in their own process,
and read the same numpy inputs, written by the test process. Bars:

- ``param_pspecs`` equals the reference's (its PartitionSpecs as tuples)
  for all ten full configs at tp 2 and 16, with and without padding;
- padded smollm (H 3 -> 4), granite (4/1 -> 4/4) and musicgen (3/3 ->
  4/4) give the unpadded logits bit for bit at init on the same base
  weights; their loss and gradients match the reference's at rtol 1e-5;
- the client pass at (data 2, model 2): each rank's loss, MoE aux and
  gradient shards against the reference's unsharded pass on the same rows,
  rtol 1e-5, atol 1e-6 (f32) (smollm padded and not, granite's replicated
  kv, gemma2 with recompute, internvl2's prefix, olmoe's split experts);
- the per-shard round (leaves split over 'model' whose shards end in a
  ragged block) against the reference's ``ef_round_sharded`` under
  shard_map with the same split: floats within rtol 1e-5, atol 1e-7, the
  shards' wires (mantissas, scales, indices) exactly, and each client's
  state bit for bit the port's single-device round over its coordinate's
  shard tree;
- 3 Session steps of smollm smoke (``tp_pad_heads`` 2, fused_quant8 up,
  fused_quant4 down) from one initial checkpoint: loss, g_norm and params
  within rtol 1e-4 of the reference's Session on the same mesh, the padded
  heads' slices unmoved, the replicated parts bit for bit among the ranks
  of a 'model' coordinate, kill-and-resume bit for bit, and the npz with
  the reference's keys, shapes and spec_hash; the same of zamba2 smoke;
- serving: tokens, cache bytes and MoE drops the reference's in f32; in
  bf16 (smollm) the prefill logits against the reference's on the same
  mesh and each package's split against its own one device, the share
  of logits the split moves and its rms gap the reference's (both round
  each rank's row-parallel partial product to bf16 before the sum), two
  planted faults outside those bands.

The SSM families ride the same world: falcon-mamba's Mamba1 and zamba2's
Mamba2 with its shared block in the client pass (with and without
recompute), and one Mamba2 block on each 'model' pair with its split
``out_norm`` and ``conv_w`` gradient, sound and with planted faults.
"""
import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cb
from repro_torch.core import comm
from repro_torch.core import distributed as pt_dist
from repro_torch.core import ef as pt_ef
from repro_torch.launch import build as pt_build
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import multiproc
from repro_torch.launch import shardings as sh
from repro_torch.launch import spec as pt_spec
from repro_torch.models import model as pt_model

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
N, DP, TP = 4, 2, 2
STEPS = 3
ARCHS = sorted(cb.ARCH_ALIASES)
RTOL, ATOL = 1e-5, 1e-6

# the client pass: (arch, tp_pad_heads, remat, seq, config overrides)
GRAD_CASES = {
    "smollm": ("smollm-360m", 0, False, 32, {}),
    "smollm-pad": ("smollm-360m", 2, False, 32, {}),
    "granite": ("granite-34b", 0, False, 32, {}),
    "gemma2-remat": ("gemma2-9b", 0, True, 160, {}),
    "internvl2": ("internvl2-76b", 0, False, 32, {}),
    "olmoe": ("olmoe-1b-7b", 0, False, 32, {}),
    # every expert on every token, the experts split
    "olmoe-dense": ("olmoe-1b-7b", 0, False, 32, {"moe_impl": "dense"}),
    # 3 experts do not divide the axis: their d_ff splits instead
    "olmoe-3-experts": ("olmoe-1b-7b", 0, False, 32, {"num_experts": 3}),
    # Mamba1 on d_inner (in_proj's x and z re-split), Mamba2 on d_inner
    # and heads with the shared block split as the attention families'
    "falcon-mamba": ("falcon-mamba-7b", 0, False, 32, {}),
    "falcon-mamba-remat": ("falcon-mamba-7b", 0, True, 32, {}),
    "zamba2": ("zamba2-1.2b", 0, False, 32, {}),
    "zamba2-remat": ("zamba2-1.2b", 0, True, 32, {}),
}

# the per-shard round: every leaf but the norm splits over 'model', and
# each shard's length ends in a ragged block of 8
SHAPES = {"embed": (30, 7), "layers/w": (2, 6, 10), "norm": (8,)}
SPLIT = {"embed": ("model", None), "layers/w": (None, None, "model"),
         "norm": (None,)}
BTK = {"compressor": "block_topk",
       "compressor_kw": {"block": 8, "k_per_block": 2}}
BASE = {"version": 5, "smoke": True, "seq_len": 32, "eta": 0.5,
        "mesh": "smoke", "clients": DP, "global_batch": 4, **BTK}


def _case(steps=1, **fields):
    return {"spec": dict(BASE, **fields), "steps": steps}


ROUND_CASES = {
    **{f"carrier-{c}": _case(carrier=c)
       for c in ("dense", "sparse", "fused", "quant8", "quant4",
                 "fused_quant8", "fused_quant4")},
    "down-ef21_sgdm-dense-quant4": _case(carrier="dense",
                                         downlink_carrier="quant4"),
    "down-ef21_sgdm-sparse-quant8": _case(carrier="sparse",
                                          downlink_carrier="quant8"),
    "down-ef21_sgdm-quant4-sparse": _case(carrier="quant4",
                                          downlink_carrier="sparse"),
    "down-ef21_sgd-fused-quant4": _case(method="ef21_sgd", carrier="fused",
                                        downlink_carrier="quant4"),
    "down-ef14_sgd-dense-sparse": _case(method="ef14_sgd", carrier="dense",
                                        downlink_carrier="sparse"),
    "groups": _case(steps=2, groups=[
        {"pattern": "norm", "carrier": "dense"},
        {"pattern": "embed", "carrier": "sparse",
         "downlink_carrier": "quant8"},
        {"pattern": "*", "carrier": "fused_quant8"}]),
    "hops-quant4": _case(steps=2, carrier="quant8", hops={
        "pods": 2, "cross_carrier": "quant4", "cross_ratio": 0.25}),
}
WIRES = ("sparse", "quant8", "quant4")

# the Sessions, one client a (data) rank: smollm smoke padded, and
# zamba2 smoke (Mamba2 and the shared block split over 'model')
SESSION = {"version": 5, "smoke": True, "seq_len": 32, "global_batch": 4,
           "mesh": "pod", "tp_pad_heads": 2, "carrier": "fused_quant8",
           "downlink_carrier": "fused_quant4", "arch": "smollm-360m"}
SESSIONS = {"session": SESSION,
            "session_zamba2": dict(SESSION, arch="zamba2-1.2b",
                                   tp_pad_heads=0)}


# serving at (data 2, model 2): f32, the same params and prompts in both
# packages; B 4 splits over the 2 data ranks. smollm's 3 smoke heads
# stay whole on each rank (its d_ff and vocabulary split), granite's 4 q
# heads split over its 1 kv head (every rank caches the kv head whole),
# olmoe's experts split and its routing spans the data ranks,
# falcon-mamba's Mamba1 d_inner split (its in_proj product re-split each
# token), zamba2's Mamba2 and shared block split
SERVE_ARCHS = ("smollm-360m", "granite-34b", "olmoe-1b-7b",
               "falcon-mamba-7b", "zamba2-1.2b")
SERVE = {"B": 4, "S": 32, "steps": 4}
# one row (B 1 does not divide the 2 data ranks): the cache's sequence
# splits over all four ranks, every rank serving the row; gemma2's prompt
# passes its 128-slot window, so its local layers' ring wraps and splits
SERVE_B1 = {"smollm-360m": 32, "granite-34b": 32, "gemma2-9b": 160}
# serving in bf16 (the spec's activation dtype) on (data 2, model 2) and
# on one device, in both packages, from the same params (bf16 values) and
# prompts: the prefill's last-position logits. smollm's d_ff and
# vocabulary split, so each MLP's row-parallel w_down product leaves every
# rank as a partial sum
SERVE_BF16 = "smollm-360m"
SERVE_BF16_TOL = 2e-2       # of each row's largest magnitude, as serving's
# the port's split against its one device as the reference's against its
# own: the share of logits moved within 0.1, the rms gap within 25 %
SPLIT_MOVED, SPLIT_RMS = 0.1, 0.25
# publishing at (data 2, model 2), 1 step: the dense downlink publishes,
# the compressed one (SESSION's fused_quant4) is refused by the verify
PUBLISH = {"dense": dict(SESSION, downlink_carrier="dense"),
           "fused_quant4": SESSION}


def _narrow_port():
    """The port's production geometry narrowed to (data 2, model 2)."""
    mesh_lib.PROD_DATA = DP
    pt_spec.MESH_GEOM["pod"] = {"data": DP, "model": TP}


def _pod(mesh_name):
    """The rank's geometry: (data 2, model 2) or (pod 2, data 1, model
    2)."""
    if mesh_name == "hops":
        return mesh_lib.make_mesh((2, 1, TP), ("pod", "data", "model"))
    return mesh_lib.make_production_mesh()


def _cfg(arch, pad=0, remat=False, **over):
    return dataclasses.replace(cb.get_smoke(arch), dtype="float32",
                               tp_pad_heads=pad, remat=remat, **over)


def _shard_np(x, spec, m, lead=0):
    """Block m of the split dim of a numpy leaf (after ``lead`` leading
    axes)."""
    if "model" not in spec:
        return x
    dim = lead + spec.index("model")
    b = x.shape[dim] // TP
    return np.take(x, range(m * b, (m + 1) * b), axis=dim)


# ---------------------------------------------------------------------------
# inputs, written once by the test process
# ---------------------------------------------------------------------------

def _grad_inputs():
    out = {}
    for name, (arch, pad, remat, seq, over) in GRAD_CASES.items():
        cfg = _cfg(arch, pad, remat, **over)
        params = pt_model.init_params(
            cfg, torch.Generator().manual_seed(sum(map(ord, name))))
        rng = np.random.RandomState(len(name))
        batch = {"tokens": rng.randint(0, cfg.vocab_size, (2 * DP, seq))
                 .astype(np.int32),
                 "labels": rng.randint(0, cfg.vocab_size, (2 * DP, seq))
                 .astype(np.int32)}
        if cfg.frontend is not None:
            batch["prefix_embeds"] = (0.5 * rng.randn(
                2 * DP, 8, cfg.d_model)).astype(np.float32)
        out[name] = {"params": {k: v.numpy() for k, v in params.items()},
                     "batch": batch}
    return out


def _serve_inputs():
    out = {}
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch)
        params = pt_model.init_params(
            cfg, torch.Generator().manual_seed(sum(map(ord, arch))))
        rng = np.random.RandomState(len(arch))
        out[arch] = {"params": {k: v.numpy() for k, v in params.items()},
                     "tokens": rng.randint(0, cfg.vocab_size,
                                           (SERVE["B"], SERVE["S"]))
                     .astype(np.int32)}
    for arch, S in SERVE_B1.items():
        cfg = _cfg(arch)
        params = pt_model.init_params(
            cfg, torch.Generator().manual_seed(len(arch)))
        rng = np.random.RandomState(S)
        out[arch + "/B1"] = {
            "params": {k: v.numpy() for k, v in params.items()},
            "tokens": rng.randint(0, cfg.vocab_size, (1, S))
            .astype(np.int32)}
    # bf16 values, so neither package's cast of a matrix rounds
    params = pt_model.init_params(_cfg(SERVE_BF16),
                                  torch.Generator().manual_seed(16))
    out[SERVE_BF16 + "/bf16"] = {
        "params": {k: v.to(torch.bfloat16).float().numpy()
                   for k, v in params.items()},
        "tokens": out[SERVE_BF16]["tokens"]}
    return out


def _round_inputs(seed):
    rng = np.random.RandomState(seed)

    def tree(lead=()):
        return {k: rng.randn(*lead, *s).astype(np.float32)
                for k, s in SHAPES.items()}
    return tree(), tree((DP,)), [tree((DP,)) for _ in range(2)]


def _seed(name):
    return sum(map(ord, name)) % 1000


# ---------------------------------------------------------------------------
# the 4 ranks
# ---------------------------------------------------------------------------

def _rank_grads(inp, mesh):
    model = mesh.axes(("model",))
    client = mesh.axes(("data",))
    out = {}
    for name, (arch, pad, remat, _, over) in GRAD_CASES.items():
        cfg = _cfg(arch, pad, remat, **over)
        params = {k: torch.tensor(v)
                  for k, v in inp["grad"][name]["params"].items()}
        batch = {k: torch.tensor(v)
                 for k, v in inp["grad"][name]["batch"].items()}
        local = sh.shard_tree(params, pt_model.param_pspecs(cfg, TP), model)
        tp = pt_model.tp_plan(cfg, model)
        rows = pt_dist.client_rows(batch, DP, client.index)
        loss, aux, g = pt_dist.client_value_and_grad(
            lambda p, b: pt_model.train_loss(cfg, p, b, tp=tp), local, rows)
        out[name] = (float(loss), {k: float(v) for k, v in aux.items()},
                     {k: v[0].numpy().copy() for k, v in g.items()})
    return out


def _flat(tree):
    return {k: v.float().numpy().copy() for k, v in pt_ef.flatten(tree).items()}


def _rank_rounds(meshes):
    out = {}
    for name, case in ROUND_CASES.items():
        mesh = meshes["hops" if "hops" in name else "pod"]
        spec = pt_spec.RunSpec.from_dict(case["spec"])
        efc = pt_build.ef_config(spec, client_axes=mesh.client_axes())
        c_axes = mesh.axes(mesh.client_axes())
        c, m = c_axes.index, mesh.coordinate()["model"]
        params, g0, grads = _round_inputs(_seed(name))

        def mine(tree, rows=None):
            return {k: torch.tensor(np.ascontiguousarray(_shard_np(
                v if rows is None else v[rows], SPLIT[k], m,
                0 if rows is None else 1))) for k, v in tree.items()}
        state = pt_dist.init_ef_state_sharded(
            efc, mine(params), mesh, init_grads=mine(g0, slice(c, c + 1)))
        steps = [{p: _flat(v) for p, v in state.items()}]
        for s in range(case["steps"]):
            est, state = pt_dist.ef_round_sharded(
                efc, mine(grads[s], slice(c, c + 1)), state, mesh, step=s)
            steps.append({"g_est": _flat(est),
                          **{p: _flat(v) for p, v in state.items()}})
        out[name] = steps
    return out


def _rank_wires(mesh):
    """Each wire carrier's encode of this rank's (client, shard) row of the
    embedding's deltas."""
    from repro_torch.core import carriers as carrier_lib
    c = mesh.axes(("data",)).index
    m = mesh.coordinate()["model"]
    _, g0, _ = _round_inputs(11)
    x = torch.tensor(np.ascontiguousarray(
        _shard_np(g0["embed"][c], SPLIT["embed"], m))).reshape(1, -1)
    comp = pt_build._build_compressor(BTK["compressor"],
                                      BTK["compressor_kw"], 0.05)
    return {w: [t.numpy().copy() for t in carrier_lib.make(w).encode(comp, x)]
            for w in WIRES}


def _clip(norm_sq=None):
    from repro_torch.optim import optimizer as opt_lib
    return opt_lib.clip_by_global_norm(opt_lib.sgd(0.5), 1.0, norm_sq)


def _rank_norms(mesh):
    """g_norm and global-norm clipping of a tree of this rank's shards."""
    model = mesh.axes(("model",))
    params, g0, _ = _round_inputs(5)
    shard = {k: torch.tensor(np.ascontiguousarray(
        _shard_np(v[0], SPLIT[k], model.index))) for k, v in g0.items()}
    p = {k: torch.tensor(np.ascontiguousarray(
        _shard_np(v, SPLIT[k], model.index))) for k, v in params.items()}
    opt = _clip(lambda g: pt_dist.tree_norm_sq_sharded(g, SPLIT, model))
    upd, _ = opt.update(shard, opt.init(p), p, 0)
    return (float(pt_dist.tree_norm_sq_sharded(shard, SPLIT, model)),
            {k: v.numpy().copy() for k, v in upd.items()})


def _rank_session(workdir, ckpt0, spec_dict):
    from repro_torch.launch.session import Session
    spec = pt_spec.RunSpec.from_dict(spec_dict)
    sess = Session(spec, device="cpu", dtype="float32")
    sess.restore_from(ckpt0, allow_spec_mismatch=True)
    start = {k: v.clone() for k, v in sess.params.items()}
    out = {"mesh": dict(sess.mesh.shape), "trajectory": [], "digests": []}
    cut = os.path.join(workdir, "cut")
    for d in (cut, os.path.join(workdir, "final")):
        os.makedirs(d, exist_ok=True)
    for step in range(STEPS):
        m = sess.step_once()
        out["trajectory"].append((float(m["loss"]), float(m["g_norm"])))
        out["digests"].append(sh.replicated_digest(sess.params,
                                                   sess.ef_state))
        if sess.step == 1:
            out["params_1"] = {k: v.numpy().copy()
                               for k, v in sess.params.items()}
        if sess.step == 2:
            sess.save(os.path.join(cut, "step_00000002.npz"))
    out["npz"] = sess.save(os.path.join(workdir, "final", "step_3.npz"))
    out["start"] = {k: v.numpy() for k, v in start.items()}
    out["params"] = {k: v.numpy().copy() for k, v in sess.params.items()}
    out["ef_state"] = _flat(sess.ef_state)
    resumed = Session.resume(cut, device="cpu", dtype="float32")
    out["resumed_step"] = resumed.step
    resumed.train(STEPS, log_every=0)
    a = pt_ef.flatten({"params": sess.params, "ef_state": sess.ef_state,
                       "opt_state": sess.opt_state})
    b = pt_ef.flatten({"params": resumed.params,
                       "ef_state": resumed.ef_state,
                       "opt_state": resumed.opt_state})
    out["resume_equal"] = sorted(a) == sorted(b) and all(
        torch.equal(a[k], b[k]) for k in a)
    return out


def _serve_drops(sess, tokens):
    """Serve ``tokens`` on ``sess`` (SERVE's decode steps), recording each
    MoE call's dropped assignments among this rank's tokens (under a row
    split ``dropped_frac`` is this rank's share of the call's)."""
    from repro_torch.models import moe as pt_moe
    drops, orig = [], pt_moe.moe_apply

    def moe(p, x, **kw):
        out, aux = orig(p, x, **kw)
        split = kw.get("split")
        n = x.shape[0] * x.shape[1] * kw["k"] * (split.size if split else 1)
        drops.append(round(float(aux["dropped_frac"]) * n))
        return out, aux
    pt_moe.moe_apply = moe
    try:
        r = sess.serve(tokens=torch.tensor(tokens),
                       decode_steps=SERVE["steps"])
    finally:
        pt_moe.moe_apply = orig
    return dict(r, drops=drops)


def _rank_serve(inp):
    """Each serving arch on (data 2, model 2) from the same params and
    prompts as the reference's: the tokens, cache bytes and MoE drops."""
    from repro_torch.launch.session import Session
    out = {}
    for name in (*SERVE_ARCHS, *(a + "/B1" for a in SERVE_B1)):
        spec = pt_spec.RunSpec.from_dict(dict(
            SESSION, arch=name.split("/")[0], tp_pad_heads=0))
        sess = Session(spec, device="cpu", dtype="float32")
        sess.set_serve_params({k: torch.tensor(v) for k, v in
                               inp["serve"][name]["params"].items()})
        comm.reset_stats()
        r = _serve_drops(sess, inp["serve"][name]["tokens"])
        out[name] = {k: r[k] for k in ("tokens", "cache_bytes",
                                       "local_cache_bytes", "drops")}
        out[name]["kinds"] = {k: dict(v, groups=dict(v["groups"]))
                              for k, v in comm.KINDS.items()}
    out[SERVE_BF16 + "/bf16"] = _rank_serve_bf16(inp)
    return out


# planted faults of the MLP's row-parallel w_down product under a 'model'
# split, where both packages round each rank's partial product to bf16
# once before the f32 sum over 'model': "fewer" keeps the partial in f32
# through the sum and rounds once after it; "more" sums the partial's
# blocks of PLANTED_BLOCK of the rank's d_ff rows in bf16, rounding the
# running sum at each block (a blocked product with a bf16 accumulator)
PLANTED_PARTIALS = ("fewer", "more")
PLANTED_BLOCK = 8


@contextlib.contextmanager
def _planted_partials(fault):
    """Within: the port's MLP with the PLANTED_PARTIALS ``fault``."""
    import torch.nn.functional as F
    from repro_torch.models import layers
    orig = layers.mlp_apply

    def mlp(p, x, eps, tp=None):
        if tp is None or not tp.ff:
            return orig(p, x, eps, tp)
        h = comm.copy_to(tp.axes, layers.rms_norm(x, p["norm"], eps))
        act = F.silu(h @ p["w_gate"].to(h.dtype)) * (h @ p["w_up"].to(h.dtype))
        w = p["w_down"].to(act.dtype)
        if fault == "fewer":
            out = act.float() @ w.float()
        else:
            out = 0
            for a, b in zip(act.split(PLANTED_BLOCK, -1),
                            w.split(PLANTED_BLOCK, 0)):
                out = out + a @ b
        return comm.reduce_from(tp.axes, out).to(x.dtype)
    layers.mlp_apply = mlp
    try:
        yield
    finally:
        layers.mlp_apply = orig


def _rank_serve_bf16(inp):
    """SERVE_BF16 served in the spec's bf16 on (data 2, model 2): the
    tokens and this rank's rows' prefill logits at the last position, as
    the port runs it and with each PLANTED_PARTIALS fault."""
    from repro_torch.launch.session import Session
    name = SERVE_BF16 + "/bf16"
    out, orig = {}, pt_model._serve_logits
    for run, ctx in (("logits", contextlib.nullcontext()),
                     *((f, _planted_partials(f)) for f in PLANTED_PARTIALS)):
        sess = Session(pt_spec.RunSpec.from_dict(dict(
            SESSION, arch=SERVE_BF16, tp_pad_heads=0)), device="cpu")
        assert sess.cfg.activation_dtype == torch.bfloat16
        sess.set_serve_params({k: torch.tensor(v) for k, v in
                               inp["serve"][name]["params"].items()})
        seen = []

        def logits(*a, **kw):
            lg = orig(*a, **kw)
            seen.append(lg[:, -1].numpy().copy())
            return lg
        pt_model._serve_logits = logits
        try:
            with ctx:
                r = sess.serve(tokens=torch.tensor(
                    inp["serve"][name]["tokens"]),
                    decode_steps=SERVE["steps"])
        finally:
            pt_model._serve_logits = orig
        out[run] = seen[0]
        out.setdefault("tokens", r["tokens"])
    return out


@contextlib.contextmanager
def _gather_skipped():
    """A planted fault: the publishing rank's trees stay its own 'model'
    shards (the gather into the single-device layout skipped)."""
    from repro_torch.launch import session as pt_session
    saved = pt_session.sh.unshard_tree
    pt_session.sh.unshard_tree = \
        lambda tree, pspecs, axes: tree if axes.index == 0 else None
    try:
        yield
    finally:
        pt_session.sh.unshard_tree = saved


def _rank_publish(workdir, ckpt0):
    """One published step of each PUBLISH spec from its initial
    checkpoint, then the compressed one with the gather planted away:
    what each raised (None: it published)."""
    from repro_torch.launch.session import Session
    out = {}
    runs = [(name, spec, contextlib.nullcontext())
            for name, spec in PUBLISH.items()]
    runs.append(("gather-skipped", PUBLISH["fused_quant4"], _gather_skipped()))
    for name, spec, fault in runs:
        sess = Session(pt_spec.RunSpec.from_dict(spec), device="cpu",
                       dtype="float32")
        sess.restore_from(ckpt0[spec_key(spec)], allow_spec_mismatch=True)
        sess.publish_to(os.path.join(workdir, f"wire_{name}"))
        try:
            with fault:
                sess.step_once()
            out[name] = None
        except Exception as err:
            out[name] = (type(err).__name__, str(err), sess.step)
    out["dir"] = workdir
    return out


def spec_key(spec):
    """The initial checkpoint a publish spec restores (SESSIONS' key)."""
    return "session_dense" if spec["downlink_carrier"] == "dense" \
        else "session"


def _mamba2_block(cfg, p, x, tp=None):
    from repro_torch.models import ssm as ssm_lib
    return ssm_lib.mamba2_apply(p, x, cfg, tp=tp)[0]


def _planted(fault):
    """The Mamba2 split with one of its collectives planted wrong: the f
    on out_norm's mean square dropped, or that mean square's gradient
    summed twice; the f on conv_w's x columns dropped, or conv_w's B and C
    columns summed over the axis with them."""
    import contextlib
    from repro_torch.models import ssm as ssm_lib

    def conv_no_f(tp, w, Di):
        n = Di // tp.axes.size
        return w[:, tp.axes.index * n:(tp.axes.index + 1) * n], w[:, Di:]

    def conv_all_summed(tp, w, Di):
        n = Di // tp.axes.size
        w = comm.copy_to(tp.axes, w)
        return w[:, tp.axes.index * n:(tp.axes.index + 1) * n], w[:, Di:]
    patch = {
        "out_norm-no-f": (comm, "reduce_to_all", comm.reduce_from),
        "out_norm-summed-twice": (comm, "reduce_to_all", lambda a, x: (
            comm.copy_to(a, comm.copy_to(a, comm.reduce_from(a, x))))),
        "conv_w-no-f": (ssm_lib, "_conv_w_local", conv_no_f),
        "conv_w-bc-summed": (ssm_lib, "_conv_w_local", conv_all_summed),
    }.get(fault)

    @contextlib.contextmanager
    def ctx():
        if patch is None:
            yield
            return
        mod, name, fn = patch
        saved = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, saved)
    return ctx()


MAMBA2_FAULTS = ("out_norm-no-f", "out_norm-summed-twice", "conv_w-no-f",
                 "conv_w-bc-summed")


def _rank_mamba2_unit(mesh):
    """One zamba2 smoke Mamba2 block on the 2 ranks of this rank's 'model'
    axis, sound and with each planted fault: the gradient shards of a
    fixed cotangent's product, and of the input, against the whole
    block's on this process."""
    model = mesh.axes(("model",))
    cfg = _cfg("zamba2-1.2b")
    gen = torch.Generator().manual_seed(7)
    whole = {k[len("layers/mamba/"):]: v[0] for k, v in pt_model.init_params(
        cfg, gen).items() if k.startswith("layers/mamba/")}
    # scales and biases off their constant init, so every term shows
    for k in ("out_norm", "norm", "dt_bias", "A_log", "D"):
        whole[k] = whole[k] + 0.3 * torch.randn(whole[k].shape, generator=gen)
    x = torch.randn(2, 32, cfg.d_model, generator=gen)
    # a cotangent that keeps the gradients of order 1, as the loss's are
    cot = 0.1 * torch.randn(2, 32, cfg.d_model, generator=gen)
    specs = {k[len("layers/mamba/"):]: v[1:] for k, v in
             pt_model.param_pspecs(cfg, TP).items()
             if k.startswith("layers/mamba/")}
    tp = pt_model.tp_plan(cfg, model)

    def grads(p, tp_):
        return torch.func.grad(lambda p_, x_: (
            _mamba2_block(cfg, p_, x_, tp_) * cot).sum(), argnums=(0, 1))(
                p, x)
    gw, gx = grads(whole, None)
    want = {k: sh.shard_leaf(v, specs[k], model.index, TP)
            for k, v in gw.items()}
    local = sh.shard_tree(whole, specs, model)
    out = {}
    for fault in ("sound",) + MAMBA2_FAULTS:
        with _planted(fault):
            g, x_g = grads(local, tp)
        out[fault] = ({k: (v.numpy().copy(), want[k].numpy().copy())
                       for k, v in g.items()},
                      (x_g.numpy().copy(), gx.numpy().copy()))
    return out


def _rank_work(rank, inp_path, workdir, ckpt0):
    _narrow_port()
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    meshes = {"pod": _pod("pod"), "hops": _pod("hops")}
    mesh = meshes["pod"]
    out = {"coord": (mesh.axes(("data",)).index,
                     mesh.coordinate()["model"])}
    out["grads"] = _rank_grads(inp, mesh)
    out["mamba2"] = _rank_mamba2_unit(mesh)
    out["rounds"] = _rank_rounds(meshes)
    out["wires"] = _rank_wires(mesh)
    out["norms"] = _rank_norms(mesh)
    for name, spec in SESSIONS.items():
        out[name] = _rank_session(os.path.join(workdir, name), ckpt0[name],
                                  spec)
    out["serve"] = _rank_serve(inp)
    out["publish"] = _rank_publish(workdir, ckpt0)
    return out


# ---------------------------------------------------------------------------
# the reference, in one subprocess on 4 forced host devices
# ---------------------------------------------------------------------------

def _reference_serve_bf16(inp):
    """The reference's SERVE_BF16 in the spec's bf16, in the reference
    subprocess: the prefill's last-position logits under the mesh (the
    jitted prefill serve() built, run again on its placement of the
    params, the prompts and a fresh cache) and on one device (the same
    prefill jitted without a mesh), and the served tokens."""
    import jax
    import jax.numpy as jnp
    from repro.launch import mesh as jax_mesh
    from repro.launch import session as jax_session
    from repro.launch import spec as jax_spec
    from repro.models import model as jax_model
    from test_torch_ef_round import _nest
    name = SERVE_BF16 + "/bf16"
    jsess = jax_session.Session(jax_spec.RunSpec.from_dict(
        dict(SESSION, arch=SERVE_BF16, tp_pad_heads=0)))
    assert jsess.cfg.activation_dtype == jnp.bfloat16
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     _nest(inp["serve"][name]["params"]))
    jsess.set_serve_params(jparams)
    tokens = inp["serve"][name]["tokens"]
    B, S = tokens.shape
    r = jsess.serve(tokens=jnp.asarray(tokens), decode_steps=SERVE["steps"])
    prefill, _, _, b_spec, c_spec, _ = jsess._serve_cache[
        (B, S, SERVE["steps"])]
    shard_of = lambda tree: jax.tree_util.tree_map(    # noqa: E731
        lambda s: s.sharding, tree)
    cache = jax_model.init_cache(jsess.cfg, B, S + SERVE["steps"])
    with jax_mesh.mesh_context(jsess.mesh):
        mesh_logits, _ = prefill(
            jsess._serve_params[1],
            dict(jax.device_put({"tokens": jnp.asarray(tokens)},
                                shard_of(b_spec))),
            jax.device_put(cache, shard_of(c_spec)))
    one_logits, _ = jax.jit(lambda p, t, c: jax_model.prefill(
        jsess.cfg, p, {"tokens": t}, c))(jparams, jnp.asarray(tokens), cache)
    return {"tokens": np.asarray(r["tokens"]),
            "logits": np.asarray(mesh_logits[:, -1], np.float32),
            "one_logits": np.asarray(one_logits[:, -1], np.float32)}


def _reference_main(inp_path, ckpt0, out_path, workdir):
    """Run in the subprocess (XLA_FLAGS set before jax loads)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs import base as jax_cb
    from repro.core import carriers as jax_car
    from repro.core import distributed as jax_dist
    from repro.launch import mesh as jax_mesh
    from repro.launch import session as jax_session
    from repro.launch import spec as jax_spec
    from repro.models import model as jax_model
    from test_torch_ef_round import _nest
    from test_torch_schedule import configs, flat
    assert len(jax.devices()) == N, jax.devices()
    jax_mesh.PROD_DATA = DP
    jax_spec.MESH_GEOM["pod"] = {"data": DP, "model": TP}
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = {"grads": {}, "rounds": {}, "wires": {}}

    # the client pass, unsharded, client by client
    for name, (arch, pad, remat, _, over) in GRAD_CASES.items():
        cfg = dataclasses.replace(jax_cb.get_smoke(arch), dtype="float32",
                                  tp_pad_heads=pad, remat=remat, **over)
        params = jax.tree_util.tree_map(
            jnp.asarray, _nest(inp["grad"][name]["params"]))
        batch = inp["grad"][name]["batch"]
        fn = jax.jit(lambda p, b: jax_dist.per_client_value_and_grad(
            lambda pp, bb: jax_model.train_loss(cfg, pp, bb), p, b, 1))
        per = []
        for c in range(DP):
            m = batch["tokens"].shape[0] // DP
            rows = {k: jnp.asarray(v[c * m:(c + 1) * m])
                    for k, v in batch.items()}
            loss, aux, g = fn(params, rows)
            per.append((float(loss), {k: float(v) for k, v in aux.items()},
                        {k: np.asarray(v[0]) for k, v in
                         pt_ef.flatten(g).items()}))
        out["grads"][name] = per

    # the per-shard round under shard_map
    for name, case in ROUND_CASES.items():
        hops = "hops" in name
        j_efc, _ = configs(case["spec"])
        c_axes = ("pod", "data") if hops else ("data",)
        j_efc = dataclasses.replace(j_efc, data_axes=c_axes)
        mesh = jax_mesh.make_mesh((2, 1, TP) if hops else (DP, TP),
                                  ("pod", "data", "model") if hops
                                  else ("data", "model"))
        leaf = {k: P(*SPLIT[k]) for k in SHAPES}
        gspecs = _nest({k: P(c_axes, *SPLIT[k]) for k in SHAPES})
        sspecs = {"clients": {}, "server": _nest(leaf), "h": _nest(leaf)}
        params, g0, grads = _round_inputs(_seed(name))
        to_j = lambda t: jax.tree_util.tree_map(           # noqa: E731
            jnp.asarray, _nest(t))
        state = jax_dist.init_ef_state(j_efc, to_j(params), DP,
                                       init_grads=to_j(g0))
        sspecs["clients"] = {k: gspecs for k in state["clients"]}
        if hops:
            sspecs["pods"] = {k: _nest({n: P("pod", *SPLIT[n])
                                        for n in SHAPES})
                              for k in state["pods"]}
        if "h" not in state:
            del sspecs["h"]
        fn = jax.jit(lambda g, s, st: jax_dist.ef_round_sharded(
            j_efc, g, s, None, mesh, gspecs, sspecs, step=st))
        steps = [{p: flat(v) for p, v in state.items()}]
        with jax_mesh.mesh_context(mesh):
            for s in range(case["steps"]):
                est, state = fn(to_j(grads[s]), state, jnp.int32(s))
                steps.append({"g_est": flat(est),
                              **{p: flat(v) for p, v in state.items()}})
        out["rounds"][name] = steps

    # the wires of each (client, shard) row
    from repro.core import compressors as jax_comp
    comp = jax_comp.BlockTopK(**BTK["compressor_kw"])
    _, g0, _ = _round_inputs(11)
    for c in range(DP):
        for m in range(TP):
            x = jnp.asarray(np.ascontiguousarray(
                _shard_np(g0["embed"][c], SPLIT["embed"], m))).reshape(-1)
            for w in WIRES:
                # jitted, as the round runs it (XLA's reciprocal scales)
                enc = jax.jit(lambda v, w=w: jax_car.make(w).encode(comp, v))
                out["wires"][(c, m, w)] = [np.asarray(t) for t in enc(x)]

    # the Sessions on the narrowed pod mesh
    for name, spec in SESSIONS.items():
        jsess = jax_session.Session(jax_spec.RunSpec.from_dict(spec))
        jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
        jsess.restore_from(ckpt0[name], allow_spec_mismatch=True)
        history = jsess.train(1, log_every=1)
        params_1 = {k: np.asarray(v) for k, v in
                    pt_ef.flatten(jax.device_get(jsess.params)).items()}
        history += jsess.train(STEPS, log_every=1)
        out[name] = {"history": history, "params_1": params_1,
                     "npz": jsess.save(os.path.join(
                         workdir, f"ref_{name}_step_3.npz")),
                     "mesh": dict(jsess.mesh.shape)}

    # serving on the narrowed pod mesh, f32, the port's params and prompts;
    # a device's bytes of the cache: each leaf's shard_shape under the
    # reference's cache_pspecs
    from jax.sharding import NamedSharding
    from repro.data import pipeline as jax_pipe
    from repro.launch import shardings as jax_sh
    from repro.models import model as jax_model
    out["serve"] = {}
    for name in (*SERVE_ARCHS, *(a + "/B1" for a in SERVE_B1)):
        arch = name.split("/")[0]
        jsess = jax_session.Session(jax_spec.RunSpec.from_dict(
            dict(SESSION, arch=arch, tp_pad_heads=0)))
        jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
        jsess.set_serve_params(jax.tree_util.tree_map(
            jnp.asarray, _nest(inp["serve"][name]["params"])))
        tokens = inp["serve"][name]["tokens"]
        r = jsess.serve(tokens=jnp.asarray(tokens),
                        decode_steps=SERVE["steps"])
        B, S = tokens.shape
        slots = jax_pipe.prefix_token_count(
            jsess.cfg, pad_to=jax_pipe.PREFIX_PAD_SPEC) + S + SERVE["steps"]
        # the cache's leaves as the prefill leaves them (an f32 state
        # promotes a bf16 conv cache, as the serve's cache_bytes counts)
        jparams = jax.tree_util.tree_map(
            jnp.asarray, _nest(inp["serve"][name]["params"]))
        shapes = jax.eval_shape(
            lambda c: jax_model.prefill(jsess.cfg, jparams,
                                        {"tokens": jnp.asarray(tokens)},
                                        c)[1],
            jax.eval_shape(lambda: jax_model.init_cache(jsess.cfg, B,
                                                        slots)))
        specs = jax_sh.cache_pspecs(jsess.cfg, jsess.mesh, B)
        shard = {k: int(np.prod(NamedSharding(jsess.mesh, specs[k])
                                .shard_shape(x.shape))) * x.dtype.itemsize
                 for k, x in shapes.items()}
        out["serve"][name] = {"tokens": np.asarray(r["tokens"]),
                              "cache_bytes": r["cache_bytes"],
                              "shard_bytes": shard}

    out["serve"][SERVE_BF16 + "/bf16"] = _reference_serve_bf16(inp)

    # one published step of each PUBLISH spec
    from repro.core import stream as jax_stream
    out["publish"] = {}
    for name, spec in PUBLISH.items():
        jsess = jax_session.Session(jax_spec.RunSpec.from_dict(spec))
        jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
        jsess.restore_from(ckpt0[spec_key(spec)], allow_spec_mismatch=True)
        jsess.publish_to(os.path.join(workdir, f"ref_wire_{name}"))
        try:
            jsess.step_once()
            out["publish"][name] = None
        except jax_stream.StreamIntegrityError as err:
            out["publish"][name] = (type(err).__name__, str(err),
                                    jsess.step)
    out["publish"]["dir"] = workdir
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs and the initial checkpoint (the port's single-device
    Session at step 0: both packages restore it), then the reference
    subprocess and the 4 ranks side by side."""
    tmp = tmp_path_factory.mktemp("tp")
    inp = {"grad": _grad_inputs(), "serve": _serve_inputs()}
    inp_path = str(tmp / "inputs.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    from repro_torch.launch.session import Session
    ckpt0 = {}
    for name, spec in dict(SESSIONS,
                           session_dense=PUBLISH["dense"]).items():
        init = Session(pt_spec.RunSpec.from_dict(
            dict(spec, mesh="smoke", clients=DP)), device="cpu",
            dtype="float32")
        ckpt0[name] = init.save(str(tmp / f"{name}_step_0.npz"))
        del init
    ref_out = str(tmp / "reference.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               f"={N}", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    ref = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_tensor_parallel as t; "
         f"t._reference_main({inp_path!r}, {ckpt0!r}, {ref_out!r}, "
         f"{str(tmp)!r})"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = multiproc.spawn(_rank_work, N, str(tmp / "mp"),
                                args=(inp_path, str(tmp / "port"), ckpt0),
                                timeout_s=300)
        log = ref.communicate(timeout=300)[0]
    finally:
        ref.kill()
    assert ref.returncode == 0, log[-4000:]
    with open(ref_out, "rb") as f:
        want = pickle.load(f)
    return inp, ranks, want


# ---------------------------------------------------------------------------
# 1. param_pspecs, no ranks
# ---------------------------------------------------------------------------

def _ref_pspecs(arch, tp, pad):
    from jax.sharding import PartitionSpec as P
    from repro.configs import base as jax_cb
    from repro.models import model as jax_model
    cfg = dataclasses.replace(jax_cb.get(arch), tp_pad_heads=pad)
    tree = jax_model.param_pspecs(cfg, tp)

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, P):
                yield path, tuple(v)
            else:
                yield from walk(v, path)
    return dict(walk(tree, ""))


@pytest.mark.parametrize("pad", [0, 2])
@pytest.mark.parametrize("tp", [2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_the_reference(arch, tp, pad):
    cfg = dataclasses.replace(cb.get(arch), tp_pad_heads=pad)
    got = pt_model.param_pspecs(cfg, tp)
    assert got == _ref_pspecs(arch, tp, pad)
    shapes = pt_model.init_params(cfg, None, "meta")
    assert sorted(got) == sorted(shapes)
    for k, spec in got.items():
        assert len(spec) == shapes[k].dim(), k
        d = sh.split_dim(spec)
        assert d is None or shapes[k].shape[d] % tp == 0, k


# the SSM families' plans at tp 2 and 16: (d_inner, heads, ff)
class _Mesh:
    """The reference's cache_pspecs reads a mesh's axis names and sizes
    alone."""
    axis_names = ("data", "model")
    shape = {"data": DP, "model": TP}


@pytest.mark.parametrize("B", [4, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_split_as_the_reference_s(arch, B):
    """Each serving cache leaf's split (``shardings.cache_pspecs``, the
    port's ``init_cache`` slice) equals the reference's ``cache_pspecs``
    on (data 2, model 2), entry by entry: the rows over the data axes
    where B divides them, the kv heads, d_inner and the SSM heads over
    'model' where they split, and the sequence over 'model' where the kv
    heads do not split (over the data axes and 'model', or the data axes
    alone, where the rows do not). A hybrid's conv state splits on the
    same dim in another order (this rank's d_inner columns, then B and
    C's whole); ``init_cache`` holds this rank's block of the slots
    (``slot_range``)."""
    from repro.configs import base as jax_cb
    from repro.launch import shardings as jax_sh
    cfg = cb.get(arch)
    mesh = mesh_lib.Mesh((DP, TP), ("data", "model"))
    got = sh.cache_pspecs(cfg, mesh, B)
    want = {k: tuple(v) for k, v in
            jax_sh.cache_pspecs(jax_cb.get(arch), _Mesh(), B).items()}
    assert got == want
    seq = sh.seq_axes(cfg, mesh, B)
    attn = got.get("k", got.get("k_local", got.get("k_attn")))
    if attn is None or attn[2] is None:
        assert seq is None
    else:
        names = (attn[2],) if isinstance(attn[2], str) else attn[2]
        assert seq.names == tuple(names)
        assert seq.size == DP ** ("data" in names) * TP ** ("model" in names)


def test_slot_range_splits_or_raises_as_the_reference_shard_shape():
    """Rank i of n holds the i-th contiguous block of the slots; a count
    the split does not divide raises, as the reference's
    ``NamedSharding.shard_shape`` raises for an uneven tiling."""
    from repro_torch.models import layers as pt_layers
    seq = comm.Axes(("data", "model"), None, 4, 2, (0,))
    assert pt_layers.slot_range(36, seq) == (18, 27)
    assert pt_layers.slot_range(36, None) == (0, 36)
    with pytest.raises(ValueError, match="does not divide"):
        pt_layers.slot_range(38, seq)


SSM_PLANS = {"falcon-mamba-7b": (True, False, False),
             "zamba2-1.2b": (True, True, True)}


@pytest.mark.parametrize("tp", [2, 16])
@pytest.mark.parametrize("arch", sorted(SSM_PLANS))
def test_tp_plan_splits_the_ssm_families_where_the_specs_split(arch, tp):
    """Mamba1's d_inner, Mamba2's d_inner (its heads with it), and the
    hybrid's shared block (unstacked: its head dim at index 1), read from
    ``param_pspecs``; a group of one runs the single-device pass."""
    axes = comm.Axes(("model",), None, tp, 0, tuple(range(tp)))
    plan = pt_model.tp_plan(cb.get(arch), axes)
    assert (plan.d_inner, plan.heads, plan.ff) == SSM_PLANS[arch]
    assert plan.vocab and not plan.experts
    assert pt_model.tp_plan(cb.get_smoke(arch), comm.Axes()) is None


def test_collectives_run_on_plain_tensors_under_torch_func():
    """A recomputed block's backward runs inside torch.func.grad/vjp, where
    tensors are wrappers and every operation's result is one; gloo's CUDA
    all-gather reads the storage, which a wrapper has not. The pass's
    collectives (``comm._tp_timed``) take the tensor under the wrappers and
    run with the transforms set aside: same values, plain tensors."""
    from torch._C import _functorch
    seen = []

    @comm._tp_timed
    def collective(axes, x):
        b = x.contiguous().reshape(-1).view(torch.uint8)
        out = torch.empty_like(b)
        out.copy_(b)
        seen.append([_functorch.is_gradtrackingtensor(t) for t in (x, out)])
        return out.view(x.dtype).reshape(x.shape) + 1.0

    def f(x):
        y = torch.func.vjp(lambda t: t * 3.0, x * 2.0)[0]
        got = collective(comm.Axes(), y)
        seen.append(_functorch.is_gradtrackingtensor(y))
        seen.append(got)
        return (y * got).sum()
    g = torch.func.grad(f)(torch.arange(4.0))
    assert seen[0] == [False, False] and seen[1]
    assert not _functorch.is_gradtrackingtensor(seen[2])
    assert torch.equal(seen[2], torch.arange(4.0) * 6.0 + 1.0)
    # the collective's result is a constant to the transform
    assert torch.equal(g, 6.0 * (torch.arange(4.0) * 6.0 + 1.0))


def test_tp_plan_refuses_mamba2_heads_that_do_not_split():
    """zamba2 smoke at 16 ranks: d_inner 256 splits, its 8 heads do not;
    the reference's specs would give each rank a part of every head's
    head_dim, which the port refuses by name."""
    cfg = cb.get_smoke("zamba2-1.2b")
    specs = pt_model.param_pspecs(cfg, 16)
    assert specs["layers/mamba/in_x"][2] == "model"
    assert specs["layers/mamba/in_dt"][2] is None
    axes = comm.Axes(("model",), None, 16, 0, tuple(range(16)))
    with pytest.raises(NotImplementedError, match="by whole heads"):
        pt_model.tp_plan(cfg, axes)


# ---------------------------------------------------------------------------
# 2. head padding, no ranks
# ---------------------------------------------------------------------------

PAD_ARCHS = {"smollm-360m": (4, 4), "granite-34b": (4, 4),
             "musicgen-medium": (4, 4)}


def _logits(cfg, params, tokens):
    h, n = pt_model._embed(cfg, params, tokens)
    pos = torch.arange(h.shape[1])[None].expand(h.shape[0], -1)
    h, _ = pt_model._run_stack(cfg, params, h, pos)
    h = pt_model.L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return pt_model._logits(cfg, params["embed"].to(h.dtype), h)


def _pad_heads(cfg, params, generator):
    """An unpadded tree's attention padded to ``cfg.eff_heads``: the
    unpadded heads' wq and wo as they are, the padded heads' wq drawn from
    ``generator`` and their wo zero, wk and wv MHA-expanded
    (``model.expand_kv``)."""
    H, he = cfg.num_heads, cfg.eff_heads[0]
    out = dict(params)
    for k, t in params.items():
        if k.endswith(("attn/wk", "attn/wv")):
            out[k] = pt_model.expand_kv(cfg, t)
        elif k.endswith("attn/wq"):
            extra = torch.randn(*t.shape[:-2], he - H, t.shape[-1],
                                generator=generator) * cfg.d_model ** -0.5
            out[k] = torch.cat([t, extra], dim=-2)
        elif k.endswith("attn/wo"):
            out[k] = torch.cat([t, torch.zeros(
                *t.shape[:-3], he - H, *t.shape[-2:])], dim=-3)
    return out


@pytest.mark.parametrize("arch", sorted(PAD_ARCHS))
def test_padded_heads_give_the_unpadded_logits_exactly(arch):
    cfg = _cfg(arch)
    padded_cfg = dataclasses.replace(cfg, tp_pad_heads=2)
    assert padded_cfg.eff_heads == PAD_ARCHS[arch] != (cfg.num_heads,
                                                       cfg.num_kv_heads)
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(3))
    padded = _pad_heads(padded_cfg, params, torch.Generator().manual_seed(4))
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(5))
    assert torch.equal(_logits(padded_cfg, padded, tokens),
                       _logits(cfg, params, tokens))


@pytest.mark.parametrize("arch", sorted(PAD_ARCHS))
def test_padded_init_zeroes_the_padded_heads(arch):
    """The port's padded init, as the reference's attn_init: the padded
    heads' wk, wv and wo are zero, and a kv head's copies are equal."""
    cfg = _cfg(arch, pad=2)
    p = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
    H, he = cfg.num_heads, cfg.eff_heads[0]
    G = H // cfg.num_kv_heads
    assert p["layers/attn/wq"].shape[-2] == he
    for k in ("wk", "wv"):
        w = p[f"layers/attn/{k}"]
        assert not w[..., H:, :].any()
        for j in range(H):
            assert torch.equal(w[..., j, :], w[..., (j // G) * G, :])
    assert not p["layers/attn/wo"][:, H:].any()
    assert p["layers/attn/wo"][:, :H].all()


@pytest.mark.parametrize("arch", sorted(PAD_ARCHS))
def test_padded_loss_and_grads_match_the_reference(arch):
    """The reference's padded init, carried across by
    ``checkpoint/bridge.py``, through the port's single-device pass and the
    reference's, per client."""
    import jax
    from repro.configs import base as jax_cb
    from repro.core import distributed as jax_dist
    from repro.models import model as jax_model
    jcfg = dataclasses.replace(jax_cb.get_smoke(arch), dtype="float32",
                               tp_pad_heads=2)
    jp = jax_model.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = _cfg(arch, pad=2)
    rng = np.random.RandomState(2)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (4, 32))
             .astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (4, 32))
             .astype(np.int32)}
    if cfg.frontend is not None:
        batch["prefix_embeds"] = rng.randn(4, 8, cfg.d_model).astype(
            np.float32)
    loss, _, grads = jax.jit(lambda p, b: jax_dist.per_client_value_and_grad(
        lambda pp, bb: jax_model.train_loss(jcfg, pp, bb), p, b, 2))(
            jp, batch)
    from repro_torch.checkpoint import bridge
    params = bridge.params_from_jax(jax.device_get(jp))
    assert params["layers/attn/wq"].shape[-2] == cfg.eff_heads[0]
    got_loss, _, got = pt_dist.per_client_value_and_grad(
        lambda p, b: pt_model.train_loss(cfg, p, b), params,
        {k: torch.tensor(v) for k, v in batch.items()}, 2)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=RTOL)
    for k, w in pt_ef.flatten(grads).items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# 3. the client pass at (data 2, model 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_tensor_parallel_pass_matches_the_reference(world, name):
    inp, ranks, want = world
    arch, pad, remat, _, over = GRAD_CASES[name]
    cfg = _cfg(arch, pad, remat, **over)
    pspecs = pt_model.param_pspecs(cfg, TP)
    assert {r["coord"] for r in ranks} == {(c, m) for c in range(DP)
                                           for m in range(TP)}
    for r in ranks:
        c, m = r["coord"]
        loss, aux, grads = r["grads"][name]
        w_loss, w_aux, w_grads = want["grads"][name][c]
        np.testing.assert_allclose(loss, w_loss, rtol=RTOL)
        assert sorted(aux) == sorted(w_aux)
        for k in aux:
            np.testing.assert_allclose(aux[k], w_aux[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        assert sorted(grads) == sorted(w_grads)
        for k, g in grads.items():
            np.testing.assert_allclose(
                g, _shard_np(w_grads[k], pspecs[k], m), rtol=RTOL,
                atol=ATOL, err_msg=f"{name} rank {c, m} {k}")


def test_the_pass_splits_where_the_specs_split(world):
    """Each case's shards have the split the specs give: the padded smollm
    splits its heads, the unpadded one keeps its 3 heads whole; granite
    splits its q heads and keeps its one kv head; olmoe splits its 4
    experts, and with 3 experts their d_ff."""
    _, ranks, _ = world
    g = ranks[0]["grads"]
    assert g["smollm-pad"][2]["layers/attn/wq"].shape[-2] == 2
    assert g["smollm"][2]["layers/attn/wq"].shape[-2] == 3
    assert g["granite"][2]["layers/attn/wq"].shape[-2] == 2
    assert g["granite"][2]["layers/attn/wk"].shape[-2] == 1
    assert g["olmoe"][2]["layers/moe/w_up"].shape[1] == 2
    assert g["olmoe-3-experts"][2]["layers/moe/w_up"].shape[1:] == (
        3, 128, 32)
    assert g["gemma2-remat"][2]["embed"].shape[0] == 256
    # Mamba1: in_proj (L, d, 2·Di) halves, the rest on Di 256 -> 128
    for name in ("falcon-mamba", "falcon-mamba-remat"):
        fm = g[name][2]
        assert fm["layers/mamba/in_proj"].shape == (2, 128, 256)
        assert fm["layers/mamba/conv_w"].shape[-1] == 128
        assert fm["layers/mamba/x_proj"].shape[1] == 128
        assert fm["layers/mamba/A_log"].shape == (2, 128, 8)
        assert fm["layers/mamba/norm"].shape == (2, 128)
    # Mamba2: d_inner 256 -> 128, 8 heads -> 4, B, C and conv_w whole; the
    # shared block's 4 heads -> 2 and d_ff 256 -> 128
    for name in ("zamba2", "zamba2-remat"):
        z = g[name][2]
        assert z["layers/mamba/in_x"].shape == (4, 128, 128)
        assert z["layers/mamba/out_norm"].shape == (4, 128)
        assert z["layers/mamba/in_dt"].shape == (4, 128, 4)
        assert z["layers/mamba/A_log"].shape == (4, 4)
        assert z["layers/mamba/in_B"].shape == (4, 128, 16)
        assert z["layers/mamba/conv_w"].shape == (4, 4, 256 + 32)
        assert z["shared_attn/attn/wq"].shape == (128, 2, 32)
        assert z["shared_attn/attn/wk"].shape == (128, 2, 32)
        assert z["shared_attn/mlp/w_up"].shape == (128, 128)


def _rel_max(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_mamba2_split_norm_and_conv_gradient_catch_planted_faults(world):
    """One Mamba2 block on each 'model' pair of ranks: the split
    ``out_norm`` (mean square over the whole d_inner) and ``conv_w``'s
    gradient (whole and equal on both ranks) match the whole block's
    gradients at the test's bars; with each planted fault (an f dropped, a
    sum taken twice) the same comparison fails, by far."""
    _, ranks, _ = world
    for r in ranks:
        grads, (gx, want_x) = r["mamba2"]["sound"]
        for k, (g, w) in grads.items():
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{r['coord']} {k}")
        np.testing.assert_allclose(gx, want_x, rtol=RTOL, atol=ATOL)
        for fault in MAMBA2_FAULTS:
            grads, (gx, want_x) = r["mamba2"][fault]
            worst = max([_rel_max(g, w) for g, w in grads.values()]
                        + [_rel_max(gx, want_x)])
            assert worst > 1e-2, (fault, r["coord"], worst)
            if fault.startswith("conv_w"):
                assert _rel_max(*grads["conv_w"]) > 1e-2, fault
            else:            # the mean square's gradient reaches the input
                assert _rel_max(gx, want_x) > 1e-2, fault
    conv = [r["mamba2"]["sound"][0]["conv_w"][0] for r in ranks]
    assert all(np.array_equal(c, conv[0]) for c in conv[1:])


# ---------------------------------------------------------------------------
# 4. the per-shard round
# ---------------------------------------------------------------------------

def _client_part(part):
    return part in ("clients", "pods")


def _rank_view(steps_full, c, m, pods_slot):
    """A reference step (whole arrays) as rank (c, m) holds it."""
    out = []
    for step in steps_full:
        got = {}
        for part, leaves in step.items():
            got[part] = {}
            for k, v in leaves.items():
                name = next(n for n in SHAPES if k.endswith(n))
                if part == "clients":
                    v = v[c:c + 1]
                elif part == "pods":
                    v = v[pods_slot:pods_slot + 1]
                got[part][k] = _shard_np(v, SPLIT[name], m,
                                         1 if _client_part(part) else 0)
        out.append(got)
    return out


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_per_shard_round_matches_the_reference_shard_map(world, name):
    _, ranks, want = world
    for r in ranks:
        c, m = r["coord"]
        if "hops" in name:           # (pod 2, data 1, model 2): rank order
            c, m = divmod(ranks.index(r), TP)
        ref = _rank_view(want["rounds"][name], c, m, c)
        got = r["rounds"][name]
        assert len(got) == len(ref) == ROUND_CASES[name]["steps"] + 1
        for s, (g, w) in enumerate(zip(got, ref)):
            assert sorted(g) == sorted(w), (name, s)
            for part in w:
                assert sorted(g[part]) == sorted(w[part])
                for k in w[part]:
                    np.testing.assert_allclose(
                        g[part][k], w[part][k], rtol=1e-5, atol=1e-7,
                        err_msg=f"{name} rank {c, m} step {s} {part}/{k}")


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_client_state_is_the_single_device_round_on_the_shard_tree(world,
                                                                  name):
    """Each client's state, bit for bit the port's single-device round over
    the tree of its 'model' coordinate's shards (the two clients of that
    coordinate emulated on one device)."""
    _, ranks, _ = world
    case = ROUND_CASES[name]
    efc = pt_build.ef_config(pt_spec.RunSpec.from_dict(case["spec"]))
    params, g0, grads = _round_inputs(_seed(name))
    for m in range(TP):
        def shard(tree, lead):
            return {k: torch.tensor(np.ascontiguousarray(
                _shard_np(v, SPLIT[k], m, lead))) for k, v in tree.items()}
        state = pt_dist.init_ef_state(efc, shard(params, 0), DP,
                                      init_grads=shard(g0, 1))
        for s in range(case["steps"]):
            _, state = pt_dist.ef_round(efc, shard(grads[s], 1), state,
                                        step=s)
        want = _flat(state["clients"])
        for i, r in enumerate(ranks):
            c, rm = r["coord"] if "hops" not in name else divmod(i, TP)
            if rm != m:
                continue
            got = r["rounds"][name][-1]["clients"]
            for k, v in want.items():
                np.testing.assert_array_equal(got[k][0], v[c],
                                              err_msg=f"{name} {c, m} {k}")


@pytest.mark.parametrize("wire", WIRES)
def test_shard_wires_equal_the_reference_exactly(world, wire):
    """Mantissas, scales and indices of each (client, shard) row's wire,
    the shard's last block ragged (105 values in blocks of 8)."""
    _, ranks, want = world
    for r in ranks:
        c, m = r["coord"]
        got, ref = r["wires"][wire], want["wires"][(c, m, wire)]
        assert len(got) == len(ref)
        for g, w in zip(got, ref):
            np.testing.assert_array_equal(g.reshape(w.shape),
                                          w.astype(g.dtype))


def test_norm_and_clipping_sum_the_split_leaves_over_the_axis(world):
    """g_norm over a tree of shards (``tree_norm_sq_sharded``: the split
    leaves' squares summed over 'model', the replicated ones once) and
    ``clip_by_global_norm`` with it: the single-device tree's norm and
    clipped update, sharded."""
    _, ranks, _ = world
    params, g0, _ = _round_inputs(5)
    whole = {k: torch.tensor(v[0]) for k, v in g0.items()}
    want_sq = float(sum((t.double() ** 2).sum() for t in whole.values()))
    opt = _clip()
    p = {k: torch.tensor(v) for k, v in params.items()}
    want, _ = opt.update(whole, opt.init(p), p, 0)
    assert want_sq > 1.0            # the clip is active
    for r in ranks:
        sq, upd = r["norms"]
        np.testing.assert_allclose(sq, want_sq, rtol=1e-6)
        m = r["coord"][1]
        for k, v in upd.items():
            np.testing.assert_allclose(
                v, _shard_np(want[k].numpy(), SPLIT[k], m), rtol=1e-6,
                atol=1e-8, err_msg=k)


# ---------------------------------------------------------------------------
# 5. the Session at model 2
# ---------------------------------------------------------------------------

def test_session_at_model_2_tracks_the_reference_session(world):
    _, ranks, want = world
    ref = want["session"]
    assert ref["mesh"] == {"data": DP, "model": TP}
    for r in ranks:
        s = r["session"]
        assert s["mesh"] == {"data": DP, "model": TP}
        got = np.array(s["trajectory"])
        for i, key in enumerate(("loss", "g_norm")):
            np.testing.assert_allclose(got[:, i],
                                       [h[key] for h in ref["history"]],
                                       rtol=1e-4, err_msg=key)
        assert s["trajectory"] == ranks[0]["session"]["trajectory"]


def test_session_params_match_the_reference_session(world):
    """After the first step every parameter within rtol 1e-4. Later steps
    compress gradients that differ from the reference's in their last bits
    (the split pass sums in another order), and a Block-TopK selection or
    a quant4 mantissa near its boundary can go the other way: after step 3
    at most 1 % of the tree's entries lie outside the bar, none by more than
    0.02 (lr 0.5 times a downlink grid step); loss and g_norm stay within
    1e-4 (above)."""
    _, ranks, want = world
    cfg = _cfg("smollm-360m", pad=2)
    pspecs = pt_model.param_pspecs(cfg, TP)
    with np.load(want["session"]["npz"]) as z:
        ref3 = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
    ref1 = want["session"]["params_1"]
    for r in ranks:
        m = r["coord"][1]
        for k, v in r["session"]["params_1"].items():
            np.testing.assert_allclose(v, _shard_np(ref1[k], pspecs[k], m),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        off = total = 0
        for k, v in r["session"]["params"].items():
            w = _shard_np(ref3[k], pspecs[k], m)
            off += int((np.abs(v - w) > 1e-6 + 1e-4 * np.abs(w)).sum())
            total += v.size
            assert np.abs(v - w).max() <= 0.02, k
        assert off <= 0.01 * total, (off, total)


def test_padded_heads_stay_where_they_started(world):
    """The padded head (index 3 of 4: rank model 1's second head) keeps its
    wq, and its wk, wv, wo and their EF state stay zero."""
    _, ranks, _ = world
    for r in ranks:
        s, m = r["session"], r["coord"][1]
        if m != 1:
            continue
        np.testing.assert_array_equal(s["params"]["layers/attn/wq"][..., 1, :],
                                      s["start"]["layers/attn/wq"][..., 1, :])
        assert not s["params"]["layers/attn/wo"][:, 1].any()
        for k in ("wk", "wv"):
            assert not s["params"][f"layers/attn/{k}"][..., 1, :].any()
        for path, v in s["ef_state"].items():
            if path.endswith(("attn/wk", "attn/wv")):
                assert not v[..., 1, :].any(), path
            if path.endswith("attn/wo"):
                assert not np.take(v, 1, axis=v.ndim - 3).any(), path
        # the real heads moved
        assert not np.array_equal(s["params"]["layers/attn/wq"][..., 0, :],
                                  s["start"]["layers/attn/wq"][..., 0, :])


def test_replicated_parts_are_bit_identical_per_model_coordinate(world):
    _, ranks, _ = world
    for step in range(STEPS):
        for m in range(TP):
            digests = {r["session"]["digests"][step] for r in ranks
                       if r["coord"][1] == m}
            assert len(digests) == 1, (step, m)
        # the two coordinates hold different shards
        assert len({r["session"]["digests"][step] for r in ranks}) == TP


def test_session_kill_and_resume_is_bit_for_bit(world):
    _, ranks, _ = world
    for r in ranks:
        assert r["session"]["resumed_step"] == 2
        assert r["session"]["resume_equal"]


def _npz_matches(ranks, want, name):
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    got_path = ranks[0][name]["npz"]
    assert all(r[name]["npz"] == got_path for r in ranks)
    with np.load(got_path) as g, np.load(want[name]["npz"]) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            if k != ckpt_lib.META:
                assert g[k].shape == w[k].shape, k
    got_meta = ckpt_lib.read_meta(got_path)
    assert got_meta["spec_hash"] == ckpt_lib.read_meta(
        want[name]["npz"])["spec_hash"]
    assert got_meta["step"] == STEPS


def test_session_npz_has_the_reference_keys_shapes_and_hash(world):
    _, ranks, want = world
    _npz_matches(ranks, want, "session")


# ---------------------------------------------------------------------------
# 6. the hybrid's Session at model 2 (zamba2 smoke)
# ---------------------------------------------------------------------------

def test_zamba2_session_at_model_2_tracks_the_reference_session(world):
    """3 steps of zamba2 smoke from one initial checkpoint: loss and g_norm
    within rtol 1e-4 of the reference's Session on the same mesh, equal on
    every rank; the parameters after step 1 within rtol 1e-4, and after
    step 3 within the bar of the smollm Session above."""
    _, ranks, want = world
    ref = want["session_zamba2"]
    assert ref["mesh"] == {"data": DP, "model": TP}
    pspecs = pt_model.param_pspecs(_cfg("zamba2-1.2b"), TP)
    with np.load(ref["npz"]) as z:
        ref3 = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
    for r in ranks:
        s, m = r["session_zamba2"], r["coord"][1]
        assert s["mesh"] == {"data": DP, "model": TP}
        got = np.array(s["trajectory"])
        for i, key in enumerate(("loss", "g_norm")):
            np.testing.assert_allclose(got[:, i],
                                       [h[key] for h in ref["history"]],
                                       rtol=1e-4, err_msg=key)
        assert s["trajectory"] == ranks[0]["session_zamba2"]["trajectory"]
        for k, v in s["params_1"].items():
            np.testing.assert_allclose(
                v, _shard_np(ref["params_1"][k], pspecs[k], m), rtol=1e-4,
                atol=1e-6, err_msg=k)
        off = total = 0
        for k, v in s["params"].items():
            w = _shard_np(ref3[k], pspecs[k], m)
            off += int((np.abs(v - w) > 1e-6 + 1e-4 * np.abs(w)).sum())
            total += v.size
            assert np.abs(v - w).max() <= 0.02, k
        assert off <= 0.01 * total, (off, total)
    for step in range(STEPS):
        for m in range(TP):
            assert len({r["session_zamba2"]["digests"][step] for r in ranks
                        if r["coord"][1] == m}) == 1, (step, m)


def test_zamba2_session_kill_and_resume_is_bit_for_bit(world):
    _, ranks, _ = world
    for r in ranks:
        assert r["session_zamba2"]["resumed_step"] == 2
        assert r["session_zamba2"]["resume_equal"]


def test_zamba2_session_npz_has_the_reference_keys_shapes_and_hash(world):
    _, ranks, want = world
    _npz_matches(ranks, want, "session_zamba2")


# ---------------------------------------------------------------------------
# 6. serving and publishing at model 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_at_model_2_matches_the_reference(world, arch):
    """Session.serve on (data 2, model 2), f32, the same params and
    prompts: every rank returns the reference's tokens exactly (B 4: each
    data rank prefilled and decoded 2 rows on its shards and cache slice,
    the rows gathered) and the reference's global cache_bytes; this
    rank's slice holds half the rows and, where the pass splits them, half
    the kv heads or d_inner. Under MoE every call (the whole prefill, then
    B tokens a decode step) drops the assignments the port's one-device
    serve drops, which tests/test_torch_moe.py holds to the reference's:
    the capacity from the whole call, the queue positions offset by the
    lower data rank's counts (so the higher rank's assignments queue last
    and drop first): the two data ranks' drops of a 'model' coordinate sum
    to the call's."""
    from repro_torch.launch.session import Session
    inp, ranks, want = world
    ref = want["serve"][arch]
    for r in ranks:
        got = r["serve"][arch]
        assert got["tokens"].shape == (SERVE["B"], SERVE["steps"] + 1)
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        assert got["cache_bytes"] == ref["cache_bytes"]
        assert got["local_cache_bytes"] < got["cache_bytes"]
        assert got["local_cache_bytes"] == _ref_shard_bytes(arch, ref)
    if arch == "olmoe-1b-7b":
        one = Session(pt_spec.RunSpec.from_dict(dict(
            SESSION, arch=arch, tp_pad_heads=0, mesh="smoke", clients=DP)),
            device="cpu", dtype="float32")
        one.set_serve_params({k: torch.tensor(v) for k, v in
                              inp["serve"][arch]["params"].items()})
        drops = _serve_drops(one, inp["serve"][arch]["tokens"])["drops"]
        assert len(drops) == 2 * (1 + SERVE["steps"]) and sum(drops) > 0
        for m in range(TP):
            by_data = [r["serve"][arch]["drops"] for r in ranks
                       if r["coord"][1] == m]
            assert [sum(c) for c in zip(*by_data)] == drops


def _row_rel(got, want):
    """The largest |got - want| of a row over the row's largest |want|."""
    return float((np.abs(got - want).max(-1)
                  / np.abs(want).max(-1)).max())


def bf16_serve_readings(world):
    """SERVE_BF16's bf16 prefill logits: the port's on (data 2, model 2)
    (each data rank's rows, equal on the two ranks of a data coordinate;
    as it runs and with each PLANTED_PARTIALS fault), the reference's
    under the same mesh, and each package's on one device. Returns the
    gaps between them, each the largest over the rows of
    :func:`_row_rel`, and of each split against its package's own
    one-device logits the share of the logits it moves ("moved") and
    the root mean square of its gap over each row's largest ("rms")."""
    inp, ranks, want = world
    name = SERVE_BF16 + "/bf16"
    ref = want["serve"][name]
    rows = SERVE["B"] // DP
    many = {run: np.zeros_like(ref["logits"])
            for run in ("logits", *PLANTED_PARTIALS)}
    for r in ranks:
        got = r["serve"][name]
        np.testing.assert_array_equal(got["tokens"],
                                      ranks[0]["serve"][name]["tokens"])
        d = r["coord"][0]
        for run, logits in many.items():
            if r["coord"][1] == 0:
                logits[d * rows:(d + 1) * rows] = got[run]
            else:
                np.testing.assert_array_equal(got[run], next(
                    o["serve"][name][run] for o in ranks
                    if o["coord"] == (d, 0)))
    cfg = cb.get_smoke(SERVE_BF16)
    params = pt_model.cast_matrices(cfg, {
        k: torch.tensor(v) for k, v in inp["serve"][name]["params"].items()})
    tokens = torch.tensor(inp["serve"][name]["tokens"])
    cache = pt_model.init_cache(cfg, *tokens.shape)
    one = pt_model.prefill(cfg, params, {"tokens": tokens},
                           cache)[0][:, -1].numpy()

    def rms(got, want):
        return float(np.sqrt((((got - want) / np.abs(want).max(
            -1, keepdims=True)) ** 2).mean()))
    out = {
        "port": _row_rel(many["logits"], one),
        "reference": _row_rel(ref["logits"], ref["one_logits"]),
        "port vs reference, split": _row_rel(many["logits"], ref["logits"]),
        "port vs reference, one device": _row_rel(one, ref["one_logits"]),
        "moved, reference": float((ref["logits"]
                                   != ref["one_logits"]).mean()),
        "rms, reference": rms(ref["logits"], ref["one_logits"])}
    for run in ("logits", *PLANTED_PARTIALS):
        key = "port" if run == "logits" else f"planted {run}"
        out[f"moved, {key}"] = float((many[run] != one).mean())
        out[f"rms, {key}"] = rms(many[run], one)
    return out


def test_bf16_serve_at_model_2_matches_the_reference(world):
    """SERVE_BF16 served in bf16 on (data 2, model 2) from the same params
    and prompts in both packages.

    One device: the packages' logits within SERVE_BF16_TOL of each row's
    largest (tests/test_torch_serve.py's bar; the reference's XLA-CPU
    rounds each step of SiLU to bf16, the port once). The split: the
    port's logits within that one-device gap plus SERVE_BF16_TOL of the
    reference's on the same mesh, and each package's split within
    SERVE_BF16_TOL of its own one device (chip_smoke.py's MT-serve bar).

    Where the split rounds: both packages round each rank's row-parallel
    partial product to bf16 before the f32 sum over 'model' (the
    reference's compiled prefill converts the w_down product to bf16 and
    back before its all-reduce, then rounds the sum). So the port's split
    moves the reference's share of the logits off one device within
    SPLIT_MOVED (0.7529 against 0.7744 at smoke size), and its rms gap
    within SPLIT_RMS of the reference's (1.085 times). Each
    PLANTED_PARTIALS fault leaves one of the bands: the partial kept in
    f32 moves 0.1543 at 0.34 times the rms; the blocked bf16 accumulator
    moves 0.8613 at 1.72 times. One extra rounding of a partial, of the
    size of the one both packages make, stays inside the bands: the
    split's first perturbation has grown to the bf16 floor of the next
    layer by the logits, which so tell rounding from none and a growing
    accumulator's error from one rounding, not one rounding from two."""
    got = bf16_serve_readings(world)
    print(f"bf16 serve on (data 2, model 2), readings: {got}")
    one = got["port vs reference, one device"]
    assert one <= SERVE_BF16_TOL, got
    assert got["port vs reference, split"] <= one + SERVE_BF16_TOL, got
    assert got["port"] <= SERVE_BF16_TOL, got
    assert got["reference"] <= SERVE_BF16_TOL, got

    def as_reference(key):
        return (abs(got[f"moved, {key}"] - got["moved, reference"])
                <= SPLIT_MOVED
                and abs(got[f"rms, {key}"] / got["rms, reference"] - 1)
                <= SPLIT_RMS)
    assert as_reference("port"), got
    for fault in PLANTED_PARTIALS:
        assert not as_reference(f"planted {fault}"), (fault, got)


def _ref_shard_bytes(arch, ref):
    """A device's cache bytes under the reference's layout, in the port's
    terms: the reference's shard of every leaf, except a hybrid's conv
    state, whose 'model' split the port takes in another order (d_inner/n
    columns, then B and C's 2N whole, where the reference's slice is
    (d_inner + 2N)/n columns)."""
    total = sum(ref["shard_bytes"].values())
    cfg = _cfg(arch)
    if cfg.family == "hybrid":
        conv = ref["shard_bytes"]["conv"]
        di, two_n = cfg.d_inner, 2 * cfg.ssm_state
        total += conv * (di // TP + two_n) // ((di + two_n) // TP) - conv
    return total


@pytest.mark.parametrize("arch", sorted(SERVE_B1))
def test_one_row_serve_splits_the_sequence_over_every_rank(world, arch):
    """B 1 at (data 2, model 2): the row does not divide the data ranks,
    so every rank serves it and the cache's sequence splits over ('data',
    'model') (the kv heads do not split: smollm's 1 of 3, granite's 1 of
    4 under split q heads; gemma2's 2 kv heads do split over 'model', so
    its sequence splits over 'data' alone); each rank holds a quarter of
    the cache (gemma2: half of every layer's slots, its ring's too, and
    half its kv heads), and the decode merges the ranks' softmax sums. The tokens equal the reference's on the same
    mesh, and each rank's cache bytes its shard's. Decode makes 3
    all-reduces a layer a step over the sequence axes (max, sum, P·V)."""
    inp, ranks, want = world
    name = arch + "/B1"
    ref = want["serve"][name]
    for r in ranks:
        got = r["serve"][name]
        assert got["tokens"].shape == (1, SERVE["steps"] + 1)
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        assert got["cache_bytes"] == ref["cache_bytes"]
        assert got["local_cache_bytes"] == _ref_shard_bytes(arch, ref)
        assert got["local_cache_bytes"] * N == got["cache_bytes"]
        cfg = _cfg(arch)
        seq = "data" if arch == "gemma2-9b" else "data+model"
        merges = got["kinds"]["all-reduce"]["groups"].get(seq, 0)
        assert merges == 3 * cfg.num_layers * SERVE["steps"], got["kinds"]


def _records(root):
    from repro_torch.core import stream as pt_stream
    log = pt_stream.WireLog(root)
    out = {}
    for step, groups in sorted(log.listing().items()):
        for g in groups:
            with np.load(log.record_path(step, g)) as z:
                out[step, g] = {k: z[k] for k in z.files}
    return out, sorted(os.listdir(log.bootstrap_dir))


def test_dense_publish_at_model_2_writes_the_reference_records(world):
    """One published step with a dense downlink on (data 2, model 2): the
    first rank publishes the server estimate gathered over 'model', so
    the record set has the reference's legs, keys, header, shapes and
    dtypes, and its payload is the reference's within the bar of the two
    trainers' step-1 state (rtol 1e-4, atol 1e-6); both streams hold the
    step-0 bootstrap."""
    _, ranks, want = world
    assert all(r["publish"]["dense"] is None for r in ranks)
    assert want["publish"]["dense"] is None
    got, boot = _records(os.path.join(ranks[0]["publish"]["dir"],
                                      "wire_dense"))
    ref, ref_boot = _records(os.path.join(want["publish"]["dir"],
                                          "ref_wire_dense"))
    assert boot == ref_boot == ["step_00000000.npz"]
    assert sorted(got) == sorted(ref) == [(1, 0)]
    for key, rec in got.items():
        assert sorted(rec) == sorted(ref[key])
        assert bytes(rec["__meta__"]) == bytes(ref[key]["__meta__"])
        for k, v in rec.items():
            if k == "__meta__":
                continue
            assert (v.shape, v.dtype) == (ref[key][k].shape,
                                          ref[key][k].dtype), k
            np.testing.assert_allclose(v, ref[key][k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_compressed_publish_at_model_2_raises_on_every_rank(world):
    """With the fused_quant4 downlink the reference's Publisher re-encodes
    the step's broadcast on the single-device partition, which the
    per-shard round did not use, and refuses the step; the port's first
    rank verifies the gathered trees the same way, and every rank raises
    the same StreamIntegrityError at step 1 (none hangs in a collective).
    The bootstrap is written and no record."""
    _, ranks, want = world
    kind, msg, step = want["publish"]["fused_quant4"]
    assert (kind, step) == ("StreamIntegrityError", 1)
    assert "step 1 group '*'" in msg
    errs = [r["publish"]["fused_quant4"] for r in ranks]
    assert all(e is not None and e[0] == "StreamIntegrityError"
               and e[2] == 1 for e in errs), errs
    assert len({e[1] for e in errs}) == 1 and "step 1 group '*'" in errs[0][1]
    got, boot = _records(os.path.join(ranks[0]["publish"]["dir"],
                                      "wire_fused_quant4"))
    assert got == {} and boot == ["step_00000000.npz"]


def test_a_publisher_that_skips_the_gather_is_caught(world):
    """Planted: the first rank publishes its own 'model' shards. Its
    re-encode then reproduces the per-shard round, and the step publishes
    where the reference refuses it: the test above would fail."""
    _, ranks, _ = world
    assert ranks[0]["publish"]["gather-skipped"] is None
