"""Client granularity 'pod' and state sharding 'zero' in the port on the
CPU, against the reference.

Under 'pod' one EF client is one pod (n = the pods; one client on a mesh
without a pod axis): its rows are split over the pod's data ranks, each
rank's pass returns an additive share of the client's loss, and the
shares' gradients are summed over that data group before the round, which
aggregates over 'pod' only. MoE keeps the reference's routing of the
client's whole token set (capacity, queue positions, ``ce``). 'zero' runs
where the reference runs it and is refused where the reference's round
fails.

The 4 gloo ranks are spawned once for the module (``multiproc.spawn``, one
torch thread a rank), and ONE reference subprocess runs beside them on 4
forced host devices; each narrows the production geometry in its own
process (``PROD_DATA``, ``MESH_GEOM``) for the meshes (pod 2, data 2, model
1), (pod 2, data 1, model 2), (data 4, model 1) and (data 2, model 2).
Every Session starts from one initial checkpoint the port's single-device
Session writes (both packages restore it) and runs smollm-360m (or
olmoe-1b-7b) smoke in f32, batch 8, seq 32. Bars:

- (pod 2, data 2, model 1), 'pod', on ``quant4`` and on
  ``fused_quant8``/``fused_quant4``: loss and g_norm within rtol 1e-4 of
  the reference's Session at every step, and within rtol 1e-3 of the
  port's own 2-client single-device run (the reference's pod run is its
  2-client smoke run bit for bit; the port's split pass sums a client's
  gradient in another order than its vmap pass, and at step 2 of the fused
  run one uplink entry and then quant4 mantissas of the downlink go the
  other way, which moves g_norm by 1.2e-4); the parameters after the
  last step: at most 1 % of the
  entries beyond 1e-5 + 1e-4·|ref|, none beyond 0.02 (split rows sum in
  another order and can flip a Block-TopK selection or a quant4
  mantissa); the client state equal bit for bit across each pod's two
  data ranks and ``replicated_digest`` equal on all four ranks. A planted
  fault, the shares' gradients not summed, must break the last two and the
  1e-4 bar.
- olmoe-1b-7b smoke, 'pod' on (2, 2, 1): at the initial parameters, each
  client's drop count (over its layers) equal to the reference's exactly,
  at a batch and sequence where the reference drops assignments; the
  client's loss within rtol 1e-4, its gradients within rtol 1e-4, atol
  1e-6 of the reference's pass over the client's rows; a planted fault,
  the capacity taken from each rank's own tokens, gives other drop counts;
  the ``dense`` impl's loss and gradients within the same bars; a Session
  of 2 steps within rtol 1e-4 of the reference's.
- 'pod' on the pod mesh (data 4, model 1): one client, loss and g_norm
  within rtol 1e-4 of the reference over 2 steps.
- ZeRO: 'pod' + 'zero' on (2, 1, 2) equals 'pod' + 'client' there bit for
  bit (loss, g_norm, params, client state) and the reference within rtol
  1e-4; 'group' + 'zero' on the pod mesh (data 2, model 2) equals 'group'
  + 'client' bit for bit; 'pod' + 'zero' on (2, 2, 1): the port raises
  its ValueError where it builds the training state, the reference's
  ``step_once`` raises its TypeError (both pinned).
- Checkpoints of the (2, 2, 1) 'pod' run: the npz's keys and shapes equal
  the reference's save of its run (the clients leading 2); saved at step
  1 and restored on the 4 ranks, the next steps equal the uninterrupted
  run bit for bit; the reference's step-1 checkpoint restored into the
  port's run gives the reference's step 2 within rtol 1e-4.
- The spec: ``quant4_multipod_zero.json`` loads with the reference's
  ``spec_hash``; ``--granularity``/``--state-sharding`` parse to the
  reference's spec.
"""
import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cb
from repro_torch.core import distributed as pt_dist
from repro_torch.core import ef as pt_ef
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import multiproc
from repro_torch.launch import shardings as sh
from repro_torch.launch import spec as pt_spec
from repro_torch.models import model as pt_model

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
SRC = os.path.join(ROOT, "src")
N = 4
STEPS = 3
RTOL = 1e-4
SINGLE_RTOL = 1e-3         # against the port's single-device run

BASE = {"version": 5, "smoke": True, "seq_len": 32, "global_batch": 8,
        "eta": 0.5, "mesh": "multi_pod", "client_granularity": "pod"}
QUANT4 = dict(BASE, carrier="quant4")
FUSED = dict(BASE, carrier="fused_quant8", downlink_carrier="fused_quant4")
OLMOE = dict(QUANT4, arch="olmoe-1b-7b")
PADDED = dict(QUANT4, tp_pad_heads=2)
# (spec, mesh geometry, steps): the Sessions both packages run
SESSIONS = {
    "quant4": (QUANT4, "2-2-1", STEPS),
    "fused": (FUSED, "2-2-1", 2),
    "olmoe": (OLMOE, "2-2-1", 2),
    "pod-mesh": (dict(QUANT4, mesh="pod"), "4-1", 2),
    "pod-zero-212": (dict(PADDED, state_sharding="zero"), "2-1-2", 2),
}
# the port alone: the runs each ZeRO run must equal bit for bit, and the
# planted fault
PORT_ONLY = {
    "pod-client-212": (PADDED, "2-1-2", 2),
    "group-client-22": (dict(PADDED, mesh="pod", client_granularity="group"),
                        "2-2", 2),
    "group-zero-22": (dict(PADDED, mesh="pod", client_granularity="group",
                           state_sharding="zero"), "2-2", 2),
    "unsummed": (QUANT4, "2-2-1", 2),
}
# the initial checkpoint each run restores (state trees of one shape)
CKPT0 = {"quant4": (QUANT4, 2), "fused": (FUSED, 2), "olmoe": (OLMOE, 2),
         "padded": (PADDED, 2), "one": (QUANT4, 1)}
START = {"quant4": "quant4", "fused": "fused", "olmoe": "olmoe",
         "pod-mesh": "one", "pod-zero-212": "padded",
         "pod-client-212": "padded", "group-client-22": "padded",
         "group-zero-22": "padded", "unsummed": "quant4"}
# the MoE pass: olmoe smoke at capacity factor 1.25 (the config's), 4 rows
# of 32 a client: the reference drops assignments there
MOE_IMPLS = ("dispatch", "dense")


def _geometry(mod_mesh, mod_spec, geom):
    """Narrow one package's production geometry to ``geom`` (in this
    process): PROD_DATA, and MESH_GEOM for the spec's client count."""
    if geom == "2-1-2":
        mod_mesh.PROD_DATA = 1
        mod_spec.MESH_GEOM["multi_pod"] = {"pod": 2, "data": 1, "model": 2}
    elif geom == "2-2":
        mod_mesh.PROD_DATA = 2
        mod_spec.MESH_GEOM["pod"] = {"data": 2, "model": 2}
    else:                       # (2, 2, 1) and (4, 1): the shrink alone
        mod_mesh.PROD_DATA = 16
        mod_spec.MESH_GEOM["multi_pod"] = {"pod": 2, "data": 16,
                                           "model": 16}
        mod_spec.MESH_GEOM["pod"] = {"data": 16, "model": 16}


def _moe_inputs():
    cfg = dataclasses.replace(cb.get_smoke("olmoe-1b-7b"), dtype="float32")
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(7))
    rng = np.random.RandomState(3)
    batch = {k: rng.randint(0, cfg.vocab_size, (8, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    return {"params": {k: v.numpy() for k, v in params.items()},
            "batch": batch}


# ---------------------------------------------------------------------------
# the 4 ranks
# ---------------------------------------------------------------------------

def _flat(tree):
    return {k: v.float().numpy().copy() for k, v in pt_ef.flatten(tree).items()}


@contextlib.contextmanager
def _unsummed():
    """The planted fault: a pod client's gradient is this rank's share
    alone (the data group's shares never summed)."""
    saved = pt_dist.sum_shares
    pt_dist.sum_shares = lambda axes, grads: grads
    try:
        yield
    finally:
        pt_dist.sum_shares = saved


def _rank_session(name, fields, geom, steps, ckpt0, workdir):
    from repro_torch.launch.session import Session
    _geometry(mesh_lib, pt_spec, geom)
    sess = Session(pt_spec.RunSpec.from_dict(fields), device="cpu",
                   dtype="float32")
    sess.restore_from(ckpt0, allow_spec_mismatch=True)
    out = {"mesh": dict(sess.mesh.shape), "n": sess.n_clients,
           "coord": sess.mesh.coordinate(), "trajectory": [],
           "digests": []}
    cut = os.path.join(workdir, name, "cut")
    os.makedirs(cut, exist_ok=True)
    with _unsummed() if name == "unsummed" else contextlib.nullcontext():
        for _ in range(steps):
            m = sess.step_once()
            out["trajectory"].append((float(m["loss"]), float(m["g_norm"])))
            out["digests"].append(sh.replicated_digest(sess.params,
                                                       sess.ef_state))
            if name == "quant4" and sess.step == 1:
                sess.save(os.path.join(cut, "step_00000001.npz"))
    out["params"] = {k: v.numpy().copy() for k, v in sess.params.items()}
    out["clients"] = _flat(sess.ef_state["clients"])
    if name == "quant4":
        out["npz"] = sess.save(os.path.join(workdir, name, "final.npz"))
        resumed = Session.resume(cut, device="cpu", dtype="float32")
        out["resumed_step"] = resumed.step
        resumed.train(steps, log_every=0)
        a = pt_ef.flatten({"params": sess.params, "ef_state": sess.ef_state,
                           "opt_state": sess.opt_state})
        b = pt_ef.flatten({"params": resumed.params,
                           "ef_state": resumed.ef_state,
                           "opt_state": resumed.opt_state})
        out["resume_equal"] = sorted(a) == sorted(b) and all(
            torch.equal(a[k], b[k]) for k in a)
    return out


def _wait_for(path, timeout_s=240.0):
    t0 = time.time()
    while not os.path.exists(path + ".done"):
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"{path} not written in {timeout_s:.0f} s")
        time.sleep(0.5)
    return path


def _rank_from_reference(ref_ckpt, ckpt0):
    """The reference's checkpoint after its step 1 restored into the
    port's (2, 2, 1) run, then one step."""
    from repro_torch.launch.session import Session
    _geometry(mesh_lib, pt_spec, "2-2-1")
    sess = Session(pt_spec.RunSpec.from_dict(QUANT4), device="cpu",
                   dtype="float32")
    sess.restore_from(_wait_for(ref_ckpt))
    m = sess.step_once()
    return {"step": sess.step, "loss": float(m["loss"]),
            "g_norm": float(m["g_norm"])}


def _rank_zero_refused(ckpt0):
    """'pod' + 'zero' on (2, 2, 1): the Session builds, the training state
    is refused."""
    from repro_torch.launch.session import Session
    _geometry(mesh_lib, pt_spec, "2-2-1")
    sess = Session(pt_spec.RunSpec.from_dict(
        dict(QUANT4, state_sharding="zero")), device="cpu", dtype="float32")
    try:
        sess.step_once()
    except ValueError as err:
        return str(err)
    return None


def _rank_moe(inp):
    """Each impl's split pass over this rank's sub-block of its pod
    client's rows (loss and gradients summed over the data group, the aux
    shares summed here),
    and the planted fault: capacity and queues from the rank's own tokens
    (no data group), its drop count summed over the group."""
    from repro_torch.core import comm
    _geometry(mesh_lib, pt_spec, "2-2-1")
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    c_axes = mesh.client_axes("pod")
    group = mesh.axes(mesh.split_axes(c_axes))
    params = {k: torch.tensor(v) for k, v in inp["params"].items()}
    batch = {k: torch.tensor(v) for k, v in inp["batch"].items()}
    out = {}
    for impl in MOE_IMPLS:
        cfg = dataclasses.replace(cb.get_smoke("olmoe-1b-7b"),
                                  dtype="float32", moe_impl=impl)
        loss, aux, g = pt_dist.sharded_value_and_grad(
            lambda p, b: pt_model.train_loss(cfg, p, b, split=group),
            params, pt_dist.rank_rows(batch, mesh, c_axes), mesh, c_axes)
        out[impl] = (float(loss),
                     {k: float(comm.share_sum(group, v))
                      for k, v in aux.items()},
                     {k: v[0].numpy().copy() for k, v in g.items()})
    cfg = dataclasses.replace(cb.get_smoke("olmoe-1b-7b"), dtype="float32")
    pod = mesh.axes(c_axes)
    rows = pt_dist.client_rows(pt_dist.client_rows(batch, 2, pod.index),
                               group.size, group.index)
    with torch.no_grad():
        _, aux = pt_model.train_loss(cfg, params, rows)
    own = aux["dropped_frac"] * rows["tokens"].numel() \
        * cfg.num_experts_per_tok
    out["own_capacity_drops"] = round(float(comm.share_sum(group, own)))
    out["pod"] = pod.index
    return out


def _rank_work(rank, inp_path, workdir, ckpt0, ref_ckpt):
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = {"moe": _rank_moe(inp), "zero_refused": _rank_zero_refused(
        ckpt0["quant4"])}
    for name, (fields, geom, steps) in {**SESSIONS, **PORT_ONLY}.items():
        out[name] = _rank_session(name, fields, geom, steps,
                                  ckpt0[START[name]], workdir)
    out["from_reference"] = _rank_from_reference(ref_ckpt, ckpt0)
    return out


# ---------------------------------------------------------------------------
# the reference, in one subprocess on 4 forced host devices
# ---------------------------------------------------------------------------

def _reference_main(inp_path, ckpt0, ref_ckpt, out_path, workdir):
    """Run in the subprocess (XLA_FLAGS set before jax loads)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jax_cb
    from repro.launch import mesh as jax_mesh
    from repro.launch import session as jax_session
    from repro.launch import spec as jax_spec
    from repro.models import model as jax_model
    from test_torch_ef_round import _nest
    assert len(jax.devices()) == N, jax.devices()
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = {}

    def session(fields, geom):
        _geometry(jax_mesh, jax_spec, geom)
        jsess = jax_session.Session(jax_spec.RunSpec.from_dict(fields))
        jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
        return jsess

    # first the run whose step-1 checkpoint the ranks restore
    for name, (fields, geom, steps) in SESSIONS.items():
        jsess = session(fields, geom)
        jsess.restore_from(ckpt0[START[name]], allow_spec_mismatch=True)
        history = jsess.train(1, log_every=1)
        if name == "quant4":
            jsess.save(ref_ckpt)
            open(ref_ckpt + ".done", "w").close()
        history += jsess.train(steps, log_every=1)
        out[name] = {"history": history, "mesh": dict(jsess.mesh.shape),
                     "params": {k: np.asarray(v) for k, v in pt_ef.flatten(
                         jax.device_get(jsess.params)).items()}}
        if name == "quant4":
            out[name]["npz"] = jsess.save(
                os.path.join(workdir, "ref_quant4_final.npz"))

    # 'pod' + 'zero' on (2, 2, 1): the reference's round fails
    jsess = session(dict(QUANT4, state_sharding="zero"), "2-2-1")
    jsess.restore_from(ckpt0["quant4"], allow_spec_mismatch=True)
    try:
        jsess.step_once()
        out["zero_error"] = None
    except Exception as err:                          # noqa: BLE001
        out["zero_error"] = (type(err).__name__, str(err))

    # the MoE pass: each client's unsplit pass over its rows
    params = jax.tree_util.tree_map(jnp.asarray, _nest(inp["params"]))
    batch = inp["batch"]
    out["moe"] = {}
    for impl in MOE_IMPLS:
        cfg = dataclasses.replace(jax_cb.get_smoke("olmoe-1b-7b"),
                                  dtype="float32", moe_impl=impl)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: jax_model.train_loss(cfg, p, b), has_aux=True))
        per = []
        for c in range(2):
            rows = {k: jnp.asarray(v[c * 4:(c + 1) * 4])
                    for k, v in batch.items()}
            (loss, aux), g = fn(params, rows)
            per.append((float(loss), {k: float(v) for k, v in aux.items()},
                        {k: np.asarray(v) for k, v in
                         pt_ef.flatten(g).items()}))
        out["moe"][impl] = per
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs and the initial checkpoints (the port's single-device
    Sessions at step 0: both packages restore them), then the reference
    subprocess, the port's 2-client single-device runs while it starts,
    and the 4 ranks beside it."""
    from repro_torch.launch.session import Session
    tmp = tmp_path_factory.mktemp("pod")
    inp_path = str(tmp / "inputs.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(_moe_inputs(), f)
    ckpt0, inits = {}, {}
    with torch_threads(1):
        for name, (fields, clients) in CKPT0.items():
            init = Session(pt_spec.RunSpec.from_dict(dict(
                fields, mesh="smoke", clients=clients)), device="cpu",
                dtype="float32")
            ckpt0[name] = init.save(str(tmp / f"{name}_step_0.npz"))
            if name in ("quant4", "fused"):
                inits[name] = init
    ref_ckpt = str(tmp / "ref_quant4_step_1.npz")
    ref_out = str(tmp / "reference.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               f"={N}", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    ref = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_pod_clients as t; "
         f"t._reference_main({inp_path!r}, {ckpt0!r}, {ref_ckpt!r}, "
         f"{ref_out!r}, {str(tmp)!r})"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        with torch_threads(1):
            single = {name: [(float(m["loss"]), float(m["g_norm"]))
                             for m in (init.step_once()
                                       for _ in range(SESSIONS[name][2]))]
                      for name, init in inits.items()}
        del inits
        ranks = multiproc.spawn(_rank_work, N, str(tmp / "mp"),
                                args=(inp_path, str(tmp / "port"), ckpt0,
                                      ref_ckpt), timeout_s=300)
        log = ref.communicate(timeout=300)[0]
    finally:
        ref.kill()
    assert ref.returncode == 0, log[-4000:]
    with open(ref_out, "rb") as f:
        want = pickle.load(f)
    return ranks, want, single


@contextlib.contextmanager
def torch_threads(n):
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _traj(ref):
    return np.array([(h["loss"], h["g_norm"]) for h in ref["history"]])


# ---------------------------------------------------------------------------
# 1. pod clients on (pod 2, data 2, model 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["quant4", "fused"])
def test_pod_clients_track_the_reference(world, name):
    ranks, want, single = world
    assert want[name]["mesh"] == {"pod": 2, "data": 2, "model": 1}
    for r in ranks:
        s = r[name]
        assert (s["mesh"], s["n"]) == ({"pod": 2, "data": 2, "model": 1}, 2)
        assert s["trajectory"] == ranks[0][name]["trajectory"]
        got = np.array(s["trajectory"])
        np.testing.assert_allclose(got, _traj(want[name]), rtol=RTOL)
        np.testing.assert_allclose(got, np.array(single[name]),
                                   rtol=SINGLE_RTOL)


def _params_bar(got, ref):
    """At most 1 % of the entries beyond 1e-5 + 1e-4·|ref|, none beyond
    0.02; returns (entries off, entries)."""
    off = total = 0
    for k, v in got.items():
        w = ref[k]
        off += int((np.abs(v - w) > 1e-5 + 1e-4 * np.abs(w)).sum())
        total += v.size
        assert np.abs(v - w).max() <= 0.02, k
    assert off <= 0.01 * total, (off, total)
    return off, total


@pytest.mark.parametrize("name", ["quant4", "fused"])
def test_pod_client_params_match_the_reference(world, name):
    ranks, want, _ = world
    for r in ranks:
        _params_bar(r[name]["params"], want[name]["params"])


def _pods_agree(ranks, name):
    """Client states equal bit for bit across each pod's data ranks, and
    the replicated digests equal on every rank, every step."""
    by_pod = {}
    for r in ranks:
        by_pod.setdefault(r[name]["coord"].get("pod", 0), []).append(
            r[name]["clients"])
    same = all(sorted(a) == sorted(b) and all(
        np.array_equal(a[k], b[k]) for k in a)
        for states in by_pod.values() for a, b in zip(states, states[1:]))
    digests = all(len({r[name]["digests"][s] for r in ranks}) == 1
                  for s in range(len(ranks[0][name]["digests"])))
    return same and digests


@pytest.mark.parametrize("name", ["quant4", "fused"])
def test_pod_client_state_is_one_per_pod(world, name):
    ranks, _, _ = world
    assert _pods_agree(ranks, name)
    # the two pods are two clients
    pods = {r[name]["coord"]["pod"]: r[name]["clients"] for r in ranks}
    assert not all(np.array_equal(pods[0][k], pods[1][k]) for k in pods[0])


def test_unsummed_shares_fail_the_checks(world):
    """The planted fault: each data rank keeps its own share of the pod
    client's gradient. The pods' data ranks then disagree, and the run
    leaves the reference's 1e-4."""
    ranks, want, _ = world
    assert not _pods_agree(ranks, "unsummed")
    got = np.array(ranks[0]["unsummed"]["trajectory"])
    ref = _traj(want["quant4"])[:len(got)]
    assert np.abs(got - ref).max() / np.abs(ref).max() > RTOL


# ---------------------------------------------------------------------------
# 2. MoE over the client's whole token set
# ---------------------------------------------------------------------------

def _drops(aux, tokens=4 * 32, k=2):
    return round(aux["dropped_frac"] * tokens * k)


@pytest.mark.parametrize("impl", MOE_IMPLS)
def test_moe_split_pass_is_the_clients_pass(world, impl):
    """Loss and aux within rtol 1e-4, gradients within rtol 1e-4, atol
    1e-6, and (dispatch) the drop counts exactly, against the reference's
    pass over each client's rows; the reference drops assignments."""
    ranks, want, _ = world
    for r in ranks:
        c = r["moe"]["pod"]
        loss, aux, g = r["moe"][impl]
        w_loss, w_aux, w_g = want["moe"][impl][c]
        np.testing.assert_allclose(loss, w_loss, rtol=RTOL)
        for k in ("load_balance", "router_z"):
            np.testing.assert_allclose(aux[k], w_aux[k], rtol=RTOL)
        for k, v in g.items():
            np.testing.assert_allclose(v, w_g[k], rtol=RTOL, atol=1e-6,
                                       err_msg=k)
        assert _drops(aux) == _drops(w_aux)
        if impl == "dispatch":
            assert _drops(w_aux) > 0


def test_moe_capacity_of_the_ranks_own_tokens_drops_otherwise(world):
    ranks, want, _ = world
    for r in ranks:
        c = r["moe"]["pod"]
        assert r["moe"]["own_capacity_drops"] != \
            _drops(want["moe"]["dispatch"][c][1])


def test_moe_session_tracks_the_reference(world):
    ranks, want, _ = world
    for r in ranks:
        np.testing.assert_allclose(np.array(r["olmoe"]["trajectory"]),
                                   _traj(want["olmoe"]), rtol=RTOL)


# ---------------------------------------------------------------------------
# 3. one client on the pod mesh
# ---------------------------------------------------------------------------

def test_pod_granularity_on_the_pod_mesh_is_one_client(world):
    ranks, want, _ = world
    assert want["pod-mesh"]["mesh"] == {"data": 4, "model": 1}
    for r in ranks:
        s = r["pod-mesh"]
        assert (s["mesh"], s["n"]) == ({"data": 4, "model": 1}, 1)
        np.testing.assert_allclose(np.array(s["trajectory"]),
                                   _traj(want["pod-mesh"]), rtol=RTOL)
    assert _pods_agree(ranks, "pod-mesh")


# ---------------------------------------------------------------------------
# 4. ZeRO as the reference runs it
# ---------------------------------------------------------------------------

def _same_run(a, b):
    return a["trajectory"] == b["trajectory"] \
        and all(np.array_equal(a["params"][k], b["params"][k])
                for k in a["params"]) \
        and all(np.array_equal(a["clients"][k], b["clients"][k])
                for k in a["clients"])


def test_pod_zero_with_one_data_rank_is_the_client_run(world):
    ranks, want, _ = world
    assert want["pod-zero-212"]["mesh"] == {"pod": 2, "data": 1, "model": 2}
    for r in ranks:
        assert r["pod-zero-212"]["mesh"] == {"pod": 2, "data": 1,
                                             "model": 2}
        assert _same_run(r["pod-zero-212"], r["pod-client-212"])
        np.testing.assert_allclose(np.array(r["pod-zero-212"]["trajectory"]),
                                   _traj(want["pod-zero-212"]), rtol=RTOL)


def test_group_zero_is_the_client_run(world):
    ranks, _, _ = world
    for r in ranks:
        assert r["group-zero-22"]["mesh"] == {"data": 2, "model": 2}
        assert _same_run(r["group-zero-22"], r["group-client-22"])


def test_pod_zero_over_two_data_ranks_is_refused_as_the_reference_fails(
        world):
    ranks, want, _ = world
    kind, msg = want["zero_error"]
    assert kind == "TypeError" and "incompatible shapes" in msg
    for r in ranks:
        err = r["zero_refused"]
        assert err is not None and "TypeError" in err
        assert "state_sharding='zero'" in err and "standing facts" in err


# ---------------------------------------------------------------------------
# 5. checkpoints
# ---------------------------------------------------------------------------

def test_pod_npz_has_the_reference_keys_and_shapes(world):
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    ranks, want, _ = world
    got = ranks[0]["quant4"]["npz"]
    assert all(r["quant4"]["npz"] == got for r in ranks)
    with np.load(got) as g, np.load(want["quant4"]["npz"]) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            if k != ckpt_lib.META:
                assert g[k].shape == w[k].shape, k
        lead = {g[k].shape[0] for k in g.files
                if k.startswith("ef_state/clients/")}
        assert lead == {2}
    assert ckpt_lib.read_meta(got)["spec_hash"] == \
        ckpt_lib.read_meta(want["quant4"]["npz"])["spec_hash"]


def test_pod_restore_and_resume_continue_bit_for_bit(world):
    ranks, _, _ = world
    for r in ranks:
        assert r["quant4"]["resumed_step"] == 1
        assert r["quant4"]["resume_equal"]


def test_the_reference_checkpoint_restores_into_the_pod_run(world):
    ranks, want, _ = world
    ref2 = want["quant4"]["history"][1]
    for r in ranks:
        got = r["from_reference"]
        assert got["step"] == 2
        np.testing.assert_allclose([got["loss"], got["g_norm"]],
                                   [ref2["loss"], ref2["g_norm"]],
                                   rtol=RTOL)


# ---------------------------------------------------------------------------
# 6. the spec and the shard plan, no ranks
# ---------------------------------------------------------------------------

def test_quant4_multipod_zero_loads_with_the_reference_hash():
    from repro.launch import spec as jax_spec
    with open(os.path.join(ROOT, "results", "specs",
                           "quant4_multipod_zero.json")) as f:
        d = json.load(f)
    spec = pt_spec.RunSpec.from_dict(d)
    assert (spec.client_granularity, spec.state_sharding) == ("pod", "zero")
    assert spec.spec_hash() == jax_spec.RunSpec.from_dict(d).spec_hash()
    assert spec.n_clients_preview() == \
        jax_spec.RunSpec.from_dict(d).n_clients_preview() == 2


@pytest.mark.parametrize("argv", [
    ["--granularity", "pod", "--state-sharding", "zero", "--mesh",
     "multi_pod"],
    ["--granularity", "pod", "--mesh", "pod", "--global-batch", "4"],
    ["--state-sharding", "zero"],
])
def test_granularity_flags_parse_to_the_reference_spec(argv):
    import argparse
    from repro.launch import spec as jax_spec
    ap = argparse.ArgumentParser()
    pt_spec.add_flags(ap)
    got = pt_spec.from_args(ap.parse_args(argv))
    jap = argparse.ArgumentParser()
    jax_spec.add_flags(jap)
    want = jax_spec.RunSpec.from_args(jap.parse_args(argv))
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.spec_hash() == want.spec_hash()


@pytest.mark.parametrize("geom,plan,refused", [
    ((2, 16, 16), ("pod", "zero"), True),      # the shipped spec's layout
    ((2, 2, 1), ("pod", "zero"), True),
    ((2, 1, 2), ("pod", "zero"), False),       # no data rank to split over
    ((2, 16, 16), ("group", "zero"), False),   # no free data axis
    ((2, 16, 16), ("pod", "client"), False),
])
def test_zero_refusal_follows_the_reference_leaf_rule(geom, plan, refused):
    """The parameters whose ZeRO client state the reference's
    ``ef_state_pspecs`` splits beyond its gradient specs, on a mesh object
    of that geometry (no process group needed)."""
    from jax.sharding import PartitionSpec as P
    from repro.launch import shardings as jax_sh
    cfg = cb.get("grok-1-314b")
    mesh = mesh_lib.Mesh(geom, ("pod", "data", "model"))
    sp = sh.ShardPlan(*plan)
    splits = sh.zero_splits(cfg, mesh, sp)
    assert (sh.zero_refusal(cfg, mesh, sp) is not None) == refused
    assert bool(splits) == refused
    # the upgraded specs are the reference's rule, leaf by leaf
    shapes = pt_model.init_params(cfg, None, "meta")
    pspecs = sh.params_pspecs(cfg, mesh)
    free = mesh.split_axes(mesh.client_axes(plan[0]))
    for name, spec in splits.items():
        want = jax_sh._zero_upgrade(P(*pspecs[name]), free,
                                    tuple(shapes[name].shape), mesh)
        assert tuple(want) == spec, name
