"""The two-tier hierarchy in the port (repro_torch.core.hierarchy and the pod
tier of core/distributed.py) against the reference's
(repro.core.hierarchy), on the CPU.

Exact: cross-pod and flat words a round, with and without a schedule, at
smoke and at full width. Within tolerance (rtol 1e-6 and four ulps at
η = 0.5, as tests/test_torch_ef_round.py): ``round_pods_batched`` on a
non-trivial quant4 cross hop, whole rounds with pods for each intra plan
that composes with them, and 3 Session steps of
results/specs/hierarchy_quant4_cross.json (rtol 1e-4). Bit for bit, torch
to torch: a trivial cross hop (dense) against the flat round.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierarchy as jax_hier
from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro_torch.core import distributed as pt_dist
from repro_torch.core import hierarchy as pt_hier
from repro_torch.core import participation as pt_part
from repro_torch.launch import build as pt_build
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.models import model as pt_model
from test_torch_ef_round import _close, _nest, _shapes
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)
from test_torch_schedule import (BASE, DP, assert_bit_equal,
                                 assert_rounds_close, clone_state, configs,
                                 flat, numpy_inputs, run_rounds,
                                 session_parity, shipped)


def hier(cross="quant4", pods=2, **fields):
    hops = {"pods": pods}
    if cross is not None:
        hops["cross_carrier"] = cross
    return dict(BASE, hops=hops, **fields)


WORDS_SPECS = [
    pytest.param(shipped("hierarchy_quant4_cross"), id="shipped"),
    pytest.param(dict(shipped("hierarchy_quant4_cross"),
                      hops={"pods": 4, "cross_carrier": "sparse",
                            "cross_ratio": 0.02}), id="sparse_cross"),
    pytest.param(dict(shipped("hierarchy_quant4_cross"), groups=[
        {"pattern": "norm", "carrier": "dense", "cross_carrier": "dense"},
        {"pattern": "embed", "carrier": "quant8",
         "cross_carrier": "quant8", "cross_ratio": 0.1},
        {"pattern": "*", "carrier": "sparse"}]), id="per_group_cross"),
]


@pytest.mark.parametrize("d", WORDS_SPECS)
@pytest.mark.parametrize("smoke", [True, False])
def test_cross_words_match_reference_exactly(d, smoke):
    d = dict(d, smoke=smoke)
    js, ps = jax_spec.RunSpec.from_dict(d), pt_spec.RunSpec.from_dict(d)
    j_hops, p_hops = jax_session.make_hops(js), pt_build.make_hops(ps)
    j_sched, p_sched = jax_session.make_schedule(js), \
        pt_build.make_schedule(ps)
    j_m, p_m = jax_session.make_method(js), pt_build.make_method(ps)
    tree = pt_model.init_params(pt_session.Session(ps, device="cpu").cfg,
                                None, "meta")
    nested = _nest({k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
                    for k, v in tree.items()})
    got = pt_hier.wire_words_cross(p_hops, p_sched, p_m, tree)
    assert got == jax_hier.wire_words_cross(j_hops, j_sched, j_m, nested)
    d_all = sum(int(v.numel()) for v in tree.values())
    assert pt_hier.wire_words_cross(p_hops, None, p_m, d_all) == \
        jax_hier.wire_words_cross(j_hops, None, j_m, d_all)
    assert p_hops.trivial_cross == j_hops.trivial_cross is False
    assert pt_spec.hops_preview(ps) == jax_spec.hops_preview(js)


def test_round_pods_batched_matches_reference_on_a_quant4_cross():
    """The pod tier alone, from numpy pod means and pod memories: per pod
    the target update and the quant4 cross hop (K5/K6's plain versions),
    then the server step."""
    d = shipped("hierarchy_quant4_cross", eta=0.5)
    js, ps = jax_spec.RunSpec.from_dict(d), pt_spec.RunSpec.from_dict(d)
    rng = np.random.RandomState(4)
    shapes = _shapes()
    pods = 2

    def tree(lead=()):
        return {k: rng.randn(*lead, *s).astype(np.float32)
                for k, s in shapes.items()}
    u, t, b, g = tree((pods,)), tree((pods,)), tree((pods,)), tree()
    j_pods, j_server = jax.jit(lambda u, st, g: jax_hier.round_pods_batched(
        jax_session.make_hops(js), None, jax_session.make_method(js), u, st,
        g, None))(_nest(u), {"t": _nest(t), "b": _nest(b)}, _nest(g))
    tt = {k: torch.tensor(v) for k, v in t.items()}
    p_pods, p_server = pt_hier.round_pods_batched(
        pt_build.make_hops(ps), None, pt_build.make_method(ps),
        {k: torch.tensor(v) for k, v in u.items()},
        {"t": tt, "b": {k: torch.tensor(v) for k, v in b.items()}},
        {k: torch.tensor(v) for k, v in g.items()})
    _close(flat(p_server), flat(j_server), "server")
    for part in ("t", "b"):
        _close(flat(p_pods[part]), flat(j_pods[part]), part)
    # the pod means the intra hop gives, as the reference takes them
    x = np.random.RandomState(5).randn(8, 3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        pt_hier.pod_mean({"a": torch.tensor(x)}, 2)["a"].numpy(),
        np.asarray(jax_hier.pod_mean({"a": jnp.asarray(x)}, 2)["a"]))
    # the cross hop moved b, and t is exact (t + u)
    assert not np.allclose(flat(p_pods["b"])["embed"], b["embed"])
    np.testing.assert_array_equal(flat(p_pods["t"])["embed"],
                                  t["embed"] + u["embed"])


POD_CELLS = [
    pytest.param(dict(shipped("hierarchy_quant4_cross"), eta=0.5,
                      clients=DP), id="shipped_dense_intra"),
    pytest.param(hier("quant8", carrier="sparse", downlink_carrier="quant4"),
                 id="wire_intra_quant8_cross"),
    pytest.param(hier("quant4", carrier="fused"), id="fused_intra"),
    pytest.param(hier("sparse", pods=4, method="ef14_sgd",
                      carrier="quant4"), id="absolute_four_pods"),
    pytest.param(hier(None, groups=[
        {"pattern": "norm", "carrier": "dense"},
        {"pattern": "embed", "carrier": "quant4",
         "cross_carrier": "quant8"},
        {"pattern": "*", "carrier": "fused", "cross_carrier": "quant4",
         "cross_ratio": 0.1}]), id="grouped_per_group_cross"),
]


@pytest.mark.parametrize("d", POD_CELLS)
def test_pod_round_matches_reference(d):
    """Two rounds with the pods' memories carried."""
    rounds = run_rounds(d, seed=8, steps=(0, 1))
    assert "pods" in rounds[0][1]
    assert_rounds_close(rounds)


INTRA = [
    pytest.param({"carrier": "dense"}, id="dense"),
    pytest.param({"carrier": "sparse", "downlink_carrier": "quant4"},
                 id="wire_sparse"),
    pytest.param({"carrier": "quant8"}, id="wire_quant8"),
    pytest.param({"carrier": "fused"}, id="fused"),
    pytest.param({"method": "sgdm", "carrier": "dense"}, id="absolute"),
    pytest.param({"groups": [{"pattern": "norm", "carrier": "dense"},
                             {"pattern": "*", "carrier": "fused"}]},
                 id="grouped"),
]


@pytest.mark.parametrize("fields", INTRA)
def test_trivial_cross_is_bit_identical_to_the_flat_round(fields):
    """A dense cross hop makes the pod aggregator transparent: estimate,
    clients and server bit for bit the flat round's; the pods' memories
    track the global innovation (b = t, every pod the same)."""
    flat_efc = pt_build.ef_config(pt_spec.RunSpec.from_dict(dict(BASE,
                                                                 **fields)))
    pod_efc = pt_build.ef_config(pt_spec.RunSpec.from_dict(
        hier("dense", **fields)))
    assert pod_efc.effective_hops is not None
    params, g0, grads = numpy_inputs(9)
    params = {k: torch.tensor(v) for k, v in params.items()}
    st_flat = pt_dist.init_ef_state(flat_efc, params, DP, init_grads={
        k: torch.tensor(v) for k, v in g0.items()})
    st_pod = clone_state(st_flat)
    st_pod["pods"] = pt_dist.init_ef_state(pod_efc, params, DP)["pods"]
    for step in range(2):
        g = {k: torch.tensor(v) * (step + 1) for k, v in grads.items()}
        est_a, st_flat = pt_dist.ef_round(flat_efc, g, st_flat)
        est_b, st_pod = pt_dist.ef_round(
            pod_efc, {k: v.clone() for k, v in g.items()}, st_pod)
        assert_bit_equal(est_a, est_b, f"step {step} g_est/")
        assert_bit_equal(st_flat, {p: v for p, v in st_pod.items()
                                   if p != "pods"}, f"step {step} state/")
        for k, t in st_pod["pods"]["t"].items():
            assert t is st_pod["pods"]["b"][k]
            assert torch.equal(t[0], t[1]), k


@pytest.mark.parametrize("d", [
    pytest.param(hier(pods=3), id="pods_not_dividing"),
    pytest.param(hier(carrier="fused_quant8"), id="fused_wire"),
    pytest.param(hier(groups=[{"pattern": "embed", "carrier": "fused_quant4"},
                              {"pattern": "*"}]), id="fused_wire_group"),
    pytest.param(hier(pods=0), id="zero_pods"),
    pytest.param(hier("fused"), id="fused_cross"),
    pytest.param(dict(BASE, hops={"pods": 2, "fanout": 3}), id="unknown_key"),
    pytest.param(dict(BASE, hops={"pods": 2, "cross_ratio": 0.0}),
                 id="bad_ratio"),
])
def test_bad_hops_are_refused_by_both_packages(d):
    with pytest.raises(ValueError, match="invalid RunSpec"):
        jax_spec.RunSpec.from_dict(d)
    with pytest.raises(ValueError, match="invalid RunSpec"):
        pt_spec.RunSpec.from_dict(d)


def test_round_refuses_what_the_pod_tier_cannot_run():
    """Behind the spec's refusals, ef_round keeps the reference's own:
    a cohort mask or the fused wire under pods."""
    _, efc = configs(hier(carrier="quant8"))
    params, g0, grads = numpy_inputs(1)
    state = pt_dist.init_ef_state(
        efc, {k: torch.tensor(v) for k, v in params.items()}, DP)
    g = {k: torch.tensor(v) for k, v in grads.items()}
    with pytest.raises(ValueError, match="does not compose"):
        pt_dist.ef_round(dataclasses.replace(
            efc, participation=pt_part.Participation("sampled", 0.5)),
            g, state, step=0)
    with pytest.raises(ValueError, match="fused_wire"):
        pt_dist.ef_round(dataclasses.replace(efc, carrier="fused_quant8"),
                         g, state)
    with pytest.raises(ValueError, match="must divide"):
        pt_hier.check_pods(pt_hier.Hops(pods=3), DP)
    assert pt_hier.CROSS_FOLD == jax_hier.CROSS_FOLD


def test_hierarchy_session_tracks_reference(tmp_path):
    psess = session_parity(tmp_path, shipped("hierarchy_quant4_cross"))
    pods = psess.ef_state["pods"]
    assert sorted(pods) == ["b", "t"]
    assert pods["t"]["embed"].shape[0] == 2
