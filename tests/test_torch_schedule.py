"""Per-parameter-group schedules of the port (repro_torch.core.schedule and
the grouped round of core/distributed.py) against the reference's
(repro.core.schedule), on the CPU.

Exact, as integers and accounting: leaf paths and their resolution,
pattern matching over a grid, wire words up, down and cross, coordinate
counts, α and the printed plan table, the spec hash and the --schedule
grammar, and the construction errors. Within tolerance: one grouped round
for each plan against the reference's jitted round on the same numpy
inputs at the smoke smollm-360m leaf shapes (rtol 1e-6 and four ulps, as
tests/test_torch_ef_round.py states: at η = 0.5 both momentum products are
exact), and 3 Session steps of results/specs/mixed_schedule.json from the
same npz weights (rtol 1e-4, as tests/test_torch_train.py). Bit for bit,
torch to torch: a one-group schedule against the ungrouped round on the
dense, wire, fused and fused_wire plans.
"""
import contextlib
import dataclasses
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jax_dist
from repro.core import schedule as jax_sched
from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro_torch.configs import base as cb
from repro_torch.core import distributed as pt_dist
from repro_torch.core import ef as pt_ef
from repro_torch.core import schedule as pt_sched
from repro_torch.launch import build as pt_build
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.models import model as pt_model
from test_torch_ef_round import _close, _nest, _shapes

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPECS = os.path.join(ROOT, "results", "specs")
DP = 4
# the round-level cells: smoke shapes, η 0.5 (exact momentum products)
BASE = {"version": 5, "smoke": True, "seq_len": 64, "clients": DP,
        "global_batch": 2 * DP,
        "eta": 0.5, "compressor": "block_topk",
        "compressor_kw": {"block": 1024, "k_per_block": 16}}
# phase G of chip_smoke.py: the fused wire on two groups, one of them on
# bf16 EF state, the norms dense
FUSED_GROUPS = [
    {"pattern": "norm|bias", "carrier": "dense"},
    {"pattern": "embed", "carrier": "fused_quant8",
     "downlink_carrier": "fused_quant4", "ef_state_dtype": "bfloat16"},
    {"pattern": "*", "carrier": "fused_quant8",
     "downlink_carrier": "fused_quant4"}]


@contextlib.contextmanager
def torch_threads(n):
    """Run on ``n`` torch threads, then restore the count. These tests run
    many small tensor operations, which a pool of threads per test process
    only slows down when the suite's processes share the cores; every
    comparison runs both of its sides in the same setting."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


def shipped(name, **overrides):
    with open(os.path.join(SPECS, f"{name}.json")) as f:
        return dict(json.load(f), **overrides)


# ---------------------------------------------------------------------------
# the round harness the participation and hierarchy tests share
# ---------------------------------------------------------------------------

def configs(d):
    """(reference EFConfig, port EFConfig) of one spec dict, each built by
    its own package's factories."""
    js = jax_spec.RunSpec.from_dict(dict(d))
    j_efc = jax_dist.EFConfig(
        method=jax_session.make_method(js), carrier=js.carrier,
        down_carrier=js.downlink_carrier,
        down_compressor=jax_session.make_down_compressor(js),
        schedule=jax_session.make_schedule(js),
        participation=jax_session.make_participation(js),
        hops=jax_session.make_hops(js))
    return j_efc, pt_build.ef_config(pt_spec.RunSpec.from_dict(dict(d)))


def numpy_inputs(seed, dp=DP):
    """Params, first gradients (Alg 1 line 2) and one round's gradients at
    the smoke leaf shapes, float32 numpy."""
    rng = np.random.RandomState(seed)
    shapes = _shapes()

    def tree(lead=()):
        return {k: rng.randn(*lead, *s).astype(np.float32)
                for k, s in shapes.items()}
    return tree(), tree((dp,)), tree((dp,))


def init_states(j_efc, p_efc, params, g0):
    dp = next(iter(g0.values())).shape[0]
    j_state = jax_dist.init_ef_state(
        j_efc, jax.tree_util.tree_map(jnp.asarray, _nest(params)), dp,
        init_grads=jax.tree_util.tree_map(jnp.asarray, _nest(g0)))
    p_state = pt_dist.init_ef_state(
        p_efc, {k: torch.tensor(v) for k, v in params.items()}, dp,
        init_grads={k: torch.tensor(v) for k, v in g0.items()})
    return j_state, p_state


def flat(tree):
    """Any nested state (the reference's or the port's) as one flat dict of
    numpy arrays keyed by ``part/name/leaf``."""
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else
                          jnp.asarray(v, jnp.float32))
            for k, v in pt_ef.flatten(tree).items()}


def to_torch(state):
    """The reference's EF state as the port's (nested leaves flattened,
    bf16 kept)."""
    def conv(x):
        a = np.asarray(jnp.asarray(x, jnp.float32))
        t = torch.tensor(a)
        return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t

    def walk(node, depth):
        if depth == 0:
            return {k: conv(v) for k, v in pt_ef.flatten(node).items()}
        return {k: walk(v, depth - 1) for k, v in node.items()}
    out = {}
    for part, tree in state.items():
        out[part] = walk(tree, 1 if part in ("clients", "pods") else 0)
    return out


def run_rounds(d, seed, steps=(0,)):
    """The reference's jitted round and the port's on the same numpy inputs,
    round after round (the port starts each round from the reference's
    state, so one round's ulp cannot move the next one's selection).
    Returns [(reference g_est and state, port g_est and state)] a round,
    flattened."""
    j_efc, p_efc = configs(d)
    params, g0, _ = numpy_inputs(seed)
    j_state, p_state = init_states(j_efc, p_efc, params, g0)
    step_fn = jax.jit(lambda g, s, st: jax_dist.ef_round(j_efc, g, s, None,
                                                         step=st))
    out = []
    rng = np.random.RandomState(seed + 1)
    for step in steps:
        grads = {k: rng.randn(DP, *s).astype(np.float32)
                 for k, s in _shapes().items()}
        j_est, j_state_new = step_fn(
            jax.tree_util.tree_map(jnp.asarray, _nest(grads)), j_state,
            jnp.int32(step))
        p_est, p_new = pt_dist.ef_round(
            p_efc, {k: torch.tensor(v) for k, v in grads.items()}, p_state,
            step=step)
        out.append(({"g_est": flat(j_est), **{
            p: flat(v) for p, v in j_state_new.items()}},
            {"g_est": flat(p_est), **{p: flat(v) for p, v in p_new.items()}}))
        j_state, p_state = j_state_new, to_torch(j_state_new)
    return out


def assert_rounds_close(rounds, bf16_leaves=()):
    """Every part within _close's tolerance; a client state leaf held in
    bfloat16 (``bf16_leaves``) within one bf16 ulp (2⁻⁷ relative): the
    reference rounds g + decode(wire) to bf16 after XLA's fused add, the
    port after its own."""
    for r, (want, got) in enumerate(rounds):
        assert sorted(got) == sorted(want), r
        for part in want:
            loose = {k for k in want[part] if part == "clients"
                     and k.split("/", 1)[1] in bf16_leaves}
            _close({k: v for k, v in got[part].items() if k not in loose},
                   {k: v for k, v in want[part].items() if k not in loose},
                   f"round {r} {part}")
            for k in loose:
                np.testing.assert_allclose(got[part][k], want[part][k],
                                           rtol=2 ** -7, atol=0,
                                           err_msg=f"round {r} {part}/{k}")


# ---------------------------------------------------------------------------
# patterns, paths, resolution
# ---------------------------------------------------------------------------

PATTERNS = ["*", "norm", "norm|bias", "embed", "EMBED", "attn|mlp", "wq",
            "w_", "layers/mlp", "final", "bias", "x|y|norm", "norm|", "a|*",
            "", "|"]
PATHS = list(_shapes()) + ["layers/mlp/bias", "Embed/Table", ""]


def test_pattern_matches_and_token_errors_match_reference():
    for pat in PATTERNS:
        assert pt_sched.pattern_token_errors(pat) == \
            jax_sched.pattern_token_errors(pat) == \
            jax_spec.pattern_token_errors(pat) == \
            pt_spec.pattern_token_errors(pat), pat
        for path in PATHS:
            assert pt_sched.pattern_matches(pat, path.lower()) == \
                jax_sched.pattern_matches(pat, path.lower()), (pat, path)


@pytest.mark.parametrize("groups", [
    pytest.param(shipped("mixed_schedule")["groups"], id="mixed_schedule"),
    pytest.param(FUSED_GROUPS, id="fused_groups"),
    pytest.param([{"pattern": "wq|wk|wv", "carrier": "sparse"},
                  {"pattern": "mlp", "carrier": "quant8"},
                  {"pattern": "*", "carrier": "dense"}], id="attn_mlp"),
])
def test_leaf_paths_and_resolve_match_reference(groups):
    cfg = pt_model.init_params(cb.get_smoke("smollm-360m"), None, "meta")
    nested = _nest({k: np.zeros(tuple(v.shape), np.float32)
                    for k, v in cfg.items()})
    assert pt_sched.leaf_paths(cfg) == jax_sched.leaf_paths(nested)
    d = dict(BASE, groups=groups)
    j_sched = jax_session.make_schedule(jax_spec.RunSpec.from_dict(d))
    p_sched = pt_build.make_schedule(pt_spec.RunSpec.from_dict(d))
    assert p_sched.resolve(cfg) == j_sched.resolve(nested)
    assert [len(k) for k in pt_sched.group_keys(p_sched, cfg)] == \
        [sum(1 for g in j_sched.resolve(nested) if g == i)
         for i in range(len(groups))]


def test_leaf_order_refuses_keys_that_sort_apart_from_the_reference():
    assert pt_sched.leaf_order({"b": 0, "a/c": 0, "a/b": 0}) == \
        ["a/b", "a/c", "b"]
    with pytest.raises(ValueError, match="tree_flatten order"):
        pt_sched.leaf_order({"a-b": 0, "a/c": 0})


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

ACCOUNTING_SPECS = [
    pytest.param(shipped("mixed_schedule"), id="mixed_schedule"),
    pytest.param(dict(shipped("fused_quickstart"), groups=FUSED_GROUPS),
                 id="fused_groups"),
    pytest.param(dict(shipped("hierarchy_quant4_cross"), groups=[
        {"pattern": "embed", "carrier": "quant8", "cross_carrier": "dense"},
        {"pattern": "*", "carrier": "sparse", "cross_carrier": "quant8",
         "cross_ratio": 0.1}]), id="per_group_cross"),
    pytest.param(dict(BASE, method="ef21_sgdm_abs", groups=[
        {"pattern": "norm", "carrier": "quant4", "compressor": "identity"},
        {"pattern": "*", "carrier": "sparse", "ratio": 0.02}]),
        id="degraded"),
]


@pytest.mark.parametrize("d", ACCOUNTING_SPECS)
@pytest.mark.parametrize("smoke", [True, False])
def test_accounting_matches_reference_exactly(d, smoke):
    """Wire words up, down and cross, coordinates, α and the printed table,
    at smoke and at full width (shapes only: nothing is allocated)."""
    d = dict(d, smoke=smoke)
    js, ps = jax_spec.RunSpec.from_dict(d), pt_spec.RunSpec.from_dict(d)
    j_sched, p_sched = jax_session.make_schedule(js), \
        pt_build.make_schedule(ps)
    j_method, p_method = jax_session.make_method(js), \
        pt_build.make_method(ps)
    psess = pt_session.Session(ps, device="cpu")
    tree = pt_model.init_params(psess.cfg, None, "meta")
    nested = _nest({k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
                    for k, v in tree.items()})
    for direction in ("up", "down", "cross"):
        assert pt_sched.wire_words_tree(p_sched, p_method, tree, direction,
                                        eta=ps.eta) == \
            jax_sched.wire_words_tree(j_sched, j_method, nested, direction,
                                      eta=js.eta), direction
    assert pt_sched.coords_tree(p_sched, p_method, tree) == \
        jax_sched.coords_tree(j_sched, j_method, nested)
    assert pt_sched.alpha_min(p_sched, tree) == \
        jax_sched.alpha_min(j_sched, nested)
    assert psess.schedule_table() == \
        jax_sched.plan_table(j_sched, j_method, nested, eta=js.eta)
    assert pt_spec.schedule_preview(ps) == jax_spec.schedule_preview(js)
    assert pt_spec.resolved_groups(ps) == jax_spec.resolved_groups(js)


# ---------------------------------------------------------------------------
# spec, flags, construction errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mixed_schedule", "sampled_quarter",
                                  "hierarchy_quant4_cross"])
def test_shipped_specs_load_and_hash_as_the_reference(name):
    with open(os.path.join(SPECS, f"{name}.json")) as f:
        text = f.read()
    ps, js = pt_spec.RunSpec.from_json(text), jax_spec.RunSpec.from_json(text)
    assert ps.spec_hash() == js.spec_hash()
    assert json.loads(ps.to_json()) == json.loads(js.to_json())
    assert pt_spec.participation_preview(ps) == \
        jax_spec.participation_preview(js)
    assert pt_spec.hops_preview(ps) == jax_spec.hops_preview(js)


@pytest.mark.parametrize("flag,value", [
    ("--schedule", "norm|bias=dense,embed=quant4:0.05,*=sparse:0.02"),
    ("--schedule", "embed=sparse:0.1@topk,*=dense"),
    ("--schedule", json.dumps(FUSED_GROUPS)),
    ("--participation", "sampled:0.25:7"),
    ("--participation", "sampled:0.5"),
    ("--participation", "full"),
    ("--participation", '{"fraction": 0.5, "mode": "sampled"}'),
    ("--hops", "pods=2,cross=quant4:0.05"),
    ("--hops", "pods=4"),
    ("--hops", '{"cross_ratio": 0.1, "pods": 2}'),
])
def test_flag_grammars_round_trip_as_the_reference(flag, value):
    kind = {"--schedule": "schedule", "--participation": "participation",
            "--hops": "hops"}[flag]
    p_parse = getattr(pt_spec, f"parse_{kind}_flag")
    p_format = getattr(pt_spec, f"format_{kind}_flag")
    parsed = p_parse(value)
    assert parsed == getattr(jax_spec, f"parse_{kind}_flag")(value)
    assert p_format(parsed) == getattr(jax_spec, f"format_{kind}_flag")(
        parsed)
    assert p_parse(p_format(parsed)) == parsed
    # and through the training CLI's parser
    import argparse
    ap = argparse.ArgumentParser()
    pt_spec.add_flags(ap)
    args = ap.parse_args(["--spec", os.path.join(SPECS, "fused_quickstart"
                                                 ".json"), flag, value])
    field = {"--schedule": "groups"}.get(flag, kind)
    assert getattr(pt_spec.from_args(args), field) == parsed


BAD_GROUPS = [
    [{"pattern": "embed", "carrier": "dense"}],                 # no '*'
    [{"pattern": "*"}, {"pattern": "embed"}],                   # '*' first
    [{"pattern": "norm|", "carrier": "dense"}, {"pattern": "*"}],
    [{"pattern": "a=b"}, {"pattern": "*"}],
    [{"pattern": "x"}, {"pattern": "x"}, {"pattern": "*"}],
    [{"pattern": "*", "carrier": "warp"}],
    [{"pattern": "*", "downlink_carrier": "fused"}],
    [{"pattern": "*", "cross_carrier": "fused"}],
    [{"pattern": "*", "ef_state_dtype": "float16"}],
    [{"pattern": "*", "ratio": 1.5}],
    [{"pattern": "*", "carrier": "fused", "compressor": "topk"}],
    [{"pattern": "*", "carrier": "fused_quant8", "compressor": "identity"}],
    [{"pattern": "*", "shape": 3}],
]


@pytest.mark.parametrize("groups", BAD_GROUPS)
def test_bad_groups_are_refused_by_both_packages(groups):
    d = dict(BASE, groups=groups)
    with pytest.raises(ValueError, match="invalid RunSpec"):
        jax_spec.RunSpec.from_dict(d)
    with pytest.raises(ValueError, match="invalid RunSpec"):
        pt_spec.RunSpec.from_dict(d)


def test_schedule_object_refuses_what_the_reference_refuses():
    for bad in ([], [pt_sched.Group("embed")],
                [pt_sched.Group("*"), pt_sched.Group("embed")],
                [pt_sched.Group("a:b"), pt_sched.Group("*")],
                [pt_sched.Group("*", carrier="nope")],
                [pt_sched.Group("*", down_carrier="fused")],
                [pt_sched.Group("*", cross_carrier="fused")],
                [pt_sched.Group("*", state_dtype="int8")]):
        with pytest.raises(ValueError, match="invalid CompressionSchedule"):
            pt_sched.CompressionSchedule(tuple(bad))


def test_fused_group_misconfig_is_a_hard_error_in_build():
    """A fused group whose compressor the kernel does not run: the spec
    refuses it, and so does build on a schedule made by hand."""
    from repro_torch.core import compressors as comp_lib
    spec = pt_spec.RunSpec.from_dict(BASE)
    sched = pt_sched.CompressionSchedule((pt_sched.Group(
        "*", compressor=comp_lib.TopK(), carrier="fused"),))
    method = dataclasses.replace(pt_build.make_method(spec),
                                 compressor=comp_lib.TopK())
    with pytest.raises(ValueError, match="UNFUSED"):
        pt_build._check_group_plans(("k",), sched, method, spec.eta)


def test_build_warns_once_per_distinct_degradation():
    """A group that degrades to the dense plan warns once for a config,
    however often it is built; another config warns again."""
    d = dict(BASE, method="ef21_sgdm_abs", groups=[
        {"pattern": "embed", "carrier": "quant4"},
        {"pattern": "*", "carrier": "sparse"}])
    pt_build.reset_plan_warnings()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(3):
            pt_build.ef_config(pt_spec.RunSpec.from_dict(d))
    hits = [w for w in rec
            if issubclass(w.category, pt_build.PlanDegradationWarning)]
    assert len(hits) == 2, [str(w.message) for w in hits]    # two groups
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pt_build.ef_config(pt_spec.RunSpec.from_dict(dict(d, eta=0.3)))
    assert len([w for w in rec if issubclass(
        w.category, pt_build.PlanDegradationWarning)]) == 2
    pt_build.reset_plan_warnings()


def test_group_state_dtype_per_group():
    d = dict(shipped("fused_quickstart"), smoke=True, seq_len=64,
             groups=FUSED_GROUPS)
    sess = pt_session.Session(pt_spec.RunSpec.from_dict(d), device="cpu",
                              dtype="float32")
    clients = sess.ef_state["clients"]
    for name in ("v", "g"):
        assert clients[name]["embed"].dtype == torch.bfloat16
        assert clients[name]["layers/mlp/w_up"].dtype == torch.float32
        assert clients[name]["final_norm"].dtype == torch.float32
    assert sess.ef_state["h"]["embed"].dtype == torch.float32
    assert pt_sched._group_rng(None, 0, 3) is None
    gen = torch.Generator()
    assert pt_sched._group_rng(gen, 0, 1) is gen


# ---------------------------------------------------------------------------
# the grouped round against the reference's
# ---------------------------------------------------------------------------

ROUND_CELLS = [
    pytest.param(shipped("mixed_schedule", eta=0.5), (),
                 id="mixed_dense_wire_sparse_quant4"),
    pytest.param(dict(BASE, groups=[
        {"pattern": "norm|bias", "carrier": "dense"},
        {"pattern": "*", "carrier": "fused"}]), (), id="fused"),
    pytest.param(dict(BASE, groups=[
        {"pattern": "norm|bias", "carrier": "dense"},
        {"pattern": "*", "carrier": "fused_quant8",
         "downlink_carrier": "fused_quant4"}]), (), id="fused_wire"),
    pytest.param(dict(BASE, groups=[
        {"pattern": "embed", "carrier": "quant8", "compressor": "identity"},
        {"pattern": "attn", "carrier": "dense", "compressor": "block_quant",
         "compressor_kw": {"bits": 8, "block": 256}},
        {"pattern": "*", "carrier": "dense", "compressor": "block_topk",
         "downlink_carrier": "sparse", "downlink_ratio": 0.1}]), (),
        id="dense_payload"),
    # a bf16 group beside f32 groups
    pytest.param(dict(BASE, groups=FUSED_GROUPS), ("embed",),
                 id="bf16_group"),
]


@pytest.mark.parametrize("d,bf16_leaves", ROUND_CELLS)
def test_grouped_round_matches_reference(d, bf16_leaves):
    assert_rounds_close(run_rounds(d, seed=11, steps=(0, 1)), bf16_leaves)


ONE_GROUP = [
    pytest.param({"carrier": "dense"}, id="dense"),
    pytest.param({"carrier": "dense", "compressor": "block_quant",
                  "compressor_kw": {"bits": 4, "block": 64},
                  "downlink_carrier": "quant8"}, id="dense_block_quant"),
    pytest.param({"carrier": "sparse", "downlink_carrier": "quant4"},
                 id="wire_sparse"),
    pytest.param({"carrier": "quant8", "downlink_carrier": "sparse"},
                 id="wire_quant8"),
    pytest.param({"carrier": "fused"}, id="fused"),
    pytest.param({"carrier": "fused", "ef_state_dtype": "bfloat16"},
                 id="fused_bf16"),
    pytest.param({"carrier": "fused_quant8",
                  "downlink_carrier": "fused_quant4"}, id="fused_wire"),
    pytest.param({"method": "ef14_sgd", "carrier": "quant4"},
                 id="ef14_wire"),
]


def clone_state(state):
    return {p: ({n: {k: t.clone() for k, t in tr.items()}
                 for n, tr in v.items()} if p in ("clients", "pods")
                else {k: t.clone() for k, t in v.items()})
            for p, v in state.items()}


def assert_bit_equal(a, b, what=""):
    fa, fb = pt_ef.flatten(a), pt_ef.flatten(b)
    assert sorted(fa) == sorted(fb), what
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), \
            f"{what}{k}"


@pytest.mark.parametrize("fields", ONE_GROUP)
def test_one_group_schedule_is_bit_identical_to_the_ungrouped_round(fields):
    d = dict(BASE, **fields)
    flat_efc = pt_build.ef_config(pt_spec.RunSpec.from_dict(d))
    s = pt_spec.RunSpec.from_dict(d)
    group = {k: v for k, v in fields.items()
             if k in pt_spec.GROUP_KEYS and k != "method"}
    grouped = pt_build.ef_config(pt_spec.RunSpec.from_dict(
        dict(d, groups=[dict(group, pattern="*",
                             compressor=s.compressor)])))
    assert grouped.schedule is not None and flat_efc.schedule is None
    params, g0, grads = numpy_inputs(5)
    params = {k: torch.tensor(v) for k, v in params.items()}
    g0 = {k: torch.tensor(v) for k, v in g0.items()}
    st_flat = pt_dist.init_ef_state(flat_efc, params, DP, init_grads=g0)
    st_grp = pt_dist.init_ef_state(grouped, params, DP,
                                   init_grads={k: v.clone()
                                               for k, v in g0.items()})
    assert_bit_equal(st_flat, st_grp, "init/")
    for r in range(2):
        gr = {k: torch.tensor(v) * (r + 1) for k, v in grads.items()}
        est_a, st_flat = pt_dist.ef_round(flat_efc, gr, st_flat)
        est_b, st_grp = pt_dist.ef_round(grouped, {k: v.clone() for k, v
                                                   in gr.items()}, st_grp)
        assert_bit_equal(est_a, est_b, f"round {r} g_est/")
        assert_bit_equal(st_flat, st_grp, f"round {r} state/")


def test_fused_groups_write_the_state_in_place():
    """The fused plans' in-place writes land in the full state's tensors,
    not in copies of a group's sub-dict."""
    d = dict(BASE, groups=[{"pattern": "norm", "carrier": "dense"},
                           {"pattern": "*", "carrier": "fused_quant8"}])
    efc = pt_build.ef_config(pt_spec.RunSpec.from_dict(d))
    params, g0, grads = numpy_inputs(6)
    state = pt_dist.init_ef_state(
        efc, {k: torch.tensor(v) for k, v in params.items()}, DP,
        init_grads={k: torch.tensor(v) for k, v in g0.items()})
    before = {k: (t.data_ptr(), t.clone())
              for k, t in state["clients"]["g"].items()}
    _, new = pt_dist.ef_round(efc, {k: torch.tensor(v)
                                    for k, v in grads.items()}, state)
    assert new["clients"] is state["clients"]
    for k, (ptr, old) in before.items():
        t = new["clients"]["g"][k]
        if "norm" in k:
            assert not torch.equal(t, old), k    # replaced, dense plan
        else:
            assert t.data_ptr() == ptr and not torch.equal(t, old), k


# ---------------------------------------------------------------------------
# the shipped spec through the Session
# ---------------------------------------------------------------------------

def session_parity(tmp_path, d, steps=3):
    """The reference's smoke Session (f32 activations) saves its initial
    state; the port's Session restores it and both train ``steps`` steps:
    loss and g_norm within rtol 1e-4."""
    jsess = jax_session.Session(jax_spec.RunSpec.from_dict(dict(d)))
    jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
    ckpt = jsess.save(str(tmp_path / "step_0.npz"))
    want = jsess.train(steps, log_every=1)
    psess = pt_session.Session(pt_spec.RunSpec.from_dict(dict(d)),
                               device="cpu", dtype="float32")
    psess.restore_from(ckpt)
    got = psess.train(steps, log_every=1)
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        list(range(steps))
    for key in ("loss", "g_norm"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4,
                                   err_msg=key)
    return psess


def test_mixed_schedule_session_tracks_reference(tmp_path):
    session_parity(tmp_path, shipped("mixed_schedule"))
