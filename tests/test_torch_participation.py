"""Sampled participation in the port (repro_torch.core.participation and the
masked round of core/distributed.py) against the reference's
(repro.core.participation), on the CPU.

Exact: the cohorts (``cohort_mask_np``, the reference's threefry2x32 stream
and sort-based shuffle written in numpy) over 240 (seed, step, n,
fraction) cells, seeds at and above 2³¹ and below 0 included, and the
cohort sizes. Within tolerance: masked rounds at fraction 0.25 and 0.5 on
the reference's cohorts, for each plan that may run one (rtol 1e-6 and four
ulps at η = 0.5, as tests/test_torch_ef_round.py), and 3 Session steps of
results/specs/sampled_quarter.json (rtol 1e-4). Bit for bit, torch to
torch: fraction 1.0 against the full round, and the non-sampled clients'
state across a round. The reference's own fraction-1.0 run is not bit for
bit its full run on XLA-CPU; the port's is held to its own full round, and
to the reference's FULL round within tolerance.
"""
import numpy as np
import pytest
import torch

from repro.core import ef as jax_ef
from repro.core import participation as jax_part
from repro.launch import build as jax_build
from repro.launch import spec as jax_spec
from repro_torch.core import distributed as pt_dist
from repro_torch.core import participation as pt_part
from repro_torch.launch import build as pt_build
from repro_torch.launch import spec as pt_spec
from test_torch_ef_round import _shapes
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)
from test_torch_schedule import (BASE, DP, assert_bit_equal,
                                 assert_rounds_close, clone_state,
                                 numpy_inputs, run_rounds, session_parity,
                                 shipped)

SEEDS = [0, 7, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 99, 2 ** 32 + 5, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_cohort_masks_match_reference_bit_for_bit(seed):
    """30 cells a seed: steps × n × fractions."""
    for step in (0, 17, 100_003):
        for n in (1, 3, 8, 33, 64):
            for fraction in (0.25, 1.0):
                part = (pt_part.Participation("sampled", fraction, seed),
                        jax_part.Participation("sampled", fraction, seed))
                got = pt_part.cohort_mask_np(part[0], n, step)
                want = jax_part.cohort_mask_np(part[1], n, step)
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want, err_msg=str(
                    (seed, step, n, fraction)))
                assert got.sum() == part[1].cohort_size(n)


def test_cohort_sizes_and_construction_errors_match_reference():
    for mode in ("full", "sampled", "async"):
        for fraction in (0.01, 0.1, 0.125, 0.25, 0.5, 0.9, 1.0):
            for n in (1, 3, 4, 8, 64):
                assert pt_part.Participation(mode, fraction).cohort_size(n) \
                    == jax_part.Participation(mode, fraction).cohort_size(n)
    for bad in ({"mode": "lazy"}, {"fraction": 0.0}, {"fraction": 1.5}):
        with pytest.raises(ValueError):
            jax_part.Participation(**bad)
        with pytest.raises(ValueError):
            pt_part.Participation(**bad)
    mask = torch.tensor([1.0, 0.0])
    assert torch.equal(pt_part.apply_mask(mask, {"a": torch.ones(2, 3)})["a"],
                       torch.tensor([[1.0] * 3, [0.0] * 3]))


@pytest.mark.parametrize("d", [
    pytest.param({"participation": {"mode": "sampled", "fraction": 0.25},
                  "carrier": "fused_quant8"}, id="sampled_fused_wire"),
    pytest.param({"participation": {"mode": "sampled"}, "groups": [
        {"pattern": "embed", "carrier": "fused_quant4"},
        {"pattern": "*", "carrier": "dense"}]}, id="sampled_fused_group"),
    pytest.param({"participation": {"mode": "sampled", "seed": 1.5}},
                 id="float_seed"),
    pytest.param({"participation": {"mode": "sampled", "size": 3}},
                 id="unknown_key"),
    pytest.param({"participation": {"mode": "sampled"},
                  "hops": {"pods": 2}}, id="sampled_hops"),
])
def test_bad_participation_is_refused_by_both_packages(d):
    d = dict(BASE, **d)
    with pytest.raises(ValueError, match="invalid RunSpec"):
        jax_spec.RunSpec.from_dict(d)
    with pytest.raises(ValueError, match="invalid RunSpec"):
        pt_spec.RunSpec.from_dict(d)


def test_async_is_refused_with_the_reference_message():
    """Mode 'async' is a spec both packages take; neither builds a
    synchronous step from it, and the port's words are the reference's
    (naming its own run_async)."""
    d = dict(BASE, participation={"mode": "async"})
    jspec = jax_spec.RunSpec.from_dict(d)
    pspec = pt_spec.RunSpec.from_dict(d)     # the port's spec takes it too
    assert pspec.spec_hash() == jspec.spec_hash()
    with pytest.raises(ValueError,
                       match="does not build a synchronous") as want:
        jax_build.default_ef_config(
            None, None, method=jax_ef.make("ef21_sgdm"),
            participation=jax_part.Participation("async"))
    with pytest.raises(ValueError,
                       match="does not build a synchronous") as got:
        pt_build.ef_config(pspec)
    assert str(got.value) == str(want.value).replace(
        "repro.core.participation", "repro_torch.core.participation")
    efc = pt_dist.EFConfig(
        method=pt_build.make_method(pt_spec.RunSpec.from_dict(BASE)),
        participation=pt_part.Participation("async"))
    params, g0, grads = numpy_inputs(0)
    state = pt_dist.init_ef_state(
        efc, {k: torch.tensor(v) for k, v in params.items()}, DP)
    with pytest.raises(ValueError, match="every round is a barrier"):
        pt_dist.ef_round(efc, {k: torch.tensor(v) for k, v in grads.items()},
                         state, step=0)
    efc = pt_dist.EFConfig(method=efc.method,
                           participation=pt_part.Participation("sampled"))
    with pytest.raises(ValueError, match="pass step="):
        pt_dist.ef_round(efc, {k: torch.tensor(v) for k, v in grads.items()},
                         state)


def sampled(fraction, seed=7, **fields):
    return dict(BASE, participation={"mode": "sampled", "fraction": fraction,
                                     "seed": seed}, **fields)


MASKED_CELLS = [
    pytest.param(dict(shipped("sampled_quarter"), eta=0.5), id="shipped"),
    pytest.param(sampled(0.25, carrier="sparse", downlink_carrier="quant4"),
                 id="wire_sparse_down4"),
    pytest.param(sampled(0.25, carrier="fused", ef_state_dtype="bfloat16"),
                 id="fused_bf16"),
    pytest.param(sampled(0.5, method="ef14_sgd", carrier="quant4"),
                 id="absolute_rescaled"),
    pytest.param(sampled(0.5, groups=[
        {"pattern": "norm", "carrier": "dense"},
        {"pattern": "embed", "carrier": "quant4"},
        {"pattern": "*", "carrier": "fused"}]), id="grouped"),
]


@pytest.mark.parametrize("d", MASKED_CELLS)
def test_masked_round_matches_reference(d):
    """Two rounds, two cohorts (steps 0 and 5)."""
    bf16 = tuple(_shapes()) if d.get("ef_state_dtype") else ()
    assert_rounds_close(run_rounds(d, seed=3, steps=(0, 5)), bf16)


PLANS = [
    pytest.param({"carrier": "dense"}, id="dense"),
    pytest.param({"carrier": "sparse", "downlink_carrier": "quant8"},
                 id="wire_sparse"),
    pytest.param({"carrier": "quant4"}, id="wire_quant4"),
    pytest.param({"carrier": "fused"}, id="fused"),
    pytest.param({"carrier": "fused", "ef_state_dtype": "bfloat16"},
                 id="fused_bf16"),
    pytest.param({"method": "ef14_sgd", "carrier": "dense"},
                 id="absolute_dense"),
    pytest.param({"groups": [{"pattern": "norm", "carrier": "dense"},
                             {"pattern": "*", "carrier": "fused"}]},
                 id="grouped"),
]


def _states(efc, seed=2):
    params, g0, grads = numpy_inputs(seed)
    params = {k: torch.tensor(v) for k, v in params.items()}
    st = pt_dist.init_ef_state(efc, params, DP, init_grads={
        k: torch.tensor(v) for k, v in g0.items()})
    return st, clone_state(st), grads


@pytest.mark.parametrize("fields", PLANS)
def test_fraction_one_is_bit_identical_to_the_full_round(fields):
    full = pt_build.ef_config(pt_spec.RunSpec.from_dict(dict(BASE,
                                                             **fields)))
    one = pt_build.ef_config(pt_spec.RunSpec.from_dict(sampled(1.0,
                                                               **fields)))
    st_full, st_one, grads = _states(full)
    for step in range(3):
        g = {k: torch.tensor(v) * (step + 1) for k, v in grads.items()}
        est_a, st_full = pt_dist.ef_round(full, g, st_full, step=step)
        est_b, st_one = pt_dist.ef_round(
            one, {k: v.clone() for k, v in g.items()}, st_one, step=step)
        assert_bit_equal(est_a, est_b, f"step {step} g_est/")
        assert_bit_equal(st_full, st_one, f"step {step} state/")


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("fields", PLANS)
def test_non_sampled_clients_keep_their_state_bit_for_bit(fields):
    efc = pt_build.ef_config(pt_spec.RunSpec.from_dict(sampled(0.25,
                                                               **fields)))
    st, before, grads = _states(efc)
    for step in range(3):
        cohort = pt_part.cohort_mask_np(efc.participation, DP, step) > 0
        _, st = pt_dist.ef_round(efc, {k: torch.tensor(v) for k, v in
                                       grads.items()}, st, step=step)
        moved = 0
        for name, tree in st["clients"].items():
            for k, t in tree.items():
                old = before["clients"][name][k]
                for i in range(DP):
                    if cohort[i]:
                        moved += not torch.equal(t[i], old[i])
                    else:
                        assert torch.equal(_bits(t[i]), _bits(old[i])), \
                            (step, name, k, i)
        assert moved, "no sampled client moved"
        before = clone_state(st)


def test_sampled_quarter_session_tracks_reference(tmp_path):
    psess = session_parity(tmp_path, shipped("sampled_quarter"))
    assert pt_spec.participation_preview(psess.spec)["cohort"] == 1
