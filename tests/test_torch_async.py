"""The port's event-driven asynchronous simulator
(repro_torch.core.participation: ArrivalModel, sync_barrier_wallclock,
run_async) against the reference's, on the CPU.

The event queue draws from numpy's RandomState in both packages, so the
event accounting is held EXACTLY: the wall clock, the applied, dropped and
discarded arrivals, the staleness histogram and its max and mean, and the
synchronous barrier's wall clock, for uniform, heavy-tailed and dropout
arrivals and under a staleness cap. On full-batch clients (no draw enters
a gradient) the trajectories are held too: the per-round ‖∇f‖² within
rtol 1e-4.
"""
import numpy as np
import pytest

from repro.core import compressors as jax_comp
from repro.core import ef as jax_ef
from repro.core import participation as jax_part
from repro_torch.core import compressors as pt_comp
from repro_torch.core import ef as pt_ef
from repro_torch.core import participation as pt_part
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)
from test_torch_simulate import JaxLogistic, PtLogistic

PROB = dict(n=4, m_per_client=24, l=6, c=3, seed=3)
EVENT_KEYS = ("wall_clock", "rounds", "arrivals_applied", "arrivals_dropped",
              "arrivals_discarded", "max_staleness", "mean_staleness",
              "sync_wall_clock")
SCENARIOS = [
    pytest.param(dict(kind="uniform"), None, 5, id="uniform"),
    pytest.param(dict(kind="heavy_tail", alpha=1.3), None, 5,
                 id="heavy_tail"),
    pytest.param(dict(kind="dropout", drop_prob=0.3), None, 4, id="dropout"),
    pytest.param(dict(kind="heavy_tail", alpha=1.2), 2, 4,
                 id="heavy_tail_cap2"),
]


def _runs(arrival, cap, rounds, seed=5):
    n = PROB["n"]
    kw = dict(n=n, gamma=0.05, rounds=rounds, staleness_cap=cap, seed=seed)
    want = jax_part.run_async(
        JaxLogistic(**PROB),
        jax_ef.EF21SGDM(compressor=jax_comp.BlockTopK(block=8,
                                                      k_per_block=2),
                        eta=0.2),
        arrival=jax_part.ArrivalModel(**arrival), **kw)
    got = pt_part.run_async(
        PtLogistic(device="cpu", **PROB),
        pt_ef.EF21SGDM(compressor=pt_comp.BlockTopK(block=8, k_per_block=2),
                       eta=0.2),
        arrival=pt_part.ArrivalModel(**arrival), **kw)
    return want, got


@pytest.mark.parametrize("arrival,cap,rounds", SCENARIOS)
def test_event_accounting_equals_reference(arrival, cap, rounds):
    want, got = _runs(arrival, cap, rounds)
    for k in EVENT_KEYS:
        assert got[k] == want[k], (k, got[k], want[k])
    np.testing.assert_array_equal(got["stale_age_hist"],
                                  want["stale_age_hist"])
    assert got["stale_age_hist"].sum() == got["arrivals_applied"]
    if cap is not None:
        assert got["max_staleness"] <= cap
    # full-batch clients: the trajectory itself agrees
    gw = np.asarray(want["grad_norm_sq_per_round"], np.float64)
    gg = np.asarray(got["grad_norm_sq_per_round"], np.float64)
    assert gg.shape == gw.shape == (rounds,)
    np.testing.assert_allclose(gg, gw, rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm_sq"], want["grad_norm_sq"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["x_final"][""],
                               np.asarray(want["x_final"]), rtol=1e-4,
                               atol=1e-4 * np.abs(want["x_final"]).max())


def test_heavy_tail_beats_the_barrier_and_dropout_never_deadlocks():
    _, got = _runs(dict(kind="heavy_tail", alpha=1.3), None, 5)
    assert got["wall_clock"] < got["sync_wall_clock"]
    _, got = _runs(dict(kind="dropout", drop_prob=0.5), None, 3)
    assert got["arrivals_applied"] == 12 and got["arrivals_dropped"] > 0


@pytest.mark.parametrize("kind", ["uniform", "heavy_tail", "dropout"])
@pytest.mark.parametrize("seed", [0, 9])
def test_sync_barrier_wallclock_equals_reference(kind, seed):
    for n, rounds in ((1, 3), (8, 20)):
        want = jax_part.sync_barrier_wallclock(
            jax_part.ArrivalModel(kind=kind), n, rounds, seed=seed)
        got = pt_part.sync_barrier_wallclock(
            pt_part.ArrivalModel(kind=kind), n, rounds, seed=seed)
        assert got == want


def test_arrival_model_refusals_match_reference():
    for bad in (dict(kind="burst"), dict(kind="heavy_tail", alpha=1.0),
                dict(drop_prob=1.0), dict(drop_prob=-0.1)):
        with pytest.raises(ValueError):
            jax_part.ArrivalModel(**bad)
        with pytest.raises(ValueError):
            pt_part.ArrivalModel(**bad)


def test_absolute_mode_is_refused_with_the_reference_message():
    kw = dict(n=2, gamma=0.1, rounds=1)
    with pytest.raises(ValueError, match="delta-mode") as want:
        jax_part.run_async(JaxLogistic(**PROB), jax_ef.EF14SGD(), **kw)
    with pytest.raises(ValueError, match="delta-mode") as got:
        pt_part.run_async(PtLogistic(device="cpu", **PROB), pt_ef.EF14SGD(),
                          **kw)
    assert str(got.value) == str(want.value)
