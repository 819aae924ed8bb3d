"""The port's examples (``python -m repro_torch.examples.<name>``, the
counterparts of examples/*.py) on the CPU at a few steps: each equals the
API run of the same specs — the quickstart's histories a Session's, the
ablation's rows the simulator's on the same RunSpecs, the streaming demo's
replicas bit for bit the trainer and its history a plain Session's."""
import numpy as np

from repro_torch.core import problems, simulate
from repro_torch.examples import compression_ablation, distributed_serve
from repro_torch.examples import quickstart
from repro_torch.launch import build as build_lib
from repro_torch.launch.session import Session

from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

STEPS = 2


def test_quickstart_equals_the_session_runs():
    out = quickstart.main(["--steps", str(STEPS), "--device", "cpu",
                           "--log-every", "1"])
    assert [o["name"] for o in out] == [n for n, _ in quickstart.SPECS]
    for o in out:
        sess = Session(o["spec"], device="cpu")
        sess.train(STEPS, log_every=1)
        assert o["history"] == sess.history
    ef, sgdm = out
    assert ef["coords"] < 0.05 * ef["d"] and sgdm["coords"] == sgdm["d"]


def test_compression_ablation_rows_are_the_simulator_s():
    out = compression_ablation.main(["--steps", "6", "--mixed-steps", "4",
                                     "--device", "cpu"])
    grid = compression_ablation.grid()
    assert len(out["rows"]) == len(grid) == 22
    prob = problems.LogisticRegression(n=8, m_per_client=128, l=32, c=5,
                                       seed=0, device="cpu")
    for spec, row in zip(grid[::7], out["rows"][::7]):
        m = build_lib.make_method(spec)
        want = simulate.run_numpy(
            prob, m, compression_ablation.sim_config(spec, 6), seed=0)
        assert row[0] == spec.method
        assert row[2] == float(np.asarray(want["grad_norm_sq"][-100:])
                               .mean())
        assert row[4] == want["wire_words_total_per_round"]
    mixed, uniform = out["scheduled"]["mixed"], out["scheduled"]["uniform"]
    assert mixed["wire_words_up_per_round"] \
        < uniform["wire_words_up_per_round"]


def test_distributed_serve_replicas_are_the_trainer(tmp_path):
    out = distributed_serve.main(["--steps", "3", "--requests", "2",
                                  "--device", "cpu", "--stream-dir",
                                  str(tmp_path / "wire")])
    assert out["identical"]["r0"]
    assert len(out["fleet"]["requests"]) == 2
    plain = Session(distributed_serve.SPEC, device="cpu")
    plain.train(3, log_every=1)
    got = [(h["step"], h["loss"]) for h in out["trainer"].history]
    assert got == [(h["step"], h["loss"]) for h in plain.history
                   if h["step"] in dict(got)]
