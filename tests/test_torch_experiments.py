"""The port's experiment drivers (repro_torch.experiments) keep the
reference scripts' constants (benchmarks/fig1_divergence.py, exp1–4), and
each runs end to end on the CPU at a few steps, writing its claims to
results/torch/<name>.json (here into a temporary directory)."""
import importlib
import json

import pytest

from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

DRIVERS = {  # name: (constants to compare, the CPU run's cuts)
    "fig1_divergence": (("SEEDS", "STEPS"), dict(SEEDS=1, STEPS=30)),
    "exp1_batchsize": (("SEEDS", "STEPS", "N", "K"), dict(SEEDS=1, STEPS=4)),
    "exp2_nspeedup": (("SEEDS", "STEPS", "B", "K", "GAMMA"),
                      dict(SEEDS=1, STEPS=3)),
    "exp3_quadratic": (("SEEDS", "STEPS", "D", "N"), dict(SEEDS=1, STEPS=4)),
    "exp4_neuralnet": (("SEEDS", "STEPS", "N"), dict(SEEDS=1, STEPS=3)),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_keeps_the_reference_constants_and_runs(name, monkeypatch,
                                                       tmp_path):
    keys, cuts = DRIVERS[name]
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"repro_torch.experiments.{name}")
    for k in keys:
        assert getattr(port, k) == getattr(ref, k), k
    from repro_torch.experiments import common
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    for k, v in cuts.items():
        monkeypatch.setattr(port, k, v)
    out = port.run(device="cpu")
    with open(tmp_path / f"{name}.json") as f:
        saved = json.load(f)
    assert saved["claims"] == out["claims"] and out["claims"]
    assert all(isinstance(v, bool) for v in out["claims"].values())


def test_drivers_default_to_cuda():
    """With no card the drivers' default device fails loudly: nothing falls
    back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    from repro_torch.experiments import fig1_divergence
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fig1_divergence.run()
