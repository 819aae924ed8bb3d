# NOTE: no XLA_FLAGS here — smoke tests and benches must see exactly ONE device
# (the 512-device placeholder mesh belongs to launch/dryrun.py only).
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running convergence/e2e tests — excluded from the PR "
        "gate (`pytest -m tier1`), run in full on main")
    config.addinivalue_line(
        "markers",
        "tier1: fast PR-gating tier, auto-applied to every test not marked "
        "slow (never set it by hand)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand kernels have no CPU "
        "mode); skips with a reason elsewhere")


def pytest_collection_modifyitems(config, items):
    # tier1 := not slow, maintained automatically so new tests default into
    # the PR gate and only deliberate `slow` marks opt out
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.tier1)


@pytest.fixture(scope="session")
def step_cache():
    """Session-scoped memo for jitted train steps. Tests that sweep carriers
    re-trace the same production step dozens of times; compiling once per
    configuration cuts minutes off the suite. Entries are jitted callables —
    pure, so sharing across tests is safe PROVIDED the key includes
    everything the cached step closes over: the loss function, the optimizer
    config, the method, the carrier, and dp (see tests/test_carriers.py
    ``_trajectory`` for the canonical keying)."""
    return {}
