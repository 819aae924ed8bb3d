"""Package-level guarantees of the PyTorch port: it imports neither JAX nor
the reference package, its entry points run on cuda unless told otherwise,
and its RunSpec reads the reference's spec files and refuses what this
slice does not run."""
import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

_GUARD = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: F401  (its work runs under __main__ only)
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "repro") or n.startswith(("jax.", "repro.")))
print(len([n for n in sys.modules if n.startswith("repro_torch")]), bad)
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {os.path.abspath(ROOT)!r}\n" + _GUARD],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) > 15          # every module was walked


def _imports(path):
    """(module, names) of every import statement in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, ()
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", tuple(a.name for a in node.names)


def test_sources_import_neither_jax_nor_the_reference_nor_plain_versions():
    """Read from the sources, so an import behind a branch counts too: no
    file of the port or chip_smoke.py imports jax or ``repro``, and no module
    of core/, models/ or launch/ reaches kernels/ref.py — they go through
    the kernel wrappers (chip_smoke.py may, to check the kernels)."""
    port = os.path.join(SRC, "repro_torch")
    files = glob.glob(os.path.join(port, "**", "*.py"), recursive=True)
    assert len(files) > 15
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        for mod, _ in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
    for sub in ("core", "models", "launch"):
        for path in glob.glob(os.path.join(port, sub, "*.py")):
            for mod, names in _imports(path):
                assert mod != "repro_torch.kernels.ref", (path, mod)
                assert not (mod == "repro_torch.kernels" and "ref" in names), \
                    (path, mod, names)


def test_session_defaults_to_cuda():
    spec = pt_spec.RunSpec(smoke=True, seq_len=16)
    if torch.cuda.is_available():
        assert pt_session.Session(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            pt_session.Session(spec)
    assert pt_session.Session(spec, device="cpu").device.type == "cpu"


def test_spec_reads_the_reference_golden_file():
    with open(os.path.join(ROOT, "results", "specs",
                           "fused_quickstart.json")) as f:
        spec = pt_spec.RunSpec.from_json(f.read())
    assert (spec.carrier, spec.eta, spec.compressor_kw) == (
        "fused", 0.2, {"block": 1024, "k_per_block": 16})
    assert pt_spec.RunSpec.from_json(spec.to_json()) == spec


@pytest.mark.parametrize("bad", [
    {"tp_pad_heads": 2},
    {"state_sharding": "zero"}, {"optimizer": "lion"},
    {"client_granularity": "pod"},
    {"ef_state_dtype": "float16"},
    {"carrier": "fused", "compressor_kw": {"block": 2048}},
    {"global_batch": 12},
])
def test_spec_rejects_what_this_slice_does_not_run(bad):
    with pytest.raises(ValueError, match="invalid RunSpec"):
        pt_spec.RunSpec(**bad)


@pytest.mark.parametrize("fields", [{"mesh": "pod"}, {"overlap": True}])
def test_spec_takes_what_this_slice_runs(fields):
    """The pod mesh and overlap were refused until the multi-device slice
    (they were cases of the refusal test above): the port's spec now takes
    each as the reference's does, under the same spec_hash."""
    from repro.launch import spec as jax_spec
    spec = pt_spec.RunSpec(**fields)
    assert spec.spec_hash() == jax_spec.RunSpec(**fields).spec_hash()
    assert pt_spec.RunSpec.from_json(spec.to_json()) == spec


@pytest.mark.parametrize("fields", [
    {"compressor": "randk"}, {"method": "neolithic"},
    {"participation": {"mode": "async"}},
])
def test_spec_takes_what_was_refused_before_the_simulator(fields):
    """The rng compressors, the paired and R-round methods and mode 'async'
    were refused until the simulator's slice: the port's spec now takes
    each as the reference's does, under the same spec_hash."""
    from repro.launch import spec as jax_spec
    spec = pt_spec.RunSpec(**fields)
    assert spec.spec_hash() == jax_spec.RunSpec(**fields).spec_hash()
    assert pt_spec.RunSpec.from_json(spec.to_json()) == spec


def test_spec_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown RunSpec keys"):
        pt_spec.RunSpec.from_dict({"version": 5, "warp_speed": 9})
