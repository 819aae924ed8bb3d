"""The port's spec emitter (``python -m repro_torch.launch.spec``) against
the reference's (``python -m repro.launch.spec``): ``--print`` byte for byte
for a grid of flags, ``--regen-goldens`` into a scratch directory equal to
``results/specs/``, ``to_flags``/``from_flags`` round trips, and the
``--shape`` flag taken by the training CLI. The reference's emitter imports
no jax, so both run in this process's interpreter as subprocesses."""
import argparse
import os
import subprocess
import sys

import pytest

from repro.launch import spec as jax_spec
from repro_torch.launch import spec as pt_spec

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPECS = os.path.join(ROOT, "results", "specs")

FLAG_GRID = [
    [],
    ["--arch", "gemma2-9b", "--carrier", "sparse"],
    ["--arch", "gemma2-9b", "--shape", "train_4k", "--mesh", "pod",
     "--carrier", "sparse", "--compressor", "topk", "--ratio", "0.01"],
    ["--shape", "decode_32k", "--arch", "internvl2-76b"],
    ["--smoke", "--carrier", "quant4", "--clients", "4", "--global-batch",
     "8", "--seq", "64", "--downlink-carrier", "quant4",
     "--downlink-ratio", "0.02"],
    ["--schedule", "norm|bias=dense,embed=quant4:0.05,*=sparse:0.02",
     "--smoke", "--clients", "4"],
    ["--participation", "sampled:0.25:7", "--smoke"],
    ["--hops", "pods=2,cross=quant4:0.05", "--smoke"],
    ["--arch", "grok-1-314b", "--carrier", "quant4", "--mesh", "multi_pod",
     "--shape", "train_4k", "--granularity", "pod", "--state-sharding",
     "zero", "--ef-state-dtype", "bfloat16"],
    ["--carrier", "fused_quant8", "--eta", "0.2", "--overlap",
     "--compressor-kw", '{"block": 1024, "k_per_block": 16}',
     "--method-kw", '{}', "--tp-pad-heads", "2", "--moe-impl", "dense",
     "--optimizer", "adamw", "--lr", "0.001", "--heterogeneity", "0.1",
     "--seed", "3", "--ckpt-dir", "/tmp/ck", "--ckpt-every", "2"],
    ["--spec", os.path.join(SPECS, "fused_quickstart.json"), "--no-smoke",
     "--shape", "prefill_32k"],
]


def _emit(module, argv, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=cwd,
                         env=env, capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    return out.stdout


@pytest.mark.parametrize("argv", FLAG_GRID,
                         ids=[" ".join(a[:4]) or "defaults"
                              for a in FLAG_GRID])
def test_print_is_the_reference_s_byte_for_byte(argv):
    got = _emit("repro_torch.launch.spec", ["--print", *argv])
    want = _emit("repro.launch.spec", ["--print", *argv])
    assert got == want


@pytest.mark.parametrize("argv", FLAG_GRID[1:4])
def test_out_writes_what_print_prints(argv, tmp_path):
    out = tmp_path / "cell.json"
    printed = _emit("repro_torch.launch.spec", ["--print", "--out", str(out),
                                                *argv])
    assert out.read_bytes() == printed
    ref = tmp_path / "ref.json"
    _emit("repro.launch.spec", ["--out", str(ref), *argv])
    assert out.read_bytes() == ref.read_bytes()


def test_regen_goldens_reproduces_results_specs(tmp_path):
    listed = _emit("repro_torch.launch.spec",
                   ["--regen-goldens", "--goldens-dir", str(tmp_path)])
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f for f in os.listdir(SPECS)
                           if f.endswith(".json"))
    assert len(listed.decode().split()) == len(names)
    for name in names:
        with open(os.path.join(SPECS, name), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read(), name


def test_golden_definitions_are_the_reference_s():
    assert pt_spec.GOLDEN_SPECS == jax_spec.GOLDEN_SPECS


def test_flag_surface_is_the_reference_s():
    assert pt_spec._FLAGS == jax_spec._FLAGS
    assert pt_spec._FLAG_CHOICES == jax_spec._FLAG_CHOICES
    assert set(pt_spec._FLAG_HELP) == set(jax_spec._FLAG_HELP)


@pytest.mark.parametrize("argv", FLAG_GRID[:-1],
                         ids=[" ".join(a[:4]) or "defaults"
                              for a in FLAG_GRID[:-1]])
def test_to_flags_from_flags_round_trip(argv):
    spec = pt_spec.RunSpec.from_flags(argv)
    assert pt_spec.RunSpec.from_flags(spec.to_flags()) == spec
    ref = jax_spec.RunSpec.from_flags(argv)
    assert spec.to_flags() == ref.to_flags()
    assert spec.spec_hash() == ref.spec_hash()


@pytest.mark.parametrize("name", sorted(pt_spec.GOLDEN_SPECS))
def test_goldens_round_trip_through_flags(name):
    spec = pt_spec.RunSpec(**pt_spec.GOLDEN_SPECS[name])
    assert pt_spec.RunSpec.from_flags(spec.to_flags()) == spec


@pytest.mark.parametrize("name", ["dryrun_sparse_pod", "fused_quickstart",
                                  "quant4_multipod_zero"])
def test_previews_are_the_reference_s(name):
    ours = pt_spec.RunSpec(**pt_spec.GOLDEN_SPECS[name])
    ref = jax_spec.RunSpec(**jax_spec.GOLDEN_SPECS[name])
    assert ours.plan() == ref.plan()
    assert ours.downlink_plan() == ref.downlink_plan()
    assert ours.train_kind() == ref.train_kind()
    assert ours.train_batch() == ref.train_batch()


def test_train_cli_takes_shape(capsys):
    """``--shape`` parses in the training CLI as in the reference's (a
    named shape training ignores); an unknown name is refused."""
    from repro_torch.launch import train
    train.main(["--shape", "train_4k", "--smoke", "--seq", "32",
                "--global-batch", "4", "--clients", "2", "--steps", "1",
                "--device", "cpu", "--log-every", "1"])
    assert "step     0 loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train.main(["--shape", "train_5k", "--device", "cpu"])


def test_explicit_fields_name_the_spec_file():
    ap = argparse.ArgumentParser()
    pt_spec.add_flags(ap)
    args = ap.parse_args(["--spec", "x.json", "--seed", "2"])
    jap = argparse.ArgumentParser()
    jax_spec.add_flags(jap)
    jargs = jap.parse_args(["--spec", "x.json", "--seed", "2"])
    assert pt_spec.explicit_fields(args) == jax_spec.explicit_fields(jargs)
