"""Checkpoints across the two packages: the port's ``spec_hash``, its npz
layout (repro_torch.checkpoint.checkpoint) and its Session's save /
restore_from / resume, against the reference's.

* ``spec_hash``: the same 16 hex digits as the reference for every spec
  both accept, so each package's resume accepts the other's checkpoint
  without ``allow_spec_mismatch``.
* The npz round trip is exact leaf for leaf, bfloat16 included (stored as
  f32, cast back).
* A JAX smoke Session (bf16 EF state, AdamW, fused_quant8 up and
  fused_quant4 down, f32 activations) saves after 2 steps; the torch
  Session resumes that checkpoint and trains to step 4 with loss and g_norm
  within rtol 1e-4 of the JAX run's own steps 2 and 3 (the one thing that
  can cross it is a near-tie in a selection, test_torch_train.py), and its
  held-out loss within rtol 1e-5. The reverse: a torch save that the JAX
  Session restores without ``allow_spec_mismatch``, every leaf equal.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro_torch.checkpoint import checkpoint as pt_ckpt
from repro_torch.core import ef as pt_ef
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.launch import train as pt_train
from test_torch_schedule import torch_threads

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPEC = os.path.join(ROOT, "results", "specs", "fused_quickstart.json")
RESUMABLE = {"smoke": True, "seq_len": 64, "carrier": "fused_quant8",
             "downlink_carrier": "fused_quant4", "ef_state_dtype": "bfloat16",
             "optimizer": "adamw", "lr": 1e-3}


def _spec_dict(**overrides):
    with open(SPEC) as f:
        return dict(json.load(f), **overrides)


@pytest.mark.parametrize("overrides", [
    pytest.param(None, id="default"),
    pytest.param({}, id="fused_quickstart"),
    pytest.param(RESUMABLE, id="bf16_adamw"),
    pytest.param({"method_kw": {"eta": 0.5}, "carrier": "quant8"},
                 id="method_kw"),
    pytest.param({"ckpt_dir": "/elsewhere", "ckpt_every": 5},
                 id="ckpt_policy_excluded"),
])
def test_spec_hash_matches_reference(overrides):
    d = dict(jax_spec.RunSpec().to_dict()) if overrides is None \
        else _spec_dict(**overrides)
    got = pt_spec.RunSpec.from_dict(d).spec_hash()
    assert got == jax_spec.RunSpec.from_dict(d).spec_hash()
    assert len(got) == 16 and int(got, 16) >= 0
    if overrides and "ckpt_dir" in overrides:
        assert got == pt_spec.RunSpec.from_dict(_spec_dict()).spec_hash()


def test_spec_diff_names_each_differing_field():
    a = pt_spec.RunSpec.from_dict(_spec_dict())
    b = dataclasses.replace(a, eta=0.3, optimizer="adamw")
    assert a.diff(b) == ["eta: 0.2 != 0.3", "optimizer: 'sgd' != 'adamw'"]
    assert a.diff(b) == jax_spec.RunSpec.from_dict(a.to_dict()).diff(
        jax_spec.RunSpec.from_dict(b.to_dict()))


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"embed": torch.tensor(rng.randn(6, 4), dtype=torch.float32),
                       "layers/attn/wq": torch.tensor(rng.randn(2, 4, 3))
                       .float()},
            "opt_state": {"m": {"embed": torch.tensor(rng.randn(6, 4))
                                .float()}},
            "ef_state": {"clients": {"v": {"embed": torch.tensor(
                rng.randn(3, 6, 4)).to(torch.bfloat16)}},
                "server": {"embed": torch.tensor(rng.randn(6, 4)).float()},
                "step_count": torch.tensor([7], dtype=torch.int32)}}


def test_npz_round_trip_is_exact_and_the_reference_layout(tmp_path):
    tree = _tree(0)
    spec = pt_spec.RunSpec.from_dict(_spec_dict(**RESUMABLE))
    path = str(tmp_path / "sub" / "step_3.npz")
    pt_ckpt.save(path, tree, step=3, spec=spec)
    assert os.listdir(tmp_path / "sub") == ["step_3.npz"]   # no partial left
    like = pt_ef.tree_map(torch.zeros_like, pt_ef.flatten(tree))
    nested = {"params": {k[len("params/"):]: v for k, v in like.items()
                         if k.startswith("params/")},
              "opt_state": {"m": {"embed": like["opt_state/m/embed"]}},
              "ef_state": {"clients": {"v": {
                  "embed": like["ef_state/clients/v/embed"]}},
                  "server": {"embed": like["ef_state/server/embed"]},
                  "step_count": like["ef_state/step_count"]}}
    got, meta = pt_ckpt.restore(path, nested)
    want = pt_ef.flatten(tree)
    for k, v in pt_ef.flatten(got).items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    assert meta == pt_ckpt.read_meta(path)
    assert meta["step"] == 3 and meta["spec_hash"] == spec.spec_hash()
    assert meta["spec"] == spec.to_dict()
    with np.load(path) as z:                 # the reference's npz layout
        assert sorted(z.files) == sorted(list(want) + ["__meta__"])
        assert z["ef_state/clients/v/embed"].dtype == np.float32
        assert z["ef_state/step_count"].dtype == np.int32
    # and the reference's own restore reads it, bf16 cast back
    jlike = {"ef_state": {"clients": {"v": {"embed": jnp.zeros(
        (3, 6, 4), jnp.bfloat16)}}}}
    jgot, _ = jax_ckpt.restore(path, jlike)
    np.testing.assert_array_equal(
        np.asarray(jgot["ef_state"]["clients"]["v"]["embed"]
                   .astype(jnp.float32)),
        want["ef_state/clients/v/embed"].float().numpy())


def test_restore_refuses_a_shape_it_does_not_hold(tmp_path):
    path = str(tmp_path / "c.npz")
    pt_ckpt.save(path, {"params": {"embed": torch.zeros(2, 3)}})
    with pytest.raises(ValueError, match="shape"):
        pt_ckpt.restore(path, {"params": {"embed": torch.zeros(3, 2)}})


def test_latest_and_parse_step(tmp_path):
    assert pt_ckpt.latest(str(tmp_path / "absent")) is None
    assert pt_ckpt.latest(str(tmp_path)) is None
    for name in ("step_2.npz", "step_10.npz", "final.npz",
                 "step_99xyz.tmp.npz", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert pt_ckpt.latest(str(tmp_path)) == str(tmp_path / "step_10.npz")
    assert jax_ckpt.latest(str(tmp_path)) == pt_ckpt.latest(str(tmp_path))
    for name in ("run2/step_100.npz", "step_00000007.npz", "final.npz",
                 "a1b22.npz"):
        assert pt_ckpt.parse_step(name) == jax_ckpt.parse_step(name)
    assert pt_ckpt.parse_step("run2/step_100.npz") == 100
    assert pt_ckpt.parse_step("final.npz") is None


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX smoke Session of RESUMABLE in f32 activations: 2 steps, a
    save, its held-out loss, then steps 2 and 3."""
    ckpt_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    jsess = jax_session.Session(jax_spec.RunSpec.from_dict(
        _spec_dict(**RESUMABLE)))
    jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
    jsess.train(2, log_every=1)
    path = jsess.save(os.path.join(ckpt_dir, "step_00000002.npz"))
    evaluated = jsess.evaluate()
    after = jsess.train(4, log_every=1)
    return {"dir": ckpt_dir, "path": path, "eval": evaluated,
            "after": after}


def test_jax_checkpoint_resumes_in_the_torch_session(jax_run):
    psess = pt_session.Session.resume(jax_run["dir"], device="cpu",
                                      dtype="float32")
    assert psess.step == 2 and psess.spec.ckpt_dir == jax_run["dir"]
    clients = psess.ef_state["clients"]
    assert all(t.dtype == torch.bfloat16 for tree in clients.values()
               for t in tree.values())
    assert sorted(psess.opt_state) == ["m", "v"]
    np.testing.assert_allclose(psess.evaluate(), jax_run["eval"], rtol=1e-5)
    got = psess.train(4, log_every=1)
    want = jax_run["after"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 3]
    for key in ("loss", "g_norm"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4,
                                   err_msg=key)


def test_torch_checkpoint_restores_in_the_jax_session(tmp_path):
    spec = _spec_dict(**RESUMABLE)
    psess = pt_session.Session(pt_spec.RunSpec.from_dict(spec), device="cpu",
                               dtype="float32")
    psess.train(2, log_every=1)
    path = psess.save(str(tmp_path / "step_00000002.npz"))
    jsess = jax_session.Session(jax_spec.RunSpec.from_dict(spec))
    jsess.restore_from(path)                 # no allow_spec_mismatch
    assert jsess.step == 2
    want = pt_ef.flatten({"params": psess.params,
                          "opt_state": psess.opt_state,
                          "ef_state": psess.ef_state})
    got = {}
    for name in ("params", "opt_state", "ef_state"):
        flat, _ = jax.tree_util.tree_flatten_with_path(getattr(jsess, name))
        for p, leaf in flat:
            got["/".join([name] + [str(k.key) for k in p])] = leaf
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert str(got[k].dtype) == str(v.dtype).replace("torch.", ""), k
        np.testing.assert_array_equal(
            np.asarray(got[k].astype(jnp.float32)), v.float().numpy(),
            err_msg=k)
    resumed = jax_session.Session.resume(str(tmp_path))
    assert resumed.step == 2


def test_a_foreign_spec_is_refused_with_the_field_diff(tmp_path):
    spec = pt_spec.RunSpec.from_dict(_spec_dict(smoke=True, seq_len=32,
                                                global_batch=8))
    sess = pt_session.Session(spec, device="cpu")
    path = sess.save(str(tmp_path / "step_00000000.npz"))
    other = pt_session.Session(dataclasses.replace(spec, eta=0.3),
                               device="cpu")
    with pytest.raises(ValueError, match=r"(?s)different RunSpec.*"
                       r"eta: 0\.3 != 0\.2"):
        other.restore_from(path)
    assert other._tr is None                 # no template left behind
    with pytest.raises(ValueError, match="different RunSpec"):
        pt_session.Session.resume(str(tmp_path), overrides={"eta": 0.3},
                                  device="cpu")
    other.restore_from(path, allow_spec_mismatch=True)
    assert other.step == 0
    # the checkpoint policy is not part of the experiment
    moved = pt_session.Session.resume(str(tmp_path), device="cpu",
                                      overrides={"ckpt_every": 3})
    assert moved.spec.ckpt_every == 3 and moved.spec.ckpt_dir == str(tmp_path)


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    base = ["--smoke", "--seq", "32", "--global-batch", "8", "--clients",
            "4", "--carrier", "fused_quant8", "--downlink-carrier",
            "fused_quant4", "--ef-state-dtype", "bfloat16", "--optimizer",
            "adamw", "--lr", "1e-3", "--device", "cpu", "--log-every", "1"]
    pt_train.main(base + ["--steps", "2", "--ckpt-dir", ckpt,
                          "--ckpt-every", "1"])
    assert sorted(os.listdir(ckpt)) == ["step_00000001.npz",
                                        "step_00000002.npz"]
    first = capsys.readouterr().out
    assert "step     1 loss" in first and "saved checkpoint @ 2" in first
    # a bare resume takes everything from the embedded spec
    pt_train.main(["--ckpt-dir", ckpt, "--resume", "--steps", "3",
                   "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "@ step 2" in out and "step     2 loss" in out
    assert "optimizer=adamw ef_state_dtype=bfloat16" in out
    assert "step_00000003.npz" in os.listdir(ckpt)
    with pytest.raises(ValueError, match="different RunSpec"):
        pt_train.main(["--ckpt-dir", ckpt, "--resume", "--steps", "4",
                       "--device", "cpu", "--eta", "0.9"])


# --------------------------------------------------------------------------
# grouped, pod and sampled state
# --------------------------------------------------------------------------

def _shipped(name):
    with open(os.path.join(ROOT, "results", "specs", f"{name}.json")) as f:
        return json.load(f)


def _leaves(sess):
    """Every leaf of a Session's training state keyed by its npz path, as
    (dtype name, f32 numpy): either package's."""
    out = {}
    for name in ("params", "opt_state", "ef_state"):
        tree = getattr(sess, name)
        if isinstance(sess, pt_session.Session):
            for k, v in pt_ef.flatten({name: tree}).items():
                out[k] = (str(v.dtype).replace("torch.", ""),
                          v.float().numpy())
        else:
            flat, _ = jax.tree_util.tree_flatten_with_path(tree)
            for p, leaf in flat:
                out["/".join([name] + [str(k.key) for k in p])] = (
                    str(leaf.dtype), np.asarray(leaf.astype(jnp.float32)))
    return out


def _assert_same_leaves(got, want):
    assert sorted(got) == sorted(want)
    for k, (dt, v) in want.items():
        assert got[k][0] == dt, k
        np.testing.assert_array_equal(got[k][1], v, err_msg=k)


@pytest.mark.parametrize("spec", [
    pytest.param(_spec_dict(smoke=True, seq_len=64, groups=[
        {"pattern": "norm|bias", "carrier": "dense"},
        {"pattern": "embed", "carrier": "fused_quant8",
         "downlink_carrier": "fused_quant4", "ef_state_dtype": "bfloat16"},
        {"pattern": "*", "carrier": "fused_quant8",
         "downlink_carrier": "fused_quant4"}]), id="grouped_bf16_group"),
    pytest.param(_shipped("hierarchy_quant4_cross"), id="hops_pods_state"),
])
@torch_threads(1)
def test_grouped_and_pod_state_cross_the_packages(tmp_path, spec):
    """The reference saves after a step and the port resumes it, leaf for
    leaf (a bf16 group's v and g beside f32 ones; ``ef_state/pods/{t,b}``
    with its leading pods axis); the port trains on and saves, and the
    reference restores that, leaf for leaf, without allow_spec_mismatch."""
    jsess = jax_session.Session(jax_spec.RunSpec.from_dict(spec))
    jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
    jsess.train(1, log_every=1)
    jsess.save(str(tmp_path / "jax" / "step_00000001.npz"))
    psess = pt_session.Session.resume(str(tmp_path / "jax"), device="cpu",
                                      dtype="float32")
    assert psess.step == 1
    _assert_same_leaves(_leaves(psess), _leaves(jsess))
    keys = _leaves(psess)
    if spec["groups"]:
        assert keys["ef_state/clients/v/embed"][0] == "bfloat16"
        assert keys["ef_state/clients/v/layers/mlp/w_up"][0] == "float32"
    else:
        assert keys["ef_state/pods/b/embed"][1].shape[0] == 2
    psess.train(2, log_every=1)
    path = psess.save(str(tmp_path / "pt" / "step_00000002.npz"))
    back = jax_session.Session(jax_spec.RunSpec.from_dict(spec))
    back.restore_from(path)
    assert back.step == 2
    _assert_same_leaves(_leaves(back), _leaves(psess))


@pytest.mark.parametrize("carrier", ["dense", "fused"])
@torch_threads(1)
def test_sampled_run_resumes_on_the_same_cohorts(tmp_path, carrier):
    """Kill and resume a sampled run on the CPU: 2 steps, a checkpoint, a
    new Session from it, 2 more, bit for bit the uninterrupted 4 (the
    reference's test_participation.py holds its own Session so)."""
    spec = _shipped("sampled_quarter")
    if carrier == "fused":
        spec.update(carrier="fused",
                    compressor_kw={"block": 1024, "k_per_block": 16})
    whole = pt_session.Session(pt_spec.RunSpec.from_dict(spec), device="cpu")
    want = whole.train(4, log_every=1)
    first = pt_session.Session(pt_spec.RunSpec.from_dict(dict(
        spec, ckpt_dir=str(tmp_path), ckpt_every=2)), device="cpu")
    first.train(2, log_every=1)
    resumed = pt_session.Session.resume(str(tmp_path), device="cpu")
    assert resumed.step == 2
    got = resumed.train(4, log_every=1)
    assert got == want[2:]
    _assert_same_leaves(_leaves(resumed), _leaves(whole))
