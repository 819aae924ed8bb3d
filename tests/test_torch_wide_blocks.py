"""Block-TopK blocks of any width: the port's RunSpec, carriers, Session and
dry run against the reference's.

The reference's kernels take a block of any width; so does the port, whose
K1-K3 take rows wider than 1024 on the card's wide route (csrc/wide.cuh;
tests/test_torch_cuda.py holds it against the plain versions, which
tests/test_torch_kernels.py holds against the Pallas kernels). Here:
  * the spec grid: for every (uplink carrier, downlink carrier, block) the
    port's RunSpec accepts, refuses and degrades where the reference's
    does, with equal ``spec_hash`` and plan previews where both accept;
  * two smoke-size smollm-360m Sessions per package from the same npz
    state, fused_quant8 up and fused_quant4 down, at block 2048 (k 32) and
    at the odd block 1023 (k 16, which fused_quant4 runs on its downlink):
    loss and g_norm within rtol 1e-4 over 2 steps, as the fused-carrier
    parity of tests/test_torch_train.py holds them, and the wire's integer
    accounting (words a leaf up and down, the downlink payload's mantissas
    and scales) exactly;
  * the dry run (``Session.lower``) of a block-4096 step: its traced
    launches are the ones chip_smoke.py's ``expected_launches`` derives.
"""
import dataclasses
import importlib.util
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import carriers as jax_carriers
from repro.core import compressors as jax_comp
from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro_torch.core import carriers as pt_carriers
from repro_torch.core import compressors as pt_comp
from repro_torch.kernels import ops
from repro_torch.launch import build as pt_build
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPEC = os.path.join(ROOT, "results", "specs", "fused_quickstart.json")
UP = ["dense", "sparse", "quant8", "quant4", "fused", "fused_quant8",
      "fused_quant4"]
DOWN = UP
BLOCKS = [1, 2, 1023, 1024, 1025, 2048, 3000, 4096]


def _base():
    with open(SPEC) as f:
        return json.load(f)


def _kw(block):
    return {"block": block, "k_per_block": min(16, block)}


def _outcome(mod, d):
    """(spec_hash, plan, downlink plan) of the package's RunSpec, or the
    refusal."""
    try:
        spec = mod.RunSpec.from_dict(d)
    except ValueError as e:
        assert "invalid RunSpec" in str(e)
        return "refused"
    return spec.spec_hash(), spec.plan(), spec.downlink_plan()


@pytest.mark.parametrize("up,down,block", [
    pytest.param(u, d, b, id=f"{u}-{d}-{b}")
    for u, d, b in itertools.product(UP, DOWN, BLOCKS)])
def test_spec_takes_every_block_the_reference_takes(up, down, block):
    """fused up, dense down, block 2048 was refused while the fused kernels
    took rows up to 1024: every cell now accepts, refuses or degrades where
    the reference's RunSpec does. An odd block on a
    fused_quant4 uplink degrades there (uint4 packing), which both refuse
    as a DEGRADED fused plan; on a fused_quant4 downlink both run it."""
    d = dict(_base(), carrier=up, downlink_carrier=down,
             compressor_kw=_kw(block))
    want = _outcome(jax_spec, d)
    assert _outcome(pt_spec, d) == want
    if (up, down, block) == ("fused", "dense", 2048):
        assert want != "refused"


@pytest.mark.parametrize("up,down,block,k,want", [
    ("fused", "dense", 2048, 32, "4cf436c65db1f0a7"),
    ("fused", "dense", 4096, 64, "0272cf4a9b1f70b4"),
    ("fused", "dense", 3000, 47, "76fe391e9631fc4f"),
    ("fused_quant8", "fused_quant4", 4096, 16, "f4d36d980bcaca90"),
    ("fused_quant8", "fused_quant4", 4096, 64, "224a09473a0a84a5"),
    ("fused_quant8", "dense", 5000, 16, "b391881fcbc41c7b"),
    ("fused_quant8", "fused_quant4", 1023, 16, "eae6385b34a3210d")])
def test_wide_and_odd_blocks_keep_the_reference_hash(up, down, block, k,
                                                     want):
    """The reference's hashes of fused_quickstart.json with these carriers
    and blocks: the port's spec takes each under the same hash."""
    d = dict(_base(), carrier=up, downlink_carrier=down,
             compressor_kw={"block": block, "k_per_block": k})
    spec = pt_spec.RunSpec.from_dict(d)
    assert spec.spec_hash() == want
    assert spec.plan()[0] == ("fused" if up == "fused" else "fused_wire")


# ---------------------------------------------------------------------------
# the Session, 2 steps from the same state in both packages
# ---------------------------------------------------------------------------

SESSIONS = [pytest.param(2048, 32, id="block_2048"),
            pytest.param(1023, 16, id="block_1023")]


def _session_dict(block, k):
    return dict(_base(), smoke=True, seq_len=64, carrier="fused_quant8",
                downlink_carrier="fused_quant4",
                compressor_kw={"block": block, "k_per_block": k})


@pytest.mark.parametrize("block,k", SESSIONS)
def test_fused_wire_session_tracks_the_reference(tmp_path, block, k):
    """fused_quant8 up (K3 on rows of the block; single-block leaves
    lane-rounded, which at 2048 puts leaves of 1,025-2,048 values on rows
    wider than 1024) and fused_quant4 down (K5, K4 on the block: an odd
    block's rows end in a pad nibble): loss and g_norm within rtol 1e-4 of
    the reference's over 2 steps from its saved state."""
    d = _session_dict(block, k)
    jsess = jax_session.Session(jax_spec.RunSpec.from_dict(d))
    jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
    ckpt = jsess.save(str(tmp_path / "step_0.npz"))
    want = jsess.train(2, log_every=1)

    psess = pt_session.Session(pt_spec.RunSpec.from_dict(d), device="cpu",
                               dtype="float32")
    psess.restore_from(ckpt)
    assert psess.spec.spec_hash() == jsess.spec.spec_hash()
    got = psess.train(2, log_every=1)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for key in ("loss", "g_norm"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4,
                                   err_msg=key)
    # the wire's accounting, leaf by leaf, up and down
    for leaf, p in psess.params.items():
        n = p.numel()
        for name in ("fused_quant8", "fused_quant4"):
            jc = jax_comp.BlockTopK(ratio=0.05, block=block, k_per_block=k)
            pc = pt_comp.BlockTopK(ratio=0.05, block=block, k_per_block=k)
            j_car, p_car = jax_carriers.make(name), pt_carriers.make(name)
            assert p_car.wire_words(pc, n) == j_car.wire_words(jc, n), leaf
            assert pt_carriers.downlink_words(p_car, pc, n) == \
                jax_carriers.downlink_words(j_car, jc, n), leaf


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block,d", [(2048, 1500), (2048, 3 * 2048 + 5),
                                     (1023, 5 * 1023 - 4), (4096, 9000)])
def test_wide_block_payload_matches_the_reference(bits, block, d):
    """The fused wire's block-dense payload at wide and odd blocks: encode's
    mantissas and scales exactly, the decode and the h-integration (K4's
    plain version; at 4 bits an odd row's pad nibble) as the reference's."""
    rng = np.random.RandomState(block + d + bits)
    delta = rng.randn(d).astype(np.float32)
    base = rng.randn(d).astype(np.float32)
    kw = dict(ratio=0.05, block=block)
    jc, pc = jax_comp.BlockTopK(**kw), pt_comp.BlockTopK(**kw)
    name = f"fused_quant{bits}"
    j_car = jax_carriers.FusedQuantCarrier(name=name, bits=bits)
    p_car = pt_carriers.make(name)
    jq, js = jax.jit(lambda x: j_car.encode(jc, x))(jnp.asarray(delta))
    pq, ps = p_car.encode(pc, torch.tensor(delta))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        p_car.decode(pc, (pq, ps), d=d, dtype=torch.float32).numpy(),
        np.asarray(j_car.decode(jc, (jq, js), d=d, dtype=jnp.float32)))
    j_out = np.asarray(j_car.decode_add(jc, (jq, js), jnp.asarray(base), d=d,
                                        dtype=jnp.float32))
    p_out = p_car.decode_add(pc, (pq, ps), torch.tensor(base), d=d,
                             dtype=torch.float32).numpy()
    atol = 4 * np.spacing(np.float32(np.abs(j_out).max()))
    np.testing.assert_allclose(p_out, j_out, rtol=1e-6, atol=atol)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dry_run_of_a_block_4096_step_counts_its_launches():
    """``Session.lower()`` traces the block-4096 step on the host (the
    wrappers' traced branch takes rows of any width): its launches are the
    step's ``expected_launches``, K3 and K6 a leaf up, K5 and K4 down."""
    cs = _chip_smoke()
    spec = pt_spec.RunSpec.from_dict(dict(
        _session_dict(4096, 64), compressor_kw={"block": 4096,
                                                "k_per_block": 64}))
    sess = pt_session.Session(spec, device="cpu")
    ops.reset_traced()
    got = sess.lower(None)
    want = cs.expected_launches(pt_build.ef_config(spec), sess.params)
    assert got["kernel_launches"] == {k: v for k, v in want.items() if v}
    assert got["kernel_launches"]["ef21_sgdm_topk_quant"] == len(sess.params)
