"""The port's wire stream (src/repro_torch/core/stream.py) against the
reference's tests/test_stream.py, case for case: record round-trip through
the npz log (bfloat16 included), idempotent-vs-conflicting republish,
gap/partial-step/out-of-order/foreign-spec refusal. Then the packages
against each other:
- (a) record files written by either package's WireLog read back equal in
  the other (``records_equal``), bfloat16 included;
- (b) the port's Publisher writes, from the same numpy (server, h_prev),
  the reference's wires exactly (mantissas, scales, indices) on quant8 and
  quant4 (sparse and dense payload), fused_quant4, sparse, and a dense leg;
- (c) ``resolve_legs`` gives the reference's legs (name, index, n_groups,
  leaf positions) and ``legs_wire_words`` its words, on the uniform, the
  all-dense and the mixed_schedule.json plans.
Session-level streaming (publisher verify, bit-identity, resync) is in
tests/test_torch_fleet.py."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stream as jax_stream
from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro.models import model as jax_model
from repro_torch.core import stream as stream_lib
from repro_torch.core.stream import (StreamGapError, StreamIntegrityError,
                                     StreamOrderError, StreamSpecMismatch,
                                     WireLog, WireRecord)
from repro_torch.launch import build as pt_build
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.models import model as pt_model
from repro_torch.optim import optimizer as opt_lib
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
HASH = "deadbeef"


def _rec(step=1, group="*", gi=0, n=1, kind="dense", payload=None,
         spec_hash=HASH):
    if payload is None:
        rng = np.random.RandomState(step * 7 + gi)
        payload = (rng.randn(6).astype(np.float32),
                   (rng.randint(-8, 8, 12).astype(np.int8),
                    rng.randn(3).astype(np.float32)))
    return WireRecord(step=step, spec_hash=spec_hash, group=group,
                      group_index=gi, n_records=n, kind=kind,
                      payload=payload)


# ---------------------------------------------------------------------------
# log round-trip + republish semantics
# ---------------------------------------------------------------------------

def test_record_roundtrip_preserves_bits_and_structure(tmp_path):
    """Bare arrays and tuple-of-component payloads (quant wires carry
    (q, scales[, idx])) come back bit-identical with dtypes intact."""
    log = WireLog(str(tmp_path))
    rec = _rec(kind="delta")
    assert log.append(rec) is True
    got = log.read(1, 0)
    assert stream_lib.records_equal(rec, got)
    assert isinstance(got.payload[0], torch.Tensor)
    assert isinstance(got.payload[1], tuple)
    assert got.payload[1][0].dtype == torch.int8
    assert stream_lib.record_nbytes(got) == stream_lib.record_nbytes(rec)


def test_roundtrip_extension_dtype_bf16(tmp_path):
    """bfloat16 payloads survive the f32 npz detour losslessly and come
    back as torch.bfloat16 (numpy names no bfloat16 without ml_dtypes)."""
    log = WireLog(str(tmp_path))
    arr = torch.randn(16, generator=torch.Generator().manual_seed(0)) \
        .bfloat16()
    log.append(_rec(payload=(arr,)))
    got = log.read(1, 0)
    assert got.payload[0].dtype == torch.bfloat16
    assert torch.equal(got.payload[0].view(torch.int16),
                       arr.view(torch.int16))
    with np.load(log.record_path(1, 0)) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        assert z["l0_c0"].dtype == np.float32
    assert meta["dtypes"] == [["bfloat16"]] and meta["struct"] == [-1]


def test_append_is_idempotent_but_refuses_conflicts(tmp_path):
    """Kill-and-resume republish: a bit-identical re-append is a no-op; a
    record with the same (step, group) but other bits would fork the
    stream and must raise."""
    log = WireLog(str(tmp_path))
    rec = _rec()
    assert log.append(rec) is True
    assert log.append(rec) is False          # republish: no-op
    evil = _rec(payload=(np.zeros(6, np.float32),
                         (np.zeros(12, np.int8), np.zeros(3, np.float32))))
    with pytest.raises(StreamIntegrityError):
        log.append(evil)
    assert stream_lib.records_equal(log.read(1, 0), rec)


def test_missing_record_raises_gap(tmp_path):
    log = WireLog(str(tmp_path))
    log.append(_rec(step=1))
    with pytest.raises(StreamGapError):
        log.read(2, 0)
    with pytest.raises(StreamGapError):
        log.read_step(2)


def test_partial_step_refused_and_hidden_from_last_step(tmp_path):
    """A writer killed between the group files of one step leaves a partial
    record set: read_step refuses it and last_step does not surface it."""
    log = WireLog(str(tmp_path))
    for gi in range(2):
        log.append(_rec(step=1, gi=gi, n=2, group=f"g{gi}"))
    log.append(_rec(step=2, gi=0, n=2, group="g0"))   # g1 never landed
    assert len(log.read_step(1)) == 2
    with pytest.raises(StreamIntegrityError):
        log.read_step(2)
    assert log.last_step() == 1


def test_tmp_partials_are_never_listed(tmp_path):
    log = WireLog(str(tmp_path))
    log.append(_rec(step=1))
    with open(os.path.join(log.records_dir, "xyz.tmp.npz"), "wb") as f:
        f.write(b"garbage")
    assert log.steps() == [1]
    assert log.last_step() == 1


def test_unknown_schema_refused(tmp_path):
    log = WireLog(str(tmp_path))
    log.append(_rec(step=1))
    path = log.record_path(1, 0)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    flat["__meta__"] = np.frombuffer(b'{"stream": "wire/v999"}',
                                     dtype=np.uint8)
    np.savez(path, **flat)
    with pytest.raises(StreamIntegrityError):
        log.read(1, 0)


def test_bootstrap_listing_and_upto(tmp_path):
    log = WireLog(str(tmp_path))
    os.makedirs(log.bootstrap_dir, exist_ok=True)
    for s in (0, 4, 8):
        with open(log.bootstrap_path(s), "wb") as f:
            f.write(b"x")
    assert log.bootstrap_steps() == [0, 4, 8]
    assert log.latest_bootstrap() == log.bootstrap_path(8)
    assert log.latest_bootstrap(upto=5) == log.bootstrap_path(4)
    assert log.latest_bootstrap(upto=-1) is None


# ---------------------------------------------------------------------------
# subscriber state machine (dense transport — no carrier needed)
# ---------------------------------------------------------------------------

def _dense_world():
    params = {"w": torch.arange(4, dtype=torch.float32),
              "b": torch.ones(2, dtype=torch.float32)}
    legs = stream_lib.resolve_legs(params)          # one dense leg, no h
    return params, legs, opt_lib.make("sgd", lr=0.5)


def _dense_rec(step, params, scale=1.0):
    return WireRecord(step=step, spec_hash=HASH, group="*", group_index=0,
                      n_records=1, kind="dense",
                      payload=tuple(params[k] * scale for k in sorted(params)))


def _sub(params, legs, opt, log=None):
    return stream_lib.Subscriber(log or WireLog("/nonexistent"), HASH, legs,
                                 params, opt.init(params), None, 0, opt)


def test_subscriber_applies_dense_record_through_optimizer():
    """A dense record IS g_est: applying it equals one optimizer.update +
    apply_updates at the pre-increment step."""
    params, legs, opt = _dense_world()
    sub = _sub(params, legs, opt)
    rec = _dense_rec(1, params)
    sub.apply([rec])
    assert sub.step == 1
    g_est = dict(zip(sorted(params), rec.payload))
    updates, _ = opt.update(g_est, opt.init(params), params, 0)
    want = opt_lib.apply_updates(params, updates)
    assert sorted(sub.params) == sorted(want)
    assert all(torch.equal(sub.params[k], want[k]) for k in want)


def test_subscriber_refuses_out_of_order():
    params, legs, opt = _dense_world()
    sub = _sub(params, legs, opt)
    with pytest.raises(StreamOrderError):
        sub.apply([_dense_rec(3, params)])       # skipping 1..2 would drift
    sub.apply([_dense_rec(1, params)])
    with pytest.raises(StreamOrderError):
        sub.apply([_dense_rec(1, params)])       # replay of an applied step
    assert sub.step == 1


def test_subscriber_refuses_foreign_spec_hash():
    params, legs, opt = _dense_world()
    sub = _sub(params, legs, opt)
    rec = _dense_rec(1, params)
    with pytest.raises(StreamSpecMismatch):
        sub.apply([WireRecord(**{**rec.__dict__, "spec_hash": "cafebabe"})])


def test_subscriber_refuses_wrong_kind_and_group_set():
    params, legs, opt = _dense_world()
    sub = _sub(params, legs, opt)
    rec = _dense_rec(1, params)
    with pytest.raises(StreamIntegrityError):
        sub.apply([WireRecord(**{**rec.__dict__, "kind": "delta"})])
    with pytest.raises(StreamIntegrityError):
        sub.apply([WireRecord(**{**rec.__dict__, "group_index": 7})])


def test_subscriber_sync_walks_the_log_and_stops_at_gap(tmp_path):
    params, legs, opt = _dense_world()
    log = WireLog(str(tmp_path))
    for s in (1, 2, 4):                          # 3 is the gap
        log.append(_dense_rec(s, params, scale=0.1 * s))
    sub = _sub(params, legs, opt, log)
    assert sub.sync(upto=2) == 2
    assert sub.step == 2
    with pytest.raises(StreamGapError):
        sub.sync()                               # needs 3, only 4 exists
    assert sub.step == 2                         # consistent, not drifted


# ---------------------------------------------------------------------------
# (a) record files across the packages
# ---------------------------------------------------------------------------

def _mixed_payload(seed):
    rng = np.random.RandomState(seed)
    bf = rng.randn(10).astype(np.float32)
    return (rng.randn(6).astype(np.float32),
            (rng.randint(-8, 8, (3, 4)).astype(np.int8),
             rng.randn(3).astype(np.float32),
             rng.randint(0, 100, (3, 2)).astype(np.int16)),
            (rng.randint(0, 255, (2, 5)).astype(np.uint8),
             rng.randn(2).astype(np.float32)), bf)


def _as_jax_record(payload, **hdr):
    """The payload as the reference holds it, its last leaf bfloat16."""
    *head, bf = payload
    return jax_stream.WireRecord(
        payload=tuple(head) + (np.asarray(jnp.asarray(bf, jnp.bfloat16)),),
        **hdr)


def _as_port_record(payload, **hdr):
    *head, bf = payload
    return WireRecord(payload=tuple(head) + (
        torch.from_numpy(bf).bfloat16(),), **hdr)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_record_files_read_equal_across_packages(tmp_path, writer):
    """A record set written by one package's WireLog reads back in the
    other's equal to what was written, bit for bit and dtype for dtype
    (bfloat16 included), and each package's ``records_equal`` holds the
    reader's record to the writer's."""
    hdr = dict(step=3, spec_hash=HASH, group="*", group_index=0,
               n_records=1, kind="delta")
    payload = _mixed_payload(11)
    jrec, prec = _as_jax_record(payload, **hdr), _as_port_record(payload,
                                                                 **hdr)
    if writer == "jax":
        assert jax_stream.WireLog(str(tmp_path)).append(jrec)
        got = WireLog(str(tmp_path)).read(3, 0)
        assert stream_lib.records_equal(got, prec)
        assert got.payload[3].dtype == torch.bfloat16
        assert WireLog(str(tmp_path)).append(prec) is False   # same bits
    else:
        assert WireLog(str(tmp_path)).append(prec)
        got = jax_stream.WireLog(str(tmp_path)).read(3, 0)
        assert jax_stream.records_equal(got, jrec)
        assert got.payload[3].dtype == jnp.bfloat16
        # the port takes the reference's numpy record, bfloat16 by its bits
        assert stream_lib.records_equal(got, prec)
        assert jax_stream.WireLog(str(tmp_path)).append(jrec) is False
    assert stream_lib.record_nbytes(prec) == jax_stream.record_nbytes(jrec)


# ---------------------------------------------------------------------------
# (b) the Publisher's wires across the packages
# ---------------------------------------------------------------------------

SHAPES = {"a": (32, 100), "b": (40,), "c/d": (3, 130), "e_norm": (7,)}
WIRES = [
    pytest.param(dict(compressor="block_topk", ratio=0.1,
                      downlink_carrier="quant8", downlink_ratio=0.05),
                 id="quant8-sparse"),
    pytest.param(dict(compressor="block_topk", ratio=0.1,
                      downlink_carrier="quant4", downlink_ratio=0.05),
                 id="quant4-sparse"),
    pytest.param(dict(compressor="identity", compressor_kw={},
                      downlink_carrier="quant8"), id="quant8-dense-payload"),
    pytest.param(dict(compressor="identity", compressor_kw={},
                      downlink_carrier="quant4"), id="quant4-dense-payload"),
    pytest.param(dict(compressor="block_topk", ratio=0.1,
                      downlink_carrier="fused_quant4", downlink_ratio=0.05),
                 id="fused_quant4"),
    pytest.param(dict(compressor="block_topk", ratio=0.1,
                      downlink_carrier="sparse", downlink_ratio=0.05),
                 id="sparse"),
    pytest.param(dict(compressor="block_topk", ratio=0.1), id="dense-leg"),
]


@pytest.mark.parametrize("fields", WIRES)
def test_publisher_wires_equal_the_reference(tmp_path, fields):
    """The same numpy (server, h_prev) through both packages' Publisher (the
    reference's jitted re-encode, the port's eager one) give record files
    that are equal array for array. Each package verifies against the h
    its own encode integrates to (the two may differ by XLA's FMA in the
    integrate; the wires may not)."""
    rng = np.random.RandomState(5)
    server = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    h_prev = {k: (v - 0.1 * rng.randn(*v.shape)).astype(np.float32)
              for k, v in server.items()}
    jspec, pspec = jax_spec.RunSpec(**fields), pt_spec.RunSpec(**fields)
    assert jspec.spec_hash() == pspec.spec_hash()

    jlegs = jax_stream.resolve_legs(
        server, down_carrier=jspec.downlink_carrier,
        down_compressor=jax_session.make_down_compressor(jspec))
    jpub = jax_stream.Publisher(jax_stream.WireLog(str(tmp_path / "jax")),
                                jspec.spec_hash(), jlegs,
                                jax.random.PRNGKey(0))
    jserver = {k: jnp.asarray(v) for k, v in server.items()}
    jh = {k: jnp.asarray(v) for k, v in h_prev.items()}
    jh_new = None
    if jlegs[0].carrier is not None:
        _, got = jpub._leg_encode(jlegs[0])(
            [jserver[k] for k in sorted(server)],
            [jh[k] for k in sorted(server)], jax.random.PRNGKey(1))
        jh_new = dict(zip(sorted(server), got))
    assert jpub.publish(1, jserver, jh, jh_new) == 1

    pserver = {k: torch.from_numpy(v) for k, v in server.items()}
    ph = {k: torch.from_numpy(v) for k, v in h_prev.items()}
    plegs = stream_lib.resolve_legs(
        pserver, down_carrier=pspec.downlink_carrier,
        down_compressor=pt_build.make_down_compressor(pspec))
    ph_new = None
    if plegs[0].carrier is not None:
        ph_new = stream_lib.encode_leg(plegs[0], pserver, ph)[1]
    ppub = stream_lib.Publisher(WireLog(str(tmp_path / "pt")),
                                pspec.spec_hash(), plegs, pspec.seed)
    assert ppub.publish(1, pserver, ph, ph_new) == 1

    want = WireLog(str(tmp_path / "jax")).read(1, 0)
    got = WireLog(str(tmp_path / "pt")).read(1, 0)
    assert want.kind == got.kind == ("dense" if jh_new is None else "delta")
    assert stream_lib.records_equal(got, want)
    if jh_new is not None:
        comps = [c for leaf in got.payload for c in
                 (leaf if isinstance(leaf, tuple) else (leaf,))]
        assert any(not c.is_floating_point() for c in comps)  # indices or q


# ---------------------------------------------------------------------------
# (c) the transport legs across the packages
# ---------------------------------------------------------------------------

def _shipped(name, **overrides):
    with open(os.path.join(ROOT, "results", "specs", f"{name}.json")) as f:
        return dict(json.load(f), **overrides)


@pytest.mark.parametrize("fields", [
    pytest.param(dict(smoke=True, compressor="block_topk", ratio=0.1,
                      downlink_carrier="quant4", downlink_ratio=0.05),
                 id="uniform-quant4"),
    pytest.param(dict(smoke=True), id="all-dense"),
    pytest.param(_shipped("mixed_schedule"), id="mixed_schedule"),
])
def test_resolve_legs_and_words_equal_the_reference(fields):
    fields = dict({"version": pt_spec.SCHEMA_VERSION}, **fields)
    jspec = jax_spec.RunSpec.from_dict(fields)
    pspec = pt_spec.RunSpec.from_dict(fields)
    jcfg = jax_session.Session(jspec).cfg
    jlike = jax.eval_shape(lambda: jax_model.init_params(
        jcfg, jax.random.PRNGKey(0)))
    plike = pt_model.init_params(pt_session.Session(pspec, device="cpu").cfg,
                                 None, "meta")
    jlegs = jax_stream.resolve_legs(
        jlike, schedule=jax_session.make_schedule(jspec),
        down_carrier=jspec.downlink_carrier,
        down_compressor=jax_session.make_down_compressor(jspec))
    plegs = stream_lib.resolve_legs(
        plike, schedule=pt_build.make_schedule(pspec),
        down_carrier=pspec.downlink_carrier,
        down_compressor=pt_build.make_down_compressor(pspec))
    assert [(lg.name, lg.index, lg.n_groups, lg.leaf_ii) for lg in plegs] == \
        [(lg.name, lg.index, lg.n_groups, lg.leaf_ii) for lg in jlegs]
    assert [lg.carrier is None for lg in plegs] == \
        [lg.carrier is None for lg in jlegs]
    assert [getattr(lg.carrier, "name", None) for lg in plegs] == \
        [getattr(lg.carrier, "name", None) for lg in jlegs]
    assert stream_lib.legs_wire_words(plegs, plike) == \
        jax_stream.legs_wire_words(jlegs, jlike)
