"""The port's stream transports (src/repro_torch/launch/transport.py)
against the reference's tests/test_transport.py, case for case: the
FileTail poller is an exact stand-in for reading the WireLog, the
SocketTail RPC mirrors records and bootstraps byte for byte through the
same local decode path, and a ServeReplica over ``tcp://`` lands
bit-identical to the trainer. Then (g): the port's SocketTail reads from
the reference's TailServer (the protocol is the reference's), and the
reference's SocketTail from the port's; a file larger than one chunk
streams whole."""
import os

import pytest
import torch

from repro.launch import transport as jax_transport
from repro_torch.core import stream as stream_lib
from repro_torch.launch import fleet as fleet_lib
from repro_torch.launch import transport as transport_lib
from repro_torch.launch.session import Session
from repro_torch.launch.spec import RunSpec
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)
from test_torch_schedule import torch_threads

TINY = dict(arch="smollm-360m", smoke=True, clients=2, global_batch=4,
            seq_len=32)
QUANT4 = dict(compressor="block_topk", ratio=0.1,
              downlink_carrier="quant4", downlink_ratio=0.05)


@pytest.fixture(scope="module")
def wire(tmp_path_factory):
    """One quant4 stream shared by the transport tests: 4 published steps,
    bootstraps at 0/2/4, the trainer kept alive so tests can extend the
    stream, and its params after every step."""
    root = tmp_path_factory.mktemp("wire_tp")
    with torch_threads(1):
        sess = Session(RunSpec(**TINY, **QUANT4), device="cpu")
        sess.publish_to(str(root), bootstrap_every=2)
        snaps = {}
        for _ in range(4):
            sess.step_once()
            snaps[sess.step] = {k: v.clone() for k, v in sess.params.items()}
    return {"dir": str(root), "sess": sess, "snaps": snaps}


@pytest.fixture(scope="module")
def server(wire):
    srv = transport_lib.TailServer(wire["dir"]).start()
    yield srv
    srv.stop()


def _records_equal(a, b):
    return len(a) == len(b) and all(stream_lib.records_equal(x, y)
                                    for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# file backend
# ---------------------------------------------------------------------------

def test_file_tail_matches_wirelog(wire):
    log = stream_lib.WireLog(wire["dir"])
    tail = transport_lib.make_tail(wire["dir"])
    assert isinstance(tail, transport_lib.FileTail)
    assert tail.last_step() == log.last_step()
    assert tail.bootstrap_steps() == log.bootstrap_steps()
    assert tail.bootstrap_path(0) == log.bootstrap_path(0)
    assert tail.latest_bootstrap(upto=3) == log.bootstrap_path(2)
    for step in (1, tail.last_step()):
        assert _records_equal(tail.read_step(step), log.read_step(step))


def test_file_tail_head_cache_tracks_new_records(wire):
    """The cached head advances when the trainer publishes: the cache key is
    the newest step's record listing."""
    tail = transport_lib.FileTail(wire["dir"])
    before = tail.last_step()
    assert tail.last_step() == before          # cache hit, same answer
    sess = wire["sess"]
    with torch_threads(1):
        sess.step_once()
    wire["snaps"][sess.step] = {k: v.clone() for k, v in sess.params.items()}
    assert tail.last_step() == before + 1      # cache invalidated by growth


def test_file_tail_empty_dir_is_none(tmp_path):
    tail = transport_lib.FileTail(str(tmp_path))
    assert tail.last_step() is None
    assert tail.latest_bootstrap() is None
    with pytest.raises(stream_lib.StreamError):
        tail.read_step(0)


# ---------------------------------------------------------------------------
# socket RPC backend
# ---------------------------------------------------------------------------

def test_socket_tail_parity_with_file(wire, server, tmp_path):
    log = stream_lib.WireLog(wire["dir"])
    tail = transport_lib.make_tail(server.address,
                                   cache_dir=str(tmp_path / "mirror"))
    assert isinstance(tail, transport_lib.SocketTail)
    assert tail.last_step() == log.last_step()
    assert tail.bootstrap_steps() == log.bootstrap_steps()
    for step in (1, 2):
        assert _records_equal(tail.read_step(step), log.read_step(step))
    bp = tail.bootstrap_path(2)
    assert os.path.exists(bp) and bp != log.bootstrap_path(2)
    with open(bp, "rb") as fa, open(log.bootstrap_path(2), "rb") as fb:
        assert fa.read() == fb.read()
    tail.close()


def test_socket_tail_missing_step_raises_gap(server, tmp_path):
    tail = transport_lib.make_tail(server.address,
                                   cache_dir=str(tmp_path / "mirror"))
    with pytest.raises(stream_lib.StreamGapError):
        tail.read_step(999)
    tail.close()


def test_socket_tail_reconnects_after_drop(wire, server, tmp_path):
    tail = transport_lib.make_tail(server.address,
                                   cache_dir=str(tmp_path / "mirror"))
    head = tail.last_step()
    tail.close_socket()                        # a dropped transport
    assert tail.last_step() == head
    tail.close()


def test_make_tail_passthrough_and_dispatch(wire):
    ft = transport_lib.FileTail(wire["dir"])
    assert transport_lib.make_tail(ft) is ft
    assert isinstance(transport_lib.make_tail(wire["dir"]),
                      transport_lib.FileTail)


def test_replica_over_tcp_bit_identical(wire, server, tmp_path):
    """ServeReplica(tcp://…) lands on exactly the trainer's params, and on
    the file-tail replica's: the mirrored files run the same decode."""
    tail = transport_lib.make_tail(server.address,
                                   cache_dir=str(tmp_path / "mirror"))
    rep = fleet_lib.ServeReplica(tail, bootstrap_step=0, name="tcp0",
                                 device="cpu")
    rep.sync()
    head = stream_lib.WireLog(wire["dir"]).last_step()
    assert rep.step == head
    want = wire["snaps"][head]
    assert all(torch.equal(rep.params[k], want[k]) for k in want)
    local = fleet_lib.ServeReplica(wire["dir"], bootstrap_step=0,
                                   device="cpu")
    local.sync(upto=head)
    assert all(torch.equal(rep.params[k], local.params[k]) for k in want)


# ---------------------------------------------------------------------------
# (g) across the packages, and files larger than a chunk
# ---------------------------------------------------------------------------

def test_port_socket_tail_reads_the_reference_server(wire, tmp_path):
    """The reference's TailServer on the same directory: the port's
    SocketTail mirrors its records and bootstraps, equal to the file's."""
    srv = jax_transport.TailServer(wire["dir"]).start()
    try:
        log = stream_lib.WireLog(wire["dir"])
        tail = transport_lib.make_tail(srv.address,
                                       cache_dir=str(tmp_path / "mirror"))
        assert tail.last_step() == log.last_step()
        assert tail.bootstrap_steps() == log.bootstrap_steps()
        for step in range(1, log.last_step() + 1):
            assert _records_equal(tail.read_step(step), log.read_step(step))
        with open(tail.bootstrap_path(0), "rb") as fa, \
                open(log.bootstrap_path(0), "rb") as fb:
            assert fa.read() == fb.read()
        with pytest.raises(stream_lib.StreamGapError):
            tail.read_step(999)
        tail.close()
    finally:
        srv.stop()


def test_reference_socket_tail_reads_the_port_server(wire, server, tmp_path):
    tail = jax_transport.make_tail(server.address,
                                   cache_dir=str(tmp_path / "mirror"))
    log = stream_lib.WireLog(wire["dir"])
    assert tail.last_step() == log.last_step()
    assert tail.bootstrap_steps() == log.bootstrap_steps()
    mirror = stream_lib.WireLog(str(tmp_path / "mirror"))
    tail.read_step(1)
    assert _records_equal(mirror.read_step(1), log.read_step(1))
    with open(tail.bootstrap_path(2), "rb") as fa, \
            open(log.bootstrap_path(2), "rb") as fb:
        assert fa.read() == fb.read()
    tail.close()


def test_files_stream_in_chunks(wire, monkeypatch, tmp_path):
    """With a chunk far smaller than a bootstrap, the server sends and the
    client writes it piece by piece; the mirror is byte-identical."""
    monkeypatch.setattr(transport_lib, "CHUNK", 4096)
    srv = transport_lib.TailServer(wire["dir"]).start()
    try:
        tail = transport_lib.make_tail(srv.address,
                                       cache_dir=str(tmp_path / "mirror"))
        path = stream_lib.WireLog(wire["dir"]).bootstrap_path(4)
        assert os.path.getsize(path) > 100 * 4096
        with open(tail.bootstrap_path(4), "rb") as fa, open(path, "rb") as fb:
            assert fa.read() == fb.read()
        assert _records_equal(tail.read_step(3), stream_lib.WireLog(
            wire["dir"]).read_step(3))
        tail.close()
    finally:
        srv.stop()
