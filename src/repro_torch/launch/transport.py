"""Stream transports — how a replica TAILS the wire log across process and
host boundaries (counterpart of src/repro/launch/transport.py, the
reference's DESIGN.md §12).

  * ``StreamTail`` — the read-only transport a subscriber needs:
    ``last_step`` / ``read_step`` (the surface ``core/stream.py::Subscriber``
    consumes) plus the bootstrap listing and a LOCAL path to any bootstrap
    checkpoint (``bootstrap_path``: a remote backend downloads into a cache,
    so ``checkpoint.restore`` never learns about sockets).
  * ``FileTail`` — the shared-filesystem backend: a poller over a
    ``WireLog`` that caches the verified head keyed on the newest step's
    record listing, so a replica polling between decode steps pays one
    ``listdir`` a poll.
  * ``SocketTail`` / ``TailServer`` — the RPC backend: one JSON line a
    request; a JSON header line a reply, then, for file operations, each
    file's bytes behind an 8-byte big-endian length. The server ships
    record and bootstrap FILES verbatim; the client mirrors them into a
    local cache directory and parses them through its own ``WireLog``, so
    both backends run one decode path and every integrity rule. The
    protocol is the reference's, so either package's ``SocketTail`` reads
    from either package's ``TailServer``. Files are streamed in chunks on
    both sides: a full-width bootstrap is tens of GB, never held in memory.

``make_tail`` picks the backend from the address: ``tcp://host:port`` → RPC,
anything else → a stream directory.

    python -m repro_torch.launch.transport DIR --port P

serves a stream directory to remote tails.
"""
from __future__ import annotations

import abc
import json
import os
import re
import socket
import socketserver
import struct
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import stream as stream_lib

CHUNK = 16 << 20               # bytes a read or write of a streamed file


# ---------------------------------------------------------------------------
# the interface
# ---------------------------------------------------------------------------

class StreamTail(abc.ABC):
    """Read side of one wire stream. The record methods mirror ``WireLog``
    (a ``Subscriber`` takes either); the bootstrap methods resolve to LOCAL
    paths so a checkpoint restore stays transport-agnostic."""

    @abc.abstractmethod
    def last_step(self) -> Optional[int]:
        """Newest step whose record set is complete (None = no records)."""

    @abc.abstractmethod
    def read_step(self, step: int) -> List[stream_lib.WireRecord]:
        """Every group record of one step (StreamGapError when absent)."""

    @abc.abstractmethod
    def bootstrap_steps(self) -> List[int]:
        """Steps with a bootstrap checkpoint, sorted ascending."""

    @abc.abstractmethod
    def bootstrap_path(self, step: int) -> str:
        """LOCAL path of the bootstrap for ``step`` (a remote backend
        fetches it into its cache first)."""

    def latest_bootstrap(self, upto: Optional[int] = None) -> Optional[str]:
        steps = [s for s in self.bootstrap_steps()
                 if upto is None or s <= upto]
        return self.bootstrap_path(steps[-1]) if steps else None

    def close(self) -> None:
        """Release transport resources (cache directories stay)."""


# ---------------------------------------------------------------------------
# file backend — the shared-filesystem poller
# ---------------------------------------------------------------------------

class FileTail(StreamTail):
    """Poll a ``WireLog`` directory. ``last_step`` caches the verified head
    keyed on the newest step's record listing: an unchanged directory costs
    one ``listdir``, never a re-load of record files."""

    def __init__(self, root: str):
        self.log = stream_lib.WireLog(root)
        self._key: Optional[Tuple[int, Tuple[int, ...]]] = None
        self._head: Optional[int] = None

    def last_step(self) -> Optional[int]:
        listing = self.log.listing()
        if not listing:
            self._key = self._head = None
            return None
        newest = max(listing)
        key = (newest, tuple(sorted(listing[newest])))
        if key != self._key:
            self._head = self.log.last_step()
            self._key = key
        return self._head

    def read_step(self, step: int) -> List[stream_lib.WireRecord]:
        return self.log.read_step(step)

    def bootstrap_steps(self) -> List[int]:
        return self.log.bootstrap_steps()

    def bootstrap_path(self, step: int) -> str:
        return self.log.bootstrap_path(step)


# ---------------------------------------------------------------------------
# socket RPC backend
# ---------------------------------------------------------------------------

def _recv_line(sock: socket.socket, buf: bytearray) -> bytes:
    while b"\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise stream_lib.StreamError("transport connection closed "
                                         "mid-line")
        buf.extend(chunk)
    line, _, rest = bytes(buf).partition(b"\n")
    buf[:] = rest
    return line


class _TailHandler(socketserver.StreamRequestHandler):
    def handle(self):
        tail: FileTail = self.server.tail            # type: ignore[attr-defined]
        log = tail.log
        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            try:
                req = json.loads(raw.decode())
                op = req.get("op")
                if op == "head":
                    self._reply({"ok": True, "head": tail.last_step()})
                elif op == "bootstraps":
                    self._reply({"ok": True, "steps": tail.bootstrap_steps()})
                elif op == "step_files":
                    step = int(req["step"])
                    present = sorted(log.listing().get(step, []))
                    self._reply_files([log.record_path(step, gi)
                                       for gi in present])
                elif op == "bootstrap_file":
                    path = log.bootstrap_path(int(req["step"]))
                    if not os.path.exists(path):
                        self._reply({"ok": False,
                                     "error": f"no bootstrap {path}"})
                    else:
                        self._reply_files([path])
                else:
                    self._reply({"ok": False, "error": f"unknown op {op!r}"})
            except BrokenPipeError:
                return
            except Exception as e:                   # noqa: BLE001 — RPC edge
                try:
                    self._reply({"ok": False, "error": repr(e)})
                except OSError:
                    return

    def _reply(self, header: Dict[str, Any]) -> None:
        self.wfile.write(json.dumps(header).encode() + b"\n")
        self.wfile.flush()

    def _reply_files(self, paths: List[str]) -> None:
        """The header with each file's name and size, then each file's
        bytes behind its length, streamed in chunks (records and bootstraps
        are immutable once renamed into place)."""
        files = [open(p, "rb") for p in paths]
        try:
            sizes = [os.fstat(f.fileno()).st_size for f in files]
            self._reply({"ok": True, "files": [
                {"name": os.path.basename(p), "size": n}
                for p, n in zip(paths, sizes)]})
            for f, n in zip(files, sizes):
                self.wfile.write(struct.pack(">Q", n))
                while n:
                    data = f.read(min(CHUNK, n))
                    if not data:
                        raise OSError(f"{f.name} shrank while being sent")
                    self.wfile.write(data)
                    n -= len(data)
            self.wfile.flush()
        finally:
            for f in files:
                f.close()


class TailServer:
    """Expose one stream directory to ``SocketTail`` clients. Threaded —
    each replica keeps a persistent connection."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _TailHandler, bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.tail = FileTail(root)              # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"tcp://{host}:{port}"

    def start(self) -> "TailServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class SocketTail(StreamTail):
    """Tail a remote stream over the TailServer RPC, mirroring fetched
    record and bootstrap files into ``cache_dir`` and parsing them through a
    local ``WireLog`` — one decode path, both transports."""

    def __init__(self, host: str, port: int,
                 cache_dir: Optional[str] = None):
        self.addr = (host, int(port))
        self.cache_dir = cache_dir or tempfile.mkdtemp(prefix="wire_tail_")
        self.mirror = stream_lib.WireLog(self.cache_dir)
        self._sock: Optional[socket.socket] = None
        self._buf = bytearray()
        self._complete: set = set()
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, timeout=30)
            self._buf.clear()
        return self._sock

    def _call(self, op: str, subdir: Optional[str] = None, **kw
              ) -> Tuple[Dict[str, Any], List[str]]:
        """One request; a reply's files land in ``subdir`` of the cache.
        Returns (header, local paths of the files)."""
        with self._lock:
            try:
                return self._call_once(op, subdir, **kw)
            except (OSError, stream_lib.StreamError) as e:
                if isinstance(e, stream_lib.StreamIntegrityError):
                    raise
                # one reconnect: the server may have restarted between polls
                self.close_socket()
                return self._call_once(op, subdir, **kw)

    def _call_once(self, op: str, subdir: Optional[str], **kw
                   ) -> Tuple[Dict[str, Any], List[str]]:
        sock = self._connect()
        sock.sendall(json.dumps({"op": op, **kw}).encode() + b"\n")
        header = json.loads(_recv_line(sock, self._buf).decode())
        if not header.get("ok"):
            raise stream_lib.StreamError(
                f"tail rpc {op!r} failed: {header.get('error')}")
        paths = []
        for meta in header.get("files", []):
            # the length prefix and the size in the header must agree — a
            # mismatch means a corrupt frame, never a silent resync
            n = struct.unpack(">Q", self._pull_bytes(8))[0]
            if n != meta["size"]:
                raise stream_lib.StreamIntegrityError(
                    f"tail rpc frame size {n} != header size {meta['size']}")
            paths.append(self._mirror_file(subdir, meta["name"], n))
        return header, paths

    def _pull_bytes(self, n: int) -> bytes:
        out = bytearray()
        for piece in self._pull(n):
            out.extend(piece)
        return bytes(out)

    def _pull(self, n: int):
        """The next ``n`` bytes of the connection, in pieces: the line
        buffer's leftover first, then the socket."""
        if self._buf:
            take = bytes(self._buf[:n])
            del self._buf[:len(take)]
            n -= len(take)
            yield take
        while n:
            chunk = self._sock.recv(min(CHUNK, n))
            if not chunk:
                raise stream_lib.StreamError("transport connection closed "
                                             "mid-frame")
            n -= len(chunk)
            yield chunk

    def _mirror_file(self, subdir: str, name: str, n: int) -> str:
        """Stream ``n`` bytes of the connection into the cache as ``name``
        (a temporary file renamed into place; an existing mirror is kept,
        the bytes read and dropped)."""
        d = os.path.join(self.cache_dir, subdir)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        try:
            with os.fdopen(fd, "wb") as f:
                for piece in self._pull(n):
                    f.write(piece)
            if os.path.exists(path):
                os.unlink(tmp)
            else:
                os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    def last_step(self) -> Optional[int]:
        return self._call("head")[0]["head"]

    def read_step(self, step: int) -> List[stream_lib.WireRecord]:
        if step not in self._complete:
            self._call("step_files", subdir="records", step=step)
        recs = self.mirror.read_step(step)     # gap/partial raise here
        self._complete.add(step)
        return recs

    def bootstrap_steps(self) -> List[int]:
        return list(self._call("bootstraps")[0]["steps"])

    def bootstrap_path(self, step: int) -> str:
        path = self.mirror.bootstrap_path(step)
        if not os.path.exists(path):
            path = self._call("bootstrap_file", subdir="bootstrap",
                              step=step)[1][0]
        return path

    def close_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._buf.clear()

    def close(self) -> None:
        self.close_socket()


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

_TCP_RE = re.compile(r"^tcp://([^:/]+):(\d+)$")


def make_tail(stream, cache_dir: Optional[str] = None) -> StreamTail:
    """Resolve a stream address to a tail: a ``StreamTail`` passes through,
    ``tcp://host:port`` opens the RPC backend, anything else is a stream
    directory on a (shared) filesystem."""
    if isinstance(stream, StreamTail):
        return stream
    m = _TCP_RE.match(str(stream))
    if m:
        return SocketTail(m.group(1), int(m.group(2)), cache_dir=cache_dir)
    return FileTail(str(stream))


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        "repro_torch.launch.transport",
        description="Serve a wire-stream directory to remote SocketTails")
    ap.add_argument("root", help="stream directory (WireLog root)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    srv = TailServer(args.root, host=args.host, port=args.port)
    print(f"serving {args.root} at {srv.address}", flush=True)
    srv.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
