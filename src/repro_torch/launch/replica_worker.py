"""One serving replica a PROCESS (counterpart of
src/repro/launch/replica_worker.py, the reference's DESIGN.md §12).

``python -m repro_torch.launch.replica_worker --stream ADDR --name r1 --lag 0``
runs a single ``ServeReplica`` on the card (``--device cpu`` runs the
kernels' plain versions on the CPU; a worker started for the card fails
without one, it never carries on elsewhere) that joins the wire stream over
a transport tail (launch/transport.py: a shared directory or
``tcp://host:port``) and then speaks a line protocol with its parent over
stdin/stdout:

  parent → worker (stdin, one JSON object a line):
    {"cmd": "sync",   "id": n, "upto": step?}
    {"cmd": "serve",  "id": n, "requests": [{"rid", "tokens",
                      "max_new_tokens"}], "decode_steps": D,
                      "prompt_len": P?, "sync_during_decode": bool?}
    {"cmd": "digest", "id": n}            # sha256 over the served params
    {"cmd": "stop",   "id": n}

  worker → parent (stdout, lines prefixed ``@@rw `` so stray library prints
  never corrupt the channel):
    {"type": "ready", "name", "step", "pid"}          once, after join
    {"type": "hb", "name", "step", "t"}               heartbeat thread
    {"type": "reply", "id", "ok", ...}                one a command

The serve command runs CONTINUOUS sync: between decode steps the replica
polls the tail and applies fresh records through the train step's tail, so
a long decode never pins the batch to the params it started with; the reply
says how many steps were applied mid-decode. A killed worker rejoins via
checkpoint + replay and lands bit-identical to the trainer —
``params_digest`` is how the parent checks it without shipping a tree.

``WorkerHandle`` is the parent side: spawn, speak the protocol, track
heartbeats, kill, restart. ``launch/fleet.py::ProcessFleet`` drives a set
of handles as one serving fleet.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

MAGIC = "@@rw "


def params_digest(tree) -> str:
    """sha256 over every leaf's dtype, shape and bytes in sorted key order
    (the reference's leaf order) — equal digests ⟺ bit-identical trees.
    The reference's digest of the same values: each leaf as numpy names it
    (``'<f4'``, and ``'<V2'`` for bfloat16, ml_dtypes' name of its 2
    bytes), its shape tuple, its raw bytes. Leaves are tensors (on any
    device) or numpy arrays."""
    import numpy as np
    import torch

    h = hashlib.sha256()
    for key in sorted(tree):
        leaf = tree[key]
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                arr = t.view(torch.int16).numpy()
                dstr = "<V2"
            else:
                arr = t.numpy()
                dstr = arr.dtype.str
        else:
            arr = np.asarray(leaf)
            dstr = arr.dtype.str
        h.update(f"{dstr}{tuple(arr.shape)}".encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

def _emit(obj: Dict[str, Any]) -> None:
    sys.stdout.write(MAGIC + json.dumps(obj) + "\n")
    sys.stdout.flush()


def _heartbeat_loop(rep, interval: float, stop: threading.Event) -> None:
    while not stop.wait(interval):
        _emit({"type": "hb", "name": rep.name, "step": rep.step,
               "t": time.time()})


def _handle(rep, cmd: Dict[str, Any], default_prompt_len: int
            ) -> Dict[str, Any]:
    import numpy as np

    from repro_torch.launch import fleet as fleet_lib

    op = cmd.get("cmd")
    if op == "sync":
        applied = rep.sync(upto=cmd.get("upto"))
        return {"ok": True, "step": rep.step, "applied": applied,
                "head": rep.tail.last_step()}
    if op == "digest":
        return {"ok": True, "step": rep.step,
                "digest": params_digest(rep.params)}
    if op == "serve":
        reqs = [fleet_lib.Request(
                    rid=int(r["rid"]),
                    tokens=np.asarray(r["tokens"], dtype=np.int64),
                    max_new_tokens=int(r.get("max_new_tokens", 16)))
                for r in cmd["requests"]]
        out = rep.serve_batch(
            reqs, int(cmd.get("prompt_len", default_prompt_len)),
            int(cmd["decode_steps"]),
            sync_during_decode=bool(cmd.get("sync_during_decode", True)))
        for req, row in zip(reqs, out["tokens"]):
            fleet_lib.finalize_request(req, row)
        return {"ok": True, "step": rep.step, "head": rep.tail.last_step(),
                "mid_applied": out.get("mid_applied", 0),
                "rids": [r.rid for r in reqs],
                "tokens": [r.tokens_out.tolist() for r in reqs],
                "tokens_generated": [r.tokens_generated for r in reqs]}
    return {"ok": False, "error": f"unknown cmd {op!r}"}


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("repro_torch.launch.replica_worker")
    ap.add_argument("--stream", required=True,
                    help="stream directory or tcp://host:port")
    ap.add_argument("--name", default="w0")
    ap.add_argument("--lag", type=int, default=0)
    ap.add_argument("--bootstrap-step", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--heartbeat", type=float, default=0.25,
                    help="heartbeat interval in seconds (0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    from repro_torch.launch import fleet as fleet_lib

    rep = fleet_lib.ServeReplica(args.stream, name=args.name, lag=args.lag,
                                 bootstrap_step=args.bootstrap_step,
                                 device=args.device)
    _emit({"type": "ready", "name": rep.name, "step": rep.step,
           "pid": os.getpid()})
    stop_hb = threading.Event()
    if args.heartbeat > 0:
        threading.Thread(target=_heartbeat_loop,
                         args=(rep, args.heartbeat, stop_hb),
                         daemon=True).start()
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            cmd = json.loads(line)
            if cmd.get("cmd") == "stop":
                _emit({"type": "reply", "id": cmd.get("id"), "ok": True})
                break
            try:
                reply = _handle(rep, cmd, args.prompt_len)
            except Exception as e:                 # noqa: BLE001 — protocol edge
                reply = {"ok": False, "error": repr(e)}
            _emit({"type": "reply", "id": cmd.get("id"), **reply})
    finally:
        stop_hb.set()


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

class WorkerDied(RuntimeError):
    """The worker process exited (or never came up) — the fleet layer
    restarts it and replays any in-flight batch."""


class WorkerHandle:
    """Parent-side handle on one replica worker process: spawn, speak the
    line protocol, track heartbeats, kill, restart. ``call`` is the blocking
    request/reply path; ``submit``/``take_reply`` the async pair
    ``ProcessFleet.run`` multiplexes over. ``device`` is the worker's
    (cuda when None)."""

    def __init__(self, stream: str, name: str = "w0", lag: int = 0,
                 bootstrap_step: Optional[int] = None, prompt_len: int = 32,
                 heartbeat_s: float = 0.25, start_timeout_s: float = 300.0,
                 spawn: bool = True, device: Optional[str] = None):
        self.stream = str(stream)
        self.name = name
        self.lag = int(lag)
        self.bootstrap_step = bootstrap_step
        self.prompt_len = int(prompt_len)
        self.heartbeat_s = float(heartbeat_s)
        self.start_timeout_s = float(start_timeout_s)
        self.device = device
        self.restarts = 0
        self.proc: Optional[subprocess.Popen] = None
        if spawn:
            self.spawn()

    # ------------------------------------------------------------- lifecycle
    def _argv(self) -> List[str]:
        argv = [sys.executable, "-m", "repro_torch.launch.replica_worker",
                "--stream", self.stream, "--name", self.name,
                "--lag", str(self.lag), "--prompt-len", str(self.prompt_len),
                "--heartbeat", str(self.heartbeat_s)]
        if self.bootstrap_step is not None:
            argv += ["--bootstrap-step", str(self.bootstrap_step)]
        if self.device is not None:
            argv += ["--device", str(self.device)]
        return argv

    def _env(self) -> Dict[str, str]:
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        pp = env.get("PYTHONPATH", "")
        if src not in pp.split(os.pathsep):
            env["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
        return env

    def spawn(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            raise RuntimeError(f"worker {self.name!r} is already running")
        self._ready = threading.Event()
        self._replies: deque = deque()
        self._reply_cv = threading.Condition()
        self._stderr_tail: deque = deque(maxlen=50)
        self.last_hb: float = time.time()
        self.step: Optional[int] = None
        self._next_id = 0
        self.proc = subprocess.Popen(
            self._argv(), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, bufsize=1, env=self._env())
        threading.Thread(target=self._read_stdout, daemon=True).start()
        threading.Thread(target=self._read_stderr, daemon=True).start()

    def _read_stdout(self) -> None:
        proc = self.proc
        for line in proc.stdout:
            if not line.startswith(MAGIC):
                continue                     # a stray library print
            try:
                msg = json.loads(line[len(MAGIC):])
            except json.JSONDecodeError:
                continue
            t = msg.get("type")
            if t == "ready":
                self.step = msg.get("step")
                self.last_hb = time.time()
                self._ready.set()
            elif t == "hb":
                self.last_hb = time.time()
                self.step = msg.get("step", self.step)
            elif t == "reply":
                with self._reply_cv:
                    self._replies.append(msg)
                    self._reply_cv.notify_all()

    def _read_stderr(self) -> None:
        for line in self.proc.stderr:
            self._stderr_tail.append(line.rstrip())

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        timeout = self.start_timeout_s if timeout is None else timeout
        deadline = time.time() + timeout
        while not self._ready.wait(timeout=0.2):
            if not self.alive():
                raise WorkerDied(
                    f"worker {self.name!r} exited during startup "
                    f"(rc={self.proc.returncode}); stderr tail:\n  "
                    + "\n  ".join(self._stderr_tail))
            if time.time() > deadline:
                self.kill()
                raise WorkerDied(
                    f"worker {self.name!r} did not come up within "
                    f"{timeout:.0f}s")

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful stop, falling back to kill."""
        if not self.alive():
            return
        try:
            self.submit({"cmd": "stop"})
            self.proc.wait(timeout=timeout)
        except (OSError, subprocess.TimeoutExpired, WorkerDied):
            self.kill()

    def restart(self) -> None:
        """Kill (if needed) and respawn: the fresh process rejoins the
        stream via checkpoint + replay, bit-identical."""
        self.kill()
        self.restarts += 1
        self.spawn()
        self.wait_ready()

    # --------------------------------------------------------------- protocol
    def submit(self, cmd: Dict[str, Any]) -> int:
        if not self.alive():
            raise WorkerDied(f"worker {self.name!r} is not running")
        self._next_id += 1
        cmd = {**cmd, "id": self._next_id}
        try:
            self.proc.stdin.write(json.dumps(cmd) + "\n")
            self.proc.stdin.flush()
        except (OSError, ValueError) as e:
            raise WorkerDied(f"worker {self.name!r} pipe closed: {e}") from e
        return self._next_id

    def take_reply(self, timeout: float = 0.0) -> Optional[Dict[str, Any]]:
        """Pop one reply if one arrives within ``timeout`` (0 = poll)."""
        with self._reply_cv:
            if not self._replies and timeout > 0:
                self._reply_cv.wait(timeout=timeout)
            return self._replies.popleft() if self._replies else None

    def call(self, cmd: Dict[str, Any], timeout: float = 600.0
             ) -> Dict[str, Any]:
        """Blocking request/reply; raises WorkerDied if the process exits
        first and RuntimeError on an ok=False reply."""
        mid = self.submit(cmd)
        deadline = time.time() + timeout
        while True:
            msg = self.take_reply(timeout=0.2)
            if msg is not None and msg.get("id") == mid:
                if not msg.get("ok"):
                    raise RuntimeError(
                        f"worker {self.name!r} {cmd.get('cmd')!r} failed: "
                        f"{msg.get('error')}")
                return msg
            if msg is None and not self.alive():
                raise WorkerDied(
                    f"worker {self.name!r} died awaiting "
                    f"{cmd.get('cmd')!r} (rc={self.proc.returncode}); "
                    "stderr tail:\n  " + "\n  ".join(self._stderr_tail))
            if time.time() > deadline:
                raise TimeoutError(
                    f"worker {self.name!r} {cmd.get('cmd')!r} timed out "
                    f"after {timeout:.0f}s")

    def hb_age(self) -> float:
        return time.time() - self.last_hb


if __name__ == "__main__":
    main()
