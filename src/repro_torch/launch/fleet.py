"""Serving fleet fed by the downlink wire (counterpart of
src/repro/launch/fleet.py, the reference's DESIGN.md §12).

A ``ServeReplica`` is a serving ``Session`` whose parameters are kept
bit-identical to the trainer's by SUBSCRIBING to the wire stream a training
session publishes (``Session.publish_to`` → core/stream.py): it joins from
the stream's bootstrap checkpoint, replays every record (checkpoint +
replay), and between request batches applies new records through the train
step's tail — never a dense f32 weight push. A ``Fleet`` runs several
replicas against ONE stream at different lags behind the trainer's head,
dispatching a request queue through a decode-budget scheduler:

    sess = Session(spec); sess.publish_to("/tmp/wire"); sess.train(100)
    fleet = Fleet("/tmp/wire", n_replicas=2, lags=(0, 4))
    results = fleet.run(synthetic_requests(32, rate=8.0))

Replicas run on cuda unless ``device`` says otherwise (``device="cpu"``
runs the kernels' plain versions).

Scheduling: requests are admitted FIFO into one serving batch while
``B × decode_steps ≤ decode_budget``, the decode steps bucketed to powers of
two. The port compiles nothing per geometry, but the buckets decide which
requests share a batch, and they are the reference's.

Staleness: a replica at lag L serves the trainer's step-(head−L) model —
exact, never drifted (a gap resyncs via a later bootstrap, or fails
loudly). This is SERVING staleness, distinct from the async TRAINING
staleness of the reference's DESIGN.md §11.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core import stream as stream_lib
from repro_torch.launch import build as build_lib
from repro_torch.launch import session as session_lib
from repro_torch.launch import transport as transport_lib
from repro_torch.launch.spec import RunSpec
from repro_torch.models import model as model_lib
from repro_torch.optim import optimizer as opt_lib

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# requests + decode-budget scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One serving request. ``arrival_s`` is relative to the run's t0; the
    completion fields are filled by ``Fleet.run``."""

    rid: int
    tokens: np.ndarray                  # 1-D prompt token ids
    max_new_tokens: int = 16
    arrival_s: float = 0.0
    # filled on completion
    t_done: float = 0.0
    latency_s: float = 0.0
    replica: str = ""
    staleness: int = 0
    tokens_out: Optional[np.ndarray] = None
    tokens_generated: int = 0           # may be < max_new_tokens (capped)


def finalize_request(req: Request, row) -> None:
    """Fill a request's generated tokens from one served row: at most
    ``max_new_tokens`` tokens, and ``tokens_generated`` records how many the
    decode budget allowed — an oversized lone request admitted with capped
    decode completes SHORT, and says so."""
    avail = np.asarray(row)
    take = min(req.max_new_tokens, int(avail.size))
    req.tokens_out = avail[:take]
    req.tokens_generated = take


def _bucket(n: int) -> int:
    """Next power of two ≥ n."""
    return 1 << max(0, int(n - 1).bit_length())


@dataclasses.dataclass
class DecodeBudgetScheduler:
    """FIFO batcher under a decode budget: admit the longest queue prefix
    whose batched decode cost ``B × D`` stays within ``decode_budget``,
    where D is the power-of-two bucket of the batch's largest
    ``max_new_tokens``. An oversized lone request is still admitted alone
    with its decode capped at the budget (starving it would turn a budget
    into a deadlock)."""

    decode_budget: int = 64
    max_batch: int = 4

    def admit(self, queue: Deque[Request]) -> Tuple[List[Request], int]:
        """Pop and return ``(batch, decode_steps)``; empty queue → ([], 0)."""
        if not queue:
            return [], 0
        batch: List[Request] = []
        d = 1
        for req in list(queue):
            cand_d = max(d, _bucket(max(req.max_new_tokens, 1)))
            if batch and (len(batch) + 1 > self.max_batch
                          or (len(batch) + 1) * cand_d > self.decode_budget):
                break
            batch.append(req)
            d = cand_d
            if len(batch) * d >= self.decode_budget:
                break
        for _ in batch:
            queue.popleft()
        return batch, min(d, max(self.decode_budget, 1))


def synthetic_requests(n: int, rate: float = 0.0, prompt_len: int = 32,
                       max_new_tokens: int = 8, vocab_size: int = 256,
                       seed: int = 0) -> List[Request]:
    """A deterministic load (the reference's numpy draws): ``n`` requests
    with exponential inter-arrivals at ``rate`` req/s (rate ≤ 0 →
    everything arrives at t=0)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab_size, size=(n, prompt_len), dtype=np.int64)
    if rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    else:
        arrivals = np.zeros(n)
    return [Request(rid=i, tokens=toks[i], arrival_s=float(arrivals[i]),
                    max_new_tokens=max_new_tokens) for i in range(n)]


# ---------------------------------------------------------------------------
# one replica
# ---------------------------------------------------------------------------

class ServeReplica:
    """subscribe → apply → serve → resync (DESIGN.md §12). Joins from the
    stream's bootstrap checkpoint (never loading the clients' EF state — a
    replica restores only params, opt_state and h, into meta-device
    templates), replays the record log, and serves through
    ``Session.serve`` with the subscriber's params injected as the serving
    tree. On a gap it resyncs from the newest bootstrap past the gap and
    replays; with no such bootstrap it raises — the replica keeps serving
    its last CONSISTENT model (stale is honest, drift is not)."""

    def __init__(self, stream, name: str = "r0", lag: int = 0,
                 bootstrap_step: Optional[int] = None,
                 device: Optional[str] = None):
        self.tail = transport_lib.make_tail(stream)
        self.name = name
        self.lag = int(lag)
        if bootstrap_step is not None:
            path = self.tail.bootstrap_path(bootstrap_step)
        else:
            # a lagged replica joins at a bootstrap at or below its target
            # (head − lag) when one exists, so it starts BEHIND and stays
            # there; else at the newest bootstrap
            head = self.tail.last_step()
            path = None
            if self.lag > 0 and head is not None:
                path = self.tail.latest_bootstrap(
                    upto=max(head - self.lag, 0))
            if path is None:
                path = self.tail.latest_bootstrap()
        if path is None:
            raise stream_lib.StreamError(
                f"stream {stream!r} has no bootstrap checkpoint — a "
                "replica cannot join (params never travel on the wire); "
                "attach the trainer with Session.publish_to first")
        meta = ckpt_lib.read_meta(path)
        if "spec" not in meta:
            raise stream_lib.StreamError(
                f"bootstrap {path} has no embedded RunSpec")
        self.spec = RunSpec.from_dict(meta["spec"])
        self.spec_hash = self.spec.spec_hash()
        self.session = session_lib.Session(self.spec, device=device)
        self.optimizer = opt_lib.make(self.spec.optimizer, lr=self.spec.lr)
        self._likes, self.legs = self._like_trees()
        self.sub = self._load_bootstrap(path)
        self.session.set_serve_params(self.sub.params)

    @property
    def log(self):
        """The read side of the stream (a StreamTail)."""
        return self.tail

    @property
    def device(self) -> torch.device:
        return self.session.device

    def _like_trees(self) -> Tuple[Dict[str, Any], List[stream_lib.Leg]]:
        """Templates on the meta device (shapes and dtypes, no memory, no
        init): only params, opt_state and the broadcast memory h leave the
        checkpoint, never the clients' EF state. The transport legs are
        resolved once against the same template (they decide whether the
        stream carries an h at all)."""
        params_like = model_lib.init_params(self.session.cfg, None, "meta")
        legs = stream_lib.resolve_legs(
            params_like, schedule=build_lib.make_schedule(self.spec),
            down_carrier=self.spec.downlink_carrier,
            down_compressor=build_lib.make_down_compressor(self.spec))
        likes = {"params": params_like,
                 "opt_state": self.optimizer.init(params_like)}
        if any(leg.carrier is not None for leg in legs):
            likes["ef_state"] = {"h": params_like}
        return likes, legs

    def _load_bootstrap(self, path: str) -> stream_lib.Subscriber:
        meta = ckpt_lib.read_meta(path)
        stored = meta.get("spec_hash")
        if stored is not None and stored != self.spec_hash:
            raise stream_lib.StreamSpecMismatch(
                f"bootstrap {path} was written by a different RunSpec "
                f"(hash {stored} != {self.spec_hash}); refusing to join a "
                "foreign stream")
        state, meta = ckpt_lib.restore(path, self._likes, self.device)
        return stream_lib.Subscriber(
            self.tail, self.spec_hash, self.legs, state["params"],
            state["opt_state"], state.get("ef_state", {}).get("h"),
            int(meta["step"]), self.optimizer)

    # ------------------------------------------------------------------ sync
    @property
    def step(self) -> int:
        return self.sub.step

    @property
    def params(self) -> Tree:
        return self.sub.params

    def _target(self, upto: Optional[int]) -> Optional[int]:
        last = self.tail.last_step()
        if last is None:
            return None
        target = max(0, last - self.lag)
        return target if upto is None else min(target, int(upto))

    def sync(self, upto: Optional[int] = None) -> int:
        """Apply every record up to (head − lag); on a gap, resync via
        checkpoint + replay. Returns the steps advanced."""
        target = self._target(upto)
        if target is None or target <= self.step:
            return 0
        start = self.step
        try:
            if self.sub.sync(upto=target):
                self.session.set_serve_params(self.sub.params)
        except stream_lib.StreamGapError:
            self.resync(target)
        return self.step - start

    def resync(self, target: int) -> int:
        """Gap recovery: reload the newest bootstrap PAST the replica's
        current step and replay forward — the replica re-enters the stream
        bit-identical, never having applied records out of order. Raises
        ``StreamGapError`` when no bootstrap bridges the gap (the replica
        keeps its last consistent, honestly stale model)."""
        before = self.step
        for b in sorted(self.tail.bootstrap_steps(), reverse=True):
            if b <= self.step or b > target:
                continue
            sub = self._load_bootstrap(self.tail.bootstrap_path(b))
            try:
                sub.sync(upto=target)
            except stream_lib.StreamGapError:
                continue
            self.sub = sub
            self.session.set_serve_params(self.sub.params)
            return self.step - before
        raise stream_lib.StreamGapError(
            f"replica {self.name!r} is at step {before} with a gap before "
            f"step {target} and no bootstrap bridges it; refusing to skip "
            "records (serving stays on the last consistent model)")

    def staleness(self) -> int:
        """Head − replica step; 0 for an empty log (nothing to be stale
        against)."""
        last = self.tail.last_step()
        if last is None:
            return 0
        return max(int(last) - self.step, 0)

    # ----------------------------------------------------------------- serve
    def serve_batch(self, requests: Sequence[Request], prompt_len: int,
                    decode_steps: int,
                    sync_during_decode: bool = False) -> Dict[str, Any]:
        """One batched prefill + decode over ``requests`` at the replica's
        current params. Prompts are right-padded or truncated to the fleet's
        ``prompt_len``; the TRUE prompt lengths travel with the batch, so
        the first generated token is read at each row's last real position.
        With ``sync_during_decode`` the replica polls the tail between
        decode steps and applies any fresh records (the remaining decode
        runs on the new params); the result carries ``mid_applied``, the
        steps applied mid-decode."""
        if not requests:
            raise ValueError("serve_batch needs at least one request")
        vocab = self.session.cfg.vocab_size
        toks = np.zeros((len(requests), prompt_len), dtype=np.int64)
        lens = np.zeros((len(requests),), dtype=np.int64)
        for j, req in enumerate(requests):
            row = np.asarray(req.tokens)[:prompt_len] % vocab
            toks[j, :row.size] = row
            lens[j] = max(int(row.size), 1)
        applied = {"n": 0}
        hook = None
        if sync_during_decode:
            def hook(i):
                applied["n"] += self.sync()
        out = self.session.serve(tokens=torch.from_numpy(toks),
                                 prompt_lens=torch.from_numpy(lens),
                                 decode_steps=decode_steps, decode_hook=hook)
        out["mid_applied"] = applied["n"]
        return out


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

class Fleet:
    """N replicas subscribed to ONE wire stream at per-replica lags, served
    round-robin under a shared decode-budget scheduler."""

    def __init__(self, stream, n_replicas: int = 2,
                 lags: Optional[Sequence[int]] = None,
                 decode_budget: int = 64, max_batch: int = 4,
                 prompt_len: int = 32,
                 bootstrap_step: Optional[int] = None,
                 device: Optional[str] = None):
        lags = list(lags) if lags is not None else [0] * n_replicas
        if len(lags) != n_replicas:
            raise ValueError(f"{n_replicas} replicas but {len(lags)} lags")
        self.replicas = [
            ServeReplica(stream, name=f"r{i}", lag=lags[i],
                         bootstrap_step=bootstrap_step, device=device)
            for i in range(n_replicas)]
        self.scheduler = DecodeBudgetScheduler(decode_budget=decode_budget,
                                               max_batch=max_batch)
        self.prompt_len = int(prompt_len)

    def sync(self) -> List[int]:
        return [rep.sync() for rep in self.replicas]

    def run(self, requests: Sequence[Request], sync_every: int = 1,
            sync_during_decode: bool = False) -> Dict[str, Any]:
        """Drive the request load through the fleet: arrivals against the
        wall clock; each replica syncs (applies fresh wire records) every
        ``sync_every`` batches IT serves, counted per replica, so every
        replica syncs before its first batch and none is starved of syncs
        by the round-robin phase. Each completed request records its
        latency, the staleness (head − replica step) it was served at, and
        ``tokens_generated``; a request whose decode the budget capped
        shows in ``short_requests`` / ``tokens_short``.
        ``sync_during_decode`` also applies fresh records BETWEEN decode
        steps. Returns the completed requests plus a QPS/p50/p99 summary."""
        todo = collections.deque(sorted(requests, key=lambda r: r.arrival_s))
        pending: Deque[Request] = collections.deque()
        done: List[Request] = []
        t0 = time.time()
        batches = ri = 0
        served = [0] * len(self.replicas)   # per-replica batch counts
        while todo or pending:
            now = time.time() - t0
            while todo and todo[0].arrival_s <= now:
                pending.append(todo.popleft())
            if not pending:
                time.sleep(min(0.002, max(todo[0].arrival_s - now, 1e-4)))
                continue
            idx = ri % len(self.replicas)
            rep = self.replicas[idx]
            ri += 1
            if sync_every and served[idx] % sync_every == 0:
                rep.sync()
            batch, decode_steps = self.scheduler.admit(pending)
            out = rep.serve_batch(batch, self.prompt_len, decode_steps,
                                  sync_during_decode=sync_during_decode)
            t_done = time.time() - t0
            staleness = rep.staleness()
            for req, row in zip(batch, out["tokens"]):
                req.t_done = t_done
                req.latency_s = t_done - req.arrival_s
                finalize_request(req, row)
                req.replica = rep.name
                req.staleness = staleness
                done.append(req)
            batches += 1
            served[idx] += 1
        return _summary(done, batches)


def _summary(done: List[Request], batches: int, **extra) -> Dict[str, Any]:
    """The run summary both fleets return: QPS/p50/p99, staleness, and the
    decode-budget shortfall."""
    lat = np.array(sorted(r.latency_s for r in done)) if done \
        else np.zeros(1)
    wall = max((r.t_done for r in done), default=0.0)
    stal = np.array([r.staleness for r in done]) if done else np.zeros(1)
    short = [r for r in done if r.tokens_generated < r.max_new_tokens]
    return {
        "requests": done,
        "batches": batches,
        "qps": len(done) / max(wall, 1e-9),
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "staleness_mean": float(stal.mean()),
        "staleness_max": int(stal.max()),
        "short_requests": len(short),
        "tokens_short": int(sum(r.max_new_tokens - r.tokens_generated
                                for r in short)),
        **extra,
    }


# ---------------------------------------------------------------------------
# the multi-process fleet
# ---------------------------------------------------------------------------

class ProcessFleet:
    """N replica WORKER PROCESSES on one wire stream: each worker is a
    ``python -m repro_torch.launch.replica_worker`` subprocess running its
    own ``ServeReplica`` over a transport tail on ``device`` (cuda unless
    told), reporting heartbeats to this parent. The parent admits request
    batches under the shared decode-budget scheduler and dispatches them to
    idle workers, so batches overlap across processes. Workers serve with
    CONTINUOUS sync (records applied between decode steps); a crashed
    worker is restarted and rejoins via checkpoint + replay (bit-identical),
    and its in-flight batch goes back to the head of the queue, so a crash
    costs latency, never a lost or drifted request."""

    def __init__(self, stream, n_workers: int = 2,
                 lags: Optional[Sequence[int]] = None,
                 decode_budget: int = 64, max_batch: int = 4,
                 prompt_len: int = 32,
                 bootstrap_step: Optional[int] = None,
                 heartbeat_s: float = 0.25, hb_timeout_s: float = 120.0,
                 start_timeout_s: float = 300.0,
                 device: Optional[str] = None):
        from repro_torch.launch import replica_worker as worker_lib

        lags = list(lags) if lags is not None else [0] * n_workers
        if len(lags) != n_workers:
            raise ValueError(f"{n_workers} workers but {len(lags)} lags")
        self.workers = [
            worker_lib.WorkerHandle(
                str(stream), name=f"w{i}", lag=lags[i],
                bootstrap_step=bootstrap_step, prompt_len=prompt_len,
                heartbeat_s=heartbeat_s, start_timeout_s=start_timeout_s,
                device=device)
            for i in range(n_workers)]
        self.scheduler = DecodeBudgetScheduler(decode_budget=decode_budget,
                                               max_batch=max_batch)
        self.prompt_len = int(prompt_len)
        self.hb_timeout_s = float(hb_timeout_s)
        try:
            for w in self.workers:
                w.wait_ready()
        except BaseException:
            self.stop()
            raise

    def __enter__(self) -> "ProcessFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self) -> None:
        for w in self.workers:
            w.stop()

    def sync(self) -> List[int]:
        return [w.call({"cmd": "sync"})["applied"] for w in self.workers]

    def digests(self) -> List[str]:
        return [w.call({"cmd": "digest"})["digest"] for w in self.workers]

    def _restart(self, w, inflight: Dict[Any, Any],
                 pending: Deque[Request]) -> None:
        """Restart a dead or hung worker; its in-flight batch (if any) goes
        back to the FRONT of the queue so those requests are served next."""
        entry = inflight.pop(w, None)
        if entry is not None:
            for req in reversed(entry["batch"]):
                pending.appendleft(req)
        w.restart()

    def run(self, requests: Sequence[Request],
            sync_during_decode: bool = True) -> Dict[str, Any]:
        """Drive the load: arrivals against the wall clock, batches admitted
        under the decode budget and dispatched to IDLE workers, results
        collected as they complete. Workers sync continuously during
        decode; staleness is what the worker reports at batch completion.
        The summary is ``Fleet.run``'s plus ``restarts`` and
        ``mid_applied``."""
        from repro_torch.launch import replica_worker as worker_lib

        todo = collections.deque(sorted(requests, key=lambda r: r.arrival_s))
        pending: Deque[Request] = collections.deque()
        done: List[Request] = []
        inflight: Dict[Any, Dict[str, Any]] = {}
        t0 = time.time()
        batches = 0
        mid_applied = 0
        while todo or pending or inflight:
            now = time.time() - t0
            while todo and todo[0].arrival_s <= now:
                pending.append(todo.popleft())
            # health: restart dead (or heartbeat-silent) workers, requeueing
            # their in-flight batch
            for w in self.workers:
                dead = not w.alive()
                hung = (w in inflight and self.hb_timeout_s
                        and w.hb_age() > self.hb_timeout_s)
                if dead or hung:
                    self._restart(w, inflight, pending)
            # dispatch to every idle worker while there is work
            for w in self.workers:
                if not pending:
                    break
                if w in inflight or not w.alive():
                    continue
                batch, decode_steps = self.scheduler.admit(pending)
                if not batch:
                    break
                cmd = {"cmd": "serve",
                       "requests": [{"rid": r.rid,
                                     "tokens": np.asarray(r.tokens).tolist(),
                                     "max_new_tokens": r.max_new_tokens}
                                    for r in batch],
                       "decode_steps": decode_steps,
                       "prompt_len": self.prompt_len,
                       "sync_during_decode": sync_during_decode}
                try:
                    mid = w.submit(cmd)
                except worker_lib.WorkerDied:
                    for req in reversed(batch):
                        pending.appendleft(req)
                    continue                   # the health pass restarts it
                inflight[w] = {"batch": batch, "id": mid,
                               "decode_steps": decode_steps}
            # collect
            got_reply = False
            for w in list(inflight):
                msg = w.take_reply(timeout=0.0)
                if msg is None:
                    continue
                entry = inflight[w]
                if msg.get("id") != entry["id"] or not msg.get("ok"):
                    # a failed serve (or a stale reply): requeue, restart
                    self._restart(w, inflight, pending)
                    continue
                inflight.pop(w)
                got_reply = True
                t_done = time.time() - t0
                head, step = msg.get("head"), msg.get("step", 0)
                staleness = 0 if head is None else max(int(head) - step, 0)
                mid_applied += int(msg.get("mid_applied", 0))
                by_rid = {r.rid: r for r in entry["batch"]}
                for rid, toks, ngen in zip(msg["rids"], msg["tokens"],
                                           msg["tokens_generated"]):
                    req = by_rid[rid]
                    req.t_done = t_done
                    req.latency_s = t_done - req.arrival_s
                    req.tokens_out = np.asarray(toks, dtype=np.int64)
                    req.tokens_generated = int(ngen)
                    req.replica = w.name
                    req.staleness = staleness
                    done.append(req)
                batches += 1
            if not got_reply:
                time.sleep(0.002)
        return _summary(done, batches,
                        restarts=sum(w.restarts for w in self.workers),
                        mid_applied=mid_applied,
                        workers=[w.name for w in self.workers])
