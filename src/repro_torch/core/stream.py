"""Train→serve streaming: the downlink wire as an ordered, seekable log
(counterpart of src/repro/core/stream.py, the reference's DESIGN.md §12).

Every round the server broadcasts the carrier wire of C_down(g − h) and
every subscriber integrates h' = h + decode(wire) (DESIGN.md §8). This
module makes that broadcast a durable transport, so serving replicas can
subscribe too:

  * ``WireRecord`` — one group's wire for one step, with an explicit
    ``(step, spec_hash, group)`` header. ``kind='delta'`` records carry the
    per-leaf carrier wires (apply: h += decode); ``kind='dense'`` records
    carry the group's dense server leaves (a group without a downlink
    carrier: g_est IS the payload).
  * ``WireLog`` — a directory of one npz file a record (written to a
    ``*.tmp.npz`` and renamed into place), ordered and seekable by step,
    plus the ``bootstrap/`` checkpoints a replica joins from. The files are
    the reference's, byte layout and all, so each package reads the
    other's: ``records/rec_<step:08d>_g<group:02d>.npz`` with arrays
    ``l{i}_c{j}`` and a ``__meta__`` JSON (``stream: "wire/v1"``,
    ``struct``, ``dtypes``).
  * ``Publisher`` — the trainer-side hook: re-encodes each round's
    broadcast with the operations the step ran (``ef.downlink_sync``:
    δ = server − h, ``downlink_encode``, ``downlink_apply``) from the
    step's own stream, and REFUSES to append a record whose wires do not
    reproduce the trainer's post-step h bit for bit. A trainer of several
    ranks runs it on its first rank, on the trees gathered into the
    single-device layout, and every rank raises its refusal
    (launch/session.py ``Session._publish``).
  * ``Subscriber`` — the replica-side state machine: holds (params,
    opt_state, h, step) and advances them record by record through the
    train step's tail (``carriers.downlink_apply``, then the optimizer),
    so each applied record lands the replica bit-identical to the
    trainer's post-step model.

Payload components are CPU tensors. numpy has no bfloat16 without
``ml_dtypes``, so a bfloat16 component is written as float32 (exact) under
its name ``"bfloat16"`` in ``dtypes``, as the reference writes it, and read
back as ``torch.bfloat16``; a reference-side numpy bfloat16 array is taken
by its bits.

The Publisher's stream is the port's own (core/rng.py): the round that
produced post-step ``step`` ran ``round_generator(seed, step - 1)``, its
compression folds 1, the downlink folds ``DOWNLINK_FOLD``, then each group
``schedule._group_rng``. A randomized downlink therefore publishes other
wires than the JAX trainer would; the Subscriber draws nothing, so a
replica of either package replays either package's records.

Integrity rules: out-of-order application raises ``StreamOrderError``; a
missing record raises ``StreamGapError`` (the replica must resync via a
later bootstrap + replay, never skip — launch/fleet.py); a record written
by another RunSpec raises ``StreamSpecMismatch``. A republish after a
trainer's kill-and-resume is idempotent: an append that equals the record
on disk bit for bit is a no-op, a conflicting one raises
``StreamIntegrityError``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import carriers as carrier_lib
from repro_torch.core import compressors as comp_lib
from repro_torch.core import ef as ef_lib
from repro_torch.core import rng as rng_lib
from repro_torch.core import schedule as sched_lib

Tree = Dict[str, torch.Tensor]

STREAM_SCHEMA = "wire/v1"

# the numpy names of the dtypes numpy holds natively, as ``dtypes`` records
# them, and the extension dtypes it lacks here (stored as f32, cast back by
# name on read)
_NP_NAMES = {torch.float32: "float32", torch.float64: "float64",
             torch.float16: "float16", torch.int8: "int8",
             torch.uint8: "uint8", torch.int16: "int16",
             torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_EXT = {"bfloat16": torch.bfloat16}
_EXT_NAMES = {v: k for k, v in _EXT.items()}


class StreamError(RuntimeError):
    """Base class for wire-stream failures."""


class StreamOrderError(StreamError):
    """A record was applied out of order (step != subscriber step + 1)."""


class StreamGapError(StreamError):
    """A needed record is missing from the log — resync, never skip."""


class StreamSpecMismatch(StreamError):
    """Record and subscriber were built from different RunSpecs."""


class StreamIntegrityError(StreamError):
    """A record conflicts with the log or fails the bit-exact verify."""


# ---------------------------------------------------------------------------
# payload components
# ---------------------------------------------------------------------------

def _as_tensor(c) -> torch.Tensor:
    """One payload component as a tensor: a tensor as it is (detached), a
    numpy array by its bits (a reference-side bfloat16 array, which only
    ``ml_dtypes`` names, through int16)."""
    if isinstance(c, torch.Tensor):
        return c.detach()
    arr = np.asarray(c)
    if str(arr.dtype) == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr))


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a component's dtype, as ``dtypes`` records it."""
    name = _NP_NAMES.get(t.dtype) or _EXT_NAMES.get(t.dtype)
    if name is None:
        raise StreamError(f"no wire name for dtype {t.dtype}")
    return name


def _stored(t: torch.Tensor) -> np.ndarray:
    """What the npz holds for a component: extension dtypes as f32."""
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype in _EXT_NAMES else t.numpy()


def _loaded(arr: np.ndarray, name: str) -> torch.Tensor:
    ext = _EXT.get(name)
    if ext is not None:
        return torch.from_numpy(arr).to(ext)
    if str(arr.dtype) != name:
        arr = arr.astype(np.dtype(name))
    return torch.from_numpy(arr)


def _leaf_comps(leaf) -> Tuple[Any, ...]:
    return leaf if isinstance(leaf, tuple) else (leaf,)


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireRecord:
    """One group's downlink payload for one step. ``step`` is the trainer's
    POST-step counter: applying this record advances a replica holding the
    step-1 model to the trainer's exact step-``step`` model."""

    step: int
    spec_hash: str
    group: str                 # group pattern ('*' on the uniform path)
    group_index: int
    n_records: int             # records that make up this step (non-empty groups)
    kind: str                  # 'delta' (h += decode) | 'dense' (g_est = payload)
    payload: Tuple[Any, ...]   # per leaf: a tensor | a tuple of tensors


def _arrays_equal(a, b) -> bool:
    """Same dtype, shape and bits; a NaN equals a NaN (the reference's
    ``np.array_equal(equal_nan=True)``)."""
    a, b = _as_tensor(a), _as_tensor(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.device != b.device:
        b = b.to(a.device)
    if a.is_floating_point():
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def _record_arrays(rec: WireRecord) -> List[torch.Tensor]:
    return [_as_tensor(c) for leaf in rec.payload for c in _leaf_comps(leaf)]


def records_equal(a: WireRecord, b: WireRecord) -> bool:
    if (a.step, a.spec_hash, a.group, a.group_index, a.n_records, a.kind) != \
            (b.step, b.spec_hash, b.group, b.group_index, b.n_records, b.kind):
        return False
    aa, bb = _record_arrays(a), _record_arrays(b)
    return len(aa) == len(bb) and all(
        _arrays_equal(x, y) for x, y in zip(aa, bb))


def record_nbytes(rec: WireRecord) -> int:
    """On-the-wire payload bytes of one record (arrays only, no header)."""
    return sum(t.numel() * t.element_size() for t in _record_arrays(rec))


# ---------------------------------------------------------------------------
# the log
# ---------------------------------------------------------------------------

_REC_RE = re.compile(r"^rec_(\d{8})_g(\d{2})\.npz$")
_BOOT_RE = re.compile(r"^step_(\d{8})\.npz$")


class WireLog:
    """Directory-backed record log: ``records/rec_<step>_g<group>.npz`` plus
    the ``bootstrap/step_<step>.npz`` full-state checkpoints replicas join
    from. Writes are atomic (mkstemp + rename; ``*.tmp.npz`` partials from a
    killed writer are never listed)."""

    def __init__(self, root: str):
        self.root = root
        self.records_dir = os.path.join(root, "records")
        self.bootstrap_dir = os.path.join(root, "bootstrap")

    def record_path(self, step: int, group_index: int) -> str:
        return os.path.join(self.records_dir,
                            f"rec_{step:08d}_g{group_index:02d}.npz")

    def bootstrap_path(self, step: int) -> str:
        return os.path.join(self.bootstrap_dir, f"step_{step:08d}.npz")

    def listing(self) -> Dict[int, List[int]]:
        """{step: [group indices present]} over complete FILES only."""
        if not os.path.isdir(self.records_dir):
            return {}
        out: Dict[int, List[int]] = {}
        for f in os.listdir(self.records_dir):
            m = _REC_RE.match(f)
            if m:
                out.setdefault(int(m.group(1)), []).append(int(m.group(2)))
        return out

    def steps(self) -> List[int]:
        """Steps with at least one record file, sorted."""
        return sorted(self.listing())

    def last_step(self) -> Optional[int]:
        """Newest step whose record set is COMPLETE (a writer killed between
        the group files of one step must not surface a partial step). Reads
        each file's ``__meta__`` alone: a poll never loads a record's
        arrays."""
        listing = self.listing()
        for step in sorted(listing, reverse=True):
            try:
                metas = [self.read_meta(step, gi) for gi in listing[step]]
            except StreamError:
                continue
            want = metas[0]["n_records"]
            if len(metas) == want and all(m["n_records"] == want
                                          for m in metas):
                return step
        return None

    def bootstrap_steps(self) -> List[int]:
        if not os.path.isdir(self.bootstrap_dir):
            return []
        return sorted(int(m.group(1)) for m in map(
            _BOOT_RE.match, os.listdir(self.bootstrap_dir)) if m)

    def latest_bootstrap(self, upto: Optional[int] = None) -> Optional[str]:
        steps = [s for s in self.bootstrap_steps()
                 if upto is None or s <= upto]
        return self.bootstrap_path(steps[-1]) if steps else None

    def append(self, rec: WireRecord) -> bool:
        """Write one record atomically. Idempotent on republish: a
        bit-identical existing record is a no-op (returns False), a
        conflicting one raises ``StreamIntegrityError`` — the log never
        silently forks."""
        path = self.record_path(rec.step, rec.group_index)
        if os.path.exists(path):
            if records_equal(self.read(rec.step, rec.group_index), rec):
                return False
            raise StreamIntegrityError(
                f"refusing to overwrite {path}: a record for step {rec.step} "
                f"group {rec.group!r} already exists with different bits "
                "(a diverged republish would silently fork the stream)")
        os.makedirs(self.records_dir, exist_ok=True)
        flat: Dict[str, np.ndarray] = {}
        struct: List[int] = []
        dtypes: List[List[str]] = []
        for i, leaf in enumerate(rec.payload):
            comps = _leaf_comps(leaf)
            struct.append(len(comps) if isinstance(leaf, tuple) else -1)
            names = []
            for j, c in enumerate(comps):
                t = _as_tensor(c)
                names.append(_dtype_name(t))
                flat[f"l{i}_c{j}"] = _stored(t)
            dtypes.append(names)
        meta = {"stream": STREAM_SCHEMA, "step": rec.step,
                "spec_hash": rec.spec_hash, "group": rec.group,
                "group_index": rec.group_index, "n_records": rec.n_records,
                "kind": rec.kind, "struct": struct, "dtypes": dtypes}
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)
        fd, tmp = tempfile.mkstemp(dir=self.records_dir, suffix=".tmp.npz")
        os.close(fd)
        try:
            np.savez(tmp, **flat)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return True

    def _open(self, step: int, group_index: int):
        path = self.record_path(step, group_index)
        if not os.path.exists(path):
            raise StreamGapError(
                f"no record for step {step} group {group_index} under "
                f"{self.records_dir!r}")
        return path, np.load(path)

    @staticmethod
    def _meta_of(path: str, z) -> Dict[str, Any]:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("stream") != STREAM_SCHEMA:
            raise StreamIntegrityError(
                f"{path}: unknown stream schema {meta.get('stream')!r} "
                f"(this reader speaks {STREAM_SCHEMA!r})")
        return meta

    def read_meta(self, step: int, group_index: int) -> Dict[str, Any]:
        """One record file's ``__meta__`` (its header), no array read."""
        path, z = self._open(step, group_index)
        with z:
            return self._meta_of(path, z)

    def read(self, step: int, group_index: int) -> WireRecord:
        path, z = self._open(step, group_index)
        with z:
            meta = self._meta_of(path, z)
            payload: List[Any] = []
            for i, (nc, names) in enumerate(zip(meta["struct"],
                                                meta["dtypes"])):
                comps = [_loaded(z[f"l{i}_c{j}"], name) for j, name in
                         enumerate(names if nc != -1 else names[:1])]
                payload.append(tuple(comps) if nc != -1 else comps[0])
        return WireRecord(step=meta["step"], spec_hash=meta["spec_hash"],
                          group=meta["group"],
                          group_index=meta["group_index"],
                          n_records=meta["n_records"], kind=meta["kind"],
                          payload=tuple(payload))

    def read_step(self, step: int) -> List[WireRecord]:
        """Every group record of one step, ordered by group index. Raises
        ``StreamGapError`` when the step is absent and
        ``StreamIntegrityError`` when only PART of the step's record set is
        on disk (a half-published step must never be applied)."""
        present = sorted(self.listing().get(step, []))
        if not present:
            raise StreamGapError(
                f"no records for step {step} under {self.records_dir!r}")
        recs = [self.read(step, gi) for gi in present]
        want = recs[0].n_records
        if len(recs) != want or any(r.n_records != want for r in recs):
            raise StreamIntegrityError(
                f"step {step} has {len(recs)} of {want} group records — "
                "partial publish; refusing to apply an incomplete step")
        return recs


# ---------------------------------------------------------------------------
# transport legs — the resolved downlink plan shared by both ends
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Leg:
    """One group's transport: which leaves it covers and how they travel.
    ``carrier is None`` means the group has no downlink — its server leaves
    ship dense (``kind='dense'``), the implicit dense broadcast of
    ``schedule.downlink_round_grouped``. ``keys`` names the leaves at
    ``leaf_ii`` (positions in the reference's leaf order)."""

    name: str
    index: int                  # schedule group index — the rng fold index
    n_groups: int
    leaf_ii: Tuple[int, ...]    # leaf positions in the full flat param list
    carrier: Optional[Any] = None
    comp: Optional[Any] = None
    keys: Tuple[str, ...] = ()


def resolve_legs(params_like: Tree, schedule=None,
                 down_carrier: str = "dense",
                 down_compressor=None) -> List[Leg]:
    """The downlink transport legs for one spec, resolved once against the
    tree's leaves and shared by the publisher and every subscriber (same
    group indices → same rng folds → same wires). ``params_like`` may live
    on the meta device."""
    order = sched_lib.leaf_order(params_like)
    if schedule is None:
        ii, keys = tuple(range(len(order))), tuple(order)
        if down_carrier == "dense" and down_compressor is None:
            return [Leg(name="*", index=0, n_groups=1, leaf_ii=ii, keys=keys)]
        comp = down_compressor if down_compressor is not None \
            else comp_lib.Identity()
        return [Leg(name="*", index=0, n_groups=1, leaf_ii=ii,
                    carrier=carrier_lib.make(down_carrier), comp=comp,
                    keys=keys)]
    pos = {k: i for i, k in enumerate(order)}
    ng = len(schedule.groups)
    legs: List[Leg] = []
    for gi, (grp, keys) in enumerate(zip(
            schedule.groups, sched_lib.group_keys(schedule, params_like))):
        if not keys:
            continue                       # the trainer skips empty groups
        leg = Leg(name=grp.pattern, index=gi, n_groups=ng,
                  leaf_ii=tuple(pos[k] for k in keys), keys=tuple(keys))
        if grp.has_downlink:
            leg = dataclasses.replace(
                leg, carrier=carrier_lib.make(grp.down_carrier),
                comp=grp.down_comp())
        legs.append(leg)
    return legs


def legs_wire_words(legs: Sequence[Leg], params_like: Tree) -> float:
    """Broadcast words of one sync over all legs (a leg without a downlink
    ships its dense leaves). One wire serves both the training sync and the
    serving fleet: fleet downlink bytes are THESE words × 4 a subscriber."""
    order = sched_lib.leaf_order(params_like)
    total = 0.0
    for leg in legs:
        for i in leg.leaf_ii:
            d = params_like[order[i]].numel()
            total += float(d) if leg.carrier is None else \
                carrier_lib.downlink_words(leg.carrier, leg.comp, d)
    return total


def round_down_rng(seed: int, step: int, device=None) -> torch.Generator:
    """The downlink stream of the round that PRODUCED post-step ``step``:
    the step ran ``round_generator(seed, step - 1)``, its compression
    folds 1, the downlink leg folds ``DOWNLINK_FOLD``
    (core/distributed.py)."""
    r_round = rng_lib.round_generator(seed, step - 1, device)
    return rng_lib.fold_in(rng_lib.fold_in(r_round, 1),
                           carrier_lib.DOWNLINK_FOLD)


def _take(tree: Tree, keys: Sequence[str]) -> Tree:
    return {k: tree[k] for k in keys}


def encode_leg(leg: Leg, server: Tree, h: Tree, rng=None
               ) -> Tuple[List[Any], Tree]:
    """The leg's wires and the h they integrate to: the operations of the
    step's ``ef.downlink_sync`` (δ = server − h, ``downlink_encode``,
    ``downlink_apply``) on the leg's leaves."""
    h_g = _take(h, leg.keys)
    delta = ef_lib.tree_sub(_take(server, leg.keys), h_g)
    wires = carrier_lib.downlink_encode(leg.carrier, leg.comp, delta, rng)
    del delta
    return wires, carrier_lib.downlink_apply(leg.carrier, leg.comp, wires,
                                             h_g)


def _host(w):
    return tuple(c.detach().cpu() for c in w) if isinstance(w, tuple) \
        else w.detach().cpu()


# ---------------------------------------------------------------------------
# trainer side — publisher
# ---------------------------------------------------------------------------

class Publisher:
    """Appends one WireRecord a leg after each trainer step, re-encoding the
    broadcast and verifying that the wires reproduce the trainer's own
    post-step h bit for bit before anything is written. A failed verify
    raises: the log never carries a record that would drift a replica.
    ``seed`` is the run's (``spec.seed``): the re-encode draws from the
    stream the step drew from (:func:`round_down_rng`), on the device of
    the server's tensors."""

    def __init__(self, log: WireLog, spec_hash: str, legs: Sequence[Leg],
                 seed: int):
        self.log = log
        self.spec_hash = spec_hash
        self.legs = list(legs)
        self.seed = int(seed)

    def publish(self, step: int, server: Tree, h_prev: Optional[Tree],
                h_new: Optional[Tree]) -> int:
        """Publish the wire of the round that produced post-step ``step``.
        Returns the number of NEW records written (0 when a resumed trainer
        republishes steps already in the log — verified equal, skipped)."""
        r_down = None
        if any(leg.carrier is not None for leg in self.legs):
            device = next(iter(server.values())).device
            r_down = round_down_rng(self.seed, step, device)
        written = 0
        for leg in self.legs:
            if leg.carrier is None:
                payload = tuple(server[k].detach().cpu() for k in leg.keys)
                kind = "dense"
            else:
                if h_prev is None or h_new is None:
                    raise StreamError("downlink legs need the broadcast "
                                      "memory h before and after the step")
                r_leg = sched_lib._group_rng(r_down, leg.index, leg.n_groups)
                # the proof obligation: these wires, applied through the
                # downlink_apply every subscriber runs, must land on the
                # trainer's own h — else publishing would fork the stream
                wires, got = encode_leg(leg, server, h_prev, r_leg)
                for k in leg.keys:
                    if not _arrays_equal(got[k], h_new[k]):
                        raise StreamIntegrityError(
                            f"step {step} group {leg.name!r} leaf {k!r}: the "
                            "re-encoded wire does not reproduce the "
                            "trainer's post-step h bit for bit; refusing to "
                            "publish a drifting record")
                del got
                payload = tuple(_host(w) for w in wires)
                kind = "delta"
            rec = WireRecord(step=step, spec_hash=self.spec_hash,
                             group=leg.name, group_index=leg.index,
                             n_records=len(self.legs), kind=kind,
                             payload=payload)
            written += int(self.log.append(rec))
        return written


# ---------------------------------------------------------------------------
# replica side — subscriber
# ---------------------------------------------------------------------------

def _on(leaf, device):
    if isinstance(leaf, tuple):
        return tuple(_as_tensor(c).to(device) for c in leaf)
    return _as_tensor(leaf).to(device)


class Subscriber:
    """The replica-side state machine (DESIGN.md §12): subscribe → apply →
    (serve) → resync. Holds exactly the state the train step's tail touches
    — params, opt_state, the broadcast memory h, and the step cursor — and
    advances it one record set at a time. The h-integration runs through
    the SAME ``carriers.downlink_apply`` as the trainer's downlink and the
    optimizer step is the same ``optimizer.update`` + ``apply_updates``, so
    an applied step is bit-identical to the trainer's. The record's arrays
    move to the device of ``params``.

    Resync (checkpoint + replay on a gap) lives in launch/fleet.py — this
    class only guarantees it never applies out of order and never skips."""

    def __init__(self, log, spec_hash: str, legs: Sequence[Leg],
                 params: Tree, opt_state: Dict[str, Any],
                 h: Optional[Tree], step: int, optimizer):
        self.log = log
        self.spec_hash = spec_hash
        self.legs = list(legs)
        self.params = params
        self.opt_state = opt_state
        self.h = h
        self.step = int(step)
        self.optimizer = optimizer

    def _check(self, recs: List[WireRecord]) -> List[WireRecord]:
        if not recs:
            raise StreamGapError("empty record set")
        for rec in recs:
            if rec.spec_hash != self.spec_hash:
                raise StreamSpecMismatch(
                    f"record step {rec.step} group {rec.group!r} was "
                    f"published by a different RunSpec (hash "
                    f"{rec.spec_hash} != {self.spec_hash}); refusing to "
                    "apply a foreign stream (the checkpoint foreign-spec "
                    "rule, DESIGN.md §7)")
            if rec.step != self.step + 1:
                raise StreamOrderError(
                    f"out-of-order record: got step {rec.step}, replica is "
                    f"at {self.step} (next applicable is {self.step + 1}); "
                    "applying out of order would silently drift h")
        by_index = {r.group_index: r for r in recs}
        want = [leg.index for leg in self.legs]
        if sorted(by_index) != sorted(want) or len(by_index) != len(recs):
            raise StreamIntegrityError(
                f"step {recs[0].step}: record groups {sorted(by_index)} do "
                f"not match the spec's transport legs {sorted(want)}")
        ordered = [by_index[leg.index] for leg in self.legs]
        for leg, rec in zip(self.legs, ordered):
            want_kind = "dense" if leg.carrier is None else "delta"
            if rec.kind != want_kind:
                raise StreamIntegrityError(
                    f"step {rec.step} group {rec.group!r}: kind "
                    f"{rec.kind!r} does not match the leg's {want_kind!r}")
            if len(rec.payload) != len(leg.leaf_ii):
                raise StreamIntegrityError(
                    f"step {rec.step} group {rec.group!r}: {len(rec.payload)}"
                    f" payload leaves for {len(leg.leaf_ii)} group leaves")
        return ordered

    def apply(self, recs: List[WireRecord]) -> None:
        """Apply one step's full record set; the replica lands bit-identical
        to the trainer's post-step model at ``recs[0].step``."""
        from repro_torch.optim.optimizer import apply_updates
        ordered = self._check(recs)
        device = next(iter(self.params.values())).device
        est: Tree = {}
        for leg, rec in zip(self.legs, ordered):
            payload = [_on(p, device) for p in rec.payload]
            if leg.carrier is None:
                est.update(zip(leg.keys, payload))
            else:
                est.update(carrier_lib.downlink_apply(
                    leg.carrier, leg.comp, payload, _take(self.h, leg.keys)))
        g_est = {k: est[k] for k in sorted(est)}
        # the trainer's optimizer.update ran with the PRE-increment step
        updates, self.opt_state = self.optimizer.update(
            g_est, self.opt_state, self.params, self.step)
        self.params = apply_updates(self.params, updates)
        if self.h is not None:
            self.h = g_est
        self.step += 1

    def sync(self, upto: Optional[int] = None) -> int:
        """Apply every available record in order, up to ``upto`` (default:
        the log's last complete step). Returns the number of steps applied.
        Raises ``StreamGapError`` when a needed record is missing while later
        ones exist — the caller must resync from a bootstrap (fleet layer),
        because skipping would serve silently drifted weights."""
        last = self.log.last_step()
        if last is None:
            return 0
        target = last if upto is None else min(int(upto), last)
        applied = 0
        while self.step < target:
            self.apply(self.log.read_step(self.step + 1))
            applied += 1
        return applied
