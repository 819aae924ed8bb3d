"""Session: the runtime facade over a RunSpec (counterpart of
src/repro/launch/session.py: training with checkpoints, the wire stream it
publishes, and static serving).

    spec = RunSpec.from_json(open("results/specs/fused_quickstart.json").read())
    sess = Session(spec)              # on cuda; Session(spec, device="cpu")
    sess.publish_to("/tmp/wire")      # every step's downlink wire, logged
    sess.train(3)                     # saves under spec.ckpt_dir when set
    sess = Session.resume(spec.ckpt_dir)     # the same run, from its latest
    sess.serve(batch=8, prompt_len=1024, decode_steps=32)

Training state (params, optimizer state, EF state) is built lazily on first
use: parameters from a CPU ``torch.Generator`` seeded with ``spec.seed``, then
the batch-0 per-client gradients initialize the EF state (Alg 1 line 2),
as in the reference. ``save`` writes that state, the step and the spec in
the reference's npz layout; ``restore_from`` reads a checkpoint of either
package back (refusing one written by another RunSpec), and ``resume``
rebuilds a run from the spec its latest checkpoint embeds.

The spec's ``mesh`` names the geometry (launch/mesh.py): ``smoke`` is the
single-device runtime with ``spec.clients`` emulated clients; ``pod`` and
``multi_pod`` span the ``torch.distributed`` world (shrunk pod-major to its
rank count; ``launch/multiproc.py`` joins it), and on more than one rank
each rank is one client: it draws the global batch and keeps its client's
rows, the round is ``ef_round_sharded``, the loss is the clients' mean.
On one rank they run the single-device runtime as ``smoke`` does. A world
that would give the ``model`` axis more than one rank is refused here, as
are ``publish_to`` and ``serve`` on more than one rank (both arrive with
later slices). ``save`` on a sharded run writes one npz from the first
rank with the clients gathered on a leading axis: the keys, shapes and
spec hash of the single-device layout; ``restore_from`` gives each rank its
slice back.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import base as cb
from repro_torch.core import comm
from repro_torch.core import distributed as dist
from repro_torch.core import rng as rng_lib
from repro_torch.core import schedule as sched_lib
from repro_torch.data import pipeline as pipe_lib
from repro_torch.launch import build as build_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.launch.spec import RunSpec
from repro_torch.models import model as model_lib
from repro_torch.optim import optimizer as opt_lib


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` means cuda. Asking for cuda without a card raises: nothing
    moves to the CPU unless the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Session runs on cuda, and no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions of the kernels on the CPU")
    return dev


class Session:
    """Runtime facade over one RunSpec. ``dtype`` overrides the activation
    dtype of the arch config (the parity tests run both packages in f32)."""

    def __init__(self, spec: RunSpec, device: Optional[str] = None,
                 dtype: Optional[str] = None):
        self.spec = spec
        self.device = resolve_device(device)
        cfg = self._arch_config(spec)
        self.cfg = dataclasses.replace(cfg, dtype=dtype) if dtype else cfg
        self.step = 0                      # the data cursor: pipe.batch(step)
        self.history: List[Dict[str, float]] = []
        self._tr: Optional[Dict[str, Any]] = None
        self._last_saved_step: Optional[int] = None
        # the tree serve() runs, placed and cast once; every path that
        # changes the served tree (step_once, restore_from,
        # set_serve_params) drops it, so an unchanged tree is not moved or
        # cast again and a changed one is never served stale
        self._serve_params: Optional[Dict[str, torch.Tensor]] = None
        self._serve_src: Optional[Dict[str, torch.Tensor]] = None
        self._publisher = None             # core/stream.py, see publish_to
        self._bootstrap_every = 0
        self.mesh = self._make_mesh(spec.mesh)
        if self.mesh.shape.get("model", 1) > 1:
            raise ValueError(
                f"mesh={spec.mesh!r} on this world gives the 'model' axis "
                f"{self.mesh.shape['model']} ranks ({self.mesh.shape}); the "
                "'model' axis (param_pspecs, tp_pad_heads) arrives with the "
                "next slice of the port (ROADMAP Queue 1 item 3)")
        self.plan = sh.ShardPlan(spec.client_granularity,
                                 spec.state_sharding, spec.ef_state_dtype)

    @staticmethod
    def _make_mesh(name: str) -> mesh_lib.Mesh:
        if name == "smoke":
            return mesh_lib.make_smoke_mesh()
        return mesh_lib.make_production_mesh(multi_pod=(name == "multi_pod"))

    @property
    def sharded(self) -> bool:
        """True when each rank of the mesh is one client."""
        return self.mesh.size > 1

    def _refuse_sharded(self, what: str) -> None:
        if self.sharded:
            raise ValueError(
                f"{what} on a session of {self.mesh.size} ranks arrives with "
                "a later slice of the port (ROADMAP Queue 1 item 3); run it "
                "on the smoke mesh")

    @staticmethod
    def _arch_config(spec: RunSpec) -> cb.ArchConfig:
        """The spec's arch config (its smoke variant under ``spec.smoke``),
        with the spec's ``moe_impl``."""
        cfg = cb.get_smoke(spec.arch) if spec.smoke else cb.get(spec.arch)
        if spec.moe_impl != "dispatch":
            cfg = dataclasses.replace(cfg, moe_impl=spec.moe_impl)
        return cfg

    @property
    def n_clients(self) -> int:
        if not self.sharded:
            return self.spec.clients
        return mesh_lib.dp_size(self.mesh)

    def _client_axes(self):
        """The group of all clients through this rank (its ``index`` is
        this rank's client, pod-major)."""
        return self.mesh.axes(self.mesh.client_axes())

    def _pods(self, efc) -> int:
        hops = efc.effective_hops
        return hops.pods if hops is not None else 1

    def schedule_table(self) -> Optional[str]:
        """The resolved per-group table for this session's arch (leaf and
        parameter counts, each group's plan and degradation reason, wire
        words up and down), or None without a schedule. Reads the tree's
        shapes from the meta device: nothing is allocated."""
        sched = build_lib.make_schedule(self.spec)
        if sched is None:
            return None
        return sched_lib.plan_table(
            sched, build_lib.make_method(self.spec),
            model_lib.init_params(self.cfg, None, "meta"), eta=self.spec.eta)

    def _pipe(self, seed: int) -> pipe_lib.SyntheticTokens:
        spec, cfg = self.spec, self.cfg
        return pipe_lib.SyntheticTokens(pipe_lib.DataConfig(
            vocab_size=cfg.vocab_size, seq_len=spec.seq_len,
            global_batch=spec.global_batch, seed=seed,
            dp_groups=self.n_clients, heterogeneity=spec.heterogeneity))

    def _ensure_train(self, template: bool = False) -> Dict[str, Any]:
        """Build the training bundle. With ``template=True`` the state trees
        (params, opt_state, ef_state) live on the meta device — their
        structure, shapes and dtypes without memory, init or the batch-0
        gradients; ``restore_from`` fills every leaf from a checkpoint."""
        if self._tr is not None:
            return self._tr
        spec, cfg, n = self.spec, self.cfg, self.n_clients
        sharded = self.sharded
        efc = build_lib.ef_config(spec, n)
        opt = opt_lib.make(spec.optimizer, lr=spec.lr)
        pipe = self._pipe(spec.seed)

        def loss_fn(p, b):
            return model_lib.train_loss(cfg, p, b)

        if template:
            params = model_lib.init_params(cfg, None, "meta")
            ef_state = dist.init_ef_state_sharded(efc, params, self.mesh) \
                if sharded else dist.init_ef_state(efc, params, n)
        else:
            params = model_lib.init_params(
                cfg, torch.Generator().manual_seed(spec.seed), self.device)
            # Alg 1 line 2: v⁰ᵢ = g⁰ᵢ = the clients' gradients on batch 0
            b0 = pipe_lib.with_prefix_embeds(cfg, pipe.batch(0, self.device))
            if sharded:
                # this rank's client: its rows of batch 0, its gradients
                mine = dist.client_rows(b0, n, self._client_axes().index)
                _, _, g0 = dist.per_client_value_and_grad(loss_fn, params,
                                                          mine, 1)
                ef_state = dist.init_ef_state_sharded(efc, params, self.mesh,
                                                      init_grads=g0)
            else:
                _, _, g0 = dist.per_client_value_and_grad(loss_fn, params,
                                                          b0, n)
                ef_state = dist.init_ef_state(efc, params, n, init_grads=g0)
        self._tr = {
            "pipe": pipe, "loss_fn": loss_fn, "efc": efc,
            "step_fn": dist.make_train_step(
                loss_fn, efc, opt, n, mesh=self.mesh if sharded else None,
                overlap=spec.overlap),
            "params": params, "opt_state": opt.init(params),
            "ef_state": ef_state,
        }
        return self._tr

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._ensure_train()["params"]

    @property
    def opt_state(self) -> Dict[str, Any]:
        return self._ensure_train()["opt_state"]

    @property
    def ef_state(self) -> Dict[str, Any]:
        return self._ensure_train()["ef_state"]

    def batch_for(self, step: int) -> Dict[str, torch.Tensor]:
        """The global batch of ``step`` (deterministic in (seed, step)),
        with the frontend's zero prefix padded to ``PREFIX_PAD_MIN``."""
        return pipe_lib.with_prefix_embeds(
            self.cfg, self._ensure_train()["pipe"].batch(step, self.device))

    def step_once(self) -> Dict[str, torch.Tensor]:
        """Advance exactly one training step; returns the step metrics."""
        tr = self._ensure_train()
        batch = self.batch_for(self.step)
        # the step's stream, pure in (seed, step): a resumed run replays it
        rng = rng_lib.round_generator(self.spec.seed, self.step, self.device)
        # the step leaves the old h's tensors untouched (the downlink builds
        # new ones), so holding the dict keeps the pre-step h
        h_prev = tr["ef_state"].get("h") if self._publisher is not None \
            else None
        tr["params"], tr["opt_state"], tr["ef_state"], m = tr["step_fn"](
            tr["params"], tr["opt_state"], tr["ef_state"], batch, self.step,
            rng)
        self.step += 1
        self._params_changed()
        if self._publisher is not None:
            # this round's downlink wire, verified bit for bit against the
            # step's own h before anything reaches the log
            self._publisher.publish(self.step, tr["ef_state"]["server"],
                                    h_prev, tr["ef_state"].get("h"))
            if self._bootstrap_every \
                    and self.step % self._bootstrap_every == 0:
                self._write_bootstrap(self._publisher.log)
        return m

    def train(self, steps: int, log_every: int = 10, verbose: bool = False
              ) -> List[Dict[str, float]]:
        """Train until the step counter reaches ``steps`` (absolute: a
        resumed session goes on from its checkpoint's step). Logs every
        ``log_every`` steps and the last one; returns the new entries. With
        ``spec.ckpt_dir`` set, saves every ``spec.ckpt_every`` steps (when
        > 0) and at the end."""
        spec = self.spec
        self._ensure_train()
        new: List[Dict[str, float]] = []
        t0, start = time.time(), self.step
        while self.step < steps:
            m = self.step_once()
            step = self.step - 1
            if (log_every and step % log_every == 0) or step == steps - 1:
                rec = {"step": step, "loss": float(m["loss"]),
                       "g_norm": float(m["g_norm"])}
                self.history.append(rec)
                new.append(rec)
                if verbose:
                    print(f"step {step:5d} loss {rec['loss']:8.4f} "
                          f"g_norm {rec['g_norm']:.3e} "
                          f"({(time.time()-t0)/max(step-start+1,1):.2f}s/step)",
                          flush=True)
            if (spec.ckpt_dir and spec.ckpt_every
                    and self.step % spec.ckpt_every == 0):
                self.save()
        # the end-of-train save, unless the periodic one just wrote this step
        if spec.ckpt_dir and self._last_saved_step != self.step:
            self.save()
        return new

    def evaluate(self, batches: int = 2) -> float:
        """Mean loss over ``batches`` held-out batches (the synthetic stream
        at seed + 1, disjoint from every training batch) at the current
        params."""
        tr = self._ensure_train()
        pipe = self._pipe(self.spec.seed + 1)
        with torch.no_grad():
            losses = [float(tr["loss_fn"](
                tr["params"], pipe_lib.with_prefix_embeds(
                    self.cfg, pipe.batch(i, self.device)))[0])
                for i in range(batches)]
        return sum(losses) / max(len(losses), 1)

    # ---------------------------------------------------------- checkpoints
    def _state(self) -> Dict[str, Any]:
        tr = self._ensure_train()
        return {"params": tr["params"], "opt_state": tr["opt_state"],
                "ef_state": tr["ef_state"]}

    def save(self, path: Optional[str] = None) -> str:
        """Write the FULL training state — params, opt_state, ef_state, the
        step (the data cursor: ``pipe.batch(step)`` resumes the stream) and
        the spec — to ``path``, by default ``step_<step>.npz`` under
        ``spec.ckpt_dir``. Returns the path."""
        if path is None:
            if not self.spec.ckpt_dir:
                raise ValueError("no ckpt_dir in the spec and no path given")
            path = os.path.join(self.spec.ckpt_dir,
                                f"step_{self.step:08d}.npz")
        state = self._state()
        if self.sharded:
            # every rank hands its client's leaves to the first, which
            # writes the single-device layout; the others wait for the file
            axes = self._client_axes()
            ef_full = sh.global_state(state["ef_state"], axes,
                                      self._pods(self._tr["efc"]))
            if axes.index == 0:
                ckpt_lib.save(path, dict(state, ef_state=ef_full),
                              step=self.step, spec=self.spec)
            comm.barrier(axes)
        else:
            ckpt_lib.save(path, state, step=self.step, spec=self.spec)
        self._last_saved_step = self.step
        return path

    def restore_from(self, path: str, allow_spec_mismatch: bool = False
                     ) -> None:
        """Replace the full training state with the checkpoint at ``path``
        (written by this package or by the JAX one: the layout is the same)
        and take over its step. Refuses a checkpoint whose recorded
        ``spec_hash`` is not this spec's, naming the differing fields,
        unless ``allow_spec_mismatch``."""
        meta = ckpt_lib.read_meta(path)
        stored = meta.get("spec_hash")
        if stored is not None and stored != self.spec.spec_hash() \
                and not allow_spec_mismatch:
            diff = ""
            if "spec" in meta:
                other = RunSpec.from_dict(meta["spec"])
                diff = "\n  - " + "\n  - ".join(self.spec.diff(other))
            raise ValueError(
                f"checkpoint {path} was written by a different RunSpec "
                f"(hash {stored} != {self.spec.spec_hash()}); refusing to "
                f"resume across experiment definitions.{diff}\n"
                "Pass allow_spec_mismatch=True / --allow-spec-mismatch to "
                "override.")
        # a fresh session restores into a meta-device template: no init, no
        # batch-0 gradients, and no second copy of the state on the device
        created = self._tr is None
        self._ensure_train(template=created)
        try:
            if self.sharded:
                state, meta = self._restore_slice(path)
            else:
                state, meta = ckpt_lib.restore(path, self._state(),
                                               self.device)
        except BaseException:
            if created:
                self._tr = None         # never leave a template behind
            raise
        self._tr.update(state)
        self.step = int(meta["step"])
        # the restored params are the new serving truth, even at the same
        # step, and they supersede an injected serving tree
        self._serve_src = None
        self._params_changed()

    def _restore_slice(self, path: str):
        """A sharded rank's restore: the checkpoint's single-device layout
        read on the host, this rank's client (and pod) slice kept, moved to
        the device."""
        efc, n = self._tr["efc"], self.n_clients
        like = dict(self._state(), ef_state=dist.init_ef_state(
            efc, model_lib.init_params(self.cfg, None, "meta"), n))
        state, meta = ckpt_lib.restore(path, like, "cpu")
        state["ef_state"] = sh.local_state(
            state["ef_state"], self._client_axes().index, self._pods(efc), n)
        return sh.to_device(state, self.device), meta

    # -------------------------------------------------------- wire streaming
    def publish_to(self, stream_dir: str, bootstrap_every: int = 0):
        """Attach a core/stream.py Publisher: every later ``step_once``
        appends this round's downlink wire records to ``stream_dir`` (one a
        transport leg, verified bit for bit against the step's own h).
        Writes a full-state bootstrap checkpoint into the stream when the
        log has no record at or past the current step, so a replica can
        join from the stream directory alone (checkpoint + replay);
        ``bootstrap_every`` adds one every that many steps, for cheaper
        mid-stream joins and gap resyncs. Returns the WireLog."""
        from repro_torch.core import stream as stream_lib
        self._refuse_sharded("publish_to")
        tr = self._ensure_train()
        efc = tr["efc"]
        legs = stream_lib.resolve_legs(
            tr["params"], schedule=efc.schedule,
            down_carrier=efc.down_carrier,
            down_compressor=efc.down_compressor)
        log = stream_lib.WireLog(stream_dir)
        last = log.last_step()
        if last is None or last < self.step:
            # nothing in the log reaches this trainer's state by replay:
            # anchor the stream here so subscribers have a join point
            self._write_bootstrap(log)
        self._bootstrap_every = int(bootstrap_every)
        self._publisher = stream_lib.Publisher(
            log, self.spec.spec_hash(), legs, self.spec.seed)
        return log

    @property
    def publisher(self):
        """The attached core/stream.py Publisher, or None."""
        return self._publisher

    def _write_bootstrap(self, log) -> str:
        """One full-state checkpoint INSIDE the stream directory of ``log``
        — what replicas join from and resync to (the spec embedded, as in a
        ckpt_dir checkpoint)."""
        path = log.bootstrap_path(self.step)
        if not os.path.exists(path):
            ckpt_lib.save(path, self._state(), step=self.step,
                          spec=self.spec)
        return path

    @classmethod
    def resume(cls, ckpt_dir: str, spec: Optional[RunSpec] = None,
               overrides: Optional[Dict[str, Any]] = None,
               allow_spec_mismatch: bool = False,
               device: Optional[str] = None, dtype: Optional[str] = None
               ) -> "Session":
        """Rebuild a run from the latest checkpoint under ``ckpt_dir``. The
        RunSpec embedded in it is the source of truth; ``overrides`` changes
        single fields on top of it (an experiment-defining change still
        needs ``allow_spec_mismatch``). Pass ``spec`` to insist on an exact
        spec instead: it must hash-match the checkpoint unless allowed."""
        path = ckpt_lib.latest(ckpt_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
        if spec is None:
            meta = ckpt_lib.read_meta(path)
            if "spec" not in meta:
                raise ValueError(f"checkpoint {path} has no embedded RunSpec; "
                                 "pass spec= explicitly")
            embedded = RunSpec.from_dict(meta["spec"])
            spec = dataclasses.replace(embedded, ckpt_dir=ckpt_dir,
                                       **(overrides or {}))
            if spec.spec_hash() == embedded.spec_hash():
                allow_spec_mismatch = True   # no experiment-defining change
        elif overrides:
            raise ValueError("pass either spec= or overrides=, not both")
        sess = cls(spec, device=device, dtype=dtype)
        sess.restore_from(path, allow_spec_mismatch=allow_spec_mismatch)
        return sess

    # --------------------------------------------------------------- serving
    def serve_source(self) -> Dict[str, torch.Tensor]:
        """THE parameter tree serve() uses, in priority order: the injected
        serving tree (``set_serve_params``), else the live training tree,
        else a fresh init from ``spec.seed``."""
        if self._serve_src is not None:
            return self._serve_src
        if self._tr is not None:
            return self._tr["params"]
        return model_lib.init_params(
            self.cfg, torch.Generator().manual_seed(self.spec.seed),
            self.device)

    def set_serve_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Inject the tree serve() must use from now on."""
        self._serve_src = params
        self._params_changed()

    def _params_changed(self) -> None:
        """The served tree changed: drop its placed, cast copy (the next
        serve builds it again)."""
        self._serve_params = None

    def serving_params(self) -> Dict[str, torch.Tensor]:
        """The tree serve() runs: ``serve_source()`` on the device, its
        matrix leaves cast to the activation dtype
        (``model.cast_matrices``), built once per version of the params. In
        f32 serving it is the placed tree itself."""
        if self._serve_params is None:
            self._serve_params = model_lib.cast_matrices(
                self.cfg, {k: t.to(self.device)
                           for k, t in self.serve_source().items()})
        return self._serve_params

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, tokens=None, batch: int = 4, prompt_len: int = 128,
              decode_steps: int = 32, prompt_lens=None,
              decode_hook: Optional[Callable[[int], None]] = None
              ) -> Dict[str, Any]:
        """Batched prefill, then greedy decode against a KV cache. Returns
        ``tokens`` ((B, decode_steps+1) int32 numpy: the prefill's token,
        then one a decode step), ``prefill_s``, ``decode_s``,
        ``prefill_tok_s``, ``decode_tok_s`` and ``cache_bytes``; each time
        ends in a synchronize on the card.

        ``tokens`` (B, S) are the prompts; when not given they are drawn
        from a ``torch.Generator`` seeded with ``spec.seed``, which cannot
        reproduce the reference's jax.random prompts (pass tokens to
        compare). ``prompt_lens`` (per-row true lengths <= S) takes each
        row's first token from its last real position, so right padding
        never reaches it. ``decode_hook(i)`` runs before decode step i; if
        it changes the served tree (``set_serve_params``), the remaining
        steps decode with the new tree."""
        self._refuse_sharded("serve")
        cfg = self.cfg
        if tokens is None:
            tokens = torch.randint(
                0, cfg.vocab_size, (batch, prompt_len),
                generator=torch.Generator().manual_seed(self.spec.seed))
        tokens = torch.as_tensor(tokens, device=self.device)
        B, S = tokens.shape
        # the production padding of the frontend prefix, as the reference
        pad = pipe_lib.PREFIX_PAD_SPEC
        n_prefix = pipe_lib.prefix_token_count(cfg, pad_to=pad)
        prefill = build_lib.build_prefill(cfg)
        decode = build_lib.build_decode(cfg)
        params = self.serving_params()
        batch_in = pipe_lib.with_prefix_embeds(cfg, {"tokens": tokens},
                                               pad_to=pad)
        if prompt_lens is not None:
            batch_in["prompt_lens"] = torch.as_tensor(prompt_lens,
                                                      device=self.device)
        cache = model_lib.init_cache(
            cfg, B, build_lib.cache_len(S, decode_steps, n_prefix),
            device=self.device)

        self._sync()
        t0 = time.time()
        logits, cache = prefill(params, batch_in, cache)
        self._sync()
        t_prefill = time.time() - t0

        tok = logits[:, -1].argmax(-1)[:, None]
        out_tokens = [tok]
        t0 = time.time()
        for i in range(decode_steps):
            if decode_hook is not None:
                decode_hook(i)
                params = self.serving_params()
            logits, cache = decode(params, cache, tok, n_prefix + S + i)
            tok = logits[:, -1].argmax(-1)[:, None]
            out_tokens.append(tok)
        self._sync()
        t_decode = time.time() - t0

        return {
            "tokens": torch.cat(out_tokens, dim=1).to(torch.int32).cpu()
            .numpy(),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "prefill_tok_s": B * S / max(t_prefill, 1e-9),
            "decode_tok_s": decode_steps * B / max(t_decode, 1e-9),
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in cache.values()),
        }

