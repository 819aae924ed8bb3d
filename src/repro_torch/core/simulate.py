"""The n-client simulator of the paper's experiments (counterpart of
src/repro/core/simulate.py): Algorithm 1's outer loop, and the loops of
Algorithms 3–5 and of the EF14/SGD/NEOLITHIC baselines, over a problem of
core/problems.py.

All n clients are carried on a leading axis on one device, and each round
runs the production round itself: ``distributed.ef_round`` on an EF config
built from the ``SimConfig`` (:func:`ef_config`), so what the simulator
validates is what trains the model, carrier for carrier (the kernels K2–K6
included). The simulator adds what only it has: the problem's gradients
(all clients' in one draw; STORM's pair on one draw; the ideal method's
exact gradients), the initial batch B_init, the time-varying schedule
γₜ = γ/√(t+1), ηₜ = min(1, 1/√(t+1)) (η a 0-d tensor then, so the fused
plans degrade as the reference's traced ηₜ does), the naive downlink
without memory (``down_memory=False``), per-step metrics and the wire
accounting of the plan that ran. The metrics stay on the device and are
stacked once at the end; the step loop reads nothing back to the host
(a sampled round's cohort is the exception: it is built on the host).

Streams: round t draws from ``fold_in(generator(seed), t)`` (core/rng.py),
its gradients from ``fold_in(·, 1)``, its compressors from
``fold_in(·, 2)`` and the downlink from that folded with ``DOWNLINK_FOLD``;
the B_init handshake from ``fold_in(generator(seed), INIT_FOLD)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core import carriers as carrier_lib
from repro_torch.core import compressors as comp_lib
from repro_torch.core import distributed as dist
from repro_torch.core import ef as ef_lib
from repro_torch.core import hierarchy as hier_lib
from repro_torch.core import participation as part_lib
from repro_torch.core import rng as rng_lib
from repro_torch.core import schedule as sched_lib


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n: int = 1                      # number of clients
    batch_size: int = 1             # per-client minibatch B
    gamma: float = 1e-3             # step size γ
    eta: Optional[float] = None     # momentum η (None: the method's)
    steps: int = 1000               # T
    b_init: int = 1                 # initial batch size B_init (Alg 1 line 2)
    time_varying: bool = False      # γₜ = γ/√(t+1), ηₜ = 1/√(t+1) (App. J)
    carrier: str = "dense"          # any core/carriers.py REGISTRY name
    # the downlink (server → client broadcast): 'dense' with no compressor
    # runs none; down_memory=False is the naive ablation (C(g) broadcast,
    # no server memory re-sends the compression error)
    down_carrier: str = "dense"
    down_compressor: Optional[comp_lib.Compressor] = None
    down_memory: bool = True
    # per-parameter-group compression: when set, the single-knob
    # carrier/down_* fields are ignored (as EFConfig.schedule)
    schedule: Optional[sched_lib.CompressionSchedule] = None
    # sampled participation; mode 'async' runs on participation.run_async
    participation: Optional[part_lib.Participation] = None
    # two-tier hierarchy (clients → pod aggregator → server)
    hops: Optional[hier_lib.Hops] = None


def ef_config(cfg: SimConfig, method: ef_lib.Method) -> dist.EFConfig:
    """The production round's config of a simulator config (the same
    carriers, schedule, participation and hops)."""
    return dist.EFConfig(method=method, carrier=cfg.carrier,
                         down_carrier=cfg.down_carrier,
                         down_compressor=cfg.down_compressor,
                         schedule=cfg.schedule,
                         participation=cfg.participation, hops=cfg.hops)


def _uplink_only(efc: dist.EFConfig) -> dist.EFConfig:
    """``efc`` without its downlink: the simulator runs the broadcast
    itself (it has the memory-less ablation the round has not)."""
    sched = efc.schedule
    if sched is not None:
        sched = sched_lib.CompressionSchedule(tuple(
            dataclasses.replace(g, down_carrier="dense", down_compressor=None)
            for g in sched.groups))
    return dataclasses.replace(efc, down_carrier="dense",
                               down_compressor=None, schedule=sched)


def _tree_dim(tree) -> int:
    return sum(int(x.numel()) for x in tree.values())


def client_grads(problem, method, x, x_next, gen, n: int, B: int):
    """The n clients' gradients of one round, drawn in one call: at x' for
    most methods; (stochastic, exact) at x' for the ideal method (the
    problem's ``client_grad``, else its full gradient); for STORM the pair
    at x' and at x under ONE draw."""
    if not method.needs_paired_grads:
        return problem.stoch_grad(x_next, gen, B, n)
    draw = problem.draw(gen, B, n)
    g_new = problem.grad_on(x_next, draw, n)
    if method.name == "ef21_sgdm_ideal":
        if hasattr(problem, "client_grad"):
            return g_new, problem.client_grad(x_next, n)
        full = problem.full_grad(x_next)
        return g_new, {k: v.expand(n, *v.shape).contiguous()
                       for k, v in full.items()}
    return g_new, problem.grad_on(x, draw, n)


def init_grads(problem, x0, base: torch.Generator, n: int, B: int,
               b_init: int):
    """Alg 1 line 2: each of the n clients' mean of ``b_init`` minibatch
    gradients at x⁰, minibatch j drawn for all clients from
    ``fold_in(fold_in(base, INIT_FOLD), j)``."""
    gen = rng_lib.fold_in(base, rng_lib.INIT_FOLD)
    draws = [problem.stoch_grad(x0, rng_lib.fold_in(gen, j), B, n)
             for j in range(b_init)]
    if len(draws) == 1:
        return draws[0]
    return {k: sum((d[k] for d in draws[1:]), draws[0][k]) / len(draws)
            for k in draws[0]}


class Simulation:
    """One run, a round at a time: ``Simulation(problem, method, cfg,
    seed)`` takes the B_init handshake, each :meth:`step` runs one round,
    :meth:`result` gives what :func:`run` returns. The clients' EF state,
    the server's estimate g, the broadcast estimate and x live on the
    problem's device; each step appends ‖∇f(xᵗ)‖² and f(xᵗ) there."""

    def __init__(self, problem, method: ef_lib.Method, cfg: SimConfig,
                 seed: int = 0):
        part = cfg.participation
        if part is not None and part.mode == "async":
            raise ValueError(
                "participation mode 'async' does not run on the synchronous "
                "simulator (every step is a barrier); drive the event-driven "
                "simulator instead: repro_torch.core.participation.run_async")
        self.problem, self.method, self.cfg = problem, method, cfg
        self.x = problem.init_x()
        dev = next(iter(self.x.values())).device
        self.base = rng_lib.generator(seed, dev)
        self.efc = ef_config(cfg, method)
        self._efc_up = _uplink_only(self.efc)
        g0 = init_grads(problem, self.x, self.base, cfg.n, cfg.batch_size,
                        cfg.b_init)
        self.state = dist.init_ef_state(self.efc, self.x, cfg.n,
                                        init_grads=g0)
        # what the clients step with: the broadcast memory h under a
        # downlink, else the server's estimate itself
        self.g_est = self.state.pop("h", self.state["server"])
        self._down_car = carrier_lib.make(cfg.down_carrier)
        self._eta0 = cfg.eta if cfg.eta is not None \
            else getattr(method, "eta", 1.0)
        if cfg.time_varying:
            self._scales = 1.0 / torch.sqrt(torch.arange(
                cfg.steps, dtype=torch.float32, device=dev) + 1.0)
        self.t = 0
        self.gns, self.fls = [], []

    def step(self) -> None:
        """Round t: x' = x − γₜ·g_est; the clients' gradients at x'; the
        production round (uplink, aggregate, server); ‖∇f(x')‖² and f(x');
        the downlink; x ← x'."""
        cfg, t = self.cfg, self.t
        gen = rng_lib.fold_in(self.base, t)
        if cfg.time_varying:
            scale = self._scales[t]
            gamma_t, eta_t = cfg.gamma * scale, torch.clamp(scale, max=1.0)
        else:
            gamma_t, eta_t = cfg.gamma, self._eta0
        x, g_est = self.x, self.g_est
        x_next = {k: x[k] - gamma_t * g_est[k] for k in x}
        grads = client_grads(self.problem, self.method, x, x_next,
                             rng_lib.fold_in(gen, 1), cfg.n, cfg.batch_size)
        r_comp = rng_lib.fold_in(gen, 2)
        g_server, self.state = dist.ef_round(self._efc_up, grads, self.state,
                                             eta=eta_t, step=t, rng=r_comp)
        del grads
        full, fl = self.problem.full_grad_and_loss(x_next)
        self.gns.append(ef_lib.tree_norm_sq(full))
        self.fls.append(fl)
        if self.efc.has_downlink:
            r_down = rng_lib.fold_in(r_comp, carrier_lib.DOWNLINK_FOLD)
            if cfg.schedule is not None:
                g_est, _ = sched_lib.downlink_round_grouped(
                    cfg.schedule, g_server, g_est, r_down,
                    memory=cfg.down_memory)
            else:
                g_est, _ = ef_lib.downlink_sync(
                    self._down_car, self.efc.down_comp(), g_server, g_est,
                    rng=r_down, memory=cfg.down_memory)
        else:
            g_est = g_server
        self.x, self.g_est = x_next, g_est
        self.t += 1

    def result(self) -> Dict[str, Any]:
        out = {"grad_norm_sq": torch.stack(self.gns) if self.gns
               else torch.zeros(0),
               "loss": torch.stack(self.fls) if self.fls else torch.zeros(0),
               "x_final": self.x}
        out.update(accounting(self.problem.init_x(), self.method, self.cfg))
        return out


def run(problem, method: ef_lib.Method, cfg: SimConfig, seed: int = 0
        ) -> Dict[str, Any]:
    """Run T = ``cfg.steps`` rounds. Returns the per-step ``grad_norm_sq``
    ‖∇f(xᵗ)‖² and ``loss`` f(xᵗ) as (T,) tensors on the problem's device,
    ``x_final`` (a tree), and the wire accounting of one round (floats):
    the idealized ``coords_per_round`` and the words up, down, in total,
    intra- and cross-pod (and per group under a schedule), all of the plan
    that ran."""
    sim = Simulation(problem, method, cfg, seed)
    for _ in range(cfg.steps):
        sim.step()
    return sim.result()


def accounting(x0, method: ef_lib.Method, cfg: SimConfig) -> Dict[str, Any]:
    """The wire accounting of one round over the tree ``x0``, following
    the plan that executes (a degraded carrier ships the dense d words; a
    time-varying η is accounted as the reference's traced one). Sampled
    rounds count the m = cohort_size uploads; the broadcast reaches all n."""
    d_total = _tree_dim(x0)
    part = cfg.participation
    sampling = part is not None and part.is_sampling
    m_cohort = part.cohort_size(cfg.n) if sampling else cfg.n
    eta_static = None if cfg.time_varying else (
        cfg.eta if cfg.eta is not None else getattr(method, "eta", 1.0))
    efc = ef_config(cfg, method)
    if cfg.schedule is not None:
        up_per, up_each = sched_lib.wire_words_tree(
            cfg.schedule, method, x0, "up", eta_static)
        dn_per, dn_each = sched_lib.wire_words_tree(
            cfg.schedule, method, x0, "down", eta_static)
        up_words, down_words = up_each * m_cohort, dn_each * cfg.n
        coords = sched_lib.coords_tree(cfg.schedule, method, x0) * m_cohort
        group_words = {
            "wire_words_up_per_group": tuple(w * m_cohort for w in up_per),
            "wire_words_down_per_group": tuple(w * cfg.n for w in dn_per),
        }
    else:
        carrier = carrier_lib.make(cfg.carrier)
        executed = cfg.carrier \
            if carrier.plan(method, eta_static) != "dense" else "dense"
        up_words = method.coords_per_message(
            d_total, carrier=executed) * m_cohort
        down_comp = cfg.down_compressor if cfg.down_compressor is not None \
            else comp_lib.Identity()
        down_each = carrier_lib.downlink_words(
            carrier_lib.make(cfg.down_carrier), down_comp, d_total) \
            if efc.has_downlink else float(d_total)
        down_words = down_each * cfg.n
        coords = method.coords_per_message(d_total) * m_cohort
        group_words = {}
    hops = efc.effective_hops
    if hops is None:
        intra_words, cross_words = 0.0, up_words
    else:
        intra_words = up_words
        cross_words = hier_lib.wire_words_cross(hops, cfg.schedule, method,
                                                x0)
    return {
        "coords_per_round": coords,
        "wire_words_per_round": up_words,
        "wire_words_up_per_round": up_words,
        "wire_words_down_per_round": down_words,
        "wire_words_total_per_round": intra_words + cross_words + down_words,
        "wire_words_intra_per_round": intra_words,
        "wire_words_cross_per_round": cross_words,
        **group_words,
    }


def to_numpy(out: Dict[str, Any]) -> Dict[str, Any]:
    """A run's result with every tensor (and tree of tensors) as numpy."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v
    return {k: conv(v) for k, v in out.items()}


def run_numpy(problem, method: ef_lib.Method, cfg: SimConfig, seed: int = 0
              ) -> Dict[str, Any]:
    """:func:`run` with its tensors as numpy arrays."""
    return to_numpy(run(problem, method, cfg, seed))

