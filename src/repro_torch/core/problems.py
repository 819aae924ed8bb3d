"""The paper's test problems (counterpart of src/repro/core/problems.py).

Every problem holds the data of all n clients on one device and answers for
all of them at once, the clients on a leading axis:

    init_x()                        -> tree x⁰
    draw(gen, B, clients)           -> one draw ξ of the clients' minibatches
                                       (indices or noise), on the device
    grad_on(x, draw, clients)       -> tree of per-client gradients (m, ...)
                                       of fᵢ(·, ξᵢ) at x
    stoch_grad(x, gen, B, clients)  =  grad_on(x, draw(gen, B, clients))
    full_grad(x)                    -> tree ∇f(x) = meanᵢ ∇fᵢ(x)
    loss(x)                         -> 0-d tensor f(x)
    full_grad_and_loss(x)           -> both, sharing the passes they can

``clients`` is an int n (clients 0..n-1; the synchronous simulator's) or a
1-D index tensor (the event-driven simulator takes one client at a time).
STORM's paired gradients are two ``grad_on`` calls on ONE draw. The data
and the initial points come from the reference's ``np.random.RandomState``
calls in the reference's order, so they are bit for bit the reference's,
and are moved to the device once. A tree is a flat dict (core/ef.py); a
problem whose iterate is one bare array in the reference keeps it under
the key ``""``, the reference's key path of a bare array, so schedule
patterns resolve on it as they do there.

The gradients are written out (softmax minus one-hot, the MLP's backward by
hand) as batched products over the clients; they agree with the reference's
``jax.grad`` to f32 rounding (tests/test_torch_problems.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ef as ef_lib

Tree = Dict[str, torch.Tensor]
LEAF = ""           # the key of a bare-array iterate (its empty key path)


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` means cuda; asking for cuda without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the problems live on cuda, and no CUDA device is "
                           "available; pass device='cpu'")
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    """Base: identity-hashed, data on ``device`` (cuda unless told)."""
    __hash__ = object.__hash__

    def _dev(self) -> torch.device:
        return self.__dict__["_device"]

    def _place(self, **arrays) -> None:
        dev = resolve_device(getattr(self, "device", None))
        object.__setattr__(self, "_device", dev)
        for name, a in arrays.items():
            object.__setattr__(self, name, torch.as_tensor(a).to(dev))

    def _index(self, clients) -> Optional[torch.Tensor]:
        """None for all of the problem's clients in order (no gather), else
        the clients' indices on the device."""
        if isinstance(clients, int):
            if clients == getattr(self, "n", None):
                return None
            clients = range(clients)
        if isinstance(clients, range):
            return torch.arange(clients.start, clients.stop,
                                device=self._dev())
        return torch.as_tensor(clients, device=self._dev()).reshape(-1)

    @staticmethod
    def _count(clients) -> int:
        return clients if isinstance(clients, int) else len(clients)

    def _rows(self, data: torch.Tensor, draw: torch.Tensor, clients
              ) -> torch.Tensor:
        """data[client, draw] for each client: (m, B, ...)."""
        idx = self._index(clients)
        if idx is None:
            idx = torch.arange(data.shape[0], device=self._dev())
        return data[idx[:, None], draw]

    def stoch_grad(self, x: Tree, gen: torch.Generator, B: int,
                   clients) -> Tree:
        return self.grad_on(x, self.draw(gen, B, clients), clients)

    def full_grad_and_loss(self, x: Tree) -> Tuple[Tree, torch.Tensor]:
        return self.full_grad(x), self.loss(x)


def _mean_keep(x: torch.Tensor, axis: int) -> torch.Tensor:
    return x.sum(axis) / x.shape[axis]


# ---------------------------------------------------------------------------
# Theorem 1 / Figure 1
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class QuadraticT1(Problem):
    """f(x) = (L/2)‖x‖², x ∈ ℝ², with Theorem 1's adversarial noise
    ξ ∈ {(2,0), (0,1), (−2,−1)}·√(3σ²/(10B)), each w.p. 1/3: zero mean, but
    Top-1 of it is biased, which drives EF21-SGD away from the optimum.
    The clients are identical."""

    L: float = 1.0
    sigma: float = 1.0
    x0: Tuple[float, float] = (0.0, -0.01)
    device: Optional[str] = None

    def __post_init__(self):
        self._place(_Z=np.array([[2.0, 0.0], [0.0, 1.0], [-2.0, -1.0]],
                                np.float32))

    def init_x(self) -> Tree:
        return {LEAF: torch.tensor(self.x0, dtype=torch.float32,
                                   device=self._dev())}

    def _zs(self, B: int) -> torch.Tensor:
        # the scale in f32, as the reference's jnp.sqrt takes it
        s = float(np.sqrt(np.float32(3.0 * self.sigma ** 2 / (10.0 * B))))
        return self._Z * s

    def draw(self, gen, B, clients):
        """(m, B) indices into the three noise points."""
        return torch.randint(0, 3, (self._count(clients), B), generator=gen,
                             device=self._dev())

    def grad_on(self, x, draw, clients):
        xi = _mean_keep(self._zs(draw.shape[1])[draw], 1)        # (m, 2)
        return {LEAF: self.L * x[LEAF] + xi}

    def client_grad(self, x, clients):
        m = self._count(clients)
        return {LEAF: (self.L * x[LEAF]).expand(m, 2).contiguous()}

    def full_grad(self, x):
        return {LEAF: self.L * x[LEAF]}

    def loss(self, x):
        return 0.5 * self.L * torch.sum(x[LEAF] * x[LEAF])


# ---------------------------------------------------------------------------
# Algorithm 2: stochastic quadratics (Experiment 3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class RandomQuadratics(Problem):
    """fᵢ(x) = ½xᵀQᵢx − xᵀbᵢ with Qᵢ from the paper's Algorithm 2 (noisy
    scaled tridiagonal, the mean matrix's least eigenvalue set to λ);
    ∇fᵢ(x, ξ) = ∇fᵢ(x) + ξ, ξ ~ N(0, σ²I/B). All clients' Qᵢx are one
    batched product."""

    n: int = 100
    d: int = 1000
    lam: float = 0.01
    scale: float = 1.0
    sigma: float = 0.001
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        n, d, s = self.n, self.d, self.scale
        mu_s = 1.0 + s * rng.randn(n)
        mu_b = s * rng.randn(n)
        base = (np.diag(2.0 * np.ones(d)) + np.diag(-np.ones(d - 1), 1)
                + np.diag(-np.ones(d - 1), -1))
        Qs = np.stack([(m / 4.0) * base for m in mu_s])          # (n, d, d)
        bs = np.zeros((n, d))
        bs[:, 0] = (mu_s / 4.0) * (-1.0 + mu_b)
        lam_min = np.linalg.eigvalsh(Qs.mean(0)).min()
        Qs = Qs + (self.lam - lam_min) * np.eye(d)
        self._place(_Q=Qs.astype(np.float32), _b=bs.astype(np.float32))
        object.__setattr__(self, "_b_mean", _mean_keep(self._b, 0))

    def init_x(self):
        x = np.zeros(self.d, np.float32)
        x[0] = np.sqrt(self.d)
        return {LEAF: torch.from_numpy(x).to(self._dev())}

    def draw(self, gen, B, clients):
        """(m, B, d) standard normal noise."""
        return torch.randn((self._count(clients), B, self.d), generator=gen,
                           device=self._dev())

    def client_grad(self, x, clients):
        idx = self._index(clients)
        Q, b = (self._Q, self._b) if idx is None else (self._Q[idx],
                                                      self._b[idx])
        return {LEAF: torch.matmul(Q, x[LEAF]) - b}              # (m, d)

    def grad_on(self, x, draw, clients):
        noise = self.sigma * _mean_keep(draw, 1)
        return {LEAF: self.client_grad(x, clients)[LEAF] + noise}

    def full_grad_and_loss(self, x):
        qx = torch.matmul(self._Q, x[LEAF])
        g = {LEAF: qx.sum(0) / self.n - self._b_mean}
        q = 0.5 * torch.dot(x[LEAF], qx.sum(0)) / self.n
        return g, q - torch.dot(x[LEAF], self._b_mean)

    def full_grad(self, x):
        return self.full_grad_and_loss(x)[0]

    def loss(self, x):
        return self.full_grad_and_loss(x)[1]


# ---------------------------------------------------------------------------
# Experiments 1 & 2: nonconvex-regularized softmax logistic regression
# ---------------------------------------------------------------------------

def _make_classification(rng: np.random.RandomState, m: int, l: int, c: int,
                         label_noise: float = 0.15):
    """Synthetic classification data with class structure; ``label_noise``
    flips a fraction of the labels so the problem is not interpolable."""
    centers = rng.randn(c, l) * 1.5
    y = rng.randint(0, c, size=m)
    a = centers[y] + rng.randn(m, l)
    flip = rng.rand(m) < label_noise
    y = np.where(flip, rng.randint(0, c, size=m), y)
    return a.astype(np.float32), y.astype(np.int32)


def _ce_grad_logits(logits: torch.Tensor, y: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per client (leading axis) the mean cross-entropy over the batch axis
    and its gradient in the logits: (softmax − onehot(y)) / batch."""
    logp = torch.log_softmax(logits, -1)
    ce = -_mean_keep(torch.gather(logp, -1, y[..., None].long())[..., 0], -1)
    dz = torch.exp(logp)
    dz.scatter_add_(-1, y[..., None].long(),
                    -torch.ones_like(dz[..., :1]))
    return ce, dz / logits.shape[-2]


@dataclasses.dataclass(frozen=True, eq=False)
class LogisticRegression(Problem):
    """§4: fᵢ = −(1/m)Σⱼ log softmax(aᵢⱼᵀx)_{yᵢⱼ} + λΣ x²/(1+x²), the data
    split across clients by label (the paper's heterogeneous protocol). The
    iterate is (c, l+1) under ``"x"``."""

    n: int = 10
    m_per_client: int = 512
    l: int = 64
    c: int = 10
    lam: float = 1e-3
    seed: int = 0
    heterogeneous: bool = True
    device: Optional[str] = None

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        m_total = self.n * self.m_per_client
        a, y = _make_classification(rng, m_total, self.l, self.c)
        if self.heterogeneous and self.n > 1:
            order = np.argsort(y, kind="stable")      # label split
            a, y = a[order], y[order]
        a = np.concatenate([a, np.ones((m_total, 1), np.float32)], axis=1)
        self._place(_A=a.reshape(self.n, self.m_per_client, self.l + 1),
                    _Y=y.reshape(self.n, self.m_per_client))

    @property
    def dim(self) -> int:
        return self.c * (self.l + 1)

    def init_x(self):
        return {LEAF: torch.zeros((self.c, self.l + 1), dtype=torch.float32,
                                  device=self._dev())}

    def draw(self, gen, B, clients):
        """(m, B) sample indices within each client's data."""
        return torch.randint(0, self.m_per_client, (self._count(clients), B),
                             generator=gen, device=self._dev())

    def _reg_grad(self, x: torch.Tensor) -> torch.Tensor:
        q = 1.0 + x * x
        return self.lam * (2.0 * x / (q * q))

    def _reg(self, x: torch.Tensor) -> torch.Tensor:
        return self.lam * torch.sum(x * x / (1.0 + x * x))

    def _ce(self, x, a, y):
        """Per client: mean CE over the rows of a (m, rows, l+1), and its
        gradient in x, (m, c, l+1)."""
        ce, dz = _ce_grad_logits(torch.matmul(a, x.T), y)
        return ce, torch.matmul(dz.transpose(1, 2), a)

    def grad_on(self, x, draw, clients):
        _, g = self._ce(x[LEAF], self._rows(self._A, draw, clients),
                        self._rows(self._Y, draw, clients))
        return {LEAF: g + self._reg_grad(x[LEAF])}

    def full_grad_and_loss(self, x):
        ce, g = self._ce(x[LEAF], self._A, self._Y)
        return ({LEAF: _mean_keep(g, 0) + self._reg_grad(x[LEAF])},
                _mean_keep(ce, 0) + self._reg(x[LEAF]))

    def full_grad(self, x):
        return self.full_grad_and_loss(x)[0]

    def loss(self, x):
        ce, _ = _ce_grad_logits(torch.matmul(self._A, x[LEAF].T), self._Y)
        return _mean_keep(ce, 0) + self._reg(x[LEAF])


# ---------------------------------------------------------------------------
# Experiment 4: neural-network training
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class MLPClassification(Problem):
    """A two-hidden-layer ReLU MLP classifier on synthetic data, split
    across clients by label: the stand-in for the paper's ResNet18/CIFAR10
    run (Figures 8–9). Leaves w1, b1, w2, b2, w3, b3."""

    n: int = 5
    m_per_client: int = 256
    in_dim: int = 32
    hidden: int = 64
    c: int = 10
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        m_total = self.n * self.m_per_client
        a, y = _make_classification(rng, m_total, self.in_dim, self.c)
        order = np.argsort(y, kind="stable")
        a, y = a[order], y[order]
        self._place(_A=a.reshape(self.n, self.m_per_client, self.in_dim),
                    _Y=y.reshape(self.n, self.m_per_client))

    def init_x(self):
        r = np.random.RandomState(self.seed + 1)
        dev = self._dev()

        def glorot(i, o):
            w = r.randn(i, o).astype(np.float32) * np.sqrt(2.0 / (i + o))
            return torch.from_numpy(w.astype(np.float32)).to(dev)

        def zeros(k):
            return torch.zeros(k, dtype=torch.float32, device=dev)
        # the reference's dict literal draws w1, w2, w3 in this order
        w1 = glorot(self.in_dim, self.hidden)
        w2 = glorot(self.hidden, self.hidden)
        w3 = glorot(self.hidden, self.c)
        return {"b1": zeros(self.hidden), "b2": zeros(self.hidden),
                "b3": zeros(self.c), "w1": w1, "w2": w2, "w3": w3}

    def _forward(self, p, a):
        h1 = torch.relu(torch.matmul(a, p["w1"]) + p["b1"])
        h2 = torch.relu(torch.matmul(h1, p["w2"]) + p["b2"])
        return h1, h2, torch.matmul(h2, p["w3"]) + p["b3"]

    def _value_and_grad(self, p, a, y) -> Tuple[torch.Tensor, Tree]:
        """Per client (leading axis of a (m, rows, in_dim)): the mean CE and
        its gradient in every leaf, by hand (ReLU's derivative is 0 at 0, as
        jax.nn.relu's)."""
        h1, h2, z = self._forward(p, a)
        ce, dz = _ce_grad_logits(z, y)
        dh2 = torch.matmul(dz, p["w3"].T) * (h2 > 0)
        dh1 = torch.matmul(dh2, p["w2"].T) * (h1 > 0)
        at = a.transpose(1, 2)
        return ce, {"b1": dh1.sum(1), "b2": dh2.sum(1), "b3": dz.sum(1),
                    "w1": torch.matmul(at, dh1),
                    "w2": torch.matmul(h1.transpose(1, 2), dh2),
                    "w3": torch.matmul(h2.transpose(1, 2), dz)}

    def draw(self, gen, B, clients):
        """(m, B) sample indices within each client's data."""
        return torch.randint(0, self.m_per_client, (self._count(clients), B),
                             generator=gen, device=self._dev())

    def grad_on(self, x, draw, clients):
        return self._value_and_grad(x, self._rows(self._A, draw, clients),
                                    self._rows(self._Y, draw, clients))[1]

    def full_grad_and_loss(self, x):
        ce, g = self._value_and_grad(x, self._A, self._Y)
        return ef_lib.tree_map(lambda v: _mean_keep(v, 0), g), \
            _mean_keep(ce, 0)

    def full_grad(self, x):
        return self.full_grad_and_loss(x)[0]

    def loss(self, x):
        ce, _ = _ce_grad_logits(self._forward(x, self._A)[2], self._Y)
        return _mean_keep(ce, 0)

    def accuracy(self, x) -> torch.Tensor:
        logits = self._forward(x, self._A.reshape(1, -1, self.in_dim))[2]
        pred = logits.argmax(-1).reshape(-1)
        return (pred == self._Y.reshape(-1)).float().mean()
