"""The randomized compressors and the paired and R-round methods of the
port, on the CPU.

Random streams do not port (the reference's threefry keys are not
reproduced), so RandK and natural compression are held statistically: RandK
keeps exactly K distinct coordinates; scaled RandK and natural compression
are unbiased within 4 standard errors over 4000 draws; natural
compression's outputs are signed powers of two bracketing |x| with
E‖C(x) − x‖² ≤ ‖x‖²/8. Their α, coordinate counts and flags equal the
reference's exactly. A stream is a pure function of (seed, step): a run
resumed from a checkpoint replays the uninterrupted run bit for bit. The
ideal method, STORM and NEOLITHIC, on paired numpy inputs with
deterministic compressors, match the reference's ``update`` within rtol
1e-6, for one client and for client-stacked trees.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jax_comp
from repro.core import ef as jax_ef
from repro_torch.core import compressors as pt_comp
from repro_torch.core import distributed as pt_dist
from repro_torch.core import ef as pt_ef
from repro_torch.core import rng as pt_rng
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DRAWS = 4000


def _x(d, seed=0):
    rs = np.random.RandomState(seed)
    return torch.tensor(rs.randn(d).astype(np.float32) * 3.0)


@pytest.mark.parametrize("d,kw", [(37, {"k": 5}), (64, {"ratio": 0.1}),
                                  (10, {"k": 10})])
def test_randk_keeps_exactly_k_distinct_coordinates(d, kw):
    c = pt_comp.RandK(**kw)
    k = c._k(d)
    x = _x(d)
    gen = torch.Generator().manual_seed(3)
    out = c(x, gen)
    assert int((out != 0).sum()) == k
    kept = out != 0
    assert torch.equal(out[kept], x[kept])
    vals, idx = c.sparse(x, torch.Generator().manual_seed(4))
    assert idx.dtype == torch.int32 and len(set(idx.tolist())) == k
    assert torch.equal(vals, x[idx.long()])
    rows = c.batched(x.expand(16, d).contiguous(), gen)
    assert torch.equal((rows != 0).sum(1), torch.full((16,), k))
    if k < d:                         # the rows draw their own coordinates
        assert len({tuple(r.nonzero().flatten().tolist())
                    for r in rows}) > 1


def _unbiased(comp, x):
    gen = torch.Generator().manual_seed(11)
    draws = comp.batched(x.expand(DRAWS, -1).contiguous(), gen).double()
    mean = draws.mean(0)
    se = draws.std(0) / DRAWS ** 0.5
    err = (mean - x.double()).abs()
    assert bool((err <= 4 * se + 1e-6).all()), float((err / (se + 1e-12)).max())
    return draws


def test_scaled_randk_is_unbiased():
    x = _x(24, seed=1)
    c = pt_comp.RandK(k=6, scaled=True)
    draws = _unbiased(c, x)
    kept = draws != 0
    np.testing.assert_allclose(draws[kept].numpy(),
                               (x.double().expand(DRAWS, -1)[kept] * 4.0)
                               .numpy(), rtol=1e-6)


def test_natural_compression_is_unbiased_powers_of_two():
    x = _x(30, seed=2)
    x[3] = 0.0
    x[4] = 1.0                                          # a power of two
    c = pt_comp.NaturalCompression()
    draws = _unbiased(c, x)
    ax = x.abs().double()
    lo = torch.where(ax > 0, torch.exp2(torch.floor(torch.log2(ax))), 0 * ax)
    mag = draws.abs()
    assert bool(((mag == lo) | (mag == 2 * lo)).all())
    nz = x != 0
    assert bool((torch.sign(draws[:, nz]) == torch.sign(x[nz]).double()).all())
    assert bool((draws[:, ~nz] == 0).all())
    assert bool((draws[:, 4] == 1.0).all())
    err = ((draws - x.double()) ** 2).sum(1).mean()
    assert float(err) <= float((x.double() ** 2).sum()) / 8


def test_the_rng_compressors_need_a_generator():
    for c in (pt_comp.RandK(k=2), pt_comp.NaturalCompression()):
        with pytest.raises(ValueError, match="torch.Generator"):
            c(_x(8))


@pytest.mark.parametrize("d", [1, 7, 100, 4096])
def test_alpha_coords_and_flags_match_reference(d):
    pairs = [(jax_comp.RandK(k=3), pt_comp.RandK(k=3)),
             (jax_comp.RandK(ratio=0.05), pt_comp.RandK(ratio=0.05)),
             (jax_comp.RandK(ratio=0.2, scaled=True),
              pt_comp.RandK(ratio=0.2, scaled=True)),
             (jax_comp.NaturalCompression(), pt_comp.NaturalCompression())]
    for jc, pc in pairs:
        assert pc.alpha(d) == jc.alpha(d)
        for prop in ("is_contractive", "has_sparse_carrier", "needs_rng"):
            assert getattr(pc, prop) == getattr(jc, prop), prop
        jm, pm = jax_ef.EF21SGDM(compressor=jc), pt_ef.EF21SGDM(compressor=pc)
        assert pm.coords_per_message(d) == jm.coords_per_message(d)
        for car in ("dense", "sparse", "quant8", "fused_quant4"):
            for direction in ("up", "down"):
                _same(lambda m: m.coords_per_message(
                    d, carrier=car, direction=direction), jm, pm)


def _same(fn, jm, pm):
    """fn on both methods: equal values, or a ValueError from both (the
    sparse wire has no geometry for RandK in either package)."""
    try:
        want = fn(jm)
    except ValueError:
        with pytest.raises(ValueError):
            fn(pm)
        return
    assert fn(pm) == want


def test_neolithic_counts_r_messages_up_and_one_down():
    for d in (10, 1000):
        for car in (None, "dense", "sparse"):
            j = jax_ef.Neolithic(compressor=jax_comp.TopK(k=4), rounds=3)
            p = pt_ef.Neolithic(compressor=pt_comp.TopK(k=4), rounds=3)
            assert p.coords_per_message(d, carrier=car) == \
                j.coords_per_message(d, carrier=car)
            assert p.coords_per_message(d, carrier=car or "dense",
                                        direction="down") == \
                j.coords_per_message(d, carrier=car or "dense",
                                     direction="down")


# ---------------------------------------------------------------------------
# streams: pure in (seed, step)
# ---------------------------------------------------------------------------

def test_streams_are_pure_and_distinct():
    a = pt_rng.round_generator(5, 17)
    b = pt_rng.fold_in(pt_rng.generator(5), 17)
    assert torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))
    seeds = {pt_rng.derive(5, s) for s in range(1000)}
    assert len(seeds) == 1000 and max(seeds) < 2 ** 63
    assert pt_rng.fold_in(None, 3) is None
    g = pt_rng.generator(1)
    before = g.get_state()
    pt_rng.fold_in(g, 2)
    assert torch.equal(g.get_state(), before)       # folding draws nothing


def test_ef_round_with_randk_replays_its_round():
    efc = pt_dist.EFConfig(method=pt_ef.EF21SGDM(
        compressor=pt_comp.RandK(k=3)), down_carrier="sparse",
        down_compressor=pt_comp.TopK(k=2))
    rs = np.random.RandomState(0)
    grads = {"a": torch.tensor(rs.randn(4, 5, 3).astype(np.float32)),
             "b": torch.tensor(rs.randn(4, 7).astype(np.float32))}
    params = {k: v[0] for k, v in grads.items()}
    outs = []
    for _ in range(2):
        st = pt_dist.init_ef_state(efc, params, 4, init_grads={
            k: v.clone() for k, v in grads.items()})
        outs.append(pt_dist.ef_round(
            efc, {k: v * 2 for k, v in grads.items()}, st,
            rng=pt_rng.round_generator(9, 3)))
    for k in grads:
        assert torch.equal(outs[0][0][k], outs[1][0][k])
        assert torch.equal(outs[0][1]["clients"]["g"][k],
                           outs[1][1]["clients"]["g"][k])
    other = pt_dist.ef_round(efc, {k: v * 2 for k, v in grads.items()},
                             pt_dist.init_ef_state(efc, params, 4, init_grads={
                                 k: v.clone() for k, v in grads.items()}),
                             rng=pt_rng.round_generator(9, 4))
    assert any(not torch.equal(other[0][k], outs[0][0][k]) for k in grads)


def test_a_resumed_randk_run_replays_the_uninterrupted_one(tmp_path):
    with open(os.path.join(ROOT, "results", "specs",
                           "fused_quickstart.json")) as f:
        d = dict(json.load(f), smoke=True, seq_len=32, global_batch=8,
                 clients=4, carrier="dense", downlink_carrier="dense",
                 compressor="randk", compressor_kw={"ratio": 0.05},
                 ckpt_dir=str(tmp_path))
    spec = pt_spec.RunSpec.from_dict(d)
    whole = pt_session.Session(pt_spec.RunSpec.from_dict(
        dict(d, ckpt_dir=None)), device="cpu", dtype="float32")
    want = whole.train(3, log_every=1)
    first = pt_session.Session(spec, device="cpu", dtype="float32")
    first.train(2, log_every=1)
    resumed = pt_session.Session.resume(str(tmp_path), device="cpu",
                                        dtype="float32")
    assert resumed.step == 2
    got = resumed.train(3, log_every=1)
    assert got[-1] == want[-1]
    for k, v in whole.params.items():
        assert torch.equal(resumed.params[k], v), k


# ---------------------------------------------------------------------------
# paired and R-round methods against the reference's update
# ---------------------------------------------------------------------------

def _tree(rs, lead=()):
    return {"a": rs.randn(*lead, 3, 5).astype(np.float32),
            "b": rs.randn(*lead, 11).astype(np.float32)}


def _pt(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _jx(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, what):
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(
            got[k].numpy(), w, rtol=1e-6,
            atol=4 * np.spacing(np.float32(np.abs(w).max())),
            err_msg=f"{what}/{k}")


METHODS = [
    pytest.param("ef21_sgdm_ideal", {"eta": 0.7}, id="ideal"),
    pytest.param("ef21_storm", {"eta": 0.3}, id="storm"),
    pytest.param("neolithic", {"rounds": 3}, id="neolithic"),
]
COMPS = [pytest.param("topk", {"k": 3}, id="topk"),
         pytest.param("block_topk", {"block": 4, "k_per_block": 1},
                      id="block_topk"),
         pytest.param("identity", {}, id="identity")]


@pytest.mark.parametrize("cname,ckw", COMPS)
@pytest.mark.parametrize("mname,mkw", METHODS)
def test_paired_and_r_round_updates_match_reference(mname, mkw, cname, ckw):
    rs = np.random.RandomState(7)
    jm = jax_ef.REGISTRY[mname](compressor=jax_comp.REGISTRY[cname](**ckw),
                                **mkw)
    pm = pt_ef.REGISTRY[mname](compressor=pt_comp.REGISTRY[cname](**ckw),
                               **mkw)
    assert (pm.mode, pm.needs_paired_grads, pm.wire_is_msg) == \
        (jm.mode, jm.needs_paired_grads, jm.wire_is_msg)
    g1, g2, g0 = _tree(rs), _tree(rs), _tree(rs)
    grads = (g1, g2) if pm.needs_paired_grads else g1
    jst = jm.init(_jx(g0), init_grads=_jx(g0))
    pst = pm.init(_pt(g0), init_grads=_pt(g0))
    jg = tuple(_jx(g) for g in grads) if pm.needs_paired_grads else _jx(grads)
    pg = tuple(_pt(g) for g in grads) if pm.needs_paired_grads else _pt(grads)
    jmsg, jnew = jm.update(jg, jst, None)
    pmsg, pnew = pm.update(pg, pst)
    _close(pmsg, jmsg, f"{mname} msg")
    assert sorted(pnew) == sorted(jnew)
    for name in jnew:
        _close(pnew[name], jnew[name], f"{mname} state {name}")
    # the client-stacked step: each row as the one-client step
    n = 3
    stack = [_tree(rs, (n,)) for _ in range(2)]
    sgrads = (_pt(stack[0]), _pt(stack[1])) if pm.needs_paired_grads \
        else _pt(stack[0])
    sst = pm.init(_pt(stack[1]), init_grads=_pt(stack[1]))
    bmsg, bnew = pm.update(sgrads, sst, batched=True)
    for i in range(n):
        row = (tuple({k: v[i] for k, v in g.items()} for g in sgrads)
               if pm.needs_paired_grads else
               {k: v[i] for k, v in sgrads.items()})
        rst = {name: {k: v[i] for k, v in t.items()}
               for name, t in pm.init(_pt(stack[1]),
                                      init_grads=_pt(stack[1])).items()}
        msg, new = pm.update(row, rst)
        for k in msg:
            assert torch.equal(bmsg[k][i], msg[k]), (mname, k, i)
        for name in new:
            for k in new[name]:
                assert torch.equal(bnew[name][k][i], new[name][k])


def test_all_ten_methods_and_eight_compressors_are_registered():
    assert set(pt_ef.REGISTRY) == set(jax_ef.REGISTRY)
    assert set(pt_comp.REGISTRY) == set(jax_comp.REGISTRY)
    for name in jax_ef.REGISTRY:
        assert pt_ef.make(name).name == jax_ef.make(name).name
    assert isinstance(pt_comp.make("natural"), pt_comp.NaturalCompression)


@pytest.mark.parametrize("carrier", ["dense", "sparse", "fused", "quant8",
                                     "quant4", "fused_quant8",
                                     "fused_quant4"])
def test_rng_compressors_degrade_as_the_reference(carrier):
    """No wire ships a randomized compressor: every carrier's plan and its
    reason equal the reference's, and the spec's name-level preview names
    the same plan."""
    from repro.core import carriers as jax_car
    from repro_torch.core import carriers as pt_car
    from repro_torch.launch.spec import downlink_plan_preview, plan_preview
    jcar, pcar = jax_car.make(carrier), pt_car.make(carrier)
    for name, kw in (("randk", {"k": 3}), ("natural", {})):
        jc, pc = jax_comp.make(name, **kw), pt_comp.make(name, **kw)
        for mname in ("ef21_sgdm", "ef21_sgd", "ef14_sgd", "ef21_storm"):
            jm = jax_ef.make(mname, compressor=jc)
            pm = pt_ef.make(mname, compressor=pc)
            assert pcar.plan_with_reason(pm) == jcar.plan_with_reason(jm)
            assert plan_preview(mname, name, carrier)[0] == pcar.plan(pm)
        assert pcar.plan_down_with_reason(pc) == \
            jcar.plan_down_with_reason(jc)
        if carrier != "fused":
            assert downlink_plan_preview(name, carrier)[0] == \
                pcar.plan_down(pc)
