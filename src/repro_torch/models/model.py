"""The model (counterpart of src/repro/models/model.py): parameter init,
the training loss, and serving's cache, prefill and decode step, for every
family of the reference: dense, the modality frontends (audio, vlm),
mixture-of-experts (moe), the Mamba1 stack (ssm) and the hybrid (Mamba2
blocks with one shared attention block).

Parameters are a flat dict keyed by the reference's ``/``-joined leaf paths,
with each layer's weights STACKED on a leading (num_layers, ...) axis under
the reference's leaf names (``layers/attn/wq``, ``layers/mlp/w_up``, …).
Every EF leaf's size sets its Block-TopK geometry and its wire, so
per-layer leaves would change the algorithm. gemma2's [local, global]
super-layers read the same stacked leaves: layer 2i is local (the sliding
window), layer 2i+1 global. Training recomputes each block (a super-layer
under ``local_global``) in the backward when ``cfg.remat`` is set
(models/remat.py), as the reference checkpoints each scanned body, and
each cross-entropy chunk too: under ``torch.func`` the f32 logits would
otherwise live until the whole pass returns.

The frontends are STUBS, as in the reference: the batch carries zero
precomputed ``prefix_embeds`` (B, P, d_model) (data/pipeline.py), which
``frontend_proj`` projects and the tokens follow; the loss counts the
token positions only. An MoE block runs models/moe.py in place of the
MLP, its aux values summed over the layers in layer order; an MoE loss
adds 0.01 of the load-balance sum and 0.001 of the router-z sum.

The SSM families (models/ssm.py) stack their mixer blocks under
``layers/mamba/``. The hybrid runs G = num_layers // hybrid_attn_every
groups, each of ``hybrid_attn_every`` Mamba2 blocks followed by THE shared
attention and MLP block (``shared_attn/``, unstacked: one set of
parameters applied G times, so its gradient sums the applications), then
the tail of the remaining Mamba2 blocks. Recompute takes each mamba block
on its own, as the reference checkpoints each mamba body; the shared
block is not recomputed, as in the reference. On a 'model' axis every
family trains over this rank's shards (``tp_plan``). Their cache holds each
layer's ``ssm`` state (f32) and ``conv`` state, and the hybrid's
``k_attn``/``v_attn`` one slot a group. A prefill runs the state over the
whole padded row: ``prompt_lens`` picks the first token's logits, and a
right-padded row's states go on to include its padding, as the
reference's do.

Serving on a 'model' axis (``prefill``/``decode_step`` under ``tp``) runs
the same pass over this rank's shards and cache slice (``init_cache``):
its kv heads where they split, else all of them with the local q heads
reading theirs; its d_inner and SSM heads. Under a split vocabulary the
logits' columns are gathered over the axis. ``split``: the data group the
serving rows are split over, which MoE routes over.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import comm
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import remat as remat_lib
from repro_torch.models import ssm as ssm_lib

CE_CHUNK = 256          # sequence chunk of the cross-entropy
FAMILIES = ("dense", "audio", "vlm", "moe", "ssm", "hybrid")
LB_COEF, Z_COEF = 0.01, 0.001   # an MoE loss's load-balance and z weights
# leaves serving keeps in their own dtype (cast_matrices)
F32_LEAVES = ("norm", "moe/router", "mamba/A_log", "mamba/D",
              "mamba/dt_bias")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"unknown model family {cfg.family!r} "
                                  f"(have {FAMILIES})")


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Random parameters drawn from ``generator`` (a CPU generator, so the
    same seed gives the same numbers on every device), moved to ``device``.
    The reference draws from jax.random, so parity runs load its numbers
    from its checkpoints instead. ``generator=None`` with ``device="meta"``
    gives the tree's shapes and dtypes alone, drawing nothing (a restore
    template)."""
    _check_family(cfg)
    dt = cfg.parameter_dtype
    d, hd, ff, n = cfg.d_model, cfg.head_dim_, cfg.d_ff, cfg.num_layers
    H, KV = cfg.num_heads, cfg.num_kv_heads

    def normal(*shape, std, dtype=dt):
        if generator is None:
            return torch.empty(*shape, dtype=dtype, device="meta")
        return (torch.randn(*shape, generator=generator) * std).to(dtype)

    he, kve = cfg.eff_heads

    def attn(prefix, *lead):
        if (he, kve) == (H, KV):
            return {prefix + "norm": torch.zeros(*lead, d, dtype=dt),
                    prefix + "wk": normal(*lead, d, KV, hd, std=d ** -0.5),
                    prefix + "wo": normal(*lead, H, hd, d,
                                          std=(H * hd) ** -0.5),
                    prefix + "wq": normal(*lead, d, H, hd, std=d ** -0.5),
                    prefix + "wv": normal(*lead, d, KV, hd, std=d ** -0.5)}
        # MHA-expand (the reference's attn_init with h_eff/kv_eff): kv head
        # j // G copied under q head j < H, the padded heads' wk/wv/wo zero
        base_k = normal(*lead, d, KV, hd, std=d ** -0.5)
        wo = normal(*lead, he, hd, d, std=(H * hd) ** -0.5)
        wq = normal(*lead, d, he, hd, std=d ** -0.5)
        base_v = normal(*lead, d, KV, hd, std=d ** -0.5)
        return {prefix + "norm": torch.zeros(*lead, d, dtype=dt),
                prefix + "wk": expand_kv(cfg, base_k),
                prefix + "wo": pad_wo(cfg, wo),
                prefix + "wq": wq,
                prefix + "wv": expand_kv(cfg, base_v)}

    def mlp(prefix, *lead):
        return {prefix + "norm": torch.zeros(*lead, d, dtype=dt),
                prefix + "w_down": normal(*lead, ff, d, std=ff ** -0.5),
                prefix + "w_gate": normal(*lead, d, ff, std=d ** -0.5),
                prefix + "w_up": normal(*lead, d, ff, std=d ** -0.5)}

    def under(prefix, leaves):
        return {prefix + k: t for k, t in leaves.items()}

    params = {"embed": normal(cfg.vocab_size, d, std=d ** -0.5),
              "final_norm": torch.zeros(d, dtype=dt)}
    if cfg.family == "ssm":
        params.update(under("layers/mamba/", ssm_lib.mamba1_init(
            normal, n, d, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
            cfg.ssm_conv, dt)))
    elif cfg.family == "hybrid":
        params.update(under("layers/mamba/", ssm_lib.mamba2_init(
            normal, n, d, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim,
            cfg.ssm_conv, dt)))
        # the ONE shared block, unstacked
        params.update(attn("shared_attn/attn/"))
        params.update(mlp("shared_attn/mlp/"))
    else:
        params.update(attn("layers/attn/", n))
        if cfg.family == "moe":
            params.update(under("layers/moe/", moe_lib.moe_init(
                normal, d, ff, cfg.num_experts, n, dt)))
        else:
            params.update(mlp("layers/mlp/", n))
    if cfg.frontend is not None:
        params["frontend_proj"] = normal(d, d, std=d ** -0.5)
    return {k: params[k].to(device) for k in sorted(params)}


def _pad_mask(cfg: ArchConfig, device) -> torch.Tensor:
    return torch.arange(cfg.eff_heads[0], device=device) < cfg.num_heads


def expand_kv(cfg: ArchConfig, w: torch.Tensor) -> torch.Tensor:
    """(..., d, KV, hd) kv weights MHA-expanded to (..., d, H_eff, hd): q
    head j < H reads kv head j // G (G = H // KV), a padded head zeros."""
    he = cfg.eff_heads[0]
    if w.device.type == "meta":
        return torch.empty(*w.shape[:-2], he, w.shape[-1], dtype=w.dtype,
                           device="meta")
    G = cfg.num_heads // cfg.num_kv_heads
    idx = torch.clamp(torch.arange(he) // G, max=cfg.num_kv_heads - 1)
    return w[..., idx, :] * _pad_mask(cfg, w.device)[:, None].to(w.dtype)


def pad_wo(cfg: ArchConfig, wo: torch.Tensor) -> torch.Tensor:
    """(..., H_eff, hd, d) output rows of the padded heads zeroed."""
    if wo.device.type == "meta":
        return wo
    return wo * _pad_mask(cfg, wo.device)[:, None, None].to(wo.dtype)


Spec = Tuple[Optional[str], ...]


def param_pspecs(cfg: ArchConfig, tp: int = 16) -> Dict[str, Spec]:
    """Each leaf's split over the 'model' axis of ``tp`` ranks, keyed as
    ``init_params``: a tuple with one entry a dim, ``"model"`` on the split
    dim and None elsewhere (the reference's PartitionSpecs, Megatron
    style). q heads, kv heads, d_ff and the vocabulary split where they
    divide ``tp`` (heads after ``tp_pad_heads``); MoE experts where
    ``num_experts`` divides it, else their d_ff; the SSM's d_inner and
    heads. Everything else is replicated."""
    def div(n):
        return n % tp == 0

    def ax(ok):
        return "model" if ok else None

    h_eff, kv_eff = cfg.eff_heads

    def attn(prefix, pre):
        h_ok, kv_ok = div(h_eff), div(kv_eff)
        return {prefix + "wq": (*pre, None, ax(h_ok), None),
                prefix + "wk": (*pre, None, ax(kv_ok), None),
                prefix + "wv": (*pre, None, ax(kv_ok), None),
                prefix + "wo": (*pre, ax(h_ok), None, None),
                prefix + "norm": (*pre, None)}

    def mlp(prefix, pre):
        f = ax(div(cfg.d_ff))
        return {prefix + "w_gate": (*pre, None, f),
                prefix + "w_up": (*pre, None, f),
                prefix + "w_down": (*pre, f, None),
                prefix + "norm": (*pre, None)}

    specs: Dict[str, Spec] = {
        "embed": (ax(div(cfg.vocab_size)), None), "final_norm": (None,)}
    if cfg.family in ("dense", "audio", "vlm", "moe"):
        specs.update(attn("layers/attn/", (None,)))
        if cfg.family == "moe":
            ep = div(cfg.num_experts)
            e = ax(ep)
            f = None if ep else ax(div(cfg.d_ff))
            specs.update({"layers/moe/router": (None, None, None),
                          "layers/moe/w_gate": (None, e, None, f),
                          "layers/moe/w_up": (None, e, None, f),
                          "layers/moe/w_down": (None, e, f, None),
                          "layers/moe/norm": (None, None)})
        else:
            specs.update(mlp("layers/mlp/", (None,)))
    elif cfg.family == "ssm":
        a = ax(div(cfg.d_inner))
        specs.update({"layers/mamba/" + k: v for k, v in {
            "in_proj": (None, None, a), "conv_w": (None, None, a),
            "x_proj": (None, a, None), "dt_proj": (None, None, a),
            "dt_bias": (None, a), "A_log": (None, a, None), "D": (None, a),
            "out_proj": (None, a, None), "norm": (None, None)}.items()})
    elif cfg.family == "hybrid":
        a = ax(div(cfg.d_inner))
        h = ax(div(cfg.d_inner // cfg.ssm_head_dim))
        specs.update({"layers/mamba/" + k: v for k, v in {
            "in_x": (None, None, a), "in_z": (None, None, a),
            "in_B": (None, None, None), "in_C": (None, None, None),
            "in_dt": (None, None, h), "dt_bias": (None, h),
            "conv_w": (None, None, None), "A_log": (None, h), "D": (None, h),
            "out_proj": (None, a, None), "norm": (None, None),
            "out_norm": (None, a)}.items()})
        specs.update(attn("shared_attn/attn/", ()))
        specs.update(mlp("shared_attn/mlp/", ()))
    else:
        _check_family(cfg)
    if cfg.frontend is not None:
        specs["frontend_proj"] = (None, None)
    return dict(sorted(specs.items()))


def tp_plan(cfg: ArchConfig, axes: comm.Axes
            ) -> Optional[L.TensorParallel]:
    """The tensor-parallel pass of ``cfg`` over the 'model' axis ``axes``
    (None on a group of one: the single-device pass itself), split where
    ``param_pspecs`` splits the leaves: the stacked attention and MLP, or
    the hybrid's unstacked shared block (its head dim one earlier), and the
    mamba blocks' d_inner (Mamba2's heads with it). A Mamba2 whose d_inner
    splits and whose heads do not (each rank a part of every head's
    ``head_dim``; no shipped config at 2 or 16 ranks) is refused."""
    if axes.size == 1:
        return None
    specs = param_pspecs(cfg, axes.size)

    def split(name, dim):
        return name in specs and specs[name][dim] == "model"
    pre, d = ("shared_attn/", 1) if cfg.family == "hybrid" else ("layers/", 2)
    tp = L.TensorParallel(
        axes, heads=split(pre + "attn/wq", d), kv=split(pre + "attn/wk", d),
        ff=split(pre + "mlp/w_up", d), vocab=split("embed", 0),
        experts=split("layers/moe/w_up", 1),
        expert_ff=split("layers/moe/w_up", 3),
        d_inner=split("layers/mamba/in_proj", 2)
        or split("layers/mamba/in_x", 2))
    if tp.d_inner and "layers/mamba/in_dt" in specs \
            and not split("layers/mamba/in_dt", 2):
        raise NotImplementedError(
            f"{cfg.name} on a 'model' axis of {axes.size}: d_inner "
            f"{cfg.d_inner} splits and its {cfg.d_inner // cfg.ssm_head_dim}"
            " Mamba2 heads do not (each rank would hold a part of every "
            "head's head_dim); the port splits Mamba2 by whole heads")
    return tp


def cast_matrices(cfg: ArchConfig, params: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """``params`` with every matrix leaf (the embedding, the attention, MLP,
    expert and mamba weights, the frontend's projection) cast to the
    activation dtype; kept: the norm scales (``rms_norm`` reads them in
    f32), the MoE router, which routing multiplies in f32, and a mamba
    block's ``A_log``, ``D`` and ``dt_bias``, which its scan reads in f32
    (a round trip through bf16 would change the served logits). The model
    uses each matrix in the activation dtype, and a cast commutes with the
    embedding's gather and
    with the slice of a stacked leaf, so this tree gives the same numbers
    as ``params`` without a cast a call: serving runs it, cast once per
    params version. A leaf already in that dtype is not copied."""
    act = cfg.activation_dtype
    return {k: t if k.endswith(F32_LEAVES) else t.to(act)
            for k, t in params.items()}


def _vocab_local(tp: L.TensorParallel, ids: torch.Tensor, rows: int):
    """Token ids as rows of this rank's block of the vocabulary (``rows``
    a rank, contiguous), 0 where an id lies in another rank's block, and
    the mask of the ids that lie in this one."""
    t = ids.long() - tp.axes.index * rows
    mine = (t >= 0) & (t < rows)
    return torch.where(mine, t, torch.zeros_like(t)), mine


def _embed(cfg: ArchConfig, params: Dict[str, torch.Tensor],
           tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None,
           tp: Optional[L.TensorParallel] = None
           ) -> Tuple[torch.Tensor, int]:
    """The tokens' embeddings (gemma's scale on them alone), after the
    prefix projected through ``frontend_proj`` in the activation dtype when
    ``prefix_embeds`` (B, P, d) is given; and P, the prefix's length.
    Under ``tp`` with the vocabulary split a rank looks its ids up in its
    rows, zeroes the others, and g sums the ranks' rows: each id's row
    plus zeros, the single-device lookup bit for bit."""
    adt = cfg.activation_dtype
    if tp is not None and tp.vocab:
        rows, mine = _vocab_local(tp, tokens, params["embed"].shape[0])
        e = F.embedding(rows, params["embed"])
        e = torch.where(mine[..., None], e, torch.zeros((), dtype=e.dtype,
                                                        device=e.device))
        h = comm.reduce_from(tp.axes, e).to(adt)
    else:
        h = F.embedding(tokens.long(), params["embed"]).to(adt)
    if cfg.name.startswith("gemma"):
        # sqrt(d_model) rounded to the activation dtype first, as the
        # reference's jnp.asarray(..., adt): 59.75 in bf16 at d 3584
        h = h * torch.full((), cfg.d_model ** 0.5, dtype=adt, device=h.device)
    if prefix_embeds is None:
        return h, 0
    pe = torch.einsum("bpd,de->bpe", prefix_embeds.to(adt),
                      params["frontend_proj"].to(adt))
    return torch.cat([pe, h], dim=1), prefix_embeds.shape[1]


def layer_window(cfg: ArchConfig, i: int) -> Optional[int]:
    """Layer i's sliding window: every layer's under a window, the even
    (local) layers' only under ``local_global``."""
    if cfg.local_global and i % 2:
        return None
    return cfg.sliding_window


def flash_layers(cfg: ArchConfig) -> int:
    """The attention applications whose prefill runs K7
    (``layers.prefill_runs_flash``): K7's launches a prefill. None in the
    attention-free ``ssm`` family; the hybrid's shared block applied G
    times counts G times."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return _hybrid_groups(cfg) * L.prefill_runs_flash(
            cfg.head_dim_, cfg.sliding_window, cfg.logit_softcap)
    return sum(L.prefill_runs_flash(cfg.head_dim_, layer_window(cfg, i),
                                    cfg.logit_softcap)
               for i in range(cfg.num_layers))


def _hybrid_groups(cfg: ArchConfig) -> int:
    """G: the hybrid's groups, each ending in the shared block."""
    return cfg.num_layers // cfg.hybrid_attn_every


def _layer_cache(cfg: ArchConfig, cache: Dict[str, torch.Tensor], i: int):
    if not cfg.local_global:
        return cache["k"][i], cache["v"][i]
    kind = "global" if i % 2 else "local"
    return cache[f"k_{kind}"][i // 2], cache[f"v_{kind}"][i // 2]


def _run_stack(cfg: ArchConfig, params: Dict[str, torch.Tensor],
               h: torch.Tensor, positions: torch.Tensor,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               pos: Optional[int] = None, train: bool = False,
               tp: Optional[L.TensorParallel] = None,
               split: Optional[comm.Axes] = None,
               seq: Optional[comm.Axes] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The layers, one after another, for training (no cache), prefill
    (cache, no ``pos``) and decode (cache and ``pos``); see
    ``layers.attn_apply``. Returns h and the aux values (models/moe.py)
    summed over the layers in layer order, zeros without MoE. The cache is
    written in place. RoPE's cos and sin are gathered once for all layers
    from the cached tables; positions run below S, or up to ``pos`` in
    decode. With ``train`` and ``cfg.remat`` each block (a [local, global]
    pair under ``local_global``) is recomputed in the backward, its aux
    values leaving the block beside h; a recomputed block replays its f/g
    collectives in the backward, every rank in the same order. ``tp``: the
    tensor-parallel pass over this rank's shards; ``split``: a pod
    client's data group, which MoE routes over (models/moe.py); ``seq``:
    the axes a serving cache's sequence is split over (``layers.attn_apply``).
    The SSM families run :func:`_run_ssm_stack`."""
    if cfg.family in ("ssm", "hybrid"):
        h = _run_ssm_stack(cfg, params, h, positions, cache, pos, train, tp,
                           seq)
        return h, {k: torch.zeros((), device=h.device)
                   for k in moe_lib.AUX_KEYS}
    length = h.shape[1] if pos is None else pos + 1
    cos, sin = L.rope_at(positions, cfg.head_dim_, cfg.rope_theta, length)
    # one unbind per stacked leaf: its backward is a single stack
    names = sorted(k[len("layers/"):] for k in params
                   if k.startswith("layers/"))
    per_layer = {n: params["layers/" + n].unbind(0) for n in names}
    moe_fn = None
    if cfg.family == "moe":
        moe_fn = functools.partial(
            moe_lib.moe_apply_dense if cfg.moe_impl == "dense"
            else moe_lib.moe_apply, k=cfg.num_experts_per_tok,
            cf=cfg.moe_capacity_factor, eps=cfg.norm_eps, tp=tp,
            split=split)

    def sub(p, prefix):
        return {n[len(prefix):]: t for n, t in p.items()
                if n.startswith(prefix)}

    def block(first: int, h: torch.Tensor, *flat: torch.Tensor):
        """(h after the group's layers, then each MoE layer's aux values
        in ``AUX_KEYS`` order)."""
        *leaves, cos, sin = flat
        aux = []
        for j in range(len(leaves) // len(names)):
            i = first + j
            p = dict(zip(names, leaves[j * len(names):]))
            h = h + L.attn_apply(
                sub(p, "attn/"), h, (cos, sin), eps=cfg.norm_eps,
                chunk=cfg.attn_chunk, window=layer_window(cfg, i),
                cap=cfg.logit_softcap,
                cache=None if cache is None else _layer_cache(cfg, cache, i),
                pos=pos, tp=tp, seq=seq)
            if moe_fn is None:
                h = h + L.mlp_apply(sub(p, "mlp/"), h, cfg.norm_eps, tp=tp)
            else:
                delta, a = moe_fn(sub(p, "moe/"), h)
                h = h + delta
                aux.extend(a[k] for k in moe_lib.AUX_KEYS)
        return (h, *aux)

    total = {k: torch.zeros((), device=h.device) for k in moe_lib.AUX_KEYS}
    group = 2 if cfg.local_global else 1
    for first in range(0, cfg.num_layers, group):
        leaves = [per_layer[n][i] for i in range(first, first + group)
                  for n in names]
        fn = functools.partial(block, first)
        if train and cfg.remat:
            h, *aux = remat_lib.checkpoint(fn, (h, *leaves), (cos, sin))
        else:
            h, *aux = fn(h, *leaves, cos, sin)
        for j, a in enumerate(aux):
            key = moe_lib.AUX_KEYS[j % len(moe_lib.AUX_KEYS)]
            total[key] = total[key] + a
    return h, total


def _store(cache: Dict[str, torch.Tensor], key: str, i: int,
           state: torch.Tensor) -> None:
    """Write layer i's new state into ``cache[key]`` in place. A state of
    a wider dtype than the cache's (f32 activations on a bf16 conv cache:
    the reference's concatenation promotes the state) first widens the
    cache entry, once, so that the state is carried as the reference
    carries it."""
    dt = torch.promote_types(cache[key].dtype, state.dtype)
    if cache[key].dtype != dt:
        cache[key] = cache[key].to(dt)
    cache[key][i].copy_(state)


def _run_ssm_stack(cfg: ArchConfig, params: Dict[str, torch.Tensor],
                   h: torch.Tensor, positions: torch.Tensor,
                   cache: Optional[Dict[str, torch.Tensor]],
                   pos: Optional[int], train: bool,
                   tp: Optional[L.TensorParallel] = None,
                   seq: Optional[comm.Axes] = None) -> torch.Tensor:
    """The ``ssm`` stack (one Mamba1 block a layer) or the ``hybrid`` one
    (G groups of ``hybrid_attn_every`` Mamba2 blocks, each group followed
    by the shared attention and MLP block, with the group's slot of
    ``k_attn``/``v_attn``; then the tail of Mamba2 blocks). A block with a
    cache starts from its layer's states and writes the new ones back in
    place (prefill: S > 1 from the cache's states; decode: S = 1). With
    ``train`` and ``cfg.remat`` each mamba block is recomputed in the
    backward, replaying its collectives there. ``tp``: every block, the
    shared one too, runs over this rank's shards; ``seq``: the axes the
    shared block's cache sequence is split over."""
    apply = functools.partial(
        ssm_lib.mamba1_apply if cfg.ssm_variant == "mamba1"
        else ssm_lib.mamba2_apply, tp=tp)
    prefix = "layers/mamba/"
    names = sorted(k[len(prefix):] for k in params if k.startswith(prefix))
    per_layer = {n: params[prefix + n].unbind(0) for n in names}

    def block(h: torch.Tensor, *leaves: torch.Tensor) -> torch.Tensor:
        return h + apply(dict(zip(names, leaves)), h, cfg)[0]

    def mamba(i: int, h: torch.Tensor) -> torch.Tensor:
        leaves = [per_layer[n][i] for n in names]
        if cache is None:
            if train and cfg.remat:
                return remat_lib.checkpoint(block, (h, *leaves))
            return block(h, *leaves)
        delta, (ssm, conv) = apply(
            dict(zip(names, leaves)), h, cfg, ssm_state=cache["ssm"][i],
            conv_state=cache["conv"][i])
        _store(cache, "ssm", i, ssm)
        _store(cache, "conv", i, conv)
        return h + delta

    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            h = mamba(i, h)
        return h
    k, G = cfg.hybrid_attn_every, _hybrid_groups(cfg)
    length = h.shape[1] if pos is None else pos + 1
    rope_cs = L.rope_at(positions, cfg.head_dim_, cfg.rope_theta, length)

    def shared(part):
        return {n[len(part):]: t for n, t in params.items()
                if n.startswith(part)}
    attn, mlp = shared("shared_attn/attn/"), shared("shared_attn/mlp/")
    for g in range(G):
        for i in range(g * k, (g + 1) * k):
            h = mamba(i, h)
        h = h + L.attn_apply(
            attn, h, rope_cs, eps=cfg.norm_eps, chunk=cfg.attn_chunk,
            window=cfg.sliding_window, cap=cfg.logit_softcap,
            cache=None if cache is None else
            (cache["k_attn"][g], cache["v_attn"][g]), pos=pos, tp=tp,
            seq=seq)
        h = h + L.mlp_apply(mlp, h, cfg.norm_eps, tp=tp)
    for i in range(G * k, cfg.num_layers):
        h = mamba(i, h)
    return h


def _logits(cfg: ArchConfig, embed: torch.Tensor, h: torch.Tensor
            ) -> torch.Tensor:
    """f32 logits through the tied embedding, already cast to h's dtype,
    soft-capped by ``cfg.final_softcap``."""
    lg = torch.einsum("bsd,vd->bsv", h, embed).float()
    return L.softcap(lg, cfg.final_softcap)


def _serve_logits(cfg: ArchConfig, embed: torch.Tensor, h: torch.Tensor,
                  tp: Optional[L.TensorParallel] = None) -> torch.Tensor:
    """Serving's f32 logits (:func:`_logits`); under ``tp`` with the
    vocabulary split each rank's columns are gathered over the axis in
    vocabulary order, so every rank holds the whole row and its argmax is
    the single-device one, the earliest index winning a tie."""
    lg = _logits(cfg, embed, h)
    if tp is not None and tp.vocab:
        lg = comm.gather_last(tp.axes, lg)
    return lg


def train_loss(cfg: ArchConfig, params: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor],
               tp: Optional[L.TensorParallel] = None,
               split: Optional[comm.Axes] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean next-token cross-entropy over the token positions, plus the
    MoE aux losses under MoE; the aux values summed over the layers).
    batch: tokens (B,S), labels (B,S), optional prefix_embeds (B,P,d).
    ``tp`` (``tp_plan``): the tensor-parallel pass, ``params`` this rank's
    shards (``param_pspecs``); the loss and aux come out whole on every
    rank of the 'model' axis. ``split``: a pod client's data group
    (``comm.Axes``), the batch this rank's contiguous block of the
    client's rows; the loss and the aux values come out as this rank's
    additive shares of the client's (the cross-entropy summed over its
    rows and divided by the client's token count; MoE routed over the
    client's tokens, models/moe.py), which the group sums."""
    tokens, labels = batch["tokens"], batch["labels"].long()
    B, S = tokens.shape
    h, n_prefix = _embed(cfg, params, tokens, batch.get("prefix_embeds"),
                         tp=tp)
    T = h.shape[1]
    positions = torch.arange(T, device=h.device)[None].expand(B, T)
    h, aux = _run_stack(cfg, params, h, positions, train=True, tp=tp,
                        split=split)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)[:, n_prefix:]

    # chunked cross-entropy: never materialize (B, S, V) in full; under
    # recompute a chunk's f32 logits live only in its forward and backward
    def ce_sum(embed, hc, lc):
        lg = _logits(cfg, embed, hc)
        gold = torch.gather(lg, -1, lc[..., None])[..., 0]
        return (torch.logsumexp(lg, dim=-1) - gold).sum()

    # the vocabulary split: this rank's columns of the (soft-capped)
    # logits; their max, the sum of exponentials and the gold logit
    # reduced over the axis
    def ce_split(embed, hc, lc):
        lg = _logits(cfg, embed, comm.copy_to(tp.axes, hc))
        m = comm.max_from(tp.axes, lg.max(-1).values)
        se = comm.reduce_from(tp.axes, torch.exp(lg - m[..., None]).sum(-1))
        rows, mine = _vocab_local(tp, lc, embed.shape[0])
        gold = torch.gather(lg, -1, rows[..., None])[..., 0]
        gold = comm.reduce_from(tp.axes, torch.where(
            mine, gold, torch.zeros((), dtype=gold.dtype,
                                    device=gold.device)))
        return (m + torch.log(se) - gold).sum()

    ce = ce_split if tp is not None and tp.vocab else ce_sum
    embed = params["embed"].to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, S, CE_CHUNK):
        hc = h[:, start:start + CE_CHUNK]
        lc = labels[:, start:start + CE_CHUNK]
        if cfg.remat:
            total = total + remat_lib.checkpoint(ce, (embed, hc), (lc,))
        else:
            total = total + ce(embed, hc, lc)
    loss = total / (B * S * (1 if split is None else split.size))
    if cfg.family == "moe":
        loss = loss + LB_COEF * aux["load_balance"] + \
            Z_COEF * aux["router_z"]
    return loss, aux


def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device="cpu",
               tp: Optional[L.TensorParallel] = None,
               seq: Optional[comm.Axes] = None
               ) -> Dict[str, torch.Tensor]:
    """Zero cache, bfloat16 by default as in the reference. The attention
    families: k and v (L, B, S, KV, hd), S = min(max_seq, window) under a
    sliding window; under ``local_global`` the local layers' ring
    (k_local, v_local: L/2 x min(max_seq, window) slots) and the global
    layers' full cache (k_global, v_global: L/2 x max_seq). ``ssm``: the
    f32 scan state (L, B, d_inner, N) and the conv state (L, B, k-1,
    d_inner); ``hybrid``: the f32 state (L, B, heads, head_dim, N), the
    conv state (L, B, k-1, d_inner + 2N), and the shared block's k_attn
    and v_attn (G, B, S, KV, hd), a slot a group. Separate tensors, since
    the port writes them in place.

    Under ``tp`` (``tp_plan``) the cache is this rank's slice of the
    'model' axis, as the tensor-parallel pass reads it: KV its kv heads
    where ``tp.kv`` splits them (else every kv head), d_inner and the
    Mamba2 heads its block where ``tp.d_inner`` splits them; a hybrid
    conv state holds this rank's d_inner columns, then the 2N columns of
    B and C whole (the order ``ssm.mamba2_apply`` splits it in).
    ``batch_size`` is the rows this rank serves (launch/shardings.py
    ``serve_rows``). ``seq``: the axes the attention caches' sequence is
    split over (``shardings.seq_axes``): each holds this rank's block of
    its slots (``layers.slot_range``), a ring's and a global cache's
    alike."""
    _check_family(cfg)
    n_tp = 1 if tp is None else tp.axes.size
    KV, hd = cfg.num_kv_heads, cfg.head_dim_
    if tp is not None and tp.kv:
        KV //= n_tp
    di_split = n_tp if tp is not None and tp.d_inner else 1
    ring = min(max_seq, cfg.sliding_window) if cfg.sliding_window \
        else max_seq

    def zeros(n, S):
        lo, hi = L.slot_range(S, seq)
        return torch.zeros((n, batch_size, hi - lo, KV, hd), dtype=dtype,
                           device=device)
    if cfg.family in ("ssm", "hybrid"):
        n, Di, N = cfg.num_layers, cfg.d_inner // di_split, cfg.ssm_state
        if cfg.family == "ssm":
            ssm, width = (n, batch_size, Di, N), Di
        else:
            P = cfg.ssm_head_dim
            ssm, width = (n, batch_size, Di // P, P, N), Di + 2 * N
        cache = {
            "ssm": torch.zeros(ssm, dtype=torch.float32, device=device),
            "conv": torch.zeros((n, batch_size, cfg.ssm_conv - 1, width),
                                dtype=dtype, device=device)}
        if cfg.family == "hybrid":
            G = _hybrid_groups(cfg)
            cache.update(k_attn=zeros(G, ring), v_attn=zeros(G, ring))
        return cache
    if cfg.local_global:
        n2 = cfg.num_layers // 2
        return {"k_local": zeros(n2, ring), "v_local": zeros(n2, ring),
                "k_global": zeros(n2, max_seq),
                "v_global": zeros(n2, max_seq)}
    return {"k": zeros(cfg.num_layers, ring),
            "v": zeros(cfg.num_layers, ring)}


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], cache: Dict[str, torch.Tensor],
            tp: Optional[L.TensorParallel] = None,
            split: Optional[comm.Axes] = None,
            seq: Optional[comm.Axes] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the whole prompt; returns (last-token logits (B,1,V) f32,
    the cache with slots [0, S) filled, or a ring with the last positions
    under a window).

    ``batch["prefix_embeds"]`` (optional, (B, P, d)) goes before the tokens
    and fills the cache's first P slots. ``batch["prompt_lens"]``
    (optional, (B,) true lengths) takes each row's logits at its last REAL
    token, ``P + len - 1``, instead of the rightmost column: right padding
    (id 0, a legal token) never reaches the first generated token, since
    causal attention keeps that position blind to the padding after it.

    ``tp``: the tensor-parallel pass over this rank's shards and cache
    slice (:func:`init_cache`); the logits come out whole on every rank.
    ``split``: the data group the batch's rows are split over, the batch
    this rank's contiguous block of them; MoE routes over the whole
    call's tokens (models/moe.py). ``seq``: the axes the cache's sequence
    is split over (:func:`init_cache`); each rank stores its slots."""
    h, n_prefix = _embed(cfg, params, batch["tokens"],
                         batch.get("prefix_embeds"), tp=tp)
    B, T = h.shape[:2]
    positions = torch.arange(T, device=h.device)[None].expand(B, T)
    h, _ = _run_stack(cfg, params, h, positions, cache=cache, tp=tp,
                      split=split, seq=seq)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    lens = batch.get("prompt_lens")
    if lens is None:
        h_last = h[:, -1:]
    else:
        idx = n_prefix + lens.to(device=h.device, dtype=torch.long) - 1
        h_last = h[torch.arange(B, device=h.device), idx][:, None]
    return _serve_logits(cfg, params["embed"].to(h.dtype), h_last,
                         tp), cache


def _decode_stack(cfg: ArchConfig, params: Dict[str, torch.Tensor],
                  h: torch.Tensor, pos: int, cache: Dict[str, torch.Tensor],
                  tp: Optional[L.TensorParallel] = None,
                  split: Optional[comm.Axes] = None,
                  seq: Optional[comm.Axes] = None) -> torch.Tensor:
    positions = torch.full((h.shape[0], 1), pos, device=h.device)
    return _run_stack(cfg, params, h, positions, cache=cache, pos=pos,
                      tp=tp, split=split, seq=seq)[0]


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int, tp: Optional[L.TensorParallel] = None,
                split: Optional[comm.Axes] = None,
                seq: Optional[comm.Axes] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. tokens: (B,1); pos: the tokens' absolute position.
    Returns (logits (B,1,V) f32, the cache with slot ``pos`` written).
    ``tp``, ``split`` and ``seq`` as in :func:`prefill` (MoE's capacity
    from the step's B tokens over the data group)."""
    h, _ = _embed(cfg, params, tokens, tp=tp)
    h = _decode_stack(cfg, params, h, pos, cache, tp, split, seq)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _serve_logits(cfg, params["embed"].to(h.dtype), h, tp), cache
