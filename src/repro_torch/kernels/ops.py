"""Wrappers of the hand kernels (counterpart of src/repro/kernels/ops.py).

Every wrapper takes the layout its kernel takes (any shape for K1, the row
view for K2-K6, (B, S, heads, hd) for K7), checks device, dtype, shape and
contiguity, and raises on anything else. Tensors on the CPU run the plain
PyTorch version (kernels/ref.py); tensors on a CUDA device launch the
kernel on the current stream and raise if the launch fails. There is no
fallback from one to the other.

A traced call (launch/trace_analysis.py: any input a ``FakeTensor`` or on
the meta device) takes the card's path up to the launch: the same checks,
the same outputs allocated (``torch.empty`` of the kernel's shapes), the
call counted in ``traced_launches``, and nothing launched or computed. No
real tensor ever takes it, and the plain versions never run in a trace
(their temporaries are not the card's).

``launches`` counts kernel launches per wrapper, on the card alone (plain
runs and traced calls do not count), so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref

launches: Dict[str, int] = {"block_topk": 0, "ef21_sgdm_update": 0,
                            "ef21_sgdm_topk_quant": 0, "dequant_add": 0,
                            "block_quantize": 0, "block_dequantize": 0,
                            "flash_attention": 0}

# the calls that took the traced branch (fake or meta inputs, nothing
# launched), by the same names
traced_launches: Dict[str, int] = dict.fromkeys(launches, 0)

# the dot FLOPs of the traced K7 launches (QK^T and P.V over the causal
# pairs), which a FLOP counter cannot see in a launch that runs nothing
traced_flops: Dict[str, int] = {"flash_attention": 0}

_lib_handle: Optional[ctypes.CDLL] = None

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "ef_launch_block_topk": [_P, _P, _L, _I, _I, _I, _P],
    "ef_launch_ef21_sgdm_update":
        [_P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _I, _I, _P],
    "ef_launch_ef21_sgdm_topk_quant":
        [_P, _P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _I, _I, _I, _P],
    "ef_launch_dequant_add": [_P, _P, _P, _P, _L, _L, _I, _I, _F, _I, _P],
    "ef_launch_block_quantize": [_P, _P, _P, _L, _I, _I, _P],
    "ef_launch_block_dequantize": [_P, _P, _P, _L, _I, _I, _P],
    "ef_codec_mapping": [_P, _P, _I],
    "ef_rows_layout": [_P, _P, _P, _P, _P, _P, _I],
    "ef_topk_layout": [_L],
    "ef_staged_update_occupancy": [_I, _I, _P],
    "ef_flash_f32_occupancy": [_I, _I, _P, _P],
    "ef_launch_flash_attention":
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
}
# the EF state dtypes K2/K3 are compiled for (grad is always f32)
STATE_DTYPES = (torch.float32, torch.bfloat16)
# the dtypes K1 is compiled for, by their code in the C interface
_TOPK_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# head dims K7 is compiled for
FLASH_HEAD_DIMS = (32, 64, 128)
# wide codec rows take one CTA a row: gridDim.x caps the rows of one launch
_MAX_ROWS = 2 ** 31 - 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def reset_traced() -> None:
    for name in traced_launches:
        traced_launches[name] = 0
    for name in traced_flops:
        traced_flops[name] = 0


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels import build
        lib = ctypes.CDLL(str(build.build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def _route(*tensors: torch.Tensor) -> str:
    """Where a wrapper's call goes: ``traced`` when a tensor is a
    ``FakeTensor`` or on the meta device (the call is being traced, not
    run), else ``card`` when every tensor is on one CUDA device and
    ``plain`` when every tensor is on the CPU; anything else raises."""
    from torch._subclasses.fake_tensor import FakeTensor
    if any(isinstance(t, FakeTensor) or t.device.type == "meta"
           for t in tensors):
        return "traced"
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {kind!r}")
    return "card" if kind == "cuda" else "plain"


def _launch(route: str, name: str, fn: str, *args) -> None:
    """On the ``card`` route, launch the library's ``fn`` on ``args``
    (tensors passed by their data pointers) and count it in
    ``launches[name]``; on the ``traced`` route launch nothing and count
    the call in ``traced_launches[name]``."""
    if route == "traced":
        traced_launches[name] += 1
        return
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # the current stream's handle, read without building a Stream object
    # (torch.cuda.current_stream() costs some 5 us a call, as much as a
    # narrow codec launch's kernel time)
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    rc = getattr(_lib(), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")
    launches[name] += 1


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def momentum_coeffs(eta: float) -> Tuple[float, float]:
    """The f32 constants (1-η, η) every momentum update multiplies by — the
    kernels' and the EF methods' alike."""
    return ref._coeffs(eta)


def _check_bits(bits: int) -> None:
    if bits not in (8, 4):
        raise ValueError(f"bits={bits}; the wire has 8- and 4-bit mantissas")


def _codec_layout(bits: int, cols: int) -> Tuple[torch.dtype, int]:
    """(dtype, columns) of the mantissas of a row of ``cols`` values: int8
    at 8 bits, packed uint4 pairs at 4 (an odd row padded by one)."""
    return (torch.int8, cols) if bits == 8 else (torch.uint8, (cols + 1) // 2)


def codec_mapping(src: torch.Tensor, dst: torch.Tensor, cols: int) -> str:
    """The mapping ``vector``, ``scalar`` or ``wide`` that the card's K5
    (``src`` x, ``dst`` q) or K6 (``src`` q, ``dst`` its output) runs rows
    of ``cols`` values on: the launcher's own rule (csrc/codec.cu), asked
    of the built library."""
    code = _lib().ef_codec_mapping(src.data_ptr(), dst.data_ptr(), cols)
    return ("vector", "scalar", "wide")[code]


def ef_layout(grad: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
              v_out: torch.Tensor, g_out: torch.Tensor,
              third: torch.Tensor) -> str:
    """The layout that the card's K2 (``third`` its c) or K3 (``third`` its
    mantissas) runs rows of these tensors on: for rows up to 1024,
    ``staged`` for widths that are a multiple of 8 with every base on a
    16-byte boundary (csrc/staged.cuh), else ``strided``; wider rows take
    the wide route (csrc/wide.cuh), ``wide_shared`` with the row kept in
    shared memory (up to 28,672 values) and ``wide_global`` beyond. The
    launchers' own rule, asked of the built library; it needs the card."""
    ptrs = [t.data_ptr() for t in (grad, v, g, v_out, g_out, third)]
    code = _lib().ef_rows_layout(*ptrs, grad.shape[1])
    return ("strided", "staged", "wide_shared", "wide_global")[code]


def topk_layout(block: int) -> str:
    """The route of the card's K1 for rows of ``block``: ``lanes`` (a lane
    group or a warp a row, up to 1024), ``wide_shared`` (a CTA a
    row kept in shared memory, up to 57,344 values) or ``wide_global``. The
    launcher's own rule, asked of the built library; it needs the card."""
    return ("lanes", "wide_shared", "wide_global")[
        _lib().ef_topk_layout(block)]


def staged_occupancy(width: int, bf16: bool) -> Tuple[int, int]:
    """(resident CTAs an SM, dynamic shared memory bytes a CTA) of the
    card's K2 launch on the staged layout for rows of ``width`` with f32 or
    bf16 state, asked of the built library; it needs the card."""
    smem = ctypes.c_int(0)
    ctas = _lib().ef_staged_update_occupancy(width, int(bf16),
                                             ctypes.byref(smem))
    if ctas < 0:
        raise ValueError(f"no staged launch for rows of {width}")
    return ctas, smem.value


def flash_f32_geometry(hd: int, heads: int) -> Dict[str, int]:
    """The card's launch of K7's f32 route at head dim ``hd`` with
    ``heads`` query heads a kv head: query rows a thread, dynamic shared
    memory bytes a CTA and resident CTAs an SM, asked of the built library;
    it needs the card."""
    smem, rows = ctypes.c_int(0), ctypes.c_int(0)
    ctas = _lib().ef_flash_f32_occupancy(hd, heads, ctypes.byref(smem),
                                         ctypes.byref(rows))
    if ctas < 0:
        raise ValueError(f"no f32 launch for hd {hd}, {heads} heads")
    return {"rows": rows.value, "smem_bytes": smem.value, "ctas_per_sm": ctas}


def _check_rows(grad, v, g, v_out, g_out, k: int) -> Tuple[int, int]:
    """grad f32 (rows, block); v, g and the outputs of one state dtype, f32
    or bfloat16, at the same shape."""
    if grad.dim() != 2:
        raise ValueError(f"grad: expected (rows, block), got {tuple(grad.shape)}")
    rows, width = grad.shape
    _check("grad", grad, (rows, width), torch.float32)
    if v.dtype not in STATE_DTYPES:
        raise ValueError(f"v: dtype {v.dtype}; the EF state is one of "
                         f"{STATE_DTYPES}")
    for name, t in (("v", v), ("g", g), ("v_out", v_out), ("g_out", g_out)):
        if t is not None:
            _check(name, t, (rows, width), v.dtype)
    if not 1 <= k <= width:
        raise ValueError(f"k={k} outside [1, block={width}]")
    return rows, width


def _into(x: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return x
    out.copy_(x)
    return out


def _present(*ts):
    return [t for t in ts if t is not None]


def block_topk(x: torch.Tensor, *, block: int = 1024, k: int = 16
               ) -> torch.Tensor:
    """K1, Block-TopK by threshold bisection (the reference's public
    ``ops.block_topk``): x of any shape, f32, bf16 or f16, flattened and
    zero-padded to rows of ``block`` (any width: rows wider than 1024
    take the card's wide route, :func:`topk_layout`); per row
    keeps x where |x| >= the 26-step threshold. Returns a new tensor of x's
    shape and dtype."""
    if not 1 <= k <= block:
        raise ValueError(f"k={k} outside [1, block={block}]")
    if x.dtype not in _TOPK_DTYPES:
        raise ValueError(f"x: dtype {x.dtype}; K1 takes "
                         f"{sorted(map(str, _TOPK_DTYPES))}")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    route = _route(x)
    if route == "plain":
        return ref.block_topk_plain(x, block=block, k=k)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _launch(route, "block_topk", "ef_launch_block_topk", x, out, x.numel(),
            block, k, _TOPK_DTYPES[x.dtype])
    return out


def ef21_sgdm_update(grad: torch.Tensor, v: torch.Tensor, g: torch.Tensor, *,
                     eta: float, k: int, v_out: Optional[torch.Tensor] = None,
                     g_out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2, the fused EF21-SGDM client update on (rows, block) rows, grad f32
    and the state v, g f32 or bfloat16, any block (:func:`ef_layout` names
    the card's route): returns (v', g', c) in the state's dtype.
    ``v_out``/``g_out`` receive v'/g' when given (they may be ``v``/``g``
    themselves: an in-place state update)."""
    rows, width = _check_rows(grad, v, g, v_out, g_out, k)
    route = _route(grad, v, g, *_present(v_out, g_out))
    if route == "plain":
        vn, gn, c = ref.ef21_sgdm_update_plain(grad, v, g, eta=eta, k=k)
        return _into(vn, v_out), _into(gn, g_out), c
    v_out = torch.empty_like(v) if v_out is None else v_out
    g_out = torch.empty_like(g) if g_out is None else g_out
    c = torch.empty_like(g)
    c1, c2 = ref._coeffs(eta)
    _launch(route, "ef21_sgdm_update", "ef_launch_ef21_sgdm_update", grad, v,
            g, v_out, g_out, c, rows, width, c1, c2, k,
            int(v.dtype == torch.bfloat16))
    return v_out, g_out, c


def ef21_sgdm_topk_quant(grad: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                         *, eta: float, k: int, bits: int,
                         v_out: Optional[torch.Tensor] = None,
                         g_out: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """K3, the one-launch uplink on (rows, block) rows, grad f32 and the
    state v, g f32 or bfloat16, any block (an even one at 4 bits):
    returns (v', g', q, scales) with g' = g +
    dequantize(q, scales), v' and g' in the state's dtype. ``v_out`` /
    ``g_out`` as for :func:`ef21_sgdm_update`."""
    rows, width = _check_rows(grad, v, g, v_out, g_out, k)
    _check_bits(bits)
    if bits == 4 and width % 2:
        raise ValueError("uint4 packing needs an even block")
    route = _route(grad, v, g, *_present(v_out, g_out))
    if route == "plain":
        vn, gn, q, s = ref.ef21_sgdm_topk_quant_plain(grad, v, g, eta=eta,
                                                      k=k, bits=bits)
        return _into(vn, v_out), _into(gn, g_out), q, s
    v_out = torch.empty_like(v) if v_out is None else v_out
    g_out = torch.empty_like(g) if g_out is None else g_out
    qdtype, qcols = (torch.int8, width) if bits == 8 else (torch.uint8,
                                                           width // 2)
    q = torch.empty((rows, qcols), dtype=qdtype, device=g.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=g.device)
    c1, c2 = ref._coeffs(eta)
    _launch(route, "ef21_sgdm_topk_quant", "ef_launch_ef21_sgdm_topk_quant",
            grad, v, g, v_out, g_out, q, scales, rows, width, c1, c2, k,
            bits, int(v.dtype == torch.bfloat16))
    return v_out, g_out, q, scales


def dequant_add(q: torch.Tensor, scales: torch.Tensor, base: torch.Tensor, *,
                block: int, bits: int, alpha: float = 1.0) -> torch.Tensor:
    """K4, ``base + alpha * dequantize(q, scales)`` in one launch. ``base`` is
    a flat f32 (d,) holding the first d of q's rows*block decoded slots; q
    has K5's layout (at 4 bits an odd block's rows end in a pad nibble).
    Returns a new (d,) f32 tensor."""
    _check_bits(bits)
    if q.dim() != 2 or base.dim() != 1:
        raise ValueError(f"q must be (rows, cols) and base flat, got "
                         f"{tuple(q.shape)} and {tuple(base.shape)}")
    rows, d = q.shape[0], base.numel()
    qdtype, qcols = _codec_layout(bits, block)
    _check("q", q, (rows, qcols), qdtype)
    _check("scales", scales, (rows,), torch.float32)
    _check("base", base, (d,), torch.float32)
    if not (rows - 1) * block < d <= rows * block:
        raise ValueError(f"base of {d} values does not fill {rows} rows of "
                         f"{block}")
    route = _route(q, scales, base)
    if route == "plain":
        return ref.dequant_add_plain(q, scales, base, block=block, bits=bits,
                                     alpha=alpha)
    out = torch.empty_like(base)
    _launch(route, "dequant_add", "ef_launch_dequant_add", q, scales, base,
            out, rows, d, block, bits, float(alpha), int(alpha != 1.0))
    return out


def block_quantize(x_rows: torch.Tensor, bits: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5, per-row absmax quantization of (rows, cols) f32: returns
    (q, scales) — q int8 (rows, cols) at bits 8, packed uint4
    (rows, ceil(cols/2)) at bits 4 — with scales f32 (rows,). Any width;
    the launcher picks the card's mapping (:func:`codec_mapping`)."""
    _check_bits(bits)
    if x_rows.dim() != 2 or x_rows.shape[1] < 1:
        raise ValueError(f"x: expected (rows, cols >= 1), got "
                         f"{tuple(x_rows.shape)}")
    rows, cols = x_rows.shape
    _check("x", x_rows, (rows, cols), torch.float32)
    route = _route(x_rows)
    if route == "plain":
        return ref.block_quantize_plain(x_rows, bits)
    if rows > _MAX_ROWS:
        raise ValueError(f"{rows} rows > {_MAX_ROWS} in one launch")
    qdtype, qcols = _codec_layout(bits, cols)
    q = torch.empty((rows, qcols), dtype=qdtype, device=x_rows.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x_rows.device)
    _launch(route, "block_quantize", "ef_launch_block_quantize", x_rows, q,
            scales, rows, cols, bits)
    return q, scales


def block_dequantize(q: torch.Tensor, scales: torch.Tensor, bits: int,
                     cols: int) -> torch.Tensor:
    """K6, the inverse of :func:`block_quantize`: q*scale per row, f32
    (rows, cols), the uint4 pad dropped."""
    _check_bits(bits)
    if q.dim() != 2 or cols < 1:
        raise ValueError(f"q must be (rows, ·) and cols >= 1, got "
                         f"{tuple(q.shape)} and cols={cols}")
    rows = q.shape[0]
    qdtype, qcols = _codec_layout(bits, cols)
    _check("q", q, (rows, qcols), qdtype)
    _check("scales", scales, (rows,), torch.float32)
    route = _route(q, scales)
    if route == "plain":
        return ref.block_dequantize_plain(q, scales, bits=bits, cols=cols)
    if rows > _MAX_ROWS:
        raise ValueError(f"{rows} rows > {_MAX_ROWS} in one launch")
    out = torch.empty((rows, cols), dtype=torch.float32, device=q.device)
    _launch(route, "block_dequantize", "ef_launch_block_dequantize", q,
            scales, out, rows, cols, bits)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """K7, attention forward with an online softmax: q (B,S,H,hd), k and v
    (B,S,KV,hd) with H % KV == 0 (query head h reads kv head h // (H/KV)),
    all of one dtype, f32 or bf16, hd in ``FLASH_HEAD_DIMS``, any S.
    Returns (B,S,H,hd) in q's dtype; one launch a call.

    The dtype picks the route. bf16 runs on the tensor cores (wgmma; one
    CTA for the query heads of a kv head, K/V staged by TMA): the scores,
    softmax, l and the accumulator are f32, and P is rounded to bf16 for
    P.V, as the reference's chunked attention rounds it. f32 runs on the
    CUDA cores with P in f32 (one CTA for the query heads of a kv head too,
    K/V staged by 16-byte cp.async). On the card q, k and v must start on
    16-byte boundaries. On CPU tensors the plain version makes the same
    roundings (``ref.flash_attention_plain``, with ``round_p`` for bf16)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B,S,heads,hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: dtype {q.dtype}; K7 takes float32 or bfloat16")
    _check("q", q, (B, S, H, hd), q.dtype)
    _check("k", k, (B, S, KV, hd), q.dtype)
    _check("v", v, (B, S, KV, hd), q.dtype)
    if S < 1 or KV < 1 or H % KV:
        raise ValueError(f"S={S}, H={H}, KV={KV}: need S >= 1 and KV "
                         "dividing H")
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {FLASH_HEAD_DIMS}")
    bf16 = q.dtype == torch.bfloat16
    route = _route(q, k, v)
    if route == "plain":
        return ref.flash_attention_plain(q, k, v, causal=causal,
                                         round_p=bf16)
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B}, H={H}: at most 65535 each in one launch")
    if route == "card" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries (the "
                         "bf16 route loads them by TMA, the f32 route by "
                         "16-byte copies)")
    out = torch.empty_like(q)
    if route == "traced":
        pairs = S * (S + 1) // 2 if causal else S * S
        traced_flops["flash_attention"] += 4 * B * H * hd * pairs
    _launch(route, "flash_attention", "ef_launch_flash_attention", q, k, v,
            out, B, S, H, KV, hd, int(bf16), int(causal),
            float(np.float32(hd ** -0.5)))
    return out
