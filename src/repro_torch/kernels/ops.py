"""Wrappers of the hand kernels (counterpart of src/repro/kernels/ops.py).

Every wrapper takes the row view its kernel takes, checks device, dtype,
shape and contiguity, and raises on anything else. Tensors on the CPU run
the plain PyTorch version (kernels/ref.py); tensors on a CUDA device launch
the kernel on the current stream and raise if the launch fails. There is no
fallback from one to the other.

``launches`` counts kernel launches per wrapper (plain runs do not count),
so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref

# widest row the warp-per-row kernels hold in registers (bisect.cuh)
MAX_WIDTH = 1024

launches: Dict[str, int] = {"ef21_sgdm_update": 0,
                            "ef21_sgdm_topk_quant": 0, "dequant_add": 0,
                            "block_quantize": 0, "block_dequantize": 0}

_lib_handle: Optional[ctypes.CDLL] = None

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "ef_launch_ef21_sgdm_update":
        [_P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _I, _P],
    "ef_launch_ef21_sgdm_topk_quant":
        [_P, _P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _I, _I, _P],
    "ef_launch_dequant_add": [_P, _P, _P, _P, _L, _L, _I, _I, _F, _I, _P],
    "ef_launch_block_quantize": [_P, _P, _P, _L, _I, _I, _P],
    "ef_launch_block_dequantize": [_P, _P, _P, _L, _I, _I, _P],
}
# wide codec rows take one CTA a row: gridDim.x caps the rows of one launch
_MAX_ROWS = 2 ** 31 - 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def _launch(name: str, *args) -> None:
    rc = getattr(_lib(), name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when every tensor
    is on the CPU; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {kind!r}")
    return kind == "cuda"


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


def _check_rows(grad, v, g, v_out, g_out, k: int) -> Tuple[int, int]:
    if grad.dim() != 2:
        raise ValueError(f"grad: expected (rows, block), got {tuple(grad.shape)}")
    rows, width = grad.shape
    for name, t in (("grad", grad), ("v", v), ("g", g), ("v_out", v_out),
                    ("g_out", g_out)):
        if t is not None:
            _check(name, t, (rows, width), torch.float32)
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


def ef21_sgdm_update(grad: torch.Tensor, v: torch.Tensor, g: torch.Tensor, *,
                     eta: float, k: int, v_out: Optional[torch.Tensor] = None,
                     g_out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2, the fused EF21-SGDM client update on (rows, block) f32 rows:
    returns (v', g', c). ``v_out``/``g_out`` receive v'/g' when given (they
    may be ``v``/``g`` themselves: an in-place state update)."""
    rows, width = _check_rows(grad, v, g, v_out, g_out, k)
    if not _on_cuda(grad, v, g, *_present(v_out, g_out)):
        vn, gn, c = ref.ef21_sgdm_update_plain(grad, v, g, eta=eta, k=k)
        return _into(vn, v_out), _into(gn, g_out), c
    if width > MAX_WIDTH:
        raise ValueError(f"block {width} > {MAX_WIDTH}: wider rows are not "
                         "supported by the CUDA kernel")
    v_out = torch.empty_like(v) if v_out is None else v_out
    g_out = torch.empty_like(g) if g_out is None else g_out
    c = torch.empty_like(g)
    c1, c2 = ref._coeffs(eta)
    _launch("ef_launch_ef21_sgdm_update", grad.data_ptr(), v.data_ptr(),
            g.data_ptr(), v_out.data_ptr(), g_out.data_ptr(), c.data_ptr(),
            rows, width, c1, c2, k)
    launches["ef21_sgdm_update"] += 1
    return v_out, g_out, c


def ef21_sgdm_topk_quant(grad: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                         *, eta: float, k: int, bits: int,
                         v_out: Optional[torch.Tensor] = None,
                         g_out: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """K3, the one-launch uplink on (rows, block) f32 rows: returns
    (v', g', q, scales) with g' = g + dequantize(q, scales). ``v_out`` /
    ``g_out`` as for :func:`ef21_sgdm_update`."""
    rows, width = _check_rows(grad, v, g, v_out, g_out, k)
    _check_bits(bits)
    if bits == 4 and width % 2:
        raise ValueError("uint4 packing needs an even block")
    if not _on_cuda(grad, v, g, *_present(v_out, g_out)):
        vn, gn, q, s = ref.ef21_sgdm_topk_quant_plain(grad, v, g, eta=eta,
                                                      k=k, bits=bits)
        return _into(vn, v_out), _into(gn, g_out), q, s
    if width > MAX_WIDTH:
        raise ValueError(f"block {width} > {MAX_WIDTH}: wider rows are not "
                         "supported by the CUDA kernel")
    v_out = torch.empty_like(v) if v_out is None else v_out
    g_out = torch.empty_like(g) if g_out is None else g_out
    qdtype, qcols = (torch.int8, width) if bits == 8 else (torch.uint8,
                                                           width // 2)
    q = torch.empty((rows, qcols), dtype=qdtype, device=g.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=g.device)
    c1, c2 = ref._coeffs(eta)
    _launch("ef_launch_ef21_sgdm_topk_quant", grad.data_ptr(), v.data_ptr(),
            g.data_ptr(), v_out.data_ptr(), g_out.data_ptr(), q.data_ptr(),
            scales.data_ptr(), rows, width, c1, c2, k, bits)
    launches["ef21_sgdm_topk_quant"] += 1
    return v_out, g_out, q, scales


def dequant_add(q: torch.Tensor, scales: torch.Tensor, base: torch.Tensor, *,
                block: int, bits: int, alpha: float = 1.0) -> torch.Tensor:
    """K4, ``base + alpha * dequantize(q, scales)`` in one launch. ``base`` is
    a flat f32 (d,) holding the first d of q's rows*block decoded slots;
    returns a new (d,) f32 tensor."""
    _check_bits(bits)
    if bits == 4 and block % 2:
        raise ValueError("uint4 packing needs an even block")
    if q.dim() != 2 or base.dim() != 1:
        raise ValueError(f"q must be (rows, cols) and base flat, got "
                         f"{tuple(q.shape)} and {tuple(base.shape)}")
    rows, d = q.shape[0], base.numel()
    qdtype, qcols = (torch.int8, block) if bits == 8 else (torch.uint8,
                                                           block // 2)
    _check("q", q, (rows, qcols), qdtype)
    _check("scales", scales, (rows,), torch.float32)
    _check("base", base, (d,), torch.float32)
    if not (rows - 1) * block < d <= rows * block:
        raise ValueError(f"base of {d} values does not fill {rows} rows of "
                         f"{block}")
    if not _on_cuda(q, scales, base):
        return ref.dequant_add_plain(q, scales, base, block=block, bits=bits,
                                     alpha=alpha)
    out = torch.empty_like(base)
    _launch("ef_launch_dequant_add", q.data_ptr(), scales.data_ptr(),
            base.data_ptr(), out.data_ptr(), rows, d, block, bits,
            float(alpha), int(alpha != 1.0))
    launches["dequant_add"] += 1
    return out


def block_quantize(x_rows: torch.Tensor, bits: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5, per-row absmax quantization of (rows, cols) f32: returns
    (q, scales) — q int8 (rows, cols) at bits 8, packed uint4
    (rows, ceil(cols/2)) at bits 4 — with scales f32 (rows,). Any width."""
    _check_bits(bits)
    if x_rows.dim() != 2 or x_rows.shape[1] < 1:
        raise ValueError(f"x: expected (rows, cols >= 1), got "
                         f"{tuple(x_rows.shape)}")
    rows, cols = x_rows.shape
    _check("x", x_rows, (rows, cols), torch.float32)
    if not _on_cuda(x_rows):
        return ref.block_quantize_plain(x_rows, bits)
    if rows > _MAX_ROWS:
        raise ValueError(f"{rows} rows > {_MAX_ROWS} in one launch")
    qdtype, qcols = _codec_layout(bits, cols)
    q = torch.empty((rows, qcols), dtype=qdtype, device=x_rows.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x_rows.device)
    _launch("ef_launch_block_quantize", x_rows.data_ptr(), q.data_ptr(),
            scales.data_ptr(), rows, cols, bits)
    launches["block_quantize"] += 1
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
    if not _on_cuda(q, scales):
        return ref.block_dequantize_plain(q, scales, bits=bits, cols=cols)
    if rows > _MAX_ROWS:
        raise ValueError(f"{rows} rows > {_MAX_ROWS} in one launch")
    out = torch.empty((rows, cols), dtype=torch.float32, device=q.device)
    _launch("ef_launch_block_dequantize", q.data_ptr(), scales.data_ptr(),
            out.data_ptr(), rows, cols, bits)
    launches["block_dequantize"] += 1
    return out
