"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
elsewhere; they import nothing of JAX, so they run on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Outputs of K1-K6 must be bit-identical: the kernels and the plain versions
make the same f32 roundings (kernels/ref.py), NaN where the plain version
has NaN. K2 and K3 run the staged row walk on widths that are a multiple of
8 from 16-byte aligned bases and the strided kernel elsewhere
(``ops.ef_layout`` says which); both are held. K7 (flash attention) sums in
another order and is held within stated tolerances.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width,k", [(1024, 51), (1024, 16), (1000, 50),
                                     (128, 5), (33, 2)])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_cuda_kernels_match_plain(cuda_device, bits, width, k):
    """bits 0 is K2, 8 and 4 are K3; widths not a multiple of 32 leave lanes
    of the last register column empty."""
    if bits == 4 and width % 2:
        pytest.skip("uint4 packing needs an even block")
    rows, eta = 513, 0.2
    gen = torch.Generator(device="cpu").manual_seed(bits + width)
    grad, v, g = (torch.randn(rows, width, generator=gen).to(cuda_device)
                  for _ in range(3))
    v[7], g[7], grad[7] = 0.0, 0.0, 0.0
    if bits == 0:
        got = ops.ef21_sgdm_update(grad, v, g, eta=eta, k=k)
        want = ref.ef21_sgdm_update_plain(grad, v, g, eta=eta, k=k)
    else:
        got = ops.ef21_sgdm_topk_quant(grad, v, g, eta=eta, k=k, bits=bits)
        want = ref.ef21_sgdm_topk_quant_plain(grad, v, g, eta=eta, k=k,
                                              bits=bits)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _same(a, b):
    """Bit for bit, NaN where the other has NaN (torch.equal counts two
    NaNs unequal)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _ef_rows(rows, width, state_dtype, device, seed):
    """grad f32, v and g in the state's dtype: an all-zero row, an inf in
    grad, a NaN in g, and a row whose values tie across the k-th one."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    grad, v, g = (torch.randn(rows, width, generator=gen) for _ in range(3))
    grad[3], v[3], g[3] = 0.0, 0.0, 0.0
    grad[5, 0] = float("inf")
    g[6, width // 2] = float("nan")
    grad[7], v[7], g[7] = 0.0, 0.0, 0.0
    grad[7, :min(width, 20)] = 2.0                  # 20 tied values
    return (grad.to(device), v.to(device=device, dtype=state_dtype),
            g.to(device=device, dtype=state_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [8, 16, 24, 256, 1000, 1024])
def test_cuda_ef_update_staged_matches_plain(cuda_device, width, state_dtype,
                                             in_place):
    """K2 on the staged kernel (widths a multiple of 8 from 16-byte aligned
    bases) against ef21_sgdm_update_plain, bit for bit, with f32 and bf16
    state, an all-zero row, inf and NaN inputs and a tie across the k-th
    value; in place (v_out=v, g_out=g) as the carriers call it."""
    grad, v, g = _ef_rows(517, width, state_dtype, cuda_device, width)
    k = min(width, 16) if width >= 64 else max(1, width // 4)
    want = ref.ef21_sgdm_update_plain(grad, v, g, eta=0.2, k=k)
    if in_place:
        got = ops.ef21_sgdm_update(grad, v, g, eta=0.2, k=k, v_out=v, g_out=g)
        assert got[0] is v and got[1] is g
    else:
        got = ops.ef21_sgdm_update(grad, v, g, eta=0.2, k=k)
    torch.cuda.synchronize()
    assert ops.ef_layout(grad, v, g, *got) == "staged"
    for a, b in zip(got, want):
        assert _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,misaligned", [(13, False), (51, False),
                                              (1024, True), (256, True)])
def test_cuda_ef_update_strided_matches_plain(cuda_device, width, misaligned,
                                              state_dtype):
    """K2's strided kernel takes odd widths and any base off a 16-byte
    boundary (here grad's), bit for bit as well, NaN and inf included."""
    grad, v, g = _ef_rows(300, width, state_dtype, cuda_device, 7 + width)
    if misaligned:
        grad = _unaligned(grad)
    k = 3 if width < 64 else 16
    want = ref.ef21_sgdm_update_plain(grad, v, g, eta=0.2, k=k)
    got = ops.ef21_sgdm_update(grad, v, g, eta=0.2, k=k)
    torch.cuda.synchronize()
    assert ops.ef_layout(grad, v, g, *got) == "strided"
    for a, b in zip(got, want):
        assert _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_topk_quant_staged_odd_rows_match_plain(cuda_device, bits,
                                                     state_dtype):
    """K3 on the same rows (zeros, inf, NaN, ties) on the staged walk it
    shares with K2, bit for bit."""
    grad, v, g = _ef_rows(517, 1024, state_dtype, cuda_device, bits)
    want = ref.ef21_sgdm_topk_quant_plain(grad, v, g, eta=0.2, k=16,
                                          bits=bits)
    got = ops.ef21_sgdm_topk_quant(grad, v, g, eta=0.2, k=16, bits=bits)
    torch.cuda.synchronize()
    assert ops.ef_layout(grad, v, g, *got[:3]) == "staged"
    for a, b in zip(got, want):
        assert _same(a, b)


@pytest.mark.cuda
def test_cuda_kernels_write_state_in_place(cuda_device):
    gen = torch.Generator(device="cpu").manual_seed(3)
    grad, v, g = (torch.randn(64, 1024, generator=gen).to(cuda_device)
                  for _ in range(3))
    want = ref.ef21_sgdm_topk_quant_plain(grad, v, g, eta=0.2, k=16, bits=8)
    ops.reset_launches()
    got = ops.ef21_sgdm_topk_quant(grad, v, g, eta=0.2, k=16, bits=8,
                                   v_out=v, g_out=g)
    assert got[0] is v and got[1] is g
    assert ops.launches["ef21_sgdm_topk_quant"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1024, 256])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_dequant_add_matches_plain(cuda_device, bits, block):
    """K4 at the fused downlink's rows of 1024 and the dense payload's 256."""
    nb = 77
    d = nb * block - 100
    gen = torch.Generator(device="cpu").manual_seed(bits)
    qcols = block if bits == 8 else block // 2
    q = torch.randint(-127 if bits == 8 else 0, 128 if bits == 8 else 256,
                      (nb, qcols), generator=gen).to(
        torch.int8 if bits == 8 else torch.uint8).to(cuda_device)
    scales = torch.rand(nb, generator=gen).to(cuda_device)
    base = torch.randn(d, generator=gen).to(cuda_device)
    for alpha in (1.0, -0.5):
        got = ops.dequant_add(q, scales, base, block=block, bits=bits,
                              alpha=alpha)
        want = ref.dequant_add_plain(q, scales, base, block=block, bits=bits,
                                     alpha=alpha)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(4099, 16), (2051, 51), (1025, 256),
                                       (513, 1024), (3, 8191), (2, 8193),
                                       (1, 2_359_296), (1001, 1), (333, 3),
                                       (777, 17), (257, 33), (65, 1025)])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_codec_matches_plain(cuda_device, bits, rows, cols):
    """K5 and K6 against their plain versions: the carriers' row widths (16
    and 51 the sparse payloads, 256 the dense payload, 1024 a selection
    block, one row of 2,359,296 plain TopK's block on the embed leaf), the
    lane groups of narrow rows (1 to 32 lanes a row, up to 1024 wide; row
    counts that leave a CTA's last groups empty), the CTA size steps at
    8192, with non-finite values and an all-zero row."""
    gen = torch.Generator(device="cpu").manual_seed(bits + rows + cols)
    x = torch.randn(rows, cols, generator=gen)
    x[0, 0], x[0, -1] = float("inf"), float("nan")
    if rows > 1:
        x[1] = 0.0
    x = x.to(cuda_device)
    ops.reset_launches()
    q, s = ops.block_quantize(x, bits)
    out = ops.block_dequantize(q, s, bits, cols)
    torch.cuda.synchronize()
    assert ops.launches["block_quantize"] == ops.launches["block_dequantize"] == 1
    for a, b in zip((q, s), ref.block_quantize_plain(x, bits)):
        assert torch.equal(a, b)
    assert torch.equal(out, ref.block_dequantize_plain(q, s, bits=bits,
                                                       cols=cols))


def _unaligned(t):
    """A contiguous copy of ``t`` starting 4 bytes past a 16-byte boundary
    (a view into a larger buffer)."""
    pad = 4 // t.element_size()
    buf = torch.empty(t.numel() + pad, dtype=t.dtype, device=t.device)
    view = buf[pad:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,misaligned,mapping", [
    (4099, 16, False, "vector"), (4099, 32, False, "vector"),
    (1025, 256, False, "vector"), (513, 1024, False, "vector"),
    # more rows than the card's resident groups: the grid-stride walk's
    # last pass, and the last CTA's last warp, are partial
    (1_000_003, 16, False, "vector"), (70_001, 32, False, "vector"),
    (33_333, 256, False, "vector"), (3001, 1024, False, "vector"),
    # not on a 16-byte boundary: the scalar mapping
    (4099, 16, True, "scalar"), (1025, 256, True, "scalar"),
    (513, 1024, True, "scalar"),
    # odd widths
    (1001, 1, False, "scalar"), (777, 17, False, "scalar"),
    (2051, 51, False, "scalar"), (2051, 51, True, "scalar"),
    # wider than 1024: one CTA a row
    (65, 1026, False, "wide"), (2, 2_359_296, False, "wide")])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_codec_mappings_match_plain(cuda_device, bits, rows, cols,
                                         misaligned, mapping):
    """K5 and K6 on each mapping (``ops.codec_mapping``): rows of 16, 32,
    256 and 1024 on the vector mapping, with a partial last pass; the same
    from a base that is not 16-byte aligned (a sliced view of x for K5 and
    of q for K6) and odd widths on the scalar mapping; rows wider than 1024
    on the wide mapping; an inf, a NaN and an all-zero row in each.
    Bit-identical to the plain versions."""
    gen = torch.Generator(device="cpu").manual_seed(bits + rows + cols)
    x = torch.randn(rows, cols, generator=gen)
    x[0, 0], x[0, -1] = float("inf"), float("nan")
    x[1] = 0.0
    x[-1, -1] = float("-inf")
    x = x.to(cuda_device)
    if misaligned:
        x = _unaligned(x)
    q, s = ops.block_quantize(x, bits)
    assert ops.codec_mapping(x, q, cols) == mapping
    if misaligned:
        q = _unaligned(q)
    out = ops.block_dequantize(q, s, bits, cols)
    assert ops.codec_mapping(q, out, cols) == mapping
    torch.cuda.synchronize()
    for a, b in zip((q, s), ref.block_quantize_plain(x, bits)):
        assert torch.equal(a, b)
    assert torch.equal(out, ref.block_dequantize_plain(q, s, bits=bits,
                                                       cols=cols))


# K7 at the shapes of chip_smoke.py's phase: the smoke config's heads, the
# full-width prefill (B 8, S 1024, H 15, KV 5, hd 64), a ragged S and hd 128
FLASH_SHAPES = [(2, 64, 3, 1, 64), (8, 1024, 15, 5, 64),
                (2, 1000, 15, 5, 64), (2, 256, 8, 2, 128), (1, 70, 4, 2, 32)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_inputs(B, S, H, KV, hd, dtype, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed + S + H + hd)
    q = torch.randn(B, S, H, hd, generator=gen)
    k, v = (torch.randn(B, S, KV, hd, generator=gen) for _ in range(2))
    return [x.to(device=device, dtype=dtype) for x in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd", FLASH_SHAPES)
def test_cuda_flash_attention_matches_plain(cuda_device, B, S, H, KV, hd,
                                            dtype, causal):
    """K7 against flash_attention_plain within the tolerance of the
    reference's flash test (tests/test_kernels.py): 2e-5 in f32, 2e-2 in
    bf16, atol and rtol; one launch a call."""
    q, k, v = _flash_inputs(B, S, H, KV, hd, dtype, cuda_device)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 1
    want = ref.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (B, S, H, hd)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 3, 5])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 1000, 1024])
def test_cuda_flash_attention_f32_route_matches_plain(cuda_device, S, hd, G,
                                                      causal):
    """K7's f32 route (one CTA for the G query heads of a kv head, up to 3
    a CTA; a ragged last tile at S 63, 65 and 1000; S 1 a single key)
    within 2e-5 of flash_attention_plain, atol and rtol."""
    B, KV = 2, 2
    q, k, v = _flash_inputs(B, S, KV * G, KV, hd, torch.float32, cuda_device,
                            seed=G)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def _p_rounding_bound(q, k, v, causal):
    """Per output element, sum_j p_j |v_j| / l of the f32 softmax (the
    size of the P.V sum that P's rounding can move)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kf, vf = (x.float().repeat_interleave(G, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (hd ** -0.5)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf.abs())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", FLASH_SHAPES)
def test_cuda_flash_attention_bf16_matches_p_rounding_plain(
        cuda_device, B, S, H, KV, hd, causal):
    """K7's bf16 (tensor-core) route against flash_attention_plain with
    round_p=True, which makes its roundings. Both round P to bf16 once
    (unit roundoff 2^-8), the kernel against its running max and the plain
    version against the final one, so each p_j may differ by 2 * 2^-8
    relative, which moves out_i by at most 2^-7 * sum_j p_j |v_j| / l_i;
    both round out_i to bf16 once, which adds at most 2^-8 * (|a| + |b|),
    2^-7 * |out_i| to first order; the f32 sums' order adds ~1e-6 relative
    (1e-5 absolute here, and 1 % on the two bf16 terms for second-order
    effects)."""
    q, k, v = _flash_inputs(B, S, H, KV, hd, torch.bfloat16, cuda_device)
    got = ops.flash_attention(q, k, v, causal=causal).float()
    want = ref.flash_attention_plain(q, k, v, causal=causal,
                                     round_p=True).float()
    bound = 1.01 * 2 ** -7 * (_p_rounding_bound(q, k, v, causal)
                              + want.abs()) + 1e-5
    err = (got - want).abs()
    assert bool((err <= bound).all()), (
        f"max err {float(err.max())}, worst err/bound "
        f"{float((err / bound).max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,block,k", [
    ((600, 1024), 1024, 16), ((8, 3, 1000), 1024, 51),   # ragged last row
    ((4097,), 37, 5), ((5, 99), 16, 3), ((77,), 1, 1),   # narrow and odd
    ((3, 130), 8, 8), ((1000,), 33, 32)])
def test_cuda_block_topk_matches_plain(cuda_device, dtype, shape, block, k):
    """K1 at widths that take a whole warp a row and at the lane groups of
    narrow rows, on a flat length that leaves the last row ragged, with an
    all-zero stretch and ties."""
    gen = torch.Generator(device="cpu").manual_seed(block + k)
    x = torch.randn(shape, generator=gen).to(dtype)
    flat = x.view(-1)
    flat[: 3 * block] = 0.0
    flat[5 * block: 5 * block + 4] = 2.0                 # a tie
    x = x.to(cuda_device)
    ops.reset_launches()
    got = ops.block_topk(x, block=block, k=k)
    torch.cuda.synchronize()
    assert ops.launches["block_topk"] == 1
    want = ref.block_topk_plain(x, block=block, k=k)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)


# rows wider than 1024: the wide route (csrc/wide.cuh), a CTA a row, kept
# in shared memory up to 28,672 values (K2/K3) or 57,344 (K1), recomputed
# from device memory each pass beyond; (rows, width, k, layout)
WIDE_EF = [(37, 1025, 16, "wide_shared"), (33, 2048, 32, "wide_shared"),
           (19, 3000, 47, "wide_shared"), (41, 4096, 64, "wide_shared"),
           (9, 28_672, 448, "wide_shared"), (7, 28_674, 448, "wide_global"),
           (3, 65_536, 1024, "wide_global"),
           (1, 1_048_576, 16_384, "wide_global")]


@pytest.mark.cuda
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("rows,width,k,layout", WIDE_EF)
def test_cuda_wide_rows_match_plain(cuda_device, rows, width, k, layout,
                                    bits, state_dtype, in_place):
    """K2 (bits 0) and K3 on rows wider than 1024, bit for bit against the
    plain versions: an all-zero row, an inf, a NaN, ties across the k-th
    value; in place as the carriers call them (the route that keeps
    nothing must store v' only after its last read of the row)."""
    if bits == 4 and width % 2:
        return                              # uint4 packing: even rows only
    grad, v, g = _ef_rows(max(rows, 8), width, state_dtype, cuda_device,
                          width + bits)
    kw = dict(eta=0.2, k=k)
    plain = ref.ef21_sgdm_update_plain if bits == 0 else \
        ref.ef21_sgdm_topk_quant_plain
    kernel = ops.ef21_sgdm_update if bits == 0 else ops.ef21_sgdm_topk_quant
    if bits:
        kw["bits"] = bits
    want = plain(grad, v, g, **kw)
    ops.reset_launches()
    if in_place:
        got = kernel(grad, v, g, v_out=v, g_out=g, **kw)
        assert got[0] is v and got[1] is g
    else:
        got = kernel(grad, v, g, **kw)
    torch.cuda.synchronize()
    assert sum(ops.launches.values()) == 1
    assert ops.ef_layout(grad, v, g, got[0], got[1], got[2]) == layout
    for a, b in zip(got, want):
        assert _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("width", [1025, 3001, 4096])
def test_cuda_wide_rows_off_16_bytes_match_plain(cuda_device, width, bits,
                                                 state_dtype):
    """The wide route takes odd widths and bases off a 16-byte boundary
    (the strided rule's inputs), K2 and K3 at 8 bits."""
    grad, v, g = _ef_rows(9, width, state_dtype, cuda_device, 3 + width)
    grad, v = _unaligned(grad), _unaligned(v)
    if bits == 0:
        got = ops.ef21_sgdm_update(grad, v, g, eta=0.2, k=20)
        want = ref.ef21_sgdm_update_plain(grad, v, g, eta=0.2, k=20)
    else:
        got = ops.ef21_sgdm_topk_quant(grad, v, g, eta=0.2, k=20, bits=8)
        want = ref.ef21_sgdm_topk_quant_plain(grad, v, g, eta=0.2, k=20,
                                              bits=8)
    torch.cuda.synchronize()
    assert ops.ef_layout(grad, v, g, *got[:3]) == "wide_shared"
    for a, b in zip(got, want):
        assert _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,block,k,layout", [
    (5 * 1025 + 3, 1025, 16, "wide_shared"), (7 * 2048, 2048, 32,
                                              "wide_shared"),
    (9 * 4097 - 1000, 4097, 64, "wide_shared"),
    (3 * 57_344, 57_344, 896, "wide_shared"),
    (2 * 65_536 + 17, 65_536, 1024, "wide_global"),
    (1_048_576, 1_048_576, 16_384, "wide_global")])
def test_cuda_block_topk_wide_matches_plain(cuda_device, dtype, n, block, k,
                                            layout):
    """K1 on the wide route: a ragged last row read as zeros and not
    stored, an all-zero row, ties, a NaN row; bit for bit."""
    gen = torch.Generator(device="cpu").manual_seed(block + k)
    x = torch.randn(n, generator=gen).to(dtype)
    x[:block] = 0.0
    if n >= 2 * block:
        x[block:block + k + 5] = 2.0                     # a tie across k
    x[-3] = float("nan")
    x = x.to(cuda_device)
    ops.reset_launches()
    got = ops.block_topk(x, block=block, k=k)
    torch.cuda.synchronize()
    assert ops.launches["block_topk"] == 1
    assert ops.topk_layout(block) == layout
    want = ref.block_topk_plain(x, block=block, k=k)
    assert got.dtype == dtype and got.shape == x.shape
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1023, 51])
def test_cuda_dequant_add_odd_block_4_bits_matches_plain(cuda_device, block):
    """K4 at 4 bits on an odd block (fused_quant4's downlink at an odd
    Block-TopK block): rows of ceil(block/2) bytes, K5's layout."""
    nb, d = 53, 53 * block - 7
    gen = torch.Generator(device="cpu").manual_seed(block)
    q = torch.randint(0, 256, (nb, (block + 1) // 2), generator=gen).to(
        torch.uint8).to(cuda_device)
    scales = torch.rand(nb, generator=gen).to(cuda_device)
    base = torch.randn(d, generator=gen).to(cuda_device)
    for alpha in (1.0, -0.5):
        got = ops.dequant_add(q, scales, base, block=block, bits=4,
                              alpha=alpha)
        want = ref.dequant_add_plain(q, scales, base, block=block, bits=4,
                                     alpha=alpha)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("width,k", [(1024, 16), (1024, 51), (1000, 50),
                                     (128, 5)])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_cuda_kernels_match_plain_bf16_state(cuda_device, bits, width, k):
    """K2 (bits 0) and K3 with bfloat16 v and g: loads widened to f32, f32
    arithmetic, v' and g' (and K2's c) rounded to bf16 by the kernel and the
    plain version alike; in place as the carriers run them."""
    rows, eta = 513, 0.2
    gen = torch.Generator(device="cpu").manual_seed(7 * bits + width)
    grad = torch.randn(rows, width, generator=gen).to(cuda_device)
    v, g = (torch.randn(rows, width, generator=gen).to(
        device=cuda_device, dtype=torch.bfloat16) for _ in range(2))
    v[7], g[7], grad[7] = 0.0, 0.0, 0.0
    if bits == 0:
        want = ref.ef21_sgdm_update_plain(grad, v, g, eta=eta, k=k)
        got = ops.ef21_sgdm_update(grad, v, g, eta=eta, k=k, v_out=v,
                                   g_out=g)
    else:
        want = ref.ef21_sgdm_topk_quant_plain(grad, v, g, eta=eta, k=k,
                                              bits=bits)
        got = ops.ef21_sgdm_topk_quant(grad, v, g, eta=eta, k=k, bits=bits,
                                       v_out=v, g_out=g)
    torch.cuda.synchronize()
    assert got[0] is v and got[1] is g
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_save_resume_at_smoke_size(cuda_device, tmp_path):
    """bf16 EF state, AdamW and fused_quant8 up / fused_quant4 down on the
    card at smoke size: train 2 steps and save, resume in a new Session,
    every restored leaf equal to the saved one, and step 3 after the resume
    equal to step 3 of the uninterrupted run within rtol 1e-3."""
    import json
    import os
    from repro_torch.launch.session import Session
    from repro_torch.launch.spec import RunSpec
    root = os.path.join(os.path.dirname(__file__), "..")
    with open(os.path.join(root, "results", "specs",
                           "fused_quickstart.json")) as f:
        spec = RunSpec.from_dict(dict(
            json.load(f), smoke=True, seq_len=64, carrier="fused_quant8",
            downlink_carrier="fused_quant4", ef_state_dtype="bfloat16",
            optimizer="adamw", lr=1e-3, ckpt_dir=str(tmp_path)))
    sess = Session(spec, device="cuda")
    sess.train(2, log_every=1)                         # saves at step 2
    saved = {k: v.clone() for k, v in _flat_state(sess).items()}
    assert all(v.dtype == torch.bfloat16 for k, v in saved.items()
               if k.startswith("ef_state/clients/"))
    want = sess.step_once()
    resumed = Session.resume(str(tmp_path), device="cuda")
    assert resumed.step == 2
    got_state = _flat_state(resumed)
    assert sorted(got_state) == sorted(saved)
    for k, v in saved.items():
        assert got_state[k].dtype == v.dtype and torch.equal(got_state[k], v), k
    got = resumed.step_once()
    for key in ("loss", "g_norm"):
        a, b = float(got[key]), float(want[key])
        assert abs(a - b) <= 1e-3 * abs(b), (key, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("compressor,kw", [
    ("block_quant", {"bits": 8, "block": 256}),
    ("block_topk", {"block": 1024, "k_per_block": 16})])
def test_cuda_dense_plan_matches_cpu(cuda_device, compressor, kw):
    """The dense plan (the clients in one pass, C through
    ``Compressor.batched``) on the card against the CPU at smoke size: 2
    steps in f32 activations, loss and g_norm within rtol 1e-3 (the same
    check as chip_smoke.py's phase 3); block_quant launches K5 and K6 on
    the card."""
    import json
    import os
    from repro_torch.launch.session import Session
    from repro_torch.launch.spec import RunSpec
    root = os.path.join(os.path.dirname(__file__), "..")
    with open(os.path.join(root, "results", "specs",
                           "fused_quickstart.json")) as f:
        spec = RunSpec.from_dict(dict(
            json.load(f), smoke=True, seq_len=64, carrier="dense",
            downlink_carrier="dense", compressor=compressor,
            compressor_kw=kw))
    runs = {}
    for device in ("cuda", "cpu"):
        ops.reset_launches()
        runs[device] = Session(spec, device=device,
                               dtype="float32").train(2, log_every=1)
        if device == "cuda" and compressor == "block_quant":
            assert ops.launches["block_quantize"] > 0
            assert ops.launches["block_dequantize"] > 0
    for got, want in zip(runs["cuda"], runs["cpu"]):
        for key in ("loss", "g_norm"):
            assert abs(got[key] - want[key]) <= 1e-3 * abs(want[key]), \
                (key, got[key], want[key])


def _flat_state(sess):
    from repro_torch.core.ef import flatten
    return flatten({"params": sess.params, "opt_state": sess.opt_state,
                    "ef_state": sess.ef_state})


STREAM_DOWNLINKS = [
    pytest.param({"carrier": "fused_quant8",
                  "downlink_carrier": "fused_quant4"}, "dequant_add",
                 id="fused_quant4"),
    pytest.param({"carrier": "quant8", "downlink_carrier": "quant4"},
                 "block_dequantize", id="quant4")]


def _stream_spec(overrides):
    import json
    import os
    from repro_torch.launch.spec import RunSpec
    root = os.path.join(os.path.dirname(__file__), "..")
    with open(os.path.join(root, "results", "specs",
                           "fused_quickstart.json")) as f:
        return RunSpec.from_dict(dict(json.load(f), smoke=True, seq_len=64,
                                      **overrides))


@pytest.mark.cuda
@pytest.mark.parametrize("overrides,apply_kernel", STREAM_DOWNLINKS)
def test_cuda_publish_subscribe_bit_for_bit(cuda_device, tmp_path, overrides,
                                            apply_kernel):
    """The wire stream on the card at smoke size: a trainer publishes 3
    steps (its re-encode's verify holds K5/K4 to the step's own h); a
    replica on the card lands on the trainer's params bit for bit after
    every record, its apply launching K4 (fused_quant4's dense payload) or
    K6 (quant4's sparse payload) once a leaf."""
    from repro_torch.launch import fleet as fleet_lib
    from repro_torch.launch.session import Session
    sess = Session(_stream_spec(overrides), device="cuda")
    sess.publish_to(str(tmp_path))
    rep = fleet_lib.ServeReplica(str(tmp_path), device="cuda")
    for _ in range(3):
        sess.step_once()
        ops.reset_launches()
        assert rep.sync() == 1
        assert ops.launches[apply_kernel] == len(sess.params)
        assert all(torch.equal(rep.params[k], sess.params[k])
                   for k in sess.params)
    assert rep.step == 3 and rep.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("overrides,apply_kernel", STREAM_DOWNLINKS)
def test_cuda_published_records_equal_the_cpu_records(cuda_device, tmp_path,
                                                      overrides,
                                                      apply_kernel):
    """From the same start — one (server, h_prev) pair, its h_new from the
    CPU's integrate — the Publisher on the card writes the records the CPU
    writes, array for array: K5 and K4 against their plain versions
    through the whole publish, verify included."""
    from repro_torch.core import stream as stream_lib
    from repro_torch.launch import build as build_lib
    from repro_torch.launch.session import Session
    from repro_torch.models import model as model_lib
    spec = _stream_spec(overrides)
    efc = build_lib.ef_config(spec)
    gen = torch.Generator().manual_seed(0)
    like = model_lib.init_params(Session(spec, device="cpu").cfg, None,
                                 "meta")
    server = {k: torch.randn(v.shape, generator=gen) for k, v in like.items()}
    h_prev = {k: v - 0.01 * torch.randn(v.shape, generator=gen)
              for k, v in server.items()}
    legs = stream_lib.resolve_legs(like, schedule=efc.schedule,
                                   down_carrier=efc.down_carrier,
                                   down_compressor=efc.down_compressor)
    h_new = stream_lib.encode_leg(legs[0], server, h_prev)[1]
    recs = {}
    for device in ("cpu", "cuda"):
        on = {name: {k: v.to(device) for k, v in tree.items()}
              for name, tree in (("s", server), ("h", h_prev),
                                 ("n", h_new))}
        log = stream_lib.WireLog(str(tmp_path / device))
        pub = stream_lib.Publisher(log, spec.spec_hash(), legs, spec.seed)
        assert pub.publish(1, on["s"], on["h"], on["n"]) == 1
        recs[device] = log.read(1, 0)
    assert stream_lib.records_equal(recs["cuda"], recs["cpu"])
