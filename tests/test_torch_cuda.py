"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
elsewhere; they import nothing of JAX, so they run on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Outputs must be bit-identical: the kernels and the plain versions make the
same f32 roundings (kernels/ref.py).
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
