"""The port's attention against the reference's, on the CPU: K7's plain
version (what ``ops.flash_attention`` runs on CPU tensors, and what the card
holds the CUDA kernel against) and the decode attention of serving.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 1e-5 (atol and rtol) in f32, where only the order of the sums
differs; 2e-2 in bf16, where the two frameworks round the output (and P,
which the reference's chunked attention rounds normalised and K7's bf16
route unnormalised) at different places — the tolerance of the
reference's own flash-attention test (tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(B, S, H, KV, hd, seed, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k, v = (rng.randn(B, S, KV, hd).astype(np.float32) for _ in range(2))
    if dtype == "bfloat16":       # both packages start from the same bf16
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    return q, k, v


def _torch(x, dtype):
    return torch.tensor(x).to(getattr(torch, dtype))


def _jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 64, 3, 1, 64),      # the smoke config's heads
    (1, 100, 6, 2, 32),     # ragged S, GQA 3
    (1, 37, 4, 4, 128),     # no GQA, S below one tile
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_reference_oracle(dtype, B, S, H, KV, hd, causal):
    """flash_attention_plain (with GQA) against the reference's
    flash_attention_ref after jnp.repeat of the kv heads."""
    q, k, v = _qkv(B, S, H, KV, hd, seed=S + H, dtype=dtype)
    got = ref.flash_attention_plain(_torch(q, dtype), _torch(k, dtype),
                                    _torch(v, dtype), causal=causal)
    G = H // KV
    want = jax_ref.flash_attention_ref(
        _jax(q, dtype), jnp.repeat(_jax(k, dtype), G, axis=2),
        jnp.repeat(_jax(v, dtype), G, axis=2), causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, hd)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_kernel_in_interpret_mode(causal):
    """Against the TPU kernel itself, run by the Pallas interpreter."""
    q, k, v = _qkv(1, 128, 2, 2, 64, seed=0, dtype="float32")
    got = ref.flash_attention_plain(*(torch.tensor(x) for x in (q, k, v)),
                                    causal=causal)
    want = jax_ops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=causal, block_q=64, block_k=64)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("S,chunk", [(64, 64), (150, 64), (200, 512)])
def test_flash_plain_matches_chunked_attention_in_f32(S, chunk):
    """In f32 chunked attention rounds P to f32 (no rounding), so the two
    attentions the port runs (chunked in training, K7 in prefill) agree up
    to the order of the sums."""
    q, k, v = (torch.tensor(x) for x in
               _qkv(2, S, 6, 2, 64, seed=S, dtype="float32"))
    _close(ref.flash_attention_plain(q, k, v),
           layers.chunked_attention(q, k, v, chunk=chunk).numpy(),
           TOL["float32"])


@pytest.mark.parametrize("B,S,H,KV,hd,chunk", [
    (2, 64, 3, 1, 64, 64),     # the smoke config's heads
    (1, 150, 6, 2, 64, 64),    # ragged S over several chunks, GQA 3
    (1, 100, 4, 2, 32, 512),   # hd 32, one chunk
    (1, 37, 4, 4, 128, 16),    # hd 128, no GQA
])
def test_flash_plain_round_p_matches_chunked_attention_in_bf16(B, S, H, KV,
                                                               hd, chunk):
    """The P-rounding plain version (K7's bf16 tensor-core route) against
    the reference's chunked attention in bf16, which rounds P to bf16 too
    (normalised, after the softmax, where K7 rounds it unnormalised):
    within the bf16 tolerance."""
    q, k, v = _qkv(B, S, H, KV, hd, seed=S + hd, dtype="bfloat16")
    got = ref.flash_attention_plain(_torch(q, "bfloat16"),
                                    _torch(k, "bfloat16"),
                                    _torch(v, "bfloat16"), round_p=True)
    want = jax_layers.chunked_attention(_jax(q, "bfloat16"),
                                        _jax(k, "bfloat16"),
                                        _jax(v, "bfloat16"), chunk=chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, hd)
    _close(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 64, 3, 1, 64), (1, 100, 6, 2, 32), (1, 37, 4, 4, 128),
    (2, 130, 15, 5, 64),
])
def test_flash_plain_round_p_within_tol_of_f32_p(B, S, H, KV, hd, causal):
    """Rounding P to bf16 moves the bf16 output by well under the 2e-2 the
    card holds K7 to against the f32-P oracle; the default keeps f32 P."""
    q, k, v = (_torch(x, "bfloat16") for x in
               _qkv(B, S, H, KV, hd, seed=S + H, dtype="bfloat16"))
    f32_p = ref.flash_attention_plain(q, k, v, causal=causal)
    assert torch.equal(f32_p, ref.flash_attention_plain(
        q, k, v, causal=causal, round_p=False))
    got = ref.flash_attention_plain(q, k, v, causal=causal, round_p=True)
    _close(got, f32_p.float().numpy(), TOL["bfloat16"])


def test_flash_wrapper_on_cpu_rounds_p_in_bf16_only():
    """On CPU tensors the wrapper runs the plain version of the route the
    card would take: P rounded for bf16 inputs, f32 P for f32 inputs."""
    q, k, v = (torch.tensor(x) for x in
               _qkv(1, 70, 3, 1, 64, seed=2, dtype="bfloat16"))
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    assert torch.equal(ops.flash_attention(qb, kb, vb),
                       ref.flash_attention_plain(qb, kb, vb, round_p=True))
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.flash_attention_plain(q, k, v))


def test_flash_wrapper_on_cpu_runs_the_plain_version_without_a_launch():
    q, k, v = (torch.tensor(x) for x in
               _qkv(1, 70, 3, 1, 64, seed=1, dtype="float32"))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v)
    assert ops.launches["flash_attention"] == 0
    assert torch.equal(got, ref.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("bad,match", [
    ({"hd": 48}, "head dim"),
    ({"KV": 2}, "KV dividing H"),
    ({"dtype": torch.float16}, "dtype"),
    ({"k_dtype": torch.float32}, "dtype"),
    ({"k_len": 8}, "shape"),
    ({"noncontig": True}, "contiguous"),
])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    hd, H, KV = bad.get("hd", 64), 3, bad.get("KV", 1)
    dt = bad.get("dtype", torch.bfloat16)
    q = torch.zeros(1, 16, H, hd, dtype=dt)
    k = torch.zeros(1, bad.get("k_len", 16), KV, hd,
                    dtype=bad.get("k_dtype", dt))
    v = torch.zeros_like(k)
    if bad.get("noncontig"):
        q = torch.zeros(1, H, 16, hd, dtype=dt).transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,pos", [(16, 0), (16, 9), (33, 32)])
def test_decode_attention_matches_reference(dtype, S, pos):
    """The port's decode_attention against the reference's: f32 scores over
    slots <= pos, P in the cache's dtype. Slots past pos hold junk that
    must not count."""
    B, H, KV, hd = 2, 3, 1, 64
    rng = np.random.RandomState(S + pos)
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    kc, vc = (rng.randn(B, S, KV, hd).astype(np.float32) for _ in range(2))
    got = layers.decode_attention(torch.tensor(q).to(getattr(torch, dtype)),
                                  _torch(kc, dtype), _torch(vc, dtype), pos)
    want = jax_layers.decode_attention(
        _jax(q, dtype), _jax(kc, dtype), _jax(vc, dtype),
        jnp.asarray(pos, jnp.int32))
    assert got.shape == (B, 1, H, hd)
    _close(got, want, TOL[dtype])
