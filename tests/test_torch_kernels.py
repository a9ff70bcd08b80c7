"""Port kernels: each plain PyTorch version held against the JAX package's
Pallas kernel wrapper (interpret mode on the CPU) on the same seeded numpy
inputs, and the dispatch rules of ``repro_torch.kernels.ops``. The
hand-written kernels themselves are held against these plain versions on
the card by tests/test_torch_cuda.py.

Tolerances follow tests/test_kernels.py: fp32 atol 2e-5, bf16 atol 2e-2,
rtol 1e-2. The two sides sum in different orders (the Pallas kernel blocks
the online softmax over KV tiles and rounds P to the value dtype before
P.V; the plain version takes one fp32 softmax), which is what the
tolerances cover."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOLS = {"fp32": 2e-5, "bf16": 2e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def pair(rng, shape, dtype):
    """The same seeded values as a JAX array and a CPU torch tensor."""
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def close(got, want_jax, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want_jax.astype(jnp.float32)),
        atol=TOLS[dtype], rtol=1e-2)


# --------------------------------------------------------------------------- #
# plain versions vs the JAX kernels (interpret mode)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N,D", [(16, 128), (257, 384)])
def test_rmsnorm_plain_matches_jax_kernel(dtype, N, D):
    rng = np.random.default_rng(0)
    xj, xt = pair(rng, (N, D), dtype)
    wj, wt = pair(rng, (D,), dtype)
    close(ops.rmsnorm(xt, wt), jops.rmsnorm(xj, wj), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize(
    "B,Sq,Skv,H,Hkv,hd,causal,window",
    [
        (1, 128, 128, 4, 4, 64, True, 0),  # MHA, block-aligned
        (2, 200, 200, 8, 2, 64, True, 64),  # GQA, ragged, sliding window
        (1, 64, 256, 4, 1, 32, False, 0),  # MQA, cross-length
        (2, 33, 33, 6, 3, 128, True, 0),  # odd sizes
    ],
)
def test_flash_plain_matches_jax_kernel(dtype, B, Sq, Skv, H, Hkv, hd,
                                        causal, window):
    rng = np.random.default_rng(1)
    qj, qt = pair(rng, (B, Sq, H, hd), dtype)
    kj, kt = pair(rng, (B, Skv, Hkv, hd), dtype)
    vj, vt = pair(rng, (B, Skv, Hkv, hd), dtype)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    close(got, jops.flash_attention(qj, kj, vj, causal=causal, window=window),
          dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_plain_segment_ids_match_jax_kernel(dtype):
    """Packed prefill: three segments and a pad tail (id -1) in one row."""
    rng = np.random.default_rng(2)
    B, S, H, Hkv, hd = 2, 48, 4, 2, 32
    seg = np.full((B, S), -1, np.int32)
    seg[0, :7], seg[0, 7:19], seg[0, 19:40] = 0, 1, 2
    seg[1, :30], seg[1, 30:48] = 0, 1
    qj, qt = pair(rng, (B, S, H, hd), dtype)
    kj, kt = pair(rng, (B, S, Hkv, hd), dtype)
    vj, vt = pair(rng, (B, S, Hkv, hd), dtype)
    got = ops.flash_attention(qt, kt, vt, causal=True,
                              segment_ids=torch.from_numpy(seg))
    want = jops.flash_attention(qj, kj, vj, causal=True, block_q=16,
                                block_k=16, segment_ids=jnp.asarray(seg))
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize(
    "B,W,H,Hkv,hd,block_k",
    [
        (2, 300, 8, 2, 64, 128),
        (3, 64, 6, 1, 128, 512),
        (2, 1024, 16, 8, 32, 256),
    ],
)
def test_decode_plain_matches_jax_kernel(dtype, B, W, H, Hkv, hd, block_k):
    rng = np.random.default_rng(3)
    qj, qt = pair(rng, (B, 1, H, hd), dtype)
    kj, kt = pair(rng, (B, W, Hkv, hd), dtype)
    vj, vt = pair(rng, (B, W, Hkv, hd), dtype)
    lens = rng.integers(1, W + 1, (B,)).astype(np.int32)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    close(got, jops.decode_attention(qj, kj, vj, jnp.asarray(lens),
                                     block_k=block_k), dtype)


def test_decode_plain_zero_length_rows_are_zero_and_match_jax():
    """An empty slot (length 0) returns zeros, not NaN, on both sides."""
    rng = np.random.default_rng(4)
    B, W, H, Hkv, hd = 3, 64, 4, 2, 16
    qj, qt = pair(rng, (B, 1, H, hd), "fp32")
    kj, kt = pair(rng, (B, W, Hkv, hd), "fp32")
    vj, vt = pair(rng, (B, W, Hkv, hd), "fp32")
    lens = np.array([0, 5, 64], np.int32)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    assert torch.isfinite(got).all()
    assert (got[0] == 0).all()
    close(got, jops.decode_attention(qj, kj, vj, jnp.asarray(lens),
                                     block_k=16), "fp32")


# --------------------------------------------------------------------------- #
# dispatch rules
# --------------------------------------------------------------------------- #
def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launches()
    x = torch.randn(4, 32, 2, 16)
    k = torch.randn(4, 32, 1, 16)
    ops.rmsnorm(x, torch.ones(16))
    ops.flash_attention(x, k, k)
    ops.decode_attention(x[:, :1], k, k, torch.full((4,), 7, dtype=torch.int32))
    assert ops.LAUNCHES == {"rmsnorm": 0, "flash_attention": 0,
                            "decode_attention": 0}


def test_plain_versions_mask_past_real_lengths():
    """sq_real/skv_real/w_real mask like slicing the inputs down."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 20, 4, 16, generator=g)
    k = torch.randn(2, 20, 2, 16, generator=g)
    v = torch.randn(2, 20, 2, 16, generator=g)
    got = ref.flash_attention_ref(q, k, v, causal=False, sq_real=12,
                                  skv_real=15)
    want = ref.flash_attention_ref(q[:, :12], k[:, :15], v[:, :15],
                                   causal=False)
    torch.testing.assert_close(got[:, :12], want, atol=1e-6, rtol=0)
    assert (got[:, 12:] == 0).all()
    lens = torch.tensor([20, 9], dtype=torch.int32)
    d = ref.decode_attention_ref(q[:, :1], k, v, lens, w_real=11)
    dw = ref.decode_attention_ref(q[:, :1], k[:, :11], v[:, :11],
                                  torch.tensor([11, 9], dtype=torch.int32))
    torch.testing.assert_close(d, dw, atol=1e-6, rtol=0)


def test_bad_shapes_raise():
    x = torch.randn(2, 8, 4, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(x, torch.randn(2, 8, 3, 16), torch.randn(2, 8, 3, 16))
    with pytest.raises(ValueError):
        ops.decode_attention(x[:, :1], x, x, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.rmsnorm(x, torch.ones(8))
    with pytest.raises(ValueError):
        ops.flash_attention(x, x, x, segment_ids=torch.zeros(2, 7))
