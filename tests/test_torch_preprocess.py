"""Port preprocess (TPU kernel 6, ``preprocess_2d``) vs the JAX package.

The plain version ``ref.preprocess_ref`` is held against JAX's
``ops.preprocess`` (the Pallas kernel in interpret mode) and JAX's oracle
``ref.preprocess_ref`` on the same seeded numpy inputs, at
tests/test_kernels.py's shapes and the paper's camera frames, in bf16 and
fp32. bf16: atol 1e-2 / rtol 1e-2, as tests/test_kernels.py holds the
Pallas kernel. fp32: the plain version equals JAX's oracle bit for bit (both
divide by 255); the Pallas kernel multiplies by fp32(1/255) instead, which
moves x/255 by at most one fp32 rounding step (6e-8 for x <= 1), and
dividing by std >= 0.3 leaves a gap under FP32_GAP = 5e-7, the bound held
here (measured: 2.4e-7 at every shape, one ulp of outputs near 2). The
Triton kernel is held against the plain version on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
FP32_GAP = 5e-7
SHAPES = [(8, 128), (100, 512), (1000, 64), (2, 48, 64, 3)]


def _inputs(shape, seed=0):
    """uint8 features and positive per-feature mean/std, as
    tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x = rng.integers(0, 256, shape).astype(np.uint8)
    mean = (np.abs(rng.normal(size=D)) * 0.4 + 0.1).astype(np.float32)
    std = (np.abs(rng.normal(size=D)) * 0.2 + 0.3).astype(np.float32)
    return x, mean, std


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_preprocess_matches_jax(shape, dtype):
    x, mean, std = _inputs(shape)
    got = ops.preprocess(torch.from_numpy(x), torch.from_numpy(mean),
                         torch.from_numpy(std), out_dtype=TDT[dtype])
    assert got.shape == x.shape and got.dtype == TDT[dtype]
    got = got.float().numpy()
    jx, jm, js = jnp.asarray(x), jnp.asarray(mean), jnp.asarray(std)
    kernel = np.asarray(jops.preprocess(jx, jm, js, out_dtype=JDT[dtype],
                                        interpret=True).astype(jnp.float32))
    oracle = np.asarray(jref.preprocess_ref(
        jx.reshape(-1, shape[-1]), jm, js, out_dtype=JDT[dtype])
        .astype(jnp.float32)).reshape(shape)
    if dtype == "bf16":
        np.testing.assert_allclose(got, kernel, atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(got, oracle, atol=1e-2, rtol=1e-2)
    else:
        np.testing.assert_array_equal(got, oracle)
        assert np.abs(got - kernel).max() <= FP32_GAP


def test_preprocess_on_cpu_counts_no_launch_and_rejects_bad_shapes():
    x, mean, std = _inputs((16, 3))
    ops.reset_launches()
    ops.preprocess(torch.from_numpy(x), torch.from_numpy(mean),
                   torch.from_numpy(std))
    assert ops.LAUNCHES["preprocess"] == 0
    with pytest.raises(ValueError):
        ops.preprocess(torch.from_numpy(x), torch.from_numpy(mean[:2]),
                       torch.from_numpy(std))


def test_plain_preprocess_is_the_oracle_formula():
    x, mean, std = _inputs((5, 7), seed=3)
    got = ref.preprocess_ref(torch.from_numpy(x), torch.from_numpy(mean),
                             torch.from_numpy(std), torch.float32)
    want = (x.astype(np.float32) / np.float32(255.0) - mean) / std
    np.testing.assert_array_equal(got.numpy(), want)
