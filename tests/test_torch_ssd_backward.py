"""The plain backward versions of the SSD scan and of MLA's flash attention,
against ``jax.grad`` through the JAX package's functions (fp32, CPU, the
same numpy inputs).

``ref.ssd_scan_bwd_ref`` is the oracle of the SSD-scan backward kernel
(``csrc/ssd_scan_bwd.cu``); here it equals ``jax.grad`` through
``src/repro/models/mamba.py`` ``ssd_chunked`` -- the function the JAX model
trains through, padded to a whole chunk as ``mamba_forward`` pads it --
for d_state 16 and 128, head dims 32 and 64, a ragged last chunk, a
sequence shorter than one chunk, two batch rows and strong decay. The
kernel rounds no operand (bf16 inputs are widened and every product and
sum runs in fp32 or fp64), so no bf16 emulation stands beside it.

``ref.flash_attention_bwd_ref`` at MLA's head dims (q/k wider than v, as
deepseek-v2's 192 and 128, here at CPU size) equals ``jax.grad`` through
``models/attention.py`` ``chunked_attention`` with v zero-padded to q's
head dim and the output cut back to v's, as the JAX MLA prefill runs it;
dv's first columns are compared.

Tolerance: each gradient within 1e-5 of its largest entry (fp32, two
frameworks' reassociation), but dA under strong decay: STRONG_DA_TOL,
stated with its reason.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import chunked_attention  # noqa: E402
from repro.models.mamba import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-5
# dA under strong decay: both sides sum dt A within a chunk in fp32, and
# with A dt near -2 a step those sums reach -100 and more, so each side's
# dA sits 1e-5 to 2e-5 of its largest entry from the port's plain version
# run in float64 (``compute=torch.float64``): JAX 2.1e-5 and the port
# 1.4e-5 on the first strong case below, 8.2e-6 and 6.1e-6 on the second;
# their other gradients stay within 6e-6 of it
STRONG_DA_TOL = 5e-5

# (b, S, nh, hd, ds, chunk, decay): S ragged against the chunk, S below
# one chunk, strong decay (dt about 0.9, A about -1.8: A dt near -2 a step)
SSD_CASES = [
    (2, 100, 3, 32, 16, 32, "normal"),
    (2, 100, 2, 64, 128, 64, "normal"),
    (1, 40, 2, 32, 128, 64, "normal"),
    (2, 20, 4, 64, 16, 32, "normal"),
    (2, 96, 3, 32, 16, 32, "strong"),
    (1, 130, 2, 64, 128, 64, "strong"),
]


def _close(got, want, what, tol=TOL):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _ssd_inputs(b, S, nh, hd, ds, decay, seed=0):
    rng = np.random.default_rng(seed)
    x, dy = (rng.standard_normal((b, S, nh, hd)).astype(np.float32)
             for _ in range(2))
    B, C = (rng.standard_normal((b, S, 1, ds)).astype(np.float32)
            for _ in range(2))
    dt = np.abs(rng.standard_normal((b, S, nh))).astype(np.float32)
    A = -np.abs(rng.standard_normal(nh)).astype(np.float32)
    if decay == "strong":
        dt, A = dt * 0.5 + 0.5, A - 1.0
    else:
        dt, A = dt * 0.1 + 0.01, A - 0.1
    return x, dt, A, B, C, dy


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_bwd_ref_matches_jax_grad(case):
    b, S, nh, hd, ds, chunk, decay = case
    x, dt, A, B, C, dy = _ssd_inputs(b, S, nh, hd, ds, decay)
    got = ref.ssd_scan_bwd_ref(*(torch.from_numpy(t)
                                 for t in (x, dt, A, B, C, dy)), chunk)
    # the CPU op is the plain version: the same gradients through autograd
    ins = [torch.from_numpy(t).requires_grad_(True) for t in (x, dt, A, B, C)]
    y, _ = ops.ssd_scan(*ins, chunk=chunk)
    via_op = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    for a, c in zip(got, via_op):
        assert torch.equal(a, c)

    L = min(chunk, S)
    pad = (-S) % L

    def f(x, dt, A, B, C):
        # mamba_forward's rule: zero-pad to a whole chunk, cut y back
        x, B, C = (jnp.pad(t, ((0, 0), (0, pad), (0, 0), (0, 0)))
                   for t in (x, B, C))
        dt = jnp.pad(dt, ((0, 0), (0, pad), (0, 0)))
        y, _ = ssd_chunked(x, dt, A, B, C, L)
        return jnp.sum(y[:, :S] * dy)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(x, dt, A, B, C)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == torch.float32
        strong_da = name == "dA" and decay == "strong"
        _close(g, w, f"{name} {case}", STRONG_DA_TOL if strong_da else TOL)


# (B, S, H, hd, hdv, causal)
MLA_CASES = [
    (2, 16, 4, 48, 32, True),
    (1, 24, 2, 48, 32, False),
    (1, 20, 2, 24, 16, True),
]


@pytest.mark.parametrize("case", MLA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_ref_at_mla_head_dims_matches_jax_grad(case):
    B, S, H, hd, hdv, causal = case
    rng = np.random.default_rng(2)
    q, k = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((B, S, H, hdv)).astype(np.float32)
             for _ in range(2))
    scale = hd ** -0.5
    got = ref.flash_attention_bwd_ref(
        *(torch.from_numpy(t) for t in (q, k, v, do)), causal=causal,
        scale=scale)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]

    def f(q, k, v):
        vp = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, hd - hdv)))
        o = chunked_attention(q, k, vp, causal=causal, q_chunk=4096,
                              scale=scale)
        return jnp.sum(o[..., :hdv] * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    _close(got[0], want[0], f"dq {case}")
    _close(got[1], want[1], f"dk {case}")
    _close(got[2], np.asarray(want[2])[..., :hdv], f"dv {case}")
