"""The plain backward versions the port's backward kernels are held against
on the card, against JAX on the CPU (the same numpy inputs).

``ref.flash_attention_bwd_ref`` equals ``jax.grad`` through the JAX
package's jnp attention (``models/attention.py`` ``chunked_attention``,
which the JAX model trains through) under GQA, causal and not, a window,
Sq != Skv and pads (JAX has no pad arguments: its side runs on the
unpadded rows and keys, and the port's rows past ``sq_real`` must get zero
gradients); ``ref.rmsnorm_bwd_ref`` equals ``jax.grad`` through
``models/layers.py`` ``rmsnorm``. Tolerances: fp32 at 1e-5 of each
gradient's largest entry (reassociation); bf16 rmsnorm at 1e-2 (the two
frameworks sum dw's rows in different precisions before the one rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import chunked_attention  # noqa: E402
from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"fp32": 1e-5, "bf16": 1e-2}

# (B, Sq, Skv, H, Hkv, hd, causal, window, sq_real, skv_real)
FLASH_CASES = [
    (2, 16, 16, 4, 2, 32, True, 0, None, None),
    (1, 20, 20, 4, 1, 16, True, 5, None, None),
    (2, 9, 13, 4, 4, 32, False, 0, None, None),
    (1, 12, 12, 2, 2, 16, False, 0, None, None),
    (2, 12, 12, 4, 2, 32, True, 0, 9, 7),
    (1, 10, 14, 4, 1, 16, False, 0, 8, 11),
]


def _close(got, want, tol, what):
    got = got.float().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_ref_matches_jax_grad(case):
    B, Sq, Skv, H, Hkv, hd, causal, window, sq_real, skv_real = case
    rng = np.random.default_rng(0)
    q, do = (rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, sq_real=sq_real,
              skv_real=skv_real)
    got = ref.flash_attention_bwd_ref(*(torch.from_numpy(t) for t in
                                        (q, k, v, do)), **kw)
    # the CPU op is the plain version: the same gradients through autograd
    qkv = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    via_op = torch.autograd.grad(ops.flash_attention(*qkv, **kw), qkv,
                                 torch.from_numpy(do))
    for a, b in zip(got, via_op):
        assert torch.equal(a, b)

    sq, skv = sq_real or Sq, skv_real or Skv

    def f(q, k, v):
        o = chunked_attention(q, k, v, causal=causal, window=window,
                              q_chunk=4096)
        return jnp.sum(o * do[:, :sq])

    want = jax.grad(f, argnums=(0, 1, 2))(q[:, :sq], k[:, :skv], v[:, :skv])
    for name, g, w, n in zip(("dq", "dk", "dv"), got, want, (sq, skv, skv)):
        w = np.asarray(w)
        _close(g[:, :n], w, TOL["fp32"], f"{name} {case}")
        assert (g[:, n:] == 0).all(), (name, case)  # pads get nothing


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N,D", [(5, 64), (3, 256)])
def test_rmsnorm_bwd_ref_matches_jax_grad(N, D, dtype):
    rng = np.random.default_rng(1)
    x, dy = (rng.standard_normal((N, D)).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tx, tw, tdy = (torch.from_numpy(a).to(tdt) for a in (x, w, dy))
    dx, dw = ref.rmsnorm_bwd_ref(tx, tw, tdy)
    assert dx.dtype == dw.dtype == tdt
    jx, jw, jdy = (jnp.asarray(a, jdt) for a in (x, w, dy))
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm(a, b), jx, jw)
    wdx, wdw = vjp(jdy)
    _close(dx, np.asarray(wdx, np.float32), TOL[dtype], "dx")
    _close(dw, np.asarray(wdw, np.float32), TOL[dtype], "dw")
