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

The bf16 flash backward kernel rounds P and dS to bf16 as the operands of
its tensor-core products; :func:`_bwd_bf16_operands` does the same
arithmetic on the CPU, and it is held to ``jax.grad`` under the card
tests' bf16 gradient rule, so the rounding plan fits that gate.
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


# the card tests' bf16 gradient rule (tests/test_torch_cuda.py BWD_TOLS,
# chip_smoke.py grad_errs): |got - want| <= atol * max|want| + rtol * |want|
# elementwise and <= ntol * |want| in the 2-norm, each gradient on its own
BWD_BF16_TOLS = (1e-2, 1e-2, 1e-2)


def _bwd_bf16_operands(q, k, v, do, *, causal, window=0):
    """The flash backward as the bf16 tensor-core kernel computes it, on
    bf16 q, k, v, do: O rounded to bf16 by the forward (``ref``'s output),
    fp32 lse, D = rowsum(dO o O), P and dS = P o (dP - D) from fp32 sums,
    then rounded to bf16 as the A operands of dV = P^T dO, dK = dS^T Q and
    dQ = dS K (fp32 sums), the gradients rounded to bf16 once."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5

    def bf(t):
        return t.to(torch.bfloat16).float()

    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window).float()
    q, k, v, do = (t.float() for t in (q, k, v, do))
    kh, vh = (t.repeat_interleave(G, dim=2) for t in (k, v))
    qi = torch.arange(Sq)[:, None]
    ki = torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= ki > qi - window
    s = torch.einsum("bqhd,bkhd->bhqk", q, kh) * scale
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1, True)
    p = torch.exp(s - lse) * mask
    d = torch.einsum("bqhd,bqhd->bhq", do, o)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vh) - d)
    p, ds = bf(p), bf(ds)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh) * scale
    dk, dv = (t.reshape(B, Skv, Hkv, G, hd).sum(3) for t in (dk, dv))
    return bf(dq), bf(dk), bf(dv)


def test_flash_bwd_bf16_operand_rounding_fits_the_card_gate():
    """[1, 512, 4/1, 128] causal: the bf16 kernel's rounding of P and dS,
    emulated on the CPU, against jax.grad through chunked_attention on the
    same bf16 values, each gradient under the card's bf16 rule."""
    B, S, H, Hkv, hd = 1, 512, 4, 1, 128
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32))
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, hd), np.float32))
            .to(torch.bfloat16) for _ in range(2))
    got = _bwd_bf16_operands(q, k, v, do, causal=True)
    jq, jk, jv, jdo = (t.float().numpy() for t in (q, k, v, do))

    def f(q, k, v):
        return jnp.sum(chunked_attention(q, k, v, causal=True) * jdo)

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    atol, rtol, ntol = BWD_BF16_TOLS
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.from_numpy(np.array(w))
        err = (g - w).abs()
        lim = atol * float(w.abs().max()) + rtol * w.abs()
        assert (err <= lim).all(), (name, float((err / lim).max()))
        rel = float(err.norm()) / float(w.norm())
        assert rel <= ntol, (name, rel)
