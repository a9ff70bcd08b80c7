"""The bf16 SSD-scan backward kernels' plan (csrc/ssd_scan_bwd.cu) on the
CPU.

``ssd_bwd_plan`` states the tensor-core backward in plain PyTorch over
chunks of 64 positions: the in-chunk prefix sums of dt A in fp64; per
(chunk, head) the chunk's state contribution X'^T B (X' = x e^{cums_last -
cums_j} dt_j) and its part of the entering state's gradient dY'^T C (dY' =
dy e^{cums_i}); the two fp32 walks over chunks that give the state entering
each chunk (H) and the gradient of the state leaving it (G'); then per
(chunk, head) the outputs from 64 x 64 tiles: C.B^T and dy.x^T, W = dy.x^T
dt_j e^{cums_i - cums_j} and M = C.B^T e^{cums_i - cums_j} (j <= i),

    dx' = e^{cums_last - cums_j} B.G'^T + M^T.dy
    dB  = sum_h [ e^{cums_last - cums_j} dt_j x.G' + W^T.C ]
    dC  = sum_h [ e^{cums_i} dy.H + W.B ]

with the sums that feed da, ddt and dA in fp64 as the kernel takes them.
On bf16 inputs it rounds to bf16 exactly where the kernels do: x, dy, B
and C are exact bf16; the fp32 operands X', dY', W and M go in as hi/lo
pairs (hi = bf16(v), lo = bf16(v - hi), two products into one fp32
accumulator); H and G' as one bf16 plane each (``ROUND_ONCE``: half the
bytes the walks write and the output launch reads); the products sum in
fp32; the outputs are rounded once, at the store. The choices the kernels
did not take are a keyword argument. Left out, each 2^-22 or smaller: the
walk adds a chunk's products onto the scaled carry inside the tensor cores
(here the contribution is summed first), the decays of W and M are
ex2.approx, and the fp64 sums take products rounded to fp32.

It is held to ``jax.grad`` through ``repro.models.mamba.ssd_chunked`` (the
function JAX trains through, over chunks of 64 on inputs zero-padded to
``SP`` positions, one compile a width) on the same numpy-seeded
bf16-valued inputs in fp32, under the
card's bf16 gradient rule (``BWD_TOLS["bf16"]``: each gradient within 1e-2
of its largest entry plus 1e-2 of itself elementwise, and within 1e-2 in
the 2-norm) at mamba2-130m's widths with its 24 heads (dB and dC sum over
the heads, so fewer heads understate the rounding), jamba-v0.1-52b's d_state
16, and under strong decay, at lengths on and beside the chunk's edges.
``test_rounding_once_readings_at_the_model_widths`` keeps the readings that
settled the rounding points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro.models.mamba import ssd_chunked  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

L = 64  # the kernels' chunk of positions
BWD_TOLS = {"bf16": (1e-2, 1e-2, 1e-2)}
NAMES = ("dx", "ddt", "dA", "dB", "dC")
# (nh, hd, ds): mamba2-130m's and jamba-v0.1-52b's SSD widths; jamba's 128
# heads cut to 8 (its products sum over 16 state columns, so the heads'
# rounding does not add up through a 128-term product as mamba2's does)
MAMBA2 = (24, 64, 128)
JAMBA = (8, 64, 16)
# the operands the kernels round to bf16 once instead of carrying as a
# hi/lo pair: the scratch states H and G' (their bytes bound the backward)
ROUND_ONCE = frozenset({"h", "g"})
ALL_OPERANDS = ("xs", "dys", "h", "g", "w", "m")


def ssd_bwd_plan(x, dt, A, B, C, dy, *, once=ROUND_ONCE):
    """The kernels' plan. x, dy: [b,S,nh,hd] bf16 (or fp32: nothing is
    rounded); dt: [b,S,nh] fp32; A: [nh] fp32; B, C: [b,S,1,ds] in x's
    dtype. Returns (dx, ddt, dA, dB, dC) in the kernel's output dtypes.
    ``once``: the operands of ALL_OPERANDS rounded to bf16 once; the
    others go in as hi/lo pairs. Positions past S are zeros with dt = 0, as
    the kernels load them."""
    if x.dtype == torch.bfloat16:
        def rnd(t):
            return t.to(torch.bfloat16).float()
    else:
        def rnd(t):
            return t

    def op(t, name):  # an fp32 operand as the kernel feeds it to a product
        hi = rnd(t)
        return hi if name in once else hi + rnd(t - hi)

    b, S, nh, hd = x.shape
    ds = B.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S
    xf, dyf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, L, nh, hd)
               for t in (x, dy))
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(b, nc, L, nh)
    Bf, Cf = (F.pad(t[:, :, 0].float(), (0, 0, 0, pad)).reshape(b, nc, L, ds)
              for t in (B, C))
    cums = torch.cumsum(dtf.double() * A.double(), dim=2)  # fp64 [b,nc,L,nh]
    cl = cums[:, :, -1:]
    ec = torch.exp(cums.float())  # e^{cums_i}
    we = torch.exp((cl - cums).float())  # e^{cums_last - cums_j}
    decay = torch.exp(cl[:, :, 0].float())  # [b,nc,nh]

    # launch 1: each chunk's state contribution and its part of the
    # entering state's gradient, [hd, ds] fp32 per (chunk, head)
    Xp = op(xf * (we * dtf)[..., None], "xs")
    Yp = op(dyf * ec[..., None], "dys")
    states = torch.einsum("bclhp,bcls->bchps", Xp, Bf)
    grads = torch.einsum("bclhp,bcls->bchps", Yp, Cf)

    # launch 2: the two fp32 walks; H (entering) and G' (the leaving
    # state's gradient) as the output launch's operands
    H = torch.zeros_like(states)
    G = torch.zeros_like(grads)
    carry = torch.zeros_like(states[:, 0])
    for c in range(nc):
        H[:, c] = carry
        carry = carry * decay[:, c, :, None, None] + states[:, c]
    carry = torch.zeros_like(carry)
    for c in reversed(range(nc)):
        G[:, c] = carry
        carry = carry * decay[:, c, :, None, None] + grads[:, c]
    Ho, Go = op(H, "h"), op(G, "g")

    # launch 3: per (chunk, head) the 64 x 64 tiles and the outputs
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    cb = torch.einsum("bcis,bcjs->bcij", Cf, Bf)[:, :, None]  # [b,nc,1,i,j]
    dyx = torch.einsum("bcihp,bcjhp->bchij", dyf, xf)
    cs = cums.transpose(2, 3)  # [b,nc,nh,L] fp64
    dcy = torch.where(causal, torch.exp((cs[..., :, None] - cs[..., None, :])
                                        .float()), torch.zeros(()))
    dtj = dtf.transpose(2, 3)[..., None, :]  # [b,nc,nh,1,j]
    W = dyx * dtj * dcy
    M = cb * dcy
    T = (W.double() * cb.double())
    rows, cols = T.sum(-1), T.sum(-2)  # [b,nc,nh,L]
    Wo, Mo = op(W, "w"), op(M, "m")
    wej = we.transpose(2, 3)[..., None]  # [b,nc,nh,j,1]
    eci = ec.transpose(2, 3)[..., None]
    bg = torch.einsum("bcjs,bchps->bchjp", Bf, Go)
    dxp = wej * bg + torch.einsum("bchij,bcihp->bchjp", Mo, dyf)
    xj = xf.permute(0, 1, 3, 2, 4)  # [b,nc,nh,j,p]
    dtj1 = dtf.transpose(2, 3)[..., None]
    V = ((xj * dtj1).double() * (wej * bg).double()).sum(-1)
    xdx = (xj.double() * dxp.double()).sum(-1).float()
    dB = ((wej * dtj1) * torch.einsum("bchjp,bchps->bchjs", xj, Go)
          + torch.einsum("bchij,bcis->bchjs", Wo, Cf)).sum(2)
    inter = eci * torch.einsum("bcihp,bchps->bchis", dyf, Ho)
    U = (Cf[:, :, None].double() * inter.double()).sum(-1)  # [b,nc,nh,L]
    dC = (inter + torch.einsum("bchij,bcjs->bchis", Wo, Bf)).sum(2)
    gh = (Go.double() * Ho.double()).sum((-1, -2))  # [b,nc,nh]
    grad_cums = rows - cols + U - V  # [b,nc,nh,L]
    grad_cums[..., -1] += decay.double() * gh + V.sum(-1)
    da = grad_cums.flip(-1).cumsum(-1).flip(-1)
    ddt = (xdx.double() + A.double()[:, None] * da).float()
    dA = (dtf.transpose(2, 3).double() * da).sum((0, 1, 3)).float()
    dx = (dtj1 * dxp).permute(0, 1, 3, 2, 4).reshape(b, nc * L, nh, hd)[:, :S]
    ddt = ddt.permute(0, 1, 3, 2).reshape(b, nc * L, nh)[:, :S]
    dB, dC = (t.reshape(b, nc * L, 1, ds)[:, :S] for t in (dB, dC))
    return (dx.to(x.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype))


def _inputs(b, S, widths, decay, seed):
    """Seeded numpy inputs (x, B, C, dy normal and rounded to bf16 values;
    dt = |N| 0.1 + 0.01, A = -|N| - 0.1, or under strong decay dt = |N| 0.5
    + 0.5, A = -|N| - 1, as the card's cases: dt A near -2 a step)."""
    nh, hd, ds = widths
    rng = np.random.default_rng(seed)

    def bf(shape):
        return np.asarray(torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).float())

    x, dy = bf((b, S, nh, hd)), bf((b, S, nh, hd))
    B, C = bf((b, S, 1, ds)), bf((b, S, 1, ds))
    dt = np.abs(rng.standard_normal((b, S, nh))).astype(np.float32)
    A = np.abs(rng.standard_normal(nh)).astype(np.float32)
    if decay == "strong":
        return x, dt * 0.5 + 0.5, -A - 1.0, B, C, dy
    return x, dt * 0.1 + 0.01, -A - 0.1, B, C, dy


SP = 320  # the JAX oracle's padded length: every case's S fits it
_grads: dict = {}


def _jax_grad_fn(b, widths):
    """jax.jit of jax.grad through ssd_chunked over chunks of 64 on inputs
    zero-padded to SP positions, dy zero past S: the gradients before S do
    not see the pad (the scan is causal and nothing reads the padded y),
    and those past S are cut. One compile per (b, widths)."""
    key = (b, widths)
    if key not in _grads:
        def f(x, dt, A, B, C, dy):
            y, _ = ssd_chunked(x, dt, A, B, C, L)
            return jnp.sum(y * dy)

        _grads[key] = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))
    return _grads[key]


_want: dict = {}


def _jax_grad(case):
    """jax.grad through ssd_chunked in fp32 on the case's inputs; once per
    case."""
    if case not in _want:
        x, dt, A, B, C, dy = _inputs(*case)
        b, S = x.shape[:2]
        x, B, C, dy = (np.pad(t, ((0, 0), (0, SP - S), (0, 0), (0, 0)))
                       for t in (x, B, C, dy))
        dt = np.pad(dt, ((0, 0), (0, SP - S), (0, 0)))
        want = _jax_grad_fn(b, case[2])(x, dt, A, B, C, dy)
        _want[case] = [torch.from_numpy(np.array(w)) for w in want]
        for i in (0, 1, 3, 4):
            _want[case][i] = _want[case][i][:, :S]
    return _want[case]


def _plan(case, **kw):
    x, dt, A, B, C, dy = (torch.from_numpy(t) for t in _inputs(*case))
    bf = torch.bfloat16
    return ssd_bwd_plan(x.to(bf), dt, A, B.to(bf), C.to(bf), dy.to(bf), **kw)


def _shares(got, want):
    """Per gradient: (the largest share of the elementwise limit, the norm
    error over its limit) under BWD_TOLS["bf16"] (the card tests'
    ``_close_grads`` rule: a gradient that is 0 in exact arithmetic, dA at
    S = 1, takes the case's largest entry and norm)."""
    atol, rtol, ntol = BWD_TOLS["bf16"]
    want = [w.float() for w in want]
    top = max(float(w.abs().max()) for w in want)
    top_norm = max(float(w.norm()) for w in want)
    out = {}
    for name, g, w in zip(NAMES, got, want):
        err = (g.float() - w).abs()
        lim = atol * (float(w.abs().max()) or top) + rtol * w.abs()
        out[name] = (float((err / lim).max()),
                     float(err.norm()) / (float(w.norm()) or top_norm) / ntol)
    return out


CASES = [  # (b, S, widths, decay, seed): two batch rows throughout
    *((2, S, MAMBA2, "normal", S) for S in (1, 63, 64, 65, 257)),
    *((2, S, JAMBA, "normal", S) for S in (1, 65, 257)),
    (2, 257, MAMBA2, "strong", 5),
    (2, 65, JAMBA, "strong", 6),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    map(str, (c[0], c[1], c[2][2], c[3]))))
def test_plan_matches_jax_grad(case):
    """Every gradient of the plan within the card's bf16 rule of jax.grad,
    with the output dtypes the kernel writes."""
    got = _plan(case)
    x = _inputs(*case)[0]
    for g, want_dtype in zip(got, (torch.bfloat16, torch.float32,
                                   torch.float32, torch.bfloat16,
                                   torch.bfloat16)):
        assert g.dtype == want_dtype and torch.isfinite(g.float()).all()
    assert got[0].shape == x.shape
    for name, (elem, norm) in _shares(got, _jax_grad(case)).items():
        assert elem <= 1.0 and norm <= 1.0, (case, name, elem, norm)


def test_plan_without_rounding_is_the_function():
    """On fp32 inputs the plan rounds nothing: it is jax.grad's function
    up to fp32 reassociation (1e-5 of each gradient's largest entry)."""
    case = (1, 130, (2, 64, 128), "normal", 11)
    x, dt, A, B, C, dy = (torch.from_numpy(t) for t in _inputs(*case))
    got = ssd_bwd_plan(x, dt, A, B, C, dy)
    for name, g, w in zip(NAMES, got, _jax_grad(case)):
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)


def test_plan_rounds_where_the_kernels_do():
    """The rounding points are live: each operand moves some gradient when
    it is rounded once where the plan pairs it, or paired where the plan
    rounds it once; a hi/lo pair carries an fp32 value to about 16 bits."""
    case = CASES[4]
    base = _plan(case)
    for name in ALL_OPERANDS:
        other = _plan(case, once=ROUND_ONCE ^ {name})
        assert any(not torch.equal(a, c) for a, c in zip(base, other)), name
    g = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
    hi = g.to(torch.bfloat16).float()
    lo = (g - hi).to(torch.bfloat16).float()
    assert float((hi + lo - g).abs().max()) <= float(g.abs().max()) * 2 ** -16


def test_rounding_once_readings_at_the_model_widths():
    """The readings that settled the rounding points, at mamba2-130m's 24
    heads (S = 257, two batch rows): the largest share of the bf16 limit
    over the five gradients. No single rounding misses: with every operand
    as a pair the outputs' own bf16 rounding sets 0.166; H and G' rounded
    once (the kernels' choice, half the scratch bytes) 0.181; every fp32
    operand rounded once 0.247. The pairs of X', dY', W and M cost
    tensor-core products, which are far from the bound, and no bytes."""
    case = CASES[4]
    want = _jax_grad(case)

    def worst(once):
        return max(max(v) for v in _shares(_plan(case, once=once),
                                           want).values())

    assert worst(frozenset()) < 0.2
    assert worst(ROUND_ONCE) < 0.2
    assert 0.2 < worst(frozenset(ALL_OPERANDS)) < 0.3


@pytest.mark.parametrize("n_chunks,nh,n_sm,want", [
    (512, 24, 132, 24),  # mamba2-130m [8, 4096]: 512 CTAs of 24 heads
    (128, 128, 132, 64),  # jamba [2, 4096]: 256 CTAs
    (16, 24, 132, 2),  # [1, 1000]: 192 CTAs
    (1, 24, 132, 1),  # one chunk: 24 CTAs
    (1, 128, 132, 1),  # jamba, one chunk: 128 CTAs
])
def test_bwd_heads_per_cta(n_chunks, nh, n_sm, want):
    """The output launch's heads a CTA: the most that divide the heads and
    still give every SM a CTA."""
    assert ssd.bwd_heads_per_cta(n_chunks, nh, n_sm) == want


def test_bwd_scratch_bytes():
    """Scratch of the backward at mamba2-130m's [8, 4096] (one group of 24
    heads): bf16 holds H and G' as one bf16 plane each (403 MB together),
    fp32 the chunk contributions in fp32 and the decays; both the dB/dC
    partials and the dA parts."""
    b, S, nh, hd, ds = 8, 4096, 24, 64, 128
    nc = S // 64
    state = b * nc * nh * hd * ds
    rest = 2 * 4 * b * S * ds + 8 * b * nc * nh
    assert ssd.bwd_scratch_bytes(b, S, nh, hd, ds, "bf16") == (
        2 * 2 * state + rest)
    assert 2 * 2 * state == 402_653_184
    assert ssd.bwd_scratch_bytes(b, S, nh, hd, ds, "fp32") == (
        2 * 4 * state + 4 * b * nc * nh + rest)
