"""The rmsnorm backward kernel's plan (``kernels/rmsnorm.py`` ``bwd_plan``)
and its order of summation, on the CPU.

The plan is pinned at every width the configs train at, in bf16 and fp32,
on a card of 132 SMs and on a small one: the geometry fits the kernels'
limits, the grid never exceeds the row groups, the kernel's walk (each
group's rows a grid's groups apart, or a wide CTA's rows ``grid`` apart)
owns every row exactly once, every CTA walks rows (each writes one of the
grid's partial rows of dw), and warps walk the same number of rows to
within one.

:func:`kernel_order` states the kernel's arithmetic in plain PyTorch: each
row's dx from its recomputed r, and dw as the kernel sums it -- each
group's rows in walk order in fp32, the groups of a warp by the shuffle
butterfly, the warps in order, one partial row a CTA, then the partial rows
in slices of consecutive rows and the slices in order. It is held to
``ref.rmsnorm_bwd_ref`` and to ``jax.vjp`` through ``models/layers.py``
``rmsnorm`` (in fp32 on the bf16 cases' values: see :func:`jax_grads`) at
small N and D under ``tests/test_torch_backward_ref.py``'s tolerances (fp32
1e-5 of the largest entry, bf16 1e-2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

TOL = {"fp32": 1e-5, "bf16": 1e-2}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
# the widths the configs train at: qwen3's qk-norm head (128), deepseek-v2's
# MLA latents (512, 1536), mamba2-130m's d_model and d_inner (768, 1536),
# seamless (1024), starcoder2-3b (3072), llama3-8b (4096), pixtral-12b
# (5120), granite-34b (6144), jamba's gate norm (8192)
CONFIG_DS = (128, 512, 768, 1024, 1536, 3072, 4096, 5120, 6144, 8192)
ROWS = (1, 8, 257, 8191, 65536)


def walk(plan, N):
    """The kernel's walk as (CTA, warp, group, row) arrays, one entry a
    (group, row) step, in the order the kernel's loops take them."""
    if plan.wide:
        rows = np.arange(N)
        cta = rows % plan.grid
        return cta, np.zeros(N, int), np.zeros(N, int), rows
    warps, groups = plan.threads // 32, 32 // plan.lanes
    Q = plan.grid * warps * groups
    q = np.arange(Q)
    steps = -(-N // Q)
    rows = (q[None, :] + Q * np.arange(steps)[:, None]).ravel()
    qs = np.tile(q, steps)
    keep = rows < N
    rows, qs = rows[keep], qs[keep]
    return (qs // (warps * groups), qs // groups % warps, qs % groups, rows)


def _plan_cases():
    for D in CONFIG_DS:
        for isz in (2, 4):
            for n_sm, per_sm in ((132, 3), (4, 2)):
                yield D, isz, n_sm, per_sm, True
    # the one-element path: an odd row, and a row that is not whole 16-byte
    # vectors in bf16
    for D in (100, 1001, 3000):
        yield D, 2, 132, 3, False


@pytest.mark.parametrize("D,isz,n_sm,per_sm,vec", list(_plan_cases()))
def test_bwd_plan_geometry(D, isz, n_sm, per_sm, vec):
    for N in ROWS:
        p = rn.bwd_plan(N, D, isz, n_sm, per_sm, vec)
        E = 16 // isz if vec else 1
        n_acc = D // E
        assert p.elems == E and D % E == 0
        assert p.threads % 32 == 0 and p.threads >= 32
        if p.wide:
            assert n_acc > 32 * rn.NARROW_VECS[-1]
            assert p.vecs * E == rn.WIDE_ELEMS
            assert p.threads * p.vecs >= n_acc > (p.threads - 32) * p.vecs
            assert p.threads <= rn.WIDE_THREADS
            row_groups = N
        else:
            lanes = p.lanes
            assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
            assert p.vecs in rn.NARROW_VECS
            assert lanes * p.vecs >= n_acc
            # the fewest accesses a lane, then the fewest lanes
            assert not any(32 * v >= n_acc for v in rn.NARROW_VECS
                           if v < p.vecs)
            assert lanes == 1 or (lanes // 2) * p.vecs < n_acc
            assert p.threads <= 32 * rn.NARROW_WARPS[p.vecs]
            row_groups = -(-N // (p.threads // 32 * (32 // lanes)))
        assert 1 <= p.grid <= min(n_sm * per_sm, row_groups), (N, p)
        # the dw sum: every slice of partial rows holds one at least
        assert 1 <= p.slices <= 32
        assert (p.slices - 1) * -(-p.grid // p.slices) < p.grid

        cta, warp, grp, rows = walk(p, N)
        assert np.array_equal(np.sort(rows), np.arange(N)), (N, p)  # once
        assert np.array_equal(np.unique(cta), np.arange(p.grid))  # none idle
        # every warp walks the same number of rows to within one (a wide
        # CTA's rows, a narrow warp's steps of its groups)
        walkers = p.grid if p.wide else p.threads // 32 * (32 // p.lanes) * p.grid
        key = cta if p.wide else (cta * (p.threads // 32) + warp) * (
            32 // p.lanes) + grp
        counts = np.bincount(key, minlength=walkers)
        assert counts.max() - counts.min() <= 1, (N, p)


def test_bwd_plan_widths():
    """What the plan gives the configs' narrow rows (bf16, 132 SMs): qk-norm
    eight lanes of two vectors (four rows a warp), a non-power-of-two width
    a whole warp with lanes masked or not, the wide rows a CTA each."""
    def shape(D, isz=2, vec=True):
        p = rn.bwd_plan(524288, D, isz, 132, 3, vec)
        return p.wide, p.lanes, p.vecs

    assert shape(128) == (False, 8, 2)
    assert shape(128, 4) == (False, 16, 2)
    assert shape(512) == (False, 32, 2)
    assert shape(768) == (False, 32, 3)  # 96 vectors
    assert shape(1024) == (False, 32, 4)
    assert shape(1536) == (False, 32, 6)  # 192 vectors
    assert shape(768, 4) == (False, 32, 6)
    assert shape(1024, 4)[0] and shape(3072)[0] and shape(8192)[0]
    assert shape(100, vec=False) == (False, 32, 4)  # 28 lanes' 4th masked
    # a small N keeps the grid to its row groups and cuts the CTA's warps
    p = rn.bwd_plan(8, 128, 2, 132, 3)
    assert (p.grid, p.threads) == (1, 64)
    p = rn.bwd_plan(8, 4096, 2, 132, 3)
    assert (p.grid, p.threads) == (8, 256)


def kernel_order(x, w, dy, plan, eps=1e-5):
    """(dx, dw) as the kernel computes them under ``plan``, in plain
    PyTorch on the CPU."""
    N, D = x.shape
    xf = x.float()
    r = torch.rsqrt(xf.square().sum(-1, keepdim=True) / D + eps)
    g = (dy.float() * w.float()).to(x.dtype).float()
    t = xf * r
    c = r * (g * xf).sum(-1, keepdim=True) / D
    dx = (r * (g - t * c)).to(x.dtype)
    terms = dy.float() * t.to(x.dtype).float()

    cta, warp, grp, rows = walk(plan, N)
    warps = plan.threads // 32 if not plan.wide else 1
    groups = 32 // plan.lanes if not plan.wide else 1
    acc = torch.zeros((plan.grid, warps, groups, D), dtype=torch.float32)
    for b, k, q, row in zip(cta, warp, grp, rows):  # walk order
        acc[b, k, q] += terms[row]
    o = 1
    while o < groups:  # the shuffle butterfly: group q adds group q ^ o
        acc = acc + acc[:, :, np.arange(groups) ^ o]
        o <<= 1
    partial = acc[:, 0, 0].clone()
    for k in range(1, warps):  # the warps in order
        partial += acc[:, k, 0]
    per = -(-plan.grid // plan.slices)
    dw = torch.zeros(D, dtype=torch.float32)
    for s in range(plan.slices):  # slices of partial rows, then in order
        part = torch.zeros(D, dtype=torch.float32)
        for p in range(s * per, min(plan.grid, (s + 1) * per)):
            part += partial[p]
        dw += part
    return dx, dw.to(w.dtype)


# (N, D): narrow at qk-norm's head width, a whole warp at mamba2's 768, a
# width of 100 (bf16: the one-element path; fp32: 25 vectors, lanes masked),
# a wide row, one row; on a small card (4 SMs of 3 CTAs) so that there are
# several CTAs and slices of the dw sum
ORDER_CASES = [(37, 128), (50, 768), (23, 100), (29, 3072), (1, 128)]


def _inputs(N, D):
    rng = np.random.default_rng(N * 10007 + D)
    x, dy = (rng.standard_normal((N, D)).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    return x, w, dy


@pytest.fixture(scope="module")
def jax_grads():
    """jax.vjp through the JAX package's rmsnorm for every order case, in
    fp32 on the case's values rounded to each dtype: JAX's bf16 pass sums
    dw's rows in bf16 (1.2% of the largest entry off at 29 rows), the
    kernel in fp32, so in bf16 both are held to the fp32 pass."""
    def grads(cases):
        out = []
        for x, w, dy in cases:
            _, vjp = jax.vjp(lambda a, b: jax_rmsnorm(a, b), x, w)
            out.append(vjp(dy))
        return out

    keys = [(dtype, N, D) for dtype in TOL for N, D in ORDER_CASES]
    cases = [[jnp.asarray(jnp.asarray(a, JDT[dtype]), jnp.float32)
              for a in _inputs(N, D)] for dtype, N, D in keys]
    got = jax.jit(grads)(cases)  # one compilation for every case
    return {k: [np.asarray(g, np.float32) for g in gs]
            for k, gs in zip(keys, got)}


def _close(got, want, tol, what):
    got = got.float().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("N,D", ORDER_CASES)
def test_kernel_order_matches_ref_and_jax(jax_grads, N, D, dtype):
    x, w, dy = (torch.from_numpy(a).to(TDT[dtype]) for a in _inputs(N, D))
    isz = x.element_size()
    plan = rn.bwd_plan(N, D, isz, 4, 3, D * isz % 16 == 0)
    assert plan.grid > 1 or N == 1
    got = kernel_order(x, w, dy, plan)
    assert got[0].dtype == x.dtype and got[1].dtype == w.dtype
    want = ref.rmsnorm_bwd_ref(x, w, dy)
    for name, a, b, jx in zip(("dx", "dw"), got, want, jax_grads[dtype, N, D]):
        _close(a, b.float().numpy(), TOL[dtype], f"{name} vs ref")
        _close(a, jx, TOL[dtype], f"{name} vs jax.vjp")
