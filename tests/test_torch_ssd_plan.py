"""The bf16 SSD-scan kernels' plan (csrc/ssd_scan.cu) on the CPU.

``ssd_plan`` states the kernels' four steps in plain PyTorch over chunks of
L positions (arXiv:2405.21060, section 6): the in-chunk prefix sum of dt A;
each chunk's contribution to the state, X'^T B with X' = x exp(cums_last -
cums_j) dt_j; the state passing over chunks; each chunk's outputs, the
decayed, masked C.B^T scores with dt_j folded in (P) times x, plus
exp(cums_i) C_i . prev. On bf16 inputs it rounds to bf16 exactly where the
kernels do: the chunk-state operand X', the scores P and the state
entering a chunk each as a hi/lo pair (hi = bf16(v), lo = bf16(v - hi),
about 16 bits of mantissa together, two wgmmas into one fp32
accumulator); y once at the end; every product sums in fp32. On fp32
inputs nothing is rounded. Rounding P once (as the plain version rounds
its scores) puts y past the tolerance at mamba2-130m's widths, and
rounding X' once leaves it at the edge (the state sums every position's
rounding and each output reads it through a 128-term product):
``test_rounding_once_misses_at_the_model_widths`` keeps those readings.

It is held against three references on the same seeded numpy inputs: JAX's
``repro.models.mamba.ssd_chunked`` (the model's padding rule: chunks of
min(256, S)), JAX's Pallas kernel in interpret mode
(``repro.kernels.ops.ssd_scan(..., interpret=True)``) and the port's
``ref.ssd_scan_ref``, at tests/test_kernels.py's tolerances: fp32 atol 3e-5,
bf16 atol 5e-2, rtol 2e-2. Widths are the kernels' (head dim 64, d_state
128) with 2 heads; the lengths sit on and beside every chunk edge, the
plan's chunk is the kernels' 64 or the config's 256, and one set of cases
decays hard (dt |A| up to about 5). The card tests in test_torch_cuda.py
hold the kernels themselves at the same edges. Also the launcher's
heads-a-CTA rule and scratch shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models.mamba import ssd_chunked  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

TOLS = {"fp32": 3e-5, "bf16": 5e-2}
RTOL = 2e-2
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
NH, HD, DS = 2, 64, 128
LENS = (1, 63, 64, 65, 255, 256, 257, 1000)
MODEL_CHUNK = 256


def ssd_plan(x, dt, A, B, C, L, *, split_x=True, split_p=True):
    """The kernels' plan over chunks of L positions. x: [b,S,nh,hd] (fp32
    or bf16); dt: [b,S,nh] fp32; A: [nh] fp32; B, C: [b,S,1,ds] in x's
    dtype. Returns (y [b,S,nh,hd] in x's dtype, final state [b,nh,hd,ds]
    fp32). Positions past S are zeros with dt = 0, as the kernels load
    them. ``split_x=False`` (``split_p=False``) rounds the chunk-state
    operand X' (the scores P) to bf16 once instead of carrying it as a
    hi/lo pair: the choices the kernels did not take."""
    if x.dtype == torch.bfloat16:
        def rnd(t):
            return t.to(torch.bfloat16).float()
    else:
        def rnd(t):
            return t

    def pair(t):  # bf16 hi + lo, as the kernels hold an fp32 operand
        hi = rnd(t)
        return hi + rnd(t - hi)

    b, S, nh, hd = x.shape
    ds = B.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, L, nh, hd)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(b, nc, L, nh)
    Bf, Cf = (F.pad(t[:, :, 0].float(), (0, 0, 0, pad)).reshape(b, nc, L, ds)
              for t in (B, C))
    # the in-chunk inclusive prefix sum of dt A
    cums = torch.cumsum(dtf * A.float(), dim=2)  # [b,nc,L,nh]
    last = cums[:, :, -1]  # [b,nc,nh]

    # 1. each chunk's contribution to the state: X'^T B, X' as a hi/lo pair
    w = torch.exp(last[:, :, None] - cums) * dtf
    Xp = xf * w[..., None]
    states = torch.einsum("bclhp,bcls->bchps", pair(Xp) if split_x else rnd(Xp),
                          Bf)

    # 2. the state passing, in fp32; each chunk's entering state as hi + lo
    decay = torch.exp(last)
    carry = torch.zeros((b, nh, hd, ds))
    prev = []
    for c in range(nc):
        prev.append(pair(carry))
        carry = carry * decay[:, c, :, None, None] + states[:, c]

    # 3. each chunk's outputs: P = C.B^T decay dt_j for j <= i as a hi/lo
    # pair, then P x plus exp(cums_i) C . prev, y rounded once
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    ys = []
    for c in range(nc):
        cb = Cf[:, c] @ Bf[:, c].transpose(1, 2)  # [b,L,L], once per chunk
        cs = cums[:, c].transpose(1, 2)  # [b,nh,L]
        seg = (cs[..., :, None] - cs[..., None, :]).masked_fill(~causal,
                                                                float("-inf"))
        P = cb[:, None] * torch.exp(seg) \
            * dtf[:, c].transpose(1, 2)[:, :, None, :]  # [b,nh,L,L]
        y_in = torch.einsum("bhij,bjhp->bihp", pair(P) if split_p else rnd(P),
                            xf[:, c])
        y_x = torch.einsum("bis,bhps->bihp", Cf[:, c], prev[c]) \
            * torch.exp(cums[:, c])[..., None]
        ys.append(y_in + y_x)
    y = torch.stack(ys, dim=1).reshape(b, nc * L, nh, hd)[:, :S]
    return y.to(x.dtype), carry


def _inputs(b, S, seed, strong):
    """test_kernels.py's SSD inputs (x, B, C normal; dt = |N| 0.1 + 0.01;
    A = -|N| - 0.1), or with ``strong`` decay A uniform in -[4, 16) (the
    span of Mamba-2's A init, -[1, 16]): dt |A| up to about 5."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, NH, HD)).astype(np.float32)
    B = rng.normal(size=(b, S, 1, DS)).astype(np.float32)
    C = rng.normal(size=(b, S, 1, DS)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, S, NH))) * 0.1 + 0.01).astype(np.float32)
    if strong:
        A = -rng.uniform(4.0, 16.0, size=(NH,)).astype(np.float32)
    else:
        A = (-np.abs(rng.normal(size=(NH,))) - 0.1).astype(np.float32)
    return x, dt, A, B, C


_refs: dict = {}


def _jax_chunked(x, dt, A, B, C):
    """JAX's ssd_chunked under the model's padding rule."""
    S = x.shape[1]
    jc = min(MODEL_CHUNK, S)
    pad = (-S) % jc
    x, dt, B, C = (jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
                   for t in (x, dt, B, C))
    y, st = ssd_chunked(x, dt, A, B, C, jc)
    return np.asarray(y[:, :S].astype(jnp.float32)), np.asarray(st)


def _case(dtype, b, S, strong):
    """The inputs in the working dtype (dt and A fp32), the three
    references' (y, state) and, for bf16, ssd_chunked's own bf16 y; each
    computed once per case. The Pallas kernel takes the inputs as they are
    (it computes in fp32). ssd_chunked and ssd_scan_ref round their C.B^T
    and then their decayed scores to bf16 on bf16 inputs, so they run in
    fp32 on the same input values (the oracle test_kernels.py and the card
    tests use); ``test_plan_is_no_less_accurate_than_the_model`` compares
    their bf16 rounding with the kernels'."""
    key = (dtype, b, S, strong)
    if key not in _refs:
        x, dt, A, B, C = _inputs(b, S, seed=S + 7 * b + 1000 * strong,
                                 strong=strong)
        jx, jB, jC = (jnp.asarray(a, JDT[dtype]) for a in (x, B, C))
        jd, jA = jnp.asarray(dt), jnp.asarray(A)
        yk, sk = jax_ops.ssd_scan(jx, jd, jA, jB, jC, chunk=min(MODEL_CHUNK, S),
                                  interpret=True)
        fx, fB, fC = (a.astype(jnp.float32) for a in (jx, jB, jC))
        tx, tB, tC = (torch.from_numpy(np.array(a)) for a in (fx, fB, fC))
        td, tA = torch.from_numpy(dt), torch.from_numpy(A)
        yr, sr = ref.ssd_scan_ref(tx, td, tA, tB, tC, MODEL_CHUNK)
        refs = {
            "ssd_chunked": _jax_chunked(fx, jd, jA, fB, fC),
            "pallas_interpret": (np.asarray(yk.astype(jnp.float32)),
                                 np.asarray(sk)),
            "ssd_scan_ref": (yr.numpy(), sr.numpy()),
        }
        model_y = _jax_chunked(jx, jd, jA, jB, jC)[0] if dtype == "bf16" else None
        inputs = tuple(t.to(TDT[dtype]) for t in (tx,)) + (td, tA) + tuple(
            t.to(TDT[dtype]) for t in (tB, tC))
        _refs[key] = (inputs, refs, model_y)
    return _refs[key]


def _hold(dtype, b, S, L, strong):
    (x, dt, A, B, C), refs, _ = _case(dtype, b, S, strong)
    y, st = ssd_plan(x, dt, A, B, C, L)
    assert y.dtype == TDT[dtype] and y.shape == (b, S, NH, HD)
    assert st.dtype == torch.float32 and st.shape == (b, NH, HD, DS)
    for name, (want_y, want_st) in refs.items():
        np.testing.assert_allclose(y.float().numpy(), want_y, atol=TOLS[dtype],
                                   rtol=RTOL, err_msg=f"y vs {name}")
        np.testing.assert_allclose(st.numpy(), want_st, atol=TOLS[dtype],
                                   rtol=RTOL, err_msg=f"state vs {name}")


@pytest.mark.parametrize("L", [ssd.CHUNK, MODEL_CHUNK])
@pytest.mark.parametrize("S", LENS)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plan_matches_jax_and_plain(dtype, b, S, L):
    _hold(dtype, b, S, L, strong=False)


@pytest.mark.parametrize("L", [ssd.CHUNK, MODEL_CHUNK])
@pytest.mark.parametrize("S", [65, 1000])
@pytest.mark.parametrize("b", [1, 3])
def test_plan_matches_jax_and_plain_under_strong_decay(b, S, L):
    _hold("bf16", b, S, L, strong=True)


@pytest.mark.parametrize("L", [ssd.CHUNK, MODEL_CHUNK])
@pytest.mark.parametrize("S,strong", [(63, False), (257, False), (1000, False),
                                      (1000, True)])
def test_plan_is_no_less_accurate_than_the_model(S, strong, L):
    """On bf16 inputs the kernels' roundings (X', P with dt folded in, y)
    sit no further from the fp32 result on the same values than the JAX
    model's own bf16 ssd_chunked does (C.B^T, then the decayed scores):
    max |y - y_fp32| over the tolerance, element by element."""
    (x, dt, A, B, C), refs, model_y = _case("bf16", 1, S, strong)
    y, _ = ssd_plan(x, dt, A, B, C, L)
    truth = torch.tensor(refs["pallas_interpret"][0])
    truth32, _ = ssd_plan(x.float(), dt, A, B.float(), C.float(), L)
    tol = TOLS["bf16"] + RTOL * truth32.abs()
    plan_err = float(((y.float() - truth32).abs() / tol).max())
    model_err = float(((torch.tensor(model_y) - truth32).abs() / tol).max())
    assert plan_err <= model_err, (plan_err, model_err)
    torch.testing.assert_close(truth32, truth.float(), atol=TOLS["bf16"], rtol=RTOL)


def test_plan_rounds_where_the_kernels_do():
    """On bf16 inputs the plan's y differs from the same plan computed
    without its roundings (a witness that the rounding points are live),
    and the hi/lo pair carries the fp32 state to about 16 bits: its error
    is below 2^-16 of the state's magnitude."""
    (x, dt, A, B, C), _, _ = _case("bf16", 1, 257, False)
    y, st = ssd_plan(x, dt, A, B, C, ssd.CHUNK)
    y32, st32 = ssd_plan(x.float(), dt, A, B.float(), C.float(), ssd.CHUNK)
    assert not torch.equal(y.float(), y32.to(torch.bfloat16).float())
    torch.testing.assert_close(y.float(), y32, atol=TOLS["bf16"], rtol=RTOL)
    torch.testing.assert_close(st, st32, atol=TOLS["bf16"], rtol=RTOL)
    hi = st32.to(torch.bfloat16).float()
    lo = (st32 - hi).to(torch.bfloat16).float()
    assert float((hi + lo - st32).abs().max()) <= float(st32.abs().max()) * 2 ** -16


def _model_width_case(S, b, seed):
    """test_torch_cuda.py's card inputs (``_ssd_case``, same generator and
    seed) at mamba2-130m's widths: 24 heads of 64, d_state 128, x, B and C
    bf16 views of one conv-output row, dt and A fp32."""
    nh, hd, ds = 24, 64, 128
    g = torch.Generator().manual_seed(seed)
    xBC = torch.randn((b, S, nh * hd + 2 * ds), generator=g)
    dt = torch.randn((b, S, nh), generator=g).abs() * 0.1 + 0.01
    A = -torch.randn((nh,), generator=g).abs() - 0.1
    xBC = xBC.to(torch.bfloat16)
    x = xBC[..., :nh * hd].reshape(b, S, nh, hd)
    B = xBC[..., nh * hd:nh * hd + ds].reshape(b, S, 1, ds)
    C = xBC[..., nh * hd + ds:].reshape(b, S, 1, ds)
    return x, dt, A, B, C


def _err_over_tol(x, dt, A, B, C, **kw):
    """max |plan - oracle| / (atol + rtol |oracle|) for y, the oracle the
    port's plain version in fp32 on the same values (the card tests')."""
    want, _ = ref.ssd_scan_ref(x.float(), dt, A, B.float(), C.float(),
                               MODEL_CHUNK)
    y, _ = ssd_plan(x, dt, A, B, C, ssd.CHUNK, **kw)
    return float(((y.float() - want).abs()
                  / (TOLS["bf16"] + RTOL * want.abs())).max())


@pytest.mark.parametrize("S,b", [(1000, 1), (1000, 3), (2048, 1)])
def test_plan_at_the_model_widths(S, b):
    """At mamba2-130m's 24 heads the plan stays well inside the bf16
    tolerance of the fp32 oracle (y's own rounding sets most of it)."""
    assert _err_over_tol(*_model_width_case(S, b, S)) < 0.5


def test_rounding_once_misses_at_the_model_widths():
    """The readings that settled the kernels' rounding points, on the card
    test's S = 1000 inputs: with the scores P and the chunk-state operand
    X' each rounded to bf16 once, or P alone, y misses the tolerance (as
    the first tensor-core kernel did on the card); with X' alone rounded
    once it sits at the edge; with both as hi/lo pairs it is well
    inside."""
    case = _model_width_case(1000, 1, 1000)
    assert _err_over_tol(*case, split_p=False, split_x=False) > 1.0
    assert _err_over_tol(*case, split_p=False) > 1.0
    assert _err_over_tol(*case, split_x=False) > 0.9
    assert _err_over_tol(*case) < 0.5


# --------------------------------------------------------------------------- #
# the launcher's plan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_chunks,nh,n_sm,want", [
    (16, 24, 132, 2),  # b=1, S=1024: 192 CTAs in one wave of 264
    (32, 24, 132, 3),  # b=1, S=2048: 256 CTAs
    (10, 24, 132, 1),  # a 601-token prefill: 240 CTAs
    (1, 24, 132, 1),  # one chunk: 24 CTAs
    (256, 24, 132, 24),  # b=8, S=2048: one CTA a chunk
    (512, 24, 132, 24),  # no group fits one wave: all heads a CTA
    (16, 5, 132, 1),  # 5 heads: no divisor in HEAD_GROUPS but 1
])
def test_heads_per_cta(n_chunks, nh, n_sm, want):
    g = ssd.heads_per_cta(n_chunks, nh, n_sm)
    assert g == want
    assert nh % g == 0


def test_scratch_words():
    """ceil(S / CHUNK) chunks; the bf16 hi/lo planes take the bytes of the
    fp32 states; one fp32 decay a chunk and head."""
    nc, nh, hd, ds = 16, 24, 64, 128
    assert ssd.scratch_words(2, 1000, nh, hd, ds) == 2 * nc * nh * (2 * hd * ds + 1)
    assert ssd.scratch_words(1, 1, 1, hd, ds) == 2 * hd * ds + 1
