"""The ring decode kernel's split-KV plan and merge, on the CPU: the
launcher's split count; the per-CTA key ranges that the kernel
(csrc/decode_attention.cu) cuts each row into, stated here as
``split_ranges``; and the max/sum merge of per-split partial softmax states
over those ranges, held against the JAX package's ``decode_attention_update``
on the same seeded numpy inputs. The card tests in test_torch_cuda.py hold
the kernel itself at lengths on split and tile boundaries.

Tolerances follow tests/test_kernels.py: fp32 atol 2e-5, bf16 atol 2e-2,
rtol 1e-2 (JAX rounds P to the value dtype before P.V; the partials here
keep it in fp32)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOLS = {"fp32": 2e-5, "bf16": 2e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def split_ranges(length, *, w_real, W, splits):
    """The keys [start, end) that each of a row's ``splits`` CTAs reads in
    the kernel: whole tiles of TILE_K, ceil(tiles / splits) to a CTA, in
    order, the last ones empty when the row is short."""
    T = dec.TILE_K
    valid = max(0, min(length, w_real, W))
    per = -(-(-(-valid // T)) // splits)  # ceil(ceil(valid / T) / splits)
    return [(min(r * per * T, valid), min((r + 1) * per * T, valid))
            for r in range(splits)]


def merge_partials(m, l, acc):
    """The cluster's merge of per-split partial softmax states: m, l
    [S, ...] (max score and sum of exp(score - m)), acc [S, ..., hd] (the
    unnormalised sum of exp(score - m) v) -> sum_s acc_s e^(m_s - M) /
    max(sum_s l_s e^(m_s - M), 1e-30) with M = max_s m_s. A split with no
    key has m = -1e30, l = 0, acc = 0; a row with none returns zeros."""
    M = m.amax(dim=0)
    w = torch.exp(m - M)
    L = (l * w).sum(dim=0)
    O = (acc * w[..., None]).sum(dim=0)
    return O / L.clamp_min(1e-30)[..., None]


# --------------------------------------------------------------------------- #
# the split plan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("W,rows,n_sm,want", [
    (2048, 64, 132, 8),  # phase 2 / the main path: 512 CTAs
    (2048, 128, 132, 4),  # 512 CTAs already at 4
    (2048, 1024, 132, 1),  # enough rows to fill the card unsplit
    (300, 64, 132, 2),  # W caps it: one 128-key chunk a CTA at least
    (128, 8, 132, 1),
    (64, 8, 132, 1),
    (100_000, 1, 132, dec.MAX_SPLITS),
])
def test_num_splits(W, rows, n_sm, want):
    s = dec.num_splits(W, rows, n_sm)
    assert s == want
    assert s & (s - 1) == 0 and 1 <= s <= dec.MAX_SPLITS


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("W,w_real", [(2048, 2048), (300, 300), (520, 500)])
def test_split_ranges_cover_the_valid_keys_exactly(splits, W, w_real):
    """Contiguous, in order, tile-aligned starts, at most ceil(tiles /
    splits) tiles each, empty ranges only at the end, together exactly
    [0, min(length, w_real, W))."""
    T = dec.TILE_K
    for length in sorted({0, 1, T - 1, T, T + 1, W // 8, W // 8 + 1,
                          w_real - 1, w_real, W, W + 7}):
        rs = split_ranges(length, w_real=w_real, W=W, splits=splits)
        valid = max(0, min(length, w_real, W))
        assert len(rs) == splits
        assert rs[0][0] == 0 and rs[-1][1] == valid
        per = -(-(-(-valid // T)) // splits)  # ceil(ceil(valid / T) / splits)
        seen_empty = False
        for (a, b), (c, _) in zip(rs, rs[1:] + [(valid, valid)]):
            assert a <= b and b == c
            if a == b:
                seen_empty = True
            else:
                assert not seen_empty, rs  # empties only trail
                assert a % T == 0 and (b - a) <= per * T
        assert sum(b - a for a, b in rs) == valid


def test_split_ranges_short_row_uses_the_first_ctas():
    rs = split_ranges(33, w_real=2048, W=2048, splits=8)
    assert rs == [(0, 32), (32, 33)] + [(33, 33)] * 6
    assert split_ranges(0, w_real=2048, W=2048, splits=4) == [(0, 0)] * 4


# --------------------------------------------------------------------------- #
# the merge of per-split partials vs JAX's decode_attention_update
# --------------------------------------------------------------------------- #
def _partial(q, k, v, start, end, scale):
    """The plain partial state of one split over keys [start, end): m, l
    [B, H] and the unnormalised acc [B, H, hd], in fp32 (m = -1e30, l = 0,
    acc = 0 when the range is empty)."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, Hkv, H // Hkv, hd)
    ks, vs = k[:, start:end].float(), v[:, start:end].float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, ks) * scale
    if end <= start:
        return (torch.full((B, H), ref.NEG_INF), torch.zeros((B, H)),
                torch.zeros((B, H, hd)))
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    acc = torch.einsum("bhgk,bkhd->bhgd", e, vs)
    return m.reshape(B, H), e.sum(dim=-1).reshape(B, H), acc.reshape(B, H, hd)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_merge_matches_jax_decode_update(dtype, splits):
    """Rows of length 0 (the new token alone), on and off tile edges, and
    one near the full ring: the new K/V is written at slot lengths % W and
    the row attends to lengths + 1 slots. Each split's partial comes from
    the plain rule on its key range; merge_partials combines them."""
    rng = np.random.default_rng(splits)
    B, W, H, Hkv, hd = 6, 256, 8, 2, 32
    lens = np.array([0, 31, 32, 64, 150, 254], np.int32)
    arrs = [rng.normal(size=s).astype(np.float32) for s in (
        (B, 1, H, hd), (B, 1, Hkv, hd), (B, 1, Hkv, hd),
        (B, W, Hkv, hd), (B, W, Hkv, hd))]
    qj, knj, vnj, kcj, vcj = (jnp.asarray(a, JDT[dtype]) for a in arrs)
    valid = lens + 1
    want, _, _ = jattn.decode_attention_update(
        qj, knj, vnj, kcj, vcj, jnp.asarray(lens),
        valid_len=jnp.asarray(valid))

    q, kn, vn, kc, vc = (torch.from_numpy(a).to(TDT[dtype]) for a in arrs)
    rows = torch.arange(B)
    kc[rows, torch.from_numpy(lens).long()] = kn[:, 0]
    vc[rows, torch.from_numpy(lens).long()] = vn[:, 0]
    scale = 1.0 / math.sqrt(hd)
    # per row, per split: the kernel's ranges; rows differ, so each row's
    # partials are taken alone and stacked over the splits
    out = torch.empty((B, H, hd))
    for b in range(B):
        parts = [_partial(q[b:b + 1], kc[b:b + 1], vc[b:b + 1], a, e, scale)
                 for a, e in split_ranges(int(valid[b]), w_real=W, W=W,
                                              splits=splits)]
        m, l, acc = (torch.stack(t) for t in zip(*parts))
        out[b] = merge_partials(m, l, acc)[0]
    np.testing.assert_allclose(
        out.reshape(B, 1, H, hd).to(TDT[dtype]).float().numpy(),
        np.asarray(want.astype(jnp.float32)), atol=TOLS[dtype], rtol=1e-2)


def test_merge_partials_empty_row_is_zero():
    m = torch.full((4, 2, 3), ref.NEG_INF)
    out = merge_partials(m, torch.zeros((4, 2, 3)),
                             torch.zeros((4, 2, 3, 8)))
    assert torch.equal(out, torch.zeros((2, 3, 8)))


# --------------------------------------------------------------------------- #
# the two launchers' plans: one split count for the same row length
# --------------------------------------------------------------------------- #
class _Recorder:
    """Stands in for a launcher's C entry point: keeps its arguments."""

    def __init__(self):
        self.args = None

    def __call__(self, device_index, *args):
        self.args = args


@pytest.fixture
def card_of(monkeypatch):
    """The launchers' view of a card with ``n_sm`` SMs, their C calls
    recorded instead of made."""
    from types import SimpleNamespace

    from repro_torch.kernels import paged_decode_attention as pdec

    def make(n_sm):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: SimpleNamespace(multi_processor_count=n_sm))
        dec.splits_for.cache_clear()
        ring, paged = _Recorder(), _Recorder()
        monkeypatch.setattr(dec, "_FWD", ring)
        monkeypatch.setattr(pdec, "_FWD", paged)
        return ring, paged

    yield make
    dec.splits_for.cache_clear()


@pytest.mark.parametrize("B,n_pages,H,Hkv,n_sm", [
    (8, 128, 32, 8, 132),  # phase 6: 8 splits, 512 CTAs
    (2, 8, 8, 2, 132),  # max_seq 128: one CTA a row
    (8, 128, 48, 1, 132),  # granite-34b's G = 48: 3 head groups a row
    (32, 64, 32, 8, 132),  # enough rows to fill the card unsplit
    (4, 20, 24, 2, 16),  # a small card
])
def test_paged_launcher_takes_the_ring_launchers_split_count(
        card_of, B, n_pages, H, Hkv, n_sm):
    """The paged launcher's split count is num_splits(n_pages * page,
    B * Hkv, n_sm), the ring launcher's for a ring of W = n_pages * page
    slots, so the two kernels sum each row's keys in one order."""
    from repro_torch.kernels import paged_decode_attention as pdec

    ring, paged = card_of(n_sm)
    page, hd = 16, 32
    W = n_pages * page
    q = torch.zeros((B, 1, H, hd))
    lens = torch.zeros((B,), dtype=torch.int32)
    dec.launch(q, torch.zeros((B, W, Hkv, hd)), torch.zeros((B, W, Hkv, hd)),
               lens, scale=1.0, w_real=W)
    pdec.launch(q, torch.zeros((3, page, Hkv, hd)),
                torch.zeros((3, page, Hkv, hd)),
                torch.zeros((B, n_pages), dtype=torch.int32), lens, scale=1.0)
    want = dec.num_splits(W, B * Hkv, n_sm)
    assert ring.args[-1] == paged.args[-1] == want
    # B, W, H, Hkv, hd as the ring entry point takes them; B, n_pages,
    # page, H, Hkv, hd as the paged one does
    assert ring.args[5:10] == (B, W, H, Hkv, hd)
    assert paged.args[6:12] == (B, n_pages, page, H, Hkv, hd)
    # a forced count reaches both kernels as given
    dec.launch(q, torch.zeros((B, W, Hkv, hd)), torch.zeros((B, W, Hkv, hd)),
               lens, scale=1.0, w_real=W, _splits=2)
    pdec.launch(q, torch.zeros((3, page, Hkv, hd)),
                torch.zeros((3, page, Hkv, hd)),
                torch.zeros((B, n_pages), dtype=torch.int32), lens, scale=1.0,
                _splits=2)
    assert ring.args[-1] == paged.args[-1] == 2


def test_split_plan_is_asked_once_per_shape(card_of):
    """splits_for caches the plan: a call asks the card nothing."""
    asked = []
    ring, _ = card_of(132)
    real = torch.cuda.get_device_properties
    torch.cuda.get_device_properties = lambda i: asked.append(i) or real(i)
    try:
        for _ in range(3):
            assert dec.splits_for(2048, 64, 0) == 8
    finally:
        torch.cuda.get_device_properties = real
    assert asked == [0]


# --------------------------------------------------------------------------- #
# the absorbed-MLA decode kernel's plan (csrc/mla_decode_attention.cu)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("W,B,H,bf16,n_sm,want", [
    (2048, 8, 128, True, 132, 8),  # phase 2 and phase 13: 16 x 8 = 128 CTAs
    (2048, 8, 128, False, 132, 8),  # fp32 there: 64 x 8 = 512 CTAs
    (256, 4, 16, True, 132, 4),  # the card tests' MLA config: 4 tiles
    (2048, 64, 128, True, 132, 1),  # 128 (row, head block)s fill the card
    (2048, 32, 128, True, 132, 2),
    (100_000, 1, 64, True, 132, 8),  # the portable cluster caps it
])
def test_mla_num_splits(W, B, H, bf16, n_sm, want):
    """A power of two within [1, MAX_SPLITS]; in bf16 (one CTA an SM) the
    grid never passes one CTA an SM once split."""
    from repro_torch.kernels import mla_decode_attention as mla

    rows = B * mla.head_blocks(H, bf16)
    s = mla.num_splits(W, rows, n_sm, bf16)
    assert s == want
    assert s & (s - 1) == 0 and 1 <= s <= mla.MAX_SPLITS
    if bf16 and s > 1:
        assert rows * s <= n_sm


@pytest.mark.parametrize("H,bf16,want", [
    (16, True, 1), (48, True, 1), (64, True, 1), (128, True, 2),
    (16, False, 1), (48, False, 3), (128, False, 8)])
def test_mla_head_blocks(H, bf16, want):
    """bf16: ceil(H / 64) blocks of wgmma's 64 rows (a partial one
    zero-filled); fp32: H / 16."""
    from repro_torch.kernels import mla_decode_attention as mla

    assert mla.head_blocks(H, bf16) == want


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, "plan"])
def test_mla_tile_shares_cover_every_valid_tile_once(bf16, splits):
    """The kernel's share rule (``tile_shares``), at forced split counts and
    at the launcher's count for phase 2's shape: each CTA's share is whole
    tiles, in order; together they hold every tile with a valid row exactly
    once, and empty shares only trail."""
    from repro_torch.kernels import mla_decode_attention as mla

    tile, W = (mla.WG_TILE if bf16 else mla.TILE), 2048
    if splits == "plan":
        splits = mla.num_splits(W, 8 * mla.head_blocks(128, bf16), 132, bf16)
    assert 1 <= splits <= mla.MAX_SPLITS
    for length in sorted({0, 1, 63, 64, 65, 127, 128, 129, 300, 512, 513,
                          777, 1024, 1500, W - 1, W, W + 5}):
        shares = mla.tile_shares(length, W, splits, tile)
        assert len(shares) == splits
        n_tiles = -(-min(length, W) // tile)
        covered = [t for a, b in shares for t in range(a, b)]
        assert covered == list(range(n_tiles))
        sizes = [b - a for a, b in shares]
        assert max(sizes) == -(-n_tiles // splits)
        assert sizes == sorted(sizes, reverse=True)  # empties only trail


@pytest.mark.parametrize("dtype,H", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 48),
                                     (torch.float32, 128)])
def test_mla_launchers_take_one_plan(monkeypatch, dtype, H):
    """The ring and paged MLA launchers pass the same split count, the
    plan's for a ring of n_pages * page slots, and a forced count as
    given."""
    from types import SimpleNamespace

    from repro_torch.kernels import mla_decode_attention as mla

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(multi_processor_count=132))
    mla.splits_for.cache_clear()
    ring, paged = _Recorder(), _Recorder()
    monkeypatch.setattr(mla, "_RING", ring)
    monkeypatch.setattr(mla, "_PAGED", paged)
    B, page, n_pages = 8, 16, 128
    W = n_pages * page
    q_lat, q_rope = torch.zeros((B, 1, H, 512), dtype=dtype), \
        torch.zeros((B, 1, H, 64), dtype=dtype)
    lens = torch.zeros((B,), dtype=torch.int32)
    try:
        for kw in ({}, {"_splits": 3}):
            mla.launch(q_lat, q_rope, torch.zeros((B, W, 512), dtype=dtype),
                       torch.zeros((B, W, 64), dtype=dtype), lens, scale=1.0,
                       **kw)
            mla.launch_paged(q_lat, q_rope,
                             torch.zeros((3, page, 512), dtype=dtype),
                             torch.zeros((3, page, 64), dtype=dtype),
                             torch.zeros((B, n_pages), dtype=torch.int32),
                             lens, scale=1.0, **kw)
            bf16 = dtype is torch.bfloat16
            want = kw.get("_splits") or mla.num_splits(
                W, B * mla.head_blocks(H, bf16), 132, bf16)
            # (..., scale, is_bf16, splits); the paged entry takes B, the
            # pool's blocks, n_pages and page after its 7 pointers
            assert ring.args[-3:] == paged.args[-3:] == (1.0, bf16, want)
            assert paged.args[7:11] == (B, 3, n_pages, page)
    finally:
        mla.splits_for.cache_clear()
