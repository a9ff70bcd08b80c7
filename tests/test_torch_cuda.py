"""Port kernels and model on a CUDA card: each hand-written Hopper kernel
against its plain PyTorch version (the paged decode kernel also, bitwise,
against the ring kernel on the same K/V at each split count; rmsnorm at
the models' widths and every x/w dtype pair; both decode kernels at more
than 16 query heads a KV head; the bf16 flash kernel and the split decode
kernels at their tile, page and split edges; the SSD scan at its chunk
edges, under strong decay and at its largest grid), the serving engine's
launch counts on its ring, paged and exact-shape (Mamba-2) paths, and the
disaggregated engine under each mechanism against the same engine on the
CPU; packed prefill rows (tile-edge runs, pad-only tiles, one whole-row
segment, 40 sub-tile segments, windows, MQA) and the chunk path's dense
prior; the packed + chunked engine against the CPU engine; the decode
step as one CUDA graph against the eager step, bitwise over 40 steps
(ring at one and at several splits, paged with page-table edits between
replays, mamba2-130m, sampling at temperature 0.8), warm-up's capture, and
a capture that fails raising; an unwarmed EnginePipeline capturing on its
dispatch thread, and a 2-replica in-process cluster's replayed graphs;
MLA (deepseek-v2): flash at q/k 192, v 128, the absorbed-MLA decode
kernel ring and paged against its plain versions at split and tile edges,
and an MLA pool's graph against its eager step; the sharded training step on
a 2 x 2 mesh naming the card four times against the CPU's (reduced
llama3-8b, mamba2-130m and seamless-m4t-large-v2), and its blocks'
devices (``-k "sharded_train or train_blocks"``); the SSD scan forward and
backward at the head counts a ``model`` shard gives mamba2 and jamba (6,
12, 32, 64; ``-k shard_heads``). The backward kernels
(``-k backward``): flash's against ``ref.flash_attention_bwd_ref`` at
sequence, group, head-dim, window, pad and Sq != Skv edges, fully masked
rows, two calls bitwise, and at MLA's head dims (192, 128); rmsnorm's
against ``ref.rmsnorm_bwd_ref`` at the models' widths and ragged row
counts; the SSD scan's against ``ref.ssd_scan_bwd_ref`` at mamba2's and
jamba's widths, the chunk's edges, strong decay, the fp32 head dims and
every head group, two calls bitwise; the ops without a backward refusing
inputs that require grad; both autograd Functions under
``torch.utils.checkpoint``.
Every test here skips without a card (the kernels have no CPU mode); the
file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances follow tests/test_kernels.py (fp32 atol 2e-5, bf16 atol 2e-2,
rtol 1e-2; for the SSD scan fp32 atol 3e-5, bf16 atol 5e-2, rtol 2e-2):
kernel and plain version sum in different orders."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as _dec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_decode_attention as _pdec  # noqa: E402

TOLS = {"fp32": 2e-5, "bf16": 2e-2}
SSD_TOLS = {"fp32": 3e-5, "bf16": 5e-2}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# --------------------------------------------------------------------------- #
# hand-written kernels vs their plain versions
# --------------------------------------------------------------------------- #
def _cuda_pair(shape, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=dev, dtype=TDT[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rmsnorm_kernel_matches_plain(cuda_device, dtype):
    x = _cuda_pair((64, 4096), dtype, cuda_device, 0)
    w = _cuda_pair((4096,), dtype, cuda_device, 1)
    ops.reset_launches()
    got = ops.rmsnorm(x, w)
    assert ops.LAUNCHES["rmsnorm"] == 1
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(),
                               atol=TOLS[dtype], rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("bf16", "bf16"), ("bf16", "fp32"), ("fp32", "bf16"), ("fp32", "fp32")])
@pytest.mark.parametrize("D", [128, 768, 1001, 1536, 4096, 8192])
@pytest.mark.parametrize("N", [1, 8, 257, 8192])
def test_rmsnorm_kernel_shapes_and_dtypes(cuda_device, N, D, x_dtype,
                                          w_dtype):
    """The CUDA C++ kernel at decode and prefill row counts, at the widths
    the models use (D = 1001 is not a whole number of 16-byte vectors: the
    one-element accesses run), x and w each fp32 or bf16; one launch a
    call. Tolerances are x's dtype's."""
    x = _cuda_pair((N, D), x_dtype, cuda_device, N + D)
    w = _cuda_pair((D,), w_dtype, cuda_device, 1)
    ops.reset_launches()
    got = ops.rmsnorm(x, w)
    assert ops.LAUNCHES["rmsnorm"] == 1
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(),
                               atol=TOLS[x_dtype], rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N,D", [(1, 5120), (300, 5120), (3, 12288),
                                 (300, 9001)])
def test_rmsnorm_kernel_long_rows(cuda_device, N, D, dtype):
    """Rows longer than a CTA holds in registers (more than 1024 vectors,
    or 4096 elements one at a time): the rest of the row is read again for
    the output."""
    x = _cuda_pair((N, D), dtype, cuda_device, D)
    w = _cuda_pair((D,), dtype, cuda_device, 2)
    torch.testing.assert_close(ops.rmsnorm(x, w).float(),
                               ref.rmsnorm_ref(x, w).float(),
                               atol=TOLS[dtype], rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rmsnorm_kernel_unaligned_and_empty(cuda_device, dtype):
    """An x or a w that starts off a 16-byte boundary (one-element
    accesses), at 17 rows and at 8, a 3-d x, and an empty x (no launch)."""
    buf = _cuda_pair((17 * 4096 + 1,), dtype, cuda_device, 3)
    x = buf[1:].view(17, 4096)
    assert x.data_ptr() % 16
    w = _cuda_pair((4096,), dtype, cuda_device, 4)
    wbuf = _cuda_pair((769,), dtype, cuda_device, 7)
    w_off = wbuf[1:]
    assert w_off.data_ptr() % 16
    x8 = _cuda_pair((8, 768), dtype, cuda_device, 8)
    x3 = _cuda_pair((2, 5, 768), dtype, cuda_device, 5)
    w3 = _cuda_pair((768,), dtype, cuda_device, 6)
    ops.reset_launches()
    for xx, ww in ((x, w), (x3, w3), (x8, w_off), (x3, w_off)):
        torch.testing.assert_close(ops.rmsnorm(xx, ww).float(),
                                   ref.rmsnorm_ref(xx, ww).float(),
                                   atol=TOLS[dtype], rtol=1e-2)
    empty = ops.rmsnorm(x[:0], w)
    assert empty.shape == (0, 4096) and ops.LAUNCHES["rmsnorm"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("window,segmented,H,Hkv,hd", [
    (0, False, 8, 2, 128),
    (64, True, 8, 2, 128),
    (0, False, 4, 4, 64),
    (48, False, 6, 3, 32),
])
def test_flash_kernel_matches_plain(cuda_device, dtype, window, segmented, H,
                                    Hkv, hd):
    B, S = 2, 200
    q = _cuda_pair((B, S, H, hd), dtype, cuda_device, 0)
    k = _cuda_pair((B, S, Hkv, hd), dtype, cuda_device, 1)
    v = _cuda_pair((B, S, Hkv, hd), dtype, cuda_device, 2)
    seg = None
    if segmented:
        seg = torch.full((B, S), -1, dtype=torch.int32)
        seg[:, :90], seg[:, 90:170] = 0, 1
        seg = seg.to(cuda_device)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              segment_ids=seg)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                   segment_ids=seg)
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("W,H,Hkv,hd", [
    (2048, 32, 8, 128),  # llama3-8b: G = 4
    (300, 4, 4, 64),  # G = 1, W not a multiple of the tile
    (512, 24, 2, 32),  # G = 12
    (256, 16, 2, 128),  # G = 8
])
def test_decode_kernel_matches_plain(cuda_device, dtype, W, H, Hkv, hd):
    B = 8
    q = _cuda_pair((B, 1, H, hd), dtype, cuda_device, 0)
    k = _cuda_pair((B, W, Hkv, hd), dtype, cuda_device, 1)
    v = _cuda_pair((B, W, Hkv, hd), dtype, cuda_device, 2)
    lens = torch.tensor([0, 1, 31, 33, W // 3, W // 2, W - 1, W],
                        dtype=torch.int32, device=cuda_device)
    ops.reset_launches()
    got = ops.decode_attention(q, k, v, lens)
    assert ops.LAUNCHES["decode_attention"] == 1
    want = ref.decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)
    assert (got[0] == 0).all()


def _paged_case(B, n_pages, H, Hkv, hd, lens, dtype, dev, seed):
    """A shuffled block pool where rows 0/1 and 2/3 share their first half
    of pages (a shared prefix), its page table, and the same K/V laid out
    densely [B, n_pages * PAGE, Hkv, hd] for the ring kernel."""
    page = 16
    g = torch.Generator().manual_seed(seed)
    N = 1 + B * n_pages
    kb = torch.randn((N, page, Hkv, hd), generator=g)
    vb = torch.randn((N, page, Hkv, hd), generator=g)
    kb[0] = vb[0] = 0.0  # the zero sentinel
    ids = (torch.randperm(N - 1, generator=g) + 1).tolist()
    pt = torch.zeros((B, n_pages), dtype=torch.int32)
    for b in range(B):
        for j in range(-(-lens[b] // page)):
            if b % 2 and j < n_pages // 2:
                pt[b, j] = pt[b - 1, j]  # shared prefix block
            else:
                pt[b, j] = ids.pop()
    dense = [blk[pt.long()].reshape(B, n_pages * page, Hkv, hd)
             for blk in (kb, vb)]
    q = torch.randn((B, 1, H, hd), generator=g)
    cast = lambda t: t.to(device=dev, dtype=TDT[dtype])  # noqa: E731
    return (cast(q), cast(kb), cast(vb), pt.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev),
            cast(dense[0]), cast(dense[1]))


PAGED_EDGE_LENS = (0, 1, 15, 16, 17, 31, 32, 33)  # page and tile edges


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n_pages,H,Hkv,hd", [
    (128, 32, 8, 128),  # llama3-8b at max_seq 2048: G = 4
    (8, 4, 4, 64),  # G = 1
    (20, 24, 2, 32),  # G = 12
])
def test_paged_decode_kernel_matches_plain_and_ring(cuda_device, dtype,
                                                    n_pages, H, Hkv, hd,
                                                    splits):
    """Through ops at the launchers' split count, then at each forced one:
    the paged kernel against its plain version, and bitwise against the
    ring kernel on the same K/V laid out densely (one template, one split
    plan, the same keys in the same order)."""
    W = n_pages * 16
    lens = [*PAGED_EDGE_LENS, W // 3, W // 2 + 5, W - 1, W]
    q, kb, vb, pt, lens_d, kd, vd = _paged_case(len(lens), n_pages, H, Hkv,
                                                hd, lens, dtype, cuda_device, 0)
    ops.reset_launches()
    got = ops.paged_decode_attention(q, kb, vb, pt, lens_d)
    assert ops.LAUNCHES["paged_decode_attention"] == 1
    want = ref.paged_decode_attention_ref(q, kb, vb, pt, lens_d)
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)
    assert (got[0] == 0).all()
    assert torch.equal(got, ops.decode_attention(q, kd, vd, lens_d))
    got = _pdec.launch(q, kb, vb, pt, lens_d, scale=hd ** -0.5,
                       _splits=splits)
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)
    ring = _dec.launch(q, kd, vd, lens_d, scale=hd ** -0.5, w_real=W,
                       _splits=splits)
    assert torch.equal(got, ring)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 8])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("H,Hkv", [
    (48, 1),  # granite-34b: G = 48, three full groups of 16
    (40, 2),  # G = 20: a group of 16 and one of 4
])
def test_decode_kernels_any_group_size(cuda_device, dtype, H, Hkv, splits):
    """More than 16 query heads a KV head, at hd 128: the ring and paged
    kernels against their plain versions, at the launchers' split count
    (None) and forced ones, and the paged kernel bitwise the ring one."""
    n_pages, hd = 64, 128
    W = n_pages * 16
    lens = [*PAGED_EDGE_LENS, W // 2 + 5, W]
    q, kb, vb, pt, lens_d, kd, vd = _paged_case(len(lens), n_pages, H, Hkv,
                                                hd, lens, dtype, cuda_device, 1)
    want = ref.paged_decode_attention_ref(q, kb, vb, pt, lens_d)
    if splits is None:
        ops.reset_launches()
        ring = ops.decode_attention(q, kd, vd, lens_d)
        paged = ops.paged_decode_attention(q, kb, vb, pt, lens_d)
        assert ops.LAUNCHES["decode_attention"] == 1
        assert ops.LAUNCHES["paged_decode_attention"] == 1
    else:
        ring = _dec.launch(q, kd, vd, lens_d, scale=hd ** -0.5, w_real=W,
                           _splits=splits)
        paged = _pdec.launch(q, kb, vb, pt, lens_d, scale=hd ** -0.5,
                             _splits=splits)
    for got in (ring, paged):
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOLS[dtype], rtol=1e-2)
        assert (got[0] == 0).all()
    assert torch.equal(paged, ring)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("window,H,Hkv,hd", [
    (0, 8, 2, 128),
    (40, 8, 2, 128),
    (0, 6, 3, 32),
])
def test_flash_kernel_with_prior_matches_plain(cuda_device, dtype, window, H,
                                               Hkv, hd):
    B, S, Pp = 3, 70, 96
    q = _cuda_pair((B, S, H, hd), dtype, cuda_device, 0)
    k = _cuda_pair((B, S, Hkv, hd), dtype, cuda_device, 1)
    v = _cuda_pair((B, S, Hkv, hd), dtype, cuda_device, 2)
    pk = _cuda_pair((B, Pp, Hkv, hd), dtype, cuda_device, 3)
    pv = _cuda_pair((B, Pp, Hkv, hd), dtype, cuda_device, 4)
    valid = torch.tensor([96, 48, 0], dtype=torch.int32, device=cuda_device)
    kw = dict(causal=True, window=window, prior_k=pk, prior_v=pv,
              prior_valid=valid)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, sq_real=61, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, sq_real=61, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)
    # a row with no valid prior is the plain prefill, bitwise
    plain = ops.flash_attention(q, k, v, causal=True, window=window,
                                sq_real=61)
    assert torch.equal(got[2], plain[2])


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,causal,H,Hkv,hd", [
    (1, 1, True, 4, 4, 128),  # one row of one 64-row q-tile
    (63, 63, True, 8, 2, 128),  # one short of a q-tile
    (65, 65, True, 8, 2, 64),  # one past it
    (200, 200, True, 12, 1, 32),  # G = 12, ragged last tile
    (63, 300, False, 4, 1, 128),  # Sq < Skv, non-causal, G = 4
    (65, 129, False, 12, 1, 64),
    (130, 1000, False, 8, 8, 32),  # G = 1
])
def test_flash_bf16_tile_edges(cuda_device, Sq, Skv, causal, H, Hkv, hd):
    """The tensor-core path (bf16) at the edges of its 64-row q-tiles and
    64-key K/V tiles, at every head dim and group it takes."""
    B = 2
    q = _cuda_pair((B, Sq, H, hd), "bf16", cuda_device, 0)
    k = _cuda_pair((B, Skv, Hkv, hd), "bf16", cuda_device, 1)
    v = _cuda_pair((B, Skv, Hkv, hd), "bf16", cuda_device, 2)
    kw = dict(causal=causal, skv_real=max(1, Skv - 3),
              sq_real=max(1, Sq - 2))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(q, k, v, **kw).float(),
                               atol=TOLS["bf16"], rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_bf16_window_and_segments(cuda_device, hd):
    """A sliding window with packed segments whose cuts fall inside tiles:
    every tile takes the masked path."""
    B, S, H, Hkv = 2, 300, 8, 2
    q = _cuda_pair((B, S, H, hd), "bf16", cuda_device, 3)
    k = _cuda_pair((B, S, Hkv, hd), "bf16", cuda_device, 4)
    v = _cuda_pair((B, S, Hkv, hd), "bf16", cuda_device, 5)
    seg = torch.full((B, S), -1, dtype=torch.int32)
    seg[0, :70], seg[0, 70:201], seg[0, 201:290] = 0, 1, 2
    seg[1, :129], seg[1, 129:300] = 0, 1
    seg = seg.to(cuda_device)
    kw = dict(causal=True, window=90, segment_ids=seg)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(q, k, v, **kw).float(),
                               atol=TOLS["bf16"], rtol=1e-2)


def _packed_seg(layout, T):
    """Segment ids [T] of a packed row: contiguous runs of the given
    lengths, then a pad run (-1) to T."""
    seg = torch.full((T,), -1, dtype=torch.int32)
    off = 0
    for j, n in enumerate(layout):
        seg[off:off + n] = j
        off += n
    assert off <= T
    return seg


_rng40 = np.random.default_rng(40)
PACKED_LAYOUTS = {
    # runs starting on, one before and one after the 64-row tile edges 64
    # and 128, then a long run across two edges and a pad tail
    "tile_edges": (300, 0, [63, 1, 1, 62, 1, 1, 62, 69],
                   [64, 1, 62, 2, 64, 70]),
    # a pad run from 100 covers the q-tiles [128, 192) and [192, 256)
    "pad_tiles": (256, 0, [40, 60], [100]),
    # one segment over the whole row: every off-diagonal tile unmasked
    "one_segment": (300, 0, [300], [299]),
    # 40 segments shorter than a tile
    "forty_short": (512, 0, [int(n) for n in _rng40.integers(1, 12, 40)],
                    [int(n) for n in _rng40.integers(1, 12, 40)]),
    # segments under a sliding window, cut inside tiles
    "window": (300, 90, [70, 131, 89], [129, 171]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(PACKED_LAYOUTS))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_packed_segments_match_plain(cuda_device, dtype, hd, layout):
    """Packed rows (two per launch, laid out differently): the key sweep
    starts at the tile of each q-tile's first run start, and a tile whose
    keys and rows lie in one run takes the unmasked route; both held to the
    plain version, which masks by id alone. Passing the run starts built
    once (as the model does) gives the wrapper's own result bitwise."""
    T, window, row0, row1 = PACKED_LAYOUTS[layout]
    B, H, Hkv = 2, 8, 2
    q = _cuda_pair((B, T, H, hd), dtype, cuda_device, 20)
    k = _cuda_pair((B, T, Hkv, hd), dtype, cuda_device, 21)
    v = _cuda_pair((B, T, Hkv, hd), dtype, cuda_device, 22)
    seg = torch.stack([_packed_seg(row0, T), _packed_seg(row1, T)]).to(
        cuda_device)
    kw = dict(causal=True, window=window, segment_ids=seg)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(q, k, v, **kw).float(),
                               atol=TOLS[dtype], rtol=1e-2)
    starts = ops.segment_run_starts(seg)
    assert torch.equal(got, ops.flash_attention(q, k, v, segment_starts=starts,
                                                **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_packed_mqa(cuda_device, dtype):
    """granite-34b's heads (48 query heads on one KV head, hd 128) on a
    packed row with a pad tail."""
    T, H, Hkv, hd = 200, 48, 1, 128
    q = _cuda_pair((1, T, H, hd), dtype, cuda_device, 23)
    k = _cuda_pair((1, T, Hkv, hd), dtype, cuda_device, 24)
    v = _cuda_pair((1, T, Hkv, hd), dtype, cuda_device, 25)
    seg = _packed_seg([65, 30, 64], T)[None].to(cuda_device)
    kw = dict(causal=True, segment_ids=seg)
    torch.testing.assert_close(ops.flash_attention(q, k, v, **kw).float(),
                               ref.flash_attention_ref(q, k, v, **kw).float(),
                               atol=TOLS[dtype], rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_chunk_dense_prior(cuda_device, dtype, hd, window):
    """The chunk path: one [1, C] chunk (C = 64) against the request's
    dense max_seq-wide prior (256 slots), prior_valid 0, C - 1, C and
    max_seq - C; the slots past prior_valid hold stale KV the mask must
    hide."""
    C, Pp, H, Hkv = 64, 256, 8, 2
    q = _cuda_pair((1, C, H, hd), dtype, cuda_device, 26)
    k = _cuda_pair((1, C, Hkv, hd), dtype, cuda_device, 27)
    v = _cuda_pair((1, C, Hkv, hd), dtype, cuda_device, 28)
    pk = _cuda_pair((1, Pp, Hkv, hd), dtype, cuda_device, 29)
    pv = _cuda_pair((1, Pp, Hkv, hd), dtype, cuda_device, 30)
    for valid in (0, C - 1, C, Pp - C):
        kw = dict(causal=True, window=window, prior_k=pk, prior_v=pv,
                  prior_valid=torch.tensor([valid], dtype=torch.int32,
                                           device=cuda_device))
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, sq_real=C - 3, **kw).float(),
            ref.flash_attention_ref(q, k, v, sq_real=C - 3, **kw).float(),
            atol=TOLS[dtype], rtol=1e-2, msg=lambda m: f"valid {valid}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("N", [512, 524288])
def test_rmsnorm_kernel_qk_norm_widths(cuda_device, N, dtype):
    """qwen3's qk-norm at head_dim 128: a decode step's queries (8 rows x
    64 heads) and an 8 x 1024 prefill bucket's (524288 rows)."""
    x = _cuda_pair((N, 128), dtype, cuda_device, N)
    w = _cuda_pair((128,), dtype, cuda_device, 3)
    torch.testing.assert_close(ops.rmsnorm(x, w).float(),
                               ref.rmsnorm_ref(x, w).float(),
                               atol=TOLS[dtype], rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("window,hd", [(0, 128), (70, 128), (0, 64), (50, 32)])
def test_flash_bf16_prior_valid_edges(cuda_device, window, hd):
    """A prior of 130 keys (two whole 64-key tiles and a ragged one) with
    prior_valid 0, partial (on and off a tile edge) and full; a row with no
    valid prior is the plain prefill, bitwise."""
    B, S, Pp, H, Hkv = 4, 65, 130, 8, 2
    q = _cuda_pair((B, S, H, hd), "bf16", cuda_device, 6)
    k = _cuda_pair((B, S, Hkv, hd), "bf16", cuda_device, 7)
    v = _cuda_pair((B, S, Hkv, hd), "bf16", cuda_device, 8)
    pk = _cuda_pair((B, Pp, Hkv, hd), "bf16", cuda_device, 9)
    pv = _cuda_pair((B, Pp, Hkv, hd), "bf16", cuda_device, 10)
    valid = torch.tensor([0, 64, 77, Pp], dtype=torch.int32,
                         device=cuda_device)
    kw = dict(causal=True, window=window, prior_k=pk, prior_v=pv,
              prior_valid=valid)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(q, k, v, **kw).float(),
                               atol=TOLS["bf16"], rtol=1e-2)
    plain = ops.flash_attention(q, k, v, causal=True, window=window)
    assert torch.equal(got[0], plain[0])


def _decode_lens(kind, W):
    if kind == "edges":  # on and around tile and split boundaries
        return [0, 1, 31, 32, 33, W // 8, W // 8 + 1, W]
    return [0, 0, 0, W, 0, 0, 0, 0]  # one long row among empty ones


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["edges", "one_long"])
@pytest.mark.parametrize("W,H,Hkv,hd", [
    (2048, 32, 8, 128),  # llama3-8b: G = 4
    (1000, 32, 2, 64),  # G = 16: one full head group
    (520, 8, 8, 32),  # G = 1
])
def test_decode_split_edges_match_plain(cuda_device, dtype, kind, W, H, Hkv,
                                        hd):
    """The split kernel with the launcher's split count (one launch), then
    with each forced count, against the plain version."""
    B = 8
    q = _cuda_pair((B, 1, H, hd), dtype, cuda_device, 0)
    k = _cuda_pair((B, W, Hkv, hd), dtype, cuda_device, 1)
    v = _cuda_pair((B, W, Hkv, hd), dtype, cuda_device, 2)
    lens = torch.tensor(_decode_lens(kind, W), dtype=torch.int32,
                        device=cuda_device)
    want = ref.decode_attention_ref(q, k, v, lens)
    ops.reset_launches()
    got = ops.decode_attention(q, k, v, lens)
    assert ops.LAUNCHES["decode_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)
    for splits in (1, 2, 4, 8):
        got = _dec.launch(q, k, v, lens, scale=hd ** -0.5, w_real=W,
                          _splits=splits)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOLS[dtype], rtol=1e-2)
        assert (got[lens == 0] == 0).all()


def _ssd_case(S, dtype, dev, seed, nh=24, hd=64, ds=128, b=1, strong=False):
    """tests/test_kernels.py's SSD inputs at mamba2-130m's widths, with x,
    B and C read as the model reads them: strided views of one conv-output
    row [b, S, nh * hd + 2 ds]. With ``strong`` decay A is uniform in
    -[4, 16) (the span of Mamba-2's A init): dt |A| up to about 5."""
    g = torch.Generator().manual_seed(seed)
    xBC = torch.randn((b, S, nh * hd + 2 * ds), generator=g)
    dt = torch.randn((b, S, nh), generator=g).abs() * 0.1 + 0.01
    A = -torch.randn((nh,), generator=g).abs() - 0.1
    if strong:
        A = -torch.rand((nh,), generator=g) * 12.0 - 4.0
    xBC = xBC.to(device=dev, dtype=TDT[dtype])
    x = xBC[..., :nh * hd].reshape(b, S, nh, hd)
    B = xBC[..., nh * hd:nh * hd + ds].reshape(b, S, 1, ds)
    C = xBC[..., nh * hd + ds:].reshape(b, S, 1, ds)
    return x, dt.to(dev), A.to(dev), B, C


def _ssd_hold(x, dt, A, B, C, dtype, chunk=256):
    """One ops.ssd_scan launch held to the plain version run in fp32 on the
    same input values, y and the final state, at SSD_TOLS and rtol 2e-2."""
    ops.reset_launches()
    y, st = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == 1
    torch.cuda.synchronize()
    want_y, want_st = ref.ssd_scan_ref(x.float(), dt, A, B.float(), C.float(),
                                       chunk)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert st.dtype == torch.float32 and st.shape == want_st.shape
    torch.testing.assert_close(y.float(), want_y.float(),
                               atol=SSD_TOLS[dtype], rtol=2e-2)
    torch.testing.assert_close(st, want_st, atol=SSD_TOLS[dtype], rtol=2e-2)
    return y, st


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S", [77, 1000, 1024])  # < 1 chunk, ragged, 4 chunks
def test_ssd_kernel_matches_plain(cuda_device, dtype, S):
    """The kernels round differently from the plain version: on bf16 inputs
    the tensor-core path rounds its chunk-state operand, its decayed scores
    (dt folded in) and y, and carries the state as a bf16 hi/lo pair, while
    the plain version rounds its C.B^T and then its decayed scores, as the
    JAX model's ssd_chunked does. So the oracle is the plain version run in
    fp32 on the same input values (test_kernels.py likewise holds the
    Pallas kernel against an fp32 oracle)."""
    x, dt, A, B, C = _ssd_case(S, dtype, cuda_device, S)
    _ssd_hold(x, dt, A, B, C, dtype)


SSD_EDGE_LENS = [1, 63, 64, 65, 255, 256, 257, 1000, 1024, 2048]
# mamba2-130m's SSD widths (24 heads of 64, d_state 128) and jamba-v0.1-52b's
# (8192 / 64 = 128 heads of 64, d_state 16)
SSD_WIDTHS = {"mamba2": {}, "jamba": dict(nh=128, hd=64, ds=16)}


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(SSD_WIDTHS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("S", SSD_EDGE_LENS)
def test_ssd_kernel_at_chunk_edges(cuda_device, S, b, chunk, dtype, width):
    """Every tile and chunk edge of both kernels (the bf16 path's 64-position
    chunks, the fp32 kernel's 64-row tiles and its chunk of 64 or 256), one
    and three batch rows, through the model's strided views (no padded copy
    of the state at d_state 16)."""
    x, dt, A, B, C = _ssd_case(S, dtype, cuda_device, 10 * S + b, b=b,
                               **SSD_WIDTHS[width])
    _ssd_hold(x, dt, A, B, C, dtype, chunk=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(SSD_WIDTHS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S", [65, 1000, 2048])
def test_ssd_kernel_under_strong_decay(cuda_device, S, dtype, width):
    """dt |A| up to about 5: exp(cums) underflows within a chunk, the decay
    of the carried state reaches 0, and the scores' decay spans many
    orders of magnitude."""
    x, dt, A, B, C = _ssd_case(S, dtype, cuda_device, S + 5, b=2, strong=True,
                               **SSD_WIDTHS[width])
    assert float((dt * A.abs()).max()) > 3.0
    _ssd_hold(x, dt, A, B, C, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ssd_kernel_at_its_largest_grid(cuda_device, dtype):
    """b=8, S=2048: in bf16 256 chunks of 64, the bf16 launches' largest
    scratch (400 MB) and grid on the serving paths (max_batch 8, max_seq
    2048); in fp32 (one CTA per 16 head-dim columns whatever S) the
    longest chain of chunk states a row carries."""
    x, dt, A, B, C = _ssd_case(2048, dtype, cuda_device, 8, b=8)
    _ssd_hold(x, dt, A, B, C, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(SSD_WIDTHS))
@pytest.mark.parametrize("S", [63, 1000, 2048])
def test_ssd_bf16_heads_per_cta_agree_bitwise(cuda_device, S, width):
    """The bf16 launches give the same bits whatever the heads a CTA takes
    (every HEAD_GROUPS entry, a last CTA short of heads where the entry
    does not divide the heads): a head's arithmetic does not depend on its
    group, and C.B^T is the same product in every CTA of a chunk."""
    from repro_torch.kernels import ssd_scan as _ssd

    x, dt, A, B, C = _ssd_case(S, "bf16", cuda_device, S, **SSD_WIDTHS[width])
    y1, st1 = _ssd.launch(x, dt, A, B, C, chunk=256, _heads=1)
    for g in _ssd.HEAD_GROUPS[1:]:
        y, st = _ssd.launch(x, dt, A, B, C, chunk=256, _heads=g)
        assert torch.equal(y, y1) and torch.equal(st, st1), g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv", [
    (2, 300, 300),  # seamless's encoder: bidirectional over the frames
    (4, 2, 512),  # its cross-attention: a 2-token prompt over 512 frames
    (2, 77, 200),  # Sq != Skv, neither a multiple of a tile
])
def test_flash_kernel_non_causal(cuda_device, dtype, B, Sq, Skv):
    """flash with causal=False at seamless's head dim (16 heads of 64), Sq
    == Skv and Sq != Skv, against the plain version."""
    q = _cuda_pair((B, Sq, 16, 64), dtype, cuda_device, 3)
    k = _cuda_pair((B, Skv, 16, 64), dtype, cuda_device, 4)
    v = _cuda_pair((B, Skv, 16, 64), dtype, cuda_device, 5)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=False)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_kernel_over_a_static_cross_cache(cuda_device, dtype):
    """The decode kernel over seamless's cross leaves: every one of the F
    encoder rows valid, G = 1."""
    B, F_ = 4, 1024
    q = _cuda_pair((B, 1, 16, 64), dtype, cuda_device, 6)
    k = _cuda_pair((B, F_, 16, 64), dtype, cuda_device, 7)
    v = _cuda_pair((B, F_, 16, 64), dtype, cuda_device, 8)
    full = torch.full((B,), F_, dtype=torch.int32, device=cuda_device)
    ops.reset_launches()
    got = ops.decode_attention(q, k, v, full)
    assert ops.LAUNCHES["decode_attention"] == 1
    want = ref.decode_attention_ref(q, k, v, full)
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)


@pytest.mark.cuda
def test_mamba_engine_on_card_matches_cpu(cuda_device):
    """A 2-layer Mamba-2 stack at the kernel's widths (d_state 128, head_dim
    64, chunk 64) served on the card: one exact prefill per request, the
    SSD kernel once per layer per prefill, no attention kernel, and the CPU
    engine's greedy tokens on the same weights (fp32)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_map
    from repro_torch.serving import Request, ServingEngine

    base = get_config("mamba2-130m").reduced()
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, d_state=128, head_dim=64, chunk=64))
    gpu = Model(cfg, dtype=torch.float32, device=cuda_device)
    params = gpu.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
               for s in (5, 70, 130, 9, 200)]

    def serve(model, p, device):
        eng = ServingEngine(model, p, max_batch=2, max_seq=256, device=device)
        reqs = [Request(prompt_tokens=t, max_new_tokens=6) for t in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.generated for r in reqs], eng

    ops.reset_launches()
    got, eng = serve(gpu, params, cuda_device)
    c = eng.counters()
    L = cfg.n_layers
    assert c["prefill_calls"] == len(prompts)
    assert ops.LAUNCHES == {
        "rmsnorm": (2 * L + 1) * (c["prefill_calls"] + c["decode_steps"]),
        "flash_attention": 0, "decode_attention": 0,
        "paged_decode_attention": 0, "ssd_scan": L * c["prefill_calls"],
        "preprocess": 0,
        "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
        "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0,
    }
    assert eng.logits_all_finite()
    want, ceng = serve(cpu, params_cpu, "cpu")
    assert got == want
    assert ceng.counters() == c


@pytest.mark.cuda
def test_paged_engine_on_card_matches_cpu_and_ring(cuda_device):
    """A reduced llama3 served paged with prefix reuse on the card: launch
    counts follow the path's structure, the greedy tokens are the CPU
    paged engine's on the same weights (fp32), and the card's paged engine
    without reuse gives the card's ring engine's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_map
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("llama3-8b").reduced()
    gpu = Model(cfg, dtype=torch.float32, device=cuda_device)
    params = gpu.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    rng = np.random.default_rng(0)
    fams = [rng.integers(0, cfg.vocab_size, 48, dtype=np.int32)
            for _ in range(2)]
    prompts = [np.concatenate([f, rng.integers(0, cfg.vocab_size, n,
                                               dtype=np.int32)])
               for n in (5, 17, 30) for f in fams]

    def serve(model, p, device, **kw):
        eng = ServingEngine(model, p, max_batch=2, max_seq=128, device=device,
                            **kw)
        reqs = [Request(prompt_tokens=t, max_new_tokens=6) for t in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.generated for r in reqs], eng

    ops.reset_launches()
    got, eng = serve(gpu, params, cuda_device, paged=True)
    c = eng.counters()
    L = cfg.n_layers
    assert c["prefix_hits"] > 0
    assert ops.LAUNCHES == {
        "rmsnorm": (2 * L + 1) * (c["prefill_calls"] + c["decode_steps"]),
        "flash_attention": L * c["prefill_calls"],
        "decode_attention": 0,
        "paged_decode_attention": L * c["decode_steps"],
        "ssd_scan": 0,
        "preprocess": 0,
        "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
        "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0,
    }
    assert eng.logits_all_finite()
    want, ceng = serve(cpu, params_cpu, "cpu", paged=True)
    assert got == want
    assert ceng.counters() == c
    # one split-KV template and one split plan for both pools: the same
    # keys through the same arithmetic, so the tokens agree exactly
    ring, _ = serve(gpu, params, cuda_device)
    paged, _ = serve(gpu, params, cuda_device, paged=True, prefix_reuse=False)
    assert paged == ring


@pytest.mark.cuda
def test_engine_on_card_goes_through_every_kernel(cuda_device):
    """A reduced llama3 served on the card launches each kernel exactly as
    the path's structure says, and agrees with the CPU engine's greedy
    tokens on the same weights (fp32)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_map
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("llama3-8b").reduced()
    gpu = Model(cfg, dtype=torch.float32, device=cuda_device)
    params = gpu.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
               for s in (5, 17, 33, 50)]

    def serve(model, p, device):
        eng = ServingEngine(model, p, max_batch=2, max_seq=128, device=device)
        reqs = [Request(prompt_tokens=t, max_new_tokens=6) for t in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.generated for r in reqs], eng

    ops.reset_launches()
    got, eng = serve(gpu, params, cuda_device)
    c = eng.counters()
    L = cfg.n_layers
    assert ops.LAUNCHES == {
        "rmsnorm": (2 * L + 1) * (c["prefill_calls"] + c["decode_steps"]),
        "flash_attention": L * c["prefill_calls"],
        "decode_attention": L * c["decode_steps"],
        "paged_decode_attention": 0,
        "ssd_scan": 0,
        "preprocess": 0,
        "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
        "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0,
    }
    assert eng.logits_all_finite()
    want, _ = serve(cpu, params_cpu, "cpu")
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-32b", "granite-34b"])
def test_packed_chunked_engine_on_card_matches_cpu(cuda_device, name):
    """Packed + chunked prefill (C = 32) on the card, reduced configurations
    in fp32: each kernel launched as the path's structure says (flash once
    a layer per prefill call, packed or a chunk alike; qwen3's qk-norm adds
    two rmsnorm launches a layer), and the CPU engine's greedy tokens on the
    same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_map
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(name).reduced()
    gpu = Model(cfg, dtype=torch.float32, device=cuda_device)
    params = gpu.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
               for s in (5, 17, 33, 50, 70, 9)]

    def serve(model, p, device):
        eng = ServingEngine(model, p, max_batch=4, max_seq=128, packed=True,
                            prefill_chunk=32, device=device)
        reqs = [Request(prompt_tokens=t, max_new_tokens=6) for t in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.generated for r in reqs], eng

    ops.reset_launches()
    got, eng = serve(gpu, params, cuda_device)
    c = eng.counters()
    L = cfg.n_layers
    per_layer = 4 if cfg.qk_norm else 2
    assert ops.LAUNCHES == {
        "rmsnorm": (per_layer * L + 1) * (c["prefill_calls"]
                                          + c["decode_steps"]),
        "flash_attention": L * c["prefill_calls"],
        "decode_attention": L * c["decode_steps"],
        "paged_decode_attention": 0,
        "ssd_scan": 0,
        "preprocess": 0,
        "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
        "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0,
    }
    assert eng.logits_all_finite()
    want, cpu_eng = serve(cpu, params_cpu, "cpu")
    assert got == want
    assert c == cpu_eng.counters()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 128), (100, 512), (1000, 64),
                                   (8, 480, 640, 3)])
def test_preprocess_kernel_matches_plain(cuda_device, dtype, shape):
    """The Triton kernel at tests/test_kernels.py's shapes and the paper's
    batch of 8 camera frames: it multiplies by fp32(1/255) where the plain
    version divides by 255 (one fp32 rounding step of x/255 at most)."""
    rng = np.random.default_rng(0)
    D = shape[-1]
    x = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
    mean = torch.from_numpy((np.abs(rng.normal(size=D)) * 0.4 + 0.1)
                            .astype(np.float32))
    std = torch.from_numpy((np.abs(rng.normal(size=D)) * 0.2 + 0.3)
                           .astype(np.float32))
    x, mean, std = (t.to(cuda_device) for t in (x, mean, std))
    ops.reset_launches()
    got = ops.preprocess(x, mean, std, out_dtype=TDT[dtype])
    assert ops.LAUNCHES["preprocess"] == 1
    torch.cuda.synchronize()
    want = ref.preprocess_ref(x, mean, std, TDT[dtype])
    assert got.dtype == want.dtype and got.shape == want.shape
    atol = {"fp32": 5e-7, "bf16": 1e-2}[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct_hbm", "direct_dma", "host_staged"])
def test_disaggregated_engine_on_card_matches_cpu(cuda_device, mode):
    """A reduced llama3 served disaggregated on the card, ring path and
    paged path with prefix reuse, against the same engine on the CPU on
    the same weights (fp32): the same greedy tokens and every counter, the
    handoff's included; the card's launches follow the path."""
    from repro_torch.configs import get_config
    from repro_torch.core.transfer import TransferMode
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_map
    from repro_torch.serving import DisaggregatedEngine, Request

    cfg = get_config("llama3-8b").reduced()
    gpu = Model(cfg, dtype=torch.float32, device=cuda_device)
    params = gpu.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    rng = np.random.default_rng(0)
    fams = [rng.integers(0, cfg.vocab_size, 48, dtype=np.int32)
            for _ in range(2)]
    prompts = [np.concatenate([f, rng.integers(0, cfg.vocab_size, n,
                                               dtype=np.int32)])
               for n in (5, 17, 30) for f in fams]

    def serve(model, p, device, **kw):
        eng = DisaggregatedEngine(model, p, transfer_mode=TransferMode(mode),
                                  max_batch=2, max_seq=128, device=device,
                                  **kw)
        reqs = [Request(prompt_tokens=t, max_new_tokens=6) for t in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.generated for r in reqs], eng

    for kw in ({}, {"paged": True}):
        ops.reset_launches()
        got, eng = serve(gpu, params, cuda_device, **kw)
        c = eng.counters()
        L = cfg.n_layers
        decode = "paged_decode_attention" if kw else "decode_attention"
        want_launches = {
            "rmsnorm": (2 * L + 1) * (c["prefill_calls"] + c["decode_steps"]),
            "flash_attention": L * c["prefill_calls"], "decode_attention": 0,
            "paged_decode_attention": 0, "ssd_scan": 0, "preprocess": 0,
            "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0}
        want_launches[decode] = L * c["decode_steps"]
        assert ops.LAUNCHES == want_launches
        assert c["handoffs"] > 0
        if kw:
            assert c["prefix_hits"] > 0
            assert c["handoff_wire_bytes"] == c["handoff_payload_bytes"]
        want, ceng = serve(cpu, params_cpu, "cpu", **kw)
        assert got == want
        assert ceng.counters() == c
        # measured on the card: each request's 'transfer' is a share of the
        # hop wall the engine timed
        assert sum(r.stage_s["transfer"] for r in eng.store.records) == (
            pytest.approx(eng.handoff_wall_s))


# --------------------------------------------------------------------------- #
# the decode step as one CUDA graph: replays against the eager step
# --------------------------------------------------------------------------- #
def _graph_pair(cfg, dev, dtype, seed=0):
    from repro_torch.models import Model

    model = Model(cfg, dtype=dtype, device=dev)
    return model, model.init(torch.Generator(device=dev).manual_seed(seed))


def _pool_state(pool):
    kv = pool.blocks if pool.paged else pool.caches
    leaves = []
    _tree_leaves(kv, leaves)
    return [pool.tokens, pool.lengths, pool.done, pool.gen] + leaves


def _tree_leaves(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _tree_leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _tree_leaves(v, out)
    else:
        out.append(tree)


def _lockstep(model, params, waves, new, steps=40, **kw):
    """Serve ``waves`` of prompts (each wave submitted after the one before
    has run 5 engine steps) on an eager engine (``_graph=False``) and a
    graph engine in lockstep, and hold their whole pool state -- tokens,
    lengths, done flags, counts and every KV (or conv/state) leaf --
    bitwise equal after every engine step, until ``steps`` decode steps
    went out. Returns the two engines and their requests' tokens."""
    from repro_torch.serving import Request, ServingEngine

    engines = [ServingEngine(model, params, device=model.device, _graph=g,
                             **kw) for g in (False, True)]
    reqs = [[], []]
    it, i = 0, 0
    while engines[1].decode_steps < steps:
        if i < len(waves) and it % 5 == 0:
            for eng, rs in zip(engines, reqs):
                for t in waves[i]:
                    rs.append(Request(prompt_tokens=t.copy(),
                                      max_new_tokens=new))
                    eng.submit(rs[-1])
            i += 1
        for eng in engines:
            eng.step()
        it += 1
        for a, b in zip(*(_pool_state(e.pool) for e in engines)):
            assert torch.equal(a, b), f"state parts at engine step {it}"
        assert it < 10 * steps
    for eng in engines:
        eng.run_until_drained()
    eager, graph = engines
    assert eager.pool._graph is None and graph.pool._graph is not None
    assert graph.pool.graph_replays == graph.decode_steps - 1
    assert eager.counters() == graph.counters()
    return engines, [[r.generated for r in rs] for rs in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, None])
def test_graph_ring_step_equals_eager(cuda_device, monkeypatch, splits):
    """The ring pool's replayed step equals the eager step bitwise over 40
    steps, at one CTA a row and at the launcher's split over a cluster
    (the captured cluster launch keeps its cluster); the launch counts
    follow the path under replay."""
    from repro_torch.configs import get_config

    cfg = get_config("llama3-8b").reduced()
    model, params = _graph_pair(cfg, cuda_device, torch.bfloat16)
    if splits is None:
        assert _dec.splits_for(512, 4 * cfg.n_kv_heads,
                               cuda_device.index or 0) > 1
    else:
        monkeypatch.setattr(_dec, "splits_for", lambda W, rows, dev: splits)
    rng = np.random.default_rng(1)
    waves = [[rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
              for s in (7, 40, 100)], [rng.integers(0, cfg.vocab_size, 60,
                                                    dtype=np.int32)]]
    ops.reset_launches()
    (eager, graph), toks = _lockstep(model, params, waves, 45, max_batch=4,
                                     max_seq=512)
    assert toks[0] == toks[1]
    L = cfg.n_layers
    steps = eager.decode_steps + graph.decode_steps
    calls = eager.counters()["prefill_calls"] * 2
    assert ops.LAUNCHES == {
        "rmsnorm": (2 * L + 1) * (calls + steps),
        "flash_attention": L * calls, "decode_attention": L * steps,
        "paged_decode_attention": 0, "ssd_scan": 0, "preprocess": 0,
        "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
        "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0}


@pytest.mark.cuda
def test_graph_paged_step_equals_eager(cuda_device):
    """The paged pool's replayed step equals the eager step bitwise while
    admissions and releases edit the page table between replays (prefix
    reuse on: shared blocks in several rows)."""
    from repro_torch.configs import get_config

    cfg = get_config("llama3-8b").reduced()
    model, params = _graph_pair(cfg, cuda_device, torch.bfloat16)
    rng = np.random.default_rng(2)
    fam = rng.integers(0, cfg.vocab_size, 48, dtype=np.int32)
    waves = [[np.concatenate([fam, rng.integers(0, cfg.vocab_size, n,
                                                dtype=np.int32)])
              for n in ns] for ns in ((5, 30), (17,), (9, 40))]
    (eager, graph), toks = _lockstep(model, params, waves, 20, max_batch=4,
                                     max_seq=256, paged=True)
    assert toks[0] == toks[1]
    assert graph.counters()["prefix_hits"] > 0


@pytest.mark.cuda
def test_graph_ssm_step_equals_eager(cuda_device):
    """mamba2-130m's decode step (the conv window and state written in
    place) replayed equals the eager step bitwise."""
    import dataclasses

    from repro_torch.configs import get_config

    base = get_config("mamba2-130m").reduced()
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, d_state=128, head_dim=64, chunk=64))
    model, params = _graph_pair(cfg, cuda_device, torch.float32)
    rng = np.random.default_rng(3)
    waves = [[rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
              for s in (5, 70)], [rng.integers(0, cfg.vocab_size, 130,
                                               dtype=np.int32)]]
    ops.reset_launches()
    (eager, graph), toks = _lockstep(model, params, waves, 45, max_batch=2,
                                     max_seq=256)
    assert toks[0] == toks[1]
    L = cfg.n_layers
    c = eager.counters()
    assert ops.LAUNCHES["rmsnorm"] == 2 * (2 * L + 1) * (
        c["prefill_calls"] + c["decode_steps"])


@pytest.mark.cuda
def test_graph_sampling_equals_eager(cuda_device):
    """At temperature 0.8, top_k 50 and one seed, the replays draw what the
    eager steps draw: the pool's generator is registered with the graph,
    so each replay advances its Philox offset as an eager call does."""
    from repro_torch.configs import get_config

    cfg = get_config("llama3-8b").reduced()
    model, params = _graph_pair(cfg, cuda_device, torch.bfloat16)
    rng = np.random.default_rng(4)
    waves = [[rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
              for s in (9, 33, 64)]]
    _, toks = _lockstep(model, params, waves, 45, max_batch=4, max_seq=256,
                        temperature=0.8, top_k=50, sample_seed=5)
    assert toks[0] == toks[1]
    assert len({t for r in toks[1] for t in r}) > 10  # it did sample


@pytest.mark.cuda
def test_graph_warm_captures_at_construction(cuda_device):
    """warmup=True captures the decode graph at construction and leaves a
    pristine pool; the warmed engine's tokens are the cold engine's."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("llama3-8b").reduced()
    model, params = _graph_pair(cfg, cuda_device, torch.bfloat16)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
               for s in (5, 17, 33, 50)]
    out = []
    for warm in (True, False):
        eng = ServingEngine(model, params, max_batch=2, max_seq=128,
                            warmup=warm, device=cuda_device)
        if warm:
            assert eng.pool._graph is not None and eng.warm_s > 0
            assert bool(eng.pool.done.all()) and not eng.pool.lengths.any()
        reqs = [Request(prompt_tokens=t, max_new_tokens=8) for t in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        assert eng.pool.graph_replays == eng.decode_steps - (0 if warm else 1)
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]


@pytest.mark.cuda
def test_graph_capture_failure_raises(cuda_device):
    """A capture that fails raises out of the dispatch; the engine does not
    go on with the eager step."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("llama3-8b").reduced()
    model, params = _graph_pair(cfg, cuda_device, torch.bfloat16)
    eng = ServingEngine(model, params, max_batch=2, max_seq=128,
                        device=cuda_device)
    pool = eng.pool
    sample = pool.sample

    def failing(logits, rng):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("no capture today")
        return sample(logits, rng)

    pool.sample = failing
    eng.submit(Request(prompt_tokens=np.arange(9, dtype=np.int32),
                       max_new_tokens=8))
    with pytest.raises(RuntimeError, match="no capture today"):
        eng.run_until_drained()
    assert pool._graph is None and not pool.window and eng.decode_steps == 0
    with pytest.raises(RuntimeError, match="no capture today"):
        eng.step()
    assert pool._graph is None and eng.decode_steps == 0


# --------------------------------------------------------------------------- #
# the threaded pipeline and the in-process cluster on the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
def test_pipeline_unwarmed_captures_on_dispatch_thread(cuda_device):
    """An unwarmed EnginePipeline under traffic: its decode graph is
    captured on the dispatch thread (thread-local capture mode) while the
    harvest thread waits on earlier steps' events, every later dispatch
    replays it, and the tokens equal the step() loop's bitwise."""
    import threading

    from repro_torch.configs import get_config
    from repro_torch.serving import EnginePipeline, Request, ServingEngine

    cfg = get_config("llama3-8b").reduced()
    model, params = _graph_pair(cfg, cuda_device, torch.bfloat16)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
               for s in (5, 17, 33, 50, 9, 64, 21, 40)]

    def serve(front):
        reqs = [Request(prompt_tokens=t.copy(), max_new_tokens=12)
                for t in prompts]
        for r in reqs:
            front.submit(r)
        assert len(front.run_until_drained(max_steps=1_000_000)) == len(reqs)
        return [r.generated for r in reqs]

    want = serve(ServingEngine(model, params, max_batch=4, max_seq=128,
                               device=cuda_device))
    eng = ServingEngine(model, params, max_batch=4, max_seq=128,
                        device=cuda_device)
    captured_on = []
    capture = eng.pool._capture

    def spy(p):
        captured_on.append(threading.current_thread().name)
        return capture(p)

    eng.pool._capture = spy
    with EnginePipeline(eng) as pipe:
        got = serve(pipe)
        assert pipe.submitted == pipe.emitted == len(prompts)
    assert captured_on == ["engine-pipeline-dispatch"]
    assert eng.pool._graph is not None
    assert eng.pool.graph_replays == eng.decode_steps - 1
    assert got == want


@pytest.mark.cuda
def test_cluster_replicas_replay_their_own_graphs(cuda_device):
    """A 2-replica in-process cluster on one card: the replicas share the
    params, each captures and replays its own decode graph, and the tokens
    equal independent engines' fed what each replica was routed. (The pod
    mesh names the card twice: the default mesh would spread the replicas
    over the cards a host has.)"""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.serving import Request, ServingCluster, ServingEngine

    cfg = get_config("llama3-8b").reduced()
    model, params = _graph_pair(cfg, cuda_device, torch.bfloat16)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
               for s in (5, 17, 33, 50, 9, 64)]
    kw = dict(max_batch=2, max_seq=128)
    cl = ServingCluster.build(model, params, n_replicas=2,
                              policy="round_robin", warmup=True,
                              device=cuda_device,
                              mesh=DeviceMesh([cuda_device] * 2, ("pod",)),
                              **kw)
    reqs = [Request(prompt_tokens=t.copy(), max_new_tokens=10)
            for t in prompts]
    for r in reqs:
        cl.submit(r)
    assert len(cl.run_until_drained(max_steps=100_000)) == len(reqs)
    pools = [rep.engine.pool for rep in cl.replicas]
    assert pools[0]._graph is not None and pools[1]._graph is not None
    assert pools[0]._graph is not pools[1]._graph
    for rep in cl.replicas:
        assert rep.engine.params is params
        assert rep.engine.pool.graph_replays == rep.engine.decode_steps > 0
    for k in range(2):
        mine = [t for i, t in enumerate(prompts) if i % 2 == k]
        eng = ServingEngine(model, params, device=cuda_device, **kw)
        solo = [Request(prompt_tokens=t.copy(), max_new_tokens=10)
                for t in mine]
        for r in solo:
            eng.submit(r)
        eng.run_until_drained()
        assert [r.generated for r in solo] == \
            [r.generated for i, r in enumerate(reqs) if i % 2 == k]


# --------------------------------------------------------------------------- #
# the MoE layer (grok-1-314b) and feature payloads (pixtral-12b) on the card
# --------------------------------------------------------------------------- #
def _moe_inputs(cfg, T, seed=0):
    """One MoE layer's weights (the model's init) and [T, d] rows skewed
    towards expert 0, so first choices overflow their capacity."""
    from repro_torch.models import moe
    from repro_torch.models.schema import init_params

    g = torch.Generator().manual_seed(seed)
    p = init_params(g, moe.moe_schema(cfg), torch.float32, "cpu")
    x = torch.randn((T, cfg.d_model), generator=g)
    r0 = p["router"][:, 0]
    x += 8.0 * r0 / r0.norm()
    return p, x


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 200, 1024])
def test_moe_layer_on_card_matches_cpu_fp32(cuda_device, T):
    """``moe_apply`` on the card against its CPU run in fp32 with tokens
    dropped: the same routing choices (flipped (token, slot) choices
    counted and required to be none), the same drops, outputs within
    1e-4 of the largest."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.schema import tree_map

    cfg = get_config("grok-1-314b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           n_experts=8))
    p, x = _moe_inputs(cfg, T)
    pg = tree_map(lambda t: t.to(cuda_device), p)
    out, aux = moe.moe_apply(p, cfg, x)
    gout, gaux = moe.moe_apply(pg, cfg, x.to(cuda_device))
    _, ids = moe.router_topk(x @ p["router"], 2)
    _, gids = moe.router_topk(x.to(cuda_device) @ pg["router"], 2)
    flips = int((gids.cpu() != ids).sum())
    assert flips == 0, f"{flips} flipped (token, slot) choices"
    C = moe.capacity(T, cfg.moe)
    keep = moe.dispatch_plan(ids, 8, C)[1]
    assert torch.equal(moe.dispatch_plan(gids, 8, C)[1].cpu(), keep)
    if T > 8:
        assert not bool(keep.all())
    scale = float(out.abs().max())
    torch.testing.assert_close(gout.cpu(), out, rtol=0, atol=1e-4 * scale)
    assert abs(float(gaux) - float(aux)) <= 1e-5


@pytest.mark.cuda
def test_router_ties_on_card_match_cpu(cuda_device):
    """Exact ties in bf16 router logits keep the lower expert first on the
    card as on the CPU (a stable sort, as ``jax.lax.top_k``)."""
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(5)
    logits = torch.randn((4096, 8), generator=g).to(torch.bfloat16)
    logits = (logits * 4).round() / 4  # coarse: many exact ties
    w, ids = moe.router_topk(logits, 2)
    gw, gids = moe.router_topk(logits.to(cuda_device), 2)
    assert torch.equal(gids.cpu(), ids)
    torch.testing.assert_close(gw.cpu(), w, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_graph_moe_step_equals_eager(cuda_device):
    """A reduced-width grok-1 pool (MoE in every layer, capacity from the
    pool's max_batch rows) captures into one graph: the replayed step
    equals the eager step bitwise over 20 replays, and the launch counts
    follow the path."""
    from repro_torch.configs import get_config

    cfg = get_config("grok-1-314b").reduced()
    model, params = _graph_pair(cfg, cuda_device, torch.bfloat16)
    rng = np.random.default_rng(4)
    waves = [[rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
              for s in (9, 40, 70)], [rng.integers(0, cfg.vocab_size, 33,
                                                   dtype=np.int32)]]
    ops.reset_launches()
    (eager, graph), toks = _lockstep(model, params, waves, 30, steps=21,
                                     max_batch=4, max_seq=256)
    assert toks[0] == toks[1]
    assert graph.pool.graph_replays >= 20
    L = cfg.n_layers
    steps = eager.decode_steps + graph.decode_steps
    calls = eager.counters()["prefill_calls"] * 2
    assert ops.LAUNCHES["flash_attention"] == L * calls
    assert ops.LAUNCHES["decode_attention"] == L * steps
    assert ops.LAUNCHES["rmsnorm"] == (2 * L + 1) * (calls + steps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("F,S", [(12, 6), (256, 17), (512, 99),
                                 (1024, 101)])
def test_flash_kernel_at_feature_prefill_lengths(cuda_device, dtype, F, S):
    """A feature request's exact prefill is one [1, F + S] row, F + S not a
    multiple of the 64-row tile, at pixtral-12b's heads (32 of 128, 8 KV
    heads)."""
    L = F + S
    q = _cuda_pair((1, L, 32, 128), dtype, cuda_device, 0)
    k = _cuda_pair((1, L, 8, 128), dtype, cuda_device, 1)
    v = _cuda_pair((1, L, 8, 128), dtype, cuda_device, 2)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES["flash_attention"] == 1 and L % 64
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)


@pytest.mark.cuda
def test_feature_engine_on_card_matches_cpu(cuda_device):
    """Reduced pixtral-12b on the card, feature and text requests mixed:
    the CPU engine's greedy tokens on the same weights (fp32), one exact
    prefill call a feature request, the launch counts of the path."""
    from repro_torch.configs import get_config
    from repro_torch.models import FRONTEND_DIM, Model
    from repro_torch.models.schema import tree_map
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("pixtral-12b").reduced()
    gpu = Model(cfg, dtype=torch.float32, device=cuda_device)
    params = gpu.init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    rng = np.random.default_rng(3)
    items = [(rng.integers(0, cfg.vocab_size, s, dtype=np.int32),
              rng.normal(size=(1, f, FRONTEND_DIM)).astype(np.float32)
              if f else None) for s, f in ((6, 40), (30, 0), (11, 77))]

    def serve(model, p, device):
        eng = ServingEngine(model, p, max_batch=4, max_seq=128,
                            device=device)
        reqs = [Request(prompt_tokens=t, features=f, max_new_tokens=6)
                for t, f in items]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.generated for r in reqs], eng

    ops.reset_launches()
    got, eng = serve(gpu, params, cuda_device)
    c = eng.counters()
    L = cfg.n_layers
    assert c["prefill_calls"] == 3
    assert c["prefill_padded_tokens"] == 6 + 11 + 4 * 32
    assert ops.LAUNCHES["flash_attention"] == L * c["prefill_calls"]
    assert ops.LAUNCHES["decode_attention"] == L * c["decode_steps"]
    assert ops.LAUNCHES["rmsnorm"] == (2 * L + 1) * (c["prefill_calls"]
                                                     + c["decode_steps"])
    want, _ = serve(cpu, params_cpu, "cpu")
    assert got == want


# --------------------------------------------------------------------------- #
# MLA (deepseek-v2): flash at (192, 128), the absorbed decode kernel, the
# latent pool's graph
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S", [77, 200])
def test_flash_mla_head_dims_match_plain(cuda_device, dtype, S):
    """MLA's prefill: q/k at 192 (nope + rope), v at 128, scale 1/sqrt(192),
    causal, S not a multiple of the 64-row tile, 16 heads (MHA)."""
    B, H = 2, 16
    q = _cuda_pair((B, S, H, 192), dtype, cuda_device, 0)
    k = _cuda_pair((B, S, H, 192), dtype, cuda_device, 1)
    v = _cuda_pair((B, S, H, 128), dtype, cuda_device, 2)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True, scale=192 ** -0.5)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert tuple(got.shape) == (B, S, H, 128)
    want = ref.flash_attention_ref(q, k, v, causal=True, scale=192 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)


def _mla_case(B, W, H, dtype, dev, seed):
    q_lat = _cuda_pair((B, 1, H, 512), dtype, dev, seed)
    q_rope = _cuda_pair((B, 1, H, 64), dtype, dev, seed + 1)
    ckv = _cuda_pair((B, W, 512), dtype, dev, seed + 2)
    krope = _cuda_pair((B, W, 64), dtype, dev, seed + 3)
    return q_lat, q_rope, ckv, krope


def _mla_lens(kind, W):
    if kind == "tiles":  # on and around the 64-row tile and, at 8 splits,
        # one tile a CTA (512) and one over (513)
        return [63, 64, 65, 127, 128, 129, 512, 513]
    return _decode_lens(kind, W)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("H", [16, 48, 64, 128])
@pytest.mark.parametrize("kind", ["edges", "one_long", "tiles"])
def test_mla_decode_kernel_ring_and_paged_match_plain(cuda_device, dtype, H,
                                                      kind):
    """The absorbed-MLA decode kernel, ring and paged (pages of 16 in a
    shuffled pool), with the launcher's split count and each forced count,
    against the plain versions; valid lengths 0 and 1, on and around the
    32-row (fp32) and 64-row (bf16) tiles and the splits' boundaries; H
    covering a partial 64-head block (16, 48). The paged output equals the
    ring output on the same rows at the same split count, bitwise."""
    from repro_torch.kernels import mla_decode_attention as _mla

    B, W, page = 8, 1024, 16
    q_lat, q_rope, ckv, krope = _mla_case(B, W, H, dtype, cuda_device, 3)
    lens = torch.tensor(_mla_lens(kind, W), dtype=torch.int32,
                        device=cuda_device)
    scale = 192 ** -0.5
    want = ref.mla_decode_attention_ref(q_lat, q_rope, ckv, krope, lens,
                                        scale=scale)
    n_pages = W // page
    perm = torch.randperm(B * n_pages, generator=torch.Generator(
        ).manual_seed(4)) + 1
    table = perm.reshape(B, n_pages).to(torch.int32).to(cuda_device)
    cb = torch.zeros((B * n_pages + 1, page, 512), dtype=ckv.dtype,
                     device=cuda_device)
    rb = torch.zeros((B * n_pages + 1, page, 64), dtype=ckv.dtype,
                     device=cuda_device)
    cb[table.reshape(-1).long()] = ckv.reshape(B * n_pages, page, 512)
    rb[table.reshape(-1).long()] = krope.reshape(B * n_pages, page, 64)
    ops.reset_launches()
    got = ops.mla_decode_attention(q_lat, q_rope, ckv, krope, lens,
                                   scale=scale)
    pgot = ops.paged_mla_decode_attention(q_lat, q_rope, cb, rb, table, lens,
                                          scale=scale)
    assert ops.LAUNCHES["mla_decode_attention"] == 1
    assert ops.LAUNCHES["paged_mla_decode_attention"] == 1
    pwant = ref.paged_mla_decode_attention_ref(q_lat, q_rope, cb, rb, table,
                                               lens, scale=scale)
    torch.testing.assert_close(pwant, want, atol=0, rtol=0)
    for out in (got, pgot):
        torch.testing.assert_close(out.float(), want.float(),
                                   atol=TOLS[dtype], rtol=1e-2)
        assert (out[lens == 0] == 0).all()
    for splits in (1, 2, 3, 8):
        ring = _mla.launch(q_lat, q_rope, ckv, krope, lens, scale=scale,
                           _splits=splits)
        paged = _mla.launch_paged(q_lat, q_rope, cb, rb, table, lens,
                                  scale=scale, _splits=splits)
        torch.testing.assert_close(ring.float(), want.float(),
                                   atol=TOLS[dtype], rtol=1e-2)
        assert torch.equal(ring, paged), splits
        assert (ring[lens == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 12, 64, 128])
def test_mla_decode_kernel_page_sizes(cuda_device, page):
    """The bf16 kernel over pools of other page sizes -- whole TMA boxes of
    a page (8), of 64 rows in a page (64, 128), and a page no box fits
    (12: cp.async) -- against the plain version and, bitwise, the ring."""
    from repro_torch.kernels import mla_decode_attention as _mla

    B, W, H = 4, 768, 64
    q_lat, q_rope, ckv, krope = _mla_case(B, W, H, "bf16", cuda_device, 7)
    lens = torch.tensor([0, 65, 500, W], dtype=torch.int32,
                        device=cuda_device)
    n_pages = W // page
    perm = torch.randperm(B * n_pages, generator=torch.Generator(
        ).manual_seed(8)) + 1
    table = perm.reshape(B, n_pages).to(torch.int32).to(cuda_device)
    cb = torch.zeros((B * n_pages + 1, page, 512), dtype=ckv.dtype,
                     device=cuda_device)
    rb = torch.zeros((B * n_pages + 1, page, 64), dtype=ckv.dtype,
                     device=cuda_device)
    cb[table.reshape(-1).long()] = ckv.reshape(B * n_pages, page, 512)
    rb[table.reshape(-1).long()] = krope.reshape(B * n_pages, page, 64)
    want = ref.mla_decode_attention_ref(q_lat, q_rope, ckv, krope, lens,
                                        scale=0.07)
    for splits in (1, 4):
        ring = _mla.launch(q_lat, q_rope, ckv, krope, lens, scale=0.07,
                           _splits=splits)
        paged = _mla.launch_paged(q_lat, q_rope, cb, rb, table, lens,
                                  scale=0.07, _splits=splits)
        torch.testing.assert_close(paged.float(), want.float(),
                                   atol=TOLS["bf16"], rtol=1e-2)
        assert torch.equal(ring, paged), splits


@pytest.mark.cuda
def test_mla_decode_kernel_strided_query(cuda_device):
    """bf16 queries read through (b, h) strides that are not 16-byte
    multiples (a narrow view of a wider tensor): the kernel's element-wise
    Q staging, against the plain version."""
    B, W, H = 4, 300, 48
    wide = _cuda_pair((B, 1, H, 512 + 64 + 3), "bf16", cuda_device, 11)
    q_lat, q_rope = wide[..., :512], wide[..., 515:]
    ckv = _cuda_pair((B, W, 512), "bf16", cuda_device, 12)
    krope = _cuda_pair((B, W, 64), "bf16", cuda_device, 13)
    lens = torch.tensor([0, 64, 190, 300], dtype=torch.int32,
                        device=cuda_device)
    got = ops.mla_decode_attention(q_lat, q_rope, ckv, krope, lens,
                                   scale=0.1)
    want = ref.mla_decode_attention_ref(q_lat, q_rope, ckv, krope, lens,
                                        scale=0.1)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOLS["bf16"], rtol=1e-2)


def _mla_card_cfg():
    """deepseek-v2 at its published MLA dims (latent 512, q rank 1536, nope
    128, rope 64, v 128) with 16 heads, d_model 256 and 2 layers (a dense
    FFN layer, then a reduced MoE one): the kernels' dims, a card test's
    size."""
    import dataclasses

    from repro_torch.configs import MLAConfig, get_config

    return dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                               n_heads=16, n_kv_heads=16, mla=MLAConfig())


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_graph_mla_step_equals_eager(cuda_device, paged):
    """The latent pool's replayed decode step (both leaves written in
    place, the MLA decode kernel or its paged twin captured) equals the
    eager step bitwise over 20 replays; launches follow the path."""
    cfg = _mla_card_cfg()
    model, params = _graph_pair(cfg, cuda_device, torch.bfloat16)
    rng = np.random.default_rng(6)
    waves = [[rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
              for s in (7, 40, 100)], [rng.integers(0, cfg.vocab_size, 60,
                                                    dtype=np.int32)]]
    ops.reset_launches()
    (eager, graph), toks = _lockstep(model, params, waves, 30, steps=21,
                                     max_batch=4, max_seq=256, paged=paged)
    assert toks[0] == toks[1]
    assert graph.pool.graph_replays >= 20
    L = cfg.n_layers
    steps = eager.decode_steps + graph.decode_steps
    calls = eager.counters()["prefill_calls"] * 2
    decode = "paged_mla_decode_attention" if paged else "mla_decode_attention"
    want = {k: 0 for k in ops.LAUNCHES}
    want.update({"rmsnorm": (4 * L + 1) * (calls + steps),
                 "flash_attention": L * calls, decode: L * steps})
    assert ops.LAUNCHES == want


# --------------------------------------------------------------------------- #
# backward kernels (training)
# --------------------------------------------------------------------------- #
# gradients, each held on its own (the rule of chip_smoke.py's phase 2):
# |kernel - plain| <= atol * (its largest |plain|) + rtol * |plain|
# elementwise, and |kernel - plain| <= ntol * |plain| in the 2-norm over the
# whole gradient (zeroed rows or dropped key tiles move it by 0.2-0.4,
# rounding by under 0.003); a gradient that is 0 in exact arithmetic (dq
# where every row sees one key) takes its case's largest entry and norm
# instead. fp32 (the CUDA-core body) differs by summation order only; bf16
# (the tensor-core body) also by rounding P and dS to bf16 as the A
# operands of its dV, dK and dQ products (fp32 sums) and by reading the
# bf16-rounded output O for D = rowsum(dO o O)
BWD_TOLS = {"fp32": (1e-5, 1e-4, 1e-5), "bf16": (1e-2, 1e-2, 1e-2)}


def _close_grads(got, want, dtypes, what, names):
    """Hold each gradient of one case against its plain version under
    BWD_TOLS (``dtypes``: each gradient's tolerance key)."""
    want = [w.float() for w in want]
    top = max(float(w.abs().max()) for w in want)
    top_norm = max(float(w.norm()) for w in want)
    for name, g, w, dtype in zip(names, got, want, dtypes):
        atol, rtol, ntol = BWD_TOLS[dtype]
        g = g.float()
        assert torch.isfinite(g).all(), (what, name)
        err = (g - w).abs()
        lim = atol * (float(w.abs().max()) or top) + rtol * w.abs()
        rel = float(err.norm()) / (float(w.norm()) or top_norm)
        assert (err <= lim).all(), (what, name, float(err.max()),
                                    float(w.abs().max()))
        assert rel <= ntol, (what, name, rel)


def _grad_run(q, k, v, do, **kw):
    """ops.flash_attention's gradients through its autograd Function."""
    qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = ops.flash_attention(*qkv, **kw)
    return o, torch.autograd.grad(o, qkv, do)


# (B, Sq, Skv, H, Hkv, hd, causal, window, sq_real, skv_real)
FLASH_BWD_CASES = [
    (2, 1, 1, 4, 4, 64, True, 0, None, None),
    (2, 63, 63, 8, 2, 128, True, 0, None, None),
    (1, 64, 64, 8, 1, 64, True, 0, None, None),
    (2, 65, 65, 4, 1, 128, True, 0, None, None),
    (1, 1000, 1000, 8, 1, 128, True, 256, None, None),
    (1, 1000, 1000, 4, 4, 64, True, 256, None, None),
    (1, 4096, 4096, 8, 1, 128, True, 0, None, None),
    (1, 1000, 1000, 4, 4, 64, False, 0, None, None),
    (2, 7, 300, 4, 1, 64, False, 0, None, None),
    (2, 300, 1000, 8, 2, 128, False, 0, None, None),
    (2, 200, 200, 4, 1, 64, True, 0, 150, 170),
    (2, 130, 100, 4, 2, 32, False, 0, 120, 90),
    # the tensor-core body's own edges: hd 32 (the 64-byte swizzle), the
    # training head layout at a ragged length, a window of one tile, and
    # pads that cut a q-tile and a key tile mid-tile under a causal mask
    (2, 129, 129, 4, 4, 32, True, 0, None, None),
    (1, 2049, 2049, 32, 8, 128, True, 0, None, None),
    (1, 640, 640, 8, 2, 128, True, 64, None, None),
    (2, 300, 300, 8, 2, 64, True, 0, 227, 165),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_matches_plain(cuda_device, dtype, case):
    B, Sq, Skv, H, Hkv, hd, causal, window, sq_real, skv_real = case
    q = _cuda_pair((B, Sq, H, hd), dtype, cuda_device, 0)
    k = _cuda_pair((B, Skv, Hkv, hd), dtype, cuda_device, 1)
    v = _cuda_pair((B, Skv, Hkv, hd), dtype, cuda_device, 2)
    do = _cuda_pair((B, Sq, H, hd), dtype, cuda_device, 3)
    kw = dict(causal=causal, window=window, sq_real=sq_real,
              skv_real=skv_real)
    ops.reset_launches()
    o, got = _grad_run(q, k, v, do, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.LAUNCHES["flash_attention_bwd"] == 1
    torch.testing.assert_close(o.float(), ref.flash_attention_ref(
        q, k, v, **kw).float(), atol=TOLS[dtype], rtol=1e-2)
    want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    _close_grads(got, want, [dtype] * 3, case, ("dq", "dk", "dv"))
    if sq_real is not None:  # rows past sq_real see no key
        assert (got[0][:, sq_real:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_backward_fully_masked_rows_give_zeros(cuda_device, dtype):
    """skv_real = 0: no row sees a key; the output and every gradient are
    zeros, not NaN (the forward's lse is +inf there)."""
    q = _cuda_pair((2, 70, 4, 64), dtype, cuda_device, 0)
    k = _cuda_pair((2, 90, 2, 64), dtype, cuda_device, 1)
    v = _cuda_pair((2, 90, 2, 64), dtype, cuda_device, 2)
    do = _cuda_pair((2, 70, 4, 64), dtype, cuda_device, 3)
    o, got = _grad_run(q, k, v, do, causal=False, skv_real=0)
    assert (o == 0).all()
    for g in got:
        assert (g == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_backward_is_deterministic(cuda_device, dtype):
    """No atomics: two calls give the same bits (GQA at G = 4, causal)."""
    q = _cuda_pair((2, 1000, 16, 128), dtype, cuda_device, 0)
    k = _cuda_pair((2, 1000, 4, 128), dtype, cuda_device, 1)
    v = _cuda_pair((2, 1000, 4, 128), dtype, cuda_device, 2)
    do = _cuda_pair((2, 1000, 16, 128), dtype, cuda_device, 3)
    _, a = _grad_run(q, k, v, do, causal=True)
    _, b = _grad_run(q, k, v, do, causal=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("bf16", "bf16"), ("fp32", "fp32"), ("bf16", "fp32"), ("fp32", "bf16")])
# 512 and 1536: deepseek-v2's latent norms (kv, q); 768 and 1536: mamba2's
# d_model and d_inner (the narrow kernel's whole-warp rows, 96 and 192
# vectors); 3072: starcoder2-3b; 8192: jamba's gate norm; 100: an odd row
# in bf16 (one element an access); 128: qwen3's qk-norm (four rows a warp)
@pytest.mark.parametrize("D", [100, 128, 512, 768, 1024, 1536, 3072, 4096,
                               8192])
# 8191: the last warp's groups a partial set of rows
@pytest.mark.parametrize("N", [1, 257, 8191, 8192])
def test_rmsnorm_backward_matches_plain(cuda_device, N, D, x_dtype, w_dtype):
    x = _cuda_pair((N, D), x_dtype, cuda_device, 0)
    w = _cuda_pair((D,), w_dtype, cuda_device, 1)
    dy = _cuda_pair((N, D), x_dtype, cuda_device, 2)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ops.reset_launches()
    got = torch.autograd.grad(ops.rmsnorm(xg, wg), (xg, wg), dy)
    assert ops.LAUNCHES["rmsnorm"] == 1 and ops.LAUNCHES["rmsnorm_bwd"] == 1
    want = ref.rmsnorm_bwd_ref(x, w, dy)
    _close_grads(got, want, [x_dtype, "bf16" if "bf16" in (x_dtype, w_dtype)
                             else "fp32"], (N, D), ("dx", "dw"))
    again = torch.autograd.grad(ops.rmsnorm(xg, wg), (xg, wg), dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("D", [128, 768, 1536])
def test_rmsnorm_backward_warps(cuda_device, D, dtype):
    """The kernel at the geometries the plan picks for 1 to 5000 rows (a
    narrow CTA's warps cut to few rows, the grid grown with them): a row's
    dx does not depend on the warps and CTAs around it (its sums stay
    within its group or CTA), and dw holds to the plain version at each."""
    from repro_torch.kernels import rmsnorm as rn

    N = 5000
    x = _cuda_pair((N, D), dtype, cuda_device, 0)
    w = _cuda_pair((D,), dtype, cuda_device, 1)
    dy = _cuda_pair((N, D), dtype, cuda_device, 2)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    isz = x.element_size()
    first, geometries = None, set()
    for n in (1, 2, 8, 40, N):
        plan = rn.bwd_plan(n, D, isz, n_sm, 2)
        geometries.add((plan.threads, plan.grid))
        got = rn.launch_bwd(x[:n], w, dy[:n], 1e-5)
        want = ref.rmsnorm_bwd_ref(x[:n], w, dy[:n])
        _close_grads(got, want, [dtype, dtype], (n, D), ("dx", "dw"))
        first = first if first is not None else got[0]
        assert torch.equal(got[0][:1], first), n
    assert len(geometries) >= 4, geometries


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 4096])
def test_rmsnorm_backward_rejects_grid_past_rows(cuda_device, D):
    """The C entry refuses more CTAs than rows (a wide CTA loads its first
    row before it tests it) and launches nothing."""
    from repro_torch.kernels import rmsnorm as rn

    N = 3
    x, dy = (_cuda_pair((N, D), "bf16", cuda_device, s) for s in (0, 2))
    w = _cuda_pair((D,), "bf16", cuda_device, 1)
    p = rn.bwd_plan(N, D, 2, 132, 2)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    partial = torch.empty((N + 1, D), dtype=torch.float32, device=x.device)
    dev = x.get_device()
    with pytest.raises(RuntimeError, match="rmsnorm_bwd"):
        rn._BWD(dev, x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                dw.data_ptr(), partial.data_ptr(), N, D, 1, int(p.wide),
                p.vecs, p.lanes, p.threads, N + 1, 1, 1e-5, 3)


# (b, S, decay): below one chunk, the chunk's edges, a ragged tail over
# several chunks, two batch rows; strong decay (dt about 0.9, A about -1.8)
SSD_BWD_CASES = [(1, 1, "normal"), (1, 40, "normal"), (2, 63, "normal"),
                 (1, 64, "normal"), (2, 65, "normal"), (1, 1000, "normal"),
                 (2, 200, "strong"), (1, 1024, "strong")]


def _ssd_bwd_inputs(b, S, dtype, dev, seed, nh, hd, ds, decay):
    x, dt, A, B, C = _ssd_case(S, dtype, dev, seed, nh=nh, hd=hd, ds=ds, b=b)
    if decay == "strong":
        g = torch.Generator().manual_seed(seed + 1)
        dt = (torch.randn((b, S, nh), generator=g).abs() * 0.5 + 0.5).to(dev)
        A = (-torch.randn((nh,), generator=g).abs() - 1.0).to(dev)
    dy = _cuda_pair((b, S, nh, hd), dtype, dev, seed + 2)
    return x, dt, A, B, C, dy


def _ssd_bwd_want(x, dt, A, B, C, dy, dtype):
    """The plain version in fp32 on bf16 inputs (the kernel rounds nothing
    but its outputs), in float64 on fp32 inputs (the fp32 plain version
    sums dt A in fp32, the kernel in fp64: under strong decay its own dA
    comes within reach of the fp32 rule; chip_smoke.py phase 2 reports
    that gap)."""
    from repro_torch.kernels import ssd_scan as _ssd

    compute = torch.float64 if dtype == "fp32" else torch.float32
    return ref.ssd_scan_bwd_ref(x, dt, A, B, C, dy, _ssd.BWD_CHUNK,
                                compute=compute)


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(SSD_WIDTHS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", SSD_BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_backward_matches_plain(cuda_device, case, dtype, width):
    """The SSD-scan backward kernel through ops.ssd_scan's autograd
    Function, x, B and C the model's strided views: every gradient under
    BWD_TOLS, one launch of each kernel, two calls bitwise equal."""
    b, S, decay = case
    w = {"nh": 24, "hd": 64, "ds": 128, **SSD_WIDTHS[width]}
    x, dt, A, B, C, dy = _ssd_bwd_inputs(b, S, dtype, cuda_device, 7 * S + b,
                                         decay=decay, **w)
    ins = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
    ops.reset_launches()
    y, _ = ops.ssd_scan(*ins, chunk=256)
    got = torch.autograd.grad(y, ins, dy, retain_graph=True)
    assert ops.LAUNCHES["ssd_scan"] == 1 and ops.LAUNCHES["ssd_scan_bwd"] == 1
    want = _ssd_bwd_want(x, dt, A, B, C, dy, dtype)
    for g, t in zip(got, want):
        assert g.dtype == t.dtype and g.shape == t.shape
    _close_grads(got, want, [dtype] * 5, (case, width),
                 ("dx", "ddt", "dA", "dB", "dC"))
    again = torch.autograd.grad(y, ins, dy)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 48])
@pytest.mark.parametrize("ds", [16, 128])
def test_ssd_backward_fp32_head_dims(cuda_device, hd, ds):
    """The fp32 kernel's other head dims (the forward's multiples of 16)."""
    x, dt, A, B, C, dy = _ssd_bwd_inputs(2, 300, "fp32", cuda_device, hd + ds,
                                         nh=3, hd=hd, ds=ds, decay="normal")
    ins = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
    y, _ = ops.ssd_scan(*ins, chunk=64)
    got = torch.autograd.grad(y, ins, dy)
    _close_grads(got, _ssd_bwd_want(x, dt, A, B, C, dy, "fp32"), ["fp32"] * 5,
                 (hd, ds), ("dx", "ddt", "dA", "dB", "dC"))


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(SSD_WIDTHS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ssd_backward_heads_per_cta(cuda_device, dtype, width):
    """Launch 3 at every head group that divides the heads: each within
    BWD_TOLS (dB and dC sum the groups' partials in group order, so the
    grouping moves their last bits), and the launcher's own pick."""
    from repro_torch.kernels import ssd_scan as _ssd

    w = {"nh": 24, "hd": 64, "ds": 128, **SSD_WIDTHS[width]}
    x, dt, A, B, C, dy = _ssd_bwd_inputs(2, 333, dtype, cuda_device, 5,
                                         decay="normal", **w)
    want = _ssd_bwd_want(x, dt, A, B, C, dy, dtype)
    for g in [d for d in range(1, w["nh"] + 1) if w["nh"] % d == 0]:
        got = _ssd.launch_bwd(x, dt, A, B, C, dy.contiguous(), _heads=g)
        _close_grads(got, want, [dtype] * 5, (width, g),
                     ("dx", "ddt", "dA", "dB", "dC"))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [4095, 4096, 4097])
def test_ssd_backward_bf16_body_at_the_training_length(cuda_device, S):
    """The bf16 tensor-core body at mamba2-130m's widths and its training
    length, one position short and one past it (a one-position chunk), with
    the output launch's head group forced to 1, 2, 3 and 24 and the
    launcher's pick: every gradient under BWD_TOLS, two calls bitwise equal
    at each group."""
    from repro_torch.kernels import ssd_scan as _ssd

    x, dt, A, B, C, dy = _ssd_bwd_inputs(1, S, "bf16", cuda_device, S, nh=24,
                                         hd=64, ds=128, decay="normal")
    want = _ssd_bwd_want(x, dt, A, B, C, dy, "bf16")
    for g in (1, 2, 3, 24, None):
        got = _ssd.launch_bwd(x, dt, A, B, C, dy.contiguous(), _heads=g)
        _close_grads(got, want, ["bf16"] * 5, (S, g),
                     ("dx", "ddt", "dA", "dB", "dC"))
        again = _ssd.launch_bwd(x, dt, A, B, C, dy.contiguous(), _heads=g)
        assert all(torch.equal(a, c) for a, c in zip(got, again)), (S, g)


@pytest.mark.cuda
@pytest.mark.parametrize("b,S", [(1, 1000), (2, 129)])
def test_ssd_backward_bf16_ragged_chunk_under_strong_decay_ds16(cuda_device,
                                                                 b, S):
    """jamba-v0.1-52b's d_state 16 (H and G' transposed in the scratch, the
    m64n16 products) with a ragged last chunk under strong decay (dt about
    0.9, A about -1.8), the head group forced to 1, 2 and 128 and the
    launcher's pick: every gradient under BWD_TOLS, two calls bitwise
    equal at each group."""
    from repro_torch.kernels import ssd_scan as _ssd

    x, dt, A, B, C, dy = _ssd_bwd_inputs(b, S, "bf16", cuda_device, S + b,
                                         decay="strong",
                                         **{"nh": 24, "hd": 64, "ds": 128,
                                            **SSD_WIDTHS["jamba"]})
    want = _ssd_bwd_want(x, dt, A, B, C, dy, "bf16")
    for g in (1, 2, 128, None):
        got = _ssd.launch_bwd(x, dt, A, B, C, dy.contiguous(), _heads=g)
        _close_grads(got, want, ["bf16"] * 5, (b, S, g),
                     ("dx", "ddt", "dA", "dB", "dC"))
        again = _ssd.launch_bwd(x, dt, A, B, C, dy.contiguous(), _heads=g)
        assert all(torch.equal(a, c) for a, c in zip(got, again)), (b, S, g)


# (B, S, H, causal, real): MLA's head dims (q/k 192, v 128) at ragged
# lengths, a pad cutting a tile, cross-tile causal and not
FLASH_MLA_BWD_CASES = [(2, 77, 16, True, None), (1, 200, 16, True, 150),
                       (1, 1000, 8, True, None), (2, 130, 4, False, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_MLA_BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_at_mla_head_dims(cuda_device, dtype, case):
    """The flash backward at (192, 128) through the autograd Function: the
    bf16 body's dK in two passes, its dQ over key halves; the fp32 body's
    own tiles. Every gradient under BWD_TOLS, two calls bitwise equal."""
    B, S, H, causal, real = case
    q = _cuda_pair((B, S, H, 192), dtype, cuda_device, 0)
    k = _cuda_pair((B, S, H, 192), dtype, cuda_device, 1)
    v = _cuda_pair((B, S, H, 128), dtype, cuda_device, 2)
    do = _cuda_pair((B, S, H, 128), dtype, cuda_device, 3)
    kw = dict(causal=causal, scale=192 ** -0.5, sq_real=real, skv_real=real)
    ops.reset_launches()
    _, got = _grad_run(q, k, v, do, **kw)
    assert ops.LAUNCHES["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    _close_grads(got, want, [dtype] * 3, case, ("dq", "dk", "dv"))
    _, again = _grad_run(q, k, v, do, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
def test_backward_refusals(cuda_device):
    """On CUDA tensors that require grad, every kernel op without a
    backward raises NotImplementedError; under no_grad it runs. The SSD
    scan and flash at MLA's head dims (192, 128) have theirs: their
    gradients arrive through the backward kernels."""
    dev = cuda_device
    bf = torch.bfloat16
    q = torch.randn(2, 1, 8, 64, device=dev, dtype=bf, requires_grad=True)
    kc = torch.randn(2, 32, 2, 64, device=dev, dtype=bf)
    lens = torch.tensor([5, 32], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        ops.decode_attention(q, kc, kc, lens)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    blocks = torch.randn(5, 16, 2, 64, device=dev, dtype=bf)
    with pytest.raises(NotImplementedError, match="paged_decode"):
        ops.paged_decode_attention(q, blocks, blocks, pt, lens)
    with torch.no_grad():
        ops.decode_attention(q, kc, kc, lens)
    x = torch.randn(1, 64, 2, 64, device=dev, dtype=bf, requires_grad=True)
    dt = torch.rand(1, 64, 2, device=dev)
    A = -torch.rand(2, device=dev)
    Bm = torch.randn(1, 64, 1, 16, device=dev, dtype=bf)
    ops.reset_launches()
    y, _ = ops.ssd_scan(x, dt, A, Bm, Bm, chunk=64)
    (gx,) = torch.autograd.grad(y.float().sum(), x)
    assert ops.LAUNCHES["ssd_scan_bwd"] == 1 and gx.shape == x.shape
    ql = torch.randn(1, 1, 16, 512, device=dev, dtype=bf, requires_grad=True)
    qr = torch.randn(1, 1, 16, 64, device=dev, dtype=bf)
    ckv = torch.randn(1, 64, 512, device=dev, dtype=bf)
    kr = torch.randn(1, 64, 64, device=dev, dtype=bf)
    vl = torch.tensor([10], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="mla_decode"):
        ops.mla_decode_attention(ql, qr, ckv, kr, vl, scale=0.1)
    frames = torch.zeros(2, 4, 3, dtype=torch.uint8, device=dev)
    mean = torch.zeros(3, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="preprocess"):
        ops.preprocess(frames, mean, torch.ones(3, device=dev))
    qf = torch.randn(1, 64, 4, 192, device=dev, dtype=bf, requires_grad=True)
    kf = torch.randn(1, 64, 4, 192, device=dev, dtype=bf)
    vf = torch.randn(1, 64, 4, 128, device=dev, dtype=bf)
    ops.reset_launches()
    (gq,) = torch.autograd.grad(ops.flash_attention(qf, kf, vf).float().sum(),
                                qf)
    assert ops.LAUNCHES["flash_attention_bwd"] == 1 and gq.shape == qf.shape
    qs = torch.randn(1, 64, 4, 64, device=dev, dtype=bf, requires_grad=True)
    seg = torch.zeros(1, 64, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="segment ids"):
        ops.flash_attention(qs, qs.detach(), qs.detach(), segment_ids=seg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_backward_functions_under_checkpoint(cuda_device, dtype):
    """A norm + attention block under non-reentrant torch.utils.checkpoint:
    the recompute runs each forward kernel a second time and the gradients
    equal the unchecked run's bit for bit."""
    import torch.utils.checkpoint as ckpt

    B, S, H, hd = 2, 300, 4, 64
    x = _cuda_pair((B, S, H * hd), dtype, cuda_device, 0)
    w = _cuda_pair((H * hd,), dtype, cuda_device, 1)
    g = _cuda_pair((B, S, H * hd), dtype, cuda_device, 2)

    def block(x, w):
        h = ops.rmsnorm(x, w).reshape(B, S, H, hd)
        o = ops.flash_attention(h, h, h, causal=True)
        return x + o.reshape(B, S, -1)

    def grads(remat):
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        ops.reset_launches()
        out = (ckpt.checkpoint(block, xg, wg, use_reentrant=False) if remat
               else block(xg, wg))
        res = torch.autograd.grad(out, (xg, wg), g)
        return res, dict(ops.LAUNCHES)

    plain, n_plain = grads(False)
    remat, n_remat = grads(True)
    for name in ("rmsnorm", "flash_attention"):
        assert n_plain[name] == 1 and n_remat[name] == 2
    for name in ("rmsnorm_bwd", "flash_attention_bwd"):
        assert n_plain[name] == 1 and n_remat[name] == 1
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))


# --------------------------------------------------------------------------- #
# the decode kernels' lse output and the sequence-sharded decode
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_kernel_lse_matches_plain(cuda_device, dtype):
    """The ring kernel's lse (fp32 [B, H]) against the plain version's at a
    shard's shape -- 512 slots, rows of 0 (no valid slot: lse -inf, out 0),
    1, a short row and a full one -- at the launcher's split count and
    each forced count; ``out`` bitwise the same with lse on and off."""
    B, W, H, Hkv, hd = 6, 512, 32, 8, 128
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(s, generator=g).to(cuda_device, TDT[dtype])
               for s in ((B, 1, H, hd), (B, W, Hkv, hd), (B, W, Hkv, hd)))
    lens = torch.tensor([0, 1, 33, 200, 511, 512], dtype=torch.int32,
                        device=cuda_device)
    want, want_lse = ref.decode_attention_ref(q, k, v, lens, return_lse=True)
    ops.reset_launches()
    plain = ops.decode_attention(q, k, v, lens)
    out, lse = ops.decode_attention(q, k, v, lens, return_lse=True)
    assert ops.LAUNCHES["decode_attention"] == 2
    assert torch.equal(out, plain)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.isneginf(lse[0]).all() and not out[0].any()
    torch.testing.assert_close(lse[1:], want_lse[1:], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(out.float(), want.float(), atol=TOLS[dtype],
                               rtol=1e-2)
    for splits in (1, 2, 8):
        buf = torch.empty((B, H), dtype=torch.float32, device=cuda_device)
        o = _dec.launch(q, k, v, lens, scale=hd ** -0.5, w_real=W, lse=buf,
                        _splits=splits)
        assert torch.equal(o, _dec.launch(q, k, v, lens, scale=hd ** -0.5,
                                          w_real=W, _splits=splits))
        assert torch.isneginf(buf[0]).all()
        torch.testing.assert_close(buf[1:], want_lse[1:], atol=1e-4,
                                   rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("H", [16, 128])
def test_mla_decode_kernel_lse_matches_plain(cuda_device, dtype, H):
    """The MLA kernel's lse, from both bodies (bf16 on wgmma, fp32 on the
    CUDA cores), at one CTA a row and at several, against the plain
    version's; an empty row gives -inf and zeros; ``out`` bitwise the same
    with lse on and off."""
    from repro_torch.kernels import mla_decode_attention as _mla

    B, W = 5, 512
    q_lat, q_rope, ckv, krope = _mla_case(B, W, H, dtype, cuda_device, 21)
    lens = torch.tensor([0, 1, 64, 300, 512], dtype=torch.int32,
                        device=cuda_device)
    scale = 192 ** -0.5
    want, want_lse = ref.mla_decode_attention_ref(
        q_lat, q_rope, ckv, krope, lens, scale=scale, return_lse=True)
    plain = ops.mla_decode_attention(q_lat, q_rope, ckv, krope, lens,
                                     scale=scale)
    out, lse = ops.mla_decode_attention(q_lat, q_rope, ckv, krope, lens,
                                        scale=scale, return_lse=True)
    assert torch.equal(out, plain)
    assert torch.isneginf(lse[0]).all() and not out[0].any()
    torch.testing.assert_close(lse[1:], want_lse[1:], atol=1e-4, rtol=1e-5)
    for splits in (1, 3, 8):
        buf = torch.empty((B, H), dtype=torch.float32, device=cuda_device)
        o = _mla.launch(q_lat, q_rope, ckv, krope, lens, scale=scale,
                        lse=buf, _splits=splits)
        assert torch.equal(o, _mla.launch(q_lat, q_rope, ckv, krope, lens,
                                          scale=scale, _splits=splits))
        torch.testing.assert_close(o.float(), want.float(),
                                   atol=TOLS[dtype], rtol=1e-2)
        assert torch.isneginf(buf[0]).all()
        torch.testing.assert_close(buf[1:], want_lse[1:], atol=1e-4,
                                   rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b"])
def test_sharded_decode_step_on_a_1x4_mesh_of_the_card(cuda_device, arch):
    """decode_step under DECODE_32K's rules on a 1 x 4 mesh that names the
    card four times (the caches split 4 ways by sequence, the table 4 ways
    by vocab) against the unsharded step on the same weights and caches,
    fp32: logits within 1e-4 of the largest; the decode kernel launched
    once a shard and layer."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import DECODE_32K
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models import Model
    from repro_torch.sharding.partition import make_ctx, place_for_ctx

    cfg = _mla_card_cfg() if arch != "llama3-8b" else \
        get_config(arch).reduced()
    model = Model(cfg, dtype=torch.float32, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    B, W = 4, 256
    caches = model.init_cache(B, W)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for grp in caches.values():
        for blk in grp:
            for leaves in blk.values():
                for t in leaves.values():
                    t.normal_(0.0, 0.5, generator=g)
    plain = {gn: [{ln: {k: t.clone() for k, t in lv.items()}
                   for ln, lv in blk.items()} for blk in grp]
             for gn, grp in caches.items()}
    mesh = DeviceMesh([[cuda_device] * 4], ("data", "model"))
    ctx = make_ctx(cfg, mesh, DECODE_32K)
    pp, cc = place_for_ctx(model, ctx, params, caches)
    lens = torch.tensor([3, 70, 130, 300], dtype=torch.int32,
                        device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (B, 2), device=cuda_device,
                         dtype=torch.int32)
    kernel = "mla_decode_attention" if cfg.mla else "decode_attention"
    lens_p = lens.clone()
    for t in range(2):
        ops.reset_launches()
        got, cc, lens = model.decode_step(pp, cc, toks[:, t:t + 1], lens,
                                          shard_ctx=ctx)
        assert ops.LAUNCHES[kernel] == 4 * cfg.n_layers
        want, plain, lens_p = model.decode_step(params, plain,
                                                toks[:, t:t + 1], lens_p)
        top = float(want.abs().max())
        torch.testing.assert_close(got, want, atol=1e-4 * top, rtol=0)


@pytest.mark.cuda
def test_kernels_launch_on_a_second_card_while_the_first_is_current(
        cuda_device):
    """A kernel call for cuda:1 issued with cuda:0 current runs on cuda:1
    (``build.CFunction`` switches the current device for the call), and
    the current device is left as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a launch for the second card while "
                    "the first is current cannot be shown on one")
    dev1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, 4096, generator=g).to(dev1, torch.bfloat16)
    w = torch.randn(4096, generator=g).to(dev1, torch.bfloat16)
    q = torch.randn(4, 1, 32, 128, generator=g).to(dev1, torch.bfloat16)
    k = torch.randn(4, 512, 8, 128, generator=g).to(dev1, torch.bfloat16)
    lens = torch.tensor([0, 5, 300, 512], dtype=torch.int32, device=dev1)
    got = ops.rmsnorm(x, w)
    out, lse = ops.decode_attention(q, k, k, lens, return_lse=True)
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev1)
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(),
                               atol=TOLS["bf16"], rtol=1e-2)
    want, want_lse = ref.decode_attention_ref(q, k, k, lens, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), atol=TOLS["bf16"],
                               rtol=1e-2)
    torch.testing.assert_close(lse[1:], want_lse[1:], atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_sharded_decode_step_across_cards(cuda_device):
    """The sequence- and vocab-sharded decode with each shard on its own
    card (a 1 x 2 or 1 x 4 mesh of distinct cards: the blocks copied to
    their cards, each shard's kernel launched there, the partials summed
    on the first card) against the unsharded step on the first, fp32."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import DECODE_32K
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models import Model
    from repro_torch.sharding.partition import make_ctx, place_for_ctx

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards: shards on distinct cards cannot be "
                    "shown on one")
    n = 4 if n >= 4 else 2
    dev0 = torch.device("cuda", 0)
    cfg = get_config("llama3-8b").reduced()
    model = Model(cfg, dtype=torch.float32, device=dev0)
    params = model.init(torch.Generator(device=dev0).manual_seed(0))
    caches = model.init_cache(4, 256)
    g = torch.Generator(device=dev0).manual_seed(1)
    for grp in caches.values():
        for blk in grp:
            for leaves in blk.values():
                for t in leaves.values():
                    t.normal_(0.0, 0.5, generator=g)
    plain = {gn: [{ln: {k: t.clone() for k, t in lv.items()}
                   for ln, lv in blk.items()} for blk in grp]
             for gn, grp in caches.items()}
    mesh = DeviceMesh([[torch.device("cuda", i) for i in range(n)]],
                      ("data", "model"))
    ctx = make_ctx(cfg, mesh, DECODE_32K)
    pp, cc = place_for_ctx(model, ctx, params, caches)
    leaf = cc["g0"][0]["l0"]["k"]
    assert {t.device for t in leaf.locals.values()} == set(mesh.device_list)
    lens = torch.tensor([3, 70, 130, 255], dtype=torch.int32, device=dev0)
    lens_p = lens.clone()
    toks = torch.randint(0, cfg.vocab_size, (4, 2), device=dev0,
                         dtype=torch.int32)
    for t in range(2):
        got, cc, lens = model.decode_step(pp, cc, toks[:, t:t + 1], lens,
                                          shard_ctx=ctx)
        want, plain, lens_p = model.decode_step(params, plain,
                                                toks[:, t:t + 1], lens_p)
        assert got.device == dev0
        top = float(want.abs().max())
        torch.testing.assert_close(got, want, atol=1e-4 * top, rtol=0)
    whole = leaf.gather()
    torch.testing.assert_close(whole, plain["g0"][0]["l0"]["k"], atol=1e-4,
                               rtol=0)


def _sharded_grads(model, ctx, params, batch):
    """Loss and each gradient leaf (gathered on the host) of one sharded
    pass over ``params`` placed for ``ctx``."""
    from repro_torch.models.schema import tree_leaves
    from repro_torch.sharding.partition import (
        place_for_train,
        tree_parts,
        tree_with_parts,
    )

    placed = place_for_train(model, ctx, params)
    parts = tree_parts(placed)
    for p in parts:
        p.requires_grad_(True)
    loss = model.loss(placed, batch, shard_ctx=ctx)
    grads = torch.autograd.grad(loss, parts, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, parts)]
    return float(loss.detach()), [
        g.sum_copies().gather("cpu")
        for g in tree_leaves(tree_with_parts(placed, grads))]


def _train_mesh(dev, shape):
    from repro_torch.launch.mesh import DeviceMesh

    devs = np.empty(shape, dtype=object)
    devs.flat[:] = [dev] * int(np.prod(shape))
    return DeviceMesh(devs, ("data", "model"))


def _train_ctx(cfg, mesh, B, S):
    from repro_torch.configs.shapes import InputShape
    from repro_torch.sharding.partition import make_ctx

    return make_ctx(cfg, mesh, InputShape("train_4k", seq_len=S,
                                          global_batch=B, kind="train"))


@pytest.mark.cuda
def test_sharded_train_step_on_a_2x2_mesh_of_the_card(cuda_device):
    """Reduced llama3-8b's sharded fp32 loss and gradients on a 2 x 2
    (data, model) mesh naming the card four times, against the CPU's
    sharded pass on the same weights and batch: the loss within 1e-5
    relative, each gradient leaf within 5e-4 of its largest entry (embed
    5e-3); flash and rmsnorm launched once a slot as the unsharded step
    launches them once."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_leaves, tree_map

    cfg = get_config("llama3-8b").reduced()
    B, S = 4, 128
    gpu = Model(cfg, dtype=torch.float32, device=cuda_device, remat=True)
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params = gpu.init(torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    ops.reset_launches()
    lg, gg = _sharded_grads(gpu, _train_ctx(cfg, _train_mesh(
        gpu.device, (2, 2)), B, S), params,
        {k: v.to(gpu.device) for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    L = cfg.n_layers
    assert launches["flash_attention"] == 4 * 2 * L  # forward + recompute
    assert launches["flash_attention_bwd"] == 4 * L
    assert launches["rmsnorm"] == 4 * (2 * 2 * L + 1)
    assert launches["rmsnorm_bwd"] == 4 * (2 * L + 1)
    lc, gc_ = _sharded_grads(cpu, _train_ctx(cfg, _train_mesh(
        "cpu", (2, 2)), B, S), tree_map(lambda t: t.cpu(), params), batch)
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    leaves = tree_leaves(gpu.schema())
    for spec, a, b in zip(leaves, gg, gc_):
        tol = 5e-3 if spec.axes == ("vocab", "embed") else 5e-4
        top = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * max(top, 1e-30), spec


@pytest.mark.cuda
def test_train_blocks_sit_on_their_slots_devices(cuda_device):
    """place_for_train on a 2 x 1 mesh that names the card twice: every
    leaf's two embed blocks (FSDP) on the card, half the embed dim each,
    each a fresh tensor (none aliases the whole weight); the moments of
    ``adamw_init`` split the same way, fp32; one sharded step keeps the
    layout."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_leaves
    from repro_torch.sharding.partition import place_for_train
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step

    cfg = get_config("llama3-8b").reduced()
    model = Model(cfg, dtype=torch.bfloat16, device=cuda_device, remat=True)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    mesh = _train_mesh(model.device, (2, 1))
    ctx = _train_ctx(cfg, mesh, 2, 64)
    placed = place_for_train(model, ctx, params)
    state = adamw_init(placed)
    g = torch.Generator().manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=g).to(
        model.device) for k in ("tokens", "labels")}
    placed, state, met = make_train_step(model, AdamWConfig(), ctx)(
        placed, state, batch)
    assert np.isfinite(float(met["loss"]))
    whole = {t.data_ptr() for t in tree_leaves(params)}
    for spec, p, m in zip(tree_leaves(model.schema()), tree_leaves(placed),
                          tree_leaves(state.m)):
        for leaf, dtype in ((p, torch.bfloat16), (m, torch.float32)):
            parts = leaf.parts()
            assert len(parts) == (2 if "embed" in spec.axes else 1), spec
            for coord in mesh.coords():
                t = leaf.locals[coord]
                assert t.device == model.device and t.dtype == dtype
                assert t.data_ptr() not in whole
                dim = spec.axes.index("embed")
                assert t.shape[dim] == leaf.shape[dim] // len(parts)


@pytest.mark.cuda
def test_sharded_train_step_across_two_cards(cuda_device):
    """Where the host has two cards: reduced llama3-8b's sharded fp32 loss
    and gradients on a 2 x 1 (data, model) mesh over cuda:0 and cuda:1
    (FSDP across the cards: each embed block on its own card, the gathers
    peer copies) against the CPU's pass on the same mesh shape: the loss
    within 1e-5 relative, each gradient leaf within 5e-4 of its largest
    (embed 5e-3); each part on its slot's card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: FSDP across cards cannot be shown on "
                    "one")
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import DeviceMesh, make_train_mesh
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_leaves, tree_map
    from repro_torch.sharding.partition import place_for_train

    cfg = get_config("llama3-8b").reduced()
    B, S = 4, 128
    mesh = make_train_mesh(2)
    gpu = Model(cfg, dtype=torch.float32, device=mesh.first_device,
                remat=True)
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params = gpu.init(torch.Generator(device=gpu.device).manual_seed(0))
    ctx = _train_ctx(cfg, mesh, B, S)
    placed = place_for_train(gpu, ctx, params)
    for leaf in tree_leaves(placed):
        for coord in mesh.coords():
            assert leaf.locals[coord].device == mesh.device_at(coord)
    assert {str(d) for d in mesh.device_list} == {"cuda:0", "cuda:1"}
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    lg, gg = _sharded_grads(gpu, ctx, params,
                            {k: v.to(gpu.device) for k, v in batch.items()})
    lc, gc_ = _sharded_grads(cpu, _train_ctx(cfg, DeviceMesh(
        [["cpu"], ["cpu"]], ("data", "model")), B, S),
        tree_map(lambda t: t.cpu(), params), batch)
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    for spec, a, b in zip(tree_leaves(gpu.schema()), gg, gc_):
        tol = 5e-3 if spec.axes == ("vocab", "embed") else 5e-4
        top = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * max(top, 1e-30), spec


# a model shard's SSD heads: mamba2-130m's 24 over model 4 and 2 (d_state
# 128), jamba-v0.1-52b's 128 over 4 and 2 (d_state 16)
SHARD_HEADS = {6: 128, 12: 128, 32: 16, 64: 16}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("nh", list(SHARD_HEADS))
def test_ssd_kernels_at_shard_heads(cuda_device, nh, dtype):
    """The SSD scan forward and backward kernels at the head counts the
    sharded training pass gives them (x, B and C strided views of one
    conv-output row, as a slot's are): y and the final state against the
    plain version, every gradient under BWD_TOLS, one launch each."""
    ds = SHARD_HEADS[nh]
    x, dt, A, B, C = _ssd_case(1000, dtype, cuda_device, nh, nh=nh, ds=ds,
                               b=2)
    _ssd_hold(x, dt, A, B, C, dtype)
    x, dt, A, B, C, dy = _ssd_bwd_inputs(2, 1000, dtype, cuda_device, nh + 1,
                                         nh=nh, hd=64, ds=ds, decay="normal")
    ins = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
    ops.reset_launches()
    y, _ = ops.ssd_scan(*ins, chunk=256)
    got = torch.autograd.grad(y, ins, dy)
    assert ops.LAUNCHES["ssd_scan"] == 1 and ops.LAUNCHES["ssd_scan_bwd"] == 1
    _close_grads(got, _ssd_bwd_want(x, dt, A, B, C, dy, dtype), [dtype] * 5,
                 (nh, dtype), ("dx", "ddt", "dA", "dB", "dC"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "seamless-m4t-large-v2"])
def test_sharded_train_step_of_other_stacks(cuda_device, arch):
    """Reduced mamba2-130m (its SSD heads over model, 8 a slot; the fp32
    kernel's chunk of 64) and reduced seamless-m4t-large-v2 (16 frames into
    its encoder, the cross-attention at 64 queries over 16 keys): the
    sharded fp32 loss and gradients on a 2 x 2 mesh naming the card four
    times against the CPU's sharded pass on the same weights and batch,
    the loss within 1e-5 relative, each gradient leaf within 5e-4 of its
    largest (embed 5e-3); each slot launches the SSD scan, or flash, as
    the unsharded step launches it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_leaves, tree_map

    cfg = get_config(arch).reduced()
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               chunk=64))
    B, S, F = 4, 64, 16
    gpu = Model(cfg, dtype=torch.float32, device=cuda_device, remat=True)
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params = gpu.init(torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
             for k in ("tokens", "labels")}
    if cfg.is_encdec:
        batch["features"] = torch.randn((B, F, 1024), generator=g)
    ops.reset_launches()
    lg, gg = _sharded_grads(gpu, _train_ctx(cfg, _train_mesh(
        gpu.device, (2, 2)), B, S), params,
        {k: v.to(gpu.device) for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    L, E = cfg.n_layers, cfg.encoder_layers
    if cfg.ssm is not None:  # SSD forward + recompute, backward, a layer
        assert launches["ssd_scan"] == 4 * 2 * L
        assert launches["ssd_scan_bwd"] == 4 * L
        assert launches["rmsnorm"] == 4 * (2 * 2 * L + 1)
    else:  # self- and cross-attention a decoder layer, self an encoder one
        assert launches["flash_attention"] == 4 * 2 * (2 * L + E)
        assert launches["flash_attention_bwd"] == 4 * (2 * L + E)
        assert launches["rmsnorm"] == 4 * (2 * (3 * L + 2 * E) + 2)
    lc, gc_ = _sharded_grads(cpu, _train_ctx(cfg, _train_mesh(
        "cpu", (2, 2)), B, S), tree_map(lambda t: t.cpu(), params), batch)
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    for spec, a, b in zip(tree_leaves(gpu.schema()), gg, gc_):
        tol = 5e-3 if spec.axes == ("vocab", "embed") else 5e-4
        top = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * max(top, 1e-30), spec
