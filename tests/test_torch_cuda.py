"""Port kernels and model on a CUDA card: each hand-written Hopper kernel
against its plain PyTorch version, and the serving engine's launch counts.
Every test here skips without a card (the kernels have no CPU mode); the
file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances follow tests/test_kernels.py (fp32 atol 2e-5, bf16 atol 2e-2,
rtol 1e-2): kernel and plain version sum in different orders."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TOLS = {"fp32": 2e-5, "bf16": 2e-2}
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
    }
    assert eng.logits_all_finite()
    want, _ = serve(cpu, params_cpu, "cpu")
    assert got == want
