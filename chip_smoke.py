#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero and prints no
result line:

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every CUDA kernel from the sources in the checkout;
2. every kernel of the serving path (rmsnorm, flash prefill, ring decode)
   against its plain PyTorch version on the card, at the main path's shapes,
   in bf16 and fp32, with its time beside its bound, the plain version's
   time and one PyTorch library call's time (a yardstick only);
3. the same weights on card and CPU: llama3-8b at full width cut to 2
   layers, a ragged bucketed prefill then 4 decode steps, the card through
   the kernels and the CPU through the plain versions, both fed the card's
   greedy token; where the greedy tokens part, the CPU's top-2 logit gap;
4. the main path: ``repro_torch.launch.serve`` on the full 32-layer
   llama3-8b, ServingEngine(max_batch=8, max_seq=2048), 12 ragged requests
   (64-1024 prompt tokens, 32 new tokens each), with the kernels' launch
   counts held against the path's structure;
5. where a decode step's time goes: 10 whole-batch steps of the drained
   engine under torch.profiler -- host wall, device first-to-last span and
   device busy time per step, all from that one profiled run, the device's
   idle share and the kernels that take the most time; and, from a separate
   unprofiled run of the same steps, the host wall per step alone.

Numerics: fp32 references run with TF32 off; kernels are held at fp32 atol
2e-5 / bf16 atol 2e-2, rtol 1e-2 (the kernel and the plain version sum in
different orders). The full results go to chiprun_out/chip_smoke.json.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data-sheet peaks (dense); a card below 700 W runs slower.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # tensor-core bf16; fp32 FMA
TOLS = {"bf16": 2e-2, "fp32": 2e-5}
RTOL = 1e-2
N_LAYERS = 32
MAIN_ARGV = ["--arch", "llama3-8b", "--max-batch", "8", "--max-seq", "2048",
             "--clients", "12", "--requests", "1", "--prompt-len", "64:1024",
             "--new-tokens", "32", "--transport", "gdr"]


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0, msg=""):
    print(f"   ok ({time.perf_counter() - t0:.1f} s) {msg}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; chip_smoke.py runs on an NVIDIA card",
              flush=True)
        sys.exit(2)
    from repro_torch.kernels import build, ops  # fails without the checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results = {}

    # ------------------------------------------------------------------ #
    t0 = phase("phase 1: environment and kernel build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"   card: {smi}")
    print(f"   python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    build_s = build.build_all()
    print(f"   nvcc build of {', '.join(build.SOURCES)}: {build_s:.1f} s")
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"   [{name}] {line.strip()}")
    results["env"] = {"card": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "build_s": build_s}
    done(t0)

    # ------------------------------------------------------------------ #
    t0 = phase("phase 2: kernels vs their plain versions on the card")
    print(f"   tolerances: |kernel - plain| <= atol + {RTOL} |plain|, atol "
          f"{TOLS['fp32']} fp32 / {TOLS['bf16']} bf16 (different summation "
          f"orders); bounds from the H100 SXM peaks {PEAK_BYTES_S:.3g} B/s, "
          f"{PEAK_FLOPS['bf16']:.3g} bf16 / {PEAK_FLOPS['fp32']:.3g} fp32 FLOP/s")
    results["kernels"] = check_kernels(torch, ops, dev)
    done(t0)

    # ------------------------------------------------------------------ #
    t0 = phase("phase 3: same weights on card and CPU (llama3-8b, 2 layers)")
    results["same_weights"] = same_weights(torch, dev)
    done(t0)

    # ------------------------------------------------------------------ #
    t0 = phase("phase 4: main path, repro_torch.launch.serve on llama3-8b")
    results["main_path"], engine = main_path(torch, ops)
    done(t0)

    t0 = phase("phase 5: where a decode step's time goes (torch.profiler)")
    results["decode_profile"] = decode_profile(torch, engine)
    done(t0)

    kernel_line = []
    for k in results["kernels"]["summary"]:
        k = dict(k)
        k["launches"] = results["main_path"]["launches"][k["name"]]
        kernel_line.append(k)
    results["kernel_line"] = kernel_line
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernel_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# --------------------------------------------------------------------------- #
# timing helpers
# --------------------------------------------------------------------------- #
def time_ms(torch, fn, reps=20, warmup=3):
    """Median per-call device time of ``fn`` (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def library_ms(torch, fn, **kw):
    """Time of a PyTorch library call used as a yardstick only; None when
    this torch build cannot make the call."""
    try:
        return time_ms(torch, fn, **kw)
    except (TypeError, RuntimeError) as e:
        print(f"   (library call unavailable: {type(e).__name__}: {e})")
        return None


def compare(torch, got, want, dtype, what):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output not finite")
    err = (got - want).abs()
    bad = err > TOLS[dtype] + RTOL * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond "
                             f"atol {TOLS[dtype]} rtol {RTOL}; max err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def case_record(torch, name, dtype, shape, got, want, t_kernel, t_plain,
                t_lib, nbytes, flops):
    err = compare(torch, got, want, dtype, f"{name} {dtype} {shape}")
    b_ms, b_by = bound(nbytes, flops, dtype)
    rec = {"name": name, "dtype": dtype, "shape": shape, "max_abs_err": err,
           "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops}
    print(f"   {name:16s} {dtype} {shape}: err {err:.2e}  kernel "
          f"{t_kernel:.4f} ms  plain {t_plain:.4f} ms  library "
          f"{'n/a' if t_lib is None else '%.4f ms' % t_lib}  bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    return rec


def rand(torch, shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
    return t.to({"bf16": torch.bfloat16, "fp32": torch.float32}[dtype])


# --------------------------------------------------------------------------- #
# phase 2
# --------------------------------------------------------------------------- #
def check_kernels(torch, ops, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    cases = []
    # rmsnorm: decode ([max_batch, d]) and a 1024-token prefill bucket
    for dtype in ("bf16", "fp32"):
        for N in (8, 8 * 1024):
            D = 4096
            x = rand(torch, (N, D), dtype, dev, 0)
            w = rand(torch, (D,), dtype, dev, 1)
            isz = x.element_size()
            lib = None
            if hasattr(F, "rms_norm"):
                lib = library_ms(torch, lambda: F.rms_norm(x, (D,), w, 1e-5))
            cases.append(case_record(
                torch, "rmsnorm", dtype, [N, D], ops.rmsnorm(x, w),
                ref.rmsnorm_ref(x, w), time_ms(torch, lambda: ops.rmsnorm(x, w)),
                time_ms(torch, lambda: ref.rmsnorm_ref(x, w)), lib,
                (2 * N * D + D) * isz, 4 * N * D))

    # flash prefill: B=8, H=32, Hkv=8, hd=128; causal at S=256 and 1024,
    # plus window + packed segment ids at S=1024
    B, H, Hkv, hd = 8, 32, 8, 128
    for dtype in ("bf16", "fp32"):
        for S, window, segmented in ((256, 0, False), (1024, 0, False),
                                     (1024, 256, True)):
            q = rand(torch, (B, S, H, hd), dtype, dev, 2)
            k = rand(torch, (B, S, Hkv, hd), dtype, dev, 3)
            v = rand(torch, (B, S, Hkv, hd), dtype, dev, 4)
            seg = None
            if segmented:
                seg = torch.full((B, S), -1, dtype=torch.int32, device=dev)
                for b in range(B):  # ragged packed segments, pad tail
                    cuts = [0, 100 + 37 * b, 400 + 51 * b, 900 + 10 * b]
                    for j in range(3):
                        seg[b, cuts[j]:cuts[j + 1]] = j
            kw = dict(causal=True, window=window, segment_ids=seg)
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            qi = torch.arange(S, device=dev)[:, None]
            ki = torch.arange(S, device=dev)[None, :]
            mask = qi >= ki
            if window:
                mask = mask & (ki > qi - window)
            if seg is not None:
                pairs = int((mask[None] & (seg[:, :, None] == seg[:, None, :]))
                            .sum()) * H
            else:
                pairs = int(mask.sum()) * B * H
            isz = q.element_size()
            nbytes = 2 * (B * S * H * hd + B * S * Hkv * hd) * isz + (
                0 if seg is None else 2 * B * S * 4)
            lib = None
            if not segmented:
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                lib = library_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
            cases.append(case_record(
                torch, "flash_attention", dtype,
                [B, S, H, Hkv, hd, f"window={window}", f"segments={segmented}"],
                got, want, time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                                   reps=10),
                time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw),
                        reps=5, warmup=1),
                lib, nbytes, 4 * hd * pairs))
            del got, want

    # ring decode: B=8, W=2048, ragged lengths including an empty slot
    W = 2048
    lens_host = [0, 1, 64, 300, 777, 1024, 1500, 2048]
    lens = torch.tensor(lens_host, dtype=torch.int32, device=dev)
    for dtype in ("bf16", "fp32"):
        q = rand(torch, (B, 1, H, hd), dtype, dev, 5)
        k = rand(torch, (B, W, Hkv, hd), dtype, dev, 6)
        v = rand(torch, (B, W, Hkv, hd), dtype, dev, 7)
        got = ops.decode_attention(q, k, v, lens)
        if not (got[0] == 0).all():
            raise AssertionError("decode kernel: an empty slot must be zeros")
        want = ref.decode_attention_ref(q, k, v, lens)
        isz = q.element_size()
        n_pos = sum(lens_host)
        nbytes = (2 * B * H * hd + 2 * n_pos * Hkv * hd) * isz + B * 4
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        amask = (torch.arange(W, device=dev)[None, :] < lens[:, None])[:, None, None]
        lib = library_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask, enable_gqa=True))
        cases.append(case_record(
            torch, "decode_attention", dtype, [B, W, H, Hkv, hd, lens_host],
            got, want, time_ms(torch, lambda: ops.decode_attention(q, k, v, lens)),
            time_ms(torch, lambda: ref.decode_attention_ref(q, k, v, lens)),
            lib, nbytes, 4 * hd * H * n_pos))

    # the line's entry per kernel: bf16 (the serving dtype) at the shape the
    # main path launches most (decode for rmsnorm, the 1024 bucket for flash)
    pick = {"rmsnorm": [8, 4096],
            "flash_attention": [B, 1024, H, Hkv, hd, "window=0", "segments=False"],
            "decode_attention": [B, W, H, Hkv, hd, lens_host]}
    meta = {
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                    "src/repro/kernels/rmsnorm.py:23"),
        "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:103"),
        "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:79"),
    }
    summary = []
    for name, shape in pick.items():
        c = next(c for c in cases
                 if c["name"] == name and c["dtype"] == "bf16" and c["shape"] == shape)
        route, source, replaces = meta[name]
        summary.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                        "shape": shape, "dtype": "bf16"})
    return {"cases": cases, "summary": summary}


# --------------------------------------------------------------------------- #
# phase 3
# --------------------------------------------------------------------------- #
def same_weights(torch, dev):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.kvcache import grow_cache
    from repro_torch.models.schema import tree_map

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    gpu = Model(cfg, device=dev)
    params = gpu.init(torch.Generator(device=dev).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    lens = [17, 64, 40, 9]
    L, K = 64, 4
    g = torch.Generator().manual_seed(1)
    toks = torch.zeros((len(lens), L), dtype=torch.int32)
    for i, s in enumerate(lens):
        toks[i, :s] = torch.randint(0, cfg.vocab_size, (s,), generator=g)
    lens_t = torch.tensor(lens, dtype=torch.int32)

    lg_g, c_g, n_g = gpu.prefill_bucketed(params, toks.to(dev), lens_t.to(dev))
    lg_c, c_c, n_c = cpu.prefill_bucketed(params_cpu, toks, lens_t)
    c_g, c_c = grow_cache(c_g, L + K), grow_cache(c_c, L + K)
    rel, agree, total, misses = [], 0, 0, []
    for step in range(K + 1):
        if not torch.isfinite(lg_g).all():
            raise AssertionError(f"card logits not finite at step {step}")
        a, b = lg_g.float().cpu(), lg_c.float()
        rel.append(float((a - b).abs().max() / b.abs().max()))
        nxt, nxt_c = a.argmax(-1), b.argmax(-1)
        agree += int((nxt == nxt_c).sum())
        total += len(lens)
        for r in (nxt != nxt_c).nonzero().flatten().tolist():
            # where the greedy tokens part: the CPU's top-2 logit gap, the
            # CPU's margin of its token over the card's, and the row's
            # largest card-vs-CPU logit difference
            top2 = b[r].topk(2).values
            misses.append({
                "step": step, "row": r, "card_token": int(nxt[r]),
                "cpu_token": int(nxt_c[r]),
                "cpu_top2_gap": float(top2[0] - top2[1]),
                "cpu_margin_over_card_token": float(b[r, nxt_c[r]] - b[r, nxt[r]]),
                "row_max_abs_diff": float((a[r] - b[r]).abs().max()),
                "row_max_abs_logit": float(b[r].abs().max())})
            print(f"   tokens part at step {step} row {r}: " + ", ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in misses[-1].items() if k not in ("step", "row")))
        if step == K:
            break
        # both sides take the card's token, so each step compares logits on
        # the same context (a parted token cannot grow into a new sequence)
        tok = nxt.to(torch.int32)[:, None]
        lg_g, c_g, n_g = gpu.decode_step(params, c_g, tok.to(dev), n_g)
        lg_c, c_c, n_c = cpu.decode_step(params_cpu, c_c, tok, n_c)
    worst = max(rel)
    print(f"   max|logit diff| / max|logit| per step: "
          f"{', '.join('%.2e' % r for r in rel)}; greedy agreement "
          f"{agree}/{total}")
    if worst > 2e-2:
        raise AssertionError(f"card vs CPU logits differ by {worst:.3e} > 2e-2 "
                             "of the largest logit")
    del gpu, params, params_cpu, c_g, c_c
    torch.cuda.empty_cache()
    return {"rel_err_per_step": rel, "greedy_agree": agree,
            "greedy_total": total, "greedy_misses": misses, "tolerance": 2e-2}


# --------------------------------------------------------------------------- #
# phase 4
# --------------------------------------------------------------------------- #
def main_path(torch, ops):
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve.main(MAIN_ARGV)
    launches = dict(ops.LAUNCHES)
    eng = out["engine"]
    c = eng.counters()
    responses = out["responses"]
    if len(responses) != 12 or any(len(r.tokens) != 32 for r in responses):
        raise AssertionError(f"main path: token counts "
                             f"{[len(r.tokens) for r in responses]}")
    if not eng.logits_all_finite():
        raise AssertionError("main path: a logit was not finite")
    forwards = c["prefill_calls"] + c["decode_steps"]
    want = {"rmsnorm": (2 * N_LAYERS + 1) * forwards,
            "flash_attention": N_LAYERS * c["prefill_calls"],
            "decode_attention": N_LAYERS * c["decode_steps"]}
    print(f"   counters {c}; launches {launches}; expected {want}")
    if min(launches.values()) == 0 or launches != want:
        raise AssertionError(f"launch counts {launches} != path structure {want}")
    peak = torch.cuda.max_memory_allocated()
    slo = out["slo"]
    res = {
        "argv": MAIN_ARGV, "counters": c, "launches": launches,
        "wall_s": out["wall_s"], "tokens": out["tokens"],
        "tokens_per_s": out["tokens"] / out["wall_s"],
        "ttft_ms": {p: slo["ttft_s"][p] * 1e3 for p in ("p50", "p99", "mean")},
        "tpot_ms": {p: slo["tpot_s"][p] * 1e3 for p in ("p50", "p99", "mean")},
        "stage_means_ms": {k: v * 1e3 for k, v in
                           eng.store.stage_means().items()},
        "peak_mem_gb": peak / 1e9,
    }
    print(f"   peak device memory {peak / 1e9:.2f} GB; kernels "
          f"{json.dumps(launches)}")
    return res, eng


# --------------------------------------------------------------------------- #
# phase 5
# --------------------------------------------------------------------------- #
def decode_profile(torch, eng, steps=10):
    """Whole-batch decode steps of the drained engine (its slots are frozen
    lanes, which run the same batched compute as live ones)."""
    from torch.profiler import ProfilerActivity, profile

    pool = eng.pool

    def run():
        for _ in range(steps):
            pool.fill_one(eng.params, limit=steps)
            pool.pop_oldest()
        torch.cuda.synchronize()

    run()  # warm
    t0 = time.perf_counter()
    run()
    bare_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    from torch.autograd import DeviceType

    # first to last device timestamp of the profiled run
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if getattr(e, "device_type", None) == DeviceType.CUDA]
    span_ms = ((max(e for _, e in spans) - min(s for s, _ in spans))
               / 1e3 / steps if spans else None)
    kernels = []  # device-side events only (CPU ops would count twice)
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        kernels.append((dev_us / steps / 1e3, evt.key, evt.count / steps))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    res = {"steps": steps, "host_wall_ms_per_step": wall_ms,
           "device_span_ms_per_step": span_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_kernels_per_step": sum(k[2] for k in kernels),
           "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "device_idle_share_of_span": (1 - busy_ms / span_ms)
           if busy_ms and span_ms else None,
           "unprofiled_host_wall_ms_per_step": bare_wall_ms,
           "top": [{"ms_per_step": ms, "name": name[:80], "calls_per_step": n}
                   for ms, name, n in kernels[:8]]}
    if busy_ms:
        print(f"   profiled run: host wall {wall_ms:.2f} ms/step, device "
              f"first-to-last {span_ms:.2f} ms/step, busy {busy_ms:.2f} ms/step "
              f"over {res['device_kernels_per_step']:.0f} kernels; idle share "
              f"{res['device_idle_share']:.2f} of the wall, "
              f"{res['device_idle_share_of_span']:.2f} of the device span")
    else:
        print(f"   profiled run: host wall {wall_ms:.2f} ms/step; the "
              "profiler reported no device time: busy and idle not measured")
    print(f"   a separate unprofiled run: host wall {bare_wall_ms:.2f} ms/step")
    for k in res["top"]:
        print(f"   {k['ms_per_step']:8.3f} ms  x{k['calls_per_step']:<5g} {k['name']}")
    return res


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException as e:  # report the failing phase, then exit non-zero
        import traceback

        traceback.print_exc()
        print(f"FAIL: {type(e).__name__}: {e}", flush=True)
        sys.exit(1)
