#!/usr/bin/env python3
"""Readings for a same-call A/B of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_ab.py SRC LABEL

takes the measurements below on the ``repro_torch`` package under SRC (a
``src`` directory: this checkout's, or another tree's unpacked with
``git archive``), through entry points every tree of the port has, prints
them as one JSON line and writes ``chiprun_out/ab_<LABEL>.json``. An A/B
runs it on the parent, the change, the change and the parent, in one call
to one card, and compares each reading only within that call:

- rmsnorm bf16 at ``chip_smoke.RMSNORM_SHAPES`` (llama3-8b and
  mamba2-130m widths): CUDA-event ms, device time alone (torch.profiler)
  and ``F.rms_norm``'s both beside; at the 8-row decode shapes also the
  host microseconds a call (there the kernel's device time is far under
  the host's, so 10,000 calls without a sync time the host, not a full
  launch queue);
- paged decode bf16 at ``chip_smoke.py`` phase 2's shape, and the ring
  kernel on the same K/V laid out densely: events and device time alone;
- the SSD scan bf16 at phase 2's shape (mamba2-130m's widths, b=1) and
  1024 and 2048 positions, and fp32 at 1024: events and device time
  alone, all its launches;
- flash bf16 at llama3-8b's heads: the [8, 1024] bucket, and phase 2's
  packed [1, 8192] row (phase 4's first admission) called with its
  segment ids alone (a tree whose kernel skips no tile by segment sweeps
  every key tile up to the diagonal): events and device time alone; its
  backward at phase 16's [2, 4096], causal, through the autograd
  Function: events and the device time of its three kernels alone;
- the SSD-scan backward bf16 through the autograd Function at phase 16
  (d)'s shapes, mamba2-130m's [8, 4096] and jamba's [2, 4096]: events,
  the device time of its kernels together and of each launch alone,
  and the launcher's scratch bytes where the tree states them (reading
  ``ssd_bwd``);
- phase 16 (d)'s mamba2-130m training run (24 layers, [8, 4096], 10
  steps): the median step, tokens/s and one profiled step's device busy
  time, idle share and the SSD backward's ms and share of busy (reading
  ``train``);
- rmsnorm's backward bf16 through the autograd Function at
  ``chip_smoke.RMSNORM_BWD_SHAPES``: events, its two launches' device time
  alone, ``F.rms_norm``'s backward beside, and the dw sum's device time
  at the plan's slices and at one where the tree's plan has slices
  (reading ``rmsnorm_bwd``);
- one profiled training step of qwen3-32b, mamba2-130m, deepseek-v2-236b
  and seamless-m4t at phase 16's shapes: device busy and the rmsnorm
  backward's and forward's ms (reading ``train_norms``);
- the wall seconds of each of phase 2's rmsnorm backward cases
  (``chip_smoke.rmsnorm_bwd_case``, on a tree whose launcher has
  ``plan_on``; reading ``rmsnorm_cases``);
- phase 4 of ``chip_smoke.py`` (``repro_torch.launch.serve`` on the
  32-layer llama3-8b): TTFT and TPOT p50;
- phase 5's decode step on that engine (10 whole-batch steps of the
  drained engine, as the tree dispatches them: eager before the decode
  step became one CUDA graph, replays of the graph after): host wall,
  device busy time and idle share a step from torch.profiler, and the
  unprofiled host wall a step;
- phase 6 (c)'s paged decode step (the shared-prefix traffic, paged with
  prefix reuse), profiled as ``chip_smoke.py`` profiles it;
- phase 7 (``repro_torch.launch.serve`` on the 24-layer mamba2-130m):
  TTFT and TPOT p50, and the 2048-token exact prefill's device busy time
  and the SSD kernels' share of it;
- the absorbed-MLA decode kernel bf16 at phase 2's shape (max_batch 8,
  2,048 latent slots, 128 heads, ``chip_smoke.MLA_LENS``), ring and paged:
  events and device time alone;
- phase 13's graphed decode step (deepseek-v2-236b at
  ``chip_smoke.MLA_LAYERS`` layers, warmed, after phase 4's requests):
  device busy time, idle share, and the MLA kernel's ms and share of the
  busy time.

A reading whose entry point a tree lacks prints as absent (null).

    python3 chip_ab.py SRC LABEL READING[,READING...]

takes only the named groups of readings: ``kernels`` (rmsnorm, paged and
ring decode, the SSD scan, flash and its backward, MLA decode),
``ssd_bwd``, ``serving`` (phases 4, 5, 6 (c), 7 and 13), ``train``,
``rmsnorm_bwd``, ``train_norms`` and ``rmsnorm_cases``; all seven without
the argument.

It reuses ``chip_smoke.py``'s helpers and fails, printing no result, on a
machine without a CUDA device.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

# the paged kernel's name: ``PagedRows`` since both decode kernels share
# one template, ``paged_decode`` in trees before that
PAGED_KEYS = ("PagedRows", "paged_decode")


def phase7(torch, ops):
    """Phase 7's TTFT and TPOT p50 and its profiled 2048-token prefill;
    None where the tree lacks the SSM path."""
    try:
        served, _ = cs.ssm_path(torch, ops)
    except (ImportError, AttributeError) as e:
        print(f"   phase 7 absent in this tree: {type(e).__name__}: {e}")
        return None
    pf = served["prefill_2048"]
    return {"ttft_ms_p50": served["ttft_ms"]["p50"],
            "tpot_ms_p50": served["tpot_ms"]["p50"],
            "prefill_2048_device_busy_ms": pf["device_busy_ms"],
            "prefill_2048_ssd_ms": pf["kernel_ms"],
            "prefill_2048_ssd_share": pf["kernel_share_of_device_time"]}


def mla(torch, ops, dev):
    """The MLA decode kernel bf16 at phase 2's shape, ring and paged:
    events and device time alone; None where the tree lacks it."""
    if not hasattr(ops, "paged_mla_decode_attention"):
        print("   MLA decode absent in this tree")
        return None
    (q_lat, q_rope, ckv, krope, lens), (cb, rb, table), scale = cs.mla_inputs(
        torch, dev)
    ring = lambda: ops.mla_decode_attention(  # noqa: E731
        q_lat, q_rope, ckv, krope, lens, scale=scale)
    paged = lambda: ops.paged_mla_decode_attention(  # noqa: E731
        q_lat, q_rope, cb, rb, table, lens, scale=scale)
    return {"ring": {"ms": cs.time_ms(torch, ring),
                     "device_ms": cs.device_ms(torch, ring, "mla_decode")},
            "paged": {"ms": cs.time_ms(torch, paged),
                      "device_ms": cs.device_ms(torch, paged, "mla_decode")}}


def phase13_step(torch, dev):
    """Phase 13's graphed decode step: deepseek-v2-236b at MLA_LAYERS
    layers, a warmed engine after phase 4's requests, profiled as
    ``chip_smoke.py`` profiles it; None where the tree lacks the model."""
    import dataclasses

    try:
        from repro_torch.configs import get_config
        from repro_torch.models import Model
        from repro_torch.serving import ServingEngine

        cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                                  n_layers=cs.MLA_LAYERS)
    except (ImportError, AttributeError, KeyError) as e:
        print(f"   phase 13 absent in this tree: {type(e).__name__}: {e}")
        return None
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = ServingEngine(model, params, max_batch=8, max_seq=2048, device=dev,
                        warmup=True)
    cs.serve_all(eng, cs.main_prompts(cfg.vocab_size), 32)
    prof = cs.decode_profile(torch, eng, key="mla_decode")
    busy, kernel = prof.get("device_busy_ms_per_step"), prof.get(
        "kernel_ms_per_step")
    del eng, model, params
    torch.cuda.empty_cache()
    return {"device_busy_ms_per_step": busy,
            "device_idle_share": prof.get("device_idle_share"),
            "mla_decode_ms_per_step": kernel,
            "mla_decode_share_of_busy": kernel / busy if busy and kernel
            is not None else None}


def flash(torch, ops, dev):
    """Flash bf16 at the [8, 1024] bucket and on phase 2's packed [1, 8192]
    row, and its backward at phase 16's [2, 4096], causal, through
    ``torch.autograd.grad`` of ``ops.flash_attention`` (the autograd
    Function, as training calls it): events and device time alone (the
    backward's three kernels)."""
    H, Hkv, hd = 32, 8, 128
    out = {}
    for name, B, S, seg in (
            ("flash_8x1024", 8, 1024, None),
            ("flash_packed_1x8192", 1, cs.PACKED_T,
             cs.packed_row(torch, cs.MAIN_LENS[:8], cs.PACKED_T, dev))):
        q = cs.rand(torch, (B, S, H, hd), "bf16", dev, 12)
        k = cs.rand(torch, (B, S, Hkv, hd), "bf16", dev, 13)
        v = cs.rand(torch, (B, S, Hkv, hd), "bf16", dev, 14)
        fn = lambda: ops.flash_attention(q, k, v, causal=True,  # noqa: E731
                                         segment_ids=seg)
        out[name] = {"ms": cs.time_ms(torch, fn, reps=10),
                     "device_ms": cs.device_ms(torch, fn, "flash")}
    B, S = cs.TRAIN_BATCH
    q, do = (cs.rand(torch, (B, S, H, hd), "bf16", dev, sd) for sd in (12, 15))
    k, v = (cs.rand(torch, (B, S, Hkv, hd), "bf16", dev, sd) for sd in (13, 14))
    qkv = [t.requires_grad_(True) for t in (q, k, v)]
    o = ops.flash_attention(*qkv, causal=True)
    bwd = lambda: torch.autograd.grad(o, qkv, do, retain_graph=True)  # noqa: E731
    out[f"flash_bwd_{B}x{S}"] = {
        "ms": cs.time_ms(torch, bwd, reps=5, warmup=2),
        "device_ms": cs.device_ms(torch, bwd, "flash_bwd", reps=5)}
    return out


def ssd_bwd(torch, ops, dev):
    """The SSD-scan backward bf16 through ``torch.autograd.grad`` of
    ``ops.ssd_scan`` (the autograd Function, as training calls it) at
    phase 16 (d)'s shapes: events, its kernels' device time together
    and each launch's alone, and the launcher's scratch bytes (None where
    the tree does not state them)."""
    from repro_torch.kernels import ssd_scan as _ssd

    out = {}
    for name, shape, b in (("mamba2_8x4096", cs.SSD_SHAPE, 8),
                           ("jamba_2x4096", cs.JAMBA_SSD_SHAPE, 2)):
        S = 4096
        nh, hd, ds = (shape[k] for k in ("nh", "hd", "ds"))
        x, dt, A, B, C = cs.ssd_inputs(torch, "bf16", S, dev, shape, b)
        dy = cs.rand(torch, (b, S, nh, hd), "bf16", dev, 22)
        ins = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
        y, _ = ops.ssd_scan(*ins, chunk=shape["chunk"])
        run = lambda: torch.autograd.grad(  # noqa: E731
            y, ins, dy, retain_graph=True)
        scratch = getattr(_ssd, "bwd_scratch_bytes", None)
        out[name] = {
            "ms": cs.time_ms(torch, run, reps=5, warmup=2),
            "device_ms": cs.device_ms(torch, run, "ssd_bwd", reps=5),
            "launch_device_ms": cs.device_ms_split(
                torch, run, cs.SSD_BWD_KERNELS, reps=5),
            "scratch_bytes": None if scratch is None else scratch(
                b, S, nh, hd, ds, "bf16")}
        print(f"   ssd_bwd {name}: {out[name]}", flush=True)
        del x, dt, A, B, C, dy, ins, y, run
        torch.cuda.empty_cache()
    return out


def train_mamba2(torch, ops, dev):
    """Phase 16 (d)'s mamba2-130m run (``chip_smoke.TRAIN_FAMILY``'s first
    entry) with its gates, and one more step profiled."""
    arch, layers, batch, changes = cs.TRAIN_FAMILY[0]
    cfg = cs.train_config(arch, layers, changes)
    res, model, params, state, data, opt = cs.train_run(
        torch, ops, dev, cfg, batch, f"{arch}, {layers} layers")
    prof = cs.train_step_profile(torch, model, params, state, data, opt,
                                 time_alone=False)
    del model, params, state
    torch.cuda.empty_cache()
    busy = prof.get("device_busy_ms")
    ssd = prof["parts_ms"].get("ssd_scan_bwd")
    return {"step_ms_median_after_first": res["step_ms_median_after_first"],
            "tokens_per_s": res["tokens_per_s"],
            "device_busy_ms": busy,
            "device_idle_share": prof.get("device_idle_share"),
            "parts_ms": prof["parts_ms"],
            "ssd_bwd_share_of_busy": ssd / busy if busy else None}


def rmsnorm_bwd(torch, F, ops, dev):
    """rmsnorm's backward bf16 through ``torch.autograd.grad`` of
    ``ops.rmsnorm`` (the autograd Function, as training calls it) at
    ``chip_smoke.RMSNORM_BWD_SHAPES``: events, the device time of its two
    launches alone (the rows, the dw sum) and ``F.rms_norm``'s backward
    beside; where the tree's launcher has a plan with slices of the dw sum,
    also the dw sum's device time at the plan's slices and at one (each
    column summed over all partial rows in order by one thread)."""
    from repro_torch.kernels import rmsnorm as _rn

    out = {}
    for N, D in cs.RMSNORM_BWD_SHAPES:
        x, dy = (cs.rand(torch, (N, D), "bf16", dev, sd) for sd in (16, 18))
        w = cs.rand(torch, (D,), "bf16", dev, 17)
        xw = [t.requires_grad_(True) for t in (x, w)]
        y = ops.rmsnorm(*xw, eps=1e-5)
        run = lambda: torch.autograd.grad(  # noqa: E731
            y, xw, dy, retain_graph=True)
        xr, wr = (t.detach().clone().requires_grad_(True) for t in (x, w))
        o = F.rms_norm(xr, (D,), wr, 1e-5)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            o, (xr, wr), dy, retain_graph=True)
        rec = {"ms": cs.time_ms(torch, run),
               "launch_device_ms": cs.device_ms_split(
                   torch, run, cs.RMSNORM_BWD_KERNELS),
               "library_device_ms": cs.device_ms(torch, lib, "")}
        if "slices" in getattr(getattr(_rn, "BwdPlan", None), "_fields", ()):
            rec["dw_sum"] = dw_sum_by_slices(torch, _rn, x.detach(),
                                             w.detach(), dy)
        out[f"{N}x{D}"] = rec
        print(f"   rmsnorm_bwd [{N}, {D}]: {rec}", flush=True)
        del x, dy, w, xw, y, xr, wr, o, run, lib
        torch.cuda.empty_cache()
    return out


def dw_sum_by_slices(torch, _rn, x, w, dy):
    """The dw sum's device time (torch.profiler) at the plan's slices and
    at one slice (each call both launches, the rows' the same), and the
    largest difference between the two dw."""
    D = w.shape[0]
    N = x.numel() // D
    dev = x.get_device()
    p, _ = _rn.plan_on(dev, N, D, 2, 3, True)
    dx, partial = torch.empty_like(x), torch.empty(
        (p.grid, D), dtype=torch.float32, device=x.device)
    res = {"grid": p.grid, "slices": p.slices}
    dws = {}
    for slices in (p.slices, 1):
        dw = dws[slices] = torch.empty_like(w)
        fn = lambda s=slices, o=dw: _rn._BWD(  # noqa: E731
            dev, x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            o.data_ptr(), partial.data_ptr(), N, D, 1, int(p.wide), p.vecs,
            p.lanes, p.threads, p.grid, s, 1e-5, 3)
        res[f"dw_device_ms_slices_{slices}"] = cs.device_ms(torch, fn,
                                                            "rmsnorm_dw")
    res["dw_max_abs_diff"] = float((dws[p.slices].float()
                                    - dws[1].float()).abs().max())
    return res


def rmsnorm_cases(torch, ops, dev):
    """The wall seconds of each of ``chip_smoke.py`` phase 2's rmsnorm
    backward cases (``chip_smoke.rmsnorm_bwd_case``: held, and in bf16 or
    at RMSNORM_BWD_FP32_TIMED timed), bf16 then fp32, and their sums over
    the shapes before and after the first three."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    walls = {}
    for dtype in ("bf16", "fp32"):
        for N, D in cs.RMSNORM_BWD_SHAPES:
            t0 = time.perf_counter()
            cs.rmsnorm_bwd_case(torch, F, ops, ref, dev, dtype, N, D)
            walls[f"{dtype} {N}x{D}"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    old = {f"{d} {N}x{D}" for d in ("bf16", "fp32")
           for N, D in cs.RMSNORM_BWD_SHAPES[:3]}
    return {"wall_s": walls,
            "first_three_s": sum(v for k, v in walls.items() if k in old),
            "others_s": sum(v for k, v in walls.items() if k not in old)}


# phase 16's stacks at the narrow widths: (arch, layers, [B, S], feature
# rows, config changes) from chip_smoke.TRAIN_FAMILY and TRAIN_STACKS
NORM_STACKS = ("qwen3-32b", "mamba2-130m", "deepseek-v2-236b",
               "seamless-m4t-large-v2")


def train_norms(torch, ops, dev):
    """One profiled training step (after two steps and a warm one) of each
    of NORM_STACKS at phase 16's shapes: device busy, and the rmsnorm
    kernels' ms by part (``chip_smoke.STEP_PARTS``: the backward's two
    launches apart from the forward)."""
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, train

    runs = {a: (a, L, b, 0, c) for a, L, b, c in cs.TRAIN_FAMILY}
    runs.update({r[0]: r for r in cs.TRAIN_STACKS})
    out = {}
    for arch in NORM_STACKS:
        _, layers, (B, S), features, changes = runs[arch]
        cfg = cs.train_config(arch, layers, changes)
        model = Model(cfg, remat=True, remat_policy="full")
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                          seed=0, feature_rows=features)
        opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
        params, state, _ = train(model, data, TrainConfig(steps=2, log_every=1,
                                                          seed=0), opt,
                                 log_fn=lambda m: None)
        prof = cs.train_step_profile(torch, model, params, state, data, opt,
                                     time_alone=False, cpu_ops=False)
        out[arch] = {"layers": layers, "batch": [B, S],
                     "device_busy_ms": prof.get("device_busy_ms"),
                     "rmsnorm_bwd_ms": prof["parts_ms"].get("rmsnorm_bwd"),
                     "rmsnorm_fwd_ms": prof["parts_ms"].get("rmsnorm")}
        print(f"   train_norms {arch}: {out[arch]}", flush=True)
        del model, params, state
        torch.cuda.empty_cache()
    return out


READINGS = ("kernels", "ssd_bwd", "serving", "train", "rmsnorm_bwd",
            "train_norms", "rmsnorm_cases")


def main():
    if len(sys.argv) not in (3, 4):
        print("usage: python3 chip_ab.py SRC LABEL [READING[,READING...]]",
              flush=True)
        sys.exit(2)
    src, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    take = sys.argv[3].split(",") if len(sys.argv) == 4 else list(READINGS)
    if not set(take) <= set(READINGS):
        print(f"readings are among {READINGS}: {take}", flush=True)
        sys.exit(2)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; chip_ab.py runs on an NVIDIA card",
              flush=True)
        sys.exit(2)
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.kernels import build, ops
    from repro_torch.serving import Request, ServingEngine

    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise AssertionError(f"{src}: imported {repro_torch.__file__}")

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all()
    out = {"label": label, "src": str(src),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}
    if "kernels" in take:
        kernel_readings(torch, F, ops, dev, out)
    if "ssd_bwd" in take:
        out["ssd_bwd"] = ssd_bwd(torch, ops, dev)
    if "serving" in take:
        serving_readings(torch, ops, dev, out, Request, ServingEngine)
    if "train" in take:
        out["train_mamba2"] = train_mamba2(torch, ops, dev)
    if "rmsnorm_bwd" in take:
        out["rmsnorm_bwd"] = rmsnorm_bwd(torch, F, ops, dev)
    if "train_norms" in take:
        out["train_norms"] = train_norms(torch, ops, dev)
    if "rmsnorm_cases" in take:
        out["rmsnorm_cases"] = rmsnorm_cases(torch, ops, dev)
    line = json.dumps(out)
    (cs.ROOT / "chiprun_out").mkdir(exist_ok=True)
    (cs.ROOT / "chiprun_out" / f"ab_{label}.json").write_text(line)
    print(line)


def kernel_readings(torch, F, ops, dev, out):
    """The kernel readings of the module docstring's first five items and
    the MLA decode kernel's, into ``out``."""
    for N, D in cs.RMSNORM_SHAPES:
        x = cs.rand(torch, (N, D), "bf16", dev, 0)
        w = cs.rand(torch, (D,), "bf16", dev, 1)
        kernel = lambda: ops.rmsnorm(x, w)  # noqa: E731
        lib = lambda: F.rms_norm(x, (D,), w, 1e-5)  # noqa: E731
        rec = {"ms": cs.time_ms(torch, kernel),
               "device_ms": cs.device_ms(torch, kernel, "rmsnorm"),
               "library_ms": cs.time_ms(torch, lib),
               "library_device_ms": cs.device_ms(torch, lib, "")}
        if N == 8:
            rec["host_us"] = cs.host_us(torch, kernel)
        out[f"rmsnorm_{N}x{D}"] = rec
    q, kb, vb, pt, lens, kd, vd = cs.paged_inputs(torch, "bf16", dev)
    paged = lambda: ops.paged_decode_attention(q, kb, vb, pt, lens)  # noqa: E731
    ring = lambda: ops.decode_attention(q, kd, vd, lens)  # noqa: E731
    out["paged"] = {"ms": cs.time_ms(torch, paged),
                    "device_ms": cs.device_ms(torch, paged, PAGED_KEYS),
                    "ring_ms": cs.time_ms(torch, ring),
                    "ring_device_ms": cs.device_ms(torch, ring, "decode_split")}
    del q, kb, vb, pt, lens, kd, vd
    for S in (1024, 2048):
        x, dt, A, B, C = cs.ssd_inputs(torch, "bf16", S, dev)
        ssd = lambda: ops.ssd_scan(x, dt, A, B, C,  # noqa: E731
                                   chunk=cs.SSD_SHAPE["chunk"])
        out[f"ssd_{S}"] = {"ms": cs.time_ms(torch, ssd),
                           "device_ms": cs.device_ms(torch, ssd, "ssd_scan")}
    x, dt, A, B, C = cs.ssd_inputs(torch, "fp32", 1024, dev)
    ssd = lambda: ops.ssd_scan(x, dt, A, B, C,  # noqa: E731
                               chunk=cs.SSD_SHAPE["chunk"])
    out["ssd_fp32_1024"] = {"ms": cs.time_ms(torch, ssd),
                            "device_ms": cs.device_ms(torch, ssd, "ssd_scan")}
    del x, dt, A, B, C
    out.update(flash(torch, ops, dev))
    out["mla"] = mla(torch, ops, dev)
    print(f"   kernels: {json.dumps(out)}", flush=True)


def serving_readings(torch, ops, dev, out, Request, ServingEngine):
    """Phases 4, 5, 6 (c), 7 and 13's readings, into ``out``."""
    served, engine = cs.main_path(torch, ops)
    out["phase4"] = {"ttft_ms_p50": served["ttft_ms"]["p50"],
                     "tpot_ms_p50": served["tpot_ms"]["p50"]}
    step = cs.decode_profile(torch, engine)
    out["phase5_step"] = {k: step.get(k) for k in (
        "host_wall_ms_per_step", "unprofiled_host_wall_ms_per_step",
        "device_busy_ms_per_step", "device_idle_share",
        "device_kernels_per_step")}
    model, params = engine.model, engine.params
    del engine
    torch.cuda.empty_cache()
    prompts, _, primes = cs.paged_traffic(model.cfg)
    new = cs.PAGED_TRAFFIC["max_new"]
    eng = ServingEngine(model, params, max_batch=8, max_seq=2048,
                        device=model.device, paged=True)
    for wave in (primes, prompts):
        for t in wave:
            eng.submit(Request(prompt_tokens=t.copy(), max_new_tokens=new))
        eng.run_until_drained()
    cs.clear_index(eng)
    prof = cs.live_step_profile(torch, eng, prompts, new, key=PAGED_KEYS)
    out["phase6c_step"] = {k: prof.get(k) for k in (
        "host_wall_ms_per_step", "device_busy_ms_per_step",
        "device_idle_share", "kernel_ms_per_step")}
    del eng, model, params
    torch.cuda.empty_cache()
    out["phase7"] = phase7(torch, ops)
    out["phase13_step"] = phase13_step(torch, dev)


if __name__ == "__main__":
    main()
