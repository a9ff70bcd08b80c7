#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero and prints no
result line:

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every CUDA kernel from the sources in the checkout;
2. every kernel of the serving and training paths (rmsnorm, flash
   prefill -- plain and with a cached prefix --, ring decode, paged
   decode, the SSD scan, the backward kernels)
   against its plain PyTorch version on the card, at the main paths'
   shapes, in bf16 and fp32, with its time beside its bound, the plain
   version's time and one PyTorch library call's time where one computes
   the same function (a yardstick only), its achieved TFLOP/s and GB/s and
   its share of the bound; rmsnorm at llama3-8b's and mamba2-130m's widths,
   and what each step of its launch path costs the host; the paged kernel
   also against the ring kernel on the same K/V laid out densely, bitwise,
   at the launchers' split count and at one CTA a row, with its split plan
   and launch; the device time alone (torch.profiler) of rmsnorm, flash,
   ring and paged decode, the SSD scan and preprocess beside the CUDA-event
   time; for the kernels redesigned for Hopper the grid, block, shared
   memory and registers as launched, the cluster shape, ptxas's registers
   and spills (none allowed in rmsnorm, either decode kernel, the SSD
   scan or any flash-backward instantiation), and the HGMMA instructions
   in the flash, flash-backward and SSD libraries' SASS where cuobjdump
   exists (none found fails); the bf16 flash backward's three launches
   (grid, shared memory, registers) at phase 16's shape; the SSD scan at
   1024, 2048, 1000 and 77 positions, the device time of each of its three bf16
   launches and of the whole scan at each heads-a-CTA choice at 1024 and
   2048 positions; deepseek-v2-236b's attention at its published dims and
   128 heads: flash over the [8, 1024] bucket at q/k 192, v 128 (SDPA
   beside it), the absorbed-MLA decode kernel at max_batch 8 over 2,048
   latent slots, ring and paged (pages of 16; paged == ring bitwise), SDPA
   over the concatenated 576-wide keys beside it; and the preprocess kernel on its
   path, the entry point ``ops.preprocess`` (4 batches of 8 camera frames,
   the paper's input), then against its plain version there and at
   tests/test_kernels.py's shapes; flash on a packed [1, 8192] row (phase
   4's first admission: 8 segments and a pad run), its bound counting the
   segments' causal pairs, SDPA with a block-diagonal causal mask beside
   it, and its device time against the [8, 1024] bucketed case's; rmsnorm
   at qwen3-32b's qk-norm width (128) for [524288, 128] and [512, 128];
   the SSD scan at jamba-v0.1-52b's widths (128 heads of 64, d_state 16)
   at 1024, 881, 192 and 64 positions, and its three bf16 launches and
   heads-a-CTA sweep at 1024 and 2048 there; flash without the causal mask
   at seamless-m4t's head dims: its encoder (4 x 1024 frames) and its
   cross-attention (a 2-token prompt over 1024 frames), and the decode
   kernel over its static cross cache (1024 rows), SDPA beside each; the
   two backward kernels (training): flash's at phase 16's [2, 4096] (32
   heads, 8 KV heads, 128) and at [8, 1024], causal, and rmsnorm's at
   [8192, 4096] and [8, 4096], bf16 and fp32, against ``torch.autograd``
   through the plain versions, two calls bitwise equal, their device time
   alone, SDPA's and ``F.rms_norm``'s backward beside them, and no ptxas
   spills in their bodies (flash's bf16 body on wgmma, its fp32 body on
   the CUDA cores); flash's at MLA's head dims (192, 128, 128 heads) at
   [2, 4096], [8, 1024] and with a pad, SDPA's backward beside it; the SSD
   scan's at mamba2-130m's and jamba's training shapes ([8, 4096], [2,
   4096]), ragged, below one chunk and under strong decay, bf16 and fp32
   (the fp32 oracle the plain version in float64), each with its bound by
   bytes and by operations, each launch's device time and the scratch
   bytes; its bf16 launches' shapes at those training shapes, no ptxas
   spills in any of its kernels and HGMMA in its SASS (``ssd_bwd_design``);
   the ring and MLA decode kernels with their lse output at phase 18's
   shard shape (8 rows over 512 slots, a shard with no valid slot among
   them): out bitwise equal with lse on and off, lse against the plain
   version's (-inf exactly where no slot is valid), each kernel's device
   time alone with and without lse; what ``build.CFunction``'s device
   check costs a launch, in rmsnorm's launch-path rows; the backward
   kernels at phase 16 (e)'s shapes: rmsnorm's at qwen3-32b's qk-norm rows
   [524288, 128], flash's at granite-34b's MQA [2, 4096, 48/1, 128]
   (causal; the plain version 8 query heads a call) and seamless-m4t's
   encoder [4, 1024, 16, 64], non-causal (its decoder's cross-attention,
   Sq and Skv 1024, is the same launch), each as the backward cases above;
3. the same weights on card and CPU: llama3-8b at full width cut to 2
   layers, a ragged bucketed prefill then 4 decode steps on a ring cache of
   2048 slots (so the card's decode kernel splits each row over a cluster
   of CTAs), the card through
   the kernels and the CPU through the plain versions, both fed the card's
   greedy token; where the greedy tokens part, the CPU's top-2 logit gap;
   3b. the same for mamba2-130m at full width and full depth: one exact
   prefill of 601 tokens, then 4 decode steps, held to the limit in fp32;
   in bf16 (where the random 24-layer stack amplifies the two sides'
   different roundings) the card and the CPU are each held against the
   CPU model in fp32 on the same weights, the card within SSM_BF16_LIMIT;
   3c. the same for starcoder2-3b, qwen3-32b (qk-norm) and granite-34b
   (MQA) at published widths cut to 2 layers, and llama3-8b cut to 2
   layers with a 256-token sliding window, prompts longer than the window
   and decode steps that wrap its 256-slot ring;
4. the main path: ``repro_torch.launch.serve`` on the full 32-layer
   llama3-8b, ServingEngine(max_batch=8, max_seq=2048), 12 ragged requests
   (64-1024 prompt tokens, 32 new tokens each), with the kernels' launch
   counts held against the path's structure;
   4 (b). phase 4's 12 requests on its model and weights, all submitted at
   once, served bucketed, packed (``packed=True``), chunked
   (``prefill_chunk=256``) and both (a warm pass, then a measured pass in
   reverse order): launch counts (flash 32 per prefill call, packed or a
   chunk; rmsnorm 65 per forward), tokens equal to the bucketed run's or
   parted only where the top-2 gap is under 0.02 of the largest logit,
   padded token-rows (bucketed exactly 26,624, packed under it), TTFT
   p50/p99, TPOT p50 and 'preprocess'; then one packed prefill of the
   first admission under torch.profiler (busy time, flash's share);
5. where a decode step's time goes: 10 whole-batch steps of the drained
   engine under torch.profiler, as replays of its captured decode graph
   and again as the eager step -- host wall, device first-to-last span and
   device busy time per step, all from that one profiled run, the device's
   idle share and the kernels that take the most time; and, from a separate
   unprofiled run of the same steps, the host wall and the stream's
   CUDA-event time per step; then the flash kernel's share of the device
   time of one profiled prefill of the 8 x 1024 bucket;
6. the paged path on the same 32-layer llama3-8b and weights:
   ServingEngine(max_batch=8, max_seq=2048) serves one shared-prefix
   workload (2 Zipf-weighted 1024-token system prompts, 64-token suffixes,
   32 new tokens; one priming request per prefix, then 24 requests at once)
   three times: (a) the ring pool, (b) paged without and (c) paged with
   prefix reuse. (b)'s greedy tokens must equal (a)'s: both decode kernels
   are one split-KV template with one split plan, so the same keys go
   through the same arithmetic; (c)'s prefix counters must be exactly 24
   hits of 1024 tokens, every launch count must follow the path's
   structure, and clearing the index must leave no block live; it prints
   TTFT/TPOT p50 per run and where (c)'s tokens part from (b)'s, then
   profiles (c)'s decode step on one more wave of live rows as phase 5
   does the ring step;
7. the SSM path: ``repro_torch.launch.serve`` on the 24-layer mamba2-130m,
   ServingEngine(max_batch=8, max_seq=2048), 12 requests of 64-2048 prompt
   tokens and 32 new tokens, one exact-shape prefill per request, with the
   launch counts held against the path's structure; then the SSD kernel's
   share of the device time of one profiled 2048-token prefill, and where
   a decode step's time goes, measured as in phase 5;
8. the disaggregated tier: (a) phase 4's 12 requests on the 32-layer
   llama3-8b, all submitted at once, through the fused engine and
   DisaggregatedEngine under DIRECT_HBM, DIRECT_DMA and HOST_STAGED (a warm
   pass each, then two measured passes in turns), holding the direct
   mechanisms' tokens to the fused engine's, HOST_STAGED's first tokens and
   budgets, the extents and wire bytes to those worked out by hand from
   the prompt lengths and to a host-side sum over the handoffs' extents,
   and the launch counts to the path; (b) phase 6's shared-prefix traffic,
   paged with reuse, under DIRECT_DMA: phase 6 (c)'s tokens, 24 hits, wire
   bytes equal to the admission plan's; (c) 4 mamba2-130m requests under
   DIRECT_HBM: the fused engine's tokens, 19,132,432 wire bytes each. It
   prints each mechanism's hop wall, wire GB/s, the PAPER_A2 model for the
   same bytes, TTFT p50 and the 'transfer' and 'preprocess' means;
9. the dense family served packed and chunked: starcoder2-3b (30 of 30
   layers), qwen3-32b (16 of 64) and granite-34b (8 of 88) at published
   widths, random bf16 weights, each served with phase 4's traffic the
   four ways of phase 4 (b), with the same gates (qwen3's rmsnorm 4L + 1
   a forward), then freed before the next;
10. the decode step as one CUDA graph (run after phase 8, on its models):
   every engine warmed (``warmup=True``); (a) phase 4's 12 requests served
   with the eager step (``_graph=False``), the graph, and the legacy loop
   (``legacy=True``), holding graph tokens to eager tokens exactly and
   legacy's to them up to top-2 gaps under 0.02 of the largest logit, the
   launch counts to the path (the graph's counted through its replays, one
   replay a decode dispatch), and printing TPOT p50/p99, TTFT p50, a live
   step's host wall and device busy time, and peak device memory each way;
   (b) phase 6's traffic paged with prefix reuse, graph and eager tokens
   equal to each other and to phase 6 (c)'s; (c) phase 7's traffic on
   mamba2-130m, graph == eager; (d) 8 requests sampled at temperature 0.8,
   top_k 50, graph == eager. Phases 4 and 6-9 serve through the graph
   too, their launch-count gates unchanged;
11. tracing, the threaded pipeline, Gateway -> ServingCluster, process
   replicas and prefix_cache routing (see :func:`cluster_path`);
12. feature payloads and the MoE layer (after 11, every earlier model
   freed): (a) pixtral-12b at published widths and depth (40 layers),
   PIX_TRAFFIC (8 photo questions carrying 256-1024 patch embeddings, 4
   plain chat turns) through the bucketed engine (feature requests on the
   exact path), the warmed engine and the disaggregated tier under each
   mechanism: launch counts, prefill counters that count prompt tokens and
   not frames, warmed and direct tokens == bucketed, HOST_STAGED's first
   tokens, handoff extents and wire bytes == those worked out by hand from
   F + S; card vs CPU on 2 layers with features; (b) grok-1-314b at
   published widths, 2 of 64 layers: card vs CPU in fp32 on 1 layer with
   the router's flipped choices counted; phase 4's traffic bucketed, eager,
   warmed, paged and packed (and bucketed and packed with nothing
   dropped): eager == warmed == bucketed, paged == bucketed or parted at a
   near tie, packed reported (its drops differ) and gated without drops;
   a graphed decode step's device time beside its byte bound, and the MoE
   layer's time split into router + plan, gather, expert products and
   combine;
13. MLA (after 12, every earlier model freed): deepseek-v2-236b
   (arXiv:2405.04434) at published widths, 3 of 60 layers (layer 0's dense
   FFN, layers 1-2 MoE with 160 experts, top-6, 2 shared), phase 4's
   traffic bucketed, eager, warmed, paged (without prefix reuse, as MLA
   runs), legacy and with packed=True, prefill_chunk=256 (both reported
   off), then the disaggregated tier under each mechanism: launch counts
   (flash 3 a prefill call, the MLA decode kernel or its paged twin 3 a
   step, rmsnorm 13 a forward), eager, warmed and packed/chunked tokens ==
   bucketed, paged == bucketed or parted at a near tie, legacy against
   bucketed reported in bf16 (its lone prefills drop other expert choices
   and round differently) and gated in fp32 without drops on 2 layers, direct
   mechanisms == bucketed, HOST_STAGED's first tokens, handoff extents and
   wire bytes == worked out by hand at 1,152 bytes a token a layer; a
   graphed step's device time, byte bound and the MLA kernel's share; the
   handoff's bytes a token against llama3-8b's and GDR's TTFT saving; card
   vs CPU in fp32 on the first 2 layers (router flips counted) and in bf16
   on layer 0;
14. the hybrid stack (run after 13): jamba-v0.1-52b (arXiv:2403.19887) at
   published widths, 8 of 32 layers (one period of its interleave: 1
   attention + MoE, 3 SSM + MoE, 4 SSM + dense; 26.0 GB), phase 4's
   traffic through the exact-shape admission eager, warmed (the graph) and
   legacy, then the tier under each mechanism: launch counts (ssd_scan 7
   and flash 1 a prefill call, rmsnorm 24 a forward, ring decode 1 a
   step), padded token-rows == prompt tokens, warmed == eager, legacy ==
   them or parted at a near tie, direct mechanisms == fused, HOST_STAGED's
   first tokens, wire bytes == worked out by hand (the attention layer's
   4,096 bytes a token, each SSM layer's 573,632 a request); a graphed
   step against its byte bound, the SSD kernel's share of a 1024-token
   prefill, the hop a pass and GDR's TTFT saving; card vs CPU in fp32
   without drops on the first 4 layers, within 1e-4 (router flips
   counted);
15. the encoder-decoder (run last): seamless-m4t-large-v2
   (arXiv:2308.11596) at full depth (24 + 24 layers, 3.55 GB) through the
   Model API (the serving engine refuses it, as JAX's has no path): 4
   utterances of 512 and of 1024 precomputed frames, a 2-token target
   prompt, 32 greedy tokens; launch counts (flash 72 a prefill: encoder,
   self and cross; the decode kernel 48 a step: ring and cross), flash's
   device time in a prefill against its bound; card vs CPU at full depth,
   fp32 within 1e-4, bf16 within 0.02;
16. training (run last): ``repro_torch.training.train`` on llama3-8b at
   full width cut to 8 of 32 layers (2.27B parameters, about 27 GB of
   bf16 weights and gradients and fp32 moments), bf16 weights from seed 0,
   ``SyntheticLM`` batches of [2, 4096] (train_4k's sequence; batch 2 of
   256), full remat, 10 AdamW steps on the launcher's schedule (lr 1e-3,
   1 warm-up step): every loss and grad norm finite, the last 3 losses'
   mean under the first, launches a step exactly flash 2L, its backward
   L, rmsnorm 4L + 1, its backward 2L + 1 and no serving kernel; step wall
   (CUDA events), tokens/s, model FLOPs (6 N T + attention) against 989
   TFLOP/s, peak memory; (c) the trained parameters (none requiring grad)
   serve 4 of phase 4's prompts through ServingEngine with its launch
   structure; one more step profiled (weight GEMMs, flash forward and
   backward, rmsnorm by kernel name; idle share) and cross-entropy, the
   embedding's backward and the AdamW update timed alone; (b) card vs
   CPU in fp32 on 2 layers and one [1, 512] batch: the loss within 1e-5,
   every gradient leaf within 1e-4 of its largest entry; (d) the same 10
   steps, gates and a profiled step for mamba2-130m (24 layers, [8,
   4096]), jamba-v0.1-52b (2 layers: SSM + dense, attention + MoE; [2,
   4096]) and deepseek-v2-236b (layer 0, [2, 4096]), launches a step from
   each config (``train_structure``), and (b)'s gate on each (mamba2's 24
   layers at [1, 500] against the CPU model in float64, jamba at [1, 256],
   deepseek-v2 at [1, 512]); (e) the same for the remaining stacks at full
   width: qwen3-32b (2 of 64 layers, [2, 4096]: qk-norm, its two rmsnorm
   launches a layer counted), starcoder2-3b (all 30 layers, [2, 4096]),
   granite-34b (2 of 88 layers, [2, 4096]: MQA), pixtral-12b (2 of 40
   layers, 1024 feature rows + 3072 tokens) and seamless-m4t-large-v2 (24
   + 24 layers, 1024 frames + [4, 1024] tokens), each held to the card by
   the launcher's ``check_fits``, 10 steps, a profiled step (the device
   traced alone) and (b)'s gate at 2 layers (TRAIN_STACK_CHECK), each
   model freed before the next;
17. the dry-run launchers (the host's CPU, the meta device, the package's
   H100 constants): ``python -m repro_torch.launch.dryrun --all`` and
   ``--all --multipod`` as two concurrent processes of 4 workers each,
   every (arch, shape) line printed, each OK but seamless-m4t's long_500k
   (JAX's stated skip), ``repro_torch.launch.report`` rendering both
   meshes' tables into chiprun_out/phase17_report.md; then the 1 x 1
   roofline of phase 16's llama3-8b step (8 layers, [2, 4096], remat full,
   AdamW) beside its measured step: max(t_compute, t_memory) must not
   exceed the measured step, its peak a device printed beside phase 16's;
18. the serving tier on a device mesh (runs after phase 9, on phase 4's
   model; see :func:`mesh_path`): (a) llama3-8b at full width, every
   layer, under ``DECODE_32K``'s rules on a 1 x 4 (data, model) mesh of
   the card -- the ring caches split 4 ways by sequence (512 of 2,048
   slots), the table 4 ways by vocab -- 32 greedy steps after phase 4's
   first 8 prompts' prefill, sharded against unsharded in bf16 (phase 4's
   weights: tokens equal or parted at a top-2 gap under 0.02, logits
   reported) and in fp32 (new weights: logits within 1e-4 of the
   largest), the decode kernel 4 x 32 a step, busy ms a step each way;
   (b) deepseek-v2-236b at 3 layers the same way through the MLA kernel
   (bf16 reported only, its MoE router's choices moving with the
   rounding; fp32 gated); (c) ``LONG_500K``'s rules on 2 x 2, batch 1,
   llama3-8b's first 8 layers over a 32,768-slot ring (8,192 a shard; a
   20,000-token prompt leaves shard 3 empty), bf16 and fp32 as (a); (d) phase
   8's traffic on the disaggregated tier on a hand-built 2-slot pod mesh
   (prefill on pod 0, decode on pod 1) and with ``placement=False``, under
   each mechanism: tokens == phase 8's, extents and wire bytes by hand,
   the hop's wall; (e) ``ServingCluster.build(mesh=...,
   pods_per_replica=...)``, fused and disaggregated, 2 replicas: tokens ==
   the cluster without a mesh. With two cards or more, (d) and (e) also
   run on the default meshes over distinct cards; on one card the phase
   prints ``devices: 1`` and the branch it ran.
   Bounds in phase 2 and phase 16's share of peak come from the package's
   ``kernel_work`` (``kernels/work.py``), ``train_step_flops`` and
   constants, read through ``launch/roofline.py``;
19. training on a device mesh (runs after phase 17; see
   :func:`mesh_train_path`): (a) phase 16's llama3-8b (8 of 32 layers,
   [2, 4096], bf16, full remat) on a 2 x 2 (data, model) mesh naming the
   card four times under ``train_4k``'s rules -- FSDP over data; heads,
   kv heads, FFN and vocab over model; the residual sequence-sharded --
   3 AdamW steps through ``train(..., shard_ctx=)``: losses falling,
   launches a computing slot's ``train_structure``, one step profiled
   beside phase 16's unsharded one (busy, idle, peak); (b) llama3-8b at
   2 layers, fp32, [2, 512], the card's sharded loss and gradients
   against the CPU's (loss 1e-5 relative, each leaf 5e-4 of its largest,
   embed 5e-3); (c) deepseek-v2's layer 0 (MLA, the flash backward at
   (192, 128) on 64 heads a slot): one bf16 step at [2, 4096], its fp32
   gate at [1, 512] as (b); (d) with two cards or more, llama3-8b's 32
   layers through the launcher's full-config branch (data = the cards),
   4 steps, the trained params' loss on the first batch below the first
   step's; on one card it prints that it needs two and runs nothing; (e)
   the other stacks on (a)'s mesh at full width, 3 steps each through
   ``train(..., shard_ctx=)``: mamba2-130m (24 layers, [8, 4096], its SSD
   scan at 12 heads a slot), jamba-v0.1-52b (2 layers, [2, 4096], SSD at
   64 heads a slot, attention + MoE), pixtral-12b (2 layers, 1024 feature
   rows ahead of 3072 tokens) and seamless-m4t-large-v2 (6 + 6 of 24 +
   24 layers, 1024 frames, 1024 tokens): the first batch's loss lower
   after training, launches a slot's ``train_structure``, the SSD
   launches by head count, a profiled step (busy, idle, host wall, peak),
   each stack's fp32 gate at 2 layers as (b);
20. the port's examples on the card (runs last): ``examples/
   serve_llm_torch.py``, ``disaggregated_prefill_torch.py`` and
   ``train_tiny_torch.py`` (50 steps) on their defaults, three processes
   started together, each exiting 0: every transport serves all 12
   requests; the direct mechanisms' tokens are 100% the fused engine's and
   the wire bytes those of the JAX tier on the same prompts
   (EXAMPLE_WIRE); the loss falls.

Numerics: fp32 references run with TF32 off; kernels are held at fp32 atol
2e-5 / bf16 atol 2e-2, rtol 1e-2, the SSD scan at fp32 atol 3e-5 / bf16
atol 5e-2, rtol 2e-2 (tests/test_kernels.py's tolerances; the kernel and
the plain version sum in different orders). The full results go to
chiprun_out/chip_smoke.json.
"""

import collections
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOLS = {"bf16": 2e-2, "fp32": 2e-5}
RTOL = 1e-2
# card vs CPU logits (phase 3): max|diff| over the largest logit
LOGIT_LIMIT = 2e-2
N_LAYERS = 32
# phase 2's paged case: max_seq 2048 in pages of 16, ragged lengths of two
# shared 1024-token prefixes plus 64-96 tokens of each row's own
PAGED_PAGES = 128
PAGED_LENS = [1088, 1092, 1097, 1101, 1105, 1110, 1115, 1120]
# phase 6's workload (loadgen.shared_prefix_schedule arguments)
PAGED_TRAFFIC = dict(n_requests=24, n_prefixes=2, prefix_len=1024,
                     suffix_len=64, zipf_a=1.1, max_new=32, seed=0)
MAIN_ARGV = ["--arch", "llama3-8b", "--max-batch", "8", "--max-seq", "2048",
             "--clients", "12", "--requests", "1", "--prompt-len", "64:1024",
             "--new-tokens", "32", "--transport", "gdr"]
# the SSD scan at mamba2-130m's widths (b=1: the exact path prefills one
# request per call); its tolerances are tests/test_kernels.py's
SSD_SHAPE = dict(nh=24, hd=64, ds=128, chunk=256)
# jamba-v0.1-52b's: 8192 / 64 = 128 heads of 64, d_state 16, phase 14's
# prompts (64-1024 tokens, one a prefill call)
JAMBA_SSD_SHAPE = dict(nh=128, hd=64, ds=16, chunk=256)
JAMBA_SSD_LENS = (1024, 881, 192, 64)
# 4 chunks of 256, phase 7's longest prompt, a ragged tail, less than one
SSD_LENS = (1024, 2048, 1000, 77)
SSD_TOLS = {"bf16": 5e-2, "fp32": 3e-5}
SSD_RTOL = 2e-2
SSM_LAYERS = 24
# phase 3b, bf16: the card's largest distance from the fp32 witness, over
# the witness's largest logit. Set from a reading on an H100 at 700 W: the
# card sat 0.077-0.135 from it, the CPU in bf16 0.095-0.140.
SSM_BF16_LIMIT = 0.2
# phase 2's preprocess path: the paper's Table II input, a batch of 8
# 640x480 RGB camera frames (uint8), normalized per channel
PP_FRAMES = (8, 480, 640, 3)
PP_BATCHES = 4
DISAGG_MODES = ("direct_hbm", "direct_dma", "host_staged")
# phase 8 (a): one pass's handoffs, (rows, ring slots), worked out by hand
# from the 12 prompt lengths (881 518 868 843 762 708 491 972 | 755 469 810
# 192): two waves of max_batch 8 (equal budgets, so a wave ends together);
# in each, one prefill per power-of-two bucket in order of first
# appearance, its rows and its longest prompt rounded up to powers of two
RING_EXTENTS = [(8, 1024), (1, 512), (2, 1024), (1, 512), (1, 256)]
# and their wire bytes a pass: 11,520 slot-rows x 131,072 B (32 layers x
# k, v x 8 heads x 128 x bf16; int8 halves it), 16 B of int32 metadata a
# row, and under HOST_STAGED one fp32 scale per k and v leaf a handoff
RING_WIRE = {"direct_hbm": 1_509_949_648, "direct_dma": 1_509_949_648,
             "host_staged": 754_974_968}
# phase 8 (c): one mamba2-130m request's conv + state rows, plus 16 bytes of
# int32 metadata
MAMBA_REQUEST_WIRE = 19_132_432
# phase 2's rmsnorm shapes: llama3-8b decode and a 1024-token prefill
# bucket (d_model 4096); mamba2-130m decode at d_model 768 and d_inner 1536,
# and its gate norm over a 2048-token prefill
# and qwen3-32b's qk-norm at head_dim 128: the queries of an 8 x 1024 prefill
# bucket ([8 * 1024 * 64 heads, 128]) and of a decode step ([8 * 64, 128]);
# jamba-v0.1-52b's gated norm at d_inner 8192 (a decode step of 8 rows, a
# 1024-token prefill) and seamless-m4t-large-v2 at d_model 1024 (a decode
# step of 4 utterances, their 4 x 1024 encoder frames)
RMSNORM_SHAPES = ((8, 4096), (8192, 4096), (8, 768), (8, 1536), (2048, 1536),
                  (524288, 128), (512, 128), (8, 8192), (1024, 8192),
                  (4, 1024), (4096, 1024))
# phase 4's prompt lengths (ClosedLoopClient i = 0..11, 64-1024 tokens);
# its first admission is the first 8 (6,043 tokens), packed into 8192 slots
# with a pad run of 2,149 after them (phase 2's packed flash row)
MAIN_LENS = [881, 518, 868, 843, 762, 708, 491, 972, 755, 469, 810, 192]
PACKED_T = 8192
# phase 4 (b): the prefill knobs served on phase 4's traffic and weights
PREFILL_WAYS = {"bucketed": {}, "packed": dict(packed=True),
                "chunked": dict(prefill_chunk=256),
                "packed_chunked": dict(packed=True, prefill_chunk=256)}
BUCKETED_PADDED = 26_624  # phase 4's padded token-rows, bucketed
# phase 9: the rest of the dense family at published widths, depth cut so
# the weights stay under about 20 GB (bf16) and the smoke in its time
DENSE_FAMILY = (("starcoder2-3b", 30), ("qwen3-32b", 16), ("granite-34b", 8))
# phase 11 (c)-(d): phase 4's prompt lengths arriving open-loop at 20
# requests a second (loadgen.poisson_schedule), 32 new tokens each
CLUSTER_TRAFFIC = dict(rate_rps=20.0, n_requests=12, prompt_lens=MAIN_LENS,
                       max_new=32, seed=0)
# phase 12 (a): pixtral-12b's multimodal chat traffic in submission order,
# (prompt tokens, feature frames), 0 frames a text-only turn: 8 photos
# (patch embeddings of 256-1024 frames, each size twice) with a question of
# 16-128 tokens among 4 plain chat turns of 64-512 tokens; 32 new tokens
PIX_TRAFFIC = [(16, 256), (64, 0), (48, 512), (80, 768), (200, 0),
               (112, 1024), (32, 256), (512, 0), (64, 512), (96, 768),
               (384, 0), (128, 1024)]
# worked out by hand: two waves of max_batch 8 (equal budgets, so a wave
# ends together); in each, the feature requests prefill one by one at
# F + S, then one call per text bucket: 5 + 3 and 3 + 1 calls; padded
# token-rows: the 8 questions' 576 tokens + 8 rows x (64 + 256 + 512 | 512)
PIX_CALLS, PIX_PADDED, PIX_PROMPT_TOKENS = 12, 11_328, 1_736
# the handoffs (rows, ring slots) in order: each feature request's F + S to
# its power of two (272, 560, 848, 1136, 288), then the text buckets (64,
# 256, 512); the second wave 576, 864, 1152, then the 384-token turn's 512
PIX_EXTENTS = [(1, 512), (1, 1024), (1, 1024), (1, 2048), (1, 512), (1, 64),
               (1, 256), (1, 512), (1, 1024), (1, 1024), (1, 2048), (1, 512)]
# 10,560 slot-rows x 163,840 B (40 layers x k, v x 8 heads x 128 x bf16;
# int8 halves it), 16 B of int32 metadata a row, and under HOST_STAGED one
# fp32 scale per k and v leaf a handoff
PIX_WIRE = {"direct_hbm": 1_730_150_592, "direct_dma": 1_730_150_592,
            "host_staged": 865_075_488}
# phase 12 (b): grok-1-314b's depth cut (about 21.3 GB of bf16 weights)
GROK_LAYERS = 2
# phase 2's MLA cases: deepseek-v2-236b's 128 heads at its published MLA
# dims; decode at max_batch 8 over 2,048 slots, ragged, ring and in pages
# of 16
MLA_HEADS = 128
MLA_LENS = [0, 1, 64, 300, 777, 1024, 1500, 2048]
# phase 13: deepseek-v2-236b cut to 3 of 60 layers (layer 0 with the dense
# FFN, layers 1-2 MoE): about 18.7 GB of bf16 weights
MLA_LAYERS = 3
# phase 13's handoffs have phase 8's extents (the same traffic, buckets and
# pool: RING_EXTENTS); a token's latent cache is 512 + 64 bf16 values a
# layer, 1,152 bytes (int8 under HOST_STAGED: 576): 11,520 slot-rows x 3
# layers, 16 B of int32 metadata a row (13 rows), and under HOST_STAGED one
# fp32 scale per ckv and krope leaf (6) a handoff (5)
MLA_TOKEN_LAYER_BYTES = 1152
MLA_WIRE = {"direct_hbm": 11_520 * 3 * 1152 + 13 * 16,
            "direct_dma": 11_520 * 3 * 1152 + 13 * 16,
            "host_staged": 11_520 * 3 * 576 + 13 * 16 + 5 * 6 * 4}
# llama3-8b's GQA cache a token and layer: k and v, 8 heads x 128, bf16
GQA_TOKEN_LAYER_BYTES = 4096
# phase 14: jamba-v0.1-52b cut to one period of its interleave, 8 of 32
# layers (1 attention + MoE, 3 SSM + MoE, 4 SSM + dense)
JAMBA_LAYERS = 8
# the attention layer's k and v a token: 8 kv heads x 128 x 2 x bf16
JAMBA_TOKEN_BYTES = 4096
# an SSM layer's handoff row: the fp32 state [128, 64, 16] (524,288 B) and
# the bf16 conv window [3, 8224] (49,344 B)
JAMBA_SSM_BYTES = 573_632
# phase 4's prompts' ring prefixes as the tier moves them (each the next
# power of two: 9 x 1024 + 2 x 512 + 256), the 7 SSM layers' rows of the
# 12 handoffs and their 4 int32 metadata rows; HOST_STAGED's wire is int8
# (half the KV, a quarter of the state, half the window) with a 4-byte
# scale for each of a handoff's 16 cache leaves
JAMBA_SLOTS = 10_496
JAMBA_WIRE = {
    "direct_hbm": JAMBA_SLOTS * JAMBA_TOKEN_BYTES + 84 * JAMBA_SSM_BYTES + 192,
    "direct_dma": JAMBA_SLOTS * JAMBA_TOKEN_BYTES + 84 * JAMBA_SSM_BYTES + 192,
    "host_staged": (JAMBA_SLOTS * JAMBA_TOKEN_BYTES // 2
                    + 84 * (524_288 // 4 + 49_344 // 2) + 192 + 12 * 16 * 4)}
# the requests' own bytes a pass: the KV of their 8,269 prompt tokens, the
# SSM layers' rows and the metadata (about 82 MB on the direct mechanisms)
JAMBA_REQUEST = 8269 * JAMBA_TOKEN_BYTES + 84 * JAMBA_SSM_BYTES + 192
JAMBA_CARD_VS_CPU_LAYERS = 4  # SSM + dense, SSM + MoE, SSM + dense, attn + MoE
FP32_LOGIT_LIMIT = 1e-4  # card vs CPU in fp32, of the largest logit
# phase 15: seamless-m4t-large-v2 at full depth, two batches of 4
# utterances (precomputed frame features), a 2-token target prompt each
SEAMLESS_BATCHES = ((4, 512), (4, 1024))
SEAMLESS_PROMPT = 2
SEAMLESS_NEW = 32
# phase 2's backward cases: flash at phase 16's training shape and the
# [8, 1024] bucket (H 32, Hkv 8, hd 128, causal), rmsnorm at phase 16's rows
# (B * S = 8192 of d_model 4096) and a decode-sized [8, 4096]
FLASH_BWD_SHAPES = ((2, 4096), (8, 1024))
# ... and at qwen3-32b's qk-norm rows (phase 16 (e): 2 x 4096 positions x 64
# query heads at D 128); then the other rows training runs narrow or wide
# (phase 16 (d), (e)): mamba2-130m's d_model and gate norm over 8 x 4096
# positions, seamless-m4t's d_model over 4 x 1024, deepseek-v2's latent
# norms (kv, q) over 2 x 4096, starcoder2-3b's d_model over 2 x 4096
RMSNORM_BWD_SHAPES = ((8192, 4096), (8, 4096), (524288, 128), (32768, 768),
                      (32768, 1536), (4096, 1024), (8192, 512), (8192, 1536),
                      (8192, 3072))
# the shapes timed in fp32 too (the others held in fp32, timed in bf16)
RMSNORM_BWD_FP32_TIMED = RMSNORM_BWD_SHAPES[:3]
# the backward's two launches by kernel name: the rows, the ordered dw sum
RMSNORM_BWD_KERNELS = {"rows": "rmsnorm_bwd", "dw": "rmsnorm_dw"}
# the flash backward at phase 16 (e)'s other shapes: (what, B, Sq, Skv, H,
# Hkv, hd, causal, dtypes). granite-34b's MQA (G = 48); seamless-m4t's
# encoder over 1024 frames, which is also its decoder's cross-attention
# from 1024 tokens to them (the training split's Sq and Skv are equal, so
# the two are one launch; Sq != Skv is held by phase 16 (e)'s fp32 gate,
# 384 tokens over 128 frames)
FLASH_BWD_STACK_CASES = (
    ("granite-34b", 2, 4096, 4096, 48, 1, 128, True, ("bf16",)),
    ("seamless encoder and cross-attention", 4, 1024, 1024, 16, 16, 64, False,
     ("bf16", "fp32")),
)
STACK_BWD_HEADS = 8  # the plain version's query heads a call at G > 1
# the flash backward at MLA's head dims (q/k 192, v 128, deepseek-v2-236b's
# 128 heads, scale 1/sqrt(192), causal): phase 16's [2, 4096], an [8, 1024]
# batch and a pad (rows and keys at or past 1000 of 1024 masked); the plain
# version runs 16 heads at a time (the heads are independent at G = 1),
# which keeps its fp32 score tensors at [2, 16, 4096, 4096]
MLA_BWD_CASES = ((2, 4096, None), (8, 1024, None), (2, 1024, 1000))
MLA_BWD_HEADS = 16
# the SSD-scan backward at phase 16's training shapes (mamba2-130m [8,
# 4096], jamba [2, 4096]) and at its edges: a ragged last chunk, a sequence
# below one chunk, strong decay (dt about 0.9 and A about -1.8: A dt near
# -2 a step, where dt A's in-chunk sums reach -100 and more)
SSD_BWD_CASES = (  # (widths, b, S, decay)
    (SSD_SHAPE, 8, 4096, "normal"), (JAMBA_SSD_SHAPE, 2, 4096, "normal"),
    (SSD_SHAPE, 1, 1000, "normal"), (JAMBA_SSD_SHAPE, 1, 881, "normal"),
    (SSD_SHAPE, 1, 40, "normal"), (JAMBA_SSD_SHAPE, 1, 40, "normal"),
    (SSD_SHAPE, 1, 1024, "strong"), (JAMBA_SSD_SHAPE, 1, 1024, "strong"))
# gradients, each held on its own: |kernel - plain| <= atol * (its largest
# |plain|) + rtol * |plain| elementwise, and |kernel - plain| <= ntol *
# |plain| in the 2-norm over the whole gradient (zeroed rows or dropped key
# tiles move it by 0.2-0.4, rounding by under 0.003); a gradient that is 0
# in exact arithmetic (dq where every row sees one key) takes its case's
# largest entry and norm instead. fp32 differs by summation order only,
# bf16 also by the kernel rounding P and dS to bf16 for its products and
# reading the bf16-rounded output O for D = rowsum(dO o O)
BWD_TOLS = {"bf16": (1e-2, 1e-2, 1e-2), "fp32": (1e-5, 1e-4, 1e-5)}
# the SSD-scan backward's launches by kernel-name key: fp32 runs chunk,
# pass, out, sum, da; bf16 runs the walk (chunk and pass in one), out, sum,
# da
SSD_BWD_KERNELS = {"chunk": "ssd_bwd_chunk", "pass": "ssd_bwd_pass",
                   "walk": "ssd_bwd_walk", "out": "ssd_bwd_out",
                   "sum": "ssd_bwd_sum", "da": "ssd_bwd_da"}
# phase 16: llama3-8b at full width cut to 8 of 32 layers (2.27B parameters,
# about 27 GB of training state at 12 bytes a parameter; the 32-layer
# model's 90 GB needs the sharding of several cards), train_4k's sequence at
# batch 2 (of 256), 10 AdamW steps on the launcher's schedule
TRAIN_LAYERS = 8
TRAIN_BATCH = (2, 4096)
TRAIN_STEPS = 10
# (b): card vs CPU, fp32, 2 layers, one [1, 512] batch: the loss within
# TRAIN_LOSS_RTOL, every gradient leaf within TRAIN_GRAD_TOL of its largest
# entry (the kernels and the CPU's plain versions sum in different orders;
# the embedding's gradient is summed with atomics on the card)
TRAIN_CHECK = dict(layers=2, batch=(1, 512))
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
SSM_ARGV = ["--arch", "mamba2-130m", "--max-batch", "8", "--max-seq", "2048",
            "--clients", "12", "--requests", "1", "--prompt-len", "64:2048",
            "--new-tokens", "32", "--transport", "gdr"]


T_START = time.perf_counter()


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
          f"orders); bounds from the H100 SXM peaks {_rl().HBM_BW:.3g} B/s, "
          f"{_rl().PEAK_FLOPS['bf16']:.3g} bf16 / "
          f"{_rl().PEAK_FLOPS['fp32']:.3g} fp32 FLOP/s")
    results["kernels"] = check_kernels(torch, ops, dev)
    print("   the decode kernels' lse output at phase 18's shard shapes:")
    results["kernels"]["lse"] = lse_cases(torch, ops, dev)
    print("   rmsnorm's launch path, host time a call at [8, 4096] bf16:")
    results["kernels"]["launch_path"] = launch_path_cost(torch, ops, dev)
    results["kernels"]["design"] = design_report(torch, build, ops, dev)
    done(t0)

    # ------------------------------------------------------------------ #
    t0 = phase("phase 3: same weights on card and CPU (llama3-8b, 2 layers)")
    results["same_weights"] = same_weights(torch, dev)
    done(t0)

    t0 = phase("phase 3b: same weights on card and CPU (mamba2-130m, 24 layers)")
    results["same_weights_ssm"] = same_weights_ssm(torch, ops, dev)
    done(t0)

    t0 = phase("phase 3c: same weights on card and CPU (the dense family, "
               "a sliding window)")
    results["same_weights_family"] = same_weights_family(torch, dev)
    done(t0)

    # ------------------------------------------------------------------ #
    t0 = phase("phase 4: main path, repro_torch.launch.serve on llama3-8b")
    results["main_path"], engine = main_path(torch, ops)
    done(t0)

    t0 = phase("phase 5: where a decode step's time goes (torch.profiler)")
    print("   replays of the captured decode graph:")
    results["decode_profile"] = decode_profile(torch, engine)
    print("   the same steps eager (the graph set aside):")
    results["decode_profile_eager"] = decode_profile(torch, engine,
                                                     graph=False)
    results["prefill_profile"] = prefill_profile(torch, engine, (8, 1024),
                                                 "flash", "flash")
    done(t0)

    t0 = phase("phase 4 (b): phase 4's traffic bucketed, packed, chunked "
               "and both")
    results["prefill_ways"] = prefill_ways(torch, ops, engine)
    done(t0)

    t0 = phase("phase 6: paged KV pool + prefix reuse on llama3-8b")
    results["paged_path"], shared = paged_path(torch, ops, engine)
    done(t0)
    llama = (engine.model, engine.params)
    del engine
    torch.cuda.empty_cache()

    t0 = phase("phase 7: the SSM path, repro_torch.launch.serve on mamba2-130m")
    results["ssm_path"], ssm_engine = ssm_path(torch, ops)
    done(t0)

    t0 = phase("phase 8: the disaggregated prefill->decode tier")
    results["disagg"] = disagg_path(torch, ops, llama, shared, ssm_engine)
    done(t0)

    t0 = phase("phase 10: the decode step as one CUDA graph")
    results["graph"] = graph_path(torch, ops, llama, shared, ssm_engine)
    done(t0)
    del ssm_engine
    torch.cuda.empty_cache()

    t0 = phase("phase 9: the dense family served packed and chunked")
    results["dense_family"] = dense_family_path(torch, ops, dev)
    done(t0)

    t0 = phase("phase 18: the serving tier on a device mesh: sequence- "
               "and vocab-sharded decode, pod placement, the cluster's slices")
    results["mesh"] = mesh_path(torch, ops, llama, results["disagg"])
    done(t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = phase("phase 11: tracing, the threaded pipeline, Gateway -> "
               "ServingCluster, process replicas, prefix_cache routing")
    results["cluster"], handoff = cluster_path(
        torch, ops, llama, shared, results["graph"]["main_graph_tokens"])
    del llama  # the process replicas build their own weights
    gc.collect()
    torch.cuda.empty_cache()
    results["cluster"]["process"] = process_path(torch, handoff)
    done(t0)
    del handoff
    gc.collect()
    torch.cuda.empty_cache()

    t0 = phase("phase 12: feature payloads (pixtral-12b) and the MoE layer "
               "(grok-1-314b)")
    print(f"   device memory held before loading: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    results["vlm"] = vlm_path(torch, ops, dev)
    print("   (a) card vs CPU, pixtral-12b at full width, 2 layers, "
          "features:")
    results["vlm"]["same_weights"] = vlm_card_vs_cpu(torch, dev)
    print("   (b) card vs CPU, grok-1-314b at full width, 1 layer, fp32:")
    results["moe_same_weights"] = moe_card_vs_cpu(torch, dev)
    results["moe"] = moe_path(torch, ops, dev)
    done(t0)

    t0 = phase("phase 13: MLA (deepseek-v2-236b): the latent cache, flash "
               "at 192/128, the MLA decode kernel, the latent handoff")
    print(f"   device memory held before loading: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    results["mla"] = mla_path(torch, ops, dev)
    print("   the legacy loop against the bucketed engine, 2 layers, fp32, "
          "no drops:")
    results["mla"]["legacy_fp32"] = mla_legacy_fp32(torch, ops, dev)
    print("   card vs CPU, deepseek-v2-236b at full width, 2 layers, fp32:")
    results["mla_same_weights"] = moe_card_vs_cpu(torch, dev,
                                                  "deepseek-v2-236b", 2)
    print("   card vs CPU, deepseek-v2-236b's layer 0 (MLA + dense FFN), "
          "bf16:")
    results["mla_same_weights_bf16"] = mla_card_vs_cpu_bf16(torch, dev)
    done(t0)

    t0 = phase("phase 14: jamba-v0.1-52b: attention + SSD + MoE in one "
               "stack, the SSD kernel at d_state 16, the mixed handoff")
    print(f"   device memory held before loading: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    results["hybrid"] = hybrid_path(torch, ops, dev)
    print(f"   card vs CPU, jamba-v0.1-52b at full width, its first "
          f"{JAMBA_CARD_VS_CPU_LAYERS} layers, fp32, no drops:")
    results["hybrid_same_weights"] = moe_card_vs_cpu(
        torch, dev, "jamba-v0.1-52b", JAMBA_CARD_VS_CPU_LAYERS, nodrop=True,
        limit=FP32_LOGIT_LIMIT)
    done(t0)

    t0 = phase("phase 15: seamless-m4t-large-v2: the encoder-decoder "
               "through the Model API")
    results["encdec"] = encdec_path(torch, ops, dev)
    results["encdec"]["same_weights"] = encdec_card_vs_cpu(torch, dev)
    done(t0)

    t0 = phase(f"phase 16: training llama3-8b at full width, {TRAIN_LAYERS} "
               f"of 32 layers, through the backward kernels")
    print(f"   device memory held before loading: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    results["train"] = train_path(torch, ops, dev)
    results["train"]["same_weights"] = train_card_vs_cpu(torch, ops, dev)
    done(t0)

    t0 = phase("phase 16 (d): training mamba2-130m, jamba-v0.1-52b and "
               "deepseek-v2-236b at full width (the SSD backward at d_state "
               "128 and 16, the flash backward at 192/128)")
    results["train_family"] = train_family_path(torch, ops, dev)
    results["train_family_same_weights"] = [
        train_card_vs_cpu(torch, ops, dev, *check)
        for check in TRAIN_FAMILY_CHECK]
    done(t0)

    t0 = phase("phase 16 (e): training qwen3-32b, starcoder2-3b, "
               "granite-34b, pixtral-12b and seamless-m4t-large-v2 at full "
               "width (qk-norm's rmsnorm backward at D 128, the flash "
               "backward at G 12 and 48, non-causal and across)")
    print(f"   device memory held before loading: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    results["train_stacks"] = train_stacks_path(torch, ops, dev)
    t1 = time.perf_counter()
    results["train_stacks_same_weights"] = [
        train_card_vs_cpu(torch, ops, dev, arch, layers, batch, changes,
                          features=features)
        for arch, layers, batch, features, changes in TRAIN_STACK_CHECK]
    print(f"   (e)'s gates: {time.perf_counter() - t1:.1f} s", flush=True)
    done(t0)

    t0 = phase("phase 17: the dry-run launchers on the meta device (H100 "
               "constants) and phase 16's step against its roofline")
    results["dryrun"] = dryrun_path(results["train"])
    done(t0)

    t0 = phase("phase 19: training on a device mesh: FSDP over data, "
               "tensor and sequence parallelism over model, the "
               "vocab-parallel loss")
    results["mesh_train"] = mesh_train_path(torch, ops, dev, results["train"],
                                            results["train_family"])
    done(t0)

    t0 = phase("phase 20: the port's examples on the card (serve_llm, "
               "disaggregated_prefill, train_tiny)")
    results["examples"] = examples_path()
    done(t0)

    # each kernel's launches come from the run of the path that carries it:
    # the ring path (phase 4) for rmsnorm/flash/ring decode, the paged path
    # with reuse (phase 6 (c)) for paged decode, the SSM path (phase 7) for
    # the SSD scan, the ops.preprocess entry point (phase 2) for preprocess
    runs = {"paged_decode_attention": results["paged_path"]["runs"]["reuse"],
            "ssd_scan": results["ssm_path"],
            "preprocess": results["kernels"]["preprocess_path"],
            "mla_decode_attention": results["mla"]["bucketed"],
            "flash_attention_bwd": results["train"],
            "rmsnorm_bwd": results["train"],
            "ssd_scan_bwd": results["train_family"]["mamba2-130m"]}
    kernel_line = []
    for k in results["kernels"]["summary"]:
        k = dict(k)
        run = runs.get(k["name"], results["main_path"])
        k["launches"] = run["launches"][k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on its path")
        kernel_line.append(k)
    results["kernel_line"] = kernel_line
    results["phase12_launches"] = {
        "pixtral": results["vlm"]["launches"],
        "grok": results["moe"]["launches"],
        "grok_paged": results["moe"]["launches_paged"]}
    results["phase13_launches"] = {
        "deepseek": results["mla"]["launches"],
        "deepseek_paged": results["mla"]["launches_paged"]}
    results["phase14_launches"] = {"jamba": results["hybrid"]["launches"]}
    results["phase16_launches"] = {
        "train": results["train"]["launches"],
        "serve": results["train"]["serve"]["launches"],
        **{arch: r["launches"] for arch, r in results["train_family"].items()},
        **{arch: r["launches"] for arch, r in results["train_stacks"].items()}}
    results["phase19_launches"] = {
        "llama3_2x2": results["mesh_train"]["a"]["launches"],
        "deepseek_layer0_2x2": results["mesh_train"]["c"]["launches"],
        **{f"{arch}_2x2": r["launches"]
           for arch, r in results["mesh_train"]["e"].items()}}
    results["phase15_launches"] = {
        k: {"prefill": v["prefill_launches"],
            "decode_step": v["decode_launches_a_step"]}
        for k, v in results["encdec"]["batches"].items()}
    results["wall_s"] = time.perf_counter() - T_START
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(f"whole run: {results['wall_s']:.1f} s")
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


def matches(key, name):
    """Whether a kernel's name holds ``key`` (a string, or any of a tuple of
    them)."""
    return any(k in name for k in ((key,) if isinstance(key, str) else key))


def device_ms(torch, fn, key, reps=20):
    """Device time per call of the kernels whose name holds ``key``, from
    torch.profiler over ``reps`` calls: the kernel alone, without the host
    launch time that CUDA events around a launch-bound call also catch.
    None when the profiler reports no device time."""
    return device_ms_split(torch, fn, {key: key}, reps)[key]


def device_ms_split(torch, fn, keys, reps=20):
    """:func:`device_ms` of each kernel key of ``keys`` (a {part: key}
    mapping) from one torch.profiler window over ``reps`` calls; a part the
    trace lacks is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for part, key in keys.items():
        us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0)
                 for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA
                 and matches(key, e.key))
        out[part] = us / reps / 1e3 if us else None
    return out


def library_ms(torch, fn, **kw):
    """Time of a PyTorch library call used as a yardstick only; None when
    this torch build cannot make the call."""
    try:
        return time_ms(torch, fn, **kw)
    except (TypeError, RuntimeError) as e:
        print(f"   (library call unavailable: {type(e).__name__}: {e})")
        return None


def compare(torch, got, want, dtype, what, tols=TOLS, rtol=RTOL):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output not finite")
    err = (got - want).abs()
    bad = err > tols[dtype] + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond "
                             f"atol {tols[dtype]} rtol {rtol}; max err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def _rl():
    """``repro_torch.launch.roofline``: the package's NVIDIA H100 SXM
    data-sheet peaks (``HBM_BW``, ``PEAK_FLOPS``; dense, and a card below
    700 W runs slower), its one count of each kernel's work
    (``kernel_work``), ``bound`` and ``train_step_flops``. Imported at first
    use: chip_ab.py points ``sys.path`` at another tree before any of the
    package loads."""
    from repro_torch.launch import roofline

    return roofline


def case_record(torch, name, dtype, shape, got, want, t_kernel, t_plain,
                t_lib, nbytes, flops, tols=TOLS, rtol=RTOL, flop_dtype=None):
    err = compare(torch, got, want, dtype, f"{name} {dtype} {shape}", tols,
                  rtol)
    return err_record(name, dtype, shape, err, t_kernel, t_plain, t_lib,
                      nbytes, flops, flop_dtype)


def err_record(name, dtype, shape, err, t_kernel, t_plain, t_lib, nbytes,
               flops, flop_dtype=None):
    """A case's record and printed line from its error against the plain
    version and its times."""
    b_ms, b_by = _rl().bound(nbytes, flops, flop_dtype or dtype)
    rec = {"name": name, "dtype": dtype, "shape": shape, "max_abs_err": err,
           "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops, "tflop_s": flops / t_kernel / 1e9,
           "gb_s": nbytes / t_kernel / 1e6, "bound_share": b_ms / t_kernel}
    print(f"   {name:16s} {dtype} {shape}: err {err:.2e}  kernel "
          f"{t_kernel:.4f} ms  plain {t_plain:.4f} ms  library "
          f"{'n/a' if t_lib is None else '%.4f ms' % t_lib}  bound "
          f"{b_ms:.4f} ms ({b_by}); {rec['tflop_s']:.1f} TFLOP/s, "
          f"{rec['gb_s']:.0f} GB/s, {rec['bound_share']:.3f} of the bound",
          flush=True)
    return rec


def alone(torch, rec, fn, key, lib_fn=None):
    """Add the device time of the kernel alone (torch.profiler; CUDA events
    around one call also catch the host's launch, which a short kernel no
    longer hides) and of the whole library call, all its kernels."""
    rec["device_ms"] = device_ms(torch, fn, key)
    rec["library_device_ms"] = (None if lib_fn is None
                                or rec["library_ms"] is None
                                else device_ms(torch, lib_fn, ""))
    print(f"   {'':16s} device time alone (torch.profiler): kernel "
          f"{rec['device_ms']} ms, library {rec['library_device_ms']} ms")


def rand(torch, shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
    return t.to({"bf16": torch.bfloat16, "fp32": torch.float32}[dtype])


# --------------------------------------------------------------------------- #
# phase 2: what the redesigned kernels launch and what they compiled to
# --------------------------------------------------------------------------- #
def ptxas_stats(log):
    """{mangled kernel name: registers, spill bytes, stack} from nvcc's
    ``-Xptxas -v`` output."""
    import re

    stats, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            stats[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stats[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            stats[name]["registers"] = int(m.group(1))
    return stats


def launch_info(torch, fn, key, tries=3):
    """The launch of the kernel whose name holds ``key`` as the profiler
    saw it: grid, block, shared memory, registers per thread (CUPTI's
    record, from a chrome trace of three calls; a trace can lack a kernel
    that ran, so up to ``tries`` traces are taken). Empty when every trace
    lacks it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
        for e in events:
            if e.get("cat") == "kernel" and key in e.get("name", ""):
                args = e.get("args", {})
                return {k: args[k] for k in ("grid", "block", "shared memory",
                                             "registers per thread")
                        if k in args}
    return {}


def hgmma_count(lib_path):
    """HGMMA (wgmma) instructions in a built library's SASS; None without
    cuobjdump."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    return sass.count("HGMMA")


def design_report(torch, build, ops, dev):
    """Phase 2's account of the kernels redesigned for Hopper at the main
    paths' bf16 shapes: flash prefill at [8, 1024, 32, 8, 128] (one
    warpgroup a 64-row q-tile, wgmma), ring decode at B=8, W=2048 (a
    cluster of CTAs a row) and the SSD scan (``ssd_design``). Grid, block,
    shared memory and registers as launched; registers and spills from
    ptxas; the cluster from the launcher's split plan; HGMMA in the flash,
    flash backward, SSD and MLA decode libraries' SASS; registers and
    spills of every instantiation of rmsnorm, the two decode kernels and
    the SSD scan; the bf16 MLA decode kernel (``mla_design``), the flash
    backward (``flash_bwd_design``) and the SSD-scan backward
    (``ssd_bwd_design``, HGMMA in its SASS too). Fails when the profiler
    records no decode launch, when the decode kernel runs one CTA a row
    there, when one of those instantiations spills or takes stack, or when
    cuobjdump finds no HGMMA."""
    from repro_torch.kernels import decode_attention as _dec

    B, H, Hkv, hd, S, W = 8, 32, 8, 128, 1024, 2048
    q = rand(torch, (B, S, H, hd), "bf16", dev, 2)
    k = rand(torch, (B, S, Hkv, hd), "bf16", dev, 3)
    v = rand(torch, (B, S, Hkv, hd), "bf16", dev, 4)
    qd = rand(torch, (B, 1, H, hd), "bf16", dev, 5)
    kd = rand(torch, (B, W, Hkv, hd), "bf16", dev, 6)
    vd = rand(torch, (B, W, Hkv, hd), "bf16", dev, 7)
    lens = torch.tensor([0, 1, 64, 300, 777, 1024, 1500, 2048],
                        dtype=torch.int32, device=dev)
    splits = _dec.num_splits(W, B * Hkv, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = {}
    for name, key, kernel, fn, cluster in (
            ("flash_attention", "flash_wgmma", "flash_wgmma_kernelILi128ELb0E",
             lambda: ops.flash_attention(q, k, v), None),
            ("decode_attention", "decode_split",
             "decode_split_kernelI13__nv_bfloat16Li128ELi4E",
             lambda: ops.decode_attention(qd, kd, vd, lens), [splits, 1, 1])):
        stats = next((st for fn_name, st in ptxas_stats(
            build.build_log.get(name, "")).items() if kernel in fn_name), {})
        rec = {"launch": launch_info(torch, fn, key), "ptxas": stats,
               "cluster": cluster}
        print(f"   {name} (bf16): launch {rec['launch']}; cluster "
              f"{cluster or 'none'}; ptxas {stats}")
        out[name] = rec
    grid = out["decode_attention"]["launch"].get("grid")
    if grid is None:
        raise AssertionError("decode kernel: the profiler recorded no launch, "
                             "so its grid was not measured")
    if splits < 2 or grid[0] != splits * Hkv:
        raise AssertionError(f"decode kernel: {splits} CTA(s) a row, launch "
                             f"{out['decode_attention']['launch']}")
    out["ssd_scan"] = ssd_design(torch, ops, dev)
    out["ssd_scan_jamba"] = ssd_design(torch, ops, dev, JAMBA_SSD_SHAPE)
    # every instantiation of the kernels rebuilt for Hopper: no spills, no
    # stack (the paged kernel's fp32 staging spilled before)
    for name in ("rmsnorm", "paged_decode_attention", "decode_attention",
                 "ssd_scan"):
        stats = ptxas_stats(build.build_log.get(name, ""))
        if not stats:
            raise AssertionError(f"{name}: no ptxas report in its build log")
        regs = sorted(st.get("registers", 0) for st in stats.values())
        spilled = {fn: st for fn, st in stats.items()
                   if st.get("spill_stores") or st.get("spill_loads")
                   or st.get("stack")}
        print(f"   {name}: {len(stats)} instantiations, {regs[0]}-{regs[-1]} "
              f"registers, {len(spilled)} with spills or stack")
        out.setdefault("ptxas", {})[name] = stats
        if spilled:
            raise AssertionError(f"{name}: spills or stack in {spilled}")
    out["mla_decode_attention"] = mla_design(torch, build, ops, dev)
    out.setdefault("ptxas", {})["mla_decode_attention"] = out[
        "mla_decode_attention"].pop("ptxas")
    out["flash_attention_bwd"] = flash_bwd_design(torch, build, ops, dev)
    out["ptxas"]["flash_attention_bwd"] = out["flash_attention_bwd"].pop(
        "ptxas")
    out["ssd_scan_bwd"] = ssd_bwd_design(torch, build, ops, dev)
    out["ptxas"]["ssd_scan_bwd"] = out["ssd_scan_bwd"].pop("ptxas")
    for name in ("flash_attention", "ssd_scan", "mla_decode_attention",
                 "flash_attention_bwd", "ssd_scan_bwd"):
        n = hgmma_count(build._lib_path(name))
        print(f"   HGMMA instructions in the {name} library's SASS: "
              f"{'cuobjdump not found' if n is None else n}")
        if n == 0:
            raise AssertionError(f"{name}: no HGMMA in its SASS")
        out[name]["hgmma_in_sass"] = n
    return out


# the flash backward's three launches (D, dK/dV, dQ) by kernel-name key
FLASH_BWD_KERNELS = (("dot", "flash_bwd_dot"),
                     ("dkdv", "flash_bwd_dkdv_wgmma"),
                     ("dq", "flash_bwd_dq_wgmma"))


def flash_bwd_design(torch, build, ops, dev):
    """The bf16 flash backward at phase 16's shape ([2, 4096], 32/8 heads
    of 128, causal) through the autograd Function: each of its three
    launches' grid, block, shared memory and registers as the profiler saw
    them; registers, spills and stack of every instantiation in its library
    (the bf16 tensor-core body and the fp32 CUDA-core body) from ptxas, and
    ptxas's performance advisories (wgmma serialized, warpgroup.arrive
    injected). Fails on spills or stack in any instantiation, or when the
    profiler records no dK/dV or dQ launch."""
    B, S = TRAIN_BATCH
    H, Hkv, hd = 32, 8, 128
    q, do = (rand(torch, (B, S, H, hd), "bf16", dev, sd) for sd in (12, 15))
    k, v = (rand(torch, (B, S, Hkv, hd), "bf16", dev, sd) for sd in (13, 14))
    qkv = [t.requires_grad_(True) for t in (q, k, v)]
    o = ops.flash_attention(*qkv, causal=True)
    run = lambda: torch.autograd.grad(o, qkv, do, retain_graph=True)  # noqa: E731
    out = {"launch": {}}
    for part, key in FLASH_BWD_KERNELS:
        out["launch"][part] = launch_info(torch, run, key)
        print(f"   flash_attention_bwd (bf16) {part}: launch "
              f"{out['launch'][part]}")
    for part in ("dkdv", "dq"):
        if not out["launch"][part].get("grid"):
            raise AssertionError(f"flash_attention_bwd: the profiler recorded "
                                 f"no {part} launch")
    log = build.build_log.get("flash_attention_bwd", "")
    stats = ptxas_stats(log)
    if not stats:
        raise AssertionError("flash_attention_bwd: no ptxas report in its "
                             "build log")
    for fn, st in sorted(stats.items()):
        print(f"   ptxas {fn[fn.find('flash_bwd'):][:56]}: {st}")
    spilled = {fn: st for fn, st in stats.items()
               if st.get("spill_stores") or st.get("spill_loads")
               or st.get("stack")}
    if spilled:
        raise AssertionError(f"flash_attention_bwd: spills or stack in "
                             f"{spilled}")
    out["wgmma_remarks"] = [line.strip() for line in log.splitlines()
                            if "(C75" in line]
    print(f"   ptxas advisories (wgmma serialized, warpgroup.arrive "
          f"injected): {out['wgmma_remarks'] or 'none'}")
    out["ptxas"] = stats
    del q, k, v, do, o, qkv, run
    torch.cuda.empty_cache()
    return out


def ctas_per_sm(launch, smem_per_sm=233472, regs_per_sm=65536,
                threads_per_sm=2048, reserved=1024):
    """CTAs of a launch one SM holds at once, from its block, registers per
    thread and shared memory as the profiler recorded them: the fewest that
    the threads, the registers (allocated 256 a warp at a time) and the
    shared memory (1 KB a CTA reserved) allow."""
    threads = math.prod(launch["block"])
    warps = -(-threads // 32)
    regs = -(-launch["registers per thread"] * 32 // 256) * 256 * warps
    smem = launch["shared memory"] + reserved
    return min(threads_per_sm // threads, regs_per_sm // regs,
               smem_per_sm // smem, 32)


def ssd_bwd_design(torch, build, ops, dev):
    """The bf16 SSD-scan backward at phase 16 (d)'s shapes (mamba2-130m's
    [8, 4096], jamba's [2, 4096]) through the autograd Function: each of its
    four launches' grid, block, shared memory and registers as the profiler
    saw them and the CTAs an SM those allow; registers, spills and stack of
    every instantiation in its library (the bf16 tensor-core body and the
    fp32 CUDA-core body) from ptxas, and ptxas's wgmma advisories. Fails on
    spills or stack in any instantiation, or when the profiler records no
    walk or output launch."""
    out = {"launch": {}}
    for label, shape, b in (("mamba2-130m", SSD_SHAPE, 8),
                            ("jamba-v0.1-52b", JAMBA_SSD_SHAPE, 2)):
        nh, hd = shape["nh"], shape["hd"]
        x, dt, A, B, C = ssd_inputs(torch, "bf16", 4096, dev, shape, b)
        dy = rand(torch, (b, 4096, nh, hd), "bf16", dev, 22)
        ins = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
        y, _ = ops.ssd_scan(*ins, chunk=shape["chunk"])
        run = lambda: torch.autograd.grad(  # noqa: E731
            y, ins, dy, retain_graph=True)
        rec = {}
        for part in ("walk", "out", "sum", "da"):
            info = launch_info(torch, run, SSD_BWD_KERNELS[part])
            if info.get("block"):
                info["ctas_per_sm"] = ctas_per_sm(info)
            rec[part] = info
            print(f"   ssd_scan_bwd (bf16) {label} [{b}, 4096] {part}: "
                  f"launch {info}")
        for part in ("walk", "out"):
            if not rec[part].get("grid"):
                raise AssertionError(f"ssd_scan_bwd {label}: the profiler "
                                     f"recorded no {part} launch")
        out["launch"][label] = rec
        del x, dt, A, B, C, dy, ins, y, run
        torch.cuda.empty_cache()
    log = build.build_log.get("ssd_scan_bwd", "")
    stats = ptxas_stats(log)
    if not stats:
        raise AssertionError("ssd_scan_bwd: no ptxas report in its build log")
    for fn, st in sorted(stats.items()):
        print(f"   ptxas {fn[fn.find('ssd_bwd'):][:60]}: {st}")
    spilled = {fn: st for fn, st in stats.items()
               if st.get("spill_stores") or st.get("spill_loads")
               or st.get("stack")}
    if spilled:
        raise AssertionError(f"ssd_scan_bwd: spills or stack in {spilled}")
    out["wgmma_remarks"] = [line.strip() for line in log.splitlines()
                            if "(C75" in line]
    print(f"   ptxas advisories (wgmma serialized, warpgroup.arrive "
          f"injected): {out['wgmma_remarks'] or 'none'}")
    out["ptxas"] = stats
    return out


def mla_inputs(torch, dev, dtype="bf16", page=16):
    """MLA decode inputs at phase 2's shape (max_batch 8, 2,048 latent
    slots, MLA_HEADS heads, MLA_LENS), the pool (pages of ``page`` in a
    shuffled order) holding the same rows, and the scale."""
    B, W, H = 8, 2048, MLA_HEADS
    q_lat = rand(torch, (B, 1, H, 512), dtype, dev, 24)
    q_rope = rand(torch, (B, 1, H, 64), dtype, dev, 25)
    ckv = rand(torch, (B, W, 512), dtype, dev, 26)
    krope = rand(torch, (B, W, 64), dtype, dev, 27)
    lens = torch.tensor(MLA_LENS, dtype=torch.int32, device=dev)
    n_pages = W // page
    perm = torch.randperm(B * n_pages, generator=torch.Generator().manual_seed(
        23)) + 1
    table = perm.reshape(B, n_pages).to(torch.int32).to(dev)
    cb = torch.zeros((B * n_pages + 1, page, 512), dtype=ckv.dtype, device=dev)
    rb = torch.zeros((B * n_pages + 1, page, 64), dtype=ckv.dtype, device=dev)
    cb[table.reshape(-1).long()] = ckv.reshape(B * n_pages, page, 512)
    rb[table.reshape(-1).long()] = krope.reshape(B * n_pages, page, 64)
    return (q_lat, q_rope, ckv, krope, lens), (cb, rb, table), 192 ** -0.5


def mla_design(torch, build, ops, dev):
    """The bf16 MLA decode kernel (wgmma) at phase 2's shape: its launch as
    the profiler saw it (grid, block, shared memory, registers), the
    launcher's cluster size and cudaOccupancyMaxActiveClusters at every
    cluster size it can launch; the device time alone, ring and paged, at
    each split count (1 to 8); registers and spills of every instantiation.
    Fails on spills or stack in a bf16 (wgmma) instantiation, or when the
    profiler records no launch."""
    from repro_torch.kernels import mla_decode_attention as _mla

    (q_lat, q_rope, ckv, krope, lens), (cb, rb, table), scale = mla_inputs(
        torch, dev)
    B, W, H = ckv.shape[0], ckv.shape[1], q_lat.shape[2]
    idx = dev.index or 0
    splits = _mla.plan(W, B, H, True, idx)
    rec = {"shape": [B, W, H, 512, 64, MLA_LENS], "splits": splits,
           "launch": launch_info(torch, lambda: ops.mla_decode_attention(
               q_lat, q_rope, ckv, krope, lens, scale=scale), "mla_decode"),
           "active_clusters": {s: _mla.max_active_clusters(s, device_index=idx)
                               for s in (1, 2, 4, 8)}}
    print(f"   mla_decode_attention (bf16): launch {rec['launch']}; cluster "
          f"[{splits}, 1, 1]; max active clusters by size "
          f"{rec['active_clusters']}")
    if not rec["launch"].get("grid"):
        raise AssertionError("MLA decode kernel: the profiler recorded no "
                             "launch, so its grid was not measured")
    rec["device_ms"] = {}
    for s in (1, 2, 4, 8):
        ring = lambda: _mla.launch(q_lat, q_rope, ckv, krope, lens,  # noqa: E731
                                   scale=scale, _splits=s)
        paged = lambda: _mla.launch_paged(  # noqa: E731
            q_lat, q_rope, cb, rb, table, lens, scale=scale, _splits=s)
        rec["device_ms"][f"splits={s}"] = {
            "ring": device_ms(torch, ring, "mla_decode"),
            "paged": device_ms(torch, paged, "mla_decode")}
        print(f"   mla_decode_attention bf16 splits={s}: device ms alone "
              f"{rec['device_ms'][f'splits={s}']}", flush=True)
    stats = ptxas_stats(build.build_log.get("mla_decode_attention", ""))
    if not stats:
        raise AssertionError("mla_decode_attention: no ptxas report in its "
                             "build log")
    rec["ptxas"] = stats
    for fn, st in stats.items():
        print(f"   mla_decode_attention {fn[60:110]}: {st}")
    spilled = {fn: st for fn, st in stats.items() if "wgmma" in fn and (
        st.get("spill_stores") or st.get("spill_loads") or st.get("stack"))}
    if spilled:
        raise AssertionError(f"mla_decode_attention: spills or stack in the "
                             f"bf16 body: {spilled}")
    return rec


def ssd_design(torch, ops, dev, shape=SSD_SHAPE):
    """The bf16 SSD scan's three launches at b=1 and 1024 and 2048
    positions (at mamba2-130m's widths, or jamba's): each launch's grid,
    block, shared memory and registers as the profiler saw it and its
    device time alone; and the device time of the whole scan at each
    heads-a-CTA choice of HEAD_GROUPS that divides the heads, beside the
    launcher's pick (the readings its rule rests on). Fails when a launch
    is missing from the trace or the grid does not run one CTA column per
    chunk of 64 positions."""
    from repro_torch.kernels import ssd_scan as _ssd

    nh, chunk = shape["nh"], shape["chunk"]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for S in (1024, 2048):
        x, dt, A, B, C = ssd_inputs(torch, "bf16", S, dev, shape)
        nc = -(-S // _ssd.CHUNK)
        pick = _ssd.heads_per_cta(nc, nh, n_sm)
        rec = {"heads_per_cta": pick, "launches": {}, "device_ms": {}}
        for key in ("ssd_scan_states", "ssd_scan_pass", "ssd_scan_out"):
            def fn():
                return ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
            rec["launches"][key] = launch_info(torch, fn, key)
            rec["device_ms"][key] = device_ms(torch, fn, key)
        rec["heads_sweep_device_ms"] = {
            g: device_ms(torch, lambda g=g: _ssd.launch(x, dt, A, B, C, chunk=chunk,
                                                         _heads=g), "ssd_scan")
            for g in _ssd.HEAD_GROUPS if nh % g == 0}
        print(f"   ssd_scan bf16 S={S} ds={shape['ds']}: {pick} heads a CTA; "
              f"launches "
              f"{rec['launches']}; device ms {rec['device_ms']}; whole scan "
              f"by heads a CTA {rec['heads_sweep_device_ms']}")
        for key in ("ssd_scan_states", "ssd_scan_out"):
            grid = rec["launches"][key].get("grid")
            if grid is None or grid[0] != nc or grid[1] != -(-nh // pick):
                raise AssertionError(f"ssd_scan bf16 S={S}: {key} launch "
                                     f"{rec['launches'][key]}, expected a grid "
                                     f"of [{nc}, {-(-nh // pick)}, 1]")
        out[S] = rec
    return out


def host_us(torch, fn, n=10_000):
    """Host microseconds a call of ``fn``: time.perf_counter over ``n``
    calls, no synchronisation inside (launches queue on the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def launch_path_cost(torch, ops, dev):
    """What each step of a call from ``ops.rmsnorm`` down to the ctypes
    call costs the host, at llama3-8b's decode shape [8, 4096] in bf16
    (host_us over 10,000 calls each; the kernel's device time is far under
    the host's, so the launch queue never fills and the reading is the
    host's)."""
    from repro_torch.kernels import rmsnorm as _rn

    x = rand(torch, (8, 4096), "bf16", dev, 0)
    w = rand(torch, (4096,), "bf16", dev, 1)
    o = torch.empty_like(x)
    idx = x.get_device()
    ops.rmsnorm(x, w)  # resolves the ctypes function
    fn = _rn._FWD._fn
    current_stream = torch._C._cuda_getCurrentRawStream
    stream = current_stream(idx)
    args = (x.data_ptr(), w.data_ptr(), o.data_ptr(), 8, 4096, 1e-5, 3)

    def unchecked(device_index, *a):
        err = fn(*a, current_stream(device_index))
        if err:
            raise RuntimeError(f"rmsnorm launch failed: cudaError {err}")

    steps = [
        ("ops.rmsnorm, the whole call", lambda: ops.rmsnorm(x, w)),
        ("ops._on_cuda(x, w)", lambda: ops._on_cuda(x, w)),
        ("shape, dtype, contiguity and size checks",
         lambda: (x.shape[-1:] != w.shape, x.dtype in ops.KERNEL_DTYPES,
                  w.dtype in ops.KERNEL_DTYPES, w.is_contiguous(),
                  x.is_contiguous(), x.numel())),
        ("rmsnorm.launch: output to ctypes call", lambda: _rn.launch(x, w, 1e-5)),
        ("torch.empty_like(x)", lambda: torch.empty_like(x)),
        ("3 x data_ptr(), get_device(), numel()",
         lambda: (x.data_ptr(), w.data_ptr(), o.data_ptr(), x.get_device(),
                  x.numel())),
        ("build.CFunction: device check, stream, ctypes call, error check",
         lambda: _rn._FWD(idx, *args)),
        ("the same without the device check (the call before it)",
         lambda: unchecked(idx, *args)),
        ("the device check alone (torch._C._cuda_getDevice)",
         lambda: torch._C._cuda_getDevice() == idx),
        ("the current stream (torch._C._cuda_getCurrentRawStream)",
         lambda: current_stream(idx)),
        ("the ctypes call alone (8 arguments, cudaLaunchKernel)",
         lambda: fn(*args, stream)),
    ]
    table = []
    for what, fn_ in steps:
        table.append({"step": what, "host_us": host_us(torch, fn_)})
        print(f"   {'':16s} {table[-1]['host_us']:7.2f} us  {what}")
    return table


LSE_SHARD_LENS = [0, 1, 64, 300, 511, 512, 0, 200]  # a 512-slot shard's


def lse_cases(torch, ops, dev):
    """Both decode kernels with their lse output at phase 18 (a)'s and
    (b)'s shard shape (8 rows over 512 slots: 2048 split 4 ways; llama3-8b's
    32 / 8 heads of 128, deepseek-v2's 128 heads at latent 512 + 64), the
    valid slots a shard sees (0: a shard past the row, 1, short, full): out
    bitwise equal with lse on and off, lse within 1e-4 of the plain
    version's (-inf exactly where no slot is valid), out within the kernel
    tolerances, and each kernel's device time alone with and without
    lse."""
    from repro_torch.kernels import ref

    B, W = 8, 512
    lens = torch.tensor(LSE_SHARD_LENS, dtype=torch.int32, device=dev)
    empty = lens == 0
    out = []
    for name in ("decode_attention", "mla_decode_attention"):
        for dtype in ("bf16", "fp32"):
            if name == "decode_attention":
                H = 32
                q = rand(torch, (B, 1, H, 128), dtype, dev, 40)
                k = rand(torch, (B, W, 8, 128), dtype, dev, 41)
                v = rand(torch, (B, W, 8, 128), dtype, dev, 42)

                def call(lse, q=q, k=k, v=v):
                    return ops.decode_attention(q, k, v, lens,
                                                return_lse=lse)

                plain = ref.decode_attention_ref(q, k, v, lens,
                                                 return_lse=True)
                key = "decode_split"
            else:
                H, scale = MLA_HEADS, 192 ** -0.5
                ql, qr, ckv, kr = (rand(torch, s, dtype, dev, 43 + i)
                                   for i, s in enumerate((
                                       (B, 1, H, 512), (B, 1, H, 64),
                                       (B, W, 512), (B, W, 64))))

                def call(lse, ql=ql, qr=qr, ckv=ckv, kr=kr):
                    return ops.mla_decode_attention(ql, qr, ckv, kr, lens,
                                                    scale=scale,
                                                    return_lse=lse)

                plain = ref.mla_decode_attention_ref(ql, qr, ckv, kr, lens,
                                                     scale=scale,
                                                     return_lse=True)
                key = "mla_decode"
            off = call(False)
            got, lse = call(True)
            torch.cuda.synchronize()
            if not torch.equal(got, off):
                raise AssertionError(f"{name} {dtype}: out differs with lse "
                                     "on and off")
            err = compare(torch, got, plain[0], dtype, f"{name} {dtype} lse")
            want = plain[1]
            if not (torch.isneginf(lse[empty]).all()
                    and torch.isneginf(want[empty]).all()
                    and not got[empty].any()):
                raise AssertionError(f"{name} {dtype}: a shard with no valid "
                                     "slot must give lse -inf and zeros")
            lse_err = float((lse[~empty] - want[~empty]).abs().max())
            if not lse_err <= 1e-4:
                raise AssertionError(f"{name} {dtype}: lse off the plain "
                                     f"version's by {lse_err:.3e}")
            ms = {flag: device_ms(torch, lambda f=flag: call(f), key)
                  for flag in (False, True)}
            rec = {"name": name, "dtype": dtype,
                   "shape": [B, W, H, LSE_SHARD_LENS], "max_abs_err": err,
                   "lse_max_abs_err": lse_err, "device_ms": ms[False],
                   "device_ms_lse": ms[True]}
            print(f"   {name:20s} {dtype} lse: out bitwise with and without; "
                  f"lse err {lse_err:.2e} (-inf on the {int(empty.sum())} "
                  f"empty rows); device ms alone {ms[False]} without, "
                  f"{ms[True]} with", flush=True)
            out.append(rec)
    return out


# --------------------------------------------------------------------------- #
# phase 2
# --------------------------------------------------------------------------- #
def check_kernels(torch, ops, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    cases = []
    # rmsnorm: llama3-8b decode ([max_batch, d]) and a 1024-token prefill
    # bucket; mamba2-130m decode at d_model and d_inner, and a 2048-token
    # prefill's gate norm
    for dtype in ("bf16", "fp32"):
        for N, D in RMSNORM_SHAPES:
            x = rand(torch, (N, D), dtype, dev, 0)
            w = rand(torch, (D,), dtype, dev, 1)
            isz = x.element_size()
            lib = None
            if hasattr(F, "rms_norm"):
                lib = library_ms(torch, lambda: F.rms_norm(x, (D,), w, 1e-5))
            flops, nbytes = _rl().kernel_work("rmsnorm", N, D, isz)
            rec = case_record(
                torch, "rmsnorm", dtype, [N, D], ops.rmsnorm(x, w),
                ref.rmsnorm_ref(x, w), time_ms(torch, lambda: ops.rmsnorm(x, w)),
                time_ms(torch, lambda: ref.rmsnorm_ref(x, w)), lib, nbytes,
                flops)
            alone(torch, rec, lambda: ops.rmsnorm(x, w), "rmsnorm",
                  lambda: F.rms_norm(x, (D,), w, 1e-5))
            cases.append(rec)

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
            pairs = None  # the causal (and window) mask's, a head
            if seg is not None:  # the segments' pairs: the data sets them
                qi = torch.arange(S, device=dev)[:, None]
                ki = torch.arange(S, device=dev)[None, :]
                mask = (qi >= ki) & (ki > qi - window) if window else qi >= ki
                pairs = int((mask[None] & (seg[:, :, None] == seg[:, None, :]))
                            .sum())
            flops, nbytes = _rl().kernel_work(
                "flash_attention", B, S, S, H, Hkv, hd, isz=q.element_size(),
                window=window, segments=seg is not None, pairs=pairs)
            lib = None
            if not segmented:
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                lib = library_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
            rec = case_record(
                torch, "flash_attention", dtype,
                [B, S, H, Hkv, hd, f"window={window}", f"segments={segmented}"],
                got, want, time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                                   reps=10),
                time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw),
                        reps=5, warmup=1),
                lib, nbytes, flops)
            alone(torch, rec, lambda: ops.flash_attention(q, k, v, **kw),
                  "flash", None if segmented else
                  lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True, enable_gqa=True))
            cases.append(rec)
            del got, want
    cases.append(packed_flash_case(torch, ops, ref, dev, cases))

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
        flops, nbytes = _rl().kernel_work("decode_attention", B, H, Hkv, hd,
                                    sum(lens_host), q.element_size())
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        amask = (torch.arange(W, device=dev)[None, :] < lens[:, None])[:, None, None]
        lib = library_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask, enable_gqa=True))
        rec = case_record(
            torch, "decode_attention", dtype, [B, W, H, Hkv, hd, lens_host],
            got, want, time_ms(torch, lambda: ops.decode_attention(q, k, v, lens)),
            time_ms(torch, lambda: ref.decode_attention_ref(q, k, v, lens)),
            lib, nbytes, flops)
        alone(torch, rec, lambda: ops.decode_attention(q, k, v, lens),
              "decode", lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, attn_mask=amask, enable_gqa=True))
        cases.append(rec)

    cases += paged_cases(torch, ops, ref, dev)
    cases += mla_cases(torch, ops, ref, dev)
    cases += ssd_cases(torch, ops, ref, dev)
    cases += ssd_cases(torch, ops, ref, dev, JAMBA_SSD_SHAPE, JAMBA_SSD_LENS)
    cases += encdec_attention_cases(torch, ops, ref, dev)
    pp_cases, pp_path = preprocess_cases(torch, ops, ref, dev)
    cases += pp_cases
    cases += backward_cases(torch, ref, dev)
    cases += stack_backward_cases(torch, ref, dev)
    cases += mla_backward_cases(torch, ref, dev)
    cases += ssd_backward_cases(torch, ref, dev)

    # the line's entry per kernel: bf16 (the serving dtype) at the shape the
    # main path launches most (decode for rmsnorm, the 1024 bucket for flash)
    pick = {"rmsnorm": [8, 4096],
            "flash_attention": [B, 1024, H, Hkv, hd, "window=0", "segments=False"],
            "decode_attention": [B, W, H, Hkv, hd, lens_host],
            "paged_decode_attention": [B, PAGED_PAGES, H, Hkv, hd, PAGED_LENS],
            "ssd_scan": [1, 1024, SSD_SHAPE["nh"], SSD_SHAPE["hd"],
                         SSD_SHAPE["ds"]],
            "preprocess": list(PP_FRAMES),
            "mla_decode_attention": [B, 2048, MLA_HEADS, 512, 64, MLA_LENS],
            "flash_attention_bwd": [*TRAIN_BATCH, H, Hkv, hd, "causal"],
            "rmsnorm_bwd": [TRAIN_BATCH[0] * TRAIN_BATCH[1], 4096],
            "ssd_scan_bwd": [8, 4096, SSD_SHAPE["nh"], SSD_SHAPE["hd"],
                             SSD_SHAPE["ds"], "normal"]}
    meta = {
        "rmsnorm": ("cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:23"),
        "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:103"),
        "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:79"),
        "paged_decode_attention": (
            "cuda", "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention.py:145"),
        "ssd_scan": ("cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:80"),
        "preprocess": ("triton", "src/repro_torch/kernels/preprocess.py",
                       "src/repro/kernels/preprocess.py:24"),
        # no Pallas kernel: it replaces the JAX model's jnp ``attend``
        "mla_decode_attention": (
            "cuda", "src/repro_torch/kernels/csrc/mla_decode_attention.cu",
            "src/repro/models/mla.py:111"),
        # no Pallas backward: JAX differentiates its jnp attention and norm
        "flash_attention_bwd": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/models/attention.py:71"),
        "rmsnorm_bwd": ("cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/models/layers.py:19"),
        # no Pallas backward: JAX differentiates its jnp ssd_chunked
        "ssd_scan_bwd": ("cuda", "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                         "src/repro/models/mamba.py:70"),
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
                        "shape": shape, "dtype": "bf16",
                        **({"device_ms": c["device_ms"]} if "device_ms" in c
                           else {})})
    return {"cases": cases, "summary": summary, "preprocess_path": pp_path}


def main_prompts(vocab):
    """Phase 4's 12 prompts (the launcher's closed-loop clients 0..11, 64 to
    1024 tokens), drawn as the clients draw them."""
    from repro_torch.serving.client import ClosedLoopClient

    prompts = [ClosedLoopClient(i, vocab, prompt_len=(64, 1024))
               .make_request().prompt_tokens for i in range(12)]
    if [len(p) for p in prompts] != MAIN_LENS:
        raise AssertionError(f"phase 4's prompt lengths moved: "
                             f"{[len(p) for p in prompts]}")
    return prompts


def packed_row(torch, lens, T, dev):
    """Segment ids [1, T] of prompts of ``lens`` packed back to back, -1 on
    the pad run after them."""
    seg = torch.full((1, T), -1, dtype=torch.int32)
    off = 0
    for j, n in enumerate(lens):
        seg[0, off:off + n] = j
        off += n
    return seg.to(dev)


def packed_flash_case(torch, ops, ref, dev, cases):
    """Flash on a packed row, bf16: phase 4's first admission (8 prompts,
    6,043 tokens) in one [1, 8192] row, llama3-8b's heads, against its
    plain version at TOLS. The bound counts the segments' own causal work
    (sum of s (s + 1) / 2 pairs a head; the pad run's pairs, which the
    kernel and the plain version also compute, are reported apart). The
    yardstick is SDPA with a boolean block-diagonal causal mask. Printed
    beside the [8, 1024] bucketed case of the same run, device time
    alone."""
    import torch.nn.functional as F

    H, Hkv, hd, T = 32, 8, 128, PACKED_T
    lens = MAIN_LENS[:8]
    q = rand(torch, (1, T, H, hd), "bf16", dev, 12)
    k = rand(torch, (1, T, Hkv, hd), "bf16", dev, 13)
    v = rand(torch, (1, T, Hkv, hd), "bf16", dev, 14)
    seg = packed_row(torch, lens, T, dev)
    starts = ops.segment_run_starts(seg)
    kw = dict(causal=True, segment_ids=seg)
    got = ops.flash_attention(q, k, v, segment_starts=starts, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    pairs = sum(n * (n + 1) // 2 for n in lens)
    pad = T - sum(lens)
    flops, nbytes = _rl().kernel_work("flash_attention", 1, T, T, H, Hkv, hd,
                                segments=True, pairs=pairs)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    i = torch.arange(T, device=dev)
    block = (seg[0][:, None] == seg[0][None, :]) & (i[:, None] >= i[None, :])

    def lib_fn():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=block,
                                              enable_gqa=True)

    rec = case_record(
        torch, "flash_attention", "bf16",
        [1, T, H, Hkv, hd, "window=0", f"packed={lens}"], got, want,
        time_ms(torch, lambda: ops.flash_attention(
            q, k, v, segment_starts=starts, **kw), reps=10),
        time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw),
                reps=3, warmup=1),
        library_ms(torch, lib_fn, reps=5), nbytes, flops)
    alone(torch, rec, lambda: ops.flash_attention(
        q, k, v, segment_starts=starts, **kw), "flash", lib_fn)
    bucket = next(c for c in cases if c["name"] == "flash_attention"
                  and c["dtype"] == "bf16" and c["shape"][:2] == [8, 1024]
                  and c["shape"][-1] == "segments=False")
    rec.update(segment_pairs_a_head=pairs, pad_tokens=pad,
               pad_pairs_a_head=pad * (pad + 1) // 2,
               bucketed_8x1024_pairs_a_head=8 * 1024 * 1025 // 2,
               bucketed_8x1024_device_ms=bucket.get("device_ms"),
               bucketed_8x1024_ms=bucket["ms"])
    if rec["device_ms"] and bucket.get("device_ms"):
        rec["device_ratio_to_bucketed"] = rec["device_ms"] / bucket["device_ms"]
    rec["tiles_a_head"] = flash_tiles(seg[0].tolist(), starts[0].tolist())
    rec["bucketed_8x1024_tiles_a_head"] = {"swept": 8 * 16 * 17 // 2,
                                           "masked": 8 * 16}
    print(f"   64 x 64 tiles a head, by the kernel's sweep rule: packed "
          f"{rec['tiles_a_head']}; bucketed [8, 1024] "
          f"{rec['bucketed_8x1024_tiles_a_head']}")
    print(f"   packed [1, {T}]: {pairs} segment pairs a head + {pad} pad "
          f"tokens ({rec['pad_pairs_a_head']} pairs); bucketed [8, 1024]: "
          f"{rec['bucketed_8x1024_pairs_a_head']} pairs. Device time "
          f"{rec['device_ms']} ms against the bucketed case's "
          f"{bucket.get('device_ms')} ms: ratio "
          f"{rec.get('device_ratio_to_bucketed')}")
    del got, want, block, qt, kt, vt
    torch.cuda.empty_cache()
    return rec


def grad_errs(torch, gots, wants, dtype, what, names):
    """Hold each gradient of one case against its plain version under
    BWD_TOLS, failing past them. Returns (the case's max |kernel - plain|,
    {name: [the largest share of the elementwise limit, the relative norm
    error]})."""
    atol, rtol, ntol = BWD_TOLS[dtype]
    wants = [w.float() for w in wants]
    top = max(float(w.abs().max()) for w in wants)
    top_norm = max(float(w.norm()) for w in wants)
    worst, shares = 0.0, {}
    for n, got, want in zip(names, gots, wants):
        got = got.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what} {n}: kernel gradient not finite")
        err = (got - want).abs()
        lim = atol * (float(want.abs().max()) or top) + rtol * want.abs()
        share = float((err / lim.clamp_min(1e-30)).max())
        rel = float(err.norm()) / (float(want.norm()) or top_norm)
        if share > 1 or rel > ntol:
            raise AssertionError(
                f"{what} {n}: {int((err > lim).sum())} elements beyond atol "
                f"{atol} x max|plain| rtol {rtol} (max err "
                f"{float(err.max()):.3e}, {share:.3f} of the limit); norm "
                f"error {rel:.3e} of the plain norm against {ntol}")
        worst = max(worst, float(err.max()))
        shares[n] = [share, rel]
    return worst, shares


def backward_cases(torch, ref, dev):
    """The two backward kernels against their plain versions (autograd
    through ``kernels/ref.py``) at phase 16's shapes and beside them, bf16
    and fp32, called as the training path calls them: ``torch.autograd.grad``
    through ``ops.flash_attention`` and ``ops.rmsnorm`` on tensors that
    require grad, so the autograd Functions' forward (flash saving its
    log-sum-exp), their argument handling and launch counts are held too.
    Also: two calls bitwise equal, the time of the backward (CUDA events)
    and of its kernels alone (torch.profiler), the bound, and one library
    call's backward as the yardstick (SDPA's, ``F.rms_norm``'s)."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, ops

    cases = []
    H, Hkv, hd = 32, 8, 128
    for dtype in ("bf16", "fp32"):
        for B, S in FLASH_BWD_SHAPES:
            q, do = (rand(torch, (B, S, H, hd), dtype, dev, sd)
                     for sd in (12, 15))
            k, v = (rand(torch, (B, S, Hkv, hd), dtype, dev, sd)
                    for sd in (13, 14))
            shape = [B, S, H, Hkv, hd, "causal"]
            qkv = [t.requires_grad_(True) for t in (q, k, v)]
            o = ops.flash_attention(*qkv, causal=True)
            with torch.no_grad():
                compare(torch, o, ref.flash_attention_ref(q, k, v, causal=True),
                        dtype, f"flash_attention_bwd {dtype} {shape} forward "
                        "(lse written)")
            cases.append(flash_bwd_record(
                torch, dtype, shape, qkv, o, do,
                lambda: ref.flash_attention_bwd_ref(q, k, v, do, causal=True)))
            del q, k, v, do, o, qkv
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        for i, (N, D) in enumerate(RMSNORM_BWD_SHAPES):
            if i == 3:
                t3 = time.perf_counter()
            rec = rmsnorm_bwd_case(torch, F, ops, ref, dev, dtype, N, D)
            if rec is not None:
                cases.append(rec)
        t1 = time.perf_counter()
        print(f"   rmsnorm_bwd {dtype} cases: {t1 - t0:.2f} s, of which the "
              f"shapes after the first three {t1 - t3:.2f} s", flush=True)

    # ptxas: no spills or stack in rmsnorm's backward (the flash backward's
    # instantiations are held in design_report's flash_bwd_design)
    for fn, st in ptxas_stats(build.build_log.get("rmsnorm", "")).items():
        if not matches(("rmsnorm_bwd", "rmsnorm_dw"), fn):
            continue
        print(f"   ptxas {fn[fn.find('rmsnorm'):][:72]}: {st}")
        if st.get("spill_stores") or st.get("spill_loads") or st.get("stack"):
            raise AssertionError(f"{fn}: spills or stack {st}")
    return cases


def rmsnorm_bwd_case(torch, F, ops, ref, dev, dtype, N, D):
    """rmsnorm's backward at [N, D] in ``dtype`` through the autograd
    Function, as training calls it: held against the plain version, two
    calls bitwise equal, one launch counted a call, the plan's geometry
    printed. Timed (CUDA events, its two launches' device time alone,
    the plain version, ``F.rms_norm``'s backward) in bf16 and at
    RMSNORM_BWD_FP32_TIMED; else None (held only)."""
    from repro_torch.kernels import rmsnorm as _rn

    x, dy = (rand(torch, (N, D), dtype, dev, sd) for sd in (16, 18))
    w = rand(torch, (D,), dtype, dev, 17)
    what = f"rmsnorm_bwd {dtype} [{N}, {D}]"
    xw = [t.requires_grad_(True) for t in (x, w)]
    y = ops.rmsnorm(*xw, eps=1e-5)
    if type(y.grad_fn).__name__ != "_RmsnormFnBackward":
        raise AssertionError(f"{what}: the forward ran outside the "
                             f"autograd Function ({y.grad_fn})")
    run = lambda: torch.autograd.grad(  # noqa: E731
        y, xw, dy, retain_graph=True)
    n0 = ops.LAUNCHES["rmsnorm_bwd"]
    got, again = run(), run()
    if ops.LAUNCHES["rmsnorm_bwd"] - n0 != 2:
        raise AssertionError(f"{what}: two backward calls counted "
                             f"{ops.LAUNCHES['rmsnorm_bwd'] - n0}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two calls differ")
    want = ref.rmsnorm_bwd_ref(x, w, dy)
    err, shares = grad_errs(torch, got, want, dtype, what, ("dx", "dw"))
    del got, again, want
    isz = x.element_size()
    plan, per_sm = _rn.plan_on(x.get_device(), N, D, isz,
                               3 if dtype == "bf16" else 0, D * isz % 16 == 0)
    geometry = {**plan._asdict(), "ctas_per_sm": per_sm}
    if dtype != "bf16" and (N, D) not in RMSNORM_BWD_FP32_TIMED:
        print(f"   {what}: err {err:.2e}, bitwise repeat, plan {geometry} "
              f"(held, not timed)", flush=True)
        return None
    xr, wr = (t.detach().clone().requires_grad_(True) for t in (x, w))
    out = F.rms_norm(xr, (D,), wr, 1e-5)
    lib_fn = lambda: torch.autograd.grad(  # noqa: E731
        out, (xr, wr), dy, retain_graph=True)
    flops, nbytes = _rl().kernel_work("rmsnorm_bwd", N, D, isz)
    rec = err_record(
        "rmsnorm_bwd", dtype, [N, D], err, time_ms(torch, run),
        time_ms(torch, lambda: ref.rmsnorm_bwd_ref(x, w, dy)),
        library_ms(torch, lib_fn), nbytes, flops)
    split = device_ms_split(torch, run, RMSNORM_BWD_KERNELS)
    rec["launch_device_ms"] = split
    rec["device_ms"] = (None if split["rows"] is None
                        else split["rows"] + (split["dw"] or 0.0))
    rec["library_device_ms"] = device_ms(torch, lib_fn, "")
    rec["device_bound_share"] = (None if rec["device_ms"] is None
                                 else rec["bound_ms"] / rec["device_ms"])
    rec["bitwise_repeat"] = True
    rec["limit_shares"] = shares
    rec["plan"] = geometry
    print(f"   {'':16s} share of the elementwise limit, norm error: "
          f"{shares}; plan {geometry}", flush=True)
    print(f"   {'':16s} device time alone (torch.profiler): kernels "
          f"{rec['device_ms']} ms (rows {split['rows']}, dw sum "
          f"{split['dw']}), {rec['device_bound_share']} of the bound; "
          f"F.rms_norm's backward {rec['library_device_ms']} ms", flush=True)
    return rec


def encdec_attention_cases(torch, ops, ref, dev):
    """Phase 2's attention cases of seamless-m4t's encoder-decoder (16
    heads of 64, G = 1), each beside SDPA (a yardstick only): flash without
    the causal mask over its encoder's 4 utterances of 1024 frames (Sq ==
    Skv) and for its cross-attention, a 2-token target prompt over the
    1024 frames (Sq != Skv); and the decode kernel over the static cross
    cache, every one of the 1024 rows valid."""
    import torch.nn.functional as F

    cases = []
    B, H, hd = 4, 16, 64
    for dtype in ("bf16", "fp32"):
        q = rand(torch, (B, 1, H, hd), dtype, dev, 43)
        k = rand(torch, (B, 1024, H, hd), dtype, dev, 44)
        v = rand(torch, (B, 1024, H, hd), dtype, dev, 45)
        full = torch.full((B,), 1024, dtype=torch.int32, device=dev)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops, nbytes = _rl().kernel_work(
            "decode_attention", B, H, H, hd, B * 1024,
            q.element_size())
        rec = case_record(
            torch, "decode_attention", dtype, [B, 1024, H, H, hd, "cross"],
            ops.decode_attention(q, k, v, full),
            ref.decode_attention_ref(q, k, v, full),
            time_ms(torch, lambda: ops.decode_attention(q, k, v, full)),
            time_ms(torch, lambda: ref.decode_attention_ref(q, k, v, full)),
            library_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt)), nbytes, flops)
        alone(torch, rec, lambda: ops.decode_attention(q, k, v, full),
              "decode", lambda: F.scaled_dot_product_attention(qt, kt, vt))
        cases.append(rec)
        for Sq, Skv in ((1024, 1024), (SEAMLESS_PROMPT, 1024)):
            q = rand(torch, (B, Sq, H, hd), dtype, dev, 40)
            k = rand(torch, (B, Skv, H, hd), dtype, dev, 41)
            v = rand(torch, (B, Skv, H, hd), dtype, dev, 42)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            flops, nbytes = _rl().kernel_work(
                "flash_attention", B, Sq, Skv, H, H,
                hd, isz=q.element_size(),
                causal=False)
            rec = case_record(
                torch, "flash_attention", dtype,
                [B, Sq, Skv, H, H, hd, "causal=False"],
                ops.flash_attention(q, k, v, causal=False),
                ref.flash_attention_ref(q, k, v, causal=False),
                time_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                           causal=False)),
                time_ms(torch, lambda: ref.flash_attention_ref(
                    q, k, v, causal=False), reps=5, warmup=1),
                library_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt)), nbytes, flops)
            alone(torch, rec, lambda: ops.flash_attention(q, k, v,
                                                          causal=False),
                  "flash", lambda: F.scaled_dot_product_attention(qt, kt, vt))
            cases.append(rec)
    return cases


def flash_tiles(seg, starts, tile=64):
    """The bf16 flash kernel's 64 x 64 tiles a head on one causal packed
    row, by its sweep rule: each q-tile from the tile holding its first
    row's run start to its diagonal. ``swept`` all of them, ``pad`` those
    of q-tiles in the pad run, ``masked`` those that take the masked route
    (not wholly below the diagonal with rows and keys in one run), and
    ``unskipped`` what a sweep from key 0 would visit."""
    T = len(seg)
    out = {"swept": 0, "pad": 0, "masked": 0, "unskipped": 0}
    for q0 in range(0, T, tile):
        run0 = starts[q0]
        one_run = run0 == starts[min(q0 + tile, T) - 1]
        n = 0
        for t0 in range(run0 // tile * tile, q0 + tile, tile):
            n += 1
            full = t0 + tile <= T and t0 + tile - 1 <= q0 and one_run \
                and t0 >= run0
            out["masked"] += not full
        out["swept"] += n
        out["pad"] += n if seg[q0] == -1 else 0
        out["unskipped"] += q0 // tile + 1
    return out


def preprocess_cases(torch, ops, ref, dev):
    """Phase 2's preprocess cases. Its path is the entry point a user calls,
    ``ops.preprocess`` (no serving path of the JAX package calls it): first
    that path, run on PP_BATCHES batches of the paper's 8 camera frames
    with the launch counts set to 0 just before and read just after; then
    the kernel against its plain version at those frames and at
    tests/test_kernels.py's shapes, in bf16 and fp32. Tolerances: bf16
    atol 1e-2 as tests/test_kernels.py; fp32 5e-7 (the kernel multiplies by
    fp32(1/255) where the plain version divides by 255). The bound counts
    N*D bytes read, N*D outputs written and 4 fp32 operations per element;
    no single PyTorch call computes the function."""
    def inputs(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randint(0, 256, shape, generator=g, device=dev,
                          dtype=torch.uint8)
        D = shape[-1]
        mean = torch.rand((D,), generator=g, device=dev) * 0.4 + 0.1
        std = torch.rand((D,), generator=g, device=dev) * 0.2 + 0.3
        return x, mean, std

    batches = [inputs(PP_FRAMES, 30 + i) for i in range(PP_BATCHES)]
    torch.cuda.synchronize()
    ops.reset_launches()
    outs = [ops.preprocess(x, m, sd) for x, m, sd in batches]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches["preprocess"] != PP_BATCHES or any(
            v for k, v in launches.items() if k != "preprocess"):
        raise AssertionError(f"preprocess path launches {launches}")
    if any(o.shape != PP_FRAMES or o.dtype != torch.bfloat16
           or not torch.isfinite(o).all() for o in outs):
        raise AssertionError("preprocess path: outputs not finite bf16 frames")
    print(f"   preprocess path: ops.preprocess on {PP_BATCHES} batches of "
          f"{PP_FRAMES} uint8 frames, launches {launches['preprocess']}")
    del outs, batches
    tols = {"bf16": 1e-2, "fp32": 5e-7}
    cases = []
    for dtype in ("bf16", "fp32"):
        tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
        for shape in (PP_FRAMES, (8, 128), (100, 512), (1000, 64)):
            x, mean, std = inputs(shape, 40)
            n = x.numel()
            flops, nbytes = _rl().kernel_work(
                "preprocess", n, shape[-1],
                torch.empty((), dtype=tdt).element_size())
            rec = case_record(
                torch, "preprocess", dtype, list(shape),
                ops.preprocess(x, mean, std, out_dtype=tdt),
                ref.preprocess_ref(x, mean, std, tdt),
                time_ms(torch, lambda: ops.preprocess(x, mean, std,
                                                      out_dtype=tdt)),
                time_ms(torch, lambda: ref.preprocess_ref(x, mean, std, tdt)),
                None, nbytes, flops, tols, RTOL, flop_dtype="fp32")
            rec["library"] = "none: no single PyTorch call computes it"
            rec["device_ms"] = device_ms(
                torch, lambda: ops.preprocess(x, mean, std, out_dtype=tdt),
                "preprocess_kernel")
            print(f"   {'':16s} device time alone (torch.profiler): "
                  f"{rec['device_ms']} ms")
            cases.append(rec)
    return cases, {"path": "ops.preprocess", "batches": PP_BATCHES,
                   "launches": launches}


def paged_inputs(torch, dtype, dev):
    """Phase 2's paged case (B 8, PAGED_PAGES pages of 16, H 32, Hkv 8, hd
    128, PAGED_LENS): q, a shuffled block pool of the main path's size where
    rows share two 1024-token prefixes (block 0 the zero sentinel), its page
    table and lengths, and the same K/V laid out densely [B, n_pages * 16,
    Hkv, hd] for the ring kernel."""
    B, H, Hkv, hd, page = 8, 32, 8, 128, 16
    n_pages = PAGED_PAGES
    N = 1 + 2 * B * n_pages  # the main path's pool: sentinel + 2 per slot
    shared = 1024 // page
    g = torch.Generator(device="cpu").manual_seed(8)
    ids = (torch.randperm(N - 1, generator=g) + 1).tolist()
    prefix = [[ids.pop() for _ in range(shared)] for _ in range(2)]
    pt = torch.zeros((B, n_pages), dtype=torch.int32)
    for b, n in enumerate(PAGED_LENS):
        row = prefix[b % 2] + [ids.pop() for _ in range(-(-n // page) - shared)]
        pt[b, :len(row)] = torch.tensor(row, dtype=torch.int32)
    pt = pt.to(dev)
    kb = rand(torch, (N, page, Hkv, hd), dtype, dev, 9)
    vb = rand(torch, (N, page, Hkv, hd), dtype, dev, 10)
    kb[0] = 0
    vb[0] = 0
    q = rand(torch, (B, 1, H, hd), dtype, dev, 11)
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    kd, vd = (blk[pt.long()].reshape(B, n_pages * page, Hkv, hd)
              for blk in (kb, vb))
    return q, kb, vb, pt, lens, kd, vd


def paged_cases(torch, ops, ref, dev):
    """Phase 2's cases of the paged path: the paged decode kernel on a
    shuffled pool where rows share two 1024-token prefixes (held against
    its plain version and, bitwise, the ring kernel on the same K/V laid
    out densely, at the launchers' split count and at one CTA a row; its
    device time alone beside the ring kernel's, and its launch), and the
    flash kernel with a 1024-token prior (held against its plain version;
    SDPA over the concatenated K/V with a boolean mask as the
    yardstick)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import paged_decode_attention as _pdec

    B, H, Hkv, hd, page = 8, 32, 8, 128, 16
    n_pages, lens_host = PAGED_PAGES, PAGED_LENS
    cases = []
    for dtype in ("bf16", "fp32"):
        q, kb, vb, pt, lens, kd, vd = paged_inputs(torch, dtype, dev)
        got = ops.paged_decode_attention(q, kb, vb, pt, lens)
        want = ref.paged_decode_attention_ref(q, kb, vb, pt, lens)
        # one template, one split plan: at the launchers' split count and at
        # one CTA a row the two kernels run the same keys through the same
        # arithmetic
        W = n_pages * page
        splits = _dec.splits_for(W, B * Hkv, dev.index or 0)
        pairs = (("the launchers' split count", got,
                  ops.decode_attention(q, kd, vd, lens)),
                 ("one CTA a row",
                  _pdec.launch(q, kb, vb, pt, lens, scale=hd ** -0.5, _splits=1),
                  _dec.launch(q, kd, vd, lens, scale=hd ** -0.5, w_real=W,
                              _splits=1)))
        for what, paged, ring in pairs:
            if not torch.equal(paged, ring):
                raise AssertionError(
                    f"paged kernel {dtype} at {what}: differs from the ring "
                    f"kernel on the same K/V by "
                    f"{float((paged.float() - ring.float()).abs().max()):.3e}")
        isz = q.element_size()
        # each input read once: the positions the rows need, shared prefix
        # blocks once (q, o and the page table besides)
        uniq = 2 * 1024 + sum(n - 1024 for n in lens_host)
        flops, nbytes = _rl().kernel_work(
            "paged_decode_attention", B, H, Hkv, hd,
            sum(lens_host), unique=uniq,
            table=pt.numel(), isz=isz)
        per_row = 2 * sum(lens_host) * Hkv * hd * isz
        rec = case_record(
            torch, "paged_decode_attention", dtype,
            [B, n_pages, H, Hkv, hd, lens_host], got, want,
            time_ms(torch, lambda: ops.paged_decode_attention(q, kb, vb, pt, lens)),
            time_ms(torch, lambda: ref.paged_decode_attention_ref(q, kb, vb, pt, lens)),
            None, nbytes, flops)
        rec["splits"] = splits
        rec["ring_kernel_bitwise_equal"] = True
        rec["ring_ms_same_kv"] = time_ms(
            torch, lambda: ops.decode_attention(q, kd, vd, lens))
        rec["bytes_read_per_row"] = per_row
        rec["library"] = "none: no single PyTorch call computes paged attention"
        print(f"   {'':16s} {splits} CTAs a row; the ring kernel on the same "
              f"K/V: bitwise equal at that split count and at 1, "
              f"{rec['ring_ms_same_kv']:.4f} ms; K/V bytes if every row read "
              f"its prefix: {per_row / 1e6:.1f} MB, unique: "
              f"{2 * uniq * Hkv * hd * isz / 1e6:.1f} MB")
        alone(torch, rec, lambda: ops.paged_decode_attention(q, kb, vb, pt, lens),
              "PagedRows")
        rec["ring_device_ms_same_kv"] = device_ms(
            torch, lambda: ops.decode_attention(q, kd, vd, lens), "RingRows")
        print(f"   {'':16s} the ring kernel's device time on the same K/V: "
              f"{rec['ring_device_ms_same_kv']} ms")
        if dtype == "bf16":
            rec["launch"] = launch_info(
                torch, lambda: ops.paged_decode_attention(q, kb, vb, pt, lens),
                "PagedRows")
            grid = rec["launch"].get("grid")
            print(f"   {'':16s} launch {rec['launch']}; cluster [{splits}, 1, 1]")
            if grid != [splits * Hkv, B, 1]:
                raise AssertionError(f"paged kernel: launch {rec['launch']}, "
                                     f"not {splits} CTAs a row")
        cases.append(rec)
        del kb, vb, kd, vd

    # flash with a prior: phase 6's suffix prefill group, one layer
    L, Pp = 64, 1024
    for dtype in ("bf16", "fp32"):
        q = rand(torch, (B, L, H, hd), dtype, dev, 12)
        k = rand(torch, (B, L, Hkv, hd), dtype, dev, 13)
        v = rand(torch, (B, L, Hkv, hd), dtype, dev, 14)
        pk = rand(torch, (B, Pp, Hkv, hd), dtype, dev, 15)
        pv = rand(torch, (B, Pp, Hkv, hd), dtype, dev, 16)
        valid = torch.full((B,), Pp, dtype=torch.int32, device=dev)
        kw = dict(causal=True, prior_k=pk, prior_v=pv, prior_valid=valid)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        flops, nbytes = _rl().kernel_work(
            "flash_attention", B, L, L, H, Hkv, hd,
            isz=q.element_size(), prior=Pp)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (torch.cat([a, b], dim=1).transpose(1, 2).contiguous()
                  for a, b in ((pk, k), (pv, v)))
        col = torch.arange(Pp + L, device=dev)[None, :]
        amask = (col < Pp) | (col - Pp <= torch.arange(L, device=dev)[:, None])
        lib = library_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask, enable_gqa=True))
        cases.append(case_record(
            torch, "flash_attention", dtype,
            [B, L, H, Hkv, hd, f"prior={Pp}"], got, want,
            time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw)),
            time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw)),
            lib, nbytes, flops))
        del q, k, v, pk, pv, kt, vt, got, want
    return cases


def mla_cases(torch, ops, ref, dev):
    """deepseek-v2-236b's attention kernels at its published dims, 128
    heads, bf16 and fp32: flash over the [8, 1024] prefill bucket at q/k
    192 (128 nope + 64 rope) and v 128, SDPA beside it; the absorbed-MLA
    decode kernel at max_batch 8 over 2,048 latent slots with MLA_LENS,
    ring and paged (pages of 16 in a shuffled pool; the paged output held
    bitwise to the ring output at one split count), SDPA over the
    concatenated 576-wide keys with a length mask beside the ring case."""
    import torch.nn.functional as F

    from repro_torch.kernels import mla_decode_attention as _mla

    cases = []
    B, S, H = 8, 1024, MLA_HEADS
    scale = 192 ** -0.5
    for dtype in ("bf16", "fp32"):
        q = rand(torch, (B, S, H, 192), dtype, dev, 20)
        k = rand(torch, (B, S, H, 192), dtype, dev, 21)
        v = rand(torch, (B, S, H, 128), dtype, dev, 22)
        kw = dict(causal=True, scale=scale)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        flops, nbytes = _rl().kernel_work(
            "flash_attention", B, S, S, H, H, 192, 128,
            q.element_size())
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  scale=scale)
        rec = case_record(
            torch, "flash_attention", dtype, [B, S, H, H, "192/128"], got,
            want, time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                          reps=10),
            time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw),
                    reps=3, warmup=1),
            library_ms(torch, sdpa, reps=10), nbytes, flops)
        alone(torch, rec, lambda: ops.flash_attention(q, k, v, **kw), "flash",
              sdpa if rec["library_ms"] is not None else None)
        cases.append(rec)
        del q, k, v, qt, kt, vt, got, want
        torch.cuda.empty_cache()

    W, page = 2048, 16
    n_pos = sum(MLA_LENS)
    n_pages = W // page
    for dtype in ("bf16", "fp32"):
        splits = _mla.plan(W, B, H, dtype == "bf16", dev.index or 0)
        (q_lat, q_rope, ckv, krope, lens), (cb, rb, table), _ = mla_inputs(
            torch, dev, dtype, page)
        flops, nbytes = _rl().kernel_work(
            "mla_decode_attention", B, H, 512, 64,
            n_pos, ckv.element_size())

        def ring():
            return ops.mla_decode_attention(q_lat, q_rope, ckv, krope, lens,
                                            scale=scale)

        def plain():
            return ref.mla_decode_attention_ref(q_lat, q_rope, ckv, krope,
                                                lens, scale=scale)
        got = ring()
        if not (got[0] == 0).all():
            raise AssertionError("MLA decode kernel: an empty slot must be "
                                 "zeros")
        qcat = torch.cat([q_lat, q_rope], -1).transpose(1, 2).contiguous()
        kcat = torch.cat([ckv, krope], -1)[:, None]
        vl = ckv[:, None]
        amask = (torch.arange(W, device=dev)[None, :]
                 < lens[:, None])[:, None, None]

        def sdpa():
            return F.scaled_dot_product_attention(
                qcat, kcat, vl, attn_mask=amask, scale=scale, enable_gqa=True)
        rec = case_record(torch, "mla_decode_attention", dtype,
                          [B, W, H, 512, 64, MLA_LENS], got, plain(),
                          time_ms(torch, ring), time_ms(torch, plain),
                          library_ms(torch, sdpa), nbytes, flops)
        alone(torch, rec, ring, "mla_decode",
              sdpa if rec["library_ms"] is not None else None)
        rec["splits"] = splits
        cases.append(rec)

        def paged():
            return ops.paged_mla_decode_attention(q_lat, q_rope, cb, rb,
                                                  table, lens, scale=scale)

        def paged_plain():
            return ref.paged_mla_decode_attention_ref(
                q_lat, q_rope, cb, rb, table, lens, scale=scale)
        pgot = paged()
        if not torch.equal(pgot, got):
            raise AssertionError(f"paged MLA decode {dtype}: not bitwise the "
                                 "ring kernel's output on the same rows")
        rec = case_record(torch, "paged_mla_decode_attention", dtype,
                          [B, n_pages, page, H, MLA_LENS], pgot, paged_plain(),
                          time_ms(torch, paged), time_ms(torch, paged_plain),
                          None, *_rl().kernel_work(
                              "paged_mla_decode_attention", B, H, 512, 64,
                              n_pos, ckv.element_size(), B * n_pages)[::-1])
        alone(torch, rec, paged, "mla_decode")
        cases.append(rec)
        print(f"   {'':16s} paged == ring bitwise; {splits} CTAs (one "
              f"cluster) a (row, "
              f"{_mla.WG_HEADS if dtype == 'bf16' else _mla.HEAD_BLOCK}-head "
              "block)")
    return cases


def ssd_inputs(torch, dtype, S, dev, shape=SSD_SHAPE, b=1, decay="normal"):
    """x, dt, A, B, C at ``shape``'s widths (mamba2-130m's, or jamba's
    JAMBA_SSD_SHAPE) and ``b`` rows: x, B and C strided views of one
    conv-output tensor [b, S, nh hd + 2 ds], dt and A fp32 (``decay``
    "strong": dt about 0.9 and A about -1.8 instead of 0.09 and -0.9)."""
    nh, hd, ds = (shape[k] for k in ("nh", "hd", "ds"))
    xBC = rand(torch, (b, S, nh * hd + 2 * ds), dtype, dev, 20)
    x = xBC[..., :nh * hd].reshape(b, S, nh, hd)
    B = xBC[..., nh * hd:nh * hd + ds].reshape(b, S, 1, ds)
    C = xBC[..., nh * hd + ds:].reshape(b, S, 1, ds)
    g = torch.Generator(device=dev).manual_seed(21)
    dt = torch.randn((b, S, nh), generator=g, device=dev).abs()
    A = -torch.randn((nh,), generator=g, device=dev).abs()
    if decay == "strong":
        return x, dt * 0.5 + 0.5, A - 1.0, B, C
    return x, dt * 0.1 + 0.01, A - 0.1, B, C


def ssd_cases(torch, ops, ref, dev, shape=SSD_SHAPE, lens=SSD_LENS):
    """Phase 2's SSD-scan cases at mamba2-130m's widths (and at jamba's,
    d_state 16 over 128 heads) and b=1, with x, B
    and C read as the model reads them (strided views of one conv-output
    row) and dt, A in fp32; y and the final state are each held against
    the plain version. On bf16 inputs the kernels carry their fp32
    operands as bf16 hi/lo pairs and round y once, while the plain version
    rounds its C.B^T and then its scores to bf16 as the JAX model's
    ssd_chunked does: the oracle is the plain version run in fp32 on the
    same input values, and the gap to the bf16 plain version is reported
    beside it. Each case also records the scan's device time alone (all
    its launches)."""
    nh, hd, ds, chunk = (shape[k] for k in ("nh", "hd", "ds", "chunk"))
    cases = []
    for dtype in ("bf16", "fp32"):
        for S in lens:
            x, dt, A, B, C = ssd_inputs(torch, dtype, S, dev, shape)
            y, st = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
            want_y, want_st = ref.ssd_scan_ref(x.float(), dt, A, B.float(),
                                               C.float(), chunk)
            plain_y, _ = ref.ssd_scan_ref(x, dt, A, B, C, chunk)
            gap_plain = float((y.float() - plain_y.float()).abs().max())
            what = f"ssd_scan {dtype} S={S}"
            err_st = compare(torch, st, want_st, dtype, what + " state",
                             SSD_TOLS, SSD_RTOL)
            flops, nbytes = _rl().kernel_work(
                "ssd_scan", 1, S, nh, hd, ds, chunk,
                x.element_size())
            rec = case_record(
                torch, "ssd_scan", dtype, [1, S, nh, hd, ds], y, want_y,
                time_ms(torch, lambda: ops.ssd_scan(x, dt, A, B, C, chunk=chunk)),
                time_ms(torch, lambda: ref.ssd_scan_ref(x, dt, A, B, C, chunk),
                        reps=5, warmup=1),
                None, nbytes, flops, SSD_TOLS, SSD_RTOL)
            alone(torch, rec, lambda: ops.ssd_scan(x, dt, A, B, C, chunk=chunk),
                  "ssd_scan")
            rec["state_max_abs_err"] = err_st
            rec["max_abs_diff_vs_plain_in_dtype"] = gap_plain
            rec["library"] = "none: no single PyTorch call computes the SSD scan"
            print(f"   {'':16s} state err {err_st:.2e}; vs the plain "
                  f"version in {dtype} {gap_plain:.2e}")
            if dtype == "fp32" and S == max(lens):
                rec["vs_float64"] = ssd_float64_gap(torch, x, dt, A, B, C, y,
                                                    want_y)
            cases.append(rec)
    return cases


def ssd_float64_gap(torch, x, dt, A, B, C, y, plain_y, h=0):
    """The fp32 kernel's and the fp32 plain version's largest distance from
    the SSD recurrence run position by position in float64 (h_t = exp(dt_t
    A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t), on head ``h``: which side
    of a kernel-vs-plain gap is off. The kernel must sit within the fp32
    SSD tolerance of it."""
    xd, dtd, Bd, Cd = (t[0].double() for t in (x, dt, B, C))
    a = float(A[h])
    state = torch.zeros((x.shape[3], B.shape[3]), dtype=torch.float64,
                        device=x.device)
    ys = []
    for t in range(x.shape[1]):
        state = (state * torch.exp(dtd[t, h] * a)
                 + dtd[t, h] * xd[t, h][:, None] * Bd[t, 0][None, :])
        ys.append(state @ Cd[t, 0])
    y64 = torch.stack(ys)
    res = {"head": h, "kernel": float((y[0, :, h].double() - y64).abs().max()),
           "plain": float((plain_y[0, :, h].double() - y64).abs().max()),
           "max_abs_y": float(y64.abs().max())}
    print(f"   {'':16s} vs a float64 recurrence (head {h}, |y| up to "
          f"{res['max_abs_y']:.3g}): kernel {res['kernel']:.3e}, plain "
          f"{res['plain']:.3e}")
    if res["kernel"] > SSD_TOLS["fp32"]:
        raise AssertionError(f"fp32 SSD kernel {res['kernel']:.3e} from the "
                             f"float64 recurrence > {SSD_TOLS['fp32']}")
    return res


def ssd_bwd_cost(b, S, nh, hd, ds, isz, L=64):
    """(bytes, FLOPs, how) of the SSD scan's backward: x, dy, B, C (``isz``
    bytes), dt and A (fp32) read once; dx, dB, dC, ddt and dA written once.
    The operations the gradient needs per chunk of L positions (the
    kernel's chunk): the causal half of C.B^T once (one B/C group); per
    head the causal halves of dy.x'^T, (C.B^T)^T dy, W^T C and W B, and the
    state products -- the chunk's state contribution (not for the last
    chunk: the final state takes no gradient), its part of the entering
    state's gradient (not for the first: nothing enters it), G'B^T and
    x'^T G' (not for the last: G' is 0 there), dy^T H (not for the first: H
    is 0 there)."""
    flops, nbytes = _rl().kernel_work("ssd_scan_bwd", b, S, nh, hd, ds, isz, L)
    how = (f"bytes: x, dy, dx ({isz} B), B, C, dB, dC ({isz} B), dt, ddt, A, "
           f"dA (fp32) once; FLOPs: per {L}-position chunk the causal C.B^T "
           f"once, per head 4 causal products over hd and ds and the state "
           f"products each chunk needs")
    return nbytes, flops, how


def ssd_backward_cases(torch, ref, dev):
    """The SSD-scan backward kernel against its plain version at
    SSD_BWD_CASES, bf16 and fp32, called as the training path calls it:
    ``torch.autograd.grad`` through ``ops.ssd_scan`` on inputs that require
    grad (x, B and C strided views of one conv output, as the model reads
    them), so the autograd Function's forward, saved inputs and launch
    count are held too. The oracle: the plain version run in fp32 on bf16
    inputs (the kernel rounds nothing but its outputs) and in float64 on
    fp32 inputs -- the fp32 plain version sums dt A's in-chunk prefix in
    fp32 (the kernel in fp64), and under strong decay its own dA comes
    within reach of the fp32 rule's 1e-5 of the largest entry; its gap to
    the float64 oracle is reported beside each case. Also: two
    calls bitwise equal, the backward's time (CUDA events), its kernels'
    device time together and each launch's alone (torch.profiler),
    the launcher's scratch bytes, the bound by bytes and by operations, the
    plain version's time (no PyTorch call computes it). Its launches'
    shapes and every instantiation's ptxas report are held in
    ``ssd_bwd_design``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as _ssd

    cases = []
    names = ("dx", "ddt", "dA", "dB", "dC")
    for dtype in ("bf16", "fp32"):
        for shape, b, S, decay in SSD_BWD_CASES:
            nh, hd, ds = (shape[k] for k in ("nh", "hd", "ds"))
            x, dt, A, B, C = ssd_inputs(torch, dtype, S, dev, shape, b, decay)
            dy = rand(torch, (b, S, nh, hd), dtype, dev, 22)
            ins = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
            what = f"ssd_scan_bwd {dtype} [{b}, {S}, {nh}, {hd}, {ds}] {decay}"
            y, _ = ops.ssd_scan(*ins, chunk=shape["chunk"])
            if type(y.grad_fn).__name__ != "_SsdScanFnBackward":
                raise AssertionError(f"{what}: the forward ran outside the "
                                     f"autograd Function ({y.grad_fn})")
            run = lambda: torch.autograd.grad(  # noqa: E731
                y, ins, dy, retain_graph=True)
            n0 = ops.LAUNCHES["ssd_scan_bwd"]
            got, again = run(), run()
            if ops.LAUNCHES["ssd_scan_bwd"] - n0 != 2:
                raise AssertionError(f"{what}: two backward calls counted "
                                     f"{ops.LAUNCHES['ssd_scan_bwd'] - n0}")
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"{what}: two calls differ")
            plain = lambda: ref.ssd_scan_bwd_ref(  # noqa: E731
                x, dt, A, B, C, dy, _ssd.BWD_CHUNK)
            if dtype == "fp32":
                want = ref.ssd_scan_bwd_ref(x, dt, A, B, C, dy, _ssd.BWD_CHUNK,
                                            compute=torch.float64)
                fp32_plain = plain()
                plain_gap = {n: float((p - w).abs().max() / w.abs().max())
                             for n, p, w in zip(names, fp32_plain, want)}
                del fp32_plain
            else:
                want, plain_gap = plain(), None
            err, shares = grad_errs(torch, got, want, dtype, what, names)
            del got, again, want
            nbytes, flops, how = ssd_bwd_cost(b, S, nh, hd, ds,
                                              x.element_size())
            rec = err_record(
                "ssd_scan_bwd", dtype, [b, S, nh, hd, ds, decay], err,
                time_ms(torch, run, reps=5, warmup=2),
                time_ms(torch, plain, reps=3, warmup=1), None, nbytes, flops)
            rec["device_ms"] = device_ms(torch, run, "ssd_bwd", reps=5)
            rec["launch_device_ms"] = device_ms_split(torch, run,
                                                      SSD_BWD_KERNELS, reps=5)
            rec["scratch_bytes"] = _ssd.bwd_scratch_bytes(
                b, S, nh, hd, ds, dtype, torch.cuda.get_device_properties(
                    dev).multi_processor_count)
            rec["bound_bytes_ms"] = nbytes / _rl().HBM_BW * 1e3
            rec["bound_ops_ms"] = flops / _rl().PEAK_FLOPS[dtype] * 1e3
            rec["bound_counted"] = how
            rec["library"] = "none: no single PyTorch call computes it"
            rec["bitwise_repeat"] = True
            rec["limit_shares"] = shares
            rec["fp32_plain_vs_float64"] = plain_gap
            print(f"   {'':16s} share of the elementwise limit, norm error: "
                  f"{shares}", flush=True)
            print(f"   {'':16s} device time alone (torch.profiler): kernels "
                  f"{rec['device_ms']} ms, by launch {rec['launch_device_ms']}; "
                  f"scratch {rec['scratch_bytes'] / 1e6:.1f} MB; bound by bytes "
                  f"{rec['bound_bytes_ms']:.4f} ms, by operations "
                  f"{rec['bound_ops_ms']:.4f} ms ({how}); library: none"
                  + ("" if plain_gap is None else
                     f"; the fp32 plain version against float64 (of each "
                     f"gradient's largest): "
                     + ", ".join(f"{n} {v:.1e}" for n, v in plain_gap.items())),
                  flush=True)
            cases.append(rec)
            del x, dt, A, B, C, dy, ins, y, run, plain
            torch.cuda.empty_cache()
    return cases


def chunked_flash_bwd_ref(torch, ref, q, k, v, do, heads, **kw):
    """The plain flash backward on ``heads`` query heads a call, for
    ``heads`` a divisor or a multiple of G = H / Hkv (each call reads the kv
    heads its query heads share), in fp32 (as the plain version computes):
    dq concatenated, each kv head's dk and dv summed over its calls, each
    gradient rounded to the inputs' dtype once, at the end."""
    H, Hkv = q.shape[2], k.shape[2]
    G = H // Hkv
    if G % heads and heads % G:
        raise ValueError(f"{heads} heads a call split groups of {G}")
    q32, k32, v32, do32 = (t.detach().float() for t in (q, k, v, do))
    dq, dk, dv = [], torch.zeros_like(k32), torch.zeros_like(v32)
    for h in range(0, H, heads):
        kv = slice(h // G, (h + heads - 1) // G + 1)
        gq, gk, gv = ref.flash_attention_bwd_ref(
            q32[:, :, h:h + heads], k32[:, :, kv], v32[:, :, kv],
            do32[:, :, h:h + heads], **kw)
        dq.append(gq)
        dk[:, :, kv] += gk
        dv[:, :, kv] += gv
    return [g.to(t.dtype) for g, t in zip((torch.cat(dq, dim=2), dk, dv),
                                          (q, k, v))]


def flash_bwd_record(torch, dtype, shape, qkv, o, do, plain, what=None,
                     causal=True, scale=None, real=None, reps=(3, 5)):
    """One flash-backward case, as the training path calls the kernel:
    ``o`` the output of ``ops.flash_attention`` on ``qkv`` (tensors that
    require grad; ``causal``, ``scale``, rows and keys at or past ``real``
    masked), so it must carry the autograd Function; two
    ``torch.autograd.grad`` calls, counted once each and bitwise equal,
    held to ``plain()`` (the plain version's (dq, dk, dv)) under
    BWD_TOLS; CUDA-event and device times, the bound from ``kernel_work``
    and, where nothing is masked, SDPA's backward beside it (``enable_gqa``
    where G > 1). ``reps``: the plain version's and the library's timed
    calls. Returns the record."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    q, k, v = qkv
    B, Sq, H, hd = q.shape
    Skv, Hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    label = f"flash_attention_bwd {dtype} {shape}" + (f" ({what})" if what
                                                      else "")
    if type(o.grad_fn).__name__ != "_FlashFnBackward":
        raise AssertionError(f"{label}: the forward ran outside the "
                             f"autograd Function ({o.grad_fn})")
    run = lambda: torch.autograd.grad(o, qkv, do,  # noqa: E731
                                      retain_graph=True)
    n0 = ops.LAUNCHES["flash_attention_bwd"]
    got, again = run(), run()
    if ops.LAUNCHES["flash_attention_bwd"] - n0 != 2:
        raise AssertionError(f"{label}: two backward calls counted "
                             f"{ops.LAUNCHES['flash_attention_bwd'] - n0}")
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"{label}: two calls differ")
    err, shares = grad_errs(torch, got, plain(), dtype, label,
                            ("dq", "dk", "dv"))
    del got, again
    plain_reps, lib_reps = reps
    lib_fn, t_lib = None, None
    if real is None:
        qt, kt, vt = (t.detach().transpose(1, 2).contiguous()
                      .requires_grad_(True) for t in qkv)
        dot = do.transpose(1, 2).contiguous()
        gqa = {"enable_gqa": True} if H != Hkv else {}
        try:
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 scale=scale, **gqa)
            lib_fn = lambda: torch.autograd.grad(  # noqa: E731
                out, (qt, kt, vt), dot, retain_graph=True)
            t_lib = library_ms(torch, lib_fn, reps=lib_reps, warmup=1)
        except (TypeError, RuntimeError) as e:
            print(f"   (library call unavailable: {type(e).__name__}: "
                  f"{str(e)[:120]})")
            lib_fn = None
    flops, nbytes = _rl().kernel_work(
        "flash_attention_bwd", B, Sq, H, Hkv, hd, hdv, q.element_size(),
        real=real, Skv=Skv, causal=causal)
    rec = err_record(
        "flash_attention_bwd", dtype, shape, err,
        time_ms(torch, run, reps=5, warmup=2),
        time_ms(torch, plain, reps=plain_reps, warmup=1), t_lib, nbytes,
        flops)
    if what:
        rec["what"] = what
    rec["device_ms"] = device_ms(torch, run, "flash_bwd", reps=5)
    rec["library_device_ms"] = (None if t_lib is None else
                                device_ms(torch, lib_fn, "", reps=lib_reps))
    rec["bound_bytes_ms"] = nbytes / _rl().HBM_BW * 1e3
    rec["bound_ops_ms"] = flops / _rl().PEAK_FLOPS[dtype] * 1e3
    rec["bitwise_repeat"] = True
    rec["limit_shares"] = shares
    print(f"   {'':16s} share of the elementwise limit, norm error: "
          f"{shares}", flush=True)
    print(f"   {'':16s} device time alone (torch.profiler): kernels "
          f"{rec['device_ms']} ms, SDPA's backward "
          f"{rec['library_device_ms']} ms; bound by bytes "
          f"{rec['bound_bytes_ms']:.4f} ms (q, k, v, o, do, dq, dk, dv, lse "
          f"once), by operations {rec['bound_ops_ms']:.4f} ms (S, dP, dV, "
          f"dK, dQ over the pairs of the real rows)", flush=True)
    return rec


def stack_backward_cases(torch, ref, dev):
    """The flash backward at FLASH_BWD_STACK_CASES (phase 16 (e)'s shapes)
    against its plain version (:func:`flash_bwd_record`), STACK_BWD_HEADS
    query heads a call of it where G > 1."""
    from repro_torch.kernels import ops

    cases = []
    for what, B, Sq, Skv, H, Hkv, hd, causal, dtypes in FLASH_BWD_STACK_CASES:
        for dtype in dtypes:
            q, do = (rand(torch, (B, Sq, H, hd), dtype, dev, sd)
                     for sd in (40, 43))
            k, v = (rand(torch, (B, Skv, Hkv, hd), dtype, dev, sd)
                    for sd in (41, 42))
            shape = ([B, Sq] + ([Skv] if Skv != Sq else [])
                     + [H, Hkv, hd, "causal" if causal else "non-causal"])
            qkv = [t.requires_grad_(True) for t in (q, k, v)]
            o = ops.flash_attention(*qkv, causal=causal)
            heads = H if H == Hkv else STACK_BWD_HEADS
            plain = lambda: chunked_flash_bwd_ref(  # noqa: E731
                torch, ref, q, k, v, do, heads, causal=causal)
            cases.append(flash_bwd_record(torch, dtype, shape, qkv, o, do,
                                          plain, what, causal=causal))
            del q, k, v, do, o, qkv, plain
            torch.cuda.empty_cache()
    return cases


def mla_backward_cases(torch, ref, dev):
    """The flash backward at MLA's head dims (192, 128) against its plain
    version (MLA_BWD_HEADS heads a call of it) at MLA_BWD_CASES, bf16 and
    fp32, through ``torch.autograd.grad`` of ``ops.flash_attention`` (the
    autograd Function, as deepseek-v2's training calls it), as
    :func:`flash_bwd_record` holds a case."""
    from repro_torch.kernels import ops

    cases = []
    H, hd, hdv = MLA_HEADS, 192, 128
    scale = 1.0 / math.sqrt(hd)
    for dtype in ("bf16", "fp32"):
        for B, S, real in MLA_BWD_CASES:
            q, k = (rand(torch, (B, S, H, hd), dtype, dev, sd) for sd in (30, 31))
            v, do = (rand(torch, (B, S, H, hdv), dtype, dev, sd)
                     for sd in (32, 33))
            kw = dict(causal=True, scale=scale, sq_real=real, skv_real=real)
            shape = [B, S, H, hd, hdv, "causal"] + ([f"pad {real}"] if real
                                                    else [])
            qkv = [t.requires_grad_(True) for t in (q, k, v)]
            o = ops.flash_attention(*qkv, **kw)
            plain = lambda: chunked_flash_bwd_ref(  # noqa: E731
                torch, ref, q, k, v, do, MLA_BWD_HEADS, **kw)
            cases.append(flash_bwd_record(
                torch, dtype, shape, qkv, o, do, plain, scale=scale,
                real=real, reps=(2, 3)))
            del q, k, v, do, o, qkv, plain
            torch.cuda.empty_cache()
    return cases


# --------------------------------------------------------------------------- #
# phase 3
# --------------------------------------------------------------------------- #
def walk_logits(torch, dev, gpu, params, cpu, params_cpu, first_g, first_c,
                K, gate=True, witness=None, witness_limit=None,
                limit=LOGIT_LIMIT):
    """From each side's prefill result (logits, caches, lengths), K decode
    steps on both sides, each fed the card's greedy token, so each step
    compares logits on the same context (a parted token cannot grow into
    a new sequence). Logits are compared over the true vocabulary (the
    padded columns hold the -1e9 mask). Returns max|diff| / max|logit| per
    step, the greedy agreement and, where the tokens part, the CPU's top-2
    gap, its margin over the card's token and the row's largest logit
    difference; with ``gate`` a ratio above ``limit`` (0.02) fails.

    ``witness`` is a third side on the CPU, (model, params, prefill result),
    fed the same tokens: the same weights in fp32. Each step then also
    gives the card's and the CPU's distance from it, over the witness's
    largest logit; a card distance above ``witness_limit`` fails."""
    (lg_g, c_g, n_g), (lg_c, c_c, n_c) = first_g, first_c
    if witness is not None:
        wit, params_w, (lg_w, c_w, n_w) = witness
    V = gpu.cfg.vocab_size
    rows = lg_c.shape[0]
    rel, agree, total, misses = [], 0, 0, []
    wit_card, wit_cpu = [], []
    for step in range(K + 1):
        if not torch.isfinite(lg_g).all():
            raise AssertionError(f"card logits not finite at step {step}")
        a, b = lg_g[:, :V].float().cpu(), lg_c[:, :V].float()
        rel.append(float((a - b).abs().max() / b.abs().max()))
        if witness is not None:
            w = lg_w[:, :V].float()
            wit_card.append(float((a - w).abs().max() / w.abs().max()))
            wit_cpu.append(float((b - w).abs().max() / w.abs().max()))
        nxt, nxt_c = a.argmax(-1), b.argmax(-1)
        agree += int((nxt == nxt_c).sum())
        total += rows
        for r in (nxt != nxt_c).nonzero().flatten().tolist():
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
        tok = nxt.to(torch.int32)[:, None]
        lg_g, c_g, n_g = gpu.decode_step(params, c_g, tok.to(dev), n_g)
        lg_c, c_c, n_c = cpu.decode_step(params_cpu, c_c, tok, n_c)
        if witness is not None:
            lg_w, c_w, n_w = wit.decode_step(params_w, c_w, tok, n_w)
    worst = max(rel)
    print(f"   max|logit diff| / max|logit| per step: "
          f"{', '.join('%.2e' % r for r in rel)}; greedy agreement "
          f"{agree}/{total}{'' if gate else ' (reported, not gated)'}")
    if gate and worst > limit:
        raise AssertionError(f"card vs CPU logits differ by {worst:.3e} > {limit} "
                             "of the largest logit")
    res = {"rel_err_per_step": rel, "greedy_agree": agree,
           "greedy_total": total, "greedy_misses": misses,
           "tolerance": limit if gate else None}
    if witness is not None:
        print(f"   distance from the fp32 witness per step, card: "
              f"{', '.join('%.2e' % r for r in wit_card)}; CPU: "
              f"{', '.join('%.2e' % r for r in wit_cpu)} (card limit "
              f"{witness_limit})")
        res.update(card_vs_fp32_per_step=wit_card, cpu_vs_fp32_per_step=wit_cpu,
                   card_vs_fp32_limit=witness_limit)
        if max(wit_card) > witness_limit:
            raise AssertionError(
                f"card logits sit {max(wit_card):.3e} from the fp32 witness "
                f"> {witness_limit} of its largest logit (the CPU in the "
                f"same dtype: {max(wit_cpu):.3e})")
    return res


def same_weights(torch, dev):
    """Phase 3: decode steps walk a ring cache of the main path's max_seq,
    2048 slots, so the card's ring decode kernel splits each row over a
    cluster of CTAs (fails if it would not) and the merge of the splits is
    held against the CPU's plain decode. Rows of 300 and 512 prompt tokens
    give 2-3 tiles to each of 5-6 CTAs, a summation order that the unsplit
    kernel does not share."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.models import Model
    from repro_torch.models.kvcache import grow_cache
    from repro_torch.models.schema import tree_map

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    gpu = Model(cfg, device=dev)
    params = gpu.init(torch.Generator(device=dev).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    lens = [17, 512, 300, 9]
    L, K, W = 512, 4, 2048
    g = torch.Generator().manual_seed(1)
    toks = torch.zeros((len(lens), L), dtype=torch.int32)
    for i, s in enumerate(lens):
        toks[i, :s] = torch.randint(0, cfg.vocab_size, (s,), generator=g)
    lens_t = torch.tensor(lens, dtype=torch.int32)

    lg_g, c_g, n_g = gpu.prefill_bucketed(params, toks.to(dev), lens_t.to(dev))
    lg_c, c_c, n_c = cpu.prefill_bucketed(params_cpu, toks, lens_t)
    c_g, c_c = grow_cache(c_g, W), grow_cache(c_c, W)
    splits = _dec.num_splits(W, len(lens) * cfg.n_kv_heads,
                             torch.cuda.get_device_properties(
                                 dev).multi_processor_count)
    print(f"   ring cache of {W} slots: the decode kernel runs {splits} CTAs a row")
    if splits < 2:
        raise AssertionError(f"phase 3's decode runs {splits} CTA a row: the "
                             "split kernel is not held against the CPU")
    res = walk_logits(torch, dev, gpu, params, cpu, params_cpu,
                      (lg_g, c_g, n_g), (lg_c, c_c, n_c), K)
    res["ring_slots"], res["decode_splits"] = W, splits
    del gpu, params, params_cpu, c_g, c_c
    torch.cuda.empty_cache()
    return res


def layer_gaps(torch, dev, cfg, params, params_cpu, toks):
    """Run each decoder layer on the card and on the CPU from the same
    input (the CPU's stream entering it): its output's max |card - CPU|
    over its max |output|, per layer. Beside the end-to-end logit gap it
    separates one layer's difference from its growth through the stack."""
    from repro_torch.models.layers import embed_lookup
    from repro_torch.models.transformer import apply_layer_full, layer_groups

    (group,) = layer_groups(cfg)
    x = embed_lookup(params_cpu["embed"], toks).to(params_cpu["embed"].dtype)
    pos = torch.arange(toks.shape[1])[None]
    gaps = []
    for i in range(group.count):
        y_c, _, _ = apply_layer_full(params_cpu["decoder"]["g0"][i]["l0"],
                                     cfg, group.sigs[0], x, pos)
        y_g, _, _ = apply_layer_full(params["decoder"]["g0"][i]["l0"], cfg,
                                     group.sigs[0], x.to(dev), pos.to(dev))
        gaps.append(float((y_g.float().cpu() - y_c.float()).abs().max()
                          / y_c.float().abs().max()))
        x = y_c
    return gaps


def ring_from_prefill(torch, caches, lens, W):
    """A sliding-window ring of W slots from a prefill cache tree: row b's
    last W tokens (of lens[b]) at slots t % W, as decode left them."""
    from repro_torch.models.schema import tree_map

    def ring(leaf):
        out = torch.zeros((leaf.shape[0], W) + tuple(leaf.shape[2:]),
                          dtype=leaf.dtype, device=leaf.device)
        for b, n in enumerate(lens):
            t = torch.arange(max(0, n - W), n, device=leaf.device)
            out[b, t % W] = leaf[b, t]
        return out

    return tree_map(ring, caches)


def card_vs_cpu(torch, dev, cfg, lens, L, K=4, W=2048):
    """One phase 3 row: a ragged bucketed prefill of ``lens`` (bucket L),
    then K decode steps on a ring of W slots, on the card (kernels) and the
    CPU (plain versions), same bf16 weights, held to LOGIT_LIMIT. With a
    sliding window the ring is the window, written from the prefill cache
    as decode would have left it, and decode wraps it."""
    from repro_torch.models import Model
    from repro_torch.models.kvcache import grow_cache
    from repro_torch.models.schema import tree_map

    gpu = Model(cfg, device=dev)
    params = gpu.init(torch.Generator(device=dev).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    g = torch.Generator().manual_seed(1)
    toks = torch.zeros((len(lens), L), dtype=torch.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=g)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    lg_g, c_g, n_g = gpu.prefill_bucketed(params, toks.to(dev), lens_t.to(dev))
    lg_c, c_c, n_c = cpu.prefill_bucketed(params_cpu, toks, lens_t)
    if cfg.sliding_window:
        c_g, c_c = (ring_from_prefill(torch, c, lens, W) for c in (c_g, c_c))
    else:
        c_g, c_c = grow_cache(c_g, W), grow_cache(c_c, W)
    res = walk_logits(torch, dev, gpu, params, cpu, params_cpu,
                      (lg_g, c_g, n_g), (lg_c, c_c, n_c), K)
    res.update(layers=cfg.n_layers, prompt_lens=lens, ring_slots=W,
               sliding_window=cfg.sliding_window)
    del gpu, params, params_cpu, c_g, c_c
    torch.cuda.empty_cache()
    return res


def same_weights_family(torch, dev):
    """Phase 3 (c): starcoder2-3b (kv 2), qwen3-32b (qk-norm) and
    granite-34b (MQA, 48 query heads a KV head) at published widths cut to
    2 layers, on a 2048-slot ring; and llama3-8b cut to 2 layers with a
    256-token sliding window, prompts of 300 and 401 tokens (longer than
    the window) and decode steps that wrap the 256-slot ring."""
    import dataclasses

    from repro_torch.configs import get_config

    rows = {}
    for name in ("starcoder2-3b", "qwen3-32b", "granite-34b"):
        print(f"   {name}, 2 layers:")
        cfg = dataclasses.replace(get_config(name), n_layers=2)
        rows[name] = card_vs_cpu(torch, dev, cfg, [9, 150, 33], 256)
    print("   llama3-8b, 2 layers, sliding window 256:")
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                              sliding_window=256)
    rows["llama3-8b-window-256"] = card_vs_cpu(torch, dev, cfg, [300, 401],
                                               512, W=256)
    return rows


def same_weights_ssm(torch, ops, dev):
    """Phase 3b: mamba2-130m at full width and depth, one exact prefill of
    601 tokens (three chunks of 256, the last ragged, in the fp32 kernel;
    ten of 64 in the bf16 launches) and 4 decode steps, the card through
    the SSD and rmsnorm kernels, the CPU through the plain versions, on the
    same random weights from seed 0. The fp32 run is held to 0.02 of the
    largest logit. In bf16 the random 24-layer stack amplifies the
    different roundings of the two sides (the kernels' bf16 hi/lo operands
    against the plain version's bf16 scores, cuBLAS against CPU products)
    from layer to layer, so the card and the CPU are each held
    against a witness: the CPU model in fp32 on the same bf16 weights, fed
    the same tokens. The card's bf16 logits must sit within SSM_BF16_LIMIT
    of it; the CPU's distance in bf16 is printed beside as the rounding
    that the plain path itself shows. The per-layer gaps, each layer run
    on both sides from the same input, show the one-layer difference apart
    from its growth."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_map

    cfg = get_config("mamba2-130m")
    S, K = 601, 4
    toks = torch.randint(0, cfg.vocab_size, (1, S),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    out = {"prompt_len": S}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gpu = Model(cfg, dtype=dtype, device=dev)
        params = gpu.init(torch.Generator(device=dev).manual_seed(0))
        cpu = Model(cfg, dtype=dtype, device="cpu")
        params_cpu = tree_map(lambda t: t.to("cpu"), params)
        ops.reset_launches()
        first_g = gpu.prefill(params, toks.to(dev))
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        want = {"rmsnorm": 2 * SSM_LAYERS + 1, "flash_attention": 0,
                "decode_attention": 0, "paged_decode_attention": 0,
                "ssd_scan": SSM_LAYERS, "preprocess": 0,
                "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
                "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0}
        if launches != want:
            raise AssertionError(f"mamba2 prefill launches {launches} != {want}")
        t0 = time.perf_counter()
        first_c = cpu.prefill(params_cpu, toks)
        print(f"   ({name}) card prefill launches {launches}; CPU prefill "
              f"{time.perf_counter() - t0:.1f} s")
        witness = None
        if dtype == torch.bfloat16:
            wit = Model(cfg, dtype=torch.float32, device="cpu")
            params_w = tree_map(
                lambda t: t.float() if t.is_floating_point() else t, params_cpu)
            witness = (wit, params_w, wit.prefill(params_w, toks))
        res = walk_logits(torch, dev, gpu, params, cpu, params_cpu, first_g,
                          first_c, K, gate=witness is None, witness=witness,
                          witness_limit=SSM_BF16_LIMIT)
        res["prefill_launches"] = launches
        res["layer_gaps"] = layer_gaps(torch, dev, cfg, params, params_cpu,
                                       toks)
        print(f"   ({name}) each layer on both sides from the CPU's input to "
              f"it: max|card - CPU| / max|output| {max(res['layer_gaps']):.2e} "
              f"at most, {min(res['layer_gaps']):.2e} at least")
        out[name] = res
        del gpu, params, params_cpu, first_g, first_c, witness
        torch.cuda.empty_cache()
    return out


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
            "decode_attention": N_LAYERS * c["decode_steps"],
            "paged_decode_attention": 0, "ssd_scan": 0, "preprocess": 0,
            "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0}
    print(f"   counters {c}; launches {launches}; expected {want}")
    if min(launches[k] for k in list(want)[:3]) == 0 or launches != want:
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
def profile_window(torch, run, key=None):
    """One call of ``run`` (which returns the decode steps it covered)
    under torch.profiler: host wall, device first-to-last span and device
    busy time per step, all from that one profiled run, the device's idle
    share, the kernels that take the most time and, with ``key``, the ms a
    step of the kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        steps = run()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
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
           "top": [{"ms_per_step": ms, "name": name[:80], "calls_per_step": n}
                   for ms, name, n in kernels[:8]]}
    if key is not None:
        res["kernel"] = key
        res["kernel_ms_per_step"] = sum(k[0] for k in kernels
                                        if matches(key, k[1]))
    if busy_ms:
        print(f"   profiled run: host wall {wall_ms:.2f} ms/step, device "
              f"first-to-last {span_ms:.2f} ms/step, busy {busy_ms:.2f} ms/step "
              f"over {res['device_kernels_per_step']:.0f} kernels; idle share "
              f"{res['device_idle_share']:.2f} of the wall, "
              f"{res['device_idle_share_of_span']:.2f} of the device span"
              + ("" if key is None else f"; the "
                 f"{key if isinstance(key, str) else key[0]} kernel "
                 f"{res['kernel_ms_per_step']:.3f} ms/step"))
    else:
        print(f"   profiled run: host wall {wall_ms:.2f} ms/step; the "
              "profiler reported no device time: busy and idle not measured")
    return res


def print_top(res):
    for k in res["top"]:
        print(f"   {k['ms_per_step']:8.3f} ms  x{k['calls_per_step']:<5g} {k['name']}")


def decode_profile(torch, eng, steps=10, graph=True, key=None):
    """Whole-batch decode steps of the drained engine (its slots are frozen
    lanes, which run the same batched compute as live ones): replays of
    the pool's captured graph, or with ``graph=False`` the eager step (the
    pool's graph set aside for the run). The unprofiled run also reads the
    stream's CUDA-event time from the first step's start to the last
    one's end, and the host microseconds a dispatch takes (``fill_one``:
    the replay, or the eager step's launches, and the step's host copy)."""
    pool = eng.pool
    use_graph = getattr(pool, "use_graph", False)  # absent before graphs
    if not graph:
        pool.use_graph = False
    dispatch_s = []

    def run():
        for _ in range(steps):
            t = time.perf_counter()
            pool.fill_one(eng.params, limit=steps)
            dispatch_s.append(time.perf_counter() - t)
            pool.pop_oldest()
        torch.cuda.synchronize()
        return steps

    try:
        run()  # warm
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        bare_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        torch.cuda.synchronize()
        events_ms = start.elapsed_time(end) / steps
        dispatch_us = statistics.median(dispatch_s[steps:]) * 1e6
        res = profile_window(torch, run, key)
    finally:
        if not graph:
            pool.use_graph = use_graph
    res.update(graph=graph, unprofiled_host_wall_ms_per_step=bare_wall_ms,
               unprofiled_events_ms_per_step=events_ms,
               unprofiled_dispatch_us_median=dispatch_us)
    print(f"   a separate unprofiled run: host wall {bare_wall_ms:.2f} ms/step,"
          f" stream (CUDA events) {events_ms:.2f} ms/step; a dispatch "
          f"(fill_one) {dispatch_us:.1f} us of host time, median")
    print_top(res)
    return res


def live_step_profile(torch, eng, prompts, new, steps=10, key="PagedRows"):
    """Decode steps of an engine on live rows (a paged engine's with their
    own page tables): one wave of ``max_batch`` requests is submitted and
    stepped until its prefill is done and 3 decode steps went out, then
    ``steps`` engine steps (dispatch and harvest; under ``legacy`` the
    seed's synchronous step) run under torch.profiler, with the ms a step
    of the kernels whose name holds ``key`` (the paged kernel); the wave is
    drained after."""
    from repro_torch.serving import Request

    for t in prompts[:eng.max_batch]:
        eng.submit(Request(prompt_tokens=t.copy(), max_new_tokens=new))
    d0 = eng.decode_steps
    while eng.decode_steps < d0 + 3:
        eng.step()
    torch.cuda.synchronize()

    def run():
        s0 = eng.decode_steps
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        return eng.decode_steps - s0

    res = profile_window(torch, run, key)
    print_top(res)
    eng.run_until_drained()
    return res


def prefill_profile(torch, eng, shape, key, label):
    """One profiled ``model.prefill`` of random tokens of ``shape`` on the
    engine's model and weights: see :func:`profile_call`."""
    model, params = eng.model, eng.params
    toks = torch.randint(0, model.cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32).to(eng.device)
    return profile_call(torch, lambda: model.prefill(params, toks), key,
                        label, " x ".join(map(str, shape)) + "-token prefill",
                        list(shape))


def profile_call(torch, fn, key, label, what, shape):
    """``fn`` once unprofiled after a warm call, then once under
    torch.profiler: host wall both times, device busy time, and the share
    of it taken by the kernels whose name holds ``key``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        kernels.append((dev_us / 1e3, evt.key, evt.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    mine = sum(k[0] for k in kernels if key in k[1])
    res = {"shape": shape, "unprofiled_host_wall_ms": bare_ms,
           "profiled_host_wall_ms": wall_ms, "device_busy_ms": busy,
           "kernel": key, "kernel_ms": mine,
           "kernel_share_of_device_time": mine / busy if busy else None,
           "device_kernels": sum(k[2] for k in kernels),
           "top": [{"ms": ms, "name": name[:80], "calls": n}
                   for ms, name, n in kernels[:8]]}
    if busy:
        print(f"   {what}: host wall {bare_ms:.2f} ms unprofiled, "
              f"{wall_ms:.2f} ms profiled; device busy {busy:.2f} ms over "
              f"{res['device_kernels']} kernels, the {label} kernel "
              f"{mine:.2f} ms = {mine / busy:.3f} of it")
    else:
        print(f"   {what}: host wall {bare_ms:.2f} ms; the profiler reported "
              f"no device time: the {label} share is not measured")
    for k in res["top"]:
        print(f"   {k['ms']:8.3f} ms  x{k['calls']:<5g} {k['name']}")
    return res


# --------------------------------------------------------------------------- #
# phases 4 (b) and 9: packed and chunked prefill
# --------------------------------------------------------------------------- #
def serve_ways(torch, ops, model, params, prompts, *, warm):
    """Serve ``prompts`` (32 new tokens each, all submitted at once) on
    ServingEngine(max_batch=8, max_seq=2048) once per PREFILL_WAYS entry,
    after one warm pass over all of them when ``warm`` (the measured pass
    then runs in reverse order, so a drift of the host's speed falls on
    both ends). Each run: launch counts held to the path's structure (flash
    once a layer per prefill call, packed or a chunk alike), tokens held to
    the bucketed run's or parted only at a near tie, the counters, TTFT
    p50/p99, TPOT p50 and the 'preprocess' mean."""
    from repro_torch.core.metrics import slo_summary
    from repro_torch.serving import ServingEngine

    cfg = model.cfg
    ways = list(PREFILL_WAYS)
    order = ways + ways[::-1] if warm else ways
    res, tokens = {}, {}
    for i, way in enumerate(order):
        eng = ServingEngine(model, params, max_batch=8, max_seq=2048,
                            device=model.device, **PREFILL_WAYS[way])
        torch.cuda.synchronize()
        ops.reset_launches()
        reqs, out = serve_all(eng, prompts, 32)
        launches = dict(ops.LAUNCHES)
        c = eng.counters()
        want = structure(c, cfg.n_layers, qk_norm=cfg.qk_norm)
        if launches != want:
            raise AssertionError(f"{way}: launch counts {launches} != path "
                                 f"structure {want}")
        if (way != "bucketed") != (eng.packed or eng._chunk_enabled):
            raise AssertionError(f"{way}: the engine's knobs did not take")
        tokens[way] = [r.generated for r in reqs]
        if warm and i < len(ways):
            continue
        slo = slo_summary(out)
        res[way] = {
            "counters": c, "launches": launches,
            "flash_per_prefill_call": launches["flash_attention"]
            / c["prefill_calls"],
            "ttft_ms": {p: slo["ttft_s"][p] * 1e3 for p in ("p50", "p99")},
            "tpot_ms_p50": slo["tpot_s"]["p50"] * 1e3,
            "preprocess_ms": eng.store.stage_means()["preprocess"] * 1e3}
        print(f"   {way:15s} prefill calls {c['prefill_calls']:3d}, padded "
              f"token-rows {c['prefill_padded_tokens']:6d} for "
              f"{c['prefill_tokens_total']} prompt tokens, decode steps "
              f"{c['decode_steps']}; TTFT p50/p99 "
              f"{res[way]['ttft_ms']['p50']:.2f} / "
              f"{res[way]['ttft_ms']['p99']:.2f} ms, TPOT p50 "
              f"{res[way]['tpot_ms_p50']:.2f} ms, 'preprocess' "
              f"{res[way]['preprocess_ms']:.2f} ms", flush=True)
        del eng
    for way in ways[1:]:
        res[way]["parted"] = parted(torch, model, params, prompts,
                                    tokens["bucketed"], tokens[way], way)
    return res


def parted(torch, model, params, prompts, want, got, way,
           ref="the bucketed run", gate=True):
    """Where ``got`` parts from ``ref``'s tokens ``want``: per parted
    request the first parting step and the top-2 logit gap there (an exact
    prefill of the prompt and the tokens before it), which must be under
    LOGIT_LIMIT of the largest logit: a near tie, not a fault (with
    ``gate=False`` it is reported only)."""
    import numpy as np

    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.concatenate([prompts[i], np.asarray(b[:k], np.int32)])
        logits, _, _ = model.prefill(
            params, torch.from_numpy(ctx)[None].to(model.device))
        lg = logits[0, :model.cfg.vocab_size].float()
        top = lg.topk(2).values
        gap = float((top[0] - top[1]) / lg.abs().max())
        out.append({"request": i, "step": k, "top2_gap_rel": gap})
        print(f"   {way}: request {i} parts at step {k}, top-2 gap "
              f"{gap:.3e} of the largest logit")
        if gate and gap >= LOGIT_LIMIT:
            raise AssertionError(f"{way}: request {i} parts from {ref} at "
                                 f"step {k} at a top-2 gap of {gap:.3e} >= "
                                 f"{LOGIT_LIMIT} of the largest logit")
    if not out:
        print(f"   {way}: tokens == {ref}'s")
    return out


def packed_prefill_profile(torch, model, params, prompts):
    """One packed prefill of phase 4's first admission (8 prompts, 6,043
    tokens in an 8192-slot row) under torch.profiler, as the engine calls
    it: busy time and flash's share, padded rows against true rows."""
    import numpy as np

    lens = [len(p) for p in prompts[:8]]
    toks = np.zeros((1, PACKED_T), np.int32)
    pos = np.zeros((1, PACKED_T), np.int32)
    seg = np.full((1, PACKED_T), -1, np.int32)
    last = np.zeros((8,), np.int32)
    off = 0
    for j, p in enumerate(prompts[:8]):
        toks[0, off:off + len(p)] = p
        pos[0, off:off + len(p)] = np.arange(len(p))
        seg[0, off:off + len(p)] = j
        last[j] = off + len(p) - 1
        off += len(p)
    dev = model.device
    args = [torch.from_numpy(a).to(dev) for a in (toks, pos, seg, last)]
    res = profile_call(torch, lambda: model.prefill_packed(params, *args),
                       "flash", "flash", f"packed [1, {PACKED_T}] prefill",
                       [1, PACKED_T])
    res.update(padded_rows=PACKED_T, true_rows=sum(lens))
    print(f"   padded rows {PACKED_T} for {sum(lens)} true rows (the bucketed "
          f"admission of the same prompts: 8 x 1024 = 8192 rows, of which "
          f"{sum(lens)} true)")
    return res


def prefill_ways(torch, ops, engine):
    """Phase 4 (b): phase 4's 12 requests on its 32-layer llama3-8b and
    weights, served bucketed, packed, chunked (C = 256) and both; packed's
    padded token-rows must be under the bucketed BUCKETED_PADDED. Then one
    packed prefill under the profiler."""
    model, params = engine.model, engine.params
    prompts = main_prompts(model.cfg.vocab_size)
    res = serve_ways(torch, ops, model, params, prompts, warm=True)
    padded = {w: r["counters"]["prefill_padded_tokens"] for w, r in res.items()}
    if padded["bucketed"] != BUCKETED_PADDED:
        raise AssertionError(f"bucketed padded token-rows {padded['bucketed']}"
                             f" != phase 4's {BUCKETED_PADDED}")
    if not padded["packed"] < BUCKETED_PADDED:
        raise AssertionError(f"packed padded token-rows {padded['packed']} "
                             f"not under {BUCKETED_PADDED}")
    res["packed_prefill_profile"] = packed_prefill_profile(torch, model,
                                                           params, prompts)
    return res


def dense_family_path(torch, ops, dev):
    """Phase 9: starcoder2-3b, qwen3-32b and granite-34b at published widths
    (depths DENSE_FAMILY), random bf16 weights from seed 0, each served
    with phase 4's traffic shape the four ways of phase 4 (b), then freed
    before the next. qwen3's launches include its qk-norm (rmsnorm 4L + 1
    a forward)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    rows = {}
    for name, layers in DENSE_FAMILY:
        cfg = dataclasses.replace(get_config(name), n_layers=layers)
        model = Model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        gb = weights_gb(params)
        layer_gb = weights_gb(params["decoder"]) / layers
        full = get_config(name).n_layers
        full_gb = gb + (full - layers) * layer_gb
        print(f"   {name}: {layers} of {full} layers, {gb:.2f} GB of bf16 "
              f"weights ({layer_gb:.3f} a layer; {full_gb:.2f} at full "
              f"depth)", flush=True)
        torch.cuda.reset_peak_memory_stats()
        rows[name] = serve_ways(torch, ops, model, params,
                                main_prompts(cfg.vocab_size), warm=False)
        rows[name].update(layers=layers, weights_gb=gb, layer_gb=layer_gb,
                          full_depth_weights_gb=full_gb,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, params
        torch.cuda.empty_cache()
    return rows


def leaves(tree):
    """The tensors of a nested dict/list tree."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


# --------------------------------------------------------------------------- #
# phase 6
# --------------------------------------------------------------------------- #
def paged_traffic(cfg):
    """Phase 6's prompts (loadgen.shared_prefix_schedule over PAGED_TRAFFIC),
    their distinct prefixes, and one priming prompt per prefix."""
    import numpy as np

    from repro_torch.serving.loadgen import shared_prefix_schedule

    sched = shared_prefix_schedule(cfg.vocab_size, rate_rps=1.0,
                                   **PAGED_TRAFFIC)
    prompts = [a.request.prompt_tokens for a in sched]
    plen = PAGED_TRAFFIC["prefix_len"]
    prefixes = []
    for p in prompts:
        if not any(np.array_equal(p[:plen], x) for x in prefixes):
            prefixes.append(p[:plen])
    rng = np.random.default_rng(1)
    primes = [np.concatenate([x, rng.integers(0, cfg.vocab_size,
                                              PAGED_TRAFFIC["suffix_len"],
                                              dtype=np.int32)])
              for x in prefixes]
    return prompts, prefixes, primes


def clear_index(eng):
    """Drop the prefix index's hold on its blocks; returns the blocks live
    after."""
    alloc = eng.pool.allocator
    for (p, d) in eng.prefix_index.clear():
        alloc.deref([p])
        alloc.deref([d])
    return alloc.live_blocks


def paged_path(torch, ops, ring_engine):
    """Serve one shared-prefix workload on phase 4's model and weights three
    times: (a) the ring pool, (b) paged without, (c) paged with prefix
    reuse. Submitting each wave at once keeps the admission groups, and so
    every count, deterministic."""
    import numpy as np

    from repro_torch.core.metrics import percentile
    from repro_torch.serving import Request, ServingEngine

    model, params = ring_engine.model, ring_engine.params
    cfg = model.cfg
    prompts, prefixes, primes = paged_traffic(cfg)
    plen = PAGED_TRAFFIC["prefix_len"]
    n, new = len(prompts), PAGED_TRAFFIC["max_new"]
    print(f"   {n} requests over {len(prefixes)} prefixes "
          f"({[sum(np.array_equal(p[:plen], x) for p in prompts) for x in prefixes]}"
          f" requests each), prompts of {len(prompts[0])} tokens, "
          f"{len(primes)} priming requests")

    def drain(eng, toks):
        reqs = [Request(prompt_tokens=t.copy(), max_new_tokens=new) for t in toks]
        for r in reqs:
            eng.submit(r)
        out = {r.request_id: r for r in eng.run_until_drained()}
        if len(out) != len(reqs):
            raise AssertionError(f"{len(out)} of {len(reqs)} requests returned")
        return reqs, [out[r.request_id] for r in reqs]

    runs, tokens = {}, {}
    for name, kw in (("ring", {}), ("paged", dict(paged=True, prefix_reuse=False)),
                     ("reuse", dict(paged=True))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        eng = ServingEngine(model, params, max_batch=8, max_seq=2048,
                            device=ring_engine.device, **kw)
        drain(eng, primes)
        c0 = eng.counters()
        t0 = time.perf_counter()
        reqs, rsps = drain(eng, prompts)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        c = eng.counters()
        if any(len(r.tokens) != new for r in rsps):
            raise AssertionError(f"({name}) token counts {[len(r.tokens) for r in rsps]}")
        if not eng.logits_all_finite():
            raise AssertionError(f"({name}) a logit was not finite")
        forwards = c["prefill_calls"] + c["decode_steps"]
        decode = "paged_decode_attention" if eng.paged else "decode_attention"
        want = {"rmsnorm": (2 * N_LAYERS + 1) * forwards,
                "flash_attention": N_LAYERS * c["prefill_calls"],
                "decode_attention": 0, "paged_decode_attention": 0,
                "ssd_scan": 0, "preprocess": 0,
                "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
                "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0}
        want[decode] = N_LAYERS * c["decode_steps"]
        if launches != want:
            raise AssertionError(f"({name}) launch counts {launches} != path "
                                 f"structure {want}")
        delta = {k: c[k] - c0[k] for k in c}
        tpots = [(r.total_s - r.ttft_s) / (len(r.tokens) - 1) for r in rsps]
        res = {"counters": c, "measured": delta, "launches": launches,
               "wall_s": wall, "tokens_per_s": n * new / wall,
               "ttft_ms_p50": percentile([r.ttft_s for r in rsps], 0.5) * 1e3,
               "ttft_ms_p99": percentile([r.ttft_s for r in rsps], 0.99) * 1e3,
               "tpot_ms_p50": percentile(tpots, 0.5) * 1e3,
               "preprocess_ms_mean": 1e3 * sum(r.stage_s["preprocess"] for r in rsps) / n,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"   ({name}) measured counters {delta}; launches {launches}")
        print(f"   ({name}) ttft p50 {res['ttft_ms_p50']:.2f} ms, p99 "
              f"{res['ttft_ms_p99']:.2f} ms; tpot p50 {res['tpot_ms_p50']:.2f} ms; "
              f"preprocess mean {res['preprocess_ms_mean']:.2f} ms; "
              f"{res['tokens_per_s']:.1f} tokens/s; peak device memory "
              f"{res['peak_mem_gb']:.2f} GB", flush=True)
        if name == "reuse":
            want_c = {"prefix_hits": n, "prefix_hit_tokens": n * plen,
                      "prefill_tokens_uncached": n * (len(prompts[0]) - plen)}
            got_c = {k: delta[k] for k in want_c}
            if got_c != want_c:
                raise AssertionError(f"(reuse) prefix counters {got_c} != {want_c}")
            res["live_blocks_before_clear"] = eng.pool.allocator.live_blocks
            live = clear_index(eng)
            if live != 0:
                raise AssertionError(f"(reuse) {live} blocks live after the "
                                     "index was cleared")
            print(f"   (reuse) {res['live_blocks_before_clear']} blocks live "
                  "after the drain, all held by the index; 0 after clearing it")
            print("   (reuse) a decode step of one more wave (8 requests, "
                  "prefilled anew: the index is cleared):")
            res["step_profile"] = live_step_profile(torch, eng, prompts, new)
        runs[name] = res
        tokens[name] = [list(r.generated) for r in reqs]
        del eng

    def parting(i, a, b):
        """Where request i's token lists a and b first differ: the index and
        the logits there, from an exact prefill of the prompt and a's tokens
        before it; None where they agree."""
        k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            return None, None
        ctx = np.concatenate([prompts[i], np.asarray(a[:k], np.int32)])
        with torch.no_grad():
            lg, _, _ = model.prefill(params, torch.from_numpy(ctx)[None].to(
                ring_engine.device))
        return k, lg[0, :cfg.vocab_size].float()

    # (a) and (b) run one split-KV template with the same split plan (the
    # ring is max_seq slots, the page table max_seq / PAGE pages): the same
    # keys through the same arithmetic, so every token must be equal
    if tokens["paged"] != tokens["ring"]:
        bad = [i for i, (a, b) in enumerate(zip(tokens["paged"], tokens["ring"]))
               if a != b]
        raise AssertionError(f"(b) paged tokens differ from (a) ring tokens "
                             f"in requests {bad}")
    print(f"   (b) paged == (a) ring: all {n * new} tokens equal")

    # suffix prefill reassociates bf16 sums: where (c) parts from (b), (b)'s
    # top-2 logit gap at that position, from an exact prefill of the context
    agree, parts = 0, []
    for i, (a, b) in enumerate(zip(tokens["paged"], tokens["reuse"])):
        agree += sum(x == y for x, y in zip(a, b))
        k, lg = parting(i, a, b)
        if k is None:
            continue
        top = lg.topk(2)
        parts.append({"request": i, "token": k, "b_token": a[k], "c_token": b[k],
                      "b_top2_gap": float(top.values[0] - top.values[1]),
                      "top1_is_b_token": int(top.indices[0]) == a[k]})
        print(f"   (c) parts from (b) in request {i} at token {k}: "
              f"{a[k]} vs {b[k]}, top-2 gap {parts[-1]['b_top2_gap']:.4g} "
              f"(exact prefill's top-1 is (b)'s token: "
              f"{parts[-1]['top1_is_b_token']})")
    print(f"   (c) reuse vs (b) paged: {agree}/{n * new} tokens equal; "
          f"ttft p50 {runs['reuse']['ttft_ms_p50']:.2f} vs "
          f"{runs['paged']['ttft_ms_p50']:.2f} ms")
    return ({"traffic": PAGED_TRAFFIC, "runs": runs,
             "reuse_tokens_equal_paged": agree, "tokens_total": n * new,
             "reuse_parts": parts},
            {"primes": primes, "prompts": prompts, "new": new,
             "reuse_tokens": tokens["reuse"]})


# --------------------------------------------------------------------------- #
# phase 7
# --------------------------------------------------------------------------- #
def ssm_path(torch, ops):
    """Serve ragged long-context load on mamba2-130m through the launcher,
    then profile one 2048-token exact prefill of the same model and the
    drained engine's decode steps."""
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = serve.main(SSM_ARGV)
    launches = dict(ops.LAUNCHES)
    eng = out["engine"]
    c = eng.counters()
    responses = out["responses"]
    if len(responses) != 12 or any(len(r.tokens) != 32 for r in responses):
        raise AssertionError(f"SSM path: token counts "
                             f"{[len(r.tokens) for r in responses]}")
    if not eng.logits_all_finite():
        raise AssertionError("SSM path: a logit was not finite")
    prompt_lens = sorted(rec.bytes_in // 4 for rec in eng.store.records)
    if not eng.exact_prefill or c["prefill_calls"] != 12:
        raise AssertionError(f"SSM path: {c['prefill_calls']} prefill calls, "
                             "not one exact prefill per request")
    if c["prefill_padded_tokens"] != sum(prompt_lens):
        raise AssertionError(f"SSM path: {c['prefill_padded_tokens']} padded "
                             f"prefill tokens != {sum(prompt_lens)} prompt tokens")
    forwards = c["prefill_calls"] + c["decode_steps"]
    want = {"rmsnorm": (2 * SSM_LAYERS + 1) * forwards, "flash_attention": 0,
            "decode_attention": 0, "paged_decode_attention": 0,
            "ssd_scan": SSM_LAYERS * c["prefill_calls"], "preprocess": 0,
            "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0}
    print(f"   prompts {prompt_lens}; counters {c}; launches {launches}; "
          f"expected {want}")
    if launches != want or launches["ssd_scan"] == 0:
        raise AssertionError(f"launch counts {launches} != path structure {want}")
    peak = torch.cuda.max_memory_allocated()
    slo = out["slo"]
    res = {
        "argv": SSM_ARGV, "prompt_lens": prompt_lens, "counters": c,
        "launches": launches, "wall_s": out["wall_s"], "tokens": out["tokens"],
        "tokens_per_s": out["tokens"] / out["wall_s"],
        "ttft_ms": {p: slo["ttft_s"][p] * 1e3 for p in ("p50", "p99", "mean")},
        "tpot_ms": {p: slo["tpot_s"][p] * 1e3 for p in ("p50", "p99", "mean")},
        "stage_means_ms": {k: v * 1e3 for k, v in
                           eng.store.stage_means().items()},
        "peak_mem_gb": peak / 1e9,
    }
    print(f"   ttft p50 {res['ttft_ms']['p50']:.2f} ms, tpot p50 "
          f"{res['tpot_ms']['p50']:.2f} ms, {res['tokens_per_s']:.1f} tokens/s, "
          f"'preprocess' mean {res['stage_means_ms'].get('preprocess', 0):.2f} "
          f"ms, peak device memory {peak / 1e9:.2f} GB")

    # one profiled exact prefill of 2048 tokens: the SSD kernel's share of
    # the device time, beside the host wall of the same call
    res["prefill_2048"] = prefill_profile(torch, eng, (1, 2048), "ssd_scan",
                                          "SSD")
    print("   decode steps of the drained engine (8 lanes):")
    res["decode_profile"] = decode_profile(torch, eng)
    return res, eng


# --------------------------------------------------------------------------- #
# phase 8
# --------------------------------------------------------------------------- #
def meta_cache(torch, model, B, W):
    """The model's cache tree for B rows of W slots as meta tensors: shapes
    and dtypes, no memory."""
    from repro_torch.models import kvcache as kvc

    return {g: [{name: kvc.init_layer_cache(shapes, model.dtype, "meta")
                 for name, shapes in block.items()} for block in group]
            for g, group in model.cache_specs(B, W).items()}


def extent_wire_bytes(torch, template, n, prefix, mode):
    """Host-side wire bytes of one ring handoff of n rows x prefix slots:
    ``payload_wire_bytes`` of the sliced template and 4 int32 metadata
    rows, never reading the engine's payload."""
    from repro_torch.core.transfer import payload_wire_bytes
    from repro_torch.models.kvcache import slice_cache

    meta = {k: torch.empty((n,), dtype=torch.int32, device="meta")
            for k in ("lengths", "next_tokens", "slot_idx", "max_new")}
    return payload_wire_bytes(
        {"caches": slice_cache(template, n, prefix), "meta": meta}, mode)


def record_extents(eng):
    """Log every ring handoff's (rows, prefix) extent as the tier computes
    it; returns the list the log fills."""
    log, extent = [], eng._prefix_extent

    def recorded(art):
        log.append(extent(art))
        return log[-1]

    eng._prefix_extent = recorded
    return log


def serve_all(eng, prompts, new, features=None):
    """Submit every prompt (with ``features[i]``, a feature payload or
    None, when given) at once and drain: admission then does not depend on
    timing. Returns (requests, responses) in prompt order."""
    from repro_torch.serving import Request

    features = features or [None] * len(prompts)
    reqs = [Request(prompt_tokens=t.copy(), max_new_tokens=new, features=f)
            for t, f in zip(prompts, features)]
    for r in reqs:
        eng.submit(r)
    out = {r.request_id: r for r in eng.run_until_drained()}
    if len(out) != len(reqs) or any(len(out[r.request_id].tokens) != new
                                    for r in reqs):
        raise AssertionError(f"{len(out)} of {len(reqs)} requests returned, "
                             "or a request fell short of its budget")
    if not eng.logits_all_finite():
        raise AssertionError("a logit was not finite")
    return reqs, [out[r.request_id] for r in reqs]


def structure(c, layers, decode="decode_attention", ssm=False,
              qk_norm=False, mla=False):
    """Launch counts a served run must show: rmsnorm 2 per layer + 1 per
    forward (4 per layer + 1 with qk-norm -- the queries' and the keys' --
    or MLA -- q_norm and kv_norm), flash (or the SSD scan) once per layer
    per prefill call, whether bucketed, packed or a chunk, the decode
    kernel once per layer per step."""
    per_layer = 4 if qk_norm or mla else 2
    want = {"rmsnorm": (per_layer * layers + 1) * (c["prefill_calls"]
                                                   + c["decode_steps"]),
            "flash_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "ssd_scan": 0, "preprocess": 0,
            "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0}
    if ssm:
        want["ssd_scan"] = layers * c["prefill_calls"]
    else:
        want["flash_attention"] = layers * c["prefill_calls"]
        want[decode] = layers * c["decode_steps"]
    return want


def disagg_path(torch, ops, llama, shared, ssm_engine):
    """Phase 8: (a) phase 4's 12 llama3-8b requests, all submitted at once,
    through the fused engine and DisaggregatedEngine under each mechanism:
    one warm pass per engine, then two measured passes in turns (A B C D
    D C B A), so a drift of the host's speed falls on every engine alike;
    (b) phase 6's shared-prefix traffic, paged with reuse, under
    DIRECT_DMA; (c) 4 mamba2-130m requests under DIRECT_HBM against phase
    7's fused engine."""
    from repro_torch.core.metrics import percentile
    from repro_torch.core.transfer import MODE_TRANSPORT, TransferMode
    from repro_torch.core.transport import PAPER_A2
    from repro_torch.serving import DisaggregatedEngine, ServingEngine
    from repro_torch.serving.client import ClosedLoopClient

    model, params = llama
    dev = model.device
    prompts = main_prompts(model.cfg.vocab_size)
    template = meta_cache(torch, model, 8, 2048)
    names = ("fused",) + DISAGG_MODES
    engines, extents = {}, {}
    for name in names:
        if name == "fused":
            eng = ServingEngine(model, params, max_batch=8, max_seq=2048,
                                device=dev)
        else:
            eng = DisaggregatedEngine(model, params, max_batch=8,
                                      max_seq=2048, device=dev,
                                      transfer_mode=TransferMode(name))
            extents[name] = record_extents(eng)
        # warm pass: the hop's buffers grow here to the largest extent this
        # traffic makes (pinned and touched host memory included), so the
        # measured passes allocate nothing
        serve_all(eng, prompts, 32)
        engines[name] = eng
    runs = {name: [] for name in names}
    tokens = {}
    for name in names + names[::-1]:  # in turns: A B C D D C B A
        eng = engines[name]
        c0, hop0 = eng.counters(), getattr(eng, "handoff_wall_s", 0.0)
        torch.cuda.synchronize()
        ops.reset_launches()
        reqs, rsps = serve_all(eng, prompts, 32)
        torch.cuda.synchronize()
        launches, c = dict(ops.LAUNCHES), eng.counters()
        delta = {k: c[k] - c0[k] for k in c}
        if launches != structure(delta, N_LAYERS):
            raise AssertionError(f"({name}) launches {launches} != "
                                 f"{structure(delta, N_LAYERS)}")
        runs[name].append({"delta": delta, "rsps": rsps, "launches": launches,
                           "hop_s": getattr(eng, "handoff_wall_s", 0.0)
                           - hop0})
        got = [list(r.generated) for r in reqs]
        if tokens.setdefault(name, got) != got:
            raise AssertionError(f"({name}) tokens differ between passes")
    out = {"ring": {}}
    for name in names:
        eng, passes = engines[name], runs[name]
        rsps = [r for p in passes for r in p["rsps"]]
        stages = ("transfer", "preprocess")
        res = {"measured": [p["delta"] for p in passes],
               "launches": [p["launches"] for p in passes],
               "ttft_ms_p50": percentile([r.ttft_s for r in rsps], 0.5) * 1e3,
               **{f"{k}_ms_mean": 1e3 * sum(r.stage_s.get(k, 0.0)
                                            for r in rsps) / len(rsps)
                  for k in stages}}
        line = (f"   ({name}) ttft p50 {res['ttft_ms_p50']:.2f} ms over 2 "
                f"measured passes; 'preprocess' mean "
                f"{res['preprocess_ms_mean']:.2f} ms, 'transfer' mean "
                f"{res['transfer_ms_mean']:.3f} ms")
        if name != "fused":
            mode = TransferMode(name)
            c = eng.counters()
            per = [extent_wire_bytes(torch, template, n, p, mode)
                   for n, p in extents[name]]
            if c["handoff_wire_bytes"] != sum(per) or c["handoffs"] != len(per):
                raise AssertionError(
                    f"({name}) handoff_wire_bytes {c['handoff_wire_bytes']} "
                    f"!= host-side sum {sum(per)} over {extents[name]}")
            k = len(per) // 3  # handoffs per pass (warm + 2 measured)
            wire = sum(per[:k])
            if extents[name] != RING_EXTENTS * 3 or wire != RING_WIRE[name]:
                raise AssertionError(
                    f"({name}) extents {extents[name]}, {wire} wire bytes a "
                    f"pass; worked out from the prompts: {RING_EXTENTS}, "
                    f"{RING_WIRE[name]}")
            hop_ms = [p["hop_s"] * 1e3 for p in passes]
            res.update(
                extents=extents[name][:k], handoffs_per_pass=k,
                wire_bytes_per_pass=wire, hop_ms_per_pass=hop_ms,
                hop_ms_per_handoff=sum(hop_ms) / (2 * k),
                wire_gb_s=2 * wire / sum(hop_ms) / 1e6,
                paper_a2_modelled_ms_per_pass=1e3 * sum(
                    PAPER_A2.handoff_time(MODE_TRANSPORT[mode], b)
                    for b in per[:k]))
            line = (f"   ({name}) {k} handoffs a pass {extents[name][:k]}, "
                    f"{wire} wire bytes a pass (all {len(per)} handoffs = "
                    f"the host-side sum); hop {hop_ms[0]:.3f}, "
                    f"{hop_ms[1]:.3f} ms a pass, "
                    f"{res['hop_ms_per_handoff']:.3f} ms a handoff, "
                    f"{res['wire_gb_s']:.2f} GB/s; PAPER_A2 models "
                    f"{res['paper_a2_modelled_ms_per_pass']:.2f} ms for the "
                    "same bytes\n" + line)
        print(line, flush=True)
        out["ring"][name] = res
    del engines
    torch.cuda.empty_cache()
    for name in ("direct_hbm", "direct_dma"):
        if tokens[name] != tokens["fused"]:
            bad = [i for i, (a, b) in enumerate(zip(tokens[name],
                                                    tokens["fused"])) if a != b]
            raise AssertionError(f"({name}) tokens differ from the fused "
                                 f"engine's in requests {bad}")
    if [t[0] for t in tokens["host_staged"]] != [t[0] for t in tokens["fused"]]:
        raise AssertionError("(host_staged) a first token differs")
    agree = sum(a == b for x, y in zip(tokens["host_staged"], tokens["fused"])
                for a, b in zip(x, y))
    out["host_staged_tokens_equal_fused"] = agree
    out["tokens"] = tokens  # phase 18 (d) holds the placed tier to them
    ttft = {k: v["ttft_ms_p50"] for k, v in out["ring"].items()}
    out["gdr_ttft_saving"] = {
        k: 1 - ttft["direct_hbm"] / ttft[k] for k in ("direct_dma",
                                                       "host_staged")}
    print(f"   direct_hbm, direct_dma == fused on all {12 * 32} tokens; "
          f"host_staged: every first token equal, {agree}/{12 * 32} tokens; "
          f"GDR's ttft p50 saving vs RDMA "
          f"{out['gdr_ttft_saving']['direct_dma']:.4f}, vs TCP "
          f"{out['gdr_ttft_saving']['host_staged']:.4f}", flush=True)

    # (b) paged with prefix reuse, DIRECT_DMA
    torch.cuda.empty_cache()
    eng = DisaggregatedEngine(model, params, max_batch=8, max_seq=2048,
                              paged=True, device=dev,
                              transfer_mode=TransferMode.DIRECT_DMA)
    serve_all(eng, shared["primes"], shared["new"])
    c0 = eng.counters()
    ops.reset_launches()
    reqs, rsps = serve_all(eng, shared["prompts"], shared["new"])
    torch.cuda.synchronize()
    launches, c = dict(ops.LAUNCHES), eng.counters()
    delta = {k: c[k] - c0[k] for k in c}
    want = structure(delta, N_LAYERS, "paged_decode_attention")
    if launches != want:
        raise AssertionError(f"(paged) launches {launches} != {want}")
    if [list(r.generated) for r in reqs] != shared["reuse_tokens"]:
        raise AssertionError("(paged) tokens differ from phase 6 (c)")
    if c["handoff_wire_bytes"] != c["handoff_payload_bytes"]:
        raise AssertionError(f"(paged) wire {c['handoff_wire_bytes']} != "
                             f"plan {c['handoff_payload_bytes']}")
    if delta["prefix_hits"] != len(shared["prompts"]):
        raise AssertionError(f"(paged) {delta['prefix_hits']} prefix hits")
    out["paged"] = {"counters": c, "measured": delta, "launches": launches,
                    "hop_ms": eng.handoff_wall_s * 1e3,
                    "ttft_ms_p50": percentile([r.ttft_s for r in rsps],
                                              0.5) * 1e3}
    print(f"   (paged, direct_dma) tokens == phase 6 (c); "
          f"{delta['prefix_hits']} prefix hits; measured run: "
          f"{delta['handoffs']} handoffs, {delta['handoff_wire_bytes']} wire "
          f"bytes; in all {c['handoff_wire_bytes']} == plan "
          f"{c['handoff_payload_bytes']}; hop {eng.handoff_wall_s * 1e3:.3f} "
          f"ms over {c['handoffs']} handoffs", flush=True)
    del eng

    # (c) mamba2-130m, DIRECT_HBM, against phase 7's fused engine
    m_model, m_params = ssm_engine.model, ssm_engine.params
    m_prompts = [ClosedLoopClient(i, m_model.cfg.vocab_size,
                                  prompt_len=(64, 2048))
                 .make_request().prompt_tokens for i in range(4)]
    fused, _ = serve_all(ssm_engine, m_prompts, 32)
    eng = DisaggregatedEngine(m_model, m_params, max_batch=8, max_seq=2048,
                              device=m_model.device)
    ops.reset_launches()
    reqs, rsps = serve_all(eng, m_prompts, 32)
    torch.cuda.synchronize()
    launches, c = dict(ops.LAUNCHES), eng.counters()
    if launches != structure(c, SSM_LAYERS, ssm=True):
        raise AssertionError(f"(mamba2) launches {launches}")
    if [r.generated for r in reqs] != [r.generated for r in fused]:
        raise AssertionError("(mamba2) tokens differ from the fused engine's")
    m_template = meta_cache(torch, m_model, 8, 2048)
    per_req = extent_wire_bytes(torch, m_template, 1, 16,
                                TransferMode.DIRECT_HBM)
    staged = extent_wire_bytes(torch, m_template, 1, 16,
                               TransferMode.HOST_STAGED)
    if (per_req != MAMBA_REQUEST_WIRE or c["handoffs"] != 4
            or c["handoff_wire_bytes"] != 4 * MAMBA_REQUEST_WIRE):
        raise AssertionError(f"(mamba2) {c['handoffs']} handoffs, "
                             f"{c['handoff_wire_bytes']} wire bytes")
    out["mamba2"] = {"counters": c, "launches": launches,
                     "prompt_lens": [len(p) for p in m_prompts],
                     "wire_bytes_per_request": per_req,
                     "host_staged_bytes_per_request": staged,
                     "hop_ms": eng.handoff_wall_s * 1e3,
                     "wire_gb_s": c["handoff_wire_bytes"]
                     / eng.handoff_wall_s / 1e9}
    print(f"   (mamba2, direct_hbm) tokens == the fused engine's; 4 handoffs "
          f"of {per_req} wire bytes each (HOST_STAGED would move {staged}); "
          f"hop {eng.handoff_wall_s * 1e3:.3f} ms in all, "
          f"{out['mamba2']['wire_gb_s']:.2f} GB/s", flush=True)
    del eng
    return out


# --------------------------------------------------------------------------- #
# phase 10
# --------------------------------------------------------------------------- #
def served_way(torch, ops, model, params, prompts, new, *, want, waves=1,
               profile=None, **kw):
    """Build a warmed ServingEngine(max_batch=8, max_seq=2048, ``kw``) on
    ``model``, serve ``prompts`` (all submitted at once; with ``waves=2``
    the first ``len(prompts) // 2`` first, to prime a prefix index) and
    hold the last wave's kernel launches to ``want(counters delta)``.
    With ``profile`` (a wave of prompts) it then profiles engine steps on
    live rows (:func:`live_step_profile`). Returns (tokens, record,
    engine)."""
    from repro_torch.serving import ServingEngine

    gc.collect()  # an earlier engine's cycles would count in this peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, params, max_batch=8, max_seq=2048,
                        device=model.device, warmup=True, **kw)
    if waves == 2:
        serve_all(eng, prompts[0], new)
        prompts = prompts[1]
    tokens, rec = served_once(torch, ops, eng, prompts, new, want)
    replays, steps = rec["graph_replays"], rec["measured"]["decode_steps"]
    graph = eng.pool.use_graph and not eng.legacy
    if replays != (steps if graph else 0) or (
            graph != (eng.pool._graph is not None)):
        raise AssertionError(f"{replays} graph replays for {steps} decode "
                             f"dispatches (graph {graph})")
    rec.update(warm_s=eng.warm_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile is not None:
        rec["step_profile"] = live_step_profile(torch, eng, profile, new,
                                                key=None)
    return tokens, rec, eng


def graph_line(name, rec):
    prof = rec.get("step_profile", {})
    busy = prof.get("device_busy_ms_per_step")
    print(f"   ({name}) warm {rec['warm_s']:.2f} s; TPOT p50 "
          f"{rec['tpot_ms']['p50']:.2f} ms, p99 {rec['tpot_ms']['p99']:.2f} "
          f"ms; TTFT p50 {rec['ttft_ms_p50']:.2f} ms; "
          + (f"a live step: host wall {prof['host_wall_ms_per_step']:.2f} "
             f"ms, device busy " + ("not measured" if not busy else
                                    f"{busy:.2f} ms") + "; "
             if prof else "")
          + f"{rec['graph_replays']} replays for "
          f"{rec['measured']['decode_steps']} decode steps; peak device "
          f"memory {rec['peak_mem_gb']:.2f} GB", flush=True)


def graph_path(torch, ops, llama, shared, ssm_engine):
    """Phase 10: the decode step as one CUDA graph against the eager step
    (``_graph=False``), every engine warmed (``warmup=True``): (a) phase
    4's traffic eager, graph and under the legacy loop; graph tokens ==
    eager tokens, legacy's parted from them only at a top-2 gap under
    LOGIT_LIMIT; launch counts equal to the path's structure (the graph's
    counted through its replays, one replay a decode dispatch); TPOT
    p50/p99, TTFT p50, a live step's host wall and device busy time, and
    peak device memory each way; (b) phase 6 (c)'s paged traffic with
    prefix reuse, graph against eager and against phase 6 (c)'s tokens;
    (c) phase 7's mamba2-130m traffic, graph against eager; (d) sampling at
    temperature 0.8, top_k 50, graph against eager."""
    from repro_torch.serving.client import ClosedLoopClient

    model, params = llama
    prompts = main_prompts(model.cfg.vocab_size)
    out = {"main": {}}
    tokens = {}
    L = N_LAYERS

    def legacy_want(d):
        n = len(prompts)  # one exact prefill a request, no prefill call counted
        return {"rmsnorm": (2 * L + 1) * (n + d["decode_steps"]),
                "flash_attention": L * n,
                "decode_attention": L * d["decode_steps"],
                "paged_decode_attention": 0, "ssd_scan": 0, "preprocess": 0,
                "mla_decode_attention": 0, "paged_mla_decode_attention": 0,
                "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0}

    for way, kw in (("eager", dict(_graph=False)), ("graph", {}),
                    ("legacy", dict(legacy=True))):
        want = legacy_want if way == "legacy" else (
            lambda d: structure(d, L))
        tokens[way], rec, eng = served_way(
            torch, ops, model, params, prompts, 32, want=want,
            profile=prompts[:8], **kw)
        del eng
        out["main"][way] = rec
        graph_line(way, rec)
    if tokens["graph"] != tokens["eager"]:
        bad = [i for i, (a, b) in enumerate(zip(tokens["graph"],
                                                tokens["eager"])) if a != b]
        raise AssertionError(f"(a) graph tokens differ from eager tokens in "
                             f"requests {bad}")
    print(f"   (a) graph == eager on all {12 * 32} tokens")
    out["main_graph_tokens"] = tokens["graph"]  # phase 11 (b)'s reference
    out["main"]["legacy"]["parted"] = parted(
        torch, model, params, prompts, tokens["graph"], tokens["legacy"],
        "legacy", ref="the fast path")

    # (b) phase 6 (c)'s traffic, paged with reuse
    tokens = {}
    for way, kw in (("eager", dict(_graph=False)), ("graph", {})):
        tokens[way], rec, eng = served_way(
            torch, ops, model, params, (shared["primes"], shared["prompts"]),
            shared["new"], waves=2, paged=True,
            want=lambda d: structure(d, L, "paged_decode_attention"),
            profile=shared["prompts"][:8], **kw)
        if rec["measured"]["prefix_hits"] != len(shared["prompts"]):
            raise AssertionError(f"(b) {rec['measured']['prefix_hits']} hits")
        del eng
        out.setdefault("paged", {})[way] = rec
        graph_line(f"paged {way}", rec)
    if not tokens["graph"] == tokens["eager"] == shared["reuse_tokens"]:
        raise AssertionError("(b) paged tokens: graph, eager and phase 6 (c) "
                             "differ")
    print(f"   (b) paged graph == eager == phase 6 (c) on all "
          f"{len(shared['prompts']) * shared['new']} tokens")

    # (c) phase 7's mamba2-130m traffic
    m_model, m_params = ssm_engine.model, ssm_engine.params
    m_prompts = [ClosedLoopClient(i, m_model.cfg.vocab_size,
                                  prompt_len=(64, 2048))
                 .make_request().prompt_tokens for i in range(12)]
    tokens = {}
    for way, kw in (("eager", dict(_graph=False)), ("graph", {})):
        tokens[way], rec, eng = served_way(
            torch, ops, m_model, m_params, m_prompts, 32,
            want=lambda d: structure(d, SSM_LAYERS, ssm=True),
            profile=m_prompts[:8], **kw)
        del eng
        out.setdefault("ssm", {})[way] = rec
        graph_line(f"mamba2 {way}", rec)
    if tokens["graph"] != tokens["eager"]:
        raise AssertionError("(c) mamba2-130m graph tokens differ from eager")
    print(f"   (c) mamba2-130m graph == eager on all {12 * 32} tokens")

    # (d) sampling
    tokens = {}
    for way, kw in (("eager", dict(_graph=False)), ("graph", {})):
        tokens[way], rec, eng = served_way(
            torch, ops, model, params, prompts[:8], 32, temperature=0.8,
            top_k=50, sample_seed=1, want=lambda d: structure(d, L), **kw)
        del eng
        out.setdefault("sampled", {})[way] = rec
    if tokens["graph"] != tokens["eager"]:
        raise AssertionError("(d) sampled graph tokens differ from eager")
    print(f"   (d) temperature 0.8, top_k 50: graph == eager on all "
          f"{8 * 32} tokens ({len({t for r in tokens['graph'] for t in r})} "
          "distinct)")
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phase 11
# --------------------------------------------------------------------------- #
def cluster_schedule(vocab):
    """Phase 11 (c)-(d)'s arrivals, drawn anew (a Request is served once)."""
    from repro_torch.serving.loadgen import poisson_schedule

    return poisson_schedule(vocab, **CLUSTER_TRAFFIC)


def slo_ms(rsps):
    from repro_torch.core.metrics import slo_summary

    slo = slo_summary(rsps)
    return {"ttft_ms_p50": slo["ttft_s"]["p50"] * 1e3,
            "ttft_ms_p99": slo["ttft_s"]["p99"] * 1e3,
            "tpot_ms_p50": slo["tpot_s"]["p50"] * 1e3,
            "tpot_ms_p99": slo["tpot_s"]["p99"] * 1e3}


def summed_counters(engines):
    out = {}
    for eng in engines:
        for k, v in eng.counters().items():
            out[k] = out.get(k, 0) + v
    return out


def traced_runs(torch, ops, eng, prompts):
    """Phase 11 (a): phase 4's 12 requests on a warmed engine four times,
    tracing off, on, on, off. Gates: equal tokens every run; for each
    traced run an empty ``reconcile`` and ``tree_problems``, one submit,
    queue, prefill.* and request span a request and at least one
    decode.window; launches equal to the path's structure."""
    from repro_torch.core import trace

    runs, tokens = [], []
    for i, on in enumerate((False, True, True, False)):
        if on:
            trace.enable_tracing(process="main")
        c0 = eng.counters()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        reqs, rsps = serve_all(eng, prompts, 32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = eng.counters()
        want = structure({k: c[k] - c0[k] for k in c}, N_LAYERS)
        if dict(ops.LAUNCHES) != want:
            raise AssertionError(f"(a) run {i}: launches {dict(ops.LAUNCHES)}"
                                 f" != path structure {want}")
        rec = {"tracing": on, "drain_wall_s": wall, **slo_ms(rsps)}
        if on:
            tr = trace.Trace.from_buffer()
            trace.disable_tracing()
            ids = {r.request_id for r in reqs}
            records = [r for r in eng.store.records if r.request_id in ids]
            problems = tr.reconcile(records) + tr.tree_problems()
            if problems:
                raise AssertionError(f"(a) run {i}: {problems[:5]}")
            for r in reqs:
                names = [x.name for x in tr.by_request()[r.request_id]]
                got = {k: names.count(k) for k in ("submit", "queue",
                                                   "request")}
                got["prefill"] = sum(n.startswith("prefill.") for n in names)
                if set(got.values()) != {1}:
                    raise AssertionError(f"(a) request {r.request_id}'s "
                                         f"spans {got}")
            windows = sum(x.name == "decode.window" for x in tr.spans)
            if windows < 1:
                raise AssertionError("(a) no decode.window span")
            rec.update(spans=len(tr), decode_windows=windows,
                       trace_stats=trace.tracer().stats())
            if i == 1:
                out_dir = ROOT / "chiprun_out"
                out_dir.mkdir(exist_ok=True)
                tr.export_chrome(out_dir / "phase11_trace.json")
                print("   stage summary of the first traced run (Chrome "
                      "trace in chiprun_out/phase11_trace.json):")
                for line in tr.stage_summary().splitlines():
                    print(f"     {line}")
        runs.append(rec)
        tokens.append([list(r.generated) for r in reqs])
        print(f"   (a) run {i} tracing {'on ' if on else 'off'}: drain "
              f"{wall * 1e3:.2f} ms, TPOT p50 {rec['tpot_ms_p50']:.3f} ms, "
              f"TTFT p50 {rec['ttft_ms_p50']:.2f} ms"
              + (f", {rec['spans']} spans" if on else ""), flush=True)
    if any(t != tokens[0] for t in tokens):
        raise AssertionError("(a) tokens differ between the four runs")

    def mean(key, on):
        xs = [r[key] for r in runs if r["tracing"] == on]
        return sum(xs) / len(xs)

    overhead = {k: mean(k, True) / mean(k, False) - 1
                for k in ("drain_wall_s", "tpot_ms_p50")}
    print(f"   (a) tokens equal in all four runs; tracing on/off: drain wall "
          f"{overhead['drain_wall_s'] * 100:+.2f}%, TPOT p50 "
          f"{overhead['tpot_ms_p50'] * 100:+.2f}%")
    return {"runs": runs, "overhead": overhead}


def pipeline_live_step(torch, pipe, prompts, new, steps=10):
    """Live decode steps under the pipeline: one wave of ``max_batch``
    requests, 3 steps let out, then a window of ``steps`` finalized steps
    (a ``record_function`` range on this thread). torch.profiler is
    started and stopped only while the pipeline is idle -- starting or
    stopping it while another thread runs torch ops can deadlock -- so it
    covers the whole wave, and the window's device busy time is the CUDA
    kernels' time clipped to the range. Host wall a step is the window
    over its steps, the idle share 1 - busy / window."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    def wait_steps(n, deadline_s=60.0):
        """Until ``n`` more steps were finalized; a pipeline thread's
        failure re-raises here (``idle``), a stall past the deadline or a
        wave that ends first fails."""
        s0, t0 = pipe.steps, time.perf_counter()
        while pipe.steps < s0 + n:
            snap = pipe.load_snapshot()
            if pipe.idle or not (snap["occupancy"] or snap["queue_depth"]):
                raise AssertionError(f"(b) the wave ended before {n} more "
                                     f"decode steps: {snap}")
            if time.perf_counter() - t0 > deadline_s:
                raise AssertionError(f"(b) the pipeline stalled: {snap}")
            time.sleep(0.0002)
        return pipe.steps - s0

    if not pipe.idle:
        raise AssertionError("(b) the profiler starts on an idle pipeline")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for t in prompts[:pipe.max_batch]:
            pipe.submit(Request(prompt_tokens=t.copy(), max_new_tokens=new))
        wait_steps(3)
        with record_function("pipeline_window"):
            t0 = time.perf_counter()
            n = wait_steps(steps)
            wall_ms = (time.perf_counter() - t0) * 1e3
        pipe.run_until_drained(max_steps=10_000_000)  # idle again
    win = next(e for e in prof.events() if e.name == "pipeline_window")
    lo, hi = win.time_range.start, win.time_range.end
    busy_us = sum(max(min(e.time_range.end, hi) - max(e.time_range.start, lo),
                      0) for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA)
    res = {"steps": n, "host_wall_ms_per_step": wall_ms / n,
           "device_busy_ms_per_step": busy_us / 1e3 / n if busy_us else None,
           "device_idle_share": (1 - busy_us / 1e3 / wall_ms)
           if busy_us else None}
    print(f"   profiled window: host wall {res['host_wall_ms_per_step']:.2f} "
          f"ms/step over {n} finalized steps, "
          + (f"busy {res['device_busy_ms_per_step']:.2f} ms/step, idle share "
             f"{res['device_idle_share']:.3f}" if busy_us else
             "the profiler reported no device time: busy not measured"))
    return res


def pipeline_run(torch, ops, eng, prompts, want_tokens):
    """Phase 11 (b): EnginePipeline over the warmed engine of (a), phase
    4's 12 requests submitted at once. Gates: tokens equal to phase 10
    (a)'s graph tokens exactly, submitted == emitted == 12, every record
    complete, one graph replay a decode dispatch."""
    from repro_torch.serving import EnginePipeline, Request

    c0, replays0 = eng.counters(), eng.pool.graph_replays
    torch.cuda.synchronize()
    ops.reset_launches()
    with EnginePipeline(eng) as pipe:
        reqs = [Request(prompt_tokens=t.copy(), max_new_tokens=32)
                for t in prompts]
        for r in reqs:
            pipe.submit(r)
        rsps = pipe.run_until_drained(max_steps=10_000_000)
        torch.cuda.synchronize()
        c = eng.counters()
        delta = {k: c[k] - c0[k] for k in c}
        replays = eng.pool.graph_replays - replays0
        launches = dict(ops.LAUNCHES)
        conserved = (pipe.submitted, pipe.emitted)
    if conserved != (12, 12) or len(rsps) != 12:
        raise AssertionError(f"(b) submitted, emitted {conserved}, "
                             f"{len(rsps)} responses")
    got = [list(r.generated) for r in reqs]
    if got != want_tokens:
        bad = [i for i, (a, b) in enumerate(zip(got, want_tokens)) if a != b]
        raise AssertionError(f"(b) pipeline tokens differ from phase 10 "
                             f"(a)'s graph tokens in requests {bad}")
    ids = {r.request_id for r in reqs}
    for rec in (r for r in eng.store.records if r.request_id in ids):
        if not (rec.t_done > rec.t_issue and {"queue", "preprocess",
                                               "inference"} <= set(rec.stage_s)):
            raise AssertionError(f"(b) record {rec.request_id} incomplete")
    if replays != delta["decode_steps"]:
        raise AssertionError(f"(b) {replays} replays for "
                             f"{delta['decode_steps']} decode dispatches")
    if launches != structure(delta, N_LAYERS):
        raise AssertionError(f"(b) launches {launches} != "
                             f"{structure(delta, N_LAYERS)}")
    print("   (b) a live step of the step() loop:")
    loop_step = live_step_profile(torch, eng, prompts, 32, key=None)
    print("   (b) a live step of the pipeline (the same wave):")
    with EnginePipeline(eng) as pipe:
        pipe_step = pipeline_live_step(torch, pipe, prompts, 32)
    res = {"counters": delta, "graph_replays": replays, "launches": launches,
           **slo_ms(rsps), "live_step": pipe_step, "loop_live_step": loop_step}
    print(f"   (b) tokens == phase 10 (a)'s on all 384; submitted == emitted "
          f"== 12; {replays} replays for {delta['decode_steps']} dispatches; "
          f"TPOT p50 {res['tpot_ms_p50']:.3f} ms, p99 "
          f"{res['tpot_ms_p99']:.3f}, TTFT p50 {res['ttft_ms_p50']:.2f} ms; a "
          f"live step: pipeline host wall "
          f"{pipe_step['host_wall_ms_per_step']:.2f} ms, busy "
          f"{pipe_step['device_busy_ms_per_step'] or float('nan'):.2f}; "
          f"step() loop {loop_step['host_wall_ms_per_step']:.2f} ms, busy "
          f"{loop_step['device_busy_ms_per_step'] or float('nan'):.2f}",
          flush=True)
    return res


def hop_charges(gw, rec, tokens):
    """The modelled stages ``gw`` (a Gateway over GDR engines) puts on a
    record with its engine's: (request, response) seconds."""
    from repro_torch.core.transport import Transport

    prof = gw.profile
    req = (prof.wire_time(Transport.GDR, rec.bytes_in)
           + prof.wire_time(gw.first_hop, rec.bytes_in) + gw.overhead)
    rsp = (prof.wire_time(Transport.GDR, rec.bytes_out)
           + prof.wire_time(gw.first_hop, 4 * tokens) + gw.overhead)
    return req, rsp


def gateway_cluster(torch, ops, model, params, eng):
    """Phase 11 (c): Gateway(TCP) -> ServingCluster of 2 in-process fused
    replicas sharing the params (GDR, round_robin, warmed) on
    CLUSTER_TRAFFIC, the sampler on. Gates: each request's tokens equal
    the single engine ``eng``'s on the same prompts or part only at a
    top-2 gap under LOGIT_LIMIT; routed counts sum to 12; every record's
    request and response stages carry the modelled TCP hop; launches equal
    the replicas' summed path structure."""
    from repro_torch.core.transport import Transport
    from repro_torch.serving import Gateway, ServingCluster, run_open_loop

    vocab = model.cfg.vocab_size
    prompts = [a.request.prompt_tokens for a in cluster_schedule(vocab)]
    single, _ = serve_all(eng, prompts, 32)
    want = [list(r.generated) for r in single]
    cl = ServingCluster.build(model, params, n_replicas=2,
                              policy="round_robin", warmup=True,
                              device=model.device, max_batch=8, max_seq=2048)
    engines = [rep.engine for rep in cl.replicas]
    c0 = summed_counters(engines)
    torch.cuda.synchronize()
    ops.reset_launches()
    sched = cluster_schedule(vocab)
    cl.start_sampler(interval_s=0.002)
    gw = Gateway(cl, first_hop=Transport.TCP)
    t0 = time.perf_counter()
    rsps = run_open_loop(gw, sched)
    wall = time.perf_counter() - t0
    cl.stop_sampler()
    torch.cuda.synchronize()
    c = summed_counters(engines)
    delta = {k: c[k] - c0[k] for k in c}
    launches = dict(ops.LAUNCHES)
    if launches != structure(delta, N_LAYERS):
        raise AssertionError(f"(c) launches {launches} != "
                             f"{structure(delta, N_LAYERS)}")
    routed = [rep.routed for rep in cl.replicas]
    if sum(routed) != 12 or len(rsps) != 12:
        raise AssertionError(f"(c) routed {routed}, {len(rsps)} responses")
    by_id = {r.request_id: r.tokens for r in rsps}
    for a in sched:
        rec = cl._records[a.request.request_id]
        req, rsp = hop_charges(gw, rec, len(by_id[a.request.request_id]))
        if (abs(rec.stage_s["request"] - req) > 1e-9 * req
                or abs(rec.stage_s["response"] - rsp) > 1e-9 * rsp):
            raise AssertionError(f"(c) record {rec.request_id}: request "
                                 f"{rec.stage_s['request']} / response "
                                 f"{rec.stage_s['response']} s, the modelled "
                                 f"TCP hop gives {req} / {rsp}")
    got = [list(by_id[a.request.request_id]) for a in sched]
    parts = parted(torch, model, params, prompts, want, got, "(c) cluster",
                   ref="the single engine")
    tel = cl.telemetry()
    slo = tel["slo"]
    print(f"   (c) {wall:.2f} s for 12 open-loop arrivals at "
          f"{CLUSTER_TRAFFIC['rate_rps']:g}/s; routed {routed}; Jain "
          f"busy {tel['balance_index_busy']}, routed "
          f"{tel['balance_index_routed']}; TTFT p50/p99 "
          f"{slo['ttft_s']['p50'] * 1e3:.2f} / {slo['ttft_s']['p99'] * 1e3:.2f}"
          f" ms, TPOT p50/p99 {slo['tpot_s']['p50'] * 1e3:.3f} / "
          f"{slo['tpot_s']['p99'] * 1e3:.3f} ms, E2E p50/p99 "
          f"{slo['e2e_s']['p50'] * 1e3:.1f} / {slo['e2e_s']['p99'] * 1e3:.1f}"
          f" ms, queue p50/p99 {slo['queue_s']['p50'] * 1e3:.2f} / "
          f"{slo['queue_s']['p99'] * 1e3:.2f} ms", flush=True)
    print(f"   (c) per replica {tel['per_replica']}")
    for name, h in sorted(tel["obs"]["histograms"].items()):
        print(f"   (c) sampler {name}: {h['count']} samples, mean "
              f"{h['mean']:.2f}, p50 {h['p50']:.1f}, p95 {h['p95']:.1f}, "
              f"max {h['max']:.0f}")
    res = {"wall_s": wall, "routed": routed, "counters": delta,
           "launches": launches, "parted": parts,
           "telemetry": {k: tel[k] for k in (
               "slo", "per_replica", "balance_index_busy",
               "balance_index_routed", "obs", "parallelism")},
           **slo_ms(rsps)}
    cl.close()
    return res, prompts, got


def prefix_routing(torch, ops, model, params, shared):
    """Phase 11 (e): phase 6's shared-prefix traffic on 2 in-process paged
    replicas with prefix reuse under ``prefix_cache``: the priming wave,
    then the 24 prompts. Gates: each system-prompt family lands wholly on
    one replica; tokens equal phase 6 (c)'s or part only at a top-2 gap
    under LOGIT_LIMIT; launches equal the paged path's structure (kernel
    4 runs); zero live blocks on each replica once its index is
    cleared."""
    from repro_torch.serving import Request, ServingCluster

    cl = ServingCluster.build(model, params, n_replicas=2,
                              policy="prefix_cache", device=model.device,
                              max_batch=8, max_seq=2048, paged=True)
    engines = [rep.engine for rep in cl.replicas]
    new = shared["new"]

    def wave(prompts):
        reqs = [Request(prompt_tokens=t.copy(), max_new_tokens=new)
                for t in prompts]
        for r in reqs:
            cl.submit(r)
        if len(cl.run_until_drained(max_steps=1_000_000)) != len(reqs):
            raise AssertionError("(e) a request did not return")
        return reqs

    wave(shared["primes"])
    c0 = summed_counters(engines)
    torch.cuda.synchronize()
    ops.reset_launches()
    reqs = wave(shared["prompts"])
    torch.cuda.synchronize()
    c = summed_counters(engines)
    delta = {k: c[k] - c0[k] for k in c}
    launches = dict(ops.LAUNCHES)
    want = structure(delta, N_LAYERS, "paged_decode_attention")
    if launches != want or launches["paged_decode_attention"] == 0:
        raise AssertionError(f"(e) launches {launches} != {want}")
    plen = PAGED_TRAFFIC["prefix_len"]
    fams = {}
    for r in reqs:
        fams.setdefault(r.prompt_tokens[:plen].tobytes(), set()).add(
            cl.replica_of(r.request_id))
    if any(len(v) != 1 for v in fams.values()):
        raise AssertionError(f"(e) a family spans replicas: "
                             f"{[sorted(v) for v in fams.values()]}")
    got = [list(r.generated) for r in reqs]
    parts = parted(torch, model, params, shared["prompts"],
                   shared["reuse_tokens"], got, "(e) prefix_cache",
                   ref="phase 6 (c)")
    live = [clear_index(eng) for eng in engines]
    if any(live):
        raise AssertionError(f"(e) {live} blocks live after clearing the "
                             "indexes")
    routed = [rep.routed for rep in cl.replicas]
    print(f"   (e) families -> replicas "
          f"{[sorted(v)[0] for v in fams.values()]}; routed {routed} "
          f"(primes included); prefix hits {delta['prefix_hits']} of "
          f"{len(reqs)}; paged decode launches "
          f"{launches['paged_decode_attention']}; 0 live blocks after the "
          "indexes are cleared", flush=True)
    cl.close()
    return {"routed": routed, "counters": delta, "launches": launches,
            "parted": parts, "families": len(fams)}


def cluster_path(torch, ops, llama, shared, graph_tokens):
    """Phase 11 on phase 4's model and weights, in this process: (a)
    tracing, (b) EnginePipeline, (c) Gateway(TCP) -> 2-replica cluster,
    (e) prefix_cache routing. Returns the results and what the process
    sub-phase (d) needs: the config, the weights' checksum, (c)'s prompts
    and tokens."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.ipc import weight_checksum

    model, params = llama
    prompts = main_prompts(model.cfg.vocab_size)
    eng = ServingEngine(model, params, max_batch=8, max_seq=2048,
                        device=model.device, warmup=True)
    out = {}
    out["tracing"] = traced_runs(torch, ops, eng, prompts)
    out["pipeline"] = pipeline_run(torch, ops, eng, prompts, graph_tokens)
    out["pipeline"]["step_loop"] = {
        k: sum(r[k] for r in out["tracing"]["runs"] if not r["tracing"]) / 2
        for k in ("tpot_ms_p50", "tpot_ms_p99", "ttft_ms_p50")}
    out["gateway_cluster"], c_prompts, c_tokens = gateway_cluster(
        torch, ops, model, params, eng)
    del eng
    out["prefix_cache"] = prefix_routing(torch, ops, model, params, shared)
    handoff = {"cfg": model.cfg, "checksum": weight_checksum(params),
               "prompts": c_prompts, "tokens": c_tokens,
               "slo": {k: out["gateway_cluster"][k] for k in
                       ("ttft_ms_p50", "tpot_ms_p50")}}
    return out, handoff


def process_path(torch, handoff):
    """Phase 11 (d): CLUSTER_TRAFFIC through Gateway(TCP) -> 2 worker
    processes on the card (round_robin, warmed, weights rebuilt from seed
    0), with this process's models freed. Gates: each worker's weight
    checksum equals phase 4's params'; tokens equal (c)'s or part only at
    a top-2 gap under LOGIT_LIMIT; submitted == emitted and payload bytes
    conserved per worker; no worker loaded JAX or ``repro``; close()
    reaps both processes."""
    from repro_torch.core.transport import Transport
    from repro_torch.models import Model
    from repro_torch.serving import Gateway, ServingCluster, run_open_loop

    model = Model(handoff["cfg"], device="cuda")  # no params in this process
    t0 = time.perf_counter()
    with ServingCluster.build(model, None, n_replicas=2, backend="process",
                              policy="round_robin", warmup=True,
                              param_seed=0, max_batch=8,
                              max_seq=2048) as pc:
        build_s = time.perf_counter() - t0
        infos = [rep.init_info for rep in pc.replicas]
        if any(i["checksum"] != handoff["checksum"] for i in infos):
            raise AssertionError(f"(d) worker weight checksums "
                                 f"{[i['checksum'][:12] for i in infos]} != "
                                 f"{handoff['checksum'][:12]}")
        sched = cluster_schedule(model.cfg.vocab_size)
        t1 = time.perf_counter()
        rsps = run_open_loop(Gateway(pc, first_hop=Transport.TCP), sched)
        wall = time.perf_counter() - t1
        tel = pc.telemetry()
        workers = [rep.client.telemetry() for rep in pc.replicas]
        procs = [rep.client.proc for rep in pc.replicas]
    if any(p.poll() is None for p in procs):
        raise AssertionError("(d) close() left a worker running")
    if len(rsps) != 12:
        raise AssertionError(f"(d) {len(rsps)} responses")
    for row in tel["ipc"]:
        if (row["submitted"] != row["emitted"]
                or row["request_payload_bytes"] != row["submitted_bytes"]):
            raise AssertionError(f"(d) conservation {row}")
    foreign = [w["foreign_modules"] for w in workers]
    if any(foreign):
        raise AssertionError(f"(d) a worker loaded {foreign}")
    # the Request objects crossed to the workers: tokens come back in the
    # responses
    by_id = {r.request_id: r.tokens for r in rsps}
    got = [list(by_id[a.request.request_id]) for a in sched]
    parts = []
    if got != handoff["tokens"]:  # rebuild the weights only to judge a part
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(0))
        parts = parted(torch, model, params, handoff["prompts"],
                       handoff["tokens"], got, "(d) process replicas",
                       ref="(c)")
        del params
    peaks = [w["peak_mem_bytes"] / 1e9 for w in workers]
    res = {"build_s": build_s, "wall_s": wall, "init": [
        {k: i[k] for k in ("init_s", "warm_s", "device")} for i in infos],
        "ipc": tel["ipc"], "worker_peak_mem_gb": peaks, "parted": parts,
        "routed": [row["submitted"] for row in tel["ipc"]], **slo_ms(rsps)}
    print(f"   (d) 2 workers built in {build_s:.2f} s (init "
          f"{[round(i['init_s'], 2) for i in infos]} s, warm "
          f"{[round(i['warm_s'], 2) for i in infos]} s); checksums == phase "
          f"4's; {wall:.2f} s for 12 arrivals; tokens "
          f"{'== (c)' if not parts else 'part at near ties'}; TTFT p50 "
          f"{res['ttft_ms_p50']:.2f} ms against (c)'s "
          f"{handoff['slo']['ttft_ms_p50']:.2f}, TPOT p50 "
          f"{res['tpot_ms_p50']:.3f} against {handoff['slo']['tpot_ms_p50']:.3f}"
          f"; workers' peak device memory "
          f"{[round(x, 2) for x in peaks]} GB; no JAX in either; both "
          "reaped", flush=True)
    return res


# --------------------------------------------------------------------------- #
# phase 12: feature payloads (pixtral-12b) and the MoE layer (grok-1-314b)
# --------------------------------------------------------------------------- #
def pix_requests(vocab):
    """PIX_TRAFFIC as (prompt, features) lists: seeded prompts, and seeded
    fp32 patch embeddings [1, F, FRONTEND_DIM] (None for a text turn)."""
    import numpy as np

    from repro_torch.models import FRONTEND_DIM

    rng = np.random.default_rng(0)
    prompts, feats = [], []
    for s, f in PIX_TRAFFIC:
        prompts.append(rng.integers(0, vocab, s, dtype=np.int32))
        feats.append(rng.standard_normal((1, f, FRONTEND_DIM),
                                         dtype=np.float32) if f else None)
    return prompts, feats


def served_once(torch, ops, eng, prompts, new, want, features=None):
    """One drain of ``prompts`` on ``eng`` (all submitted at once), its
    launches held to ``want(counters delta)``: (tokens, record)."""
    from repro_torch.core.metrics import slo_summary

    c0, replays0 = eng.counters(), eng.pool.graph_replays
    torch.cuda.synchronize()
    ops.reset_launches()
    reqs, rsps = serve_all(eng, prompts, new, features)
    torch.cuda.synchronize()
    launches, c = dict(ops.LAUNCHES), eng.counters()
    delta = {k: c[k] - c0[k] for k in c}
    if launches != want(delta):
        raise AssertionError(f"launches {launches} != path structure "
                             f"{want(delta)}")
    slo = slo_summary(rsps)
    rec = {"measured": delta, "launches": launches,
           "graph_replays": eng.pool.graph_replays - replays0,
           "ttft_ms_p50": slo["ttft_s"]["p50"] * 1e3,
           "tpot_ms": {p: slo["tpot_s"][p] * 1e3 for p in ("p50", "p99")},
           "stage_means_ms": {k: v * 1e3 for k, v in
                              eng.store.stage_means().items()}}
    return [list(r.generated) for r in reqs], rec


def weights_gb(params):
    return sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9


def vlm_path(torch, ops, dev):
    """Phase 12 (a): pixtral-12b at published widths and depth (40 layers,
    random bf16 weights from seed 0), PIX_TRAFFIC through the bucketed
    engine (feature requests on the exact path), the warmed engine (its
    decode step a captured graph) and DisaggregatedEngine under each
    mechanism (a warm pass, then a measured pass): launch counts to the
    path (flash 40 a prefill call, decode 40 a step, rmsnorm 81 a
    forward), the prefill counters to PIX_CALLS / PIX_PADDED /
    PIX_PROMPT_TOKENS (prompt tokens, not frames), warmed tokens == the
    bucketed engine's, the direct mechanisms' too, HOST_STAGED's first
    tokens, each handoff's extent to PIX_EXTENTS and its wire bytes to
    PIX_WIRE and to a host-side sum, the requests' bytes to their F + S
    prefixes."""
    from repro_torch.configs import get_config
    from repro_torch.core.transfer import TransferMode
    from repro_torch.models import Model
    from repro_torch.serving import DisaggregatedEngine, ServingEngine

    cfg = get_config("pixtral-12b")
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gb = weights_gb(params)
    print(f"   pixtral-12b: {L} layers, {gb:.2f} GB of bf16 weights",
          flush=True)
    prompts, feats = pix_requests(cfg.vocab_size)
    want = lambda d: structure(d, L)  # noqa: E731
    out, tokens = {"weights_gb": gb}, {}

    def check_counts(name, d):
        got = (d["prefill_calls"], d["prefill_padded_tokens"],
               d["prefill_tokens_total"])
        if got != (PIX_CALLS, PIX_PADDED, PIX_PROMPT_TOKENS):
            raise AssertionError(f"({name}) prefill calls, padded rows, "
                                 f"prompt tokens {got} != "
                                 f"{(PIX_CALLS, PIX_PADDED, PIX_PROMPT_TOKENS)}")

    for name, kw in (("bucketed", {}), ("warmed", dict(warmup=True))):
        eng = ServingEngine(model, params, max_batch=8, max_seq=2048,
                            device=dev, **kw)
        tokens[name], rec = served_once(torch, ops, eng, prompts, 32, want,
                                        feats)
        check_counts(name, rec["measured"])
        if name == "warmed":
            if rec["graph_replays"] != rec["measured"]["decode_steps"]:
                raise AssertionError(f"(warmed) {rec['graph_replays']} "
                                     "replays for "
                                     f"{rec['measured']['decode_steps']} steps")
            print("   (warmed) a graphed decode step of the drained engine:")
            rec["decode_profile"] = decode_profile(torch, eng)
        rec["warm_s"] = eng.warm_s
        out[name] = rec
        print(f"   ({name}) {rec['measured']['prefill_calls']} prefill calls, "
              f"{rec['measured']['prefill_padded_tokens']} padded token-rows "
              f"for {rec['measured']['prefill_tokens_total']} prompt tokens, "
              f"{rec['measured']['decode_steps']} decode steps; TTFT p50 "
              f"{rec['ttft_ms_p50']:.2f} ms, TPOT p50 "
              f"{rec['tpot_ms']['p50']:.3f} ms; launches {rec['launches']}",
              flush=True)
        del eng
    if tokens["warmed"] != tokens["bucketed"]:
        raise AssertionError("(warmed) tokens differ from the unwarmed "
                             "engine's")
    out["launches"] = out["bucketed"]["launches"]

    template = meta_cache(torch, model, 8, 2048)
    true_lens = [s + f for s, f in PIX_TRAFFIC]
    for mode in DISAGG_MODES:
        eng = DisaggregatedEngine(model, params, max_batch=8, max_seq=2048,
                                  device=dev,
                                  transfer_mode=TransferMode(mode))
        extents = record_extents(eng)
        serve_all(eng, prompts, 32, feats)  # warm: the hop's buffers grow
        hop0 = eng.handoff_wall_s
        tokens[mode], rec = served_once(torch, ops, eng, prompts, 32, want,
                                        feats)
        d = rec["measured"]
        check_counts(mode, d)
        per = [extent_wire_bytes(torch, template, n, p, TransferMode(mode))
               for n, p in extents]
        c = eng.counters()
        if (extents != PIX_EXTENTS * 2 or d["handoff_wire_bytes"] != sum(
                per[len(PIX_EXTENTS):]) or d["handoff_wire_bytes"]
                != PIX_WIRE[mode] or c["handoff_wire_bytes"] != sum(per)):
            raise AssertionError(
                f"({mode}) extents {extents}, {d['handoff_wire_bytes']} wire "
                f"bytes a pass; worked out by hand: {PIX_EXTENTS}, "
                f"{PIX_WIRE[mode]}")
        req_bytes = sum(eng.request_handoff_bytes(n) for n in true_lens)
        if d["handoff_request_bytes"] != req_bytes:
            raise AssertionError(f"({mode}) request bytes "
                                 f"{d['handoff_request_bytes']} != the F + S "
                                 f"prefixes' {req_bytes}")
        rec.update(extents=extents[:len(PIX_EXTENTS)],
                   hop_ms=1e3 * (eng.handoff_wall_s - hop0))
        out[mode] = rec
        print(f"   ({mode}) {len(PIX_EXTENTS)} handoffs a pass "
              f"{extents[:len(PIX_EXTENTS)]}, {d['handoff_wire_bytes']} wire "
              f"bytes (== by hand and the host-side sum), "
              f"{d['handoff_request_bytes']} request bytes (F + S); TTFT p50 "
              f"{rec['ttft_ms_p50']:.2f} ms, TPOT p50 "
              f"{rec['tpot_ms']['p50']:.3f} ms, 'transfer' mean "
              f"{rec['stage_means_ms'].get('transfer', 0.0):.3f} ms",
              flush=True)
        del eng
    for mode in ("direct_hbm", "direct_dma"):
        if tokens[mode] != tokens["bucketed"]:
            raise AssertionError(f"({mode}) tokens differ from the fused "
                                 "engine's")
    if ([t[0] for t in tokens["host_staged"]]
            != [t[0] for t in tokens["bucketed"]]):
        raise AssertionError("(host_staged) a first token differs")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"   warmed, direct_hbm, direct_dma == bucketed on all "
          f"{len(prompts) * 32} tokens; host_staged's first tokens equal; "
          f"peak device memory {out['peak_mem_gb']:.2f} GB", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vlm_card_vs_cpu(torch, dev):
    """Phase 12 (a), card vs CPU: pixtral-12b at full width cut to 2
    layers, bf16, two rows of 128 feature frames and 24 prompt tokens
    (one exact [2, 152] prefill), then 4 decode steps, held to
    LOGIT_LIMIT."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import FRONTEND_DIM, Model
    from repro_torch.models.kvcache import grow_cache
    from repro_torch.models.schema import tree_map

    cfg = dataclasses.replace(get_config("pixtral-12b"), n_layers=2)
    gpu = Model(cfg, device=dev)
    params = gpu.init(torch.Generator(device=dev).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                         dtype=torch.int32)
    feats = torch.randn((2, 128, FRONTEND_DIM), generator=g)
    first = []
    for model, p, d in ((gpu, params, dev), (cpu, params_cpu, "cpu")):
        lg, c, n = model.prefill(p, toks.to(d), feats.to(d))
        first.append((lg, grow_cache(c, 512), n))
    if first[0][2].tolist() != [152, 152]:
        raise AssertionError(f"lengths {first[0][2].tolist()} != F + S")
    res = walk_logits(torch, dev, gpu, params, cpu, params_cpu, *first, 4)
    del gpu, params, params_cpu, first
    torch.cuda.empty_cache()
    return res


def moe_card_vs_cpu(torch, dev, arch="grok-1-314b", n_layers=1, nodrop=False,
                    limit=LOGIT_LIMIT):
    """Phase 12 (b), card vs CPU: grok-1-314b at full width cut to 1 layer
    (phase 13: deepseek-v2-236b cut to its first 2, a dense layer and an
    MoE one; phase 14: jamba-v0.1-52b cut to its first 4, two of them MoE,
    ``nodrop`` at the capacity factor where nothing drops and held to
    FP32_LOGIT_LIMIT), fp32 (TF32 off), a ragged bucketed prefill of 64 and
    41 tokens (a stack with SSM layers, which right-padding would reach:
    an exact prefill of two rows of 64) then 4 decode steps, held to
    ``limit``; every router call's top-k choices on the card are compared
    with the CPU's, and the flipped (token, slot) choices are counted and
    printed."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model, moe
    from repro_torch.models.kvcache import grow_cache
    from repro_torch.models.schema import tree_map

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    if nodrop:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    n_moe = sum(cfg.layer_is_moe(i) for i in range(n_layers))
    gpu = Model(cfg, dtype=torch.float32, device=dev)
    params = gpu.init(torch.Generator(device=dev).manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    calls = []  # (device type, ids): each side's calls, card first
    topk = moe.router_topk

    def recorded(logits, k):
        w, ids = topk(logits, k)
        calls.append((logits.device.type, ids.cpu()))
        return w, ids

    g = torch.Generator().manual_seed(1)
    if gpu.attention_only:
        lens = [64, 41]
        toks = torch.zeros((2, 64), dtype=torch.int32)
        for i, n in enumerate(lens):
            toks[i, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=g)
        lens_t = torch.tensor(lens, dtype=torch.int32)

        def prefill(model, p, d):
            return model.prefill_bucketed(p, toks.to(d), lens_t.to(d))
    else:
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                             dtype=torch.int32)

        def prefill(model, p, d):
            return model.prefill(p, toks.to(d))
    moe.router_topk = recorded
    try:
        first = []
        for model, p, d in ((gpu, params, dev), (cpu, params_cpu, "cpu")):
            lg, c, n = prefill(model, p, d)
            first.append((lg, grow_cache(c, 256), n))
        res = walk_logits(torch, dev, gpu, params, cpu, params_cpu, *first,
                          4, limit=limit)
    finally:
        moe.router_topk = topk
    sides = [d for d, _ in calls]
    if sides != ([dev.type] * n_moe + ["cpu"] * n_moe) * 5:
        raise AssertionError(f"router calls {sides}: not each MoE layer's "
                             "card and CPU calls for the prefill and each "
                             "step")
    card = [ids for d, ids in calls if d != "cpu"]
    host = [ids for d, ids in calls if d == "cpu"]
    flips = sum(int((a != b).sum()) for a, b in zip(card, host))
    total = sum(a.numel() for a in card)
    res.update(router_flips=flips, router_choices=total)
    print(f"   router: {flips} flipped (token, slot) choices of {total} "
          "(prefill + 4 decode steps)", flush=True)
    del gpu, params, params_cpu, first
    torch.cuda.empty_cache()
    return res


def moe_timing(torch, params, cfg, dev):
    """The MoE layer's device time at a decode step's 8 rows and an
    [8, 1024] bucket's 8192 rows (layer 0's bf16 weights, random rows):
    router + slot plan, gather, the expert products and combine, each
    alone and the layer whole (CUDA events), with the expert products'
    bound (all E experts' weights read, C slots each)."""
    from repro_torch.models import moe

    p = params["decoder"]["g0"][0]["l0"]["moe"]
    m = cfg.moe
    g = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for T in (8, 8192):
        x = torch.randn((T, cfg.d_model), generator=g, device=dev,
                        dtype=torch.bfloat16)
        w, ids, _, pos, keep, slot_tok = moe.route(p, cfg, x)
        xe = moe.gather_tokens(x, slot_tok)
        ye = moe.expert_ffn(p, xe)
        C = moe.capacity(T, m)
        nbytes = (3 * m.n_experts * cfg.d_model * m.d_ff * 2
                  + 2 * m.n_experts * C * cfg.d_model * 2)
        flops = 2 * 3 * m.n_experts * C * cfg.d_model * m.d_ff
        rec = {"rows": T, "capacity": C,
               "route_ms": time_ms(torch, lambda: moe.route(p, cfg, x)),
               "gather_ms": time_ms(torch,
                                    lambda: moe.gather_tokens(x, slot_tok)),
               "experts_ms": time_ms(torch, lambda: moe.expert_ffn(p, xe)),
               "combine_ms": time_ms(torch, lambda: moe.combine(
                   ye, w, ids, pos, keep, x.dtype)),
               "layer_ms": time_ms(torch, lambda: moe.moe_apply(p, cfg, x)),
               "experts_bound_ms": _rl().bound(nbytes, flops, "bf16")[0],
               "experts_bound_by": _rl().bound(nbytes, flops, "bf16")[1]}
        out[T] = rec
        print(f"   MoE layer at {T} rows (C = {C}): router + plan "
              f"{rec['route_ms']:.4f} ms, gather {rec['gather_ms']:.4f}, "
              f"expert products {rec['experts_ms']:.4f} (bound "
              f"{rec['experts_bound_ms']:.4f}, {rec['experts_bound_by']}), "
              f"combine {rec['combine_ms']:.4f}; the layer "
              f"{rec['layer_ms']:.4f} ms", flush=True)
    return out


def moe_path(torch, ops, dev):
    """Phase 12 (b): grok-1-314b at published widths, GROK_LAYERS of 64
    layers, random bf16 weights from seed 0, phase 4's 12 requests served
    bucketed, eager (``_graph=False``), warmed, paged and packed at the
    config's capacity factor, then bucketed and packed at the capacity
    factor where nothing drops (E / K): launch counts to the path (flash 2
    a prefill call, decode or paged decode 2 a step, rmsnorm 5 a forward),
    eager and warmed tokens == bucketed exactly (the same rows, so the
    same drops), paged == bucketed or parted at a top-2 gap under
    LOGIT_LIMIT, packed against bucketed reported (drops differ between
    the two, as in JAX) and, without drops, gated as paged is; a graphed
    decode step's device time beside its byte bound; the MoE layer's time
    split (:func:`moe_timing`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine

    full = get_config("grok-1-314b")
    cfg = dataclasses.replace(full, n_layers=GROK_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gb = weights_gb(params)
    layer_gb = weights_gb(params["decoder"]) / GROK_LAYERS
    print(f"   grok-1-314b: {GROK_LAYERS} of {full.n_layers} layers, "
          f"{gb:.2f} GB of bf16 weights ({layer_gb:.3f} a layer; "
          f"{gb + (full.n_layers - GROK_LAYERS) * layer_gb:.1f} at full "
          "depth)", flush=True)
    prompts = main_prompts(cfg.vocab_size)
    L = GROK_LAYERS
    out, tokens = {"weights_gb": gb, "layer_gb": layer_gb}, {}
    nodrop = Model(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)),
        device=dev)
    ways = (("bucketed", model, {}), ("eager", model, dict(_graph=False)),
            ("warmed", model, dict(warmup=True)),
            ("paged", model, dict(paged=True)),
            ("packed", model, dict(packed=True)),
            ("bucketed_nodrop", nodrop, {}),
            ("packed_nodrop", nodrop, dict(packed=True)))
    for name, m, kw in ways:
        decode = ("paged_decode_attention" if kw.get("paged")
                  else "decode_attention")
        eng = ServingEngine(m, params, max_batch=8, max_seq=2048, device=dev,
                            **kw)
        tokens[name], rec = served_once(
            torch, ops, eng, prompts, 32,
            lambda d, decode=decode: structure(d, L, decode))
        if name == "warmed":
            if rec["graph_replays"] != rec["measured"]["decode_steps"]:
                raise AssertionError(f"(warmed) {rec['graph_replays']} "
                                     "replays for "
                                     f"{rec['measured']['decode_steps']} steps")
            print("   (warmed) a graphed decode step of the drained engine "
                  "(8 rows: every expert's C = 8 slots):")
            rec["decode_profile"] = decode_profile(torch, eng)
        rec["warm_s"] = eng.warm_s
        out[name] = rec
        print(f"   ({name}) {rec['measured']['prefill_calls']} prefill calls,"
              f" {rec['measured']['prefill_padded_tokens']} padded "
              f"token-rows, {rec['measured']['decode_steps']} decode steps; "
              f"TTFT p50 {rec['ttft_ms_p50']:.2f} ms, TPOT p50 "
              f"{rec['tpot_ms']['p50']:.3f} ms", flush=True)
        del eng
    for name in ("eager", "warmed"):
        if tokens[name] != tokens["bucketed"]:
            raise AssertionError(f"({name}) tokens differ from the bucketed "
                                 "(graph) engine's")
    print(f"   eager, warmed == bucketed (graph) on all {12 * 32} tokens")
    out["paged"]["parted"] = parted(torch, model, params, prompts,
                                    tokens["bucketed"], tokens["paged"],
                                    "paged")
    out["packed"]["parted"] = parted(torch, model, params, prompts,
                                     tokens["bucketed"], tokens["packed"],
                                     "packed (drops differ; reported)",
                                     gate=False)
    out["packed_nodrop"]["parted"] = parted(
        torch, nodrop, params, prompts, tokens["bucketed_nodrop"],
        tokens["packed_nodrop"], "packed_nodrop",
        ref="the no-drop bucketed run")
    out["launches"] = out["bucketed"]["launches"]
    out["launches_paged"] = out["paged"]["launches"]
    # a decode step reads every weight once: all E experts of each layer
    # (C >= 8 slots each), attention, norms, the tied table for the head
    step_bytes = gb * 1e9
    prof = out["warmed"]["decode_profile"]
    out["decode_bound_ms"] = step_bytes / _rl().HBM_BW * 1e3
    print(f"   a decode step's byte bound {out['decode_bound_ms']:.3f} ms "
          f"({step_bytes / 1e9:.2f} GB of weights at {_rl().HBM_BW:.3g} B/s)"
          f"; the graphed step's device busy "
          + ("not measured" if not prof["device_busy_ms_per_step"] else
             f"{prof['device_busy_ms_per_step']:.3f} ms, idle share "
             f"{prof['device_idle_share']:.3f}"), flush=True)
    out["moe_timing"] = moe_timing(torch, params, cfg, dev)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"   peak device memory {out['peak_mem_gb']:.2f} GB", flush=True)
    del model, nodrop, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phase 13
# --------------------------------------------------------------------------- #
def mla_card_vs_cpu_bf16(torch, dev):
    """Phase 13, card vs CPU in bf16: deepseek-v2-236b at full width cut to
    layer 0 (MLA and the dense FFN), a ragged bucketed prefill of 64 and 41
    tokens, then 4 decode steps on a 256-slot ring, held to LOGIT_LIMIT."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.kvcache import grow_cache
    from repro_torch.models.schema import tree_map

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=1)
    gpu = Model(cfg, device=dev)
    params = gpu.init(torch.Generator(device=dev).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu"), params)
    lens = [64, 41]
    g = torch.Generator().manual_seed(1)
    toks = torch.zeros((2, 64), dtype=torch.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=g)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    first = []
    for model, p, d in ((gpu, params, dev), (cpu, params_cpu, "cpu")):
        lg, c, n = model.prefill_bucketed(p, toks.to(d), lens_t.to(d))
        first.append((lg, grow_cache(c, 256), n))
    res = walk_logits(torch, dev, gpu, params, cpu, params_cpu, *first, 4)
    del gpu, params, params_cpu, first
    torch.cuda.empty_cache()
    return res


def mla_path(torch, ops, dev):
    """Phase 13: deepseek-v2-236b at published widths, MLA_LAYERS of 60
    layers (layer 0's dense FFN, then MoE with 160 experts, top-6, 2
    shared), random bf16 weights from seed 0, phase 4's 12 requests served
    bucketed (the graph), eager (``_graph=False``), warmed, paged (which
    MLA runs without prefix reuse), legacy and with ``packed=True,
    prefill_chunk=256`` (both must report off), then through
    DisaggregatedEngine under each mechanism (a warm pass, then a measured
    pass): launch counts to the path (flash 3 a prefill call, the MLA
    decode kernel or its paged twin 3 a step, rmsnorm 4L + 1 = 13 a
    forward), eager, warmed and packed/chunked tokens == bucketed exactly,
    paged == bucketed or parted at a top-2 gap under LOGIT_LIMIT, legacy
    against bucketed reported (gated in fp32 by :func:`mla_legacy_fp32`),
    the direct mechanisms' tokens == bucketed, HOST_STAGED's
    first tokens, the handoffs' extents == RING_EXTENTS and wire bytes ==
    MLA_WIRE (1,152 bytes a token a layer) and a host-side sum; TTFT and
    TPOT p50 a path; a graphed decode step's device time, idle share, byte
    bound and the MLA decode kernel's share; the handoff's bytes a token
    against llama3-8b's and GDR's TTFT saving against RDMA and TCP."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.transfer import TransferMode
    from repro_torch.models import Model
    from repro_torch.serving import DisaggregatedEngine, ServingEngine

    full = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS)
    L = MLA_LAYERS
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gb = weights_gb(params)
    print(f"   deepseek-v2-236b: {L} of {full.n_layers} layers, {gb:.2f} GB "
          f"of bf16 weights ({full.param_count() * 2 / 1e9:.0f} GB at full "
          "depth)", flush=True)
    prompts = main_prompts(cfg.vocab_size)
    out, tokens = {"weights_gb": gb}, {}
    ways = (("bucketed", {}), ("eager", dict(_graph=False)),
            ("warmed", dict(warmup=True)), ("paged", dict(paged=True)),
            ("legacy", dict(legacy=True)),
            ("packed_chunked", dict(packed=True, prefill_chunk=256)))

    for name, kw in ways:
        decode = ("paged_mla_decode_attention" if kw.get("paged")
                  else "mla_decode_attention")
        eng = ServingEngine(model, params, max_batch=8, max_seq=2048,
                            device=dev, **kw)
        if eng.packed or eng._chunk_enabled or eng.prefix_reuse:
            raise AssertionError(f"({name}) packed {eng.packed}, chunked "
                                 f"{eng._chunk_enabled}, prefix reuse "
                                 f"{eng.prefix_reuse}: MLA turns all off")
        tokens[name], rec = served_once(
            torch, ops, eng, prompts, 32,
            lambda d, decode=decode, exact=len(prompts) if kw.get(
                "legacy") else None: mla_structure(d, L, decode, exact))
        if name == "warmed":
            if rec["graph_replays"] != rec["measured"]["decode_steps"]:
                raise AssertionError(f"(warmed) {rec['graph_replays']} "
                                     "replays for "
                                     f"{rec['measured']['decode_steps']} steps")
            print("   (warmed) a graphed decode step of the drained engine:")
            rec["decode_profile"] = decode_profile(torch, eng,
                                                   key="mla_decode")
        rec["warm_s"] = eng.warm_s
        out[name] = rec
        print(f"   ({name}) {rec['measured']['prefill_calls']} prefill calls,"
              f" {rec['measured']['prefill_padded_tokens']} padded "
              f"token-rows, {rec['measured']['decode_steps']} decode steps; "
              f"TTFT p50 {rec['ttft_ms_p50']:.2f} ms, TPOT p50 "
              f"{rec['tpot_ms']['p50']:.3f} ms; launches {rec['launches']}",
              flush=True)
        del eng
    for name in ("eager", "warmed", "packed_chunked"):
        if tokens[name] != tokens["bucketed"]:
            raise AssertionError(f"({name}) tokens differ from the bucketed "
                                 "(graph) engine's")
    print(f"   eager, warmed, packed/chunked (off) == bucketed (graph) on all "
          f"{12 * 32} tokens")
    out["paged"]["parted"] = parted(torch, model, params, prompts,
                                    tokens["bucketed"], tokens["paged"],
                                    "paged")
    # legacy prefills each request alone, so its expert slots are not the
    # padded batch's and it drops other choices (as JAX's legacy loop
    # does), and in bf16 its other prefill shapes round differently, which
    # flips near-tied router choices among 160 experts: reported here,
    # gated in fp32 without drops (mla_legacy_fp32)
    out["legacy"]["parted"] = parted(
        torch, model, params, prompts, tokens["bucketed"], tokens["legacy"],
        "legacy (drops and rounding differ; reported)", gate=False)

    template = meta_cache(torch, model, 8, 2048)
    for mode in DISAGG_MODES:
        eng = DisaggregatedEngine(model, params, max_batch=8, max_seq=2048,
                                  device=dev,
                                  transfer_mode=TransferMode(mode))
        extents = record_extents(eng)
        serve_all(eng, prompts, 32)  # warm: the hop's buffers grow
        hop0 = eng.handoff_wall_s
        tokens[mode], rec = served_once(torch, ops, eng, prompts, 32,
                                        lambda d: mla_structure(d, L))
        d = rec["measured"]
        per = [extent_wire_bytes(torch, template, n, p, TransferMode(mode))
               for n, p in extents]
        c = eng.counters()
        if (extents != RING_EXTENTS * 2 or d["handoff_wire_bytes"] != sum(
                per[len(RING_EXTENTS):]) or d["handoff_wire_bytes"]
                != MLA_WIRE[mode] or c["handoff_wire_bytes"] != sum(per)):
            raise AssertionError(
                f"({mode}) extents {extents}, {d['handoff_wire_bytes']} wire "
                f"bytes a pass; worked out by hand: {RING_EXTENTS}, "
                f"{MLA_WIRE[mode]}")
        req_bytes = sum(eng.request_handoff_bytes(n) for n in MAIN_LENS)
        if d["handoff_request_bytes"] != req_bytes:
            raise AssertionError(f"({mode}) request bytes "
                                 f"{d['handoff_request_bytes']} != "
                                 f"{req_bytes}")
        rec.update(hop_ms=1e3 * (eng.handoff_wall_s - hop0))
        out[mode] = rec
        print(f"   ({mode}) {len(RING_EXTENTS)} handoffs a pass, "
              f"{d['handoff_wire_bytes']} wire bytes (== by hand and the "
              f"host-side sum), hop {rec['hop_ms']:.3f} ms a pass; TTFT p50 "
              f"{rec['ttft_ms_p50']:.2f} ms, TPOT p50 "
              f"{rec['tpot_ms']['p50']:.3f} ms", flush=True)
        del eng
    for mode in ("direct_hbm", "direct_dma"):
        if tokens[mode] != tokens["bucketed"]:
            raise AssertionError(f"({mode}) tokens differ from the fused "
                                 "engine's")
    if ([t[0] for t in tokens["host_staged"]]
            != [t[0] for t in tokens["bucketed"]]):
        raise AssertionError("(host_staged) a first token differs")
    ttft = {m: out[m]["ttft_ms_p50"] for m in DISAGG_MODES}
    out["gdr_ttft_saving"] = {
        "vs_rdma": 1 - ttft["direct_hbm"] / ttft["direct_dma"],
        "vs_tcp": 1 - ttft["direct_hbm"] / ttft["host_staged"]}
    llama_token = GQA_TOKEN_LAYER_BYTES * N_LAYERS
    out["handoff_bytes_a_token"] = {
        "deepseek_cut": MLA_TOKEN_LAYER_BYTES * L,
        "deepseek_full": MLA_TOKEN_LAYER_BYTES * full.n_layers,
        "llama3_8b": llama_token}
    print(f"   direct mechanisms == bucketed on all {12 * 32} tokens, "
          f"host_staged's first tokens equal; a token's handoff "
          f"{MLA_TOKEN_LAYER_BYTES} B a layer ({MLA_TOKEN_LAYER_BYTES * L} "
          f"here, {MLA_TOKEN_LAYER_BYTES * full.n_layers} at 60 layers) "
          f"against llama3-8b's {GQA_TOKEN_LAYER_BYTES} a layer "
          f"({llama_token}); GDR saves "
          f"{100 * out['gdr_ttft_saving']['vs_rdma']:.1f}% of TTFT p50 "
          f"against RDMA, {100 * out['gdr_ttft_saving']['vs_tcp']:.1f}% "
          "against TCP", flush=True)
    # a decode step reads every weight once: every expert of the MoE
    # layers (C = 8 slots each at 8 rows), the attention's, the norms', the
    # tied table for the head
    prof = out["warmed"]["decode_profile"]
    out["decode_bound_ms"] = gb * 1e9 / _rl().HBM_BW * 1e3
    busy = prof["device_busy_ms_per_step"]
    out["mla_kernel_share"] = (prof["kernel_ms_per_step"] / busy
                               if busy else None)
    print(f"   a decode step's byte bound {out['decode_bound_ms']:.3f} ms "
          f"({gb:.2f} GB at {_rl().HBM_BW:.3g} B/s); the graphed step's "
          "device busy " + ("not measured" if not busy else
                            f"{busy:.3f} ms, idle share "
                            f"{prof['device_idle_share']:.3f}, the MLA decode "
                            f"kernel {prof['kernel_ms_per_step']:.4f} ms "
                            f"({out['mla_kernel_share']:.3f} of busy)"),
          flush=True)
    out["launches"] = out["bucketed"]["launches"]
    out["launches_paged"] = out["paged"]["launches"]
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"   peak device memory {out['peak_mem_gb']:.2f} GB", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hybrid_structure(c, n_ssm, n_attn, exact=None):
    """Launch counts of a hybrid stack's served run: rmsnorm 3 an SSM layer
    (ln1, the gated norm, ln2), 2 an attention layer and 1 final a forward;
    the SSD scan once an SSM layer and flash once an attention layer a
    prefill call, the decode kernel once an attention layer a step (an SSM
    layer's one-token recurrence launches no kernel); ``exact`` prefills
    that count no prefill call (the legacy loop's, one a request)."""
    calls = c["prefill_calls"] if exact is None else exact
    want = dict.fromkeys(structure(c, 0), 0)
    want.update(
        rmsnorm=(3 * n_ssm + 2 * n_attn + 1) * (calls + c["decode_steps"]),
        ssd_scan=n_ssm * calls, flash_attention=n_attn * calls,
        decode_attention=n_attn * c["decode_steps"])
    return want


def hybrid_path(torch, ops, dev):
    """Phase 14: jamba-v0.1-52b (arXiv:2403.19887) at published widths,
    JAMBA_LAYERS of 32 layers (one period of its interleave: 1 attention +
    MoE, 3 SSM + MoE, 4 SSM + dense; d_state 16 over 128 SSD heads), random
    bf16 weights from seed 0, phase 4's 12 requests through the exact-shape
    admission (one request a prefill call) eager (``_graph=False``),
    warmed (the graph) and legacy, then DisaggregatedEngine under each
    mechanism (a warm pass, then a measured pass): launch counts to the
    path (:func:`hybrid_structure`: ssd_scan 7 and flash 1 a prefill call,
    rmsnorm 24 a forward, ring decode 1 a step), prefill_padded_tokens ==
    the prompt tokens, eager == warmed tokens, legacy == them or parted at
    a top-2 gap under LOGIT_LIMIT, the direct mechanisms' tokens == the
    fused engine's, HOST_STAGED's first tokens, the handoffs' wire bytes
    == JAMBA_WIRE (worked out by hand) and a host-side sum, their request
    bytes == JAMBA_REQUEST; a graphed decode step's device time, idle
    share and byte bound; the SSD kernel's share of a profiled 1024-token
    exact prefill; TTFT and TPOT p50 a path, the hop a pass under each
    mechanism and GDR's TTFT saving against RDMA and TCP."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.transfer import TransferMode
    from repro_torch.models import Model
    from repro_torch.serving import DisaggregatedEngine, ServingEngine

    full = get_config("jamba-v0.1-52b")
    L = JAMBA_LAYERS
    cfg = dataclasses.replace(full, n_layers=L)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(L))
    n_ssm = L - n_attn
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gb = weights_gb(params)
    print(f"   jamba-v0.1-52b: {L} of {full.n_layers} layers ({n_attn} "
          f"attention, {n_ssm} SSM; "
          f"{sum(cfg.layer_is_moe(i) for i in range(L))} MoE), {gb:.2f} GB of "
          f"bf16 weights ({full.param_count() * 2 / 1e9:.0f} GB at full "
          "depth)", flush=True)
    prompts = main_prompts(cfg.vocab_size)
    out, tokens = {"weights_gb": gb}, {}

    def want(exact=None):
        return lambda d: hybrid_structure(d, n_ssm, n_attn, exact)

    for name, kw in (("eager", dict(_graph=False)),
                     ("warmed", dict(warmup=True)),
                     ("legacy", dict(legacy=True))):
        eng = ServingEngine(model, params, max_batch=8, max_seq=2048,
                            device=dev, packed=True, prefill_chunk=256, **kw)
        if not eng.exact_prefill or eng.packed or eng._chunk_enabled:
            raise AssertionError(f"({name}) exact {eng.exact_prefill}, packed "
                                 f"{eng.packed}, chunked {eng._chunk_enabled}:"
                                 " a hybrid stack takes the exact path")
        legacy = bool(kw.get("legacy"))
        tokens[name], rec = served_once(
            torch, ops, eng, prompts, 32, want(len(prompts) if legacy
                                               else None))
        d = rec["measured"]
        if not legacy and (d["prefill_calls"] != len(prompts)
                           or d["prefill_padded_tokens"] != sum(MAIN_LENS)):
            raise AssertionError(f"({name}) {d['prefill_calls']} prefill "
                                 f"calls, {d['prefill_padded_tokens']} padded "
                                 f"token-rows: one exact prefill a request, "
                                 f"{sum(MAIN_LENS)} rows")
        if name == "warmed":
            if rec["graph_replays"] != d["decode_steps"]:
                raise AssertionError(f"(warmed) {rec['graph_replays']} "
                                     f"replays for {d['decode_steps']} steps")
            print("   (warmed) a graphed decode step of the drained engine:")
            rec["decode_profile"] = decode_profile(torch, eng,
                                                   key="decode_split")
            rec["prefill_profile"] = prefill_profile(
                torch, eng, (1, 1024), "ssd_scan", "SSD scan")
        rec["warm_s"] = eng.warm_s
        out[name] = rec
        print(f"   ({name}) {d['prefill_calls']} prefill calls, "
              f"{d['prefill_padded_tokens']} padded token-rows, "
              f"{d['decode_steps']} decode steps; TTFT p50 "
              f"{rec['ttft_ms_p50']:.2f} ms, TPOT p50 "
              f"{rec['tpot_ms']['p50']:.3f} ms; launches {rec['launches']}",
              flush=True)
        del eng
    if tokens["warmed"] != tokens["eager"]:
        raise AssertionError("(warmed) tokens differ from the eager step's")
    print(f"   warmed (graph) == eager on all {12 * 32} tokens")
    out["legacy"]["parted"] = parted(torch, model, params, prompts,
                                     tokens["eager"], tokens["legacy"],
                                     "legacy", ref="the exact path")

    template = meta_cache(torch, model, 8, 2048)
    for mode in DISAGG_MODES:
        eng = DisaggregatedEngine(model, params, max_batch=8, max_seq=2048,
                                  device=dev,
                                  transfer_mode=TransferMode(mode))
        extents = record_extents(eng)
        serve_all(eng, prompts, 32)  # warm: the hop's buffers grow
        hop0 = eng.handoff_wall_s
        tokens[mode], rec = served_once(torch, ops, eng, prompts, 32, want())
        d = rec["measured"]
        per = [extent_wire_bytes(torch, template, n, p, TransferMode(mode))
               for n, p in extents]
        c = eng.counters()
        if (d["handoffs"] != len(prompts)
                or d["handoff_wire_bytes"] != JAMBA_WIRE[mode]
                or d["handoff_wire_bytes"] != sum(per[len(prompts):])
                or c["handoff_wire_bytes"] != sum(per)):
            raise AssertionError(
                f"({mode}) {d['handoffs']} handoffs, "
                f"{d['handoff_wire_bytes']} wire bytes a pass; worked out by "
                f"hand: {len(prompts)}, {JAMBA_WIRE[mode]}; host-side "
                f"{sum(per[len(prompts):])}")
        req_bytes = sum(eng.request_handoff_bytes(n) for n in MAIN_LENS)
        if d["handoff_request_bytes"] != req_bytes or (
                mode != "host_staged" and req_bytes != JAMBA_REQUEST):
            raise AssertionError(f"({mode}) request bytes "
                                 f"{d['handoff_request_bytes']}, by the "
                                 f"template {req_bytes}, by hand "
                                 f"{JAMBA_REQUEST}")
        rec.update(hop_ms=1e3 * (eng.handoff_wall_s - hop0))
        out[mode] = rec
        print(f"   ({mode}) {d['handoffs']} handoffs a pass, "
              f"{d['handoff_wire_bytes']} wire bytes (== by hand and the "
              f"host-side sum), {d['handoff_request_bytes']} of the requests'"
              f" own; hop {rec['hop_ms']:.3f} ms a pass; TTFT p50 "
              f"{rec['ttft_ms_p50']:.2f} ms, TPOT p50 "
              f"{rec['tpot_ms']['p50']:.3f} ms", flush=True)
        del eng
    for mode in ("direct_hbm", "direct_dma"):
        if tokens[mode] != tokens["eager"]:
            raise AssertionError(f"({mode}) tokens differ from the fused "
                                 "engine's")
    if ([t[0] for t in tokens["host_staged"]]
            != [t[0] for t in tokens["eager"]]):
        raise AssertionError("(host_staged) a first token differs")
    ttft = {m: out[m]["ttft_ms_p50"] for m in DISAGG_MODES}
    out["gdr_ttft_saving"] = {
        "vs_rdma": 1 - ttft["direct_hbm"] / ttft["direct_dma"],
        "vs_tcp": 1 - ttft["direct_hbm"] / ttft["host_staged"]}
    kv = 8269 * JAMBA_TOKEN_BYTES
    state = 12 * n_ssm * JAMBA_SSM_BYTES
    out["handoff_split"] = {"kv_bytes": kv, "state_bytes": state,
                            "state_share": state / (kv + state)}
    print(f"   direct mechanisms == the fused engine on all {12 * 32} tokens,"
          f" host_staged's first tokens equal; a pass carries {kv} B of KV "
          f"and {state} B of SSM state ({100 * state / (kv + state):.1f}% "
          f"fixed a request); GDR saves "
          f"{100 * out['gdr_ttft_saving']['vs_rdma']:.1f}% of TTFT p50 "
          f"against RDMA, {100 * out['gdr_ttft_saving']['vs_tcp']:.1f}% "
          "against TCP", flush=True)
    # a decode step reads every weight once (each MoE layer's 16 experts at
    # 8 rows' slots), the tied-free head included
    prof = out["warmed"]["decode_profile"]
    out["decode_bound_ms"] = gb * 1e9 / _rl().HBM_BW * 1e3
    busy = prof["device_busy_ms_per_step"]
    print(f"   a decode step's byte bound {out['decode_bound_ms']:.3f} ms "
          f"({gb:.2f} GB at {_rl().HBM_BW:.3g} B/s); the graphed step's "
          "device busy " + ("not measured" if not busy else
                            f"{busy:.3f} ms ({out['decode_bound_ms'] / busy:.3f}"
                            f" of the bound), idle share "
                            f"{prof['device_idle_share']:.3f}"), flush=True)
    out["launches"] = out["eager"]["launches"]
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"   peak device memory {out['peak_mem_gb']:.2f} GB", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def encdec_path(torch, ops, dev):
    """Phase 15: seamless-m4t-large-v2 (arXiv:2308.11596) at published
    widths and full depth (24 encoder + 24 decoder layers), random bf16
    weights from seed 0, through the Model API (the serving engine refuses
    an encoder-decoder, as the JAX engine has no path for one): each of
    SEAMLESS_BATCHES is a batch of speech-translation requests whose frame
    features arrive precomputed; a prefill encodes them (flash with
    causal=False) and runs the 2-token target prompt through the decoder
    (its cross-attention through flash with Sq != Skv), then 31 decode
    steps (the decode kernel over each layer's ring and over its static
    cross leaves) give 32 greedy tokens. Launch counts to the structure
    (flash 3 x 24 a prefill, the decode kernel 2 x 24 a step, rmsnorm 2 an
    encoder layer + 1, 3 a decoder layer + 1), finite logits, the flash
    kernel's device time in a profiled prefill of the 1024-frame batch
    against its bound; card vs CPU in :func:`encdec_card_vs_cpu`."""
    from repro_torch.configs import get_config
    from repro_torch.models import FRONTEND_DIM, Model
    from repro_torch.models.kvcache import grow_cache
    from repro_torch.serving import ServingEngine

    cfg = get_config("seamless-m4t-large-v2")
    L, E = cfg.n_layers, cfg.encoder_layers
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gb = weights_gb(params)
    print(f"   seamless-m4t-large-v2: {E} encoder + {L} decoder layers, "
          f"{gb:.2f} GB of bf16 weights", flush=True)
    try:
        ServingEngine(model, params, max_batch=4, max_seq=64, device=dev)
    except ValueError as e:
        print(f"   the serving engine refuses it: {e}")
    else:
        raise AssertionError("the serving engine took an encoder-decoder")
    zero = dict.fromkeys(ops.LAUNCHES, 0)
    want_prefill = dict(zero, flash_attention=3 * L,
                        rmsnorm=(2 * E + 1) + (3 * L + 1))
    steps = SEAMLESS_NEW - 1
    want_steps = dict(zero, decode_attention=2 * L * steps,
                      rmsnorm=(3 * L + 1) * steps)
    V = cfg.vocab_size
    g = torch.Generator(device=dev).manual_seed(4)
    out = {"weights_gb": gb, "batches": {}}
    for B, F_ in SEAMLESS_BATCHES:
        feats = torch.randn((B, F_, FRONTEND_DIM), generator=g, device=dev)
        toks = torch.randint(0, V, (B, SEAMLESS_PROMPT), generator=g,
                             device=dev, dtype=torch.int32)
        model.prefill(params, toks, feats)  # warm
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        lg, caches, n = model.prefill(params, toks, feats)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if dict(ops.LAUNCHES) != want_prefill:
            raise AssertionError(f"prefill launches {dict(ops.LAUNCHES)} != "
                                 f"{want_prefill}")
        caches = grow_cache(caches, SEAMLESS_PROMPT + SEAMLESS_NEW)
        xk = caches["g0"][0]["l0"]["xk"]
        if tuple(xk.shape) != (B, F_, Hkv, hd):
            raise AssertionError(f"cross leaf {tuple(xk.shape)}")
        new = [lg[:, :V].argmax(-1).to(torch.int32)]
        ops.reset_launches()
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, caches, n = model.decode_step(params, caches, new[-1][:, None],
                                              n)
            new.append(lg[:, :V].argmax(-1).to(torch.int32))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        if dict(ops.LAUNCHES) != want_steps:
            raise AssertionError(f"decode launches {dict(ops.LAUNCHES)} != "
                                 f"{want_steps}")
        if not torch.isfinite(lg).all():
            raise AssertionError("decode logits not finite")
        rec = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
               "tokens": torch.stack(new, 1).cpu().tolist(),
               "prefill_launches": want_prefill,
               "decode_launches_a_step": {k: v // steps
                                          for k, v in want_steps.items()}}
        out["batches"][f"{B}x{F_}"] = rec
        print(f"   {B} utterances of {F_} frames: prefill {prefill_ms:.2f} ms"
              f" (host wall), {steps} decode steps {step_ms:.3f} ms each; "
              f"{SEAMLESS_NEW} tokens a request; launches as the structure",
              flush=True)
    # the encoder's and the decoder's flash launches in one profiled prefill
    # of the last batch, against their bound
    prof = profile_call(torch, lambda: model.prefill(params, toks, feats),
                        "flash", "flash", f"a {B} x {F_}-frame prefill",
                        [B, F_])
    # (bytes, FLOPs) of each launch, every one counted without the causal
    # mask: the encoder's (bidirectional), the decoder's self-attention over
    # the prompt, the cross-attention
    costs = [_rl().kernel_work("flash_attention", B, Sq, Skv, H, Hkv, hd,
                         causal=False)[::-1]
             for Sq, Skv in ((F_, F_), (SEAMLESS_PROMPT, SEAMLESS_PROMPT),
                             (SEAMLESS_PROMPT, F_))]
    enc_bound = _rl().bound(*costs[0], "bf16")
    total = sum(_rl().bound(*c, "bf16")[0] for c in costs) * L
    prof.update(flash_bound_ms=total, encoder_flash_bound_ms=enc_bound[0],
                encoder_flash_bound_by=enc_bound[1])
    print(f"   flash in that prefill: {prof['kernel_ms']:.3f} ms device time "
          f"for {3 * L} launches against a bound of {total:.3f} ms "
          + (f"({total / prof['kernel_ms']:.3f} of it); " if prof['kernel_ms']
             else "; ")
          + f"the encoder's launch alone bound {enc_bound[0]:.4f} ms "
          f"({enc_bound[1]})", flush=True)
    out["prefill_profile"] = prof
    del model, params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def encdec_card_vs_cpu(torch, dev):
    """Phase 15, card vs CPU: seamless-m4t-large-v2 at full depth, 2
    utterances of 512 frames and a 2-token prompt, then 4 decode steps,
    both sides fed the card's greedy token. The weights are drawn in bf16
    from seed 0 and held in fp32 by the CPU model (TF32 off on the card):
    the card in fp32 on the same values within FP32_LOGIT_LIMIT of the
    largest logit, the card in bf16 within LOGIT_LIMIT."""
    from repro_torch.configs import get_config
    from repro_torch.models import FRONTEND_DIM, Model
    from repro_torch.models.kvcache import grow_cache
    from repro_torch.models.schema import tree_map

    cfg = get_config("seamless-m4t-large-v2")
    bf = Model(cfg, device=dev)
    params_bf = bf.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator().manual_seed(5)
    feats = torch.randn((2, 512, FRONTEND_DIM), generator=g)
    toks = torch.randint(0, cfg.vocab_size, (2, SEAMLESS_PROMPT),
                         generator=g, dtype=torch.int32)
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    params_cpu = tree_map(lambda t: t.to("cpu", torch.float32), params_bf)
    t0 = time.perf_counter()
    lg, c, n = cpu.prefill(params_cpu, toks, feats)
    first_c = (lg, grow_cache(c, 64), n)
    print(f"   CPU prefill (fp32) {time.perf_counter() - t0:.1f} s")
    out = {}
    for name, dtype, limit in (("fp32", torch.float32, FP32_LOGIT_LIMIT),
                               ("bf16", torch.bfloat16, LOGIT_LIMIT)):
        gpu = bf if dtype == torch.bfloat16 else Model(cfg, dtype=dtype,
                                                       device=dev)
        params = (params_bf if dtype == torch.bfloat16 else
                  tree_map(lambda t: t.float(), params_bf))
        lg, c, n = gpu.prefill(params, toks.to(dev), feats.to(dev))
        here = (first_c[0], tree_map(lambda t: t.clone(), first_c[1]),
                first_c[2])
        print(f"   ({name}) the card against the CPU in fp32:")
        out[name] = walk_logits(torch, dev, gpu, params, cpu, params_cpu,
                                (lg, grow_cache(c, 64), n), here, 4,
                                limit=limit)
        del params, c
        torch.cuda.empty_cache()
    del bf, params_bf, params_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mla_structure(c, layers, decode="mla_decode_attention", exact=None):
    """:func:`structure` for an MLA stack (rmsnorm 4L + 1 a forward: ln1,
    ln2, q_norm, kv_norm); ``exact`` prefills that count no prefill call
    (the legacy loop's, one a request)."""
    if exact is not None:
        c = dict(c, prefill_calls=exact)
    return structure(c, layers, decode, mla=True)


def mla_legacy_fp32(torch, ops, dev):
    """Phase 13, the legacy loop held in fp32 (TF32 off): deepseek-v2-236b
    at full width cut to its first 2 layers (a dense layer, an MoE one),
    at the capacity factor where nothing drops (E / K) and max_batch 2 (a
    prefill's expert slots then stay a few GB), phase 4's 12 requests
    bucketed and through ``legacy=True``: launch counts to each path, and
    legacy's tokens == bucketed's or parted at a top-2 gap under
    LOGIT_LIMIT. (In bf16 the two paths' prefill shapes round differently
    and flip near-tied router choices among 160 experts.)"""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine

    full = get_config("deepseek-v2-236b")
    L = 2
    cfg = dataclasses.replace(full, n_layers=L, moe=dataclasses.replace(
        full.moe, capacity_factor=full.moe.n_experts / full.moe.top_k))
    model = Model(cfg, dtype=torch.float32, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = main_prompts(cfg.vocab_size)
    out, tokens = {"weights_gb": weights_gb(params)}, {}
    for name, kw in (("bucketed", {}), ("legacy", dict(legacy=True))):
        eng = ServingEngine(model, params, max_batch=2, max_seq=2048,
                            device=dev, **kw)
        exact = len(prompts) if kw else None
        tokens[name], rec = served_once(
            torch, ops, eng, prompts, 32,
            lambda d, exact=exact: mla_structure(d, L, exact=exact))
        out[name] = rec
        print(f"   (fp32, {name}) {rec['measured']['decode_steps']} decode "
              f"steps; TTFT p50 {rec['ttft_ms_p50']:.2f} ms, TPOT p50 "
              f"{rec['tpot_ms']['p50']:.3f} ms", flush=True)
        del eng
    out["parted"] = parted(torch, model, params, prompts, tokens["bucketed"],
                           tokens["legacy"], "legacy (fp32, no drops)")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phase 16: training
# --------------------------------------------------------------------------- #
STEP_PARTS = (  # kernel-name keys of a profiled training step's parts
    ("flash_attention_fwd", ("flash_wgmma_kernel", "flash_fwd_kernel")),
    ("flash_attention_bwd", ("flash_bwd",)),
    ("ssd_scan_bwd", ("ssd_bwd",)),
    ("ssd_scan_fwd", ("ssd_scan",)),
    ("rmsnorm_bwd", ("rmsnorm_bwd", "rmsnorm_dw")),
    ("rmsnorm", ("rmsnorm",)),
    ("weight_gemms", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "Kernel2")),
)
BWD_PARTS = ("flash_attention_bwd", "ssd_scan_bwd")
# phase 16 (d): the SSM, hybrid and MLA stacks trained at full width, each
# as TRAIN_STEPS steps of (a): (arch, layers, batch, config changes)
TRAIN_FAMILY = (
    # all 24 layers, 0.13B parameters, about 1.6 GB of training state
    ("mamba2-130m", 24, (8, 4096), {}),
    # reduced()'s interleave at full width: layer 0 SSM + dense FFN, layer 1
    # attention + MoE (16 experts, top-2); 3.7B parameters, about 44 GB
    ("jamba-v0.1-52b", 2, (2, 4096), dict(attn_every=2, attn_offset=1)),
    # its first layer: MLA + the dense 12,288 FFN; 1.4B parameters, 17 GB
    ("deepseek-v2-236b", 1, (2, 4096), {}),
)
# (b)'s gates for them: (arch, layers, batch, config changes, the CPU side
# in float64), fp32 on the card; mamba2's 500 positions end in a ragged
# chunk. Through mamba2's 24 random layers the CPU's own fp32 rounding
# grows past the gate (its gradients sit about 2e-4 of a leaf's largest
# from a float64 CPU pass, the card's under 1e-4: the CPU plain version,
# not the kernels, is the far side), so its gate holds the card to the CPU
# model run in float64 and reports the fp32 CPU pass beside it
TRAIN_FAMILY_CHECK = (
    ("mamba2-130m", 24, (1, 500), {}, True),
    ("jamba-v0.1-52b", 2, (1, 256), dict(attn_every=2, attn_offset=1), False),
    ("deepseek-v2-236b", 1, (1, 512), {}, False),
)


# phase 16 (e): the remaining stacks trained on one card at full width, each
# as TRAIN_STEPS steps of (a): (arch, layers, batch [B, tokens], feature
# rows, config changes). The LM head is the embedding table (as in JAX);
# training state at the launcher's 12 bytes a parameter
TRAIN_STACKS = (
    # 2 of 64 layers, 1.75B parameters, 21.0 GB: qk-norm runs rmsnorm and
    # its backward at D 128 over 524,288 q rows and 65,536 k rows a layer
    ("qwen3-32b", 2, (2, 4096), 0, {}),
    # all 30 layers, 4.16B parameters, 49.9 GB: GQA at G = 12
    ("starcoder2-3b", 30, (2, 4096), 0, {}),
    # 2 of 88 layers, 1.36B parameters, 16.3 GB: MQA, G = 48 in the flash
    # backward
    ("granite-34b", 2, (2, 4096), 0, {}),
    # 2 of 40 layers, 1.22B parameters, 14.7 GB: 1024 feature rows ahead of
    # 3072 tokens, the loss over the text suffix
    ("pixtral-12b", 2, (2, 3072), 1024, {}),
    # all 24 + 24 layers, 1.77B parameters, 21.3 GB: the encoder over 1024
    # frames (the flash backward non-causal), the decoder over 1024 tokens
    # and its cross-attention
    ("seamless-m4t-large-v2", 24, (4, 1024), 1024, {}),
)
# (b)'s gates for them, fp32 at 2 layers (seamless 2 + 2): (arch, layers,
# batch [B, tokens], feature rows, config changes). 256 tokens: qwen3's and
# granite's CPU passes over 2 layers at full width took 15.3 and 11.5 s at
# 512 on the card's host
TRAIN_STACK_CHECK = (
    ("qwen3-32b", 2, (1, 256), 0, {}),
    ("starcoder2-3b", 2, (1, 256), 0, {}),
    ("granite-34b", 2, (1, 256), 0, {}),
    ("pixtral-12b", 2, (1, 192), 64, {}),
    ("seamless-m4t-large-v2", 2, (1, 384), 128, dict(encoder_layers=2)),
)


def layer_norms(cfg, i):
    """rmsnorm launches of layer ``i``'s forward: ln1, and ln2 unless the
    stack is of the SSM family; an SSM layer's gate_norm; an MLA layer's
    latent norms (q_norm where the query is low-rank, kv_norm); a GQA
    layer's qk-norm (q_norm and k_norm, one launch each over every head's
    rows); an encoder-decoder's decoder layer's ln_x."""
    n = 1 + (cfg.family != "ssm")
    if cfg.layer_kind(i) == "ssm":
        return n + 1
    if cfg.mla is not None:
        return n + 1 + bool(cfg.mla.q_lora_rank)
    return n + 2 * cfg.qk_norm + cfg.is_encdec


def train_structure(cfg, steps):
    """Launches of ``steps`` training steps of ``cfg``'s decoder stack under
    full remat: every layer's forward runs twice (the pass, then its
    recompute in the backward) and its backward once -- flash per
    attention layer, the SSD scan per SSM layer, rmsnorm per
    :func:`layer_norms` -- and the final norm once each way. An
    encoder-decoder adds its encoder's layers (flash and ln1, ln2 each),
    each decoder layer's cross-attention (flash) and ``enc_norm``."""
    L, E = cfg.n_layers, cfg.encoder_layers
    norms = sum(layer_norms(cfg, i) for i in range(L)) + 2 * E
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(L))
    n_ssm = L - n_attn
    flash = n_attn * (1 + cfg.is_encdec) + E
    once = 1 + cfg.is_encdec  # the final norm, enc_norm
    return {"rmsnorm": (2 * norms + once) * steps,
            "flash_attention": 2 * flash * steps,
            "flash_attention_bwd": flash * steps,
            "rmsnorm_bwd": (norms + once) * steps, "decode_attention": 0,
            "paged_decode_attention": 0, "ssd_scan": 2 * n_ssm * steps,
            "preprocess": 0, "mla_decode_attention": 0,
            "paged_mla_decode_attention": 0, "ssd_scan_bwd": n_ssm * steps}


def train_config(arch, layers, changes):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=layers, **changes)


def train_run(torch, ops, dev, cfg, batch, label, features=0):
    """``repro_torch.training.train``: TRAIN_STEPS AdamW steps of ``cfg``
    (full remat, bf16), ``SyntheticLM`` batches of ``batch``, seed 0 (with
    ``features`` feature rows a row from ``DataConfig(feature_rows=)``: a
    VLM's prepended, an encoder-decoder's its encoder's frames); the
    training state first held to the card by the launcher's
    ``check_fits``; the gates: finite losses and grad norms, the mean of
    the last three losses below the first, launches equal to
    :func:`train_structure`. Returns (its record, model, params, state,
    data, opt)."""
    from repro_torch.launch.train import (
        STATE_BYTES_PER_PARAM,
        check_fits,
        param_count,
    )
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, train
    from repro_torch.training.data import make_dataset

    B, S = batch
    model = Model(cfg, remat=True, remat_policy="full")
    n_params = param_count(model)
    check_fits(model)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                      seed=0, feature_rows=features)
    opt = AdamWConfig(lr=1e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
                      total_steps=TRAIN_STEPS)
    state_gb = STATE_BYTES_PER_PARAM * n_params / 1e9
    print(f"   {label}: {n_params:,} parameters, training state "
          f"{state_gb:.1f} GB; batch [{B}, {S}]"
          + (f" + {features} feature rows" if features else "")
          + f", remat full, {TRAIN_STEPS} steps", flush=True)
    t0 = time.perf_counter()
    next(make_dataset(data).batches())
    data_ms = (time.perf_counter() - t0) * 1e3

    events = []

    def log(msg):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        print(f"   {msg}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    params, state, hist = train(model, data, TrainConfig(
        steps=TRAIN_STEPS, log_every=1, seed=0), opt, log_fn=log)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    marks = [start] + events
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"{label} training: a loss or grad norm not "
                             f"finite: {losses} {norms}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"{label} training: the loss did not fall: "
                             f"{losses}")
    want = train_structure(cfg, TRAIN_STEPS)
    print(f"   launches {launches}; expected {want}")
    if launches != want:
        raise AssertionError(f"{label} training launches {launches} != {want}")
    steady = statistics.median(step_ms[1:])
    # positions a step: a VLM's feature rows pass every decoder layer as its
    # tokens do; an encoder-decoder's frames pass only the encoder, so 6 N T
    # does not count its step and its share of peak is left out
    T = B * (S + features)
    flops = (None if cfg.is_encdec else
             _rl().train_step_flops(cfg, n_params, B, S + features))
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, S],
           "feature_rows": features, "params": n_params, "state_gb": state_gb,
           "losses": losses, "grad_norms": norms, "launches": launches,
           "step_ms": step_ms, "step_ms_median_after_first": steady,
           "tokens_per_s": T / steady * 1e3, "model_flops": flops,
           "mfu": (None if flops is None else
                   flops / (steady / 1e3) / _rl().PEAK_FLOPS["bf16"]),
           "peak_mem_gb": peak / 1e9, "data_batch_host_ms": data_ms}
    share = ("not counted for an encoder-decoder" if flops is None else
             f"model FLOPs {flops / 1e12:.2f} T a step (6 N T + attention), "
             f"{res['mfu']:.3f} of 989 TFLOP/s")
    print(f"   step wall (CUDA events) first {step_ms[0]:.1f} ms, median of "
          f"the rest {steady:.1f} ms; {res['tokens_per_s']:.0f} tokens/s"
          + (" (feature rows counted)" if features else "") + f"; "
          f"{share}; peak device memory {peak / 1e9:.2f} GB; one batch of "
          f"the data pipeline {data_ms:.0f} ms of host time", flush=True)
    return res, model, params, state, data, opt


def train_path(torch, ops, dev):
    """(a) ``repro_torch.training.train``: TRAIN_STEPS AdamW steps of
    llama3-8b at full width, TRAIN_LAYERS of 32 layers, ``SyntheticLM``
    batches of TRAIN_BATCH, full remat; (c) the trained parameters served;
    then one more step profiled, and the parts torch.profiler cannot name
    (cross-entropy, the embedding's backward, the optimizer) timed alone."""
    from repro_torch.models.schema import tree_leaves

    cfg = train_config("llama3-8b", TRAIN_LAYERS, {})
    res, model, params, state, data, opt = train_run(
        torch, ops, dev, cfg, TRAIN_BATCH,
        f"llama3-8b, {TRAIN_LAYERS} of 32 layers at full width")
    if any(p.requires_grad for p in tree_leaves(params)):
        raise AssertionError("train returned parameters that require grad")
    res["serve"] = train_serve(torch, ops, model, params)
    res["profile"] = train_step_profile(torch, model, params, state, data, opt)
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_family_path(torch, ops, dev):
    """(d) TRAIN_FAMILY: mamba2-130m, jamba-v0.1-52b and deepseek-v2-236b
    trained on the card as (a) trains llama3-8b, each with the same gates
    and one more step profiled (device busy by part, the idle share, the
    backward kernels' share of busy)."""
    out = {}
    for arch, layers, batch, changes in TRAIN_FAMILY:
        cfg = train_config(arch, layers, changes)
        res, model, params, state, data, opt = train_run(
            torch, ops, dev, cfg, batch,
            f"(d) {arch}, {layers} layer{'s' * (layers > 1)} at full width")
        res["profile"] = train_step_profile(torch, model, params, state,
                                            data, opt, time_alone=False)
        out[arch] = res
        del model, params, state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_stacks_path(torch, ops, dev):
    """(e) TRAIN_STACKS: qwen3-32b, starcoder2-3b, granite-34b, pixtral-12b
    and seamless-m4t-large-v2 trained on the card as (a) trains llama3-8b,
    each with the same gates (launches from the config, qk-norm's two
    rmsnorm launches a layer counted) and one more step profiled (device
    busy by part, the idle share, peak), each freed before the next."""
    out = {}
    for arch, layers, batch, features, changes in TRAIN_STACKS:
        t0 = time.perf_counter()
        cfg = train_config(arch, layers, changes)
        res, model, params, state, data, opt = train_run(
            torch, ops, dev, cfg, batch,
            f"(e) {arch}, {layers} layer{'s' * (layers > 1)}"
            + (f" + {cfg.encoder_layers} encoder layers" if cfg.is_encdec
               else "") + " at full width", features=features)
        res["profile"] = train_step_profile(torch, model, params, state,
                                            data, opt, time_alone=False,
                                            cpu_ops=False)
        res["run_s"] = time.perf_counter() - t0
        print(f"   (e) {arch}: the run {res['run_s']:.1f} s", flush=True)
        out[arch] = res
        del model, params, state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_serve(torch, ops, model, params):
    """(c) the trained parameters served: 4 of phase 4's prompts, 8 new
    tokens each, through ServingEngine; its launches follow the serving
    path (no backward kernel)."""
    from repro_torch.serving import Request, ServingEngine

    L = model.cfg.n_layers
    eng = ServingEngine(model, params, max_batch=4, max_seq=2048,
                        device=model.device)
    ops.reset_launches()
    for p in main_prompts(model.cfg.vocab_size)[:4]:
        eng.submit(Request(prompt_tokens=p, max_new_tokens=8))
    out = eng.run_until_drained()
    launches = dict(ops.LAUNCHES)
    c = eng.counters()
    if len(out) != 4 or any(len(r.tokens) != 8 for r in out):
        raise AssertionError(f"trained params served {[len(r.tokens) for r in out]}")
    if not eng.logits_all_finite():
        raise AssertionError("trained params: a logit was not finite")
    forwards = c["prefill_calls"] + c["decode_steps"]
    want = {**train_structure(model.cfg, 0),
            "rmsnorm": (2 * L + 1) * forwards,
            "flash_attention": L * c["prefill_calls"],
            "decode_attention": L * c["decode_steps"]}
    print(f"   (c) served 4 requests x 8 tokens on the trained parameters: "
          f"counters {c}; launches {launches}", flush=True)
    if launches != want or not c["decode_steps"]:
        raise AssertionError(f"serving launches {launches} != {want}")
    del eng
    return {"counters": c, "launches": launches,
            "tokens": [r.tokens for r in out]}


def train_step_profile(torch, model, params, state, data, opt, time_alone=True,
                       shard_ctx=None, cpu_ops=True):
    """One more training step under torch.profiler (device busy by part,
    idle share of the step's wall, the backward kernels' share of busy),
    and with ``time_alone`` cross-entropy, the embedding's backward and the
    optimizer's update each timed alone (CUDA events). With ``shard_ctx``
    the step is the sharded one, on params placed for it. ``cpu_ops=False``
    traces the device alone: the host's op events of a step of tens of
    thousands of launches cost the profiler half a minute on an H100."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.layers import cross_entropy
    from repro_torch.models.schema import tree_map
    from repro_torch.training.data import make_dataset
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.steps import make_train_step

    dev = model.device
    p = tree_map(lambda t: t.detach() if shard_ctx is None  # own leaves
                 else t.map_parts(torch.Tensor.detach), params)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in next(make_dataset(data).batches()).items()}
    step = make_train_step(model, opt, shard_ctx)
    p, state, _ = step(p, state, batch)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] * cpu_ops + [ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        p, state, _ = step(p, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        kernels.append((us / 1e3, evt.key, evt.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    parts, left = {}, list(kernels)
    for part, keys in STEP_PARTS:
        parts[part] = sum(k[0] for k in left if matches(keys, k[1]))
        left = [k for k in left if not matches(keys, k[1])]
    parts["other"] = sum(k[0] for k in left)
    bwd = sum(parts[k] for k in BWD_PARTS)
    res = {"host_wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1 - busy / wall_ms if busy else None,
           "parts_ms": parts,
           "flash_bwd_share_of_busy": (parts["flash_attention_bwd"] / busy
                                       if busy else None),
           "bwd_kernels_share_of_busy": bwd / busy if busy else None,
           "top": [{"ms": ms, "name": n[:80], "calls": c}
                   for ms, n, c in kernels[:12]]}
    if busy:
        print(f"   profiled step: host wall {wall_ms:.1f} ms, device busy "
              f"{busy:.1f} ms over {sum(k[2] for k in kernels)} kernels, idle "
              f"share {res['device_idle_share']:.3f}; by kernel name (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
              + f"; the flash backward's share of busy "
              f"{res['flash_bwd_share_of_busy']:.3f}, the backward kernels' "
              f"(flash, SSD) {res['bwd_kernels_share_of_busy']:.3f}")
        for k in res["top"]:
            print(f"   {k['ms']:9.3f} ms  x{k['calls']:<5d} {k['name']}")
    else:
        print(f"   profiled step: host wall {wall_ms:.1f} ms; the profiler "
              "reported no device time: busy and idle not measured")
    if not time_alone:
        del p, state
        return res

    B, S = batch["tokens"].shape
    logits = torch.randn((B, S, params["embed"].shape[0]), device=dev,
                         dtype=model.dtype).requires_grad_(True)
    labels = batch["labels"]
    times = {"cross_entropy_fwd_bwd": time_ms(torch, lambda: torch.autograd.grad(
        cross_entropy(logits, labels), logits), reps=5, warmup=1)}
    del logits
    table = params["embed"].detach().clone().requires_grad_(True)
    emb = F.embedding(batch["tokens"], table)
    g = torch.randn_like(emb)
    times["embedding_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
        emb, table, g, retain_graph=True), reps=5, warmup=1)
    del emb, g, table
    zeros = tree_map(torch.zeros_like, p)
    times["adamw_update"] = time_ms(torch, lambda: adamw_update(
        opt, zeros, state, p), reps=3, warmup=1)
    del zeros, p
    res["alone_ms"] = times
    print(f"   alone (CUDA events, ms): cross-entropy forward + backward over "
          f"[{B}, {S}, {params['embed'].shape[0]}] {times['cross_entropy_fwd_bwd']:.2f}, "
          f"the embedding's backward {times['embedding_bwd']:.2f}, the AdamW "
          f"update {times['adamw_update']:.2f}", flush=True)
    return res


def leaf_gap(cards, cpus):
    """|card - cpu| over the CPU leaf's largest entry: ``cards`` and
    ``cpus`` the leaf's matching blocks (one each for a whole leaf), each
    CPU block copied to its card block's device and both taken in the CPU
    block's dtype there (the card's arithmetic over gigabytes takes a
    fraction of the host's); a leaf whose CPU gradient is all zero (an
    expert no token reached) must be zero on the card too (0 when it is,
    infinity when not)."""
    top = err = 0.0
    for card, cpu in zip(cards, cpus):
        cpu = cpu.to(card.device)
        top = max(top, float(cpu.abs().max()))
        err = max(err, float((card.to(cpu.dtype) - cpu).abs().max()))
    if top:
        return err / top
    return 0.0 if not err else math.inf


# --------------------------------------------------------------------------- #
# phase 20: the examples
# --------------------------------------------------------------------------- #
# the model examples, run as a user runs them on the card: (script, its
# arguments); train_tiny at 50 of its default 200 steps (cut for the smoke's
# time: its loss has fallen by half by then)
EXAMPLES = (("serve_llm_torch.py", []), ("disaggregated_prefill_torch.py", []),
            ("train_tiny_torch.py", ["--steps", "50"]))
EXAMPLE_TIMEOUT_S = 300
# disaggregated_prefill_torch.py's wire bytes a mechanism (reduced llama3-8b
# in bf16, prompts of 6, 11, 19 and 27 tokens, max_batch 2, max_seq 64):
# the JAX tier's DisaggregatedEngine moves the same on the same prompts
EXAMPLE_WIRE = {"direct_hbm": 196_672, "direct_dma": 196_672,
                "host_staged": 98_384}
SERVE_LLM_REQUESTS = 4 * 3  # its default clients x requests a client


def examples_path():
    """Phase 20: ``examples/*_torch.py`` that run a model, each a process
    of its own on the card (EXAMPLES' arguments), started together;
    each must exit 0. serve_llm: every transport completes all its
    requests; disaggregated_prefill: the direct mechanisms' tokens 100% the
    fused engine's, the wire bytes EXAMPLE_WIRE; train_tiny: the loss
    falls."""
    import os
    import re

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    t0 = time.perf_counter()
    for script, args in EXAMPLES:
        procs[script] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / script), *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    try:
        for script, p in procs.items():
            stdout, stderr = p.communicate(timeout=EXAMPLE_TIMEOUT_S)
            out[script] = {"rc": p.returncode,
                           "wall_s": time.perf_counter() - t0,
                           "stdout": stdout[-4000:], "stderr": stderr[-2000:]}
            print(f"   {script}: rc {p.returncode}, done "
                  f"{out[script]['wall_s']:.1f} s after the start", flush=True)
            for line in stdout.strip().splitlines()[-8:]:
                print(f"      {line}")
            if p.returncode:
                print(stderr[-2000:])
                raise AssertionError(f"{script} exited {p.returncode}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    served = [int(n) for n in re.findall(
        r"^\s+\w+\s*: (\d+) requests in", out["serve_llm_torch.py"]["stdout"],
        re.M)]
    if served != [SERVE_LLM_REQUESTS] * 3:
        raise AssertionError(f"serve_llm_torch.py: requests completed a "
                             f"transport {served}, not "
                             f"{SERVE_LLM_REQUESTS} for each of 3")
    text = out["disaggregated_prefill_torch.py"]["stdout"]
    match = dict(re.findall(r"^\s+(\w+)\s+\(.*tokens vs fused engine: "
                            r"(\d+)%", text, re.M))
    wire = json.loads(re.search(r"wire bytes by mechanism: (\{.*\})",
                                text).group(1))
    if match.get("direct_hbm") != "100" or match.get("direct_dma") != "100":
        raise AssertionError(f"disaggregated_prefill_torch.py: tokens vs the "
                             f"fused engine {match}")
    if wire != EXAMPLE_WIRE:
        raise AssertionError(f"disaggregated_prefill_torch.py: wire bytes "
                             f"{wire} != {EXAMPLE_WIRE}")
    first, last = map(float, re.search(
        r"loss ([\d.]+) -> ([\d.]+)",
        out["train_tiny_torch.py"]["stdout"]).groups())
    if not last < first:
        raise AssertionError(f"train_tiny_torch.py: loss {first} -> {last}")
    print(f"   serve_llm: {served} requests a transport; disaggregated: "
          f"tokens vs fused {match}, wire bytes {wire}; train_tiny: loss "
          f"{first} -> {last}", flush=True)
    out["gates"] = {"served": served, "tokens_vs_fused": match,
                    "wire": wire, "loss": [first, last]}
    return out


# --------------------------------------------------------------------------- #
# phase 17: the dry-run launchers
# --------------------------------------------------------------------------- #
DRYRUN_MESHES = (("16x16", []), ("2x16x16", ["--multipod"]))
DRYRUN_JOBS = 4
DRYRUN_TIMEOUT_S = 240


def dryrun_path(train):
    """(a) ``repro_torch.launch.dryrun --all`` and ``--all --multipod``, two
    processes at once (DRYRUN_JOBS workers each), records in the checkout's
    ``experiments/dryrun_torch``: every case OK but JAX's stated skip
    (seamless-m4t's long_500k), then ``repro_torch.launch.report`` on both
    meshes into chiprun_out/phase17_report.md; (b) the 1 x 1 roofline of
    phase 16's step (``train``: its record) beside its measured step, gated
    max(t_compute, t_memory) <= the step."""
    import os

    from repro_torch.configs import ARCHITECTURES, SHAPES
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun, report
    from repro_torch.launch.mesh import make_local_mesh

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--jobs", str(DRYRUN_JOBS), *flags], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in DRYRUN_MESHES}
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    n_cases = len(ARCHITECTURES) * len(SHAPES)
    out = {"wall_s": wall, "meshes": {}}
    for name, proc in procs.items():
        lines = [ln for ln in outs[name].splitlines()
                 if ln.startswith(("OK ", "SKIP ", "FAIL "))]
        for ln in lines:
            print(f"   {ln}")
        ok = sum(ln.startswith("OK ") for ln in lines)
        skips = [ln for ln in lines if ln.startswith("SKIP ")]
        out["meshes"][name] = {"rc": proc.returncode, "ok": ok,
                               "skips": skips, "lines": lines}
        print(f"   dryrun --all on {name}: rc {proc.returncode}, {ok} OK, "
              f"{len(skips)} skipped", flush=True)
        if (proc.returncode or ok != n_cases - 1 or len(skips) != 1
                or "seamless-m4t-large-v2" not in skips[0]
                or "long_500k" not in skips[0]):
            raise AssertionError(f"dryrun --all on {name}: rc "
                                 f"{proc.returncode}, {ok} of {n_cases - 1} "
                                 f"OK, skips {skips}\n{outs[name][-3000:]}")
    print(f"   both meshes' dry-runs together: {wall:.1f} s of wall",
          flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "phase17_report.md").write_text("\n\n".join(
        f"# {name}\n\n## Roofline\n\n{report.roofline_table(name)}\n\n"
        f"## Dry-run\n\n{report.dryrun_table(name)}"
        for name, _ in DRYRUN_MESHES))

    # (b) phase 16's step on one card: 8 layers, [2, 4096], full remat
    cfg = train_config("llama3-8b", TRAIN_LAYERS, {})
    B, S = TRAIN_BATCH
    shape = InputShape("phase16", seq_len=S, global_batch=B, kind="train")
    rec = dryrun.run_case("llama3-8b", cfg_override=cfg, shape=shape,
                          meshes=[make_local_mesh()], save=False,
                          verbose=False)[0]
    step = train["step_ms_median_after_first"]
    t_bound = max(rec["t_compute"], rec["t_memory"]) * 1e3
    one = {k: rec[k] for k in ("t_compute", "t_memory", "t_collective",
                                "hlo_flops", "hlo_bytes", "model_flops",
                                "peak_bytes_per_device",
                                "arg_bytes_per_device")}
    one.update(measured_step_ms=step, roofline_ms=t_bound,
               roofline_share=t_bound / step,
               measured_peak_gb=train["peak_mem_gb"])
    out["phase16_roofline"] = one
    print(f"   phase 16's step on 1 x 1: t_compute {rec['t_compute'] * 1e3:.3f}"
          f" ms ({rec['hlo_flops'] / 1e12:.2f} TFLOP), t_memory "
          f"{rec['t_memory'] * 1e3:.3f} ms ({rec['hlo_bytes'] / 1e9:.1f} GB "
          f"unfused), t_collective {rec['t_collective'] * 1e3:.3f} ms; "
          f"measured step {step:.1f} ms, the roofline "
          f"{t_bound / step:.3f} of it; peak a device "
          f"{rec['peak_bytes_per_device'] / 1e9:.2f} GB (arguments "
          f"{rec['arg_bytes_per_device'] / 1e9:.2f}) against phase 16's "
          f"{train['peak_mem_gb']:.2f} GB measured", flush=True)
    if not t_bound <= step:
        raise AssertionError(f"phase 16's roofline {t_bound:.3f} ms exceeds "
                             f"its measured step {step:.3f} ms")
    return out


def train_card_vs_cpu(torch, ops, dev, arch="llama3-8b",
                      layers=TRAIN_CHECK["layers"], batch=TRAIN_CHECK["batch"],
                      changes=None, witness64=False, features=0):
    """(b) The same weights on card and CPU, fp32: ``arch`` at full width
    cut to ``layers`` (llama3-8b at TRAIN_CHECK's by default), one batch
    (with ``features`` feature rows a row); the loss and every leaf's
    gradient, the card through the forward and backward kernels, the CPU
    through the plain versions. With ``witness64`` the gate's CPU side is
    the CPU model in float64, and the fp32 CPU pass's distance from both is
    reported beside."""
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_leaves, tree_map
    from repro_torch.training.data import DataConfig, make_dataset

    L, (B, S) = layers, batch
    cfg = train_config(arch, L, changes or {})
    gpu = Model(cfg, dtype=torch.float32, device=dev, remat=True)
    cpu = Model(cfg, dtype=torch.float32, device="cpu", remat=True)
    params = gpu.init(torch.Generator(device=dev).manual_seed(0))
    params_cpu = tree_map(lambda t: t.cpu(), params)
    batch = next(make_dataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, batch_size=B, seed=0,
        feature_rows=features)).batches())

    def grads(model, tree):
        leaves = tree_leaves(tree)
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(tree, {k: torch.as_tensor(v, device=model.device)
                                 for k, v in batch.items()})
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    ops.reset_launches()
    lg, gg = grads(gpu, params)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches != train_structure(cfg, 1):
        raise AssertionError(f"{arch} card vs CPU launches {launches} != "
                             f"{train_structure(cfg, 1)}")
    t0 = time.perf_counter()
    lc, gc_ = grads(cpu, params_cpu)
    cpu_s = time.perf_counter() - t0
    extra, side = {}, "CPU"
    if witness64:
        cpu64 = Model(cfg, dtype=torch.float64, device="cpu", remat=True)
        l64, g64 = grads(cpu64, tree_map(lambda t: t.detach().double(),
                                         params_cpu))
        extra = {"loss_cpu_fp32": lc,
                 "worst_card_vs_cpu_fp32": max(
                     leaf_gap([a], [b.double()]) for a, b in zip(gg, gc_)),
                 "worst_cpu_fp32_vs_float64": max(
                     leaf_gap([a], [b]) for a, b in zip(gc_, g64))}
        print(f"   (b) {arch}: the fp32 CPU pass {extra['worst_cpu_fp32_vs_float64']:.2e} "
              f"of a leaf's largest from the float64 one, the card "
              f"{extra['worst_card_vs_cpu_fp32']:.2e} from the fp32 one; the "
              f"gate holds the card to the float64 pass", flush=True)
        lc, gc_, side = l64, g64, "CPU in float64"
        del cpu64
    loss_rel = abs(lg - lc) / abs(lc)
    worst = max(leaf_gap([a], [b]) for a, b in zip(gg, gc_))
    print(f"   (b) card vs {side}, {arch}, fp32, {L} layer{'s' * (L > 1)}, "
          f"[{B}, {S}]" + (f" + {features} feature rows" if features else "")
          + f": loss {lg:.6f} / {lc:.6f} (relative {loss_rel:.2e}, "
          f"limit {TRAIN_LOSS_RTOL}); worst gradient leaf {worst:.2e} of its "
          f"largest entry over {len(gg)} leaves (limit {TRAIN_GRAD_TOL}); "
          f"CPU pass {cpu_s:.1f} s", flush=True)
    if loss_rel > TRAIN_LOSS_RTOL or worst > TRAIN_GRAD_TOL:
        raise AssertionError(f"{arch}: card vs CPU training gradients apart")
    del gpu, cpu, params, params_cpu, gg, gc_
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": L, "batch": [B, S],
            "feature_rows": features, "loss_card": lg,
            "loss_cpu": lc, "loss_rel": loss_rel, "worst_leaf_rel": worst,
            "cpu_side": side, "launches": launches, "cpu_s": cpu_s, **extra}


# --------------------------------------------------------------------------- #
# phase 18
# --------------------------------------------------------------------------- #
MESH_STEPS = 32  # greedy steps of each sharded walk
MESH_W = 2048  # (a), (b): 512 slots a shard on the 1 x 4 mesh
LONG_W, LONG_LAYERS, LONG_PROMPT = 32_768, 8, 20_000  # (c): 8,192 a shard


def shard_walk(torch, ops, model, params, ctx, prompts, W, kernel, label,
               logit_limit=None, token_gate=True):
    """A bucketed (or, for one row, exact) prefill of ``prompts`` without a
    context, its caches grown to W slots and cloned: one copy laid out for
    ``ctx`` (``place_for_ctx``: the table by vocab, the caches by kv_seq),
    one kept whole. Then MESH_STEPS greedy steps, both fed the whole
    model's token: ``decode_step(..., shard_ctx=ctx)`` against the
    unsharded ``decode_step``, ``kernel`` launched once a shard and
    attention layer a step, the logits finite; gated with ``logit_limit``
    (of the largest logit, at every step) and with ``token_gate`` (each
    token equal or parted at a top-2 gap under LOGIT_LIMIT), else
    reported; then each step's device busy time (torch.profiler, every
    kernel), sharded and not."""
    import numpy as np

    from repro_torch.models import kvcache as kvc
    from repro_torch.sharding.partition import place_for_ctx

    dev, V = model.device, model.cfg.vocab_size
    B = len(prompts)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    if B == 1:
        logits, caches, lens = model.prefill(
            params, torch.from_numpy(prompts[0])[None].to(dev))
    else:
        L = max(16, 1 << (max(len(p) for p in prompts) - 1).bit_length())
        toks = np.zeros((B, L), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        logits, caches, lens = model.prefill_bucketed(
            params, torch.from_numpy(toks).to(dev), lens)
    caches = kvc.grow_cache(caches, W)
    whole = kvc.tree_map(lambda t: t.clone(), caches)
    pp, cc = place_for_ctx(model, ctx, params, caches)
    n_shards = ctx.axis_size("kv_seq")
    attn = sum(1 for g in model.groups for _ in range(g.count)
               for kind, _ in g.sigs if kind == "attn")
    tok = logits[:, :V].argmax(-1).to(torch.int32)[:, None]
    lens_s = lens.clone()
    errs, parts = [], []
    for t in range(MESH_STEPS):
        ops.reset_launches()
        got, cc, lens_s = model.decode_step(pp, cc, tok, lens_s,
                                            shard_ctx=ctx)
        torch.cuda.synchronize()
        n = ops.LAUNCHES[kernel]
        if n != n_shards * attn:
            raise AssertionError(f"{label}: step {t} launched {kernel} {n} "
                                 f"times, not {n_shards} x {attn}")
        want, whole, lens = model.decode_step(params, whole, tok, lens)
        g, w = got[:, :V].float(), want[:, :V].float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: step {t}: a logit not finite")
        top = float(w.abs().max())
        errs.append(float((g - w).abs().max()) / top)
        wt = w.argmax(-1)
        for b in (g.argmax(-1) != wt).nonzero().flatten().tolist():
            t2 = w[b].topk(2).values
            parts.append({"step": t, "row": b,
                          "top2_gap_rel": float(t2[0] - t2[1]) / top})
        tok = wt.to(torch.int32)[:, None]
    worst = max(errs)
    worst_gap = max((p["top2_gap_rel"] for p in parts), default=0.0)
    print(f"   {label}: logits apart a step (of the largest) "
          f"{[round(e, 5) for e in errs]}", flush=True)
    if logit_limit is not None and not worst <= logit_limit:
        raise AssertionError(f"{label}: logits {worst:.3e} of the largest "
                             f"apart (limit {logit_limit})")
    if token_gate and not worst_gap < LOGIT_LIMIT:
        raise AssertionError(f"{label}: tokens parted at a top-2 gap up to "
                             f"{worst_gap:.3e} (limit {LOGIT_LIMIT})")
    busy = device_ms(torch, lambda: model.decode_step(
        pp, cc, tok, lens_s, shard_ctx=ctx), "", reps=5)
    busy_whole = device_ms(torch, lambda: model.decode_step(
        params, whole, tok, lens), "", reps=5)
    res = {"rows": B, "W": W, "shards": n_shards,
           "slots_a_shard": W // n_shards, "rules": {
               k: ctx.rules[k] for k in ("batch", "kv_seq", "vocab")},
           "launches_a_step": n_shards * attn, "worst_logit_rel": worst,
           "logit_rel_a_step": errs, "dtype": str(model.dtype),
           "gates": {"logit_limit": logit_limit, "token_gate": token_gate},
           "parted": parts, "busy_ms_a_step": busy,
           "busy_ms_a_step_unsharded": busy_whole}
    print(f"   {label}: {MESH_STEPS} steps, logits within {worst:.3e} of the "
          f"largest (gate {logit_limit}); {len(parts)} token(s) parted "
          f"{[round(p['top2_gap_rel'], 5) for p in parts]}; {kernel} "
          f"{n_shards} x {attn} a step; busy {busy:.3f} ms a step sharded, "
          f"{busy_whole:.3f} unsharded", flush=True)
    del pp, cc, whole, caches
    torch.cuda.empty_cache()
    return res


def placed_tier(torch, ops, model, params, prompts, mesh, mode, want,
                template, label, **kw):
    """Phase 8's traffic through DisaggregatedEngine under ``mode`` on
    ``mesh`` (or with ``placement=False``): tokens == ``want``, every
    handoff's extent and the wire bytes == RING_EXTENTS / RING_WIRE and
    the host-side sum, launches to the path; the hop's wall recorded."""
    from repro_torch.core.transfer import TransferMode
    from repro_torch.serving import DisaggregatedEngine

    mode = TransferMode(mode)
    eng = DisaggregatedEngine(model, params, transfer_mode=mode, mesh=mesh,
                              max_batch=8, max_seq=2048,
                              device=model.device, **kw)
    ext = record_extents(eng)
    ops.reset_launches()
    reqs, _ = serve_all(eng, prompts, 32)
    for d in {eng.device, eng.pool.device}:
        torch.cuda.synchronize(d)
    c = eng.counters()
    if dict(ops.LAUNCHES) != structure(c, N_LAYERS):
        raise AssertionError(f"{label}: launches {dict(ops.LAUNCHES)}")
    got = [list(r.generated) for r in reqs]
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"{label}: tokens differ in requests {bad}")
    per = [extent_wire_bytes(torch, template, n, p, mode) for n, p in ext]
    if (ext != RING_EXTENTS or c["handoff_wire_bytes"] != sum(per)
            or sum(per) != RING_WIRE[mode.value]):
        raise AssertionError(f"{label}: extents {ext}, wire "
                             f"{c['handoff_wire_bytes']} (host-side "
                             f"{sum(per)}, by hand {RING_WIRE[mode.value]})")
    pl = eng.placement
    res = {"placement": None if pl is None else {
               "prefill": [str(d) for d in pl.prefill_devices()],
               "decode": [str(d) for d in pl.decode_devices()],
               "disjoint": pl.disjoint},
           "wire_bytes": c["handoff_wire_bytes"], "handoffs": c["handoffs"],
           "hop_ms": eng.handoff_wall_s * 1e3,
           "hop_ms_a_handoff": eng.handoff_wall_s * 1e3 / c["handoffs"]}
    print(f"   {label}: tokens == placement=False; {c['handoffs']} handoffs, "
          f"{c['handoff_wire_bytes']} wire bytes == by hand; hop "
          f"{res['hop_ms']:.3f} ms ({res['hop_ms_a_handoff']:.3f} a "
          f"handoff); stages {res['placement']}", flush=True)
    del eng
    return res


def cluster_tokens(torch, model, params, prompts, label, **kw):
    """Phase 4's prompts through a 2-replica in-process cluster
    (round_robin, DIRECT_HBM for disaggregated replicas), all submitted at
    once; the replicas' slices and the tokens."""
    from repro_torch.serving import ServingCluster

    from repro_torch.serving import Request

    cl = ServingCluster.build(model, params, n_replicas=2,
                              policy="round_robin", device=model.device,
                              max_batch=8, max_seq=2048, **kw)
    reqs = [Request(prompt_tokens=t.copy(), max_new_tokens=32)
            for t in prompts]
    for r in reqs:
        cl.submit(r)
    rsps = cl.run_until_drained()
    torch.cuda.synchronize()
    if len(rsps) != len(reqs) or any(len(r.generated) != 32 for r in reqs):
        raise AssertionError(f"{label}: {len(rsps)} of {len(reqs)} requests "
                             "returned, or one fell short of its budget")
    if not all(r.engine.logits_all_finite() for r in cl.replicas):
        raise AssertionError(f"{label}: a logit was not finite")
    pods = [list(r.pods) for r in cl.replicas]
    devs = [sorted({str(r.engine.device), str(r.engine.pool.device)})
            for r in cl.replicas]
    cl.close()
    print(f"   {label}: replica pods {pods}, devices {devs}", flush=True)
    return [list(r.generated) for r in reqs], {"pods": pods, "devices": devs}


def mesh_path(torch, ops, llama, disagg):
    """Phase 18: the serving tier on a device mesh (ROADMAP queue 1 item 3's
    serving half). (a) llama3-8b at full width, every layer,
    ``make_ctx(cfg, 1 x 4, DECODE_32K)``: the caches split 4 ways by
    sequence (512 of 2,048 slots each), the table 4 ways by vocab; phase
    4's first 8 prompts, the unsharded bucketed prefill, 32 greedy steps
    sharded against unsharded (:func:`shard_walk`), in bf16 on phase 4's
    weights (tokens equal or parted at a near tie; the logits reported:
    bf16's rounding through 32 random layers puts them about 0.02 of the
    largest apart) and in fp32 on new weights (logits within
    FP32_LOGIT_LIMIT of the largest: the shard arithmetic against the
    whole); (b) deepseek-v2-236b at published widths, 3 layers, the same
    way through the MLA kernel (bf16 reported only: a rounding apart moves
    the router's choices; fp32 gated as (a)'s); (c) ``LONG_500K``'s rules
    on 2 x 2 (``kv_seq`` over data and model, batch 1): llama3-8b's first
    8 layers over a 32,768-slot ring, 8,192 a shard, a 20,000-token prompt
    (shard 3 starts empty), bf16 and fp32 as (a); (d) phase 8's traffic on
    the disaggregated tier on a hand-built 2-slot pod mesh (pods 0 and 1:
    prefill and decode run apart) and with ``placement=False``, each
    mechanism, tokens == phase 8's (its default ``make_serving_pod_mesh()``
    placement), wire bytes by hand; (e) ``ServingCluster.build(mesh=...,
    pods_per_replica=...)`` fused (1 pod a replica) and disaggregated (2),
    2 replicas, tokens == the cluster built without a mesh. Where the host
    has two cards or more, (d) and (e) also run on distinct cards (the
    default meshes); on one card the meshes name the card in every slot,
    and the phase says so."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import DECODE_32K, LONG_500K
    from repro_torch.launch.mesh import (
        DeviceMesh,
        make_cluster_mesh,
        make_serving_pod_mesh,
    )
    from repro_torch.models import Model
    from repro_torch.sharding.partition import make_ctx

    model, params = llama
    dev = model.device
    n_cards = torch.cuda.device_count()
    branch = ("distinct cards: (d) and (e) also run on the default meshes"
              if n_cards >= 2 else "one card: every mesh slot names "
              f"{dev}; the distinct-card runs of (d) and (e) need two")
    print(f"   devices: {n_cards} ({branch})", flush=True)
    out = {"devices": n_cards, "branch": branch}
    prompts = main_prompts(model.cfg.vocab_size)

    # (a) llama3-8b, 1 x 4, DECODE_32K: phase 4's bf16 weights (tokens
    # gated; 32 random layers carry bf16's rounding to about 0.02 of the
    # largest logit, reported), then fp32 weights (the shard arithmetic
    # against the whole: logits within FP32_LOGIT_LIMIT)
    mesh14 = DeviceMesh([[dev] * 4], ("data", "model"))
    ctx = make_ctx(model.cfg, mesh14, DECODE_32K)
    out["a"] = shard_walk(torch, ops, model, params, ctx, prompts[:8], MESH_W,
                          "decode_attention", "(a) llama3-8b, 32 layers, 1 x 4")
    m32 = Model(model.cfg, dtype=torch.float32, device=dev)
    p32 = m32.init(torch.Generator(device=dev).manual_seed(0))
    out["a_fp32"] = shard_walk(torch, ops, m32, p32, ctx, prompts[:8], MESH_W,
                               "decode_attention",
                               "(a) llama3-8b, 32 layers, 1 x 4, fp32",
                               logit_limit=FP32_LOGIT_LIMIT)
    del m32, p32
    gc.collect()
    torch.cuda.empty_cache()

    # (b) deepseek-v2-236b, 3 layers, 1 x 4, DECODE_32K: bf16 reported (a
    # rounding apart moves the MoE router's top-6 choices, and with them
    # whole logits), fp32 gated as (a)'s
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              n_layers=MLA_LAYERS)
    ds_prompts = main_prompts(cfg.vocab_size)[:8]
    ds_ctx = make_ctx(cfg, mesh14, DECODE_32K)
    for dtype, key in ((torch.bfloat16, "b"), (torch.float32, "b_fp32")):
        ds = Model(cfg, dtype=dtype, device=dev)
        ds_params = ds.init(torch.Generator(device=dev).manual_seed(0))
        fp32 = dtype is torch.float32
        out[key] = shard_walk(
            torch, ops, ds, ds_params, ds_ctx, ds_prompts, MESH_W,
            "mla_decode_attention", f"(b) deepseek-v2-236b, {MLA_LAYERS} "
            f"layers, 1 x 4{', fp32' if fp32 else ''}",
            logit_limit=FP32_LOGIT_LIMIT if fp32 else None, token_gate=fp32)
        del ds, ds_params
        gc.collect()
        torch.cuda.empty_cache()

    # (c) LONG_500K on 2 x 2: batch 1, 8,192 slots a shard; phase 4's
    # first 8 layers in bf16 (tokens gated), then fp32 weights (gated as
    # (a)'s)
    cfg8 = dataclasses.replace(model.cfg, n_layers=LONG_LAYERS)
    mesh22 = DeviceMesh([[dev] * 2] * 2, ("data", "model"))
    ctx22 = make_ctx(cfg8, mesh22, LONG_500K)
    long_prompt = np.random.default_rng(18).integers(
        0, cfg8.vocab_size, LONG_PROMPT, dtype=np.int32)
    label = f"(c) llama3-8b, {LONG_LAYERS} layers, 2 x 2, LONG_500K"
    m8 = Model(cfg8, dtype=model.dtype, device=dev)
    p8 = dict(params, decoder={"g0": params["decoder"]["g0"][:LONG_LAYERS]})
    out["c"] = shard_walk(torch, ops, m8, p8, ctx22, [long_prompt], LONG_W,
                          "decode_attention", label)
    m8 = Model(cfg8, dtype=torch.float32, device=dev)
    p8 = m8.init(torch.Generator(device=dev).manual_seed(0))
    out["c_fp32"] = shard_walk(torch, ops, m8, p8, ctx22, [long_prompt],
                               LONG_W, "decode_attention", label + ", fp32",
                               logit_limit=FP32_LOGIT_LIMIT)
    if out["c"]["slots_a_shard"] != 8192:
        raise AssertionError(f"(c) {out['c']['slots_a_shard']} slots a shard")
    del m8, p8
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the disaggregated tier, placed
    template = meta_cache(torch, model, 8, 2048)
    two = DeviceMesh([dev, dev], ("pod",))
    out["d"] = {}
    for mode in DISAGG_MODES:
        want = disagg["tokens"][mode]
        runs = {"off": placed_tier(torch, ops, model, params, prompts, None,
                                   mode, want, template,
                                   f"(d) {mode}, placement=False",
                                   placement=False),
                "two_slot": placed_tier(torch, ops, model, params, prompts,
                                        two, mode, want, template,
                                        f"(d) {mode}, pods 0 -> 1 of a "
                                        "2-slot mesh")}
        if n_cards >= 2:
            runs["default"] = placed_tier(
                torch, ops, model, params, prompts, make_serving_pod_mesh(),
                mode, want, template, f"(d) {mode}, make_serving_pod_mesh() "
                "over two cards")
        out["d"][mode] = runs
        gc.collect()
        torch.cuda.empty_cache()

    # (e) the cluster's pod slices
    out["e"] = {}
    for engine, ppr in (("fused", 1), ("disagg", 2)):
        base, _ = cluster_tokens(torch, model, params, prompts,
                                 f"(e) {engine}, no mesh", engine=engine)
        meshes = {"hand": DeviceMesh([dev] * (2 * ppr), ("pod",))}
        if n_cards >= 2:
            meshes["default"] = make_cluster_mesh(2, ppr)
        out["e"][engine] = {}
        for name, mesh in meshes.items():
            got, info = cluster_tokens(
                torch, model, params, prompts,
                f"(e) {engine}, {name} mesh {mesh.shape}", engine=engine,
                mesh=mesh, pods_per_replica=ppr)
            if got != base:
                raise AssertionError(f"(e) {engine} on the {name} mesh: "
                                     "tokens differ from the cluster without "
                                     "a mesh")
            out["e"][engine][name] = info
        gc.collect()
        torch.cuda.empty_cache()
    print("   (e) tokens == the cluster without a mesh, fused and "
          "disaggregated", flush=True)
    return out



# --------------------------------------------------------------------------- #
# phase 19: training on a device mesh
# --------------------------------------------------------------------------- #
MESH_TRAIN_SHAPE = (2, 2)  # (data, model) slots, each naming the one card
MESH_TRAIN_STEPS = 3
MESH_TRAIN_LR = 1e-6
MESH_CHECK = dict(layers=2, batch=(2, 512))  # (b): llama3-8b, fp32
MESH_MLA_BATCH = (1, 512)  # (c)'s fp32 gate
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_TOL = 5e-4  # of a leaf's largest |gradient|; embed MESH_EMBED_TOL
MESH_EMBED_TOL = 5e-3
MULTI_CARD_STEPS = 4
# (e): the SSM, hybrid, VLM and encoder-decoder stacks on the same mesh at
# full width, each MESH_TRAIN_STEPS steps: (arch, layers, batch [B, tokens],
# feature rows, config changes, learning rate). mamba2 and jamba take
# phase 16 (d)'s rate, under which their losses fall from the first step;
# the attention stacks (a)'s
MESH_STACKS = (
    # all 24 layers, as phase 16 (d)
    ("mamba2-130m", 24, (8, 4096), 0, {}, 1e-3),
    # TRAIN_FAMILY's interleave: layer 0 SSM + dense FFN, layer 1
    # attention + MoE
    ("jamba-v0.1-52b", 2, (2, 4096), 0, dict(attn_every=2, attn_offset=1),
     1e-3),
    # 1024 feature rows ahead of 3072 tokens: 4096 positions
    ("pixtral-12b", 2, (2, 3072), 1024, {}, MESH_TRAIN_LR),
    # 6 of 24 encoder and 6 of 24 decoder layers (at 24 + 24 a step is 4.7
    # s of host wall for 80,006 kernels on an H100), 1024 frames and 1024
    # tokens
    ("seamless-m4t-large-v2", 6, (2, 1024), 1024, dict(encoder_layers=6),
     MESH_TRAIN_LR),
)
# (e)'s fp32 gates, card vs CPU, both sharded, at 2 layers (seamless: 2 +
# 2): (arch, batch [B, tokens], feature rows, config changes)
MESH_STACK_CHECK = (
    ("mamba2-130m", (1, 512), 0, {}),
    ("jamba-v0.1-52b", (1, 256), 0, dict(attn_every=2, attn_offset=1)),
    ("pixtral-12b", (1, 192), 64, {}),
    ("seamless-m4t-large-v2", (1, 384), 128, dict(encoder_layers=2)),
)


def card_mesh(torch, dev, shape=MESH_TRAIN_SHAPE):
    from repro_torch.launch.mesh import DeviceMesh

    import numpy as np

    devs = np.empty(shape, dtype=object)
    devs.flat[:] = [dev] * math.prod(shape)
    return DeviceMesh(devs, ("data", "model"))


def train_ctx(cfg, mesh, batch):
    from repro_torch.configs.shapes import InputShape
    from repro_torch.sharding.partition import make_ctx

    B, S = batch
    return make_ctx(cfg, mesh, InputShape("train_4k", seq_len=S,
                                          global_batch=B, kind="train"))


def sharded_structure(cfg, steps, ctx, batch):
    """:func:`train_structure` a computing slot: every slot of a sharded
    step that computes runs its own flash (its head shard of its batch
    rows) and rmsnorm (its block of positions) launches, forward,
    recompute and backward. Where the batch does not split over ``data``
    (a batch of 1 on 2 x 2) only the slots of data index 0 compute
    (``SlotPass.coords``)."""
    from repro_torch.sharding.partition import SlotPass

    slots = len(SlotPass(ctx, *batch).coords)
    return {k: v * slots for k, v in train_structure(cfg, steps).items()}


@contextlib.contextmanager
def ssd_heads_recorded():
    """Within it every SSD scan launch, forward and backward, is counted by
    its head count: yields a Counter of ("ssd_scan" or "ssd_scan_bwd",
    heads)."""
    from repro_torch.kernels import ssd_scan as ssd_mod

    seen = collections.Counter()
    real = ssd_mod.launch, ssd_mod.launch_bwd

    def wrap(fn, name):
        def launch(x, *a, **k):
            seen[name, x.shape[2]] += 1
            return fn(x, *a, **k)
        return launch

    ssd_mod.launch = wrap(real[0], "ssd_scan")
    ssd_mod.launch_bwd = wrap(real[1], "ssd_scan_bwd")
    try:
        yield seen
    finally:
        ssd_mod.launch, ssd_mod.launch_bwd = real


def mesh_train_run(torch, ops, dev, cfg, batch, label, unsharded,
                   features=0, lr=MESH_TRAIN_LR, recheck=False,
                   cpu_ops=True):
    """(a) ``repro_torch.training.train(..., shard_ctx=)``:
    MESH_TRAIN_STEPS AdamW steps of ``cfg`` (full remat, bf16) on a
    MESH_TRAIN_SHAPE mesh that names the card in every slot, phase 16's
    batches (with ``features`` feature rows a row, from
    ``DataConfig(feature_rows=)``: a VLM's prepended, an encoder-decoder's
    its encoder's frames); gates: finite and falling losses -- or, with
    ``recheck``, the trained params' loss on the first batch below the
    first step's --, launches == :func:`sharded_structure`, the SSD scan
    launched at a slot's head count; one more step profiled beside phase
    16's unsharded step (``unsharded``: its record, or {}; ``cpu_ops``:
    :func:`train_step_profile`'s)."""
    from repro_torch.launch.train import STATE_BYTES_PER_PARAM, param_count
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, train
    from repro_torch.training.data import make_dataset

    B, S = batch
    mesh = card_mesh(torch, dev)
    ctx = train_ctx(cfg, mesh, (B, S + features))
    model = Model(cfg, remat=True, remat_policy="full", device=dev)
    n_params = param_count(model)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                      seed=0, feature_rows=features)
    # AdamW's first steps move every weight by about lr (the update is the
    # gradient's sign): from random weights phase 16's lr of 1e-3 spikes
    # llama3-8b's loss on an H100 (12.6, 21.8, 13.8, 35.5) before it falls,
    # and so does 1e-4 (12.6, 15.9, 13.0); MESH_TRAIN_LR keeps the steps
    # small
    opt = AdamWConfig(lr=lr, warmup_steps=1, total_steps=MESH_TRAIN_STEPS)
    rules = {k: ctx.rules.get(k) for k in (
        "embed", "act_seq", "heads", "kv_heads", "ffn", "vocab", "experts",
        "ssm_heads") if ctx.rules.get(k) is not None}
    print(f"   {label}: {n_params:,} parameters, "
          f"{STATE_BYTES_PER_PARAM * n_params / 1e9:.1f} GB of state on a "
          f"{mesh.sizes[0]} x {mesh.sizes[1]} (data, model) mesh of {dev}; "
          f"rules {rules}; batch [{B}, {S}]"
          + (f" + {features} feature rows" if features else "")
          + f", remat full, {MESH_TRAIN_STEPS} steps at lr {lr:g}",
          flush=True)
    events = []

    def log(msg):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        print(f"   {msg}", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    with ssd_heads_recorded() as heads:
        params, state, hist = train(model, data, TrainConfig(
            steps=MESH_TRAIN_STEPS, log_every=1, seed=0), opt, shard_ctx=ctx,
            log_fn=log)
        torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    marks = [start] + events
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses = [h["loss"] for h in hist]
    again = None
    if recheck:
        first = {k: torch.as_tensor(v, device=dev) for k, v in next(
            make_dataset(data).batches()).items()}
        with torch.no_grad():
            again = float(model.loss(params, first, shard_ctx=ctx))
        print(f"   the first batch's loss {losses[0]:.4f} before training, "
              f"{again:.4f} after", flush=True)
        if not all(math.isfinite(x) for x in losses + [again]) \
                or not again < losses[0]:
            raise AssertionError(f"{label}: losses {losses}, the first "
                                 f"batch's after training {again}")
    elif not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")
    want = sharded_structure(cfg, MESH_TRAIN_STEPS, ctx, (B, S + features))
    print(f"   launches {launches}; expected {want} ({mesh.size} slots x "
          f"train_structure)")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != {want}")
    if cfg.ssm is not None:
        hl = cfg.ssm.n_heads(cfg.d_model) // ctx.axis_size("ssm_heads")
        want_heads = {(k, hl): launches[k] for k in ("ssd_scan",
                                                     "ssd_scan_bwd")}
        print(f"   SSD launches by heads: {dict(heads)}; {hl} heads a slot")
        if dict(heads) != want_heads:
            raise AssertionError(f"{label}: SSD launches by heads "
                                 f"{dict(heads)} != {want_heads}")
    first_layer = params["decoder"]["g0"][0]["l0"]
    mixer = ("attn", "wq") if "attn" in first_layer else ("ssm", "in_proj")
    blocks = {}
    for name, leaf in (("embed", params["embed"]),
                       ("/".join(mixer), first_layer[mixer[0]][mixer[1]]),
                       ("m embed", state.m["embed"])):
        blocks[name] = {"spec": list(map(str, leaf.spec)),
                        "block": list(leaf.parts()[0].shape),
                        "parts": len(leaf.parts()),
                        "device": str(leaf.parts()[0].device)}
    print(f"   blocks: {blocks}", flush=True)
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, S],
           "feature_rows": features, "lr": lr,
           "mesh": list(mesh.sizes), "rules": {k: str(v) for k, v in
                                               ctx.rules.items()},
           "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
           "first_batch_after": again, "launches": launches,
           "ssd_heads": {f"{k}@{h}": n for (k, h), n in heads.items()},
           "step_ms": step_ms, "peak_mem_gb": peak / 1e9, "blocks": blocks}
    t0 = time.perf_counter()
    prof = train_step_profile(torch, model, params, state, data, opt,
                              time_alone=False, shard_ctx=ctx,
                              cpu_ops=cpu_ops)
    res["profile"] = prof
    res["profile_s"] = time.perf_counter() - t0
    base = unsharded.get("profile", {})
    if prof.get("device_busy_ms"):
        print(f"   sharded step: busy {prof['device_busy_ms']:.1f} ms, idle "
              f"share {prof['device_idle_share']:.3f}, host wall "
              f"{prof['host_wall_ms']:.1f} ms, peak {peak / 1e9:.2f} GB",
              flush=True)
    if prof.get("device_busy_ms") and base.get("device_busy_ms"):
        res["busy_ratio"] = prof["device_busy_ms"] / base["device_busy_ms"]
        print(f"   phase 16's unsharded step in this run: busy "
              f"{base['device_busy_ms']:.1f} ms, idle share "
              f"{base['device_idle_share']:.3f}, host wall "
              f"{base['host_wall_ms']:.1f} ms; busy ratio "
              f"{res['busy_ratio']:.3f}; peak {peak / 1e9:.2f} GB sharded "
              f"against {unsharded.get('peak_mem_gb', float('nan')):.2f} GB "
              f"unsharded", flush=True)
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mesh_card_vs_cpu(torch, ops, dev, cfg, batch, label, features=0):
    """(b)/(c)/(e)'s gate: ``cfg`` in fp32, one sharded loss and gradient
    on a MESH_TRAIN_SHAPE mesh of the card against the same on a mesh of
    the CPU (the plain versions), the same weights and batch (with
    ``features`` feature rows a row): the loss within MESH_LOSS_RTOL, every
    gradient leaf within MESH_GRAD_TOL of its largest entry (``embed``
    MESH_EMBED_TOL); launches == :func:`sharded_structure` for one
    step."""
    from repro_torch.models import Model
    from repro_torch.models.schema import tree_leaves, tree_map
    from repro_torch.sharding.partition import (
        place_for_train,
        tree_parts,
        tree_with_parts,
    )
    from repro_torch.training.data import DataConfig, make_dataset

    B, S = batch
    gpu = Model(cfg, dtype=torch.float32, device=dev, remat=True)
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    whole = gpu.init(torch.Generator(device=dev).manual_seed(0))
    whole_cpu = tree_map(lambda t: t.cpu(), whole)
    data = next(make_dataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
        seed=0, feature_rows=features)).batches())
    rows = (B, S + features)

    def grads(model, mesh, tree):
        ctx = train_ctx(cfg, mesh, rows)
        placed = place_for_train(model, ctx, tree)
        parts = tree_parts(placed)
        for p in parts:
            p.requires_grad_(True)
        loss = model.loss(placed, {k: torch.as_tensor(v, device=model.device)
                                   for k, v in data.items()}, shard_ctx=ctx)
        g = torch.autograd.grad(loss, parts, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for x, p in zip(g, parts)]
        return float(loss.detach()), [
            t.sum_copies().blocks()
            for t in tree_leaves(tree_with_parts(placed, g))]

    ops.reset_launches()
    lg, gg = grads(gpu, card_mesh(torch, dev), whole)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    want = sharded_structure(cfg, 1, train_ctx(cfg, card_mesh(torch, dev),
                                               rows), rows)
    if launches != want:
        raise AssertionError(f"{label} launches {launches} != {want}")
    del whole
    t0 = time.perf_counter()
    lc, gc_ = grads(cpu, card_mesh(torch, torch.device("cpu")), whole_cpu)
    cpu_s = time.perf_counter() - t0
    # fp32 differences: a gap of 5e-4 of a leaf's largest is far above
    # their rounding, and float64 copies of jamba's 2.8B expert weights
    # took most of its gate's minute and a half on an H100
    gaps = {k: leaf_gap([a[i][1] for i in b], [t for _, t in b.values()])
            for k, a, b in zip(_leaf_names(cpu.schema()), gg, gc_)}
    worst_embed = gaps["embed"]
    worst = max(v for k, v in gaps.items() if k != "embed")
    loss_rel = abs(lg - lc) / abs(lc)
    print(f"   {label}: card vs CPU, both sharded on {MESH_TRAIN_SHAPE[0]} x "
          f"{MESH_TRAIN_SHAPE[1]}, fp32, [{B}, {S}]"
          + (f" + {features} feature rows" if features else "")
          + f": loss {lg:.6f} / {lc:.6f} "
          f"(relative {loss_rel:.2e}, limit {MESH_LOSS_RTOL}); worst gradient "
          f"leaf {worst:.2e} of its largest entry over {len(gg) - 1} leaves "
          f"(limit {MESH_GRAD_TOL}), embed {worst_embed:.2e} (limit "
          f"{MESH_EMBED_TOL}); CPU pass {cpu_s:.1f} s; launches on the card "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if (loss_rel > MESH_LOSS_RTOL or worst > MESH_GRAD_TOL
            or worst_embed > MESH_EMBED_TOL):
        raise AssertionError(f"{label}: card vs CPU sharded gradients apart")
    del gpu, cpu, whole_cpu, gg, gc_
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, S],
            "feature_rows": features,
            "loss_card": lg, "loss_cpu": lc, "loss_rel": loss_rel,
            "worst_leaf_rel": worst, "embed_rel": worst_embed,
            "launches": launches, "cpu_s": cpu_s}


def _leaf_names(tree, prefix=""):
    """Leaf paths in ``tree_leaves`` order ("embed", "decoder/g0/0/l0/...")."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def mla_mesh_step(torch, ops, dev, cfg, batch):
    """(c) deepseek-v2-236b's layer 0 (MLA at 128 heads, 64 a slot, and the
    dense 12,288 FFN) in bf16: one sharded step on the card, launches ==
    :func:`sharded_structure`, the flash backward at (192, 128) per head
    shard."""
    from repro_torch.models import Model
    from repro_torch.sharding.partition import place_for_train
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    from repro_torch.training.data import DataConfig, make_dataset

    B, S = batch
    ctx = train_ctx(cfg, card_mesh(torch, dev), batch)
    model = Model(cfg, remat=True, device=dev)
    params = place_for_train(model, ctx, model.init(
        torch.Generator(device=dev).manual_seed(0)))
    state = adamw_init(params)
    data = {k: torch.as_tensor(v, device=dev) for k, v in next(make_dataset(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                   seed=0)).batches()).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    params, state, met = make_train_step(model, AdamWConfig(), ctx)(
        params, state, data)
    loss = float(met["loss"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.LAUNCHES)
    want = sharded_structure(cfg, 1, ctx, batch)
    heads = cfg.n_heads // ctx.axis_size("heads")
    print(f"   (c) {cfg.name}, layer 0, bf16, [{B}, {S}], {heads} heads a "
          f"slot: loss {loss:.4f}, step wall {wall:.1f} ms (the first, "
          f"untimed warm-up included), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if launches != want or not math.isfinite(loss):
        raise AssertionError(f"(c) launches {launches} != {want} or loss "
                             f"{loss}")
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "wall_ms": wall, "launches": launches,
            "heads_a_slot": heads}


def multi_card_train(torch):
    """(d) with two cards or more: llama3-8b at all 32 layers through the
    launcher's full-config branch (``data`` = the card count, FSDP), batch
    one row a card at 4,096 positions, MULTI_CARD_STEPS steps at (a)'s
    learning rate (the launcher's 1e-3 spikes the loss at the second step,
    12.5 to 28.2 on four H100s). Each step draws a new batch, and at 1e-6
    the batches part by more than an update moves the loss (12.523,
    12.544, 12.473, 12.532 over 4 steps on four H100s), so the gate reads
    the trained params' loss on the first batch again: finite, and below
    the first step's loss on it. On one card it says so and runs nothing."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import Model
    from repro_torch.training.data import DataConfig, make_dataset

    n = torch.cuda.device_count()
    if n < 2:
        print(f"   (d) the launcher's full-config branch over several cards "
              f"needs two cards or more: this host has {n}; nothing run",
              flush=True)
        return {"devices": n, "ran": False}
    S = 4096
    t0 = time.perf_counter()
    params, _, hist = launch_train.main(
        ["--arch", "llama3-8b", "--steps", str(MULTI_CARD_STEPS), "--batch",
         str(n), "--seq", str(S), "--lr", str(MESH_TRAIN_LR)])
    wall = time.perf_counter() - t0
    cfg = get_config("llama3-8b")
    mesh = make_train_mesh()
    model = Model(cfg, remat=True, device=mesh.first_device)
    first = {k: torch.as_tensor(v, device=mesh.first_device)
             for k, v in next(make_dataset(DataConfig(
                 vocab_size=cfg.vocab_size, seq_len=S, batch_size=n,
                 seed=0)).batches()).items()}
    with torch.no_grad():
        again = float(model.loss(params, first,
                                 shard_ctx=train_ctx(cfg, mesh, (n, S))))
    losses = [h["loss"] for h in hist]
    print(f"   (d) llama3-8b, 32 layers, data = {n} cards: losses {losses}, "
          f"{wall:.1f} s; the first batch's loss {losses[0]:.4f} before "
          f"training, {again:.4f} after", flush=True)
    if not all(math.isfinite(x) for x in losses + [again]) \
            or not again < losses[0]:
        raise AssertionError(f"(d) losses {losses}, the first batch's "
                             f"after training {again}")
    return {"devices": n, "ran": True, "losses": losses,
            "first_batch_after": again, "wall_s": wall}


def mesh_stacks_path(torch, ops, dev, family):
    """(e) MESH_STACKS: mamba2-130m (24 layers, [8, 4096]; its 24 SSD heads
    12 a slot), jamba-v0.1-52b (2 layers, [2, 4096]; 64 of its 128 SSD heads
    a slot, attention and MoE), pixtral-12b (2 layers, 1024 feature rows
    and 3072 tokens a row) and seamless-m4t-large-v2 (6 + 6 of its 24 +
    24 layers, 1024 frames and 1024 tokens) trained on (a)'s mesh through
    ``train(..., shard_ctx=)``, each as (a) with the first batch's loss
    read again after training, then its fp32 gate at 2 layers
    (MESH_STACK_CHECK).
    ``family``: phase 16 (d)'s unsharded records, beside which mamba2's and
    jamba's steps are read."""
    out = {}
    for (arch, layers, batch, features, changes, lr), check in zip(
            MESH_STACKS, MESH_STACK_CHECK):
        t0 = time.perf_counter()
        cfg = train_config(arch, layers, changes)
        res = mesh_train_run(
            torch, ops, dev, cfg, batch,
            f"(e) {arch}, {layers} layers at full width",
            family.get(arch, {}), features=features, lr=lr, recheck=True,
            cpu_ops=False)
        t1 = time.perf_counter()
        c_arch, c_batch, c_features, c_changes = check
        res["gate"] = mesh_card_vs_cpu(
            torch, ops, dev, train_config(c_arch, 2, c_changes), c_batch,
            f"(e) {c_arch}, 2 layers", features=c_features)
        res["wall_s"] = {"run": t1 - t0, "gate": time.perf_counter() - t1}
        print(f"   (e) {arch}: the run {t1 - t0:.1f} s (its profiled step "
              f"{res['profile_s']:.1f} s), the gate "
              f"{res['wall_s']['gate']:.1f} s", flush=True)
        out[arch] = res
    return out


def mesh_train_path(torch, ops, dev, unsharded, family=None):
    """Phase 19: training on a device mesh (ROADMAP queue 1 item 3b).
    (a) phase 16's llama3-8b (8 of 32 layers at full width, [2, 4096],
    full remat, bf16) on a 2 x 2 (data, model) mesh naming the card four
    times -- FSDP over data, heads, kv heads, FFN and vocab over model,
    the residual sequence-sharded -- MESH_TRAIN_STEPS AdamW steps through
    ``train(..., shard_ctx=)``, the launches per slot, one step profiled
    beside phase 16's unsharded one (``unsharded``); (b) llama3-8b at 2
    layers, fp32, [2, 512], card vs CPU, both sharded; (c)
    deepseek-v2-236b's layer 0 (MLA, the flash backward at (192, 128) on
    64 heads a slot) one bf16 step at [2, 4096], then its fp32 gate at
    [1, 512]; (d) the launcher's full-config branch over the cards, where
    there are two or more; (e) the SSM, hybrid, VLM and encoder-decoder
    stacks (:func:`mesh_stacks_path`; ``family``: phase 16 (d)'s
    records)."""
    out = {}
    cfg = train_config("llama3-8b", TRAIN_LAYERS, {})
    out["a"] = mesh_train_run(
        torch, ops, dev, cfg, TRAIN_BATCH,
        f"(a) llama3-8b, {TRAIN_LAYERS} of 32 layers at full width",
        unsharded)
    out["b"] = mesh_card_vs_cpu(
        torch, ops, dev, train_config("llama3-8b", MESH_CHECK["layers"], {}),
        MESH_CHECK["batch"], f"(b) llama3-8b, {MESH_CHECK['layers']} layers")
    ds = train_config("deepseek-v2-236b", 1, {})
    out["c"] = mla_mesh_step(torch, ops, dev, ds, TRAIN_BATCH)
    out["c"]["gate"] = mesh_card_vs_cpu(torch, ops, dev, ds, MESH_MLA_BATCH,
                                        "(c) deepseek-v2-236b, layer 0")
    out["d"] = multi_card_train(torch)
    out["e"] = mesh_stacks_path(torch, ops, dev, family or {})
    return out


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
