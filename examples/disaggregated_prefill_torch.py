"""Disaggregated prefill->decode serving on the PyTorch port: the paper's
proxied-connection study mapped onto a modern LLM serving pattern
(docs/architecture.md, "Stage boundary -- the prefix-only KV handoff").

Pod 0 runs admission+prefill, the last pod owns the decode slot pool, and
with per-pod placement (the default) each stage's params and compute live
on its own pod's device, so the handoff is the only cross-pod hop. The
port's ``make_pod_mesh()`` takes two cards where the host has them, else
one pod, where both stages share the one card (or, with ``--device cpu``,
the CPU) and the handoff still lands in decode-side buffers of its own.
Each admitted request's VALID KV PREFIX (plus its slot metadata) crosses
the hop under the deployment's mechanism -- DIRECT_HBM = GPUDirect (a
device or peer copy), DIRECT_DMA = RDMA (a pinned host bounce),
HOST_STAGED = TCP (int8-requantized with per-source scales, through
pageable host memory). The hop moves only the admitted rows sliced to
their prefix blocks -- not the max_batch x max_seq pool tree -- and the
decode side grows the landed prefix back to the ring width. It prints,
per mechanism: wire bytes (vs the padded admission tree), the
per-request handoff charge folded into TTFT, and decode-token fidelity
vs a single fused engine; then each mechanism's exact wire bytes.

Run: PYTHONPATH=src python examples/disaggregated_prefill_torch.py [--device cuda]
"""

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.transfer import MODE_TRANSPORT, TransferMode
from repro_torch.launch.mesh import available_devices
from repro_torch.models import Model
from repro_torch.serving import DisaggregatedEngine, ServingEngine, make_pod_mesh
from repro_torch.serving.request import Request


def _requests(cfg, lens, max_new=4, seed=0):
    rng = np.random.default_rng(seed)
    return [
        Request(
            prompt_tokens=rng.integers(0, cfg.vocab_size, s, dtype=np.int32),
            max_new_tokens=max_new,
        )
        for s in lens
    ]


def drain(eng, cfg, lens):
    reqs = _requests(cfg, lens)
    for r in reqs:
        eng.submit(r, time.perf_counter())
    out = eng.run_until_drained()
    assert len(out) == len(reqs)
    by_id = {r.request_id: r for r in out}
    return [tuple(by_id[r.request_id].tokens) for r in reqs], [
        by_id[r.request_id] for r in reqs
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    cfg = get_config("llama3-8b").reduced()
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    mesh = make_pod_mesh(device=args.device)
    lens = [6, 11, 19, 27]
    kw = dict(max_batch=2, max_seq=64, device=model.device)

    print(f"{cfg.name}: {len(available_devices(args.device))} "
          f"{args.device} devices, {mesh.shape['pod']}-pod mesh (prefill pod "
          f"0 -> decode pod {mesh.shape['pod'] - 1})")
    base_tokens, _ = drain(ServingEngine(model, params, **kw), cfg, lens)

    shown = False
    wire = {}
    for mode in TransferMode:
        eng = DisaggregatedEngine(
            model, params, transfer_mode=mode, mesh=mesh, **kw
        )
        if not shown:  # per-pod placement (default): stage -> device
            pl = eng.placement
            print(f"  placement: prefill on {pl.prefill_devices()}, decode "
                  f"pool on {pl.decode_devices()} "
                  f"({'disjoint two-pool split' if pl.disjoint else 'degenerate shared slice'})")
            shown = True
        tokens, rsps = drain(eng, cfg, lens)
        match = sum(a == b for a, b in zip(tokens, base_tokens)) / len(tokens)
        recs = eng.store.records
        charge = sum(r.stage_s.get("transfer", 0.0) for r in recs) / len(recs)
        # what a handoff of the whole pool would put on the wire per
        # admission: the full max_batch x max_seq cache tree + full-width
        # slot metadata
        padded = eng.handoffs * eng.padded_tree_wire_bytes()
        wire[mode.value] = eng.handoff_wire_bytes
        print(f"  {mode.value:12s} ({MODE_TRANSPORT[mode].value:4s}): "
              f"{eng.handoff_wire_bytes / 1e3:7.1f} KB on the wire over "
              f"{eng.handoffs} handoffs "
              f"({eng.handoff_wire_bytes / padded:.0%} of the padded "
              f"admission trees); "
              f"{charge * 1e6:7.1f} us/request handoff charge; "
              f"tokens vs fused engine: {match:.0%}")
    print(f"  wire bytes by mechanism: {json.dumps(wire)}")
    print("\ntakeaway: the wire carries only the admitted rows' valid KV "
          "prefix (the paper's 'useful\npayload'), so handoff bytes track "
          "prompt lengths, not pool capacity. DIRECT_HBM (GDR\nanalogue) "
          "lands the full-precision cache in decode-pod memory with zero "
          "staging copies and\nstays bit-exact; HOST_STAGED pays "
          "requantization + staging copies + CPU — the paper's\n"
          "protocol-translation trade (finding 2), now measured on the "
          "live serving path.")


if __name__ == "__main__":
    main()
