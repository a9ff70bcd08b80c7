"""End-to-end example on the PyTorch port: serve a small LLM with batched
requests (REAL compute).

A reduced llama3-family model is served through the port's
continuous-batching engine with 4 concurrent closed-loop clients;
transports are swapped to show the paper's effect on a REAL inference
pipeline (compute measured on this machine -- the card's hand-written
kernels by default, their plain PyTorch versions with ``--device cpu`` --,
wires modeled by the calibrated profile).

Run: PYTHONPATH=src python examples/serve_llm_torch.py [--arch llama3-8b] [--clients 4] [--device cuda]
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.transport import Transport
from repro_torch.models import Model
from repro_torch.serving import ClosedLoopClient, ServingEngine, run_closed_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"serving {cfg.name} ({cfg.family}), vocab={cfg.vocab_size}")

    for transport in (Transport.GDR, Transport.RDMA, Transport.TCP):
        engine = ServingEngine(
            model, params, max_batch=4, max_seq=96, transport=transport,
            device=model.device,
        )
        clients = [
            ClosedLoopClient(i, cfg.vocab_size, prompt_len=16,
                             max_new_tokens=args.new_tokens)
            for i in range(args.clients)
        ]
        t0 = time.perf_counter()
        run_closed_loop(engine, clients, requests_per_client=args.requests)
        wall = time.perf_counter() - t0
        n = sum(len(c.completed) for c in clients)
        s = engine.store
        stages = {k: round(v * 1e3, 3) for k, v in s.stage_means().items() if v}
        print(f"  {transport.value:5s}: {n} requests in {wall:.1f}s wall; "
              f"modeled transport+copy stages (ms): "
              f"req={stages.get('request', 0)} copy_in={stages.get('copy_in', 0)} "
              f"rsp={stages.get('response', 0)}")


if __name__ == "__main__":
    main()
