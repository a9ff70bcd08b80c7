"""Serving launcher of the port: continuous-batching engine + closed-loop load.

Runs the full configuration in bf16 on the card by default, with random
weights drawn from seed 0:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --reduced --device cpu --clients 2 --requests 2
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.metrics import slo_summary
from repro_torch.core.transport import Transport
from repro_torch.models import Model
from repro_torch.serving import ClosedLoopClient, ServingEngine, run_closed_loop


def _prompt_len(text: str):
    """'32' -> 32; '64:1024' -> (64, 1024), a uniform ragged range."""
    if ":" in text:
        lo, hi = (int(x) for x in text.split(":"))
        if not 0 < lo <= hi:
            raise argparse.ArgumentTypeError(f"bad prompt range {text!r}")
        return lo, hi
    return int(text)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's CPU-test variant (2 layers, d=256)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--transport", default="gdr",
                    choices=["local", "tcp", "rdma", "gdr"])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=_prompt_len, default=32,
                    help="tokens per prompt, or LO:HI for a ragged range")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="ring width (0: longest prompt + new tokens + 8)")
    return ap


def run(args) -> dict:
    """Build the model and engine, serve the closed-loop load, and return
    the engine, the responses and the wall time of the drain."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    params = model.init(gen)
    longest = (args.prompt_len[1] if isinstance(args.prompt_len, tuple)
               else args.prompt_len)
    engine = ServingEngine(
        model, params, max_batch=args.max_batch,
        max_seq=args.max_seq or longest + args.new_tokens + 8,
        transport=Transport(args.transport), device=args.device,
    )
    clients = [
        ClosedLoopClient(i, cfg.vocab_size, prompt_len=args.prompt_len,
                         max_new_tokens=args.new_tokens)
        for i in range(args.clients)
    ]
    t0 = time.perf_counter()
    run_closed_loop(engine, clients, requests_per_client=args.requests)
    wall = time.perf_counter() - t0
    responses = [r for c in clients for r in c.completed]
    return {"cfg": cfg, "model": model, "engine": engine,
            "responses": responses, "wall_s": wall}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out = run(args)
    engine, responses, wall = out["engine"], out["responses"], out["wall_s"]
    s = engine.store
    slo = slo_summary(responses)
    tokens = sum(len(r.tokens) for r in responses)
    print(f"{out['cfg'].name} ({out['cfg'].n_layers} layers) on "
          f"{engine.device} via {args.transport}")
    print("  requests:", len(s.records), " tokens out:", tokens,
          " tokens/s: %.1f" % (tokens / wall))
    print("  ttft p50/p99: %.2f / %.2f ms   tpot p50/p99: %.2f / %.2f ms"
          % (slo["ttft_s"]["p50"] * 1e3, slo["ttft_s"]["p99"] * 1e3,
             slo["tpot_s"]["p50"] * 1e3, slo["tpot_s"]["p99"] * 1e3))
    print("  mean total: %.2f ms  p99: %.2f ms"
          % (s.summary()["mean"] * 1e3, s.summary()["p99"] * 1e3))
    print("  stage means (ms):",
          {k: round(v * 1e3, 3) for k, v in s.stage_means().items() if v})
    out["slo"] = slo
    out["tokens"] = tokens
    return out


if __name__ == "__main__":
    main()
