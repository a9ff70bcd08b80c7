"""Replica worker: the child-process half of the socket RPC control plane
(the JAX package's ``serving/worker.py``).

``python -m repro_torch.serving.worker --port P`` is what
:class:`~repro_torch.serving.ipc.ReplicaClient` spawns, one per
``backend="process"`` replica. The worker connects back to the parent's
listening socket, answers the ``hello`` clock handshake, then receives an
``init`` spec and builds its OWN copy of the serving stack in this
process:

* its own CUDA context on the spec's devices (``devices``, the card
  indices the cluster handed this replica, else ``device``: ``"cuda"`` by
  default; a worker that finds no card raises through the init reply and
  never carries on on the CPU -- ``"cpu"`` only when the spec asks for
  it); a disaggregated engine places its two stages on a ``('pod',)`` mesh
  over those devices, a fused one runs on the first;
* the model and params, rebuilt from ``param_seed`` with
  ``torch.Generator(device=dev).manual_seed(seed)`` on that device, as an
  in-process build of the same seed draws them: params cross the process
  boundary as a seed, not as tensors, and the init reply carries a
  checksum of a few weight leaves so the parent can show they match;
* a :class:`~repro_torch.serving.engine.ServingEngine` (or
  ``DisaggregatedEngine``) wrapped in the threaded
  :class:`~repro_torch.serving.engine.EnginePipeline`, so dispatch, the
  wait on the card and bookkeeping overlap inside the replica while the
  parent's router does something else.

After init it is a plain RPC server: submit / harvest / load / telemetry /
drain / shutdown, each answered with one frame. Any exception is caught
and shipped back as an ``("error", {traceback})`` frame; the parent raises
it as a :class:`~repro_torch.serving.ipc.ReplicaError` instead of hanging.
EOF from the parent (a crashed or impatient router) exits the process, so
workers cannot outlive their cluster even if the parent's reaper never
runs.
"""

from __future__ import annotations

import argparse
import socket
import sys
import time
import traceback

import torch

from repro_torch import resolve_device
from repro_torch.core import trace
from repro_torch.serving import ipc

# top-level package names whose loading the telemetry reply reports: the
# port's workers load none of them
_FOREIGN = ("jax", "jaxlib", "repro")


def _build_pipeline(spec: dict):
    """Build model -> params -> engine -> EnginePipeline from the init
    spec. Raises when the spec's device is absent (no CPU fallback)."""
    from repro_torch.models import Model
    from repro_torch.serving.engine import EnginePipeline, ServingEngine

    devices = [resolve_device(d) for d in
               spec.get("devices") or [spec.get("device", "cuda")]]
    dev = devices[0]
    model = Model(spec["cfg"], dtype=getattr(torch, spec.get("dtype",
                                                             "bfloat16")),
                  device=dev)
    # weights from the seed, not the wire: the same draw as an in-process
    # build's model.init(torch.Generator(device=dev).manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(int(spec.get("param_seed",
                                                               0)))
    params = model.init(gen)
    if spec.get("tracing"):
        # spans carry THIS process's perf_counter; the parent rebases them
        # at ingest and relabels them with the replica's name
        trace.enable_tracing(process=spec.get("trace_label", "worker"))
    engine_kw = dict(spec.get("engine_kw") or {})
    if spec.get("engine", "fused") == "disagg":
        from repro_torch.serving.disagg import DisaggregatedEngine

        from repro_torch.launch.mesh import DeviceMesh

        eng = DisaggregatedEngine(model, params, device=dev,
                                  mesh=DeviceMesh(devices, ("pod",)),
                                  **engine_kw)
    else:
        eng = ServingEngine(model, params, device=dev, **engine_kw)
    return EnginePipeline(eng, backlog=int(spec.get("backlog", 2)))


def _pairs(pipe) -> list:
    """Finished responses since the last call, each with its record, as
    wire dicts in completion order."""
    return [(ipc.response_to_wire(rsp),
             ipc.record_to_wire(pipe.engine._records[rsp.request_id]))
            for rsp in pipe.step()]


def _harvest(pipe) -> dict:
    return {"done": _pairs(pipe), "load": pipe.load_snapshot(),
            "spans": trace.tracer().drain_wire()}


def _telemetry(pipe) -> dict:
    eng = pipe.engine
    cuda = eng.device.type == "cuda"
    return {
        "load": pipe.load_snapshot(),
        "counters": eng.counters(),
        "warm_s": eng.warm_s,
        "metrics": pipe.metrics_snapshot(),
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(eng.device)
                           if cuda else None),
        "foreign_modules": sorted(m for m in sys.modules
                                  if m.split(".")[0] in _FOREIGN),
        "spans": trace.tracer().drain_wire(),
    }


def _drain(pipe, deadline_s: float) -> dict:
    """Run the pipeline to idle (bounded), returning every finished pair
    collected along the way."""
    done = []
    t_end = time.perf_counter() + float(deadline_s)
    while not pipe.idle:
        done.extend(_pairs(pipe))
        if time.perf_counter() > t_end:
            raise TimeoutError(
                f"drain deadline {deadline_s}s lapsed with the pipeline "
                f"still busy: {pipe.load_snapshot()}"
            )
        time.sleep(0.0005)
    done.extend(_pairs(pipe))  # finals surfaced by the last transition
    pipe.trace_flush()  # close the open decode window before shipping
    return {"done": done, "load": pipe.load_snapshot(),
            "spans": trace.tracer().drain_wire()}


def serve(port: int) -> int:
    sock = socket.create_connection(("127.0.0.1", port), timeout=30.0)
    sock.settimeout(None)  # the parent owns every deadline; the worker blocks
    pipe = None
    try:
        while True:
            try:
                op, payload, _ = ipc.recv_msg(sock)
            except ipc.ConnectionClosed:
                return 0  # the parent went away: exit, leave no orphan
            try:
                if op == "hello":
                    ipc.send_msg(sock, "ok", {"t_child": time.perf_counter()})
                elif op == "init":
                    t0 = time.perf_counter()
                    pipe = _build_pipeline(payload)
                    eng = pipe.engine
                    ipc.send_msg(sock, "ok", {
                        "init_s": time.perf_counter() - t0,
                        "device": (torch.cuda.get_device_name(eng.device)
                                   if eng.device.type == "cuda" else "cpu"),
                        "warm_s": eng.warm_s,
                        "exact_prefill": eng.exact_prefill,
                        "checksum": ipc.weight_checksum(eng.params),
                    })
                elif pipe is None:
                    raise RuntimeError(f"op {op!r} before init")
                elif op == "submit":
                    pipe.submit(ipc.request_from_wire(payload))
                    ipc.send_msg(sock, "ok", pipe.load_snapshot())
                elif op == "harvest":
                    ipc.send_msg(sock, "ok", _harvest(pipe))
                elif op == "load":
                    ipc.send_msg(sock, "ok", pipe.load_snapshot())
                elif op == "telemetry":
                    ipc.send_msg(sock, "ok", _telemetry(pipe))
                elif op == "drain":
                    ipc.send_msg(sock, "ok", _drain(
                        pipe, payload.get("deadline_s", 120.0)))
                elif op == "shutdown":
                    if pipe is not None:
                        pipe.close()
                    ipc.send_msg(sock, "ok", None)
                    return 0
                else:
                    raise RuntimeError(f"unknown op {op!r}")
            except Exception:
                # ship the traceback; the parent raises it as ReplicaError
                ipc.send_msg(sock, "error",
                             {"traceback": traceback.format_exc()})
    finally:
        if pipe is not None:
            pipe.close()
        try:
            sock.close()
        except OSError:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, required=True,
                    help="the parent's listening port on 127.0.0.1")
    args = ap.parse_args(argv)
    return serve(args.port)


if __name__ == "__main__":
    sys.exit(main())
