"""Socket RPC control plane for the process-per-replica serving cluster
(the JAX package's ``serving/ipc.py``).

The paper's deployment is a multi-stage pipeline across *separate
processes and hosts* -- client -> TCP proxy -> stage pools over a fabric --
where every hop is a real wire with real serialization. This module is
that control plane in miniature: a small length-prefixed RPC protocol the
parent-process :class:`~repro_torch.serving.cluster.Router` speaks to each
replica worker process (``serving/worker.py``), so the cluster's replicas
are concurrent OS processes, each with its own CUDA context, instead of
objects stepped one after another in one interpreter.

**Wire format.** Every message is one frame: a 4-byte big-endian length
prefix followed by a pickled ``(op, payload)`` pair. Ops:

  hello     : clock handshake -- the parent estimates the child-vs-parent
              ``perf_counter`` offset from one RTT, the skew term
              ``core.metrics.merge_record_streams`` rebases records with.
              The worker connects only once its imports are done, so the
              sample is a socket round trip, not an import stall.
  init      : engine spec (model config, dtype, param seed, device, engine
              kind + kwargs) -> the worker builds its model, params, engine
              and a threaded :class:`~repro_torch.serving.engine.
              EnginePipeline`, and replies with a checksum of a few weight
              leaves (:func:`weight_checksum`).
  submit    : one serialized Request joins the worker's admission queue;
              the reply carries a fresh load snapshot for the router.
  harvest   : finished (Response, RequestRecord) pairs since the last
              harvest, plus the load snapshot.
  load      : load snapshot only (router policies, idle checks).
  telemetry : load snapshot, engine counters and registry snapshot, the
              worker's peak device memory and any JAX module it loaded.
  drain     : block until the worker's pipeline is idle (bounded by a
              deadline), returning every remaining finished pair.
  shutdown  : stop the pipeline threads and exit 0.

**Serialization** uses ``serving/request.py``'s types: requests, responses
and records cross as plain field dicts (numpy prompt arrays pickle
natively), rebuilt with their original ``request_id`` so parent- and
child-side bookkeeping key identically. Both ends count wire bytes and
submitted request-payload bytes: the conservation invariant (what the
parent sent == what the child acknowledged).

**Process management.** :class:`ReplicaClient` spawns the worker with
``python -m repro_torch.serving.worker`` (the device rides in the init
spec, not the environment), waits for the socket handshake, and maps
every failure mode to a :class:`ReplicaError` instead of a hang: RPC
timeouts kill the child; an EOF mid-reply reports the child's exit code.
Live workers are tracked in a module registry reaped at interpreter exit,
so a crashed parent never leaks orphan processes.
"""

from __future__ import annotations

import atexit
import hashlib
import os
import pickle
import socket
import struct
import subprocess
import sys
import time
from typing import Optional

import torch

from repro_torch.core import trace
from repro_torch.core.profiler import RequestRecord
from repro_torch.serving.request import Request, Response

_HDR = struct.Struct("!I")
_MAX_FRAME = 1 << 30  # 1 GiB sanity bound on a single frame


class ConnectionClosed(RuntimeError):
    """Peer closed the socket mid-protocol (EOF before a full frame)."""


class ReplicaError(RuntimeError):
    """A replica worker process failed (died, timed out, or raised)."""


# --------------------------------------------------------------------------- #
# framing
# --------------------------------------------------------------------------- #
def send_msg(sock: socket.socket, op: str, payload=None) -> int:
    """Send one length-prefixed frame; returns bytes put on the wire."""
    body = pickle.dumps((op, payload), protocol=pickle.HIGHEST_PROTOCOL)
    frame = _HDR.pack(len(body)) + body
    sock.sendall(frame)
    return len(frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionClosed(
                f"peer closed the connection ({len(buf)}/{n} bytes of the "
                f"current frame received)"
            )
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket):
    """Receive one frame; returns ``(op, payload, wire_bytes)``."""
    hdr = _recv_exact(sock, _HDR.size)
    (n,) = _HDR.unpack(hdr)
    if n > _MAX_FRAME:
        raise ValueError(f"frame length {n} exceeds sanity bound {_MAX_FRAME}")
    op, payload = pickle.loads(_recv_exact(sock, n))
    return op, payload, _HDR.size + n


# --------------------------------------------------------------------------- #
# request / response / record serialization (serving/request.py types)
# --------------------------------------------------------------------------- #
def request_to_wire(req: Request) -> dict:
    return {
        "prompt_tokens": req.prompt_tokens,
        "max_new_tokens": req.max_new_tokens,
        "priority": req.priority,
        "client_id": req.client_id,
        "request_id": req.request_id,
        "features": req.features,
    }


def request_from_wire(d: dict) -> Request:
    # explicit request_id: the wire preserves the submitter's id stream, so
    # parent- and child-side bookkeeping (records, responses, router map)
    # key identically
    return Request(**d)


def response_to_wire(rsp: Response) -> dict:
    return {
        "request_id": rsp.request_id,
        "tokens": list(rsp.tokens),
        "ttft_s": rsp.ttft_s,
        "total_s": rsp.total_s,
        "stage_s": dict(rsp.stage_s),
    }


def response_from_wire(d: dict) -> Response:
    return Response(**d)


def record_to_wire(rec: RequestRecord) -> dict:
    return {
        "request_id": rec.request_id,
        "client_id": rec.client_id,
        "priority": rec.priority,
        "t_issue": rec.t_issue,
        "t_done": rec.t_done,
        "stage_s": dict(rec.stage_s),
        "cpu_s": rec.cpu_s,
        "bytes_in": rec.bytes_in,
        "bytes_out": rec.bytes_out,
        "transfer_wall_s": rec.transfer_wall_s,
    }


def record_from_wire(d: dict) -> RequestRecord:
    return RequestRecord(**d)


def _leaves(tree) -> list:
    """The tensors of a nested dict/list param tree, in a fixed order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def weight_checksum(params, n_elems: int = 1 << 16) -> str:
    """sha256 over the bytes of a few weight leaves (the first three and
    the last of the tree, up to ``n_elems`` elements each): a worker's
    init reply carries it, so the parent can show that the weights it
    rebuilt from the seed are the parent's bit for bit."""
    leaves = _leaves(params)
    h = hashlib.sha256()
    for t in leaves[:3] + leaves[-1:]:
        flat = t.detach().reshape(-1)[:n_elems].contiguous().cpu()
        h.update(str(t.dtype).encode())
        # read the bits through an integer dtype (numpy has no bfloat16)
        h.update(flat.view(_INT_OF_SIZE[flat.element_size()]).numpy()
                 .tobytes())
    return h.hexdigest()


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


# --------------------------------------------------------------------------- #
# orphan reaping: every live worker is registered here and terminated at
# interpreter exit, so error paths (or a crashed parent) never leak
# replica processes
# --------------------------------------------------------------------------- #
_LIVE_WORKERS: set = set()
_ATEXIT_ARMED = False


def _register_worker(proc) -> None:
    global _ATEXIT_ARMED
    _LIVE_WORKERS.add(proc)
    if not _ATEXIT_ARMED:
        atexit.register(_reap_all_workers)
        _ATEXIT_ARMED = True


def _unregister_worker(proc) -> None:
    _LIVE_WORKERS.discard(proc)


def _reap_all_workers() -> None:
    for proc in list(_LIVE_WORKERS):
        if proc.poll() is None:
            proc.terminate()
    deadline = time.monotonic() + 2.0
    for proc in list(_LIVE_WORKERS):
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        if proc.poll() is None:
            proc.kill()
        _LIVE_WORKERS.discard(proc)


# --------------------------------------------------------------------------- #
# parent-side client
# --------------------------------------------------------------------------- #
class ReplicaClient:
    """Parent-side handle on one replica worker process.

    Construction spawns the worker and completes the clock handshake;
    :meth:`start_init` / :meth:`wait_init` ship the engine spec and collect
    the (slow: model build, optional warm-up) acknowledgement, split so a
    cluster can overlap N workers' initialization instead of paying it
    serially. Every RPC failure raises :class:`ReplicaError`; a timeout
    kills the worker first, so a wedged replica never hangs the router.
    """

    def __init__(self, *, label: str = "replica",
                 spawn_timeout_s: float = 60.0, call_timeout_s: float = 120.0,
                 init_timeout_s: float = 600.0):
        self.label = label
        self.call_timeout_s = call_timeout_s
        self.init_timeout_s = init_timeout_s
        self.clock_offset = 0.0  # child perf_counter - parent perf_counter
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.request_payload_bytes = 0  # sum of submitted req.payload_bytes
        self._closed = False
        self._init_pending = False

        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)
        port = lsock.getsockname()[1]

        env = os.environ.copy()
        # the worker imports this package from the same source tree
        src_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src_root, env.get("PYTHONPATH", "")) if p
        )
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serving.worker",
             "--port", str(port)],
            env=env,
        )
        _register_worker(self.proc)
        try:
            lsock.settimeout(spawn_timeout_s)
            self.sock, _ = lsock.accept()
            self.sock.settimeout(call_timeout_s)
            # clock handshake: offset = t_child - midpoint(parent RTT).
            # The worker connects once its imports are done, so the sample
            # is a socket round trip, not an import stall.
            t0 = time.perf_counter()
            t_child = self._call("hello", None,
                                 timeout_s=spawn_timeout_s)["t_child"]
            t1 = time.perf_counter()
            self.clock_offset = t_child - 0.5 * (t0 + t1)
        except Exception as e:
            self._kill()
            raise ReplicaError(
                f"{self.label}: worker failed during spawn/handshake: {e}"
            ) from e
        finally:
            lsock.close()

    # ------------------------------------------------------------------ #
    def _kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
        _unregister_worker(self.proc)

    def _dead_error(self, context: str) -> ReplicaError:
        code = self.proc.poll()
        state = (f"exited with code {code}" if code is not None
                 else "still running but unresponsive")
        return ReplicaError(
            f"{self.label}: worker process {state} during {context!r} — "
            f"replica is lost (its queued/in-flight requests with it)"
        )

    def _call(self, op: str, payload, *, timeout_s: Optional[float] = None):
        if self._closed:
            raise ReplicaError(f"{self.label}: client already closed")
        t0 = time.perf_counter()
        sent = 0
        try:
            if timeout_s is not None:
                self.sock.settimeout(timeout_s)
            sent = send_msg(self.sock, op, payload)
            self.bytes_sent += sent
            rop, rpayload, n = recv_msg(self.sock)
        except socket.timeout as e:
            # a wedged worker must never hang the router: kill + surface
            self._kill()
            raise ReplicaError(
                f"{self.label}: RPC {op!r} timed out after "
                f"{timeout_s or self.call_timeout_s}s; worker killed"
            ) from e
        except (ConnectionClosed, ConnectionError, BrokenPipeError) as e:
            self._kill()
            raise self._dead_error(op) from e
        finally:
            if timeout_s is not None and not self._closed:
                try:
                    self.sock.settimeout(self.call_timeout_s)
                except OSError:
                    pass
        self.bytes_recv += n
        trace.tracer().emit(
            f"rpc.{op}", t0, time.perf_counter(), tag=self.label,
            bytes_sent=sent, bytes_recv=n,
        )
        if rop == "error":
            raise ReplicaError(
                f"{self.label}: worker raised during {op!r}:\n"
                f"{rpayload['traceback']}"
            )
        return rpayload

    # ------------------------------------------------------------------ #
    # protocol ops
    # ------------------------------------------------------------------ #
    def start_init(self, spec: dict) -> None:
        """Ship the engine spec without waiting for the ack (overlapped
        multi-replica construction); pair with :meth:`wait_init`."""
        self.bytes_sent += send_msg(self.sock, "init", spec)
        self._init_pending = True

    def wait_init(self) -> dict:
        try:
            self.sock.settimeout(self.init_timeout_s)
            rop, rpayload, n = recv_msg(self.sock)
            self.sock.settimeout(self.call_timeout_s)
        except socket.timeout as e:
            self._kill()
            raise ReplicaError(
                f"{self.label}: init timed out after {self.init_timeout_s}s "
                f"(model build + warm-up); worker killed"
            ) from e
        except (ConnectionClosed, ConnectionError) as e:
            self._kill()
            raise self._dead_error("init") from e
        self._init_pending = False
        self.bytes_recv += n
        if rop == "error":
            raise ReplicaError(
                f"{self.label}: worker failed to initialize:\n"
                f"{rpayload['traceback']}"
            )
        return rpayload

    def init(self, spec: dict) -> dict:
        self.start_init(spec)
        return self.wait_init()

    def submit(self, req: Request) -> dict:
        """Submit one request; returns the worker's fresh load snapshot."""
        self.request_payload_bytes += req.payload_bytes
        return self._call("submit", request_to_wire(req))

    def _ingest_spans(self, out: dict) -> None:
        """Fold worker-emitted spans (piggybacked on the reply frame) into
        the parent's trace buffer, rebased onto the parent clock via the
        handshake ``clock_offset`` and relabeled with this replica's
        label so the merged timeline names the process."""
        spans = out.get("spans")
        if spans:
            trace.tracer().ingest_wire(
                spans, offset=self.clock_offset, process=self.label
            )

    def harvest(self):
        """Finished (Response, RequestRecord) pairs + the load snapshot."""
        out = self._call("harvest", None)
        self._ingest_spans(out)
        pairs = [
            (response_from_wire(r), record_from_wire(rec))
            for r, rec in out["done"]
        ]
        return pairs, out["load"]

    def load(self) -> dict:
        return self._call("load", None)

    def telemetry(self) -> dict:
        out = self._call("telemetry", None)
        self._ingest_spans(out)
        return out

    def drain(self, deadline_s: float = 120.0):
        """Block until the worker's pipeline is idle (or the deadline
        lapses worker-side); returns the remaining finished pairs."""
        out = self._call("drain", {"deadline_s": deadline_s},
                         timeout_s=deadline_s + 10.0)
        self._ingest_spans(out)
        return [
            (response_from_wire(r), record_from_wire(rec))
            for r, rec in out["done"]
        ]

    # ------------------------------------------------------------------ #
    def close(self, timeout_s: float = 10.0) -> None:
        """Graceful shutdown: RPC shutdown -> wait -> terminate -> kill.
        Idempotent; never raises (close runs on error paths)."""
        if self._closed:
            return
        self._closed = True
        try:
            self.sock.settimeout(timeout_s)
            send_msg(self.sock, "shutdown", None)
            recv_msg(self.sock)
        except Exception:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        _unregister_worker(self.proc)

    def __enter__(self) -> "ReplicaClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
