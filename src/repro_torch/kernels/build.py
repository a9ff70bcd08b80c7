"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` compiles with plain ``nvcc`` for ``sm_90a`` into its
own shared library with a C interface, loaded through :mod:`ctypes`. No
PyTorch header is included, so a build takes seconds, not minutes. A
library's file name carries a hash of its sources, so an edited kernel is
never served from a stale build. Builds land in ``build/repro_torch_kernels/``
at the repository root (listed in ``.gitignore``) at first use;
:func:`build_all` starts one ``nvcc`` per source, all at once.

Every launcher calls its C entry point through a :class:`CFunction`: the
ctypes function and its ``argtypes`` are resolved once, the current stream
of the tensors' device is appended as the last argument at each call
(looked up from PyTorch, never cached), the call runs with that device
current, and a non-zero ``cudaError_t`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("rmsnorm", "flash_attention", "flash_attention_bwd",
           "decode_attention", "paged_decode_attention", "ssd_scan",
           "ssd_scan_bwd", "mla_decode_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's stderr (ptxas -v) per source, from the build that made its library
# (kept beside it as ``.log``, so a library built earlier still reports it)
build_log: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if not cand.exists():
            raise RuntimeError(
                "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
                "repro_torch are built on the machine with the card"
            )
        path = str(cand)
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        log = out.with_suffix(".log")
        if log.exists():
            build_log[name] = log.read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    stdout, stderr = proc.communicate()
    build_log[name] = stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{stdout}\n{stderr}")
    out.with_suffix(".log").write_text(stderr)
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every kernel source not yet built, one ``nvcc`` per source
    in parallel. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SOURCES}
    errors = []
    for name, st in started.items():
        try:
            _finish(name, st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


class CFunction:
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, whose last
    parameter is the stream and whose result is a ``cudaError_t``.

    ``fn(device_index, *args)`` launches on the current stream of that
    device, with that device current, and raises on a non-zero result. The
    launchers read the current device (``cudaGetDevice``: the shared-memory
    opt-in, the SM count), so a launch for one card issued while another
    is current would go wrong: the call switches the current device for
    its duration where it differs (one C call to compare where it does
    not). The library is built and the function resolved at the first
    call, so creating one needs no compiler."""

    __slots__ = ("source", "symbol", "argtypes", "_fn", "_stream",
                 "_get_device", "_set_device")

    def __init__(self, source: str, symbol: str, argtypes):
        self.source, self.symbol = source, symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # the stream
        self._fn = None
        self._stream = None
        self._get_device = self._set_device = None

    def _resolve(self):
        fn = getattr(load(self.source), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        # the raw ``cudaStream_t`` of PyTorch's current stream on a device:
        # one C call, no Python ``Stream`` object (what PyTorch's own
        # generated launchers call)
        self._stream = torch._C._cuda_getCurrentRawStream
        self._get_device = torch._C._cuda_getDevice
        self._set_device = torch._C._cuda_setDevice
        return fn

    def __call__(self, device_index: int, *args) -> None:
        fn = self._fn or self._resolve()
        cur = self._get_device()
        if cur == device_index:
            err = fn(*args, self._stream(device_index))
        else:
            self._set_device(device_index)
            try:
                err = fn(*args, self._stream(device_index))
            finally:
                self._set_device(cur)
        if err:
            raise RuntimeError(f"{self.symbol} kernel launch failed: "
                               f"cudaError {err}")
