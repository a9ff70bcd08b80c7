"""The port's examples (``examples/*_torch.py``) run on the CPU against the
JAX package's originals.

Each runs as a user runs it, in a process of its own with ``--device cpu``
where it runs a model, at small arguments; the processes start together in
one module fixture, beside JAX's side:

* ``quickstart_torch.py`` prints ``examples/quickstart.py``'s simulator
  table line for line;
* ``disaggregated_prefill_torch.py`` moves, under each mechanism, the wire
  bytes and handoffs of JAX's ``DisaggregatedEngine`` on the same prompt
  lengths and engine sizes (its lines and its exact byte counts), and the
  direct mechanisms give the fused engine's tokens;
* ``serve_llm_torch.py`` completes every request under each transport;
* ``train_tiny_torch.py`` trains with a falling loss.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.transfer import MODE_TRANSPORT, TransferMode  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import DisaggregatedEngine  # noqa: E402
from repro.serving.request import Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
SERVE = dict(clients=2, requests=1)
RUNS = {
    "quickstart_torch.py": [],
    "serve_llm_torch.py": ["--device", "cpu", "--clients",
                           str(SERVE["clients"]), "--requests",
                           str(SERVE["requests"]), "--new-tokens", "4"],
    "disaggregated_prefill_torch.py": ["--device", "cpu"],
    "train_tiny_torch.py": ["--device", "cpu", "--steps", "40", "--batch",
                            "4", "--seq", "64"],
    "quickstart.py": [],  # the JAX original
}
# disaggregated_prefill.py's (and its port's) requests and engine sizes
DISAGG_LENS = [6, 11, 19, 27]
DISAGG_KW = dict(max_batch=2, max_seq=64)


def _jax_disagg():
    """JAX's tier on the original example's prompts: per mechanism (wire
    bytes, handoffs, padded-tree bytes a handoff)."""
    cfg = jax_get_config("llama3-8b").reduced()
    model = JaxModel(cfg)
    params = model.init(jax.random.key(0))
    out = {}
    for mode in TransferMode:
        eng = DisaggregatedEngine(model, params, transfer_mode=mode,
                                  **DISAGG_KW)
        rng = np.random.default_rng(0)
        for s in DISAGG_LENS:
            eng.submit(Request(prompt_tokens=rng.integers(
                0, cfg.vocab_size, s, dtype=np.int32), max_new_tokens=4),
                time.perf_counter())
        assert len(eng.run_until_drained()) == len(DISAGG_LENS)
        out[mode.value] = (eng.handoff_wire_bytes, eng.handoffs,
                           eng.padded_tree_wire_bytes())
    return out


@pytest.fixture(scope="module")
def runs():
    """Every example's (rc, stdout, stderr), and JAX's tier, run while the
    example processes run."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name), *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in RUNS.items()}
    try:
        jax_tier = _jax_disagg()
        out = {}
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out["jax_tier"] = jax_tier
    return out


def _ok(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, stdout + stderr
    return stdout


def test_quickstart_prints_the_jax_originals_table(runs):
    got = _ok(runs, "quickstart_torch.py").splitlines()
    want = _ok(runs, "quickstart.py").splitlines()
    assert len(got) == 7
    assert got == want


def test_disaggregated_wire_bytes_equal_the_jax_tiers(runs):
    text = _ok(runs, "disaggregated_prefill_torch.py")
    wire = json.loads(re.search(r"wire bytes by mechanism: (\{.*\})",
                                text).group(1))
    jax_tier = runs["jax_tier"]
    assert wire == {m: w for m, (w, _, _) in jax_tier.items()}
    for mode in TransferMode:
        w, n, padded = jax_tier[mode.value]
        line = next(x for x in text.splitlines()
                    if x.strip().startswith(mode.value))
        assert (f"{mode.value:12s} ({MODE_TRANSPORT[mode].value:4s}): "
                f"{w / 1e3:7.1f} KB on the wire over {n} handoffs "
                f"({w / (n * padded):.0%} of the padded admission trees)"
                in line), line
        if mode is not TransferMode.HOST_STAGED:
            assert line.endswith("tokens vs fused engine: 100%"), line
    assert "1-pod mesh" in text and "degenerate shared slice" in text


def test_serve_llm_completes_every_request(runs):
    text = _ok(runs, "serve_llm_torch.py")
    served = re.findall(r"^\s+(\w+)\s*: (\d+) requests in", text, re.M)
    n = SERVE["clients"] * SERVE["requests"]
    assert served == [("gdr", str(n)), ("rdma", str(n)), ("tcp", str(n))]


def test_train_tiny_loss_falls(runs):
    text = _ok(runs, "train_tiny_torch.py")
    first, last = map(float, re.search(r"loss ([\d.]+) -> ([\d.]+)",
                                       text).groups())
    assert np.isfinite([first, last]).all() and last < first
    assert "LEARNING" in text
