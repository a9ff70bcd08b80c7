"""The port stands alone: importing every ``repro_torch`` module (the
training package and its launcher among them) loads neither JAX nor the
``repro`` package, no source file of the port imports them, a replica
worker process the cluster spawns loads neither, and its entry points
(serving and training) refuse to fall back to the CPU on their own."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_imports_jax_or_repro():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"):
                    offenders.append(f"{path.relative_to(ROOT)}: {n}")
    assert not offenders, offenders


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] not in ("jax", "repro")
                       for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.split(".")[0] not in ("jax", "repro")


def test_chip_ab_imports_nothing_of_jax_or_repro_and_needs_a_card():
    tree = ast.parse((ROOT / "chip_ab.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] not in ("jax", "repro")
                       for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.split(".")[0] not in ("jax", "repro")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the A/B would run")
    proc = subprocess.run(
        [sys.executable, "chip_ab.py", "src", "cpu"], capture_output=True,
        text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "no CUDA device" in proc.stdout
    assert "{" not in proc.stdout


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine

    cfg = get_config("llama3-8b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "llama3-8b", "--reduced"])


def test_training_entry_points_need_cuda_unless_asked_for_cpu():
    """The training launcher and ``train`` run on the card by default and
    never carry on on the CPU by themselves."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.training import DataConfig, TrainConfig, train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "llama3-8b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "llama3-8b", "--steps", "1"])
    cfg = get_config("llama3-8b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(Model(cfg), DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                     batch_size=1), TrainConfig(steps=1))


def test_launcher_serves_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                      "--clients", "2", "--requests", "1",
                      "--prompt-len", "4:12", "--new-tokens", "3"])
    assert len(out["responses"]) == 2
    assert all(len(r.tokens) == 3 for r in out["responses"])
    assert "ttft p50/p99" in capsys.readouterr().out
    np.testing.assert_array_equal(
        sorted(r.request_id for r in out["responses"]),
        sorted(rec.request_id for rec in out["engine"].store.records))


def test_spawned_worker_loads_no_jax_and_no_repro():
    """A process replica (``python -m repro_torch.serving.worker``) built
    and serving on the CPU reports no JAX or ``repro`` module in its
    ``sys.modules``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving import Request
    from repro_torch.serving.ipc import ReplicaClient

    cfg = dataclasses.replace(
        get_config("llama3-8b").reduced(), d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=32)
    client = ReplicaClient(label="isolated", init_timeout_s=120.0)
    try:
        client.init({"cfg": cfg, "dtype": "float32", "param_seed": 0,
                     "device": "cpu", "engine": "fused",
                     "engine_kw": dict(max_batch=2, max_seq=32),
                     "backlog": 2})
        client.submit(Request(prompt_tokens=np.arange(6, dtype=np.int32),
                              max_new_tokens=3))
        assert len(client.drain(60.0)) == 1
        assert client.telemetry()["foreign_modules"] == []
    finally:
        client.close()
    assert client.proc.poll() is not None
