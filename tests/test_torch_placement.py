"""Pod placement of the port's disaggregated tier and cluster against the
JAX package's (tests/test_placement.py and the cluster's pod slices).

PodPlacement on the degenerate one-device mesh; ``pod_slice_mesh``'s
errors; a placement over another mesh and a multi-axis mesh with
placement on refused as JAX refuses them; the tier's tokens identical with
placement on and off and equal to the JAX tier's, on the default 1-pod
mesh and on a hand-built 2-slot pod mesh that names the CPU twice (the
prefill stage on pod 0, the decode stage on pod 1, either way round:
each stage's params, pool and hop endpoints follow its pod); the cluster's
``mesh`` and ``pods_per_replica`` giving JAX's replica slices and the JAX
cluster's tokens (fp32, llama3-8b-micro)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.transfer import TransferMode as JaxMode  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import DisaggregatedEngine as JaxDisagg  # noqa: E402
from repro.serving import ServingCluster as JaxCluster  # noqa: E402
from repro.serving.cluster import replica_pod_slices as jax_slices  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transfer import TransferMode  # noqa: E402
from repro_torch.launch.mesh import DeviceMesh, make_cluster_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DisaggregatedEngine,
    PodPlacement,
    Request,
    ServingCluster,
    ServingEngine,
    make_pod_mesh,
)
from repro_torch.sharding.partition import (  # noqa: E402
    place_on_slice,
    pod_slice_mesh,
)

LENS = [5, 9, 17, 26]
KW = dict(max_batch=2, max_seq=64)
CPU2 = DeviceMesh(["cpu", "cpu"], ("pod",))


def micro(cfg):
    """benchmarks/serving.py's llama3-8b-micro."""
    import dataclasses

    return dataclasses.replace(
        cfg.reduced(), name="llama3-8b-micro", d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=32)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(micro(jax_get_config("llama3-8b")), dtype=jnp.float32)
    jp = jm.init(jax.random.key(1))
    cfg = micro(get_config("llama3-8b"))
    tm = Model(cfg, dtype=torch.float32, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX tier's greedy tokens on its default placement."""
    jm, jp, _, _ = models
    eng = JaxDisagg(jm, jp, transfer_mode=JaxMode.DIRECT_HBM, **KW)
    return _drain(eng, JaxRequest, jm.cfg.vocab_size)


def _drain(eng, req_cls, vocab, lens=LENS, max_new=4):
    rng = np.random.default_rng(7)
    reqs = [req_cls(prompt_tokens=rng.integers(0, vocab, s, dtype=np.int32),
                    max_new_tokens=max_new) for s in lens]
    for r in reqs:
        eng.submit(r, time.perf_counter())
    assert len(eng.run_until_drained()) == len(reqs)
    return [list(r.generated) for r in reqs]


def _devices(tree):
    if isinstance(tree, dict):
        return set().union(*(_devices(v) for v in tree.values()))
    if isinstance(tree, list):
        return set().union(*(_devices(v) for v in tree))
    return {tree.device}


# --------------------------------------------------------------------------- #
# PodPlacement and the slices
# --------------------------------------------------------------------------- #
def test_pod_placement_from_mesh_degenerate():
    mesh = make_pod_mesh(device="cpu")  # 1 pod on the one CPU device
    assert mesh.shape == {"pod": 1}
    pl = PodPlacement.from_mesh(mesh)
    assert pl.prefill_pods == (0,)
    assert pl.decode_pods == (mesh.shape["pod"] - 1,)
    assert not pl.disjoint  # both stages collapse onto one device
    assert pl.prefill_devices() == pl.decode_devices() == (torch.device("cpu"),)
    assert pl.prefill_sharding().is_fully_replicated
    assert pl.decode_sharding().is_fully_replicated
    two = PodPlacement.from_mesh(CPU2)
    assert two.disjoint and two.decode_pods == (1,)
    assert make_cluster_mesh(2, 2, device="cpu").shape == {"pod": 1}


def test_pod_slice_mesh_validation():
    mesh = make_pod_mesh(device="cpu")
    with pytest.raises(ValueError, match="empty"):
        pod_slice_mesh(mesh, ())
    with pytest.raises(ValueError, match="out of range"):
        pod_slice_mesh(mesh, (99,))
    with pytest.raises(ValueError, match="no 'nope' axis"):
        pod_slice_mesh(mesh, (0,), axis="nope")
    sub = pod_slice_mesh(mesh, (0,))
    assert sub.axis_names == mesh.axis_names
    assert sub.shape["pod"] == 1
    assert pod_slice_mesh(CPU2, (1,)) == pod_slice_mesh(CPU2, (1,))
    w = torch.arange(8.0).reshape(4, 2)
    whole = place_on_slice({"w": w}, CPU2, (1,))["w"]
    assert whole is w  # replicated: the slice's device, no copy
    split = place_on_slice({"w": w}, CPU2, (0, 1), ("pod",))["w"]
    assert split.counts() == (2, 1) and torch.equal(split.gather(), w)
    with pytest.raises(ValueError, match="npods 2 > available devices 1"):
        make_pod_mesh(2, device="cpu")


def test_placement_mesh_mismatch_rejected(models):
    _, _, tm, tp = models
    other = pod_slice_mesh(CPU2, (0,))
    assert other != CPU2
    with pytest.raises(ValueError, match="placement.mesh"):
        DisaggregatedEngine(tm, tp, mesh=CPU2,
                            placement=PodPlacement.from_mesh(other),
                            device="cpu", max_batch=1, max_seq=32)


def test_multi_axis_mesh_with_placement_rejected(models):
    _, _, tm, tp = models
    multi = DeviceMesh([["cpu", "cpu"]], ("pod", "model"))
    with pytest.raises(ValueError, match="placement=False"):
        DisaggregatedEngine(tm, tp, mesh=multi, device="cpu", **KW)
    off = DisaggregatedEngine(tm, tp, mesh=multi, placement=False,
                              device="cpu", **KW)
    assert off.placement is None


# --------------------------------------------------------------------------- #
# the tier's tokens
# --------------------------------------------------------------------------- #
def test_placement_default_on_tokens_identical(models, jax_tokens):
    """Default placement on the degenerate mesh: both stages on the one
    device sharing one params tree, tokens the fused engine's and JAX's;
    placement=False keeps the params as given."""
    _, _, tm, tp = models
    base = _drain(ServingEngine(tm, tp, device="cpu", **KW), Request,
                  tm.cfg.vocab_size)
    eng = DisaggregatedEngine(tm, tp, transfer_mode=TransferMode.DIRECT_HBM,
                              device="cpu", **KW)
    assert eng.placement is not None  # on by default
    assert _drain(eng, Request, tm.cfg.vocab_size) == base == jax_tokens
    ddev = set(eng.placement.decode_devices())
    assert _devices(eng.pool.caches) == ddev
    assert _devices(eng.decode_params) == ddev
    assert not eng.placement.disjoint
    assert eng.decode_params is eng.prefill_params  # one copy, not two
    off = DisaggregatedEngine(tm, tp, transfer_mode=TransferMode.DIRECT_HBM,
                              placement=False, device="cpu", **KW)
    assert off.placement is None
    assert off.prefill_params is tp and off.decode_params is tp
    assert _drain(off, Request, tm.cfg.vocab_size) == base


@pytest.mark.parametrize("mode", [TransferMode.DIRECT_HBM,
                                  TransferMode.DIRECT_DMA,
                                  TransferMode.HOST_STAGED])
def test_two_slot_pod_mesh_tokens_identical(models, jax_tokens, mode):
    """A 2-slot pod mesh that names the CPU twice: prefill on pod 0, decode
    on pod 1, each stage's params and pool on its pod's device, no weight
    copied (one device), the hop between the pods; tokens equal to JAX's
    (HOST_STAGED's int8 hop: the first tokens)."""
    _, _, tm, tp = models
    eng = DisaggregatedEngine(tm, tp, transfer_mode=mode, mesh=CPU2,
                              device="cpu", **KW)
    pl = eng.placement
    assert pl.disjoint and (eng.prefill_pod, eng.decode_pod) == (0, 1)
    # disjoint pods on one device: one params tree, its tensors the caller's
    assert eng.prefill_params is eng.decode_params
    assert all(a is b for a, b in zip(eng.prefill_params["decoder"]["g0"][0]
                                      ["l0"]["attn"].values(),
                                      tp["decoder"]["g0"][0]["l0"]["attn"]
                                      .values()))
    assert _devices(eng.pool.caches) == set(pl.decode_devices())
    assert eng._bufs.src_device == pl.prefill_devices()[0]
    assert eng._bufs.device == pl.decode_devices()[0]
    toks = _drain(eng, Request, tm.cfg.vocab_size)
    assert eng.handoffs > 0 and eng.handoff_wire_bytes > 0
    if mode is TransferMode.HOST_STAGED:
        assert [t[0] for t in toks] == [t[0] for t in jax_tokens]
    else:
        assert toks == jax_tokens


def test_reversed_pods_and_an_explicit_placement(models, jax_tokens):
    _, _, tm, tp = models
    eng = DisaggregatedEngine(tm, tp, mesh=CPU2, prefill_pod=1, decode_pod=0,
                              device="cpu", **KW)
    assert (eng.placement.prefill_pods, eng.placement.decode_pods) == \
        ((1,), (0,))
    assert _drain(eng, Request, tm.cfg.vocab_size) == jax_tokens
    pl = PodPlacement(CPU2, (0,), (0,))
    same = DisaggregatedEngine(tm, tp, mesh=CPU2, placement=pl, device="cpu",
                               **KW)
    assert not same.placement.disjoint
    assert same.decode_params is same.prefill_params
    assert tm.on("cpu") is tm


# --------------------------------------------------------------------------- #
# the cluster's pod slices
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", ["fused", "disagg"])
def test_cluster_mesh_and_pods_per_replica(models, engine):
    """A 4-slot pod mesh carved as JAX carves it: fused replicas one pod
    each (two replicas take pods 0 and 1), disaggregated ones two
    (``pods_per_replica=2``: (0, 1) and (2, 3)); the tokens the JAX
    cluster's on its one device, the routing the same."""
    jm, jp, tm, tp = models
    ppr = 1 if engine == "fused" else 2
    mesh = DeviceMesh(["cpu"] * 4, ("pod",))
    cl = ServingCluster.build(tm, tp, n_replicas=2, engine=engine, mesh=mesh,
                              pods_per_replica=ppr, policy="round_robin",
                              device="cpu", **KW)
    assert cl.mesh is mesh
    assert [r.pods for r in cl.replicas] == jax_slices(4, 2, ppr)
    if engine == "disagg":
        assert [(r.engine.prefill_pod, r.engine.decode_pod)
                for r in cl.replicas] == [(0, 1), (0, 1)]
        assert all(r.engine.placement.disjoint for r in cl.replicas)
    # one device: the replicas share one params tree
    assert cl.replicas[0].engine.params is cl.replicas[1].engine.params
    jcl = JaxCluster.build(jm, jp, n_replicas=2, engine=engine,
                           policy="round_robin", **KW)
    assert [r.pods for r in jcl.replicas] == jax_slices(
        jcl.mesh.shape["pod"], 2, ppr)
    assert _drain(cl, Request, tm.cfg.vocab_size) == \
        _drain(jcl, JaxRequest, jm.cfg.vocab_size)
    assert [r.routed for r in cl.replicas] == [r.routed for r in jcl.replicas]
