"""Quickstart on the PyTorch port: the paper's experiment in 40 lines.

Compares the four transport mechanisms on a single-client ResNet50 serving
pipeline (paper Fig. 5/6) and prints the per-stage latency breakdown that
off-the-shelf serving systems don't expose. The port's simulator
(``repro_torch.core``) models the paper's testbed, so this needs no card
and prints what ``examples/quickstart.py`` prints.

Run: PYTHONPATH=src python examples/quickstart_torch.py
"""

from repro_torch.core.simulator import (
    ScenarioConfig,
    local_reference,
    run_scenario,
)
from repro_torch.core.transport import Transport
from repro_torch.core.workloads import TABLE_II

WORKLOAD = TABLE_II["resnet50"]

print(f"{'transport':10s} {'total':>9s} {'request':>9s} {'copy':>9s} "
      f"{'preproc':>9s} {'infer':>9s} {'response':>9s}")

loc = local_reference(ScenarioConfig(workload=WORKLOAD)) * 1e3
print(f"{'local':10s} {loc:8.2f}ms {'-':>9s} {'-':>9s} {'':>9s} {'':>9s} {'-':>9s}")

for transport in (Transport.GDR, Transport.RDMA, Transport.TCP):
    store = run_scenario(ScenarioConfig(workload=WORKLOAD, transport=transport))
    m = store.stage_means()
    total = store.summary()["mean"] * 1e3
    print(
        f"{transport.value:10s} {total:8.2f}ms "
        f"{m['request']*1e3:8.3f}m {m['copy_in']*1e3+m['copy_out']*1e3:8.3f}m "
        f"{m['preprocess']*1e3:8.3f}m {m['inference']*1e3:8.3f}m "
        f"{m['response']*1e3:8.3f}m"
    )

tcp = run_scenario(ScenarioConfig(workload=WORKLOAD, transport=Transport.TCP))
gdr = run_scenario(ScenarioConfig(workload=WORKLOAD, transport=Transport.GDR))
save = 1 - gdr.summary()["mean"] / tcp.summary()["mean"]
print(f"\nGDR saves {save:.1%} of end-to-end latency vs TCP "
      f"(paper: 15-50% across setups)")
