"""Render the roofline and dry-run tables from the port's dry-run records
(``experiments/dryrun_torch/*.json``, written by ``repro_torch.launch.dryrun``):
the JAX package's ``launch/report.py`` with the same two tables and
columns, read from the port's directory.

Usage: PYTHONPATH=src python -m repro_torch.launch.report [MESH]  (16x16)
"""

from __future__ import annotations

import glob
import json
import os

DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                   "dryrun_torch")

SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def load(mesh: str = "16x16"):
    rows = []
    for path in glob.glob(os.path.join(DIR, f"*__{mesh}*.json")):
        with open(path) as f:
            rows.append(json.load(f))
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9)))
    return rows


def fmt_ms(s):
    return f"{s*1e3:.1f}"


def roofline_table(mesh: str = "16x16") -> str:
    rows = load(mesh)
    out = [
        "| arch | shape | step | t_comp (ms) | t_mem (ms) | t_coll (ms) | bottleneck | useful flops | peak GiB/dev |",
        "|---|---|---|---:|---:|---:|---|---:|---:|",
    ]
    for r in rows:
        if "skip" in r:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['step']} | {fmt_ms(r['t_compute'])} "
            f"| {fmt_ms(r['t_memory'])} | {fmt_ms(r['t_collective'])} "
            f"| {r['bottleneck']} | {r['useful_flops_fraction']*100:.1f}% "
            f"| {r['peak_bytes_per_device']/2**30:.1f} |"
        )
    return "\n".join(out)


def dryrun_table(mesh: str = "16x16") -> str:
    rows = load(mesh)
    out = [
        "| arch | shape | step | HLO GFLOP/dev | HLO GB/dev | coll GB/dev | args GiB/dev | collective mix |",
        "|---|---|---|---:|---:|---:|---:|---|",
    ]
    for r in rows:
        if "skip" in r:
            continue
        mix = ", ".join(
            f"{k.split('_')[0] if k.endswith('count') else k}:{int(v)}"
            for k, v in sorted(r.get("coll_breakdown", {}).items())
            if k.endswith("_count")
        ) or "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['step']} | {r['hlo_flops']/1e9:.1f} "
            f"| {r['hlo_bytes']/1e9:.1f} | {r['coll_bytes']/1e9:.2f} "
            f"| {r['arg_bytes_per_device']/2**30:.2f} | {mix} |"
        )
    skips = [r for r in rows if "skip" in r]
    for r in skips:
        out.append(f"| {r['arch']} | {r['shape']} | SKIP | - | - | - | - | {r['skip']} |")
    return "\n".join(out)


if __name__ == "__main__":
    import sys

    mesh = sys.argv[1] if len(sys.argv) > 1 else "16x16"
    print("## Roofline\n")
    print(roofline_table(mesh))
    print("\n## Dry-run\n")
    print(dryrun_table(mesh))
