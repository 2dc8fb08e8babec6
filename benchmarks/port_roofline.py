"""Roofline of the port's dry run on one NVIDIA H100, the counterpart of
`benchmarks/roofline.py`.

Per (arch x shape) cell on the single-pod mesh, from the records that

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --both-meshes --out chiprun_out/dryrun_results.json

writes (per rank, counted by `repro_torch.launch.hlo_cost`):
    compute    = flops / PEAK_FLOPS
    memory     = hbm_bytes / HBM_BW      (eager, unfused: every op's
                                          operands and outputs)
    collective = collective_bytes / LINK_BW  (per-rank result bytes)
plus MODEL_FLOPS (3 x forward `flops_per_token` x tokens / CHIPS for a
training step) and the useful-compute ratio MODEL_FLOPS / counted flops,
which exposes remat and the port's unpartitioned compute.

Hardware model, one H100 SXM at its 700 W power limit, from NVIDIA's
published peaks: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s
of HBM3, 450 GB/s of NVLink each way; 256 such cards for the single
pod.  (The reference's 197 TFLOP/s, 819 GB/s and 50 GB/s are a TPU
v5e's.)

    PYTHONPATH=src python -m benchmarks.port_roofline [--results PATH]

This module imports neither JAX nor the reference package.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.registry import SHAPES

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
CHIPS = 256
CARD_BYTES = 80e9             # one H100's memory, for the peak column
RESULTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chiprun_out", "dryrun_results.json")
DRYRUN_CMD = ("PYTHONPATH=src python -m repro_torch.launch.dryrun --all "
              "--both-meshes --out chiprun_out/dryrun_results.json")


def model_flops(arch: str, shape_name: str) -> float:
    """Useful model flops per device per step (forward [+backward])."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        per_tok = cfg.flops_per_token(shape.seq_len)   # forward only
        return 3.0 * per_tok * tokens / CHIPS          # fwd + bwd = 3x fwd
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return cfg.flops_per_token(shape.seq_len) * tokens / CHIPS
    # decode: one token per sequence; attention reads the whole cache
    return cfg.flops_per_token(shape.seq_len) * shape.global_batch / CHIPS


def analyze_cell(rec: dict) -> dict | None:
    if not rec.get("ok") or rec.get("skipped"):
        return None
    cost = rec.get("cost") or {}
    flops = cost.get("flops") or 0.0
    hbm = cost.get("hbm_bytes") or 0.0
    coll = cost.get("collective_bytes", 0.0) or sum(
        rec.get("collectives", {}).values())
    t_c = flops / PEAK_FLOPS
    t_m = hbm / HBM_BW
    t_x = coll / LINK_BW
    dominant = max((("compute", t_c), ("memory", t_m),
                    ("collective", t_x)), key=lambda kv: kv[1])[0]
    mf = model_flops(rec["arch"], rec["shape"])
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": (mf / flops) if flops else 0.0,
        "peak_gb": (rec.get("memory", {}).get("peak_bytes") or 0) / 2**30,
        "roofline_fraction": t_c / max(t_c, t_m, t_x) if max(
            t_c, t_m, t_x) > 0 else 0.0,
    }


def _records(results_path: str) -> list:
    if not os.path.exists(results_path):
        raise FileNotFoundError(f"{results_path}: no dry-run results; "
                                f"write them first with `{DRYRUN_CMD}`")
    with open(results_path) as f:
        return json.load(f)


def table(results_path: str = RESULTS, mesh: str = "16x16") -> list[dict]:
    rows = []
    for rec in _records(results_path):
        if rec.get("mesh") != mesh:
            continue
        row = analyze_cell(rec)
        if row:
            rows.append(row)
        elif rec.get("skipped"):
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec["mesh"], "skipped": True})
    return rows


def markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "dominant | useful ratio | peak GB |\n|---|---|---|---|---|"
           "---|---|---|")
    lines = [hdr]
    for r in rows:
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped (full attention) | — | — |")
            continue
        lines.append(
            "| {arch} | {shape} | {compute_s:.3f} | {memory_s:.3f} | "
            "{collective_s:.3f} | {dominant} | {useful_ratio:.2f} | "
            "{peak_gb:.1f} |".format(**r))
    return "\n".join(lines)


def run(fast: bool = False, *, device="cuda",
        results_path: str = RESULTS) -> list[dict]:
    """The single-pod table of `results_path` (host arithmetic; `fast`
    and `device` are accepted for the harness)."""
    from benchmarks.port_common import emit, timed
    with timed("cpu") as t:
        rows = table(results_path)
    analyzed = [r for r in rows if not r.get("skipped")]
    dom = {}
    for r in analyzed:
        dom[r["dominant"]] = dom.get(r["dominant"], 0) + 1
    over = sum(r["peak_gb"] * 2**30 > CARD_BYTES for r in analyzed)
    emit("roofline_table", t.us,
         f"cells={len(rows)}|dominant:{dom}|"
         f"worst_useful_ratio={min((r['useful_ratio'] for r in analyzed), default=0):.2f}|"
         f"peak_over_80GB={over}/{len(analyzed)}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    print(markdown(run(results_path=args.results)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
