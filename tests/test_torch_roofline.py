"""The port's roofline and framework benches (`benchmarks/port_roofline.py`,
`benchmarks/port_framework.py`) on the CPU, held to the reference's
(`benchmarks/roofline.py`, `benchmarks/framework.py`) computed in the
test:
  * `model_flops` of every (arch, shape) equals the reference's;
  * `analyze_cell`, `table` and `markdown` equal the reference's on the
    same records, with the reference module's hardware constants set to
    the port's H100 ones for the test alone;
  * `run` without the dry run's results raises FileNotFoundError naming
    the command that writes them;
  * `run_straggler` equals the reference's result (the same numpy
    draws), and `run_compression`'s wire and dense bytes equal the
    reference's.
"""

import json

import pytest

from benchmarks import port_framework, port_roofline
from repro_torch.configs import ARCHS
from repro_torch.configs.registry import SHAPES
from _torch_parity import one_thread as _one_thread  # noqa: F401


@pytest.fixture
def ref_roofline(monkeypatch):
    from benchmarks import roofline as ref
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "CHIPS"):
        monkeypatch.setattr(ref, name, getattr(port_roofline, name))
    return ref


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_are_the_references(arch, shape):
    from benchmarks import roofline as ref
    assert port_roofline.model_flops(arch, shape) == ref.model_flops(arch,
                                                                     shape)


def _records() -> list[dict]:
    """A compute-, a memory- and a collective-bound cell, a skip record,
    a failed cell and a cell of the other mesh."""
    def cell(arch, shape, mesh, flops, hbm, coll, peak):
        return {"arch": arch, "shape": shape, "mesh": mesh, "ok": True,
                "cost": {"flops": flops, "hbm_bytes": hbm,
                         "collective_bytes": coll},
                "collectives": {"all-gather": coll},
                "memory": {"peak_bytes": peak}}
    return [
        cell("glm4-9b", "train_4k", "16x16", 9.5e15, 1.2e13, 3.1e11, 9e10),
        cell("rwkv6-3b", "decode_32k", "16x16", 2.2e10, 4.4e11, 1.5e9, 3e9),
        cell("mistral-large-123b", "prefill_32k", "16x16", 1e12, 1e11,
             7.7e12, 3e11),
        {"arch": "glm4-9b", "shape": "long_500k", "mesh": "16x16",
         "ok": True, "skipped": "pure full-attention arch (DESIGN.md §5)"},
        {"arch": "qwen2.5-14b", "shape": "train_4k", "mesh": "16x16",
         "ok": False, "error": "RuntimeError: x"},
        cell("glm4-9b", "train_4k", "2x16x16", 5e15, 6e12, 3e11, 5e10),
    ]


def test_analyze_cell_and_markdown_are_the_references(ref_roofline,
                                                      tmp_path):
    recs = _records()
    for rec in recs:
        assert port_roofline.analyze_cell(rec) == \
            ref_roofline.analyze_cell(rec)
    path = tmp_path / "dryrun_results.json"
    path.write_text(json.dumps(recs))
    for mesh in ("16x16", "2x16x16"):
        rows = port_roofline.table(str(path), mesh)
        assert rows == ref_roofline.table(str(path), mesh)
        assert port_roofline.markdown(rows) == ref_roofline.markdown(rows)
    doms = {r["dominant"] for r in port_roofline.table(str(path))
            if not r.get("skipped")}
    assert doms == {"compute", "memory", "collective"}


def test_run_without_results_names_the_dry_run(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match="python -m repro_torch.launch.dryrun"):
        port_roofline.run(results_path=str(tmp_path / "absent.json"))


def test_straggler_is_the_references():
    from benchmarks import framework as ref
    assert port_framework.run_straggler(True, device="cpu") == \
        ref.run_straggler(True)


def test_compression_bytes_are_the_references():
    from benchmarks import framework as ref
    assert port_framework.run_compression(True, device="cpu") == \
        ref.run_compression(True)
