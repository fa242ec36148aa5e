"""BENCHMARK.json against the contract's forms, and every file it names
found by name."""

import dataclasses
import json
import re

import pytest

from _tiny import ROOT

from bench_port import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert len(BENCH["command"]) <= 32
    assert any(BENCH["command"][1].startswith(p + "/") for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("bench_port/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    every = [m["name"] for m in BENCH["configs"]], CELLS, [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in every:
        assert len(group) == len(set(group))


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.cell(name)
    assert spec.entry(cell["config"]).Entry
    ref = spec.reference(cell["config"])
    assert ref.REFERENCE and ref.CONTROL and ref.register and ref.compare
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(spec.metric(m["name"]).read)
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s", "frames_per_s"}
    assert cell["per_layer"]
    assert all(isinstance(v, (int, float)) for v in cell["limits"].values())


def test_configs_build_the_deployments():
    """The incremental deployment: the program's defaults with every
    occupied voxel kept (a slot per pixel) and no fitness pass."""
    from rspc_tpu_torch.config import PipelineConfig

    base = PipelineConfig()
    want = dataclasses.replace(
        base, icp=dataclasses.replace(base.icp, compute_fitness=False),
        voxel=dataclasses.replace(base.voxel, max_points=640 * 480))
    cfg = json.loads((ROOT / "bench_port/configs/incremental_icp_vga.json").read_text())
    assert spec.replaced(PipelineConfig(), cfg["pipeline"]) == want


def test_replaced_keeps_defaults_and_refuses_unknown_keys():
    from rspc_tpu_torch.config import PipelineConfig

    base = PipelineConfig()
    got = spec.replaced(base, {"voxel": {"leaf_size": 0.02}, "use_scan": False})
    assert got.voxel.leaf_size == 0.02 and got.voxel.max_points == base.voxel.max_points
    assert got.use_scan is False and got.icp == base.icp
    with pytest.raises(AttributeError):
        spec.replaced(base, {"no_such_field": 1})
    with pytest.raises(AttributeError):
        spec.replaced(base, {"voxel": {"no_such_field": 1}})
