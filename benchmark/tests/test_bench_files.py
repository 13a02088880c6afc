"""Every file of the benchmark loads, and BENCHMARK.json keeps the
contract's shape: names, units, metrics and the cells that report them."""

import importlib
import json
import os
import re

import pytest

from benchmark import harness
from benchmark.kernels import pricing_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPEC = harness.load_spec(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    read = harness.reader(metric["name"])
    assert callable(read)
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_a_metric_of_each_of_its_cells(metric):
    moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    cells = metric.get("workloads", [c["name"] for c in SPEC["workloads"]])
    for cell in cells:
        assert harness.applies(moved, cell)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    cell, config, traffic = harness.cell_files(ROOT, SPEC, cell["name"])
    assert cell["chips"] == 1
    importlib.import_module(f"benchmark.statements.{config['statement']}")
    importlib.import_module(f"benchmark.reference.{config['reference']}")
    assert config["reduced"] == [] and traffic["pool"] >= 2
    reports = [m for m in SPEC["end_to_end"] if harness.applies(m, cell["name"])]
    assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
    assert any(harness.applies(m, cell["name"]) for m in SPEC["per_layer"])


@pytest.mark.parametrize("which", ["benchmark", "fixtures"])
def test_traffic_files_hold_only_what_the_harness_reads(which, tiny_spec):
    spec = SPEC if which == "benchmark" else tiny_spec
    for cell in spec["workloads"]:
        _, _, traffic = harness.cell_files(ROOT, spec, cell["name"])
        assert set(traffic) == {"statement_params", "pool", "why"}


def test_every_config_is_used_once_by_file():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    used = {c["config"] for c in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_a_fixture_cell_loads_the_same_way(tiny_spec):
    for cell in tiny_spec["workloads"]:
        _, config, traffic = harness.cell_files(ROOT, tiny_spec, cell["name"])
        assert config["name"] == cell["config"] and traffic["pool"] == 2


@pytest.mark.parametrize("module", pricing_modules(), ids=lambda m: m.__name__)
def test_kernel_pricing_file(module):
    assert module.COUNTER.startswith("starkpack_winterfell_tpu_torch.ops.")
    assert module.NAME and callable(module.claims) and callable(module.least_time_s)
