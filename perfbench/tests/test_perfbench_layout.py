"""The harness finds every cell's parts by name, and BENCHMARK.json and
the configuration files keep to the names and keys the contract
allows."""

import json
import re

import pytest

from perfbench.core import cell as cellmod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cellmod.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(workload):
    cell = cellmod.Cell(workload)
    assert cell.config["name"] == cell.entry["config"]
    assert callable(cellmod.generator(cell.traffic["generator"]))
    assert callable(cellmod.loop(cell.traffic["loop"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        assert callable(cellmod.metric_reader(metric["name"]))


def test_names_units_and_keys():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry and group != "end_to_end" \
                        and group != "per_layer":
                    assert 1 <= len(entry[text]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
    for metric in BENCH["per_layer"]:
        assert metric["moves"] in e2e
        assert 1 <= len(metric["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_files(entry):
    cfg = cellmod.config(entry["name"])
    assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
    assert len(cfg["source"]) <= 200 and cfg["source"] == entry["source"]
    assert "assumed" in cfg and cfg["reduced"] == entry["reduced"] == []
    assert set(cfg["checks"]) <= {"gap_median", "miss_share"}
    assert 0 < cfg["miss_gap"] < 1
