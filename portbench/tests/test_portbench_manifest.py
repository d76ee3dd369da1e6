"""BENCHMARK.json and the files it names."""

import importlib.util
import json
import os

import pytest
import yaml

from portbench import manifest

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_names_units_sources_and_files_keep_the_rules():
    assert manifest.problems(MAN) == []


def test_manifest_keys_are_the_contract_s():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_and_reports_what_its_metrics_need(cell):
    c = manifest.cell(MAN, cell)
    assert c["traffic"]["mode"] in ("train", "eval")
    assert c["limits"] and all(v > 0 for v in c["limits"].values())
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in names
    for m in c["end_to_end"] + c["per_layer"]:
        spec = importlib.util.spec_from_file_location("m", manifest.metric_reader(m["name"]))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_configs_are_the_shipped_specs_but_for_the_keys_reduced(config):
    """Cut nothing; the one setting changed, the solver, is listed as
    assumed."""
    entry = [c for c in MAN["configs"] if c["name"] == config][0]
    with open(os.path.join(manifest.ROOT, entry["file"])) as f:
        run_as = json.load(f)
    shipped_name = entry["source"].split("/specs/")[1].split()[0]
    with open(os.path.join(manifest.ROOT, "specs", shipped_name)) as f:
        shipped = yaml.safe_load(f)
    assert run_as["reduced"] == entry["reduced"] == []
    for key in ["solver"]:
        del run_as["spec"]["params"][key]
        shipped["params"].pop(key, None)
    assert run_as["spec"] == shipped
