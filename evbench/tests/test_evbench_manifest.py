"""BENCHMARK.json against its required form, and every file a cell needs
found by its name."""

import json
import os
import re

import pytest

from evbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = harness.manifest()


def test_manifest_has_exactly_the_required_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_units_and_text_fields_use_the_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"],
                  BENCH["per_layer"]):
        for e in group:
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200
                    assert "\n" not in e[k] and "\t" not in e[k]
    everything = [e["name"] for g in ("configs", "workloads", "end_to_end",
                                      "per_layer") for e in BENCH[g]]
    for g in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[g]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(ms) == len(set(ms)) and everything


def test_metrics_meet_the_required_form():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if w in m.get("workloads", [w])]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert [m for m in BENCH["per_layer"] if w in m["workloads"]]


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cells_files_are_found_by_name(wl):
    cfg = harness.config_of(BENCH, wl)
    assert cfg["name"] == wl["config"]
    entry = [c for c in BENCH["configs"] if c["name"] == wl["config"]][0]
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    mix = harness._json("traffic", f"{wl['traffic']}.json")
    assert os.path.exists(os.path.join(harness.HERE, "kinds",
                                       f"{mix['kind']}.py"))
    limits = harness._json("cells", f"{wl['name']}.json")["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    for m in harness.metrics_for(BENCH, wl["name"], trace=True):
        assert callable(harness.reader(m["name"]))


def test_configuration_files_state_the_published_model():
    kag = json.load(open(os.path.join(harness.HERE, "configs",
                                      "kaggle-dlrm.json")))
    from evbench.inputs import model_dims
    d = model_dims(kag)
    assert d["mlp_top"] == [387, 512, 256, 1]
    assert sum(d["table_sizes"]) == 33762577
    ter = json.load(open(os.path.join(harness.HERE, "configs",
                                      "terabyte-dlrm.json")))
    d = model_dims(ter)
    assert d["mlp_top"] == [415, 512, 512, 256, 1]
    assert max(d["table_sizes"]) == 10_000_000
    assert sum(d["table_sizes"]) == 54184588


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_a_cell_file_holds_its_limits_and_their_readings_alone(wl):
    cell = harness._json("cells", f"{wl['name']}.json")
    assert set(cell) == {"limits", "readings"}
    assert cell["readings"]
