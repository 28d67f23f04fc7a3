"""BENCHMARK.json against the contract's shapes, and every name in it
found as a file."""
import json
import re
from pathlib import Path

import pytest

from tiny import bench  # noqa: F401  (puts the checkout on the path)
from portbench import spec as spec_mod, traffic

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert MAN["command"][1].startswith("portbench/")
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_keys(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source",
                           "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}[section]
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) <= keys, e
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] \
                    and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in MAN["workloads"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for c in m["workloads"]:          # the cell reports what it moves
            assert c in e2e[m["moves"]].get("workloads", [c])
        layers.setdefault(m["layer"], m["layer"])
    for c in cells:
        reported = [m for m in MAN["end_to_end"]
                    if c in m.get("workloads", [c])]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(c in m["workloads"] for m in MAN["per_layer"])


def test_every_file_is_found_by_name():
    for c in MAN["configs"]:
        assert (REPO / c["file"]).exists()
        conf = spec_mod.load_config(c["name"])
        assert conf["source"] == c["source"]
        spec_mod.spec_from_dict(conf)
    for w in MAN["workloads"]:
        assert w["chips"] == 1
        assert (PB / "configs" / f"{w['config']}.json").exists()
        mix = traffic.load_mix(w["traffic"])
        assert (PB / "drivers" / f"{mix['driver']}.py").exists()
        assert "max_logit_gap" in bench.load_limits(w["name"])
    for m in MAN["per_layer"]:
        assert callable(bench.load_reader(m["name"]))


def test_reference_named_by_each_config_exists():
    for c in MAN["configs"]:
        ref = spec_mod.load_config(c["name"])["reference"]
        assert (PB / "reference" / f"{ref}.py").exists()
