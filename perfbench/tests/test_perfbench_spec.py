"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file; each configuration against its own published shapes
and its tier's contract; a cell, configuration, traffic, entry and metric
added as new files alone are found and pass the same checks."""

import json
import re
import shutil

import pytest

from conftest import ROOT
from perfbench.core.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
# The rel-RMS contract of each precision tier of the program (README.md);
# "default" is a measurement mode with none, and no configuration's.
CONTRACTS = {"highest": 1e-5, "high": 1e-4}
# The source's own values that a configuration states as "published": the
# shape keys, and the number of EQ filters.
SHAPE_KEYS = ("sample_rate", "block_size", "hrir_channels", "hrir_taps",
              "speakers", "ears", "eq_filters")
# The first two configurations, held to their values by name.
ACCEPTED = ("bake_hesuvi_stereo", "ring_hesuvi_stereo")


def shape(config: dict) -> dict:
    """A configuration's working values of the shape keys."""
    return dict({k: config[k] for k in SHAPE_KEYS[:-1]},
                eq_filters=len(config["eq"]["filters"]))


def check_configuration(spec: Spec, name: str) -> None:
    """What every configuration must have: its source, a tier with a
    contract, a guarantees line, the lists of what was reduced and
    assumed, each of its cells' limit within the tier's contract; and, but
    for the two accepted ones, its published shapes, which its working
    values keep but for the keys it lists as reduced."""
    c = spec.config(name)
    assert c["source"] == spec.configs[name]["source"], name
    assert c["tier"] in CONTRACTS, f"{name}: tier {c['tier']!r}"
    assert isinstance(c["guarantees"], str) and c["guarantees"].strip(), name
    assert isinstance(c["reduced"], list) and isinstance(c["assumed"], list)
    cells = [w for w in spec.cells.values() if w["config"] == name]
    assert cells, f"{name}: no cell"
    for w in cells:
        limit = spec.traffic(w["traffic"])["check"]["limit_rel_rms"]
        assert 0 < limit <= CONTRACTS[c["tier"]], (w["name"], limit)
    if name in ACCEPTED:
        return
    published = c["published"]
    assert set(published) == set(SHAPE_KEYS), name
    working = shape(c)
    for key in SHAPE_KEYS:
        if key not in c["reduced"]:
            assert working[key] == published[key], (name, key)


@pytest.fixture(scope="module")
def spec():
    return Spec()


def test_top_level_keys_and_limits(spec):
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(d["paths"]) <= 16
    for p in d["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    assert 1 <= len(d["command"]) <= 32
    assert d["command"][1] == "perfbench/run.py"
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    assert len(json.dumps(d)) <= 64 * 1024
    # A full check of 24 cells fits the time it is allowed.
    runs = 2 + 14 * 24
    assert runs * (d["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_the_contract_keys(spec):
    d = spec.data
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in spec.configs
    assert len({(w["config"], w["traffic"]) for w in d["workloads"]}) == len(
        d["workloads"])
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in d[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in spec.cells
    for x in d["configs"] + d["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def test_every_cell_reports_what_the_contract_asks(spec):
    for cell in spec.cells:
        e2e = [m["name"] for m in spec.cell_metrics(cell, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.cell_metrics(cell, "per_layer")
        for m in spec.cell_metrics(cell, "per_layer"):
            # The end-to-end metric it moves is reported in the same cell.
            assert m["moves"] in e2e


def test_every_name_resolves_to_its_file(spec):
    for name, c in spec.configs.items():
        config = spec.config(name)
        assert config["name"] == name
        assert config["reduced"] == c["reduced"]
        assert callable(spec.reference(config["reference"]).responses)
    for cell in spec.cells.values():
        traffic = spec.traffic(cell["traffic"])
        assert hasattr(spec.entry(traffic["entry"]), "Entry")
    for name in spec.metrics:
        assert callable(spec.metric_reader(name).read)


@pytest.mark.parametrize("name", ACCEPTED)
def test_configurations_keep_the_published_shapes(spec, name):
    c = spec.config(name)
    assert (c["sample_rate"], c["block_size"], c["hrir_channels"],
            c["hrir_taps"], c["speakers"], c["ears"]) == (
        48000, 512, 14, 4320, 2, 2)
    assert c["tier"] == "highest" and c["reduced"] == []
    assert len(c["eq"]["filters"]) == 10


def test_every_configuration_keeps_its_source_and_contract(spec):
    for name in spec.configs:
        check_configuration(spec, name)


def test_a_dummy_cell_added_as_files_is_found(tmp_path):
    """A later change adds files and entries only: copy the benchmark, add
    a configuration (8 speakers at the "high" tier, with its published
    shapes), a traffic mix, an entry, a metric and a cell, find each by its
    name, and hold every configuration of the copy to the checks above."""
    bench = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "ring_hesuvi_stereo.json")
                        .read_text())
    config.update(name="dummy_config", source="x", layout="7.1", speakers=8,
                  tier="high", guarantees="bf16x3; within 1e-4 rel-RMS",
                  assumed=config["assumed"] + ["the tier"])
    config["published"] = shape(config)
    (bench / "configs" / "dummy_config.json").write_text(json.dumps(config))
    (bench / "traffic" / "dummy.mix.json").write_text(json.dumps(
        {"entry": "dummy_entry", "lanes": 4,
         "check": {"limit_rel_rms": 2.5e-5}}))
    (bench / "entries" / "dummy_entry.py").write_text(
        "class Entry:\n    name = 'dummy'\n")
    (bench / "metrics" / "dummy.metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    data["configs"].append({"name": "dummy_config", "source": "x",
                            "file": "perfbench/configs/dummy_config.json",
                            "reduced": [], "why": "a dummy"})
    data["workloads"].append({"name": "dummy.cell", "config": "dummy_config",
                              "traffic": "dummy.mix", "chips": 1,
                              "why": "a dummy"})
    data["per_layer"].append({"name": "dummy.metric", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "x_realtime",
                              "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    s = Spec(tmp_path, bench)
    cell = s.cell("dummy.cell")
    assert s.config(cell["config"])["name"] == "dummy_config"
    traffic = s.traffic(cell["traffic"])
    assert s.entry(traffic["entry"]).Entry.name == "dummy"
    assert "dummy.metric" in [m["name"] for m in
                              s.cell_metrics("dummy.cell", "per_layer")]
    assert s.metric_reader("dummy.metric").read(None) == 42.0
    assert "dummy.metric" not in [m["name"] for m in
                                  s.cell_metrics("ring.eq.b8192", "per_layer")]
    for name in s.configs:
        check_configuration(s, name)


@pytest.mark.parametrize("change, reduced", [
    ({"speakers": 2}, []),                  # a shape moved, not listed
    ({"tier": "default"}, ["speakers"]),    # a tier with no contract
    ({"published": {"speakers": 8}}, []),   # published shapes left out
])
def test_the_configuration_checks_refuse(tmp_path, change, reduced):
    """The dummy configuration, broken one way at a time, fails the checks;
    a shape it lists as reduced may differ from its published one."""
    bench = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "ring_hesuvi_stereo.json")
                        .read_text())
    config.update(name="dummy_config", source="x", speakers=8, tier="high",
                  reduced=reduced)
    config["published"] = shape(config)
    config.update(change)
    (bench / "configs" / "dummy_config.json").write_text(json.dumps(config))
    data["configs"].append({"name": "dummy_config", "source": "x",
                            "file": "perfbench/configs/dummy_config.json",
                            "reduced": reduced, "why": "a dummy"})
    data["workloads"].append({"name": "dummy.cell", "config": "dummy_config",
                              "traffic": "rounds.eq.b8192", "chips": 1,
                              "why": "a dummy"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    s = Spec(tmp_path, bench)
    with pytest.raises(AssertionError):
        check_configuration(s, "dummy_config")
    if reduced:
        # Listed as reduced, the moved shape alone passes.
        config.update(tier="high", speakers=2)
        (bench / "configs" / "dummy_config.json").write_text(
            json.dumps(config))
        check_configuration(s, "dummy_config")
