"""The harness finds a cell, a configuration, a traffic mix, a driver, a
FLOP count and a metric by name alone: adding one is adding files."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import registry
from benchmark.harness.program import reference_config


def test_new_files_are_found_by_name(tmp_path):
    for kind in ("configs", "workloads", "traffic", "drivers", "flops",
                 "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "model_x.json").write_text(
        json.dumps({"config": {"hidden_units": 7}}))
    (tmp_path / "workloads" / "model_x.bulk.json").write_text(
        json.dumps({"config": "model_x", "traffic": "bulk",
                    "driver": "drive_x", "limits": {}}))
    (tmp_path / "traffic" / "bulk.json").write_text(json.dumps({"batch": 3}))
    (tmp_path / "drivers" / "drive_x.py").write_text(
        "def count(layers, c, b):\n    return 2 * layers.body(c, b)\n\n\n"
        "class Driver:\n    kind = 'serve'\n")
    (tmp_path / "flops" / "model_x.py").write_text(
        "def body(c, b):\n    return b * c['hidden_units']\n")
    (tmp_path / "metrics" / "hits.serve.py").write_text(
        "def read(r):\n    return 42.0\n")
    cell = registry.load_json("workloads", "model_x.bulk", tmp_path)
    conf = registry.load_json("configs", cell["config"], tmp_path)
    traffic = registry.load_json("traffic", cell["traffic"], tmp_path)
    drive = registry.load_module("drivers", cell["driver"], tmp_path)
    assert drive.Driver.kind == "serve"
    assert drive.count(registry.load_module("flops", cell["config"],
                                            tmp_path),
                       conf["config"], traffic["batch"]) == 42
    assert registry.load_module("metrics", "hits.serve",
                                tmp_path).read(None) == 42.0


def test_a_cell_reports_what_lists_it():
    man = {"end_to_end": [
        {"name": "rate", "workloads": ["a"]}, {"name": "setup_s"}],
        "per_layer": [{"name": "x", "moves": "rate", "workloads": ["a"]},
                      {"name": "z", "moves": "setup_s", "workloads": ["b"]}]}
    assert [m["name"] for m in registry.cell_metrics(
        man, "a", "end_to_end")] == ["rate", "setup_s"]
    assert [m["name"] for m in registry.cell_metrics(
        man, "a", "per_layer")] == ["x"]
    assert [m["name"] for m in registry.cell_metrics(
        man, "b", "per_layer")] == ["z"]


def test_a_new_driver_counts_on_an_existing_configuration(tmp_path):
    """A driver file alone: it is found by name and counts its unit from
    the layers that the configuration's existing FLOP file gives."""
    (tmp_path / "drivers").mkdir()
    (tmp_path / "drivers" / "bulk_classify.py").write_text(
        "def count(layers, c, b):\n"
        "    return layers.classifier(c, b)\n")
    c = reference_config(registry.load_json("configs", "torch_multi"))
    got = registry.load_module("drivers", "bulk_classify", tmp_path).count(
        registry.load_module("flops", "torch_multi"), c, 4)
    t = 313
    want = (2 * 2 * 4 * t * (129 + 300) * 1200
            + 2 * 2 * 4 * t * (600 + 300) * 1200 + 2 * 4 * 600 * 103)
    assert got.model == want
    assert len(got.recurrence) == 2


@pytest.mark.parametrize("name", ["../x", "a b", "", "a/b"])
def test_names_that_are_no_names_are_refused(name):
    with pytest.raises(ValueError):
        registry.load_json("configs", name)


def test_every_manifest_entry_has_its_files(manifest):
    for cfg in manifest["configs"]:
        assert registry.load_json("configs", cfg["name"])["name"] == \
            cfg["name"]
    for w in manifest["workloads"]:
        cell = registry.load_json("workloads", w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        traffic = registry.load_json("traffic", w["traffic"])
        c = reference_config(registry.load_json("configs", w["config"]))
        assert registry.load_module("drivers", cell["driver"]).count(
            registry.load_module("flops", w["config"]), c,
            traffic["batch"]).model > 0
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(registry.load_module("metrics", m["name"]).read)
    assert all(m["workloads"] for m in manifest["per_layer"])
