"""Cells, configurations, traffic mixes and metrics are found by name:
a new one is a new file and a new entry, and no other file changes."""
import json
import os

from svbench import registry


def test_every_entry_has_its_file():
    bench = registry.load_benchmark()
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(registry.ROOT, c["file"]))
    for w in bench["workloads"]:
        cell = registry.cell(bench, w["name"])
        assert cell["config_data"]["name"] == w["config"]
        assert cell["traffic_data"]["name"] == w["traffic"]
        for name in cell["end_to_end"] + cell["per_layer"]:
            assert callable(registry.reader(name))


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    for sub in ("configs", "traffic", "metrics", "limits"):
        (tmp_path / sub).mkdir()
    (tmp_path / "limits" / "new.cell.json").write_text(
        json.dumps({"limits": {"truth_counts_off": 3}}))
    (tmp_path / "configs" / "new_cfg.json").write_text(
        json.dumps({"name": "new_cfg", "argv": []}))
    (tmp_path / "traffic" / "new_mix.json").write_text(
        json.dumps({"name": "new_mix", "sv": {}}))
    (tmp_path / "metrics" / "new.metric.py").write_text(
        "def read(run):\n    return run * 2\n")
    bench = registry.load_benchmark()
    bench["workloads"].append(dict(name="new.cell", config="new_cfg",
                                   traffic="new_mix", chips=1, why="x"))
    bench["per_layer"].append(dict(name="new.metric", unit="ms",
                                   better="lower", source="program_span",
                                   layer="decode", moves="reads_per_s",
                                   workloads=["new.cell"]))
    cell = registry.cell(bench, "new.cell", base=str(tmp_path))
    assert cell["config_data"]["name"] == "new_cfg"
    assert cell["traffic_data"]["name"] == "new_mix"
    assert cell["per_layer"] == ["new.metric"]
    assert "reads_per_s" in cell["end_to_end"]
    assert registry.reader("new.metric", base=str(tmp_path))(21) == 42
    assert registry.limits("new.cell", base=str(tmp_path)) == {
        "truth_counts_off": 3}
    assert registry.limits("other.cell", base=str(tmp_path)) == {}
    # the accepted cells do not report the new cell's metric
    assert "new.metric" not in registry.cell(bench,
                                             "hifi.germline")["per_layer"]
