"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units and limits; and a run never loads JAX or the JAX package."""
import json
import os
import re

from svbench import harness, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 \
        and "\n" not in s and "\t" not in s


def test_keys_names_units():
    bench = registry.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert all(_line(w) for w in bench["command"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(bench["paths"][0] + "/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024


def test_metric_and_file_names_stay_in_the_alphabet():
    for sub in ("configs", "traffic", "metrics", "limits"):
        if not os.path.isdir(os.path.join(registry.HERE, sub)):
            continue
        for f in os.listdir(os.path.join(registry.HERE, sub)):
            stem = f.rsplit(".", 1)[0]
            assert NAME.match(stem), f


def test_forbidden_modules_compare_whole_top_level_names():
    ok = ["cutesv_tpu_torch", "cutesv_tpu_torch.ops.cover", "numpy",
          "jaxtyping", "flaxen", "cutesv_tpu_x"]
    assert harness.forbidden_modules(ok) == []
    for bad in ("cutesv_tpu", "cutesv_tpu.ops", "jax", "jax.numpy",
                "jaxlib.xla_client", "flax.linen"):
        assert harness.forbidden_modules(ok + [bad]) == [bad.split(".")[0]]
