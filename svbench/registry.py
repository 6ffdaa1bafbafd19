"""Finds a cell's configuration, traffic mix and metric readers by the
names that ``BENCHMARK.json`` gives them, one file each:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and the output check's limits,
``limits/<workload>.json``. A later cell, configuration or metric is a new
file and a new entry; no file here names them."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(kind: str, name: str, base: str) -> dict:
    path = os.path.join(base, kind, name + ".json")
    with open(path) as fh:
        return json.load(fh)


def cell(bench: dict, workload: str, base: str = HERE) -> dict:
    """The workload's entry with its configuration and traffic loaded and
    the names of the metrics it reports, end to end and per layer."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError("no workload %r in BENCHMARK.json" % workload)

    def reported(metrics):
        return [m["name"] for m in metrics
                if workload in m.get("workloads", [workload])]

    return dict(entry, config_data=_json("configs", entry["config"], base),
                traffic_data=_json("traffic", entry["traffic"], base),
                end_to_end=reported(bench["end_to_end"]),
                per_layer=reported(bench["per_layer"]),
                units={m["name"]: m["unit"] for m in
                       bench["end_to_end"] + bench["per_layer"]})


def limits(workload: str, base: str = HERE) -> dict:
    """The output check's limits of a cell, ``limits/<workload>.json``,
    where a number's limit is not 0."""
    path = os.path.join(base, "limits", workload + ".json")
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)["limits"]


def reader(metric: str, base: str = HERE):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(base, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "svbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
