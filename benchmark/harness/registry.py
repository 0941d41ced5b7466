"""Finds everything by name: the cell in ``BENCHMARK.json``, its
configuration's file, its traffic mix (``traffic/<name>.json``), the
traffic's kind (``kinds/<kind>.py``) and each metric's reader
(``e2e/<name>.py``, ``metrics/<name>.py``). A later change adds files and
entries; nothing here names a cell."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class UnknownName(LookupError):
    """A cell, configuration, traffic mix, kind or metric that has no
    entry or no file."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, parsed
    traffic: dict         # the traffic mix's file, parsed
    end_to_end: list      # this cell's end-to-end metric entries
    per_layer: list       # this cell's per-layer metric entries


def load_spec(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise UnknownName(f"no BENCHMARK.json at {root}")
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its
    ``workloads``, or, without that key, every cell reports an end-to-end
    metric and a per-layer metric goes where its moved metric goes."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def find_cell(name: str, spec: dict, root: str = ROOT) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise UnknownName(f"no workload {name!r} in BENCHMARK.json "
                          f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise UnknownName(f"no config {w['config']!r}")
    with open(os.path.join(root, configs[w["config"]]["file"])) as fh:
        config = json.load(fh)
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     w["traffic"] + ".json"), "traffic mix")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def load_json(path: str, what: str) -> dict:
    if not os.path.exists(path):
        raise UnknownName(f"no {what} file {os.path.relpath(path, ROOT)}")
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.exists(path):
        raise UnknownName(f"no {kind} file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
