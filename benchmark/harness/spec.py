"""Cells, configurations, traffic mixes and metric readers, read as data.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics; ``workloads/<cell>.json`` names a cell's configuration, traffic
mix, mode and sizes; ``configs/<config>.json`` holds a configuration as it
is run; ``traffic/<mix>.json`` the parameters of a mix; ``metrics/<metric>.py``
the reader of one metric.  A new file of any kind and its entry in
``BENCHMARK.json`` are all a new cell, mix or metric needs."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

BENCH = pathlib.Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _file(root: pathlib.Path, folder: str, name: str, suffix: str):
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    path = root / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} file {path}")
    return path


@dataclasses.dataclass
class Cell:
    """One cell: its own file's entries, its configuration file, its traffic
    mix resolved to its parts, and the metrics ``BENCHMARK.json`` gives
    it, each with its reader module."""
    name: str
    spec: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    readers: dict

    @property
    def mode(self) -> str:
        return self.spec["mode"]

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def load_reader(root: pathlib.Path, name: str):
    """The reader module of metric ``name``, loaded from its file (a name
    may hold dots, so it is loaded by path, not imported by name)."""
    path = _file(root, "metrics", name, ".py")
    mod_name = "benchmark_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr in ("read", "UNIT"):
        if not hasattr(mod, attr):
            raise AttributeError(f"metric reader {path} defines no {attr}")
    return mod


def resolve_traffic(root: pathlib.Path, name: str, depth: int = 0) -> dict:
    """A mix's parameters; a mix of mixes has ``parts``, each a mix name
    and its share of the samples."""
    if depth > 4:
        raise ValueError(f"traffic {name!r}: mixes nested too deep")
    mix = read_json(_file(root, "traffic", name, ".json"))
    if "parts" in mix:
        mix["parts"] = [{**part, "mix": resolve_traffic(
            root, part["traffic"], depth + 1)} for part in mix["parts"]]
    return {"name": name, **mix}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict, root: pathlib.Path = BENCH) -> Cell:
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json lists no workload {name!r}")
    spec = read_json(_file(root, "workloads", name, ".json"))
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"workload {name}: {key} {spec[key]!r} in its "
                             f"file, {entry[key]!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    config = read_json(_file(root, "configs", entry["config"], ".json"))
    config["name"] = cfg_entry["name"]
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name)]
    readers = {m["name"]: load_reader(root, m["name"])
               for m in e2e + per_layer}
    return Cell(name=name, spec={**spec, "chips": entry["chips"]},
                config=config, traffic=resolve_traffic(root, entry["traffic"]),
                end_to_end=e2e, per_layer=per_layer, readers=readers)
