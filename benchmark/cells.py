"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``workloads/<cell>.json`` and ``configs/<config>.json``
beside this file."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


class UnknownCell(KeyError):
    pass


def load_spec(path: Path = SPEC) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, spec: Optional[dict] = None,
              overrides: Optional[dict] = None) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, its workload
    file under ``workload``, its configuration file under ``config``, and
    the end-to-end and per-layer metrics it reports under ``end_to_end``
    and ``per_layer``. ``overrides`` ({"config": {...}, "workload":
    {...}}) replaces keys of those files, a level deep: the CPU tests'
    small sizes."""
    spec = load_spec() if spec is None else spec
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise UnknownCell(name)
    cfg_entry = next(c for c in spec["configs"]
                     if c["name"] == entry["config"])
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    for part, new in (overrides or {}).items():
        old = {"config": config, "workload": workload}[part]
        for k, v in new.items():
            old[k] = ({**old[k], **v} if isinstance(v, dict)
                      and isinstance(old.get(k), dict) else v)

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    return {"entry": entry, "workload": workload, "config": config,
            "end_to_end": [m for m in spec["end_to_end"] if reports(m)],
            "per_layer": [m for m in spec["per_layer"] if reports(m)]}
