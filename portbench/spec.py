"""The benchmark's data files, found by the names in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` is an entry of ``workloads``. Everything that
belongs to one name sits in a file of its own:

* ``configs/<config>.json``: the model configuration as it is run;
* ``traffic/<mix>.json``: the parameters the mix's loop reads;
* ``checks/<cell>.json``: the limits of the numbers the output check compares;
* ``metrics/<metric>.py``: a reader with ``read(summary) -> float | None``
  (a metric ``<name>.<part>`` without a file of its own reads with
  ``metrics/<name>.py``: the same quantity in other cells, moving another
  end-to-end metric);
* ``counts/<kernel>.py``: a kernel's operations and bytes, and ``counts/peaks.json``;
* ``families/<family>/reference.py`` and ``port.py``: a model family, which a
  configuration names under ``family`` (:func:`load_family`).

So a later change adds a cell, a configuration, a model family, a mix or a
metric by adding files and entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return read_json(path)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str, directory: Path = PKG / "configs") -> dict:
    return read_json(directory / f"{name}.json")


def load_traffic(name: str, directory: Path = PKG / "traffic") -> dict:
    return read_json(directory / f"{name}.json")


def load_limits(cell: str, directory: Path = PKG / "checks") -> dict:
    return read_json(directory / f"{cell}.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """``(end_to_end, per_layer)`` metrics the cell reports. An end-to-end
    metric without a ``workloads`` key is in every cell; a per-layer metric
    without one is in every cell that reports the metric it ``moves``."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def _load_module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_"
                                                  + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str,
                directory: Path = PKG / "metrics") -> Callable[[dict], Optional[float]]:
    path = directory / f"{metric}.py"
    if not path.exists():
        path = directory / f"{metric.split('.')[0]}.py"
    return _load_module(path).read


def load_count(kernel: str, directory: Path = PKG / "counts") -> ModuleType:
    return _load_module(directory / f"{kernel}.py")


def peaks(directory: Path = PKG / "counts") -> Dict[str, float]:
    return read_json(directory / "peaks.json")


@dataclass(frozen=True)
class Family:
    """A model family: what a configuration's models are, to the reference
    and to the port.

    ``reference`` (``families/<name>/reference.py``, plain PyTorch, nothing of
    the port) gives ``DECISIONS``, ``kinds(config)``, ``shapes(arch, kind)``,
    ``level_logits(arch, models, x, calibrate=False)``,
    ``first_class_shift(models, decision, amount)``, ``trunks(config)`` and
    ``per_block(config, px)``. ``port`` (``families/<name>/port.py``) gives
    ``CLASSES`` (the port's model of each kind) and ``build(config, models,
    device, calib) -> predict`` for one level."""
    name: str
    reference: ModuleType
    port: ModuleType


def load_family(name: str, directory: Path = PKG / "families") -> Family:
    """The family ``directory / name``; refused where a file is missing or
    its decisions are not the ones the cascade routes."""
    from portbench.reference.cascade import DECISIONS
    folder = directory / name
    missing = [f for f in ("reference.py", "port.py") if not (folder / f).is_file()]
    if missing:
        raise FileNotFoundError(f"model family {name!r} has no {' or '.join(missing)} "
                                f"in {folder}")
    reference = _load_module(folder / "reference.py")
    decisions = tuple(getattr(reference, "DECISIONS", ()))
    if decisions != DECISIONS:
        raise ValueError(f"model family {name!r} decides {decisions}; the cascade routes "
                         f"{DECISIONS} to its 8 classes")
    return Family(name, reference, _load_module(folder / "port.py"))


__all__ = ["BENCHMARK", "Family", "NAME", "PKG", "ROOT", "UNIT", "cell_metrics",
           "load_benchmark", "load_config", "load_count", "load_family", "load_limits",
           "load_reader", "load_traffic", "peaks", "read_json", "workload"]
