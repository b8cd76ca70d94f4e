"""Cells, the run's record, and the files the harness finds by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the
harness reads ``perfbench/configs/<config>.json`` (the sizes as run),
``perfbench/traffic/<traffic>.json`` (the mix's parameters, and the
``driver`` that runs that kind of traffic: ``perfbench/drivers/
<driver>.py``), ``perfbench/limits/<workload>.json`` (the limit of each
number the correctness check compares) and, for each per-layer metric,
``perfbench/metrics/<metric>.py`` (a reader with ``read(run)``); a
configuration's model names its plain reference,
``perfbench/reference/families/<reference>.py``.  A new cell, mix,
metric or model family is new files and new entries; no file changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Iterator, List, Optional, Tuple

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
#: top-level modules no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]            # the configuration's file
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]  # the metrics this cell reports
    per_layer: List[Dict[str, Any]]

    @property
    def model(self) -> Dict[str, Any]:
        return self.config["model"]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None,
              root: Path = ROOT) -> Cell:
    bench = bench or load_benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return file_cell(name, root / cfg["file"], w["traffic"], int(w["chips"]),
                     e2e, per_layer, root)


def file_cell(name: str, config_file: Path, traffic: str, chips: int = 1,
              end_to_end: Optional[List[Dict[str, Any]]] = None,
              per_layer: Optional[List[Dict[str, Any]]] = None,
              root: Path = ROOT) -> Cell:
    """A cell from its files alone: the configuration, the traffic mix
    and, where there is one, ``limits/<name>.json``."""
    here = root / "perfbench"
    limits = here / "limits" / f"{name}.json"
    return Cell(name=name, chips=chips,
                config=json.loads(Path(config_file).read_text()),
                traffic=json.loads((here / "traffic" /
                                    f"{traffic}.json").read_text()),
                limits=json.loads(limits.read_text())
                if limits.exists() else {},
                end_to_end=end_to_end or [], per_layer=per_layer or [])


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = root / "perfbench" / kind / f"{name}.py"
    mod_name = f"perfbench.{kind}." + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may hold, compared
    whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Run:
    """One run's inputs and what it recorded."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    #: harness spans around its calls into the program: (start, end,
    #: name) in ns since the epoch, the profiler's clock
    spans: List[Tuple[int, int, str]] = field(default_factory=list)
    #: the program's calls in the window: their shapes and FLOPs
    calls: List[Dict[str, Any]] = field(default_factory=list)
    counters: Dict[str, Any] = field(default_factory=dict)
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    timeline: Any = None

    @contextmanager
    def span(self, name: str) -> Iterator[None]:
        """A harness span around a call into the program."""
        t0 = time.time_ns()
        yield
        self.spans.append((t0, time.time_ns(), name))
