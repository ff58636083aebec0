"""Everything of a cell, found by the names in ``BENCHMARK.json``:

- the configuration ``configs/<config>.json`` (its sizes) and, beside it,
  ``configs/<config>.py``, its plain reference;
- the traffic mix ``traffic/<traffic>.json``: the entry that drives the
  program, and the parameters the generator and the entry read;
- the cell ``workloads/<cell>.json``: why it exists, who sends such
  traffic, and the limits of the numbers its check compares;
- the entry ``entries/<entry>.py`` and each metric's reader
  ``metrics/<metric>.py``.

So a new cell, configuration, mix or metric is new files and new entries
in ``BENCHMARK.json``; no file that is there changes."""

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class SpecError(ValueError):
    """A cell, configuration, mix or metric that cannot be found or read."""


def _json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing file {path}") from None


def benchmark(root=ROOT):
    return _json(Path(root) / "BENCHMARK.json")


def _named(name):
    if not NAME.match(name):
        raise SpecError(f"not a name: {name!r}")
    return name


def load_module(path, name):
    """Import the Python file ``path`` as a module called ``name``."""
    path = Path(path)
    if not path.is_file():
        raise SpecError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(
        re.sub(r"[^A-Za-z0-9_]", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with its files.  ``overrides`` replace
    configuration and traffic keys (the CPU tests shrink the sizes)."""

    def __init__(self, name, root=ROOT, overrides=None):
        self.bench = benchmark(root)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SpecError(f"no cell {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = _named(name)
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in self.bench["configs"]}
        cfg = configs[_named(self.entry["config"])]
        self.config_file = Path(root) / cfg["file"]
        self.config = _json(self.config_file)
        self.traffic = _json(BENCH / "traffic" /
                             f"{_named(self.entry['traffic'])}.json")
        self.workload = _json(BENCH / "workloads" / f"{self.name}.json")
        for key, val in (overrides or {}).items():
            (self.config if key in self.config else self.traffic)[key] = val
        if self.workload.get("config") != self.entry["config"] or \
                self.workload.get("traffic") != self.entry["traffic"]:
            raise SpecError(f"workloads/{self.name}.json names another "
                            f"configuration or mix than BENCHMARK.json")

    def reference(self):
        """The configuration's plain reference, beside its file."""
        return load_module(self.config_file.with_suffix(".py"),
                           f"portbench_ref_{self.entry['config']}")

    def entry_module(self):
        return load_module(BENCH / "entries" /
                           f"{_named(self.traffic['entry'])}.py",
                           f"portbench_entry_{self.traffic['entry']}")

    def metrics(self, trace):
        """The metrics this cell reports: with trace, the per-layer ones
        that list it (or, listing none, move an end-to-end metric it
        reports); else its end-to-end ones.  [(entry, reader module)]."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if trace:
            mine = {m["name"] for m in e2e}
            chosen = [m for m in self.bench["per_layer"]
                      if (self.name in m["workloads"] if "workloads" in m
                          else m["moves"] in mine)]
        else:
            chosen = e2e
        return [(m, load_module(BENCH / "metrics" / f"{_named(m['name'])}.py",
                                "portbench_metric_" + m["name"]))
                for m in chosen]

    def limits(self):
        """{number: limit} of the cell's check."""
        return dict(self.workload["limits"])
