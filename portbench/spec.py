"""The benchmark's data, found by name.

``BENCHMARK.json`` names the cells; a cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``); a
configuration names the program under test (``programs/<name>.py``, ``em``
by default), its plain reference (``reference/<name>.py``) and its counted
work (``counts/<name>.py``), both by default under its own name; a
per-layer metric is read by ``metrics/<name>.py``. Each is looked up in the
benchmark's own folder and then in any further folders the caller gives,
so a later cell, configuration, mix or metric is a new file and an entry,
and no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Spec:
    """One cell of a benchmark file, with everything it names."""

    def __init__(self, workload, benchmark=None, dirs=()):
        self.dirs = [HERE, *dirs]
        if benchmark is None:
            with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
                benchmark = json.load(f)
        self.benchmark = benchmark
        cells = {c["name"]: c for c in benchmark["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
        self.cell = cells[workload]
        self.name = workload
        self.chips = int(self.cell["chips"])
        self.config = self.data("configs", self.cell["config"])
        self.traffic = self.data("traffic", self.cell["traffic"])
        self.end_to_end = [m for m in benchmark["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in benchmark["per_layer"]
                          if workload in m.get("workloads", [workload])]

    @staticmethod
    def base(name):
        """The quantity a metric's name measures: ``sampler_share.cli`` is
        ``sampler_share`` in the cells of another end-to-end metric, read
        by the same ``metrics/sampler_share.py``."""
        return name.split(".")[0]

    def path(self, kind, name, suffix):
        for d in self.dirs:
            p = os.path.join(d, kind, name + suffix)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} in {self.dirs}")

    def data(self, kind, name):
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def module(self, kind, name):
        """``<kind>/<name>.py``: the benchmark's own as a module of this
        package (so it may import its siblings), another folder's by
        path."""
        path = self.path(kind, name, ".py")
        if os.path.dirname(os.path.dirname(path)) == HERE:
            return importlib.import_module(f"portbench.{kind}.{name}")
        spec = importlib.util.spec_from_file_location(
            f"portbench_extra_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reference(self):
        return self.module("reference",
                           self.config.get("reference", self.config["name"]))

    def program(self):
        """``programs/<name>.py``: what builds the program under test."""
        return self.module("programs", self.config.get("program", "em"))

    def counts(self):
        return self.module("counts",
                           self.config.get("counts", self.config["name"]))
