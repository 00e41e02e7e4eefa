"""--multi / --matrix run-matrix expansion.

Port of ``nmma_tpu/cli/multi.py`` (the reference's ``multi_analysis_loop``,
nmma/core/base.py:371-437): one config expands into a list of sub-runs.
``multi`` with one key maps a flag over a value list (labels
``label_0..``); with several keys each entry is a named run with its own
overrides. ``matrix`` takes the cartesian product of all value lists.
"""

from __future__ import annotations

import copy
from itertools import product


def expand_runs(args):
    """argparse.Namespace -> list of Namespaces (one per sub-run)."""
    multi = getattr(args, "multi", None)
    matrix = getattr(args, "matrix", None)
    if multi:
        sub_runs = []
        if len(multi) == 1:
            key, vals = next(iter(multi.items()))
            for i, val in enumerate(vals):
                run = copy.deepcopy(args)
                _set_known(run, key, val)
                run.label = f"{args.label}_{i}"
                sub_runs.append(run)
        else:
            for run_name, changes in multi.items():
                run = copy.deepcopy(args)
                run.label = f"{args.label}_{run_name}"
                for key, val in (changes or {}).items():
                    _set_known(run, key, val)
                sub_runs.append(run)
        return sub_runs
    if matrix:
        keys = list(matrix.keys())
        vals = list(matrix.values())
        sub_runs = []
        for combo in product(*vals):
            run = copy.deepcopy(args)
            name = args.label
            for i, val in enumerate(combo):
                rep = f"_{val}"
                if len(rep) > 20:
                    rep = f"_{keys[i]}_{vals[i].index(val)}"
                name += rep
            run.label = name
            for key, val in zip(keys, combo):
                _set_known(run, key, val)
            sub_runs.append(run)
        return sub_runs
    return [args]


def _set_known(namespace, key, value):
    attr = key.replace("-", "_")
    if not hasattr(namespace, attr):
        raise KeyError(f"{key} is not a known argument... please remove")
    setattr(namespace, attr, value)
