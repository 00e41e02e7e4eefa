"""Systematic-error model: per-filter, optionally time-dependent sigma_sys.

Port of ``nmma_tpu/likelihood/systematics.py`` (``FilterSystematicsHandler``,
nmma/em/systematics.py:14-296): the yaml or prior configuration is resolved
once, on the host, into a static per-filter plan, and the runtime
evaluation maps a parameter batch ``{name: [B]}`` to ``sigma_sys [B, F, N]``.

Plans per observed filter:
  ("budget",)                     — the fixed error budget
  ("param", name)                 — one sampled parameter, constant in time
  ("interp", names, time_nodes)   — sampled node values, piecewise-linear in
                                    time with constant extrapolation
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.interp import interp_rows


def _load_yaml(path_or_dict):
    if isinstance(path_or_dict, dict) or path_or_dict is None:
        return path_or_dict or {}
    import yaml
    with open(path_or_dict) as f:
        return yaml.safe_load(f) or {}


_ALLOWED_KEYS = ("time_range", "time_nodes", "prior", "params", "each",
                 "filters")


def _time_nodes(info, default_range, default_grid="linear"):
    """Node positions of a 'time_range'/'time_nodes' spec, or None
    (``get_time_range``, nmma/em/systematics.py:123-149)."""
    num = info.get("time_nodes")
    t_range = str(info.get("time_range", "")).split()
    if num is None and t_range:
        num = t_range.pop(-1)
    if num is None:
        return None
    grid_type = default_grid
    if len(t_range) == 3:
        grid_type, t_start, t_end = t_range
    elif len(t_range) == 2:
        t_start, t_end = t_range
        try:
            float(t_start)
        except ValueError:
            grid_type, t_end = t_range
            t_start = default_range[0]
    else:
        t_start, t_end = default_range
    if "lin" in grid_type:
        return np.linspace(float(t_start), float(t_end), int(num))
    return np.geomspace(float(t_start), float(t_end), int(num))


class SystematicsModel:
    """Static per-filter plan + batched runtime evaluation."""

    def __init__(self, filters, systematics=None, error_budget=None,
                 base_name="em_syserr", model_time_range=(0.1, 14.0)):
        self.filters = list(filters)
        self.base_name = base_name
        self.model_time_range = model_time_range
        self.spec = _load_yaml(systematics)
        self.error_budget = 1.0 if error_budget is None else error_budget
        self.plans: dict[str, tuple] = {}
        self._legacy_groups = []
        self._resolve()

    # -- static resolution ---------------------------------------------------
    def _prior_name(self, key):
        return f"{self.base_name}_{key}" if key else self.base_name

    def _resolve(self):
        if not self.spec:
            # no yaml: a sampled em_syserr (found by finalize) or the budget
            for f in self.filters:
                self.plans[f] = ("budget",)
            return
        if "config" in self.spec:
            self._resolve_legacy(self.spec["config"])
            return

        missing = set(self.filters)
        if next(iter(self.spec)) in _ALLOWED_KEYS:
            # one systematic for every filter
            nodes = _time_nodes(self.spec, self.model_time_range)
            for f in self.filters:
                self._assign(f, "", nodes)
            return
        for key, info in self.spec.items():
            nodes = _time_nodes(info, self.model_time_range)
            if key in self.filters:
                self._assign(key, key, nodes)
                missing.discard(key)
            elif "filters" in info:
                for f in info["filters"]:
                    if f in self.filters:
                        self._assign(f, key, nodes)
                        missing.discard(f)
            elif "each" in info:
                for f in info["each"]:
                    if f in self.filters:
                        self._assign(f, f, nodes)
                        missing.discard(f)
            else:
                # shared by every filter still without a definition
                for f in missing:
                    self._assign(f, key, nodes)
                missing = set()
        if missing:
            raise ValueError(
                f"filters missing systematics definitions: {sorted(missing)}")

    def _resolve_legacy(self, config):
        """Legacy ``config.withTime``/``withoutTime`` format
        (nmma/em/systematics.py:298-510): withTime gives each filter group
        node priors em_syserr_{group}_{n} on a linear grid over the model
        time range, a null group covering the remaining filters as 'all';
        withoutTime gives one shared em_syserr."""
        with_time = config.get("withTime", {})
        without_time = config.get("withoutTime", {})
        if with_time.get("value"):
            n_nodes = int(with_time["time_nodes"])
            nodes = np.linspace(self.model_time_range[0],
                                self.model_time_range[1], n_nodes)
            groups = with_time.get("filters") or [None]
            named_groups, assigned = [], set()
            for group in groups:
                if group is None:
                    continue
                group_list = group if isinstance(group, list) else [group]
                named_groups.append(("___".join(group_list), group_list))
                assigned.update(group_list)
            if any(g is None for g in groups):
                named_groups.append(
                    ("all", [f for f in self.filters if f not in assigned]))
            for gname, group_list in named_groups:
                names = tuple(f"em_syserr_{gname}_{n}"
                              for n in range(n_nodes))
                self._legacy_groups.append((names, with_time))
                for f in group_list:
                    if f in self.filters:
                        self.plans[f] = ("interp", names, nodes)
            for f in self.filters:
                self.plans.setdefault(f, ("budget",))
        elif without_time.get("value"):
            self._legacy_groups.append((("em_syserr",), without_time))
            for f in self.filters:
                self.plans[f] = ("param", "em_syserr")

    def _assign(self, filt, key, nodes):
        name = self._prior_name(key)
        if nodes is None:
            self.plans[filt] = ("param", name)
        else:
            self.plans[filt] = ("interp", tuple(
                f"{name}_{i}" for i in range(len(nodes))), nodes)

    def finalize(self, prior_names):
        """Switch budget plans to the sampled em_syserr if the prior has it
        (the reference's from_budget -> from_param promotion,
        nmma/em/systematics.py:186-192), and check that every parameter a
        plan reads is in the prior."""
        for f, plan in self.plans.items():
            if plan[0] == "budget" and self.base_name in prior_names:
                self.plans[f] = ("param", self.base_name)
        for plan in self.plans.values():
            names = (plan[1],) if plan[0] == "param" else \
                plan[1] if plan[0] == "interp" else ()
            for name in names:
                if name not in prior_names:
                    raise ValueError(f"systematics prior missing: {name}")

    def create_priors(self):
        """The sampled priors the yaml asks for
        (``setup_systematics_priors``, nmma/em/systematics.py:57-101):
        per-filter, filter-group and 'each' expansion with one prior per
        time node. Prior expressions in the yaml are evaluated like .prior
        file lines."""
        from ..priors import core as prior_core
        from ..priors.parser import _eval_rhs

        priors = {}
        if not self.spec:
            return priors
        if "config" in self.spec:
            for names, values in self._legacy_groups:
                cls = getattr(prior_core, values.get("type", "Uniform"))
                kwargs = {k: v for k, v in values.items()
                          if k not in ("type", "value", "time_nodes",
                                       "filters")}
                kwargs.setdefault("minimum", kwargs.pop("min", 0.0))
                kwargs.setdefault("maximum", kwargs.pop("max", 2.0))
                for name in names:
                    priors[name] = cls(name=name, **kwargs)
            return priors

        specs = {"": self.spec} if next(iter(self.spec)) in _ALLOWED_KEYS \
            else self.spec
        for key, info in specs.items():
            if not isinstance(info, dict) or info.get("prior") is None:
                continue
            nodes = _time_nodes(info, self.model_time_range)
            for target in info.get("each", [key]):
                base = self._prior_name(target)
                names = [base] if nodes is None else \
                    [f"{base}_{i}" for i in range(len(nodes))]
                for name in names:
                    prior = _eval_rhs(info["prior"])
                    prior.name = name
                    priors[name] = prior
        return priors

    def prior_parameter_names(self):
        names = set()
        for plan in self.plans.values():
            if plan[0] == "param":
                names.add(plan[1])
            elif plan[0] == "interp":
                names.update(plan[1])
        return sorted(names)

    # -- batched runtime evaluation ------------------------------------------
    def _budget(self, f_idx, filt):
        budget = self.error_budget
        if isinstance(budget, dict):
            return float(budget.get(filt, 1.0))
        if isinstance(budget, (list, tuple)):
            return float(budget[f_idx])
        return float(budget)

    def __call__(self, parameters, obs_times):
        """sigma_sys ``[B, F, N]`` aligned with ``obs_times`` [F, N]: node
        values interpolated as ``jnp.interp`` does, and inf everywhere when
        a plan has fewer than two nodes (the JAX package's masked_interp
        fill)."""
        batch = next(iter(parameters.values())).shape[0]
        rows = []
        for f_idx, filt in enumerate(self.filters):
            plan = self.plans[filt]
            t_row = obs_times[f_idx]
            if plan[0] == "budget":
                rows.append(torch.full((batch,) + t_row.shape,
                                       self._budget(f_idx, filt),
                                       dtype=obs_times.dtype,
                                       device=obs_times.device))
            elif plan[0] == "param":
                rows.append(parameters[plan[1]][:, None].expand(
                    batch, t_row.shape[0]))
            elif len(plan[2]) < 2:
                rows.append(torch.full((batch,) + t_row.shape, math.inf,
                                       dtype=obs_times.dtype,
                                       device=obs_times.device))
            else:
                _, names, nodes = plan
                vals = torch.stack([parameters[n] for n in names], dim=1)
                rows.append(interp_rows(t_row, torch.as_tensor(
                    nodes, dtype=vals.dtype, device=vals.device), vals))
        return torch.stack(rows, dim=1)
