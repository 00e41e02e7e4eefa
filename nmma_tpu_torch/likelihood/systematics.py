"""Systematic-error model: per-filter sigma_sys from the error budget.

Port of the yaml-free part of ``nmma_tpu/likelihood/systematics.py``
(``FilterSystematicsHandler``, nmma/em/systematics.py:14-296): each observed
filter gets either the fixed error budget or, when the prior samples
``em_syserr``, that parameter. The yaml-configured (time-dependent, grouped)
systematics wait for a later slice.
"""

from __future__ import annotations

import torch


class SystematicsModel:
    """Static per-filter plan + batched runtime evaluation."""

    def __init__(self, filters, systematics=None, error_budget=None,
                 base_name="em_syserr"):
        if systematics:
            raise NotImplementedError(
                "yaml systematics files are not in nmma_tpu_torch yet")
        self.filters = list(filters)
        self.base_name = base_name
        self.error_budget = 1.0 if error_budget is None else error_budget
        self.plans = {f: ("budget",) for f in self.filters}

    def finalize(self, prior_names):
        """Switch budget plans to the sampled em_syserr if the prior has it
        (the reference's from_budget -> from_param promotion,
        nmma/em/systematics.py:186-192)."""
        if self.base_name in prior_names:
            self.plans = {f: ("param", self.base_name) for f in self.filters}

    def prior_parameter_names(self):
        return sorted({plan[1] for plan in self.plans.values()
                       if plan[0] == "param"})

    def _budget(self, f_idx, filt):
        budget = self.error_budget
        if isinstance(budget, dict):
            return float(budget.get(filt, 1.0))
        if isinstance(budget, (list, tuple)):
            return float(budget[f_idx])
        return float(budget)

    def __call__(self, parameters, obs_times):
        """sigma_sys ``[B, F, N]`` aligned with ``obs_times`` [F, N]."""
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
            else:
                rows.append(parameters[plan[1]][:, None].expand(
                    batch, t_row.shape[0]))
        return torch.stack(rows, dim=1)
