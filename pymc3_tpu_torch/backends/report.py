"""Sampler report & convergence checks (cf. ``pymc3/backends/report.py``).

``SamplerWarning``/``WarningType`` (``report.py:26-42``) and ``SamplerReport``
(``report.py:54``) with tiered R-hat / ESS convergence checks
(``report.py:101-168``). The reference delegates rhat/ess to ArviZ; this
build computes them natively on the host (``pymc3_tpu_torch/stats``).

Internally the report is a flat journal of ``(chain, warning)`` events;
the per-chain / global split the reference keeps as two containers is
derived on demand, and the tiered convergence thresholds live in
declarative tables rather than an if/elif ladder.
"""
from __future__ import annotations

import enum
import logging
from collections import namedtuple
from typing import Optional

import numpy as np

logger = logging.getLogger("pymc3_tpu_torch")

__all__ = ["SamplerWarning", "WarningType", "SamplerReport", "merge_reports"]


@enum.unique
class WarningType(enum.Enum):
    # For HMC and NUTS
    DIVERGENCE = 1
    TUNING_DIVERGENCE = 2
    DIVERGENCES = 3
    TREEDEPTH = 4
    # Problematic sampler parameters
    BAD_PARAMS = 5
    # Indications that chains did not converge, e.g. Rhat
    CONVERGENCE = 6
    BAD_ACCEPTANCE = 7
    BAD_ENERGY = 8


SamplerWarning = namedtuple(
    "SamplerWarning",
    "kind, message, level, step, exec_info, extra")
SamplerWarning.__new__.__defaults__ = (None, None, None)


def _severity(level: str) -> int:
    """Numeric severity of a warning-level string ('debug'..'critical')."""
    return logging.getLevelName(
        {"warn": "WARNING"}.get(level, level).upper())


# Tiered convergence tables (threshold descending → first hit wins),
# mirroring the reference's ladder at ``report.py:126-166``.
_RHAT_TIERS = (
    (1.4, "error", "The rhat statistic is larger than 1.4 for some "
                   "parameters. The sampler did not converge."),
    (1.2, "warn", "The rhat statistic is larger than 1.2 for some "
                  "parameters."),
    (1.05, "info", "The rhat statistic is larger than 1.05 for some "
                   "parameters. This indicates slight problems during "
                   "sampling."),
)

_ESS_FRAC_TIERS = (
    (0.1, "warn", "The number of effective samples is smaller than "
                  "10% for some parameters."),
    (0.25, "info", "The number of effective samples is smaller than "
                   "25% for some parameters."),
)

_GLOBAL = None  # chain id for run-level (non-chain) warnings


class SamplerReport:
    """Bundle warnings, convergence stats and metadata of a sampling run
    (cf. ``report.py:54``)."""

    def __init__(self):
        self._events = []  # journal of (chain-or-None, SamplerWarning)
        self._ess = None
        self._rhat = None
        self._n_tune = None
        self._n_draws = None
        self._t_sampling = None

    # -- derived views over the journal ---------------------------------
    @property
    def _chain_warnings(self):
        by_chain = {}
        for chain, warn in self._events:
            if chain is not _GLOBAL:
                by_chain.setdefault(chain, []).append(warn)
        return by_chain

    @property
    def _global_warnings(self):
        return [w for c, w in self._events if c is _GLOBAL]

    @property
    def _warnings(self):
        # chain events first, then global — the reference's concat order
        ordered = sorted(self._events,
                         key=lambda cw: cw[0] is _GLOBAL)
        return [w for _, w in ordered]

    @property
    def ok(self):
        """Whether the automatic convergence checks found serious problems."""
        worst = max((_severity(w.level) for _, w in self._events),
                    default=logging.NOTSET)
        return worst < logging.WARNING

    @property
    def n_tune(self) -> Optional[int]:
        """Number of tune iterations - not necessarily kept in trace!"""
        return self._n_tune

    @property
    def n_draws(self) -> Optional[int]:
        return self._n_draws

    @property
    def t_sampling(self) -> Optional[float]:
        """Number of seconds that the sampling procedure took."""
        return self._t_sampling

    def raise_ok(self, level="error"):
        bar = _severity(level)
        errors = [w for _, w in self._events if _severity(w.level) >= bar]
        if errors:
            raise ValueError(f"Serious convergence issues during sampling. "
                             f"{errors}")

    def _run_convergence_checks(self, trace, model):
        """cf. ``report.py:101-168`` — R-hat thresholds 1.05/1.2/1.4 and
        ESS thresholds vs chain count."""
        if trace.nchains == 1:
            self._add_warnings([SamplerWarning(
                WarningType.BAD_PARAMS,
                "Only one chain was sampled, this makes it impossible to "
                "run some convergence checks", "info", None, None, None)])
            return

        from ..stats import ess as _ess, rhat as _rhat
        varnames = []
        for rv in model.free_RVs:
            for candidate in dict.fromkeys(
                    (rv.name, getattr(rv, "orig_name", rv.name))):
                if candidate in trace.varnames:
                    varnames.append(candidate)

        self._ess = {v: _ess(trace, var_names=[v])[v] for v in varnames}
        self._rhat = {v: _rhat(trace, var_names=[v])[v] for v in varnames}

        found = []
        rhat_max = max((np.max(x) for x in self._rhat.values()), default=0)
        for threshold, level, msg in _RHAT_TIERS:
            if rhat_max > threshold:
                found.append(SamplerWarning(
                    WarningType.CONVERGENCE, msg, level,
                    None, None, self._rhat))
                break

        eff_min = min((np.min(x) for x in self._ess.values()),
                      default=np.inf)
        n_samples = len(trace) * trace.nchains
        if eff_min < 200 and n_samples >= 500:
            found.append(SamplerWarning(
                WarningType.CONVERGENCE,
                "The estimated number of effective samples is smaller than "
                "200 for some parameters.", "error", None, None, self._ess))
        else:
            for frac, level, msg in _ESS_FRAC_TIERS:
                if eff_min / n_samples < frac:
                    found.append(SamplerWarning(
                        WarningType.CONVERGENCE, msg, level,
                        None, None, self._ess))
                    break

        self._add_warnings(found)

    def _add_warnings(self, warnings, chain=_GLOBAL):
        self._events.extend((chain, w) for w in warnings)

    def _log_summary(self):
        for _, warn in self._events:
            logger.log(_severity(warn.level), warn.message)

    def _slice(self, start, stop, step):
        """Report for a ``trace[start:stop:step]`` view: keep step-less
        warnings, rebase in-window step indices."""
        def rebased(warn):
            if warn.step is None:
                return warn
            in_window = start <= warn.step < stop \
                and (warn.step - start) % step == 0
            return warn._replace(step=warn.step - start) if in_window \
                else None

        report = SamplerReport()
        report._events = [
            (chain, w) for chain, w in
            ((c, rebased(w)) for c, w in self._events) if w is not None]
        return report


def merge_reports(reports):
    """cf. ``report.py:211``."""
    merged = SamplerReport()
    for rep in reports:
        merged._events.extend(rep._events)
    return merged
