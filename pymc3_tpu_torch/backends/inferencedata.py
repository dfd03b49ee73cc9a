"""InferenceData export (cf. ``pymc3_tpu/backends/inferencedata.py``):
``sample(return_inferencedata=True)`` returns the trace as named groups.

Without ArviZ the container is the JAX package's light one: named groups
(``posterior``, ``sample_stats``, ``observed_data`` and, when asked for,
``log_likelihood``), each a :class:`Dataset` of ``(chain, draw, *event)``
numpy arrays with dims and coords. Where ArviZ imports, the same data goes
to ``arviz.from_dict`` instead.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["Dataset", "InferenceData", "to_inference_data"]


class Dataset:
    """Minimal xarray.Dataset stand-in: named arrays sharing leading
    (chain, draw) dims."""

    def __init__(self, data_vars: Dict[str, np.ndarray], dims=None,
                 coords=None):
        self.data_vars = dict(data_vars)
        self.dims = dims or {}
        self.coords = coords or {}

    def __getitem__(self, name):
        return self.data_vars[name]

    def __getattr__(self, name):
        try:
            return self.__dict__["data_vars"][name]
        except KeyError:
            raise AttributeError(name)

    def __contains__(self, name):
        return name in self.data_vars

    def __iter__(self):
        return iter(self.data_vars)

    def keys(self):
        return self.data_vars.keys()

    def items(self):
        return self.data_vars.items()

    def mean(self, axis=(0, 1)):
        return {k: np.asarray(v).mean(axis=axis)
                for k, v in self.data_vars.items()}

    def __repr__(self):
        lines = [f"<Dataset ({len(self.data_vars)} variables)>"]
        for k, v in self.data_vars.items():
            lines.append(f"  {k}: {np.asarray(v).shape}")
        return "\n".join(lines)


class InferenceData:
    """Container of named Dataset groups (cf. ``arviz.InferenceData``)."""

    def __init__(self, **groups):
        self._groups = {}
        for name, ds in groups.items():
            if ds is not None:
                self._groups[name] = ds
                setattr(self, name, ds)

    def groups(self):
        return list(self._groups)

    def __contains__(self, name):
        return name in self._groups

    def __repr__(self):
        return ("Inference data with groups:\n\t" +
                "\n\t".join(self._groups))


def _pointwise_log_likelihood(trace, model):
    """Per-observation log-likelihood of every observed variable, one
    ``(chain, draw, *data shape)`` array each, evaluated on the model's
    device by one ``torch.func.vmap`` over all draws (the layout of
    ArviZ's ``log_likelihood`` group)."""
    import torch
    from ..stats import _trace_q

    missing = [vm.var for vm in model.ordering.vmap
               if vm.var not in trace.varnames]
    if missing:
        raise ValueError(
            "log_likelihood requires every free variable in the trace; "
            f"missing {missing} (was sampling run with a subset "
            "trace=[...]?)")
    ordering = model.ordering
    observed = [obs for obs in model.observed_RVs
                if hasattr(obs, "value_node_eval")]
    if not observed:
        return {}

    def pointwise(q):
        env = model._env_from_q(q, ordering)
        memo = {}
        return tuple(obs.distribution.logp(obs.value_node_eval(env, memo),
                                           env, memo) for obs in observed)

    qs = torch.as_tensor(_trace_q(trace, model), device=model.device)
    with torch.no_grad():
        out = torch.func.vmap(pointwise)(qs)
    lead = (trace.nchains, len(trace))
    return {obs.name: v.cpu().numpy().reshape(lead + tuple(v.shape[1:]))
            for obs, v in zip(observed, out)}


def to_inference_data(trace, model=None, log_likelihood=False,
                      **idata_kwargs) -> "InferenceData":
    """Convert a MultiTrace to InferenceData (cf.
    ``inferencedata.py:128``).

    Uses ArviZ (``arviz.from_dict``) where it imports, otherwise the
    container above. Groups: posterior (untransformed user-facing
    variables), sample_stats, observed_data, and (when
    ``log_likelihood=True``) a pointwise log_likelihood group.

    ``idata_kwargs`` accepts ``coords`` and ``dims`` (merged over the
    model's own ``coords``/RV dims and forwarded to ArviZ when present,
    matching the reference's ``idata_kwargs`` plumbing); unknown keys
    raise so options are never silently dropped.
    """
    from ..model import modelcontext
    from ..util import get_default_varnames

    if model is None:
        # prefer the model the trace was sampled under; fall back to the
        # ambient context
        for strace in getattr(trace, "_straces", {}).values():
            if getattr(strace, "model", None) is not None:
                model = strace.model
                break
    model = modelcontext(model)

    user_coords = idata_kwargs.pop("coords", None) or {}
    user_dims = idata_kwargs.pop("dims", None) or {}
    if idata_kwargs:
        raise TypeError(
            f"Unsupported idata_kwargs: {sorted(idata_kwargs)} "
            "(supported: coords, dims)")
    dims = dict(getattr(model, "_RV_dims", {}) or {})
    dims.update({k: tuple(np.atleast_1d(v)) for k, v in user_dims.items()})
    model_coords = {k: np.asarray(v)
                    for k, v in (getattr(model, "coords", None) or {}).items()}
    model_coords.update({k: np.asarray(v) for k, v in user_coords.items()})
    chains = trace.chains
    posterior = {}
    var_order = get_default_varnames(trace.varnames,
                                     include_transformed=False)
    for name in var_order:
        per_chain = [np.asarray(trace.get_values(name, chains=[c]))
                     for c in chains]
        posterior[name] = np.stack(per_chain, axis=0)

    sample_stats = {}
    for stat in sorted(trace.stat_names or ()):
        per_chain = [np.asarray(trace.get_sampler_stats(stat, chains=[c]))
                     for c in chains]
        sample_stats[stat] = np.stack(per_chain, axis=0)
    # ArviZ naming conventions for the canonical stats
    renames = {"depth": "tree_depth", "mean_tree_accept": "acceptance_rate"}
    for old, new in renames.items():
        if old in sample_stats and new not in sample_stats:
            sample_stats[new] = sample_stats[old]

    observed = {}
    for obs in model.observed_RVs:
        try:
            observed[obs.name] = np.asarray(obs.data)
        except Exception:
            pass

    loglik = _pointwise_log_likelihood(trace, model) if log_likelihood \
        else None

    try:
        import arviz
        return arviz.from_dict(posterior=posterior,
                               sample_stats=sample_stats or None,
                               log_likelihood=loglik,
                               observed_data=observed or None,
                               coords=model_coords or None,
                               dims=dims or None)
    except ImportError:
        pass

    n_draw = len(trace)
    coords = {"chain": np.asarray(chains), "draw": np.arange(n_draw)}
    coords.update(model_coords)
    return InferenceData(
        posterior=Dataset(posterior, dims=dims or None, coords=coords),
        sample_stats=Dataset(sample_stats, coords=coords)
        if sample_stats else None,
        log_likelihood=Dataset(loglik, dims=dims or None, coords=coords)
        if loglik else None,
        observed_data=Dataset(observed, dims=dims or None) if observed
        else None,
    )
