"""Model -> graphviz DAG (cf. ``pymc3_tpu/model_graph.py``).

The dependency walk runs over the port's node DAG (``OpNode`` arguments,
``DeterministicRV`` expressions, ``TransformedRV`` views and each
distribution's ``param_nodes()``), as the JAX package's does over its own.
Plates group the variables by shape (``model_to_graphviz``). Plates,
their variables and the edges are visited in sorted order, so that the
graph's source is the same in every process. graphviz is imported when a
graph is made.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Set

import numpy as np

from .model import (DeterministicRV, FreeRV, Model, ObservedRV,
                    TransformedRV, modelcontext)
from .node import Node, OpNode
from .util import (get_default_varnames, get_untransformed_name,
                   is_transformed_name)

__all__ = ["ModelGraph", "model_to_graphviz"]


class ModelGraph:
    """cf. ``model_graph.py:29``."""

    def __init__(self, model: Model):
        self.model = model
        self.var_names = get_default_varnames(model.named_vars,
                                              include_transformed=False)
        self.var_list = [model.named_vars[n] for n in self.var_names]

    def get_deps(self, var) -> Set[str]:
        """Named ancestors of ``var`` in the node DAG (parents)."""
        seen = set()
        deps: Set[str] = set()
        start_nodes = []
        if isinstance(var, DeterministicRV):
            start_nodes.append(var.expr)
        dist = getattr(var, "distribution", None)
        if dist is not None:
            start_nodes.extend(dist.param_nodes().values())
        stack = deque(start_nodes)
        while stack:
            node = stack.popleft()
            if not isinstance(node, Node) or id(node) in seen:
                continue
            seen.add(id(node))
            name = getattr(node, "name", None)
            if name is not None and name in self.model.named_vars \
                    and node is not var:
                # a transformed variable stands for its user-facing name
                if is_transformed_name(name) and \
                        get_untransformed_name(name) in self.model.named_vars:
                    deps.add(get_untransformed_name(name))
                else:
                    deps.add(name)
                continue
            if isinstance(node, OpNode):
                stack.extend(a for a in node.args if isinstance(a, Node))
            elif isinstance(node, DeterministicRV):
                stack.append(node.expr)
            elif isinstance(node, TransformedRV):
                stack.append(node.transformed)
        return deps

    def make_compute_graph(self) -> Dict[str, Set[str]]:
        """{var_name: set of parents} (cf. ``model_graph.py:115``), with
        the links from imputed values to their observed variable."""
        input_map = {name: self.get_deps(self.model.named_vars[name])
                     for name in self.var_names}
        for obs in self.model.observed_RVs:
            if getattr(obs, "missing_values", None) is not None:
                input_map.setdefault(obs.name, set()).add(
                    obs.missing_values.name)
        return input_map

    def _make_node(self, var_name, graph):
        """Attaches the given variable to a graphviz Digraph
        (cf. ``model_graph.py:136``)."""
        v = self.model.named_vars[var_name]
        attrs = {}
        if isinstance(v, ObservedRV) or (hasattr(v, "distribution") and
                                         getattr(v, "data", None) is not None
                                         and not isinstance(v, FreeRV)):
            attrs["style"] = "filled"
        if isinstance(v, DeterministicRV):
            attrs["shape"] = "box"
            attrs["style"] = "rounded"
            label = f"{var_name}\n~\nDeterministic"
        else:
            dist = getattr(v, "distribution", None)
            dist_name = type(dist).__name__ if dist is not None else "Data"
            label = f"{var_name}\n~\n{dist_name}"
            attrs["shape"] = "ellipse"
        graph.node(var_name.replace(":", "&"), label, **attrs)

    def get_plates(self) -> Dict[tuple, Set[str]]:
        """Group variables by shape for plate notation
        (cf. ``model_graph.py:175``): a free variable's is its
        distribution's shape, another's its value's."""
        plates: Dict[tuple, Set[str]] = {}
        for var_name in self.var_names:
            v = self.model.named_vars[var_name]
            if isinstance(v, (FreeRV, TransformedRV)):
                shape = v.distribution.shape
            else:
                try:
                    shape = np.shape(v.test_value)
                except Exception:
                    shape = ()
            plates.setdefault(tuple(int(s) for s in shape),
                              set()).add(var_name)
        return plates

    def make_graph(self):
        """cf. ``model_graph.py:196``."""
        try:
            import graphviz
        except ImportError:
            raise ImportError(
                "This function requires the python library graphviz, along "
                "with binaries. The easiest way to install all of this is by "
                "running\n\n\tconda install -c conda-forge python-graphviz")
        graph = graphviz.Digraph(self.model.name or "model")
        for shape, var_names in sorted(self.get_plates().items()):
            if shape:
                # must be preceded by 'cluster' to get a box around it
                with graph.subgraph(name="cluster" + str(shape)) as sub:
                    for var_name in sorted(var_names):
                        self._make_node(var_name, sub)
                    sub.attr(label=" x ".join(map(str, shape)),
                             labeljust="r", labelloc="b", style="rounded")
            else:
                for var_name in sorted(var_names):
                    self._make_node(var_name, graph)
        for key, values in sorted(self.make_compute_graph().items()):
            for value in sorted(values):
                graph.edge(value.replace(":", "&"), key.replace(":", "&"))
        return graph


def model_to_graphviz(model=None):
    """Produce a graphviz Digraph from a model (cf. ``model_graph.py:219``)."""
    return ModelGraph(modelcontext(model)).make_graph()
