"""CUDA graphs of the adaptive ODE solve (``ode.py``).

One DOPRI5 iteration of the solve is about a hundred small launches, and
its replay with autograd about two hundred more: issued one by one from the
host they cost about 100 ms a logp+grad of the freefall model on the H100,
whatever the chain count, while the device is busy for a few. Captured
once as CUDA graphs and replayed, the host issues one graph a chunk of
``_CHECK_EVERY`` iterations forward (still reading after each chunk whether
every lane is done) and one graph for the whole backward.

The graphs run the very kernels the eager path runs, on static copies of
the inputs, so they give the same numbers. A batch size is captured at its
second solve (a shape seen once, such as the test value or a predictive
batch, runs eagerly); a backward at its second occurrence of the same
batch size and iteration count. Each kind keeps its ``KEEP`` graphs used
last (each holds its own memory pool). A capture that fails (a ``func``
that copies host data at every call, for one) raises: set ``ENABLED`` to
False to run such an equation eagerly.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

# graphs are used on CUDA tensors while this is true
ENABLED = True

# graphs kept of each kind (forward, backward) of one equation
KEEP = 16


def _capture(fn):
    """Warm ``fn`` up on a side stream, then capture it; returns the graph
    and what the captured call returned (static tensors)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


class ForwardGraph:
    """``chunk`` iterations of the masked loop over a static state of ``B``
    lanes, writing each iteration's time, accepted step and written row
    into history buffers at a device-side iteration count."""

    def __init__(self, ode, y0, theta, chunk):
        self.ode, self.chunk = ode, chunk
        self.y0, self.theta = y0.clone(), theta.clone()
        self.fb = ode._batched_func()
        self.tab = ode._tableau(self.y0)
        self.state = [s.clone() for s in ode._init_state(self.y0)]
        rows = ode.max_steps + chunk
        B = y0.shape[0]
        self.t_hist = y0.new_zeros((rows, B))
        self.h_hist = y0.new_zeros((rows, B))
        self.w_hist = torch.zeros((rows, B), dtype=torch.long,
                                  device=y0.device)
        self.it = torch.zeros((1,), dtype=torch.long, device=y0.device)
        self.graph, _ = _capture(self._run_chunk)

    def _iterate(self, k):
        """One iteration at history row ``it + k``, on the static state."""
        idx = self.it + k
        st = tuple(self.state)
        self.t_hist.index_copy_(0, idx, st[0][None])
        st, h, write = self.ode._step(self.fb, self.tab, self.theta, st)
        self.h_hist.index_copy_(0, idx, h[None])
        self.w_hist.index_copy_(0, idx, write[None])
        for s, new in zip(self.state, st):
            s.copy_(new)

    def _run_chunk(self):
        for k in range(self.chunk):
            self._iterate(k)
        self.it.add_(self.chunk)

    def __call__(self, y0, theta):
        """The solve: ``(ys, t_hist, h_hist, w_hist, iterations)``."""
        ode = self.ode
        self.y0.copy_(y0)
        self.theta.copy_(theta)
        for s, init in zip(self.state, ode._init_state(self.y0)):
            s.copy_(init)
        self.it.zero_()
        it = 0
        while it < ode.max_steps:
            if it + self.chunk <= ode.max_steps:
                self.graph.replay()
                it += self.chunk
            else:
                # the last iterations below max_steps, eagerly
                self._iterate(0)
                self.it.add_(1)
                it += 1
            if it % self.chunk == 0 and not bool(
                    (self.state[3] < ode.n_times).any()):
                break
        ys = ode._poison(self.state[4], self.state[3], self.tab)
        return (ys, self.t_hist[:it].clone(), self.h_hist[:it].clone(),
                self.w_hist[:it].clone(), it)


class BackwardGraph:
    """The backward of a solve of ``B`` lanes and ``N`` iterations: the
    replay with autograd and its gradient, captured as one graph."""

    def __init__(self, ode, y0, theta, t_hist, h_hist, w_hist, g):
        self.ode = ode
        self.y0 = y0.detach().clone().requires_grad_()
        self.theta = theta.detach().clone().requires_grad_()
        self.hist = [t_hist.clone(), h_hist.clone(), w_hist.clone()]
        self.g = g.clone()
        self.graph, self.grads = _capture(self._run)

    def _run(self):
        with torch.enable_grad():
            ys = self.ode._replay(self.y0, self.theta, *self.hist)
            return torch.autograd.grad(ys, (self.y0, self.theta), self.g)

    def __call__(self, y0, theta, t_hist, h_hist, w_hist, g):
        with torch.no_grad():
            for s, x in zip((self.y0, self.theta, *self.hist, self.g),
                            (y0, theta, t_hist, h_hist, w_hist, g)):
                s.copy_(x)
        self.graph.replay()
        return tuple(x.clone() for x in self.grads)


class Graphs:
    """The graphs of one ``DifferentialEquation``, by batch size (and
    iteration count for the backward), the ``KEEP`` used last of each kind,
    with the count of solves seen."""

    def __init__(self, ode):
        self.ode = ode
        self.forward, self.backward = OrderedDict(), OrderedDict()
        self.seen = {}

    def _get(self, cache, key, make):
        """The graph of ``key``, captured by ``make`` at the second time
        the key is seen; None the first time."""
        graph = cache.get(key)
        if graph is not None:
            cache.move_to_end(key)
            return graph
        self.seen[key] = self.seen.get(key, 0) + 1
        if self.seen[key] < 2:
            return None
        try:
            graph = cache[key] = make()
        except RuntimeError as err:
            raise RuntimeError(
                f"capturing the ODE solve as a CUDA graph failed ({err}); "
                "set pymc3_tpu_torch.ode.graphs.ENABLED = False to solve "
                "this equation eagerly") from err
        if len(cache) > KEEP:
            cache.popitem(last=False)
        return graph

    def solve(self, y0, theta, chunk):
        """The forward through a graph, or None where it runs eagerly."""
        if not (ENABLED and y0.is_cuda):
            return None
        key = ("forward", tuple(y0.shape), y0.dtype, y0.device)
        graph = self._get(self.forward, key, lambda: ForwardGraph(
            self.ode, y0, theta, chunk))
        return None if graph is None else graph(y0, theta)

    def grad(self, y0, theta, t_hist, h_hist, w_hist, g):
        """``(d y0, d theta)`` through a graph, or None."""
        if not (ENABLED and y0.is_cuda):
            return None
        key = ("backward", tuple(y0.shape), len(t_hist), y0.dtype,
               y0.device)
        graph = self._get(self.backward, key, lambda: BackwardGraph(
            self.ode, y0, theta, t_hist, h_hist, w_hist, g))
        return None if graph is None else graph(
            y0, theta, t_hist, h_hist, w_hist, g)
