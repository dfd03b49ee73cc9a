"""Bayesian ODEs (cf. ``pymc3_tpu/ode/ode.py``).

The solver is PyTorch: a fixed-grid RK4 integrator, or adaptive DOPRI5
with an I-controller (the default), differentiated through its steps. The
JAX package runs the adaptive solve as one bounded ``lax.scan`` of
``max_steps`` masked iterations. Here every iteration is a few dozen
launches issued by the host, so the solve leaves its loop once every lane
has written its last output; later iterations would change nothing.

``torch.func.vmap`` (which batches a model's logp over chains) forbids
that data-dependent exit, so the adaptive solve is a
``torch.autograd.Function`` with a ``vmap`` rule, as ``ops/gp_cov.py``'s
covariance is: under ``vmap`` it receives the whole batch, ``(B,
n_states)`` and ``(B, n_theta)``, and reads on the host every
``_CHECK_EVERY`` iterations whether all lanes are done. On the card the
loop and the backward run as CUDA graphs (``graphs.py``). It evaluates the
user's one-point ``func`` for all lanes at once through ``torch.func.vmap``.

The forward records each iteration's time, accepted step (0 where a lane
rejected or was done) and written output row. The backward replays the
accepted steps with autograd from the inputs and differentiates the
replay: the gradient is that of the forward's own arithmetic with the step
sizes as data, as JAX's reverse pass through the scan gives, and a
backward taken with ``create_graph`` is itself differentiable. Lanes do
not couple: a lane that runs out of ``max_steps`` gets NaN rows (so its
logp is not finite) and leaves every other lane's values and gradients as
they were.

``solve_adaptive_reference`` is the plain version: the full-length masked
loop of ``max_steps`` iterations, differentiated by autograd alone.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import floatX, torch_floatX
from ..node import apply as node_apply, as_node, current_device
from .graphs import Graphs

__all__ = ["DifferentialEquation", "solve_adaptive_reference"]

# loop iterations run by the adaptive solver's forward (each one DOPRI5
# attempt for every lane of the batch), and its forward calls
ITERATIONS = 0
SOLVES = 0
# iterations between two host reads of "every lane is done"
_CHECK_EVERY = 4


def _rk4_step(func, y, t, dt, theta):
    k1 = func(y, t, theta)
    k2 = func(y + 0.5 * dt * k1, t + 0.5 * dt, theta)
    k3 = func(y + 0.5 * dt * k2, t + 0.5 * dt, theta)
    k4 = func(y + dt * k3, t + dt, theta)
    return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


# Dormand-Prince 4(5) tableau (the embedded pair behind RK45 / ode45)
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = np.zeros((7, 7))
_DP_A[1, 0] = 1 / 5
_DP_A[2, :2] = [3 / 40, 9 / 40]
_DP_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_DP_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_DP_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176,
                -5103 / 18656]
_DP_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_DP_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                   11 / 84, 0.0])
_DP_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                   -92097 / 339200, 187 / 2100, 1 / 40])


def _stages(fb, tab, y, t, h, theta):
    """The first six DOPRI5 stages of every lane (``y (B, S)``, ``t, h
    (B,)``) and the fifth-order solution, which is stage seven's input:
    the tableau's last row is the fifth-order weights. Each stage's sum is
    one product with its row of the tableau."""
    hb = h[:, None]
    ks = [fb(y, t, theta)]
    for i in range(1, 6):
        yi = y + hb * (torch.stack(ks, dim=-1) @ tab["a"][i])
        ks.append(fb(yi, t + _DP_C[i] * h, theta))
    return ks, y + hb * (torch.stack(ks, dim=-1) @ tab["b5"])


def _dopri5_step(fb, tab, y, t, h, theta):
    """One embedded DOPRI5 step of every lane: (y5, y5 - y4)."""
    ks, y5 = _stages(fb, tab, y, t, h, theta)
    ks.append(fb(y5, t + h, theta))
    return y5, y5 - (y + h[:, None] * (torch.stack(ks, dim=-1) @ tab["b4"]))


def _front(t, dim, batch_size):
    """Bring the vmapped dimension of ``t`` to the front (or expand a
    tensor that has none)."""
    if dim is None:
        return t.expand(batch_size, *t.shape)
    return t.movedim(dim, 0)


class _AdaptiveSolve(torch.autograd.Function):
    """``ys (B, n_times, n_states)`` from ``y0 (B, S)`` and ``theta (B,
    P)``, with the step history the backward replays: per iteration the
    lanes' times, accepted steps (0 where none) and written rows (-1)."""

    @staticmethod
    def forward(y0, theta, ode):
        return ode._adaptive_forward(y0, theta)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y0, theta, ode = inputs
        _, t_hist, h_hist, w_hist = output
        ctx.save_for_backward(y0, theta, t_hist, h_hist, w_hist)
        ctx.mark_non_differentiable(t_hist, h_hist, w_hist)
        ctx.ode = ode

    @staticmethod
    def backward(ctx, g, *_):
        y0, theta, t_hist, h_hist, w_hist = ctx.saved_tensors
        needs = ctx.needs_input_grad[:2]
        create = torch.is_grad_enabled()
        if not create:
            grads = ctx.ode._graphs.grad(y0, theta, t_hist, h_hist, w_hist,
                                         g)
            if grads is not None:
                return tuple(d if need else None
                             for d, need in zip(grads, needs)) + (None,)
        with torch.enable_grad():
            ins = [x if create else x.detach().requires_grad_(need)
                   for x, need in zip((y0, theta), needs)]
            ys = ctx.ode._replay(ins[0], ins[1], t_hist, h_hist, w_hist)
            wrt = [x for x, need in zip(ins, needs) if need]
            grads = iter(torch.autograd.grad(ys, wrt, g, create_graph=create,
                                             allow_unused=True))
        return tuple(next(grads) if need else None for need in needs) + (
            None,)

    @staticmethod
    def vmap(info, in_dims, y0, theta, ode):
        # fold every vmapped dimension into the solver's lane axis
        y0 = _front(y0, in_dims[0], info.batch_size)
        theta = _front(theta, in_dims[1], info.batch_size)
        lead = torch.broadcast_shapes(y0.shape[:-1], theta.shape[:-1])
        y0 = y0.expand(*lead, y0.shape[-1]).reshape(-1, y0.shape[-1])
        theta = theta.expand(*lead, theta.shape[-1]).reshape(
            -1, theta.shape[-1])
        ys, *hist = _AdaptiveSolve.apply(y0, theta, ode)
        return (ys.reshape(*lead, *ys.shape[1:]), *hist), (0, None, None,
                                                           None)


class DifferentialEquation:
    """Specify an ODE solved on a fixed time grid (cf. ``ode/ode.py:27``).

    Parameters
    ----------
    func : callable
        ``func(y, t, p)`` returning dy/dt for one point, in torch ops
        (list/tuple returns are stacked).
    times : array
        Output times (must be increasing; t0 prepended).
    n_states : int
    n_theta : int
    t0 : float
    n_substeps : int
        RK4 substeps between consecutive output times (``method="rk4"``).
    method : "rk45" (adaptive DOPRI5, the default) or "rk4" (fixed grid)
    rtol, atol : the adaptive solver's tolerances (by ``floatX`` when None)
    max_steps : the adaptive solver's bound on iterations; calibrated from
        the test values at the first call when None.
    """

    def __init__(self, func, times, n_states, n_theta, t0=0,
                 n_substeps=4, method="rk45", rtol=None, atol=None,
                 max_steps=None):
        if not callable(func):
            raise ValueError("Argument func must be callable.")
        if n_states < 1:
            raise ValueError("Argument n_states must be at least 1.")
        if n_theta <= 0:
            raise ValueError("Argument n_theta must be positive.")
        if method not in ("rk45", "rk4"):
            raise ValueError("method must be 'rk45' (adaptive) or 'rk4' "
                             "(fixed grid)")
        self.func = func
        self.t0 = float(t0)
        self.times = np.asarray(times, dtype=np.float64)
        # t0 == times[0] is allowed (the reference's freefall asv benchmark
        # uses it): the first observation then IS the initial condition
        if np.any(np.diff(self.times) <= 0) or t0 > self.times[0]:
            raise ValueError("The initial time t0 must be less than or "
                             "equal to the first observation time, and "
                             "times must be strictly increasing.")
        if t0 == self.times[0] and len(self.times) < 2:
            raise ValueError("With t0 == times[0] at least two observation "
                             "times are required.")
        self.n_states = int(n_states)
        self.n_theta = int(n_theta)
        self.n_times = len(self.times)
        self.n_substeps = int(n_substeps)
        self.method = method
        wide = floatX() == "float64"
        self.rtol = float(rtol) if rtol is not None else \
            (1e-8 if wide else 1e-4)
        self.atol = float(atol) if atol is not None else \
            (1e-8 if wide else 1e-6)
        # the bound on iterations: a lane that needs more is NaN-poisoned.
        # When not given, the first ``__call__`` calibrates it from the
        # step count at the test point (margin 3x, see ``calibrate``)
        self._auto_max_steps = max_steps is None
        if max_steps is None:
            max_steps = int(np.clip(16 * self.n_times, 256, 4096))
        self.max_steps = int(max_steps)
        self._t0_is_first = bool(self.times[0] == self.t0)
        first_end = self.times[1] if self._t0_is_first else self.times[0]
        self._dt0 = (first_end - self.t0) / 8.0
        self._tableaus = {}
        self._graphs = Graphs(self)

    def _wrap_func(self):
        func = self.func

        def f(y, t, p):
            out = func(y, t, p)
            if isinstance(out, (list, tuple)):
                out = torch.stack([
                    o.to(y.dtype).reshape(()) if isinstance(o, torch.Tensor)
                    else torch.as_tensor(o, dtype=y.dtype, device=y.device)
                    for o in out])
            return out.to(y.dtype).reshape(y.shape)
        return f

    def _batched_func(self):
        """``func`` for every lane: ``(B, S), (B,), (B, P) -> (B, S)``."""
        return torch.func.vmap(self._wrap_func())

    def _tableau(self, like):
        """The tableau and output times as tensors on ``like``'s device and
        dtype, made once."""
        key = (like.device, like.dtype)
        if key not in self._tableaus:
            def as_t(v):
                return torch.as_tensor(np.asarray(v), dtype=like.dtype,
                                       device=like.device)
            self._tableaus[key] = {
                "times": as_t(self.times),
                "rows": torch.arange(self.n_times, device=like.device),
                "a": [None] + [as_t(_DP_A[i, :i]) for i in range(1, 6)],
                "b5": as_t(_DP_B5[:6]), "b4": as_t(_DP_B4)}
        return self._tableaus[key]

    # -- the adaptive solve --------------------------------------------------
    def _init_state(self, y0):
        """``(t, y, dt, out_idx, ys)`` of every lane before the first step;
        with t0 == times[0] the first output is ``y0``."""
        B = y0.shape[0]
        ys = y0.new_zeros((B, self.n_times, self.n_states))
        if self._t0_is_first:
            ys = torch.cat([y0[:, None], ys[:, 1:]], dim=1)
        out_idx = torch.full((B,), int(self._t0_is_first), dtype=torch.long,
                             device=y0.device)
        t = y0.new_full((B,), self.t0)
        dt = y0.new_full((B,), self._dt0)
        return t, y0, dt, out_idx, ys

    def _step(self, fb, tab, theta, state):
        """One iteration of the masked loop over every lane (cf.
        ``_solve_adaptive``'s scan body, ``ode/ode.py:164-202``): the new
        state, the accepted step (0 where none) and the written row (-1
        where none)."""
        t, y, dt, out_idx, ys = state
        n_out = self.n_times
        done = out_idx >= n_out
        t_target = tab["times"][torch.clamp(out_idx, max=n_out - 1)]
        h = torch.clamp(torch.minimum(dt, t_target - t), min=1e-10)

        y_new, err = _dopri5_step(fb, tab, y, t, h, theta)
        scale = self.atol + self.rtol * torch.maximum(torch.abs(y),
                                                      torch.abs(y_new))
        err_norm = torch.sqrt(torch.mean((err / scale) ** 2, dim=-1))
        err_norm = torch.where(torch.isnan(err_norm), torch.inf, err_norm)
        # the accepted step-size sequence is data: gradients flow through
        # the state, not the controller
        err_norm = err_norm.detach()
        accept = err_norm <= 1.0

        # I-controller with limiter (cf. Hairer-Norsett-Wanner II.4)
        factor = torch.clamp(
            0.9 * torch.pow(torch.clamp(err_norm, min=1e-10), -0.2),
            0.2, 5.0)
        dt_next = torch.clamp(h * factor, 1e-8, self.times[-1] - self.t0)

        step_ok = accept & ~done
        t_new = torch.where(step_ok, t + h, t)
        y_next = torch.where(step_ok[:, None], y_new, y)
        reached = step_ok & (t + h >= t_target - 1e-9)
        write = torch.where(reached, out_idx, -1)
        ys = torch.where((write[:, None] == tab["rows"])[..., None],
                         y_new[:, None], ys)
        out_next = out_idx + reached.long()
        dt_keep = torch.where(done, dt, dt_next)
        return ((t_new, y_next, dt_keep, out_next, ys),
                torch.where(step_ok, h, 0.0), write)

    def _poison(self, ys, out_idx, tab):
        """NaN in the rows a lane never wrote: its logp is then not
        finite, never silently wrong."""
        incomplete = tab["rows"] >= out_idx[:, None]
        return torch.where(incomplete[..., None], torch.nan, ys)

    def _adaptive_forward(self, y0, theta):
        """The solve with early exit; ``(ys, t_hist, h_hist, w_hist)``."""
        global ITERATIONS, SOLVES
        out = self._graphs.solve(y0, theta, _CHECK_EVERY)
        if out is not None:
            ITERATIONS += out[-1]
            SOLVES += 1
            return out[:-1]
        fb = self._batched_func()
        tab = self._tableau(y0)
        state = self._init_state(y0)
        t_hist, h_hist, w_hist = [], [], []
        it = 0
        while it < self.max_steps:
            t_hist.append(state[0])
            state, h, write = self._step(fb, tab, theta, state)
            h_hist.append(h)
            w_hist.append(write)
            it += 1
            if it % _CHECK_EVERY == 0 and not bool(
                    (state[3] < self.n_times).any()):
                break
        ITERATIONS += it
        SOLVES += 1
        return (self._poison(state[4], state[3], tab), torch.stack(t_hist),
                torch.stack(h_hist), torch.stack(w_hist))

    def _replay(self, y0, theta, t_hist, h_hist, w_hist):
        """The forward's accepted steps again, from ``y0`` and ``theta``,
        with the same arithmetic (so the same values) for autograd. A lane
        that did not step in an iteration steps by 0 there and keeps its
        state, so a rejected step's non-finite values never enter its
        gradient."""
        fb = self._batched_func()
        tab = self._tableau(y0)
        _, y, _, out_idx, ys = self._init_state(y0)
        for t, h, write in zip(t_hist, h_hist, w_hist):
            _, y5 = _stages(fb, tab, y, t, h, theta)
            ys = torch.where((write[:, None] == tab["rows"])[..., None],
                             y5[:, None], ys)
            y = torch.where((h > 0)[:, None], y5, y)
        out_idx = out_idx + (w_hist >= 0).sum(dim=0)
        return self._poison(ys, out_idx, tab)

    def _count_steps(self, y0, theta):
        """Attempted/accepted DOPRI5 step counts at concrete (y0, theta)
        — the calibration measurement behind auto ``max_steps``. Leaves
        its loop once the outputs are written, as the solve does."""
        device = current_device()
        y0 = torch.as_tensor(np.asarray(y0), dtype=torch_floatX(),
                             device=device).reshape(1, self.n_states)
        theta = torch.as_tensor(np.asarray(theta), dtype=torch_floatX(),
                                device=device).reshape(1, self.n_theta)
        fb = self._batched_func()
        tab = self._tableau(y0)
        state = self._init_state(y0)
        n_att = torch.zeros((), dtype=torch.long, device=device)
        n_acc = torch.zeros_like(n_att)
        with torch.no_grad():
            for it in range(max(4096, self.max_steps)):
                n_att = n_att + (state[3] < self.n_times).sum()
                state, h, _ = self._step(fb, tab, theta, state)
                n_acc = n_acc + (h > 0).sum()
                if (it + 1) % _CHECK_EVERY == 0 and not bool(
                        (state[3] < self.n_times).any()):
                    break
        out_f = int(state[3][0])
        return {"attempts": int(n_att), "accepted": int(n_acc),
                "outputs_written": out_f, "complete": out_f >= self.n_times}

    def calibrate(self, y0, theta, margin=3.0, probe_scales=(0.5, 1.0, 2.0)):
        """Set ``max_steps`` from measured DOPRI5 attempt counts with a
        safety margin (cf. ``ode/ode.py:257``). Called on the first
        ``__call__`` when ``max_steps`` was not given.

        Posterior draws land away from the test point, often in stiffer
        regions, so the bound covers ``theta`` scaled by each of
        ``probe_scales`` and takes the worst probe. If a probe does not
        finish within the probe budget the blanket bound
        (``clip(16*n_times, 256, 4096)``) is kept. An undersized bound is
        never silently wrong: unfinished solves are NaN-poisoned."""
        y0 = np.asarray(y0, dtype=np.float64)
        theta = np.asarray(theta, dtype=np.float64)
        attempts = []
        for s in probe_scales:
            stats = self._count_steps(y0, theta * s)
            if not stats["complete"]:
                return stats
            attempts.append(stats["attempts"])
        self.max_steps = max(int(np.ceil(margin * max(attempts))),
                             4 * self.n_times, 64)
        return stats

    # -- the solution node ---------------------------------------------------
    def _solve(self, y0, theta):
        """(n_times, n_states) solution of one point (batched by the
        model's ``vmap``)."""
        y0 = y0.reshape((self.n_states,))
        theta = theta.reshape((self.n_theta,))
        if self.method == "rk45":
            return _AdaptiveSolve.apply(y0[None], theta[None], self)[0][0]
        f = self._wrap_func()
        grid = np.concatenate([[self.t0], self.times])
        starts, ends = grid[:-1], grid[1:]
        steps = (ends - starts) / self.n_substeps
        sub_ts = starts[:, None] + np.arange(self.n_substeps)[None, :] * \
            steps[:, None]
        dts = torch.as_tensor(steps.astype(floatX()), device=y0.device)
        sub_ts = torch.as_tensor(sub_ts.astype(floatX()), device=y0.device)
        ys, y = [], y0
        for i in range(self.n_times):
            for j in range(self.n_substeps):
                y = _rk4_step(f, y, sub_ts[i, j], dts[i], theta)
            ys.append(y)
        return torch.stack(ys)

    def __call__(self, y0, theta, return_sens=False, **kwargs):
        """Build the symbolic solution node (cf. ``ode/ode.py:84``)."""
        if isinstance(y0, (list, tuple)) and len(y0) != self.n_states:
            raise ValueError(f"Length of y0 is wrong. Expected {self.n_states}"
                             f", got {len(y0)}.")
        if isinstance(theta, (list, tuple)) and len(theta) != self.n_theta:
            raise ValueError(f"Length of theta is wrong. Expected "
                             f"{self.n_theta}, got {len(theta)}.")
        device = current_device()

        def pack(*vals):
            dev = next((v.device for v in vals
                        if isinstance(v, torch.Tensor)), device)
            vals = [v.to(torch_floatX()) if isinstance(v, torch.Tensor)
                    else torch.as_tensor(v, dtype=torch_floatX(), device=dev)
                    for v in vals]
            if len(vals) == 1:
                return vals[0].reshape(-1)
            return torch.stack([v.reshape(()) for v in vals])

        y0_node = node_apply(pack, *y0) if isinstance(y0, (list, tuple)) \
            else as_node(y0)
        theta_node = node_apply(pack, *theta) \
            if isinstance(theta, (list, tuple)) else as_node(theta)

        if self._auto_max_steps and self.method == "rk45":
            # size the bound from the test-point step count once (margin
            # 3x; see ``calibrate``)
            self._auto_max_steps = False
            self.calibrate(np.asarray(y0_node.test_value, np.float64),
                           np.asarray(theta_node.test_value, np.float64))
        return node_apply(self._solve, y0_node, theta_node)

    def __repr__(self):
        return (f"DifferentialEquation(n_states={self.n_states}, "
                f"n_theta={self.n_theta})")


def solve_adaptive_reference(ode, y0, theta):
    """The plain adaptive solve of ``y0 (B, S)``, ``theta (B, P)``: all
    ``ode.max_steps`` masked iterations, no early exit, differentiated by
    autograd alone (cf. ``_solve_adaptive``, ``ode/ode.py:141-217``)."""
    fb = torch.func.vmap(ode._wrap_func())
    tab = ode._tableau(y0)
    state = ode._init_state(y0)
    for _ in range(ode.max_steps):
        state, _, _ = ode._step(fb, tab, theta, state)
    return ode._poison(state[4], state[3], tab)
