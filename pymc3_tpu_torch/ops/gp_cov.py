"""Fused stationary GP covariance: the hand-written CUDA kernels and their
plain PyTorch versions (the port of ``pymc3_tpu/ops/pallas/gp_cov.py``).

``stationary_cov(X, Xs, kind)`` computes ``K = f(|x - x'|^2)`` over
lengthscale-scaled inputs, ``X: (n, d)`` or ``(B, n, d)``. On a CUDA tensor
the forward and the backward are the two kernels of ``csrc/gp_cov.cu``
(built with ``nvcc`` at first use into ``build/kernels/`` and loaded with
``ctypes``), in float32 or in float64 (one source built twice at once, a
library of entry points per type, chosen by the inputs' dtype); on a CPU tensor they are
:func:`stationary_cov_reference` and
:func:`stationary_cov_backward_reference`. There is no fallback from the
card to the plain versions: a CUDA tensor a kernel does not take (another
dtype, or two dtypes) raises.

Gradients go through a ``torch.autograd.Function`` whose backward is a
second Function around the backward kernel (the JAX package's custom VJP ran
outside its TPU kernel, fused by XLA). Both have a ``vmap`` rule that moves
the chain dimension of a ``torch.func.vmap`` over the model's logp (with or
without ``torch.func.grad`` inside) into the kernels' batch argument, so a
batch of chains is ONE forward launch and ONE backward call on plain
tensors. The op is once-differentiable: a second derivative raises.

The float32 kernels (and their float64 instantiations) put the batch on
``gridDim.z``, which the card caps at 65,535. A larger batch (SMC over a GP
evaluates every particle in one call) is cut here, on the host, into
chunks of at most 65,535 entries, one launch each into slices of one
output; the kernels themselves are unchanged. The float64 design's
one-dimensional grids take the same chunks, so there is one path. The
counters count calls, not chunks.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["stationary_cov", "stationary_cov_reference",
           "stationary_cov_backward_reference", "STATIONARY_KINDS",
           "LAUNCHES", "BACKWARD_LAUNCHES", "build"]

STATIONARY_KINDS = ("expquad", "matern52", "matern32", "matern12",
                    "exponential")
_EPS = 1e-12

_KIND_INDEX = {kind: i for i, kind in enumerate(STATIONARY_KINDS)}
#: The element types the kernels take, and the suffix of their C entry
#: points (``gp_cov_forward_f32``, ``gp_cov_forward_f64``, ...).
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: The most batch entries one launch takes: the kernels' ``gridDim.z``.
MAX_GRID_Z = 65_535

#: Forward kernel calls since import (or since a caller reset it); a call
#: whose batch is cut into chunks (see :func:`_launch`) counts once.
LAUNCHES = 0
#: Calls of the backward kernel (each is its two launches: the tile pass and
#: the pass that adds the tiles' partial sums).
BACKWARD_LAUNCHES = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gp_cov.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: The loaded kernel library of each element type (see :func:`build`).
_libs = {}


def _apply_covfn(kind, d2):
    """K = f(d^2), the five kernels of ``_apply_covfn`` (gp_cov.py:51)."""
    if kind == "expquad":
        return torch.exp(-0.5 * d2)
    if kind == "matern52":
        t = torch.sqrt(5.0 * d2 + _EPS)
        return (1.0 + t + (t * t) / 3.0) * torch.exp(-t)
    if kind == "matern32":
        t = torch.sqrt(3.0 * d2 + _EPS)
        return (1.0 + t) * torch.exp(-t)
    if kind == "matern12":
        return torch.exp(-torch.sqrt(d2 + _EPS))
    if kind == "exponential":
        return torch.exp(-0.5 * torch.sqrt(d2 + _EPS))
    raise ValueError(f"unknown stationary kind: {kind}")


def _dcov_dd2(kind, d2):
    """dK/d(d^2) in closed form (gp_cov.py:69)."""
    if kind == "expquad":
        return -0.5 * torch.exp(-0.5 * d2)
    if kind == "matern52":
        t = torch.sqrt(5.0 * d2 + _EPS)
        return -(5.0 / 6.0) * (1.0 + t) * torch.exp(-t)
    if kind == "matern32":
        return -1.5 * torch.exp(-torch.sqrt(3.0 * d2 + _EPS))
    if kind == "matern12":
        r = torch.sqrt(d2 + _EPS)
        return torch.exp(-r) * (-0.5 / r)
    if kind == "exponential":
        r = torch.sqrt(d2 + _EPS)
        return torch.exp(-0.5 * r) * (-0.25 / r)
    raise ValueError(f"unknown stationary kind: {kind}")


def _sqdist(X, Xs):
    """Exact pairwise squared distance over any leading batch dims, for
    every feature count (the TPU kernel never switched to the matmul form)."""
    d2 = torch.sum((X[..., :, None, :] - Xs[..., None, :, :]) ** 2, dim=-1)
    return torch.clamp(d2, min=0.0)


def stationary_cov_reference(X, Xs=None, kind="expquad"):
    """Plain PyTorch version of the forward kernel: same inputs, same
    output."""
    return _apply_covfn(kind, _sqdist(X, X if Xs is None else Xs))


def stationary_cov_backward_reference(g, X, Xs, kind="expquad"):
    """Plain PyTorch version of the backward kernel, the closed form of the
    JAX package's custom VJP (gp_cov.py:215-222): w = g dK/dd2,
    dX = 2 (rowsum(w) X - w Xs), dXs = 2 (colsum(w) Xs - w^T X), for any
    leading batch dims. The kernel sums w (x - x') instead, which is the
    same sum and cancels less."""
    w = g * _dcov_dd2(kind, _sqdist(X, Xs))
    dX = 2.0 * (w.sum(-1, keepdim=True) * X - w @ Xs)
    dXs = 2.0 * (w.sum(-2)[..., None] * Xs - w.transpose(-1, -2) @ X)
    return dX, dXs


# --------------------------------------------------------------------------
# the CUDA kernels: build, load, launch
# --------------------------------------------------------------------------

def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the gp_cov kernel cannot be built")


def build():
    """Compile ``csrc/gp_cov.cu`` into one library per element type, both
    kernels each (the float32 and the float64 entry points, selected by
    ``-DGP_COV_F32`` / ``-DGP_COV_F64``), the two ``nvcc`` runs started
    together where a library is not built yet, and load both. Returns
    ``({dtype: path}, seconds, compiler_output)``; each library is keyed by
    the source's hash and its flags, so an edited source is rebuilt."""
    src = _SOURCE.read_bytes()
    jobs, paths = [], {}
    t0 = time.perf_counter()
    for dtype, suffix in _SUFFIX.items():
        flags = [*_NVCC_FLAGS, f"-DGP_COV_{suffix.upper()}"]
        tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
        path = paths[dtype] = _BUILD_DIR / f"libgp_cov_{suffix}_{tag[:16]}.so"
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            jobs.append((path, tmp, subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp), str(_SOURCE)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = ""
    for path, tmp, proc in jobs:
        out = proc.communicate()[0]
        log += out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {_SOURCE}:\n{out}")
        os.replace(tmp, path)
    seconds = time.perf_counter() - t0 if jobs else 0.0
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for dtype, suffix in _SUFFIX.items():
        lib = ctypes.CDLL(str(paths[dtype]))
        fwd = getattr(lib, f"gp_cov_forward_{suffix}")
        fwd.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
        fwd.restype = i32
        scratch = getattr(lib, f"gp_cov_backward_scratch_{suffix}")
        scratch.argtypes = [i32] * 4
        scratch.restype = i64
        bwd = getattr(lib, f"gp_cov_backward_{suffix}")
        bwd.argtypes = [ptr] + [i64] * 3 + [ptr] * 5 + [i64] + [i32] * 5 + [ptr]
        bwd.restype = i32
        _libs[dtype] = lib
    return paths, seconds, log


def _checked(kind, X, Xs):
    """The argument checks both launches share (host-side only: no device
    query): float32 or float64, both inputs alike, on one CUDA device;
    returns ``(B, n, m, d)`` and contiguous ``X``, ``Xs``."""
    if kind not in _KIND_INDEX:
        raise ValueError(f"kind must be one of {STATIONARY_KINDS}")
    if X.dtype not in _SUFFIX or Xs.dtype is not X.dtype:
        raise TypeError("the gp_cov kernels take float32 or float64, both "
                        f"inputs alike, got {X.dtype} and {Xs.dtype}")
    if not X.is_cuda or X.device != Xs.device:
        raise ValueError("X and Xs must be on the same CUDA device, got "
                         f"{X.device} and {Xs.device}")
    B, n, d = X.shape
    m = Xs.shape[1]
    if Xs.shape[0] != B or Xs.shape[2] != d:
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, "
                         f"Xs {tuple(Xs.shape)}")
    if min(B, n, m, d) <= 0:
        raise ValueError(f"empty input: X {tuple(X.shape)}, "
                         f"Xs {tuple(Xs.shape)}")
    if not _libs:
        build()
    if not X.is_contiguous():
        X = X.contiguous()
    if not Xs.is_contiguous():
        Xs = Xs.contiguous()
    return B, n, m, d, X, Xs


def _call(fn, device, *args):
    """Call a kernel's C entry on the current stream of ``device``; the
    device is switched to only when it is not the current one."""
    index = device.index
    if index is None or index == torch.cuda.current_device():
        # the stream's handle alone: no Stream object per launch
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device() if index is None else index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gp_cov kernel launch failed: CUDA error {rc}")


def _chunks(B):
    """Batch ranges of at most ``MAX_GRID_Z`` entries: both kernels put the
    batch on ``gridDim.z``, which the card caps at 65,535."""
    return [(b, min(b + MAX_GRID_Z, B)) for b in range(0, B, MAX_GRID_Z)]


def _entry(name, dtype):
    """The C entry point ``name`` of the kernels' element type ``dtype``."""
    return getattr(_libs[dtype], f"{name}_{_SUFFIX[dtype]}")


def _launch(kind, X, Xs):
    """One forward call on plain CUDA tensors ``X (B, n, d)``,
    ``Xs (B, m, d)``, both float32 or both float64 (the kernel of that
    type); returns ``K (B, n, m)`` in that type. A batch above 65,535 is cut
    into chunks of at most that many, one launch each, written into one
    output; the call counts once in ``LAUNCHES`` whatever its chunks."""
    global LAUNCHES
    B, n, m, d, X, Xs = _checked(kind, X, Xs)
    out = torch.empty((B, n, m), dtype=X.dtype, device=X.device)
    forward = _entry("gp_cov_forward", X.dtype)
    for b0, b1 in _chunks(B):
        _call(forward, X.device, X[b0:b1].data_ptr(),
              Xs[b0:b1].data_ptr(), out[b0:b1].data_ptr(), b1 - b0, n, m, d,
              _KIND_INDEX[kind])
    LAUNCHES += 1
    return out


def _launch_backward(kind, g, X, Xs):
    """One call of the backward kernel on plain CUDA tensors of one type,
    float32 or float64: cotangent ``g (B, n, m)`` with any strides (an
    expanded, stride-0 one is read in place), ``X (B, n, d)``,
    ``Xs (B, m, d)``; returns ``dX (B, n, d)``, ``dXs (B, m, d)`` in that
    type. A batch above 65,535 is cut into chunks as in :func:`_launch`,
    which share one scratch buffer; the call counts once in
    ``BACKWARD_LAUNCHES``."""
    global BACKWARD_LAUNCHES
    B, n, m, d, X, Xs = _checked(kind, X, Xs)
    if g.dtype is not X.dtype or g.device != X.device:
        raise TypeError(f"the cotangent must be {X.dtype} on X's device, "
                        f"got {g.dtype} on {g.device}")
    if tuple(g.shape) != (B, n, m):
        raise ValueError(f"cotangent shape {tuple(g.shape)}, expected "
                         f"{(B, n, m)}")
    dX = torch.empty((B, n, d), dtype=X.dtype, device=X.device)
    dXs = torch.empty((B, m, d), dtype=X.dtype, device=X.device)
    chunks = _chunks(B)
    elems = max(_entry("gp_cov_backward_scratch", X.dtype)(size, n, m, d)
                for size in {b1 - b0 for b0, b1 in chunks})
    if elems < 0:
        raise ValueError(f"the backward kernel does not take B, n, m, d = "
                         f"{(B, n, m, d)}")
    scratch = torch.empty((elems,), dtype=X.dtype, device=X.device)
    backward = _entry("gp_cov_backward", X.dtype)
    for b0, b1 in chunks:
        gb = g[b0:b1]
        _call(backward, X.device, gb.data_ptr(), *gb.stride(),
              X[b0:b1].data_ptr(), Xs[b0:b1].data_ptr(), dX[b0:b1].data_ptr(),
              dXs[b0:b1].data_ptr(), scratch.data_ptr(), elems, b1 - b0, n,
              m, d, _KIND_INDEX[kind])
    BACKWARD_LAUNCHES += 1
    return dX, dXs


def _cov_forward(kind, X, Xs):
    """Forward on plain tensors with a leading batch dimension."""
    if X.is_cuda:
        return _launch(kind, X, Xs)
    return stationary_cov_reference(X, Xs, kind)


def _cov_backward(kind, g, X, Xs):
    """Backward on plain tensors with a leading batch dimension."""
    if X.is_cuda:
        return _launch_backward(kind, g, X, Xs)
    return stationary_cov_backward_reference(g, X, Xs, kind)


def _front(t, dim, batch_size):
    """Bring the vmapped dimension of ``t`` to the front (or expand a
    tensor that has none)."""
    if dim is None:
        return t.expand(batch_size, *t.shape)
    return t.movedim(dim, 0)


def _fold(t):
    """(B, C, ...) -> (B * C, ...): a vmap over an already batched call."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


class _StationaryCovBackward(torch.autograd.Function):
    """(dX, dXs) from the cotangent of K. A Function of its own so that the
    backward of ``_StationaryCov``, traced under ``torch.func.vmap``, folds
    the chains into one kernel call as the forward does."""

    @staticmethod
    def forward(g, X, Xs, kind):
        if X.ndim == 2:
            dX, dXs = _cov_backward(kind, g[None], X[None], Xs[None])
            return dX[0], dXs[0]
        return _cov_backward(kind, g, X, Xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("stationary_cov is once-differentiable: its "
                           "backward has no derivative")

    @staticmethod
    def vmap(info, in_dims, g, X, Xs, kind):
        g, X, Xs = (_front(t, dim, info.batch_size)
                    for t, dim in zip((g, X, Xs), in_dims[:3]))
        if X.ndim == 3:
            return _StationaryCovBackward.apply(g, X, Xs, kind), (0, 0)
        B = X.shape[0]
        dX, dXs = _StationaryCovBackward.apply(_fold(g), _fold(X), _fold(Xs),
                                               kind)
        return (dX.reshape(B, -1, *dX.shape[1:]),
                dXs.reshape(B, -1, *dXs.shape[1:])), (0, 0)


class _StationaryCov(torch.autograd.Function):
    """K = f(d^2(X, Xs)) with the closed-form backward of gp_cov.py:215-222."""

    @staticmethod
    def forward(X, Xs, kind):
        if X.ndim == 2:
            return _cov_forward(kind, X[None], Xs[None])[0]
        return _cov_forward(kind, X, Xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        X, Xs, kind = inputs
        ctx.save_for_backward(X, Xs)
        ctx.kind = kind

    @staticmethod
    def backward(ctx, g):
        X, Xs = ctx.saved_tensors
        dX, dXs = _StationaryCovBackward.apply(g, X, Xs, ctx.kind)
        return dX, dXs, None

    @staticmethod
    def vmap(info, in_dims, X, Xs, kind):
        # fold the vmapped dimension into the kernel's batch argument
        X = _front(X, in_dims[0], info.batch_size)
        Xs = _front(Xs, in_dims[1], info.batch_size)
        if X.ndim == 3:
            return _StationaryCov.apply(X, Xs, kind), 0
        B = X.shape[0]
        K = _StationaryCov.apply(_fold(X), _fold(Xs), kind)
        return K.reshape(B, -1, *K.shape[1:]), 0


def stationary_cov(X, Xs=None, kind="expquad"):
    """K = f(pairwise squared distance) for lengthscale-scaled inputs.

    ``X: (n, d)`` or ``(B, n, d)``; ``Xs`` of the same rank or None
    (``Xs = X``); ``kind`` one of ``STATIONARY_KINDS``.
    """
    if kind not in STATIONARY_KINDS:
        raise ValueError(f"kind must be one of {STATIONARY_KINDS}")
    Xs = X if Xs is None else Xs
    if X.ndim not in (2, 3) or Xs.ndim != X.ndim:
        raise ValueError("X and Xs must both be (n, d) or both (B, n, d)")
    return _StationaryCov.apply(X, Xs, kind)
