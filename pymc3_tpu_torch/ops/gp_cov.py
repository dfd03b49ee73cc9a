"""Fused stationary GP covariance: the hand-written CUDA kernel and its plain
PyTorch version (the port of ``pymc3_tpu/ops/pallas/gp_cov.py``).

``stationary_cov(X, Xs, kind)`` computes ``K = f(|x - x'|^2)`` over
lengthscale-scaled inputs, ``X: (n, d)`` or ``(B, n, d)``. On a CUDA tensor
the forward is the kernel in ``csrc/gp_cov.cu`` (built with ``nvcc`` at
first use into ``build/kernels/`` and loaded with ``ctypes``); on a CPU
tensor it is :func:`stationary_cov_reference`. There is no fallback from
the card to the plain version: a CUDA tensor the kernel does not take
raises.

Gradients go through a ``torch.autograd.Function`` whose backward is the
plain-PyTorch transcription of the JAX package's custom VJP (which also ran
outside the TPU kernel): recompute d^2, weight by dK/dd^2, two batched
matmuls. Its ``vmap`` rule moves the chain dimension of a
``torch.func.vmap`` over the model's logp (with or without
``torch.func.grad`` inside) into the kernel's batch argument, so a batch of
chains is ONE launch on plain tensors.
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

__all__ = ["stationary_cov", "stationary_cov_reference", "STATIONARY_KINDS",
           "LAUNCHES", "build"]

STATIONARY_KINDS = ("expquad", "matern52", "matern32", "matern12",
                    "exponential")
_EPS = 1e-12

#: Number of CUDA kernel launches since import (or since a caller reset it).
LAUNCHES = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gp_cov.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lib = None


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
    """Plain PyTorch version of the kernel: same inputs, same output."""
    return _apply_covfn(kind, _sqdist(X, X if Xs is None else Xs))


# --------------------------------------------------------------------------
# the CUDA kernel: build, load, launch
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
    """Compile ``csrc/gp_cov.cu`` (if its build is not there yet) and load
    it. Returns ``(path, seconds, compiler_output)``; the library is keyed
    by the source's hash, so an edited source is rebuilt."""
    global _lib
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    path = _BUILD_DIR / f"libgp_cov_{tag[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {_SOURCE}:\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    fn = lib.gp_cov_forward_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return path, seconds, log


def _launch(kind, X, Xs):
    """One kernel launch on plain contiguous float32 CUDA tensors
    ``X (B, n, d)``, ``Xs (B, m, d)``; returns ``K (B, n, m)``."""
    global LAUNCHES
    if X.dtype != torch.float32 or Xs.dtype != torch.float32:
        raise TypeError(f"the gp_cov kernel takes float32, got {X.dtype} "
                        f"and {Xs.dtype}")
    if X.device != Xs.device:
        raise ValueError("X and Xs must be on the same device")
    B, n, d = X.shape
    if Xs.shape[0] != B or Xs.shape[2] != d:
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, "
                         f"Xs {tuple(Xs.shape)}")
    if _lib is None:
        build()
    X = X.contiguous()
    Xs = Xs.contiguous()
    m = Xs.shape[1]
    out = torch.empty((B, n, m), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        rc = _lib.gp_cov_forward_f32(X.data_ptr(), Xs.data_ptr(),
                                     out.data_ptr(), B, n, m, d,
                                     STATIONARY_KINDS.index(kind), stream)
    if rc != 0:
        raise RuntimeError(f"gp_cov kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def _cov_forward(kind, X, Xs):
    """Forward on plain tensors with a leading batch dimension."""
    if X.is_cuda:
        return _launch(kind, X, Xs)
    return stationary_cov_reference(X, Xs, kind)


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
        # w = g * dK/dd2; dX = 2(rowsum(w) X - w Xs), dXs = 2(colsum(w) Xs
        # - w^T X), for any leading batch dims
        w = g * _dcov_dd2(ctx.kind, _sqdist(X, Xs))
        dX = 2.0 * (w.sum(-1, keepdim=True) * X - w @ Xs)
        dXs = 2.0 * (w.sum(-2)[..., None] * Xs - w.transpose(-1, -2) @ X)
        return dX, dXs, None

    @staticmethod
    def vmap(info, in_dims, X, Xs, kind):
        # fold the vmapped dimension into the kernel's batch argument
        def front(t, dim):
            if dim is None:
                return t.expand(info.batch_size, *t.shape)
            return t.movedim(dim, 0)
        X = front(X, in_dims[0])
        Xs = front(Xs, in_dims[1])
        if X.ndim == 3:
            return _StationaryCov.apply(X, Xs, kind), 0
        B, C = X.shape[:2]
        K = _StationaryCov.apply(X.reshape(B * C, *X.shape[2:]),
                                 Xs.reshape(B * C, *Xs.shape[2:]), kind)
        return K.reshape(B, C, *K.shape[1:]), 0


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
