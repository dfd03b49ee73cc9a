"""Multi-device chain parallelism on ``torch.distributed`` (cf.
``pymc3_tpu/parallel/__init__.py``).

The JAX package is one program over every device: ``shard_map`` shards the
chain axis over a ``Mesh`` and kernels ``psum`` over it. PyTorch's idiom is
one process per device, each running the same script (SPMD ranks, started
by ``torchrun`` or :func:`launch`). Each rank holds a contiguous block of
the global chains on its own device; the cross-chain reductions of pooled
adaptation, the NUTS rescue, SMC's particle statistics and data-parallel
ADVI are collectives over the ranks' process group.

Device-side collectives are ``all_reduce`` (SUM, MAX, MIN) and
``broadcast`` only: the two operations that the gloo backend implements for
CUDA tensors, so the same code runs under gloo (CPU ranks, or several ranks
sharing one card) and under NCCL (one rank per card). A gather of rows is
an ``all_reduce`` SUM of a zero-filled global buffer in which each rank has
written its own rows (the JAX package's ``psum(where(mine, x, 0))``);
adding zeros is exact, so every rank holds the same bits. Host-side gathers
(trace blocks, checkpoints) go over a second, gloo group on the CPU.

A :class:`ChainMesh` carries the group, this rank, the world size, this
rank's device and the host group, and counts the collectives it issues with
the host time they took.
"""
from __future__ import annotations

import atexit
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..config import get_config, set_config

__all__ = ["ChainMesh", "make_mesh", "shard_chain_fn", "shard_block_fn",
           "initialize_distributed", "pooled_axes", "CHAIN_AXIS",
           "LOCAL_CHAIN_AXIS", "GlobalNoise", "RemoteWorkerError",
           "install_worker_excepthook", "terminate_workers", "launch",
           "rank_seed"]

CHAIN_AXIS = "chains"              # chains sharded across ranks
LOCAL_CHAIN_AXIS = "chains_local"  # chains within one rank (dim 0)

#: Environment variables through which :func:`launch` tells each rank where
#: the group meets, which device to take and which backend to use.
INIT_ENV = "PYMC3_TORCH_INIT_METHOD"
DEVICE_ENV = "PYMC3_TORCH_DEVICE"
BACKEND_ENV = "PYMC3_TORCH_BACKEND"
#: The process id of the launching process: a rank whose launcher is gone
#: exits (see :func:`_exit_with_parent`).
PARENT_ENV = "PYMC3_TORCH_PARENT_PID"

#: A collective that waits longer than this fails instead of hanging.
COLLECTIVE_TIMEOUT = timedelta(seconds=600)

# the process group's host group and device, set by initialize_distributed
# (a process group is itself process-wide state)
_GROUP_STATE = {}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class ChainMesh:
    """This rank's place among the ranks that share the chain axis.

    ``group`` is ``None`` outside a process group (one rank, every
    collective the identity). ``calls`` counts the collectives issued and
    ``host_s`` the host seconds spent in them (under gloo a collective on
    CUDA tensors waits for the device). ``axis_name`` names the chain axis
    the ranks share, as the JAX package's ``Mesh`` does."""

    def __init__(self, group=None, rank=0, world_size=1, device=None,
                 host_group=None, backend=None, axis_name=CHAIN_AXIS):
        self.group = group
        self.axis_name = axis_name
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = torch.device(device) if device is not None else None
        self.host_group = host_group
        self.backend = backend
        self.calls = 0
        self.host_s = 0.0

    @property
    def axis_names(self):
        return (self.axis_name,)

    def __repr__(self):
        return (f"ChainMesh(rank={self.rank}, world_size={self.world_size}, "
                f"device={self.device}, backend={self.backend})")

    def local_rows(self, n, what="chains"):
        """The slice of ``n`` global rows that this rank holds; ``n`` must
        be a multiple of the world size."""
        if n % self.world_size != 0:
            raise ValueError(
                f"{what} ({n}) must be a multiple of the device count "
                f"({self.world_size}); pad the chain count.")
        local = n // self.world_size
        return slice(self.rank * local, (self.rank + 1) * local)

    def _reduce(self, x, op):
        if self.group is None:
            return x
        t0 = time.perf_counter()
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        self.calls += 1
        self.host_s += time.perf_counter() - t0
        return out

    def sum(self, x):
        """The elementwise sum of ``x`` over the ranks."""
        return self._reduce(x, "sum")

    def max(self, x):
        return self._reduce(x, "max")

    def min(self, x):
        return self._reduce(x, "min")

    def broadcast(self, x, src=0):
        """``x`` of rank ``src`` on every rank."""
        if self.group is None:
            return x
        t0 = time.perf_counter()
        out = x.detach().clone().contiguous()
        dist.broadcast(out, src=src, group=self.group)
        self.calls += 1
        self.host_s += time.perf_counter() - t0
        return out

    def gather_rows(self, x):
        """The rows of every rank, in rank order: ``x`` is this rank's
        ``(local, ...)`` block; returns ``(world_size * local, ...)``. One
        SUM of a zero-filled buffer holding this rank's rows."""
        if self.group is None:
            return x
        local = x.shape[0]
        dtype = x.dtype
        buf_dtype = torch.uint8 if dtype == torch.bool else dtype
        buf = torch.zeros((self.world_size * local,) + tuple(x.shape[1:]),
                          dtype=buf_dtype, device=x.device)
        buf[self.rank * local:(self.rank + 1) * local] = x.to(buf_dtype)
        return self.sum(buf).to(dtype)

    def host_gather(self, obj):
        """``[obj of rank 0, obj of rank 1, ...]`` on every rank, over the
        host (gloo, CPU) group; the objects are pickled."""
        if self.group is None:
            return [obj]
        t0 = time.perf_counter()
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.host_group)
        self.calls += 1
        self.host_s += time.perf_counter() - t0
        return out

    def host_broadcast(self, obj, src=0):
        """``obj`` of rank ``src`` on every rank, over the host group."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.host_group)
        self.calls += 1
        return box[0]

    def reset_counts(self):
        self.calls = 0
        self.host_s = 0.0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, backend=None,
                           device=None) -> ChainMesh:
    """Join this process to the ranks' process group and return its mesh
    (cf. the JAX package's ``initialize_distributed``, which calls
    ``jax.distributed.initialize``).

    The JAX parameters map onto ``torch.distributed``'s:
    ``coordinator_address`` ("host:port") is the TCP store
    ``init_method="tcp://host:port"``, ``num_processes`` the world size and
    ``process_id`` the rank. Without arguments it reads ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` as
    ``torchrun`` sets them (``env://``), or the variables :func:`launch`
    sets. The device defaults to ``cuda:LOCAL_RANK``, the backend to
    ``"nccl"`` for a CUDA device and ``"gloo"`` for the CPU; the port's
    models are then built on that device (``set_config(device=...)``).
    NCCL cannot run two ranks on one device: that raises, naming the
    device, and nothing switches the backend quietly. Installs
    :func:`install_worker_excepthook`."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if process_id is None else int(process_id)
    world_size = int(env.get("WORLD_SIZE", 1)) if num_processes is None \
        else int(num_processes)
    local_rank = int(env.get("LOCAL_RANK", rank))
    device = torch.device(device or env.get(DEVICE_ENV)
                          or f"cuda:{local_rank}")
    if backend is None:
        backend = env.get(BACKEND_ENV) or (
            "nccl" if device.type == "cuda" else "gloo")
    if coordinator_address is None:
        init_method = env.get(INIT_ENV, "env://")
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    atexit.register(_leave_group)
    # after init_process_group, which installs an excepthook of its own
    install_worker_excepthook(rank)
    if env.get(PARENT_ENV):
        _exit_with_parent(int(env[PARENT_ENV]))
    host_group = dist.new_group(backend="gloo",
                                timeout=COLLECTIVE_TIMEOUT) \
        if backend != "gloo" else dist.group.WORLD
    _GROUP_STATE.update(device=device, host_group=host_group,
                        backend=backend)
    set_config(device=str(device))
    mesh = make_mesh()
    where = mesh.host_gather((socket.gethostname(), str(device)))
    if backend == "nccl" and len(set(where)) < len(where):
        shared = sorted({d for d in where if where.count(d) > 1})
        dist.destroy_process_group()
        _GROUP_STATE.clear()
        raise ValueError(
            f"NCCL cannot run two ranks on one device: {shared} each hold "
            f"more than one of the {world_size} ranks. Give each rank its "
            "own card, or ask for backend='gloo'.")
    return mesh


def _leave_group():
    """Destroy the process group before the interpreter exits: gloo's
    threads still running at exit abort the process ("terminate called
    without an active exception", exit -6) once in a while."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP_STATE.clear()


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = CHAIN_AXIS) -> ChainMesh:
    """The mesh of this process, its chain axis named ``axis_name``.

    In a process group: its ranks, with this rank's device; ``devices``,
    when given, must list one device per rank. Outside one: ``devices`` of
    length one (or ``None``) is this process alone, and a longer list
    raises, since each device needs a process of its own. A
    :class:`ChainMesh` passes through."""
    if isinstance(devices, ChainMesh):
        return devices
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if devices is not None and len(devices) != world:
            raise ValueError(
                f"devices lists {len(devices)} devices but the process group "
                f"has {world} ranks: one rank per device")
        if "host_group" not in _GROUP_STATE:
            backend = dist.get_backend()
            _GROUP_STATE.update(
                device=torch.device(get_config().device), backend=backend,
                host_group=dist.new_group(backend="gloo")
                if backend != "gloo" else dist.group.WORLD)
        return ChainMesh(dist.group.WORLD, dist.get_rank(), world,
                         _GROUP_STATE["device"], _GROUP_STATE["host_group"],
                         _GROUP_STATE["backend"], axis_name)
    if devices is not None and len(devices) > 1:
        raise ValueError(
            f"{len(devices)} devices need one process each: start the ranks "
            "with parallel.launch (or torchrun), call "
            "parallel.initialize_distributed() in each, and pass "
            "devices=parallel.make_mesh() or the list of all ranks' devices")
    dev = devices[0] if devices else get_config().device
    return ChainMesh(device=dev, axis_name=axis_name)


def rank_seed(seed, mesh):
    """The seed of this rank's generator: ``seed`` itself for one rank,
    else drawn from ``(seed, rank)``."""
    if mesh is None or mesh.world_size == 1:
        return int(seed)
    return int(np.random.SeedSequence(
        [int(seed), mesh.rank]).generate_state(1)[0])


def pooled_axes(axis_name: Optional[str] = None):
    """The axes that a pooled statistic reduces over (cf. the JAX
    package's ``pooled_axes``): the local chains, and the mesh's axis when
    one is named. Here a kernel reduces over dim 0 and then over the
    stepper's mesh, so the names only mark the stepper pooled: pass
    ``NUTS(axis_name=pooled_axes(CHAIN_AXIS))`` as in the JAX package."""
    if axis_name is None:
        return LOCAL_CHAIN_AXIS
    names = axis_name if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)
    out = [LOCAL_CHAIN_AXIS]
    for n in names:
        if n not in out:
            out.append(n)
    return out[0] if len(out) == 1 else tuple(out)


def _local_leaf(x, rows, n):
    if torch.is_tensor(x) and x.ndim > 0 and x.shape[0] == n:
        return x[rows]
    return x


def _global_leaf(mesh, x, local):
    if torch.is_tensor(x) and x.ndim > 0 and x.shape[0] == local:
        return mesh.gather_rows(x)
    return x


def _on_local_rows(fn, mesh, shared):
    """``run(*args)``: the leading chain dimension of every tensor in the
    arguments but the last ``shared`` cut to this rank's rows, ``fn`` called
    on them, and the rows of every rank gathered into each output tensor
    with this rank's row count. Other leaves pass as they are."""
    def run(*args):
        split = len(args) - shared
        leaves, spec = tree_flatten(args[:split])
        n = next(x.shape[0] for x in leaves if torch.is_tensor(x)
                 and x.ndim > 0)
        rows = mesh.local_rows(n)
        local = rows.stop - rows.start
        local_args = tree_unflatten([_local_leaf(x, rows, n)
                                     for x in leaves], spec)
        out, out_spec = tree_flatten(fn(*local_args, *args[split:]))
        return tree_unflatten([_global_leaf(mesh, x, local) for x in out],
                              out_spec)
    return run


def _mesh_of(devices, mesh, axis_name=CHAIN_AXIS):
    if axis_name is not None and not isinstance(axis_name, (str, tuple)):
        raise TypeError(f"axis_name must be a name, got {axis_name!r}: "
                        "pass a mesh as mesh=")
    if mesh is not None:
        return make_mesh(mesh)
    return make_mesh(devices, axis_name or CHAIN_AXIS)


def shard_chain_fn(chain_fn: Callable, axis_name: Optional[str] = None,
                   devices: Optional[Sequence] = None,
                   mesh: Optional[ChainMesh] = None) -> Callable:
    """Lift a batched chain function to the ranks (cf. the JAX package's
    ``shard_chain_fn``, whose parameters it takes): ``chain_fn(*args)``
    takes tensors with a leading chain dimension and returns a pytree of
    them; the returned ``run(*args)`` takes the global chains, runs
    ``chain_fn`` on this rank's rows, and returns the rows of every rank,
    in rank order. The chain count must be a multiple of the rank count.
    ``mesh``, else ``make_mesh(devices, axis_name)``, gives the ranks."""
    return _on_local_rows(chain_fn, _mesh_of(devices, mesh, axis_name),
                          shared=0)


def shard_block_fn(chain_block: Callable,
                   devices: Optional[Sequence] = None,
                   mesh: Optional[ChainMesh] = None) -> Callable:
    """Lift a block function to the ranks (cf. the JAX package's
    ``shard_block_fn``, whose parameters it takes): ``chain_block(carry,
    idxs) -> (carry, outputs)`` advances a batch of chains by ``len(idxs)``
    draws; ``carry`` and the outputs have a leading chain dimension,
    ``idxs`` is shared. The returned ``run(carry, idxs)`` takes the global
    carry and returns the global carry and outputs; each rank runs its own
    rows. ``mesh``, else ``make_mesh(devices)``, gives the ranks."""
    return _on_local_rows(chain_block, _mesh_of(devices, mesh), shared=1)


class GlobalNoise:
    """A stepper's random numbers for rows ``rows`` of ``chains`` global
    chains: every draw is made for all of them by an
    ``arraystep.GeneratorNoise`` on ``generator`` and this rank's rows kept,
    so ranks that share a seed consume the numbers one process over every
    chain would (the check that a sharded transition equals the one-process
    one). Every draw method of ``GeneratorNoise`` but ``minibatch``."""

    def __init__(self, generator, chains, device, rows=None):
        from ..step_methods.arraystep import GeneratorNoise
        self._all = GeneratorNoise(generator, chains, device)
        self.rows = rows if rows is not None else slice(0, chains)
        self.chains = self.rows.stop - self.rows.start
        self.device = device

    def __getattr__(self, name):
        draw = getattr(self._all, name)
        return lambda *args: draw(*args)[self.rows]

    def depth(self, depth, n_take):
        u_dir, u_swap, u_take = self._all.depth(depth, n_take)
        return u_dir[self.rows], u_swap[self.rows], u_take[:, self.rows]


# ---------------------------------------------------------------------------
# Launching ranks and failure detection (cf. the JAX package's
# ``RemoteWorkerError``/``install_worker_excepthook``/``terminate_workers``
# and ``scripts/multihost_sim.py``'s parent)
# ---------------------------------------------------------------------------
class RemoteWorkerError(RuntimeError):
    """A rank's process died: carries the rank and its output, the
    rank-attributed traceback included."""

    def __init__(self, rank, message):
        super().__init__(f"worker process rank {rank} failed:\n{message}")
        self.rank = rank


_FAILED_MARK = "worker failed at "


def install_worker_excepthook(rank: int):
    """Make an uncaught exception print a rank-attributed traceback, with
    the time it happened, and exit at once with code 1. A rank that waited
    in exit handlers while the others wait in a collective would hang."""

    def hook(exc_type, exc, tb):
        formatted = "".join(traceback.format_exception(exc_type, exc, tb))
        sys.stdout.flush()
        sys.stderr.write(f"[rank {rank}] {_FAILED_MARK}{time.time():.6f}:\n"
                         f"{formatted}")
        sys.stderr.flush()
        os._exit(1)

    sys.excepthook = hook


def _exit_with_parent(parent_pid, every=1.0):
    """Exit this rank as soon as its launcher has gone (it was killed
    before it could stop its ranks): a daemon thread compares the parent's
    process id with ``parent_pid`` every ``every`` seconds."""
    import threading

    def watch():
        while os.getppid() == parent_pid:
            time.sleep(every)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def terminate_workers(procs, patience: float = 5.0):
    """Stop the remaining processes after one died: ``patience`` seconds to
    exit on their own, then SIGTERM, then SIGKILL after two more."""
    deadline = time.time() + patience
    for p in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + 2.0
    for p in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        if p.poll() is None:
            p.kill()
            p.wait()


def _failed_at(text):
    """The time a rank's excepthook printed, or ``inf``."""
    at = text.find(_FAILED_MARK)
    if at < 0:
        return float("inf")
    try:
        return float(text[at + len(_FAILED_MARK):].split(":", 1)[0])
    except ValueError:
        return float("inf")


def launch(argv, nprocs, devices=None, backend=None, timeout=600.0,
           env=None, cwd=None, patience=5.0):
    """Run ``python *argv`` as ``nprocs`` ranks of one process group and
    return each rank's standard output, in rank order.

    Each rank is a fresh ``subprocess`` of ``sys.executable`` (never a fork
    of a process that may hold CUDA), told its rank, the world size, its
    device (``devices[rank]``, default ``cuda:rank``) and ``backend``
    through the environment; it calls :func:`initialize_distributed`. The
    group meets through a ``file://`` store in a fresh temporary directory,
    so no port is taken. When a rank exits non-zero, the others get
    ``patience`` seconds and are then terminated, and
    :class:`RemoteWorkerError` names the rank that failed first, with its
    output. Past ``timeout`` seconds every rank is killed and
    ``TimeoutError`` raised. A rank exits by itself when the launching
    process is gone."""
    tmp = tempfile.mkdtemp(prefix="ranks_")
    procs, files = [], []
    try:
        for rank in range(nprocs):
            e = dict(os.environ if env is None else env)
            e.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                     LOCAL_RANK=str(rank), PYTHONUNBUFFERED="1")
            e[INIT_ENV] = "file://" + os.path.join(tmp, "store")
            e[PARENT_ENV] = str(os.getpid())
            e[DEVICE_ENV] = str(devices[rank]) if devices else f"cuda:{rank}"
            if backend:
                e[BACKEND_ENV] = backend
            out = open(os.path.join(tmp, f"{rank}.out"), "w+")
            err = open(os.path.join(tmp, f"{rank}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *argv], env=e,
                                          cwd=cwd, stdout=out, stderr=err))
        deadline = time.time() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs):
                time.sleep(0.2)   # let a rank that failed first write
                terminate_workers(procs, patience)
                texts = [_read(*f) for f in files]
                failed = [r for r, p in enumerate(procs) if p.returncode]
                first = min(failed, key=lambda r: (_failed_at(texts[r]), r))
                raise RemoteWorkerError(
                    first, f"exit {procs[first].returncode}\n{texts[first]}")
            if all(rc == 0 for rc in rcs):
                return [_read(out, None) for out, _ in files]
            if time.time() > deadline:
                terminate_workers(procs, 0.0)
                raise TimeoutError(
                    f"{nprocs} ranks of {argv} ran past {timeout} s:\n"
                    + "\n".join(_read(*f)[-4000:] for f in files))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _read(out, err):
    out.seek(0)
    text = out.read()
    if err is not None:
        err.seek(0)
        text += err.read()
    return text
