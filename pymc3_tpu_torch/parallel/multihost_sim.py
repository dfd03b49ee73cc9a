"""Several CPU ranks of one ``torch.distributed`` group running a pooled
NUTS block (cf. the JAX package's ``scripts/multihost_sim.py``).

Run ``python -m pymc3_tpu_torch.parallel.multihost_sim``. The parent starts
``MULTIHOST_NPROC`` ranks (2 by default) through :func:`parallel.launch`
under gloo on the CPU. Each joins the group with
``parallel.initialize_distributed``, samples its rows of ``2 x ranks``
chains through ``shard_block_fn`` with pooled adaptation over every rank,
in two blocks, and checks that the step size and the mass matrix are equal
on every chain of every rank. The parent prints each rank's output and
``MULTIHOST SIM OK`` when all succeed. With ``MULTIHOST_FAIL_RANK=r``, rank
``r`` raises between the two blocks: the parent terminates the others,
prints ``MULTIHOST SIM FAILED: worker process rank r died ...`` with that
rank's traceback, and exits 1.
"""
import os
import sys

N_PROC = int(os.environ.get("MULTIHOST_NPROC", 2))
FAIL_RANK = os.environ.get("MULTIHOST_FAIL_RANK")


def parent():
    from . import RemoteWorkerError, launch
    try:
        outs = launch(["-m", "pymc3_tpu_torch.parallel.multihost_sim",
                       "--rank"], N_PROC, devices=["cpu"] * N_PROC,
                      backend="gloo", timeout=600)
    except RemoteWorkerError as e:
        print(str(e))
        print(f"MULTIHOST SIM FAILED: worker process rank {e.rank} died; "
              "surviving workers terminated", flush=True)
        sys.exit(1)
    for rank, out in enumerate(outs):
        print(f"--- rank {rank} ---\n{out}")
    print("MULTIHOST SIM OK", flush=True)


def child():
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import pymc3_tpu_torch as pm
    from . import (CHAIN_AXIS, initialize_distributed, pooled_axes,
                    shard_block_fn)
    from ..step_methods.arraystep import GeneratorNoise, TuneContext

    mesh = initialize_distributed()
    rank, world = mesh.rank, mesh.world_size
    print(f"rank {rank}: {world} ranks, device {mesh.device}, backend "
          f"{mesh.backend}", flush=True)

    rng = np.random.default_rng(0)
    y = rng.normal(size=16).astype(np.float32)
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 5.0)
        sigma = pm.HalfNormal("sigma", 2.0)
        pm.Normal("y", mu=mu, sigma=sigma, observed=y)

    step = pm.NUTS(model=model, axis_name=pooled_axes(CHAIN_AXIS))
    step.mesh = mesh
    chains, tune, draws = 2 * world, 4, 4
    q0 = torch.as_tensor(model.dict_to_array(model.test_point),
                         device=mesh.device)
    Q0 = q0.expand(chains, -1).clone()
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(1000 + rank)
    noise = GeneratorNoise(gen, chains // world, mesh.device)

    def chain_block(carry, idxs):
        q, st = carry
        qs, eps = [], []
        for idx in idxs:
            q, st, stats = step.kernel_step(
                q, st, TuneContext(idx < tune, idx, tune), noise)
            qs.append(q)
            eps.append(stats["step_size_bar"])
        return (q, st), (torch.stack(qs, 1), torch.stack(eps, 1))

    run = shard_block_fn(chain_block, mesh=mesh)
    carry = (Q0, step.kernel_init(Q0))
    half = (tune + draws) // 2
    carry, (qs_a, eps_a) = run(carry, range(half))
    if FAIL_RANK is not None and rank == int(FAIL_RANK):
        raise RuntimeError(
            f"injected mid-block failure on rank {rank} (test fixture)")
    carry, (qs_b, eps_b) = run(carry, range(half, tune + draws))
    qs = torch.cat([qs_a, qs_b], 1)
    eps = torch.cat([eps_a, eps_b], 1)
    if qs.shape != (chains, tune + draws, q0.shape[0]):
        raise RuntimeError(f"draws of shape {tuple(qs.shape)}")
    if not bool(torch.isfinite(qs).all()):
        raise RuntimeError("non-finite draws")
    # pooled dual averaging and mass matrix: one value on every chain of
    # every rank, to the bit
    var = carry[1].pot.var
    for name, x in (("eps bar", eps[:, -1]), ("mass matrix", var)):
        lo, hi = mesh.min(x.min(0).values), mesh.max(x.max(0).values)
        if not bool((lo == hi).all()):
            raise RuntimeError(f"{name} not pooled across ranks: "
                               f"{lo.tolist()} != {hi.tolist()}")
    print(f"rank {rank}: sharded NUTS block ok; pooled eps = "
          f"{float(eps[0, -1]):.5f}; mass diagonal "
          f"{var[0].tolist()}", flush=True)


if __name__ == "__main__":
    if "--rank" in sys.argv[1:]:
        child()
    else:
        parent()
