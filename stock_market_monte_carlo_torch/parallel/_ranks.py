"""Run a function on every rank of a paths mesh of one host and collect
its results: the helper of the mesh tests and of ``chip_smoke.py``. A
deployment starts its ranks with ``torchrun`` instead.

    from stock_market_monte_carlo_torch.parallel._ranks import run_ranks
    results = run_ranks(2, "my_module:my_fn", {"n": 8192}, device="cpu")

spawns 2 processes (``torch.multiprocessing.spawn``, which hands them this
process's ``sys.path``). Each joins a gloo process group through a
``file://`` store in a temporary directory, builds ``paths_mesh`` on
``device``, calls
``my_fn(mesh, n=8192)`` and saves the dict of arrays it returns;
``run_ranks`` returns those dicts in rank order. A rank that fails fails
the call and ends the others; so does ``timeout``, which is the process
group's timeout too, so a rank blocked in a collective whose peer died
raises as well. Each rank runs torch on one CPU thread, set before it
imports its target: ranks spawned beside other busy processes (the test
workers) would otherwise each start one thread per core.

The gloo ranks may share one card (``device="cuda"``): the kernels run on
the card in every rank and only the exchange goes through the host. NCCL
ranks, one on each card, are started with ``torchrun``.
"""

from __future__ import annotations

import datetime
import importlib
import os
import tempfile
import time

import numpy as np


def _rank(rank, world, target, kwargs, store, device, timeout, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)

    from stock_market_monte_carlo_torch.parallel.mesh import paths_mesh

    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = paths_mesh(device=device)
        out = fn(mesh, **kwargs)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})


def run_ranks(world, target, kwargs=None, *, device, timeout=300.0):
    """[rank 0's dict, ..., rank world-1's dict] of ``target``
    (``"module:function"``) called as ``function(mesh, **kwargs)`` in
    ``world`` fresh processes, each on ``device`` (``"cuda"`` or
    ``"cpu"``), on one torch thread each."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_rank, args=(world, target, kwargs or {},
                                    os.path.join(tmp, "store"), device,
                                    timeout, tmp),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    alive = [r for r, p in enumerate(ctx.processes)
                             if p.is_alive()]
                    raise TimeoutError(
                        f"ranks {alive} of {world} still running after "
                        f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for rank in range(world):
            with np.load(os.path.join(tmp, f"rank{rank}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out
