"""The paths mesh: a ``torch.distributed`` process group over the path axis.

Counterpart of ``stock_market_monte_carlo_tpu/parallel/mesh.py``. The JAX
package's mesh is a list of devices in one process (``jax.distributed``
across hosts); torch's idiom is one process per device, so the port's
mesh is a process group whose ranks each run their shard of every
dispatch on their own device: NCCL between cards, gloo on the CPU (or
between processes that share one card). Every rank calls the engine with
the same arguments and gets the same result (SPMD).

The engine exchanges each dispatch's per-rank chunk rows (a float32 stats
row and histogram, ~16 KB at 4096 cells) with one all-gather and merges
them on the host in rank order, which is global chunk order; the band
counts are all-reduced as int64 sums. Where an exchange runs follows the
group's backend, which only this module reads: an NCCL group exchanges
the device tensors on the cards right after the launch, and the engine
copies the result; a gloo group exchanges the host copies once they are
done. The engine calls ``start_gather`` (``start_sum``) before its copy
and ``finish_gather`` (``finish_sum``) after it, and each does its half.

    import torch.distributed as dist
    dist.init_process_group("nccl", ...)        # torchrun sets the env
    mesh = paths_mesh()                          # every rank of the group
    smt.simulate_stats(model, n, t, mesh=mesh)   # on every rank
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

def device_count() -> int:
    """Ranks a mesh can span: the default process group's world size, 1
    without one (the process itself)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


@dataclasses.dataclass(frozen=True)
class PathsMesh:
    """A 1-D mesh of ``size`` ranks over the path axis.

    ``group`` is the process group (None: the default group), ``rank``
    this process's rank in it and ``device`` the device its shards run on.
    A process outside the group (``paths_mesh`` with fewer ranks than the
    world) holds a mesh with ``rank`` -1, which raises when used."""

    group: Any
    rank: int
    size: int
    device: torch.device

    def check_member(self) -> None:
        """Raise in a process that is not one of the mesh's ranks."""
        if self.rank < 0:
            raise RuntimeError(
                f"this process is not a rank of the {self.size}-rank paths "
                "mesh (paths_mesh spans the group's first ranks); only its "
                "ranks may run on it")

    def check_device(self, device: torch.device) -> None:
        """Raise unless ``device`` (an engine's ``options.device``) is the
        mesh's device: a mesh never moves work to another device."""
        self.check_member()
        if _normalized(device) != _normalized(self.device):
            raise ValueError(
                f"the paths mesh runs rank {self.rank} on {self.device}, "
                f"but EngineOptions(device={str(device)!r}); pass the "
                "mesh's device")

    @functools.cached_property
    def _on_cards(self) -> bool:
        """Whether the group exchanges device tensors on the cards (NCCL)
        rather than host copies (gloo)."""
        self.check_member()
        on_cards = str(dist.get_backend(self.group)) == "nccl"
        if on_cards and torch.device(self.device).type != "cuda":
            raise ValueError(
                f"an NCCL paths mesh runs on the cards, not on "
                f"{self.device}; use gloo on the CPU")
        return on_cards

    def start_gather(self, x: torch.Tensor) -> torch.Tensor:
        """A gather's first half, on this rank's device tensor ``x`` right
        after its launch: on the cards every rank's ``x`` stacked in rank
        order; else ``x`` as it is. Copy the result to the host, then
        ``finish_gather`` it."""
        return self._gather(x) if self._on_cards else x

    def finish_gather(self, host: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape) on the host: ``start_gather``'s result once
        copied, gathered here where the group exchanges host copies."""
        return host if self._on_cards else self._gather(host)

    def start_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``start_gather``'s twin for the int64 sum of every rank's
        integer ``x``."""
        return self._sum(x) if self._on_cards else x

    def finish_sum(self, host: torch.Tensor) -> torch.Tensor:
        """``finish_gather``'s twin for the int64 sum."""
        return host if self._on_cards else self._sum(host)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's ``x``, stacked in rank order, on
        the host of every rank."""
        return self.finish_gather(self.start_gather(x.to(self.device)).cpu())

    def _gather(self, x):
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.stack(parts)

    def _sum(self, x):
        x = x.to(torch.int64, copy=True)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


def _normalized(device) -> torch.device:
    """``device`` with the current card's index where it names none, and
    the CPU without one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        return torch.device("cpu")
    return device


def _nccl_device() -> torch.device:
    """cuda:LOCAL_RANK, or the global rank modulo the visible cards; made
    the current card, as NCCL's collectives need."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "an NCCL paths mesh needs a CUDA device and torch finds none; "
            "use the gloo backend on the CPU")
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else dist.get_rank() % torch.cuda.device_count())
    device = torch.device("cuda", index)
    torch.cuda.set_device(device)
    return device


def paths_mesh(n_devices: Optional[int] = None, group=None,
               device=None) -> Optional[PathsMesh]:
    """1-D mesh over the path axis of an initialized process group.

    - ``n_devices=None``: every rank of ``group`` (default: the world).
    - ``n_devices=1``: None, the engine's single-device path.
    - more ranks than the group has raises ``ValueError``; fewer builds a
      subgroup of its first ``n_devices`` ranks (``dist.new_group``, which
      every rank of the group must call); a rank outside it gets a mesh
      that raises when used.

    The device follows the backend: NCCL runs each rank on
    cuda:LOCAL_RANK (or its rank modulo the visible cards) and makes it
    the current card; gloo runs on ``device``, which the caller names
    (``"cpu"``, or ``"cuda"`` for processes that share one card). A
    ``device`` that disagrees with NCCL's raises.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "paths_mesh needs an initialized torch.distributed process "
            "group: call dist.init_process_group (NCCL on cards, gloo on "
            "the CPU) on every rank first")
    world = dist.get_world_size(group)
    if n_devices is None:
        n_devices = world
    if n_devices <= 0:
        raise ValueError(
            f"n_devices must be >= 1, got {n_devices} (the reference's "
            "cudaSetDevice would likewise reject it)")
    if n_devices > world:
        raise ValueError(
            f"requested {n_devices} devices, only {world} available (the "
            "process group's ranks)")
    if n_devices == 1:
        return None
    backend = str(dist.get_backend(group))
    if n_devices < world:
        ranks = [dist.get_global_rank(group, r) if group is not None else r
                 for r in range(n_devices)]
        group = dist.new_group(ranks=ranks, backend=backend)
    rank = dist.get_rank(group) if group is not None else dist.get_rank()
    if backend == "nccl":
        dev = _nccl_device() if rank >= 0 else torch.device("cuda")
        if device is not None and rank >= 0 and (
                _normalized(device) != dev):
            raise ValueError(
                f"an NCCL mesh runs rank {rank} on {dev}, not {device}")
    else:
        if device is None:
            raise ValueError(
                "a gloo paths mesh runs on the device its caller names: "
                "pass device='cpu' or device='cuda'")
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"paths_mesh(device={device!r}) but torch finds no CUDA "
                "device")
    return PathsMesh(group=group, rank=rank, size=n_devices, device=dev)
