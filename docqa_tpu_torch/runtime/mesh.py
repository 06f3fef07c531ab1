"""The device mesh over ``torch.distributed``, counterpart of
``docqa_tpu/runtime/mesh.py``.

Execution model: one process per GPU, every rank running the same program
(SPMD, torchrun's model).  Every rank of a mesh builds the same engines from
the same weights and calls the same device-plane entry points with the same
arguments in the same order; each rank holds its shard, and the collectives
inside an entry point make its result whole on every rank.  That computes
what the reference's jit over a ``Mesh`` computes.  NCCL runs when the
mesh's device is CUDA, gloo when it is the CPU (the tests' worlds).

The mesh has the reference's axes, ``data`` (batch-axis data parallelism)
and ``model`` (tensor parallelism and the store's row shards), over
``init_device_mesh``.  Ranks are row-major, ``rank = d * n_model + m``, as
the reference's ``np.asarray(devices).reshape(data, model)`` orders its
devices.  Without a process group :func:`make_mesh` degenerates to (1, 1)
and no collective runs, as the reference's single chip shards nothing.

``COLLECTIVES`` counts every collective the port issues, keyed
``"<op>.<site>"`` (``all_reduce.decoder``, ``all_gather.logits``, ...), beside
the kernels' ``ops/_kernels.LAUNCHES``, so tests and the chip smoke can pin
each entry point's budget.  A collective over a group of one rank is never
issued and never counted.  A collective that fails or outlives the process
group's timeout raises; nothing continues on one rank.
"""

from __future__ import annotations

import os
import threading
from collections import Counter
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

from docqa_tpu_torch.config import MeshConfig
from docqa_tpu_torch.utils import resolve_device

# a collective that waits longer than this on a peer raises
DEFAULT_TIMEOUT = timedelta(minutes=5)

COLLECTIVES: Counter = Counter()
_COUNT_LOCK = threading.Lock()


def count_collective(op: str, site: str) -> None:
    with _COUNT_LOCK:
        COLLECTIVES[f"{op}.{site}"] += 1


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (its dtype) and return it."""
    if group_size(group) == 1:
        return t
    dist.all_reduce(t, group=group)
    count_collective("all_reduce", site)
    return t


def all_gather(t: torch.Tensor, group, site: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in group
    rank order."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    count_collective("all_gather", site)
    return torch.cat(parts, dim=dim)


def all_to_all(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """Chunk ``i`` of ``t``'s leading axis to group rank ``i``; returns the
    chunks received, in source rank order along the leading axis."""
    if group_size(group) == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    count_collective("all_to_all", site)
    return out


@dataclass(frozen=True)
class MeshContext:
    """A (data, model) mesh and this rank's place in it.  ``device_mesh`` is
    None only for the (1, 1) mesh of a process with no process group."""

    device_mesh: Optional[object]
    data_axis: str
    model_axis: str
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    device: torch.device

    @property
    def n_devices(self) -> int:
        return self.n_data * self.n_model

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.model_index

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None when
        there is no process group)."""
        if axis not in (self.data_axis, self.model_axis):
            raise ValueError(f"no mesh axis {axis!r} (axes {self.data_axis!r}, "
                             f"{self.model_axis!r})")
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    @property
    def model_group(self):
        return self.group(self.model_axis)

    @property
    def data_group(self):
        return self.group(self.data_axis)

    def axis_size(self, axis: str) -> int:
        if axis == self.data_axis:
            return self.n_data
        if axis == self.model_axis:
            return self.n_model
        raise ValueError(f"no mesh axis {axis!r}")

    def axis_index(self, axis: str) -> int:
        if axis == self.data_axis:
            return self.data_index
        if axis == self.model_axis:
            return self.model_index
        raise ValueError(f"no mesh axis {axis!r}")

    def data_lanes(self, b: int) -> slice:
        """This rank's rows of a batch of ``b`` split over the data axis
        (``b`` a multiple of ``n_data``)."""
        if b % self.n_data:
            raise ValueError(f"batch {b} not divisible by data={self.n_data}")
        per = b // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)


def _factor(n_devices: int, data: int, model: int) -> tuple[int, int]:
    if data == -1 and model == -1:
        return 1, n_devices
    if data == -1:
        if n_devices % model:
            raise ValueError(f"{n_devices} devices not divisible by model={model}")
        return n_devices // model, model
    if model == -1:
        if n_devices % data:
            raise ValueError(f"{n_devices} devices not divisible by data={data}")
        return data, n_devices // data
    if data * model != n_devices:
        raise ValueError(
            f"mesh {data}x{model} != device count {n_devices}"
        )
    return data, model


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def make_mesh(cfg: Optional[MeshConfig] = None, device=None) -> MeshContext:
    """The (data, model) mesh over the initialised world.  ``device``:
    ``"cuda"`` (this rank's card, ``cuda:{LOCAL_RANK}``, NCCL) or ``"cpu"``
    (gloo); None reads ``cfg.platform`` (``"cpu"``, else the card).  A CUDA
    device without a card raises.  With no process group the mesh is
    (1, 1) and issues no collective; a factorisation that does not fit
    the world raises ``ValueError``."""
    cfg = cfg or MeshConfig()
    if device is None:
        device = "cpu" if cfg.platform == "cpu" else "cuda"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank() if dist.is_initialized() else
                           torch.cuda.current_device())
    if not dist.is_initialized():
        _factor(1, cfg.data_parallel, cfg.model_parallel)  # raises as the reference's
        return MeshContext(None, cfg.data_axis, cfg.model_axis, 1, 1, 0, 0, dev)
    world = dist.get_world_size()
    data, model = _factor(world, cfg.data_parallel, cfg.model_parallel)
    from torch.distributed.device_mesh import init_device_mesh

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, (data, model),
                          mesh_dim_names=(cfg.data_axis, cfg.model_axis))
    rank = dist.get_rank()
    return MeshContext(dm, cfg.data_axis, cfg.model_axis, data, model,
                       rank // model, rank % model, dev)


def host_cpu_mesh(n_devices: int = 8, data: int = 1) -> MeshContext:
    """The (data, n / data) mesh over an ``n_devices``-rank gloo world on
    the CPU (the tests' worlds; :func:`multihost_init` with
    ``device="cpu"`` starts one)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise RuntimeError(
            f"need a world of {n_devices} ranks, have {world}; start one with "
            f"multihost_init(..., device='cpu')"
        )
    return make_mesh(
        MeshConfig(data_parallel=data, model_parallel=n_devices // data,
                   platform="cpu"),
        device="cpu",
    )


def multihost_init(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    local_rank: Optional[int] = None,
    device="cuda",
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the world: ``init_process_group`` from the arguments, or from
    torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  With neither it does
    nothing and returns False, so a process can call it unconditionally
    and stay alone.  NCCL for ``device="cuda"`` (each rank on
    ``cuda:{local_rank}``), gloo for ``"cpu"``; ``timeout`` bounds every
    collective's wait on a peer.  A CUDA device without a card raises.
    Returns True once the process is in a world (also when it already
    was)."""
    dev = resolve_device(device)
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = "env://"
    if init_method is None:
        return False
    if dist.is_initialized():
        return True
    world_size = int(world_size if world_size is not None else env["WORLD_SIZE"])
    rank = int(rank if rank is not None else env["RANK"])
    local_rank = int(local_rank if local_rank is not None
                     else env.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        os.environ.setdefault("LOCAL_RANK", str(local_rank))
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=world_size, rank=rank, timeout=timeout,
    )
    return True


def ranks_of(group) -> List[int]:
    """The global ranks of ``group`` in group rank order."""
    return [dist.get_global_rank(group, i) for i in range(group_size(group))]


def refuse_sharded(what: str, item: str, *meshes: Optional[MeshContext]) -> None:
    """Raise ``NotImplementedError`` when any of ``meshes`` spans more than
    one rank: ``what`` has no mesh path in this port yet, ``item`` names
    the ROADMAP item (queue 1) that brings it."""
    for mesh in meshes:
        if mesh is not None and mesh.n_devices > 1:
            raise NotImplementedError(
                f"not in the PyTorch port yet: {what} on a {mesh.n_data}x"
                f"{mesh.n_model} mesh ({item})"
            )
