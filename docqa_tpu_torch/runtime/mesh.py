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
issued and never counted.  The trainers' collectives go through autograd:
:func:`copy_to_group` (Megatron's *f*: nothing forward, an all-reduce of
the gradient backward), :func:`reduce_from_group` (*g*: an all-reduce
forward, the gradient as it is backward) and :func:`gather_from_group`
(an all-gather forward, backward this rank's slice of the summed
gradient).  Outside autograd each is the plain collective or nothing, so
serving issues what it issued before.  A collective that fails or outlives
the process group's timeout raises :class:`~docqa_tpu_torch.ops._kernels.MeshFault`
(a device fault: every serving catch-all lets it through), and the mesh is
broken from then on: every later collective and command raises at once.
That holds where a collective blocks until it is done: gloo, the CPU
worlds.  An NCCL collective returns once it is enqueued, and the port sets
neither blocking wait nor async error handling, so a peer lost during an
NCCL collective is seen by NCCL's watchdog, which ends the process after
the group's timeout: no ``MeshFault``, no 503.  A peer lost between
commands is seen at the next command's publish, which goes over gloo
(:class:`CommandStream`), and raises there.

A serving runtime (``service/app.py``) cannot be SPMD by itself: HTTP
requests reach one process, and device work starts on many threads (the
batchers' workers, ingest, warm-ups).  :class:`CommandStream` makes it so.
Rank 0, the leader, serves and decides one total order of device-plane
commands; every other rank, a follower, builds the same engines and runs
:meth:`CommandStream.follow`, which replays each command on its own objects
of the same name.  A command is a mirrored entry point (:func:`mirrored`):
a method that issues a collective or writes a sharded tensor, called with
the leader's host decisions as plain arguments (arrays, ids, seeds).  The
leader takes the mesh slot (one command at a time), publishes the command
(target, method, arguments, pickled over a gloo group made beside the
device group), then runs it, and releases the slot once its collectives are
issued.  Followers receive commands in that order, so every rank issues
every collective in one order.  A mirrored call made inside a command runs
where it is (every rank makes it inside the same outer command), and the
dispatch spine carries that context to its lane threads.  Before
:meth:`CommandStream.open` (the boot, where every rank runs the same code on
one thread) a command runs locally on every rank.  ``COMMANDS`` counts top-level
commands by name on every rank, and :func:`command_digest` hashes their
sequence: equal on every rank of a healthy mesh.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import Counter
from dataclasses import dataclass
from datetime import timedelta
from time import monotonic as _mono
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from docqa_tpu_torch.config import MeshConfig
from docqa_tpu_torch.ops._kernels import MeshFault, is_device_fault
from docqa_tpu_torch.runtime.metrics import get_logger
from docqa_tpu_torch.utils import resolve_device

log = get_logger("docqa.mesh")

# a collective that waits longer than this on a peer raises
DEFAULT_TIMEOUT = timedelta(minutes=5)

COLLECTIVES: Counter = Counter()
_COUNT_LOCK = threading.Lock()


# the first collective or command failure of this process: the mesh is
# broken from then on
_BROKEN: Optional[BaseException] = None


def count_collective(op: str, site: str) -> None:
    with _COUNT_LOCK:
        COLLECTIVES[f"{op}.{site}"] += 1


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _check_whole(what: str) -> None:
    if _BROKEN is not None:
        raise MeshFault(f"{what}: the mesh is broken ({_BROKEN})") from _BROKEN


def _collective(what: str, fn) -> None:
    """Run one collective (or a command's publish or receipt); a failure (a
    lost peer, a timeout) breaks the mesh and raises :class:`MeshFault`."""
    global _BROKEN
    _check_whole(what)
    try:
        fn()
    except Exception as e:
        if isinstance(e, MeshFault):
            raise
        fault = MeshFault(f"{what} failed: {type(e).__name__}: {e}")
        with _COUNT_LOCK:
            if _BROKEN is None:
                _BROKEN = fault
        raise fault from e


def all_reduce(t: torch.Tensor, group, site: str, op=None) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (its dtype; a sum unless ``op``
    names another ``dist.ReduceOp``) and return it."""
    if group_size(group) == 1:
        return t
    op = dist.ReduceOp.SUM if op is None else op
    _collective(f"all_reduce.{site}", lambda: dist.all_reduce(t, op=op, group=group))
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
    _collective(f"all_gather.{site}", lambda: dist.all_gather(parts, t, group=group))
    count_collective("all_gather", site)
    return torch.cat(parts, dim=dim)


def barrier(group, site: str) -> None:
    """Wait for every rank of ``group`` (a gloo group of host work)."""
    if group_size(group) == 1:
        return
    _collective(f"barrier.{site}", lambda: dist.barrier(group=group))
    count_collective("barrier", site)


def all_to_all(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """Chunk ``i`` of ``t``'s leading axis to group rank ``i``; returns the
    chunks received, in source rank order along the leading axis."""
    if group_size(group) == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    _collective(f"all_to_all.{site}",
                lambda: dist.all_to_all_single(out, t, group=group))
    count_collective("all_to_all", site)
    return out


def ring_exchange(tensors, group, site: str):
    """One ring round: each tensor to the next rank of ``group`` and the
    previous rank's received in its place (``ring_round.<site>``).  Returns
    the received tensors, in the order given."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    out = [torch.empty_like(t) for t in tensors]

    def exchange():
        ops = []
        for t, buf in zip(tensors, out):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
            ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _collective(f"ring_round.{site}", exchange)
    count_collective("ring_round", site)
    return out


# ---------------------------------------------------------------------------
# collectives under autograd (the trainers' Megatron operators)
# ---------------------------------------------------------------------------

def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToGroup(torch.autograd.Function):
    """Megatron's *f*: identity forward, gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group, site):
        ctx.group, ctx.site = group, site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        whole = grad.clone(memory_format=torch.contiguous_format)
        return all_reduce(whole, ctx.group, ctx.site), None, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's *g*: the sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group, site):
        return all_reduce(x.clone(), group, site)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward, this rank's slice of the
    gradient summed over the group (every rank's loss read every slice)."""

    @staticmethod
    def forward(ctx, x, group, site, dim):
        ctx.group, ctx.site, ctx.dim = group, site, dim
        ctx.size = x.shape[dim]
        return all_gather(x, group, site, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        whole = all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group,
                           ctx.site + "_grad")
        start = dist.get_rank(ctx.group) * ctx.size
        return whole.narrow(ctx.dim, start, ctx.size), None, None, None


def copy_to_group(x: torch.Tensor, group, site: str) -> torch.Tensor:
    """Megatron's *f* before a group of column-parallel products: ``x`` as
    it is forward (nothing issued); backward, one all-reduce of its
    gradient over ``group`` (``all_reduce.<site>``).  The identity on a
    group of one rank or outside autograd."""
    if group_size(group) == 1 or not _tracked(x):
        return x
    return _CopyToGroup.apply(x, group, site)


def reduce_from_group(x: torch.Tensor, group, site: str) -> torch.Tensor:
    """Megatron's *g* after a row-parallel product: ``x`` summed over
    ``group`` (``all_reduce.<site>``); backward, the gradient as it is.
    Outside autograd it is :func:`all_reduce` itself, in place; under
    autograd it reduces a copy."""
    if group_size(group) == 1:
        return x
    if not _tracked(x):
        return all_reduce(x, group, site)
    return _ReduceFromGroup.apply(x, group, site)


def gather_from_group(x: torch.Tensor, group, site: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` (``all_gather.<site>``)
    with a gradient path back: each rank receives its slice of the
    gradient summed over ``group`` (``all_reduce.<site>_grad``).  Every
    rank's ``x`` must have the same shape."""
    if group_size(group) == 1:
        return x
    if not _tracked(x):
        return all_gather(x, group, site, dim=dim)
    return _GatherFromGroup.apply(x, group, site, dim)


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


# ---------------------------------------------------------------------------
# the command stream (module docstring)
# ---------------------------------------------------------------------------

COMMANDS: Counter = Counter()
_DIGEST = hashlib.sha256()
_LOCAL = threading.local()
# the header group waits this long for the leader's next command: a
# follower idles in it between requests
HEADER_TIMEOUT = timedelta(days=7)
_STOP = "__stop__"


def command_digest() -> str:
    """Hex digest of the sequence of commands this process counted."""
    with _COUNT_LOCK:
        return _DIGEST.copy().hexdigest()


def reset_commands() -> None:
    """Zero ``COMMANDS`` and the digest (tests, measurement windows)."""
    global _DIGEST
    with _COUNT_LOCK:
        COMMANDS.clear()
        _DIGEST = hashlib.sha256()


def _count_command(name: str) -> None:
    with _COUNT_LOCK:
        COMMANDS[name] += 1
        _DIGEST.update(name.encode() + b"\n")


def in_command() -> bool:
    """True on a thread running inside a command (its own, a replayed one,
    or a spine item issued from one)."""
    return getattr(_LOCAL, "depth", 0) > 0


class command_scope:
    """Mark this thread as inside a command (``active``) for a block: the
    spine re-enters its submitter's scope on a lane thread."""

    def __init__(self, active: bool = True) -> None:
        self.active = active

    def __enter__(self):
        if self.active:
            _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        if self.active:
            _LOCAL.depth -= 1
        return False


def mirrored(obj: Any, method: str, fn: Callable, *args,
             local: Optional[Dict[str, Any]] = None,
             decide: Optional[Callable[[], Any]] = None, **kwargs) -> Any:
    """Run ``fn(*args, **kwargs, **local)`` as the command ``method`` of
    ``obj``: published to every follower first when ``obj`` is registered
    with a live :class:`CommandStream`, else run as it is.  ``args`` and
    ``kwargs`` are plain host values (they cross processes); ``local``
    holds what only the leader passes (a deadline).  On a follower the
    command arrives as ``getattr(obj, method)(*args, **kwargs)``, which
    reaches ``fn`` here.

    ``decide``: the leader's host decisions that must match the state at
    the command's place in the order (the tier a search reads, the nprobe
    an operator set on the leader).  When ``kwargs["plan"]`` is None the
    leader calls ``decide()`` under the mesh slot just before it publishes
    and passes the result as ``plan``, so a follower receives it; without
    a live stream, or inside a command, it is called in place."""
    stream = getattr(obj, "_command_stream", None)
    if stream is None:
        return fn(*args, **_planned(kwargs, decide), **(local or {}))
    return stream.call(obj, method, fn, args, kwargs, local or {}, decide)


def _planned(kwargs: Dict[str, Any], decide: Optional[Callable[[], Any]]) -> Dict[str, Any]:
    """``kwargs`` with its ``plan`` decided (:func:`mirrored`)."""
    if decide is None or kwargs.get("plan") is not None:
        return kwargs
    return {**kwargs, "plan": decide()}


class CommandStream:
    """The leader's ordered stream of device-plane commands and the
    followers' replay of it (module docstring).  Built on every rank at the
    same point of the boot (making its gloo group is a collective); in a
    world of one rank commands are counted and published to no one."""

    def __init__(self, mesh: MeshContext):
        self.mesh = mesh
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.leader = self.rank == 0
        self._group = (dist.new_group(backend="gloo", timeout=HEADER_TIMEOUT)
                       if self.world > 1 else None)
        self._targets: Dict[str, Any] = {}
        self._auto: Counter = Counter()
        self._slot = threading.Lock()
        self._live = False
        self._stopped = False
        self._stats_lock = threading.Lock()
        # per command: [count, seconds waited for the mesh slot]
        self._waits: Dict[str, List[float]] = {}

    @property
    def follower(self) -> bool:
        return not self.leader

    @property
    def live(self) -> bool:
        """Opened (:meth:`open`, or :meth:`follow` on a follower)."""
        return self._live

    # ---- targets -------------------------------------------------------------

    def register(self, name: str, obj: Any) -> Any:
        """Make ``obj`` the target ``name`` on this rank (every rank
        registers the same names in the same order)."""
        if name in self._targets:
            raise ValueError(f"command target {name!r} registered twice")
        obj._command_stream = self
        obj._command_name = name
        self._targets[name] = obj
        return obj

    def register_auto(self, prefix: str, obj: Any) -> Any:
        """Register ``obj`` as ``<prefix>#<n>``, ``n`` counting this
        prefix's registrations (the batchers: replicas and rebuilds)."""
        with self._stats_lock:
            n = self._auto[prefix]
            self._auto[prefix] += 1
        return self.register(f"{prefix}#{n}", obj)

    def unregister(self, obj: Any) -> None:
        self._targets.pop(getattr(obj, "_command_name", None), None)

    # ---- the leader's side ---------------------------------------------------

    def open(self) -> "CommandStream":
        """End of the boot: from here the leader publishes its commands and
        followers take them in :meth:`follow`."""
        self._live = True
        return self

    def _check(self, what: str) -> None:
        _check_whole(what)
        if self._stopped:
            raise MeshFault(f"{what}: the command stream is stopped")

    def _publish(self, header: Tuple) -> None:
        what = f"publish {header[0]}.{header[1]}" if header[0] != _STOP else "publish stop"
        _collective(what, lambda: dist.broadcast_object_list(
            [header], src=0, group=self._group))

    def call(self, obj: Any, method: str, fn: Callable, args: tuple,
             kwargs: Dict[str, Any], local: Dict[str, Any],
             decide: Optional[Callable[[], Any]] = None) -> Any:
        """:func:`mirrored`'s dispatch (module docstring)."""
        if in_command():
            return fn(*args, **_planned(kwargs, decide), **local)
        name = f"{obj._command_name}.{method}"
        if not self._live:
            # the boot: every rank runs the same code on one thread
            _count_command(name)
            with command_scope():
                return fn(*args, **_planned(kwargs, decide), **local)
        if self.follower:
            raise RuntimeError(
                f"{name}: a follower runs commands only from follow()")
        t0 = _mono()
        with self._slot:
            waited = _mono() - t0
            self._check(name)
            if self._targets.get(obj._command_name) is not obj:
                # unregistered since (a superseded tier): a follower could
                # not resolve it
                raise RuntimeError(f"{name}: the target is no longer registered")
            kwargs = _planned(kwargs, decide)
            if self.world > 1:
                self._publish((obj._command_name, method, args, kwargs))
            _count_command(name)
            with self._stats_lock:
                row = self._waits.setdefault(name, [0, 0.0, 0.0])
                row[0] += 1
                row[1] += waited
                row[2] = max(row[2], waited)
            with command_scope():
                return fn(*args, **kwargs, **local)

    def stop(self) -> None:
        """Publish ``stop`` (the leader; followers leave :meth:`follow`)
        and refuse every later command.  A broken mesh publishes nothing."""
        if self._stopped:
            return
        with self._slot:
            self._stopped = True
            if self.leader and self.world > 1 and self._live and _BROKEN is None:
                try:
                    self._publish((_STOP, "", (), {}))
                except MeshFault:
                    log.exception("stop not published: the mesh is broken")

    # ---- the followers' side -------------------------------------------------

    def follow(self) -> int:
        """Replay the leader's commands until it publishes ``stop``; returns
        the commands replayed.  A command that raises what the leader's run
        raised too (a host error) is logged and the replay goes on; a
        device fault (a kernel, CUDA, a lost rank) raises."""
        if not self.follower:
            raise RuntimeError("the leader does not follow")
        self._live = True
        n = 0
        while True:
            box = [None]
            _collective("receive a command", lambda: dist.broadcast_object_list(
                box, src=0, group=self._group))
            target, method, args, kwargs = box[0]
            if target == _STOP:
                self._stopped = True
                return n
            _count_command(f"{target}.{method}")
            n += 1
            obj = self._targets[target]
            with command_scope():
                try:
                    getattr(obj, method)(*args, **kwargs)
                except Exception as e:
                    if is_device_fault(e):
                        raise
                    log.warning("command %s.%s raised %r (the leader's run "
                                "raised it too)", target, method, e)

    # ---- observability -------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the per-command slot waits (measurement windows)."""
        with self._stats_lock:
            self._waits.clear()

    def status(self) -> Dict[str, Any]:
        """The ``/api/status`` mesh section: shape, backend, ranks, role,
        and the commands counted with their mean and longest wait for the
        mesh slot."""
        with self._stats_lock:
            waits = {
                k: {"count": int(c), "slot_wait_mean_ms": round(w / max(c, 1) * 1e3, 3),
                    "slot_wait_max_ms": round(top * 1e3, 3)}
                for k, (c, w, top) in sorted(self._waits.items())
            }
        with _COUNT_LOCK:
            issued = int(sum(COMMANDS.values()))
        return {
            "shape": [self.mesh.n_data, self.mesh.n_model],
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "ranks": self.world,
            "rank": self.rank,
            "role": "leader" if self.leader else "follower",
            "commands_issued": issued,
            "commands": waits,
            "broken": None if _BROKEN is None else str(_BROKEN),
        }
