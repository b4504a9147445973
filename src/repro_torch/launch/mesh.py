"""Device meshes over `torch.distributed` ranks: port of
`repro.launch.mesh`.

A JAX mesh lays devices of one process out on named axes; here each
device is a rank, one process. A `Mesh` holds the axis names and sizes,
the global ranks it spans (row-major), this process's rank and its
coordinate on each axis, and one process group per axis of size > 1
(the ranks that share every other coordinate, in coordinate order).
`all_gather` over an axis is the one collective the port builds on:
every cross-rank sum is an ordered sum over it
(`distributed.collectives.ordered_sum`), never an `all_reduce`, whose
order the backend picks.

Ranks are processes started by `RankPool` (or `spawn`, one task) with
the `spawn` start method, so no rank inherits the parent's JAX or CUDA
state. The backend follows the device and the card count:

- `gloo` for CPU tensors;
- `nccl` when every rank has a card of its own;
- `gloo` with each collective's tensors staged through host memory when
  ranks share a card (NCCL refuses two ranks on one device).

Outside a rank group (no process group initialised) the world is one
rank: `make_subset_mesh(1)` and `make_tp_mesh(1)` work and every
collective is the identity. `make_production_mesh` and `abstract_mesh`
come with the dry-run tools (ROADMAP Queue 1 item 15); a `Mesh` built
from axis names and sizes alone (`Mesh(("data", "model"), (16, 16))`)
serves the sharding rules, which read only its shape.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import queue as queue_lib
import socket
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")
# how long a rank waits in a collective for the others
COLLECTIVE_TIMEOUT_S = 600.0

# this process's place in a rank group (set by `init_rank`)
_RANK: dict = {"device": None, "backend": None, "staging": False}
_GROUPS: dict[tuple[int, ...], Any] = {}


@dataclasses.dataclass
class Mesh:
    """Named axes over ranks. `ranks` are the global ranks the mesh spans
    in row-major order of `sizes`; `rank` is this process's (None when
    it lies outside the mesh, or for a mesh that only carries a layout).
    `groups[axis]` is this rank's process group along `axis` (None for an
    axis of size 1)."""
    axis_names: tuple
    sizes: tuple
    ranks: tuple = ()
    rank: Optional[int] = None
    device: Optional[torch.device] = None
    backend: str = "none"
    staging: bool = False
    groups: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.axis_names = tuple(self.axis_names)
        self.sizes = tuple(int(s) for s in self.sizes)
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if not self.ranks:
            self.ranks = tuple(range(math.prod(self.sizes)))

    @property
    def shape(self) -> dict[str, int]:
        """axis name -> size, in axis order (jax `Mesh.shape`)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def member(self) -> bool:
        return self.rank is not None

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis."""
        idx = self.ranks.index(self.rank)
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = idx % n
            idx //= n
        return {a: out[a] for a in self.axis_names}

    def index(self, axes) -> int:
        """This rank's linear index over `axes` (an axis name or a tuple,
        the first the most significant), as a tiled spec entry splits a
        dimension."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        c, idx = self.coords, 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def all_gather(self, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
        """x from every rank along `axis`, in coordinate order; every rank
        passes the same shape and dtype. Pure data movement: the tensors
        cross as bytes, staged through host memory when ranks share a
        card."""
        n = self.shape.get(axis, 1)
        if n == 1:
            return [x]
        src = x.contiguous().reshape(-1).view(torch.uint8)
        if self.staging:
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=self.groups[axis])
        return [t.to(x.device).view(x.dtype).reshape(x.shape) for t in out]

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.groups.get("_all"))


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a rank group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device() -> torch.device:
    """The device this rank computes on (`init_rank` sets it); the CPU
    outside a rank group."""
    return _RANK["device"] or torch.device("cpu")


def _group(ranks: tuple[int, ...]):
    """The process group of `ranks`, made once per process. Every rank of
    the world makes every group, in the same order (torch's rule), which
    the SPMD mesh functions guarantee."""
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def _build(shape, axes, ranks: tuple[int, ...]) -> Mesh:
    shape = tuple(int(s) for s in shape)
    me, n_world = world()
    if len(ranks) > n_world:
        raise ValueError(f"requested {len(ranks)} ranks, the world has "
                         f"{n_world}")
    mesh = Mesh(tuple(axes), shape, ranks=ranks,
                rank=me if me in ranks else None, device=rank_device(),
                backend=_RANK["backend"] or "none",
                staging=bool(_RANK["staging"]))
    if n_world == 1:
        return mesh
    grid = torch.arange(len(ranks)).reshape(shape)
    for i, name in enumerate(mesh.axis_names):
        if shape[i] == 1:
            continue
        lines = grid.movedim(i, -1).reshape(-1, shape[i])
        for line in lines.tolist():
            g = _group(tuple(ranks[j] for j in line))
            if mesh.member and me in (ranks[j] for j in line):
                mesh.groups[name] = g
    if mesh.size > 1:
        g = _group(tuple(ranks))
        if mesh.member:
            mesh.groups["_all"] = g
    return mesh


def make_mesh(shape, axes) -> Mesh:
    """A mesh over every rank of the world (the axis product must equal
    the world size, as `jax.make_mesh` insists it covers every device)."""
    n = math.prod(int(s) for s in shape)
    if n != world()[1]:
        raise ValueError(f"mesh {tuple(shape)} covers {n} ranks, the world "
                         f"has {world()[1]}")
    return _build(shape, axes, tuple(range(n)))


def make_host_mesh() -> Mesh:
    """Whatever ranks exist: a (world, 1) data mesh."""
    return make_mesh((world()[1], 1), AXES)


def make_subset_mesh(n: int, axes=AXES) -> Mesh:
    """A (n, 1) mesh over the FIRST n ranks: data-parallel training. A
    1-rank mesh works in any process (the sequential reference)."""
    if n > world()[1]:
        raise ValueError(f"requested {n} devices, host has {world()[1]}")
    return _build((n, 1), axes, tuple(range(n)))


def make_tp_mesh(n: int, axes=AXES) -> Mesh:
    """A (1, n) mesh over the FIRST n ranks: `model` carries n, the
    tensor-parallel engine's layout."""
    if n > world()[1]:
        raise ValueError(f"requested {n} devices, host has {world()[1]}")
    return _build((1, n), axes, tuple(range(n)))


# ------------------------------------------------------------------ ranks
def choose_backend(world_size: int, device) -> tuple[str, bool]:
    """(backend, staging) for `world_size` ranks computing on `device`:
    gloo on the CPU, nccl when the cards cover the ranks one each, else
    gloo with host staging (ranks share a card)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo", False
    if dev.type != "cuda":
        raise ValueError(f"ranks compute on cpu or cuda, not {dev}")
    if torch.cuda.device_count() >= world_size:
        return "nccl", False
    return "gloo", True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world_size: int, device, port: int) -> None:
    """Join the rank group at tcp://localhost:`port` as `rank` of
    `world_size`, on the backend `choose_backend` picks for `device`."""
    backend, staging = choose_backend(world_size, device)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else
                           (dev.index or 0))
        torch.cuda.set_device(dev)
    _RANK.update(device=dev, backend=backend, staging=staging)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        **({"device_id": dev} if backend == "nccl" else {}))


def _worker(rank, world_size, device, port, inbox, outbox):
    try:
        # ranks share the host's cores: one intra-op thread each
        torch.set_num_threads(1)
        init_rank(rank, world_size, device, port)
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        return
    outbox.put((rank, True, "ready"))
    while True:
        task = inbox.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            outbox.put((rank, True, fn(*args, **kwargs)))
        except BaseException:
            outbox.put((rank, False, traceback.format_exc()))
    _GROUPS.clear()
    dist.destroy_process_group()


class RankPool:
    """`world` rank processes, started once with the `spawn` start method
    and kept for many tasks: `run(fn, *args)` calls fn(*args) on every
    rank (SPMD: each rank builds its mesh inside fn) and returns the
    results in rank order. fn must be importable without JAX (a function
    of `repro_torch` or of a module that imports only torch and
    repro_torch) and return picklable host values (numbers, numpy
    arrays), not tensors. A rank that raises ends the pool: `run` raises
    with its traceback and the other ranks, which may wait in a
    collective, are killed, as they are when no answer comes within
    TIMEOUT_S. Each rank runs one intra-op thread (ranks share the host's
    cores)."""

    TIMEOUT_S = 1800.0

    def __init__(self, world: int, device="cpu", *, verbose: bool = True):
        self.world = int(world)
        self.device = torch.device(device)
        self.backend, self.staging = choose_backend(self.world, device)
        if verbose:
            print(f"rank pool: {self.world} ranks on {self.device} over "
                  f"{self.backend}"
                  + (" (host-staged collectives: ranks share a card)"
                     if self.staging else ""), flush=True)
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        self._inboxes = [ctx.SimpleQueue() for _ in range(self.world)]
        self._outbox = ctx.Queue()
        self._procs = [ctx.Process(
            target=_worker, daemon=True,
            args=(r, self.world, str(device), port, self._inboxes[r],
                  self._outbox))
            for r in range(self.world)]
        for p in self._procs:
            p.start()
        self._collect()

    def _collect(self) -> list:
        results: dict[int, Any] = {}
        waited = 0.0
        while len(results) < self.world:
            try:
                rank, ok, value = self._outbox.get(timeout=5.0)
            except queue_lib.Empty:
                waited += 5.0
                dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                        if p.exitcode is not None]
                if dead or waited >= self.TIMEOUT_S:
                    self.close(kill=True)
                    raise RuntimeError(
                        f"rank pool: ranks exited (rank, exit code) {dead}"
                        if dead else f"rank pool: no answer in "
                        f"{self.TIMEOUT_S:.0f} s") from None
                continue
            if not ok:
                self.close(kill=True)
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        return [results[r] for r in range(self.world)]

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        """Start fn(*args, **kwargs) on every rank and return at once;
        `collect()` waits for its results. One task at a time: submit
        nothing else before collecting."""
        if not self._procs:
            raise RuntimeError("rank pool is closed")
        for box in self._inboxes:
            box.put((fn, args, kwargs))

    def collect(self) -> list:
        """The submitted task's results, in rank order."""
        return self._collect()

    def run(self, fn: Callable, *args, **kwargs) -> list:
        self.submit(fn, *args, **kwargs)
        return self._collect()

    def close(self, kill: bool = False) -> None:
        procs, self._procs = self._procs, []
        if not kill:
            for box in self._inboxes:
                box.put(None)
        for p in procs:
            if kill:
                p.kill()
            p.join(timeout=None if not kill else 10)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)


def spawn(fn: Callable, world: int, device="cpu", *args, **kwargs) -> list:
    """fn(*args, **kwargs) once on each of `world` fresh ranks (a
    `RankPool` for one task); the results in rank order."""
    with RankPool(world, device) as pool:
        return pool.run(fn, *args, **kwargs)


def in_ranks() -> bool:
    """Whether this process is a rank of a group (`RankPool`, `spawn`)."""
    return world()[1] > 1 or _RANK["backend"] is not None
