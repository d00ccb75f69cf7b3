"""The device mesh over `torch.distributed` (the JAX package's
`launch/mesh.py` and `parallel/sharding.make_mesh`).

A mesh is a grid of ranks with axes ("data", "model"), or ("pod", "data",
"model") when pod > 1; rank r sits at ((pod * data_size + data) *
model_size + model).  `make_mesh` builds one process group for every set of
axes that spans more than one rank (the ranks that differ only along those
axes), on the backend the world was started with.  JAX's SPMD partitioner
has no counterpart: the model places its collectives itself
(`parallel/sharding.py`).

The backend: NCCL when each rank has a card of its own, gloo when ranks
share a card or run on the host (`choose_backend`).  NCCL refuses two
ranks on one card, so several ranks on the one H100 talk over gloo through
host memory (`parallel/comm.py` stages the tensors): their communication
times say nothing about NVLink.

`spawn` starts a world of processes on this host, each with its rank, its
device and the process group initialised; `init_from_env` joins the world
that `torchrun` describes.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing
import os
import socket
import sys
import time
import traceback
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..configs.base import MeshConfig


def production_mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    """16 x 16 (256 ranks) or 2 x 16 x 16 (512), as the JAX package's."""
    return MeshConfig(data=16, model=16, pod=2 if multi_pod else 1)


class Mesh:
    """Axis names, sizes and this rank's coordinates; `group(axes)` is the
    process group of the ranks that differ from this one only along `axes`
    (None where that is this rank alone).  A mesh without groups (`make_mesh`
    was not called) still answers the spec functions, which read only its
    axis names."""

    def __init__(self, mesh_cfg: MeshConfig, rank: int = 0, groups=None,
                 backend: Optional[str] = None):
        self.cfg = mesh_cfg
        self.axis_names: Tuple[str, ...] = (("pod", "data", "model") if mesh_cfg.pod > 1
                                            else ("data", "model"))
        self.shape: Dict[str, int] = {"pod": mesh_cfg.pod, "data": mesh_cfg.data,
                                      "model": mesh_cfg.model}
        self.rank = rank
        coords, rest = {}, rank
        for ax in reversed(("pod", "data", "model")):
            coords[ax], rest = rest % self.shape[ax], rest // self.shape[ax]
        self.coords = coords
        self._groups = groups or {}
        self.backend = backend

    @property
    def size(self) -> int:
        return self.cfg.num_devices

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes_of(axes))

    def index(self, axes) -> int:
        """This rank's position along `axes` (row-major over them)."""
        i = 0
        for a in _axes_of(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        key = frozenset(a for a in _axes_of(axes) if self.shape[a] > 1)
        return self._groups.get(key) if key else None

    def replica_group(self, axis: str, n: int):
        """The group of the n ranks along `axis` that share this rank's
        block of size n (coordinates c with c // n equal; every other axis
        fixed): the replicas of a KV head over `model`, made where the mesh
        was (`make_mesh(..., kv_rep=n)`).  None where n is 1 or the mesh has
        no groups; raise where it has groups but not this one."""
        if n <= 1 or not self._groups:
            return None
        if (axis, n) not in self._groups:
            raise ValueError(f"{self!r} has no replica group of {n} along {axis!r}: make the "
                             f"mesh with kv_rep={n}")
        return self._groups[(axis, n)]

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        g = self.group(self.axis_names)
        if g is not None:
            dist.barrier(group=g)

    def __repr__(self):
        dims = " x ".join(f"{a}={self.shape[a]}" for a in self.axis_names)
        return f"Mesh({dims}, rank {self.rank}, {self.backend or 'no groups'})"


def _axes_of(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _rank_of(coords: Dict[str, int], shape: Dict[str, int]) -> int:
    return (coords["pod"] * shape["data"] + coords["data"]) * shape["model"] + coords["model"]


def make_mesh(mesh_cfg: MeshConfig, ranks: Optional[Sequence[int]] = None,
              kv_rep: int = 1) -> Optional[Mesh]:
    """The mesh over the initialised world (or over the global `ranks` of
    it, in mesh order), whose size must be mesh_cfg.num_devices.  Every rank
    of the world calls it and makes every group, in one order, as
    `dist.new_group` requires; a rank outside `ranks` gets None.  `kv_rep`
    > 1 also makes the replica groups of that size along `model`
    (`Mesh.replica_group`; `sharding.kv_replication` of the model)."""
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    if len(ranks) != mesh_cfg.num_devices:
        raise ValueError(f"mesh {mesh_cfg.pod} x {mesh_cfg.data} x {mesh_cfg.model} needs "
                         f"{mesh_cfg.num_devices} ranks, not {len(ranks)}")
    me = dist.get_rank()
    shape = {"pod": mesh_cfg.pod, "data": mesh_cfg.data, "model": mesh_cfg.model}
    axes = [a for a in ("pod", "data", "model") if shape[a] > 1]
    groups = {}
    for n in range(1, len(axes) + 1):
        for span in itertools.combinations(axes, n):
            fixed = [a for a in ("pod", "data", "model") if a not in span]
            for at in itertools.product(*(range(shape[a]) for a in fixed)):
                members = sorted(ranks[_rank_of({**dict(zip(fixed, at)), **dict(zip(span, c))},
                                                shape)]
                                 for c in itertools.product(*(range(shape[a]) for a in span)))
                g = dist.group.WORLD if len(members) == world else dist.new_group(members)
                if me in members:
                    groups[frozenset(span)] = g
    if kv_rep > 1:
        for at in itertools.product(range(shape["pod"]), range(shape["data"]),
                                    range(shape["model"] // kv_rep)):
            members = sorted(ranks[_rank_of({"pod": at[0], "data": at[1],
                                             "model": at[2] * kv_rep + c}, shape)]
                             for c in range(kv_rep))
            g = dist.new_group(members)
            if me in members:
                groups[("model", kv_rep)] = g
    if me not in ranks:
        return None
    return Mesh(mesh_cfg, ranks.index(me), groups, dist.get_backend())


def virtual_mesh(mesh_cfg: MeshConfig, rank: int = 0, kv_rep: int = 1) -> Mesh:
    """A mesh of `mesh_cfg`'s shape seen from `rank`, whose groups
    (`kv_rep` as `make_mesh`'s) are `comm.VirtualGroup`s: each collective
    returns a tensor of the right shape and dtype without communicating
    (the dry run's trace of one rank's step on a mesh that does not
    exist)."""
    from ..parallel.comm import VirtualGroup
    mesh = Mesh(mesh_cfg, rank)
    axes = [a for a in ("pod", "data", "model") if mesh.shape[a] > 1]
    groups = {}
    for n in range(1, len(axes) + 1):
        for span in itertools.combinations(axes, n):
            groups[frozenset(span)] = VirtualGroup(mesh.axis_size(span), mesh.index(span))
    if kv_rep > 1:
        groups[("model", kv_rep)] = VirtualGroup(kv_rep, mesh.coords["model"] % kv_rep)
    mesh._groups, mesh.backend = groups, "virtual"
    return mesh


def choose_backend(world_size: int, device: torch.device) -> str:
    """NCCL when each rank has a card of its own; gloo when ranks share a
    card or run on the host."""
    if device.type == "cuda" and dist.is_nccl_available() \
            and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(rank: int, backend: str, device: torch.device) -> torch.device:
    """Rank's device: its own card under NCCL, the shared one otherwise."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank if backend == "nccl" else (device.index or 0))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, addr: str, backend: str, device: str,
                fn: Callable, args: tuple) -> None:
    try:
        dev = rank_device(rank, backend, torch.device(device))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=addr, rank=rank, world_size=world)
        try:
            fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def spawn(fn: Callable, world: int, args: tuple = (), *, device="cuda",
          timeout: Optional[float] = None) -> str:
    """Run fn(rank, world, device, *args) in `world` fresh processes with the
    process group initialised (tcp://127.0.0.1 at a free port); returns the
    backend.  The ranks run on the card unless `device="cpu"` is given.  `fn` must be importable by name.  Raises if any rank exits
    non-zero or the world outlives `timeout`; the other ranks are then
    stopped."""
    device = torch.device(device)
    backend = choose_backend(world, device)
    addr = f"tcp://127.0.0.1:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(r, world, addr, backend, str(device), fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        # poll all ranks: one that fails leaves the others blocked in a collective
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0]} exited with {procs[bad[0]].exitcode}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"the world of {world} ranks outlived {timeout} s")
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0]} exited with {procs[bad[0]].exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return backend


def init_from_env(device: torch.device) -> Tuple[int, int, torch.device]:
    """Join the world `torchrun` describes (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); returns (rank, world, this rank's device)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = choose_backend(world, device)
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(local, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=rank, world_size=world)
    return rank, world, dev
