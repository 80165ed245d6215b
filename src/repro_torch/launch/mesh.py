"""Device meshes over ``torch.distributed`` — counterpart of
``repro/launch/mesh.py``.

A :class:`Mesh` lays the ranks of an initialized process group out as a
grid with named axes (row-major: the last axis varies fastest), one
process and one device a rank, and holds one process group per set of
axes (``pod`` × ``data`` is the ciphertext and batch axes; a leaf split
over ``data`` and ``model`` reduces over both).  Every
rank runs the same program on the same inputs, as a JAX mesh's replicated
arguments; ``core/hlt_dist.py`` reads a rank's coordinates and groups.
A mesh refuses ranks that hash strings differently (a ``PYTHONHASHSEED``
that differs or is unset), since their sets of strings iterate in
different orders and their collectives would pair up across programs.

``make_mesh_for`` and ``make_production_mesh`` build a mesh over the
process group the caller initialized (they assert its world size, as the
reference asserts its device count): one that ``torchrun`` started
(:func:`init_from_env` reads its ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT``), or one of :func:`spawn`, which
starts the ranks on this host and initializes the group.

The backend is an argument, never a silent switch: ``"nccl"`` is the
default on ``cuda``, ``"gloo"`` on ``cpu``; ranks that share one card
need ``"gloo"`` (NCCL takes one rank a card, and the mesh refuses more).
The dry-run (``launch/dryrun.py``) builds the production meshes over
``"fake"``, a process group of one process that stands for every rank
and moves no data.
"""
from __future__ import annotations

import datetime
import itertools
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

#: the axes the HE schedule shards ciphertexts over (``ct_batch``)
CT_AXES = ("pod", "data")


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class Mesh:
    """The ranks of the initialized process group as a named grid.

    ``axis_names`` and ``shape`` (axis -> size) are what
    ``distributed/sharding.py`` reads; ``coords`` is this rank's position,
    ``device`` its device, ``group(axes)`` the process group of the ranks
    that differ from this one along ``axes`` only (its ranks in
    row-major order of the mesh's axes)."""

    def __init__(self, shape, axis_names, *, device, backend: str):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs an initialized process group "
                               "(torch.distributed.init_process_group, or "
                               "launch.mesh.spawn)")
        world = dist.get_world_size()
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} has "
                             f"{int(np.prod(shape))} ranks, the process "
                             f"group {world}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            per_card = -(-world // max(1, torch.cuda.device_count()))
            if backend == "nccl" and per_card > 1:
                raise ValueError(
                    f"{world} ranks on {torch.cuda.device_count()} card(s): "
                    f"NCCL takes one rank a card; pass backend=\"gloo\" for "
                    f"ranks that share one")
            if self.device.index is None:
                self.device = torch.device(
                    "cuda", dist.get_rank() % torch.cuda.device_count())
        if backend != "fake":   # one process stands for every fake rank
            _check_string_hashes(self.device, world)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.backend = backend
        self.rank = dist.get_rank()
        self.ranks = np.arange(world).reshape(shape)
        self.coords = dict(zip(axis_names,
                               (int(c) for c in np.unravel_index(self.rank,
                                                                 shape))))
        self._groups: dict = {}
        # every rank creates every group, in the same order, as
        # torch.distributed requires: one a set of axes (a leaf split over
        # data and model reduces over both)
        for k in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, k):
                self._make_groups(axes)

    def _make_groups(self, axes: tuple) -> None:
        if self.size(axes) == 1:
            self._groups[axes] = None
            return
        moved = np.moveaxis(self.ranks, [self.axis_names.index(a)
                                         for a in axes],
                            list(range(-len(axes), 0)))
        for ranks in moved.reshape(-1, self.size(axes)):
            g = dist.new_group(sorted(int(r) for r in ranks),
                               backend=self.backend)
            if self.rank in ranks:
                self._groups[axes] = g

    def size(self, axes) -> int:
        """Ranks along ``axes`` (an axis name or a tuple; absent axes
        count 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def index(self, axes) -> int:
        """This rank's row-major position along ``axes`` (its rank in
        ``group(axes)``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape.get(a, 1) + self.coords.get(a, 0)
        return idx

    def group(self, axes):
        """The process group along ``axes`` (None when it holds one rank)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axis_names if a in axes)
        if self.size(axes) == 1:
            return None
        return self._groups[axes]


def _check_string_hashes(device, world: int) -> None:
    """Refuse ranks that hash strings differently.  The ranks of one
    program issue their collectives in one order only if they run their
    operations in one order, and code iterates sets of strings (the
    serving flush makes its tenants' sessions and programs so): that
    order is one only under one ``PYTHONHASHSEED``.  Every rank gathers
    every rank's hash of a fixed string, so all of them refuse together."""
    mine = torch.tensor([hash("repro_torch.launch.mesh")], dtype=torch.int64,
                        device=device)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    differ = [r for r, h in enumerate(every) if not torch.equal(h, mine)]
    if differ:
        raise RuntimeError(
            f"rank {dist.get_rank()} hashes strings unlike rank(s) {differ}: "
            f"the ranks would iterate sets of strings in different orders "
            f"and so issue their collectives in different orders; start "
            f"every rank with one PYTHONHASHSEED (launch.mesh.spawn does)")


def check_mesh(mesh):
    """``mesh`` itself when it is a :class:`Mesh` or None; anything else
    is refused by name."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r} is not a mesh: build one with "
                        f"repro_torch.launch.mesh.make_mesh_for")
    return mesh


def make_mesh_for(num_devices: int, model_parallel: int = 1,
                  axis_names=("data", "model"), device="cuda",
                  backend=None) -> Mesh:
    """A (num_devices // model_parallel) × model_parallel mesh over the
    initialized process group of ``num_devices`` ranks."""
    if num_devices % model_parallel:
        raise ValueError(f"{num_devices} ranks do not split into "
                         f"model_parallel={model_parallel}")
    backend = default_backend(device) if backend is None else backend
    return Mesh((num_devices // model_parallel, model_parallel), axis_names,
                device=device, backend=backend)


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         backend=None) -> Mesh:
    """16 × 16 = 256 ranks (data, model); (2, 16, 16) over (pod, data,
    model) when ``multi_pod`` (512).  Raises, naming the count, unless
    the initialized process group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(
            f"the {'multi-pod ' if multi_pod else ''}production mesh "
            f"{dict(zip(axes, shape))} needs {need} ranks; the process group "
            f"has {have} (start them with torchrun)")
    backend = default_backend(device) if backend is None else backend
    return Mesh(shape, axes, device=device, backend=backend)


def init_from_env(device, backend=None, timeout: float = 300.0) -> bool:
    """Initialize the default process group from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when it is set and no group is up; on ``cuda`` the
    rank takes card ``LOCAL_RANK``.  Returns whether a group is up."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    backend = default_backend(device) if backend is None else backend
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout))
    return True


# ---------------------------------------------------------------------------
# spawn: the ranks of one host
# ---------------------------------------------------------------------------


def _run_rank(rank: int, fn, world: int, device: str, backend: str,
              timeout: float, tmp: str, args: tuple) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(*args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device="cuda", backend=None,
          timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` on ``world`` ranks of this host, each a process
    with an initialized process group (``backend``, default
    :func:`default_backend`, over a ``file://`` store in a fresh temporary
    directory, on the loopback interface); returns each rank's return
    value, by rank.  ``fn`` must be importable by name (a module-level
    function).  The ranks share one ``PYTHONHASHSEED`` (the parent's, or
    0), as a :class:`Mesh` requires.  A collective that waits longer than
    ``timeout`` seconds
    fails its rank; when any rank raises, the others are stopped and the
    call raises."""
    backend = default_backend(device) if backend is None else backend
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    # one hash seed for all ranks: a Mesh refuses ranks that hash strings
    # differently
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = ("0" if seed in (None, "", "random")
                                    else seed)
    try:
        torch.multiprocessing.spawn(
            _run_rank, args=(fn, world, str(device), backend, float(timeout),
                             tmp, tuple(args)),
            nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        if seed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = seed
        shutil.rmtree(tmp, ignore_errors=True)

