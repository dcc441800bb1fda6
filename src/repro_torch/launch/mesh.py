"""Meshes for the port's multi-device solves and data-parallel training.

    torchrun --nproc-per-node 4 -m repro_torch.launch.solve --mesh debug ...
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh debug ...

:func:`make_debug_mesh` is the counterpart of the JAX package's
``repro.launch.mesh.make_debug_mesh``: a :class:`Mesh` over the ranks of
this job.  :func:`make_production_mesh` is the counterpart of its
``make_production_mesh``: the paper-scale meshes (16 x 16 over ``data``
and ``model``, or two of them on a leading ``pod`` axis) as a shape
only, with no ranks and no process group, for the production dry-runs
(:mod:`repro_torch.launch.dryrun_wilson`, :mod:`repro_torch.launch.dryrun`).
:class:`RecordingMesh` is such a shape with one rank's coordinates whose
collectives move nothing and are tallied as :class:`Mesh` tallies them:
the LM dry-run runs the port's mesh training step on it, on the meta
device, for a 256- or 512-rank mesh in one process.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core.distributed import Mesh, MeshAxes
from repro_torch.core.lattice import resolve_device

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and sizes without ranks: what the lattice
    decomposition (``distributed.lattice_specs``) reads of a mesh."""

    shape: dict
    axis_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


class RecordingMesh(MeshAxes):
    """A mesh of ``shape`` seen from the rank at ``coords`` (default: all
    0), with no process group, on the meta device: what
    ``make_train_step(..., mesh=)`` reads of a
    :class:`~repro_torch.core.distributed.Mesh` (``axis_names``,
    ``shape``, ``coords``, ``device``, ``axes_ranks``, ``coords_of``,
    ``psum``, ``all_gather``, ``reduce_scatter``) for a trace of one
    rank's step.  The
    coordinate math and the byte tally are ``Mesh``'s own
    (:class:`~repro_torch.core.distributed.MeshAxes`).

    ``psum`` returns a copy of its input, ``all_gather`` one copy of its
    input per rank of the group and ``reduce_scatter`` a copy of this
    rank's part: the buffers the transport would fill, with no values
    exchanged (on the meta device there are none).
    Each call is counted as ``Mesh`` counts it: ``counts[kind]`` calls and
    ``nbytes["<kind>/<dtype>"]`` the bytes passed in; ``jax_kinds`` maps
    each kind to the collective's name in XLA's HLO (``all-reduce``,
    ``all-gather``, ``reduce-scatter``)."""

    def __init__(self, shape: MeshShape, coords: dict | None = None):
        self.axis_names = tuple(shape.axis_names)
        self.shape = dict(shape.shape)
        self.world_size = shape.size
        self.coords = {a: int((coords or {}).get(a, 0))
                       for a in self.axis_names}
        self.rank = self.rank_at(self.coords)
        self.device = torch.device("meta")
        self.counts = collections.Counter()
        self.nbytes = collections.Counter()
        self.jax_kinds = {}
        self._lines = {}

    def axes_ranks(self, axes=None) -> list[int]:
        """The ranks that share this rank's coordinates on every axis but
        ``axes``, ascending: the group a collective over ``axes`` runs
        on."""
        axes = self._axes(axes)
        if axes not in self._lines:
            self._lines[axes] = sorted(
                self.rank_at({**self.coords, **dict(zip(axes, idx))})
                for idx in np.ndindex(*(self.shape[a] for a in axes)))
        return self._lines[axes]

    def _record(self, kind: str, jax_kind: str, t: torch.Tensor) -> None:
        self.counts[kind] += 1
        self._tally(kind, t)
        self.jax_kinds[kind] = jax_kind

    def psum(self, t: torch.Tensor, *, kind: str = "all_reduce",
             axes=None, op: str = "sum") -> torch.Tensor:
        self._axes(axes)
        self._record(kind, "all-reduce", t)
        return t.clone()

    def all_gather(self, t: torch.Tensor, *, kind: str = "all_gather",
                   axes=None) -> list[torch.Tensor]:
        n = len(self.axes_ranks(axes))
        self._record(kind, "all-gather", t)
        return [t.clone() for _ in range(n)]

    def reduce_scatter(self, t: torch.Tensor, *, axes, dim: int = 0,
                       kind: str = "reduce_scatter") -> torch.Tensor:
        ranks = self.axes_ranks(axes)
        self._record(kind, "reduce-scatter", t)
        return torch.chunk(t, len(ranks), dim=dim)[
            ranks.index(self.rank)].clone()


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 over (``data``, ``model``), or 2 x 16 x 16 with a leading
    ``pod`` axis: the JAX package's production meshes, as shapes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(dict(zip(axes, shape)), axes)


def pick_transport(device: torch.device, world_size: int) -> str:
    """NCCL when every rank can have a card of its own, else gloo (CPU
    ranks, or ranks sharing card 0 with halos staged through the host)."""
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), *, device="cuda",
                    backend: str | None = None,
                    timeout: datetime.timedelta = datetime.timedelta(
                        seconds=120)) -> Mesh:
    """A small mesh over the ranks of this job.

    Initialises the default process group from the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when none exists, and raises naming ``torchrun`` when
    that environment is missing.  ``backend``: the transport, "gloo" or
    "nccl"; None picks NCCL where ``torch.cuda.device_count()`` covers the
    ranks, else gloo (:func:`pick_transport`).  With NCCL rank r runs on
    card ``LOCAL_RANK``; with gloo on a CUDA device every rank shares card
    0.  ``timeout`` bounds every collective.
    """
    dev = resolve_device(device)
    if not tdist.is_initialized():
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                "make_debug_mesh: no process group and no torchrun "
                f"environment (missing {', '.join(missing)}); run under "
                "`torchrun --nproc-per-node N ...`")
        backend = backend or pick_transport(dev, int(os.environ["WORLD_SIZE"]))
        tdist.init_process_group(backend, init_method="env://",
                                 timeout=timeout)
    actual = tdist.get_backend()
    if backend is not None and backend != actual:
        raise ValueError(f"make_debug_mesh: backend {backend!r} asked for, "
                         f"but the process group runs {actual!r}")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", tdist.get_rank()))
        dev = torch.device("cuda", local if actual == "nccl" else 0)
        torch.cuda.set_device(dev)
    return Mesh(shape, axes, device=dev, transport=actual, timeout=timeout)
