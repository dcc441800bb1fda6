"""Meshes for the port's multi-device solves and data-parallel training.

    torchrun --nproc-per-node 4 -m repro_torch.launch.solve --mesh debug ...
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh debug ...

:func:`make_debug_mesh` is the counterpart of the JAX package's
``repro.launch.mesh.make_debug_mesh``: a :class:`Mesh` over the ranks of
this job.  :func:`make_production_mesh` is the counterpart of its
``make_production_mesh``: the paper-scale meshes (16 x 16 over ``data``
and ``model``, or two of them on a leading ``pod`` axis) as a shape
only, with no ranks and no process group, for the production dry-run
(:mod:`repro_torch.launch.dryrun_wilson`).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os

import torch
import torch.distributed as tdist

from repro_torch.core.distributed import Mesh
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
