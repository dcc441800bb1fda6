"""The paper's workload generator: a gauge field and a source."""

from __future__ import annotations

import torch

from repro_torch.core import lattice as lat


def lattice_problem(shape: lat.LatticeShape, *, mass: float = 0.1,
                    seed: int = 0, packed: bool = True, device="cuda"):
    """(gauge, source) for D x = b, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (gauge first, then source).

    ``mass`` is unused, as in the JAX package's generator: the problem
    does not depend on it.  ``packed`` returns the packed real layouts.
    """
    gen = torch.Generator(device=lat.resolve_device(device))
    gen.manual_seed(seed)
    u = lat.random_gauge(gen, shape)
    b = lat.random_spinor(gen, shape)
    if packed:
        return lat.pack_gauge(u), lat.pack_spinor(b)
    return u, b
