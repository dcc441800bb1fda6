"""The launch space of the Wilson kernels: which tile K1 (``wilson_hop``)
and K4 (``wilson_full``) run at a shape, and the tuning cache that holds
the card's sweep of it.

The counterpart of the JAX package's ``repro.kernels.dispatch``, written
for the port's knobs:

* ``b``: the rows of Y a block owns and stages (K1 and K4).  ``None`` is
  the heuristic of :func:`..wilson_dslash.kernel.hop_tile_plan` /
  ``full_tile_plan``; ``0`` reads the rows in place, staging nothing.
* ``tchunk``: the t planes a chunk of K4's block order takes before z
  (1, 2, 4 or 8, dividing T); ``None`` is the rule K4 had built in: 4
  with more than one right-hand side and T a multiple of 4, else 1.  K1
  has no such knob and ignores it.

The TPU kernels' ``bz`` (z planes a block), ``batch`` (where the RHS axis
rides the grid) and ``stream`` (the gauge field's VMEM pipeline) have no
counterpart here: a K1/K4 block is one (t, z) row of y-tiles, every
right-hand side loops inside the block over the staged links, and the
links are always staged once by TMA (or read in place at ``b = 0``).

A tile changes data movement only, never the order of any site's
operations, so every tile gives the same bits (held on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 10): the cache
can change speed, not results.  A tile the kernel cannot take (shared
memory, T, the bf16 pair instance's staging) raises in the wrapper,
before the launch.

:func:`pick_tile` resolves a launch's tile: the environment override,
else a cache hit, else :data:`DEFAULT_TILE`.  A cold or disabled cache
gives exactly the plans the kernels ran before the launch space existed.
The environment is read at every launch:

* ``REPRO_TORCH_TUNING_CACHE=0`` (or ``off``): no cache lookups;
* ``REPRO_TORCH_TUNING_CACHE_PATH``: read this JSON instead of the
  package's ``tuning_cache.json``;
* ``REPRO_TORCH_TILE``: force a tile on every K1/K4 launch, e.g.
  ``b=2,tchunk=4`` (keys may be omitted; beats the cache).

The port never reads the JAX package's variables or its cache file.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import torch

DEFAULT_CACHE_PATH = os.path.join(os.path.dirname(__file__),
                                  "tuning_cache.json")
BACKEND = "cuda"
KERNELS = ("wilson_hop", "wilson_full")
TCHUNKS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One point of the Wilson kernels' launch space (see the module
    docstring): ``b`` rows of Y a block (None: the heuristic, 0: read in
    place), ``tchunk`` t planes a chunk of K4's block order (None: the
    built-in rule)."""

    b: int | None = None
    tchunk: int | None = None

    def __post_init__(self):
        if self.b is not None and (isinstance(self.b, bool)
                                   or not isinstance(self.b, int)
                                   or self.b < 0):
            raise ValueError(
                f"tile rows b must be None (the heuristic), 0 (rows read in "
                f"place) or a positive int, got {self.b!r}")
        if self.tchunk is not None and self.tchunk not in TCHUNKS:
            raise ValueError(
                f"block-order chunk tchunk must be one of {list(TCHUNKS)} "
                f"or None (the built-in rule), got {self.tchunk!r}")

    def to_entry(self) -> dict:
        return {"b": self.b, "tchunk": self.tchunk}


DEFAULT_TILE = TileConfig()


def dtype_name(dtype) -> str:
    """``"float32"``/``"bfloat16"``/``"float16"`` for a torch dtype or its
    name."""
    return str(dtype).removeprefix("torch.")


def cache_key(kernel: str, backend: str, lattice_shape, nrhs: int,
              dtype) -> str:
    """Tuning-cache key ``backend|kernel|TxZxYxX|nrhsN|dtype``: the JAX
    package's key with the kernel's name, since K1 and K4 have different
    knobs and a half field (T, Z, Y, Xh) can have the dims of a full one.
    K1 keys on its half field's (T, Z, Y, Xh), K4 on (T, Z, Y, X)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; the launch space "
                         f"covers {list(KERNELS)}")
    dims = "x".join(str(int(d)) for d in lattice_shape)
    return f"{backend}|{kernel}|{dims}|nrhs{int(nrhs)}|{dtype_name(dtype)}"


def parse_tile(spec: str) -> TileConfig:
    """Parse ``"b=2,tchunk=4"`` (any subset of the keys; ``none`` is the
    default)."""
    kw: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key not in ("b", "tchunk"):
            raise ValueError(
                f"unknown tile key {key!r} in REPRO_TORCH_TILE={spec!r}; "
                "legal keys: b, tchunk")
        try:
            kw[key] = None if val in ("", "none", "None") else int(val)
        except ValueError:
            raise ValueError(f"tile key {key!r} in REPRO_TORCH_TILE={spec!r}"
                             f" needs an int or none, got {val!r}") from None
    return TileConfig(**kw)


def cache_path(path: str | None = None) -> str:
    return path or os.environ.get("REPRO_TORCH_TUNING_CACHE_PATH",
                                  DEFAULT_CACHE_PATH)


def read_tuning_cache(path: str | None = None) -> dict:
    """The entries of the tuning-cache JSON at ``path`` ({} when absent),
    read afresh, whatever ``REPRO_TORCH_TUNING_CACHE`` says."""
    try:
        with open(cache_path(path)) as f:
            return json.load(f).get("entries", {})
    except OSError:
        return {}


def load_tuning_cache(path: str | None = None) -> dict:
    """The entries the launches consult: :func:`read_tuning_cache`, or {}
    when ``REPRO_TORCH_TUNING_CACHE`` is 0 or off."""
    if os.environ.get("REPRO_TORCH_TUNING_CACHE", "1") in ("0", "off"):
        return {}
    return read_tuning_cache(path)


def pick_tile(kernel: str, lattice_shape, nrhs: int, dtype) -> TileConfig:
    """A launch's tile: the ``REPRO_TORCH_TILE`` override, else the cache
    entry of ``(kernel, lattice_shape, nrhs, dtype)`` on the CUDA backend,
    else :data:`DEFAULT_TILE` (the heuristics the kernels always ran).
    A float16 launch without an entry of its own takes the bf16 entry of
    its problem (the same bytes and instances on 16-bit words).

    Resolved once per process for each problem and setting of the three
    variables (the cache file is not read again until
    :func:`save_tuning_cache` writes one), so a launch pays three
    environment reads and a dict lookup."""
    env = os.environ
    return _pick(kernel, tuple(lattice_shape), int(nrhs), dtype,
                 env.get("REPRO_TORCH_TILE"),
                 env.get("REPRO_TORCH_TUNING_CACHE", "1"),
                 env.get("REPRO_TORCH_TUNING_CACHE_PATH"))


@functools.lru_cache(maxsize=None)
def _pick(kernel, lattice_shape, nrhs, dtype, forced, enabled, path):
    key = cache_key(kernel, BACKEND, lattice_shape, nrhs, dtype)
    if forced:
        return parse_tile(forced)
    if enabled in ("0", "off"):
        return DEFAULT_TILE
    entries = read_tuning_cache(path)
    entry = entries.get(key)
    if entry is None and dtype_name(dtype) == "float16":
        entry = entries.get(cache_key(kernel, BACKEND, lattice_shape, nrhs,
                                      torch.bfloat16))
    if entry is None:
        return DEFAULT_TILE
    return TileConfig(b=entry.get("b"), tchunk=entry.get("tchunk"))


def save_tuning_cache(entries: dict, path: str | None = None,
                      meta: dict | None = None) -> str:
    """Write a tuning-cache JSON (:mod:`.autotune`'s persistence)."""
    path = cache_path(path)
    doc = {"schema": 1,
           "comment": "K1/K4 launch-space winners per (backend, kernel, "
                      "lattice, nrhs, dtype); regenerate on the card with "
                      "python -m repro_torch.kernels.autotune",
           "entries": dict(sorted(entries.items()))}
    if meta:
        doc["meta"] = meta
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    _pick.cache_clear()
    return path


def device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name``), the label of a
    cache's sweep; ``"cpu"`` without a card."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"
