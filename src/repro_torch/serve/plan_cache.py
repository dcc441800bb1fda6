"""Deflation cache: harvested low-mode bases per gauge field.

:class:`DeflationCache` holds harvested
:class:`~repro_torch.core.solvers.DeflationBasis` objects keyed by the
server's coalesce key, LRU-bounded over gauge ids: data about one gauge
field, invalidated when the field changes and evicted when it goes cold.

The JAX package's module also holds a plan cache of jitted solves.  The
port has none: it compiles nothing per plan (its kernels are built once a
process), so the server calls ``plan.solve`` directly.
"""

from __future__ import annotations

from repro_torch.core import solvers


class DeflationCache:
    """Per-gauge-field deflation-basis cache.

    Keys are the server's coalesce key ``(gauge_id, family, mu, mass)``:
    the identity of the Krylov operator whose low modes a basis
    approximates.  A basis is valid for one gauge field, so re-registering
    a gauge id must call :meth:`invalidate_gauge` (the server does), and
    memory is bounded by LRU eviction over gauge ids: a gauge field owns
    every basis harvested on it, and they go cold together.
    """

    def __init__(self, max_gauges: int = 8):
        if max_gauges < 1:
            raise ValueError(f"max_gauges must be >= 1, got {max_gauges}")
        self.max_gauges = int(max_gauges)
        self._bases: dict[tuple, solvers.DeflationBasis] = {}
        # gauge_id -> None; insertion order is recency order
        self._lru: dict[str, None] = {}
        self.hits = 0
        self.misses = 0
        self.harvests = 0
        self.evictions = 0
        self.invalidations = 0

    @staticmethod
    def _gauge_of(key: tuple) -> str:
        return str(key[0])

    def _touch(self, gauge_id: str) -> None:
        self._lru.pop(gauge_id, None)
        self._lru[gauge_id] = None

    def lookup(self, key: tuple) -> solvers.DeflationBasis | None:
        """The basis for a coalesce key, counting hit/miss and touching
        the owning gauge's LRU slot; None on miss."""
        basis = self._bases.get(key)
        if basis is None:
            self.misses += 1
            return None
        self.hits += 1
        self._touch(self._gauge_of(key))
        return basis

    def peek(self, key: tuple) -> solvers.DeflationBasis | None:
        """Lookup without touching counters or recency (harvest guard)."""
        return self._bases.get(key)

    def store(self, key: tuple, basis: solvers.DeflationBasis) -> None:
        """Record a harvested basis, evicting the least recently used
        gauge's bases if a new gauge would exceed ``max_gauges``."""
        gauge_id = self._gauge_of(key)
        if gauge_id not in self._lru and len(self._lru) >= self.max_gauges:
            self._drop_gauge(next(iter(self._lru)))
            self.evictions += 1
        self._bases[key] = basis
        self._touch(gauge_id)
        self.harvests += 1

    def _drop_gauge(self, gauge_id: str) -> int:
        self._lru.pop(gauge_id, None)
        doomed = [k for k in self._bases if self._gauge_of(k) == gauge_id]
        for k in doomed:
            del self._bases[k]
        return len(doomed)

    def invalidate_gauge(self, gauge_id: str) -> int:
        """Drop every basis of one gauge id (the field changed); returns
        the number of bases invalidated."""
        dropped = self._drop_gauge(str(gauge_id))
        self.invalidations += dropped
        return dropped

    def bases(self) -> dict[tuple, solvers.DeflationBasis]:
        """Snapshot of the cached bases (a verification oracle re-solves
        a deflated response with the basis the server used)."""
        return dict(self._bases)

    def __len__(self) -> int:
        return len(self._bases)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"size": len(self._bases), "gauges": len(self._lru),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate, "harvests": self.harvests,
                "evictions": self.evictions,
                "invalidations": self.invalidations}
