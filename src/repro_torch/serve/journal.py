"""Write-ahead request journal: the serving half of durability.

The on-disk format is the JAX package's (``repro.serve.journal``), so
each package's scan reads the other's journal.

The server journals every ADMITTED request before it can touch a queue
and marks it complete when its future resolves — append-only JSONL with
an fsync per event, so a SIGKILL at any instant loses no admitted
request: on restart, :meth:`SolverServer.recover` replays exactly the
entries with no completion mark.

Layout under ``journal_dir``:

* ``journal.jsonl`` — one JSON object per line.  ``{"event": "admit",
  "rid": N, ...request fields...}`` on admission; ``{"event":
  "complete", "rid": N, "status": ...}`` when the request's future
  resolves (result OR classified failure — both are completions; only a
  crash leaves an entry open).
* ``rhs/<rid>.npy`` — the request's right-hand side, written
  tmp+rename+fsync BEFORE its admit line, so an admit record never
  points at a missing or torn array.

Crash tolerance on READ: the journal's last line may be torn (the
process died mid-append); the scanner ignores a trailing line that does
not parse.  Everything earlier was fsync'd line-atomically.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

__all__ = ["RequestJournal", "scan_journal", "incomplete_requests",
           "load_rhs", "mark_complete"]

_RHS_DIR = "rhs"
_LOG = "journal.jsonl"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class RequestJournal:
    """Append-only admit/complete journal for one server process."""

    def __init__(self, journal_dir: str):
        self.dir = str(journal_dir)
        os.makedirs(os.path.join(self.dir, _RHS_DIR), exist_ok=True)
        self._f = open(os.path.join(self.dir, _LOG), "a",
                       encoding="utf-8")

    def _append(self, record: dict) -> None:
        self._f.write(json.dumps(record, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def admit(self, rid: int, *, operator_family: str, gauge_id: str,
              rhs, tol: float, mu: float, mass: float | None,
              deadline_s: float | None) -> None:
        """Durably record one admitted request (RHS first, then the line).
        ``rhs`` is a host array: the server moves a device RHS to numpy
        before it calls this."""
        rel = os.path.join(_RHS_DIR, f"{int(rid)}.npy")
        host = np.asarray(rhs)
        fd, tmp = tempfile.mkstemp(dir=os.path.join(self.dir, _RHS_DIR),
                                   prefix=".tmp_", suffix=".npy")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, host)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.dir, rel))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        _fsync_dir(os.path.join(self.dir, _RHS_DIR))
        self._append({
            "event": "admit", "rid": int(rid),
            "operator_family": str(operator_family),
            "gauge_id": str(gauge_id), "rhs": rel,
            "tol": float(tol), "mu": float(mu),
            "mass": None if mass is None else float(mass),
            "deadline_s": None if deadline_s is None else float(deadline_s),
        })

    def complete(self, rid: int, status: str) -> None:
        self._append({"event": "complete", "rid": int(rid),
                      "status": str(status)})

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def scan_journal(journal_dir: str) -> list[dict]:
    """All parseable events in append order; a torn last line is skipped.

    A torn line ANYWHERE ELSE is corruption, not a crash artifact, and
    raises — fsync-per-line means only the final append can be partial.
    """
    path = os.path.join(journal_dir, _LOG)
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    events = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                break  # torn tail: the append the crash interrupted
            raise IOError(
                f"journal {path} line {i + 1} is corrupt (not the tail)")
    return events


def incomplete_requests(journal_dir: str) -> list[dict]:
    """Admit records with no completion mark — the replay set, in
    admission order."""
    admitted: dict[int, dict] = {}
    for ev in scan_journal(journal_dir):
        if ev.get("event") == "admit":
            admitted[int(ev["rid"])] = ev
        elif ev.get("event") == "complete":
            admitted.pop(int(ev["rid"]), None)
    return [admitted[rid] for rid in sorted(admitted)]


def load_rhs(journal_dir: str, entry: dict) -> np.ndarray:
    """The journaled right-hand side of one admit record."""
    return np.load(os.path.join(journal_dir, entry["rhs"]))


def mark_complete(journal_dir: str, rid: int, status: str) -> None:
    """Append a completion mark from OUTSIDE the owning server — used by
    recovery to retire replayed entries of a dead process's journal."""
    with open(os.path.join(journal_dir, _LOG), "a", encoding="utf-8") as f:
        f.write(json.dumps({"event": "complete", "rid": int(rid),
                            "status": str(status)}, sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
