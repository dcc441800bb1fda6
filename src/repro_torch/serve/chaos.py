"""Deterministic fault injection for the defended serving stack.

Every injector is deterministic (fires on a fixed call schedule, corrupts
fixed coordinates), so the containment tests and the loadgen ``--chaos``
lane reproduce exactly.  Each poison is bitwise the JAX package's on the
same input (``repro.serve.chaos``).

Two fault surfaces:

* **Poisoned inputs**: :func:`poison_nan` / :func:`poison_overflow`
  corrupt a right-hand side the way a broken producer would.  A NaN RHS
  is caught at admission; an overflow RHS (finite entries whose norm^2
  overflows float32) passes admission and must be caught by the in-solve
  taxonomy and the verification.
* **Transient faults**: :class:`BatchFaultInjector` wraps the server
  worker's view of ``(gauge, rhs)`` (``SolverServer(fault_injector=...)``)
  and corrupts every N-th solve call: a NaN plane or an exponent bit-flip
  in the gauge field (the device-memory fault model), a worker stall
  (deadline expiry) or a raised :class:`InjectedFault` (batch
  bisection).  Faults are transient, so the server's clean individual
  re-solve of an affected batch rescues every healthy member.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import threading
import time

import numpy as np
import torch

__all__ = ["InjectedFault", "BatchFaultInjector", "CrashedProcess",
           "poison_nan", "poison_overflow", "nan_plane", "bit_flip",
           "run_and_sigkill"]

_MODES = ("gauge_nan_plane", "gauge_bitflip", "stall", "raise")


class InjectedFault(RuntimeError):
    """Raised by a ``mode="raise"`` injector: the hard-crash fault model."""


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v))


# -- poisoned inputs ---------------------------------------------------------


def poison_nan(rhs, site: int = 0) -> torch.Tensor:
    """A NaN-poisoned RHS (entry ``site`` of the flattened field set to
    NaN): caught at admission when validation is on, classified
    ``nonfinite`` by the solve taxonomy when it is off."""
    out = _tensor(rhs).clone()
    out.view(-1)[site] = float("nan")
    return out


def poison_overflow(rhs, scale: float = 1e25) -> torch.Tensor:
    """An overflow-poisoned RHS: every entry finite, but ||b||^2
    overflows float32, so it passes the admission check and only the
    in-solve nonfinite taxonomy (and the verification) can catch it."""
    t = _tensor(rhs)
    return (t * scale).to(t.dtype)


# -- transient gauge-field corruptors ----------------------------------------


def nan_plane(u, t: int = 0) -> torch.Tensor:
    """NaN out one time plane of the gauge field (axis 1 of the natural
    (4, T, Z, Y, X, 3, 3) layout): the lost-memory-page fault model."""
    out = _tensor(u).clone()
    out[:, t] = float("nan")
    return out


def bit_flip(u, site: int = 0) -> torch.Tensor:
    """Flip bit 30 (the top exponent bit) of one float32 word of the gauge
    field, a single-event upset: the value jumps by a factor ~2^128."""
    out = _tensor(u).clone()
    words = out.view(torch.float32).view(-1).view(torch.int32)
    words[site] ^= 1 << 30
    return out


@dataclasses.dataclass
class BatchFaultInjector:
    """Deterministic transient-fault injector for ``SolverServer``.

    Wraps the worker's ``(u, b)`` just before the solve runs.  Fires when
    ``calls % every == at % every`` (0-based call counter); the next call
    sees clean fields.

    Modes:
      gauge_nan_plane:  NaN one gauge time plane (nonfinite verdicts)
      gauge_bitflip:    exponent bit-flip in one gauge word
      stall:            sleep ``stall_s`` in the worker thread (deadline
                        and backpressure fault model); fields untouched
      raise:            raise :class:`InjectedFault` (batch bisection)
    """

    mode: str = "gauge_nan_plane"
    every: int = 4
    at: int = 0
    stall_s: float = 0.5
    calls: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"unknown chaos mode {self.mode!r}; pick one of {_MODES}")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")

    def __call__(self, u, b):
        fire = self.calls % self.every == self.at % self.every
        self.calls += 1
        if not fire:
            return u, b
        self.fired += 1
        if self.mode == "raise":
            raise InjectedFault(
                f"injected crash (call {self.calls - 1})")
        if self.mode == "stall":
            time.sleep(self.stall_s)
            return u, b
        if self.mode == "gauge_nan_plane":
            return nan_plane(u), b
        return bit_flip(u), b


# -- process-level crash injection --------------------------------------------

@dataclasses.dataclass
class CrashedProcess:
    """Outcome of :func:`run_and_sigkill`."""

    args: tuple
    pid: int
    killed: bool        # True: we SIGKILLed it; False: it exited first
    returncode: int
    stdout: str         # everything the child printed (stderr merged in)


def run_and_sigkill(argv, *, kill_when, env=None, cwd=None,
                    timeout_s: float = 240.0,
                    poll_s: float = 0.05) -> CrashedProcess:
    """Run ``argv`` and SIGKILL it the moment ``kill_when`` triggers.

    ``kill_when`` is a string (kill once it appears in the child's merged
    output) or a zero- or one-argument callable polled every ``poll_s``
    seconds, which may inspect the output (passed when accepted) or the
    filesystem ("a checkpoint step directory exists").  SIGKILL, not
    SIGTERM: the child gets no chance to flush, drain or run atexit
    hooks, which is the crash the durability machinery must survive.

    If the child exits before the trigger fires, ``killed`` is False and
    the caller decides whether that invalidates the experiment.  If
    neither happens within ``timeout_s`` the child is killed and a
    TimeoutError is raised.
    """
    proc = subprocess.Popen(list(argv), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=cwd)
    chunks: list[str] = []

    def _reader():
        for line in proc.stdout:
            chunks.append(line)

    reader = threading.Thread(target=_reader, daemon=True)
    reader.start()

    def _triggered() -> bool:
        out = "".join(chunks)
        if callable(kill_when):
            try:
                return bool(kill_when(out))
            except TypeError:
                return bool(kill_when())
        return str(kill_when) in out

    deadline = time.monotonic() + float(timeout_s)
    killed = False
    while True:
        if proc.poll() is not None:
            break
        if _triggered():
            os.kill(proc.pid, signal.SIGKILL)
            killed = True
            break
        if time.monotonic() > deadline:
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait()
            reader.join(timeout=5)
            raise TimeoutError(
                f"run_and_sigkill: no trigger and no exit within "
                f"{timeout_s}s; output so far:\n" + "".join(chunks))
        time.sleep(poll_s)
    proc.wait()
    reader.join(timeout=5)
    return CrashedProcess(args=tuple(argv), pid=proc.pid, killed=killed,
                          returncode=proc.returncode,
                          stdout="".join(chunks))
