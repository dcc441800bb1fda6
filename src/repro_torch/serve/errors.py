"""Structured serving errors: every way a request can fail, as a type.

The containment contract: a request that cannot be
served NEVER hangs its awaiter and never returns an unverified x — it
fails with one of these, each carrying enough structure for the client
to decide retry/reshape/alert without parsing message strings.
"""

from __future__ import annotations

__all__ = ["RequestRejected", "ServerOverloaded", "SolveTimeout",
           "RequestFailed", "ServerClosed"]


class RequestRejected(ValueError):
    """Admission-time rejection: the request was invalid on arrival
    (non-finite RHS, non-finite/non-positive tolerance, bad parameters)
    and never touched a queue."""

    def __init__(self, message: str, *, reason: str = "invalid"):
        super().__init__(message)
        self.reason = reason


class ServerOverloaded(RuntimeError):
    """Backpressure: the request's coalesce-key queue is at its bound.
    The client should back off and retry; nothing was enqueued."""

    def __init__(self, message: str, *, queue_depth: int):
        super().__init__(message)
        self.queue_depth = queue_depth


class SolveTimeout(TimeoutError):
    """The request's deadline expired before its batch dispatched; it was
    dropped WITHOUT consuming a batch slot."""


class RequestFailed(RuntimeError):
    """The solve ran but could not produce a verified solution, even
    after the containment retry.  ``verdict`` is the classified failure
    (a :data:`repro_torch.core.solvers.VERDICTS` name, or ``"error"`` when the
    solve raised instead of returning)."""

    def __init__(self, message: str, *, verdict: str, retried: bool = False):
        super().__init__(message)
        self.verdict = verdict
        self.retried = retried


class ServerClosed(RuntimeError):
    """The server shut down (abort path) before this request completed."""
