"""Solve as a service: the continuous-batching solver server.

Public surface (module paths mirror ``repro.serve``):
  server     SolverServer (async admit, queue, coalesce, pad, batched
             solve, verify, contain), SolveRequest / SolveResult /
             RequestStats
  errors     the structured failure types (RequestRejected,
             ServerOverloaded, SolveTimeout, RequestFailed, ServerClosed)
  chaos      deterministic fault injectors (BatchFaultInjector, poisoned
             RHS helpers, run_and_sigkill)
  batching   the batch-shape ladder and BatchPolicy
  journal    the write-ahead request journal (the JAX package's format)
  plan_cache DeflationCache (harvested bases per gauge field)
  loadgen    WorkloadConfig / run_workload: an open-loop load generator
             with direct-solve verification
"""

from repro_torch.serve.batching import (BatchPolicy, DEFAULT_LADDER,
                                        pad_batch, pad_tols, rung_for,
                                        validate_ladder)
from repro_torch.serve.chaos import (BatchFaultInjector, InjectedFault,
                                     bit_flip, nan_plane, poison_nan,
                                     poison_overflow)
from repro_torch.serve.errors import (RequestFailed, RequestRejected,
                                      ServerClosed, ServerOverloaded,
                                      SolveTimeout)
from repro_torch.serve.loadgen import (WorkloadConfig, build_workload,
                                       drive_open_loop, run_workload,
                                       verify_against_direct)
from repro_torch.serve.plan_cache import DeflationCache
from repro_torch.serve.server import (RequestStats, SolveRequest,
                                      SolveResult, SolverServer)
