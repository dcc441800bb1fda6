"""K2 ``cg_update`` and K3 ``cg_xpay``: wrappers of the fused CG kernels.

The CUDA source is ``repro_torch/csrc/cg_fused.cu`` (its header note says
what bounds the kernels and how they are laid out).  K2 replaces the
Pallas kernels ``cg_update_pallas``/``cg_update_batched_pallas`` and K3
``cg_xpay_pallas``/``cg_xpay_batched_pallas`` of
``repro/kernels/cg_fused/kernel.py``.

Fields are (N, ...) batches, contiguous, streamed as (N, L) with the
ragged end masked in the kernel, all float32, all bf16 or all float16
(the storage of the mixed-precision solve's inner CG); scalars and norms
are float32.
For CPU tensors the wrappers run the plain versions in :mod:`.ref`, and
only then; for CUDA tensors they launch the kernel or raise.  Each
wrapper counts ``launches`` (one per call that launched its kernels —
K2's call is a streaming pass plus a fixed-order partial-sum pass) and
``plain_calls``; calls on bf16 or float16 storage count as
``launches_bf16`` / ``launches_f16`` and ``plain_calls_bf16`` /
``plain_calls_f16``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cg_fused.ref import cg_update_ref, cg_xpay_ref


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("cg_fused")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.cg_update_blocks.argtypes = [n]
    lib.cg_update_blocks.restype = i
    lib.cg_update.argtypes = [p] * 9 + [i, n, i, p]
    lib.cg_update.restype = i
    lib.cg_xpay.argtypes = [p] * 5 + [i, n, i, p]
    lib.cg_xpay.restype = i
    return lib


def _check(entry: str, fields, scalars) -> int:
    """Check the operands; returns the fields' storage code."""
    dev = fields[0].device
    shape = fields[0].shape
    for v in fields:
        if v.device != dev or not v.is_contiguous() or v.shape != shape:
            raise ValueError(f"{entry}: fields must be contiguous tensors "
                             f"of one shape on one device; got "
                             f"{tuple(v.shape)} on {v.device}")
    for v in scalars:
        if v.device != dev or v.shape != (shape[0],):
            raise ValueError(f"{entry}: per-RHS scalars must be ({shape[0]},)"
                             f" on {dev}, got {tuple(v.shape)} on {v.device}")
    return build.storage_code(entry, fields)


def _empty_aligned_as(v: torch.Tensor) -> torch.Tensor:
    """An empty contiguous tensor shaped like ``v`` whose data starts as far
    past a 16-byte boundary as ``v``'s does.  K2's 16-bit split of an RHS
    into a scalar head and 16-byte vectors follows its operands' common
    alignment, and so does the order of its norm's partial sums: outputs
    aligned like ``x`` keep RHS n of a batch and the single call on
    ``x[n:n+1]`` on one split, so the two norms agree bitwise."""
    off = v.data_ptr() % 16 // v.element_size()
    if off == 0:
        return torch.empty_like(v)
    buf = torch.empty(v.numel() + 16, dtype=v.dtype, device=v.device)
    return buf[off:off + v.numel()].view(v.shape)


def cg_update(alpha: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
              p: torch.Tensor, ap: torch.Tensor):
    """(x + a_n p, r - a_n Ap, ||r'_n||^2) for (N, ...) fields, (N,) alpha;
    the fields keep their dtype, the norms are float32."""
    storage = _check("cg_update", (x, r, p, ap), (alpha,))
    if x.device.type == "cpu":
        build.count(cg_update, "plain_calls", x.dtype)
        return cg_update_ref(alpha, x, r, p, ap)
    lib = _lib()
    n = x.shape[0]
    length = x.numel() // n
    alpha = alpha.to(torch.float32).contiguous()
    xo, ro = _empty_aligned_as(x), _empty_aligned_as(x)
    partial = torch.empty((n, lib.cg_update_blocks(length)),
                          dtype=torch.float32, device=x.device)
    rs = torch.empty(n, dtype=torch.float32, device=x.device)
    rc = lib.cg_update(alpha.data_ptr(), x.data_ptr(), r.data_ptr(),
                       p.data_ptr(), ap.data_ptr(), xo.data_ptr(),
                       ro.data_ptr(), partial.data_ptr(), rs.data_ptr(), n,
                       length, storage,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "cg_update")
    build.count(cg_update, "launches", x.dtype)
    return xo, ro, rs


def cg_xpay(beta: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
            gate: torch.Tensor | None = None) -> torch.Tensor:
    """p' = r + b_n p for (N, ...) fields, only where ``gate`` (N,) is set
    (everywhere when it is None)."""
    storage = _check("cg_xpay", (r, p),
                     (beta,) if gate is None else (beta, gate))
    if p.device.type == "cpu":
        build.count(cg_xpay, "plain_calls", p.dtype)
        return cg_xpay_ref(beta, r, p, gate)
    lib = _lib()
    n = p.shape[0]
    beta = beta.to(torch.float32).contiguous()
    if gate is not None:
        gate = gate.to(torch.uint8).contiguous()
    po = torch.empty_like(p)
    rc = lib.cg_xpay(beta.data_ptr(),
                     gate.data_ptr() if gate is not None else None,
                     r.data_ptr(), p.data_ptr(), po.data_ptr(), n,
                     p.numel() // n, storage,
                     torch.cuda.current_stream(p.device).cuda_stream)
    build.check(lib, rc, "cg_xpay")
    build.count(cg_xpay, "launches", p.dtype)
    return po


build.zero_counts(cg_update)
build.zero_counts(cg_xpay)
