"""Shared neural-net layers: RMSNorm, RoPE, online-softmax attention
(full / sliding-window / cross), MLP variants, embeddings (PyTorch).

The forward half of the JAX package's ``models/layers.py``, function for
function.  Conventions kept from it:

  * activations keep the compute dtype; every contraction accumulates in
    f32 and is cast back (:func:`dot`).  Products of two 16-bit values are
    exact in f32, so upcasting the operands and multiplying in f32 gives
    what XLA's ``preferred_element_type=f32`` gives, up to summation order.
  * attention is a chunked online softmax over KV chunks (a Python loop
    over chunks where JAX scans): O(seq) memory for the scores.  It is the
    plain version a later Hopper attention kernel will be held against.

The backward (JAX's ``_flash_bwd``) belongs to the training slice.
Parameters live in ``nn.Module`` containers whose attribute names are the
JAX parameter dict's keys (``wq``, ``wg``, ``tok`` ...); the functions
take such a module where JAX takes the dict.
"""

from __future__ import annotations

import math

import torch
from torch import nn

F32 = torch.float32
NEG_INF = -1e30


class Params(nn.Module):
    """A named container of parameters and sub-containers: the port's form
    of one of JAX's parameter dicts (attribute names are its keys)."""

    def __init__(self, **entries):
        super().__init__()
        for name, value in entries.items():
            setattr(self, name, value)


def _empty(shape, dtype, device) -> nn.Parameter:
    # frozen: serving never takes gradients
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def normal(gen: torch.Generator | None, shape, dtype, device,
           std: float) -> nn.Parameter:
    """N(0, std^2) drawn from ``gen``; ``gen=None`` leaves it uninitialised
    (for weights copied in afterwards)."""
    t = _empty(shape, dtype, device)
    if gen is not None:
        with torch.no_grad():
            t.normal_(0.0, 1.0, generator=gen).mul_(std)
    return t


def uniform(gen: torch.Generator | None, shape, device, lo: float = 0.0,
            hi: float = 1.0) -> nn.Parameter:
    """U[lo, hi) in f32 drawn from ``gen`` (``gen=None``: uninitialised)."""
    t = _empty(shape, F32, device)
    if gen is not None:
        with torch.no_grad():
            t.uniform_(lo, hi, generator=gen)
    return t


def full(shape, value: float, device) -> nn.Parameter:
    """A constant f32 parameter (norm scales, biases, base decays)."""
    t = _empty(shape, F32, device)
    with torch.no_grad():
        t.fill_(value)
    return t


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x's last axis contracted with w's first, f32 accumulation, cast back
    to x.dtype (every ``L.dot`` of the JAX package has this form)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on the last axis, split halves (not interleaved).
    x: (..., S, H, hd); pos: (..., S)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                          device=x.device) / hd))
    ang = pos.to(F32)[..., None] * freqs              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: online softmax over KV chunks (forward only)
# ---------------------------------------------------------------------------

def _mask_for(pj, q_pos, causal: bool, window: int):
    valid = (pj[None, :] >= 0).expand(q_pos.shape[0], -1)
    if causal:
        valid = valid & (pj[None, :] <= q_pos[:, None])
    if window > 0:
        valid = valid & (q_pos[:, None] - pj[None, :] < window)
    return valid  # (sq, chunk)


def _flash_fwd_inner(qg, k, v, q_pos, kv_pos, causal, window, chunk):
    """Online softmax over ``chunk``-sized KV blocks; returns the f32
    output (b, hkv, g, sq, hd) and the logsumexp (b, hkv, g, sq)."""
    b, sq, hkv, g, hd = qg.shape
    scale = 1.0 / math.sqrt(hd)
    q32 = qg.float()
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=F32, device=qg.device)
    denom = torch.zeros((b, hkv, g, sq), dtype=F32, device=qg.device)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=F32, device=qg.device)
    for j in range(0, k.shape[1], chunk):
        kj, vj, pj = k[:, j:j + chunk], v[:, j:j + chunk], kv_pos[j:j + chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", q32, kj.float()) * scale
        valid = _mask_for(pj, q_pos, causal, window)[None, None, None]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(valid, p, 0.0)
        denom = denom * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(k.dtype).float(),
                          vj.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    lse = m + torch.log(torch.clamp(denom, min=1e-30))
    return out, lse


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_pos: torch.Tensor, kv_pos: torch.Tensor,
              causal: bool = True, window: int = 0,
              chunk: int = 1024) -> torch.Tensor:
    """Grouped-query attention (chunked online softmax).

    q: (B, Sq, Hq, hd);  k, v: (B, Skv, Hkv, hd);  Hq % Hkv == 0.
    q_pos: (Sq,) int; kv_pos: (Skv,) int (-1 marks an empty cache slot).
    window > 0 limits attention to the last ``window`` positions.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    # JAX replicates KV heads here when they cannot cover a `model` mesh
    # axis; on one device there is no such axis and it is a no-op.
    qg = q.reshape(b, sq, hkv, g, hd)
    if sq == 1:
        # decode: one query, the whole cache as a single chunk
        chunk = skv
    chunk = min(chunk, skv)
    if skv % chunk:  # pad KV to a chunk multiple with masked slots
        pad = chunk - skv % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    out, _ = _flash_fwd_inner(qg, k, v, q_pos, kv_pos, causal, window, chunk)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def mlp_apply(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = torch.nn.functional.silu(dot(x, p.wg).float()).to(x.dtype)
        h = h * dot(x, p.wu)
    elif kind == "geglu":
        h = torch.nn.functional.gelu(dot(x, p.wg).float(),
                                     approximate="tanh").to(x.dtype)
        h = h * dot(x, p.wu)
    elif kind == "squared_relu":
        h = torch.relu(dot(x, p.wu))
        h = h * h
    else:
        raise ValueError(kind)
    return dot(h, p.wd)


def mlp_init(gen, d: int, ff: int, kind: str, dtype, device) -> Params:
    std_in, std_out = 0.02, 0.02 / math.sqrt(2.0)
    p = Params(wu=normal(gen, (d, ff), dtype, device, std_in),
               wd=normal(gen, (ff, d), dtype, device, std_out))
    if kind in ("swiglu", "geglu"):
        p.wg = normal(gen, (d, ff), dtype, device, std_in)
    return p


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d: int, dtype, tie: bool,
               padded_vocab: int | None = None, device="cuda") -> Params:
    pv = padded_vocab or vocab
    p = Params(tok=normal(gen, (pv, d), dtype, device, 0.02))
    if not tie:
        p.out = normal(gen, (pv, d), dtype, device, 0.02)
    return p


def embed_lookup(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p.tok[tokens].to(dtype)


def logits_out(p: Params, x: torch.Tensor,
               vocab: int | None = None) -> torch.Tensor:
    w = p.out if hasattr(p, "out") else p.tok
    logits = torch.matmul(x.float(), w.float().T)
    pv = w.shape[0]
    if vocab is not None and pv != vocab:  # mask vocab-padding rows
        keep = torch.arange(pv, device=x.device) < vocab
        logits = torch.where(keep, logits, NEG_INF)
    return logits
