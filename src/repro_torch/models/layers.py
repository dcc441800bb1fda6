"""Shared neural-net layers: RMSNorm, RoPE, online-softmax attention
(full / sliding-window / cross), MLP variants, embeddings (PyTorch).

The JAX package's ``models/layers.py``, function for function.
Conventions kept from it:

  * activations keep the compute dtype; every contraction accumulates in
    f32 and is cast back (:func:`dot`).  Products of two 16-bit values are
    exact in f32, so upcasting the operands and multiplying in f32 gives
    what XLA's ``preferred_element_type=f32`` gives, up to summation order.
  * attention is a chunked online softmax over KV chunks (a Python loop
    over chunks where JAX scans): O(seq) memory for the scores.  It is the
    plain version a later Hopper attention kernel will be held against.

The attention's backward is JAX's ``_flash_bwd`` (a ``custom_vjp``
there) as a ``torch.autograd.Function``: it recomputes the scores chunk
by chunk from the saved output and logsumexp.  Parameters live in
``nn.Module`` containers whose attribute names are the JAX parameter
dict's keys (``wq``, ``wg``, ``tok`` ...); the functions take such a
module where JAX takes the dict.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.parallel import tp

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
    # frozen: serving takes no gradients, and training takes them with
    # respect to a compute copy (steps.cast_compute), never these tensors
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


def remat(cfg, model: Params, fn):
    """``fn`` under ``torch.utils.checkpoint`` (its activations recomputed
    in the backward, as JAX wraps a segment's body in
    ``jax.checkpoint(..., nothing_saveable)``) when ``cfg.remat`` and
    gradients are being taken of ``model``'s parameters; ``fn`` itself
    otherwise, so serving, whose parameters are frozen, never recomputes."""
    if cfg.remat and torch.is_grad_enabled() and \
            model.final_norm.requires_grad:
        return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                                 use_reentrant=False)
    return fn


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
# Attention: online softmax over KV chunks, with a backward that saves only
# (q, k, v, out, logsumexp) and recomputes the scores chunk by chunk
# ---------------------------------------------------------------------------

def _mask_for(pj, q_pos, causal: bool, window: int):
    valid = (pj[None, :] >= 0).expand(q_pos.shape[0], -1)
    if causal:
        valid = valid & (pj[None, :] <= q_pos[:, None])
    if window > 0:
        valid = valid & (q_pos[:, None] - pj[None, :] < window)
    return valid  # (sq, chunk)


def _flash_fwd_inner(qg, k, v, q_pos, kv_pos, causal, window, chunk):
    """Online softmax over ``chunk``-sized KV blocks; returns the output
    (b, hkv, g, sq, hd) and the logsumexp (b, hkv, g, sq), both in f32
    (float64 for float64 inputs)."""
    b, sq, hkv, g, hd = qg.shape
    acc_t = torch.promote_types(qg.dtype, F32)
    scale = 1.0 / math.sqrt(hd)
    q32 = qg.to(acc_t)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=acc_t, device=qg.device)
    denom = torch.zeros((b, hkv, g, sq), dtype=acc_t, device=qg.device)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=acc_t, device=qg.device)
    for j in range(0, k.shape[1], chunk):
        kj, vj, pj = k[:, j:j + chunk], v[:, j:j + chunk], kv_pos[j:j + chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", q32, kj.to(acc_t)) * scale
        valid = _mask_for(pj, q_pos, causal, window)[None, None, None]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(valid, p, 0.0)
        denom = denom * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(k.dtype).to(acc_t),
                          vj.to(acc_t))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    lse = m + torch.log(torch.clamp(denom, min=1e-30))
    return out, lse


def _flash_bwd(qg, k, v, q_pos, kv_pos, out, lse, dout, causal, window,
               chunk):
    """JAX's ``_flash_bwd`` on one device: the probabilities of each KV
    chunk recomputed from the saved logsumexp, dq summed over the chunks,
    dk and dv written chunk by chunk.  Returns (dq, dk, dv) in the input
    dtypes."""
    acc_t = out.dtype
    scale = 1.0 / math.sqrt(qg.shape[-1])
    q32 = qg.to(acc_t)
    dout = dout.to(acc_t)
    delta = torch.sum(dout * out, dim=-1)               # (b, hkv, g, sq)
    dq = torch.zeros(qg.shape, dtype=acc_t, device=qg.device)
    dk, dv = [], []
    for j in range(0, k.shape[1], chunk):
        kj = k[:, j:j + chunk].to(acc_t)
        vj = v[:, j:j + chunk].to(acc_t)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q32, kj) * scale
        valid = _mask_for(kv_pos[j:j + chunk], q_pos, causal,
                          window)[None, None, None]
        p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
        dv.append(torch.einsum("bhgqk,bhgqd->bkhd", p, dout))
        dp = torch.einsum("bhgqd,bkhd->bhgqk", dout, vj)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kj)
        dk.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, q32))
    return (dq.to(qg.dtype), torch.cat(dk, dim=1).to(k.dtype),
            torch.cat(dv, dim=1).to(v.dtype))


class _Flash(torch.autograd.Function):
    """The chunked attention with JAX's custom VJP: the forward is
    :func:`_flash_fwd_inner`, the backward :func:`_flash_bwd`.  Autograd
    through the forward loop would keep every chunk's scores alive."""

    @staticmethod
    def forward(ctx, qg, k, v, q_pos, kv_pos, causal, window, chunk):
        out, lse = _flash_fwd_inner(qg, k, v, q_pos, kv_pos, causal, window,
                                    chunk)
        ctx.save_for_backward(qg, k, v, q_pos, kv_pos, out, lse)
        ctx.args = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(qg, k, v, q_pos, kv_pos, out, lse, dout,
                                *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_pos: torch.Tensor, kv_pos: torch.Tensor,
              causal: bool = True, window: int = 0,
              chunk: int = 1024, split=None) -> torch.Tensor:
    """Grouped-query attention (chunked online softmax).

    q: (B, Sq, Hq, hd);  k, v: (B, Skv, Hkv, hd);  Hq % Hkv == 0.
    q_pos: (Sq,) int; kv_pos: (Skv,) int (-1 marks an empty cache slot).
    window > 0 limits attention to the last ``window`` positions.

    On a mesh ``split`` (``tp.head_split``) says which heads this rank
    holds, JAX's three cases: ``"kv"``, q and k/v this rank's heads;
    ``"rep"`` and ``"group"``, q this rank's query heads and k/v every KV
    head, of which the rank's heads share one (under ``"rep"`` the rank's
    virtual KV head, JAX's ``repeat`` of K/V ``rep`` times); ``"whole"``,
    every head.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if split is not None and split.tp > 1:
        tp.CASES[split.case] += 1
        if split.case in ("rep", "group"):
            g_all = split.q_heads * split.tp // hkv
            if g_all % hq:
                raise ValueError(
                    f"{hq} query heads a rank straddle the groups of "
                    f"{hkv} KV heads on a model axis of {split.tp}")
            kv = split.q0 // g_all
            k, v = k[:, :, kv:kv + 1], v[:, :, kv:kv + 1]
            hkv = 1
    g = hq // hkv
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
    out = _Flash.apply(qg, k, v, q_pos, kv_pos, causal, window, chunk)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`dot` of this rank's columns of ``x`` and rows of ``w``,
    summed over ``model`` in f32 before the cast (off-mesh :func:`dot`)."""
    return tp.reduce_from(torch.matmul(x.float(), w.float())).to(x.dtype)


def mlp_apply(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The MLP; on a mesh ``wg``/``wu`` column-parallel and ``wd``
    row-parallel over ``model``, gathered over ``data`` just before use."""
    x = tp.copy_to(x)
    wu = tp.use(p.wu, ("wu",))
    if kind == "swiglu":
        h = torch.nn.functional.silu(dot(x, tp.use(p.wg, ("wg",)))
                                     .float()).to(x.dtype)
        h = h * dot(x, wu)
    elif kind == "geglu":
        h = torch.nn.functional.gelu(dot(x, tp.use(p.wg, ("wg",))).float(),
                                     approximate="tanh").to(x.dtype)
        h = h * dot(x, wu)
    elif kind == "squared_relu":
        h = torch.relu(dot(x, wu))
        h = h * h
    else:
        raise ValueError(kind)
    return row_parallel(h, tp.use(p.wd, ("wd",)))


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
    """The tokens' rows; on a mesh vocabulary-parallel: each rank looks up
    the tokens in its rows, zeroes the others and the ranks' rows are
    summed over ``model``."""
    tok = tp.use(p.tok, ("tok",))
    if tp.size() == 1:
        return tok[tokens].to(dtype)
    local = tokens - tp.vocab_start(tok.shape[0])
    mine = (local >= 0) & (local < tok.shape[0])
    h = tok[torch.where(mine, local, 0)].to(dtype)
    return tp.reduce_from(torch.where(mine[..., None], h, 0))


def logits_out(p: Params, x: torch.Tensor,
               vocab: int | None = None) -> torch.Tensor:
    """f32 logits, the vocabulary-padding columns masked; on a mesh this
    rank's vocabulary columns (the padding masked by global column)."""
    name = "out" if hasattr(p, "out") else "tok"
    w = tp.use(getattr(p, name), (name,))
    logits = torch.matmul(tp.copy_to(x).float(), w.float().T)
    rows = w.shape[0]
    pv = rows * tp.size()
    if vocab is not None and pv != vocab:  # mask vocab-padding rows
        keep = tp.vocab_start(rows) + torch.arange(rows,
                                                   device=x.device) < vocab
        logits = torch.where(keep, logits, NEG_INF)
    return logits
