"""Attention blocks with KV caches (full, sliding-window ring buffer) and
cross-attention for the encoder-decoder family (PyTorch).

Caches are plain dicts of tensors, as in the JAX package.  Where JAX
returns an updated copy of a cache (``dynamic_update_slice``, ``.at[].set``)
the port writes the new K/V into the cache's tensors in place and returns
the same dict: a serving loop never reads a cache it has passed on.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import tp


# ---------------------------------------------------------------------------
# Self-attention block (GQA + RoPE; optional sliding window)
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, dtype, device) -> L.Params:
    d, a = cfg.d_model, cfg.attn_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    s = 0.02
    return L.Params(wq=L.normal(gen, (d, a), dtype, device, s),
                    wk=L.normal(gen, (d, kv), dtype, device, s),
                    wv=L.normal(gen, (d, kv), dtype, device, s),
                    wo=L.normal(gen, (a, d), dtype, device,
                                s / math.sqrt(2)))


def make_kv_cache(cfg: ModelConfig, batch: int, length: int, dtype,
                  ring: bool = False, device="cuda") -> dict:
    """Empty per-layer KV cache. ``ring=True`` -> sliding-window buffer of
    size cfg.window with explicit position slots (-1: empty).  On a mesh
    it holds this rank's KV heads where they divide ``model``
    (``tp.cache_kv_heads``), else every head."""
    if ring:
        length = min(length, cfg.window)
    shape = (batch, length, tp.cache_kv_heads(cfg.num_kv_heads),
             cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if ring:
        cache["pos"] = torch.full((length,), -1, dtype=torch.int64,
                                  device=device)
    return cache


def attn_apply(p: L.Params, x: torch.Tensor, cfg: ModelConfig, *,
               pos0: int = 0, window: int = 0, cache: dict | None = None,
               update_cache: bool = False, causal: bool = True):
    """Self-attention.

    Train/prefill: x is (B, S, d), pos0 the absolute position of x[:,0].
    Decode: x is (B, 1, d) and ``cache`` holds past K/V; the new K/V is
    written at ``pos0`` (or ring slot pos0 % window).
    Returns (out, new_cache_or_None).

    On a mesh (``tp.head_split``) the rank projects its query heads (every
    head under ``"whole"``) and its KV heads under ``"kv"``, else every KV
    head, keeps those in the cache, and ends with ``wo`` row-parallel and
    one all-reduce over ``model``.
    """
    b, s, d = x.shape
    hd = cfg.head_dim
    split = tp.head_split(cfg.num_heads, cfg.num_kv_heads, s)
    kv_part = "local" if split.case == "kv" else "sum"
    x = tp.copy_to(x)
    wq = tp.use(p.wq, ("wq",),
                model="sum" if split.case == "whole" else "local")
    q = L.dot(x, wq).reshape(b, s, split.q_heads, hd)
    k = L.dot(x, tp.use(p.wk, ("wk",), model=kv_part)).reshape(
        b, s, split.kv_heads, hd)
    v = L.dot(x, tp.use(p.wv, ("wv",), model=kv_part)).reshape(
        b, s, split.kv_heads, hd)

    q_pos = pos0 + torch.arange(s, device=x.device)
    q = L.rope(q, q_pos[None, :], cfg.rope_theta)
    k = L.rope(k, q_pos[None, :], cfg.rope_theta)

    new_cache = None
    if cache is None:
        kk, vv, kv_pos = k, v, q_pos
    else:
        if not update_cache:  # JAX leaves the caller's cache untouched
            cache = {n: t.clone() for n, t in cache.items()}
        if "pos" in cache:
            w = cache["k"].shape[1]
            if s == 1:        # decode: write one slot, attend over the ring
                slot = pos0 % w
                cache["k"][:, slot] = k[:, 0]
                cache["v"][:, slot] = v[:, 0]
                cache["pos"][slot] = pos0
                kk, vv, kv_pos = cache["k"], cache["v"], cache["pos"]
            else:
                # prefill: attend over the fresh sequence (each query sees
                # its own window); the cache keeps the trailing w tokens at
                # their canonical ring slots pos % w
                if s >= w:
                    tk, tv, tpos = k[:, -w:], v[:, -w:], q_pos[-w:]
                else:
                    tk, tv, tpos = k, v, q_pos
                slots = tpos % w
                cache["k"][:, slots] = tk
                cache["v"][:, slots] = tv
                cache["pos"][slots] = tpos
                kk, vv, kv_pos = k, v, q_pos
        else:
            cache["k"][:, pos0:pos0 + s] = k
            cache["v"][:, pos0:pos0 + s] = v
            kk, vv = cache["k"], cache["v"]
            kv_pos = torch.arange(kk.shape[1], device=x.device)
        if update_cache:
            new_cache = cache

    out = L.attention(q, kk, vv, q_pos=q_pos, kv_pos=kv_pos,
                      causal=causal, window=window, split=split)
    out = out.reshape(b, s, split.q_heads * hd)
    if split.case == "whole":     # this rank's columns for its rows of wo
        a = out.shape[-1] // split.tp
        out = out[..., tp.index() * a:(tp.index() + 1) * a]
    return L.row_parallel(out, tp.use(p.wo, ("wo",))), new_cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(gen, cfg: ModelConfig, dtype, device) -> L.Params:
    return attn_init(gen, cfg, dtype, device)


def cross_attn_apply(p: L.Params, x: torch.Tensor, enc: torch.Tensor | None,
                     cfg: ModelConfig, *, cache: dict | None = None,
                     update_cache: bool = False):
    """Cross-attention over encoder output ``enc`` (B, Se, d).  At decode
    time pass the prefill-computed ``cache`` instead of ``enc``.  On a mesh
    it reads its weights whole and computes every head on every rank
    (``tp.whole``), with a cache of every head."""
    p = tp.whole(p)
    b, s, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = L.dot(x, p.wq).reshape(b, s, hq, hd)
    if cache is None:
        se = enc.shape[1]
        k = L.dot(enc, p.wk).reshape(b, se, hkv, hd)
        v = L.dot(enc, p.wv).reshape(b, se, hkv, hd)
        new_cache = {"k": k, "v": v} if update_cache else None
    else:
        k, v = cache["k"], cache["v"]
        new_cache = cache if update_cache else None
    kv_pos = torch.arange(k.shape[1], device=x.device)
    q_pos = torch.zeros((s,), dtype=torch.int64, device=x.device)
    out = L.attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=False)
    out = L.dot(out.reshape(b, s, hq * hd), p.wo)
    return out, new_cache
