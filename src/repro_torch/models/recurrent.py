"""Recurrent families: the RG-LRU block (RecurrentGemma/Griffin) and the
RWKV-v6 "Finch" time/channel mix with data-dependent decay (PyTorch).

Both are linear recurrences.  Prefill uses a parallel form, decoding an
O(1) state update, as in the JAX package:

  * RG-LRU: torch has no ``associative_scan``; :func:`_linear_scan` is a
    log-depth (Hillis-Steele) scan of the same composition.  Its
    combination tree differs from XLA's, so the two agree to f32 rounding
    (the tests hold the logits to 1e-4 of their largest magnitude).
  * WKV: :func:`_wkv_chunked` is JAX's chunked matmul form with the same
    chunk size (:func:`_wkv_chunk_size`), so the chunk boundaries, and how
    the ``exp(-L)`` factors behave inside a chunk, match JAX's.

On a mesh both mixers read their weights whole on every rank of a
``model`` line (``tp.whole``, gathered inside the layer) and compute as on
one device: their tensor parallelism is ROADMAP item 18 part 2.

Simplifications vs the released checkpoints (kept from the JAX package):
  * RG-LRU input/recurrence gates are per-channel (diagonal) rather than
    block-diagonal linear — same data-dependent gating structure.
  * RWKV6 group-norm over heads is RMS-per-head.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import tp

F32 = torch.float32
_LRU_C = 8.0


# ===========================================================================
# RG-LRU recurrent block (Griffin)
# ===========================================================================

def rglru_init(gen, cfg: ModelConfig, dtype, device) -> L.Params:
    d, w, cw = cfg.d_model, cfg.lru_width, cfg.conv_width
    s = 0.02
    # Lambda init so that a in (0.9, 0.999) at sigma(r)=0.5 (Griffin app. A)
    a_param = L.uniform(gen, (w,), device, 0.9, 0.999)
    if gen is not None:
        with torch.no_grad():
            a_param.copy_(torch.log(torch.expm1(
                -torch.log(a_param) / (_LRU_C * 0.5))))
    return L.Params(
        wx=L.normal(gen, (d, w), dtype, device, s),       # x branch
        wg=L.normal(gen, (d, w), dtype, device, s),       # gelu gate
        wo=L.normal(gen, (w, d), dtype, device, s / math.sqrt(2)),
        conv=L.normal(gen, (cw, w), dtype, device, s),
        a_param=a_param,                                  # Λ
        wa=L.normal(gen, (w,), F32, device, s),           # recurrence gate
        ba=L.full((w,), 0.0, device),
        wi=L.normal(gen, (w,), F32, device, s),           # input gate
        bi=L.full((w,), 0.0, device))


def make_rglru_state(cfg: ModelConfig, batch: int, dtype,
                     device="cuda") -> dict:
    w, cw = cfg.lru_width, cfg.conv_width
    return {"h": torch.zeros((batch, w), dtype=F32, device=device),
            "conv": torch.zeros((batch, cw - 1, w), dtype=dtype,
                                device=device)}


def _lru_coeffs(p: L.Params, u: torch.Tensor):
    """Data-dependent decay a_t and scaled input b_t from branch input u."""
    u32 = u.float()
    r = torch.sigmoid(u32 * p.wa + p.ba)
    i = torch.sigmoid(u32 * p.wi + p.bi)
    log_a = -_LRU_C * torch.nn.functional.softplus(p.a_param) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u32)
    return a, b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, in log2(S)
    steps: after the step of offset d each element holds the composition
    of the (up to) 2d elements ending at it."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_apply(p: L.Params, x: torch.Tensor, cfg: ModelConfig, *,
                state: dict | None = None, update_state: bool = False):
    """x: (B, S, d). Train/prefill when state is None or S>1 (parallel
    scan over time); decode when S==1 with a carried state."""
    p = tp.whole(p)
    b, s, d = x.shape
    cw = cfg.conv_width
    u = L.dot(x, p.wx)
    gate = torch.nn.functional.gelu(L.dot(x, p.wg).float(),
                                    approximate="tanh")

    # causal depthwise conv, width cw
    if state is None:
        upad = torch.nn.functional.pad(u, (0, 0, cw - 1, 0))
    else:
        upad = torch.cat([state["conv"].to(u.dtype), u], dim=1)
    conv = sum(upad[:, i:i + s, :] * p.conv[i][None, None, :]
               for i in range(cw))

    a, bt = _lru_coeffs(p, conv)
    if s == 1 and state is not None:
        h = a[:, 0] * state["h"] + bt[:, 0]
        hseq = h[:, None, :]
    else:
        if state is not None:  # fold the initial state into the first term
            bt = torch.cat([bt[:, :1] + a[:, :1] * state["h"][:, None],
                            bt[:, 1:]], dim=1)
        hseq = _linear_scan(a, bt)
        h = hseq[:, -1, :]

    y = (hseq * gate).to(x.dtype)
    out = L.dot(y, p.wo)
    new_state = None
    if update_state:
        tail = upad[:, upad.shape[1] - (cw - 1):, :]
        new_state = {"h": h, "conv": tail}
    return out, new_state


# ===========================================================================
# RWKV-v6 (Finch)
# ===========================================================================

def rwkv_init(gen, cfg: ModelConfig, dtype, device) -> L.Params:
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.rwkv_head_dim
    nh = d // hd
    s = 0.02
    lora = 64
    return L.Params(
        # time mix
        mu=L.uniform(gen, (5, d), device),              # shift mix r,k,v,w,g
        wr=L.normal(gen, (d, d), dtype, device, s),
        wk=L.normal(gen, (d, d), dtype, device, s),
        wv=L.normal(gen, (d, d), dtype, device, s),
        wg=L.normal(gen, (d, d), dtype, device, s),
        wo=L.normal(gen, (d, d), dtype, device, s / math.sqrt(2)),
        w0=L.full((d,), -5.0, device),                  # base decay
        wa=L.normal(gen, (d, lora), F32, device, s),    # decay LoRA
        wb=L.normal(gen, (lora, d), F32, device, s),
        u=L.normal(gen, (nh, hd), F32, device, s),      # bonus
        # channel mix
        cmu=L.uniform(gen, (2, d), device),
        ck=L.normal(gen, (d, ff), dtype, device, s),
        cv=L.normal(gen, (ff, d), dtype, device, s / math.sqrt(2)),
        cr=L.normal(gen, (d, d), dtype, device, s))


def make_rwkv_state(cfg: ModelConfig, batch: int, dtype,
                    device="cuda") -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    nh = d // hd
    return {"tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "S": torch.zeros((batch, nh, hd, hd), dtype=F32, device=device)}


def _token_shift(x, prev):
    """x_{t-1} along the sequence; ``prev`` is the carry for decode."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :]
    shifted = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1, :]
    if prev is not None:
        shifted[:, 0, :] = prev
    return shifted


def _wkv_chunk_size(s: int) -> int:
    # chunk large enough that the chunk COUNT stays <= 64 (JAX's choice)
    target = max(64, s // 64)
    for c in (target, 64, 32, 16, 8, 4, 2, 1):
        if s % c == 0:
            return c
    return 1


def _wkv_chunked(r, k, v, w, u, S0):
    """Chunked (matmul-form) WKV recurrence.

    Within a chunk of C tokens the recurrence
        S_t = diag(w_t) S_{t-1} + k_t v_t^T ;  y_t = r_t (S_{t-1} + u k_t v_t^T)
    unrolls to one (C,dk)x(dk,dv) inter-chunk matmul + one causal (C,C)
    intra-chunk attention matmul, using cumulative log-decays relative to
    the chunk start; a loop over chunks carries S.

    r,k,v,w: (B, S, H, D) f32 (w = per-channel decay in (0,1)); u: (H, D).
    Returns (S_final, y) with y (B, S, H, D).
    """
    b, s, h, d = r.shape
    c = _wkv_chunk_size(s)
    n = s // c
    rc, kc, vc, wc = (t.reshape(b, n, c, h, d).permute(1, 0, 3, 2, 4)
                      for t in (r, k, v, w))          # (n, b, h, c, d)
    logw = torch.log(torch.clamp(wc, min=1e-38))      # (n, b, h, c, d)
    # L_i = sum_{j<=i} log w_j within the chunk (inclusive cumulative decay)
    Lc = torch.cumsum(logw, dim=3)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                        diagonal=-1)                  # strictly lower
    S = S0
    ys = []
    for j in range(n):
        rj, kj, vj, Lj, lwj = rc[j], kc[j], vc[j], Lc[j], logw[j]
        a_in = torch.exp(Lj - lwj)  # decay from chunk start to t-1 (excl. t)
        r_t = rj * a_in
        k_t = kj * torch.exp(-Lj)
        # inter-chunk: r_t S (state from previous chunks)
        inter = torch.einsum("bhcd,bhdv->bhcv", r_t, S)
        # intra-chunk: causal scores + bonus diagonal
        scores = torch.einsum("bhid,bhjd->bhij", r_t, k_t)
        scores = torch.where(causal[None, None], scores, 0.0)
        diag = torch.einsum("bhcd,hd,bhcd->bhc", rj, u, kj)
        intra = torch.einsum("bhij,bhjv->bhiv", scores, vj) + \
            diag[..., None] * vj
        # state to the next chunk: S_C = diag(A_C) S + sum_j (A_C/A_j) k_j v_j^T
        decay_all = torch.exp(Lj[:, :, -1, :])        # (b, h, d)
        k_hat = kj * torch.exp(Lj[:, :, -1:, :] - Lj)  # (b, h, c, d)
        S = S * decay_all[..., :, None] + \
            torch.einsum("bhcd,bhcv->bhdv", k_hat, vj)
        ys.append(inter + intra)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, d)
    return S, y


def rwkv_time_mix(p: L.Params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: dict | None = None):
    p = tp.whole(p)
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    nh = d // hd
    prev = state["tm_x"] if state is not None else None
    xs = _token_shift(x, prev)

    def mix(i):
        m = p.mu[i].to(x.dtype)
        return x * m + xs * (1 - m)

    r = L.dot(mix(0), p.wr).reshape(b, s, nh, hd)
    k = L.dot(mix(1), p.wk).reshape(b, s, nh, hd)
    v = L.dot(mix(2), p.wv).reshape(b, s, nh, hd)
    g = L.dot(mix(4), p.wg)
    # data-dependent decay (Finch): w_t = exp(-exp(w0 + tanh(x A) B))
    dd = torch.tanh(torch.matmul(mix(3).float(), p.wa))
    dd = torch.matmul(dd, p.wb) + p.w0
    w = torch.exp(-torch.exp(dd)).reshape(b, s, nh, hd)     # in (0,1)

    r32, k32, v32 = (t.float() for t in (r, k, v))
    u = p.u
    S0 = state["S"] if state is not None else \
        torch.zeros((b, nh, hd, hd), dtype=F32, device=x.device)

    if s == 1:  # decode: single recurrence step
        rt, kt, vt, wt = (t[:, 0] for t in (r32, k32, v32, w))
        kv = kt[..., :, None] * vt[..., None, :]
        out = torch.einsum("bhk,bhkv->bhv", rt,
                           S0 + u[None, :, :, None] * kv)
        S = wt[..., :, None] * S0 + kv
        y = out[:, None].reshape(b, 1, nh, hd)
    else:
        S, y = _wkv_chunked(r32, k32, v32, w, u, S0)

    # per-head RMS norm, then gate and output proj
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    y = (y.reshape(b, s, d) *
         torch.nn.functional.silu(g.float())).to(x.dtype)
    out = L.dot(y, p.wo)
    new_state = {"tm_x": x[:, -1, :], "S": S}
    return out, new_state


def rwkv_channel_mix(p: L.Params, x: torch.Tensor, *,
                     state: dict | None = None):
    p = tp.whole(p)
    prev = state["cm_x"] if state is not None else None
    xs = _token_shift(x, prev)
    mk = p.cmu[0].to(x.dtype)
    mr = p.cmu[1].to(x.dtype)
    xk = x * mk + xs * (1 - mk)
    xr = x * mr + xs * (1 - mr)
    h = torch.relu(L.dot(xk, p.ck))
    h = h * h
    r = torch.sigmoid(L.dot(xr, p.cr).float())
    out = r.to(x.dtype) * L.dot(h, p.cv)
    return out, {"cm_x": x[:, -1, :]}
