"""Encoder-decoder transformer backbone (seamless-m4t-large-v2) (PyTorch).

The speech frontend is a STUB, as in the JAX package: the encoder consumes
pre-computed frame embeddings (B, Se, d).  The decoder is a causal
transformer with per-layer cross attention over the encoder output;
decoding carries a self-attention KV cache per layer plus the
prefill-computed cross-attention K/V.  JAX scans the stacked layers; the
port loops over ``encoder`` and ``decoder`` module lists, and checkpoints
each layer while training where JAX remats the scan's body
(:func:`layers.remat`).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.lattice import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

F32 = torch.float32


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _enc_layer_init(gen, cfg, dtype, device) -> L.Params:
    d = cfg.d_model
    return L.Params(ln1=L.full((d,), 0.0, device),
                    ln2=L.full((d,), 0.0, device),
                    attn=B.attn_init(gen, cfg, dtype, device),
                    mlp=L.mlp_init(gen, d, cfg.d_ff, cfg.mlp, dtype, device))


def _dec_layer_init(gen, cfg, dtype, device) -> L.Params:
    d = cfg.d_model
    return L.Params(ln1=L.full((d,), 0.0, device),
                    lnx=L.full((d,), 0.0, device),
                    ln2=L.full((d,), 0.0, device),
                    attn=B.attn_init(gen, cfg, dtype, device),
                    xattn=B.cross_attn_init(gen, cfg, dtype, device),
                    mlp=L.mlp_init(gen, d, cfg.d_ff, cfg.mlp, dtype, device))


def init_params(cfg: ModelConfig, gen: torch.Generator | None,
                dtype=torch.float32, device="cuda") -> L.Params:
    """``embed``, ``enc_norm``, ``final_norm``, ``encoder`` and ``decoder``
    (one block per layer), JAX's init distributions drawn from ``gen``
    (``gen=None``: uninitialised) on ``device``."""
    device = resolve_device(device)
    d = cfg.d_model
    return L.Params(
        embed=L.embed_init(gen, cfg.vocab_size, d, dtype,
                           cfg.tie_embeddings,
                           padded_vocab=cfg.padded_vocab, device=device),
        enc_norm=L.full((d,), 0.0, device),
        final_norm=L.full((d,), 0.0, device),
        encoder=nn.ModuleList(_enc_layer_init(gen, cfg, dtype, device)
                              for _ in range(cfg.encoder_layers)),
        decoder=nn.ModuleList(_dec_layer_init(gen, cfg, dtype, device)
                              for _ in range(cfg.num_layers)))


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, model: L.Params, frames: torch.Tensor,
           compute_dtype=torch.float32) -> torch.Tensor:
    """frames: (B, Se, d) stub frontend embeddings -> encoder output."""
    h = frames.to(compute_dtype)
    body = L.remat(cfg, model, _enc_layer)
    for lp in model.encoder:
        h = body(cfg, lp, h)
    return L.rms_norm(h, model.enc_norm)


def _enc_layer(cfg, lp, h):
    a, _ = B.attn_apply(lp.attn, L.rms_norm(h, lp.ln1), cfg, pos0=0,
                        window=0, cache=None, causal=False)
    h = h + a
    return h + L.mlp_apply(lp.mlp, L.rms_norm(h, lp.ln2), cfg.mlp)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _dec_layer(cfg, lp, h, *, pos0, enc_out, sc, cc, update_cache: bool):
    a, nsc = B.attn_apply(lp.attn, L.rms_norm(h, lp.ln1), cfg, pos0=pos0,
                          window=0, cache=sc, update_cache=update_cache)
    h = h + a
    x, ncc = B.cross_attn_apply(lp.xattn, L.rms_norm(h, lp.lnx), enc_out,
                                cfg, cache=cc, update_cache=update_cache)
    h = h + x
    h = h + L.mlp_apply(lp.mlp, L.rms_norm(h, lp.ln2), cfg.mlp)
    return h, nsc, ncc


def _dec_stack(cfg, model, h, *, pos0, enc_out, self_caches, cross_caches,
               update_cache: bool):
    if self_caches is None and not update_cache:  # the training forward
        body = L.remat(cfg, model, _dec_layer)
        for lp in model.decoder:
            h, _, _ = body(cfg, lp, h, pos0=pos0, enc_out=enc_out, sc=None,
                           cc=None, update_cache=False)
        return h, None
    new_self, new_cross = [], []
    for i, lp in enumerate(model.decoder):
        cc = cross_caches[i] if cross_caches is not None else None
        h, nsc, ncc = _dec_layer(cfg, lp, h, pos0=pos0, enc_out=enc_out,
                                 sc=self_caches[i], cc=cc,
                                 update_cache=update_cache)
        new_self.append(nsc)
        new_cross.append(ncc)
    return h, ((new_self, new_cross) if update_cache else None)


def forward(cfg: ModelConfig, model: L.Params, tokens, *, frames,
            compute_dtype=torch.float32):
    """Encoder over frames, causal decoder over tokens: full-sequence
    logits (f32) + aux losses (zero here)."""
    enc_out = encode(cfg, model, frames, compute_dtype)
    h = L.embed_lookup(model.embed, tokens, compute_dtype)
    h, _ = _dec_stack(cfg, model, h, pos0=0, enc_out=enc_out,
                      self_caches=None, cross_caches=None,
                      update_cache=False)
    h = L.rms_norm(h, model.final_norm)
    return L.logits_out(model.embed, h, cfg.vocab_size), {
        "load_balance_loss": torch.zeros((), dtype=F32, device=h.device)}


def prefill(cfg: ModelConfig, model: L.Params, tokens, *, frames,
            cache_len: int, compute_dtype=torch.float32):
    """Encode + run the decoder prompt; returns (logits, caches) where
    caches = (self_kv, cross_kv), one dict per decoder layer each (the
    cross K/V computed from the encoder output here)."""
    b, s = tokens.shape
    enc_out = encode(cfg, model, frames, compute_dtype)
    self_c = [B.make_kv_cache(cfg, b, cache_len, compute_dtype,
                              device=tokens.device)
              for _ in range(cfg.num_layers)]
    h = L.embed_lookup(model.embed, tokens, compute_dtype)
    h, caches = _dec_stack(cfg, model, h, pos0=0, enc_out=enc_out,
                           self_caches=self_c, cross_caches=None,
                           update_cache=True)
    h = L.rms_norm(h[:, -1:], model.final_norm)
    return L.logits_out(model.embed, h, cfg.vocab_size), caches


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, enc_len: int,
                dtype=torch.float32, device="cuda") -> tuple:
    """``(self_kv, cross_kv)`` as :func:`prefill` returns them, empty: one
    dict a decoder layer each, the self-attention K/V of ``cache_len``
    slots and the cross-attention K/V of ``enc_len`` encoder positions
    (the dry-run's decode input; JAX's ``encdec.init_caches``)."""
    device = resolve_device(device)
    self_c = [B.make_kv_cache(cfg, batch, cache_len, dtype, device=device)
              for _ in range(cfg.num_layers)]
    shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
    cross_c = [{"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
               for _ in range(cfg.num_layers)]
    return self_c, cross_c


def decode_step(cfg: ModelConfig, model: L.Params, tokens, pos: int, caches,
                *, compute_dtype=torch.float32):
    self_c, cross_c = caches
    h = L.embed_lookup(model.embed, tokens, compute_dtype)
    h, caches = _dec_stack(cfg, model, h, pos0=int(pos), enc_out=None,
                           self_caches=self_c, cross_caches=cross_c,
                           update_cache=True)
    h = L.rms_norm(h, model.final_norm)
    return L.logits_out(model.embed, h, cfg.vocab_size), caches
