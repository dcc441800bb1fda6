"""Meta-device arguments and sharding specs for every LM dry-run cell: the
JAX package's ``launch/specs.py``.

``input_specs(arch, shape_name, mesh)`` returns ``(fn, kwargs, specs)``
such that ``fn(**kwargs)`` runs the exact (architecture x input-shape x
mesh) cell as the rank of ``mesh`` at ``mesh.coords`` runs it, with every
argument on the meta device (shapes and dtypes, no storage).  ``mesh`` is
a :class:`~repro_torch.launch.mesh.RecordingMesh`, so a 256- or 512-rank
mesh runs in one process.  ``specs`` holds the port's ``state_specs``,
``batch_specs`` and ``cache_specs`` of the arguments: what JAX would
place (and ``held_caches``: the caches' specs as the port holds them).

What the port runs (the dry-run record's ``program`` and ``storage``):

* train: ``make_train_step(cfg, opt, mesh=, compute_dtype=bf16)`` on this
  rank's blocks of the f32 state (``init_train_state(..., mesh=)``, laid
  out as ``state_specs`` say) and the global batch, whose rows the step
  splits over the batch axes: tensor-parallel over ``model``, each layer
  gathered over ``data`` before use (``parallel/tp.py``);
* prefill and decode: ``make_prefill_step``/``make_decode_step(...,
  mesh=)`` on this rank's blocks of the bf16 parameters, its rows of the
  batch (``dp_axes_for``) and caches of its rows and, where the KV heads
  divide ``model``, its heads (``steps.held_cache_specs``).

JAX's ``init_params(..., bfloat16)`` leaves its output projections in
f32 (each is drawn in bf16, then scaled by a float64 NumPy std, which
promotes it), so the serving parameters here hold ``wo``, ``wd`` and
``cv`` in f32 too: the arguments JAX's dry-run lowers.
"""

from __future__ import annotations

import math

import torch

from repro_torch import configs
from repro_torch.models import convert
from repro_torch.models import encdec as ED
from repro_torch.models import steps as S
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import sharding as shd

BF16 = torch.bfloat16
META = "meta"
# the leaves JAX's bf16 init leaves in f32 (output projections)
F32_OUTPUT_PROJECTIONS = ("wo", "wd", "cv")


def _batch_struct(cfg: ModelConfig, shape: ShapeConfig, *, seq: int,
                  batch: int, dtype) -> dict:
    """The batch of ``batch`` rows of ``seq`` positions, on the meta
    device: an encoder-decoder's frames at ``min(seq, encoder_seq_len)``,
    a vlm's prefix embeddings in front of ``seq`` less their count of
    tokens.  Token ids are int64 (torch indexes with them), JAX's int32."""
    def empty(*s, dt=dtype):
        return torch.empty(s, dtype=dt, device=META)

    out = {}
    if cfg.is_encdec:
        enc_len = min(seq, cfg.encoder_seq_len or seq)
        out["tokens"] = empty(batch, seq, dt=torch.int64)
        out["frames"] = empty(batch, enc_len, cfg.d_model)
    elif cfg.num_prefix_embeds:
        out["tokens"] = empty(batch, seq - cfg.num_prefix_embeds,
                              dt=torch.int64)
        out["prefix_embeds"] = empty(batch, cfg.num_prefix_embeds,
                                     cfg.d_model)
    else:
        out["tokens"] = empty(batch, seq, dt=torch.int64)
    return out


def skip_reason(arch: str, shape_name: str) -> str | None:
    """Cells skipped by design (recorded in DESIGN.md / EXPERIMENTS.md)."""
    cfg = configs.get(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 524k dense attention is O(S^2); "
                "long-context decode runs only for ssm/hybrid families")
    return None


def rows_for(mesh, batch: int) -> int:
    """This rank's rows of a ``batch``-row batch: the batch over the
    product of ``dp_axes_for``'s axes (all of it when they do not
    divide it)."""
    dp = S.dp_axes_for(mesh, batch)
    return batch // math.prod(mesh.shape[a] for a in dp) if dp else batch


def serving_params(cfg: ModelConfig):
    """The bf16 inference copy on the meta device, its output projections
    in f32 as JAX's bf16 init leaves them."""
    model = S.model_module(cfg).init_params(cfg, None, dtype=BF16,
                                            device=META)
    for name, p in model.named_parameters():
        if convert.jax_path(cfg, name)[0][-1] in F32_OUTPUT_PROJECTIONS:
            p.data = torch.empty(p.shape, dtype=torch.float32, device=META)
    return model


def init_caches(cfg: ModelConfig, shape: ShapeConfig, batch: int):
    """Empty decode caches of ``batch`` rows and ``shape.seq_len`` slots in
    bf16 on the meta device; an encoder-decoder's cross K/V at
    ``min(encoder_seq_len, seq_len)`` positions (JAX's ``enc_len``)."""
    if cfg.is_encdec:
        enc_len = min(cfg.encoder_seq_len or shape.seq_len, shape.seq_len)
        return ED.init_caches(cfg, batch, shape.seq_len, enc_len, BF16,
                              device=META)
    return S.model_module(cfg).init_caches(cfg, batch, shape.seq_len, BF16,
                                           device=META)


def input_specs(arch: str, shape_name: str, mesh,
                cfg: ModelConfig | None = None):
    """``(fn, kwargs, specs)`` for one cell, as this rank of ``mesh`` runs
    it.  ``cfg`` overrides the registry config (reduced-depth cost passes,
    the perf ladders' overrides)."""
    cfg = cfg or configs.get(arch)
    shape = SHAPES[shape_name]

    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
        state = S.init_train_state(cfg, None, opt_cfg, device=META,
                                   mesh=mesh)
        batch = _batch_struct(cfg, shape, seq=shape.seq_len,
                              batch=shape.global_batch, dtype=BF16)
        fn = S.make_train_step(cfg, opt_cfg, mesh=mesh, compute_dtype=BF16)

        def train_step(state, batch):
            return fn(state, batch)

        return train_step, {"state": state, "batch": batch}, {
            "state": S.state_specs(cfg, state),
            "batch": S.batch_specs(cfg, batch, mesh)}

    # serving: this rank's blocks of the bf16 inference copy
    params = serving_params(cfg)
    p_spec = S.state_specs(cfg, {"params": params})["params"]
    S.shard_model(cfg, params, mesh)

    if shape.kind == "prefill":
        batch = _batch_struct(cfg, shape, seq=shape.seq_len,
                              batch=shape.global_batch, dtype=BF16)
        rows = rows_for(mesh, shape.global_batch)
        local = {k: v[:rows] for k, v in batch.items()}
        fn = S.make_prefill_step(cfg, cache_len=shape.seq_len, mesh=mesh,
                                 compute_dtype=BF16)

        def prefill_step(params, batch):
            return fn(params, batch)

        return prefill_step, {"params": params, "batch": local}, {
            "params": p_spec, "batch": S.batch_specs(cfg, batch, mesh)}

    if shape.kind == "decode":
        rows = rows_for(mesh, shape.global_batch)
        with shd.set_mesh(mesh):      # this rank's KV heads
            caches = init_caches(cfg, shape, rows)
        tokens = torch.empty((rows, 1), dtype=torch.int64, device=META)
        # the whole cache attended: every slot is read whatever pos is
        pos = shape.seq_len - 1
        fn = S.make_decode_step(cfg, mesh=mesh, compute_dtype=BF16)

        def decode_step(params, caches, tokens, pos):
            return fn(params, caches, tokens, pos)

        glob = init_caches(cfg, shape, shape.global_batch)
        whole = torch.empty((shape.global_batch, 1), dtype=torch.int64,
                            device=META)
        return decode_step, {"params": params, "caches": caches,
                             "tokens": tokens, "pos": pos}, {
            "params": p_spec, "caches": S.cache_specs(cfg, glob, mesh),
            "held_caches": S.held_cache_specs(cfg, glob, mesh),
            "tokens": S.batch_specs(cfg, {"tokens": whole}, mesh)["tokens"],
            "pos": ()}

    raise ValueError(shape.kind)
