"""Mixed-precision AdamW (the port of the JAX package's
``optim/adamw.py``).

The same two-precision discipline:
  * master weights in f32 (the "high" type),
  * compute/gradient dtype bf16 (the "low" type),
  * m/v moments in a configurable dtype: f32 by default, bf16 for the
    340B-class configs.  The moment update still runs in f32; only the
    storage is narrowed.

A tree here is a dict of tensors keyed by parameter name (a model's
``dict(model.named_parameters())``).  Where JAX returns new trees, the
update writes the master weights and the moments in place, leaf by leaf:
an f32 copy of the whole model (or of one concatenated gradient) would
not fit beside a full-width model's state on one card, so only one
leaf's f32 temporaries live at a time.

On a mesh the trees hold each rank's blocks (``steps.state_specs``):
AdamW is elementwise, so it runs on the blocks as they are; only the
clip's global norm needs the mesh (:func:`global_norm`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.parallel import sharding as shd

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # "bfloat16" to halve optimizer memory


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    """``{"step": int32 0, "m": zeros, "v": zeros}``, the moments in
    ``cfg.moment_dtype`` on each parameter's device."""
    dt = getattr(torch, cfg.moment_dtype)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)
    return {"step": step,
            "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()}}


def _global_norm(grads: dict) -> torch.Tensor:
    gn2 = sum(torch.sum(torch.square(g.to(F32))) for g in grads.values())
    return torch.sqrt(gn2)


def global_norm(grads: dict, mesh=None, specs: dict | None = None):
    """The f32 norm of a gradient tree.  With ``mesh``, ``grads`` holds
    this rank's blocks (``specs``: each leaf's spec) and the norm is the
    whole tree's, the same on every rank: a leaf counts once, whatever
    its spec, because only the ranks at coordinate 0 of every axis its
    spec leaves whole add their block's squares before the all-reduce."""
    if mesh is None:
        return _global_norm(grads)
    gn2 = torch.zeros((), dtype=F32, device=mesh.device)
    for k, g in grads.items():
        named = shd.spec_axes(mesh, specs[k])
        if all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in named):
            gn2 = gn2 + torch.sum(torch.square(g.to(F32)))
    return torch.sqrt(mesh.psum(gn2, kind="norm_all_reduce"))


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled so their global f32 norm is at most ``max_norm``, each
    rounded back to its own dtype; the norm before clipping)."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return {k: (g.to(F32) * scale).to(g.dtype)
            for k, g in grads.items()}, gnorm


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict,
                 cfg: AdamWConfig, lr_scale=1.0, *, mesh=None,
                 specs: dict | None = None):
    """One AdamW step: global-norm clip, bias correction from the step
    count, decoupled weight decay on the f32 master.  ``params``: the f32
    master tensors; ``grads``: any dtype, same keys.  Writes ``params``
    and the moments in place and returns ``(params, opt_state,
    grad_norm)``.  On a mesh every tree holds this rank's blocks and
    ``specs`` their specs (:func:`global_norm`)."""
    step = opt_state["step"] + 1
    t = step.to(F32)
    gnorm = global_norm(grads, mesh, specs)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    bc1 = 1.0 - torch.tensor(cfg.b1, dtype=F32, device=t.device) ** t
    bc2 = 1.0 - torch.tensor(cfg.b2, dtype=F32, device=t.device) ** t
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=F32, device=t.device)
    for k, p in params.items():
        g, m, v = grads[k], opt_state["m"][k], opt_state["v"][k]
        g32 = g.to(F32) * scale
        if g.dtype != F32:  # the clipped gradient in its own dtype, as JAX
            g32 = g32.to(g.dtype).to(F32)
        # f32 leaves are updated in place; narrower ones through an f32 copy
        m32, v32, p32 = m.to(F32), v.to(F32), p.to(F32)
        m32.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v32.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        del g32
        upd = torch.div(v32, bc2).sqrt_().add_(cfg.eps)   # sqrt(vhat) + eps
        upd = torch.div(m32, bc1).div_(upd)               # mhat / (...)
        upd.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        p32.sub_(upd)
        del upd
        for dst, src in ((m, m32), (v, v32), (p, p32)):
            if dst is not src:
                dst.copy_(src)
    opt_state["step"] = step
    return params, opt_state, gnorm
