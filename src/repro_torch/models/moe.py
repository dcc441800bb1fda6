"""Mixture-of-Experts layer: token-choice top-k routing with capacity,
scatter/gather dispatch (no O(N·E·C) one-hot tensors), optional shared
expert (qwen2-moe style) (PyTorch).

``num_experts_padded`` rounds the expert count up (e.g. qwen2's 60 -> 64,
so the experts divide the JAX package's ``model`` mesh axis); pads are
masked out of routing.  There is no expert parallelism and no all-to-all:
on a mesh the router and the experts are read whole on every rank of a
``model`` line (``tp.whole``, gathered inside the layer) and computed
there as on one device (the JAX package's ``constrain_experts`` is
ROADMAP item 18 part 2); the shared expert is a dense MLP and takes the
tensor-parallel path (``layers.mlp_apply``), as JAX's rules give it the
``wu``/``wg``/``wd`` specs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tp

F32 = torch.float32


def moe_init(gen, cfg: ModelConfig, dtype, device) -> L.Params:
    m = cfg.moe
    d, de, e = cfg.d_model, m.d_expert, m.padded
    s = 0.02
    p = L.Params(router=L.normal(gen, (d, e), F32, device, s),
                 wg=L.normal(gen, (e, d, de), dtype, device, s),
                 wu=L.normal(gen, (e, d, de), dtype, device, s),
                 wd=L.normal(gen, (e, de, d), dtype, device,
                             s / math.sqrt(2)))
    if m.shared_d_ff:
        p.shared = L.mlp_init(gen, d, m.shared_d_ff, "swiglu", dtype, device)
        p.shared_gate = L.normal(gen, (d,), F32, device, s)
    return p


def moe_apply(p: L.Params, x: torch.Tensor, cfg: ModelConfig):
    """Token-choice top-k with PER-SEQUENCE capacity groups (GShard-style);
    ``cfg.moe_dispatch_shard=False`` takes a single global group.

    A token's priority for an expert's ``cap`` slots is its position in
    the group (an exclusive cumsum); tokens past capacity are sent to the
    stripped slot ``e * cap`` and contribute nothing.

    Returns (out, aux) with aux = {"load_balance_loss": scalar}.

    On a mesh whose step splits the batch rows over ranks
    (``sharding.data_parallel()``), ``x`` holds this rank's rows and the
    loss is this rank's share of the global batch's: the routed fractions
    f_e come from the counts summed over the batch axes (an all-reduce),
    the mean probabilities from this rank's own probabilities over the
    global position count, so the shares of the ranks of a group sum to
    the global loss and each share's gradient is its rows' part of the
    global gradient.  The single global group of
    ``moe_dispatch_shard=False`` is not reproduced across ranks: that
    case raises ``ValueError`` naming the flag.
    """
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.padded, m.top_k
    p = tp.whole(p, ("moe",))
    mesh, dp = shd.data_parallel()
    if mesh is not None and not cfg.moe_dispatch_shard:
        raise ValueError(
            "moe_dispatch_shard=False takes one capacity group over the "
            f"whole batch; its rows are split over the mesh axes {dp}, so "
            "set moe_dispatch_shard=True or do not split the batch")
    if cfg.moe_dispatch_shard:
        g, sg = b, s                       # one capacity group per sequence
    else:
        g, sg = 1, b * s                   # single global group
    cap = int(math.ceil(m.capacity_factor * k * sg / e))
    cap = max(4, -(-cap // 4) * 4)
    dev = x.device

    xg = x.reshape(g, sg, d)
    logits = torch.einsum("gsd,de->gse", xg.float(), p.router.float())
    if e != m.num_experts:  # mask padded experts out of routing
        pad_mask = torch.arange(e, device=dev) >= m.num_experts
        logits = torch.where(pad_mask[None, None, :], L.NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)                # (g, sg, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)

    # position-in-expert by token priority within the group
    sel = torch.nn.functional.one_hot(topi, e)               # (g, sg, k, e)
    cnt = sel.sum(dim=2)                                     # (g, sg, e)
    cum = torch.cumsum(cnt, dim=1) - cnt                     # exclusive
    pos = torch.gather(cum, 2, topi)                         # (g, sg, k)
    keep = pos < cap

    # dispatch INDICES (no token duplication): slot -> source position
    flat = torch.where(keep, topi * cap + pos, e * cap).reshape(g, sg * k)
    src = torch.arange(sg, device=dev)[None, :, None].expand(g, sg, k)
    idxbuf = torch.full((g, e * cap + 1), sg, dtype=torch.int64, device=dev)
    # kept tokens own distinct slots; only the stripped slot e*cap takes
    # duplicate indices, where CUDA's scatter writes in no fixed order.
    # That column is cut off on the next line, so the order never reaches
    # the output.
    idxbuf.scatter_(1, flat, src.reshape(g, sg * k))
    idxbuf = idxbuf[:, :-1]                                  # (g, e*cap)

    xpad = torch.cat([xg, torch.zeros((g, 1, d), dtype=x.dtype, device=dev)],
                     dim=1)
    buf = torch.gather(xpad, 1, idxbuf[..., None].expand(-1, -1, d))
    buf = buf.reshape(g, e, cap, d).float()

    # expert FFN (gated), batched over experts
    h = torch.nn.functional.silu(
        torch.einsum("gecd,edf->gecf", buf, p.wg.float()))
    h = h.to(x.dtype) * torch.einsum("gecd,edf->gecf", buf,
                                     p.wu.float()).to(x.dtype)
    out_buf = torch.einsum("gecf,efd->gecd", h.float(),
                           p.wd.float()).to(x.dtype)

    out_buf = torch.cat(
        [out_buf.reshape(g, e * cap, d),
         torch.zeros((g, 1, d), dtype=x.dtype, device=dev)], dim=1)
    gathered = torch.gather(out_buf, 1, flat[..., None].expand(-1, -1, d))
    w = (topv * keep).to(x.dtype).reshape(g, sg * k)
    yt = (gathered * w[..., None]).reshape(g, sg, k, d).sum(dim=2)

    if hasattr(p, "shared"):
        gate = torch.sigmoid(torch.einsum("gsd,d->gs", xg.float(),
                                          p.shared_gate.float()))
        yt = yt + L.mlp_apply(p.shared, xg, "swiglu") * \
            gate[..., None].to(x.dtype)

    # GShard load-balance aux loss: E * sum_e f_e * P_e
    if mesh is None:
        f = cnt.float().mean(dim=(0, 1))       # fraction routed
        pbar = probs.mean(dim=(0, 1))
    else:  # this rank's share of the global batch's loss
        shards = math.prod(mesh.shape[a] for a in dp)
        n = g * sg * shards
        f = mesh.psum(cnt.sum(dim=(0, 1)), axes=dp,
                      kind="moe_all_reduce").float() / n
        pbar = probs.sum(dim=(0, 1)) / n
    lb = m.num_experts * torch.sum(f * pbar)
    return yt.reshape(b, s, d), {"load_balance_loss": lb}
