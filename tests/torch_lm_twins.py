"""Shared by the LM serving twins (tests/test_torch_lm_*.py): one JAX
parameter tree per architecture, carried into the port with
``repro_torch.models.convert.params_from_jax``, and the same numpy inputs
through JAX's serving steps and the port's.

The tree has the structure, shapes and dtypes of JAX's own
``init_params`` (``jax.eval_shape``); its values are drawn with numpy
from the same laws (normals of std 0.02, uniform mixes, the RG-LRU Λ
formula), except that the norm scales and biases JAX starts at 0 get small
random values, so that ``(1 + scale)`` is exercised.  Drawing with
numpy instead of ``jax.random`` keeps the CPU suite's clock: JAX's
initialisation costs 3-17 s an architecture on one core.
"""

from __future__ import annotations

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import steps as JS
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import steps as TS

B, P, G = 2, 20, 8      # requests, prompt (past the hybrid smoke window 16),
#                         teacher-forced decode steps
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def np_tree(cfg, seed: int):
    """JAX's parameter tree for ``cfg`` with numpy-drawn values."""
    shapes = jax.eval_shape(
        functools.partial(JS.model_module(cfg).init_params, cfg),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("mu", "cmu"):
            v = rng.uniform(size=leaf.shape)
        elif name == "a_param":
            lam = rng.uniform(0.9, 0.999, size=leaf.shape)
            v = np.log(np.expm1(-np.log(lam) / 4.0))
        elif name == "w0":
            v = -5.0 + 0.5 * rng.standard_normal(leaf.shape)
        elif name.startswith("ln") or name.endswith("norm") or \
                name in ("ba", "bi"):
            v = 0.1 * rng.standard_normal(leaf.shape)
        else:
            v = 0.02 * rng.standard_normal(leaf.shape)
        return np.asarray(v).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def np_inputs(cfg, seed: int, seq: int, batch: int = B) -> dict:
    """Tokens (batch, seq) and the family's frames / prefix embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq))
           .astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = (0.02 * rng.standard_normal(
            (batch, 12, cfg.d_model))).astype(np.float32)
    if cfg.num_prefix_embeds:
        out["prefix_embeds"] = (0.02 * rng.standard_normal(
            (batch, cfg.num_prefix_embeds, cfg.d_model))).astype(np.float32)
    return out


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def port_model(arch: str, seed: int = 0):
    """(port config, port model on the CPU, JAX config, numpy tree)."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    tree = np_tree(jcfg, seed)
    return tcfg, convert.params_from_jax(tcfg, tree, device="cpu"), jcfg, \
        tree


def serve_twins(arch: str, dtype: str = "float32", steps: int = G) -> dict:
    """JAX's jitted prefill + ``steps`` teacher-forced decode steps against
    the port's on the same weights and inputs: the f32 logits of each
    step (prefill's last position first) from both."""
    tcfg, model, jcfg, tree = port_model(arch)
    jparams = jax.tree.map(jnp.asarray, tree)
    pre = jcfg.num_prefix_embeds
    inp = np_inputs(jcfg, 1, P + steps)
    toks = inp["tokens"]
    jb = {k: jnp.asarray(v) for k, v in inp.items()}
    jb["tokens"] = jb["tokens"][:, :P]
    tb = to_torch(inp)
    tb["tokens"] = tb["tokens"][:, :P]
    cache_len = pre + P + steps
    jpre = jax.jit(JS.make_prefill_step(jcfg, cache_len=cache_len,
                                        compute_dtype=_JAX[dtype]))
    jdec = jax.jit(JS.make_decode_step(jcfg, compute_dtype=_JAX[dtype]))
    tpre = TS.make_prefill_step(tcfg, cache_len=cache_len,
                                compute_dtype=_TORCH[dtype])
    tdec = TS.make_decode_step(tcfg, compute_dtype=_TORCH[dtype])
    v = jcfg.vocab_size     # past it: the padding, masked to -1e30 by both
    jl, jc = jpre(jparams, jb)
    tl, tc = tpre(model, tb)
    jax_logits = [np.asarray(jl[:, -1, :v])]
    port_logits = [tl[:, -1, :v].numpy()]
    for i in range(steps):
        tok = toks[:, P + i:P + i + 1]
        _, jl, jc = jdec(jparams, jc, jnp.asarray(tok),
                         jnp.asarray(pre + P + i, jnp.int32))
        _, tl, tc = tdec(model, tc, torch.from_numpy(tok).long(),
                         pre + P + i)
        jax_logits.append(np.asarray(jl[:, -1, :v]))
        port_logits.append(tl[:, -1, :v].numpy())
    return {"jax": jax_logits, "port": port_logits}


def check_logits(run: dict, bar: float):
    """Each step's port logits within ``bar`` x the JAX step's largest
    |logit|; returns the worst ratio."""
    worst = 0.0
    for i, (j, t) in enumerate(zip(run["jax"], run["port"])):
        scale = float(np.abs(j).max())
        err = float(np.abs(j - t).max())
        assert err <= bar * scale, f"step {i}: {err} > {bar} x {scale}"
        worst = max(worst, err / scale)
    return worst


def check_greedy(run: dict, gap: float = 1e-3) -> int:
    """The port's argmax equals JAX's wherever JAX's top-2 gap exceeds
    ``gap``; returns how many (step, request) pairs were held."""
    held = 0
    for i, (j, t) in enumerate(zip(run["jax"], run["port"])):
        top2 = np.sort(j, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > gap
        assert np.array_equal(np.argmax(j, -1)[sure],
                              np.argmax(t, -1)[sure]), f"step {i}"
        held += int(sure.sum())
    return held


def decode_vs_forward(cfg, model, seed: int, seq: int = 32):
    """The port's prefill(seq) + decode(1) logits against its forward over
    seq + 1 tokens at the last position: (max-abs error, largest
    |logit|)."""
    mod = TS.model_module(cfg)
    inp = to_torch(np_inputs(cfg, seed, seq + 1))
    toks = inp.pop("tokens")
    pre = cfg.num_prefix_embeds
    full, _ = mod.forward(cfg, model, toks, **inp)
    _, caches = mod.prefill(cfg, model, toks[:, :seq], cache_len=pre + seq + 4,
                            **inp)
    ld, _ = mod.decode_step(cfg, model, toks[:, seq:], pre + seq, caches)
    return (float((full[:, -1] - ld[:, 0]).abs().max()),
            float(full[:, -1, :cfg.vocab_size].abs().max()))


def jax_init_laws(cfg):
    """JAX's ``init_params`` of ``cfg`` run with its random draws replaced:
    ``normal`` gives ones and ``uniform`` an evenly spaced sample of its
    interval, so each normal leaf holds the standard deviation JAX's code
    scales it by, a constant leaf its constant, and a uniform-derived leaf
    (RWKV's mixes, RG-LRU's Λ) a deterministic sample of its law.  (A real
    JAX init costs 7-17 s an architecture on one core: it compiles its
    random number generator for every leaf shape.)"""
    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.ones(shape, dtype)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        n = int(np.prod(shape))
        grid = (np.arange(n) + 0.5) / n
        return jnp.asarray((minval + (maxval - minval) * grid)
                           .reshape(shape), dtype)

    def split(key, num=2):
        return jnp.zeros((num, 2), jnp.uint32)

    with mock.patch.object(jax.random, "normal", normal), \
            mock.patch.object(jax.random, "uniform", uniform), \
            mock.patch.object(jax.random, "split", split):
        return JS.model_module(cfg).init_params(cfg, jax.random.PRNGKey(0))


def init_laws_match(arch: str, seed: int = 0) -> int:
    """The port's ``init_params`` (real draws) against :func:`jax_init_laws`
    leaf by leaf (port layers stacked back over depth): equal shape and
    dtype; a constant port leaf equal to JAX's; a normal leaf's mean
    within 6 standard errors of 0 and its standard deviation within 6 of
    JAX's scale; a uniform-derived leaf's mean and standard deviation
    within 6 standard errors of JAX's sample's.  Returns the leaves held."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jtree = jax_init_laws(jcfg)
    gen = torch.Generator().manual_seed(seed)
    model = TS.model_module(tcfg).init_params(tcfg, gen, device="cpu")
    stacked: dict = {}
    for name, p in model.named_parameters():
        path, idx = convert.jax_path(tcfg, name)
        stacked.setdefault(path, {})[idx] = p.detach()
    for path, parts in stacked.items():
        node = jtree
        for key in path:
            node = node[key]
        j = np.asarray(node, dtype=np.float64)
        t = (torch.stack([parts[i] for i in sorted(parts)])
             if None not in parts else parts[None])
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(node.dtype), path
        t = t.double().numpy()
        n = t.size
        if t.std() == 0:                    # zeros, the base decay
            assert np.array_equal(t, j), path
        elif j.std() == 0:                  # a normal leaf: j is its scale
            scale = j.flat[0]
            assert abs(t.mean()) <= 6 * scale / np.sqrt(n), path
            assert abs(t.std() - scale) <= 6 * scale / np.sqrt(2 * n), \
                (path, t.std(), scale)
        else:                               # uniform-derived
            se = j.std() / np.sqrt(n)
            assert abs(t.mean() - j.mean()) <= 6 * se, path
            assert abs(t.std() - j.std()) <= 6 * se, (path, t.std(), j.std())
    return len(stacked)
