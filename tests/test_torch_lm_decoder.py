"""The port's LM serving path against the JAX package's, decoder-only
attention families: dense (glm4-9b, yi-9b, gemma-7b, nemotron-4-340b),
vlm (pixtral-12b, with its prefix embeddings) and moe (qwen3-moe,
qwen2-moe), at their smoke configs on the CPU.

JAX's parameter tree goes through ``params_from_jax``; the same numpy
inputs go through JAX's jitted prefill and teacher-forced decode steps and
the port's (tests/torch_lm_twins.py).  Bars: the logits of every step
within 1e-5 of the JAX step's largest |logit| (f32; both sum the same
products in other orders), and the greedy tokens equal wherever JAX's
top-2 gap exceeds 1e-3.  The component twins of tests/test_models.py
(decode against forward, the MoE capacity paths, ``stack_plan``) run on
the port alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_twins as tw
from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import steps as JS
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import moe as tmoe
from repro_torch.models import steps as TS
from repro_torch.models import transformer as ttf
import torch_one_thread  # noqa: F401  (one intra-op thread)

ARCHS = ["glm4-9b", "yi-9b", "gemma-7b", "nemotron-4-340b", "pixtral-12b",
         "qwen3-moe-235b-a22b", "qwen2-moe-a2.7b"]
ATTN_BAR = 1e-5


@pytest.fixture(scope="module")
def runs():
    """One JAX/port serving twin per architecture, shared by the tests."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = tw.serve_twins(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_logits_match_jax(arch, runs):
    """Prefill (the prompt's last position) and 8 teacher-forced decode
    steps: every step's logits within 1e-5 of JAX's largest |logit|."""
    tw.check_logits(runs(arch), ATTN_BAR)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_match_jax(arch, runs):
    """The argmax of every step equals JAX's where JAX's top-2 gap exceeds
    1e-3 (and most steps have such a gap)."""
    held = tw.check_greedy(runs(arch))
    assert held >= (tw.G + 1) * tw.B // 2, held


def test_bf16_compute_matches_jax():
    """bf16 activations (JAX's step factories' default) on f32 weights,
    glm4-9b, prefill + 4 steps.  Bar 2e-2 of the largest |logit|: both
    round activations to bf16 (2^-8 relative) after each op, but XLA may
    keep an elementwise chain in f32 between roundings where torch rounds
    after every op, so single roundings differ by a bf16 ulp and travel
    through two layers and the logit projection."""
    run = tw.serve_twins("glm4-9b", dtype="bfloat16", steps=4)
    worst = tw.check_logits(run, 2e-2)
    assert worst > 0  # bf16 is not f32: the bar is not vacuous


@pytest.mark.parametrize("arch", ["glm4-9b", "gemma-7b", "pixtral-12b",
                                  "qwen2-moe-a2.7b"])
def test_decode_matches_forward(arch):
    """prefill(S) + decode(1) == forward(S+1) at the last position, within
    1e-5 of the largest |logit|.  qwen2-moe runs with capacity factor E/k
    (capacity = the group): decoding never drops a token, forward could."""
    cfg, model, _, _ = tw.port_model(arch, seed=3)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.padded / cfg.moe.top_k))
    err, scale = tw.decode_vs_forward(cfg, model, seed=4)
    assert err <= ATTN_BAR * scale, (err, scale)


def _moe_layer(seed: int = 0) -> dict:
    """qwen2-moe smoke's first MoE layer as numpy (routed experts padded
    6 -> 8, a shared expert)."""
    tree = tw.np_tree(jconfigs.get_smoke("qwen2-moe-a2.7b"), seed)
    return jax.tree.map(lambda a: a[0], tree["segments"][0]["b0"]["moe"])


def _port_moe(layer: dict) -> L.Params:
    def conv(node):
        if isinstance(node, dict):
            return L.Params(**{k: conv(v) for k, v in node.items()})
        return torch.nn.Parameter(torch.from_numpy(np.array(node)),
                                  requires_grad=False)
    return conv(layer)


def _jax_moe(cfg, layer: dict, x: np.ndarray):
    y, aux = jax.jit(lambda p_, x_: jmoe.moe_apply(p_, x_, cfg))(
        jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    return np.asarray(y), float(aux["load_balance_loss"])


def _with_moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


def _dropped(cfg, p, x) -> int:
    """Tokens past an expert's capacity, counted from the routing alone."""
    m = cfg.moe
    b, s, _ = x.shape
    g, sg = (b, s) if cfg.moe_dispatch_shard else (1, b * s)
    cap = int(np.ceil(m.capacity_factor * m.top_k * sg / m.padded))
    cap = max(4, -(-cap // 4) * 4)
    logits = torch.from_numpy(x).reshape(g, sg, -1) @ p.router
    logits[..., m.num_experts:] = -1e30
    topi = torch.topk(torch.softmax(logits, -1), m.top_k, -1).indices
    cnt = torch.nn.functional.one_hot(topi, m.padded).sum(dim=(1, 2))
    return int((cnt - cap).clamp(min=0).sum())


def test_moe_capacity_drops_tokens_as_jax():
    """Capacity factor 0.1: at least one token is dropped, the output is
    finite and differs from ample capacity, and it and the load-balance
    loss equal JAX's moe_apply on the same layer and batch within 1e-6 of
    the largest entry."""
    layer = _moe_layer()
    p = _port_moe(layer)
    jtiny = _with_moe(jconfigs.get_smoke("qwen2-moe-a2.7b"),
                      capacity_factor=0.1)
    ttiny = _with_moe(tconfigs.get_smoke("qwen2-moe-a2.7b"),
                      capacity_factor=0.1)
    x = np.random.default_rng(5).standard_normal(
        (2, 32, ttiny.d_model)).astype(np.float32)
    assert _dropped(ttiny, p, x) >= 1
    yj, lbj = _jax_moe(jtiny, layer, x)
    yt, aux = tmoe.moe_apply(p, torch.from_numpy(x), ttiny)
    assert bool(torch.isfinite(yt).all())
    assert float(np.abs(yt.numpy() - yj).max()) <= 1e-6 * np.abs(yj).max()
    assert abs(float(aux["load_balance_loss"]) - lbj) <= 1e-6 * abs(lbj)
    y_full, _ = tmoe.moe_apply(p, torch.from_numpy(x),
                               tconfigs.get_smoke("qwen2-moe-a2.7b"))
    assert float((y_full - yt).abs().max()) > 1e-6


def test_moe_grouped_matches_global_dispatch():
    """Per-sequence capacity groups change only capacity-drop boundaries:
    with capacity factor 4 the grouped and global dispatch agree within
    1e-5, and the global form equals JAX's global form within 1e-6 of
    its largest entry."""
    layer = _moe_layer()
    p = _port_moe(layer)
    big = _with_moe(tconfigs.get_smoke("qwen2-moe-a2.7b"),
                    capacity_factor=4.0)
    glob = dataclasses.replace(big, moe_dispatch_shard=False)
    x = np.random.default_rng(6).standard_normal(
        (3, 16, big.d_model)).astype(np.float32)
    y1, _ = tmoe.moe_apply(p, torch.from_numpy(x), big)
    y0, _ = tmoe.moe_apply(p, torch.from_numpy(x), glob)
    assert float((y1 - y0).abs().max()) < 1e-5
    jglob = dataclasses.replace(
        _with_moe(jconfigs.get_smoke("qwen2-moe-a2.7b"), capacity_factor=4.0),
        moe_dispatch_shard=False)
    yj, _ = _jax_moe(jglob, layer, x)
    assert float(np.abs(y0.numpy() - yj).max()) <= 1e-6 * np.abs(yj).max()


def test_stack_plan_matches_jax():
    """The port's depth plan is JAX's for every full and smoke config, and
    covers the depth (recurrentgemma-9b's 38 layers: 12 x (rec, rec,
    attn) + a (rec, rec) tail)."""
    for arch in jconfigs.all_arch_names():
        for get in ("get", "get_smoke"):
            jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
            if jc.is_encdec:
                continue
            plan = ttf.stack_plan(tc)
            assert plan == jtf.stack_plan(jc), arch
            assert sum(len(p) * c for p, c in plan) == tc.num_layers
            assert len(ttf.layer_slots(tc)) == tc.num_layers
    assert ttf.stack_plan(tconfigs.get("recurrentgemma-9b")) == [
        (("rec", "rec", "attn"), 12), (("rec", "rec"), 1)]


@pytest.mark.parametrize("arch", jconfigs.all_arch_names())
def test_configs_match_jax(arch):
    """The port's copies of the hyperparameters equal JAX's, full and
    smoke, with the same reckoned parameter counts."""
    for get in ("get", "get_smoke"):
        jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.padded_vocab == jc.padded_vocab
    assert tconfigs.CANON == jconfigs.CANON
    assert tconfigs.all_arch_names() == jconfigs.all_arch_names()


@pytest.mark.parametrize("arch", jconfigs.all_arch_names())
def test_init_shapes_and_dtypes_match_jax(arch):
    """The port's init_params has JAX's leaves and shapes, f32 and bf16
    weights: every JAX leaf is one port parameter, unstacked over depth,
    and ``params_from_jax`` carries each leaf's dtype.  The dtypes are
    JAX's, but for one quirk of the reference kept out of the port: with
    bf16 weights JAX's output projections (``wo``, ``wd``, ``cv``) come
    out f32 (their std ``s / np.sqrt(2)`` is a strong f64 scalar), where
    the port keeps them bf16 as asked."""
    jc, tc = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        shapes = jax.eval_shape(
            lambda k: JS.model_module(jc).init_params(jc, k, jd),
            jax.random.PRNGKey(0))
        gen = torch.Generator().manual_seed(0)
        mine = dict(TS.model_module(tc).init_params(
            tc, gen, dtype=td, device="cpu").named_parameters())
        tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        back = dict(convert.params_from_jax(tc, tree,
                                            device="cpu").named_parameters())
        assert back.keys() == mine.keys()
        for name, p in back.items():
            path, idx = convert.jax_path(tc, name)
            leaf = shapes
            for key in path:
                leaf = leaf[key]
            assert str(p.dtype).removeprefix("torch.") == str(leaf.dtype)
            assert mine[name].shape == p.shape, name
            quirk = td == torch.bfloat16 and path[-1] in ("wo", "wd", "cv")
            assert mine[name].dtype == (td if quirk else p.dtype), name


@pytest.mark.parametrize("arch", ["glm4-9b", "gemma-7b", "nemotron-4-340b",
                                  "qwen2-moe-a2.7b", "pixtral-12b"])
def test_init_laws_match_jax(arch):
    """The port's init draws from JAX's laws (tests/torch_lm_twins.py::
    init_laws_match): attention, swiglu / geglu / squared-relu MLPs,
    routed and shared experts with router and gate, tied and untied
    embeddings, zero norms."""
    assert tw.init_laws_match(arch) >= 10
