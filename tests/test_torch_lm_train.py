"""The port's LM training step against the JAX package's, at the smoke
configs on the CPU: gradients of ``loss_fn`` for all ten architectures,
the chunked attention's backward (an ``autograd.Function`` in the port, a
``custom_vjp`` in JAX), one AdamW ``train_step``, the bf16 compute copy's
leaf set, remat, and the optimizer and schedule twins of
tests/test_steps_and_ckpt.py.

Trees and inputs are numpy-drawn and shared (tests/torch_lm_twins.py);
the port computes in f32 unless a test says otherwise.  Bars: a gradient
leaf passes when its max-abs difference is at most bar x max(the leaf's
largest |g|, 1e-3 x the tree's largest |g|), with bar 1e-5 for the
attention families and 1e-4 for hybrid and ssm: the forward bars of the
LM serving twins (both packages sum the same products in other orders,
and the recurrent scans combine in other trees).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_twins as tw
from repro.models import layers as jlayers
from repro.models import steps as JS
from repro.optim import AdamWConfig as JAdamW
from repro.optim import clip_by_global_norm as jclip_by_global_norm
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import encdec as ted
from repro_torch.models import layers as L
from repro_torch.models import steps as TS
from repro_torch.models import transformer as ttf
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, warmup_cosine)
import torch_one_thread  # noqa: F401  (one intra-op thread)

ARCHS = tconfigs.all_arch_names()
BARS = {"hybrid": 1e-4, "ssm": 1e-4}
OPT = dict(lr=1e-3, weight_decay=0.01)   # tests/test_steps_and_ckpt.py's
SEQ = 24


def bar_for(cfg) -> float:
    return BARS.get(cfg.family, 1e-5)


def flat(tree) -> dict:
    """{JAX path string: numpy leaf}."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def check_tree(got: dict, want: dict, bar: float, what: str) -> float:
    """Every leaf of ``got`` within bar x max(the leaf's largest |value|,
    1e-3 x the tree's largest) of ``want``'s; returns the worst ratio."""
    assert got.keys() == want.keys(), what
    big = max(float(np.abs(w).max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        scale = max(float(np.abs(w).max()), 1e-3 * big)
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= bar * scale, f"{what} {k}: {err} > {bar} x {scale}"
        worst = max(worst, err / scale)
    return worst


def graph_nodes(t: torch.Tensor) -> set:
    """The class names of the autograd nodes ``t`` was computed through."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


def port_grads(tcfg, model, batch, compute_dtype=torch.float32):
    """(loss, {name: gradient}) of the port's loss_fn with respect to its
    compute copy, as ``make_train_step`` takes them."""
    cmodel = TS.cast_compute(tcfg, model, compute_dtype)
    loss, _ = TS.loss_fn(tcfg, cmodel, batch, compute_dtype)
    names, leaves = zip(*cmodel.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """One batch's loss and every gradient leaf of ``loss_fn`` against
    ``jax.value_and_grad(loss_fn)`` on the same tree (f32 compute)."""
    tcfg, model, jcfg, tree = tw.port_model(arch)
    inp = tw.np_inputs(jcfg, 2, SEQ)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JS.loss_fn(jcfg, p, b, jnp.float32), has_aux=True))
    (jloss, _), jgrads = vg(jax.tree.map(jnp.asarray, tree),
                            {k: jnp.asarray(v) for k, v in inp.items()})
    loss, grads = port_grads(tcfg, model, tw.to_torch(inp))
    bar = bar_for(tcfg)
    assert abs(float(loss) - float(jloss)) <= bar * abs(float(jloss))
    check_tree(flat(convert.params_to_jax(tcfg, grads.items())),
               flat(jgrads), bar, arch)


def test_flash_attention_backward_matches_jax_custom_vjp():
    """The gradient half of tests/test_models.py::test_flash_attention_vs_dense
    on the port: q, k, v gradients of the chunked attention (chunk 16 over
    48 keys, windows 0 and 12) against JAX's custom VJP on the same
    inputs, within 5e-5; the backward is the Function's, which saves no
    chunk's scores."""
    b, sq, skv, hq, hkv, hd = 2, 16, 48, 8, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, hq, hd), (b, skv, hkv, hd),
                         (b, skv, hkv, hd)))
    qp, kp = np.arange(32, 32 + sq), np.arange(skv)
    for window in (0, 12):
        def jf(*a):
            return jlayers.attention(*a, q_pos=jnp.asarray(qp),
                                     kv_pos=jnp.asarray(kp), window=window,
                                     chunk=16).sum()
        jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = L.attention(tq, tk, tv, q_pos=torch.from_numpy(qp),
                          kv_pos=torch.from_numpy(kp), window=window,
                          chunk=16)
        nodes = graph_nodes(out)
        assert "_FlashBackward" in nodes and "ExpBackward0" not in nodes, \
            nodes
        out.sum().backward()
        for name, a, t in zip("qkv", jg, (tq, tk, tv)):
            err = float(np.abs(np.asarray(a) - t.grad.numpy()).max())
            assert err < 5e-5, (window, name, err)


@pytest.mark.parametrize("window", [0, 2])
def test_flash_attention_gradcheck_float64(window):
    """``torch.autograd.gradcheck`` of the attention's Function in float64
    (the forward and backward compute in float64 for float64 inputs):
    3 queries over 5 keys padded to chunks of 2 (one masked slot), GQA
    group 2."""
    gen = torch.Generator().manual_seed(window)
    q = torch.randn((1, 3, 2, 4), generator=gen, dtype=torch.float64)
    k = torch.randn((1, 5, 1, 4), generator=gen, dtype=torch.float64)
    v = torch.randn((1, 5, 1, 4), generator=gen, dtype=torch.float64)
    qp, kp = torch.arange(2, 5), torch.arange(5)

    def f(q, k, v):
        return L.attention(q, k, v, q_pos=qp, kv_pos=kp, window=window,
                           chunk=2)
    assert torch.autograd.gradcheck(
        f, tuple(t.requires_grad_() for t in (q, k, v)))


def _jax_state(tree):
    jparams = jax.tree.map(jnp.asarray, tree)
    return {"params": jparams, "opt": jadamw_init(jparams, JAdamW(**OPT))}


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2-moe-a2.7b"])
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step (f32 compute) on a shared tree against
    JAX's: the metrics, the moments m and v and the step within the
    gradient bar.  The new parameters within the gradient bar carried
    through the update: Adam's first step moves each entry by
    lr g / (|g| + eps), so a gradient entry within the bar (delta) of
    JAX's may move the parameter by up to lr eps delta / (|g| - delta +
    eps)^2 (at most 2 lr, a sign), which exceeds the bar where |g| is
    below ~1e-6 (glm4: 4.6e-4 of the leaf's scale at worst; |g| is taken
    at the port's gradients, held within the bar of JAX's above).  The
    optimizer alone, JAX's ``adamw_update`` given the port's gradients,
    is held to the bar at every entry."""
    tcfg, model, jcfg, tree = tw.port_model(arch)
    inp = tw.np_inputs(jcfg, 3, SEQ)
    jb = {k: jnp.asarray(v) for k, v in inp.items()}
    jstate = _jax_state(tree)
    jnew, jmet = jax.jit(JS.make_train_step(
        jcfg, JAdamW(**OPT), compute_dtype=jnp.float32))(jstate, jb)
    state = convert.train_state_from_jax(
        tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    _, grads = port_grads(tcfg, state["params"], tw.to_torch(inp))
    new, met = TS.make_train_step(tcfg, AdamWConfig(**OPT),
                                  compute_dtype=torch.float32)(
        state, tw.to_torch(inp))
    bar = bar_for(tcfg)
    assert met.keys() == jmet.keys()
    for key in ("loss", "grad_norm", "load_balance_loss"):
        assert abs(float(met[key]) - float(jmet[key])) <= \
            bar * max(abs(float(jmet[key])), 1e-3), key
    assert int(met["step"]) == int(jmet["step"]) == 1
    got = convert.train_state_to_jax(tcfg, new)
    assert int(got["opt"]["step"]) == int(jnew["opt"]["step"])
    for part in ("m", "v"):
        check_tree(flat(got["opt"][part]), flat(jnew["opt"][part]), bar,
                   part)
    # the parameters: the gradient bar carried through the update (at the
    # port's gradients, within the bar of JAX's: the test above)
    lr, eps = OPT["lr"], JAdamW().eps
    gj = flat(convert.params_to_jax(tcfg, grads.items()))
    pj, pt = flat(jnew["params"]), flat(got["params"])
    gbig = max(float(np.abs(g).max()) for g in gj.values())
    pbig = max(float(np.abs(p).max()) for p in pj.values())
    for key, g in gj.items():
        delta = bar * max(float(np.abs(g).max()), 1e-3 * gbig)
        pscale = max(float(np.abs(pj[key]).max()), 1e-3 * pbig)
        room = np.minimum(2.0, eps * delta / (
            np.maximum(np.abs(g) - delta, 0.0) + eps) ** 2)
        err = np.abs(pt[key].astype(np.float64) - pj[key])
        assert (err <= bar * pscale + lr * room).all(), key
    # the optimizer alone: JAX's update of the port's gradients
    jp2, jopt2, _ = jadamw_update(
        jstate["params"],
        jax.tree.map(jnp.asarray, convert.params_to_jax(tcfg, grads.items())),
        jstate["opt"], JAdamW(**OPT))
    check_tree(pt, flat(jp2), bar, "params given the port's gradients")
    check_tree(flat(got["opt"]["v"]), flat(jopt2["v"]), bar, "v")


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_compute_casts_jax_leaf_set(arch):
    """The leaves ``cast_compute`` casts to bf16 are exactly the ones JAX's
    casts (its sharding rules at the stacked leaf's ndim), and the others
    share the master's storage."""
    tcfg, model, jcfg, tree = tw.port_model(arch)
    jcast = JS.cast_compute(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    want = {k for k, v in flat(jcast).items() if v.dtype.name == "bfloat16"}
    cmodel = TS.cast_compute(tcfg, model, torch.bfloat16)
    master = dict(model.named_parameters())
    got = set()
    for name, p in cmodel.named_parameters():
        assert p.requires_grad and p.is_leaf, name
        if p.dtype == torch.bfloat16:
            path, _ = convert.jax_path(tcfg, name)
            got.add(jax.tree_util.keystr(tuple(
                jax.tree_util.SequenceKey(k) if isinstance(k, int)
                else jax.tree_util.DictKey(k) for k in path)))
        else:
            assert p.data_ptr() == master[name].data_ptr(), name
    assert got == want and want, (sorted(got ^ want))


def test_grad_compression_is_bf16():
    """Twin of tests/test_steps_and_ckpt.py::test_grad_compression_is_bf16:
    with bf16 compute a weight's gradient is bf16 (taken with respect to
    the bf16 copy) and a norm scale's stays f32."""
    tcfg, model, jcfg, _ = tw.port_model("glm4-9b")
    _, grads = port_grads(tcfg, model,
                          tw.to_torch(tw.np_inputs(jcfg, 0, 16)),
                          torch.bfloat16)
    assert grads["layers.0.attn.wq"].dtype == torch.bfloat16
    assert grads["layers.0.ln1"].dtype == torch.float32
    assert all(torch.isfinite(g.float()).all() for g in grads.values())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_remat_recomputes_each_period_and_keeps_gradients(arch, monkeypatch):
    """With ``cfg.remat`` each pattern period (recurrentgemma: rec, rec,
    attn; seamless: an encoder or decoder layer) runs twice in a training
    step, once in the forward and once recomputed in the backward, and the
    loss and gradients are bitwise those without remat; serving (frozen
    parameters) runs each once."""
    tcfg, model, jcfg, _ = tw.port_model(arch)
    batch = tw.to_torch(tw.np_inputs(jcfg, 4, SEQ))
    calls = []
    if tcfg.is_encdec:
        names = ("_enc_layer", "_dec_layer")
        mod, per_pass = ted, tcfg.encoder_layers + tcfg.num_layers
    else:
        names = ("_period",)
        mod, per_pass = ttf, len(ttf._periods(tcfg, model))
    for name in names:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, **k: (
            calls.append(1), _fn(*a, **k))[1])
    runs = {}
    for remat in (True, False):
        calls.clear()
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss, grads = port_grads(cfg, model, batch)
        runs[remat] = (loss, grads, len(calls))
    assert runs[True][2] == 2 * per_pass and runs[False][2] == per_pass
    assert torch.equal(runs[True][0], runs[False][0])
    for name, g in runs[True][1].items():
        assert torch.equal(g, runs[False][1][name]), name
    calls.clear()
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    TS.model_module(tcfg).forward(tcfg, model, batch["tokens"], **extra)
    assert len(calls) == per_pass


def test_adamw_moment_dtype_knob():
    """Twin of tests/test_steps_and_ckpt.py::test_adamw_moment_dtype_knob:
    bf16 moments stay bf16 through an update, the master stays f32; the
    step's values and ``clip_by_global_norm`` against JAX's."""
    p = {"w": torch.zeros((4, 4))}
    st = adamw_init(p, AdamWConfig(moment_dtype="bfloat16"))
    assert st["m"]["w"].dtype == torch.bfloat16
    g = {"w": torch.ones((4, 4))}
    newp, newst, gn = adamw_update(p, g, st,
                                   AdamWConfig(moment_dtype="bfloat16"))
    assert newst["m"]["w"].dtype == torch.bfloat16
    assert newp["w"].dtype == torch.float32
    assert float(gn) > 0
    # and the values are JAX's: one step on the same inputs
    jp, jst, jgn = jadamw_update(
        {"w": jnp.zeros((4, 4))}, {"w": jnp.ones((4, 4))},
        jadamw_init({"w": jnp.zeros((4, 4))},
                    JAdamW(moment_dtype="bfloat16")),
        JAdamW(moment_dtype="bfloat16"))
    np.testing.assert_array_equal(
        newst["m"]["w"].float().numpy(),
        np.asarray(jst["m"]["w"]).astype(np.float32))
    np.testing.assert_allclose(newp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)
    assert abs(float(gn) - float(jgn)) <= 1e-6 * float(jgn)
    # the clip alone: JAX's scale, each leaf rounded back to its dtype
    grads = {"a": torch.full((3,), 2.0), "b": torch.full((2,), 1.5,
                                                        dtype=torch.bfloat16)}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    jclipped, jnorm = jclip_by_global_norm(
        {"a": jnp.full((3,), 2.0), "b": jnp.full((2,), 1.5, jnp.bfloat16)},
        1.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-7)
    assert clipped["b"].dtype == torch.bfloat16
    for k in grads:
        np.testing.assert_array_equal(
            clipped[k].float().numpy(),
            np.asarray(jclipped[k]).astype(np.float32))


def test_warmup_cosine_shape():
    """Twin of tests/test_steps_and_ckpt.py::test_warmup_cosine_shape, and
    the schedule equal to JAX's within 1e-7 at every step 0-99."""
    s = warmup_cosine(0, warmup=10, total=100)
    e = warmup_cosine(99, warmup=10, total=100)
    m = warmup_cosine(10, warmup=10, total=100)
    assert float(s) == 0.0 and float(m) == pytest.approx(1.0, abs=0.01)
    assert float(e) < 0.2
    steps = np.arange(100)
    want = np.asarray(jwarmup_cosine(jnp.asarray(steps), warmup=10,
                                     total=100))
    got = warmup_cosine(torch.from_numpy(steps), warmup=10,
                        total=100).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-7
