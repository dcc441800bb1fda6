"""The port's tensor parallelism over ``model`` (``parallel/tp.py``) with
one layer gathered over ``data`` at a time, in the mesh train step and the
mesh prefill/decode steps, against the port's one-device steps and the
JAX package's.

One spawn of four gloo ranks (CPU processes, one thread each, a
``file://`` rendezvous, 60 s process-group timeouts, a join deadline)
builds the 2x2 (``data``, ``model``), 1x4 and 2x1x2 (``pod``, ``data``,
``model``) meshes from the same ranks and computes every case; a JAX
subprocess of four fake CPU devices runs JAX's own sharded serving step
beside it.  Held here:

* (a) two f32 train steps of seven smoke architectures (glm4-9b,
  gemma-7b, nemotron-4-340b, recurrentgemma-9b, qwen2-moe, pixtral-12b,
  seamless) on each mesh against the port's one-device step: the
  metrics, and each rank's block of every first-step gradient leaf,
  within the gradient bars of tests/test_torch_lm_train.py; glm4-9b's
  first 2x2 step also against JAX's unsharded ``make_train_step``;
* (b) JAX's three attention cases, each asserted where it runs: KV heads
  over ``model`` (glm4-9b on 2x2), KV-head replication ``rep = 2``
  (glm4-9b on 1x4, prefill and training; its decode computes every
  head), the group axis over ``model`` (recurrentgemma-9b on 2x2,
  nemotron-4-340b on 1x4);
* (c) mesh prefill and four greedy decode steps in f32 on each mesh:
  tokens equal the one-device steps' and JAX's unsharded steps', logits
  within ROADMAP's LM-twin bars (1e-5 of the largest |logit|, 1e-4 for
  the hybrid); glm4-9b's on 2x2 also equal JAX's sharded serving step on
  four fake devices;
* (d) the partitioning is real: a rank's compute leaves are blocks, its
  traced matmul flops equal closed forms in each attention case (on 2x2
  half of the replicated program's), at most one layer's gathered
  weights and the embeddings are live in a forward whatever the depth,
  and the recording mesh (``launch/mesh.py::RecordingMesh``) tallies the
  calls and bytes, reduce-scatters included, that each gloo rank
  counted.

The file runs as a script for one rank of the spawn:
``python tests/test_torch_lm_tp.py <rank> <dir>``.
"""

import dataclasses
import datetime
import functools
import json
import math
import os
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401  (one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
WORLD = 4
PG_TIMEOUT = datetime.timedelta(seconds=60)
DEADLINE_S = 240                    # the spawn's join deadline
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
ARCHS = ("glm4-9b", "gemma-7b", "nemotron-4-340b", "recurrentgemma-9b",
         "qwen2-moe-a2.7b", "pixtral-12b", "seamless-m4t-large-v2")
# JAX's unsharded serving steps, one architecture of each kind
JAX_SERVED = ("glm4-9b", "recurrentgemma-9b", "seamless-m4t-large-v2")
BARS = {"hybrid": 1e-4, "ssm": 1e-4}   # tests/test_torch_lm_train.py's
OPT = dict(lr=1e-3, weight_decay=0.01)
SEQ, ROWS, DECODE = 24, 4, 4
# (arch, mesh) -> the attention cases its training and its serving run
CASES = {("glm4-9b", "2x2"): ({"kv"}, {"kv"}),
         ("glm4-9b", "1x4"): ({"rep"}, {"rep", "whole"}),
         ("recurrentgemma-9b", "2x2"): ({"group"}, {"group"}),
         ("nemotron-4-340b", "1x4"): ({"group"}, {"group"})}


def _bar(cfg) -> float:
    return BARS.get(cfg.family, 1e-5)


def _batches(cfg) -> list:
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(cfg, batch=ROWS, seq_len=SEQ, seed=1, device="cpu")
    return [data.batch_at(i) for i in range(2)]


def _model(cfg):
    from repro_torch.models import steps as S
    return S.model_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")


def _serve(cfg, model, mesh=None) -> tuple:
    """Prefill of batch 0 and DECODE greedy steps, f32: (tokens (B, 1 +
    DECODE), logits (B, 1 + DECODE, V)), this rank's rows on a mesh."""
    from repro_torch.models import steps as S
    batch = _batches(cfg)[0]
    if mesh is not None:
        batch = S.local_batch(cfg, batch, mesh)
    pre = S.make_prefill_step(cfg, cache_len=SEQ + 8, mesh=mesh,
                              compute_dtype=torch.float32)
    dec = S.make_decode_step(cfg, mesh=mesh, compute_dtype=torch.float32)
    pos = batch["tokens"].shape[1] + cfg.num_prefix_embeds
    with torch.no_grad():
        logits, caches = pre(model, batch)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks, lgs = [tok], [logits]
        for i in range(DECODE):
            tok, logits, caches = dec(model, caches, tok, pos + i)
            toks.append(tok)
            lgs.append(logits)
    return torch.cat(toks, dim=1), torch.cat(lgs, dim=1)


def _tally(mesh, before) -> dict:
    return {"counts": {k: v - before[0].get(k, 0)
                       for k, v in mesh.counts.items()
                       if v - before[0].get(k, 0)},
            "nbytes": {k: v - before[1].get(k, 0)
                       for k, v in mesh.nbytes.items()
                       if v - before[1].get(k, 0)}}


# ---------------------------------------------------------------------------
# One rank of the spawn
# ---------------------------------------------------------------------------

def _worker(rank: int, d: pathlib.Path):
    import torch.distributed as tdist

    from repro_torch import configs
    from repro_torch.core.distributed import Mesh
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import tp

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                             rank=rank, world_size=WORLD, timeout=PG_TIMEOUT)
    meshes = {name: Mesh(shape, axes, device="cpu", transport="gloo",
                         timeout=PG_TIMEOUT)
              for name, (shape, axes) in MESHES.items()}
    out = {"coords": {k: m.coords for k, m in meshes.items()}}
    opt = AdamWConfig(**OPT)
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        b0, b1 = _batches(cfg)
        for mname, mesh in meshes.items():
            res = {}
            state = S.init_train_state(cfg, torch.Generator().manual_seed(0),
                                       opt, device="cpu", mesh=mesh)
            specs = S.state_specs(cfg, state)["params"]
            tp.CASES.clear()
            loss, lb, grads = S.mesh_grads(cfg, state["params"], b0,
                                           torch.float32, mesh, specs)
            res["grads"] = {"loss": float(loss), "lb": float(lb)}
            res["train_cases"] = dict(tp.CASES)
            np.savez(d / f"g_{arch}_{mname}_{rank}.npz",
                     **{n: g.numpy() for n, g in grads.items()})
            del grads
            step = S.make_train_step(cfg, opt, mesh=mesh,
                                     compute_dtype=torch.float32)
            before = (dict(mesh.counts), dict(mesh.nbytes))
            for i, b in enumerate((b0, b1)):
                state, m = step(state, b)
                res[f"step{i}"] = {k: float(v) for k, v in m.items()}
                if i == 0 and arch == "glm4-9b":
                    np.savez(d / f"m_{arch}_{mname}_{rank}.npz",
                             **{n: t.numpy()
                                for n, t in state["opt"]["m"].items()})
            res["train_tally"] = _tally(mesh, before)
            model = S.shard_model(cfg, _model(cfg), mesh)
            tp.CASES.clear()
            before = (dict(mesh.counts), dict(mesh.nbytes))
            toks, logits = _serve(cfg, model, mesh)
            res["serve_tally"] = _tally(mesh, before)
            res["serve_cases"] = dict(tp.CASES)
            np.savez(d / f"s_{arch}_{mname}_{rank}.npz", tokens=toks.numpy(),
                     logits=logits.numpy())
            out[f"{arch}/{mname}"] = res
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# JAX's sharded serving step (a subprocess of four fake CPU devices)
# ---------------------------------------------------------------------------

_JAX_SHARDED = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.models import steps as JS
from repro.parallel import sharding as jshd
d, arch, seq, steps = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
cfg = configs.get_smoke(arch)
with np.load(f"{d}/jax_{arch}_params.npz") as f:
    flat = {k: f[k] for k in f.files}
tree = {}
for key, v in flat.items():
    node, parts = tree, key.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = v
def lists(n):
    if not isinstance(n, dict):
        return jnp.asarray(n)
    out = {k: lists(v) for k, v in n.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out
params = lists(tree)
with np.load(f"{d}/jax_{arch}_batch.npz") as f:
    tokens = jnp.asarray(f["tokens"], jnp.int32)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                      params, jshd.param_specs(params),
                      is_leaf=lambda x: isinstance(x, P))
pre = jax.jit(JS.make_prefill_step(cfg, cache_len=seq + 8, mesh=mesh,
                                   compute_dtype=jnp.float32))
dec = jax.jit(JS.make_decode_step(cfg, mesh=mesh, compute_dtype=jnp.float32))
logits, caches = pre(params, {"tokens": tokens})
tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
toks, lgs = [tok], [logits]
for i in range(steps):
    tok, logits, caches = dec(params, caches, tok, tokens.shape[1] + i)
    toks.append(tok)
    lgs.append(logits)
np.savez(f"{d}/jax_sharded_{arch}.npz",
         tokens=np.asarray(jnp.concatenate(toks, 1)),
         logits=np.asarray(jnp.concatenate(lgs, 1)))
print("DONE")
"""


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


# ---------------------------------------------------------------------------
# The spawn and the references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_lm_parallel import _finish, _start

    from repro_torch import configs
    from repro_torch.models import convert
    d = tmp_path_factory.mktemp("lm_tp")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    t0 = time.time()
    cfg = configs.get_smoke("glm4-9b")
    np.savez(d / "jax_glm4-9b_params.npz", **_flat(convert.params_to_jax(
        cfg, _model(cfg).named_parameters())))
    np.savez(d / "jax_glm4-9b_batch.npz",
             tokens=_batches(cfg)[0]["tokens"].numpy())
    procs = {
        "jax_sharded": _start([sys.executable, "-c", _JAX_SHARDED, str(d),
                               "glm4-9b", str(SEQ), str(DECODE)], env,
                              d / "jax_sharded.log"),
        **{f"rank{r}": _start([sys.executable, __file__, str(r), str(d)],
                              env, d / f"rank{r}.log") for r in range(WORLD)}}
    for arch in ARCHS:        # the references, while the ranks run
        _one_device(arch)
    for arch in JAX_SERVED:
        _jax_served(arch)
    _jax_glm4_step()
    rcs = _finish(procs, t0 + DEADLINE_S)
    logs = {n: (d / f"{n}.log").read_text() for n in procs}
    for name in procs:
        assert rcs[name] == 0, f"{name}: rc {rcs[name]}\n{logs[name][-4000:]}"
    return dict(d=d, ranks=[json.loads((d / f"rank{r}.json").read_text())
                            for r in range(WORLD)])


def _port_grads(cfg, model, batch):
    from repro_torch.models import steps as S
    cmodel = S.cast_compute(cfg, model, torch.float32)
    loss, aux = S.loss_fn(cfg, cmodel, batch, torch.float32)
    names, leaves = zip(*cmodel.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (float(loss.detach()), float(aux["load_balance_loss"].detach()),
            {n: g.numpy() for n, g in zip(names, grads)})


@functools.lru_cache(maxsize=None)
def _one_device(arch: str) -> dict:
    """The port's one-device references: batch 0's f32 gradients, the
    metrics of two f32 steps, and the served tokens and logits."""
    from repro_torch import configs
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    cfg = configs.get_smoke(arch)
    b0, b1 = _batches(cfg)
    opt = AdamWConfig(**OPT)
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0), opt,
                               device="cpu")
    out = {"grads": _port_grads(cfg, state["params"], b0)}
    step = S.make_train_step(cfg, opt, compute_dtype=torch.float32)
    out["metrics"] = []
    for b in (b0, b1):
        state, m = step(state, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    toks, logits = _serve(cfg, _model(cfg))
    out["tokens"], out["logits"] = toks.numpy(), logits.numpy()
    return out


@functools.lru_cache(maxsize=None)
def _jax_served(arch: str) -> dict:
    """JAX's unsharded prefill and DECODE greedy steps on the port's
    weights and batch 0 (f32)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import steps as JS

    from repro_torch import configs
    from repro_torch.models import convert
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    params = jax.tree.map(jnp.asarray, convert.params_to_jax(
        cfg, _model(cfg).named_parameters()))
    batch = {k: jnp.asarray(v.numpy(), jnp.int32 if k == "tokens" else None)
             for k, v in _batches(cfg)[0].items()}
    pre = jax.jit(JS.make_prefill_step(jcfg, cache_len=SEQ + 8,
                                       compute_dtype=jnp.float32))
    dec = jax.jit(JS.make_decode_step(jcfg, compute_dtype=jnp.float32))
    logits, caches = pre(params, batch)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks, lgs = [tok], [logits]
    pos = batch["tokens"].shape[1] + cfg.num_prefix_embeds
    for i in range(DECODE):
        tok, logits, caches = dec(params, caches, tok, pos + i)
        toks.append(tok)
        lgs.append(logits)
    return {"tokens": np.asarray(jnp.concatenate(toks, 1)),
            "logits": np.asarray(jnp.concatenate(lgs, 1))}


@functools.lru_cache(maxsize=None)
def _jax_glm4_step() -> dict:
    """JAX's unsharded jitted ``make_train_step`` (f32 compute) on the
    port's glm4-9b weights and batch 0: its metrics and m (the clipped
    gradient times 1 - b1), keyed by the port's names."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import steps as JS
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import adamw_init as jadamw_init

    from repro_torch import configs
    from repro_torch.models import convert
    cfg = configs.get_smoke("glm4-9b")
    jcfg = jconfigs.get_smoke("glm4-9b")
    jparams = jax.tree.map(jnp.asarray, convert.params_to_jax(
        cfg, _model(cfg).named_parameters()))
    jstate = {"params": jparams, "opt": jadamw_init(jparams, JAdamW(**OPT))}
    batch = {"tokens": jnp.asarray(_batches(cfg)[0]["tokens"].numpy(),
                                   jnp.int32)}
    jnew, jmet = jax.jit(JS.make_train_step(
        jcfg, JAdamW(**OPT), compute_dtype=jnp.float32))(jstate, batch)
    new = convert.train_state_from_jax(cfg, jax.tree.map(np.asarray, jnew),
                                       device="cpu")
    return {"metrics": {k: float(v) for k, v in jmet.items()},
            "m": {n: t.numpy() for n, t in new["opt"]["m"].items()}}


def _specs(cfg) -> dict:
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    return S.state_specs(cfg, S.init_train_state(
        cfg, None, AdamWConfig(), device="meta"))["params"]


def _shape(mesh: str):
    from repro_torch.launch.mesh import MeshShape
    shape, axes = MESHES[mesh]
    return MeshShape(dict(zip(axes, shape)), axes)


def _block(arr, spec, mesh: str, coords: dict):
    from repro_torch.parallel import sharding as shd
    return arr[shd.block_slices(_shape(mesh), spec, arr.shape, coords)]


def _rows(arr, mesh: str, coords: dict):
    """This rank's rows of a serving output (the batch over
    ``dp_axes_for``)."""
    from repro_torch.models import steps as S
    from repro_torch.parallel import sharding as shd
    m = _shape(mesh)
    spec = (shd.entry(S.dp_axes_for(m, arr.shape[0])),)
    return _block(arr, spec, mesh, coords)


def _check(got, want, scale, bar, what):
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= bar * scale, f"{what}: {err} > {bar} x {scale}"


TRAIN_CASES = [(a, m) for a in ARCHS for m in MESHES]


# ---------------------------------------------------------------------------
# (a) training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh", TRAIN_CASES)
def test_tp_train_matches_one_device(runs, arch, mesh):
    """Two f32 steps on the mesh: the loss, load-balance loss and grad
    norm of each within the bar of the one-device step's, the same on
    every rank; each rank's block of every first-step gradient leaf
    within the bar x max(the leaf's largest |g|, 1e-3 x the tree's) of
    the one-device gradient's block."""
    from repro_torch import configs
    cfg = configs.get_smoke(arch)
    bar = _bar(cfg)
    ref = _one_device(arch)
    loss, lb, grads = ref["grads"]
    res = [rk[f"{arch}/{mesh}"] for rk in runs["ranks"]]
    for key in ("grads", "step0", "step1"):
        assert all(r[key] == res[0][key] for r in res[1:]), (arch, key)
    assert abs(res[0]["grads"]["loss"] - loss) <= bar * abs(loss)
    assert abs(res[0]["grads"]["lb"] - lb) <= bar * max(abs(lb), 1e-3)
    for i in range(2):
        for key in ("loss", "grad_norm", "load_balance_loss"):
            w = ref["metrics"][i][key]
            got = res[0][f"step{i}"][key]
            assert abs(got - w) <= bar * max(abs(w), 1e-3), (i, key, got, w)
    specs = _specs(cfg)
    big = max(float(np.abs(g).max()) for g in grads.values())
    for r, rk in enumerate(runs["ranks"]):
        coords = rk["coords"][mesh]
        with np.load(runs["d"] / f"g_{arch}_{mesh}_{r}.npz") as f:
            assert set(f.files) == set(grads)
            for n, g in grads.items():
                want = _block(g, specs[n], mesh, coords)
                assert f[n].shape == want.shape, (n, r)
                _check(f[n], want, max(float(np.abs(g).max()), 1e-3 * big),
                       bar, f"{arch} {mesh} {n} rank {r}")


def test_glm4_tp_step_matches_jax_unsharded(runs):
    """glm4-9b's first step on each mesh against JAX's unsharded jitted
    ``make_train_step``: the metrics within the bar, and every rank's
    block of m (the clipped gradient times 1 - b1) within the bar of the
    same block of JAX's."""
    from repro_torch import configs
    cfg = configs.get_smoke("glm4-9b")
    bar = _bar(cfg)
    want = _jax_glm4_step()
    specs = _specs(cfg)
    big = max(float(np.abs(v).max()) for v in want["m"].values())
    for mesh in MESHES:
        got = runs["ranks"][0][f"glm4-9b/{mesh}"]["step0"]
        for key in ("loss", "grad_norm", "load_balance_loss"):
            w = want["metrics"][key]
            assert abs(got[key] - w) <= bar * max(abs(w), 1e-3), (mesh, key)
        for r, rk in enumerate(runs["ranks"]):
            with np.load(runs["d"] / f"m_glm4-9b_{mesh}_{r}.npz") as f:
                for n, m in want["m"].items():
                    _check(f[n], _block(m, specs[n], mesh,
                                        rk["coords"][mesh]),
                           max(float(np.abs(m).max()), 1e-3 * big), bar,
                           f"{mesh} m/{n} rank {r}")


# ---------------------------------------------------------------------------
# (b) the attention cases
# ---------------------------------------------------------------------------

def test_attention_cases_run_as_jax(runs):
    """Each of JAX's cases ran where its condition holds, on every rank:
    a forward and a remat recompute of each attention layer in
    training, one prefill and DECODE decode steps of each in serving."""
    from repro_torch import configs
    for (arch, mesh), (train, serve) in CASES.items():
        cfg = configs.get_smoke(arch)
        n = sum(k in ("attn", "moe") for k in cfg._layer_kinds())
        for rk in runs["ranks"]:
            res = rk[f"{arch}/{mesh}"]
            assert res["train_cases"] == {c: 2 * n for c in train}, \
                (arch, mesh, res["train_cases"])
            if serve == {"rep", "whole"}:
                assert res["serve_cases"] == {"rep": n, "whole": DECODE * n}
            else:
                assert res["serve_cases"] == {c: (1 + DECODE) * n
                                              for c in serve}
    seen = set().union(*(t | s for t, s in CASES.values()))
    assert seen == {"kv", "rep", "group", "whole"}


# ---------------------------------------------------------------------------
# (c) serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh", TRAIN_CASES)
def test_tp_serving_matches_one_device_and_jax(runs, arch, mesh):
    """Mesh prefill and DECODE greedy decode steps (f32): every rank's
    tokens equal its rows of the one-device steps' (and of JAX's
    unsharded steps' for one architecture of each kind), its logits (the
    vocabulary gathered over ``model``) within the bar x the largest
    |logit| of theirs."""
    from repro_torch import configs
    cfg = configs.get_smoke(arch)
    bar = _bar(cfg)
    refs = [_one_device(arch)]
    if arch in JAX_SERVED:
        refs.append(_jax_served(arch))
    v = cfg.vocab_size
    for r, rk in enumerate(runs["ranks"]):
        coords = rk["coords"][mesh]
        with np.load(runs["d"] / f"s_{arch}_{mesh}_{r}.npz") as f:
            toks, logits = f["tokens"], f["logits"]
        for ref in refs:
            want = _rows(ref["logits"], mesh, coords)[..., :v]
            assert np.array_equal(toks, _rows(ref["tokens"], mesh, coords)), \
                (arch, mesh, r)
            _check(logits[..., :v], want, float(np.abs(want).max()), bar,
                   f"{arch} {mesh} rank {r} logits")


def test_jax_sharded_serving_matches(runs):
    """JAX's own sharded prefill and decode steps (glm4-9b on a 2x2 mesh
    of four fake CPU devices, jax.jit with the parameters placed by
    ``param_specs``) give the port's 2x2 tokens, and logits within the
    bar."""
    from repro_torch import configs
    cfg = configs.get_smoke("glm4-9b")
    with np.load(runs["d"] / "jax_sharded_glm4-9b.npz") as f:
        jt, jl = f["tokens"], f["logits"][..., :cfg.vocab_size]
    for r, rk in enumerate(runs["ranks"]):
        coords = rk["coords"]["2x2"]
        with np.load(runs["d"] / f"s_glm4-9b_2x2_{r}.npz") as f:
            assert np.array_equal(f["tokens"], _rows(jt, "2x2", coords))
            want = _rows(jl, "2x2", coords)
            _check(f["logits"][..., :cfg.vocab_size], want,
                   float(np.abs(want).max()), _bar(cfg), f"rank {r}")


# ---------------------------------------------------------------------------
# (d) the partitioning is real
# ---------------------------------------------------------------------------

def _recording(mesh: str, coords=None):
    from repro_torch.launch.mesh import RecordingMesh
    return RecordingMesh(_shape(mesh), coords)


def test_compute_leaves_are_blocks():
    """On the 2x2 recording mesh every leaf of the compute copy a step
    differentiates is this rank's block (a quarter, a half or, for a
    replicated leaf, the whole), and every weight a layer multiplies is
    the leaf's ``model`` block with the ``data`` blocks joined: never
    the whole leaf where its spec splits it over ``model``."""
    from repro_torch import configs
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tp
    cfg = configs.get_smoke("glm4-9b")
    mesh = _recording("2x2", {"data": 1, "model": 1})
    state = S.init_train_state(cfg, None, AdamWConfig(), device="meta",
                               mesh=mesh)
    whole = S.init_train_state(cfg, None, AdamWConfig(), device="meta")
    specs = S.state_specs(cfg, state)["params"]
    cmodel = S.cast_compute(cfg, state["params"], torch.float32)
    full = dict(whole["params"].named_parameters())
    split = 0
    for n, p in cmodel.named_parameters():
        parts = math.prod(mesh.shape[a] for a in shd.spec_axes(mesh,
                                                               specs[n]))
        assert p.numel() * parts == full[n].numel(), n
        assert tuple(p.shape) == shd.block_shape(mesh, specs[n],
                                                 full[n].shape), n
        split += parts > 1
    assert split == sum(1 for n in specs if specs[n])
    used = []
    tp.gathered_hook = lambda t: used.append(tuple(t.shape))
    try:
        with shd.set_mesh(mesh, dp_axes=("data",)):
            S.loss_fn(cfg, cmodel, {"tokens": torch.empty(
                (ROWS // 2, SEQ), dtype=torch.int64, device="meta")},
                torch.float32)
    finally:
        tp.gathered_hook = None
    model_halves = {tuple(s // (2 if e == "model" else 1)
                          for s, e in zip(full[n].shape, specs[n]))
                    for n in specs if "model" in specs[n]}
    assert used and set(used) <= model_halves, (set(used), model_halves)


def _flops_closed_form(cfg, case: str, t: int, rows: int) -> float:
    """A rank's matmul flops in a train step with remat on ``rows`` rows
    of SEQ tokens, ``t`` ranks on ``model``: L (3 P + 3.5 A) + 3 logits
    and one recompute of the layers less the MLP down projection
    (tests/test_torch_lm_dryrun.py's forms), each product on this rank's
    heads, hidden columns and vocabulary columns; under ``"rep"`` and
    ``"group"`` K and V are projected whole for this rank's query
    heads."""
    n, d, hd, ff = cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    tok = rows * SEQ
    hq, hkv = cfg.num_heads // t, cfg.num_kv_heads
    kv = hkv // t if case == "kv" else hkv
    proj = 2 * tok * d * (2 * hq * hd + 2 * kv * hd)
    mlp = (3 if cfg.mlp in ("swiglu", "geglu") else 2) * 2 * tok * d * ff // t
    attn = 2 * 2 * rows * hq * SEQ * SEQ * hd
    logits = 2 * tok * d * cfg.padded_vocab // t
    tail = 2 * tok * ff * d // t
    p = proj + mlp
    return n * (3 * p + 3.5 * attn) + 3 * logits + n * (p + attn - tail)


@pytest.mark.parametrize("arch,mesh,case", [
    ("glm4-9b", "2x2", "kv"), ("glm4-9b", "1x4", "rep"),
    ("nemotron-4-340b", "1x4", "group")])
def test_traced_flops_equal_closed_form(arch, mesh, case):
    """A rank's train step traced on the meta device with the recording
    mesh (``dryrun.measure``): its matmul flops equal the closed form;
    on 2x2 they are half of the replicated program's, which a rank's
    one-device step on its rows computes."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import measure
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import tp
    cfg = configs.get_smoke(arch)
    m = _recording(mesh)
    t, rows = m.shape["model"], ROWS // m.shape["data"]
    opt = AdamWConfig()
    tokens = torch.empty((ROWS, SEQ), dtype=torch.int64, device="meta")
    state = S.init_train_state(cfg, None, opt, device="meta", mesh=m)
    tp.CASES.clear()
    got = measure(S.make_train_step(cfg, opt, mesh=m,
                                    compute_dtype=torch.float32),
                  {"state": state, "batch": {"tokens": tokens}}, m)
    assert set(tp.CASES) == {case}
    assert got["flops_by_dtype"] == {
        "float32": _flops_closed_form(cfg, case, t, rows)}
    if mesh == "2x2":
        one = S.init_train_state(cfg, None, opt, device="meta")
        rep = measure(S.make_train_step(cfg, opt,
                                        compute_dtype=torch.float32),
                      {"state": one, "batch": {"tokens": tokens[:rows]}})
        assert got["flops"] * 2 == rep["flops"]


def _gathered_live(cfg, layers: int) -> tuple[int, int, int]:
    """(the most gathered-parameter bytes live at once in a forward with
    gradients on, those live at the forward's traced peak, one layer's
    gathered bytes plus the embeddings') of glm4-9b's smoke widths at
    ``layers`` layers, a 2x2 rank, f32."""
    from repro_torch.launch import dryrun
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig

    class Tracked(dryrun.Trace):
        most = 0

        def label(self, t, label):
            super().label(t, label)
            self.most = max(self.most, self.by_label[dryrun.GATHERED])

    c = dataclasses.replace(cfg, num_layers=layers)
    mesh = _recording("2x2")
    state = S.init_train_state(c, None, AdamWConfig(), device="meta",
                               mesh=mesh)
    cmodel = S.cast_compute(c, state["params"], torch.float32)
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tp
    tr = Tracked()
    tp.gathered_hook = lambda t: tr.label(t, dryrun.GATHERED)
    try:
        with tr, shd.set_mesh(mesh, dp_axes=("data",)):
            loss, _ = S.loss_fn(c, cmodel, {"tokens": torch.empty(
                (ROWS, SEQ), dtype=torch.int64, device="meta")},
                torch.float32)
    finally:
        tp.gathered_hook = None
    del loss
    layer = sum(p.numel() * 2 * 4 for p in cmodel.layers[0].parameters()
                if p.ndim == 2)            # each block, its data half joined
    emb = sum(p.numel() * 2 * 4 for p in cmodel.embed.parameters())
    return tr.most, tr.peak_holds.get(dryrun.GATHERED, 0), layer + emb


def test_one_layer_gathered_at_a_time():
    """A forward with gradients on (remat: each layer its own period) at
    4 and at 8 layers: the most gathered-parameter bytes live at once,
    and those live at the traced peak, are at most one layer's gathered
    blocks plus the embeddings', and do not grow with depth."""
    from repro_torch import configs
    cfg = configs.get_smoke("glm4-9b")
    assert cfg.remat
    four = _gathered_live(cfg, 4)
    eight = _gathered_live(cfg, 8)
    most, at_peak, bound = four
    assert 0 < at_peak <= most <= bound, four
    assert eight[:2] == four[:2], (four, eight)


@pytest.mark.parametrize("arch,mesh", [
    ("glm4-9b", "2x2"), ("glm4-9b", "1x4"), ("glm4-9b", "2x1x2"),
    ("nemotron-4-340b", "1x4")])
def test_recording_mesh_counts_tp_as_gloo(runs, arch, mesh):
    """The two train steps and the serving run on the meta device with a
    recording mesh at each rank's coordinates: the collectives' calls
    and bytes by kind and dtype (reduce-scatters, tensor-parallel
    all-reduces and logits gathers included) equal what the rank's gloo
    mesh counted."""
    from repro_torch import configs
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    cfg = configs.get_smoke(arch)
    opt = AdamWConfig(**OPT)
    meta = [{k: torch.empty_like(v, device="meta") for k, v in b.items()}
            for b in _batches(cfg)]
    for r, rk in enumerate(runs["ranks"]):
        res = rk[f"{arch}/{mesh}"]
        m = _recording(mesh, rk["coords"][mesh])
        state = S.init_train_state(cfg, None, opt, device="meta", mesh=m)
        step = S.make_train_step(cfg, opt, mesh=m,
                                 compute_dtype=torch.float32)
        for b in meta:
            state, _ = step(state, b)
        assert dict(m.counts) == res["train_tally"]["counts"], r
        assert dict(m.nbytes) == res["train_tally"]["nbytes"], r
        m = _recording(mesh, rk["coords"][mesh])
        model = S.shard_model(cfg, S.model_module(cfg).init_params(
            cfg, None, device="meta"), m)
        batch = S.local_batch(cfg, meta[0], m)
        pre = S.make_prefill_step(cfg, cache_len=SEQ + 8, mesh=m,
                                  compute_dtype=torch.float32)
        dec = S.make_decode_step(cfg, mesh=m, compute_dtype=torch.float32)
        _, caches = pre(model, batch)
        tok = torch.empty((batch["tokens"].shape[0], 1), dtype=torch.int64,
                          device="meta")
        for i in range(DECODE):
            _, _, caches = dec(model, caches, tok, SEQ + i)
        assert dict(m.counts) == res["serve_tally"]["counts"], r
        assert dict(m.nbytes) == res["serve_tally"]["nbytes"], r
    kinds = runs["ranks"][0][f"{arch}/{mesh}"]["train_tally"]["counts"]
    # a gradient is reduce-scattered over data where data splits the rows,
    # and over model where K and V are projected whole ("rep", "group")
    data = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))["data"]
    whole_kv = CASES.get((arch, mesh), ({"kv"},))[0] != {"kv"}
    assert "tp_all_reduce" in kinds
    assert ("grad_reduce_scatter" in kinds) == (data > 1 or whole_kv)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), pathlib.Path(sys.argv[2]))
