"""The port's LM dry-run (``launch/{specs,dryrun,perf_variants}.py``,
``models/config.py``'s ``SHAPES``, ``steps.cache_specs``, the recording
mesh) against the JAX package's, on the meta device (no spawn here; the
recording mesh against a real gloo run is held in
tests/test_torch_lm_parallel.py, whose ranks count it):

* (a) ``SHAPES`` and ``skip_reason`` equal JAX's: 40 cells, 8 skipped
  (the twin of tests/test_specs_and_scan.py::test_cell_enumeration_counts);
* (b) ``cache_specs`` equals JAX's for every cache leaf of the ten
  architectures (smoke and full widths) on the debug meshes and the two
  production shapes;
* (c) ``input_specs``' arguments, through ``convert``'s mappings, have the
  shapes and dtypes of JAX's ``input_specs`` (``jax.eval_shape``, no
  compile) for one cell of each kind of glm4-9b, seamless and pixtral and
  recurrentgemma's ``long_500k`` decode; a decode position given as a
  meta tensor is a host read that raises, so the cells pass an int;
* (d) ``_extrapolate`` equals JAX's (tests/test_dryrun_tools.py's inputs
  and a negative per-layer delta);
* (e) traced matmul flops of a forward and of a train step equal closed
  forms from the config's widths (glm4-9b and qwen2-moe smoke), and
  ``remat=False`` takes exactly one forward of the layers less;
* (f) the gradient bytes phase 13 reduces on the card (glm4-9b at full
  width, 1 layer, 2 x 1024 tokens on 2x2): 1,445,462,016 bf16
  reduce-scattered and 49,152 f32 all-reduced a step and rank;
* (g) the live-bytes tracker against hand counts (a view, an in-place op,
  a saved tensor);
* (h) the CLI's records of a train, a decode and a skipped cell, and the
  perf ladders' tags and overrides equal JAX's ``RUNS``.
"""

import dataclasses
import json
import math
import os

import pytest
import torch

import torch_one_thread  # noqa: F401  (one intra-op thread)

META = "meta"


def _jax_import(module: str):
    """A JAX launch module whose import sets ``XLA_FLAGS`` (512 host
    devices) for its own process; the variable is put back."""
    import importlib
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(module)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def _meshes():
    from repro_torch.launch.mesh import MeshShape, make_production_mesh
    debug = {f"{a}x{b}": MeshShape({"data": a, "model": b},
                                   ("data", "model"))
             for a, b in ((2, 2), (4, 1), (1, 4))}
    return {**debug, "pod": make_production_mesh(),
            "multipod": make_production_mesh(multi_pod=True)}


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _jax_flat(tree, is_leaf=None) -> dict:
    import jax
    return {tuple(_key(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


# ---------------------------------------------------------------------------
# (a) shapes and skips
# ---------------------------------------------------------------------------

def test_shapes_equal_jax():
    from repro.models.config import SHAPES as JSHAPES

    from repro_torch.models.config import SHAPES
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JSHAPES[name])


def test_cell_enumeration_and_skips_equal_jax():
    from repro.launch.specs import skip_reason as jskip

    from repro_torch import configs
    from repro_torch.launch.specs import skip_reason
    from repro_torch.models.config import SHAPES
    cells = [(a, s) for a in configs.all_arch_names() for s in SHAPES]
    assert len(cells) == 40
    for c in cells:
        assert skip_reason(*c) == jskip(*c), c
    assert len([c for c in cells if skip_reason(*c)]) == 8
    assert skip_reason("glm4-9b", "long_500k") is not None
    assert skip_reason("rwkv6-1.6b", "long_500k") is None


# ---------------------------------------------------------------------------
# (b) cache_specs
# ---------------------------------------------------------------------------

class _Stack(list):
    """The per-layer leaves JAX stacks into one, in depth order."""


def _stacks(x) -> bool:
    return isinstance(x, _Stack)


def _jax_cache_tree(cfg, caches):
    """The port's caches (or their specs) in JAX's tree: decoder-only a
    list over segments of ``{b<j>: {name: _Stack}}``, an encoder-decoder
    ``(self, cross)`` of ``{name: _Stack}``."""
    from repro_torch.models import transformer as TF
    if cfg.is_encdec:
        return tuple({k: _Stack(c[k] for c in part) for k in part[0]}
                     for part in caches)
    segs = {}
    for (_, si, _, j), c in zip(TF.layer_slots(cfg), caches):
        blk = segs.setdefault(si, {}).setdefault(f"b{j}", {})
        for k, v in c.items():
            blk.setdefault(k, _Stack()).append(v)
    return [segs[i] for i in range(len(segs))]


def _both_caches(cfg, jcfg, batch: int, length: int):
    """(JAX's cache shapes, the port's caches on the meta device)."""
    import jax
    import jax.numpy as jnp
    from repro.models import encdec as JED
    from repro.models import transformer as JTF

    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as TF
    if cfg.is_encdec:
        enc = min(cfg.encoder_seq_len or length, length)
        want = jax.eval_shape(lambda: JED.init_caches(
            jcfg, batch, length, enc, jnp.bfloat16))
        got = ED.init_caches(cfg, batch, length, enc, torch.bfloat16,
                             device=META)
    else:
        want = jax.eval_shape(lambda: JTF.init_caches(
            jcfg, batch, length, jnp.bfloat16))
        got = TF.init_caches(cfg, batch, length, torch.bfloat16,
                             device=META)
    return want, got


def test_cache_specs_equal_jax():
    """Every cache leaf of the ten architectures, smoke and full widths
    (kv_seq_shard on and off), at batch sizes that take each fall-back of
    ``dp_axes_for``, on 2x2, 4x1, 1x4, pod and multipod: the port's spec
    with its depth dim equals JAX's ``cache_specs``; the shapes equal
    JAX's ``init_caches``' too."""
    from jax.sharding import PartitionSpec as P
    from repro import configs as jconfigs
    from repro.models import steps as JS

    from repro_torch import configs
    from repro_torch.models import steps as S
    held, rules = 0, set()
    for arch in configs.all_arch_names():
        for get, jget in ((configs.get_smoke, jconfigs.get_smoke),
                          (configs.get, jconfigs.get)):
            cfg, jcfg = get(arch), jget(arch)
            variants = [(cfg, jcfg)]
            if arch == "nemotron-4-340b":
                variants.append((dataclasses.replace(cfg, kv_seq_shard=False),
                                 dataclasses.replace(jcfg,
                                                     kv_seq_shard=False)))
            for c, jc in variants:
                for batch in (64, 2, 1):
                    want, got = _both_caches(c, jc, batch, 32)
                    wflat = _jax_flat(want)
                    gshape = _jax_flat(_jax_cache_tree(c, got),
                                       is_leaf=_stacks)
                    for path, leaves in gshape.items():
                        stacked = (len(leaves), *leaves[0].shape)
                        assert tuple(wflat[path].shape) == stacked, path
                    for mname, mesh in _meshes().items():
                        jspec = _jax_flat(JS.cache_specs(jc, want, mesh),
                                          is_leaf=lambda x: isinstance(x, P))
                        gspec = _jax_flat(
                            _jax_cache_tree(c, S.cache_specs(c, got, mesh)),
                            is_leaf=_stacks)
                        assert set(jspec) == set(gspec), (arch, mname)
                        for path, specs in gspec.items():
                            assert all(s == specs[0] for s in specs)
                            port = (None, *specs[0])
                            assert port == tuple(jspec[path]), \
                                (arch, cfg.name, batch, mname, path, port,
                                 jspec[path])
                            rules.add((path[-1], port))
                            held += 1
    # the head, sequence and replicated rules and the RWKV state's all ran
    assert ((("k", (None, "data", None, "model", None)) in rules)
            and ("k", (None, "data", "model", None, None)) in rules
            and ("v", (None, None, None, None, None)) in rules
            and ("S", (None, "data", "model", None, None)) in rules
            and ("pos", (None, None)) in rules), sorted(rules)
    assert held > 1000, held


# ---------------------------------------------------------------------------
# (c) input_specs' arguments
# ---------------------------------------------------------------------------

CELLS = [("glm4-9b", s) for s in ("train_4k", "prefill_32k", "decode_32k")] \
    + [("seamless-m4t-large-v2", s) for s in ("train_4k", "prefill_32k",
                                              "decode_32k")] \
    + [("pixtral-12b", s) for s in ("train_4k", "prefill_32k",
                                    "decode_32k")] \
    + [("recurrentgemma-9b", "long_500k")]


def _dtype(t) -> str:
    """A port dtype in JAX's name; token ids are int64 in the port (torch
    indexes with them), int32 in JAX."""
    name = str(t).removeprefix("torch.")
    return "int32" if name == "int64" else name


def _global_rows(shape, rows: int, glob: int) -> tuple:
    return (shape[0] * glob // rows, *shape[1:])


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_equal_jax_eval_shape(arch, shape_name):
    """The port's cell arguments on the pod mesh, mapped to JAX's trees
    (the train state's and the serving parameters' blocks at their global
    shapes by ``state_specs``, a serving batch's rows over
    ``dp_axes_for``, the caches' blocks by ``held_cache_specs``, stacked
    per segment), equal JAX's ``input_specs`` arguments in shape and
    dtype; ``pos`` is a Python int where JAX's is an int32 scalar."""
    from repro.compat import make_mesh
    from repro.launch.specs import input_specs as jinput_specs

    from repro_torch.launch.mesh import RecordingMesh, make_production_mesh
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import convert
    from repro_torch.models import steps as S
    from repro_torch.models.config import SHAPES
    from repro_torch.parallel import sharding as shd
    from repro_torch import configs
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    _, jkw, _, _ = jinput_specs(arch, shape_name,
                                make_mesh((1, 1), ("data", "model")))
    mesh = RecordingMesh(make_production_mesh())
    _, kw, specs = input_specs(arch, shape_name, mesh)
    assert set(kw) == set(jkw)
    # this rank's rows: the batch over the 16 data ranks where they
    # divide it (dp_axes_for), else the whole batch
    g = shape.global_batch
    rows = g // 16 if g % 16 == 0 else g

    def same(want_tree, got: dict, what):
        want = _jax_flat(want_tree)
        assert set(want) == set(got), (what, set(want) ^ set(got))
        for path, (shp, dt) in got.items():
            w = want[path]
            assert (tuple(w.shape), str(w.dtype)) == (tuple(shp), dt), \
                (what, path, shp, dt, w)

    batch_key = "batch" if "batch" in kw else None
    if shape.kind == "train":
        shapes = convert.train_state_shapes(cfg, kw["state"])
        sp = convert.train_state_specs_to_jax(
            cfg, S.state_specs(cfg, kw["state"]))
        got = {}
        for path, (shp, dt) in _jax_flat(
                shapes, is_leaf=lambda x: isinstance(x, tuple)).items():
            node = sp
            for k in path:
                node = node[int(k) if isinstance(node, list) else k]
            got[path] = (shd.global_shape(mesh, node, shp), _dtype(dt))
        same(jkw["state"], got, "state")
        same(jkw["batch"], {(k,): (tuple(v.shape), _dtype(v.dtype))
                            for k, v in kw["batch"].items()}, "batch")
        return
    sp = convert.train_state_specs_to_jax(
        cfg, S.state_specs(cfg, {"params": kw["params"]}))["params"]
    got = {}
    for path, (shp, dt) in _jax_flat(
            convert.param_shapes(cfg, kw["params"].named_parameters()),
            is_leaf=lambda x: isinstance(x, tuple)).items():
        node = sp
        for k in path:
            node = node[int(k) if isinstance(node, list) else k]
        got[path] = (shd.global_shape(mesh, node, shp), _dtype(dt))
    same(jkw["params"], got, "params")
    if batch_key:
        same(jkw["batch"], {(k,): (_global_rows(v.shape, rows,
                                                shape.global_batch),
                                   _dtype(v.dtype))
                            for k, v in kw["batch"].items()}, "batch")
        return
    caches = _jax_flat(_jax_cache_tree(cfg, kw["caches"]), is_leaf=_stacks)
    held = _jax_flat(_jax_cache_tree(cfg, specs["held_caches"]),
                     is_leaf=_stacks)
    got = {}
    for path, leaves in caches.items():
        got[path] = ((len(leaves), *shd.global_shape(
            mesh, held[path][0], leaves[0].shape)), _dtype(leaves[0].dtype))
    same(jkw["caches"], got, "caches")
    assert tuple(jkw["tokens"].shape) == _global_rows(
        kw["tokens"].shape, rows, shape.global_batch)
    assert isinstance(kw["pos"], int) and str(jkw["pos"].dtype) == "int32" \
        and jkw["pos"].shape == ()
    assert kw["tokens"].device.type == META
    assert specs["pos"] == ()


def test_decode_position_tensor_is_a_host_read():
    """The one host read on the dry-run's path: a decode step reads its
    position with ``int(pos)``, which a meta tensor cannot give, so the
    cells pass ``pos`` as a Python int (JAX's is a traced int32
    scalar)."""
    from repro_torch import configs
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as TF
    cfg = configs.get_smoke("glm4-9b")
    model = TF.init_params(cfg, None, device=META)
    caches = TF.init_caches(cfg, 2, 16, device=META)
    tokens = torch.empty((2, 1), dtype=torch.int64, device=META)
    step = S.make_decode_step(cfg, compute_dtype=torch.float32)
    nxt, logits, _ = step(model, caches, tokens, 15)
    assert nxt.shape == (2, 1) and logits.shape == (2, 1, cfg.padded_vocab)
    with pytest.raises((RuntimeError, NotImplementedError)):
        step(model, caches, tokens, torch.empty((), dtype=torch.int64,
                                                device=META))


# ---------------------------------------------------------------------------
# (d) _extrapolate
# ---------------------------------------------------------------------------

def test_extrapolate_equals_jax():
    jdr = _jax_import("repro.launch.dryrun")

    from repro_torch.launch.dryrun import _extrapolate
    m1 = {"flops": 100.0, "bytes": 10.0, "coll_bytes": 4.0, "coll_count": 2}
    m2 = {"flops": 150.0, "bytes": 14.0, "coll_bytes": 6.0, "coll_count": 3}
    neg = {"flops": 90.0, "bytes": 16.0, "coll_bytes": 3.0, "coll_count": 1}
    for a, b, k1, k2, L in ((m1, m2, 1, 2, 10), (m1, neg, 1, 2, 10),
                            (m1, m2, 3, 6, 38), (neg, m1, 2, 4, 94)):
        assert _extrapolate(a, b, k1, k2, L) == jdr._extrapolate(
            a, b, k1, k2, L)
    ext = _extrapolate(m1, neg, 1, 2, 10)      # clamped at 0, floored
    assert ext["flops_per_layer"] == 0.0 and ext["flops"] == 100.0
    assert ext["bytes"] == pytest.approx(10 + 9 * 6)


# ---------------------------------------------------------------------------
# (e) traced flops against closed forms
# ---------------------------------------------------------------------------

ROWS, SEQ = 2, 24


def _closed_form(cfg) -> dict:
    """A forward's matmul flops at ROWS x SEQ tokens, one KV chunk (SEQ <=
    1024): per layer P (the q, k, v and o projections, and the MLP, or
    the MoE's router, experts over their capacity buffers, shared expert
    and its gate) and A (QK^T and PV); the logits; and ``tail``, the
    products a remat period's recompute skips: non-reentrant checkpointing
    stops once the last tensor its backward saved is recomputed, and a
    dense layer's MLP down projection is saved by nothing (``h + m``),
    where the MoE's shared expert output is (its gate's product)."""
    t, d, hd = ROWS * SEQ, cfg.d_model, cfg.head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    proj = 2 * t * d * (2 * h * hd + 2 * hkv * hd)
    attn = 2 * 2 * ROWS * h * SEQ * SEQ * hd
    if cfg.moe is None:
        ffn = 3 * 2 * t * d * cfg.d_ff
        tail = 2 * t * cfg.d_ff * d
    else:
        m = cfg.moe
        e = m.padded
        cap = max(4, -(-math.ceil(m.capacity_factor * m.top_k * SEQ / e)
                       // 4) * 4)
        ffn = (2 * t * d * e                           # router
               + 3 * 2 * ROWS * e * cap * d * m.d_expert)  # experts
        ffn += 3 * 2 * t * d * m.shared_d_ff + 2 * t * d  # shared, gate
        tail = 0
    return {"P": proj + ffn, "A": attn, "logits": 2 * t * d * cfg.padded_vocab,
            "tail": tail}


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2-moe-a2.7b"])
def test_traced_flops_equal_closed_form(arch):
    """A forward: L (P + A) + logits.  A train step without remat: the
    forward and the backward, each matmul's backward two products (both
    operands take gradients), the chunked attention's five (scores again,
    dV, dP, dQ, dK): L (3 P + 3.5 A) + 3 logits.  With remat each period
    is recomputed once in the backward, up to its last saved tensor: one
    forward of the layers less ``tail`` more."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import Trace, measure
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as TF
    from repro_torch.optim import AdamWConfig
    cfg = configs.get_smoke(arch)
    cf = _closed_form(cfg)
    n = cfg.num_layers
    tokens = torch.empty((ROWS, SEQ), dtype=torch.int64, device=META)
    model = TF.init_params(cfg, None, device=META)
    with Trace() as tr:
        TF.forward(cfg, model, tokens)
    assert dict(tr.flops) == {"float32": n * (cf["P"] + cf["A"])
                              + cf["logits"]}
    got = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        opt = AdamWConfig()
        state = S.init_train_state(c, None, opt, device=META)
        step = S.make_train_step(c, opt, compute_dtype=torch.float32)
        m = measure(step, {"state": state, "batch": {"tokens": tokens}})
        assert m["collectives"]["total_count"] == m["coll_bytes"] == 0
        assert m["flops"] == sum(m["flops_by_dtype"].values())
        got[remat] = m["flops_by_dtype"]
    plain = n * (3 * cf["P"] + 3.5 * cf["A"]) + 3 * cf["logits"]
    assert got[False] == {"float32": plain}
    assert got[True] == {"float32": plain + n * (cf["P"] + cf["A"]
                                                 - cf["tail"])}


# ---------------------------------------------------------------------------
# (f) phase 13's gradient bytes
# ---------------------------------------------------------------------------

def test_recording_mesh_gives_phase13_gradient_bytes():
    """glm4-9b at full width cut to 1 layer, bf16 compute, 2 x 1024 tokens
    on the 2x2 (data, model) mesh (phase 13 of chip_smoke.py): each rank
    reduce-scatters over ``data`` its ``model`` block of every matmul
    weight's bf16 gradient, 1,445,462,016 bytes a step (half of the
    2,890,924,032 the replicated program all-reduced: the weights are
    split in two over ``model``), and all-reduces the three f32 norm
    scales' 49,152; the same collectives on every rank."""
    from repro_torch import configs
    from repro_torch.launch.mesh import MeshShape, RecordingMesh
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(configs.get("glm4-9b"), num_layers=1)
    shape = MeshShape({"data": 2, "model": 2}, ("data", "model"))
    opt = AdamWConfig(lr=1e-5)
    seen = []
    for coords in ({"data": 0, "model": 0}, {"data": 1, "model": 1}):
        mesh = RecordingMesh(shape, coords)
        state = S.init_train_state(cfg, None, opt, device=META, mesh=mesh)
        step = S.make_train_step(cfg, opt, mesh=mesh,
                                 compute_dtype=torch.bfloat16)
        step(state, {"tokens": torch.empty((2, 1024), dtype=torch.int64,
                                           device=META)})
        assert mesh.nbytes["grad_reduce_scatter/bfloat16"] == \
            2_890_924_032 // 2
        assert mesh.nbytes["grad_all_reduce/float32"] == 49_152
        assert "grad_all_reduce/bfloat16" not in mesh.nbytes
        seen.append((dict(mesh.counts), dict(mesh.nbytes)))
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# (g) the live-bytes tracker
# ---------------------------------------------------------------------------

def test_live_bytes_tracker_hand_counts():
    """Sizes in 512-byte units: a new tensor counts, its view and an
    in-place op on it do not, a 100-byte storage counts 512; ``exp`` saves
    its result for the backward, so the result stays live after its name
    is dropped until the graph goes; the peak and what it holds."""
    from repro_torch.launch.dryrun import Trace
    tr = Trace()
    x = torch.ones(1024, requires_grad=True)        # 4096 B, registered
    tr.register([x], "x")
    assert tr.live == 4096
    with tr:
        a = torch.empty(2048)                       # 8192
        v = a.view(32, 64)                          # a view: no storage
        a.mul_(2.0)                                 # in place: none
        assert tr.live == 4096 + 8192
        small = torch.empty(25)                     # 100 B -> 512
        assert tr.live == 4096 + 8192 + 512
        y = x.exp()                                 # 4096, saved
        z = y.sum()                                 # 512
        del y
        assert tr.live == 4096 + 8192 + 512 + 4096 + 512
        del v, a
        assert tr.live == 4096 + 512 + 4096 + 512
        del z                                       # the graph and y go
        assert tr.live == 4096 + 512
        del small
    assert tr.live == 4096
    assert tr.peak == 4096 + 8192 + 512 + 4096 + 512
    assert tr.peak_holds == {"x": 4096, "empty:float32": 8192 + 512,
                             "exp:float32": 4096, "sum:float32": 512}


# ---------------------------------------------------------------------------
# (h) the CLI and the perf ladders
# ---------------------------------------------------------------------------

def test_cli_writes_train_decode_and_skipped_records(tmp_path,
                                                    monkeypatch):
    """``python -m repro_torch.launch.dryrun``'s ``main`` for gemma-7b
    train_4k (the registry's config cut to 2 layers here, to keep the
    test's clock: a full-depth train cell traces for 20-90 s), glm4-9b
    decode_32k and glm4-9b long_500k (skipped) on pod, then ``--all``
    over the glm4-9b cells skipping the written ones: every record states
    its program, fit, dominant term and constants' sources, with no TPU
    constant and no XLA field."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    whole = configs.get
    monkeypatch.setattr(configs, "get", lambda a: dataclasses.replace(
        whole(a), num_layers=2) if a == "gemma-7b" else whole(a))
    out = str(tmp_path)
    for arch, shape in (("gemma-7b", "train_4k"),
                        ("glm4-9b", "decode_32k"),
                        ("glm4-9b", "long_500k")):
        assert dryrun.main(["--arch", arch, "--shape", shape, "--mesh",
                            "pod", "--out-dir", out]) == 0
    recs = {p: json.load(open(tmp_path / p)) for p in os.listdir(out)}
    assert sorted(recs) == ["gemma-7b__train_4k__pod.json",
                            "glm4-9b__decode_32k__pod.json",
                            "glm4-9b__long_500k__pod.json"]
    skip = recs["glm4-9b__long_500k__pod.json"]
    assert skip["status"] == "skipped" and "O(S^2)" in skip["reason"]
    train = recs["gemma-7b__train_4k__pod.json"]
    dec = recs["glm4-9b__decode_32k__pod.json"]
    assert train["program"] == dryrun.program("train")
    assert dec["program"] == dryrun.program("decode")
    assert "tensor-parallel over model" in train["program"]
    assert "tensor-parallel serving over model" in dec["program"]
    for r in (train, dec):
        text = json.dumps(r)
        for absent in ("197e12", "1.97e+14", "819000000000", "8.19e+11",
                       "5e+10", "memory_analysis", "compile_s", "lower_s"):
            assert absent not in text, absent
        rf = r["roofline"]
        assert rf["dominant"] in ("compute", "memory")
        assert "H100" in rf["peak_flops_source"] and "H100" in rf["bw_source"]
        assert rf["peak_flops"]["float32"] == 67e12 and rf["bw"] == 3.35e12
        assert isinstance(r["fits"], bool) and "H100" in r["hbm_source"]
        assert {k: r[k] for k in dryrun.fit(r["peak_bytes"])} == \
            dryrun.fit(r["peak_bytes"])
        assert r["chips"] == 256 and r["peak_bytes"] > r["arg_bytes"] > 0
        assert r["useful_flops_ratio"] > 0
        assert r["cost_extrapolated"]["flops"] == pytest.approx(
            r["cost_fulltrace"]["flops"], rel=1e-9)
    # the train cell's collectives: gathers, tensor-parallel all-reduces
    # and gradient reductions, in XLA's names too; serving's: gathers and
    # tensor-parallel all-reduces
    kinds = train["collectives_fulltrace"]["jax_kinds"]
    assert set(kinds) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert set(dec["collectives_fulltrace"]["jax_kinds"]) == \
        {"all-gather", "all-reduce"}
    assert set(dec["collectives_fulltrace"]["by_kind"]) == \
        {"param_gather", "tp_all_reduce", "logits_gather"}
    assert dryrun.run_all(out, meshes=("pod",), archs=["glm4-9b"],
                          shapes=["decode_32k", "long_500k"]) == []


def test_fits_holds_one_limit_on_every_host(monkeypatch):
    """``fits`` compares a peak with one constant, an H100 80GB HBM3's
    ``total_memory`` less its CUDA context, whatever card the process
    sees; within 4 GiB of it, on either side, the peak is marginal."""
    from repro_torch.launch import dryrun
    limit = dryrun.HBM_BYTES - dryrun.CONTEXT_BYTES
    band = dryrun.MARGINAL_BYTES
    want = {limit: (True, True, 0), limit + 1: (False, True, -1),
            limit - band - 1: (True, False, band + 1),
            limit + band + 1: (False, False, -band - 1)}
    for seen in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: seen)
        for peak, (fits, marginal, margin) in want.items():
            f = dryrun.fit(peak)
            assert (f["fits"], f["marginal"], f["margin_bytes"]) == \
                (fits, marginal, margin)
            assert f["hbm_bytes"] == dryrun.HBM_BYTES
            assert "H100 80GB HBM3" in f["hbm_source"]


def test_perf_ladders_equal_jax_runs():
    jpv = _jax_import("repro.launch.perf_variants")

    from repro_torch.launch import perf_variants as pv
    assert list(pv.RUNS) == list(jpv.RUNS)
    for k in pv.RUNS:
        assert pv.RUNS[k] == jpv.RUNS[k], k
