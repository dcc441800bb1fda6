"""The port's data-parallel LM training on a mesh against its one-device
training and the JAX package's: twins of JAX's sharding rules, of
tests/test_distributed.py::test_sharded_train_step_learns and of
tests/test_fault_tolerance.py::test_elastic_restore_across_meshes.

Four gloo ranks (CPU processes, one thread each, a ``file://``
rendezvous under the test's temporary directory) build three meshes from
the same ranks: 2x2 (``data``, ``model``), 4x1 and 2x1x2 (``pod``,
``data``, ``model``).  Held here:

* (a) the port's ``spec_for``, ``param_specs``, ``state_specs``,
  ``batch_specs``, ``batch_axes``, ``dp_axes_for``, ``tp_axis_for`` and
  ``tp_size`` equal JAX's for every leaf of the ten smoke architectures,
  on the 2x2, 4x1 and 1x4 debug meshes and the two production shapes
  (JAX's functions read a mesh only through ``axis_names`` and
  ``shape``, so they are given the port's ``MeshShape``);
* (b) each rule's block is the one ``jax.NamedSharding`` places (a JAX
  subprocess of four fake devices lists them), and ``shard_leaf`` then
  ``unshard_leaf`` is bitwise the leaf on every mesh;
* (c) two f32 steps on the 2x2 mesh of glm4-9b, qwen2-moe, rwkv6 and
  seamless (states restored onto the mesh from a JAX-written checkpoint
  of a numpy-drawn tree, tests/torch_lm_twins.py) against the port's
  one-device step on the whole batch, with the gradient bars of
  tests/test_torch_lm_train.py; qwen2-moe's batch is one whose mean of
  per-shard load-balance losses misses the global one; glm4-9b's first
  step also against JAX's unsharded ``make_train_step``;
* (d) bf16 compute on glm4-9b: the gradients reduced in bf16 (the bytes
  of the collective by dtype) and within 2 bf16 ulps of each leaf's
  largest |g| of the one-device bf16 gradients;
* (e) eight steps on 2x2 (glm4-9b smoke, batch 4 x 32, lr 1e-3, f32):
  the loss falls;
* (f) a 2x2 checkpoint restored onto the 4x1 mesh and onto one device
  bitwise, and a JAX-written checkpoint restored onto the 2x2 mesh
  bitwise;
* (h) the LM dry-run's recording mesh (``launch/mesh.py::RecordingMesh``,
  tests/test_torch_lm_dryrun.py) tallies the calls and bytes by kind and
  dtype of (e)'s first two steps exactly as each rank's gloo mesh did;
* (g) ``torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh
  debug --device cpu`` for 4 steps, and its step-2 checkpoint resumed
  bitwise the uninterrupted run; a run whose rank 2 alone gets SIGTERM
  checkpointed by every rank after the same step (both by the CLI's
  ``main`` in the four ranks above, which saves four process starts);
  ``--mesh pod`` and ``multipod`` outside jobs of 256 and 512 ranks
  raise naming the size.

Every process group has a 60 s timeout and every spawn a deadline.  The
file runs as a script for one rank of the spawn:
``python tests/test_torch_lm_parallel.py <rank> <dir>``.
"""

import datetime
import functools
import json
import math
import os
import pathlib
import shutil
import signal
import subprocess
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
DEADLINE_S = 240                    # every spawn's join deadline
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
ARCHS = ("glm4-9b", "qwen2-moe-a2.7b", "rwkv6-1.6b", "seamless-m4t-large-v2")
BARS = {"hybrid": 1e-4, "ssm": 1e-4}   # tests/test_torch_lm_train.py's
OPT = dict(lr=1e-3, weight_decay=0.01)
SEQ, ROWS = 24, 4
# qwen2-moe's input seed: one whose per-shard load-balance losses' mean
# misses the global one (checked in the test)
INPUT_SEEDS = {"qwen2-moe-a2.7b": (3, 4)}
LEARN_STEPS = 8
TORCHRUN = ["-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "4", "-m", "repro_torch.launch.train"]
TRAIN_ARGS = ["--arch", "glm4-9b", "--device", "cpu", "--mesh", "debug",
              "--steps", "4", "--batch", "4", "--seq-len", "32", "--warmup",
              "1", "--log-every", "1", "--ckpt-every", "2"]
CLI_WAIT_S = 150            # the ranks' wait for the torchrun run's end
BF16_ULP_BITS = 7                   # bf16: 7 stored fraction bits


def spec_cases(axis_names) -> list:
    """(spec, shape) of every rule kind of ``_NAME_RULES`` (2-D and 3-D,
    a stacked leaf, a replicated one) and the batch's rows, for a mesh of
    these axes; every sharded dim divisible by 4."""
    cases = [(("data", "model"), (8, 12)), (("model", "data"), (8, 12)),
             ((None, "model"), (6, 8)), (("model", "data", None), (4, 8, 6)),
             (("model", None, "data"), (4, 6, 8)),
             ((None, "data", "model"), (3, 8, 12)), ((), (5, 3)),
             (("data", None, None), (4, 5, 6))]
    if "pod" in axis_names:
        cases += [((("pod", "data"), None), (4, 5)),
                  (("pod", "model"), (4, 8))]
    return cases


def _torch_batch(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: (torch.from_numpy(v).long() if k.endswith(
        "tokens") else torch.from_numpy(v))
        for k, v in arrays.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# One rank of the spawn
# ---------------------------------------------------------------------------

def _worker(rank: int, d: pathlib.Path):
    import torch.distributed as tdist

    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.distributed import Mesh
    from repro_torch.data import SyntheticLM
    from repro_torch.models import convert
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                             rank=rank, world_size=WORLD, timeout=PG_TIMEOUT)
    meshes = {name: Mesh(shape, axes, device="cpu", transport="gloo",
                         timeout=PG_TIMEOUT)
              for name, (shape, axes) in MESHES.items()}
    out = {"coords": {k: m.coords for k, m in meshes.items()}}

    def blocks_npz(name: str, cfg, state):
        arrays = {f"params/{n}": p.detach().numpy()
                  for n, p in state["params"].named_parameters()}
        for part in ("m", "v"):
            arrays.update({f"{part}/{n}": t.float().numpy()
                           for n, t in state["opt"][part].items()})
        arrays["step"] = state["opt"]["step"].numpy()
        np.savez(d / f"{name}_rank{rank}.npz", **arrays)

    def restore(cfg, opt, mesh, path, step):
        skel = S.init_train_state(cfg, None, opt, device="cpu", mesh=mesh)
        specs = convert.train_state_specs_to_jax(cfg, S.state_specs(cfg,
                                                                    skel))
        tree = ckpt.restore_checkpoint(
            str(path), step, convert.train_state_shapes(cfg, skel),
            mesh=mesh, specs=specs)
        return convert.train_state_from_jax(cfg, tree, device="cpu",
                                            mesh=mesh)

    # (b) shard then unshard, bitwise
    out["roundtrip"] = {}
    for mname, mesh in meshes.items():
        for i, (spec, shape) in enumerate(spec_cases(mesh.axis_names)):
            leaf = torch.arange(math.prod(shape), dtype=torch.float32
                                ).reshape(shape).to(torch.bfloat16)
            blk = shd.shard_leaf(mesh, leaf, spec)
            whole = shd.unshard_leaf(mesh, blk, spec)
            out["roundtrip"][f"{mname}/{i}"] = dict(
                equal=bool(torch.equal(whole, leaf)), block=list(blk.shape))

    # (c), (d) the 2x2 mesh against one device
    mesh = meshes["2x2"]
    opt = AdamWConfig(**OPT)
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        state = restore(cfg, opt, mesh, d / f"c_{arch}", 0)
        blocks_npz(f"c0_{arch}", cfg, state)
        with np.load(d / f"c_{arch}_in.npz") as f:
            inputs = {k: f[k] for k in f.files}
        b0, b1 = _torch_batch(inputs, "0/"), _torch_batch(inputs, "1/")
        specs = S.state_specs(cfg, state)["params"]
        res = {}
        dtypes = (torch.float32, torch.bfloat16) if arch == "glm4-9b" \
            else (torch.float32,)
        for dt in dtypes:
            before = dict(mesh.nbytes)
            loss, lb, grads = S.mesh_grads(cfg, state["params"], b0, dt,
                                           mesh, specs)
            tag = str(dt).removeprefix("torch.")
            res[f"grads_{tag}"] = dict(
                loss=float(loss), lb=float(lb),
                nbytes={k: v - before.get(k, 0) for k, v in
                        mesh.nbytes.items()
                        if k.startswith("grad_") and v - before.get(k, 0)},
                dtypes={n: str(g.dtype).removeprefix("torch.")
                        for n, g in grads.items()})
            np.savez(d / f"grads_{tag}_{arch}_rank{rank}.npz",
                     **{n: g.float().numpy() for n, g in grads.items()})
            del grads
        step = S.make_train_step(cfg, opt, mesh=mesh,
                                 compute_dtype=torch.float32)
        for i, b in enumerate((b0, b1)):
            state, m = step(state, b)
            res[f"step{i}"] = {k: float(v) for k, v in m.items()}
            if i == 0:
                blocks_npz(f"c1_{arch}", cfg, state)
        out[f"c/{arch}"] = res

    # (e) the twin of test_sharded_train_step_learns
    cfg = configs.get_smoke("glm4-9b")
    opt = AdamWConfig(lr=1e-3)
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0), opt,
                               device="cpu", mesh=mesh)
    step = S.make_train_step(cfg, opt, mesh=mesh, compute_dtype=torch.float32)
    data = SyntheticLM(cfg, batch=4, seq_len=32, device="cpu")
    losses = []
    before = (dict(mesh.counts), dict(mesh.nbytes))
    for i in range(LEARN_STEPS):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
        if i == 1:    # (h) what the first two steps' collectives moved
            out["two_steps"] = {
                "counts": {k: v - before[0].get(k, 0)
                           for k, v in mesh.counts.items()
                           if v - before[0].get(k, 0)},
                "nbytes": {k: v - before[1].get(k, 0)
                           for k, v in mesh.nbytes.items()
                           if v - before[1].get(k, 0)}}
    out["learns"] = losses

    # (f) elastic: the 2x2 state checkpointed, restored onto 4x1; a
    # JAX-written checkpoint restored onto 2x2
    jspecs = convert.train_state_specs_to_jax(cfg, S.state_specs(cfg, state))
    path = ckpt.save_checkpoint(str(d / "ck22"), LEARN_STEPS,
                                convert.train_state_tree(cfg, state),
                                mesh=mesh, specs=jspecs)
    out["ck22_path"] = path
    blocks_npz("f22", cfg, state)
    blocks_npz("f41", cfg, restore(cfg, opt, meshes["4x1"], d / "ck22",
                                   LEARN_STEPS))
    blocks_npz("fjax", cfg, restore(cfg, opt, mesh, d / "fjax", 7))
    out["counts"] = dict(mesh.counts)
    out["cli"] = _cli_in_ranks(rank, d)
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    tdist.destroy_process_group()


def _cli_in_ranks(rank: int, d: pathlib.Path) -> dict:
    """(g) ``launch.train.main`` in these ranks (their process group is
    the mesh's): once the torchrun run of TRAIN_ARGS has written its step
    4, its step-2 checkpoint resumed to step 4; then a 40-step run whose
    rank 2 alone raises SIGTERM as step 1's batch is drawn.  Each run's
    return code and rank 0's printout."""
    import contextlib
    import io

    import torch.distributed as tdist

    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_cli

    def run(argv):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = train_cli.main(argv)
        return {"rc": rc, "out": text.getvalue()}

    whole, resumed = d / "cli_whole", d / "cli_resumed"
    deadline = time.time() + CLI_WAIT_S
    while not (whole / "step_00000004").exists():
        if time.time() > deadline:
            raise TimeoutError(f"no step 4 under {whole} in {CLI_WAIT_S} s")
        time.sleep(0.2)
    if rank == 0:
        shutil.copytree(whole / "step_00000002",
                        resumed / "step_00000002")
    tdist.barrier()
    out = {"resumed": run(TRAIN_ARGS + ["--ckpt-dir", str(resumed),
                                        "--resume", "auto"])}

    class Interrupted(SyntheticLM):
        def batch_at(self, step, dtype=torch.float32):
            if step == 1 and rank == 2:
                signal.raise_signal(signal.SIGTERM)
            return super().batch_at(step, dtype)

    argv = list(TRAIN_ARGS)
    argv[argv.index("--steps") + 1] = "40"
    argv[argv.index("--ckpt-every") + 1] = "100"
    train_cli.SyntheticLM = Interrupted
    try:
        out["sigterm"] = run(argv + ["--ckpt-dir", str(d / "cli_sig")])
    finally:
        train_cli.SyntheticLM = SyntheticLM
    return out


# ---------------------------------------------------------------------------
# The spawn and the references
# ---------------------------------------------------------------------------

_JAX_BLOCKS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases, out = json.loads(sys.argv[1]), {}
devs = np.array(jax.devices())
for mname, (shape, axes, specs) in cases.items():
    mesh = Mesh(devs.reshape(shape), tuple(axes))
    for i, (spec, leaf) in enumerate(specs):
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(leaf))
        out[f"{mname}/{i}"] = {
            str(dev.id): [[s.start or 0, leaf[k] if s.stop is None else s.stop]
                          for k, s in enumerate(sl)]
            for dev, sl in idx.items()}
print("RESULT" + json.dumps(out))
"""


def _start(argv, env, log: pathlib.Path):
    fh = open(log, "w")
    return subprocess.Popen(argv, env=env, stdout=fh,
                            stderr=subprocess.STDOUT, text=True), fh


def _finish(procs, deadline: float) -> dict:
    """Wait for every process until ``deadline``; kill what is left."""
    rcs = {}
    for name, (proc, fh) in procs.items():
        try:
            rcs[name] = proc.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            rcs[name] = "timeout"
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()
    return rcs


def _np_state(tree, seed=None, step=0) -> dict:
    """A JAX train state over numpy parameter tree ``tree``: zero moments
    at step 0, or moments drawn from ``seed`` (v positive)."""
    import jax
    rng = np.random.default_rng(seed)

    def moment(positive):
        if seed is None:
            return jax.tree.map(np.zeros_like, tree)
        return jax.tree.map(lambda p: (np.abs(rng.standard_normal(p.shape))
                                       if positive else rng.standard_normal(
                                           p.shape)).astype(p.dtype), tree)
    return {"params": tree, "opt": {"step": np.asarray(step, np.int32),
                                    "m": moment(False), "v": moment(True)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro.checkpoint import save_checkpoint as jsave

    import torch_lm_twins as tw
    from repro import configs as jconfigs
    d = tmp_path_factory.mktemp("lm_mesh")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    t0 = time.time()
    trees = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_smoke(arch)
        trees[arch] = tw.np_tree(jcfg, 0)
        jsave(str(d / f"c_{arch}"), 0, _np_state(trees[arch]))
        seeds = INPUT_SEEDS.get(arch, (0, 1))
        np.savez(d / f"c_{arch}_in.npz", **{
            f"{i}/{k}": v for i, s in enumerate(seeds)
            for k, v in tw.np_inputs(jcfg, s, SEQ, ROWS).items()})
    jax_state = _np_state(tw.np_tree(jconfigs.get_smoke("glm4-9b"), 5),
                          seed=5, step=7)
    jsave(str(d / "fjax"), 7, jax_state)
    cases = {m: (shape, axes, spec_cases(axes))
             for m, (shape, axes) in MESHES.items()}
    cases["1x4"] = ((1, 4), ("data", "model"),
                    spec_cases(("data", "model")))
    procs = {
        "jax_blocks": _start([sys.executable, "-c", _JAX_BLOCKS,
                              json.dumps(cases)], env, d / "jax_blocks.log"),
        "cli_whole": _start([sys.executable, *TORCHRUN, *TRAIN_ARGS,
                             "--ckpt-dir", str(d / "cli_whole")], env,
                            d / "cli_whole.log"),
        **{f"rank{r}": _start([sys.executable, __file__, str(r), str(d)],
                              env, d / f"rank{r}.log") for r in range(WORLD)}}
    rcs = _finish(procs, t0 + DEADLINE_S)
    logs = {n: (d / f"{n}.log").read_text() for n in procs}
    for name in procs:
        assert rcs[name] == 0, f"{name}: rc {rcs[name]}\n{logs[name][-4000:]}"
    line = [ln for ln in logs["jax_blocks"].splitlines()
            if ln.startswith("RESULT")][-1]
    return dict(d=d, trees=trees, jax_state=jax_state, cases=cases,
                jax_blocks=json.loads(line[len("RESULT"):]),
                ranks=[json.loads((d / f"rank{r}.json").read_text())
                       for r in range(WORLD)],
                cli_whole=logs["cli_whole"])


def _block(arr, spec: tuple, mesh: str, coords: dict):
    """The block of ``arr`` at ``coords`` of mesh ``mesh`` under ``spec``,
    as NamedSharding places it: along a dim split over axes (a, b), block
    coords[a] * size(b) + coords[b] of equal blocks."""
    sizes = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
    idx = []
    for k, n in enumerate(arr.shape):
        e = spec[k] if k < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        i, parts = 0, 1
        for a in axes:
            i, parts = i * sizes[a] + coords[a], parts * sizes[a]
        idx.append(slice(i * (n // parts), (i + 1) * (n // parts)))
    return arr[tuple(idx)]


def _rank_blocks(runs, name: str, rank: int) -> dict:
    with np.load(runs["d"] / f"{name}_rank{rank}.npz") as f:
        return {k: f[k] for k in f.files}


def _whole(cfg, state) -> dict:
    """A copy of a port state as ``{"params/<name>", "m/<name>",
    "v/<name>", "step": numpy}``, moments widened to f32."""
    out = {f"params/{n}": p.detach().numpy().copy()
           for n, p in state["params"].named_parameters()}
    for part in ("m", "v"):
        out.update({f"{part}/{n}": t.float().numpy().copy()
                    for n, t in state["opt"][part].items()})
    out["step"] = state["opt"]["step"].numpy().copy()
    return out


def _specs(cfg) -> dict:
    """The port's state specs keyed as :func:`_whole` keys the state."""
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    sp = S.state_specs(cfg, S.init_train_state(cfg, None, AdamWConfig(),
                                               device="cpu"))
    out = {f"params/{n}": s for n, s in sp["params"].items()}
    out.update({f"{p}/{n}": s for p in ("m", "v")
                for n, s in sp["opt"][p].items()})
    out["step"] = ()
    return out


def _port_state(arch, tree_state):
    from repro_torch import configs
    from repro_torch.models import convert
    cfg = configs.get_smoke(arch)
    return cfg, convert.train_state_from_jax(cfg, tree_state, device="cpu")


def _bar(cfg) -> float:
    return BARS.get(cfg.family, 1e-5)


def _port_grads(cfg, model, batch, compute_dtype):
    from repro_torch.models import steps as S
    cmodel = S.cast_compute(cfg, model, compute_dtype)
    loss, aux = S.loss_fn(cfg, cmodel, batch, compute_dtype)
    names, leaves = zip(*cmodel.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), float(aux["load_balance_loss"].detach()), \
        dict(zip(names, grads))


@functools.lru_cache(maxsize=None)
def _one_device(arch: str):
    """The port's one-device references on the twins' tree and inputs:
    the f32 and bf16 gradients at the start, and the state and metrics
    after each of two f32 steps."""
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    import torch_lm_twins as tw
    from repro import configs as jconfigs
    jcfg = jconfigs.get_smoke(arch)
    cfg, state = _port_state(arch, _np_state(tw.np_tree(jcfg, 0)))
    seeds = INPUT_SEEDS.get(arch, (0, 1))
    batches = [tw.to_torch(tw.np_inputs(jcfg, s, SEQ, ROWS)) for s in seeds]
    out = {"grads": {}}
    for dt in (torch.float32, torch.bfloat16)[:2 if arch == "glm4-9b" else 1]:
        loss, lb, g = _port_grads(cfg, state["params"], batches[0], dt)
        out["grads"][str(dt).removeprefix("torch.")] = (loss, lb, g)
    step = S.make_train_step(cfg, AdamWConfig(**OPT),
                             compute_dtype=torch.float32)
    out["states"], out["metrics"] = [], []
    for b in batches:
        state, m = step(state, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(_whole(cfg, state))
    return cfg, out, batches


# ---------------------------------------------------------------------------
# (a) specs, no spawn
# ---------------------------------------------------------------------------

def _jax_tuple(spec) -> tuple:
    return tuple(spec)


def _mesh_shapes():
    from repro_torch.launch.mesh import MeshShape, make_production_mesh
    debug = {f"{a}x{b}": MeshShape({"data": a, "model": b},
                                   ("data", "model"))
             for a, b in ((2, 2), (4, 1), (1, 4))}
    return {**debug, "pod": make_production_mesh(),
            "multipod": make_production_mesh(multi_pod=True)}


# batch sizes that reach each fall-back of batch_axes / dp_axes_for that
# the mesh has (all batch axes, data alone, no split), and the axes they
# give
BATCHES = {"2x2": ((4, 2, 3), {("data",), None}),
           "4x1": ((8, 4, 2), {("data",), None}),
           "1x4": ((4, 3), {("data",)}),
           "pod": ((32, 16, 8), {("data",), None}),
           "multipod": ((64, 16, 8), {("pod", "data"), ("data",), None})}


def test_specs_match_jax_for_every_leaf():
    """For all ten smoke architectures: the port's state specs (keyed by
    its parameter names) in JAX's tree equal JAX's ``state_specs`` of
    ``jax.eval_shape(init_train_state)`` leaf by leaf, and the port's
    ``param_specs`` of the twins' numpy tree equal JAX's."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro import configs as jconfigs
    from repro.models import steps as JS
    from repro.optim import AdamWConfig as JAdamW
    from repro.parallel import sharding as jshd

    import torch_lm_twins as tw
    from repro_torch import configs
    from repro_torch.models import convert
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    held = 0
    for arch in configs.all_arch_names():
        jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
        jshape = jax.eval_shape(lambda: JS.init_train_state(
            jcfg, jax.random.PRNGKey(0), JAdamW()))
        want = jax.tree_util.tree_flatten_with_path(
            JS.state_specs(jcfg, jshape),
            is_leaf=lambda x: isinstance(x, P))[0]
        state = S.init_train_state(cfg, None, AdamWConfig(), device="cpu")
        got = convert.train_state_specs_to_jax(cfg, S.state_specs(cfg, state))
        for path, spec in want:
            node = got
            for k in path:
                node = node[getattr(k, "key", getattr(k, "idx", None))]
            assert node == _jax_tuple(spec), (arch, path, node, spec)
            held += 1
        assert len(jax.tree_util.tree_leaves(
            got, is_leaf=lambda x: isinstance(x, tuple))) == len(want), arch
        tree = tw.np_tree(jcfg, 0) if arch in ARCHS else \
            jax.eval_shape(lambda: JS.model_module(jcfg).init_params(
                jcfg, jax.random.PRNGKey(0)))
        jps = jax.tree_util.tree_leaves(jshd.param_specs(tree),
                                        is_leaf=lambda x: isinstance(x, P))
        pps = jax.tree_util.tree_leaves(
            shd.param_specs(tree), is_leaf=lambda x: isinstance(x, tuple))
        assert [tuple(s) for s in jps] == pps, arch
    assert held > 300, held


@pytest.mark.parametrize("mesh", list(BATCHES))
def test_batch_rules_match_jax(mesh):
    """``batch_axes``, ``dp_axes_for``, ``batch_specs`` (each family's
    batch leaves), ``tp_axis_for`` and ``tp_size`` equal JAX's on the
    mesh shape, at batch sizes that take every fall-back."""
    from repro import configs as jconfigs
    from repro.models import steps as JS
    from repro.parallel import sharding as jshd

    import torch_lm_twins as tw
    from repro_torch import configs
    from repro_torch.models import steps as S
    from repro_torch.parallel import sharding as shd
    m = _mesh_shapes()[mesh]
    got_axes = set()
    sizes, axes = BATCHES[mesh]
    for batch in sizes:
        assert shd.batch_axes(m, batch) == jshd.batch_axes(m, batch)
        assert S.dp_axes_for(m, batch) == JS.dp_axes_for(m, batch)
        got_axes.add(S.dp_axes_for(m, batch))
        for arch in ("glm4-9b", "pixtral-12b", "seamless-m4t-large-v2"):
            jcfg = jconfigs.get_smoke(arch)
            inp = tw.np_inputs(jcfg, 0, 8, batch)
            want = JS.batch_specs(jcfg, inp, m)
            got = S.batch_specs(configs.get_smoke(arch), tw.to_torch(inp), m)
            assert got == {k: tuple(v) for k, v in want.items()}, \
                (mesh, batch, arch)
    assert shd.batch_axes(m) == jshd.batch_axes(m)
    assert got_axes == axes
    with jshd.set_mesh(m):
        for size in (4, 6, 16, 17):
            assert shd.tp_axis_for(size, m) == jshd.tp_axis_for(size)
        assert shd.tp_size(m) == jshd.tp_size()


def test_uneven_block_raises_as_jax():
    """A dim its axes do not divide raises, in JAX's words (JAX's
    ``device_put`` and ``jit`` refuse such a sharding)."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.parallel import sharding as shd
    m = MeshShape({"data": 2, "model": 2}, ("data", "model"))
    with pytest.raises(ValueError, match="should be divisible by 2, but it "
                                         "is equal to 3"):
        shd.block_slices(m, ("data", "model"), (3, 4), {"data": 0,
                                                         "model": 1})


# ---------------------------------------------------------------------------
# (b) blocks
# ---------------------------------------------------------------------------

def test_blocks_are_jax_placements(runs):
    """Every rule kind's block at every rank of the 2x2, 4x1, 1x4 and
    2x1x2 meshes is the slice ``NamedSharding`` places on that device."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.parallel import sharding as shd
    held = 0
    for mname, (shape, axes, cases) in runs["cases"].items():
        m = MeshShape(dict(zip(axes, shape)), tuple(axes))
        for i, (spec, leaf) in enumerate(cases):
            want = runs["jax_blocks"][f"{mname}/{i}"]
            for r in range(WORLD):
                coords = dict(zip(axes, (int(c) for c in np.unravel_index(
                    r, shape))))
                sl = shd.block_slices(m, spec, leaf, coords)
                assert [[s.start, s.stop] for s in sl] == want[str(r)], \
                    (mname, spec, r)
                held += 1
    assert held == WORLD * sum(len(c[2]) for c in runs["cases"].values())


def test_shard_then_unshard_is_the_leaf(runs):
    """``shard_leaf`` then ``unshard_leaf`` (one gather over the axes the
    spec names) gives back the bf16 leaf bitwise on every rank."""
    for r, rk in enumerate(runs["ranks"]):
        rt = rk["roundtrip"]
        assert rt and all(v["equal"] for v in rt.values()), (r, rt)


# ---------------------------------------------------------------------------
# (c) the 2x2 step against one device and JAX
# ---------------------------------------------------------------------------

def _check_leaf(got, want, scale, bar, what):
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= bar * scale, f"{what}: {err} > {bar} x {scale}"


def _check_grads(got: dict, want: dict, bar: float, what: str):
    """Every gradient leaf within bar x max(its largest |g|, 1e-3 x the
    tree's) of ``want``'s."""
    assert got.keys() == want.keys(), what
    big = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        _check_leaf(got[k], w, max(float(np.abs(w).max()), 1e-3 * big), bar,
                    f"{what} {k}")


def _check_state_blocks(runs, name, cfg, want: dict, grads: dict, bar,
                        lr=OPT["lr"], eps=1e-8):
    """Every rank's blocks against ``want``'s blocks: m and v within the
    gradient bar; the parameters within it carried through Adam's first
    update (tests/test_torch_lm_train.py::test_train_step_matches_jax):
    an entry may move by up to lr eps delta / (|g| - delta + eps)^2 (at
    most 2 lr) where the gradient is within delta of the reference's."""
    specs = _specs(cfg)
    gbig = max(float(np.abs(g).max()) for g in grads.values())
    big = {p: max(float(np.abs(v).max()) for k, v in want.items()
                  if k.startswith(p)) for p in ("params", "m", "v")}
    for r, rk in enumerate(runs["ranks"]):
        got = _rank_blocks(runs, name, r)
        assert got.keys() == want.keys()
        assert int(got["step"]) == int(want["step"])
        for key, w in want.items():
            if key == "step":
                continue
            part, pname = key.split("/", 1)
            wb = _block(w, specs[key], "2x2", rk["coords"]["2x2"])
            scale = max(float(np.abs(w).max()), 1e-3 * big[part])
            if part != "params":
                _check_leaf(got[key], wb, scale, bar, f"{name} {key} rank {r}")
                continue
            g = grads[pname]
            delta = bar * max(float(np.abs(g).max()), 1e-3 * gbig)
            room = np.minimum(2.0, eps * delta / (
                np.maximum(np.abs(g) - delta, 0.0) + eps) ** 2)
            err = np.abs(got[key].astype(np.float64) - wb)
            assert (err <= bar * scale + lr * _block(
                room, specs[key], "2x2", rk["coords"]["2x2"])).all(), \
                (name, key, r)


def _mesh_grads(runs, tag, arch) -> dict:
    """The whole gradients the four ranks' blocks make up on the 2x2 mesh
    (``mesh_grads`` leaves each rank its block); the copies of a block
    that ranks share agree bitwise."""
    from repro_torch import configs
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.parallel import sharding as shd
    specs = _specs(configs.get_smoke(arch))
    shape, axes = MESHES["2x2"]
    m = MeshShape(dict(zip(axes, shape)), axes)
    out = {}
    for r, rk in enumerate(runs["ranks"]):
        with np.load(runs["d"] / f"grads_{tag}_{arch}_rank{r}.npz") as f:
            for k in f.files:
                spec, blk = specs[f"params/{k}"], f[k]
                if k not in out:
                    out[k] = np.full(shd.global_shape(m, spec, blk.shape),
                                     np.nan, blk.dtype)
                sl = shd.block_slices(m, spec, out[k].shape,
                                      rk["coords"]["2x2"])
                seen = out[k][sl]
                assert np.isnan(seen).all() or \
                    seen.tobytes() == blk.tobytes(), (arch, k, r)
                out[k][sl] = blk
    assert not any(np.isnan(g).any() for g in out.values()), arch
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_one_device(runs, arch):
    """On the 2x2 mesh: the state restored from the JAX-written
    checkpoint is the tree's blocks bitwise; the first step's loss,
    load-balance loss and every gradient leaf within the bar of the
    one-device step's on the whole batch; both steps' metrics within it;
    after the first step every rank's blocks of m and v within it and of
    the parameters within it carried through the update; every rank
    reports the same metrics."""
    cfg, ref, _ = _one_device(arch)
    bar = _bar(cfg)
    specs = _specs(cfg)
    _, start = _port_state(arch, _np_state(runs["trees"][arch]))
    start = _whole(cfg, start)
    for r, rk in enumerate(runs["ranks"]):
        got = _rank_blocks(runs, f"c0_{arch}", r)
        for key, w in start.items():
            wb = _block(w, specs[key], "2x2", rk["coords"]["2x2"])
            assert got[key].tobytes() == wb.tobytes(), (arch, key, r)
    res = [rk[f"c/{arch}"] for rk in runs["ranks"]]
    assert all(x == res[0] for x in res[1:])
    res = res[0]
    loss, lb, grads = ref["grads"]["float32"]
    g = res["grads_float32"]
    assert abs(g["loss"] - loss) <= bar * abs(loss)
    assert abs(g["lb"] - lb) <= bar * max(abs(lb), 1e-3)
    want = {n: t.numpy() for n, t in grads.items()}
    _check_grads(_mesh_grads(runs, "float32", arch), want, bar, arch)
    for i in range(2):
        for key in ("loss", "grad_norm", "load_balance_loss"):
            w = ref["metrics"][i][key]
            assert abs(res[f"step{i}"][key] - w) <= bar * max(abs(w), 1e-3), \
                (arch, i, key, res[f"step{i}"][key], w)
        assert res[f"step{i}"]["step"] == ref["metrics"][i]["step"] == i + 1
    _check_state_blocks(runs, f"c1_{arch}", cfg, ref["states"][0],
                        _mesh_grads(runs, "float32", arch), bar)


def test_moe_load_balance_is_global(runs):
    """qwen2-moe: the mean of the two row shards' load-balance losses
    (each computed on its own rows) misses the global batch's by more
    than 100 bars, and the mesh's load-balance loss is the global one
    within the bar."""
    arch = "qwen2-moe-a2.7b"
    cfg, ref, batches = _one_device(arch)
    model = _port_state(arch, _np_state(runs["trees"][arch]))[1]["params"]
    from repro_torch.models import steps as S
    shards = []
    with torch.no_grad():
        for rows in (slice(0, 2), slice(2, 4)):
            part = {k: v[rows] for k, v in batches[0].items()}
            _, aux = S.loss_fn(cfg, model, part, torch.float32)
            shards.append(float(aux["load_balance_loss"]))
    lb = ref["grads"]["float32"][1]
    bar = _bar(cfg)
    assert abs(np.mean(shards) - lb) > 100 * bar * lb, (shards, lb)
    got = runs["ranks"][0][f"c/{arch}"]["grads_float32"]["lb"]
    assert abs(got - lb) <= bar * lb
    assert runs["ranks"][0]["counts"]["moe_all_reduce"] > 0


def test_glm4_mesh_step_matches_jax_unsharded(runs):
    """glm4-9b's first 2x2 step against JAX's unsharded jitted
    ``make_train_step`` on the same tree and whole batch (f32 compute):
    the metrics within the bar, every rank's blocks of m and v within it
    and of the parameters within it carried through the update."""
    import jax
    import jax.numpy as jnp
    from repro.models import steps as JS
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import adamw_init as jadamw_init

    import torch_lm_twins as tw
    from repro import configs as jconfigs
    arch = "glm4-9b"
    jcfg = jconfigs.get_smoke(arch)
    jparams = jax.tree.map(jnp.asarray, runs["trees"][arch])
    jstate = {"params": jparams, "opt": jadamw_init(jparams, JAdamW(**OPT))}
    inp = tw.np_inputs(jcfg, INPUT_SEEDS.get(arch, (0, 1))[0], SEQ, ROWS)
    jnew, jmet = jax.jit(JS.make_train_step(
        jcfg, JAdamW(**OPT), compute_dtype=jnp.float32))(
        jstate, {k: jnp.asarray(v) for k, v in inp.items()})
    cfg, want = _port_state(arch, jax.tree.map(np.asarray, jnew))
    bar = _bar(cfg)
    res = runs["ranks"][0][f"c/{arch}"]["step0"]
    for key in ("loss", "grad_norm", "load_balance_loss"):
        w = float(jmet[key])
        assert abs(res[key] - w) <= bar * max(abs(w), 1e-3), key
    _check_state_blocks(runs, f"c1_{arch}", cfg, _whole(cfg, want),
                        _mesh_grads(runs, "float32", arch), bar)


# ---------------------------------------------------------------------------
# (d) bf16 gradients reduced in bf16
# ---------------------------------------------------------------------------

def test_bf16_gradients_reduce_in_bf16(runs):
    """glm4-9b with bf16 compute: every matmul weight's gradient crosses
    the reduction over ``data`` as bf16 and the norm scales' as f32: a
    leaf split over ``data`` in its layer's reduce-scatter (its bytes
    those of this rank's ``model`` block, the data ranks' blocks joined),
    any other in an all-reduce of its block; every reduced leaf within 2
    bf16 ulps of its largest |g| (ulp: the spacing of bf16 numbers at
    that value) of the one-device bf16 gradients."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.parallel import sharding as shd
    arch = "glm4-9b"
    cfg, ref, _ = _one_device(arch)
    res = runs["ranks"][0][f"c/{arch}"]["grads_bfloat16"]
    _, _, want = ref["grads"]["bfloat16"]
    assert res["dtypes"] == {n: str(g.dtype).removeprefix("torch.")
                             for n, g in want.items()}
    assert "bfloat16" in res["dtypes"].values()
    specs = _specs(cfg)
    shape, axes = MESHES["2x2"]
    m = MeshShape(dict(zip(axes, shape)), axes)
    nbytes = {}
    for n, g in want.items():
        spec = specs[f"params/{n}"]
        blk = math.prod(shd.block_shape(m, spec, g.shape)) * g.element_size()
        split = "data" in shd.spec_axes(m, spec)
        key = (f"grad_{'reduce_scatter' if split else 'all_reduce'}/"
               f"{str(g.dtype).removeprefix('torch.')}")
        nbytes[key] = nbytes.get(key, 0) + blk * (m.shape["data"] if split
                                                  else 1)
    assert res["nbytes"] == nbytes
    got = _mesh_grads(runs, "bfloat16", arch)
    worst = 0.0
    for n, g in want.items():
        w = g.float().numpy()
        top = float(np.abs(w).max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - BF16_ULP_BITS)
        err = float(np.abs(got[n] - w).max())
        assert err <= 2 * ulp, (n, err / ulp)
        worst = max(worst, err / ulp)
    assert worst > 0      # the reduction's roundings are there to see


# ---------------------------------------------------------------------------
# (e), (f)
# ---------------------------------------------------------------------------

def test_sharded_train_step_learns(runs):
    """Twin of tests/test_distributed.py::test_sharded_train_step_learns:
    eight steps on the 2x2 mesh, glm4-9b smoke, batch 4 x 32, lr 1e-3,
    f32 compute; the loss falls, the same on every rank."""
    losses = runs["ranks"][0]["learns"]
    assert all(rk["learns"] == losses for rk in runs["ranks"][1:])
    assert len(losses) == LEARN_STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_recording_mesh_counts_as_gloo(runs):
    """(h) glm4-9b's smoke config, (e)'s state and first two batches on
    the meta device and a recording 2x2 mesh at each rank's coordinates:
    the collectives' calls and bytes by kind and dtype equal what the
    rank's gloo mesh counted."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import MeshShape, RecordingMesh
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    cfg = configs.get_smoke("glm4-9b")
    opt = AdamWConfig(lr=1e-3)
    shape, axes = MESHES["2x2"]
    data = SyntheticLM(cfg, batch=4, seq_len=32, device="cpu")
    for r, rk in enumerate(runs["ranks"]):
        mesh = RecordingMesh(MeshShape(dict(zip(axes, shape)), axes),
                             rk["coords"]["2x2"])
        state = S.init_train_state(cfg, None, opt, device="meta", mesh=mesh)
        step = S.make_train_step(cfg, opt, mesh=mesh,
                                 compute_dtype=torch.float32)
        for i in range(2):
            state, _ = step(state, {k: torch.empty_like(v, device="meta")
                                    for k, v in data.batch_at(i).items()})
        assert dict(mesh.counts) == rk["two_steps"]["counts"], r
        assert dict(mesh.nbytes) == rk["two_steps"]["nbytes"], r
    assert rk["two_steps"]["nbytes"]["grad_all_reduce/float32"] > 0


def test_elastic_restore_across_meshes(runs):
    """Twin of tests/test_fault_tolerance.py::
    test_elastic_restore_across_meshes: the 2x2 run's checkpoint holds
    whole arrays, restores onto one device as the 2x2 blocks' whole
    leaves bitwise, and onto the 4x1 mesh as that mesh's blocks
    bitwise; a checkpoint JAX's ``save_checkpoint`` wrote restores onto
    the 2x2 mesh as its blocks bitwise."""
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.models import convert
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    cfg = configs.get_smoke("glm4-9b")
    skel = S.init_train_state(cfg, None, AdamWConfig(lr=1e-3), device="cpu")
    tree = ckpt.restore_checkpoint(str(runs["d"] / "ck22"), LEARN_STEPS,
                                   convert.train_state_shapes(cfg, skel))
    one = _whole(cfg, convert.train_state_from_jax(cfg, tree, device="cpu"))
    _, jax_one = _port_state("glm4-9b", runs["jax_state"])
    jax_one = _whole(cfg, jax_one)
    specs = _specs(cfg)
    assert int(one["step"]) == LEARN_STEPS and int(jax_one["step"]) == 7
    for name, mesh, whole in (("f22", "2x2", one), ("f41", "4x1", one),
                              ("fjax", "2x2", jax_one)):
        for r, rk in enumerate(runs["ranks"]):
            got = _rank_blocks(runs, name, r)
            assert got.keys() == whole.keys()
            for key, w in whole.items():
                wb = _block(w, specs[key], mesh, rk["coords"][mesh])
                assert got[key].shape == wb.shape and \
                    got[key].tobytes() == wb.tobytes(), (name, key, r)


# ---------------------------------------------------------------------------
# (g) the CLI
# ---------------------------------------------------------------------------

def test_cli_mesh_resume_is_bitwise_uninterrupted(runs):
    """``torchrun ... -m repro_torch.launch.train --mesh debug --device
    cpu``: 4 steps with checkpoints at 2 and 4, rank 0 alone printing;
    its step-2 checkpoint resumed by the CLI's ``main`` in the four test
    ranks prints the same losses for steps 2 and 3 and ends in the same
    step-4 checkpoint, bitwise."""
    log_a = runs["cli_whole"]
    res = [rk["cli"]["resumed"] for rk in runs["ranks"]]
    assert [r["rc"] for r in res] == [0] * WORLD
    log_b = res[0]["out"]
    assert all(not r["out"] for r in res[1:])    # rank 0 alone prints
    steps_a = [ln for ln in log_a.splitlines()
               if ln.startswith("[train] step=")]
    steps_b = [ln for ln in log_b.splitlines()
               if ln.startswith("[train] step=")]
    assert [ln.split()[1] for ln in steps_a] == [f"step={i}" for i in
                                                 range(4)]
    assert "[train] resuming from step 2" in log_b
    assert [ln.split()[1:3] for ln in steps_a[2:]] == \
        [ln.split()[1:3] for ln in steps_b]
    a, b = (runs["d"] / k / "step_00000004" / "arrays.npz"
            for k in ("cli_whole", "cli_resumed"))
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].tobytes() == y[k].tobytes(), k


def test_cli_mesh_sigterm_checkpoints_every_rank(runs):
    """The CLI on the 2x2 mesh with SIGTERM raised in rank 2 alone during
    step 1: every rank stops after that step (they agree through an
    all-reduce), the step-2 checkpoint is written and complete, and
    every rank's ``main`` returns 0."""
    from repro_torch.checkpoint.ckpt import valid_steps
    sig = [rk["cli"]["sigterm"] for rk in runs["ranks"]]
    assert [r["rc"] for r in sig] == [0] * WORLD, sig
    assert "SIGTERM received; checkpointed and exiting" in sig[0]["out"]
    assert valid_steps(str(runs["d"] / "cli_sig")) == [2]
    assert [ln.split()[1] for ln in sig[0]["out"].splitlines()
            if ln.startswith("[train] step=")] == ["step=0", "step=1"]


@pytest.mark.parametrize("kind,size", [("pod", 256), ("multipod", 512)])
def test_cli_production_mesh_needs_its_size(kind, size, monkeypatch):
    from repro_torch.launch import train as train_cli
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match=f"needs a torchrun job of {size} "
                                         "ranks, this one has 4"):
        train_cli.main(["--arch", "glm4-9b", "--mesh", kind,
                        "--device", "cpu"])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), pathlib.Path(sys.argv[2]))
