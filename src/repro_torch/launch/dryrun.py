"""LM dry-run: every (architecture x input-shape x mesh) cell of the port's
own train, prefill and decode steps, traced on the meta device, with its
roofline terms: the JAX package's ``launch/dryrun.py``.

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all            # every cell

No card is needed.  Each cell writes
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

JAX lowers and compiles each cell for 512 placeholder devices and reads
XLA's analyses of the partitioned program.  The port runs its program
instead, as the rank at coordinates 0 of the 16 x 16 (``pod``) or
2 x 16 x 16 (``multipod``) mesh runs it: the arguments of
``launch/specs.py::input_specs`` on the meta device, the mesh a
:class:`~repro_torch.launch.mesh.RecordingMesh`, every ATen op seen by
:class:`Trace`.  Per cell:

1. the full-depth trace, the runnability artifact (JAX's step 1): the
   rank's peak live bytes (:class:`Trace`'s storage tracker; the
   arguments live from the start), what the peak holds, and the counts
   of every layer (``cost_fulltrace``);
2. the cost pass (JAX's step 2): traces at k1 = p and k2 = 2p layers
   (p the hybrid's pattern length, else 1), extrapolated linearly in
   depth by :func:`_extrapolate` (JAX's, verbatim): matmul flops by
   operand dtype, bytes each ATen op reads and writes (inputs plus
   outputs: eager PyTorch's unfused traffic), and collectives by kind and
   bytes from the recording mesh, each kind also under XLA's name;
3. the roofline: compute term the sum over dtypes of flops / the H100
   SXM peak for that dtype (``PEAK_FLOPS``); memory term bytes / ``--bw``
   (a measured copy rate) or the data sheet's 3.35 TB/s; collective
   bytes with no time (no multi-card measurement); ``dominant`` the
   larger term.  ``model_flops_global`` is JAX's formula, ``fits`` the
   peak against one constant on every host, an H100 80GB HBM3's
   ``total_memory`` less its CUDA context (:func:`fit`; ``marginal``
   within 4 GiB of it).

XLA's fields have no counterpart here and are absent: ``memory_analysis``
(no compiler buffer assignment; the peak live bytes stand in),
``lower_s``/``compile_s`` (nothing is compiled; ``trace_s``), the HLO
collective parser (the recording mesh counts each call), and
``unrolled_scans`` (the port's layers are a Python loop, so every traced
layer is counted).  The port's "bf16 compute" multiplies in f32
(``layers.dot`` upcasts its operands), so its matmul flops are f32 ones.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W), by the
# matmul operands' dtype
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              "float64": 34e12}
HBM_BW = 3.35e12      # H100 SXM HBM3, data sheet
CONSTANTS_SOURCE = "NVIDIA H100 SXM data sheet (dense, 700 W)"
# what a rank holds, on every host: an NVIDIA H100 80GB HBM3's
# ``total_memory`` (85,017,493,504 bytes, 79.18 GiB) less 1.25 GiB for
# what the process holds outside torch's allocator, the CUDA context with
# its loaded modules and library handles (1.038 GiB after chip_smoke.py's
# phases 0-13, 0.747 GiB after phases 11-13 alone); chip_smoke.py phase
# 14 prints both beside these constants
HBM_BYTES = 85_017_493_504
CONTEXT_BYTES = 5 * 2 ** 28
HBM_SOURCE = ("total_memory of an NVIDIA H100 80GB HBM3 (chip_smoke.py "
              "phase 14) less 1.25 GiB for the CUDA context")
# a peak within this of the limit, on either side, is marginal: the
# caching allocator's rounding, reserve and fragmentation are outside
# the traced live bytes
MARGINAL_BYTES = 4 * 2 ** 30
ALLOC_ROUND = 512     # the CUDA caching allocator's size granularity
# the label of the parameters a layer gathered (``parallel/tp.py``)
GATHERED = "param_gather"

# ops that allocate without reading or writing data
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided"}
# queries FlopCounterMode leaves alone
_QUERIES = {"is_contiguous", "sym_is_contiguous", "is_strides_like_format",
            "is_non_overlapping_and_dense", "size", "sym_size", "stride",
            "sym_stride", "storage_offset", "sym_storage_offset", "numel",
            "sym_numel", "dim", "layout"}


def _leaves(obj):
    """The tensors in nested tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Trace(TorchDispatchMode):
    """Counts what the ATen ops run under it do, on any device (meta
    included):

    * ``flops``: matmul flops by the dtype of the first operand, from
      ``torch.utils.flop_counter``'s formulas, with ops decomposed as
      ``FlopCounterMode`` decomposes them (so its total equals
      ``FlopCounterMode``'s on the same program);
    * ``bytes``: every op's tensor inputs and outputs (a view op moves
      nothing; an allocation without data neither);
    * live storage: every storage an op returns, and those
      :meth:`register` names, counted once (a view or an in-place op
      returns a storage already counted) at its size rounded up to 512
      bytes, from the op that made it until Python frees it (autograd's
      saved tensors stay live while the graph holds them).  ``peak`` is
      the largest live total, ``peak_holds`` its bytes by label (the
      registered labels, else ``<op>:<dtype>``).
    """

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.by_label = collections.Counter()
        self.peak_holds = {}
        self._held = {}
        # ops whose ``decompose`` returned NotImplemented (it depends on
        # the op alone): not asked again
        self._no_decomposition = set()

    # -- live storage --------------------------------------------------------

    def _free(self, key, _ref):
        held = self._held.pop(key, None)
        if held is not None:
            self.live -= held[1]
            self.by_label[held[2]] -= held[1]

    def _add(self, t: torch.Tensor, label: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._held[key] = (weakref.ref(st, functools.partial(self._free,
                                                             key)), n, label)
        self.live += n
        self.by_label[label] += n
        if self.live > self.peak:
            self.peak = self.live
            self.peak_holds = {k: v for k, v in self.by_label.items() if v}

    def label(self, t: torch.Tensor, label: str) -> None:
        """Count the storage of ``t``, already live, under ``label`` from
        now on (and in the peak's holdings when it made the peak)."""
        held = self._held.get(id(t.untyped_storage()))
        if held is None or held[2] == label:
            return
        ref, n, old = held
        self._held[id(t.untyped_storage())] = (ref, n, label)
        self.by_label[old] -= n
        self.by_label[label] += n
        if self.live == self.peak:
            self.peak_holds = {k: v for k, v in self.by_label.items() if v}

    def register(self, obj, label: str) -> None:
        """Count the storages of ``obj``'s tensors (a module's parameters,
        nested containers) as live under ``label``."""
        if isinstance(obj, torch.nn.Module):
            obj = [p for _, p in obj.named_parameters()]
        for t in _leaves(obj):
            self._add(t, label)

    # -- dispatch ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        if name in _QUERIES:
            return func(*args, **kwargs)
        if func not in self._no_decomposition and \
                func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            self._no_decomposition.add(func)
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        ins = list(_leaves((args, kwargs)))
        if packet in flop_registry:
            self.flops[str(ins[0].dtype).removeprefix("torch.")] += \
                flop_registry[packet](*args, **kwargs, out_val=out)
        outs = list(_leaves(out))
        if not func.is_view and name not in _NO_DATA:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._add(t, f"{name}:{str(t.dtype).removeprefix('torch.')}")
        return out


def compute_seconds(flops_by_dtype: dict) -> float:
    """The compute term: each dtype's matmul flops at its peak."""
    unknown = set(flops_by_dtype) - set(PEAK_FLOPS)
    if unknown:
        raise ValueError(f"no H100 peak for matmul operands {unknown}")
    return sum(f / PEAK_FLOPS[k] for k, f in flops_by_dtype.items())


def _register_args(tr: Trace, kwargs: dict) -> None:
    """The arguments live from the start, labelled by where they sit:
    ``state.params`` (the f32 master), ``state.opt.m``/``v``/``step``,
    else the argument's name."""
    for key, val in kwargs.items():
        if key == "state":
            tr.register(val["params"], "state.params")
            for part, t in val["opt"].items():
                tr.register(t, f"state.opt.{part}")
        else:
            tr.register(val, key)


def measure(fn, kwargs: dict, mesh=None) -> dict:
    """Run ``fn(**kwargs)`` once under a :class:`Trace` (the arguments
    registered first) and return its counts: ``flops`` (total and
    ``flops_by_dtype``), ``bytes``, the collectives the recording ``mesh``
    tallied in the call (none without one), ``peak_bytes`` with
    ``peak_holds`` (the parameters the layers gathered under
    :data:`GATHERED`), ``arg_bytes`` and ``trace_s``."""
    before = (dict(mesh.counts), dict(mesh.nbytes)) if mesh else ({}, {})
    from repro_torch.parallel import tp
    tr = Trace()
    _register_args(tr, kwargs)
    arg_bytes = tr.live
    t0 = time.perf_counter()
    tp.gathered_hook = functools.partial(tr.label, label=GATHERED)
    try:
        with tr:
            out = fn(**kwargs)
    finally:
        tp.gathered_hook = None
    seconds = time.perf_counter() - t0
    del out
    coll = collectives(mesh, *before)
    return {"flops": float(sum(tr.flops.values())),
            "flops_by_dtype": {k: float(v) for k, v in tr.flops.items()},
            "bytes": float(tr.bytes), "coll_bytes": float(coll["total_bytes"]),
            "coll_count": float(coll["total_count"]), "collectives": coll,
            "peak_bytes": tr.peak, "arg_bytes": arg_bytes,
            "peak_holds": dict(sorted(tr.peak_holds.items(),
                                      key=lambda kv: -kv[1])),
            "ops": tr.ops, "trace_s": seconds}


def collectives(mesh, counts0: dict, nbytes0: dict) -> dict:
    """The collectives ``mesh`` (None: no mesh, none) tallied since
    ``(counts0, nbytes0)``: by the port's kind (calls, bytes by dtype),
    under ``Mesh.nbytes``'s keys (``<kind>/<dtype>``) and by XLA's
    name."""
    out = {"by_kind": {}, "nbytes": {}, "jax_kinds": {}, "total_bytes": 0,
           "total_count": 0}
    for kind, n in (mesh.counts if mesh else {}).items():
        calls = n - counts0.get(kind, 0)
        if not calls or kind not in mesh.jax_kinds:
            continue
        by_dtype = {k.split("/", 1)[1]: v - nbytes0.get(k, 0)
                    for k, v in mesh.nbytes.items()
                    if k.split("/", 1)[0] == kind and v - nbytes0.get(k, 0)}
        total = sum(by_dtype.values())
        out["nbytes"].update({f"{kind}/{dt}": v
                              for dt, v in by_dtype.items()})
        out["by_kind"][kind] = {"count": calls, "bytes": total,
                                "bytes_by_dtype": by_dtype}
        jk = out["jax_kinds"].setdefault(mesh.jax_kinds[kind],
                                         {"count": 0, "bytes": 0})
        jk["count"] += calls
        jk["bytes"] += total
        out["total_bytes"] += total
        out["total_count"] += calls
    return out


def _extrapolate(m1: dict, m2: dict, k1: int, k2: int, L: int) -> dict:
    """Linear depth extrapolation.  XLA occasionally optimizes the deeper
    reduced lowering harder (CSE across unrolled layers), which would give
    a NEGATIVE per-layer delta; clamp at 0 and floor the total at the
    larger observation."""
    out = {}
    for key in ("flops", "bytes", "coll_bytes", "coll_count"):
        per = max(0.0, (m2[key] - m1[key]) / (k2 - k1))
        out[key] = max(m1[key] + (L - k1) * per, m1[key], m2[key])
        out[f"{key}_per_layer"] = per
    return out


def _extrapolate_dtypes(m1: dict, m2: dict, k1: int, k2: int,
                        L: int) -> dict:
    """:func:`_extrapolate` of each dtype's flops."""
    out = {}
    for dt in sorted(set(m1["flops_by_dtype"]) | set(m2["flops_by_dtype"])):
        a = {**m1, "flops": m1["flops_by_dtype"].get(dt, 0.0)}
        b = {**m2, "flops": m2["flops_by_dtype"].get(dt, 0.0)}
        out[dt] = _extrapolate(a, b, k1, k2, L)["flops"]
    return out


def _reduced_cfg(cfg, k: int):
    kw = {"num_layers": k}
    if cfg.is_encdec:
        kw["encoder_layers"] = k
    return dataclasses.replace(cfg, **kw)


def reduced_depths(cfg) -> tuple[int, int]:
    p = len(cfg.block_pattern) if cfg.family == "hybrid" else 1
    return p, 2 * p


def model_flops(cfg, shape) -> float:
    """JAX's ``model_flops_global``: 6 N D for a train step, 2 N D for
    serving, N the active parameters, D the global tokens."""
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return float(6 * cfg.active_param_count() * tokens)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind == "prefill" else 1)
    return float(2 * cfg.active_param_count() * tokens)


def program(kind: str) -> str:
    if kind == "train":
        return ("tensor-parallel over model (attention, dense MLP, "
                "vocabulary-parallel embedding, logits and loss), "
                "data-parallel over the batch axes, one layer gathered over "
                "data at a time")
    return ("tensor-parallel serving over model, one layer gathered over "
            "data at a time")


def storage(kind: str) -> str:
    """What the port holds where JAX's specs would shard."""
    if kind == "train":
        return ("f32 master, m and v: this rank's blocks (state_specs); "
                "batch: the global batch passed in, this rank's rows taken "
                "by the step (batch_specs); bf16 compute copy and its "
                "gradients: this rank's blocks, one layer's blocks gathered "
                "over data at a time; MoE experts and router, RG-LRU, RWKV "
                "and cross-attention weights gathered whole along model in "
                "their layer; no sequence sharded (seq_shard not read)")
    return ("bf16 parameters: this rank's blocks (state_specs), one "
            "layer's gathered over data at a time; batch and caches: this "
            "rank's rows (dp_axes_for), KV heads over model where they "
            "divide it (held_cache_specs), the sequence whole "
            "(kv_seq_shard not read)")


def _distinct_specs(cfg, specs: dict) -> dict:
    """Parameter specs keyed by JAX tree path (stacked layers once)."""
    from repro_torch.models import convert
    out = {}
    for name, spec in specs.items():
        path = "/".join(map(str, convert.jax_path(cfg, name)[0]))
        out[path] = list(spec)
    return out


def roofline(flops_by_dtype: dict, nbytes: float, coll_bytes: float,
             bw: float | None) -> dict:
    compute_s = compute_seconds(flops_by_dtype)
    memory_s = nbytes / (bw or HBM_BW)
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_bytes": coll_bytes,
            "dominant": "compute" if compute_s >= memory_s else "memory",
            "peak_flops": dict(PEAK_FLOPS),
            "peak_flops_source": CONSTANTS_SOURCE,
            "bw": bw or HBM_BW,
            "bw_source": ("measured copy rate (--bw)" if bw else
                          f"{CONSTANTS_SOURCE}: 3.35 TB/s")}


def _path(out_dir: str, arch: str, shape_name: str, mesh_kind: str) -> str:
    return os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_kind}.json".replace("/", "_"))


def fit(peak: int) -> dict:
    """``peak`` live bytes against what a rank holds (:data:`HBM_BYTES`
    less :data:`CONTEXT_BYTES`): fits, marginal (within
    :data:`MARGINAL_BYTES`), and the bytes left (negative: over)."""
    limit = HBM_BYTES - CONTEXT_BYTES
    return {"fits": peak <= limit,
            "marginal": abs(limit - peak) <= MARGINAL_BYTES,
            "margin_bytes": limit - peak, "hbm_bytes": HBM_BYTES,
            "context_bytes": CONTEXT_BYTES, "hbm_source": HBM_SOURCE}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str, *,
             bw: float | None = None, cfg=None, write: bool = True) -> dict:
    """Trace one cell and write its record (``cfg``: the registry's config
    with overrides, as the perf ladders pass it)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import RecordingMesh, make_production_mesh
    from repro_torch.launch.specs import input_specs, skip_reason
    from repro_torch.models.config import SHAPES

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "ok"}
    reason = skip_reason(arch, shape_name)
    if reason:
        rec.update(status="skipped", reason=reason)
        if write:
            os.makedirs(out_dir, exist_ok=True)
            with open(_path(out_dir, arch, shape_name, mesh_kind), "w") as f:
                json.dump(rec, f, indent=1)
        print(f"[dryrun] SKIP {arch} {shape_name} {mesh_kind}: {reason}")
        return rec

    shape_mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    n_chips = shape_mesh.size
    cfg = cfg or configs.get(arch)
    shape = SHAPES[shape_name]

    def traced(c):
        mesh = RecordingMesh(shape_mesh)
        fn, kwargs, specs = input_specs(arch, shape_name, mesh, cfg=c)
        return measure(fn, kwargs, mesh), specs, mesh

    # 1) the full-depth trace: runnability and the rank's peak
    full, specs, mesh = traced(cfg)
    # 2) the cost pass: reduced depths, extrapolated
    k1, k2 = reduced_depths(cfg)
    m1, _, _ = traced(_reduced_cfg(cfg, k1))
    m2, _, _ = traced(_reduced_cfg(cfg, k2))
    ext = _extrapolate(m1, m2, k1, k2, cfg.num_layers)
    ext_dt = _extrapolate_dtypes(m1, m2, k1, k2, cfg.num_layers)
    flops = ext["flops"]
    mflops = model_flops(cfg, shape)
    params = (specs["state"]["params"] if shape.kind == "train"
              else specs["params"])
    rec.update({
        "chips": int(n_chips), "coords": mesh.coords,
        "program": program(shape.kind), "storage": storage(shape.kind),
        "layers": cfg.num_layers,
        "trace_s": round(full["trace_s"], 2),
        "peak_bytes": full["peak_bytes"], "arg_bytes": full["arg_bytes"],
        "peak_holds": {k: v for k, v in list(full["peak_holds"].items())[:12]},
        **fit(full["peak_bytes"]),
        "cost_method": f"2-point depth extrapolation (k={k1},{k2} traced)",
        "cost_reduced": {"k1": k1, "m1": {k: m1[k] for k in
                                          ("flops", "bytes", "coll_bytes")},
                         "k2": k2, "m2": {k: m2[k] for k in
                                          ("flops", "bytes", "coll_bytes")}},
        "cost_extrapolated": {**{k: ext[k] for k in
                                 ("flops", "bytes", "coll_bytes",
                                  "coll_count")},
                              "flops_by_dtype": ext_dt},
        "cost_fulltrace": {k: full[k] for k in
                           ("flops", "flops_by_dtype", "bytes", "coll_bytes",
                            "coll_count", "ops")},
        "collectives_reduced_k2": m2["collectives"],
        "collectives_fulltrace": full["collectives"],
        "roofline": roofline(ext_dt, ext["bytes"], ext["coll_bytes"], bw),
        "model_flops_global": mflops,
        "flops_per_device": flops,
        "useful_flops_ratio": (mflops / n_chips / flops) if flops else None,
        "specs": {"params": _distinct_specs(cfg, params),
                  **{k: v for k, v in specs.items()
                     if k not in ("params", "state")}},
    })
    if write:
        os.makedirs(out_dir, exist_ok=True)
        with open(_path(out_dir, arch, shape_name, mesh_kind), "w") as f:
            json.dump(rec, f, indent=1)
    r = rec["roofline"]
    print(f"[dryrun] OK {arch} {shape_name} {mesh_kind}: "
          f"peak={rec['peak_bytes'] / 2 ** 30:.2f}GiB fits={rec['fits']}"
          f"{' (marginal)' if rec['marginal'] else ''} "
          f"compute={r['compute_s'] * 1e3:.1f}ms "
          f"memory={r['memory_s'] * 1e3:.1f}ms "
          f"coll={ext['coll_bytes'] / 1e9:.3f}GB dom={r['dominant']} "
          f"useful={rec['useful_flops_ratio']:.4f} "
          f"(trace {rec['trace_s']:.1f}s)", flush=True)
    return rec


def run_all(out_dir: str, meshes=("pod", "multipod"), archs=None,
            shapes=None, **kw) -> list:
    """Every cell whose record is not written yet, in this process; the
    cells that raised."""
    from repro_torch import configs
    from repro_torch.models.config import SHAPES
    archs = archs or configs.all_arch_names()
    shapes = shapes or list(SHAPES)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                path = _path(out_dir, arch, shape, mesh)
                if os.path.exists(path):
                    print(f"[dryrun] cached {path}")
                    continue
                try:
                    run_cell(arch, shape, mesh, out_dir, **kw)
                except Exception as e:  # recorded; --all exits non-zero
                    failures.append((arch, shape, mesh, repr(e)))
                    print(f"[dryrun] FAIL {arch} {shape} {mesh}: {e!r}",
                          flush=True)
    print(f"[dryrun] all done; {len(failures)} failures: {failures}")
    return failures


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--out-dir", default="experiments/dryrun_torch")
    p.add_argument("--bw", type=float, default=None,
                   help="copy rate in bytes/s for the memory term (default "
                        "the H100 data sheet's 3.35e12)")
    args = p.parse_args(argv)
    if args.all:
        return 1 if run_all(args.out_dir, bw=args.bw) else 0
    if not (args.arch and args.shape):
        p.error("--arch and --shape, or --all")
    run_cell(args.arch, args.shape, args.mesh, args.out_dir, bw=args.bw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
