"""The LM dry-run's perf ladders: VARIANTS of three chosen cells traced
with config overrides, their roofline terms side by side (the JAX
package's ``launch/perf_variants.py``).

  python -m repro_torch.launch.perf_variants --run h1   # glm4 train_4k ladder
  python -m repro_torch.launch.perf_variants --run h2   # nemotron decode ladder
  python -m repro_torch.launch.perf_variants --all

Each variant is (tag, arch, shape, overrides), as in JAX's ``RUNS``; its
record lands in ``experiments/dryrun_torch/perf/<tag>.json`` with the
dry-run cell's terms (``launch/dryrun.py::run_cell`` on the overridden
config) and ``reads``: whether the port's program reads each override.
``remat`` is read (``layers.remat``).  ``seq_shard`` and ``kv_seq_shard``
are not (the port's steps shard no sequence before ROADMAP item 18 part
2), so those variants trace the baseline's program.  ``moe_dispatch_shard=False``
with a batch split over the mesh raises in ``models/moe.py`` (one capacity
group over the whole batch is not reproduced across ranks): the record's
status is ``refused``, with the message.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# (tag, arch, shape, overrides)
H1 = [  # glm4-9b train_4k: activation-memory ladder
    ("h1a_baseline_no_seqshard", "glm4-9b", "train_4k",
     {"seq_shard": False}),
    ("h1b_seq_shard", "glm4-9b", "train_4k", {}),
    ("h1c_no_remat", "glm4-9b", "train_4k", {"remat": False}),
]
H2 = [  # nemotron-4-340b decode_32k: KV-cache sharding ladder
    ("h2a_baseline_replicated_kv", "nemotron-4-340b", "decode_32k",
     {"kv_seq_shard": False}),
    ("h2b_seq_sharded_kv", "nemotron-4-340b", "decode_32k", {}),
]
H4 = [  # qwen3-moe train_4k: dispatch-buffer sharding (bonus climb)
    ("h4a_baseline_ep_only", "qwen3-moe-235b-a22b", "train_4k",
     {"moe_dispatch_shard": False}),
    ("h4b_cap_sharded", "qwen3-moe-235b-a22b", "train_4k", {}),
]
H5 = [  # yi-9b train_4k: KV-head replication for the TP-divisibility gap
    # baseline = the sweep cell (attention replicated over TP: kv=4, g=8,
    # neither divides 16); optimized = rep=4 virtual kv heads
    ("h5b_kv_replicated_heads", "yi-9b", "train_4k", {}),
]
RUNS = {"h1": H1, "h2": H2, "h4": H4, "h5": H5}

# whether the port's program reads each override
READS = {
    "remat": "read: layers.remat checkpoints each pattern period",
    "seq_shard": "not read: the port shards no sequence (ROADMAP item 18 "
                 "part 2)",
    "kv_seq_shard": "not read: the port's serving holds a cache whole "
                    "along model where its KV heads do not divide it "
                    "(ROADMAP item 18 part 2)",
    "moe_dispatch_shard": "read: models/moe.py's capacity groups; False "
                          "with a split batch raises",
}


def run_variant(tag: str, arch: str, shape_name: str, overrides: dict,
                mesh_kind: str, out_dir: str) -> dict:
    """Trace one variant and write its record."""
    from repro_torch import configs
    from repro_torch.launch import dryrun as dr

    cfg = dataclasses.replace(configs.get(arch), **overrides)
    rec = {"tag": tag, "arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "overrides": {k: str(v) for k, v in overrides.items()},
           "reads": {k: READS[k] for k in overrides}}
    try:
        cell = dr.run_cell(arch, shape_name, mesh_kind, out_dir, cfg=cfg,
                           write=False)
    except ValueError as e:
        if "moe_dispatch_shard" not in str(e):
            raise
        rec.update(status="refused", reason=str(e))
        print(f"[perf] {tag}: refused: {e}")
    else:
        rec.update({k: cell[k] for k in (
            "status", "chips", "program", "peak_bytes", "peak_holds", "fits",
            "marginal", "margin_bytes", "cost_extrapolated", "roofline",
            "model_flops_global", "useful_flops_ratio")})
        r = rec["roofline"]
        print(f"[perf] {tag}: peak={rec['peak_bytes'] / 2 ** 30:.1f}GiB "
              f"compute={r['compute_s'] * 1e3:.0f}ms "
              f"memory={r['memory_s'] * 1e3:.0f}ms "
              f"coll={r['collective_bytes'] / 1e9:.3f}GB "
              f"dom={r['dominant']}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", choices=list(RUNS) + ["one"])
    p.add_argument("--tag")
    p.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--out-dir", default="experiments/dryrun_torch/perf")
    args = p.parse_args(argv)
    if args.all or args.run in RUNS:
        runs = sum(RUNS.values(), []) if args.all else RUNS[args.run]
        for tag, arch, shape, ov in runs:
            if os.path.exists(os.path.join(args.out_dir, f"{tag}.json")):
                print(f"[perf] cached {tag}")
                continue
            run_variant(tag, arch, shape, ov, args.mesh, args.out_dir)
        return 0
    for tag, arch, shape, ov in sum(RUNS.values(), []):
        if tag == args.tag:
            run_variant(tag, arch, shape, ov, args.mesh, args.out_dir)
            return 0
    print(f"unknown tag {args.tag}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
