"""Sweep the launch space of K1 (``wilson_hop``) and K4 (``wilson_full``)
on the card and keep the winners in the port's tuning cache.

The counterpart of the JAX package's ``repro.kernels.autotune``, for the
port's knobs (:mod:`.dispatch`): K1's rows of Y a block ``b``, and K4's
``b`` and block-order chunk ``tchunk``.  :func:`candidates` lists the
tiles a shape can take; :func:`sweep` launches each on random fields at
that shape, holds its output bitwise against the default tile's, and
times the candidates **in turns**: each round runs every candidate once
(:func:`time_tile`: the median of CUDA events over one call a pair, and
over ten calls back to back), and a candidate's time is its median over
the rounds.  The winner is the fastest back to back; unless it beats the
default by more than the spread of the rounds (the larger of the two
tiles' max - min), the default stays.  :func:`autotune` sweeps a list of
points into cache entries that record both times;
:func:`.dispatch.save_tuning_cache` writes them to the port's
``kernels/tuning_cache.json``, never the JAX package's.

The sweep times the kernels only: on a CPU tensor a wrapper runs its
plain version, which has no tiles, so :func:`sweep` raises there.

CLI (on the card)::

    python -m repro_torch.kernels.autotune --kernel wilson_hop \\
        --dims 64x32x32x16 --nrhs 1 4 --dtype float32 --merge
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import subprocess
import sys

import torch

from repro_torch.core.lattice import GAUGE_G, NDIRS, SPINOR_S, resolve_device
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import TileConfig
from repro_torch.kernels.wilson_dslash import kernel as wk

MASS = 0.1
SEED = 1234


def _esize(dtype) -> int:
    return torch.empty((), dtype=getattr(torch, dispatch.dtype_name(dtype))
                       ).element_size()


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def default_tile(kernel: str, lattice_shape, nrhs: int, dtype) -> TileConfig:
    """The tile the default plan resolves to at a shape (concrete b and,
    for K4, tchunk)."""
    t, _, y, w = lattice_shape
    es = _esize(dtype)
    if kernel == "wilson_hop":
        return TileConfig(b=wk.hop_tile_plan(y, w, es)[0])
    return TileConfig(b=wk.full_tile_plan(y, w, es)[0],
                      tchunk=wk.full_tchunk(t, nrhs))


def candidates(kernel: str, lattice_shape, nrhs: int,
               dtype) -> list[TileConfig]:
    """The tiles of one point, the default first.

    K1 (``lattice_shape`` its half field's (T, Z, Y, Xh)): b over the
    divisors of Y whose tile fits shared memory, and 0 (rows read in
    place).  K4 ((T, Z, Y, X)): the same b (without 0 where the bf16 pair
    instance runs: it stages its links), times tchunk in 1, 2, 4, 8
    dividing T.  Every one of them gave the default's bits on the card
    (PERF.md); :func:`sweep` checks again."""
    if kernel not in dispatch.KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; the launch space "
                         f"covers {list(dispatch.KERNELS)}")
    t, _, y, w = lattice_shape
    es = _esize(dtype)
    if kernel == "wilson_hop":
        top = wk.max_rows(y, w, wk.hop_smem_bytes, es)
        bs = [d for d in _divisors(y) if d <= top] + [0]
        tiles = [TileConfig(b=b) for b in bs]
    else:
        top = wk.max_rows(y, w, wk._full_smem, es)
        bs = [d for d in _divisors(y) if d <= top]
        if not wk.full_pair(w, es):
            bs.append(0)
        tiles = [TileConfig(b=b, tchunk=c) for b in bs
                 for c in dispatch.TCHUNKS if t % c == 0]
    default = default_tile(kernel, lattice_shape, nrhs, dtype)
    return [default] + [c for c in tiles if c != default]


@contextlib.contextmanager
def forced(tile: TileConfig):
    """Run the block with ``tile`` forced on every K1/K4 launch (the
    ``REPRO_TORCH_TILE`` override), restoring the environment after."""
    old = os.environ.get("REPRO_TORCH_TILE")
    os.environ["REPRO_TORCH_TILE"] = (f"b={tile.b},tchunk={tile.tchunk}"
                                      .replace("None", "none"))
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_TORCH_TILE", None)
        else:
            os.environ["REPRO_TORCH_TILE"] = old


def problem(kernel: str, lattice_shape, nrhs: int, dtype, device):
    """The launch one point times, on random fields from :data:`SEED`:
    K1 as the Schur operator's second launch (D_eo of an odd field with
    gamma5 and the site term's accumulator), K4 as the normal operator's
    second (D^dag, both gamma5 flags).  Returns a no-argument call."""
    t, z, y, w = lattice_shape
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    dtype = getattr(torch, dispatch.dtype_name(dtype))
    lead = (nrhs,) if nrhs > 1 else ()

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    psi = rand(*lead, t, z, y, SPINOR_S, w)
    if kernel == "wilson_hop":
        u_e, u_o = (rand(NDIRS, t, z, y, GAUGE_G, w) for _ in range(2))
        acc = rand(*lead, t, z, y, SPINOR_S, w)
        m = MASS + 4.0
        return lambda: wk.wilson_hop(u_e, u_o, psi, parity=0,
                                     gamma5_out=True, psi_acc=acc,
                                     acc_coeff=m, hop_coeff=-1.0 / m)
    up = rand(NDIRS, t, z, y, GAUGE_G, w)
    return lambda: wk.wilson_full(up, psi, MASS, gamma5_in=True,
                                  gamma5_out=True)


def time_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``inner`` calls of ``fn``
    in a row, per call, after ``warmup`` (``chip_smoke.py::time_ms``'s
    protocol)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_tile(fn, tile: TileConfig) -> dict:
    """``fn`` under ``tile``, timed both ways: one call a pair of events
    (``ms``, the wrapper's host latency included) and ten back to back
    (``ms_back_to_back``, the kernel's own time)."""
    with forced(tile):
        return {"ms": time_ms(fn, reps=20),
                "ms_back_to_back": time_ms(fn, reps=10, inner=10)}


def sweep(kernel: str, lattice_shape, nrhs: int = 1, dtype=torch.float32,
          *, rounds: int = 5, device="cuda", verbose: bool = False
          ) -> tuple[TileConfig, list[dict]]:
    """Time every candidate of one point in turns; returns ``(winner,
    rows)``, a row per candidate (the default first): its tile, the
    medians over the rounds of ``ms`` and ``ms_back_to_back``, their
    spread (max - min over the rounds, back to back), the rounds' times
    and ``bitwise`` (its output equal to the default tile's).  Only a
    bitwise candidate can win; where the default is kept the winner is
    :data:`.dispatch.DEFAULT_TILE`, so a cache entry of it launches the
    very plan a cold cache does."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(
            f"autotune.sweep times the CUDA kernels; on {dev} the wrappers "
            "run their plain versions, which have no tiles")
    fn = problem(kernel, lattice_shape, nrhs, dtype, dev)
    tiles = candidates(kernel, lattice_shape, nrhs, dtype)
    with forced(tiles[0]):
        want = fn()
    rows = []
    for tile in tiles:
        with forced(tile):
            rows.append({**tile.to_entry(),
                         "bitwise": bool(torch.equal(fn(), want)),
                         "rounds_ms": [], "rounds_ms_back_to_back": []})
    del want
    for _ in range(rounds):
        for tile, row in zip(tiles, rows):
            t = time_tile(fn, tile)
            row["rounds_ms"].append(t["ms"])
            row["rounds_ms_back_to_back"].append(t["ms_back_to_back"])
    for row in rows:
        b2b = row["rounds_ms_back_to_back"]
        row["ms"] = statistics.median(row["rounds_ms"])
        row["ms_back_to_back"] = statistics.median(b2b)
        row["spread_ms"] = max(b2b) - min(b2b)
        if verbose:
            print(f"  {kernel} {lattice_shape} N={nrhs} "
                  f"{dispatch.dtype_name(dtype)} b={row['b']} "
                  f"tchunk={row['tchunk']}: {row['ms']:.4f} ms (back to "
                  f"back {row['ms_back_to_back']:.4f} ms, spread "
                  f"{row['spread_ms']:.4f}) bitwise={row['bitwise']}",
                  file=sys.stderr, flush=True)
    default = rows[0]
    best = min((r for r in rows if r["bitwise"]),
               key=lambda r: r["ms_back_to_back"])
    margin = max(default["spread_ms"], best["spread_ms"])
    if default["ms_back_to_back"] - best["ms_back_to_back"] <= margin:
        return dispatch.DEFAULT_TILE, rows
    return TileConfig(b=best["b"], tchunk=best["tchunk"]), rows


def autotune(points, *, rounds: int = 5, device="cuda",
             verbose: bool = False) -> dict:
    """Sweep ``points``, a list of ``(kernel, lattice_shape, nrhs,
    dtype)``; returns cache entries keyed by :func:`.dispatch.cache_key`:
    the winner's tile (b and tchunk None where the default was kept) and
    times beside the default tile's, the spread, the number of
    candidates and any that were not bitwise."""
    entries = {}
    for kernel, shape, nrhs, dtype in points:
        winner, rows = sweep(kernel, shape, nrhs, dtype, rounds=rounds,
                             device=device, verbose=verbose)
        default = rows[0]
        row = next((r for r in rows if (r["b"], r["tchunk"])
                    == (winner.b, winner.tchunk)), default)
        entries[dispatch.cache_key(kernel, dispatch.BACKEND, shape, nrhs,
                                   dtype)] = {
            **winner.to_entry(),
            "ms": row["ms"], "ms_back_to_back": row["ms_back_to_back"],
            "default": {"b": default["b"], "tchunk": default["tchunk"],
                        "ms": default["ms"],
                        "ms_back_to_back": default["ms_back_to_back"]},
            "spread_ms": max(default["spread_ms"], row["spread_ms"]),
            "candidates": len(rows), "rounds": rounds,
            "not_bitwise": [{"b": r["b"], "tchunk": r["tchunk"]}
                            for r in rows if not r["bitwise"]]}
    return entries


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out.stdout.strip().splitlines()[0]


def _parse_dims(s: str) -> tuple[int, int, int, int]:
    dims = tuple(int(d) for d in s.lower().split("x"))
    if len(dims) != 4:
        raise argparse.ArgumentTypeError(f"dims must be TxZxYxW, got {s!r}")
    return dims


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="sweep the K1/K4 launch space on the card, persist "
                    "the winners in the port's tuning cache")
    p.add_argument("--kernel", required=True, choices=dispatch.KERNELS)
    p.add_argument("--dims", type=_parse_dims, nargs="+", required=True,
                   help="TxZxYxW: W is Xh for wilson_hop (its half "
                        "field), X for wilson_full")
    p.add_argument("--nrhs", type=int, nargs="+", default=[1])
    p.add_argument("--dtype", nargs="+", default=["float32"],
                   choices=["float32", "bfloat16", "float16"])
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--out", default=None,
                   help="cache JSON (default: REPRO_TORCH_TUNING_CACHE_PATH "
                        "or the package's kernels/tuning_cache.json)")
    p.add_argument("--merge", action="store_true",
                   help="merge into the existing cache instead of "
                        "replacing it")
    p.add_argument("--device", default="cuda")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    points = [(args.kernel, dims, n, dt) for dims in args.dims
              for n in args.nrhs for dt in args.dtype]
    entries = autotune(points, rounds=args.rounds, device=args.device,
                       verbose=args.verbose)
    for key, e in entries.items():
        d = e["default"]
        print(f"{key}: b={e['b']} tchunk={e['tchunk']} "
              f"{e['ms_back_to_back']:.4f} ms back to back (default b="
              f"{d['b']} tchunk={d['tchunk']} {d['ms_back_to_back']:.4f} ms; "
              f"spread {e['spread_ms']:.4f} ms; {e['candidates']} "
              f"candidates; not bitwise: {e['not_bitwise'] or 'none'})")
    meta = {"device_kind": dispatch.device_kind(),
            "power_limit": power_limit(), "torch": torch.__version__}
    for e in entries.values():
        e.update(device_kind=meta["device_kind"],
                 power_limit=meta["power_limit"])
    if args.merge:
        entries = {**dispatch.read_tuning_cache(args.out), **entries}
    path = dispatch.save_tuning_cache(entries, path=args.out, meta=meta)
    print(f"wrote {len(entries)} entries -> {path} ({meta['device_kind']}, "
          f"{meta['power_limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
