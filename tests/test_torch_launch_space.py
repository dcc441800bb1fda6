"""The launch space of K1 and K4 (``repro_torch.kernels.dispatch``,
``.autotune`` and the port's ``kernels/tuning_cache.json``).

* the cache key is the JAX package's with the kernel's name added;
  ``parse_tile`` and ``TileConfig`` validate in the JAX package's words;
* a cache round trip: a hit comes back, a miss and the kill switch give
  the default, ``REPRO_TORCH_TILE`` beats the cache, the JAX package's
  variables are not read;
* a cold or disabled cache gives exactly the plans the kernels ran
  before the launch space existed, over the tile-plan tables of
  ``tests/test_torch_full.py`` and ``tests/test_torch_hop.py`` and K4's
  block-order rule;
* a forced tile changes the plan and not the result: K1's and K4's
  emulated algorithms (the tests' step-by-step models of the CUDA
  kernels) give the same bits for every candidate tile;
* ``candidates()`` respects shared memory, T and the bf16 pair
  instance; a tile that does not fit raises before any launch;
* K4's block-order model visits every tile once for each candidate;
* the checked-in cache is well formed and each entry carries the card it
  was swept on; a sweep on the CPU raises.

The kernels' own bits for every tile are held on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 10).
"""

import json

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import dispatch as jax_dispatch
from repro_torch.kernels import autotune, dispatch
from repro_torch.kernels.dispatch import (DEFAULT_TILE, TileConfig,
                                          cache_key, parse_tile, pick_tile)
from repro_torch.kernels.wilson_dslash import kernel as tk
from test_torch_full import (FLAGS, FULL_BF16_PLANS, FULL_PLANS, MASS,
                             emulate_wilson_full, full_block_tile)
from test_torch_hop import HOP_BF16_PLANS, emulate_wilson_hop

import torch_one_thread  # noqa: F401  (one intra-op thread)

F32, BF16 = torch.float32, torch.bfloat16
# (Y, Xh) -> K1's f32 plan (b, ls, ss) (tests/test_torch_mixed.py, and
# the card checks' shapes of chip_smoke.py phase 2)
HOP_PLANS = {(32, 16): (2, 304, 400), (4, 2): (4, 36, 48),
             (8, 4): (8, 100, 100), (22, 4): (8, 100, 100),
             (6, 3): (6, 54, 72), (2, 174): (0, 3132, 4176)}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Each test picks its tiles from its own setup, not the ambient
    environment or the checked-in cache."""
    for var in ("REPRO_TORCH_TILE", "REPRO_TORCH_TUNING_CACHE_PATH",
                "REPRO_DSLASH_TILE", "REPRO_TUNING_CACHE_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", "0")


# ---------------------------------------------------------------- keys


@pytest.mark.parametrize("kernel,dims,n,dtype", [
    ("wilson_hop", (64, 32, 32, 16), 4, F32),
    ("wilson_full", (64, 32, 32, 32), 1, BF16),
    ("wilson_hop", (4, 4, 4, 8), 8, BF16)])
def test_cache_key_is_jax_format_with_the_kernel(kernel, dims, n, dtype):
    ours = cache_key(kernel, "cuda", dims, n, dtype)
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    backend, rest = jax_dispatch.cache_key("cuda", dims, n, jdt).split(
        "|", 1)
    assert ours == f"{backend}|{kernel}|{rest}"
    assert (cache_key("wilson_hop", "cuda", (64, 32, 32, 16), 4, F32)
            == "cuda|wilson_hop|64x32x32x16|nrhs4|float32")
    with pytest.raises(ValueError, match="wilson_hop"):
        cache_key("dslash", "cuda", dims, n, dtype)


def test_parse_tile_and_its_errors():
    assert parse_tile("b=2,tchunk=4") == TileConfig(b=2, tchunk=4)
    assert parse_tile("b=0") == TileConfig(b=0)
    assert parse_tile("b=none, tchunk=8") == TileConfig(tchunk=8)
    assert parse_tile("") == DEFAULT_TILE
    with pytest.raises(ValueError, match="legal keys: b, tchunk"):
        parse_tile("bz=2")
    with pytest.raises(ValueError, match="needs an int or none"):
        parse_tile("b=two")
    with pytest.raises(ValueError, match=r"one of \[1, 2, 4, 8\]"):
        parse_tile("tchunk=3")
    with pytest.raises(ValueError, match="positive int"):
        TileConfig(b=-1)


# ------------------------------------------------------- cache dispatch


def test_cache_round_trip(tmp_path, monkeypatch):
    path = str(tmp_path / "cache.json")
    dims = (8, 4, 4, 8)
    tuned = TileConfig(b=2, tchunk=2)
    dispatch.save_tuning_cache(
        {cache_key("wilson_full", "cuda", dims, 1, F32): {
            **tuned.to_entry(), "device_kind": "test"}},
        path=path, meta={"device_kind": "test"})
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", "1")
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE_PATH", path)
    assert pick_tile("wilson_full", dims, 1, F32) == tuned      # hit
    assert pick_tile("wilson_full", dims, 4, F32) == DEFAULT_TILE  # miss
    assert pick_tile("wilson_hop", dims, 1, F32) == DEFAULT_TILE
    # the launch plan follows the hit
    assert tk.full_launch_plan(dims, 1, F32)[0] == (2, 168, 2)
    # the JAX package's variables are not the port's
    monkeypatch.setenv("REPRO_DSLASH_TILE", "bz=1")
    monkeypatch.setenv("REPRO_TUNING_CACHE", "0")
    assert pick_tile("wilson_full", dims, 1, F32) == tuned
    # the env override beats the cache
    monkeypatch.setenv("REPRO_TORCH_TILE", "b=1")
    assert pick_tile("wilson_full", dims, 1, F32) == TileConfig(b=1)
    monkeypatch.delenv("REPRO_TORCH_TILE")
    # the kill switch
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", "0")
    assert pick_tile("wilson_full", dims, 1, F32) == DEFAULT_TILE
    # --merge reads the file whatever the kill switch says
    assert list(dispatch.read_tuning_cache(path)) == [
        cache_key("wilson_full", "cuda", dims, 1, F32)]


# ----------------------------------- a cold cache gives today's plans


@pytest.mark.parametrize("cold", ["disabled", "missing"])
def test_cold_cache_gives_todays_plans(cold, tmp_path, monkeypatch):
    if cold == "missing":
        monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", "1")
        monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE_PATH",
                           str(tmp_path / "none.json"))
    for dtype, plans in ((F32, HOP_PLANS), (BF16, HOP_BF16_PLANS)):
        for (y, xh), want in plans.items():
            plan, tile = tk.hop_launch_plan((4, 4, y, xh), 1, dtype)
            assert tile == DEFAULT_TILE and plan == want, (y, xh, dtype)
    for dtype, plans in ((F32, FULL_PLANS), (BF16, FULL_BF16_PLANS)):
        for (y, x), want in plans.items():
            for t, n in ((6, 1), (6, 4), (8, 1), (8, 4), (64, 4)):
                plan, tile = tk.full_launch_plan((t, 4, y, x), n, dtype)
                # the block order K4 had built in (csrc/wilson_full.cu)
                tchunk = 4 if n > 1 and t % 4 == 0 else 1
                assert tile == DEFAULT_TILE
                assert plan == (*want, tchunk), (t, y, x, n, dtype)


def test_forced_tile_changes_the_plan(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TILE", "b=1,tchunk=2")
    assert tk.full_launch_plan((8, 4, 32, 32), 1, F32)[0] == (1, 576, 2)
    assert tk.hop_launch_plan((8, 4, 32, 16), 4, F32)[0] == (1, 304, 400)
    monkeypatch.setenv("REPRO_TORCH_TILE", "b=0")
    assert tk.hop_launch_plan((8, 4, 32, 16), 1, BF16)[0] == (0, 336, 400)


def _fields(dims, n, seed, half=False):
    from repro_torch.core import lattice as tl
    gen = torch.Generator().manual_seed(seed)
    lat = tl.LatticeShape(*dims)
    u = tl.random_gauge(gen, lat)
    psi = torch.stack([tl.random_spinor(gen, lat) for _ in range(n)])
    if not half:
        return tl.pack_gauge(u), tl.pack_spinor(psi)
    ue, uo = tl.split_eo_gauge(u)
    pe = torch.stack([tl.split_eo(v)[0] for v in psi])
    return tl.pack_gauge(ue), tl.pack_gauge(uo), tl.pack_spinor(pe)


@pytest.mark.parametrize("n", [1, 2])
def test_a_tile_changes_k4s_data_movement_not_its_bits(n):
    """K4's emulated algorithm gives the same bits under every staged
    candidate (b > 0: the emulation models staged links) at 8x2x6x8,
    every gamma5 flag pair with twist."""
    dims = (8, 2, 6, 8)
    up, pp = _fields(dims, n, 81)
    pp = pp[0] if n == 1 else pp
    tiles = [c for c in autotune.candidates("wilson_full", dims, n, F32)
             if c.b]
    assert {c.tchunk for c in tiles} == {1, 2, 4, 8}
    assert {c.b for c in tiles} == {1, 2, 3, 6}
    for g5in, g5out, twist in FLAGS[1::2]:
        kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
        want = emulate_wilson_full(up, pp, MASS, **kw)
        for c in tiles:
            assert torch.equal(emulate_wilson_full(
                up, pp, MASS, b=c.b, tchunk=c.tchunk, **kw), want), c


def test_a_tile_changes_k1s_data_movement_not_its_bits():
    """K1's emulated algorithm gives the same bits for every staged b at
    4x4x6x8 (Xh = 4, N = 2), with the Schur epilogue's accumulator."""
    dims = (4, 4, 6, 8)
    ue, uo, pe = _fields(dims, 2, 82, half=True)
    kw = dict(parity=0, gamma5_in=False, gamma5_out=True, psi_acc=pe,
              acc_coeff=4.1, hop_coeff=-1 / 4.1, acc_twist=0.2,
              hop_twist=0.0)
    tiles = [c for c in autotune.candidates("wilson_hop", (4, 4, 6, 4), 2,
                                            F32) if c.b]
    assert sorted(c.b for c in tiles) == [1, 2, 3, 6]
    want = emulate_wilson_hop(ue, uo, pe, **kw)
    for c in tiles:
        assert torch.equal(emulate_wilson_hop(ue, uo, pe, b=c.b, **kw),
                           want), c


# ------------------------------------------------------------ candidates


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_candidates_fit_shared_memory_and_t(dtype):
    es = dtype.itemsize
    for dims in ((64, 32, 32, 16), (6, 4, 22, 8), (4, 4, 2, 350)):
        tiles = autotune.candidates("wilson_hop", dims, 1, dtype)
        assert tiles[0] == autotune.default_tile("wilson_hop", dims, 1,
                                                 dtype)
        assert len(set(tiles)) == len(tiles)
        for c in tiles:
            assert c.tchunk is None
            assert c.b == 0 or dims[2] % c.b == 0 or c == tiles[0]
            b, ls, ss = tk.hop_tile_plan(dims[2], dims[3], es, b=c.b)
            assert b == 0 or tk.hop_smem_bytes(b, ls, ss, es) <= (
                tk.HOP_SMEM_LIMIT)
    for dims in ((64, 32, 32, 32), (6, 4, 22, 16), (4, 2, 2, 928)):
        for n in (1, 4):
            tiles = autotune.candidates("wilson_full", dims, n, dtype)
            assert tiles[0] == autotune.default_tile("wilson_full", dims,
                                                     n, dtype)
            for c in tiles:
                assert dims[0] % c.tchunk == 0
                b, ls = tk.full_tile_plan(dims[2], dims[3], es, b=c.b)
                assert b == 0 or tk.full_smem_bytes(b, ls, es) <= (
                    tk.HOP_SMEM_LIMIT)
                # the bf16 pair instance stages its links: never b = 0
                assert not (b == 0 and tk.full_pair(dims[3], es))
    # the main path's shapes: K1 f32 b in 1, 2, 4, 8 (16 rows overflow),
    # K4 f32 b up to 16, bf16 up to 32 (Y = 32), times 4 chunks
    assert len(autotune.candidates("wilson_hop", (64, 32, 32, 16), 1,
                                   F32)) == 5
    assert len(autotune.candidates("wilson_full", (64, 32, 32, 32), 4,
                                   dtype)) == 24


def test_a_tile_that_does_not_fit_raises():
    with pytest.raises(ValueError, match=r"legal b values for Y=32.*"
                                         r"0 \(rows read in place\) and "
                                         r"1\.\.11"):
        tk.hop_tile_plan(32, 16, 4, b=16)
    with pytest.raises(ValueError, match=r"does not fit the Y extent 6"):
        tk.full_tile_plan(6, 8, 4, b=7)
    with pytest.raises(ValueError, match=r"legal tchunk values for T=6: "
                                         r"\[1, 2\]"):
        tk.full_tchunk(6, 4, 4)
    with pytest.raises(ValueError, match="pair instance stages its links"):
        tk.full_tile_plan(32, 32, 2, b=0)
    assert tk.full_tile_plan(32, 32, 4, b=0) == (0, 576)  # f32: in place


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("dims", [(64, 32, 32, 32), (8, 2, 6, 8),
                                  (6, 3, 22, 16)],
                         ids=lambda d: "x".join(map(str, d)))
def test_block_order_visits_every_tile_once_for_each_candidate(dims, n):
    for c in autotune.candidates("wilson_full", dims, n, F32):
        b = c.b or 1     # b = 0 reads in place, one row a block
        nyb = -(-dims[2] // b)
        order = [full_block_tile(i, dims[:3], b, n, c.tchunk)
                 for i in range(dims[0] * dims[1] * nyb)]
        assert sorted(order) == [(t, z, yb) for t in range(dims[0])
                                 for z in range(dims[1])
                                 for yb in range(nyb)], c
        # a chunk's planes come first along one z line
        assert [tl[0] for tl in order[:c.tchunk * nyb:nyb]] == list(
            range(c.tchunk))


# ---------------------------------------------- the cache, the sweep


def test_checked_in_cache_is_well_formed():
    with open(dispatch.DEFAULT_CACHE_PATH) as f:
        doc = json.load(f)
    assert doc["schema"] == 1 and doc["meta"]["device_kind"]
    for key, e in doc["entries"].items():
        backend, kernel, dims, nrhs, dtype = key.split("|")
        dims = tuple(int(d) for d in dims.split("x"))
        n = int(nrhs.removeprefix("nrhs"))
        assert key == cache_key(kernel, backend, dims, n, dtype)
        assert e["device_kind"] and e["power_limit"]
        tile = TileConfig(b=e["b"], tchunk=e["tchunk"])
        tiles = autotune.candidates(kernel, dims, n, getattr(torch, dtype))
        default = TileConfig(b=e["default"]["b"],
                             tchunk=e["default"]["tchunk"])
        assert default == tiles[0], key
        assert tile == DEFAULT_TILE or tile in tiles[1:], key
        assert not e["not_bitwise"], key
        assert e["ms_back_to_back"] > 0 and e["default"]["ms_back_to_back"]
        # a winner beats the default by more than the rounds' spread, or
        # the default is kept as the default tile (the cold cache's plan)
        if tile != DEFAULT_TILE:
            assert (e["default"]["ms_back_to_back"] - e["ms_back_to_back"]
                    > e["spread_ms"])


def test_sweep_on_the_cpu_raises(tmp_path):
    with pytest.raises(RuntimeError, match="plain versions"):
        autotune.sweep("wilson_hop", (4, 4, 4, 4), 1, F32, device="cpu")
    out = tmp_path / "cache.json"
    with pytest.raises(RuntimeError, match="plain versions"):
        autotune.main(["--kernel", "wilson_full", "--dims", "4x4x4x8",
                       "--device", "cpu", "--out", str(out)])
    assert not out.exists()
