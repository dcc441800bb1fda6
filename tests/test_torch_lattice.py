"""Port vs JAX: lattice layouts, SU(3) projection, field crossing, the
committed golden fixture, and the port's import isolation.

Same inputs through both packages: fields come from the JAX package's
generators (or numpy) and cross as numpy arrays.  Packing and the
even-odd split are pure data movement, so they must agree bitwise.

Regenerate the fixture with ``PYTHONPATH=src python
tests/test_torch_lattice.py --write``.
"""

import ast
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lattice as jl
from repro_torch.core import lattice as tl

import torch_one_thread  # noqa: F401  (one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "src" / "repro_torch" / "data" / "golden_4x4x4x4_seed7.npz"
SHAPES = [jl.LatticeShape(4, 4, 4, 4), jl.LatticeShape(4, 4, 4, 8)]


def golden_fields_from_jax() -> dict:
    """The 4^4 seed-7 problem of the JAX package's solver goldens: gauge
    and RHS from ``split(PRNGKey(7))``, and the batch RHS ``n`` from
    ``fold_in(kb, n)`` (benchmarks/bench_solvers.py's generation): 4 of
    them as ``b_batch``, 16 as ``b_batch16`` (block CG's width)."""
    lat = jl.LatticeShape(4, 4, 4, 4)
    ku, kb = jax.random.split(jax.random.PRNGKey(7))
    batch = np.asarray(jnp.stack([
        jl.random_spinor(jax.random.fold_in(kb, i), lat) for i in range(16)]))
    return {"gauge": np.asarray(jl.random_gauge(ku, lat)),
            "b": np.asarray(jl.random_spinor(kb, lat)),
            "b_batch": batch[:4], "b_batch16": batch}


def _fields(lat, seed):
    ku, kb = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jl.random_gauge(ku, lat)),
            np.asarray(jl.random_spinor(kb, lat)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("lat", SHAPES, ids=str)
def test_pack_unpack_bitwise(lat):
    u, b = _fields(lat, 3)
    np.testing.assert_array_equal(tl.pack_spinor(_t(b)).numpy(),
                                  np.asarray(jl.pack_spinor(b)))
    np.testing.assert_array_equal(tl.pack_gauge(_t(u)).numpy(),
                                  np.asarray(jl.pack_gauge(u)))
    pb, pu = np.asarray(jl.pack_spinor(b)), np.asarray(jl.pack_gauge(u))
    np.testing.assert_array_equal(tl.unpack_spinor(_t(pb)).numpy(),
                                  np.asarray(jl.unpack_spinor(pb)))
    np.testing.assert_array_equal(tl.unpack_gauge(_t(pu)).numpy(),
                                  np.asarray(jl.unpack_gauge(pu)))


@pytest.mark.parametrize("lat", SHAPES, ids=str)
def test_split_merge_bitwise(lat):
    u, b = _fields(lat, 4)
    te, to = tl.split_eo(_t(b))
    je, jo = jl.split_eo(b)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tl.merge_eo(te, to).numpy(), b)
    tue, tuo = tl.split_eo_gauge(_t(u))
    jue, juo = jl.split_eo_gauge(u)
    np.testing.assert_array_equal(tue.numpy(), np.asarray(jue))
    np.testing.assert_array_equal(tuo.numpy(), np.asarray(juo))
    np.testing.assert_array_equal(tl.eo_row_offset(*lat.dims[:3]),
                                  jl.eo_row_offset(*lat.dims[:3]))


def test_project_su3_matches_jax():
    """Gram-Schmidt on the columns gives the positive-diagonal QR's Q: the
    same SU(3) matrices as the JAX package's LAPACK QR, to f32 rounding."""
    rng = np.random.default_rng(0)
    m = (rng.standard_normal((500, 3, 3))
         + 1j * rng.standard_normal((500, 3, 3))).astype(np.complex64)
    ours = tl._project_su3(_t(m)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jl._project_su3(m)),
                               atol=1e-5)
    eye = np.einsum("nab,ncb->nac", ours, ours.conj())
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(ours), 1.0, atol=1e-5)


def test_random_fields_use_the_generator():
    lat = tl.LatticeShape(2, 2, 2, 4)
    a = tl.random_gauge(torch.Generator().manual_seed(5), lat)
    b = tl.random_gauge(torch.Generator().manual_seed(5), lat)
    assert torch.equal(a, b) and a.shape == (4, 2, 2, 2, 4, 3, 3)
    s = tl.random_spinor(torch.Generator().manual_seed(5), lat)
    assert s.shape == (2, 2, 2, 4, 4, 3) and s.dtype == torch.complex64


@pytest.mark.parametrize("packed", [False, True])
def test_fields_from_numpy(packed):
    lat = SHAPES[1]
    u, b = _fields(lat, 5)
    bb = np.stack([b, 2 * b])
    if packed:
        args = (np.asarray(jl.pack_gauge(u)), np.asarray(jl.pack_spinor(bb)))
    else:
        args = (u, bb)
    ut, bt = tl.fields_from_numpy(*args, device="cpu")
    assert ut.dtype == bt.dtype == torch.complex64
    np.testing.assert_array_equal(ut.numpy(), u)
    np.testing.assert_array_equal(bt.numpy(), bb)


def test_batched_reductions_equal_singles():
    rng = np.random.default_rng(1)
    a = _t(rng.standard_normal((3, 4, 24, 5)).astype(np.float32))
    c = _t(rng.standard_normal((3, 4, 24, 5)).astype(np.float32))
    dots = tl.field_dot_batched(a, c)
    norms = tl.field_norm2_batched(a)
    for n in range(3):
        assert torch.equal(dots[n], tl.field_dot(a[n], c[n]))
        assert torch.equal(norms[n], tl.field_norm2(a[n]))
    np.testing.assert_allclose(
        norms.numpy(), np.asarray(jl.field_norm2_batched(a.numpy())),
        rtol=1e-6)
    z = _t((rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
            ).astype(np.complex64))
    np.testing.assert_allclose(tl.field_dot(z, z).numpy(),
                               np.asarray(jl.field_dot(z.numpy(), z.numpy())),
                               rtol=1e-6)


def test_golden_fixture_equals_jax_generation():
    """The committed fixture that chip_smoke.py solves is bitwise the JAX
    package's generation."""
    with np.load(GOLDEN) as f:
        stored = {k: f[k] for k in f.files}
    fresh = golden_fields_from_jax()
    assert sorted(stored) == sorted(fresh)
    for k in fresh:
        assert stored[k].dtype == fresh[k].dtype
        np.testing.assert_array_equal(stored[k], fresh[k])


def test_golden_batch16_extends_the_batch_of_4():
    """``b_batch16`` is ``fold_in(kb, i)`` for i < 16, bitwise, and its
    first 4 are ``b_batch``."""
    with np.load(GOLDEN) as f:
        b4, b16 = f["b_batch"], f["b_batch16"]
    lat = jl.LatticeShape(4, 4, 4, 4)
    _, kb = jax.random.split(jax.random.PRNGKey(7))
    assert b16.shape == (16, 4, 4, 4, 4, 4, 3) and b16.dtype == np.complex64
    for i in range(16):
        np.testing.assert_array_equal(
            b16[i], np.asarray(jl.random_spinor(jax.random.fold_in(kb, i),
                                                lat)))
    np.testing.assert_array_equal(b16[:4], b4)


def test_cuda_device_is_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.resolve_device("cuda")
    assert tl.resolve_device("cpu").type == "cpu"


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    """The port (and chip_smoke.py) never imports jax, repro or
    benchmarks — an AST scan of every import statement."""
    bad = _imports(path) & {"jax", "jaxlib", "repro", "benchmarks"}
    assert not bad, f"{path} imports {sorted(bad)}"


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: tests/test_torch_lattice.py --write")
    np.savez_compressed(GOLDEN, **golden_fields_from_jax())
    print(f"wrote {GOLDEN}")
