"""Distributed Dirac-Wilson solves: 4D domain decomposition over ranks of
``torch.distributed``, with halo exchange around the port's kernels.

The scale-out layer the paper motivates ("boundary values have to be
frequently exchanged between the neighbours as well as global
communications ... to establish total error estimates"), after the JAX
package's ``repro.core.distributed``:

* The lattice is block-decomposed over the axes of a :class:`Mesh`
  (default: T over ``data``, Z over ``model`` and Y over ``pod`` when the
  mesh has one).  Each rank owns a contiguous 4D block; X is never
  sharded.
* ``dslash_halo`` exchanges the two boundary planes of every sharded
  direction with the neighbours and launches K4 (the full-lattice
  kernel) once on the local block, reading those ghost planes where a
  neighbour row wraps across a sharded face: bitwise one launch on the
  global field.  ``parity_hop_halo`` (K1, the hop kernel) evaluates the
  bulk with the local periodic wrap and then corrects the two boundary
  planes of every sharded direction with plane-sized plain tensor work
  (``hop_term_packed`` on one plane), as the JAX package does.
* Global reductions inside CG go through injected ``dot``/``norm2`` that
  all-reduce the local partial sums once per reduction; with ``pipecg``
  that is one all-reduce an iteration for the whole batch.

JAX runs these functions inside ``shard_map``, which supplies the
collectives.  Here a :class:`Mesh` does: ``ppermute`` (halo planes to the
neighbours along one axis, ``batch_isend_irecv`` within the axis's
subgroup) and ``psum`` (one ``all_reduce`` on the world group).  Every
rank calls every function of a solve in the same order with the same
shapes; the host reads of a loop read only all-reduced values, which are
the same bits on every rank, so every rank takes every branch together.

Transports: ``"nccl"`` (one card a rank) or ``"gloo"``.  Gloo moves host
tensors; a gloo mesh on a CUDA device stages every halo plane and partial
sum through pinned host memory explicitly.  The caller picks the
transport; nothing retries one on the other.
"""

from __future__ import annotations

import collections
import datetime
import math
import time
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core.operators import apply_igamma5_packed
from repro_torch.core.wilson import apply_gamma5_packed, hop_term_packed

Tensor = torch.Tensor

# lattice axis index -> name, for error messages
_LAT_AXIS_NAMES = {0: "T", 1: "Z", 2: "Y"}

TRANSPORTS = ("gloo", "nccl")
_REDUCE_OPS = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}


class MeshAxes:
    """A mesh's axes seen from one rank: what :class:`Mesh` and the
    dry-run's ``launch/mesh.py::RecordingMesh`` share.  A subclass sets
    ``axis_names``, ``shape`` (axis -> size, ranks row-major over the
    axes) and ``nbytes`` (a ``Counter``)."""

    def _axes(self, axes) -> tuple:
        """``axes`` (None: every axis) in the mesh's order."""
        if axes is None:
            return self.axis_names
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"{type(self).__name__}: no axis "
                             f"{sorted(unknown)} in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def rank_at(self, coords: Mapping[str, int]) -> int:
        """The rank at mesh ``coords`` (each taken modulo its axis)."""
        return int(np.ravel_multi_index(
            tuple(int(coords[a]) % self.shape[a] for a in self.axis_names),
            tuple(self.shape[a] for a in self.axis_names)))

    def coords_of(self, rank: int) -> dict:
        """The mesh coordinates of ``rank``."""
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            rank, tuple(self.shape[a] for a in self.axis_names)))))

    def _tally(self, kind: str, t: Tensor) -> None:
        """``t``'s bytes under ``nbytes["<kind>/<dtype>"]``."""
        self.nbytes[f"{kind}/{str(t.dtype).removeprefix('torch.')}"] += \
            t.numel() * t.element_size()


class Mesh(MeshAxes):
    """A device mesh over the ranks of the default process group.

    ``shape``/``axis_names``: the mesh axes, ranks laid out row-major over
    them (rank r sits at ``np.unravel_index(r, shape)``, as a JAX mesh
    built from devices 0..n-1).  Holds this rank's coordinates, one
    process subgroup per axis (the ranks that share every other
    coordinate), the world group, the device the rank's tensors live on
    and the transport.  ``counts`` tallies the collectives: ``all_reduce``,
    ``ppermute`` calls, ``<kind>_planes``/``<kind>_bytes`` sent by them
    (``kind`` "spinor" or "link"), ``all_gather``, ``broadcast``,
    ``barrier``, and the kinds callers name (the data-parallel trainer's
    ``param_gather``, ``grad_reduce_scatter``, ...); ``seconds`` the host's
    wall time inside each kind of collective (staging copies included, so
    also the wait for the card's queued work that a copy to the host
    implies); ``nbytes`` the bytes each ``psum`` and ``all_gather``
    passed in, keyed ``<kind>/<dtype>`` (the dtype the collective moved);
    ``reduce_scatter`` is counted as ``psum`` is.

    ``psum``, ``all_gather`` and ``reduce_scatter`` act on the world
    group, or with ``axes`` on the ranks that share this rank's
    coordinates on every other axis (one subgroup for each such set of
    axes, made at its first use: every rank makes its collectives in the
    same order, so every rank makes the same subgroups together).

    Every rank constructs the mesh with the same arguments (the subgroups
    are created collectively).  ``timeout`` bounds every collective of the
    subgroups; the world group's is set where it is initialised
    (:func:`repro_torch.launch.mesh.make_debug_mesh`).
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device, transport: str,
                 timeout: datetime.timedelta = datetime.timedelta(
                     seconds=120)):
        if not tdist.is_initialized():
            raise RuntimeError("Mesh needs an initialised default process "
                               "group (torch.distributed.init_process_group)")
        if transport not in TRANSPORTS:
            raise ValueError(f"Mesh: transport must be one of {TRANSPORTS}, "
                             f"got {transport!r}")
        shape = tuple(int(n) for n in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"Mesh: shape {shape} and axes {axis_names} "
                             "differ in length")
        world = tdist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"Mesh: shape {shape} holds {math.prod(shape)} "
                             f"ranks, the process group {world}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.rank = tdist.get_rank()
        self.world_size = world
        self.coords = dict(zip(axis_names,
                               (int(c) for c in np.unravel_index(self.rank,
                                                                 shape))))
        self.device = torch.device(device)
        self.transport = transport
        self._staged = transport == "gloo" and self.device.type == "cuda"
        self._timeout = timeout
        self._groups = {}
        self._lines = {}
        ranks = np.arange(world).reshape(shape)
        for i, name in enumerate(axis_names):
            for line in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
                group = tdist.new_group(line.tolist(), timeout=timeout)
                if self.rank in line:
                    self._groups[name] = group
                    self._lines[(name,)] = line.tolist()
        self._lines[axis_names] = list(range(world))
        self.counts = collections.Counter()
        self.seconds = collections.Counter()
        self.nbytes = collections.Counter()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, transport={self.transport!r})")

    # -- staging: gloo moves host tensors -----------------------------------

    def _out(self, t: Tensor) -> Tensor:
        """A buffer of ``t``'s shape and dtype on the transport's side."""
        if self._staged:
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def _send(self, t: Tensor) -> Tensor:
        """A contiguous copy of ``t`` on the transport's side (never ``t``
        itself: the collectives write in place)."""
        buf = self._out(t)
        buf.copy_(t)
        return buf

    def _back(self, buf: Tensor) -> Tensor:
        return buf.to(self.device) if self._staged else buf

    # -- collectives ---------------------------------------------------------

    def ppermute(self, axis: str, sends: Sequence[tuple[Tensor, int]], *,
                 kind: str = "spinor") -> list[Tensor]:
        """Cyclic shifts along one mesh axis, in one ``batch_isend_irecv``.

        Each ``(plane, shift)`` sends ``plane`` to the rank ``shift`` steps
        ahead along ``axis`` and returns the plane received from the rank
        ``shift`` steps behind (JAX's ``ppermute`` with the permutation
        ``i -> i + shift``).  With two ranks on the axis both neighbours
        are one process: the i-th send carries tag i, and the ops are
        issued in list order, so gloo matches them by tag and NCCL by
        order."""
        t0 = time.perf_counter()
        group = self._groups[axis]
        n = self.shape[axis]
        me = tdist.get_group_rank(group, self.rank)
        ops, bufs = [], []
        for tag, (plane, shift) in enumerate(sends):
            dst = tdist.get_global_rank(group, (me + shift) % n)
            src = tdist.get_global_rank(group, (me - shift) % n)
            out = self._out(plane)
            ops.append(tdist.P2POp(tdist.isend, self._send(plane), dst, group,
                                   tag))
            ops.append(tdist.P2POp(tdist.irecv, out, src, group, tag))
            bufs.append(out)
            self.counts[f"{kind}_planes"] += 1
            self.counts[f"{kind}_bytes"] += plane.numel() * plane.element_size()
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        out = [self._back(b) for b in bufs]
        self._done("ppermute", t0)
        return out

    def _done(self, kind: str, t0: float) -> None:
        self.counts[kind] += 1
        self.seconds[kind] += time.perf_counter() - t0

    def axes_ranks(self, axes=None) -> list[int]:
        """The ranks that share this rank's coordinates on every axis but
        ``axes``, ascending (row-major over ``axes``): the members of the
        group a collective over ``axes`` runs on, in its order."""
        axes = self._axes(axes)
        if axes not in self._lines:
            self._group(axes)
        return self._lines[axes]

    def _group(self, axes: tuple):
        """The process group over ``axes`` (None: the world group)."""
        if axes == self.axis_names:
            return None
        if len(axes) == 1:
            return self._groups[axes[0]]
        if axes not in self._groups:
            shape = tuple(self.shape[a] for a in self.axis_names)
            keep = [self.axis_names.index(a) for a in axes]
            ranks = np.moveaxis(np.arange(self.world_size).reshape(shape),
                                keep, list(range(-len(keep), 0)))
            for line in ranks.reshape(-1, math.prod(shape[i] for i in keep)):
                group = tdist.new_group(sorted(line.tolist()),
                                        timeout=self._timeout)
                if self.rank in line:
                    self._groups[axes] = group
                    self._lines[axes] = sorted(line.tolist())
        return self._groups[axes]

    def psum(self, t: Tensor, *, kind: str = "all_reduce",
             axes=None, op: str = "sum") -> Tensor:
        """The sum of ``t`` over every rank (one ``all_reduce`` on the
        world group), or with ``axes`` over the ranks of this rank's group
        on those axes; every rank of the group gets the same bits, summed
        in ``t``'s dtype (``op="max"``: the largest entry instead).
        ``kind``: the key it is counted under (the verification's own
        collectives count apart from the solve's)."""
        t0 = time.perf_counter()
        group = None if axes is None else self._group(self._axes(axes))
        buf = self._send(t)
        tdist.all_reduce(buf, op=_REDUCE_OPS[op], group=group)
        out = self._back(buf)
        self._tally(kind, t)
        self._done(kind, t0)
        return out

    def all_gather(self, t: Tensor, *, kind: str = "all_gather",
                   axes=None) -> list[Tensor]:
        """``t`` of every rank, in rank order (one ``all_gather``), or with
        ``axes`` of the ranks :meth:`axes_ranks` lists, in that order."""
        t0 = time.perf_counter()
        group = None if axes is None else self._group(self._axes(axes))
        n = self.world_size if axes is None else len(self.axes_ranks(axes))
        outs = [self._out(t) for _ in range(n)]
        tdist.all_gather(outs, self._send(t), group=group)
        outs = [self._back(o) for o in outs]
        self._tally(kind, t)
        self._done(kind, t0)
        return outs

    def reduce_scatter(self, t: Tensor, *, axes, dim: int = 0,
                       kind: str = "reduce_scatter") -> Tensor:
        """This rank's part of the sum of ``t`` over the ranks of its group
        on ``axes``: ``t`` cut along ``dim`` into as many equal parts as
        the group has ranks, in :meth:`axes_ranks`' order, and part i
        summed over the group in ``t``'s dtype on its i-th rank (one
        ``reduce_scatter``).  Counted, like :meth:`psum`, with the bytes
        of ``t``."""
        t0 = time.perf_counter()
        group = self._group(self._axes(axes))
        ranks = self.axes_ranks(axes)
        parts = [self._send(c) for c in
                 torch.chunk(t, len(ranks), dim=dim)]
        buf = self._out(parts[0])
        tdist.reduce_scatter(buf, parts, group=group)
        out = self._back(buf)
        self._tally(kind, t)
        self._done(kind, t0)
        return out

    def broadcast(self, t: Tensor, src: int = 0) -> Tensor:
        """Rank ``src``'s ``t`` on every rank (the other ranks pass a tensor
        of the same shape and dtype)."""
        t0 = time.perf_counter()
        buf = self._send(t)
        tdist.broadcast(buf, src)
        out = self._back(buf)
        self._done("broadcast", t0)
        return out

    def barrier(self) -> None:
        t0 = time.perf_counter()
        if self.transport == "nccl":
            tdist.barrier(device_ids=[self.device.index])
        else:
            tdist.barrier()
        self._done("barrier", t0)


# ---------------------------------------------------------------------------
# Halo operators (local blocks; every rank calls them together)
# ---------------------------------------------------------------------------


def _take(arr: Tensor, axis: int, idx: int) -> Tensor:
    """Single plane at static index ``idx`` (0 or -1), keeping the dim."""
    return arr.narrow(axis, idx % arr.shape[axis], 1)


def _add_at(arr: Tensor, axis: int, idx: int, delta: Tensor) -> Tensor:
    """``arr`` with ``delta`` (f32) added to plane ``idx``, rounded once to
    ``arr``'s dtype (in place: ``arr`` is a fresh kernel output)."""
    plane = _take(arr, axis, idx)
    plane.copy_((plane.to(delta.dtype) + delta).to(arr.dtype))
    return arr


def link_halos(mesh: Mesh, sharded: Mapping[int, tuple[str, int]],
               u: Tensor) -> dict[int, Tensor]:
    """``{mu: plane}``: for each sharded direction mu, the previous rank's
    last mu-plane of ``U_mu`` (``u`` packed (4, T, Z, Y, 18, X[h]) local
    links), which the backward hop into this block's plane 0 needs.

    JAX's halo functions ``ppermute`` this plane inside every block
    (``repro/core/distributed.py:94``, ``:213``).  The links do not change
    during a solve, so the port exchanges them once at set-up and every
    block reuses them: the same numbers with less traffic, the
    loop-invariant hoisting XLA is free to do."""
    out = {}
    for mu, (ax, n) in sorted(sharded.items()):
        if n == 1:
            continue
        (out[mu],) = mesh.ppermute(ax, [(_take(u[mu], mu, -1), 1)],
                                   kind="link")
    return out


def _links_prev(mesh, u_mu_last, mu, ax, u_prev):
    """U_mu at the previous rank's edge: from the set-up exchange, or
    exchanged here (JAX's per-block exchange) when none was made."""
    if u_prev is not None:
        return u_prev[mu]
    (p,) = mesh.ppermute(ax, [(u_mu_last, 1)], kind="link")
    return p


def _g5(p: Tensor) -> Tensor:
    """gamma5 on a (possibly batched) plane of a packed field."""
    return apply_gamma5_packed(p)


def _hop_plane(u_plane: Tensor, psi_plane: Tensor, mu: int,
               forward: bool) -> Tensor:
    """``hop_term_packed`` on one (possibly RHS-batched) boundary plane of
    a parity hop block (K1's corrections; K4 reads ghost planes), as an
    f32 term: the term the bulk's plain version summed, so that a
    correction cancels it.  f32 storage evaluates the term in f64 and
    rounds it once, as the plain full-lattice operator does each of its
    hop terms (``wilson.dslash_packed``); narrow storage evaluates it in
    f32 and keeps it there, as the kernels' narrow instances sum in f32
    and round their output once."""
    hop = torch.float64 if psi_plane.dtype == torch.float32 else None
    u32 = u_plane.to(torch.float32)

    def one(q):
        return hop_term_packed(u32, q.to(torch.float32), mu, forward=forward,
                               hop_dtype=hop)

    if psi_plane.dim() == 6:
        return torch.stack([one(q) for q in psi_plane])
    return one(psi_plane)


def _corrections(mesh, sharded, u_out, u_nbr, pp, *, gamma5_in, u_prev):
    """Per sharded direction: ``(pax, delta_b, delta_f)``, the corrections
    of planes 0 and -1 of axis ``pax`` of a parity hop block's bulk output
    (hop-only, before any epilogue), from halo planes of ``pp`` exchanged
    with the neighbours.  ``u_out``/``u_nbr``: the links at the output
    sites and at the neighbour sites."""
    batch = pp.dim() - 5  # 0 or 1 leading RHS-batch axes
    out = []
    for mu, (ax, n) in sorted(sharded.items()):
        if n == 1:
            continue
        pax = mu + batch
        first, last = _take(pp, pax, 0), _take(pp, pax, -1)
        if gamma5_in:  # fold gamma5 into the planes, as the kernels do
            first, last = _g5(first), _g5(last)
        u_out_last = _take(u_out[mu], mu, -1)
        u_nbr_last = _take(u_nbr[mu], mu, -1)
        # psi at my (axis)-1 edge from the previous rank, and at my +1
        # edge from the next one
        psi_prev, psi_next = mesh.ppermute(ax, [(last, 1), (first, -1)])
        u_prev_mu = _links_prev(mesh, u_nbr_last, mu, ax, u_prev)
        # backward hop into plane 0: the bulk used the local wrap (last)
        wrong_b = _hop_plane(u_nbr_last, last, mu, forward=False)
        right_b = _hop_plane(u_prev_mu, psi_prev, mu, forward=False)
        # forward hop into plane -1: U is local (output site), psi wrapped
        wrong_f = _hop_plane(u_out_last, first, mu, forward=True)
        right_f = _hop_plane(u_out_last, psi_next, mu, forward=True)
        out.append((pax, right_b - wrong_b, right_f - wrong_f))
    return out


def _ghosts(mesh, sharded, up, pp, u_prev) -> dict:
    """``{axis: (psi_prev, psi_next, u_prev)}``: for each sharded
    direction, the previous rank's last plane of ``pp`` and the next
    rank's first (one ``ppermute`` of both planes), and U_axis at the
    previous rank's edge: the ghost planes K4 reads
    (:func:`repro_torch.kernels.wilson_dslash.kernel.wilson_full`)."""
    batch = pp.dim() - 5
    out = {}
    for mu, (ax, n) in sorted(sharded.items()):
        if n == 1:
            continue
        pax = mu + batch
        prev, nxt = mesh.ppermute(ax, [(_take(pp, pax, -1), 1),
                                       (_take(pp, pax, 0), -1)])
        out[mu] = (prev, nxt, _links_prev(mesh, _take(up[mu], mu, -1), mu,
                                          ax, u_prev))
    return out


def dslash_halo(up: Tensor, pp: Tensor, mass, mesh: Mesh,
                sharded: Mapping[int, tuple[str, int]], *,
                use_kernels: bool = True, twist: float = 0.0,
                gamma5_in: bool = False, gamma5_out: bool = False,
                u_prev: Mapping[int, Tensor] | None = None) -> Tensor:
    """``g5out (D + i twist g5)(g5in psi)`` on a LOCAL block.

    The boundary planes of every sharded direction are exchanged first;
    then one K4 launch (``ops.dslash``; its plain version on CPU tensors,
    or directly with ``use_kernels=False``) reads them where a neighbour
    row wraps across a sharded face.  Each site sums the terms one launch
    on the global field sums, in the same order, so the gathered blocks
    are that launch bit for bit.

    Args:
      up: local (4, Tl, Zl, Yl, 18, X) packed links.
      pp: local (Tl, Zl, Yl, 24, X) packed spinor, or (N, ...) a batch.
      mesh, sharded: the mesh and ``{lattice axis (0=T, 1=Z, 2=Y):
        (mesh axis name, size)}`` (:func:`lattice_specs`).
      use_kernels: K4 through its wrapper, or its plain version directly.
      twist: the operator family's site-term twist.
      gamma5_in/gamma5_out: gamma5 folded into the launch (the ghost
        planes travel as stored; the kernel folds gamma5 on them too).
      u_prev: the link halo planes from :func:`link_halos`, or None to
        exchange them here.

    r = 1 only (K4's spin tables).
    """
    from repro_torch.kernels.wilson_dslash import ops as wops

    halo = _ghosts(mesh, sharded, up, pp, u_prev)
    return wops.dslash(up, pp, mass, twist=twist, gamma5_in=gamma5_in,
                       gamma5_out=gamma5_out, use_kernels=use_kernels,
                       halo=halo)


def dslash_dagger_halo(up, pp, mass, mesh, sharded, *,
                       use_kernels: bool = True, twist: float = 0.0,
                       u_prev=None) -> Tensor:
    """D^dag = gamma5 D(-twist) gamma5 on a local block, the gamma5s
    folded (one K4 launch)."""
    return dslash_halo(up, pp, mass, mesh, sharded, use_kernels=use_kernels,
                       twist=-twist, gamma5_in=True, gamma5_out=True,
                       u_prev=u_prev)


def normal_op_halo(up, pp, mass, mesh, sharded, *, use_kernels: bool = True,
                   twist: float = 0.0, u_prev=None) -> Tensor:
    """D^dag D on a local block: two K4 launches."""
    kw = dict(use_kernels=use_kernels, twist=twist, u_prev=u_prev)
    return dslash_dagger_halo(up, dslash_halo(up, pp, mass, mesh, sharded,
                                              **kw),
                              mass, mesh, sharded, **kw)


# ---------------------------------------------------------------------------
# Parity-compressed halo exchange: the even-odd Schur path, sharded
# ---------------------------------------------------------------------------
#
# The parity hop blocks roll only T, Z and Y (the x hops stay inside a
# row, and X is never sharded), so they need the full lattice's halo
# planes; K1 reads no ghost planes yet, so the bulk runs with the local
# wrap and the two boundary planes of every sharded direction are
# corrected afterwards.  The correction hop on a half field
# is the same ``hop_term_packed``: at fixed compressed index j the sites
# (t, z, y, j) and (t +- 1, z, y, j) are neighbours on the full lattice.
#
# Every sharded LOCAL extent must be even: shard origins are then even,
# each rank's local row parity equals the global row parity, and the
# local kernels (whose row parity comes from local coordinates) compute
# the right projections.  A leading RHS axis is never sharded: the spinor
# planes carry the batch, the link planes do not.


def parity_hop_halo(which: str, u_e: Tensor, u_o: Tensor, pp: Tensor,
                    mesh: Mesh, sharded: Mapping[int, tuple[str, int]], *,
                    use_kernels: bool = True, gamma5_in: bool = False,
                    gamma5_out: bool = False, psi_acc: Tensor | None = None,
                    acc_coeff: float = 0.0, hop_coeff: float = 1.0,
                    acc_twist: float = 0.0, hop_twist: float = 0.0,
                    u_prev: tuple[Mapping, Mapping] | None = None) -> Tensor:
    """Parity hop block on a LOCAL block.

    Computes ``(acc_coeff + acc_twist i g5) psi_acc + (hop_coeff +
    hop_twist i g5) g5out Hop(g5in psi)``, Hop being D_eo (``which="eo"``:
    odd in, even out) or D_oe: the bulk through K1 (``ops.hop_block``;
    its plain version on CPU tensors, or directly with
    ``use_kernels=False``), the boundary planes of every sharded direction
    corrected with exchanged halos.  gamma5 and the twists are applied to
    the correction planes only, as the kernel folds them.  ``u_prev``:
    ``(link_halos(u_e), link_halos(u_o))``, or None to exchange the link
    planes here.
    """
    from repro_torch.kernels.wilson_dslash import ops as wops

    out = wops.hop_block(u_e, u_o, pp, which=which, gamma5_in=gamma5_in,
                         gamma5_out=gamma5_out, psi_acc=psi_acc,
                         acc_coeff=acc_coeff, hop_coeff=hop_coeff,
                         acc_twist=acc_twist, hop_twist=hop_twist,
                         use_kernels=use_kernels)
    u_out, u_nbr = (u_e, u_o) if which == "eo" else (u_o, u_e)
    nbr_prev = None
    if u_prev is not None:
        nbr_prev = u_prev[1] if which == "eo" else u_prev[0]
    for pax, delta_b, delta_f in _corrections(
            mesh, sharded, u_out, u_nbr, pp, gamma5_in=gamma5_in,
            u_prev=nbr_prev):
        if gamma5_out:
            delta_b, delta_f = _g5(delta_b), _g5(delta_f)
        if hop_twist != 0.0:
            # the (hop_coeff + hop_twist i g5) epilogue the bulk folded,
            # applied plane-sized to the corrections
            delta_b = (hop_coeff * delta_b
                       + hop_twist * apply_igamma5_packed(delta_b))
            delta_f = (hop_coeff * delta_f
                       + hop_twist * apply_igamma5_packed(delta_f))
        else:
            delta_b, delta_f = hop_coeff * delta_b, hop_coeff * delta_f
        out = _add_at(out, pax, 0, delta_b)
        out = _add_at(out, pax, -1, delta_f)
    return out


def schur_op_halo(u_e, u_o, pp_e, mass, mesh, sharded, *,
                  use_kernels: bool = True, twist: float = 0.0,
                  dagger: bool = False, u_prev=None) -> Tensor:
    """Sharded Schur complement D_hat psi = S psi - D_eo S^-1 D_oe psi with
    the site term S = (mass + 4) + i twist g5: two local hop blocks with
    gamma5 (``dagger``), the axpy and the twist folded as on one device."""
    from repro_torch.core.operators import schur_launch_coeffs

    m = float(mass) + 4.0
    kw = dict(use_kernels=use_kernels, u_prev=u_prev)
    if twist == 0.0:
        tmp_o = parity_hop_halo("oe", u_e, u_o, pp_e, mesh, sharded,
                                gamma5_in=dagger, **kw)
        return parity_hop_halo("eo", u_e, u_o, tmp_o, mesh, sharded,
                               gamma5_out=dagger, psi_acc=pp_e, acc_coeff=m,
                               hop_coeff=-1.0 / m, **kw)
    h1c, h1t, acc, acct = schur_launch_coeffs(m, twist, dagger)
    tmp_o = parity_hop_halo("oe", u_e, u_o, pp_e, mesh, sharded,
                            gamma5_in=dagger, hop_coeff=h1c, hop_twist=h1t,
                            **kw)
    return parity_hop_halo("eo", u_e, u_o, tmp_o, mesh, sharded,
                           gamma5_out=dagger, psi_acc=pp_e, acc_coeff=acc,
                           acc_twist=acct, hop_coeff=-1.0, **kw)


def schur_normal_op_halo(u_e, u_o, pp_e, mass, mesh, sharded, *,
                         use_kernels: bool = True, twist: float = 0.0,
                         u_prev=None) -> Tensor:
    """A_hat = D_hat^dag D_hat on local blocks: four hop blocks, their
    halo corrections, no full-field gamma5, axpy or twist pass."""
    kw = dict(use_kernels=use_kernels, twist=twist, u_prev=u_prev)
    w = schur_op_halo(u_e, u_o, pp_e, mass, mesh, sharded, **kw)
    return schur_op_halo(u_e, u_o, w, mass, mesh, sharded, dagger=True, **kw)


# ---------------------------------------------------------------------------
# Mesh plumbing
# ---------------------------------------------------------------------------


def lattice_specs(mesh: Mesh, axis_map: Mapping[int, str] | None = None):
    """(psi_spec, gauge_spec, sharded) for decomposing (T, Z, Y) over
    ``mesh``.  A spec names, for each axis of a packed field, the mesh
    axis it is split over (None: not split), as JAX's ``PartitionSpec``;
    ``sharded`` is ``{lattice axis: (mesh axis, size)}``.

    Default axis map: T -> data, Z -> model, and Y -> pod when present.
    """
    if axis_map is None:
        axis_map = {0: "data", 1: "model"}
        if "pod" in mesh.axis_names:
            axis_map[2] = "pod"
    for mu, name in axis_map.items():
        if mu not in _LAT_AXIS_NAMES or name not in mesh.shape:
            raise ValueError(
                f"axis_map {dict(axis_map)}: lattice axis {mu} -> "
                f"{name!r} (lattice axes are 0=T, 1=Z, 2=Y; mesh axes "
                f"{mesh.axis_names})")
    sharded = {mu: (name, mesh.shape[name]) for mu, name in axis_map.items()}
    spin = [None] * 5
    for mu, name in axis_map.items():
        spin[mu] = name
    psi_spec = tuple(spin)
    gauge_spec = (None,) + psi_spec
    return psi_spec, gauge_spec, sharded


def layout_specs(mesh: Mesh, layout: str = "packed",
                 axis_map: Mapping[int, str] | None = None):
    """:func:`lattice_specs` for fields of ``layout``: ``"packed"``
    (T, Z, Y, 24, X) and (4, T, Z, Y, 18, X), or ``"natural"`` (T, Z, Y,
    X, 4, 3) and (4, T, Z, Y, X, 3, 3).  The lattice axes come first in
    both, so the natural specs are the packed ones with the site's
    trailing axes whole."""
    psi_spec, _, sharded = lattice_specs(mesh, axis_map)
    if layout == "natural":
        psi_spec = psi_spec[:3] + (None, None, None)
    elif layout != "packed":
        raise ValueError(f"layout must be 'natural' or 'packed', "
                         f"got {layout!r}")
    return psi_spec, (None,) + psi_spec, sharded


def block_slices(mesh: Mesh, shape, spec,
                 coords: Mapping[str, int] | None = None
                 ) -> tuple[slice, ...]:
    """The block at mesh ``coords`` (default: this rank's) of a global
    field of ``shape`` split by ``spec`` (trailing axes of ``shape``;
    leading ones are whole).  What a rank reads of a field it never
    holds whole, e.g. from a memory-mapped file."""
    coords = mesh.coords if coords is None else coords
    lead = len(shape) - len(spec)
    out = [slice(None)] * lead
    for ax, name in enumerate(spec):
        ext = shape[lead + ax]
        if name is None:
            out.append(slice(None))
            continue
        n = mesh.shape[name]
        if ext % n:
            raise ValueError(
                f"a field axis of extent {ext} does not split evenly over "
                f"{n} {name!r} shards")
        w = ext // n
        c = coords[name]
        out.append(slice(c * w, (c + 1) * w))
    return tuple(out)


def global_shape(mesh: Mesh, block_shape, spec) -> tuple[int, ...]:
    """The global field's shape from one block's (the inverse of
    :func:`block_slices`: every block of a spec has the same shape)."""
    lead = len(block_shape) - len(spec)
    return tuple(block_shape[:lead]) + tuple(
        ext * (1 if name is None else mesh.shape[name])
        for ext, name in zip(block_shape[lead:], spec))


def block_origin(mesh: Mesh, block_shape, spec,
                 coords: Mapping[str, int] | None = None) -> tuple[int, ...]:
    """The global index of the block's first entry along each axis of
    ``spec`` (0 on the whole axes).  The sum of the lattice axes' origins
    modulo 2 is the block's parity origin: even-odd blocks need it even,
    so that a block's local row parity is the global one."""
    coords = mesh.coords if coords is None else coords
    lead = len(block_shape) - len(spec)
    return tuple(0 if name is None else coords[name] * ext
                 for ext, name in zip(block_shape[lead:], spec))


def local_block(mesh: Mesh, field: Tensor, spec) -> Tensor:
    """This rank's contiguous block of a global packed field (a leading
    RHS axis, if any, stays whole)."""
    return field[block_slices(mesh, field.shape, spec)].contiguous()


def gather_blocks(mesh: Mesh, block: Tensor, spec, global_shape) -> Tensor:
    """Every rank's block of ``spec`` assembled into the global field (one
    all-gather); the same tensor on every rank."""
    out = torch.empty(tuple(global_shape), dtype=block.dtype,
                      device=block.device)
    mesh_shape = tuple(mesh.shape.values())
    for r, blk in enumerate(mesh.all_gather(block)):
        coords = dict(zip(mesh.axis_names,
                          (int(c) for c in np.unravel_index(r, mesh_shape))))
        out[block_slices(mesh, out.shape, spec, coords)] = blk
    return out


def pad_with_faces(mesh: Mesh, sharded: Mapping[int, tuple[str, int]],
                   u: Tensor, psi: Tensor):
    """Natural-layout blocks padded for a plain periodic operator:
    ``(u_pad, psi_pad, inner)``.

    ``u`` (4, T, Z, Y, X, 3, 3) and ``psi`` (T, Z, Y, X, 4, 3), or (N,
    ...) a batch, are this rank's blocks.  Every sharded direction mu
    gains one plane on each side: psi's plane -1 is the previous rank's
    last mu-plane and plane L its next rank's first, and U_mu's plane -1
    the previous rank's last (the backward hop's link); the corners and
    the other links of the pad stay 0, as no interior site reads them.
    A periodic operator on the padded blocks, indexed by ``inner``,
    is then the global operator's block.

    The faces travel in one ``all_gather`` of every rank's boundary
    planes (counted as ``verify_gather``), through none of the solver's
    halo code (no ``ppermute``, no ``link_halos``): the verification's
    transport, which a broken halo exchange cannot vouch for."""
    batch = psi.dim() - 6
    dirs = [(mu, ax) for mu, (ax, n) in sorted(sharded.items()) if n > 1]
    faces = []
    for mu, _ in dirs:
        a = mu + batch
        faces += [_take(psi, a, 0), _take(psi, a, -1), _take(u[mu], mu, -1)]
    shapes = [f.shape for f in faces]
    flat = torch.cat([torch.view_as_real(f.contiguous()).reshape(-1)
                      for f in faces]) if faces else None
    every = mesh.all_gather(flat, kind="verify_gather") if faces else []

    def face(rank: int, i: int) -> Tensor:
        off = sum(2 * math.prod(s) for s in shapes[:i])
        n = 2 * math.prod(shapes[i])
        return torch.view_as_complex(
            every[rank][off:off + n].reshape(tuple(shapes[i]) + (2,)))

    pad = {mu: psi.shape[mu + batch] for mu, _ in dirs}

    def spans(skip: int, idx) -> list:
        """Index of a lattice axis: ``idx`` on axis ``skip``, the interior
        on the other padded axes, whole elsewhere."""
        out = []
        for mu in range(3):
            if mu == skip:
                out.append(idx)
            elif mu in pad:
                out.append(slice(1, pad[mu] + 1))
            else:
                out.append(slice(None))
        return out

    lead = [slice(None)] * batch
    inner = tuple(spans(-1, None))
    padded = tuple(n + 2 if mu in pad else n
                   for mu, n in enumerate(psi.shape[batch:batch + 3]))
    psi_pad = psi.new_zeros(psi.shape[:batch] + padded
                            + psi.shape[batch + 3:])
    u_pad = u.new_zeros((u.shape[0],) + padded + u.shape[4:])
    psi_pad[tuple(lead) + inner] = psi
    u_pad[(slice(None),) + inner] = u
    for i, (mu, ax) in enumerate(dirs):
        prev = mesh.rank_at({**mesh.coords, ax: mesh.coords[ax] - 1})
        nxt = mesh.rank_at({**mesh.coords, ax: mesh.coords[ax] + 1})
        end = pad[mu] + 1
        psi_pad[tuple(lead + spans(mu, slice(0, 1)))] = face(prev, 3 * i + 1)
        psi_pad[tuple(lead + spans(mu, slice(end, end + 1)))] = face(nxt,
                                                                     3 * i)
        u_pad[mu][tuple(spans(mu, slice(0, 1)))] = face(prev, 3 * i + 2)
    return u_pad, psi_pad, inner


def make_psum_dots(mesh: Mesh, batched: bool = False):
    """Local-block inner products with one all-reduce per reduction.

    ``batched=True``: operands carry a leading RHS axis and the reductions
    return per-RHS (N,) scalars; the N partial sums still travel in one
    all-reduce, never N.
    """
    lead = 1 if batched else 0

    def dot(a, b):
        red = tuple(range(lead, a.dim()))
        local = (a.to(torch.float32) * b.to(torch.float32)).sum(dim=red)
        return mesh.psum(local)

    def norm2(a):
        a32 = a.to(torch.float32)
        return mesh.psum((a32 * a32).sum(dim=tuple(range(lead, a.dim()))))

    return dot, norm2


def make_fused_psum_dots(mesh: Mesh, batched: bool = False):
    """The pipelined-CG reduction: gamma = (r, r) and delta = (w, r), for
    every right-hand side, stacked into one (2,) or (2, N) partial sum and
    all-reduced once: the iteration's only collective, whatever N."""
    lead = 1 if batched else 0

    def fused_dots(r, w):
        red = tuple(range(lead, r.dim()))
        r32, w32 = r.to(torch.float32), w.to(torch.float32)
        local = torch.stack([(r32 * r32).sum(dim=red),
                             (w32 * r32).sum(dim=red)])
        both = mesh.psum(local)
        return both[0], both[1]

    return fused_dots


# (solver name) -> (plan.solver, plan.precision) for the legacy entry point
_LEGACY_SOLVERS = {"cg": ("cgnr", "single"), "pipecg": ("pipecg", "single"),
                   "mpcg": ("cgnr", "mixed"), "cg16": ("cgnr", "low")}


def solve_wilson(mesh: Mesh, up: Tensor, b: Tensor, mass, *,
                 solver: str = "cg", tol: float = 1e-6, maxiter: int = 1000,
                 inner_tol: float = 5e-2, low_dtype=torch.bfloat16,
                 axis_map: Mapping[int, str] | None = None,
                 residual_replacement_every: int = 25):
    """Solve D x = b (via the normal equations) on a mesh.

    ``solver``: "cg" | "pipecg" | "mpcg" | "cg16".  ``up``/``b``: the
    GLOBAL packed fields, the same on every rank.  Returns the global
    packed x and :class:`SolveStats`, the same on every rank.  A
    forwarder: builds the full-operator :class:`SolverPlan` and runs it
    with ``layout="packed"``.
    """
    if solver not in _LEGACY_SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")
    from repro_torch.core import plan as plan_mod
    sv, precision = _LEGACY_SOLVERS[solver]
    p = plan_mod.SolverPlan(operator="full", solver=sv, precision=precision,
                            low=low_dtype, mesh=mesh, axis_map=axis_map)
    return plan_mod.solve(
        p, up, b, mass, tol=tol, maxiter=maxiter, inner_tol=inner_tol,
        inner_maxiter=maxiter,
        residual_replacement_every=residual_replacement_every,
        layout="packed", device=mesh.device)


def shard_lattice_fields(mesh: Mesh, up: Tensor, pp: Tensor,
                         axis_map: Mapping[int, str] | None = None, *,
                         layout: str = "packed"):
    """This rank's blocks of the global fields of ``layout`` (a leading
    RHS axis of ``pp`` stays whole), on the mesh's device: JAX's
    ``device_put`` with the lattice decomposition, the slicer of a global
    field (:func:`block_slices` reads a block of a field never held
    whole)."""
    psi_spec, gauge_spec, _ = layout_specs(mesh, layout, axis_map)
    return (local_block(mesh, up.to(mesh.device), gauge_spec),
            local_block(mesh, pp.to(mesh.device), psi_spec))
