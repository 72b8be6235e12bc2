"""Collectives over the ranks of a mesh in one process, in a fixed order.

A placed run (``models.placement``) runs one program per rank of a
``launch.mesh.Mesh``: ``spmd`` starts one thread per rank under
``pspec.use_rank`` and every rank's program meets the others at each
collective (a barrier). The last rank to arrive runs the collective for
every group of the mesh at once, as one autograd node whose backward is
again a fixed-order collective; the others wait and take their results.
A mesh may repeat a device (``[cuda:0] * 4`` on one card, ``["cpu"] * 4``
in tests); the same code spans ``cuda:0..3`` on a four-card host.

Every sum runs in float32 over the group's ranks in rank order and is
cast back, so reruns are bit-identical: no atomics, no order that a
scheduler picks. NCCL would need one process per card, and a mesh larger
than the host's card count could not run at all.

- ``psum`` / ``pmean`` (all-reduce) and ``all_gather`` over mesh axes;
  backward: the all-reduce of the gradients, and the fixed-order sum of
  each shard's slices of them.
- ``reshard`` moves one tensor from one layout (a spec: an entry per
  dimension, an axis name, a tuple of them or None, as
  ``models.sharding`` gives) to another: a parameter's storage shards to
  the slice each rank uses (the FSDP gather). Its backward gives every
  replica of a source shard the same sum of the gradient over all the
  ranks that used it: the gradient reduced over the data-parallel axes.
  ``reshard_shards`` is its forward without autograd.

``remat`` is block rematerialization across the ranks: a remat block
keeps none of the tensors its forward saves for the backward pass, and
the first read of one recomputes every rank's block together in a fresh
``spmd`` run, so the recompute meets its collectives.

Every collective reports its op, the bytes of each rank's result and its
group size to ``recording``'s callbacks (the roofline's op walk); the
copies and sums inside a collective are hidden from dispatch modes.
Under a ``Solo`` rendezvous one rank's program runs alone on the ``meta``
device: each collective gives a tensor of the shape the real one would
(and its backward one of the input's), so a dry run walks one device's
program of a mesh of any size. With no ambient rank every function is
the identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.launch.mesh import Mesh
from repro_torch.models import pspec

Spec = Tuple[Any, ...]
Block = Tuple[Tuple[int, int], ...]

_RECORDERS: List[Callable[[str, int, int], None]] = []
_RECORD_LOCK = threading.Lock()


@contextlib.contextmanager
def recording(fn: Callable[[str, int, int], None]):
    """Call ``fn(op, result_bytes, group_size)`` once per rank for every
    collective run inside the block (forward and backward)."""
    _RECORDERS.append(fn)
    try:
        yield
    finally:
        _RECORDERS.remove(fn)


def _record(op: str, t: torch.Tensor, n: int) -> None:
    if _RECORDERS:
        nbytes = t.numel() * t.element_size()
        with _RECORD_LOCK:
            for fn in list(_RECORDERS):
                fn(op, nbytes, n)


# --------------------------------------------------------------------------- #
# groups and blocks
# --------------------------------------------------------------------------- #


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def groups(mesh: Mesh, axes: Sequence[str]) -> List[List[int]]:
    """The ranks that meet in a collective over ``axes``: those equal on
    every other axis, each group in rank order."""
    out: Dict[tuple, List[int]] = {}
    for r in range(mesh.size):
        c = pspec.coords(mesh, r)
        out.setdefault(tuple(c[a] for a in mesh.axis_names if a not in axes),
                       []).append(r)
    return list(out.values())


def block(spec: Spec, shape: Sequence[int], mesh: Mesh, index: int) -> Block:
    """Rank ``index``'s [start, stop) per dimension of a tensor of
    ``shape`` laid out by ``spec`` (``NamedSharding``'s shard: an entry's
    axes split its dimension, the first axis major)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    c = pspec.coords(mesh, index)
    out = []
    for size, entry in zip(shape, spec):
        n, i = 1, 0
        for a in _axes(entry):
            n, i = n * mesh.shape[a], i * mesh.shape[a] + c[a]
        if size % n:
            raise ValueError(f"dimension {size} does not split {n} ways "
                             f"({spec} over {mesh.shape})")
        step = size // n
        out.append((i * step, (i + 1) * step))
    return tuple(out)


def shard_shape(spec: Spec, shape: Sequence[int], mesh: Mesh
                ) -> Tuple[int, ...]:
    """The shape of every rank's shard (equal for all ranks)."""
    return tuple(b - a for a, b in block(spec, shape, mesh, 0))


def shard(x: torch.Tensor, spec: Spec, mesh: Mesh, index: int, device
          ) -> torch.Tensor:
    """Rank ``index``'s shard of the global ``x``, copied to ``device``."""
    sl = tuple(slice(a, b) for a, b in block(spec, x.shape, mesh, index))
    return x[sl].to(device, copy=True).contiguous()


def _intersect(a: Block, b: Block) -> Optional[Block]:
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1)
                in zip(a, b))
    return None if any(s >= e for s, e in out) else out


def _rel(region: Block, origin: Block) -> tuple:
    return tuple(slice(s - o, e - o) for (s, e), (o, _) in zip(region, origin))


# --------------------------------------------------------------------------- #
# the runner
# --------------------------------------------------------------------------- #


class Rendezvous:
    """Where the ranks of one ``spmd`` run meet: each collective is a
    barrier whose action (run once, by the last rank to arrive) computes
    every rank's result; a second barrier keeps the next collective from
    overwriting results not yet taken. Its ranks have finished by the
    backward pass, so a remat block's recompute runs in a fresh ``spmd``
    (``remat``); the k-th remat block of every rank shares one
    ``_RematGroup``. A rank that returns while another waits at (or later
    reaches) a collective breaks the barrier: the ranks diverged."""

    def __init__(self, n: int):
        self._in: List[Any] = [None] * n
        self._out: List[Any] = [None] * n
        self._lock = threading.Lock()
        self._arrived = 0
        self._done = False
        self._barrier = threading.Barrier(n, action=self._run)
        self._remats: Dict[int, _RematGroup] = {}
        self._remat_next = [0] * n

    def _run(self) -> None:
        self._arrived = 0
        keys = {k for k, _, _ in self._in}
        if len(keys) != 1:
            raise RuntimeError(f"the ranks diverged at a collective: {keys}")
        action = self._in[0][1]
        with _disable_current_modes():
            self._out = action([v for _, _, v in self._in])

    def exchange(self, index: int, key: str, action: Callable, value: Any):
        with self._lock:
            if self._done:
                self._barrier.abort()
                raise RuntimeError(f"the ranks diverged: rank {index} "
                                   "reached a collective after another "
                                   "returned")
            self._arrived += 1
        self._in[index] = (key, action, value)
        self._barrier.wait()
        out = self._out[index]
        self._barrier.wait()
        return out

    def finish(self) -> None:
        """A rank returned: no collective can complete from now on."""
        with self._lock:
            self._done = True
            if self._arrived:
                self._barrier.abort()

    def abort(self) -> None:
        self._barrier.abort()

    def remat_group(self, index: int) -> "_RematGroup":
        """Rank ``index``'s next remat block: the k-th block of every rank
        gets the same group (the ranks run the same program)."""
        with self._lock:
            k = self._remat_next[index]
            self._remat_next[index] += 1
            group = self._remats.get(k)
            if group is None:
                group = self._remats[k] = _RematGroup(len(self._in))
            group.joined += 1
            if group.joined == len(self._in):
                del self._remats[k]
            return group


class Solo:
    """The rendezvous of one rank's program run alone (``solo``). Its
    collectives may run again in a backward pass (torch's checkpoint)."""


def solo(mesh: Mesh, fn: Callable, *args, index: int = 0,
         batch_sharded: bool = True):
    """Run ``fn(*args)`` as rank ``index`` of ``mesh`` alone, on ``meta``
    tensors: collectives give results of the right shape and no data."""
    with pspec.use_rank(pspec.Rank(mesh, index, Solo(), batch_sharded)):
        return fn(*args)


class _Standin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_shape, bwd_op, bwd_n):
        ctx.in_shape, ctx.bwd_op, ctx.bwd_n = x.shape, bwd_op, bwd_n
        with _disable_current_modes():
            return x.new_empty(out_shape)

    @staticmethod
    def backward(ctx, grad):
        with _disable_current_modes():
            out = grad.new_empty(ctx.in_shape)
        _record(ctx.bwd_op, out, ctx.bwd_n)
        return out, None, None, None


def _solo() -> bool:
    rank = pspec.current()
    return rank is not None and isinstance(rank.rendezvous, Solo)


def spmd(mesh: Mesh, fn: Callable, args: Sequence[tuple], *,
         batch_sharded: bool = True) -> List[Any]:
    """Run ``fn(*args[r])`` once per rank r of ``mesh``, each in a thread
    of its own under ``pspec.use_rank``, with the caller's grad mode and
    intra-op thread count, and its device current when it is a card. Returns the results in rank
    order; a rank's exception is raised here after every rank stopped."""
    n = mesh.size
    if len(args) != n:
        raise ValueError(f"{len(args)} argument tuples for {n} ranks")
    rdv = Rendezvous(n)
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    grad = torch.is_grad_enabled()
    # a new thread starts with the default intra-op thread count (OpenMP's
    # is per thread); the caller's keeps CPU reductions in the same order
    threads_per_op = torch.get_num_threads()
    # each rank's card by index ("cuda" alone is the caller's current one)
    cards = [None] * n
    for r, d in enumerate(mesh.devices):
        d = torch.device(d)
        if d.type == "cuda":
            cards[r] = torch.cuda.current_device() if d.index is None \
                else d.index

    def body(r: int) -> None:
        try:
            torch.set_num_threads(threads_per_op)
            if cards[r] is not None:
                torch.cuda.set_device(cards[r])
            with torch.set_grad_enabled(grad), pspec.use_rank(pspec.Rank(
                    mesh, r, rdv, batch_sharded)):
                results[r] = fn(*args[r])
            rdv.finish()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[r] = e
            rdv.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [e for e in errors if e is not None
            and not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]
    if any(e is not None for e in errors):
        raise RuntimeError("the ranks diverged: a rank returned while "
                           "others waited at a collective")
    return results


def _exchange(key: str, action: Callable, value: Any):
    rank = pspec.current()
    return rank.rendezvous.exchange(rank.index, key, action, value)


def axis_index(axis: str) -> int:
    """This rank's index along ``axis`` (0 with no ambient rank)."""
    rank = pspec.current()
    if rank is None or axis not in rank.mesh.axis_names:
        return 0
    return rank.coords[axis]


def _group_size(axes: Tuple[str, ...]) -> int:
    mesh = pspec.current_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in axes if a in mesh.axis_names)


# --------------------------------------------------------------------------- #
# remat across the ranks
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class _Frame:
    """One rank's remat block: its function and inputs, and how many
    tensors its forward saved for the backward pass."""
    fn: Callable
    args: tuple
    rank: Any
    count: int = 0


class _RematGroup:
    """The same remat block on every rank of one ``spmd`` run: each rank's
    ``_Frame`` and, once recomputed, the tensors each rank's block saves,
    in the order it saved them."""

    def __init__(self, n: int):
        self.frames: List[Optional[_Frame]] = [None] * n
        self.saved: Optional[List[List[Optional[torch.Tensor]]]] = None
        self.joined = 0
        self._lock = threading.Lock()

    def read(self, index: int, i: int) -> torch.Tensor:
        """Rank ``index``'s i-th saved tensor (each is read once)."""
        with self._lock:
            if self.saved is None:
                self._recompute()
        t = self.saved[index][i]
        if t is None:
            raise RuntimeError("a remat block's saved tensor was read twice")
        self.saved[index][i] = None
        return t

    def _recompute(self) -> None:
        frames = self.frames
        saved: List[List[Optional[torch.Tensor]]] = [[] for _ in frames]

        def body(r: int) -> None:
            def pack(t: torch.Tensor):
                saved[r].append(t.detach())

            f = frames[r]
            args = [a.detach().requires_grad_(a.requires_grad)
                    if isinstance(a, torch.Tensor) else a for a in f.args]
            with torch.enable_grad(), \
                    torch.autograd.graph.saved_tensors_hooks(pack, _never):
                f.fn(*args)

        first = frames[0].rank
        spmd(first.mesh, body, [(r,) for r in range(len(frames))],
             batch_sharded=first.batch_sharded)
        for f, got in zip(frames, saved):
            if len(got) != f.count:
                raise RuntimeError(f"a remat block saved {len(got)} tensors "
                                   f"on recompute, {f.count} the first time")
        self.saved, self.frames = saved, None


def _never(_):
    raise RuntimeError("a recomputed block's tensors are not unpacked")


def _unpack(handle) -> torch.Tensor:
    group, index, i = handle
    return group.read(index, i)


def _remat_call(fn: Callable, *args):
    rank = pspec.current()
    group = rank.rendezvous.remat_group(rank.index)
    frame = group.frames[rank.index] = _Frame(fn, args, rank)

    def pack(_t: torch.Tensor):
        frame.count += 1
        return group, rank.index, frame.count - 1

    with torch.autograd.graph.saved_tensors_hooks(pack, _unpack):
        return fn(*args)


def remat(fn: Callable) -> Callable:
    """Inside a ``spmd`` run: ``fn`` with the tensors it saves for the
    backward pass recomputed there instead of kept, with the same bits.
    The first read recomputes every rank's call together (a fresh
    ``spmd``, so its collectives meet); every rank wraps the same calls in
    the same order. (Alone, under ``solo``, and with no ambient rank,
    torch's checkpoint does this.)"""
    if not isinstance(getattr(pspec.current(), "rendezvous", None),
                      Rendezvous):
        raise RuntimeError("collectives.remat runs inside collectives.spmd")
    return functools.partial(_remat_call, fn)


# --------------------------------------------------------------------------- #
# all-reduce and all-gather
# --------------------------------------------------------------------------- #


def _fixed_sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    s = xs[0].to(torch.float32)
    for x in xs[1:]:
        s = s + x.to(s.device, torch.float32)
    return s


def _sum_groups(gs: List[List[int]], xs: Sequence[torch.Tensor], like
                ) -> List[torch.Tensor]:
    out: List[Any] = [None] * len(xs)
    for g in gs:
        s = _fixed_sum([xs[j] for j in g])
        for r in g:
            out[r] = s.to(like[r].device, like[r].dtype, copy=True)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gs, *xs):
        ctx.gs = gs
        ctx.like = [torch.empty(0, dtype=x.dtype, device=x.device)
                    for x in xs]
        return tuple(_sum_groups(gs, xs, ctx.like))

    @staticmethod
    def backward(ctx, *grads):
        with _disable_current_modes():
            out = _sum_groups(ctx.gs, grads, ctx.like)
        for g, o in zip(ctx.gs, out):
            for r in g:
                _record("all-reduce", out[r], len(g))
        return (None, *out)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gs, dim, *xs):
        ctx.gs, ctx.dim = gs, dim
        ctx.like = [torch.empty(0, dtype=x.dtype, device=x.device)
                    for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        out: List[Any] = [None] * len(xs)
        for g in gs:
            for r in g:
                out[r] = torch.cat([xs[j].to(xs[r].device) for j in g], dim)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        out: List[Any] = [None] * len(grads)
        with _disable_current_modes():
            for g in ctx.gs:
                off = 0
                for j in g:
                    n = ctx.sizes[j]
                    s = _fixed_sum([grads[r].narrow(ctx.dim, off, n)
                                    for r in g])
                    out[j] = s.to(ctx.like[j].device, ctx.like[j].dtype)
                    off += n
        for g in ctx.gs:
            for j in g:
                _record("reduce-scatter", grads[j], len(g))
        return (None, None, *out)


def _axes_of(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (a name or a tuple), in
    float32 in rank order, cast back to x's dtype; the identity with no
    ambient rank or a group of one."""
    axes = _axes_of(axes)
    n = _group_size(axes)
    if n == 1:
        return x
    if _solo():
        out = _Standin.apply(x, x.shape, "all-reduce", n)
    else:
        gs = groups(pspec.current_mesh(), axes)
        out = _exchange(f"psum{axes}", lambda xs: _PSum.apply(gs, *xs), x)
    _record("all-reduce", out, n)
    return out


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    """``psum`` over ``axes`` divided by the group's size."""
    n = _group_size(_axes_of(axes))
    return x if n == 1 else psum(x, axes) / n


def all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The group's shards of ``x`` along ``axis``, concatenated along
    ``dim`` in rank order."""
    n = _group_size((axis,))
    if n == 1:
        return x
    dim = dim % x.dim()
    if _solo():
        shape = list(x.shape)
        shape[dim] *= n
        out = _Standin.apply(x, tuple(shape), "reduce-scatter", n)
    else:
        gs = groups(pspec.current_mesh(), (axis,))
        out = _exchange(f"all_gather({axis},{dim})",
                        lambda xs: _AllGather.apply(gs, dim, *xs), x)
    _record("all-gather", out, n)
    return out


# --------------------------------------------------------------------------- #
# reshard
# --------------------------------------------------------------------------- #


def _plan(shape, src: Spec, dst: Spec, mesh: Mesh):
    n = mesh.size
    src_b = [block(src, shape, mesh, j) for j in range(n)]
    dst_b = [block(dst, shape, mesh, r) for r in range(n)]
    owner: Dict[Block, int] = {}
    for j, b in enumerate(src_b):
        owner.setdefault(b, j)
    return src_b, dst_b, owner


def reshard_shards(xs: Sequence[torch.Tensor], shape: Sequence[int],
                   src: Spec, dst: Spec, mesh: Mesh) -> List[torch.Tensor]:
    """Every rank's shard under ``dst`` of the tensor of ``shape`` whose
    shards under ``src`` are ``xs`` (one per rank, on its device), built
    from the ranks that hold each piece (the rank itself where it does,
    else the first in rank order). New tensors."""
    src_b, dst_b, owner = _plan(shape, src, dst, mesh)
    out = []
    for r, db in enumerate(dst_b):
        dev = xs[r].device
        buf = torch.empty(tuple(e - s for s, e in db), dtype=xs[r].dtype,
                          device=dev)
        for b, j in owner.items():
            region = _intersect(b, db)
            if region is None:
                continue
            j = r if src_b[r] == b else j
            buf[_rel(region, db)] = xs[j][_rel(region, b)].to(dev)
        out.append(buf)
    return out


class _Reshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layout, *xs):
        shape, src, dst, mesh = layout
        ctx.layout = layout
        ctx.like = [torch.empty(0, dtype=x.dtype, device=x.device)
                    for x in xs]
        return tuple(reshard_shards(xs, shape, src, dst, mesh))

    @staticmethod
    def backward(ctx, *grads):
        shape, src, dst, mesh = ctx.layout
        src_b, dst_b, owner = _plan(shape, src, dst, mesh)
        out: List[Any] = [None] * len(grads)
        with _disable_current_modes():
            for b, j0 in owner.items():
                dev = ctx.like[j0].device
                acc = torch.zeros(tuple(e - s for s, e in b),
                                  dtype=torch.float32, device=dev)
                users = 0
                for r, db in enumerate(dst_b):
                    region = _intersect(b, db)
                    if region is not None:
                        users += 1
                        acc[_rel(region, b)] += grads[r][_rel(region, db)].to(
                            dev, torch.float32)
                for j, bj in enumerate(src_b):
                    if bj == b:
                        out[j] = acc.to(ctx.like[j].device, ctx.like[j].dtype,
                                        copy=True)
                        _record("reduce-scatter", out[j], users)
        return (None, *out)


def reshard(x: torch.Tensor, shape: Sequence[int], src: Spec, dst: Spec,
            key: str = "") -> torch.Tensor:
    """This rank's shard under ``dst`` of the tensor of global ``shape``
    whose shard under ``src`` is ``x`` (a collective: every rank calls it
    in the same order). Differentiable."""
    mesh = pspec.current_mesh()
    layout = (tuple(shape), tuple(src), tuple(dst), mesh)
    sources, users = _fan(layout, pspec.current().index)
    if _solo():
        out = _Standin.apply(x, shard_shape(dst, shape, mesh),
                             "reduce-scatter", users)
    else:
        out = _exchange(f"reshard {key}{layout[:3]}",
                        lambda xs: _Reshard.apply(layout, *xs), x)
    _record("all-gather", out, sources)
    return out


@functools.lru_cache(maxsize=4096)
def _fan(layout, index: int) -> Tuple[int, int]:
    """(the distinct source blocks rank ``index``'s result is made of, the
    ranks whose results read its own block): the group sizes of the
    gather and of its backward's reduce-scatter."""
    shape, src, dst, mesh = layout
    src_b, dst_b, _ = _plan(shape, src, dst, mesh)
    sources = len({b for b in src_b
                   if _intersect(b, dst_b[index]) is not None})
    users = sum(_intersect(src_b[index], b) is not None for b in dst_b)
    return sources, users
