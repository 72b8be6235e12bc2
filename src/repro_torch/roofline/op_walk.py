"""Op walk: FLOPs, bytes and collective traffic of one step, counted op by
op (the port's counterpart of ``repro.roofline.hlo_walk``).

The reference parses XLA's compiled HLO text and multiplies every while
body by its trip count. The port has no compiled module: its layer loops
are Python loops, so every op runs once per execution. ``OpWalk`` is a
``TorchDispatchMode`` that tallies each aten op as it is dispatched, with
the reference ``Tally``'s fields:

  * dot FLOPs (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``dot``, ``mv``,
    ``convolution``): 2 x result elements x contraction size;
  * elementwise FLOPs: 1 x result elements for a known op list; a
    reduction 1 per input element; softmax 5 and logsumexp 4 per element
    (XLA's max, subtract, exp, sum and divide); sort n log2 n;
  * ``bytes``: every op's operands and results (the unfused upper bound)
    and ``bytes_min``: only what a fused program cannot avoid moving
    (products, gathers and scatters, sorts, concatenations, collectives);
  * collectives: each ``models.collectives`` call reports its result
    bytes and group size, weighted by the reference's ring costs
    (``analysis.wire_bytes``).

Run it over a step on ``meta`` tensors (``launch.specs``): nothing is
allocated or computed, as ``jax.eval_shape`` in the reference. It
analyses one rank's program (``collectives.solo`` for a mesh); every rank
runs the same shapes, as the reference's partitioned module is per
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.models import collectives
from repro_torch.roofline.analysis import wire_bytes

aten = torch.ops.aten

_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.dot, aten.mv,
         aten.convolution}
_ELEMENTWISE = {
    aten.add, aten.sub, aten.mul, aten.div, aten.maximum, aten.minimum,
    aten.pow, aten.exp, aten.expm1, aten.log, aten.log1p, aten.tanh,
    aten.sigmoid, aten.rsqrt, aten.sqrt, aten.neg, aten.abs, aten.sign,
    aten.floor, aten.ceil, aten.round, aten.eq, aten.ne, aten.lt, aten.le,
    aten.gt, aten.ge, aten.where, aten.logical_and, aten.logical_or,
    aten.logical_not, aten.bitwise_and, aten.bitwise_or, aten.bitwise_xor,
    aten.bitwise_not, aten.clamp, aten.clamp_min, aten.clamp_max,
    aten.remainder, aten.fmod, aten.floor_divide, aten.cos, aten.sin,
    aten.erf, aten.reciprocal, aten.silu, aten.gelu, aten.softplus,
    aten._to_copy, aten.silu_backward, aten.gelu_backward,
    aten.tanh_backward, aten.sigmoid_backward, aten.threshold_backward,
    aten.lerp, aten.addcmul, aten.addcdiv, aten.isfinite,
}
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.prod, aten.cumsum, aten.any, aten.all,
               aten.argmax, aten.argmin, aten.var_mean, aten.norm,
               aten.linalg_vector_norm, aten.bincount}
_PER_ELEMENT = {aten._softmax: 5, aten._log_softmax: 5,
                aten._softmax_backward_data: 3,
                aten._log_softmax_backward_data: 3, aten.logsumexp: 4}
_MOVES = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_,
          aten.gather, aten.scatter, aten.scatter_add, aten.index_select,
          aten.index_add, aten.embedding, aten.embedding_dense_backward,
          aten.sort, aten.cat, aten.stack, aten.index_copy}
_FREE = {aten.view, aten._unsafe_view, aten.reshape, aten.expand,
         aten.permute, aten.transpose, aten.t, aten.unsqueeze, aten.squeeze,
         aten.slice, aten.select, aten.as_strided, aten.alias, aten.detach,
         aten.split, aten.split_with_sizes, aten.unbind, aten.narrow,
         aten.diagonal, aten.unfold, aten._reshape_alias, aten.empty,
         aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.lift_fresh, aten.movedim,
         aten._local_scalar_dense, aten.is_same_size, aten.sym_size,
         aten.sym_stride, aten.sym_numel, aten.sym_storage_offset}


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


@dataclasses.dataclass
class Tally:
    flops: float = 0.0
    bytes: float = 0.0        # every op's operands and results
    bytes_min: float = 0.0    # products, data movement and collectives
    wire_bytes: float = 0.0
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_wire: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    dot_flops: float = 0.0
    ops: int = 0

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_min": self.bytes_min, "wire_bytes": self.wire_bytes,
                "dot_flops": self.dot_flops,
                "collective_counts": self.collective_counts,
                "collective_wire": self.collective_wire, "ops": self.ops}


def _dot_flops(packet, args, out) -> float:
    if packet is aten.convolution:
        w = args[1]
        return 2.0 * _numel(out) * math.prod(w.shape[1:])
    if packet in (aten.addmm, aten.baddbmm):
        a = args[1]
    else:
        a = args[0]
    return 2.0 * _numel(out) * a.shape[-1]


class OpWalk(TorchDispatchMode):
    """``with OpWalk() as w: step(...)`` → ``w.tally``."""

    def __init__(self):
        super().__init__()
        self.tally = Tally()
        self._rec = None

    def __enter__(self):
        self._rec = collectives.recording(self._collective)
        self._rec.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._rec.__exit__(*exc)

    def _collective(self, op: str, nbytes: int, n: int) -> None:
        t = self.tally
        w = wire_bytes(op, nbytes, n)
        t.collective_counts[op] = t.collective_counts.get(op, 0) + 1
        t.collective_wire[op] = t.collective_wire.get(op, 0.0) + w
        t.wire_bytes += w
        t.bytes += nbytes
        t.bytes_min += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet is aten.bincount and args[0].device.type == "meta":
            # its length depends on the data; the callers pass minlength
            out = torch.zeros(kwargs.get("minlength", args[2] if len(args)
                                         > 2 else 0),
                              dtype=torch.int64, device="meta")
        else:
            out = func(*args, **kwargs)
        if packet in _FREE:
            return out
        t = self.tally
        t.ops += 1
        ins = [x for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        moved = sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)
        t.bytes += moved
        n_out = sum(_numel(x) for x in outs)
        if packet in _DOTS:
            f = _dot_flops(packet, args, outs[0])
            t.dot_flops += f
            t.flops += f
            if packet in (aten.addmm, aten.baddbmm):
                t.flops += n_out
            t.bytes_min += moved
        elif packet in _ELEMENTWISE:
            t.flops += n_out
        elif packet in _REDUCTIONS:
            t.flops += _numel(ins[0]) if ins else 0
        elif packet in _PER_ELEMENT:
            t.flops += _PER_ELEMENT[packet] * n_out
        elif packet is aten.sort:
            n = max(_numel(ins[0]), 2)
            t.flops += n * math.log2(n)
        if packet in _MOVES:
            t.bytes_min += moved
        return out


def walk(fn, *args, **kwargs) -> Tally:
    """Tally ``fn(*args, **kwargs)``."""
    with OpWalk() as w:
        fn(*args, **kwargs)
    return w.tally
