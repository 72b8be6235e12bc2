"""Elastic re-meshing: recompute a coherent mesh after node loss or join
(the port of ``repro.runtime.elastic``).

The recovery path:
  1. detect (heartbeat miss / a device error),
  2. pick the largest supported mesh that fits the surviving chips,
  3. rebuild the step for the new mesh (the sharding rules are
     divisibility-aware, so every mesh from this planner is valid for
     every arch),
  4. restore the latest deterministic checkpoint and continue — the data
     pipeline is step-indexed and dp_size-invariant (``data.pipeline``),
     so the global batch order is identical after the resize.

The planner prefers shrinking the ``data`` axis (pure DP: no
re-partition of parameters across a different TP width, the cheapest
restart), then ``pod``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_chips: int

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_remesh(available_chips: int, *, model: int = 16,
                prefer_pods: Optional[int] = None) -> ElasticPlan:
    """Largest (pod, data, model) mesh with ≤ available chips.

    `model` (TP width) is held fixed: changing it would re-partition every
    weight; `data`/`pod` shrink instead. data is kept a power of two so the
    step-indexed pipeline keeps dividing global_batch evenly.
    """
    if available_chips < model:
        raise ValueError(
            f"cannot keep TP width {model} with {available_chips} chips")
    best: Optional[ElasticPlan] = None
    max_pods = prefer_pods or max(available_chips // model, 1)
    for pods in range(max_pods, 0, -1):
        per_pod = available_chips // pods
        data = 1
        while data * 2 * model <= per_pod:
            data *= 2
        if data < 1:
            continue
        used = pods * data * model
        plan = (
            ElasticPlan((pods, data, model), ("pod", "data", "model"),
                        available_chips - used)
            if pods > 1 else
            ElasticPlan((data, model), ("data", "model"),
                        available_chips - used)
        )
        if best is None or plan.size > best.size:
            best = plan
    assert best is not None
    return best
