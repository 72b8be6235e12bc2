"""The ambient rank of a placed run, and the reference's sharding roles
against it (the port of ``repro.models.pspec``).

The reference reads an ambient mesh (``compat.use_mesh``) and annotates
activations for GSPMD, which partitions one program. The port places
explicitly: ``models.placement`` runs the model once per rank of a
``launch.mesh.Mesh``, each rank in a thread of its own under ``use_rank``,
on its shard of the batch and the slice of each parameter its layout
needs (``models.collectives`` does the exchanges). This module is that
ambient rank: ``current_mesh``, and ``dp_axes``, ``model_divides`` and
``constrain`` as the reference has them, plus the two choices the port's
layers take their parallel paths on (``attn_layout``, ``moe_ep``).

With no ambient rank (every path outside ``models.placement``) every
function is the identity or False, so those paths are unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch.launch.mesh import Mesh, dp_axes  # noqa: F401  (re-exported)
from repro_torch.models.config import ModelConfig

_LOCAL = threading.local()


@dataclasses.dataclass(frozen=True)
class Rank:
    """One rank of a placed run: the mesh, the rank's row-major index in
    it, the run's rendezvous (``collectives.Rendezvous``) and whether the
    run's batch is split over the data-parallel axes (it is replicated
    when they do not divide it)."""
    mesh: Mesh
    index: int
    rendezvous: Any
    batch_sharded: bool

    @property
    def coords(self) -> Dict[str, int]:
        """Axis name → this rank's index along it."""
        return coords(self.mesh, self.index)


def coords(mesh: Mesh, index: int) -> Dict[str, int]:
    out = {}
    for name, size in reversed(list(mesh.shape.items())):
        out[name] = index % size
        index //= size
    return {name: out[name] for name in mesh.axis_names}


@contextlib.contextmanager
def use_rank(rank: Rank) -> Iterator[Rank]:
    """Make ``rank`` this thread's ambient rank."""
    prev = getattr(_LOCAL, "rank", None)
    _LOCAL.rank = rank
    try:
        yield rank
    finally:
        _LOCAL.rank = prev


def current() -> Optional[Rank]:
    return getattr(_LOCAL, "rank", None)


def current_mesh() -> Optional[Mesh]:
    rank = current()
    return None if rank is None else rank.mesh


def dp_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def model_divides(n: int, mesh: Optional[Mesh] = None) -> bool:
    """True iff the mesh (the ambient one by default) has a ``model`` axis
    that divides n."""
    mesh = mesh or current_mesh()
    return (mesh is not None and "model" in mesh.axis_names
            and n % mesh.shape["model"] == 0)


def attn_layout(cfg: ModelConfig, mesh: Optional[Mesh] = None
                ) -> Optional[str]:
    """How attention lays out over ``model``, as the reference's
    ``attention`` chooses (None with no mesh):

    - ``"heads"``: ``model`` divides the query and the key/value heads;
      each rank projects and attends its slice of both.
    - ``"q_heads"``: it divides the query heads only; each rank projects
      its query heads, and the key/value heads whole (replicated).
    - ``"sequence"``: it does not divide the query heads; each rank
      attends its L/model query rows against the whole key/value, the
      attention weights whole (sequence-parallel attention).

    A mesh without a ``model`` axis takes ``"sequence"`` over a group of
    one, as the reference does (its zigzag stays off there too)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    if not model_divides(cfg.num_heads, mesh):
        return "sequence"
    return "heads" if model_divides(cfg.num_kv_heads, mesh) else "q_heads"


def moe_ep(cfg: ModelConfig, mesh: Optional[Mesh] = None,
           batch_sharded: Optional[bool] = None) -> bool:
    """The reference's condition for its expert-parallel ``shard_map``
    (``moe_ffn``): a ``model`` axis that divides the padded experts, and a
    global batch that the data-parallel axes divide (here: the run's batch
    is split over them, or there is one data-parallel rank). Defaults to
    the ambient rank's mesh and batch."""
    if mesh is None:
        rank = current()
        if rank is None:
            return False
        mesh, batch_sharded = rank.mesh, rank.batch_sharded
    if not model_divides(cfg.padded_experts, mesh):
        return False
    return bool(batch_sharded) or dp_size(mesh) == 1


def constrain(x: torch.Tensor, *dim_roles: Optional[str]) -> torch.Tensor:
    """dim_roles per axis: 'batch' | 'model' | None, as the reference's.

    The reference asks GSPMD for the layout; here each rank's tensor is
    already its shard in that layout (``models.placement`` places the
    batch and gathers each parameter to its use layout), so this checks
    the roles' count and returns ``x``."""
    if current() is not None and len(dim_roles) != x.dim():
        raise ValueError(f"{len(dim_roles)} roles for a {x.dim()}-d tensor")
    return x
