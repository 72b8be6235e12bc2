"""Multi-device execution: a model, its optimizer state, batches and caches
placed over a mesh's devices, and the train, prefill and decode steps run
over them.

One process, explicit device lists. ``place`` keeps, for every parameter
of a model (by the port's name), one shard per rank of a
``launch.mesh.Mesh`` on that rank's device: the slice that the
reference's ``NamedSharding(mesh, spec).shard_shape`` gives, with ``spec``
from ``models.sharding``'s rules (FSDP over ``data``, TP over ``model``,
replication where the rules replicate). AdamW's ``m`` and ``v`` are
placed the same way, a batch by ``train_batch_specs`` and decode caches
by ``cache_specs``.

The steps run the model's own code once per rank (``collectives.spmd``:
one thread per rank, each under ``pspec``'s ambient rank) on the rank's
shard of the batch. A rank reads a parameter through ``_View``: the read
is a collective (``collectives.reshard``) that turns the storage shards
into the slice the rank's computation uses (``use_spec``) — the FSDP
gather before use. That slice is the head, FFN-column or expert slice
under the layers' parallel paths (``pspec.attn_layout``: the query and
key/value heads under ``heads``, the query heads under ``q_heads``,
nothing under ``sequence``; ``model_divides(d_ff)``, ``moe_ep``), the
vocabulary slice of the embedding and head, and the whole tensor
elsewhere (norms, the SSM blocks, a dense MoE).
The layers add their sums over ``model``; the loss is the global batch's
(sums over the data-parallel ranks in rank order); the backward of every
read gives each replica of a shard the same sum of its gradient over the
ranks that used it, so AdamW updates each shard where it lives and the
replicas stay bit-identical. A decode cache whose storage layout differs
from the layout the step computes in is resharded around the step, inside
each rank's program (so a dry run walks it).

Block remat runs under a mesh as unplaced (``transformer._maybe_remat``,
``collectives.remat``): a block's saved activations are dropped in the
forward pass and every rank's block is recomputed together in the
backward, with the same bits. Capacity-bound MoE routing is per data
shard under expert parallelism, as the reference's; a placed MoE run
equals an unplaced one on each data shard's batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.launch.mesh import Mesh, dp_axes
from repro_torch.models import collectives, pspec
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import Rules, _bspec, cache_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_update

Spec = Tuple[Any, ...]


# --------------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------------- #


def param_spec(name: str, shape: Sequence[int], cfg: ModelConfig,
               mesh: Mesh) -> Spec:
    """The storage spec of the port's parameter ``name`` (one layer of the
    reference's stack: the rules read the leaf's name and trailing
    dimensions, and a stack's leading axes replicate)."""
    return Rules(mesh, cfg).spec_for(name.replace(".", "/"), tuple(shape))


def use_spec(name: str, shape: Sequence[int], cfg: ModelConfig, mesh: Mesh,
             batch_sharded: bool) -> Spec:
    """The slice of parameter ``name`` that a rank's computation uses: the
    layers' parallel paths decide (module docstring); whole elsewhere."""
    leaf, nd = name.rsplit(".", 1)[-1], len(shape)
    full = (None,) * nd
    vocab = pspec.model_divides(cfg.padded_vocab, mesh)
    if leaf == "embed":
        return ("model", None) if vocab else full
    if leaf == "lm_head":
        return (None, "model") if vocab else full
    if leaf in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
        layout = pspec.attn_layout(cfg, mesh)
        split = layout == "heads" or (layout == "q_heads"
                                      and leaf in ("wq", "wo", "bq"))
        if not split:
            return full
        return {"wo": ("model", None, None), "bq": ("model", None),
                "bk": ("model", None), "bv": ("model", None)}.get(
                    leaf, (None, "model", None))
    if leaf in ("w_gate", "w_up", "w_down") and nd == 3:  # experts
        ep = pspec.moe_ep(cfg, mesh, batch_sharded)
        return ("model", None, None) if ep else full
    if leaf in ("w_gate", "w_up"):
        return (None, "model") if pspec.model_divides(cfg.d_ff, mesh) \
            else full
    if leaf == "w_down":
        return ("model", None) if pspec.model_divides(cfg.d_ff, mesh) \
            else full
    return full


def batch_spec(key: str, ndim: int, b) -> Spec:
    """A batch leaf's spec: the batch dimension over the data-parallel
    axes (``positions_3d`` [3, B, L] carries it second)."""
    if key == "positions_3d":
        return (None, b) + (None,) * (ndim - 2)
    return (b,) + (None,) * (ndim - 1)


# --------------------------------------------------------------------------- #
# placed parameters
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Placed:
    """A module's parameters over ``mesh``: ``shards[r][name]`` on
    ``mesh.devices[r]``, laid out by ``specs[name]`` over global
    ``shapes[name]``."""
    cfg: ModelConfig
    mesh: Mesh
    specs: Dict[str, Spec]
    shapes: Dict[str, Tuple[int, ...]]
    shards: List[Dict[str, torch.Tensor]]

    def __post_init__(self):
        self._children: Dict[str, set] = {}
        for name in self.shapes:
            parts = name.split(".")
            for i in range(len(parts)):
                self._children.setdefault(".".join(parts[:i]), set()).add(
                    parts[i])

    def view(self, rank: int,
             leaves: Optional[Dict[str, torch.Tensor]] = None) -> "_View":
        """Rank ``rank``'s model, to pass to the model's functions inside
        ``collectives.spmd`` (``leaves`` replace the shards: the leaves a
        backward differentiates)."""
        return _View(self, leaves or self.shards[rank], "")

    def owners(self, name: str) -> Dict[tuple, int]:
        """Each distinct block of ``name`` → the first rank holding it."""
        out: Dict[tuple, int] = {}
        for r in range(self.mesh.size):
            out.setdefault(collectives.block(self.specs[name],
                                             self.shapes[name], self.mesh,
                                             r), r)
        return out

    def gather(self, name: str, device=None) -> torch.Tensor:
        """The global tensor of ``name`` from its shards, on ``device``
        (the first rank's by default)."""
        return gather_like(self.shards, self, name,
                           device or self.mesh.devices[0])


class _View:
    """A rank's model: attribute and index access mirror the module's;
    reading a parameter is ``collectives.reshard`` to its use slice."""

    __slots__ = ("_placed", "_leaves", "_prefix")

    def __init__(self, placed: Placed, leaves, prefix: str):
        self._placed, self._leaves, self._prefix = placed, leaves, prefix

    def _child(self, key: str):
        p = self._placed
        name = self._prefix + key
        if name in p.shapes:
            rank = pspec.current()
            src = p.specs[name]
            dst = use_spec(name, p.shapes[name], p.cfg, p.mesh,
                           rank.batch_sharded)
            x = self._leaves[name]
            if dst == src and not torch.is_grad_enabled():
                return x
            return collectives.reshard(x, p.shapes[name], src, dst, name)
        if name in p._children:
            return _View(p, self._leaves, name + ".")
        raise AttributeError(name)

    def __getattr__(self, key: str):
        return self._child(key)

    def __getitem__(self, i: int):
        return self._child(str(i))

    def __len__(self) -> int:
        return len(self._placed._children[self._prefix[:-1]])

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def place(module: nn.Module, cfg: ModelConfig, mesh: Mesh) -> Placed:
    """Place ``module``'s parameters (a ``Transformer`` or any of its
    layers, on any device) over ``mesh``'s devices by the sharding
    rules."""
    if not mesh.devices:
        raise ValueError("the mesh lays over no devices")
    specs, shapes = {}, {}
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(mesh.size)]
    for name, p in module.named_parameters():
        shapes[name] = tuple(p.shape)
        specs[name] = param_spec(name, p.shape, cfg, mesh)
        for r, dev in enumerate(mesh.devices):
            shards[r][name] = collectives.shard(p.detach(), specs[name], mesh,
                                                r, dev)
    return Placed(cfg, mesh, specs, shapes, shards)


def place_like(tree: Dict[str, torch.Tensor], placed: Placed
               ) -> List[Dict[str, torch.Tensor]]:
    """Per-rank shards of per-parameter tensors (gradients, AdamW's m or
    v) in ``placed``'s layout."""
    return [{k: collectives.shard(v, placed.specs[k], placed.mesh, r, dev)
             for k, v in tree.items()}
            for r, dev in enumerate(placed.mesh.devices)]


def place_opt(opt_state: dict, placed: Placed) -> List[dict]:
    """AdamW's state per rank: ``m`` and ``v`` laid out as the
    parameters, ``step`` copied to every rank."""
    m, v = place_like(opt_state["m"], placed), place_like(opt_state["v"],
                                                           placed)
    return [{"m": m[r], "v": v[r],
             "step": opt_state["step"].to(dev, copy=True)}
            for r, dev in enumerate(placed.mesh.devices)]


def gather_like(shards: Sequence[Dict[str, torch.Tensor]], placed: Placed,
                name: str, device) -> torch.Tensor:
    """The global tensor of per-rank ``shards[r][name]`` laid out as
    ``placed``'s parameter ``name``."""
    first = shards[0][name]
    out = torch.empty(placed.shapes[name], dtype=first.dtype, device=device)
    for b, r in placed.owners(name).items():
        out[tuple(slice(s, e) for s, e in b)] = shards[r][name].to(device)
    return out


@torch.no_grad()
def gather_state(placed: Placed, opt: List[dict], params: nn.Module,
                 opt_state: dict) -> None:
    """Copy the placed parameters and AdamW state back into the unplaced
    ``params`` and ``opt_state`` (in place)."""
    for name, p in params.named_parameters():
        p.copy_(gather_like(placed.shards, placed, name, p.device))
        for key in ("m", "v"):
            dst = opt_state[key][name]
            dst.copy_(gather_like([o[key] for o in opt], placed, name,
                                  dst.device))
    opt_state["step"].copy_(opt[0]["step"])


def place_batch(batch: Dict[str, Any], mesh: Mesh
                ) -> Tuple[List[Dict[str, torch.Tensor]], bool]:
    """Per-rank shards of a global batch by ``train_batch_specs`` (the
    batch dimension over the data-parallel axes when they divide it, else
    whole on every rank); returns (the shards, whether it is split)."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()
             if v is not None}
    lead = next(k for k in ("tokens", "embeds", "labels") if k in batch)
    b = _bspec(mesh, batch[lead].shape[0])
    out = [{k: collectives.shard(v, batch_spec(k, v.dim(), b), mesh, r, dev)
            for k, v in batch.items()}
           for r, dev in enumerate(mesh.devices)]
    return out, b is not None


def _canonical(mesh: Mesh, sharded: bool) -> List[int]:
    """The ranks whose outputs make up the global result: model index 0
    on each data-parallel rank when the batch is split, else rank 0."""
    if not sharded:
        return [0]
    dp = dp_axes(mesh)
    return [r for r in range(mesh.size)
            if all(c == 0 for a, c in pspec.coords(mesh, r).items()
                   if a not in dp)]


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #


def loss_and_grads(placed: Placed, batch: Dict[str, Any], cfg: ModelConfig
                   ) -> Tuple[Dict[str, torch.Tensor],
                              List[Dict[str, torch.Tensor]]]:
    """``loss_fn`` over the placed model on the global batch: (its metrics
    on the first rank's device, each rank's gradient of the total by
    parameter name, laid out as its shards; every replica of a shard gets
    the same bits)."""
    mesh = placed.mesh
    shards, sharded = place_batch(batch, mesh)
    leaves = [{k: t.detach().requires_grad_() for k, t in s.items()}
              for s in placed.shards]

    def rank_loss(r: int, b: Dict[str, torch.Tensor]):
        logits, aux = tf.apply(placed.view(r, leaves[r]), b, cfg)
        s, c = tf.ce_terms(logits, b["labels"])
        return s, c, aux

    with torch.enable_grad():
        outs = collectives.spmd(mesh, rank_loss,
                                [(r, shards[r]) for r in range(mesh.size)],
                                batch_sharded=sharded)
        dev0 = mesh.devices[0]
        canon = _canonical(mesh, sharded)
        s = collectives._fixed_sum([outs[r][0].to(dev0) for r in canon])
        c = collectives._fixed_sum([outs[r][1].to(dev0) for r in canon])
        ce = s / torch.clamp(c, min=1.0)
        aux = outs[0][2].to(dev0)
        total = ce + 0.01 * aux
        names = list(placed.shapes)
        flat = [leaves[r][k] for r in range(mesh.size) for k in names]
        grads = torch.autograd.grad(total, flat, allow_unused=True)
    # a parameter the loss does not reach gets zeros, as in the reference
    grads = [torch.zeros_like(x) if gr is None else gr
             for x, gr in zip(flat, grads)]
    per_rank = [dict(zip(names, grads[r * len(names):(r + 1) * len(names)]))
                for r in range(mesh.size)]
    metrics = {"loss": total.detach(), "ce": ce.detach(),
               "aux": aux.detach()}
    return metrics, per_rank


def unplaced_loss_and_grads(params: nn.Module, batch: Dict[str, Any],
                            cfg: ModelConfig, mesh: Mesh
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The unplaced model's counterpart of ``loss_and_grads``: where the
    MoE is expert-parallel over several data-parallel ranks, its capacity
    is per data shard, so each data shard's batch runs on its own and the
    terms combine as the placed step combines them. Returns (the loss,
    the gradient by parameter name)."""
    named = dict(params.named_parameters())
    b = _bspec(mesh, len(batch["labels"]))
    n = pspec.dp_size(mesh) if b is not None and pspec.moe_ep(
        cfg, mesh, True) else 1
    per = len(batch["labels"]) // n
    dev = next(iter(named.values())).device
    with torch.enable_grad():
        terms = []
        for i in range(n):
            sl = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            sl = {k: v[:, i * per:(i + 1) * per] if k == "positions_3d"
                  else v[i * per:(i + 1) * per] for k, v in sl.items()}
            logits, aux = tf.apply(params, sl, cfg)
            terms.append((*tf.ce_terms(logits, sl["labels"]), aux))
        s = collectives._fixed_sum([t[0] for t in terms])
        c = collectives._fixed_sum([t[1] for t in terms])
        aux = collectives._fixed_sum([t[2] for t in terms]) / n
        total = s / torch.clamp(c, min=1.0) + 0.01 * aux
        grads = torch.autograd.grad(total, list(named.values()),
                                    allow_unused=True)
    return total.detach(), {k: torch.zeros_like(p) if g is None else g
                            for (k, p), g in zip(named.items(), grads)}


def global_norm(placed: Placed, grads: List[Dict[str, torch.Tensor]]
                ) -> torch.Tensor:
    """The gradient's global norm: each distinct block once, in parameter
    order, on the first rank's device."""
    dev0 = placed.mesh.devices[0]
    sq = [torch.sum(grads[r][k].to(dev0, torch.float32) ** 2)
          for k in placed.shapes for r in placed.owners(k).values()]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def train_step(placed: Placed, opt: List[dict], batch: Dict[str, Any],
               cfg: ModelConfig, optc: AdamWConfig
               ) -> Tuple[Placed, List[dict], Dict[str, torch.Tensor]]:
    """One step of ``loss_fn`` + AdamW over the placed model, in place:
    (placed, opt, metrics on the first rank's device). Every rank updates
    its own shards with the one global gradient norm."""
    metrics, grads = loss_and_grads(placed, batch, cfg)
    gnorm = global_norm(placed, grads)
    for r, dev in enumerate(placed.mesh.devices):
        _, _, om = adamw_update(optc, placed.shards[r], grads[r], opt[r],
                                gnorm=gnorm.to(dev))
    metrics.update(grad_norm=gnorm, lr=om["lr"].to(placed.mesh.devices[0]))
    return placed, opt, metrics


# --------------------------------------------------------------------------- #
# serving: prefill and decode with placed caches
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class PlacedCaches:
    """Decode caches over a mesh: ``shards[r]`` in the port's layout
    (``transformer.init_caches``), each leaf laid out by ``cache_specs``
    (``specs``, the same tree of per-layer specs) over ``shapes``."""
    mesh: Mesh
    batch: int
    s_cache: int
    specs: Any
    shapes: Any
    shards: List[Any]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [_tree_map(fn, *(t[i] for t in trees))
                for i in range(len(first))]
    return fn(*trees)


def _leaf_names(tree):
    """The same tree with each leaf replaced by its key (k, v, pos, ssm,
    conv)."""
    if isinstance(tree, dict):
        return {k: _leaf_names(v) if isinstance(v, (dict, list)) else k
                for k, v in tree.items()}
    return [_leaf_names(v) for v in tree]


def cache_layout(cfg: ModelConfig, mesh: Mesh, batch: int, s_cache: int
                 ) -> Tuple[Any, Any]:
    """(the per-layer storage specs by ``cache_specs``, the global shapes)
    of a batch's caches, as trees in the port's layout."""
    shapes = _tree_map(lambda t: tuple(t.shape),
                       tf.init_caches(cfg, batch, s_cache, "meta"))

    def spec(name, shape):
        one = {name: torch.empty((1,) + shape, device="meta")}
        return cache_specs(cfg, mesh, batch, one)[name][1:]

    return _tree_map(spec, _leaf_names(shapes), shapes), shapes


def compute_layout(cfg: ModelConfig, mesh: Mesh, shapes, batch: int,
                   sharded: bool):
    """The specs a rank's step keeps the caches in: its batch shard (when
    the batch is split) and, under the ``heads`` layout, its key/value
    heads (whole under ``q_heads`` and ``sequence``)."""
    b = _bspec(mesh, batch) if sharded else None

    def spec(name, shape):
        if name in ("k", "v") and pspec.attn_layout(cfg, mesh) == "heads":
            return (b, None, "model", None)
        return (b,) + (None,) * (len(shape) - 1)

    return _tree_map(spec, _leaf_names(shapes), shapes)


def reshard_caches(tree: Any, shapes, src, dst) -> Any:
    """This rank's cache tree from the layout of spec tree ``src`` to
    ``dst``: a collective (``collectives.reshard``) per leaf whose specs
    differ, the leaf itself elsewhere."""
    return _tree_map(lambda x, shape, s, d: x if s == d else
                     collectives.reshard(x, shape, s, d, "cache"),
                     tree, shapes, src, dst)


def serve_rank(run, view, b: Dict[str, torch.Tensor], caches: Any, shapes,
               specs, compute) -> Tuple[torch.Tensor, Any]:
    """One rank's serving step: its ``caches`` (None for a prefill) from
    the storage specs to the ``compute`` specs, ``run(view, b, caches)``,
    and the caches it returns back to the storage specs."""
    if caches is not None:
        caches = reshard_caches(caches, shapes, specs, compute)
    logits, caches = run(view, b, caches)
    return logits, reshard_caches(caches, shapes, compute, specs)


def _reshard_tree(shards: List[Any], shapes, src, dst, mesh: Mesh
                  ) -> List[Any]:
    """Per-rank cache trees from the layout of spec tree ``src`` to
    ``dst``; leaves whose specs agree are passed through."""
    def leaf(shape, s, d, *xs):
        if s == d:
            return tuple(xs)
        return tuple(collectives.reshard_shards(xs, shape, s, d, mesh))

    per_leaf = _tree_map(leaf, shapes, src, dst, *shards)
    return [_tree_map(lambda v, r=r: v[r], per_leaf)
            for r in range(mesh.size)]


def place_caches(caches: Any, cfg: ModelConfig, mesh: Mesh, batch: int,
                 s_cache: int) -> PlacedCaches:
    """Per-rank shards of global caches (``transformer.init_caches(cfg,
    batch, s_cache)``'s layout) by ``cache_specs``."""
    specs, shapes = cache_layout(cfg, mesh, batch, s_cache)
    shards = [_tree_map(lambda x, sp, r=r, dev=dev:
                        collectives.shard(x, sp, mesh, r, dev), caches, specs)
              for r, dev in enumerate(mesh.devices)]
    return PlacedCaches(mesh, batch, s_cache, specs, shapes, shards)


def gather_caches(pc: PlacedCaches, device=None) -> Any:
    """The global caches from their shards, on ``device``."""
    full = _tree_map(lambda s: (None,) * len(s), pc.shapes)
    whole = _reshard_tree(pc.shards, pc.shapes, pc.specs, full, pc.mesh)
    return _tree_map(lambda x: x.to(device or pc.mesh.devices[0]), whole[0])


def _serve(placed: Placed, batch: Dict[str, Any], pc: Optional[PlacedCaches],
           run, s_cache: int) -> Tuple[torch.Tensor, PlacedCaches]:
    cfg, mesh = placed.cfg, placed.mesh
    shards, sharded = place_batch(batch, mesh)
    B = next(iter(v for v in batch.values() if v is not None)).shape[0]
    specs, shapes = cache_layout(cfg, mesh, B, s_cache)
    compute = compute_layout(cfg, mesh, shapes, B, sharded)
    outs = collectives.spmd(
        mesh, lambda r: serve_rank(
            run, placed.view(r), shards[r],
            None if pc is None else pc.shards[r], shapes, specs, compute),
        [(r,) for r in range(mesh.size)], batch_sharded=sharded)
    logits = torch.cat([outs[r][0].to(mesh.devices[0])
                        for r in _canonical(mesh, sharded)])
    return logits, PlacedCaches(mesh, B, s_cache, specs, shapes,
                                [o[1] for o in outs])


def prefill(placed: Placed, batch: Dict[str, Any], s_cache: int
            ) -> Tuple[torch.Tensor, PlacedCaches]:
    """``transformer.prefill`` over the placed model: (the global batch's
    last-position logits [B, V] on the first rank's device, the caches
    placed by ``cache_specs``)."""
    cfg = placed.cfg

    def run(view, b, _):
        return tf.prefill(view, b, cfg, s_cache)

    with torch.no_grad():
        return _serve(placed, batch, None, run, s_cache)


def decode_step(placed: Placed, pc: PlacedCaches,
                tokens: Optional[torch.Tensor], positions: torch.Tensor,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, PlacedCaches]:
    """``transformer.decode_step`` over the placed model and caches:
    (logits [B, V] on the first rank's device, the new caches)."""
    cfg = placed.cfg

    def run(view, b, caches):
        return tf.decode_step(view, caches, b.get("tokens"), b["positions"],
                              cfg, embeds=b.get("embeds"))

    batch = {"tokens": tokens, "positions": positions, "embeds": embeds}
    with torch.no_grad():
        return _serve(placed, batch, pc, run, pc.s_cache)
