"""Meta-device stand-ins for every (arch x shape x mesh) dry-run cell (the
port of ``repro.launch.specs``).

No memory anywhere. A cell holds one rank's shards of the parameters,
AdamW's state, the batch and the decode caches on the ``meta`` device,
each of the shape the sharding specs give that rank on the mesh
(``models.placement``'s layouts), and a ``step`` that runs the rank's
program of the cell's step alone (``collectives.solo``): the reference
lowers its partitioned per-device module; every rank runs the same
shapes. ``launch.dryrun`` walks ``step`` with ``roofline.op_walk``.

Train cells run ``loss_fn``, its backward (block remat recomputes each
block, as a placed step does) and AdamW on the rank's shards (the loss's
sums and the gradient norm over the ranks are all-reduces, as
``placement.train_step`` takes them); prefill and decode cells run
``placement.serve_rank`` over ``transformer.prefill`` / ``decode_step``:
a decode step reshards its caches from their storage layout
(``cache_specs``) to the layout it computes in and back, a prefill
reshards the caches it writes to storage, as a placed rank does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import get_config, long_context_ok
from repro_torch.launch.mesh import Mesh
from repro_torch.models import collectives, placement
from repro_torch.models import transformer as tf
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.sharding import _bspec
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def params_struct(cfg: ModelConfig, mesh: Mesh, rank: int = 0
                  ) -> placement.Placed:
    """Rank ``rank``'s parameter shards on ``meta`` (``shards[0]``)."""
    model = tf.init_params(cfg, None)
    specs, shapes, mine = {}, {}, {}
    for name, p in model.named_parameters():
        shapes[name] = tuple(p.shape)
        specs[name] = placement.param_spec(name, p.shape, cfg, mesh)
        block = collectives.block(specs[name], p.shape, mesh, rank)
        mine[name] = _meta([e - s for s, e in block], p.dtype)
    return placement.Placed(cfg, mesh, specs, shapes, [mine])


def batch_struct(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig,
                 labels: bool) -> Dict[str, torch.Tensor]:
    """A rank's shard of the global batch by ``train_batch_specs``."""
    b = _bspec(mesh, shape.global_batch)
    B = collectives.shard_shape((b,), (shape.global_batch,), mesh)[0]
    L = shape.seq_len
    out = {}
    if cfg.external_embeddings:
        out["embeds"] = _meta((B, L, cfg.d_model), cfg.compute_dtype)
    else:
        out["tokens"] = _meta((B, L), torch.int32)
    if labels:
        out["labels"] = _meta((B, L), torch.int32)
    return out


def cache_struct(cfg: ModelConfig, mesh: Mesh, batch: int, s_cache: int):
    """(a rank's cache shards by ``cache_specs``, and the storage specs,
    global shapes and compute specs that ``placement.serve_rank`` takes)."""
    specs, shapes = placement.cache_layout(cfg, mesh, batch, s_cache)
    stored = placement._tree_map(
        lambda x, sp: _meta(collectives.shard_shape(sp, x.shape, mesh),
                            x.dtype),
        tf.init_caches(cfg, batch, s_cache, "meta"), specs)
    compute = placement.compute_layout(cfg, mesh, shapes, batch,
                                       _bspec(mesh, batch) is not None)
    return stored, (shapes, specs, compute)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    mesh: Mesh
    step: Optional[Callable[[], Any]] = None
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)
    skip_reason: str = ""


def _train_step(cfg: ModelConfig, optc: AdamWConfig, placed, opt, batch,
                mesh: Mesh):
    """Rank 0's share of ``placement.train_step``."""
    leaves = {k: t.requires_grad_() for k, t in placed.shards[0].items()}
    dp = placement.dp_axes(mesh)
    with torch.enable_grad():
        logits, aux = tf.apply(placed.view(0, leaves), batch, cfg)
        s, c = tf.ce_terms(logits, batch["labels"])
        s, c = collectives.psum(s, dp), collectives.psum(c, dp)
        total = s / torch.clamp(c, min=1.0) + 0.01 * aux
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(x) if g is None else g
             for (k, x), g in zip(leaves.items(), grads)}
    sq = torch.sum(torch.stack([torch.sum(g.float() ** 2)
                                for g in grads.values()]))
    gnorm = torch.sqrt(collectives.psum(sq, mesh.axis_names))
    return adamw_update(optc, placed.shards[0], grads, opt, gnorm=gnorm)


def build_cell(arch: str, shape_name: str, mesh: Mesh,
               optc: Optional[AdamWConfig] = None) -> Cell:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    optc = optc or AdamWConfig()
    cell = Cell(arch, shape, cfg, mesh)
    if shape.name == "long_500k" and not long_context_ok(arch):
        cell.skip_reason = (
            "pure full-attention arch: 500k-context decode cache/attention "
            "has no sub-quadratic path (DESIGN.md §Arch-applicability)")
        return cell

    placed = params_struct(cfg, mesh)
    cell.memory["params"] = _nbytes(placed.shards[0])
    sharded = _bspec(mesh, shape.global_batch) is not None

    if shape.kind == "train":
        opt = adamw_init(placed.shards[0])
        batch = batch_struct(cfg, mesh, shape, labels=True)
        cell.memory.update(opt=_nbytes(opt), batch=_nbytes(batch))
        cell.step = lambda: collectives.solo(
            mesh, _train_step, cfg, optc, placed, opt, batch, mesh,
            batch_sharded=sharded)
        return cell

    caches, layout = cache_struct(cfg, mesh, shape.global_batch,
                                  shape.seq_len)
    if shape.kind == "prefill":
        batch = batch_struct(cfg, mesh, shape, labels=False)
        cell.memory.update(batch=_nbytes(batch), caches=_nbytes(caches))
        cell.step = lambda: collectives.solo(
            mesh, placement.serve_rank,
            lambda view, b, _: tf.prefill(view, b, cfg, shape.seq_len),
            placed.view(0), batch, None, *layout, batch_sharded=sharded)
        return cell

    # decode: one new token against a seq_len-deep cache
    one = dataclasses.replace(shape, seq_len=1)
    batch = batch_struct(cfg, mesh, one, labels=False)
    B = next(iter(batch.values())).shape[0]
    batch["positions"] = _meta((B, 1), torch.int32)
    cell.memory.update(batch=_nbytes(batch), caches=_nbytes(caches))
    cell.step = lambda: collectives.solo(
        mesh, placement.serve_rank,
        lambda view, b, c: tf.decode_step(view, c, b.get("tokens"),
                                          b["positions"], cfg,
                                          embeds=b.get("embeds")),
        placed.view(0), batch, caches, *layout, batch_sharded=sharded)
    return cell
