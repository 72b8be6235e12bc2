"""AdamW with the reference's formula (the port of ``repro.optim.adamw``).

Clip by global norm, linear warmup then cosine decay to ``min_lr_ratio``,
bias-corrected moments, and the update ``mhat / (sqrt(vhat) + eps) + wd *
p``; ``m`` and ``v`` are kept in the parameter dtype. ``torch.optim.AdamW``
places ``eps``, clips and schedules differently, so it is not used.

A tree here is a flat mapping of names to tensors, or an ``nn.Module``
(its ``named_parameters()``). ``adamw_update`` writes the new parameters,
``m`` and ``v`` into the tensors it is given, leaf by leaf and in slices
of ``_SLICE`` elements, under ``torch.no_grad()``: the values are the
functional formula's, and no second copy of the parameters is needed
(gemma2-2b's f32 masters, gradients, ``m`` and ``v`` alone take 42 GB).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

Tree = Union[Mapping[str, torch.Tensor], nn.Module]

_SLICE = 1 << 24  # elements per elementwise pass (bounds the temporaries)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named(tree: Tree) -> Dict[str, torch.Tensor]:
    """The tree's leaves by name, in its own order."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def adamw_init(params: Tree) -> dict:
    """Zero ``m`` and ``v`` beside each parameter, and ``step`` = 0 (int32,
    on the parameters' device)."""
    leaves = named(params)
    dev = next(iter(leaves.values())).device
    return {"m": {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                  for k, p in leaves.items()},
            "v": {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                  for k, p in leaves.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio (float32)."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    leaves = [torch.sum(g.to(torch.float32) ** 2)
              for g in named(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree, state: dict,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Tree, dict, dict]:
    """One step, in place: ``params``, ``state["m"]``, ``state["v"]`` and
    ``state["step"]`` take the new values. ``gnorm`` is the global
    gradient norm when the caller holds only shards of the tree (a placed
    step); by default ``global_norm(grads)``. Returns (params, state,
    {"grad_norm", "lr"})."""
    p_tree, g_tree = named(params), named(grads)
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(g_tree)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    for name, p in p_tree.items():
        m, v, g = state["m"][name], state["v"][name], g_tree[name]
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError(f"{name}: parameters and moments must be "
                             "contiguous to be updated in place")
        pf, mf, vf = p.view(-1), m.view(-1), v.view(-1)
        gf = g.reshape(-1)
        for a in range(0, pf.numel(), _SLICE):
            sl = slice(a, a + _SLICE)
            gs = gf[sl].to(torch.float32) * scale
            m32 = b1 * mf[sl].to(torch.float32) + (1 - b1) * gs
            v32 = b2 * vf[sl].to(torch.float32) + (1 - b2) * gs * gs
            mhat = m32 / bc1
            vhat = v32 / bc2
            p32 = pf[sl].to(torch.float32)
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
                + cfg.weight_decay * p32
            pf[sl] = (p32 - lr * delta).to(p.dtype)
            mf[sl] = m32.to(m.dtype)
            vf[sl] = v32.to(v.dtype)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
