"""Carry LM weights between the reference's parameter tree and the port.

The reference keeps a pytree of arrays: ``embed``, ``final_norm``,
optional ``lm_head``, and stacks whose leaves carry leading layer axes:

  dense / moe / ssm : ``blocks`` [L, ...] (MoE leaves [L, E_pad, ...]);
                      under local_global two stacks, ``a`` (the local layer
                      of each pair) and ``b`` (the global one), [L/2, ...]
  hybrid            : ``blocks`` [n_groups, hybrid_period, ...] and
                      ``shared`` [num_shared_blocks, ...]

The port keeps one module per layer (``blocks.{i}``, ``blocks.{g}.{j}``,
``shared.{s}``). ``from_reference`` unstacks and ``to_reference`` stacks
back; both take and give numpy arrays, so a round trip keeps every byte.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, init_params

Tree = Dict[str, Any]


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Tree:
    tree: Tree = {}
    for name, val in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _stacks(cfg: ModelConfig
            ) -> List[Tuple[str, Tuple[int, ...], List[str]]]:
    """Each stack of the reference's tree: (its path, its leading layer
    axes, the port's module prefix of each index in row-major order)."""
    if cfg.family == "hybrid":
        n_groups, per = cfg.num_layers // cfg.hybrid_period, cfg.hybrid_period
        return [("blocks", (n_groups, per),
                 [f"blocks.{g}.{j}" for g in range(n_groups)
                  for j in range(per)]),
                ("shared", (cfg.num_shared_blocks,),
                 [f"shared.{s}" for s in range(cfg.num_shared_blocks)])]
    if cfg.attn_pattern == "local_global":
        half = cfg.num_layers // 2
        return [("blocks.a", (half,),
                 [f"blocks.{2 * i}" for i in range(half)]),
                ("blocks.b", (half,),
                 [f"blocks.{2 * i + 1}" for i in range(half)])]
    return [("blocks", (cfg.num_layers,),
             [f"blocks.{i}" for i in range(cfg.num_layers)])]


def from_reference(tree: Tree, cfg: ModelConfig, device="cpu"
                   ) -> Transformer:
    """The reference's parameter tree (arrays as numpy) → the port's
    ``Transformer`` on ``device``."""
    state = _flatten({k: v for k, v in tree.items()
                      if k not in ("blocks", "shared")})
    for path, axes, prefixes in _stacks(cfg):
        node = tree
        for key in path.split("."):
            node = node[key]
        for name, val in _flatten(node).items():
            flat = val.reshape((-1,) + val.shape[len(axes):])
            state.update({f"{prefix}.{name}": flat[i]
                          for i, prefix in enumerate(prefixes)})
    model = init_params(cfg, torch.Generator(device).manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    return model


def to_reference(params: Transformer, cfg: ModelConfig) -> Tree:
    """The port's ``Transformer`` → the reference's parameter tree of numpy
    arrays (the layers stacked back along their leading axes)."""
    sd = {k: v.detach().cpu().numpy() for k, v in params.state_dict().items()}
    flat = {}
    stacked = set()
    for path, axes, prefixes in _stacks(cfg):
        head = prefixes[0] + "."
        for key in (k for k in sd if k.startswith(head)):
            name = key[len(head):]
            parts = [sd[f"{prefix}.{name}"] for prefix in prefixes]
            flat[f"{path}.{name}"] = np.stack(parts).reshape(
                axes + parts[0].shape)
            stacked.update(f"{prefix}.{name}" for prefix in prefixes)
    flat.update({k: v for k, v in sd.items() if k not in stacked})
    return _unflatten(flat)
