"""Carry LM weights between the reference's parameter tree and the port.

The reference keeps a pytree of arrays: ``embed``, ``final_norm``,
optional ``lm_head``, and ``blocks`` whose leaves are stacked ``[n, ...]``
over layers — or, under local_global, two stacks ``a`` (the local layer of
each pair) and ``b`` (the global one). The port keeps one module per layer
in layer order. ``from_reference`` unstacks (pair i → layers 2i, 2i+1) and
``to_reference`` stacks back; both take and give numpy arrays, so a round
trip keeps every byte.
"""
from __future__ import annotations

from typing import Any, Dict, List

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


def _layer_leaves(blocks: Tree, cfg: ModelConfig) -> List[Dict[str, np.ndarray]]:
    """The reference's stacked block leaves as one flat dict per layer, in
    layer order."""
    if cfg.attn_pattern == "local_global":
        a, b = _flatten(blocks["a"]), _flatten(blocks["b"])
        layers = []
        for i in range(cfg.num_layers // 2):
            layers.append({k: v[i] for k, v in a.items()})
            layers.append({k: v[i] for k, v in b.items()})
        return layers
    flat = _flatten(blocks)
    return [{k: v[i] for k, v in flat.items()}
            for i in range(cfg.num_layers)]


def from_reference(tree: Tree, cfg: ModelConfig, device="cpu"
                   ) -> Transformer:
    """The reference's parameter tree (arrays as numpy) → the port's
    ``Transformer`` on ``device``."""
    state = {"embed": tree["embed"],
             "final_norm.scale": tree["final_norm"]["scale"]}
    if "lm_head" in tree:
        state["lm_head"] = tree["lm_head"]
    for i, leaves in enumerate(_layer_leaves(tree["blocks"], cfg)):
        state.update({f"blocks.{i}.{k}": v for k, v in leaves.items()})
    model = init_params(cfg, torch.Generator(device).manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    return model


def to_reference(params: Transformer, cfg: ModelConfig) -> Tree:
    """The port's ``Transformer`` → the reference's parameter tree of numpy
    arrays (layers stacked back, local_global split into ``a``/``b``)."""
    sd = {k: v.detach().cpu().numpy() for k, v in params.state_dict().items()}
    tree: Tree = {"embed": sd["embed"],
                  "final_norm": {"scale": sd["final_norm.scale"]}}
    if "lm_head" in sd:
        tree["lm_head"] = sd["lm_head"]
    layers = [{k.split(".", 2)[2]: v for k, v in sd.items()
               if k.startswith(f"blocks.{i}.")}
              for i in range(cfg.num_layers)]

    def stack(group):
        return _unflatten({k: np.stack([layer[k] for layer in group])
                           for k in group[0]})

    if cfg.attn_pattern == "local_global":
        tree["blocks"] = {"a": stack(layers[0::2]), "b": stack(layers[1::2])}
    else:
        tree["blocks"] = stack(layers)
    return tree
