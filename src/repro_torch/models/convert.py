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
``reference_tree`` and ``port_leaves`` carry any per-parameter leaves
(gradients, optimizer moments) the same way, and ``bind`` makes a model's
parameters views of a tree in the reference's layout: the training state
is checkpointed in that layout (``train.step.train_state``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, init_params

Tree = Dict[str, Any]


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """Dotted names → leaves; tensors stay tensors, anything else becomes
    a numpy array."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val if isinstance(val, torch.Tensor) \
                else np.asarray(val)
    return out


def _unflatten(flat: Dict[str, Any]) -> Tree:
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


def _plan(names: Sequence[str], cfg: ModelConfig
          ) -> List[Tuple[str, Tuple[int, ...], List[str]]]:
    """Each leaf of the reference's tree: (its dotted path, its leading
    layer axes, the port's names of the leaves it stacks, row-major)."""
    out, taken = [], set()
    for path, axes, prefixes in _stacks(cfg):
        head = prefixes[0] + "."
        for key in names:
            if key.startswith(head):
                rest = key[len(head):]
                members = [f"{prefix}.{rest}" for prefix in prefixes]
                out.append((f"{path}.{rest}", axes, members))
                taken.update(members)
    return out + [(k, (), [k]) for k in names if k not in taken]


def _stack(parts: List[Any], axes: Tuple[int, ...]) -> Any:
    if not axes:
        return parts[0]
    stack = torch.stack if isinstance(parts[0], torch.Tensor) else np.stack
    return stack(parts).reshape(axes + tuple(parts[0].shape))


def reference_leaves(leaves: Mapping[str, Any], cfg: ModelConfig
                     ) -> Dict[str, Any]:
    """The port's leaves by parameter name (tensors or numpy arrays: a
    model's parameters, their gradients, AdamW's ``m`` or ``v``) → the
    reference's leaves by dotted path, the layers stacked along their
    leading axes (a copy)."""
    return {path: _stack([leaves[m] for m in members], axes)
            for path, axes, members in _plan(list(leaves), cfg)}


def reference_tree(leaves: Mapping[str, Any], cfg: ModelConfig) -> Tree:
    """``reference_leaves`` as the reference's nested tree."""
    return _unflatten(reference_leaves(leaves, cfg))


def port_leaves(tree: Tree, cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's tree (nested, or flat by dotted path) → the port's
    leaves by parameter name, each one layer of its stack (a view, for
    tensors)."""
    tree = _unflatten(tree)
    state = _flatten({k: v for k, v in tree.items()
                      if k not in ("blocks", "shared")})
    for path, axes, prefixes in _stacks(cfg):
        node = tree
        for key in path.split("."):
            node = node[key]
        for name, val in _flatten(node).items():
            flat = val.reshape((-1,) + tuple(val.shape[len(axes):]))
            state.update({f"{prefix}.{name}": flat[i]
                          for i, prefix in enumerate(prefixes)})
    return state


def from_reference(tree: Tree, cfg: ModelConfig, device="cpu"
                   ) -> Transformer:
    """The reference's parameter tree (arrays as numpy) → the port's
    ``Transformer`` on ``device``."""
    model = init_params(cfg, torch.Generator(device).manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in port_leaves(tree, cfg).items()},
                          strict=True)
    return model


def to_reference(params: Transformer, cfg: ModelConfig) -> Tree:
    """The port's ``Transformer`` → the reference's parameter tree of numpy
    arrays (the layers stacked back along their leading axes)."""
    return reference_tree({k: v.detach().cpu().numpy()
                           for k, v in params.state_dict().items()}, cfg)


def bind(params: Transformer, tree: Tree, cfg: ModelConfig) -> Transformer:
    """Make each of ``params``' parameters a view of its layer in ``tree``
    (the reference's layout, tensors): an in-place update of the model
    then updates the tree, with no copy between the two layouts. The
    model may be one built on the ``meta`` device."""
    for name, view in port_leaves(tree, cfg).items():
        _set_parameter(params, name, view)
    return params


def _set_parameter(params: Transformer, name: str, value: torch.Tensor):
    owner, _, attr = name.rpartition(".")
    setattr(params.get_submodule(owner), attr, nn.Parameter(value))


def stack_in_place(params: Transformer,
                   moments: Sequence[Dict[str, torch.Tensor]],
                   cfg: ModelConfig) -> Tuple[Tree, List[Tree]]:
    """Move ``params`` and each dict of per-parameter ``moments`` (AdamW's
    ``m`` and ``v``) into the reference's layout on their own device: each
    leaf is stacked once, and the model's parameter and the dicts' entries
    become views of the stack, so the peak grows by one stack, not by a
    copy of the model. Returns (the parameter tree, one tree per dict)."""
    named = dict(params.named_parameters())
    flats: List[Dict[str, torch.Tensor]] = [{} for _ in range(len(moments)
                                                              + 1)]
    for path, axes, members in _plan(list(named), cfg):
        for flat, src in zip(flats, [named, *moments]):
            stacked = _stack([src[k].detach() for k in members], axes)
            flat[path] = stacked
            layers = stacked.reshape((-1,) + tuple(stacked.shape[len(axes):]))
            for i, k in enumerate(members):
                view = layers[i] if axes else stacked
                if src is named:
                    _set_parameter(params, k, view)
                # the old leaf is freed once nothing holds it
                src[k] = view
    trees = [_unflatten(f) for f in flats]
    return trees[0], trees[1:]


def reference_caches(caches: Any, cfg: ModelConfig) -> Tree:
    """The port's decode caches (``transformer.init_caches``: one dict per
    layer) → the reference's layout, each leaf stacked over its layers:
    ``{k, v, pos}`` [L, ...] (under local_global ``a`` and ``b``), ``{ssm,
    conv}`` [L, ...], or the hybrid's ``{"mamba": {ssm, conv} [G, period,
    ...], "shared": {k, v, pos} [G, ...]}``. A copy (none on ``meta``)."""
    def stacked(layers):
        return {k: torch.stack([c[k] for c in layers]) for k in layers[0]}

    if cfg.family == "hybrid":
        return {"mamba": stacked([stacked(g) for g in caches["mamba"]]),
                "shared": stacked(caches["shared"])}
    if cfg.family != "ssm" and cfg.attn_pattern == "local_global":
        return {"a": stacked(caches[0::2]), "b": stacked(caches[1::2])}
    return stacked(caches)
