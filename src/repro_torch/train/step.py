"""Train and serve step builders (the port of ``repro.train.step``).

``make_train_step`` takes gradients by autograd over ``loss_fn`` and
applies one AdamW update in place. ``make_compressed_train_step`` is the
reference's pod-data-parallel step (a ``shard_map`` over the ``pod`` mesh
axis) over an explicit list of pod devices: one parameter replica per pod,
the global batch split into contiguous per-pod slices as ``P("pod")``
splits it, each pod's gradients reduced by ``compress.integer_psum_grads``
in the reference's layout and one AdamW update per replica, so every replica ends bit-identical.

Given a model placed over a mesh (``models.placement.Placed``), the
train, prefill and decode steps run over it: one program per rank, TP
and FSDP by the sharding rules, the MoE expert-parallel where the
reference's condition holds (``models.placement``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.models import convert, placement
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import compress
from repro_torch.optim.adamw import AdamWConfig, adamw_update

Batch = Dict[str, Any]  # "tokens" / "labels": tensors or numpy arrays


def _on(batch: Batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(params: tf.Transformer, batch: Batch, cfg: ModelConfig
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """(loss_fn's metrics, the gradient of its total by parameter name; a
    parameter the loss does not reach gets zeros, as in the reference)."""
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    with torch.enable_grad():
        total, metrics = tf.loss_fn(params, _on(batch, dev), cfg)
        grads = torch.autograd.grad(total, list(named.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named.items(), grads)}
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, optc: AdamWConfig):
    """(params, opt_state, batch) → (params, opt_state, metrics); params and
    opt_state are updated in place and returned. A placed model takes
    ``placement.place_opt``'s per-rank state and the global batch."""

    def train_step(params: tf.Transformer, opt_state: dict, batch: Batch):
        if isinstance(params, placement.Placed):
            return placement.train_step(params, opt_state, batch, cfg, optc)
        metrics, grads = loss_and_grads(params, batch, cfg)
        params, opt_state, om = adamw_update(optc, params, grads, opt_state)
        return params, opt_state, {**metrics, **om}

    return train_step


def make_compressed_train_step(cfg: ModelConfig, optc: AdamWConfig,
                               devices: Sequence, contract: str = "Q2.13",
                               error_feedback: bool = True):
    """Pod-DP train step with a deterministic integer gradient all-reduce.

    The step takes (params, opt_states, batch): ``params[i]`` and
    ``opt_states[i]`` are pod i's replica and AdamW state on
    ``devices[i]``; ``batch`` is the global batch. The gradients are
    reduced in the reference's layout (each stacked leaf has one scale, as
    in the reference's tree), and each pod's quantization residual is
    carried in ``opt_states[i]["residual"]``, by the reference's dotted
    leaf paths. As in the reference, a residual that opt_state holds is
    carried; with ``error_feedback`` and none there, the first step starts
    one at zeros (the reference's flag has no effect, so it carries none
    unless the caller seeds it). Returns (params, opt_states, the metrics
    averaged over pods)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def step(params: List[tf.Transformer], opt_states: List[dict],
             batch: Batch):
        b = len(batch["tokens"])
        if b % n:
            raise ValueError(f"global batch {b} does not split over {n} "
                             "pods")
        per = b // n
        grads, metrics = [], []
        for i, dev in enumerate(devices):
            sl = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            m, g = loss_and_grads(params[i], _on(sl, dev), cfg)
            # the reference reduces its tree: one scale per stacked leaf
            grads.append(convert.reference_leaves(g, cfg))
            metrics.append(m)
            del g
        residuals = [o.get("residual") for o in opt_states]
        if residuals[0] is None:
            residuals = [{k: torch.zeros_like(v, dtype=torch.float32)
                          for k, v in g.items()} for g in grads] \
                if error_feedback else None
        mean, new_res = compress.integer_psum_grads(grads, contract,
                                                    residuals)
        del grads
        mean = convert.port_leaves(mean, cfg)
        for i, dev in enumerate(devices):
            opt = {k: v for k, v in opt_states[i].items() if k != "residual"}
            g_i = {k: v.to(dev) for k, v in mean.items()}
            _, opt, om = adamw_update(optc, params[i], g_i, opt)
            if new_res is not None:
                opt["residual"] = new_res[i]
            opt_states[i] = opt
            metrics[i].update(om)
        out = {k: torch.stack([m[k].to(devices[0]) for m in metrics]).sum()
               / float(n) for k in metrics[0]}
        return params, opt_states, out

    return step


def train_state(params: tf.Transformer, opt_state: dict, cfg: ModelConfig
                ) -> dict:
    """The train state that checkpoints hold, ``{"params": <the
    reference's tree>, "opt": {"m", "v", "step"}}`` with ``m`` and ``v`` in
    the same layout, over the same storage as ``params`` and ``opt_state``
    (``convert.stack_in_place``): a step on them updates the state."""
    ptree, (m, v) = convert.stack_in_place(
        params, [opt_state["m"], opt_state["v"]], cfg)
    return {"params": ptree, "opt": {"m": m, "v": v,
                                     "step": opt_state["step"]}}


def bind_state(state: dict, cfg: ModelConfig
               ) -> Tuple[tf.Transformer, dict]:
    """The inverse of ``train_state``: (a model whose parameters are views
    of ``state["params"]``, AdamW's state whose ``m`` and ``v`` are views
    of ``state["opt"]``'s), for ``make_train_step``."""
    params = convert.bind(tf.init_params(cfg, None), state["params"], cfg)
    opt = state["opt"]
    return params, {"m": convert.port_leaves(opt["m"], cfg),
                    "v": convert.port_leaves(opt["v"], cfg),
                    "step": opt["step"]}


def make_prefill_step(cfg: ModelConfig, s_cache: int):
    """(params, batch) → (last-position logits, caches); over a placed
    model the logits are the global batch's and the caches are placed
    (``placement.PlacedCaches``)."""
    def prefill_step(params: tf.Transformer, batch: Batch):
        if isinstance(params, placement.Placed):
            return placement.prefill(params, batch, s_cache)
        return tf.prefill(params, batch, cfg, s_cache)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, caches, tokens, positions, embeds=None) → (logits,
    caches), placed or not as ``make_prefill_step``."""
    def decode_step(params: tf.Transformer, caches, tokens: torch.Tensor,
                    positions: torch.Tensor, embeds=None):
        if isinstance(params, placement.Placed):
            return placement.decode_step(params, caches, tokens, positions,
                                         embeds)
        return tf.decode_step(params, caches, tokens, positions, cfg,
                              embeds=embeds)
    return decode_step
