"""The LM: init / apply / prefill / decode for the token-input families
(the port of ``repro.models.transformer``).

The reference scans stacked layer params; here each stack is an
``nn.ModuleList`` in layer order and the scan is a Python loop.
``models.convert`` carries the reference's tree across. Stacks by family:

  dense / vlm / audio / moe :
                one ``DecoderBlock`` per layer. Layer i is local (sliding
                window) when ``cfg.layer_is_local(i)``: every layer under
                swa, the even layers (the reference's ``a`` of pair i/2)
                under local_global.
  ssm         : one ``MambaLayer`` per layer.
  hybrid      : ``blocks`` holds n_groups = num_layers // hybrid_period
                groups of hybrid_period ``MambaLayer``s; group g runs the
                shared ``DecoderBlock`` g % num_shared_blocks (full
                attention) before its mamba layers.

The vlm and audio families take external embeddings (``batch["embeds"]``
[B, L, D], cast to the compute dtype, neither gathered nor scaled); they
keep an ``embed`` table and an untied ``lm_head``, as the reference's
init does. Under ``rope_type="mrope"`` (qwen2-vl) the angles come from
``batch["positions_3d"]`` [3, B, L] (text positions when absent), and
decode uses text RoPE, as the reference does. ``loss_fn`` is the training
objective; under ``remat="block"`` each of the reference's scan units is
recomputed in the backward pass (``_maybe_remat``).

Under a mesh (``models.placement`` runs one thread per rank, each with
``models.pspec``'s ambient rank) the same code runs per rank on its shard
of the batch: the embedding table and the head are vocab-parallel over
``model`` (a masked lookup summed over ``model``; logits gathered over
``model``), attention takes the reference's layout over ``model``
(``layers.attention``: heads, query heads or query rows), the MLP is
column/row-parallel, and the MoE is expert-parallel (``layers.moe``).
Block remat recomputes every rank's block together
(``collectives.remat``).

Parameters are float32 masters cast to the compute dtype at every use;
norms, RoPE, the softmax, the MoE router, the SSD scan and the logits
after the head are float32. Caches follow the stack: one attention
``{k, v, pos}`` (written in place) or SSM ``{ssm, conv}`` dict per layer;
the hybrid's are ``{"mamba": [group][layer], "shared": [group]}``, one
full-length attention cache per group invocation.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks as blk
from repro_torch.models import collectives, pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.initializers import device_of, embed_init
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import rope as rope_lib
from repro_torch.models.layers import ssm as ssm_lib
from repro_torch.models.layers.norms import RMSNorm, rmsnorm

Caches = Any  # per family: see the module docstring


class Transformer(nn.Module):
    """``embed`` [padded_vocab, D], ``blocks`` (per family: see the module
    docstring), ``shared`` (hybrid: ``num_shared_blocks`` decoder blocks),
    ``final_norm`` and, untied, ``lm_head`` [D, padded_vocab]."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if cfg.family not in ("dense", "vlm", "audio", "moe", "ssm",
                              "hybrid"):
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        if cfg.attn_pattern == "local_global" and cfg.num_layers % 2:
            raise ValueError("local_global needs an even layer count")
        pd = cfg.params_dtype
        # vocab rows padded to vocab_pad_multiple; padded logits are masked
        # in _head
        self.embed = nn.Parameter(
            embed_init(generator, (cfg.padded_vocab, cfg.d_model), pd))
        if cfg.family == "ssm":
            self.blocks = nn.ModuleList(
                blk.MambaLayer(generator, cfg) for _ in range(cfg.num_layers))
        elif cfg.family == "hybrid":
            n_groups = cfg.num_layers // cfg.hybrid_period
            if n_groups * cfg.hybrid_period != cfg.num_layers:
                raise ValueError("hybrid needs num_layers to be a multiple "
                                 "of hybrid_period")
            self.blocks = nn.ModuleList(
                nn.ModuleList(blk.MambaLayer(generator, cfg)
                              for _ in range(cfg.hybrid_period))
                for _ in range(n_groups))
            self.shared = nn.ModuleList(
                blk.DecoderBlock(generator, cfg)
                for _ in range(cfg.num_shared_blocks))
        else:
            self.blocks = nn.ModuleList(
                blk.DecoderBlock(generator, cfg)
                for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, pd, device_of(generator))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                embed_init(generator, (cfg.d_model, cfg.padded_vocab), pd))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator]
                ) -> Transformer:
    """Initialize on ``generator.device`` from its state: the same seed on
    the same device gives the same weights. With None, the model is built
    on the ``meta`` device: its parameters' shapes and dtypes, no memory."""
    return Transformer(cfg, generator)


# --------------------------------------------------------------------------- #
# caches
# --------------------------------------------------------------------------- #


def init_caches(cfg: ModelConfig, batch: int, s_cache: int, device
                ) -> Caches:
    """Decode state in the stack's layout (module docstring): attention
    caches of ``s_cache`` slots, or min(window, s_cache) on sliding-window
    layers; zero SSM state and conv tails."""
    if cfg.family == "ssm":
        return [ssm_lib.init_ssm_cache(batch, cfg, device)
                for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        n_groups = cfg.num_layers // cfg.hybrid_period
        return {"mamba": [[ssm_lib.init_ssm_cache(batch, cfg, device)
                           for _ in range(cfg.hybrid_period)]
                          for _ in range(n_groups)],
                "shared": [attn_lib.init_cache(batch, s_cache, cfg, device)
                           for _ in range(n_groups)]}
    w = min(cfg.sliding_window, s_cache)
    return [attn_lib.init_cache(batch, w if cfg.layer_is_local(i) else s_cache,
                                cfg, device)
            for i in range(cfg.num_layers)]


# --------------------------------------------------------------------------- #
# trunk
# --------------------------------------------------------------------------- #


def _maybe_remat(fn, cfg: ModelConfig, mode: str):
    """Block rematerialization: under ``remat="block"`` in train mode with
    autograd recording, ``fn``'s activations are recomputed in the
    backward pass instead of kept (the reference's ``jax.checkpoint``):
    torch's checkpoint unplaced and alone (``collectives.solo``), every
    rank's block together in a ``collectives.spmd`` run
    (``collectives.remat``). The values and gradients are the same bits
    either way."""
    if not (cfg.remat == "block" and mode == "train"
            and torch.is_grad_enabled()):
        return fn
    rank = pspec.current()
    if rank is not None and isinstance(rank.rendezvous,
                                       collectives.Rendezvous):
        return collectives.remat(fn)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _run_stack(params: Transformer, h: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, mode: str, caches: Optional[Caches],
               angles: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
    """Every layer in order; returns (h, caches, the summed MoE balance
    loss: float32 zero outside the moe family). The units that
    ``_maybe_remat`` wraps are the reference's scan steps: a local+global
    pair of decoder blocks (local_global), one decoder block, one mamba
    layer, or one hybrid group with its shared block."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def cache(tree, i):
        return None if tree is None else tree[i]

    if cfg.family == "ssm":
        def mamba(h, i):
            return blk.mamba_layer(params.blocks[i], h, cfg, mode=mode,
                                   cache_slice=cache(caches, i))

        step = _maybe_remat(mamba, cfg, mode)
        new = []
        for i in range(len(params.blocks)):
            h, nc = step(h, i)
            new.append(nc)
        return h, (new if caches is not None else None), aux

    if cfg.family == "hybrid":
        c_shared = None if caches is None else caches["shared"]
        c_mamba = None if caches is None else caches["mamba"]

        def group(h, g):
            h, nc_shared, _ = blk.decoder_block(
                params.shared[g % cfg.num_shared_blocks], h, positions, cfg,
                local=False, mode=mode, cache_slice=cache(c_shared, g),
                angles=angles)
            nc_mamba = []
            for j, layer in enumerate(params.blocks[g]):
                h, nc = blk.mamba_layer(layer, h, cfg, mode=mode,
                                        cache_slice=cache(cache(c_mamba, g),
                                                          j))
                nc_mamba.append(nc)
            return h, nc_shared, nc_mamba

        step = _maybe_remat(group, cfg, mode)
        new = {"mamba": [], "shared": []}
        for g in range(len(params.blocks)):
            h, nc_shared, nc_mamba = step(h, g)
            new["shared"].append(nc_shared)
            new["mamba"].append(nc_mamba)
        return h, (new if caches is not None else None), aux

    def blocks(h, first, n):
        """Decoder blocks first .. first + n - 1; returns (h, their caches,
        their balance losses)."""
        new, auxes = [], []
        for i in range(first, first + n):
            h, nc, a = blk.decoder_block(
                params.blocks[i], h, positions, cfg,
                local=cfg.layer_is_local(i), mode=mode,
                cache_slice=cache(caches, i), angles=angles)
            new.append(nc)
            auxes.append(a)
        return h, new, auxes

    unit = 2 if cfg.attn_pattern == "local_global" else 1
    step = _maybe_remat(blocks, cfg, mode)
    new = []
    for first in range(0, len(params.blocks), unit):
        h, nc, auxes = step(h, first, unit)
        new += nc
        for a in auxes:
            aux = aux + a
    return h, (new if caches is not None else None), aux


# --------------------------------------------------------------------------- #
# public entry points
# --------------------------------------------------------------------------- #


def _embed(params: Transformer, batch: Dict[str, torch.Tensor],
           cfg: ModelConfig) -> torch.Tensor:
    if cfg.external_embeddings:
        return batch["embeds"].to(cfg.compute_dtype)
    ids = batch["tokens"].long()
    table = params.embed
    if pspec.model_divides(cfg.padded_vocab):
        # vocab-parallel lookup: this rank's rows, zeros for the others'
        # tokens, summed over model (one nonzero term: exact)
        local = ids - collectives.axis_index("model") * table.shape[0]
        mine = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(mine, local, 0)]
        h = collectives.psum(torch.where(mine[..., None], rows, 0.0),
                             "model")
    else:
        h = table[ids]
    h = h.to(cfg.compute_dtype)
    if cfg.scale_embeddings:
        # the scale is rounded to the compute dtype before the multiply
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype,
                             device=h.device)
    return pspec.constrain(h, "batch", None, None)


def _head(params: Transformer, h: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    h = rmsnorm(params.final_norm, h, cfg.rms_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bld,vd->blv", h, params.embed.to(h.dtype))
    else:
        logits = torch.einsum("bld,dv->blv", h, params.lm_head.to(h.dtype))
    logits = pspec.constrain(logits, "batch", None, "model")
    if pspec.model_divides(cfg.padded_vocab):
        logits = collectives.all_gather(logits, "model", dim=-1)
    logits = logits.to(torch.float32)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    if cfg.padded_vocab != cfg.vocab_size:
        # padded rows never win: mask to a large negative
        v = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(v[None, None, :] < cfg.vocab_size, logits,
                             -1e30)
    return logits


def _positions(B: int, L: int, device) -> torch.Tensor:
    return torch.arange(L, dtype=torch.int32, device=device)[None].expand(B, L)


def _angles_for(batch: Dict[str, torch.Tensor], positions: torch.Tensor,
                cfg: ModelConfig) -> Optional[torch.Tensor]:
    """M-RoPE's angles (rope_type "mrope"), else None (text RoPE)."""
    if cfg.rope_type != "mrope":
        return None
    pos3 = batch.get("positions_3d")
    if pos3 is None:
        pos3 = rope_lib.text_positions_3d(positions)
    return rope_lib.mrope_angles(torch.as_tensor(pos3, device=positions.device),
                                 cfg.head_dim_, cfg.rope_theta,
                                 cfg.mrope_sections)


def apply(params: Transformer, batch: Dict[str, torch.Tensor],
          cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/eval forward: (full-sequence logits [B, L, V], the MoE
    balance loss summed over layers, float32)."""
    h = _embed(params, batch, cfg)
    B, L = h.shape[0], h.shape[1]
    positions = _positions(B, L, h.device)
    h, _, aux = _run_stack(params, h, positions, cfg, "train", None,
                           _angles_for(batch, positions, cfg))
    return _head(params, h, cfg), aux


def loss_fn(params: Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (``labels`` = tokens shifted by the caller;
    ``labels < 0`` masked) + 0.01 x the MoE balance loss. Returns (total,
    {"loss": total, "ce", "aux"}), float32 scalars."""
    logits, aux = apply(params, batch, cfg)
    nll_sum, count = ce_terms(logits, batch["labels"])
    ce = nll_sum / torch.clamp(count, min=1.0)
    total = ce + 0.01 * aux
    return total, {"loss": total, "ce": ce, "aux": aux}


def ce_terms(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the summed next-token NLL over the labels >= 0, their count), in
    float32: ``loss_fn``'s cross entropy is their quotient (a placed step
    sums both over its data-parallel ranks first)."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0)
    lse = torch.logsumexp(logits, dim=-1)
    # the one logit of each label: the reference's masked sum over the
    # vocabulary adds zeros to it, so a gather gives the same value
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - picked
    return torch.sum(nll * mask), torch.sum(mask)


def prefill(params: Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, s_cache: int) -> Tuple[torch.Tensor, Caches]:
    """Process a prompt; return (last-position logits [B, V], caches)."""
    h = _embed(params, batch, cfg)
    B, L = h.shape[0], h.shape[1]
    caches = init_caches(cfg, B, s_cache, h.device)
    positions = _positions(B, L, h.device)
    h, caches, _ = _run_stack(params, h, positions, cfg, "prefill", caches,
                              _angles_for(batch, positions, cfg))
    logits = _head(params, h[:, -1:], cfg)
    return logits[:, 0], caches


def decode_step(params: Transformer, caches: Caches,
                tokens: Optional[torch.Tensor], positions: torch.Tensor,
                cfg: ModelConfig, embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Caches]:
    """One decode step. tokens [B, 1] (or embeds [B, 1, D]); positions
    [B, 1]. Returns (logits [B, V], caches): attention caches are written
    in place, SSM caches replaced. Decode uses text RoPE even after an
    M-RoPE prefill, as the reference does."""
    batch = {"tokens": tokens} if embeds is None else {"embeds": embeds}
    h = _embed(params, batch, cfg)
    h, caches, _ = _run_stack(params, h, positions, cfg, "decode", caches,
                              None)
    logits = _head(params, h, cfg)
    return logits[:, 0], caches


def pooled_embedding(params: Transformer, tokens: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """The memory engine's embedding of documents and prompts: tokens
    [B, L] through the stack in "train" mode without caches, the final
    hidden states (before the final norm) averaged over L in float32 →
    [B, D]."""
    h = _embed(params, {"tokens": tokens}, cfg)
    B, L = h.shape[:2]
    h, _, _ = _run_stack(params, h, _positions(B, L, h.device), cfg, "train",
                         None)
    return torch.mean(h.to(torch.float32), dim=1)


def greedy_decode(params: Transformer, logits: torch.Tensor, caches: Caches,
                  start: int, n_new: int, cfg: ModelConfig) -> torch.Tensor:
    """Greedy continuation of a prefilled prompt of ``start`` tokens:
    ``logits`` [B, V] are ``prefill``'s. Ties in the argmax go to the first
    index. Returns [B, n_new] int32 after n_new - 1 decode steps (the
    reference's last step only feeds a discarded token)."""
    B = logits.shape[0]
    out = torch.empty((B, n_new), dtype=torch.int32, device=logits.device)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    for t in range(n_new):
        out[:, t] = tok[:, 0]
        if t + 1 == n_new:
            break
        pos = torch.full((B, 1), start + t, dtype=torch.int32,
                         device=logits.device)
        logits, caches = decode_step(params, caches, tok, pos, cfg)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    return out
