"""Token-choice top-k MoE with deterministic sort-based capacity dispatch
(the port of ``repro.models.layers.moe``: its one-device ``_moe_dense``).

Routing runs in float32 and takes the k largest probabilities with a
stable descending sort, so equal probabilities go to the lower expert
index, as ``jax.lax.top_k`` does. Padded experts (``padded_experts`` >
``num_experts``) get -1e30 logits, a probability of exactly 0, and are
never routed to. The (expert, pair) pairs are sorted stably by expert;
each pair's rank within its expert decides whether it fits the capacity
``capacity_of(T)``, and the pairs that do not are dropped (their combine
weight is zero, so the residual passes through). Every write goes to a
distinct slot and the combine is a gather and a sum over k: no float
scatter-add, so no atomics and the same bits on every run.

A document's output depends on its batch: the capacity is a function of
the batch's token count and overflow is dropped, as in the reference.

Under a mesh (``models.placement``), where the reference takes its
expert-parallel ``shard_map`` (``pspec.moe_ep``), each rank holds the
router whole and ``E_pad / n_model`` experts, routes its data shard's
tokens exactly as every other ``model`` rank does, keeps the pairs bound
for its experts (capacity per data shard, as the reference's), and the
combine is one float32 sum over ``model`` in rank order; the balance loss
is averaged over the data-parallel axes. With top-2 routing each token's
output is the same sum of the same two terms as the one-device path's,
bit for bit.
"""
from __future__ import annotations

import threading
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import collectives, pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.initializers import dense_init


class MoE(nn.Module):
    """``router`` [D, E_pad], ``w_gate`` / ``w_up`` [E_pad, D, Fe],
    ``w_down`` [E_pad, Fe, D]: the reference's ``init_moe``."""

    def __init__(self, generator: torch.Generator, cfg: ModelConfig):
        super().__init__()
        D, E, Fe = cfg.d_model, cfg.padded_experts, cfg.expert_d_ff
        pd = cfg.params_dtype
        self.router = nn.Parameter(dense_init(generator, (D, E), pd,
                                              fan_in=D))
        self.w_gate = nn.Parameter(dense_init(generator, (E, D, Fe), pd,
                                              fan_in=D))
        self.w_up = nn.Parameter(dense_init(generator, (E, D, Fe), pd,
                                            fan_in=D))
        self.w_down = nn.Parameter(dense_init(generator, (E, Fe, D), pd,
                                              fan_in=Fe))


PATHS = {"dense": 0, "expert_parallel": 0}  # moe_ffn calls by path taken
_PATHS_LOCK = threading.Lock()


def capacity_of(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: tokens x k x capacity factor over the real
    experts, at least 8 and rounded up to a multiple of 8."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    c = int(tokens * k * cfg.moe_capacity_factor / E)
    return max(8, ((c + 7) // 8) * 8)


def _route(params: MoE, xt: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt [T, D] → (probs [T, E_pad], top_p [T, K] renormalized, top_e
    [T, K]), in float32."""
    E, E_real, K = (cfg.padded_experts, cfg.num_experts,
                    cfg.num_experts_per_tok)
    logits = xt.to(torch.float32) @ params.router.to(torch.float32)
    if E != E_real:
        eidx = torch.arange(E, device=xt.device)
        logits = torch.where(eidx[None, :] < E_real, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _expert_mlp(params: MoE, buf: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """buf [E, C, D] → [E, C, D], each expert's gated MLP on its slots."""
    dtype = buf.dtype
    gate = torch.einsum("ecd,edf->ecf", buf, params.w_gate.to(dtype))
    up = torch.einsum("ecd,edf->ecf", buf, params.w_up.to(dtype))
    act = F.silu(gate) if cfg.activation == "swiglu" \
        else F.gelu(gate, approximate="tanh")
    return torch.einsum("ecf,efd->ecd", act * up, params.w_down.to(dtype))


def moe_ffn(params: MoE, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, D] → (y [B, L, D], aux): the reference's ``_moe_dense``,
    or under a mesh where ``pspec.moe_ep`` holds its expert-parallel
    ``_moe_shardmap`` (this rank's data shard and experts). aux is the
    Switch-style load-balance loss, mean(f_e · p_e) · E_pad, in
    float32."""
    ep = pspec.moe_ep(cfg)
    with _PATHS_LOCK:
        PATHS["expert_parallel" if ep else "dense"] += 1
    return _moe_dispatch(params, x, cfg, expert_parallel=ep)


def _moe_dispatch(params: MoE, x: torch.Tensor, cfg: ModelConfig, *,
                  expert_parallel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    B, L, D = x.shape
    T = B * L
    E, K = cfg.padded_experts, cfg.num_experts_per_tok
    C = capacity_of(T, cfg)
    dev = x.device
    xt = x.reshape(T, D)
    # this rank's experts: [first, first + E_loc) (all E on one device)
    E_loc, first = E, 0
    if expert_parallel:
        E_loc = params.w_gate.shape[0]
        first = collectives.axis_index("model") * E_loc

    probs, top_p, top_e = _route(params, xt, cfg)

    # ---- dispatch: stable sort of the (token, rank) pairs by expert ---- #
    flat_e = top_e.reshape(T * K)
    # pair_idx is an arange, so a stable sort by expert is the reference's
    # two-key (expert, pair) sort
    sorted_e, sorted_pair = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - starts[sorted_e]
    keep = rank < C
    if expert_parallel:
        # identical routing on every model rank; each keeps its experts'
        keep = keep & (sorted_e // E_loc == first // E_loc)
    # overflow pairs (and, expert-parallel, other ranks' pairs) all go to
    # one extra row that is thrown away; every kept pair owns its slot,
    # so the writes that survive are unique
    dest = torch.where(keep, (sorted_e - first) * C + rank, E_loc * C)
    buf = torch.zeros((E_loc * C + 1, D), dtype=x.dtype, device=dev)
    buf[dest] = xt[sorted_pair // K]
    out_flat = _expert_mlp(params, buf[:E_loc * C].reshape(E_loc, C, D), cfg
                           ).reshape(E_loc * C, D)

    # ---- combine: each pair's expert output, weighted, summed over K --- #
    pair_dest = torch.empty(T * K, dtype=dest.dtype, device=dev)
    pair_dest[sorted_pair] = torch.where(keep, dest, -1)
    gathered = out_flat[torch.clamp(pair_dest, 0, E_loc * C - 1)]
    w = torch.where(pair_dest >= 0, top_p.reshape(T * K), 0.0).to(x.dtype)
    y = (gathered * w[:, None]).reshape(T, K, D).sum(dim=1)

    # ---- aux load-balance loss ----------------------------------------- #
    frac_tokens = counts.to(torch.float32) / float(T * K)
    frac_probs = probs.mean(dim=0)
    aux = torch.sum(frac_tokens * frac_probs) * E
    if expert_parallel:
        # one float32 sum over the expert shards; aux over the dp shards
        y = collectives.psum(y.to(torch.float32), "model").to(x.dtype)
        aux = collectives.pmean(aux, pspec.dp_axes(pspec.current_mesh()))
    return y.reshape(B, L, D), aux
