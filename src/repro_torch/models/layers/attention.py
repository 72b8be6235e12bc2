"""GQA attention: naive, flash-chunked, work-balanced (zigzag) and decode.

The port of ``repro.models.layers.attention``: GQA / MQA / MHA through
``num_kv_heads``, RoPE, sliding windows (with a ring-buffer KV cache),
logit softcapping and qkv bias. The flash paths are the reference's
online softmax in plain torch ops: the reference vmaps over query chunks
and scans over KV chunks; here the query chunks are one batch axis and the
KV chunks a Python loop, with the same per-block arithmetic. The softcap
rules out ``scaled_dot_product_attention``.

M-RoPE (qwen2-vl) comes in as precomputed ``angles``; decode always uses
text RoPE. Under a mesh (``models.pspec``) attention takes the
reference's layout over ``model`` (``pspec.attn_layout``;
``models.placement`` gathers each rank's weights to it):

  heads    : the rank holds its slice of the query and key/value heads,
             attends over them, and its partial output projection is
             summed over ``model`` (head-sharded tensor parallelism);
  q_heads  : as heads, but the key/value heads are whole on every rank
             (replicated); its query head h reads key/value head h // G;
  sequence : the weights are whole; the rank projects q for its L/model
             query rows (with their positions for RoPE and the mask),
             attends them against the whole K/V, projects them out, and
             the rows are gathered along L over ``model``. Zigzag is off.
             Decode (L = 1) computes every head on every rank.

Head counts are read from the tensors, so the same code serves all.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import collectives, pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.initializers import dense_init, device_of
from repro_torch.models.layers import rope as rope_lib

NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #


class Attention(nn.Module):
    """``wq`` [D, H, Dh], ``wk``/``wv`` [D, KV, Dh], ``wo`` [H, Dh, D]; with
    ``qkv_bias`` also ``bq`` [H, Dh], ``bk``/``bv`` [KV, Dh] (zero init).
    The reference's ``init_attention``."""

    def __init__(self, generator: torch.Generator, cfg: ModelConfig):
        super().__init__()
        D, H, KV, Dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim_)
        pd, dev = cfg.params_dtype, device_of(generator)
        self.wq = nn.Parameter(dense_init(generator, (D, H, Dh), pd,
                                          fan_in=D))
        self.wk = nn.Parameter(dense_init(generator, (D, KV, Dh), pd,
                                          fan_in=D))
        self.wv = nn.Parameter(dense_init(generator, (D, KV, Dh), pd,
                                          fan_in=D))
        self.wo = nn.Parameter(dense_init(generator, (H, Dh, D), pd,
                                          fan_in=H * Dh))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros((H, Dh), dtype=pd, device=dev))
            self.bk = nn.Parameter(torch.zeros((KV, Dh), dtype=pd,
                                               device=dev))
            self.bv = nn.Parameter(torch.zeros((KV, Dh), dtype=pd,
                                               device=dev))


# --------------------------------------------------------------------------- #
# qkv projection + rope
# --------------------------------------------------------------------------- #


def _project_qkv(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                 angles: torch.Tensor, rows: Optional[slice] = None):
    """q, k, v with RoPE; ``rows`` (sequence-parallel attention) limits q
    to those rows of x and angles."""
    dtype = x.dtype
    xq, aq = (x, angles) if rows is None else (x[:, rows], angles[:, rows])
    q = torch.einsum("bld,dhk->blhk", xq, params.wq.to(dtype))
    k = torch.einsum("bld,dhk->blhk", x, params.wk.to(dtype))
    v = torch.einsum("bld,dhk->blhk", x, params.wv.to(dtype))
    if cfg.qkv_bias:
        q = q + params.bq.to(dtype)
        k = k + params.bk.to(dtype)
        v = v + params.bv.to(dtype)
    q = rope_lib.apply_rope(q, aq)
    k = rope_lib.apply_rope(k, angles)
    return q, k, v


def _kv_for(k: torch.Tensor, v: torch.Tensor, n_heads: int,
            cfg: ModelConfig):
    """The key/value heads [B, S, KV', Dh] that this rank's ``n_heads``
    query heads read: under ``q_heads`` the rank's heads are the
    contiguous slice at model index x n_heads and head h reads key/value
    head h // G. Where ``model`` is a multiple of the key/value heads the
    slice lies in one group and the rank takes that head; otherwise (say
    6 / 3 heads over 2 ranks: heads 0-2 read 0, 0, 1) one key/value head
    per query head. Elsewhere k and v as they are."""
    if pspec.attn_layout(cfg) != "q_heads":
        return k, v
    G = cfg.num_heads // cfg.num_kv_heads
    first = collectives.axis_index("model") * n_heads
    if G % n_heads == 0:
        return (k[:, :, first // G:first // G + 1],
                v[:, :, first // G:first // G + 1])
    idx = torch.arange(first, first + n_heads, device=k.device) // G
    return k[:, :, idx], v[:, :, idx]


def _rows(cfg: ModelConfig, L: int) -> Optional[slice]:
    """This rank's query rows under sequence-parallel attention over a
    ``model`` group larger than one that divides L (the reference's
    constraint replicates a dimension it does not divide); else None."""
    if pspec.attn_layout(cfg) != "sequence":
        return None
    m = pspec.current_mesh().shape.get("model", 1)
    if m == 1 or L % m:
        return None
    i = collectives.axis_index("model")
    return slice(i * (L // m), (i + 1) * (L // m))


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(logits / cap)
    return logits


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int]) -> torch.Tensor:
    """[..., Lq, Lk] additive bias: 0 where attendable, NEG_INF otherwise."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        ok &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


# --------------------------------------------------------------------------- #
# naive attention (short sequences)
# --------------------------------------------------------------------------- #


def _naive_attend(q, k, v, q_pos, k_pos, cfg: ModelConfig, window):
    B, Lq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Lq, KV, G, Dh)
    logits = torch.einsum("blkgd,bmkd->bkglm", qg, k).to(torch.float32)
    logits = _softcap(logits * cfg.query_scale, cfg.attn_logit_softcap)
    logits = logits + _mask_bias(q_pos, k_pos, window)[:, None, None]
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkglm,bmkd->blkgd", w, v)
    return out.reshape(B, Lq, H, Dh)


# --------------------------------------------------------------------------- #
# flash attention (online softmax)
# --------------------------------------------------------------------------- #


def _online_step(m, l, acc, q_blk, k_blk, v_blk, qpos_blk, kpos_blk,
                 cfg: ModelConfig, window):
    """One KV block of the online softmax for a batch of query blocks.

    q_blk [B, n, qc, KV, G, Dh]; k_blk, v_blk [B, n, kc, KV, Dh]; positions
    [B, n, qc] and [B, n, kc]; m, l [B, n, KV, G, qc], acc [..., qc, Dh]."""
    s = torch.einsum("bnqkgd,bnmkd->bnkgqm", q_blk, k_blk).to(torch.float32)
    s = _softcap(s * cfg.query_scale, cfg.attn_logit_softcap)
    bias = _mask_bias(qpos_blk, kpos_blk, window)    # [B, n, qc, kc]
    ok = (bias > NEG_INF / 2)[:, :, None, None]      # [B, n, 1, 1, qc, kc]
    s = s + bias[:, :, None, None]
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    alpha = torch.exp(m - m_new)
    # explicit zeroing: a fully masked block has s == m_new == -1e30, where
    # exp(s - m_new) would wrongly be 1
    p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
    l_new = l * alpha + torch.sum(p, dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bnkgqm,bnmkd->bnkgqd", p.to(v_blk.dtype), v_blk).to(torch.float32)
    return m_new, l_new, acc_new


def _online_init(B: int, n: int, KV: int, G: int, qc: int, Dh: int, device):
    m = torch.full((B, n, KV, G, qc), NEG_INF, dtype=torch.float32,
                   device=device)
    l = torch.zeros((B, n, KV, G, qc), dtype=torch.float32, device=device)
    acc = torch.zeros((B, n, KV, G, qc, Dh), dtype=torch.float32,
                      device=device)
    return m, l, acc


def _online_out(l, acc) -> torch.Tensor:
    """[B, n, KV, G, qc, Dh] → [B, n, qc, KV, G, Dh]."""
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return torch.movedim(out, 4, 2)


def _flash_attend(q, k, v, q_pos, k_pos, cfg: ModelConfig, window,
                  qc: Optional[int] = None):
    """Memory-O(chunk) attention. q [B,Lq,H,Dh]; k,v [B,Lk,KV,Dh]; ``qc``
    the query chunk (min(flash_q_chunk, Lq) by default: each query row's
    arithmetic is the same for any chunk, the KV blocks set its order)."""
    B, Lq, H, Dh = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qc = qc or min(cfg.flash_q_chunk, Lq)
    kc = min(cfg.flash_kv_chunk, Lk)
    if Lq % qc or Lk % kc:
        raise ValueError(f"flash chunks do not divide: Lq={Lq} qc={qc}, "
                         f"Lk={Lk} kc={kc}")
    nq, nk = Lq // qc, Lk // kc
    qg = q.reshape(B, nq, qc, KV, G, Dh)
    qp = q_pos.reshape(B, nq, qc)
    kg = k.reshape(B, nk, kc, KV, Dh)
    vg = v.reshape(B, nk, kc, KV, Dh)
    kp = k_pos.reshape(B, nk, kc)
    m, l, acc = _online_init(B, nq, KV, G, qc, Dh, q.device)
    for j in range(nk):
        # every query chunk sees KV block j (the reference's scan step)
        m, l, acc = _online_step(
            m, l, acc, qg, kg[:, j, None], vg[:, j, None], qp,
            kp[:, j, None], cfg, window)
    out = _online_out(l, acc)
    return out.reshape(B, Lq, H, Dh).to(q.dtype)


def _flash_attend_zigzag(q, k, v, q_pos, k_pos, cfg: ModelConfig):
    """Work-balanced causal flash attention: pair query chunk p with chunk
    nq-1-p, so each pair needs exactly nq+1 KV blocks (p+1 for the early
    member, nq-p for the late one). At step t pair p serves its early
    member with KV block t while t <= p, then its late member with block
    t-(p+1). Requires full causality (no window), Lq == Lk and an even
    chunk count; ``attention`` checks. The running (m, l, acc) of each
    query chunk is kept by chunk index: the members active at one step are
    distinct chunks, so one gather and one scatter per step do the
    reference's per-member select and update."""
    B, Lq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qc = min(cfg.flash_q_chunk, Lq)
    nq = Lq // qc
    kc = qc  # equal chunking keeps the pairing arithmetic exact
    qg = q.reshape(B, nq, qc, KV, G, Dh)
    qp = q_pos.reshape(B, nq, qc)
    kg = k.reshape(B, nq, kc, KV, Dh)
    vg = v.reshape(B, nq, kc, KV, Dh)
    kp = k_pos.reshape(B, nq, kc)
    m, l, acc = _online_init(B, nq, KV, G, qc, Dh, q.device)
    pairs = torch.arange(nq // 2, device=q.device)
    for t in range(nq + 1):
        late = t > pairs
        q_idx = torch.where(late, nq - 1 - pairs, pairs)
        kv_idx = torch.where(late, t - (pairs + 1), t)
        m_sel, l_sel, acc_sel = _online_step(
            m[:, q_idx], l[:, q_idx], acc[:, q_idx], qg[:, q_idx],
            kg[:, kv_idx], vg[:, kv_idx], qp[:, q_idx], kp[:, kv_idx], cfg,
            None)
        m[:, q_idx], l[:, q_idx], acc[:, q_idx] = m_sel, l_sel, acc_sel
    out = _online_out(l, acc)
    return out.reshape(B, Lq, H, Dh).to(q.dtype)


# --------------------------------------------------------------------------- #
# KV cache (decode). Ring buffer when S_cache < total positions.
# --------------------------------------------------------------------------- #


def init_cache(batch: int, s_cache: int, cfg: ModelConfig, device) -> Cache:
    """One layer's cache: k, v [B, S, KV, Dh] in the compute dtype, and the
    absolute position held in each slot (-1 = empty). Under the
    ``heads`` layout a rank holds its KV / model heads, elsewhere all."""
    KV, Dh = cfg.num_kv_heads, cfg.head_dim_
    if pspec.attn_layout(cfg) == "heads":
        KV //= pspec.current_mesh().shape["model"]
    dt = cfg.compute_dtype
    return {
        "k": torch.zeros((batch, s_cache, KV, Dh), dtype=dt, device=device),
        "v": torch.zeros((batch, s_cache, KV, Dh), dtype=dt, device=device),
        "pos": torch.full((batch, s_cache), -1, dtype=torch.int32,
                          device=device),
    }


def _decode_attend(params: Attention, x, positions, cfg: ModelConfig,
                   cache_slice: Cache, window):
    """x [B, 1, D]; cache {k, v [B, S, KV, Dh], pos [B, S]}. Writes the new
    key and value at slot ``pos % S`` in place (the ring)."""
    B = x.shape[0]
    S = cache_slice["k"].shape[1]
    angles = rope_lib.rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    q, k_new, v_new = _project_qkv(params, x, cfg, angles)

    write_idx = (positions[:, 0] % S).long()  # [B]
    bidx = torch.arange(B, device=x.device)
    k_cache, v_cache = cache_slice["k"], cache_slice["v"]
    pos_cache = cache_slice["pos"]
    k_cache[bidx, write_idx] = k_new[:, 0]
    v_cache[bidx, write_idx] = v_new[:, 0]
    pos_cache[bidx, write_idx] = positions[:, 0].to(torch.int32)

    H, Dh = q.shape[2], q.shape[3]  # this rank's query heads
    k_read, v_read = _kv_for(k_cache, v_cache, H, cfg)
    KV = k_read.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_read).to(torch.float32)
    s = _softcap(s * cfg.query_scale, cfg.attn_logit_softcap)
    ok = (pos_cache >= 0) & (pos_cache <= positions)  # [B, S]
    if window is not None:
        ok &= (positions - pos_cache) < window
    s = torch.where(ok[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_read).reshape(B, 1, H, Dh)
    o = torch.einsum("blhd,hdo->blo", out, params.wo.to(x.dtype))
    return _heads_sum(o, cfg), cache_slice


def _heads_sum(out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Under the ``heads`` and ``q_heads`` layouts each rank's output
    projection covers its query heads only: the one sum over ``model``
    (the identity otherwise)."""
    if pspec.attn_layout(cfg) in ("heads", "q_heads"):
        return collectives.psum(out, "model")
    return out


# --------------------------------------------------------------------------- #
# public entry
# --------------------------------------------------------------------------- #


def attention(params: Attention, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, local: bool, mode: str,
              cache_slice: Optional[Cache] = None,
              angles: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x [B, L, D], positions [B, L] int absolute positions; ``mode`` is
    train | prefill | decode; ``angles`` [B, L, head_dim/2] precomputed
    (M-RoPE) replace the text RoPE of ``positions`` outside decode.
    Prefill writes the cache in place, keeping the last S positions at
    slot ``pos % S``; decode writes one slot."""
    window = cfg.sliding_window if local else None

    if mode == "decode":
        return _decode_attend(params, x, positions, cfg, cache_slice, window)

    if angles is None:
        angles = rope_lib.rope_angles(positions, cfg.head_dim_,
                                      cfg.rope_theta)
    L = x.shape[1]
    rows = _rows(cfg, L)
    q, k, v = _project_qkv(params, x, cfg, angles, rows)
    q_pos = positions if rows is None else positions[:, rows]
    k_read, v_read = _kv_for(k, v, q.shape[2], cfg)

    use_flash = (cfg.attn_impl in ("flash", "latency")) or (
        cfg.attn_impl == "auto" and L >= cfg.flash_threshold)
    qc = min(cfg.flash_q_chunk, L)
    zigzag_ok = (
        use_flash and window is None and cfg.attn_impl != "flash"
        and L % qc == 0 and (L // qc) % 2 == 0 and L // qc >= 2
        # as the reference: zigzag only where attention is head-TP or
        # unsharded
        and pspec.attn_layout(cfg) in (None, "heads", "q_heads"))
    if zigzag_ok:
        ctx = _flash_attend_zigzag(q, k_read, v_read, positions, positions,
                                   cfg)
    elif use_flash:
        # a rank's rows may not split into whole chunks of the full length
        Lq = q.shape[1]
        ctx = _flash_attend(q, k_read, v_read, q_pos, positions, cfg,
                            window, None if rows is None
                            else math.gcd(min(qc, Lq), Lq))
    else:
        ctx = _naive_attend(q, k_read, v_read, q_pos, positions, cfg,
                            window)
    out = _heads_sum(torch.einsum("blhd,hdo->blo", ctx,
                                  params.wo.to(x.dtype)), cfg)
    if rows is not None:
        # every rank's rows, in rank order: whole along L again
        out = collectives.all_gather(out, "model", dim=1)

    if mode == "prefill":
        if cache_slice is None:
            raise ValueError("prefill needs a cache")
        S = cache_slice["k"].shape[1]
        # keep the last S positions (ring layout: slot = pos % S)
        keep = min(L, S)
        p_tail = positions[:, -keep:]
        idx = (p_tail % S).long()
        bidx = torch.arange(x.shape[0], device=x.device)[:, None]
        cache_slice["k"][bidx, idx] = k[:, -keep:]
        cache_slice["v"][bidx, idx] = v[:, -keep:]
        cache_slice["pos"][bidx, idx] = p_tail.to(torch.int32)
        return out, cache_slice
    return out, None
