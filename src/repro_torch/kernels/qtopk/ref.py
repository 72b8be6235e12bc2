"""Plain PyTorch versions of qtopk.

``qtopk_sorted`` is the definition: the k smallest (score, key) pairs per
row by a full two-key sort. ``qtopk_blocked`` is the function the
reference kernel computes, step for step: columns cut into blocks of
``bn`` (the last one padded with (INT64_MAX, INT32_MAX) lanes), ``kk``
selection passes per block, each retiring the lanes that carry the
(score, key) minimum, then one two-key sort over the candidates. The two
agree whenever the keys are unique and k <= n; the blocked form also
reproduces the reference kernel's output where they do not. It is the CPU
path of ``ops.qtopk`` and the oracle the card is held against.

``qtopk_select_ref`` is the CUDA kernel's algorithm on the CPU, step for
step (``csrc/qtopk.cu``): each (score, key) pair becomes a 96-bit composite
key whose unsigned order is the (score, key) order, per-tile thresholds
are found by 8-bit radix digits, each starting at the highest bit on which
the keys still in play differ, the pairs at or below a threshold are
compacted, a second selection over the row's candidates leaves exactly
min(k, n) pairs, one two-key sort orders them (the kernel's bitonic sort
gives the same order), and the pad columns of the reference's width are
written in closed form. The kernel tracks a segment held in registers
with per-slot bits where this model compares against the range of the
keys in play; both name the same keys. It exists so that a fault
in the digit logic shows on the CPU; it must equal ``qtopk_blocked``
whenever every score is below INT64_MAX.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.sorting import sort2

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
I32_MAX = (1 << 31) - 1
M32 = 0xFFFFFFFF
TILE = 4096  # columns per phase-1 block of the kernel (256 threads x 16)


def qtopk_sorted(scores: torch.Tensor, keys: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    nq, n = scores.shape
    keys_b = keys.to(torch.int32)[None, :].expand(nq, n)
    s, i = sort2(scores, keys_b)
    return s[:, :k], i[:, :k]


def block_candidates(scores: torch.Tensor, keys: torch.Tensor, bn: int,
                     kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block candidates [nq, n_blocks * kk] (score int64, key int32)."""
    nq, n = scores.shape
    nb = -(-n // bn)
    pad = nb * bn - n
    dev = scores.device
    s = torch.cat([scores.to(torch.int64),
                   torch.full((nq, pad), I64_MAX, dtype=torch.int64, device=dev)],
                  dim=1).view(nq, nb, bn)
    kb = torch.cat([keys.to(torch.int32),
                    torch.full((pad,), I32_MAX, dtype=torch.int32, device=dev)]
                   ).view(1, nb, bn).expand(nq, nb, bn)
    out_s = torch.empty((nq, nb, kk), dtype=torch.int64, device=dev)
    out_k = torch.empty((nq, nb, kk), dtype=torch.int32, device=dev)
    for t in range(kk):
        ms = s.min(dim=-1).values
        km = torch.where(s == ms[..., None], kb, I32_MAX)
        mk = km.min(dim=-1).values
        out_s[..., t] = ms
        out_k[..., t] = mk
        s = torch.where(km == mk[..., None], I64_MAX, s)
    return out_s.view(nq, nb * kk), out_k.view(nq, nb * kk)


def merge(cand_s: torch.Tensor, cand_k: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final (score, key) two-key sort over the block candidates."""
    s, i = sort2(cand_s, cand_k)
    return s[:, :k], i[:, :k]


def qtopk_blocked(scores: torch.Tensor, keys: torch.Tensor, k: int, bn: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    cand_s, cand_k = block_candidates(scores, keys, bn, min(k, bn))
    return merge(cand_s, cand_k, k)


def qtopk_width(n: int, k: int, bn: int) -> int:
    """Columns of the reference's output: min(k, n_blocks * min(k, bn)).
    It exceeds n when n >= 1024, n % 1024 != 0 and k > n."""
    return min(k, -(-n // bn) * min(k, bn)) if n else 0


def pad_columns(s: torch.Tensor, i: torch.Tensor, keys: torch.Tensor, k: int,
                bn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append the reference's pad columns to the min(k, n) sorted pairs.

    Where the width exceeds n, the last block's retired and pad lanes
    yield (INT64_MAX, smallest real key of that block) once per pass that
    finds no live lane, so every pad column is that pair."""
    nq, m = s.shape
    n = keys.shape[0]
    extra = qtopk_width(n, k, bn) - m
    if extra <= 0:
        return s, i
    last = keys[(-(-n // bn) - 1) * bn:].min().to(torch.int32)
    ps = torch.full((nq, extra), I64_MAX, dtype=s.dtype, device=s.device)
    return (torch.cat([s, ps], dim=1),
            torch.cat([i, last.reshape(1, 1).expand(nq, extra)], dim=1))


# --------------------------------------------------------------------------- #
# the kernel's radix selection, on the CPU
# --------------------------------------------------------------------------- #
# A composite key is a pair (hi, lo) of int64 tensors: hi holds the bits of
# the uint64 score ^ 2^63, lo the uint32 key ^ 2^31 (0 <= lo < 2^32). Each
# helper mirrors the device function of the same name in csrc/qtopk.cu.


def _u64_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a ^ I64_MIN) < (b ^ I64_MIN)


def key_le(ah, al, bh, bl) -> torch.Tensor:
    return _u64_lt(ah, bh) | ((ah == bh) & (al <= bl))


def ones(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The low m bits set, 0 <= m <= 96."""
    all_set = torch.full_like(m, -1)
    hi = torch.where(m <= 32, 0, torch.where(
        m == 96, -1, ~(all_set << (m - 32).clamp(0, 63))))
    lo = torch.where(m >= 32, M32, ~(all_set << m.clamp(0, 31)) & M32)
    return hi, lo


def digit(xh, xl, s: torch.Tensor) -> torch.Tensor:
    """Bits [s, s + 8) of the key, 0 <= s <= 88."""
    from_hi = (xh >> (s - 32).clamp(0, 63)) & 0xFF
    from_lo = (xl >> s.clamp(0, 31)) & 0xFF
    mixed = ((xh << (32 - s).clamp(0, 63)) | (xl >> s.clamp(0, 31))) & 0xFF
    return torch.where(s >= 32, from_hi, torch.where(s <= 24, from_lo, mixed))


def shl_digit(b: torch.Tensor, s: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """b << s as a composite key, 0 <= b < 256, 0 <= s <= 88."""
    hi = torch.where(s >= 32, b << (s - 32).clamp(0, 63),
                     torch.where(s <= 24, 0, b >> (32 - s).clamp(0, 63)))
    lo = torch.where(s >= 32, 0, (b << s.clamp(0, 31)) & M32)
    return hi, lo


def top_bit(xh, xl) -> torch.Tensor:
    """Position of the highest set bit of the key, or -1."""
    sh = torch.arange(63, device=xh.device)
    hi_len = torch.where(xh < 0, 64, ((xh[:, None] >> sh) != 0).sum(1))
    lo_len = ((xl[:, None] >> sh[:32]) != 0).sum(1)
    return torch.where(xh != 0, 31 + hi_len, lo_len - 1)


def _fold(x: torch.Tensor, op, identity: int) -> torch.Tensor:
    """Reduce the last dim with a bitwise op (a halving tree)."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.full_like(x[:, :1], identity)], dim=1)
        h = x.shape[1] // 2
        x = op(x[:, :h], x[:, h:])
    return x[:, 0]


def select_segments(scores: torch.Tensor, keys: torch.Tensor, seg: int, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel: each row of ``scores`` / ``keys`` [R, L]
    is cut into segments of ``seg`` columns (the last one shorter); each
    segment keeps its kt = min(k, length) smallest pairs, unordered, at
    offset g * k of its row of the output [R, n_segments * k]. Slots a short
    last segment leaves empty are (INT64_MAX, INT32_MAX). The kernel writes
    a segment's pairs in thread order, this model in column order: the
    final sort makes the two the same."""
    R, L = scores.shape
    nseg = -(-L // seg)
    pad = nseg * seg - L
    S = R * nseg
    dev = scores.device

    def cut(x, fill):
        x = torch.cat([x, torch.full((R, pad), fill, dtype=x.dtype,
                                     device=dev)], dim=1)
        return x.reshape(S, seg)

    s_seg = cut(scores.to(torch.int64), I64_MAX)
    k_seg = cut(keys.to(torch.int32), I32_MAX)
    valid = cut(torch.ones((R, L), dtype=torch.bool, device=dev), False)
    xh = s_seg ^ I64_MIN
    xl = (k_seg.to(torch.int64) ^ 0x80000000) & M32
    length = valid.sum(1)
    kt = length.clamp(max=k)

    def and_or(member):
        """AND and OR of each segment's keys where ``member``."""
        return (_fold(torch.where(member, xh, -1), torch.bitwise_and, -1),
                _fold(torch.where(member, xl, M32), torch.bitwise_and, M32),
                _fold(torch.where(member, xh, 0), torch.bitwise_or, 0),
                _fold(torch.where(member, xl, 0), torch.bitwise_or, 0))

    def jump(a_h, a_l, o_h, o_l):
        """The range of the keys in play (they share every bit above their
        highest differing bit ``top``) and the next digit, ending at top."""
        top = top_bit(a_h ^ o_h, a_l ^ o_l)
        m_h, m_l = ones(top + 1)
        lo_h, lo_l = a_h & ~m_h, a_l & ~m_l
        return lo_h, lo_l, lo_h | m_h, lo_l | m_l, (top - 7).clamp(min=0)

    def in_range(lo_h, lo_l, hi_h, hi_l):
        return (valid & key_le(lo_h[:, None], lo_l[:, None], xh, xl)
                & key_le(xh, xl, hi_h[:, None], hi_l[:, None]))

    lo_h, lo_l, hi_h, hi_l, s = jump(*and_or(valid))
    needed = kt.clone()
    take_all = kt >= length
    done = take_all.clone()
    for _ in range(97):  # each level fixes at least one of the 96 bits
        if bool(done.all()):
            break
        act = ~done
        inplay = in_range(lo_h, lo_l, hi_h, hi_l)
        d = digit(xh, xl, s[:, None])
        hist = torch.zeros((S, 256), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, torch.where(inplay, d, 0), inplay.to(torch.int64))
        csum = hist.cumsum(1)
        b = (csum < needed[:, None]).sum(1).clamp(max=255)
        cnt = hist.gather(1, b[:, None])[:, 0]
        before = csum.gather(1, b[:, None])[:, 0] - cnt
        needed = torch.where(act, needed - before, needed)
        m_h, m_l = ones(s + 8)
        d_h, d_l = shl_digit(b, s)
        nlo_h, nlo_l = (lo_h & ~m_h) | d_h, (lo_l & ~m_l) | d_l
        f_h, f_l = ones(s)
        nhi_h, nhi_l = nlo_h | f_h, nlo_l | f_l
        stop = act & ((cnt == needed) | (s == 0))
        # the bin's keys stay in play: jump to their highest differing bit
        j_lo_h, j_lo_l, j_hi_h, j_hi_l, j_s = jump(
            *and_or(in_range(nlo_h, nlo_l, nhi_h, nhi_l)))
        go = act & ~stop
        lo_h = torch.where(stop, nlo_h, torch.where(go, j_lo_h, lo_h))
        lo_l = torch.where(stop, nlo_l, torch.where(go, j_lo_l, lo_l))
        hi_h = torch.where(stop, nhi_h, torch.where(go, j_hi_h, hi_h))
        hi_l = torch.where(stop, nhi_l, torch.where(go, j_hi_l, hi_l))
        s = torch.where(go, j_s, s)
        done = done | stop
    else:
        raise AssertionError("qtopk model: a segment's selection made no "
                             "progress")
    thr_h = torch.where(take_all, -1, hi_h)
    thr_l = torch.where(take_all, M32, hi_l)

    selected = valid & key_le(xh, xl, thr_h[:, None], thr_l[:, None])
    if not torch.equal(selected.sum(1), kt):
        raise AssertionError("qtopk model: a threshold selected the wrong "
                             "count (duplicate keys?)")
    order = torch.argsort((~selected).to(torch.int8), dim=1, stable=True)
    order = order[:, :k]
    keep = torch.arange(k, device=dev)[None, :] < kt[:, None]
    out_s = torch.where(keep, s_seg.gather(1, order), I64_MAX)
    out_k = torch.where(keep, k_seg.gather(1, order), I32_MAX)
    return out_s.reshape(R, nseg * k), out_k.reshape(R, nseg * k)


def select_plan(n: int, k: int, tile: int = TILE):
    """The kernel's phases for a row of n columns: None for one pass over
    the row (n <= tile or k >= tile), else (n_tiles, candidates per row)."""
    if n <= tile or k >= tile:
        return None
    n_tiles = -(-n // tile)
    return n_tiles, (n_tiles - 1) * k + min(k, n - (n_tiles - 1) * tile)


def qtopk_select_ref(scores: torch.Tensor, keys: torch.Tensor, k: int,
                     bn: int, tile: int = TILE
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.qtopk`` by the card's algorithm (module docstring); ``tile``
    is the kernel's phase-1 width, smaller in tests to reach phase 2 on
    short rows."""
    nq, n = scores.shape
    m = min(k, n)
    keys_b = keys.to(torch.int32)[None, :].expand(nq, n)
    plan = select_plan(n, k, tile)
    if plan is None:
        sel_s, sel_k = select_segments(scores, keys_b, n, m)
    else:
        _, c = plan
        cand_s, cand_k = select_segments(scores, keys_b, tile, k)
        sel_s, sel_k = select_segments(cand_s[:, :c], cand_k[:, :c], c, k)
    s, i = merge(sel_s, sel_k, m)
    return pad_columns(s, i, keys, k, bn)
