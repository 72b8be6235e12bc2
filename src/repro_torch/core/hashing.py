"""Deterministic state hashing (paper §8.1 / §9), bit-identical to the
reference's ``repro.core.hashing``.

Two levels:

  1. per-leaf digest: the leaf's canonical little-endian words (one per
     element; 8-byte elements split into lo, hi; bool as uint8) are mixed
     with an order-sensitive multiply-xor in wrapping 64-bit arithmetic and
     folded with XOR;
  2. each digest, xor'd with an FNV-1a salt of the leaf's path string
     (``.vectors`` for a dataclass field, ``[0]`` for a tuple entry — the
     reference's ``keystr``), its numpy dtype name and its shape, enters a
     sequential FNV-1a chain in field order.

Words are a leaf's bits: float16, bfloat16, float32 and float64 leaves
are read as the integers of their width, never converted by value.
``hash_pytree`` works on the host (numpy); ``hash_state_device`` computes
the same value with the word mixing done by torch on the tensors' own
device — int64 wraparound multiply and xor give the uint64 bits, and the
XOR reduction is a pairwise fold.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, List, Tuple

import numpy as np
import torch

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
MIX_GOLDEN = 0x9E3779B97F4A7C15
MIX_PRIME = 0xC2B2AE3D27D4EB4F
_U64 = (1 << 64) - 1


def _s64(x: int) -> int:
    """uint64 constant → the int64 with the same bits."""
    return x - (1 << 64) if x >= (1 << 63) else x


def _leaves(tree: Any) -> List[Tuple[str, Any]]:
    """(path string, leaf) in the reference's flattening order, with its
    ``keystr`` path: dataclass fields in declaration order (tensor fields
    only), tuple/list entries by index, dict entries in sorted key order;
    None holds no leaf."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [("", tree)]
    if tree is None:
        return []
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += [(f"[{k!r}]{p}", leaf) for p, leaf in _leaves(tree[k])]
        return out
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, str):
                continue  # static metadata (contract_name), not a leaf
            out += [(f".{f.name}{p}", leaf) for p, leaf in _leaves(v)]
        return out
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out += [(f"[{i}]{p}", leaf) for p, leaf in _leaves(v)]
        return out
    raise TypeError(f"unhashable tree node {type(tree)}")


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# the signed integer of each float width: a leaf's words are its bits
_BITS = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
         torch.float32: torch.int32, torch.float64: torch.int64}


def _bits(leaf: torch.Tensor) -> torch.Tensor:
    """A float tensor viewed as the integers of its width (other dtypes as
    they are): the same bytes, without numpy's bfloat16 gap."""
    return leaf.view(_BITS[leaf.dtype]) if leaf.dtype in _BITS else leaf


# --------------------------------------------------------------------------- #
# host path (numpy uint64)
# --------------------------------------------------------------------------- #


def _host_words(flat: np.ndarray) -> np.ndarray:
    """The uint64 words of a flat array's little-endian elements: one per
    element, 8-byte elements split into (lo, hi)."""
    size = flat.dtype.itemsize
    if size not in (1, 2, 4, 8):
        raise TypeError(f"unhashable dtype {flat.dtype}")
    w = flat.view(f"<u{size}").astype(np.uint64)
    if size == 8:
        return np.stack([w & np.uint64(0xFFFFFFFF), w >> np.uint64(32)],
                        axis=-1).reshape(-1)
    return w


def _mix_fold_host(words: np.ndarray, offset: int = 0) -> int:
    """The XOR fold of the mixed words, word i of ``words`` at position
    offset + i."""
    if words.size == 0:
        return 0
    with np.errstate(over="ignore"):
        mixed = np.arange(offset, offset + words.shape[0], dtype=np.uint64)
        mixed *= np.uint64(MIX_GOLDEN)
        mixed ^= words
        mixed *= np.uint64(MIX_PRIME)
        return int(np.bitwise_xor.reduce(mixed))


_HOST_CHUNK = 1 << 16  # elements per mixing step: the temporaries stay in
# cache, several times faster on a large tree than one step


def _digest_host(arr: np.ndarray) -> int:
    """A leaf's digest: its words mixed in slices of _HOST_CHUNK elements
    (the fold is an XOR, so the slices' folds combine)."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    if flat.dtype == np.bool_:
        flat = flat.view(np.uint8)
    per = 2 if flat.dtype.itemsize == 8 else 1
    acc = 0
    for start in range(0, flat.size, _HOST_CHUNK):
        acc ^= _mix_fold_host(_host_words(flat[start:start + _HOST_CHUNK]),
                              start * per)
    return acc


def _fnv1a_bytes(data: bytes, h: int = FNV_OFFSET) -> int:
    for ch in data:
        h = ((h ^ ch) * FNV_PRIME) & _U64
    return h


def _leaf_meta_hash(path: str, dtype_name: str, shape) -> int:
    h = _fnv1a_bytes(path.encode())
    h = _fnv1a_bytes(dtype_name.encode(), h)
    for s in shape:
        h = ((h ^ (s & _U64)) * FNV_PRIME) & _U64
    return h


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _fnv_chain(entries) -> int:
    h = FNV_OFFSET
    for e in entries:
        h = ((h ^ (int(e) & _U64)) * FNV_PRIME) & _U64
    return h


def hash_pytree(tree: Any) -> int:
    """Deterministic 64-bit hash of a tree of arrays/tensors, on the host."""
    entries = []
    for path, leaf in _leaves(tree):
        arr = _np(_bits(leaf.detach()) if isinstance(leaf, torch.Tensor)
                  else leaf)
        digest = _digest_host(arr)
        entries.append(digest ^ _leaf_meta_hash(path, _dtype_name(leaf),
                                                arr.shape))
    return _fnv_chain(entries)


def digest_bytes(data: bytes) -> int:
    """Order-sensitive 64-bit digest of a byte string (zero-padded to
    8-byte words, mix-folded, salted with an FNV hash of the length)."""
    pad = (-len(data)) % 8
    words = np.frombuffer(data + b"\0" * pad, dtype="<u8").astype(np.uint64)
    return _mix_fold_host(words) ^ _fnv1a_bytes(struct.pack("<Q", len(data)))


# --------------------------------------------------------------------------- #
# device path (torch int64 with wraparound)
# --------------------------------------------------------------------------- #

_CHUNK = 1 << 26  # words per mixing step (bounds the temporaries)


def _device_words(leaf: torch.Tensor) -> torch.Tensor:
    flat = leaf.reshape(-1)
    if flat.dtype == torch.bool:
        return flat.to(torch.int64)
    itemsize = flat.element_size()
    w = _bits(flat).to(torch.int64)
    if itemsize == 8:
        lo = w & 0xFFFFFFFF
        hi = (w >> 32) & 0xFFFFFFFF
        return torch.stack([lo, hi], dim=-1).reshape(-1)
    if itemsize in (1, 2, 4):
        return w & ((1 << (8 * itemsize)) - 1)
    raise TypeError(f"unhashable dtype {leaf.dtype}")


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros(1)])
        half = x.shape[0] // 2
        x = x[:half] ^ x[half:]
    return x


def _mix_fold_device(leaf: torch.Tensor) -> int:
    flat = leaf.detach().reshape(-1)
    if flat.numel() == 0:
        return 0
    per = 2 if flat.element_size() == 8 and flat.dtype != torch.bool else 1
    acc = torch.zeros(1, dtype=torch.int64, device=flat.device)
    step = _CHUNK // per
    for start in range(0, flat.numel(), step):
        words = _device_words(flat[start:start + step])
        idx = torch.arange(start * per, start * per + words.shape[0],
                           dtype=torch.int64, device=flat.device)
        mixed = (words ^ (idx * _s64(MIX_GOLDEN))) * _s64(MIX_PRIME)
        acc = acc ^ _xor_fold(mixed)
    return int(acc.item()) & _U64


def hash_state_device(tree: Any) -> int:
    """``hash_pytree`` with the word mixing on the tensors' device; returns
    the same value for the same tree."""
    entries = []
    for path, leaf in _leaves(tree):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        digest = _mix_fold_device(t)
        entries.append(digest ^ _leaf_meta_hash(path, _dtype_name(leaf),
                                                tuple(t.shape)))
    return _fnv_chain(entries)


def live_content(state) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ids, vectors, meta) of the live rows sorted by external id."""
    live = torch.nonzero(state.valid).reshape(-1)
    order = live[torch.argsort(state.ids[live], stable=True)]
    return state.ids[order], state.vectors[order], state.meta[order]


def content_hash(state) -> int:
    """Layout-invariant hash of a memory's live content: the live rows
    sorted by external id, as the tuple ``(ids, vectors, meta)``. Gathered
    on the state's device, hashed like ``hash_pytree``."""
    return hash_state_device(live_content(state))
