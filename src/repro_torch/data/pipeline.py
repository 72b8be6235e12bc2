"""Deterministic, resumable data pipeline (the port of
``repro.data.pipeline``: numpy, byte for byte the same batches).

The batch served at step t is a pure function of (seed, step, dp_rank), so

  * restarts resume mid-epoch bit-identically (a checkpoint stores only
    ``step``);
  * elastic re-sharding (a dp_size change) re-partitions the SAME global
    order;
  * shuffling is a Feistel permutation over [0, N) — integer-only,
    stateless, invertible, no shuffle buffer to checkpoint.

Sources: a synthetic LM stream (deterministic token soup with local
structure, so loss curves are meaningful) or a memory-mapped int32 token
file.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


# --------------------------------------------------------------------------- #
# Feistel permutation over [0, n): deterministic stateless shuffle
# --------------------------------------------------------------------------- #


def _feistel_round(left: np.ndarray, right: np.ndarray, key: int) -> tuple:
    mixed = (right.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             ^ np.uint64(key)) * np.uint64(0xC2B2AE3D27D4EB4F)
    mixed = (mixed >> np.uint64(29)) ^ mixed
    return right, left ^ (mixed & np.uint64(0xFFFFFFFF))


def feistel_permute(idx: np.ndarray, n: int, seed: int, rounds: int = 4
                    ) -> np.ndarray:
    """Map indices → permuted indices over [0, n). Cycle-walking Feistel:
    bijective for any n, pure integer ops ⇒ platform-invariant."""
    assert n > 0
    bits = max(2, int(np.ceil(np.log2(n))))
    half = (bits + 1) // 2
    mask = np.uint64((1 << half) - 1)

    def encrypt(x: np.ndarray) -> np.ndarray:
        left = (x >> np.uint64(half)) & mask
        right = x & mask
        for r in range(rounds):
            left, right = _feistel_round(left, right, seed * 1000003 + r)
            left &= mask
            right &= mask
        return (left << np.uint64(half)) | right

    out = idx.astype(np.uint64)
    domain = np.uint64(1) << np.uint64(2 * half)
    result = encrypt(out)
    # cycle-walk values that landed outside [0, n)
    for _ in range(64):  # P(escape) halves each round; 64 is overkill-safe
        bad = result >= n
        if not bad.any():
            break
        result = np.where(bad, encrypt(result), result)
    return result.astype(np.int64)


# --------------------------------------------------------------------------- #
# pipeline
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    num_documents: int = 1 << 20   # synthetic corpus size (documents)
    source: str = "synthetic"      # synthetic | file
    token_file: Optional[str] = None


class DeterministicPipeline:
    """batch(step, dp_rank, dp_size) → {'tokens','labels'} int32 arrays."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.source == "file":
            assert cfg.token_file, "file source needs token_file"
            self._tokens = np.memmap(cfg.token_file, dtype=np.int32, mode="r")
            self._n_docs = len(self._tokens) // (cfg.seq_len + 1)
        else:
            self._tokens = None
            self._n_docs = cfg.num_documents

    # ------------------------------------------------------------------ #
    def _doc_ids_for(self, step: int, dp_rank: int, dp_size: int) -> np.ndarray:
        """Global sample order is permutation(seed, epoch); rank r takes the
        contiguous slice [r·b_local, (r+1)·b_local) of each global batch —
        identical global order for ANY dp_size (elasticity invariant)."""
        b = self.cfg.global_batch
        assert b % dp_size == 0, (b, dp_size)
        b_local = b // dp_size
        start = step * b + dp_rank * b_local
        linear = np.arange(start, start + b_local, dtype=np.int64)
        epoch = linear // self._n_docs
        within = linear % self._n_docs
        out = np.empty_like(within)
        for e in np.unique(epoch):
            m = epoch == e
            out[m] = feistel_permute(within[m], self._n_docs,
                                     self.cfg.seed * 7919 + int(e))
        return out

    def _synthesize(self, doc_ids: np.ndarray) -> np.ndarray:
        """Deterministic 'token soup' with Markov-ish structure: token t+1
        depends on (doc hash, token t) so models can actually learn."""
        L = self.cfg.seq_len + 1
        V = self.cfg.vocab_size
        n = len(doc_ids)
        toks = np.empty((n, L), dtype=np.int64)
        state = (doc_ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
        cur = (state >> np.uint64(33)) % np.uint64(V)
        toks[:, 0] = cur
        for t in range(1, L):
            state = (state ^ cur) * np.uint64(0xC2B2AE3D27D4EB4F) + np.uint64(t)
            nxt = ((state >> np.uint64(31)) ^ state) % np.uint64(V)
            # 75% markov-predictable continuation, 25% "noise"
            predictable = ((state >> np.uint64(13)) & np.uint64(3)) != 0
            cont = (cur * np.uint64(31) + np.uint64(7)) % np.uint64(V)
            cur = np.where(predictable, cont, nxt)
            toks[:, t] = cur
        return toks.astype(np.int32)

    def batch(self, step: int, dp_rank: int = 0, dp_size: int = 1
              ) -> Dict[str, np.ndarray]:
        doc_ids = self._doc_ids_for(step, dp_rank, dp_size)
        if self._tokens is not None:
            L = self.cfg.seq_len + 1
            rows = np.stack([
                self._tokens[i * L:(i + 1) * L] for i in doc_ids
            ]).astype(np.int32)
        else:
            rows = self._synthesize(doc_ids)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
