"""Memory-augmented serving engine: the flat, in-memory substrate.

The port of ``repro.serve.engine`` for one shard, no durability, no
replicas and no network: the paper's §5.3 boundary and the audit trail.

  embedding (float32) ──boundary.normalize──▶ INSERT log ──bulk_apply──▶ state
  query (float32)     ──boundary.admit_query──▶ planned exact / HNSW /
                                               coarse (int8 code table) k-NN

The engine takes the float32 embeddings ``[B, d]`` that the reference
engine's embedder produces; everything after that point follows the
reference step for step (id allocation, canonical batch logs, the re-link
schedule, ``relink_ts`` and ``graph_gen``, the code table's lazy build,
refresh and drop), so the same embeddings give the same ``state_hash``,
``memory_hash`` and ``retrieval_hash``. The LM that
produces embeddings, and ``generate``, arrive with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (boundary, codes, commands, hashing, hnsw,
                              machine, query)
from repro_torch.core.contracts import DEFAULT_CONTRACT, PrecisionContract
from repro_torch.core.state import MemoryState, init_state, resolve_device


@dataclasses.dataclass
class ServeConfig:
    """The reference's field names. This slice serves one flat in-memory
    shard with its compressed tier (``ef_coarse``, ``route="coarse"``); the
    sharded, durable, replicated and networked fields raise when set."""
    capacity: int = 4096
    retrieve_k: int = 4
    max_new_tokens: int = 32
    s_cache: int = 512
    contract: PrecisionContract = DEFAULT_CONTRACT
    context_tokens: int = 32
    shards: int = 1
    hosts: Optional[List[str]] = None
    route: str = "auto"
    ef: int = 64
    ef_coarse: int = 0
    exact_threshold: int = 1024
    use_kernel: bool = False
    durable_dir: Optional[str] = None
    checkpoint_every: int = 0
    retain_snapshots: int = 0
    group_commit: Optional[Any] = None
    compaction: Optional[Any] = None
    relink: Optional[hnsw.RelinkPolicy] = None
    replicas: int = 0
    follow: Optional[Any] = None


_NOT_SERVED = {  # field: (value meaning "unset", the slice that serves it)
    "shards": (1, "sharding"), "hosts": (None, "network"),
    "durable_dir": (None, "durability"), "checkpoint_every": (0, "durability"),
    "retain_snapshots": (0, "durability"), "group_commit": (None, "durability"),
    "compaction": (None, "durability"), "replicas": (0, "replication"),
    "follow": (None, "replication"),
}


class MemoryAugmentedEngine:
    def __init__(self, d_model: int, serve_cfg: ServeConfig, *, device=None):
        for name, (unset, slice_name) in _NOT_SERVED.items():
            if getattr(serve_cfg, name) != unset:
                raise NotImplementedError(
                    f"ServeConfig.{name} is served by the {slice_name} slice "
                    f"of the port, not by the flat in-memory engine")
        self.device = resolve_device(device)
        self.d_model = d_model
        self.sc = serve_cfg
        self.memory: MemoryState = init_state(
            serve_cfg.capacity, d_model, contract=serve_cfg.contract,
            device=self.device)
        self.log = commands.empty_log(d_model, serve_cfg.contract,
                                      device=self.device)
        self._next_id = 0
        self.last_plan: Optional[query.QueryPlan] = None
        self.graph_gen = 0
        self.relink_ts: List[int] = []
        self._deletes_since_relink = 0
        self._cmds_since_relink_check = 0
        # compressed tier (DESIGN.md §10): built on the first coarse read,
        # then refreshed after every insert batch and dropped on delete;
        # always equal to codes.build(self.memory)
        self._code_table: Optional[codes.CodeTable] = None

    def _as_f32(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    def _cursor(self) -> int:
        return int(self.memory.version)

    def live_count(self) -> int:
        return int(self.memory.count)

    # ------------------------------------------------------------------ #
    # WRITE path
    # ------------------------------------------------------------------ #

    def insert_documents(self, embeddings) -> List[int]:
        """float32 embeddings [N, d] → ids, through the boundary and one
        canonical INSERT batch applied with ``machine.bulk_apply``."""
        emb = self._as_f32(embeddings)
        n = emb.shape[0]
        if n == 0:
            return []
        raw = boundary.normalize_embedding(emb, self.sc.contract)
        ids = torch.arange(self._next_id, self._next_id + n, dtype=torch.int64,
                           device=self.device)
        self._next_id += n
        batch_log = commands.insert_batch(ids, raw, self.sc.contract)
        self.log = self.log.concat(batch_log)
        self.memory = machine.bulk_apply(self.memory, batch_log)
        self._refresh_code_tables(ids)
        self._cmds_since_relink_check += n
        self._maybe_relink()
        return ids.cpu().tolist()

    def delete_documents(self, doc_ids) -> int:
        """Delete by id with one canonical DELETE batch; unknown ids are
        no-ops that still advance logical time. Returns rows tombstoned."""
        if len(doc_ids) == 0:
            return 0
        ids = torch.tensor(sorted(int(i) for i in doc_ids), dtype=torch.int64,
                           device=self.device)
        batch_log = commands.delete_batch(ids, self.d_model, self.sc.contract)
        self.log = self.log.concat(batch_log)
        before = self.live_count()
        self.memory = machine.bulk_apply(self.memory, batch_log)
        removed = before - self.live_count()
        # deletes touch layout-dependent slots; the lazy rebuild is a pure
        # function of the live rows, so it is always bit-identical
        self._code_table = None
        self._deletes_since_relink += removed
        self._cmds_since_relink_check += len(batch_log)
        self._maybe_relink()
        return removed

    # ------------------------------------------------------------------ #
    # compressed tier: the code table (DESIGN.md §10)
    # ------------------------------------------------------------------ #

    def _ensure_code_tables(self) -> None:
        """Build the code table from the live state if there is none."""
        if self._code_table is None:
            self._code_table = codes.build(self.memory)

    def _refresh_code_tables(self, inserted_ids: torch.Tensor) -> None:
        """After an insert batch, once a table exists: re-encode the slots
        that hold this batch's ids (engine writes are fresh INSERTs, so
        those are exactly the touched slots); a param drift rebuilds
        inside ``codes.refresh``."""
        if self._code_table is None:
            return
        touched = torch.nonzero(torch.isin(self.memory.ids, inserted_ids)
                                & self.memory.valid).reshape(-1)
        self._code_table = codes.refresh(self._code_table, self.memory,
                                         touched)

    def _coarse_enabled(self) -> bool:
        """Whether the engine serves the compressed tier (the reference's
        durable mode checkpoints the code table only then)."""
        return self.sc.ef_coarse > 0 or self.sc.route == query.ROUTE_COARSE

    # ------------------------------------------------------------------ #
    # graph maintenance: scheduled deterministic re-link
    # ------------------------------------------------------------------ #

    def _maybe_relink(self) -> None:
        pol = self.sc.relink
        if pol is None or self._cmds_since_relink_check < pol.check_every:
            return
        self._cmds_since_relink_check = 0
        dead = self._deletes_since_relink
        live = self.live_count()
        if dead < pol.min_deletes or dead < pol.dead_ratio * (dead + live):
            return
        self.relink_now()

    def relink_now(self) -> int:
        """Re-link the graph from its live rows now; records the cursor on
        ``relink_ts`` so ``replay_log_fresh`` can reproduce it. The code
        table stays: the graph is not in it."""
        t = self._cursor()
        self.memory = hnsw.relink(self.memory)
        self.relink_ts.append(t)
        self.graph_gen = len(self.relink_ts)
        self._deletes_since_relink = 0
        return t

    # ------------------------------------------------------------------ #
    # READ path
    # ------------------------------------------------------------------ #

    def retrieve(self, query_embeddings, k: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """float32 queries [B, d] → (ids [B, k], scores [B, k]), on the
        route the planner picks from static facts (``last_plan``)."""
        k = k or self.sc.retrieve_k
        self.flush()
        emb = self._as_f32(query_embeddings)
        q_raw = boundary.admit_query(emb, self.sc.contract)
        plan = query.plan_query(
            self.live_count(), k, self.sc.ef, use_kernel=self.sc.use_kernel,
            exact_threshold=self.sc.exact_threshold, route=self.sc.route,
            ef_coarse=self.sc.ef_coarse, dim=self.d_model,
            graph_gen=self.graph_gen)
        self.last_plan = plan
        if plan.route == query.ROUTE_COARSE:
            self._ensure_code_tables()
        ids, scores = query.execute_plan(self.memory, q_raw, k, plan,
                                         codes=self._code_table)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def retrieval_hash(self, query_embeddings, k: Optional[int] = None) -> int:
        ids, scores = self.retrieve(query_embeddings, k)
        return query.retrieval_hash(ids, scores)

    def flush(self) -> int:
        """Nothing is buffered in memory-only mode: returns the cursor."""
        return self._cursor()

    # ------------------------------------------------------------------ #
    # audit / replay
    # ------------------------------------------------------------------ #

    def memory_hash(self) -> int:
        """The layout-invariant live-content hash."""
        return hashing.content_hash(self.memory)

    def state_hash(self) -> int:
        """``hash_pytree`` of the state (computed on its device)."""
        return hashing.hash_state_device(self.memory)

    def replay_log_fresh(self) -> int:
        """Re-apply the audit log to S_0 with the one-command-at-a-time
        ``machine.replay``, interleaving ``hnsw.relink`` at the recorded
        cursors; must equal ``state_hash()``."""
        st = init_state(self.sc.capacity, self.d_model,
                        contract=self.sc.contract, device=self.device)
        pos = 0
        for t in self.relink_ts:
            st = machine.replay(st, self.log.slice(pos, t))
            st = hnsw.relink(st)
            pos = t
        st = machine.replay(st, self.log.slice(pos, len(self.log)))
        return hashing.hash_state_device(st)
