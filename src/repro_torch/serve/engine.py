"""Memory-augmented serving engine: the flat substrate, in memory or durable.

The port of ``repro.serve.engine`` for one shard, no replicas and no
network: the paper's §5.3 boundary, the audit trail and durability.

  embedding (float32) ──boundary.normalize──▶ INSERT log ──bulk_apply──▶ state
  query (float32)     ──boundary.admit_query──▶ planned exact / HNSW /
                                               coarse (int8 code table) k-NN

The engine takes the float32 embeddings ``[B, d]`` that the reference
engine's embedder produces; everything after that point follows the
reference step for step (id allocation, canonical batch logs, the re-link
schedule, ``relink_ts`` and ``graph_gen``, the code table's lazy build,
refresh and drop), so the same embeddings give the same ``state_hash``,
``memory_hash`` and ``retrieval_hash``. The LM that produces embeddings,
and ``generate``, arrive with a later slice.

Durable mode (``durable_dir``, DESIGN.md §5-§7) follows the reference too:
every ingested batch is WAL-appended to a ``DurableStore`` before its
effects are visible (or, with ``group_commit``, buffered in a
``GroupCommitWriter`` whose pending group the read path flushes first —
the sync-on-read barrier); ``checkpoint_every`` cuts background snapshots
of a host copy of the state, one in flight at a time; ``retain_snapshots``
and ``compaction`` age and fold the history; ``recover()`` and
``rollback_to()`` rebuild the state on the engine's device. The reference
engine also keeps a durable doc side table (``docs.sdt``) of LM token
prefixes; this engine has no tokens, so the table waits for the LM slice.
It is a cache, not state, so no hash depends on it.
"""
from __future__ import annotations

import dataclasses
import pathlib
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (boundary, codes, commands, hashing, hnsw,
                              machine, query, snapshot)
from repro_torch.core import wal as wal_lib
from repro_torch.core.contracts import DEFAULT_CONTRACT, PrecisionContract
from repro_torch.core.durability import DurableStore
from repro_torch.core.state import MemoryState, init_state, resolve_device


@dataclasses.dataclass
class ServeConfig:
    """The reference's field names. This slice serves one flat shard, in
    memory or durable, with its compressed tier (``ef_coarse``,
    ``route="coarse"``); the sharded, replicated and networked fields raise
    when set."""
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
    group_commit: Optional[wal_lib.GroupCommitPolicy] = None
    compaction: Optional[wal_lib.CompactionPolicy] = None
    relink: Optional[hnsw.RelinkPolicy] = None
    replicas: int = 0
    follow: Optional[Any] = None


_NOT_SERVED = {  # field: (value meaning "unset", the slice that serves it)
    "shards": (1, "sharding"), "hosts": (None, "network"),
    "replicas": (0, "replication"), "follow": (None, "replication"),
}


class MemoryAugmentedEngine:
    def __init__(self, d_model: int, serve_cfg: ServeConfig, *, device=None):
        for name, (unset, slice_name) in _NOT_SERVED.items():
            if getattr(serve_cfg, name) != unset:
                raise NotImplementedError(
                    f"ServeConfig.{name} is served by the {slice_name} slice "
                    f"of the port, not by the flat engine")
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

        self.durable: Optional[DurableStore] = None
        self._group: Optional[wal_lib.GroupCommitWriter] = None
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None
        self._last_ckpt_t = 0
        self._closed = False
        if serve_cfg.durable_dir is not None:
            self.durable = DurableStore(
                serve_cfg.durable_dir, self.memory,
                compaction=serve_cfg.compaction, device=self.device)
            if serve_cfg.group_commit is not None:
                self._group = wal_lib.GroupCommitWriter(
                    self.durable, serve_cfg.group_commit)
        elif (serve_cfg.group_commit is not None
              or serve_cfg.compaction is not None):
            # an operator who set a durability policy believes ingest is
            # durable: silently running non-durable would be the worst
            # possible reading of the config
            raise ValueError(
                "group_commit/compaction policies need durable_dir set")

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
        self._make_durable(batch_log)
        self.log = self.log.concat(batch_log)
        self.memory = machine.bulk_apply(self.memory, batch_log)
        self._refresh_code_tables(ids)
        self._cmds_since_relink_check += n
        self._maybe_relink()
        self._maybe_checkpoint()
        return ids.cpu().tolist()

    def delete_documents(self, doc_ids) -> int:
        """Delete by id with one canonical DELETE batch; unknown ids are
        no-ops that still advance logical time. Returns rows tombstoned."""
        if len(doc_ids) == 0:
            return 0
        ids = torch.tensor(sorted(int(i) for i in doc_ids), dtype=torch.int64,
                           device=self.device)
        batch_log = commands.delete_batch(ids, self.d_model, self.sc.contract)
        self._make_durable(batch_log)
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
        self._maybe_checkpoint()
        return removed

    def _make_durable(self, batch_log: commands.CommandLog) -> None:
        """WAL-first: the commands are durable before their effects are
        visible, so a crash can lose at most un-acked work. Under group
        commit the batch buffers toward one fsync per group and must not be
        readable until then: the read path's ``flush()`` barrier restores
        WAL-first ordering at the moment of first observation."""
        if self._group is not None:
            self._group.submit(batch_log)
        elif self.durable is not None:
            self.durable.append(batch_log)

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

    # ------------------------------------------------------------------ #
    # durability: background checkpoints + crash recovery (DESIGN.md §5, §7)
    # ------------------------------------------------------------------ #

    def flush(self) -> int:
        """Force any pending group-commit batch durable; returns the durable
        WAL cursor (the memory cursor in memory-only mode). The read path
        calls this before serving — the sync-on-read barrier — and it is
        the ack point for upstream callers under group commit."""
        if self._group is not None:
            return self._group.flush()
        return self.durable.t if self.durable is not None else self._cursor()

    def close(self) -> None:
        """Flush pending ingest, join background work and stop the group-
        commit writer (and its timer thread). Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.flush()
        self.wait_durable()
        if self._group is not None:
            self._group.close()

    def wait_durable(self) -> None:
        """Join any in-flight background checkpoint; re-raise its error."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        if self._ckpt_error is not None:
            err, self._ckpt_error = self._ckpt_error, None
            raise RuntimeError("background checkpoint failed") from err

    def _require_durable(self) -> DurableStore:
        if self.durable is None:
            raise RuntimeError("no durable_dir configured")
        return self.durable

    def checkpoint(self) -> Dict[str, int]:
        """Synchronously cut an incremental snapshot at the current cursor;
        returns the snapshot stats (with retention's when configured)."""
        store = self._require_durable()
        self.flush()  # a snapshot may only cover durable commands
        self.wait_durable()
        stats = store.checkpoint(self.memory.to("cpu"))
        self._last_ckpt_t = self._cursor()
        if self.sc.retain_snapshots > 0:
            stats.update(store.retain(self.sc.retain_snapshots))
        self._checkpoint_code_tables()
        return stats

    def _maybe_checkpoint(self) -> None:
        if (self.durable is None or self.sc.checkpoint_every <= 0
                or self._cursor() - self._last_ckpt_t
                < self.sc.checkpoint_every):
            return
        self.flush()  # a snapshot may only cover durable commands
        self.wait_durable()  # one in flight at a time; surfaces past errors
        host_state = self.memory.to("cpu")
        self._last_ckpt_t = self._cursor()
        store = self.durable

        def work():
            try:
                store.checkpoint(host_state)
                if self.sc.retain_snapshots > 0:
                    store.retain(self.sc.retain_snapshots)
            except BaseException as e:  # noqa: BLE001 — re-raised on wait
                self._ckpt_error = e

        self._ckpt_thread = threading.Thread(target=work, daemon=True)
        self._ckpt_thread.start()

    def _checkpoint_code_tables(self) -> None:
        """Cut the code table's content-addressed manifest beside the state
        snapshots (``<durable_dir>/codes/``), keeping only the newest one
        and the chunks it references. Recovery does not read it (the table
        is rebuilt from the recovered state); it is the audit / warm-start
        artifact, equal bit for bit to the rebuild."""
        if self.sc.durable_dir is None or not self._coarse_enabled():
            return
        self._ensure_code_tables()
        t = self._cursor()
        cdir = pathlib.Path(self.sc.durable_dir) / "codes"
        store = snapshot.ChunkStore(cdir / "chunks")
        manifest, _ = codes.snapshot_table_v2(self._code_table, t, store)
        path = cdir / f"codes_{0:04d}_t{t:020d}.mft"
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(manifest)
        tmp.replace(path)
        keep_keys = set(codes.table_manifest_chunk_keys(manifest))
        for old in cdir.glob("codes_*.mft"):
            if old != path:
                old.unlink()
        for key in store.keys():
            if key not in keep_keys:
                store.delete(key)

    def _reload_audit_logs(self, t: int) -> None:
        """Rebuild the in-memory audit trail from the durable WAL after
        recover/rollback, if retention kept the full history."""
        try:
            self.log = self.durable.wal.read_range(0, t, device=self.device)
        except ValueError:
            self.log = commands.empty_log(self.d_model, self.sc.contract,
                                          device=self.device)

    def _reload_serving_caches(self) -> None:
        """Next-id allocation from the live rows of the recovered state."""
        live = self.memory.ids[self.memory.valid]
        self._next_id = int(live.max()) + 1 if live.numel() else 0

    def recover(self) -> Tuple[int, int]:
        """Rebuild memory from the durable store after a crash: nearest
        snapshot + WAL tail, bit-identical to replaying the durable prefix,
        on the engine's device. Returns (t, state hash)."""
        store = self._require_durable()
        self.flush()  # a live engine recovering: don't drop acked work
        self.wait_durable()
        state, h, t = store.recover()
        self.memory = state
        self._code_table = None  # rebuilt from the recovered state on the
        self._last_ckpt_t = t    # first coarse read (pure function of it)
        self._reload_audit_logs(t)
        self._reload_serving_caches()
        return t, self._canonicalize_graph(t, h)

    def rollback_to(self, t: int) -> Tuple[int, int]:
        """Roll the durable history AND the serving state back to logical
        time ``t``: snapshots and WAL records above ``t`` are dropped and
        memory is restored at ``t``. Returns (t, state hash)."""
        store = self._require_durable()
        self.flush()
        self.wait_durable()
        store.rollback_to(t)
        state, h = store.restore_at(t)
        self.memory = state
        self._code_table = None
        self._last_ckpt_t = t
        self._reload_audit_logs(t)
        self._reload_serving_caches()
        return t, self._canonicalize_graph(t, h)

    def _canonicalize_graph(self, t: int, h: int) -> int:
        """After a restore the graph is the pure-replay graph (the WAL holds
        commands only). With a re-link policy, one re-link puts every
        recovered engine on the same footing (``relink_ts=[t]``,
        ``graph_gen=1``) and the returned hash is the post-re-link
        ``state_hash()``; without one the restore is returned untouched."""
        self._deletes_since_relink = 0
        self._cmds_since_relink_check = 0
        if self.sc.relink is None:
            self.relink_ts = []
            self.graph_gen = 0
            return h
        self.memory = hnsw.relink(self.memory)
        self.relink_ts = [t]
        self.graph_gen = 1
        return self.state_hash()

    # ------------------------------------------------------------------ #
    # audit / replay
    # ------------------------------------------------------------------ #

    def memory_hash(self) -> int:
        """The layout-invariant live-content hash."""
        return hashing.content_hash(self.memory)

    def state_hash(self) -> int:
        """``hash_pytree`` of the state (computed on its device)."""
        return hashing.hash_state_device(self.memory)

    def snapshot_bytes(self) -> bytes:
        """The state as one v1 snapshot blob (``snapshot.restore_bytes``)."""
        return snapshot.snapshot_bytes(self.memory)

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
