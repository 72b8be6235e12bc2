"""Memory-augmented serving engine: an LM, the boundary and the memory —
flat, sharded or networked, in memory or durable, with verified read
replicas.

The port of ``repro.serve.engine``: the paper's §5.3 boundary, the audit
trail, durability, sharding, shard hosts over the wire and read replicas.

  tokens ──LM (float, bf16 on the card)──▶ pooled embedding (float32)
  embedding ──boundary.normalize──▶ INSERT log ──bulk_apply──▶ state
  query     ──boundary.admit_query──▶ planned exact / HNSW / coarse
                                       (int8 code table) k-NN

Two forms share the class:

* ``MemoryAugmentedEngine(cfg, params, serve_cfg)`` — the reference's
  engine: documents and prompts are token arrays. ``_embed_batch`` runs the
  LM's stack (no caches) and pools the final hidden states (float32 mean
  over positions); ``generate`` decodes greedily, the prompt prefixed with
  the top hit's tokens. Nothing before the boundary is bit-reproducible
  across devices (the card's bf16 LM does not equal the CPU's); everything
  from ``normalize_embedding`` on is.
* ``MemoryAugmentedEngine(d_model, serve_cfg)`` — the embedding engine:
  the caller brings float32 embeddings ``[N, d_model]`` (what the
  reference's embedder produces) and there is no LM and no ``generate``.

Everything after the embedding follows the reference step for step (id
allocation, canonical batch logs, the re-link schedule, ``relink_ts`` and
``graph_gen``, the code table's lazy build, refresh and drop), so the same
embeddings give the same ``state_hash``, ``memory_hash`` and
``retrieval_hash`` in both forms and both packages.

Durable mode (``durable_dir``, DESIGN.md §5-§7) follows the reference too:
every ingested batch is WAL-appended to a ``DurableStore`` before its
effects are visible (or, with ``group_commit``, buffered in a
``GroupCommitWriter`` whose pending group the read path flushes first —
the sync-on-read barrier); ``checkpoint_every`` cuts background snapshots
of a host copy of the state, one in flight at a time; ``retain_snapshots``
and ``compaction`` age and fold the history; ``recover()`` and
``rollback_to()`` rebuild the state on the engine's device. The LM engine
keeps its doc cache (token prefixes by id) in a durable side table,
``docs.sdt``, whose records are synced before the commands they describe
(through the writer's ``pre_flush`` under group commit), so a recovered
engine generates with warm context and a live id never outruns its
tokens. It is a cache, not state: no hash depends on it.

Three serving modes share the class, as in the reference (DESIGN.md
§7-§9):

* ``ServeConfig(shards=1)``: a flat MemoryState, ``DurableStore``
  durability, planner-routed reads.
* ``ServeConfig(shards=N)``: a shard-major sharded-layout MemoryState
  (``distributed.init_sharded_host``; ``capacity`` is the total, split
  evenly), each batch routed once (``distributed.route_commands``) for
  the per-shard audit logs, ``shard_wal.bulk_apply_sharded`` and the
  store; durability through a ``ShardedDurableStore``; reads fanned out
  per shard and merged (``query.sharded_host_query``), with one code table
  per shard. Fed the same embeddings, both modes allocate the same ids
  and report one ``memory_hash()`` and one exact-route
  ``retrieval_hash()``; ``state_hash()`` is the within-layout hash.
* ``ServeConfig(hosts=["addr:port", ...])``: the sharded layout with
  durability and reads fanned out to per-process shard hosts
  (``net.ShardHost`` behind ``net.ShardServer``) over the wire protocol,
  through one ``net.RemoteShardClient`` each; the engine's local sharded
  state stays as the audit twin, so every remote append, checkpoint and
  answer is checkable against it by hash.

``replicas=k`` attaches k verified log-shipping read replicas per shard
(``net.ReplicaStore``: followers of the engine's own store(s), or of the
shard hosts), and ``follow=net.replica.FollowerPolicy(...)`` runs each on a
background tailer. A read is served by the replica slot its query bytes
pick when every chosen replica has proved the flush cursor (read-your-
writes), else by the primary; ``last_plan.served_by`` says which.
"""
from __future__ import annotations

import dataclasses
import pathlib
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import (boundary, codes, commands, distributed,
                              hashing, hnsw, machine, query, search,
                              shard_wal, snapshot)
from repro_torch.core import wal as wal_lib
from repro_torch.core.contracts import DEFAULT_CONTRACT, PrecisionContract
from repro_torch.core.durability import DurableStore, SideTable
from repro_torch.core.shard_wal import ShardedDurableStore
from repro_torch.core.state import MemoryState, init_state, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ServeConfig:
    """The reference's field names and checks. ``hosts`` ("addr:port" of
    one shard host each) needs ``durable_dir`` (the coordinator's merged
    records) and sets ``shards`` when it is left at 1; ``replicas`` needs a
    durable store to follow; ``follow`` needs ``replicas``."""
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


def _host_port(address: str) -> Tuple[str, int]:
    host, port = address.rsplit(":", 1)
    return host, int(port)


class MemoryAugmentedEngine:
    def __init__(self, cfg: Union[ModelConfig, int], params, serve_cfg=None,
                 *, device=None):
        """``(cfg, params, serve_cfg)``: the LM engine, ``params`` a
        ``models.transformer.Transformer`` on the engine's device.
        ``(d_model, serve_cfg)``: the embedding engine."""
        if isinstance(cfg, ModelConfig):
            d_model = cfg.d_model
        else:
            if serve_cfg is not None:
                raise TypeError("the embedding engine takes (d_model, "
                                "serve_cfg)")
            d_model, serve_cfg, cfg, params = int(cfg), params, None, None
        n = serve_cfg.shards
        if n < 1:
            raise ValueError(f"shards must be >= 1, got {n}")
        if serve_cfg.hosts is not None:
            if n == 1:
                n = len(serve_cfg.hosts)
            elif n != len(serve_cfg.hosts):
                raise ValueError(
                    f"shards={n} but {len(serve_cfg.hosts)} hosts given")
            if serve_cfg.durable_dir is None:
                raise ValueError(
                    "networked serving (hosts=[...]) needs durable_dir: the "
                    "coordinator keeps its merged-hash records there")
        if serve_cfg.follow is not None and not serve_cfg.replicas:
            raise ValueError(
                "follow=FollowerPolicy(...) needs replicas > 0: a "
                "follower policy paces read replicas, and there are none")
        if serve_cfg.replicas and serve_cfg.durable_dir is None:
            raise ValueError(
                "replicas=k needs durable_dir: a read replica follows a "
                "durable WAL, and without one there is nothing to tail")
        if serve_cfg.capacity % n:
            raise ValueError(
                f"capacity {serve_cfg.capacity} must divide evenly across "
                f"{n} shards")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        if params is not None and params.embed.device != \
                torch.empty(0, device=self.device).device:
            raise ValueError(
                f"params are on {params.embed.device}, the engine on "
                f"{self.device}: place them where the engine runs")
        self.d_model = d_model
        self.sc = serve_cfg
        self.n_shards = n
        # networked serving uses the sharded layout even at one shard (its
        # durable twin is a fleet of one)
        self._layout_sharded = n > 1 or serve_cfg.hosts is not None
        if not self._layout_sharded:
            self.memory: MemoryState = init_state(
                serve_cfg.capacity, d_model, contract=serve_cfg.contract,
                device=self.device)
        else:
            self.memory = distributed.init_sharded_host(
                n, serve_cfg.capacity // n, d_model,
                contract=serve_cfg.contract, device=self.device)
        # the audit trail: the global command log and, in sharded mode, its
        # routed per-shard twin (what the per-shard WALs hold; after a
        # sharded recover only the per-shard logs are reconstructible)
        self.log = commands.empty_log(d_model, serve_cfg.contract,
                                      device=self.device)
        self._shard_logs: List[commands.CommandLog] = [
            self._empty_log() for _ in range(n)]
        self.docs: Dict[int, np.ndarray] = {}  # id -> token prefix (LM)
        self._next_id = 0
        self.last_plan: Optional[query.QueryPlan] = None
        self.graph_gen = 0
        self.relink_ts: List[int] = []
        self._deletes_since_relink = 0
        self._cmds_since_relink_check = 0
        # compressed tier (DESIGN.md §10): one code table per shard slice
        # (one in flat mode), built on the first coarse read, then refreshed
        # after every insert batch and dropped on delete; always equal to
        # codes.build of each slice
        self._code_tables: Optional[List[codes.CodeTable]] = None

        self.durable = None  # DurableStore | ShardedDurableStore | None
        self._clients = None  # net.RemoteShardClient fleet (hosts mode)
        self._group: Optional[wal_lib.GroupCommitWriter] = None
        self._doc_table: Optional[SideTable] = None
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None
        self._last_ckpt_t = 0
        self._closed = False
        if serve_cfg.durable_dir is not None:
            if serve_cfg.hosts is not None:
                # one client per shard host; the sharded store drives them
                # through the surface local shards expose
                from repro_torch.net.client import (RemoteShardClient,
                                                    SocketTransport)
                self._clients = [
                    RemoteShardClient(SocketTransport(*_host_port(h)),
                                      contract=serve_cfg.contract,
                                      device=self.device)
                    for h in serve_cfg.hosts]
                self.durable = ShardedDurableStore(
                    serve_cfg.durable_dir, backends=self._clients,
                    device=self.device)
            elif not self._layout_sharded:
                self.durable = DurableStore(
                    serve_cfg.durable_dir, self.memory,
                    compaction=serve_cfg.compaction, device=self.device)
            else:
                self.durable = ShardedDurableStore(
                    serve_cfg.durable_dir, self.memory, n_shards=n,
                    compaction=serve_cfg.compaction, device=self.device)
            if cfg is not None:
                # the doc cache's side table: its records are synced before
                # the commands they describe (directly, or in the writer's
                # pre_flush under group commit)
                self._doc_table = SideTable(
                    pathlib.Path(serve_cfg.durable_dir) / "docs.sdt")
            if serve_cfg.group_commit is not None:
                self._group = wal_lib.GroupCommitWriter(
                    self.durable, serve_cfg.group_commit,
                    pre_flush=None if self._doc_table is None
                    else self._doc_table.sync)
        elif (serve_cfg.group_commit is not None
              or serve_cfg.compaction is not None):
            # an operator who set a durability policy believes ingest is
            # durable: silently running non-durable would be the worst
            # possible reading of the config
            raise ValueError(
                "group_commit/compaction policies need durable_dir set")

        # the read pool (DESIGN.md §9): read_replicas[s][i] is the i-th
        # verified follower of shard s (one list in flat mode)
        self.read_replicas: List[List[Any]] = []
        if serve_cfg.replicas:
            self._spawn_replicas(serve_cfg.replicas)
            self._start_followers()

    def _as_f32(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    def _empty_log(self) -> commands.CommandLog:
        return commands.empty_log(self.d_model, self.sc.contract,
                                  device=self.device)

    @property
    def _code_table(self) -> Optional[codes.CodeTable]:
        """The flat engine's code table; a sharded engine keeps one per
        shard in ``_code_tables`` and refuses this single-table view."""
        if self._layout_sharded:
            raise ValueError("a sharded engine has one code table per "
                             "shard: read _code_tables")
        return None if self._code_tables is None else self._code_tables[0]

    def _cursor(self) -> int:
        """The applied-command cursor: flat ``version``, or the common
        per-shard padded cursor (equal at the batch boundaries the engine
        operates at)."""
        return int(obs.host_item(self.memory.version.reshape(-1)[0]))

    def live_count(self) -> int:
        return shard_wal.live_count(self.memory)

    def _genesis_state(self) -> MemoryState:
        """A fresh t=0 state in the engine's layout, on its device."""
        if not self._layout_sharded:
            return init_state(self.sc.capacity, self.d_model,
                              contract=self.sc.contract, device=self.device)
        return distributed.init_sharded_host(
            self.n_shards, self.sc.capacity // self.n_shards, self.d_model,
            contract=self.sc.contract, device=self.device)

    # ------------------------------------------------------------------ #
    # read pool: verified replicas behind the flush barrier (DESIGN.md §9)
    # ------------------------------------------------------------------ #

    def _spawn_replicas(self, k: int) -> None:
        """Attach ``k`` in-process verified followers per shard: of the
        engine's own store(s) through ``LocalPrimary`` in local modes, of
        the shard hosts over their own connections in networked mode. Each
        starts from the t=0 state (its shard slice in sharded layouts) and
        earns its cursor through verify-then-ack catch-up. (The reference
        seeds a respawned pool with the live state, which its replicas
        refuse once the engine is past t=0; a fresh genesis is what its
        catch-up needs.)"""
        from repro_torch.net.replica import LocalPrimary, ReplicaStore
        genesis = self.memory if self._cursor() == 0 \
            else self._genesis_state()
        if not self._layout_sharded:
            primaries = [lambda: LocalPrimary(
                self.durable, state_fn=lambda: self.memory,
                side_table=self._doc_table)]
            geneses = [genesis]
        else:
            if self._clients is not None:
                from repro_torch.net.client import (RemoteShardClient,
                                                    SocketTransport)

                def primary(s):
                    return lambda: RemoteShardClient(
                        SocketTransport(*_host_port(self.sc.hosts[s])),
                        contract=self.sc.contract, device=self.device)
            else:
                def primary(s):
                    return lambda: LocalPrimary(
                        self.durable.shards[s],
                        state_fn=lambda: distributed.shard_slice(
                            self.memory, s, self.n_shards),
                        side_table=self._doc_table)
            primaries = [primary(s) for s in range(self.n_shards)]
            geneses = [distributed.shard_slice(genesis, s, self.n_shards)
                       for s in range(self.n_shards)]
        self.read_replicas = [
            [ReplicaStore(make_primary(), geneses[s], replica_id=s * k + i)
             for i in range(k)]
            for s, make_primary in enumerate(primaries)]

    def _start_followers(self) -> None:
        """One background tailer per replica under ``ServeConfig.follow``
        (DESIGN.md §12); without a policy the pool advances only on
        ``sync_replicas()``."""
        if self.sc.follow is None:
            return
        for pool in self.read_replicas:
            for rep in pool:
                rep.start_following(self.sc.follow)

    def _reset_replicas(self) -> None:
        """Tear the read pool down and respawn it (recover / rollback):
        a pool must never serve a state the current durable history cannot
        prove, so fresh replicas re-earn their cursors."""
        if not self.read_replicas:
            return
        for pool in self.read_replicas:
            for rep in pool:
                rep.close()  # stops the follower thread first
        self.read_replicas = []
        self._spawn_replicas(self.sc.replicas)
        self._start_followers()

    def _pick_replica(self, q_raw: torch.Tensor) -> Optional[int]:
        """The pool slot of a request, from its query bytes (the same query
        always lands on the same slot). The slot must exist on every
        shard's pool, so the usable size is the smallest pool; an empty
        pool returns None and the primary serves."""
        sizes = [len(pool) for pool in self.read_replicas]
        n = min(sizes) if sizes else 0
        if n == 0:
            return None
        return hashing.digest_bytes(obs.host(q_raw).numpy().tobytes()) % n

    def sync_replicas(self, *, max_commands: int = 0) -> int:
        """Catch every replica up to the flush cursor, each slice verified
        against the primary's hash before commit. Returns the largest
        residual lag in the pool: 0 means every replica proved the flush
        cursor."""
        self.flush()
        lag = 0
        for pool in self.read_replicas:
            for rep in pool:
                lag = max(lag, rep.catch_up(max_commands=max_commands))
        return lag

    # ------------------------------------------------------------------ #
    # WRITE path
    # ------------------------------------------------------------------ #

    # ------------------------------------------------------------------ #
    # embedding: pooled final hidden states (pre-head)
    # ------------------------------------------------------------------ #

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), device=self.device)

    @torch.no_grad()
    def _embed_batch(self, tokens) -> torch.Tensor:
        """tokens [B, L] → float32 [B, D] (``transformer.pooled_embedding``).
        Under the moe family a document's embedding depends on its batch
        (the experts' capacity counts the batch's tokens), as in the
        reference."""
        return tf.pooled_embedding(self.params, self._tokens(tokens), self.cfg)

    def _embed(self, x) -> torch.Tensor:
        """Documents or prompts → float32 embeddings: token arrays through
        the LM, or the embedding engine's own float32 input."""
        if self.cfg is None:
            return self._as_f32(x)
        return self._embed_batch(x)

    def _require_lm(self) -> None:
        if self.cfg is None:
            raise ValueError("the embedding engine has no LM: build the "
                             "engine as (cfg, params, serve_cfg)")

    # ------------------------------------------------------------------ #
    # WRITE path
    # ------------------------------------------------------------------ #

    def insert_documents(self, documents) -> List[int]:
        """Documents → ids, through the boundary and one canonical INSERT
        batch applied with ``machine.bulk_apply``. The LM engine takes
        token arrays [N, L] (int32), records each in the doc cache and, in
        durable mode, its side table; the embedding engine takes float32
        embeddings [N, d]."""
        if len(documents) == 0:
            return []
        with obs.span("engine.insert_documents", len(documents)):
            return self._insert_documents(documents)

    def _insert_documents(self, documents) -> List[int]:
        with obs.span("lm.embed"):
            emb = self._embed(documents)
        n = emb.shape[0]
        raw = boundary.normalize_embedding(emb, self.sc.contract)
        ids = torch.arange(self._next_id, self._next_id + n, dtype=torch.int64,
                           device=self.device)
        self._next_id += n
        batch_log = commands.insert_batch(ids, raw, self.sc.contract)
        if self.cfg is not None:
            # doc cache first: its side-table records must be durable no
            # later than the commands they describe, or a crash after a
            # rollback-then-reinsert could recover a live id with stale
            # tokens
            for i, tid in enumerate(range(self._next_id - n, self._next_id)):
                doc = np.asarray(documents[i])
                self.docs[tid] = doc
                if self._doc_table is not None:
                    self._doc_table.put(
                        tid, doc.astype("<i4", copy=False).tobytes())
        self._apply_batch(batch_log)
        self._refresh_code_tables(ids)
        self._cmds_since_relink_check += n
        self._maybe_relink()
        self._maybe_checkpoint()
        return obs.host(ids).tolist()

    def delete_documents(self, doc_ids) -> int:
        """Delete by id with one canonical DELETE batch; unknown ids are
        no-ops that still advance logical time. Returns rows tombstoned."""
        if len(doc_ids) == 0:
            return 0
        ids = torch.tensor(sorted(int(i) for i in doc_ids), dtype=torch.int64,
                           device=self.device)
        batch_log = commands.delete_batch(ids, self.d_model, self.sc.contract)
        before = self.live_count()
        self._apply_batch(batch_log)
        removed = before - self.live_count()
        for tid in ids.cpu().tolist():
            # the doc cache drops now; the side table's record stays — a
            # dead id is never retrieved, and sequential allocation never
            # reuses it
            self.docs.pop(tid, None)
        # deletes touch layout-dependent slots; the lazy rebuild is a pure
        # function of the live rows, so it is always bit-identical
        self._code_tables = None
        self._deletes_since_relink += removed
        self._cmds_since_relink_check += len(batch_log)
        self._maybe_relink()
        self._maybe_checkpoint()
        return removed

    def _apply_batch(self, batch_log: commands.CommandLog) -> None:
        """Make one batch durable, record it on the audit logs and apply it.

        WAL-first: the commands are durable before their effects are
        visible, so a crash can lose at most un-acked work. Under group
        commit the batch buffers toward one fsync per group and must not be
        readable until then: the read path's ``flush()`` barrier restores
        WAL-first ordering at the moment of first observation. In sharded
        mode the batch is routed once, for the store, the per-shard audit
        logs and the apply."""
        routed = None if not self._layout_sharded else \
            distributed.route_commands(batch_log, self.n_shards)
        if self._group is not None:
            self._group.submit(batch_log, routed=routed)
        elif self.durable is not None:
            if self._doc_table is not None:
                self._doc_table.sync()
            if routed is None:
                self.durable.append(batch_log)
            else:
                self.durable.append(batch_log, routed=routed)
        self.log = self.log.concat(batch_log)
        if routed is None:
            self.memory = machine.bulk_apply(self.memory, batch_log)
            return
        for s in range(self.n_shards):
            self._shard_logs[s] = self._shard_logs[s].concat(
                distributed.share(routed, s))
        self.memory = shard_wal.bulk_apply_sharded(
            self.memory, batch_log, self.n_shards, routed=routed)

    # ------------------------------------------------------------------ #
    # compressed tier: the code table (DESIGN.md §10)
    # ------------------------------------------------------------------ #

    def _memory_slices(self) -> List[MemoryState]:
        if not self._layout_sharded:
            return [self.memory]
        return [distributed.shard_slice(self.memory, s, self.n_shards)
                for s in range(self.n_shards)]

    def _ensure_code_tables(self) -> None:
        """Build the per-slice code tables from the live state if there are
        none."""
        if self._code_tables is None:
            self._code_tables = [codes.build(sl)
                                 for sl in self._memory_slices()]

    def _refresh_code_tables(self, inserted_ids: torch.Tensor) -> None:
        """After an insert batch, once tables exist: re-encode the slots
        that hold this batch's ids (engine writes are fresh INSERTs, so
        those are exactly the touched slots); a param drift rebuilds
        inside ``codes.refresh``."""
        if self._code_tables is None:
            return
        tables = []
        for sl, tbl in zip(self._memory_slices(), self._code_tables):
            touched = torch.nonzero(torch.isin(sl.ids, inserted_ids)
                                    & sl.valid).reshape(-1)
            tables.append(codes.refresh(tbl, sl, touched))
        self._code_tables = tables

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
        self.memory = self._relinked(self.memory)
        self.relink_ts.append(t)
        self.graph_gen = len(self.relink_ts)
        self._deletes_since_relink = 0
        return t

    def _relinked(self, state: MemoryState) -> MemoryState:
        if not self._layout_sharded:
            return hnsw.relink(state)
        return shard_wal.relink_sharded(state, self.n_shards)

    # ------------------------------------------------------------------ #
    # READ path
    # ------------------------------------------------------------------ #

    def retrieve(self, queries, k: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Prompts [B, L] int32 (the LM engine) or float32 queries [B, d]
        (the embedding engine) → (ids [B, k], scores [B, k]), on the route
        the planner picks from static facts (``last_plan``)."""
        with obs.span("engine.retrieve", len(queries)):
            return self._retrieve(queries, k or self.sc.retrieve_k)

    def _retrieve(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        # sync-on-read barrier: nothing un-durable is observable, and the
        # cursor it returns is the read-your-writes floor for replica reads
        flush_t = self.flush()
        with obs.span("boundary.admit"):
            emb = self._embed(queries)
            q_raw = boundary.admit_query(emb, self.sc.contract)
        with obs.span("query.plan"):
            plan = query.plan_query(
                self.live_count(), k, self.sc.ef,
                use_kernel=self.sc.use_kernel,
                exact_threshold=self.sc.exact_threshold, route=self.sc.route,
                ef_coarse=self.sc.ef_coarse, dim=self.d_model,
                graph_gen=self.graph_gen)
        pool_states = None
        if self.read_replicas:
            slot = self._pick_replica(q_raw)
            if slot is not None:
                # one proven (state, hash, t) per replica: a live follower
                # may commit concurrently
                chosen = [pool[slot] for pool in self.read_replicas]
                snaps = [rep.snapshot() for rep in chosen]
                if all(t >= flush_t for _, _, t in snaps):
                    pool_states = [state for state, _, _ in snaps]
                    plan = dataclasses.replace(plan,
                                               served_by=f"replica:{slot}")
        self.last_plan = plan
        if pool_states is not None:
            ids, scores = self._replica_query(chosen, pool_states, q_raw, k,
                                              plan)
        elif self._clients is not None:
            # every shard host executes the plan on its applied state; the
            # candidates merge with the one order-invariant combine
            from repro_torch.net.client import remote_sharded_query
            ids, scores = remote_sharded_query(self._clients, q_raw, k, plan)
        else:
            if plan.route == query.ROUTE_COARSE:
                self._ensure_code_tables()
            if not self._layout_sharded:
                with obs.span("query.execute"):
                    ids, scores = query.execute_plan(
                        self.memory, q_raw, k, plan, codes=self._code_table)
            else:
                ids, scores = query.sharded_host_query(
                    self.memory, self.n_shards, q_raw, k, plan,
                    tables=self._code_tables)
        with obs.span("engine.copy_out"):
            return obs.host(ids).numpy(), obs.host(scores).numpy()

    def _replica_query(self, replicas: list, pool_states: List[MemoryState],
                       q_raw: torch.Tensor, k: int, plan: query.QueryPlan
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The plan on the chosen replicas' verified states: the flat state
        directly, per-shard states merged with the one (score, id) combine.
        A coarse read takes each replica's code table of the state it
        serves (built once per cursor; the reference builds one per
        read)."""
        def run(rep, st):
            table = rep.coarse_table(st) \
                if plan.route == query.ROUTE_COARSE else None
            return query.execute_plan(st, q_raw.to(st.device), k, plan,
                                      codes=table)

        if not self._layout_sharded:
            return run(replicas[0], pool_states[0])
        parts = [run(rep, st) for rep, st in zip(replicas, pool_states)]
        dev = q_raw.device
        s_out, i_out = search.merge_candidates(
            torch.cat([sc.to(dev) for _, sc in parts], dim=-1),
            torch.cat([ids.to(dev) for ids, _ in parts], dim=-1), k)
        return i_out, s_out

    def retrieval_hash(self, queries, k: Optional[int] = None) -> int:
        """Platform-invariant hash of the retrieval set for these queries."""
        ids, scores = self.retrieve(queries, k)
        return query.retrieval_hash(ids, scores)

    # ------------------------------------------------------------------ #
    # GENERATE
    # ------------------------------------------------------------------ #

    def _augmented(self, prompt_tokens, augment: bool = True) -> np.ndarray:
        """The prompt ``generate`` decodes from: [B, L] int32, or with
        ``augment`` and live rows the top hit's first ``context_tokens``
        tokens (right-aligned, zeros before a shorter doc) prepended."""
        prompt_tokens = np.asarray(prompt_tokens, np.int32)
        B = prompt_tokens.shape[0]
        if not (augment and self.live_count() > 0):
            return prompt_tokens
        ids, _ = self.retrieve(prompt_tokens)
        ctx = np.zeros((B, self.sc.context_tokens), np.int32)
        for b in range(B):
            doc = self.docs.get(int(ids[b, 0]))
            if doc is not None:
                n = min(len(doc), self.sc.context_tokens)
                ctx[b, -n:] = doc[:n]
        return np.concatenate([ctx, prompt_tokens], axis=1)

    @torch.no_grad()
    def generate(self, prompt_tokens, *, augment: bool = True) -> np.ndarray:
        """Greedy decode a batch of prompts [B, L], optionally memory-
        augmented (``_augmented``). Ties in the argmax go to the first
        index. Returns [B, max_new_tokens] int32."""
        self._require_lm()
        tokens = self._augmented(prompt_tokens, augment)
        logits, caches = tf.prefill(self.params,
                                    {"tokens": self._tokens(tokens)},
                                    self.cfg, self.sc.s_cache)
        return tf.greedy_decode(self.params, logits, caches, tokens.shape[1],
                                self.sc.max_new_tokens, self.cfg
                                ).cpu().numpy()

    # ------------------------------------------------------------------ #
    # durability: background checkpoints + crash recovery (DESIGN.md §5, §7)
    # ------------------------------------------------------------------ #

    def flush(self) -> int:
        """Force any pending group-commit batch durable; returns the durable
        WAL cursor (the memory cursor in memory-only mode). The read path
        calls this before serving — the sync-on-read barrier — and it is
        the ack point for upstream callers under group commit. With live
        followers it also wakes any replica lagging the cursor by more than
        the policy's ``max_lag_commands`` (never waits on one). The doc side
        table syncs here too, so its durability never lags the barrier."""
        if self._doc_table is not None:
            self._doc_table.sync()
        if self._group is not None:
            t = self._group.flush()
        else:
            t = self.durable.t if self.durable is not None \
                else self._cursor()
        if self.sc.follow is not None:
            lag_bound = self.sc.follow.max_lag_commands
            for pool in self.read_replicas:
                for rep in pool:
                    if t - rep.t > lag_bound:
                        rep.notify_writes()
        return t

    def close(self) -> None:
        """Flush pending ingest, join background work, stop the group-commit
        writer (and its timer thread), close every read replica (follower
        threads, transports) and the shard-host connections. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.flush()
        self.wait_durable()
        if self._group is not None:
            self._group.close()
        for pool in self.read_replicas:
            for rep in pool:
                rep.close()
        if self._doc_table is not None:
            self._doc_table.close()
        for c in self._clients or ():
            c.close()

    def wait_durable(self) -> None:
        """Join any in-flight background checkpoint; re-raise its error."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        if self._ckpt_error is not None:
            err, self._ckpt_error = self._ckpt_error, None
            raise RuntimeError("background checkpoint failed") from err

    def _require_durable(self):
        if self.durable is None:
            raise RuntimeError("no durable_dir configured")
        return self.durable

    def checkpoint(self) -> Dict[str, int]:
        """Synchronously cut an incremental snapshot at the current cursor
        (per-shard v2 snapshots + the merged whole-state-hash record in
        sharded mode); returns the snapshot stats (with retention's when
        configured)."""
        store = self._require_durable()
        self.flush()  # a snapshot may only cover durable commands
        self.wait_durable()
        stats = store.checkpoint(self._checkpoint_source())
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
        host_state = self._checkpoint_source()
        self._last_ckpt_t = self._cursor()
        store = self.durable
        if self._clients is not None:
            # synchronous over the wire: a host proves cursor and hash
            # against its applied state at request time, so a background
            # thread would race the next append's cursor advance
            store.checkpoint(host_state)
            if self.sc.retain_snapshots > 0:
                store.retain(self.sc.retain_snapshots)
            return

        def work():
            try:
                store.checkpoint(host_state)
                if self.sc.retain_snapshots > 0:
                    store.retain(self.sc.retain_snapshots)
            except BaseException as e:  # noqa: BLE001 — re-raised on wait
                self._ckpt_error = e

        self._ckpt_thread = threading.Thread(target=work, daemon=True)
        self._ckpt_thread.start()

    def _checkpoint_source(self) -> MemoryState:
        """What a checkpoint reads: a host copy of the state, or in
        networked mode the state where it is (only its per-shard hashes
        cross the wire; each host snapshots its own applied state)."""
        return self.memory if self._clients is not None \
            else self.memory.to("cpu")

    def _checkpoint_code_tables(self) -> None:
        """Cut each code table's content-addressed manifest beside the
        state snapshots (``<durable_dir>/codes/``, one per shard), keeping
        only the newest set and the chunks it references. Recovery does not
        read them (the tables are rebuilt from the recovered state); they
        are the audit / warm-start artifact, equal bit for bit to the
        rebuild."""
        if self.sc.durable_dir is None or not self._coarse_enabled():
            return
        self._ensure_code_tables()
        t = self._cursor()
        cdir = pathlib.Path(self.sc.durable_dir) / "codes"
        store = snapshot.ChunkStore(cdir / "chunks")
        keep_keys = set()
        for s, tbl in enumerate(self._code_tables):
            manifest, _ = codes.snapshot_table_v2(tbl, t, store)
            path = cdir / f"codes_{s:04d}_t{t:020d}.mft"
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(manifest)
            tmp.replace(path)
            keep_keys.update(codes.table_manifest_chunk_keys(manifest))
        for old in cdir.glob("codes_*.mft"):
            if not old.name.endswith(f"t{t:020d}.mft"):
                old.unlink()
        for key in store.keys():
            if key not in keep_keys:
                store.delete(key)

    def _reload_audit_logs(self, t: int) -> None:
        """Rebuild the in-memory audit trail from the durable WAL(s) after
        recover/rollback, if retention kept the full history. In sharded
        mode the global interleaving is not durable (per-shard WALs only);
        the per-shard logs are the reconstructible audit trail."""
        if not self._layout_sharded:
            try:
                self.log = self.durable.wal.read_range(0, t,
                                                       device=self.device)
            except ValueError:
                self.log = self._empty_log()
            return
        self.log = self._empty_log()
        try:
            self._shard_logs = self.durable.shard_logs(0, t)
        except ValueError:
            self._shard_logs = [self._empty_log()
                                for _ in range(self.n_shards)]

    def _reload_serving_caches(self) -> None:
        """Next-id allocation from the live rows of the recovered state, and
        the doc cache from its side table (later records for an id win), so
        the recovered engine generates with warm context at once. Every
        record is loaded, as the reference does: a deleted or rolled-away
        id's entry is inert (a dead id is never retrieved, and a reused
        id's new record replaces it)."""
        live = self.memory.ids[self.memory.valid]
        self._next_id = int(live.max()) + 1 if live.numel() else 0
        if self._doc_table is not None:
            self.docs = {
                key: np.frombuffer(payload, "<i4").astype(np.int32)
                for key, payload in self._doc_table.entries.items()}

    def recover(self) -> Tuple[int, int]:
        """Rebuild memory from the durable store after a crash: nearest
        snapshot + WAL tail, bit-identical to replaying the durable prefix,
        on the engine's device. Returns (t, state hash)."""
        store = self._require_durable()
        self.flush()  # a live engine recovering: don't drop acked work
        self.wait_durable()
        state, h, t = store.recover()
        self.memory = state
        self._code_tables = None  # rebuilt from the recovered state on the
        self._last_ckpt_t = t     # first coarse read (pure function of it)
        self._reload_audit_logs(t)
        self._reload_serving_caches()
        # recovery may land below the replicas' cursors: every served
        # cursor re-earns its proof against the recovered history
        self._reset_replicas()
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
        self._code_tables = None
        self._last_ckpt_t = t
        self._reload_audit_logs(t)
        self._reload_serving_caches()
        # rollback rewrites history: replicas ahead of t proved a prefix
        # that no longer exists
        self._reset_replicas()
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
        self.memory = self._relinked(self.memory)
        self.relink_ts = [t]
        self.graph_gen = 1
        return self.state_hash()

    # ------------------------------------------------------------------ #
    # audit / replay
    # ------------------------------------------------------------------ #

    def memory_hash(self) -> int:
        """The layout-invariant live-content hash: flat and sharded engines
        fed the same documents report the same value."""
        return hashing.content_hash(self.memory)

    def state_hash(self) -> int:
        """``hash_pytree`` of the state (computed on its device)."""
        return hashing.hash_state_device(self.memory)

    def snapshot_bytes(self) -> bytes:
        """The flat state as one v1 snapshot blob
        (``snapshot.restore_bytes``)."""
        if self._layout_sharded:
            raise ValueError(
                "sharded engines snapshot through checkpoint() (per-shard "
                "v2 snapshots + merged hash record), not one flat blob")
        return snapshot.snapshot_bytes(self.memory)

    def replay_log_fresh(self) -> int:
        """Re-apply the audit log to S_0 with the one-command-at-a-time
        ``machine.replay``, interleaving ``hnsw.relink`` at the recorded
        cursors; must equal ``state_hash()``. In sharded mode each shard's
        (routed, padded) log replays on its genesis slice, relinked at the
        same cursors (a per-shard cursor is the per-shard padded offset),
        and the merge is hashed."""
        def replay(st, log):
            pos = 0
            for t in self.relink_ts:
                st = hnsw.relink(machine.replay(st, log.slice(pos, t)))
                pos = t
            return machine.replay(st, log.slice(pos, len(log)))

        genesis = self._genesis_state()
        if not self._layout_sharded:
            return hashing.hash_state_device(replay(genesis, self.log))
        return hashing.hash_state_device(distributed.merge_shards(
            [replay(distributed.shard_slice(genesis, s, self.n_shards),
                    self._shard_logs[s]) for s in range(self.n_shards)]))
