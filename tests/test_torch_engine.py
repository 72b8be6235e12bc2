"""The slice as a whole: the port's flat engine fed the reference engine's
own embeddings reproduces its hashes and retrievals bit for bit."""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.configs import get_reduced_config  # noqa: E402
from repro.core import codes as jcodes  # noqa: E402
from repro.models import transformer as tf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.core import codes as tcodes  # noqa: E402
from repro_torch.core import hnsw as thnsw  # noqa: E402
from repro_torch.core.state import init_state  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    cfg = get_reduced_config("h2o_danube_1_8b")
    params = tf.init_params(cfg, jax.random.PRNGKey(0))
    sc = dict(capacity=128, retrieve_k=3, ef=16)
    j = jengine.MemoryAugmentedEngine(cfg, params, jengine.ServeConfig(
        max_new_tokens=4, s_cache=96, context_tokens=8, **sc))
    t = tengine.MemoryAugmentedEngine(cfg.d_model, tengine.ServeConfig(**sc),
                                      device="cpu")
    rng = np.random.default_rng(0)

    def embed(tokens):
        return np.asarray(j._embed_fn(j.params, jnp.asarray(tokens)))

    for n in (24, 17):
        docs = rng.integers(0, cfg.vocab_size, (n, 16), dtype=np.int32)
        assert j.insert_documents(docs) == t.insert_documents(embed(docs))
    gone = [3, 0, 11, 99, 3]
    assert j.delete_documents(gone) == t.delete_documents(gone)
    assert j.relink_now() == t.relink_now()
    docs = rng.integers(0, cfg.vocab_size, (9, 16), dtype=np.int32)
    assert j.insert_documents(docs) == t.insert_documents(embed(docs))
    prompts = rng.integers(0, cfg.vocab_size, (4, 10), dtype=np.int32)
    return j, t, prompts, embed(prompts)


def test_engine_hashes_match(pair):
    j, t, _, _ = pair
    assert t.state_hash() == j.state_hash()
    assert t.memory_hash() == j.memory_hash()
    assert t.relink_ts == j.relink_ts and t.graph_gen == j.graph_gen
    assert t.replay_log_fresh() == t.state_hash()
    assert t.log.opcode.shape[0] == len(j.log)


@pytest.mark.parametrize("route", ["auto", "exact", "hnsw"])
def test_engine_retrieval_matches(pair, route):
    j, t, prompts, q = pair
    j.sc.route = t.sc.route = route
    try:
        jid, jsc = j.retrieve(prompts)
        tid, tsc = t.retrieve(q)
        assert np.array_equal(tid, jid) and np.array_equal(tsc, jsc)
        assert dataclasses.asdict(t.last_plan) == \
            dataclasses.asdict(j.last_plan)
        assert t.retrieval_hash(q, 5) == j.retrieval_hash(prompts, 5)
    finally:
        j.sc.route = t.sc.route = "auto"


def test_engine_refuses_unserved_modes_and_silent_cpu():
    # the networked and replicated modes are served; their inconsistent
    # configurations are refused as the reference refuses them
    for kw, match in ((dict(follow=object()), "needs replicas > 0"),
                      (dict(replicas=1), "replicas=k needs durable_dir"),
                      (dict(hosts=["localhost:1"]), "needs durable_dir"),
                      (dict(shards=2, hosts=["localhost:1"],
                            durable_dir="unused"), "shards=2 but 1 hosts")):
        with pytest.raises(ValueError, match=match):
            tengine.MemoryAugmentedEngine(8, tengine.ServeConfig(**kw),
                                          device="cpu")
    # the compressed tier is served: both ways of asking for it build an
    # engine that answers on the coarse route
    rng = np.random.default_rng(2)
    for kw in (dict(ef_coarse=8), dict(route="coarse", ef_coarse=8)):
        eng = tengine.MemoryAugmentedEngine(
            8, tengine.ServeConfig(capacity=16, exact_threshold=0, ef=2,
                                   **kw), device="cpu")
        assert eng._coarse_enabled()
        eng.insert_documents(rng.normal(size=(12, 8)).astype(np.float32))
        ids, _ = eng.retrieve(rng.normal(size=(2, 8)).astype(np.float32), 2)
        assert eng.last_plan.route == "coarse" and ids.shape == (2, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_state(4, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengine.MemoryAugmentedEngine(8, tengine.ServeConfig())


def test_relink_policy_schedule_matches():
    """The scheduled re-link fires at the same batch boundaries."""
    pol = thnsw.RelinkPolicy(dead_ratio=0.2, min_deletes=2, check_every=4)
    from repro.core import hnsw as jhnsw
    jpol = jhnsw.RelinkPolicy(dead_ratio=0.2, min_deletes=2, check_every=4)
    rng = np.random.default_rng(1)
    t = tengine.MemoryAugmentedEngine(
        8, tengine.ServeConfig(capacity=32, relink=pol), device="cpu")
    emb = rng.normal(size=(12, 8)).astype(np.float32)
    t.insert_documents(emb)
    t.delete_documents([1, 2, 5, 7])
    t.insert_documents(emb[:4])
    assert t.relink_ts == [16] and t.graph_gen == 1
    assert t.replay_log_fresh() == t.state_hash()
    assert dataclasses.asdict(jpol) == dataclasses.asdict(pol)


@pytest.fixture(scope="module")
def coarse_pair(pair):
    """A JAX / port engine pair serving the compressed tier, fed the same
    embeddings (the reference engine's own embedder). With
    exact_threshold=0 and ef=4 the planner's rule 5 picks the coarse route
    on its own; ``route="coarse"`` forces it."""
    j0, _, _, _ = pair
    sc = dict(capacity=128, retrieve_k=3, ef=4, ef_coarse=16,
              exact_threshold=0)
    j = jengine.MemoryAugmentedEngine(j0.cfg, j0.params, jengine.ServeConfig(
        max_new_tokens=4, s_cache=96, context_tokens=8, **sc))
    t = tengine.MemoryAugmentedEngine(j0.cfg.d_model,
                                      tengine.ServeConfig(**sc), device="cpu")
    return j, t


def _embed(j, tokens):
    return np.asarray(j._embed_fn(j.params, jnp.asarray(tokens)))


def test_engine_coarse_route_matches_through_build_refresh_and_drop(
        coarse_pair):
    j, t = coarse_pair
    rng = np.random.default_rng(3)
    vocab = j.cfg.vocab_size

    def insert(n):
        docs = rng.integers(0, vocab, (n, 16), dtype=np.int32)
        assert j.insert_documents(docs) == t.insert_documents(_embed(j, docs))

    def check(stage):
        prompts = rng.integers(0, vocab, (4, 10), dtype=np.int32)
        q = _embed(j, prompts)
        for route in ("auto", "coarse"):
            j.sc.route = t.sc.route = route
            try:
                jid, jsc = j.retrieve(prompts)
                tid, tsc = t.retrieve(q)
                assert t.last_plan.route == "coarse", stage
                assert dataclasses.asdict(t.last_plan) == \
                    dataclasses.asdict(j.last_plan), stage
                assert np.array_equal(tid, jid), stage
                assert np.array_equal(tsc, jsc), stage
                assert t.retrieval_hash(q, 5) == \
                    j.retrieval_hash(prompts, 5), stage
            finally:
                j.sc.route = t.sc.route = "auto"
        assert t._code_table is not None
        assert tcodes.table_hash(t._code_table) == \
            jcodes.table_hash(j._code_tables[0]) == \
            tcodes.table_hash(tcodes.build(t.memory)), stage
        assert t.state_hash() == j.state_hash(), stage

    insert(40)
    assert t._code_table is None  # built lazily, on the first coarse read
    check("built")
    insert(9)                     # refreshed after the batch
    check("refreshed")
    assert j.delete_documents([1, 5, 33]) == t.delete_documents([1, 5, 33])
    assert t._code_table is None  # dropped on delete, rebuilt on read
    check("rebuilt")
    assert j.relink_now() == t.relink_now()
    table = t._code_table
    check("relinked")             # re-link leaves the table alone
    assert t._code_table is table
    assert t.replay_log_fresh() == t.state_hash()


@pytest.fixture(scope="module")
def wide_pair(pair):
    """A JAX / port engine pair at capacity 1030 holding a few dozen
    documents: a read with k = 1040 > capacity takes the exact route."""
    j0, _, _, _ = pair
    sc = dict(capacity=1030, retrieve_k=3, ef=16)
    j = jengine.MemoryAugmentedEngine(j0.cfg, j0.params, jengine.ServeConfig(
        max_new_tokens=4, s_cache=96, context_tokens=8, **sc))
    t = tengine.MemoryAugmentedEngine(j0.cfg.d_model,
                                      tengine.ServeConfig(**sc), device="cpu")
    rng = np.random.default_rng(4)
    docs = rng.integers(0, j0.cfg.vocab_size, (30, 16), dtype=np.int32)
    assert j.insert_documents(docs) == t.insert_documents(_embed(j, docs))
    prompts = rng.integers(0, j0.cfg.vocab_size, (4, 10), dtype=np.int32)
    return j, t, prompts


@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_retrieve_k_beyond_capacity_matches(wide_pair, use_kernel):
    """The reference engine (its default route) answers k = 1040 at
    capacity 1030 with 1030 columns; so must the port's, on the kernel
    route (qtopk's plain version here, the card's kernels on a GPU)."""
    j, t, prompts = wide_pair
    q = _embed(j, prompts)
    t.sc.use_kernel = use_kernel
    try:
        jid, jsc = j.retrieve(prompts, 1040)
        tid, tsc = t.retrieve(q, 1040)
        assert t.last_plan.route == "exact" and jid.shape == (4, 1030)
        assert np.array_equal(tid, jid) and np.array_equal(tsc, jsc)
        assert t.retrieval_hash(q, 1040) == j.retrieval_hash(prompts, 1040)
    finally:
        t.sc.use_kernel = False


# --------------------------------------------------------------------------- #
# durable mode: a JAX / port engine pair over their own directories
# --------------------------------------------------------------------------- #

ROUTES = ("exact", "hnsw", "coarse")


def _durable_engines(j0, root, **extra):
    """A fresh JAX / port engine pair in durable mode over ``root/j`` and
    ``root/t``. ``extra`` maps a ServeConfig field to a pair of values,
    (the reference's, the port's), for the policies each package types."""
    from repro.core import hnsw as jhnsw
    sc = dict(capacity=128, retrieve_k=3, ef=16, ef_coarse=16)
    jx = {k: v[0] for k, v in extra.items()}
    tx = {k: v[1] for k, v in extra.items()}
    jx.setdefault("relink", jhnsw.RelinkPolicy(dead_ratio=0.2, min_deletes=2,
                                               check_every=4))
    tx.setdefault("relink", thnsw.RelinkPolicy(dead_ratio=0.2, min_deletes=2,
                                               check_every=4))
    j = jengine.MemoryAugmentedEngine(j0.cfg, j0.params, jengine.ServeConfig(
        max_new_tokens=4, s_cache=96, context_tokens=8,
        durable_dir=str(root / "j"), **sc, **jx))
    t = tengine.MemoryAugmentedEngine(j0.cfg.d_model, tengine.ServeConfig(
        durable_dir=str(root / "t"), **sc, **tx), device="cpu")
    return j, t


def _answers_pair(j, t, prompts):
    """Each route's retrieval hash, from both engines."""
    q = _embed(j, prompts)
    out = []
    for route in ROUTES:
        j.sc.route = t.sc.route = route
        out.append((j.retrieval_hash(prompts), t.retrieval_hash(q)))
    j.sc.route = t.sc.route = "auto"
    return out


def _assert_alike(j, t):
    assert t.state_hash() == j.state_hash()
    assert (t.relink_ts, t.graph_gen) == (j.relink_ts, j.graph_gen)
    assert t.durable.t == j.durable.t


@pytest.fixture(scope="module")
def durable_dirs(pair, tmp_path_factory):
    """Both packages' durable engines fed the same history (checkpoints
    every 16 commands, a re-link policy, a delete batch), then dropped
    without a close: the crashed directories and what was served."""
    j0, _, _, _ = pair
    root = tmp_path_factory.mktemp("durable_pair")
    j, t = _durable_engines(j0, root, checkpoint_every=(16, 16))
    rng = np.random.default_rng(6)
    for n in (12, 9):
        docs = rng.integers(0, j0.cfg.vocab_size, (n, 16), dtype=np.int32)
        assert j.insert_documents(docs) == t.insert_documents(
            _embed(j, docs))
    gone = [1, 2, 5, 7, 40]
    assert j.delete_documents(gone) == t.delete_documents(gone)
    docs = rng.integers(0, j0.cfg.vocab_size, (6, 16), dtype=np.int32)
    assert j.insert_documents(docs) == t.insert_documents(_embed(j, docs))
    j.wait_durable()
    t.wait_durable()
    _assert_alike(j, t)
    assert t.durable.snapshots() == j.durable.snapshots()
    assert len(t.durable.snapshots()) >= 2
    prompts = rng.integers(0, j0.cfg.vocab_size, (3, 10), dtype=np.int32)
    answers = _answers_pair(j, t, prompts)
    assert all(a == b for a, b in answers)
    served = dict(t=t.durable.t, answers=answers,
                  t_ckpt=t.durable.snapshots()[1])
    return root, prompts, served


def _copy(src, dst):
    for name in ("j", "t"):
        shutil.copytree(src / name, dst / name)
    return dst


def test_durable_engines_recover_alike(pair, durable_dirs, tmp_path):
    """Fresh engines of both packages over the crashed directories recover
    the same (t, hash), the same canonical graph (relink_ts == [t],
    graph_gen == 1), the same answers on every route as were served, and
    allocate the same next ids; the port's engine recovers the reference's
    directory to the reference store's (t, hash)."""
    j0, _, _, _ = pair
    src, prompts, served = durable_dirs
    root = _copy(src, tmp_path)
    j, t = _durable_engines(j0, root)
    got = t.recover()
    assert got == j.recover()
    assert got[0] == served["t"]
    _assert_alike(j, t)
    assert (t.relink_ts, t.graph_gen) == ([served["t"]], 1)
    assert t.replay_log_fresh() == j.replay_log_fresh() == t.state_hash()
    assert _answers_pair(j, t, prompts) == served["answers"]
    docs = np.random.default_rng(8).integers(0, j0.cfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    assert t.insert_documents(_embed(j, docs)) == j.insert_documents(docs)
    _assert_alike(j, t)
    cross = tengine.MemoryAugmentedEngine(j0.cfg.d_model, tengine.ServeConfig(
        capacity=128, retrieve_k=3, ef=16, durable_dir=str(root / "j")),
        device="cpu")
    assert cross.recover() == (j.durable.t,
                               j.durable.restore_at(j.durable.t)[1])
    for e in (j, t, cross):
        e.close()


def test_durable_engines_roll_back_alike(pair, durable_dirs, tmp_path):
    """``rollback_to`` the second snapshot on recovered engines of both
    packages: the same (t, hash), canonical graph, answers and next ids,
    and the same durable history afterwards."""
    j0, _, _, _ = pair
    src, prompts, served = durable_dirs
    root = _copy(src, tmp_path)
    j, t = _durable_engines(j0, root)
    assert t.recover() == j.recover()
    got = t.rollback_to(served["t_ckpt"])
    assert got == j.rollback_to(served["t_ckpt"])
    assert got[0] == served["t_ckpt"] == t.durable.t
    _assert_alike(j, t)
    assert t.relink_ts == [served["t_ckpt"]]
    assert all(a == b for a, b in _answers_pair(j, t, prompts))
    docs = np.random.default_rng(9).integers(0, j0.cfg.vocab_size, (3, 16),
                                             dtype=np.int32)
    assert t.insert_documents(_embed(j, docs)) == j.insert_documents(docs)
    _assert_alike(j, t)
    assert t.replay_log_fresh() == j.replay_log_fresh() == t.state_hash()
    for e in (j, t):
        e.close()


def test_durable_engines_group_commit_and_compaction_alike(pair, tmp_path):
    """Group commit: both buffer until the read path's flush, then hold the
    same durable cursor, and a crash loses the same unflushed tail.
    Compaction: a delete-heavy history reaches the same hash, cursor and
    compacted WAL bytes in both packages."""
    from repro.core import wal as jwal
    from repro_torch.core import wal as twal
    j0, _, _, _ = pair
    rng = np.random.default_rng(10)
    gc = (jwal.GroupCommitPolicy(max_batch=1 << 20, max_delay_s=3600),
          twal.GroupCommitPolicy(max_batch=1 << 20, max_delay_s=3600))
    j, t = _durable_engines(j0, tmp_path / "gc", group_commit=gc)
    docs = rng.integers(0, j0.cfg.vocab_size, (10, 16), dtype=np.int32)
    assert j.insert_documents(docs) == t.insert_documents(_embed(j, docs))
    assert t.durable.t == j.durable.t == 0
    prompts = rng.integers(0, j0.cfg.vocab_size, (2, 10), dtype=np.int32)
    assert all(a == b for a, b in _answers_pair(j, t, prompts))
    assert t.durable.t == j.durable.t == 10
    docs = rng.integers(0, j0.cfg.vocab_size, (4, 16), dtype=np.int32)
    assert j.insert_documents(docs) == t.insert_documents(_embed(j, docs))
    j2, t2 = _durable_engines(j0, tmp_path / "gc", group_commit=gc)
    got = t2.recover()
    assert got == j2.recover() and got[0] == 10
    for e in (j, t, j2, t2):
        e.close()

    cp = (jwal.CompactionPolicy(dead_ratio=0.01, min_commands=8,
                                check_every=8),
          twal.CompactionPolicy(dead_ratio=0.01, min_commands=8,
                                check_every=8))
    j, t = _durable_engines(j0, tmp_path / "cp", compaction=cp)
    for _ in range(3):
        docs = rng.integers(0, j0.cfg.vocab_size, (8, 16), dtype=np.int32)
        assert j.insert_documents(docs) == t.insert_documents(
            _embed(j, docs))
        gone = [int(i) for i in rng.choice(24, 5, replace=False)]
        assert j.delete_documents(gone) == t.delete_documents(gone)
    _assert_alike(j, t)
    jwal_bytes = {p.name: p.read_bytes()
                  for p in sorted((tmp_path / "cp" / "j" / "wal").iterdir())}
    twal_bytes = {p.name: p.read_bytes()
                  for p in sorted((tmp_path / "cp" / "t" / "wal").iterdir())}
    assert twal_bytes == jwal_bytes
    from repro_torch.core import commands as tcommands
    folded = t.durable.wal.read_range(0, t.durable.t, device="cpu")
    assert bool((folded.opcode == tcommands.NOP).any())  # compaction ran
    for e in (j, t):
        e.close()
