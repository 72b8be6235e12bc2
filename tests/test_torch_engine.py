"""The slice as a whole: the port's flat engine fed the reference engine's
own embeddings reproduces its hashes and retrievals bit for bit."""
import dataclasses

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
    for kw in (dict(shards=2), dict(durable_dir="/x"), dict(replicas=1)):
        with pytest.raises(NotImplementedError):
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
