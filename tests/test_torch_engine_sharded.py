"""The port's sharded engine (``ServeConfig(shards=N)``) against the JAX
package's sharded engine fed the same embeddings (the reference engine's
own embedder), at 2 and 4 shards, in memory and with group commit — bit
for bit, with ``memory_hash`` and the exact route equal to the flat
engine's. The durable pairs (recover, rollback) are
``test_torch_engine_sharded_durable.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import codes as jcodes  # noqa: E402
from repro.core import wal as jwal  # noqa: E402
from repro_torch.core import codes as tcodes  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import wal as twal  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

from _torch_sharded_engine import (BATCH, PROMPTS, SC,  # noqa: E402
                                   assert_alike, embedded_docs, engines,
                                   model, relink_policies, route_answers)

assert model  # a fixture, used by name


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_engine_in_memory_matches(model, shards):
    """Ingest, delete, re-link (scheduled and manual) and the three routes;
    the code tables (one per shard) through build, refresh and drop; the
    flat engine on the same documents reports the same memory_hash and the
    same exact-route answers."""
    pol = relink_policies(0.1)
    j, t = engines(model, shards, relink=pol)
    flat = tengine.MemoryAugmentedEngine(model[0].d_model, tengine.ServeConfig(
        **SC), device="cpu")
    rng = np.random.default_rng(shards)
    for _ in range(2):
        docs, emb = embedded_docs(model, rng, BATCH)
        assert j.insert_documents(docs) == t.insert_documents(emb) == \
            flat.insert_documents(emb)
    prompts = rng.integers(0, model[0].vocab_size, (PROMPTS, 10),
                           dtype=np.int32)
    assert all(a == b for a, b in route_answers(model, j, t, prompts))
    assert t._code_tables is not None and len(t._code_tables) == shards
    for s in range(shards):
        assert tcodes.table_hash(t._code_tables[s]) == \
            jcodes.table_hash(j._code_tables[s]) == tcodes.table_hash(
                tcodes.build(td.shard_slice(t.memory, s, shards)))
    gone = [3, 0, 11, 99, 3, 7, 8]
    assert j.delete_documents(gone) == t.delete_documents(gone) == \
        flat.delete_documents(gone)
    assert t._code_tables is None
    docs, emb = embedded_docs(model, rng, BATCH)
    assert j.insert_documents(docs) == t.insert_documents(emb) == \
        flat.insert_documents(emb)
    assert t.relink_ts and t.relink_ts == j.relink_ts  # the policy fired
    assert j.relink_now() == t.relink_now()
    assert_alike(j, t)
    assert all(a == b for a, b in route_answers(model, j, t, prompts))
    assert t.memory_hash() == flat.memory_hash()
    q = model[2](prompts)
    t.sc.route = flat.sc.route = "exact"
    assert t.retrieval_hash(q) == flat.retrieval_hash(q)
    assert t.live_count() == flat.live_count()
    assert t.replay_log_fresh() == t.state_hash()
    with pytest.raises(ValueError, match="checkpoint"):
        t.snapshot_bytes()


def test_sharded_engine_config_checks():
    with pytest.raises(ValueError, match="divide"):
        tengine.MemoryAugmentedEngine(8, tengine.ServeConfig(
            capacity=30, shards=4), device="cpu")
    with pytest.raises(ValueError, match="shards"):
        tengine.MemoryAugmentedEngine(8, tengine.ServeConfig(shards=0),
                                      device="cpu")
    for kw, match in ((dict(hosts=["localhost:1", "localhost:2"]),
                       "needs durable_dir"),
                      (dict(hosts=["localhost:1"], durable_dir="unused"),
                       "shards=2 but 1 hosts"),
                      (dict(replicas=1), "replicas=k needs durable_dir"),
                      (dict(follow=object()), "needs replicas > 0")):
        with pytest.raises(ValueError, match=match):
            tengine.MemoryAugmentedEngine(8, tengine.ServeConfig(
                shards=2, **kw), device="cpu")


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_group_commit_engines_alike(model, shards, tmp_path):
    """Group commit submits routed shares: nothing durable before the read
    barrier, then the same padded cursor in both packages; a crash loses
    the same unflushed tail."""
    gc = (jwal.GroupCommitPolicy(max_batch=1 << 20, max_delay_s=3600),
          twal.GroupCommitPolicy(max_batch=1 << 20, max_delay_s=3600))
    j, t = engines(model, shards, tmp_path, group_commit=gc)
    rng = np.random.default_rng(10)
    docs, emb = embedded_docs(model, rng, BATCH)
    assert j.insert_documents(docs) == t.insert_documents(emb)
    assert j.delete_documents([2, 3]) == t.delete_documents([2, 3])
    assert t.durable.t == j.durable.t == 0
    assert t._group.target_t == j._group.target_t > 0
    prompts = rng.integers(0, model[0].vocab_size, (PROMPTS, 10),
                           dtype=np.int32)
    assert all(a == b for a, b in route_answers(model, j, t, prompts))
    flushed = t.durable.t
    assert flushed == j.durable.t == t._cursor()
    assert_alike(j, t)
    docs, emb = embedded_docs(model, rng, BATCH)
    assert j.insert_documents(docs) == t.insert_documents(emb)
    j2, t2 = engines(model, shards, tmp_path, group_commit=gc)
    got = t2.recover()
    assert got == j2.recover() and got[0] == flushed
    for e in (j, t, j2, t2):
        e.close()
