"""The port's networked and replicated engine modes against the JAX
engine fed the same embeddings (the reference engine's own embedder):
``hosts=`` over in-process shard servers on ephemeral ports (each
package's engine over its own package's hosts), ``replicas=1`` and
``follow=``. Recover and rollback with the pool's respawn are
``test_torch_engine_replicas.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distributed as jdist  # noqa: E402
from repro.net import replica as jreplica  # noqa: E402
from repro.net import server as jserver  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.net import replica as treplica  # noqa: E402
from repro_torch.net import server as tserver  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

from _torch_net import tree_bytes  # noqa: E402
from _torch_sharded_engine import (BATCH, PROMPTS, SC,  # noqa: E402
                                   assert_alike, embedded_docs, model,
                                   route_answers)

assert model  # a fixture, used by name
N = 2  # shard hosts


@pytest.fixture
def servers(model, tmp_path):
    """(reference servers, port servers): N shard hosts of each package on
    ephemeral ports, each over its shard slice of an empty arena."""
    d, rows = model[0].d_model, SC["capacity"] // N
    jg = jdist.init_sharded_host(N, rows, d)
    tg = tdist.init_sharded_host(N, rows, d, device="cpu")
    js = [jserver.ShardServer(jserver.ShardHost(
        tmp_path / f"jh{s}", jdist.shard_slice(jg, s, N))).start()
        for s in range(N)]
    ts = [tserver.ShardServer(tserver.ShardHost(
        tmp_path / f"th{s}", tdist.shard_slice(tg, s, N),
        device="cpu")).start() for s in range(N)]
    yield js, ts
    for srv in js + ts:
        srv.close()
        srv.host.close()


def addresses(servers):
    return [f"127.0.0.1:{srv.port}" for srv in servers]


def net_engines(model, root, servers, **extra):
    """A JAX / port engine pair, each over its own package's hosts;
    ``extra`` maps a ServeConfig field to (reference value, port value)."""
    cfg, params, _ = model
    js, ts = servers
    j = jengine.MemoryAugmentedEngine(cfg, params, jengine.ServeConfig(
        max_new_tokens=4, s_cache=96, context_tokens=8, hosts=addresses(js),
        durable_dir=str(root / "jc"), **SC,
        **{k: v[0] for k, v in extra.items()}))
    t = tengine.MemoryAugmentedEngine(cfg.d_model, tengine.ServeConfig(
        hosts=addresses(ts), durable_dir=str(root / "tc"), **SC,
        **{k: v[1] for k, v in extra.items()}), device="cpu")
    return j, t


def ingest(model, j, t, rng, batches=2, gone=(3, 0, 11, 99)):
    for _ in range(batches):
        docs, emb = embedded_docs(model, rng, BATCH)
        assert j.insert_documents(docs) == t.insert_documents(emb)
    assert j.delete_documents(list(gone)) == t.delete_documents(list(gone))


def test_networked_replicated_following_engines_match(model, servers,
                                                      tmp_path):
    """Ingest through the shard hosts, the three routes over the wire, a
    replica-served read of each after ``sync_replicas``, and a checkpoint
    over the wire: the same hashes, plans (``served_by`` included),
    answers, and the same bytes in the hosts' and coordinators' stores."""
    pol = (jreplica.FollowerPolicy(max_delay_s=0.005),
           treplica.FollowerPolicy(max_delay_s=0.005))
    j, t = net_engines(model, tmp_path, servers, replicas=(1, 1),
                       follow=pol)
    rng = np.random.default_rng(30)
    ingest(model, j, t, rng)
    assert_alike(j, t)
    prompts = rng.integers(0, model[0].vocab_size, (PROMPTS, 10),
                           dtype=np.int32)
    q = model[2](prompts)
    for route in ("exact", "hnsw", "coarse"):
        j.sc.route = t.sc.route = route
        assert t.retrieval_hash(q) == j.retrieval_hash(prompts)
    assert j.sync_replicas() == t.sync_replicas() == 0
    assert all(a == b for a, b in route_answers(model, j, t, prompts))
    assert t.last_plan.served_by == j.last_plan.served_by
    assert t.last_plan.served_by.startswith("replica:")
    assert all(rep.following and rep.follow_error is None
               for pool in t.read_replicas for rep in pool)
    assert t.checkpoint()["t"] == j.checkpoint()["t"] == t.durable.t
    j.close()
    t.close()
    j.close()
    t.close()  # idempotent
    assert not any(rep.following for pool in t.read_replicas
                   for rep in pool)
    # the reference engine's doc side table of LM tokens has no port yet
    jc = tree_bytes(tmp_path / "jc")
    assert jc.pop("docs.sdt") and tree_bytes(tmp_path / "tc") == jc
    for s in range(N):
        assert tree_bytes(tmp_path / f"th{s}") == \
            tree_bytes(tmp_path / f"jh{s}")
