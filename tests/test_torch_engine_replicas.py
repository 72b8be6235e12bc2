"""The port's replica pools through recover and rollback: the networked
engine's pool respawned (against the reference engine without a pool),
and the flat durable engine's pool against the reference's, fed the same
embeddings (the reference engine's own embedder)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve import engine as jengine  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

from _torch_sharded_engine import (PROMPTS, SC, assert_alike,  # noqa: E402
                                   model, route_answers)
from test_torch_engine_net import (N, ingest, net_engines,  # noqa: E402
                                   servers)

assert model and servers  # fixtures, used by name


def test_networked_recover_and_rollback_respawn_the_pool(model, servers,
                                                         tmp_path):
    """The port's networked engine with a replica pool against the
    reference's without one (the reference's respawn refuses past t=0,
    see ``test_flat_pool_matches_and_respawns``): recover and rollback
    land on the same (t, hash) and answers; the respawned pool re-earns
    the cursor and then serves the same bits."""
    j, t = net_engines(model, tmp_path, servers, replicas=(0, 1))
    rng = np.random.default_rng(31)
    ingest(model, j, t, rng, batches=1, gone=())
    t_ckpt = t.checkpoint()["t"]
    assert j.checkpoint()["t"] == t_ckpt
    ingest(model, j, t, rng, batches=1)
    assert t.sync_replicas() == 0
    prompts = rng.integers(0, model[0].vocab_size, (PROMPTS, 10),
                           dtype=np.int32)
    q = model[2](prompts)
    for step in (lambda e: e.recover(), lambda e: e.rollback_to(t_ckpt)):
        assert step(t) == step(j)
        assert [rep.t for pool in t.read_replicas for rep in pool] == \
            [0] * N
        assert t.sync_replicas() == 0
        for route in ("exact", "coarse"):
            j.sc.route = t.sc.route = route
            assert t.retrieval_hash(q) == j.retrieval_hash(prompts)
            assert t.last_plan.served_by == "replica:" + \
                t.last_plan.served_by.split(":")[-1]
            assert j.last_plan.served_by == "primary"
        assert_alike(j, t)
    j.close()
    t.close()


def test_flat_pool_matches_and_respawns(model, tmp_path):
    """The flat durable engine's pool (replicas following the engine's own
    store): synced reads are replica-served alike, a stale pool falls back
    to the primary alike; after ``recover`` the reference refuses to
    respawn its pool (it seeds replicas with the live state, which a
    replica refuses past t=0) while the port respawns from genesis, lands
    on the same state and re-earns the pool."""
    cfg, params, embed = model
    j = jengine.MemoryAugmentedEngine(cfg, params, jengine.ServeConfig(
        max_new_tokens=4, s_cache=96, context_tokens=8, replicas=1,
        durable_dir=str(tmp_path / "j"), **SC))
    t = tengine.MemoryAugmentedEngine(cfg.d_model, tengine.ServeConfig(
        replicas=1, durable_dir=str(tmp_path / "t"), **SC), device="cpu")
    rng = np.random.default_rng(32)
    ingest(model, j, t, rng, batches=1, gone=())
    assert j.sync_replicas() == t.sync_replicas() == 0
    prompts = rng.integers(0, cfg.vocab_size, (PROMPTS, 10), dtype=np.int32)
    assert all(a == b for a, b in route_answers(model, j, t, prompts))
    ingest(model, j, t, rng, batches=1)
    j.sc.route = t.sc.route = "exact"
    assert t.retrieval_hash(embed(prompts)) == j.retrieval_hash(prompts)
    assert t.last_plan.served_by == j.last_plan.served_by == "primary"
    with pytest.raises(ValueError, match="genesis must be at t=0"):
        j.recover()
    assert t.recover() == (t.durable.t, j.state_hash())
    assert t.sync_replicas() == 0
    assert t.retrieval_hash(embed(prompts)) == j.retrieval_hash(prompts)
    assert t.last_plan.served_by == "replica:0"
    t.close()
