"""The port's durable sharded engine against the JAX package's, at 2 and 4
shards: both packages fed the same history over their own directories
(checkpoints with per-shard code tables, a re-link policy, a delete
batch), then recovered and rolled back alike; the port recovers the
reference's directory too."""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serve import engine as tengine  # noqa: E402

from _torch_sharded_engine import (BATCH, PROMPTS, SC,  # noqa: E402
                                   assert_alike, embedded_docs, engines,
                                   model, relink_policies, route_answers)

assert model  # a fixture, used by name


@pytest.fixture(scope="module", params=[2, 4])
def durable_dirs(request, model, tmp_path_factory):
    """Both packages' durable sharded engines fed the same history
    (checkpoints every 16 commands with their code tables, a re-link
    policy, a delete batch), then dropped without a close."""
    shards = request.param
    root = tmp_path_factory.mktemp(f"sharded_durable_{shards}")
    pol = relink_policies(0.2)
    j, t = engines(model, shards, root, checkpoint_every=(16, 16),
                    relink=pol)
    rng = np.random.default_rng(6)
    for _ in range(2):
        docs, emb = embedded_docs(model, rng, BATCH)
        assert j.insert_documents(docs) == t.insert_documents(emb)
    gone = [1, 2, 5, 7, 40]
    assert j.delete_documents(gone) == t.delete_documents(gone)
    docs, emb = embedded_docs(model, rng, BATCH)
    assert j.insert_documents(docs) == t.insert_documents(emb)
    j.wait_durable()
    t.wait_durable()
    assert_alike(j, t)
    prompts = rng.integers(0, model[0].vocab_size, (PROMPTS, 10),
                           dtype=np.int32)
    answers = route_answers(model, j, t, prompts)
    assert all(a == b for a, b in answers)
    j.checkpoint()
    t.checkpoint()
    ckpts = t.durable.shards[0].snapshots()
    assert ckpts == j.durable.shards[0].snapshots() and len(ckpts) >= 2
    assert t.durable.merged_records() == j.durable.merged_records()
    for sub in ("codes", "merged"):
        names = sorted(p.name for p in (root / "t").rglob("*")
                       if sub in p.parts)
        assert names == sorted(p.name for p in (root / "j").rglob("*")
                               if sub in p.parts)
    return shards, root, prompts, dict(t=t.durable.t, answers=answers,
                                       t_ckpt=ckpts[1])


def _copy(src, dst):
    for name in ("j", "t"):
        shutil.copytree(src / name, dst / name)
    return dst


def test_durable_sharded_engines_recover_alike(model, durable_dirs, tmp_path):
    """Fresh engines of both packages recover the same (t, hash), canonical
    graph and answers as were served; the port recovers the reference's
    directory too, and the recovered audit logs replay to the state."""
    shards, src, prompts, served = durable_dirs
    root = _copy(src, tmp_path)
    pol = relink_policies(0.2)
    j, t = engines(model, shards, root, relink=pol)
    got = t.recover()
    assert got == j.recover() and got[0] == served["t"]
    assert_alike(j, t)
    assert (t.relink_ts, t.graph_gen) == ([served["t"]], 1)
    assert t.replay_log_fresh() == j.replay_log_fresh() == t.state_hash()
    assert route_answers(model, j, t, prompts) == served["answers"]
    docs, emb = embedded_docs(model, np.random.default_rng(8), BATCH)
    assert t.insert_documents(emb) == j.insert_documents(docs)
    assert_alike(j, t)
    cross = tengine.MemoryAugmentedEngine(
        model[0].d_model, tengine.ServeConfig(
            shards=shards, durable_dir=str(root / "j"), **SC), device="cpu")
    assert cross.recover() == (j.durable.t,
                               j.durable.restore_at(j.durable.t)[1])
    for e in (j, t, cross):
        e.close()


def test_durable_sharded_engines_roll_back_alike(model, durable_dirs,
                                                 tmp_path):
    shards, src, prompts, served = durable_dirs
    root = _copy(src, tmp_path)
    j, t = engines(model, shards, root)
    assert t.recover() == j.recover()
    got = t.rollback_to(served["t_ckpt"])
    assert got == j.rollback_to(served["t_ckpt"])
    assert got[0] == served["t_ckpt"] == t.durable.t
    assert_alike(j, t)
    assert all(a == b for a, b in route_answers(model, j, t, prompts))
    docs, emb = embedded_docs(model, np.random.default_rng(9), BATCH)
    assert t.insert_documents(emb) == j.insert_documents(docs)
    assert_alike(j, t)
    assert t.replay_log_fresh() == t.state_hash()
    for e in (j, t):
        e.close()


