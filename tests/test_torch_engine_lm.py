"""The LM serving path: the reference engine against the port's token engine,
both built from the same weights (``repro_torch.models.convert``), in
float32 compute, on h2o-danube REDUCED (sliding window) and gemma2 REDUCED
(local/global, softcaps, tied and scaled embeddings).

Before the boundary the packages agree within float32 tolerance
(``F32_REL``, as in ``test_torch_models.py``): pooled embeddings and the
per-step logits of a teacher-forced ``generate``. After it, a Q16.16 word
may differ by at most one unit where the float inputs straddle a rounding
edge; the test reports how many do. The port's own paths agree bit for
bit: its token engine and its embedding engine fed that LM's embeddings
hold the same state and answers, and the doc side table (``docs.sdt``)
holds the same bytes as the reference's for the same history.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config as jax_reduced
from repro.core import wal as jwal
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.core import wal as twal
from repro_torch.core.durability import SideTable
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine

F32_REL = 1e-5
# one document shape and one prompt shape: every new shape is a JAX compile
DOCS, DOC_LEN = 8, 16
PROMPTS, PROMPT_LEN = 2, 8
SC = dict(capacity=128, retrieve_k=3, max_new_tokens=4, s_cache=64,
          context_tokens=8)


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    top = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=F32_REL, atol=F32_REL * top)


def engines(arch, **extra):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(torch_reduced(arch), dtype="float32")
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    model = convert.from_reference(tree, tcfg)
    return (jcfg, tcfg, jparams, model,
            lambda **kw: jengine.MemoryAugmentedEngine(
                jcfg, jparams, jengine.ServeConfig(**SC, **extra, **kw)),
            lambda **kw: tengine.MemoryAugmentedEngine(
                tcfg, model, tengine.ServeConfig(**SC, **extra, **kw),
                device="cpu"))


def doc_batches(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (DOCS, DOC_LEN), dtype=np.int32)
            for _ in range(n)]


def make_pair(arch):
    """The reference engine ``j``, the port's token engine ``t`` and its
    embedding engine ``e`` (fed ``t``'s LM), through three inserts and a
    delete."""
    jcfg, tcfg, jparams, model, jmake, tmake = engines(arch)
    j, t = jmake(), tmake()
    e = tengine.MemoryAugmentedEngine(tcfg.d_model, tengine.ServeConfig(**SC),
                                      device="cpu")
    batches = doc_batches(jcfg.vocab_size, 3, 0)
    for docs in batches:
        ids = j.insert_documents(docs)
        assert t.insert_documents(docs) == ids
        assert e.insert_documents(t._embed_batch(docs)) == ids
    for eng in (j, t, e):
        eng.delete_documents([2, 5, 99])
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (PROMPTS, PROMPT_LEN), dtype=np.int32)
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, j=j, t=t, e=e,
                                 batches=batches, prompts=prompts)


@pytest.fixture(scope="module", params=["h2o_danube_1_8b", "gemma2_2b"])
def pair(request):
    return make_pair(request.param)


def test_pooled_embeddings_agree(pair):
    for tokens in (pair.batches[0], pair.prompts):
        want = pair.j._embed_fn(pair.j.params, jnp.asarray(tokens))
        close(pair.t._embed_batch(tokens), want)


def test_boundary_words_differ_by_at_most_one(pair):
    """The log's Q16.16 rows: every word equal or one unit apart."""
    jvec = np.asarray(pair.j.log.vec).astype(np.int64)
    tvec = pair.t.log.vec.numpy().astype(np.int64)
    assert jvec.shape == tvec.shape
    diff = np.abs(jvec - tvec)
    print(f"\n{pair.jcfg.name}: {int((diff != 0).sum())} of {diff.size} "
          f"Q16.16 words differ between the packages (max {diff.max()})")
    assert diff.max() <= 1


def test_token_engine_equals_embedding_engine_bit_for_bit(pair):
    t, e = pair.t, pair.e
    assert t.state_hash() == e.state_hash()
    assert t.memory_hash() == e.memory_hash()
    assert torch.equal(t.log.vec, e.log.vec)
    for route in ("auto", "exact", "hnsw"):
        t.sc.route = e.sc.route = route
        try:
            tid, tsc = t.retrieve(pair.prompts)
            eid, esc = e.retrieve(t._embed_batch(pair.prompts))
            assert np.array_equal(tid, eid) and np.array_equal(tsc, esc)
            assert t.last_plan == e.last_plan
        finally:
            t.sc.route = e.sc.route = "auto"
    assert t.retrieval_hash(pair.prompts) == \
        e.retrieval_hash(t._embed_batch(pair.prompts))
    assert t.replay_log_fresh() == t.state_hash()


def test_retrieval_and_doc_cache_match_reference(pair):
    jid, _ = pair.j.retrieve(pair.prompts)
    tid, _ = pair.t.retrieve(pair.prompts)
    assert np.array_equal(tid, jid)
    assert sorted(pair.t.docs) == sorted(pair.j.docs)
    for key, doc in pair.j.docs.items():
        assert np.array_equal(pair.t.docs[key], doc)


def _augmented(eng, prompts):
    """The reference's augmented prompt: the top hit's first
    ``context_tokens`` tokens, right-aligned, before the prompt."""
    ids, _ = eng.retrieve(prompts)
    ctx = np.zeros((len(prompts), eng.sc.context_tokens), np.int32)
    for b in range(len(prompts)):
        doc = eng.docs.get(int(ids[b, 0]))
        if doc is not None:
            n = min(len(doc), eng.sc.context_tokens)
            ctx[b, -n:] = doc[:n]
    return np.concatenate([ctx, prompts], axis=1)


def test_generate_teacher_forced_matches_reference(pair):
    """Prefill the reference's augmented prompt in both packages, then feed
    both the reference's greedy tokens: the logits of every step agree,
    and the port's greedy choice equals the reference's at every step
    whose top-2 margin exceeds twice the tolerance."""
    j, t = pair.j, pair.t
    aug = _augmented(j, pair.prompts)
    assert np.array_equal(t._augmented(pair.prompts), aug)
    want_tokens = j.generate(pair.prompts)
    L = aug.shape[1]
    jl, jc = jtf.prefill(j.params, {"tokens": jnp.asarray(aug)}, pair.jcfg,
                         SC["s_cache"])
    with torch.no_grad():
        tl, tc = ttf.prefill(t.params, {"tokens": torch.from_numpy(aug)},
                             pair.tcfg, SC["s_cache"])
        decided = True
        for s in range(SC["max_new_tokens"]):
            jl_np = np.asarray(jl)
            close(tl, jl_np)
            top2 = np.sort(jl_np, axis=-1)[:, -2:]
            margin_ok = (top2[:, 1] - top2[:, 0]) > \
                2 * F32_REL * max(1.0, float(np.abs(jl_np).max()))
            assert np.array_equal(want_tokens[:, s], jl_np.argmax(-1)) or \
                not margin_ok.all()
            got = tl.argmax(-1).numpy()
            assert np.array_equal(got[margin_ok], jl_np.argmax(-1)[margin_ok])
            decided &= bool(margin_ok.all())
            if s + 1 == SC["max_new_tokens"]:
                break
            tok = want_tokens[:, s:s + 1]
            pos = np.full((PROMPTS, 1), L + s, np.int32)
            jl, jc = jtf.decode_step(j.params, jc, jnp.asarray(tok),
                                     jnp.asarray(pos), pair.jcfg)
            tl, tc = ttf.decode_step(t.params, tc, torch.from_numpy(tok),
                                     torch.from_numpy(pos), pair.tcfg)
    out = t.generate(pair.prompts)
    assert out.shape == (PROMPTS, SC["max_new_tokens"])
    assert np.array_equal(out, t.generate(pair.prompts))
    if decided:
        assert np.array_equal(out, want_tokens)


def test_embedding_engine_has_no_lm(pair):
    with pytest.raises(ValueError, match="no LM"):
        pair.e.generate(pair.prompts)
    with pytest.raises(ValueError, match="params are on"):
        tengine.MemoryAugmentedEngine(pair.tcfg, pair.t.params,
                                      tengine.ServeConfig(**SC),
                                      device="meta")


# --------------------------------------------------------------------------- #
# durable mode: the doc side table
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def danube():
    return engines("h2o_danube_1_8b")


def test_doc_side_table_bytes_match_reference(danube, tmp_path):
    """The same ingest / delete / checkpoint / rollback / reinsert history
    writes the same ``docs.sdt`` in both packages, and both recover the
    same doc cache from it."""
    jcfg, tcfg, _, _, jmake, tmake = danube
    a, b, c = doc_batches(jcfg.vocab_size, 3, 2)
    engs = {"j": jmake(durable_dir=str(tmp_path / "j")),
            "t": tmake(durable_dir=str(tmp_path / "t"))}
    for eng in engs.values():
        eng.insert_documents(a)
        eng.checkpoint()
        eng.insert_documents(b)
        eng.delete_documents([1, 9])
        assert eng.rollback_to(DOCS)[0] == DOCS
        assert eng.insert_documents(c) == list(range(DOCS, 2 * DOCS))
        eng.close()
    assert (tmp_path / "j" / "docs.sdt").read_bytes() == \
        (tmp_path / "t" / "docs.sdt").read_bytes()
    j2 = jmake(durable_dir=str(tmp_path / "j"))
    t2 = tmake(durable_dir=str(tmp_path / "t"))
    assert j2.recover()[0] == t2.recover()[0] == 2 * DOCS
    assert sorted(t2.docs) == sorted(j2.docs)
    for key in j2.docs:
        assert np.array_equal(t2.docs[key], j2.docs[key])
    assert np.array_equal(t2.docs[DOCS], c[0])
    j2.close()
    t2.close()


def test_doc_cache_recovers_from_side_table(danube, tmp_path):
    """The reference's warm-recover scenario on the port: the recovered
    engine's doc cache reloads from the side table, so generation
    conditions on the same retrieved context as before the crash."""
    jcfg, _, _, _, _, tmake = danube
    sc = dict(durable_dir=str(tmp_path / "d"))
    eng = tmake(**sc)
    (docs,) = doc_batches(jcfg.vocab_size, 1, 11)
    eng.insert_documents(docs)
    prompts = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (PROMPTS, PROMPT_LEN), dtype=np.int32)
    out_a = eng.generate(prompts)
    eng2 = tmake(**sc)  # "crash": no close
    assert eng2.recover()[0] == DOCS
    assert sorted(eng2.docs) == sorted(eng.docs)
    for key in eng.docs:
        assert np.array_equal(eng2.docs[key], eng.docs[key])
    assert np.array_equal(eng2.generate(prompts), out_a)
    eng2.close()


def test_doc_side_table_never_lags_reused_ids(danube, tmp_path):
    """Rollback then reinsert reuses ids; a crash right after the insert
    (no read barrier, no flush) must still recover the new tokens."""
    jcfg, _, _, _, _, tmake = danube
    sc = dict(durable_dir=str(tmp_path / "d"))
    eng = tmake(**sc)
    a, b = doc_batches(jcfg.vocab_size, 2, 17)
    eng.insert_documents(a)
    eng.rollback_to(3)
    assert eng.insert_documents(b)[0] == 3  # id 3 reused, new content
    eng2 = tmake(**sc)
    assert eng2.recover()[0] == 3 + DOCS
    assert np.array_equal(eng2.docs[3], b[0])
    eng2.close()


@pytest.mark.parametrize("package", ["reference", "port"])
def test_group_commit_policy_flush_syncs_doc_table(danube, tmp_path,
                                                    package):
    """A policy flush inside submit (max_batch reached) syncs the doc side
    table through the writer's pre_flush hook, in both packages."""
    jcfg, _, _, _, jmake, tmake = danube
    make, wal = (jmake, jwal) if package == "reference" else (tmake, twal)
    eng = make(durable_dir=str(tmp_path / "d"),
               group_commit=wal.GroupCommitPolicy(max_batch=DOCS,
                                                  max_delay_s=3600))
    (docs,) = doc_batches(jcfg.vocab_size, 1, 19)
    eng.insert_documents(docs)  # max_batch hit: flushes inside submit
    assert eng.durable.t == DOCS
    table = SideTable(tmp_path / "d" / "docs.sdt")  # what is on disk
    try:
        assert sorted(table.entries) == list(range(DOCS))
    finally:
        table.close()
    eng.close()


def test_recovered_doc_cache_holds_exactly_the_live_ids(danube, tmp_path):
    """After recover and rollback both packages reload every side-table
    record: the cache holds exactly the live ids' tokens, plus the inert
    records of dead ids (a deleted id, ids rolled away), the same keys and
    tokens in both."""
    jcfg, _, _, _, jmake, tmake = danube
    a, b = doc_batches(jcfg.vocab_size, 2, 23)
    for make, name in ((jmake, "j"), (tmake, "t")):
        eng = make(durable_dir=str(tmp_path / name))
        eng.insert_documents(a)
        eng.insert_documents(b)
        eng.delete_documents([3])
        eng.close()
    j = jmake(durable_dir=str(tmp_path / "j"))
    t = tmake(durable_dir=str(tmp_path / "t"))
    docs = np.concatenate([a, b])

    def same_cache(live):
        assert sorted(t.docs) == sorted(j.docs)
        for key in t.docs:
            assert np.array_equal(t.docs[key], j.docs[key])
        ids = t.memory.ids[t.memory.valid].tolist()
        assert sorted(ids) == live
        for key in live:
            assert np.array_equal(t.docs[key], docs[key])

    for eng in (j, t):
        eng.recover()
    same_cache(sorted(set(range(2 * DOCS)) - {3}))
    assert set(t.docs) == set(range(2 * DOCS))
    for eng in (j, t):
        eng.rollback_to(DOCS)
    same_cache(list(range(DOCS)))
    assert set(t.docs) == set(range(2 * DOCS))
    j.close()
    t.close()
