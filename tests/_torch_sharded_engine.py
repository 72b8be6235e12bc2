"""Shared pieces of the sharded engine tests: the reference engine's own
embedder, a JAX / port sharded engine pair, each route's answers from both,
and the engines' common facts."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402,F401
from repro.configs import get_reduced_config  # noqa: E402
from repro.core import hnsw as jhnsw  # noqa: E402
from repro.models import transformer as tf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.core import hnsw as thnsw  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ROUTES = ("exact", "hnsw", "coarse")
SC = dict(capacity=128, retrieve_k=3, ef=16, ef_coarse=16)
# one token-batch shape and one prompt shape throughout: every new shape
# costs the reference a compile
BATCH, PROMPTS = 16, 4


@pytest.fixture(scope="module")
def model():
    """(model config, params, embed): embed maps token batches to the
    reference engine's float32 embeddings, which both engines ingest."""
    cfg = get_reduced_config("h2o_danube_1_8b")
    params = tf.init_params(cfg, jax.random.PRNGKey(0))
    j = jengine.MemoryAugmentedEngine(cfg, params, jengine.ServeConfig(
        max_new_tokens=4, s_cache=96, context_tokens=8, **SC))

    def embed(tokens):
        return np.asarray(j._embed_fn(j.params, jnp.asarray(tokens)))

    return cfg, params, embed


def relink_policies(dead_ratio):
    """(the reference's, the port's) RelinkPolicy."""
    kw = dict(dead_ratio=dead_ratio, min_deletes=2, check_every=4)
    return jhnsw.RelinkPolicy(**kw), thnsw.RelinkPolicy(**kw)


def engines(model, shards, root=None, **extra):
    """A JAX / port sharded engine pair (durable over ``root/j`` and
    ``root/t`` when ``root`` is given); ``extra`` maps a ServeConfig field
    to (the reference's value, the port's value)."""
    cfg, params, _ = model
    jx = {k: v[0] for k, v in extra.items()}
    tx = {k: v[1] for k, v in extra.items()}
    if root is not None:
        jx["durable_dir"], tx["durable_dir"] = str(root / "j"), str(root / "t")
    j = jengine.MemoryAugmentedEngine(cfg, params, jengine.ServeConfig(
        max_new_tokens=4, s_cache=96, context_tokens=8, shards=shards, **SC,
        **jx))
    t = tengine.MemoryAugmentedEngine(cfg.d_model, tengine.ServeConfig(
        shards=shards, **SC, **tx), device="cpu")
    return j, t


def embedded_docs(model, rng, n):
    """(token batch, its embeddings)."""
    cfg, _, embed = model
    tokens = rng.integers(0, cfg.vocab_size, (n, 16), dtype=np.int32)
    return tokens, embed(tokens)


def route_answers(model, j, t, prompts):
    """Each route's (reference, port) retrieval hash; the plans and the
    (ids, scores) must agree on the way."""
    q = model[2](prompts)
    out = []
    for route in ROUTES:
        j.sc.route = t.sc.route = route
        ja, ta = j.retrieve(prompts), t.retrieve(q)
        assert dataclasses.asdict(t.last_plan) == \
            dataclasses.asdict(j.last_plan)
        assert np.array_equal(ta[0], ja[0]) and np.array_equal(ta[1], ja[1])
        out.append((j.retrieval_hash(prompts), t.retrieval_hash(q)))
    j.sc.route = t.sc.route = "auto"
    return out


def assert_alike(j, t):
    assert t.state_hash() == j.state_hash()
    assert t.memory_hash() == j.memory_hash()
    assert (t.relink_ts, t.graph_gen) == (j.relink_ts, j.graph_gen)
    if t.durable is not None:
        assert t.durable.t == j.durable.t
        assert t.durable.shard_ts() == j.durable.shard_ts()
