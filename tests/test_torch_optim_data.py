"""The port's training substrates against the reference's on the same
inputs: the deterministic pipeline (byte for byte), AdamW (1e-6
relative), the integer gradient all-reduce (bit for bit) and the elastic
planner (equal plans)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadam
from repro.optim import compress as jcomp
from repro.runtime import elastic as jel
from repro_torch.core import hashing as th
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adamw as tadam
from repro_torch.optim import compress as tcomp
from repro_torch.runtime import elastic as tel

ADAM_REL = 1e-6


# --------------------------------------------------------------------------- #
# pipeline
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("source", ["synthetic", "file"])
def test_pipeline_byte_for_byte(source, tmp_path):
    kw = dict(seq_len=12, global_batch=8, vocab_size=997, seed=3)
    if source == "file":
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 997, 13 * 37).astype(
            np.int32).tofile(path)
        kw.update(source="file", token_file=str(path))
    else:
        kw.update(num_documents=29)  # several epochs in 8 steps of 8
    ref = jpipe.DeterministicPipeline(jpipe.DataConfig(**kw))
    port = tpipe.DeterministicPipeline(tpipe.DataConfig(**kw))
    for rank, size in [(0, 1), (1, 2), (3, 4)]:
        for step in range(8):
            a, b = ref.batch(step, rank, size), port.batch(step, rank, size)
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (step, rank, k)
    idx = np.arange(1000)
    assert np.array_equal(jpipe.feistel_permute(idx, 1000, 5),
                          tpipe.feistel_permute(idx, 1000, 5))


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)


def test_schedule_and_global_norm():
    cfg = tadam.AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=40)
    jcfg = jadam.AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=40)
    for s in range(0, 45):
        a = jadam.schedule(jcfg, jnp.asarray(s, jnp.int32))
        b = tadam.schedule(cfg, torch.tensor(s, dtype=torch.int32))
        assert b.dtype == torch.float32
        assert _rel(a, b.numpy()) <= ADAM_REL, s
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(33, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32) * 1e3}
    a = jadam.global_norm(jax.tree.map(jnp.asarray, tree))
    b = tadam.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert _rel(a, b.numpy()) <= ADAM_REL


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_reference(clip):
    """Five updates from the same parameters and gradients: the port's
    in-place update against the reference's functional one."""
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(16, 9)).astype(np.float32),
              "s": rng.normal(size=(9,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 3
              for k, v in params.items()} for _ in range(5)]
    jcfg = jadam.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                             grad_clip=clip)
    cfg = tadam.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadam.adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tadam.adamw_init(tp)
    for g in grads:
        jp, js, jm = jadam.adamw_update(
            jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp2, ts2, tm = tadam.adamw_update(
            cfg, tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        assert tp2 is tp and ts2 is ts  # in place
        for k in params:
            assert _rel(jp[k], tp[k].numpy()) <= ADAM_REL, k
            assert _rel(js["m"][k], ts["m"][k].numpy()) <= ADAM_REL, k
            assert _rel(js["v"][k], ts["v"][k].numpy()) <= ADAM_REL, k
        assert int(js["step"]) == int(ts["step"])
        for key in ("grad_norm", "lr"):
            assert _rel(jm[key], tm[key].numpy()) <= ADAM_REL, key


def test_adamw_reduces_quadratic_loss():
    """tests/test_substrates.py's test, on the port."""
    optc = tadam.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                             weight_decay=0.0)
    params = {"x": torch.tensor([5.0, -3.0], requires_grad=True)}
    state = tadam.adamw_init(params)
    for _ in range(60):
        g = torch.autograd.grad(torch.sum(params["x"] ** 2),
                                [params["x"]])[0]
        tadam.adamw_update(optc, params, {"x": g}, state)
    assert float(torch.sum(params["x"].detach() ** 2)) < 0.5


def test_adamw_deterministic():
    """tests/test_substrates.py's test, on the port."""
    optc = tadam.AdamWConfig()

    def run():
        p = {"x": torch.ones((4, 4))}
        s = tadam.adamw_init(p)
        for i in range(5):
            g = {"x": p["x"] * 0.1 * (i + 1)}
            tadam.adamw_update(optc, p, g, s)
        return th.hash_pytree(p)

    assert run() == run()


# --------------------------------------------------------------------------- #
# the integer gradient all-reduce
# --------------------------------------------------------------------------- #


def _pod_grads(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(n, 33, 17)) * 1e-3).astype(np.float32),
            "b": (rng.normal(size=(n, 7)) * 10).astype(np.float32),
            "z": np.zeros((n, 5), np.float32)}


def _per_pod(tree, n=4):
    return [{k: torch.from_numpy(v[i].copy()) for k, v in tree.items()}
            for i in range(n)]


@pytest.mark.parametrize("with_residuals", [False, True])
def test_integer_psum_matches_reference_bit_for_bit(with_residuals):
    """The reference under ``jax.vmap(..., axis_name="pod")`` (its psum and
    pmax over a bound axis) against the port over a list of 4 pods."""
    g = _pod_grads()
    r = None
    if with_residuals:
        rng = np.random.default_rng(9)
        r = {k: (rng.normal(size=v.shape) * 1e-6).astype(np.float32)
             for k, v in g.items()}
    jg = jax.tree.map(jnp.asarray, g)
    if r is None:
        jm = jax.vmap(lambda t: jcomp.integer_psum_grads(t, "pod")[0],
                      axis_name="pod")(jg)
        tm, tr = tcomp.integer_psum_grads(_per_pod(g))
        assert tr is None
    else:
        jm, jr = jax.vmap(lambda t, s: jcomp.integer_psum_grads(
            t, "pod", "Q2.13", s), axis_name="pod")(
            jg, jax.tree.map(jnp.asarray, r))
        tm, tr = tcomp.integer_psum_grads(_per_pod(g), "Q2.13", _per_pod(r))
        for i in range(4):
            for k in g:
                assert np.array_equal(np.asarray(jr[k][i]),
                                      tr[i][k].numpy()), (i, k)
    for k in g:
        assert tm[k].dtype == torch.float32
        for i in range(4):
            assert np.array_equal(np.asarray(jm[k][i]), tm[k].numpy()), k


def test_integer_psum_order_invariant_and_bounded():
    """The mean is the same bits with the pods reversed, and within the
    contract's resolution of the float mean (tests/test_substrates.py's
    bound)."""
    g = _pod_grads(seed=2)
    pods = _per_pod(g)
    fwd, _ = tcomp.integer_psum_grads(pods)
    rev, _ = tcomp.integer_psum_grads(pods[::-1])
    for k in g:
        assert torch.equal(fwd[k], rev[k])
        want = np.mean(g[k], axis=0)
        err = float(np.max(np.abs(fwd[k].numpy() - want)))
        scale = float(np.max(np.abs(g[k])))
        assert err <= scale / (1 << 13) + 1e-9, (k, err, scale)


# --------------------------------------------------------------------------- #
# elastic
# --------------------------------------------------------------------------- #


def test_plan_remesh_matches_reference():
    for chips in range(16, 1025):
        for prefer in (None, 2):
            for model in (16, 8):
                a = jel.plan_remesh(chips, model=model, prefer_pods=prefer)
                b = tel.plan_remesh(chips, model=model, prefer_pods=prefer)
                assert (a.shape, a.axes, a.dropped_chips, a.size) == \
                    (b.shape, b.axes, b.dropped_chips, b.size), chips
    with pytest.raises(ValueError):
        tel.plan_remesh(8, model=16)
