"""Shared pieces of the training parity tests: one REDUCED arch in f32
through the reference's ``loss_fn`` / ``make_train_step`` and the port's
on the same weights (the port's init carried over by ``models.convert``)
and the same seeded batches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config as jax_reduced
from repro.models import transformer as jtf
from repro.optim import adamw as jadam
from repro.train import step as jstep
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.data.pipeline import DataConfig, DeterministicPipeline
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadam
from repro_torch.train import step as tstep

torch.set_num_threads(min(2, torch.get_num_threads()))

LOSS_REL = 1e-5
GRAD_REL = 1e-4    # relative Frobenius error of each gradient leaf
STEPS_REL = 1e-4   # losses over 3 steps of make_train_step
STEPS = 3


def configs(arch):
    return (dataclasses.replace(jax_reduced(arch), dtype="float32"),
            dataclasses.replace(torch_reduced(arch), dtype="float32"))


def batch(cfg, seq, seed=0, b=2):
    """Seeded tokens and next-token labels, a few of them -1 (masked)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, seq + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    labels[-1, -2:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def check_loss_and_grads(arch, seq):
    """loss, ce and aux within LOSS_REL, every gradient leaf within
    GRAD_REL; in the port, remat block (which must run) and none give the
    same bits. Returns the largest gradient error."""
    jcfg, tcfg = configs(arch)
    model = ttf.init_params(tcfg, torch.Generator().manual_seed(7))
    tree = convert.to_reference(model, tcfg)
    b = batch(tcfg, seq)
    (_, jm), jg = jax.jit(jax.value_and_grad(jtf.loss_fn, has_aux=True),
                          static_argnums=2)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in b.items()}, jcfg)

    calls = []
    real = ttf.checkpoint

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    ttf.checkpoint = counting
    try:
        tm, tg = tstep.loss_and_grads(model, b, tcfg)
    finally:
        ttf.checkpoint = real
    assert tcfg.remat == "block" and calls, "remat never ran"
    for key in ("loss", "ce", "aux"):
        a, t = float(jm[key]), float(tm[key])
        assert abs(a - t) <= LOSS_REL * max(abs(a), 1e-30) or a == t, \
            (key, a, t)
    ref = convert.reference_tree({k: v.numpy() for k, v in tg.items()},
                                 tcfg)
    worst = 0.0
    for (path, a), t in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                            jax.tree_util.tree_leaves(ref)):
        assert np.shape(a) == t.shape, path
        e = rel(a, t) if np.any(np.asarray(a)) else \
            float(np.max(np.abs(t), initial=0.0))
        assert e <= GRAD_REL, (jax.tree_util.keystr(path), e)
        worst = max(worst, e)

    _, none = tstep.loss_and_grads(
        model, b, dataclasses.replace(tcfg, remat="none"))
    assert all(torch.equal(tg[k], none[k]) for k in tg), \
        "remat changed a gradient bit"
    return worst


def check_train_steps(arch, seq=16):
    """STEPS of make_train_step on pipeline batches in both packages:
    losses within STEPS_REL. The learning rate is small (1e-5): after a
    step AdamW moves each weight by about lr x sign(g), so where an entry
    of g is near zero the two packages' ulp-level differences in it move
    the weight differently; at 3e-3 that moved the REDUCED models' second
    loss by 4e-3 relative, and it scales with lr."""
    jcfg, tcfg = configs(arch)
    optc = dict(lr=1e-5, warmup_steps=1, total_steps=10)
    model = ttf.init_params(tcfg, torch.Generator().manual_seed(7))
    jp = jax.tree.map(jnp.asarray, convert.to_reference(model, tcfg))
    js = jadam.adamw_init(jp)
    jfn = jax.jit(jstep.make_train_step(jcfg, jadam.AdamWConfig(**optc)))
    tfn = tstep.make_train_step(tcfg, tadam.AdamWConfig(**optc))
    ts = tadam.adamw_init(model)
    data = DeterministicPipeline(DataConfig(
        seq_len=seq, global_batch=2, vocab_size=tcfg.vocab_size, seed=1))
    losses = []
    for s in range(STEPS):
        b = data.batch(s)
        jp, js, jm = jfn(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        _, _, tm = tfn(model, ts, b)
        losses.append((float(jm["loss"]), float(tm["loss"])))
    for a, t in losses:
        assert abs(a - t) <= STEPS_REL * abs(a), losses
    assert int(ts["step"]) == STEPS
    return losses
