"""Block remat under a mesh (``collectives.remat``,
``transformer._maybe_remat``) on ``["cpu"] * n``.

- A placed train step with ``remat = "block"`` recomputes each block
  (every rank's together) and equals the same step with ``remat = "none"``
  bit for bit: the loss, every gradient, the parameters and AdamW's state
  after the update. It saves fewer bytes for the backward pass (counted
  through ``torch.autograd.graph.saved_tensors_hooks`` in each rank).
  Cases: gemma2-2b REDUCED on (1, 4) (``q_heads``), qwen2-vl-7b on (1, 8)
  (``sequence``) and granite-moe on (2, 2) (``heads``, expert-parallel).
- The walk of one rank's placed step counts the recompute, as the run
  does: its ``dot_flops`` exceed the walk without remat by the forward
  blocks' products.
- A block whose recompute saves other tensors than its forward is an
  error; a collective inside a remat block meets its peers on recompute,
  also with sixteen ranks and the interpreter switching threads every
  microsecond.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import collectives, placement
from repro_torch.models import transformer as ttf
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.roofline.op_walk import walk


B, L = 4, 16
CASES = [("gemma2_2b", (1, 4)), ("qwen2_vl_7b", (1, 8)),
         ("granite_moe_3b_a800m", (2, 2))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank():
    """Eight ranks' threads with one intra-op thread each: the test
    workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mesh(shape, device="cpu"):
    return Mesh(("data", "model"), shape, (device,) * (shape[0] * shape[1]))


def _cfg(arch, remat="block"):
    return dataclasses.replace(get_reduced_config(arch), dtype="float32",
                               remat=remat)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, L)).astype(
        np.int32)}
    if cfg.external_embeddings:
        out["embeds"] = rng.standard_normal(
            (B, L, cfg.d_model)).astype(np.float32)
        out["positions_3d"] = rng.integers(0, 30, (3, B, L)).astype(np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, L)).astype(
            np.int32)
    return out


def _step(cfg, mesh, monkeypatch):
    """One placed step from seed 0, as ``placement.train_step`` takes it:
    (metrics, the gradients, the parameters and AdamW state after it,
    the bytes every rank's forward saved for the backward pass, the
    blocks recomputed)."""
    model = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    placed = placement.place(model, cfg, mesh)
    opt = placement.place_opt(adamw_init(model), placed)
    saved = [0]
    apply = ttf.apply

    def counting(*args):
        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return apply(*args)

    recomputes = [0]
    recompute = collectives._RematGroup._recompute

    def counted(group):
        recomputes[0] += 1
        return recompute(group)

    monkeypatch.setattr(ttf, "apply", counting)
    monkeypatch.setattr(collectives._RematGroup, "_recompute", counted)
    metrics, grads = placement.loss_and_grads(placed, _batch(cfg), cfg)
    monkeypatch.undo()
    gnorm = placement.global_norm(placed, grads)
    for r in range(mesh.size):
        adamw_update(AdamWConfig(lr=1e-3), placed.shards[r], grads[r],
                     opt[r], gnorm=gnorm)
    return metrics, grads, placed.shards, opt, saved[0], recomputes[0]


@pytest.mark.parametrize("arch,shape", CASES)
def test_placed_remat_step_equals_no_remat_bit_for_bit(monkeypatch, arch,
                                                      shape):
    mesh = _mesh(shape)
    cfg = _cfg(arch)
    m1, g1, p1, o1, saved1, n1 = _step(cfg, mesh, monkeypatch)
    m0, g0, p0, o0, saved0, n0 = _step(_cfg(arch, "none"), mesh,
                                       monkeypatch)
    units = cfg.num_layers // (2 if cfg.attn_pattern == "local_global"
                               else 1)
    assert (n1, n0) == (units, 0)
    for k in ("loss", "ce", "aux"):
        assert torch.equal(m1[k], m0[k]), k
    for r in range(mesh.size):
        for name in g0[r]:
            assert torch.equal(g1[r][name], g0[r][name]), (r, name)
            assert torch.equal(p1[r][name], p0[r][name]), (r, name)
            assert torch.equal(o1[r]["m"][name], o0[r]["m"][name])
            assert torch.equal(o1[r]["v"][name], o0[r]["v"][name])
    # the blocks' activations are not kept
    assert saved1 < saved0 / 2, (saved1, saved0)


def test_walk_counts_the_recompute_as_the_run_does():
    """One rank of gemma2-2b REDUCED on (1, 4), alone on ``meta``: with
    remat the walk's products are the walk without remat plus one more
    forward pass of the blocks."""
    mesh = _mesh((1, 4), "meta")

    def dots(cfg, grad):
        model = ttf.init_params(cfg, None)
        placed = placement.place(model, cfg, mesh)
        leaves = {k: t.requires_grad_(grad)
                  for k, t in placed.shards[0].items()}
        batch = {k: torch.zeros((B, L), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}

        def run():
            with torch.set_grad_enabled(grad):
                logits, _ = ttf.apply(placed.view(0, leaves), batch, cfg)
                if grad:
                    torch.autograd.grad(logits.sum(), list(leaves.values()),
                                        allow_unused=True)
            return logits

        return walk(lambda: collectives.solo(mesh, run)).dot_flops

    cfg = _cfg("gemma2_2b")
    with_remat = dots(cfg, True)
    without = dots(_cfg("gemma2_2b", "none"), True)
    # the 4 layers' forward products: twice those of 2 layers
    half = dots(cfg, False) - dots(dataclasses.replace(cfg, num_layers=2),
                                   False)
    assert with_remat - without == 2 * half > 0


def test_remat_recompute_meets_collectives_and_checks_its_saves():
    """Two ranks; the block sums over ``model`` inside: the gradients with
    remat equal those without bit for bit. A block that saves another
    number of tensors on recompute raises."""
    mesh = _mesh((1, 2))
    w = [torch.tensor([1.5, -2.0, 0.25]) * (r + 1) for r in range(2)]

    def grads(remat, twist=False):
        backward = [False]

        def block(x, w):
            y = torch.tanh(x * w)
            if twist and backward[0]:
                y = torch.sin(y)
            return collectives.psum(torch.exp(y), "model")

        def rank(r):
            x = torch.linspace(-1.0, 1.0, 3).requires_grad_()
            wr = w[r].clone().requires_grad_()
            fn = collectives.remat(block) if remat else block
            return fn(x, wr).sum(), x, wr

        outs = collectives.spmd(mesh, rank, [(r,) for r in range(2)])
        total = outs[0][0] + outs[1][0]
        backward[0] = True
        return torch.autograd.grad(total, [t for o in outs for t in o[1:]])

    for a, b in zip(grads(True), grads(False)):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="saved"):
        grads(True, twist=True)
    with pytest.raises(RuntimeError, match="spmd"):
        collectives.remat(torch.tanh)


def test_remat_under_thread_switching_many_ranks():
    """Sixteen ranks on (2, 8), twelve remat blocks each with sums over
    both axes, the interpreter switching threads every microsecond: each
    block is recomputed once for all ranks and the gradients equal those
    without remat bit for bit; the run ends within its time bound."""
    mesh = _mesh((2, 8))
    n_blocks = 12

    def block(x, scale):
        y = torch.tanh(x * scale)
        y = collectives.psum(y, "model") * 0.125
        return collectives.psum(torch.sin(y), "data") * 0.5

    def run(remat, out):
        def rank(r):
            x0 = torch.full((4,), 0.1 * (r + 1)).requires_grad_()
            x = x0
            for i in range(n_blocks):
                fn = collectives.remat(block) if remat else block
                x = fn(x, torch.tensor(1.0 + 0.01 * i))
            return x.sum(), x0

        outs = collectives.spmd(mesh, rank, [(r,) for r in
                                             range(mesh.size)])
        total = torch.stack([o[0] for o in outs]).sum()
        out.extend(torch.autograd.grad(total, [o[1] for o in outs]))

    recomputes = [0]
    recompute = collectives._RematGroup._recompute

    def counted(group):
        recomputes[0] += 1
        return recompute(group)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    results = {True: [], False: []}
    try:
        collectives._RematGroup._recompute = counted
        for remat in (True, False):
            t = threading.Thread(target=run, args=(remat, results[remat]),
                                 daemon=True)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive(), "the placed run did not finish"
    finally:
        collectives._RematGroup._recompute = recompute
        sys.setswitchinterval(old)
    assert recomputes[0] == n_blocks
    assert len(results[True]) == mesh.size
    for a, b in zip(results[True], results[False]):
        assert torch.equal(a, b)
