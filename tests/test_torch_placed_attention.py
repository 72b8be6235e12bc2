"""Placed attention in the reference's three layouts over ``model``
(``pspec.attn_layout``, ``layers.attention``, ``placement.use_spec`` and
the cache layouts) on ``["cpu"] * n``.

gemma2-2b and qwen2-vl-7b REDUCED have 4 query and 2 key/value heads: on
(data 1, model 4) they take ``q_heads`` (query heads split, K/V
replicated) and on (data 1, model 8) ``sequence`` (each rank attends its
L/8 query rows; qwen2-vl through M-RoPE).

- The layout equals the reference's condition (``repro.models.pspec.
  model_divides`` of the query and key/value heads, as its ``attention``
  reads it) for every arch's CONFIG on (16, 16), (2, 2), (1, 4), (1, 8).
- The placed forward (naive and flash), prefill + decode and one
  ``make_train_step`` equal the unplaced port: logits and loss within
  1e-5, each gradient leaf within 1e-4 (relative Frobenius).
- The placed loss equals the reference's jitted step on the same mesh
  within 1e-5 (one subprocess on eight forced host devices).
- One rank's walked attention ``dot_flops`` without the key/value
  projections (q and o projections, scores, context) are exactly 1/model
  of the unplaced layer's; a walked placed decode step reshards its
  caches from storage to compute and back.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import pspec as jpspec
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import collectives, convert, placement, pspec
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import attention as tattn
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.roofline.op_walk import walk
from repro_torch.train import step as tstep


LOSS_REL = 1e-5
LOGITS_REL = 1e-5
GRAD_REL = 1e-4
B, L = 2, 16
CASES = [("gemma2_2b", (1, 4), "q_heads"), ("gemma2_2b", (1, 8), "sequence"),
         ("qwen2_vl_7b", (1, 4), "q_heads"),
         ("qwen2_vl_7b", (1, 8), "sequence")]
REFERENCE_CASES = [("gemma2_2b", (1, 4)), ("qwen2_vl_7b", (1, 8))]

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro
    from repro.configs import get_reduced_config
    from repro.core import compat
    from repro.models import sharding as shd
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.train.step import make_train_step

    z = np.load(sys.argv[1])
    out = {}
    for case in str(z["cases"]).split(","):
        arch, d, m = case.split(":")
        mesh = compat.make_mesh((int(d), int(m)), ("data", "model"))
        cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
        params = {}
        prefix = f"{case}.p."
        for k in z.files:
            if k.startswith(prefix):
                node = params
                *parents, leaf = k[len(prefix):].split(".")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = jnp.asarray(z[k])
        batch = {k: jnp.asarray(z[f"{case}.{k}"])
                 for k in ("tokens", "embeds", "positions_3d", "labels")
                 if f"{case}.{k}" in z.files}
        step = make_train_step(cfg, AdamWConfig(lr=1e-5))
        with compat.use_mesh(mesh):
            p_sh = shd.param_shardings(jax.eval_shape(lambda: params), cfg,
                                       mesh)
            rep = NamedSharding(mesh, P())
            o_sh = {"m": p_sh, "v": p_sh, "step": rep}
            m_sh = {k: rep for k in ("loss", "ce", "aux", "grad_norm", "lr")}
            _, _, met = jax.jit(step, out_shardings=(p_sh, o_sh, m_sh))(
                params, adamw_init(params), batch)
        out[case] = met["loss"]
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    print("REFERENCE_OK")
""")


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


def _cfg(arch):
    return dataclasses.replace(get_reduced_config(arch), dtype="float32")


def _model(cfg, seed=0):
    return ttf.init_params(cfg, torch.Generator().manual_seed(seed))


def _batch(cfg, length=L, seed=1):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, length)).astype(
        np.int32)}
    out["labels"][0, :3] = -1
    if cfg.external_embeddings:
        out["embeds"] = rng.standard_normal(
            (B, length, cfg.d_model)).astype(np.float32)
        if cfg.rope_type == "mrope":
            out["positions_3d"] = rng.integers(0, 30, (3, B, length)).astype(
                np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, length)).astype(
            np.int32)
    return out


def _key(arch, shape):
    return f"{arch}:{shape[0]}:{shape[1]}"


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _close(got, want, vocab):
    top = float(want[..., :vocab].abs().max())
    return float((got - want)[..., :vocab].abs().max()) <= LOGITS_REL * max(
        1.0, top)


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as tmp:
        init = {}
        for arch, shape in REFERENCE_CASES:
            cfg, key = _cfg(arch), _key(arch, shape)
            leaves = convert.reference_leaves(
                {k: v.detach().numpy() for k, v in
                 _model(cfg).state_dict().items()}, cfg)
            init.update({f"{key}.p.{k}": v for k, v in leaves.items()})
            init.update({f"{key}.{k}": v for k, v in _batch(cfg).items()})
        np.savez(os.path.join(tmp, "in.npz"), cases=",".join(
            _key(a, s) for a, s in REFERENCE_CASES), **init)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        env["PYTHONPATH"] = os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "src"))
        proc = subprocess.run(
            [sys.executable, "-c", _REFERENCE, os.path.join(tmp, "in.npz"),
             os.path.join(tmp, "out.npz")],
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "REFERENCE_OK" in proc.stdout
        with np.load(os.path.join(tmp, "out.npz")) as z:
            return {k: float(z[k]) for k in z.files}


# --------------------------------------------------------------------------- #
# the layout
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(16, 16), (2, 2), (1, 4), (1, 8)])
def test_layout_is_the_reference_condition(monkeypatch, shape):
    """The reference's ``attention`` splits the query heads where
    ``model_divides(num_heads)`` and the key/value heads where also
    ``model_divides(num_kv_heads)``; else it shards q's sequence."""
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": shape[0], "model": shape[1]})
    monkeypatch.setattr(jpspec, "_mesh", lambda: fake)
    mesh = _mesh(shape, "meta")
    seen = set()
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_config(arch)
        if cfg.family == "ssm":
            continue
        if not jpspec.model_divides(jcfg.num_heads):
            want = "sequence"
        elif jpspec.model_divides(jcfg.num_kv_heads):
            want = "heads"
        else:
            want = "q_heads"
        assert pspec.attn_layout(cfg, mesh) == want, arch
        seen.add(want)
        # a rank reads its query heads (and key/value heads) exactly there
        wq = placement.use_spec("blocks.0.attn.wq", (1, 1, 1), cfg, mesh,
                                True)
        wk = placement.use_spec("blocks.0.attn.wk", (1, 1, 1), cfg, mesh,
                                True)
        assert (wq[1] == "model") == (want != "sequence"), arch
        assert (wk[1] == "model") == (want == "heads"), arch
    if shape == (16, 16):
        assert seen == {"heads", "q_heads", "sequence"}


# --------------------------------------------------------------------------- #
# placed against unplaced
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,shape,layout", CASES)
def test_placed_forward_matches_unplaced(arch, shape, layout):
    """The flash path at L = 64 (REDUCED's threshold; zigzag on the
    global layers under ``q_heads`` only); the other tests run naive
    attention at L = 16."""
    cfg, mesh = _cfg(arch), _mesh(shape)
    assert pspec.attn_layout(cfg, mesh) == layout
    model = _model(cfg)
    placed = placement.place(model, cfg, mesh)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 64).items()
             if k != "labels"}
    shards, sharded = placement.place_batch(batch, mesh)
    with torch.no_grad():
        outs = collectives.spmd(mesh, lambda r: ttf.apply(
            placed.view(r), shards[r], cfg)[0],
            [(r,) for r in range(mesh.size)], batch_sharded=sharded)
        want = ttf.apply(model, batch, cfg)[0]
    for o in outs:
        assert _close(o, want, cfg.vocab_size)


@pytest.mark.parametrize("arch,shape,layout", CASES)
def test_placed_train_step_matches_unplaced(arch, shape, layout):
    cfg, mesh = _cfg(arch), _mesh(shape)
    model = _model(cfg)
    batch = _batch(cfg)
    placed = placement.place(model, cfg, mesh)
    metrics, grads = placement.loss_and_grads(placed, batch, cfg)
    loss, want = placement.unplaced_loss_and_grads(model, batch, cfg, mesh)
    assert abs(float(metrics["loss"]) - float(loss)) <= LOSS_REL * abs(
        float(loss))
    for name in placed.shapes:
        got = placement.gather_like(grads, placed, name, "cpu")
        assert _rel(got, want[name]) <= GRAD_REL, name
        # every replica of a block holds the same gradient bits
        for block, first in placed.owners(name).items():
            for j in range(mesh.size):
                if collectives.block(placed.specs[name], placed.shapes[name],
                                     mesh, j) == block:
                    assert torch.equal(grads[j][name], grads[first][name])


@pytest.mark.parametrize("arch,shape,layout", CASES)
def test_placed_prefill_decode_match_unplaced(arch, shape, layout):
    """Prefill, then two decode steps; the caches come back placed by
    ``cache_specs`` (the head_dim over ``model`` where the key/value heads
    do not divide it) and gather to the unplaced caches."""
    cfg, mesh = _cfg(arch), _mesh(shape)
    model = _model(cfg)
    placed = placement.place(model, cfg, mesh)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()
             if k != "labels"}
    rng = np.random.default_rng(4)
    with torch.no_grad():
        got, pc = placement.prefill(placed, batch, 24)
        want, caches = ttf.prefill(model, batch, cfg, 24)
        for t in range(3):
            assert _close(got, want, cfg.vocab_size), t
            if t == 2:
                break
            tok = torch.argmax(want, -1)[:, None].to(torch.int32)
            pos = torch.full((B, 1), L + t, dtype=torch.int32)
            emb = torch.from_numpy(rng.standard_normal(
                (B, 1, cfg.d_model)).astype(np.float32)) \
                if cfg.external_embeddings else None
            tok = None if emb is not None else tok
            got, pc = placement.decode_step(placed, pc, tok, pos, emb)
            want, caches = ttf.decode_step(model, caches, tok, pos, cfg,
                                           embeds=emb)
    assert pc.specs[0]["k"][-1] == "model"
    back = convert.reference_caches(placement.gather_caches(pc), cfg)
    ref = convert.reference_caches(caches, cfg)
    flat_got, flat_want = convert._flatten(back), convert._flatten(ref)
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        assert torch.allclose(flat_got[k].float(), flat_want[k].float(),
                              rtol=1e-5, atol=1e-5), k


def test_q_heads_whose_groups_straddle_ranks():
    """6 query / 3 key/value heads over model 2: rank 0's heads read
    key/value heads 0, 0, 1 and rank 1's 1, 2, 2 (one per query head).
    Forward (flash, zigzag on the global layer), prefill and two decode
    steps equal the unplaced model."""
    cfg = dataclasses.replace(_cfg("gemma2_2b"), num_heads=6,
                              num_kv_heads=3, num_layers=2)
    mesh = _mesh((1, 2))
    assert pspec.attn_layout(cfg, mesh) == "q_heads"
    model = _model(cfg)
    placed = placement.place(model, cfg, mesh)
    tokens = torch.as_tensor(_batch(cfg, 64)["tokens"])
    with torch.no_grad():
        outs = collectives.spmd(mesh, lambda r: ttf.apply(
            placed.view(r), {"tokens": tokens}, cfg)[0], [(0,), (1,)])
        want = ttf.apply(model, {"tokens": tokens}, cfg)[0]
        assert all(_close(o, want, cfg.vocab_size) for o in outs)
        got, pc = placement.prefill(placed, {"tokens": tokens[:, :L]}, 24)
        want, caches = ttf.prefill(model, {"tokens": tokens[:, :L]}, cfg, 24)
        for t in range(2):
            assert _close(got, want, cfg.vocab_size), t
            tok = torch.argmax(want, -1)[:, None].to(torch.int32)
            pos = torch.full((B, 1), L + t, dtype=torch.int32)
            got, pc = placement.decode_step(placed, pc, tok, pos)
            want, caches = ttf.decode_step(model, caches, tok, pos, cfg)
        assert _close(got, want, cfg.vocab_size)


@pytest.mark.parametrize("arch,shape", REFERENCE_CASES)
def test_placed_loss_matches_reference_jitted_step(reference, arch, shape):
    cfg, mesh = _cfg(arch), _mesh(shape)
    placed = placement.place(_model(cfg), cfg, mesh)
    opt = placement.place_opt(adamw_init(_model(cfg)), placed)
    step = tstep.make_train_step(cfg, AdamWConfig(lr=1e-5))
    _, _, m = step(placed, opt, _batch(cfg))
    want = reference[_key(arch, shape)]
    assert abs(float(m["loss"]) - want) <= LOSS_REL * abs(want)


# --------------------------------------------------------------------------- #
# the op walk of one rank
# --------------------------------------------------------------------------- #


def _attention_dots(cfg, mesh, batch, length, local):
    """(the walked dot_flops of one attention layer, those of its key and
    value projections): unplaced with ``mesh`` None, else rank 0's
    program alone on ``meta``."""
    layer = ttf.init_params(dataclasses.replace(cfg, num_layers=2), None
                            ).blocks[0].attn
    D, KV, Dh = cfg.d_model, cfg.num_kv_heads, cfg.head_dim_
    kv = 2 * (2.0 * batch * length * D * KV * Dh)
    positions = torch.zeros((batch, length), dtype=torch.int32,
                            device="meta")
    x = torch.zeros((batch, length, D), dtype=cfg.compute_dtype,
                    device="meta")
    if mesh is None:
        return walk(tattn.attention, layer, x, positions, cfg, local=local,
                    mode="train").dot_flops, kv
    placed = placement.place(layer, cfg, mesh)
    tally = walk(lambda: collectives.solo(mesh, lambda: tattn.attention(
        placed.view(0), x, positions, cfg, local=local, mode="train")))
    return tally.dot_flops, kv


@pytest.mark.parametrize("arch,shape,length,local", [
    ("gemma2_2b", (16, 16), 4096, True),     # sequence, flash
    ("gemma2_2b", (16, 16), 1024, False),    # sequence, naive
    ("qwen2_vl_7b", (1, 8), 1024, False),    # sequence, 28 heads over 8
    ("granite_34b", (16, 16), 4096, False),  # q_heads, zigzag
    ("h2o_danube_1_8b", (16, 16), 4096, True),  # q_heads, window
    ("codeqwen1_5_7b", (16, 16), 4096, False)])  # heads
def test_walked_attention_work_is_one_model_th(arch, shape, length, local):
    """One rank's q and o projections, scores and context are exactly
    1/model of the unplaced layer's (the key/value projections are whole
    under ``q_heads`` and ``sequence``, split under ``heads``). Full
    CONFIGs on ``meta``: nothing is computed."""
    cfg, mesh = get_config(arch), _mesh(shape, "meta")
    m = shape[1]
    whole, kv = _attention_dots(cfg, None, 1, length, local)
    rank, _ = _attention_dots(cfg, mesh, 1, length, local)
    if pspec.attn_layout(cfg, mesh) == "heads":
        assert rank * m == whole
    else:
        assert (rank - kv) * m == whole - kv


def test_walked_decode_reshards_its_caches():
    """gemma2-2b on (16, 16) stores its 4 key/value heads' caches split
    along head_dim over ``model`` and decodes on whole ones: the walked
    placed decode step gathers every k and v leaf in and slices it back
    out (one all-gather each way per leaf, the way out over a group of
    one), on top of the step's own collectives."""
    cfg, mesh = get_config("gemma2_2b"), _mesh((16, 16), "meta")
    cell = specs.build_cell("gemma2_2b", "decode_32k", mesh)
    tally = walk(cell.step)
    caches, (shapes, stored, compute) = specs.cache_struct(
        cfg, mesh, cell.shape.global_batch, cell.shape.seq_len)
    assert stored[0]["k"][1:] == (None, None, "model")
    assert compute[0]["k"][1:] == (None, None, None)
    # the same step with caches already in the compute layout
    placed = specs.params_struct(cfg, mesh)
    B = caches[0]["k"].shape[0]
    whole = placement._tree_map(
        lambda x, s: torch.empty(collectives.shard_shape(s, x, mesh),
                                 dtype=cfg.compute_dtype, device="meta"),
        shapes, compute)
    for c in whole:
        c["pos"] = c["pos"].to(torch.int32)
    bare = walk(lambda: collectives.solo(mesh, lambda: ttf.decode_step(
        placed.view(0), whole, torch.zeros((B, 1), dtype=torch.int32,
                                           device="meta"),
        torch.zeros((B, 1), dtype=torch.int32, device="meta"), cfg)))
    n_leaves = 2 * cfg.num_layers
    got = tally.collective_counts["all-gather"] - \
        bare.collective_counts["all-gather"]
    assert got == 2 * n_leaves
    per_leaf = [c[k].numel() * c[k].element_size() for c in whole
                for k in ("k", "v")]
    m = mesh.shape["model"]
    assert tally.wire_bytes - bare.wire_bytes == pytest.approx(
        sum(per_leaf) * (m - 1) / m, rel=1e-12)
