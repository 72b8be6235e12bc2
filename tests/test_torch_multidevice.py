"""Multi-device execution (``models.placement``, ``models.collectives``,
``models.pspec``, the MoE's expert-parallel path) on ``["cpu"] * 4``.

The reference runs in one subprocess on four forced host devices: each
leaf's ``NamedSharding(mesh, spec).shard_shape`` for every arch's CONFIG
(parameters and decode caches) on (data 2, model 2) and (data 1, model 4);
its ``shard_map`` MoE on phi3.5-moe REDUCED; and its jitted
``make_train_step`` on a (2, 2) mesh from the port's initial weights.

- Every rank's shard of every parameter, AdamW moment and cache leaf has
  the reference's shard shape.
- The placed REDUCED forward and one ``make_train_step`` equal the
  unplaced port: logits and loss within 1e-5, each gradient leaf within
  1e-4 (relative Frobenius). Where the MoE takes the expert-parallel path
  with two data-parallel ranks, its capacity is per data shard (as the
  reference's), so the unplaced side runs each data shard's batch on its
  own. The placed loss equals the reference's jitted step within 1e-5.
- The expert-parallel MoE equals the one-device path bit for bit (on each
  data shard's batch) and the reference's ``shard_map`` within 1e-5; it
  runs exactly where the reference's condition holds.
- Two placed runs are bit-identical; placed prefill and decode equal the
  unplaced ones.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import make_coordinator
from repro_torch.models import collectives, convert, placement, pspec
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import moe as tmoe
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train import step as tstep

torch.set_num_threads(min(2, torch.get_num_threads()))

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
LOSS_REL = 1e-5
LOGITS_REL = 1e-5
GRAD_REL = 1e-4
B, L = 4, 16
TRAIN_ARCHS = ["gemma2_2b", "qwen2_vl_7b", "granite_moe_3b_a800m"]

_REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro
    from repro.configs import ARCH_IDS, get_config, get_reduced_config
    from repro.core import compat
    from repro.models import sharding as shd, transformer as tf
    from repro.models.layers import moe as moe_lib
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.train.step import make_train_step

    z = np.load(sys.argv[1])
    out, shapes = {}, {}
    meshes = {"2x2": compat.make_mesh((2, 2), ("data", "model")),
              "1x4": compat.make_mesh((1, 4), ("data", "model"))}

    def name(path):
        return ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)

    for mname, mesh in meshes.items():
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            ps = jax.eval_shape(lambda: tf.init_params(
                cfg, jax.random.PRNGKey(0)))
            specs = shd.param_specs(ps, cfg, mesh)
            for (path, leaf), spec in zip(
                    jax.tree_util.tree_flatten_with_path(ps)[0],
                    jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                        x, P))):
                shapes[f"{mname}|{arch}|p|{name(path)}"] = list(
                    NamedSharding(mesh, spec).shard_shape(leaf.shape))
            cs = jax.eval_shape(lambda: tf.init_caches(cfg, 4, 64))
            cspecs = shd.cache_specs(cfg, mesh, 4, cs)
            for (path, leaf), spec in zip(
                    jax.tree_util.tree_flatten_with_path(cs)[0],
                    jax.tree.leaves(cspecs, is_leaf=lambda x: isinstance(
                        x, P))):
                shapes[f"{mname}|{arch}|c|{name(path)}"] = list(
                    NamedSharding(mesh, spec).shard_shape(leaf.shape))

    def unflatten(prefix):
        tree = {}
        for k in z.files:
            if not k.startswith(prefix):
                continue
            node = tree
            *parents, leaf = k[len(prefix):].split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(z[k])
        return tree

    # the MoE: dense, and shard_map under each mesh
    cfg = dataclasses.replace(get_reduced_config("phi3_5_moe_42b_a6_6b"),
                              dtype="float32")
    moe = unflatten("moe.")
    x = jnp.asarray(z["moe_x"])
    out["moe_dense"], out["moe_dense_aux"] = moe_lib._moe_dense(moe, x, cfg)
    for mname, mesh in meshes.items():
        with compat.use_mesh(mesh):
            y, aux = jax.jit(lambda p, x: moe_lib.moe_ffn(p, x, cfg))(moe, x)
        out[f"moe_ep_{mname}"], out[f"moe_ep_aux_{mname}"] = y, aux
    out["moe_ep_equals_dense_1x4"] = np.asarray(
        float(jnp.max(jnp.abs(out["moe_ep_1x4"] - out["moe_dense"]))) == 0.0)

    # the jitted train step on the (2, 2) mesh
    mesh = meshes["2x2"]
    for arch in str(z["train_archs"]).split(","):
        cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
        params = unflatten(f"{arch}.p.")
        batch = {k: jnp.asarray(z[f"{arch}.{k}"])
                 for k in ("tokens", "embeds", "positions_3d", "labels")
                 if f"{arch}.{k}" in z.files}
        opt = adamw_init(params)
        step = make_train_step(cfg, AdamWConfig(lr=1e-5))
        with compat.use_mesh(mesh):
            p_sh = shd.param_shardings(jax.eval_shape(lambda: params), cfg,
                                       mesh)
            rep = NamedSharding(mesh, P())
            o_sh = {"m": p_sh, "v": p_sh, "step": rep}
            m_sh = {k: rep for k in ("loss", "ce", "aux", "grad_norm", "lr")}
            _, _, m = jax.jit(step, out_shardings=(p_sh, o_sh, m_sh))(
                params, opt, batch)
        out[f"{arch}.loss"] = m["loss"]
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    with open(sys.argv[3], "w") as f:
        json.dump(shapes, f)
    print("REFERENCE_OK")
""")


def _mesh(name, devices="cpu"):
    return Mesh(("data", "model"), MESHES[name], (devices,) * 4)


def _cfg(arch):
    return dataclasses.replace(get_reduced_config(arch), dtype="float32")


def _model(cfg, seed=0):
    return ttf.init_params(cfg, torch.Generator().manual_seed(seed))


def _batch(cfg, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (batch, L)).astype(
        np.int32)}
    out["labels"][0, :3] = -1
    if cfg.external_embeddings:
        out["embeds"] = rng.standard_normal(
            (batch, L, cfg.d_model)).astype(np.float32)
        if cfg.rope_type == "mrope":
            out["positions_3d"] = rng.integers(0, 30, (3, batch, L)).astype(
                np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, L)).astype(
            np.int32)
    return out


def _moe_params(cfg):
    return tmoe.MoE(torch.Generator().manual_seed(5), cfg)


def _moe_x(cfg):
    rng = np.random.default_rng(9)
    return rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as tmp:
        init = {}
        for arch in TRAIN_ARCHS:
            cfg = _cfg(arch)
            leaves = convert.reference_leaves(
                {k: v.detach().numpy() for k, v in
                 _model(cfg).state_dict().items()}, cfg)
            init.update({f"{arch}.p.{k}": v for k, v in leaves.items()})
            init.update({f"{arch}.{k}": v for k, v in _batch(cfg).items()})
        mcfg = _cfg("phi3_5_moe_42b_a6_6b")
        init.update({f"moe.{k}": v.detach().numpy() for k, v in
                     _moe_params(mcfg).state_dict().items()})
        init["moe_x"] = _moe_x(mcfg)
        np.savez(os.path.join(tmp, "in.npz"),
                 train_archs=",".join(TRAIN_ARCHS), **init)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        env["PYTHONPATH"] = os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "src"))
        proc = subprocess.run(
            [sys.executable, "-c", _REFERENCE, os.path.join(tmp, "in.npz"),
             os.path.join(tmp, "out.npz"), os.path.join(tmp, "shapes.json")],
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "REFERENCE_OK" in proc.stdout
        with np.load(os.path.join(tmp, "out.npz")) as z:
            out = {k: z[k] for k in z.files}
        with open(os.path.join(tmp, "shapes.json")) as f:
            out["shapes"] = json.load(f)
    return out


# --------------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------------- #


def _reference_names(cfg, names):
    """Port name → (the reference's dotted leaf, its stack axes)."""
    return {m: (path, axes) for path, axes, members in convert._plan(
        list(names), cfg) for m in members}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_shapes_match_reference(reference, mesh_name):
    mesh = _mesh(mesh_name, "meta")
    shapes = reference["shapes"]
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = ttf.init_params(cfg, None)
        placed = placement.place(model, cfg, mesh)
        opt = placement.place_opt(adamw_init(model), placed)
        ref = _reference_names(cfg, placed.shapes)
        for name, shape in placed.shapes.items():
            path, axes = ref[name]
            want = shapes[f"{mesh_name}|{arch}|p|{path}"]
            assert want[:len(axes)] == list(axes), (arch, name)
            for r in range(mesh.size):
                for got in (placed.shards[r][name], opt[r]["m"][name],
                            opt[r]["v"][name]):
                    assert list(got.shape) == want[len(axes):], (arch, name)
        caches = ttf.init_caches(cfg, 4, 64, "meta")
        pc = placement.place_caches(caches, cfg, mesh, 4, 64)
        stacked = [convert.reference_caches(s, cfg) for s in pc.shards]
        for key, want in shapes.items():
            m, a, kind, path = key.split("|")
            if (m, a, kind) != (mesh_name, arch, "c"):
                continue
            for tree in stacked:
                leaf = tree
                for part in path.split("."):
                    leaf = leaf[part]
                lead = len(leaf.shape) - len(want)
                assert lead == 0, (arch, path)
                assert list(leaf.shape) == want, (arch, path)


def test_collectives_fixed_order_and_groups():
    """psum sums in float32 in rank order and casts back; all_gather and
    reshard move the right slices; the groups follow the mesh's axes."""
    mesh = _mesh("2x2")
    assert collectives.groups(mesh, ("model",)) == [[0, 1], [2, 3]]
    assert collectives.groups(mesh, ("data",)) == [[0, 2], [1, 3]]
    xs = [torch.full((3,), float(r + 1), dtype=torch.bfloat16)
          for r in range(4)]

    def body(r):
        s = collectives.psum(xs[r], "model")
        g = collectives.all_gather(xs[r][:1], "data", 0)
        full = torch.arange(8.0).reshape(4, 2)
        mine = collectives.shard(full, ("data", None), mesh, r, "cpu")
        back = collectives.reshard(mine, (4, 2), ("data", None),
                                   (None, "model"))
        return s, g, back, collectives.axis_index("model")

    out = collectives.spmd(mesh, body, [(r,) for r in range(4)])
    assert [float(o[0][0]) for o in out] == [3.0, 3.0, 7.0, 7.0]
    assert out[0][0].dtype == torch.bfloat16
    assert out[1][1].tolist() == [2.0, 4.0]
    full = torch.arange(8.0).reshape(4, 2)
    for r, o in enumerate(out):
        assert torch.equal(o[2], full[:, o[3]:o[3] + 1])

    def bad(r):
        if r == 3:
            raise ZeroDivisionError("rank 3")
        return collectives.psum(torch.ones(1), "model")

    # the other ranks wait at the collective; the run ends with rank 3's
    with pytest.raises(ZeroDivisionError):
        collectives.spmd(mesh, bad, [(r,) for r in range(4)])


def test_collectives_under_thread_switching_and_divergence():
    """Eight ranks, 200 sums each, the interpreter switching threads every
    microsecond: every sum is the group's, in every rank. A rank that
    returns while the others wait at a collective ends the run with an
    error instead of a hang."""
    mesh = Mesh(("data", "model"), (2, 4), ("cpu",) * 8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(r):
            return [float(collectives.psum(torch.tensor([float(r + i)]),
                                           "model")) for i in range(200)]

        out = collectives.spmd(mesh, body, [(r,) for r in range(8)])
    finally:
        sys.setswitchinterval(old)
    for r, sums in enumerate(out):
        base = sum(range(4)) if r < 4 else sum(range(4, 8))
        assert sums == [base + 4.0 * i for i in range(200)]

    def diverge(r):
        if r == 0:
            return None
        return collectives.psum(torch.ones(1), "model")

    with pytest.raises(RuntimeError, match="diverged"):
        collectives.spmd(_mesh("2x2"), diverge, [(r,) for r in range(4)])


# --------------------------------------------------------------------------- #
# placed training against the unplaced port and the reference
# --------------------------------------------------------------------------- #


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_placed_train_step_matches_unplaced(arch, mesh_name):
    cfg, mesh = _cfg(arch), _mesh(mesh_name)
    model = _model(cfg)
    batch = _batch(cfg)
    placed = placement.place(model, cfg, mesh)
    before = dict(tmoe.PATHS)
    metrics, grads = placement.loss_and_grads(placed, batch, cfg)
    ep = tmoe.PATHS["expert_parallel"] > before["expert_parallel"]
    assert ep == (cfg.family == "moe")
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
    # the forward
    shards, sharded = placement.place_batch(batch, mesh)
    with torch.no_grad():
        outs = collectives.spmd(mesh, lambda r: ttf.apply(
            placed.view(r), shards[r], cfg)[0], [(r,) for r in range(4)],
            batch_sharded=sharded)
        got = torch.cat([outs[r] for r in placement._canonical(mesh,
                                                               sharded)])
        if not ep or mesh.shape["data"] == 1:
            ref = ttf.apply(model, {k: torch.as_tensor(v)
                                    for k, v in batch.items()}, cfg)[0]
            top = float(ref[..., :cfg.vocab_size].abs().max())
            assert float((got - ref)[..., :cfg.vocab_size].abs().max()) \
                <= LOGITS_REL * max(1.0, top)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_placed_loss_matches_reference_jitted_step(reference, arch):
    cfg, mesh = _cfg(arch), _mesh("2x2")
    placed = placement.place(_model(cfg), cfg, mesh)
    opt = placement.place_opt(adamw_init(_model(cfg)), placed)
    step = tstep.make_train_step(cfg, AdamWConfig(lr=1e-5))
    _, _, m = step(placed, opt, _batch(cfg))
    want = float(reference[f"{arch}.loss"])
    assert abs(float(m["loss"]) - want) <= LOSS_REL * abs(want)


def test_two_placed_runs_are_bit_identical():
    cfg, mesh = _cfg("granite_moe_3b_a800m"), _mesh("2x2")
    runs = []
    for _ in range(2):
        model = _model(cfg)
        placed = placement.place(model, cfg, mesh)
        opt = placement.place_opt(adamw_init(model), placed)
        step = tstep.make_train_step(cfg, AdamWConfig(lr=1e-3))
        losses = [float(step(placed, opt, _batch(cfg, seed=s))[2]["loss"])
                  for s in range(2)]
        prefill = tstep.make_prefill_step(cfg, 24)
        tokens = torch.as_tensor(_batch(cfg)["tokens"])
        logits, caches = prefill(placed, {"tokens": tokens})
        decode = tstep.make_decode_step(cfg)
        pos = torch.full((B, 1), L, dtype=torch.int32)
        logits2, _ = decode(placed, caches, torch.argmax(
            logits, -1)[:, None].to(torch.int32), pos)
        runs.append((losses, [placed.gather(k) for k in placed.shapes],
                     logits, logits2))
    a, b = runs
    assert a[0] == b[0]
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


@pytest.mark.parametrize("arch,mesh_name", [("gemma2_2b", "2x2"),
                                            ("qwen2_vl_7b", "1x4"),
                                            ("zamba2_2_7b", "2x2")])
def test_placed_prefill_decode_match_unplaced(arch, mesh_name):
    """Prefill, then three decode steps; the caches come back placed by
    ``cache_specs`` and gather to the unplaced caches."""
    cfg, mesh = _cfg(arch), _mesh(mesh_name)
    model = _model(cfg)
    placed = placement.place(model, cfg, mesh)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()
             if k != "labels"}
    rng = np.random.default_rng(4)
    with torch.no_grad():
        got, pc = placement.prefill(placed, batch, 24)
        want, caches = ttf.prefill(model, batch, cfg, 24)
        for t in range(4):
            top = float(want[:, :cfg.vocab_size].abs().max())
            assert float((got - want)[:, :cfg.vocab_size].abs().max()) <= \
                LOGITS_REL * max(1.0, top), t
            if t == 3:
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
    back = placement.gather_caches(pc)
    flat_got = convert.reference_caches(back, cfg)
    flat_want = convert.reference_caches(caches, cfg)

    def check(a, b):
        if isinstance(a, dict):
            for k in a:
                check(a[k], b[k])
        else:
            assert a.shape == b.shape
            assert torch.allclose(a.float(), b.float(), rtol=1e-5,
                                  atol=1e-5)

    check(flat_got, flat_want)


# --------------------------------------------------------------------------- #
# the MoE's expert-parallel path
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_expert_parallel_moe_matches_dense_and_reference(reference,
                                                         mesh_name):
    cfg, mesh = _cfg("phi3_5_moe_42b_a6_6b"), _mesh(mesh_name)
    assert cfg.num_experts_per_tok == 2
    params = _moe_params(cfg)
    x = torch.from_numpy(_moe_x(cfg))
    placed = placement.place(params, cfg, mesh)
    shards, sharded = placement.place_batch({"embeds": x}, mesh)
    before = tmoe.PATHS["expert_parallel"]
    with torch.no_grad():
        outs = collectives.spmd(mesh, lambda r: tmoe.moe_ffn(
            placed.view(r), shards[r]["embeds"], cfg), [(r,) for r in
                                                        range(4)],
            batch_sharded=sharded)
        assert tmoe.PATHS["expert_parallel"] == before + 4
        canon = placement._canonical(mesh, sharded)
        got = torch.cat([outs[r][0] for r in canon])
        dp = mesh.shape["data"]
        per = x.shape[0] // dp
        dense = [tmoe.moe_ffn(params, x[i * per:(i + 1) * per], cfg)
                 for i in range(dp)]
    assert torch.equal(got, torch.cat([d[0] for d in dense]))
    aux = sum(float(d[1]) for d in dense) / dp
    assert all(abs(float(o[1]) - aux) <= 1e-6 * aux for o in outs)
    want = reference[f"moe_ep_{mesh_name}"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    assert bool(reference["moe_ep_equals_dense_1x4"])
    if dp == 1:
        np.testing.assert_allclose(got.numpy(), reference["moe_dense"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,batch,ep", [
    ((2, 2), 4, True), ((1, 4), 3, True), ((2, 2), 3, False),
    ((4, 1), 4, True), ((1, 1), 2, True), ((2, 3), 4, False)])
def test_expert_parallel_exactly_where_the_reference_takes_it(shape, batch,
                                                              ep):
    """The reference's condition: a ``model`` axis dividing the padded
    experts and a batch the data-parallel axes divide. granite-moe pads 40
    experts to 48 (3 does not divide it). A batch the data axis does not
    divide stays whole on every rank and takes the dense path, equal to
    the unplaced layer bit for bit."""
    cfg = _cfg("granite_moe_3b_a800m")
    mesh = Mesh(("data", "model"), shape, ("cpu",) * (shape[0] * shape[1]))
    sharded = batch % shape[0] == 0
    assert pspec.moe_ep(cfg, mesh, sharded) == ep
    want_ep = (cfg.padded_experts % shape[1] == 0 and batch % shape[0] == 0)
    assert ep == want_ep
    if shape == (2, 2) and not ep:
        params = _moe_params(cfg)
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (batch, 8, cfg.d_model)).astype(np.float32))
        placed = placement.place(params, cfg, mesh)
        shards, sh = placement.place_batch({"embeds": x}, mesh)
        assert not sh
        with torch.no_grad():
            want = tmoe.moe_ffn(params, x, cfg)[0]
            before = tmoe.PATHS["dense"]
            outs = collectives.spmd(mesh, lambda r: tmoe.moe_ffn(
                placed.view(r), shards[r]["embeds"], cfg)[0],
                [(r,) for r in range(4)], batch_sharded=sh)
        assert tmoe.PATHS["dense"] == before + 4
        assert all(torch.equal(o, want) for o in outs)


def test_coordinator_over_a_mesh_matches_one_device():
    """``make_coordinator(mesh=...)``: the placed steps write the train
    state back; after two steps it equals the one-device run's."""
    cfg = _cfg("gemma2_2b")
    states = []
    for mesh in (None, _mesh("2x2")):
        with tempfile.TemporaryDirectory() as d:
            coord = make_coordinator(cfg, torch.device("cpu"), steps=2,
                                     batch=4, seq=16, lr=1e-5, seed=0,
                                     checkpoint_dir=d, checkpoint_every=2,
                                     mesh=mesh)
            states.append(coord.train())
    a, b = (convert._flatten(s["params"]) for s in states)
    for k in a:
        assert _rel(b[k], a[k]) <= 1e-5, k
    assert int(states[1]["opt"]["step"]) == 2
