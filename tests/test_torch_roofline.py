"""The op walk, the roofline and the dry run (``roofline.op_walk``,
``roofline.analysis``, ``launch.specs``, ``launch.dryrun``) against the
reference's HLO walker.

- ``dot_flops`` equals the reference ``walk_hlo``'s on the reference
  test's single matmul (2·256·512·128), its 7-step scan and its nested
  scan (the port's loops are Python loops: every step runs).
- Elementwise FLOPs are counted; ``bytes_min`` <= ``bytes``.
- On gemma2-2b and phi3.5-moe REDUCED, ``apply``'s ``dot_flops`` is within
  2 % of the reference walk's and a train step's within 5 % (the gaps are
  printed).
- ``dominant`` picks the largest term; ``build_cell`` skips ``long_500k``
  exactly where the reference does; a solo rank's step reports its
  collectives with the ring factors; ``dryrun`` writes its record.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config as jax_reduced
from repro.configs import long_context_ok as jax_long_ok
from repro.models import transformer as jtf
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.roofline.hlo_walk import walk_hlo
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models import collectives
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ShapeConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.roofline import analysis
from repro_torch.roofline.analysis import Roofline
from repro_torch.roofline.op_walk import walk
from repro_torch.train.step import make_train_step

torch.set_num_threads(min(2, torch.get_num_threads()))


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _jax_walk(fn, *args):
    return walk_hlo(jax.jit(fn).lower(*args).compile().as_text())


def test_single_matmul_matches_reference():
    x, w = jnp.zeros((256, 512)), jnp.zeros((512, 128))
    want = _jax_walk(lambda a, b: a @ b, x, w).dot_flops
    got = walk(lambda: _meta(256, 512) @ _meta(512, 128))
    assert got.dot_flops == want == 2 * 256 * 512 * 128
    assert got.flops == got.dot_flops


def test_scan_and_nested_scan_match_reference():
    def scanned(x, ws):
        return jax.lax.scan(lambda h, w: (h @ w, None), x, ws)[0]

    want = _jax_walk(scanned, jnp.zeros((128, 128)), jnp.zeros((7, 128, 128)))

    def loop(x, ws):
        for i in range(ws.shape[0]):
            x = x @ ws[i]
        return x

    got = walk(loop, _meta(128, 128), _meta(7, 128, 128))
    assert got.dot_flops == want.dot_flops == 7 * 2 * 128 ** 3

    def nested(x, ws):
        def outer(h, wg):
            return jax.lax.scan(lambda h, w: (h @ w, None), h, wg)[0], None
        return jax.lax.scan(outer, x, ws)[0]

    want = _jax_walk(nested, jnp.zeros((64, 64)), jnp.zeros((3, 4, 64, 64)))

    def nested_loop(x, ws):
        for g in range(ws.shape[0]):
            x = loop(x, ws[g])
        return x

    got = walk(nested_loop, _meta(64, 64), _meta(3, 4, 64, 64))
    assert got.dot_flops == want.dot_flops == 12 * 2 * 64 ** 3


def test_elementwise_flops_and_byte_bounds():
    a = _meta(1024)
    t = walk(lambda: torch.tanh(a) + a * 2.0)
    assert 2 * 1024 <= t.flops <= 4 * 1024 and t.dot_flops == 0
    x = _meta(256, 256)
    t = walk(lambda: torch.sum(torch.tanh(x @ x) * 3.0))
    assert 0 < t.bytes_min <= t.bytes
    assert t.flops > t.dot_flops == 2 * 256 ** 3


def test_dominant_term_logic():
    r = Roofline(flops=1e15, hbm_bytes=1e9, wire_bytes=1e9, chips=256,
                 collectives={})
    assert r.dominant == "compute" and r.bound_s == r.compute_s
    r = Roofline(flops=1e12, hbm_bytes=1e14, wire_bytes=0, chips=256,
                 collectives={})
    assert r.dominant == "memory"
    r = Roofline(flops=1e12, hbm_bytes=1e9, wire_bytes=1e13, chips=256,
                 collectives={})
    assert r.dominant == "collective"
    assert analysis.PEAK_FLOPS == 989e12 and analysis.HBM_BW == 3.35e12
    assert analysis.wire_bytes("all-reduce", 100, 4) == 150.0
    assert analysis.wire_bytes("all-gather", 100, 4) == 75.0
    assert analysis.wire_bytes("reduce-scatter", 100, 4) == 300.0
    assert analysis.wire_bytes("all-reduce", 100, 1) == 0.0


def _batch_pair(cfg, B=2, L=64):
    tokens = jnp.zeros((B, L), jnp.int32)
    return ({"tokens": tokens, "labels": tokens},
            {"tokens": _meta(B, L, dtype=torch.int32),
             "labels": _meta(B, L, dtype=torch.int32)})


@pytest.mark.parametrize("arch", ["gemma2_2b", "phi3_5_moe_42b_a6_6b"])
def test_model_dot_flops_match_reference(arch):
    jcfg, tcfg = jax_reduced(arch), get_reduced_config(arch)
    params = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), params)
    jb, tb = _batch_pair(jcfg)
    want = _jax_walk(lambda p, b: jtf.apply(p, b, jcfg), params, jb)
    model = ttf.init_params(tcfg, None)
    got = walk(lambda: ttf.apply(model, tb, tcfg))
    gap = got.dot_flops / want.dot_flops - 1
    print(f"{arch} apply dot_flops: port {got.dot_flops:.4e}, reference "
          f"{want.dot_flops:.4e}, gap {gap:+.4%}")
    assert abs(gap) <= 0.02

    step = jmake_train_step(jcfg, JAdamWConfig())
    want = _jax_walk(step, params, jadamw_init(params), jb)
    got = walk(make_train_step(tcfg, AdamWConfig()), model,
               adamw_init(model), tb)
    gap = got.dot_flops / want.dot_flops - 1
    print(f"{arch} train step dot_flops: port {got.dot_flops:.4e}, "
          f"reference {want.dot_flops:.4e}, gap {gap:+.4%}")
    assert abs(gap) <= 0.05


def test_long_500k_skipped_where_the_reference_skips():
    mesh = make_production_mesh()
    for arch in ARCH_IDS:
        cell = build_cell(arch, "long_500k", mesh)
        assert bool(cell.skip_reason) == (not jax_long_ok(arch)), arch
        assert (cell.step is None) == bool(cell.skip_reason)


def test_solo_rank_reports_its_collectives():
    """One rank of a (2, 2) mesh alone: granite-moe REDUCED's placed
    prefill gathers its FSDP shards, sums over ``model`` and gathers the
    logits; each is tallied with its ring factor."""
    mesh = Mesh(("data", "model"), (2, 2))
    cell = build_cell("granite-moe-3b-a800m", "prefill_32k", mesh)
    assert cell.memory["params"] > 0 and cell.memory["caches"] > 0
    seen = []
    with collectives.recording(lambda op, b, n: seen.append((op, b, n))):
        t = walk(_tiny_prefill(mesh))
    assert {op for op, _, _ in seen} >= {"all-gather", "all-reduce"}
    assert t.wire_bytes == pytest.approx(sum(
        analysis.wire_bytes(op, b, n) for op, b, n in seen))
    assert t.collective_counts["all-reduce"] == sum(
        op == "all-reduce" for op, _, _ in seen)


def _tiny_prefill(mesh):
    cfg = get_reduced_config("granite_moe_3b_a800m")
    placed = specs.params_struct(cfg, mesh)
    batch = specs.batch_struct(cfg, mesh, ShapeConfig("t", 16, 4, "prefill"),
                               labels=False)
    return lambda: collectives.solo(
        mesh, lambda: ttf.prefill(placed.view(0), batch, cfg, 16))


def test_dryrun_writes_its_record(tmp_path):
    rec = dryrun.run_cell("gemma2_2b", "decode_32k", False, tmp_path,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    on_disk = json.loads((tmp_path / "gemma2_2b__decode_32k__single.json")
                         .read_text())
    assert on_disk["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
    assert on_disk["chips"] == 256
    assert on_disk["memory_per_device"]["caches"] > 0
    rec = dryrun.run_cell("granite_34b", "long_500k", False, tmp_path,
                          verbose=False)
    assert rec["status"] == "skip"
