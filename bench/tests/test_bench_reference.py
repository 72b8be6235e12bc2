"""The plain reference against the port's CPU path at tiny sizes."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from bench.reference import boundary, check, hnsw

REF_DIR = pathlib.Path(check.__file__).resolve().parent


def _floats(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g) * 3.0
    x[0] = 0.0                       # a zero row passes through
    x[1, :3] = torch.tensor([1e30, -1e30, 1e-30])
    return x


@pytest.mark.parametrize("contract", ["Q16.16", "Q8.8", "Q2.13"])
def test_boundary_equals_the_ports(contract):
    from repro_torch.core import boundary as port
    from repro_torch.core.contracts import get_contract
    x = _floats(64, 37, 3)
    want = port.normalize_embedding(x, get_contract(contract)).numpy()
    got = boundary.normalize(x.numpy(), contract)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_the_float32_control_breaks_the_boundary():
    x = _floats(256, 1536, 4)[2:].numpy()
    exact = boundary.normalize(x)
    control = boundary.normalize_float32(x)
    assert np.count_nonzero(exact != control) > 0
    assert np.abs(exact.astype(np.int64) - control).max() <= 4


def test_hnsw_replay_and_search_equal_the_ports():
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig
    d, n, b = 37, 300, 100
    eng = MemoryAugmentedEngine(d, ServeConfig(
        capacity=512, retrieve_k=5, ef=16, exact_threshold=32), device="cpu")
    x = _floats(n, d, 5)[2:]
    for i in range(0, len(x), b):
        eng.insert_documents(x[i:i + b])
    mem = eng.memory
    n = len(x)
    rows = boundary.normalize(x.numpy())
    np.testing.assert_array_equal(mem.vectors[:n].numpy(), rows)
    valid = np.zeros(n, bool)
    g = hnsw.Graph(rows, np.arange(n, dtype=np.int64), valid,
                   np.full((4, n, 16), -1, np.int32),
                   np.full(n, -1, np.int32), -1)
    for i in range(0, n, b):
        g.valid[:i + b] = True       # F stores a batch before it links it
        for s in range(i, min(i + b, n)):
            hnsw.insert(g, s, 32)
    np.testing.assert_array_equal(g.neighbors,
                                  mem.hnsw_neighbors[:, :n].numpy())
    np.testing.assert_array_equal(g.levels, mem.hnsw_levels[:n].numpy())
    assert g.entry == int(mem.hnsw_entry)
    q = _floats(12, d, 6)
    ids, scores = eng.retrieve(q, k=5)
    assert eng.last_plan.route == "hnsw"
    qr = boundary.normalize(q.numpy())
    for i in range(len(q)):
        want_ids, want_scores = hnsw.search(g, qr[i], 5, 16)
        np.testing.assert_array_equal(want_ids, ids[i])
        np.testing.assert_array_equal(want_scores, scores[i])
    r64 = rows.astype(np.float64)
    top, lid, contrast = check.data_stats(r64, (r64 ** 2).sum(1), qr, 5)
    assert (top == ids).mean() > 0.5
    assert lid > 1.0 and contrast > 1.0


def test_reference_imports_nothing_of_the_port():
    for path in REF_DIR.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in (
                    "repro_torch", "repro", "jax", "jaxlib", "flax"), \
                    f"{path.name} imports {name}"


@pytest.mark.parametrize("batch", [1, 6])
def test_lm_forward_equals_the_ports_in_float32(batch):
    """The plain forward against the port's pooled embedding at the
    granite REDUCED config in float32, on the same drawn weights (the
    MoE's capacity couples a batch's documents; at 6 x 16 tokens it drops
    pairs)."""
    import dataclasses
    from bench.engines import lm_moe
    from bench.reference import lm
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_reduced_config("granite_moe_3b_a800m"),
                              dtype="float32")
    dims = lm_moe.lm_dims({
        "num_hidden_layers": cfg.num_layers, "hidden_size": cfg.d_model,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "intermediate_size": cfg.expert_d_ff,
        "num_local_experts": cfg.num_experts,
        "num_experts_per_tok": cfg.num_experts_per_tok,
        "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps})
    weights = lm.draw(dims, 11, "cpu")
    params = transformer.init_params(cfg, None)
    lm_moe._bind(params, weights)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 16), generator=g)
    with torch.no_grad():
        want = transformer.pooled_embedding(params, tokens, cfg)
    got = lm.pooled(weights, tokens, dims)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * scale
    control = lm.pooled(weights, tokens, dims, quantize=True)
    assert (control - want).abs().max() > 1e-3 * scale
