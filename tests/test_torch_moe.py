"""The port's MoE layer (``repro_torch.models.layers.moe``) against the
reference's one-device dispatch (``repro.models.layers.moe._moe_dense``).

Both get the same weights (the reference's ``init_moe``) and the same
seeded numpy inputs, in float32. Routing, the renormalized weights and the
output agree to 1e-5 relative (``F32_REL``); the expert choices and the
dropped (token, rank) pairs are equal, with padded experts (40 → 48) and
with a capacity factor of 0.25 that drops tokens. The port's dispatch
writes each kept pair to its own slot and combines by a gather, so two
runs give the same bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config as jax_reduced
from repro.models import blocks as jblk
from repro.models.layers import moe as jmoe
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.models import blocks as tblk
from repro_torch.models import convert
from repro_torch.models.layers import moe as tmoe

F32_REL = 1e-5
ARCH = "phi3_5_moe_42b_a6_6b"
CASES = {
    "phi3.5": {},
    "padded": dict(num_experts=40, expert_d_ff=16, num_experts_per_tok=4),
    "overflow": dict(moe_capacity_factor=0.25),
}


def cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jax_reduced(ARCH), **kw),
            dataclasses.replace(torch_reduced(ARCH), **kw))


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    top = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=F32_REL, atol=F32_REL * top)


def load(module, tree):
    flat = convert._flatten(tree)
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in flat.items()}, strict=True)
    return module


def moe_pair(case):
    jcfg, tcfg = cfgs(**CASES[case])
    tree = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0),
                                                  jcfg))
    mod = load(tmoe.MoE(torch.Generator().manual_seed(0), tcfg), tree)
    x = np.random.default_rng(1).normal(
        size=(2, 32, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), mod, x


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_matches_reference(case):
    jcfg, tcfg, jp, mod, x = moe_pair(case)
    xt = x.reshape(-1, jcfg.d_model)
    jprobs, jtop_p, jtop_e = jmoe._route(jp, jnp.asarray(xt), jcfg)
    with torch.no_grad():
        probs, top_p, top_e = tmoe._route(mod, torch.from_numpy(xt), tcfg)
    close(probs, jprobs)
    close(top_p, jtop_p)
    assert np.array_equal(top_e.numpy(), np.asarray(jtop_e))
    if jcfg.padded_experts != jcfg.num_experts:
        assert jcfg.padded_experts == 48 and mod.w_gate.shape[0] == 48
        assert int(top_e.max()) < jcfg.num_experts
        assert float(probs[:, jcfg.num_experts:].abs().max()) == 0.0


def test_route_ties_go_to_the_lower_expert():
    """Equal probabilities: ``jax.lax.top_k`` takes the lower index first;
    the port's stable descending sort does the same."""
    jcfg, tcfg, jp, mod, _ = moe_pair("phi3.5")
    with torch.no_grad():
        mod.router.zero_()
    xt = np.ones((3, jcfg.d_model), np.float32)
    _, _, jtop_e = jmoe._route(jax.tree.map(jnp.zeros_like, jp),
                               jnp.asarray(xt), jcfg)
    with torch.no_grad():
        _, top_p, top_e = tmoe._route(mod, torch.from_numpy(xt), tcfg)
    assert np.array_equal(top_e.numpy(), np.asarray(jtop_e))
    assert top_e.tolist() == [list(range(jcfg.num_experts_per_tok))] * 3
    assert torch.all(top_p == 1.0 / jcfg.num_experts_per_tok)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_reference(case):
    """Output and balance loss; the dropped tokens (all-zero output rows)
    are the same rows in both packages."""
    jcfg, tcfg, jp, mod, x = moe_pair(case)
    want, jaux = jmoe._moe_dense(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = tmoe.moe_ffn(mod, torch.from_numpy(x), tcfg)
    close(got, want)
    close(aux, jaux)
    zero = ~np.asarray(want).reshape(-1, jcfg.d_model).any(axis=1)
    assert np.array_equal(~got.reshape(-1, tcfg.d_model).numpy().any(axis=1),
                          zero)
    assert zero.any() == (case == "overflow")
    capacity = tmoe.capacity_of(x.shape[0] * x.shape[1], tcfg)
    print(f"\n{case}: capacity {capacity}, {int(zero.sum())} of {zero.size} "
          f"tokens dropped in both")


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_repeats_bit_for_bit(case):
    _, tcfg, _, mod, x = moe_pair(case)
    with torch.no_grad():
        a = tmoe.moe_ffn(mod, torch.from_numpy(x), tcfg)
        b = tmoe.moe_ffn(mod, torch.from_numpy(x), tcfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_capacity_counts_real_experts():
    _, tcfg = cfgs(**CASES["padded"])
    for tokens in (1, 64, 1000, 32768):
        c = int(tokens * 4 * tcfg.moe_capacity_factor / 40)
        assert tmoe.capacity_of(tokens, tcfg) == max(8, -(-c // 8) * 8) == \
            jmoe.capacity_of(tokens, tcfg)


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b_a6_6b",
                                  "granite_moe_3b_a800m"])
def test_moe_decoder_block_matches_reference(arch):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(torch_reduced(arch), dtype="float32")
    tree = jax.tree.map(np.asarray, jblk.init_decoder_block(
        jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(5)
    for name in ("ln_attn", "ln_ffn"):
        tree[name]["scale"] = rng.normal(size=(jcfg.d_model,)).astype(
            np.float32) * 0.1
    mod = load(tblk.DecoderBlock(torch.Generator().manual_seed(0), tcfg),
               tree)
    x = rng.normal(size=(2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32)[None], (2, 20)).copy()
    want, _, jaux = jblk.decoder_block(jax.tree.map(jnp.asarray, tree),
                                       jnp.asarray(x), jnp.asarray(pos), jcfg,
                                       local=False, mode="train")
    with torch.no_grad():
        got, cache, aux = tblk.decoder_block(
            mod, torch.from_numpy(x), torch.from_numpy(pos), tcfg,
            local=False, mode="train")
    assert cache is None
    close(got, want)
    close(aux, jaux)
