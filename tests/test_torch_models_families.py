"""The port's moe, ssm and hybrid LMs against the reference's, on the
REDUCED configs of granite-moe-3b-a800m, phi3.5-moe-42b-a6.6b, mamba2-130m
and zamba2-2.7b.

Both packages get the reference's weights (through ``models.convert``) and
the same seeded tokens. ``apply`` (logits and the MoE balance loss),
``prefill`` and four teacher-forced ``decode_step``s agree in float32 to
1e-5 relative (``F32_REL``) and in bfloat16 to 5 % of the largest logit
(``BF16_REL``), as the dense configs' do in ``test_torch_models.py``.

In bfloat16 the reference runs op by op (``jax.disable_jit()``), so each
op's result is rounded to bf16 as the port's is; under jit XLA keeps some
fused chains in f32, which moves zamba2's logits up to 7.8 % from the
port's on some inputs while both stay 2-5 % from the f32 logits (measured).
An MoE router in bf16 picks a different expert for some tokens in one
package than in the other, as the reference's own bf16 routing differs
from its f32 routing (measured: 11-17 % of the largest logit on granite
REDUCED); a token so routed differs by far more than the tolerance, and so
do the tokens after it (attention, capacity ranks). So in bf16 the port
takes the reference's expert choices, call by call (``ForcedRoutes``),
with its own probabilities for their weights, and the test asserts that
wherever the port's own choice differs, it is a near tie: the reference
gives the port's experts at least 1 - BF16_REL of the probability it gives
its own. The test prints how many tokens' choices differ. In float32 the
port routes on its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config as jax_reduced
from repro.models import transformer as jtf
from repro.models.layers import moe as jmoe
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import moe as tmoe

F32_REL = 1e-5
BF16_REL = 0.05
ARCHS = ["granite_moe_3b_a800m", "phi3_5_moe_42b_a6_6b", "mamba2_130m",
         "zamba2_2_7b"]
B, L, PRE, STEPS = 2, 64, 32, 4


def model_pair(arch, dtype):
    """The arch's REDUCED config in both packages at ``dtype``; without
    rematerialization, which changes only a backward pass and would trace
    the reference's train-mode blocks under ``jax.disable_jit()``."""
    jcfg = dataclasses.replace(jax_reduced(arch), dtype=dtype, remat="none")
    tcfg = dataclasses.replace(torch_reduced(arch), dtype=dtype,
                               remat="none")
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    return jcfg, tcfg, tree, convert.from_reference(tree, tcfg)


class ForcedRoutes:
    """The reference's routing, recorded call by call (its probabilities
    and expert choices), imposed on the port's next MoE call; each of the
    port's own choices is checked to be a near tie."""

    def __init__(self, monkeypatch):
        self.queue, self.tokens, self.differ = [], 0, 0
        j_dense, t_route = jmoe._moe_dense, tmoe._route

        def j_record(params, x, cfg):
            probs, _, top_e = jmoe._route(params, x.reshape(-1, x.shape[-1]),
                                          cfg)
            self.queue.append((np.asarray(probs), np.asarray(top_e)))
            return j_dense(params, x, cfg)

        def t_forced(params, xt, cfg):
            probs, _, own = t_route(params, xt, cfg)
            j_probs, j_e = self.queue.pop(0)
            own = own.numpy()
            p_own = np.take_along_axis(j_probs, own, 1).sum(1)
            p_ref = np.take_along_axis(j_probs, j_e, 1).sum(1)
            assert (p_own >= (1 - BF16_REL) * p_ref).all()
            self.tokens += len(own)
            self.differ += int((np.sort(own, 1) != np.sort(j_e, 1)).any(1)
                               .sum())
            top_e = torch.from_numpy(np.array(j_e)).long()
            top_p = probs.gather(1, top_e)
            return probs, top_p / torch.clamp(
                top_p.sum(dim=-1, keepdim=True), min=1e-9), top_e

        monkeypatch.setattr(jmoe, "_moe_dense", j_record)
        monkeypatch.setattr(tmoe, "_route", t_forced)


def close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    if tol == "bf16":
        np.testing.assert_allclose(got, want, rtol=0.0, atol=BF16_REL * top)
    else:
        np.testing.assert_allclose(got, want, rtol=F32_REL,
                                   atol=F32_REL * max(1.0, top))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_prefill_decode_match_reference(arch, dtype, monkeypatch):
    """apply over 64 tokens (the flash threshold of the attention configs),
    prefill of 32 (more than one SSD chunk of 16, so the tail chunk is
    padded), then teacher-forced decode steps."""
    jcfg, tcfg, tree, model = model_pair(arch, dtype)
    tol = "f32" if dtype == "float32" else "bf16"
    routes = ForcedRoutes(monkeypatch) \
        if tcfg.family == "moe" and tol == "bf16" else None
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, L),
                                               dtype=np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    with jax.disable_jit(tol == "bf16"), torch.no_grad():
        want, jaux = jtf.apply(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
        got, aux = ttf.apply(model, {"tokens": torch.from_numpy(tokens)},
                             tcfg)
        close(got, want, tol)
        close(aux, jaux, tol)
        if tcfg.family != "moe":
            assert float(aux) == 0.0

        want, jc = jtf.prefill(jp, {"tokens": jnp.asarray(tokens[:, :PRE])},
                               jcfg, L)
        got, tc = ttf.prefill(model, {"tokens": torch.from_numpy(
            tokens[:, :PRE])}, tcfg, L)
        close(got, want, tol)
        for t in range(PRE, PRE + STEPS):
            p = np.full((B, 1), t, np.int32)
            want, jc = jtf.decode_step(jp, jc, jnp.asarray(tokens[:, t:t + 1]),
                                       jnp.asarray(p), jcfg)
            got, tc = ttf.decode_step(model, tc, torch.from_numpy(
                tokens[:, t:t + 1]), torch.from_numpy(p), tcfg)
            close(got, want, tol)
    if routes is not None:
        assert not routes.queue
        print(f"\n{tcfg.name} {dtype}: {routes.differ} of {routes.tokens} "
              f"routed tokens chose other experts in the port (near ties)")


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_keeps_bytes(arch):
    _, tcfg, tree, model = model_pair(arch, "bfloat16")
    back = convert.to_reference(model, tcfg)
    flat_a, flat_b = convert._flatten(tree), convert._flatten(back)
    assert sorted(flat_a) == sorted(flat_b)
    for key, val in flat_a.items():
        assert flat_b[key].dtype == val.dtype and \
            flat_b[key].shape == val.shape and \
            flat_b[key].tobytes() == val.tobytes(), key


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_seeded_and_counts_the_reference_params(arch):
    """The same seed gives the same weights, and the port holds as many
    parameters, leaf for leaf in shape, as the reference's init."""
    jcfg, tcfg = jax_reduced(arch), torch_reduced(arch)
    a = ttf.init_params(tcfg, torch.Generator().manual_seed(3))
    b = ttf.init_params(tcfg, torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    shapes = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    ref = convert._flatten(jax.tree.map(lambda s: np.empty(s.shape, s.dtype),
                                        shapes))
    back = convert.to_reference(a, tcfg)
    assert {k: v.shape for k, v in convert._flatten(back).items()} == \
        {k: v.shape for k, v in ref.items()}
    assert sum(p.numel() for p in a.parameters()) == \
        sum(v.size for v in ref.values())
