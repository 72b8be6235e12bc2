"""The vlm and audio backbones on external embeddings (qwen2-vl-7b with
M-RoPE, musicgen-large) against the reference.

- ``mrope_angles`` equals the reference's on non-text ``positions_3d``
  (text positions would reduce M-RoPE to RoPE and hide a wrong section
  split) within 1e-5, as ``rope_angles`` does (XLA's and torch's float32
  powers differ in the last bit), and reduces to ``rope_angles`` on text
  positions bit for bit.
- Both REDUCED configs on the reference's weights (``models.convert``):
  ``apply``, ``loss_fn``, ``prefill`` and ``decode_step(embeds=)`` within
  1e-5 in f32 and 5 % of the largest logit in bf16; qwen2-vl's prefill
  takes M-RoPE angles and its decode text RoPE, as the reference's.
- The configs equal the reference's field by field, as do
  ``long_context_ok`` and ``all_configs``; the weights round-trip byte
  for byte.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.models.layers import rope as jrope
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import rope as trope

torch.set_num_threads(min(2, torch.get_num_threads()))

F32_REL = 1e-5
BF16_REL = 0.05
ARCHS = ["qwen2_vl_7b", "musicgen_large"]


def close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    if tol == "bf16":
        np.testing.assert_allclose(got, want, rtol=0.0, atol=BF16_REL * top)
    else:
        np.testing.assert_allclose(got, want, rtol=F32_REL,
                                   atol=F32_REL * max(1.0, top))


def _pos3(rng, B, L):
    """Non-text positions: three different streams (a t / h / w grid)."""
    return rng.integers(0, 40, (3, B, L)).astype(np.int32)


def test_mrope_angles_match_reference():
    rng = np.random.default_rng(0)
    for sections, head_dim, theta in [((16, 24, 24), 128, 1e6),
                                      ((4, 2, 2), 16, 1e4)]:
        pos3 = _pos3(rng, 2, 12)
        assert not (pos3[0] == pos3[1]).all()
        want = jrope.mrope_angles(jnp.asarray(pos3), head_dim, theta,
                                  sections)
        got = trope.mrope_angles(torch.from_numpy(pos3), head_dim, theta,
                                 sections)
        close(got, want, "f32")
        # each slot's angle is its own section's stream: exact per slot
        d2, start = head_dim // 2, 0
        freqs = trope._freqs(head_dim, theta, "cpu")
        for i, sec in enumerate(sections):
            sl = slice(start, start + sec)
            assert torch.equal(got[..., sl], torch.from_numpy(pos3[i]).float()
                               [..., None] * freqs[sl])
            start += sec
        assert start == d2
        text = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
        lifted = trope.text_positions_3d(torch.from_numpy(text))
        assert np.array_equal(lifted.numpy(), np.asarray(
            jrope.text_positions_3d(jnp.asarray(text))))
        assert torch.equal(
            trope.mrope_angles(lifted, head_dim, theta, sections),
            trope.rope_angles(torch.from_numpy(text), head_dim, theta))
    with pytest.raises(ValueError):
        trope.mrope_angles(torch.zeros(3, 1, 1, dtype=torch.int32), 16, 1e4,
                           (4, 4, 4))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for getter in ("get_config", "get_reduced_config"):
        want = getattr(jconfigs, getter)(arch)
        got = getattr(tconfigs, getter)(arch)
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    canonical = {v: k for k, v in tconfigs.CANONICAL.items()}[arch]
    assert tconfigs.get_config(canonical).name == jconfigs.get_config(
        canonical).name
    for a in tconfigs.ARCH_IDS:
        assert tconfigs.long_context_ok(a) == jconfigs.long_context_ok(a)
    assert sorted(tconfigs.all_configs()) == sorted(jconfigs.all_configs())


def _pair(arch, dtype):
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_reduced_config(arch),
                               dtype=dtype)
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    return jcfg, tcfg, tree, convert.from_reference(tree, tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_loss_prefill_decode_match_reference(arch, dtype):
    """L = 64 reaches the REDUCED flash threshold (the zigzag path); the
    prefill at 32 is naive, then four decode steps on embeddings."""
    jcfg, tcfg, tree, model = _pair(arch, dtype)
    tol = "f32" if dtype == "float32" else "bf16"
    rng = np.random.default_rng(3)
    B, L = 2, 64
    embeds = rng.standard_normal((B, L, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (B, L)).astype(np.int32)
    labels[0, :5] = -1
    jb = {"embeds": jnp.asarray(embeds), "labels": jnp.asarray(labels)}
    tb = {"embeds": torch.from_numpy(embeds),
          "labels": torch.from_numpy(labels)}
    if jcfg.rope_type == "mrope":
        pos3 = _pos3(rng, B, L)
        jb["positions_3d"] = jnp.asarray(pos3)
        tb["positions_3d"] = torch.from_numpy(pos3)
    jp = jax.tree.map(jnp.asarray, tree)
    japply = jax.jit(lambda p, b: jtf.apply(p, b, jcfg))
    jloss = jax.jit(lambda p, b: jtf.loss_fn(p, b, jcfg))
    jprefill = jax.jit(lambda p, b: jtf.prefill(p, b, jcfg, 48))
    jdecode = jax.jit(lambda p, c, pos, e: jtf.decode_step(
        p, c, None, pos, jcfg, embeds=e))
    with torch.no_grad():
        want, _ = japply(jp, jb)
        got, aux = ttf.apply(model, tb, tcfg)
        close(got, want, tol)
        assert float(aux) == 0.0
        want, wm = jloss(jp, jb)
        got, gm = ttf.loss_fn(model, tb, tcfg)
        close(got, want, tol)
        close(gm["ce"], wm["ce"], tol)

        half = {k: v[..., :32, :] if k == "embeds" else v[..., :32]
                for k, v in jb.items() if k != "labels"}
        thalf = {k: v[..., :32, :] if k == "embeds" else v[..., :32]
                 for k, v in tb.items() if k != "labels"}
        want, jc = jprefill(jp, half)
        got, tc = ttf.prefill(model, thalf, tcfg, 48)
        close(got, want, tol)
        for t in range(32, 36):
            p = np.full((B, 1), t, np.int32)
            e = embeds[:, t:t + 1]
            want, jc = jdecode(jp, jc, jnp.asarray(p), jnp.asarray(e))
            got, tc = ttf.decode_step(model, tc, None, torch.from_numpy(p),
                                      tcfg, embeds=torch.from_numpy(e))
            close(got, want, tol)
    # vlm and audio keep an untied head, as the reference's init
    assert model.lm_head.shape == (tcfg.d_model, tcfg.padded_vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_and_full_size(arch):
    """The reference's tree round-trips byte for byte; CONFIG's parameter
    tensors (meta device) count what the reference's ``init_params``
    holds, untied ``lm_head`` included."""
    _, tcfg, tree, model = _pair(arch, "bfloat16")
    back = convert.to_reference(model, tcfg)
    flat_a, flat_b = convert._flatten(tree), convert._flatten(back)
    assert sorted(flat_a) == sorted(flat_b)
    for key, val in flat_a.items():
        assert flat_b[key].tobytes() == val.tobytes(), key
    cfg = tconfigs.get_config(arch)
    full = ttf.init_params(cfg, None)
    shapes = jax.eval_shape(lambda: jtf.init_params(
        jconfigs.get_config(arch), jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in full.parameters()) == want
    assert want == {"qwen2_vl_7b": 7_615_616_512,
                    "musicgen_large": 2_424_506_368}[arch]
