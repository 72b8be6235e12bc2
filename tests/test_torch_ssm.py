"""The port's Mamba2 SSD layer (``repro_torch.models.layers.ssm``) against
the reference's (``repro.models.layers.ssm``).

The same seeded numpy inputs and the reference's weights go through both,
in float32, and agree to 1e-5 relative (``F32_REL``; measured at these
shapes: below 1e-6). ``ssd`` runs within one chunk, over several chunks
with a padded last one (L = 40, chunk 16), and from a carried state;
``mamba_block`` runs in train mode and as a prefill whose conv tail and
SSM state carry into decode steps. Every case runs with one B/C group and
with two, where ``jnp.repeat``'s per-group broadcast (head i reads group
i // (heads / groups)) differs from tiling.
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
from repro.models.layers import ssm as jssm
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.models import blocks as tblk
from repro_torch.models import convert
from repro_torch.models.layers import ssm as tssm

F32_REL = 1e-5
ARCH = "mamba2_130m"


def cfgs(groups):
    kw = dict(dtype="float32", ssm_ngroups=groups)
    return (dataclasses.replace(jax_reduced(ARCH), **kw),
            dataclasses.replace(torch_reduced(ARCH), **kw))


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    top = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=F32_REL, atol=F32_REL * top)


def t(x):
    return torch.from_numpy(np.array(x))


def test_segsum_matches_reference():
    x = np.random.default_rng(0).normal(size=(2, 3, 16)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    got = tssm._segsum(t(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    close(got[finite], want[finite])


def ssd_inputs(seed, L, h=8, p=16, n=16, groups=1):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(2, L, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(2, L, h)))).astype(f)
    A = -np.exp(rng.normal(size=(h,)) * 0.5).astype(f)
    B = rng.normal(size=(2, L, groups, n)).astype(f)
    C = rng.normal(size=(2, L, groups, n)).astype(f)
    state = rng.normal(size=(2, h, p, n)).astype(f)
    return x, dt, A, B, C, state


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("L,carry", [(12, False), (40, False), (40, True)],
                         ids=["one-chunk", "chunks-padded", "init-state"])
def test_ssd_matches_reference(L, carry, groups):
    """chunk 16: L = 12 is one chunk of 12; L = 40 is three chunks, the
    last padded with dt = 0."""
    x, dt, A, B, C, state = ssd_inputs(L, L, groups=groups)
    init = state if carry else None
    want_y, want_s = jssm.ssd(*map(jnp.asarray, (x, dt, A, B, C)), 16,
                              None if init is None else jnp.asarray(init))
    got_y, got_s = tssm.ssd(*map(t, (x, dt, A, B, C)), 16,
                            None if init is None else t(init))
    close(got_y, want_y)
    close(got_s, want_s)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_decode_step_matches_reference(groups):
    x, dt, A, B, C, state = ssd_inputs(3, 1, groups=groups)
    args = (state, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    want = jssm.ssd_decode_step(*map(jnp.asarray, args))
    got = tssm.ssd_decode_step(*map(t, args))
    for g, w in zip(got, want):
        close(g, w)


def block_pair(groups):
    jcfg, tcfg = cfgs(groups)
    tree = jax.tree.map(np.asarray,
                        jblk.init_mamba_layer(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(7)
    # non-trivial values for the zero / one initialized leaves
    m = tree["mamba"]
    H, Din = jcfg.ssm_nheads, jcfg.d_inner
    m["A_log"] = (rng.normal(size=(H,)) * 0.5).astype(np.float32)
    m["D_skip"] = (1 + rng.normal(size=(H,)) * 0.1).astype(np.float32)
    m["dt_bias"] = (rng.normal(size=(H,)) * 0.5).astype(np.float32)
    m["norm_scale"] = (rng.normal(size=(Din,)) * 0.1).astype(np.float32)
    m["conv_b"] = (rng.normal(size=m["conv_b"].shape) * 0.1).astype(
        np.float32)
    tree["ln"]["scale"] = (rng.normal(size=(jcfg.d_model,)) * 0.1).astype(
        np.float32)
    mod = tblk.MambaLayer(torch.Generator().manual_seed(0), tcfg)
    mod.load_state_dict({k: t(v) for k, v in convert._flatten(tree).items()},
                        strict=True)
    x = rng.normal(size=(2, 44, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), mod, x


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_layer_train_matches_reference(groups):
    jcfg, tcfg, jp, mod, x = block_pair(groups)
    want, _ = jblk.mamba_layer(jp, jnp.asarray(x), jcfg, mode="train")
    with torch.no_grad():
        got, cache = tblk.mamba_layer(mod, t(x), tcfg, mode="train")
    assert cache is None
    close(got, want)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_prefill_then_decode_matches_reference(groups):
    """Prefill 40 positions (three chunks of 16, the last padded), then
    four decode steps: each step's output, SSM state and conv tail (the
    rows before the conv) agree."""
    jcfg, tcfg, jp, mod, x = block_pair(groups)
    jcache = jax.tree.map(lambda a: a[0], jssm.init_ssm_cache(2, jcfg, 1))
    tcache = tssm.init_ssm_cache(2, tcfg, "cpu")
    for key in ("ssm", "conv"):
        assert tuple(tcache[key].shape) == tuple(jcache[key].shape)
        assert tcache[key].dtype == getattr(torch, str(jcache[key].dtype))
    want, jcache = jblk.mamba_layer(jp, jnp.asarray(x[:, :40]), jcfg,
                                    mode="prefill", cache_slice=jcache)
    with torch.no_grad():
        got, tcache = tblk.mamba_layer(mod, t(x[:, :40]), tcfg,
                                       mode="prefill", cache_slice=tcache)
    close(got, want)
    for step in range(40, 44):
        for key in ("ssm", "conv"):
            close(tcache[key], jcache[key])
        want, jcache = jblk.mamba_layer(jp, jnp.asarray(x[:, step:step + 1]),
                                        jcfg, mode="decode",
                                        cache_slice=jcache)
        with torch.no_grad():
            got, tcache = tblk.mamba_layer(mod, t(x[:, step:step + 1]), tcfg,
                                           mode="decode", cache_slice=tcache)
        close(got, want)
    # decode from the prefill equals the train-mode run over all 44
    with torch.no_grad():
        full, _ = tblk.mamba_layer(mod, t(x), tcfg, mode="train")
    close(got[:, 0], full[:, -1].numpy())
