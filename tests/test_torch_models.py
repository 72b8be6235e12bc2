"""The port's LM stack (``repro_torch.models``) against the reference's.

Both packages get the same weights (the reference's init, carried across
by ``repro_torch.models.convert``) and the same seeded numpy inputs. In
float32 compute each layer and each entry point agrees to 1e-5 relative
(``F32_REL``), absolute against the largest magnitude (at least 1): the
two differ only in the order of float32 sums. In
bfloat16 compute (the configs' own dtype) the logits agree to 5 % of their
largest magnitude (``BF16_REL``): the packages round different
intermediates to bf16 (XLA keeps some fused elementwise chains in f32),
each rounding is worth up to one bf16 step (2^-8 relative), and the
dozen or so roundings along four layers' residual stream reach the
logits at about 1 % of their range (measured: 0.6-1.3 % on the four
configs).
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
from repro.models import transformer as jtf
from repro.models.layers import attention as jatt
from repro.models.layers import mlp as jmlp
from repro.models.layers import norms as jnorms
from repro.models.layers import rope as jrope
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.models import blocks as tblk
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import attention as tatt
from repro_torch.models.layers import mlp as tmlp
from repro_torch.models.layers import norms as tnorms
from repro_torch.models.layers import rope as trope

F32_REL = 1e-5
BF16_REL = 0.05
DENSE = ["gemma2_2b", "h2o_danube_1_8b", "codeqwen1_5_7b", "granite_34b"]


def cfgs(arch, **kw):
    """The arch's REDUCED config in both packages, with the same edits."""
    return (dataclasses.replace(jax_reduced(arch), **kw),
            dataclasses.replace(torch_reduced(arch), **kw))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def load(module, tree):
    """Load a reference param subtree (numpy) into a port module."""
    flat = convert._flatten(tree)
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in flat.items()}, strict=True)
    return module


def close(got, want, tol="f32"):
    """``tol`` "f32": F32_REL relative, and absolute F32_REL of max(1, the
    largest |want|); "bf16": BF16_REL of the largest |want|, absolute."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max()) if want.size else 0.0
    if tol == "bf16":
        np.testing.assert_allclose(got, want, rtol=0.0, atol=BF16_REL * top)
    else:
        np.testing.assert_allclose(got, want, rtol=F32_REL,
                                   atol=F32_REL * max(1.0, top))


def positions(B, L):
    return np.broadcast_to(np.arange(L, dtype=np.int32)[None], (B, L)).copy()


# --------------------------------------------------------------------------- #
# layers, f32
# --------------------------------------------------------------------------- #


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    want = jnorms.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    mod = tnorms.RMSNorm(64, torch.float32)
    mod.scale.data = torch.from_numpy(scale)
    close(tnorms.rmsnorm(mod, torch.from_numpy(x), 1e-6), want)


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    pos = positions(2, 12)
    x = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    ja = jrope.rope_angles(jnp.asarray(pos), 16, 10_000.0)
    ta = trope.rope_angles(torch.from_numpy(pos), 16, 10_000.0)
    close(ta, ja)
    close(trope.apply_rope(torch.from_numpy(x), ta),
          jrope.apply_rope(jnp.asarray(x), ja))


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu_mlp"])
def test_mlp_matches_reference(activation):
    rng = np.random.default_rng(2)
    tree = to_np(jmlp.init_mlp(jax.random.PRNGKey(0), 32, 48, activation,
                               jnp.float32))
    mod = load(tmlp.MLP(torch.Generator().manual_seed(0), 32, 48, activation,
                        torch.float32), tree)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    close(tmlp.mlp(mod, torch.from_numpy(x), activation),
          jmlp.mlp(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                   activation))


def _attn_pair(arch, **kw):
    jcfg, tcfg = cfgs(arch, dtype="float32", **kw)
    tree = to_np(jatt.init_attention(jax.random.PRNGKey(2), jcfg))
    mod = load(tatt.Attention(torch.Generator().manual_seed(0), tcfg), tree)
    return jcfg, tcfg, tree, mod


def _qkv(tcfg, B, L, seed):
    rng = np.random.default_rng(seed)
    H, KV, Dh = tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim_
    return (rng.normal(size=(B, L, H, Dh)).astype(np.float32),
            rng.normal(size=(B, L, KV, Dh)).astype(np.float32),
            rng.normal(size=(B, L, KV, Dh)).astype(np.float32))


@pytest.mark.parametrize("path,window", [("naive", None), ("naive", 16),
                                         ("flash", None), ("flash", 16),
                                         ("zigzag", None)])
def test_attention_paths_match_reference(path, window):
    """Each path on the same q, k, v. L = 64 in chunks of 16 with a window
    of 16 gives flash fully masked blocks (query chunk 3 against KV block
    0), which must contribute nothing."""
    jcfg, tcfg = cfgs("gemma2_2b", dtype="float32")
    q, k, v = _qkv(tcfg, 2, 64, 3)
    pos = positions(2, 64)
    jargs = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    targs = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    if path == "zigzag":
        want = jatt._flash_attend_zigzag(*jargs, jcfg)
        got = tatt._flash_attend_zigzag(*targs, tcfg)
    else:
        fn = {"naive": "_naive_attend", "flash": "_flash_attend"}[path]
        want = getattr(jatt, fn)(*jargs, jcfg, window)
        got = getattr(tatt, fn)(*targs, tcfg, window)
    close(got, want)
    # every path also equals the port's naive attention
    close(got, tatt._naive_attend(*targs, tcfg, window))


@pytest.mark.parametrize("local", [False, True])
def test_attention_prefill_and_ring_decode_match_reference(local):
    """``attention`` in prefill mode with L > S (the last S positions kept
    at slot pos % S), then decode steps that wrap the ring."""
    jcfg, tcfg, tree, mod = _attn_pair("h2o_danube_1_8b")
    rng = np.random.default_rng(4)
    B, L, S = 2, 24, 16
    x = rng.normal(size=(B, L + 6, jcfg.d_model)).astype(np.float32)
    pos = positions(B, L + 6)
    jp = jax.tree.map(jnp.asarray, tree)
    jcache = jax.tree.map(lambda a: a[0], jatt.init_cache(B, S, jcfg, 1))
    tcache = tatt.init_cache(B, S, tcfg, "cpu")
    want, jcache = jatt.attention(jp, jnp.asarray(x[:, :L]),
                                  jnp.asarray(pos[:, :L]), jcfg, local=local,
                                  mode="prefill", cache_slice=jcache)
    got, tcache = tatt.attention(mod, torch.from_numpy(x[:, :L]),
                                 torch.from_numpy(pos[:, :L]), tcfg,
                                 local=local, mode="prefill",
                                 cache_slice=tcache)
    close(got, want)
    for key in ("k", "v", "pos"):
        close(tcache[key], jcache[key])
    for t in range(L, L + 6):
        want, jcache = jatt.attention(
            jp, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos[:, t:t + 1]),
            jcfg, local=local, mode="decode", cache_slice=jcache)
        got, tcache = tatt.attention(
            mod, torch.from_numpy(x[:, t:t + 1]),
            torch.from_numpy(pos[:, t:t + 1]), tcfg, local=local,
            mode="decode", cache_slice=tcache)
        close(got, want)
    for key in ("k", "v", "pos"):
        close(tcache[key], jcache[key])


@pytest.mark.parametrize("arch", ["gemma2_2b", "h2o_danube_1_8b"])
def test_decoder_block_matches_reference(arch):
    """pre_post (gemma2 sandwich) and pre (llama) norm styles."""
    jcfg, tcfg = cfgs(arch, dtype="float32")
    tree = to_np(jblk.init_decoder_block(jax.random.PRNGKey(5), jcfg))
    # non-zero norm scales, so (1 + w) is exercised
    rng = np.random.default_rng(5)
    for name in tree:
        if name.startswith("ln_"):
            tree[name]["scale"] = rng.normal(size=(jcfg.d_model,)).astype(
                np.float32) * 0.1
    mod = load(tblk.DecoderBlock(torch.Generator().manual_seed(0), tcfg),
               tree)
    x = rng.normal(size=(2, 20, jcfg.d_model)).astype(np.float32)
    pos = positions(2, 20)
    want, _, _ = jblk.decoder_block(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(x), jnp.asarray(pos), jcfg,
                                    local=True, mode="train")
    got, _, aux = tblk.decoder_block(mod, torch.from_numpy(x),
                                     torch.from_numpy(pos), tcfg, local=True,
                                     mode="train")
    assert float(aux) == 0.0
    close(got, want)


# --------------------------------------------------------------------------- #
# the whole model: apply, prefill, decode_step
# --------------------------------------------------------------------------- #


def _model_pair(arch, dtype):
    jcfg, tcfg = cfgs(arch, dtype=dtype)
    tree = to_np(jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, tree, convert.from_reference(tree, tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_apply_prefill_decode_match_reference(arch, dtype):
    """L = 64 reaches the flash threshold of every REDUCED config: the
    global layers take the zigzag path and the windowed ones flash with
    fully masked blocks; prefill at 32 is naive, and decode steps follow."""
    jcfg, tcfg, tree, model = _model_pair(arch, dtype)
    tol = "f32" if dtype == "float32" else "bf16"
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64), dtype=np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        want, _ = jtf.apply(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
        got, aux = ttf.apply(model, {"tokens": torch.from_numpy(tokens)},
                             tcfg)
        close(got, want, tol)
        assert float(aux) == 0.0
        want, jc = jtf.prefill(jp, {"tokens": jnp.asarray(tokens[:, :32])},
                               jcfg, 48)
        got, tc = ttf.prefill(model, {"tokens": torch.from_numpy(
            tokens[:, :32])}, tcfg, 48)
        close(got, want, tol)
        for t in range(32, 36):
            p = np.full((2, 1), t, np.int32)
            want, jc = jtf.decode_step(jp, jc, jnp.asarray(tokens[:, t:t + 1]),
                                       jnp.asarray(p), jcfg)
            got, tc = ttf.decode_step(model, tc, torch.from_numpy(
                tokens[:, t:t + 1]), torch.from_numpy(p), tcfg)
            close(got, want, tol)


def test_prefill_longer_than_the_window_cache():
    """gemma2's local layers hold min(window, s_cache) = 16 slots; a
    prefill of 40 keeps the last 16 positions there, and decode continues
    through the wrapped ring on both packages."""
    jcfg, tcfg, tree, model = _model_pair("gemma2_2b", "float32")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 46), dtype=np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        want, jc = jtf.prefill(jp, {"tokens": jnp.asarray(tokens[:, :40])},
                               jcfg, 64)
        got, tc = ttf.prefill(model, {"tokens": torch.from_numpy(
            tokens[:, :40])}, tcfg, 64)
        close(got, want)
        assert tc[0]["k"].shape[1] == 16 and tc[1]["k"].shape[1] == 64
        close(tc[0]["pos"], jc["a"]["pos"][0])
        close(tc[1]["pos"], jc["b"]["pos"][0])
        for t in range(40, 46):
            p = np.full((2, 1), t, np.int32)
            want, jc = jtf.decode_step(jp, jc, jnp.asarray(tokens[:, t:t + 1]),
                                       jnp.asarray(p), jcfg)
            got, tc = ttf.decode_step(model, tc, torch.from_numpy(
                tokens[:, t:t + 1]), torch.from_numpy(p), tcfg)
            close(got, want)


@pytest.mark.parametrize("arch", DENSE)
def test_convert_round_trip_keeps_bytes(arch):
    jcfg, tcfg, tree, model = _model_pair(arch, "bfloat16")
    back = convert.to_reference(model, tcfg)
    flat_a, flat_b = convert._flatten(tree), convert._flatten(back)
    assert sorted(flat_a) == sorted(flat_b)
    for key, val in flat_a.items():
        assert flat_b[key].dtype == val.dtype and \
            flat_b[key].tobytes() == val.tobytes(), key
    assert sum(p.numel() for p in model.parameters()) == \
        sum(v.size for v in flat_a.values())


def test_init_is_seeded_and_counts_the_reference_params():
    """The port's init: the same seed gives the same weights, and the
    parameter count is ``param_count()``'s."""
    _, tcfg = cfgs("gemma2_2b")
    a = ttf.init_params(tcfg, torch.Generator().manual_seed(3))
    b = ttf.init_params(tcfg, torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert sum(p.numel() for p in a.parameters()) == tcfg.param_count()
    assert float(a.embed.detach().abs().max()) <= 2.0
