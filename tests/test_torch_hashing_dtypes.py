"""The port's two tree hashes read a leaf's bits, for every dtype the
reference hashes, and ``CommandLog.record`` drives a reference-style step
loop to the reference's hash.

``hash_pytree`` (host) and ``hash_state_device`` (torch on the leaves'
device) must both equal ``repro.core.hashing.hash_pytree`` on the same
tree: bool, int8-int64, uint8, float16, bfloat16, float32 and float64
leaves, with ±0.0, ±inf, NaN and 0-size leaves among the floats."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.core import commands as jc
from repro.core import hashing as jh
from repro.core import machine as jm
from repro.core.state import init_state as j_init
from repro_torch.core import hashing as th
from repro_torch.core import machine as tm
from repro_torch.core.state import init_state as t_init

from _torch_parity import to_port_log

DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "float16",
          "bfloat16", "float32", "float64"]
SPECIAL = [0.0, -0.0, np.inf, -np.inf, 1.5, -2.25, 65504.0, 1e-7]


def _np_dtype(name):
    return np.dtype(ml_dtypes.bfloat16) if name == "bfloat16" \
        else np.dtype(name)


def _values(name, rng, shape):
    if name == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if name.startswith(("int", "uint")):
        info = np.iinfo(name)
        return rng.integers(info.min, info.max, shape, endpoint=True,
                            dtype=name)
    x = rng.normal(size=shape) * 100
    flat = x.reshape(-1)
    flat[:len(SPECIAL)] = SPECIAL[:flat.size]
    return np.asarray(x.astype(_np_dtype(name)))


def _port(arr):
    """A numpy array (bfloat16 from ml_dtypes included) as a torch tensor
    with the same bits."""
    if arr.dtype == np.dtype(ml_dtypes.bfloat16):
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


@pytest.mark.parametrize("name", DTYPES)
def test_both_hashes_equal_reference(name):
    rng = np.random.default_rng(DTYPES.index(name))
    tree = {"a": _values(name, rng, (5, 7)),
            "empty": _values(name, rng, (0, 3)),
            "nest": [_values(name, rng, (16,)), _values(name, rng, ())]}
    if name.startswith("float"):
        tree["nan"] = np.full((3,), np.nan, dtype=_np_dtype(name))
    want = jh.hash_pytree(jax.tree.map(jnp.asarray, tree))
    port = {"a": _port(tree["a"]), "empty": _port(tree["empty"]),
            "nest": [_port(x) for x in tree["nest"]]}
    if "nan" in tree:
        port["nan"] = _port(tree["nan"])
    assert str(port["a"].dtype).removeprefix("torch.") == name
    assert th.hash_pytree(port) == want
    assert th.hash_state_device(port) == want


def test_bfloat16_value_from_the_reference():
    """The issue's example: the reference hashes this tree to
    12955485543623800944; both port paths must too (the device path once
    truncated floats to integers, and the host path refused bfloat16)."""
    t = {"w": torch.tensor([0.5, 1.5, -2.25], dtype=torch.bfloat16)}
    j = {"w": jnp.asarray([0.5, 1.5, -2.25], dtype=jnp.bfloat16)}
    assert jh.hash_pytree(j) == 12955485543623800944
    assert th.hash_pytree(t) == th.hash_state_device(t) \
        == 12955485543623800944
    f32 = {"w": torch.tensor([0.5, 1.5, -2.25])}
    assert th.hash_state_device(f32) == th.hash_pytree(f32) \
        == jh.hash_pytree({"w": jnp.asarray([0.5, 1.5, -2.25],
                                             jnp.float32)})


def test_record_step_loop_reaches_reference_hash():
    """``s = apply_command(s, log.record(i))`` for each i, as the
    reference's durability tests step (tests/test_durability.py:40)."""
    D = 8
    rng = np.random.default_rng(0)
    log = jc.insert_batch(jnp.arange(5, dtype=jnp.int64) + 3,
                          rng.integers(-4000, 4000, (5, D)).astype(np.int32))
    for rec in (jc.delete_cmd(4, D), jc.link_cmd(3, 5, D),
                jc.set_meta_cmd(6, 1, -7, D), jc.unlink_cmd(3, 5, D),
                jc.insert_cmd(4, np.full((D,), 77, np.int32))):
        log = log.concat(rec)
    step = jax.jit(jm.apply_command)
    js, ts = j_init(16, D), t_init(16, D, device="cpu")
    tlog = to_port_log(log)
    hashes = []
    for i in range(len(log)):
        js = step(js, log.record(i))
        ts = tm.apply_command(ts, tlog.record(i))
        hashes.append((jh.hash_pytree(js), th.hash_pytree(ts)))
    assert all(a == b for a, b in hashes)
    assert len(set(a for a, _ in hashes)) == len(log)
    last = tlog.record(-1)
    assert len(last) == 1 and int(last.arg0[0]) == 4
    with pytest.raises(IndexError):
        tlog.record(len(log))
