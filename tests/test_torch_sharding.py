"""The port's partition rules against the reference's: every arch's
full CONFIG (its parameters' shapes from the port's ``Transformer`` built
on the meta device, the reference's from ``jax.eval_shape``) at mesh shapes
(16, 16), (2, 16, 16) and (1, 1); the batch, logits and decode-cache specs
too. The reference's rules read only a mesh's ``axis_names`` and ``shape``,
so both packages are handed the port's device-free ``Mesh``."""
import jax
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_config as jax_config
from repro.models import sharding as jshd
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import convert
from repro_torch.models import sharding as tshd
from repro_torch.models import transformer as ttf

MESHES = {"16x16": tmesh.make_production_mesh(),
          "2x16x16": tmesh.make_production_mesh(multi_pod=True),
          "1x1": tmesh.Mesh(("data", "model"), (1, 1))}


def _as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_io_specs_match_reference(arch):
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    shapes = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    model = ttf.init_params(tcfg, None)
    assert model.embed.device.type == "meta"
    caches = jax.eval_shape(lambda: jtf.init_caches(jcfg, 4, 64))
    tcaches = convert.reference_caches(
        ttf.init_caches(tcfg, 4, 64, "meta"), tcfg)
    for name, mesh in MESHES.items():
        want = _as_tuples(jshd.param_specs(shapes, jcfg, mesh))
        assert tshd.param_specs(model, tcfg, mesh) == want, name
        for gb in (4, 256, 7):
            assert tshd.train_batch_specs(tcfg, mesh, gb) == _as_tuples(
                jshd.train_batch_specs(jcfg, mesh, gb)), (name, gb)
            assert tshd.logits_spec(tcfg, mesh, gb) == tuple(
                jshd.logits_spec(jcfg, mesh, gb)), (name, gb)
        for batch in (4, 1):
            assert tshd.cache_specs(tcfg, mesh, batch, tcaches) == _as_tuples(
                jshd.cache_specs(jcfg, mesh, batch, caches)), (name, batch)


def test_host_mesh_over_named_devices():
    m = tmesh.make_host_mesh(devices=["cpu"] * 8)
    assert m.shape == {"data": 1, "model": 8} and m.size == 8
    assert tmesh.batch_axes(m) == ("data",) == tmesh.dp_axes(m)
    m = tmesh.make_host_mesh(model=2, devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2}
    prod = tmesh.make_production_mesh(multi_pod=True)
    assert tmesh.batch_axes(prod) == ("pod", "data") == tmesh.dp_axes(prod)
    assert prod.devices == ()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_host_mesh()
