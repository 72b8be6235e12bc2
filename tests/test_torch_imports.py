"""Import hygiene: the port, chip_smoke.py and the golden helper it loads
never import JAX or the JAX package, and entry points never fall back to
the CPU on their own."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_port_imports_neither_jax_nor_reference():
    mods = list(_modules())
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) >= 20
    assert {"repro_torch.core.codes", "repro_torch.core.snapshot",
            "repro_torch.core.distributed", "repro_torch.core.shard_wal",
            "repro_torch.kernels.qcoarse.ops",
            "repro_torch.kernels.qcoarse.kernel",
            "repro_torch.net.protocol", "repro_torch.net.server",
            "repro_torch.net.client", "repro_torch.net.replica",
            "repro_torch.runtime.coordinator",
            "repro_torch.configs", "repro_torch.configs.gemma2_2b",
            "repro_torch.models.config", "repro_torch.models.initializers",
            "repro_torch.models.layers.norms",
            "repro_torch.models.layers.rope",
            "repro_torch.models.layers.mlp",
            "repro_torch.models.layers.attention",
            "repro_torch.models.layers.moe", "repro_torch.models.layers.ssm",
            "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.phi3_5_moe_42b_a6_6b",
            "repro_torch.configs.mamba2_130m",
            "repro_torch.configs.zamba2_2_7b",
            "repro_torch.models.blocks", "repro_torch.models.transformer",
            "repro_torch.models.convert",
            "repro_torch.launch.serve",
            "repro_torch.models.sharding", "repro_torch.launch.mesh",
            "repro_torch.launch.train", "repro_torch.train.step",
            "repro_torch.optim.adamw", "repro_torch.optim.compress",
            "repro_torch.data.pipeline", "repro_torch.runtime.elastic"
            } <= set(mods)


def _imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  ROOT / "scripts" / "probe_qcoarse.py",
                                  ROOT / "tests" / "_torch_golden.py",
                                  *sorted(PKG.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_reference(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_init_state_without_device_refuses_cpu_fallback():
    code = ("import torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from repro_torch.core.state import init_state\n"
            "try:\n    init_state(4, 4)\nexcept RuntimeError as e:\n"
            "    assert \"device='cpu'\" in str(e); print('raised')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.stdout.strip() == "raised", res.stdout + res.stderr
