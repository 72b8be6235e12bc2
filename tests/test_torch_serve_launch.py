"""``python -m repro_torch.launch.serve``: the port's serving launcher runs the
LM path end to end on the CPU when asked (flat, sharded in process, and
through spawned shard-server processes; the dense, moe, ssm and hybrid
families), refuses the archs it does not serve (the embedding-input VLM and
audio archs), and never moves to the CPU on its own."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
BASE = ["--arch", "h2o-danube-1.8b", "--reduced", "--docs", "16",
        "--requests", "2", "--device", "cpu"]


def serve(*args, code=None):
    cmd = [sys.executable, "-c", code] if code else \
        [sys.executable, "-m", "repro_torch.launch.serve"]
    return subprocess.run(cmd + list(args), env=ENV, capture_output=True,
                          text=True, timeout=240, cwd=ROOT)


# the moe, ssm and hybrid cases name their arch after BASE's: argparse
# keeps the last --arch
FAMILIES = ["mamba2-130m", "granite-moe-3b-a800m", "zamba2-2.7b"]


@pytest.mark.parametrize("extra", [[], ["--shards", "2"],
                                   ["--spawn-shards", "2", "--replicas", "1"],
                                   ["--route", "coarse", "--churn", "3"]]
                         + [["--arch", arch] for arch in FAMILIES],
                         ids=["flat", "shards", "spawn-replicas", "coarse"]
                         + FAMILIES)
def test_serve_runs_and_audits(extra):
    res = serve(*BASE, *extra)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "ingested 16 docs" in out
    assert "generated 2x16 tokens" in out
    assert "audit: replay(S0, log) hash" in out and "== live state" in out
    if "--route" in extra:
        assert "planned route: coarse" in out
    if "--replicas" in extra:
        assert "spawned 2 shard servers" in out
        assert "served by: replica:0" in out


@pytest.mark.parametrize("arch,message", [
    ("musicgen-large", "takes stub embeddings; pick a token arch"),
    ("qwen2-vl-7b", "takes stub embeddings; pick a token arch")])
def test_serve_refuses_unserved_archs(arch, message):
    res = serve("--arch", arch, "--reduced", "--device", "cpu")
    assert res.returncode != 0
    assert message in res.stderr


def test_serve_without_cuda_refuses_instead_of_falling_back():
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from repro_torch.launch import serve\n"
            "sys.argv = ['serve'] + sys.argv[1:]\n"
            "serve.main()\n")
    res = serve("--arch", "h2o-danube-1.8b", "--reduced", "--docs", "4",
                code=code)
    assert res.returncode != 0
    assert "device='cpu'" in res.stderr
    assert "ingested" not in res.stdout
