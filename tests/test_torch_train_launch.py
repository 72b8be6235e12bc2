"""``python -m repro_torch.launch.train``: a run, a resumed second call on
the same checkpoint directory, the refusals (an external-embedding arch;
the card when there is none), and ``examples/train_lm.py``'s claim — the
loss falls over 30 steps on REDUCED h2o-danube — in both packages."""
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config as jax_reduced
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import DeterministicPipeline as JPipe
from repro.optim import adamw as jadam
from repro.train import step as jstep
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.data.pipeline import DataConfig, DeterministicPipeline
from repro_torch.launch import train as launch
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadam
from repro_torch.train import step as tstep

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _train(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_launcher_runs_and_resumes(tmp_path):
    common = ["--arch", "mamba2-130m", "--reduced", "--batch", "4",
              "--seq", "32", "--checkpoint-every", "3", "--device", "cpu",
              "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-every", "1"]
    out = _train("--steps", "6", *common)
    steps = [int(s) for s in re.findall(r"^step\s+(\d+)\s+loss", out, re.M)]
    assert steps == [1, 2, 3, 4, 5, 6], out
    assert "done: 6 steps" in out and "cpu" in out
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_00000003", "step_00000006"]
    out = _train("--steps", "8", *common)
    steps = [int(s) for s in re.findall(r"^step\s+(\d+)\s+loss", out, re.M)]
    assert steps == [7, 8], out  # resumed from step 6


def test_launcher_refusals():
    with pytest.raises(SystemExit):
        launch.main(["--arch", "qwen2-vl-7b", "--reduced", "--device", "cpu"])
    if not torch.cuda.is_available():
        for dev in (["--device", "cuda"], []):
            with pytest.raises(SystemExit):
                launch.main(["--arch", "mamba2-130m", "--reduced",
                             "--steps", "1", *dev])


def test_loss_falls_in_both_packages():
    """examples/train_lm.py's claim at 30 steps: the mean loss of the last
    10 steps is below that of the first 10, in each package, from the
    same weights and batches."""
    arch, steps = "h2o_danube_1_8b", 30
    jcfg, tcfg = jax_reduced(arch), torch_reduced(arch)
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=steps)
    dkw = dict(seq_len=64, global_batch=8, vocab_size=tcfg.vocab_size,
               seed=0)
    model = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, convert.to_reference(model, tcfg))
    js = jadam.adamw_init(jp)
    jfn = jax.jit(jstep.make_train_step(jcfg, jadam.AdamWConfig(**kw)))
    tfn = tstep.make_train_step(tcfg, tadam.AdamWConfig(**kw))
    ts = tadam.adamw_init(model)
    jdata, tdata = JPipe(JData(**dkw)), DeterministicPipeline(
        DataConfig(**dkw))
    jl, tl = [], []
    for s in range(steps):
        jb = {k: jnp.asarray(v) for k, v in jdata.batch(s).items()}
        jp, js, jm = jfn(jp, js, jb)
        _, _, tm = tfn(model, ts, tdata.batch(s))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    for losses in (jl, tl):
        assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses
    print(f"reference {np.mean(jl[:10]):.3f} -> {np.mean(jl[-10:]):.3f}; "
          f"port {np.mean(tl[:10]):.3f} -> {np.mean(tl[-10:]):.3f}")
