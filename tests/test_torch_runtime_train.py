"""The port's training Coordinator: the reference suite's checkpoint /
restart and straggler tests (tests/test_runtime.py) on the port, a REDUCED
LM run with an injected failure bit-identical to a clean one (the path
``launch/train.py`` takes), and training checkpoints that restore across
the two packages with the same leaf paths, dtypes and manifest hash."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro  # noqa: F401
from repro.checkpoint import manager as jman
from repro.configs import get_reduced_config as jax_reduced
from repro.core import hashing as jh
from repro.models import transformer as jtf
from repro.optim import adamw as jadam
from repro_torch.checkpoint import manager as tman
from repro_torch.configs import get_reduced_config as torch_reduced
from repro_torch.core import hashing as th
from repro_torch.launch.train import make_coordinator
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadam
from repro_torch.runtime.coordinator import (Coordinator, RunConfig,
                                             StragglerPolicy)
from repro_torch.train import step as tstep

torch.set_num_threads(min(2, torch.get_num_threads()))


def _toy_setup(tmp_path, failures=(), name="run"):
    """tests/test_runtime.py's toy 'training': state = {w}; the batch a
    pure function of the step."""

    def init_state_fn():
        return {"w": torch.zeros((4, 4), dtype=torch.float64),
                "step_sum": torch.zeros((), dtype=torch.int64)}

    def batch_fn(step):
        rng = np.random.default_rng(step)
        return torch.from_numpy(rng.normal(size=(4, 4)))

    def train_step(state, batch):
        w = state["w"] * 0.9 + batch * 0.1
        return ({"w": w, "step_sum": state["step_sum"] + 1},
                {"loss": torch.sum(w ** 2)})

    injected, fired = set(failures), set()

    def injector(step):
        if step in injected and step not in fired:
            fired.add(step)
            return f"node lost at {step}"
        return None

    run = RunConfig(total_steps=30, checkpoint_every=5,
                    checkpoint_dir=str(tmp_path / name), max_restarts=5)
    return Coordinator(run, train_step, batch_fn, init_state_fn,
                       failure_injector=injector)


def test_failure_recovery_bitwise_identical(tmp_path):
    clean = _toy_setup(tmp_path, failures=(), name="clean").train()
    faulty_coord = _toy_setup(tmp_path, failures=(7, 18), name="faulty")
    faulty = faulty_coord.train()
    assert th.hash_pytree(clean) == th.hash_pytree(faulty)
    events = [e["event"] for e in faulty_coord.events]
    assert events.count("failure") == 2
    assert events.count("restart") == 2


def test_resume_from_existing_checkpoints(tmp_path):
    c1 = _toy_setup(tmp_path, name="resume")
    c1.run = RunConfig(total_steps=12, checkpoint_every=5,
                       checkpoint_dir=str(tmp_path / "resume"))
    c1.train()
    c2 = _toy_setup(tmp_path, name="resume")
    final = c2.train()
    assert any(e["event"] == "resume" for e in c2.events)
    clean = _toy_setup(tmp_path, name="clean2").train()
    assert th.hash_pytree(final) == th.hash_pytree(clean)


def test_straggler_flag_and_evict(tmp_path):
    pol = StragglerPolicy(deadline_factor=2.0, evict_after=2)
    run = RunConfig(total_steps=1, straggler=pol,
                    checkpoint_dir=str(tmp_path / "x"))
    coord = Coordinator(run, lambda s, b: (s, {}), lambda s: None, dict)
    times = {0: 1.0, 1: 1.0, 2: 1.0, 3: 5.0}
    assert coord._check_stragglers(times) == []       # first flag
    assert coord._check_stragglers(times) == [3]      # second → evict
    coord._check_stragglers({0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0})
    assert coord.flag_counts[3] == 0


def _lm_run(tmp_path, name, fail_at=None):
    cfg = torch_reduced("mamba2_130m")
    fired = []

    def injector(step):
        if step == fail_at and not fired:
            fired.append(step)
            return f"node lost at {step}"
        return None

    coord = make_coordinator(
        cfg, torch.device("cpu"), steps=6, batch=4, seq=16, lr=3e-3, seed=0,
        checkpoint_dir=str(tmp_path / name), checkpoint_every=2,
        failure_injector=injector)
    return coord, coord.train()


def test_lm_run_with_failure_equals_clean_run(tmp_path):
    """A REDUCED mamba2 run through the launcher's Coordinator: a failure
    at step 5 restarts from the step-4 checkpoint and ends on the same
    train-state bits as a run without one."""
    clean_coord, clean = _lm_run(tmp_path, "clean")
    coord, faulty = _lm_run(tmp_path, "faulty", fail_at=5)
    events = [e["event"] for e in coord.events]
    assert events.count("failure") == 1
    assert {"event": "restart", "from_step": 4} in coord.events
    assert int(faulty["opt"]["step"]) == 6
    assert th.hash_pytree(clean) == th.hash_pytree(faulty)
    assert th.hash_state_device(faulty) == th.hash_pytree(faulty)
    # the train state is the reference's layout: stacked [L, ...] leaves
    assert faulty["params"]["blocks"]["mamba"]["in_proj"].shape[0] == 4


def _manifest(path):
    m = json.loads((path / "manifest.json").read_text())
    return m["hash"], [(e["path"], e["dtype"], e["shape"])
                       for e in m["leaves"]]


def test_training_checkpoints_cross_restore(tmp_path):
    """A train state written by each package's CheckpointManager restores
    in the other's: the same leaf paths, dtypes, shapes and manifest hash,
    and the same values."""
    tcfg = torch_reduced("granite_moe_3b_a800m")
    jcfg = jax_reduced("granite_moe_3b_a800m")
    model = ttf.init_params(tcfg, torch.Generator().manual_seed(3))
    opt = tadam.adamw_init(model)
    b = {"tokens": np.arange(32, dtype=np.int32).reshape(2, 16) % 97,
         "labels": np.arange(1, 33, dtype=np.int32).reshape(2, 16) % 97}
    tstep.make_train_step(tcfg, tadam.AdamWConfig())(model, opt, b)
    state = tstep.train_state(model, opt, tcfg)

    # the port writes, the reference restores
    tman.CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        state, 1)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    proto = {"params": jparams, "opt": jadam.adamw_init(jparams)}
    jstate, step, h = jman.CheckpointManager(
        str(tmp_path / "port"), async_save=False).restore_latest(proto)
    assert step == 1 and h == th.hash_pytree(state) == jh.hash_pytree(jstate)
    assert int(jstate["opt"]["step"]) == 1

    # the reference writes (its own values moved one step on), the port
    # restores
    jstate["opt"]["step"] = jnp.asarray(2, jnp.int32)
    jstate["params"] = jax.tree.map(lambda x: x * 0.5, jstate["params"])
    jman.CheckpointManager(str(tmp_path / "ref"), async_save=False).save(
        jstate, 2)
    assert _manifest(tmp_path / "ref" / "step_00000002")[1] == \
        _manifest(tmp_path / "port" / "step_00000001")[1]
    other = ttf.init_params(tcfg, torch.Generator().manual_seed(9))
    tproto = tstep.train_state(other, tadam.adamw_init(other), tcfg)
    back, step, h = tman.CheckpointManager(
        str(tmp_path / "ref"), async_save=False).restore_latest(tproto)
    assert step == 2 and h == jh.hash_pytree(jstate) == th.hash_pytree(back)
    params, opt = tstep.bind_state(back, tcfg)
    assert int(opt["step"]) == 2
    ref = convert.to_reference(params, tcfg)
    for a, t in zip(jax.tree_util.tree_leaves(jstate["params"]),
                    jax.tree_util.tree_leaves(ref)):
        assert np.array_equal(np.asarray(a), t)


def test_compressed_step_keeps_pods_identical():
    """``make_compressed_train_step`` over ["cpu"] * 2 on REDUCED mamba2:
    both replicas end on the same bits, a second run repeats them, and
    each pod carries its own error-feedback residual."""
    from repro_torch.data.pipeline import DataConfig, DeterministicPipeline
    cfg = torch_reduced("mamba2_130m")
    data = DeterministicPipeline(DataConfig(seq_len=16, global_batch=4,
                                            vocab_size=cfg.vocab_size))
    hashes = []
    for _ in range(2):
        params = [ttf.init_params(cfg, torch.Generator().manual_seed(1))
                  for _ in range(2)]
        opts = [tadam.adamw_init(p) for p in params]
        step = tstep.make_compressed_train_step(
            cfg, tadam.AdamWConfig(lr=1e-3), ["cpu", "cpu"])
        for s in range(2):
            params, opts, m = step(params, opts, data.batch(s))
        assert all(int(o["step"]) == 2 and "residual" in o for o in opts)
        assert not all(torch.equal(opts[0]["residual"][k],
                                   opts[1]["residual"][k])
                       for k in opts[0]["residual"])
        hashes += [th.hash_pytree(dict(p.named_parameters()))
                   for p in params]
    assert len(set(hashes)) == 1
