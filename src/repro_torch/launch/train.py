"""End-to-end training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --reduced --steps 100 --batch 8 --seq 128 [--device cuda]

Wires together: config → parameters and AdamW state on ``--device``
(``cuda`` by default; nothing falls back to the CPU) → the deterministic
pipeline → ``make_train_step`` → the fault-tolerant ``Coordinator``
(checkpoint / restart, the train state in the reference's layout, so a
checkpoint of either package restores in the other) → the metrics log. On
``cuda`` the mesh lays over every CUDA device, as the reference's
``make_host_mesh()`` does; with more than one, the model and AdamW's state
are placed over it (``models.placement``) and the state is gathered back
after each step. One card is a (data 1, model 1) mesh and runs the model
unplaced. A second call on the same ``--checkpoint-dir`` resumes from its
last checkpoint. Archs that take external embeddings are refused. The weights
are random, from ``--seed`` on the device (``torch.Generator(device)``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.state import resolve_device
from repro_torch.data.pipeline import DataConfig, DeterministicPipeline
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import placement
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.coordinator import Coordinator, RunConfig
from repro_torch.train.step import bind_state, make_train_step, train_state


def _args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default cuda; refused "
                    "without one)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = _args(argv)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    if cfg.external_embeddings:
        raise SystemExit(
            f"{cfg.name} takes stub embeddings; use examples/train_lm.py "
            "with a token arch instead")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu "
                         "to train on the CPU")

    mesh = make_host_mesh() if device.type == "cuda" \
        else make_host_mesh(devices=[device])
    print(f"mesh: {mesh.shape} devices={mesh.size} ({device})")
    coord = make_coordinator(
        cfg, device, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, log_every=args.log_every,
        mesh=mesh)
    t0 = time.time()
    coord.train()
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps / max(dt, 1e-9):.2f} steps/s); "
          f"events={len(coord.events)}")


def make_coordinator(cfg: ModelConfig, device, *, steps: int, batch: int,
                     seq: int, lr: float, seed: int, checkpoint_dir: str,
                     checkpoint_every: int, log_every: Optional[int] = None,
                     failure_injector: Optional[Callable] = None,
                     mesh: Optional[Mesh] = None) -> Coordinator:
    """The launcher's training run, ready to ``train()``: the pipeline's
    batches (``seed``), ``make_train_step`` under AdamW (warmup a tenth of
    ``steps``, cosine to ``steps``), the train state in the reference's
    layout (``train.step.train_state``) from ``seed`` on ``device``, and
    checkpoints every ``checkpoint_every`` steps in ``checkpoint_dir``.
    ``log_every`` prints the reference's step lines; ``failure_injector``
    is the ``Coordinator``'s. Over a ``mesh`` of more than one device each
    step runs placed (``models.placement``) and writes its parameters, m
    and v back into the train state."""
    optc = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                       total_steps=steps)
    data = DeterministicPipeline(DataConfig(
        seq_len=seq, global_batch=batch, vocab_size=cfg.vocab_size,
        seed=seed))
    step_fn = make_train_step(cfg, optc)

    def init_state_fn():
        gen = torch.Generator(device).manual_seed(seed)
        params = tf.init_params(cfg, gen)
        return train_state(params, adamw_init(params), cfg)

    bound = {}  # the state the model is bound to, and the model

    placed = mesh is not None and mesh.size > 1

    def train_one(state, batch):
        if bound.get("state") is not state:
            bound.update(state=state, model=bind_state(state, cfg))
            if placed:
                params, opt = bound["model"]
                p = placement.place(params, cfg, mesh)
                bound.update(placed=(p, placement.place_opt(opt, p)))
        params, opt = bound["model"]
        if not placed:
            _, _, metrics = step_fn(params, opt, batch)
            return state, metrics
        p, popt = bound["placed"]
        _, _, metrics = step_fn(p, popt, batch)
        placement.gather_state(p, popt, params, opt)
        return state, metrics

    return Coordinator(
        RunConfig(total_steps=steps, checkpoint_every=checkpoint_every,
                  checkpoint_dir=checkpoint_dir),
        train_step=(train_one if log_every is None
                    else _logging_step(train_one, log_every)),
        batch_fn=data.batch, init_state_fn=init_state_fn,
        failure_injector=failure_injector,
        on_restart=lambda _: bound.clear())


def _logging_step(fn, every: int):
    def wrapped(state, batch):
        state, metrics = fn(state, batch)
        step = int(state["opt"]["step"])
        if step % every == 0 or step == 1:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            print(f"step {step:5d}  loss {loss:8.4f}  gnorm {gn:8.3f}",
                  flush=True)
        return state, metrics
    return wrapped


if __name__ == "__main__":
    main()
