"""Memory-augmented serving launcher (the port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --reduced --docs 64 --requests 8 [--device cuda]

Serves the token-input archs (dense, moe, ssm, hybrid); the vlm and audio
archs take external embeddings and are refused.

Boots a model on ``--device`` (``cuda`` by default; nothing falls back to
the CPU), ingests documents through the Valori boundary, serves batched
retrieval-augmented generation, and proves the audit-trail property:
replaying the command log reproduces the memory hash bit for bit. The
flags and prints are the reference's:

  --shards N           sharded-layout engine in one process
  --spawn-shards N     spawn N shard-server subprocesses
                       (``python -m repro_torch.net.server --device D``)
                       and serve through them over the wire protocol
  --hosts a:p,b:p      attach to already-running shard servers instead
  --durable-dir DIR    durable store / coordinator metadata directory
                       (required for --hosts; defaulted for --spawn-shards)
  --replicas K         attach K verified read replicas per shard; retrieval
                       routes to the pool once the replicas prove the
                       flush cursor. Needs --durable-dir (defaulted)
  --route R            force the read route (exact | hnsw | coarse) or
                       leave the planner to choose (auto)
  --ef-coarse N        candidate-set size for the compressed coarse tier;
                       defaulted to cover the corpus when --route coarse is
                       forced without it

The weights are random, from ``--seed`` on the device
(``torch.Generator(device)``).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core import hnsw
from repro_torch.core.state import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.net.replica import FollowerPolicy
from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig


def _spawn_shard_servers(n: int, capacity: int, dim: int, workdir: str,
                         device: str):
    """Start n shard-server subprocesses on ephemeral ports; returns
    (procs, ["127.0.0.1:<port>", ...]) once every server printed its
    LISTENING line (i.e. is accepting connections)."""
    procs, hosts = [], []
    for s in range(n):
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.net.server",
             "--dir", os.path.join(workdir, f"shard_{s}"),
             "--capacity", str(capacity // n), "--dim", str(dim),
             "--device", device, "--port", "0"],
            stdout=subprocess.PIPE, text=True, env=dict(os.environ))
        procs.append(proc)
        line = proc.stdout.readline().strip()
        if not line.startswith("LISTENING "):
            raise RuntimeError(f"shard server {s} failed to start: {line!r}")
        hosts.append(f"127.0.0.1:{int(line.split()[1])}")
    return procs, hosts


def _args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--docs", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--doc-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model, the memory and the shard "
                         "servers run (default cuda; refused without one)")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--spawn-shards", type=int, default=0,
                    help="spawn N shard-server subprocesses and serve "
                         "through the wire protocol")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated host:port shard servers "
                         "(needs --durable-dir)")
    ap.add_argument("--durable-dir", default=None)
    ap.add_argument("--replicas", type=int, default=0,
                    help="verified read replicas per shard; retrieval "
                         "routes to the pool at proven cursors")
    ap.add_argument("--follow", action="store_true",
                    help="run the replica pool as live followers, each "
                         "tailing the primary on a background thread")
    ap.add_argument("--follow-delay", type=float, default=0.05,
                    help="follower staleness bound in seconds "
                         "(FollowerPolicy.max_delay_s)")
    ap.add_argument("--route", default="auto",
                    choices=["auto", "exact", "hnsw", "coarse"],
                    help="read route: planner's choice (auto) or forced")
    ap.add_argument("--ef-coarse", type=int, default=0,
                    help="coarse-tier candidate-set size (0 disables the "
                         "compressed tier under auto routing)")
    ap.add_argument("--churn", type=int, default=0,
                    help="delete N of the ingested docs before serving")
    ap.add_argument("--relink-dead-ratio", type=float, default=0.0,
                    help="schedule the deterministic HNSW re-link pass at "
                         "this dead fraction; 0 disables")
    args = ap.parse_args(argv)
    if args.route == "coarse" and args.ef_coarse <= 0:
        # a forced coarse route needs a candidate-set size; cover the
        # whole corpus, which also makes the answer bit-equal to exact
        args.ef_coarse = max(args.docs, 1)
    return args


def main(argv=None) -> None:
    args = _args(argv)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    if cfg.external_embeddings:
        raise SystemExit(f"{cfg.name} takes stub embeddings; pick a token "
                         "arch")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

    hosts = args.hosts.split(",") if args.hosts else None
    n = args.spawn_shards or (len(hosts) if hosts else max(args.shards, 1))
    capacity = max(args.docs * 2, 256)
    capacity += (-capacity) % n  # divide evenly across shards
    durable_dir = args.durable_dir

    procs = []
    try:
        if args.spawn_shards:
            workdir = tempfile.mkdtemp(prefix="valori-net-")
            procs, hosts = _spawn_shard_servers(args.spawn_shards, capacity,
                                                cfg.d_model, workdir,
                                                str(device))
            if durable_dir is None:
                durable_dir = os.path.join(workdir, "coord")
            print(f"spawned {len(procs)} shard servers: {', '.join(hosts)}")

        if args.replicas and durable_dir is None:
            # replicas tail a durable WAL; default one rather than refusing
            durable_dir = tempfile.mkdtemp(prefix="valori-serve-")

        rng = np.random.default_rng(args.seed)
        params = tf.init_params(
            cfg, torch.Generator(device).manual_seed(args.seed))
        engine = MemoryAugmentedEngine(cfg, params, ServeConfig(
            capacity=capacity, max_new_tokens=args.max_new,
            s_cache=args.doc_len + args.prompt_len + args.max_new + 32,
            context_tokens=min(32, args.doc_len),
            shards=args.shards if hosts is None else 1,
            hosts=hosts, durable_dir=durable_dir,
            replicas=args.replicas,
            follow=(FollowerPolicy(max_delay_s=args.follow_delay)
                    if args.follow else None),
            route=args.route, ef_coarse=args.ef_coarse,
            # floors scaled to the demo corpus so the pass actually fires
            # at launcher scale; production defaults are the dataclass's
            relink=(hnsw.RelinkPolicy(dead_ratio=args.relink_dead_ratio,
                                      min_deletes=1, check_every=1)
                    if args.relink_dead_ratio > 0 else None)),
            device=device)

        docs = rng.integers(0, cfg.vocab_size, (args.docs, args.doc_len),
                            dtype=np.int32)
        t0 = time.time()
        ids = engine.insert_documents(docs)
        print(f"ingested {len(ids)} docs in {time.time() - t0:.2f}s; "
              f"memory hash {engine.memory_hash():#x}")

        if args.churn:
            victims = ids[:min(args.churn, len(ids))]
            removed = engine.delete_documents(victims)
            print(f"churned {removed} docs; graph_gen={engine.graph_gen} "
                  f"(re-links at {engine.relink_ts}); "
                  f"memory hash {engine.memory_hash():#x}")

        if args.replicas and not args.follow:
            lag = engine.sync_replicas()
            print(f"synced {args.replicas} replicas/shard "
                  f"(residual lag {lag} commands)")
        elif args.replicas:
            # live followers: no manual barrier — wait until the pool
            # proves the flush cursor, bounded so a fault is visible
            flush_t = engine.flush()
            deadline = time.time() + 30.0
            while (min(r.t for pool in engine.read_replicas for r in pool)
                   < flush_t):
                if time.time() > deadline:
                    raise SystemExit("followers failed to reach the "
                                     f"flush cursor t={flush_t}")
                time.sleep(0.01)
            print(f"{args.replicas} followers/shard tailed to proven "
                  f"cursor t={flush_t} (no sync_replicas call)")

        prompts = rng.integers(0, cfg.vocab_size,
                               (args.requests, args.prompt_len),
                               dtype=np.int32)
        nn_ids, _ = engine.retrieve(prompts)
        print("retrieved neighbors:", nn_ids[:, 0].tolist())
        print(f"planned route: {engine.last_plan.route} "
              f"({engine.last_plan.reason}) "
              f"graph_gen={engine.last_plan.graph_gen}")
        if args.replicas:
            print(f"served by: {engine.last_plan.served_by}")

        t0 = time.time()
        engine.generate(prompts)
        dt = time.time() - t0
        print(f"generated {args.requests}x{args.max_new} tokens in {dt:.2f}s "
              f"({args.requests * args.max_new / dt:.1f} tok/s)")

        replay_hash = engine.replay_log_fresh()
        live_hash = engine.state_hash()
        if replay_hash != live_hash:
            raise SystemExit(f"replay diverged: {replay_hash:#x} != "
                             f"{live_hash:#x}")
        print(f"audit: replay(S0, log) hash {replay_hash:#x} == live state ✓")
        engine.close()
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.wait(timeout=10)


if __name__ == "__main__":
    main()
