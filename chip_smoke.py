#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--docs 1536] [--seed 0]

Phases (any failure raises and exits non-zero):

1. build — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
2. kernels — each kernel (qboundary, qgemm, qtopk, qcoarse, and qhnsw's
   search and insert) against its
   plain PyTorch version on the card, bitwise, at the main path's shapes
   and at edge shapes (qboundary also at odd widths, at d = 40000 on its
   looped form, one float past 16-byte alignment and on rows whose sum of
   squares wraps, each case with the path it took; under Q4.27 and Q1.30,
   beyond its reciprocal-division bound, ``normalize_embedding`` on the
   card takes the kernel's exact-divide instance, one launch per call, and
   equals the CPU's on every load path; and timed at both of
   its main-path shapes as a whole call and as the kernel alone in a CUDA
   graph; qgemm also on int16 and int64 rows and on values
   beyond +-2^23 in some tiles, against the CPU's int64 product; each
   qgemm / qcoarse case prints the load path it took; qtopk also at
   k > n >= 1024 (the reference's pad columns), at k = 4095 / 4096 past
   one tile, and at [64, 131072] on all-equal, mostly-INF, extreme and
   40-shared-top-bit rows and at k = 8192); then timed with CUDA events
   beside its plain version, the one PyTorch call that computes the same
   function where there is one, and its bound (qtopk at k = 10, 256 and
   8192, each split into the selection kernels and the merge, with
   ``torch.topk`` as a values-only yardstick; qgemm also at the coarse
   re-rank's shape); ``exact_search`` over every storage type the
   contracts give (Q8.8, Q2.13, Q16.16 with and without unit norm,
   Q32.32, d = 8200) equals the CPU's, and at k > capacity (1030 / 1040,
   2100 / 3000) it returns the CPU default route's shape and values;
   qgemm, qcoarse and qtopk (k = 10 and 256) are also checked and timed at
   one shard's shape (phase 6's: 32768 rows); qhnsw_insert links one run
   of 512 stored rows into 1536 linked ones (1 % deleted) at d = 2304 over
   the 131072-row arena, in its fast and default variants, and re-links
   the result in both, and qhnsw_search answers 64 queries (k = 10, ef =
   64) on it, flat and over 4 shards of the same rows in one launch, each
   equal to the plain version (the host-driven beams) bit for bit and
   timed beside it, with a bound from the rows the beams need and a chain
   bound (the plain version's dependent distance steps times one memory
   round trip, measured), the cluster size of each op, us per insert and
   per step; then one insert run and one search at d = 333, which no
   cluster size divides, equal to the plain versions. The build
   step prints ptxas
   registers and spills per
   kernel and the integer tensor-core (IMMA/IGMMA) and IDP4A instruction
   counts of each library (``cuobjdump -sass``);
3. engine — the flat engine at full width (d = 2304, gemma2-2b's d_model;
   131072-row arena; Q16.16; ef_coarse = 256): ingest seeded float32
   embeddings in batches of 512 (1536 documents by default; after the
   third batch, the ``memory_hash`` and the exact route's
   ``retrieval_hash`` of one query batch are recorded for phase 6, their
   launches counted apart), delete 1 % and re-link, retrieve batches
   of 64 queries (k = 10) on the forced exact route (qgemm + qtopk; one
   cold batch timed apart, then 50), the forced HNSW route (ef = 64; one
   cold, then 10) and the forced coarse route (qcoarse scan + qtopk at
   k = 256 + qgemm re-rank; one cold batch that builds the code table,
   then 50); then the coarse route at full coverage (ef_coarse >= live
   rows) must equal the exact route's ``retrieval_hash``, and one more
   insert batch refreshes the table before a last coarse read. Launch
   counts are zeroed just before and read just after. One warm exact and
   one warm coarse batch are then broken into stages with CUDA events
   (the exact one also with its boundary: the copy to the card and
   ``admit_query``). Then the refreshed
   table equals ``codes.build`` of the state and ``replay_log_fresh() ==
   state_hash()`` (its coarse route against the CPU's on a copy of the
   state is cut to keep the run inside its time, as are phase 6's); one
   HNSW batch on the card equals the plain version on a CPU copy of the
   state it read, and one exact-route batch (``plan_query`` /
   ``execute_plan``) on the card the CPU's on that same copy; at the
   default documents and seed, ``state_hash`` and ``memory_hash`` (and
   phase 6's reference record) must equal the values the host-driven
   graph gave (``PINNED``), as must phase 5's crashed engine, phase 6's
   memory and first HNSW reads and phase 7's wire HNSW read. Each phase
   that builds or reads the graph fails unless
   qhnsw_insert / qhnsw_search launched on its path;
4. golden — the hashes the JAX reference wrote at d = 2304
   (``tests/fixtures/torch_port_golden.json``, code table and coarse
   routes included) reproduce on the card; the reference's golden v1 and
   v2 snapshots restore onto the card with their recorded hash; the
   engine's full-width state survives a v1 round trip in memory and a v2
   round trip through a chunk store (1 MiB chunks, temporary directory),
   and its code table a VLRQ round trip, with unchanged hashes;
5. durable — the engine at the same width with ``durable_dir`` in a
   temporary directory and ``checkpoint_every = 1024``: 2 batches of 512
   ingested (the first also into an in-memory engine, whose hash it must
   equal), 1 % deleted, ``checkpoint()``, one more batch; its state hash
   and the exact and coarse ``retrieval_hash`` of 64 queries are recorded
   and a fresh engine's ``recover()`` over the directory must give all
   three, with ``replay_log_fresh() == state_hash()``; a durable engine
   over an 8192-row arena (``SIDE_CAPACITY``, d = 2304: a full-arena
   restore is a 30-60 s chunk loop on the host) ingests a batch,
   ``checkpoint()``s and ingests one more; its last WAL segment then loses
   5 bytes, and recover on the card must land on the last whole record
   with the hash of that prefix applied in memory, ``rollback_to`` the
   checkpoint must give the checkpoint's hash, and the CPU's recovery of
   the same directory (its own reader over the torn WAL, the surviving
   tail applied on the CPU to that one restore of the checkpoint) must
   equal the card's; a group-commit engine (nothing durable before
   the read barrier) and a compaction engine on a delete-heavy log must
   reach the in-memory engine's hash (both at d = 2304 over an 8192-row
   arena, ``SIDE_CAPACITY``); the JAX-written interop store
   (``tests/fixtures/torch_port_durable/``) recovers on the card with its
   recorded ``(t, hash)`` and every ``restore_at`` hash. Prints each
   stage's time, durable ingest docs/s beside in-memory, the checkpoints'
   chunk counts, WAL bytes per document and the durable path's kernel
   launches (zeroed before the durable engine is built, read after the
   recovered engine's reads and replay);
6. sharded — ``ServeConfig(shards=4)`` at the same width over the same
   131072-row arena (4 x 32768): phase 3's first 1536 documents, whose
   ``memory_hash`` and exact ``retrieval_hash`` must equal phase 3's
   record; 1 % deleted and a re-link; the exact route (one cold batch,
   then 20), HNSW (ef = 64; one cold, then 3) and coarse (ef_coarse = 256;
   one cold that builds the 4 code tables, then 20), with launch counts
   zeroed before the ingest and read after the reads; coverage == exact,
   ``distributed_search`` over ``[cuda:0] * 4`` == the exact route, a
   per-stage CUDA-event breakdown of one warm exact and one warm coarse
   batch and ``replay_log_fresh() == state_hash()`` (the routes against
   the CPU's on a copy of the state are cut for time; the card is held to
   the CPU by phase 2's ``exact_search`` on every storage type and phase
   5's recovery); then a ``ShardedDurableStore``
   at full arena (1 MiB chunks): crash → recover to the pre-crash merged
   hash, a crash between per-shard flushes reconciled to the last whole
   cursor, ``rollback_to`` the checkpoint; the durable sharded engine
   (``SIDE_CAPACITY`` rows, group commit, checkpoints) recovers its state
   and retrieval hashes and its replay; the JAX-written sharded fixtures
   (``tests/fixtures/torch_port_sharded/``: store, VLRS manifest, the
   golden recipe on 4 shards) reproduce on the card;
7. network — the 30 golden wire frames (``tests/fixtures/golden_wire/``)
   decode with the port's protocol and re-encode to the same bytes; then
   ``SHARDS`` shard hosts (``net.ShardHost`` on the card behind
   ``net.ShardServer`` on 127.0.0.1 ephemeral ports, in this process so
   their launches count, ``SHARD_ROWS`` rows each) serve
   ``ServeConfig(hosts=[...], replicas=1, follow=FollowerPolicy())``:
   phase 3's first 1536 documents, whose ``memory_hash`` and exact
   ``retrieval_hash`` must equal phase 3's record; phase 6's 1 % deleted
   (no re-link: the hosts keep the replay graph); over the wire (the pool
   detached) the exact and coarse reads of phase 6's first query batch
   must equal phase 6's, HNSW phase 6's read before its re-link, and
   coverage the exact read; ``sync_replicas()`` must return 0 (the
   commands the followers had left, per second) and replica-served reads
   equal the wire reads; launch counts are zeroed before the ingest and
   read after the replica reads; transport retries and the faults the
   replicas rode through are logged and counted; a checkpoint over the
   wire must write the merged record of the engine's state hash.
   Then a ``python -m repro_torch.net.server`` process on the card
   (``SIDE_CAPACITY`` rows) with two durable replicas at staggered
   cursors is SIGKILLed; one ``FailureDetector.poll()`` (a lease of one
   miss) promotes the replica with the max proven prefix at epoch 1, whose
   ``state_hash`` must equal the replica's proof, the epoch-0 writer must
   be refused (``StaleEpochError``) and the promoted host, behind a new
   server, must answer the exact and coarse reads with the replica's bits;
8. lm — gemma2-2b's CONFIG built on the card (26 layers, d = 2304,
   vocabulary 256000, bf16 compute over f32 parameters, from
   ``torch.Generator("cuda").manual_seed(seed)``) behind
   ``MemoryAugmentedEngine(cfg, params, ServeConfig(capacity=131072,
   ...))``: 512 seeded token documents of 64 tokens ingested in one batch
   (cut from 1024 to keep the run inside its time limit), 64 prompts of 16
   tokens retrieved on the auto route (exact at 512 live rows; one cold
   batch, then 10), 8 prompts x 32 tokens
   generated, augmented, twice (the two must be equal), launch counts
   zeroed before the ingest and read after the generations, and
   ``replay_log_fresh() == state_hash()``; one ingest batch's float
   embeddings, normalized on the CPU, must equal the rows the card logged
   bit for bit; the augmented prompt must hold the top hit's tokens and
   its prefill logits must differ from the bare prompt's; generate's
   prefill and greedy decode, as the engine calls them, timed with CUDA
   events (the timed decode must give generate's tokens); the first
   local/global pair and the head copied to the CPU and run in f32 on 4
   documents against the card in f32 (pooled embeddings, prefill logits
   and teacher-forced decode steps, with and without a ring-buffer wrap,
   held to ``LM_F32_REL_TOL``), with the count of Q16.16 words in which
   the card's bf16 pair embeddings differ from the CPU's f32 ones after
   the boundary printed, not held; then the durable LM engine
   (``SIDE_CAPACITY`` rows, checkpoint every 512): 768 documents, a crash
   (no ``close``), ``recover()`` to the same ``(t, hash)`` with the doc
   cache reloaded from ``docs.sdt``, the same generated tokens, and
   ``rollback_to`` the checkpoint with every live id's tokens cached;
9. families — granite-moe-3b-a800m, mamba2-130m and zamba2-2.7b at their
   CONFIG's full width and depth (bf16 over f32 parameters, from the
   seed on the card), one after another, each behind
   ``MemoryAugmentedEngine(cfg, params, ServeConfig(capacity=8192, ...))``:
   256 token documents of 64 tokens in one batch (cut from 512 for the
   run's time limit), 6 batches of 64 prompts on the auto route (exact), 8 x 32 augmented tokens twice (equal), launch
   counts zeroed before the ingest and read after the generations,
   ``replay_log_fresh() == state_hash()``, the boundary identity of phase
   8, the ingest batch's pooled embeddings computed again and equal bit for
   bit (no atomics in the MoE dispatch), generate's prefill and decode
   timed; ``torch.backends.cuda.matmul.allow_tf32`` must be off. Then
   phi3.5-moe at full width with 2 of its 32 layers (its f32 parameters
   do not fit one card), prefill and greedy decode twice, equal. Each
   model's depth-cut copy (the first MoE layer, the first 2 mamba layers,
   or zamba2's first group: a shared block and 6 mamba layers) runs in f32
   on the card and on the CPU: pooled embeddings, prefill logits and
   teacher-forced decode steps, the ssm and hybrid copies also over 300
   tokens (more than one 256-token SSD chunk), held to ``LM_F32_REL_TOL``
   on the documents whose expert choices agree (the count of differing
   (token, rank) choices is printed). Phase 2 holds the kernels at phase
   9's shapes (d = 768, 1536, 2560; 8192 rows);
10. train — (a) gemma2-2b's CONFIG (26 layers, d = 2304, vocabulary
   256000, bf16 compute over f32 masters, ``remat="block"``) from the seed
   on the card: 4 steps of ``make_train_step`` (AdamW) on
   ``DeterministicPipeline`` batches of 4 x 256 tokens, then a fresh init
   from the same seed and the same 4 steps: the losses, gradient norms and
   the ``hash_state_device`` of the parameters in the reference's layout
   must be equal bit for bit; step times, tokens/s and the peak memory
   printed; (b) the same CONFIG cut to 2 layers in f32, one batch of 64
   tokens on the card and on the CPU: loss within 1e-5, gradient norm
   within 1e-4, each gradient leaf within 1e-4 (relative Frobenius); the
   card's step runs under ``torch.use_deterministic_algorithms(True,
   warn_only=True)``, switched off after it, and the ops it flags are
   printed;
   (c) mamba2-130m's CONFIG through ``launch.train.make_coordinator`` (the
   launcher's path: batches of 8 x 256, 8 steps, a checkpoint every 4 in a
   temporary directory), once clean and once with a failure injected at
   step 6 that resumes from step 4: the clean run's events are its two
   checkpoints alone and the other's add that one failure and one restart
   (a fault on the card that the Coordinator caught and replayed would
   fail here); equal ``hash_pytree`` of the final train states,
   checkpoint save and restore seconds printed; each run's
   weights then serve 256 token documents and one batch of 64 prompts
   behind the token engine (``SIDE_CAPACITY`` rows), with equal
   ``memory_hash`` and ``retrieval_hash`` (qboundary, qgemm, qtopk; launch
   counts zeroed before the first engine and read after the second);
   (d) mamba2-130m's ``make_compressed_train_step`` over 4 pods on
   ``[cuda] * 4`` (global batch 8 x 256), 2 steps with error feedback,
   twice: every pod of both runs on the same parameter bits, and the first
   step's ``integer_psum_grads`` on the card equal to the CPU's on the same
   per-pod gradients bit for bit; before it, one step of mamba2-130m cut
   to 2 layers under the deterministic mode lists the ops it flags;
11. external embeddings — qwen2-vl-7b and musicgen-large at full width and
   depth (bf16 compute over f32 masters, from the seed on the card, their
   parameter counts checked): prefill on seeded embeddings [8, 48]
   (qwen2-vl with non-text M-RoPE ``positions_3d``) and 32 greedy tokens,
   each decode step fed the embedding row of the token it chose, twice:
   equal logits and tokens bit for bit; prefill and decode ms (CUDA
   events) and the peak memory; each model's first 2 layers with its
   head in f32 on the card and, copied to the host, on the CPU: ``apply``,
   prefill and 4 decode steps within 1e-4 relative;
12. multi-device — over (data 2, model 2) on ``[cuda] * 4``: (a)
   granite-moe-3b-a800m's CONFIG in f32 placed by the sharding rules
   (``models.placement``), ``make_prefill_step`` [8, 48] and 4 greedy
   ``make_decode_step`` steps, the MoE expert-parallel (48 padded experts
   / 2), twice and equal bit for bit, against the same weights unplaced on
   each data shard's prompts (the expert-parallel capacity is per data
   shard, as the reference's): logits within 1e-4 relative, the same
   tokens; (b) its first 4 layers, 2 placed ``make_train_step`` steps of 8
   x 128 at lr 1e-5 against the same steps unplaced: first loss within
   1e-5, each gradient leaf within 1e-4 and the parameters after step 2
   within 1e-5 (relative Frobenius over all of them; the worst leaf is
   printed), with ``remat="block"`` recomputing every rank's blocks: the
   first step's loss and gradients, and the two steps' losses and
   parameters, equal to the same steps without remat bit for bit, the
   peak memory of a step printed both ways; (c) phi3.5-moe's 2 MoE layers
   at full width in f32 on (data 1, model 4): expert-parallel == the
   one-device path bit for bit on 8 x 64 tokens (top-2); over (data 1,
   model 8) on ``[cuda] * 8``, full width in f32 cut to 2 layers: (d)
   gemma2-2b, whose 8 query heads split over ``model`` and 4 key/value
   heads do not (the ``q_heads`` layout: K/V replicated), and (e)
   qwen2-vl-7b, whose 28 heads do not split 8 ways (the ``sequence``
   layout: each rank attends 6 of the 48 query rows), on seeded embeddings
   with non-text M-RoPE positions: prefill [8, 48] and 4 greedy steps
   (qwen2-vl fed its tokens' embedding rows), twice and equal bit for bit,
   against the same weights unplaced: logits within 1e-5 relative, the
   same tokens;
13. roofline — the op walk (``roofline.op_walk``) on ``meta`` tensors over
   phase 10(a)'s step, phase 8's decode step and one rank's program of
   phase 12(a)'s placed prefill, each beside the time its phase measured
   and the share that time is of its bound (the H100 SXM data sheet's
   constants, ``roofline.analysis``); then ``launch.dryrun``'s gemma2-2b x
   train_4k cell on the single production mesh, its operations per device
   beside their count when every model rank computed every head (4.936e14,
   before the reference's attention layouts were ported). Phases 11-13
   launch none
   of the kernels; their counts are read and printed.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Needs the repository's ``src/``
beside it and a CUDA device; it does not fall back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT8_TC_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor-core rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# The main path's shapes: gemma2-2b's d_model, a 131072-row Q16.16 arena,
# ingest batches of 512, retrieve batches of 64 queries, k = 10, ef = 64,
# ef_coarse = 256 (ef_coarse >= EF_COVER covers the live rows).
DIM = 2304
CAPACITY = 131072
BATCH = 512
QUERIES = 64
K = 10
EF = 64
EF_COARSE = 256
EF_COVER = 8192
EF_CONSTRUCTION = 32  # the engine's inserts (machine's default)
# the values the host-driven graph (the qhnsw plain version) gave at the
# default documents and seed 0; the kernels must land on them
PINNED = {"state_hash": 0x283af3b3ad85ec3f, "memory_hash": 0x7bb94cd8a645b90f,
          "shard_memory": 0xb65355a8a26e7781,
          "sharded_hnsw": 0x27ba45fe03b2ab28,
          "replay_hnsw": 0x84d8077e1811c69e,
          "durable": (1546, 0x54e14c1a3a5ed183)}
QHNSW_ROWS = 1536     # phase 2's hold: rows linked before its insert run
QHNSW_SMALL_DIM = 333  # and its small width, which no cluster size divides
EXACT_BATCHES = 50
HNSW_BATCHES = 10
COARSE_BATCHES = 50
CHUNK_SIZE = 1 << 20  # v2 snapshot chunks at full width
DURABLE_BATCHES = 2  # phase 5 ingests 2 batches, deletes 1 %, checkpoints,
CHECKPOINT_EVERY = 1024  # then one more batch (cut from 3 for the time limit)
# phase 5's group-commit and compaction engines: d = 2304 over a smaller
# arena (each full-size genesis snapshot or restore costs 20-35 s of 8 KB
# chunks on the host)
SIDE_CAPACITY = 8192
# phase 6: the sharded engine at phase 3's width over the same total arena,
# split as SHARDS x SHARD_ROWS; it ingests phase 3's first SHARD_DOCS
# documents
SHARDS = 4
SHARD_ROWS = CAPACITY // SHARDS
SHARD_DOCS = 1536  # cut from 2048 to keep the run inside its time limit
SHARD_EXACT_BATCHES = 20
SHARD_HNSW_BATCHES = 3
SHARD_COARSE_BATCHES = 20
SHARD_CHECKPOINT_EVERY = 256  # per-shard cursor: about two batches of 512
# phase 7: the networked engine reads NET_BATCHES warm batches per route
# over the wire and from its replicas; the failover ingests batches of
# FAIL_BATCH documents into a SIDE_CAPACITY-row shard-server process
NET_BATCHES = {"exact": 10, "hnsw": 2, "coarse": 10}
FAIL_BATCH = 128
CARD = ["card not read"]  # nvidia-smi's name and power limit, for reports
# phase 8: the LM serving path at gemma2-2b's full width (26 layers, d =
# 2304, vocabulary 256000, bf16 compute over f32 parameters): LM_DOCS
# documents of LM_DOC_LEN tokens in batches of BATCH, LM_QUERY_BATCHES
# warm batches of QUERIES prompts of LM_PROMPT_LEN tokens after one cold
# one, GEN_PROMPTS prompts generating GEN_NEW tokens (twice); then a
# durable engine over SIDE_CAPACITY rows ingests LM_DURABLE_DOCS in
# batches of LM_DURABLE_BATCH with a checkpoint every LM_CHECKPOINT_EVERY
LM_ARCH = "gemma2-2b"
LM_DOCS = 512  # cut from 1024 to keep the run inside its time limit
LM_DOC_LEN = 64
LM_PROMPT_LEN = 16
LM_QUERY_BATCHES = 10
LM_CONTEXT = 32
GEN_PROMPTS = 8
GEN_NEW = 32
LM_S_CACHE = 128
LM_DURABLE_DOCS = 768
LM_DURABLE_BATCH = 256
LM_CHECKPOINT_EVERY = 512
LM_NUMERICS_DOCS = 4
LM_NUMERICS_STEPS = 4  # teacher-forced decode steps after the prefill
# the first local/global pair and the head in f32, the card against the
# CPU: the largest |difference| over the largest |CPU value|, for the
# pooled embeddings and for the logits of the prefill and of each decode
# step
LM_F32_REL_TOL = 1e-4
# phase 9: the moe, ssm and hybrid LMs at full width and depth (bf16 compute
# over f32 parameters), each behind the token engine over SIDE_CAPACITY
# rows: FAMILY_DOCS documents of LM_DOC_LEN tokens in one batch, one cold
# and FAMILY_QUERY_BATCHES warm batches of QUERIES prompts, GEN_PROMPTS x
# GEN_NEW tokens twice; then phi3.5-moe at full width with its depth cut
# to PHI_LAYERS of 32 layers (its 168 GB of f32 parameters do not fit one
# card), at the model level. The f32 cross-checks of the ssm and hybrid
# copies also run SSM_LONG tokens: more than one 256-token SSD chunk and
# not a multiple of it
FAMILY_ARCHS = ("granite-moe-3b-a800m", "mamba2-130m", "zamba2-2.7b")
FAMILY_DOCS = 256  # cut from 512 to keep the run inside its time limit
FAMILY_QUERY_BATCHES = 5
PHI_ARCH = "phi3.5-moe-42b-a6.6b"
PHI_LAYERS = 2
SSM_LONG = 300
LM_WIDTHS = (768, 1536, 2560)  # d_model of mamba2, granite-moe, zamba2

# phase 10: training. (a) TRAIN_ARCH's CONFIG (bf16 compute over f32
# masters, remat="block") takes TRAIN_STEPS AdamW steps on pipeline batches
# of TRAIN_BATCH x TRAIN_SEQ tokens, twice from the seed; (b) its depth cut
# to TRAIN_CUT_LAYERS layers in f32 takes one step's gradients on the card
# and on the CPU (batch 1, TRAIN_CUT_SEQ tokens), held to the TRAIN_*_REL
# tolerances; (c) COORD_ARCH trains through the launcher's Coordinator
# (COORD_BATCH x COORD_SEQ, COORD_STEPS steps, a checkpoint every
# COORD_EVERY), once clean and once failing at step COORD_FAIL_AT, and each
# run's weights serve COORD_DOCS documents and one batch of QUERIES prompts
# behind the token engine; (d) COORD_ARCH's compressed step over PODS pods
# on the card, POD_STEPS steps, twice
TRAIN_ARCH = "gemma2-2b"
TRAIN_STEPS = 4
TRAIN_BATCH = 4
TRAIN_SEQ = 256
TRAIN_LR = 3e-4
TRAIN_CUT_LAYERS = 2
TRAIN_CUT_SEQ = 64
TRAIN_LOSS_REL = 1e-5
TRAIN_GNORM_REL = 1e-4
TRAIN_GRAD_REL = 1e-4  # each gradient leaf, relative Frobenius error
COORD_ARCH = "mamba2-130m"
COORD_BATCH = 8
COORD_SEQ = 256
COORD_STEPS = 8
COORD_EVERY = 4
COORD_FAIL_AT = 6
COORD_LR = 3e-3  # launch/train.py's default
COORD_DOCS = FAMILY_DOCS  # phase 2 holds the kernels at phase 9's shapes
PODS = 4
POD_STEPS = 2
# phase 11: the vlm and audio backbones on external embeddings at full width
# and depth (bf16 compute over f32 masters): EXT_BATCH x EXT_LEN seeded
# embeddings (qwen2-vl with non-text M-RoPE positions), prefill and EXT_NEW
# greedy decode steps fed the embedding rows of their own tokens, twice;
# then EXT_CUT_LAYERS layers in f32 on the card and on the CPU
EXT_ARCHS = ("qwen2-vl-7b", "musicgen-large")
EXT_PARAMS = {"qwen2-vl-7b": 7_615_616_512, "musicgen-large": 2_424_506_368}
EXT_BATCH = 8
EXT_LEN = 48
EXT_NEW = 32
EXT_S_CACHE = 128
EXT_CUT_LAYERS = 2
EXT_CUT_BATCH = 2
EXT_F32_REL = 1e-4
# phase 12: multi-device execution over MESH_SHAPE on [cuda] * 4:
# (a) MD_ARCH's CONFIG in f32, placed, prefill [MD_BATCH, MD_LEN] and MD_NEW
# greedy steps; (b) its first MD_TRAIN_LAYERS layers, MD_TRAIN_STEPS steps of
# MD_TRAIN_BATCH x MD_TRAIN_SEQ at MD_LR; (c) phi3.5-moe's PHI_LAYERS MoE
# layers at full width on (data 1, model 4): expert-parallel == dense
MESH_SHAPE = (2, 2)
MD_ARCH = "granite-moe-3b-a800m"
MD_BATCH = 8
MD_LEN = 48
MD_NEW = 4  # cut from 8 to keep the run inside its time limit
MD_S_CACHE = 64
MD_LOGITS_REL = 1e-4
MD_TRAIN_LAYERS = 4
MD_TRAIN_STEPS = 2
MD_TRAIN_BATCH = 8
MD_TRAIN_SEQ = 128
MD_LR = 1e-5
MD_LOSS_REL = 1e-5
MD_GRAD_REL = 1e-4
MD_PARAM_REL = 1e-5
EP_TOKENS = (8, 64)
# (d), (e): each arch's CONFIG in f32 cut to MD_LAYOUT_LAYERS layers over
# MD_LAYOUT_SHAPE, with the attention layout it must take there
MD_LAYOUTS = {"gemma2-2b": "q_heads", "qwen2-vl-7b": "sequence"}
MD_LAYOUT_SHAPE = (1, 8)
MD_LAYOUT_LAYERS = 2
MD_LAYOUT_REL = 1e-5
# phase 13: the op walk of three measured steps, and one dry-run cell
DRY_SHAPE = "train_4k"
HAND_OPS_TRAIN = 2.1e13  # PERF.md §2's estimate of phase 10(a)'s step
# the dry-run cell's operations per device when every model rank computed
# every head, before the reference's attention layouts were ported
DRY_OPS_BEFORE = 4.936e14

REPLACES = {
    "qboundary": "src/repro/kernels/qboundary/kernel.py:29",
    "qgemm": "src/repro/kernels/qgemm/kernel.py:39",
    "qtopk": "src/repro/kernels/qtopk/kernel.py:30",
    "qcoarse": "src/repro/kernels/qcoarse/kernel.py:41",
    # no Pallas kernel: the reference's jnp under jit
    "qhnsw_search": "none (jnp under jit): src/repro/core/hnsw.py:711 "
                    "hnsw_search, vmapped at src/repro/core/query.py:52",
    "qhnsw_insert": "none (jnp under jit): src/repro/core/hnsw.py:421 "
                    "hnsw_insert, scanned at src/repro/core/machine.py:246 "
                    "and src/repro/core/hnsw.py:656",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in ("qboundary", "qgemm", "qtopk", "qcoarse")}
SOURCES.update(qhnsw_search="src/repro_torch/kernels/csrc/qhnsw.cu",
               qhnsw_insert="src/repro_torch/kernels/csrc/qhnsw.cu")
GRAPH_KERNELS = ("qhnsw_search", "qhnsw_insert")
LM_KERNELS = ("qboundary", "qgemm", "qtopk")  # phase 8's path (exact route)
LM_PATH = LM_KERNELS + ("qhnsw_insert",)  # the LM engines ingest: F's graph


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, got, want, acc: dict) -> None:
    """Fold |got - want| of integer tensors (or tuples of them) into
    ``acc``: the largest difference and the count of differing values."""
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            compare(torch, g, w, acc)
        return
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    diff = (got.cpu().to(torch.int64) - want.cpu().to(torch.int64)).abs()
    if diff.numel():
        acc["max_abs_err"] = max(acc["max_abs_err"], int(diff.max()))
        acc["mismatches"] += int((diff != 0).sum())


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pin(name: str, got, held: bool) -> None:
    """Hold a hash to its pinned value where ``held``: at the default
    documents and seed, which made it, and the module's shapes."""
    held = held and (DIM, CAPACITY, BATCH, SHARDS) == (2304, 131072, 512, 4)
    if held and got != PINNED[name]:
        raise AssertionError(f"{name}: {got!r} != the pinned {PINNED[name]!r}")
    return held


def phase_counts(kernels) -> dict:
    """Every kernel's launches since the last reset: the four TPU kernels'
    and qhnsw's two (the graph's search and insert)."""
    return {**kernels.launch_counts(), **kernels.graph_launch_counts()}


def require(counts: dict, names, what: str) -> None:
    """Fail unless each named kernel launched on a phase's path."""
    missing = [name for name in names if counts.get(name, 0) < 1]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched: {counts}")


# --------------------------------------------------------------------------- #
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------- #


def graph_ms(torch, launch, iters: int) -> float:
    """Per-launch time of ``iters`` launches captured in one CUDA graph and
    replayed: the kernel with no Python between its launches."""
    launch()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):  # launches go to the capture stream
        for _ in range(iters):
            launch()
    return cuda_ms(torch, g.replay, 5) / iters


def qboundary_rows(rng, n: int, d: int) -> np.ndarray:
    """Seeded float32 rows with the boundary's hard cases in the first
    rows: NaN, a zero row, a tiny row (1e-7), a saturating row whose int64
    sum of squares wraps negative (norm 0: the row passes through), and a
    row whose four -2^31 squares wrap to 0 so the small rest sets a tiny
    norm (quotients beyond the range, clamped)."""
    x = (rng.normal(size=(n, d)) * 2).astype(np.float32)
    if n >= 4:
        x[1] = 0.0
        x[2] *= 1e-7
        x[3, ::2], x[3, 1::2] = 40000.0, -40000.0
    if n >= 5 and d >= 5:
        x[4, :4] = -40000.0
        x[4, 4:] *= 1e-3
    x[0, 0] = np.nan
    return x


def check_qboundary(torch, dev, rng):
    """Every case bitwise against the plain version (unit norm on and
    off), with the path each took; then the whole call and the kernel
    alone (a CUDA graph of launches) at both of the main path's shapes:
    ingest batches [512, 2304] and query batches [64, 2304]."""
    from repro_torch.core.contracts import Q16_16
    from repro_torch.kernels.qboundary import kernel, ops, ref
    acc = dict(max_abs_err=0, mismatches=0)
    cases = {}

    def run(name, xt):
        case = dict(max_abs_err=0, mismatches=0, path=kernel.path(xt))
        for unit_norm in (True, False):
            compare(torch, ops.qboundary(xt, Q16_16, unit_norm=unit_norm),
                    ref.qboundary_ref(xt, Q16_16, unit_norm), case)
        cases[name] = case
        acc["max_abs_err"] = max(acc["max_abs_err"], case["max_abs_err"])
        acc["mismatches"] += case["mismatches"]

    for n, d in [(1, 8), (4, 16), (257, 768), (100, 64), (3, 8192),
                 (QUERIES, DIM), (BATCH, DIM), (GEN_PROMPTS, DIM),
                 (LM_DURABLE_BATCH, DIM), (6, 1), (6, 3), (6, 77),
                 (5, 2303), (5, 4097), (3, 40000), (2, 40003)]:
        run(f"[{n}, {d}]", torch.from_numpy(qboundary_rows(rng, n, d)).to(dev))
    # one float past 16-byte alignment: a contiguous view at offset 1
    for n, d in [(6, 768), (QUERIES, DIM)]:
        buf = torch.from_numpy(np.concatenate(
            [[0.0], qboundary_rows(rng, n, d).ravel()]).astype(np.float32))
        run(f"[{n}, {d}] at a one-float offset",
            buf.to(dev)[1:].view(n, d))

    timing = {}
    for n in (QUERIES, BATCH):  # query batches, then ingest batches
        xt = torch.from_numpy(rng.normal(size=(n, DIM)).astype(np.float32)
                              ).to(dev)
        out = torch.empty(xt.shape, dtype=torch.int32, device=dev)
        timing[n] = dict(
            call=cuda_ms(torch, lambda: ops.qboundary(xt, Q16_16), 50),
            kernel=graph_ms(torch, lambda: kernel.launch(xt, out, Q16_16, True),
                            50),
            bound=bound_ms(n * DIM * 8, n * DIM * 4, F32_OPS_PER_S)[0],
            path=kernel.path(xt))
    plain = cuda_ms(torch, lambda: ref.qboundary_ref(xt, Q16_16), 5)
    b, by = bound_ms(BATCH * DIM * 8, BATCH * DIM * 4, F32_OPS_PER_S)
    q = timing[QUERIES]
    return dict(acc, ms=timing[BATCH]["call"], plain_ms=plain, library_ms=None,
                bound_ms=b, bound_by=by, kernel_ms=timing[BATCH]["kernel"],
                ms_at_queries=q["call"], kernel_ms_at_queries=q["kernel"],
                bound_ms_at_queries=q["bound"],
                shape=f"[{BATCH}, {DIM}] f32 -> i32", cases=cases,
                timing=timing)


def report_qboundary(r) -> None:
    """qboundary's cases with their paths, and at each shape the whole
    call, the kernel alone and the host's share (call - kernel)."""
    for name, case in r["cases"].items():
        log(f"[kernel] qboundary {name}: {case['path']}, max_abs_err "
            f"{case['max_abs_err']}, mismatches {case['mismatches']}")
    for n, tm in r["timing"].items():
        log(f"[kernel] qboundary [{n}, {DIM}] ({tm['path']}): call "
            f"{tm['call']:.4f} ms, kernel alone {tm['kernel']:.4f} ms, host "
            f"share {tm['call'] - tm['kernel']:.4f} ms (bound "
            f"{tm['bound']:.5f} ms)")


def check_qboundary_contracts(torch, dev, rng) -> dict:
    """Contracts beyond the kernel's reciprocal-division bound (int_bits +
    2 * frac_bits > 51: Q4.27, Q1.30) go through the kernel on the card
    (the wide instance, an exact 64-bit divide per element, with unit
    norm), one launch per call, and equal the CPU's ``normalize_embedding``
    bit for bit. Returns {case: "kernel, <path>"} and the wide instance's
    kernel time at the ingest shape beside Q16.16's."""
    from repro_torch import kernels
    from repro_torch.core import boundary
    from repro_torch.core.contracts import PrecisionContract, Q16_16
    from repro_torch.kernels.qboundary import kernel
    routes = {}
    for name, ib, fb in (("Q4.27", 4, 27), ("Q1.30", 1, 30)):
        c = PrecisionContract(name, int_bits=ib, frac_bits=fb)
        if not kernel.params(c, True)[0].wide:
            raise AssertionError(f"{name} does not take the exact divide")
        for n, d in ((QUERIES, DIM), (BATCH, DIM), (6, 77), (3, 40000)):
            x = qboundary_rows(rng, n, d)
            xt = torch.from_numpy(x).to(dev)
            for unit_norm in (True, False):
                before = kernels.launch_counts()["qboundary"]
                got = boundary.normalize_embedding(xt, c, unit_norm)
                launches = kernels.launch_counts()["qboundary"] - before
                if launches != 1:
                    raise AssertionError(
                        f"normalize_embedding {name} unit_norm={unit_norm}: "
                        f"{launches} kernel launches, want 1")
                want = boundary.normalize_embedding(torch.from_numpy(x), c,
                                                    unit_norm)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(
                        f"normalize_embedding {name} [{n}, {d}] unit_norm="
                        f"{unit_norm}: card and CPU differ")
                step = "exact divide" if unit_norm else "encode only"
                routes[f"{name} [{n}, {d}] unit_norm={unit_norm}"] = (
                    f"kernel ({step}), {kernel.path(xt)}")
    xt = torch.from_numpy(rng.normal(size=(BATCH, DIM)).astype(np.float32)
                          ).to(dev)
    out = torch.empty(xt.shape, dtype=torch.int32, device=dev)
    wide = PrecisionContract("Q4.27", int_bits=4, frac_bits=27)
    timing = {f"{c.name} [{BATCH}, {DIM}]": graph_ms(
        torch, lambda c=c: kernel.launch(xt, out, c, True), 50)
        for c in (Q16_16, wide)}
    return routes, timing


def check_qgemm(torch, dev, rng):
    from repro_torch.kernels.qgemm import kernel, ops, ref
    acc = dict(max_abs_err=0, mismatches=0)
    paths = {}

    def run(name, q, db, exact_f64=True):
        """Kernel vs the float64 plain version where that is exact
        (|raw| <= 2^16), else vs the CPU's int64 product."""
        paths[name] = kernel.path(q, db)
        got = ops.qgemm(q, db)
        want = (ref.qgemm_ref(q, db) if exact_f64
                else ref.qgemm_ref(q.cpu(), db.cpu()))
        compare(torch, got, want, acc)
        return got

    def ints(lo, hi, shape, dtype=np.int32):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                                .astype(dtype)).to(dev)

    for nq, m, dd in [(1, 1, 8), (4, 16, 32), (7, 100, 384), (130, 257, 640),
                      (16, 1000, 768), (3, 33, 8192), (64, 4099, 2304),
                      (5, 77, 7), (3, 9, 101)]:
        run(f"int32 [{nq}, {dd}] x [{m}, {dd}]",
            ints(-65536, 65537, (nq, dd)), ints(-65536, 65537, (m, dd)))
    ext = torch.full((2, 8192), 65536, dtype=torch.int32, device=dev)
    ext[1] = -65536
    if int(run("int32 +-2^16, d=8192", ext, ext)[0, 0]) != 8192 * 65536 * 65536:
        raise AssertionError("qgemm extreme value wrong")
    # values beyond +-2^23 in some (tile, stage) pairs and not others: both
    # sides of the per-stage limb switch in one launch
    q, db = ints(-65536, 65537, (70, 300)), ints(-65536, 65537, (200, 300))
    q[3, 70], q[66, 299] = 2**31 - 1, -2**31      # query tiles 0 and 1
    db[130, 150], db[7, 5] = -2**31, 2**23       # row tiles 2 and 0
    db[199, 0] = -(2**23) - 1
    run("int32 +-2^23 mixed", q, db, exact_f64=False)
    run("int32 full range", ints(-2**31, 2**31, (64, 768)),
        ints(-2**31, 2**31, (1000, 768)), exact_f64=False)
    for v in (2**31 - 1, -2**31, 2**23 - 1, -2**23, 2**23, 0x00FFFFFF):
        e = torch.full((2, 8192), v, dtype=torch.int32, device=dev)
        e[1] = -v if v != -2**31 else 2**31 - 1
        run(f"int32 extremes {v}, d=8192", e, e, exact_f64=False)
    for nq, m, dd in [(5, 77, 101), (64, 4099, 2304), (3, 33, 8192)]:
        run(f"int16 [{nq}, {dd}] x [{m}, {dd}]",
            ints(-2**15, 2**15, (nq, dd), np.int16),
            ints(-2**15, 2**15, (m, dd), np.int16), exact_f64=False)
    for nq, m, dd in [(5, 77, 101), (64, 300, 2304)]:
        run(f"int64 [{nq}, {dd}] x [{m}, {dd}]",
            ints(-2**63, 2**63 - 1, (nq, dd), np.int64),
            ints(-2**63, 2**63 - 1, (m, dd), np.int64), exact_f64=False)
    # rows whose base is not 16-byte aligned take the plain loads
    buf = ints(-65536, 65537, (34 * 64,))
    for off, dd in ((1, 64), (2, 62)):
        dbv = buf[off:off + 33 * dd].reshape(33, dd)
        run(f"int32 unaligned view +{off}, d={dd}",
            ints(-65536, 65537, (3, dd)), dbv)
    # the coarse route's re-rank: 64 queries x the union of <= 64 x 256
    # candidate rows, gathered (a contiguous copy)
    nq, nn, d = QUERIES, CAPACITY, DIM
    q = ints(-65536, 65537, (nq, d))
    db = torch.randint(-65536, 65537, (nn, d), dtype=torch.int32, device=dev)
    union = db[torch.randperm(nn, device=dev)[:QUERIES * EF_COARSE]]
    run(f"int32 re-rank [{nq}, {d}] x [{union.shape[0]}, {d}]", q, union)
    ms_rerank = cuda_ms(torch, lambda: ops.qgemm(q, union), 20)
    b_rerank, _ = bound_ms((nq + union.shape[0]) * d * 4 + nq * union.shape[0] * 8,
                           2.0 * nq * union.shape[0] * d, INT8_TC_OPS_PER_S)
    # the main path's scan: 64 queries against the whole arena, and against
    # one shard's rows (phase 6)
    run(f"int32 main [{nq}, {d}] x [{nn}, {d}]", q, db)
    # phase 8's generate reads: GEN_PROMPTS prompts against the whole
    # arena, and against the durable LM engine's SIDE_CAPACITY rows
    for rows in (nn, SIDE_CAPACITY):
        run(f"int32 generate [{GEN_PROMPTS}, {d}] x [{rows}, {d}]",
            q[:GEN_PROMPTS], db[:rows])
    ms = cuda_ms(torch, lambda: ops.qgemm(q, db), 10)
    plain = cuda_ms(torch, lambda: ref.qgemm_ref(q, db), 3)
    qf, dbf = q.to(torch.float64), db.to(torch.float64)
    lib = cuda_ms(torch, lambda: torch.matmul(qf, dbf.T), 3)
    del dbf
    shard = per_shard_times(torch, run, q, db[:SHARD_ROWS], ops.qgemm,
                            ref.qgemm_ref, qf, INT8_TC_OPS_PER_S)
    del qf, db, union
    b, by = bound_ms((nq + nn) * d * 4 + nq * nn * 8, 2.0 * nq * nn * d,
                     INT8_TC_OPS_PER_S)
    return dict(acc, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b, bound_by=by, paths=paths,
                ms_rerank=ms_rerank, bound_ms_rerank=b_rerank,
                shape=f"[{nq}, {d}] x [{nn}, {d}] i32 -> i64", **shard)


def per_shard_times(torch, run, q, rows, op, plain_op, q64, ops_rate
                    ) -> dict:
    """A scan kernel (qgemm or qcoarse) at one shard's shape: bitwise
    against its plain version, then its time beside the plain version, the
    float64 ``torch.matmul`` of the same operands and its bound. ``rows``
    is a contiguous slice of the full-arena operand."""
    nq, d = q.shape
    n = rows.shape[0]
    run(f"per shard [{nq}, {d}] x [{n}, {d}]", q, rows)
    rows64 = rows.to(torch.float64)
    b, by = bound_ms(nq * d * 4 + n * d * rows.element_size() + nq * n * 8,
                     2.0 * nq * n * d, ops_rate)
    out = dict(ms_per_shard=cuda_ms(torch, lambda: op(q, rows), 20),
               plain_ms_per_shard=cuda_ms(torch, lambda: plain_op(q, rows), 3),
               library_ms_per_shard=cuda_ms(
                   torch, lambda: torch.matmul(q64, rows64.T), 3),
               bound_ms_per_shard=b, bound_by_per_shard=by,
               shape_per_shard=f"[{nq}, {d}] x [{n}, {d}]")
    del rows64
    return out


def check_qtopk(torch, dev, rng):
    from repro_torch.core.search import INF
    from repro_torch.kernels.qtopk import kernel, ops, ref
    acc = dict(max_abs_err=0, mismatches=0)
    cases = {}

    def run(name, s, keys, kk):
        """ops.qtopk on the card against the reference kernel's blocked
        selection, run by its plain version on the same card."""
        case = dict(max_abs_err=0, mismatches=0)
        compare(torch, ops.qtopk(s, keys, kk),
                ref.qtopk_blocked(s, keys, kk, ops.block_n(s.shape[1])), case)
        cases[name] = case
        acc["max_abs_err"] = max(acc["max_abs_err"], case["max_abs_err"])
        acc["mismatches"] += case["mismatches"]

    def perm(m):
        return torch.from_numpy(rng.permutation(m).astype(np.int32)).to(dev)

    # k > n >= 1024 with n % 1024 != 0: the reference's pad columns
    for nq, m, kk in [(1, 4, 1), (3, 17, 5), (6, 200, 16), (2, 127, 16),
                      (5, 128, 9), (4, 1000, 12), (4, 1030, 10), (4, 5000, 16),
                      (2, 1030, 40), (3, 50, 80), (2, 1030, 1040),
                      (2, 2100, 3000), (2, 9000, 4095), (2, 9000, 4096),
                      (QUERIES, CAPACITY, K), (GEN_PROMPTS, CAPACITY, K),
                      (GEN_PROMPTS, SIDE_CAPACITY, K)]:
        s = torch.from_numpy(rng.integers(-2**45, 2**45, (nq, m))).to(dev)
        s[:, ::5] = 0  # ties
        run(f"random [{nq}, {m}] k={kk}", s, perm(m), kk)
    ties = torch.zeros((1, 64), dtype=torch.int64, device=dev)
    rev = torch.arange(63, -1, -1, dtype=torch.int32, device=dev)
    if ops.qtopk(ties, rev, 5)[1][0].tolist() != [0, 1, 2, 3, 4]:
        raise AssertionError("qtopk all-ties order wrong")
    nq, n = QUERIES, CAPACITY
    keys = perm(n)
    # the main path's shape with data that stresses the digits: all
    # scores equal (the keys decide), every score INF but 100 per row,
    # the extremes, and scores that share their top 40 bits
    run(f"all equal [{nq}, {n}] k={EF_COARSE}",
        torch.zeros((nq, n), dtype=torch.int64, device=dev), keys, EF_COARSE)
    s = torch.full((nq, n), INF, dtype=torch.int64, device=dev)
    live = torch.from_numpy(np.stack([rng.choice(n, 100, replace=False)
                                      for _ in range(nq)])).to(dev)
    s.scatter_(1, live, torch.from_numpy(
        rng.integers(0, 2**40, (nq, 100))).to(dev))
    run(f"INF but 100 per row [{nq}, {n}] k={EF_COARSE}", s, keys, EF_COARSE)
    extremes = np.array([-2**63 + 1, -2**63 + 2, -1, 0, 1, 2**62, 2**63 - 2])
    s = torch.from_numpy(rng.choice(extremes, (nq, n))).to(dev)
    run(f"extremes [{nq}, {n}] k={K}", s, keys, K)
    run(f"extremes [{nq}, {n}] k={EF_COARSE}", s, keys, EF_COARSE)
    s = (torch.from_numpy(rng.integers(0, 2**24, (nq, n))).to(dev)
         + (0x5A5A5A5A5A << 24))
    run(f"top 40 bits shared [{nq}, {n}] k={EF_COARSE}", s, keys, EF_COARSE)
    s = torch.from_numpy(rng.integers(-2**45, 2**45, (nq, n))).to(dev)
    run(f"coverage [{nq}, {n}] k={EF_COVER}", s, keys, EF_COVER)

    # times at k = 10 (exact route), 256 (coarse candidates) and 8192
    # (coverage): the whole call, the selection kernels alone, the merge
    # alone; torch.topk (values only, another tie order) as a yardstick
    timing = {}
    for kk, iters in ((K, 20), (EF_COARSE, 20), (EF_COVER, 5)):
        sel_s, sel_k, ordered = kernel.select(s, keys, kk)
        timing[kk] = dict(
            call=cuda_ms(torch, lambda: ops.qtopk(s, keys, kk), iters),
            kernels=cuda_ms(torch, lambda: kernel.select(s, keys, kk), iters),
            merge=0.0 if ordered else cuda_ms(
                torch, lambda: ref.merge(sel_s, sel_k, min(kk, n)), iters),
            torch_topk=cuda_ms(torch, lambda: torch.topk(
                s, kk, dim=1, largest=False), iters),
            bound=bound_ms(nq * n * 8 + n * 4 + nq * kk * 12, 2.0 * nq * n,
                           INT8_TC_OPS_PER_S)[0])
    # one shard's rows (phase 6): k = 10 (exact) and 256 (coarse)
    ns = SHARD_ROWS
    s_sh, keys_sh = s[:, :ns].contiguous(), perm(ns)
    per_shard = {}
    for kk in (K, EF_COARSE):
        run(f"per shard [{nq}, {ns}] k={kk}", s_sh, keys_sh, kk)
        per_shard[kk] = dict(
            call=cuda_ms(torch, lambda: ops.qtopk(s_sh, keys_sh, kk), 20),
            plain=cuda_ms(torch, lambda: ref.qtopk_blocked(
                s_sh, keys_sh, kk, ops.block_n(ns)), 3),
            bound=bound_ms(nq * ns * 8 + ns * 4 + nq * kk * 12,
                           2.0 * nq * ns, INT8_TC_OPS_PER_S)[0])
    plain = cuda_ms(torch, lambda: ref.qtopk_blocked(s, keys, K,
                                                     ops.block_n(n)), 3)
    plain_ef = cuda_ms(torch, lambda: ref.qtopk_blocked(s, keys, EF_COARSE,
                                                        ops.block_n(n)), 2)
    b, by = bound_ms(nq * n * 8 + n * 4 + nq * K * 12, 2.0 * nq * n,
                     INT8_TC_OPS_PER_S)
    return dict(acc, ms=timing[K]["call"], plain_ms=plain, library_ms=None,
                bound_ms=b, bound_by=by, shape=f"[{nq}, {n}] i64, k={K}",
                ms_at_ef_coarse=timing[EF_COARSE]["call"],
                plain_ms_at_ef_coarse=plain_ef,
                bound_ms_at_ef_coarse=timing[EF_COARSE]["bound"],
                timing=timing, cases=cases,
                ms_per_shard=per_shard[K]["call"],
                plain_ms_per_shard=per_shard[K]["plain"],
                bound_ms_per_shard=per_shard[K]["bound"],
                library_ms_per_shard=None, bound_by_per_shard="bytes",
                ms_per_shard_at_ef_coarse=per_shard[EF_COARSE]["call"],
                plain_ms_per_shard_at_ef_coarse=per_shard[EF_COARSE]["plain"],
                bound_ms_per_shard_at_ef_coarse=per_shard[EF_COARSE]["bound"],
                shape_per_shard=f"[{nq}, {ns}] i64, k={K}")


def report_qtopk(r) -> None:
    """qtopk's cases (each against the blocked plain version) and its
    times by k: whole call = selection kernels + merge (+ pad columns)."""
    for name, case in r["cases"].items():
        log(f"[kernel] qtopk {name}: max_abs_err {case['max_abs_err']}, "
            f"mismatches {case['mismatches']}")
    for kk, tm in r["timing"].items():
        log(f"[kernel] qtopk [{QUERIES}, {CAPACITY}] k={kk}: call "
            f"{tm['call']:.4f} ms = kernels {tm['kernels']:.4f} + merge "
            f"{tm['merge']:.4f} (0: sorted in the kernel) (bound "
            f"{tm['bound']:.4f} ms)")
    for kk, tm in r["timing"].items():
        log(f"[kernel] yardstick, not the same function (values only, "
            f"another tie order): torch.topk(largest=False) k={kk} "
            f"{tm['torch_topk']:.4f} ms")
    log(f"[kernel] qtopk plain (blocked) version: {r['plain_ms']:.4f} ms at "
        f"k={K}, {r['plain_ms_at_ef_coarse']:.4f} ms at k={EF_COARSE}")


def report_per_shard(results) -> None:
    """The scan kernels and qtopk at one shard's shape (phase 6's)."""
    for name in ("qgemm", "qcoarse", "qtopk"):
        r = results[name]
        lib = r["library_ms_per_shard"]
        log(f"[kernel] {name} per shard {r['shape_per_shard']}: "
            f"{r['ms_per_shard']:.4f} ms (plain {r['plain_ms_per_shard']:.4f}"
            f" ms, library {'none' if lib is None else f'{lib:.4f} ms'}, "
            f"bound {r['bound_ms_per_shard']:.4f} ms by "
            f"{r['bound_by_per_shard']})")
    r = results["qtopk"]
    log(f"[kernel] qtopk per shard at k={EF_COARSE}: "
        f"{r['ms_per_shard_at_ef_coarse']:.4f} ms (plain "
        f"{r['plain_ms_per_shard_at_ef_coarse']:.4f} ms, bound "
        f"{r['bound_ms_per_shard_at_ef_coarse']:.4f} ms)")


def check_k_beyond_capacity(torch, dev) -> None:
    """``exact_search`` with k > capacity on the card returns what the
    CPU's default route (the full sort) returns: min(k, capacity) columns,
    the same values, both metrics."""
    import dataclasses
    from repro_torch.core import search
    from repro_torch.core.contracts import get_contract
    from repro_torch.core.state import init_state
    cases = load_test_module("_torch_search_cases")
    for cap, kk in ((1030, 1040), (2100, 3000)):
        c = cases.make_case("Q16.16-unit", cap, DIM, QUERIES, seed=2)
        states = {}
        for where in ("cpu", dev):
            states[str(where)] = dataclasses.replace(
                init_state(cap, DIM, contract=get_contract(c["contract"]),
                           device=where),
                vectors=torch.from_numpy(c["vectors"]).to(where),
                ids=torch.from_numpy(c["ids"]).to(where),
                valid=torch.from_numpy(c["valid"]).to(where))
        q = torch.from_numpy(c["queries"])
        for metric in (search.METRIC_L2, search.METRIC_DOT):
            want = search.exact_search(states["cpu"], q, kk, metric=metric)
            got = search.exact_search(states[str(dev)], q.to(dev), kk,
                                      metric=metric)
            acc = dict(max_abs_err=0, mismatches=0)
            compare(torch, got, want, acc)  # raises on another shape
            if acc["mismatches"]:
                raise AssertionError(f"exact_search k={kk} > capacity={cap} "
                                     f"{metric}: card and CPU differ: {acc}")
        log(f"[search] exact_search k={kk} > capacity={cap} on the card: "
            f"shape {tuple(got[0].shape)} and values equal the CPU default "
            f"route's (l2 and dot)")


def check_lm_widths(torch, dev, rng) -> dict:
    """Phase 9's kernel shapes at each of its widths, bit for bit against
    the plain versions on the card, each then timed as a whole call:
    qboundary at [FAMILY_DOCS, d] (ingest), [QUERIES, d] (reads) and
    [GEN_PROMPTS, d] (generate's read), with unit norm and without; qgemm
    at [QUERIES, d] and [GEN_PROMPTS, d] x [SIDE_CAPACITY, d]; qtopk at
    [QUERIES, SIDE_CAPACITY] and [GEN_PROMPTS, SIDE_CAPACITY], k = K.
    Returns {case: ms}."""
    from repro_torch.core.contracts import Q16_16
    from repro_torch.kernels.qboundary import ops as qb_ops
    from repro_torch.kernels.qboundary import ref as qb_ref
    from repro_torch.kernels.qgemm import ops as qg_ops
    from repro_torch.kernels.qgemm import ref as qg_ref
    from repro_torch.kernels.qtopk import ops as qt_ops
    from repro_torch.kernels.qtopk import ref as qt_ref
    times = {}

    def check(name, fn, want):
        acc = dict(max_abs_err=0, mismatches=0)
        compare(torch, fn(), want, acc)
        if acc["mismatches"]:
            raise AssertionError(f"{name}: kernel != plain version ({acc})")
        times[name] = cuda_ms(torch, fn, 20)

    def ints(shape):
        return torch.from_numpy(rng.integers(-65536, 65537, shape).astype(
            np.int32)).to(dev)

    for d in LM_WIDTHS:
        for n in (FAMILY_DOCS, QUERIES, GEN_PROMPTS):
            xt = torch.from_numpy(qboundary_rows(rng, n, d)).to(dev)
            for un in (True, False):
                check(f"qboundary [{n}, {d}] unit_norm={un}",
                      lambda: qb_ops.qboundary(xt, Q16_16, unit_norm=un),
                      qb_ref.qboundary_ref(xt, Q16_16, un))
        db = ints((SIDE_CAPACITY, d))
        for n in (QUERIES, GEN_PROMPTS):
            q = ints((n, d))
            check(f"qgemm [{n}, {d}] x [{SIDE_CAPACITY}, {d}]",
                  lambda: qg_ops.qgemm(q, db), qg_ref.qgemm_ref(q, db))
    keys = torch.from_numpy(rng.permutation(SIDE_CAPACITY).astype(np.int32)
                            ).to(dev)
    for n in (QUERIES, GEN_PROMPTS):
        s = torch.from_numpy(rng.integers(-2**45, 2**45,
                                          (n, SIDE_CAPACITY))).to(dev)
        s[:, ::5] = 0  # ties
        check(f"qtopk [{n}, {SIDE_CAPACITY}] k={K}",
              lambda: qt_ops.qtopk(s, keys, K),
              qt_ref.qtopk_blocked(s, keys, K, qt_ops.block_n(SIDE_CAPACITY)))
    return times


def check_qcoarse(torch, dev, rng):
    from repro_torch.kernels.qcoarse import kernel, ops, ref
    acc = dict(max_abs_err=0, mismatches=0)
    paths = {}
    wb = ops.W_BOUND

    def inputs(nq, nn, d):
        w = rng.integers(-wb, wb + 1, (nq, d)).astype(np.int32)
        c = rng.integers(-127, 128, (nn, d)).astype(np.int8)
        return torch.from_numpy(w).to(dev), torch.from_numpy(c).to(dev)

    def run(name, w, c):
        paths[name] = kernel.path(c)
        got = ops.qcoarse(w, c)
        compare(torch, got, ref.qcoarse_ref(w, c), acc)
        return got

    for nq, nn, d in [(1, 1, 8), (4, 16, 32), (8, 128, 64), (128, 256, 512),
                      (7, 100, 384), (130, 257, 640), (3, 33, 8192),
                      (5, 77, 7), (3, 9, 101), (64, 4099, 2304)]:
        run(f"[{nq}, {d}] x [{nn}, {d}]", *inputs(nq, nn, d))
    # codes whose rows are not 16-byte aligned take the plain loads
    w, c = inputs(3, 34, 64)
    for off, d in ((1, 64), (2, 62)):
        cv = c.reshape(-1)[off:off + 33 * d].reshape(33, d)
        run(f"unaligned view +{off}, d={d}", w[:, :d].contiguous(), cv)
    ext_w = torch.full((2, 8192), wb, dtype=torch.int32, device=dev)
    ext_w[1] = -wb
    ext_c = torch.full((2, 8192), 127, dtype=torch.int8, device=dev)
    ext_c[1] = -127
    got = run("+-W_BOUND x +-127, d=8192", ext_w, ext_c)
    if int(got[0, 0]) != 8192 * wb * 127:
        raise AssertionError("qcoarse extreme value wrong")
    # all-255 low limbs against -128 codes: the planes' worst case
    low_w = torch.full((2, 8192), 0x00FFFFFF, dtype=torch.int32, device=dev)
    low_w[1] = -1
    low_c = torch.full((3, 8192), -128, dtype=torch.int8, device=dev)
    low_c[1] = 127
    run("all-255 limbs x -128 / 127 codes, d=8192", low_w, low_c)
    try:
        ops.qcoarse(torch.zeros((2, 8193), dtype=torch.int32, device=dev),
                    torch.zeros((2, 8193), dtype=torch.int8, device=dev))
    except ValueError:
        pass
    else:
        raise AssertionError("qcoarse accepted d > 8192")
    # the main path's scan: 64 query weights against the whole code table
    nq, nn, d = QUERIES, CAPACITY, DIM
    w, _ = inputs(nq, 1, d)
    c = torch.randint(-127, 128, (nn, d), dtype=torch.int8, device=dev)
    run(f"main [{nq}, {d}] x [{nn}, {d}]", w, c)
    ms = cuda_ms(torch, lambda: ops.qcoarse(w, c), 20)
    plain = cuda_ms(torch, lambda: ref.qcoarse_ref(w, c), 3)
    wf, cf = w.to(torch.float64), c.to(torch.float64)
    lib = cuda_ms(torch, lambda: torch.matmul(wf, cf.T), 3)
    del cf
    shard = per_shard_times(torch, run, w, c[:SHARD_ROWS], ops.qcoarse,
                            ref.qcoarse_ref, wf, INT8_TC_OPS_PER_S)
    del wf, c
    b, by = bound_ms(nn * d + nq * d * 4 + nq * nn * 8, 2.0 * nq * nn * d,
                     INT8_TC_OPS_PER_S)
    return dict(acc, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b, bound_by=by, paths=paths,
                shape=f"[{nq}, {d}] i32 x [{nn}, {d}] i8 -> i64", **shard)


class NeededRows:
    """While the plain HNSW version runs: the rows whose distances each
    beam needs (its prefetches left out), per beam (a query, or one insert
    with all its levels) and over all beams — the work a bound counts —
    and each beam's dependent distance steps (the greedy walk's start and
    moves, each level's entry and expansions with fresh rows: one request
    each, one memory round trip each on the card)."""

    def __init__(self, ref):
        self.ref, self.sets, self.keep, self.steps = ref, {}, [], {}

    def __enter__(self):
        orig = self.orig = self.ref._dists
        sets, keep, steps = self.sets, self.keep, self.steps

        def counting(cache, slots, ok, prefetch=None):
            if id(cache) not in sets:
                keep.append(cache)  # no reuse of its id while counting
            sets.setdefault(id(cache), set()).update(slots[ok].tolist())
            steps[id(cache)] = steps.get(id(cache), 0) + 1
            return (yield from orig(cache, slots, ok, prefetch))

        self.ref._dists = counting
        return self

    def __exit__(self, *exc):
        self.ref._dists = self.orig

    def per_beam(self) -> int:
        return sum(len(s) for s in self.sets.values())

    def union(self) -> int:
        return len(set().union(*self.sets.values())) if self.sets else 0

    def chain(self) -> dict:
        """Dependent distance steps: in all, and per beam (mean, max)."""
        n = list(self.steps.values()) or [0]
        return dict(total=sum(n), mean=sum(n) / len(n), max=max(n),
                    beams=len(self.steps))


def hnsw_bound(need, row_bytes: int, extra_bytes: int):
    """Least time for a beam's work: each needed row read once (plus the
    queries or new rows and the outputs), and 3 int64 operations per
    element of each needed distance at the card's CUDA-core float32 rate
    (int64 multiply-adds run slower, so this stays a lower bound)."""
    return bound_ms(need.union() * row_bytes + extra_bytes,
                    3.0 * DIM * need.per_beam(), F32_OPS_PER_S)


def stored_run(torch, dev, rng, n, run, dim, capacity):
    """n seeded unit-norm rows inserted and linked into a ``capacity``-row
    arena of width ``dim``, 1 % of them deleted, then ``run`` more rows
    stored but not linked, as ``_apply_insert_segment`` leaves them before
    its inserts. Returns (state, slots [1, run], the rows' raw values, ids,
    the deleted ids)."""
    import dataclasses as dc
    from repro_torch.core import boundary, commands, machine
    from repro_torch.core.state import init_state
    raw = boundary.normalize_embedding(torch.from_numpy(
        rng.normal(size=(n + run, dim)).astype(np.float32)).to(dev))
    ids = torch.arange(n + run, device=dev)
    dead = torch.from_numpy(rng.choice(n, n // 100, replace=False)).to(dev)
    base = machine.bulk_apply(init_state(capacity, dim, device=dev),
                              commands.insert_batch(ids[:n], raw[:n]))
    base = machine.bulk_apply(base, commands.delete_batch(dead, dim))
    slots = torch.nonzero(~base.valid).reshape(-1)[:run]
    vectors, sids, valid = (base.vectors.clone(), base.ids.clone(),
                            base.valid.clone())
    vectors[slots], sids[slots], valid[slots] = raw[n:], ids[n:], True
    stored = dc.replace(base, vectors=vectors, ids=sids, valid=valid)
    return stored, slots.to(torch.int32)[None], raw, ids, dead


def check_qhnsw_small(torch, dev, rng, acc_i, acc_s) -> dict:
    """One insert run (both variants) and one search at ``QHNSW_SMALL_DIM``,
    which no cluster size the launch takes divides (and whose rows are no
    whole number of 16-byte units: the plain-load path), bit for bit
    against the plain versions; returns the cluster sizes taken."""
    from repro_torch.core import boundary
    from repro_torch.kernels.qhnsw import kernel, ops, ref
    d = QHNSW_SMALL_DIM
    stored, slots, _, _, _ = stored_run(torch, dev, rng, 1024, 256, d, 4096)
    for fast in (True, False):
        got = ops.qhnsw_insert(stored, slots, slots.shape[1], fast=fast,
                               ef_construction=EF_CONSTRUCTION)
        want = ref.insert_ref(stored, slots, slots.shape[1],
                              EF_CONSTRUCTION, fast)
        compare(torch, (got.hnsw_neighbors, got.hnsw_levels, got.hnsw_entry),
                (want.hnsw_neighbors, want.hnsw_levels, want.hnsw_entry),
                acc_i)
    cluster = {"insert": kernel.CLUSTER["insert"]}
    q = boundary.admit_query(torch.from_numpy(rng.normal(
        size=(QUERIES, d)).astype(np.float32)).to(dev))
    compare(torch, ops.qhnsw_search(got, q, K, EF),
            ref.search_ref(want, q, K, EF), acc_s)
    cluster["search"] = kernel.CLUSTER["search"]
    return dict(dim=d, cluster=cluster)


def check_qhnsw(torch, dev, rng):
    """qhnsw_insert and qhnsw_search bit for bit against their plain
    versions on the card, at phase 3's width over its arena: 1536 rows
    linked, 1 % deleted, then one run of 512 stored rows linked (fast and
    default variants) and a re-link of the result (both variants); 64
    queries (k = 10, ef = 64) on it, flat and over 4 shards of the same
    rows in one launch; then one insert run and one search at
    ``QHNSW_SMALL_DIM``. Times: CUDA events for the kernels, the host clock
    for the plain versions (host-driven beams with their distances on the
    card). Beside each bound, the chain bound: the plain version's
    dependent distance steps (all of a run's, one beam's most for the
    search) times one memory round trip (``kernel.round_trip_ns``)."""
    from repro_torch.core import (boundary, commands, distributed, hnsw,
                                  shard_wal)
    from repro_torch.kernels.qhnsw import kernel, ops, ref
    acc_i = dict(max_abs_err=0, mismatches=0)
    acc_s = dict(max_abs_err=0, mismatches=0)
    n, run = QHNSW_ROWS, BATCH
    stored, slots, raw, ids, dead = stored_run(torch, dev, rng, n, run, DIM,
                                               CAPACITY)
    trip_ns = kernel.round_trip_ns(dev, 1 << 26, 200_000)

    def graph(st):
        return st.hnsw_neighbors, st.hnsw_levels, st.hnsw_entry

    def plain(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    ins = {}
    for fast in (True, False):
        with NeededRows(ref) as need:
            want, plain_ms = plain(lambda: ref.insert_ref(
                stored, slots, run, EF_CONSTRUCTION, fast))

        def launch():
            return ops.qhnsw_insert(stored, slots, run, fast=fast,
                                    ef_construction=EF_CONSTRUCTION)

        got = launch()
        compare(torch, graph(got), graph(want), acc_i)
        b, by = hnsw_bound(need, DIM * 4, run * DIM * 4)
        ins["fast" if fast else "default"] = dict(
            ms=cuda_ms(torch, launch, 1, warmup=0), plain_ms=plain_ms,
            bound_ms=b, bound_by=by, chain=need.chain(),
            cluster=kernel.CLUSTER["insert"])
        if fast:
            linked = got
    blank, order, n_real = hnsw.rebuild_plan(linked)
    relink = {}
    for fast in (True, False):
        want, plain_ms = plain(lambda: ref.insert_ref(
            blank, torch.from_numpy(order), n_real, EF_CONSTRUCTION, fast))
        got = hnsw.rebuild(linked, EF_CONSTRUCTION, fast)
        compare(torch, graph(got), graph(want), acc_i)
        relink["fast" if fast else "default"] = dict(
            ms=cuda_ms(torch, lambda: hnsw.rebuild(linked, EF_CONSTRUCTION,
                                                   fast), 1, warmup=0),
            plain_ms=plain_ms, rows=n_real)

    q = boundary.admit_query(torch.from_numpy(rng.normal(
        size=(QUERIES, DIM)).astype(np.float32)).to(dev))
    with NeededRows(ref) as need:
        want, plain_ms = plain(lambda: ref.search_ref(linked, q, K, EF))
    compare(torch, ops.qhnsw_search(linked, q, K, EF), want, acc_s)
    cluster = kernel.CLUSTER["search"]
    ms = cuda_ms(torch, lambda: ops.qhnsw_search(linked, q, K, EF), 10)
    b, by = hnsw_bound(need, DIM * 4, QUERIES * DIM * 4 + QUERIES * K * 20)
    # the same rows over 4 shards, all shards in one launch
    sh = distributed.init_sharded_host(SHARDS, SHARD_ROWS, DIM, device=dev)
    sh = shard_wal.bulk_apply_sharded(sh, commands.insert_batch(ids, raw),
                                      SHARDS)
    sh = shard_wal.bulk_apply_sharded(sh, commands.delete_batch(dead, DIM),
                                      SHARDS)
    stacked = shard_wal.shard_stack(sh, SHARDS)
    with NeededRows(ref) as need_sh:
        want, plain_sh = plain(lambda: ref.search_ref(stacked, q, K, EF))
    compare(torch, ops.qhnsw_search(stacked, q, K, EF), want, acc_s)
    cluster_sh = kernel.CLUSTER["search"]
    ms_sh = cuda_ms(torch, lambda: ops.qhnsw_search(stacked, q, K, EF), 10)
    b_sh, by_sh = hnsw_bound(need_sh, DIM * 4,
                             QUERIES * DIM * 4 + SHARDS * QUERIES * K * 20)
    small = check_qhnsw_small(torch, dev, rng, acc_i, acc_s)
    live = int(linked.valid.sum())
    chains = dict(trip_ns=trip_ns, small=small, search=dict(
        flat=dict(need.chain(), cluster=cluster, rows=need.per_beam()),
        sharded=dict(need_sh.chain(), cluster=cluster_sh,
                     rows=need_sh.per_beam())))
    search = dict(acc_s, ms=ms, plain_ms=plain_ms, library_ms=None,
                  bound_ms=b, bound_by=by, ms_sharded=ms_sh,
                  plain_ms_sharded=plain_sh, bound_ms_sharded=b_sh,
                  bound_by_sharded=by_sh, chains=chains,
                  shape=f"{QUERIES} queries, k={K}, ef={EF}, {live} live of "
                  f"{CAPACITY} rows, d={DIM}; sharded {SHARDS} x "
                  f"{SHARD_ROWS}")
    insert = dict(acc_i, **ins["fast"], library_ms=None,
                  ms_default=ins["default"]["ms"],
                  default_chain=ins["default"]["chain"],
                  default_cluster=ins["default"]["cluster"],
                  plain_ms_default=ins["default"]["plain_ms"],
                  relink=relink,
                  shape=f"one run of {run} stored rows into {n - n // 100} "
                  f"linked ({CAPACITY} rows, d={DIM}, ef_construction="
                  f"{EF_CONSTRUCTION}); re-link of {relink['fast']['rows']}")
    return search, insert


def report_qhnsw(search, insert) -> None:
    ch = search["chains"]
    trip = ch["trip_ns"]
    log(f"[kernel] qhnsw: one memory round trip {trip:.1f} ns (one thread's "
        f"dependent loads over 256 MB) ({CARD[0]})")
    for variant in ("fast", "default"):
        r = insert if variant == "fast" else dict(
            ms=insert["ms_default"], chain=insert["default_chain"],
            cluster=insert["default_cluster"])
        c = r["chain"]
        log(f"[kernel] qhnsw_insert {variant}: cluster of {r['cluster']} "
            f"CTAs; {r['ms'] * 1e3 / BATCH:.1f} us per insert, "
            f"{r['ms'] * 1e3 / max(c['total'], 1):.2f} us per dependent "
            f"step; the plain version's steps {c['total']} in all, "
            f"{c['mean']:.1f} per insert (at most {c['max']}); chain bound "
            f"{c['total'] * trip / 1e6:.3f} ms ({CARD[0]})")
    for tag, c in ch["search"].items():
        ms = search["ms"] if tag == "flat" else search["ms_sharded"]
        log(f"[kernel] qhnsw_search {tag}: cluster of {c['cluster']} CTAs; "
            f"the plain version's steps {c['mean']:.1f} per beam (at most "
            f"{c['max']}, {c['beams']} beams) beside NeededRows' "
            f"{c['rows']} needed rows; {ms * 1e3 / max(c['max'], 1):.2f} us "
            f"per step of the longest beam; chain bound "
            f"{c['max'] * trip / 1e6:.4f} ms ({CARD[0]})")
    sm = ch["small"]
    log(f"[kernel] qhnsw at d = {sm['dim']} (no cluster size divides it): "
        f"insert run (both variants) and search equal the plain versions, "
        f"clusters {sm['cluster']}")
    log(f"[kernel] qhnsw_search over {SHARDS} shards in one launch: "
        f"{search['ms_sharded']:.4f} ms (plain {search['plain_ms_sharded']:.1f}"
        f" ms, bound {search['bound_ms_sharded']:.4f} ms by "
        f"{search['bound_by_sharded']}) ({CARD[0]})")
    log(f"[kernel] qhnsw_insert default variant: {insert['ms_default']:.1f} "
        f"ms (plain {insert['plain_ms_default']:.1f} ms) ({CARD[0]})")
    for variant, r in insert["relink"].items():
        log(f"[kernel] qhnsw_insert re-link of {r['rows']} rows, {variant}: "
            f"{r['ms']:.1f} ms (plain {r['plain_ms']:.1f} ms), equal bit for "
            f"bit ({CARD[0]})")


def load_test_module(name: str):
    """A helper module of the tests (``tests/<name>.py``), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_search_contracts(torch, dev) -> dict:
    """``exact_search`` on the card over every storage type the contracts
    give (``tests/_torch_search_cases.py``: Q8.8, Q2.13, Q16.16 with and
    without unit norm, Q32.32, and d = 8200) equals the CPU's, both
    metrics. Returns the qgemm path each case took."""
    import dataclasses
    from repro_torch.core import search
    from repro_torch.core.contracts import get_contract
    from repro_torch.core.state import init_state
    from repro_torch.kernels.qgemm import kernel
    cases = load_test_module("_torch_search_cases")
    paths = {}
    for case in cases.CASES:
        cap = 1031 if case == "Q16.16-d8200" else 4099  # CPU time
        c = cases.make_case(case, cap, DIM, QUERIES, seed=1)
        cap, dim = c["vectors"].shape
        states = {}
        for where in ("cpu", dev):
            states[str(where)] = dataclasses.replace(
                init_state(cap, dim, contract=get_contract(c["contract"]),
                           device=where),
                vectors=torch.from_numpy(c["vectors"]).to(where),
                ids=torch.from_numpy(c["ids"]).to(where),
                valid=torch.from_numpy(c["valid"]).to(where))
        q = torch.from_numpy(c["queries"])
        card = states[str(dev)]
        paths[f"{case} [{QUERIES}, {dim}] x [{cap}, {dim}] "
              f"{str(card.vectors.dtype).removeprefix('torch.')}"] = \
            kernel.path(q.to(dev), card.vectors)
        for metric in (search.METRIC_L2, search.METRIC_DOT):
            want = search.exact_search(states["cpu"], q, K, metric=metric)
            got = search.exact_search(card, q.to(dev), K, metric=metric)
            if not (torch.equal(got[0].cpu(), want[0])
                    and torch.equal(got[1].cpu(), want[1])):
                raise AssertionError(
                    f"exact_search {case} {metric}: card and CPU differ")
    return paths


def stage_breakdown(torch, eng, queries) -> dict:
    """Per-stage CUDA-event times (ms) of one warm exact and one warm
    coarse batch on the engine's state: each kernel call repeated alone on
    the batch's own inputs, the rest as the remainder of the whole
    search."""
    from repro_torch.core import boundary, codes, search
    from repro_torch.kernels.qcoarse import ops as qcoarse_ops
    from repro_torch.kernels.qgemm import ops as qgemm_ops
    from repro_torch.kernels.qtopk import ops as qtopk_ops
    state, table = eng.memory, eng._code_table
    q = boundary.admit_query(torch.from_numpy(queries).to(state.vectors.device),
                             eng.sc.contract)
    n = state.capacity

    def ms(fn, iters=10):
        return cuda_ms(torch, fn, iters)

    # exact: qgemm, qtopk (k = 10), and norms / masks / id ranks
    scores = search.score_block(q, state.vectors)
    ids = torch.where(state.valid, state.ids, search.TOMBSTONE_ID)
    ranks = torch.empty((n,), dtype=torch.int32, device=ids.device)
    ranks[torch.argsort(ids, stable=True)] = torch.arange(
        n, dtype=torch.int32, device=ids.device)
    exact = {"total": ms(lambda: search.exact_search(state, q, K)),
             "qgemm": ms(lambda: qgemm_ops.qgemm(q, state.vectors)),
             "qtopk k=10": ms(lambda: qtopk_ops.qtopk(scores, ranks, K))}
    exact["norms, masks, id argsort (rest)"] = (
        exact["total"] - exact["qgemm"] - exact["qtopk k=10"])
    # outside the search: the batch's copy to the card and its boundary
    exact["boundary outside the search: copy to card + admit_query"] = ms(
        lambda: boundary.admit_query(eng._as_f32(queries), eng.sc.contract))
    # coarse: qcoarse, qtopk (k = 256), re-rank qgemm, and the rest
    w = codes.query_weights(q, table, search.METRIC_L2)
    approx = torch.where(state.valid[None, :],
                         table.norms[None, :] - 2 * qcoarse_ops.qcoarse(
                             w, table.codes), search.INF)
    slots = torch.arange(n, dtype=torch.int32, device=q.device)
    _, slot_c = search._topk_by_score_kernel(approx, slots.to(torch.int64),
                                             EF_COARSE)
    union = state.vectors[torch.unique(slot_c)]
    coarse = {"total": ms(lambda: search.coarse_search(
                  state, table, q, K, ef_coarse=EF_COARSE)),
              "qcoarse": ms(lambda: qcoarse_ops.qcoarse(w, table.codes)),
              f"qtopk k={EF_COARSE}": ms(lambda: qtopk_ops.qtopk(
                  approx, slots, EF_COARSE)),
              f"re-rank qgemm [{QUERIES}, {union.shape[0]}]": ms(
                  lambda: qgemm_ops.qgemm(q, union))}
    coarse["weights, approx, unique, gather, merge (rest)"] = (
        coarse["total"] - sum(v for k, v in coarse.items() if k != "total"))
    return {"exact": exact, "coarse": coarse}


def sass_counts(names) -> dict:
    """Integer tensor-core (IMMA / IGMMA) and IDP4A instructions in each
    built library, from ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in names:
        text = subprocess.run([tool, "-sass", str(_build.lib_path(name))],
                              capture_output=True, text=True,
                              timeout=120).stdout
        ops = []
        for ln in text.splitlines():
            # "/*0a60*/  @P0 IGMMA.64x64x32.S8.S8 R24, ... ;  /* 0x... */"
            tok = (ln.split("*/", 1)[1].split("/*")[0].split()
                   if "*/" in ln else [])
            if tok and tok[0].startswith("@"):  # predicated
                tok = tok[1:]
            if tok:
                ops.append(tok[0])
        out[name] = {
            "IMMA/IGMMA": sum(o.startswith(("IMMA", "IGMMA")) for o in ops),
            "IDP4A": sum(o.startswith("IDP4A") for o in ops)}
    return out


def ptxas_report(name: str):
    """(kernel, registers/spill line) pairs of ``nvcc -Xptxas -v``."""
    from repro_torch.kernels import _build
    entry = None
    for line in _build.PTXAS_LOG.get(name, "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif entry and ("registers" in line or "spill" in line):
            yield entry, line.split(":", 2)[-1].strip()


# --------------------------------------------------------------------------- #
# phase 3: the engine at full width
# --------------------------------------------------------------------------- #


def run_engine(torch, dev, n_docs: int, seed: int):
    from repro_torch import kernels
    from repro_torch.core import codes, query, search
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig

    eng = MemoryAugmentedEngine(DIM, ServeConfig(
        capacity=CAPACITY, retrieve_k=K, ef=EF, ef_coarse=EF_COARSE),
        device=dev)
    batches, queries, rng = engine_inputs(n_docs, seed)
    held = n_docs == SHARD_DOCS and seed == 0  # the pinned run
    routes = ("exact", "hnsw", "coarse")
    n_batches = {"exact": EXACT_BATCHES, "hnsw": HNSW_BATCHES,
                 "coarse": COARSE_BATCHES}
    torch.cuda.synchronize()

    kernels.reset_launch_counts()  # ---- the main path starts here ----
    t0 = time.perf_counter()
    for i, emb in enumerate(batches):
        eng.insert_documents(emb)
        if (i + 1) * BATCH == SHARD_DOCS:  # phase 6's reference values
            flat_ref = flat_conformance(torch, kernels, eng, queries[0])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0 - flat_ref["s"]
    boundary_ingest = (phase_counts(kernels)["qboundary"]
                       - flat_ref["launches"]["qboundary"])
    n_docs = eng.live_count()
    dead = rng.choice(n_docs, size=n_docs // 100, replace=False)
    t0 = time.perf_counter()
    removed = eng.delete_documents(dead.tolist())
    delete_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.relink_now()
    torch.cuda.synchronize()
    relink_s = time.perf_counter() - t0
    answers, times = {}, {}
    for route in routes:
        eng.sc.route = route
        times[route], answers[route] = [], []
        # queries[0] is the cold batch (on the coarse route it builds the
        # code table); it is answered and timed apart
        for q in queries[:1 + n_batches[route]]:
            t0 = time.perf_counter()
            ids, scores = eng.retrieve(q)
            times[route].append((time.perf_counter() - t0) * 1e3)
            answers[route].append((ids, scores))
    hnsw_state = eng.memory  # the state the HNSW route read
    # full coverage: ef_coarse >= live rows
    live = eng.live_count()
    eng.sc.ef_coarse = max(EF_COVER, live)
    t0 = time.perf_counter()
    cover = eng.retrieve(queries[0])
    cover_ms = (time.perf_counter() - t0) * 1e3
    eng.sc.ef_coarse = EF_COARSE
    # one more insert batch refreshes the maintained table
    extra = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    before = phase_counts(kernels)["qboundary"]
    t0 = time.perf_counter()
    eng.insert_documents(extra)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    boundary_ingest += phase_counts(kernels)["qboundary"] - before
    t0 = time.perf_counter()
    refreshed = eng.retrieve(queries[0])
    refreshed_ms = (time.perf_counter() - t0) * 1e3
    counts = phase_counts(kernels)  # ---- the main path ends here ----
    # phase 6's reference record is not the main path's
    counts = {k: v - flat_ref["launches"][k] for k, v in counts.items()}
    flat_ref["ingest_docs_s"] = n_docs / ingest_s
    log(f"[engine] after {SHARD_DOCS} docs (phase 6's reference): "
        f"memory_hash {flat_ref['memory_hash']:#018x}, exact retrieval_hash "
        f"{flat_ref['exact']:#018x} ({flat_ref['s']:.3f} s, outside the "
        f"ingest time); its launches {flat_ref['launches']} are not in the "
        f"main path's counts")

    log(f"[engine] ingested {n_docs} docs in {ingest_s:.3f} s = "
        f"{n_docs / ingest_s:.1f} docs/s (batches of {BATCH}, "
        f"d={DIM}, capacity={CAPACITY})")
    log(f"[engine] deleted {removed} in {delete_s:.3f} s; relink of "
        f"{live} live rows in {relink_s:.3f} s")
    for route in routes:
        warm = times[route][1:]
        extra_note = f", ef_coarse={EF_COARSE}" if route == "coarse" else ""
        log(f"[engine] retrieve route={route}: {QUERIES} queries x k={K}"
            f"{extra_note}, cold batch {times[route][0]:.3f} ms, then "
            f"{len(warm)} batches: p50 {statistics.median(warm):.3f} "
            f"ms/batch, min {min(warm):.3f}, max {max(warm):.3f}")
    log(f"[engine] kernel launches on the main path: {counts}; qboundary "
        f"{boundary_ingest} at [{BATCH}, {DIM}] (ingest), "
        f"{counts['qboundary'] - boundary_ingest} at [{QUERIES}, {DIM}] "
        f"(queries)")
    for route, stages in stage_breakdown(torch, eng, queries[1]).items():
        log(f"[engine] one warm {route} batch by stage (CUDA events, ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    require(counts, list(counts), "phase 3's main path")
    for route in ("hnsw", "coarse"):
        overlap = np.mean([len(set(a[0][i]) & set(b[0][i])) / K
                           for a, b in zip(answers["exact"], answers[route])
                           for i in range(QUERIES)])
        log(f"[engine] {route} recall@{K} against the exact route on the "
            f"card: {overlap:.4f} over {len(answers[route])} batches")
    for route in routes:
        for ids, scores in answers[route] + [cover, refreshed]:
            if ids.shape != (QUERIES, K) or (ids < 0).any() \
                    or (scores >= search.INF).any():
                raise AssertionError(f"route {route}: malformed answer")

    h_cover = query.retrieval_hash(*cover)
    if h_cover != query.retrieval_hash(*answers["exact"][0]):
        raise AssertionError("coarse route at full coverage != exact route")
    log(f"[engine] coarse route at ef_coarse={max(EF_COVER, live)} >= "
        f"{live} live rows: retrieval_hash {h_cover:#018x} equals the exact "
        f"route's ({cover_ms:.3f} ms)")
    h_table = codes.table_hash(eng._code_table)
    t0 = time.perf_counter()
    h_build = codes.table_hash(codes.build(eng.memory))
    build_ms = (time.perf_counter() - t0) * 1e3
    if h_table != h_build:
        raise AssertionError("refreshed code table != codes.build(state)")
    log(f"[engine] insert of {BATCH} more in {refresh_s:.3f} s, then a "
        f"coarse read in {refreshed_ms:.3f} ms: refreshed table_hash "
        f"{h_table:#018x} equals codes.build's ({build_ms:.1f} ms)")

    t0 = time.perf_counter()
    h_state = eng.state_hash()
    h_replay = eng.replay_log_fresh()
    log(f"[engine] state_hash {h_state:#018x}, replay_log_fresh "
        f"{h_replay:#018x} ({time.perf_counter() - t0:.1f} s)")
    if h_state != h_replay:
        raise AssertionError("replay_log_fresh() != state_hash()")

    # the routes against the CPU's plain versions on a copy of the state
    # are cut to keep the run inside its time (phase 6's too)
    eng.sc.route = "coarse"
    if query.retrieval_hash(*eng.retrieve(queries[0])) \
            != query.retrieval_hash(*refreshed):
        raise AssertionError("coarse route: two reads of one state differ")
    h_mem = eng.memory_hash()
    log(f"[engine] memory_hash {h_mem:#018x}")
    if all([pin("state_hash", h_state, held),
            pin("memory_hash", h_mem, held),
            pin("shard_memory", flat_ref["memory_hash"], seed == 0)]):
        log("[engine] state_hash, memory_hash and phase 6's reference "
            "memory_hash equal the pinned values")
    check_hnsw_on_cpu(torch, dev, hnsw_state, queries[0])
    return counts, eng, flat_ref


def check_hnsw_on_cpu(torch, dev, state, queries) -> None:
    """One HNSW batch on the card (qhnsw_search) and on a CPU copy of the
    same state (the plain version): equal ids, distances and slots; then
    one exact-route batch (``query.plan_query(route="exact")`` and
    ``execute_plan``: qboundary's admitted queries, qgemm, qtopk on the
    card) on the same two: equal ids and scores."""
    from repro_torch.core import boundary, query
    q = boundary.admit_query(torch.from_numpy(queries).to(dev))
    t0 = time.perf_counter()
    cpu_state = state.to("cpu")
    card = query.batched_hnsw_search(state, q, K, ef=EF)
    cpu = query.batched_hnsw_search(cpu_state, q.cpu(), K, ef=EF)
    for a, b in zip(card, cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("the HNSW route on the card != on the CPU")
    t1 = time.perf_counter()
    log(f"[engine] one HNSW batch on the card equals the plain version on "
        f"a CPU copy of the state: ids, distances and slots "
        f"({t1 - t0:.1f} s)")
    plan = query.plan_query(int(state.valid.sum()), K, EF, route="exact")
    card = query.execute_plan(state, q, K, plan)
    cpu = query.execute_plan(cpu_state, q.cpu(), K, plan)
    for a, b in zip(card, cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("the exact route on the card != on the CPU")
    log(f"[engine] one exact-route batch on the card equals the CPU's on "
        f"the same copy of the state: ids and scores "
        f"({time.perf_counter() - t1:.1f} s)")


def engine_inputs(n_docs: int, seed: int):
    """Phase 3's seeded float32 embeddings: ``n_docs // BATCH`` batches of
    documents, then the query batches (the first batches do not depend on
    ``n_docs``), and the generator, which phase 3 draws on."""
    rng = np.random.default_rng(seed)
    batches = [rng.normal(size=(BATCH, DIM)).astype(np.float32)
               for _ in range(n_docs // BATCH)]
    queries = [rng.normal(size=(QUERIES, DIM)).astype(np.float32)
               for _ in range(1 + max(EXACT_BATCHES, COARSE_BATCHES))]
    return batches, queries, rng


def flat_conformance(torch, kernels, eng, queries) -> dict:
    """The flat engine's ``memory_hash`` and exact-route ``retrieval_hash``
    of ``queries`` now, with the time and kernel launches this took."""
    before = phase_counts(kernels)
    t0 = time.perf_counter()
    route, eng.sc.route = eng.sc.route, "exact"
    rec = dict(memory_hash=eng.memory_hash(),
               exact=eng.retrieval_hash(queries), queries=queries)
    eng.sc.route = route
    torch.cuda.synchronize()
    rec["s"] = time.perf_counter() - t0
    after = phase_counts(kernels)
    rec["launches"] = {k: after[k] - before[k] for k in after}
    return rec


# --------------------------------------------------------------------------- #
# phase 4: snapshots
# --------------------------------------------------------------------------- #


def check_snapshots(torch, dev, eng) -> None:
    """The reference's golden snapshots restore onto the card with their
    recorded hash; the engine's full-width state and code table survive
    their round trips with unchanged hashes."""
    from repro_torch.core import codes, hashing, snapshot
    fx = ROOT / "tests" / "fixtures"
    want = int(json.loads((fx / "golden.json").read_text())["state_hash"], 16)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        shutil.copytree(fx / "golden_v2_chunks", tmp / "golden")
        s1, h1 = snapshot.restore_bytes((fx / "golden_v1.bin").read_bytes(),
                                        device=dev)
        s2, h2 = snapshot.restore_v2(
            (fx / "golden_v2_manifest.bin").read_bytes(),
            snapshot.ChunkStore(tmp / "golden"), device=dev)
        for s in (s1, s2):
            if s.device.type != "cuda" or hashing.hash_state_device(s) != want:
                raise AssertionError("golden snapshot restore on the card")
        log(f"[snapshot] golden v1 and v2 restore on the card with "
            f"state_hash {want:#018x} (h1 {h1:#018x}, h2 {h2:#018x})")

        h = eng.state_hash()
        t0 = time.perf_counter()
        blob = snapshot.snapshot_bytes(eng.memory)
        t1 = time.perf_counter()
        st, hr = snapshot.restore_bytes(blob, device=dev)
        t2 = time.perf_counter()
        if hr != h or hashing.hash_state_device(st) != h:
            raise AssertionError("v1 round trip changed the state hash")
        log(f"[snapshot] v1 in memory: {len(blob)} bytes, write "
            f"{t1 - t0:.3f} s, restore onto the card {t2 - t1:.3f} s, "
            f"hash {h:#018x} unchanged")
        del st, blob

        store = snapshot.ChunkStore(tmp / "engine")
        t0 = time.perf_counter()
        manifest, stats = snapshot.snapshot_v2(eng.memory, store,
                                               chunk_size=CHUNK_SIZE)
        t1 = time.perf_counter()
        st, hr = snapshot.restore_v2(manifest, store, device=dev)
        t2 = time.perf_counter()
        if hr != h or hashing.hash_state_device(st) != h:
            raise AssertionError("v2 round trip changed the state hash")
        log(f"[snapshot] v2 ({CHUNK_SIZE}-byte chunks, temporary directory): "
            f"{stats['chunks_written']} distinct of {stats['chunks']} chunks "
            f"written ({stats['bytes_written']} of {stats['bytes_total']} "
            f"bytes), manifest {stats['manifest_bytes']} bytes, write "
            f"{t1 - t0:.3f} s, restore onto the card {t2 - t1:.3f} s, hash "
            f"unchanged")
        del st

        h_tab = codes.table_hash(eng._code_table)
        t0 = time.perf_counter()
        tblob, tstats = codes.snapshot_table_v2(
            eng._code_table, eng.flush(), store, chunk_size=CHUNK_SIZE)
        t1 = time.perf_counter()
        tab, cursor = codes.restore_table_v2(tblob, store, device=dev)
        t2 = time.perf_counter()
        if codes.table_hash(tab) != h_tab or cursor != eng.flush() \
                or tab.codes.device.type != "cuda":
            raise AssertionError("code-table round trip changed the table")
        log(f"[snapshot] code table (VLRQ): {tstats['chunks_written']} new "
            f"of {tstats['chunks']} chunks, write {t1 - t0:.3f} s, restore "
            f"onto the card {t2 - t1:.3f} s, table_hash {h_tab:#018x} "
            f"unchanged")


# --------------------------------------------------------------------------- #
# phase 5: durability
# --------------------------------------------------------------------------- #


def wal_bytes(store) -> int:
    return sum(p.stat().st_size for p in (store.dir / "wal").glob("*.wal"))


def run_durable(torch, dev, seed: int) -> dict:
    """The flat engine's durable mode at phase 3's width: durable ingest,
    checkpoints (background and synchronous), crash → recover on a fresh
    engine (card and CPU), a torn WAL tail, rollback, group commit,
    compaction and the JAX-written interop fixture, each held to its hash.
    Returns the stage times and the kernel launches of the durable path."""
    from repro_torch import kernels
    from repro_torch.core import commands, durability, hashing, machine
    from repro_torch.core import wal as wal_lib
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig

    rng = np.random.default_rng(seed + 2)
    batches = [rng.normal(size=(BATCH, DIM)).astype(np.float32)
               for _ in range(DURABLE_BATCHES + 1)]
    queries = rng.normal(size=(QUERIES, DIM)).astype(np.float32)
    base = dict(capacity=CAPACITY, retrieve_k=K, ef=EF, ef_coarse=EF_COARSE)
    times, out = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return res

    def hashes(eng):
        res = {"state": eng.state_hash()}
        for route in ("exact", "coarse"):
            eng.sc.route = route
            res[route] = eng.retrieval_hash(queries)
        eng.sc.route = "auto"
        return res

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # the in-memory engine, fed the first batch: the reference of the
        # durable engines below and the in-memory rate beside the durable one
        mem = MemoryAugmentedEngine(DIM, ServeConfig(**base), device=dev)
        timed("in-memory ingest, 1 batch", lambda: mem.insert_documents(
            batches[0]))
        mem_first = mem.memory
        side = dict(base, capacity=SIDE_CAPACITY)
        mem_side = MemoryAugmentedEngine(DIM, ServeConfig(**side), device=dev)
        mem_side.insert_documents(batches[0])
        side_first = mem_side.memory
        del mem_side

        kernels.reset_launch_counts()  # ---- the durable path starts here ----
        eng = timed("durable engine + genesis snapshot", lambda:
                    MemoryAugmentedEngine(DIM, ServeConfig(
                        durable_dir=str(tmp / "a"),
                        checkpoint_every=CHECKPOINT_EVERY, **base),
                        device=dev))
        store = eng.durable
        background = []
        store_checkpoint = store.checkpoint

        def checkpoint_timed(state):  # times the background checkpoints
            t0 = time.perf_counter()
            stats = store_checkpoint(state)
            background.append((time.perf_counter() - t0, stats))
            return stats

        store.checkpoint = checkpoint_timed
        for i in range(DURABLE_BATCHES):
            timed(f"durable ingest batch {i}",
                  lambda: eng.insert_documents(batches[i]))
            if i == 0 and eng.state_hash() != hashing.hash_state_device(
                    mem_first):
                raise AssertionError("durable engine != in-memory engine")
        n_docs = eng.live_count()
        dead = rng.choice(n_docs, size=n_docs // 100, replace=False)
        timed("delete 1 %", lambda: eng.delete_documents(dead.tolist()))
        timed("wait for the background checkpoint", eng.wait_durable)
        store.checkpoint = store_checkpoint
        sync = timed("synchronous checkpoint (+ code table)", eng.checkpoint)
        t_ckpt, h_ckpt, at_ckpt = eng.flush(), eng.state_hash(), eng.memory
        timed(f"durable ingest batch {DURABLE_BATCHES}",
              lambda: eng.insert_documents(batches[DURABLE_BATCHES]))
        before = hashes(eng)
        t_end = eng.flush()
        pin("durable", (t_end, before["state"]), seed == 0)
        log_end = eng.log
        n_wal = wal_bytes(store)
        eng.close()
        del eng
        out.update(t_ckpt=t_ckpt, t_end=t_end, wal_bytes=n_wal,
                   snapshots=store.snapshots(), background=background,
                   sync=sync)

        # crash: a fresh engine over the same directory recovers
        b = MemoryAugmentedEngine(DIM, ServeConfig(durable_dir=str(tmp / "a"),
                                                   **base), device=dev)
        got = timed("recover on the card", b.recover)
        if got != (t_end, before["state"]) or hashes(b) != before:
            raise AssertionError("recover on the card != the crashed engine")
        if timed("replay_log_fresh", b.replay_log_fresh) != before["state"]:
            raise AssertionError("replay_log_fresh() != state_hash()")
        counts = phase_counts(kernels)  # ---- the durable path ends here ----
        del b

        # a torn tail, over SIDE_CAPACITY rows: a checkpoint, one more
        # batch, and the last segment loses a few bytes; the card recovers
        # it. The CPU's recovery of the same directory reads the torn WAL
        # itself (a copy taken before the card's open truncates it) and
        # applies the surviving tail to the card's one restore of the
        # checkpoint (the rollback's)
        tt = MemoryAugmentedEngine(DIM, ServeConfig(
            durable_dir=str(tmp / "t"), **side), device=dev)
        tt.insert_documents(batches[0])
        tt.checkpoint()
        t_ckpt, h_ckpt, at_ckpt = tt.flush(), tt.state_hash(), tt.memory
        tt.insert_documents(batches[1])
        t_tt, log_end = tt.flush(), tt.log
        tt.close()
        del tt
        seg = sorted((tmp / "t" / "wal").glob("seg_*.wal"))[-1]
        with open(seg, "r+b") as f:
            f.truncate(seg.stat().st_size - 5)
        shutil.copytree(tmp / "t" / "wal", tmp / "torn_wal")
        b2 = MemoryAugmentedEngine(DIM, ServeConfig(
            durable_dir=str(tmp / "t"), **side), device=dev)
        t_torn, h_torn = timed("recover after a torn tail", b2.recover)
        prefix = timed("the same prefix applied in memory", lambda:
                       machine.bulk_apply(at_ckpt,
                                          log_end.slice(t_ckpt, t_torn)))
        if t_torn != t_tt - 1 or h_torn != hashing.hash_state_device(prefix):
            raise AssertionError("torn-tail recover != the in-memory prefix")
        cpu_wal = wal_lib.WriteAheadLog(tmp / "torn_wal")
        if cpu_wal.torn_tail_dropped == 0 or cpu_wal.t != t_torn:
            raise AssertionError("the CPU's WAL reader missed the torn tail")
        tail = cpu_wal.read_range(t_ckpt, t_torn, device="cpu")
        got = timed("rollback_to the checkpoint", lambda:
                    b2.rollback_to(t_ckpt))
        if got != (t_ckpt, h_ckpt):
            raise AssertionError("rollback_to != the checkpoint's hash")
        on_cpu = timed("the CPU's recovery: the WAL tail on the restored "
                       "checkpoint", lambda: machine.bulk_apply(
                           b2.memory.to("cpu"), tail))
        if hashing.hash_state_device(on_cpu) != h_torn:
            raise AssertionError("torn-tail recovery: card and CPU differ")
        b2.close()
        del b2, prefix, at_ckpt, on_cpu, cpu_wal, tail
        out["t_torn_ckpt"] = t_ckpt

        # group commit: the first batch buffers until the read barrier
        dead0 = rng.choice(BATCH, size=BATCH // 100, replace=False)
        ref = machine.bulk_apply(side_first, commands.delete_batch(
            torch.from_numpy(np.sort(dead0)).to(dev), DIM))
        g = MemoryAugmentedEngine(DIM, ServeConfig(
            durable_dir=str(tmp / "g"),
            group_commit=wal_lib.GroupCommitPolicy(max_batch=1024,
                                                   max_delay_s=3600),
            **side), device=dev)
        timed("group-commit ingest, 1 batch", lambda: g.insert_documents(
            batches[0]))
        g.delete_documents(dead0.tolist())
        pending = g.durable.t
        timed("read barrier flush + read", lambda: g.retrieve(queries))
        if pending != 0 or g.durable.t != BATCH + len(dead0) \
                or g.state_hash() != hashing.hash_state_device(ref):
            raise AssertionError("group commit != the in-memory engine")
        g.close()
        del g

        # compaction on a delete-heavy log: absent ids and repeated deletes
        # fold to NOP runs; the state must not move
        live = rng.choice(BATCH, size=BATCH // 4, replace=False).tolist()
        absent = list(range(10 * CAPACITY, 10 * CAPACITY + BATCH // 2))
        e = MemoryAugmentedEngine(DIM, ServeConfig(
            durable_dir=str(tmp / "e"), compaction=wal_lib.CompactionPolicy(
                dead_ratio=0.2, min_commands=BATCH, check_every=BATCH // 4),
            **side), device=dev)
        e.insert_documents(batches[0])
        ref = side_first
        t0 = time.perf_counter()
        for ids in (absent, live, live):
            e.delete_documents(ids)
        times["compaction engine: 3 delete batches"] = \
            time.perf_counter() - t0
        for ids in (absent, live, live):
            ref = machine.bulk_apply(ref, commands.delete_batch(
                torch.tensor(sorted(ids), device=dev), DIM))
        folded = int((e.durable.wal.read_range(
            0, e.durable.t, device="cpu").opcode == commands.NOP).sum())
        if folded == 0 or e.state_hash() != hashing.hash_state_device(ref):
            raise AssertionError("compaction engine != the in-memory engine")
        out.update(folded=folded, compacted_wal=wal_bytes(e.durable),
                   delete_heavy_commands=e.durable.t)
        e.close()
        del e, ref, mem, mem_first, side_first

        # the interop fixture the JAX package wrote
        fx = ROOT / "tests" / "fixtures" / "torch_port_durable"
        expect = json.loads((fx / "expected.json").read_text())
        shutil.copytree(fx / "store", tmp / "fixture")
        fstore = durability.DurableStore(tmp / "fixture", device=dev)
        state, h, t = fstore.recover()
        if state.device.type != dev.type or \
                (t, f"{h:#018x}") != (expect["recover"]["t"],
                                      expect["recover"]["state_hash"]):
            raise AssertionError("interop fixture: recover on the card")
        for off, want in expect["restore_at"].items():
            if f"{fstore.restore_at(int(off))[1]:#018x}" != want:
                raise AssertionError(f"interop fixture: restore_at({off})")
        out["fixture"] = (t, f"{h:#018x}", len(expect["restore_at"]))
    out.update(times=times, counts=counts, before=before,
               torn=(t_torn, h_torn), n_docs=n_docs + BATCH)
    return out


def report_durable(r) -> None:
    for name, secs in r["times"].items():
        log(f"[durable] {name}: {secs:.3f} s")
    per_batch = [r["times"][f"durable ingest batch {i}"]
                 for i in range(DURABLE_BATCHES + 1)]
    docs = BATCH * len(per_batch)
    ingest = sum(per_batch)
    mem = r["times"]["in-memory ingest, 1 batch"]
    first = per_batch[0]
    log(f"[durable] durable ingest {docs} docs in {ingest:.3f} s = "
        f"{docs / ingest:.1f} docs/s (batches of {BATCH}, d={DIM}, "
        f"WAL-append + fsync per batch, checkpoint_every={CHECKPOINT_EVERY}); "
        f"first batch durable {BATCH / first:.1f} docs/s vs the same batch "
        f"in memory {BATCH / mem:.1f} docs/s")
    for secs, stats in r["background"]:
        log(f"[durable] background checkpoint at t={stats['t']}: "
            f"{secs:.3f} s, {stats['chunks']} chunks of 8192 bytes, "
            f"{stats['chunks_written']} written ({stats['bytes_written']} of "
            f"{stats['bytes_total']} bytes)")
    s = r["sync"]
    log(f"[durable] synchronous checkpoint at t={s['t']}: {s['chunks']} "
        f"chunks, {s['chunks_written']} written ({s['bytes_written']} of "
        f"{s['bytes_total']} bytes)")
    log(f"[durable] WAL {r['wal_bytes']} bytes for {r['t_end']} commands "
        f"({r['n_docs']} inserts): {r['wal_bytes'] / r['n_docs']:.1f} bytes "
        f"per document; snapshots at {r['snapshots']}")
    b = r["before"]
    log(f"[durable] crashed engine t={r['t_end']} state_hash "
        f"{b['state']:#018x}, exact {b['exact']:#018x}, coarse "
        f"{b['coarse']:#018x}: a fresh engine's recover() on the card equals "
        f"all three, replay_log_fresh equals state_hash")
    log(f"[durable] torn tail (5 bytes cut): recover on the card lands on t="
        f"{r['torn'][0]} with {r['torn'][1]:#018x} == the in-memory prefix; "
        f"rollback_to({r['t_torn_ckpt']}) equals the checkpoint's hash "
        f"({SIDE_CAPACITY} rows); the CPU's "
        f"recovery (its own reader over the torn WAL, the surviving tail "
        f"on that restored checkpoint) "
        f"equals the card's")
    log(f"[durable] group commit (max_batch=1024): nothing durable before "
        f"the read barrier, then the in-memory engine's hash; compaction "
        f"folded {r['folded']} of {r['delete_heavy_commands']} commands "
        f"(WAL {r['compacted_wal']} bytes), hash unchanged")
    t, h, n = r["fixture"]
    log(f"[durable] JAX-written interop fixture recovered on the card: "
        f"t={t} {h}, {n} restore_at hashes reproduced")
    log(f"[durable] kernel launches on the durable path: {r['counts']}")
    # no HNSW read on this path: its reads are exact and coarse
    require(r["counts"], [k for k in r["counts"] if k != "qhnsw_search"],
            "the durable path")


# --------------------------------------------------------------------------- #
# phase 6: sharding
# --------------------------------------------------------------------------- #


def sharded_breakdown(torch, eng, queries) -> dict:
    """Per-stage CUDA-event times (ms) of one warm exact and one warm coarse
    batch on the sharded engine's state: each kernel call repeated alone on
    its own inputs, summed over the shards; the merge of the per-shard
    candidates alone; the rest as the remainder of the whole read."""
    from repro_torch.core import (boundary, codes, distributed, search,
                                  shard_wal)
    from repro_torch.kernels.qcoarse import ops as qcoarse_ops
    from repro_torch.kernels.qgemm import ops as qgemm_ops
    from repro_torch.kernels.qtopk import ops as qtopk_ops
    state, tables = eng.memory, eng._code_tables
    q = boundary.admit_query(torch.from_numpy(queries).to(state.device),
                             eng.sc.contract)
    slices = [distributed.shard_slice(state, s, SHARDS)
              for s in range(SHARDS)]

    def ms(fn, iters=10):
        return cuda_ms(torch, fn, iters)

    def merge_ms(parts):
        ids = torch.cat([i for i, _ in parts], dim=-1)
        sc = torch.cat([s for _, s in parts], dim=-1)
        return ms(lambda: search.merge_candidates(sc, ids, K))

    n = SHARD_ROWS
    ranks, scores, approx = [], [], []
    slots = torch.arange(n, dtype=torch.int32, device=q.device)
    for sl, table in zip(slices, tables):
        ids = torch.where(sl.valid, sl.ids, search.TOMBSTONE_ID)
        r = torch.empty((n,), dtype=torch.int32, device=ids.device)
        r[torch.argsort(ids, stable=True)] = slots
        ranks.append(r)
        scores.append(search.score_block(q, sl.vectors))
        w = codes.query_weights(q, table, search.METRIC_L2)
        approx.append((w, torch.where(
            sl.valid[None, :], table.norms[None, :] - 2 * qcoarse_ops.qcoarse(
                w, table.codes), search.INF)))
    exact = {"total": ms(lambda: shard_wal.exact_search_sharded(
                 state, SHARDS, q, K)),
             "qgemm x4": sum(ms(lambda sl=sl: qgemm_ops.qgemm(q, sl.vectors))
                             for sl in slices),
             f"qtopk k={K} x4": sum(
                 ms(lambda s=s, r=r: qtopk_ops.qtopk(s, r, K))
                 for s, r in zip(scores, ranks)),
             "merge": merge_ms([search.exact_search(sl, q, K)
                                for sl in slices])}
    exact["norms, masks, id argsort, slicing (rest)"] = (
        exact["total"] - sum(v for k, v in exact.items() if k != "total"))
    unions = []
    for sl, (w, a) in zip(slices, approx):
        _, slot_c = search._topk_by_score_kernel(
            a, slots.to(torch.int64), EF_COARSE)
        unions.append(sl.vectors[torch.unique(slot_c)])
    coarse = {"total": ms(lambda: shard_wal.coarse_search_sharded(
                  state, SHARDS, q, K, ef_coarse=EF_COARSE, tables=tables)),
              "qcoarse x4": sum(ms(lambda w=w, t=t: qcoarse_ops.qcoarse(
                  w, t.codes)) for (w, _), t in zip(approx, tables)),
              f"qtopk k={EF_COARSE} x4": sum(ms(lambda a=a: qtopk_ops.qtopk(
                  a, slots, EF_COARSE)) for _, a in approx),
              "re-rank qgemm x4": sum(ms(lambda u=u: qgemm_ops.qgemm(q, u))
                                      for u in unions),
              "merge": merge_ms([search.coarse_search(
                  sl, t, q, K, ef_coarse=EF_COARSE)
                  for sl, t in zip(slices, tables)])}
    coarse["weights, approx, unique, gather (rest)"] = (
        coarse["total"] - sum(v for k, v in coarse.items() if k != "total"))
    return {"exact": exact, "coarse": coarse}


def run_sharded(torch, dev, seed: int, flat_ref: dict) -> dict:
    """The sharded engine at phase 3's width over SHARDS x SHARD_ROWS rows:
    conformance with the flat engine, the three routes after a delete and a
    re-link, coverage == exact, the device-list mesh path, the audit, a
    ShardedDurableStore at full arena (crash →
    recover, a crash between per-shard flushes, rollback), the durable
    sharded engine (group commit, checkpoints, recover) and the JAX-written
    fixtures, each held to its hash. Returns the times, hashes and the
    kernel launches of the phase's main path."""
    from repro_torch import kernels
    from repro_torch.core import (boundary, distributed, hashing, query,
                                  search, shard_wal, snapshot)
    from repro_torch.core import wal as wal_lib
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig

    batches = engine_inputs(SHARD_DOCS, seed)[0]  # phase 3's first batches
    rng = np.random.default_rng(seed + 6)
    queries = [rng.normal(size=(QUERIES, DIM)).astype(np.float32)
               for _ in range(1 + max(SHARD_EXACT_BATCHES,
                                      SHARD_COARSE_BATCHES))]
    times, out = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return res

    base = dict(retrieve_k=K, ef=EF, ef_coarse=EF_COARSE, shards=SHARDS)
    eng = timed("engine + sharded genesis", lambda: MemoryAugmentedEngine(
        DIM, ServeConfig(capacity=CAPACITY, **base), device=dev))
    kernels.reset_launch_counts()  # ---- the phase's main path starts ----
    states = []
    for i, emb in enumerate(batches):
        timed(f"ingest batch {i}", lambda: eng.insert_documents(emb))
        states.append(eng.memory)
    eng.sc.route = "exact"
    conf = dict(memory_hash=timed("memory_hash", eng.memory_hash),
                exact=timed("exact read of phase 3's queries",
                            lambda: eng.retrieval_hash(flat_ref["queries"])))
    if (conf["memory_hash"], conf["exact"]) != (flat_ref["memory_hash"],
                                                flat_ref["exact"]):
        raise AssertionError(f"sharded engine != flat engine at "
                             f"{SHARD_DOCS} docs: {conf} vs {flat_ref}")
    n_docs = eng.live_count()
    dead = rng.choice(n_docs, size=n_docs // 100, replace=False)
    removed = timed("delete 1 %", lambda: eng.delete_documents(dead.tolist()))
    # the HNSW answer on the replay graph, before the re-link (a re-link is
    # not a logged command, so phase 7's hosts keep this graph)
    eng.sc.route = "hnsw"
    hnsw_replay = query.retrieval_hash(*eng.retrieve(queries[0]))
    timed("relink_now", eng.relink_now)
    n_batches = {"exact": SHARD_EXACT_BATCHES, "hnsw": SHARD_HNSW_BATCHES,
                 "coarse": SHARD_COARSE_BATCHES}
    answers, read_ms = {}, {}
    for route, nb in n_batches.items():
        eng.sc.route = route
        read_ms[route], answers[route] = [], []
        for q in queries[:1 + nb]:  # queries[0] is the cold batch
            t0 = time.perf_counter()
            answers[route].append(eng.retrieve(q))
            read_ms[route].append((time.perf_counter() - t0) * 1e3)
    counts = phase_counts(kernels)  # ---- the phase's main path ends ----
    require(counts, list(counts), "phase 6's main path")
    for route in n_batches:
        for ids, scores in answers[route]:
            if ids.shape != (QUERIES, K) or (ids < 0).any() \
                    or (scores >= search.INF).any():
                raise AssertionError(f"sharded route {route}: malformed")

    # coverage: ef_coarse >= every shard's live count
    live = distributed.shard_live_counts(eng.memory, SHARDS)
    eng.sc.route, eng.sc.ef_coarse = "coarse", int(live.max())
    cover = timed("coarse read at full coverage",
                  lambda: eng.retrieve(queries[0]))
    eng.sc.ef_coarse = EF_COARSE
    h_exact = query.retrieval_hash(*answers["exact"][0])
    if query.retrieval_hash(*cover) != h_exact:
        raise AssertionError("sharded coarse at full coverage != exact")
    q0 = boundary.admit_query(torch.from_numpy(queries[0]).to(dev))
    mesh = timed("distributed_search over cuda:0 x 4", lambda:
                 distributed.distributed_search([dev] * SHARDS, eng.memory,
                                                q0, K))
    if not (np.array_equal(mesh[0].cpu().numpy(), answers["exact"][0][0])
            and np.array_equal(mesh[1].cpu().numpy(),
                               answers["exact"][0][1])):
        raise AssertionError("distributed_search != the sharded exact route")
    out["breakdown"] = sharded_breakdown(torch, eng, queries[1])
    h_state = eng.state_hash()
    if timed("replay_log_fresh", eng.replay_log_fresh) != h_state:
        raise AssertionError("sharded replay_log_fresh() != state_hash()")

    # each route's first answer, which phase 7's wire reads must equal (the
    # CPU's plain versions on a copy of this state are cut to keep the run
    # inside its time)
    card = {route: query.retrieval_hash(*answers[route][0])
            for route in n_batches}
    pin("shard_memory", conf["memory_hash"], seed == 0)
    pin("sharded_hnsw", card["hnsw"], seed == 0)
    pin("replay_hnsw", hnsw_replay, seed == 0)
    out.update(conf=conf, card=card, h_state=h_state, removed=removed,
               hnsw_replay=hnsw_replay,
               n_docs=n_docs, live=live.tolist(), read_ms=read_ms,
               counts=counts, cover_ef=int(live.max()),
               dead=dead.tolist(), queries=queries)
    log_end = eng.log
    del eng

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # a ShardedDurableStore at full arena, driven directly
        genesis = distributed.init_sharded_host(SHARDS, SHARD_ROWS, DIM,
                                                device=dev)
        store = timed("store + genesis snapshots", lambda:
                      shard_wal.ShardedDurableStore(
                          tmp / "s", genesis, n_shards=SHARDS,
                          chunk_size=CHUNK_SIZE, device=dev))
        logs = [log_end.slice(i * BATCH, (i + 1) * BATCH)
                for i in range(len(batches))] + [  # + the delete batch
            log_end.slice(len(batches) * BATCH, len(log_end))]
        for i in range(len(batches) - 1):
            timed(f"store append batch {i}", lambda: store.append(logs[i]))
        timed("store checkpoint", lambda: store.checkpoint(states[-2]))
        t_ckpt, h_ckpt = store.t, hashing.hash_state_device(states[-2])
        t_end = timed("store append the last batch", lambda: store.append(
            logs[len(batches) - 1]))
        h_end = hashing.hash_state_device(states[-1])
        del store
        reopened = shard_wal.ShardedDurableStore(tmp / "s", device=dev)
        _, h, t = timed("store recover after a crash", reopened.recover)
        if (t, h) != (t_end, h_end):
            raise AssertionError("store recover != the pre-crash state")
        # a crash between per-shard flushes: shards 0-1 got the next group
        routed = distributed.route_commands(logs[-1], SHARDS)
        for s in (0, 1):
            reopened.shards[s].append(distributed.share(routed, s))
        ahead = reopened.shard_ts()
        reopened = shard_wal.ShardedDurableStore(tmp / "s", device=dev)
        _, h, t = timed("store recover after a crash between shard "
                        "flushes", reopened.recover)
        if (t, h) != (t_end, h_end) or len(set(reopened.shard_ts())) != 1:
            raise AssertionError("cross-shard reconcile != last whole cursor")
        timed("store rollback_to the checkpoint",
              lambda: reopened.rollback_to(t_ckpt))
        _, h = timed("store restore_at the checkpoint",
                     lambda: reopened.restore_at(t_ckpt))
        if h != h_ckpt or reopened.t != t_ckpt:
            raise AssertionError("store rollback != the checkpoint's hash")
        out["store"] = dict(t_ckpt=t_ckpt, h_ckpt=h_ckpt, t_end=t_end,
                            h_end=h_end, ahead=ahead)
        del reopened, genesis, states

        # the durable sharded engine: group commit + checkpoints, recover
        side = dict(base, capacity=SIDE_CAPACITY,
                    durable_dir=str(tmp / "e"))
        d = MemoryAugmentedEngine(DIM, ServeConfig(
            group_commit=wal_lib.GroupCommitPolicy(max_batch=4096,
                                                   max_delay_s=3600),
            checkpoint_every=SHARD_CHECKPOINT_EVERY, **side), device=dev)
        for i in range(2):
            timed(f"durable engine ingest batch {i}",
                  lambda: d.insert_documents(batches[i]))
        d.delete_documents(list(range(0, BATCH, 50)))
        pending = d.durable.t
        before = {"state": d.state_hash()}
        for route in ("exact", "coarse"):
            d.sc.route = route
            before[route] = d.retrieval_hash(queries[0])
        before["replay"] = timed("durable engine replay_log_fresh",
                                 d.replay_log_fresh)
        t_d = d.flush()
        d.wait_durable()
        snaps = d.durable.shards[0].snapshots()
        del d  # a crash: no close
        e = MemoryAugmentedEngine(DIM, ServeConfig(**side), device=dev)
        got_t, got_h = timed("durable engine recover", e.recover)
        after = {"state": e.state_hash()}
        for route in ("exact", "coarse"):
            e.sc.route = route
            after[route] = e.retrieval_hash(queries[0])
        after["replay"] = timed("recovered engine replay_log_fresh",
                                e.replay_log_fresh)
        if (got_t, got_h) != (t_d, before["state"]) or after != before \
                or before["replay"] != before["state"] or pending >= t_d \
                or len(snaps) < 2:
            raise AssertionError("durable sharded engine: recover != crash")
        out["durable"] = dict(t=t_d, pending=pending, snaps=snaps,
                              hashes=before)
        e.close()
        del e

        # the fixtures the JAX package wrote
        fx = ROOT / "tests" / "fixtures" / "torch_port_sharded"
        expect = json.loads((fx / "expected.json").read_text())
        shutil.copytree(fx / "store", tmp / "fixture")
        shutil.copytree(fx / "vlrs_chunks", tmp / "vlrs_chunks")
        fstore = shard_wal.ShardedDurableStore(tmp / "fixture", device=dev)
        state, h, t = fstore.recover()
        want = expect["recover"]
        if state.device.type != dev.type or (t, f"{h:#018x}",
                                             fstore.shard_ts()) != (
                want["t"], want["hash"], want["shard_ts"]):
            raise AssertionError("sharded fixture: recover on the card")
        for off, h_want in expect["restore_at"].items():
            if f"{fstore.restore_at(int(off))[1]:#018x}" != h_want:
                raise AssertionError(f"sharded fixture: restore_at({off})")
        _, hv = distributed.restore_sharded(
            (fx / "vlrs_manifest.bin").read_bytes(),
            snapshot.ChunkStore(tmp / "vlrs_chunks"), device=dev)
        if f"{hv:#018x}" != expect["vlrs_hash"]:
            raise AssertionError("sharded fixture: VLRS restore")
        golden = load_test_module("_torch_golden")
        out["golden"] = timed("sharded golden recipe on the card",
                              lambda: golden.check_sharded(dev))
        out["fixture"] = (t, f"{h:#018x}", len(expect["restore_at"]),
                          f"{hv:#018x}")
    out["times"] = times
    return out


def report_sharded(r, flat_ingest_docs_s: float) -> None:
    for name, secs in r["times"].items():
        log(f"[sharded] {name}: {secs:.3f} s")
    per_batch = [r["times"][f"ingest batch {i}"]
                 for i in range(SHARD_DOCS // BATCH)]
    log(f"[sharded] ingest {SHARD_DOCS} docs into {SHARDS} x {SHARD_ROWS} "
        f"rows in {sum(per_batch):.3f} s = {SHARD_DOCS / sum(per_batch):.1f} "
        f"docs/s (phase 3, flat, {CAPACITY} rows: "
        f"{flat_ingest_docs_s:.1f} docs/s over its whole ingest)")
    c = r["conf"]
    log(f"[sharded] at {SHARD_DOCS} docs: memory_hash {c['memory_hash']:#018x}"
        f" and exact retrieval_hash {c['exact']:#018x} equal the flat "
        f"engine's (phase 3)")
    log(f"[sharded] deleted {r['removed']} of {r['n_docs']}; live per shard "
        f"{r['live']}")
    for route, ms in r["read_ms"].items():
        warm = ms[1:]
        log(f"[sharded] retrieve route={route}: {QUERIES} queries x k={K}, "
            f"cold batch {ms[0]:.3f} ms, then {len(warm)} batches: p50 "
            f"{statistics.median(warm):.3f} ms/batch, min {min(warm):.3f}, "
            f"max {max(warm):.3f}")
    for route, stages in r["breakdown"].items():
        log(f"[sharded] one warm {route} batch by stage (CUDA events, ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    log(f"[sharded] coarse at ef_coarse={r['cover_ef']} (>= every shard's "
        f"live count) equals the exact route; distributed_search over "
        f"cuda:0 x {SHARDS} equals the exact route's (ids, scores); "
        f"replay_log_fresh == state_hash {r['h_state']:#018x}")
    log("[sharded] first read per route: " + ", ".join(
        f"{route} {h:#018x}" for route, h in r["card"].items()))
    s = r["store"]
    log(f"[sharded] store ({CHUNK_SIZE}-byte chunks): recover -> "
        f"t={s['t_end']} {s['h_end']:#018x} == the pre-crash state; shards 0-1 ahead at "
        f"{s['ahead']} reconciled to the same; rollback_to({s['t_ckpt']}) "
        f"-> {s['h_ckpt']:#018x}")
    d = r["durable"]
    log(f"[sharded] durable engine ({SIDE_CAPACITY} rows, group commit, "
        f"checkpoint_every={SHARD_CHECKPOINT_EVERY}): t={d['pending']} "
        f"durable before the read barrier, then t={d['t']}, snapshots "
        f"{d['snaps']}; "
        f"recover equals state {d['hashes']['state']:#018x}, exact "
        f"{d['hashes']['exact']:#018x}, coarse {d['hashes']['coarse']:#018x},"
        f" replay_log_fresh")
    t, h, n, hv = r["fixture"]
    log(f"[sharded] JAX-written fixture recovered on the card: t={t} {h}, {n}"
        f" restore_at hashes, VLRS {hv}; sharded golden recipe "
        f"{r['golden']}")
    log(f"[sharded] kernel launches on phase 6's main path: {r['counts']}")


# --------------------------------------------------------------------------- #
# phase 7: the network and replication
# --------------------------------------------------------------------------- #


def check_golden_wire() -> int:
    """Every frame of ``tests/fixtures/golden_wire/`` decodes with the
    port's protocol and re-encodes to the same bytes; returns the count."""
    from repro_torch.net import protocol as p
    fx = ROOT / "tests" / "fixtures" / "golden_wire"
    index = json.loads((fx / "golden_wire.json").read_text())
    if index["wire_format"] != p.WIRE_FORMAT:
        raise AssertionError("golden wire: format differs")
    for name, meta in index["frames"].items():
        frame = (fx / f"{name}.bin").read_bytes()
        msg, rid, end = p.decode_frame(frame)
        if (end, msg.TYPE, rid, len(frame)) != (
                len(frame), meta["msg_type"], meta["request_id"],
                meta["bytes"]) or p.encode_frame(msg, rid) != frame:
            raise AssertionError(f"golden wire frame {name} not reproduced")
    if len(index["frames"]) != len(p.MESSAGE_TYPES):
        raise AssertionError("golden wire: a message type has no frame")
    return len(index["frames"])


def run_network(torch, dev, seed: int, flat_ref: dict, sharded: dict
                ) -> dict:
    """Phase 7: the golden wire frames; the engine with ``hosts=`` over
    SHARDS in-process shard servers (SHARD_ROWS rows each, every request
    over a TCP socket), one following replica per shard, fed phase 3's
    first SHARD_DOCS documents, held to phase 3's and phase 6's hashes, its
    replica-served reads to its wire reads, a checkpoint over the wire; then
    a failover through a SIGKILLed shard-server process at SIDE_CAPACITY
    rows. Returns the times, hashes and the kernel launches of the
    networked engine's path."""
    from repro_torch import kernels
    from repro_torch.core import boundary, commands, distributed, query
    from repro_torch.core.state import init_state
    from repro_torch.net import protocol as p
    from repro_torch.net.client import RemoteShardClient, SocketTransport
    from repro_torch.net.replica import FollowerPolicy, ReplicaStore
    from repro_torch.net.server import ShardHost, ShardServer
    from repro_torch.runtime.coordinator import FailureDetector, LeaseConfig
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig

    times, out = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return res

    out["golden_frames"] = timed("golden wire frames", check_golden_wire)
    batches = engine_inputs(SHARD_DOCS, seed)[0]  # phase 3's first batches
    queries = sharded["queries"]                  # phase 6's
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_net_"))
    servers, eng, proc = [], None, None
    try:
        def start_hosts():
            genesis = distributed.init_sharded_host(SHARDS, SHARD_ROWS, DIM,
                                                    device=dev)
            for s in range(SHARDS):
                host = ShardHost(tmp / f"host_{s}",
                                 distributed.shard_slice(genesis, s, SHARDS),
                                 device=dev, chunk_size=CHUNK_SIZE)
                servers.append(ShardServer(host).start())

        timed("hosts' genesis", start_hosts)
        eng = timed("engine, clients and replicas", lambda:
                    MemoryAugmentedEngine(DIM, ServeConfig(
                        capacity=CAPACITY, retrieve_k=K, ef=EF,
                        ef_coarse=EF_COARSE,
                        hosts=[f"127.0.0.1:{s.port}" for s in servers],
                        durable_dir=str(tmp / "coordinator"), replicas=1,
                        follow=FollowerPolicy()),
                        device=dev))
        kernels.reset_launch_counts()  # ---- the phase's main path starts ----
        for i, emb in enumerate(batches):
            timed(f"ingest batch {i}", lambda: eng.insert_documents(emb))
        # reads go over the wire while the pool is detached (an empty pool
        # means the primary serves)
        pool, eng.read_replicas = eng.read_replicas, []
        eng.sc.route = "exact"
        conf = dict(memory_hash=timed("memory_hash", eng.memory_hash),
                    exact=timed("exact read of phase 3's queries", lambda:
                                eng.retrieval_hash(flat_ref["queries"])))
        if (conf["memory_hash"], conf["exact"]) != (flat_ref["memory_hash"],
                                                    flat_ref["exact"]):
            raise AssertionError(f"networked engine != flat engine at "
                                 f"{SHARD_DOCS} docs: {conf}")
        timed("delete 1 %", lambda: eng.delete_documents(sharded["dead"]))
        eng.read_replicas = pool
        before = sum(rep.t for pool in eng.read_replicas for rep in pool)
        out["lag"] = timed("sync_replicas", eng.sync_replicas)
        if out["lag"] != 0:
            raise AssertionError(f"sync_replicas left lag {out['lag']}")
        out["catch_up_cmds"] = sum(rep.t for pool in eng.read_replicas
                                   for rep in pool) - before
        eng.read_replicas = []
        wire, wire_ms = {}, {}
        for route, nb in NET_BATCHES.items():
            eng.sc.route = route
            wire_ms[route] = []
            for q in queries[:1 + nb]:  # queries[0] is the cold batch
                t0 = time.perf_counter()
                ans = eng.retrieve(q)
                wire_ms[route].append((time.perf_counter() - t0) * 1e3)
                if eng.last_plan.served_by != "primary":
                    raise AssertionError("a wire read was not the primary's")
                wire.setdefault(route, ans)
        h_wire = {r: query.retrieval_hash(*a) for r, a in wire.items()}
        for route in ("exact", "coarse"):
            if h_wire[route] != sharded["card"][route]:
                raise AssertionError(f"wire {route} != phase 6's read")
        # HNSW: the hosts hold the replay graph (a re-link is not a logged
        # command), which phase 6 read before its re-link
        if h_wire["hnsw"] != sharded["hnsw_replay"]:
            raise AssertionError("wire hnsw != phase 6's read before its "
                                 "re-link")
        pin("replay_hnsw", h_wire["hnsw"], seed == 0)
        live = distributed.shard_live_counts(eng.memory, SHARDS)
        eng.sc.route, eng.sc.ef_coarse = "coarse", int(live.max())
        cover = timed("coarse read at full coverage over the wire",
                      lambda: eng.retrieve(queries[0]))
        eng.sc.ef_coarse = EF_COARSE
        if query.retrieval_hash(*cover) != h_wire["exact"]:
            raise AssertionError("wire coarse at full coverage != exact")
        eng.read_replicas = pool
        rep_ms = {}
        for route, nb in NET_BATCHES.items():
            eng.sc.route = route
            rep_ms[route] = []
            for q in queries[:1 + nb]:
                t0 = time.perf_counter()
                ans = eng.retrieve(q)
                rep_ms[route].append((time.perf_counter() - t0) * 1e3)
                if not eng.last_plan.served_by.startswith("replica:"):
                    raise AssertionError("a synced pool did not serve")
                if q is queries[0] and query.retrieval_hash(*ans) \
                        != h_wire[route]:
                    raise AssertionError(f"replica {route} != wire read")
        counts = phase_counts(kernels)  # ---- the main path ends ----
        require(counts, list(counts), "phase 7's main path")
        if any(rep.follow_error is not None for pool in eng.read_replicas
               for rep in pool):
            raise AssertionError("a follower stopped")
        # an idempotent retry is logged where it happens; these count them
        reps = [rep for pool in eng.read_replicas for rep in pool]
        out["retries"] = dict(
            clients=sum(c.transport.retries for c in eng._clients),
            replicas=sum(rep.primary.transport.retries for rep in reps),
            replica_faults=sum(rep.faults for rep in reps))
        stats = timed("checkpoint over the wire", eng.checkpoint)
        record = tmp / "coordinator" / "merged" / f"t_{stats['t']:020d}.json"
        merged = json.loads(record.read_text())
        if int(merged["hash"], 16) != eng.state_hash():
            raise AssertionError("merged record != the engine's state hash")
        out.update(conf=conf, h_wire=h_wire, wire_ms=wire_ms, rep_ms=rep_ms,
                   counts=counts, merged=(stats["t"], merged["hash"]),
                   cover_ef=int(live.max()))
        eng.close()
        eng = None
        for srv in servers:
            srv.close()
            srv.host.close()
        servers = []

        # ---- 7c: failover through a real process ----
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.net.server", "--dir",
             str(tmp / "primary"), "--capacity", str(SIDE_CAPACITY),
             "--dim", str(DIM), "--port", "0", "--device", dev.type,
             "--chunk-size", str(CHUNK_SIZE)],
            stdout=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        t0 = time.perf_counter()
        line = proc.stdout.readline().strip()
        times["primary process start"] = time.perf_counter() - t0
        if not line.startswith("LISTENING "):
            raise AssertionError(f"shard server did not start: {line!r}")
        port = int(line.split()[1])

        def client():
            return RemoteShardClient(SocketTransport("127.0.0.1", port),
                                     device=dev)

        writer, probe = client(), client()
        genesis = init_state(SIDE_CAPACITY, DIM, device=dev)
        reps = timed("two durable replicas", lambda: [
            ReplicaStore(client(), genesis, directory=tmp / f"replica_{i}",
                         replica_id=i) for i in range(2)])
        rng = np.random.default_rng(seed + 7)
        logs = [commands.insert_batch(
            torch.arange(i * FAIL_BATCH, (i + 1) * FAIL_BATCH, device=dev),
            boundary.normalize_embedding(torch.from_numpy(rng.normal(
                size=(FAIL_BATCH, DIM)).astype(np.float32)).to(dev)))
            for i in range(4)]
        timed("failover: ingest 2 batches", lambda: writer.append_many(
            logs[:2]))
        lags = [timed("failover: replica 0 catch-up", reps[0].catch_up)]
        writer.append(logs[2])
        lags.append(timed("failover: replica 1 catch-up", reps[1].catch_up))
        t_max, h_max = reps[1].t, reps[1].state_hash()
        qf = boundary.admit_query(torch.from_numpy(rng.normal(
            size=(QUERIES, DIM)).astype(np.float32)).to(dev))
        plans = {r: query.plan_query(reps[1].t, K, EF, route=r,
                                     ef_coarse=EF_COARSE, dim=DIM)
                 for r in ("exact", "coarse")}
        proven = {r: query.execute_plan(reps[1].state, qf, K, pl)
                  for r, pl in plans.items()}
        writer.append(logs[3])  # the unshipped suffix dies with the primary
        t_dead = writer.t
        if lags != [0, 0] or not 0 < reps[0].t < t_max < t_dead:
            raise AssertionError(f"failover set-up: {lags}, {reps[0].t}, "
                                 f"{t_max}, {t_dead}")
        t0 = time.perf_counter()
        proc.kill()
        proc.wait(timeout=60)
        det = FailureDetector([probe], [reps],
                              lease=LeaseConfig(lease_misses=1), epoch=0)
        host = det.poll()[0]  # one missed beat: promote_on_primary_loss
        server = ShardServer(host).start()
        times["kill to promoted host"] = time.perf_counter() - t0
        servers.append(server)
        events = [e["event"] for e in det.events]
        if events != ["miss", "lease_expired", "promoted"] or det.epoch != 1 \
                or host.epoch != 1 or host.store.t != t_max \
                or host.state_hash() != h_max:
            raise AssertionError(f"failover: {det.events}")
        writer.transport = SocketTransport("127.0.0.1", server.port)
        try:  # the pre-failover writer, at epoch 0, against the new host
            writer.append(logs[3])
            raise AssertionError("a fenced writer committed")
        except p.RemoteError as e:
            if e.kind != "StaleEpochError":
                raise
        reader = RemoteShardClient(SocketTransport("127.0.0.1", server.port),
                                   device=dev)
        for r, pl in plans.items():
            ids, scores = reader.query(qf, K, pl)
            want = proven[r]
            if not (np.array_equal(ids, want[0].cpu().numpy())
                    and np.array_equal(scores, want[1].cpu().numpy())):
                raise AssertionError(f"promoted host {r} != the replica's")
        out["retries_failover"] = dict(
            clients=sum(c.transport.retries for c in (writer, probe)),
            replicas=sum(rep.primary.transport.retries for rep in reps),
            replica_faults=sum(rep.faults for rep in reps))
        reader.close()
        writer.close()
        probe.close()
        reps[0].close()
        out["failover"] = dict(t_lag=reps[0].t, t_max=t_max, t_dead=t_dead,
                               h_max=h_max, epoch=det.epoch, events=events)
    finally:
        if proc is not None:
            proc.kill()
            proc.wait(timeout=60)
        if eng is not None:
            eng.close()
        for srv in servers:
            srv.close()
            srv.host.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["times"] = times
    return out


def sharded_docs_s(sharded: dict) -> float:
    return SHARD_DOCS / sum(sharded["times"][f"ingest batch {i}"]
                            for i in range(SHARD_DOCS // BATCH))


def report_network(r, sharded: dict) -> None:
    for name, secs in r["times"].items():
        log(f"[network] {name}: {secs:.3f} s ({CARD[0]})")
    log(f"[network] golden wire: {r['golden_frames']} frames decoded and "
        f"re-encoded to the same bytes")
    per_batch = [r["times"][f"ingest batch {i}"]
                 for i in range(SHARD_DOCS // BATCH)]
    log(f"[network] ingest {SHARD_DOCS} docs through {SHARDS} shard hosts x "
        f"{SHARD_ROWS} rows, one following replica each, in "
        f"{sum(per_batch):.3f} s = {SHARD_DOCS / sum(per_batch):.1f} docs/s "
        f"(phase 6, in process: {sharded_docs_s(sharded):.1f}) "
        f"({CARD[0]})")
    c = r["conf"]
    log(f"[network] at {SHARD_DOCS} docs: memory_hash "
        f"{c['memory_hash']:#018x} and exact retrieval_hash "
        f"{c['exact']:#018x} equal phase 3's")
    log("[network] wire reads equal phase 6's (exact and coarse after its "
        "re-link, hnsw before it): " + ", ".join(
            f"{k} {v:#018x}" for k, v in r["h_wire"].items()))
    for route, ms in r["wire_ms"].items():
        rep, p6 = r["rep_ms"][route], sharded["read_ms"][route]
        log(f"[network] route={route}: wire cold {ms[0]:.3f} ms, p50 "
            f"{statistics.median(ms[1:]):.3f} ms over {len(ms) - 1}; "
            f"replica-served p50 {statistics.median(rep[1:]):.3f} ms; "
            f"phase 6 in process p50 {statistics.median(p6[1:]):.3f} ms "
            f"({CARD[0]})")
    log(f"[network] coarse at ef_coarse={r['cover_ef']} over the wire "
        f"equals the exact read; sync_replicas -> {r['lag']}; replica-served"
        f" reads equal the wire reads on every route")
    cmds, secs = r["catch_up_cmds"], r["times"]["sync_replicas"]
    log(f"[network] replica catch-up: the {SHARDS} followers had "
        f"{cmds} commands left to replay at sync_replicas, done in "
        f"{secs:.3f} s = {cmds / secs:.1f} commands/s ({CARD[0]})")
    t, h = r["merged"]
    log(f"[network] checkpoint over the wire: merged record t={t} {h} == "
        f"state_hash")
    f = r["failover"]
    log(f"[network] failover at {SIDE_CAPACITY} rows: replicas at "
        f"t={f['t_lag']} and t={f['t_max']}, primary SIGKILLed at "
        f"t={f['t_dead']}; detector events {f['events']}, epoch "
        f"{f['epoch']}; promoted host t={f['t_max']} {f['h_max']:#018x} == "
        f"the replica's proof; the epoch-0 writer is refused "
        f"(StaleEpochError); exact and coarse reads equal the replica's; "
        f"kill to promoted host {r['times']['kill to promoted host']:.3f} s "
        f"({CARD[0]})")
    log(f"[network] transport retries and replica faults ridden through "
        f"(each logged on stderr): networked engine {r['retries']}; "
        f"failover {r['retries_failover']}")
    if any(r["retries"].values()):
        print(f"chip_smoke: WARNING: the networked engine retried: "
              f"{r['retries']}", file=sys.stderr)
    log(f"[network] kernel launches on phase 7's main path: {r['counts']}")


# --------------------------------------------------------------------------- #
# phase 8: the LM serving path
# --------------------------------------------------------------------------- #


class EmbedProbe:
    """Stands in for an engine's ``_embed_batch``: each call's time (the
    card synchronized on both sides) and its float32 embeddings."""

    def __init__(self, torch, eng):
        self.torch, self.fn, self.calls = torch, eng._embed_batch, []
        eng._embed_batch = self

    def __call__(self, tokens):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = self.fn(tokens)
        self.torch.cuda.synchronize()
        self.calls.append((time.perf_counter() - t0, emb))
        return emb


def lm_inputs(cfg, rng, n_docs: int, n_warm: int):
    """Seeded tokens from ``rng``: n_docs documents of LM_DOC_LEN, 1 + n_warm
    query batches of QUERIES prompts (the first one cold) and the
    generation prompts (the first query prompts)."""
    docs = rng.integers(0, cfg.vocab_size, (n_docs, LM_DOC_LEN),
                        dtype=np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, (QUERIES, LM_PROMPT_LEN),
                            dtype=np.int32)
               for _ in range(1 + n_warm)]
    return docs, prompts, prompts[0][:GEN_PROMPTS]


def lm_generate_parts(torch, eng, tf, docs, gen_prompts, gen) -> dict:
    """``generate``'s two parts as the engine calls them, timed with CUDA
    events: the prefill of the augmented prompt and the greedy decode,
    whose tokens must be ``gen``, generate's own. The augmented prompt must
    be the top hit's first LM_CONTEXT tokens before the prompt, and its
    prefill logits must differ from the bare prompt's: the retrieved
    context reaches the model."""
    aug = eng._augmented(gen_prompts)
    top = eng.retrieve(gen_prompts)[0][:, 0]
    if not (np.array_equal(aug[:, LM_CONTEXT:], gen_prompts) and
            np.array_equal(aug[:, :LM_CONTEXT], docs[top, :LM_CONTEXT])):
        raise AssertionError("the augmented prompt != the top hit's tokens "
                             "+ the prompt")
    p, cfg, s_cache = eng.params, eng.cfg, eng.sc.s_cache

    def prefill(tokens):
        return tf.prefill(p, {"tokens": eng._tokens(tokens)}, cfg, s_cache)

    with torch.no_grad():
        prefill_ms = cuda_ms(torch, lambda: prefill(aug), iters=3, warmup=1)
        logits, caches = prefill(aug)
        ctx_diff = float((logits - prefill(gen_prompts)[0]).abs().max())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = tf.greedy_decode(p, logits, caches, aug.shape[1], GEN_NEW, cfg)
        end.record()
        torch.cuda.synchronize()
    if not ctx_diff > 0:
        raise AssertionError("the augmented prompt's prefill logits equal "
                             "the bare prompt's")
    if not np.array_equal(out.cpu().numpy(), gen):
        raise AssertionError("the timed prefill + decode != generate's tokens")
    return {"prefill_ms": prefill_ms, "ctx_logit_diff": ctx_diff,
            "decode_ms": start.elapsed_time(end) / (GEN_NEW - 1)}


def teacher_forced(torch, tf, p, toks, n_pre: int, s_cache: int, cfg):
    """[B, 1 + steps, V]: the logits of the prefill of ``toks[:, :n_pre]``,
    then of each teacher-forced decode step over the rest of ``toks``."""
    logits, caches = tf.prefill(p, {"tokens": toks[:, :n_pre]}, cfg, s_cache)
    out = [logits]
    for t in range(n_pre, toks.shape[1]):
        pos = torch.full((toks.shape[0], 1), t, dtype=torch.int32,
                         device=toks.device)
        logits, caches = tf.decode_step(p, caches, toks[:, t:t + 1], pos, cfg)
        out.append(logits)
    return torch.stack(out, 1)


def lm_numerics(torch, dev, tf, boundary, params, cfg, tokens) -> dict:
    """The model's first local/global pair (layers 0-1) and its head: a
    copy on the CPU in f32 against the card in f32 (the pooled embeddings
    of ``tokens``; the logits of generate's prefill length and of
    LM_NUMERICS_STEPS teacher-forced decode steps, with the main path's
    s_cache and with half the prefill's length, so that the prefill keeps
    its last positions and the decode writes wrap), and the card's bf16
    embeddings against the CPU's f32 ones after the boundary."""
    import copy
    pair = torch.nn.Module()
    pair.embed = params.embed
    pair.blocks = torch.nn.ModuleList(list(params.blocks)[:2])
    pair.final_norm = params.final_norm
    if not cfg.tie_embeddings:
        pair.lm_head = params.lm_head
    bf16 = dataclasses.replace(cfg, num_layers=2)
    f32 = dataclasses.replace(bf16, dtype="float32")
    t0 = time.perf_counter()
    cpu_pair = copy.deepcopy(pair).to("cpu")
    copy_s = time.perf_counter() - t0
    n_pre = LM_CONTEXT + LM_PROMPT_LEN  # generate's prefill length
    seq = np.concatenate([tokens, tokens], 1)[:, :n_pre + LM_NUMERICS_STEPS]
    s_caches = (LM_S_CACHE, n_pre // 2)

    def run(p, dv):
        toks, s_toks = (torch.as_tensor(x, device=dv) for x in (tokens, seq))
        return (tf.pooled_embedding(p, toks, f32),
                [teacher_forced(torch, tf, p, s_toks, n_pre, s, f32)
                 for s in s_caches])

    with torch.no_grad():
        t0 = time.perf_counter()
        e_cpu, l_cpu = run(cpu_pair, "cpu")
        cpu_s = time.perf_counter() - t0
        e_card, l_card = run(pair, dev)
        e_card, l_card = e_card.cpu(), [x.cpu() for x in l_card]
        e_bf16 = tf.pooled_embedding(pair, torch.as_tensor(tokens, device=dev),
                                     bf16).cpu()

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def words(a, b):
        ra = boundary.normalize_embedding(a).to(torch.int64)
        rb = boundary.normalize_embedding(b).to(torch.int64)
        diff = (ra - rb).abs()
        return int((diff != 0).sum()), int(diff.max()), diff.numel()

    logit_rel = {s: [rel(g[:, i], w[:, i]) for i in range(g.shape[1])]
                 for s, g, w in zip(s_caches, l_card, l_cpu)}
    out = dict(emb_rel=rel(e_card, e_cpu), logit_rel=logit_rel, n_pre=n_pre,
               words_f32=words(e_card, e_cpu), words_bf16=words(e_bf16, e_cpu),
               bf16_rel=rel(e_bf16, e_cpu), copy_s=copy_s, cpu_s=cpu_s,
               finite=bool(torch.isfinite(e_bf16).all() and all(
                   torch.isfinite(x).all() for x in l_card)))
    if not out["finite"]:
        raise AssertionError("lm numerics: non-finite values")
    worst = max(max(v) for v in logit_rel.values())
    if max(out["emb_rel"], worst) > LM_F32_REL_TOL:
        raise AssertionError(
            f"the first pair in f32: card against CPU {out['emb_rel']:.3g} "
            f"(embeddings), {worst:.3g} (prefill and decode logits) > "
            f"{LM_F32_REL_TOL}")
    return out


def run_lm_durable(torch, dev, cfg, params, docs, gen_prompts) -> dict:
    """The durable LM engine over SIDE_CAPACITY rows: ingest, crash (the
    engine dropped without ``close``), recover to the same (t, hash) with
    the doc cache reloaded from ``docs.sdt``, the same generation, then
    ``rollback_to`` the checkpoint with every live id's tokens warm (the
    rolled-away ids' records stay loaded and inert, as in the reference)."""
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return res

    with tempfile.TemporaryDirectory() as tmp:
        sc = ServeConfig(capacity=SIDE_CAPACITY, retrieve_k=K, ef=EF,
                         s_cache=LM_S_CACHE, context_tokens=LM_CONTEXT,
                         max_new_tokens=GEN_NEW, durable_dir=tmp,
                         checkpoint_every=LM_CHECKPOINT_EVERY)
        eng = timed("engine + genesis snapshot", lambda: MemoryAugmentedEngine(
            cfg, params, sc, device=dev))
        h_at = {}
        for i in range(0, LM_DURABLE_DOCS, LM_DURABLE_BATCH):
            timed(f"ingest {i}-{i + LM_DURABLE_BATCH}",
                  lambda i=i: eng.insert_documents(
                      docs[i:i + LM_DURABLE_BATCH]))
            h_at[eng._cursor()] = eng.state_hash()
        timed("wait for the checkpoint", eng.wait_durable)
        t_pre, h_pre = eng.durable.t, eng.state_hash()
        gen_pre = timed("generate", lambda: eng.generate(gen_prompts))
        snaps = eng.durable.snapshots()
        del eng  # the crash: no close, no flush

        eng = MemoryAugmentedEngine(cfg, params, sc, device=dev)
        t, h = timed("recover", eng.recover)
        if (t, h) != (t_pre, h_pre):
            raise AssertionError(f"durable LM recover: ({t}, {h:#x}) != "
                                 f"({t_pre}, {h_pre:#x})")
        if sorted(eng.docs) != list(range(LM_DURABLE_DOCS)) or any(
                not np.array_equal(eng.docs[i], docs[i])
                for i in range(LM_DURABLE_DOCS)):
            raise AssertionError("recovered doc cache != the ingested tokens")
        gen_post = timed("generate after recover",
                         lambda: eng.generate(gen_prompts))
        if not np.array_equal(gen_pre, gen_post):
            raise AssertionError("generate after recover != before the crash")
        t_rb, h_rb = timed("rollback_to the checkpoint",
                           lambda: eng.rollback_to(LM_CHECKPOINT_EVERY))
        live = sorted(eng.memory.ids[eng.memory.valid].cpu().tolist())
        if h_rb != h_at[LM_CHECKPOINT_EVERY] \
                or live != list(range(LM_CHECKPOINT_EVERY)) \
                or sorted(eng.docs) != list(range(LM_DURABLE_DOCS)) \
                or any(not np.array_equal(eng.docs[i], docs[i]) for i in live):
            raise AssertionError("rollback: hash or warm doc cache differs")
        eng.close()
    return dict(times=times, t=t, h=h, snaps=snaps, t_rb=t_rb, h_rb=h_rb,
                gen=gen_post)


def run_lm(torch, dev, seed: int, cfg=None) -> dict:
    """Phase 8: gemma2-2b at full width on the card (``cfg`` replaces it in
    a CPU rehearsal), served by ``MemoryAugmentedEngine(cfg, params,
    ...)``: token ingest, retrieval on the auto route (exact at LM_DOCS
    live rows), augmented generation twice, the audit; the card's boundary
    against the CPU's on one ingest batch; the first pair's numerics; the
    durable LM engine. Returns the times, the checks' values and the
    kernel launches of the phase's main path."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import boundary
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig

    cfg = cfg or get_config(LM_ARCH)
    # the engine ingests the first LM_DOCS, the durable engine the first
    # LM_DURABLE_DOCS
    docs, prompts, gen_prompts = lm_inputs(
        cfg, np.random.default_rng(seed + 8), max(LM_DOCS, LM_DURABLE_DOCS),
        LM_QUERY_BATCHES)
    fresh_card(torch)
    params, out = init_lm(torch, dev, cfg, seed)
    eng = MemoryAugmentedEngine(cfg, params, ServeConfig(
        capacity=CAPACITY, retrieve_k=K, ef=EF, s_cache=LM_S_CACHE,
        context_tokens=LM_CONTEXT, max_new_tokens=GEN_NEW), device=dev)
    probe = EmbedProbe(torch, eng)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()  # ---- the main path starts here ----
    ingest_s = []
    for i in range(0, LM_DOCS, BATCH):
        t0 = time.perf_counter()
        eng.insert_documents(docs[i:i + BATCH])
        torch.cuda.synchronize()
        ingest_s.append(time.perf_counter() - t0)
    n_ingest = len(ingest_s)
    read_ms, embed_ms, answers = [], [], []
    for q in prompts:
        n0 = len(probe.calls)
        t0 = time.perf_counter()
        answers.append(eng.retrieve(q))
        read_ms.append((time.perf_counter() - t0) * 1e3)
        embed_ms.append(probe.calls[n0][0] * 1e3)
    out["plan"] = eng.last_plan
    gens, gen_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        gens.append(eng.generate(gen_prompts))
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    counts = phase_counts(kernels)  # ---- the main path ends here ----
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    require(counts, LM_PATH, "the LM path")
    if out["plan"].route != "exact":
        raise AssertionError(f"auto route at {LM_DOCS} rows: "
                             f"{out['plan'].route}, not exact")
    for ids, _ in answers:
        if ids.shape != (QUERIES, K) or (ids < 0).any() \
                or (ids >= LM_DOCS).any():
            raise AssertionError("lm retrieve: malformed answer")
    if not np.array_equal(gens[0], gens[1]):
        raise AssertionError("generate did not repeat itself")
    if gens[0].shape != (GEN_PROMPTS, GEN_NEW) or gens[0].min() < 0 \
            or gens[0].max() >= cfg.vocab_size:
        raise AssertionError("generate: malformed tokens")

    t0 = time.perf_counter()
    h_state, h_replay = eng.state_hash(), eng.replay_log_fresh()
    out["audit_s"] = time.perf_counter() - t0
    if h_state != h_replay:
        raise AssertionError("lm engine: replay_log_fresh() != state_hash()")
    # the card's boundary against the CPU's, on one ingest batch's floats
    emb = probe.calls[0][1].cpu()
    raw = boundary.normalize_embedding(emb, eng.sc.contract)
    if not (bool(torch.isfinite(emb).all())
            and torch.equal(raw, eng.log.vec[:BATCH].cpu())):
        raise AssertionError("the CPU's boundary != the rows the card logged")
    out["steps"] = lm_generate_parts(torch, eng, tf, docs, gen_prompts,
                                     gens[0])
    out["numerics"] = lm_numerics(torch, dev, tf, boundary, params, cfg,
                                  docs[:LM_NUMERICS_DOCS])
    out.update(
        counts=counts, h_state=h_state, memory_hash=eng.memory_hash(),
        ingest_s=ingest_s, embed_ingest_s=[probe.calls[i][0]
                                           for i in range(n_ingest)],
        read_ms=read_ms, embed_ms=embed_ms, gen_s=gen_s, gen=gens[0])
    eng.close()
    del eng, probe
    out["durable"] = run_lm_durable(torch, dev, cfg, params, docs,
                                    gen_prompts)
    return out


def report_lm(r) -> None:
    cfg, card = r["cfg"], CARD[0]
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"vocabulary {cfg.vocab_size}, {cfg.dtype} compute over "
        f"{cfg.param_dtype} parameters: {r['n_params']} parameters, "
        f"initialized on the card in {r['init_s']:.3f} s ({card})")
    n = len(r["ingest_s"])
    emb, tot = r["embed_ingest_s"], r["ingest_s"]
    log(f"[lm] ingest {LM_DOCS} docs of {LM_DOC_LEN} tokens in {n} batches "
        f"of {BATCH}: {sum(tot):.3f} s = {LM_DOCS / sum(tot):.1f} docs/s; "
        f"LM embed per batch " + ", ".join(f"{1e3 * e:.1f}" for e in emb)
        + " ms; boundary + apply per batch " + ", ".join(
            f"{1e3 * (t - e):.1f}" for t, e in zip(tot, emb)) + f" ms ({card})")
    warm = list(zip(r["read_ms"][1:], r["embed_ms"][1:]))
    med = statistics.median
    log(f"[lm] retrieve {QUERIES} prompts of {LM_PROMPT_LEN} tokens, k={K}, "
        f"route {r['plan'].route} ({r['plan'].reason}): cold "
        f"{r['read_ms'][0]:.3f} ms, then {len(warm)} batches p50 "
        f"{med(a for a, _ in warm):.3f} ms = embed p50 "
        f"{med(e for _, e in warm):.3f} + search p50 "
        f"{med(a - e for a, e in warm):.3f} ({card})")
    st = r["steps"]
    toks = GEN_PROMPTS * GEN_NEW
    log(f"[lm] generate {GEN_PROMPTS} x {GEN_NEW} tokens, augmented with "
        f"{LM_CONTEXT} context tokens: {r['gen_s'][0]:.3f} s, then "
        f"{r['gen_s'][1]:.3f} s = {toks / r['gen_s'][1]:.1f} tokens/s, the "
        f"same tokens both times; prefill [{GEN_PROMPTS}, "
        f"{LM_CONTEXT + LM_PROMPT_LEN}] {st['prefill_ms']:.3f} ms, decode "
        f"{st['decode_ms']:.3f} ms per step (CUDA events; {card}); the "
        f"augmented prompt's prefill logits differ from the bare prompt's "
        f"by up to {st['ctx_logit_diff']:.4g}")
    log(f"[lm] peak device memory {r['peak_bytes'] / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated; {card})")
    log(f"[lm] audit: replay_log_fresh == state_hash {r['h_state']:#018x} "
        f"({r['audit_s']:.1f} s); memory_hash {r['memory_hash']:#018x}; "
        f"first generated tokens {r['gen'][0, :8].tolist()}")
    log(f"[lm] boundary: the card's float embeddings of ingest batch 0, "
        f"normalized on the CPU, equal the rows the card logged, bit for bit")
    nm = r["numerics"]
    log(f"[lm] first local/global pair + head in f32, card against CPU: "
        f"max relative error {nm['emb_rel']:.3g} (pooled embeddings); "
        + "; ".join(
            f"s_cache {s}: prefill [{LM_NUMERICS_DOCS}, {nm['n_pre']}] "
            f"logits {v[0]:.3g}, teacher-forced decode steps "
            + ", ".join(f"{x:.3g}" for x in v[1:])
            for s, v in nm["logit_rel"].items())
        + f"; tolerance {LM_F32_REL_TOL}; copy to the CPU "
        f"{nm['copy_s']:.1f} s, CPU run {nm['cpu_s']:.1f} s")
    for name in ("words_f32", "words_bf16"):
        k, mx, total = nm[name]
        log(f"[lm] after the boundary: {k} of {total} Q16.16 words differ "
            f"(max {mx}) between the card's "
            f"{'f32' if name == 'words_f32' else 'bf16'} pair embeddings "
            f"and the CPU's f32 ones"
            + (f" (relative error before it {nm['bf16_rel']:.3g})"
               if name == "words_bf16" else ""))
    d = r["durable"]
    for name, secs in d["times"].items():
        log(f"[lm] durable {name}: {secs:.3f} s ({card})")
    log(f"[lm] durable LM engine ({SIDE_CAPACITY} rows, checkpoint_every="
        f"{LM_CHECKPOINT_EVERY}, snapshots {d['snaps']}): recover -> t="
        f"{d['t']} {d['h']:#018x} == before the crash, doc cache reloaded "
        f"from docs.sdt, the same {GEN_PROMPTS} x {GEN_NEW} tokens; "
        f"rollback_to({d['t_rb']}) -> {d['h_rb']:#018x} with every live "
        f"id's tokens cached")
    log(f"[lm] kernel launches on phase 8's main path: {r['counts']}")


# --------------------------------------------------------------------------- #
# phase 9: the moe, ssm and hybrid LMs
# --------------------------------------------------------------------------- #


def lm_params(cfg) -> int:
    """The parameter count of the reference's init: ``param_count()`` at
    the padded vocabulary and expert count, plus what it leaves out of a
    Mamba2 layer (the conv bias and the third head vector)."""
    n = dataclasses.replace(cfg, vocab_size=cfg.padded_vocab,
                            num_experts=cfg.padded_experts).param_count()
    if cfg.family in ("ssm", "hybrid"):
        n += cfg.num_layers * (cfg.d_inner + 2 * cfg.ssm_ngroups
                               * cfg.ssm_state + cfg.ssm_nheads)
    return n


def init_lm(torch, dev, cfg, seed: int):
    """``cfg``'s LM on ``dev`` from the seed, its parameter count checked
    against the reference's; returns (params, a record of the config, the
    init time and the count)."""
    from repro_torch.models import transformer as tf
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    params.requires_grad_(False)
    torch.cuda.synchronize()
    out = dict(cfg=cfg, init_s=time.perf_counter() - t0,
               n_params=sum(p.numel() for p in params.parameters()))
    if out["n_params"] != lm_params(cfg):
        raise AssertionError(f"{cfg.name}: {out['n_params']} parameters != "
                             f"{lm_params(cfg)}")
    return params, out


def family_cut(torch, params, cfg):
    """The first layers of ``params`` as a model of their own (embedding
    and head shared, not copied), its config and a description: the first
    MoE layer, the first 2 mamba layers, or the hybrid's first group (its
    shared block and hybrid_period mamba layers)."""
    cut = torch.nn.Module()
    cut.embed, cut.final_norm = params.embed, params.final_norm
    if not cfg.tie_embeddings:
        cut.lm_head = params.lm_head
    if cfg.family == "hybrid":
        cut.blocks = torch.nn.ModuleList(list(params.blocks)[:1])
        cut.shared = torch.nn.ModuleList(list(params.shared)[:1])
        return cut, dataclasses.replace(cfg, num_layers=cfg.hybrid_period,
                                        num_shared_blocks=1), (
            f"first group (shared block + {cfg.hybrid_period} mamba layers)")
    n = 1 if cfg.family == "moe" else 2
    cut.blocks = torch.nn.ModuleList(list(params.blocks)[:n])
    return cut, dataclasses.replace(cfg, num_layers=n), (
        f"first {n} layer{'s' if n > 1 else ''}")


class RouteLog:
    """While active, records each MoE call's expert choices [T, K] (on the
    CPU) by wrapping ``moe._route``."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.route = self.moe._route

        def route(params, xt, cfg):
            out = self.route(params, xt, cfg)
            self.calls.append(out[2].cpu())
            return out

        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route


def family_numerics(torch, dev, tf, moe, params, cfg, tokens, long_tokens
                    ) -> dict:
    """The depth-cut copy (``family_cut``) on the CPU in f32 against the
    card in f32: pooled embeddings of ``tokens``; the logits of a prefill
    of generate's length and LM_NUMERICS_STEPS teacher-forced decode steps;
    for the ssm and hybrid families the same over ``long_tokens``
    (SSM_LONG tokens, then the steps). Every (token, rank) expert choice
    of the card is compared with the CPU's; the tolerance holds on the
    documents whose choices all agree. Returns {check: (relative error,
    documents held, choices that differ)}."""
    import copy
    cut, cut_cfg, what = family_cut(torch, params, cfg)
    f32 = dataclasses.replace(cut_cfg, dtype="float32")
    t0 = time.perf_counter()
    cpu_cut = copy.deepcopy(cut).to("cpu")
    copy_s = time.perf_counter() - t0
    n_pre = LM_CONTEXT + LM_PROMPT_LEN
    seq = np.concatenate([tokens, tokens], 1)[:, :n_pre + LM_NUMERICS_STEPS]
    runs = {"pooled embeddings": lambda p, t: tf.pooled_embedding(p, t(tokens),
                                                                  f32),
            f"prefill {n_pre} + {LM_NUMERICS_STEPS} decode steps":
                lambda p, t: teacher_forced(torch, tf, p, t(seq), n_pre,
                                            LM_S_CACHE, f32)}
    if cfg.family in ("ssm", "hybrid"):
        runs[f"pooled embeddings of {SSM_LONG} tokens"] = \
            lambda p, t: tf.pooled_embedding(p, t(long_tokens[:, :SSM_LONG]),
                                             f32)
        runs[f"prefill {SSM_LONG} + {LM_NUMERICS_STEPS} decode steps"] = \
            lambda p, t: teacher_forced(torch, tf, p, t(long_tokens),
                                        SSM_LONG, SSM_LONG + LM_S_CACHE, f32)
    out, cpu_s = {}, 0.0
    for name, fn in runs.items():
        logs = []
        for p, dv in ((cpu_cut, "cpu"), (cut, dev)):
            with torch.no_grad(), RouteLog(moe) as rl:
                t0 = time.perf_counter()
                val = fn(p, lambda x: torch.as_tensor(x, device=dv)).cpu()
                if dv == "cpu":
                    cpu_s += time.perf_counter() - t0
            logs.append((val, rl.calls))
        (want, c_cpu), (got, c_card) = logs
        if got.ndim == 3:  # logits: the padded vocabulary rows hold -1e30
            got, want = got[..., :cfg.vocab_size], want[..., :cfg.vocab_size]
        if not (bool(torch.isfinite(got).all()) and got.shape == want.shape
                and len(c_cpu) == len(c_card)):
            raise AssertionError(f"{cfg.name} {name}: non-finite or "
                                 f"malformed output")
        held = torch.ones(got.shape[0], dtype=torch.bool)
        differ = 0
        for a, b in zip(c_cpu, c_card):
            same = a == b
            differ += int((~same).sum())
            held &= same.reshape(got.shape[0], -1).all(dim=1)
        if not held.any():
            raise AssertionError(f"{cfg.name} {name}: every document routed "
                                 f"differently on the card")
        rel = float((got[held] - want[held]).abs().max() / want.abs().max())
        if rel > LM_F32_REL_TOL:
            raise AssertionError(f"{cfg.name} {name} in f32: card against "
                                 f"CPU {rel:.3g} > {LM_F32_REL_TOL}")
        out[name] = (rel, int(held.sum()), differ)
    return dict(checks=out, copy_s=copy_s, cpu_s=cpu_s, what=what)


def run_family(torch, dev, seed: int, arch: str, cfg=None) -> dict:
    """Phase 9, one arch: its CONFIG at full width and depth (``cfg``
    replaces it in a CPU rehearsal) behind ``MemoryAugmentedEngine`` over
    SIDE_CAPACITY rows: one ingest batch, reads on the auto route (exact),
    augmented generation twice, the audit, the boundary identity, the
    pooled embeddings' repeatability, generate's parts and the f32 cut
    copy against the CPU. Returns the times, the checks' values and the
    kernel launches of the main path."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import boundary
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import moe
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the f32 router and SSD "
                             "would round to 10 mantissa bits")
    cfg = cfg or get_config(arch)
    rng = np.random.default_rng(seed + 9)
    docs, prompts, gen_prompts = lm_inputs(cfg, rng, FAMILY_DOCS,
                                           FAMILY_QUERY_BATCHES)
    long_tokens = rng.integers(0, cfg.vocab_size, (
        LM_NUMERICS_DOCS, SSM_LONG + LM_NUMERICS_STEPS), dtype=np.int32)
    fresh_card(torch)
    params, out = init_lm(torch, dev, cfg, seed)
    eng = MemoryAugmentedEngine(cfg, params, ServeConfig(
        capacity=SIDE_CAPACITY, retrieve_k=K, ef=EF, s_cache=LM_S_CACHE,
        context_tokens=LM_CONTEXT, max_new_tokens=GEN_NEW), device=dev)
    probe = EmbedProbe(torch, eng)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()  # ---- the main path starts here ----
    t0 = time.perf_counter()
    eng.insert_documents(docs)
    torch.cuda.synchronize()
    out["ingest_s"] = time.perf_counter() - t0
    read_ms, embed_ms, answers = [], [], []
    for q in prompts:
        n0 = len(probe.calls)
        t0 = time.perf_counter()
        answers.append(eng.retrieve(q))
        read_ms.append((time.perf_counter() - t0) * 1e3)
        embed_ms.append(probe.calls[n0][0] * 1e3)
    out["plan"] = eng.last_plan
    gens, gen_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        gens.append(eng.generate(gen_prompts))
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    counts = phase_counts(kernels)  # ---- the main path ends here ----
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    require(counts, LM_PATH, f"{cfg.name}'s path")
    if out["plan"].route != "exact":
        raise AssertionError(f"{cfg.name}: auto route at {FAMILY_DOCS} rows: "
                             f"{out['plan'].route}, not exact")
    for ids, _ in answers:
        if ids.shape != (QUERIES, K) or (ids < 0).any() \
                or (ids >= FAMILY_DOCS).any():
            raise AssertionError(f"{cfg.name} retrieve: malformed answer")
    if not np.array_equal(gens[0], gens[1]):
        raise AssertionError(f"{cfg.name}: generate did not repeat itself")
    if gens[0].shape != (GEN_PROMPTS, GEN_NEW) or gens[0].min() < 0 \
            or gens[0].max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name} generate: malformed tokens")

    t0 = time.perf_counter()
    h_state, h_replay = eng.state_hash(), eng.replay_log_fresh()
    out["audit_s"] = time.perf_counter() - t0
    if h_state != h_replay:
        raise AssertionError(f"{cfg.name}: replay_log_fresh() != "
                             f"state_hash()")
    emb = probe.calls[0][1]
    raw = boundary.normalize_embedding(emb.cpu(), eng.sc.contract)
    if not (bool(torch.isfinite(emb).all())
            and torch.equal(raw, eng.log.vec[:FAMILY_DOCS].cpu())):
        raise AssertionError(f"{cfg.name}: the CPU's boundary != the rows "
                             f"the card logged")
    # the ingest batch's pooled embeddings once more: the same bits (no
    # atomics in the MoE dispatch, no run-to-run choice anywhere)
    with torch.no_grad():
        again = tf.pooled_embedding(params, eng._tokens(docs), cfg)
    if not torch.equal(again, emb):
        raise AssertionError(f"{cfg.name}: pooled embeddings differ between "
                             f"two runs on the card")
    out["steps"] = lm_generate_parts(torch, eng, tf, docs, gen_prompts,
                                     gens[0])
    out["numerics"] = family_numerics(torch, dev, tf, moe, params, cfg,
                                      docs[:LM_NUMERICS_DOCS], long_tokens)
    out.update(counts=counts, h_state=h_state, memory_hash=eng.memory_hash(),
               embed_ingest_s=probe.calls[0][0], read_ms=read_ms,
               embed_ms=embed_ms, gen_s=gen_s, gen=gens[0])
    eng.close()
    return out


def fresh_card(torch) -> None:
    """Free what earlier models left (an engine and its ``EmbedProbe``
    hold each other, so only the collector frees them) and restart the
    peak-memory count, so the next model's peak is its own."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def run_phi(torch, dev, seed: int, cfg=None) -> dict:
    """Phase 9, phi3.5-moe at full width with PHI_LAYERS layers (``cfg``
    replaces it in a CPU rehearsal): generate's prefill ([GEN_PROMPTS,
    LM_CONTEXT + LM_PROMPT_LEN]) and GEN_NEW greedy tokens twice, equal,
    timed with CUDA events; then its first layer and head in f32 against
    the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import moe
    cfg = cfg or dataclasses.replace(get_config(PHI_ARCH),
                                     num_layers=PHI_LAYERS)
    rng = np.random.default_rng(seed + 10)
    prompts = rng.integers(0, cfg.vocab_size,
                           (GEN_PROMPTS, LM_CONTEXT + LM_PROMPT_LEN),
                           dtype=np.int32)
    docs = rng.integers(0, cfg.vocab_size, (LM_NUMERICS_DOCS, LM_DOC_LEN),
                        dtype=np.int32)
    fresh_card(torch)
    params, out = init_lm(torch, dev, cfg, seed)
    toks = torch.as_tensor(prompts, device=dev)
    gens, ms = [], []
    with torch.no_grad():
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            mid = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, caches = tf.prefill(params, {"tokens": toks}, cfg,
                                        LM_S_CACHE)
            mid.record()
            gens.append(tf.greedy_decode(params, logits, caches,
                                         toks.shape[1], GEN_NEW, cfg).cpu())
            end.record()
            torch.cuda.synchronize()
            ms.append((start.elapsed_time(mid),
                       mid.elapsed_time(end) / (GEN_NEW - 1)))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if not torch.equal(gens[0], gens[1]):
        raise AssertionError(f"{cfg.name}: greedy decode did not repeat")
    if gens[0].min() < 0 or gens[0].max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: malformed tokens")
    out.update(gen=gens[0], ms=ms, numerics=family_numerics(
        torch, dev, tf, moe, params, cfg, docs, None))
    return out


def report_model(r, tag: str) -> None:
    """A phase 9 model's size and init time, its peak memory and its cut
    copy's f32 checks against the CPU."""
    cfg, card = r["cfg"], CARD[0]
    log(f"[{tag}] {cfg.name} ({cfg.family}): {cfg.num_layers} layers, "
        f"d={cfg.d_model}, vocabulary {cfg.vocab_size}, {cfg.dtype} over "
        f"{cfg.param_dtype}: {r['n_params']} parameters, initialized on the "
        f"card in {r['init_s']:.3f} s; peak device memory "
        f"{r['peak_bytes'] / 2**30:.2f} GiB (torch.cuda.max_memory_allocated;"
        f" {card})")
    nm = r["numerics"]
    for name, (rel, held, differ) in nm["checks"].items():
        log(f"[{tag}] {cfg.name} {nm['what']} + head in f32, card against "
            f"CPU, {name} [{LM_NUMERICS_DOCS} docs]: max relative error "
            f"{rel:.3g} over {held} documents held (tolerance "
            f"{LM_F32_REL_TOL}); {differ} (token, rank) expert choices "
            f"differ")
    log(f"[{tag}] {cfg.name} copy to the CPU {nm['copy_s']:.1f} s, CPU runs "
        f"{nm['cpu_s']:.1f} s")


def report_family(r) -> None:
    cfg, card = r["cfg"], CARD[0]
    report_model(r, "families")
    e = r["embed_ingest_s"]
    log(f"[families] {cfg.name} ingest {FAMILY_DOCS} docs of {LM_DOC_LEN} "
        f"tokens in one batch: {r['ingest_s']:.3f} s = "
        f"{FAMILY_DOCS / r['ingest_s']:.1f} docs/s; LM embed {1e3 * e:.1f} "
        f"ms, boundary + apply {1e3 * (r['ingest_s'] - e):.1f} ms ({card})")
    warm = list(zip(r["read_ms"][1:], r["embed_ms"][1:]))
    med = statistics.median
    log(f"[families] {cfg.name} retrieve {QUERIES} prompts of "
        f"{LM_PROMPT_LEN} tokens, k={K}, route {r['plan'].route}: cold "
        f"{r['read_ms'][0]:.3f} ms, then {len(warm)} batches p50 "
        f"{med(a for a, _ in warm):.3f} ms = embed p50 "
        f"{med(e for _, e in warm):.3f} + search p50 "
        f"{med(a - e for a, e in warm):.3f} ({card})")
    st = r["steps"]
    log(f"[families] {cfg.name} generate {GEN_PROMPTS} x {GEN_NEW} tokens, "
        f"augmented: {r['gen_s'][0]:.3f} s, then {r['gen_s'][1]:.3f} s = "
        f"{GEN_PROMPTS * GEN_NEW / r['gen_s'][1]:.1f} tokens/s, the same "
        f"tokens both times; prefill [{GEN_PROMPTS}, "
        f"{LM_CONTEXT + LM_PROMPT_LEN}] {st['prefill_ms']:.3f} ms, decode "
        f"{st['decode_ms']:.3f} ms per step (CUDA events; {card}); the "
        f"context moves the prefill logits by up to "
        f"{st['ctx_logit_diff']:.4g}")
    log(f"[families] {cfg.name} audit: replay_log_fresh == state_hash "
        f"{r['h_state']:#018x} ({r['audit_s']:.1f} s); memory_hash "
        f"{r['memory_hash']:#018x}; the card's boundary == the CPU's on the "
        f"card's floats; the batch's pooled embeddings repeat bit for bit; "
        f"first tokens {r['gen'][0, :8].tolist()}")
    log(f"[families] {cfg.name} kernel launches: {r['counts']}")


def report_phi(r) -> None:
    report_model(r, "families")
    for i, (pre, dec) in enumerate(r["ms"]):
        log(f"[families] {r['cfg'].name} prefill [{GEN_PROMPTS}, "
            f"{LM_CONTEXT + LM_PROMPT_LEN}] {pre:.3f} ms, greedy decode "
            f"{dec:.3f} ms per step (run {i + 1}, CUDA events; {CARD[0]}); "
            f"the same {GEN_PROMPTS} x {GEN_NEW} tokens both times, first "
            f"{r['gen'][0, :8].tolist()}")

# --------------------------------------------------------------------------- #
# phase 10: training
# --------------------------------------------------------------------------- #


def flagged_ops(torch, fn):
    """(``fn()``, the first line of each warning about determinism that
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` raises
    while it runs): the ops PyTorch knows to be nondeterministic on the
    card. The mode is switched off again before anything else runs."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.use_deterministic_algorithms(False)
    return out, sorted({str(w.message).split("\n")[0] for w in caught
                        if "eterministic" in str(w.message)})


def train_twice(torch, dev, seed: int, cfg) -> dict:
    """(a) ``cfg`` from the seed on ``dev``: TRAIN_STEPS steps of
    ``make_train_step`` on the pipeline's batches, then the same again from
    a fresh init. The losses, gradient norms and the ``hash_state_device``
    of the parameters in the reference's layout must repeat bit for bit."""
    from repro_torch.core import hashing
    from repro_torch.data.pipeline import DataConfig, DeterministicPipeline
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step, train_state
    data = DeterministicPipeline(DataConfig(
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        vocab_size=cfg.vocab_size, seed=seed))
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                            total_steps=TRAIN_STEPS))
    runs = []
    for _ in range(2):
        fresh_card(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tf.init_params(cfg, torch.Generator(dev).manual_seed(seed))
        opt = adamw_init(params)
        torch.cuda.synchronize()
        run = dict(init_s=time.perf_counter() - t0, ms=[], losses=[],
                   gnorms=[])
        for s in range(TRAIN_STEPS):
            batch = data.batch(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = step(params, opt, batch)
            torch.cuda.synchronize()
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            run["losses"].append(m["loss"].item())
            run["gnorms"].append(m["grad_norm"].item())
        run["peak_bytes"] = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        state = train_state(params, opt, cfg)
        run["hash"] = hashing.hash_state_device(state["params"])
        torch.cuda.synchronize()
        run["hash_s"] = time.perf_counter() - t0
        run["n_params"] = sum(p.numel() for p in params.parameters())
        runs.append(run)
        del params, opt, state, m
    a, b = runs
    if (a["losses"], a["gnorms"], a["hash"]) != \
            (b["losses"], b["gnorms"], b["hash"]):
        raise AssertionError(f"{cfg.name}: a second training run from the "
                             f"seed differs: {a} vs {b}")
    if not all(np.isfinite(a["losses"] + a["gnorms"])):
        raise AssertionError(f"{cfg.name}: non-finite loss or gradient norm")
    return dict(cfg=cfg, runs=runs)


def train_cut_numerics(torch, dev, seed: int, cfg) -> dict:
    """(b) ``cfg`` cut to TRAIN_CUT_LAYERS layers in f32, from the seed on
    the card and copied to the CPU: one batch of TRAIN_CUT_SEQ tokens, the
    loss, the gradient norm and every gradient leaf of both, held to
    TRAIN_LOSS_REL, TRAIN_GNORM_REL and TRAIN_GRAD_REL. The card's step
    runs under the deterministic mode, which lists the ops it flags."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.step import loss_and_grads
    cut = dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS,
                              dtype="float32")
    rng = np.random.default_rng(seed + 11)
    toks = rng.integers(0, cfg.vocab_size, (1, TRAIN_CUT_SEQ + 1),
                        dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fresh_card(torch)
    params = tf.init_params(cut, torch.Generator(dev).manual_seed(seed))
    (m_dev, g_dev), flagged = flagged_ops(
        torch, lambda: loss_and_grads(params, batch, cut))
    gn_dev = global_norm(g_dev).item()
    g_dev = {k: v.cpu() for k, v in g_dev.items()}
    t0 = time.perf_counter()
    cpu = tf.init_params(cut, None).to_empty(device="cpu")
    cpu.load_state_dict(params.state_dict())
    del params
    m_cpu, g_cpu = loss_and_grads(cpu, batch, cut)
    cpu_s = time.perf_counter() - t0
    gn_cpu = global_norm(g_cpu).item()

    def rel(got, want):
        return float(torch.linalg.vector_norm((got - want).double())
                     / torch.linalg.vector_norm(want.double()))

    leaves = {k: rel(g_dev[k], g_cpu[k]) for k in g_cpu}
    worst = max(leaves, key=leaves.get)
    out = dict(cut=cut, loss=(m_dev["loss"].item(), m_cpu["loss"].item()),
               gnorm=(gn_dev, gn_cpu), worst=(worst, leaves[worst]),
               n_leaves=len(leaves), cpu_s=cpu_s, flagged=flagged)
    loss_rel = abs(out["loss"][0] - out["loss"][1]) / abs(out["loss"][1])
    gn_rel = abs(gn_dev - gn_cpu) / gn_cpu
    out.update(loss_rel=loss_rel, gnorm_rel=gn_rel)
    if loss_rel > TRAIN_LOSS_REL or gn_rel > TRAIN_GNORM_REL \
            or leaves[worst] > TRAIN_GRAD_REL:
        raise AssertionError(
            f"{cut.name} cut in f32, card against CPU: loss {loss_rel:.3g} "
            f"(tolerance {TRAIN_LOSS_REL}), gradient norm {gn_rel:.3g} "
            f"({TRAIN_GNORM_REL}), {worst} {leaves[worst]:.3g} "
            f"({TRAIN_GRAD_REL})")
    return out


class Timed:
    """Wraps a method of an object with a list of its call times."""

    def __init__(self, torch, obj, name: str):
        self.torch, self.fn, self.s = torch, getattr(obj, name), []
        setattr(obj, name, self)

    def __call__(self, *args, **kwargs):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        self.s.append(time.perf_counter() - t0)
        return out


def train_coordinator(torch, dev, seed: int, cfg) -> dict:
    """(c) ``cfg`` through ``launch.train.make_coordinator`` (the path
    ``python -m repro_torch.launch.train`` takes) in a temporary directory:
    a clean run and one with a failure at step COORD_FAIL_AT that resumes
    from its step-COORD_EVERY checkpoint must end on the same
    ``hash_pytree``; then each run's weights behind the token engine
    (SIDE_CAPACITY rows): COORD_DOCS documents in one batch and one batch
    of QUERIES prompts, whose ``memory_hash`` and ``retrieval_hash`` must
    be equal. Launch counts are zeroed before the first engine is built and
    read after the second one's reads."""
    from repro_torch import kernels
    from repro_torch.launch.train import make_coordinator
    from repro_torch.serve.engine import MemoryAugmentedEngine, ServeConfig
    from repro_torch.train.step import bind_state
    rng = np.random.default_rng(seed + 12)
    docs = rng.integers(0, cfg.vocab_size, (COORD_DOCS, LM_DOC_LEN),
                        dtype=np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (QUERIES, LM_PROMPT_LEN),
                           dtype=np.int32)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-train-")
    runs = {}
    try:
        for name, fail_at in (("clean", None), ("restarted", COORD_FAIL_AT)):
            fresh_card(torch)
            fired = []

            def injector(step, fail_at=fail_at, fired=fired):
                if step == fail_at and not fired:
                    fired.append(step)
                    return f"injected at step {step}"
                return None

            coord = make_coordinator(
                cfg, dev, steps=COORD_STEPS, batch=COORD_BATCH,
                seq=COORD_SEQ, lr=COORD_LR, seed=seed,
                checkpoint_dir=os.path.join(tmp, name),
                checkpoint_every=COORD_EVERY, failure_injector=injector)
            save = Timed(torch, coord.ckpt, "save")
            restore = Timed(torch, coord.ckpt, "restore_latest")
            t0 = time.perf_counter()
            state = coord.train()
            torch.cuda.synchronize()
            # the Coordinator restarts from its last checkpoint whatever a
            # step raises: the clean run's events are its checkpoints
            # alone, the other's hold the injected failure and one restart,
            # so a fault on the card cannot pass as a recovery. The save at
            # the last step wrote hash_pytree(state) into its manifest
            want = [{"event": "checkpoint", "step": s}
                    for s in range(COORD_EVERY, COORD_STEPS + 1, COORD_EVERY)]
            if fail_at is not None:
                back = fail_at // COORD_EVERY
                want[back:back] = [
                    {"event": "failure", "step": fail_at,
                     "error": f"injected failure: injected at step {fail_at}"},
                    {"event": "restart", "from_step": back * COORD_EVERY}]
            if coord.events != want:
                raise AssertionError(f"{cfg.name} Coordinator, {name} run: "
                                     f"events {coord.events} != {want}")
            run = dict(train_s=time.perf_counter() - t0, save_s=save.s,
                       restore_s=restore.s, events=coord.events,
                       step_s=coord.step_times, hash=coord.ckpt.last_hash)
            params, _ = bind_state(state, cfg)
            params.requires_grad_(False)
            runs[name] = (run, params)
            del state, coord
        first = True
        for name, (run, params) in runs.items():
            eng = MemoryAugmentedEngine(cfg, params, ServeConfig(
                capacity=SIDE_CAPACITY, retrieve_k=K, ef=EF,
                s_cache=LM_S_CACHE, context_tokens=LM_CONTEXT,
                max_new_tokens=GEN_NEW), device=dev)
            torch.cuda.synchronize()
            if first:
                kernels.reset_launch_counts()  # the main path starts here
                first = False
            t0 = time.perf_counter()
            eng.insert_documents(docs)
            torch.cuda.synchronize()
            run["ingest_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            run["retrieval_hash"] = eng.retrieval_hash(prompts)
            run["read_ms"] = (time.perf_counter() - t0) * 1e3
            run["route"] = eng.last_plan.route
            run["memory_hash"] = eng.memory_hash()
            eng.close()
        counts = phase_counts(kernels)  # the main path ends here
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    clean, restarted = (runs[k][0] for k in ("clean", "restarted"))
    if restarted["hash"] != clean["hash"]:
        raise AssertionError(f"{cfg.name}: the restarted run's train state "
                             f"{restarted['hash']:#x} != the clean run's "
                             f"{clean['hash']:#x}")
    for key in ("memory_hash", "retrieval_hash"):
        if restarted[key] != clean[key]:
            raise AssertionError(f"{cfg.name}: {key} differs between the "
                                 f"clean and the restarted weights")
    require(counts, LM_PATH, "the training phase's engines")
    return dict(cfg=cfg, clean=clean, restarted=restarted, counts=counts)


def train_compressed(torch, dev, seed: int, cfg) -> dict:
    """(d) ``make_compressed_train_step`` over PODS pods on the card
    (``[dev] * PODS``), global batch COORD_BATCH, POD_STEPS steps with
    error feedback, twice from the seed: the runs and the pods must end on
    the same parameter bits, and the first step's ``integer_psum_grads``
    on the card must equal the CPU's on the same per-pod gradients, copied
    to the host, and zero residuals, bit for bit. First, one step of
    ``cfg`` cut to TRAIN_CUT_LAYERS layers under the deterministic mode
    lists the ops it flags."""
    from repro_torch.core import hashing
    from repro_torch.data.pipeline import DataConfig, DeterministicPipeline
    from repro_torch.models import transformer as tf
    from repro_torch.optim import compress
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import loss_and_grads, \
        make_compressed_train_step
    devices = [dev] * PODS
    data = DeterministicPipeline(DataConfig(
        seq_len=COORD_SEQ, global_batch=COORD_BATCH,
        vocab_size=cfg.vocab_size, seed=seed))
    optc = AdamWConfig(lr=COORD_LR, warmup_steps=1, total_steps=POD_STEPS)
    real, calls = compress.integer_psum_grads, []

    def host(tree):
        return None if tree is None else {k: v.cpu() for k, v in tree.items()}

    def capture(grads, contract="Q2.13", residuals=None):
        mean, res = real(grads, contract, residuals)
        if not calls:
            # the first step's residuals are the zeros that error feedback
            # starts from: checked on the card, not copied
            if residuals is None or any(bool(torch.any(v)) for r in residuals
                                        for v in r.values()):
                raise AssertionError(f"{cfg.name}: the first step's "
                                     f"residuals are not zeros")
            calls.append(dict(grads=[host(g) for g in grads],
                              mean=host(mean), res=[host(r) for r in res]))
        return mean, res

    fresh_card(torch)
    cut = dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS)
    small = tf.init_params(cut, torch.Generator(dev).manual_seed(seed))
    _, flagged = flagged_ops(
        torch, lambda: loss_and_grads(small, data.batch(0), cut))
    del small
    runs = []
    compress.integer_psum_grads = capture
    try:
        for _ in range(2):
            fresh_card(torch)
            params = [tf.init_params(cfg, torch.Generator(d).manual_seed(seed))
                      for d in devices]
            opts = [adamw_init(p) for p in params]
            step = make_compressed_train_step(cfg, optc, devices)
            losses, ms = [], []
            for s in range(POD_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opts, m = step(params, opts, data.batch(s))
                losses.append(m["loss"].item())
                ms.append((time.perf_counter() - t0) * 1e3)
            runs.append(dict(losses=losses, ms=ms, hashes=[
                hashing.hash_state_device(dict(p.named_parameters()))
                for p in params]))
            del params, opts
    finally:
        compress.integer_psum_grads = real
    a, b = runs
    if len(set(a["hashes"] + b["hashes"])) != 1 or a["losses"] != b["losses"]:
        raise AssertionError(f"{cfg.name} compressed step: runs or pods "
                             f"differ: {runs}")
    c = calls[0]
    zeros = [{k: torch.zeros_like(v, dtype=torch.float32)
              for k, v in g.items()} for g in c["grads"]]
    t0 = time.perf_counter()
    mean, res = real(c["grads"], "Q2.13", zeros)
    cpu_s = time.perf_counter() - t0
    same = all(torch.equal(mean[k], c["mean"][k]) for k in mean) and all(
        torch.equal(r[k], cr[k]) for r, cr in zip(res, c["res"]) for k in r)
    if not same:
        raise AssertionError(f"{cfg.name}: the card's integer_psum_grads != "
                             f"the CPU's on the same gradients")
    n_words = sum(v.numel() for v in c["mean"].values())
    return dict(cfg=cfg, runs=runs, cpu_s=cpu_s, n_words=n_words,
                flagged=flagged)


def run_train(torch, dev, seed: int, cfg=None, coord_cfg=None) -> dict:
    """Phase 10 (``cfg`` and ``coord_cfg`` replace TRAIN_ARCH's and
    COORD_ARCH's CONFIGs in a CPU rehearsal)."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config(TRAIN_ARCH)
    coord_cfg = coord_cfg or get_config(COORD_ARCH)
    if cfg.remat != "block":
        raise AssertionError(f"{cfg.name}: remat {cfg.remat!r}")
    out = {}
    t0 = time.perf_counter()
    out["twice"] = train_twice(torch, dev, seed, cfg)
    out["cut"] = train_cut_numerics(torch, dev, seed, cfg)
    out["coord"] = train_coordinator(torch, dev, seed, coord_cfg)
    out["pods"] = train_compressed(torch, dev, seed, coord_cfg)
    out["s"] = time.perf_counter() - t0
    fresh_card(torch)
    return out


def report_train(r) -> None:
    card, med = CARD[0], statistics.median
    tw = r["twice"]
    cfg, (a, b) = tw["cfg"], tw["runs"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = med(a["ms"] + b["ms"])
    log(f"[train] {cfg.name} ({cfg.num_layers} layers, d={cfg.d_model}, "
        f"vocabulary {cfg.vocab_size}, {cfg.dtype} over {cfg.param_dtype}, "
        f"remat {cfg.remat}, {a['n_params']} parameters): {TRAIN_STEPS} "
        f"AdamW steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, twice from the "
        f"seed: step ms {[round(x, 1) for x in a['ms']]} then "
        f"{[round(x, 1) for x in b['ms']]}, median {step_ms:.1f} ms = "
        f"{tokens / step_ms * 1e3:.1f} tokens/s; init {a['init_s']:.2f} s; "
        f"peak device memory {a['peak_bytes'] / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated; {card})")
    log(f"[train] {cfg.name} losses {a['losses']}, gradient norms "
        f"{a['gnorms']}: equal bit for bit in both runs; parameter hash "
        f"(reference layout, hash_state_device) {a['hash']:#018x} both "
        f"times ({a['hash_s']:.2f} s with the move to that layout; {card})")
    c = r["cut"]
    log(f"[train] {c['cut'].name} cut to {c['cut'].num_layers} layers in "
        f"f32, one batch of {TRAIN_CUT_SEQ} tokens, card against CPU: loss "
        f"{c['loss'][0]!r} vs {c['loss'][1]!r} (relative "
        f"{c['loss_rel']:.3g}, tolerance {TRAIN_LOSS_REL}); gradient norm "
        f"relative {c['gnorm_rel']:.3g} ({TRAIN_GNORM_REL}); worst of "
        f"{c['n_leaves']} gradient leaves {c['worst'][0]} "
        f"{c['worst'][1]:.3g} ({TRAIN_GRAD_REL}); CPU {c['cpu_s']:.1f} s "
        f"({card})")
    co = r["coord"]
    cl, rs = co["clean"], co["restarted"]
    for name, run in (("clean", cl), ("restarted", rs)):
        log(f"[train] {co['cfg'].name} Coordinator, {name}: {COORD_STEPS} "
            f"steps of {COORD_BATCH} x {COORD_SEQ} in {run['train_s']:.2f} "
            f"s (steps p50 {1e3 * med(run['step_s']):.1f} ms); checkpoint "
            f"saves {[round(x, 3) for x in run['save_s']]} s, restores "
            f"{[round(x, 3) for x in run['restore_s']]} s; events "
            f"{[e['event'] for e in run['events']]}; the final train "
            f"state's hash_pytree (its last checkpoint's manifest) "
            f"{run['hash']:#018x} ({card})")
        log(f"[train] {co['cfg'].name} {name} weights behind the token "
            f"engine: ingest {COORD_DOCS} docs of {LM_DOC_LEN} tokens "
            f"{run['ingest_s']:.3f} s, one batch of {QUERIES} prompts "
            f"{run['read_ms']:.3f} ms on route {run['route']}; memory_hash "
            f"{run['memory_hash']:#018x}, retrieval_hash "
            f"{run['retrieval_hash']:#018x} ({card})")
    log(f"[train] {co['cfg'].name}: the restarted run equals the clean run "
        f"(train state, memory_hash, retrieval_hash); kernel launches "
        f"{co['counts']}")
    pd = r["pods"]
    a, b = pd["runs"]
    log(f"[train] {pd['cfg'].name} compressed step over {PODS} pods on the "
        f"card, global batch {COORD_BATCH} x {COORD_SEQ}, {POD_STEPS} steps "
        f"with error feedback, twice: losses {a['losses']}, step ms "
        f"{[round(x, 1) for x in a['ms'] + b['ms']]}; every pod of both "
        f"runs ends on {a['hashes'][0]:#018x}; the first integer_psum_grads "
        f"({pd['n_words']} words) on the card == the CPU's bit for bit "
        f"(CPU {pd['cpu_s']:.2f} s; {card})")
    log(f"[train] ops that torch.use_deterministic_algorithms flags in one "
        f"step on the card (warn_only; the mode is off everywhere else): "
        f"{c['cut'].name} cut to {c['cut'].num_layers} layers in f32 "
        f"{c['flagged']}, {pd['cfg'].name} cut to {TRAIN_CUT_LAYERS} layers "
        f"{pd['flagged']}; the reruns above ran without it and repeated bit "
        f"for bit")


# --------------------------------------------------------------------------- #
# phase 11: the vlm and audio backbones on external embeddings
# --------------------------------------------------------------------------- #


def ext_inputs(cfg, rng, batch: int, length: int) -> dict:
    """Seeded embeddings [batch, length, D] and, under M-RoPE, non-text
    ``positions_3d`` [3, batch, length]: a t / h / w grid of 2 x 4 x 6
    patches (the three streams differ)."""
    out = {"embeds": rng.standard_normal(
        (batch, length, cfg.d_model)).astype(np.float32)}
    if cfg.rope_type == "mrope":
        i = np.arange(length)
        grid = np.stack([i // 24, (i % 24) // 6, i % 6]).astype(np.int32)
        out["positions_3d"] = np.broadcast_to(
            grid[:, None], (3, batch, length)).copy()
    return out


def ext_generate(torch, tf, params, cfg, inputs: dict, dev):
    """Prefill on the embeddings, then EXT_NEW - 1 greedy decode steps,
    each fed the embedding row of the token it chose (text RoPE at the
    next positions, as the reference decodes): (tokens [B, EXT_NEW], every
    step's logits, prefill ms, decode ms per step; CUDA events)."""
    batch = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
    B, L = batch["embeds"].shape[:2]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, caches = tf.prefill(params, batch, cfg, EXT_S_CACHE)
    ev[1].record()
    toks, seen = [], [logits]
    for t in range(EXT_NEW):
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        if t + 1 == EXT_NEW:
            break
        emb = params.embed[tok][:, None].to(cfg.compute_dtype)
        pos = torch.full((B, 1), L + t, dtype=torch.int32, device=dev)
        logits, caches = tf.decode_step(params, caches, None, pos, cfg,
                                        embeds=emb)
        seen.append(logits)
    ev[2].record()
    torch.cuda.synchronize()
    return (torch.stack(toks, 1), torch.stack(seen),
            ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]) / (EXT_NEW - 1))


def ext_cut(torch, tf, params, cfg, inputs: dict, dev) -> dict:
    """The first EXT_CUT_LAYERS layers with the embedding table, final
    norm and head (shared, not copied) in f32 on the card, and the same
    weights copied to the host on the CPU: ``apply``'s logits, prefill and
    four decode steps on seeded embeddings; the largest relative error."""
    ccfg = dataclasses.replace(cfg, num_layers=EXT_CUT_LAYERS,
                               dtype="float32")
    cut = torch.nn.Module()
    cut.embed, cut.final_norm, cut.lm_head = (params.embed,
                                              params.final_norm,
                                              params.lm_head)
    cut.blocks = torch.nn.ModuleList(list(params.blocks)[:EXT_CUT_LAYERS])
    t0 = time.perf_counter()
    host = tf.init_params(ccfg, None)
    host.load_state_dict({k: v.cpu() for k, v in cut.state_dict().items()},
                         assign=True)
    copy_s = time.perf_counter() - t0
    small = {k: v[:EXT_CUT_BATCH] if k != "positions_3d"
             else v[:, :EXT_CUT_BATCH] for k, v in inputs.items()}
    steps = np.random.default_rng(7).standard_normal(
        (4, EXT_CUT_BATCH, 1, cfg.d_model)).astype(np.float32)

    def run(model, device):
        b = {k: torch.as_tensor(v, device=device) for k, v in small.items()}
        outs = [tf.apply(model, b, ccfg)[0]]
        logits, caches = tf.prefill(model, b, ccfg, EXT_LEN + 8)
        outs.append(logits)
        for t, e in enumerate(steps):
            pos = torch.full((EXT_CUT_BATCH, 1), EXT_LEN + t,
                             dtype=torch.int32, device=device)
            logits, caches = tf.decode_step(
                model, caches, None, pos, ccfg,
                embeds=torch.as_tensor(e, device=device))
            outs.append(logits)
        return [o.float().cpu() for o in outs]

    with torch.no_grad():
        card = run(cut, dev)
        t0 = time.perf_counter()
        cpu = run(host, torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(card, cpu))
    return dict(rel=rel, copy_s=copy_s, cpu_s=cpu_s, outputs=len(card))


def run_external(torch, dev, seed: int, arch: str, cfg=None) -> dict:
    """Phase 11 for one arch (``cfg`` replaces its CONFIG in a CPU
    rehearsal): the backbone from the seed on the card, prefill + greedy
    decode on seeded embeddings twice, equal bit for bit; then its f32 cut
    against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    full = cfg is None
    cfg = cfg or get_config(arch)
    inputs = ext_inputs(cfg, np.random.default_rng(seed + 11), EXT_BATCH,
                        EXT_LEN)
    fresh_card(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    params.requires_grad_(False)
    torch.cuda.synchronize()
    out = dict(cfg=cfg, init_s=time.perf_counter() - t0,
               n_params=sum(p.numel() for p in params.parameters()))
    if full and out["n_params"] != EXT_PARAMS[arch]:
        raise AssertionError(f"{arch}: {out['n_params']} parameters != "
                             f"{EXT_PARAMS[arch]}")
    with torch.no_grad():
        runs = [ext_generate(torch, tf, params, cfg, inputs, dev)
                for _ in range(2)]
    (tok_a, log_a, *_), (tok_b, log_b, *_) = runs
    if not (torch.equal(tok_a, tok_b) and torch.equal(log_a, log_b)):
        raise AssertionError(f"{cfg.name}: the rerun's logits or tokens "
                             "differ")
    if not bool(torch.isfinite(log_a[..., :cfg.vocab_size]).all()) or \
            int(tok_a.min()) < 0 or int(tok_a.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: non-finite logits or tokens out "
                             "of the vocabulary")
    out.update(peak_bytes=torch.cuda.max_memory_allocated(),
               prefill_ms=[r[2] for r in runs],
               decode_ms=[r[3] for r in runs], tokens=tok_a.cpu(),
               cut=ext_cut(torch, tf, params, cfg, inputs, dev))
    if not out["cut"]["rel"] <= EXT_F32_REL:
        raise AssertionError(f"{cfg.name}: f32 cut, card against CPU: "
                             f"{out['cut']['rel']:.3g} > {EXT_F32_REL}")
    del params
    fresh_card(torch)
    return out


def report_external(r) -> None:
    cfg, card, c = r["cfg"], CARD[0], r["cut"]
    pos = " with non-text M-RoPE positions" if cfg.rope_type == "mrope" \
        else ""
    log(f"[external] {cfg.name} ({cfg.family}): {cfg.num_layers} layers, "
        f"d={cfg.d_model}, vocabulary {cfg.vocab_size}, {cfg.dtype} over "
        f"{cfg.param_dtype}: {r['n_params']} parameters, initialized on the "
        f"card in {r['init_s']:.3f} s")
    log(f"[external] {cfg.name} prefill [{EXT_BATCH}, {EXT_LEN}] on seeded "
        f"embeddings{pos}, then {EXT_NEW} greedy tokens (decode fed its "
        f"tokens' embedding rows), twice: the same logits and tokens bit "
        f"for bit; prefill {r['prefill_ms'][0]:.3f} / "
        f"{r['prefill_ms'][1]:.3f} ms, decode {r['decode_ms'][0]:.3f} / "
        f"{r['decode_ms'][1]:.3f} ms per step; peak "
        f"{r['peak_bytes'] / 2**30:.2f} GiB ({card})")
    log(f"[external] {cfg.name} first {EXT_CUT_LAYERS} layers + head in "
        f"f32, card against CPU ({c['outputs']} outputs: apply, prefill, 4 "
        f"decode steps): max relative error {c['rel']:.3g} (tolerance "
        f"{EXT_F32_REL}); copy to the host {c['copy_s']:.1f} s, CPU runs "
        f"{c['cpu_s']:.1f} s")


# --------------------------------------------------------------------------- #
# phase 12: multi-device execution
# --------------------------------------------------------------------------- #


def md_mesh(dev, shape=MESH_SHAPE):
    from repro_torch.launch.mesh import Mesh
    return Mesh(("data", "model"), shape, (dev,) * (shape[0] * shape[1]))


def greedy(torch, prefill, decode, tokens, n_new: int):
    """``prefill(tokens)`` then greedy ``decode(caches, tok, pos)`` steps:
    (tokens [B, n_new], every step's logits)."""
    logits, caches = prefill(tokens)
    B, L = tokens.shape
    out, seen = [], [logits]
    for t in range(n_new):
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        out.append(tok)
        if t + 1 == n_new:
            break
        pos = torch.full((B, 1), L + t, dtype=torch.int32,
                         device=tokens.device)
        logits, caches = decode(caches, tok, pos)
        seen.append(logits)
    return torch.cat(out, 1), seen


def rel_err(torch, got, want, vocab: int) -> float:
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return float((got - want).abs().max() / want.abs().max())


def md_serve(torch, dev, seed: int, cfg) -> dict:
    """(a): ``cfg`` placed over MESH_SHAPE, prefill + greedy decode through
    ``make_prefill_step`` / ``make_decode_step``, twice; against the same
    weights unplaced on each data shard's prompts (the expert-parallel
    capacity is per data shard, as the reference's)."""
    from repro_torch.models import placement
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import moe
    from repro_torch.train.step import make_decode_step, make_prefill_step
    rng = np.random.default_rng(seed + 12)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        MD_BATCH, MD_LEN), dtype=np.int32), device=dev)
    fresh_card(torch)
    params = tf.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    params.requires_grad_(False)
    mesh = md_mesh(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = placement.place(params, cfg, mesh)
    torch.cuda.synchronize()
    out = dict(cfg=cfg, place_s=time.perf_counter() - t0,
               shard_bytes=sum(t.numel() * t.element_size()
                               for t in placed.shards[0].values()),
               n_params=sum(p.numel() for p in params.parameters()))
    prefill, decode = make_prefill_step(cfg, MD_S_CACHE), \
        make_decode_step(cfg)
    runs, paths0 = [], dict(moe.PATHS)
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, pc = prefill(placed, {"tokens": tokens})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got, seen = greedy(torch, lambda t: (logits, pc),
                               lambda c, tok, pos: decode(placed, c, tok,
                                                          pos),
                               tokens, MD_NEW)
            torch.cuda.synchronize()
            runs.append(dict(tokens=got, logits=seen,
                             prefill_ms=(t1 - t0) * 1e3,
                             decode_ms=(time.perf_counter() - t1) * 1e3
                             / (MD_NEW - 1)))
        out["paths"] = {k: v - paths0[k] for k, v in moe.PATHS.items()}
        a, b = runs
        if not (torch.equal(a["tokens"], b["tokens"]) and all(
                torch.equal(x, y) for x, y in zip(a["logits"],
                                                  b["logits"]))):
            raise AssertionError("placed rerun differs")
        # the same weights unplaced, one data shard's prompts at a time
        dp = mesh.shape["data"]
        per = MD_BATCH // dp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = [greedy(torch, lambda t: tf.prefill(params, {"tokens": t},
                                                    cfg, MD_S_CACHE),
                        lambda c, tok, pos: tf.decode_step(params, c, tok,
                                                           pos, cfg),
                        tokens[i * per:(i + 1) * per], MD_NEW)
                 for i in range(dp)]
        torch.cuda.synchronize()
        out["unplaced_s"] = time.perf_counter() - t0
    want_tokens = torch.cat([p[0] for p in parts])
    rels = [rel_err(torch, g, torch.cat([p[1][s] for p in parts]),
                    cfg.vocab_size) for s, g in enumerate(a["logits"])]
    out.update(runs=runs, rel=max(rels),
               same_tokens=bool(torch.equal(a["tokens"], want_tokens)),
               peak_bytes=torch.cuda.max_memory_allocated())
    if out["paths"]["expert_parallel"] == 0:
        raise AssertionError("the expert-parallel path did not run")
    if not out["rel"] <= MD_LOGITS_REL or not out["same_tokens"]:
        raise AssertionError(f"placed != unplaced: logits {out['rel']:.3g}, "
                             f"tokens equal {out['same_tokens']}")
    del placed, params, parts, runs
    fresh_card(torch)
    return out


def md_train(torch, dev, seed: int, cfg) -> dict:
    """(b): the first MD_TRAIN_LAYERS layers placed, MD_TRAIN_STEPS of
    ``make_train_step`` at MD_LR with block remat, against the same steps
    unplaced (``placement.unplaced_loss_and_grads``: each data shard's
    batch on its own, as the expert-parallel capacity is per shard) and
    against the same placed steps without remat (bit for bit)."""
    from repro_torch.models import collectives, placement
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(cfg, num_layers=MD_TRAIN_LAYERS, remat="block")
    bare = dataclasses.replace(cfg, remat="none")
    rng = np.random.default_rng(seed + 13)
    batches = []
    for _ in range(MD_TRAIN_STEPS):
        t = rng.integers(0, cfg.vocab_size, (MD_TRAIN_BATCH,
                                             MD_TRAIN_SEQ + 1), dtype=np.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    fresh_card(torch)
    model = tf.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    mesh = md_mesh(dev)
    optc = AdamWConfig(lr=MD_LR)

    recomputes = [0]
    recompute = collectives._RematGroup._recompute

    def counted(group):
        recomputes[0] += 1
        return recompute(group)

    def grads_and_peak(placed, c):
        """``loss_and_grads``, the bytes every rank's forward kept for the
        backward pass (counted by a saved-tensor hook around each rank's
        ``apply``; a remat block keeps none of its own) and the peak memory
        above what was live before it."""
        apply, saved = tf.apply, [0]

        def counting(*args):
            def pack(t):
                saved[0] += t.numel() * t.element_size()
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                return apply(*args)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tf.apply = counting
        try:
            metrics, grads = placement.loss_and_grads(placed, batches[0], c)
        finally:
            tf.apply = apply
        torch.cuda.synchronize()
        return (metrics, grads, saved[0],
                torch.cuda.max_memory_allocated() - base)

    placed = placement.place(model, cfg, mesh)
    popt = placement.place_opt(adamw_init(model), placed)
    collectives._RematGroup._recompute = counted
    try:
        metrics, grads, saved, peak = grads_and_peak(placed, cfg)
    finally:
        collectives._RematGroup._recompute = recompute
    m0, g0, saved0, peak0 = grads_and_peak(placed, bare)
    same_grads = torch.equal(metrics["loss"], m0["loss"]) and all(
        torch.equal(g0[r][k], grads[r][k]) for r in range(mesh.size)
        for k in placed.shapes)
    del g0
    loss, want = placement.unplaced_loss_and_grads(model, batches[0], cfg,
                                                   mesh)
    loss_rel = abs(float(metrics["loss"]) - float(loss)) / abs(float(loss))
    grad_rels = {k: float(torch.linalg.vector_norm(placement.gather_like(
        grads, placed, k, dev) - want[k]) / torch.linalg.vector_norm(
            want[k]).clamp(min=1e-30)) for k in placed.shapes}
    grad_rel = max(grad_rels.values())
    del grads, want
    # the same steps with and without remat, each from the same placement
    twin = placement.place(model, cfg, mesh)
    twin_opt = placement.place_opt(adamw_init(model), twin)
    ms, losses = {"block": [], "none": []}, {"block": [], "none": []}
    for key, c, p, o in (("block", cfg, placed, popt),
                         ("none", bare, twin, twin_opt)):
        step = make_train_step(c, optc)
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[key].append(step(p, o, b)[2]["loss"])
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) * 1e3)
    same_steps = all(torch.equal(a, b) for a, b in zip(losses["block"],
                                                       losses["none"])) \
        and all(torch.equal(placed.shards[r][k], twin.shards[r][k])
                for r in range(mesh.size) for k in placed.shapes)
    del twin, twin_opt
    opt = adamw_init(model)
    for b in batches:
        _, g = placement.unplaced_loss_and_grads(model, b, cfg, mesh)
        adamw_update(optc, model, g, opt)
    # the parameters as one vector, relative Frobenius; the worst leaf is
    # reported beside it (a zero-initialized norm scale holds only its two
    # AdamW updates, which normalize each gradient entry)
    named = dict(model.named_parameters())
    sq_diff = sq_norm = 0.0
    leaf_rels = {}
    for k in placed.shapes:
        d = float(torch.linalg.vector_norm(placed.gather(k)
                                           - named[k].detach())) ** 2
        n = float(torch.linalg.vector_norm(named[k].detach())) ** 2
        sq_diff, sq_norm = sq_diff + d, sq_norm + n
        leaf_rels[k] = (d / max(n, 1e-60)) ** 0.5
    param_rel = (sq_diff / sq_norm) ** 0.5
    worst = max(leaf_rels, key=leaf_rels.get)
    out = dict(cfg=cfg, loss=float(metrics["loss"]), loss_rel=loss_rel,
               grad_rel=grad_rel, param_rel=param_rel, ms=ms["block"],
               ms_bare=ms["none"], peak=peak, peak_bare=peak0,
               saved=saved, saved_bare=saved0,
               recomputes=recomputes[0], same_grads=same_grads,
               same_steps=same_steps,
               worst=(worst, leaf_rels[worst], grad_rels[worst]))
    if not (loss_rel <= MD_LOSS_REL and grad_rel <= MD_GRAD_REL
            and param_rel <= MD_PARAM_REL):
        raise AssertionError(
            f"placed training != unplaced: loss {loss_rel:.3g}, gradients "
            f"{grad_rel:.3g}, parameters {param_rel:.3g}")
    if recomputes[0] != MD_TRAIN_LAYERS:
        raise AssertionError(f"{recomputes[0]} blocks recomputed, not "
                             f"{MD_TRAIN_LAYERS}")
    if not saved < saved0:
        raise AssertionError(f"remat kept {saved} bytes for the backward "
                             f"pass, {saved0} without it")
    if not (same_grads and same_steps):
        raise AssertionError(f"placed remat != no remat: first step "
                             f"{same_grads}, {MD_TRAIN_STEPS} steps "
                             f"{same_steps}")
    del placed, popt, model, opt
    fresh_card(torch)
    return out


def md_layout(torch, dev, seed: int, arch: str, cfg=None) -> dict:
    """(d) and (e): ``arch``'s CONFIG in f32 cut to MD_LAYOUT_LAYERS
    layers over MD_LAYOUT_SHAPE, where its attention takes the layout
    MD_LAYOUTS names: prefill [MD_BATCH, MD_LEN] and MD_NEW greedy steps
    (external embeddings: seeded, with non-text M-RoPE positions, each
    decode step fed the embedding row of the token it chose), twice,
    equal bit for bit; against the same weights unplaced."""
    from repro_torch.configs import get_config
    from repro_torch.models import placement, pspec
    from repro_torch.models import transformer as tf
    cfg = cfg or dataclasses.replace(get_config(arch), dtype="float32",
                                     num_layers=MD_LAYOUT_LAYERS)
    mesh = md_mesh(dev, MD_LAYOUT_SHAPE)
    layout = pspec.attn_layout(cfg, mesh)
    if layout != MD_LAYOUTS[arch]:
        raise AssertionError(f"{arch}: layout {layout} over {mesh.shape}")
    rng = np.random.default_rng(seed + 15)
    if cfg.external_embeddings:
        inputs = {k: torch.as_tensor(v, device=dev) for k, v in ext_inputs(
            cfg, rng, MD_BATCH, MD_LEN).items()}
    else:
        inputs = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (MD_BATCH, MD_LEN), dtype=np.int32),
            device=dev)}
    fresh_card(torch)
    params = tf.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    params.requires_grad_(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = placement.place(params, cfg, mesh)
    torch.cuda.synchronize()
    out = dict(cfg=cfg, layout=layout, place_s=time.perf_counter() - t0,
               n_params=sum(p.numel() for p in params.parameters()),
               shard_bytes=sum(t.numel() * t.element_size()
                               for t in placed.shards[0].values()))

    def feed(tok):
        """The next step's input: the token, or its embedding row."""
        if cfg.external_embeddings:
            return None, params.embed[tok[:, 0]][:, None].to(
                cfg.compute_dtype)
        return tok, None

    def generate(prefill, decode):
        logits, caches = prefill()
        toks, seen = [], [logits]
        for t in range(MD_NEW):
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            toks.append(tok)
            if t + 1 == MD_NEW:
                break
            pos = torch.full((MD_BATCH, 1), MD_LEN + t, dtype=torch.int32,
                             device=dev)
            logits, caches = decode(caches, *feed(tok), pos)
            seen.append(logits)
        return torch.cat(toks, 1), seen

    runs = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, pc = placement.prefill(placed, inputs, MD_S_CACHE)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got, seen = generate(
                lambda: (logits, pc),
                lambda c, tok, emb, pos: placement.decode_step(
                    placed, c, tok, pos, emb))
            torch.cuda.synchronize()
            runs.append(dict(tokens=got, logits=seen,
                             prefill_ms=(t1 - t0) * 1e3,
                             decode_ms=(time.perf_counter() - t1) * 1e3
                             / (MD_NEW - 1)))
        a, b = runs
        if not (torch.equal(a["tokens"], b["tokens"]) and all(
                torch.equal(x, y) for x, y in zip(a["logits"],
                                                  b["logits"]))):
            raise AssertionError(f"{arch}: placed rerun differs")
        # the same weights unplaced, fed the placed run's tokens
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [tf.prefill(params, inputs, cfg, MD_S_CACHE)]
        for t in range(MD_NEW - 1):
            pos = torch.full((MD_BATCH, 1), MD_LEN + t, dtype=torch.int32,
                             device=dev)
            tok, emb = feed(a["tokens"][:, t:t + 1])
            want.append(tf.decode_step(params, want[-1][1], tok, pos, cfg,
                                       embeds=emb))
        torch.cuda.synchronize()
        out["unplaced_s"] = time.perf_counter() - t0
    rels = [rel_err(torch, g, w[0], cfg.vocab_size)
            for g, w in zip(a["logits"], want)]
    want_tokens = torch.stack([torch.argmax(w[0], -1) for w in want], 1)
    out.update(runs=runs, rel=max(rels),
               same_tokens=bool(torch.equal(a["tokens"], want_tokens.to(
                   torch.int32))),
               peak_bytes=torch.cuda.max_memory_allocated())
    if not out["rel"] <= MD_LAYOUT_REL or not out["same_tokens"]:
        raise AssertionError(f"{arch} placed != unplaced: logits "
                             f"{out['rel']:.3g}, tokens equal "
                             f"{out['same_tokens']}")
    del placed, params, runs, want
    fresh_card(torch)
    return out


def md_expert_parallel(torch, dev, seed: int, cfg=None) -> dict:
    """(c): phi3.5-moe's PHI_LAYERS MoE layers at full width in f32, one at
    a time: ``moe_ffn`` placed over (data 1, model 4) takes the
    expert-parallel path and equals the one-device path bit for bit on
    EP_TOKENS tokens (top-2: each token's output is the same sum of the
    same two terms)."""
    from repro_torch.configs import get_config
    from repro_torch.models import collectives, placement
    from repro_torch.models.layers import moe
    cfg = cfg or dataclasses.replace(get_config(PHI_ARCH), dtype="float32")
    mesh = md_mesh(dev, (1, 4))
    gen = torch.Generator(dev).manual_seed(seed + 14)
    out = dict(cfg=cfg, ms=[], dense_ms=[])
    fresh_card(torch)
    for _ in range(PHI_LAYERS):
        layer = moe.MoE(gen, cfg)
        layer.requires_grad_(False)
        x = torch.randn(EP_TOKENS + (cfg.d_model,), generator=gen,
                        device=dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, aux = moe.moe_ffn(layer, x, cfg)
            torch.cuda.synchronize()
            out["dense_ms"].append((time.perf_counter() - t0) * 1e3)
            placed = placement.place(layer, cfg, mesh)
            shards, sharded = placement.place_batch({"embeds": x}, mesh)
            before = moe.PATHS["expert_parallel"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ranks = collectives.spmd(mesh, lambda r: moe.moe_ffn(
                placed.view(r), shards[r]["embeds"], cfg),
                [(r,) for r in range(mesh.size)], batch_sharded=sharded)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
        if moe.PATHS["expert_parallel"] != before + mesh.size:
            raise AssertionError("the expert-parallel path did not run")
        for y_r, aux_r in ranks:
            if not (torch.equal(y_r.to(dev), y)
                    and torch.equal(aux_r.to(dev), aux)):
                raise AssertionError("expert-parallel MoE != the one-device "
                                     "path")
        del layer, placed, shards, ranks, x, y
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    fresh_card(torch)
    return out


def run_multidevice(torch, dev, seed: int, cfg=None, phi_cfg=None,
                    layout_cfgs=None) -> dict:
    """Phase 12 (``cfg``, ``phi_cfg`` and ``layout_cfgs`` (arch → config)
    replace MD_ARCH's CONFIG, phi3.5-moe's and those of MD_LAYOUTS in a
    CPU rehearsal)."""
    from repro_torch.configs import get_config
    cfg = cfg or dataclasses.replace(get_config(MD_ARCH), dtype="float32")
    layout_cfgs = layout_cfgs or {}
    t0 = time.perf_counter()
    out = dict(serve=md_serve(torch, dev, seed, cfg),
               train=md_train(torch, dev, seed, cfg),
               ep=md_expert_parallel(torch, dev, seed, phi_cfg),
               layouts={arch: md_layout(torch, dev, seed, arch,
                                        layout_cfgs.get(arch))
                        for arch in MD_LAYOUTS})
    out["s"] = time.perf_counter() - t0
    return out


def report_multidevice(r) -> None:
    card, sv, tr, ep = CARD[0], r["serve"], r["train"], r["ep"]
    cfg = sv["cfg"]
    a, b = sv["runs"]
    log(f"[multidevice] {cfg.name} CONFIG in f32 ({sv['n_params']} "
        f"parameters) placed over (data {MESH_SHAPE[0]}, model "
        f"{MESH_SHAPE[1]}) on 4 ranks of one card in {sv['place_s']:.2f} s, "
        f"{sv['shard_bytes'] / 2**30:.2f} GiB on rank 0; MoE calls by path "
        f"{sv['paths']}")
    log(f"[multidevice] placed prefill [{MD_BATCH}, {MD_LEN}] "
        f"{a['prefill_ms']:.1f} / {b['prefill_ms']:.1f} ms, {MD_NEW} greedy "
        f"steps at {a['decode_ms']:.1f} / {b['decode_ms']:.1f} ms per step "
        f"(host clock), the rerun equal bit for bit; against the same "
        f"weights unplaced on each data shard's prompts "
        f"({sv['unplaced_s']:.1f} s): logits max relative error "
        f"{sv['rel']:.3g} (tolerance {MD_LOGITS_REL}), the same tokens; "
        f"peak {sv['peak_bytes'] / 2**30:.2f} GiB ({card})")
    log(f"[multidevice] {tr['cfg'].name} cut to {MD_TRAIN_LAYERS} layers, "
        f"{MD_TRAIN_STEPS} placed make_train_step steps of {MD_TRAIN_BATCH} "
        f"x {MD_TRAIN_SEQ} at lr {MD_LR}: first loss {tr['loss']:.6f}, "
        f"against unplaced: loss {tr['loss_rel']:.3g}, worst gradient leaf "
        f"{tr['grad_rel']:.3g}, parameters after step {MD_TRAIN_STEPS} "
        f"{tr['param_rel']:.3g} (relative Frobenius; the worst leaf, "
        f"{tr['worst'][0]}, {tr['worst'][1]:.3g} with its gradient at "
        f"{tr['worst'][2]:.3g}); step ms {[round(x, 1) for x in tr['ms']]} "
        f"({card})")
    log(f"[multidevice] block remat under the mesh: {tr['recomputes']} "
        f"blocks recomputed in the first step; its loss and every "
        f"gradient, and the {MD_TRAIN_STEPS} steps' losses and parameters, "
        f"equal the same steps without remat bit for bit; the four ranks' "
        f"forwards kept {tr['saved'] / 2**30:.3f} GiB for the backward "
        f"pass with remat, {tr['saved_bare'] / 2**30:.3f} GiB without; "
        f"peak above the live state in one loss_and_grads "
        f"{tr['peak'] / 2**30:.3f} GiB with remat, "
        f"{tr['peak_bare'] / 2**30:.3f} GiB without; step ms without remat "
        f"{[round(x, 1) for x in tr['ms_bare']]} ({card})")
    log(f"[multidevice] {ep['cfg'].name} MoE layers at full width (d="
        f"{ep['cfg'].d_model}, {ep['cfg'].padded_experts} experts, top-"
        f"{ep['cfg'].num_experts_per_tok}) on (data 1, model 4): "
        f"expert-parallel == one-device path bit for bit on "
        f"{EP_TOKENS[0]} x {EP_TOKENS[1]} tokens, {PHI_LAYERS} layers; ms "
        f"{[round(x, 1) for x in ep['ms']]} (one device "
        f"{[round(x, 1) for x in ep['dense_ms']]}); peak "
        f"{ep['peak_bytes'] / 2**30:.2f} GiB ({card})")
    for arch, lo in r["layouts"].items():
        cfg, (a, b) = lo["cfg"], lo["runs"]
        d, m = MD_LAYOUT_SHAPE
        feed = "seeded embeddings with non-text M-RoPE positions, decode " \
            "fed its tokens' embedding rows" if cfg.external_embeddings \
            else "tokens"
        log(f"[multidevice] {arch} CONFIG in f32 cut to {cfg.num_layers} "
            f"layers ({lo['n_params']} parameters, {cfg.num_heads} query / "
            f"{cfg.num_kv_heads} key-value heads) over (data {d}, model {m}) "
            f"on {d * m} ranks of one card: the {lo['layout']} layout, "
            f"placed in {lo['place_s']:.2f} s, "
            f"{lo['shard_bytes'] / 2**30:.2f} GiB on rank 0; prefill "
            f"[{MD_BATCH}, {MD_LEN}] on {feed} {a['prefill_ms']:.1f} / "
            f"{b['prefill_ms']:.1f} ms, {MD_NEW} greedy steps at "
            f"{a['decode_ms']:.1f} / {b['decode_ms']:.1f} ms per step (host "
            f"clock), the rerun equal bit for bit; against the same weights "
            f"unplaced ({lo['unplaced_s']:.1f} s): logits max relative error "
            f"{lo['rel']:.3g} (tolerance {MD_LAYOUT_REL}), the same tokens; "
            f"peak {lo['peak_bytes'] / 2**30:.2f} GiB ({card})")


# --------------------------------------------------------------------------- #
# phase 13: the roofline of three measured steps, and one dry-run cell
# --------------------------------------------------------------------------- #


def run_roofline(torch, train_ms: float, decode_ms: float,
                 placed_prefill_ms: float, lm_cfg=None, md_cfg=None
                 ) -> dict:
    """The op walk on ``meta`` tensors over phase 10(a)'s step, phase 8's
    decode step and phase 12(a)'s placed prefill (one rank's program), each
    with its roofline on the H100's data-sheet constants beside the time
    its phase measured; then ``launch.dryrun``'s gemma2-2b x train_4k cell
    on the production mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import collectives
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.roofline import analysis
    from repro_torch.roofline.op_walk import walk
    from repro_torch.train.step import make_train_step

    def meta(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    t_start = time.perf_counter()
    out = {}
    cfg = lm_cfg or get_config(TRAIN_ARCH)
    model = tf.init_params(cfg, None)
    t0 = time.perf_counter()
    tally = walk(make_train_step(cfg, AdamWConfig(lr=TRAIN_LR)), model,
                 adamw_init(model), {"tokens": meta((TRAIN_BATCH, TRAIN_SEQ)),
                                     "labels": meta((TRAIN_BATCH,
                                                     TRAIN_SEQ))})
    out["train"] = (tally, analysis.analyze(tally, 1), train_ms,
                    time.perf_counter() - t0)
    cfg = lm_cfg or get_config(LM_ARCH)
    model = tf.init_params(cfg, None)
    caches = tf.init_caches(cfg, GEN_PROMPTS, LM_S_CACHE, "meta")
    t0 = time.perf_counter()
    tally = walk(tf.decode_step, model, caches, meta((GEN_PROMPTS, 1)),
                 meta((GEN_PROMPTS, 1)), cfg)
    out["decode"] = (tally, analysis.analyze(tally, 1), decode_ms,
                     time.perf_counter() - t0)
    cfg = md_cfg or dataclasses.replace(get_config(MD_ARCH), dtype="float32")
    mesh = md_mesh("meta")
    placed = specs.params_struct(cfg, mesh)
    batch = specs.batch_struct(cfg, mesh, ShapeConfig(
        "phase12", MD_LEN, MD_BATCH, "prefill"), labels=False)
    t0 = time.perf_counter()
    tally = walk(lambda: collectives.solo(mesh, lambda: tf.prefill(
        placed.view(0), batch, cfg, MD_S_CACHE)))
    out["placed_prefill"] = (tally, analysis.analyze(tally, mesh.size),
                             placed_prefill_ms, time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        out["dryrun"] = dryrun.run_cell(TRAIN_ARCH.replace("-", "_"),
                                        DRY_SHAPE, False, pathlib.Path(tmp),
                                        verbose=False)
    if out["dryrun"]["status"] != "ok":
        raise AssertionError(f"dry run: {out['dryrun']}")
    out["s"] = time.perf_counter() - t_start
    return out


def report_roofline(r) -> None:
    card = CARD[0]
    names = {"train": f"phase 10(a)'s step ({TRAIN_ARCH}, {TRAIN_BATCH} x "
                      f"{TRAIN_SEQ}, remat block)",
             "decode": f"phase 8's decode step ({LM_ARCH}, {GEN_PROMPTS} x "
                       f"1 against {LM_S_CACHE} cache slots)",
             "placed_prefill": f"phase 12(a)'s placed prefill ({MD_ARCH} "
                               f"f32, [{MD_BATCH}, {MD_LEN}], one rank of "
                               f"(data {MESH_SHAPE[0]}, model "
                               f"{MESH_SHAPE[1]}))"}
    for key, (t, rf, ms, walk_s) in ((k, r[k]) for k in names):
        bound_ms = rf.bound_s * 1e3
        log(f"[roofline] {names[key]}: {t.flops:.4g} operations "
            f"({t.dot_flops:.4g} in products), {t.bytes:.4g} bytes "
            f"op by op, {t.bytes_min:.4g} at fused boundaries, "
            f"{t.wire_bytes:.4g} wire bytes, {t.ops} ops walked in "
            f"{walk_s:.1f} s; bound {bound_ms:.3f} ms by {rf.dominant} "
            f"(compute {rf.compute_s * 1e3:.3f}, memory "
            f"{rf.memory_s * 1e3:.3f}, collective "
            f"{rf.collective_s * 1e3:.3f} ms at the H100 SXM data sheet's "
            f"989 TFLOP/s bf16, 3.35 TB/s, 450 GB/s); measured {ms:.3f} ms "
            f"({card}): {bound_ms / ms:.2%} of it")
    t = r["train"][0]
    log(f"[roofline] phase 10(a)'s step: {t.flops:.4g} operations against "
        f"PERF.md §2's hand estimate of {HAND_OPS_TRAIN:.2g} "
        f"({t.flops / HAND_OPS_TRAIN - 1:+.1%})")
    d = r["dryrun"]
    rl, mem = d["roofline"], d["memory_per_device"]
    log(f"[roofline] dryrun {d['arch']} x {d['shape']} on the single "
        f"production mesh ({d['chips']} devices): per device "
        f"{mem['total'] / 2**30:.3f} GiB placed (parameters "
        f"{mem['params'] / 2**20:.1f} MiB, AdamW {mem['opt'] / 2**20:.1f} "
        f"MiB, batch {mem['batch'] / 2**20:.2f} MiB), {rl['flops']:.4g} "
        f"operations, {rl['wire_bytes_per_device']:.4g} wire bytes; "
        f"compute {rl['compute_s']:.4g} s, memory {rl['memory_s']:.4g} s, "
        f"collective {rl['collective_s']:.4g} s: {rl['dominant']}")
    log(f"[roofline] dryrun {d['arch']} x {d['shape']}: "
        f"{rl['flops']:.4g} operations per device ({d['tally']['dot_flops']:.4g} "
        f"in products) in the reference's attention layouts, against "
        f"{DRY_OPS_BEFORE:.4g} when every model rank computed every head "
        f"({rl['flops'] / DRY_OPS_BEFORE:.3f} of it)")
    log(f"[roofline] phase 13 in {r['s']:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # 1536 by default (phase 6's reference, the least) keeps the whole run
    # inside its time limit with phases 11-13; --docs 2048, 3072, 4096 and
    # 8192 reproduce the hashes PERF.md records for them
    ap.add_argument("--docs", type=int, default=SHARD_DOCS,
                    help="documents phase 3 ingests (a multiple of 512, at "
                    f"least {SHARD_DOCS})")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.docs < SHARD_DOCS or args.docs % BATCH:
        ap.error(f"--docs must be a multiple of {BATCH}, at least "
                 f"{SHARD_DOCS} (phase 6's reference)")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    golden = load_test_module("_torch_golden")

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    CARD[0] = smi.stdout.strip() or smi.stderr.strip()
    log(f"[device] {CARD[0]}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; per kernel "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in _build.KERNELS:
        for entry, line in ptxas_report(name):
            log(f"[build] {name} {entry}: {line}")
    log(f"[build] SASS instruction counts: {sass_counts(_build.KERNELS)}")

    rng = np.random.default_rng(args.seed + 1)
    results = {
        "qboundary": check_qboundary(torch, dev, rng),
        "qgemm": check_qgemm(torch, dev, rng),
        "qtopk": check_qtopk(torch, dev, rng),
        "qcoarse": check_qcoarse(torch, dev, rng),
    }
    t0 = time.perf_counter()
    results["qhnsw_search"], results["qhnsw_insert"] = check_qhnsw(
        torch, dev, rng)
    log(f"[kernel] qhnsw holds in {time.perf_counter() - t0:.1f} s")
    for name, r in results.items():
        log(f"[kernel] {name} {r['shape']}: max_abs_err {r['max_abs_err']}, "
            f"mismatches {r['mismatches']}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
        if r["max_abs_err"] != 0 or r["mismatches"] != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    report_qhnsw(results["qhnsw_search"], results["qhnsw_insert"])
    report_qboundary(results["qboundary"])
    routes, wide_ms = check_qboundary_contracts(torch, dev, rng)
    for case, route in routes.items():
        log(f"[kernel] qboundary {case}: {route}, one launch, equals the "
            f"CPU's normalize_embedding bit for bit")
    log("[kernel] qboundary kernel alone, unit norm: " + ", ".join(
        f"{case} {ms:.4f} ms" for case, ms in wide_ms.items()))
    for name in ("qgemm", "qcoarse"):
        for case, path in results[name]["paths"].items():
            log(f"[kernel] {name} {case}: {path}")
    t0 = time.perf_counter()
    for case, path in check_search_contracts(torch, dev).items():
        log(f"[search] exact_search {case}: card == CPU (l2 and dot), "
            f"qgemm path {path}")
    log(f"[search] every storage type answered on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    r = results["qgemm"]
    log(f"[kernel] qgemm at the coarse re-rank's shape ([{QUERIES}, {DIM}] x "
        f"[{QUERIES * EF_COARSE}, {DIM}] gathered rows): {r['ms_rerank']:.4f} "
        f"ms (bound {r['bound_ms_rerank']:.4f} ms)")
    report_qtopk(results["qtopk"])
    report_per_shard(results)
    check_k_beyond_capacity(torch, dev)
    for case, ms in check_lm_widths(torch, dev, rng).items():
        log(f"[kernel] phase 9's shape {case}: equals the plain version bit "
            f"for bit; call {ms:.4f} ms ({CARD[0]})")

    counts, eng, flat_ref = run_engine(torch, dev, args.docs, args.seed)
    t0 = time.perf_counter()
    got = golden.check(dev)
    log(f"[golden] reference hashes reproduced on the card "
        f"({time.perf_counter() - t0:.1f} s): {got}")
    check_snapshots(torch, dev, eng)
    del eng

    t0 = time.perf_counter()
    durable = run_durable(torch, dev, args.seed)
    report_durable(durable)
    log(f"[durable] phase 5 in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sharded = run_sharded(torch, dev, args.seed, flat_ref)
    report_sharded(sharded, flat_ref["ingest_docs_s"])
    log(f"[sharded] phase 6 in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    network = run_network(torch, dev, args.seed, flat_ref, sharded)
    report_network(network, sharded)
    log(f"[network] phase 7 in {time.perf_counter() - t0:.1f} s "
        f"({CARD[0]})")

    t0 = time.perf_counter()
    lm = run_lm(torch, dev, args.seed)
    report_lm(lm)
    log(f"[lm] phase 8 in {time.perf_counter() - t0:.1f} s ({CARD[0]})")

    t0 = time.perf_counter()
    families = {}
    for arch in FAMILY_ARCHS:
        families[arch] = run_family(torch, dev, args.seed, arch)
        report_family(families[arch])
    report_phi(run_phi(torch, dev, args.seed))
    log(f"[families] phase 9 in {time.perf_counter() - t0:.1f} s "
        f"({CARD[0]})")

    fresh_card(torch)
    train = run_train(torch, dev, args.seed)
    report_train(train)
    log(f"[train] phase 10 in {train['s']:.1f} s ({CARD[0]})")

    from repro_torch import kernels
    new_counts = {}
    t0 = time.perf_counter()
    kernels.reset_launch_counts()  # ---- phase 11's main path starts ----
    for arch in EXT_ARCHS:
        report_external(run_external(torch, dev, args.seed, arch))
    new_counts["external"] = phase_counts(kernels)
    log(f"[external] phase 11 in {time.perf_counter() - t0:.1f} s "
        f"({CARD[0]})")

    kernels.reset_launch_counts()  # ---- phase 12's main path starts ----
    md = run_multidevice(torch, dev, args.seed)
    new_counts["multidevice"] = phase_counts(kernels)
    report_multidevice(md)
    log(f"[multidevice] phase 12 in {md['s']:.1f} s ({CARD[0]})")

    kernels.reset_launch_counts()  # ---- phase 13's main path starts ----
    tw = train["twice"]["runs"]
    roof = run_roofline(
        torch, statistics.median(tw[0]["ms"] + tw[1]["ms"]),
        lm["steps"]["decode_ms"], md["serve"]["runs"][1]["prefill_ms"])
    new_counts["roofline"] = phase_counts(kernels)
    report_roofline(roof)
    log(f"[phases 11-13] kernel launches (none is on their path): "
        f"{new_counts}")

    kern = [dict(name=name, route="cuda", source=SOURCES[name],
                 replaces=REPLACES[name], launches=counts[name],
                 launches_durable=durable["counts"][name],
                 launches_sharded=sharded["counts"][name],
                 launches_network=network["counts"][name],
                 launches_lm=lm["counts"][name],
                 launches_lm_families={arch: f["counts"][name]
                                       for arch, f in families.items()},
                 launches_train=train["coord"]["counts"][name],
                 launches_external=new_counts["external"][name],
                 launches_multidevice=new_counts["multidevice"][name],
                 launches_roofline=new_counts["roofline"][name],
                 max_abs_err=r["max_abs_err"], mismatches=r["mismatches"],
                 ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"],
                 **{key: v for key, v in r.items()
                    if key.endswith(("_at_ef_coarse", "_at_queries",
                                     "_sharded", "_default"))
                    or "per_shard" in key
                    or key in ("timing", "kernel_ms", "relink")})
            for name, r in results.items()]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
