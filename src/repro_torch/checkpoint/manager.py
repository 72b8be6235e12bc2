"""Deterministic checkpoints of arbitrary trees, and a rotation policy over
a memory's ``DurableStore`` (paper §5.2/§8.1 snapshot semantics).

The port of ``repro.checkpoint.manager``, with the same directory layout:

  manifest.json  — step, FNV-1a tree hash (hashing.hash_pytree), leaf index
  <n>.npy        — one file per leaf, little-endian, in flattening order
                   (or, in dedup mode, chunk references into a shared
                   content-addressed ChunkStore)

A tree is a nested dict / list / tuple / dataclass of tensors or arrays.
Leaf paths are the strings ``jax.tree_util.keystr`` gives for the same
structure (``hashing._leaves``), so a checkpoint written by either package
loads in the other. Restore re-hashes and refuses a mismatch. The async
mode writes in a background thread; a failure there is recorded and
re-raised on the next ``save()`` / ``wait()``.

``DurableCheckpointManager`` applies the same rotation to a memory
``DurableStore``: each save appends the new commands to the WAL, writes an
incremental v2 snapshot, and retains the last ``keep`` (snapshot,
WAL-segment) pairs together.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.commands import CommandLog
from repro_torch.core.durability import DurableStore
from repro_torch.core.snapshot import ChunkStore
from repro_torch.core.state import MemoryState


def _rebuild(tree: Any, leaves: Iterator[Any]) -> Any:
    """``tree`` with its leaves (in ``hashing._leaves`` order) replaced by
    the next items of ``leaves``."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return next(leaves)
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)
            if not isinstance(getattr(tree, f.name), str)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    raise TypeError(f"unsupported tree node {type(tree)}")


def _to_host(tree: Any) -> Any:
    """The tree with every leaf as a host numpy array."""
    return _rebuild(tree, iter([hashing._np(leaf)
                                for _, leaf in hashing._leaves(tree)]))


def save_checkpoint(path: str | pathlib.Path, tree: Any, step: int,
                    chunk_store: Optional[ChunkStore] = None) -> int:
    """Write a checkpoint; returns the tree hash. With ``chunk_store``, leaf
    payloads go into the shared content-addressed store (deduplicated
    across steps) and the step directory holds only the manifest."""
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    index = []
    for i, (kp, leaf) in enumerate(hashing._leaves(tree)):
        arr = hashing._np(leaf)
        entry = {"path": kp, "dtype": str(arr.dtype), "shape": list(arr.shape)}
        if chunk_store is None:
            np.save(tmp / f"{i}.npy", arr)
        else:
            payload = arr.astype(arr.dtype.newbyteorder("<"),
                                 copy=False).tobytes()
            key, _ = chunk_store.put(payload)
            entry["chunk"] = f"{key:016x}"
        index.append(entry)
    h = hashing.hash_pytree(tree)
    (tmp / "manifest.json").write_text(json.dumps(
        {"step": step, "hash": f"{h:#x}", "leaves": index}))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)  # atomic-ish publish
    return h


def load_checkpoint(path: str | pathlib.Path, tree_like: Any,
                    chunk_store: Optional[ChunkStore] = None
                    ) -> Tuple[Any, int, int]:
    """Restore into the structure of ``tree_like``; verifies the hash.
    A leaf comes back as ``tree_like``'s leaf is: a tensor on that leaf's
    device, or a numpy array. Returns (tree, step, hash)."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    leaves = hashing._leaves(tree_like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"structure mismatch: {len(leaves)} leaves, manifest has "
            f"{len(manifest['leaves'])}")
    restored = []
    for i, ((kp, proto), meta) in enumerate(zip(leaves, manifest["leaves"])):
        if kp != meta["path"]:
            raise ValueError(
                f"leaf order mismatch at {i}: {kp} vs {meta['path']}")
        if "chunk" in meta:
            if chunk_store is None:
                raise ValueError(
                    f"{path} is a deduplicated checkpoint; pass its "
                    "ChunkStore to load it")
            dtype = np.dtype(meta["dtype"])
            payload = chunk_store.get(int(meta["chunk"], 16))
            arr = np.frombuffer(payload, dtype=dtype.newbyteorder("<")
                                ).astype(dtype).reshape(meta["shape"])
        else:
            arr = np.load(path / f"{i}.npy")
        if isinstance(proto, torch.Tensor):
            arr = torch.from_numpy(np.array(arr, copy=True)).to(proto.device)
        restored.append(arr)
    tree = _rebuild(tree_like, iter(restored))
    h = hashing.hash_pytree(tree)
    expect = int(manifest["hash"], 16)
    if h != expect:
        raise ValueError(
            f"checkpoint hash mismatch: manifest {expect:#x}, recomputed {h:#x}"
        )
    return tree, int(manifest["step"]), h


@dataclasses.dataclass
class CheckpointManager:
    """Rotating checkpoints + optional async writes + optional dedup."""

    directory: str
    keep: int = 3
    async_save: bool = True
    dedup: bool = False  # content-address leaves in a shared chunk store

    def __post_init__(self):
        self._dir = pathlib.Path(self.directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_hash: Optional[int] = None
        self._chunks = ChunkStore(self._dir / "chunks") if self.dedup else None

    def _ckpt_path(self, step: int) -> pathlib.Path:
        return self._dir / f"step_{step:08d}"

    def steps(self):
        out = []
        for p in sorted(self._dir.glob("step_*")):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def wait(self):
        """Join any in-flight write; re-raise an error it recorded. A save
        that failed in the background must not vanish."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def save(self, tree: Any, step: int) -> None:
        # copy to the host synchronously, write + rotate in the background
        host_tree = _to_host(tree)
        self.wait()  # raises here if the previous async save failed

        def work():
            try:
                self.last_hash = save_checkpoint(
                    self._ckpt_path(step), host_tree, step,
                    chunk_store=self._chunks)
                self._gc()
            except BaseException as e:  # noqa: BLE001 — recorded, re-raised
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("checkpoint save failed") from err

    def restore_latest(self, tree_like: Any) -> Optional[Tuple[Any, int, int]]:
        self.wait()
        steps = self.steps()
        if not steps:
            return None
        return load_checkpoint(self._ckpt_path(steps[-1]), tree_like,
                               chunk_store=self._chunks)

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._ckpt_path(s), ignore_errors=True)
        if self._chunks is not None:
            referenced = set()
            for s in self.steps():
                manifest = json.loads(
                    (self._ckpt_path(s) / "manifest.json").read_text())
                for meta in manifest["leaves"]:
                    if "chunk" in meta:
                        referenced.add(int(meta["chunk"], 16))
            for key in self._chunks.keys():
                if key not in referenced:
                    self._chunks.delete(key)


class DurableCheckpointManager:
    """Rotation policy over a memory DurableStore: append → snapshot →
    retain the newest ``keep`` (snapshot, WAL-segment) pairs. Background
    failures surface on the next call, as in ``CheckpointManager``."""

    def __init__(self, directory: str, genesis: Optional[MemoryState] = None,
                 *, keep: int = 3, async_save: bool = False, **store_kwargs):
        self.store = DurableStore(directory, genesis, **store_kwargs)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_stats: Optional[Dict[str, int]] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async durable checkpoint failed") from err

    def save(self, state: MemoryState,
             new_commands: Optional[CommandLog] = None) -> None:
        """Durably persist ``state``: append its new commands (if any) to
        the WAL, snapshot at its cursor, age out old pairs."""
        self.wait()
        host_state = state.to("cpu")

        def work():
            try:
                if new_commands is not None:
                    self.store.append(new_commands)
                stats = self.store.checkpoint(host_state)
                stats.update(self.store.retain(self.keep))
                self.last_stats = stats
            except BaseException as e:  # noqa: BLE001 — recorded, re-raised
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("durable checkpoint failed") from err

    def recover(self) -> Tuple[MemoryState, int, int]:
        """(state, hash, t) at the last durable prefix."""
        self.wait()
        return self.store.recover()
