"""The embedding engine: ``MemoryAugmentedEngine(d_model,
ServeConfig(**serve))`` of the port (``repro_torch.serve.engine``),
driven only through its public calls; documents and queries are float32
embeddings on the card. ``state`` and ``graph_snapshot`` read the
engine's memory to hand the program's outputs to the check.

The check (``reference.check.compare``): every stored row against the
reference's boundary, F's bookkeeping, and the HNSW link's sampled runs.
The control puts the reference's float32 boundary in the program's
place."""
from __future__ import annotations

import contextlib

from bench.reference.check import MEMORY_LIMITS as LIMITS


def serve_config(serve: dict):
    from repro_torch.core.contracts import get_contract
    from repro_torch.serve.engine import ServeConfig
    fields = dict(serve)
    fields["contract"] = get_contract(fields.pop("contract"))
    return ServeConfig(**fields)


class System:
    kind = "embedding"

    def __init__(self, config: dict, device, seed: int = 0):
        from repro_torch.serve.engine import MemoryAugmentedEngine
        self.d_model = int(config["d_model"])
        self.engine = MemoryAugmentedEngine(
            self.d_model, serve_config(config["serve"]), device=device)

    def prepare(self, x):
        """An input as the caller hands it over: embeddings on the card."""
        return x

    def ingest(self, docs) -> list:
        return self.engine.insert_documents(docs)

    def read(self, queries, k: int):
        return self.engine.retrieve(queries, k=k)

    def route(self) -> str:
        return self.engine.last_plan.route

    def graph_snapshot(self) -> dict:
        """A device copy of the graph over the rows written so far."""
        mem = self.engine.memory
        n = int(mem.cursor)
        return {"n": n, "neighbors": mem.hnsw_neighbors[:, :n].clone(),
                "levels": mem.hnsw_levels[:n].clone(),
                "entry": int(mem.hnsw_entry)}

    def state(self) -> dict:
        """The program's memory as host arrays: rows and graph over the rows
        written, the bookkeeping over the whole arena."""
        mem = self.engine.memory
        n = int(mem.cursor)
        return {
            "vectors": mem.vectors[:n].cpu().numpy(),
            "ids": mem.ids.cpu().numpy(), "valid": mem.valid.cpu().numpy(),
            "links": mem.links[:n].cpu().numpy(),
            "meta": mem.meta[:n].cpu().numpy(),
            "neighbors": mem.hnsw_neighbors[:, :n].cpu().numpy(),
            "levels": mem.hnsw_levels.cpu().numpy(),
            "entry": int(mem.hnsw_entry), "count": int(mem.count),
            "cursor": n, "version": int(mem.version),
            "contract": mem.contract_name,
            "degree": mem.hnsw_neighbors.shape[2],
            "max_levels": mem.hnsw_neighbors.shape[0],
        }

    def facts(self, mix: dict) -> dict:
        """Static sizes the per-layer metrics read."""
        mem = self.engine.memory
        return {"d_model": self.d_model,
                "row_bytes": mem.vectors.element_size()}

    def close(self) -> None:
        self.engine.close()


def build(config: dict, device, seed: int):
    return System(config, device, seed)


def check(out) -> tuple:
    import numpy as np
    from bench.reference import check as ref
    wl = out.workload
    docs = np.concatenate([out.gen.batch(s, i, n).cpu().numpy()
                           for s, i, n in wl.docs])
    checks, work, out.rows = ref.compare(docs, wl.acked, out.state, wl.first,
                                         wl.sampled_run())
    return checks, work


@contextlib.contextmanager
def control():
    """The reference's float32 boundary in the program's place."""
    import numpy as np
    import torch
    from bench.reference import boundary as ref_boundary
    from repro_torch.core import boundary as prog_boundary

    def normalize_embedding(x, contract, unit_norm=True):
        x = torch.as_tensor(x).to(torch.float32)
        raw = ref_boundary.normalize_float32(
            x.reshape(-1, x.shape[-1]).cpu().numpy(), contract.name)
        return torch.from_numpy(np.ascontiguousarray(raw)).to(
            x.device).reshape(x.shape).to(contract.storage_dtype)

    program = prog_boundary.normalize_embedding
    prog_boundary.normalize_embedding = normalize_embedding
    try:
        yield
    finally:
        prog_boundary.normalize_embedding = program
