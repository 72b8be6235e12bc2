"""``{"op": "ingest", "n": N}``: one ``insert_documents`` of N new
documents, a span named ``ingest`` of N items. The memory's check
(rows, F's bookkeeping, the HNSW link) is the engine kind's."""
from __future__ import annotations


LIMITS: dict = {}


class Op:
    def __init__(self, wl):
        self.wl, self.calls = wl, 0

    def warm(self, entries) -> None:
        """One insert of each batch size the fill did not use."""
        sizes = sorted({int(e["n"]) for e in entries}
                       - {int(self.wl.mix["fill_batch"])})
        for j, n in enumerate(sizes):
            self.wl.ingest("warm.ingest", j, n, span=False)

    def run(self, entry) -> None:
        self.wl.ingest("ingest", self.calls, int(entry["n"]), span=True)
        self.calls += 1

    def check(self, out) -> tuple:
        return {}, {}
