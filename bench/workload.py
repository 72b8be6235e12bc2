"""One cell's run: the set-up fill and warm-up, the closed loop over the
window, and what the check needs of both.

A mix's cycle is a list of entries run in order by one client, each
waiting for the last (a closed loop). Each names its operation,
``{"op": NAME, ...}``, which is the module ``ops/<NAME>.py``; an
operation with no module stops the run before set-up.

The set-up fills ``fill_rows`` documents in batches of ``fill_batch``,
then lets each operation warm the shapes its entries use, so that nothing
builds or warms up inside the window. Inputs are drawn outside the spans,
on the device, before each call.

Every insert call is one run of the HNSW link. The check replays the
fill's first run from an empty graph, and one more run drawn from the
seed (among the window's runs, or the fill's later ones where the window
inserts nothing) from the program's graph before it, against the
program's graph after it: the workload keeps those two snapshots.
"""
from __future__ import annotations

import time
from typing import Optional

from . import generator, harness


def host_snapshot(snap: Optional[dict]) -> Optional[dict]:
    """A graph snapshot's tensors as host arrays."""
    if snap is None:
        return None
    return {"n": snap["n"], "neighbors": snap["neighbors"].cpu().numpy(),
            "levels": snap["levels"].cpu().numpy(), "entry": snap["entry"]}


class Workload:
    def __init__(self, system, mix: dict, gen, seed: int,
                 recorder: harness.Recorder):
        self.system, self.mix, self.gen, self.rec = system, mix, gen, recorder
        self.seed = seed
        self.docs: list = []        # (stream, index, n) in ingest order
        self.acked: list = []
        self.first = None           # the graph after the fill's first run
        self.sampled = {p: harness.Reservoir(1, generator.derive_seed(
            seed, "sampled_run." + p, 0)) for p in ("fill", "window")}
        self.graph_version = 0      # insert calls so far
        self.in_window = False
        self._last_run = None
        names = list(dict.fromkeys(e["op"] for e in mix["cycle"]))
        self.ops = {n: harness.part("ops", n).Op(self) for n in names}

    def ingest(self, stream: str, index: int, n: int, span: bool) -> list:
        """``insert_documents`` of batch ``index`` of ``stream``."""
        docs = self.system.prepare(self.gen.batch(stream, index, n))
        snap = self.system.graph_snapshot()
        if self._last_run is not None:
            self._last_run["after"] = snap
        at = len(self.rec.spans) if span else None
        if span:
            with self.rec.span("ingest", n):
                ids = self.system.ingest(docs)
        else:
            ids = self.system.ingest(docs)
        run = {"call": len(self.docs), "before": snap, "after": None,
               "slots": range(snap["n"], snap["n"] + n), "span": at}
        if self.docs:
            self.sampled["window" if self.in_window else "fill"].offer(run)
        self.docs.append((stream, index, n))
        self.acked.extend(int(i) for i in ids)
        self._last_run = run
        self.graph_version += 1
        return ids

    def setup(self) -> None:
        rows, b = int(self.mix["fill_rows"]), int(self.mix["fill_batch"])
        for i in range((rows + b - 1) // b):
            self.ingest("fill", i, min(b, rows - i * b), span=False)
            if i == 0:
                self.first = host_snapshot(
                    self.system.graph_snapshot())
        for name, op in self.ops.items():
            op.warm([e for e in self.mix["cycle"] if e["op"] == name])

    def window(self, seconds: float) -> None:
        """Whole cycles until ``seconds`` have passed since the first."""
        self.in_window = True
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for entry in self.mix["cycle"]:
                self.ops[entry["op"]].run(entry)
        self.in_window = False

    def release(self) -> None:
        """Moves the sampled run's snapshots to the host and lets go of the
        system, before its memory is freed."""
        for p in self.sampled.values():
            p.items = [dict(r, before=host_snapshot(r["before"]),
                            after=host_snapshot(r["after"]))
                       for r in p.items]
        self._last_run = None
        self.system = None

    def sampled_run(self) -> Optional[dict]:
        """The run drawn for the check (after ``release``), or None. Its
        ``after`` is None where it was the last run: the graph after it is
        the final state's."""
        pool = self.sampled["window"].items or self.sampled["fill"].items
        return pool[0] if pool else None
