"""``{"op": "read", "n": B, "k": K}``: one ``retrieve`` of B queries for
their K nearest documents, a span named ``read`` of B items.

The check (``reference.check.check_reads``) takes two samples drawn from
the seed: ``check.beam_reads`` of the reads made since the last insert,
whose ids and scores the reference's HNSW search over the program's
final graph must give, and ``check.score_reads`` of all the window's
reads, whose every score must be its id's exact squared distance, in
(score, id) order."""
from __future__ import annotations

from bench import generator, harness
from bench.reference.check import READ_LIMITS as LIMITS


class Op:
    def __init__(self, wl):
        self.wl = wl
        check = wl.mix.get("check", {})
        self.beam = harness.Reservoir(int(check.get("beam_reads", 0)),
                                      generator.derive_seed(wl.seed,
                                                            "check.beam", 0))
        self.scored = harness.Reservoir(int(check.get("score_reads", 0)),
                                        generator.derive_seed(
                                            wl.seed, "check.scored", 0))
        self.calls, self.version, self.routes = 0, None, set()

    def warm(self, entries) -> None:
        """One read of each (batch, k) the cycle reads."""
        shapes = sorted({(int(e["n"]), int(e["k"])) for e in entries})
        for j, (n, k) in enumerate(shapes):
            self.wl.system.read(self.wl.system.prepare(
                self.wl.gen.batch("warm", j, n)), k)

    def run(self, entry) -> None:
        wl, n, k = self.wl, int(entry["n"]), int(entry["k"])
        j = self.calls
        self.calls += 1
        queries = wl.system.prepare(wl.gen.batch("read", j, n))
        at = len(wl.rec.spans)
        with wl.rec.span("read", n):
            ids, scores = wl.system.read(queries, k)
        self.routes.add(wl.system.route())
        if self.version != wl.graph_version:
            self.beam.clear()
            self.version = wl.graph_version
        item = (j, n, k, ids, scores, at)
        self.beam.offer(item)
        self.scored.offer(item)

    def check(self, out) -> tuple:
        from bench.reference import check

        def with_queries(items):
            return [(out.gen.batch("read", j, n).cpu().numpy(), k,
                     ids, scores) for j, n, k, ids, scores, _ in items]

        answers, scores, searches, stats = check.check_reads(
            out.rows, out.state, int(out.cell.config["serve"]["ef"]),
            with_queries(self.beam.items), with_queries(self.scored.items))
        for entry, item in zip(searches, self.beam.items):
            entry["span"] = item[5]
        return ({"answers": answers, "scores": scores},
                {"hnsw_search": searches, "routes": sorted(self.routes),
                 "reads": self.calls, **stats})
