"""Dry run: one device's program of every (arch x shape) cell on the
production mesh, walked on the ``meta`` device (the port of
``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both

Each cell (``launch.specs.build_cell``) is walked op by op
(``roofline.op_walk``): nothing is allocated, compiled or run on a card.
A record holds the per-device bytes of the placed parameters, AdamW's
state, the batch and the caches, the walk's tally and the roofline on the
H100's data-sheet constants (``roofline.analysis``). Records land in
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json`` (``--out``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

from repro_torch.configs import ARCH_IDS, CANONICAL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models.config import SHAPES
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.op_walk import walk

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, verbose: bool = True) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        cell = build_cell(arch, shape_name, mesh)
        if cell.skip_reason:
            record.update(status="skip", reason=cell.skip_reason)
        else:
            tally = walk(cell.step)
            rf = roofline.analyze(tally, mesh.size)
            record.update(
                status="ok", chips=mesh.size,
                memory_per_device=dict(cell.memory,
                                       total=sum(cell.memory.values())),
                tally=tally.to_dict(), roofline=rf.to_dict(),
                walk_seconds=round(time.time() - t0, 1))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(record, indent=2))
    if verbose:
        status = record["status"]
        extra = ""
        if status == "ok":
            rl = record["roofline"]
            extra = (f" dominant={rl['dominant']}"
                     f" compute={rl['compute_s']:.2e}s"
                     f" memory={rl['memory_s']:.2e}s"
                     f" coll={rl['collective_s']:.2e}s"
                     f" bytes/device={record['memory_per_device']['total']}"
                     f" walk={record['walk_seconds']}s")
        elif status == "error":
            extra = " " + record["error"][:200]
        print(f"[dryrun] {tag}: {status}{extra}", flush=True)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id (canonical or module name) or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [
        CANONICAL.get(args.arch, args.arch.replace("-", "_").replace(".", "_"))
    ]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    out_dir = pathlib.Path(args.out)

    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                rec = run_cell(arch, shape, multi, out_dir)
                failures += rec["status"] == "error"
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
