#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s mesh phase (b) on the CPU, to set its bars.

    PYTHONPATH=src python3 scripts/rehearse_mesh.py [--seeds 3]

The phase's (b) runs the train step on a (2, 1) mesh of two ``gloo`` ranks,
each taking B 1 of the phase's B 2 x 1,024 batches, and holds its losses
and params to (a), the one-device steps on the same draw.  Here the same
functions (``chip_smoke.mesh_train``, ``mesh_pair_rank``, ``mesh_gap``)
run at the smoke config's width in its bf16 params, on two CPU ranks,
three AdamW steps of the phase's optimizer, once per seed of the draw.
Each seed prints one JSON line: the largest relative gap of the losses,
the share of param elements that differ, and the largest difference over
its cap (one unit in the last place of the one-device value plus 2 lr per
step); then the largest of each over the seeds.

With ``--fault`` each seed runs a second pair of ranks with one fault
planted: the gradients are not all-reduced, so each rank updates its shards
with its own batch's gradient (and clips by that gradient's norm), while
the loss still comes back as the mean over the ranks.  Its lines carry
``"fault": true``.  ``chip_smoke.MESH_BARS`` lies between the sound
readings (these and the card's) and the fault's.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402


def fault_pair_rank(rank, device, *args) -> dict:
    """``chip_smoke.mesh_pair_rank`` with the gradients' all-reduce taken
    out of the sharded step (the 0-d loss is still reduced)."""
    from repro_torch.launch import steps
    reduce = steps.all_reduce_mean
    steps.all_reduce_mean = lambda t, part, mesh: (
        reduce(t, part, mesh) if t.dim() == 0 else t)
    return chip_smoke.mesh_pair_rank(rank, device, *args)


def rehearse(seed: int, fault: bool) -> list[dict]:
    cfg = chip_smoke.get_config(chip_smoke.MESH_ARCH).smoke()
    one = chip_smoke.mesh_train(cfg, torch.device("cpu"), seed=seed)
    rows = []
    for rank_fn in (chip_smoke.mesh_pair_rank, fault_pair_rank)[:1 + fault]:
        with tempfile.TemporaryDirectory() as root:
            pair = spawn_ranks(rank_fn, 2, True, root, False, seed,
                               backend="gloo", device="cpu")
            gap = chip_smoke.mesh_gap(one["params"], root,
                                      torch.device("cpu"))
        loss = np.array(pair[0]["loss"]) / np.array(one["loss"]) - 1
        rows.append({"seed": seed, "fault": rank_fn is fault_pair_rank,
                     "loss_one": one["loss"], "loss_pair": pair[0]["loss"],
                     "loss_max_rel_gap": float(np.abs(loss).max()), **gap})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--fault", action="store_true",
                    help="also run each seed with the gradients' "
                         "all-reduce taken out")
    args = ap.parse_args()
    chip_smoke.deterministic()
    torch.set_num_threads(2)
    rows = [r for s in range(args.seeds) for r in rehearse(s, args.fault)]
    for r in rows:
        print(json.dumps(r), flush=True)
    keys = ("loss_max_rel_gap", "share_differ", "worst_over_cap")
    for fault in sorted({r["fault"] for r in rows}):
        some = [r for r in rows if r["fault"] == fault]
        print(json.dumps({"fault": fault,
                          **{k: max(r[k] for r in some) for k in keys},
                          **{f"least_{k}": min(r[k] for r in some)
                             for k in keys}}))


if __name__ == "__main__":
    main()
