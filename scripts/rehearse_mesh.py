#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s mesh phase (b), (e) and (f) on the CPU, to
set their bars.

    PYTHONPATH=src python3 scripts/rehearse_mesh.py [--seeds 3] [--fault]

The phase's (b) runs the train step on a (2, 1) mesh of two ``gloo`` ranks,
each taking B 1 of the phase's B 2 x 1,024 batches, and (e) on a (1, 2)
mesh of the same two ranks, each taking the whole batch on its half of the
heads, columns, vocabulary and sequence; (f) runs Qwen3-30B-A3B's config
on the same (1, 2) mesh, each rank on half the experts.  All are the
partitioned route, held to the one-device steps on the same draw ((a), and
the MoE config's own).  Here the same
functions (``chip_smoke.mesh_train``, ``mesh_pair_rank``, ``mesh_gap``)
run at the smoke config's width in its bf16 params, on two CPU ranks,
``MESH_STEPS`` AdamW steps of the phase's optimizer, once per seed of the
draw.  Each seed prints one JSON line per leg: the largest relative gap of
the losses, the share of param elements that differ, and the largest
difference over its cap (one unit in the last place of the one-device
value plus 2 lr per step); then the least and largest of each over the
seeds, per leg and fault.

With ``--fault`` each seed runs two more pairs of ranks, each with one
fault planted, and each leg is read under the fault aimed at it:

* ``data`` (read on (b)): the gradients are not summed over "data", so
  each rank updates its shards with its own rows' gradient (and clips by
  its norm), while the loss still comes back as the mean over the ranks;
* ``model`` (read on (e) and (f)): the gradients of the leaves every
  "model" rank holds whole (the norms, here) are not summed over "model",
  so each keeps the part its own sequence slice gave.

``chip_smoke.MESH_BARS`` and ``MESH_BARS_TP`` lie between the sound
readings (these and the card's) and the faults'.
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

LEGS = {"pair": chip_smoke.MESH_PAIR, "tp": chip_smoke.MESH_TP,
        "moe": chip_smoke.MESH_TP}
AIMED = {"data": ("pair",), "model": ("tp", "moe")}   # each fault's legs


def plant(fault: str) -> None:
    """Take the gradients' sum over the ``fault`` axis out of the
    partitioned step."""
    from repro_torch.distributed import collectives, partition
    axes = partition.grad_sum_axes
    partition.grad_sum_axes = lambda spec, mesh: tuple(
        a for a in axes(spec, mesh) if a != fault)
    if fault == "data":
        # the FSDP gathers' backward keeps this rank's own part of its
        # gradient, as its own rows gave it (the loss is scaled by the
        # batch's ranks before the backward)
        scatter = collectives.reduce_scatter

        def own_part(t, dim, part, mesh):
            if part != "data":
                return scatter(t, dim, part, mesh)
            n = collectives.spec_shards((part,), mesh)
            k = t.shape[dim] // n
            i = collectives._index(("data",), mesh)
            return t.narrow(dim, i * k, k).contiguous() * n

        collectives.reduce_scatter = own_part


def fault_pair_rank(rank, device, fault, *args) -> dict:
    """``chip_smoke.mesh_pair_rank`` with ``fault`` planted."""
    plant(fault)
    return chip_smoke.mesh_pair_rank(rank, device, *args)


def sound_pair_rank(rank, device, fault, *args) -> dict:
    return chip_smoke.mesh_pair_rank(rank, device, *args)


def rehearse(seed: int, fault: bool) -> list[dict]:
    cfgs = {"dense": chip_smoke.get_config(chip_smoke.MESH_ARCH).smoke(),
            "moe": chip_smoke.mesh_moe_config(True)}
    ones = {k: chip_smoke.mesh_train(c, torch.device("cpu"), seed=seed)
            for k, c in cfgs.items()}
    rows = []
    runs = [(sound_pair_rank, None, tuple(LEGS))]
    if fault:
        runs += [(fault_pair_rank, f, legs) for f, legs in AIMED.items()]
    for rank_fn, planted, legs in runs:
        with tempfile.TemporaryDirectory() as root:
            pair = spawn_ranks(rank_fn, 2, planted, True, root, False, seed,
                               legs, backend="gloo", device="cpu")
            for leg in legs:
                kind = "moe" if leg == "moe" else "dense"
                one = ones[kind]
                gap = chip_smoke.mesh_gap(one["params"], root,
                                          torch.device("cpu"), leg, LEGS[leg],
                                          cfgs[kind])
                got = pair[0][leg]["loss"]
                loss = np.array(got) / np.array(one["loss"]) - 1
                whole = {f"model_whole_{k}": v for k, v in gap.pop(
                    "model_whole", {}).items()}
                rows.append({"seed": seed, "leg": leg, "fault": planted,
                             "loss_one": one["loss"], "loss_mesh": got,
                             "loss_max_rel_gap": float(np.abs(loss).max()),
                             **gap, **whole})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--fault", action="store_true",
                    help="also run each seed with each fault planted")
    args = ap.parse_args()
    chip_smoke.deterministic()
    torch.set_num_threads(2)
    rows = [r for s in range(args.seeds) for r in rehearse(s, args.fault)]
    for r in rows:
        print(json.dumps(r), flush=True)
    for key in sorted({(r["leg"], r["fault"] or "") for r in rows}):
        some = [r for r in rows if (r["leg"], r["fault"] or "") == key]
        keys = [k for k, v in some[0].items() if k.endswith((
            "gap", "differ", "over_cap")) and isinstance(v, float)]
        print(json.dumps({"leg": key[0], "fault": key[1] or None,
                          **{k: max(r[k] for r in some) for k in keys},
                          **{f"least_{k}": min(r[k] for r in some)
                             for k in keys}}))


if __name__ == "__main__":
    main()
