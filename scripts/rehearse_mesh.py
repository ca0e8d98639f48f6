#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s mesh phase (b), (e) and (f)-(i) on the CPU,
to set their bars.

    PYTHONPATH=src python3 scripts/rehearse_mesh.py [--seeds 3] [--fault]
    python3 scripts/rehearse_mesh.py --card --seeds 1 --fault   # on the card
    PYTHONPATH=src python3 scripts/rehearse_mesh.py --grads [--card] --fault

The phase's (b) runs the train step on a (2, 1) mesh of two ``gloo`` ranks,
each taking B 1 of the phase's B 2 x 1,024 batches, and (e) on a (1, 2)
mesh of the same two ranks, each taking the whole batch on its half of the
heads, columns, vocabulary and sequence; (f)-(i) run Qwen3-30B-A3B's,
DeepSeek-V2-Lite's, Mamba2-1.3B's and Zamba2-7B's configs on the same (1,
2) mesh (each rank on half the experts, heads, latent rank or SSM
channels).  All are the partitioned route, held to the one-device steps on
the same draw ((a), and each family config's own).  Here the same
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
* ``model`` (read on (e) and (f)-(i)): the gradients of the leaves every
  "model" rank holds whole (the norms, and MLA's ``w_kr``) are not summed
  over "model", so each keeps the part its own sequence slice or heads
  gave.

``chip_smoke.MESH_BARS``, ``MESH_BARS_TP`` and ``MESH_BARS_FAMILY`` lie
between the sound readings (these and the card's) and the faults'.  With
``--card`` the legs (g)-(i) run at the phase's full width and depth on the
card, sound and with the ``model`` fault: there the random bf16 stacks
carry rounding far further than at smoke width.

``--grads`` rehearses (g)-(i)'s f32 first gradient instead
(``chip_smoke.mesh_grads_rank``; ``MESH_GRAD_BARS``), at smoke width on
the CPU or (``--card``) at the check's width and depth on the card.  Each
row is one rank's: the first loss's relative gap to one device's, and the
worst leaf's largest |difference| over the one-device leaf's largest
|value|.  Its faults are planted in the partitioned blocks, each read on
the legs it reaches (``AIMED_GRADS``):

* ``model``: as above (the norms, MLA's ``w_kr``);
* ``kv_mean``: MLA's latent norm takes the mean of squares over this
  rank's slice of the latent rank alone;
* ``heads_sum``: MLA's ``k_nope`` / ``v`` keep this rank's partial sums
  over its slice of the latent rank, unsummed;
* ``whole_bc``: the SSM's scan reads this rank's B / C columns twice in
  place of all 2N;
* ``gate_mean``: the SSM's gated norm takes the mean of squares over this
  rank's channels alone;
* ``shared_once``: the hybrid's shared block keeps the gradient of its
  second use only (the first use's weights detached).

Before them it reads each leg's bf16 rounding floor on one device
(:func:`rows_apart`): the first loss of the phase's batch against the mean
of each row's alone.
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

FAMILIES = tuple(chip_smoke.MESH_FAMILY_LEGS)   # (f)-(i)
LEGS = {"pair": chip_smoke.MESH_PAIR, "tp": chip_smoke.MESH_TP,
        **{leg: chip_smoke.MESH_TP for leg in FAMILIES}}
AIMED = {"data": ("pair",), "model": ("tp", *FAMILIES)}   # each fault's legs
# --card: the MLA-MoE, SSM and hybrid legs (g)-(i) ((f)'s bars were rehearsed
# at smoke width and hold on the card)
CARD_LEGS = ("mla", "ssm", "hybrid")
GRAD_LEGS = tuple(chip_smoke.MESH_GRAD_LEGS)
AIMED_GRADS = {"model": GRAD_LEGS, "kv_mean": ("mla",),
               "heads_sum": ("mla",), "whole_bc": ("ssm", "hybrid"),
               "gate_mean": ("ssm", "hybrid"), "shared_once": ("hybrid",)}


def plant_block(fault: str) -> None:
    """Plant one of ``AIMED_GRADS``' faults in the partitioned blocks
    (module docstring)."""
    from repro_torch.distributed.partition import Partition
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map
    if fault == "model":
        plant(fault)
        return
    if fault == "shared_once":
        block, uses = tfm._tp_block, []

        def first_detached(x, lp, cfg, part, stack="blocks"):
            if stack == "shared_attn":
                uses.append(stack)
                if len(uses) % 2:
                    lp = tree_map(lambda t: t.detach(), lp)
            return block(x, lp, cfg, part, stack)

        tfm._tp_block = first_detached
        return
    mla_args, ssm_args = Partition.mla_args, Partition.ssm_args
    keywords = {
        "kv_mean": (mla_args, lambda self: {"kv_mean": None}),
        "heads_sum": (mla_args, lambda self: {"heads_sum": lambda t: (
            t[:, :, self.heads] if self.heads_cut else t)}),
        "whole_bc": (ssm_args, lambda self: {
            "whole_bc": lambda t: torch.cat([t, t], -1)}),
        "gate_mean": (ssm_args, lambda self: {"gate_mean": None})}
    args, faulty = keywords[fault]
    setattr(Partition, args.__name__,
            lambda self: {**args(self), **faulty(self)})


def grads_rank(rank, device, fault, *args) -> dict:
    """``chip_smoke.mesh_grads_rank``, with ``fault`` planted (None:
    sound)."""
    if fault is not None:
        plant_block(fault)
    return chip_smoke.mesh_grads_rank(rank, device, *args)


@torch.no_grad()
def rows_apart(leg: str, device, smoke: bool, seed: int) -> dict:
    """The rounding floor of a leg's bf16 first loss on one device: its
    loss on the phase's first batch (B 2) against the mean of its loss on
    each row alone (other product shapes, the same arithmetic), at the
    leg's steps' depth."""
    cfg = chip_smoke.mesh_family_config(leg, smoke)
    model = chip_smoke.Model(cfg, params={})
    params = chip_smoke.mesh_params(cfg, device, None, seed)
    toks = chip_smoke.mesh_batches(cfg, device, seed)[0]["tokens"]
    whole = float(model.loss(params, {"tokens": toks}))
    apart = sum(float(model.loss(params, {"tokens": toks[i:i + 1]}))
                for i in range(len(toks))) / len(toks)
    del params
    if device.type == "cuda":
        chip_smoke.free_card()
    return {"seed": seed, "leg": leg, "fault": None,
            "bf16_loss": whole, "bf16_rows_apart_loss": apart,
            "bf16_rows_apart_gap": abs(apart / whole - 1)}


def rehearse_grads(seed: int, fault: bool, card: bool) -> list[dict]:
    """One seed's rows of the f32 first gradient, sound and (``fault``)
    under each fault on the legs it reaches; first, each leg's
    :func:`rows_apart`."""
    device = torch.device("cuda" if card else "cpu")
    rows = [rows_apart(leg, device, not card, seed) for leg in GRAD_LEGS]
    runs = [(None, GRAD_LEGS)]
    if fault:
        runs += list(AIMED_GRADS.items())
    for planted, legs in runs:
        ranks = spawn_ranks(grads_rank, 2, planted, not card, seed, legs,
                            backend="gloo", device="cuda" if card else "cpu")
        for rank, got in enumerate(ranks):
            for leg in legs:
                rows.append({"seed": seed, "leg": leg, "fault": planted,
                             "rank": rank, **got[leg]})
    return rows


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


def rehearse(seed: int, fault: bool, card: bool = False) -> list[dict]:
    """One seed's rows: at smoke width on the CPU, or (``card``) the legs
    ``CARD_LEGS`` at the mesh phase's full width on the card."""
    smoke = not card
    device = torch.device("cuda" if card else "cpu")
    all_legs = CARD_LEGS if card else tuple(LEGS)
    cfgs = {leg: chip_smoke.mesh_family_config(leg, smoke)
            for leg in FAMILIES if leg in all_legs}
    if smoke:
        cfgs["dense"] = chip_smoke.get_config(chip_smoke.MESH_ARCH).smoke()
    ones = {}
    for k, c in cfgs.items():
        ones[k] = chip_smoke.mesh_train(c, device, seed=seed)
        if card:
            chip_smoke.free_card()
    rows = []
    runs = [(sound_pair_rank, None, all_legs)]
    if fault:
        runs += [(fault_pair_rank, f, tuple(x for x in legs if x in all_legs))
                 for f, legs in AIMED.items()]
    for rank_fn, planted, legs in runs:
        if not legs:
            continue
        with tempfile.TemporaryDirectory() as root:
            pair = spawn_ranks(rank_fn, 2, planted, smoke, root, False, seed,
                               legs, backend="gloo", device=device.type)
            for leg in legs:
                kind = leg if leg in FAMILIES else "dense"
                one = ones[kind]
                gap = chip_smoke.mesh_gap(one["params"], root, device, leg,
                                          LEGS[leg], cfgs[kind])
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
    ap.add_argument("--card", action="store_true",
                    help="the family legs (g)-(i) at full width on the card "
                         "(two gloo ranks sharing it, the one-device steps "
                         "in this process)")
    ap.add_argument("--grads", action="store_true",
                    help="(g)-(i)'s f32 first gradient instead of the steps")
    args = ap.parse_args()
    chip_smoke.deterministic()
    torch.set_num_threads(2)
    rehearse_one = rehearse_grads if args.grads else rehearse
    rows = [r for s in range(args.seeds)
            for r in rehearse_one(s, args.fault, args.card)]
    for r in rows:
        print(json.dumps(r), flush=True)
    for key in sorted({(r["leg"], r["fault"] or "") for r in rows}):
        some = [r for r in rows if (r["leg"], r["fault"] or "") == key]
        keys = {k for r in some for k, v in r.items() if k.endswith((
            "gap", "differ", "over_cap", "over_leaf_max"))
            and isinstance(v, float)}
        read = {k: [r[k] for r in some if k in r] for k in sorted(keys)}
        print(json.dumps({"leg": key[0], "fault": key[1] or None,
                          **{k: max(v) for k, v in read.items()},
                          **{f"least_{k}": min(v) for k, v in read.items()}}))


if __name__ == "__main__":
    main()
