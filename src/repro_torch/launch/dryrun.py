"""The dry-run: every (arch × shape × mesh) cell built on ``meta`` tensors
at its published full width and run once under :class:`OpCost`, which
counts its work op by op with each hand-written kernel charged its own
work.  The port's counterpart of the JAX package's dry-run, which lowers
and compiles each cell for TPU meshes and walks the HLO.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
    PYTHONPATH=src python -m repro_torch.roofline.report --mesh single

One json per cell (default ``experiments/dryrun_torch/``) with the JAX
record's keys where the port has a counterpart: ``status`` (``ok``,
``skipped`` with ``skip_reason``, or ``error`` with ``error`` and
``traceback``), ``n_params``, ``n_active_params``,
``param_bytes_per_device``, ``opt_bytes_per_device`` (train),
``cache_bytes_per_device`` (prefill and decode), ``mesh_shape``, the
count under ``op_cost`` (``OpCost.summary()``), and ``peak_live_bytes``
where the JAX record has XLA's ``memory_analysis``.

Meshes (``--mesh``): the JAX dry-run's ``single`` (16 x 16, one pod) and
``multi`` (2 x 16 x 16) at their sizes, and ``one``, one H100 running the
one-device step.  On ``single`` and ``multi`` the cell is rank 0's
(``build_cell(..., mesh=)`` on the mesh given as sizes: no rank is
spawned): its arguments are rank 0's shards under ``DEFAULT_RULES``, the
per-device bytes are ``tree_bytes_per_device``'s (the JAX record's), and
the count is rank 0's step on ``meta`` with its collectives charged by
kind and payload.  Each record names the step's route as ``"compute"``
(``launch.steps.compute_route``): the train cells of every family but
the encoder-decoder and the VLM stub are ``partitioned`` (the JAX
program's work per device: its heads, columns, experts, latent rank, SSM
channels and vocabulary rows, the sequence-parallel residual, per-layer
FSDP gathers), the other cells on a mesh ``replicated`` (the whole tree
gathered, the compute repeated over "model"), and the ``one`` cells
``one-device``.  The
FLOPs, bytes, collectives and peak are the port's eager program's, not
the TPU's.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import pathlib
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_config, skip_reason
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import tree_bytes_per_device
from ..models import Model
from ..models import transformer as tfm
from ..optim import AdamW
from ..roofline.op_cost import OpCost
from ..tree import leaves
from .mesh import make_production_mesh
from .steps import build_cell, compute_route

# the one-card cells' mesh, as sizes (per-device bytes = the whole tree's)
ONE = {"data": 1, "model": 1}
MESHES = {"one": None, "single": make_production_mesh(multi_pod=False),
          "multi": make_production_mesh(multi_pod=True)}

OUT_DEFAULT = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")

VLM_PREFILL_REASON = (
    "the port's prefill refuses patches: the reference's VLM prefill "
    "misplaces its cache (ROADMAP §3)")


def parse_overrides(pairs):
    out = {}
    for kv in pairs or ():
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def cell_id(arch, shape, mesh_kind, tag):
    return f"{arch}__{shape}__{mesh_kind}" + (f"__{tag}" if tag else "")


def port_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """The JAX ``skip_reason``, or the port's own: InternVL2's prefill with
    patches."""
    reason = skip_reason(cfg, shape.name)
    if reason is None and cfg.n_patches and shape.kind == "prefill":
        reason = VLM_PREFILL_REASON
    return reason


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    return sum(math.prod(shp) * dt.itemsize for shp, dt in
               tfm.cache_spec(cfg, batch, max_len).values())


def bytes_per_device(model: Model, shape: ShapeConfig, sizes: dict) -> dict:
    """The JAX record's ``param_bytes_per_device``, and
    ``opt_bytes_per_device`` (train) or ``cache_bytes_per_device``
    (prefill and decode), by ``tree_bytes_per_device`` on the mesh of
    ``sizes`` under ``DEFAULT_RULES``."""
    p_abs, axes = model.abstract(), model.axes()
    out = {"param_bytes_per_device": tree_bytes_per_device(axes, p_abs,
                                                           sizes)}
    if shape.kind == "train":
        mu = AdamW().abstract_state(p_abs).mu
        out["opt_bytes_per_device"] = tree_bytes_per_device(axes, mu,
                                                            sizes) * 2
    else:
        cache = {k: torch.empty(shp, dtype=dt, device="meta") for k, (shp, dt)
                 in tfm.cache_spec(model.cfg, shape.global_batch,
                                   shape.seq_len).items()}
        out["cache_bytes_per_device"] = tree_bytes_per_device(
            model.cache_axes(), cache, sizes)
    return out


def run_cell(arch: str, shape_name: str, out_dir: pathlib.Path,
             overrides: dict | None = None, tag: str = "",
             force: bool = False, *, smoke: bool = False,
             mesh: str = "one") -> dict:
    """Count one cell on ``meta`` and write its json (returned; a cell
    already written is read back unless ``force``).  ``smoke``: the arch's
    smoke config at the shape scaled for smoke (tagged ``smoke``).
    ``mesh``: ``"one"``, ``"single"`` or ``"multi"`` (module docstring)."""
    if smoke:
        tag = "smoke" + (f"-{tag}" if tag else "")
    sizes = MESHES[mesh]
    cid = cell_id(arch, shape_name, mesh, tag)
    path = out_dir / f"{cid}.json"
    if path.exists() and not force:
        rec = json.loads(path.read_text())
        # a record of another mesh under this name (the one-card cells
        # were once named "single") is counted again
        if rec.get("mesh_shape") == dict(sizes or ONE):
            return rec

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if smoke:
        cfg, shape = cfg.smoke(), shape.scaled_for_smoke()
    if overrides:
        cfg = cfg.with_(**overrides)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh, "tag": tag,
        "overrides": overrides or {}, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "kind": shape.kind,
        "mesh_shape": dict(sizes or ONE),
        "compute": compute_route(cfg, shape.kind, sizes),
    }
    reason = port_skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["skip_reason"] = reason
        path.write_text(json.dumps(rec, indent=1))
        return rec

    try:
        t0 = time.time()
        fn, args = build_cell(cfg, shape, mesh=sizes)
        rec["t_build_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        with OpCost(inputs=args) as oc:
            fn(*args)
        rec["t_count_s"] = round(time.time() - t0, 2)
        del fn, args
        rec["op_cost"] = oc.summary()
        rec["peak_live_bytes"] = rec["op_cost"]["peak_live_bytes"]

        model = Model(cfg, params={})
        rec["n_params"] = model.n_params()
        rec["n_active_params"] = model.n_active_params()
        rec.update(bytes_per_device(model, shape, rec["mesh_shape"]))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded result
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]

    path.write_text(json.dumps(rec, indent=1))
    return rec


def main():
    ap = argparse.ArgumentParser(description="dry-run: count every (arch × "
                                 "shape) cell's work on meta tensors")
    ap.add_argument("--arch", choices=ARCHS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--mesh", choices=["one", "single", "multi", "both"],
                    default="one",
                    help="one H100, the JAX single (16 x 16) or multi (2 x "
                         "16 x 16) mesh as rank 0, or both of those")
    ap.add_argument("--out", type=pathlib.Path, default=OUT_DEFAULT)
    ap.add_argument("--set", nargs="*", metavar="KEY=VAL", dest="overrides",
                    help="ModelConfig overrides, e.g. remat=dots")
    ap.add_argument("--tag", default="", help="suffix for override runs")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    args.out.mkdir(parents=True, exist_ok=True)
    overrides = parse_overrides(args.overrides)
    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    # cheapest cells first so early results stream out
    def cost_key(cell):
        a, s = cell
        return (Model(get_config(a), params={}).n_params()
                * SHAPES[s].seq_len * SHAPES[s].global_batch)

    cells = sorted(((a, s) for a in archs for s in shapes), key=cost_key)
    t_all = time.time()
    for (a, s), m in itertools.product(cells, meshes):
        rec = run_cell(a, s, args.out, overrides, args.tag, args.force,
                       mesh=m)
        status = rec["status"]
        extra = ""
        if status == "ok":
            oc = rec["op_cost"]
            extra = (f" flops={oc['flops_per_device']:.3g}"
                     f" bytes={oc['hbm_bytes_per_device']:.3g}"
                     f" coll={oc['total_collective_bytes']:.3g}B"
                     f" peak={rec['peak_live_bytes']/2**30:.2f}GiB"
                     f" ({rec.get('t_build_s', 0)}s build,"
                     f" {rec.get('t_count_s', 0)}s count)")
        elif status == "error":
            extra = " " + rec["error"][:120]
        print(f"[{time.time()-t_all:7.1f}s] {cell_id(a, s, m, rec['tag']):60s}"
              f" {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
