"""The dry-run: every (arch × shape) cell built on ``meta`` tensors at its
published full width and run once under :class:`OpCost`, which counts its
work op by op with each hand-written kernel charged its own work.  The
port's counterpart of the JAX package's dry-run, which lowers and compiles
each cell for TPU meshes and walks the HLO.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.roofline.report

One json per cell (default ``experiments/dryrun_torch/``) with the JAX
record's keys where the port has a counterpart: ``status`` (``ok``,
``skipped`` with ``skip_reason``, or ``error`` with ``error`` and
``traceback``), ``n_params``, ``n_active_params``,
``param_bytes_per_device``, ``opt_bytes_per_device`` (train),
``cache_bytes_per_device`` (prefill and decode), the count under
``op_cost`` (``OpCost.summary()``), and ``peak_live_bytes`` where the JAX
record has XLA's ``memory_analysis``.  The mesh is ``single``, one H100:
the JAX meshes are 256- and 512-chip TPU pods, and the port trains on one
device.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

from ..configs import ARCHS, SHAPES, get_config, skip_reason
from ..configs.base import ModelConfig, ShapeConfig
from ..models import Model
from ..models import transformer as tfm
from ..optim import AdamW
from ..roofline.op_cost import OpCost
from ..tree import leaves
from .steps import build_cell

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


def run_cell(arch: str, shape_name: str, out_dir: pathlib.Path,
             overrides: dict | None = None, tag: str = "",
             force: bool = False, *, smoke: bool = False) -> dict:
    """Count one cell on ``meta`` and write its json (returned; a cell
    already written is read back unless ``force``).  ``smoke``: the arch's
    smoke config at the shape scaled for smoke (tagged ``smoke``)."""
    if smoke:
        tag = "smoke" + (f"-{tag}" if tag else "")
    mesh_kind = "single"
    cid = cell_id(arch, shape_name, mesh_kind, tag)
    path = out_dir / f"{cid}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if smoke:
        cfg, shape = cfg.smoke(), shape.scaled_for_smoke()
    if overrides:
        cfg = cfg.with_(**overrides)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "overrides": overrides or {}, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "kind": shape.kind,
    }
    reason = port_skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["skip_reason"] = reason
        path.write_text(json.dumps(rec, indent=1))
        return rec

    try:
        t0 = time.time()
        fn, args = build_cell(cfg, shape)
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
        p_abs = model.abstract()
        rec["param_bytes_per_device"] = tree_bytes(p_abs)
        if shape.kind == "train":
            o_abs = AdamW().abstract_state(p_abs)
            rec["opt_bytes_per_device"] = tree_bytes(o_abs.mu) * 2
        if shape.kind in ("decode", "prefill"):
            rec["cache_bytes_per_device"] = cache_bytes(
                cfg, shape.global_batch, shape.seq_len)
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
    ap.add_argument("--mesh", choices=["single"], default="single",
                    help="one H100 (the only mesh of the port's dry-run)")
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

    # cheapest cells first so early results stream out
    def cost_key(cell):
        a, s = cell
        return (Model(get_config(a), params={}).n_params()
                * SHAPES[s].seq_len * SHAPES[s].global_batch)

    cells = sorted(((a, s) for a in archs for s in shapes), key=cost_key)
    t_all = time.time()
    for a, s in cells:
        rec = run_cell(a, s, args.out, overrides, args.tag, args.force)
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
        print(f"[{time.time()-t_all:7.1f}s] {cell_id(a, s, 'single', rec['tag']):60s}"
              f" {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
