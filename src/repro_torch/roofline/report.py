"""Roofline report: ``experiments/dryrun_torch/*.json`` -> the roofline table
(three terms, the dominant one, the useful share of the counted FLOPs, the
roofline fraction, the peak of live bytes and whether it fits one card).

Hardware model: one H100 SXM at its data-sheet peaks (NVIDIA H100 80GB
HBM3, 700.00 W): 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32
outside them (TF32 stays off), 3.35 TB/s HBM, 450 GB/s per direction of
NVLink, 80 GB of HBM.  On the JAX meshes (``single``, 16 x 16, and
``multi``, 2 x 16 x 16: 256 and 512 cards, 32 and 64 nodes of 8) a mesh
axis of 16 ranks spans two nodes, so the collective term takes the
inter-node rate of a card, ``POD_LINK_BYTES_PER_S``, where the ``one``
cells have no collective.  The compute term sums the products' FLOPs of each
dtype over that dtype's peak (a type without a tensor-core rate, f32 or
an integer, at the f32 rate) and every other FLOP over the f32 rate
outside the tensor cores: PyTorch's elementwise and reduction kernels
compute bf16 in f32.  The useful FLOPs, 6·N·tokens (train) or 2·N·tokens,
count every parameter, the embedding table's too, as the JAX report does,
so a model whose table is a large share of N (Mamba2) can read above 1.
The JAX package's report is the counterpart on a TPU v5e.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.roofline.report
    PYTHONPATH=src python -m repro_torch.roofline.report --tag mytag
    PYTHONPATH=src python -m repro_torch.roofline.report --mesh multi
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib

CARD = "H100 SXM data sheet, NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9   # per direction
# a card's link out of its node in a DGX H100 SuperPOD: one 400 Gb/s NDR
# InfiniBand port (ConnectX-7) per H100 (NVIDIA DGX H100 data sheet), per
# direction
POD_LINK_BYTES_PER_S = 400e9 / 8
HBM_CAPACITY_BYTES = 80e9

DRYRUN_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
              / "dryrun_torch")


def peak_flops(dtype: str) -> float:
    """The card's peak rate for operations in ``dtype`` (``"bfloat16"``)."""
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])


def kernel_bound_ms(work) -> tuple[float, str]:
    """Least time in ms a kernel's work
    (:class:`repro_torch.kernels.work.KernelWork`) takes
    on the card: its bytes over the HBM rate or its operations over the
    peak rate of their type, whichever is larger, and which it was."""
    t_bytes = work.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = work.flops / peak_flops(work.dtype) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def term_seconds(rec: dict) -> dict:
    oc = rec["op_cost"]
    products = oc["product_flops_by_dtype"]
    comp = (sum(f / peak_flops(dt) for dt, f in products.items())
            + (oc["flops_per_device"] - sum(products.values()))
            / PEAK_FLOPS["float32"])
    mem = oc["hbm_bytes_per_device"] / HBM_BYTES_PER_S
    coll = oc["total_collective_bytes"] / (
        POD_LINK_BYTES_PER_S if rec.get("mesh") in ("single", "multi")
        else NVLINK_BYTES_PER_S)
    dom = max(("compute", comp), ("memory", mem), ("collective", coll),
              key=lambda t: t[1])[0]
    step = max(comp, mem, coll)
    # useful model FLOPs: 6·N_active·tokens (train) / 2·N_active·tokens
    # (fwd), per device of the cell's mesh as the JAX report shares them (a
    # rank of the replicated route repeats its compute over "model", so its
    # useful share of what it counts is below one; the partitioned route
    # shares it)
    tokens = rec["global_batch"] * (rec["seq_len"] if rec["kind"] != "decode"
                                    else 1)
    mf = (6 if rec["kind"] == "train" else 2) * rec["n_active_params"] * tokens
    mf /= math.prod(rec.get("mesh_shape", {}).values())
    return {
        "compute_s": comp, "memory_s": mem, "collective_s": coll,
        "dominant": dom, "bound_step_s": step,
        "model_flops_per_dev": mf,
        "useful_flop_frac": mf / max(oc["flops_per_device"], 1),
        # the share of the bf16 peak the bound step would reach
        "roofline_frac": mf / (step * PEAK_FLOPS["bfloat16"]) if step else 0.0,
        "fits_one_card": rec["peak_live_bytes"] <= HBM_CAPACITY_BYTES,
    }


def load_cells(tag: str = "", dir: pathlib.Path | None = None) -> list[dict]:
    cells = []
    suffix = f"__{tag}.json" if tag else ".json"
    for p in sorted((dir or DRYRUN_DIR).glob(f"*{suffix}")):
        rec = json.loads(p.read_text())
        if tag and rec.get("tag") != tag:
            continue
        if not tag and rec.get("tag"):
            continue
        cells.append(rec)
    return cells


def fmt_engineering(x: float) -> str:
    for div, unit in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(x) >= div:
            return f"{x/div:.3g}{unit}"
    return f"{x:.3g}"


def markdown_table(cells: list[dict], mesh: str = "one") -> str:
    rows = []
    hdr = ("| arch | shape | compute | comp (ms) | mem (ms) | coll (ms) | "
           "dominant | useful/counted | roofline frac | peak GiB | "
           "fits one card |")
    sep = "|" + "---|" * 11
    rows.append(hdr)
    rows.append(sep)
    for rec in cells:
        if rec.get("mesh") != mesh:
            continue
        head = (f"| {rec['arch']} | {rec['shape']} | "
                f"{rec.get('compute', '—')} |")
        if rec.get("status") == "skipped":
            rows.append(f"{head} — | — | — | skipped | — | — | — | — |")
            continue
        if rec.get("status") != "ok":
            rows.append(f"{head} — | — | — | ERROR | — | — | — | — |")
            continue
        t = term_seconds(rec)
        peak = rec["peak_live_bytes"] / 2**30
        rows.append(
            f"{head} {t['compute_s']*1e3:.2f} | "
            f"{t['memory_s']*1e3:.2f} | {t['collective_s']*1e3:.2f} | "
            f"{t['dominant']} | {t['useful_flop_frac']:.2f} | "
            f"{t['roofline_frac']:.3f} | {peak:.2f} | "
            f"{'yes' if t['fits_one_card'] else 'no'} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default="one",
                    choices=["one", "single", "multi"])
    ap.add_argument("--dir", type=pathlib.Path, default=None,
                    help="e.g. experiments/dryrun_torch_baseline")
    args = ap.parse_args()
    cells = load_cells(args.tag, args.dir)
    print(f"peaks: {CARD}")
    print(markdown_table(cells, args.mesh))
    ok = [c for c in cells if c.get("status") == "ok" and c["mesh"] == args.mesh]
    if ok:
        worst = min(ok, key=lambda c: term_seconds(c)["roofline_frac"])
        print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']}")
        coll = [c for c in ok if term_seconds(c)["collective_s"]]
        if coll:
            most = max(coll, key=lambda c: term_seconds(c)["collective_s"]
                       / term_seconds(c)["bound_step_s"])
            print(f"most collective-bound:   {most['arch']}/{most['shape']}")


if __name__ == "__main__":
    main()
