#!/usr/bin/env python3
"""sha256 digests of the paged attention kernel's outputs on the card, and
its mixed q / pool dtype pairs against the plain version.

    python3 scripts/paged_attention_digests.py [--src DIR] [--mixed]

``--src`` imports ``repro_torch`` from DIR (default: this checkout's
``src``), so the digests of two trees can be compared in one call: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and pass its ``src``.  Every case draws its inputs through
``tests/_torch_checks.paged_case``, as ``chip_smoke.py`` and the card tests
do, and its digests are held against ``_torch_checks.PAGED_SHA256``.
Prints one JSON line per case (same-dtype digests and whether each equals
the recorded one; with ``--mixed`` also the max |err| of each mixed pair
against ``ref.paged_attention_ref``) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--mixed", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT / "tests"))
    from repro_torch.kernels import ops, ref
    from _torch_checks import PAGED_SHA256, digest, paged_case

    if not torch.cuda.is_available():
        raise SystemExit("paged_attention_digests: needs a CUDA card")
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    for case, recorded in PAGED_SHA256.items():  # (B, P, Kh, G, D, page_T)
        row = {"case": case, "ops": ops.__file__}
        for dt, want in zip((torch.bfloat16, torch.float32), recorded):
            got = digest(ops.paged_attention(*paged_case(dt, dt, *case)))
            row[f"{names[dt]}/{names[dt]}"] = {"sha256": got,
                                              "recorded": got == want}
        if args.mixed:
            for q_dt, kv_dt in ((torch.float32, torch.bfloat16),
                                (torch.bfloat16, torch.float32)):
                inputs = paged_case(q_dt, kv_dt, *case)
                n0 = ops.launches["paged_attention"]
                got = ops.paged_attention(*inputs)
                torch.cuda.synchronize()
                want = ref.paged_attention_ref(*inputs)
                row[f"{names[q_dt]}/{names[kv_dt]}"] = {
                    "dtype": str(got.dtype),
                    "launches": ops.launches["paged_attention"] - n0,
                    "max_abs_err": float((got.float() - want.float()).abs().max())}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
