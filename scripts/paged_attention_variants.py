#!/usr/bin/env python3
"""Build-time variants of the paged attention kernel, timed in alternation.

    python3 scripts/paged_attention_variants.py [--variants NAME ...]

Each variant is ``csrc/paged_attention.cu`` with one line replaced (its
first match: the first instance family's kernel).  It is
compiled by ``nvcc`` with the port's flags into ``build/variants/``, and
called through the same C entry point as the kernel.  What each one shows:

* ``kernel``          — the source as it is;
* ``any_family``      — every shape through the second instance family
                        (``paged_attention_any_kernel``), the shapes the
                        first family takes too;
* ``table_per_page``  — each page's table entry is read when the page is
                        (no per-lane read of a warp's next 32 entries);
* ``rounds_4``        — four rounds of loads per chunk at every G (fewer
                        registers, so more clusters fit on the card at once);
* ``warps_8``         — eight warps per CTA instead of four;
* ``no_pages``        — every sequence is treated as empty: the launch, the
                        first loads, both combines and the output, i.e. the
                        fixed cost of a call;
* ``empty``           — the kernel returns at once: the launch of the grid of
                        clusters, timed by the same method.

For each variant it prints one JSON line with the registers and spills of
the G 2, D 128 instantiations (``-Xptxas -v``) and the clusters that can be
resident at once (``cudaOccupancyMaxActiveClusters``).  For each of
``chip_smoke.py``'s four first-family shapes (qwen3-1.7b's heads, Kh 8 and
G 2: bf16 and f32 at B 8, P 64, bf16 at B 32, P 256; Qwen3-30B-A3B's, Kh 4
and G 8: bf16 at B 8, P 64) it prints one line per variant: the median time
(``chip_smoke.Timer``: L2 flushed before each call, variants in
alternation) and the largest difference from the plain version.  The ``no_pages`` and ``empty``
variants compute nothing, so their differences are large.  Measurement
only: nothing is asserted.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

SRC = build.CSRC / "paged_attention.cu"
OUT = ROOT / "build" / "variants"

# variant -> (line of the source, its replacement)
EDITS = {
    "kernel": None,
    "any_family": ("return (D == 32 || D == 64 || D == 128) && (G == 1 || G == 2 || G == 4 || G == 8);",
                   "return false;"),
    "table_per_page": ("min(max(__shfl_sync(0xffffffffu, lane_page, i % 32), 0),",
                       "min(max(bt_row[j], 0),"),
    "rounds_4": ("R_MAX = G >= 8 ? 4 : 8;", "R_MAX = 4;"),
    "warps_8": ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
    "no_pages": ("if (n_pages > P) n_pages = P;", "n_pages = 0;"),
    "empty": ("constexpr int VEC = Tl::VEC, LPT = Tl::LPT, TPW = Tl::TPW, R = Tl::R;",
              "constexpr int VEC = Tl::VEC, LPT = Tl::LPT, TPW = Tl::TPW, R = Tl::R;"
              " if (Kh > 0) return;"),
}

# appended to each variant: resident clusters of the engine's instantiation
OCCUPANCY = r'''
extern "C" int max_active_clusters(int grid) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  int n = -1;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, (void*)paged_attention_kernel<__nv_bfloat16, __nv_bfloat16, 2, 128>,
      &cfg);
  return e == cudaSuccess ? n : -(int)e;
}
'''


def variant_source(name: str) -> str:
    text = SRC.read_text()
    edit = EDITS[name]
    if edit is not None:
        # the first match: the first instance family's kernel, ahead of
        # the second's in the source
        if edit[0] not in text:
            raise SystemExit(f"variant {name}: the line to replace is not in "
                             f"the source")
        text = text.replace(*edit, 1)
    # after the anonymous namespace, whose kernel and kThreads it can name
    return text + OCCUPANCY


def compile_all(names) -> dict[str, tuple[ctypes.CDLL, dict]]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(variant_source(name))
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{stdout}{stderr}")
        report = cs.ptxas_report(stdout + stderr)
        regs = {dt: {k: report[f"paged_attention_kernel<{t}, {t}, 2, 128>"][k]
                     for k in ("registers", "spill_store_bytes")}
                for dt, t in (("bf16", "__nv_bfloat16"), ("f32", "float"))}
        lib = ctypes.CDLL(str(so))
        lib.paged_attention.argtypes = build.SIGNATURES["paged_attention"]
        lib.paged_attention.restype = ctypes.c_int
        lib.max_active_clusters.argtypes = [ctypes.c_int]
        libs[name] = (lib, regs)
    return libs


def caller(lib, q, k_pool, v_pool, bt, lens, out):
    B, H, D = q.shape
    num_pages, T, Kh, _ = k_pool.shape
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
            lens.data_ptr(), out.data_ptr(), B, Kh, H // Kh, D, T, bt.shape[1],
            num_pages, 1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
            int(k_pool.dtype == torch.bfloat16))

    def call():
        rc = lib.paged_attention(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed (error {rc})")
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--variants", nargs="+", choices=list(EDITS),
                    default=list(EDITS))
    names = ap.parse_args().variants
    if not torch.cuda.is_available():
        raise SystemExit("paged_attention_variants: needs a CUDA card")
    smi = cs.card()
    print(smi, flush=True)
    libs = compile_all(names)
    for name, (lib, regs) in libs.items():
        print(json.dumps({"variant": name, "ptxas_G2_D128": regs,
                          "max_active_clusters": lib.max_active_clusters(512)}),
              flush=True)
    timer = cs.Timer(reps=40)
    for dtype, B, P, Kh, G in ((torch.bfloat16, 8, 64, 8, 2),
                               (torch.float32, 8, 64, 8, 2),
                               (torch.bfloat16, 32, 256, 8, 2),
                               (torch.bfloat16, 8, 64, 4, 8)):
        # chip_smoke.check_paged_attention's inputs
        g = torch.Generator(device="cuda").manual_seed(cs.SEED)
        D, T = 128, 16
        n_pages = B * P + 1
        q = torch.randn(B, Kh * G, D, generator=g, device="cuda").to(dtype)
        k_pool = torch.randn(n_pages, T, Kh, D, generator=g, device="cuda").to(dtype)
        v_pool = torch.randn(n_pages, T, Kh, D, generator=g, device="cuda").to(dtype)
        bt = torch.randperm(B * P, generator=g, device="cuda").view(B, P).to(torch.int32)
        lens = torch.randint(1, P * T + 1, (B,), generator=g, device="cuda",
                             dtype=torch.int32)
        lens[0], lens[1] = P * T, 1
        want = ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)
        calls, errs = [], []
        for lib, _ in libs.values():
            out = torch.empty_like(q)
            call = caller(lib, q, k_pool, v_pool, bt, lens, out)
            call()
            torch.cuda.synchronize()
            calls.append(call)
            errs.append(cs.max_err(out, want))
        for name, ms, err in zip(libs, timer(*calls), errs):
            print(json.dumps({"dtype": str(dtype), "B": B, "P": P, "Kh": Kh,
                              "G": G,
                              "tokens": int(lens.sum()), "variant": name,
                              "ms": ms, "max_abs_err": err}), flush=True)
        del q, k_pool, v_pool, want
        torch.cuda.empty_cache()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
