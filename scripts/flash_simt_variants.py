#!/usr/bin/env python3
"""Build-time variants of the flash kernel's CUDA-core route, timed in
alternation.

    python3 scripts/flash_simt_variants.py

Each variant is ``csrc/flash_attention.cu`` with lines of its CUDA-core
route replaced.  It is compiled by ``nvcc`` with the port's flags into
``build/variants/`` and called through the same C entry point as the
kernel.  What each one shows:

* ``kernel``            — the source as it is: 64 query rows (4 per thread)
                          and 64 kv rows per tile, one block per SM at D 128
                          (its shared memory);
* ``rows_32``           — 32 query rows per block (2 per thread): twice the
                          blocks, each K/V tile read from L2 once per 32
                          rows, and two blocks per SM by shared memory;
* ``rows_32_2_blocks``  — ``rows_32`` with the registers capped for two
                          blocks per SM (``__launch_bounds__(256, 2)``);
* ``kv_32``             — 32 kv rows per tile (2 logits per row and thread);
* ``kv_32_2_blocks``    — ``kv_32`` with the registers capped for two blocks
                          per SM.

For each variant it prints one JSON line with the registers and spills of
the f32 D 128 and D 192 instances (``-Xptxas -v``).  For each shape (f32:
qwen3-1.7b's heads at S 1,024 and at the prefix-hit shape, 512 rows at
``q_offset`` 512 over 1,024 keys; Nemotron-4-340B's H 96 / Kh 8 at D 192,
S 1,024) it prints one line per variant: the median time
(``chip_smoke.Timer``: L2 flushed before each call, variants in
alternation), the largest difference from the plain version, and whether
its output is bit for bit the kernel's (a variant that only regroups the
rows into blocks must be: a row's arithmetic does not depend on the other
rows of its block).  Measurement only: nothing is asserted.
"""

from __future__ import annotations

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
from repro_torch.kernels import build, ops, ref  # noqa: E402

SRC = build.CSRC / "flash_attention.cu"
OUT = ROOT / "build" / "variants"

ROWS_32 = ("constexpr int NI = 4;", "constexpr int NI = 2;")
KV_32 = ("constexpr int BK = 64;                   // kv rows per tile",
         "constexpr int BK = 32;                   // kv rows per tile")
TWO_BLOCKS = ("__global__ void __launch_bounds__(kThreads, 1)\nflash_fwd(",
              "__global__ void __launch_bounds__(kThreads, 2)\nflash_fwd(")
# variant -> the (line of the source, its replacement) pairs
EDITS = {
    "kernel": [],
    "rows_32": [ROWS_32],
    "rows_32_2_blocks": [ROWS_32, TWO_BLOCKS],
    "kv_32": [KV_32],
    "kv_32_2_blocks": [KV_32, TWO_BLOCKS],
}


def variant_source(name: str) -> str:
    text = SRC.read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the line to replace is not in "
                             f"the source once: {old!r}")
        text = text.replace(old, new)
    return text


def compile_all() -> dict[str, tuple[ctypes.CDLL, dict]]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in EDITS:
        cu, so = OUT / f"flash_{name}.cu", OUT / f"flash_{name}.so"
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
        regs = {D: {k: report[f"simt::flash_fwd<float, {D}>"][k]
                    for k in ("registers", "spill_store_bytes")}
                for D in (128, 192)}
        lib = ctypes.CDLL(str(so))
        lib.flash_attention.argtypes = build.SIGNATURES["flash_attention"]
        lib.flash_attention.restype = ctypes.c_int
        libs[name] = (lib, regs)
    return libs


def caller(lib, q, k, v, out, q_offset):
    B, Sq, H, D = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    layout = ops.flash_layout(q, k, v) + [ops._operand_strides("out", out)]
    strides = (ctypes.c_longlong * 12)(*(x for st in layout for x in st))

    def call():
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            B, H, Kh, Sq, Skv, D, 1.0 / math.sqrt(D), 1, q_offset, 0, 0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed (error {rc})")
    return call


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_simt_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.card()
    print(smi, flush=True)
    libs = compile_all()
    for name, (_, regs) in libs.items():
        print(json.dumps({"variant": name, "ptxas_f32": regs}), flush=True)
    timer = cs.Timer(reps=30)
    shapes = {"S1024": (16, 8, 128, 1024, 0), "hit": (16, 8, 128, 512, 512),
              "nemotron": (96, 8, 192, 1024, 0)}
    for shape, (H, Kh, D, Sq, off) in shapes.items():
        # chip_smoke's flash inputs: the seed's draws, q over all rows
        g = torch.Generator(device="cuda").manual_seed(cs.SEED)
        Skv = Sq + off
        q_all = torch.randn(1, Skv, H, D, generator=g, device="cuda")
        k = torch.randn(1, Skv, Kh, D, generator=g, device="cuda")
        v = torch.randn(1, Skv, Kh, D, generator=g, device="cuda")
        q = q_all[:, off:]
        want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=off)
        calls, outs = [], []
        for lib, _ in libs.values():
            out = torch.empty(q.shape, device="cuda")
            call = caller(lib, q, k, v, out, off)
            call()
            torch.cuda.synchronize()
            calls.append(call)
            outs.append(out)
        for name, ms, out in zip(libs, timer(*calls), outs):
            print(json.dumps({"shape": shape, "H": H, "Kh": Kh, "D": D,
                              "Sq": Sq, "q_offset": off, "variant": name,
                              "ms": ms, "max_abs_err": cs.max_err(out, want),
                              "bitwise_kernel": bool(torch.equal(out, outs[0]))
                              }), flush=True)
        del q_all, k, v, want, outs
        torch.cuda.empty_cache()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
