"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library for Hopper (``sm_90a``), loaded with ``ctypes``;
``csrc/*.cuh`` holds device code that several of them include.
Libraries are built at first use into ``build/repro_torch/`` at the root of
the checkout, keyed by a hash of the source, the headers and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.  ``build()``
starts one ``nvcc`` per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# no --use_fast_math: mdc_priority's parity with the JAX key rests on IEEE f32
# division.  --split-compile optimises a source's kernels on several threads:
# the build's time is its largest source's (paged attention's 48 instances),
# and it counts against chip_smoke.py's time limit; the code is the same
# (the card tests' sha256 digests of paged and flash attention hold)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--split-compile=4",
              "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PLL = ctypes.POINTER(ctypes.c_longlong)

# C entry point of each library: the function is named after the kernel
SIGNATURES = {
    # q, k_pool, v_pool, block_tables, seq_lens, out, B, Kh, G, D, page_T, P,
    # num_pages, scale, q_dtype, kv_dtype, stream
    "paged_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _F, _I, _I, _P],
    # pool, src, out, n_rows, m_rows, row_bytes, stream
    "segment_compact": [_P, _P, _P, _LL, _LL, _LL, _P],
    # q, k, v, out, strides (12 element strides), B, H, Kh, Sq, Skv, D,
    # scale, causal, q_offset, dtype, route, stream
    "flash_attention": [_P, _P, _P, _P, _PLL, _I, _I, _I, _I, _I, _I, _F, _I,
                        _I, _I, _I, _P],
    # live, up2, out, n, u_now, S, stream
    "mdc_priority": [_P, _P, _P, _LL, _F, _I, _P],
    # src0, src1, dst0, dst1, src_pages, dst_pages (host int32 arrays or
    # null), layers, n_pages, total, m0, n, row_bytes, stream
    "segment_move": [_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL,
                     _P],
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit (set CUDA_HOME or PATH)")


def library_path(name: str) -> Path:
    """Keyed by the source, the shared headers (``csrc/*.cuh``) and the
    flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, started together.  Returns, per kernel
    compiled here, its wall seconds and the compiler's ``-Xptxas -v`` report
    (registers, shared memory, spills).  Raises on the first failure, after
    stopping every compiler it started."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           tmp, out, time.perf_counter())
        info = {}
        for name, (proc, tmp, out, t0) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n{stdout}{stderr}")
            os.replace(tmp, out)
            info[name] = {"seconds": time.perf_counter() - t0,
                          "log": stdout + stderr}
        return info
    finally:
        for proc, tmp, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
