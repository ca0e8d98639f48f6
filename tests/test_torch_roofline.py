"""The port's op counter and its kernels' work.

``OpCost`` is held to what ``tests/test_roofline.py`` holds the JAX
package's ``HloCost`` to (one product's FLOPs and bytes, a loop of them,
bytes that grow with the tensor), and to the rules of its own (views cost
nothing, FLOPs by dtype, in-place and indexed writes, the peak of live
bytes).  Every kernel wrapper charges exactly its work function's figures,
and what it moves around the launch (a padded head dim, a staged move, a
cast), on CPU tensors (the plain version's own ops add nothing) and on
``meta`` ones (with the kernel's output shape and dtype); with no counter
a wrapper touches nothing of the hook; and the work functions give
PERF.md's bound column at its shapes.  ``gather_heads`` charges its
all-gather's payload in a two-rank ``gloo`` run.  No JAX here: the JAX
side of the count is ``tests/test_torch_dryrun.py``'s.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, work
from repro_torch.launch import mesh as tp_mesh
from repro_torch.roofline import report
from repro_torch.roofline.op_cost import OpCost

import _torch_tp as tp


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEVICES = ("cpu", "meta")


def _rand(shape, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


# ------------------------------------------------------------------ OpCost

@pytest.mark.parametrize("device", DEVICES)
def test_single_matmul_flops_and_bytes(device):
    M, K, N = 256, 512, 128
    a, b = _rand((M, K), device=device), _rand((K, N), device=device, seed=1)
    with OpCost() as oc:
        a @ b
    s = oc.summary()
    assert s["flops_per_device"] == 2 * M * K * N
    assert s["flops_by_dtype"] == {"float32": 2 * M * K * N}
    assert s["product_flops_by_dtype"] == {"float32": 2 * M * K * N}
    assert s["hbm_bytes_per_device"] == (M * K + K * N + M * N) * 4
    assert s["kernel_charges"] == {} and s["total_collective_bytes"] == 0


@pytest.mark.parametrize("device", DEVICES)
def test_matmuls_in_a_loop_count_L_times_one(device):
    L, D = 8, 128
    ws = _rand((L, D, D), device=device)
    x = _rand((4, D), device=device, seed=1)
    with OpCost() as one:
        x @ ws[0]
    with OpCost() as oc:
        h = x
        for i in range(L):
            h = h @ ws[i]
    assert one.summary()["flops_per_device"] == 2 * 4 * D * D
    assert oc.summary()["flops_per_device"] == L * 2 * 4 * D * D
    assert oc.summary()["hbm_bytes_per_device"] == (
        L * one.summary()["hbm_bytes_per_device"])


@pytest.mark.parametrize("device", DEVICES)
def test_bytes_scale_with_tensor_size(device):
    def cost(n):
        x = _rand((n, n), device=device)
        with OpCost() as oc:
            x * 2.0
        return oc.summary()

    small, big = cost(128), cost(512)
    assert big["hbm_bytes_per_device"] > 10 * small["hbm_bytes_per_device"]
    assert small["hbm_bytes_per_device"] == 2 * 128 * 128 * 4
    assert small["flops_per_device"] == 128 * 128


@pytest.mark.parametrize("device", DEVICES)
def test_views_cost_nothing(device):
    x = _rand((4, 6, 8), device=device)
    with OpCost() as oc:
        v = x.view(24, 8)
        x.reshape(4, 48)
        x.transpose(0, 2)
        x[:, 1:3]
        x[2]
        x[:, None].expand(4, 5, 6, 8)
        x.as_strided((2, 2), (1, 1))
        v.t().unbind(0)
        x.permute(2, 0, 1).unsqueeze(0).squeeze(0)
    s = oc.summary()
    assert s["hbm_bytes_per_device"] == 0 and s["flops_per_device"] == 0
    assert s["n_ops"] == 0 and s["peak_live_bytes"] == 0


@pytest.mark.parametrize("device", DEVICES)
def test_flops_split_by_dtype(device):
    a16, b16 = (_rand((64, 32), torch.bfloat16, device, s) for s in (0, 1))
    a32, b32 = (_rand((16, 48), torch.float32, device, s) for s in (2, 3))
    with OpCost() as oc:
        a16 @ b16.T
        a32 @ b32.T
        a32 + 1.0
    assert oc.summary()["flops_by_dtype"] == {
        "bfloat16": 2.0 * 64 * 32 * 64,
        "float32": 2.0 * 16 * 48 * 16 + 16 * 48}
    assert oc.summary()["product_flops_by_dtype"] == {
        "bfloat16": 2.0 * 64 * 32 * 64, "float32": 2.0 * 16 * 48 * 16}


@pytest.mark.parametrize("device", DEVICES)
def test_in_place_copy_and_indexed_writes(device):
    """An in-place op reads and writes its destination, a copy writes it,
    an indexed write writes only its source's worth, a conversion computes
    one FLOP per element and a copy none."""
    x = _rand((64, 32), device=device)
    y = _rand((64, 32), device=device, seed=1)
    rows = torch.tensor([1, 5, 9], device=device)
    vals = _rand((3, 32), device=device, seed=2)
    nb = 64 * 32 * 4

    def cost(fn):
        with OpCost() as oc:
            fn()
        s = oc.summary()
        return s["hbm_bytes_per_device"], s["flops_per_device"]

    assert cost(lambda: x.add_(y)) == (3 * nb, 64 * 32)
    assert cost(lambda: x.copy_(y)) == (2 * nb, 0)
    assert cost(lambda: x.index_put_((rows,), vals)) == (
        3 * 8 + 2 * 3 * 32 * 4, 0)
    assert cost(lambda: x.to(torch.bfloat16)) == (nb + nb // 2, 64 * 32)
    assert cost(lambda: x.clone()) == (2 * nb, 0)


@pytest.mark.parametrize("device", DEVICES)
def test_peak_of_live_bytes(device):
    """Inputs are live from the start; a temporary counts until Python
    frees it; views of a storage add nothing."""
    x = _rand((256, 256), device=device)
    nb = 256 * 256 * 4
    with OpCost(inputs={"x": x}) as oc:
        y = x * 2.0
        del y
        z = x * 3.0
        z.view(-1)
        w = z + 1.0
    s = oc.summary()
    assert s["peak_live_bytes"] == 3 * nb   # x, z and w; y was freed
    assert oc.live_bytes == 3 * nb
    del z, w
    assert oc.live_bytes == nb


@pytest.mark.parametrize("device", DEVICES)
def test_backward_is_counted(device):
    """``autograd.grad`` of a product's sum: the forward product and the
    backward's two, each 2·M·K·N."""
    M, K, N = 32, 64, 16
    a = _rand((M, K), device=device).requires_grad_(True)
    b = _rand((K, N), device=device, seed=1).requires_grad_(True)
    with OpCost() as oc:
        torch.autograd.grad((a @ b).sum(), [a, b])
    products = sum(n for name, n in oc.op_counts.items() if name == "mm")
    assert products == 3
    assert oc.summary()["flops_per_device"] >= 3 * 2 * M * K * N


# --------------------------------------------------------- kernel charges

def _check_charge(summary, name, w: work.KernelWork, calls: int = 1,
                  extra: dict | None = None):
    """The call's whole count is the kernel's charge, and ``extra``'s
    (``{name: KernelWork}``: what the wrapper moves around the launch):
    nothing of the plain version's (or the meta route's) own ops."""
    charges = {name: w, **(extra or {})}
    assert summary["kernel_charges"] == {n: {
        "calls": calls, "bytes": calls * c.bytes,
        "flops": {c.dtype: calls * c.flops} if c.flops else {}}
        for n, c in charges.items()}
    assert summary["hbm_bytes_per_device"] == calls * sum(
        c.bytes for c in charges.values())
    flops, products = {}, {}
    for c in charges.values():
        if c.flops:
            flops[c.dtype] = flops.get(c.dtype, 0) + calls * c.flops
            if c.products:
                products[c.dtype] = products.get(c.dtype, 0) + calls * c.flops
    assert summary["flops_by_dtype"] == flops
    assert summary["product_flops_by_dtype"] == products
    assert summary["n_ops"] == 0


FLASH_CASES = {
    "causal": dict(B=2, Sq=24, Skv=24, H=4, Kh=2, D=32, causal=True,
                   q_offset=0),
    "offset": dict(B=1, Sq=8, Skv=24, H=4, Kh=2, D=32, causal=True,
                   q_offset=16),
    "cross": dict(B=2, Sq=12, Skv=20, H=4, Kh=4, D=16, causal=False,
                  q_offset=0),
    # Zamba2's head dim (the case's name is from when its launch was
    # padded to 128): now charged at D alone
    "pad112": dict(B=1, Sq=16, Skv=16, H=2, Kh=2, D=112, causal=True,
                   q_offset=0),
    "d192": dict(B=1, Sq=12, Skv=20, H=4, Kh=2, D=192, causal=False,
                 q_offset=0),
}


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("device", DEVICES)
def test_flash_attention_charges_its_work(device, case, dtype):
    c = FLASH_CASES[case]
    q = _rand((c["B"], c["Sq"], c["H"], c["D"]), dtype, device)
    k = _rand((c["B"], c["Skv"], c["Kh"], c["D"]), dtype, device, 1)
    v = _rand((c["B"], c["Skv"], c["Kh"], c["D"]), dtype, device, 2)
    w = work.flash_attention(dtype=dtype, **c)
    before = dict(ops.launches)
    with OpCost() as oc:
        out = ops.flash_attention(q, k, v, causal=c["causal"],
                                  q_offset=c["q_offset"])
    assert ops.launches == before
    assert out.shape == q.shape and out.dtype == dtype
    assert out.device.type == device
    _check_charge(oc.summary(), "flash_attention", w)
    assert oc.summary()["peak_live_bytes"] == out.numel() * out.element_size()
    # the (B, H, S, D) entry charges the same work
    if c["q_offset"] == 0:
        with OpCost() as oc2:
            o2 = ops.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2),
                                          causal=c["causal"])
        assert o2.shape == q.transpose(1, 2).shape and o2.dtype == dtype
        _check_charge(oc2.summary(), "flash_attention", w)


def test_flash_attention_meta_route_checks_shapes():
    q = torch.empty(1, 8, 4, 32, device="meta")
    with pytest.raises(ValueError, match="bad shapes"):
        ops.flash_attention(q, torch.empty(1, 8, 3, 32, device="meta"),
                            torch.empty(1, 8, 3, 32, device="meta"))
    # 160 lies between the instances at 128 and 192: no route takes it
    big = torch.empty(1, 8, 4, 160, device="meta")
    with pytest.raises(ValueError, match="no route takes head dim 160"):
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="on the CPU or all on one CUDA"):
        ops.flash_attention(q, torch.zeros(1, 8, 4, 32), q)


def _paged_inputs(device, q_dtype, kv_dtype, B=3, H=8, Kh=2, D=32, T=8,
                  n_pages=20, P=4):
    rng = np.random.default_rng(0)
    q = _rand((B, H, D), q_dtype, device)
    kp = _rand((n_pages, T, Kh, D), kv_dtype, device, 1)
    vp = _rand((n_pages, T, Kh, D), kv_dtype, device, 2)
    bt = torch.from_numpy(rng.integers(0, n_pages, (B, P)).astype(np.int32))
    lens = torch.tensor([5, 17, 26][:B], dtype=torch.int32)
    return q, kp, vp, bt.to(device), lens.to(device)


@pytest.mark.parametrize("dtypes", ((torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)))
@pytest.mark.parametrize("device", DEVICES)
def test_paged_attention_charges_its_work(device, dtypes):
    """The lengths' tokens and pages on the CPU; full tables on meta,
    which has no lengths."""
    q_dtype, kv_dtype = dtypes
    q, kp, vp, bt, lens = _paged_inputs(device, q_dtype, kv_dtype)
    B, H, D = q.shape
    T, Kh = kp.shape[1], kp.shape[2]
    if device == "cpu":
        tokens, pages = 5 + 17 + 26, 1 + 3 + 4
    else:
        pages = B * bt.shape[1]
        tokens = pages * T
    w = work.paged_attention(B=B, H=H, Kh=Kh, D=D, tokens=tokens,
                             pages=pages, q_dtype=q_dtype, kv_dtype=kv_dtype)
    with OpCost() as oc:
        out = ops.paged_attention(q, kp, vp, bt, lens)
    assert out.shape == q.shape and out.dtype == q_dtype
    _check_charge(oc.summary(), "paged_attention", w)


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.int32))
@pytest.mark.parametrize("device", DEVICES)
def test_segment_compact_charges_its_work(device, dtype):
    pool = torch.arange(40 * 12).reshape(40, 12).to(dtype).to(device)
    src = torch.tensor([3, 0, 39, 7, 7], dtype=torch.int32, device=device)
    with OpCost() as oc:
        out = ops.segment_compact(pool, src)
    assert out.shape == (5, 12) and out.dtype == dtype
    _check_charge(oc.summary(), "segment_compact",
                  work.segment_compact(M=5, E=12, dtype=dtype))


@pytest.mark.parametrize("device", DEVICES)
def test_segment_move_charges_its_work(device):
    pools = tuple(_rand((3, 10, 4, 8), torch.bfloat16, device, s)
                  for s in (0, 1))
    with OpCost() as oc:
        ops.segment_move(pools, [0, 1, 2], [5, 6, 0])   # staged
        ops.segment_move(pools, [3], [9])               # direct
    s = oc.summary()
    w3 = work.segment_move(L=3, moves=3, E=32, dtype=torch.bfloat16)
    w1 = work.segment_move(L=3, moves=1, E=32, dtype=torch.bfloat16)
    st = work.segment_move_stage(L=3, moves=3, E=32, dtype=torch.bfloat16)
    assert s["kernel_charges"] == {
        "segment_move": {"calls": 2, "bytes": w3.bytes + w1.bytes,
                         "flops": {}},
        "segment_move_stage": {"calls": 1, "bytes": st.bytes, "flops": {}}}
    assert st.bytes == 2 * st.scratch == 2 * 2 * 3 * 3 * 32 * 2
    assert s["hbm_bytes_per_device"] == w3.bytes + w1.bytes + st.bytes
    assert s["peak_live_bytes"] == st.scratch
    assert s["n_ops"] == 0


@pytest.mark.parametrize("device", DEVICES)
def test_mdc_priority_charges_its_work(device):
    live = torch.tensor([0, 2, 4, 1, 3], device=device)   # int64: cast
    up2 = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0], device=device)
    with OpCost() as oc:
        out = ops.mdc_priority(live, up2, 9.0, S=4)
    assert out.shape == (5,) and out.dtype == torch.float32
    cast = work.cast(n=5, src_dtype=torch.int64, dtype=torch.float32)
    assert (cast.bytes, cast.flops, cast.scratch) == (5 * 12, 5.0, 5 * 4)
    _check_charge(oc.summary(), "mdc_priority", work.mdc_priority(N=5),
                  extra={"mdc_priority_cast": cast})
    assert oc.summary()["peak_live_bytes"] == 5 * 4 + cast.scratch
    # f32 counts need no cast
    livef = live.float()
    with OpCost() as oc:
        ops.mdc_priority(livef, up2, 9.0, S=4)
    _check_charge(oc.summary(), "mdc_priority", work.mdc_priority(N=5))
    # the victim route: the kernel's charge, and top-k counted as an op
    with OpCost() as oc:
        ops.mdc_select_victims(live, up2, 9.0, S=4, k=2)
    s = oc.summary()
    assert s["kernel_charges"]["mdc_priority"]["calls"] == 1
    assert oc.op_counts["topk"] == 1


@pytest.mark.parametrize("device", DEVICES)
def test_paged_attention_charges_its_table_casts(device):
    """int64 tables and lengths are copied to int32 before the launch."""
    q, kp, vp, bt, lens = _paged_inputs(device, torch.float32, torch.float32)
    bt64, lens64 = bt.to(torch.int64), lens.to(torch.int64)
    with OpCost() as oc:
        ops.paged_attention(q, kp, vp, bt64, lens64)
    casts = [work.cast(n=t.numel(), src_dtype=torch.int64, dtype=torch.int32)
             for t in (bt, lens)]
    charge = oc.summary()["kernel_charges"]["paged_attention_cast"]
    assert charge == {"calls": 2, "bytes": sum(c.bytes for c in casts),
                      "flops": {"int32": float(bt.numel() + lens.numel())}}


def test_wrappers_skip_the_hook_when_nothing_counts(monkeypatch):
    """With no counter registered a wrapper runs its body and nothing
    else: ``work.charged`` is never reached."""
    def fail(*a, **k):
        raise AssertionError("charged() called with no counter")

    monkeypatch.setattr(work, "charged", fail)
    assert work.counters == []
    q = _rand((1, 8, 4, 32))
    ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    ops.flash_attention_bhsd(*(t.transpose(1, 2) for t in (q, q, q)))
    ops.paged_attention(*_paged_inputs("cpu", torch.float32, torch.float32))
    ops.segment_compact(_rand((10, 4)), torch.tensor([1, 2], dtype=torch.int32))
    ops.segment_move((_rand((2, 6, 4)), _rand((2, 6, 4), seed=1)), [0], [3])
    ops.mdc_priority(torch.ones(4), torch.ones(4), 2.0, S=4)


def test_kernels_import_nothing_above_them():
    """The kernels are the lowest layer: the counter registers into their
    hook, and importing them loads nothing of ``roofline``."""
    src = pathlib.Path(work.__file__).resolve().parents[2]
    code = ("import sys, repro_torch.kernels.ops, repro_torch.kernels.work; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.roofline')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(src)}).stdout
    assert out.strip() == "[]"


# ------------------------------------------------- the bound column, PERF.md

# (work, PERF.md §6's bound in ms): its shapes, its figure to 3 digits
PAGED = dict(B=8, H=16, Kh=8, D=128)
FLASH = dict(B=1, H=16, Kh=8, D=128)
BOUNDS = {
    "paged_bf16_B8": (work.paged_attention(
        **PAGED, tokens=4357, pages=4357 // 16 + 8, q_dtype=torch.bfloat16,
        kv_dtype=torch.bfloat16), 0.00535),
    "paged_bf16_B32": (work.paged_attention(
        B=32, H=16, Kh=8, D=128, tokens=69815, pages=69815 // 16 + 32,
        q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16), 0.0854),
    "paged_f32q_bf16_pools": (work.paged_attention(
        **PAGED, tokens=4357, pages=4357 // 16 + 8, q_dtype=torch.float32,
        kv_dtype=torch.bfloat16), 0.00537),
    "paged_bf16q_f32_pools": (work.paged_attention(
        **PAGED, tokens=4357, pages=4357 // 16 + 8, q_dtype=torch.bfloat16,
        kv_dtype=torch.float32), 0.0107),
    "paged_G8": (work.paged_attention(
        B=8, H=32, Kh=4, D=128, tokens=3652, pages=3652 // 16 + 8,
        q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16), 0.00227),
    "paged_sharded_rank": (work.paged_attention(
        B=8, H=8, Kh=4, D=128, tokens=4357, pages=4357 // 16 + 8,
        q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16), 0.00267),
    "flash_S256": (work.flash_attention(
        **FLASH, Sq=256, Skv=256, dtype=torch.bfloat16, causal=True),
        0.000939),
    "flash_S512": (work.flash_attention(
        **FLASH, Sq=512, Skv=512, dtype=torch.bfloat16, causal=True), 0.00188),
    "flash_S1024": (work.flash_attention(
        **FLASH, Sq=1024, Skv=1024, dtype=torch.bfloat16, causal=True),
        0.00435),
    "flash_hit_bf16": (work.flash_attention(
        **FLASH, Sq=512, Skv=1024, dtype=torch.bfloat16, causal=True,
        q_offset=512), 0.00326),
    "flash_hit_f32": (work.flash_attention(
        **FLASH, Sq=512, Skv=1024, dtype=torch.float32, causal=True,
        q_offset=512), 0.0481),
    "flash_chunk": (work.flash_attention(
        **FLASH, Sq=256, Skv=1024, dtype=torch.bfloat16, causal=True,
        q_offset=768), 0.00190),
    "flash_f32_S1024": (work.flash_attention(
        **FLASH, Sq=1024, Skv=1024, dtype=torch.float32, causal=True),
        0.0642),
    "flash_H32": (work.flash_attention(
        B=1, H=32, Kh=4, D=128, Sq=1024, Skv=1024, dtype=torch.bfloat16,
        causal=True), 0.00869),
    "flash_zamba2": (work.flash_attention(
        B=1, H=32, Kh=32, D=112, Sq=1024, Skv=1024, dtype=torch.bfloat16,
        causal=True), 0.00876),
    "flash_nemotron_bf16": (work.flash_attention(
        B=1, H=96, Kh=8, D=192, Sq=1024, Skv=1024, dtype=torch.bfloat16,
        causal=True), 0.0391),
    "flash_nemotron_f32": (work.flash_attention(
        B=1, H=96, Kh=8, D=192, Sq=1024, Skv=1024, dtype=torch.float32,
        causal=True), 0.577),
    "flash_whisper_encoder": (work.flash_attention(
        B=2, H=16, Kh=16, D=64, Sq=1500, Skv=1500, dtype=torch.bfloat16,
        causal=False), 0.0186),
    "flash_whisper_cross": (work.flash_attention(
        B=2, H=16, Kh=16, D=64, Sq=384, Skv=1500, dtype=torch.bfloat16,
        causal=False), 0.00477),
    "flash_internvl2": (work.flash_attention(
        B=1, H=64, Kh=8, D=128, Sq=1024, Skv=1024, dtype=torch.bfloat16,
        causal=True), 0.0174),
    "flash_sharded_rank": (work.flash_attention(
        B=1, H=8, Kh=4, D=128, Sq=1024, Skv=1024, dtype=torch.bfloat16,
        causal=True), 0.00217),
    "flash_sharded_rank_hit": (work.flash_attention(
        B=1, H=8, Kh=4, D=128, Sq=512, Skv=1024, dtype=torch.bfloat16,
        causal=True, q_offset=512), 0.00163),
    "segment_compact_bf16": (work.segment_compact(
        M=28 * 64, E=16384, dtype=torch.bfloat16), 0.0351),
    "segment_compact_int32": (work.segment_compact(
        M=28 * 64, E=16383, dtype=torch.int32), 0.0701),
    "segment_move": (work.segment_move(
        L=28, moves=64, E=16384, dtype=torch.bfloat16), 0.0701),
    "mdc_priority_paper": (work.mdc_priority(N=51_200), 0.000183),
    "mdc_priority_2_24": (work.mdc_priority(N=1 << 24), 0.0601),
}


@pytest.mark.parametrize("case", BOUNDS)
def test_work_gives_the_bound_column(case):
    w, want_ms = BOUNDS[case]
    ms, _ = report.kernel_bound_ms(w)
    assert ms == pytest.approx(want_ms, rel=0.01)


def test_bound_takes_the_larger_term():
    assert report.kernel_bound_ms(BOUNDS["flash_S1024"][0])[1] == "operations"
    assert report.kernel_bound_ms(BOUNDS["flash_S256"][0])[1] == "bytes"
    assert report.kernel_bound_ms(BOUNDS["segment_move"][0])[1] == "bytes"
    assert report.peak_flops("int32") == report.PEAK_FLOPS["float32"]


# ------------------------------------------------ gather_heads' collective

@pytest.fixture(scope="module")
def gloo_costs():
    case = tp.wrapper_case()
    return case, tp_mesh.spawn_ranks(tp.wrapper_costs, 2, case,
                                     backend="gloo", device="cpu",
                                     timeout_s=120)


def test_gather_heads_charges_the_gathered_payload(gloo_costs):
    """Each rank's three all-gathers (paged, flash, flash at an offset)
    count their gathered bytes, once each, and the wrappers on the local
    heads charge their kernels' work."""
    case, ranks = gloo_costs
    for r in ranks:
        s = r["summary"]
        assert s["collective_counts"] == {"all-gather": 3}
        assert s["collective_bytes_per_device"] == {
            "all-gather": float(r["gathered_bytes"])}
        assert s["total_collective_bytes"] == r["gathered_bytes"]
        charges = s["kernel_charges"]
        assert charges["gather_heads"]["calls"] == 3
        assert charges["paged_attention"]["calls"] == 1
        assert charges["flash_attention"]["calls"] == 2
        B, Sq, H, D = case["qf"].shape
        w = work.flash_attention(B=B, H=H // 2, Kh=case["kf"].shape[2] // 2,
                                 Sq=Sq, Skv=Sq, D=D, dtype=torch.float32,
                                 causal=True)
        assert charges["flash_attention"]["bytes"] == 2 * w.bytes
