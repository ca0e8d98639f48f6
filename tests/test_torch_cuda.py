"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpret mode, so every test here needs a card: they
carry the ``cuda`` marker and skip without one (the decision is taken inside
the fixture, never at import).  The file imports no JAX, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import hashlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import Model
from repro_torch.serving import PagedServingEngine
from _torch_checks import (PAGED_SHA256, check_paged_close, digest, paged_bar,
                           paged_case)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev).to(dtype)


def _flash_case(dev, B, Sq, Skv, H, Kh, D, causal, dtype, route, *,
                layout="bshd"):
    """One launch against the plain version; it must take ``route``.
    ``layout="bhsd"`` stores the inputs as (B, H, S, D) and hands the kernel
    (B, S, H, D) views of them (strided, not copied)."""
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, H, D), dtype, dev)
    k = _randn(rng, (B, Skv, Kh, D), dtype, dev)
    v = _randn(rng, (B, Skv, Kh, D), dtype, dev)
    if layout == "bhsd":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
        assert not q.is_contiguous()
    n0, r0 = ops.launches["flash_attention"], dict(ops.flash_routes)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == n0 + 1
    assert ops.flash_routes[route] == r0[route] + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,Kh,D,causal", [
    (1, 128, 128, 4, 4, 64, True),
    (2, 256, 256, 8, 2, 64, True),
    (1, 200, 200, 4, 1, 32, True),     # ragged: padded and masked tiles
    (1, 64, 192, 2, 2, 128, False),    # cross-shape kv
    (2, 96, 96, 6, 3, 16, False),
    (1, 1024, 1024, 16, 8, 128, True),  # qwen3-1.7b heads at a 1k prompt
])
def test_flash_attention_kernel(dev, B, Sq, Skv, H, Kh, D, causal, dtype):
    """The JAX kernel tests' shapes: bf16 at D 64 / 128 on the tensor-core
    route, f32 and the other head dims on the CUDA-core route."""
    _flash_case(dev, B, Sq, Skv, H, Kh, D, causal, dtype,
                ops.flash_route(dtype, D))


@pytest.mark.parametrize("B,Sq,Skv,H,Kh,D,causal,layout", [
    (1, 256, 256, 16, 8, 128, True, "bshd"),   # the engine's prefill buckets
    (1, 512, 512, 16, 8, 128, True, "bshd"),
    (1, 1024, 1024, 16, 8, 128, True, "bshd"),
    (1, 1, 1, 16, 8, 128, True, "bshd"),       # ragged S
    (1, 65, 65, 16, 8, 128, True, "bshd"),
    (1, 127, 127, 16, 8, 128, True, "bshd"),
    (1, 1000, 1000, 16, 8, 128, True, "bshd"),
    (2, 200, 700, 4, 2, 128, False, "bshd"),   # Skv > Sq
    (1, 65, 300, 8, 8, 64, False, "bshd"),
    (2, 300, 300, 8, 4, 128, True, "bhsd"),    # strided (B, S, H, D) views
    (1, 1000, 1000, 16, 8, 64, True, "bhsd"),
])
def test_flash_attention_wgmma_route(dev, B, Sq, Skv, H, Kh, D, causal, layout):
    _flash_case(dev, B, Sq, Skv, H, Kh, D, causal, torch.bfloat16, "wgmma",
                layout=layout)


def test_flash_attention_bhsd_entry_on_both_routes(dev):
    rng = np.random.default_rng(2)
    for dtype, route in ((torch.bfloat16, "wgmma"), (torch.float32, "simt")):
        q = _randn(rng, (2, 8, 200, 128), dtype, dev)
        k = _randn(rng, (2, 4, 200, 128), dtype, dev)
        v = _randn(rng, (2, 4, 200, 128), dtype, dev)
        r0 = ops.flash_routes[route]
        got = ops.flash_attention_bhsd(q, k, v, causal=True)
        assert ops.flash_routes[route] == r0 + 1
        want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=True)
        torch.testing.assert_close(got.transpose(1, 2).float(), want.float(),
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Skv,H,Kh,D,q_offset", [
    (1, 512, 1024, 16, 8, 128, 512),  # the prefix-hit shape of qwen3-1.7b
    (1, 64, 128, 16, 8, 128, 80),     # pad rows: Sq + q_offset > Skv
    (1, 17, 300, 8, 4, 128, 200),     # Sq 17, offset not a tile multiple
    (2, 1, 257, 16, 8, 128, 256),     # Sq 1: the last position
    (1, 200, 700, 4, 2, 64, 333),     # ragged Sq and Skv, odd offset
    (1, 96, 96, 4, 4, 64, 50),        # Sq + q_offset > Skv, both ragged
    # kv tile 0 crosses the diagonal of warpgroup 0's rows (100..163) and
    # lies wholly below warpgroup 1's (164..227)
    (1, 130, 640, 16, 8, 128, 100),
])
def test_flash_attention_q_offset(dev, B, Sq, Skv, H, Kh, D, q_offset, dtype):
    """Query rows at absolute positions ``q_offset + i``: against the plain
    version, and bit for bit the rows ``q_offset:`` of the ``q_offset = 0``
    call over all ``q_offset + Sq`` rows, on both routes."""
    rng = np.random.default_rng(3)
    q_all = _randn(rng, (B, q_offset + Sq, H, D), dtype, dev)
    k = _randn(rng, (B, Skv, Kh, D), dtype, dev)
    v = _randn(rng, (B, Skv, Kh, D), dtype, dev)
    q = q_all[:, q_offset:]
    route = ops.flash_route(dtype, D)
    r0, o0 = ops.flash_routes[route], ops.flash_offsets["nonzero"]
    got = ops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    torch.cuda.synchronize()
    assert ops.flash_routes[route] == r0 + 1
    assert ops.flash_offsets["nonzero"] == o0 + 1
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    whole = ops.flash_attention(q_all, k, v, causal=True)
    assert torch.equal(got, whole[:, q_offset:])


@pytest.mark.parametrize("q_offset", [256, 512, 768])
def test_flash_attention_at_the_chunk_shapes(dev, q_offset):
    """One chunk of a chunked prefill of a 1,024-token prompt at qwen3-1.7b's
    heads: 256 query rows at ``q_offset`` over the whole 1,024-key extent
    (the keys past the chunk stand for the stale rows the mask hides), bf16
    on the tensor-core route: against the plain version, and bit for bit the
    same rows of the ``q_offset = 0`` call over all 1,024 rows."""
    rng = np.random.default_rng(5)
    q_all = _randn(rng, (1, 1024, 16, 128), torch.bfloat16, dev)
    k = _randn(rng, (1, 1024, 8, 128), torch.bfloat16, dev)
    v = _randn(rng, (1, 1024, 8, 128), torch.bfloat16, dev)
    q = q_all[:, q_offset:q_offset + 256]
    r0 = ops.flash_routes["wgmma"]
    got = ops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    torch.cuda.synchronize()
    assert ops.flash_routes["wgmma"] == r0 + 1
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    whole = ops.flash_attention(q_all, k, v, causal=True)
    assert torch.equal(got, whole[:, q_offset:q_offset + 256])


# sha256 (first 16 hex digits) of the outputs of the flash kernel as it was
# before it took a query offset, on an NVIDIA H100 80GB HBM3 (inputs from
# numpy seed 11): the q_offset = 0 call must reproduce them bit for bit
PRE_OFFSET_SHA256 = {
    (torch.bfloat16, 1, 256, 16, 8, 128, True): "7cdabb7496334322",
    (torch.bfloat16, 1, 1024, 16, 8, 128, True): "eeef910088820fe4",
    (torch.bfloat16, 1, 1000, 16, 8, 64, True): "5380b0a339f23d5e",
    (torch.bfloat16, 2, 200, 4, 2, 128, False): "f79e082b06cbe452",
    (torch.float32, 1, 1024, 16, 8, 128, True): "0d311f4d796fd963",
    (torch.float32, 1, 200, 4, 1, 32, True): "ff89134060c19b4f",
    (torch.bfloat16, 1, 96, 6, 3, 16, True): "6c8cd99a088a10ac",
}


@pytest.mark.parametrize("case", list(PRE_OFFSET_SHA256),
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_q_offset_zero_is_the_kernel_before_it(dev, case):
    dtype, B, S, H, Kh, D, causal = case
    rng = np.random.default_rng(11)
    q = _randn(rng, (B, S, H, D), dtype, dev)
    k = _randn(rng, (B, S, Kh, D), dtype, dev)
    v = _randn(rng, (B, S, Kh, D), dtype, dev)
    out = ops.flash_attention(q, k, v, causal=causal, q_offset=0)
    digest = hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy()
                            .tobytes()).hexdigest()[:16]
    assert digest == PRE_OFFSET_SHA256[case]


def test_flash_attention_refuses_a_negative_q_offset(dev):
    q = torch.zeros(1, 8, 2, 64, device=dev)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, q, q, q_offset=-1)


def _paged_inputs(rng, dev, dtype, B, H, Kh, D, T, P, n_pages=None):
    """q, pools and disjoint random tables (as the slab allocator hands out),
    from numpy with a seed."""
    n_pages = n_pages or B * P + 5
    q = _randn(rng, (B, H, D), dtype, dev)
    k_pool = _randn(rng, (n_pages, T, Kh, D), dtype, dev)
    v_pool = _randn(rng, (n_pages, T, Kh, D), dtype, dev)
    bt = torch.from_numpy(rng.permutation(n_pages)[:B * P].reshape(B, P)
                          .astype(np.int32)).to(dev)
    return q, k_pool, v_pool, bt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Kh,D,T,P,lens", [
    (2, 4, 4, 64, 16, 4, None),
    (3, 8, 2, 32, 8, 6, None),      # GQA 4:1
    (1, 4, 1, 128, 32, 3, None),    # MQA
    (8, 16, 8, 128, 16, 64, None),  # qwen3-1.7b heads, 1k-token tables
    # the split edges: zero-length and one-token rows, exactly 8 pages,
    # 8*2 + 1 pages, a full table of P = 20 (not a multiple of 8)
    (6, 16, 8, 128, 16, 20, [0, 1, 128, 257, 320, 7]),
    (3, 4, 4, 128, 16, 1, [0, 16, 9]),          # P = 1
    (3, 16, 2, 128, 16, 12, [1, 100, 192]),     # G = 8
    (3, 8, 1, 32, 8, 9, [0, 72, 65]),           # G = 8, D = 32, P = 9
    # 1,099 pages: a warp of the kernel walks more than 32 of them
    (2, 4, 2, 64, 2, 1100, [2197, 2200]),
])
def test_paged_attention_kernel(dev, B, H, Kh, D, T, P, lens, dtype):
    """Against the plain version; a zero-length row is zeros, as in the
    Pallas kernel (the plain dense softmax gives the mean of V there).  Every
    row is also held against the plain model of the kernel's split schedule.
    One launch per call."""
    rng = np.random.default_rng(3)
    q, k_pool, v_pool, bt = _paged_inputs(rng, dev, dtype, B, H, Kh, D, T, P)
    lens = np.linspace(1, P * T, B) if lens is None else lens
    lens = torch.tensor(np.asarray(lens, np.int32), device=dev)
    n0 = ops.launches["paged_attention"]
    got = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    torch.cuda.synchronize()
    assert ops.launches["paged_attention"] == n0 + 1
    live = lens > 0
    want = ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])
    assert not got[~live].float().any()
    split = ref.paged_attention_split_ref(q, k_pool, v_pool, bt, lens)
    torch.testing.assert_close(got.float(), split.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_clamps_tables(dev, dtype):
    """Entries outside [0, num_pages) are clamped by the kernel itself, as
    ``repro.kernels.ops.paged_attention`` clips them before its kernel."""
    rng = np.random.default_rng(4)
    B, H, Kh, D, T, P, n_pages = 3, 16, 8, 128, 16, 10, 12
    q, k_pool, v_pool, _ = _paged_inputs(rng, dev, dtype, B, H, Kh, D, T, 1,
                                         n_pages)
    bt = torch.from_numpy(rng.integers(-5, 2 * n_pages, (B, P)).astype(np.int32))
    bt[0, :3] = torch.tensor([-1, n_pages, 1 << 30])
    bt = bt.to(dev)
    lens = torch.tensor([P * T, 97, 33], dtype=torch.int32, device=dev)
    got = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    want = ref.paged_attention_ref(q, k_pool, v_pool,
                                   bt.clamp(0, n_pages - 1), lens)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_paged_attention_kernel_is_one_device_kernel(dev):
    """A call on int32 tables and lengths is the kernel and nothing else on
    the device: no clamp, no conversion, no second combine kernel."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    q, k_pool, v_pool, bt = _paged_inputs(rng, dev, torch.bfloat16, 8, 16, 8,
                                          128, 16, 64)
    bt[0, 0] = -7  # an entry that only the kernel clamps
    lens = torch.full((8,), 600, dtype=torch.int32, device=dev)
    ops.paged_attention(q, k_pool, v_pool, bt, lens)  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.paged_attention(q, k_pool, v_pool, bt, lens)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "paged_attention_kernel" in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_is_batch_invariant(dev, dtype):
    """A sequence's output is bitwise the same alone (B = 1, a table just
    wide enough) and in a batch of 8 (a wider table, other rows of every
    length, padding entries past its pages), and from call to call."""
    rng = np.random.default_rng(6)
    H, Kh, D, T, P = 16, 8, 128, 16, 40
    q, k_pool, v_pool, bt = _paged_inputs(rng, dev, dtype, 8, H, Kh, D, T, P)
    lens = torch.from_numpy(rng.integers(0, P * T + 1, 8).astype(np.int32)).to(dev)
    row, n = 5, 331  # 21 pages: splits of 3 and 2 pages
    lens[row] = n
    batch = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    need = -(-n // T)
    alone = ops.paged_attention(q[row:row + 1].clone(), k_pool, v_pool,
                                bt[row:row + 1, :need].clone(),
                                lens[row:row + 1].clone())
    again = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    torch.cuda.synchronize()
    assert torch.equal(alone[0], batch[row])
    assert torch.equal(again, batch)


def test_paged_attention_kernel_replays_in_a_cuda_graph(dev):
    """Captured once in a CUDA graph, then replayed after the lengths and
    the table were rewritten in place: each replay matches the plain
    version on the new contents."""
    rng = np.random.default_rng(7)
    B, H, Kh, D, T, P = 8, 16, 8, 128, 16, 32
    n_pages = 2 * B * P
    q, k_pool, v_pool, bt = _paged_inputs(rng, dev, torch.bfloat16, B, H, Kh,
                                          D, T, P, n_pages)
    lens = torch.from_numpy(rng.integers(1, P * T + 1, B).astype(np.int32)).to(dev)
    ops.paged_attention(q, k_pool, v_pool, bt, lens)  # built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = ops.launches["paged_attention"]
    with torch.cuda.graph(graph):
        out = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    assert ops.launches["paged_attention"] == n0 + 1
    for _ in range(3):
        bt.copy_(torch.from_numpy(rng.permutation(n_pages)[:B * P]
                                  .reshape(B, P).astype(np.int32)))
        lens.copy_(torch.from_numpy(rng.integers(0, P * T + 1, B)
                                    .astype(np.int32)))
        graph.replay()
        torch.cuda.synchronize()
        live = lens > 0
        want = ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)
        torch.testing.assert_close(out[live].float(), want[live].float(),
                                   **TOL[torch.bfloat16])
        assert not out[~live].float().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("N,E,M", [(32, 256, 16), (7, 100, 7), (64, 8192, 64),
                                   (16, 130, 5), (16, 129, 9)])
def test_segment_compact_kernel_exact(dev, N, E, M, dtype):
    rng = np.random.default_rng(5)
    if dtype == torch.int32:
        pool = torch.from_numpy(rng.integers(0, 1000, (N, E), dtype=np.int32)).to(dev)
    else:
        pool = _randn(rng, (N, E), dtype, dev)
    src = torch.from_numpy(rng.integers(0, N, M).astype(np.int32)).to(dev)
    got = ops.segment_compact(pool, src)
    assert torch.equal(got, ref.segment_compact_ref(pool, src))


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("dtype,E", [(torch.bfloat16, 16384), (torch.int32, 16383)])
def test_segment_move_kernel_exact(dev, dtype, E, overlap):
    """The engine's move at its shape (28 layers, 481 pages, 64 moves; E
    16,384 bf16 = one 16-token page of 8 heads x 128) and at an E whose row
    is not a multiple of 16 bytes: one launch for a disjoint plan, a gather
    and a scatter launch when a destination is another move's source."""
    rng = np.random.default_rng(7)
    L, n_pages, M = 28, 481, 64
    if dtype == torch.int32:
        k_pool, v_pool = (torch.from_numpy(rng.integers(0, 1 << 30, (L, n_pages, E),
                                                        dtype=np.int32)).to(dev)
                          for _ in range(2))
    else:
        k_pool, v_pool = (_randn(rng, (L, n_pages, E), dtype, dev) for _ in range(2))
    perm = rng.permutation(n_pages)
    src, dst = perm[:M], perm[M:2 * M].copy()
    if overlap:
        dst[:M // 2] = np.roll(src, 1)[:M // 2]
    want = (k_pool.clone(), v_pool.clone())
    ref.segment_move_ref(want, src, dst)
    n0, plans0 = ops.launches["segment_move"], dict(ops.move_plans)
    ops.segment_move((k_pool, v_pool), src, dst)
    torch.cuda.synchronize()
    form = "staged" if overlap else "direct"
    assert ops.move_plans[form] == plans0[form] + 1
    assert ops.launches["segment_move"] == n0 + (2 if overlap else 1)
    assert torch.equal(k_pool, want[0]) and torch.equal(v_pool, want[1])


@pytest.mark.parametrize("overlap", [False, True])
def test_segment_move_kernel_splits_long_plans(dev, overlap):
    """A plan longer than the page ids one launch carries goes in chunks of
    ``ops.MOVE_CHUNK`` moves, all gathers before any scatter when staged."""
    rng = np.random.default_rng(8)
    L, n_pages, E = 2, 3 * ops.MOVE_CHUNK, 33  # 132-byte rows: re-aligned
    k_pool, v_pool = (torch.from_numpy(rng.integers(0, 1 << 30, (L, n_pages, E),
                                                    dtype=np.int32)).to(dev)
                      for _ in range(2))
    M = ops.MOVE_CHUNK + 100
    perm = rng.permutation(n_pages)
    src, dst = perm[:M], perm[M:2 * M].copy()
    if overlap:
        dst[:M // 2] = np.roll(src, 1)[:M // 2]
    want = (k_pool.clone(), v_pool.clone())
    ref.segment_move_ref(want, src, dst)
    n0 = ops.launches["segment_move"]
    ops.segment_move((k_pool, v_pool), src, dst)
    torch.cuda.synchronize()
    assert ops.launches["segment_move"] == n0 + (4 if overlap else 2)
    assert torch.equal(k_pool, want[0]) and torch.equal(v_pool, want[1])


def test_kernel_wrappers_refuse_mixed_devices(dev):
    q = torch.zeros(2, 4, 32, device=dev)
    pool = torch.zeros(3, 8, 2, 32)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.paged_attention(q, pool, pool, torch.zeros(2, 1, dtype=torch.int32),
                            torch.ones(2, dtype=torch.int32))


@pytest.mark.parametrize("N", [1, 3, 4097, 51_200])
@pytest.mark.parametrize("offset", [0, 1])  # 1: unaligned, element by element
def test_mdc_priority_kernel(dev, N, offset):
    """All three key branches (empty -1, full +inf, finite), tails of every
    length mod 4: identical -1 / +inf pattern, finite keys within 1e-6."""
    rng = np.random.default_rng(N)
    S = 512
    live_np = rng.integers(0, S + 1, N + offset).astype(np.float32)
    live_np[offset::7] = 0
    live_np[offset + 3::11] = S
    live = torch.from_numpy(live_np).to(dev)[offset:]
    up2 = torch.from_numpy(rng.uniform(0, 1e6, N + offset).astype(np.float32)
                           ).to(dev)[offset:]
    n0 = ops.launches["mdc_priority"]
    got = ops.mdc_priority(live, up2, 1.5e6, S=S)
    torch.cuda.synchronize()
    assert ops.launches["mdc_priority"] == n0 + 1
    assert tuple(got.shape) == (N,) and got.dtype == torch.float32
    want = ref.mdc_priority_ref(live, up2, 1.5e6, S)
    assert torch.equal(got == -1, want == -1)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=0)


def test_mdc_priority_kernel_casts_integer_counts(dev):
    rng = np.random.default_rng(2)
    live = torch.from_numpy(rng.integers(0, 65, 1000)).to(dev)  # int64
    up2 = torch.from_numpy(rng.uniform(0, 900, 1000)).to(dev)  # float64
    got = ops.mdc_priority(live, up2, 1000.0, S=64)
    want = ref.mdc_priority_ref(live, up2, 1000.0, 64)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=0)


def test_mdc_select_victims_kernel(dev):
    """Victims of the kernel route == victims of the plain route (key and
    top-k on the card), at the paper's 51,200 segments and clean_batch 64."""
    rng = np.random.default_rng(1)
    N, S, k = 51_200, 512, 64
    live = torch.from_numpy(rng.integers(1, S, N).astype(np.float32)).to(dev)
    up2 = torch.from_numpy(rng.uniform(0, 1e6, N).astype(np.float32)).to(dev)
    ids, valid = ops.mdc_select_victims(live, up2, 2e6, S=S, k=k)
    neg, want = torch.topk(-ref.mdc_priority_ref(live, up2, 2e6, S), k)
    assert ids.device == live.device and bool(valid.all())
    assert set(ids.tolist()) == set(want.tolist())


def test_mdc_priority_refuses_mixed_devices(dev):
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.mdc_priority(torch.zeros(4, device=dev), torch.zeros(4), 1.0, S=4)


def test_engine_on_card_matches_cpu_engine(dev):
    """The engine's kernel path on the card and its plain path on the CPU,
    at f32 on the smoke model, under forced compaction: same tokens, same
    pool traffic, and every compaction leaves each live slot reading the
    same K/V through its remapped block table."""
    cfg = get_config("qwen3-1.7b").smoke()
    params = _f32(Model(cfg, device="cpu", seed=0).params, "cpu")
    cpu_model, card_model = Model(cfg, params), Model(cfg, _f32(params, dev))
    results = []
    ops.reset_launches()
    for model, device in ((cpu_model, "cpu"), (card_model, dev)):
        eng = PagedServingEngine(model, n_slabs=7, blocks_per_slab=2, page_T=8,
                                 max_batch=3, max_seq=96, streams=1,
                                 compact_trigger=2, compact_batch=3,
                                 max_decode_chunk=8, pool_dtype=torch.float32,
                                 device=device)
        rng = np.random.default_rng(1)
        rids = [eng.submit(rng.integers(1, 100, size=n), m)
                for n, m in [(27, 10), (5, 8), (11, 6), (3, 12)]]
        for step in range(10_000):
            eng.step()
            if step % 3 == 2:
                before = _slot_kv(eng)
                eng.pool.compact()  # moves through segment_move
                after = _slot_kv(eng)
                assert before.keys() == after.keys()
                for rid, (k, v) in before.items():
                    assert torch.equal(k, after[rid][0])
                    assert torch.equal(v, after[rid][1])
            if not eng.has_work():
                break
        eng.pool.check_invariants()
        m = eng.metrics()
        results.append(([eng.finished[r] for r in rids],
                        {k: m[k] for k in ("blocks_written", "blocks_moved",
                                           "compactions", "wamp")}))
    assert results[0] == results[1]
    assert results[0][1]["compactions"] >= 2
    # the card's engine moved its plans through the kernel, staged ones too
    assert ops.launches["segment_move"] > 0 and ops.move_plans["staged"] > 0


def test_prefix_hit_engine_on_card_matches_cpu_engine(dev):
    """The shared-prefix stream of ``tests/test_prefix_cache.py`` at f32 on
    the smoke model: the card's hit engine (its tail prefills through the
    flash kernel with a query offset) gives the CPU hit engine's tokens and
    counters, and each page's reference count is its holders' count."""
    cfg = get_config("qwen3-1.7b").smoke()
    params = _f32(Model(cfg, device="cpu", seed=0).params, "cpu")
    rng = np.random.default_rng(1)
    sys_prompt = np.random.default_rng(42).integers(1, cfg.vocab_size, 24)
    reqs = [(np.concatenate([sys_prompt, rng.integers(
        1, cfg.vocab_size, int(rng.integers(3, 14)))]),
        int(rng.integers(4, 12))) for _ in range(6)]
    results = []
    ops.reset_launches()
    for device in ("cpu", dev):
        eng = PagedServingEngine(
            Model(cfg, _f32(params, device)), n_slabs=8, blocks_per_slab=2,
            page_T=8, max_batch=3, max_seq=96, streams=1, compact_trigger=2,
            compact_batch=3, prefix_cache=True, pool_dtype=torch.float32,
            device=device)
        rids = [eng.submit(p, n) for p, n in reqs]
        eng.run_to_completion()
        eng.pool.check_invariants()
        eng.prefix_cache.check_invariants()
        tree = np.asarray(eng.prefix_cache.pages(), np.int64)
        assert (eng.pool.block_ref[tree] == 1).all()  # only the tree holds
        m = eng.metrics()
        results.append(([eng.finished[r] for r in rids],
                        {k: m[k] for k in ("blocks_written", "blocks_moved",
                                           "compactions", "wamp",
                                           "prefill_tokens_saved",
                                           "prefix_hit_rate",
                                           "frames_shared")}))
    assert results[0] == results[1]
    assert results[1][1]["prefix_hit_rate"] >= 5 / 6
    assert ops.flash_offsets["nonzero"] > 0   # the card's tail prefills


def _mixed_requests(vocab, n=8, seed=3):
    """test_chunked_prefill.py::_mixed_reqs."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(4, 60))),
             int(rng.integers(4, 25))) for _ in range(n)]


def _chunked_engine(cfg, params, device, **kw):
    return PagedServingEngine(
        Model(cfg, _f32(params, device)), n_slabs=6, blocks_per_slab=4,
        page_T=8, max_batch=3, max_seq=96, compact_trigger=1,
        compact_batch=2, prefill_chunk=16, pool_dtype=torch.float32,
        device=device, **kw)


def test_chunked_engine_on_card_matches_cpu_engine(dev):
    """test_chunked_prefill.py's concurrent mixed stream at f32 on the smoke
    model, chunked at 16 tokens: the card's engine (its chunks through the
    flash kernel with a query offset, fused with decode) gives the CPU
    engine's tokens and counters, under compaction."""
    cfg = get_config("qwen3-1.7b").smoke()
    params = _f32(Model(cfg, device="cpu", seed=0).params, "cpu")
    reqs = _mixed_requests(cfg.vocab_size, n=10)
    results = []
    ops.reset_launches()
    for device in ("cpu", dev):
        eng = _chunked_engine(cfg, params, device)
        rids = [eng.submit(p, n) for p, n in reqs]
        eng.run_to_completion()
        eng.pool.check_invariants()
        m = eng.metrics()
        results.append(([eng.finished[r] for r in rids],
                        {k: m[k] for k in ("blocks_written", "blocks_moved",
                                           "compactions", "wamp", "dispatches",
                                           "prefill_chunks_dispatched")}))
    assert results[0] == results[1]
    assert results[1][1]["compactions"] >= 1
    assert ops.flash_offsets["nonzero"] > 0 and ops.launches["paged_attention"] > 0


def test_fused_dispatch_reads_the_card_once(dev, monkeypatch):
    """Every fused ``step()`` (one chunk plus the decode of the other slots)
    reads the card once: the decode tokens and the chunk's first token come
    back in one copy, and no other value is read to the host."""
    cfg = get_config("qwen3-1.7b").smoke()
    params = _f32(Model(cfg, device="cpu", seed=0).params, "cpu")
    eng = _chunked_engine(cfg, params, dev)
    for p, n in _mixed_requests(cfg.vocab_size, n=10):
        eng.submit(p, n)
    reads = []

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **k):
            if self.is_cuda:
                reads.append(name)
            return orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, read)

    for name in ("cpu", "item", "tolist", "__int__", "__float__", "__bool__",
                 "__index__", "numpy"):
        counting(name)
    firsts = []   # per chunk run: whether it returned the first token
    run_chunk = eng._prefill_chunk

    def chunk(pf):
        first = run_chunk(pf)
        firsts.append(first is not None)
        return first

    eng._prefill_chunk = chunk
    while eng.has_work():
        decoding = bool(eng._decoding().any())  # admission adds no decoder
        n0 = len(firsts)
        reads.clear()
        eng.step()
        if len(firsts) > n0:
            assert reads == (["cpu"] if decoding or firsts[-1] else [])
        else:
            assert len(reads) <= 1
    assert len(firsts) == eng.prefill_chunks_dispatched > 0


def _slot_kv(eng):
    """Each live slot's K/V read through its block-table row."""
    return {int(eng.rid[i]): (eng.k_pools[:, eng.slot_pages(i)].clone(),
                              eng.v_pools[:, eng.slot_pages(i)].clone())
            for i in range(eng.max_batch) if eng.slot_active(i)}


def _f32(tree, dev):
    return {k: _f32(v, dev) if isinstance(v, dict)
            else v.to(dev, torch.float32) for k, v in tree.items()}


# -------------------------------------------- async compaction on the card

def _cast(tree, dev, dtype):
    return {k: _cast(v, dev, dtype) if isinstance(v, dict)
            else v.to(dev, dtype) for k, v in tree.items()}


def _async_requests(vocab):
    """test_async_compaction.py::_reqs."""
    rng = np.random.default_rng(1)
    lens = [5, 17, 9, 24, 3, 12, 20, 7, 15, 11]
    news = [16, 20, 14, 18, 22, 15, 19, 21, 13, 17]
    return [(rng.integers(1, vocab, size=n), m) for n, m in zip(lens, news)]


def _serve_all(eng, requests):
    rids = [eng.submit(p, n) for p, n in requests]
    eng.run_to_completion()
    eng.audit()
    m = eng.metrics()
    return [eng.finished[r] for r in rids], {
        k: m[k] for k in ("blocks_written", "blocks_moved", "compactions",
                          "wamp", "compaction_debt_moves", "fenced_slabs")}


ASYNC_KW = dict(n_slabs=8, blocks_per_slab=2, page_T=8, max_batch=3,
                max_seq=96, policy="mdc", compact_trigger=2, compact_batch=2,
                audit_every=1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_async_engine_on_card_matches_sync_on_card(dev, dtype):
    """test_async_compaction.py's stream (through 8 slabs, where a moved
    page's owner dies inside a window): the async engine on the card, its
    moves on the side stream, gives the sync engine's tokens on the card bit
    for bit; at f32 both also give the CPU engine's tokens."""
    cfg = get_config("qwen3-1.7b").smoke()
    params = Model(cfg, device="cpu", seed=0).params
    reqs = _async_requests(cfg.vocab_size)
    runs = {}
    for device in ((dev, "cpu") if dtype == torch.float32 else (dev,)):
        model = Model(cfg, _cast(params, device, dtype))
        for mode, kw in (("sync", {}), ("async", {"async_compaction": True})):
            ops.reset_launches()
            eng = PagedServingEngine(model, pool_dtype=dtype, device=device,
                                     **ASYNC_KW, **kw)
            runs[str(device), mode] = _serve_all(eng, reqs)
            if device != "cpu" and mode == "async":
                assert eng.pool.stats.gc_planned == eng.pool.stats.gc_committed > 0
                side = ops.stream_launches["segment_move"]
                assert side.get(eng._side.cuda_stream, 0) > 0
    tokens = {k: v[0] for k, v in runs.items()}
    assert tokens[str(dev), "async"] == tokens[str(dev), "sync"]
    if dtype == torch.float32:
        assert tokens[str(dev), "async"] == tokens["cpu", "async"]
        assert runs[str(dev), "async"] == runs["cpu", "async"]


# a move waits this long on the side stream (~50 ms at the H100's clock), so
# that a missing wait shows as other tokens
SLEEP_CYCLES = 100_000_000


def _shared_stream(vocab, n_sys):
    """One system prompt (test_prefix_cache.py's shared stream, 10 users)
    or three (12 users, tails of 3-13 tokens)."""
    if n_sys == 1:
        rng = np.random.default_rng(1)
        sys_prompt = np.random.default_rng(42).integers(1, vocab, size=24)
        return [(np.concatenate([sys_prompt, rng.integers(
            1, vocab, size=int(rng.integers(3, 14)))]), int(rng.integers(4, 12)))
            for _ in range(10)]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, vocab, size=16) for _ in range(n_sys)]
    return [(np.concatenate([prompts[int(rng.integers(n_sys))],
                             rng.integers(1, vocab, size=int(rng.integers(3, 14)))]),
             int(rng.integers(2, 12))) for _ in range(12)]


# the streams of the widened window, each with the counter of its hazard:
# a sub-plan committed at once because the next dispatch writes its source
# (hazard 3), and a moved page that a prefix-cache eviction kills and the same
# admission hands out again while its move is in flight (hazard 4)
WINDOW_STREAMS = {
    "hazard_commit": (1, {}, "hazard_commits"),
    "dead_destination": (3, {"prefix_cache_pages": 6},
                         "dead_destination_waits"),
}


def _window_run(dev, stream, *, widen: bool, **kw):
    n_sys, extra, counter = WINDOW_STREAMS[stream]
    cfg = get_config("qwen3-1.7b").smoke()
    params = _f32(Model(cfg, device="cpu", seed=0).params, dev)
    eng = PagedServingEngine(
        Model(cfg, params), n_slabs=8, blocks_per_slab=2, page_T=8,
        max_batch=3, max_seq=96, policy="mdc", streams=1, compact_trigger=2,
        compact_batch=3, prefix_cache=True, pool_dtype=torch.float32,
        clean_budget=4, device=dev, **extra, **kw)
    if widen:
        eng.before_side_move = lambda: torch.cuda._sleep(SLEEP_CYCLES)
    rids = [eng.submit(p, n) for p, n in _shared_stream(cfg.vocab_size, n_sys)]
    eng.run_to_completion()
    torch.cuda.synchronize()
    return [eng.finished[r] for r in rids], eng, counter


@pytest.mark.parametrize("stream", list(WINDOW_STREAMS))
def test_async_widened_window_keeps_tokens(dev, stream):
    """Each move sleeps ~50 ms on the side stream before it copies: the
    events still order everything, so the tokens are the sync engine's, on
    a stream where the window's hazard occurs."""
    want, _, _ = _window_run(dev, stream, widen=False)
    got, eng, counter = _window_run(dev, stream, widen=True,
                                    async_compaction=True)
    assert getattr(eng, counter) >= 1
    assert eng.pool.stats.gc_planned == eng.pool.stats.gc_committed > 0
    eng.audit()
    assert got == want


@pytest.mark.parametrize("stream,removed", [
    ("hazard_commit", "every wait"),
    ("dead_destination", "the dead-destination wait")])
def test_async_widened_window_without_waits_gives_other_tokens(
        dev, stream, removed, monkeypatch):
    """The same streams with the main stream's waits taken out (only in this
    test): the widened window then shows as other tokens, so the tokens of
    the test above depend on the waits.  On the dead-destination stream
    only that hazard's wait goes: the commit waits then hold the main
    stream until the late move has overwritten the page handed out again,
    and the new owner's decode reads it (with every wait gone, the new
    owner can finish within the ~50 ms before the move lands)."""
    want, _, _ = _window_run(dev, stream, widen=False)
    if removed == "every wait":
        monkeypatch.setattr(PagedServingEngine, "_main_wait",
                            lambda self, event: None)
    else:
        monkeypatch.setattr(PagedServingEngine, "_on_dead_destination",
                            lambda self, pages: None)
    got, _, _ = _window_run(dev, stream, widen=True, async_compaction=True)
    assert got != want


def _count_syncs(fn, counts):
    """``fn`` with the calls that wait for the card (PyTorch's sync debug
    mode, as ``scripts/profile_engine.py`` counts them) added to
    ``counts``."""
    import warnings

    def call(*args):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append((sum("synchronizing" in str(w.message) for w in caught),
                       args[0] if args else 0))
        return out
    return call


def test_async_adds_no_host_sync(dev):
    """The pump (commits, hazard checks, moves on the side stream) makes no
    call that waits for the card, and a decode token step makes no more
    than in the sync engine."""
    cfg = get_config("qwen3-1.7b").smoke()
    params = _f32(Model(cfg, device="cpu", seed=0).params, dev)
    per_step, calls = {}, {}
    # a first, unmeasured run: the process's first decode at these shapes
    # makes one more synchronising call (lazy initialisation)
    _serve_all(PagedServingEngine(Model(cfg, params), pool_dtype=torch.float32,
                                  device=dev, **ASYNC_KW),
               _async_requests(cfg.vocab_size))
    for mode, kw in (("sync", {}), ("async", {"async_compaction": True})):
        eng = PagedServingEngine(Model(cfg, params), pool_dtype=torch.float32,
                                 device=dev, **ASYNC_KW, **kw)
        decode, pump = [], []
        eng._decode = _count_syncs(eng._decode, decode)
        eng._pump_compaction = _count_syncs(eng._pump_compaction, pump)
        _serve_all(eng, _async_requests(cfg.vocab_size))
        per_step[mode] = (sum(s for s, _ in decode)
                          / sum(n for _, n in decode))
        calls[mode] = decode
        if mode == "async":
            assert eng.pool.stats.gc_committed > 0 and pump
            assert sum(s for s, _ in pump) == 0
    assert 0 < per_step["async"] <= per_step["sync"], (per_step, calls)


# ------------------------------------------------- crash safety on the card

def test_dropped_engine_keeps_pools_until_the_side_move_is_done(dev):
    """A sub-plan is launched on the side stream, held back ~0.5 s there by a
    device spin, and the engine is dropped at once.  The pools were
    allocated on the main stream: without ``record_stream`` the caching
    allocator hands their memory straight to the next allocations there,
    and the late move writes into them.  Two tensors of the pools' size,
    allocated and filled on the main stream right after the drop, must
    still hold what was written once everything has run.  The fill is a
    distinct value per element, not zeros: the move copies pages within
    the same memory, so over zeros it would copy zeros.  Full-width heads
    and layers at f32 make each pool its own allocator segment (over
    10 MB), which the next allocation of that size takes when it is free."""
    import gc
    cfg = get_config("qwen3-1.7b")
    params = _cast(Model(cfg, device=dev, seed=0).params, dev, torch.float32)
    eng = PagedServingEngine(Model(cfg, params), pool_dtype=torch.float32,
                             device=dev, async_compaction=True,
                             **{**ASYNC_KW, "audit_every": 0})
    assert eng.k_pools.numel() * eng.k_pools.element_size() > 10 << 20
    for p, n in _async_requests(cfg.vocab_size):
        eng.submit(p, n)
    # a step boundary with a planned sub-plan whose blocks are still alive
    # (a block that died since its planning is not moved)
    while eng.has_work() and not any(len(eng._live_moves(p))
                                     for p in eng.pool.pending_plans):
        eng.step()
    shape, dtype = eng.k_pools.shape, eng.k_pools.dtype
    n = int(np.prod(shape))
    assert n < 1 << 24            # every value exact in f32
    want = torch.arange(n, dtype=dtype, device=dev).view(shape)
    torch.cuda.synchronize()      # (the fill's kernel is loaded by now)
    eng.before_side_move = lambda: torch.cuda._sleep(10 * SLEEP_CYCLES)
    eng._pump_compaction()          # the start of a step: the moves launch
    assert any(len(eng._live_moves(p)) for p in eng._inflight_plans), \
        "no move in flight to drop the engine on"
    eng = None                      # the drop (its reference cycles below)
    gc.collect()
    fresh = [torch.arange(n, dtype=dtype, device=dev).view(shape)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(t, want) for t in fresh)


def test_journal_and_snapshots_add_no_host_sync(dev):
    """A journaled engine (a snapshot every 2 dispatches) makes exactly the
    synchronising calls of an unjournaled one, step for step: records and
    snapshots are host bookkeeping only."""
    import tempfile
    cfg = get_config("qwen3-1.7b").smoke()
    params = _f32(Model(cfg, device="cpu", seed=0).params, dev)
    _serve_all(PagedServingEngine(Model(cfg, params), pool_dtype=torch.float32,
                                  device=dev, **ASYNC_KW),
               _async_requests(cfg.vocab_size))   # lazy initialisation
    calls, inner = {}, {}
    for mode in ("plain", "journal"):
        with tempfile.TemporaryDirectory() as d:
            kw = dict(journal_dir=d, snapshot_every=2) if mode == "journal" \
                else {}
            eng = PagedServingEngine(Model(cfg, params), pool_dtype=torch.float32,
                                     device=dev, **ASYNC_KW, **kw)
            steps, books = [], []
            eng.step = _count_syncs(eng.step, steps)
            eng._jrec = _count_syncs(eng._jrec, books)
            eng.snapshot = _count_syncs(eng.snapshot, books)
            _serve_all(eng, _async_requests(cfg.vocab_size))
            calls[mode] = [s for s, _ in steps]
            inner[mode] = books
            if mode == "journal":
                assert eng._snap_id >= 2 and eng.journal.next_seq > 0
    assert calls["journal"] == calls["plain"]
    assert inner["journal"] and sum(s for s, _ in inner["journal"]) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_recovery_on_card_gives_the_unkilled_tokens(dev, dtype, tmp_path):
    """Smoke width on the card: the engine journals (a snapshot every 2
    dispatches); a recovery from a clone of the journal taken at every
    third record boundary, on the card, drains to the unkilled run's tokens
    and re-runs the prefill and decode kernels."""
    import json
    import shutil
    from repro_torch.serving import recover_engine
    cfg = get_config("qwen3-1.7b").smoke()
    model = Model(cfg, _cast(Model(cfg, device="cpu", seed=0).params, dev,
                             dtype))
    kw = dict(ASYNC_KW, pool_dtype=dtype, device=dev)
    reqs = _async_requests(cfg.vocab_size)
    eng = PagedServingEngine(model, journal_dir=tmp_path / "j",
                             snapshot_every=2, **kw)
    cuts, append = [], eng.journal.append

    def hooked(payload):
        seq = append(payload)
        if seq % 3 == 2:
            shutil.copytree(tmp_path / "j", tmp_path / f"cut{seq}")
            cuts.append((seq, json.loads(payload)))
        return seq

    eng.journal.append = hooked
    want, _ = _serve_all(eng, reqs)
    assert eng.pool.stats.compactions >= 1
    n_sub = 0
    for seq, rec in cuts:
        n_sub = sum(1 for r in _journal_records(tmp_path / f"cut{seq}")
                    if r["t"] == "sub")
        ops.reset_launches()
        reng, rep = recover_engine(model, tmp_path / f"cut{seq}", **kw)
        reng.run_to_completion()
        reng.audit()
        assert {r: reng.finished.get(r) for r in range(n_sub)} == \
            {r: want[r] for r in range(n_sub)}, f"cut at record {seq}"
        if rep["sequences_resumed"]:
            assert ops.launches["flash_attention"] > 0
            assert ops.launches["paged_attention"] > 0
    assert n_sub == len(reqs)


def _journal_records(d):
    """Every record in a journal directory's files, in order (the ones a
    snapshot compacted away included, while their file survives)."""
    import json
    import struct
    from pathlib import Path
    hdr = struct.Struct("<IIQ")
    out = []
    for f in sorted(Path(d).glob("journal_*.log")):
        data, off = f.read_bytes(), 0
        while off + hdr.size <= len(data):
            ln = hdr.unpack_from(data, off)[0]
            out.append(json.loads(data[off + hdr.size:off + hdr.size + ln]))
            off += hdr.size + ln
    return out


# ------------------------------------------------ observability on the card

def _observed(eng_kw, tmp_path, name):
    """The engine arguments of full observability: a tracer, the phase
    split, death calibration and a metrics row every 2 dispatches."""
    from repro_torch.obs import Tracer
    tracer = Tracer(capacity=1 << 16)
    return tracer, dict(eng_kw, tracer=tracer, phase_log=True, calibration=True,
                        metrics_every=2, metrics_sink=tmp_path / f"{name}.jsonl")


def test_observability_adds_no_host_sync(dev, tmp_path):
    """A traced, phase-logged, calibrated engine sampling its metrics makes
    exactly the synchronising calls of a plain one, step for step: the
    tracer, the phase clock, the calibration and the metric rows read only
    host values."""
    cfg = get_config("qwen3-1.7b").smoke()
    params = _f32(Model(cfg, device="cpu", seed=0).params, dev)
    kw = dict(ASYNC_KW, pool_dtype=torch.float32, device=dev)
    _serve_all(PagedServingEngine(Model(cfg, params), **kw),
               _async_requests(cfg.vocab_size))   # lazy initialisation
    calls, tokens = {}, {}
    for mode in ("plain", "observed"):
        tracer, okw = (None, kw) if mode == "plain" else \
            _observed(kw, tmp_path, mode)
        eng = PagedServingEngine(Model(cfg, params), **okw)
        steps = []
        eng.step = _count_syncs(eng.step, steps)
        tokens[mode] = _serve_all(eng, _async_requests(cfg.vocab_size))
        calls[mode] = [s for s, _ in steps]
        if tracer is not None:
            assert eng.phase_report()["dispatches"] == eng.dispatches > 0
            assert len(tracer) > 0 and eng.calibration.report()["deaths"] > 0
    assert calls["observed"] == calls["plain"]
    assert tokens["observed"] == tokens["plain"]


def test_observed_engine_on_card_gives_the_plain_bf16_tokens(dev, tmp_path):
    """bf16 weights and pool on the card, under compaction: observability
    changes no token and no counter, and its trace has the engine's
    lifecycle and segment events."""
    cfg = get_config("qwen3-1.7b").smoke()
    model = Model(cfg, _cast(Model(cfg, device="cpu", seed=0).params, dev,
                             torch.bfloat16))
    kw = dict(ASYNC_KW, pool_dtype=torch.bfloat16, device=dev)
    plain = _serve_all(PagedServingEngine(model, **kw),
                       _async_requests(cfg.vocab_size))
    tracer, okw = _observed(kw, tmp_path, "bf16")
    eng = PagedServingEngine(model, **okw)
    assert _serve_all(eng, _async_requests(cfg.vocab_size)) == plain
    assert plain[1]["compactions"] >= 1
    names = {e["name"] for e in tracer.export()["traceEvents"]}
    assert {"step", "dispatch", "host_sync", "req", "req.admit", "seg.open",
            "seg.seal", "seg.evacuate", "compaction"} <= names


def test_recovered_engine_on_card_traces_its_journal_core(dev, tmp_path,
                                                          monkeypatch):
    """``recover_engine(..., tracer=)`` on the card: the rebuilt engine, its
    pool's core and its journal's core report to the tracer; with small
    journal segments the recovered session opens journal segments whose ids
    lie past the pool's slabs, and their events reach the tracer."""
    import functools
    from repro_torch.obs import Tracer
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import recover_engine
    monkeypatch.setattr(engine_mod, "JournalLog",
                        functools.partial(engine_mod.JournalLog, seg_bytes=256))
    cfg = get_config("qwen3-1.7b").smoke()
    model = Model(cfg, _f32(Model(cfg, device="cpu", seed=0).params, dev))
    kw = dict(ASYNC_KW, pool_dtype=torch.float32, device=dev, snapshot_every=3)
    want, _ = _serve_all(PagedServingEngine(model, **kw),
                         _async_requests(cfg.vocab_size))
    eng = PagedServingEngine(model, journal_dir=tmp_path / "j", **kw)
    for p, n in _async_requests(cfg.vocab_size):
        eng.submit(p, n)
    for _ in range(4):      # the kill: sequences live
        eng.step()
    eng.journal.close()
    first = eng.journal.core.next_sid
    tracer = Tracer(capacity=1 << 16)
    reng, rep = recover_engine(model, tmp_path / "j", tracer=tracer, **kw)
    assert reng.tracer is tracer and reng.pool.core.tracer is tracer
    assert reng.journal.core.tracer is tracer
    reng.run_to_completion()
    reng.audit()
    assert rep["sequences_resumed"] > 0
    assert [reng.finished[r] for r in range(len(want))] == want
    opened = {e["args"]["seg"] for e in tracer.events()
              if e["name"] == "seg.open"}
    journal_sids = set(range(max(first, reng.pool.core.nseg),
                             reng.journal.core.next_sid))
    assert journal_sids and journal_sids <= opened


# ------------------------ paged attention with q's dtype apart from the pools'

DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]


def _pair_id(pair):
    return "q{}-kv{}".format(*(str(d).removeprefix("torch.") for d in pair))


@pytest.mark.parametrize("pair", DTYPE_PAIRS, ids=_pair_id)
@pytest.mark.parametrize("B,H,Kh,D,T,P,lens", [
    (6, 16, 8, 128, 16, 20, [0, 1, 128, 257, 320, 7]),
    (3, 4, 4, 128, 16, 1, [0, 16, 9]),
    (3, 16, 2, 128, 16, 12, [1, 100, 192]),
    (3, 8, 1, 32, 8, 9, [0, 72, 65]),
    (4, 8, 2, 64, 8, 30, [240, 1, 33, 0]),
    (2, 4, 2, 64, 2, 1100, [2197, 2200]),
])
def test_paged_attention_kernel_dtype_pairs(dev, B, H, Kh, D, T, P, lens,
                                            pair):
    """Every q / pool dtype pair in one launch, at the split edges, against
    the plain version (its promotion: f32 softmax, P in the pools' dtype)
    within the pair's own bar (``_torch_checks.paged_bar``); the output
    takes q's dtype, and a zero-length row is zeros."""
    q_dtype, kv_dtype = pair
    rng = np.random.default_rng(3)
    _, k_pool, v_pool, bt = _paged_inputs(rng, dev, kv_dtype, B, H, Kh, D, T, P)
    q = _randn(rng, (B, H, D), q_dtype, dev)
    lens = torch.tensor(np.asarray(lens, np.int32), device=dev)
    n0 = ops.launches["paged_attention"]
    got = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    torch.cuda.synchronize()
    assert ops.launches["paged_attention"] == n0 + 1
    assert got.dtype == q_dtype
    live = lens > 0
    want = ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)
    bar = paged_bar(q, k_pool, v_pool, bt, lens, want)
    check_paged_close(got[live], want[live], bar[live])
    assert not got[~live].float().any()


def test_paged_attention_refuses_pools_of_two_dtypes(dev):
    q = torch.zeros(1, 2, 64, device=dev)
    k = torch.zeros(2, 8, 2, 64, device=dev)
    bt = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="one dtype"):
        ops.paged_attention(q, k, k.to(torch.bfloat16), bt, lens)
    with pytest.raises(ValueError, match="one dtype"):
        ops.paged_attention(q.half(), k, k, bt, lens)


@pytest.mark.parametrize("case", list(PAGED_SHA256),
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_same_dtype_is_the_kernel_before_it(dev, case, dtype):
    out = ops.paged_attention(*paged_case(dtype, dtype, *case))
    assert digest(out) == PAGED_SHA256[case][dtype == torch.float32]


def test_paged_attention_mixed_pair_replays_in_a_cuda_graph(dev):
    """f32 q over bf16 pools, captured once and replayed after the table
    and lengths were rewritten in place: one launch, no cast kernel, each
    replay the plain version's."""
    rng = np.random.default_rng(7)
    B, H, Kh, D, T, P = 8, 16, 8, 128, 16, 32
    n_pages = 2 * B * P
    _, k_pool, v_pool, bt = _paged_inputs(rng, dev, torch.bfloat16, B, H, Kh,
                                          D, T, P, n_pages)
    q = _randn(rng, (B, H, D), torch.float32, dev)
    lens = torch.from_numpy(rng.integers(1, P * T + 1, B).astype(np.int32)).to(dev)
    ops.paged_attention(q, k_pool, v_pool, bt, lens)  # built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = ops.launches["paged_attention"]
    with torch.cuda.graph(graph):
        out = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    assert ops.launches["paged_attention"] == n0 + 1
    for _ in range(3):
        bt.copy_(torch.from_numpy(rng.permutation(n_pages)[:B * P]
                                  .reshape(B, P).astype(np.int32)))
        lens.copy_(torch.from_numpy(rng.integers(0, P * T + 1, B)
                                    .astype(np.int32)))
        graph.replay()
        torch.cuda.synchronize()
        live = lens > 0
        want = ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)
        assert out.dtype == torch.float32
        bar = paged_bar(q, k_pool, v_pool, bt, lens, want)
        check_paged_close(out[live], want[live], bar[live])
        assert not out[~live].float().any()


def test_f32_params_over_bf16_pool_on_card_match_cpu(dev):
    """``serve_run``'s stream with f32 parameters over its default bf16
    pool (the mix ``tests/test_torch_serve.py`` holds against the JAX
    package on the CPU): the card's row equals the CPU's."""
    from repro_torch.launch.serve import serve_run
    cfg = get_config("qwen3-1.7b").smoke()
    params = _f32(Model(cfg, device="cpu", seed=0).params, "cpu")
    rows = []
    for device in ("cpu", dev):
        ops.reset_launches()
        rows.append(serve_run(requests=10, policy="mdc",
                              model=Model(cfg, _f32(params, device)),
                              device=device, verbose=False))
    assert ops.launches["paged_attention"] > 0
    keys = ("tokens", "finished_digest", "wamp", "compactions", "dispatches",
            "blocks_moved", "blocks_written")
    assert {k: rows[1][k] for k in keys} == {k: rows[0][k] for k in keys}
    assert rows[0]["compactions"] >= 1


def test_bf16_params_over_f32_pool_on_card_match_cpu(dev):
    """bf16 parameters over an f32 pool (the JAX examples/serve_paged.py
    prefix demo's mix), with the prefix cache on and a shared system
    prompt: every request finishes on the card with the CPU engine's
    counters and tokens."""
    cfg = get_config("qwen3-1.7b").smoke()
    bf = Model(cfg, device="cpu", seed=0).params
    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab_size, size=32)
    reqs = [(np.concatenate([system, rng.integers(1, cfg.vocab_size,
                                                  size=int(n))]), int(m))
            for n, m in zip(rng.integers(3, 20, 6), rng.integers(4, 16, 6))]
    out = []
    for device in ("cpu", dev):
        model = Model(cfg, _cast(bf, device, torch.bfloat16))
        eng = PagedServingEngine(model, n_slabs=12, blocks_per_slab=4,
                                 page_T=8, max_batch=2, max_seq=128,
                                 prefix_cache=True, pool_dtype=torch.float32,
                                 device=device)
        ops.reset_launches()
        rids = [eng.submit(p, n) for p, n in reqs]
        eng.run_to_completion()
        eng.pool.check_invariants()
        m = eng.metrics()
        out.append(([eng.finished[r] for r in rids],
                     {k: m[k] for k in ("dispatches", "blocks_written",
                                        "prefill_tokens_saved")}))
    assert ops.launches["paged_attention"] > 0
    assert out[1][1]["prefill_tokens_saved"] > 0
    assert out[1] == out[0]


# ------------------------ the simulator's victims through mdc_priority

def test_simulator_victims_through_mdc_priority_on_card(dev):
    """A small store (512 segments of 64 pages, 80:20 hot/cold) through
    ``DeviceVictimCheck`` on the card, as chip_smoke.py's sim phase runs the
    paper's store: one launch per cleaning cycle at least, device picks
    equal to the host's up to near-ties, and the run's counters and arrays
    those of an unchecked run."""
    import dataclasses
    from _torch_checks import DeviceVictimCheck
    from repro_torch.core.simulator import SimConfig, Simulator
    cfg = SimConfig(nseg=512, pages_per_seg=64, fill_factor=0.8, policy="mdc",
                    clean_trigger=8, clean_batch=16, buf_segs=8, seed=0)
    sims = [Simulator(cfg, workload_name="hot_cold", update_frac=0.8,
                      data_frac=0.2) for _ in range(2)]
    n = 2 * 512 * 64
    sims[0].run(n)
    check = DeviceVictimCheck(dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    with check.installed():
        sims[1].run(n)
    torch.cuda.synchronize()
    rep = check.report()
    assert rep["cycles"] == sims[1].store.stats.cleanings > 0
    assert ops.launches["mdc_priority"] >= rep["cycles"]
    assert rep["kernel_ms_median"] > 0
    assert dataclasses.asdict(sims[1].store.stats) == \
        dataclasses.asdict(sims[0].store.stats)
    for name in ("seg_live", "seg_up2", "seg_state", "page_seg"):
        assert np.array_equal(getattr(sims[1].store, name),
                              getattr(sims[0].store, name))
    sims[1].store.check_invariants()


# ------------------------------------------- tensor-parallel serving (mesh)

def _tp_stream():
    """tp_smoke at f32 (16 q / 8 kv heads, one weight draw on the CPU) and
    test_sharded_serving.py's _serve stream, whose pool compacts."""
    cfg = get_config("qwen3-1.7b").tp_smoke()
    params = _cast(Model(cfg, device="cpu", seed=0).params, "cpu",
                   torch.float32)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, cfg.vocab_size, size=p), n) for p, n in
            zip([5, 17, 9, 24, 3, 12], [6, 10, 4, 8, 12, 5])]
    kw = dict(n_slabs=7, blocks_per_slab=2, page_T=8, max_batch=3,
              max_seq=96, policy="mdc", streams=1, compact_trigger=2,
              compact_batch=3, max_decode_chunk=8, pool_dtype=torch.float32)
    return cfg, params, reqs, kw


def test_sharded_wrappers_on_card_are_the_unsharded_slices(dev):
    """Two gloo ranks sharing the card, each on 4 of 8 kv heads (f32, D 32,
    G 2): every rank's paged / flash output (and a q_offset 8 flash) is bit
    for bit the unsharded kernel's slice of its heads, and its gather the
    whole unsharded output."""
    import _torch_tp as tp
    from repro_torch.launch.mesh import spawn_ranks
    case = tp.wrapper_case(seed=0)
    ranks = spawn_ranks(tp.run_cases, 2, {"w": dict(kind="wrappers",
                                                     inputs=case,
                                                     q_offset=8)},
                        backend="gloo", device="cuda")
    t = {k: torch.from_numpy(v).to(dev) for k, v in case.items()}
    whole = {"paged": ops.paged_attention(t["q"], t["kp"], t["vp"], t["bt"],
                                          t["lens"]),
             "flash": ops.flash_attention(t["qf"], t["kf"], t["vf"]),
             "flash_offset": ops.flash_attention(t["qf"][:, 8:], t["kf"],
                                                 t["vf"], q_offset=8)}
    for rank, r in enumerate(ranks):
        for k, w in whole.items():
            w = w.cpu()
            axis = 1 if k == "paged" else 2
            assert np.array_equal(r["w"][k],
                                  tp.local_heads(w, axis, rank, 2).numpy()), k
            assert np.array_equal(r["w"][f"{k}_gathered"], w.numpy()), k


def test_sharded_engine_on_card_matches_cpu_unsharded(dev):
    """The 2-rank gloo engine on the card (tp_smoke, f32) serves the CPU
    one-device engine's tokens and metrics, its pools sharded to 4 kv
    heads."""
    import _torch_tp as tp
    from repro_torch.launch.mesh import spawn_ranks
    cfg, params, reqs, kw = _tp_stream()
    base = tp.serve_stream(Model(cfg, params), reqs, "cpu", **kw)
    ranks = spawn_ranks(tp.run_cases, 2, {"s": dict(
        cfg=cfg, params=params, requests=reqs,
        engine_kw=dict(kw, audit_every=2))}, backend="gloo", device="cuda")
    assert base["metrics"]["compactions"] >= 1
    for r in ranks:
        assert r["s"]["pool_sharded"] and r["s"]["pool_shape"][3] == 4
        assert r["s"]["tokens"] == base["tokens"]
        assert r["s"]["metrics"] == base["metrics"]


def test_nccl_world_size_one_is_the_unsharded_engine(dev, tmp_path):
    """One nccl rank in this process: the mesh path (sharded wrappers,
    gather_heads through NCCL, the agreement check) is bit for bit the
    unsharded engine on the card."""
    import torch.distributed as dist
    import _torch_tp as tp
    from repro_torch.launch.mesh import make_serving_mesh
    cfg, params, reqs, kw = _tp_stream()
    model = Model(cfg, _cast(params, dev, torch.float32))
    base = tp.serve_stream(model, reqs, dev, **kw)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        ops.reset_launches()
        got = tp.serve_stream(model, reqs, dev, make_serving_mesh(1),
                              audit=True, **kw)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert ops.launches["paged_attention_sharded"] > 0
    assert ops.launches["flash_attention_sharded"] > 0
    assert got["pool_sharded"]
    assert got["tokens"] == base["tokens"]
    assert got["metrics"] == base["metrics"]


# ------------------------------------------------------ the MoE family

MOE = "qwen3-moe-30b-a3b"


def _moe_input(cfg, T, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return _randn(rng, (1, T, cfg.d_model), dtype, dev)


@pytest.mark.parametrize("cf", [4.0, 1.0], ids=["no-drop", "drops"])
def test_moe_ffn_on_card_matches_cpu(dev, cf):
    """The smoke MoE layer at f32 on the card against the CPU: a 64-token
    call in 32 groups of two tokens, at the smoke config's capacity (no
    drop) and at 1.0 (drops)."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer
    cfg = get_config(MOE).smoke().with_(capacity_factor=cf)
    params = _f32(Model(cfg, device="cpu", seed=0).params, "cpu")
    lp = layer(params["blocks"], 0)["mlp"]
    x = _moe_input(cfg, 64, "cpu", torch.float32)
    want = moe.moe_ffn(x, lp, cfg, cf, cfg.moe_groups)
    got = moe.moe_ffn(x.to(dev), _f32(lp, dev), cfg, cf, cfg.moe_groups)
    torch.testing.assert_close(got.cpu(), want, **TOL[torch.float32])
    xg, top_p, top_e, cap = moe._route(x.to(dev), lp["router"].to(dev),
                                       cfg, cf, cfg.moe_groups)
    keep = moe._dispatch_group(xg, top_e, top_p, cfg.n_experts, cfg.top_k,
                               cap)[1][3]
    assert bool(keep.all()) == (cf == 4.0)


@pytest.mark.parametrize("T", [8, 1024], ids=["decode", "prefill"])
def test_full_width_moe_layer_repeats_bitwise(dev, T):
    """One full-width Qwen3-30B-A3B layer's ``moe_ffn`` (128 experts, top-8,
    bf16) called twice on the same input gives the same bits: the combine
    sums each token's picks in a fixed order, without atomics."""
    from repro_torch.models import moe
    from repro_torch.models.layers import init_params
    cfg = get_config(MOE)
    specs = {k: s._replace(shape=s.shape[1:]) for k, s in
             moe.moe_specs(cfg, 1).items()}
    lp = init_params(specs, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    x = _moe_input(cfg, T, dev, torch.bfloat16)
    a = moe.moe_ffn(x, lp, cfg, cfg.capacity_factor, cfg.moe_groups)
    b = moe.moe_ffn(x, lp, cfg, cfg.capacity_factor, cfg.moe_groups)
    assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
    assert torch.equal(a, b)


def test_moe_engine_on_card_matches_cpu_engine(dev):
    """The MoE smoke engine at f32 on the card against the CPU, on a
    compacting stream: same tokens, same pool counters, and the card's
    decode through the paged kernel."""
    cfg = get_config(MOE).smoke()
    params = _f32(Model(cfg, device="cpu", seed=0).params, "cpu")
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, cfg.vocab_size, size=n), m) for n, m in
            zip([5, 17, 9, 24, 3, 12], [6, 10, 4, 8, 12, 5])]
    results = []
    ops.reset_launches()
    for device in ("cpu", dev):
        eng = PagedServingEngine(Model(cfg, _f32(params, device)), n_slabs=7,
                                 blocks_per_slab=2, page_T=8, max_batch=3,
                                 max_seq=96, streams=1, compact_trigger=2,
                                 compact_batch=3, max_decode_chunk=8,
                                 pool_dtype=torch.float32, device=device)
        rids = [eng.submit(p, n) for p, n in reqs]
        eng.run_to_completion()
        eng.pool.check_invariants()
        m = eng.metrics()
        results.append(([eng.finished[r] for r in rids],
                        {k: m[k] for k in ("blocks_written", "blocks_moved",
                                           "compactions", "wamp")}))
    assert results[0] == results[1]
    assert results[0][1]["compactions"] >= 1
    assert ops.launches["paged_attention"] > 0
