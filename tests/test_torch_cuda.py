"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpret mode, so every test here needs a card: they
carry the ``cuda`` marker and skip without one (the decision is taken inside
the fixture, never at import).  The file imports no JAX, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import Model
from repro_torch.serving import PagedServingEngine

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


def _slot_kv(eng):
    """Each live slot's K/V read through its block-table row."""
    return {int(eng.rid[i]): (eng.k_pools[:, eng.slot_pages(i)].clone(),
                              eng.v_pools[:, eng.slot_pages(i)].clone())
            for i in range(eng.max_batch) if eng.slot_active(i)}


def _f32(tree, dev):
    return {k: _f32(v, dev) if isinstance(v, dict)
            else v.to(dev, torch.float32) for k, v in tree.items()}
