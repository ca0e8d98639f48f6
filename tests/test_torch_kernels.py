"""The port's plain kernel versions against the JAX package's kernels.

For each of the port's five kernels, the plain PyTorch version (what the
port's wrappers run for CPU tensors, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card) must match the JAX Pallas kernel, run in
interpret mode as the JAX package's own tests run it, and the JAX plain
reference (for the compaction move: the JAX engine's ``_move_pages_fn`` on
its Pallas path).  Shapes and tolerances are those of ``tests/test_kernels.py``
(f32 2e-5, bf16 2e-2, exact for the copy; rtol 1e-6 and the same -1 / +inf
pattern for the MDC key), plus one case at the full-width
head geometry of qwen3-1.7b (D=128, G=2).  Inputs come from numpy with a
seed and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving.engine import _move_pages_fn
from repro_torch.core import policies
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "int32": torch.int32}


def both(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a CPU tensor of the same dtype
    (both round f32 → bf16 to nearest even, so the values are identical)."""
    return (jnp.asarray(a).astype(JNP[dtype]),
            torch.from_numpy(a).to(TORCH[dtype]))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ flash attention

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Kh,D,causal", [
    (1, 128, 128, 4, 4, 64, True), (1, 128, 128, 4, 4, 64, False),
    (2, 256, 256, 8, 2, 64, True), (2, 256, 256, 8, 2, 64, False),
    (1, 200, 200, 4, 1, 32, True), (1, 200, 200, 4, 1, 32, False),
    (1, 64, 192, 2, 2, 128, False),   # cross-shape kv: non-causal only
    (2, 96, 96, 6, 3, 16, True), (2, 96, 96, 6, 3, 16, False),
    (1, 128, 128, 4, 2, 128, True),   # full-width head: D=128, G=2
])
def test_flash_attention_plain_matches_pallas_and_ref(B, Sq, Skv, H, Kh, D,
                                                      causal, dtype):
    rng = np.random.default_rng(42)
    jq, q = both(rng.standard_normal((B, Sq, H, D), np.float32), dtype)
    jk, k = both(rng.standard_normal((B, Skv, Kh, D), np.float32), dtype)
    jv, v = both(rng.standard_normal((B, Skv, Kh, D), np.float32), dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Sq, H, D)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, q_block=64,
                                  kv_block=64)
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(
        f32(got), f32(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
        **TOL[dtype])


def test_flash_attention_bhsd_is_the_transposed_entry():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 4, 40, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 40, 32), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 40, 32), np.float32))
    got = ops.flash_attention_bhsd(q, k, v, causal=True)
    want = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True).transpose(1, 2)
    assert torch.equal(got, want)


def test_flash_attention_reads_strided_views_in_place():
    """Both entries are stride sets over one kernel: a (B, S, H, D) view of
    (B, H, S, D) storage is read through its own strides (the layout the
    kernel gets is the view's, so nothing is copied) and gives the same
    result as a contiguous copy."""
    rng = np.random.default_rng(7)
    B, H, Kh, S, D = 2, 4, 2, 40, 32
    qh, kh, vh = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                  .to(torch.bfloat16)
                  for shape in ((B, H, S, D), (B, Kh, S, D), (B, Kh, S, D)))
    q, k, v = (t.transpose(1, 2) for t in (qh, kh, vh))
    assert not q.is_contiguous()
    assert ops.flash_layout(q, k, v) == [t.stride()[:3] for t in (q, k, v)]
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True)
    assert torch.equal(got, want)
    assert torch.equal(ops.flash_attention_bhsd(qh, kh, vh, causal=True),
                       want.transpose(1, 2))


@pytest.mark.parametrize("bad", ["strided_head_dim", "row_not_16_bytes",
                                 "misaligned_base", "expanded_heads"])
def test_flash_attention_refuses_strides_the_kernel_cannot_read(bad):
    B, S, H, Kh, D = 1, 16, 4, 2, 32
    k = torch.zeros(B, S, Kh, D, dtype=torch.bfloat16)
    if bad == "strided_head_dim":
        q = torch.zeros(B, S, H, 2 * D, dtype=torch.bfloat16)[..., ::2]
    elif bad == "row_not_16_bytes":  # head stride 36 bf16 = 72 bytes
        q = torch.zeros(B, S, H, D + 4, dtype=torch.bfloat16)[..., :D]
    elif bad == "misaligned_base":
        q = torch.zeros(B * S * H * D + 1, dtype=torch.bfloat16)[1:].view(
            B, S, H, D)
    else:
        q = torch.zeros(B, S, 1, D, dtype=torch.bfloat16).expand(B, S, H, D)
    with pytest.raises(ValueError, match="flash_attention"):
        ops.flash_layout(q, k, k)
    with pytest.raises(ValueError, match="flash_attention"):
        ops.flash_attention(q, k, k)


def test_flash_attention_route_follows_dtype_and_head_dim():
    """bf16 at D 64 / 128 goes to the tensor-core route, the rest to the
    CUDA-core route; the CPU path launches nothing on either."""
    assert ops.flash_route(torch.bfloat16, 128) == "wgmma"
    assert ops.flash_route(torch.bfloat16, 64) == "wgmma"
    assert ops.flash_route(torch.bfloat16, 32) == "simt"
    assert ops.flash_route(torch.float32, 128) == "simt"
    before = (dict(ops.launches), dict(ops.flash_routes))
    q = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    ops.flash_attention(q, q, q)
    assert (ops.launches, ops.flash_routes) == before


# ------------------------------------------------------------ paged attention

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Kh,D,T,P", [
    (2, 4, 4, 64, 16, 4),
    (3, 8, 2, 32, 8, 6),      # GQA 4:1
    (1, 4, 1, 128, 32, 3),    # MQA
    (2, 4, 2, 128, 16, 4),    # full-width head: D=128, G=2, page_T=16
])
def test_paged_attention_plain_matches_pallas_and_ref(B, H, Kh, D, T, P,
                                                      dtype):
    rng = np.random.default_rng(3)
    n_pages = B * P + 5
    jq, q = both(rng.standard_normal((B, H, D), np.float32), dtype)
    jkp, kp = both(rng.standard_normal((n_pages, T, Kh, D), np.float32), dtype)
    jvp, vp = both(rng.standard_normal((n_pages, T, Kh, D), np.float32), dtype)
    # disjoint random pages per sequence, as the slab allocator hands out;
    # ragged lengths including exactly one token and a full table
    bt_np = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    lens_np = np.linspace(1, P * T, B).astype(np.int32)
    got = ops.paged_attention(q, kp, vp, torch.from_numpy(bt_np),
                              torch.from_numpy(lens_np))
    assert got.dtype == q.dtype and tuple(got.shape) == (B, H, D)
    args = (jq, jkp, jvp, jnp.asarray(bt_np), jnp.asarray(lens_np))
    np.testing.assert_allclose(f32(got), f32(jops.paged_attention(*args)),
                               **TOL[dtype])
    np.testing.assert_allclose(f32(got), f32(jref.paged_attention_ref(*args)),
                               **TOL[dtype])


def test_paged_attention_clamps_tables_like_the_jax_wrapper():
    """Table entries outside [0, num_pages) are clamped before the read, as
    ``repro.kernels.ops.paged_attention`` does."""
    rng = np.random.default_rng(4)
    B, H, Kh, D, T, P, n_pages = 2, 4, 2, 32, 8, 3, 5
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((n_pages, T, Kh, D), np.float32)
    vp = rng.standard_normal((n_pages, T, Kh, D), np.float32)
    bt = np.array([[0, 9, -3], [4, 2, 77]], np.int32)
    lens = np.array([20, 24], np.int32)
    got = ops.paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp, bt, lens)))
    want = jops.paged_attention(*(jnp.asarray(a) for a in (q, kp, vp, bt, lens)))
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Kh,D,T,P,lens", [
    # zero-length, one token, exactly 8 pages, 8*2 + 1 pages, a full table
    # of P = 20 (not a multiple of 8), and a sequence whose splits 1-7 are
    # empty
    (4, 2, 32, 8, 20, [0, 1, 64, 129, 160, 7]),
    (16, 2, 64, 4, 11, [0, 5, 44]),          # G = 8, P = 11
    (4, 1, 32, 16, 1, [0, 16, 9]),           # P = 1: one split in use
    (4, 2, 128, 16, 9, [0, 129, 144]),       # full-width head: D=128, G=2
])
def test_paged_attention_split_model_matches_pallas_and_ref(H, Kh, D, T, P,
                                                            lens, dtype):
    """``ref.paged_attention_split_ref``, the plain model of the CUDA
    kernel's schedule (page j in split j % 8, the partials combined in split
    order), against the Pallas kernel in interpret mode on every row, and
    against the JAX dense reference on the rows with live tokens: a
    zero-length row is zeros in the kernels and the mean of V in the dense
    softmax over a fully masked row."""
    rng = np.random.default_rng(9)
    B = len(lens)
    n_pages = B * P + 3
    jq, q = both(rng.standard_normal((B, H, D), np.float32), dtype)
    jkp, kp = both(rng.standard_normal((n_pages, T, Kh, D), np.float32), dtype)
    jvp, vp = both(rng.standard_normal((n_pages, T, Kh, D), np.float32), dtype)
    bt_np = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    lens_np = np.asarray(lens, np.int32)
    got = ref.paged_attention_split_ref(q, kp, vp, torch.from_numpy(bt_np),
                                        torch.from_numpy(lens_np))
    assert got.dtype == q.dtype and tuple(got.shape) == (B, H, D)
    args = (jq, jkp, jvp, jnp.asarray(bt_np), jnp.asarray(lens_np))
    np.testing.assert_allclose(f32(got), f32(jops.paged_attention(*args)),
                               **TOL[dtype])
    live = lens_np > 0
    np.testing.assert_allclose(f32(got)[live],
                               f32(jref.paged_attention_ref(*args))[live],
                               **TOL[dtype])
    assert not f32(got)[~live].any()


# ----------------------------------------------------------- segment compact

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("N,E,M", [(32, 256, 16), (7, 100, 7), (64, 8192, 64),
                                   (16, 130, 5)])
def test_segment_compact_plain_matches_pallas_exactly(N, E, M, dtype):
    rng = np.random.default_rng(5)
    if dtype == "int32":
        pool_np = rng.integers(0, 1000, (N, E), dtype=np.int32)
    else:
        pool_np = rng.standard_normal((N, E), np.float32)
    jpool, pool = both(pool_np, dtype)
    src_np = rng.integers(0, N, M).astype(np.int32)
    got = ops.segment_compact(pool, torch.from_numpy(src_np))
    assert got.dtype == pool.dtype
    pallas = jops.segment_compact(jpool, jnp.asarray(src_np), tile=1024)
    want = jref.segment_compact_ref(jpool, jnp.asarray(src_np))
    if dtype == "bfloat16":  # compare the bits
        got_bits = got.view(torch.int16).numpy()
        np.testing.assert_array_equal(got_bits, np.asarray(pallas).view(np.int16))
        np.testing.assert_array_equal(got_bits, np.asarray(want).view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_take_the_plain_version_for_cpu_tensors_only():
    """CPU tensors go to the plain version and launch nothing; no CUDA
    tensor ever reaches it (a mix of devices is refused)."""
    before = dict(ops.launches)
    pool = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    src = torch.tensor([3, 0], dtype=torch.int32)
    assert torch.equal(ops.segment_compact(pool, src), pool[[3, 0]])
    assert ops.launches == before
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.segment_compact(pool, src.to("meta"))


# -------------------------------------------------------------- segment move

def _plan(rng, n_pages, M, overlap):
    """M moves between distinct pages; with ``overlap`` the first half of
    the destinations are other moves' sources (a survivor placed into a page
    the same plan frees)."""
    perm = rng.permutation(n_pages)
    src = perm[:M]
    dst = perm[M:2 * M].copy()
    if overlap:
        dst[:M // 2] = np.roll(src, 1)[:M // 2]
    return src, dst


def _bits(x) -> np.ndarray:
    a = x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) and \
        x.dtype == torch.bfloat16 else np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_segment_move_matches_jax_move_pages_exactly(dtype, overlap):
    """``ops.segment_move`` on CPU tensors (its plain version) against the JAX
    engine's move on its Pallas path (segment_compact in interpret mode):
    the same pools bit for bit, for a disjoint and an overlapping plan."""
    rng = np.random.default_rng(6)
    shape = (2, 12, 4, 2, 8)  # (L, n_pages, T, Kh, hd)
    if dtype == "int32":
        k_np, v_np = (rng.integers(0, 1000, shape, dtype=np.int32)
                      for _ in range(2))
    else:
        k_np, v_np = (rng.standard_normal(shape, np.float32) for _ in range(2))
    # the move is in place: the port gets buffers of its own (from_numpy
    # shares the array's memory, and a JAX array on the CPU may too)
    (jk, _), (jv, _) = both(k_np, dtype), both(v_np, dtype)
    k, v = (both(a.copy(), dtype)[1] for a in (k_np, v_np))
    old_k = k.clone()
    src, dst = _plan(rng, shape[1], 4, overlap)
    assert bool(np.isin(dst, src).any()) == overlap
    before = dict(ops.move_plans)
    launched = dict(ops.launches)
    ops.segment_move((k, v), src, dst)
    form = "staged" if overlap else "direct"
    assert ops.move_plans[form] == before[form] + 1
    assert ops.launches == launched  # CPU tensors: the plain version
    wk, wv = _move_pages_fn(jk, jv, jnp.asarray(src, jnp.int32),
                            jnp.asarray(dst, jnp.int32), use_pallas=True)
    np.testing.assert_array_equal(_bits(k), _bits(wk))
    np.testing.assert_array_equal(_bits(v), _bits(wv))
    if overlap:  # page dst[0] = src[-1] is overwritten by move 0, yet move
        # M - 1 carried its old content
        assert dst[0] == src[-1]
        np.testing.assert_array_equal(_bits(k[:, dst[0]]), _bits(old_k[:, src[0]]))
        np.testing.assert_array_equal(_bits(k[:, dst[-1]]),
                                      _bits(old_k[:, src[-1]]))


def test_segment_move_refuses_bad_plans():
    pools = (torch.zeros(2, 6, 8), torch.zeros(2, 6, 8))
    with pytest.raises(ValueError, match="outside"):
        ops.segment_move(pools, [0, 6], [1, 2])
    with pytest.raises(ValueError, match="distinct"):
        ops.segment_move(pools, [0, 1], [2, 2])
    with pytest.raises(ValueError, match="one shape"):
        ops.segment_move((pools[0], torch.zeros(2, 5, 8)), [0], [1])
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.segment_move((pools[0], pools[1].to("meta")), [0], [1])


# -------------------------------------------------------------- mdc priority

def _same_key(got, want):
    """Identical -1 / +inf pattern; finite keys within rtol 1e-6."""
    got, want = f32(got), f32(want)
    np.testing.assert_array_equal(got == -1, want == -1)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6)


@pytest.mark.parametrize("N,S", [(100, 512), (1024, 512), (4097, 64), (3, 32)])
def test_mdc_priority_plain_matches_pallas_and_ref(N, S):
    rng = np.random.default_rng(N)
    live = rng.integers(0, S + 1, N)  # all three branches: empty, full, rest
    up2 = rng.uniform(0, 1e6, N)
    u_now = 1.5e6
    got = ops.mdc_priority(torch.from_numpy(live), torch.from_numpy(up2),
                           u_now, S=S)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N,)
    jl, ju = jnp.asarray(live), jnp.asarray(up2)
    _same_key(got, jops.mdc_priority(jl, ju, u_now, S=S))
    _same_key(got, jref.mdc_priority_ref(jl, ju, u_now, S))


def test_mdc_select_victims_matches_jax_and_numpy():
    """The inputs of ``test_mdc_select_victims_orders_like_simulator``."""
    rng = np.random.default_rng(1)
    N, S, k = 256, 128, 8
    live = rng.integers(1, S, N)
    up2 = rng.uniform(0, 1e5, N)
    u_now = 2e5
    ids, valid = ops.mdc_select_victims(torch.from_numpy(live),
                                        torch.from_numpy(up2), u_now, S=S, k=k)
    jids, jvalid = jops.mdc_select_victims(jnp.asarray(live), jnp.asarray(up2),
                                           u_now, S=S, k=k)
    want = policies.select_victims("mdc", k, live=live, S=S, up2=up2,
                                   seal_time=np.zeros(N), u_now=u_now,
                                   eligible=np.ones(N, bool))
    assert valid.all() and np.asarray(jvalid).all()
    np.testing.assert_array_equal(np.sort(ids.numpy()), np.sort(np.asarray(jids)))
    np.testing.assert_array_equal(np.sort(ids.numpy()), np.sort(want))


def test_mdc_select_victims_marks_uncleanable_entries_invalid():
    """Fewer cleanable segments than k: the rest come back invalid, as from
    the JAX entry (full segments key +inf)."""
    live = np.array([4, 0, 4, 2, 4], np.int64)
    up2 = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    ids, valid = ops.mdc_select_victims(torch.from_numpy(live),
                                        torch.from_numpy(up2), 10.0, S=4, k=4)
    jids, jvalid = jops.mdc_select_victims(jnp.asarray(live), jnp.asarray(up2),
                                           10.0, S=4, k=4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.tolist() == [True, True, False, False]
    assert ids[:2].tolist() == [1, 3] == np.asarray(jids)[:2].tolist()


def test_mdc_priority_takes_the_plain_version_for_cpu_tensors():
    before = dict(ops.launches)
    live = torch.tensor([0, 2, 4])
    up2 = torch.tensor([1.0, 2.0, 3.0])
    got = ops.mdc_priority(live, up2, 9.0, S=4)
    assert torch.equal(got, ops.ref.mdc_priority_ref(live, up2, 9.0, 4))
    assert ops.launches == before
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ops.mdc_priority(live, up2.to("meta"), 9.0, S=4)
