"""The port's tensor-parallel serving against the JAX package and against
the port's own one-device engine, with ranks on the CPU (``gloo``).

The JAX sharded *engine* does not run on this JAX (its mesh prefill raises
``ShardingTypeError`` in ``models/attention.py``; ROADMAP §3), so the
port's sharded engine is held to the contract of
``tests/test_sharded_serving.py``: decoded tokens, Wamp and compaction
counts equal to the one-device engine's, here the port's (bitwise: tokens
and ``metrics()``) and the JAX package's (tokens and counters).  The JAX
sharded kernel wrappers do run, in a subprocess with two host devices, and
the port's wrappers are held to them.

Each rank is a process of its own (``launch.mesh.spawn_ranks``) running
the functions of ``tests/_torch_tp.py``; the ranks of one world size run
all their cases in one spawn (module fixtures), every rank on one torch
thread.  Parameters and pools are float32.
"""

import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp as tp
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jax_sharding
from repro.models import Model as JaxModel
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.logstructure import JournalLog
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tp_mesh
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.serving import engine as port_engine

ROOT = Path(__file__).resolve().parents[1]
F32 = torch.float32
COUNTERS = ("blocks_written", "blocks_moved", "compactions", "wamp")
# a spawn that hangs (a collective some rank never reaches) fails here
# instead of holding the whole run: the spawns take seconds
SPAWN_TIMEOUT_S = 300


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg_name):
    """(JAX model, JAX f32 params, port config, port f32 params on the
    CPU), one PRNGKey."""
    jcfg = jax_get_config("qwen3-1.7b")
    jm = JaxModel(jcfg.tp_smoke() if cfg_name == "tp" else jcfg.smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    cfg = get_config("qwen3-1.7b")
    cfg = cfg.tp_smoke() if cfg_name == "tp" else cfg.smoke()
    return jm, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def tp_pair():
    return _pair("tp")


@pytest.fixture(scope="module")
def smoke_pair():
    return _pair("smoke")


# ---------------------------------------------------------------- streams
# each the geometry and requests of the JAX test it mirrors

def _serve_kw(n_slabs=7):
    """test_sharded_serving.py::_serve: a tight pool with one open stream,
    so compaction fires."""
    return dict(n_slabs=n_slabs, blocks_per_slab=2, page_T=8, max_batch=3,
                max_seq=96, policy="mdc", streams=1, compact_trigger=2,
                compact_batch=3, max_decode_chunk=8)


def _serve_reqs(vocab):
    rng = np.random.default_rng(3)
    return [(rng.integers(1, vocab, size=plen), n_new) for plen, n_new in
            zip([5, 17, 9, 24, 3, 12], [6, 10, 4, 8, 12, 5])]


STREAMS_KW = dict(n_slabs=10, blocks_per_slab=2, page_T=8, max_batch=2,
                  max_seq=64, policy="mdc", compact_trigger=2,
                  compact_batch=3)   # test_streams.py:277


def _streams_reqs(vocab):
    return [(np.arange(1, 18) % vocab, 8)]


CHUNKED_KW = dict(n_slabs=8, blocks_per_slab=4, page_T=8, max_batch=3,
                  max_seq=96, policy="mdc", compact_trigger=1,
                  compact_batch=2, prefill_chunk=16, preemption=True)


def _chunked_reqs(vocab, n=6, seed=3):   # test_chunked_prefill.py:58
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(4, 60))),
             int(rng.integers(4, 25))) for _ in range(n)]


ASYNC_KW = dict(n_slabs=7, blocks_per_slab=2, page_T=8, max_batch=3,
                max_seq=96, policy="mdc", compact_trigger=2, compact_batch=2,
                audit_every=3)   # test_async_compaction.py:221


def _async_reqs(vocab, seed=1):
    rng = np.random.default_rng(seed)
    lens = [5, 17, 9, 24, 3, 12, 20, 7, 15, 11]
    news = [16, 20, 14, 18, 22, 15, 19, 21, 13, 17]
    return [(rng.integers(1, vocab, size=n), m) for n, m in zip(lens, news)]


PREEMPT_KW = dict(n_slabs=8, blocks_per_slab=2, page_T=8, max_batch=3,
                  max_seq=96, policy="mdc", compact_trigger=1,
                  compact_batch=2, max_decode_chunk=32, preemption=True)


def _preempt_reqs(vocab, n=8, seed=0):   # test_preemption.py:49
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(4, 40))),
             int(rng.integers(4, 30))) for _ in range(n)]


RECOVERY_KW = dict(n_slabs=8, blocks_per_slab=2, page_T=8, max_batch=2,
                   max_seq=96, policy="mdc", compact_trigger=2,
                   compact_batch=2, stop_token=97, preemption=True)


def _recovery_reqs(vocab, n=3, seed=5):   # test_crash_recovery.py:66
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(5, 20))),
             int(rng.integers(4, 7))) for _ in range(n)]


def _case(pair, reqs, kw, **extra):
    _, _, cfg, params = pair
    return dict(cfg=cfg, params=params, requests=reqs(cfg.vocab_size),
                engine_kw=dict(kw, pool_dtype=F32), **extra)


def _unsharded(pair, reqs, kw, **override):
    """The port's one-device engine on the same stream (CPU)."""
    _, _, cfg, params = pair
    return tp.serve_stream(Model(cfg, params), reqs(cfg.vocab_size), "cpu",
                           **dict(kw, pool_dtype=F32, **override))


@pytest.fixture(scope="module")
def wrapper_inputs():
    return tp.wrapper_case(seed=0)


@pytest.fixture(scope="module")
def mesh2(tp_pair, smoke_pair, wrapper_inputs, tmp_path_factory):
    """Every mesh-2 case, on two gloo ranks in one spawn: per rank
    {case: result}."""
    root = tmp_path_factory.mktemp("tp_journal")
    cases = {
        "wrappers": dict(kind="wrappers", inputs=wrapper_inputs, q_offset=8),
        "serve": _case(tp_pair, _serve_reqs, _serve_kw()),
        "streams": _case(smoke_pair, _streams_reqs,
                         dict(STREAMS_KW, streams=4)),
        "chunked": _case(tp_pair, _chunked_reqs, CHUNKED_KW),
        "async": _case(smoke_pair, _async_reqs,
                       dict(ASYNC_KW, async_compaction=True, clean_budget=4)),
        "preemption": _case(tp_pair, _preempt_reqs, PREEMPT_KW),
        "recovery": _case(tp_pair, _recovery_reqs, RECOVERY_KW,
                          recovery=(str(root / "j"), 3)),
        "snapshots": _case(tp_pair, _recovery_reqs,
                           dict(RECOVERY_KW, snapshot_every=2),
                           recovery=(str(root / "s"), 5)),
    }
    return tp_mesh.spawn_ranks(tp.run_cases, 2, cases, backend="gloo",
                               device="cpu", timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def mesh8(tp_pair, smoke_pair):
    """The _serve stream on eight gloo ranks, and the default smoke model
    (2 kv heads, which 8 ranks do not divide) on the same stream."""
    cases = {"serve": _case(tp_pair, _serve_reqs, _serve_kw()),
             "replicated": _case(smoke_pair, _serve_reqs, _serve_kw(9))}
    return tp_mesh.spawn_ranks(tp.run_cases, 8, cases, backend="gloo",
                               device="cpu", timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def runs(mesh2, mesh8):
    return {2: mesh2, 8: mesh8}


# ------------------------------------------------------------- wrappers

_JAX_WRAPPERS = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from repro import kernels
    from repro.launch.mesh import make_serving_mesh
    f = dict(np.load(sys.argv[1]))
    mesh = make_serving_mesh(2)
    assert len(jax.devices()) == 2
    args_p = (f["q"], f["kp"], f["vp"], f["bt"], f["lens"])
    args_f = (f["qf"], f["kf"], f["vf"])
    np.savez(sys.argv[2],
             paged_sharded=np.asarray(kernels.paged_attention(*args_p,
                                                              mesh=mesh)),
             flash_sharded=np.asarray(kernels.flash_attention(
                 *args_f, causal=True, mesh=mesh)),
             paged=np.asarray(kernels.paged_attention(*args_p)),
             flash=np.asarray(kernels.flash_attention(*args_f, causal=True)))
""")


@pytest.fixture(scope="module")
def jax_wrappers(wrapper_inputs, tmp_path_factory):
    """JAX's ``paged_attention_sharded`` / ``flash_attention_sharded`` (its
    ``kernels`` entry points with a 2-device mesh) and its unsharded Pallas
    kernels, in interpret mode, in a subprocess with two host devices."""
    d = tmp_path_factory.mktemp("jax_wrappers")
    np.savez(d / "in.npz", **wrapper_inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _JAX_WRAPPERS,
                          str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("kind", ["paged", "flash"])
def test_sharded_wrappers_match_jax_sharded_wrappers(mesh2, jax_wrappers,
                                                     kind):
    """Each rank's heads equal JAX's sharded wrapper's same heads (f32,
    2e-5), and the gathered heads its whole output."""
    want = jax_wrappers[f"{kind}_sharded"]
    axis = 1 if kind == "paged" else 2
    for rank, r in enumerate(mesh2):
        got = r["wrappers"][kind]
        np.testing.assert_allclose(
            got, tp.local_heads(torch.from_numpy(want), axis, rank, 2).numpy(),
            rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["wrappers"][f"{kind}_gathered"], want,
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["paged", "flash"])
def test_sharded_wrappers_match_jax_unsharded_kernels(mesh2, jax_wrappers,
                                                      kind):
    """The gathered heads against JAX's unsharded Pallas kernel (interpret
    mode), which the JAX sharded wrapper equals bitwise."""
    np.testing.assert_array_equal(jax_wrappers[f"{kind}_sharded"],
                                  jax_wrappers[kind])
    for r in mesh2:
        np.testing.assert_allclose(r["wrappers"][f"{kind}_gathered"],
                                   jax_wrappers[kind], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["paged", "flash", "flash_offset"])
def test_gathered_heads_are_the_unsharded_call_bitwise(mesh2, wrapper_inputs,
                                                       kind):
    """The port's wrappers on each rank's heads, gathered, are bit for bit
    the port's unsharded call (heads are independent); the offset case
    runs the rows from 8 on with ``q_offset`` 8."""
    t = {k: torch.from_numpy(v) for k, v in wrapper_inputs.items()}
    if kind == "paged":
        want = ops.paged_attention(t["q"], t["kp"], t["vp"], t["bt"],
                                   t["lens"])
    else:
        off = 8 if kind == "flash_offset" else 0
        want = ops.flash_attention(t["qf"][:, off:], t["kf"], t["vf"],
                                   causal=True, q_offset=off)
    for r in mesh2:
        np.testing.assert_array_equal(r["wrappers"][f"{kind}_gathered"],
                                      want.numpy())


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("n", [2, 8])
def test_ranks_agree(runs, n):
    """Every rank ends with the same tokens and the same ``metrics()``."""
    first = runs[n][0]
    for r in runs[n][1:]:
        for name in first:
            if name == "wrappers":
                continue
            assert r[name]["tokens"] == first[name]["tokens"], name
            assert r[name]["metrics"] == first[name]["metrics"], name


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_engine_equals_port_unsharded_bitwise(runs, tp_pair, n):
    """THE equivalence at 2 and 8 ranks: the _serve stream's tokens and
    ``metrics()`` are the one-device engine's, with >= 1 compaction, and
    the pools really shard: each rank holds Kh / n kv heads of every
    global page, and only its H / n and Kh / n heads of wq / wk."""
    base = _unsharded(tp_pair, _serve_reqs, _serve_kw())
    cfg = tp_pair[2]
    for r in runs[n]:
        got = r["serve"]
        assert got["tokens"] == base["tokens"]
        assert got["metrics"] == base["metrics"]
        assert base["metrics"]["compactions"] >= 1
        assert got["pool_sharded"]
        assert got["pool_shape"][3] == cfg.n_kv_heads // n
        assert got["pool_shape"][:3] == base["pool_shape"][:3]
        assert got["model_heads"] == (cfg.n_heads // n, cfg.n_kv_heads // n)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_engine_equals_jax_unsharded(runs, tp_pair, n):
    """Tokens and pool counters equal the JAX one-device engine's on the
    same stream (its plain path, f32 pool)."""
    jm, jp, cfg, _ = tp_pair
    eng = JaxEngine(jm, params=jp, use_pallas=False, pool_dtype=jnp.float32,
                    **_serve_kw())
    reqs = _serve_reqs(cfg.vocab_size)
    rids = [eng.submit(p, n_new) for p, n_new in reqs]
    eng.run_to_completion()
    want = [eng.finished[r] for r in rids]
    mj = eng.metrics()
    assert mj["compactions"] >= 1
    for r in runs[n]:
        assert r["serve"]["tokens"] == want
        assert {k: r["serve"]["metrics"][k] for k in COUNTERS} == \
            {k: mj[k] for k in COUNTERS}


def test_indivisible_kv_heads_replicate(mesh8, smoke_pair):
    """The default smoke model's 2 kv heads cannot split 8 ways: the pools
    replicate on every rank and the engine serves the one-device engine's
    tokens and metrics (test_sharded_serving.py's fallback)."""
    base = _unsharded(smoke_pair, _serve_reqs, _serve_kw(9))
    for r in mesh8:
        got = r["replicated"]
        assert not got["pool_sharded"]
        assert got["pool_shape"] == base["pool_shape"]
        assert got["model_heads"] == base["model_heads"]
        assert got["tokens"] == base["tokens"]
        assert got["metrics"] == base["metrics"]


def test_streams_under_mesh2(mesh2, smoke_pair):
    """test_streams.py:277: four death streams under a 2-rank mesh give the
    one-stream unsharded engine's tokens; the metrics are those of the
    unsharded engine with four streams."""
    one = _unsharded(smoke_pair, _streams_reqs, dict(STREAMS_KW, streams=1))
    four = _unsharded(smoke_pair, _streams_reqs, dict(STREAMS_KW, streams=4))
    for r in mesh2:
        got = r["streams"]
        assert got["pool_sharded"]
        assert got["tokens"] == one["tokens"]
        assert got["metrics"] == four["metrics"]
        assert got["metrics"]["streams"] == 4
        assert sum(got["metrics"]["stream_writes"]) == \
            got["metrics"]["blocks_written"]


def test_chunked_prefill_under_mesh2(mesh2, tp_pair):
    """test_chunked_prefill.py:306: the fused chunk + decode dispatch under
    a 2-rank mesh equals the unsharded chunked engine."""
    base = _unsharded(tp_pair, _chunked_reqs, CHUNKED_KW)
    assert base["metrics"]["prefill_chunks_dispatched"] >= 1
    for r in mesh2:
        got = r["chunked"]
        assert got["pool_sharded"]
        assert got["tokens"] == base["tokens"]
        assert got["metrics"] == base["metrics"]


def test_async_compaction_under_mesh2(mesh2, smoke_pair):
    """test_async_compaction.py:251: async compaction under a 2-rank mesh
    (audit, with the ranks' agreement check, every 3 dispatches) gives the
    synchronous unsharded engine's tokens and the async unsharded
    engine's metrics."""
    sync = _unsharded(smoke_pair, _async_reqs, ASYNC_KW)
    asyn = _unsharded(smoke_pair, _async_reqs,
                      dict(ASYNC_KW, async_compaction=True, clean_budget=4))
    assert asyn["metrics"]["gc_planned"] > 0
    for r in mesh2:
        got = r["async"]
        assert got["pool_sharded"]
        assert got["tokens"] == sync["tokens"]
        assert got["metrics"] == asyn["metrics"]
        assert got["metrics"]["gc_planned"] == got["metrics"]["gc_committed"]


def test_preemption_under_mesh2(mesh2, tp_pair):
    """test_preemption.py:197's stream: preemption is host-side and
    mesh-oblivious; both engines share the port's resume rule."""
    base = _unsharded(tp_pair, _preempt_reqs, PREEMPT_KW)
    assert base["metrics"]["preemptions"] >= 1
    for r in mesh2:
        got = r["preemption"]
        assert got["pool_sharded"]
        assert got["tokens"] == base["tokens"]
        assert got["metrics"] == base["metrics"]


def test_recovery_under_mesh2(mesh2, tp_pair):
    """test_crash_recovery.py:204: a 2-rank engine killed after 3
    dispatches and recovered (rank 0 reads the journal, every rank
    replays) serves the unkilled sharded run's tokens, which are the
    unsharded engine's; both ranks report the same recovery."""
    base = _unsharded(tp_pair, _recovery_reqs, RECOVERY_KW)
    reports = []
    for r in mesh2:
        got = r["recovery"]
        assert got["pool_sharded"]
        assert got["report"]["sequences_resumed"] + \
            got["report"]["requests_requeued"] >= 1
        assert got["tokens"] == got["unkilled"] == base["tokens"]
        reports.append((got["report"], got["metrics"]))
    assert reports[0] == reports[1]


def test_snapshots_under_mesh2(mesh2, tp_pair):
    """The recovery stream with a snapshot every 2 dispatches, killed after
    5: rank 0 saves the snapshots and the other rank keeps the journal's
    accounting without writing, so both report the same journal records,
    bytes and Wamp, and recover through the snapshot to the unkilled
    tokens."""
    base = _unsharded(tp_pair, _recovery_reqs,
                      dict(RECOVERY_KW, snapshot_every=2))
    got = [r["snapshots"] for r in mesh2]
    assert got[0]["report"]["snapshot_id"] >= 1
    assert got[0]["report"] == got[1]["report"]
    assert got[0]["metrics"] == got[1]["metrics"]
    assert got[0]["metrics"]["journal_records"] > 0
    for g in got:
        assert g["tokens"] == g["unkilled"] == base["tokens"]


# ----------------------------------------------------------- the pieces

SPEC_CASES = [
    ((2, 15, 8, 8, 32), ("layers", None, None, "kv", None), {"model": 2}),
    ((2, 15, 8, 2, 32), ("layers", None, None, "kv", None), {"model": 8}),
    ((2, 128, 16, 32), ("layers", "embed", "heads", "head_dim"),
     {"model": 8}),
    ((2, 128, 4, 32), ("layers", "embed", "heads", "head_dim"),
     {"model": 8}),
    ((2, 16, 32, 128), ("layers", "heads", "head_dim", "embed"),
     {"data": 2, "model": 4}),
    ((0, 8), ("kv", "heads"), {"model": 2}),
    ((8, 6), ("kv", "heads"), {"model": 2}),
]


@pytest.mark.parametrize("shape,axes,sizes", SPEC_CASES,
                         ids=[f"{s}-{list(m.values())}" for s, _, m in
                              SPEC_CASES])
def test_resolve_spec_matches_jax(shape, axes, sizes):
    """The port's resolver gives JAX's spec under SERVING_RULES, falling
    back to replication where the mesh does not divide a dim; a 2-D
    {data, model} mesh shards over "model" alone; ``spec_shards`` agrees
    too.  JAX's resolver reads only the mesh's axis names and sizes."""
    mesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    want = jax_sharding.resolve_spec(shape, axes, mesh,
                                     jax_sharding.SERVING_RULES)
    got = sharding.resolve_spec(shape, axes, sizes)
    assert got == tuple(want)
    assert sharding.spec_shards(got, sizes) == \
        jax_sharding.spec_shards(want, mesh)


def test_shard_serving_params_cuts_only_the_head_projections(tp_pair):
    """Rank r of 4 keeps heads [r*H/4, (r+1)*H/4) of wq and kv heads
    [r*Kh/4, ...) of wk / wv; everything else is the same tensor."""
    _, _, cfg, params = tp_pair
    for r in range(4):
        got = port_engine.shard_serving_params(params, {"model": 4},
                                               {"model": r})
        attn, whole = got["blocks"]["attn"], params["blocks"]["attn"]
        h, kh = cfg.n_heads // 4, cfg.n_kv_heads // 4
        assert torch.equal(attn["wq"], whole["wq"][:, :, r * h:(r + 1) * h])
        for k in ("wk", "wv"):
            assert torch.equal(attn[k], whole[k][:, :, r * kh:(r + 1) * kh])
        assert attn["wo"] is whole["wo"]
        assert got["embed"] is params["embed"]


def test_journal_mirror_keeps_the_writers_accounting(tmp_path):
    """A mirror appends and compacts as its writer does (sequence numbers,
    segments, byte counts, Wamp) and writes no file."""
    j = JournalLog(tmp_path / "j", seg_bytes=256)
    for i in range(3):
        j.append_record({"t": "sub", "rid": i})
    m = j.mirror()
    assert isinstance(m, JournalLog) and not m.persist
    for i in range(40):
        rec = {"t": "emit", "r": [i], "k": [[i] * (i % 7)]}
        assert j.append_record(rec) == m.append_record(rec)
        if i % 13 == 12:
            assert j.compact(j.next_seq - 2) == m.compact(m.next_seq - 2)
    files = sorted(os.listdir(tmp_path / "j"))
    j.close()
    m.close()
    m.check_tail()
    assert m.next_seq == j.next_seq and m._index == j._index
    st_j, st_m = j.core.stats, m.core.stats
    assert (st_j.user_bytes, st_j.wamp()) == (st_m.user_bytes, st_m.wamp())
    assert sorted(os.listdir(tmp_path / "j")) == files
    with pytest.raises(RuntimeError):
        m.records()


def test_spawn_ranks_raises_when_a_rank_fails():
    assert tp_mesh.spawn_ranks(tp.fail_on_rank, 2, -1, backend="gloo",
                               device="cpu",
                               timeout_s=SPAWN_TIMEOUT_S) == [0, 1]
    # the first rank to end with an error is reported: rank 1, or rank 0
    # whose peer went away
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        tp_mesh.spawn_ranks(tp.fail_on_rank, 2, 1, backend="gloo",
                            device="cpu", timeout_s=SPAWN_TIMEOUT_S)


def test_spawn_ranks_kills_ranks_past_its_timeout():
    """A rank that waits at a barrier no other rank reaches is killed."""
    with pytest.raises(TimeoutError):
        tp_mesh.spawn_ranks(tp.hang_on_rank, 2, 1, backend="gloo",
                            device="cpu", timeout_s=5)


def test_nccl_wants_a_card_per_rank():
    with pytest.raises(ValueError, match="one rank per card"):
        tp_mesh.spawn_ranks(tp.fail_on_rank, 2, -1, backend="nccl",
                            device="cpu")


def test_cli_mesh2_equals_serve_run_without_a_mesh(monkeypatch, capfd):
    """``python -m repro_torch.launch.serve --mesh 2 --dist-backend gloo
    --device cpu`` against ``serve_run`` without a mesh on the same smoke
    model: the same rows (tokens, digest, counters) for both policies, and
    rank 0 alone prints them."""
    argv = ["serve", "--mesh", "2", "--dist-backend", "gloo", "--device",
            "cpu", "--requests", "10", "--policies", "mdc", "greedy"]
    monkeypatch.setattr(sys, "argv", argv)
    rows = serve.main()
    printed = capfd.readouterr().out
    model = Model(get_config("qwen3-1.7b").smoke(), device="cpu", seed=0)
    keys = ("tokens", "finished_digest", "dispatches", "blocks_written",
            "blocks_moved", "compactions", "wamp", "policy")
    for row in rows:
        want = serve.serve_run(requests=10, policy=row["policy"],
                               model=model, device="cpu", verbose=False)
        assert {k: row[k] for k in keys} == {k: want[k] for k in keys}
        assert row["engine_metrics"] == want["engine_metrics"]
    assert printed.count("[serve] mdc ") == 1
    assert printed.count("[serve] greedy ") == 1


def test_cli_refuses_the_open_loop_under_a_mesh(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--mesh", "2", "--device",
                                      "cpu", "--arrival-rate", "2"])
    with pytest.raises(SystemExit):
        serve.main()
