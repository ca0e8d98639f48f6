"""The port's serving CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``).

* ``serve_run`` — the closed loop at smoke width, f32 parameters carried
  across by ``bridge.params_from_jax`` (the pools bf16, as the CLI runs
  them): equal tokens, ``finished_digest``, Wamp, compactions and
  dispatches per policy;
* ``_open_loop`` — on a deterministic clock (each read advances 1 ms, the
  idle sleep a no-op) both drivers give the same dispatches, latency
  percentiles and tokens, shed retries included; every request finishes,
  TTFT is never below its queue wait, and at an arrival rate high enough
  that every request arrives before the first step the tokens are the
  closed loop's;
* ``main()`` — runs with ``--device cpu`` through a patched ``sys.argv``
  and writes its trace, metrics and calibration outputs.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve
import repro_torch.launch.serve as serve
from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving import PagedServingEngine
from test_obs import Tick

ROW_KEYS = ("tokens", "finished_digest", "wamp", "compactions", "dispatches",
            "blocks_moved", "blocks_written")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke model's operations are tiny: one intra-op thread runs them
    faster than many, and keeps test files that run side by side in
    parallel workers from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX f32 params, port model on the CPU), one PRNGKey."""
    jm = JaxModel(jax_get_config("qwen3-1.7b").smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    model = Model(get_config("qwen3-1.7b").smoke(),
                  params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, model


@pytest.mark.parametrize("policy", ["mdc", "greedy"])
def test_serve_run_matches_jax_serve_run(models, policy):
    """10 requests of serve_run's mix through its 9-slab pool: one
    compaction."""
    jm, jp, model = models
    want = jax_serve.serve_run(requests=10, policy=policy, params=jp,
                               model=jm, use_pallas=False, verbose=False)
    got = serve.serve_run(requests=10, policy=policy, model=model,
                          device="cpu", verbose=False)
    assert {k: got[k] for k in ROW_KEYS} == {k: want[k] for k in ROW_KEYS}
    assert got["compactions"] >= 1
    assert set(got) == set(want)


def _requests(rng, n=10, vocab=512):
    """serve_run's request mix."""
    out = []
    for _ in range(n):
        plen = int(rng.integers(4, 40))
        nnew = int(rng.choice([4, 8, 12, 24, 48], p=[.3, .25, .2, .15, .1]))
        out.append((rng.integers(1, vocab, size=plen), nnew))
    return out


ENGINE_KW = dict(n_slabs=9, blocks_per_slab=4, page_T=8, max_batch=4,
                 max_seq=256, compact_trigger=2, compact_batch=3)


def _open_loop(models, side, rate, **kw):
    """One open-loop drive on a fresh engine with a deterministic clock;
    returns (dispatches, latency row, finished tokens, engine, requests)."""
    jm, jp, model = models
    rng = np.random.default_rng(0)
    reqs = _requests(rng)
    if side == "jax":
        eng = JaxEngine(jm, params=jp, use_pallas=False, clock=Tick(),
                        **{**ENGINE_KW, **kw})
        d, lat = jax_serve._open_loop(eng, reqs, rate, rng)
    else:
        eng = PagedServingEngine(model, device="cpu", clock=Tick(),
                                 **{**ENGINE_KW, **kw})
        d, lat = serve._open_loop(eng, reqs, rate, rng)
    eng.pool.check_invariants()
    return d, lat, sorted(eng.finished.items()), eng, reqs


# rate 20/s: arrivals spread over the run; 200/s into 5 slabs with a
# queue depth of 1: admission stalls and submissions are shed and retried
OPEN_LOOPS = {"spread": (20.0, {}),
              "shed": (200.0, dict(n_slabs=5, shed_queue_depth=1))}


@pytest.mark.parametrize("case", sorted(OPEN_LOOPS))
def test_open_loop_matches_jax_open_loop(models, case, monkeypatch):
    monkeypatch.setattr(serve.time, "sleep", lambda s: None)
    rate, kw = OPEN_LOOPS[case]
    want = _open_loop(models, "jax", rate, **kw)
    got = _open_loop(models, "port", rate, **kw)
    assert got[:3] == want[:3]
    d, lat, finished, eng, reqs = got
    assert [len(t) for _, t in finished] == [n for _, n in reqs]
    assert lat["ttft_p50_ms"] >= lat["queue_ms_p50"] >= 0.0
    assert lat["ttft_p99_ms"] >= lat["queue_ms_p99"]
    assert lat["tpot_p99_ms"] >= lat["tpot_p50_ms"] > 0.0
    if case == "shed":
        assert lat["shed_retries"] == eng.shed_count > 0
        assert eng.metrics()["shed_count"] == lat["shed_retries"]
    else:
        assert lat["shed_retries"] == 0


def test_open_loop_at_a_burst_gives_the_closed_loop_tokens(models,
                                                          monkeypatch):
    """Every request arrives before the first step: the submission order
    and the schedule are the closed loop's."""
    monkeypatch.setattr(serve.time, "sleep", lambda s: None)
    d, lat, finished, eng, reqs = _open_loop(models, "port", 1e9)
    closed = PagedServingEngine(models[2], device="cpu", **ENGINE_KW)
    rids = [closed.submit(p, n) for p, n in reqs]
    steps = 0
    while closed.has_work():
        closed.step()
        steps += 1
    assert finished == [(r, closed.finished[r]) for r in rids]
    assert d == steps
    assert eng.metrics() == closed.metrics()


def test_serve_run_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_run(requests=1, verbose=False)


def test_main_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--requests", "4",
        "--policies", "mdc", "greedy", "--arrival-rate", "50",
        "--trace", str(tmp_path / "trace.json"), "--phase-log",
        "--metrics-every", "2", "--calibration"])
    rows = serve.main()
    out = capsys.readouterr().out
    assert [r["policy"] for r in rows] == ["mdc", "greedy"]
    for r in rows:
        p = r["policy"]
        assert r["tokens"] > 0 and r["ttft_p99_ms"] >= r["ttft_p50_ms"]
        assert r["phase_report"]["dispatches"] > 0
        assert r["calibration"]["deaths"] > 0
        doc = json.loads((tmp_path / f"trace.json.{p}").read_text())
        assert doc["traceEvents"]
        metrics = (tmp_path / f"serve_metrics_{p}.jsonl").read_text()
        assert len(metrics.splitlines()) >= 1
        assert f"[serve] {p}" in out
    assert "death calibration" in out and "lowest block-move overhead" in out


def test_example_runs_on_the_cpu(monkeypatch, capsys):
    """``examples/serve_paged_torch.py --device cpu``: the policy comparison
    and the two-request prefix-cache demo."""
    import runpy
    from pathlib import Path
    example = Path(__file__).resolve().parents[1] / "examples" \
        / "serve_paged_torch.py"
    monkeypatch.setattr(sys, "argv", [str(example), "--device", "cpu",
                                      "--requests", "6", "--policies", "mdc"])
    runpy.run_path(str(example), run_name="__main__")
    out = capsys.readouterr().out
    assert "[serve] mdc" in out and "lowest compaction overhead" in out
    assert "request B reused 4 of them" in out
