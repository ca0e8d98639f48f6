"""The port's optimizer, schedule, gradient compression, synthetic data stream
and restart driver against the JAX package's, on the same numpy inputs.

* ``AdamW.update`` over 5 steps at f32 and bf16 params, clipping on and off,
  weight decay on, the learning rate from ``cosine_with_warmup``: f32
  moments and params within 1e-6 relative (``_close``), bf16 params equal
  or one bf16 step apart; ``global_norm`` and the schedule at every step.
* int8 quantization bitwise (both round half to even), the error-feedback
  residuals, and top-k's mask.
* ``SyntheticLMStream.batch_at`` bit for bit over seeds, steps and hosts,
  and ``seek``.
* ``StragglerDetector`` and ``run_with_restarts`` on the same sequences,
  and the port's restart driver dropping a failed attempt's state before
  it builds the next.
"""

import dataclasses
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLMStream as JaxStream
from repro.distributed import fault as jfault
from repro.optim import AdamW as JaxAdamW
from repro.optim import global_norm as jax_global_norm
from repro.optim import grad as jgrad
from repro.optim.schedule import cosine_with_warmup as jax_cosine
from repro_torch.bridge import tensor_from_numpy
from repro_torch.data import SyntheticLMStream
from repro_torch.distributed import fault
from repro_torch.optim import AdamW, global_norm, grad
from repro_torch.optim.schedule import constant, cosine_with_warmup
from repro_torch.tree import leaves, tree_map

SHAPES = {"w": (6, 5), "blocks": {"wq": (3, 4, 8), "ln": (3, 8)},
          "b": (7,)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread, and no oversubscription of the
    CPU by test files running side by side in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, dtype, scale=1.0):
    """A parameter-shaped tree of numpy f32 arrays (rounded through
    ``dtype`` when bf16, so both packages start from the same values)."""
    out = tree_map(lambda s: (rng.standard_normal(s) * scale).astype(
        np.float32), SHAPES, is_leaf=lambda x: isinstance(x, tuple))
    if dtype == "bfloat16":
        out = tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                       out)
    return out


def _to_jax(tree):
    return tree_map(jnp.asarray, tree)


def _to_port(tree):
    return tree_map(tensor_from_numpy, tree)


def _close(got: np.ndarray, want: np.ndarray) -> None:
    """Within 1e-6 of each element's magnitude or of the leaf's largest.
    The leaf-wide term covers first moments that cancel to near zero: with
    clipping on, the two packages' global norms (sums in different orders)
    can differ in their last bit, so every gradient does too, and a moment
    that sums them to ~1e-3 of its leaf's scale keeps that ulp as ~1e-5 of
    itself (measured: 4.4e-8 of the leaf's largest)."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def _within_one_bf16_step(got: np.ndarray, want: np.ndarray) -> None:
    """Equal, or adjacent bf16 values (their bit patterns one apart)."""
    a = got.astype(np.float32).view(np.uint32) >> 16
    b = want.astype(np.float32).view(np.uint32) >> 16
    sign_equal = (a >> 15) == (b >> 15)
    apart = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert np.all((apart == 0) | (sign_equal & (apart == 1))), \
        f"{int(np.sum(apart > 1))} bf16 params more than one step apart"


@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["no-clip", "clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_five_steps(dtype, clip):
    rng = np.random.default_rng(11)
    p0 = _tree(rng, dtype)
    kw = dict(b2=0.95, weight_decay=0.1, clip_norm=clip)
    jopt = JaxAdamW(lr=jax_cosine(1e-2, 2, 5), **kw)
    opt = AdamW(lr=cosine_with_warmup(1e-2, 2, 5), **kw)
    jp, p = _to_jax(p0), _to_port(p0)
    jst, st = jopt.init(jp), opt.init(p)
    clipped = []
    for _ in range(5):
        g = _tree(rng, dtype, scale=0.3)
        clipped.append(float(jax_global_norm(_to_jax(g))) > clip > 0)
        jp, jst = jopt.update(jp, _to_jax(g), jst)
        p, st = opt.update(p, _to_port(g), st)
        assert int(st.step) == int(jst.step)
        for m, jm in ((st.mu, jst.mu), (st.nu, jst.nu)):
            for a, b in zip(leaves(m), leaves(jm)):
                _close(a.numpy(), np.asarray(b))
        for a, b in zip(leaves(p), leaves(jp)):
            if dtype == "float32":
                _close(a.numpy(), np.asarray(b))
            else:
                assert a.dtype == torch.bfloat16
                _within_one_bf16_step(a.float().numpy(),
                                      np.asarray(b, np.float32))
    assert any(clipped) == (clip > 0)


def test_global_norm_and_schedules_match_jax():
    rng = np.random.default_rng(3)
    for dtype in ("float32", "bfloat16"):
        t = _tree(rng, dtype)
        np.testing.assert_allclose(float(global_norm(_to_port(t))),
                                   float(jax_global_norm(_to_jax(t))),
                                   rtol=1e-6)
    for peak, warm, total, frac in ((3e-4, 10, 30, 0.1), (1e-2, 2, 5, 0.1),
                                    (1e-3, 0, 7, 0.25), (5e-4, 4, 4, 0.1)):
        ours, ref = cosine_with_warmup(peak, warm, total, frac), \
            jax_cosine(peak, warm, total, frac)
        for step in range(total + 3):
            want = float(ref(jnp.asarray(step, jnp.int32)))
            assert ours(step) == pytest.approx(want, rel=1e-6, abs=0), step
    assert constant(0.25)(7) == 0.25


def test_quantize_int8_is_bitwise_and_residuals_match():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    q, s = grad.quantize_int8(torch.from_numpy(x))
    jq, js = jgrad.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and float(s) == float(js)
    # half-to-even on exact ties: a scale that makes x / scale land on .5
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    np.testing.assert_array_equal(
        grad.quantize_int8(torch.from_numpy(ties))[0].numpy(),
        np.asarray(jgrad.quantize_int8(jnp.asarray(ties))[0]))

    ef, jef = grad.init_error_feedback(_to_port(_tree(rng, "float32"))), \
        jgrad.init_error_feedback(_to_jax(_tree(rng, "float32")))
    for _ in range(3):
        g = _tree(rng, "float32")
        pay, ef = grad.compress_grads_int8(_to_port(g), ef)
        jpay, jef = jgrad.compress_grads_int8(_to_jax(g), jef)
        for (a, sa), (b, sb) in zip(
                leaves(pay, is_leaf=grad._is_payload),
                leaves(jpay, is_leaf=lambda v: isinstance(v, tuple))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert float(sa) == float(sb)
        for a, b in zip(leaves(ef.residual), leaves(jef.residual)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)
        deq = grad.decompress_grads_int8(pay)
        jdeq = jgrad.decompress_grads_int8(jpay)
        for a, b in zip(leaves(deq), leaves(jdeq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("frac", [0.05, 0.1, 0.5])
def test_topk_keeps_the_jax_mask_and_residuals(frac):
    rng = np.random.default_rng(9)
    ef = grad.init_error_feedback(_to_port(_tree(rng, "float32")))
    jef = jgrad.init_error_feedback(_to_jax(_tree(rng, "float32")))
    for _ in range(3):
        g = _tree(rng, "float32")
        kept, ef = grad.compress_grads_topk(_to_port(g), ef, frac)
        jkept, jef = jgrad.compress_grads_topk(_to_jax(g), jef, frac)
        for a, b in zip(leaves(kept), leaves(jkept)):
            np.testing.assert_array_equal(a.numpy() != 0, np.asarray(b) != 0)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(leaves(ef.residual), leaves(jef.residual)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)


def test_synthetic_stream_is_the_jax_stream_bit_for_bit():
    for seed in (0, 1, 7):
        for n_hosts, host in ((1, 0), (2, 0), (2, 1)):
            kw = dict(vocab_size=97, seq_len=16, global_batch=4,
                      n_hosts=n_hosts, host_id=host, seed=seed)
            ours, ref = SyntheticLMStream(**kw), JaxStream(**kw)
            for step in (0, 1, 5, 100):
                a, b = ours.batch_at(step), ref.batch_at(step)
                assert a["tokens"].dtype == b["tokens"].dtype == np.int32
                np.testing.assert_array_equal(a["tokens"], b["tokens"])
            got = [next(ours)["tokens"] for _ in range(4)]
            for i, t in enumerate(got):
                np.testing.assert_array_equal(t, ref.batch_at(i)["tokens"])
            ours.seek(2)
            ref.seek(2)
            np.testing.assert_array_equal(next(ours)["tokens"],
                                          next(ref)["tokens"])
            assert ours.state_dict() == ref.state_dict()
            ours.close()
            ref.close()


def test_straggler_detector_matches_jax():
    rng = np.random.default_rng(2)
    for thr, warm in ((3.0, 2), (4.0, 3), (1.5, 0)):
        dts = list(rng.uniform(0.8, 1.2, 40))
        dts[5] = dts[17] = 6.0
        dts[30] = 2.0
        ours, ref = fault.StragglerDetector(thr, warmup=warm), \
            jfault.StragglerDetector(thr, warmup=warm)
        flags = [ours.observe(i, dt) for i, dt in enumerate(dts)]
        jflags = [ref.observe(i, dt) for i, dt in enumerate(dts)]
        assert flags == jflags
        assert ours.stragglers == ref.stragglers and ours.ewma == ref.ewma
        assert ours.stragglers


def _restart_run(mod, fail_at, steps=12, every=3, **kw):
    """A loop that checkpoints every ``every`` steps and fails where the
    injector says; returns (result, RestartStats as a dict, trace)."""
    inj = mod.FailureInjector(fail_at_steps=fail_at)
    ckpt, trace = [0], []

    def make_state(attempt):
        trace.append(("start", attempt, ckpt[0]))
        return {"start": ckpt[0]}

    def loop(state):
        for s in range(state["start"], steps):
            inj.check(s)
            trace.append(s)
            if (s + 1) % every == 0:
                ckpt[0] = s + 1
        return sum(x for x in trace if isinstance(x, int))

    result, stats = mod.run_with_restarts(
        make_state, loop, restored_step=lambda st: st["start"], **kw)
    return result, dataclasses.asdict(stats), trace


@pytest.mark.parametrize("fail_at,kw", [
    ((), {}), ((4,), {}), ((2, 7, 11), {}), ((5,), {"max_restarts": 2}),
    ((1, 2, 3), {"max_restarts": 3})])
def test_run_with_restarts_matches_jax(fail_at, kw):
    assert _restart_run(fault, fail_at, **kw) == \
        _restart_run(jfault, fail_at, **kw)


def test_run_with_restarts_exhausts_like_jax():
    for mod in (fault, jfault):
        with pytest.raises(RuntimeError, match="restart budget exhausted"):
            _restart_run(mod, (1, 2, 3), max_restarts=2)


def test_failed_attempt_is_dropped_before_the_next_state():
    """The failed loop's locals (its params) are unreachable when
    ``make_state`` builds the next attempt: not held by the driver's state
    nor by the exception's traceback."""
    refs, alive = [], []

    def make_state(attempt):
        gc.disable()  # only reference counting may free them
        try:
            alive.append([r() is not None for r in refs])
        finally:
            gc.enable()
        params = {"w": torch.ones(4)}
        refs.append(weakref.ref(params["w"]))
        return {"params": params, "start": 0}

    def loop(state):
        params = state["params"]
        moments = {"m": params["w"] * 2}
        refs.append(weakref.ref(moments["m"]))
        if len(refs) < 4:
            raise fault.SimulatedFailure("node lost", step=1)
        return float(params["w"].sum() + moments["m"].sum())

    result, stats = fault.run_with_restarts(make_state, loop)
    assert result == 12.0 and stats.restarts == 1
    assert alive == [[], [False, False]]
