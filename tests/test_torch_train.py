"""The port's train step and ``train()`` against the JAX package's, and the
port's own restart property.

* The train step (autograd + AdamW with the JAX trainer's settings) against
  JAX's jitted ``make_train_fn`` over 5 steps at f32: losses within 1e-4
  relative.
* ``train()`` end to end against JAX's ``train()`` at the smoke config's
  default bf16 params (JAX's draw carried by ``params=``), 8 steps with a
  checkpoint every 4 and a node loss at step 6: losses within
  ``E2E_LOSS_RTOL`` (the bar and its measured margin are stated there);
  equal ``restarts``, ``resumed_from``, ``steps_replayed`` and checkpoint
  store counters.
* The twin of ``tests/test_checkpoint.py::test_train_fail_restart_is_bit_exact``
  without JAX: the faulty run's losses after the resume equal the clean
  run's, bit for bit (one device, deterministic CPU kernels).
* The CLI, and the device policy: no device means the card, and raises
  without one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_fn as jax_make_train_fn
from repro.launch.train import train as jax_train
from repro.models import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro.optim.schedule import cosine_with_warmup as jax_cosine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import make_train_fn
from repro_torch.launch.train import train
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.tree import leaves, tree_map

# The bar of ``train()`` against JAX's at bf16: half a bf16 step of the
# loss, relative (2**-9).  The two packages round bf16 products and
# activations in different places, so the losses part by rounding, not by
# their math.  Measured: 1.61e-4 relative at most over the 10 losses, a
# margin of 12x.
E2E_LOSS_RTOL = 2.0 ** -9
E2E = dict(arch="qwen3-1.7b", smoke=True, steps=8, global_batch=2,
           seq_len=64, save_every=4, fail_at=(6,), verbose=False, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-sized tensors: one intra-op thread, and no oversubscription of
    the CPU by test files running side by side in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """(JAX log, port log) of one faulty run each, from JAX's draw."""
    root = tmp_path_factory.mktemp("e2e")
    jlog = jax_train(ckpt_dir=str(root / "jax"), **E2E)
    jp = JaxModel(jax_get_config(E2E["arch"]).smoke()).init(
        jax.random.PRNGKey(E2E["seed"]))
    log = train(ckpt_dir=str(root / "port"), device="cpu",
                params=params_from_jax(jax.tree.map(np.asarray, jp)), **E2E)
    return jlog, log


def _tokens(vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (2, 64)).astype(
        np.int32)


def test_train_step_matches_jax_over_five_steps():
    """The JAX trainer's optimizer (``launch.train``: cosine with warmup,
    b2 0.95, weight decay 0.1, clip 1.0) at f32, both steps fed the same
    batches."""
    jcfg, cfg = (jax_get_config("qwen3-1.7b").smoke(),
                 get_config("qwen3-1.7b").smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JaxModel(jcfg).init(jax.random.PRNGKey(1)))
    p = params_from_jax(jax.tree.map(np.asarray, jp))
    for t in leaves(p):
        t.requires_grad_(True)
    kw = dict(b2=0.95, weight_decay=0.1, clip_norm=1.0)
    jopt = JaxAdamW(lr=jax_cosine(3e-3, 2, 5), **kw)
    opt = AdamW(lr=cosine_with_warmup(3e-3, 2, 5), **kw)
    jstep = jax.jit(jax_make_train_fn(JaxModel(jcfg), jopt))
    step = make_train_fn(Model(cfg, params={}), opt)
    jst, st = jopt.init(jp), opt.init(p)
    jl, pl = [], []
    for i in range(5):
        toks = _tokens(cfg.vocab_size, seed=10 + i)
        jp, jst, jloss = jstep(jp, jst, {"tokens": jnp.asarray(toks)})
        p, st, loss = step(p, st, {"tokens": torch.from_numpy(toks)})
        jl.append(float(jloss))
        pl.append(float(loss))
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0]  # it trains
    assert int(st.step) == 5 and all(t.requires_grad for t in leaves(p))
    apart = tree_map(lambda a, b: float(np.abs(a.detach().numpy()
                                               - np.asarray(b)).max()), p, jp)
    assert max(leaves(apart)) < 1e-4


def test_train_matches_jax_end_to_end(e2e):
    jlog, log = e2e
    assert len(log["loss"]) == len(jlog["loss"]) == 10  # 6 + 4 replayed
    np.testing.assert_allclose(log["loss"], jlog["loss"], rtol=E2E_LOSS_RTOL)
    for k in ("restarts", "resumed_from", "steps_replayed"):
        assert log[k] == jlog[k], k
    assert log["restarts"] == 1 and log["resumed_from"] == [4]
    assert (dataclasses.asdict(log["ckpt_stats"])
            == dataclasses.asdict(jlog["ckpt_stats"]))
    assert log["ckpt_wamp"] == jlog["ckpt_wamp"]
    assert log["final_loss"] == log["loss"][-1]
    assert {k: t.dtype for k, t in log["params"]["blocks"]["attn"].items()} \
        == {k: torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
            for k, a in jlog["params"]["blocks"]["attn"].items()}


def test_fail_restart_is_bit_exact(tmp_path):
    """A run that dies at step 17 and restarts from the step-16 checkpoint
    ends with exactly the clean run's losses and params."""
    kw = dict(arch="qwen3-1.7b", smoke=True, steps=24, global_batch=2,
              seq_len=64, save_every=8, verbose=False, seed=3, device="cpu")
    clean = train(ckpt_dir=None, **kw)
    faulty = train(ckpt_dir=str(tmp_path / "ck"), fail_at=(17,), **kw)
    assert faulty["restarts"] == 1 and faulty["resumed_from"] == [16]
    assert faulty["steps_replayed"] == 1
    assert faulty["loss"][-8:] == clean["loss"][-8:]
    assert faulty["loss"][:17] == clean["loss"][:17]
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(faulty["params"]), leaves(clean["params"])))


def test_attempts_start_from_their_own_copy_of_params(tmp_path):
    """``params=`` is copied per attempt: the caller's tree is untouched,
    and a run that fails before its first checkpoint restarts from the
    given values, so it repeats the clean run."""
    cfg = get_config("qwen3-1.7b").smoke()
    given = Model(cfg, params={}).init(5, device="cpu")
    before = tree_map(torch.clone, given)
    kw = dict(steps=6, global_batch=2, seq_len=32, save_every=4,
              verbose=False, device="cpu", params=given)
    clean = train(**kw)
    faulty = train(ckpt_dir=str(tmp_path / "ck"), fail_at=(2,), **kw)
    assert faulty["restarts"] == 1 and faulty["resumed_from"] == []
    assert faulty["loss"][2:] == clean["loss"]
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(given), leaves(before)))


def test_cli_trains_and_resumes_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--device", "cpu", "--steps", "4", "--seq-len", "16",
        "--global-batch", "2", "--ckpt-dir", str(tmp_path / "ck"),
        "--save-every", "2", "--fail-at", "3"])
    train_mod.main()
    out = capsys.readouterr().out
    assert "attempt 1: resumed step 2" in out
    assert "done: final loss" in out and "restarts 1" in out


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(steps=1, verbose=False)
