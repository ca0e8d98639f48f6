"""Training on a mesh of CPU ranks (``gloo``) against one device and against
the JAX package, and elastic re-sharding: the twin of
``tests/test_elastic.py``'s 8 -> 2 -> 8.

All on the smoke qwen3-1.7b with f32 params drawn by JAX (``bridge``) and
batches from numpy, in three spawns of ``tests/_torch_mesh.py``'s rank
functions, one torch thread per rank:

1. a 2 x 2 mesh takes three sharded steps and saves params and moments
   from the mesh;
2. a 2 x 1 mesh (the trainer's host mesh of two ranks) restores the
   params from it;
3. a 2 x 2 mesh restores params and moments and takes a step, runs
   ``train`` clean and with a failure (restarts restore onto the mesh),
   and gathers and reduces over a joint ("pod", "data") axis.

Tolerances: the sharded step sums each half batch's gradient apart and
all-reduces them, so it rounds apart from the one-device step: losses
within ``LOSS_RTOL`` (measured 1.4e-7 relative; against the JAX step,
``tests/test_torch_train.py``'s 1e-4, measured 2.9e-7).  Params: AdamW's
first update is ~lr * sign(g), so an element whose gradient is rounding
noise can step either way in two runs (ROADMAP §3's one-step bar): at
most ``PARAM_SHARE`` of the elements beyond ``PARAM_ATOL`` and none
beyond 2 lr per step.  Measured after three steps at lr 3e-3: 1 element
of 426,368 (an embedding entry) beyond 1e-4, at 2.2e-3 against the
one-device step and 3.1e-3 between the one-device and the JAX step, every
other within 1.25e-5 and 7.6e-5.  Restores are bitwise, and a resumed
run's losses are the clean run's, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh as tm
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_fn as jax_make_train_fn
from repro.models import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.steps import make_train_fn
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.tree import leaves, tree_map

LOSS_RTOL = 1e-5
JAX_RTOL = 1e-4
PARAM_ATOL = 1e-4
PARAM_SHARE = 1e-3
OPT = dict(lr=3e-3, b2=0.95, weight_decay=0.1, clip_norm=1.0)
B, S, STEPS = 4, 32, 3
PARAM_CAP = 2 * OPT["lr"] * STEPS
RESTART = dict(arch=tm.ARCH, smoke=True, steps=6, global_batch=B,
               seq_len=S, save_every=2, fail_at=(3,), seed=0)
SPAWN_TIMEOUT_S = 300


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX steps, the port's one-device steps and the 2 x 2 mesh's
    (spawn 1), from the same params and batches."""
    root = tmp_path_factory.mktemp("elastic")
    jcfg, cfg = jax_get_config(tm.ARCH).smoke(), get_config(tm.ARCH).smoke()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JaxModel(jcfg).init(jax.random.PRNGKey(1)))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for _ in range(STEPS)]
    jopt = JaxAdamW(**OPT)
    jstep = jax.jit(jax_make_train_fn(JaxModel(jcfg), jopt))
    jst, jl = jopt.init(jp), []
    for t in toks:
        jp, jst, loss = jstep(jp, jst, {"tokens": jnp.asarray(t)})
        jl.append(float(loss))
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    opt = AdamW(**OPT)
    st, step, pl = opt.init(p), make_train_fn(Model(cfg, params={}), opt), []
    for t in toks:
        p, st, loss = step(p, st, {"tokens": torch.from_numpy(t)})
        pl.append(float(loss))
    batches = [{"tokens": torch.from_numpy(t)} for t in toks]
    ranks = spawn_ranks(tm.sharded_steps, 4, (2, 2), params, batches, OPT,
                        str(root / "ckpt"), backend="gloo", device="cpu",
                        timeout_s=SPAWN_TIMEOUT_S)
    return dict(root=root, params=params, batches=batches, jax_loss=jl,
                jax_params=jp, one_loss=pl, one_params=p, ranks=ranks)


def _apart(a_tree, b_leaves) -> tuple[float, float]:
    """(largest |a - b|, share of elements apart by more than PARAM_ATOL)."""
    d = np.concatenate([np.abs(a.detach().numpy() - np.asarray(
        b.detach() if isinstance(b, torch.Tensor) else b)).ravel()
        for a, b in zip(leaves(a_tree), b_leaves)])
    return float(d.max()), float((d > PARAM_ATOL).mean())


def test_sharded_steps_match_one_device_and_jax(run):
    ranks = run["ranks"]
    for r in ranks:   # every rank reads the same averaged loss
        assert r["losses"] == ranks[0]["losses"]
    got = ranks[0]["losses"]
    np.testing.assert_allclose(got, run["one_loss"], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got, run["jax_loss"], rtol=JAX_RTOL, atol=0)
    whole = ranks[0]["params"]
    for other in (leaves(run["one_params"]),
                  jax.tree.leaves(run["jax_params"])):
        worst, share = _apart(whole, other)
        assert worst < PARAM_CAP and share <= PARAM_SHARE, (worst, share)


def test_each_rank_holds_only_its_shards(run):
    """What a rank keeps between steps is its shard of every parameter:
    ``tree_bytes_per_device``'s share, a quarter of the whole on 2 x 2
    but for the leaves no axis divides."""
    whole = sum(t.numel() * t.element_size() for t in leaves(run["params"]))
    for r in run["ranks"]:
        assert r["held_bytes"] == r["per_device_bytes"] < whole / 2


@pytest.fixture(scope="module")
def shrunk(run):
    """Spawn 2: the 2 x 2 mesh's checkpoint restored onto 2 x 1, the
    trainer's host mesh of two ranks."""
    return spawn_ranks(tm.restore_onto, 2, "host", str(run["root"] / "ckpt"),
                       run["ranks"][0]["params"], None, OPT, backend="gloo",
                       device="cpu", timeout_s=SPAWN_TIMEOUT_S)


def test_restore_onto_a_smaller_mesh_is_bitwise(shrunk):
    for r in shrunk:
        assert r["mesh"] == {"data": 2, "model": 1}
        assert r["bitwise"]
        assert r["cut_leaves"] > 0
        assert r["held_bytes"] <= r["per_device_bytes"]


@pytest.fixture(scope="module")
def grown(run):
    """Spawn 3 on 2 x 2: the checkpoint restored and a step taken, the
    restart runs, the joint axis."""
    return spawn_ranks(tm.grow_back_and_restart, 4, str(run["root"] / "ckpt"),
                       run["ranks"][0]["params"], run["batches"][0], OPT,
                       dict(RESTART, params=run["params"]),
                       str(run["root"] / "restart"), backend="gloo",
                       device="cpu", timeout_s=SPAWN_TIMEOUT_S)


def test_restore_onto_the_larger_mesh_again_and_step(grown):
    for r in grown:
        g = r["grown"]
        assert g["bitwise"] and g["held_bytes"] <= g["per_device_bytes"]
        assert np.isfinite(g["loss"]) and g["loss"] == grown[0]["grown"]["loss"]


def test_restart_under_the_mesh_resumes_to_the_clean_losses(grown):
    r = grown[0]["restart"]
    assert r["restarts"] == 1 and r["resumed_from"] == [2]
    n = RESTART["steps"] - 2
    assert len(r["faulty"]) == 3 + n and len(r["clean"]) == RESTART["steps"]
    assert r["faulty"][:3] == r["clean"][:3]
    assert r["faulty"][-n:] == r["clean"][-n:]
    for other in grown[1:]:
        assert other["restart"] == r


def test_joint_pod_data_axis(grown):
    """Rank (pod, data) holds rows [2 (2 pod + data), +2) of the 8, the
    gather gives the whole back, the all-reduce the mean of ranks 0..3."""
    for rank, r in enumerate(grown):
        j = r["joint"]
        assert j["spec"] == (("pod", "data"),)
        assert j["rows"] == [6.0 * rank, 6.0 * rank + 3.0]
        assert j["round_trip"] and j["mean"] == [1.5, 1.5]


def test_a_mesh_save_needs_specs_and_a_mesh_restore_axes(tmp_path):
    """On a mesh the manager is told how the leaves are cut: a save
    without ``specs`` or a restore without ``axes`` raises before any rank
    touches the store."""
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path), **tm.CKPT)
    sizes = {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="specs"):
        mgr.save(1, {"w": torch.zeros(4)}, mesh=sizes)
    with pytest.raises(ValueError, match="axes"):
        mgr.restore({"w": torch.empty(4, device="meta")}, 1, device="cpu",
                    mesh=sizes)
