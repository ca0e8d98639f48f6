"""The partitioned train step (``launch.steps.make_train_fn``'s route for the
dense family on a mesh) against the JAX package and the one-device step.

On the smoke qwen3-1.7b with f32 params drawn by JAX (``bridge``) and
batches from numpy, ``gloo`` CPU ranks (``tests/_torch_mesh.py``'s rank
functions, one torch thread each) take three steps at (data, model) = (1,
2) and (2, 2); their losses and params are held to the jitted one-device
JAX step and the port's one-device step at ``tests/test_torch_elastic.py``'s
bars (measured: losses 2.8e-7 / 1.4e-7 relative to the one-device step, 1
element of 426,368 beyond ``PARAM_ATOL``).

Work: rank 0's product FLOPs of the train cell (B 4 x S 32), counted on
``meta`` at a (1, 2) and a (2, 2) mesh given as sizes, against the dot
FLOPs of ``HloCost`` on the JAX cell's per-device program at the same
debug mesh (lowered and compiled in a subprocess with 8 host devices, as
``tests/test_sharding.py::test_multidevice_dryrun_smoke`` does; the dot
FLOPs are its count less its count with dots at 0), within
``FLOPS_VS_HLOCOST_RTOL``.  Measured 1.0000 at (1, 2) and 0.958 at (2, 2):
the JAX program repeats the attention's f32 score products over "data"
(its whole count over ours: 1.089 and 1.180).  The whole-width step before
the partitioned route counted 2.0 and 1.92 of JAX's dots.

The replicated dims: smoke configs whose head count, kv heads and
vocabulary a 2-way "model" does not divide (each computed whole on every
rank), and two whose kv heads alone it does not divide (each rank projects
the kv heads its query heads read): each rank's reduced gradient shards are
the one-device gradient's slices, so a leaf every "model" rank holds whole
(the norms) is summed over "model" once.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import _torch_mesh as tm
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_fn as jax_make_train_fn
from repro.models import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import shard_view, tree_specs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.distributed.partition import Partition
from repro_torch.launch.steps import (build_cell, compute_route, make_train_fn,
                                     partitioned_grads)
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.roofline.op_cost import OpCost
from repro_torch.tree import leaves, leaves_with_path, tree_map
from test_torch_dryrun import FLOPS_VS_HLOCOST_RTOL
from test_torch_elastic import (JAX_RTOL, LOSS_RTOL, OPT, PARAM_ATOL,
                                PARAM_SHARE)

B, S, STEPS = 4, 32, 3
PARAM_CAP = 2 * OPT["lr"] * STEPS
MESHES = [(1, 2), (2, 2)]
SPAWN_TIMEOUT_S = 300
# each rank's reduced gradient shard against the one-device gradient's
# slice, relative to the leaf's largest element (measured <= 1.6e-6: the
# partial sums add in another order)
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.fixture(scope="module")
def run():
    """The JAX steps, the port's one-device steps and each mesh's, from the
    same params and batches."""
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
    meshes = {shape: spawn_ranks(tm.sharded_steps, shape[0] * shape[1], shape,
                                 params, batches, OPT, None, backend="gloo",
                                 device="cpu", timeout_s=SPAWN_TIMEOUT_S)
              for shape in MESHES}
    return dict(params=params, jax_loss=jl, jax_params=jp, one_loss=pl,
                one_params=p, meshes=meshes)


def _apart(a_tree, b_leaves) -> tuple[float, float]:
    """(largest |a - b|, share of elements apart by more than PARAM_ATOL)."""
    d = np.concatenate([np.abs(a.detach().numpy() - np.asarray(
        b.detach() if isinstance(b, torch.Tensor) else b)).ravel()
        for a, b in zip(leaves(a_tree), b_leaves)])
    return float(d.max()), float((d > PARAM_ATOL).mean())


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_steps_match_one_device_and_jax(run, shape):
    ranks = run["meshes"][shape]
    for r in ranks:   # every rank reads the same averaged loss
        assert r["losses"] == ranks[0]["losses"]
        assert r["held_bytes"] == r["per_device_bytes"]
    got = ranks[0]["losses"]
    np.testing.assert_allclose(got, run["one_loss"], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got, run["jax_loss"], rtol=JAX_RTOL, atol=0)
    whole = ranks[0]["params"]
    for other in (leaves(run["one_params"]),
                  jax.tree.leaves(run["jax_params"])):
        worst, share = _apart(whole, other)
        assert worst < PARAM_CAP and share <= PARAM_SHARE, (worst, share)


def test_routes_are_named():
    """The train step is partitioned on a mesh for every family but the
    encoder-decoder and the VLM stub; every other step replicated; the
    step and the dry-run's records name the route."""
    sizes = {"data": 2, "model": 2}
    assert compute_route(get_config("qwen3-1.7b"), "train", None) == (
        "one-device")
    for arch in ("qwen3-1.7b", "granite-3-2b", "yi-34b", "nemotron-4-340b",
                 "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "mamba2-1.3b",
                 "zamba2-7b"):
        assert compute_route(get_config(arch), "train", sizes) == (
            "partitioned")
        assert compute_route(get_config(arch), "decode", sizes) == (
            "replicated")
    for arch in ("whisper-medium", "internvl2-76b"):
        assert compute_route(get_config(arch), "train", sizes) == (
            "replicated")
        fn, _ = build_cell(get_config(arch).smoke(), dataclasses.replace(
            SHAPES["train_4k"], global_batch=4, seq_len=32), mesh=sizes)
        assert fn.compute == "replicated"
    fn, _ = build_cell(get_config("qwen3-1.7b").smoke(), dataclasses.replace(
        SHAPES["train_4k"], global_batch=4, seq_len=32), mesh=sizes)
    assert fn.compute == "partitioned"


def test_dryrun_records_carry_the_route(tmp_path):
    recs = {m: dryrun.run_cell("qwen3-1.7b", "train_4k", tmp_path,
                               smoke=True, mesh=m) for m in ("one", "single")}
    assert recs["one"]["compute"] == "one-device"
    assert recs["single"]["compute"] == "partitioned"
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", tmp_path, smoke=True,
                          mesh="single")
    assert rec["status"] == "ok" and rec["compute"] == "replicated"


def test_one_by_one_mesh_is_the_one_device_step_bitwise():
    cfg = get_config(tm.ARCH).smoke()
    params = tree_map(lambda t: t.float(), Model(cfg, device="cpu",
                                                 seed=0).params)
    rng = np.random.default_rng(5)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))} for _ in range(2)]
    r, = spawn_ranks(tm.one_by_one_against_one_device, 1, params, batches,
                     OPT, backend="gloo", device="cpu",
                     timeout_s=SPAWN_TIMEOUT_S)
    assert r["mesh"]["losses"] == r["one"]["losses"]
    for a, b in zip(leaves(r["mesh"]["params"]), leaves(r["one"]["params"])):
        assert torch.equal(a, b)


# ------------------------------------------------------------- the work

JAX_DOTS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.configs import SHAPES, get_config
    from repro.launch.steps import build_cell
    from repro.roofline import hlo_cost

    cfg = get_config("qwen3-1.7b").smoke()
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=%d,
                                seq_len=%d)
    out = {}
    for d, m in %r:
        mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                    ("data", "model"))
        jitted, args = build_cell(cfg, shape, mesh)
        txt = jitted.lower(*args).compile().as_text()
        whole = hlo_cost.HloCost(txt).summary()["flops_per_device"]
        dot = hlo_cost._dot_flops
        hlo_cost._dot_flops = lambda op, types: 0
        rest = hlo_cost.HloCost(txt).summary()["flops_per_device"]
        hlo_cost._dot_flops = dot
        out[f"{d}x{m}"] = {"flops": whole, "dots": whole - rest}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_dots():
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_DOTS % (B, S, MESHES)],
                          env=env, capture_output=True, text=True,
                          timeout=480)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_rank0_product_flops_are_the_jax_per_device_dots(jax_dots, shape):
    cfg = get_config(tm.ARCH).smoke()
    cell = dataclasses.replace(SHAPES["train_4k"], global_batch=B, seq_len=S)
    fn, args = build_cell(cfg, cell, mesh=dict(zip(("data", "model"),
                                                   shape)))
    with OpCost(inputs=args) as oc:
        fn(*args)
    got = sum(oc.summary()["product_flops_by_dtype"].values())
    want = jax_dots[_ids(shape)]["dots"]
    assert got == pytest.approx(want, rel=FLOPS_VS_HLOCOST_RTOL)


# ------------------------------------------------------ replicated dims

# a 2-way "model" divides none of the heads, the kv heads or the
# vocabulary of the first (granite's tied embedding); all but the kv heads
# of the others (qwen3's qk norms): a rank's two query heads read the one
# kv head, or its three (of six, over three kv heads) read kv heads 0, 0
# and 1 (one kv head per query head)
ODD = {"granite-odd": ("granite-3-2b", dict(n_heads=3, n_kv_heads=1,
                                            vocab_size=511)),
       "qwen3-kv1": ("qwen3-1.7b", dict(n_kv_heads=1)),
       "qwen3-h6kv3": ("qwen3-1.7b", dict(n_heads=6, n_kv_heads=3))}


@pytest.mark.parametrize("case", list(ODD))
def test_replicated_dims_match_the_one_device_gradient(case):
    arch, kw = ODD[case]
    cfg = dataclasses.replace(get_config(arch).smoke(), **kw)
    model = Model(cfg, params={})
    params = tree_map(lambda t: t.float(), Model(cfg, device="cpu",
                                                 seed=3).params)
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))}
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    want_loss = model.loss(p, batch)
    want = dict(zip(["/".join(k) for k, _ in leaves_with_path(p)],
                    torch.autograd.grad(want_loss, leaves(p))))
    ranks = spawn_ranks(tm.partitioned_grads, 2, (1, 2), cfg, params, batch,
                        backend="gloo", device="cpu",
                        timeout_s=SPAWN_TIMEOUT_S)
    sizes = {"data": 1, "model": 2}
    specs = dict(zip(want, tree_specs(model.axes(), model.abstract(),
                                      sizes)))
    replicated = [k for k, sp in specs.items() if "model" not in sp]
    assert "blocks/ln1" in replicated and "final_norm" in replicated
    if case == "granite-odd":
        assert {"embed", "blocks/attn/wq", "blocks/attn/wk"} <= set(
            replicated)
    for r in ranks:
        assert r["route"] == "partitioned"
        assert r["loss"] == pytest.approx(float(want_loss.detach()),
                                          rel=LOSS_RTOL)
        for k, g in r["grads"].items():
            w = shard_view(want[k], specs[k], sizes, r["coords"])
            scale = float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=GRAD_RTOL * scale, msg=k)


# ----------------------------------------------------------- the operators

def test_operators_forward_and_backward():
    """Two ranks, inputs x_r = arange(8).reshape(2, 4) + 10 r, upstream
    gradient (r + 1): each operator's output and its input's gradient."""
    r0, r1 = spawn_ranks(tm.megatron_ops, 2, backend="gloo", device="cpu",
                         timeout_s=SPAWN_TIMEOUT_S)
    x = [np.arange(8.0).reshape(2, 4) + 10 * r for r in range(2)]
    for r, got in enumerate((r0, r1)):
        up = r + 1.0
        assert got["copy_to"]["y"] == x[r].tolist()
        assert got["copy_to"]["grad"] == np.full((2, 4), 3.0).tolist()
        assert got["reduce_from"]["y"] == (x[0] + x[1]).tolist()
        assert got["reduce_from"]["grad"] == np.full((2, 4), up).tolist()
        assert got["gather_from"]["y"] == np.concatenate(x, 1).tolist()
        # the upstream gradient of the gathered (2, 8) summed over the
        # ranks and cut back to this rank's columns
        assert got["gather_from"]["grad"] == np.full((2, 4), 3.0).tolist()
        assert got["scatter_to"]["y"] == (x[0] + x[1])[:, 2 * r:2 * r + 2
                                                       ].tolist()
        # the gathered upstream gradient: rank 0's columns of 1, rank 1's
        # of 2
        assert got["scatter_to"]["grad"] == [[1.0, 1.0, 2.0, 2.0]] * 2
        assert got["fsdp_gather"]["y"] == np.concatenate(x, 0).tolist()
        assert got["fsdp_gather"]["grad"] == np.full((2, 4), 3.0).tolist()
        assert got["max"] == [2.0, 5.0]


def test_operators_charge_their_collectives_on_sizes_only_mesh():
    """On a mesh given as sizes: each operator's forward and backward is
    charged as the collective it means (a reduce-scatter's payload its
    output's bytes), and a weight kept by ``FsdpHooks`` is gathered again
    in the backward."""
    sizes = {"data": 2, "model": 4}
    x = torch.empty(2, 8, 16, device="meta", requires_grad=True)
    nb = 2 * 8 * 16 * 4
    with OpCost() as oc:
        y = collectives.gather_from(x, 1, "model", sizes)
        assert y.shape == (2, 32, 16)
        z = collectives.scatter_to(y, 1, "model", sizes)
        assert z.shape == (2, 8, 16)
        z.sum().backward()
    s = oc.summary()
    assert s["collective_counts"] == {"all-gather": 2, "reduce-scatter": 2}
    assert s["collective_bytes_per_device"] == {"all-gather": 2 * 4 * nb,
                                                "reduce-scatter": 2 * nb}
    w = torch.empty(4, 16, device="meta", requires_grad=True)
    hooks = collectives.FsdpHooks()
    with OpCost() as oc:
        with hooks:
            whole = collectives.fsdp_gather(w, 0, "data", sizes, hooks)
            out = x @ whole.t()       # the product saves the gathered weight
        del whole
        out.sum().backward()
    s = oc.summary()
    # gathered for the forward and again for the backward; its gradient
    # reduce-scattered to the shard
    assert s["collective_counts"] == {"all-gather": 2, "reduce-scatter": 1}
    assert s["collective_bytes_per_device"] == {
        "all-gather": 2 * 8 * 16 * 4, "reduce-scatter": 4 * 16 * 4}


def test_meta_and_cpu_ranks_count_alike():
    """The (2, 2) train cell counted on each CPU rank and on ``meta`` at the
    mesh's sizes (rank 0's): FLOPs by dtype, bytes, collectives, kernel
    charges and the peak of live bytes, equal."""
    cfg = get_config(tm.ARCH).smoke()
    cell = dataclasses.replace(SHAPES["train_4k"], global_batch=B, seq_len=S)
    fn, args = build_cell(cfg, cell, mesh={"data": 2, "model": 2})
    with OpCost(inputs=args) as oc:
        fn(*args)
    want = oc.summary()
    r0 = spawn_ranks(tm.count_train_cell, 4, (2, 2), cfg, cell,
                     backend="gloo", device="cpu",
                     timeout_s=SPAWN_TIMEOUT_S)[0]
    for k in ("flops_by_dtype", "product_flops_by_dtype",
              "hbm_bytes_per_device", "collective_bytes_per_device",
              "collective_counts", "kernel_charges", "peak_live_bytes"):
        assert r0[k] == want[k], k


# --------------------------------------------------------------- memory

def test_no_rank_holds_whole_logits_or_the_whole_tree():
    """Rank 0 of a (2, 2) mesh on ``meta``, at a width where the parameter
    tree dwarfs the activations (d 1,024, a vocabulary of 16,384, B 4 x S
    8): the count's peak over the step's forward and backward, above its
    inputs (the shards and the batch), stays below the whole tree's bytes
    (measured 0.61 of it: the gradient shards, a quarter, and the gathered
    unembedding and its gradient; a rank that gathered the tree whole
    would add all of it to its gradient shards), and no op makes a tensor
    with a dim of the whole vocabulary (so none holds the (B, S, V)
    logits).  The AdamW update after it walks the shards leaf by leaf."""
    cfg = get_config(tm.ARCH).smoke().with_(d_model=1024, d_ff=2048,
                                            vocab_size=16384)
    cell = dataclasses.replace(SHAPES["train_4k"], global_batch=4, seq_len=8)
    sizes = {"data": 2, "model": 2}
    _, (params, _, batch) = build_cell(cfg, cell, mesh=sizes)
    model = Model(cfg, params={})
    inputs = sum(t.numel() * t.element_size()
                 for t in leaves((params, batch)))
    tree = sum(t.numel() * t.element_size() for t in leaves(model.abstract()))
    shapes = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            shapes.extend(tuple(t.shape) for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor))
            return out

    part = Partition(model, sizes)
    with OpCost(inputs=(params, batch)) as oc, Shapes():
        partitioned_grads(model, part, params, batch)
    peak = oc.summary()["peak_live_bytes"]
    assert peak - inputs < tree, (peak - inputs, tree)
    assert not [s for s in shapes if cfg.vocab_size in s]
