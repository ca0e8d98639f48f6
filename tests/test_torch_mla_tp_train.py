"""The MLA-MoE family's partitioned train step (DeepSeek-V2-Lite's smoke)
against the JAX package and the one-device step.

On the smoke config (4 heads, latent rank 32, 8 routed experts top-2 and 2
shared experts) with f32 params drawn by JAX (``bridge``) and batches from
numpy, ``gloo`` CPU ranks (``tests/_torch_mesh.py``'s rank functions, one
torch thread each) take three steps at (data, model) = (1, 2) and (2, 2),
at the smoke capacity factor (4.0: nothing drops) and at 1.25, where the
capacity binds.  Losses and params are held to the jitted one-device JAX
step and the port's one-device step at ``tests/test_torch_elastic.py``'s
bars (measured: losses within 1.2e-6 relative of the one-device step, 10
of 981,696 elements beyond ``PARAM_ATOL``).  The draw is the MoE tests'
(``PRNGKey(1)``).  From ``PRNGKey(2)`` at capacity factor 4.0 the second
step's gradient of one embedding element (a token absent from the first
batch) is -1.0e-6, rounding noise against its row: the mesh's AdamW steps
it the other way (3.8e-3 apart), and that one element of an RMS-normed
row moves the third loss by 1.7e-4.  AdamW's update does not scale with
the gradient, so three steps cannot tell such noise from a fault; the
first step's gradient can.  So the mesh's first gradient from
``PRNGKey(2)``, at both capacity factors, is held leaf by leaf to the
one-device step's, each within ``GRAD_BAR`` of the leaf's largest
(``tests/test_torch_families.py``'s bar for the family).

A rank holds its query heads of ``wq`` / ``wo``, its slice of the
latent rank (``w_dkv``, ``kv_norm``, and ``w_uk`` / ``w_uv``, cut on their
rank and whole on their heads, as the resolver gives them), its routed
experts and its shared experts' columns; ``w_kr`` is whole.

Work: rank 0's product FLOPs of the train cell (B 4 x S 32), counted on
``meta`` at a mesh given as sizes, against the dot FLOPs of ``HloCost`` on
the JAX cell's per-device program (8 host devices in a subprocess), within
``FLOPS_VS_HLOCOST_RTOL``; the step never gathers the parameter tree.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import _torch_mesh as tm
from repro_torch.configs import SHAPES
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import shard_view, tree_specs
from repro_torch.launch import steps
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import Model
from repro_torch.roofline.op_cost import OpCost
from repro_torch.tree import leaves, leaves_with_path, tree_map
from test_torch_dryrun import FLOPS_VS_HLOCOST_RTOL
from test_torch_elastic import LOSS_RTOL, OPT
from test_torch_families import GRAD_BAR, _f32_pair
from test_torch_ep_train import (CAPACITY, JAX_DOTS, MESHES, SPAWN_TIMEOUT_S,
                                 _batches, _configs, _hold_to_one_device,
                                 _ids, _one_device)

ARCH = "deepseek-v2-lite-16b"
B, S = 4, 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def start_jax_dots(arch: str, cf: float) -> subprocess.Popen:
    """The JAX train cell (B 4 x S 32) of ``arch``'s smoke config at
    capacity factor ``cf`` compiled at each of ``MESHES`` in a subprocess
    of 8 host devices (``JAX_DOTS``); :func:`read_jax_dots` reads it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-c", JAX_DOTS % (arch, cf, B, S, MESHES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def read_jax_dots(proc: subprocess.Popen) -> dict:
    """{mesh id: {"dots": per-device dot FLOPs, ...}} of a finished
    :func:`start_jax_dots`."""
    stdout, stderr = proc.communicate(timeout=480)
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def dots_proc():
    """The JAX cell at the binding capacity factor, started before the
    steps so that they run side by side."""
    proc = start_jax_dots(ARCH, CAPACITY["cf1.25"])
    yield proc
    proc.kill()
    proc.communicate()


GRAD_SEED = 2   # the first gradients' draw (module docstring)


def one_device_grads(cfg, params, batch) -> dict:
    """The port's one-device loss and gradient (by leaf path) of
    ``batch``."""
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss = Model(cfg, params={}).loss(p, batch)
    return {"loss": float(loss.detach()), "grads": dict(zip(
        ("/".join(k) for k, _ in leaves_with_path(p)),
        torch.autograd.grad(loss, leaves(p))))}


def hold_grads_to_one_device(ranks, cfg, shape, want) -> None:
    """Each rank's first gradient (``tests/_torch_mesh.py``'s
    ``partitioned_grads``) against the same slices of the one-device
    gradient ``want`` (:func:`one_device_grads`), every leaf within
    ``GRAD_BAR`` of the one-device leaf's largest |value|; the ranks' mean
    loss (each its rows' mean) against the one-device loss."""
    sizes = dict(zip(("data", "model"), shape))
    model = Model(cfg, params={})
    specs = dict(zip(want["grads"], tree_specs(model.axes(),
                                               model.abstract(), sizes)))
    bar = GRAD_BAR[cfg.family]
    assert sum(r["loss"] for r in ranks) / len(ranks) == pytest.approx(
        want["loss"], rel=LOSS_RTOL)
    for r in ranks:
        assert r["route"] == "partitioned"
        assert r["grads"].keys() == want["grads"].keys()
        for k, g in r["grads"].items():
            w = want["grads"][k]
            torch.testing.assert_close(
                g, shard_view(w, specs[k], sizes, r["coords"]), rtol=0,
                atol=bar * float(w.abs().max()), msg=k)


@pytest.fixture(scope="module")
def run(dots_proc):
    """Per capacity factor the JAX and one-device steps, and the one-device
    first gradient from ``GRAD_SEED``'s draw; per mesh one spawn whose
    ranks run both capacity factors' steps and first gradients."""
    toks = _batches(_configs(ARCH, 4.0)[1].vocab_size)
    batches = [{"tokens": torch.from_numpy(t)} for t in toks]
    out, cases, grad_cases = {}, {}, {}
    for name, cf in CAPACITY.items():
        jcfg, cfg = _configs(ARCH, cf)
        out[name] = _one_device(jcfg, cfg, toks)
        cases[name] = (cfg, out[name]["params"])
        grad_cases[name] = (cfg, _f32_pair(jcfg, GRAD_SEED)[1])
        out[name]["first_grads"] = one_device_grads(*grad_cases[name],
                                                    batches[0])
    out["meshes"] = {shape: spawn_ranks(
        tm.steps_of_cases, shape[0] * shape[1], shape, cases, batches, OPT,
        grad_cases, backend="gloo", device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        for shape in MESHES}
    return out


@pytest.mark.parametrize("cf", list(CAPACITY))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_mla_steps_match_one_device_and_jax(run, shape, cf):
    ranks = [r[cf] for r in run["meshes"][shape]]
    assert {r["route"] for r in ranks} == {"partitioned"}
    _hold_to_one_device(ranks, run[cf])


@pytest.mark.parametrize("cf", list(CAPACITY))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_mla_first_gradient_matches_one_device(run, shape, cf):
    hold_grads_to_one_device([r["grads"][cf] for r in run["meshes"][shape]],
                             _configs(ARCH, CAPACITY[cf])[1], shape,
                             run[cf]["first_grads"])


@pytest.mark.parametrize("cf", list(CAPACITY))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_gradient_frees_its_params(run, shape, cf):
    """Once the step's graph is dropped and another step has run, no shard
    the first read stays alive."""
    for r in run["meshes"][shape]:
        assert r["grads"][cf]["shards_alive"] == 0


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_each_rank_holds_its_heads_latent_and_experts(run, shape):
    """The leaves' shapes on each rank: the query heads, the latent rank,
    the routed experts and the shared experts' columns divided over
    "model"; ``w_kr`` and ``w_uk``'s heads whole; at (2, 2) the embed dim
    halved over "data" (FSDP)."""
    cfg = _configs(ARCH, 4.0)[1]
    n, d = shape[1], cfg.d_model // shape[0]
    r, H = cfg.kv_lora_rank, cfg.n_heads
    want = {
        "blocks/attn/wq": (cfg.n_layers, d, H // n, cfg.qk_nope_dim
                           + cfg.qk_rope_dim),
        "blocks/attn/wo": (cfg.n_layers, H // n, cfg.v_head_dim,
                           cfg.d_model // shape[0]),
        "blocks/attn/w_dkv": (cfg.n_layers, d, r // n),
        "blocks/attn/kv_norm": (cfg.n_layers, r // n),
        "blocks/attn/w_uk": (cfg.n_layers, r // n, H, cfg.qk_nope_dim),
        "blocks/attn/w_kr": (cfg.n_layers, d, cfg.qk_rope_dim),
        "blocks/mlp/w_up": (cfg.n_layers, cfg.n_experts // n, d, cfg.d_ff),
        "blocks/mlp/shared_up": (cfg.n_layers, d,
                                 cfg.d_ff * cfg.n_shared_experts // n),
    }
    for rank in run["meshes"][shape]:
        held = rank["cf4"]["shapes"]
        for leaf, shp in want.items():
            assert held[leaf] == shp, leaf


# ------------------------------------------------------------- the work

@pytest.fixture(scope="module")
def jax_dots(dots_proc):
    return read_jax_dots(dots_proc)


def _never_gathers(monkeypatch):
    def gather(*a, **k):
        raise AssertionError("the partitioned step gathered a whole leaf")
    monkeypatch.setattr(collectives, "gather", gather)
    monkeypatch.setattr(steps, "gather", gather)


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_rank0_product_flops_are_the_jax_per_device_dots(jax_dots, shape,
                                                         monkeypatch):
    """At the binding capacity factor, with ``collectives.gather`` (the
    replicated route's gather of the tree) made to raise."""
    _never_gathers(monkeypatch)
    _, cfg = _configs(ARCH, CAPACITY["cf1.25"])
    cell = dataclasses.replace(SHAPES["train_4k"], global_batch=B, seq_len=S)
    fn, args = steps.build_cell(cfg, cell, mesh=dict(zip(("data", "model"),
                                                         shape)))
    assert fn.compute == "partitioned"
    with OpCost(inputs=args) as oc:
        fn(*args)
    got = sum(oc.summary()["product_flops_by_dtype"].values())
    assert got == pytest.approx(jax_dots[_ids(shape)]["dots"],
                                rel=FLOPS_VS_HLOCOST_RTOL)
