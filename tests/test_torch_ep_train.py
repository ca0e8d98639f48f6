"""The MoE family's partitioned train step (experts over "model") and the
JAX program's dispatch groups on every mesh route, against the JAX package
and the one-device step.

**The partitioned route.**  On the smoke qwen3-moe (8 experts, top-2) with
f32 params drawn by JAX (``bridge``) and batches from numpy, ``gloo`` CPU
ranks (``tests/_torch_mesh.py``'s rank functions, one torch thread each)
take three steps at (data, model) = (1, 2) and (2, 2), at the smoke
capacity factor (4.0: nothing drops) and at 1.25, where the capacity binds
and a token's output depends on its dispatch group.  Losses and params are
held to the jitted one-device JAX step and the port's one-device step at
``tests/test_torch_elastic.py``'s bars (measured: losses within 2.2e-7
relative of the one-device step, 1 element of 822,016 beyond
``PARAM_ATOL``).  Each rank holds E / |model| experts of every routed leaf
and of the router.  Rank 0's product FLOPs of the train cell (B 4 x S 32),
counted on ``meta`` at a mesh given as sizes, against the dot FLOPs of
``HloCost`` on the JAX cell's per-device program at the same debug mesh
(8 host devices in a subprocess), within ``FLOPS_VS_HLOCOST_RTOL``:
measured 1.0000 at (1, 2) and 0.967 at (2, 2), where the replicated route
read 2.0.  That program has no all-to-all at either mesh: GSPMD keeps the
tokens whole over "model" and cuts the experts, as the port does.

**The groups on a mesh of batch ranks and the mesh prefill.**  A rank's
rows must dispatch in the global batch's groups: DeepSeek-V2-Lite's smoke
(MLA-MoE, replicated when this was written, partitioned since) at (2, 1)
and capacity factor 1.25, three train steps and a prefill, against the
one-device JAX step and prefill.
Before the repair each rank grouped its own rows alone (32 groups of 2
tokens where the JAX program has 16 of 4 per rank): losses 4.2e-3 apart.
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

import _torch_mesh as tm
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_fn as jax_make_train_fn
from repro.models import Model as JaxModel
from repro.models import transformer as jtfm
from repro.optim import AdamW as JaxAdamW
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.sharding import spec_shards
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.steps import (batch_part, build_cell, compute_route,
                                      make_train_fn, rank_model)
from repro_torch.models import Model
from repro_torch.models.moe import rank_groups
from repro_torch.optim import AdamW
from repro_torch.roofline.op_cost import OpCost
from repro_torch.tree import leaves, tree_map
from test_torch_dryrun import FLOPS_VS_HLOCOST_RTOL
from test_torch_elastic import (JAX_RTOL, LOSS_RTOL, OPT, PARAM_ATOL,
                                PARAM_SHARE)

ARCH = "qwen3-moe-30b-a3b"
MLA_ARCH = "deepseek-v2-lite-16b"
B, S, STEPS = 4, 32, 3
PARAM_CAP = 2 * OPT["lr"] * STEPS
MESHES = [(1, 2), (2, 2)]
CAPACITY = {"cf4": 4.0, "cf1.25": 1.25}   # the smoke config's, and binding
SPAWN_TIMEOUT_S = 300


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(shape):
    return "x".join(map(str, shape))


def _configs(arch, cf):
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(),
                               capacity_factor=cf)
    return jcfg, get_config(arch).smoke().with_(capacity_factor=cf)


def _batches(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (B, S)).astype(np.int32)
            for _ in range(STEPS)]


def _one_device(jcfg, cfg, toks, seed=1):
    """f32 params drawn by JAX, and STEPS steps of the jitted JAX step and
    of the port's one-device step from them."""
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JaxModel(jcfg).init(jax.random.PRNGKey(seed)))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
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
    return dict(params=params, jax_loss=jl, jax_params=jp, one_loss=pl,
                one_params=p)


@pytest.fixture(scope="module")
def run():
    """Per capacity factor the JAX and one-device steps; per mesh one
    spawn whose ranks run both capacity factors' steps."""
    toks = _batches(get_config(ARCH).smoke().vocab_size)
    out, cases = {}, {}
    for name, cf in CAPACITY.items():
        jcfg, cfg = _configs(ARCH, cf)
        out[name] = _one_device(jcfg, cfg, toks)
        cases[name] = (cfg, out[name]["params"])
    batches = [{"tokens": torch.from_numpy(t)} for t in toks]
    out["meshes"] = {shape: spawn_ranks(
        tm.steps_of_cases, shape[0] * shape[1], shape, cases, batches, OPT,
        backend="gloo", device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        for shape in MESHES}
    return out


def _apart(a_tree, b_leaves) -> tuple[float, float]:
    """(largest |a - b|, share of elements apart by more than PARAM_ATOL)."""
    d = np.concatenate([np.abs(a.detach().numpy() - np.asarray(
        b.detach() if isinstance(b, torch.Tensor) else b)).ravel()
        for a, b in zip(leaves(a_tree), b_leaves)])
    return float(d.max()), float((d > PARAM_ATOL).mean())


def _hold_to_one_device(ranks, want):
    for r in ranks:   # every rank reads the same averaged loss
        assert r["losses"] == ranks[0]["losses"]
        assert r["held_bytes"] == r["per_device_bytes"]
    got = ranks[0]["losses"]
    np.testing.assert_allclose(got, want["one_loss"], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got, want["jax_loss"], rtol=JAX_RTOL, atol=0)
    whole = ranks[0]["params"]
    for other in (leaves(want["one_params"]),
                  jax.tree.leaves(want["jax_params"])):
        worst, share = _apart(whole, other)
        assert worst < PARAM_CAP and share <= PARAM_SHARE, (worst, share)


@pytest.mark.parametrize("cf", list(CAPACITY))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_moe_steps_match_one_device_and_jax(run, shape, cf):
    ranks = [r[cf] for r in run["meshes"][shape]]
    assert {r["route"] for r in ranks} == {"partitioned"}
    _hold_to_one_device(ranks, run[cf])


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_no_rank_holds_every_expert(run, shape):
    """Each rank's routed leaves and router hold E / |model| experts, its
    attention its heads: at (2, 2) also half of ``embed`` (FSDP)."""
    cfg = get_config(ARCH).smoke()
    E, n = cfg.n_experts, shape[1]
    for r in run["meshes"][shape]:
        held = r["cf4"]["shapes"]
        for leaf in ("w_gate", "w_up", "w_down"):
            assert held[f"blocks/mlp/{leaf}"][1] == E // n
        router = held["blocks/mlp/router"]
        assert router[2] == E // n and router[1] == cfg.d_model // shape[0]


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

    cfg = dataclasses.replace(get_config(%r).smoke(), capacity_factor=%r)
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
        out[f"{d}x{m}"] = {"dots": whole - rest,
                           "all_to_all": txt.count("all-to-all")}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_dots():
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_DOTS % (ARCH, CAPACITY["cf1.25"], B, S,
                                           MESHES)],
        env=env, capture_output=True, text=True, timeout=480)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_rank0_product_flops_are_the_jax_per_device_dots(jax_dots, shape):
    """At the binding capacity factor; the JAX program moves no token with
    an all-to-all at these meshes, so the port adds none."""
    _, cfg = _configs(ARCH, CAPACITY["cf1.25"])
    cell = dataclasses.replace(SHAPES["train_4k"], global_batch=B, seq_len=S)
    fn, args = build_cell(cfg, cell, mesh=dict(zip(("data", "model"),
                                                   shape)))
    assert fn.compute == "partitioned"
    with OpCost(inputs=args) as oc:
        fn(*args)
    s = oc.summary()
    got = sum(s["product_flops_by_dtype"].values())
    want = jax_dots[_ids(shape)]
    assert got == pytest.approx(want["dots"], rel=FLOPS_VS_HLOCOST_RTOL)
    assert want["all_to_all"] == 0 and "all-to-all" not in s[
        "collective_counts"]


def test_meta_and_cpu_ranks_count_alike():
    """The (1, 2) MoE train cell counted on each CPU rank and on ``meta``
    at the mesh's sizes (rank 0's): FLOPs by dtype, bytes, collectives,
    kernel charges and the peak of live bytes, equal."""
    _, cfg = _configs(ARCH, CAPACITY["cf1.25"])
    cell = dataclasses.replace(SHAPES["train_4k"], global_batch=B, seq_len=S)
    fn, args = build_cell(cfg, cell, mesh={"data": 1, "model": 2})
    with OpCost(inputs=args) as oc:
        fn(*args)
    want = oc.summary()
    r0 = spawn_ranks(tm.count_train_cell, 2, (1, 2), cfg, cell,
                     backend="gloo", device="cpu",
                     timeout_s=SPAWN_TIMEOUT_S)[0]
    for k in ("flops_by_dtype", "product_flops_by_dtype",
              "hbm_bytes_per_device", "collective_bytes_per_device",
              "collective_counts", "kernel_charges", "peak_live_bytes"):
        assert r0[k] == want[k], k


# ---------------------------------------------- the global dispatch groups

@pytest.fixture(scope="module")
def mla():
    """DeepSeek-V2-Lite's smoke at capacity factor 1.25: the JAX and
    one-device steps, and a (2, 1) spawn of its steps and mesh prefill."""
    jcfg, cfg = _configs(MLA_ARCH, CAPACITY["cf1.25"])
    toks = _batches(cfg.vocab_size)
    out = _one_device(jcfg, cfg, toks, seed=2)
    batches = [{"tokens": torch.from_numpy(t)} for t in toks]
    out["steps"] = [r["c"] for r in spawn_ranks(
        tm.steps_of_cases, 2, (2, 1), {"c": (cfg, out["params"])}, batches,
        OPT, backend="gloo", device="cpu", timeout_s=SPAWN_TIMEOUT_S)]
    out["prefill"] = spawn_ranks(
        tm.mesh_prefill, 2, (2, 1), cfg, out["params"],
        torch.from_numpy(toks[0]), S, backend="gloo", device="cpu",
        timeout_s=SPAWN_TIMEOUT_S)
    out["jcfg"], out["tokens"] = jcfg, toks[0]
    return out


def test_replicated_route_uses_the_global_groups(mla):
    """Named when the MLA-MoE train step was replicated; it has been
    partitioned since (the replicated train step takes no config with
    experts), and this holds that a batch rank's rows still dispatch in the
    global batch's groups."""
    assert {r["route"] for r in mla["steps"]} == {"partitioned"}
    _hold_to_one_device(mla["steps"], mla)


def test_mesh_prefill_uses_the_global_groups(mla):
    """Each rank's argmax tokens and cache rows against the one-device JAX
    prefill of the whole batch (f32 params; both caches are bf16, so the
    bar is one bf16 unit in the last place: measured 3 of 4,096 elements of
    a layer's latent one unit apart, none further)."""
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(),
                                            mla["params"]))
    logits, cache = jtfm.prefill(jp, jnp.asarray(mla["tokens"]),
                                 mla["jcfg"], S)
    want_tok = np.asarray(jnp.argmax(logits, -1))
    rows = B // 2
    for r, got in enumerate(mla["prefill"]):
        sl = slice(r * rows, (r + 1) * rows)
        assert got["tokens"].numpy().tolist() == want_tok[sl].tolist()
        for name in ("c", "r"):
            w = np.asarray(cache[name], np.float32)[:, sl]
            g = got["cache"][name].float().numpy()
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7,
                                       atol=2e-5 * np.abs(w).max(),
                                       err_msg=name)


def test_groups_divide_at_the_jax_meshes():
    """Every MoE cell of the JAX ``single`` (16 x 16) and ``multi`` (2 x 16
    x 16) meshes: the global batch's 32 groups divide over its batch ranks
    (16 and 32), so every rank runs whole groups; a cut that does not
    divide raises, naming the config."""
    for arch in (ARCH, MLA_ARCH):
        cfg = get_config(arch)
        for shape in ("train_4k", "prefill_32k"):
            sh = SHAPES[shape]
            for sizes, n in (({"data": 16, "model": 16}, 16),
                             ({"pod": 2, "data": 16, "model": 16}, 32)):
                part = batch_part(sh.global_batch, sizes)
                assert spec_shards((part,), sizes) == n
                tokens = sh.global_batch * sh.seq_len
                assert rank_groups(tokens, cfg.moe_groups, n) * n == 32
                rows = rank_model(Model(cfg, params={}), tokens, n)
                assert rows.cfg.moe_groups == 32 // n
    with pytest.raises(ValueError, match=ARCH):   # 8 groups over 16 ranks
        rank_model(Model(get_config(ARCH), params={}), 40, 16)


def test_one_device_and_decode_keep_their_groups():
    """Without a mesh, and on one batch rank, the model is the config's
    own: the serving engine and decode call ``moe_ffn`` as before."""
    model = Model(get_config(ARCH).smoke(), params={})
    assert rank_model(model, B * S, 1) is model
    assert compute_route(model.cfg, "decode", {"data": 2, "model": 2}) == (
        "replicated")
    assert compute_route(model.cfg, "train", {"data": 2, "model": 2}) == (
        "partitioned")
