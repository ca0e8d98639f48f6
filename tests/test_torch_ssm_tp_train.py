"""The SSM and hybrid families' partitioned train step (Mamba2's and
Zamba2's smoke) against the JAX package and the one-device step, and the
train step's route for every family.

On each smoke config with f32 params drawn by JAX (``bridge``) and batches
from numpy, ``gloo`` CPU ranks (``tests/_torch_mesh.py``'s rank functions,
one torch thread each) take three steps at (data, model) = (1, 2) and (2,
2), held to the jitted one-device JAX step and the port's one-device step
at ``tests/test_torch_elastic.py``'s bars.  A rank holds its SSM channels
(``in_z`` / ``in_x`` / ``conv_x`` / ``gate_norm`` / ``out_proj``), heads
(``in_dt``, ``A_log``, ``dt_bias``, ``D``) and B / C columns (``in_bc`` /
``conv_bc`` on their 2N: B on rank 0 and C on rank 1 at |model| 2).

Zamba2's steps run its smoke config cut to one SSM layer and the shared
block after it (``attn_period`` 1).  Deeper, the random stack carries
rounding to the loss (``tests/test_torch_families.py``'s hybrid bar): at
the smoke's 4 layers the port's own one-device step reads 9.7e-4 of the
JAX step's third loss and 30% of the params beyond ``PARAM_ATOL``, so no
route of it holds these bars; at 2 layers and ``attn_period`` 1, from
``PRNGKey(1)``, the first gradient of one element of the shared block's
``wk`` is 2.4e-7 (3.5e-6 of the leaf's largest) and the mesh's rounds to
the other sign, AdamW (whose update does not scale with the gradient)
steps it by lr the other way, and the third losses part by 3.7e-4.  At
one layer, draws 1-5 all hold the bars: measured from ``PRNGKey(1)``,
losses within 1.6e-6 relative of the one-device step and 0.002% of the
elements beyond ``PARAM_ATOL``; Mamba2's (2 layers) within 3.5e-7 and
0.001%.

So the depth is held by the first step's gradient, which does not go
through AdamW's sign: from the same draw, on Mamba2's smoke, on Zamba2's
smoke (4 layers: two uses of the shared block, whose gradient autograd
sums over them) and on Zamba2's at 5 layers (a tail layer after the two
groups), each rank's gradient shards, the shared block's among them, are
held leaf by leaf to the one-device step's within ``GRAD_BAR`` of the
leaf's largest (``tests/test_torch_families.py``'s bar for the family).

Work: rank 0's product FLOPs of each smoke train cell (B 4 x S 32),
counted on ``meta`` at a mesh given as sizes, against the dot FLOPs of
``HloCost`` on the JAX cell's per-device program (8 host devices in a
subprocess per config), within ``FLOPS_VS_HLOCOST_RTOL``; the step never
gathers the parameter tree.  At (2, 2) the JAX program contracts the SSM's
projections over the embed dim "data" cuts, on every "data" rank's rows,
and so runs the SSD scan on all of them and keeps its own rows' result:
the same values at |data| times the scan's work.  The port scans its own
rows, so the JAX scan's repeated share is taken out of the expected dots:
it is what the port's count gains when each of its scans also runs the
other "data" ranks' rows.  Measured at (2, 2): rank 0 reads 0.930 (Mamba2)
/ 0.932 (Zamba2) of JAX's dots, and 1.0104 / 0.9880 of them less that
share; at (1, 2) 1.0003 / 1.0002.
"""

import dataclasses

import pytest
import torch

import _torch_mesh as tm
from repro.configs import get_config as jax_get_config
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.partition import Partition
from repro_torch.launch import steps
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import Model
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.roofline.op_cost import OpCost
from test_torch_dryrun import FLOPS_VS_HLOCOST_RTOL
from test_torch_elastic import OPT
from test_torch_ep_train import (MESHES, SPAWN_TIMEOUT_S, _batches,
                                 _hold_to_one_device, _ids, _one_device)
from test_torch_families import _f32_pair
from test_torch_mla_tp_train import (_never_gathers, hold_grads_to_one_device,
                                     one_device_grads, read_jax_dots,
                                     start_jax_dots)

B, S = 4, 32
# the steps' configs over the smoke ones (module docstring)
ARCHS = {"mamba2-1.3b": {}, "zamba2-7b": {"n_layers": 1, "attn_period": 1}}
# the first gradients' configs: (arch, over the smoke one)
GRAD_CASES = {"mamba2-1.3b": ("mamba2-1.3b", {}),
              "zamba2-7b": ("zamba2-7b", {}),
              "zamba2-7b-tail": ("zamba2-7b", {"n_layers": 5})}
GRAD_SEED = 1   # the steps' draw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, kw=None):
    kw = ARCHS[arch] if kw is None else kw
    return (dataclasses.replace(jax_get_config(arch).smoke(), **kw),
            get_config(arch).smoke().with_(**kw))


def _grad_configs(case):
    return _configs(*GRAD_CASES[case])


@pytest.fixture(scope="module")
def dots_procs():
    """Each smoke config's JAX cell, started before the steps so that they
    run side by side."""
    procs = {arch: start_jax_dots(arch, 1.25) for arch in ARCHS}
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def run(dots_procs):
    """Per config the JAX and one-device steps, per gradient case the
    one-device first gradient; per mesh one spawn whose ranks run both
    configs' steps and every case's first gradient."""
    out, cases, grad_cases = {}, {}, {}
    for arch in ARCHS:
        jcfg, cfg = _configs(arch)
        toks = _batches(cfg.vocab_size)
        out[arch] = _one_device(jcfg, cfg, toks)
        out[arch]["batches"] = [{"tokens": torch.from_numpy(t)}
                                for t in toks]
        cases[arch] = (cfg, out[arch]["params"])
    batches = out["mamba2-1.3b"]["batches"]   # one vocabulary (smoke 512)
    assert all(torch.equal(b["tokens"], c["tokens"]) for b, c in zip(
        batches, out["zamba2-7b"]["batches"]))
    for case in GRAD_CASES:
        jcfg, cfg = _grad_configs(case)
        grad_cases[case] = (cfg, _f32_pair(jcfg, GRAD_SEED)[1])
        out[case] = out.get(case, {}) | {"first_grads": one_device_grads(
            *grad_cases[case], batches[0])}
    out["meshes"] = {shape: spawn_ranks(
        tm.steps_of_cases, shape[0] * shape[1], shape, cases, batches, OPT,
        grad_cases, backend="gloo", device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        for shape in MESHES}
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_ssm_steps_match_one_device_and_jax(run, shape, arch):
    ranks = [r[arch] for r in run["meshes"][shape]]
    assert {r["route"] for r in ranks} == {"partitioned"}
    _hold_to_one_device(ranks, run[arch])


def test_gradient_cases_reuse_the_shared_block_and_have_a_tail():
    """Zamba2's gradient cases run the shared block twice, and the second
    a tail layer after its groups."""
    for case, tail in (("zamba2-7b", 0), ("zamba2-7b-tail", 1)):
        cfg = _grad_configs(case)[1]
        uses = [i for kind, i in tfm._ssm_order(cfg) if kind == "attn"]
        assert uses == [0, 1]
        assert tfm._hybrid_split(cfg)[2] == tail


@pytest.mark.parametrize("case", list(GRAD_CASES))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_ssm_first_gradient_matches_one_device(run, shape, case):
    cfg = _grad_configs(case)[1]
    ranks = [r["grads"][case] for r in run["meshes"][shape]]
    if cfg.family == "hybrid":
        assert any(k.startswith("shared_attn/") for k in ranks[0]["grads"])
    hold_grads_to_one_device(ranks, cfg, shape, run[case]["first_grads"])


@pytest.mark.parametrize("case", list(GRAD_CASES))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_gradient_frees_its_params(run, shape, case):
    """Once the step's graph is dropped and another step has run, no shard
    the first read stays alive (the FSDP hooks' packed tensors once held
    an unused output's nodes, the scan's final state among them, and every
    shard with them)."""
    for r in run["meshes"][shape]:
        assert r["grads"][case]["shards_alive"] == 0


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_each_rank_holds_its_channels_heads_and_bc(run, shape, arch):
    """The SSM leaves' shapes on each rank (at (2, 2) the embed dim halved
    over "data"); the hybrid's shared block on its heads and columns."""
    cfg = _configs(arch)[1]
    n, d, L = shape[1], cfg.d_model // shape[0], cfg.n_layers
    di, H, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_heads, cfg.ssm_state
    want = {"blocks/ssm/in_x": (L, d, di // n),
            "blocks/ssm/in_dt": (L, d, H // n),
            "blocks/ssm/in_bc": (L, d, 2 * N // n),
            "blocks/ssm/conv_bc": (L, 4, 2 * N // n),
            "blocks/ssm/A_log": (L, H // n),
            "blocks/ssm/gate_norm": (L, di // n),
            "blocks/ssm/out_proj": (L, di // n, d)}
    if cfg.family == "hybrid":
        want.update({
            "shared_attn/attn/wq": (1, d, cfg.n_heads // n, cfg.hd),
            "shared_attn/mlp/w_up": (1, d, cfg.d_ff // n)})
    for rank in run["meshes"][shape]:
        held = rank[arch]["shapes"]
        for leaf, shp in want.items():
            assert held[leaf] == shp, leaf


# ------------------------------------------------------------- the work

@pytest.fixture(scope="module")
def jax_dots(dots_procs):
    return {arch: read_jax_dots(proc) for arch, proc in dots_procs.items()}


def _rank0_product_flops(cfg, shape) -> int:
    cell = dataclasses.replace(SHAPES["train_4k"], global_batch=B, seq_len=S)
    fn, args = steps.build_cell(cfg, cell, mesh=dict(zip(("data", "model"),
                                                         shape)))
    assert fn.compute == "partitioned"
    with OpCost(inputs=args) as oc:
        fn(*args)
    return sum(oc.summary()["product_flops_by_dtype"].values())


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_rank0_product_flops_are_the_jax_per_device_dots(jax_dots, shape,
                                                         arch, monkeypatch):
    """The port's count, and the JAX scan's repeated share (module
    docstring): the port's count again with every scan also run on the
    other "data" ranks' rows (stand-ins of the same shape), less the
    port's."""
    _never_gathers(monkeypatch)
    cfg = get_config(arch).smoke()
    got = _rank0_product_flops(cfg, shape)
    scan, n_data = ssm_mod.ssd_scan, shape[0]

    def every_data_rank(xh, dt, A, Bm, Cm, chunk):
        def rows(t):
            return torch.cat([t] * n_data)
        y, state = scan(rows(xh), rows(dt), A, rows(Bm), rows(Cm), chunk)
        return y[:xh.shape[0]], state[:xh.shape[0]]

    monkeypatch.setattr(ssm_mod, "ssd_scan", every_data_rank)
    repeated = _rank0_product_flops(cfg, shape) - got
    assert (repeated > 0) == (n_data > 1)
    assert got == pytest.approx(jax_dots[arch][_ids(shape)]["dots"]
                                - repeated, rel=FLOPS_VS_HLOCOST_RTOL)


# ------------------------------------------------------------ the routes

MESH_SIZES = [{"data": 2, "model": 1}, {"data": 1, "model": 2},
              {"data": 2, "model": 2}, {"data": 16, "model": 16},
              {"pod": 2, "data": 16, "model": 16}]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-1.3b",
                                  "zamba2-7b", "whisper-medium",
                                  "internvl2-76b"])
def test_train_route_of_each_family(arch):
    """The three families' train step is partitioned on any mesh of more
    than one rank; the encoder-decoder's and the VLM stub's (its patches)
    stay replicated, and ``Partition`` refuses them, naming the families
    it runs.  Every decode stays replicated."""
    cfg = get_config(arch)
    want = ("replicated" if cfg.family == "encdec" or cfg.n_patches
            else "partitioned")
    for sizes in MESH_SIZES:
        assert steps.compute_route(cfg, "train", sizes) == want
        assert steps.compute_route(cfg, "decode", sizes) == "replicated"
    if want == "replicated":
        with pytest.raises(ValueError, match="mla_moe, ssm and hybrid"):
            Partition(Model(cfg.smoke(), params={}), MESH_SIZES[1])
