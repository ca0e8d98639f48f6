"""The port's dry-run against the JAX package's: the shape grid and its
skips, the input specs, the parameter counts and the bytes of the
parameters, the optimiser state and the decode cache at full width (JAX's
``tree_bytes_per_device`` on a one-device mesh), every arch's smoke cells
through ``dryrun.run_cell`` (``ok`` or ``skipped``, never ``error``), the
same count on ``meta`` and on CPU tensors, and the port's FLOPs of a smoke
dense forward beside ``HloCost``'s of the JAX forward.  The JAX side runs on
the CPU (``JAX_PLATFORMS=cpu``)."""

import dataclasses
import json
import pkgutil
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable_shapes as j_applicable_shapes
from repro.configs import get_config as j_get_config
from repro.configs import skip_reason as j_skip_reason
from repro.distributed.sharding import tree_bytes_per_device
from repro.launch.mesh import make_debug_mesh
from repro.models import Model as JModel
from repro.models import input_specs as j_input_specs
from repro.optim import AdamW as JAdamW
from repro.roofline.hlo_cost import HloCost

import repro_torch
from repro_torch.configs import (ARCHS, SHAPES, applicable_shapes, get_config,
                                 skip_reason)
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_cell
from repro_torch.models import Model, input_specs
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamW
from repro_torch.roofline import report
from repro_torch.roofline.op_cost import OpCost
from repro_torch.tree import leaves

# the port's smoke dense forward counts 0.974-0.983 of HloCost's FLOPs of
# the JAX forward (qwen3 / granite / nemotron smoke at B 1-2 x S 64-128,
# measured on the CPU): XLA's fused elementwise ops count ~1 per element
# of every op inside a fusion, and eager PyTorch dispatches a few fewer
FLOPS_VS_HLOCOST_RTOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh1():
    return make_debug_mesh(1, 1)


def test_the_shape_grid_is_the_jax_one():
    assert {n: (s.name, s.seq_len, s.global_batch, s.kind)
            for n, s in SHAPES.items()} == {
        n: (s.name, s.seq_len, s.global_batch, s.kind)
        for n, s in J_SHAPES.items()}
    for n, s in SHAPES.items():
        j = J_SHAPES[n].scaled_for_smoke()
        assert (s.scaled_for_smoke().seq_len,
                s.scaled_for_smoke().global_batch) == (j.seq_len,
                                                       j.global_batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_shapes_and_skips_are_the_jax_ones(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert applicable_shapes(cfg) == j_applicable_shapes(jcfg)
    for shape in SHAPES:
        assert skip_reason(cfg, shape) == j_skip_reason(jcfg, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_the_jax_ones(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in SHAPES.items():
        specs, axes = input_specs(cfg, shape)
        jspecs, jaxes = j_input_specs(jcfg, J_SHAPES[name])
        assert axes == jaxes
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in specs.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in jspecs.items()}
        assert all(v.device.type == "meta" for v in specs.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_counts_and_bytes_are_the_jax_ones(arch, mesh1):
    """At the published width: parameter counts, and the bytes of the
    parameters, of AdamW's state and of the decode_32k cache equal JAX's
    ``tree_bytes_per_device`` on a one-device mesh exactly."""
    cfg, jm = get_config(arch), JModel(j_get_config(arch))
    m = Model(cfg, params={})
    assert m.n_params() == jm.n_params()
    assert m.n_active_params() == jm.n_active_params()
    p_abs, j_abs = m.abstract(), jm.abstract()
    assert all(t.device.type == "meta" for t in leaves(p_abs))
    assert dryrun.tree_bytes(p_abs) == tree_bytes_per_device(
        jm.axes(), j_abs, mesh1)
    o_abs, jo_abs = AdamW().abstract_state(p_abs), JAdamW().abstract_state(j_abs)
    assert o_abs.step.dtype == torch.int32 and o_abs.step.device.type == "cpu"
    for mine, theirs in ((o_abs.mu, jo_abs.mu), (o_abs.nu, jo_abs.nu)):
        assert all(t.dtype == torch.float32 and t.device.type == "meta"
                   for t in leaves(mine))
        assert dryrun.tree_bytes(mine) == tree_bytes_per_device(
            jm.axes(), theirs, mesh1)
    d = SHAPES["decode_32k"]
    c_abs, c_axes = jm.cache_spec(d.global_batch, d.seq_len)
    assert dryrun.cache_bytes(cfg, d.global_batch, d.seq_len) == (
        tree_bytes_per_device(c_axes, c_abs, mesh1))


@pytest.fixture(scope="module")
def smoke_cells(tmp_path_factory):
    """Every arch's smoke config at every shape scaled for smoke, through
    ``run_cell`` (on ``meta``), and each cell it counts counted again on
    CPU tensors (``build_cell(..., "cpu")`` under ``OpCost``)."""
    root = tmp_path_factory.mktemp("dryrun")
    cells = {}
    for arch in ARCHS:
        for shape in SHAPES:
            rec = dryrun.run_cell(arch, shape, root, smoke=True)
            cells[(arch, shape, "meta")] = rec
            if rec["status"] == "ok":
                fn, args = build_cell(get_config(arch).smoke(),
                                      SHAPES[shape].scaled_for_smoke(), "cpu")
                with OpCost(inputs=args) as oc:
                    fn(*args)
                cells[(arch, shape, "cpu")] = oc.summary()
    return cells


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_end_ok_or_skipped(arch, smoke_cells):
    for shape in SHAPES:
        rec = smoke_cells[(arch, shape, "meta")]
        assert rec["status"] in ("ok", "skipped"), rec.get("traceback")
        cfg = get_config(arch)
        if rec["status"] == "skipped":
            assert rec["skip_reason"] == (
                skip_reason(cfg, shape) or dryrun.VLM_PREFILL_REASON)
            continue
        assert rec["tag"] == "smoke" and rec["op_cost"]["flops_per_device"] > 0
        assert rec["n_params"] == Model(cfg.smoke(), params={}).n_params()
        kind = SHAPES[shape].kind
        assert ("opt_bytes_per_device" in rec) == (kind == "train")
        assert ("cache_bytes_per_device" in rec) == (kind != "train")
        # a prefill through the flash kernel charges it once per attention
        # layer (MLA and Mamba2 attend without it)
        charges = rec["op_cost"]["kernel_charges"]
        if kind == "prefill" and cfg.family in ("dense", "moe", "hybrid",
                                                "encdec"):
            assert charges["flash_attention"]["calls"] > 0
        else:
            assert charges == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_count_alike_on_meta_and_cpu(arch, smoke_cells):
    for shape in SHAPES:
        meta = smoke_cells[(arch, shape, "meta")]
        if meta["status"] != "ok":
            continue
        a, b = meta["op_cost"], smoke_cells[(arch, shape, "cpu")]
        for key in ("flops_by_dtype", "hbm_bytes_per_device",
                    "kernel_charges", "peak_live_bytes", "n_ops"):
            assert a[key] == b[key], (shape, key)


def test_vlm_prefill_is_skipped_with_the_port_reason(smoke_cells):
    rec = smoke_cells[("internvl2-76b", "prefill_32k", "meta")]
    assert rec["status"] == "skipped"
    assert "ROADMAP §3" in rec["skip_reason"]


def test_build_cell_hands_back_what_each_step_takes():
    cfg = get_config("qwen3-1.7b").smoke()
    sh = {k: s.scaled_for_smoke() for k, s in SHAPES.items()}
    fn, (params, state, batch) = build_cell(cfg, sh["train_4k"])
    assert all(p.requires_grad and p.device.type == "meta"
               for p in leaves(params))
    assert batch["tokens"].shape == (2, 128)
    fn, (params, batch) = build_cell(cfg, sh["prefill_32k"], "cpu")
    tok, cache = fn(params, batch)
    assert tok.shape == (2,) and tok.dtype == torch.int32
    assert cache["k"].shape == (2, 2, 128, 2, 32)
    fn, (params, cache, token) = build_cell(cfg, sh["decode_32k"], "cpu")
    assert int(cache["cur_len"][0]) == 127
    tok, cache = fn(params, cache, token)
    assert tok.shape == (2,) and int(cache["cur_len"][0]) == 128


def test_dense_forward_flops_beside_hlocost():
    B, S = 2, 128
    arch = "qwen3-1.7b"
    jm = JModel(j_get_config(arch).smoke())
    txt = jax.jit(lambda p, t: jm.forward(p, t)).lower(
        jm.abstract(), jax.ShapeDtypeStruct((B, S), jnp.int32)).compile(
        ).as_text()
    want = HloCost(txt).summary()["flops_per_device"]
    cfg = get_config(arch).smoke()
    with OpCost() as oc:
        tfm.forward(Model(cfg, params={}).abstract(),
                    torch.empty(B, S, dtype=torch.int32, device="meta"), cfg)
    got = oc.summary()["flops_per_device"]
    assert got == pytest.approx(want, rel=FLOPS_VS_HLOCOST_RTOL)


def test_report_renders_ok_skipped_and_error_rows(tmp_path):
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", tmp_path, smoke=True)
    skipped = dryrun.run_cell("qwen3-1.7b", "long_500k", tmp_path, smoke=True)
    err = dict(rec, shape="prefill_32k", status="error", error="boom")
    for r in (rec, skipped, err):
        r["tag"] = ""
    (tmp_path / "err.json").write_text(json.dumps(err))
    (tmp_path / "ok.json").write_text(json.dumps(rec))
    (tmp_path / "skip.json").write_text(json.dumps(skipped))
    table = report.markdown_table(report.load_cells("", tmp_path))
    lines = table.splitlines()
    assert lines[0].startswith("| arch | shape |") and len(lines) == 5
    assert any("| ERROR |" in ln for ln in lines)
    assert any("| skipped |" in ln for ln in lines)
    ok = next(ln for ln in lines if "decode_32k" in ln)
    t = report.term_seconds(rec)
    assert f"| {t['dominant']} |" in ok and ok.endswith("| yes |")
    assert t["memory_s"] == (rec["op_cost"]["hbm_bytes_per_device"]
                             / report.HBM_BYTES_PER_S)
    assert report.fmt_engineering(2.5e12) == "2.5T"


# the twin of tests/test_sharding.py::test_multidevice_dryrun_smoke: its
# archs and cells (train B 4 x 32, decode B 4 over 64) at a 2 x 2 x 2 mesh,
# here given as sizes (rank 0 counted on meta, no rank spawned)
MESH_2X2X2 = {"pod": 2, "data": 2, "model": 2}
MESH_CELLS = [(arch, name, B, S) for arch in ("qwen3-1.7b",
                                              "qwen3-moe-30b-a3b",
                                              "mamba2-1.3b")
              for name, B, S in (("train_4k", 4, 32), ("decode_32k", 4, 64))]


@pytest.mark.parametrize("arch,shape_name,B,S", MESH_CELLS,
                         ids=[f"{a}-{n}" for a, n, _, _ in MESH_CELLS])
def test_smoke_cells_at_a_2x2x2_mesh(arch, shape_name, B, S):
    """Each cell builds and counts (FLOPs > 0, the train cell's gradient
    all-reduce and parameter gathers as collective bytes > 0), and its
    per-device bytes are JAX's ``tree_bytes_per_device`` on the same
    mesh."""
    cfg, jm = get_config(arch).smoke(), JModel(j_get_config(arch).smoke())
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=B,
                                seq_len=S)
    fn, args = build_cell(cfg, shape, mesh=MESH_2X2X2)
    with OpCost(inputs=args) as oc:
        fn(*args)
    s = oc.summary()
    assert s["flops_per_device"] > 0 and s["hbm_bytes_per_device"] > 0
    assert s["collective_counts"]["all-gather"] > 0
    if shape.kind == "train":
        assert s["collective_bytes_per_device"]["all-reduce"] > 0
    fake = types.SimpleNamespace(axis_names=tuple(MESH_2X2X2),
                                 shape=MESH_2X2X2)
    got = dryrun.bytes_per_device(Model(cfg, params={}), shape, MESH_2X2X2)
    assert got["param_bytes_per_device"] == tree_bytes_per_device(
        jm.axes(), jm.abstract(), fake)
    if shape.kind == "train":
        assert got["opt_bytes_per_device"] == 2 * tree_bytes_per_device(
            jm.axes(), JAdamW().abstract_state(jm.abstract()).mu, fake)
    else:
        c_abs, c_axes = jm.cache_spec(B, S)
        assert got["cache_bytes_per_device"] == tree_bytes_per_device(
            c_axes, c_abs, fake)


def test_run_cell_records_the_jax_meshes(tmp_path):
    """A cell at ``single`` and ``multi`` carries the JAX record's
    ``mesh_shape`` and per-device keys; ``one`` is one card."""
    recs = {m: dryrun.run_cell("qwen3-1.7b", "train_4k", tmp_path,
                               smoke=True, mesh=m)
            for m in ("one", "single", "multi")}
    assert recs["one"]["mesh_shape"] == {"data": 1, "model": 1}
    assert recs["single"]["mesh_shape"] == {"data": 16, "model": 16}
    assert recs["multi"]["mesh_shape"] == {"pod": 2, "data": 16,
                                           "model": 16}
    for m, rec in recs.items():
        assert rec["status"] == "ok" and rec["mesh"] == m
        coll = rec["op_cost"]["total_collective_bytes"]
        assert (coll > 0) == (m != "one")
        assert rec["opt_bytes_per_device"] > 0


def test_run_cell_counts_again_a_record_of_another_mesh(tmp_path):
    """A record under the cell's name whose ``mesh_shape`` is not the
    mesh's (a one-card record once named ``single``) is not read back: the
    cell is counted again at its mesh, and that record is read back."""
    cid = dryrun.cell_id("qwen3-1.7b", "train_4k", "single", "smoke")
    (tmp_path / f"{cid}.json").write_text(json.dumps(
        {"status": "ok", "mesh": "single", "mesh_shape": dryrun.ONE}))
    rec = dryrun.run_cell("qwen3-1.7b", "train_4k", tmp_path, smoke=True,
                          mesh="single")
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["op_cost"]["total_collective_bytes"] > 0
    assert dryrun.run_cell("qwen3-1.7b", "train_4k", tmp_path, smoke=True,
                           mesh="single") == rec


def test_the_module_walk_holds_the_dry_run():
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")}
    assert {"repro_torch.roofline.op_cost", "repro_torch.roofline.report",
            "repro_torch.kernels.work",
            "repro_torch.launch.dryrun"} <= mods
