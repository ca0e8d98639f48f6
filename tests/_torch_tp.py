"""Rank functions of the port's tensor-parallel checks, shared by
``tests/test_torch_tp.py`` (ranks on the CPU), ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` (ranks on the card).

``launch.mesh.spawn_ranks`` starts each rank in a fresh process that
imports its function by name, so they live here and not in a test module
(which imports JAX) or in ``chip_smoke.py``'s ``__main__``.  Nothing here
imports JAX.
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import Model
from repro_torch.serving import PagedServingEngine, recover_engine
from repro_torch.serving.engine import shard_model


def drain(eng, cap: int = 10_000) -> None:
    for _ in range(cap):
        eng.step()
        if not eng.has_work():
            return
    raise AssertionError("engine did not drain")


def serve_stream(model, requests, device, mesh=None, audit=False, **kw) -> dict:
    """One engine over ``requests`` to completion: its tokens (in request
    order), ``metrics()``, whether its pools shard and their shape, and the
    q and kv heads of ``model``'s ``wq`` / ``wk`` (what the rank holds)."""
    attn = model.params["blocks"]["attn"]
    heads = (attn["wq"].shape[2], attn["wk"].shape[2])
    eng = PagedServingEngine(model, device=device, mesh=mesh, **kw)
    rids = [eng.submit(p, n) for p, n in requests]
    drain(eng)
    eng.pool.check_invariants()
    if audit:
        eng.audit()
    return {"tokens": [eng.finished[r] for r in rids],
            "metrics": eng.metrics(), "pool_sharded": eng._pool_sharded,
            "pool_shape": tuple(eng.k_pools.shape), "model_heads": heads}


def recovery_stream(model, requests, device, root, steps, mesh=None,
                    **kw) -> dict:
    """The unkilled run's tokens, and those of a run killed after ``steps``
    dispatches (journal under ``root``) and recovered: ``recover_engine``
    drains it, ``audit()`` passes."""
    want = serve_stream(model, requests, device, mesh, **kw)["tokens"]
    root = Path(root)
    if mesh is None or mesh.get_local_rank("model") == 0:
        shutil.rmtree(root, ignore_errors=True)
    eng = PagedServingEngine(model, journal_dir=root, device=device,
                             mesh=mesh, **kw)
    rids = [eng.submit(p, n) for p, n in requests]
    for _ in range(steps):
        eng.step()
    eng.journal.close()
    del eng
    eng, report = recover_engine(model, root, mesh=mesh, device=device, **kw)
    drain(eng)
    eng.audit()
    return {"tokens": [eng.finished[r] for r in rids], "unkilled": want,
            "report": {k: v for k, v in report.items()
                       if k != "recovery_wall_s"},
            "pool_sharded": eng._pool_sharded,
            "metrics": {k: v for k, v in eng.metrics().items()
                        if k != "recovery"}}


def run_cases(rank, device, cases: dict) -> dict:
    """Rank function: each case of ``cases`` ({name: case}) on this rank's
    mesh (``make_serving_mesh`` over the spawned group); returns {name:
    result}.  A case is ``dict(kind="wrappers", inputs=wrapper_case(...),
    q_offset=...)`` (``wrapper_outputs``) or ``dict(cfg=..., params=...
    (CPU tensors, moved to ``device``), requests=..., engine_kw=...)``
    through ``serve_stream``, or with ``recovery=(root, steps)`` through
    ``recovery_stream``."""
    n = torch.distributed.get_world_size()
    mesh = make_serving_mesh(n, device.type)
    out = {}
    for name, case in cases.items():
        if case.get("kind") == "wrappers":
            out[name] = wrapper_outputs(rank, device, mesh, case["inputs"],
                                        case.get("q_offset", 0))
            continue
        model = Model(case["cfg"], _to(case["params"], device))
        if "recovery" in case:   # the engines slice the whole model
            root, steps = case["recovery"]
            out[name] = recovery_stream(model, case["requests"], device,
                                        root, steps, mesh,
                                        **case["engine_kw"])
        else:                    # the rank's model holds its heads alone
            out[name] = serve_stream(shard_model(model, mesh),
                                     case["requests"], device, mesh,
                                     **case["engine_kw"])
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def wrapper_case(seed: int = 0, B: int = 3, H: int = 16, Kh: int = 8,
                 D: int = 32, T: int = 8, n_pages: int = 20, P: int = 4,
                 Sq: int = 24) -> dict:
    """The inputs of ``tests/test_sharded_serving.py``'s direct kernel
    check, from numpy at ``seed``: paged q (B, H, D), pools, tables and
    lengths; flash q (B, Sq, H, D), k / v (B, Sq, Kh, D)."""
    rng = np.random.default_rng(seed)
    f = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("q", (B, H, D)), ("kp", (n_pages, T, Kh, D)),
        ("vp", (n_pages, T, Kh, D)))}
    f["bt"] = rng.integers(0, n_pages, size=(B, P)).astype(np.int32)
    f["lens"] = np.array([5, 17, 26][:B], np.int32)
    for k, s in (("qf", (B, Sq, H, D)), ("kf", (B, Sq, Kh, D)),
                 ("vf", (B, Sq, Kh, D))):
        f[k] = rng.standard_normal(s).astype(np.float32)
    return f


def local_heads(t, dim: int, rank: int, n: int):
    """Rank ``rank``'s slice of ``n`` equal parts of ``t``'s ``dim``."""
    step = t.shape[dim] // n
    return t.narrow(dim, rank * step, step).contiguous()


def wrapper_outputs(rank, device, mesh, case: dict,
                    q_offset: int = 0) -> dict:
    """This rank's heads of ``case`` (``wrapper_case``) through
    ``ops.paged_attention_sharded`` and ``ops.flash_attention_sharded``
    (all query rows, and the rows from ``q_offset`` on), and the
    ``gather_heads`` of each; numpy results."""
    n = mesh.size()
    t = {k: torch.from_numpy(v).to(device) for k, v in case.items()}
    q, kp, vp = (local_heads(t[k], d, rank, n)
                 for k, d in (("q", 1), ("kp", 2), ("vp", 2)))
    qf, kf, vf = (local_heads(t[k], 2, rank, n) for k in ("qf", "kf", "vf"))
    out = {"paged": ops.paged_attention_sharded(q, kp, vp, t["bt"],
                                                t["lens"], mesh=mesh),
           "flash": ops.flash_attention_sharded(qf, kf, vf, mesh=mesh),
           "flash_offset": ops.flash_attention(
               qf[:, q_offset:], kf, vf, causal=True, q_offset=q_offset,
               mesh=mesh)}
    for k in list(out):
        out[f"{k}_gathered"] = ops.gather_heads(out[k], mesh)
    return {k: v.cpu().numpy() for k, v in out.items()}


def wrapper_costs(rank, device, case: dict) -> dict:
    """``wrapper_outputs`` of ``case`` under an ``OpCost``: its summary, and
    the bytes of the three gathered outputs."""
    from repro_torch.roofline.op_cost import OpCost
    mesh = make_serving_mesh(torch.distributed.get_world_size(), device.type)
    with OpCost() as oc:
        out = wrapper_outputs(rank, device, mesh, case)
    return {"summary": oc.summary(),
            "gathered_bytes": sum(v.nbytes for k, v in out.items()
                                  if k.endswith("_gathered"))}


def fail_on_rank(rank, device, bad: int) -> int:
    """Rank function that raises on rank ``bad``."""
    if rank == bad:
        raise RuntimeError(f"rank {rank} fails on purpose")
    return rank


def hang_on_rank(rank, device, bad: int) -> int:
    """Rank function whose rank ``bad`` waits at a barrier the others never
    reach (they sleep)."""
    if rank == bad:
        torch.distributed.barrier()
    else:
        time.sleep(3600)
    return rank
