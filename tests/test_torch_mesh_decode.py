"""The MoE families' decode step on a mesh dispatches in the global batch's
groups (``launch.steps.make_decode_fn``, ``rank_model``), against the
jitted one-device JAX ``decode_step``.

Each MoE config's smoke (Qwen3-30B-A3B's and DeepSeek-V2-Lite's: 8 routed
experts, top-2) at capacity factor 1.25 with ``moe_groups`` 2: a decode
step of B 8 rows has 8 tokens, which the JAX program cuts into 2 groups of
4 at capacity 2 each.  On a (2, 1) mesh (two ``gloo`` CPU ranks,
``tests/_torch_mesh.py``'s ``mesh_decode``) each rank holds 4 rows: one
global group, at its capacity.  A rank that grouped its 4 tokens alone
would make gcd(4, 2) = 2 groups of 2 at capacity 1, and drop picks the
global groups keep (the last test shows its logits move).  From a JAX
prefill's cache of a 16-token prompt (f32 params drawn by JAX, an f32
cache), three decode steps: each rank's argmax tokens equal to the JAX
steps' rows and its logits within 2e-5.  (Over a bf16 cache the decode's
attention casts its probabilities to bf16, and one of them that f32
rounding moves across a bf16 rounding boundary moves its row's logits by
~1e-3, on one device as on the mesh.)
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh as tm
from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import transformer as jtfm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import Model

ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")
MOE = dict(capacity_factor=1.25, moe_groups=2)
B, P, STEPS = 8, 16, 3
MESH = (2, 1)
TOL = dict(rtol=2e-5, atol=2e-5)
SPAWN_TIMEOUT_S = 300


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    """Per config: the JAX prefill's cache and the jitted JAX decode steps
    from it, and the (2, 1) mesh's steps from the same cache."""
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **MOE)
        cfg = get_config(arch).smoke().with_(**MOE)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                          JaxModel(jcfg).init(jax.random.PRNGKey(1)))
        params = params_from_jax(jax.tree.map(np.asarray, jp))
        rng = np.random.default_rng(3)
        prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
        max_len = P + STEPS + 1
        logits, cache = jtfm.prefill(jp, jnp.asarray(prompt), jcfg, max_len,
                                     cache_dtype=jnp.float32)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        start = ({k: torch.from_numpy(np.array(v)) for k, v in cache.items()},
                 torch.from_numpy(np.asarray(tok)))
        step = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))
        want = {"tokens": [], "logits": []}
        for _ in range(STEPS):
            logits, cache = step(jp, cache, tok)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            want["logits"].append(np.asarray(logits))
            want["tokens"].append(np.asarray(tok))
        ranks = spawn_ranks(tm.mesh_decode, MESH[0] * MESH[1], MESH, cfg,
                            params, *start, max_len, STEPS, backend="gloo",
                            device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        out[arch] = dict(cfg=cfg, params=params, start=start, want=want,
                         ranks=ranks)
    return out


def _rows(rank: int) -> slice:
    n = B // (MESH[0] * MESH[1])
    return slice(rank * n, (rank + 1) * n)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_decode_is_the_one_device_jax_decode(run, arch):
    r = run[arch]
    for rank, got in enumerate(r["ranks"]):
        rows = _rows(rank)
        for i in range(STEPS):
            assert got["tokens"][i].tolist() == (
                r["want"]["tokens"][i][rows].tolist()), (rank, i)
            np.testing.assert_allclose(got["logits"][i].numpy(),
                                       r["want"]["logits"][i][rows], **TOL,
                                       err_msg=f"rank {rank} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_grouping_its_rows_alone_differs(run, arch):
    """The capacity binds: one device decoding each rank's rows alone, in
    the groups those rows make by themselves (the step before the global
    groups), moves some logit beyond the bar."""
    r = run[arch]
    model = Model(r["cfg"], params={})
    cache, tok = r["start"]
    worst = 0.0
    for rank in range(MESH[0] * MESH[1]):
        rows = _rows(rank)
        c = {k: v[:, rows].clone() if k != "cur_len" else v[rows].clone()
             for k, v in cache.items()}
        t = tok[rows]
        with torch.no_grad():
            for i in range(STEPS):
                logits, c = model.decode_step(r["params"], c, t)
                want = r["want"]["logits"][i][rows]
                worst = max(worst, float(np.max(np.abs(logits.numpy() - want)
                                                / (TOL["atol"] + TOL["rtol"]
                                                   * np.abs(want)))))
                t = torch.from_numpy(r["want"]["tokens"][i][rows])
    assert worst > 1.0, worst
