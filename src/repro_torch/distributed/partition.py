"""One rank's part of a train step on a mesh (the dense but the VLM stub's
with patches, MoE, MLA-MoE, SSM and hybrid families): the work the JAX
program's GSPMD partition gives each device, with the collectives written
out (``launch.steps.make_train_fn``'s partitioned route).

A :class:`Partition` reads every local size from the leaves' resolved
specs under ``DEFAULT_RULES`` (``tree_specs``), never from a per-arch
table: this rank's query heads, kv heads, MLP columns, experts, latent
rank, SSM channels, heads and B / C columns and vocabulary rows are the
slices its ``wq`` / ``wk`` / ``w_up`` / ``w_dkv`` / ``in_x`` / ``in_dt`` /
``in_bc`` / ``embed`` shards hold on "model" (the hybrid's attention and
MLP are its shared block's), and the residual stream's sequence is cut
over "model" where the rules cut ``seq_act``.  What the model's code does
with them
(``models.transformer``'s partitioned block, embedding and unembedding,
``models.model``'s vocab-parallel loss):

* **Tensor-parallel products over "model".**  ``wq`` / ``wk`` / ``wv`` and
  ``w_gate`` / ``w_up`` are column-parallel (this rank's heads or
  columns), ``wo`` and ``w_down`` row-parallel: their outputs are partial
  sums over "model", reduce-scattered in the activations' dtype.  A dim
  the resolver leaves whole (a head count or a vocabulary "model" does not
  divide) is computed whole on every rank, on the whole sequence, and only
  this rank's positions are kept.  Where the kv heads stay whole but the
  query heads are cut, a rank projects only the kv heads its query heads
  read, sliced from the whole ``wk`` / ``wv``.
* **Sequence-parallel activations.**  Between blocks the residual stream is
  this rank's slice of the sequence (the JAX ``_sp`` constraint): each
  block all-gathers its normed input along the sequence and
  reduce-scatters its attention and MLP outputs back; the norms run on the
  local slice.
* **Vocab-parallel embedding and loss.**  The lookup masks the rows outside
  this rank's vocabulary slice and reduce-scatters the partial embeddings
  onto the sequence slices (the JAX lookup's all-reduce, joined with the
  cut onto the sequence); the logits stay vocab-sharded and the loss is
  the JAX iota-mask form, all-reducing the max, the sum of exponentials and
  the label's logit as (B, S) values.
* **Expert parallelism over "model" (the MoE family).**  The rules cut
  the routed experts' ``w_gate`` / ``w_up`` / ``w_down`` and the router's
  columns over "model" on their expert dim, so a rank holds E / |model|
  experts with their whole ``ff``.  Its MoE block takes the normed input
  gathered along the sequence (every token of its rows), computes its
  experts' router logits and gathers them over "model" on the expert dim
  (the softmax and top-k run over all E, as the JAX program's do), keeps
  the picks of its experts in the JAX program's global dispatch groups
  (``models.moe.rank_groups``), runs its experts' products alone, and
  reduce-scatters its partial combine onto the sequence slices.  The JAX
  per-device program does the same: no all-to-all, the tokens whole over
  "model" and the experts cut (its expert dots are (E / |model|, rows of
  the rank's groups, ff)).  Shared experts (MLA-MoE) are column-parallel
  over their ff and row-parallel on the way out: their partial output joins
  the routed experts' partial combine before the one reduce-scatter.
* **MLA over "model" (the MLA-MoE family).**  The resolver gives "model" to
  the latent rank ``r`` before the heads, so ``w_dkv`` / ``kv_norm`` and
  ``w_uk`` / ``w_uv`` hold this rank's slice of ``r`` (the latter every
  head), ``wq`` / ``wo`` its query heads, ``w_kr`` is whole.  The latent
  norm's mean of squares is summed over "model"; ``k_nope`` and ``v``,
  partial sums over ``r`` for every head, are reduce-scattered onto this
  rank's heads (the JAX program's dots: every head from the rank's ``r``).
* **The SSM over "model" (the SSM and hybrid families).**  ``in_z`` /
  ``in_x`` / ``conv_x`` / ``gate_norm`` / ``out_proj`` hold this rank's
  channels and ``in_dt`` / ``A_log`` / ``dt_bias`` / ``D`` its heads (which
  must cut alike); ``in_bc`` / ``conv_bc`` its slice of the 2N B / C
  columns, gathered whole after the depthwise conv (at |model| 2, B on
  rank 0 and C on rank 1: the JAX "shard-aligned midpoint split").  The
  scan runs this rank's heads over the whole sequence, the gated norm's
  mean of squares is summed over "model", ``out_proj``'s output is a
  partial sum.  The scan runs this rank's own rows.  (Where "data" cuts
  the batch and the projections' embed dim alike, the JAX per-device
  program scans every "data" rank's rows and keeps its own: the same
  values at |data| times the scan's work.)
* **FSDP over "data", one layer at a time.**  Each layer's weights are
  gathered over the axes their ``embed`` dim is cut on just before its
  forward, kept by autograd as their shards (``collectives.FsdpHooks``),
  gathered again for its backward, and their gradient reduce-scattered to
  the shard right after it.

Gradients: a leaf's shard gradient is summed over every mesh axis its spec
does not name (:func:`grad_sum_axes`: the batch's ranks, and "model" for a
leaf every "model" rank holds whole, whose gradient each rank computes
from its own sequence slice or heads), the loss being scaled by the number
of ranks outside "model" so that the sum is the mean over the batch.
"""

from __future__ import annotations

import torch

from ..tree import leaves_with_path
from . import collectives as coll
from .sharding import (DEFAULT_RULES, mesh_axes, mesh_coords, part_axes,
                       rank_slice, resolve_spec, spec_shards, tree_specs)

MODEL = "model"


def grad_sum_axes(spec: tuple, mesh) -> tuple[str, ...]:
    """The mesh axes (in the mesh's order, each of more than one rank) a
    leaf of ``spec``'s gradient is summed over after the backward: every
    axis the spec does not cut.  (An axis it cuts over the batch, "data",
    was summed by its FSDP gather's reduce-scatter; "model" it cuts needs
    no sum: each rank computed its own slice whole.)"""
    named = {a for p in spec for a in part_axes(p)}
    return tuple(a for a, n in mesh_axes(mesh).items()
                 if n > 1 and a not in named)


def _entry(spec: tuple, d: int):
    return spec[d] if d < len(spec) else None


class Partition:
    """This rank's part of a model's train step on ``mesh`` (module
    docstring): the dense (but the VLM stub with patches), MoE, MLA-MoE,
    SSM and hybrid families.  ``model``: a ``models.Model``; ``mesh``: a
    ``DeviceMesh`` with named dims or a mesh given as sizes only (rank 0's
    part, ``meta`` tensors)."""

    def __init__(self, model, mesh):
        cfg = model.cfg
        fam = cfg.family
        if fam == "encdec" or cfg.n_patches:
            raise ValueError(f"the partitioned step runs the dense (without "
                             f"patches), moe, mla_moe, ssm and hybrid "
                             f"families, not {cfg.name} ({fam})")
        self.cfg, self.mesh = cfg, mesh
        self.coords = mesh_coords(mesh)
        self.n_model = mesh_axes(mesh).get(MODEL, 1)
        abstract = model.abstract()
        self.specs = {path: sp for (path, _), sp in zip(
            leaves_with_path(abstract),
            tree_specs(model.axes(), abstract, mesh))}
        self.spec_list = list(self.specs.values())
        self.hooks = coll.FsdpHooks()
        # the attention's and the MLP's leaves: the hybrid's are its shared
        # block's, the SSM has neither
        attn = {"hybrid": ("shared_attn", "attn"),
                "ssm": None}.get(fam, ("blocks", "attn"))
        mlp = ("shared_attn" if fam == "hybrid" else "blocks", "mlp")
        self.heads = self.kv = self.ff = self.experts = None
        self.heads_cut = self.kv_cut = self.ff_cut = False
        self.experts_cut = self.lora_cut = False
        self.kv_pick = None
        if attn is not None:
            self.heads, self.heads_cut = self._cut(cfg.n_heads,
                                                   attn + ("wq",), 2)
        if fam == "mla_moe":
            # the latent rank: w_dkv's columns, and w_uk / w_uv's rows
            # (the resolver gives "model" to their rank before their heads)
            self.lora, self.lora_cut = self._cut(cfg.kv_lora_rank,
                                                 attn + ("w_dkv",), 2)
        elif attn is not None:
            self.kv, self.kv_cut = self._cut(cfg.n_kv_heads, attn + ("wk",), 2)
            self.kv_pick = self._kv_pick()
        if fam in ("moe", "mla_moe"):
            # routed experts: w_up is (E, d, ff), its experts on "model"
            # and its ff whole; the shared experts' ff columns on "model"
            self.experts, self.experts_cut = self._cut(
                cfg.n_experts, mlp + ("w_up",), 1)
            if self.experts_cut and self._slice(cfg.n_experts, mlp + (
                    "router",), 2) != self.experts:
                raise ValueError("the router's expert columns and the "
                                 "experts' weights are cut apart")
            if cfg.n_shared_experts:
                _, shared_cut = self._cut(cfg.d_ff * cfg.n_shared_experts,
                                          mlp + ("shared_up",), 2)
                if shared_cut != self.experts_cut:
                    raise ValueError(f"{cfg.name}: the routed and the shared "
                                     f"experts are cut apart")
        elif fam != "ssm":
            self.ff, self.ff_cut = self._cut(cfg.d_ff, mlp + ("w_up",), 2)
        if fam in ("ssm", "hybrid"):
            self._ssm_slices(cfg)
        self.vocab, self.vocab_cut = self._cut(cfg.vocab_size, ("embed",), 0)
        self._vocab_part = MODEL if self.vocab_cut else None

    def _cut(self, size: int, path: tuple, d: int) -> tuple[slice, bool]:
        """This rank's slice of dim ``d`` of ``size`` of the leaf at
        ``path``, and whether "model" cuts it."""
        sl = self._slice(size, path, d)
        return sl, sl.stop - sl.start < size

    def _kv_pick(self):
        """The kv heads this rank's query heads read, where "model" cuts
        the query heads and leaves the kv heads whole: a slice of the whole
        ones (or, where its query heads do not cover whole groups, one per
        query head); None where each rank projects its own (or all)."""
        cfg = self.cfg
        if self.kv_cut or not self.heads_cut:
            return None
        G = cfg.n_heads // cfg.n_kv_heads
        need = [h // G for h in range(self.heads.start, self.heads.stop)]
        kvs = range(need[0], need[-1] + 1)
        if need == [k for k in kvs for _ in range(len(need) // len(kvs))]:
            return slice(kvs.start, kvs.stop)
        return need

    def _ssm_slices(self, cfg) -> None:
        """The SSM's cuts: its channels (``in_x`` on "ff"), heads
        (``in_dt`` on "heads"), which must cut alike, and its B / C
        columns (``in_bc``'s 2N on "ff": at |model| 2 the B columns on rank
        0 and the C columns on rank 1, gathered whole before the scan)."""
        ssm = ("blocks", "ssm")
        di, H = cfg.ssm_expand * cfg.d_model, cfg.ssm_heads
        self.channels, self.channels_cut = self._cut(di, ssm + ("in_x",), 2)
        self.ssm_heads, _ = self._cut(H, ssm + ("in_dt",), 2)
        P = di // H
        if (self.ssm_heads.start * P, self.ssm_heads.stop * P) != (
                self.channels.start, self.channels.stop):
            raise ValueError(f"{cfg.name}: the SSM's channels {self.channels}"
                             f" and heads {self.ssm_heads} are cut apart")
        _, self.bc_cut = self._cut(2 * cfg.ssm_state, ssm + ("in_bc",), 2)

    def _slice(self, size: int, path: tuple, d: int) -> slice:
        part = _entry(self.specs[path], d)
        if MODEL not in part_axes(part):
            return slice(0, size)
        return rank_slice(size, part, self.mesh, self.coords)

    # -- the sequence over "model" -----------------------------------------
    def seq_part(self, S: int):
        """The spec entry of the residual stream's sequence of ``S``
        positions: "model" where it divides, nothing on a mesh without
        one (raises on a "model" axis it does not divide)."""
        part = _entry(resolve_spec((S,), ("seq_act",), self.mesh,
                                   DEFAULT_RULES), 0)
        if self.n_model > 1 and part is None:
            raise ValueError(f"the partitioned step cuts the sequence over "
                             f"'model': {S} positions do not divide over "
                             f"{self.n_model} ranks")
        return part

    def seq_slice(self, S: int) -> slice:
        return rank_slice(S, self.seq_part(S), self.mesh, self.coords)

    def enter(self, h):
        """A block's input (this rank's positions) gathered along the
        sequence; its gradient reduce-scattered back."""
        S = h.shape[1] * self.n_model
        return coll.gather_from(h, 1, self.seq_part(S), self.mesh)

    def leave(self, y, cut: bool):
        """A block's output over the whole sequence back to this rank's
        positions: reduce-scattered where ``cut`` (partial sums of a
        product cut over "model"), else this rank's slice of it."""
        part = self.seq_part(y.shape[1])
        if cut:
            return coll.scatter_to(y, 1, part, self.mesh)
        return y[:, self.seq_slice(y.shape[1])]

    def seq_sum(self, t):
        """``t`` summed over the sequence's ranks (gradient as it is)."""
        return coll.reduce_from(t, MODEL if self.n_model > 1 else None,
                                self.mesh)

    # -- the experts over "model" ------------------------------------------
    def expert_logits(self, t):
        """Router logits (..., E / |model|) of this rank's experts gathered
        over "model" on their last dim, in expert order (their gradient
        reduce-scattered back)."""
        return coll.gather_from(t, t.dim() - 1, MODEL, self.mesh)

    def moe_args(self) -> dict:
        """``models.moe.moe_ffn``'s keywords for this rank's experts (none
        where "model" leaves them whole)."""
        if not self.experts_cut:
            return {}
        return dict(experts=self.experts, whole_logits=self.expert_logits)

    # -- dims cut over "model" inside a block -------------------------------
    def model_sum(self, t):
        """``t`` summed over "model", and its gradient too: the ranks use
        the sum apart (each on its own heads, channels or positions), so
        each one's gradient of it is a part."""
        return coll.copy_to(coll.reduce_from(t, MODEL, self.mesh), MODEL,
                            self.mesh)

    def model_mean(self, t):
        """The mean over "model" of ``t`` (each rank's mean over its equal
        slice of a dim: the mean over the whole dim), gradient summed."""
        return self.model_sum(t) / self.n_model

    def heads_sum(self, t):
        """MLA's ``k_nope`` / ``v`` (B, S, H, ·), partial sums over the
        latent rank "model" cuts, summed: this rank's heads where "model"
        cuts the query heads (a reduce-scatter on the heads), else all of
        them."""
        if self.heads_cut:
            return coll.scatter_to(t, 2, MODEL, self.mesh)
        return self.model_sum(t)

    def mla_args(self) -> dict:
        """``models.attention.mla_train``'s keywords where "model" cuts the
        latent rank (none where it does not)."""
        if not self.lora_cut:
            return {}
        return dict(kv_mean=self.model_mean, heads_sum=self.heads_sum)

    def ssm_args(self) -> dict:
        """``models.ssm.mamba2_seq``'s keywords for this rank's channels
        and heads: B / C gathered whole over "model" where it cuts their
        columns, and the gated norm's mean of squares over the channels it
        cuts."""
        out = {}
        if self.bc_cut:
            out["whole_bc"] = lambda t: coll.gather_from(t, t.dim() - 1,
                                                         MODEL, self.mesh)
        if self.channels_cut:
            out["gate_mean"] = self.model_mean
        return out

    # -- the vocabulary over "model" ---------------------------------------
    def vocab_sum(self, t):
        """``t`` summed over the vocabulary's slices (gradient as it is)."""
        return coll.reduce_from(t, self._vocab_part, self.mesh)

    def vocab_max(self, t):
        """``t``'s max over the vocabulary's slices, in place."""
        return coll.all_reduce(t, self._vocab_part, self.mesh, op="max")

    # -- weights -----------------------------------------------------------
    def fsdp(self, t, spec: tuple):
        """``t`` (this rank's shard of a weight of ``spec``) gathered along
        every dim its spec cuts on axes other than "model"."""
        for d, part in enumerate(spec):
            if part is not None and MODEL not in part_axes(part):
                t = coll.fsdp_gather(t, d, part, self.mesh, self.hooks)
        return t

    def weight(self, tree: dict, name: str):
        """A top-level leaf (``embed``, ``lm_head``, ``final_norm``)
        gathered for use."""
        return self.fsdp(tree[name], self.specs[(name,)])

    def layer(self, lp: dict, stack: str = "blocks") -> dict:
        """One layer's weights (views of this rank's shards of the stacked
        leaves under ``stack``: ``blocks``, or the hybrid's
        ``shared_attn``) gathered for its forward, ``wk`` / ``wv`` narrowed
        to the kv heads this rank's query heads read."""
        out = {}
        for path, t in leaves_with_path(lp):
            spec = self.specs[(stack,) + path][1:]
            if self.kv_pick is not None and path[-1] in ("wk", "wv"):
                t = t[:, self.kv_pick]
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self.fsdp(t, spec)
        return out

    # -- the gradients -----------------------------------------------------
    def reduce_grads(self, grads: list) -> None:
        """Each shard gradient (in the params' leaf order) summed in place
        over :func:`grad_sum_axes` of its leaf."""
        for g, spec in zip(grads, self.spec_list):
            axes = grad_sum_axes(spec, self.mesh)
            if axes:
                coll.all_reduce(g, axes, self.mesh)

    def global_norm(self, grads: list):
        """The whole gradient's norm from its shards: each leaf's f32 sum of
        squares, the leaves cut on the same axes added in leaf order and
        summed over those axes' ranks (the distinct shards: a leaf held
        whole by several ranks counts once), the groups added in the order
        of their first leaf."""
        sizes = mesh_axes(self.mesh)
        groups: dict = {}
        for g, spec in zip(grads, self.spec_list):
            axes = tuple(a for a in sizes if sizes[a] > 1 and a in
                         {x for p in spec for x in part_axes(p)})
            s = torch.sum(torch.square(g.float()))
            groups[axes] = s if axes not in groups else groups[axes] + s
        total = None
        for axes, s in groups.items():
            if axes:
                coll.all_reduce(s, axes, self.mesh)
            total = s if total is None else total + s
        return total.sqrt()

    def loss_scale(self) -> int:
        """The number of ranks outside "model": the local loss is divided
        by it before the backward, so the gradients' sum over them is the
        gradient of the mean over the batch."""
        return spec_shards(tuple(a for a in mesh_axes(self.mesh)
                                 if a != MODEL), self.mesh)

