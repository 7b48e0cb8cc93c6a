"""Pipeline parallelism (pp) for the ESM2 expert: GPipe over send / recv.

Counterpart of ``ppde_tpu/parallel/pipeline.py``, with its names. The
layer stack splits into ``pp`` stages, one per rank of the mesh's pp axis;
microbatches stream through the stages and the activations go stage to
stage by ``torch.distributed`` send / recv on the pp group:

  * stage s applies layers [s * Np, (s + 1) * Np) of ``pipeline_params``'
    stacked layers (every rank holds the stack; a stage reads its slice);
  * one loop over ``n_mb + pp - 1`` ticks: at tick t stage s takes
    microbatch t - s (from the embedding at stage 0, else from stage
    s - 1), applies its layers and sends the result on; the last stage
    keeps it. Its outputs are then broadcast over pp, so that every pp rank
    holds them (the JAX package's psum of zeros elsewhere);
  * the batch of each microbatch also splits over dp: a rank carries
    [mb / dp, T, D] activations, and the outputs are gathered along dp;
  * differentiable end to end: one ``torch.autograd.Function`` runs the
    forward schedule and, in its backward, the reverse schedule (each
    stage's vector-Jacobian product of the gradient received from the
    next stage, sent to the previous one), so dE/dx and the layers'
    gradients (summed over pp and dp) flow through the pipeline.
    ``torch.distributed.pipelining`` is not used: its schedules
    backpropagate a loss of their own and give no input gradient.

Numerics are ``esm2.forward_logits``'s (the same layer function, the same
per-example token-dropout). Utilization is n_mb / (n_mb + pp - 1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ppde_tpu_torch.models import esm2
from ppde_tpu_torch.parallel import mesh as pmesh


def stack_layers(layers: list) -> dict:
    """Stack a list of per-layer dicts into one dict whose leaves have a
    leading layer axis. Requires identical shapes."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([layer[k] for layer in layers])
                for k in first}
    return torch.stack(layers)


def pipeline_params(params: dict, n_stages: int) -> dict:
    """Re-layout ESM2 params for an n_stages pipeline: ``layers`` (list)
    becomes ``layers_stacked`` [n_layers, ...]; everything else unchanged.
    n_stages must divide the layer count."""
    n_layers = len(params["layers"])
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers not divisible by pp={n_stages} stages")
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers_stacked"] = stack_layers(params["layers"])
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _layer(paths, leaves, i):
    """Layer i of the stacked leaves, as a layer dict."""
    out = {}
    for path, leaf in zip(paths, leaves):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf[i]
    return out


class _Stages(torch.autograd.Function):
    """This rank's stage of the GPipe schedule over [n_mb, rows, T, D]
    microbatches; the inputs after ``h_mb`` and ``cfg`` are the stacked
    layers' leaves."""

    @staticmethod
    def forward(ctx, h_mb, cfg, *leaves):
        ax, _, heads, approx_gelu, remat, paths = cfg
        pp, s = ax.size, ax.rank
        ranks = dist.get_process_group_ranks(ax.group) if pp > 1 else [0]
        n_mb = h_mb.shape[0]
        n_local = leaves[0].shape[0] // pp
        grad = any(ctx.needs_input_grad)
        keep_graph = grad and not remat
        lv = [leaf.detach().requires_grad_(r)
              for leaf, r in zip(leaves, ctx.needs_input_grad[2:])]

        def stage(h):
            # the layers are sliced here, where autograd may be recording
            for i in range(s * n_local, (s + 1) * n_local):
                h = esm2.transformer_layer(_layer(paths, lv, i), h, heads,
                                           approx_gelu)
            return h

        outs = torch.zeros_like(h_mb)
        saved = {}
        for t in range(n_mb + pp - 1):
            m = t - s
            if not 0 <= m < n_mb:
                continue
            if s == 0:
                inp = h_mb[m]
            else:
                inp = torch.empty_like(h_mb[0])
                dist.recv(inp, ranks[s - 1], group=ax.group)
            if keep_graph:
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    act = stage(inp)
                saved[m] = (inp, act)
            else:
                act = stage(inp)
                if grad:
                    saved[m] = (inp, None)
            if s < pp - 1:
                dist.send(act.detach().contiguous(), ranks[s + 1],
                          group=ax.group)
            else:
                outs[m] = act.detach()
        if pp > 1:
            dist.broadcast(outs, ranks[pp - 1], group=ax.group)
        ctx.cfg, ctx.ranks, ctx.lv, ctx.saved = cfg, ranks, lv, saved
        ctx.stage, ctx.n_local = stage, n_local
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        ax, dp = ctx.cfg[:2]
        pp, s, ranks = ax.size, ax.rank, ctx.ranks
        n_mb = g_outs.shape[0]
        wants = [leaf for leaf in ctx.lv if leaf.requires_grad]
        g_h = torch.zeros_like(g_outs)
        g_leaves = [torch.zeros_like(leaf) for leaf in wants]
        for t in reversed(range(n_mb + pp - 1)):
            m = t - s
            if not 0 <= m < n_mb:
                continue
            if s == pp - 1:
                g = g_outs[m]
            else:
                g = torch.empty_like(g_outs[0])
                dist.recv(g, ranks[s + 1], group=ax.group)
            inp, act = ctx.saved.pop(m)
            if act is None:  # remat: run the stage again, recording
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    act = ctx.stage(inp)
            got = torch.autograd.grad(act, [inp] + wants, g,
                                      allow_unused=True)
            for acc, gl in zip(g_leaves, got[1:]):
                if gl is not None:
                    acc.add_(gl)
            if s > 0:
                dist.send(got[0].contiguous(), ranks[s - 1], group=ax.group)
            else:
                g_h[m] = got[0]
        if pp > 1:
            dist.broadcast(g_h, ranks[0], group=ax.group)
        # a stage's layers get their gradient on its own rank, from its dp
        # rows: summed over pp and dp, every rank holds the whole of it
        out = iter(pmesh.all_sum_list(pmesh.all_sum_list(g_leaves, dp), ax))
        return (g_h, None, *(next(out) if leaf.requires_grad else None
                             for leaf in ctx.lv))


def forward_logits_pp(params: dict, x_onehot: torch.Tensor, mesh, *,
                      heads: int = 20, n_microbatches: int | None = None,
                      remat: bool = False, pp_axis: str = "pp",
                      dp_axis: str | None = "dp") -> torch.Tensor:
    """Pipelined ESM2 forward: one-hot [B, T, 33] -> logits [B, T, 33],
    the same on every rank.

    ``params`` is a ``pipeline_params`` re-layout (layers_stacked). The
    embedding and the tied LM head are small and run whole on every rank;
    only the layer stack is pipelined. ``n_microbatches`` defaults to 2 pp;
    B must divide by it, and each microbatch by dp. ``remat``: a stage
    keeps only its microbatches' inputs and runs again in the backward.
    The layers' gradients, when they need one, are summed over pp and dp.
    """
    ax = pmesh.axis(mesh, pp_axis)
    dp = pmesh.axis(mesh, dp_axis) if dp_axis is not None else None
    pp, n_dp = ax.size, dp.size if dp is not None else 1
    n_mb = n_microbatches if n_microbatches is not None else max(2 * pp, 1)
    B, T, _ = x_onehot.shape
    if B % n_mb or (B // n_mb) % n_dp:
        raise ValueError(
            f"batch {B} must split into {n_mb} microbatches x dp={n_dp}")
    stacked = params["layers_stacked"]
    paths = _paths(stacked)
    leaves = []
    for path in paths:
        leaf = stacked
        for k in path:
            leaf = leaf[k]
        leaves.append(leaf)
    n_layers = leaves[0].shape[0]
    if n_layers % pp:
        raise ValueError(f"{n_layers} layers not divisible by pp={pp}")

    approx_gelu = esm2._use_approx_gelu(params)
    h = esm2.embed_tokens(params, x_onehot)
    h_mb = h.reshape(n_mb, B // n_mb, T, h.shape[-1])
    if dp is not None:
        h_mb = pmesh.slice_gather(h_mb, dp, 1)
    outs = _Stages.apply(h_mb, (ax, dp, heads, approx_gelu, remat, paths),
                         *leaves)
    if dp is not None:
        outs = pmesh.gather_keep(outs, dp, 1)
    return esm2.lm_head(params, outs.reshape(B, T, -1), approx_gelu)


def pseudo_log_likelihood_pp(params: dict, x_onehot: torch.Tensor, mesh,
                             **kw) -> torch.Tensor:
    """Pipelined PLL score [B]: the pp counterpart of
    ``esm2.pseudo_log_likelihood``."""
    logits = forward_logits_pp(params, x_onehot, mesh, **kw)
    lp = torch.log_softmax(logits, -1)
    return (x_onehot.float() * lp).sum((1, 2))
