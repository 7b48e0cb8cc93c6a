"""Device meshes and sharding on ``torch.distributed``.

Counterpart of ``ppde_tpu/parallel/mesh.py``, with its names and its five
axes: dp (chains), ep (ensemble members), tp (Potts couplings by columns,
ESM2 heads and hidden units), sp (the ESM2 residual stream's sequence axis)
and pp (ESM2 layers, ``parallel/pipeline.py``). The JAX package runs one
program over N devices and lets GSPMD insert the collectives; PyTorch runs
one process per device, so here every collective is an explicit call on a
group of the mesh (``torch.distributed.device_mesh``), and every kernel
launch stays visible to its wrapper's counter:

  * ``make_mesh`` joins the process group a launcher describes
    (``torchrun --nproc_per_node N ...``) and lays the world out as
    (dp, ep, tp, sp, pp); size-1 axes cost nothing. The backend follows the
    device: ``nccl`` for CUDA, ``gloo`` for the CPU, and nothing else;
  * a sharded value is the rank's local shard plus what is needed to
    reassemble it (``Placed``; a ``potts.PottsParams`` column block with
    its ``col0`` and ``tp`` axis; the ``"_tp"`` entry of ``shard_esm``'s
    parameters; ``SPConstraint``);
  * sums across ranks are ``all_reduce`` calls: every rank receives the
    same bits, so the replicated samplers take the same decisions
    everywhere;
  * every collective here is the identity on an axis of size 1 or None
    (no mesh), so the single-device path runs the same code;
  * the autograd-aware helpers: ``copy_to`` / ``reduce_from`` (the Megatron
    pair: identity forward with a sum backward, and a sum forward with an
    identity backward), ``gather_keep`` (gather forward; backward keeps the
    rank's slice, for a value every rank then uses alike), ``gather_sum``
    (gather forward; backward sums over ranks and keeps the slice, for a
    value each rank uses for its own rows), ``slice_gather`` (the rank's
    rows forward; backward gathers every rank's rows).

``shard_energy`` evaluates an energy on the rank's dp slice of the
population and gathers E, the fitness and dE/dx along dp, so that a
sampler runs unchanged and replicated on the full population.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

AXES = ("dp", "ep", "tp", "sp", "pp")


def backend_for(device_type: str) -> str:
    """The process group's backend for tensors of ``device_type``."""
    return "nccl" if device_type == "cuda" else "gloo"


def is_lead() -> bool:
    """True outside a process group and on its rank 0: the process that
    writes files and prints."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def init_distributed(device="cuda") -> torch.device:
    """Join the process group that a launcher describes (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK: ``torchrun``), unless one exists,
    and return this rank's device: ``cuda:LOCAL_RANK`` for CUDA. The
    group's backend must be the device's (``backend_for``): a CUDA run
    never goes through gloo."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "a mesh run needs one process per device, started by a "
                "launcher: torchrun --nproc_per_node N -m <module> ... "
                "(RANK and WORLD_SIZE are not set)")
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device 'cuda' requested but torch.cuda.is_available() "
                    "is False")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend_for(kind))
    backend = dist.get_backend()
    if backend != backend_for(kind):
        raise RuntimeError(f"the process group's backend is {backend}; "
                           f"{kind} tensors need {backend_for(kind)}")
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(dp: int | None = None, ep: int = 1, tp: int = 1, sp: int = 1,
              pp: int = 1, device="cuda"):
    """A (dp, ep, tp, sp, pp) ``DeviceMesh`` over the process group; dp
    None takes every rank left over. The mesh's size must be the world's."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = init_distributed(device)
    n = dist.get_world_size()
    rest = ep * tp * sp * pp
    if dp is None:
        if n % rest:
            raise ValueError(f"the world size {n} is not a multiple of "
                             f"ep*tp*sp*pp = {rest}")
        dp = n // rest
    if dp * rest != n:
        raise ValueError(
            f"mesh size {dp * rest} (dp={dp}, ep={ep}, tp={tp}, sp={sp}, "
            f"pp={pp}) differs from the world size {n}")
    return init_device_mesh(dev.type, (dp, ep, tp, sp, pp),
                            mesh_dim_names=AXES)


def mesh_shape(mesh) -> dict:
    """{axis name: size}, as the JAX package prints ``dict(mesh.shape)``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it."""

    name: str
    size: int
    rank: int
    group: Any


def axis(mesh, name: str) -> Axis:
    size = mesh.shape[mesh.mesh_dim_names.index(name)]
    return Axis(name, size, mesh.get_local_rank(name), mesh.get_group(name))


# ---------------------------------------------------------------------------
# collectives (the identity on no axis or a size-1 axis)
# ---------------------------------------------------------------------------

def _alone(ax: Axis | None) -> bool:
    return ax is None or ax.size == 1


def gather_cat(t: torch.Tensor, ax: Axis | None,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in
    rank order."""
    if _alone(ax):
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(ax.size)]
    dist.all_gather(parts, t, group=ax.group)
    return torch.cat(parts, dim)


def all_sum(t: torch.Tensor, ax: Axis | None) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor; ``all_reduce``)."""
    if _alone(ax):
        return t
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=ax.group)
    return t


def all_sum_list(ts, ax: Axis | None) -> list:
    """``all_sum`` of each tensor of ``ts``, in one ``all_reduce`` of one
    flat buffer."""
    if _alone(ax) or not ts:
        return list(ts)
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=ax.group)
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in ts]), ts)]


def _local(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.rank * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, summed):
        ctx.ax, ctx.dim, ctx.summed = ax, dim, summed
        return gather_cat(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = all_sum(g, ctx.ax)
        return _local(g, ctx.ax, ctx.dim).contiguous(), None, None, None


class _SliceGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _local(x, ax, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return gather_cat(g, ctx.ax, ctx.dim), None, None


def copy_to(x, ax: Axis | None):
    """Identity forward; backward sums the gradient over the axis (a
    replicated input read by a computation split over ranks)."""
    return x if _alone(ax) else _CopyTo.apply(x, ax)


def reduce_from(x, ax: Axis | None):
    """Sum over the axis forward; identity backward (partial results whose
    sum every rank then uses alike)."""
    return x if _alone(ax) else _ReduceFrom.apply(x, ax)


def gather_keep(x, ax: Axis | None, dim: int = 0):
    """Gather along ``dim`` forward; backward keeps the rank's slice of the
    gradient: for a value that every rank then uses alike (a replicated
    loss), where ``torch.distributed.nn``'s gather would multiply the
    gradient by the group's size."""
    return x if _alone(ax) else _Gather.apply(x, ax, dim, False)


def gather_sum(x, ax: Axis | None, dim: int = 0):
    """Gather along ``dim`` forward; backward sums the gradient over ranks
    and keeps the rank's slice: for a value each rank uses for its own
    outputs (the sequence-parallel attention)."""
    return x if _alone(ax) else _Gather.apply(x, ax, dim, True)


def slice_gather(x, ax: Axis | None, dim: int = 0):
    """The rank's slice of a replicated ``x`` forward (``dim`` a multiple
    of the axis' size); backward gathers every rank's slice of the
    gradient, so that the replicated ``x`` gets its whole gradient."""
    return x if _alone(ax) else _SliceGather.apply(x, ax, dim)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Placed:
    """A rank's shard of a value split over ``axis`` along ``dim`` (None:
    replicated, ``local`` is the whole value), ``full`` long there."""

    local: Any
    axis: Axis | None
    dim: int
    full: int

    @property
    def share(self) -> float:
        """The shard's part of the whole along ``dim``."""
        return 1.0 if self.axis is None else 1.0 / self.axis.size


def _split(x: torch.Tensor, ax: Axis, dim: int, what: str) -> torch.Tensor:
    if x.shape[dim] % ax.size:
        raise ValueError(f"{what}: {x.shape[dim]} is not a multiple of "
                         f"{ax.name}={ax.size}")
    return _local(x, ax, dim).contiguous()


def shard_chains(x: torch.Tensor, mesh) -> Placed:
    """The rank's rows of a [n_chains, ...] tensor over dp."""
    ax = axis(mesh, "dp")
    return Placed(_split(x, ax, 0, "n_chains"), ax, 0, x.shape[0])


def replicated(x, mesh) -> Placed:
    """``x`` whole on every rank."""
    return Placed(x, None, 0, 0)


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def shard_ensemble(stacked_params: dict, mesh) -> Placed:
    """The rank's members of a stacked ensemble over ep. Members split only
    when ep divides their count; otherwise the ensemble stays whole on
    every rank (3-member ensembles on ep = 2)."""
    ax = axis(mesh, "ep")
    m = _leaves(stacked_params)[0].shape[0]
    if ax.size == 1 or m % ax.size:
        return Placed(stacked_params, None, 0, m)
    return Placed(_tree_map(stacked_params,
                            lambda a: _split(a, ax, 0, "members")),
                  ax, 0, m)


def shard_potts(potts_params, mesh):
    """The rank's column block of the couplings over tp (``P(None, "tp")``
    in the JAX package): the ``potts.PottsParams`` with W [P', N], h [N],
    ``col0`` and the ``tp`` axis, where N = P' / tp and P' is P padded with
    zeros to a multiple of 128 * tp (kernel A tiles 128 x 128; the extra
    rows and columns meet zero entries of the one-hots and change
    nothing). wt_H stays whole. tp = 1 returns the couplings as they
    are."""
    ax = axis(mesh, "tp")
    if ax.size == 1:
        return potts_params
    W, h, c0 = potts_column_block(potts_params.W, potts_params.h, ax.size,
                                  ax.rank)
    return dataclasses.replace(potts_params, W=W, h=h, col0=c0, tp=ax)


def potts_column_block(W: torch.Tensor, h: torch.Tensor, tp: int,
                       rank: int):
    """(W[:, c0 : c0 + N], h[c0 : c0 + N], c0): block ``rank`` of ``tp``
    column blocks of the couplings [P, P] zero-padded to P', the next
    multiple of 128 * tp (kernel A's tiles)."""
    P = W.shape[-1]
    Pp = -(-P // (128 * tp)) * 128 * tp
    if Pp != P:
        W = torch.nn.functional.pad(W, (0, Pp - P, 0, Pp - P))
        h = torch.nn.functional.pad(h, (0, Pp - P))
    N = Pp // tp
    c0 = rank * N
    return W[:, c0:c0 + N].contiguous(), h[c0:c0 + N].contiguous(), c0


@dataclasses.dataclass(frozen=True)
class SPConstraint:
    """Sequence parallelism for the ESM2 residual stream [B, T, D]: between
    layers each rank of ``axis`` holds T' / sp positions (T' = T padded to
    a multiple of sp); ``esm2.forward_logits`` reads it."""

    axis: Axis

    def split(self, h: torch.Tensor) -> torch.Tensor:
        """Pad [B, T, ...] to T' along dim 1 and keep the rank's rows."""
        T = h.shape[1]
        Tp = -(-T // self.axis.size) * self.axis.size
        if Tp != T:
            h = torch.nn.functional.pad(h, (0, 0, 0, Tp - T))
        return _local(h, self.axis, 1)

    def gather(self, y: torch.Tensor, T: int) -> torch.Tensor:
        """The whole sequence of a split [B, T'/sp, D], cut to T: padded
        positions never reach attention (gradient summed over ranks)."""
        return gather_sum(y, self.axis, 1)[:, :T]

    def gather_keep(self, y: torch.Tensor, T: int) -> torch.Tensor:
        """The whole sequence of a split output that every rank then uses
        alike, cut to T."""
        return gather_keep(y, self.axis, 1)[:, :T]


def sp_constraint(mesh) -> SPConstraint:
    """The sequence-parallel hook for ``esm2.forward_logits(constrain=)``
    (and ``esm2.SP_CONSTRAIN``): T over the mesh's sp axis (the batch
    reaching the expert is already the rank's dp slice, ``shard_energy``)."""
    return SPConstraint(axis(mesh, "sp"))


def shard_esm(esm_params: dict, mesh, heads: int | None = None) -> dict:
    """Megatron tensor parallelism for ESM2 over tp: q, k, v and fc1 keep
    the rank's columns (its heads, its hidden units), o and fc2 its rows
    (``esm2`` sums the partial products over tp and adds their bias once);
    layer norms, the embedding and the LM head stay whole. The result holds
    the axis as ``"_tp"``. tp must divide the heads (``heads``, when given,
    is checked here; ``esm2`` checks at the first forward otherwise)."""
    ax = axis(mesh, "tp")
    if ax.size == 1:
        return esm_params
    if heads is not None and heads % ax.size:
        raise ValueError(f"tp={ax.size} does not divide the {heads} "
                         "attention heads")

    def col(p):
        return {"w": _split(p["w"], ax, 1, "columns"),
                "b": _split(p["b"], ax, 0, "columns")}

    def row(p):
        return {"w": _split(p["w"], ax, 0, "rows"), "b": p["b"]}

    out = {k: v for k, v in esm_params.items() if k != "layers"}
    out["layers"] = [
        {"attn_ln": layer["attn_ln"], "q": col(layer["q"]),
         "k": col(layer["k"]), "v": col(layer["v"]), "o": row(layer["o"]),
         "ffn_ln": layer["ffn_ln"], "fc1": col(layer["fc1"]),
         "fc2": row(layer["fc2"])}
        for layer in esm_params["layers"]]
    out["_tp"] = ax
    return out


# ---------------------------------------------------------------------------
# the energy over dp
# ---------------------------------------------------------------------------

def _pad_rows(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """x with its rows padded (copies of row 0) to a multiple of the
    axis' size."""
    extra = -x.shape[0] % ax.size
    if not extra:
        return x
    return torch.cat([x, x[:1].expand(extra, *x.shape[1:])])


class _DPEval(torch.autograd.Function):
    """Evaluate ``fn`` on the rank's rows and gather the outputs along dp;
    backward: the local vector-Jacobian product of the rank's rows of the
    upstream gradient, then a gather of dx (every rank holds the same
    upstream gradient: the sampler is replicated)."""

    @staticmethod
    def forward(ctx, x, fn, ax):
        n = x.shape[0]
        xs = _local(_pad_rows(x, ax), ax, 0)
        ctx.ax, ctx.n = ax, n
        if ctx.needs_input_grad[0]:
            xs = xs.detach().requires_grad_(True)
            with torch.enable_grad():
                outs = fn(xs)
            ctx.xs, ctx.outs = xs, outs
        else:
            outs = fn(xs)
        return tuple(gather_cat(o.detach(), ax)[:n] for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        ax, n = ctx.ax, ctx.n
        outs, gs = [], []
        for o, g in zip(ctx.outs, grads):
            if g is not None and o.requires_grad:
                outs.append(o)
                gs.append(_local(_pad_rows(g, ax), ax, 0))
        (dx,) = torch.autograd.grad(outs, ctx.xs, gs, allow_unused=True)
        if dx is None:
            dx = torch.zeros_like(ctx.xs)
        return gather_cat(dx, ax)[:n], None, None


def shard_energy(energy, mesh):
    """A protein ``energy`` over dp: each call evaluates the rank's slice
    of the population (rows padded to a multiple of dp) and gathers E, the
    fitness and dE/dx, so that a sampler runs replicated on the whole
    population. ``energy`` and ``fitness`` stay differentiable
    (MALA-approx). dp = 1 returns ``energy`` as it is."""
    ax = axis(mesh, "dp")
    if ax.size == 1:
        return energy

    def rows(x):
        return _local(_pad_rows(x, ax), ax, 0)

    def energy_and_grad(p, x):
        outs = energy.energy_and_grad(p, rows(x))
        return tuple(gather_cat(o, ax)[:x.shape[0]] for o in outs)

    def energy_fn(p, x):
        return _DPEval.apply(x, lambda v: energy.energy(p, v), ax)

    def fitness(p, x):
        (fit,) = _DPEval.apply(x, lambda v: (energy.fitness(p, v),), ax)
        return fit

    return dataclasses.replace(energy, energy=energy_fn,
                               energy_and_grad=energy_and_grad,
                               fitness=fitness, with_params=None)
