"""Collectives with the gradients that JAX's transposes give them, as
`torch.autograd.Function`s over a process group (one rank a shard).

A tensor is either replicated (every rank of the group holds the same
value) or a rank's own part. The rules, in Megatron's terms:

- `enter(x)`: a replicated tensor that flows into shard-local work. The
  forward is the identity; the backward sums the ranks' cotangents, so
  every rank ends with the full gradient of x. `enter_many` does it for
  a list of tensors with one all-reduce.
- `psum(x, grad=...)`: the sum over the ranks. grad="identity" where every
  rank consumes the sum alike (a replicated result, e.g. the beliefs
  assembled from each shard's rows: each rank's cotangent is already the
  full one); grad="psum" where each rank feeds the sum into its own
  shard-local work (the learned softmax's denominator, a full-width
  accumulator each rank slices): the cotangents are summed.
- `pmax(x)`: the maximum, with no gradient (the softmax's max shift is
  stop-gradient in the reference too).
- `all_gather(x, dim, grad=...)`: the ranks' blocks concatenated along
  dim. grad="slice" where every rank consumes the whole alike (the tp
  ranks of one dp group gather a layer's weight shards and run the same
  batch): the backward keeps this rank's block of the cotangent;
  grad="reduce_scatter" where each rank consumes it differently: the
  cotangents are summed and each rank keeps its block.
- `ppermute(x, shift)`: rank r sends x to rank (r + shift) mod d and
  receives rank (r - shift) mod d's; the backward sends the cotangent back
  round the reverse ring.
- `all_to_all(x, dim)`: block j of x along dim goes to rank j; the blocks
  received are concatenated along dim in rank order. It is its own
  inverse, and its backward.

NCCL runs every collective on CUDA tensors. PyTorch documents gloo's
CUDA support as all_reduce and broadcast only, so under gloo every other
collective of a CUDA tensor (all_gather, all_to_all, send/recv) copies
that one tensor to host memory, runs there and copies the result back to
the card (`_staged`); the compute stays on the card. (chip_smoke.py's
parallel line records which collectives gloo ran on CUDA tensors: with
torch 2.11, all_gather too.) Under NCCL nothing is staged.
A group of one rank runs no collective. Every collective goes through
one of `all_reduce_`, `all_gather_data`, `_ppermute` and `_all_to_all`.

`GroupRef` holds a group on a module (EuclideanEdge's `batch_group`,
bound by the data-parallel wrappers): a deep copy of the module shares
it, as it shares the communicator.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective other than all_reduce and broadcast must take
    t through host memory: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """In place: t becomes the reduction over the ranks (no gradient)."""
    if _size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    return all_reduce_(t.contiguous().clone(), group, op)


def all_reduce_many(tensors, group, mean: bool = False) -> None:
    """In place: each tensor becomes its sum (mean=True: its mean) over
    the ranks, all of them in one all-reduce of their concatenation (no
    gradient). None entries are skipped."""
    tensors = [t for t in tensors if t is not None]
    d = _size(group)
    if d == 1 or not tensors:
        return
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]), group)
    if mean:
        flat /= d
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


def all_gather_data(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' blocks of t concatenated along dim (equal shapes)."""
    d = _size(group)
    if d == 1:
        return t.clone()
    src = (t.cpu() if _staged(t, group) else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(d)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _my_block(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    d = _size(group)
    nb = t.shape[dim] // d
    return t.narrow(dim, dist.get_rank(group) * nb, nb).contiguous()


def _ppermute(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    d = _size(group)
    if d == 1 or shift % d == 0:
        return t.clone()
    r = dist.get_rank(group)
    src = (t.cpu() if _staged(t, group) else t).contiguous()
    recv = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(group, (r + shift) % d), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (r - shift) % d), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(t.device)


def _all_to_all(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    d = _size(group)
    if d == 1:
        return t.clone()
    moved = t.movedim(dim, 0)
    src = (moved.cpu() if _staged(t, group) else moved).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device).movedim(0, dim)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if _size(ctx.group) > 1:
            gs = [None if g is None else g.clone() for g in gs]
            all_reduce_many(gs, ctx.group)
        return (None, *gs)


def enter(x: torch.Tensor, group) -> torch.Tensor:
    return _Enter.apply(group, x)[0]


def enter_many(xs, group) -> list:
    """enter() for each tensor of xs, the backward one all-reduce."""
    xs = list(xs)
    if not xs:
        return []
    return list(_Enter.apply(group, *xs))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad):
        ctx.group, ctx.grad = group, grad
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "identity":
            return g, None, None
        return _all_reduce(g, ctx.group), None, None


def psum(x: torch.Tensor, group, grad: str = "psum") -> torch.Tensor:
    if grad not in ("psum", "identity"):
        raise ValueError(f"grad must be 'psum' or 'identity': {grad!r}")
    return _Psum.apply(x, group, grad)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the ranks; no gradient."""
    return _all_reduce(x.detach(), group, op=dist.ReduceOp.MAX)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad):
        ctx.group, ctx.dim, ctx.grad = group, dim, grad
        return all_gather_data(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "reduce_scatter":
            g = _all_reduce(g, ctx.group)
        return _my_block(g, ctx.group, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, group, dim: int,
               grad: str = "reduce_scatter") -> torch.Tensor:
    if grad not in ("reduce_scatter", "slice"):
        raise ValueError(f"grad must be 'reduce_scatter' or 'slice': "
                         f"{grad!r}")
    return _AllGather.apply(x, group, dim, grad)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank r's x to rank (r + shift) mod d: with shift 1 every rank gets
    its left ring neighbour's (JAX's perm [(j, j + 1 mod d)])."""
    return _Ppermute.apply(x, group, shift)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_to_all(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.dim), None, None


def all_to_all(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    if x.shape[dim] % _size(group):
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {_size(group)} ranks")
    return _AllToAll.apply(x, group, dim)


def all_to_all_data(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """all_to_all of index data (no gradient)."""
    return _all_to_all(x, group, dim)


class GroupRef:
    """A process group held by a module attribute. A deep copy of the
    module keeps the same group (a communicator is not copied)."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self
