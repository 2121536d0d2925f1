"""Data parallel and FSDP training over ``torch.distributed`` (counterpart
of ``tokenreduction_tpu/parallel/mesh.py``; reference utils.py:216-238 and
train.py:406).

JAX runs one program over a mesh and XLA inserts the collectives; here
each rank runs the train step on its own rows and the collectives are
explicit, on the default stream between the kernels' launches:

- ``init_distributed`` joins the process group: NCCL with each rank on
  ``cuda:LOCAL_RANK``, or gloo when the caller asks for the CPU. A single
  process is a no-op.
- ``DataParallel`` is the data axis. ``place`` broadcasts rank 0's masters
  and, under FSDP, keeps this rank's shards (``fsdp_shardings``: JAX's
  placement rule). The step ``gather``s the full weights before its
  forwards (one all-gather of a flat bucket), and ``reduce_grads`` takes
  the mean of the accumulated gradients after its microbatches: an
  all-reduce (SUM, then / world) of the replicated leaves' flat bucket and
  a reduce-scatter of the sharded ones', so that clipping and the update
  see the global gradient (the psum XLA inserts). The update runs on the
  shards. Per-tensor reductions over a sharded leaf (the global norm,
  NovoGrad's layer norms, AdamP's and SGDP's projections, Adafactor's
  factored moments, the Sinkhorn projection, the watched norms) sum their
  partial sums over the ranks explicitly (``LeafShard``,
  ``complete_sums``).
- ``global_rows`` and ``draw_rows``: the step's random draws over the
  global batch. JAX draws drop-path masks, Gumbel noise, the device
  augmentation and mixup once over the global batch; here every rank
  draws the global shape from the same generator and keeps its own rows,
  so the multi-rank step is the single-process step on the global batch
  in the order ``global_order`` gives. Its cost: each rank draws world
  times the rows (masks of [B, 1, 1], a few floats a row).
- ``mirror_rows``: mixup's partner rows. The flip pairs global
  row g with B - 1 - g, which lies on rank world - 1 - r: each rank sends
  its rows to that rank and receives its rows (one point-to-point
  exchange of the local batch a step; none on one rank, or for the middle
  rank of an odd world).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

MIN_SIZE = 2 ** 14


def init_distributed(device=None, world_size: Optional[int] = None,
                     dist_url: Optional[str] = None) -> dict:
    """Join the process group (replaces reference utils.py:216-238).

    The rank and world come from torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` (with ``MASTER_ADDR`` / ``MASTER_PORT`` for the
    default ``env://``), or from the reference's ``--world_size`` and
    ``--dist_url`` with ``RANK`` (and ``LOCAL_RANK``) in the environment;
    ``WORLD_SIZE`` wins over ``world_size``, as in the reference. Backend
    NCCL with this rank on ``cuda:LOCAL_RANK``; gloo only when ``device``
    is the CPU. With one process nothing is joined. Returns
    {"process_index", "process_count", "initialized", "device"}."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        return {"process_index": rank, "process_count": world,
                "initialized": True,
                "device": _rank_device(
                    cpu, int(os.environ.get("LOCAL_RANK", rank)))}
    world = int(os.environ.get("WORLD_SIZE", world_size or 1))
    if world <= 1:
        return {"process_index": 0, "process_count": 1,
                "initialized": False,
                "device": None if device is None else torch.device(device)}
    if "RANK" not in os.environ:
        raise RuntimeError(
            f"a world of {world} needs each process's RANK (and LOCAL_RANK) "
            "in its environment, as torchrun sets them")
    rank = int(os.environ["RANK"])
    dev = _rank_device(cpu, int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=dist_url or "env://",
                            world_size=world, rank=rank)
    return {"process_index": rank, "process_count": world,
            "initialized": True, "device": dev}


def _rank_device(cpu: bool, local_rank: int) -> torch.device:
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the CPU as the device to "
                           "train over gloo on the CPU")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def fsdp_shardings(params: dict, world: int, min_size: int = MIN_SIZE):
    """{name: the torch dim the leaf is split along, or None}: JAX's rule,
    each leaf of at least ``min_size`` elements split along its largest
    dimension that ``world`` divides, the rest replicated. The dimensions
    are taken in Flax's order (``flax_axes``), so that a tie picks the
    axis JAX picks."""
    # imported here: train/optim.py imports this module
    from tokenreduction_tpu_torch.train.optim import flax_axes

    out = {}
    for name, p in params.items():
        out[name] = None
        if p.dim() == 0 or p.numel() < min_size:
            continue
        axes = flax_axes(name, p.dim())
        for a in sorted(axes, key=lambda d: -p.shape[d]):
            if p.shape[a] % world == 0:
                out[name] = a
                break
    return out


def shard_params(params: dict, world: int, rank: int, fsdp: bool = False,
                 min_size: int = MIN_SIZE) -> dict:
    """This rank's part of each tensor: the whole tensor without FSDP;
    under it the rank-th of the ``world`` equal blocks along the dim of
    ``fsdp_shardings`` (JAX's block order), a contiguous copy."""
    if not fsdp:
        return dict(params)
    dims = fsdp_shardings(params, world, min_size)
    return {n: p if dims[n] is None else
            p.chunk(world, dims[n])[rank].contiguous()
            for n, p in params.items()}


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """A leaf split over the ranks along torch dim ``dim`` of its ``full``
    shape: what a per-tensor reduction needs to see the whole tensor."""
    dim: int
    full: tuple
    world: int

    @property
    def numel(self) -> int:
        return int(np.prod(self.full))

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """t, this rank's partial sums, summed over the ranks in place."""
        dist.all_reduce(t)
        return t

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t


def complete_sums(values: list, shards: list) -> list:
    """Each value a partial sum over its leaf's shard (None: a leaf held
    whole): the split ones summed over the ranks in one all-reduce."""
    idx = [i for i, s in enumerate(shards) if s is not None]
    if not idx:
        return values
    flat = torch.stack([values[i].reshape(()) for i in idx])
    dist.all_reduce(flat)
    out = list(values)
    for j, i in enumerate(idx):
        out[i] = flat[j].reshape(values[i].shape)
    return out


# ---- the draws over the global batch
_ROWS = None  # (world, rank, groups) while a step draws over its rows


@contextlib.contextmanager
def global_rows(world: int, rank: int, groups: int = 1):
    """Inside it, ``draw_rows`` draws over the global batch: the local
    rows are ``groups`` microbatches of the global order
    (``global_order``) and this rank's part of each."""
    global _ROWS
    prev = _ROWS
    _ROWS = (world, rank, groups) if world > 1 else None
    try:
        yield
    finally:
        _ROWS = prev


def global_count(n: int) -> int:
    """The global batch's rows of a local batch of n rows."""
    return n if _ROWS is None else n * _ROWS[0]


def microbatch_rows(n: int) -> int:
    """The rows of one microbatch of a local batch of n rows inside
    ``global_rows`` (n outside it)."""
    return n if _ROWS is None else n // _ROWS[2]


def draw_rows(fn, *args, **kw):
    """``fn(*args, **kw)``, a draw whose size (the last positional
    argument) leads with the local batch's rows. Inside ``global_rows``
    the draw is of the global batch's rows, and this rank's rows of it
    are returned."""
    if _ROWS is None:
        return fn(*args, **kw)
    world, rank, groups = _ROWS
    *lead, size = args
    size = tuple(size)
    n, rest = size[0], size[1:]
    if n % groups:
        raise ValueError(f"{n} rows do not split into {groups} microbatches")
    out = fn(*lead, (n * world,) + rest, **kw)
    return out.view((groups, world, n // groups) + rest)[:, rank] \
        .reshape(size)


def local_rows(n: int) -> Optional[np.ndarray]:
    """The global rows of this rank's n local rows inside ``global_rows``
    (None outside it): indices into a draw over the global batch."""
    if _ROWS is None:
        return None
    world, rank, groups = _ROWS
    return global_order(world, groups, n)[rank * n:(rank + 1) * n]


def mirror_rows(images: torch.Tensor, labels: torch.Tensor):
    """(images, labels) of the rows mixup pairs with this rank's: global
    row g's partner is B - 1 - g (``global_order`` keeps the partner of a
    rank's local row j at local row n - 1 - j of rank world - 1 - r), so
    the partner rank's batch reversed, exchanged point to point. Outside
    ``global_rows``, this batch reversed."""
    partner = None if _ROWS is None else _ROWS[0] - 1 - _ROWS[1]
    if partner is None or partner == _ROWS[1]:
        return images.flip(0), labels.flip(0)
    got_x, got_y = torch.empty_like(images), torch.empty_like(labels)
    ops = [dist.P2POp(dist.isend, images.contiguous(), partner),
           dist.P2POp(dist.irecv, got_x, partner),
           dist.P2POp(dist.isend, labels.contiguous(), partner),
           dist.P2POp(dist.irecv, got_y, partner)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got_x.flip(0), got_y.flip(0)


def global_order(world: int, groups: int, rows: int) -> np.ndarray:
    """The global batch's row of each rank's local rows, rank-major:
    ``order[r * rows + j]`` is the global row of rank r's local row j.
    The global order is microbatch-major: microbatch i of the global batch
    is every rank's microbatch i, in rank order, so that the single-process
    step's microbatches are the ranks' together."""
    m = rows // groups
    r, i, j = np.meshgrid(np.arange(world), np.arange(groups), np.arange(m),
                          indexing="ij")
    return (i * world * m + r * m + j).reshape(-1)


# ---- the data axis
class DataParallel:
    """The data axis over the default process group (world 1 without
    one). ``fsdp``: masters, moments and EMA held as shards
    (``fsdp_shardings`` with ``min_size``); without it, replicated."""

    def __init__(self, fsdp: bool = False, min_size: int = MIN_SIZE):
        self.world, self.rank = process_count(), process_index()
        self.fsdp, self.min_size = fsdp, min_size
        self.dims: dict = {}  # name -> split dim or None
        self.full_shape: dict = {}

    @property
    def active(self) -> bool:
        return dist.is_initialized()

    def place(self, params: dict) -> dict:
        """Rank 0's tensors on every rank (one broadcast of a flat bucket),
        then this rank's shards under FSDP."""
        names = list(params)
        if self.active:
            flat = torch.cat([params[n].detach().reshape(-1).float()
                              for n in names])
            dist.broadcast(flat, 0)
            params = dict(zip(names, _unflat(flat, [params[n]
                                                    for n in names])))
        self.full_shape = {n: tuple(p.shape) for n, p in params.items()}
        self.dims = (fsdp_shardings(params, self.world, self.min_size)
                     if self.fsdp else dict.fromkeys(names))
        local = shard_params(params, self.world, self.rank, self.fsdp,
                             self.min_size)
        return {n: t.clone() for n, t in local.items()}

    def split(self) -> list:
        return [n for n, d in self.dims.items() if d is not None]

    def shards(self) -> dict:
        """{name: LeafShard} of the leaves split over more than one rank."""
        if self.world == 1:
            return {}
        return {n: LeafShard(self.dims[n], self.full_shape[n], self.world)
                for n in self.split()}

    def gather(self, params: dict, grad: bool = False,
               dims: Optional[dict] = None) -> dict:
        """The full tensors: the split leaves all-gathered (one flat
        bucket), new leaves that require grad when ``grad``; the others
        as they are. ``dims``: {name: split dim or None} of tensors other
        than the params (the optimizer's state)."""
        dims = self.dims if dims is None else dims
        names = [n for n in params if dims.get(n) is not None]
        if not names:
            return dict(params)
        with torch.no_grad():
            flat = torch.cat([params[n].reshape(-1) for n in names])
            out = flat.new_empty(flat.numel() * self.world)
            if self.active:
                dist.all_gather_into_tensor(out, flat)
            else:
                out.copy_(flat)
            out = out.view(self.world, -1)
        full, off = dict(params), 0
        for n in names:
            local = params[n]
            k = local.numel()
            blocks = out[:, off:off + k].reshape((self.world,) + local.shape)
            t = torch.cat(blocks.unbind(0), dim=dims[n])
            full[n] = t.requires_grad_(True) if grad else t
            off += k
        return full

    def reduce_grads(self, grads: dict) -> dict:
        """The mean over the ranks of each full gradient: this rank's
        block of it for the split leaves (reduce-scatter), the whole for
        the others (all-reduce); SUM, then / world."""
        if not self.active:
            return grads
        out = dict(grads)
        whole = [n for n in grads if self.dims.get(n) is None]
        if whole:
            flat = torch.cat([grads[n].reshape(-1) for n in whole])
            dist.all_reduce(flat)
            flat.div_(self.world)
            out.update(zip(whole, _unflat(flat, [grads[n] for n in whole])))
        split = [n for n in grads if self.dims.get(n) is not None]
        if split:
            blocks = [grads[n].chunk(self.world, self.dims[n])
                      for n in split]
            flat = torch.cat([b[r].reshape(-1) for r in range(self.world)
                              for b in blocks])
            mine = flat.new_empty(flat.numel() // self.world)
            _reduce_scatter(mine, flat)
            mine.div_(self.world)
            out.update(zip(split, _unflat(mine, [b[self.rank]
                                                 for b in blocks])))
        return out

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """A scalar's mean over the ranks (SUM, then / world)."""
        if not self.active:
            return t
        t = t.detach().clone()
        dist.all_reduce(t)
        return t / self.world

    def full_state(self, state, optimizer) -> dict:
        """{"params", "ema_params", "opt_state"} of a train state whole on
        every rank (the split leaves gathered, in the same order on every
        rank): what a checkpoint holds."""
        out = {"params": self.gather(state.params),
               "ema_params": None if state.ema_params is None
               else self.gather(state.ema_params), "opt_state": {}}
        for part, tensors in state.opt_state.items():
            dims = {n: optimizer.state_dims(n, self.full_shape[n],
                                            self.dims[n])[part]
                    for n in tensors}
            out["opt_state"][part] = self.gather(tensors, dims=dims)
        return out

    def rows(self, groups: int = 1):
        return global_rows(self.world, self.rank, groups)


def _unflat(flat: torch.Tensor, like: list) -> list:
    out, off = [], 0
    for t in like:
        k = t.numel()
        out.append(flat[off:off + k].view(t.shape).to(t.dtype))
        off += k
    return out


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, inp)
