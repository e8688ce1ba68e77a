"""Sequence-parallel ranks: the counterpart of ``magcache_tpu.parallel.mesh``.

The JAX package states shardings and lets XLA insert the collectives. PyTorch
has no such thing, so the port is explicit SPMD: every rank runs the same
program on its ``1/sp`` of the tokens and calls collectives on a ``Group``.
Only the ``sp`` axis is ported (``dp`` and ``tp`` are not yet).

A ``Group`` offers ``rank``, ``size`` and four collectives:

- ``all_to_all(x, split_dim, concat_dim)``: x is cut into ``size`` equal
  chunks along ``split_dim``, chunk j goes to rank j, and the chunks received
  are concatenated along ``concat_dim`` in rank order;
- ``ring_shift(x)``: send x to rank + 1, return what rank - 1 sent;
- ``all_gather(x, dim)``: every rank's x concatenated along ``dim`` in rank
  order;
- ``all_reduce_sum(x)``: the sum over ranks of a small f32 tensor.

Two implementations run the same rank program:

- ``TorchDistGroup``: a ``torch.distributed`` process group, one process per
  rank (NCCL for CUDA tensors, gloo for CPU tensors), as ``torchrun`` starts
  them; ``init_distributed`` is the rendezvous;
- ``LocalGroup``: ``size`` ranks as threads of one process on one device;
  ``run_local_ranks`` starts them. It is the counterpart of the virtual CPU
  devices the JAX tests use, and how several ranks run on a single card.
  The ranks take turns: one runs at a time, from one collective to the
  next, and hands the turn to the next rank when it has put its tensor in
  its slot. The card runs their work one kernel after another anyway, and
  host threads that ran at once would trade the GIL at every op (each
  PyTorch call drops and retakes it); taking turns, a rank queues its
  kernels while the card still runs the previous rank's. All ranks stay on
  the device's default stream, so what one rank enqueued before a
  collective is ordered before what another enqueues after it. The model's
  weights are shared, not copied. A rank that raises ends the turns, every
  wait has a timeout, and the caller gets the first exception: a fault ends
  the run, it never hangs it.

``MeshPlan`` holds a rank's group; models, samplers and ``attention()`` take
it as an explicit argument (``plan=None`` is the single-rank path).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence

import torch

__all__ = ["Group", "LocalGroup", "TorchDistGroup", "MeshPlan",
           "run_local_ranks", "init_distributed", "LOCAL_TIMEOUT_S"]

LOCAL_TIMEOUT_S = 120.0     # a local rank waits this long for its turn


class Group:
    """One rank's handle on its sequence-parallel group."""

    rank: int
    size: int

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x``, in rank order (the one primitive a subclass
        may build the collectives from)."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        chunks = _split_even(x, self.size, split_dim, "all_to_all")
        mine = [got[self.rank] for got in self._exchange(chunks)]
        return torch.cat(mine, dim=concat_dim)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        return self._exchange(x)[(self.rank - 1) % self.size]

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._exchange(x), dim=dim)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._exchange(x)).sum(0)


def _split_even(x: torch.Tensor, n: int, dim: int, what: str) -> Sequence[torch.Tensor]:
    if x.shape[dim] % n:
        raise ValueError(f"{what}: dim {dim} of {tuple(x.shape)} does not divide "
                         f"by the group size {n}")
    return x.chunk(n, dim=dim)


class _LocalShared:
    """What the ranks of one ``LocalGroup`` share: whose turn it is, two
    rounds of slots (a round's slots stay until every rank has read them:
    a rank writes round k + 2 only after all have read round k), the
    exchanges each rank has entered, and which ranks are done."""

    def __init__(self, size: int, timeout: float):
        self.cond = threading.Condition()
        self.size = size
        self.timeout = timeout
        self.turn = 0
        self.slots = ([None] * size, [None] * size)
        self.rounds = [0] * size
        self.done = [False] * size
        self.broken = False

    def wait(self, ready: Callable[[], bool]) -> None:
        """Under ``cond``: waits until ``ready()``; raises
        ``BrokenBarrierError`` if the run was ended or the wait timed out
        (which ends it for the others too)."""
        if not self.cond.wait_for(lambda: self.broken or ready(), self.timeout):
            self.broken = True
            self.cond.notify_all()
        if self.broken:
            raise threading.BrokenBarrierError

    def pass_turn(self, rank: int) -> None:
        """Under ``cond``: the turn goes to the next rank that is not done."""
        nxt = (rank + 1) % self.size
        while self.done[nxt] and nxt != rank:
            nxt = (nxt + 1) % self.size
        self.turn = nxt
        self.cond.notify_all()

    def start(self, rank: int) -> None:
        with self.cond:
            self.wait(lambda: self.turn == rank)

    def finish(self, rank: int) -> None:
        with self.cond:
            self.done[rank] = True
            self.pass_turn(rank)

    def abort(self) -> None:
        with self.cond:
            self.broken = True
            self.cond.notify_all()


class LocalGroup(Group):
    """Rank ``rank`` of ``size`` ranks that are threads of this process.
    A collective writes this rank's value into its slot of the round, hands
    the turn on, and when the turn comes back (every rank has written the
    round by then) reads every slot."""

    def __init__(self, shared: _LocalShared, rank: int, size: int):
        self._shared = shared
        self.rank = rank
        self.size = size

    def _exchange(self, x):
        sh = self._shared
        with sh.cond:
            k = sh.rounds[self.rank]
            slots = sh.slots[k % 2]
            slots[self.rank] = x
            sh.rounds[self.rank] = k + 1
            sh.pass_turn(self.rank)
            sh.wait(lambda: sh.turn == self.rank and min(sh.rounds) > k)
            return list(slots)


class TorchDistGroup(Group):
    """The ranks of a ``torch.distributed`` process group (default: the world
    group that ``init_distributed`` made). CUDA tensors need the NCCL
    backend, CPU tensors gloo."""

    def __init__(self, process_group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("TorchDistGroup needs an initialised process group "
                               "(call init_distributed first)")
        self._pg = process_group
        self.rank = dist.get_rank(process_group)
        self.size = dist.get_world_size(process_group)

    def all_to_all(self, x, split_dim, concat_dim):
        import torch.distributed as dist

        chunks = _split_even(x, self.size, split_dim, "all_to_all")
        send = torch.stack([c.contiguous() for c in chunks])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self._pg)
        return torch.cat(list(recv.unbind(0)), dim=concat_dim)

    def ring_shift(self, x):
        import torch.distributed as dist

        send = x.contiguous()
        recv = torch.empty_like(send)
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        ops = [dist.P2POp(dist.isend, send, self._peer(nxt), group=self._pg),
               dist.P2POp(dist.irecv, recv, self._peer(prv), group=self._pg)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def _peer(self, group_rank: int) -> int:
        import torch.distributed as dist

        return group_rank if self._pg is None else dist.get_global_rank(self._pg, group_rank)

    def all_gather(self, x, dim):
        import torch.distributed as dist

        send = x.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(parts, send, group=self._pg)
        return torch.cat(parts, dim=dim)

    def all_reduce_sum(self, x):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=self._pg)
        return out


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A rank's sequence-parallel plan: its group. ``sp`` ranks each hold
    ``1/sp`` of the tokens, of the activations and of the MagCache residual
    cache; weights and the text context are whole on every rank."""

    group: Group

    @property
    def sp(self) -> int:
        return self.group.size

    @property
    def rank(self) -> int:
        return self.group.rank

    def shard_len(self, n: int, what: str = "sequence") -> int:
        """Tokens per rank of an ``n``-token sequence; raises when ``n``
        does not divide by ``sp`` (shards are even, as in the JAX package)."""
        if n % self.sp:
            raise ValueError(f"{what} length {n} does not divide by sp = {self.sp}")
        return n // self.sp


def run_local_ranks(sp: int, fn: Callable[[MeshPlan], object], *,
                    timeout: float = LOCAL_TIMEOUT_S, device=None) -> list:
    """Runs ``fn(plan)`` on ``sp`` local ranks, one thread each, taking
    turns in rank order between collectives, and returns their results in
    rank order. ``device`` (a CUDA device) becomes every thread's current
    device. If a rank raises, the turns end, the other ranks end, and the
    first exception is raised here; a rank that waits longer than
    ``timeout`` for its turn ends the run the same way."""
    shared = _LocalShared(sp, timeout)
    results: list = [None] * sp
    errors: list = [None] * sp

    def worker(rank: int):
        try:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.set_device(device)
            shared.start(rank)
            results[rank] = fn(MeshPlan(LocalGroup(shared, rank, sp)))
        except BaseException as e:          # noqa: BLE001 - handed to the caller
            errors[rank] = e
            shared.abort()
        else:
            shared.finish(rank)

    threads = [threading.Thread(target=worker, args=(r,), name=f"sp-rank-{r}",
                                daemon=True) for r in range(sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # the fault itself first; BrokenBarrierError is only its echo in the others
    real = [e for e in errors if e is not None
            and not isinstance(e, threading.BrokenBarrierError)]
    broken = [e for e in errors if e is not None]
    if real:
        raise real[0]
    if broken:
        raise TimeoutError(f"a local rank waited longer than {timeout} s at a "
                           f"collective") from broken[0]
    return results


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, *, backend: str = "nccl",
                     timeout_s: float = 600.0) -> int:
    """The process-group rendezvous (the JAX package's ``init_distributed``
    with its coordinator address). With ``init_method`` (``tcp://host:port``
    or ``file:///path``) it needs ``world_size`` and ``rank``; without, the
    launcher's environment (``torchrun``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``) is read. ``backend``: ``nccl`` for CUDA
    tensors, ``gloo`` for CPU tensors. Returns the world size."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if init_method is not None and (world_size is None or rank is None):
        raise ValueError("an explicit init_method needs world_size and rank")
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method, world_size=world_size, rank=rank)
    dist.init_process_group(backend=backend,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.get_world_size()
