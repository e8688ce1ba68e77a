"""The (dp, sp, tp) rank grid: the counterpart of ``magcache_tpu.parallel.mesh``.

The JAX package states shardings and lets XLA insert the collectives. PyTorch
has no such thing, so the port is explicit SPMD: every rank runs the same
program on its share and calls collectives on a ``Group``. The grid has the
JAX mesh's three axes, and a rank's world index follows JAX ``build_mesh``'s
``reshape(dp, sp, tp)``: ``rank = (d * sp + s) * tp + t``, ``tp`` innermost.

- ``sp`` ranks each hold ``1/sp`` of the tokens (Ulysses or ring attention);
- ``tp`` ranks each hold ``1/tp`` of the heads and of the FFN's inner width
  (Megatron slices, ``parallel.shard``); the activations between blocks stay
  whole on every tp rank, and each row-parallel projection ends in an
  all-reduce over tp;
- ``dp`` ranks each hold their own rows of the batch: one CFG lane of a
  ``generate()`` request at dp 2 (the JAX package's lane-stacked batch riding
  ``dp``), or ``B/dp`` whole prompts of a ``generate_batch``.

A ``Group`` offers ``rank``, ``size`` and four collectives:

- ``all_to_all(x, split_dim, concat_dim)``: x is cut into ``size`` equal
  chunks along ``split_dim``, chunk j goes to rank j, and the chunks received
  are concatenated along ``concat_dim`` in rank order;
- ``ring_shift(x)``: send x to rank + 1, return what rank - 1 sent;
- ``all_gather(x, dim)``: every rank's x concatenated along ``dim`` in rank
  order;
- ``all_reduce_sum(x)``: the sum over ranks, in one f32 buffer (the f32
  result, whatever x's dtype).

Two implementations run the same rank program:

- ``TorchDistGroup``: a ``torch.distributed`` process group, one process per
  rank (NCCL for CUDA tensors, gloo for CPU tensors), as ``torchrun`` starts
  them; ``init_distributed`` is the rendezvous and ``torch_dist_plan`` builds
  a rank's groups;
- ``LocalGroup``: ranks as threads of one process on one device;
  ``run_local_ranks`` starts them. It is the counterpart of the virtual CPU
  devices the JAX tests use, and how several ranks run on a single card.
  The ranks take turns over the whole grid: one runs at a time, from one
  collective to the next, and hands the turn to the next rank when it has
  put its tensor in its group's slot. Each group (one per dp, sp and tp
  line of the grid) has its own rounds of slots; a rank whose round is not
  complete when the turn comes back passes it on, and if the turn goes
  round the grid with no rank writing a slot or ending, no rank can move:
  the rank waits for the timeout without passing the turn, and the run's
  ``TimeoutError`` says where each rank waits.
  The card runs the ranks' work one kernel after another anyway, and host
  threads that ran at once would trade the GIL at every op; taking turns, a
  rank queues its kernels while the card still runs the previous rank's.
  All ranks stay on the device's default stream, so what one rank enqueued
  before a collective is ordered before what another enqueues after it. The
  model's weights are shared (tp ranks hold views of one copy). A rank that
  raises ends the turns, every wait has a timeout, and the caller gets the
  first exception: a fault ends the run, it never hangs it.

``MeshPlan`` holds a rank's three groups; models, samplers and
``attention()`` take it as an explicit argument (``plan=None`` is the
single-rank path). Every axis of a local rank is a ``LocalGroup``, one of
size 1 too; elsewhere (``MeshPlan``'s defaults, ``torch_dist_plan``) an axis
of size 1 is a ``SoloGroup``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["Group", "SoloGroup", "LocalGroup", "TorchDistGroup", "MeshPlan",
           "run_local_ranks", "init_distributed", "torch_dist_plan", "grid_rank",
           "LOCAL_TIMEOUT_S"]

LOCAL_TIMEOUT_S = 120.0     # a local rank waits this long for its turn


def grid_rank(d: int, s: int, t: int, sp: int, tp: int) -> int:
    """The world rank of grid point (d, s, t): JAX ``build_mesh``'s
    ``reshape(dp, sp, tp)`` order, ``tp`` innermost."""
    return (d * sp + s) * tp + t


class Group:
    """One rank's handle on one axis of the grid."""

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
        """The f32 sum of every rank's x: one f32 buffer, the ranks' tensors
        added into it in rank order."""
        parts = self._exchange(x)
        out = parts[0].to(torch.float32, copy=True)
        for p in parts[1:]:
            out.add_(p)
        return out


class SoloGroup(Group):
    """An axis of size 1: every collective returns this rank's own value."""

    rank = 0
    size = 1

    def _exchange(self, x):
        return [x]


def _split_even(x: torch.Tensor, n: int, dim: int, what: str) -> Sequence[torch.Tensor]:
    if x.shape[dim] % n:
        raise ValueError(f"{what}: dim {dim} of {tuple(x.shape)} does not divide "
                         f"by the group size {n}")
    return x.chunk(n, dim=dim)


class _Rounds:
    """One group's two rounds of slots (a round's slots stay until every
    member has read them: a member writes round k + 2 only after all have
    read round k, and the last reader empties them, so that no tensor
    outlives its collective), the rounds each member has entered, and each
    round's readers so far."""

    def __init__(self, name: str, size: int):
        self.name = name
        self.slots = ([None] * size, [None] * size)
        self.rounds = [0] * size
        self.reads = [0, 0]

    def read(self, k: int) -> list:
        """Under the shared condition: round k's slots, emptied after the
        last member's read."""
        slots = self.slots[k % 2]
        got = list(slots)
        self.reads[k % 2] += 1
        if self.reads[k % 2] == len(slots):
            slots[:] = [None] * len(slots)
            self.reads[k % 2] = 0
        return got


class _LocalShared:
    """What the local ranks of one grid share: whose turn it is, each
    group's rounds, a count of progress (slots written and ranks ended),
    what each rank waits on, and which ranks are done."""

    def __init__(self, size: int, timeout: float):
        self.cond = threading.Condition()
        self.size = size
        self.timeout = timeout
        self.turn = 0
        self.progress = 0
        self.waiting: Dict[int, str] = {}
        self.stuck: Optional[str] = None    # every rank's wait, when none could move
        self.done = [False] * size
        self.broken = False

    def wait(self, ready: Callable[[], bool]) -> None:
        """Under ``cond``: waits until ``ready()``; raises
        ``BrokenBarrierError`` if the run was ended or the wait timed out
        (which ends it for the others too)."""
        if not self.cond.wait_for(lambda: self.broken or ready(), self.timeout):
            self.end_at_timeout()
        if self.broken:
            raise threading.BrokenBarrierError

    def end_at_timeout(self) -> None:
        """Under ``cond``: ends the run; when every rank not done waits at a
        collective, none could move, and ``stuck`` records their waits."""
        live = [r for r in range(self.size) if not self.done[r]]
        if live and all(r in self.waiting for r in live):
            self.stuck = "; ".join(f"rank {r}: {self.waiting[r]}" for r in live)
        self.broken = True
        self.cond.notify_all()

    def pass_turn(self, rank: int) -> None:
        """Under ``cond``: the turn goes to the next rank that is not done."""
        nxt = (rank + 1) % self.size
        while self.done[nxt] and nxt != rank:
            nxt = (nxt + 1) % self.size
        self.turn = nxt
        self.cond.notify_all()

    def await_round(self, rank: int, complete: Callable[[], bool], what: str) -> None:
        """Under ``cond``, after this rank wrote its slot: hands the turn on
        until it comes back with the round complete. A turn that comes back
        with no progress made went round every rank that is not done, each
        waiting on a round that cannot complete: the rank then waits (without
        spinning the turn) for progress until the timeout, which ends the
        run with every rank's wait recorded in ``stuck``."""
        self.waiting[rank] = what
        try:
            while True:
                seen = self.progress
                self.pass_turn(rank)
                self.wait(lambda: self.turn == rank)
                if complete():
                    return
                if self.progress == seen and not self.cond.wait_for(
                        lambda: self.broken or self.progress != seen, self.timeout):
                    self.end_at_timeout()
                if self.broken:
                    raise threading.BrokenBarrierError
        finally:
            self.waiting.pop(rank, None)

    def start(self, rank: int) -> None:
        with self.cond:
            self.wait(lambda: self.turn == rank)

    def finish(self, rank: int) -> None:
        with self.cond:
            self.done[rank] = True
            self.progress += 1
            self.pass_turn(rank)

    def abort(self) -> None:
        with self.cond:
            self.broken = True
            self.cond.notify_all()


class LocalGroup(Group):
    """Member ``rank`` of a group of ``size`` local ranks (threads of this
    process); ``world_rank`` is the thread's rank in the grid. A collective
    writes this rank's value into its slot of the group's round, hands the
    turn on, and when the turn comes back with every member's slot written
    reads every slot."""

    def __init__(self, shared: _LocalShared, rounds: _Rounds, rank: int, size: int,
                 world_rank: int):
        self._shared = shared
        self._rounds = rounds
        self.rank = rank
        self.size = size
        self.world_rank = world_rank

    def _exchange(self, x):
        sh, g = self._shared, self._rounds
        with sh.cond:
            k = g.rounds[self.rank]
            slots = g.slots[k % 2]
            slots[self.rank] = x
            g.rounds[self.rank] = k + 1
            sh.progress += 1
            sh.await_round(self.world_rank, lambda: min(g.rounds) > k,
                           f"{g.name} round {k}")
            return g.read(k)


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
        """The f32 sum over the group's ranks (the backend's order of
        addition)."""
        import torch.distributed as dist

        out = x.to(torch.float32, copy=True)
        dist.all_reduce(out, group=self._pg)
        return out


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A rank's plan: its sequence-parallel ``group`` and its ``tp_group``
    and ``dp_group`` (``SoloGroup`` where the axis has size 1). ``sp`` ranks
    each hold ``1/sp`` of the tokens, of the activations and of the MagCache
    residual cache; ``tp`` ranks each hold ``1/tp`` of the heads; ``dp``
    ranks each hold their own rows of the batch. The text context is whole
    on every rank."""

    group: Group
    tp_group: Group = dataclasses.field(default_factory=SoloGroup)
    dp_group: Group = dataclasses.field(default_factory=SoloGroup)

    @property
    def sp(self) -> int:
        return self.group.size

    @property
    def rank(self) -> int:
        """The rank's index along ``sp``."""
        return self.group.rank

    @property
    def tp(self) -> int:
        return self.tp_group.size

    @property
    def tp_rank(self) -> int:
        return self.tp_group.rank

    @property
    def dp(self) -> int:
        return self.dp_group.size

    @property
    def dp_rank(self) -> int:
        return self.dp_group.rank

    @property
    def world(self) -> int:
        return self.dp * self.sp * self.tp

    @property
    def world_rank(self) -> int:
        return grid_rank(self.dp_rank, self.rank, self.tp_rank, self.sp, self.tp)

    def describe(self) -> str:
        return f"dp {self.dp} x sp {self.sp} x tp {self.tp}"

    def without_dp(self) -> "MeshPlan":
        """The same rank with its dp axis taken off: the plan of a program
        whose dp ranks each run their own whole batch rows."""
        return dataclasses.replace(self, dp_group=SoloGroup())

    def shard_len(self, n: int, what: str = "sequence") -> int:
        """Tokens per rank of an ``n``-token sequence; raises when ``n``
        does not divide by ``sp`` (shards are even, as in the JAX package)."""
        if n % self.sp:
            raise ValueError(f"{what} length {n} does not divide by sp = {self.sp}")
        return n // self.sp


def _grid_lines(dp: int, sp: int, tp: int) -> List[Tuple[str, List[int]]]:
    """Every group of the grid as ``(name, world ranks in group order)``:
    the sp lines, then the tp lines, then the dp lines."""
    lines = []
    for d in range(dp):
        for t in range(tp):
            lines.append((f"sp group (dp {d}, tp {t})",
                          [grid_rank(d, s, t, sp, tp) for s in range(sp)]))
    for d in range(dp):
        for s in range(sp):
            lines.append((f"tp group (dp {d}, sp {s})",
                          [grid_rank(d, s, t, sp, tp) for t in range(tp)]))
    for s in range(sp):
        for t in range(tp):
            lines.append((f"dp group (sp {s}, tp {t})",
                          [grid_rank(d, s, t, sp, tp) for d in range(dp)]))
    return lines


def _check_axes(dp: int, sp: int, tp: int) -> None:
    if min(dp, sp, tp) < 1:
        raise ValueError(f"the grid's axes must be at least 1, got dp {dp}, sp {sp}, tp {tp}")


def run_local_ranks(sp: int, fn: Callable[[MeshPlan], object], *, dp: int = 1,
                    tp: int = 1, timeout: float = LOCAL_TIMEOUT_S, device=None) -> list:
    """Runs ``fn(plan)`` on the ``dp * sp * tp`` local ranks of a grid, one
    thread each, taking turns in world-rank order between collectives, and
    returns their results in world-rank order (``grid_rank``). Every axis is
    a ``LocalGroup``, one of size 1 too. ``device``
    (a CUDA device) becomes every thread's current device. If a rank raises,
    the turns end, the other ranks end, and the first exception is raised
    here; a rank that waits longer than ``timeout`` for its turn ends the
    run the same way (``TimeoutError``)."""
    _check_axes(dp, sp, tp)
    world = dp * sp * tp
    shared = _LocalShared(world, timeout)
    groups: Dict[int, dict] = {r: {} for r in range(world)}
    for name, members in _grid_lines(dp, sp, tp):
        rounds = _Rounds(name, len(members))
        axis = name.split()[0]
        for i, w in enumerate(members):
            groups[w][axis] = LocalGroup(shared, rounds, i, len(members), w)
    results: list = [None] * world
    errors: list = [None] * world

    def worker(rank: int):
        try:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.set_device(device)
            shared.start(rank)
            g = groups[rank]
            results[rank] = fn(MeshPlan(g["sp"], tp_group=g["tp"], dp_group=g["dp"]))
        except BaseException as e:          # noqa: BLE001 - handed to the caller
            errors[rank] = e
            shared.abort()
        else:
            shared.finish(rank)

    def name(w: int) -> str:
        d, s, t = w // (sp * tp), w // tp % sp, w % tp
        return f"sp-rank-{s}" if dp == tp == 1 else f"grid-rank-{w}-dp{d}-sp{s}-tp{t}"

    threads = [threading.Thread(target=worker, args=(r,), name=name(r), daemon=True)
               for r in range(world)]
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
        stuck = f" (no rank could move: {shared.stuck})" if shared.stuck else ""
        raise TimeoutError(f"a local rank waited longer than {timeout} s at a "
                           f"collective{stuck}") from broken[0]
    return results


def torch_dist_plan(dp: int = 1, sp: int = 1, tp: int = 1) -> MeshPlan:
    """This process's ``MeshPlan`` in a ``torch.distributed`` world of
    ``dp * sp * tp`` processes (``init_distributed`` first). Every process
    creates every sp, tp and dp group of the grid in the same order, as
    ``torch.distributed.new_group`` requires, and keeps its own three; an
    axis that spans the world is the world group, one of size 1 a
    ``SoloGroup``."""
    import torch.distributed as dist

    _check_axes(dp, sp, tp)
    world, me = dist.get_world_size(), dist.get_rank()
    if world != dp * sp * tp:
        raise ValueError(f"the process world holds {world} ranks, the grid "
                         f"dp {dp} x sp {sp} x tp {tp} needs {dp * sp * tp}")
    mine = {"sp": SoloGroup(), "tp": SoloGroup(), "dp": SoloGroup()}
    for name, members in _grid_lines(dp, sp, tp):
        if len(members) == 1:
            continue
        axis = name.split()[0]
        pg = None if len(members) == world else dist.new_group(members)
        if me in members:
            mine[axis] = TorchDistGroup(pg)
    return MeshPlan(mine["sp"], tp_group=mine["tp"], dp_group=mine["dp"])


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
