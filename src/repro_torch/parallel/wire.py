"""One rank's transport over a ``torch.distributed`` process group: the
wire the staged ladder's hops, the halo planes and ELL send sets, and the
monolithic dot block's all-reduce travel on.

NCCL moves tensors on the card itself; gloo moves CPU tensors.  A gloo
group whose ranks compute on the card (several ranks sharing one GPU, which
NCCL refuses) stages every payload through pinned host buffers: one
device-to-host copy per batch of sends (a host synchronisation, counted in
``host_syncs``), the transfer, and an asynchronous host-to-device copy of
what arrived.

The wire counts what it carries by kind (``"halo"``, ``"hop"``,
``"all_reduce"``, ``"gather"``): ``bytes_sent`` and ``messages`` of this
rank.
"""

from __future__ import annotations

import collections
from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["Wire", "Pending"]


class Pending:
    """An in-flight all-reduce: the MPI_Iallreduce request.  ``wait()``
    returns the reduced tensor (on NCCL it orders the caller's stream after
    the collective and does not block the host; on gloo it blocks until the
    collective is done)."""

    def __init__(self, work, buf: torch.Tensor, device: torch.device | None):
        self._work, self._buf, self._device = work, buf, device

    def wait(self) -> torch.Tensor:
        self._work.wait()
        if self._device is None:
            return self._buf
        return self._buf.to(self._device, non_blocking=True)


class Wire:
    """Point-to-point messages and collectives of one rank.

    ``device`` is where the rank computes; the wire is the default
    process group's.  ``rank`` and ``size`` are this rank's place in the
    group and the group's size; ``backend`` is ``"nccl"`` or
    ``"gloo"``, and ``staged`` whether payloads go through pinned host
    buffers (gloo with a CUDA device)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = str(dist.get_backend())
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.bytes_sent: collections.Counter = collections.Counter()
        self.messages: collections.Counter = collections.Counter()
        self.host_syncs = 0

    def reset_counts(self) -> None:
        self.bytes_sent.clear()
        self.messages.clear()
        self.host_syncs = 0

    # ------------------------------------------------------------ staging --
    def _outgoing(self, tensors: Sequence[torch.Tensor]
                  ) -> list[torch.Tensor]:
        """What the backend sends: the tensors themselves, or their pinned
        host copies (one stream synchronisation for the batch)."""
        if not self.staged:
            return [t.contiguous() for t in tensors]
        outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        if outs:
            for o, t in zip(outs, tensors):
                o.copy_(t, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            self.host_syncs += 1
        return outs

    def _incoming(self, like: torch.Tensor) -> torch.Tensor:
        if self.staged:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(like.shape, dtype=like.dtype, device=self.device)

    def _arrived(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True) if self.staged else t

    # --------------------------------------------------------- transport --
    def exchange(self, sends, recvs, kind: str) -> list[torch.Tensor]:
        """One batch of point-to-point messages.  ``sends`` lists
        ``(peer, tag, tensor)``, ``recvs`` lists ``(peer, tag, like)`` with
        ``like`` giving the arriving tensor's shape and dtype.  Every send
        and receive of the batch is posted at once
        (``dist.batch_isend_irecv``) and waited for; returns the received
        tensors in the order of ``recvs``, on this rank's device."""
        out = self._outgoing([t for _, _, t in sends])
        into = [self._incoming(like) for _, _, like in recvs]
        ops = [dist.P2POp(dist.isend, buf, peer=peer, tag=tag)
               for (peer, tag, _), buf in zip(sends, out)]
        ops += [dist.P2POp(dist.irecv, buf, peer=peer, tag=tag)
                for (peer, tag, _), buf in zip(recvs, into)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        self.messages[kind] += len(sends)
        self.bytes_sent[kind] += sum(t.numel() * t.element_size()
                                     for t in out)
        return [self._arrived(t) for t in into]

    def all_reduce_async(self, t: torch.Tensor,
                         op=dist.ReduceOp.SUM) -> Pending:
        """Issue an all-reduce of ``t`` over the group and return at once
        (``async_op=True``).  On an unstaged wire the collective writes
        ``t`` in place, so ``t`` must not be read before the wait."""
        (buf,) = self._outgoing([t])
        work = dist.all_reduce(buf, op=op, async_op=True)
        self.messages["all_reduce"] += 1
        self.bytes_sent["all_reduce"] += buf.numel() * buf.element_size()
        return Pending(work, buf, self.device if self.staged else None)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """Blocking all-reduce (the caller's stream waits on NCCL)."""
        return self.all_reduce_async(t, op).wait()

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated in rank order along ``dim``."""
        (buf,) = self._outgoing([t])
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf)
        self.messages["gather"] += 1
        self.bytes_sent["gather"] += buf.numel() * buf.element_size()
        return self._arrived(torch.cat(parts, dim=dim))

    def counts(self) -> dict:
        """This rank's traffic so far: bytes and messages by kind, and the
        host synchronisations the staging took."""
        return {"bytes_sent": dict(self.bytes_sent),
                "messages": dict(self.messages),
                "staging_host_syncs": self.host_syncs}
