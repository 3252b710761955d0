"""A one-axis device mesh and the collectives the sharded solvers use.

Counterpart of ``jax.sharding.Mesh`` together with the ``lax`` collectives
the JAX package's shard_map bodies call (``psum``, ``psum_scatter`` and
``all_gather`` with ``tiled=True``, ``axis_index``, ``axis_size``).
PyTorch has no single-process SPMD, so each body is written once, over
the list of this process's shards: a collective takes one tensor per
local shard and returns one per local shard. The single-device solvers
of optim/ run the same bodies on a one-shard in-process mesh, where a
collective moves and copies nothing. Two backings carry it:

* **in process** (``group=False``): a tuple of devices, repeats allowed
  (four shards on ``cuda:0``, or eight on ``cpu`` in the tests). The
  collectives sum or concatenate across the list. This is what ``System``
  uses (it refuses a process-group mesh); it mirrors
  ``len(jax.devices()) > 1``. The shards run one after another on the
  calling thread.
* **process group** (``group=True``): the ranks of ``torch.distributed``,
  each holding its local shards (``parallel/multihost.initialize`` joins
  them; it mirrors ``jax.distributed``). A collective first reduces or
  concatenates the local list, then calls ``all_reduce``,
  ``all_gather_into_tensor`` or ``reduce_scatter_tensor``. Global shard
  ``g`` lives on rank ``g // n_local``.

Replicated values are held one per shard as well; shards that share a
device share one tensor object, and ``replicated`` computes a replicated
expression once per distinct device.

Every collective is counted by the op that crossed the shards and the
element count of the full (unscattered, gathered) tensor: ``counts``
maps op -> [calls, elements]. The tests and the weak-scaling tool read
these, as the JAX tests read the compiled HLO.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


class Mesh:
    """One mesh axis of ``size`` shards; this process holds ``devices``."""

    def __init__(self, devices: Sequence, group: bool = False):
        if not devices:
            raise ValueError("a mesh needs at least one local shard")
        self.devices = tuple(torch.device(d) for d in devices)
        self.group = bool(group)
        if self.group and not dist.is_initialized():
            raise RuntimeError("a process-group mesh needs torch.distributed initialized "
                               "(parallel/multihost.initialize)")
        self.rank = dist.get_rank() if self.group else 0
        self.world = dist.get_world_size() if self.group else 1
        self.n_local = len(self.devices)
        self.size = self.n_local * self.world  # lax.axis_size
        self.backend = dist.get_backend() if self.group else None
        self.counts: dict[str, list[int]] = {}

    def __repr__(self):
        where = f"rank {self.rank}/{self.world} ({self.backend})" if self.group else "in process"
        return f"Mesh(size={self.size}, {where}, devices={[str(d) for d in self.devices]})"

    # ------------------------------------------------------------------
    def axis_index(self, i: int) -> int:
        """Global index of local shard i (lax.axis_index)."""
        return self.rank * self.n_local + i

    def reset_counts(self):
        self.counts = {}

    def _count(self, op: str, numel: int):
        c = self.counts.setdefault(op, [0, 0])
        c[0] += 1
        c[1] += int(numel)

    def replicate(self, x) -> list:
        """A replicated value (a tensor or a tuple of tensors) as its
        per-shard list, no collective: one value per local shard, shared
        by the shards on one device."""
        if isinstance(x, tuple):
            return [tuple(p) for p in zip(*(self.replicate(t) for t in x))]
        on = {x.device: x}
        return [on[d] if d in on else on.setdefault(d, x.to(d)) for d in self.devices]

    def shard(self, x: torch.Tensor) -> list:
        """Split a global tensor along dim 0 into this process's shards
        (equal blocks, global shard order)."""
        if x.shape[0] % self.size:
            raise ValueError(f"dim 0 ({x.shape[0]}) does not divide {self.size} shards")
        n = x.shape[0] // self.size
        return [x[self.axis_index(i) * n:(self.axis_index(i) + 1) * n].to(d)
                for i, d in enumerate(self.devices)]

    def replicated(self, fn: Callable, *per_shard: list) -> list:
        """fn over per-shard replicated arguments, evaluated once per
        distinct local device; one result per shard."""
        out: dict = {}
        res = []
        for i, d in enumerate(self.devices):
            if d not in out:
                out[d] = fn(*(a[i] for a in per_shard))
            res.append(out[d])
        return res

    def per_shard(self, fn: Callable, *per_shard: list) -> list:
        """fn over each local shard's arguments (sharded values)."""
        return [fn(*args) for args in zip(*per_shard)]

    def gather_local(self, xs: list) -> torch.Tensor:
        """Concatenate this process's shards along dim 0 on the first
        local device (no collective: what this process can address)."""
        if self.n_local == 1:
            return xs[0]
        home = self.devices[0]
        return torch.cat([x.to(home) for x in xs], dim=0)

    # ------------------------------------------------------------------
    def _local_sum(self, xs: list):
        """This process's shards summed on its first device. One local
        shard: the tensor itself, no copy."""
        if self.n_local == 1:
            return xs[0]
        home = self.devices[0]
        if isinstance(xs[0], tuple):
            return tuple(self._local_sum(list(x)) for x in zip(*xs))
        acc = xs[0].to(home, copy=True)
        for x in xs[1:]:
            acc += x.to(home)
        return acc

    def _staged(self, t: torch.Tensor) -> bool:
        # Gloo's CUDA coverage is partial (reduce-scatter is the likeliest
        # gap), so a CUDA tensor crosses a gloo group through host memory.
        # Explicit, and counted under "host_staged" beside the op.
        return self.backend == "gloo" and t.is_cuda

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self._staged(t):
            self._count("host_staged", t.numel())
            h = t.cpu()
            dist.all_reduce(h)
            return h.to(t.device)
        dist.all_reduce(t)
        return t

    def psum(self, xs: list) -> list:
        """Sum over all shards; the sum, replicated, one per local shard.
        A shard's value is a tensor or a tuple of tensors (summed part by
        part, and crossing a process group as one flat buffer)."""
        acc = self._local_sum(xs)
        parts = acc if isinstance(acc, tuple) else (acc,)
        self._count("psum", sum(t.numel() for t in parts))
        if self.group:
            flat = self._all_reduce(torch.cat([t.reshape(-1) for t in parts]))
            parts = tuple(c.view(t.shape) for c, t in
                          zip(flat.split([t.numel() for t in parts]), parts))
            acc = parts if isinstance(acc, tuple) else parts[0]
        return self.replicate(acc)

    def psum_scatter(self, xs: list) -> list:
        """Sum over all shards, leaving shard g its g-th block of dim 0
        (lax.psum_scatter(..., scatter_dimension=0, tiled=True))."""
        acc = self._local_sum(xs)
        n = acc.shape[0] // self.size
        if acc.shape[0] % self.size:
            raise ValueError(f"dim 0 ({acc.shape[0]}) does not divide {self.size} shards")
        if not self.group:
            self._count("psum_scatter", acc.numel())
            return [acc[i * n:(i + 1) * n].to(d) for i, d in enumerate(self.devices)]
        lo = self.rank * self.n_local * n
        if self.backend == "gloo":
            # Gloo has no reduce-scatter for every device type: all-reduce
            # the whole tensor and keep this rank's blocks. Counted as
            # what crossed the ranks, a psum of the full tensor.
            self._count("psum", acc.numel())
            mine = self._all_reduce(acc.clone() if self.n_local == 1 else acc)
            mine = mine[lo:lo + self.n_local * n]
        else:
            self._count("psum_scatter", acc.numel())
            mine = torch.empty((self.n_local * n, *acc.shape[1:]), dtype=acc.dtype,
                               device=acc.device)
            dist.reduce_scatter_tensor(mine, acc.contiguous())
        return [mine[i * n:(i + 1) * n].to(d) for i, d in enumerate(self.devices)]

    def all_gather(self, xs: list) -> list:
        """Concatenate every shard's block along dim 0 in global shard
        order (lax.all_gather(..., tiled=True)); replicated, one per local
        shard."""
        local = self.gather_local(xs)
        if self.group:
            if self._staged(local):
                self._count("host_staged", local.numel() * self.world)
                h = local.cpu().contiguous()
                parts = [torch.empty_like(h) for _ in range(self.world)]
                dist.all_gather(parts, h)
                full = torch.cat(parts).to(local.device)
            else:
                full = torch.empty((local.shape[0] * self.world, *local.shape[1:]),
                                   dtype=local.dtype, device=local.device)
                dist.all_gather_into_tensor(full, local.contiguous())
        else:
            full = local
        self._count("all_gather", full.numel())
        return self.replicate(full)


def make_mesh(devices: Optional[Sequence] = None, device_type: Optional[str] = None,
              group: Optional[bool] = None) -> Mesh:
    """The default mirrors ``jax.devices()``. With ``torch.distributed``
    initialized: every rank, each with one shard on its current device (a
    process-group mesh). Otherwise every visible device of
    ``device_type`` (default ``cuda``; with no card visible that raises,
    and a CPU mesh is asked for with ``device_type="cpu"``) in process;
    the CPU is one device, so a CPU run gets one shard. ``devices`` names
    the local shards explicitly, repeats allowed. ``group=False`` asks
    for an in-process mesh whatever the state of ``torch.distributed``
    (``System``'s default), ``group=True`` for a process-group mesh.
    """
    if group is None:
        group = dist.is_available() and dist.is_initialized()
    if devices is None:
        device_type = device_type or "cuda"
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA device is visible; pass device_type="cpu" '
                               'for a mesh on the CPU')
        if device_type == "cuda":
            devices = ([torch.device("cuda", torch.cuda.current_device())] if group
                       else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        else:
            devices = [torch.device(device_type)]
    return Mesh(devices, group=group)


def pcg(matvec: Callable, precond: Callable, dot: Callable, each: Callable, b: list,
        iters: int) -> list:
    """Fixed-iteration preconditioned conjugate gradients over per-shard
    vectors, the one PCG of the port's solvers (optim/ba's implicit Schur
    system on replicated or camera-sharded vectors, optim/pose_graph's
    vertex system). ``dot`` returns the replicated
    inner product (a psum of local sums where the vectors are sharded);
    ``each`` applies an elementwise update (``Mesh.replicated`` for
    replicated vectors, ``Mesh.per_shard`` for sharded ones)."""
    x = each(torch.zeros_like, b)
    r = b
    z = precond(r)
    d = z
    rz = dot(r, z)
    for _ in range(iters):
        Ad = matvec(d)
        alpha = each(lambda a, b_: a / torch.clamp(b_, min=1e-20), rz, dot(d, Ad))
        x = each(lambda x_, a, d_: x_ + a * d_, x, alpha, d)
        r = each(lambda r_, a, ad: r_ - a * ad, r, alpha, Ad)
        z = precond(r)
        rz_new = dot(r, z)
        beta = each(lambda a, b_: a / torch.clamp(b_, min=1e-20), rz_new, rz)
        d = each(lambda z_, bt, d_: z_ + bt * d_, z, beta, d)
        rz = rz_new
    return x
