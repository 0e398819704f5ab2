"""The device mesh of the PyTorch port: a ``[db][sp]`` grid of torch devices.

The counterpart of ``hmm_fasta_viterbi_tpu/parallel/mesh.py``, with the same
two axes:

* ``db`` — the database axis: sequences are independent, so each db shard
  of a batch (a contiguous row slice) is scanned on its own device and the
  scores are gathered in row order (``parallel.database``);
* ``sp`` — the sequence axis: residue blocks of long sequences, scanned as
  a wavefront from rank to rank with the DP carry handed on at each block
  boundary (``parallel.seqblocks``).

A mesh may name one device more than once: ``[cpu] * 8`` runs every
sharded path through the plain versions, as the JAX package's virtual CPU
devices do, and ``[cuda:0] * k`` runs it through the kernels of one card.
Every launch on a shard runs under :func:`device_scope`, so the kernels'
launchers, which launch on the calling thread's current device, meet the
shard's device.

Across processes: call :func:`init_distributed` first. The mesh then
spans every process's devices, process-major, as ``jax.devices()`` does
after ``jax.distributed.initialize``; each cell names the process that
owns it, a process scans the cells it owns, scores are gathered with
``all_gather`` and a wavefront carry that crosses processes goes by
``send``/``recv``.
"""

from __future__ import annotations

import contextlib

import torch

DB_AXIS = "db"
SP_AXIS = "sp"


def device_scope(device: torch.device):
    """The context that makes ``device`` the current CUDA device (a no-op
    on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _named(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card, as
    the tensors made there report it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def process_group():
    """``torch.distributed`` once :func:`init_distributed` has run, else
    None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class ScanMesh:
    """A ``[db][sp]`` grid of devices and the process that owns each cell.

    ``devices[d][p]`` is the device of cell ``(d, p)`` on its own process
    (every process has the same local devices) and ``ranks[d][p]`` that
    process; ``shape`` is ``{"db": db, "sp": sp}`` like JAX's
    ``mesh.shape``. This process is ``process_index`` of
    ``process_count``."""

    def __init__(self, devices: list[list[torch.device]], ranks: list[list[int]] | None = None,
                 process_index: int = 0, process_count: int = 1):
        self.devices = [[_named(x) for x in row] for row in devices]
        self.ranks = ranks if ranks is not None else [[0] * len(row) for row in self.devices]
        self.process_index = process_index
        self.process_count = process_count

    @property
    def shape(self) -> dict:
        return {DB_AXIS: len(self.devices), SP_AXIS: len(self.devices[0])}

    def local(self, d: int, p: int = 0) -> bool:
        """Cell ``(d, p)`` belongs to this process."""
        return self.ranks[d][p] == self.process_index

    def device(self, d: int, p: int = 0) -> torch.device:
        return self.devices[d][p]

    @property
    def first_device(self) -> torch.device:
        """This process's first device: where gathered results land."""
        for d, row in enumerate(self.devices):
            for p, device in enumerate(row):
                if self.local(d, p):
                    return device
        return self.devices[0][0]

    def local_shards(self) -> list[int]:
        """The db shards this process scans: those whose ``sp = 0`` cell it
        owns (a db-sharded scan runs on the first column)."""
        return [d for d in range(self.shape[DB_AXIS]) if self.local(d)]

    def __repr__(self) -> str:
        return f"ScanMesh({self.shape}, devices={self.devices})"


def _visible_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def make_scan_mesh(db: int | None = None, sp: int = 1, devices=None) -> ScanMesh:
    """Build a (db, sp) mesh. Defaults: all devices on the db axis.

    ``devices`` defaults to every visible CUDA device; an explicit list may
    name a device more than once. After :func:`init_distributed` the list
    is this process's, and the mesh lays out every process's list, process
    after process (each process must pass as many devices). The rules and
    error texts are ``make_scan_mesh``'s of the JAX package."""
    local = [torch.device(x) for x in (_visible_devices() if devices is None else devices)]
    dist = process_group()
    count, index = (dist.get_world_size(), dist.get_rank()) if dist else (1, 0)
    n = len(local) * count
    if db is None:
        if n % sp != 0:
            raise ValueError(f"{n} devices not divisible by sp={sp}")
        db = n // sp
    if db * sp > n or db < 1 or sp < 1:
        raise ValueError(f"mesh {db}x{sp} needs more than the {n} available devices")
    cells = [(k // len(local), local[k % len(local)]) for k in range(db * sp)]
    return ScanMesh(
        [[cells[d * sp + p][1] for p in range(sp)] for d in range(db)],
        [[cells[d * sp + p][0] for p in range(sp)] for d in range(db)],
        process_index=index, process_count=count,
    )


def shard_rows(n: int, num_shards: int) -> list[slice]:
    """A contiguous split of ``n`` rows into ``num_shards`` slices, in
    order, their sizes differing by at most one (a slice may be empty)."""
    return [slice(k * n // num_shards, (k + 1) * n // num_shards) for k in range(num_shards)]


def gather_rows(parts: dict, mesh: ScanMesh, dim: int = -1, owner=None) -> torch.Tensor:
    """The shards' results ``parts`` ({db shard: tensor}, rows along
    ``dim``) joined in db order on ``mesh.first_device``.

    ``parts`` holds every shard, in one process or across processes. Across
    processes a part counts only on its ``owner(d)`` (default: the owner of
    cell ``(d, 0)``); elsewhere it is a stand-in of the right shape. The
    rows are padded to the largest shard and ``all_gather``ed, so every
    process returns the whole result."""
    first = mesh.first_device
    num_db = mesh.shape[DB_AXIS]
    dist = process_group() if mesh.process_count > 1 else None
    if dist is None:
        return torch.cat([parts[d].to(first, non_blocking=True) for d in range(num_db)], dim=dim)
    owner = owner or (lambda d: mesh.ranks[d][0])
    rows = {d: parts[d].movedim(dim, 0) for d in range(num_db)}
    width = max(r.shape[0] for r in rows.values())
    buf = torch.zeros((num_db, width, *rows[0].shape[1:]), dtype=rows[0].dtype, device=first)
    for d, r in rows.items():
        if owner(d) == mesh.process_index:
            buf[d, : r.shape[0]] = r.to(first)
    bufs = [torch.empty_like(buf) for _ in range(mesh.process_count)]
    dist.all_gather(bufs, buf)
    joined = torch.cat([bufs[owner(d)][d, : rows[d].shape[0]] for d in range(num_db)])
    return joined.movedim(0, dim)


def init_distributed(device: str = "cuda", **kwargs) -> None:
    """Multi-process entry: ``torch.distributed.init_process_group`` with
    NCCL for a CUDA ``device`` and gloo for the CPU; ``kwargs`` go to it
    (``init_method="tcp://localhost:PORT"``, ``world_size``, ``rank``).
    Afterwards :func:`make_scan_mesh` lays the mesh over every process's
    devices."""
    import torch.distributed as dist

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, **kwargs)
