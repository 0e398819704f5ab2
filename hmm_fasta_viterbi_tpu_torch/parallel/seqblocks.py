"""Long-sequence block sharding: a wavefront pipeline over the ``sp`` axis.

The counterpart of ``hmm_fasta_viterbi_tpu/parallel/seqblocks.py``. The DP
recurrences are sequential along residues, but their state across a block
boundary is small: the M row plus the specials for MSV; the M, I and D
rows plus the specials for Viterbi; and for the Forward the same plus its
log scale and Kahan compensation, which make its rescaling resumable. So
the residues of a batch are cut into ``sp`` blocks of equal length, block
``p`` staged on rank ``p`` of the sp axis, and the rows run through the
ranks as a wavefront: in round ``t`` rank ``p`` scans row group ``g = t - p``
of its block, from the carry rank ``p - 1`` handed it at the end of round
``t - 1`` (rank 0 from the row-0 carry), and hands its carry on to rank
``p + 1``. With G row groups the pipeline takes ``sp + G - 1`` rounds; only
the last rank's scores are kept. The db axis runs one such wavefront a
db shard (a row slice of the batch).

One function a family drives the blocks (:func:`msv_scan_seqblocks`,
:func:`p7_scan_seqblocks`), through the single-device path's kernels on a
CUDA device and their plain versions on the CPU: JAX's lax.scan and Pallas
twins (``msv_scan_seqblocks``, ``*_pallas``) are one function here. Each
block takes block-local lengths, ``clamp(lengths - p * blk, 0, blk)``, and
the whole row's length transitions; a row that ends in an earlier block
reaches a later rank with length 0 and leaves its carry as it was. The
block length is a multiple of :data:`BLOCK_GRANULE`, so the Forward's
rescale points (every ``p7_cuda.FWD_RESCALE_GROUP`` residues from a call's
start) fall where one call over the whole row puts them, and every family
equals its single-device scan bit for bit.

The carry moves with ``Tensor.to(next_device, non_blocking=True)`` behind
an event of the producing stream within a process, and by ``send``/
``recv`` between processes (``parallel.mesh.init_distributed``). A row
group is as many rows as fill the kernel's launch plan on the card
(``msv_cuda.device_plan``, ``p7_cuda.device_plan``) and the whole shard on
the CPU, unless the ``group`` argument of :func:`msv_scan_seqblocks` or
:func:`p7_scan_seqblocks` says otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.msv import MSVProfile, length_transitions
from ..ops import msv_cuda, p7_cuda
from ..pipeline import MSVScanner
from .mesh import (
    DB_AXIS, SP_AXIS, ScanMesh, device_scope, gather_rows, process_group, shard_rows,
)

# the block length's granule: JAX's 32-residue token group (its l_chunk is
# rounded to 32), a multiple of the Forward's rescale group
BLOCK_GRANULE = 32
assert BLOCK_GRANULE % p7_cuda.FWD_RESCALE_GROUP == 0


def block_length(seq_len: int, sp: int) -> int:
    """Residues a rank's block holds: ``ceil(seq_len / sp)`` rounded up to
    :data:`BLOCK_GRANULE` (at least one granule)."""
    return msv_cuda.round_up(max(-(-seq_len // sp), 1), BLOCK_GRANULE)


@dataclasses.dataclass
class _Family:
    """How the wavefront runs one kernel family on a device: ``pack(scanner)``
    the profile's pack there, ``init(pack, block)`` the row-0 carry of a
    row group, ``step(pack, block, carry)`` -> (scores, carry), and
    ``fill(pack, device)`` the rows that fill the kernel's launch plan. A
    block is a :class:`pipeline.StagedDatabase` of a row group."""

    pack: object
    init: object
    step: object
    fill: object


def _msv_fill(pack, device) -> int:
    emit = pack[0]
    m_pad = emit.shape[1]
    lanes, _ = msv_cuda.kernel_case(m_pad)
    plan = msv_cuda.device_plan(m_pad, emit.element_size(), 1 << 20, 1, device)
    if lanes == 32:
        return plan.warps * plan.grid
    if lanes == 64:  # a pair of warps a sequence, one in each block of a cluster
        return plan.warps * plan.grid // plan.cluster
    return plan.grid


def _msv_family(profile: MSVProfile) -> _Family:
    def step(pack, block, carry):
        score, m, s = msv_cuda.msv_scan(pack[0], block.tokens, block.lengths, block.tr_rows,
                                        pack[1], *carry)
        return score, (m, s)

    return _Family(
        pack=lambda scanner: scanner._device_profile(profile),
        init=lambda pack, block: msv_cuda.init_carry(block.tr_rows, pack[0].shape[1]),
        step=step,
        fill=_msv_fill,
    )


def _p7_family(p7, stage: str) -> _Family:
    if stage == "forward":
        def init(pack, block):
            return p7_cuda.forward_init_carry(block.tr_probs, pack.m_pad)

        def step(pack, block, carry):
            score, *carry = p7_cuda.forward_prob_scan(
                *pack[:4], block.tokens, block.lengths, block.tr_rows, block.tr_probs,
                pack.consts, *carry)
            return score, tuple(carry)

        def fill(pack, device):
            return _p7_fill("forward", pack, pack.chain.shape[0], device)
    else:
        def init(pack, block):
            return p7_cuda.viterbi_init_carry(block.tr_rows, pack.m_pad)

        def step(pack, block, carry):
            args = (*pack[:4], block.tokens, block.lengths, block.tr_rows, pack.consts, *carry)
            if pack.lazy_k:  # the lazy kernel's d slot carries its pre_diag row
                score, *carry, _replays = p7_cuda.viterbi_lazy_scan(*args, pack.lazy_k)
            else:
                score, *carry = p7_cuda.viterbi_scan(*args)
            return score, tuple(carry)

        def fill(pack, device):
            full = p7_cuda.chain_passes(pack.m_pad)
            if pack.lazy_k:  # the passes the lazy wrapper runs
                return _p7_fill("lazy", pack, min(max(pack.lazy_k, 1), full), device)
            return _p7_fill("eager", pack, full, device)

    return _Family(pack=lambda scanner: scanner._p7_pack(p7, stage), init=init, step=step,
                   fill=fill)


def _p7_fill(kind: str, pack, passes: int, device) -> int:
    plan = p7_cuda.device_plan(kind, pack.m_pad, passes, 1 << 20, device)
    return plan.groups * plan.grid // max(plan.cluster, 1)  # the wide block's is 0


def _hand_on(carry: tuple, src: torch.device, dst: torch.device) -> tuple:
    """The carry of a block on ``src``, on ``dst`` for the next rank: the
    copies wait on an event of ``src``'s stream."""
    if src == dst:
        return carry
    if src.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(src))
        if dst.type == "cuda":
            torch.cuda.current_stream(dst).wait_event(done)
    return tuple(x.to(dst, non_blocking=True) for x in carry)


def _wavefront(mesh: ScanMesh, family: _Family, tokens, lengths, group: int | None
               ) -> torch.Tensor:
    """Scores ``[B]`` of a host batch on ``mesh.first_device``: the batch's
    rows split over db, its residues over sp, scanned as a wavefront."""
    tokens = np.asarray(tokens)
    lengths = np.asarray(lengths, dtype=np.int32)
    b, seq_len = tokens.shape
    num_db, num_sp = mesh.shape[DB_AXIS], mesh.shape[SP_AXIS]
    blk = block_length(seq_len, num_sp)
    rows = shard_rows(b, num_db)
    tr_rows = np.stack(length_transitions(lengths))
    tr_probs = p7_cuda.length_transition_probs(lengths)
    dist = process_group() if mesh.process_count > 1 else None
    if mesh.process_count > 1 and dist is None:
        raise RuntimeError("a mesh across processes needs torch.distributed initialised")

    scanners: dict[torch.device, MSVScanner] = {}
    packs: dict[torch.device, object] = {}
    blocks: dict[tuple[int, int], object] = {}
    for d in range(num_db):
        for p in range(num_sp):
            if not mesh.local(d, p):
                continue
            device = mesh.device(d, p)
            if device not in scanners:
                scanners[device] = MSVScanner(device=device)
                with device_scope(device):
                    packs[device] = family.pack(scanners[device])
            # the block's columns (fewer than blk, or none, past the batch's
            # width: its rows end before them)
            local = np.clip(lengths[rows[d]] - p * blk, 0, blk).astype(np.int32)
            with device_scope(device):
                staged = scanners[device].stage(tokens[rows[d], p * blk:(p + 1) * blk], local)
                # the whole row's length transitions, not the block's
                blocks[(d, p)] = dataclasses.replace(
                    staged, tr_rows=torch.from_numpy(tr_rows[:, rows[d]]).to(device),
                    tr_probs=torch.from_numpy(tr_probs[:, rows[d]]).to(device))

    if group is None:
        if blocks and mesh.first_device.type == "cuda":
            device = mesh.device(*next(iter(blocks)))
            group = family.fill(packs[device], device)
        else:
            group = max(max(r.stop - r.start for r in rows), 1)
    group = max(int(group), 1)
    num_groups = [-(-(r.stop - r.start) // group) for r in rows]

    # the last rank's scores; across processes a stand-in where another
    # process holds the last rank
    scores = {d: torch.zeros(rows[d].stop - rows[d].start, dtype=torch.float32,
                             device=mesh.device(d, num_sp - 1) if mesh.local(d, num_sp - 1)
                             else mesh.first_device)
              for d in range(num_db)}
    carries: dict[tuple[int, int, int], tuple] = {}
    sends = []
    for t in range(num_sp + max(num_groups, default=0) - 1):
        for d in range(num_db):
            for p in range(num_sp):
                g = t - p
                if not 0 <= g < num_groups[d] or not mesh.local(d, p):
                    continue
                device = mesh.device(d, p)
                pack = packs[device]
                sel = slice(g * group, min((g + 1) * group, rows[d].stop - rows[d].start))
                whole = blocks[(d, p)]
                with device_scope(device):
                    block = dataclasses.replace(
                        whole, tokens=whole.tokens[sel], lengths=whole.lengths[sel],
                        tr_rows=whole.tr_rows[:, sel].contiguous(),
                        tr_probs=whole.tr_probs[:, sel].contiguous(),
                        num_sequences=sel.stop - sel.start)
                    if p > 0 and mesh.local(d, p - 1):
                        carry = carries.pop((d, p, g))
                    else:
                        carry = family.init(pack, block)
                        if p > 0:  # overwritten by rank p - 1's carry
                            for x in carry:
                                dist.recv(x, src=mesh.ranks[d][p - 1])
                    score, carry = family.step(pack, block, carry)
                    if p == num_sp - 1:
                        scores[d][sel] = score
                    elif mesh.local(d, p + 1):
                        carries[(d, p + 1, g)] = _hand_on(carry, device, mesh.device(d, p + 1))
                    else:
                        for x in carry:
                            x = x.contiguous()
                            sends.append((x, dist.isend(x, dst=mesh.ranks[d][p + 1])))
    for _, work in sends:
        work.wait()
    return gather_rows(scores, mesh, owner=lambda d: mesh.ranks[d][num_sp - 1])


def msv_scan_seqblocks(profile: MSVProfile, tokens: np.ndarray, lengths: np.ndarray,
                       mesh: ScanMesh, group: int | None = None) -> np.ndarray:
    """MSV scores (f32 ``[B]``, host) with residue blocks sharded over
    ``sp`` and rows over ``db``: the MSV kernel (B1) as the block scanner on
    the card, its plain version on the CPU; bit-equal to the single-device
    scan. ``group`` rows advance through the pipeline at a time (default:
    see the module docstring)."""
    return _wavefront(mesh, _msv_family(profile), tokens, lengths, group).cpu().numpy()


def p7_scan_seqblocks(p7, tokens: np.ndarray, lengths: np.ndarray, mesh: ScanMesh,
                      stage: str = "viterbi", group: int | None = None) -> np.ndarray:
    """Viterbi or Forward scores (f32 ``[B]``, host) with residue blocks
    sharded over ``sp``: ``stage="viterbi"`` runs the lazy kernel when
    ``e_skip_d_ok(p7)`` holds and the eager one otherwise, ``"forward"`` the
    probability-space Forward; each bit-equal to the single-device scan."""
    if stage not in ("viterbi", "forward"):
        raise ValueError(f"stage must be 'viterbi' or 'forward', got {stage!r}")
    return _wavefront(mesh, _p7_family(p7, stage), tokens, lengths, group).cpu().numpy()


@dataclasses.dataclass
class _HostStaged:
    """The host batch a :class:`SeqblockScanner` scans: the wavefront pads
    and shards it on every call (each stage restages its survivors)."""

    tokens: np.ndarray
    lengths: np.ndarray
    num_sequences: int


class SeqblockScanner:
    """An ``MSVScanner`` stand-in that runs every stage through the sp-axis
    wavefront (``--mesh db=N,sp=M`` with M > 1): a drop-in for
    ``pipeline.SearchPipeline``, whose cascade (thresholds, survivor
    restaging) is unchanged. Its scans return the scores on
    ``self.device``, as the scanner's do.

    The upper-bound prefilters have no wavefront, so ``scan_filter`` and
    ``scan_p7_filter`` run the exact wavefronts (a bound that holds
    trivially), as in the JAX package; ``scan_many`` scans one profile
    after the other."""

    mesh = None  # the scanner's own db sharding; the wavefront's is sp_mesh
    # no pack cache and no bucketed staging (refused): the search log's
    # counters stay at 0
    pack_lookups = pack_builds = bucketed_scans = bucketed_launches = 0

    def __init__(self, sp_mesh: ScanMesh):
        self.sp_mesh = sp_mesh
        self.device = sp_mesh.first_device

    def stage(self, tokens: np.ndarray, lengths: np.ndarray) -> _HostStaged:
        tokens = np.asarray(tokens)
        return _HostStaged(tokens, np.asarray(lengths, np.int32), tokens.shape[0])

    def stage_fasta(self, db) -> _HostStaged:
        return self.stage(*db.encode())

    def _run(self, family: _Family, staged: _HostStaged) -> torch.Tensor:
        return _wavefront(self.sp_mesh, family, staged.tokens, staged.lengths, None)

    def scan(self, profile: MSVProfile, staged: _HostStaged) -> torch.Tensor:
        return self._run(_msv_family(profile), staged)

    def scan_filter(self, profile: MSVProfile, staged: _HostStaged) -> torch.Tensor:
        return self.scan(profile, staged)

    def scan_p7(self, p7, staged: _HostStaged, stage: str = "viterbi") -> torch.Tensor:
        if stage not in ("viterbi", "forward"):
            raise ValueError(f"stage must be 'viterbi' or 'forward', got {stage!r}")
        return self._run(_p7_family(p7, stage), staged)

    def scan_p7_filter(self, p7, staged: _HostStaged, window_log2=None) -> torch.Tensor:
        return self.scan_p7(p7, staged, stage="viterbi")

    def scan_many(self, profiles, staged: _HostStaged, mode: str = "exact") -> dict:
        if mode not in ("exact", "filter"):
            raise ValueError(f"mode must be 'exact' or 'filter', got {mode!r}")
        return {p.name: self.scan(p, staged).cpu().numpy() for p in profiles}
