"""A multi-device dry run of the port: every sharded path once, on a mesh.

The counterpart of ``__graft_entry__.py::dryrun_multichip`` of the JAX
package: the same checks in the same order, over an ``n``-device (db x sp)
mesh of ``device``. Where fewer such devices exist the mesh names the one
device ``n`` times (``[cuda:0] * n``, ``[cpu] * n``): every sharded and
wavefront path then runs through the real kernels, or their plain versions
on the CPU. Unlike JAX's, it never switches to another platform.

    python -m hmm_fasta_viterbi_tpu_torch.parallel.dryrun [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from ..io.hmmio import parse_hmm
from ..models.msv import MSVProfile
from ..models.p7 import P7Profile
from ..ops.posterior_cuda import posterior_coverage_batch
from ..ops.reference import msv_oracle_batch
from ..pipeline import MSVScanner, SearchPipeline
from .database import ShardedStager, msv_scan_sharded, pad_batch_to_mesh
from .mesh import make_scan_mesh
from .seqblocks import SeqblockScanner, msv_scan_seqblocks, p7_scan_seqblocks

PROFILE = pathlib.Path(__file__).resolve().parents[2] / "data" / "profile_HMMs" / "100.hmm"


def _devices(n_devices: int, device) -> list[torch.device]:
    """``n_devices`` devices of ``device``'s type: the real ones when there
    are enough, else ``device`` named ``n_devices`` times."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: device cuda, but torch.cuda.is_available() "
                               "is false")
        real = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
        if len(real) >= n_devices:
            return real[:n_devices]
    return [device] * n_devices


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One full sharded scan step over an ``n_devices`` (db x sp) mesh, and
    every other mesh path once; raises on a mismatch."""
    devices = _devices(n_devices, device)
    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    db = n_devices // sp
    mesh = make_scan_mesh(db=db, sp=sp, devices=devices)

    hmm = parse_hmm(PROFILE)
    profile = MSVProfile.from_profile(hmm)
    rng = np.random.default_rng(1)
    batch, seq_len = 2 * db, 32
    tokens = rng.integers(0, 20, size=(batch, seq_len)).astype(np.int32)
    lengths = np.full(batch, seq_len, dtype=np.int32)
    lengths[0] = 17  # ragged masking across block boundaries

    # the full multi-device step: db-sharded and the sp wavefront
    got = msv_scan_seqblocks(profile, tokens, lengths, mesh)
    assert got.shape == (batch,) and np.all(np.isfinite(got))

    # pure database sharding
    db_mesh = make_scan_mesh(db=n_devices, sp=1, devices=devices)
    got_db = msv_scan_sharded(profile, tokens, lengths, db_mesh)
    np.testing.assert_array_equal(got, got_db)

    # the wavefront a row at a time (JAX: its Pallas wavefront)
    got_wf = msv_scan_seqblocks(profile, tokens, lengths, mesh, group=1)
    np.testing.assert_array_equal(got_wf, got_db)

    # the db-sharded kernel on a batch padded to the mesh
    mesh_scanner = MSVScanner(mesh=db_mesh)
    tokens_p, lengths_p, _ = pad_batch_to_mesh(tokens, lengths, 4 * n_devices)
    got_pad = mesh_scanner.scan(profile, mesh_scanner.stage(tokens_p, lengths_p))
    np.testing.assert_array_equal(got_pad.cpu().numpy()[:batch], got_db)

    # the full cascade sharded over db: MSV filter -> exact -> Viterbi
    # filter -> Viterbi -> Forward through the mesh scanner
    mstaged = mesh_scanner.stage(tokens, lengths)
    result = SearchPipeline(mesh_scanner, fast_msv=True, fast_viterbi=True).search(
        hmm, mstaged, tokens, lengths)
    assert result.msv_scores.shape == (batch,)
    # the fast cascade keeps the filter's scores of the rows it rejects
    assert np.all(result.msv_scores >= got_db)
    p7 = P7Profile.from_profile(hmm)
    vit = mesh_scanner.scan_p7(p7, mstaged, stage="viterbi").cpu().numpy()
    fwd = mesh_scanner.scan_p7(p7, mstaged, stage="forward").cpu().numpy()
    vfl = mesh_scanner.scan_p7_filter(p7, mstaged).cpu().numpy()
    assert np.all(np.isfinite(vit)) and np.all(np.isfinite(fwd))
    assert np.all(vfl >= vit)

    # the p7 wavefront over the (db, sp) mesh
    vit_wf = p7_scan_seqblocks(p7, tokens, lengths, mesh, stage="viterbi")
    np.testing.assert_array_equal(vit_wf, vit)

    # the whole cascade through the wavefront (scan --stage search --mesh db=,sp=)
    sb = SeqblockScanner(mesh)
    sp_result = SearchPipeline(sb).search(hmm, sb.stage(tokens, lengths), tokens, lengths)
    np.testing.assert_array_equal(sp_result.msv_scores, got_db)

    # the batched posterior decode (--domains) on the mesh
    cov, _ = posterior_coverage_batch(p7, tokens[:2], lengths[:2], mesh=db_mesh)
    assert cov.shape[0] == 2 and np.all(np.isfinite(cov))

    # the bucketed scan on the db mesh
    rag_lengths = np.array([17, 32, 9, 32] * max(db, 1), dtype=np.int32)
    rag_tokens = rng.integers(0, 20, size=(rag_lengths.size, 32)).astype(np.int32)
    for r, n in enumerate(rag_lengths):
        rag_tokens[r, n:] = 0
    bucketed = mesh_scanner.stage_bucketed(rag_tokens, rag_lengths)
    np.testing.assert_array_equal(mesh_scanner.scan_bucketed(profile, bucketed),
                                  msv_oracle_batch(profile, rag_tokens, rag_lengths))

    # the streamed search on the db mesh: batches staged by the side-stream
    # stager of each shard's device (--stream), searched one after another
    stager = ShardedStager(mesh_scanner)
    pipeline = SearchPipeline(mesh_scanner, fast_msv=True, fast_viterbi=True)
    half = max(batch // 2, 1)
    streamed = [pipeline.search(hmm, stager(tokens[lo:lo + half], lengths[lo:lo + half]),
                                tokens[lo:lo + half], lengths[lo:lo + half])
                for lo in range(0, batch, half)]
    np.testing.assert_array_equal(np.concatenate([r.msv_scores for r in streamed]),
                                  result.msv_scores)
    np.testing.assert_array_equal(np.concatenate([r.passed_msv for r in streamed]),
                                  result.passed_msv)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    print(f"dryrun_multichip ok on {args.n_devices} x {args.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
