"""Multi-process smoke of the PyTorch port: 2 processes x 4 CPU ranks.

The port's counterpart of tools/multihost_smoke.py. Each process joins a
gloo process group (``parallel.mesh.init_distributed``), builds the global
mesh over every process's 4 ``cpu`` ranks and, with the same seeded batch
on every process, runs:

* ``msv_scan_sharded`` over the global db axis (db = 8): each process
  stages and scans its own rows, the scores are ``all_gather``ed;
* the sp wavefront over db = 1, sp = 8 (MSV, and the Forward on a batch
  whose rows cross every block boundary): the carry crosses from process
  0's last rank to process 1's first by ``send``/``recv``.

Every process checks the scores: against the port's ``msv_oracle_batch``,
and the wavefronts bit for bit against the single-device scans. Process 0
prints MULTIHOST_OK.

Run (the test spawns both):
    python tools/torch_multihost_smoke.py <process_id> <num_processes> <port>
"""

from __future__ import annotations

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LOCAL_RANKS = 4


def main() -> int:
    process_id, num_processes, port = (int(x) for x in sys.argv[1:4])

    import numpy as np
    import torch

    from hmm_fasta_viterbi_tpu_torch import MSVProfile, MSVScanner, P7Profile, msv_oracle_batch
    from hmm_fasta_viterbi_tpu_torch import parse_hmm
    from hmm_fasta_viterbi_tpu_torch.parallel.database import msv_scan_sharded
    from hmm_fasta_viterbi_tpu_torch.parallel.mesh import init_distributed, make_scan_mesh
    from hmm_fasta_viterbi_tpu_torch.parallel.seqblocks import (
        msv_scan_seqblocks, p7_scan_seqblocks,
    )

    init_distributed(device="cpu", init_method=f"tcp://localhost:{port}",
                     world_size=num_processes, rank=process_id)
    cpu = [torch.device("cpu")] * LOCAL_RANKS
    mesh = make_scan_mesh(sp=1, devices=cpu)
    assert mesh.shape == {"db": LOCAL_RANKS * num_processes, "sp": 1}, mesh.shape

    hmm = parse_hmm(REPO / "data" / "profile_HMMs" / "100.hmm")
    profile = MSVProfile.from_profile(hmm)
    rng = np.random.default_rng(0)
    batch, seq_len = 16, 120
    tokens = rng.integers(0, 20, size=(batch, seq_len)).astype(np.int32)
    lengths = np.full(batch, seq_len, dtype=np.int32)
    lengths[1] = 37
    lengths[2] = 0

    got = msv_scan_sharded(profile, tokens, lengths, mesh)
    want = msv_oracle_batch(profile, tokens, lengths)
    assert np.array_equal(got, want), (got, want)
    print(f"[proc {process_id}] db={mesh.shape['db']}: {batch} scores == oracle", flush=True)

    sp_mesh = make_scan_mesh(db=1, sp=LOCAL_RANKS * num_processes, devices=cpu)
    one = MSVScanner(device="cpu")
    staged = one.stage(tokens, lengths)
    got = msv_scan_seqblocks(profile, tokens, lengths, sp_mesh, group=4)
    assert np.array_equal(got, one.scan(profile, staged).numpy()), got
    p7 = P7Profile.from_profile(hmm)
    got = p7_scan_seqblocks(p7, tokens, lengths, sp_mesh, stage="forward", group=4)
    assert np.array_equal(got, one.scan_p7(p7, staged, "forward").numpy()), got
    print(f"[proc {process_id}] sp={sp_mesh.shape['sp']} across processes: MSV and Forward "
          f"== one device", flush=True)

    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    if process_id == 0:
        print(f"[proc {process_id}] MULTIHOST_OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
