"""The bucketed staging's row table on the CPU (the kernels' plain
versions): ``MSVScanner.stage_bucketed`` stages every bucket as a view of
one token buffer and lists all their rows longest first
(``msv_cuda.RowTable``); on the card ``scan_bucketed`` scores them in one
MSV launch (``msv_cuda.msv_table_scan``), each score at its row's original
index, and on the CPU a bucket at a time.

The row table scan (the one launch's plain version) equals the
bucket-at-a-time scan bit for bit, in both modes, on a ragged database
whose buckets hold one or two rows and whose longest row is many times
the median; the buckets and their ``order`` are what a bucket-at-a-time
staging makes; ``msv_cuda.table_walk``, the model of how the kernel hands
the table's rows to its warps, covers every row once, longest first, the longest rows one a block; the scanner counts one
launch a bucketed scan on a CUDA device (the CPU and a sharded staging,
which has no table, one scan a bucket), and the CLI's search line says so.
"""

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu_torch import MSVProfile, parse_hmm
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu_torch.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu_torch.models.msv import length_transitions
from hmm_fasta_viterbi_tpu_torch.ops import msv_cuda
from hmm_fasta_viterbi_tpu_torch.parallel.mesh import make_scan_mesh
from hmm_fasta_viterbi_tpu_torch.pipeline import MSVScanner

MODES = ("exact", "filter")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' small per-residue ops run on one thread here,
    as in tests/test_torch_bucketed.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ragged(seed: int = 21):
    """A body of 40 rows (lognormal, median 60) and a tail whose buckets
    hold one or two rows: 700 and 720 together, 1400 and 3000 alone (50
    times the median), and an empty row."""
    rng = np.random.default_rng(seed)
    body = np.clip(np.round(rng.lognormal(np.log(60), 0.5, 40)), 1, 400)
    lengths = np.concatenate([body, [700, 720, 1400, 3000, 0]]).astype(np.int32)
    lengths = lengths[rng.permutation(lengths.size)]
    tokens = rng.integers(0, 20, size=(lengths.size, int(lengths.max()))).astype(np.int8)
    return tokens, lengths


@pytest.fixture(scope="module")
def ragged():
    return _ragged()


@pytest.fixture(scope="module")
def profiles(profile_dir):
    return [MSVProfile.from_profile(parse_hmm(profile_dir / f"{s}.hmm")) for s in ("100", "200")]


@pytest.mark.parametrize("mode", MODES)
def test_one_launch_equals_bucket_at_a_time(ragged, profiles, mode):
    """The row table scan (the card's one launch over every bucket) equals
    the scan of each bucket put back in order, which is scan_bucketed's on
    the CPU, and the scan of the whole batch, bit for bit; the database has
    buckets of one and two rows and a row 50 times the median."""
    tokens, lengths = ragged
    scanner = MSVScanner(device="cpu")
    bucketed = scanner.stage_bucketed(tokens, lengths)
    sizes = [idx.size for idx in bucketed.order]
    assert min(sizes) == 1 and 2 in sizes
    assert lengths.max() >= 8 * np.median(lengths)
    scan = scanner.scan if mode == "exact" else scanner.scan_filter
    whole = scanner.stage(tokens, lengths)
    for p in profiles:
        got = scanner._scan_table(p, bucketed.table, mode).numpy()
        per_bucket = bucketed.in_order([scan(p, staged) for staged in bucketed.buckets]).numpy()
        assert got.dtype == np.float32 and got.shape == lengths.shape
        np.testing.assert_array_equal(got, per_bucket)
        np.testing.assert_array_equal(scanner.scan_bucketed(p, bucketed, mode=mode), per_bucket)
        np.testing.assert_array_equal(got, scan(p, whole).numpy())
    assert np.isneginf(got[lengths == 0]).all()


@pytest.mark.parametrize("mode", MODES)
def test_table_scan_in_any_order_of_rows(ragged, profiles, mode):
    """msv_table_scan puts each row's score at its own index whatever the
    table's order: a table read backwards (shortest first) scores as the
    staged one does."""
    tokens, lengths = ragged
    scanner = MSVScanner(device="cpu")
    table = scanner.stage_bucketed(tokens, lengths).table
    back = msv_cuda.RowTable(table.tokens, table.row_at.flip(0), table.lengths.flip(0),
                             table.tr_rows.flip(1).contiguous(), table.dest.flip(0), table.width)
    pack = msv_cuda.pack_profile if mode == "exact" else msv_cuda.pack_profile_filter
    emit, consts = pack(profiles[1], msv_cuda.round_up(profiles[1].num_states, 8), "cpu")
    np.testing.assert_array_equal(msv_cuda.msv_table_scan(emit, back, consts).numpy(),
                                  msv_cuda.msv_table_scan(emit, table, consts).numpy())


def test_row_table_is_longest_first_and_maps_every_row(ragged):
    """The table lists every row once, longest first, each with its
    original index, its own residues (PAD_TOKEN past its length, to its
    bucket's width) and its own length transitions."""
    tokens, lengths = ragged
    bucketed = MSVScanner(device="cpu").stage_bucketed(tokens, lengths)
    table = bucketed.table
    dest = table.dest.numpy()
    assert table.dest.dtype == torch.int32 and table.row_at.dtype == torch.int64
    assert sorted(dest) == list(range(lengths.size))
    got_lengths = table.lengths.numpy()
    np.testing.assert_array_equal(got_lengths, lengths[dest])
    assert (np.diff(got_lengths) <= 0).all()
    assert table.width == max(int(lengths.max()), 1)
    loop, move = length_transitions(lengths[dest])
    np.testing.assert_array_equal(table.tr_rows.numpy(), np.stack([loop, move]))
    buffer, row_at = table.tokens.numpy(), table.row_at.numpy()
    widths = {int(i): s.width for idx, s in zip(bucketed.order, bucketed.buckets) for i in idx}
    for r, (at, i) in enumerate(zip(row_at, dest)):
        n = got_lengths[r]
        np.testing.assert_array_equal(buffer[at:at + n], tokens[i, :n])
        assert (buffer[at + n:at + widths[int(i)]] == msv_cuda.PAD_TOKEN).all()


def test_buckets_and_order_are_the_bucket_at_a_time_staging(ragged):
    """Each bucket (a view of the one token buffer) equals the staging of
    its rows alone, field for field, and ``order`` partitions the rows in
    ascending length, as before the row table."""
    tokens, lengths = ragged
    scanner = MSVScanner(device="cpu")
    bucketed = scanner.stage_bucketed(tokens, lengths)
    np.testing.assert_array_equal(np.concatenate(bucketed.order),
                                  np.argsort(lengths, kind="stable"))
    buffer = bucketed.table.tokens
    for idx, got in zip(bucketed.order, bucketed.buckets):
        want = scanner.stage(tokens[idx, :max(int(lengths[idx].max()), 1)], lengths[idx])
        assert got.tokens.is_contiguous()
        assert got.tokens.untyped_storage().data_ptr() == buffer.untyped_storage().data_ptr()
        for field in ("tokens", "lengths", "tr_rows", "tr_probs"):
            np.testing.assert_array_equal(getattr(got, field).numpy(), getattr(want, field).numpy(),
                                          err_msg=field)
        assert got.num_sequences == want.num_sequences == idx.size


def _plans(b: int):
    """(lanes, plan) of the kernel's three kinds of case over ``b`` rows on
    a card of 8 SMs: a register case, a 2-block cluster (4 clusters), the
    rows-in-memory case."""
    return [
        (32, msv_cuda.launch_plan(32, 44, 4, b, 1, 8)),
        (64, msv_cuda.launch_plan(64, 44, 4, b, 1, 8, clusters=4)),
        (msv_cuda.MEM_LANES, msv_cuda.launch_plan(msv_cuda.MEM_LANES, 80, 4, b, 1, 8)),
    ]


@pytest.mark.parametrize("case", range(3), ids=["register", "cluster", "mem"])
@pytest.mark.parametrize("b", [5, 200, 1000])
def test_table_walk_covers_every_row_longest_first(case, b):
    """The kernel's hand-out of the table's rows (its model, table_walk):
    every row once; a warp's rows in table order (longest first); the
    first rows, one a unit (block or cluster), on distinct units: each
    unit's first warp takes one of the table's longest ``units`` rows."""
    lengths = np.sort(np.random.default_rng(b).integers(1, 3000, b))[::-1]
    lanes, plan = _plans(b)[case]
    rows = msv_cuda.table_walk(lengths, lanes, plan)
    flat = sorted(r for held in rows for r in held)
    assert flat == list(range(b))
    assert all(held == sorted(held) for held in rows)
    units = plan.grid if lanes == msv_cuda.MEM_LANES else plan.grid // plan.cluster
    per_unit = 1 if lanes == msv_cuda.MEM_LANES else plan.warps
    firsts = [rows[u * per_unit][0] for u in range(units) if rows[u * per_unit]]
    assert sorted(firsts) == list(range(min(units, b)))


def test_table_walk_leaves_the_longest_row_its_warp():
    """A register case's warps claim rows as they finish, so the warp on a
    row far longer than the rest takes no other row while the others
    share them."""
    lengths = np.array([34350] + [400] * 3000)
    plan = msv_cuda.launch_plan(32, 76, 4, lengths.size, 1, 8)
    rows = msv_cuda.table_walk(lengths, 32, plan)
    assert rows[0] == [0]
    assert max(len(held) for held in rows) > 1


def test_counters_one_launch_a_bucketed_scan(ragged, profiles, monkeypatch):
    """One MSV launch a bucketed scan on a CUDA device, in both modes (the
    row table scan's launch stood in for by its plain version); on the CPU
    and for a staging sharded over a mesh, which has no row table, a scan
    a bucket."""
    tokens, lengths = ragged
    scanner = MSVScanner(device="cpu")
    bucketed = scanner.stage_bucketed(tokens, lengths)
    n = len(bucketed.buckets)
    assert n >= 4
    for mode in MODES:
        scanner.scan_bucketed(profiles[0], bucketed, mode=mode)
    assert (scanner.bucketed_scans, scanner.bucketed_launches) == (2, 2 * n)

    card = MSVScanner(device="cpu")
    tables = []

    def scan_table(profile, table, mode):
        tables.append((table, mode))
        return scanner._scan_table(profile, table, mode)

    monkeypatch.setattr(card, "device", torch.device("cuda"))
    monkeypatch.setattr(card, "_scan_table", scan_table)
    for mode in MODES:
        np.testing.assert_array_equal(card.scan_bucketed(profiles[0], bucketed, mode=mode),
                                      scanner.scan_bucketed(profiles[0], bucketed, mode=mode))
    assert tables == [(bucketed.table, mode) for mode in MODES]
    assert (card.bucketed_scans, card.bucketed_launches) == (2, 2)

    sharded = MSVScanner(mesh=make_scan_mesh(db=2, devices=["cpu", "cpu"]))
    staged = sharded.stage_bucketed(tokens, lengths)
    assert staged.table is None
    np.testing.assert_array_equal(sharded.scan_bucketed(profiles[0], staged),
                                  scanner.scan_bucketed(profiles[0], bucketed))
    assert (sharded.bucketed_scans, sharded.bucketed_launches) == (1, len(staged.buckets))


def test_cli_search_line_gives_launches_a_bucketed_scan(profile_dir, tmp_path, caplog):
    """``scan --stage search --bucketed``'s search line gives the MSV
    launches a bucketed scan: on the CPU one a bucket (on the card 1)."""
    tokens, lengths = _ragged(5)
    fasta = tmp_path / "ragged.fsa"
    write_fasta(fasta, [FastaRecord(f"r{i}", "".join(AMINO_ACIDS[t] for t in tokens[i, :n]))
                        for i, n in enumerate(lengths) if n])
    with caplog.at_level("INFO", logger=port_cli.__name__):
        assert port_cli.main(["scan", "--stage", "search", "--bucketed", "--device", "cpu",
                              "--hmm", str(profile_dir / "100.hmm"), "--fasta", str(fasta),
                              "--loader", "python", "--out", str(tmp_path / "out.tsv")]) == 0
    messages = [r.getMessage() for r in caplog.records]
    buckets = int(next(m for m in messages if m.startswith("bucketed staging:")).split()[2])
    line = next(m for m in messages if m.startswith("search "))
    assert buckets > 1
    assert "packs built" in line and f", {buckets} MSV launches a bucketed scan" in line
