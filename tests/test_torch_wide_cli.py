"""The port's CLI on the CPU with profiles wider than 2432 states, against
the JAX CLI (--backend xla).

The two wide profiles of chip_smoke.py (LENG 2701 and 4770, built with
``chip_smoke.join_profiles`` from the JAX-parsed repo profiles) are written
with the JAX package's writer; the database holds random sequences and one
60-residue consensus piece of each wide profile taken past its first 2432
states. ``scan`` (the MSV stage) and ``sweep`` over 100.hmm and both give
the JAX CLI's reports byte for byte; ``scan --stage search --domains`` the
same rows, hit flags, envelopes and domain spans, domain scores within 2e-3
nats; ``--fast`` the plain search's hits. The three-profile join past 4864
states (LENG 6977) gives the JAX CLI's `scan` report too. Every comparison
with the JAX CLI parses with --loader python on both sides.
"""

import logging

import numpy as np
import pytest
import torch

import chip_smoke
from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu import parse_hmm as jax_parse_hmm
from hmm_fasta_viterbi_tpu.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu.io.hmmwrite import write_hmm
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from test_torch_search import _domain_fields, _same_domains
from test_torch_search import _rows as _search_rows
from test_torch_sweep import _rows

# where each wide profile's consensus piece starts: past 2432 states
PIECE_AT = {("1400", "1301"): 2600, ("2405", "2365"): 3400}
PIECE_LEN = 60
IDS = {pair: "+".join(pair) for pair in chip_smoke.WIDE_PAIRS}


def _letters(tokens) -> str:
    return "".join(AMINO_ACIDS[int(t)] for t in tokens)



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The plain versions at M_pad up to 4872 on two threads: the suite runs
    files side by side, where more threads a worker only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def wide_dir(profile_dir, tmp_path_factory):
    """100.hmm and the two wide profiles, each in its own file; returns
    (directory, {pair: path}, FASTA path)."""
    out = tmp_path_factory.mktemp("wide_cli")
    (out / "100.hmm").write_bytes((profile_dir / "100.hmm").read_bytes())
    rng = np.random.default_rng(71)
    records = [FastaRecord(f"rand{k}", _letters(rng.integers(0, 20, 40 + 6 * k)))
               for k in range(4)]
    paths = {}
    for pair in chip_smoke.WIDE_PAIRS:
        hmm = chip_smoke.join_profiles(*(jax_parse_hmm(profile_dir / f"{s}.hmm") for s in pair))
        paths[pair] = out / f"wide_{'_'.join(pair)}.hmm"
        write_hmm(hmm, paths[pair])
        consensus = np.argmax(hmm.match_emissions[1:], axis=1)
        start = PIECE_AT[pair]
        records.append(FastaRecord(f"piece_{IDS[pair]}",
                                   _letters(consensus[start:start + PIECE_LEN])))
    fasta = out / "wide.fsa"
    write_fasta(fasta, records)
    return out, paths, fasta


@pytest.mark.parametrize("pair", chip_smoke.WIDE_PAIRS, ids=IDS.get)
def test_wide_scan_msv_byte_equal_to_jax(wide_dir, tmp_path, pair):
    """`scan` (MSV) with a wide profile: the report equals the JAX CLI's."""
    _, paths, fasta = wide_dir
    common = ["scan", "--loader", "python", "--hmm", str(paths[pair]), "--fasta", str(fasta)]
    jax_out, port_out = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jax_cli.main([*common, "--backend", "xla", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()


@pytest.mark.parametrize("pair", chip_smoke.WIDE_PAIRS, ids=IDS.get)
def test_wide_search_domains_matches_jax(wide_dir, tmp_path, pair):
    """`scan --stage search --domains` with a wide profile: the JAX CLI's
    rows, hit flags, envelopes and domain spans; the consensus piece is a
    hit with one domain inside it."""
    _, paths, fasta = wide_dir
    common = ["scan", "--hmm", str(paths[pair]), "--fasta", str(fasta), "--stage", "search",
              "--loader", "python", "--domains"]
    jax_out, port_out = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jax_cli.main([*common, "--backend", "xla", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    got = _domain_fields(_search_rows(port_out, "tsv"), "tsv")
    _same_domains(got, _domain_fields(_search_rows(jax_out, "tsv"), "tsv"))
    piece = next(g for g in got if g[0] == f"piece_{IDS[pair]}")
    assert piece[1] and piece[4] >= 1 and 1 <= piece[2] <= piece[3] <= PIECE_LEN


@pytest.mark.parametrize("pair", chip_smoke.WIDE_PAIRS, ids=IDS.get)
def test_wide_search_fast_same_hits(wide_dir, tmp_path, pair, caplog):
    """`scan --stage search --fast` with a wide profile reports the plain
    search's hit rows."""
    _, paths, fasta = wide_dir
    base = ["scan", "--hmm", str(paths[pair]), "--fasta", str(fasta), "--stage", "search",
            "--device", "cpu"]
    plain_out, fast_out = tmp_path / "plain.tsv", tmp_path / "fast.tsv"
    assert port_cli.main([*base, "--out", str(plain_out)]) == 0
    with caplog.at_level(logging.INFO, logger=port_cli.__name__):
        assert port_cli.main([*base, "--fast", "--out", str(fast_out)]) == 0

    def hits(path):
        return [r for r in _rows(path, "tsv") if r[7] == "1"]

    assert hits(fast_out) == hits(plain_out) and hits(plain_out)
    assert any(r.getMessage().startswith("search ") for r in caplog.records)


def test_wide_sweep_byte_equal_to_jax(wide_dir, tmp_path):
    """`sweep --hmm-dir` over 100.hmm and both wide profiles (the MSV stage;
    on the CPU the stacked plain version groups them by width): the report
    equals the JAX CLI's byte for byte."""
    directory, _, fasta = wide_dir
    common = ["sweep", "--loader", "python", "--hmm-dir", str(directory), "--fasta", str(fasta)]
    jax_out, port_out = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jax_cli.main([*common, "--backend", "xla", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    want = jax_out.read_bytes()
    assert port_out.read_bytes() == want
    assert len({r[1] for r in _rows(port_out, "tsv")}) == 3


def test_mem_join_scan_msv_byte_equal_to_jax(wide_dir, profile_dir, tmp_path):
    """`scan` (MSV) with the three-profile join of chip_smoke.MEM_JOINS (LENG
    6977: the rows-in-memory case on the card), both CLIs parsing with
    --loader python: the report equals the JAX CLI's byte for byte."""
    _, _, fasta = wide_dir
    stems = chip_smoke.MEM_JOINS[0]
    hmm = chip_smoke.join_profiles(*(jax_parse_hmm(profile_dir / f"{s}.hmm") for s in stems))
    assert hmm.leng == 6977
    path = tmp_path / "mem.hmm"
    write_hmm(hmm, path)
    common = ["scan", "--loader", "python", "--hmm", str(path), "--fasta", str(fasta)]
    jax_out, port_out = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jax_cli.main([*common, "--backend", "xla", "--out", str(jax_out)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--out", str(port_out)]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()
