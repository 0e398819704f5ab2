"""The port's host commands `info`, `emit` and `generate` against the JAX
CLI's: every output byte-equal (`--loader python` on both sides where a
command loads profiles)."""

import pytest

from hmm_fasta_viterbi_tpu import cli as jax_cli
from hmm_fasta_viterbi_tpu_torch import cli as port_cli
from hmm_fasta_viterbi_tpu_torch import parse_fasta
from hmm_fasta_viterbi_tpu_torch.io.generate import generate_records


def _outputs(tmp_path, argv, out_flag="--out"):
    jax_out, port_out = tmp_path / "jax.out", tmp_path / "port.out"
    assert jax_cli.main([*argv, out_flag, str(jax_out)]) == 0
    assert port_cli.main([*argv, out_flag, str(port_out)]) == 0
    return jax_out.read_bytes(), port_out.read_bytes()


@pytest.fixture(scope="module")
def hmm_db(profile_dir, tmp_path_factory):
    """Three profiles concatenated into one //-separated database file."""
    path = tmp_path_factory.mktemp("hmmdb") / "three.hmm"
    path.write_text("".join((profile_dir / f"{s}.hmm").read_text() for s in (100, 300, 1400)))
    return path


@pytest.mark.parametrize("consensus", [[], ["--consensus"]], ids=["plain", "consensus"])
@pytest.mark.parametrize("fmt", ["tsv", "json"])
@pytest.mark.parametrize("source", ["hmm", "hmm-dir", "hmm-db"])
def test_info_byte_equal_to_jax(profile_dir, hmm_db, tmp_path, source, fmt, consensus):
    target = {"hmm": profile_dir / "100.hmm", "hmm-dir": profile_dir, "hmm-db": hmm_db}[source]
    want, got = _outputs(tmp_path, ["info", f"--{source}", str(target), "--loader", "python",
                                    "--format", fmt, *consensus])
    assert got == want
    rows = {"hmm": 1, "hmm-dir": 24, "hmm-db": 3}[source]
    if fmt == "tsv":
        assert got.count(b"\n") == rows + 1
        assert got.startswith(b"# file\tname\tleng\tmodel_length\tmsv_mu")
    assert (b"consensus" in got) == bool(consensus)


def test_info_needs_one_source(profile_dir, hmm_db):
    for argv in ([], ["--hmm", str(profile_dir / "100.hmm"), "--hmm-db", str(hmm_db)]):
        assert port_cli.main(["info", *argv]) == 2


@pytest.mark.parametrize("argv", [["--seed", "7", "--count", "5"], ["--consensus"],
                                  ["--seed", "3", "--count", "2", "--width", "50"]],
                         ids=["samples", "consensus", "width"])
@pytest.mark.parametrize("stem", ["100", "1400"])
def test_emit_byte_equal_to_jax(profile_dir, tmp_path, stem, argv):
    want, got = _outputs(tmp_path, ["emit", "--hmm", str(profile_dir / f"{stem}.hmm"), *argv])
    assert got == want
    db = parse_fasta(tmp_path / "port.out")
    n = 1 if "--consensus" in argv else int(argv[argv.index("--count") + 1])
    assert len(db) == n and all(r.sequence for r in db.records)


def test_emit_to_stdout(profile_dir, capsys):
    assert jax_cli.main(["emit", "--hmm", str(profile_dir / "100.hmm"), "--seed", "7",
                         "--count", "3"]) == 0
    want = capsys.readouterr().out
    assert port_cli.main(["emit", "--hmm", str(profile_dir / "100.hmm"), "--seed", "7",
                          "--count", "3"]) == 0
    assert capsys.readouterr().out == want and want.count(">") == 3


@pytest.mark.parametrize("argv", [["--seed", "3", "--count", "4", "--length", "50"],
                                  ["--seed", "0", "--count", "2", "--length", "131",
                                   "--width", "60"]], ids=["small", "width"])
def test_generate_byte_equal_to_jax(tmp_path, capsys, argv):
    want, got = _outputs(tmp_path, ["generate", *argv])
    assert got == want
    count, length = int(argv[argv.index("--count") + 1]), int(argv[argv.index("--length") + 1])
    db = parse_fasta(tmp_path / "port.out")
    assert len(db) == count and all(len(r.sequence) == length for r in db.records)
    assert [r.header for r in db.records] == [f"random {i}" for i in range(count)]
    assert [r.sequence for r in generate_records(count, length, int(argv[1]))] == [
        r.sequence for r in db.records]
    assert capsys.readouterr().out.count(f"wrote {count} x {length} aa to") == 2
