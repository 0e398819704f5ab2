"""The port's copy of ops/traceback.py (the host Viterbi traceback and the
alignment renderers behind `scan --align`, `--msa-out` and `align`) against
the JAX package's, on the same seeded token rows: paths, domains, scores,
the envelope fallback, the consensus and every rendering equal; the walked
path's score (f64) within 1e-4 of the port's f32 Viterbi oracle plus the
oracle's own rounding, one f32 rounding a residue at the score's size
(L * eps32 * |score|): the f32 oracle drifts 4.1e-4 on a 94-nat homolog of
300.hmm and 1.1e-3 on its 654-nat two-copy row."""

import dataclasses

import numpy as np
import pytest

from hmm_fasta_viterbi_tpu import parse_hmm as jax_parse_hmm
from hmm_fasta_viterbi_tpu.models.p7 import P7Profile as JaxP7Profile
from hmm_fasta_viterbi_tpu.ops import traceback as jax_tb
from hmm_fasta_viterbi_tpu_torch import P7Profile, parse_hmm, viterbi_oracle_batch
from hmm_fasta_viterbi_tpu_torch.models.sample import sample_sequences
from hmm_fasta_viterbi_tpu_torch.ops import traceback as port_tb

VIT_TOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", params=["100", "300"])
def case(request, profile_dir):
    """(JAX P7Profile, the port's P7Profile, seeded token rows): the
    consensus, two consensus copies joined by junk, three homologs sampled
    from the profile, a consensus fragment inside random residues, random
    rows of 1 and 80 residues and an empty row."""
    path = profile_dir / f"{request.param}.hmm"
    hmm = parse_hmm(path)
    rng = np.random.default_rng(int(request.param))
    core = np.argmax(hmm.match_emissions[1:], axis=1).astype(np.int32)
    rows = [core, np.concatenate([core, rng.integers(0, 20, 40), core]).astype(np.int32)]
    rows += [np.asarray(s, dtype=np.int32) for s in sample_sequences(hmm, 3, seed=7)]
    rows.append(np.concatenate([rng.integers(0, 20, 30), core[10:60],
                                rng.integers(0, 20, 25)]).astype(np.int32))
    rows += [rng.integers(0, 20, n).astype(np.int32) for n in (1, 80)]
    rows.append(np.zeros(0, dtype=np.int32))
    return (JaxP7Profile.from_profile(jax_parse_hmm(path)), P7Profile.from_profile(hmm), rows)


def test_viterbi_path_equal_and_scores_the_oracle(case):
    jax_p7, p7, rows = case
    for tokens in rows:
        want_score, want_path = jax_tb.viterbi_path(jax_p7, tokens)
        score, path = port_tb.viterbi_path(p7, tokens)
        assert score == want_score and path == want_path
        if tokens.size:
            oracle = viterbi_oracle_batch(p7, tokens[None, :], np.array([tokens.size]))[0]
            assert abs(score - oracle) <= VIT_TOL + tokens.size * EPS32 * abs(oracle)
        else:
            assert score == -np.inf and path == []


def test_domain_alignments_equal(case):
    jax_p7, p7, rows = case
    n_doms = []
    for tokens in rows:
        want_score, want = jax_tb.domain_alignments(jax_p7, tokens)
        score, got = port_tb.domain_alignments(p7, tokens)
        assert score == want_score or (np.isnan(score) and np.isnan(want_score))
        assert [port_tb.alignment_row(d) for d in got] == [jax_tb.alignment_row(d) for d in want]
        assert [dataclasses.asdict(d) for d in got] == [dataclasses.asdict(d) for d in want]
        n_doms.append(len(got))
    assert n_doms[0] == 1 and n_doms[1] == 2  # the consensus and its two copies


def test_hit_alignments_and_envelope_fallback(case, monkeypatch):
    """Within the DP budget, hit_alignments aligns the whole row; past it,
    each posterior envelope (the domains of the two-copy row) is aligned
    alone and shifted back, or MemoryError without envelopes, in both
    packages alike."""
    jax_p7, p7, rows = case
    for tokens in rows[:3]:
        assert ([port_tb.alignment_row(d) for d in port_tb.hit_alignments(p7, tokens)]
                == [jax_tb.alignment_row(d) for d in jax_tb.hit_alignments(jax_p7, tokens)])
    double = rows[1]
    core = rows[0].size
    env = [(1, core), (core + 41, double.size)]
    # a budget the whole two-copy row exceeds and each copy fits
    budget = 3 * 8 * (core + 1) * p7.num_states / 2**30 * 1.3
    monkeypatch.setattr(jax_tb, "TRACEBACK_MAX_GIB", budget)
    monkeypatch.setattr(port_tb, "TRACEBACK_MAX_GIB", budget)
    for tb, prof in ((jax_tb, jax_p7), (port_tb, p7)):
        with pytest.raises(MemoryError):
            tb.hit_alignments(prof, double)
    got = port_tb.hit_alignments(p7, double, envelopes=env)
    want = jax_tb.hit_alignments(jax_p7, double, envelopes=env)
    assert len(got) == 2
    assert [port_tb.alignment_row(d) for d in got] == [jax_tb.alignment_row(d) for d in want]
    assert got[1].seq_from > core  # shifted back into the whole row's coordinates


def test_consensus_and_renderings_equal(case):
    """consensus_string, format_alignment (from a DomainAlignment and from
    its JSON row) and stockholm_msa over every domain of every row."""
    jax_p7, p7, rows = case
    assert port_tb.consensus_string(p7) == jax_tb.consensus_string(jax_p7)
    entries, jax_entries = [], []
    for k, tokens in enumerate(rows):
        _, got = port_tb.domain_alignments(p7, tokens)
        _, want = jax_tb.domain_alignments(jax_p7, tokens)
        for d, w in zip(got, want):
            name = f"row{k}"
            text = port_tb.format_alignment(d, "prof", name)
            assert text == jax_tb.format_alignment(w, "prof", name)
            assert port_tb.format_alignment(port_tb.alignment_row(d), "prof", name) == text
            entries.append((name, port_tb.alignment_row(d)))
            jax_entries.append((name, jax_tb.alignment_row(w)))
    msa = port_tb.stockholm_msa(entries, p7.num_states, "prof")
    assert msa == jax_tb.stockholm_msa(jax_entries, jax_p7.num_states, "prof")
    assert msa.startswith("# STOCKHOLM 1.0") and len(entries) >= 6
