"""The reference against a frozen oracle, and the check against sound
runs, the control and the faults a cell can have (on the CPU, the
program's plain versions in place of its kernels)."""

import numpy as np
import pytest

from hmmbench import check
from hmmbench.reference import dp
from hmmbench.reference import hmm as hmm_mod
from hmmbench.traffic import generator

from . import oracle
from .cells import run_tiny, tiny_cell
from .conftest import ROOT


@pytest.fixture(scope="module")
def rows():
    config = tiny_cell().config
    config.update(rows=40, length_max=160, planted_share=0.05)
    db = generator.make_database(config, generator.parse_library(config, ROOT), 21, "cpu")
    library = [hmm_mod.parse(p) for p in generator.library_paths(config, ROOT)]
    return db, library


def test_reference_msv_equals_the_oracle_bit_for_bit(rows):
    db, library = rows
    prof = np.arange(len(db.lengths)) % 2
    got = dp.msv(library, prof, db.tokens, db.lengths, "cpu")
    want = [oracle.msv(library[p], db.tokens[r, :db.lengths[r]]) for r, p in enumerate(prof)]
    assert np.array_equal(got, np.array(want, dtype=np.float32))


@pytest.mark.parametrize("forward", [False, True])
def test_reference_p7_matches_the_oracle(rows, forward):
    db, library = rows
    sel = np.arange(12)
    prof = sel % 2
    got = dp.p7(library, prof, db.tokens[sel], db.lengths[sel], "cpu", forward=forward)
    want = np.array([oracle.p7(library[p], db.tokens[r, :db.lengths[r]], forward)
                     for r, p in zip(sel, prof)], dtype=np.float64)
    # the oracle runs in float32, the reference in float64
    assert np.allclose(got, want, rtol=2e-5, atol=2e-4)


def test_bf16_control_leaves_every_number_past_its_limit(rows):
    db, library = rows
    sel = np.flatnonzero(db.family >= 0)
    prof = db.family[sel].astype(np.int64)
    limits = check.load_limits("sprot_search.pfam24")
    exact = dp.msv(library, prof, db.tokens[sel], db.lengths[sel], "cpu")
    low = dp.msv(library, prof, db.tokens[sel], db.lengths[sel], "cpu", precision="bf16")
    assert np.abs(low - exact).max() > limits["msv_gap"]
    for forward, name in ((False, "vit_rel_gap"), (True, "fwd_rel_gap")):
        exact = dp.p7(library, prof, db.tokens[sel], db.lengths[sel], "cpu", forward=forward)
        low = dp.p7(library, prof, db.tokens[sel], db.lengths[sel], "cpu", forward=forward,
                    precision="bf16")
        assert (np.abs(low - exact) / np.maximum(1.0, np.abs(exact))).max() > limits[name]


@pytest.mark.parametrize("name", ["sprot_search.pfam24", "proteome_scan.pfam24"])
def test_a_sound_run_is_correct(name):
    out = run_tiny(tiny_cell(name))
    assert out["correct"], out["check"]
    assert out["numbers"]["msv_gap"] == 0.0
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-3:] == ["check", "numbers", "limits"]


def test_the_program_s_own_lower_precision_path_is_not_correct():
    """The control: the bf16 round-up MSV and Viterbi filters switched on."""
    out = run_tiny(tiny_cell(), options={"fast_msv": True, "fast_viterbi": True})
    assert not out["correct"]
    assert out["numbers"]["msv_gap"] > out["limits"]["msv_gap"]


def _unchanged_state(monkeypatch):
    """MSV returns the row-0 state's score (C = -inf) for every row."""
    from hmm_fasta_viterbi_tpu_torch import MSVScanner

    real = MSVScanner.scan

    def scan(self, profile, staged):
        return torch_full_like(real(self, profile, staged), float("-inf"))

    monkeypatch.setattr(MSVScanner, "scan", scan)


def _half_left_out(monkeypatch):
    """The second half of every bucket is never scored."""
    from hmm_fasta_viterbi_tpu_torch import MSVScanner

    real = MSVScanner.scan

    def scan(self, profile, staged):
        out = real(self, profile, staged).clone()
        out[out.shape[0] // 2:] = out[: out.shape[0] - out.shape[0] // 2].mean()
        return out

    monkeypatch.setattr(MSVScanner, "scan", scan)


def _token_altered(monkeypatch):
    """The Forward stage reads every residue one letter on."""
    import dataclasses

    from hmm_fasta_viterbi_tpu_torch import MSVScanner

    real = MSVScanner.scan_p7

    def scan_p7(self, p7, staged, stage="viterbi"):
        if stage == "forward":
            tok = staged.tokens
            staged = dataclasses.replace(staged, tokens=torch_where(tok < 20, (tok + 1) % 20, tok))
        return real(self, p7, staged, stage)

    monkeypatch.setattr(MSVScanner, "scan_p7", scan_p7)


def _msv_answer_altered(monkeypatch):
    """One row's MSV score moved by one float32 step, where it is produced."""
    from hmm_fasta_viterbi_tpu_torch import MSVScanner

    real = MSVScanner.scan

    def scan(self, profile, staged):
        out = real(self, profile, staged).clone()
        out[0] = torch_nextafter(out[0])
        return out

    monkeypatch.setattr(MSVScanner, "scan", scan)


def torch_where(cond, a, b):
    import torch

    return torch.where(cond, a, b)


def torch_full_like(x, v):
    import torch

    return torch.full_like(x, v)


def torch_nextafter(x):
    import torch

    return torch.nextafter(x, torch.tensor(float("inf"), dtype=x.dtype))


def _last_bucket_off(monkeypatch):
    """Every MSV score of the staging's last bucket (its longest rows, one
    launch) moved by one float32 step."""
    from hmm_fasta_viterbi_tpu_torch import MSVScanner

    real_stage, real_scan = MSVScanner.stage_bucketed, MSVScanner.scan
    last = set()

    def stage_bucketed(self, tokens, lengths, *args, **kw):
        out = real_stage(self, tokens, lengths, *args, **kw)
        last.add(id(out.buckets[-1]))
        return out

    def scan(self, profile, staged):
        out = real_scan(self, profile, staged)
        return torch_nextafter(out) if id(staged) in last else out

    monkeypatch.setattr(MSVScanner, "stage_bucketed", stage_bucketed)
    monkeypatch.setattr(MSVScanner, "scan", scan)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_left_out, _token_altered,
                                   _msv_answer_altered, _last_bucket_off])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    # the cell's own sample, on a database larger than it: 700 rows in 7
    # buckets, the last of them one row
    cell = tiny_cell(rows=700, length_max=2200)
    assert cell.traffic["check_rows"]["msv"] < 700 // 4
    out = run_tiny(cell)
    assert not out["correct"], out["numbers"]


def test_the_sample_holds_every_bucket_s_edges_and_the_longest_rows():
    class Result:
        def __init__(self, n, passed):
            self.msv_scores = np.zeros(n)
            self.passed_msv = passed
            self.passed_viterbi = passed & (np.arange(n) % 2 == 0)

    n = 1000
    rng = np.random.default_rng(3)
    lengths = rng.integers(10, 5000, size=n)
    order = np.lexsort((np.arange(n), lengths))
    strata = np.split(order, [400, 800, 990])  # the last holds the 10 longest rows
    passed = rng.random(n) < 0.05
    family = np.full(n, -1)
    checked = [check.Checked(0, Result(n, passed))]
    sizes, per = {"msv": 8, "viterbi": 2, "forward": 2}, {"msv": 1, "viterbi": 1, "forward": 1}
    rows = check.sample_rows(checked, family, lengths, strata, rng, sizes, per, 3)
    for stage, pool in (("msv", np.ones(n, dtype=bool)), ("viterbi", passed),
                        ("forward", checked[0].result.passed_viterbi)):
        (c, got), = getattr(rows, stage)
        assert np.all(pool[got]) and np.array_equal(got, np.unique(got))
        for part in strata:
            part = part[pool[part]]
            if part.size:
                assert {part[0], part[-1]} <= set(got)
        longest = order[pool[order]][-3:]
        assert set(longest) <= set(got)
    assert len(rows.msv[0][1]) <= 8 + 4 * 3 + 3
