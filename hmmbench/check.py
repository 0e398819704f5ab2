"""The comparison that decides ``correct``.

What the timed path produced is judged on a sample of the queries it
finished, drawn from the seed, with a query of the library's longest
profile always among them. For each profile searched in a sampled query:

* the stage decisions over **every** row: each P-value is the reference's
  statistic of the program's own score, each ``passed_*`` flag its
  threshold (``passed_viterbi`` and ``passed_forward`` also need the
  stage before), and a row carries a Viterbi (Forward) score exactly
  when it passed MSV (Viterbi);
* the MSV score of sampled rows against the reference's float32 MSV,
  exact;
* the Viterbi score of sampled MSV survivors and the Forward score of
  sampled Viterbi survivors against the reference's float64 programs, as
  a gap relative to ``max(1, |reference|)``.

A stage's sample (``sample_rows``) holds random rows of those it scored,
as many rows planted with the profile's family, and from each of the
staging's length buckets (one launch each) its first and last rows and a
few random ones, and always the longest rows: a fault confined to one
launch, or to the long rows of the last, is compared on every seed.

Each stage gives one number, the widest gap over its rows; a decision,
P-value or score's presence against the rule makes that stage's number
``BROKEN``. Each number has its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from .reference import dp
from .reference import hmm as hmm_mod

HERE = pathlib.Path(__file__).resolve().parent
NUMBERS = ("msv_gap", "vit_rel_gap", "fwd_rel_gap")
BROKEN = 1e30  # a number that found a row against the rule
LONGEST = 4  # the longest rows of a stage's pool, always compared


def load_limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


@dataclasses.dataclass
class Checked:
    """One searched profile of a sampled query: the library index and the
    program's ``SearchResult``."""

    profile: int
    result: object


@dataclasses.dataclass
class Rows:
    """The rows each stage's reference scores, for every ``Checked``."""

    msv: list  # (checked index, row indices)
    viterbi: list
    forward: list


def _decisions(h, res, thresholds: dict) -> list[str]:
    """What in ``res`` goes against the rule, as messages ([] if nothing)."""
    bad = []
    gate = np.ones(len(res.msv_scores), dtype=bool)
    for stage, score_key in (("msv", "msv_scores"), ("viterbi", "viterbi_scores"),
                             ("forward", "forward_scores")):
        scores = np.asarray(getattr(res, score_key))
        pv = np.asarray(getattr(res, f"{stage}_pvalues"))
        passed = np.asarray(getattr(res, f"passed_{stage}"))
        has = np.isfinite(scores)
        if stage != "msv" and not np.array_equal(has, gate):
            bad.append(f"{stage}: {int((has != gate).sum())} rows scored against the gate")
        want = np.full(len(scores), np.nan)
        want[has] = hmm_mod.pvalues(h, stage, scores[has])
        if not np.allclose(pv, want, rtol=1e-12, atol=0.0, equal_nan=True):
            bad.append(f"{stage}: P-values differ from the statistic of the scores")
        rule = gate & (np.nan_to_num(want, nan=np.inf) <= thresholds[stage])
        if not np.array_equal(passed, rule):
            bad.append(f"{stage}: {int((passed != rule).sum())} decisions against the threshold")
        gate = rule
    return bad


def sample_rows(checked: list, family: np.ndarray, lengths: np.ndarray, strata: list,
                rng: np.random.Generator, sizes: dict, per_bucket: dict,
                longest: int = LONGEST) -> Rows:
    """Rows to score, per stage, of those the stage scored (MSV: every
    row; Viterbi: the MSV survivors; Forward: the Viterbi survivors):
    ``sizes[stage]`` random rows and as many planted with the profile's
    family; from each stratum (the staging's buckets, each its rows in
    launch order) its first and last such rows and ``per_bucket[stage]``
    random others; and the ``longest`` longest such rows."""
    by_length = np.lexsort((np.arange(len(lengths)), lengths))  # ascending, stable
    out = Rows([], [], [])
    for c, item in enumerate(checked):
        res = item.result
        planted = family == item.profile
        for stage, pool in (("msv", np.ones(len(res.msv_scores), dtype=bool)),
                            ("viterbi", np.asarray(res.passed_msv)),
                            ("forward", np.asarray(res.passed_viterbi))):
            picked = []
            for mask in (pool & ~planted, pool & planted):
                idx = np.flatnonzero(mask)
                picked.append(rng.choice(idx, size=min(sizes[stage], idx.size), replace=False))
            for rows in strata:
                rows = rows[pool[rows]]
                if rows.size:
                    picked.append(rows[[0, -1]])
                    picked.append(rng.choice(rows, size=min(per_bucket[stage], rows.size),
                                             replace=False))
            picked.append(by_length[pool[by_length]][-longest:])
            getattr(out, stage).append((c, np.unique(np.concatenate(picked).astype(np.int64))))
    return out


def reference_scores(library: list, checked: list, rows: Rows, tokens: np.ndarray,
                     lengths: np.ndarray, device, precision: str = "exact") -> dict:
    """The reference's score of every sampled row, per stage: ``{stage:
    [array per checked]}``. ``precision="bf16"`` computes the control."""
    out = {}
    for stage, picks in (("msv", rows.msv), ("viterbi", rows.viterbi),
                         ("forward", rows.forward)):
        prof = np.concatenate([np.full(len(idx), checked[c].profile) for c, idx in picks])
        idx = np.concatenate([idx for _, idx in picks]).astype(np.int64)
        if idx.size == 0:
            out[stage] = [np.empty(0) for _ in picks]
            continue
        used = np.unique(prof)
        local = np.searchsorted(used, prof)
        hmms = [library[p] for p in used]
        if stage == "msv":
            got = dp.msv(hmms, local, tokens[idx], lengths[idx], device,
                         precision="bf16" if precision == "bf16" else "f32")
        else:
            got = dp.p7(hmms, local, tokens[idx], lengths[idx], device,
                        forward=stage == "forward",
                        precision="bf16" if precision == "bf16" else "f64")
        out[stage] = np.split(got, np.cumsum([len(i) for _, i in picks])[:-1])
    return out


def gaps(checked: list, rows: Rows, program: dict, reference: dict) -> dict:
    """The widest gap of each stage: MSV absolute, Viterbi and Forward
    relative to ``max(1, |reference|)``."""
    out = {}
    for number, stage in zip(NUMBERS, ("msv", "viterbi", "forward")):
        widest = 0.0
        for (c, idx), got, want in zip(getattr(rows, stage), program[stage], reference[stage]):
            if idx.size == 0:
                continue
            got = np.asarray(got, dtype=np.float64)
            want = np.asarray(want, dtype=np.float64)
            gap = np.abs(got - want)
            if stage != "msv":
                gap = gap / np.maximum(1.0, np.abs(want))
            gap = np.where(np.isnan(gap) | np.isinf(gap), BROKEN, gap)
            widest = max(widest, float(gap.max()))
        out[number] = widest
    return out


def program_scores(checked: list, rows: Rows) -> dict:
    keys = {"msv": "msv_scores", "viterbi": "viterbi_scores", "forward": "forward_scores"}
    return {stage: [np.asarray(getattr(checked[c].result, keys[stage]))[idx]
                    for c, idx in getattr(rows, stage)] for stage in keys}


def compare(library: list, checked: list, family: np.ndarray, tokens: np.ndarray,
            lengths: np.ndarray, strata: list, thresholds: dict, traffic: dict,
            seed_rng: np.random.Generator, device, log, control: bool = False) -> dict:
    """The numbers of the check: ``{name: value}``. ``strata`` are the
    staging's buckets (row indices in launch order), ``traffic`` the mix
    whose ``check_rows`` and ``check_per_bucket`` size the sample. With ``control``, also ``{"control": numbers}``: the same
    comparison with the reference computed in bfloat16 put in the
    program's place."""
    rows = sample_rows(checked, family, lengths, strata, seed_rng, traffic["check_rows"],
                       traffic["check_per_bucket"])
    reference = reference_scores(library, checked, rows, tokens, lengths, device)
    numbers = gaps(checked, rows, program_scores(checked, rows), reference)
    if control:
        low = reference_scores(library, checked, rows, tokens, lengths, device, "bf16")
        numbers["control"] = gaps(checked, rows, low, reference)
    for item in checked:
        for msg in _decisions(library[item.profile], item.result, thresholds):
            log(f"check: profile {library[item.profile].name}: {msg}")
            stage = msg.split(":")[0]
            numbers[NUMBERS[("msv", "viterbi", "forward").index(stage)]] = BROKEN
    log("check: rows passing MSV, Viterbi, Forward: " + "; ".join(
        f"{library[c.profile].name} {int(c.result.passed_msv.sum())}, "
        f"{int(c.result.passed_viterbi.sum())}, {int(c.result.passed_forward.sum())} "
        f"({int((family == c.profile).sum())} planted)" for c in checked))
    log("check: rows compared: " + ", ".join(
        f"{stage} {sum(len(i) for _, i in getattr(rows, stage))}"
        for stage in ("msv", "viterbi", "forward")))
    return numbers
