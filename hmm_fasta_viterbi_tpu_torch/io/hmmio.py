"""HMMER3/b ``.hmm`` profile parser producing dense NumPy arrays.

Capability parity with the reference profile reader
(reference: data_readers/Profile_HMM.{hpp,cpp}) including its numeric
conventions and quirks:

* every stored value is a *probability* obtained as ``exp(-x)`` from the
  negative-log value ``x`` in the file (Profile_HMM.cpp:35-45);
* a dummy node ``M0`` is inserted, so ``model_length = LENG + 1``
  (Profile_HMM.cpp:66-71); ``match_emissions[0]`` is all zeros;
* unparseable numeric tokens — notably the ``*`` used by HMMER for
  log-probability -inf — parse as ``strtof``-style 0.0 and therefore as
  probability ``exp(-0) = 1.0`` (quirk enshrined by the reference's own
  tests, data_readers/test_hmm_parsing.cpp:29-36). Set
  ``star_as_zero_prob=True`` to instead use the semantically correct 0.0
  probability (net-new option; default preserves reference behavior);
* STATS LOCAL MSV/VITERBI/FORWARD (mu|theta, lambda) pairs are retained
  (Profile_HMM.hpp:32-42) — unused by MSV itself but needed by the
  Viterbi/Forward stages and E-value statistics.

The parser is a single forward pass over the file; unlike the reference it
raises real exceptions on malformed input instead of returning
half-initialized objects (SURVEY.md §5 "failure detection").

A native C++ fast path with identical semantics lives in
``hmm_fasta_viterbi_tpu_torch.io.native`` and is used automatically when built.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from .alphabet import NUM_AMINO_ACIDS

NUM_TRANSITIONS = 7  # m->m m->i m->d i->m i->i d->m d->d

_STATS_KINDS = {"MSV", "VITERBI", "FORWARD"}


@dataclasses.dataclass
class ProfileHMM:
    """A parsed profile HMM with dense probability arrays.

    Array shapes use ``m = model_length = LENG + 1`` (dummy node M0 at
    row 0):

    * ``match_emissions``  — ``[m, 20]`` float32 (row 0 all zeros)
    * ``insert_emissions`` — ``[m, 20]`` float32
    * ``transitions``      — ``[m, 7]``  float32
    """

    name: str
    model_length: int  # LENG + 1 (includes dummy M0)
    match_emissions: np.ndarray
    insert_emissions: np.ndarray
    transitions: np.ndarray
    stats_local_msv_mu: float = 0.0
    stats_local_msv_lambda: float = 0.0
    stats_local_viterbi_mu: float = 0.0
    stats_local_viterbi_lambda: float = 0.0
    stats_local_forward_theta: float = 0.0
    stats_local_forward_lambda: float = 0.0

    @property
    def leng(self) -> int:
        """The file's LENG value (number of real match states)."""
        return self.model_length - 1


def _check_alphabet(text: str) -> None:
    """Reject non-amino alphabets EXPLICITLY: a DNA/RNA profile has 4
    emission columns and would otherwise mis-parse silently (the
    reference has the same blind spot — Profile_HMM.cpp never reads
    ALPH). Files without an ALPH line are accepted as amino."""
    import re

    m = re.search(r"^ALPH\s+(\S+)", text, re.MULTILINE)
    if m and m.group(1).lower() != "amino":
        raise HMMParseError(
            f"unsupported alphabet {m.group(1)!r}: this engine scores "
            "protein profiles (ALPH amino)"
        )


class HMMParseError(ValueError):
    """Raised on malformed ``.hmm`` input."""


def _strtof(token: str) -> np.float32:
    """C ``strtof`` semantics: parse a leading float, else 0.0.

    The reference feeds every numeric field through ``std::strtof``
    (Profile_HMM.cpp:31-43), so ``*`` and other non-numeric tokens become
    0.0 without error.
    """
    try:
        return np.float32(token)
    except ValueError:
        return np.float32(0.0)


def _neg_log_to_prob(tokens: list[str], n: int, star_as_zero_prob: bool) -> np.ndarray:
    """First ``n`` whitespace tokens -> probabilities ``exp(-x)`` (f32)."""
    if len(tokens) < n:
        raise HMMParseError(f"expected {n} probability fields, got {len(tokens)}")
    vals = np.empty(n, dtype=np.float32)
    for i in range(n):
        tok = tokens[i]
        if star_as_zero_prob and tok == "*":
            vals[i] = np.float32(np.inf)
        else:
            vals[i] = _strtof(tok)
    return np.exp(-vals).astype(np.float32)


def _lines_after_tag(lines: Iterator[str], tag: str) -> list[str]:
    """Advance to the next line whose first token starts with ``tag``.

    Returns the line's whitespace tokens. Mirrors the reference's
    prefix-match-after-leading-spaces search (Profile_HMM.cpp:15-26).
    """
    for line in lines:
        stripped = line.lstrip(" ")
        if stripped.startswith(tag):
            return stripped.split()
    raise HMMParseError(f"tag {tag!r} not found")


def parse_hmm(
    path: str | os.PathLike,
    *,
    star_as_zero_prob: bool = False,
) -> ProfileHMM:
    """Parse one profile from an HMMER3/b ``.hmm`` file.

    Single-pass, line-oriented (reference call stack: SURVEY.md §3.4).
    """
    with open(path, "r") as f:
        text = f.read()
    return parse_hmm_text(text, star_as_zero_prob=star_as_zero_prob)


def parse_hmm_multi(
    path: str | os.PathLike,
    *,
    star_as_zero_prob: bool = False,
) -> list[ProfileHMM]:
    """Parse a concatenated HMMER3 profile database (the hmmscan
    ``Pfam.hmm`` shape: models separated by ``//`` terminator lines).

    The reference parses exactly one model per file and never consumes
    the ``//`` tail (SURVEY.md §3.4); real HMMER databases concatenate
    thousands. Single-model files return a one-element list.
    """
    with open(path, "r") as f:
        text = f.read()
    return parse_hmm_multi_text(text, star_as_zero_prob=star_as_zero_prob)


def parse_hmm_multi_text(
    text: str, *, star_as_zero_prob: bool = False
) -> list[ProfileHMM]:
    import re

    profiles = []
    # split at a line-leading terminator; the reference fixtures end
    # with "//" and NO trailing newline, so naive concatenation puts
    # the next model's header on the terminator line — keep everything
    # after the two slashes in the following chunk
    for chunk in re.split(r"(?m)^//", text):
        if not chunk.strip():
            continue
        profiles.append(
            parse_hmm_text(chunk, star_as_zero_prob=star_as_zero_prob)
        )
    if not profiles:
        raise HMMParseError("no profiles in .hmm text")
    return profiles


def parse_hmm_text(text: str, *, star_as_zero_prob: bool = False) -> ProfileHMM:
    _check_alphabet(text)
    lines = iter(text.splitlines())

    name_tokens = _lines_after_tag(lines, "NAME")
    if len(name_tokens) < 2:
        raise HMMParseError("NAME line has no value")
    name = name_tokens[1]

    leng_tokens = _lines_after_tag(lines, "LENG")
    try:
        leng = int(leng_tokens[1])
    except (IndexError, ValueError) as e:
        raise HMMParseError("bad LENG line") from e
    if leng <= 0:
        raise HMMParseError(f"non-positive LENG {leng}")
    model_length = leng + 1  # dummy M0 (reference: Profile_HMM.cpp:66-71)

    stats: dict[str, tuple[float, float]] = {}
    for _ in range(3):
        tokens = _lines_after_tag(lines, "STATS")
        # STATS LOCAL <KIND> <mu|theta> <lambda>
        if len(tokens) < 5 or tokens[1] != "LOCAL" or tokens[2] not in _STATS_KINDS:
            raise HMMParseError(f"bad STATS line: {' '.join(tokens)}")
        stats[tokens[2]] = (float(_strtof(tokens[3])), float(_strtof(tokens[4])))

    match = np.zeros((model_length, NUM_AMINO_ACIDS), dtype=np.float32)
    insert = np.zeros((model_length, NUM_AMINO_ACIDS), dtype=np.float32)
    trans = np.zeros((model_length, NUM_TRANSITIONS), dtype=np.float32)

    # COMPO anchor; the following two lines are node-0 insert emissions and
    # transitions; match_emissions[0] stays zero (Profile_HMM.cpp:96-113).
    _lines_after_tag(lines, "COMPO")
    try:
        insert[0] = _neg_log_to_prob(
            next(lines).split(), NUM_AMINO_ACIDS, star_as_zero_prob
        )
        trans[0] = _neg_log_to_prob(
            next(lines).split(), NUM_TRANSITIONS, star_as_zero_prob
        )
    except StopIteration as e:
        raise HMMParseError("truncated .hmm file (after COMPO)") from e

    try:
        for k in range(1, model_length):
            tokens = _lines_after_tag(lines, str(k))
            # first token is the node number; 20 match emissions follow
            match[k] = _neg_log_to_prob(tokens[1:], NUM_AMINO_ACIDS, star_as_zero_prob)
            insert[k] = _neg_log_to_prob(next(lines).split(), NUM_AMINO_ACIDS, star_as_zero_prob)
            trans[k] = _neg_log_to_prob(next(lines).split(), NUM_TRANSITIONS, star_as_zero_prob)
    except StopIteration as e:
        raise HMMParseError("truncated .hmm file") from e

    msv = stats.get("MSV", (0.0, 0.0))
    vit = stats.get("VITERBI", (0.0, 0.0))
    fwd = stats.get("FORWARD", (0.0, 0.0))
    return ProfileHMM(
        name=name,
        model_length=model_length,
        match_emissions=match,
        insert_emissions=insert,
        transitions=trans,
        stats_local_msv_mu=msv[0],
        stats_local_msv_lambda=msv[1],
        stats_local_viterbi_mu=vit[0],
        stats_local_viterbi_lambda=vit[1],
        stats_local_forward_theta=fwd[0],
        stats_local_forward_lambda=fwd[1],
    )
