"""HMMER3/b ``.hmm`` writer — the inverse of io.hmmio.

Emits the subset of the format the family's parsers consume (NAME /
LENG / ALPH / STATS LOCAL / COMPO anchor / per-node emission+transition
rows / ``//`` terminator), with probabilities stored as negative natural
logs and impossible transitions as ``*`` — exactly the conventions
io.hmmio and the reference parser read back (round-trip tested).
Trailing per-node annotation columns (MAP/CONS) are written like real
HMMER files; both parsers ignore extras past the 20/7 value fields.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .alphabet import AMINO_ACIDS
from .hmmio import ProfileHMM

_HEADER = "HMMER3/b [hmm_fasta_viterbi_tpu]"


def _fields(probs) -> str:
    out = []
    for p in np.asarray(probs, dtype=np.float64):
        if p <= 0.0:
            out.append("        *")
        else:
            out.append(f"{max(-math.log(p), 0.0):9.5f}")
    return "  ".join(out)


def format_hmm(hmm: ProfileHMM) -> str:
    m = hmm.model_length
    leng = m - 1
    aa_header = "  ".join(f"{a:>9s}" for a in AMINO_ACIDS)
    lines = [
        _HEADER,
        f"NAME  {hmm.name}",
        f"LENG  {leng}",
        "ALPH  amino",
        f"STATS LOCAL MSV      {hmm.stats_local_msv_mu:9.4f}  "
        f"{hmm.stats_local_msv_lambda:.5f}",
        f"STATS LOCAL VITERBI  {hmm.stats_local_viterbi_mu:9.4f}  "
        f"{hmm.stats_local_viterbi_lambda:.5f}",
        f"STATS LOCAL FORWARD  {hmm.stats_local_forward_theta:9.4f}  "
        f"{hmm.stats_local_forward_lambda:.5f}",
        f"HMM    {aa_header}",
        "        m->m     m->i     m->d     i->m     i->i     d->m     d->d",
    ]
    # COMPO: average match distribution (background of the model);
    # io.hmmio uses the tag purely as the node-block anchor
    compo = np.asarray(hmm.match_emissions[1:], dtype=np.float64).mean(axis=0)
    lines.append(f"  COMPO  {_fields(compo)}")
    lines.append(f"         {_fields(hmm.insert_emissions[0])}")
    lines.append(f"         {_fields(hmm.transitions[0])}")
    cons = [
        AMINO_ACIDS[int(np.argmax(hmm.match_emissions[k]))]
        for k in range(1, m)
    ]
    for k in range(1, m):
        lines.append(
            f"{k:7d}  {_fields(hmm.match_emissions[k])}  {k:7d} {cons[k - 1]} -"
        )
        lines.append(f"         {_fields(hmm.insert_emissions[k])}")
        trans_k = np.asarray(hmm.transitions[k], dtype=np.float64).copy()
        if k == leng:
            # structural zeros: no D_{LENG+1} exists, so the last
            # node's m->d / d->d are ALWAYS '*'. A default-quirk parse
            # stores exp(-0)=1.0 there (SURVEY quirk 1); writing that
            # back as 0.00000 would turn an impossibility into a
            # certainty for star_as_zero_prob consumers (emit).
            trans_k[2] = 0.0
            trans_k[6] = 0.0
        lines.append(f"         {_fields(trans_k)}")
    lines.append("//")
    return "\n".join(lines) + "\n"


def write_hmm(hmm: ProfileHMM, path: str | os.PathLike) -> None:
    with open(path, "w") as f:
        f.write(format_hmm(hmm))
