"""Full profile-HMM (P7) scoring model for the Viterbi and Forward stages.

The reference parses insert emissions and the 7 transition rows but its
MSV stage never reads them (SURVEY.md quirk 10) — they exist precisely
for these stages, the repo's stated direction (reference README.md:2-4,
and its very name: HMM_FASTA_Viterbi). There is no reference
implementation to match, so the model is defined here, consistent with
this engine's MSV conventions:

* multihit local mode with nu = 2: E->C = E->J = log(1/2) (models.msv);
* uniform local entry B->M_k = log(2/(m(m+1))) with m = LENG+1 — the
  same (deliberately off-by-one) constant the MSV stage uses;
* local exit M_k->E = D_k->E = 0 for every k;
* length-modeled specials: N/C/J self-loops log(L/(L+3)), moves
  log(3/(L+3)) — identical to the MSV stage;
* node-0 transition row (B->M1/B->I0/B->D1 in glocal HMMER) is ignored:
  local entry replaces it, N-terminal inserts fold into the N loop;
* emission scores are log-odds vs the HMMER background (io.alphabet).

State indexing below is 0-based over REAL nodes: index j corresponds to
HMM node j+1, matching the [20, m-1] layout of the MSV device path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.alphabet import BACKGROUND_FREQUENCIES
from ..io.hmmio import ProfileHMM
from .msv import msv_transitions

NEG_INF = np.float32(-np.inf)

# transition-column order in the .hmm file (Profile_HMM format)
T_MM, T_MI, T_MD, T_IM, T_II, T_DM, T_DD = range(7)


@dataclasses.dataclass
class P7Profile:
    """Device-ready full-profile scores, all float32 and finite except
    documented -inf boundaries.

    Arrays over j = 0..mr-1 (node j+1):
    * ``msc``/``isc`` [20, mr] — match/insert emission log-odds;
    * ``tmm/tmi/tmd/tim/tii/tdm/tdd`` [mr] — transition scores OUT of
      node j+1 (entry j of tmm is M_{j} -> M_{j+1} in 0-based indexing);
      the last entry of each feeds a nonexistent node m and is forced to
      -inf so padded/terminal flows cannot escape through it.
    """

    name: str
    model_length: int  # m = LENG + 1
    msc: np.ndarray
    isc: np.ndarray
    tmm: np.ndarray
    tmi: np.ndarray
    tmd: np.ndarray
    tim: np.ndarray
    tii: np.ndarray
    tdm: np.ndarray
    tdd: np.ndarray
    tr_B_Mk: np.float32
    tr_E_C: np.float32
    tr_E_J: np.float32
    stats_local_msv_mu: float = 0.0
    stats_local_msv_lambda: float = 0.0
    stats_local_viterbi_mu: float = 0.0
    stats_local_viterbi_lambda: float = 0.0
    stats_local_forward_theta: float = 0.0
    stats_local_forward_lambda: float = 0.0

    @property
    def num_states(self) -> int:
        return self.model_length - 1

    @classmethod
    def from_profile(cls, profile: ProfileHMM) -> "P7Profile":
        m = profile.model_length
        mr = m - 1
        with np.errstate(divide="ignore"):
            msc = np.log(
                profile.match_emissions[1:].astype(np.float32)
                / BACKGROUND_FREQUENCIES[None, :]
            ).astype(np.float32)
            isc = np.log(
                profile.insert_emissions[1:].astype(np.float32)
                / BACKGROUND_FREQUENCIES[None, :]
            ).astype(np.float32)
            # transitions out of nodes 1..mr (row 0 = B/I0 row, ignored)
            t = np.log(profile.transitions[1:].astype(np.float32)).astype(np.float32)

        def col(c: int, kill_last: bool) -> np.ndarray:
            v = np.ascontiguousarray(t[:, c])
            if kill_last and mr > 0:
                v = v.copy()
                v[-1] = NEG_INF  # node m does not exist
            return v

        tr = msv_transitions(m)
        return cls(
            name=profile.name,
            model_length=m,
            msc=np.ascontiguousarray(msc.T),  # [20, mr]
            isc=np.ascontiguousarray(isc.T),
            tmm=col(T_MM, kill_last=True),
            tmi=col(T_MI, kill_last=False),  # M_j -> I_j stays within node
            tmd=col(T_MD, kill_last=True),
            tim=col(T_IM, kill_last=True),
            tii=col(T_II, kill_last=False),
            tdm=col(T_DM, kill_last=True),
            tdd=col(T_DD, kill_last=True),
            tr_B_Mk=tr.tr_B_Mk,
            tr_E_C=tr.tr_E_C,
            tr_E_J=tr.tr_E_J,
            stats_local_msv_mu=profile.stats_local_msv_mu,
            stats_local_msv_lambda=profile.stats_local_msv_lambda,
            stats_local_viterbi_mu=profile.stats_local_viterbi_mu,
            stats_local_viterbi_lambda=profile.stats_local_viterbi_lambda,
            stats_local_forward_theta=profile.stats_local_forward_theta,
            stats_local_forward_lambda=profile.stats_local_forward_lambda,
        )
