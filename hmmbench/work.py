"""The yardstick: the work a search asks for, counted from the algorithm and
the inputs alone, and the card's peaks.

A DP cell is one residue against one model state. Counted per cell, from
each stage's recurrence (``B' = B + t_BMk`` is computed once a residue,
not a cell, and so is not counted):

* MSV, ``M_j = e_j(x) + max(M_{j-1}, B')``, ``E = max(E, M_j)``: one
  add, two maxes: **3**;
* Viterbi, ``M_j = e_j(x) + max(M_{j-1} + t_MM, I_{j-1} + t_IM,
  D_{j-1} + t_DM, B')`` (3 adds, 3 maxes, 1 add), ``I_j = e'_j(x) +
  max(M_j + t_MI, I_j + t_II)`` (2 adds, 1 max, 1 add), ``D_j =
  max(M_{j-1} + t_MD, D_{j-1} + t_DD)`` (2 adds, 1 max), ``E = max(E,
  M_j, D_j)`` (2 maxes): **16**;
* Forward in probability space, the same recurrence with products for
  sums and sums for maxes: **16**.

No count depends on how a kernel runs the recurrence: not on its chain
passes, certificates, windows, replays or packs. The bytes count each
input byte once (a residue is one byte; a row's length, its two length
transitions and its score are four bytes each; a profile's tables four
bytes an entry) and each output byte once.

The peaks are NVIDIA's for one H100 SXM at its 700 W limit: 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

OPS_PER_CELL = {"msv": 3, "viterbi": 16, "forward": 16}

# bytes a row brings beside its residues: length, two length transitions,
# and its score out
ROW_BYTES = {"msv": 4 + 8 + 4, "viterbi": 4 + 8 + 4, "forward": 4 + 16 + 4}


def table_bytes(stage: str, leng: int) -> int:
    """A profile's tables: MSV 20 emission rows; Viterbi and Forward 20
    match and 20 insert emission rows and 7 transition rows."""
    rows = 20 if stage == "msv" else 47
    return 4 * rows * leng


def cells(residues: int, leng: int) -> int:
    """DP cells of ``residues`` against a profile of LENG ``leng``."""
    return int(residues) * int(leng)


def stage_work(stage: str, rows: int, residues: int, leng: int) -> tuple[float, float]:
    """``(FP32 operations, bytes)`` of one stage over ``rows`` rows holding
    ``residues`` residues against one profile."""
    ops = OPS_PER_CELL[stage] * cells(residues, leng)
    nbytes = residues + ROW_BYTES[stage] * rows + table_bytes(stage, leng)
    return float(ops), float(nbytes)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: max(ops / peak, bytes / peak)."""
    return max(ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES)
