"""msv_pass_pct: the share of the rows searched that passed the MSV
stage (``SearchResult.passed_msv``), over the traced window: the rows the
Viterbi stage is given and restaged."""


def read(w):
    return 100.0 * w.rows["viterbi"] / w.rows["msv"] if w.rows["msv"] else None
