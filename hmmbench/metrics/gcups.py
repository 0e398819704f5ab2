"""gcups: the MSV-stage DP cells of every query completed in the window
(a query's cells: the database's residues times the LENG of each profile
it searches), over the window's seconds, / 1e9. A whole-window rate."""


def read(w):
    return w.msv_cells / w.seconds / 1e9 if w.seconds > 0 and w.queries else None
