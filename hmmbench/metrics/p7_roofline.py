"""p7_roofline: the Viterbi and Forward kernels (``csrc/p7_*``)
against their roofline over the traced window: 16 FP32 operations a DP
cell of the rows each stage was given (Viterbi: the MSV survivors;
Forward: the Viterbi survivors)."""

from hmmbench.metrics._roofline import share


def read(w):
    return share(w, r"\b(viterbi|forward)\w*_kernel\b", ("viterbi", "forward"))
