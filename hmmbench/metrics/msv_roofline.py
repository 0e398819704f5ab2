"""msv_roofline: the MSV kernels (``csrc/msv_kernel.cu``) against
their roofline over the traced window: 3 FP32 operations a DP cell of
every row (``work.OPS_PER_CELL``)."""

from hmmbench.metrics._roofline import share


def read(w):
    return share(w, r"\bmsv\w*_kernel\b", ("msv",))
