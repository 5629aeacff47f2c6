"""Kernels: K1 (`csrc/fast_nms.cu`) as a percent of its roofline: the least time
of its launches in the traced window (`slambench/roofline.py`) over their
time on the card in the profiler's trace."""

from slambench.roofline import share


def read(ctx):
    return share(ctx, "K1")
