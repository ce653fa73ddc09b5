"""Percent: the least time of the window's jobs at one card's published
peaks (:mod:`cardbench.roofline`: the image's pixels at the filter's
fewest operations, its bytes read and written once) over the device time
of every kernel the jobs ran on every card, whatever their names.  Reads
``kernel_roofline.<cells>`` for every kind of cell that iterates images."""

from cardbench.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx)
