"""The compositing forward (K1) kernel's share of its roofline over the traced
steps: the least time the chip could take for the counted work (the
larger of the counted operations over the float32 peak and the counted
bytes over the memory peak, from the benchmark's own binning of each
step's inputs), over the device time of the kernels named rasterize_fwd."""

from gsbench.counts import roofline_s

KERNEL = "rasterize_fwd"


def read(run):
    ms, n = run.trace.device_ms(kernel=lambda k: KERNEL in k)
    if not n or ms <= 0:
        return None
    bound = sum(roofline_s(c["k1_ops"], c["k1_bytes"], run.peaks)
                for c in run.counts)
    return 100.0 * bound / (ms / 1e3)
