"""The whole step's share of the chip's float32 peak: the counted
operations of a step (both compositing passes, the active Gaussians'
projection, SH, normals and Adam, the losses' per-pixel work and the side
networks; the mean over the traced steps) over the untraced window's time
a step."""


def read(run):
    if not run.counts or run.step_s <= 0 or not run.trace.device:
        return None
    ops = sum(c["step_ops"] for c in run.counts) / len(run.counts)
    return 100.0 * ops / run.step_s / run.peaks["fp32_flops"]
