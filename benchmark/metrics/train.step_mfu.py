"""train.step_mfu: the whole training step's share of the chip's float32
peak: the model FLOPs of a step (`work.train_flops_per_example` x batch)
over the traced window's time a step, over 67 TFLOP/s (H100 SXM, float32
outside the tensor cores, at 700 W)."""

from harness import work


def read(r):
    peak = work.peak(r.kind, "float32_flops")
    if not peak or not r.units or not r.flops_per_unit:
        return None
    step_s = r.timeline.window_s / r.units
    return 100.0 * r.flops_per_unit / step_s / peak
