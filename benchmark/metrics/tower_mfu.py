"""tower_mfu: the tower layer's share of the chip's float32 peak: the model
FLOPs of a step (`work.train_flops_per_example` x batch: the MLPs' and the
cross net's products, forward and backward) over the tower layer's device
time a step (its forward and loss, backward nodes and dense Adam), over
67 TFLOP/s (H100 SXM, float32 outside the tensor cores, at 700 W)."""

from harness import work


def read(r):
    peak = work.peak(r.kind, "float32_flops")
    ms = r.layer_ms_per_unit("tower")
    if not peak or not ms or not r.flops_per_unit:
        return None
    return 100.0 * r.flops_per_unit / (ms / 1e3) / peak
