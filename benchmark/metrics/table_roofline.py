"""table_roofline: the table layer's share of its roofline: the least bytes
a step's table work moves (`work.table_step_bytes`, from the step's ids,
unique ids and first sightings), over the HBM peak (3.35 TB/s, H100 SXM),
over the layer's device time a step."""

from harness import work


def read(r):
    ms = r.layer_ms_per_unit("table")
    bw = work.peak(r.kind, "hbm_bytes_per_s")
    if not ms or not bw or not r.table_bytes_per_unit:
        return None
    return 100.0 * (r.table_bytes_per_unit / bw) / (ms / 1e3)
