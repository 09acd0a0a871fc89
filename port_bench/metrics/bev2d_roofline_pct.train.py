"""The BEV path's share of its roofline: the larger of its convolutions'
FLOPs over the float32 peak and their bytes over the HBM bandwidth
(``flops.step_work``), over the BEV layer's ms a step."""

MODULES = ("map_to_bev", "backbone_2d")
LAYER = "bev2d"


def read(rec):
    ms = rec["spans_ms"].get(LAYER)
    if not ms:
        return None
    least_s = max(rec["bev_flops_per_step"] / rec["peak_flops"],
                  rec["bev_bytes_per_step"] / rec["peak_bytes_per_s"])
    return 100.0 * least_s / (ms * 1e-3)
