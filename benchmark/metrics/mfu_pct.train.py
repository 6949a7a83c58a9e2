"""The whole step's share of the card's dense bfloat16 peak (989 TFLOP/s,
H100 SXM), in percent: the model FLOPs of one unit (frame or image) as
``torch.utils.flop_counter`` counts them over the plain reference at the
cell's shapes, forward and backward, times the traced run's rate over
its window."""

from benchmark.roofline import mfu_pct


def read(record):
    if record.get("kind") != "train" or not record.get("flops_per_unit") \
            or not record.get("rate"):
        return None
    return mfu_pct(record["flops_per_unit"], record["rate"])
