"""The extraction step's share of the card's bf16 peak, in %.

The FLOPs of a batch's networks, 2 streams x K splits of BN-Inception over
B clips x T ticks (``benchmark/flops.py``, the per-layer model copied from
``tools/cnn_roofline.py``), times the batches completed in the traced
window, over the window and the published 989 TFLOP/s. The flow's
arithmetic (TV-L1, the camera, the rescue) is not counted.
"""

from benchmark import stats


def read(run):
    w = run.work
    if not w.get("batches") or not run.trace.window_s:
        return None
    return 100.0 * w["batch_flops"] * w["batches"] / run.trace.window_s / stats.PEAK_BF16_FLOPS
