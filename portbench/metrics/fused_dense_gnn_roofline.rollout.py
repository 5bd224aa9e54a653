"""fused_dense_gnn_roofline.rollout: row 1, `ops/cuda/fused_gnn.py::
fused_dense_gnn` (csrc/dense_gnn.cu, symbol dense_gnn_kernel): the bound of
the dense stack's forward calls in the trace over their traced time."""

from portbench.metrics._common import roofline_pct

SYMBOLS = r"\bdense_gnn_kernel\b"


def read(view):
    return roofline_pct(view, "fused_dense_gnn", SYMBOLS)
