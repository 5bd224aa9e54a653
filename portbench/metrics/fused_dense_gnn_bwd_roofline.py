"""fused_dense_gnn_bwd_roofline: row A, `ops/cuda/fused_gnn.py::
fused_dense_gnn_bwd` (csrc/dense_gnn_bwd.cu: the backward kernel and the
sum of its partials, symbols dense_gnn_bwd_kernel and sum_partials_kernel):
the bound of the stack's backward calls in the trace over their traced
time."""

from portbench.metrics._common import roofline_pct

SYMBOLS = r"\b(dense_gnn_bwd_kernel|sum_partials_kernel)\b"


def read(view):
    return roofline_pct(view, "fused_dense_gnn_bwd", SYMBOLS)
