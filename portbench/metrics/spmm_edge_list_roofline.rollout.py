"""spmm_edge_list_roofline.rollout: row 3, `ops/cuda/spmm.py::spmm_edge_list`
(csrc/spmm.cu on csrc/edge_tile.cuh, symbol edge_tile::kernel): the bound
of the aggregations in the trace (forward, and dx on the flipped edges in
training) over their traced time."""

from portbench.metrics._common import roofline_pct

SYMBOLS = r"\bedge_tile::kernel\b"


def read(view):
    return roofline_pct(view, "spmm_edge_list", SYMBOLS)
