"""The benchmark's counts of operations and bytes, pinned to values worked
out by hand."""

import pytest

from portbench import yardstick as y

W = [32, 32, 32]  # the README stacks: 2 layers 32 -> 32


def test_dense_stack_operations_and_bytes():
    # a layer: 2·B·(N²·32 + 2·N·32·32) = 2·1·(16,384·32 + 262,144)
    #        = 2·(524,288 + 262,144) = 1,572,864; two layers 3,145,728
    assert y.dense_gnn_ops(1, 128, W) == 3_145_728
    assert y.dense_gnn_ops(1024, 128, W) == 1024 * 3_145_728
    # params: 2 x (32·32 + 32 + 32·32) = 4,160
    assert y.conv_params(W) == 4160
    # B=2, N=4, widths 3 -> 5: x 2·4·3 = 24, adj 32, params 3·5·2 + 5 = 35,
    # out 2·4·5 = 40: 131 floats
    assert y.dense_gnn_bytes(2, 4, [3, 5]) == 4 * 131
    # backward: x 24 + adj 32 + g 40 + params 35, then dx 24 + dparams 35
    assert y.dense_gnn_bwd_bytes(2, 4, [3, 5]) == 4 * 190


def test_sparse_counts():
    assert y.temporal_edges(80, [1]) == 79
    assert y.temporal_edges(1, [1]) == 0
    assert y.temporal_edges(5, [1, 2]) == 4 + 3
    assert y.temporal_sources(5, [1, 2]) == 4
    assert y.temporal_sources(0, [1]) == 0
    # 2 layers: 2·E·32 + 2·B·2·N·32·32 each; B=1, N=128, E=79
    assert y.sparse_gnn_ops(1, 128, 79, W) == 2 * (2 * 79 * 32 + 524_288)
    # x rows 79·32 floats, edges 79·12 bytes, out 128·32 floats
    assert y.spmm_bytes(1, 128, 32, 79, 79) == 4 * 79 * 32 + 12 * 79 \
        + 4 * 128 * 32
    assert y.linear_ops(1024 * 128, 8, 32) == 2 * 1024 * 128 * 8 * 32


@pytest.mark.parametrize("hops", [[1], [1, 2], [2, 5]])
def test_the_batch_totals_match_graph_by_graph(hops):
    import numpy as np

    n = np.random.default_rng(0).integers(0, 9, 500)
    edges, rows = y.temporal_totals(n, hops)
    assert edges == sum(y.temporal_edges(int(v), hops) for v in n)
    assert rows == sum(y.temporal_sources(int(v), hops) for v in n)


def test_the_bound_names_what_binds():
    t, by = y.bound_s(495e12, 1.0)
    assert by == "ops" and t == pytest.approx(1.0)
    t, by = y.bound_s(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)
