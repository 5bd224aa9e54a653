"""gcm_tpu_torch.edges: the dense selectors (temporal, dense, distance,
learned, chain) and the sparse ones (sparse_temporal, sparse_spatial,
sparse_learned); see the modules."""
