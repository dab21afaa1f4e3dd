"""Multi-GPU training on torch.distributed: the windowed (scenario-aligned)
data×graph split (windowed_parallel.py), the explicit graph-parallel split
(graph_parallel.py, on the source-partitioned layers of graph_shard.py),
their process layout and collectives (mesh.py) and the metric sums across
ranks (multihost.py)."""
