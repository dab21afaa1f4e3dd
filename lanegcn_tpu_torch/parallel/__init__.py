"""Multi-GPU training: the windowed (scenario-aligned) data×graph split on
torch.distributed (windowed_parallel.py), its process layout (mesh.py) and
the metric sums across ranks (multihost.py)."""
