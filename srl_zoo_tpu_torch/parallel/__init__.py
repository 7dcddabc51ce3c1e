"""Data parallelism over torch.distributed (parallel/mesh.py)."""
