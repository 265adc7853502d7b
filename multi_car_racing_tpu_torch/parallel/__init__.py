"""Data parallelism over processes: ``mesh`` (torch.distributed)."""
