"""Data-parallel scale-out: one process per GPU over torch.distributed."""
