"""Data generators of the port: the classic models' synthetic data, random
LM batches and the LM trainer's token stream (``ShardedLMDataset``)."""
from repro_torch.data.pipeline import ShardedLMDataset

__all__ = ["ShardedLMDataset"]
