"""Training data of the port: the synthetic token stream and its
relocatable batch-row assignment."""
from .pipeline import ShardedBatches, TokenSource, make_global_batch

__all__ = ["ShardedBatches", "TokenSource", "make_global_batch"]
