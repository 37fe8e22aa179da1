"""The row-sharded layer on `torch.distributed` (port of
`meepoembedding_tpu/parallel/`, without `colsharded.py`): one process a
rank, each rank holding one table shard."""
