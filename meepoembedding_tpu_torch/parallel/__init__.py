"""The row- and column-sharded layers on `torch.distributed` (port of
`meepoembedding_tpu/parallel/`): one process a rank, each rank holding one
table shard, or one column block of it (`colsharded.py`)."""
