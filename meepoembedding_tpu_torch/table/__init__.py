"""Hash table of the port: id hashing, shard layout, table ops, runtime."""
