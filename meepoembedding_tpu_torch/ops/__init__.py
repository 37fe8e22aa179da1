"""Batch ops of the port: id deduplication, bag pooling."""
