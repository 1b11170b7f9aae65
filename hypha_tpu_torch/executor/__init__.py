"""Serving executors of the port (counterpart of ``hypha_tpu/executor``):
one-shot generation, the block allocator and the paged decode pool."""
