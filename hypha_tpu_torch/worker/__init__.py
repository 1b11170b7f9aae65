"""Worker-side serving of the port (counterpart of ``hypha_tpu/worker``):
model loading and the pool server."""
