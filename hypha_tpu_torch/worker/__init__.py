"""Worker side of the port (counterpart of ``hypha_tpu/worker``): model
loading and the pool server for serving; the Job Bridge an executor
process talks to, its URI connector, and the parameter server's outer
step for training."""
