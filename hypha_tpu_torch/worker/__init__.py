"""Worker side of the port (counterpart of ``hypha_tpu/worker``): model
loading and the pool server for serving; for training, the worker runtime
(``runtime.WorkerNode``: the auction's arbiter, leases, the job manager),
the in-process and process train executors behind the Job Bridge, the
peer connector, and the parameter server."""
