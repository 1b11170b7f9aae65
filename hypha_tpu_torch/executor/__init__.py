"""Executors of the port (counterpart of ``hypha_tpu/executor``): one-shot
generation, the block allocator and the paged decode pool for serving; the
SafeTensors reader/writer, slice batches, the inner step, the DiLoCo
algebra, ``run_training`` and its CLI, and the Job-Bridge client for
training."""
