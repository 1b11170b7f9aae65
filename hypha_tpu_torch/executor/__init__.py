"""Executors of the port (counterpart of ``hypha_tpu/executor``): one-shot
generation, the block allocator and the paged decode pool for serving; the
SafeTensors reader/writer, slice batches and the input pipeline, the
preprocessors, the inner step, the DiLoCo algebra, ``run_training`` and its
CLI, and the Job-Bridge client for training."""

# Slices the input pipeline fetches ahead when the job doesn't pin a depth
# (``dataset.SlicePrefetcher``): one training, one landing, one in flight.
# The scheduler resolves a job's depth with it too, and imports no torch,
# so it lives here rather than in ``dataset.py``.
DEFAULT_PREFETCH_SLICES = 2
