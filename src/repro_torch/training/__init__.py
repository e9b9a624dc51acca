"""Training: the data pipeline, AdamW with float32 masters and gradient
accumulation, checkpoints in the JAX package's on-disk format, int8
gradient compression and the fault-tolerant loop."""
