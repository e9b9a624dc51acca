"""Tensor parallelism for the single-controller port: the sharding plan
(``sharding.py``) and the collectives that the JAX package leaves to GSPMD
(``collectives.py``).  The JAX package's ``hints.py`` has no counterpart:
it pins attention heads and logits to ``model`` inside a jit, and the
port's explicit per-shard layout already holds them there."""
