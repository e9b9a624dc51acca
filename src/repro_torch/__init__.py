"""PyTorch/CUDA port of the SYMPHONY reproduction.

The package mirrors ``src/repro``'s module layout so each module's
counterpart is easy to find, imports ``torch`` and ``numpy`` and nothing
of JAX or of the JAX package, and runs on the card by default: its entry
points take ``device="cuda"`` and raise on a machine without one, unless
the caller asks for the CPU."""
