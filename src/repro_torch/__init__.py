"""PyTorch/CUDA port of the Nightjar reproduction: paged speculative decoding
served on an NVIDIA H100, with hand-written CUDA kernels for paged attention
and KV block migration.  Imports no JAX and nothing of the ``repro``
package."""
