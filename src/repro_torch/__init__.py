"""NeutronTP in PyTorch with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro``, built beside it and held against it
by the tests.  Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU.
"""
