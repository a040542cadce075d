"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

Same module layout as the JAX package: each module here is the counterpart
of ``src/repro/<same path>``.  The JAX package stays the reference this
port is held against; the port imports ``torch`` and numpy, never JAX.
"""
