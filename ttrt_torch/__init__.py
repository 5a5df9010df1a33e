"""ttrt_torch: the terminal ray tracer ported to PyTorch and CUDA.

A second package beside the JAX reference ``ttrt``, with the same module
names. It imports torch and numpy, never JAX or ``ttrt``. ``python -m
ttrt_torch`` animates the reference's demo scene through the hand-written
CUDA render kernel (``ttrt_torch/kernels/csrc/render.cu``).
"""
