"""ttrt_torch: the terminal ray tracer ported to PyTorch and CUDA.

A second package beside the JAX reference ``ttrt``, with the same module
names. It imports torch and numpy, never JAX or ``ttrt``. ``python -m
ttrt_torch`` animates the reference's demo scene through the hand-written
CUDA render kernel (``ttrt_torch/kernels/csrc/render.cu``).
"""

import time as _time

# the host clock at the package's first line: set-up's 'import' phase
# starts here (``utils.profiling.SETUP``; the interpreter loads ``time``)
IMPORTED_AT = _time.perf_counter()
