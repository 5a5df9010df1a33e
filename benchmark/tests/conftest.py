"""The benchmark's own tests: the reference against the port's CPU path,
the harness driven on the CPU at a tiny size, and (marked ``cuda``) a
short run on the card. Run from the repository root:

    python -m pytest benchmark/tests -q
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        benchmark/tests/test_bench_cuda.py     # on the card
"""

import pytest
import torch

torch.set_num_threads(2)

# the CPU tests' small sizes: a few pixels, samples and bounces, 200
# spheres, three compared rows, a short profiled span
TINY = {"config": {"width": 24, "height": 8, "spp": 2, "bounces": 3,
                   "n_spheres": 200},
        "workload": {"check": {"rows": 3},
                     "profile": {"skip": 3, "frames": 5}}}


@pytest.fixture
def tiny():
    return TINY
