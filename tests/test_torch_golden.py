"""The stored JAX goldens (tests/data/torch_port_golden.npz,
tests/data/torch_port_golden_mesh.npz and
tests/data/torch_port_golden_sky.npz), which the machine with the card
reads in place of JAX, must equal what tests/make_torch_golden.py computes
from the JAX package now."""

import numpy as np

from make_torch_golden import (GOLDEN_PATH, HEIGHT, MESH_GOLDEN_PATH,
                               SKY_FRAMES, SKY_GOLDEN_PATH, TIMES, WIDTH,
                               golden_arrays, mesh_golden_arrays,
                               sky_golden_arrays)


def test_stored_golden_is_current():
    want = golden_arrays()
    with np.load(GOLDEN_PATH) as stored:
        assert sorted(stored.files) == sorted(want)
        for key, value in want.items():
            assert stored[key].dtype == np.asarray(value).dtype, key
            np.testing.assert_array_equal(stored[key], value, err_msg=key)


def _check_without_knife(path, want, n_frames):
    """``path`` holds ``want``'s arrays, and (H, W) bool knife masks."""
    with np.load(path) as stored:
        knife = {f"k{j}_{i}" for j in (1, 2) for i in range(n_frames)}
        assert sorted(stored.files) == sorted(set(want) | knife)
        for key, value in want.items():
            assert stored[key].dtype == np.asarray(value).dtype, key
            np.testing.assert_array_equal(stored[key], value, err_msg=key)
        for key in knife:
            assert stored[key].dtype == bool, key
            assert stored[key].shape == (HEIGHT, WIDTH), key


def test_stored_mesh_golden_is_current():
    """The many-object golden (tests/data/torch_port_golden_mesh.npz): its
    scene leaves, config, frames and trace counts equal what the JAX
    package computes now. The knife masks are left to
    ``python tests/make_torch_golden.py mesh``: they are a function of the
    checked arrays, and recomputing them takes two minutes."""
    _check_without_knife(MESH_GOLDEN_PATH, mesh_golden_arrays(knife=False),
                         len(TIMES))


def test_stored_sky_golden_is_current():
    """The image-sky golden (tests/data/torch_port_golden_sky.npz), as the
    many-object golden: all but its knife masks (twelve minutes of
    ``python tests/make_torch_golden.py sky``)."""
    _check_without_knife(SKY_GOLDEN_PATH, sky_golden_arrays(knife=False),
                         len(SKY_FRAMES))
