"""The stored JAX golden (tests/data/torch_port_golden.npz), which the
machine with the card reads in place of JAX, must equal what
tests/make_torch_golden.py computes from the JAX package now."""

import numpy as np

from make_torch_golden import GOLDEN_PATH, golden_arrays


def test_stored_golden_is_current():
    want = golden_arrays()
    with np.load(GOLDEN_PATH) as stored:
        assert sorted(stored.files) == sorted(want)
        for key, value in want.items():
            assert stored[key].dtype == np.asarray(value).dtype, key
            np.testing.assert_array_equal(stored[key], value, err_msg=key)
