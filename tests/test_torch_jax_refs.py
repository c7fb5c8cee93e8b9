"""The stored JAX outputs of tests/torch_jax_refs.npz against their inputs.

Each case's inputs are rebuilt from their seeds (numpy, the JAX package's
scene functions, and for ``field_replay`` the port's plain sorted render,
which sets the cotangent) and must hash to the digest stored with that
case's outputs; every output must be finite. The outputs themselves come
from the JAX package's Pallas kernels in interpret mode, through
``python tests/torch_jax_refs.py``, which rewrites the file.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch_jax_refs as refs


@pytest.mark.parametrize("case", sorted(refs.CASES))
def test_stored_outputs_match_their_inputs(case):
    make_inputs, _ = refs.CASES[case]
    out = refs.outputs(case, make_inputs())
    assert out, case
    for name, v in out.items():
        assert v.size > 0 and (v.dtype.kind not in "fc" or np.isfinite(v).all()), (case, name)
