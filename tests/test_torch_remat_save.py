"""The "save:" remat policies of tests/test_remat.py's grid: the port's
loss and gradients with remat under each equal its own without remat bit
for bit and match the JAX model's with the same policy, as
tests/test_torch_remat.py holds the named policies (tolerances there).  A
module of its own because each JAX policy is a compile of ~6 s."""

import pytest

from tests.test_torch_convert import torch_one_thread  # noqa: F401
from tests.test_torch_remat import (SAVE_POLICIES, check_policy,  # noqa: F401
                                    reference)


@pytest.mark.parametrize("policy", SAVE_POLICIES)
def test_save_policy_equals_no_remat_and_jax(policy, reference):
    check_policy(policy, reference)
