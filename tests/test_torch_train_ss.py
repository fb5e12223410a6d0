"""The GOLF-ss (``golf-precise.yaml``) training step of the port against
golf_tpu's, on the CPU: the checks of ``test_torch_train.py``'s GOLF-ff
cases, in a file of their own so that the two slow JAX references (an
eager ``jax.value_and_grad`` of the whole step) run on two test workers."""

import pytest
import torch

from tests.test_torch_train import (check_adam_trajectory,
                                    check_training_step, make_jax_step)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_step():
    return make_jax_step("golf-precise")


def test_training_step_matches_golf_tpu(jax_step):
    check_training_step(jax_step)


def test_adam_trajectory_tracks_golf_tpu(jax_step):
    check_adam_trajectory(jax_step)
