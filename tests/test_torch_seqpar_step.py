"""The port's time-sharded training step (``parallel.seqpar.
make_sharded_train_step``) against golf_tpu's single-device step, on the
CPU.

For a tiny GOLF-ss (oversampling 1 and 4) and GOLF-ff (the configuration of
``tests/test_seqpar.py``), B = 4 x 9600 samples: golf_tpu's jitted step
gives the loss, the gradients and its noise field; four spawned gloo ranks
run the port's sharded step at 2 x 2 (data x time), then ranks 0 and 1 at
1 x 2, on the global batch with that noise and golf_tpu's weights. Held
with golf_tpu's own limits for its sharded step (``tests/test_seqpar.py``):
loss within 2e-4 relative and 2e-5 absolute, each gradient scaled by its
largest entry within 5e-4 (the conv biases in front of a train-mode batch
norm, zero in exact arithmetic, against their conv weight's gradient, as
``test_torch_train.py`` holds them).
"""

import pytest
import torch

from tests.test_torch_parallel_dp import (JaxReference, check_grads,
                                          run_ranks, sharded_worker,
                                          tiny_cfg)

torch.set_num_threads(1)

CASES = {"ss1": dict(oversampling=1), "ss4": dict(oversampling=4),
         "ff": dict(oversampling=1, ff=True)}
LAYOUTS = [(2, 2), (1, 2)]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    ref = JaxReference(tiny_cfg(**CASES[request.param]), 4, 4 * 2400,
                       seed=2, key=5)
    out = run_ranks(4, tmp_path_factory.mktemp("store"), sharded_worker,
                    ref.cfg, ref.variables, ref.x, ref.f0, ref.noise,
                    LAYOUTS)
    return ref, dict(zip(LAYOUTS, out[0]))


@pytest.mark.parametrize("layout", LAYOUTS, ids=["2x2", "1x2"])
def test_sharded_step_matches_golf_tpu(case, layout):
    ref, got = case
    loss, grads = got[layout]
    assert abs(loss - ref.loss) <= 2e-4 * abs(ref.loss) + 2e-5
    check_grads(grads, ref.grads, 5e-4)
