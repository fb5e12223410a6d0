"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor ``golf_tpu``, so it also runs where they are
not installed; there ``tests/conftest.py`` (which imports JAX) is left
out::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Inputs are numpy-seeded; the all-pole coefficients come from
``rc2lpc(tanh(.))`` as the model makes them.
"""

import numpy as np
import pytest
import torch

from golf_tpu_torch.ops import allpole as tap
from golf_tpu_torch.ops.dsp import rc2lpc
from golf_tpu_torch.ops.lookup import lookup_blocks_cuda, lookup_blocks_plain

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lpc(rng, shape, scale):
    logits = rng.standard_normal(shape).astype(np.float32) * scale
    return rc2lpc(torch.tanh(torch.from_numpy(logits))).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("b,blocks,hop,s", [(3, 7, 1000, 1000),
                                            (2, 5, 9600, 2048)])
def test_cuda_lookup_matches_plain(cuda_device, b, blocks, hop, s):
    r = np.random.default_rng(0)
    ph = r.random((b, blocks, hop), np.float32)
    ph[:, :, :4] = np.float32(1.0 - 1e-4)      # the wrap column
    tabs = r.standard_normal((b, blocks + 1, s)).astype(np.float32)
    ph, tabs = torch.from_numpy(ph).cuda(), torch.from_numpy(tabs).cuda()
    out = lookup_blocks_cuda(ph, tabs, hop)
    ref = lookup_blocks_plain(ph, tabs, hop)
    # built without FMA contraction, the kernel rounds like the plain
    # version; 2e-6 is chip_smoke.py's tolerance
    assert (out - ref).abs().max().item() <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("p", [22, 5, 40])
def test_cuda_allpole_matches_plain(cuda_device, p):
    # the plain versions run the blocked two-pass form, the kernels the
    # sequential recurrence: 1e-5 of max|y| at this low filter gain
    rng = np.random.default_rng(p)
    x = torch.from_numpy(rng.standard_normal((3, 3000)).astype(np.float32))
    a = _lpc(rng, (3, 3000, p), 0.1)
    ac = _lpc(rng, (3, p), 0.1)
    for kernel, plain, aa in ((tap.allpole_cuda, tap.allpole_plain, a),
                              (tap.allpole_const_cuda,
                               tap.allpole_const_plain, ac)):
        out = kernel(x.cuda(), aa.cuda()).cpu()
        ref = plain(x, aa)
        assert (out - ref).abs().max() / ref.abs().max() < 1e-5


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_device):
    x = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(TypeError):
        tap.allpole_const_cuda(x.double(), torch.zeros(2, 3).double().cuda())
    with pytest.raises(ValueError):
        tap.allpole_const_cuda(x.t(), torch.zeros(8, 3, device=cuda_device))
    with pytest.raises(ValueError):
        tap.allpole_cuda(x, torch.zeros(2, 7, 3, device=cuda_device))
    with pytest.raises(ValueError):
        lookup_blocks_cuda(torch.zeros(1, 2, 4, device=cuda_device),
                           torch.zeros(1, 2, 8, device=cuda_device), 4)
    with pytest.raises(NotImplementedError):
        tap.allpole_const_cuda(x.requires_grad_(),
                               torch.zeros(2, 3, device=cuda_device))
