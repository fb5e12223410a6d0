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
from golf_tpu_torch.ops import lookup as tlk
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
@pytest.mark.parametrize("b,blocks,hop,s", [(3, 7, 1000, 1000),
                                            (2, 5, 9600, 2048)])
def test_cuda_lookup_res_and_dtab_match_plain(cuda_device, b, blocks, hop,
                                              s):
    r = np.random.default_rng(1)
    ph = r.random((b, blocks, hop), np.float32)
    ph[:, :, :4] = np.float32(1.0 - 1e-4)      # the wrap column
    tabs = r.standard_normal((b, blocks + 2, s)).astype(np.float32)
    g = r.standard_normal((b, blocks, hop)).astype(np.float32)
    ph, tabs, g = (torch.from_numpy(a).cuda() for a in (ph, tabs, g))
    outs = tlk.lookup_res_cuda(ph, tabs, hop)
    refs = tlk.lookup_res_plain(ph, tabs, hop)
    # B3a: the output rounds like B1 (2e-6); the residuals are differences
    # of the same gathered values, bit for bit
    assert (outs[0] - refs[0]).abs().max().item() <= 2e-6
    assert torch.equal(outs[1], refs[1]) and torch.equal(outs[2], refs[2])
    # B3b: shared-memory atomics add in a varying order: 1e-5 of max|ref|
    d = tlk.lookup_dtab_cuda(ph, g, hop, tabs.shape[1], s)
    ref = tlk.lookup_dtab_plain(ph, g, hop, tabs.shape[1], s)
    assert d.shape == tabs.shape
    assert ((d - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lookup", "allpole_const", "allpole"])
def test_cuda_function_backward_matches_plain(cuda_device, name):
    """Each autograd Function's backward through the kernels against the
    same Function on the plain versions, on the card, same cotangent."""
    r = np.random.default_rng(2)
    if name == "lookup":
        ph = torch.from_numpy(r.random((2, 5, 3000), np.float32))
        tab = torch.from_numpy(r.standard_normal((2, 6, 2048)).astype(
            np.float32))
        fns = [lambda p_, t, ops=ops: tlk.lookup_blocks(p_, t, 3000, ops)
               for ops in (tlk.CUDA_OPS, tlk.PLAIN_OPS)]
        inputs = (ph, tab)
    elif name == "allpole_const":
        inputs = (torch.from_numpy(r.standard_normal((300, 960)).astype(
            np.float32)), _lpc(r, (300, 22), 0.2))
        fns = [lambda x, a, f=f: tap.allpole_const(x, a, f)
               for f in (tap.allpole_const_cuda, tap.allpole_const_plain)]
    else:
        inputs = (torch.from_numpy(r.standard_normal((3, 4000)).astype(
            np.float32)), _lpc(r, (3, 4000, 22), 0.1))
        fns = [lambda x, a, f=f: tap.allpole(x, a, f)
               for f in (tap.allpole_cuda, tap.allpole_plain)]
    grads = []
    for fn in fns:
        ins = [t.cuda().requires_grad_() for t in inputs]
        out = fn(*ins)
        g = torch.from_numpy(np.random.default_rng(3).standard_normal(
            tuple(out.shape)).astype(np.float32)).cuda()
        grads.append(torch.autograd.grad(out, ins, g))
    # the kernels' sequential recurrences and atomics against the plain
    # versions' blocked forms and scatter_add: 1e-4 of max|ref|
    for u, v in zip(*grads):
        assert ((u - v).abs().max() / v.abs().max()).item() <= 1e-4


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
