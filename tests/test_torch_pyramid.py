"""The conv pyramid's stage functions (``golf_tpu_torch.ops.pyramid``) on
the CPU: the plain versions against ``ConvPyramid``'s chain of torch ops,
the module's routing by mode, the wrapper's argument check and the tile
planner of the CUDA kernel (P1), whose numbers are the card's
(``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from golf_tpu_torch import kernels
from golf_tpu_torch.models.unet import ConvPyramid
from golf_tpu_torch.ops import pyramid as pyr


def _pyramid(in_ch, channels, strides, seed):
    """A ConvPyramid with seeded running statistics and some negative
    batch-norm scales, in eval mode."""
    torch.manual_seed(seed)
    p = ConvPyramid(in_ch, channels, strides)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n in p.norms:
            n.running_mean.normal_(0.0, 0.2, generator=g)
            n.running_var.uniform_(0.5, 2.0, generator=g)
            n.weight.normal_(0.0, 1.0, generator=g)
            n.bias.normal_(0.0, 0.1, generator=g)
    return p.eval()


def _chain(p, x):
    """``ConvPyramid``'s fp32 eval chain as the module ran it before the
    stage functions: conv, batch norm, ReLU, the strided max."""
    for conv, norm, s in zip(p.convs, p.norms, p.strides):
        x = pyr.strided_max(F.relu(norm(conv(x))), s, axis=2)
    return x


# (in channels, channels, strides, (B, F, T)): synthetic.yaml's pyramid at
# its spectrogram (n_fft 1024), the same at odd F and T, and KH = 5
# (s = 2) at odd F and T
CASES = [(1, (8, 16), (4, 4), (2, 513, 40)),
         (1, (8, 16), (4, 4), (2, 511, 37)),
         (3, (6, 10), (2, 2), (3, 45, 29))]


@pytest.mark.parametrize("in_ch,channels,strides,shape", CASES)
def test_stage_eval_plain_is_the_module_chain(in_ch, channels, strides,
                                              shape):
    """``pyramid_stage_eval_plain`` stage by stage equals the module's eval
    chain bit for bit."""
    p = _pyramid(in_ch, channels, strides, 1)
    b, f, t = shape
    x = torch.randn(b, in_ch, f, t, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = _chain(p, x)
        got = x
        for conv, norm, s in zip(p.convs, p.norms, p.strides):
            got = pyr.pyramid_stage_eval_plain(got, conv, norm, s)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("in_ch,channels,strides,shape", CASES)
def test_conv_pyramid_eval_same_with_and_without_grad(in_ch, channels,
                                                      strides, shape):
    """In eval mode the module returns the same tensor under no_grad (the
    fused stage) and with gradients on (the bias-only convolution, then
    the torch ops), and that is the chain's."""
    p = _pyramid(in_ch, channels, strides, 3)
    b, f, t = shape
    x = torch.randn(b, in_ch, f, t, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        fused = p(x)
        ref = _chain(p, x)
    with_grad = p(x)
    assert with_grad.requires_grad
    assert torch.equal(fused, with_grad.detach())
    assert torch.equal(fused, ref)


def test_conv_pyramid_train_mode_is_the_torch_chain():
    """In train mode the convolution is ``pyramid_conv`` (``F.conv2d`` on
    the CPU) and the rest the module's ops: output and gradients equal
    ``nn.Conv2d``'s chain bit for bit, running statistics too."""
    p = _pyramid(1, (8, 16), (4, 4), 5).train()
    q = _pyramid(1, (8, 16), (4, 4), 5).train()
    x = torch.randn(2, 1, 129, 21, generator=torch.Generator().manual_seed(6))
    got = p(x)
    ref = x
    for conv, norm, s in zip(q.convs, q.norms, q.strides):
        ref = pyr.strided_max(F.relu(norm(conv(ref))), s, axis=2)
    assert torch.equal(got, ref)
    got.square().sum().backward()
    ref.square().sum().backward()
    for (name, a), b in zip(p.named_parameters(), q.parameters()):
        assert torch.equal(a.grad, b.grad), name
    for a, b in zip(p.buffers(), q.buffers()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["pyramid_conv", "pyramid_conv_eval"])
def test_pyramid_kernels_are_built_with_the_rest(monkeypatch, kernel):
    """Both entries are in ``kernels.ALL`` and share ``pyramid_conv.cu``'s
    library; the build command names that source (no ``nvcc`` is run)."""
    k = next(k for k in kernels.ALL if k.name == kernel)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    cmd = k.build_command(kernels.BUILD / "x.so")
    assert cmd[0] == "nvcc" and cmd[-1].endswith("csrc/pyramid_conv.cu")
    assert "sm_90a" in " ".join(cmd)
    assert k.library_path == kernels.PYRAMID_CONV.library_path
    assert k.span_name == f"kernel.{kernel}"


def _args(x=(2, 3, 16, 10), w=(4, 3, 9, 3), dtype=torch.float32):
    return (torch.zeros(x, dtype=dtype), torch.zeros(w, dtype=dtype),
            torch.zeros(w[0], dtype=dtype))


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_check_conv_args_takes_each_stride(s):
    x, w, b = _args(w=(5, 3, 2 * s + 1, 3))
    assert pyr.check_conv_args("t", x, w, b) == s


@pytest.mark.parametrize("case", ["fp64", "strided_x", "strided_w", "rank",
                                  "kw", "s5", "cin", "bias"])
def test_check_conv_args_refuses(case):
    x, w, b = _args()
    err = ValueError
    if case == "fp64":
        x, w, b = _args(dtype=torch.float64)
        err = TypeError
    elif case == "strided_x":
        x = torch.zeros(2, 3, 10, 16).transpose(2, 3)
    elif case == "strided_w":
        w = torch.zeros(4, 3, 3, 9).transpose(2, 3)
    elif case == "rank":
        x = torch.zeros(3, 16, 10)
    elif case == "kw":
        w = torch.zeros(4, 3, 9, 5)
    elif case == "s5":
        w = torch.zeros(4, 3, 11, 3)
    elif case == "cin":
        x = torch.zeros(2, 5, 16, 10)
    elif case == "bias":
        b = torch.zeros(5)
    with pytest.raises(err):
        pyr.check_conv_args("t", x, w, b)


# the recipe's stages at B = 64 x 2 s (eval rows: (F // 4) 4), and small
# and ragged shapes
PLAN_SHAPES = [(64, 1, 32, 513, 200, 4), (64, 1, 32, 512, 200, 4),
               (64, 32, 64, 128, 200, 4), (64, 64, 128, 32, 200, 4),
               (64, 128, 256, 8, 200, 4), (2, 1, 8, 513, 40, 4),
               (3, 5, 24, 36, 50, 2), (1, 7, 3, 5, 3, 1), (2, 9, 40, 30, 17, 3)]


@pytest.mark.parametrize("b,cin,cout,rows,t,s", PLAN_SHAPES)
def test_plan_conv_fits_the_kernel(b, cin, cout, rows, t, s):
    """The planned tile is one of the candidates: 256 threads, two stages
    within the shared memory of two CTAs an SM, a chunk that divides into
    the input channels' power-of-two padding, and no channel tile twice
    the channels or wider."""
    p = pyr.plan_conv(b, cin, cout, rows, t, s)
    assert p in pyr.candidate_plans(cin, cout, s)
    assert p.cog * p.rg * p.cg == pyr.THREADS
    assert 8 * pyr.stage_floats(s, *p) <= pyr.STAGES_BYTES
    assert p.chunk <= max(1, cin) and p.chunk & (p.chunk - 1) == 0
    assert p.cog == 1 or pyr.CO_THREAD * p.cog < 2 * cout
