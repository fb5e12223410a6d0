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


# B1's and B3a's shapes: (B, blocks, hop, S). A push (4, 3, 9600, 2048); a
# hop not divisible by 4 (the scalar path); a hop shorter than a CTA's
# piece; S = 8192, two rows of 64 KB (dynamic shared memory above 48 KB)
LOOKUP_CUDA_SHAPES = [(3, 7, 1000, 1000), (2, 5, 9600, 2048),
                      (4, 3, 9600, 2048), (3, 7, 999, 1000), (2, 5, 7, 64),
                      (2, 3, 2400, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,blocks,hop,s", LOOKUP_CUDA_SHAPES)
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
@pytest.mark.parametrize("b,blocks,hop,s", LOOKUP_CUDA_SHAPES)
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
@pytest.mark.parametrize("b,blocks,hop,s", [(2, 5, 9600, 2048),
                                            (3, 7, 999, 1000),
                                            (4, 3, 9600, 2048),
                                            (2, 5, 7, 64)])
def test_cuda_lookup_row_weight_across_pieces(cuda_device, b, blocks, hop,
                                              s):
    """Row f + 1 is row f plus 1 and every row is constant, so out - row f
    is the row weight i / hop of each sample, i its index within its
    block, also where one CTA's piece ends and the next one's begins."""
    plan = tlk.plan_split(b, blocks, hop, s,
                          tlk.sm_count(cuda_device.index or 0))
    assert plan.splits > 1
    r = np.random.default_rng(4)
    rows = np.arange(blocks + 1, dtype=np.float32)
    tabs = np.broadcast_to(rows[None, :, None], (b, blocks + 1, s)).copy()
    ph = torch.from_numpy(r.random((b, blocks, hop), np.float32)).cuda()
    tabs = torch.from_numpy(tabs).cuda()
    out = lookup_blocks_cuda(ph, tabs, hop)
    assert (out - lookup_blocks_plain(ph, tabs, hop)).abs().max() <= 2e-6
    rw = (out - torch.arange(blocks, device="cuda")[None, :, None]).double()
    want = torch.arange(hop, device="cuda", dtype=torch.float64) / hop
    # the blends of values up to 8 round within a few of their ulps (5e-7)
    assert (rw - want).abs().max().item() <= 4e-6


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
        fns = [lambda x, a, ops=ops: tap.allpole_const(x, a, ops)
               for ops in (tap.CONST_CUDA_OPS, tap.CONST_PLAIN_OPS)]
    else:
        inputs = (torch.from_numpy(r.standard_normal((3, 4000)).astype(
            np.float32)), _lpc(r, (3, 4000, 22), 0.1))
        fns = [lambda x, a, ops=ops: tap.allpole(x, a, ops)
               for ops in (tap.CUDA_OPS, tap.PLAIN_OPS)]
    grads = []
    for fn in fns:
        ins = [t.cuda().requires_grad_() for t in inputs]
        out = fn(*ins)
        g = torch.from_numpy(np.random.default_rng(3).standard_normal(
            tuple(out.shape)).astype(np.float32)).cuda()
        grads.append(torch.autograd.grad(out, ins, g))
    # the kernels (sequential and chunked float64) and atomics against the
    # plain versions' blocked forms and scatter_add: 1e-4 of max|ref|
    for u, v in zip(*grads):
        assert ((u - v).abs().max() / v.abs().max()).item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("p", [22, 5, 40])
def test_cuda_allpole_matches_plain(cuda_device, p):
    # the plain versions run the blocked two-pass form, the kernels the
    # chunked float64 form (B4) and the sequential recurrence (B2): 1e-5 of
    # max|y| at this low filter gain
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


# (B, T): several chunks with a ragged end, T shorter than a chunk, T = 1
CHUNKED_SHAPES = [(3, 3 * tap.CHUNK + 37), (2, 100), (2, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("p", [5, 22, 40])
@pytest.mark.parametrize("b,t", CHUNKED_SHAPES)
def test_cuda_allpole_chunked_matches_mirror(cuda_device, b, t, p):
    """B4 and its adjoint entry against ``allpole_chunked_plain`` (the same
    algorithm in plain PyTorch) on the card."""
    rng = np.random.default_rng(t + p)
    x = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32))
    a = _lpc(rng, (b, t, p), 0.2)
    x, a = x.cuda(), a.cuda()
    for kernel, adjoint in ((tap.allpole_cuda, False),
                            (tap.allpole_adjoint_cuda, True)):
        out = kernel(x, a)
        ref = tap.allpole_chunked_plain(x, a, adjoint=adjoint)
        # float64 on both sides; the sums run in other orders: 1e-5 of
        # max|y|
        assert out.shape == (b, t)
        assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(48, 512 * 45), (50, 512 * 42 + 77)])
def test_cuda_allpole_paired_rerun(cuda_device, monkeypatch, b, t):
    """With B ceil(T / 512) >= 2112 chunks the re-run pairs them in a CTA
    (an odd count and a ragged last chunk in the second case): the forward
    from zi and the adjoint against ``allpole_chunked_plain`` (1e-5 of
    max|y|), the adjoint bit for bit against the forward entry on the
    materialised operands, and both entries bit for bit against one chunk
    a CTA. The coefficients are ``resonant_inputs``' (frame-rate, capped at
    0.95): i.i.d. ones a sample diverge over this many steps."""
    x, a = tap.resonant_inputs(b + t, b=b, t=t)
    zi = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (b, 22)).astype(np.float32))
    x, a, zi = x.cuda(), a.cuda(), zi.cuda()
    assert tap.rerun_chunks(b, t, 22) == 2
    y = tap.allpole_cuda(x, a, zi)
    ref = tap.allpole_chunked_plain(x, a, zi=zi)
    assert ((y - ref).abs().max() / ref.abs().max()).item() <= 1e-5
    dx = tap.allpole_adjoint_cuda(x, a)
    ref = tap.allpole_chunked_plain(x, a, adjoint=True)
    assert ((dx - ref).abs().max() / ref.abs().max()).item() <= 1e-5
    c = torch.flip(tap._shift_columns(a), (1,)).contiguous()
    assert torch.equal(dx, torch.flip(tap.allpole_cuda(
        torch.flip(x, (1,)).contiguous(), c), (1,)))
    monkeypatch.setattr(tap, "rerun_chunks", lambda *_: 1)
    assert torch.equal(tap.allpole_cuda(x, a, zi), y)
    assert torch.equal(tap.allpole_adjoint_cuda(x, a), dx)


@pytest.mark.cuda
def test_cuda_allpole_adjoint_is_the_materialised_adjoint(cuda_device):
    """The adjoint entry, reading g and a in place, equals the forward entry
    on the flipped cotangent and the flipped, column-shifted coefficients,
    bit for bit."""
    rng = np.random.default_rng(9)
    t = 2 * tap.CHUNK + 91
    g = torch.from_numpy(rng.standard_normal((3, t)).astype(np.float32))
    a = _lpc(rng, (3, t, 22), 0.2)
    g, a = g.cuda(), a.cuda()
    dx = tap.allpole_adjoint_cuda(g, a)
    c = torch.flip(tap._shift_columns(a), (1,)).contiguous()
    ref = torch.flip(tap.allpole_cuda(torch.flip(g, (1,)).contiguous(), c),
                     (1,))
    assert torch.equal(dx, ref)


@pytest.mark.cuda
def test_cuda_allpole_resonant_error_within_float32_scan(cuda_device):
    """On a resonant filter (uncapped) B4's error against a float64 scan is
    no larger than the float32 scan's, on the same inputs."""
    x, a = tap.resonant_inputs(0, cap=None)
    x, a = x.cuda(), a.cuda()
    ref = tap.allpole_scan(x.double(), a.double())
    scale = ref.abs().max()
    err32 = ((tap.allpole_scan(x, a).double() - ref).abs().max() / scale)
    err = ((tap.allpole_cuda(x, a).double() - ref).abs().max() / scale)
    assert torch.isfinite(ref).all() and err32.item() >= 1e-5
    assert err.item() <= err32.item()


CONST_T = [1, 21, 100, 960, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 8, 22, 40, 64])
@pytest.mark.parametrize("t", CONST_T)
def test_cuda_allpole_const_matches_float64_mirror(cuda_device, t, p):
    """B2 and its adjoint entry (dx and da) against the float64 mirrors
    (``allpole_const_scan64``, ``allpole_const_adjoint_scan64``) on the card:
    the register ring (p <= 22), the shared-memory state (p > 22), 16-byte
    (T % 4 == 0) and 4-byte staging, ragged tiles, T < p."""
    for n in (1, 33, 300):
        rng = np.random.default_rng(n * 1000 + t + p)
        x = torch.from_numpy(rng.standard_normal((n, t)).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((n, t)).astype(np.float32))
        a = _lpc(rng, (n, p), 0.2)
        x, g, a = x.cuda(), g.cuda(), a.cuda()
        y = tap.allpole_const_cuda(x, a)
        dx, da = tap.allpole_const_adjoint_cuda(g, y, a)
        dx_only, none = tap.allpole_const_adjoint_cuda(g, y, a, False)
        y_ref = tap.allpole_const_scan64(x, a)
        dx_ref, da_ref = tap.allpole_const_adjoint_scan64(g, y, a)
        # float64 on both sides, sums in another order, fp32 out: 1e-6 of
        # max|ref|
        for out, ref in ((y, y_ref), (dx, dx_ref), (da, da_ref)):
            assert out.shape == ref.shape
            assert ((out - ref).abs().max()
                    / ref.abs().max().clamp_min(1e-30)).item() <= 1e-6
        assert none is None and torch.equal(dx_only, dx)


@pytest.mark.cuda
def test_cuda_allpole_const_backward_launches_the_adjoint_entry(cuda_device):
    """On CUDA the Function's forward launches B2 once and its backward the
    adjoint entry once (no B2 on the flipped cotangent)."""
    from golf_tpu_torch import kernels
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((40, 960)).astype(np.float32))
    a = _lpc(rng, (40, 22), 0.2)
    x, a = x.cuda().requires_grad_(), a.cuda().requires_grad_()
    fwd, adj = kernels.ALLPOLE_CONST, kernels.ALLPOLE_CONST_ADJ
    before = (fwd.launches, adj.launches)
    y = tap.allpole_const(x, a)
    y.backward(torch.ones_like(y))
    assert (fwd.launches - before[0], adj.launches - before[1]) == (1, 1)
    assert x.grad.shape == x.shape and a.grad.shape == a.shape


@pytest.mark.cuda
def test_cuda_recorder_spans_each_kernel_launch(cuda_device):
    """While recording, every launch is a ``kernel.<name>`` span with
    device time; the forward and adjoint entries of B2 once each."""
    from golf_tpu_torch import kernels
    from golf_tpu_torch.utils import profiling
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((40, 960)).astype(np.float32))
    a = _lpc(rng, (40, 22), 0.2)
    x, a = x.cuda().requires_grad_(), a.cuda().requires_grad_()
    fwd, adj = kernels.ALLPOLE_CONST, kernels.ALLPOLE_CONST_ADJ
    before = (fwd.launches, adj.launches)
    with profiling.recording() as rec:
        y = tap.allpole_const(x, a)
        y.backward(torch.ones_like(y))
    totals = rec.totals()
    assert (totals["kernel.allpole_const"]["n"],
            totals["kernel.allpole_const_adjoint"]["n"]) == \
        (fwd.launches - before[0], adj.launches - before[1]) == (1, 1)
    for name in ("kernel.allpole_const", "kernel.allpole_const_adjoint"):
        assert totals[name]["device_ms"] > 0


@pytest.mark.cuda
def test_cuda_recorder_counts_the_finite_check_sync(cuda_device):
    """``host_syncs`` counts ``ClippedOptimizer.step``'s finite check, its
    one synchronizing call, in the span ``optimizer.finite_check``; the
    sync debug mode is restored after."""
    from golf_tpu_torch.train.loop import ClippedOptimizer
    from golf_tpu_torch.utils import profiling
    params = [torch.nn.Parameter(torch.randn(64, 32, device="cuda")),
              torch.nn.Parameter(torch.randn(32, device="cuda"))]
    for p in params:
        p.grad = torch.randn_like(p)
    opt = ClippedOptimizer(params)
    mode = torch.cuda.get_sync_debug_mode()
    with profiling.recording() as rec:
        opt.step()
    assert rec.counts["host_syncs"] == {"optimizer.finite_check": 1}
    assert torch.cuda.get_sync_debug_mode() == mode
    assert rec.totals()["trainer.optimizer"]["device_ms"] > 0


@pytest.mark.cuda
def test_cuda_allpole_const_resonant_within_float64_scan(cuda_device):
    """On resonant constant filters (capped at 0.95 and uncapped) B2's y
    and the adjoint's dx are within 1e-6 of max-abs of a float64 scan, and
    da within 1e-5 of max|da| of the float64 mirror."""
    for cap in (0.95, None):
        x, a = tap.resonant_const_inputs(0, cap=cap)
        x, a = x.cuda(), a.cuda()
        n, t = x.shape
        a_tv = a[:, None, :].expand(n, t, a.shape[1]).double()
        g = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (n, t)).astype(np.float32)).cuda()
        ref = tap.allpole_scan(x.double(), a_tv)
        y = tap.allpole_const_cuda(x, a)
        dx, da = tap.allpole_const_adjoint_cuda(g, y, a)
        dx_ref = torch.flip(tap.allpole_scan(torch.flip(g, (1,)).double(),
                                             a_tv), (1,))
        _, da_ref = tap.allpole_const_adjoint_scan64(g.double(), y,
                                                     a.double())
        assert torch.isfinite(ref).all() and torch.isfinite(dx_ref).all()
        for out, r, tol in ((y, ref, 1e-6), (dx, dx_ref, 1e-6),
                            (da, da_ref, 1e-5)):
            assert ((out.double() - r).abs().max()
                    / r.abs().max()).item() <= tol


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_device):
    x = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(TypeError):
        tap.allpole_const_cuda(x.double(), torch.zeros(2, 3).double().cuda())
    with pytest.raises(ValueError):
        tap.allpole_const_cuda(x.t(), torch.zeros(8, 3, device=cuda_device))
    with pytest.raises(ValueError):
        tap.allpole_cuda(x, torch.zeros(2, 7, 3, device=cuda_device))
    a3 = torch.zeros(2, 8, 3, device=cuda_device)
    _, _, maps = tap.allpole_summary_cuda(x, a3)
    with pytest.raises(ValueError):
        tap.allpole_rerun_cuda(x, a3, torch.zeros(2, 3, device=cuda_device),
                               maps[:, :, :-1].contiguous())
    with pytest.raises(ValueError):
        tap.allpole_rerun_cuda(x, a3, torch.zeros(2, 3, device=cuda_device),
                               maps.float())
    with pytest.raises(ValueError):
        lookup_blocks_cuda(torch.zeros(1, 2, 4, device=cuda_device),
                           torch.zeros(1, 2, 8, device=cuda_device), 4)
    a = torch.zeros(2, 3, device=cuda_device)
    with pytest.raises(ValueError):
        tap.allpole_const_adjoint_cuda(x, torch.zeros(2, 7,
                                                      device=cuda_device), a)
    with pytest.raises(ValueError):
        tap.allpole_const_adjoint_cuda(x, x, torch.zeros(
            2, tap.MAX_ORDER + 1, device=cuda_device))
    with pytest.raises(ValueError):
        tap.allpole_const_adjoint_cuda(x, x.cpu(), a)
    with pytest.raises(TypeError):
        tap.allpole_const_adjoint_cuda(x, x.double(), a)
    with pytest.raises(NotImplementedError):
        tap.allpole_const_cuda(x.requires_grad_(), a)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,p", [(4, 2400, 22), (1, 2400, 22), (2, 300, 22),
                                   (2, 700, 5), (3, 1500, 40)])
def test_cuda_allpole_zi_entry(cuda_device, b, t, p):
    """B4's forward entry from a random initial state, at ``chunk_for``'s
    chunk length (64 at a push's (4 | 1, 2400)) over several chunks:
    against its plain version (golf_tpu's streaming form, 1e-4 of max|y|),
    against a float64 scan from the same state (1e-5), against
    ``allpole_chunked_plain`` from it (1e-5), and with a null state bit for
    bit equal to a zero state."""
    rng = np.random.default_rng(b * t + p)
    x = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32))
    a = rc2lpc(torch.tanh(torch.from_numpy(
        0.2 * rng.standard_normal((b, t, p)).astype(np.float32))))
    zi = torch.from_numpy(rng.standard_normal((b, p)).astype(np.float32))
    x, a, zi = (v.contiguous().to(cuda_device) for v in (x, a, zi))
    y = tap.allpole_cuda(x, a, zi)
    torch.cuda.synchronize()
    ref64 = tap.allpole_scan(x.double(), a.double(), zi.double())
    scale = ref64.abs().max()
    assert ((y.double() - ref64).abs().max() / scale).item() <= 1e-5
    plain = tap.allpole_stream_plain(x, a, zi)
    assert ((y - plain).abs().max() / plain.abs().max()).item() <= 1e-4
    mirror = tap.allpole_chunked_plain(x, a, zi=zi)
    assert ((y - mirror).abs().max() / mirror.abs().max()).item() <= 1e-5
    assert torch.equal(tap.allpole_cuda(x, a),
                       tap.allpole_cuda(x, a, torch.zeros_like(zi)))
    with pytest.raises(ValueError):
        tap.allpole_cuda(x, a, zi[:, :-1].contiguous())


@pytest.mark.cuda
def test_cuda_stream_matches_cpu(cuda_device):
    """One GOLFStream of a small GOLF-ss decoder (lpc 8, 128 table points,
    room filter of 32, random weights) on the card against the same stream
    on the CPU, same ctrl and noise: within 1e-4 of max|y| (B4 chunked in
    float64 against the float32 blocked form; cuFFT against pocketfft).
    The stream launches B1 and B4 once an emitted chunk."""
    import copy

    from golf_tpu_torch import kernels
    from golf_tpu_torch.core.sig import Sig
    from golf_tpu_torch.models.filters import (LTIAcousticFilter,
                                               LTVMinimumPhaseFilterPrecise,
                                               LTVZeroPhaseFIRFilter)
    from golf_tpu_torch.models.noise import StandardNormalNoise
    from golf_tpu_torch.models.sf import SourceFilterSynth
    from golf_tpu_torch.models.synth import \
        DownsampledIndexedGlottalFlowTable
    from golf_tpu_torch.serve import GOLFStream, chunk_ctrl

    torch.manual_seed(0)
    dec = SourceFilterSynth(
        harm_oscillator=DownsampledIndexedGlottalFlowTable(
            hop_rate=10, in_channels=16, oversampling=4, equal_energy=True,
            lf_v2=True, points=128, table_size=16),
        noise_generator=StandardNormalNoise(),
        noise_filter=LTVZeroPhaseFIRFilter(window="hanning", n_mag=33),
        end_filter=LTVMinimumPhaseFilterPrecise(lpc_order=8),
        room_filter=LTIAcousticFilter(length=32), subtract_harmonics=False)
    with torch.no_grad():
        dec.room_filter.kernel.normal_(0, 0.05)
    chunk, n, b, hop = 2400, 6, 2, 240
    rng = np.random.default_rng(0)
    frames = n * chunk // hop

    def t(shape, scale, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                                .astype(np.float32))
    raw = {"harm_oscillator_params": (Sig(t((b, frames, 16), 0.1), hop),),
           "noise_filter_params": (Sig(t((b, frames, 33), 0.1, -3.0), hop),),
           "end_filter_params": (Sig(t((b, frames), 0.1), hop),
                                 Sig(t((b, frames, 8), 0.3), hop))}
    f0 = 150.0 + 60.0 * np.sin(np.linspace(0, 9.0, n * chunk))
    phase = torch.from_numpy(np.tile(f0 / 24000.0, (b, 1)).astype(np.float32))
    noise = t((b, n * chunk), 0.03)
    with torch.no_grad():
        ctrl = dec.apply_ctrl(raw)
    outs = {}
    for dev in ("cpu", "cuda"):
        d = copy.deepcopy(dec).to(dev)
        stream = GOLFStream(d, chunk=chunk)
        kernels.LOOKUP.launches = kernels.ALLPOLE_TV.launches = 0
        got = []
        for c in range(n):
            sl = slice(c * chunk, (c + 1) * chunk)
            out = stream.push(chunk_ctrl(ctrl, c, chunk), phase[:, sl],
                              noise[:, sl])
            if out is not None:
                assert out.device.type == dev
                got.append(out.cpu())
        got.append(stream.flush(chunk_ctrl(ctrl, n, chunk, rest=True)).cpu())
        outs[dev] = torch.cat(got, dim=1)
        if dev == "cuda":
            assert kernels.LOOKUP.launches == n
            assert kernels.ALLPOLE_TV.launches == n
    ref = outs["cpu"]
    assert ((outs["cuda"] - ref).abs().max() / ref.abs().max()).item() <= 1e-4


@pytest.mark.cuda
def test_cuda_wrapped_cumsum_error_does_not_grow(cuda_device):
    """The oscillator's wrapped phase over 6 s at the 4x oversampled rate
    (576 000 increments of 100-350 Hz at 96 kHz) on the card, against a
    float64 cumsum mod 1: within 4e-6 cycles. With float32 block sums the
    card's rounding entered every later block's offset (3.5e-5 cycles)."""
    from golf_tpu_torch.ops.dsp import wrapped_cumsum
    rng = np.random.default_rng(0)
    inc = (rng.uniform(100, 350, (2, 576_000)) / 96_000).astype(np.float32)
    got = wrapped_cumsum(torch.from_numpy(inc).to(cuda_device)).double().cpu()
    ref = torch.remainder(torch.cumsum(torch.from_numpy(inc).double(), 1), 1)
    d = (got - ref).abs()
    assert torch.minimum(d, 1 - d).max().item() <= 4e-6


@pytest.mark.cuda
def test_cuda_phase_increments_equal_the_cpus(cuda_device):
    """f0 / sample_rate on the card, as ``phase_from_f0`` and the training
    step's ``prepare_training`` form it, and the oscillator's 4x oversampled
    increments, equal the CPU's bit for bit at (4, 144 000): a true
    division on both devices (a product with float32's 1/24000 gave 12% of
    the oversampled increments another value)."""
    from golf_tpu_torch.config.registry import load_config
    from golf_tpu_torch.core.sig import Sig
    from golf_tpu_torch.tasks.ae import build_voice_autoencoder

    cfg = load_config(["cfg/ae/synthetic.yaml"], "cfg/ae/decoder/golf.yaml")
    torch.manual_seed(0)
    cpu_task = build_voice_autoencoder(cfg["model"]["init_args"],
                                       device="cpu")
    card_task = build_voice_autoencoder(cfg["model"]["init_args"],
                                        device="cpu")
    card_task.load_state_dict(cpu_task.state_dict())
    card_task.to(cuda_device)
    rng = np.random.default_rng(0)
    f0 = rng.uniform(60.0, 500.0, (4, 144_000)).astype(np.float32)
    f0[:, 1000:3000] = 0.0
    x = (0.1 * rng.standard_normal((4, 144_000))).astype(np.float32)
    random_f0 = torch.tensor([[90.0], [310.0], [55.5], [499.0]])
    phases = {}
    for dev, task in (("cpu", cpu_task), ("cuda", card_task)):
        xs = Sig(torch.from_numpy(x).to(dev), 1)
        f0s = Sig(torch.from_numpy(f0).to(dev), 1)
        task.eval()
        with torch.no_grad():
            served = task.phase_from_f0(f0s).data
            task.train()
            params, _, _ = task.prepare_training(
                xs, f0s, random_f0=random_f0.to(dev))
        up = Sig(served / 4, 4).reduce_hop_length().data
        phases[dev] = [t.cpu() for t in (served, params["phase"].data, up)]
    for got, ref in zip(phases["cuda"], phases["cpu"]):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_wrapped_cumsum_cotangent_within_the_cpus_error(cuda_device):
    """``wrapped_cumsum``'s cotangent, the reversed cumsum of g, at the
    training step's oversampled length (64, 192 000): on the card no
    further from a float64 reversed cumsum than the CPU's (both accumulate
    in float64 and round once a sample; a float32 accumulation on the card
    drifted by orders of magnitude more)."""
    from golf_tpu_torch.ops.dsp import wrapped_cumsum
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal((64, 192_000))
                         .astype(np.float32))
    x = torch.from_numpy(rng.uniform(0.001, 0.005, (64, 192_000))
                         .astype(np.float32))
    ref = torch.flip(torch.cumsum(torch.flip(g, (1,)).double(), 1), (1,))
    errs = {}
    for dev in ("cpu", cuda_device):
        xd = x.to(dev).requires_grad_()
        (dx,) = torch.autograd.grad(wrapped_cumsum(xd), xd, g.to(dev))
        errs[str(dev)] = (dx.cpu().double() - ref).abs().max().item()
    assert errs["cuda"] <= errs["cpu"] * (1 + 1e-6), errs


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "amsgrad"])
def test_cuda_optimizer_step_equals_the_cpus(cuda_device, optimizer):
    """Two steps of ``ClippedOptimizer`` (the first clipped) on the card
    against the CPU: within 1e-6 of max|param| (foreach kernels in fp32,
    the same operations)."""
    from golf_tpu_torch.train.loop import ClippedOptimizer
    rng = np.random.default_rng(3)
    shapes = [(64, 33), (7,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * scale
              for s in shapes] for scale in (2.0, 0.01)]
    out = {}
    for dev in ("cpu", cuda_device):
        params = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(dev))
                  for p in p0]
        opt = ClippedOptimizer(params, lr=0.01, grad_clip=0.5,
                               optimizer=optimizer, lr_decay=0.5)
        for g in grads:
            for p, a in zip(params, g):
                p.grad = torch.from_numpy(a.copy()).to(dev)
            opt.step()
        out[str(dev)] = [p.detach().cpu() for p in params]
    scale = max(p.abs().max().item() for p in out["cpu"])
    for got, ref in zip(out["cuda"], out["cpu"]):
        assert (got - ref).abs().max().item() <= 1e-6 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,p,scale", [
    (4, 512 * 3, 22, 0.2), (2, 512 * 24, 22, 0.2), (3, 1234, 22, 0.2),
    (2, 512, 22, 0.2), (2, 700, 5, 0.2), (2, 1500, 40, 0.2),
    (2, 1500, 64, 0.1)])
def test_cuda_allpole_summary_entry(cuda_device, b, t, p, scale):
    """The summary entry (the affine end-state map of each row, float64) at
    T a multiple of the chunk and at ragged lengths, its tree in one round
    and in two (24 chunks of 64 at p = 64, which takes 4 maps a group;
    there the coefficients' scale is 0.1: at 0.2 M outgrows float32, which
    the float32 plain version needs): against a float64 run of its plain
    version (golf_tpu's
    ``_local_affine_summary``; 1e-9 of max|ref|), against its tree mirror
    (``allpole_summary_chunked_plain``, maps too; 1e-9) and against the
    float32 plain version (1e-3: that form's own error); its map then
    carries a random state to the filter's end state, within 1e-5 of a
    float64 scan; the re-run entry from its maps equals the zi entry bit
    for bit."""
    rng = np.random.default_rng(b * t + p)
    x = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32))
    a = rc2lpc(torch.tanh(torch.from_numpy(
        scale * rng.standard_normal((b, t, p)).astype(np.float32))))
    x, a = x.contiguous().to(cuda_device), a.contiguous().to(cuda_device)
    m, v, maps = tap.allpole_summary_cuda(x, a)
    assert m.dtype == torch.float64 and m.shape == (b, p, p)
    assert v.shape == (b, p)
    m64, v64 = tap.allpole_summary_plain(x.double(), a.double())
    mt, vt, maps_t = tap.allpole_summary_chunked_plain(x, a)
    assert maps.shape == maps_t.shape
    # over many steps M decays below float64's range: a floor of 1e-30
    # keeps 0 / 0 out
    for got, ref in ((m, m64), (v, v64), (m, mt), (v, vt), (maps, maps_t)):
        assert ((got - ref).abs().max()
                / ref.abs().max().clamp_min(1e-30)).item() <= 1e-9
    # over hundreds of steps of a low-order filter M decays below float32's
    # range: the float32 form holds zeros there, hence the floor
    m32, v32 = tap.allpole_summary_plain(x, a)
    for got, ref in ((m, m32), (v, v32)):
        assert (got - ref.double()).abs().max().item() <= \
            1e-3 * ref.abs().max().item() + 1e-30
    zi = torch.from_numpy(rng.standard_normal((b, p))).to(cuda_device)
    y = tap.allpole_scan(x.double(), a.double(), zi)
    end = torch.flip(y[:, -p:], (1,))
    got = torch.einsum("bij,bj->bi", m, zi) + v
    assert ((got - end).abs().max() / end.abs().max()).item() <= 1e-5
    zi32 = zi.float().contiguous()
    assert torch.equal(tap.allpole_rerun_cuda(x, a, zi32, maps),
                       tap.allpole_cuda(x, a, zi32))
    launches = tap.ALLPOLE_TV_SUMMARY.launches
    tap.allpole_summary_cuda(x, a)
    assert tap.ALLPOLE_TV_SUMMARY.launches == launches + 1


# P1's shapes (B, Cin, Cout, F, T, s): the recipe's four stages at B = 4
# (cfg/ae/vctk.yaml: 513 bins, 200 frames of 2 s), synthetic.yaml's two,
# and a ragged case (channels not a multiple of the tile, odd F and T,
# s = 2)
PYRAMID_SHAPES = [(4, 1, 32, 513, 200, 4), (4, 32, 64, 128, 200, 4),
                  (4, 64, 128, 32, 200, 4), (4, 128, 256, 8, 200, 4),
                  (4, 1, 8, 513, 200, 4), (4, 8, 16, 128, 200, 4),
                  (3, 5, 24, 37, 50, 2)]


def _pyramid_stage(rng, cin, cout, s, device):
    """A conv and an eval-mode batch norm with seeded parameters and
    running statistics; some of the norm's scales negative, so that the
    pool must follow the norm."""
    from torch import nn
    conv = nn.Conv2d(cin, cout, (2 * s + 1, 3), padding=(s, 1))
    norm = nn.BatchNorm2d(cout, eps=1e-5)
    scale = 1 / np.sqrt(cin * 3 * (2 * s + 1))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(scale * rng.standard_normal(
            conv.weight.shape).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(
            cout).astype(np.float32)))
        norm.running_mean.copy_(torch.from_numpy(0.2 * rng.standard_normal(
            cout).astype(np.float32)))
        norm.running_var.copy_(torch.from_numpy(rng.uniform(
            0.5, 2.0, cout).astype(np.float32)))
        norm.weight.copy_(torch.from_numpy(rng.standard_normal(
            cout).astype(np.float32)))
        norm.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(
            cout).astype(np.float32)))
    return conv.to(device).eval(), norm.to(device).eval()


def _stage_eval64(x, conv, norm, s):
    from golf_tpu_torch.ops import pyramid as pyr
    y = torch.nn.functional.conv2d(x.double(), conv.weight.double(),
                                   conv.bias.double(), padding=(s, 1))
    y = torch.nn.functional.batch_norm(
        y, norm.running_mean.double(), norm.running_var.double(),
        norm.weight.double(), norm.bias.double(), False, 0.0, norm.eps)
    return pyr.strided_max(torch.relu(y), s, axis=2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cout,f,t,s", PYRAMID_SHAPES)
def test_cuda_pyramid_conv_within_cudnn_error(cuda_device, b, cin, cout, f,
                                              t, s):
    """Both P1 entries against their plain versions: the kernel's max-abs
    error from a float64 ``F.conv2d`` (and the float64 stage) is at most
    1.5x cuDNN's fp32 error on the same inputs, TF32 off. The kernel sums
    the same products in fp32 in another order than cuDNN (a fixed chain
    an input channel over kernel row and column, those partial sums
    chained over input channels), so neither is exact; 1.5x leaves room
    for the orders' differing luck.
    A second run is bit for bit the first (no atomics, no split sum)."""
    from golf_tpu_torch.ops import pyramid as pyr
    rng = np.random.default_rng(cin * 1000 + cout + f + t)
    conv, norm = _pyramid_stage(rng, cin, cout, s, cuda_device)
    x = torch.from_numpy(rng.standard_normal((b, cin, f, t)).astype(
        np.float32)).to(cuda_device)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        y = pyr.pyramid_conv_cuda(x, conv.weight, conv.bias)
        lib = pyr.pyramid_conv_plain(x, conv.weight, conv.bias)
        ref = torch.nn.functional.conv2d(x.double(), conv.weight.double(),
                                         conv.bias.double(), padding=(s, 1))
        ye = pyr.pyramid_stage_eval_cuda(x, conv, norm, s)
        lib_e = pyr.pyramid_stage_eval_plain(x, conv, norm, s)
        ref_e = _stage_eval64(x, conv, norm, s)
        assert y.shape == ref.shape and ye.shape == ref_e.shape
        for got, plain, r in ((y, lib, ref), (ye, lib_e, ref_e)):
            err = (got.double() - r).abs().max().item()
            lib_err = (plain.double() - r).abs().max().item()
            assert err <= 1.5 * lib_err, (err, lib_err)
        assert torch.equal(y, pyr.pyramid_conv_cuda(x, conv.weight,
                                                    conv.bias))
        assert torch.equal(ye, pyr.pyramid_stage_eval_cuda(x, conv, norm, s))


@pytest.mark.cuda
def test_cuda_pyramid_conv_keeps_nan(cuda_device):
    """A NaN in the input reaches the same outputs as in the plain chain
    (conv, batch norm, ReLU and max-pool all keep a NaN), for both
    entries: the plain versions in float64 on the CPU, whose direct
    convolution spreads a NaN only over its receptive field."""
    import copy
    from golf_tpu_torch.ops import pyramid as pyr
    s = 4
    rng = np.random.default_rng(5)
    conv, norm = _pyramid_stage(rng, 8, 16, s, cuda_device)
    x = torch.from_numpy(rng.standard_normal((2, 8, 64, 30)).astype(
        np.float32))
    x[1, 3, 20, 7] = float("nan")
    conv64, norm64 = (copy.deepcopy(m).cpu().double() for m in (conv, norm))
    with torch.no_grad():
        y = pyr.pyramid_conv_cuda(x.to(cuda_device), conv.weight,
                                  conv.bias).cpu()
        ye = pyr.pyramid_stage_eval_cuda(x.to(cuda_device), conv, norm,
                                         s).cpu()
        ref = pyr.pyramid_conv_plain(x.double(), conv64.weight, conv64.bias)
        ref_e = pyr.pyramid_stage_eval_plain(x.double(), conv64, norm64, s)
    for got, r in ((y, ref), (ye, ref_e)):
        nan = torch.isnan(r)
        assert nan.any() and not nan.all()
        assert torch.equal(torch.isnan(got), nan)
        assert (got.double()[~nan] - r[~nan]).abs().max().item() <= \
            1e-5 * r[~nan].abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("x_grad", [True, False])
def test_cuda_pyramid_conv_gradients_equal_conv2d(cuda_device, x_grad):
    """``pyramid_conv``'s backward is ``F.conv2d``'s: the input, weight and
    bias gradients bit for bit, under cuDNN's deterministic algorithms
    (the forward differs by rounding, the backward is the same call)."""
    from golf_tpu_torch.ops import pyramid as pyr
    rng = np.random.default_rng(11)
    conv, _ = _pyramid_stage(rng, 8, 16, 4, cuda_device)
    x = torch.from_numpy(rng.standard_normal((3, 8, 64, 50)).astype(
        np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((3, 16, 64, 50)).astype(
        np.float32)).to(cuda_device)
    grads = []
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False, allow_tf32=False):
        for fn in (pyr.pyramid_conv,
                   lambda a, w, b: torch.nn.functional.conv2d(
                       a, w, b, padding=(4, 1))):
            xi = x.clone().requires_grad_(x_grad)
            w = conv.weight.detach().clone().requires_grad_()
            b = conv.bias.detach().clone().requires_grad_()
            fn(xi, w, b).backward(g)
            grads.append([xi.grad, w.grad, b.grad])
    for got, ref in zip(*grads):
        if ref is None:
            assert got is None
        else:
            assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_conv_pyramid_launches_by_mode(cuda_device):
    """``ConvPyramid`` in fp32 on the card: the eval entry once a stage in
    eval mode under no_grad, the bias-only entry once a stage otherwise
    (train mode; eval with gradients on); no F.conv2d forward."""
    from golf_tpu_torch import kernels
    from golf_tpu_torch.models.unet import ConvPyramid
    pyr = ConvPyramid(1, (8, 16), (4, 4)).to(cuda_device)
    x = torch.randn(2, 1, 513, 40, device=cuda_device)
    conv, ev = kernels.PYRAMID_CONV, kernels.PYRAMID_CONV_EVAL

    def launches(fn):
        before = (conv.launches, ev.launches)
        fn()
        return conv.launches - before[0], ev.launches - before[1]

    assert launches(lambda: pyr(x).sum().backward()) == (2, 0)
    pyr.eval()
    with torch.no_grad():
        assert launches(lambda: pyr(x)) == (0, 2)
        fused = pyr(x)
    assert launches(lambda: pyr(x)) == (2, 0)
    assert (pyr(x) - fused).abs().max().item() <= 1e-5 * \
        fused.abs().max().item()


@pytest.mark.cuda
def test_cuda_pyramid_wrappers_refuse_bad_inputs(cuda_device):
    from golf_tpu_torch.ops import pyramid as pyr
    w = torch.zeros(4, 2, 9, 3, device=cuda_device)
    b = torch.zeros(4, device=cuda_device)
    x = torch.zeros(1, 2, 16, 10, device=cuda_device)
    with pytest.raises(ValueError):
        pyr.pyramid_conv_cuda(x.cpu(), w, b)
    with pytest.raises(TypeError):
        pyr.pyramid_conv_cuda(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        pyr.pyramid_conv_cuda(x.transpose(2, 3), w, b)
    with pytest.raises(ValueError):
        pyr.pyramid_conv_cuda(x, torch.zeros(4, 2, 11, 3,
                                             device=cuda_device), b)
