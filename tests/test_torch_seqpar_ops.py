"""The port's time-sharded primitives (``golf_tpu_torch.parallel.seqpar``)
against golf_tpu's own functions under ``shard_map`` on 2 of the conftest's
8 CPU devices, on the CPU.

The port's side runs once on 2 spawned gloo ranks (``run_ranks`` of
``test_torch_parallel_dp.py``) and returns every primitive's local output;
the tests hold them, concatenated along time, against golf_tpu's:

* the halos, ``global_flip`` and ``global_cumsum``: equal (1e-6 relative
  for the float64-accumulated cumsum);
* ``global_wrapped_cumsum`` bit for bit against the port's own
  ``wrapped_cumsum`` of the whole signal, its backward within 1e-6 of the
  reversed cumsum's;
* the summary's plain version against ``_local_affine_summary``: both
  float32 runs against a float64 one, the port's within twice golf_tpu's
  distance; the summary entry's tree mirror against it in float64, and on
  resonant filters no further from a float64 scan than golf_tpu's float32
  run;
* ``allpole_sharded`` at order 22, forward and gradients, against
  golf_tpu's unsharded ``allpole`` on a shorter version of
  ``tests/test_seqpar.py``'s order-22 case, with its limits (1e-3, 2e-3);
* ``parallel.timeshard.allpole_timesharded`` on global tensors, the same;
* ``fir_frame_conv_sharded``, ``decimate_sharded``, ``frame_ola_sharded``
  (with B2's plain version per frame) and ``sss_loss_sharded`` against
  golf_tpu's sharded functions (2e-4 of max|ref|; the loss 1e-5 relative),
  and the loss's gradient against the port's unsharded ``SSSLoss`` on the
  valid prefix (1e-4 of max|ref|).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_parallel_dp import run_ranks

torch.set_num_threads(1)

B, T, HOP, P_ORD = 2, 2 * 4800, 240, 22
N_FFT = 509
VALID = T - 239


def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T)).astype(np.float32)
    y = rng.standard_normal((B, T)).astype(np.float32)
    ph = (rng.random((B, T)) * 0.02).astype(np.float32)
    frames = T // HOP + 1
    rc = np.tanh(rng.standard_normal((B, frames, P_ORD)) * 0.25)
    up = np.stack([np.stack(
        [np.interp(np.arange(T) / HOP, np.arange(frames), rc[bi, :, j])
         for j in range(P_ORD)], -1) for bi in range(B)])
    from golf_tpu_torch.ops.dsp import rc2lpc
    a = rc2lpc(torch.from_numpy(up.astype(np.float32))).numpy()
    w = rng.standard_normal((B, T)).astype(np.float32)
    kern = (rng.standard_normal((B, T // HOP, 65)) * 0.1).astype(np.float32)
    a_ff = rc2lpc(torch.from_numpy(np.tanh(rng.standard_normal(
        (B, T // HOP, 8)) * 0.3).astype(np.float32))).numpy()
    return dict(x=x, y=y, ph=ph, a=a, w=w, kern=kern, a_ff=a_ff)


def ops_worker(rank, d):
    from golf_tpu_torch.ops.allpole import allpole_const
    from golf_tpu_torch.parallel import collectives
    from golf_tpu_torch.parallel import seqpar as sp
    env = sp.SeqParEnv(n_time=2, t_global=T, b_global=B, time_index=rank)
    tl = T // 2
    loc = {k: torch.from_numpy(v[:, rank * tl:(rank + 1) * tl].copy())
           for k, v in d.items() if k in ("x", "y", "ph", "a", "w")}
    out = {}
    x = loc["x"]
    out["halo_left"] = sp.halo_left(x, 5, env)
    out["halo_right"] = sp.halo_right(x, 7, env)
    out["flip"] = sp.global_flip(x, env)
    out["cumsum"] = sp.global_cumsum(x, env)
    from golf_tpu_torch.core.sig import Sig
    gathered = sp.gather_sig(Sig(x, 1), env)
    rows_env = sp.SeqParEnv(n_time=1, t_global=T, b_global=B, n_data=2,
                            data_index=rank)
    rows = sp.slice_global_rows(torch.from_numpy(d["x"]), rows_env)
    ph = loc["ph"].requires_grad_()
    wc = sp.global_wrapped_cumsum(ph, env)
    (wc * loc["w"]).sum().backward()
    out["wrapped"], out["wrapped_grad"] = wc, ph.grad
    xr = loc["x"].clone().requires_grad_()
    ar = loc["a"].clone().requires_grad_()
    yr = sp.allpole_sharded(xr, ar, env)
    # a psum'd loss is replicated: each rank backpropagates its share
    (collectives.psum((yr * loc["w"]).sum()) / 2).backward()
    out["allpole"], out["allpole_gx"], out["allpole_ga"] = yr, xr.grad, ar.grad
    kl = torch.from_numpy(d["kern"][:, rank * tl // HOP:
                                    (rank + 1) * tl // HOP].copy())
    out["fir"] = sp.fir_frame_conv_sharded(x, kl, HOP, 32, True, env)
    out["decimate"] = sp.decimate_sharded(x, 4, env)
    a_l = torch.from_numpy(d["a_ff"][:, rank * tl // HOP:
                                     (rank + 1) * tl // HOP].copy())

    def per_frame(fr):
        b, f, w = fr.shape
        return allpole_const(fr.reshape(-1, w).contiguous(),
                             a_l.reshape(-1, 8)).reshape(b, f, w)

    from golf_tpu_torch.ops.dsp import get_window_fn
    out["ola"] = sp.frame_ola_sharded(per_frame, x, get_window_fn(
        "hanning")(960), HOP, env)
    pred = loc["x"].clone().requires_grad_()
    env.valid_len = VALID
    loss = sp.sss_loss_sharded(pred, loc["y"], N_FFT, N_FFT // 4, 1.0,
                               "hanning", 1e-8, env)
    (loss / 2).backward()
    out["sss"], out["sss_grad"] = loss, pred.grad
    # parallel.timeshard: the same filter as one op on global tensors
    from golf_tpu_torch.parallel.mesh import make_mesh
    from golf_tpu_torch.parallel.timeshard import allpole_timesharded
    xg = torch.from_numpy(d["x"]).requires_grad_()
    ag = torch.from_numpy(d["a"]).requires_grad_()
    yg = allpole_timesharded(xg, ag, make_mesh(1, 2))
    (yg * torch.from_numpy(d["w"])).sum().backward()
    res = {k: v.detach().numpy() for k, v in out.items()}
    res["timeshard"] = [t.detach().numpy() for t in (yg, xg.grad, ag.grad)]
    res["gathered"] = [gathered.data.numpy(), rows.numpy()]
    from golf_tpu_torch.parallel import multihost
    pod = multihost.make_pod_mesh(nodes=1, time=2)
    multihost.sync_global_devices("ops")
    res["multihost"] = {
        "pod": pod.ranks.tolist(), "main": multihost.is_main_process(),
        "bcast": multihost.broadcast_one_to_all({"rank": rank, "v": [1.5]})}
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = inputs()
    outs = run_ranks(2, tmp_path_factory.mktemp("store"), ops_worker, d)
    cat = {k: np.concatenate([o[k] for o in outs], axis=1)
           for k in outs[0] if k not in ("timeshard", "gathered", "multihost")
           and outs[0][k].ndim >= 2}
    cat["multihost"] = [o["multihost"] for o in outs]
    cat["timeshard"] = [o["timeshard"] for o in outs]
    cat["gathered"] = [o["gathered"] for o in outs]
    cat["sss"] = [float(o["sss"]) for o in outs]
    return d, cat


@pytest.fixture(scope="module")
def golf():
    """golf_tpu's sharded functions under shard_map on 2 CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from golf_tpu.ops.allpole import allpole, allpole_const
    from golf_tpu.ops.dsp import get_window_fn
    from golf_tpu.parallel import seqpar as js
    from golf_tpu.parallel.mesh import make_mesh

    d = inputs()
    mesh = make_mesh(data=1, time=2, devices=jax.devices()[:2])
    env = lambda: js.SeqParEnv("time", 2, T, B, None, 1)   # noqa: E731
    pt = P(None, "time")

    def run(fn, *args, out=pt):
        return np.asarray(jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(pt,) * len(args), out_specs=out,
            check_vma=False))(*[jnp.asarray(a) for a in args]))

    x = d["x"]
    ref = {
        "halo_left": run(lambda v: js.halo_left(v, 5, env()), x),
        "halo_right": run(lambda v: js.halo_right(v, 7, env()), x),
        "flip": run(lambda v: js.global_flip(v, env()), x),
        "cumsum": run(lambda v: js.global_cumsum(v, env()), x),
        "fir": run(lambda v, k: js.fir_frame_conv_sharded(
            v, k, HOP, 32, True, env()), x, d["kern"]),
        "decimate": run(lambda v: js.decimate_sharded(v, 4, env()), x),
    }

    def ola(v, a_l):
        def per_frame(fr):
            b, f, w = fr.shape
            return allpole_const(fr.reshape(-1, w),
                                 a_l.reshape(-1, 8)).reshape(b, f, w)
        return js.frame_ola_sharded(per_frame, v, np.asarray(
            get_window_fn("hanning")(960)), HOP, env())

    ref["ola"] = run(ola, x, d["a_ff"])

    def sss(p_, t_):
        e = env()
        e.valid_len = VALID
        return js.sss_loss_sharded(p_, t_, N_FFT, N_FFT // 4, 1.0,
                                   "hanning", 1e-8, e)

    ref["sss"] = float(run(sss, x, d["y"], out=P()))
    xa, aa, wa = (jnp.asarray(d[k]) for k in ("x", "a", "w"))
    ref["allpole"] = np.asarray(jax.jit(allpole)(xa, aa))
    gx, ga = jax.jit(jax.grad(lambda u, v: jnp.sum(allpole(u, v) * wa),
                              argnums=(0, 1)))(xa, aa)
    ref["allpole_gx"], ref["allpole_ga"] = np.asarray(gx), np.asarray(ga)
    return ref


def rel(got, ref):
    return np.abs(np.asarray(got) - ref).max() / (np.abs(ref).max() + 1e-30)


@pytest.mark.parametrize("name", ["halo_left", "halo_right", "flip"])
def test_halos_and_flip_match_golf_tpu(port, golf, name):
    np.testing.assert_array_equal(port[1][name], golf[name])


def test_global_cumsum_matches_golf_tpu(port, golf):
    assert rel(port[1]["cumsum"], golf["cumsum"]) <= 1e-6


def test_global_wrapped_cumsum_bit_for_bit(port):
    """Equal bit for bit to the port's ``wrapped_cumsum`` of the gathered
    signal; its backward (the reversed global cumsum) within 1e-6 of the
    unsharded adjoint's."""
    from golf_tpu_torch.ops.dsp import wrapped_cumsum
    d, got = port
    ph = torch.from_numpy(d["ph"]).requires_grad_()
    ref = wrapped_cumsum(ph)
    (ref * torch.from_numpy(d["w"])).sum().backward()
    np.testing.assert_array_equal(got["wrapped"], ref.detach().numpy())
    assert rel(got["wrapped_grad"], ph.grad.numpy()) <= 1e-6


@pytest.mark.parametrize("t", [600, 997])
def test_summary_plain_matches_golf_tpu(t):
    """``allpole_summary_plain`` against ``_local_affine_summary`` at a
    length with a divisor block and at a prime one (sequential): both in
    float32, each held against the plain version's float64 run, the port
    within twice golf_tpu's own distance (plus 1e-7)."""
    import jax
    import jax.numpy as jnp
    from golf_tpu.parallel.seqpar import _local_affine_summary
    from golf_tpu_torch.ops.allpole import allpole_summary_plain
    d = inputs()
    x = torch.from_numpy(d["x"][:, :t].copy())
    a = torch.from_numpy(d["a"][:, :t].copy())
    got_j = jax.jit(lambda u, v: _local_affine_summary(u, v, 0))(
        jnp.asarray(x.numpy()), jnp.asarray(a.numpy()))
    got_t = allpole_summary_plain(x, a)
    ref64 = allpole_summary_plain(x.double(), a.double())
    for j, tt, r in zip(got_j, got_t, ref64):
        r = r.numpy()
        assert rel(tt.numpy(), r) <= 2 * rel(np.asarray(j), r) + 1e-7


# (T, p, chunk): several groups of the tree with a ragged last chunk, one
# group, an order whose tree takes 8 maps a group, and chunk_for's length at
# a push (64: 38 chunks, three groups)
TREE_CASES = [(600, 22, 64), (1000, 22, 128), (1300, 40, 64), (2400, 22, 64)]


@pytest.mark.parametrize("t,p,chunk", TREE_CASES)
def test_summary_tree_mirror_matches_golf_tpu_float64(t, p, chunk):
    """The summary entry's plain mirror (every chunk's map, composed as the
    kernel's tree) against golf_tpu's ``_local_affine_summary``, both in
    float64, at the model's scale: 1e-9 of max|ref| (the same products in
    another order; measured 1e-13 and below)."""
    import jax
    import jax.numpy as jnp
    from golf_tpu.parallel.seqpar import _local_affine_summary
    from golf_tpu_torch.ops.allpole import allpole_summary_chunked_plain
    from golf_tpu_torch.ops.dsp import rc2lpc
    rng = np.random.default_rng(t + p)
    x = rng.standard_normal((B, t))
    a = rc2lpc(torch.tanh(torch.from_numpy(
        0.2 * rng.standard_normal((B, t, p))))).numpy()
    with jax.enable_x64(True):
        ref = jax.jit(lambda u, v: _local_affine_summary(u, v, 0))(
            jnp.asarray(x), jnp.asarray(a))
        ref = [np.asarray(r) for r in ref]
    assert ref[0].dtype == np.float64
    m, v, maps = allpole_summary_chunked_plain(
        torch.from_numpy(x), torch.from_numpy(a), chunk)
    assert maps.shape == (B, -(-t // chunk), p + 1, p)
    for got, r in zip((m, v), ref):
        assert rel(got.numpy(), r) <= 1e-9


@pytest.mark.parametrize("cap,seed", [(0.95, 0), (0.95, 1), (None, 2)])
def test_summary_tree_mirror_on_resonant_filters(cap, seed):
    """On resonant filters (``resonant_inputs``) the tree mirror's map,
    applied to a state, lands no further from a float64 scan's end state
    than golf_tpu's float32 ``_local_affine_summary`` does."""
    import jax
    import jax.numpy as jnp
    from golf_tpu.parallel.seqpar import _local_affine_summary
    from golf_tpu_torch.ops.allpole import (allpole_scan,
                                            allpole_summary_chunked_plain,
                                            resonant_inputs)
    x, a = resonant_inputs(seed, b=2, t=1200, cap=cap)
    zi = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 22)))
    end = torch.flip(allpole_scan(x.double(), a.double(), zi)[:, -22:],
                     (1,)).numpy()

    def err(m, v):
        got = np.einsum("bij,bj->bi", np.asarray(m, np.float64),
                        zi.numpy()) + np.asarray(v, np.float64)
        return rel(got, end)

    m32, v32 = jax.jit(lambda u, w: _local_affine_summary(u, w, 0))(
        jnp.asarray(x.numpy()), jnp.asarray(a.numpy()))
    m, v, _ = allpole_summary_chunked_plain(x, a, 64)
    assert np.isfinite(end).all()
    assert err(m, v) <= err(m32, v32)


@pytest.mark.parametrize("name,tol", [("allpole", 1e-3),
                                      ("allpole_gx", 2e-3),
                                      ("allpole_ga", 2e-3)])
def test_allpole_sharded_order22_matches_golf_tpu(port, golf, name, tol):
    assert rel(port[1][name], golf[name]) < tol


@pytest.mark.parametrize("name", ["fir", "decimate", "ola"])
def test_framed_ops_match_golf_tpu(port, golf, name):
    assert port[1][name].shape == golf[name].shape
    assert rel(port[1][name], golf[name]) <= 2e-4


def test_sss_loss_sharded_matches_golf_tpu(port, golf):
    """The same value on both ranks, golf_tpu's within 1e-5 relative; the
    gradient equals the unsharded ``SSSLoss``'s on the valid prefix."""
    from golf_tpu_torch.loss.spec import SSSLoss
    d, got = port
    assert got["sss"][0] == got["sss"][1]
    assert abs(got["sss"][0] - golf["sss"]) <= 1e-5 * abs(golf["sss"])
    pred = torch.from_numpy(d["x"]).requires_grad_()
    loss = SSSLoss(n_fft=N_FFT, hop_length=N_FFT // 4, window="hanning")(
        pred[:, :VALID], torch.from_numpy(d["y"][:, :VALID]))
    loss.backward()
    assert abs(loss.item() - got["sss"][0]) <= 1e-5 * abs(loss.item())
    assert rel(got["sss_grad"], pred.grad.numpy()) <= 1e-4


def test_timeshard_matches_golf_tpu_allpole(port, golf):
    """``parallel.timeshard.allpole_timesharded`` on global tensors: every
    rank holds the whole y and the whole gradients of a loss computed the
    same on each, equal to golf_tpu's unsharded filter's (the order-22
    limits above)."""
    for y, gx, ga in port[1]["timeshard"]:
        assert rel(y, golf["allpole"]) < 1e-3
        assert rel(gx, golf["allpole_gx"]) < 2e-3
        assert rel(ga, golf["allpole_ga"]) < 2e-3


def test_gather_time_and_rows(port):
    """``gather_sig`` gives every rank the whole signal; ``slice_global_rows``
    each data index its rows."""
    d, got = port
    for rank, (whole, rows) in enumerate(got["gathered"]):
        np.testing.assert_array_equal(whole, d["x"])
        np.testing.assert_array_equal(rows, d["x"][rank:rank + 1])


def test_multihost_helpers(port):
    """``make_pod_mesh`` lays the ranks out node first; rank 0 is the main
    process; ``broadcast_one_to_all`` gives every rank rank 0's object."""
    for rank, m in enumerate(port[1]["multihost"]):
        assert m["pod"] == [[0, 1]]
        assert m["main"] == (rank == 0)
        assert m["bcast"] == {"rank": 0, "v": [1.5]}
