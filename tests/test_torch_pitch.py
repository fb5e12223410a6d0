"""The port's pitch tools against golf_tpu's, on the CPU: the msgpack
reader (``utils/flax_msgpack.py``) against flax's, exactly; ``PitchNet``
on the shipped weights (logits within 1e-4 of max-abs), ``frame_signal``
(bit for bit: both resample through ``native/worldlite.cpp``), ``decode``
(periodicity 1e-6, f0 1e-5 relative), ``swipe``, ``dio_yin``, ``get_f0``
and the native YIN and resampler (bit for bit: the same numpy, the same
C++ source and flags), ``predict`` (frames voiced alike, f0 within 1e-5
relative); ``scripts/wav2f0_torch.py`` against ``scripts/wav2f0.py`` on a
tmp tree (the host methods' ``.pv`` files byte for byte, ``penn`` within a
printed 0.01 Hz on frames voiced in both, the voicing equal on 99%); and
CREPE at narrow widths (the first conv at k = 512, stride 4) in eval and
train mode: outputs within 1e-5 of max|y|, every gradient within 1e-3 of
its max-abs, the running statistics within 1e-5."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models import crepe as j_crepe
from golf_tpu.models import pitchnet as j_pn
from golf_tpu.utils import native as j_native
from golf_tpu.utils import pitchnet as j_upn
from golf_tpu.utils import swipe as j_swipe
from golf_tpu.utils import world_lite as j_wl
from golf_tpu.utils.wav import write_wav
from golf_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from golf_tpu_torch.config.registry import import_object
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models import pitchnet as t_pn
from golf_tpu_torch.utils import flax_msgpack
from golf_tpu_torch.utils import native as t_native
from golf_tpu_torch.utils import pitchnet as t_upn
from golf_tpu_torch.utils import swipe as t_swipe
from golf_tpu_torch.utils import world_lite as t_wl

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def golf_native():
    """golf_tpu's ctypes binding on ``native/worldlite.cpp``: its own
    ``native/libworldlite.so`` when built, else the port's build of the
    same source with the same flags (golf_tpu would fall back to numpy)."""
    if not j_native.has_native():
        j_native._LIB_PATH = t_native.build_host_library("worldlite.cpp")
    assert j_native.has_native()


def _voice(sr, seconds, f0=140.0, seed=0):
    t = np.arange(int(sr * seconds)) / sr
    x = sum(np.sin(2 * np.pi * k * f0 * (1 + 0.05 * np.sin(2 * np.pi * t))
                   * t) / k for k in range(1, 12))
    x = x * (t > 0.1) * (t < seconds - 0.1)
    x += 0.01 * np.random.default_rng(seed).standard_normal(len(t))
    return (0.3 * x).astype(np.float32)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_msgpack_reader_matches_flax_exactly():
    path = t_upn.ASSET
    with open(path, "rb") as fh:
        data = fh.read()
    tmpl = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
            j_pn.PitchNet().init, jax.random.key(0),
            jnp.zeros((1, j_pn.FRAME))))
    ref = dict(_leaves(serialization.from_bytes(tmpl, data)))
    got = dict(_leaves(flax_msgpack.loads(data)))
    assert set(ref) == set(got) and len(got) == 22
    for k, v in ref.items():
        assert got[k].dtype == np.float32
        assert np.array_equal(np.asarray(jnp.asarray(v, jnp.float32)),
                              got[k]), k
    # other dtypes, nesting and sizes through flax's own writer
    r = np.random.default_rng(0)
    tree = {"a": {"w": r.standard_normal((3, 70000)).astype(np.float32),
                  "i": np.arange(-5, 300, dtype=np.int32)},
            "d": r.standard_normal((2, 2)), "h": np.float16([1.5, -2]),
            "s": {"t": {"u": np.zeros((0, 4), np.float32)}}}
    got = flax_msgpack.loads(serialization.to_bytes(tree))
    for k, v in _leaves(tree):
        g = got
        for part in k:
            g = g[part]
        assert g.dtype == v.dtype and np.array_equal(g, v), k


def _frames(n=48, seed=0):
    r = np.random.default_rng(seed)
    t = np.arange(j_pn.FRAME) / j_pn.ANALYSIS_SR
    f0s = r.uniform(70, 900, n)
    return np.stack([np.sin(2 * np.pi * f * t) + 0.2 * np.sin(
        4 * np.pi * f * t) + 0.1 * r.standard_normal(t.size)
        for f in f0s]).astype(np.float32)


def test_pitchnet_shipped_weights_match_golf_tpu():
    model, params = j_upn.load_params()
    frames = _frames()
    ref = np.asarray(model.apply(params, jnp.asarray(frames)))
    port = t_upn.load_model(device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(frames)).numpy()
    assert got.shape == ref.shape == (48, t_pn.N_BINS)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_decode_and_bins_match_golf_tpu():
    r = np.random.default_rng(1)
    logits = (r.standard_normal((64, t_pn.N_BINS)) * 3).astype(np.float32)
    logits[:8, 100] += 12.0                      # confident frames
    logits[8:12, 0] += 12.0                      # at the edges
    logits[12:16, -1] += 12.0
    f_ref, p_ref = (np.asarray(a) for a in j_pn.decode(jnp.asarray(logits)))
    f_got, p_got = (a.numpy() for a in t_pn.decode(torch.from_numpy(logits)))
    assert np.abs(p_got - p_ref).max() <= 1e-6
    assert np.array_equal(f_got > 0, f_ref > 0) and (f_ref > 0).sum() >= 16
    assert np.abs(f_got - f_ref).max() <= 1e-5 * np.abs(f_ref).max()
    assert np.array_equal(t_pn.bin_centers_hz(), j_pn.bin_centers_hz())
    f0 = np.array([60.0, 65.0, 110.0, 440.0, 1000.0, 2000.0])
    assert np.array_equal(t_pn.f0_to_bin(f0), j_pn.f0_to_bin(f0))


@pytest.mark.parametrize("sr", [16000, 24000])
def test_frame_signal_bit_for_bit(sr):
    x = _voice(sr, 0.7)
    a, na = j_pn.frame_signal(x, sr)
    b, nb = t_pn.frame_signal(x, sr)
    assert na == nb and a.dtype == b.dtype and np.array_equal(a, b)


def test_native_yin_and_resample_bit_for_bit():
    x = _voice(24000, 0.6).astype(np.float64)
    for method in ("yin", "dio"):
        f_j, t_j = j_native.dio(x, 24000, method=method)
        f_t, t_t = t_native.dio(x, 24000, method=method)
        assert np.array_equal(f_j, f_t) and np.array_equal(t_j, t_t)
    for target in (16000, 22050, 24000):
        assert np.array_equal(j_native.resample(x, 24000, target),
                              t_native.resample(x, 24000, target))


def test_swipe_yin_get_f0_bit_for_bit():
    x = _voice(16000, 0.6).astype(np.float64)
    for kw in ({}, {"otype": "pitch", "threshold": 0.2}):
        assert np.array_equal(j_swipe.swipe(x, 16000, hopsize=80, **kw),
                              t_swipe.swipe(x, 16000, hopsize=80, **kw))
    for a, b in zip(j_wl.dio_yin(x, 16000), t_wl.dio_yin(x, 16000)):
        assert np.array_equal(a, b)
    for a, b in zip(j_wl.get_f0(x, 16000), t_wl.get_f0(x, 16000)):
        assert np.array_equal(a, b)
    assert (t_wl.get_f0(x, 16000)[0] > 0).mean() > 0.5


def test_predict_matches_golf_tpu():
    x = _voice(24000, 0.8)
    f_j, p_j = j_upn.predict(x, 24000, batch=128)
    f_t, p_t = t_upn.predict(x, 24000, batch=128, device="cpu")
    assert f_t.shape == f_j.shape
    assert np.abs(p_t - p_j).max() <= 1e-5
    assert np.array_equal(f_t > 0, f_j > 0) and (f_j > 0).mean() > 0.5
    assert np.abs(f_t - f_j).max() <= 1e-5 * np.abs(f_j).max()


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def f0_trees(tmp_path_factory):
    """The same wavs in two trees, one for each script."""
    roots = [tmp_path_factory.mktemp(n) for n in ("jax", "torch")]
    for i, (sr, f0) in enumerate(((24000, 130.0), (16000, 220.0))):
        x = _voice(sr, 0.8, f0=f0, seed=i)
        for root in roots:
            write_wav(str(root / "spk" / f"u{i}.wav"), x, sr)
    return roots


@pytest.mark.parametrize("method", ["dio", "native", "swipe", "penn"])
def test_wav2f0_matches_golf_tpu(f0_trees, method):
    j_root, t_root = f0_trees
    j_script = _load_script("wav2f0")
    wavs = sorted(j_root.glob("**/*.wav"))
    for w in wavs:
        j_script.process((w, w.with_suffix(f".{method}.pv"), 65.0, 1047.0,
                          method))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "wav2f0_torch.py"),
         str(t_root), "--method", method, "--workers", "1", "--device",
         "cpu"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    for w in wavs:
        ref_path = w.with_suffix(f".{method}.pv")
        got_path = t_root / w.relative_to(j_root).with_suffix(".pv")
        if method != "penn":
            assert got_path.read_bytes() == ref_path.read_bytes()
            continue
        ref, got = np.loadtxt(ref_path), np.loadtxt(got_path)
        both = (ref > 0) & (got > 0)
        assert ref.shape == got.shape and both.mean() > 0.5
        assert (np.equal(ref > 0, got > 0)).mean() >= 0.99
        assert np.abs(ref[both] - got[both]).max() <= 0.01


CREPE_ARGS = {"channels": (8, 4, 4, 8, 8, 16),
              "kernels": (512, 16, 16, 16, 16, 16),
              "strides": (4, 4, 4, 4, 2, 2)}
OUT = 6


def _crepe_pair(x):
    j_model = j_crepe.CREPE(**CREPE_ARGS)
    vs = dict(j_model.init(jax.random.key(0), JSig(jnp.asarray(x), 1),
                           train=False, out_channels=OUT))
    r = np.random.default_rng(4)
    vs["params"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * 0.2), vs["params"])
    vs["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(r.uniform(0.1, 0.3, a.shape)
                                  .astype(np.float32)), vs["batch_stats"])
    port = import_object("models.crepe.CREPE")(OUT, **CREPE_ARGS)
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, vs))
    return j_model, vs, port


@pytest.mark.parametrize("train", [False, True])
def test_crepe_matches_golf_tpu(train):
    r = np.random.default_rng(5)
    x = (r.standard_normal((2, 4096)) * 0.3).astype(np.float32)
    w = r.standard_normal((2, 5, OUT)).astype(np.float32)
    j_model, vs, port = _crepe_pair(x)

    def loss(params):
        out = j_model.apply({**vs, "params": params},
                            JSig(jnp.asarray(x), 1), train=train,
                            out_channels=OUT, mutable=["batch_stats"])
        y, state = out
        return jnp.sum(y.data * w), (y, state)

    (l_j, (y_j, state)), g_j = jax.value_and_grad(loss, has_aux=True)(
        vs["params"])
    assert y_j.hop == 1024
    port.train(train)
    y_t = port(TSig(torch.from_numpy(x), 1), train=train)
    assert y_t.hop == 1024 and tuple(y_t.shape) == (2, 5, OUT)
    (y_t.data * torch.from_numpy(w)).sum().backward()
    ref = np.asarray(y_j.data)
    assert np.abs(y_t.data.detach().numpy() - ref).max() <= \
        1e-5 * np.abs(ref).max()
    grads = flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, g_j)})
    for name, prm in port.named_parameters():
        ref_g = grads[name].numpy()
        # a conv's bias before a train-mode batch norm: zero gradient in
        # exact arithmetic, held against its weight's gradient scale
        scale = grads[name[:-4] + "weight"].numpy() \
            if train and name.startswith("convs.") and name.endswith("bias") \
            else ref_g
        assert np.abs(prm.grad.numpy() - ref_g).max() <= \
            1e-3 * np.abs(scale).max(), name
    if train:
        stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
            np.asarray, state["batch_stats"])})
        own = port.state_dict()
        for name, v in stats.items():
            assert np.abs(own[name].numpy() - v.numpy()).max() <= \
                1e-5 * np.abs(v.numpy()).max(), name
