"""The port's host-side tool twins and their helpers against golf_tpu's, on
the CPU:

* ``ops.dsp.smooth_phase_offset`` and its gradient within 1e-6 of
  golf_tpu's (``jax.grad``), at random offsets and at differences of
  exactly -0.5 and 0.5 and below -1;
* ``tasks.cli.build_from_config`` builds the task, the seeded weights, the
  data module and the Trainer arguments that ``run`` built inline;
* ``tools/dump_refs_torch.py``, ``tools/harm_noise_stats_torch.py``:
  their files, JSON line and npz bit for bit those of golf_tpu's tools;
* ``tools/pesq_battery_torch.py``: every degradation bit for bit, and one
  MNRU condition and one family scored equal to golf_tpu's library
  (skipped only without ``g++``: the port builds ``native/pesq862.cpp``);
* ``tools/lpc_anchor_torch.py``: ``lpc_analysis``, ``excite`` and the
  per-sample interpolation bit for bit, and ``anchor`` within 1e-4 of
  max|y| of golf_tpu's tool and of a float64 scan of the same filter;
* the seven tool twins and ``ops/dsp.py`` import neither JAX nor
  golf_tpu, lazily or not."""

import ast
import contextlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from golf_tpu.config.registry import load_config as j_load_config
from golf_tpu.ops.dsp import smooth_phase_offset as j_smooth
from golf_tpu.utils import pesq862 as j_pesq862
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.ops.allpole import allpole_scan
from golf_tpu_torch.ops.dsp import smooth_phase_offset as t_smooth
from golf_tpu_torch.tasks import cli
from golf_tpu_torch.tasks.data import SyntheticVoiceDataset
from golf_tpu_torch.utils import pesq862 as t_pesq862
from golf_tpu_torch.utils.wav import write_wav

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAS_GXX = shutil.which("g++") is not None
SMOOTH_TOL = 1e-6       # smooth_phase_offset and its gradient, absolute
ANCHOR_TOL = 1e-4       # anchor() of max|y|, vs golf_tpu's and float64
TWINS = ("lpc_anchor", "time_l2", "rd_stats", "convert_ckpt", "dump_refs",
         "harm_noise_stats", "pesq_battery")


def tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _offsets(case):
    if case == "random":
        return np.random.default_rng(0).normal(
            0.0, 0.7, (3, 17)).astype(np.float32)
    # differences of exactly 0.5 and -0.5, negative ones, and below -1
    return np.array([[0.0, 0.5, 0.5, 0.0, -0.5, -1.75, -0.25, 0.75, 1.25,
                      0.75, -0.5]], np.float32)


@pytest.mark.parametrize("case", ["random", "half_and_negative"])
def test_smooth_phase_offset_matches_golf_tpu(case):
    off = _offsets(case)
    w = np.random.default_rng(1).standard_normal(off.shape).astype(
        np.float32)
    ref = np.asarray(j_smooth(jnp.asarray(off)))
    g_ref = np.asarray(jax.grad(lambda o: jnp.sum(j_smooth(o) * w))(
        jnp.asarray(off)))
    ot = torch.from_numpy(off).requires_grad_(True)
    out = t_smooth(ot)
    (torch.from_numpy(w) * out).sum().backward()
    assert out.shape == ref.shape
    assert np.abs(out.detach().numpy() - ref).max() <= SMOOTH_TOL
    assert np.abs(ot.grad.numpy() - g_ref).max() <= SMOOTH_TOL
    if case != "random":
        # (0.5 + 0.5) % 1 and (-0.5 + 0.5) % 1 are both 0: -0.5 either way
        steps = np.diff(out.detach().numpy()[0])
        assert steps[0] == -0.5 and steps[3] == -0.5


@pytest.mark.parametrize("configs,model,want", [
    (["cfg/ae/synthetic.yaml"], "cfg/ae/decoder/golf.yaml",
     ("VoiceAutoEncoder", "Synthetic")),
    (["cfg/vocoder.yaml"], "cfg/ae/decoder/golf-v1.yaml",
     ("DDSPVocoder", "MPop600")),
    (["cfg/ae/pyworld.yaml"], None, ("WORLDAutoEncoder", "VCTK")),
])
def test_build_from_config_builds_what_run_built(configs, model, want):
    cfg = t_load_config(configs, model)
    task, dm, kwargs = cli.build_from_config(cfg, "cpu")
    assert (type(task).__name__, type(dm).__name__) == want
    assert kwargs == cli.trainer_kwargs(cfg)
    # run's inline build before the builder: the seed, the task's build
    # function, then the data module
    torch.manual_seed(cfg.get("seed_everything") or 2434)
    node = cfg["model"]
    ref = cli.BUILD_FNS[want[0]](node.get("init_args", node), device="cpu")
    assert type(ref) is type(task)
    if isinstance(task, torch.nn.Module):       # WORLD has no weights
        own, other = task.state_dict(), ref.state_dict()
        assert own and own.keys() == other.keys()
        assert all(torch.equal(own[k], other[k]) for k in own)
    j_cfg = j_load_config(configs[0])
    if model:
        j_cfg["model"]["init_args"].update(j_load_config(model))
    from golf_tpu.tasks.cli import build_from_config as j_build_from_config
    j_task, j_dm, _ = j_build_from_config(j_cfg)
    assert (type(j_task).__name__, type(j_dm).__name__) == want


def _imports(path):
    """Every module name a file imports, at any depth."""
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_tool_twins_import_no_jax():
    files = [os.path.join(ROOT, "tools", f"{n}_torch.py") for n in TWINS]
    files.append(os.path.join(ROOT, "golf_tpu_torch", "ops", "dsp.py"))
    banned = ("jax", "flax", "optax", "orbax", "golf_tpu")
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in banned, (path, name)
    code = (
        "import sys, importlib.util\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'golf_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import golf_tpu_torch.ops.dsp\n"
        f"for n in {TWINS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        n, f'tools/{n}_torch.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _run(main, argv=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main() if argv is None else main(argv)
    return rc, out.getvalue()


def test_dump_refs_twin_writes_golf_tpu_files(tmp_path, monkeypatch):
    cfg = j_load_config("cfg/ae/synthetic.yaml")
    cfg["data"]["init_args"].update(n_items=16, duration=0.3)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(sys, "argv", ["dump_refs", str(path),
                                      str(tmp_path / "j")])
    _run(tool("dump_refs").main)
    rc, _ = _run(tool("dump_refs_torch").main,
                 [str(path), str(tmp_path / "t")])
    assert rc == 0
    ref = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert ref and ref == sorted(p.name for p in (tmp_path / "t").iterdir())
    for name in ref:
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name


def test_harm_noise_stats_twin_matches_golf_tpu(tmp_path, monkeypatch):
    r = np.random.default_rng(4)
    for spk in ("p360", "p361"):
        for branch, scale in (("harm", 0.3), ("noise", 0.05)):
            write_wav(str(tmp_path / branch / spk / f"{spk}_001.wav"),
                      scale * r.standard_normal(6000), 24000)
    argv = [str(tmp_path), "--n_fft", "512", "--hop", "128"]
    monkeypatch.setattr(sys, "argv", ["harm_noise_stats", *argv, "--out",
                                      str(tmp_path / "j.npz")])
    _, ref = _run(tool("harm_noise_stats").main)
    rc, got = _run(tool("harm_noise_stats_torch").main,
                   [*argv, "--out", str(tmp_path / "t.npz")])
    assert rc == 0 and json.loads(ref)["n_utts"] == 2
    assert got == ref
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        assert np.array_equal(j[k], t[k]), k


def test_pesq_battery_degradations_bit_for_bit():
    j, t = tool("pesq_battery"), tool("pesq_battery_torch")
    assert t.MNRU_ANCHORS == j.MNRU_ANCHORS and t.FS == j.FS
    for seed in (0, 2):
        x = j.speech_like(seed=seed)
        assert np.array_equal(t.speech_like(seed=seed), x)
        for fn, arg in (("mnru", 15), ("add_noise", 10), ("lowpass", 2000),
                        ("clip", 0.25), ("spectral_holes", 4)):
            extra = (seed,) if fn in ("mnru", "add_noise",
                                      "spectral_holes") else ()
            assert np.array_equal(getattr(t, fn)(x, arg, *extra),
                                  getattr(j, fn)(x, arg, *extra)), fn
    a, b = [3.0, 1.0, 2.0, 5.0], [2.5, 0.5, 2.0, 4.0]
    assert t.spearman(a, b) == j.spearman(a, b)
    assert t.pearson(a, b) == j.pearson(a, b)


@pytest.mark.skipif(not HAS_GXX, reason="no g++: pesq862.cpp not built")
def test_pesq_battery_scores_match_golf_tpu():
    """One MNRU condition and the clipping family, as the two batteries
    score them (golf_tpu's prebuilt library against the port's build)."""
    j, t = tool("pesq_battery"), tool("pesq_battery_torch")
    assert j_pesq862.available()
    fs = j.FS
    pairs = [(t.speech_like(seed=0), t.mnru(t.speech_like(seed=0), 20, 0))]
    pairs += [(t.speech_like(seed=1), t.clip(t.speech_like(seed=1), f))
              for f in (0.5, 0.25, 0.12, 0.06)]
    scores = [t_pesq862.pesq(ref, deg, fs, "wb") for ref, deg in pairs]
    assert scores == [j_pesq862.pesq(ref, deg, fs, "wb")
                      for ref, deg in pairs]
    assert all(0.5 < s < 5.0 for s in scores)
    # harsher clipping scores lower
    assert t.spearman(scores[1:], [0, 1, 2, 3]) <= -0.9


def _voice(seconds=0.5, seed=3):
    x, _ = SyntheticVoiceDataset(1, seconds, 24000, seed=seed)[0]
    return x


def test_lpc_anchor_host_stages_bit_for_bit(monkeypatch):
    j, t = tool("lpc_anchor"), tool("lpc_anchor_torch")
    x = _voice()
    lpc = t.lpc_analysis(x, 1024, 80, 26)
    assert np.array_equal(lpc, j.lpc_analysis(x, 1024, 80, 26))
    pitch = np.where(np.arange(lpc.shape[0]) % 7 < 4,
                     24000 / 180.0, 0.0)
    ex = t.excite(pitch, 80, seed=0)
    assert np.array_equal(ex, j.excite(pitch, 80, seed=0))
    # golf_tpu's synth interpolates, then calls its all-pole on float32
    # arrays: capture them
    import golf_tpu.ops.allpole as j_allpole
    seen = {}

    def capture(xs, a):
        seen["x"], seen["a"] = np.asarray(xs), np.asarray(a)
        return xs

    monkeypatch.setattr(j_allpole, "allpole", capture)
    j.synth(lpc, ex, 80)
    src, a = t.interpolate(lpc, ex, 80)
    assert np.array_equal(src[None].astype(np.float32), seen["x"])
    assert np.array_equal(a[None].astype(np.float32), seen["a"])


def test_lpc_anchor_matches_golf_tpu_and_float64():
    j, t = tool("lpc_anchor"), tool("lpc_anchor_torch")
    x = _voice()
    ref = j.anchor(x, 24000)
    got = t.anchor(x, 24000, device="cpu")
    assert got.dtype == np.float32 and got.shape == x.shape
    peak = np.abs(ref).max()
    assert peak > 0 and np.abs(got - ref).max() / peak <= ANCHOR_TOL
    # the same chain with a float64 scan as the filter
    src, a = t.interpolate(*t.excitation(x, 24000), 80)
    y64 = allpole_scan(torch.from_numpy(src[None].astype(np.float32)).double(),
                       torch.from_numpy(a[None].astype(np.float32)).double()
                       )[0].numpy()[:len(x)]
    y64 = y64 / max(1.0, np.abs(y64).max())
    assert np.abs(got - y64).max() / np.abs(y64).max() <= ANCHOR_TOL


def test_lpc_anchor_cli(tmp_path):
    x = _voice(0.3)
    write_wav(str(tmp_path / "in.wav"), x, 24000)
    rc, out = _run(tool("lpc_anchor_torch").main,
                   [str(tmp_path / "in.wav"), str(tmp_path / "out.wav"),
                    "--device", "cpu"])
    assert rc == 0 and "7200 samples @ 24000 Hz" in out
    from golf_tpu_torch.utils.wav import read_wav
    y, sr = read_wav(str(tmp_path / "out.wav"))
    assert sr == 24000 and y.shape == x.shape and np.isfinite(y).all()
