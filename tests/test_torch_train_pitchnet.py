"""``tools/train_pitchnet_torch.py`` against ``tools/train_pitchnet.py``, on
the CPU.

* ``make_batch`` gives the same bits for the same generator;
* two steps from golf_tpu's initial PitchNet weights on the same batches:
  the soft-target cross-entropy within 1e-5 relative and its gradients
  within 1e-4 of their largest entry; then the port's adamw under the
  cosine schedule (three decay steps, so the rate moves), given golf_tpu's
  gradients, moves every leaf as optax's ``adamw(cosine_decay_schedule)``
  does: the weights within 1e-6 of their largest entry plus 1e-5 of the
  two steps' rate (optax rounds Adam's bias corrections to float32:
  1 - 0.999 is 1.3e-5 off in float32, 6.5e-6 after the square root);
* the written bf16 msgpack equals flax's ``to_bytes`` of the same weights
  in bf16 byte for byte, reads back through flax's ``serialization``, and
  golf_tpu's PitchNet on it gives the port's logits (1e-5 of max|ref|);
* ``main`` runs 3 steps on the CPU and prints its eval line.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import train_pitchnet as j_tool            # noqa: E402
import train_pitchnet_torch as t_tool      # noqa: E402

torch.set_num_threads(1)


def test_make_batch_same_bits():
    for seed, b in ((0, 64), (7, 5)):
        got = t_tool.make_batch(np.random.default_rng(seed), b)
        ref = j_tool.make_batch(np.random.default_rng(seed), b)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


def _jax_model():
    import jax
    import jax.numpy as jnp
    from golf_tpu.models.pitchnet import FRAME, PitchNet
    model = PitchNet()
    params = model.init(jax.random.key(0), jnp.zeros((1, FRAME)))
    return model, params


def test_adamw_cosine_steps_match_optax():
    import jax
    import jax.numpy as jnp
    import optax
    from golf_tpu_torch.bridge import pitchnet_state_dict, pitchnet_variables
    from golf_tpu_torch.models.pitchnet import PitchNet
    lr, steps = 2e-4, 3
    model, params = _jax_model()
    init = jax.tree_util.tree_map(np.asarray, params)["params"]
    opt = optax.adamw(optax.cosine_decay_schedule(lr, steps))
    ost = opt.init(params)

    @jax.jit
    def grads_of(params, x, tgt):
        def loss_fn(p):
            logits = model.apply(p, x)
            return -(tgt * jax.nn.log_softmax(logits, -1)).sum(-1).mean()
        return jax.value_and_grad(loss_fn)(params)

    net = PitchNet()
    net.load_state_dict(pitchnet_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    topt = t_tool.make_optimizer(net, lr, steps)
    rng = np.random.default_rng(3)
    named = dict(net.named_parameters())
    for _ in range(2):
        x, tgt, _, _ = t_tool.make_batch(rng, 16)
        loss_j, g_j = grads_of(params, jnp.asarray(x), jnp.asarray(tgt))
        topt.zero_grad()
        loss_t = t_tool.soft_cross_entropy(net(torch.from_numpy(x)),
                                           torch.from_numpy(tgt))
        loss_t.backward()
        assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * float(loss_j)
        g_ref = pitchnet_state_dict(jax.tree_util.tree_map(np.asarray, g_j))
        for k, g in g_ref.items():
            assert (named[k].grad - g).abs().max() <= 1e-4 * g.abs().max(), k
            named[k].grad = g.clone()   # the optimizer on the same grads
        topt.step()
        up, ost = opt.update(g_j, ost, params)
        params = optax.apply_updates(params, up)
    got = pitchnet_variables(net.state_dict())["params"]
    ref = jax.tree_util.tree_map(np.asarray, params)["params"]
    for mod, leaves in ref.items():
        for leaf, r in leaves.items():
            assert np.abs(r - init[mod][leaf]).max() > 0, (mod, leaf)
            assert np.abs(got[mod][leaf] - r).max() <= 1e-6 * np.abs(
                r).max() + 1e-5 * lr * 2, (mod, leaf)


def test_written_msgpack_reads_back_in_flax(tmp_path):
    import jax
    import jax.numpy as jnp
    from flax import serialization
    from golf_tpu_torch.bridge import pitchnet_state_dict
    from golf_tpu_torch.models.pitchnet import FRAME, PitchNet
    from golf_tpu_torch.utils.pitchnet import load_model
    model, params = _jax_model()
    net = PitchNet()
    net.load_state_dict(pitchnet_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    path = str(tmp_path / "pitchnet.msgpack")
    t_tool.write_weights(net, path)
    raw = open(path, "rb").read()
    small = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.dtype(jnp.bfloat16)), params)
    assert raw == serialization.to_bytes(small)
    restored = serialization.msgpack_restore(raw)
    x = np.random.default_rng(1).standard_normal((4, FRAME)).astype(
        np.float32)
    ref = np.asarray(model.apply(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), restored), jnp.asarray(x)))
    with torch.no_grad():
        got = load_model(path, "cpu")(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_main_runs_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "w.msgpack")
    res = t_tool.main(["--device", "cpu", "--steps", "3", "--batch", "8",
                       "--out", out])
    text = capsys.readouterr().out
    assert "eval: cents MAE" in text and os.path.exists(out)
    assert res["ms_per_step"] > 0 and 0 <= res["voiced_detect"] <= 1


def test_tool_imports_neither_jax_nor_golf_tpu():
    """``tools/train_pitchnet_torch.py`` and ``golf_tpu_torch/parallel``,
    read as source: no import of jax, flax, optax or golf_tpu."""
    import ast
    banned = ("jax", "flax", "optax", "golf_tpu")
    par = os.path.join(ROOT, "golf_tpu_torch", "parallel")
    files = [os.path.join(ROOT, "tools", "train_pitchnet_torch.py")] + [
        os.path.join(par, f) for f in os.listdir(par) if f.endswith(".py")]
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
