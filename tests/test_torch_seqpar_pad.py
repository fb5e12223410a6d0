"""The port's time-sharded step against golf_tpu's own sharded step
(``make_sharded_train_fn``), and on a batch of any length
(``pad_to_alignment``), on the CPU.

* 1 x 2 (data x time), the tiny GOLF-ss of ``tests/test_seqpar.py`` at
  oversampling 4, B = 2 x 9600: the port's ``make_sharded_train_step`` on
  two gloo ranks against golf_tpu's ``make_sharded_train_fn`` on 2 CPU
  devices, same weights, same noise (golf_tpu draws its field over the
  global shape, as the port does);
* T = 2 x 2400 + 1234 with ``pad_align=2400``: ``pad_to_alignment`` equals
  golf_tpu's (zero audio, edge-held f0) bit for bit, and the port's sharded
  step on the unpadded batch equals golf_tpu's single-device step on the
  padded one.

Limits as ``test_torch_seqpar_step.py``'s: loss 2e-4 relative and 2e-5
absolute, gradients 5e-4 of their largest entry.
"""

import numpy as np
import torch

from tests.test_torch_parallel_dp import (JaxReference, check_grads,
                                          make_inputs, run_ranks,
                                          sharded_worker, tiny_cfg)

torch.set_num_threads(1)


def test_sharded_step_matches_golf_tpu_sharded_step(tmp_path):
    import jax
    from golf_tpu.parallel import seqpar as js
    from golf_tpu.parallel.mesh import make_mesh
    from golf_tpu_torch.bridge import flax_to_state_dict
    ref = JaxReference(tiny_cfg(4), 2, 4 * 2400, seed=6, key=9)
    v = ref.variables
    step = js.make_sharded_train_fn(
        ref.task, make_mesh(data=1, time=2, devices=jax.devices()[:2]))
    loss_j, grads_j, _, _ = step(v["params"], v.get("stats", {}),
                                 v.get("batch_stats", {}), ref.x, ref.f0,
                                 ref.key)
    grads_j = {k: t.numpy() for k, t in flax_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, grads_j)}).items()}
    # golf_tpu's sharded step is its single-device step (its own test)
    assert abs(float(loss_j) - ref.loss) <= 2e-4 * abs(ref.loss) + 2e-5
    out = run_ranks(2, tmp_path, sharded_worker, ref.cfg, v, ref.x, ref.f0,
                    ref.noise, [(1, 2)])
    loss, grads = out[0][0]
    assert abs(loss - float(loss_j)) <= 2e-4 * abs(float(loss_j)) + 2e-5
    check_grads(grads, grads_j, 5e-4)


def test_padded_sharded_step_matches_golf_tpu(tmp_path):
    import jax.numpy as jnp
    from golf_tpu.parallel.seqpar import pad_to_alignment as j_pad
    from golf_tpu_torch.parallel.seqpar import pad_to_alignment
    x, f0 = make_inputs(2, 2 * 2400 + 1234, seed=8)
    xp, f0p, t = pad_to_alignment(torch.from_numpy(x), torch.from_numpy(f0),
                                  2, 2400)
    xj, f0j, tj = j_pad(jnp.asarray(x), jnp.asarray(f0), 2, 2400)
    assert t == tj == x.shape[1] and xp.shape == (2, 2 * 2 * 2400)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(f0p.numpy(), np.asarray(f0j))
    ref = JaxReference(tiny_cfg(1), 2, None, key=4, x=xp.numpy(),
                       f0=f0p.numpy())
    out = run_ranks(2, tmp_path, sharded_worker, ref.cfg, ref.variables, x,
                    f0, ref.noise, [(1, 2)], 2400)
    loss, grads = out[0][0]
    assert abs(loss - ref.loss) <= 2e-4 * abs(ref.loss) + 2e-5
    check_grads(grads, ref.grads, 5e-4)
