"""The yardstick against hand counts at the cells' shapes."""

import pytest

from gpubench.counts import PEAKS, bytes as kb, flops
from gpubench.harness import spec

SS = spec.load_json(spec.HERE / "configs" / "golf-ss.json")
FF = spec.load_json(spec.HERE / "configs" / "golf-ff.json")

# the operand shapes the training path (64 x 2 s) gives each kernel
TRAIN = {
    "lookup": ((64, 20, 9600), (64, 21, 2048)),
    "lookup_dtab": ((64, 20, 9600), (64, 21, 2048)),
    "allpole_tv": ((64, 47760), (64, 47760, 22)),
    "allpole_tv_adjoint": ((64, 47760), (64, 47760, 22)),
    "allpole_const": ((12800, 960), (12800, 22)),
    "allpole_const_adjoint": ((12800, 960), (12800, 22)),
}
# bytes by hand: ph in and out, tables in; x in, a in, y out; the const
# adjoint reads g, y, a and writes dx, da
HAND = {
    "lookup": 4 * (2 * 64 * 20 * 9600 + 64 * 21 * 2048),
    "lookup_dtab": 4 * (2 * 64 * 20 * 9600 + 64 * 21 * 2048),
    "allpole_tv": 4 * (2 * 64 * 47760 + 64 * 47760 * 22),
    "allpole_tv_adjoint": 4 * (2 * 64 * 47760 + 64 * 47760 * 22),
    "allpole_const": 4 * (2 * 12800 * 960 + 12800 * 22),
    "allpole_const_adjoint": 4 * (3 * 12800 * 960 + 2 * 12800 * 22),
}
# the least times that PERF.md's kernel table gives (us)
BOUND_US = {"lookup": 32.6, "lookup_dtab": 32.6, "allpole_tv": 87.6,
            "allpole_tv_adjoint": 87.6, "allpole_const": 29.7,
            "allpole_const_adjoint": 44.7}


@pytest.mark.parametrize("kernel", sorted(TRAIN))
def test_kernel_bytes_at_the_training_shapes(kernel):
    got = kb.BYTES[kernel](TRAIN[kernel])
    assert got == HAND[kernel]
    us = got / PEAKS["hbm_bytes_per_s"] * 1e6
    assert us == pytest.approx(BOUND_US[kernel], abs=0.05)


def test_train_step_flops_by_hand():
    p = flops.parts(SS, 64, 48000)
    tf = 200                                  # 48000 / 240 f0 frames
    assert p["stft"]["fwd"] == pytest.approx(64 * 201 * 5 * 1024 * 10)
    assert p["conv0"]["fwd"] == 2 * 64 * 32 * 513 * tf * 1 * 9 * 3
    assert p["conv1"]["fwd"] == 2 * 64 * 64 * 128 * tf * 32 * 9 * 3
    assert p["conv2"]["fwd"] == 2 * 64 * 128 * 32 * tf * 64 * 9 * 3
    assert p["conv3"]["fwd"] == 2 * 64 * 256 * 8 * tf * 128 * 9 * 3
    assert (p["conv0"]["bwd"], p["conv1"]["bwd"]) == (1, 2)
    gates = 2 * 4 * 256 * 64 * tf * 2         # both directions
    assert p["lstm"]["fwd"] == gates * ((513 + 256) + 2 * (512 + 256))
    assert p["head"]["fwd"] == 2 * 64 * tf * 512 * 343
    assert p["allpole"]["fwd"] == 2 * 22 * 64 * 47760
    assert p["decimate"]["fwd"] == 2 * 64 * 48000 * 449
    assert p["noise_fir"]["fwd"] == 2 * 64 * 199 * 240 * 510
    total = flops.train_step(SS, 64, 48000)
    assert 1.9e12 < total < 2.2e12
    # GOLF-ff: the same but its end filter, B2 over 200 windows of 960
    pf = flops.parts(FF, 64, 48000)
    assert pf["allpole"]["fwd"] == 2 * 22 * 64 * 200 * 960
    assert pf["conv3"] == p["conv3"] and pf["lstm"] == p["lstm"]


def test_resynthesis_flops_by_hand():
    p = flops.parts(SS, 64, 48000)
    assert p["conv0"]["fwd"] == 2 * 64 * 32 * 513 * 200 * 27
    assert p["allpole"]["fwd"] == 2 * 22 * 64 * 47760
    fwd = flops.resynthesis(SS, 64, 48000)
    assert fwd == pytest.approx(sum(v["fwd"] for k, v in p.items()
                                    if k != "mss"))
    assert 0.6e12 < fwd < 0.8e12
