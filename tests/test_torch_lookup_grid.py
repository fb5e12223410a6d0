"""The split of B1's and B3a's grid (``ops.lookup.plan_split``), on the CPU.

Each (batch, block) of the lookup is split over ``splits`` CTAs of
``piece`` contiguous samples. The planner is a plain function of the shape
and the SM count; the kernel (``kernels/csrc/lookup.cu``) runs only on the
card, where ``tests/test_torch_cuda.py`` holds it against its plain
version at these shapes.
"""

import pytest

from golf_tpu_torch.ops import lookup as tlk

H100_SMS = 132

# (B, blocks, hop, S): a push's window, serving 4 x 6 s, training 64 x 2 s;
# hops not divisible by 4; tiny hops; one block; one batch row
SHAPES = {
    "push": (4, 3, 9600, 2048),
    "serving": (4, 60, 9600, 2048),
    "training": (64, 20, 9600, 2048),
    "hop_999": (3, 7, 999, 1000),
    "hop_1001_s8192": (2, 3, 1001, 8192),
    "hop_1": (2, 5, 1, 64),
    "hop_7": (2, 5, 7, 64),
    "hop_7_one_cell": (1, 1, 7, 64),
    "one_block": (4, 1, 9600, 2048),
    "one_batch": (1, 60, 9600, 2048),
    "one_cell": (1, 1, 9600, 2048),
    "one_cell_hop_1": (1, 1, 1, 2048),
}


def _plan(name, n_sm=H100_SMS):
    b, blocks, hop, s = SHAPES[name]
    return tlk.plan_split(b, blocks, hop, s, n_sm), (b, blocks, hop, s)


@pytest.mark.parametrize("name", list(SHAPES))
def test_pieces_cover_the_block_once(name):
    plan, (b, blocks, hop, s) = _plan(name)
    pieces = plan.pieces(hop)
    assert len(pieces) == plan.splits >= 1
    assert pieces[0][0] == 0 and pieces[-1][1] == hop
    for (a0, a1), (b0, _) in zip(pieces, pieces[1:]):
        assert a1 == b0                       # contiguous, no overlap
    assert all(a1 > a0 for a0, a1 in pieces)  # none empty
    covered = [0] * hop
    for a0, a1 in pieces:
        for i in range(a0, a1):
            covered[i] += 1
    assert covered == [1] * hop


@pytest.mark.parametrize("name", list(SHAPES))
def test_pieces_are_whole_16_byte_units(name):
    plan, (b, blocks, hop, s) = _plan(name)
    if hop % 4 == 0:
        assert plan.piece % 4 == 0
        assert all(a0 % 4 == 0 and (a1 - a0) % 4 == 0
                   for a0, a1 in plan.pieces(hop))


@pytest.mark.parametrize("name", list(SHAPES))
def test_grid_is_within_cuda_limits_and_fills_the_card(name):
    plan, (b, blocks, hop, s) = _plan(name)
    tlk.check_grid("lookup", b, blocks, plan)
    assert plan.splits * blocks <= tlk.MAX_GRID_X and b <= tlk.MAX_GRID_Y
    # a CTA for every SM wherever the shape has that many pieces of one
    # 16-byte unit (or sample)
    unit = 4 if hop % 4 == 0 else 1
    assert b * blocks * plan.splits >= min(H100_SMS,
                                           b * blocks * -(-hop // unit))


def test_push_fills_the_card():
    plan, (b, blocks, hop, s) = _plan("push")
    assert b * blocks * plan.splits >= H100_SMS
    assert plan.piece < 2 * s                 # far below the rows it stages


@pytest.mark.parametrize("name", ["serving", "training"])
def test_larger_shapes_take_pieces_of_about_s(name):
    """Where the blocks alone give every SM a CTA, a block is split into
    ceil(hop / S) pieces of whole 16-byte units, none longer than S."""
    plan, (b, blocks, hop, s) = _plan(name)
    assert b * blocks >= H100_SMS
    assert plan.splits == -(-hop // s)
    assert plan.piece <= s


@pytest.mark.parametrize("n_sm", [1, 78, 114, 132])
def test_plan_holds_on_other_cards(n_sm):
    for name in SHAPES:
        plan, (b, blocks, hop, s) = _plan(name, n_sm)
        assert plan.pieces(hop)[-1][1] == hop
        assert (plan.splits - 1) * plan.piece < hop <= plan.splits * plan.piece
        unit = 4 if hop % 4 == 0 else 1
        assert b * blocks * plan.splits >= min(n_sm,
                                               b * blocks * -(-hop // unit))


def test_grid_beyond_cuda_limits_raises():
    with pytest.raises(ValueError, match="CUDA's limits"):
        tlk.check_grid("lookup", 65536, 1, tlk.LookupPlan(1, 8))
    with pytest.raises(ValueError, match="CUDA's limits"):
        tlk.check_grid("lookup", 1, 2 ** 30, tlk.LookupPlan(2, 8))
    tlk.check_grid("lookup", 65535, 2 ** 30 - 1, tlk.LookupPlan(2, 8))


@pytest.mark.parametrize("name,want", [("push", (11, 876)),
                                       ("serving", (5, 1920)),
                                       ("training", (5, 1920))])
def test_main_path_splits(name, want):
    """The splits the sweep chose at the main path's three shapes."""
    plan, _ = _plan(name)
    assert tuple(plan) == want
