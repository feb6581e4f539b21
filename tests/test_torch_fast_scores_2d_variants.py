"""K5's wrapper (hectorgrapher_tpu_torch/ops/fast_scores_2d.py) on the CPU:
the kernel instance it picks for each offset grid, its size checks at the
kernel's grid limits, and that a call it refuses raises before any launch.
The kernel itself runs only on the card (chip_smoke.py phase 20 holds each
instance to the plain version there)."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from hectorgrapher_tpu_torch.ops import fast_scores_2d as k5

INT32_MAX = 2**31 - 1
SIZE_MAX = INT32_MAX - 2048  # C, Y and P: a staging chunk below 2^31


@pytest.mark.parametrize("grid, want", [
    ((2, 2), 1),  # every expansion level
    ((5, 5), 2),  # the local coarse stage: linear_cells 40, depth 6
    ((11, 11), 3),  # the full-submap coarse stage: 320 cells, depth 7
    ((3, 7), 0),  # any other grid: the generic instance
    ((81, 81), 0),  # depth 1 over 40 cells
    ((5, 2), 0),
    ((1, 1), 0),
])
def test_instance_choice(grid, want):
    assert k5.instance(*grid) == want
    assert k5.launch_config(3, *grid, 2048, 4) == want


def test_instances_match_the_chip_gates():
    """chip_smoke.py's synthetic K5 calls reach every instance, each under
    the number the wrapper gives its grid."""
    assert {case[4] for case in cs.K5_EDGE_CASES} == {0, *k5.INSTANCES.values()}
    for label, nxo, nyo, level, inst, p in cs.K5_EDGE_CASES:
        assert k5.launch_config(24, nxo, nyo, p, level) == inst, label


@pytest.mark.parametrize("sizes", [
    (1, 2, 2, 2048, 0),
    (SIZE_MAX, 2, 2, 2048, 4),  # ceil(C / candidates a block) blocks of a one-dimensional grid
    (3107, 5, 5, 2048, 5),
    (1423, 11, 11, 2048, 6),
    (16, 81, 81, 2048, 0),  # 6,561 outputs a candidate, one block
    (4, 65536, 32767, 2048, 2),  # X * Y just under 2^31
    (2, 1, SIZE_MAX, 2048, 3),
    (2, 2, 2, SIZE_MAX, 30),
    (2, 2, 2, 0, 3),  # no point slots: every sum is 0
])
def test_launch_config_accepts(sizes):
    assert k5.launch_config(*sizes) in (0, 1, 2, 3)


@pytest.mark.parametrize("sizes", [
    (0, 2, 2, 2048, 4),  # no candidate
    (SIZE_MAX + 1, 2, 2, 2048, 4),  # a block's last candidate past 2^31 - 1
    (INT32_MAX, 2, 2, 2048, 4),
    (8, 0, 5, 2048, 4),
    (8, 5, 0, 2048, 4),
    (8, 65536, 32768, 2048, 4),  # X * Y = 2^31
    (8, 1, SIZE_MAX + 1, 2048, 4),
    (8, 2, 2, SIZE_MAX + 1, 4),  # the last chunk's end past 2^31 - 1
    (8, 2, 2, INT32_MAX, 4),
    (8, 2, 2, -1, 4),
    (8, 2, 2, 2048, -1),
    (8, 2, 2, 2048, 31),  # 2^level no longer an int
])
def test_launch_config_refuses(sizes):
    with pytest.raises(ValueError, match="unsupported sizes"):
        k5.launch_config(*sizes)


def _args(c=6, nxo=5, nyo=5, p=64, r=4, level=2, dims=(16, 12), depth=4, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    table = rng.uniform(-0.1, 0.8, (depth, dims[0] + 1, dims[1])).astype(np.float32)
    table[:, -1] = 0.0
    return (t(table.reshape(-1, dims[1])), t(rng.integers(0, dims[0], (r, p)).astype(np.int32)),
            t(rng.integers(0, dims[1], (r, p)).astype(np.int32)), t(rng.random((r, p)) < 0.7),
            t(rng.integers(0, r, c).astype(np.int32)), t(rng.integers(-4, 5, (c, nxo)).astype(np.int32)),
            t(rng.integers(-4, 5, (c, nyo)).astype(np.int32)), level, dims, None)


@pytest.mark.parametrize("shape, want", [((2, 2), 1), ((5, 5), 2), ((11, 11), 3), ((3, 7), 0)])
def test_checked_instance(shape, want):
    assert k5.checked_instance(*_args(nxo=shape[0], nyo=shape[1])) == want


@pytest.mark.parametrize("bad", ["no_candidate", "no_x_offset", "level", "offset_dtype", "flag_shape",
                                 "level_past_table"])
def test_refused_call_raises_before_any_launch(bad):
    """checked_instance, which the wrapper runs before it allocates or
    launches anything, refuses the call on the CPU, without a card."""
    a = list(_args())
    if bad == "no_candidate":
        a[4], a[5], a[6] = a[4][:0], a[5][:0], a[6][:0]
    elif bad == "no_x_offset":
        a[5] = a[5][:, :0].contiguous()
    elif bad == "level":
        a[7] = 31
    elif bad == "offset_dtype":
        a[6] = a[6].long()
    elif bad == "flag_shape":
        a[3] = a[3][:, :-1].contiguous()
    else:
        a[7] = 4  # a 4-level table has no level 4
    with pytest.raises((ValueError, TypeError)):
        k5.checked_instance(*a)
