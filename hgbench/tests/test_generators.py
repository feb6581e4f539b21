"""The generators repeat per seed, and their drives are what they say."""

import numpy as np
import pytest
import torch

from hgbench.gen.drive import Drive
from hgbench.gen.stream import make_stream
from hgbench.lib import names

SMALL = {"drz_ct3d": {"beams": 8, "columns": 32}, "carto2d": {"rays": 90}}


def _stream(config, mix, seed):
    sensors = dict(names.load_json("configs", config)["sensors"], **SMALL[config])
    return make_stream(sensors, names.load_json("traffic", mix), seed, torch.device("cpu"), duration_s=3.0)


@pytest.mark.parametrize("config,mix", [("drz_ct3d", "solo"), ("carto2d", "laps")])
def test_stream_repeats_per_seed(config, mix):
    a, b, c = _stream(config, mix, 2**31 + 7), _stream(config, mix, 2**31 + 7), _stream(config, mix, 12)
    lazy = make_stream(dict(names.load_json("configs", config)["sensors"], **SMALL[config]),
                       names.load_json("traffic", mix), 2**31 + 7, torch.device("cpu"), 3.0, eager=False)
    for i in range(len(a.scan_t)):
        # The same scan, made again, ahead or on demand.
        for x, y, z in zip(a.points(i), b.points(i), lazy.points(i)):
            assert torch.equal(x, y) and torch.equal(x, z)
    for x, y in ((a.imu_acc, b.imu_acc), (a.odom_xyz, b.odom_xyz), (a.scan_t, b.scan_t)):
        assert np.array_equal(x, y)
    assert not torch.equal(a.points(0)[0], c.points(0)[0]) and not np.array_equal(a.odom_xyz, c.odom_xyz)
    # Every seed makes the same work: the same scans at the same times.
    assert np.array_equal(a.scan_t, c.scan_t)


def test_scan_points_lie_on_the_room():
    s = _stream("drz_ct3d", "solo", 3)
    room = names.load_json("traffic", "solo")["room"]
    drive = Drive(names.load_json("traffic", "solo")["drive"])
    xy, yaw, _ = drive.pose(s.scan_t[:1])
    c, sn = np.cos(yaw[0]), np.sin(yaw[0])
    pts, mask = s.points(0)
    p = pts[mask].double().numpy()
    world = np.stack([c * p[:, 0] - sn * p[:, 1] + xy[0, 0], sn * p[:, 0] + c * p[:, 1] + xy[0, 1], p[:, 2]], 1)
    gap = np.min(np.abs(np.abs(world - np.array(room["center"])) - np.array(room["half_extents"])), axis=1)
    assert np.all(gap < 0.05)  # on a wall, within the range noise


@pytest.mark.parametrize("mix", ["solo", "laps"])
def test_drive_is_continuous_and_keeps_its_speed(mix):
    spec = names.load_json("traffic", mix)["drive"]
    d = Drive(spec)
    t = np.arange(0.0, 200.0, 0.01)
    xy, yaw, rate = d.pose(t)
    step = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    assert np.all(step <= d.speed * 0.01 + 1e-9)
    moving = t[1:] > d.rest_s + d.ramp_s + 0.02
    assert np.allclose(step[moving], d.speed * 0.01, rtol=1e-3)
    dyaw = np.diff(np.unwrap(yaw))
    steady = moving & (rate[1:] == rate[:-1])  # no corner begins or ends inside the step
    assert steady.sum() > 1000
    assert np.allclose(dyaw[steady], rate[1:][steady] * 0.01, atol=1e-9)
