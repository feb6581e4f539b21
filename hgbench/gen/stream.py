"""One robot's sensor stream, made from a configuration's sensors, a traffic
mix's drive and a seed.

IMU and odometry are small and made on the host (numpy). The scans are
ray casts of the mix's room, made on `device` in a few large calls, with
the range noise drawn from a torch.Generator seeded from the seed; a scan
is copied to the host when the driver hands it over.

  * 3D ("organized"): `beams` x `columns` rays, elevations evenly spread
    over [-max_elevation, max_elevation], row-major by beam as an
    organized PointCloud2 is; each point's time goes with its column over
    the sweep ([-sweep_s, 0], 0 at the scan's stamp); rays beyond
    max_range are masked out.
  * 2D ("planar"): `rays` rays over [-pi, pi), z = 0, time 0, padded to
    `capacity` points.

Rooms are axis-aligned boxes (rectangles in 2D) given by their half
extents and the centre's offset from the lap's frame; the sensor is at
the tracking frame's origin, so the box's floor lies
`center[2] - half_extents[2]` below it.
"""

from __future__ import annotations

import math
import numpy as np
import torch

from hgbench.gen.drive import Drive
from hgbench.lib import quat

GRAVITY = 9.80665
CHUNK = 32  # scans a ray-cast call


def seed_bits(seed: int, salt: int = 0) -> int:
    """A non-negative 63-bit seed for numpy and torch from any integer."""
    return (int(seed) * 1_000_003 + salt) & ((1 << 63) - 1)


class Stream:
    """Host arrays of one robot's stream, and its scans: ray casts made a
    chunk of CHUNK scans at a time, each chunk's noise from a generator
    seeded from the seed and the chunk's index, so that a scan is the same
    whether its chunk is made ahead (eager) or when first asked for."""

    def __init__(self, imu_t, imu_acc, imu_gyro, odom_t, odom_xyz, odom_q, scan_t, cast, point_times, width,
                 eager: bool):
        self.imu_t, self.imu_acc, self.imu_gyro = imu_t, imu_acc, imu_gyro
        self.odom_t, self.odom_xyz, self.odom_q = odom_t, odom_xyz, odom_q
        self.scan_t, self.point_times, self.width = scan_t, point_times, width
        self._cast = cast
        self._chunks = {}
        self._eager = eager
        if eager:
            for c in range((len(scan_t) + CHUNK - 1) // CHUNK):
                self._chunk(c)

    def _chunk(self, c: int):
        got = self._chunks.get(c)
        if got is None:
            got = self._chunks[c] = self._cast(c)
            if not self._eager:
                for old in [k for k in self._chunks if k < c - 1]:
                    del self._chunks[old]
        return got

    def points(self, i: int):
        """(positions (R, 3) f32, mask (R,) bool) of scan i, on the device
        the stream casts on."""
        pts, mask = self._chunk(i // CHUNK)
        return pts[i % CHUNK], mask[i % CHUNK]

    def samples_until(self, t: float, imu: int, odom: int):
        """The IMU and odometry samples after the first `imu` and `odom`
        ones, stamped at or before t, in time order (at one stamp the IMU
        first, as a bag orders them): ("imu", i) and ("odom", j) items."""
        imu_stop = int(np.searchsorted(self.imu_t, t, side="right"))
        odom_stop = int(np.searchsorted(self.odom_t, t, side="right"))
        while imu < imu_stop or odom < odom_stop:
            if odom >= odom_stop or (imu < imu_stop and self.imu_t[imu] <= self.odom_t[odom]):
                yield "imu", imu
                imu += 1
            else:
                yield "odom", odom
                odom += 1

    def scan(self, i: int):
        """(time, positions (R, 3) f32, times (R,) f32, mask (R,) bool) of
        scan i on the host."""
        pts, mask = self.points(i)
        return float(self.scan_t[i]), pts.cpu().numpy(), self.point_times, mask.cpu().numpy()


def _box_ranges(origins, dirs, center, half):
    """Distance along each ray (..., 3) from origins (..., 3) to the inside
    walls of a box; inf where none is hit."""
    ts = torch.full(dirs.shape[:-1], math.inf, dtype=dirs.dtype, device=dirs.device)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            wall = center[axis] + sign * half[axis]
            d = dirs[..., axis]
            t = (wall - origins[..., axis]) / d
            hit = origins + t[..., None] * dirs
            ok = t > 1e-6
            for other in range(3):
                if other != axis:
                    ok &= torch.abs(hit[..., other] - center[other]) <= half[other] + 1e-9
            ts = torch.where(ok & (t < ts), t, ts)
    return ts


def make_stream(sensors: dict, mix: dict, seed: int, device, duration_s: float, start_m=None,
                eager: bool = True) -> Stream:
    """The stream of `duration_s` seconds of sensor time for one robot.
    `start_m` places it on the lap (the mix's own start when None); with
    `eager` every scan is cast at once, else a chunk when first asked."""
    drive = Drive(mix["drive"], sensors["scan_rate_hz"], start_m=start_m)
    room = mix["room"]
    rng = np.random.default_rng(seed_bits(seed))
    imu_rate, odom_rate, scan_rate = sensors["imu_rate_hz"], sensors["odometry_rate_hz"], sensors["scan_rate_hz"]

    imu_t = np.round(np.arange(0.0, duration_s, 1.0 / imu_rate), 6)
    _, yaw_i, rate_i = drive.pose(imu_t)
    acc_world = np.array([0.0, 0.0, GRAVITY]) + (drive.accel(imu_t) if sensors.get("imu_motion_terms") else 0.0)
    imu_acc = quat.rotate(quat.conj(quat.yaw(yaw_i)), acc_world)
    imu_gyro = np.stack([np.zeros_like(rate_i), np.zeros_like(rate_i), rate_i], axis=-1)

    odom_t = np.round(np.arange(0.0, duration_s, 1.0 / odom_rate), 6)
    xy_o, yaw_o, _ = drive.pose(odom_t)
    odom_xyz = np.concatenate([xy_o, np.zeros((len(odom_t), 1))], axis=-1)
    odom_xyz = odom_xyz + rng.normal(0.0, sensors["odometry_noise_m"], odom_xyz.shape)
    odom_q = quat.yaw(yaw_o)

    scan_t = np.round(np.arange(0.5 / scan_rate, duration_s, 1.0 / scan_rate), 6)
    xy_s, yaw_s, _ = drive.pose(scan_t)
    center = [float(x) for x in room["center"]]
    half = [float(x) for x in room["half_extents"]]
    kind = sensors["scanner"]
    if kind == "organized":
        n_el, n_az = sensors["beams"], sensors["columns"]
        max_el = float(sensors["max_elevation_rad"])
        az = torch.linspace(-math.pi, math.pi, n_az + 1, dtype=torch.float64, device=device)[:-1]
        el = torch.linspace(-max_el, max_el, n_el, dtype=torch.float64, device=device)
        elg, azg = torch.meshgrid(el, az, indexing="ij")
        dirs = torch.stack([torch.cos(elg) * torch.cos(azg), torch.cos(elg) * torch.sin(azg), torch.sin(elg)],
                           dim=-1).reshape(-1, 3)
        col = np.arange(n_az * n_el) % n_az
        sweep = float(sensors["sweep_s"])
        point_times = (col / (n_az - 1) * sweep - sweep).astype(np.float32)
        width = n_az
    elif kind == "planar":
        n = sensors["rays"]
        ang = torch.linspace(-math.pi, math.pi, n + 1, dtype=torch.float64, device=device)[:-1]
        dirs = torch.stack([torch.cos(ang), torch.sin(ang), torch.zeros_like(ang)], dim=-1)
        point_times = np.zeros(sensors["capacity"], np.float32)
        width = 0
    else:
        raise ValueError(f"unknown scanner {kind!r}")
    max_range, noise = float(sensors["max_range_m"]), float(sensors["range_noise_m"])
    n_rays = dirs.shape[0]
    cap = sensors.get("capacity", n_rays)
    yaw_dev = torch.as_tensor(yaw_s, dtype=torch.float64, device=device)
    xy_dev = torch.as_tensor(xy_s, dtype=torch.float64, device=device)

    def cast(c: int):
        """Scans c * CHUNK onwards, CHUNK of them (fewer at the end)."""
        lo, hi = c * CHUNK, min((c + 1) * CHUNK, len(scan_t))
        gen = torch.Generator(device=device)
        gen.manual_seed(seed_bits(seed, 1000 + c))
        cos, sin = torch.cos(yaw_dev[lo:hi])[:, None], torch.sin(yaw_dev[lo:hi])[:, None]
        world = torch.stack([cos * dirs[None, :, 0] - sin * dirs[None, :, 1],
                             sin * dirs[None, :, 0] + cos * dirs[None, :, 1],
                             dirs[None, :, 2].expand(hi - lo, n_rays)], dim=-1)
        origins = torch.cat([xy_dev[lo:hi], torch.zeros_like(xy_dev[lo:hi, :1])], dim=-1)[:, None, :]
        t = _box_ranges(origins.expand_as(world), world, center, half)
        t = t + noise * torch.randn(t.shape, dtype=torch.float64, device=device, generator=gen)
        ok = torch.isfinite(t) & (t <= max_range)
        points = torch.zeros((hi - lo, cap, 3), dtype=torch.float32, device=device)
        mask = torch.zeros((hi - lo, cap), dtype=torch.bool, device=device)
        points[:, :n_rays] = torch.where(ok[..., None], dirs[None] * t[..., None], 0.0).to(torch.float32)
        mask[:, :n_rays] = ok
        return points, mask

    return Stream(imu_t, imu_acc, imu_gyro, odom_t, odom_xyz, odom_q, scan_t, cast, point_times, width, eager)
