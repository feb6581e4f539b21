"""Planar drives: where a robot is at time t, from a traffic mix's "drive".

Two kinds, each a closed lap parametrized by arc length:

  * "rounded_rect": a rectangle of half sizes (a, b) with corners of
    radius r around `center`, driven counter-clockwise at `speed` after
    `rest_s` at rest and a linear ramp of `ramp_s`; the robot starts
    `start_m` metres along the lap (from the start of the lower straight).
  * "circle": a circle of `radius` around `center`, `scans_per_lap`
    scans at the sensor's rate a lap (the speed follows), starting at
    angle 0; the robot faces along the circle (yaw = angle + pi / 2),
    as Cartographer's mapping-evaluation circle drives.

pose(t) gives the position (x, y), the yaw and the yaw rate; accel(t) the
world-frame acceleration of the lap's own motion (tangential and
centripetal).
"""

from __future__ import annotations

import math

import numpy as np


class Drive:
    def __init__(self, spec: dict, sensor_rate_hz: float = 10.0, start_m: float | None = None):
        self.kind = spec["kind"]
        self.center = np.asarray(spec.get("center", (0.0, 0.0)), float)
        self.rest_s = float(spec.get("rest_s", 0.0))
        self.ramp_s = float(spec.get("ramp_s", 0.0))
        if self.kind == "rounded_rect":
            self.a, self.b = (float(x) for x in spec["half_size"])
            self.r = float(spec["corner_radius"])
            self.speed = float(spec["speed"])
            straight_x, straight_y = 2 * (self.a - self.r), 2 * (self.b - self.r)
            self.pieces = [("line", straight_x, 0.0), ("arc", 0.5 * math.pi * self.r, 0.0),
                           ("line", straight_y, 0.5 * math.pi), ("arc", 0.5 * math.pi * self.r, 0.5 * math.pi),
                           ("line", straight_x, math.pi), ("arc", 0.5 * math.pi * self.r, math.pi),
                           ("line", straight_y, 1.5 * math.pi), ("arc", 0.5 * math.pi * self.r, 1.5 * math.pi)]
            self.length = sum(p[1] for p in self.pieces)
        elif self.kind == "circle":
            self.radius = float(spec["radius"])
            self.length = 2 * math.pi * self.radius
            self.speed = self.length / (float(spec["scans_per_lap"]) / sensor_rate_hz)
        else:
            raise ValueError(f"unknown drive kind {self.kind!r}")
        self.start_m = float(spec.get("start_m", 0.0) if start_m is None else start_m)

    # -- arc length over time -------------------------------------------------

    def arc(self, t):
        """(s, ds/dt, d2s/dt2) at times t (arrays): rest, a linear ramp of
        the speed, then constant speed."""
        t = np.asarray(t, float)
        v, t0, tr = self.speed, self.rest_s, self.ramp_s
        u = np.clip(t - t0, 0.0, None)
        if tr > 0:
            in_ramp = u < tr
            s = np.where(in_ramp, 0.5 * v * u * u / tr, v * (u - 0.5 * tr))
            ds = np.where(in_ramp, v * u / tr, v)
            dds = np.where(in_ramp & (t > t0), v / tr, 0.0)
        else:
            s, ds, dds = v * u, np.where(t > t0, v, 0.0), np.zeros_like(u)
        return self.start_m + s, ds, dds

    # -- geometry ------------------------------------------------------------

    def _geometry(self, s):
        """(x, y, heading, curvature) at arc lengths s (arrays)."""
        s = np.mod(np.asarray(s, float), self.length)
        if self.kind == "circle":
            ang = s / self.radius
            x = self.center[0] + self.radius * np.cos(ang)
            y = self.center[1] + self.radius * np.sin(ang)
            return x, y, ang + 0.5 * math.pi, np.full_like(s, 1.0 / self.radius)
        a, b, r = self.a, self.b, self.r
        # Start of each piece: the lower straight begins at (-a + r, -b).
        starts = [(-a + r, -b), (a - r, -b), (a, -b + r), (a, b - r), (a - r, b), (-a + r, b), (-a, b - r),
                  (-a, -b + r)]
        x, y = np.zeros_like(s), np.zeros_like(s)
        head, curv = np.zeros_like(s), np.zeros_like(s)
        offset = 0.0
        for (kind, length, h0), (sx, sy) in zip(self.pieces, starts):
            sel = (s >= offset) & (s < offset + length + 1e-12)
            d = s[sel] - offset
            if kind == "line":
                x[sel] = sx + d * math.cos(h0)
                y[sel] = sy + d * math.sin(h0)
                head[sel] = h0
            else:
                # Centre of the corner: left of the heading by r.
                cx, cy = sx - r * math.sin(h0), sy + r * math.cos(h0)
                phi = h0 + d / r
                x[sel] = cx + r * np.sin(phi)
                y[sel] = cy - r * np.cos(phi)
                head[sel] = phi
                curv[sel] = 1.0 / r
            offset += length
        return x + self.center[0], y + self.center[1], head, curv

    def pose(self, t):
        """(xy (n, 2), yaw (n,), yaw rate (n,)) at times t."""
        s, ds, _ = self.arc(t)
        x, y, head, curv = self._geometry(s)
        return np.stack([x, y], axis=-1), head, curv * ds

    def accel(self, t):
        """World-frame acceleration (n, 3) of the drive at times t."""
        s, ds, dds = self.arc(t)
        _, _, head, curv = self._geometry(s)
        tangent = np.stack([np.cos(head), np.sin(head)], axis=-1)
        normal = np.stack([-np.sin(head), np.cos(head)], axis=-1)
        a = dds[:, None] * tangent + (curv * ds * ds)[:, None] * normal
        return np.concatenate([a, np.zeros((len(a), 1))], axis=-1)
