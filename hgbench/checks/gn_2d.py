"""The 2D front end's scan matches of the timed window against the plain
reference (hgbench/reference/scan_2d.py).

Sampled from the seed among the window's refinements: the matching
submap's occupancy grid, the filtered cloud, the initial pose and the
target (the program's state and its filters' output: the reference
follows them step by step), and the program's answer, its pose and cost.
The reference derives the probability field from the grid's log-odds,
evaluates the configured cost and refines from the same start:

  gn2d_cost_rel    |program's final cost - the reference's cost at the
                   program's pose| / the latter
  gn2d_lm_excess   (reference cost at the program's pose - at its own
                   refinement) / its cost at the start, 0 where the
                   program's is lower
  gn2d_pose_gap_m  the local pose returned for the scan against the
  gn2d_pose_gap_rad  reference's refinement: its translation's x, y (m),
                   and its yaw once the scan's gravity alignment (the
                   program's IMU state) is taken off (rad); the local
                   pose is the refined 2D pose embedded in 3D, times the
                   gravity alignment
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hgbench.lib.check import Check
from hgbench.reference import scan_2d as ref


def _qmul(a, b):
    """The product of two quaternions (w, x, y, z)."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw])


def _yaw(q) -> float:
    w, x, y, z = q
    return math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


class Gn2dCheck(Check):
    salt = 17

    def __init__(self, session):
        super().__init__(session, session.config["check"]["gn_2d_samples"])

    def install(self, robot):
        from hectorgrapher_tpu_torch.mapping import local_2d
        from hectorgrapher_tpu_torch.mapping.pose_extrapolator import PoseExtrapolator
        from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

        session, local = self.session, robot.local
        inner, inner_gravity, inner_add = (local_2d.match_gn_2d_probability,
                                           PoseExtrapolator.estimate_gravity_orientation, local.add_range_data)
        current = {}

        def gravity(extrapolator, time):
            current["gravity"] = q = inner_gravity(extrapolator, time)
            return q

        def match(grid, cloud, initial, target, w_o, w_t, w_r, num_iterations=20, prepared_field=None):
            pose, cost = inner(grid, cloud, initial, target, w_o, w_t, w_r, num_iterations=num_iterations,
                               prepared_field=prepared_field)
            if session.fault == "unchanged":
                pose = initial
            elif session.fault == "altered":
                pose = pose._replace(translation=pose.translation + torch.tensor([0.05, 0.0],
                                                                                 device=pose.translation.device))
            current["rec"] = self.sample.offer(lambda: dict(
                grid=grid, cloud=cloud, initial=initial, target=target, weights=(w_o, w_t, w_r),
                iterations=num_iterations, out=(pose, cost), gravity=np.array(current["gravity"], np.float64)))
            return pose, cost

        def add(data):
            result = inner_add(data)
            rec = current.pop("rec", None)
            if result is None:
                return result
            if session.fault == "writeback":  # the pose returned is not the one matched
                result.local_pose = NpRigid3(result.local_pose.t + np.array([0.01, 0.0, 0.0]), result.local_pose.q)
            if rec is not None:
                rec["returned"] = (result.local_pose.t.copy(), result.local_pose.q.copy())
            return result

        session.patch(PoseExtrapolator, "estimate_gravity_orientation", gravity)
        session.patch(local_2d, "match_gn_2d_probability", match)
        session.patch(local, "add_range_data", add)

    def numbers(self, control: bool) -> dict:
        out = dict(gn2d_cost_rel=0.0, gn2d_lm_excess=0.0, gn2d_pose_gap_m=0.0, gn2d_pose_gap_rad=0.0)
        for rec in self.sample.items:
            g, cloud = rec["grid"], rec["cloud"]
            w_o, w_t, w_r = rec["weights"]

            def problem(dtype):
                return ref.Match(ref.probability(g.log_odds, g.known, dtype), g.meta.min_corner.to(dtype),
                                 g.meta.resolution.to(dtype), cloud.positions[:, :2], cloud.mask,
                                 rec["target"], rec["initial"].angle.to(dtype), w_o, w_t, w_r)

            m64 = problem(torch.float64)
            x0 = torch.cat([rec["initial"].translation, rec["initial"].angle.reshape(1)]).double()
            if control:
                xc, c1 = problem(torch.bfloat16).solve(x0, rec["iterations"])
                got = xc.double()
            else:
                pose, c1 = rec["out"]
                got, c1 = torch.cat([pose.translation, pose.angle.reshape(1)]).double(), float(c1)
            start, at_got = m64.cost(x0), m64.cost(got)
            solved, best = m64.solve(x0, rec["iterations"])
            out["gn2d_cost_rel"] = max(out["gn2d_cost_rel"], abs(c1 - at_got) / at_got)
            out["gn2d_lm_excess"] = max(out["gn2d_lm_excess"], max(0.0, at_got - best) / start)
            if "returned" in rec:
                if control:  # the control's refinement, returned as the program's is
                    xy, yaw = got[:2].cpu().numpy(), float(got[2])
                else:
                    t, q = rec["returned"]
                    xy, yaw = t[:2], _yaw(_qmul(q, rec["gravity"] * np.array([1.0, -1.0, -1.0, -1.0])))
                solved = solved.double().cpu().numpy()
                turn = math.remainder(yaw - float(solved[2]), 2.0 * math.pi)
                out["gn2d_pose_gap_m"] = max(out["gn2d_pose_gap_m"], float(np.linalg.norm(xy - solved[:2])))
                out["gn2d_pose_gap_rad"] = max(out["gn2d_pose_gap_rad"], abs(turn))
        return out


make = Gn2dCheck
