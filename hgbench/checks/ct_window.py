"""The CT window solves of the timed window against the plain reference
(hgbench/reference/ct_window.py).

Sampled from the seed among the window's solves, each solve is taken as
the program met it: its control points' times and starting states, the
clouds in the window and the matching submap's occupancy grids (the
program's state: the reference follows it step by step, see PERF.md).
The reference works out again what the program derived from the
generated inputs: the IMU rotations from the raw gyro samples, the
odometry terms and their adaptive weights from the raw odometry, each
cloud's bracket and factor, each cloud's scale, and the probability
field from the grid's log-odds. Then it compares, over the sample:

  window_points_foreign  window points (position and time) that are not
                         points of the scan they came from (the start:
                         the filters only keep points)
  ct_cost0_rel           |program's initial cost - reference's| / reference's
  ct_cost_rel            |program's final cost - the reference's cost at
                         the program's solved state| / the latter
  ct_lm_excess           (reference cost at the program's solved state -
                         at the reference's own solve from the same
                         start) / the initial cost, 0 where the program's
                         is lower
  ct_pose_gap_m          the returned local poses against the reference's
  ct_pose_gap_rad        solve: a scan's local pose is the window's first
                         control point, held in the solve and last moved
                         by the solve in which it was still free; where
                         that solve is a sampled one, the pose returned
                         for it against the reference's own solve of that
                         control point (translation in m, rotation in rad)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hgbench.lib.check import Check
from hgbench.lib.trace import span
from hgbench.reference import ct_window as ref


def _points_foreign(pts, times, on, raw_pts, raw_times, raw_on) -> int:
    """How many of the points (with their times) are not among the raw
    scan's, bit for bit."""
    have = np.concatenate([raw_pts[raw_on], raw_times[raw_on, None]], axis=1).astype(np.float32)
    want = np.concatenate([pts[on], times[on, None]], axis=1).astype(np.float32)
    if not len(want):
        return 0
    key = lambda a: np.ascontiguousarray(a).view(np.dtype((np.void, 16))).ravel()
    return int((~np.isin(key(want), key(have))).sum())


def _angle(qa, qb) -> float:
    """The angle (rad) of the rotation between two quaternions (w, x, y, z)."""
    d = ref.qmul(ref.qconj(torch.as_tensor(qa, dtype=torch.float64)), torch.as_tensor(qb, dtype=torch.float64))
    return 2.0 * math.atan2(float(torch.linalg.norm(d[1:])), abs(float(d[0])))


class CtWindowCheck(Check):
    salt = 11

    def __init__(self, session):
        super().__init__(session, session.config["check"]["ct_window_samples"])

    def install(self, robot):
        """Sample the robot's window solves through its builder's hook, and
        follow each solved control point to the scan whose local pose it
        becomes."""
        from hectorgrapher_tpu_torch.mapping.ct import builder as bmod
        from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3

        session, local = self.session, robot.local
        last = {}  # control point time -> (the record of the last solve that moved it, or None; its index)
        current = {}

        def solve(pending):
            with span("ct_solve"), session.timed("ct_solve"):
                state, cost, cost0 = bmod.solve_ct_window(
                    pending.high_grid, pending.low_grid, pending.problem, pending.state0, pending.weights,
                    is_tsdf=pending.is_tsdf, num_iterations=pending.num_iterations, per_point=pending.per_point,
                    direct=pending.direct)
            state, cost = self._faulty(pending.state0, state, cost, cost0)
            current["rec"] = self._offer(robot, pending, state, cost, cost0)
            return state

        inner_apply, inner_add = local._apply_window_solution, local.add_range_data

        def apply(pending, solved):
            inner_apply(pending, solved)
            rec = current.pop("rec", None)
            for j, cp in enumerate(pending.cps[1:pending.k], start=1):  # control point 0 is held
                last[cp.time] = (rec, j)

        def add(data):
            result = inner_add(data)
            if result is None:
                return result
            if session.fault == "writeback":  # the pose returned is not the one solved
                result.local_pose = NpRigid3(result.local_pose.t + np.array([0.01, 0.0, 0.0]), result.local_pose.q)
            rec, j = last.pop(result.time, (None, 0))
            if rec is not None:
                rec["returned"] = (j, result.local_pose.t.copy(), result.local_pose.q.copy())
            return result

        local.window_solve_fn = solve
        session.patch(local, "_apply_window_solution", apply)
        session.patch(local, "add_range_data", add)

    def _faulty(self, state0, state, cost, cost0):
        """The answer as a broken path would give it (tests)."""
        if self.session.fault == "unchanged":
            return state0, cost0
        if self.session.fault == "altered":
            return state._replace(translation=state.translation + torch.tensor(
                [0.05, 0.0, 0.0], device=state.translation.device)), cost
        return state, cost

    def _offer(self, robot, pending, state, cost, cost0):
        """Offer the solve to the sample; its record where kept."""
        submap = robot.local.active_submaps.matching_submap
        return self.sample.offer(lambda: dict(
            cp_t=np.array([cp.time for cp in pending.cps[:pending.k]], np.float64), k=pending.k,
            problem=pending.problem, state0=pending.state0, iterations=pending.num_iterations,
            out=(state, cost, cost0), grids=(submap.high_resolution_grid, submap.low_resolution_grid),
            scan_t=robot.local._clouds[-1].time, robot=robot))

    def _options(self):
        o = self.session.options.trajectory_builder_3d.optimizing_local_trajectory_builder
        names = ("high_resolution_grid_weight", "low_resolution_grid_weight", "translation_weight",
                 "velocity_weight", "rotation_weight", "odometry_translation_weight", "odometry_rotation_weight",
                 "odometry_translation_normalization", "odometry_rotation_normalization")
        if not o.use_adaptive_odometry_weights or o.imu_cost_term != "PREINTEGRATION" or o.use_per_point_unwarping:
            raise ValueError("the CT reference covers adaptive odometry weights and the preintegrated IMU term "
                             "with per-cloud poses")
        return {n: float(getattr(o, n)) for n in names}

    def numbers(self, control: bool) -> dict:
        opts = self._options()
        out = dict(window_points_foreign=0, ct_cost0_rel=0.0, ct_cost_rel=0.0, ct_lm_excess=0.0, ct_pose_gap_m=0.0,
                   ct_pose_gap_rad=0.0)
        for rec in self.sample.items:
            stream, k, pb = rec["robot"].raw_stream(), rec["k"], rec["problem"]
            dev = pb.hi_points.device
            on = pb.cloud_mask.cpu().numpy()
            cloud_t = rec["cp_t"][0] + pb.cloud_time.cpu().numpy().astype(np.float64)[on]
            scan_idx = [int(np.argmin(np.abs(stream.scan_t - t))) for t in cloud_t]
            cloud_t = stream.scan_t[scan_idx]
            cols = [x[torch.as_tensor(on, device=dev)] for x in
                    (pb.hi_points, pb.hi_mask, pb.hi_times, pb.lo_points, pb.lo_mask, pb.lo_times)]
            hi_p, hi_on, hi_t, lo_p, lo_on, lo_t = cols
            if control:  # the reference's own points, kept in bfloat16
                hi_p, lo_p = (x.to(torch.bfloat16).to(torch.float32) for x in (hi_p, lo_p))
            for c, i in enumerate(scan_idx):
                _, raw, raw_t, raw_on = stream.scan(i)
                for p, m, t in ((hi_p, hi_on, hi_t), (lo_p, lo_on, lo_t)):
                    out["window_points_foreign"] += _points_foreign(
                        p[c].cpu().numpy(), t[c].cpu().numpy(), m[c].cpu().numpy(), raw, raw_t, raw_on)
            # The samples handed before the scan that triggered the solve.
            n_imu = int(np.searchsorted(stream.imu_t, rec["scan_t"], side="right"))
            n_odom = int(np.searchsorted(stream.odom_t, rec["scan_t"], side="right"))
            w = ref.build_window(rec["cp_t"], cloud_t, hi_p, hi_on, lo_p, lo_on, stream.imu_t[:n_imu],
                                 stream.imu_gyro[:n_imu], stream.odom_t[:n_odom], stream.odom_xyz[:n_odom],
                                 stream.odom_q[:n_odom], opts, dev)
            hi_g, lo_g = rec["grids"]
            parts = [(g.log_odds, g.known, g.meta.min_corner, g.meta.resolution) for g in (hi_g, lo_g)]
            g64 = ref.Grids(*parts, torch.float64)
            s0 = rec["state0"]
            start = tuple(x[:k].double() for x in (s0.translation, s0.rotation, s0.velocity))
            if control:
                gc = ref.Grids(*parts, torch.bfloat16)
                st, c1, c0 = ref.solve(w, gc, tuple(x.to(torch.bfloat16) for x in start), rec["iterations"])
                got = tuple(x.double() for x in st)
            else:
                st, c1, c0 = rec["out"]
                got = tuple(x[:k].double() for x in (st.translation, st.rotation, st.velocity))
                c1, c0 = float(c1), float(c0)
            ref0 = ref.cost(w, g64, start)
            at_got = ref.cost(w, g64, got)
            solved, best, _ = ref.solve(w, g64, start, rec["iterations"])
            out["ct_cost0_rel"] = max(out["ct_cost0_rel"], abs(c0 - ref0) / ref0)
            out["ct_cost_rel"] = max(out["ct_cost_rel"], abs(c1 - at_got) / at_got)
            out["ct_lm_excess"] = max(out["ct_lm_excess"], max(0.0, at_got - best) / ref0)
            if "returned" in rec:
                j, t_ret, q_ret = rec["returned"]
                if control:  # the control's solve, written back as the program's is
                    t_ret, q_ret = got[0][j].cpu().numpy(), got[1][j].cpu().numpy()
                t_ref, q_ref = solved[0][j].cpu().numpy(), solved[1][j].cpu().numpy()
                out["ct_pose_gap_m"] = max(out["ct_pose_gap_m"], float(np.linalg.norm(t_ret - t_ref)))
                out["ct_pose_gap_rad"] = max(out["ct_pose_gap_rad"], _angle(q_ret, q_ref))
        return out


make = CtWindowCheck
