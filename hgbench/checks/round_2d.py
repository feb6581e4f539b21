"""The 2D constraint rounds' searches of the timed window against the plain
reference (hgbench/reference/scan_2d.py).

Sampled from the seed among the candidates of the window's rounds
(batched, and serial where a round has one candidate): the finished submap's occupancy grid, the node's cloud, the
candidate's initial pose in the submap's frame and the round's search
window (angles, their step and the cell offsets: the program's state,
which the reference follows step by step), and the program's answer, the
best score and its pose. The reference derives the probabilities from
the grid's log-odds, searches the same window by the same top-k beam
(reference/scan_2d.py beam_search) and compares:

  round_score_gap   |program's score - the reference's score of the
                    program's pose|
  round_winner_gap  |the reference's score of its own answer - of the
                    program's|: the winner (a pose the program keeps
                    that the beam does not, its start say, scores lower;
                    two poses that tie score alike)
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from hgbench.lib.check import Check
from hgbench.reference import scan_2d as ref


class Round2dCheck(Check):
    salt = 19

    def __init__(self, session):
        super().__init__(session, session.config["check"]["round_2d_samples"])
        self._round = threading.local()

    def install(self, robot):
        """Sample the candidates of batched rounds (the round's search over
        the pack) and of serial ones (one candidate's search)."""
        from hectorgrapher_tpu_torch.mapping.pose_graph import pose_graph as pg_module

        session = self.session
        pg = robot.pose_graph
        inner_round, inner_one = pg._compute_constraints_batched, pg._compute_constraint
        inner_search, inner_match = pg_module.sharded_fast_matches_2d_packed, pg_module.match_fast_2d_prepared
        ctx = self._round

        def round_(gated, global_search=False):
            ctx.gated = gated
            try:
                return inner_round(gated, global_search=global_search)
            finally:
                ctx.gated = None

        def one(node, pg_submap, global_search=False):
            ctx.submap = pg_submap
            try:
                return inner_one(node, pg_submap, global_search=global_search)
            finally:
                ctx.submap = None

        def offer(pg_submap, cloud, initial, config, match):
            if session.fault == "start":  # the search keeps its start, with the start's own score
                g, f64 = pg_submap.submap.grid, torch.float64
                dev = g.log_odds.device
                xy = torch.as_tensor(initial.translation, device=dev).to(torch.float32)
                angle = torch.as_tensor(initial.angle, device=dev).to(torch.float32).reshape(())
                start = ref.score(ref.probability(g.log_odds, g.known, f64), g.meta.min_corner.to(f64),
                                  g.meta.resolution.to(f64), cloud.positions[:, :2], cloud.mask, xy.to(f64),
                                  float(angle))
                match = (torch.tensor(start, device=dev) if torch.is_tensor(match[0]) else start,
                         type(match[1])(translation=xy, angle=angle))
            self.sample.offer(lambda: dict(grid=pg_submap.submap.grid, cloud=cloud, initial=initial, config=config,
                                           out=match))
            return match

        def search(packed, candidates, config, profile=None, broadcast=None):
            matches = inner_search(packed, candidates, config, profile=profile, broadcast=broadcast)
            gated = getattr(ctx, "gated", None)
            if not gated:
                return matches
            return [offer(pg_submap, cloud, initial, config, match)
                    for (_, _, _, pg_submap), (_, cloud, initial), match in zip(gated, candidates, matches)]

        def match(prepared, cloud, initial, config):
            out = inner_match(prepared, cloud, initial, config)
            if getattr(ctx, "submap", None) is not None:
                out = offer(ctx.submap, cloud, initial, config, out)
            return out

        session.patch(pg, "_compute_constraints_batched", round_)
        session.patch(pg, "_compute_constraint", one)
        session.patch(pg_module, "sharded_fast_matches_2d_packed", search)
        session.patch(pg_module, "match_fast_2d_prepared", match)

    def numbers(self, control: bool) -> dict:
        out = dict(round_score_gap=0.0, round_winner_gap=0.0)
        for rec in self.sample.items:
            g, cloud, init, cfg = rec["grid"], rec["cloud"], rec["initial"], rec["config"]
            pts, valid = cloud.positions[:, :2], cloud.mask

            def window(dtype):
                prob = ref.probability(g.log_odds, g.known, dtype)
                args = (prob, g.meta.min_corner.to(dtype), g.meta.resolution.to(dtype), pts, valid)
                t = init.translation.cpu().numpy() if torch.is_tensor(init.translation) else init.translation
                xy = torch.as_tensor(np.asarray(t, np.float64), device=prob.device).to(dtype)
                return args, xy, float(init.angle)

            def search(dtype):
                args, xy, th = window(dtype)
                return ref.beam_search(*args, xy, th, cfg.num_angles, cfg.angle_step, cfg.linear_cells, cfg.depth,
                                       cfg.top_k)

            a64, _, _ = window(torch.float64)
            _, ref_xy, ref_th = search(torch.float64)
            if control:
                got_score, got_xy, got_th = search(torch.bfloat16)
                got_xy = got_xy.double()
            else:
                score, pose = rec["out"]
                got_score, got_xy, got_th = float(score), pose.translation.double(), float(pose.angle)
            at_got = ref.score(*a64, got_xy, got_th)
            out["round_score_gap"] = max(out["round_score_gap"], abs(got_score - at_got))
            out["round_winner_gap"] = max(out["round_winner_gap"], abs(ref.score(*a64, ref_xy, ref_th) - at_got))
        return out


make = Round2dCheck
