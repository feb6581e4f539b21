"""The occupancy insertions of the timed window against the plain reference
(hgbench/reference/insert_3d.py).

Sampled from the seed among the window's insertions: the range data the
program inserted and every active submap's two grids before and after.
The reference inserts the same range data into the grids as they were
before (a submap the insertion opened starts empty) and compares:

  insert_cells_differ  cells, over both grids of every sampled submap,
                       whose log-odds or known flag differ from the
                       program's (an exact comparison)
"""

from __future__ import annotations

import torch

from hgbench.lib.check import Check
from hgbench.reference import insert_3d as ref


class Insert3dCheck(Check):
    salt = 13

    def __init__(self, session):
        super().__init__(session, session.config["check"]["insert_samples"])

    def install(self, robot):
        subs = robot.local.active_submaps
        inner = subs.insert_data

        def insert_data(range_data, histogram, origin_local):
            before = {id(s): (s.high_resolution_grid, s.low_resolution_grid) for s in subs.submaps}
            out = inner(range_data, histogram, origin_local)
            self.sample.offer(lambda: dict(rd=range_data, pairs=[
                (before.get(id(s)), (s.high_resolution_grid, s.low_resolution_grid)) for s in out]))
            return out

        subs.insert_data = insert_data

    def numbers(self, control: bool) -> dict:
        sub = self.session.options.trajectory_builder_3d.submaps
        hi_max = float(sub.high_resolution_max_range)
        opts = [sub.high_resolution_range_data_inserter.probability_grid_range_data_inserter,
                sub.low_resolution_range_data_inserter.probability_grid_range_data_inserter]
        differ = 0
        for rec in self.sample.items:
            rd = rec["rd"]
            pts, valid, origin = rd.returns.positions, rd.returns.mask, rd.origin
            r = torch.linalg.vector_norm(pts - origin[None, :], dim=-1)
            for before, after in rec["pairs"]:
                for level, (got, o) in enumerate(zip(after, opts)):
                    if before is None:
                        log_odds, known = torch.zeros_like(got.log_odds), torch.zeros_like(got.known)
                    else:
                        log_odds, known = before[level].log_odds, before[level].known
                    ok = valid & (r <= hi_max) if level == 0 else valid
                    args = (log_odds, known, got.meta.min_corner, got.meta.resolution, origin, pts, ok,
                            o.hit_probability, o.miss_probability, int(o.num_free_space_voxels))
                    want = ref.insert(*args)
                    if control:
                        got_lo, got_known = ref.insert(*args, dtype=torch.bfloat16)
                    else:
                        got_lo, got_known = got.log_odds, got.known
                    differ += int(((got_lo != want[0]) | (got_known != want[1])).sum())
        return {"insert_cells_differ": differ}


make = Insert3dCheck
