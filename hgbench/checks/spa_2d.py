"""The 2D pose graph's optimizations of the timed window against the plain
reference (hgbench/reference/spa_2d.py).

Sampled from the seed among the window's optimizations: the problem as
the program assembled it from its graph (the reference follows it step
by step), and the program's answer, the optimized poses and their cost.
The reference evaluates the configured cost and solves from the same
start:

  spa_cost0_rel   |program's initial cost - the reference's| / the latter
  spa_cost_rel    |program's final cost - the reference's cost at the
                  program's poses| / the latter
  spa_lm_excess   (reference cost at the program's poses - at its own
                  solve) / its cost at the start, 0 where the program's
                  is lower
"""

from __future__ import annotations

import torch

from hgbench.lib.check import Check
from hgbench.reference import spa_2d as ref


class Spa2dCheck(Check):
    salt = 23

    def __init__(self, session):
        super().__init__(session, session.config["check"]["spa_2d_samples"])

    def install(self, robot):
        from hectorgrapher_tpu_torch.mapping.pose_graph import optimization
        from hectorgrapher_tpu_torch.mapping.pose_graph import pose_graph as pg_module

        session = self.session
        inner_full, inner_plain = pg_module.solve_spa_2d_full, pg_module.solve_spa_2d

        def record(problem, extras, iterations, sub, node, cost):
            cost0 = optimization.LAST_SOLVE_STATS.get("initial_cost")
            if session.fault == "unchanged":
                sub, node, cost = problem.submap_pose, problem.node_pose, cost0
            self.sample.offer(lambda: dict(problem=problem, extras=extras, iterations=iterations,
                                           out=(sub, node, cost, cost0)))
            return sub, node

        def full(problem, extras, num_iterations=20, init_lambda=1e-4):
            sub, node, lm, cost = inner_full(problem, extras, num_iterations=num_iterations, init_lambda=init_lambda)
            sub, node = record(problem, extras, num_iterations, sub, node, cost)
            return sub, node, lm, cost

        def plain(problem, num_iterations=20, init_lambda=1e-4, linear_solver="auto"):
            sub, node, cost = inner_plain(problem, num_iterations=num_iterations, init_lambda=init_lambda,
                                          linear_solver=linear_solver)
            sub, node = record(problem, None, num_iterations, sub, node, cost)
            return sub, node, cost

        session.patch(pg_module, "solve_spa_2d_full", full)
        session.patch(pg_module, "solve_spa_2d", plain)

    def numbers(self, control: bool) -> dict:
        out = dict(spa_cost0_rel=0.0, spa_cost_rel=0.0, spa_lm_excess=0.0)
        for rec in self.sample.items:
            spa = ref.Spa(rec["problem"], rec["extras"], torch.float64)
            x0 = spa.start()
            if control:
                sc = ref.Spa(rec["problem"], rec["extras"], torch.bfloat16)
                xc, c1 = sc.solve(sc.start(), rec["iterations"])
                got, c0 = xc.double(), sc.cost(sc.start())
            else:
                sub, node, c1, c0 = rec["out"]
                parts = [sub, node] + ([rec["extras"].landmark_pose] if rec["extras"] is not None else [])
                got = torch.cat([x.reshape(-1) for x in parts]).double()
                c1, c0 = float(c1), float(c0)
            start, at_got = spa.cost(x0), spa.cost(got)
            _, best = spa.solve(x0, rec["iterations"])
            out["spa_cost0_rel"] = max(out["spa_cost0_rel"], abs(c0 - start) / start)
            out["spa_cost_rel"] = max(out["spa_cost_rel"], abs(c1 - at_got) / at_got)
            out["spa_lm_excess"] = max(out["spa_lm_excess"], max(0.0, at_got - best) / start)
        return out


make = Spa2dCheck
