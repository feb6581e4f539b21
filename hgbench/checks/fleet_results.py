"""What each robot's stream delivered against what its builder produced
(hgbench/reference/fleet_results.py), over the whole run.

Each robot's trajectory builder in the server is watched where it hands
a local SLAM result to the server (its add_range_data); the run hands
over what each robot's ReceiveLocalSlamResults stream delivered to the
robot (readings["fleet_received"]). Compared, summed over the robots,
every one exact:

  fleet_results_lost          results produced and not delivered on the
                              robot's own stream
  fleet_results_foreign       items a robot's stream delivered that are
                              none of its own results, bit for bit
  fleet_results_out_of_order  results delivered after one its builder
                              produced later
"""

from __future__ import annotations

import threading

from hgbench.lib.check import Check
from hgbench.reference import fleet_results as ref


def _item(result):
    pose = result.local_pose
    return [float(result.time)] + [float(x) for x in pose.t] + [float(x) for x in pose.q]


class FleetResultsCheck(Check):
    salt = 17

    def __init__(self, session):
        super().__init__(session, 0)
        self.produced = {}
        self._lock = threading.Lock()

    def install(self, robot):
        tid, inner = robot.tid, robot.tb.add_range_data
        self.produced[tid] = []

        def add_range_data(data):
            result = inner(data)
            if result is not None:
                with self._lock:
                    self.produced[tid].append(_item(result))
            return result

        self.session.patch(robot.tb, "add_range_data", add_range_data)

    def numbers(self, control: bool) -> dict:
        received = self.session.readings.get("fleet_received", {})
        counts = ref.compare(self.produced, received, control)
        return {f"fleet_results_{k}": v for k, v in counts.items()}


make = FleetResultsCheck
