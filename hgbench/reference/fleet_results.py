"""What each robot of a fleet should get back from a mapping server, from
what its own builder produced, written out plainly.

A robot's results (time, translation x y z, rotation w x y z) are due on
that robot's own stream, every one, each once, in the order its builder
produced them, bit for bit as produced. Over each robot:

  lost          results produced that its stream did not deliver
  foreign       items its stream delivered that are none of its results
                (another robot's, an altered or a repeated one)
  out_of_order  delivered results that came after one produced later

The control stands in for the server as a lower precision would: each
produced result delivered with its pose rounded through bfloat16.
"""

from __future__ import annotations

import torch


def _as_control(item):
    pose = torch.tensor(item[1:], dtype=torch.float64).to(torch.bfloat16).to(torch.float64)
    return [item[0]] + pose.tolist()


def compare(produced: dict, received: dict, control: bool = False) -> dict:
    """produced, received: {robot: [item, ...]}, each item a list of 8
    floats. Counts summed over the robots."""
    out = {"lost": 0, "foreign": 0, "out_of_order": 0}
    for robot in sorted(set(produced) | set(received)):
        mine = [list(map(float, x)) for x in produced.get(robot, [])]
        got = [list(map(float, x)) for x in received.get(robot, [])]
        if control:
            got = [_as_control(x) for x in mine]
        index = {}
        for i, item in enumerate(mine):
            index.setdefault(tuple(item), []).append(i)
        last = -1
        matched = 0
        for item in got:
            slots = index.get(tuple(item))
            if not slots:
                out["foreign"] += 1
                continue
            i = slots.pop(0)
            matched += 1
            if i < last:
                out["out_of_order"] += 1
            last = max(last, i)
        out["lost"] += len(mine) - matched
    return out
