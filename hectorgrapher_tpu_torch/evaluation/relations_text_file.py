"""TORO-style relations text I/O (counterpart of
hectorgrapher_tpu/evaluation/relations_text_file.py).

(ref: cartographer/ground_truth/relations_text_file.{h,cc} — lines of
`time1 time2 x y z roll pitch yaw` describing expected relative poses,
the Freiburg relation-metric exchange format.)
"""

from __future__ import annotations

from typing import List

import numpy as np

from hectorgrapher_tpu_torch.evaluation.metrics import Relation
from hectorgrapher_tpu_torch.transform import np_quat as nq
from hectorgrapher_tpu_torch.transform.np_quat import NpRigid3


def _rpy_to_quat(roll: float, pitch: float, yaw: float) -> np.ndarray:
    qz = nq.quat_from_axis_angle(np.array([0.0, 0.0, yaw]))
    qy = nq.quat_from_axis_angle(np.array([0.0, pitch, 0.0]))
    qx = nq.quat_from_axis_angle(np.array([roll, 0.0, 0.0]))
    return nq.quat_multiply(qz, nq.quat_multiply(qy, qx))


def _quat_to_rpy(q: np.ndarray):
    w, x, y, z = q
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def write_relations_text_file(path: str, relations: List[Relation]) -> None:
    with open(path, "w") as f:
        for r in relations:
            roll, pitch, yaw = _quat_to_rpy(r.expected.q)
            t = r.expected.t
            f.write(
                f"{r.time1} {r.time2} {t[0]} {t[1]} {t[2]} {roll} {pitch} {yaw}\n"
            )


def read_relations_text_file(path: str) -> List[Relation]:
    relations = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 8:
                continue
            t1, t2, x, y, z, roll, pitch, yaw = map(float, parts)
            relations.append(
                Relation(t1, t2, NpRigid3(np.array([x, y, z]), _rpy_to_quat(roll, pitch, yaw)))
            )
    return relations
