"""CSV logger of marginalized control points (counterpart of
hectorgrapher_tpu/mapping/ct/debug_logger.py: the same columns and number
formatting, over this package's ControlPoint).

(ref: cartographer/mapping/internal/3d/debug_logger.h — HectorGrapher's
DebugLogger writes each marginalized ControlPoint's state to test_log.csv
for offline analysis; constructed at
optimizing_local_trajectory_builder.cc:146.)
"""

from __future__ import annotations

import io
from typing import Optional


class DebugLogger:
    COLUMNS = [
        "time",
        "tx", "ty", "tz",
        "qw", "qx", "qy", "qz",
        "vx", "vy", "vz",
        "translation_ratio", "rotation_ratio", "time_ratio",
    ]

    def __init__(self, path: Optional[str] = None):
        self._file = open(path, "w") if path else io.StringIO()
        self._file.write(",".join(self.COLUMNS) + "\n")

    def add_entry(self, control_point) -> None:
        s = control_point.state
        row = [
            control_point.time,
            *s.translation,
            *s.rotation,
            *s.velocity,
            control_point.translation_ratio,
            control_point.rotation_ratio,
            control_point.time_ratio,
        ]
        self._file.write(",".join(f"{v}" for v in row) + "\n")

    def getvalue(self) -> str:
        if isinstance(self._file, io.StringIO):
            return self._file.getvalue()
        raise ValueError("file-backed logger; read the file instead")

    def close(self) -> None:
        if not isinstance(self._file, io.StringIO):
            self._file.close()
