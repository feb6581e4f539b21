"""Generate configuration_files/*.lua from the typed defaults (counterpart
of hectorgrapher_tpu/tools/generate_lua_defaults.py).

(ref: the reference ships hand-maintained configuration_files/*.lua —
map_builder.lua, pose_graph.lua, trajectory_builder{,_2d,_3d}.lua,
map_builder_server.lua — as the source of truth; here the typed dataclasses
in common/config.py are the source of truth and the Lua files are GENERATED
from them, so the two representations can never drift.)

Run: python -m hectorgrapher_tpu_torch.tools.generate_lua_defaults [outdir]
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any

HEADER = (
    "-- GENERATED by hectorgrapher_tpu_torch.tools.generate_lua_defaults from the\n"
    "-- typed defaults in hectorgrapher_tpu_torch/common/config.py. Do not hand-edit;\n"
    "-- regenerate after changing the dataclasses.\n\n"
)


def _lua_value(value: Any, indent: int) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        return f'"{value}"'
    if dataclasses.is_dataclass(value):
        return _lua_table(dataclasses.asdict(value), indent)
    if isinstance(value, dict):
        return _lua_table(value, indent)
    if isinstance(value, (list, tuple)):
        inner = ", ".join(_lua_value(v, indent + 1) for v in value)
        return "{ " + inner + " }"
    raise TypeError(f"no Lua rendering for {type(value)}: {value!r}")


def _lua_table(tree: dict, indent: int) -> str:
    pad = "  " * (indent + 1)
    lines = ["{"]
    for key, value in tree.items():
        if value is None:  # optional sub-configs default to absent
            continue
        lines.append(f"{pad}{key} = {_lua_value(value, indent + 1)},")
    lines.append("  " * indent + "}")
    return "\n".join(lines)


def generate(outdir: str) -> None:
    from hectorgrapher_tpu_torch.common import config as cfg

    mb = cfg.MapBuilderOptions()
    os.makedirs(outdir, exist_ok=True)

    def write(name: str, text: str) -> None:
        with open(os.path.join(outdir, name), "w") as f:
            f.write(HEADER + text)
        print(f"wrote {os.path.join(outdir, name)}")

    # pose_graph.lua (ref: configuration_files/pose_graph.lua)
    write("pose_graph.lua", f"POSE_GRAPH = {_lua_value(mb.pose_graph, 0)}\n")

    # trajectory_builder_2d.lua / _3d.lua
    write(
        "trajectory_builder_2d.lua",
        f"TRAJECTORY_BUILDER_2D = {_lua_value(mb.trajectory_builder_2d, 0)}\n",
    )
    write(
        "trajectory_builder_3d.lua",
        f"TRAJECTORY_BUILDER_3D = {_lua_value(mb.trajectory_builder_3d, 0)}\n",
    )

    # trajectory_builder.lua wires the per-dimension blocks + collate flags
    # (ref: configuration_files/trajectory_builder.lua).
    write(
        "trajectory_builder.lua",
        'include "trajectory_builder_2d.lua"\n'
        'include "trajectory_builder_3d.lua"\n\n'
        "TRAJECTORY_BUILDER = {\n"
        "  trajectory_builder_2d = TRAJECTORY_BUILDER_2D,\n"
        "  trajectory_builder_3d = TRAJECTORY_BUILDER_3D,\n"
        "  collate_fixed_frame = true,\n"
        "  collate_landmarks = false,\n"
        "}\n",
    )

    # map_builder.lua (ref: configuration_files/map_builder.lua).
    top = {
        f.name: getattr(mb, f.name)
        for f in dataclasses.fields(mb)
        if f.name not in ("pose_graph", "trajectory_builder_2d", "trajectory_builder_3d")
    }
    body = "\n".join(f"  {k} = {_lua_value(v, 1)}," for k, v in top.items())
    write(
        "map_builder.lua",
        'include "pose_graph.lua"\n\n'
        "MAP_BUILDER = {\n"
        "  pose_graph = POSE_GRAPH,\n" + body + "\n}\n",
    )

    # map_builder_server.lua: only the knobs this stack consumes
    # (cloud/server.py address, cloud/uploader.py batching)
    # (ref: configuration_files/map_builder_server.lua).
    write(
        "map_builder_server.lua",
        'include "map_builder.lua"\n'
        'include "trajectory_builder.lua"\n\n'
        "MAP_BUILDER_SERVER = {\n"
        "  map_builder = MAP_BUILDER,\n"
        '  server_address = "0.0.0.0:50051",\n'
        '  uplink_server_address = "",\n'
        "  upload_batch_size = 100,\n"
        "}\n",
    )


if __name__ == "__main__":
    default = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configuration_files")
    generate(sys.argv[1] if len(sys.argv) > 1 else default)
