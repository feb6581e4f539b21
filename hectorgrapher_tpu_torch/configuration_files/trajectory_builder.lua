-- GENERATED by hectorgrapher_tpu_torch.tools.generate_lua_defaults from the
-- typed defaults in hectorgrapher_tpu_torch/common/config.py. Do not hand-edit;
-- regenerate after changing the dataclasses.

include "trajectory_builder_2d.lua"
include "trajectory_builder_3d.lua"

TRAJECTORY_BUILDER = {
  trajectory_builder_2d = TRAJECTORY_BUILDER_2D,
  trajectory_builder_3d = TRAJECTORY_BUILDER_3D,
  collate_fixed_frame = true,
  collate_landmarks = false,
}
