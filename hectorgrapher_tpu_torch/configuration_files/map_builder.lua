-- GENERATED by hectorgrapher_tpu_torch.tools.generate_lua_defaults from the
-- typed defaults in hectorgrapher_tpu_torch/common/config.py. Do not hand-edit;
-- regenerate after changing the dataclasses.

include "pose_graph.lua"

MAP_BUILDER = {
  pose_graph = POSE_GRAPH,
  use_trajectory_builder_2d = false,
  use_trajectory_builder_3d = false,
  num_background_threads = 4,
  collate_by_trajectory = false,
}
