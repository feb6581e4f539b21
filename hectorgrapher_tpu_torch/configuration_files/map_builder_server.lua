-- GENERATED by hectorgrapher_tpu_torch.tools.generate_lua_defaults from the
-- typed defaults in hectorgrapher_tpu_torch/common/config.py. Do not hand-edit;
-- regenerate after changing the dataclasses.

include "map_builder.lua"
include "trajectory_builder.lua"

MAP_BUILDER_SERVER = {
  map_builder = MAP_BUILDER,
  server_address = "0.0.0.0:50051",
  uplink_server_address = "",
  upload_batch_size = 100,
}
