-- GENERATED by hectorgrapher_tpu_torch.tools.generate_lua_defaults from the
-- typed defaults in hectorgrapher_tpu_torch/common/config.py. Do not hand-edit;
-- regenerate after changing the dataclasses.

TRAJECTORY_BUILDER_2D = {
  use_imu_data = true,
  min_range = 0.0,
  max_range = 30.0,
  min_z = -0.8,
  max_z = 2.0,
  missing_data_ray_length = 5.0,
  num_accumulated_range_data = 1,
  voxel_filter_size = 0.025,
  adaptive_voxel_filter = {
    max_length = 0.5,
    min_num_points = 200,
    max_range = 50.0,
  },
  loop_closure_adaptive_voxel_filter = {
    max_length = 0.9,
    min_num_points = 100,
    max_range = 50.0,
  },
  use_online_correlative_scan_matching = false,
  real_time_correlative_scan_matcher = {
    linear_search_window = 0.1,
    angular_search_window = 0.3490658503988659,
    translation_delta_cost_weight = 0.1,
    rotation_delta_cost_weight = 0.1,
  },
  ceres_scan_matcher = {
    occupied_space_weight = 1.0,
    translation_weight = 10.0,
    rotation_weight = 40.0,
    ceres_solver_options = {
      use_nonmonotonic_steps = false,
      max_num_iterations = 20,
      num_threads = 1,
    },
  },
  motion_filter = {
    max_time_seconds = 5.0,
    max_distance_meters = 0.2,
    max_angle_radians = 0.017453292519943295,
  },
  imu_gravity_time_constant = 10.0,
  submaps = {
    num_range_data = 90,
    grid_options_2d = {
      grid_type = "PROBABILITY_GRID",
      resolution = 0.05,
    },
    range_data_inserter = {
      range_data_inserter_type = "PROBABILITY_GRID_INSERTER_2D",
      probability_grid_range_data_inserter = {
        insert_free_space = true,
        hit_probability = 0.55,
        miss_probability = 0.49,
      },
      tsdf_range_data_inserter = {
        truncation_distance = 0.3,
        maximum_weight = 10.0,
        update_free_space = false,
        normal_estimation_options = {
          num_normal_samples = 4,
          sample_radius = 0.5,
        },
        project_sdf_distance_to_scan_normal = true,
        update_weight_range_exponent = 0,
        update_weight_angle_scan_normal_to_ray_kernel_bandwidth = 0.5,
        update_weight_distance_cell_to_hit_kernel_bandwidth = 0.5,
      },
    },
    grid_size = 512,
    grid_storage_dtype = "float32",
  },
  max_num_points = 2048,
}
