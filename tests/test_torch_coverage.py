"""The coverage map: every test function of the JAX suite and the port test
that holds the same path against the reference, or why none applies.

``COVERAGE`` maps each ``def test_*`` of the 22 JAX test files
(``tests/test_*.py`` without ``torch``) to ``"test_torch_<x>.py::<name>"``,
a port test that runs the same function or path, or to ``"none: <why>"``.
Both sides are read with ``ast``: the test fails on a JAX test missing from
the map, on a name in the map that is no JAX test, and on a port test named
that does not exist.  Add a JAX test, and this asks where the port holds it.
"""
import ast
import os

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))

COVERAGE = {
    "test_aux.py": {
        "test_gnss_to_xyz_scale": "test_torch_parity_copies.py::test_copy_matches_original",
        "test_gnss_track": "test_torch_parity_copies.py::test_copy_matches_original",
        "test_checkpoint_roundtrip": "test_torch_checkpoint.py::test_round_trip_bit_exact",
        "test_resume_continues_identically":
            "test_torch_audit_gaps.py::test_resume_continues_identically",
        "test_localization_mode_freezes_map":
            "test_torch_checkpoint.py::test_localize_restores_the_saved_map",
        "test_global_map_and_pcd": "test_torch_export.py::test_global_map_same_points",
        "test_loop_edges_empty": "test_torch_audit_gaps.py::test_loop_edges_empty",
        "test_compose_map_pose": "test_torch_aux.py::test_compose_map_pose",
        "test_profiling_tools": "test_torch_aux.py::test_profiling_tools",
        "test_init_pose_config": "test_torch_aux.py::test_init_pose_config",
        "test_mapping_skip_frame": "test_torch_slam.py::test_mapping_skip_frame",
        "test_keyframe_pcd_dump": "test_torch_export.py::test_loop_edges_and_keyframe_pcds",
        "test_slam_system_with_loops": "test_torch_loop.py::test_slam_system_closes_a_loop",
        "test_expected_ground_ranges_per_sensor": "test_torch_config.py::test_validation_matches",
        "test_corridor_world_clutter_options":
            "test_torch_audit_gaps.py::test_corridor_world_clutter_options",
        "test_sp_shards_divisibility_validated": "test_torch_config.py::test_validation_matches",
        "test_viz_html": "test_torch_io.py::test_render_html_same_string",
        "test_viz_write_viewer": "test_torch_export.py::test_write_viewer",
    },
    "test_cli.py": {
        "test_kitti_bin_roundtrip": "test_torch_io.py::test_kitti_scan_to_cloud",
        "test_kitti_sequence_runs": "test_torch_cli_modes.py::test_cli_kitti",
        "test_cli_synthetic": "test_torch_cli_modes.py::test_cli_synthetic_preint_viz_every",
        "test_cli_ckpt_roundtrip": "test_torch_cli.py::test_cli_localize_keeps_the_map",
        "test_cli_fleet_mode": "test_torch_cli_fleet.py::test_cli_fleet_chunked",
        "test_cli_fleet_with_loops": "test_torch_cli_fleet_loops.py::test_cli_fleet_chunked_loops",
        "test_cli_fleet_rejects_unsupported_flags":
            "test_torch_cli_modes.py::test_cli_fleet_rejects_flag",
        "test_chunked_system_matches_sequential":
            "test_torch_chunk.py::test_chunked_bit_equal_to_unchunked",
    },
    "test_features.py": {
        "test_organize_ring_major": "test_torch_features.py::test_extract_features_debug_matches",
        "test_extract_runs_and_shapes":
            "test_torch_features.py::test_extract_features_debug_matches",
        "test_ground_plane_quality": "test_torch_features.py::test_extract_features_debug_matches",
        "test_features_on_structure": "test_torch_features.py::test_extract_features_debug_matches",
        "test_feature_determinism": "test_torch_audit_gaps.py::test_feature_determinism",
        "test_eigh3x3_matches_lapack": "test_torch_features.py::test_eigh3x3_and_regularizers",
        "test_plane_regularize": "test_torch_features.py::test_eigh3x3_and_regularizers",
        "test_vmap_extract": "test_torch_fleet.py::test_fleet_lanes_match_single_streams",
    },
    "test_features_sp.py": {
        "test_features_sp_matches_replicated": "test_torch_features_sp.py::test_features_sp_matches_jax",
        "test_features_sp_rbf_covariances":
            "test_torch_features_sp.py::test_features_sp_rbf_covariances",
        "test_sp_features_requires_divisible_caps":
            "test_torch_features_sp.py::test_features_sp_rejects_bad_shards",
        "test_features_sp_rejects_axis_size_mismatch":
            "test_torch_features_sp.py::test_features_sp_rejects_bad_shards",
        "test_fleet_distributed_step_with_sp_features":
            "test_torch_distributed.py::test_distributed_step_2x2",
        "test_features_sp_degenerate_scans":
            "test_torch_features_sp.py::test_features_sp_degenerate_scans",
        "test_fleet_sp_features_indivisible_falls_back":
            "test_torch_features_sp.py::test_sp_plan_fallbacks",
        "test_slam_step_with_sp_features": "test_torch_distributed.py::test_slam_step_sp_features",
    },
    "test_fleet.py": {
        "test_vmap_fleet_matches_single": "test_torch_fleet.py::test_fleet_lanes_match_single_streams",
        "test_sharded_fleet_on_virtual_mesh": "test_torch_distributed.py::test_distributed_step_2x2",
        "test_compact_fleet_evicts_only_at_capacity":
            "test_torch_fleet.py::test_compact_fleet_matches_jax",
        "test_fleet_step_compacting_device_gate": "test_torch_fleet.py::test_fleet_step_compacting",
        "test_compact_fleet_if_needed_gates_dispatch":
            "test_torch_fleet.py::test_fleet_step_compacting",
        "test_fleet_loop_closure_distinct_streams":
            "test_torch_fleet_loop.py::test_fleet_loop_step_mixed_lanes",
        "test_fused_chunk_matches_per_dispatch":
            "test_torch_fleet_loop.py::test_fleet_chunk_step_matches_per_dispatch",
        "test_fused_chunk_exact_cadence_selection":
            "test_torch_fleet_loop.py::test_needs_exact_cadence_matches_jax",
        "test_chunk_exceeding_margin_rejected":
            "test_torch_checkpoint.py::test_chunk_value_errors_as_jax",
    },
    "test_gicp_variants.py": {
        "test_gicp_register": "test_torch_gicp.py::test_registration_matches",
        "test_ndt_register": "test_torch_gicp_variants.py::test_ndt_register_matches",
        "test_ndt_modes_agree": "test_torch_gicp_variants.py::test_ndt_register_matches",
        "test_rbf_covariances_oracle": "test_torch_rbf.py::test_rbf_covariances_full_cloud",
        "test_rbf_covariances_feed_registration": "test_torch_rbf.py::test_slam_steps_rbf",
        "test_gicp_mp_register": "test_torch_gicp_variants.py::test_gicp_mp_register_matches",
        "test_gicp_mp_empty_overlap":
            "test_torch_gicp_variants.py::test_gicp_mp_empty_overlap_matches",
        "test_cov_regularization_modes": "test_torch_features.py::test_eigh3x3_and_regularizers",
        "test_knn_covariances_plane": "test_torch_gicp.py::test_knn_covariances_match",
        "test_imu_preint_residual_zero_at_truth":
            "test_torch_audit_gaps.py::test_imu_preint_residual_zero_at_truth",
        "test_misc_factor_residuals": "test_torch_factors.py::test_library_residuals_match",
        "test_edge_factor_matches_geometry": "test_torch_factors.py::test_residuals_match",
        "test_p2plane_register": "test_torch_gicp.py::test_registration_matches",
        "test_loop_plane_method_compiles":
            "test_torch_audit_gaps.py::test_loop_plane_method_on_an_empty_store",
        "test_plane_normals_on_wall": "test_torch_gicp.py::test_plane_normals_match_up_to_sign",
    },
    "test_graft_entry.py": {
        "test_entry_compiles_and_runs": "test_torch_graft_entry.py::test_entry_step_matches_jax",
        "test_dryrun_multichip_8": "test_torch_graft_entry.py::test_dryrun_multichip_on_cpu_ranks",
    },
    "test_imu_preint.py": {
        "test_full_matches_mean_only":
            "test_torch_properties.py::test_preintegration_cov_psd_and_mean_parity",
        "test_covariance_matches_monte_carlo":
            "test_torch_imu_preint.py::test_preintegrate_full_matches",
        "test_bias_jacobian_first_order":
            "test_torch_imu_preint.py::test_bias_corrected_delta_matches",
        "test_rotation_variance_sets_delta_r_weight":
            "test_torch_audit_gaps.py::test_rotation_variance_sets_delta_r_weight",
        "test_odometry_preint_cov_mode_tracks":
            "test_torch_imu_preint.py::test_odometry_step_preint_matches",
    },
    "test_loop.py": {
        "test_icp_point2point_recovers_transform": "test_torch_loop.py::test_icp_point2point_matches",
        "test_pgo_removes_drift": "test_torch_loop.py::test_pgo_solve_matches",
        "test_loop_slot_eviction_policy": "test_torch_loop.py::test_choose_loop_slot_matches",
        "test_loop_closure_end_to_end": "test_torch_loop.py::test_loop_closure_step_matches",
        "test_loop_gicp_method_compiles": "test_torch_gicp.py::test_registration_matches",
        "test_loops_survive_keyframe_compaction": "test_torch_loop.py::test_maybe_compact_matches",
    },
    "test_mapping.py": {
        "test_mapping_improves_or_matches_odometry": "test_torch_slam.py::test_sequence_tracks_jax",
        "test_keyframes_accumulate":
            "test_torch_slam.py::test_keyframes_accumulate_and_travel_monotone",
        "test_travel_distance_monotone":
            "test_torch_slam.py::test_keyframes_accumulate_and_travel_monotone",
        "test_compact_keyframe_store_unit":
            "test_torch_mapping.py::test_compact_keyframe_store_matches",
        "test_eviction_no_loop_long_run":
            "test_torch_eviction_long_run.py::test_eviction_no_loop_long_run",
    },
    "test_math3d.py": {
        "test_quat_mul_rotate_consistency": "test_torch_math3d.py::test_quat_mul_rotate",
        "test_quat_mat_roundtrip": "test_torch_math3d.py::test_mat_ypr_roundtrips",
        "test_quat_rotate_matches_matrix": "test_torch_math3d.py::test_quat_mul_rotate",
        "test_exp_log_roundtrip": "test_torch_properties.py::test_exp_log_inverse",
        "test_exp_small_angle": "test_torch_math3d.py::test_quat_exp_so3",
        "test_ypr_roundtrip": "test_torch_math3d.py::test_mat_ypr_roundtrips",
        "test_se3_compose_inverse": "test_torch_math3d.py::test_angle_wraps_and_se3",
        "test_slerp_endpoints": "test_torch_math3d.py::test_slerp_axis_angle_skew",
        "test_skew_cross": "test_torch_math3d.py::test_slerp_axis_angle_skew",
    },
    "test_odometry.py": {
        "test_deskew_roundtrip": "test_torch_odometry.py::test_deskew_points_matches",
        "test_preintegration_constant_rotation":
            "test_torch_imu.py::test_preintegrate_and_gravity_init",
        "test_odometry_tracks_trajectory":
            "test_torch_odometry.py::test_odometry_step_matches_per_scan",
        "test_odometry_no_imu":
            "test_torch_stress_configs.py::test_kitti_style_64beam_no_imu_no_ground",
        "test_static_bias_estimation": "test_torch_imu.py::test_static_bias",
        "test_check_static": "test_torch_imu.py::test_static_bias",
        "test_bias_init_wired_bounds_yaw_drift":
            "test_torch_audit_gaps.py::test_bias_init_bounds_yaw_drift",
        "test_gravity_init_alignment_applied":
            "test_torch_imu.py::test_preintegrate_and_gravity_init",
        "test_gravity_alignment_noop_on_level_ground":
            "test_torch_odometry.py::test_odometry_step_matches_per_scan",
    },
    "test_oracle.py": {
        "test_picker_matches_oracle_sets":
            "test_torch_features.py::test_extract_features_debug_matches",
        "test_picker_downstream_ate_parity":
            "none: it runs JAX's odometry on the numpy oracle's picks against its own "
            "picks; the port's picks equal JAX's exactly "
            "(test_torch_features.py::test_extract_features_debug_matches) and its oracle "
            "copy equals the original (test_torch_parity_copies.py), so the comparison "
            "is the JAX test's own",
    },
    "test_pallas_knn.py": {
        "test_matches_xla_reference": "test_torch_knn_cuda.py::test_kernel_matches_plain",
        "test_all_masked": "test_torch_knn.py::test_all_masked_and_too_few_points",
        "test_supported_gate": "test_torch_knn.py::test_dispatch_cpu_and_wrapper_guards",
    },
    "test_parity_oracles.py": {
        name: "test_torch_parity_oracles.py::test_port_meets_oracle_gate"
        for name in ("test_ground_fit_parity", "test_complementary_filter_parity",
                     "test_vgicp_linearize_parity", "test_lm_schedule_parity",
                     "test_fourdof_residual_parity", "test_pgo_solve_parity",
                     "test_mapping_solve_parity", "test_odometry_fusion_parity",
                     "test_loop_icp_parity", "test_rel_time_matches_reference_machine",
                     "test_deskew_parity")
    },
    "test_properties.py": {
        name: f"test_torch_properties.py::{name}"
        for name in ("test_exp_log_inverse", "test_rotation_preserves_norm",
                     "test_compose_associative_on_points", "test_ypr_matrix_roundtrip",
                     "test_voxelhash_claiming_invariants", "test_eigh3x3_reconstruction",
                     "test_preintegration_cov_psd_and_mean_parity",
                     "test_pgo_pin_and_chain_consistency")
    },
    "test_registration.py": {
        "test_vgicp_recovers_pose": "test_torch_registration_pair.py::test_lm_register_on_the_scan_pair",
        "test_vgicp_identity_stays_put":
            "test_torch_registration_pair.py::test_lm_register_on_the_scan_pair",
        "test_vgicp_converges_from_bad_guess":
            "test_torch_registration_pair.py::test_lm_register_on_the_scan_pair",
        "test_linearize_gradient_matches_autodiff":
            "test_torch_registration.py::test_vgicp_linearize_matches",
        "test_direct7_neighbors": "test_torch_registration.py::test_vgicp_linearize_matches",
    },
    "test_robustness.py": {
        "test_empty_and_garbage_scans_mid_run":
            "test_torch_robustness.py::test_empty_and_garbage_scans_mid_run",
        "test_out_of_order_and_duplicate_imu_stamps":
            "test_torch_robustness.py::test_out_of_order_and_duplicate_imu_stamps",
        "test_backwards_scan_stamps": "test_torch_robustness.py::test_backwards_scan_stamps",
        "test_all_ground_scan": "test_torch_robustness_fleet.py::test_all_ground_scan",
        "test_fleet_zero_feature_robot": "test_torch_robustness_fleet.py::test_fleet_zero_feature_robot",
        "test_empty_imu_batch_mid_run": "test_torch_robustness_fleet.py::test_empty_imu_batch_mid_run",
    },
    "test_rosbag.py": {
        **{name: "test_torch_io.py::test_rosbag_same_bytes_and_scans"
           for name in ("test_bag_roundtrip", "test_bag_bz2_chunks", "test_bag_header_indexed",
                        "test_index_offsets_point_at_messages", "test_bag_lz4_chunks")},
        "test_bag_channel_fallbacks": "test_torch_io.py::test_channel_fallbacks_same_arrays",
        "test_lz4_frame_blocks_fit_declared_bd": "test_torch_io.py::test_lz4_same_bytes",
        **{name: "test_torch_io_malformed.py::test_same_outcome_in_both_packages"
           for name in ("test_bag_to_sweeplog", "test_navsatfix_decode",
                        "test_ring_exceeding_config_raises", "test_ring32_with_matching_config",
                        "test_lz4_block_and_frame_unit", "test_lz4_legacy_truncated_block_raises",
                        "test_lz4_malformed_length_run",
                        "test_bag_corrupt_lz4_chunk_stops_cleanly", "test_bag_truncated_tail",
                        "test_bag_unchunked_toplevel_messages",
                        "test_bag_duplicate_latched_connections", "test_bag_bigendian_rejected",
                        "test_pointcloud2_misaligned_fields", "test_bag_truncation_fuzz_sweep",
                        "test_bag_byteflip_fuzz_sweep")},
    },
    "test_runtime.py": {
        "test_build_and_roundtrip": "test_torch_io.py::test_sweeplog_same_bytes_and_scans",
        "test_reader_without_prefetch": "test_torch_io.py::test_sweeplog_same_bytes_and_scans",
        "test_feeds_pipeline": "test_torch_cli.py::test_cli_matches_jax",
        "test_pcd_sink_async_roundtrip": "test_torch_io.py::test_pcd_sink_and_write_pcd_same_bytes",
        "test_pcd_sink_empty_frame": "test_torch_audit_gaps.py::test_pcd_sink_empty_frame",
    },
    "test_stress_configs.py": {
        "test_ring_binning_16_matches_generator":
            "test_torch_io.py::test_channel_fallbacks_same_arrays",
        "test_ring_binning_64_produces_plausible_rings":
            "test_torch_io.py::test_channel_fallbacks_same_arrays",
        "test_kitti_style_64beam_no_imu_no_ground":
            "test_torch_stress_configs.py::test_kitti_style_64beam_no_imu_no_ground",
        "test_degraded_corridor_intensity_injection":
            "test_torch_stress_configs_corridor.py::test_corridor_full_slam_survives",
        "test_corridor_full_slam_survives":
            "test_torch_stress_configs_corridor.py::test_corridor_full_slam_survives",
        "test_corridor_l1_loss_rescues":
            "test_torch_stress_configs_corridor.py::test_corridor_l1_loss_rescues",
        "test_32beam_pipeline": "test_torch_stress_configs.py::test_32beam_pipeline",
        "test_ground_change_machine_on_ramp":
            "test_torch_stress_configs_ramp.py::test_ground_change_machine_on_ramp",
    },
    "test_voxelhash.py": {
        "test_pack_unique": "test_torch_voxelhash.py::test_pack_coords_and_bins",
        "test_pack_out_of_range": "test_torch_audit_gaps.py::test_pack_out_of_range_and_empty_downsample",
        "test_build_and_lookup": "test_torch_voxelhash.py::test_build_hash_table_and_lookup_exact",
        "test_voxel_downsample_centroids": "test_torch_voxelhash.py::test_voxel_downsample",
        "test_voxel_downsample_invalid_excluded":
            "test_torch_audit_gaps.py::test_pack_out_of_range_and_empty_downsample",
        "test_gaussian_voxelmap_stats":
            "test_torch_voxelhash.py::test_build_gaussian_voxelmap_and_lookup",
        "test_hash_table_jit_and_vmap": "test_torch_audit_gaps.py::test_hash_table_under_vmap",
    },
}


def _tests_in(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name.startswith("test_")}


def _jax_files() -> list:
    return sorted(f for f in os.listdir(TESTS)
                  if f.startswith("test_") and f.endswith(".py") and "torch" not in f)


def test_every_jax_test_file_is_mapped():
    assert len(_jax_files()) == 22
    assert sorted(COVERAGE) == _jax_files()


@pytest.mark.parametrize("jax_file", sorted(COVERAGE))
def test_every_jax_test_maps_to_a_port_test_or_a_reason(jax_file):
    mapped = COVERAGE[jax_file]
    tests = _tests_in(os.path.join(TESTS, jax_file))
    assert not tests - set(mapped), f"{jax_file}: not in the map: {sorted(tests - set(mapped))}"
    assert not set(mapped) - tests, f"{jax_file}: no such JAX test: {sorted(set(mapped) - tests)}"
    for name, target in mapped.items():
        if target.startswith("none: "):
            assert len(target) > len("none: ") + 20, (name, "state the reason")
            continue
        port_file, _, port_test = target.partition("::")
        assert port_file.startswith("test_torch_"), (name, target)
        path = os.path.join(TESTS, port_file)
        assert os.path.exists(path), (name, target)
        assert port_test in _tests_in(path), (name, target)
