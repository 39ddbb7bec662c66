"""Test configuration: run on a virtual 8-device CPU mesh with fp64 enabled.

The reference validates at double precision 1e-6 (/root/reference/test/test.h:31);
we enable x64 for parity tests.  Multi-device tests use the 8 virtual CPU devices.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Pin tests to the virtual CPU mesh even where a GPU is visible: the suite
# checks correctness in fp64 on 8 virtual devices; on-card runs go through
# chip_smoke.py.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# --- fast/slow test tiers -----------------------------------------------------
# `pytest -m "not slow"` is the edit-loop tier (~4-5 min: every solver family
# exercised, the expensive cross-checks skipped); the plain `pytest tests/`
# full suite stays the merge gate.  Centralized here (measured ≥8 s per test
# on the virtual mesh) so the test files stay free of tier bookkeeping.
SLOW_TESTS = {
    "test_auto.py": {
        "test_auto_banded_prefer_segmented",
        "test_auto_block_angular_interleaved_dense_cols",
        "test_auto_block_angular_split",
        "test_auto_dense_inputs",
    },
    "test_autodiff.py": {"test_block_angular_lstsq_grad_matches_dense"},
    "test_banded.py": {
        "test_banded_chunked_path",
        "test_refactorize_changed_nnz_layout",
    },
    "test_block_angular.py": {
        "test_block_angular_blockdiag_left",
        "test_block_angular_colpiv_right",
        "test_block_angular_sparse_a2_matches_dense_path",
        "test_block_angular_sparse_a2_wide_onnz",
        "test_block_angular_thin_dense_right",
        "test_blockdiag_sparse_a2_plan_cache_reuse",
    },
    "test_blocked_thin.py": {
        "test_thin_dense",
        "test_thin_dense_wide_input",
        "test_thin_sparse",
        "test_thin_sparse_fused_scan_matches_eager",
        "test_thin_sparse_pivot_ordering",
        "test_thin_sparse_skewed_extents_use_heights",
    },
    "test_bundle.py": {
        "test_bundle_converges_clean",
        "test_bundle_device_matches_host_loop",
        "test_bundle_device_sharded_matches",
        "test_bundle_noisy_recovery",
        "test_bundle_step_structure",
    },
    "test_factorize_values.py": {
        "test_segmented_factorize_values_matches_compute"
    },
    "test_functional.py": {
        "test_soa_damped_step_matches_aos",
        "test_soa_damped_step_multicolumn_matches_aos",
    },
    "test_fuzz_contract.py": {
        "test_fuzz_banded_blocked",
        "test_fuzz_block_angular",
        "test_fuzz_segmented",
    },
    "test_fuzz_segmented_surfaces.py": {"test_fuzz_segmented_all_surfaces"},
    "test_householder.py": {
        "test_colpiv_wide_scan_variant",
        "test_panel_qr_yt_landscape_wide",
        "test_panel_qr_yt_lapack_wide",
    },
    "test_landscape.py": {"test_dense_wide_solve"},
    "test_lm_ellipse.py": {"test_banded_left_variant_matches"},
    "test_multi_rhs.py": {
        "test_multi_rhs_block_angular",
        "test_multi_rhs_segmented",
        "test_multi_rhs_segmented_fused_vs_protocol",
        "test_multi_rhs_thin_sparse",
    },
    "test_parallel.py": {"test_sharded_block_angular_end_to_end"},
    "test_rank_deficient.py": {
        "test_block_diagonal_pivot_rank_deficient",
        "test_blocked_thin_sparse_rank_deficient",
    },
    "test_scipy_interop.py": {"test_scipy_input_solves_end_to_end"},
    "test_segmented_banded.py": {
        "test_gather_free_extraction_fast_paths",
        "test_segment_space_solve_fast_path_equality",
        "test_segmented_grouped_chain_matches_contract",
        "test_segmented_matches_contract",
        "test_segmented_matches_plain_solution",
        "test_shared_backsub_gate_and_equality",
        "test_stream_gap_mode_equality",
        "test_tall_block_config3_geometry",
    },
    "test_segmented_sharded.py": {"test_segmented_sharded_matches"},
    "test_sparse_apply.py": {
        "test_block_angular_sparse_a2_fused",
        "test_segmented_sparse_qproduct",
    },
    "test_sparse_r.py": {
        "test_block_angular_sparse_r",
        "test_segmented_sparse_r",
    },
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = item.path.name if hasattr(item, "path") else item.fspath.basename
        base = item.name.split("[")[0]
        if base in SLOW_TESTS.get(fname, ()):
            item.add_marker(pytest.mark.slow)
