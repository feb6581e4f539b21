"""The port's Lua configuration loader (hectorgrapher_tpu_torch/common/
lua_config.py), its configuration_files/*.lua and its generator
(tools/generate_lua_defaults.py) against the JAX package's.

Every case of tests/test_lua_config.py runs through both packages; the
option trees they build must be equal (dataclasses.asdict, exact values).
The reference-file cases, which tests/test_lua_config.py runs only where
the reference's own configuration_files/ exist, run here on each
package's generated files. The generated files must equal what the JAX
package's generator writes, byte for byte but for the header's package
name. The JAX package's committed pose_graph.lua predates the
pack_hbm_budget_bytes option and lacks its line (ROADMAP C30); that line
is its only other difference from the port's files.
"""

import dataclasses
import math
from pathlib import Path

import pytest

from hectorgrapher_tpu.common import lua_config as jlua
from hectorgrapher_tpu_torch.common import config as tcfg
from hectorgrapher_tpu_torch.common import lua_config as tlua
from hectorgrapher_tpu_torch.tools import generate_lua_defaults

ROOT = Path(__file__).resolve().parent.parent
JAX_FILES = ROOT / "hectorgrapher_tpu" / "configuration_files"
PORT_FILES = ROOT / "hectorgrapher_tpu_torch" / "configuration_files"
LUA_FILES = ["map_builder.lua", "map_builder_server.lua", "pose_graph.lua", "trajectory_builder.lua",
             "trajectory_builder_2d.lua", "trajectory_builder_3d.lua"]


@pytest.fixture(params=[jlua, tlua], ids=["jax", "port"])
def lua(request):
    return request.param


def _tree(loaded):
    return (dataclasses.asdict(loaded.map_builder), loaded.collate_fixed_frame, loaded.collate_landmarks,
            loaded.pure_localization_max_submaps_to_keep, loaded.extra)


def both(code, config_dirs=(), strict=True):
    """The code's options through both packages, checked equal; the port's."""
    loaded = [m.map_builder_options_from_lua(*m.run_lua(code, config_dirs=config_dirs), strict=strict)
              for m in (jlua, tlua)]
    assert _tree(loaded[1]) == _tree(loaded[0])
    assert isinstance(loaded[1].map_builder, tcfg.MapBuilderOptions)
    return loaded[1]


class TestLuaEvaluator:
    def test_literals_and_arithmetic(self, lua):
        g, _ = lua.run_lua(
            """
            a = 1 + 2 * 3
            b = (1 + 2) * 3
            c = 2^10
            d = 7 % 3
            e = -4.5e-1
            f = 0x10
            g_ = 10 / 4
            h = true
            i = false
            j = nil
            s = "hello" .. " " .. "world"
            n = 10 .. ""
            """
        )
        assert (g["a"], g["b"], g["c"], g["d"], g["e"], g["f"], g["g_"]) == (7, 9, 1024, 1, -0.45, 16, 2.5)
        assert g["h"] is True and g["i"] is False and g["j"] is None
        assert g["s"] == "hello world"
        assert g["n"] == "10"

    def test_math_library(self, lua):
        g, _ = lua.run_lua(
            """
            a = math.rad(30.)
            b = math.deg(math.pi)
            c = math.sqrt(16.)
            d = math.floor(2.7)
            e = math.max(1, 5, 3)
            f = math.huge
            """
        )
        assert g["a"] == pytest.approx(math.radians(30.0))
        assert g["b"] == pytest.approx(180.0)
        assert (g["c"], g["d"], g["e"], g["f"]) == (4.0, 2, 5, math.inf)

    def test_logic_and_comparison(self, lua):
        g, _ = lua.run_lua(
            """
            a = 1 < 2
            b = 2 ~= 2
            c = false or 5
            d = nil and 7
            e = not nil
            f = 3 == 3.0
            """
        )
        assert g["a"] is True and g["b"] is False and g["c"] == 5 and g["d"] is None
        assert g["e"] is True and g["f"] is True

    def test_tables_nested_and_array_part(self, lua):
        g, _ = lua.run_lua(
            """
            t = {
              x = 1,
              nested = { y = 2, z = { "a", "b" } },
              [3] = "three";
            }
            t.nested.y = 20
            t["x"] = 10
            """
        )
        t = g["t"]
        assert t["x"] == 10
        assert t["nested"]["y"] == 20
        assert t["nested"]["z"] == {1: "a", 2: "b"}
        assert t[3] == "three"

    def test_table_reference_semantics(self, lua):
        g, _ = lua.run_lua(
            """
            POSE_GRAPH = { optimize_every_n_nodes = 90 }
            MAP_BUILDER = { pose_graph = POSE_GRAPH }
            POSE_GRAPH.optimize_every_n_nodes = 3
            """
        )
        assert g["MAP_BUILDER"]["pose_graph"]["optimize_every_n_nodes"] == 3
        assert g["MAP_BUILDER"]["pose_graph"] is g["POSE_GRAPH"]

    def test_local_and_global_variable_reference(self, lua):
        g, _ = lua.run_lua(
            """
            local MAX = 60.
            RANGE = MAX
            T = { max_range = MAX }
            """
        )
        assert "MAX" not in g
        assert g["RANGE"] == 60.0
        assert g["T"]["max_range"] == 60.0

    def test_return_options(self, lua):
        _, ret = lua.run_lua(
            """
            options = { a = 1, b = { c = 2 } }
            options.b.c = 3
            return options
            """
        )
        assert ret == {"a": 1, "b": {"c": 3}}

    def test_include(self, lua, tmp_path):
        (tmp_path / "base.lua").write_text("BASE = { v = 1 }\n")
        (tmp_path / "top.lua").write_text('include "base.lua"\nBASE.v = 2\n')
        g, _ = lua.load_lua_file("top.lua", [str(tmp_path)])
        assert g["BASE"]["v"] == 2

    def test_include_first_match_wins(self, lua, tmp_path):
        d1, d2 = tmp_path / "d1", tmp_path / "d2"
        d1.mkdir()
        d2.mkdir()
        (d1 / "x.lua").write_text("WHO = 'd1'\n")
        (d2 / "x.lua").write_text("WHO = 'd2'\n")
        g, _ = lua.load_lua_file("x.lua", [str(d1), str(d2)])
        assert g["WHO"] == "d1"

    def test_comments(self, lua):
        g, _ = lua.run_lua(
            """
            -- a line comment
            a = 1  -- trailing
            --[[ a block
                 comment a = 99 ]]
            b = 2
            """
        )
        assert g["a"] == 1 and g["b"] == 2

    def test_undefined_variable_raises(self, lua):
        with pytest.raises(lua.LuaError):
            lua.run_lua("a = UNDEFINED_THING\n")

    def test_os_getenv(self, lua, monkeypatch):
        monkeypatch.setenv("HG_TEST_ENV", "hello")
        g, _ = lua.run_lua('a = os.getenv("HG_TEST_ENV")\nb = os.getenv("HG_MISSING_X")\n')
        assert g["a"] == "hello"
        assert g["b"] is None


class TestOptionsFromLua:
    def test_simple_overrides(self):
        mb = both("""
        POSE_GRAPH = { optimize_every_n_nodes = 42 }
        MAP_BUILDER = {
          use_trajectory_builder_2d = true,
          pose_graph = POSE_GRAPH,
        }
        POSE_GRAPH.constraint_builder = { min_score = 0.66 }
        """).map_builder
        assert mb.use_trajectory_builder_2d is True
        assert mb.pose_graph.optimize_every_n_nodes == 42
        assert mb.pose_graph.constraint_builder.min_score == 0.66
        assert mb.pose_graph.constraint_builder.sampling_ratio == 0.3  # untouched defaults survive

    def test_trajectory_builder_wrapper_keys(self):
        loaded = both("""
        TRAJECTORY_BUILDER_2D = { max_range = 25. }
        TRAJECTORY_BUILDER = {
          trajectory_builder_2d = TRAJECTORY_BUILDER_2D,
          collate_fixed_frame = false,
          collate_landmarks = true,
          pure_localization_trimmer = { max_submaps_to_keep = 4 },
        }
        MAP_BUILDER = { use_trajectory_builder_2d = true }
        """)
        assert loaded.map_builder.trajectory_builder_2d.max_range == 25.0
        assert loaded.collate_fixed_frame is False
        assert loaded.collate_landmarks is True
        assert loaded.pure_localization_max_submaps_to_keep == 4

    def test_unknown_key_raises_strict(self, lua):
        g, ret = lua.run_lua("MAP_BUILDER = { not_a_real_option = 1 }")
        with pytest.raises(KeyError):
            lua.map_builder_options_from_lua(g, ret, strict=True)
        both("MAP_BUILDER = { not_a_real_option = 1 }", strict=False)

    def test_overlapping_submaps_trimmer(self):
        trimmer = both("""
        POSE_GRAPH = {
          overlapping_submaps_trimmer_2d = {
            fresh_submaps_count = 2,
            min_covered_area = 3.,
            min_added_submaps_count = 6,
          },
        }
        MAP_BUILDER = { pose_graph = POSE_GRAPH }
        """).map_builder.pose_graph.overlapping_submaps_trimmer_2d
        assert isinstance(trimmer, tcfg.OverlappingSubmapsTrimmerOptions2D)
        assert (trimmer.fresh_submaps_count, trimmer.min_covered_area, trimmer.min_added_submaps_count) == (2, 3.0, 6)

    def test_trimmer_unknown_key_raises(self):
        g, ret = tlua.run_lua("MAP_BUILDER = { pose_graph = { overlapping_submaps_trimmer_2d = { nope = 1 } } }")
        with pytest.raises(KeyError):
            tlua.map_builder_options_from_lua(g, ret)


@pytest.mark.parametrize("files", [JAX_FILES, PORT_FILES], ids=["jax_files", "port_files"])
class TestConfigurationFiles:
    """tests/test_lua_config.py's reference-file cases on the packages'
    generated configuration files."""

    LOAD = ('include "map_builder.lua"\n'
            'include "trajectory_builder.lua"\n'
            "options = { map_builder = MAP_BUILDER, trajectory_builder = TRAJECTORY_BUILDER }\n"
            "return options\n")

    def test_defaults_match(self, files):
        loaded = both(self.LOAD, config_dirs=[str(files)])
        assert loaded.map_builder == tcfg.MapBuilderOptions()
        mb = loaded.map_builder
        assert mb.pose_graph.optimize_every_n_nodes == 90
        assert mb.pose_graph.constraint_builder.fast_correlative_scan_matcher.angular_search_window == pytest.approx(
            math.radians(30.0))
        assert mb.pose_graph.optimization_problem.ceres_solver_options.max_num_iterations == 50
        tb3 = mb.trajectory_builder_3d
        assert tb3.max_range == 60.0 and tb3.low_resolution_adaptive_voxel_filter.max_range == 60.0
        assert tb3.optimizing_local_trajectory_builder.imu_integrator == "RK4"
        assert loaded.collate_fixed_frame is True and loaded.collate_landmarks is False

    def test_user_style_override_flows_through_alias(self, files):
        mb = both('include "map_builder.lua"\n'
                  'include "trajectory_builder.lua"\n'
                  "MAP_BUILDER.use_trajectory_builder_3d = true\n"
                  "TRAJECTORY_BUILDER_3D.submaps.num_range_data = 55\n"
                  "POSE_GRAPH.optimize_every_n_nodes = 7\n"
                  "options = { map_builder = MAP_BUILDER, trajectory_builder = TRAJECTORY_BUILDER }\n"
                  "return options\n", config_dirs=[str(files)]).map_builder
        assert mb.use_trajectory_builder_3d is True
        assert mb.trajectory_builder_3d.submaps.num_range_data == 55
        assert mb.pose_graph.optimize_every_n_nodes == 7

    def test_map_builder_server_lua(self, files):
        g, _ = tlua.load_lua_file("map_builder_server.lua", [str(files)])
        assert g["MAP_BUILDER_SERVER"]["map_builder"] is g["MAP_BUILDER"]
        loaded = tlua.load_map_builder_options("map_builder.lua", [str(files)])
        assert loaded.map_builder == tcfg.MapBuilderOptions()


def _body(text: str) -> str:
    return text.replace("hectorgrapher_tpu_torch.", "hectorgrapher_tpu.").replace(
        "hectorgrapher_tpu_torch/", "hectorgrapher_tpu/")


@pytest.mark.parametrize("name", LUA_FILES)
def test_generated_files_equal_the_jax_packages(name, jax_generated):
    """Byte-equal to the JAX generator's output but for the header's
    package name: the two packages' defaults agree."""
    port = (PORT_FILES / name).read_text()
    assert port.startswith("-- GENERATED by hectorgrapher_tpu_torch.tools.generate_lua_defaults")
    assert _body(port) == (jax_generated / name).read_text()
    stale = [line for line in _body(port).splitlines(keepends=True) if "pack_hbm_budget_bytes" in line]
    committed = (JAX_FILES / name).read_text()
    assert "".join(line for line in _body(port).splitlines(keepends=True) if line not in stale) == committed
    assert len(stale) == (name == "pose_graph.lua")  # C30


@pytest.fixture(scope="module")
def jax_generated(tmp_path_factory):
    from hectorgrapher_tpu.tools import generate_lua_defaults as jax_generator

    out = tmp_path_factory.mktemp("jax_lua")
    jax_generator.generate(str(out))
    return out


def test_generator_writes_the_committed_files(tmp_path, capsys):
    generate_lua_defaults.generate(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == LUA_FILES
    for name in LUA_FILES:
        assert (tmp_path / name).read_bytes() == (PORT_FILES / name).read_bytes()
