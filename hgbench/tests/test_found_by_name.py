"""A new configuration, mix, driver, metric and work count are added as
files only, and found by name: a copy of the benchmark with a dummy set
added runs its dummy cell without an edit of any file that was there."""

import json
import shutil
import subprocess
import sys
import textwrap

from hgbench.lib import names


def test_dummy_set_added_as_files_only(tmp_path):
    shutil.copytree(names.HGBENCH, tmp_path / "hgbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = names.benchmark()
    spec["configs"].append({"name": "dummy_cfg", "source": "https://example.org/dummy", "file":
                            "hgbench/configs/dummy_cfg.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg", "traffic": "dummy_mix",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_rate", "unit": "x/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["dummy_cfg.dummy_mix"]})
    spec["per_layer"].append({"name": "dummy_share", "unit": "%", "better": "higher", "source": "device_trace",
                              "layer": "kernels", "moves": "dummy_rate", "workloads": ["dummy_cfg.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    hg = tmp_path / "hgbench"
    config = names.load_json("configs", "drz_ct3d")
    config.update(name="dummy_cfg", source="https://example.org/dummy", checks=[])
    (hg / "configs" / "dummy_cfg.json").write_text(json.dumps(config))
    (hg / "traffic" / "dummy_mix.json").write_text(json.dumps({"driver": "dummy_drv"}))
    (hg / "limits" / "dummy_cfg.dummy_mix.json").write_text("{}")
    (hg / "drivers" / "dummy_drv.py").write_text(textwrap.dedent("""
        def run(session):
            session.setup_done()
            session.attempted = session.completed = 3
            session.e2e["dummy_rate"] = 3.0
            session.readings["calls"] = {"dummy_call": [((7,), {})]}
    """))
    (hg / "roofline" / "dummy_call.py").write_text("def work(args, kwargs):\n    return args[0], 0\n")
    (hg / "metrics" / "dummy_share.py").write_text(textwrap.dedent("""
        from hgbench.lib import names

        def read(readings):
            (args, kwargs), = readings["calls"]["dummy_call"]
            return float(names.load_module("roofline", "dummy_call").work(args, kwargs)[0])
    """))
    script = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(tmp_path)!r}]
        sys.path.append({str(names.ROOT)!r})
        from hgbench.lib import names
        from hgbench.lib.session import Session, finish
        assert names.HGBENCH == __import__("pathlib").Path({str(hg)!r})
        for trace in (False, True):
            s = Session("dummy_cfg.dummy_mix", 5, 1.0, trace, "cpu")
            names.load_module("drivers", s.mix["driver"]).run(s)
            print(json.dumps(finish(s)[0]["metrics"]))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    e2e, per_layer = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert e2e["dummy_rate"]["value"] == 3.0 and "setup_s" in e2e
    assert per_layer == {"dummy_share": {"value": 7.0, "unit": "%"}}
