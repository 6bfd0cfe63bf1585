"""The work count behind k1_roofline_pct comes from the benchmark alone."""

import ast
import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "benchmark")
sys.path.insert(0, REPO)

from benchmark.work import roofline  # noqa: E402

COUNT = """
    import json, sys
    sys.path.insert(0, ".")
    {block}
    from benchmark.harness import scenes
    from benchmark.work import count
    cfg = scenes.load_config("benchmark/configs/{config}.json")
    print(json.dumps(count.count(cfg, 48, 2, overrides={overrides})))
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _count(config, block="", overrides=None):
    code = textwrap.dedent(COUNT).format(block=block, config=config,
                                         overrides=repr(overrides or {}))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out, mods = (json.loads(x) for x in r.stdout.strip().splitlines()[-2:])
    return out, mods


def test_count_does_not_depend_on_the_program():
    small = {"width": 48, "height": 32}
    free, mods = _count("demo", overrides=small)
    assert "rayzen_tpu_torch" not in mods
    # with the program made unimportable the count is the same, number for number
    blocked, _ = _count("demo", 'sys.modules["rayzen_tpu_torch"] = None', small)
    assert blocked == free
    assert free["visits_per_path"] > 0 and free["tests_per_path"] > 0


def test_reference_and_work_import_nothing_of_the_program():
    for sub in ("reference", "work"):
        for name in os.listdir(os.path.join(BENCH, sub)):
            if not name.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(BENCH, sub, name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    assert m.split(".")[0] not in ("rayzen_tpu_torch", "rayzen_tpu", "jax"), (name, m)


def test_least_time_is_the_larger_bound():
    count = {"ops_per_path": 1000.0, "table_bytes": 1 << 20}
    peak = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    t = roofline.least_seconds_for(count, peak, 1920, 1080, 4)
    assert t == 1000.0 * 1920 * 1080 * 4 / 67e12
    assert roofline.least_seconds_for({"ops_per_path": 0.0, "table_bytes": 1 << 30},
                                      peak, 2, 2, 1) == ((1 << 30) + 48) / 3.35e12


def test_stored_counts_are_estimates_of_this_benchmark():
    for config in ("demo", "field"):
        c = roofline.load_count(config)
        assert c is not None and c["estimate"] is True
        assert c["ops_per_path"] == (c["visits_per_path"] * c["ops_per_visit"]
                                     + c["tests_per_path"] * c["ops_per_test"])
