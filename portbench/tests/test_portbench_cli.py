"""The command line: without a card it prints nothing and fails; in a
folder that holds only the benchmark it fails."""

import json
import os
import shutil
import subprocess
import sys

from portbench.harness import PKG, ROOT

ARGS = ["--workload", "restore-unet128-deblur", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def command(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "portbench", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    proc = command(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = command(tmp_path, env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_json_names_existing_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PKG / "workloads" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        own = PKG / "metrics" / f"{m['name']}.py"
        shared = PKG / "metrics" / f"{m['name'].split('.')[0]}.py"
        assert own.is_file() or shared.is_file(), m["name"]


def test_every_metric_reader_loads_and_reads_nothing_from_an_empty_run():
    from portbench.harness import Run, reader

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        cell = (m.get("workloads") or [bench["workloads"][0]["name"]])[0]
        run = Run(bench, cell, 1, 1.0, trace=True, device="cpu")
        assert reader(m["name"]).read(run) is None, m["name"]


def test_a_split_metric_takes_its_own_reader_before_the_shared_one(
        tmp_path, monkeypatch):
    from portbench import harness

    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics/share.py").write_text("def read(run):\n    return 1\n")
    (tmp_path / "metrics/share.b.py").write_text(
        "def read(run):\n    return 2\n")
    monkeypatch.setattr(harness, "PKG", tmp_path)
    assert [harness.reader(n).read(None)
            for n in ("share", "share.a", "share.b")] == [1, 1, 2]
