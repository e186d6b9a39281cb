"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and ``BENCHMARK.json`` entries, and nothing edited, are found by
name and run: here in a copy of the benchmark's folder."""

import json
import os
import shutil
import subprocess
import sys

from portbench.harness import PKG, ROOT

CHILD = """
import json, torch
torch.set_num_threads(2)
from portbench import harness
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
run = harness.Run(bench, "restore-unet64-deblur", 2 ** 31 + 3, 1.5,
                  trace=False, device="cpu")
out = harness.execute(run)
run.traced = True
traced = harness.result(run)
print(json.dumps({"out": out, "traced": traced, "file": harness.__file__}))
"""


def test_new_files_are_found_by_name(tmp_path):
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((pkg / "configs/pnpflow-unet-celeba128.json")
                     .read_text())
    cfg.update(name="pnpflow-unet-celeba64", image_size=64,
               reduced=["image_size"])
    (pkg / "configs/pnpflow-unet-celeba64.json").write_text(json.dumps(cfg))
    traffic = json.loads((pkg / "traffic/pnp-deblur-s1-b16.json")
                         .read_text())
    traffic.update(sigma_blur=3.0, batch=1, num_samples=2, steps_pnp=20)
    (pkg / "traffic/pnp-deblur-s3-b1.json").write_text(json.dumps(traffic))
    (pkg / "workloads/restore-unet64-deblur.json").write_text(json.dumps({
        "limits": {"start_gap": 1e-4, "stage_gap": 1e-4}}))
    (pkg / "metrics/requests_seen.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    bench["configs"].append({
        "name": "pnpflow-unet-celeba64", "source": "a test",
        "file": "portbench/configs/pnpflow-unet-celeba64.json",
        "reduced": ["image_size"], "why": "a test"})
    bench["workloads"].append({
        "name": "restore-unet64-deblur", "config": "pnpflow-unet-celeba64",
        "traffic": "pnp-deblur-s3-b1", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("restore-unet64-deblur")
    bench["per_layer"].append({
        "name": "requests_seen", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "serving",
        "moves": "restore_img_per_s",
        "workloads": ["restore-unet64-deblur"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)])}
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(tmp_path))
    assert got["out"]["correct"], got["out"]["checks"]
    assert "restore_img_per_s" in got["out"]["metrics"]
    assert got["traced"]["metrics"]["requests_seen"]["value"] >= 1
