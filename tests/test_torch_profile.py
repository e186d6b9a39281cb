"""``--opts jax_profile <dir>`` in the port (``pnpflow_tpu_torch/solvers/
base.py``) and its report (``pnpflow_tpu_torch/utils/profile_report.py``,
the counterpart of ``scripts/profile_report.py``): a CPU restoration run
with the key writes a ``torch.profiler`` Chrome trace into the directory,
and the report tabulates it; on a trace with device events the report
keeps those alone, as JAX's keeps the TPU planes.
"""

import glob
import json
import os

import pytest

from pnpflow_tpu_torch.main import main
from pnpflow_tpu_torch.utils import profile_report


def test_jax_profile_writes_a_trace_that_the_report_reads(tmp_path,
                                                           capsys):
    prof = tmp_path / "prof"
    main(["--opts", "dataset", "synthetic", "dim_image", "16",
          "num_channels", "1", "eval", "True", "method", "pnp_flow",
          "problem", "denoising", "steps_pnp", "1", "num_samples", "1",
          "batch_size_ip", "1", "max_batch", "1", "fused_norm", "False",
          "save_results", "False", "device", "cpu",
          "output_root", str(tmp_path / "out"), "jax_profile", str(prof)])
    traces = glob.glob(str(prof / "*.json"))
    assert len(traces) == 1
    assert "profile trace: " + traces[0] in capsys.readouterr().out
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    rows = profile_report.report(str(prof), 5)
    assert len(rows) == 5
    assert all(set(r) == {"op", "ms", "share", "count"} for r in rows)
    assert any(r["op"] == "aten::conv2d" for r in rows)
    assert rows[0]["ms"] >= rows[-1]["ms"] > 0 and rows[0]["count"] >= 1
    profile_report.main([str(prof), "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(s) for s in lines] == rows[:2]


def test_report_prefers_device_events(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "gn_swish", "dur": 300.0},
        {"ph": "X", "cat": "kernel", "name": "gn_swish", "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "dur": 100.0},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]
    os.makedirs(tmp_path / "run")
    with open(tmp_path / "run" / "t.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    assert profile_report.report(str(tmp_path)) == [
        {"op": "gn_swish", "ms": 0.4, "share": 0.8, "count": 2},
        {"op": "Memcpy HtoD", "ms": 0.1, "share": 0.2, "count": 1}]
    with pytest.raises(FileNotFoundError):
        profile_report.report(str(tmp_path / "none"))
