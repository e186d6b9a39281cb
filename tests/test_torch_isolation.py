"""The port stands alone: no import of JAX, flax, grain, orbax or the JAX
package (data parallelism, the data and checkpoint backends and the demos
included); no quiet fall back to the CPU; its own config reader agrees with
PyYAML."""

import ast
import glob
import os

import pytest
import torch
import yaml

from pnpflow_tpu_torch.device import resolve_device
from pnpflow_tpu_torch.metrics.lpips import get_lpips_fn
from pnpflow_tpu_torch.models.inception import get_inception_fns
from pnpflow_tpu_torch.models.registry import build_model_bundle
from pnpflow_tpu_torch.ops.degradations import make_degradation
from pnpflow_tpu_torch.utils.config import CfgNode, read_flat_yaml
from pnpflow_tpu_torch.main import main
from pnpflow_tpu_torch.serve import Restorer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "grain", "orbax", "pnpflow_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def _port_files():
    files = sorted(glob.glob(os.path.join(REPO, "pnpflow_tpu_torch", "**",
                                          "*.py"), recursive=True))
    return files + [os.path.join(REPO, "chip_smoke.py")]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 15
    bad = [(os.path.relpath(f, REPO), name) for f in files
           for name in _imports(f)
           if any(name == m or name.startswith(m + ".") for m in FORBIDDEN)]
    assert not bad, bad


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(REPO)
    args = CfgNode(dict(model="ot", dim_image=64, num_channels=3,
                        problem="gaussian_deblurring_FFT",
                        noise_type="gaussian", output_root=str(tmp_path),
                        dataset="synthetic"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        make_degradation(args)
    with pytest.raises(RuntimeError):
        build_model_bundle(args)
    with pytest.raises(RuntimeError):
        main(["--opts", "dataset", "synthetic", "output_root", str(tmp_path)])
    args.model, args.dim_image = "rectified", 256
    with pytest.raises(RuntimeError):
        build_model_bundle(args)
    with pytest.raises(RuntimeError):
        main(["--opts", "dataset", "synthetic", "model", "rectified",
              "dim_image", "256", "fused_norm", "bm",
              "output_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Restorer(output_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_inception_fns(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_lpips_fn(args)
    assert resolve_device("cpu").type == "cpu"


def test_parallel_and_demos_stand_alone_and_refuse_the_cpu(monkeypatch):
    from pnpflow_tpu_torch.demos import demo, dirichlet, toy_example
    from pnpflow_tpu_torch.parallel import mesh

    rel = {os.path.relpath(f, REPO) for f in _port_files()}
    for f in ("parallel/__init__.py", "parallel/mesh.py",
              "demos/toy_example.py", "demos/demo.py", "demos/dirichlet.py",
              "data/grain_loader.py", "training/checkpoint.py",
              "utils/profile_report.py"):
        assert "pnpflow_tpu_torch/" + f in rel, f
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.devices()
    for mod in (toy_example, demo, dirichlet):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main([])


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "config", "**", "*.yaml"), recursive=True)))
def test_config_reader_matches_yaml(path):
    with open(path) as f:
        assert read_flat_yaml(path) == yaml.safe_load(f)


def test_config_reader_scalars_match_yaml(tmp_path):
    text = ("S:\n    a: 1\n    b: -2.5\n    c: 'q # x'\n    d: None\n"
            "    e: true  # c\n    f: ~\n    g: 1e-4\n    h: 0.0001\n"
            "    i: \"s\"\n    j: off\n    k: .5\n")
    path = tmp_path / "t.yaml"
    path.write_text(text)
    assert read_flat_yaml(str(path)) == yaml.safe_load(text)
