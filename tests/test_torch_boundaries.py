"""Boundaries of the PyTorch port: no JAX, no ``houv_tpu`` imports, CUDA by
default, and kernel launch counters that count only kernel launches."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import houv_tpu_torch
from houv_tpu_torch.ops.chamfer import chamfer_indices, nn_select
from houv_tpu_torch.ops.emd import emd_auction, emd_auction_with_stats
from houv_tpu_torch.ops.grouping import knn_indices, knn_points
from houv_tpu_torch.ops.interpolate import three_nn
from houv_tpu_torch.ops.sampling import furthest_point_sample
from houv_tpu_torch.ops.scatter import gather_rows_kernel, scatter_add
from houv_tpu_torch.solvers.houv import HOUVConfig, houv_solve
from houv_tpu_torch.train.cli import main as torch_cli_main
from houv_tpu_torch.train.cli import test_main as torch_test_main
from houv_tpu_torch.train.cli import train_main as torch_train_main
from houv_tpu_torch.train.config import Config
from houv_tpu_torch.train.harness import CompletionTrainer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "houv_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        houv_tpu_torch.__path__, "houv_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    names = _modules()
    for name in ("houv_tpu_torch.solvers.houv", "houv_tpu_torch.ops.grouping",
                 "houv_tpu_torch.ops.emd", "houv_tpu_torch.models.vrcnet",
                 "houv_tpu_torch.train.harness", "houv_tpu_torch.state",
                 "houv_tpu_torch.ops.scatter",
                 "houv_tpu_torch.train.schedules",
                 "houv_tpu_torch.train.checkpoint"):
        assert name in names
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'houv_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k.split('.')[0] in ('jax', 'houv_tpu') and v is not None\n"
        "               for k, v in sys.modules.items())\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_houv_tpu_import_in_the_port():
    files = [os.path.join(_REPO, "chip_smoke.py"),
             os.path.join(_REPO, "scripts", "time_scatter_gather.py"),
             os.path.join(_REPO, "scripts", "time_knn_wide_variants.py"),
             os.path.join(_REPO, "scripts", "time_nn_both_variants.py"),
             os.path.join(_REPO, "scripts", "time_knn_variants.py"),
             os.path.join(_REPO, "scripts", "time_fps_variants.py"),
             os.path.join(_REPO, "scripts", "time_emd_variants.py")]
    for root, _, names in os.walk(_PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imported(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "msgpack",
                               "houv_tpu"), (path, mod)


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = torch.randn(1, 16, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chamfer_indices(pts, pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        furthest_point_sample(pts, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        houv_solve(pts, pts, HOUVConfig(kernel=2, steps=1, angle_passes=1))
    cfg = tmp_path / "houv.yaml"
    cfg.write_text("model_name: houv\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_test_main(["-c", str(cfg)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        knn_indices(pts, pts, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        emd_auction_with_stats(pts, pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompletionTrainer(Config(model_name="vrcnet"))
    cfg = tmp_path / "vrcnet.yaml"
    cfg.write_text("model_name: vrcnet\ndataset: mvp_cp\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_test_main(["-c", str(cfg)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_train_main(["-c", str(cfg)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_cli_main(["train", "-c", str(cfg)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scatter_add(torch.zeros(1, 16, dtype=torch.int64), pts, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nn_select(pts, pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gather_rows_kernel(pts, torch.zeros(1, 16, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        knn_indices(torch.randn(1, 16, 24), torch.randn(1, 16, 24), 4)
    for model in ("pcn", "ecg"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CompletionTrainer(Config(model_name=model))
        cfg.write_text(f"model_name: {model}\ndataset: mvp_cp\n")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_test_main(["-c", str(cfg)])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_train_main(["-c", str(cfg)])
    # asking for the CPU with tensors elsewhere is an error, not a move
    with pytest.raises(ValueError):
        chamfer_indices(pts, pts, device="meta")
    with pytest.raises(ValueError):
        knn_indices(pts, pts, 4, device="meta")


def test_cpu_tensors_never_count_as_kernel_launches():
    chamfer_indices.launches = 0
    furthest_point_sample.launches = 0
    src = torch.randn(2, 32, 3)
    tgt = torch.randn(2, 32, 3)
    out = houv_solve(src, tgt,
                     HOUVConfig(kernel=4, steps=4, angle_passes=2,
                                nn_refresh_schedule=((2, 2, 2), (2, 1))),
                     device="cpu")
    assert out["transform"].shape == (2, 4, 4)
    assert chamfer_indices.launches == 0
    assert furthest_point_sample.launches == 0


def test_cpu_completion_ops_never_count_as_kernel_launches():
    knn_indices.launches = 0
    emd_auction_with_stats.launches = 0
    chamfer_indices.launches = 0
    pts = torch.randn(2, 40, 3)
    knn_points(pts, pts, 5)
    three_nn(pts, pts[:, :10])
    emd_auction(pts, pts.flip(1), 0.01, 20)
    assert knn_indices.launches == 0
    assert emd_auction_with_stats.launches == 0
    assert chamfer_indices.launches == 0


def test_cpu_training_ops_never_count_as_kernel_launches():
    """``scatter_add.launches`` counts kernel launches only: the plain
    version, a chamfer backward on CPU tensors and a scatter-mode solver
    step leave it at 0."""
    from houv_tpu_torch.metrics.cd import calc_cd

    scatter_add.launches = 0
    chamfer_indices.launches = 0
    out = torch.randn(2, 40, 3, requires_grad=True)
    gt = torch.randn(2, 50, 3)
    scatter_add(torch.randint(0, 9, (2, 40)), out.detach(), 9, device="cpu")
    calc_cd(out, gt)[0].sum().backward()
    assert out.grad is not None and torch.isfinite(out.grad).all()
    houv_solve(gt, gt.flip(1), HOUVConfig(kernel=2, steps=2, angle_passes=1,
                                          grad_mode="scatter"), device="cpu")
    assert scatter_add.launches == 0
    assert chamfer_indices.launches == 0


def test_the_scatter_kernel_is_bound_and_has_no_fallback():
    """The kernel's source and ctypes signature are registered with the
    build, and the wrapper's CUDA branch has no ``try`` to fall back
    through; nothing on the training path calls a library scatter."""
    from houv_tpu_torch.kernels import _build, sources

    assert "scatter.cu" in {p.name for p in sources()}
    assert "houv_scatter_add" in _build._SIGNATURES
    for rel in ("ops/scatter.py", "ops/chamfer.py", "metrics/cd.py"):
        with open(os.path.join(_PKG, rel)) as f:
            tree = ast.parse(f.read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), rel
        called = {n.func.attr for n in ast.walk(tree)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)}
        assert not called & {"scatter_add_", "index_add_", "index_add",
                             "compile"}, (rel, called)


def test_cpu_pcn_ecg_and_select_paths_never_count_as_kernel_launches():
    """The three newest counters (``knn_indices.wide_launches``,
    ``nn_select.launches``, ``gather_rows_kernel.launches``) count kernel
    launches only: an ECG train step, an ``nn_select`` solve and the row
    gather on CPU tensors leave them, and every other count, at 0."""
    from houv_tpu_torch.models import get_model
    from houv_tpu_torch.models.common import init_like_flax

    counters = [(knn_indices, "launches"), (knn_indices, "wide_launches"),
                (nn_select, "launches"), (gather_rows_kernel, "launches"),
                (chamfer_indices, "launches"), (scatter_add, "launches"),
                (furthest_point_sample, "launches")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    model = get_model("ecg", num_points=64, num_coarse=32, num_input=64)
    init_like_flax(model, torch.Generator().manual_seed(0))
    x = torch.rand(1, 64, 3) - 0.5
    model(x, x.flip(1), "train", alpha=0.5)["total_loss"].backward()
    houv_solve(x, x.flip(1), HOUVConfig(kernel=2, steps=2, angle_passes=1,
                                        nn_select=True), device="cpu")
    gather_rows_kernel(x, torch.zeros(1, 4, dtype=torch.int64), device="cpu")
    assert [getattr(fn, attr) for fn, attr in counters] == [0] * len(counters)


def test_the_new_kernels_are_bound_and_have_no_fallback():
    """knn_wide, nn_select and gather_rows: each source and ctypes signature
    is registered with the build; the wrappers' modules have no ``try`` to
    fall back through; and no CUDA route calls a library's distance
    product, selection or gather in its kernel's place."""
    from houv_tpu_torch.kernels import _build, sources

    assert {"knn_wide.cu", "nn_select.cu", "gather_rows.cu"} <= \
        {p.name for p in sources()}
    assert {"houv_knn_wide", "houv_nn_select", "houv_gather_rows"} <= \
        set(_build._SIGNATURES)
    routes = {"ops/grouping.py": "_knn_cuda",
              "ops/chamfer.py": "_nn_select_cuda",
              "ops/scatter.py": "_gather_rows_cuda"}
    for rel, route in routes.items():
        with open(os.path.join(_PKG, rel)) as f:
            tree = ast.parse(f.read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), rel
        fn = next(n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name == route)
        called = {n.func.attr for n in ast.walk(fn)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)}
        assert not called & {"cdist", "matmul", "einsum", "topk", "sort",
                             "gather", "argmin", "compile"}, (rel, called)
