"""The port's remaining small modules against the JAX package, on the CPU,
and the inventory that holds the port to doing what the JAX package does.

- ``geometry/rotations.py``: ``quat2mat``, ``mat2euler``, ``random_pose``
  (JAX's draws handed over), ``transform_points``,
  ``axis_angle_from_matrix``: within 1e-5 (f32 trigonometry in another
  library), the Euler angles within 1e-4 degrees;
- ``ops/voxel.py``: ``voxelize_occupancy`` exact, ``voxelize_features_mean``
  within 1e-6 (both sum in point order);
- ``ops/boxes.py`` (the exact BEV overlap and IoU within 1e-5 of the
  largest area, the sampled IoU, NMS, points in boxes, ``assign_score_withk``)
  and ``ops/image.py`` (``sigmoid_focal_loss``, ``roi_align``) within 1e-5;
- ``models/voxelnet.py:SparseBasicBlock`` (flax's masked BatchNorm, both
  modes) within 1e-5; ``data/mvp.py``'s h5 fixtures read back equal;
  ``utils/visu.py`` writes its PNG files;
- the inventory: every public name defined at the top of a module of
  ``houv_tpu/`` exists at the same module path of ``houv_tpu_torch/`` or in
  ``REPLACED``, the TPU workarounds and the entry points the port has under
  other names.
"""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.data import mvp as jmvp
from houv_tpu.geometry import rotations as jrot
from houv_tpu.models import voxelnet as jv
from houv_tpu.ops import boxes as jboxes
from houv_tpu.ops import image as jimage
from houv_tpu.ops import sparse_conv as jsc
from houv_tpu.ops import voxel as jvoxel
from houv_tpu_torch.data import mvp as tmvp
from houv_tpu_torch.geometry import rotations as trot
from houv_tpu_torch.models import voxelnet as tv
from houv_tpu_torch.ops import boxes as tboxes
from houv_tpu_torch.ops import image as timage
from houv_tpu_torch.ops import sparse_conv as tsc
from houv_tpu_torch.ops import voxel as tvoxel
from test_torch_voxelnet import _grid, _port, _sparse_pair, _variables

_REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------- rotations

def test_quat2mat_mat2euler_and_transforms_match_jax(rng):
    q = rng.standard_normal((5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r = np.asarray(jrot.quat2mat(jnp.asarray(q)))
    np.testing.assert_allclose(trot.quat2mat(_t(q)).numpy(), r, **TOL)
    for seq in ("zyx", "ZYX"):
        np.testing.assert_allclose(
            trot.mat2euler(_t(r), seq).numpy(),
            np.asarray(jrot.mat2euler(jnp.asarray(r), seq)), atol=1e-4,
            rtol=0)
    with pytest.raises(NotImplementedError):
        trot.mat2euler(_t(r), "xyz")
    pts = rng.standard_normal((5, 7, 3)).astype(np.float32)
    t = rng.standard_normal((5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        trot.transform_points(_t(pts), _t(r), _t(t)).numpy(),
        np.asarray(jrot.transform_points(jnp.asarray(pts), jnp.asarray(r),
                                         jnp.asarray(t))), **TOL)
    # rotations of every angle, the identity's fallback axis among them
    axes = rng.standard_normal((6, 3)).astype(np.float32)
    angles = np.array([0.0, 1e-9, 0.3, 1.5, 3.0, np.pi], np.float32)
    mats = np.asarray(jrot.rodrigues(jnp.asarray(angles), jnp.asarray(axes)))
    ja, jx = jrot.axis_angle_from_matrix(jnp.asarray(mats))
    ta, tx = trot.axis_angle_from_matrix(_t(mats))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-3, rtol=0)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    assert trot.rotation_from_axis_angle is trot.rodrigues


def test_random_pose_from_jaxs_draws_and_from_a_generator():
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jrot.random_pose(key, 0.8, 0.4))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = [jax.random.normal(k1, (3,)), jax.random.uniform(k2),
             jax.random.normal(k3, (3,)), jax.random.uniform(k4)]
    ours = trot._pose_from_draws(*(_t(d) for d in draws), 0.8, 0.4)
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    gen = torch.Generator().manual_seed(0)
    poses = torch.stack([trot.random_pose(gen, 0.8, 0.4) for _ in range(64)])
    r = poses[:, :3, :3]
    np.testing.assert_allclose((r @ r.transpose(1, 2)).numpy(),
                               np.broadcast_to(np.eye(3), (64, 3, 3)),
                               atol=1e-5)
    ang, _ = trot.axis_angle_from_matrix(r)
    assert float(ang.max()) <= np.degrees(0.8) + 1e-3
    assert float(poses[:, :3, 3].norm(dim=-1).max()) <= 0.4 + 1e-6
    assert (poses[:, 3] == torch.tensor([0.0, 0.0, 0.0, 1.0])).all()


# -------------------------------------------------------------------- voxel

def test_voxel_occupancy_and_feature_means_match_jax(rng):
    xyz = rng.uniform(-0.6, 0.6, (2, 300, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 300, 11)).astype(np.float32)
    occ = tvoxel.voxelize_occupancy(_t(xyz), 9)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jvoxel.voxelize_occupancy(jnp.asarray(xyz),
                                                          9)))
    means = tvoxel.voxelize_features_mean(_t(xyz), _t(feats), 9)
    ref = np.asarray(jvoxel.voxelize_features_mean(jnp.asarray(xyz),
                                                   jnp.asarray(feats), 9))
    assert means.shape == ref.shape == (2, 9, 9, 9, 11)
    np.testing.assert_allclose(means.numpy(), ref, rtol=0, atol=1e-6)


# -------------------------------------------------------------------- boxes

def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-2, 2, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 2.5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_bev_overlap_iou_and_nms_match_jax(rng):
    a, b = _boxes(rng, 9), _boxes(rng, 7)
    b[0] = a[0]                          # a box against itself
    b[1] = a[1] + np.float32([30, 0, 0, 0, 0, 0, 0])   # far apart
    ov = tboxes.boxes_overlap_bev(_t(a), _t(b)).numpy()
    ref = np.asarray(jboxes.boxes_overlap_bev(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(ov, ref, rtol=0, atol=1e-5 * ref.max())
    np.testing.assert_allclose(ov[0, 0], a[0, 3] * a[0, 4], rtol=1e-5)
    assert ov[1, 1] == 0 and (ov > 0).mean() > 0.1
    np.testing.assert_allclose(
        tboxes.boxes_iou_bev(_t(a), _t(b)).numpy(),
        np.asarray(jboxes.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b))),
        **TOL)
    np.testing.assert_allclose(
        tboxes.boxes_iou_bev_sampled(_t(a), _t(b), 12).numpy(),
        np.asarray(jboxes.boxes_iou_bev_sampled(jnp.asarray(a),
                                                jnp.asarray(b), 12)), **TOL)
    boxes = np.concatenate([a, a[:4] + np.float32([0.1, 0, 0, 0, 0, 0, 0])])
    scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
    keep, mask = tboxes.nms_bev(_t(boxes), _t(scores), 0.3, max_out=20)
    jkeep, jmask = jboxes.nms_bev(jnp.asarray(boxes), jnp.asarray(scores),
                                  0.3, max_out=20)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_points_in_boxes_and_assign_score_match_jax(rng):
    boxes = np.stack([_boxes(rng, 4), _boxes(rng, 4)])
    pts = rng.uniform(-2.5, 2.5, (2, 200, 3)).astype(np.float32)
    got = tboxes.points_in_boxes(_t(pts), _t(boxes)).numpy()
    ref = np.asarray(jboxes.points_in_boxes(jnp.asarray(pts),
                                            jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).any() and (got < 0).any()
    scores = rng.uniform(0, 1, (2, 10, 4, 3)).astype(np.float32)
    pf = rng.standard_normal((2, 12, 3, 5)).astype(np.float32)
    cf = rng.standard_normal((2, 10, 3, 5)).astype(np.float32)
    idx = rng.integers(0, 12, (2, 10, 4))
    np.testing.assert_allclose(
        tboxes.assign_score_withk(_t(scores), _t(pf), _t(cf),
                                  _t(idx)).numpy(),
        np.asarray(jboxes.assign_score_withk(jnp.asarray(scores),
                                             jnp.asarray(pf),
                                             jnp.asarray(cf),
                                             jnp.asarray(idx))), **TOL)


def test_focal_loss_and_roi_align_match_jax(rng):
    logits = rng.standard_normal((4, 6)).astype(np.float32) * 3
    tgt = (rng.uniform(0, 1, (4, 6)) > 0.5).astype(np.float32)
    for red in ("mean", "sum", "none"):
        np.testing.assert_allclose(
            timage.sigmoid_focal_loss(_t(logits), _t(tgt),
                                      reduction=red).numpy(),
            np.asarray(jimage.sigmoid_focal_loss(
                jnp.asarray(logits), jnp.asarray(tgt), reduction=red)),
            **TOL)
    feats = rng.standard_normal((2, 3, 12, 10)).astype(np.float32)
    rois = np.array([[0, 1.0, 2.0, 8.5, 9.0], [1, 0.0, 0.0, 9.9, 11.9],
                     [1, 3.2, 4.1, 4.0, 4.5]], np.float32)
    np.testing.assert_allclose(
        timage.roi_align(_t(feats), _t(rois), 4, 1.0, 2).numpy(),
        np.asarray(jimage.roi_align(jnp.asarray(feats), jnp.asarray(rois),
                                    4, 1.0, 2)), **TOL)


# --------------------------------------------- SparseBasicBlock, h5, visu

@pytest.mark.parametrize("width,train", [(8, False), (12, True)])
def test_sparse_basic_block_matches_jax(rng, width, train):
    ind, feats = _grid(rng, g=10, c=8)
    jsg, tsg = _sparse_pair(ind, feats, 10)
    lk = jsc.build_lookup(jsg)
    jm = jv.SparseBasicBlock(width)
    variables = _variables(jm, rng, jsg, lk, train)
    out, upd = jax.jit(lambda v, sg, lk: jm.apply(
        v, sg, lk, train, mutable=["batch_stats"]))(variables, jsg, lk)
    tm = _port(tv.SparseBasicBlock(8, width), variables)
    ours = tm(tsg, tsc.build_lookup(tsg), train)
    np.testing.assert_allclose(ours.features.detach().numpy(),
                               np.asarray(out.features), **TOL)
    if train:
        stats = upd["batch_stats"]["BatchNorm_1"]
        np.testing.assert_allclose(tm.bn2.running_mean.numpy(),
                                   np.asarray(stats["mean"]), **TOL)


def test_mvp_fixtures_read_back(tmp_path):
    import h5py  # noqa: F401  (the fixtures need it)

    rg = tmvp.write_mvp_rg_fixture(str(tmp_path / "a" / "rg.h5"), n_pairs=4,
                                   n_points=32, seed=3)
    cp = tmvp.write_mvp_cp_fixture(str(tmp_path / "cp.h5"), n_models=2,
                                   views=3, n_points=32, seed=3)
    for path, data in ((tmp_path / "a" / "rg.h5", rg),
                       (tmp_path / "cp.h5", cp)):
        back = tmvp.load_h5(str(path))
        ref = jmvp.load_h5(str(path))
        assert set(back) == set(data) == set(ref)
        for k, v in data.items():
            if isinstance(v, list):
                for x, y in zip(back[k], v):
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(back[k], v)
    # the JAX package's fixture of the same seed reads back the same
    jmvp.write_mvp_rg_fixture(str(tmp_path / "j.h5"), n_pairs=4,
                              n_points=32, seed=3)
    jrg = tmvp.load_h5(str(tmp_path / "j.h5"))
    back = tmvp.load_h5(str(tmp_path / "a" / "rg.h5"))
    assert set(jrg) == set(back)
    for k, v in jrg.items():
        if isinstance(v, list):
            assert all(np.array_equal(x, y) for x, y in zip(back[k], v))
        else:
            np.testing.assert_array_equal(back[k], v)


def test_visu_writes_its_figures(tmp_path, rng):
    from houv_tpu_torch.utils import visu

    clouds = [torch.randn(50, 3) for _ in range(3)]
    p = visu.plot_grid_pcd(clouds, save_path=str(tmp_path / "g.png"))
    assert Path(p).exists()
    visu.analyse_distances({"sine": rng.uniform(0, 90, 100)},
                           save_path=str(tmp_path / "h.png"))
    assert (tmp_path / "h.png").exists()
    tf = np.eye(4, dtype=np.float32)
    paths = visu.dump_failure_cases(torch.stack(clouds[:2]),
                                    torch.stack(clouds[1:]),
                                    np.stack([tf, tf]),
                                    np.array([80.0, 10.0]), str(tmp_path))
    assert len(paths) == 1 and Path(paths[0]).exists()
    import matplotlib.pyplot as plt

    ax = plt.figure().add_subplot(projection="3d")
    visu.plot_gmm(ax, np.full(4, 0.25), rng.standard_normal((4, 3)),
                  np.broadcast_to(np.eye(3), (4, 3, 3)) * 0.01)
    plt.close("all")


# ---------------------------------------------------------------- inventory

# the JAX package's public names that the port has under another name or
# replaces by design: name -> its counterpart
REPLACED = {
    # TPU workarounds: one-hot and matrix-unit gathers and scatters
    "ops/gather.py:gather_rows_onehot": "torch.gather (ops/gather.py)",
    "ops/scatter.py:gather_rows_matmul": "K5, ops/scatter.py:"
                                         "gather_rows_kernel",
    "ops/scatter.py:scatter_add_matmul": "K4, ops/scatter.py:scatter_add",
    # the TPU's bounded solve segments: the eager solver needs none
    "solvers/houv.py:houv_solve_chunked": "solvers/houv.py:houv_solve",
    "solvers/houv.py:chunked_pass": "solvers/houv.py:houv_solve",
    "solvers/houv.py:houv_pass_segment": "solvers/houv.py:houv_solve",
    "solvers/houv.py:houv_opt_init": "solvers/houv.py:houv_solve",
    "solvers/houv.py:houv_finalize": "solvers/houv.py:houv_solve",
    # the Pallas wrappers: the CUDA kernels behind the ops
    "ops/chamfer.py:nn_select_pallas": "csrc/nn_select.cu, "
                                       "ops/chamfer.py:nn_select",
    "ops/grouping.py:knn_indices_pallas": "csrc/knn.cu, csrc/knn_wide.cu, "
                                          "ops/grouping.py:knn_indices",
    "ops/emd_kernel.py:emd_auction_pallas": "csrc/emd.cu, csrc/emd_large.cu,"
                                            " ops/emd.py:emd_auction",
    # XLA's compilation cache: the built kernel library is reused
    "utils/cache.py:enable_compilation_cache": "kernels/_build.py:load",
    # entry points under other names
    "parallel/mesh.py:dataclasses_replace_kernel":
        "dataclasses.replace(cfg, kernel=...) in parallel/mesh.py",
    "train/gan.py:make_gan_step": "train/harness.py:CompletionTrainer "
                                  "(the GAN step of use_gan)",
    "parallel/distributed.py:initialize_multihost":
        "parallel/distributed.py:init_distributed",
    "train/submission.py:combine_shards": "train/cli.py:combine_main",
}


def _defined(path: Path) -> set:
    """The public names a module defines at its top level."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_") and n != "Array"}


def test_the_port_has_every_public_name_of_the_jax_package():
    missing, replaced = [], set()
    for path in sorted((_REPO / "houv_tpu").rglob("*.py")):
        rel = path.relative_to(_REPO / "houv_tpu")
        module = ".".join(("houv_tpu_torch",) + rel.with_suffix("").parts)
        port = None
        if (_REPO / "houv_tpu_torch" / rel).exists():
            port = importlib.import_module(module)
        for name in sorted(_defined(path)):
            key = f"{rel.as_posix()}:{name}"
            if key in REPLACED:
                replaced.add(key)
            elif port is None or not hasattr(port, name):
                missing.append(key)
    assert not missing, missing
    assert replaced == set(REPLACED)
    # each counterpart the table names exists
    for target in ("ops.gather:gather_rows", "ops.scatter:gather_rows_kernel",
                   "ops.scatter:scatter_add", "solvers.houv:houv_solve",
                   "ops.chamfer:nn_select", "ops.grouping:knn_indices",
                   "ops.emd:emd_auction", "kernels._build:load",
                   "parallel.distributed:init_distributed",
                   "train.cli:combine_main"):
        module, name = target.split(":")
        assert hasattr(importlib.import_module(f"houv_tpu_torch.{module}"),
                       name), target
