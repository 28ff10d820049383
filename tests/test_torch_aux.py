"""The port's viewers, plots, profiler, k-NN grouping and pose oracles
against the JAX package's.

- `utils/ball_viewer`: the NumPy rasterizer equal to JAX's, the port's
  C++ one equal to JAX's C++ one and to the NumPy one;
- `utils/vis`: every plot writes its file (tests/test_aux.py:62-97),
  and raises ImportError naming matplotlib without it;
- `utils/profiling`: StepTimer, trace, span, stage and device_memory_stats
  on the CPU;
- `ops/core.knn_point` and `sample_and_group(knn=True)` under the SA
  MLP (JAX's `SetAbstraction(knn=True)`) within atol 1e-5 of JAX's, on
  uniform random clouds, where no two distances tie (torch.topk and
  lax.top_k may order ties differently);
- `pose/umeyama.umeyama_similarity` and `pose/lm.lm_refine_joint_ad` on
  tests/test_pose.py's inputs, with the bounds stated at each test.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from articulated_pose_tpu import native as jnative
from articulated_pose_tpu.models.pointnet2 import \
    SetAbstraction as JaxSetAbstraction
from articulated_pose_tpu.ops import core as jcore
from articulated_pose_tpu.pose import lm as jlm
from articulated_pose_tpu.pose import umeyama as jumeyama
from articulated_pose_tpu.utils import ball_viewer as jball_viewer
from articulated_pose_tpu.utils import transforms as jtr
from articulated_pose_tpu_torch import native
from articulated_pose_tpu_torch.convert import state_dict_from_flax
from articulated_pose_tpu_torch.eval.metrics import get_3d_bbox
from articulated_pose_tpu_torch.models.pointnet2 import (SetAbstraction,
                                                         sample_and_group)
from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.pose import lm, umeyama
from articulated_pose_tpu_torch.utils import ball_viewer, profiling, vis


@pytest.fixture
def cloud():
    rng = np.random.RandomState(0)
    return rng.randn(256, 3), rng.rand(256, 3) * 255


# ---------------------------------------------------------- ball viewer
@pytest.mark.parametrize("view", [
    dict(size=200, ballradius=4),
    dict(size=240, ballradius=5, xangle=0.3, yangle=-0.4, zoom=1.2),
    dict(size=160, ballradius=3, background=(10, 20, 30),
         normalizecolor=False)])
def test_numpy_renderer_equals_jax(cloud, view):
    xyz, colors = cloud
    got = ball_viewer.render_points(xyz, colors, use_native=False, **view)
    want = jball_viewer.render_points(xyz, colors, use_native=False, **view)
    np.testing.assert_array_equal(got, want)
    white = ball_viewer.render_points(xyz, None, use_native=False, **view)
    np.testing.assert_array_equal(
        white, jball_viewer.render_points(xyz, None, use_native=False, **view))


def test_native_renderer_equals_jax_and_numpy(cloud):
    assert native.available()
    xyz, colors = cloud
    view = dict(size=240, ballradius=5, xangle=0.3, yangle=-0.4, zoom=1.2)
    got = ball_viewer.render_points(xyz, colors, use_native=True, **view)
    np.testing.assert_array_equal(
        got, ball_viewer.render_points(xyz, colors, use_native=False, **view))
    if jnative.render_available():
        np.testing.assert_array_equal(
            got, jball_viewer.render_points(xyz, colors, use_native=True,
                                            **view))
    # the default takes the C++ rasterizer where it builds
    np.testing.assert_array_equal(
        got, ball_viewer.render_points(xyz, colors, **view))


def test_depth_ordering():
    """Two overlapping balls: the larger z wins, in both rasterizers."""
    xyz = np.array([[100, 100, 0], [100, 100, 50]], np.int32)
    colors = np.array([[255, 0, 0], [0, 255, 0]], np.float32)
    for render in (ball_viewer._render_balls_numpy,
                   native.render_balls_native):
        img = np.zeros((200, 200, 3), np.uint8)
        render(img, xyz, colors, 6)
        assert img[100, 100, 1] > 0 and img[100, 100, 0] == 0


def test_showpoints_headless(tmp_path, cloud):
    xyz, colors = cloud
    out = tmp_path / "view.png"
    img = ball_viewer.showpoints(xyz, colors, size=160, ballradius=3,
                                 save_path=str(out))
    assert img.shape == (160, 160, 3) and out.stat().st_size > 0
    np.testing.assert_array_equal(
        img, jball_viewer.render_points(xyz, colors, size=160, ballradius=3,
                                        use_native=False))


def test_native_render_rejects_a_strided_image(cloud):
    img = np.zeros((40, 40, 4), np.uint8)[..., :3]
    with pytest.raises(ValueError, match="C-contiguous"):
        native.render_balls_native(img, np.zeros((1, 3), np.int32),
                                   np.zeros((1, 3), np.float32), 2)


# ------------------------------------------------------------------ vis
def test_vis_writes_every_plot(tmp_path):
    rng = np.random.RandomState(1)
    pts = rng.rand(60, 3)
    joint = {"point": [0, 0, 0], "axis": [0, 0, 1]}
    d = str(tmp_path)
    vis.plot3d_pts([[pts, pts + 1]], [["a", "b"]], title="t",
                   save_path=os.path.join(d, "p.png"))
    vis.plot3d_pts([[pts]], color_channel=[[rng.rand(60, 3)]],
                   save_path=os.path.join(d, "pc.png"))
    vis.plot_arrows(pts, rng.rand(60, 3) * 0.1, joint=joint,
                    save_path=os.path.join(d, "a.png"))
    vis.hist_show([rng.rand(100)], ["err"], save_path=os.path.join(d, "h.png"))
    vis.plot_bbox(os.path.join(d, "b.png"), get_3d_bbox([1, 1, 1]), pts)
    vis.plot_arrows_list([pts, pts + 1], [rng.rand(60, 3)] * 2,
                         joints=[joint, None], titles=["a", "b"],
                         save_path=os.path.join(d, "al.png"))
    vis.plot_joints_bb_list(pts, [get_3d_bbox([1, 1, 1])], [joint, None],
                            save_path=os.path.join(d, "jb.png"))
    vis.draw_segmentation_2d(rng.rand(32, 32, 3) * 255,
                             rng.randint(0, 3, (32, 32)), 3,
                             save_path=os.path.join(d, "sg.png"))
    vis.viz_err_distri(rng.rand(200) * 10, title="rot",
                       save_path=os.path.join(d, "ed.png"))
    for f in ("p", "pc", "a", "h", "b", "al", "jb", "sg", "ed"):
        assert os.path.getsize(os.path.join(d, f + ".png")) > 0, f
    fig = vis.hist_show([rng.rand(10)], ["x"])       # no path: the figure
    assert fig is not None


def test_vis_without_matplotlib_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        vis.plot3d_pts([[np.zeros((3, 3))]],
                       save_path=str(tmp_path / "p.png"))


# ------------------------------------------------------------- profiler
def test_step_timer_summary_and_dump():
    t = profiling.StepTimer()
    for _ in range(5):
        with t.stage("a"):
            pass
    with t.stage("b", sync=torch.zeros(1)):
        pass
    s = t.summary()
    assert s["a"]["count"] == 5 and s["b"]["count"] == 1
    assert set(s["a"]) == {"mean_ms", "p50_ms", "p95_ms", "count"}
    assert 0 <= s["a"]["p50_ms"] <= s["a"]["p95_ms"]


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (x @ x).sum()
    events = json.loads((tmp_path / "tr" / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aten::matmul" in names
    assert any(e.key == "aten::matmul" for e in prof.key_averages())


def test_trace_names_each_kernel_launch(tmp_path):
    """A kernel wrapper's launch scope shows in the trace as
    "kernel:<entry>" (on the card, around each launch); outside a trace
    it is a no-op."""
    from articulated_pose_tpu_torch.ops.kernels import KERNELS

    with KERNELS["three_nn"].scope():
        pass
    with profiling.trace(str(tmp_path)):
        for name in ("fps2", "ball_query_group", "fps2"):
            with KERNELS[name].scope():
                pass
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = [e["name"] for e in events["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("kernel:fps2") == 2
    assert names.count("kernel:ball_query_group") == 1
    assert "kernel:three_nn" not in names


def test_span_is_named_only_inside_a_trace(tmp_path):
    """Outside a trace a span is the one shared null context; inside
    `profiling.trace` it is a range named by its name and ids, nested in
    the span around it."""
    assert profiling.span("a.b", call=1) is profiling.span("c")
    with profiling.trace(str(tmp_path)):
        with profiling.span("a.b", call=3, shard=0):
            with profiling.span("a.c"):
                torch.ones(2).add_(1)
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"])
             for e in events["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert set(spans) == {"a.b call=3 shard=0", "a.c"}
    outer, inner = spans["a.b call=3 shard=0"], spans["a.c"]
    assert outer[0] <= inner[0] <= inner[1] <= outer[1]


def test_a_stage_mark_reaches_only_the_capture_in_progress():
    marks = []
    profiling.stage("early")
    with profiling.staging(marks.append):
        profiling.stage("a")
        with profiling.staging(lambda n: marks.append("inner " + n)):
            profiling.stage("b")
        other = threading.Thread(target=profiling.stage, args=("other",))
        other.start()
        other.join()
        profiling.stage("c")
    profiling.stage("late")
    assert marks == ["a", "inner b", "c"]


def test_device_memory_stats_on_the_cpu():
    assert profiling.device_memory_stats() is None


# ------------------------------------------------------------------ kNN
@pytest.mark.parametrize("B,N,M,k", [(2, 64, 16, 8), (3, 200, 50, 3),
                                     (1, 33, 33, 33)])
def test_knn_point_equals_jax(B, N, M, k):
    rng = np.random.RandomState(N)
    xyz = rng.rand(B, N, 3).astype(np.float32)
    new = rng.rand(B, M, 3).astype(np.float32)
    dist, idx = core.knn_point(k, torch.from_numpy(xyz), torch.from_numpy(new))
    jdist, jidx = jcore.knn_point(k, jnp.asarray(xyz), jnp.asarray(new))
    assert idx.dtype == torch.int32 and idx.shape == (B, M, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("features", [0, 4])
def test_set_abstraction_knn_equals_jax(features):
    rng = np.random.RandomState(features)
    B, N = 2, 128
    xyz = rng.rand(B, N, 3).astype(np.float32)
    pts = rng.randn(B, N, features).astype(np.float32) if features else None
    jsa = JaxSetAbstraction(npoint=32, radius=0.3, nsample=8, mlp=(16, 24),
                            knn=True)
    args = (jnp.asarray(xyz), None if pts is None else jnp.asarray(pts))
    variables = jsa.init(jax.random.PRNGKey(0), *args)
    jxyz, jout, jidx = jsa.apply(variables, *args)
    flat = traverse_util.flatten_dict(jax.device_get(variables), sep="/")
    sa = SetAbstraction(3 + features, (16, 24), torch.float32).eval()
    sa.load_state_dict(state_dict_from_flax(
        {k: np.asarray(v) for k, v in flat.items()}))
    with torch.no_grad():
        new_xyz, grouped = sample_and_group(
            32, 0.3, 8, torch.from_numpy(xyz),
            None if pts is None else torch.from_numpy(pts), torch.float32,
            knn=True)
        out = sa(grouped)
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(jxyz))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)


# ----------------------------------------------------------- pose oracles
def random_similarity(rng):       # tests/test_pose.py:16
    return (rng.uniform(0.5, 2.0), jtr.random_rotation(rng),
            rng.uniform(-1, 1, 3))


@pytest.mark.parametrize("case", ["exact", "noisy", "weighted", "mirror"])
def test_umeyama_similarity_equals_jax(case):
    rng = np.random.RandomState(0)
    src = rng.rand(50, 3)
    s, R, t = random_similarity(rng)
    tgt = s * src @ R.T + t                   # tests/test_pose.py:29's input
    w = None
    if case in ("noisy", "weighted"):
        tgt = tgt + 0.02 * rng.randn(50, 3)
    if case == "weighted":
        w = (rng.rand(50) < 0.7).astype(np.float32)
    if case == "mirror":                      # det < 0: the flip branch
        tgt = tgt * np.array([1.0, 1.0, -1.0])
    src, tgt = src.astype(np.float32), tgt.astype(np.float32)
    got = umeyama.umeyama_similarity(
        torch.from_numpy(src), torch.from_numpy(tgt),
        None if w is None else torch.from_numpy(w))
    want = jumeyama.umeyama_similarity(
        jnp.asarray(src), jnp.asarray(tgt), None if w is None else jnp.asarray(w))
    # two f32 SVDs (LAPACK through torch and through XLA): 1e-5, the
    # bound tests/test_pose.py:29 holds JAX's own fit to
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-5)
    if case == "exact":
        np.testing.assert_allclose(got[0].numpy(), R, atol=1e-5)
        np.testing.assert_allclose(float(got[1]), s, rtol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), t, atol=1e-5)


def test_umeyama_similarity_batched():
    rng = np.random.RandomState(2)
    src = rng.rand(4, 30, 3)
    tgt = rng.rand(4, 30, 3)
    R, s, t = umeyama.umeyama_similarity(torch.from_numpy(src),
                                         torch.from_numpy(tgt))
    for b in range(4):
        r1, s1, t1 = umeyama.umeyama_similarity(torch.from_numpy(src[b]),
                                                torch.from_numpy(tgt[b]))
        torch.testing.assert_close(R[b], r1)
        torch.testing.assert_close(s[b], s1)
        torch.testing.assert_close(t[b], t1)


def lm_inputs(prismatic):
    """tests/test_pose.py:468's problem."""
    rng = np.random.RandomState(3)
    P = 48
    v0 = rng.randn(3) * 0.5
    v1 = rng.randn(3) * 0.5
    x0 = rng.randn(P, 3).astype(np.float32)
    x1 = rng.randn(P, 3).astype(np.float32)
    R0t = np.asarray(jlm.rotvec_to_matrix(jnp.asarray(v0 + 0.1)))
    R1t = np.asarray(jlm.rotvec_to_matrix(jnp.asarray(v1 - 0.1)))
    y0 = (x0 @ R0t.T + 0.01 * rng.randn(P, 3)).astype(np.float32)
    y1 = (x1 @ R1t.T + 0.01 * rng.randn(P, 3)).astype(np.float32)
    m0 = (rng.rand(P) < 0.8).astype(np.float32)
    m1 = (rng.rand(P) < 0.8).astype(np.float32)
    a = rng.randn(3)
    a = a / np.linalg.norm(a)
    mult = np.float32(min(m0.sum(), m1.sum()))
    return tuple(np.asarray(x, np.float32)
                 for x in (v0, v1, x0, y0, m0, x1, y1, m1, a, mult))


@pytest.mark.parametrize("prismatic", [False, True])
def test_lm_refine_joint_ad_equals_jax(prismatic):
    args = lm_inputs(prismatic)
    got = lm.lm_refine_joint_ad(*map(torch.from_numpy, args), iters=12,
                                prismatic=prismatic)
    want = jlm.lm_refine_joint_ad(*map(jnp.asarray, args), iters=12,
                                  prismatic=prismatic)
    analytic = lm.lm_refine_joint(*map(torch.from_numpy, args), iters=12,
                                  prismatic=prismatic)
    # tests/test_pose.py:484's bound: f32 order differences compound
    # through 12 damped accept/reject iterations
    for g, w, a in zip(got, want, analytic):
        assert g.dtype == torch.float32 and g.shape == (3,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4)
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=5e-4)
