"""The port's C++ labeling fast path against the JAX package's, on the CPU.

Both libraries are built from the same source by the same compiler, so
the port's native labels must equal JAX's native labels; against the
port's NumPy labeling they agree within 2e-5 (tests/test_native.py's
tolerance: the C++ path rounds its float64 math to float32 at other
points).  `frame(use_native=True)` must equal JAX's, and must raise,
never fall back to NumPy, when the library does not build.
"""

import numpy as np
import pytest

from articulated_pose_tpu import native as jnative
from articulated_pose_tpu.data import synthetic as jsynthetic
from articulated_pose_tpu_torch import native
from articulated_pose_tpu_torch.data import synthetic
from articulated_pose_tpu_torch.data.labeling import build_sample
from articulated_pose_tpu_torch.utils import transforms as tr

LABELS = ("P", "cls_gt", "mask_array", "nocs_gt", "nocs_gt_g", "heatmap_gt",
          "unitvec_gt", "orient_gt", "joint_cls_gt", "joint_cls_mask",
          "joint_params_gt")
JOINT_TYPES = [("revolute", "revolute"), ("prismatic",),
               ("fixed", "prismatic", "prismatic")]


def make_frame(joint_types=("revolute", "revolute"), seed=0):
    gen = synthetic.SyntheticArticulated(n_parts=len(joint_types) + 1,
                                         points_per_part=300,
                                         joint_types=joint_types, seed=seed)
    rng = np.random.RandomState(seed + 1)
    art = gen.articulation_transforms([0.5] * len(joint_types))
    cam = tr.similarity(1.1, tr.random_rotation(rng), rng.rand(3))
    parts_pts = [tr.apply_similarity(cam @ art[j], gen.parts_canon[j])
                 for j in range(gen.n_parts)]
    return gen, parts_pts


def both(gen, parts_pts, rng_seed=None, **kw):
    """Both libraries' labels; with `rng_seed`, each draws its selection
    from its own RandomState(rng_seed)."""
    def rng():
        return {} if rng_seed is None else {
            "rng": np.random.RandomState(rng_seed)}

    got = native.build_labels_native(parts_pts, gen.parts_canon, gen.joints,
                                     gen.norm, **kw, **rng())
    want = jnative.build_labels_native(parts_pts, gen.parts_canon,
                                       gen.joints, gen.norm, **kw, **rng())
    return got, want


def test_library_builds():
    assert native.available()
    assert jnative.available()


@pytest.mark.parametrize("joint_types", JOINT_TYPES)
def test_native_labels_equal_jax(joint_types):
    gen, parts_pts = make_frame(joint_types)
    K = gen.n_parts
    n_total = sum(len(p) for p in parts_pts)
    sel = np.random.RandomState(7).permutation(n_total)[:256].astype(np.int32)
    got, want = both(gen, parts_pts, num_points=256, n_max_parts=K, sel=sel)
    assert set(got) == set(want) == set(LABELS)
    for key in LABELS:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # drawn from an rng, as build_sample draws it, and K above the parts
    got, want = both(gen, parts_pts, rng_seed=3, num_points=256,
                     n_max_parts=K + 1)
    for key in LABELS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("joint_types", JOINT_TYPES)
def test_native_labels_match_numpy(joint_types):
    gen, parts_pts = make_frame(joint_types)
    K = gen.n_parts
    n_total = sum(len(p) for p in parts_pts)
    sel = np.random.RandomState(7).permutation(n_total)[:256].astype(np.int32)

    class FixedRng:
        def permutation(self, n):
            return np.concatenate([sel, np.setdiff1d(np.arange(n), sel)])

    py = build_sample(parts_pts, gen.parts_canon, gen.joints, gen.norm,
                      num_points=256, n_max_parts=K, rng=FixedRng())
    cc = native.build_labels_native(parts_pts, gen.parts_canon, gen.joints,
                                    gen.norm, num_points=256, n_max_parts=K,
                                    sel=sel)
    for key in LABELS:
        np.testing.assert_allclose(cc[key], py[key], atol=2e-5,
                                   err_msg=f"key {key}")


def test_tiled_selection():
    gen, parts_pts = make_frame(("revolute",), seed=3)
    n_total = sum(len(p) for p in parts_pts)
    num_points = n_total * 2 + 10
    sel = np.arange(num_points, dtype=np.int32)   # forces modular tiling
    got, want = both(gen, parts_pts, num_points=num_points, n_max_parts=2,
                     sel=sel)
    np.testing.assert_array_equal(got["P"], want["P"])
    np.testing.assert_allclose(got["P"][:n_total],
                               got["P"][n_total:2 * n_total])


@pytest.mark.parametrize("kw", [
    dict(n_parts=3, joint_types=["revolute", "revolute"]),
    dict(n_parts=2, joint_types=["prismatic"], full_rotation=False),
    dict(n_parts=4, joint_types=["prismatic"] * 3),
])
@pytest.mark.parametrize("seed", [0, 5])
def test_frame_use_native_equals_jax(kw, seed):
    gen = synthetic.SyntheticArticulated(points_per_part=150, seed=seed, **kw)
    jgen = jsynthetic.SyntheticArticulated(points_per_part=150, seed=seed,
                                           **kw)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):
        got, got_gt = gen.frame(r1, num_points=512, noise=0.01,
                                use_native=True)
        want, want_gt = jgen.frame(r2, num_points=512, noise=0.01,
                                   use_native=True)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got_gt.rt_nocs2cam, want_gt.rt_nocs2cam)


def test_default_takes_native_where_the_layout_matches():
    gen = synthetic.SyntheticArticulated(n_parts=2, points_per_part=100)
    for kw, native_path in ((dict(), True), (dict(nocs_type="A"), False),
                            (dict(n_max_parts=3), False)):
        args = dict(num_points=128, **kw)
        default, _ = gen.frame(np.random.RandomState(1), **args)
        chosen, _ = gen.frame(np.random.RandomState(1),
                              use_native=native_path, **args)
        for k in chosen:
            np.testing.assert_array_equal(default[k], chosen[k], err_msg=k)


def test_use_native_raises_when_the_library_does_not_build(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no compiler")
    assert not native.available()
    gen = synthetic.SyntheticArticulated(n_parts=2, points_per_part=50)
    with pytest.raises(RuntimeError, match="no compiler"):
        gen.frame(np.random.RandomState(0), num_points=64, use_native=True)
    # the default falls back to the NumPy labeling, as JAX's does
    got, _ = gen.frame(np.random.RandomState(0), num_points=64)
    want, _ = gen.frame(np.random.RandomState(0), num_points=64,
                        use_native=False)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_compiler_failure_raises(monkeypatch, tmp_path):
    src = tmp_path / "labeling.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.load()
    assert not native.available()
