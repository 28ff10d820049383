"""The port's reference-format data path against the JAX package's, on the
CPU: `HDF5Dataset` samples and batches bit for bit on a dataset written
by JAX's `export_hdf5` (train, test, each domain, the eval-protocol grid,
the SAPIEN spec map, a BMVC15 category), both iterators, the port's
`export_hdf5`, prediction files written by one package and read by the
other, `data/real.py`, and the ImportError without h5py."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from articulated_pose_tpu import registry as jregistry
from articulated_pose_tpu.data import hdf5_dataset as jh5
from articulated_pose_tpu.data import real as jreal
from articulated_pose_tpu.data.synthetic import \
    SyntheticArticulated as JSynthetic
from articulated_pose_tpu.utils import prediction_io as jpio
from articulated_pose_tpu_torch import registry
from articulated_pose_tpu_torch.data import hdf5_dataset as h5
from articulated_pose_tpu_torch.data import real
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.utils import prediction_io as pio

import h5py

N = 128
# eyeglasses' test_list holds 0007 and its spec_list 0006, so both
# domains and the eval grid's skip rule have frames to act on
INSTANCES = ("0001", "0006", "0007")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_export"))
    gen = JSynthetic(n_parts=3, points_per_part=150, seed=0)
    gen.export_hdf5(root, "eyeglasses", frames_per_instance=6,
                    test_fraction=0.34, instance_names=INSTANCES)
    return root


def both(root, category, **kw):
    """The same dataset in each package: (port, JAX)."""
    return (h5.HDF5Dataset(root, category, **kw),
            jh5.HDF5Dataset(root, category, **kw))


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_fetches_equal(ds, jds):
    assert ds.files == jds.files and ds.basenames == jds.basenames
    for i in range(len(jds)):
        assert_same(ds.fetch(i), jds.fetch(i))


@pytest.mark.parametrize("kw", [
    dict(mode="train"),
    dict(mode="train", fixed_order=True),
    dict(mode="test", fixed_order=True),
    dict(mode="test", domain="seen", fixed_order=True),
    dict(mode="test", domain="unseen", fixed_order=True),
    dict(mode="test", domain="seen", eval_subsample=True, fixed_order=True),
    dict(mode="test", domain="unseen", eval_subsample=True,
         fixed_order=True),
    dict(mode="test", nocs_type="A", fixed_order=True),
], ids=["train", "train_fixed", "test", "seen", "unseen", "seen_grid",
        "unseen_grid", "npcs"])
def test_fetch_equals_jax(root, kw):
    ds, jds = both(root, "eyeglasses", num_points=N, batch_size=2, **kw)
    assert len(ds) > 0
    assert_fetches_equal(ds, jds)


def test_spec_map_reordering(tmp_path, monkeypatch):
    """JAX's TestSpecMapReordering setup: part j of an instance with a
    spec_map order is its original part order[j]."""
    root = str(tmp_path)
    JSynthetic(n_parts=3, points_per_part=120, seed=1).export_hdf5(
        root, "specmap_cat", n_instances=1, frames_per_instance=2,
        test_fraction=0.0)
    for reg in (registry, jregistry):
        monkeypatch.setattr(reg, "DATASETS", dict(reg.DATASETS))
        reg.register_category(reg.CategorySpec(
            name="specmap_cat", parts_map=((0,), (1,), (2,)), num_parts=3,
            spec_map={"0000": [2, 0, 1]},
            joint_types=("revolute", "revolute")))
    ds, jds = both(root, "specmap_cat", mode="train", num_points=360,
                   batch_size=1, fixed_order=True)
    assert_fetches_equal(ds, jds)
    ds.spec = dataclasses.replace(ds.spec, spec_map=None)
    plain = ds.fetch(0)
    cnt = np.bincount(plain["cls_gt"].astype(int), minlength=3)
    mapped = np.bincount(jds.fetch(0)["cls_gt"].astype(int), minlength=3)
    np.testing.assert_array_equal(mapped, cnt[[2, 0, 1]])


def test_bmvc15_metric_input(tmp_path):
    root = str(tmp_path)
    JSynthetic(n_parts=2, points_per_part=150, seed=0,
               joint_types=["revolute"]).export_hdf5(
        root, "Laptop", frames_per_instance=4, test_fraction=0.5,
        instance_names=("0001", "0006"))
    for kw in (dict(mode="test", domain="unseen", fixed_order=True),
               dict(mode="train")):
        ds, jds = both(root, "Laptop", num_points=N, batch_size=2, **kw)
        assert ds.metric_input
        assert_fetches_equal(ds, jds)
        assert "P_center" in ds.fetch(0) and "P_scale" in ds.fetch(0)


@pytest.mark.parametrize("kw,it_kw", [
    (dict(mode="train"), dict()),
    (dict(mode="train", add_noise=True), dict()),
    (dict(mode="test", fixed_order=True), dict(drop_last=False)),
    (dict(mode="train", fixed_order=True), dict(shuffle=True, parallel=True,
                                                num_workers=3)),
    (dict(mode="train", fixed_order=True, add_noise=True),
     dict(shuffle=True, parallel=True, num_workers=2)),
], ids=["cached", "cached_noise", "test", "parallel", "parallel_noise"])
def test_iterators_equal_jax(root, kw, it_kw):
    """Both iterators' batches, two epochs, equal JAX's; the parallel
    loader (fixed_order: a frame's sampling is seeded by its path, so
    worker threads cannot reorder it) equals the cached one."""
    ds, jds = both(root, "eyeglasses", num_points=N, batch_size=3, **kw)
    it, jit = ds.iterator(**it_kw), jds.iterator(**it_kw)
    assert len(it) == len(jit) > 0
    for _ in range(2):
        got, want = list(it), list(jit)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    if it_kw.get("parallel"):
        cached = h5.HDF5Dataset(root, "eyeglasses", num_points=N,
                                batch_size=3, **kw).iterator(
            shuffle=True)
        for g, w in zip(cached, h5.HDF5Dataset(
                root, "eyeglasses", num_points=N, batch_size=3,
                **kw).iterator(**it_kw)):
            assert_same(w, g)


def test_port_export_writes_jaxs_files(tmp_path):
    """export_hdf5 of the port writes the datasets, model_info.json and
    split files of JAX's, byte for byte in content."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(frames_per_instance=3, test_fraction=0.34,
              instance_names=("0001", "0007"))
    got = SyntheticArticulated(n_parts=3, points_per_part=100,
                               seed=5).export_hdf5(a, "eyeglasses", **kw)
    want = JSynthetic(n_parts=3, points_per_part=100, seed=5).export_hdf5(
        b, "eyeglasses", **kw)
    assert got == want
    for dirpath, _, names in os.walk(b):
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name), b)
            pa, pb = os.path.join(a, rel), os.path.join(b, rel)
            if name.endswith(".h5"):
                with h5py.File(pa) as fa, h5py.File(pb) as fb:
                    for grp in ("gt_points", "gt_coords"):
                        assert set(fa[grp]) == set(fb[grp])
                        for k in fb[grp]:
                            np.testing.assert_array_equal(fa[grp][k][()],
                                                          fb[grp][k][()])
            elif name.endswith(".json"):
                assert json.load(open(pa)) == json.load(open(pb))
            else:
                assert open(pa).read() == open(pb).read()


def _prediction_batch(seed=0, B=3, K=3):
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.rand(*s).astype(np.float32)  # noqa: E731
    pred = {"W": f32(B, N, K), "nocs_per_point": f32(B, N, 3 * K),
            "gocs_per_point": f32(B, N, 3 * K), "confi_per_point": f32(B, N, 1),
            "heatmap_per_point": f32(B, N, 1),
            "unitvec_per_point": f32(B, N, 3),
            "joint_axis_per_point": f32(B, N, 3),
            "index_per_point": f32(B, N, K), "global_scale": f32(B, N, K)}
    batch = {"P": f32(B, N, 3), "cls_gt": rng.randint(0, K, (B, N)).astype(
        np.float32), "nocs_gt": f32(B, N, 3), "joint_cls_gt": f32(B, N),
        "P_center": f32(B, 3), "P_scale": f32(B), "mask_array": f32(B, N, K)}
    return pred, batch


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_prediction_files_cross_read(tmp_path, writer):
    pred, batch = _prediction_batch()
    if writer == "jax":
        # JAX's writer gzips every dataset, and h5py refuses a filter on a
        # scalar: a BMVC15 batch's P_scale raises there (the port writes
        # scalars uncompressed)
        with pytest.raises(TypeError, match="Scalar datasets"):
            jpio.save_batch_predictions(pred, batch, ["x"],
                                        str(tmp_path / "bmvc15"))
        del batch["P_scale"]
    names = ["a_0_1", "b_0_2", "c_1_0"]
    save, load = ((pio.save_batch_predictions, jpio.load_prediction)
                  if writer == "port" else
                  (jpio.save_batch_predictions, pio.load_prediction))
    paths = save(pred, batch, names, str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [n + ".h5" for n in names]
    want_keys = ({o for o, k in jpio._PRED_KEYS if k in pred}
                 | {o for o, k in jpio._GT_KEYS if k in batch})
    for i, p in enumerate(paths):
        got = load(p)
        assert set(got) == want_keys
        for o, k in jpio._PRED_KEYS:
            np.testing.assert_array_equal(got[o], pred[k][i])
        for o, k in jpio._GT_KEYS:
            if k in batch:
                np.testing.assert_array_equal(got[o], batch[k][i])
        # and the other package reads the same
        assert_same(got, (jpio if writer == "jax" else pio).load_prediction(p))


def test_empty_split_message_is_jaxs(tmp_path):
    root = str(tmp_path)
    JSynthetic(n_parts=3, points_per_part=100, seed=2).export_hdf5(
        root, "eyeglasses", n_instances=1, frames_per_instance=2,
        test_fraction=0.5)
    kw = dict(mode="test", domain="unseen", num_points=64, batch_size=1)
    with pytest.raises(ValueError, match="empty 'test' split") as got:
        h5.HDF5Dataset(root, "eyeglasses", **kw)
    with pytest.raises(ValueError) as want:
        jh5.HDF5Dataset(root, "eyeglasses", **kw)
    assert str(got.value) == str(want.value)


def test_helpers_equal_jax(root, tmp_path):
    files = h5.read_split(os.path.join(root, "splits", "eyeglasses", "0.01",
                                       "test.txt"))
    assert files == jh5.read_split(os.path.join(
        root, "splits", "eyeglasses", "0.01", "test.txt"))
    spec, jspec = (registry.get_category("eyeglasses"),
                   jregistry.get_category("eyeglasses"))
    paths = [f"hdf5/eyeglasses/{ins}/{art}/{fr}.h5" for ins in INSTANCES
             for art in (0, 3, 4) for fr in (0, 5, 7)]
    assert [h5.instance_of(p) for p in paths] == [jh5.instance_of(p)
                                                  for p in paths]
    for dom in (None, "seen", "unseen"):
        assert h5.filter_domain(paths, spec, dom) == jh5.filter_domain(
            paths, jspec, dom)
    for dom in ("seen", "unseen"):
        for full in (False, True):
            got = h5.get_test_group(paths, spec, dom, full)
            assert got == jh5.get_test_group(paths, jspec, dom, full)
    demo = paths + ["0006_x.h5", "0001_y.h5", "notes.txt"]
    assert h5.get_demo_h5(demo, ("0006",)) == jh5.get_demo_h5(demo, ("0006",))
    for bad in (lambda: h5.filter_domain(paths, spec, "all"),
                lambda: h5.get_test_group(paths, spec, "all")):
        with pytest.raises(ValueError):
            bad()
    info = os.path.join(root, "info", "eyeglasses", "0001",
                        "model_info.json")
    h5.InstanceInfo.load(info).dump(str(tmp_path / "info.json"))
    assert json.load(open(tmp_path / "info.json")) == json.load(open(info))


def test_real_equals_jax():
    rng = np.random.RandomState(3)
    P = rng.rand(300, 3) * 2.0 + 1.0
    for got, want in zip(real.normalize_cloud(P), jreal.normalize_cloud(P)):
        np.testing.assert_array_equal(got, want)
    R, t, c = np.eye(3), rng.rand(3), rng.rand(3)
    for got, want in zip(real.denormalize_pose(R, 0.7, t, c, 2.5),
                         jreal.denormalize_pose(R, 0.7, t, c, 2.5)):
        np.testing.assert_array_equal(got, want)
    cls = rng.randint(0, 3, 300)
    nocs = rng.rand(300, 3)
    for n_pts in (128, 512):              # subsampled, and tiled up
        got = real.build_real_sample(P, cls, nocs, num_points=n_pts,
                                     rng=np.random.RandomState(1))
        want = jreal.build_real_sample(P, cls, nocs, num_points=n_pts,
                                       rng=np.random.RandomState(1))
        assert_same(got, want)


def test_without_h5py_raises_naming_it(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        h5.HDF5Dataset(root, "eyeglasses", num_points=N)
    pred, batch = _prediction_batch()
    with pytest.raises(ImportError, match="h5py"):
        pio.save_batch_predictions(pred, batch, ["a", "b", "c"], root)
    with pytest.raises(ImportError, match="h5py"):
        pio.load_prediction("unused.h5")
    with pytest.raises(ImportError, match="h5py"):
        SyntheticArticulated(n_parts=2).export_hdf5(root, "laptop")
