"""Reference-format HDF5 dataset: a NumPy copy of
`articulated_pose_tpu/data/hdf5_dataset.py` on the port's labeling,
batcher and augment modules; for the same files and seed its samples
and batches equal the JAX package's bit for bit.

Reads the preprocessed per-frame HDF5 files the reference pipeline
produces (reference: tools/preprocess_data.py:337-348 — groups
`gt_points/<part>` (camera-space points) and `gt_coords/<part>`
(canonical URDF-frame coords)) together with split txt files
(lib/dataset.py:47-76) and the category registry, and assembles training
samples via data.labeling.

Differences from the reference loader (lib/dataset.py):
- normalization corners/factors and joint specs come from a
  `model_info.json` per instance (written by tools/preprocess.py) or are
  computed from URDF + meshes via tools/urdf.py — no pickled
  side-channel required;
- seen/unseen filtering uses the registry's test_list identically;
- sample assembly is the shared labeling.build_sample (golden-tested).

h5py is imported when a dataset is made, not with the module: without
it `HDF5Dataset` raises ImportError (a GPU host may have none).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from articulated_pose_tpu_torch.data.batcher import BatchIterator
from articulated_pose_tpu_torch.data.labeling import (JointSpec, NormInfo,
                                                      build_sample)
from articulated_pose_tpu_torch.registry import CategorySpec, get_category


def _h5py():
    try:
        import h5py
    except ImportError:
        raise ImportError("h5py is required for HDF5Dataset") from None
    return h5py


def read_split(path: str) -> List[str]:
    with open(path, errors="replace") as f:
        return [ln.strip() for ln in f if ln.strip()]


def instance_of(path: str) -> str:
    """Instance id from .../<instance>/<articulation>/<frame>.h5
    (lib/dataset.py:59)."""
    return path.split(".")[0].split("/")[-3]


def filter_domain(files: Sequence[str], spec: CategorySpec,
                  domain: Optional[str]) -> List[str]:
    """seen/unseen filtering by held-out instance ids (lib/dataset.py:61-66)."""
    if domain is None:
        return list(files)
    unseen = set(spec.test_list)
    if domain == "seen":
        return [f for f in files if instance_of(f) not in unseen]
    if domain == "unseen":
        return [f for f in files if instance_of(f) in unseen]
    raise ValueError(f"domain must be 'seen'/'unseen'/None, got {domain!r}")


def get_test_group(files: Sequence[str], spec: CategorySpec,
                   domain: str = "unseen", full: bool = False) -> List[str]:
    """Eval-protocol frame selection (lib/data_utils.py:907-957).

    The reference evaluates on a subsampled grid — seen: every 3rd
    articulation index; unseen: every 5th frame per articulation — and
    always skips spec_list instances.  full=True keeps every frame of
    the domain (`get_full_test`).
    """
    seen_arti = {str(x) for x in range(0, 31, 3)}
    unseen_frame = {str(x) for x in range(0, 30, 5)}
    unseen = set(spec.test_list)
    skip = set(spec.spec_list)
    out = []
    for f in files:
        parts = f.split(".")[0].split("/")
        ins, art, frame = parts[-3], parts[-2], parts[-1]
        if ins in skip:
            continue
        if domain == "unseen":
            if ins in unseen and (full or frame in unseen_frame):
                out.append(f)
        elif domain == "seen":
            if ins not in unseen and (full or art in seen_arti):
                out.append(f)
        else:
            raise ValueError(f"domain must be 'seen' or 'unseen', got {domain!r}")
    return out


def get_demo_h5(all_test_h5: Sequence[str],
                spec_instances: Sequence[str] = ()) -> List[str]:
    """Demo-frame selection (lib/data_utils.py:960-967): keep .h5 entries
    whose instance id is not in spec_instances.

    The reference matched the instance by the path's first 4 characters
    (its lists were instance-relative); here the id comes from the path
    layout when present, falling back to the same prefix rule.
    """
    spec = set(spec_instances)
    out = []
    for f in all_test_h5:
        if not f.endswith("h5"):
            continue
        ins = instance_of(f) if f.count("/") >= 2 else f[0:4]
        if ins in spec:
            continue
        out.append(f)
    return out


class InstanceInfo:
    """Per-instance normalization + joints, loaded from model_info.json."""

    def __init__(self, norm: NormInfo, joints: List[JointSpec]):
        self.norm = norm
        self.joints = joints

    @classmethod
    def load(cls, path: str) -> "InstanceInfo":
        with open(path) as f:
            raw = json.load(f)
        norm = NormInfo(
            corners=[np.asarray(c, np.float64) for c in raw["corners"]],
            factors=[float(x) for x in raw["factors"]])
        joints = [JointSpec(position=np.asarray(j["position"], np.float64),
                            axis=np.asarray(j["axis"], np.float64),
                            parent=int(j["parent"]), child=int(j["child"]),
                            jtype=j.get("type", "revolute"))
                  for j in raw["joints"]]
        return cls(norm, joints)

    def dump(self, path: str) -> None:
        raw = {
            "corners": [np.asarray(c).tolist() for c in self.norm.corners],
            "factors": [float(x) for x in self.norm.factors],
            "joints": [{"position": np.asarray(j.position).reshape(-1).tolist(),
                        "axis": np.asarray(j.axis).reshape(-1).tolist(),
                        "parent": j.parent, "child": j.child, "type": j.jtype}
                       for j in self.joints],
        }
        with open(path, "w") as f:
            json.dump(raw, f, indent=1)


class HDF5Dataset:
    """Iterable dataset over reference-format HDF5 frames.

    root_dir layout (matching the reference's data dir):
      <root>/hdf5/<category>/<instance>/<articulation>/<frame>.h5
      <root>/splits/<category>/<num_expr>/{train,test,demo}.txt
      <root>/info/<category>/<instance>/model_info.json
    """

    def __init__(self, root_dir: str, category: str, mode: str = "train", *,
                 num_expr: str = "0.01", domain: Optional[str] = None,
                 num_points: int = 1024, n_max_parts: Optional[int] = None,
                 batch_size: int = 16, nocs_type: str = "AC",
                 fixed_order: bool = False, first_n: int = -1, seed: int = 0,
                 thres_r: float = 0.2, eval_subsample: bool = False,
                 add_noise: bool = False):
        self._h5py = _h5py()
        self.root_dir = root_dir
        self.spec = get_category(category)
        # BMVC15 real-depth data stays in metric camera units and is
        # normalized per sample instead of by a canonical global factor
        # (lib/dataset.py:348, lib/prediction_io.py:97-129)
        self.metric_input = self.spec.dataset_name == "BMVC15"
        self.mode = mode
        self.num_points = num_points
        self.n_max_parts = n_max_parts or self.spec.num_parts
        self.nocs_type = nocs_type
        self.fixed_order = fixed_order
        self.thres_r = thres_r
        self.batch_size = batch_size
        # input-point jitter (provider.py:99-112); GT labels stay clean —
        # only the network input is perturbed.  The reference's add_noise
        # flag was accepted but never consumed (lib/dataset.py:436,558).
        self.add_noise = add_noise and mode == "train"
        self._rng = np.random.RandomState(seed)

        split_file = os.path.join(root_dir, "splits", category, num_expr,
                                  ("train.txt" if mode == "train" else
                                   "demo.txt" if mode == "demo" else "test.txt"))
        files = read_split(split_file)
        if mode == "test":
            if eval_subsample and domain is not None:
                # the reference eval protocol's frame grid
                # (lib/data_utils.py:907-933)
                files = get_test_group(files, self.spec, domain)
            else:
                files = filter_domain(files, self.spec, domain)
        if not fixed_order:
            self._rng.shuffle(files)
        if first_n != -1:
            files = files[:first_n]
        if not files:
            raise ValueError(
                f"empty {mode!r} split for category {category!r} "
                f"(domain={domain!r}, split file {split_file}); with a "
                f"domain filter, check that the registry's test_list "
                f"instances {sorted(set(self.spec.test_list))[:6]}... "
                f"appear in the split")
        self.files = files
        self.basenames = ["_".join(p.split(".")[0].split("/")[-3:]) for p in files]
        self._info_cache: Dict[str, InstanceInfo] = {}

    # ------------------------------------------------------------------
    def _info(self, instance: str) -> InstanceInfo:
        if instance not in self._info_cache:
            path = os.path.join(self.root_dir, "info", self.spec.name,
                                instance, "model_info.json")
            self._info_cache[instance] = InstanceInfo.load(path)
        return self._info_cache[instance]

    def fetch(self, i: int) -> Dict[str, np.ndarray]:
        path = self.files[i]
        full = path if os.path.isabs(path) else os.path.join(self.root_dir, path)
        instance = instance_of(path)
        info = self._info(instance)
        with self._h5py.File(full, "r") as f:
            parts_pts, parts_canon = [], []
            for group in self.spec.parts_map:
                pts = [f["gt_points"][str(g)][()][:, :3] for g in group]
                coords = [f["gt_coords"][str(g)][()][:, :3] for g in group]
                parts_pts.append(np.concatenate(pts, axis=0))
                parts_canon.append(np.concatenate(coords, axis=0))
        joints, norm = info.joints, info.norm
        order = (self.spec.spec_map or {}).get(instance)
        if order:
            # SAPIEN per-instance part reordering (lib/dataset.py:693-699):
            # new part j is original part order[j]; joints follow via the
            # inverse id map, normalization boxes are permuted with parts
            inv = {orig: new for new, orig in enumerate(order)}
            parts_pts = [parts_pts[o] for o in order]
            parts_canon = [parts_canon[o] for o in order]
            joints = [JointSpec(position=j.position, axis=j.axis,
                                parent=inv.get(j.parent, j.parent),
                                child=inv.get(j.child, j.child),
                                jtype=j.jtype) for j in joints]
            norm = NormInfo(
                corners=[norm.corners[0]] + [norm.corners[1 + o] for o in order],
                factors=[norm.factors[0]] + [norm.factors[1 + o] for o in order])
        # NOTE: points are ALWAYS permutation-subsampled (the reference
        # does so unconditionally, lib/dataset.py:346-355 — fixed_order
        # only fixes *file* order); taking the first num_points instead
        # would truncate to part 0 whenever parts are stored contiguously.
        sample = build_sample(
            parts_pts, parts_canon, joints, norm,
            num_points=self.num_points, n_max_parts=self.n_max_parts,
            nocs_type=self.nocs_type, thres_r=self.thres_r,
            rng=(np.random.RandomState(zlib.crc32(path.encode()) % (2**31))
                 if self.fixed_order else self._rng),
            permute=True, metric_input=self.metric_input)
        if self.metric_input:
            from articulated_pose_tpu_torch.data.real import normalize_cloud

            P_norm, center, scale = normalize_cloud(sample["P"])
            sample["P"] = P_norm.astype(np.float32)
            sample["P_center"] = center.astype(np.float32)
            sample["P_scale"] = np.float32(scale)
        # NOTE: train-time jitter (add_noise) is NOT applied here — the
        # iterators cache fetch() once, which would freeze the noise to a
        # single draw per sample; it rides the iterator's per-batch
        # transform instead (augment.train_noise_batch).
        return sample

    def iterator(self, shuffle: Optional[bool] = None,
                 drop_last: bool = True, parallel: bool = False,
                 num_workers: Optional[int] = None):
        """Batch iterator.  parallel=True streams through a thread pool
        (no epoch RAM cache — right for datasets too large to cache);
        default caches the epoch in RAM like the reference
        (lib/dataset.py:109-155)."""
        shuffle = (not self.fixed_order) if shuffle is None else shuffle
        seed = self._rng.randint(2**31)
        transform = None
        if self.add_noise:
            from articulated_pose_tpu_torch.data import augment

            transform = augment.train_noise_batch
        if parallel:
            from articulated_pose_tpu_torch.data.parallel_loader import \
                ParallelLoader

            return ParallelLoader(len(self.files), self.fetch, self.batch_size,
                                  shuffle=shuffle, seed=seed,
                                  num_workers=num_workers, drop_last=drop_last,
                                  transform=transform)
        return BatchIterator(len(self.files), self.fetch, self.batch_size,
                             shuffle=shuffle, seed=seed, drop_last=drop_last,
                             transform=transform)

    def __len__(self):
        return len(self.files)
