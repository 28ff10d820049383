"""Command line — train / predict / fit poses / evaluate / serve on the card.

Counterpart of the JAX package's `main.py`, command for command and flag
for flag; it writes the same files (checkpoints, test_pred/*.h5,
eval_*.json, poses.npz, joint_baseline_eval.json) with the same report
keys and the same error messages:

  python -m articulated_pose_tpu_torch train --item=eyeglasses --nocs_type=ancsh
  python -m articulated_pose_tpu_torch test  --item=eyeglasses --domain=unseen
  python -m articulated_pose_tpu_torch pose  --item=eyeglasses --domain=unseen
  python -m articulated_pose_tpu_torch eval  --item=eyeglasses --domain=unseen
  python -m articulated_pose_tpu_torch demo  --synthetic        # no dataset needed
  python -m articulated_pose_tpu_torch serve --input clouds.npy
  python -m articulated_pose_tpu_torch eval  --from_pred <dir>  # offline protocol

With --synthetic, frames come from the procedural generator
(data/synthetic.py), so every stage runs end to end with no dataset.
One flag is the port's own: --device (default cuda).  Every command
runs on the card unless --device names another device; without a card
the default raises.  The reference-format HDF5 paths (--data_root
frames, `test`'s prediction files, --from_pred) need h5py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch


def build_config(args):
    from articulated_pose_tpu_torch.config import load_config
    from articulated_pose_tpu_torch.registry import get_category

    overrides = {}
    spec = get_category(args.item)
    overrides["category"] = args.item
    overrides["nocs_type"] = args.nocs_type
    overrides["n_max_parts"] = spec.num_parts
    if args.data_root:
        overrides["data_root"] = args.data_root
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.num_points:
        overrides["num_points"] = args.num_points
    if args.backbone != "reference":
        overrides["backbone_preset"] = args.backbone
    cfg = load_config(args.config, **overrides)
    return cfg, spec


def make_datasets(args, cfg, spec, mode: str, domain=None,
                  eval_subsample=False):
    """The batch iterator of a split (main.py:49-94).  It carries
    `basenames`, and on the synthetic path also `frame_gts` (the
    renderer's exact GT) and `generator`."""
    if args.synthetic:
        from articulated_pose_tpu_torch.data.batcher import BatchIterator
        from articulated_pose_tpu_torch.data.synthetic import \
            SyntheticArticulated

        gen = SyntheticArticulated(
            n_parts=spec.num_parts, points_per_part=400,
            joint_types=list(spec.joint_types), seed=0)
        n = args.synthetic_frames
        rng = np.random.RandomState(0 if mode == "train" else 1)
        samples = [gen.frame(rng, num_points=cfg.num_points,
                             n_max_parts=cfg.n_max_parts,
                             nocs_type="AC" if cfg.is_mixed else "A")
                   for _ in range(n)]
        frames = [s for s, _ in samples]
        transform = None
        if mode == "train" and cfg.train_data_add_noise:
            # per-batch (post-cache) jitter, the HDF5 path's policy too
            from articulated_pose_tpu_torch.data import augment

            transform = augment.train_noise_batch
        gts = [g for _, g in samples]
        it = BatchIterator(n, lambda i: frames[i], cfg.batch_size,
                           shuffle=(mode == "train"), seed=0,
                           drop_last=(mode == "train"),
                           transform=transform)
        it.basenames = [f"synth_{mode}_{i}" for i in range(n)]
        it.frame_gts = gts
        it.generator = gen
        return it
    from articulated_pose_tpu_torch.data.hdf5_dataset import HDF5Dataset

    ds = HDF5Dataset(cfg.data_root, cfg.category, mode=mode,
                     num_expr=cfg.num_expr, domain=domain,
                     num_points=cfg.num_points, n_max_parts=cfg.n_max_parts,
                     batch_size=cfg.batch_size,
                     nocs_type="AC" if cfg.is_mixed else "A",
                     fixed_order=(mode != "train"),
                     eval_subsample=eval_subsample,
                     add_noise=cfg.train_data_add_noise)
    it = ds.iterator(shuffle=(mode == "train"),
                     drop_last=(mode == "train"))
    it.basenames = ds.basenames
    return it


def work_dir(args, cfg) -> str:
    return args.work_dir or os.path.join(cfg.experiment_dir, cfg.category,
                                         cfg.nocs_type)


def make_trainer(args, cfg):
    """The ANCSH model with the reference's initialisation drawn from
    cfg.seed, and its trainer on --device."""
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.train.trainer import Trainer

    model = build_model(cfg, torch.Generator().manual_seed(cfg.seed))
    return Trainer(model, cfg, work_dir=work_dir(args, cfg),
                   device=args.device)


def cmd_train(args):
    cfg, spec = build_config(args)
    train_it = make_datasets(args, cfg, spec, "train")
    val_its = []
    if not args.synthetic:
        # a val split with no matching instances (e.g. a dataset whose ids
        # don't overlap the registry's unseen list) skips that val set
        # with a warning; test/eval modes still error loudly on it
        for dom in ("seen", "unseen"):
            try:
                val_its.append(
                    make_datasets(args, cfg, spec, "test", domain=dom))
            except ValueError as e:
                print(f"WARNING: skipping {dom} validation set: {e}")
    tr = make_trainer(args, cfg)
    resumed = tr.maybe_restore()
    print(f"work_dir={tr.work_dir} resumed_step={resumed}")
    out = tr.fit(train_it, val_its, n_epochs=args.epochs,
                 max_steps=args.max_steps)
    print("final:", json.dumps({k: round(float(v), 5) for k, v in out.items()}))


def cmd_test(args):
    """Run prediction and dump per-frame h5 in the reference schema."""
    from articulated_pose_tpu_torch.utils.prediction_io import \
        save_batch_predictions

    cfg, spec = build_config(args)
    test_it = make_datasets(args, cfg, spec, "test", domain=args.domain)
    tr = make_trainer(args, cfg)
    restored = tr.maybe_restore()
    print(f"restored checkpoint step {restored}"
          if restored else "WARNING: no checkpoint found — predictions come "
                           "from a randomly initialized model")
    save_dir = os.path.join(tr.work_dir, "test_pred")
    names = list(test_it.basenames)
    lo = 0
    for batch in test_it:
        pred = tr.predict(batch)
        bs = batch["P"].shape[0]
        save_batch_predictions(pred, batch, names[lo:lo + bs], save_dir)
        lo += bs
    print(f"wrote {lo} prediction files to {save_dir}")


# h5 output key -> model prediction key (utils/prediction_io._PRED_KEYS
# reversed); `instance_per_point` keeps the reference's legacy name for W
_H5_TO_PRED = {
    "instance_per_point": "W",
    "nocs_per_point": "nocs_per_point",
    "gocs_per_point": "gocs_per_point",
    "confidence": "confi_per_point",
    "heatmap_per_point": "heatmap_per_point",
    "unitvec_per_point": "unitvec_per_point",
    "joint_axis_per_point": "joint_axis_per_point",
    "index_per_point": "index_per_point",
}
_H5_GT_KEYS = ("P", "cls_gt", "nocs_gt", "nocs_gt_g", "heatmap_gt",
               "unitvec_gt", "orient_gt", "joint_cls_gt",
               "P_center", "P_scale")
_FIT_KEYS = ("W", "nocs_per_point", "gocs_per_point", "joint_axis_per_point",
             "index_per_point")


def iter_saved_predictions(pred_dir: str, batch_size: int,
                           baseline_dir: Optional[str] = None,
                           n_max_parts: Optional[int] = None):
    """Yield (pred, batch) dicts from per-frame prediction h5 files
    (main.py:173-219).

    The decoupled offline protocol (reference: evaluation/
    parallel_ancsh_pose.py:225-247 + pose_multi_process.py — the pose
    stage never shares a process with the network).  Files are consumed
    in sorted basename order, `batch_size` frames per yield.

    With `baseline_dir`, each frame's segmentation + part NOCS come from
    the separately trained NPCS baseline's h5 of the same basename while
    the joint heads stay from the ANCSH h5 — the reference's
    USE_BASELINE pairing (parallel_ancsh_pose.py:197,233-238).
    """
    from articulated_pose_tpu_torch.utils.prediction_io import load_prediction

    names = sorted(n for n in os.listdir(pred_dir) if n.endswith(".h5"))
    if not names:
        sys.exit(f"--from_pred: no .h5 prediction files under {pred_dir}")
    for lo in range(0, len(names), batch_size):
        frames = []
        for n in names[lo:lo + batch_size]:
            d = load_prediction(os.path.join(pred_dir, n))
            if baseline_dir is not None:
                bpath = os.path.join(baseline_dir, n)
                if not os.path.exists(bpath):
                    sys.exit(f"--baseline_pred: no matching {n} under "
                             f"{baseline_dir}")
                fb = load_prediction(bpath)
                d["instance_per_point"] = fb["instance_per_point"]
                d["nocs_per_point"] = fb["nocs_per_point"]
            frames.append(d)
        pred = {pk: np.stack([f[hk] for f in frames])
                for hk, pk in _H5_TO_PRED.items() if hk in frames[0]}
        batch = {k: np.stack([f[k] for f in frames])
                 for k in _H5_GT_KEYS if k in frames[0]}
        if n_max_parts is not None:
            got = pred["nocs_per_point"].shape[-1]
            if got != 3 * n_max_parts:
                sys.exit(f"--from_pred: nocs_per_point has {got} channels "
                         f"but --item implies {3 * n_max_parts} "
                         f"(n_max_parts={n_max_parts}) — wrong --item for "
                         "this prediction dir?")
        yield pred, batch


def _pose_list(parts):
    return {k: [p[k] if p else None for p in parts] for k in ("R", "s", "t")}


def _decomposed(rts):
    from articulated_pose_tpu_torch.utils import transforms as trn

    g = {"R": [], "s": [], "t": []}
    for rt in rts:
        s_, R_, t_ = trn.decompose_similarity(rt)
        g["R"].append(R_)
        g["s"].append(s_)
        g["t"].append(t_)
    return g


def cmd_pose_eval(args, draws: Optional[Callable] = None):
    """Pose fitting + evaluation in one pass (main.py:222-436; the
    synthetic path has exact GT).

    `draws(B) -> PoseDraws` gives each batch's RANSAC draws; by default
    a generator on the device reseeded from cfg.seed for every batch, as
    JAX reuses PRNGKey(cfg.seed) for every batch.  Each batch's fits
    come to the host once.
    """
    from articulated_pose_tpu_torch.eval.pipeline import (
        compute_gt_poses, evaluate_fits, gt_joint_lines, joint_errors,
        pred_joint_lines, segmentation_iou)
    from articulated_pose_tpu_torch.pose.naocs import naocs_pred_view
    from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                          PoseFitConfig,
                                                          fit_frame_batch)

    cfg, spec = build_config(args)
    device = torch.device(args.device)
    if args.from_pred:
        # offline path: no model, no checkpoint — predictions from disk
        if args.synthetic:
            sys.exit("--from_pred and --synthetic are mutually exclusive "
                     "(saved predictions carry their own GT labels)")
        test_it = None
        work = args.work_dir or args.from_pred
        print(f"evaluating saved predictions from {args.from_pred}"
              + (f" paired with baseline {args.baseline_pred}"
                 if args.baseline_pred else ""))

        def batch_source():
            return iter_saved_predictions(args.from_pred, cfg.batch_size,
                                          baseline_dir=args.baseline_pred,
                                          n_max_parts=cfg.n_max_parts)
    else:
        # the reference eval protocol runs on a subsampled frame grid
        # (lib/data_utils.py:907-933); --full_test keeps every frame
        test_it = make_datasets(args, cfg, spec, "test", domain=args.domain,
                                eval_subsample=not args.full_test)
        trainer = make_trainer(args, cfg)
        work = trainer.work_dir
        restored = trainer.maybe_restore()
        print(f"restored checkpoint step {restored}"
              if restored else "WARNING: no checkpoint found — evaluating a "
                               "randomly initialized model")

        def batch_source():
            for batch in test_it:
                yield trainer.predict(batch), batch
    pose_cfg = PoseFitConfig(
        n_parts=cfg.n_max_parts, niter_part=cfg.ransac_niter_part,
        niter_joint=cfg.ransac_niter_joint, inlier_th=cfg.ransac_inlier_th,
        joint_types=tuple(spec.joint_types),
        use_gt_association=cfg.use_gt_joint_association)
    if draws is None:
        generator = torch.Generator(device=device)

        def draws(B):
            generator.manual_seed(cfg.seed)
            return PoseDraws.sample(B, pose_cfg, generator, device)
    naocs_mode = args.nocs == "NAOCS"
    fits, gts = [], []
    gts_global, P_l, cls_pred_l = [], [], []
    nocs_pred_l, nocs_gt_l, cls_l = [], [], []
    joint_errs = []
    seg_miou, seg_miou_h = [], []
    fi = 0
    for pred, batch in batch_source():
        pose_pred = {k: torch.as_tensor(pred[k], device=device)
                     for k in _FIT_KEYS if k in pred}
        if naocs_mode:
            # NAOCS baseline fit: source coords from the gocs head
            # (baseline_naocs.py:244-262 equivalent)
            pose_pred = naocs_pred_view(pose_pred, cfg.n_max_parts)
        # GT joint association for the axis vote (the reference
        # evaluation/ solver's protocol, parallel_ancsh_pose.py:244-247)
        # only when configured AND labeled
        jc_gt = (torch.as_tensor(batch["joint_cls_gt"], device=device)
                 if pose_cfg.use_gt_association and "joint_cls_gt" in batch
                 else None)
        P = torch.as_tensor(np.asarray(batch["P"], np.float32), device=device)
        B = P.shape[0]
        out = {k: v.cpu().numpy() for k, v in fit_frame_batch(
            pose_pred, P, draws(B), pose_cfg, joint_cls_gt=jc_gt).items()}
        prefix = "nonlinear" if ("nonlinear_R" in out and not args.baseline_only) \
            else "baseline"
        # GT poses: NAOCS fits are scored against GT NAOCS poses
        # (baseline_naocs.py:216-218), NPCS fits against part-NOCS poses
        gt_src_key = "nocs_gt_g" if naocs_mode else "nocs_gt"
        for i in range(B):
            # copies: the BMVC15 branch below denormalizes in place
            fits.append({"R": np.array(out[f"{prefix}_R"][i]),
                         "s": np.array(out[f"{prefix}_s"][i]),
                         "t": np.array(out[f"{prefix}_t"][i])})
            cls = batch["cls_gt"][i].astype(int)
            if args.synthetic:
                gt_frame = test_it.frame_gts[fi]
                g = _decomposed((gt_frame.rt_naocs2cam if naocs_mode
                                 else gt_frame.rt_nocs2cam)[:cfg.n_max_parts])
            else:
                g = _pose_list(compute_gt_poses(batch[gt_src_key][i],
                                                batch["P"][i], cls,
                                                cfg.n_max_parts))
            # GLOBAL-NOCS GT poses for the relative inter-part metrics
            # (eval_pose_err.py:326-330 uses the NAOCS GT rts for the
            # translation delta — both parts share that frame)
            if args.synthetic:
                gg = _decomposed(
                    test_it.frame_gts[fi].rt_naocs2cam[:cfg.n_max_parts])
            elif "nocs_gt_g" in batch:
                gg = _pose_list(compute_gt_poses(batch["nocs_gt_g"][i],
                                                 batch["P"][i], cls,
                                                 cfg.n_max_parts))
            else:
                gg = None
            gts_global.append(gg)
            P_l.append(np.asarray(batch["P"][i]))
            cls_pred_l.append(np.argmax(np.asarray(pred["W"][i]), axis=-1))
            if "P_center" in batch:
                # BMVC15 real data: errors are reported in metric camera
                # space (lib/prediction_io.py:97-129 P_center/P_scale)
                from articulated_pose_tpu_torch.data.real import \
                    denormalize_pose

                c, sc = batch["P_center"][i], float(batch["P_scale"][i])
                for j in range(cfg.n_max_parts):
                    _, fits[-1]["s"][j], fits[-1]["t"][j] = denormalize_pose(
                        fits[-1]["R"][j], fits[-1]["s"][j], fits[-1]["t"][j],
                        c, sc)
                    if g["R"][j] is not None:
                        _, g["s"][j], g["t"][j] = denormalize_pose(
                            g["R"][j], g["s"][j], g["t"][j], c, sc)
                    if gg is not None and gg["R"][j] is not None:
                        _, gg["s"][j], gg["t"][j] = denormalize_pose(
                            gg["R"][j], gg["s"][j], gg["t"][j], c, sc)
            gts.append(g)
            if naocs_mode:
                gp = pred["gocs_per_point"][i]
                nocs_pred_l.append(gp if gp.shape[-1] == 3 * cfg.n_max_parts
                                   else np.tile(gp, (1, cfg.n_max_parts)))
                nocs_gt_l.append(batch["nocs_gt_g"][i])
            else:
                nocs_pred_l.append(pred["nocs_per_point"][i])
                nocs_gt_l.append(batch["nocs_gt"][i])
            cls_l.append(cls)
            seg_miou.append(segmentation_iou(pred["W"][i], cls,
                                             cfg.n_max_parts))
            seg_miou_h.append(segmentation_iou(pred["W"][i], cls,
                                               cfg.n_max_parts,
                                               hungarian=True))
            # joint-parameter eval (eval_joint_params.py:105-256) whenever
            # the joint + gocs heads exist — HDF5 and synthetic alike
            if "gocs_per_point" in pred and "heatmap_per_point" in pred \
                    and "nocs_gt_g" in batch:
                base_fit = ({"R": fits[-1]["R"][0], "s": fits[-1]["s"][0],
                             "t": fits[-1]["t"][0]}
                            if np.all(np.isfinite(fits[-1]["R"][0])) else None)
                frame_pred = {k: np.asarray(v[i]) for k, v in pred.items()}
                p_lines = pred_joint_lines(
                    frame_pred, base_fit, cfg.n_max_parts,
                    thres_r=cfg.thres_r, naocs_fit=naocs_mode)
                if args.synthetic:
                    # exact renderer GT (better than voted-label GT)
                    gt_frame = test_it.frame_gts[fi]
                    g_lines = [
                        {"axis": gt_frame.joint_axes_cam[j - 1],
                         "point": gt_frame.joint_points_cam[j - 1]}
                        if j - 1 < len(gt_frame.joint_axes_cam) else None
                        for j in range(1, cfg.n_max_parts)]
                else:
                    frame_gtb = {k: np.asarray(v[i]) for k, v in batch.items()}
                    g_lines = gt_joint_lines(frame_gtb, batch["P"][i],
                                             cfg.n_max_parts,
                                             thres_r=cfg.thres_r)
                for pl, gl in zip(p_lines, g_lines):
                    if pl is not None and gl is not None:
                        joint_errs.append(joint_errors(pl, gl["axis"],
                                                       gl["point"]))
            fi += 1
    report = evaluate_fits(fits, gts, cfg.n_max_parts, nocs_pred=nocs_pred_l,
                           nocs_gt=nocs_gt_l, cls_list=cls_l,
                           gts_global=gts_global, P_list=P_l,
                           cls_pred_list=cls_pred_l, naocs_fit=naocs_mode)
    if seg_miou:
        report.overall["seg_miou"] = float(np.mean(seg_miou))
        report.overall["seg_miou_hungarian"] = float(np.mean(seg_miou_h))
    print(report.summary())
    if seg_miou:
        print(f"seg mIoU {report.overall['seg_miou']:.3f} "
              f"(hungarian-matched {report.overall['seg_miou_hungarian']:.3f})")
    if joint_errs:
        ax = float(np.mean([e["axis_err_deg"] for e in joint_errs]))
        ld = float(np.mean([e["line_dist"] for e in joint_errs]))
        print(f"joints: axis err {ax:.2f}°  line dist {ld:.4f} ({len(joint_errs)} joints)")
        report.overall["joint_axis_err_deg"] = ax
        report.overall["joint_line_dist"] = ld
    tag = "from_pred_" if args.from_pred else ""
    out_path = os.path.join(work, f"eval_{tag}{args.domain or 'all'}.json")
    os.makedirs(work, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"per_part": report.per_part, "overall": report.overall,
                   "per_joint": report.per_joint,
                   "n_frames": report.n_frames, "n_dropped": report.n_dropped},
                  f, indent=1)
    print("wrote", out_path)


def cmd_serve(args):
    """One-call production inference: clouds in, poses out (main.py:
    439-496).

    Drives serving.PosePredictor (the forward + pose fit) through
    serving.serve_clouds, which pads a short last batch with copies of
    its last cloud and trims the answers.  Input: --input .npy/.npz of
    (B, N, 3) clouds (npz key 'P'), or --synthetic frames.  Output: .npz
    with R/s/t, segmentation, part_counts.  --mesh 'data=8' serves data-
    parallel over the devices (parallel/mesh.py): every visible card, or
    with --device cpu that many copies of the CPU.
    """
    from articulated_pose_tpu_torch.serving import PosePredictor, serve_clouds

    cfg, spec = build_config(args)
    work = work_dir(args, cfg)
    # load + validate the input BEFORE the predictor is built
    if args.input:
        loaded = np.load(args.input)
        clouds = loaded["P"] if hasattr(loaded, "files") else loaded
    else:
        if not args.synthetic:
            sys.exit("serve needs --input or --synthetic")
        it = make_datasets(args, cfg, spec, "test")
        clouds = np.concatenate([np.asarray(b["P"]) for b in it])
    clouds = np.asarray(clouds, np.float32)
    if clouds.ndim != 3 or clouds.shape[-1] != 3:
        sys.exit(f"serve: expected (B, N, 3) clouds, got {clouds.shape}")
    if len(clouds) == 0:
        sys.exit("serve: input contains no clouds")
    mesh = None
    if args.mesh:
        from articulated_pose_tpu_torch.parallel.mesh import (make_mesh,
                                                              parse_spec)

        devices = None
        if torch.device(args.device).type == "cpu":
            devices = ["cpu"] * int(np.prod(parse_spec(args.mesh)[1]))
        mesh = make_mesh(args.mesh, devices=devices)
    pred = PosePredictor(cfg, work_dir=work, device=args.device, mesh=mesh)
    merged = serve_clouds(pred, clouds, cfg.batch_size)
    out_path = args.output or os.path.join(work, "poses.npz")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **merged)
    print(f"served {len(clouds)} clouds -> {out_path} "
          f"(R {merged['R'].shape}, mesh={args.mesh or 'single-device'})")


def cmd_joint_baseline(args):
    """Train/eval the direct joint-regression baseline
    (`--model joint_baseline`; reference lib/architecture.py:163-192)."""
    from articulated_pose_tpu_torch.train.joint_baseline import \
        run_joint_baseline

    cfg, spec = build_config(args)
    work = args.work_dir or os.path.join(cfg.experiment_dir, cfg.category,
                                         "joint_baseline")
    train_it = test_it = None
    if args.command in ("train", "demo"):
        train_it = make_datasets(args, cfg, spec, "train")
    if args.command in ("test", "pose", "eval", "demo"):
        test_it = make_datasets(args, cfg, spec, "test", domain=args.domain)
    out = run_joint_baseline(cfg, work, train_it=train_it, test_it=test_it,
                             max_steps=args.max_steps, n_epochs=args.epochs,
                             device=args.device)
    print("joint_baseline:", json.dumps(
        {k: round(float(v), 5) for k, v in out.items()}))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("command",
                    choices=["train", "test", "pose", "eval", "demo",
                             "serve"])
    ap.add_argument("--item", default="eyeglasses")
    ap.add_argument("--nocs_type", default="ancsh", choices=["ancsh", "npcs"])
    ap.add_argument("--domain", default=None, choices=[None, "seen", "unseen"])
    ap.add_argument("--config", default=None)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--work_dir", default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--num_points", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="use the procedural generator instead of HDF5 data")
    ap.add_argument("--synthetic_frames", type=int, default=64)
    ap.add_argument("--baseline_only", action="store_true")
    ap.add_argument("--full_test", action="store_true",
                    help="evaluate every frame instead of the reference's "
                         "subsampled grid (get_full_test vs get_test_group)")
    ap.add_argument("--nocs", default="NPCS", choices=["NPCS", "NAOCS"],
                    help="pose-fit source space (NAOCS = gocs head)")
    ap.add_argument("--backbone", default="reference",
                    choices=["reference", "tiny"],
                    help="backbone width preset: 'reference' mirrors the "
                         "paper widths (architectures.py:62-93); 'tiny' "
                         "keeps the topology at trimmed widths for CLI "
                         "smokes and CPU tests")
    ap.add_argument("--from_pred", default=None,
                    help="pose/eval: directory of per-frame prediction .h5 "
                         "files (written by the `test` command) to evaluate "
                         "offline instead of re-running the network — the "
                         "reference's decoupled protocol "
                         "(evaluation/pose_multi_process.py)")
    ap.add_argument("--baseline_pred", default=None,
                    help="pose/eval with --from_pred: directory of the "
                         "separately trained NPCS baseline's prediction h5; "
                         "its segmentation + part NOCS replace the ANCSH "
                         "ones while the joint heads stay (the reference's "
                         "USE_BASELINE pairing, "
                         "evaluation/parallel_ancsh_pose.py:225-247)")
    ap.add_argument("--input", default=None,
                    help="serve: .npy/.npz of (B, N, 3) clouds (npz key 'P')")
    ap.add_argument("--output", default=None,
                    help="serve: output .npz path (default <work>/poses.npz)")
    ap.add_argument("--mesh", default=None,
                    help="serve: data-parallel mesh spec, e.g. 'data=8' "
                         "(parallel/mesh.py::make_mesh; over every visible "
                         "card, or copies of the CPU with --device cpu)")
    ap.add_argument("--model", default="ancsh",
                    choices=["ancsh", "joint_baseline"],
                    help="joint_baseline = direct joint-parameter "
                         "regression (reference lib/architecture.py:163-192, "
                         "the global_info.py joint_baseline experiments)")
    ap.add_argument("--device", default="cuda",
                    help="torch device every command runs on (default cuda; "
                         "without a card it raises unless given 'cpu')")
    return ap.parse_args(argv)


def main(argv=None, draws: Optional[Callable] = None):
    """Run one command.  `draws(B) -> PoseDraws`, when given, supplies
    the pose fit's RANSAC draws of each batch of `pose`/`eval` (the
    tests hand in the JAX package's)."""
    args = parse_args(argv)

    if args.baseline_pred and not args.from_pred:
        sys.exit("--baseline_pred requires --from_pred (it pairs two saved "
                 "prediction directories)")
    if args.from_pred and args.command not in ("pose", "eval"):
        sys.exit("--from_pred only applies to the pose/eval commands")
    if args.model == "joint_baseline" and args.command == "serve":
        sys.exit("serve is only available for --model ancsh "
                 "(the joint baseline predicts joint parameters, "
                 "not poses)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} is not available; pass "
                           "--device cpu to run on the CPU")
    if args.model == "joint_baseline":
        if args.command == "demo":
            args.synthetic = True
            args.max_steps = args.max_steps or 30
        cmd_joint_baseline(args)
        return
    if args.command == "serve":
        cmd_serve(args)
    elif args.command == "train":
        cmd_train(args)
    elif args.command == "test":
        cmd_test(args)
    elif args.command in ("pose", "eval"):
        cmd_pose_eval(args, draws)
    elif args.command == "demo":
        args.synthetic = True
        args.max_steps = args.max_steps or 30
        cmd_train(args)


if __name__ == "__main__":
    main()
