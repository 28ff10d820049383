#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises, so the exit code
is non-zero):

0. Require a CUDA device; print the card (nvidia-smi name and power
   limit), the torch / CUDA / nvcc versions, whether scipy, h5py,
   matplotlib, yaml, pybullet and cv2 import on the host and whether the
   native library (labeling, ball renderer) builds.
1. Build the CUDA sources from csrc/ (the twelve kernels' four and the
   card-limits probe's), one nvcc each, all at once; print each
   kernel's registers, shared memory and spills (ptxas -v).
2. Hold each of the eleven kernels of the PointNet++ paths (`knn` is
   held by tests/test_torch_kernels_cuda.py) against its plain PyTorch
   version at
   the shapes its paths give it: the serving path's (B=16, N=2048), the
   large-cloud path's (B=4, N=32768), the N-level path's (B=8,
   N=8192 -> 1024 -> 256 -> 64 -> 16), the stage profiler's (B=64,
   N=2048 -> 512 -> 128), bench.py's and the bucket path's (B3, B3p, B8
   and K3 at B=64) and the kernel entries' (B5g at B=64; B7 at (4,
   2048 <- 16384) and (4, 2048 <- 3000); B9 at (64, 2048 <- 512)): exact
   indices, counts and grouped coordinates (the B5g and bucket tiers'
   queries include some moved out of the cloud); 3-NN distances within
   1e-6 relative (B7 equal, with a tie across two lanes' slices; B9's
   within one key quantum, with the entries that differ counted).  Each
   ball-query and 3-NN shape prints its launch plan (`bq_plan`,
   `nn_plan`); each first-S ball-query shape also the points a query
   examined, mean and max.
   B9 is also read against K3 as scripts/ab_threenn_packed.py reads the
   TPU kernels, with the bounds of tests/test_pallas_tpu.py.  Both FPS
   kernels also run at every cluster size on tie-heavy grid clouds and
   ragged ones (all outputs equal), and each FPS shape prints its plan
   (variant, cluster size C), µs per pick and step floor (the same
   launch on a cloud of one point per thread).  Device
   time of each, median of 20 CUDA-event-timed calls (`timing.
   cuda_time_ms`; of 5 for the plain versions, which are no yardstick
   and, for FPS, take tens of ms of host time a call); its bound from
   this run's inputs (`roofline.py`'s work functions); for the 3-NN
   kernels the time of torch.topk(torch.cdist(...), 3) as the nearest
   library call.
3. Pose oracle: 8 frames of a 3-part object with two revolute joints and
   perfect predictions; the pose fit on the card must recover every
   part's similarity (rotation < 3 deg, scale within 5 %, translation
   within 0.05).
4. Serve: PosePredictor at the reference width for eyeglasses (K=3),
   N=2048, seeded random weights, niter 128/64, through serve_clouds:
   (a) f32, three requests of 16 clouds (1 FPS, 2 exact ball query,
   2 3-NN launches per batch), the forward on the card against the same
   model on the CPU, and one forward with the bf16 trunk; (b) the
   packed bf16 configuration that bench.py times (ball_query_packed),
   three requests of 64 clouds (1 FPS, 2 packed ball query, 2 3-NN).
5. Large-cloud forward (scripts/run_large_cloud.py's tier): ANCSHModel
   with the bf16 trunk and ball_query_impl="stream", B=4, N=32768
   (1 FPS in its large-cloud variant, 2 index-only ball query, 2 3-NN
   per forward); the f32 forward on the card against the CPU at B=1.
6. Bucket path: bench.py's composition (forward + fit_frame_batch, niter
   128/64) at the reference widths with ball_query_impl="bucket", bf16
   trunk, three batches of 64 clouds (1 two-level FPS, 2 bucket ball
   query, 2 3-NN per batch); the f32 forward on the card against the CPU
   at B=2; the distance to the exact bf16 forward (printed, no bound:
   another neighbour subset); one "bucket_xla" forward.
7. N-level path: the four-level pyramid of PointNet++'s semantic
   segmentation network under the ANCSH heads, B=8, N=8192, bf16 and
   f32 (4 single-level FPS, 4 exact ball query, 4 3-NN per forward);
   the f32 forward on the card against the CPU at B=1.
8. Stage profiler: `profile_stages.run` at B=64, N=2048 over all 14
   stages, a few iterations each; every stage must show device time and
   at least as many device ops a call as it launched kernels, and B2
   (`fps1`, `fps2`) and B5 (`bq1`, `bq2`) must launch.
9. Kernel entries: B5g, B7 and B9 called once each at phase 2's shapes,
   as the JAX package's tests and A/B scripts call the TPU kernels; each
   output is held against the plain version's, by phase 2's rules.
10. Train (`main.py train`'s path, cfg/network_config.yml: eyeglasses,
   K=3, N=1024, reference widths, seeded weights, frames of the port's
   synthetic generator): (a) f32, B=16, BatchIterator -> device_prefetch
   -> Trainer.fit for 30 steps on one batch, every step's metrics finite
   with grads_finite true, total_loss below 0.8x the first (the rule of
   tests/test_train.py), 1 fps2, 2 ball_query_group and 2 three_nn
   launches a step; then PosePredictor(work_dir=...) serves one batch
   from the trainer's checkpoint; and device_prefetch's batches, over
   two shuffled epochs with its copy stream started late, equal the
   host batches bit for bit; (b) one step on the card against the
   same step on the CPU, B=2, dropout off: the kernels' outputs equal,
   the loss within rtol 1e-5, each gradient within 1e-3 of its leaf's
   largest entry (plus 1e-7 of the model's largest) with the CPU's ReLU
   masks and max-pool selections imposed on the card, and on the card's
   own routing at most 1e-4 of those choices differ from the CPU's and
   each gradient is within 0.1 of its leaf's largest entry; (c) 5 steps
   with the yml's bf16 trunk, finite; (d) train steps/s and clouds/s at
   B=16 and B=32 (f32, host clock around a synchronised window) and the
   device idle share (torch.profiler).
11. Synthetic e2e (`python -m articulated_pose_tpu_torch.e2e`'s path,
   the sweep's recipe: B=32, N=1024, f32, reference widths): (a)
   DeviceSynthetic on the card against the same generator on the CPU,
   one set of draws, for laptop, eyeglasses and drawer: every label
   equal, P and the GT poses within 1e-5; (b) 200 fused train steps of
   laptop with the batches generated on the card, 1 fps2, 2
   ball_query_group and 2 three_nn launches a step (checked after each
   step), the loss at step 200 below 0.8x its first value, steps/s and
   clouds/s on the host clock, device ms, ops and idle share
   (torch.profiler); (c) 32 held-out card frames through eval_step,
   fit_frame_batch (niter 1024/128) and evaluate_fits: a report with
   the JAX e2e report's keys (docs/e2e_laptop_report.json), every value
   finite; its 5deg5cm is printed, not held (200 steps).
12. The command line (`python -m articulated_pose_tpu_torch`), through
   `main.main(argv)` in this process, eyeglasses, f32, reference widths,
   B=16, N=1024, 64 synthetic frames: (a) `demo`, 30 steps, the final
   loss finite, 1 fps2, 2 ball_query_group and 2 three_nn launches a
   step, its steps/s; (b) `eval --synthetic` restores step 30, in NPCS,
   in NAOCS and with `use_gt_joint_association: true` from a `--config`
   file: each report has JAX's top-level keys and finite values, each
   run's launches (4 batches) and seconds; (c) `serve --input` (40
   clouds: a short last batch) and `serve --synthetic`, each equal to
   serve_clouds on a PosePredictor of the same checkpoint (within 1e-5;
   seg and part counts exact), clouds/s through the command; (d) `demo`
   then `eval --model joint_baseline` (2 fps and 2 ball_query_group
   launches a step and a forward, joint_baseline_eval.json written) and
   the joint-baseline train step's ms, steps/s, device ms, ops and idle
   share, and its device time by kernel (the six largest); (e) the four pose-fit knobs (use_gt_association, axis_agg
   "mean", batch_joints, hypo_estimator "lm") on phase 3's oracle frames
   within phase 3's bounds, batch_joints against the loop within 1e-5;
   (f) with h5py: export_hdf5 -> `train --data_root` (3 steps) -> `test`
   -> `eval --from_pred`; without it: `test --data_root` raises
   ImportError naming h5py.
13. The device mesh (`parallel/mesh.py`): (a) phase 4's f32 serve
   (reference widths, B=16, N=2048) through a data=1 mesh, equal to the
   unsharded predictor; (b) through data=2 on [cuda:0, cuda:0], and the
   packed bf16 serve at B=64 likewise: each shard equal to the
   unsharded predictor on its rows with its draws, launches 2x a batch's,
   clouds/s sharded and not; (c) `serve --mesh data=1` through
   main(argv) equal to plain `serve`, and `--mesh data=2` raising JAX's
   ValueError on a one-card host; (d) the sharded train step at the
   reference widths (cfg/network_config.yml: eyeglasses, the L2
   coordinate loss; f32, N=1024, B=16, dropout off), three steps, over
   gloo with every rank on cuda:0: world 2 (data=2) and world 4
   (data=2,model=2).  Each step is held against the single-process step
   on the card from the world's own state before it, with the world's
   routing imposed (its ReLU and max-pool choices and the signs of the
   heatmap's residuals, `train/routing.py`): the loss within rtol 1e-5,
   the grad norm rtol 1e-4, the batch statistics 1e-4 of their largest
   entry, each gradient 1e-4 of its leaf's largest
   (`parallel/launch.py::BOUNDS`); the choices the single process makes
   otherwise are counted.  Each rank's device, the card's compute mode
   (one that forbids a second context fails the phase), the ranks'
   launches and ms a step are printed;
   (e) R6: `fps` and `fps2` with more picks than points (N 1, 100, 511;
   512 and 512 -> 128) equal to their plain versions, and the joint
   baseline's train step at N=256 (its SA1 picks 512).
   Every kernel call of (b), (c), (d) and (e)'s paths is also made once,
   outside the counted runs, on the same inputs with each kernel held
   against its plain version (`held_to_plain`): the shards' shapes (B=8
   and B=32 at N=2048, B=8 at N=1024) and the joint baseline's at N=256
   are no other phase's.
14. Reference assets: (a) the reference graph's TF1 checkpoint at full
   width (`utils/ref_forward.synth_reference_checkpoint`, seed 1),
   written as a TF1 bundle (`utils/tf_bundle.write_bundle`) and as an
   npz, each loaded by `utils/tf_ckpt.load_reference_weights` into
   cfg/network_config.yml's model (f32) on the card: every variable
   mapped, none unmapped or mismatched, every state_dict entry
   overwritten (a NaN sentinel); on tests/test_ckpt_parity.py's cloud
   (seed 7, B=2, N=1024) every head within 2e-4 of the float64
   `reference_forward` on the host (1 fps2, 2 ball_query_group, 2
   three_nn launches); the card's FPS picks, ball-query neighbourhoods
   and 3-NN neighbours against the float64 oracle, each difference
   printed with its margin; PosePredictor serves 3 requests of 16 fresh
   clouds at N=1024 (clouds/s beside the card's name and power limit,
   StepTimer's summary), then one batch with every kernel call held
   against its plain version (`held_to_plain`); (b) a two-part
   Shape2Motion JSON and OBJ boxes -> URDF -> joint specs and norm info
   -> `sample_mesh_points` at 16 articulated poses -> a depth and label
   image each (a NumPy z-buffer, GL camera) -> `preprocess_frame`
   (canonical points within 1e-5 of their samples) -> `build_sample`
   -> served on the card as one batch; `get_pose` / `write_frame_h5`
   run, or raise ImportError naming PyYAML / h5py without them; (c)
   `ball_viewer.render_points` C++ equal to NumPy, `vis.plot3d_pts`
   writes a PNG (or raises naming matplotlib), `profiling.trace` of one
   served batch's eager forward + fit names each launch
   ("kernel:<entry>"; a replayed batch names none), and
   `device_memory_stats` gives the peak bytes.
15. The accuracy tools (`articulated_pose_tpu_torch.ab`), each through
   its own functions, each printing its table: (a) `ransac_strength`
   on 8 noisy-oracle frames (N=2048), the --r4 control and two arms,
   every score finite, the control's rotation below 5 deg; then 150
   fused synthetic steps of eyeglasses (seed 0, B=32, N=1024, f32; 1
   fps2, 2 ball_query_group and 2 three_nn launches a step), saved as a
   work dir, the first step's kernel calls held against their plain
   versions on a copy of the init (`held_to_plain`); (b) `packed_eval` in f32 and in bf16 on it, 32 frames at
   B=16: the exact arm launches fps2, ball_query_group and three_nn,
   the packed arm ball_query_group_packed in place of the exact query,
   per forward (the guard's and one a batch), every metric finite and
   the seg guard at 0.40; each arm's kernel calls also held against
   their plain versions on one batch (`held_to_plain`); (c)
   `bf16_grads` at B=4, N=1024, depth 4, every policy arm and both
   parameter controls (one forward each), backbone/sa1/mlp/conv0
   reported, every overall cosine finite, then the f32 arm, its
   controls and the bf16 arm once more with each kernel call held;
   (d) `pose_knobs_trained` on the control and refit=3, `--time-iters
   3` (ms a batch from CUDA events), one forward of 32 frames, then the
   forward and the control once more with each kernel call held.  Every
   kernel that a counted run of the phase launched is held at that
   run's shapes, or the phase fails.
16. The roofline and timing tools, each through its own functions at
   short counts: (a) `probe_card` (5 calls a reading; the FMA kernel of
   csrc/probe.cu within 1e-5 relative of float64); (b) `roofline` at
   B=64 (bench.py's program, the fit, FPS, the SA1 ball query, FP1's
   3-NN, the f32 train step at B=16, N=1024), its kernel counts equal to
   the launches, and one forward (B=2, N=2048) counting the same on the
   card and on the CPU, its launches on the card a path of their own,
   held at B=2; (c) `roofline_session` on phase 8's profile and
   (a)'s ceilings, every stage's floor at the published peaks at most
   its device ms; (d) `profile_train_stages` at B=32, N=1024, 2
   iterations, its five stages in the JAX script's order with their
   launches; (e) `ab.overlap` (2 iterations; the pipelined fits equal to
   the serial ones); (f) `ab.batch` at B=64 and 128; (g)
   `ab.batch_joints` (no kernel; the arms within 1e-5).  Each stage's
   kernel calls are held against their plain versions once more,
   outside the counted runs (`held_to_plain`, which also holds the
   calls that the tools make through the kernel modules).
17. The compiled programs (`compiled.py`, JAX's `jax.jit` on the card:
   captured once a shape as a CUDA graph, then replayed): (a)
   PosePredictor at bench.py's configuration (B=64, bf16 trunk, packed
   ball query, niter 128/64) and the f32 serve at B=16: the shape's
   first call (run, then captured), then three calls of fresh clouds,
   each a replay, every output torch.equal to the eager
   `serving.forward_fit` on the same clouds and draws, each replay
   counting its launches; (b) the f32 serve on a data=2 mesh of the one
   card, shard by shard; (c) five `make_train_step(jit=True)` steps
   (cfg/network_config.yml in f32, B=16, N=1024, dropout on) and (d)
   five fused synthetic steps (the e2e recipe: laptop, B=32), each step
   replayed and run eagerly twice from a common state: every loss, batch
   statistic, Adam count and step equal bit for bit, the grad norm
   within rtol 1e-5, each moment leaf within 1e-4 (mu) or 2e-4 (nu) of
   its largest entry (a pre-batch-norm bias, whose gradient is rounding,
   of its layer weight's), each parameter within 2.05 learning rates.
   The eager step does not repeat itself bit for bit on the card (the
   gathers' backward adds with atomics), so the second eager run is held
   to the same bounds and printed beside; (e) eager against replayed:
   ms a call and clouds/s (host clock), device ms, device ops and idle
   share (torch.profiler), the bytes a call allocates, each program's
   capture seconds, graph pool bytes and replays, each line with the
   card's name and power limit; every reading also goes to
   chiprun_out/compiled_programs.json.
   Phases 4-16 run their PosePredictor, Trainer.fit and fused steps
   through the same programs: each path's first call at a shape runs
   the body, later ones replay.  A kernel call held against its plain
   version (`held_to_plain`) is an eager one: a shape's first call, or
   the eager body.

    python3 chip_smoke.py --soak WORLDS STEPS

builds the kernels and runs only phase 13(d), WORLDS worlds of each
mesh of STEPS steps each, every step held as above; it prints each
world and, for a step where the heatmap's signs differed, the same step
held without them imposed.

    python3 chip_smoke.py --compiled

builds the kernels and runs only phase 17.

Each phase logs its host-clock seconds ("[time]").  Each path of
phases 4-17 runs with the launch counts set to 0 just before it and read
just after, and fails unless each of its kernels launched.  The last lines are the card's name and power limit as
nvidia-smi prints them, a JSON object describing each kernel, then
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
18. Point Transformer (`models/point_transformer.py`): a flat YAML with
   `backbone: point_transformer` and the bf16 trunk read by
   `load_config`, a seeded model at the published widths saved as a
   trainer checkpoint, then `serve --synthetic` through main(argv) at
   B=16, N=8192: 9 knn, 4 fps and 4 three_nn launches a batch, every
   pose finite, the predictor's stage marks read on its last replay
   (k-NN, attention and the rest summed); then the `knn` kernel at the
   cell's nine searches (B=16) held equal to its plain version, with its
   ms, the plain version's, torch.topk(torch.cdist(...), k)'s and its
   bound (`python3 chip_smoke.py --ptv1` runs this phase alone after the
   build).
19. The `joint_fit` kernel (the pose fit's joint stage, one launch a
   fit) at the served fits (B=64, N=2048; B=16, N=8192; B=256): held
   equal to its plain version (`pipeline.joint_fit_plain`), with its ms,
   the plain version's and its bound.  Every path that fits launches it
   once a fit, and `held_to_plain` holds it as it holds the others
   (`python3 chip_smoke.py --joint-fit` runs this phase alone after the
   build).  Then the product orders the kernel takes from
   `ops/kernels/joint_fit.py`'s tables, re-read on this card: at every
   batch count up to 64, on a grid up to 131,072, around each step of
   the tables and at the fits' counts (B and B x H), the dot3 orders that
   give torch's products of the plain path bit for bit (`dot3_orders`),
   each change between two counts bisected to its count, printed as
   the steps and the table they give; it fails where a table's order is
   not among them at a count read, and prints the toolkit beside the one
   the tables were read on
   (`python3 chip_smoke.py --joint-orders` runs this alone after the
   build).
20. The `vector_attention` kernel (the Point Transformer's attention
   layer after its q, k, v Linears, one launch a layer) at the cell's
   five levels (B=16, bf16, eval mode, seeded weights and batch-norm
   state): held to the plain layer (`PointTransformerLayer.plain`) as
   `vector_attention_held` says, then its ms beside the plain layer's
   and its bound, the largest of gamma's two products at 989 TFLOP/s,
   theta's Linear(3, C) and the weighted sum at 67 TFLOP/s and p, q,
   k, v, the neighbours and y at 3.35 TB/s, each printed
   (`python3 chip_smoke.py --vector-attention` runs this phase alone
   after the build; phase 18 counts 18 launches a served batch).
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
B_KERNEL = 16
N_POINTS = 2048
SERVE_BATCH = 16
SERVE_REQUESTS = 3
PACKED_BATCH = 64                   # bench.py's serving batch
ORACLE_FRAMES = 8
LARGE_B = 4                         # scripts/run_large_cloud.py's shape
LARGE_N = 32768
LARGE_FORWARDS = 3
BUCKET_BATCH = 64                   # bench.py's batch
BUCKET_BATCHES = 3
# charlesq34/pointnet2 models/pointnet2_sem_seg.py: four SA levels on
# ScanNet clouds of 8192 points, its four FP stages, and the global SA
# stage the backbone always adds (with its FP stage first)
NLEVEL_SPEC = dict(
    sa_npoints=(1024, 256, 64, 16), sa_radii=(0.1, 0.2, 0.4, 0.8),
    sa_nsamples=(32, 32, 32, 32),
    sa_mlps=((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512)),
    global_mlp=(256, 512, 1024),
    fp_mlps=((256, 256), (256, 256), (256, 256), (256, 128), (128, 128, 128)))
NLEVEL_B = 8
NLEVEL_N = 8192
NLEVEL_FORWARDS = 3
PROFILE_B = 64                      # scripts/profile_stages.py's defaults
PROFILE_ITERS = 3
PLAIN_REPS = 5
STREAM_SHAPES = ((4, 2048, 16384), (4, 2048, 3000))   # B7: B, N, M
# main.py train's path: cfg/network_config.yml (eyeglasses, K=3, B=16,
# N=1024); tests/test_train.py's rule of a loss below 0.8x in 30 steps
TRAIN_B = 16
TRAIN_N = 1024
TRAIN_STEPS = 30
TRAIN_BF16_STEPS = 5
TRAIN_RATE_B = (16, 32)
# phase 11: the e2e recipe (B=32, N=1024) and three categories of the sweep
# (category, generator seed), laptop first
E2E_CATEGORIES = (("laptop", 2), ("eyeglasses", 1), ("drawer", 3))
E2E_STEPS = 200
E2E_TEST_FRAMES = 32
E2E_FRAME_TOL = 1e-5
# phase 12: the command line at cfg/network_config.yml's shape (eyeglasses,
# B=16, N=1024), main.py demo's 30 steps and its 64 synthetic frames; a
# serve input of two full batches and a short one
CLI_B = 16
CLI_N = 1024
CLI_STEPS = 30
CLI_FRAMES = 64
CLI_SERVE_CLOUDS = 40
CLI_REPORT_KEYS = {"per_part", "overall", "per_joint", "n_frames",
                   "n_dropped"}
JB_RATE_STEPS = 20
# phase 13: the sharded train step's worlds and steps, and the joint
# baseline below its SA1's 512 picks
MESH_WORLDS = ("data=2", "data=2,model=2")
MESH_TRAIN_STEPS = 3
R6_N = (1, 100, 511)
R6_JB_N = 256
R6_JB_STEPS = 3
# phase 10(b), the card's step on its own routing against the CPU's: the
# share of ReLU and max-pool choices allowed to differ, and the gradient
# bound a leaf, relative to its scale (the largest measured is 3.4e-2)
TRAIN_FLIP_LIMIT = 1e-4
TRAIN_OWN_ROUTING_BOUND = 0.1
# phase 10(a)'s device_prefetch check: spin-kernel cycles the copy stream
# starts behind (~35 ms at H100 clocks) and the consuming stream waits
# between its two reads of a batch (~1 ms)
PREFETCH_COPY_SPIN = 1 << 26
PREFETCH_READ_SPIN = 1 << 21


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_lines(log_text: str) -> list:
    """One line per kernel of an `nvcc -Xptxas -v` log: the kernel's
    entry name (mangled, its template arguments after "I"), then its
    registers, shared memory and spills, all as ptxas printed them."""
    import re

    lines = []
    for ln in log_text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            lines.append(entry.group(1))
        elif lines and ("registers" in ln or "spill" in ln):
            lines[-1] += "; " + ln.split(":", 1)[-1].strip()
    return lines


def bq_note(pairs: int, most: int, queries: int, plan) -> str:
    """The points a first-S query examined (mean, max) and the plan."""
    return (f"{pairs / queries:.1f} points examined per query, at most "
            f"{most}; plan {plan.variant} "
            f"{'staged' if plan.staged else 'streamed'}")


# ---------------------------------------------------------------- phase 2
def time_both(kernel_fn, plain_fn, library_fn=None):
    """Times of a kernel, of its plain version and, where given, of the
    library call on the same inputs: (ms, plain_ms, ms device only?,
    plain_ms device only?, note, library_ms or None)."""
    from articulated_pose_tpu_torch.timing import cuda_time_ms, timing_note

    ms, k_dev = cuda_time_ms(kernel_fn)
    plain_ms, p_dev = cuda_time_ms(plain_fn, reps=PLAIN_REPS)
    note = (f"kernel {ms:.4f} ms{timing_note(k_dev)}, plain {plain_ms:.4f} "
            f"ms{timing_note(p_dev)}")
    library_ms = None
    if library_fn is not None:
        library_ms, l_dev = cuda_time_ms(library_fn)
        note += f", library {library_ms:.4f} ms{timing_note(l_dev)}"
    return ms, plain_ms, k_dev, p_dev, note, library_ms


def kernel_result(err, times, shapes, bounds):
    """The JSON entry of one kernel: times and bounds summed over its
    shapes; `bounds` holds each shape's (operations ms, bytes ms), and
    `bound_by` names the larger of the two sums."""
    t_ops = sum(b[0] for b in bounds)
    t_bytes = sum(b[1] for b in bounds)
    ms = sum(t[0] for t in times)
    libs = [t[5] for t in times]
    return dict(max_abs_err=err, ms=ms,
                plain_ms=sum(t[1] for t in times),
                bound_ms=sum(max(b) for b in bounds),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None if None in libs else sum(libs),
                ms_device_only=all(t[2] for t in times),
                plain_ms_device_only=all(t[3] for t in times), shapes=shapes)


def bound_note(b) -> str:
    return (f"bound {max(b):.4f} ms "
            f"({'operations' if b[0] >= b[1] else 'bytes'})")


def check_equal(name: str, got, want) -> float:
    """Raise unless every tensor of got equals want's; max abs error."""
    import torch

    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 "version")
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def fps_reading(kernel_fn, plain_fn, B, picks, work, plan):
    """Times, bound and step floor of one FPS launch: (times, bounds,
    shape label, log text, µs per pick, floor µs per pick)."""
    from articulated_pose_tpu_torch.ops.kernels.fps import step_floor
    from articulated_pose_tpu_torch.roofline import bound

    t = time_both(kernel_fn, plain_fn)
    b = bound(work)
    floor = step_floor(B, *plan)
    us = t[0] * 1e3 / picks
    text = (f"{plan[0]} C={plan[1]}, {us:.4f} us a pick, step floor "
            f"{floor:.4f} us a pick; {t[4]}; {bound_note(b)}")
    return t, b, text, us, floor


def fps_result(err, readings):
    """The JSON entry of an FPS kernel: kernel_result's keys, plus each
    shape's plan, µs per pick and step floor."""
    times, bounds, shapes, plans, us, floors = zip(*readings)
    return dict(kernel_result(err, list(times), list(shapes), list(bounds)),
                plans=[f"{v} C={c}" for v, c in plans], us_per_pick=list(us),
                floor_us_per_pick=list(floors))


def compare_fps(clouds):
    """K1 at each (label, cloud): N -> 512 -> 128, as PointNet2Backbone
    calls it.  Returns the JSON entry and each cloud's (xyz1, xyz2)."""
    from articulated_pose_tpu_torch.ops.kernels import fps
    from articulated_pose_tpu_torch.roofline import fps2_work

    err, readings, picks = 0.0, [], {}
    for label, cloud in clouds:
        B, N, _ = cloud.shape
        got = fps.fps2(cloud, 512, 128)
        err = max(err, check_equal("fps2", got,
                                   fps.fps2_plain(cloud, 512, 128)))
        plan = fps.fps_plan(B, N, 512)
        t, b, text, us, floor = fps_reading(
            lambda: fps.fps2(cloud, 512, 128),
            lambda: fps.fps2_plain(cloud, 512, 128), B, 512 + 128,
            fps2_work(B, N, 512, 128), plan)
        shape = f"B{B} N{N}->512->128"
        log(f"[kernels] fps2 {shape}: indices and coordinates equal; {text}")
        readings.append((t, b, shape, plan, us, floor))
        picks[label] = (got[1], got[3])
    return fps_result(err, readings), picks


def compare_fps_single(cases):
    """B2 at each (cloud, npoint) of its paths.  Returns the JSON entry."""
    from articulated_pose_tpu_torch.ops.kernels import fps
    from articulated_pose_tpu_torch.roofline import fps_work

    err, readings = 0.0, []
    for cloud, npoint in cases:
        B, N, _ = cloud.shape
        got = fps.fps(cloud, npoint)
        err = max(err, check_equal("fps", got, fps.fps_plain(cloud, npoint)))
        plan = fps.fps_plan(B, N, npoint)
        t, b, text, us, floor = fps_reading(
            lambda: fps.fps(cloud, npoint),
            lambda: fps.fps_plain(cloud, npoint), B, npoint,
            fps_work(B, N, npoint), plan)
        shape = f"B{B} N{N}->{npoint}"
        log(f"[kernels] fps {shape}: indices and coordinates equal; {text}")
        readings.append((t, b, shape, plan, us, floor))
    return fps_result(err, readings)


def grid_cloud(rng, B: int, N: int, side: int, dev):
    """Points on a coarse integer grid scaled by 1/8: exact duplicates and
    exactly equal distances, every product and sum exact."""
    import torch

    return torch.from_numpy((rng.randint(0, side, (B, N, 3)) * 0.125)
                            .astype(np.float32)).to(dev)


def fps_ties_and_slices(dev):
    """Both FPS kernels forced through every cluster size on tie-heavy grid
    clouds (equal distances in different warps and CTAs) and a ragged one
    (N = 3001, no multiple of C x threads; fewer points than C x threads
    at N = 100), each in the smallest register variant that holds it (where
    one does) and in the streamed one: every output equal to the plain
    version's."""
    from articulated_pose_tpu_torch.ops.kernels import fps

    rng = np.random.RandomState(11)
    clouds = {"grid side 4": grid_cloud(rng, 4, 4096, 4, dev),
              "grid side 16": grid_cloud(rng, 4, 4096, 16, dev),
              "ragged N=3001": torch_cloud(rng, 3, 3001, dev),
              "ragged N=100": torch_cloud(rng, 3, 100, dev)}
    by_capacity = sorted((v for v in fps.VARIANTS if fps.capacity(v)),
                         key=fps.capacity)
    launches = 0
    for label, cloud in clouds.items():
        N = cloud.shape[1]
        np1, np2, single = min(N, 512), min(N, 128), min(N, 300)
        want2 = fps.fps2_plain(cloud, np1, np2)
        want1 = fps.fps_plain(cloud, single)
        for cluster in fps.CLUSTERS:
            small = next((v for v in by_capacity if fps.fits(v, N, cluster)),
                         "stream")
            for variant in dict.fromkeys((small, "stream")):
                check_equal(f"fps2 {label} {variant} C={cluster}",
                            fps.launch(fps.KERNEL, cloud, np1, np2, variant,
                                       cluster), want2)
                check_equal(f"fps {label} {variant} C={cluster}",
                            fps.launch(fps.SINGLE_KERNEL, cloud, single, 0,
                                       variant, cluster)[:2], want1)
                launches += 2
    log(f"[kernels] fps2 and fps on {', '.join(clouds)} at C in "
        f"{fps.CLUSTERS}, smallest register variant and streamed: "
        f"{launches} launches, every output equal to the plain version's")


def torch_cloud(rng, B: int, N: int, dev):
    import torch

    return torch.from_numpy(rng.rand(B, N, 3).astype(np.float32)).to(dev)


def compare_grouping(name, kernel_fn, plain_fn, cases, coord_bound,
                     whole_cloud=False):
    """A grouped ball query at each (points, queries, radius, emit_idx)
    or (points, queries, radius, emit_idx, nsample) of its path, S=64
    where the case names none: cnt and idx equal, coordinates within
    coord_bound.  The emit_idx=False launch must give the same
    coordinates and counts.  The bound counts the points each query has
    to examine: up to its 64th hit, or the whole cloud (`whole_cloud`,
    the bucket tier), by `roofline.ball_query_work`.  Each shape also
    prints its launch plan and, for the first-S tiers, the points
    examined per query, mean and max."""
    from articulated_pose_tpu_torch.ops.kernels.ball_query import bq_plan
    from articulated_pose_tpu_torch.roofline import (ball_query_work, bound,
                                                     scanned_points)

    err, times, shapes, bounds = 0.0, [], [], []
    for pts, q, r, emit, *nsample in cases:
        S = nsample[0] if nsample else 64
        g, cnt, idx = kernel_fn(r, S, pts, q, emit_idx=True)
        gp, cntp, idxp = plain_fn(r, S, pts, q)
        g2, cnt2, _ = kernel_fn(r, S, pts, q, emit_idx=False)
        check_equal(f"{name} r={r} cnt/idx", (cnt, idx, cnt2),
                    (cntp, idxp, cntp))
        e = max((g - gp).abs().max().item(), (g2 - gp).abs().max().item())
        if e > coord_bound:
            raise AssertionError(f"{name} r={r}: grouped xyz off by {e}")
        err = max(err, e)
        t = time_both(lambda: kernel_fn(r, S, pts, q, emit_idx=emit),
                      lambda: plain_fn(r, S, pts, q, emit_idx=emit))
        B, N = pts.shape[:2]
        M = q.shape[1]
        if whole_cloud:
            plan = bq_plan(B, N, M, S, bucket=True)
            pairs = B * M * N
            scan = (f"{N} points examined per query; plan {plan.variant} "
                    f"{'staged' if plan.staged else 'streamed'}")
        else:
            pairs, most = scanned_points(idxp, cntp, N)
            scan = bq_note(pairs, most, B * M, bq_plan(B, N, M, S))
        bounds.append(bound(ball_query_work(name, B, N, M, S, emit, pairs)))
        shape = f"B{B} N{N} M{M} S{S} r{r} emit_idx={emit}"
        log(f"[kernels] {name} {shape}: cnt, idx equal, grouped max abs "
            f"err {e:.3g}; {t[4]}; {bound_note(bounds[-1])} (mean cnt "
            f"{cnt.float().mean().item():.2f}, {scan})")
        times.append(t)
        shapes.append(shape)
    return kernel_result(err, times, shapes, bounds)


def compare_idx(name, kernel_fn, plain_fn, cases):
    """An idx-only first-S ball query at each (points, queries, radius),
    S=64: idx and cnt equal."""
    from articulated_pose_tpu_torch.ops.kernels.ball_query import bq_plan
    from articulated_pose_tpu_torch.roofline import (ball_query_work, bound,
                                                     scanned_points)

    err, times, shapes, bounds = 0.0, [], [], []
    for pts, q, r in cases:
        idx, cnt = kernel_fn(r, 64, pts, q)
        idxp, cntp = plain_fn(r, 64, pts, q)
        check_equal(f"{name} r={r}", (idx, cnt), (idxp, cntp))
        t = time_both(lambda: kernel_fn(r, 64, pts, q),
                      lambda: plain_fn(r, 64, pts, q))
        B, N = pts.shape[:2]
        M = q.shape[1]
        pairs, most = scanned_points(idxp, cntp, N)
        bounds.append(bound(ball_query_work(name, B, N, M, 64, True, pairs)))
        shape = f"B{B} N{N} M{M} S64 r{r}"
        log(f"[kernels] {name} {shape}: idx, cnt equal; {t[4]}; "
            f"{bound_note(bounds[-1])} (mean cnt "
            f"{cnt.float().mean().item():.2f}, "
            f"{bq_note(pairs, most, B * M, bq_plan(B, N, M, 64))})")
        times.append(t)
        shapes.append(shape)
    return kernel_result(err, times, shapes, bounds)


def nn_library(a, b):
    """The nearest PyTorch call to a 3-NN search: two calls (cdist, then
    topk), and plain distances rather than squared ones."""
    import torch

    return torch.topk(torch.cdist(a, b), 3, dim=-1, largest=False)


def nn_bound(a, b):
    from articulated_pose_tpu_torch.roofline import bound, three_nn_work

    return bound(three_nn_work(a.shape[0], a.shape[1], b.shape[1]))


def nn_note(a, b, packed=False) -> str:
    from articulated_pose_tpu_torch.ops.kernels.three_nn import nn_plan

    plan = nn_plan(a.shape[0], a.shape[1], b.shape[1], packed)
    return (f"plan {plan.variant} "
            f"{'staged' if plan.staged else 'streamed'}")


def compare_nn(name, kernel_fn, plain_fn, cases, rel_bound):
    """An exact 3-NN kernel at each (xyz1, xyz2): idx equal, distances
    within rel_bound relative (0: equal); each shape prints its plan."""
    err, times, shapes, bounds = 0.0, [], [], []
    for a, b in cases:
        d, i = kernel_fn(a, b)
        dp, ip = plain_fn(a, b)
        check_equal(f"{name} indices", (i,), (ip,))
        rel = ((d - dp).abs() / dp.abs().clamp_min(1e-30)).max().item()
        if rel > rel_bound:
            raise AssertionError(f"{name} distances off by {rel} relative")
        err = max(err, (d - dp).abs().max().item())
        t = time_both(lambda: kernel_fn(a, b), lambda: plain_fn(a, b),
                      lambda: nn_library(a, b))
        bounds.append(nn_bound(a, b))
        shape = f"B{a.shape[0]} N{a.shape[1]} M{b.shape[1]}"
        log(f"[kernels] {name} {shape}: idx equal, dist max rel err "
            f"{rel:.3g}; {t[4]}; {bound_note(bounds[-1])}; {nn_note(a, b)}")
        times.append(t)
        shapes.append(shape)
    return kernel_result(err, times, shapes, bounds)


def key_quanta_off(name, d, dp) -> int:
    """B9's distances against the plain version's: equal, or one key
    quantum (bit 16 of the f32) off; returns how many entries are."""
    import torch

    bits = (d.view(torch.int32) - dp.view(torch.int32)).abs()
    if not ((bits == 0) | (bits == 1 << 16)).all():
        raise AssertionError(f"{name}: a distance is more than one key "
                             "quantum off the plain version's")
    return int((bits != 0).sum())


def compare_nn_packed(a, b):
    """B9 at (xyz1, xyz2): idx equal to the plain version's, dist equal
    or one key quantum off (the entries that are, counted); then read
    against K3 as scripts/ab_threenn_packed.py reads the TPU kernels,
    with the bounds of tests/test_pallas_tpu.py:236-242."""
    from articulated_pose_tpu_torch.ops.kernels import three_nn

    d, i = three_nn.three_nn_packed(a, b)
    dp, ip = three_nn.three_nn_packed_plain(a, b)
    check_equal("three_nn_packed indices", (i,), (ip,))
    n_off = key_quanta_off("three_nn_packed", d, dp)
    err = (d - dp).abs().max().item()
    t = time_both(lambda: three_nn.three_nn_packed(a, b),
                  lambda: three_nn.three_nn_packed_plain(a, b),
                  lambda: nn_library(a, b))
    bounds = [nn_bound(a, b)]
    shape = f"B{a.shape[0]} N{a.shape[1]} M{b.shape[1]}"
    log(f"[kernels] three_nn_packed {shape}: idx equal, dist equal but for "
        f"{n_off} of {d.numel()} entries one key quantum off; {t[4]}; "
        f"{bound_note(bounds[0])}; {nn_note(a, b, packed=True)}")

    de, ie = three_nn.three_nn(a, b)
    agree = (i == ie).double().mean().item()
    rel = ((d - de).abs() / de.clamp_min(1e-9)).max().item()
    q, p = a.double(), b.double()
    chosen = p.gather(1, i.long().reshape(i.shape[0], -1, 1).expand(
        -1, -1, 3)).reshape(*i.shape, 3)
    d_true = ((q.unsqueeze(2) - chosen) ** 2).sum(-1)
    d64, de64 = d.double(), de.double()
    ok = ((d64 <= d_true * (1 + 1e-5) + 4e-6).all()
          and (d64 >= d_true * (1 - 2 ** -7) - 4e-6).all()
          and (d_true <= de64 + de64 * (4 * 2 ** -7) + 1e-5).all())
    log(f"[kernels] three_nn_packed vs three_nn (ab_threenn_packed.py's "
        f"reading): idx agreement {agree:.6f}, max reldiff dist {rel:.3e}; "
        f"within tests/test_pallas_tpu.py's truncation bounds: {bool(ok)}")
    if not ok:
        raise AssertionError("three_nn_packed leaves the key-truncation band "
                             "of the exact 3-NN")
    return kernel_result(err, [t], [shape], bounds), (dp, ip)


def compare_kernels(dev):
    """Phase 2.  Returns each kernel's JSON entry, and the kernel entries
    of phase 9: (name, call, the plain version's outputs)."""
    import torch

    from articulated_pose_tpu_torch.ops.kernels import (ball_query, fps,
                                                        three_nn)

    rng = np.random.RandomState(0)
    cloud = torch.from_numpy(
        rng.rand(B_KERNEL, N_POINTS, 3).astype(np.float32)).to(dev)
    large = torch.from_numpy(
        rng.rand(LARGE_B, LARGE_N, 3).astype(np.float32)).to(dev)
    results = {}

    # K1: the serving cloud and the large cloud (its large-N variant)
    results["fps2"], picks = compare_fps((("serve", cloud),
                                          ("large", large)))
    xyz1, xyz2 = picks["serve"]
    lxyz1, lxyz2 = picks["large"]

    # the stage profiler's inputs: profile_stages draws them from seed 0
    # in this order (P, Q1, Q2), which are also ab_threenn_packed.py's Q, P
    prng = np.random.RandomState(0)
    P64, Q1, Q2 = (torch.from_numpy(prng.rand(PROFILE_B, n, 3).astype(
        np.float32)).to(dev) for n in (N_POINTS, 512, 128))

    # K2 and B3p: SA1 (idx not emitted on the path) and SA2, at the
    # serving batch and at bench.py's (B=64, the packed serve's batch);
    # every output equal (both tiers compute the plain versions' f32
    # subtraction, the packed one after the same quantiser)
    _, bxyz1, _, bxyz2 = fps.fps2(P64, 512, 128)
    serve_cases = ((cloud, xyz1, 0.2, False), (xyz1, xyz2, 0.4, True),
                   (P64, bxyz1, 0.2, False), (bxyz1, bxyz2, 0.4, True))
    # the joint baseline's SA1 (N -> 512, r 0.2, S 32, idx not emitted)
    # and SA2 (512 -> 128, r 0.4, S 64) at phase 12's batch, on B2's
    # picks (models/joint_regression.py SA_STAGES)
    jcloud = torch.from_numpy(np.random.RandomState(12).rand(
        CLI_B, CLI_N, 3).astype(np.float32)).to(dev)
    jxyz1 = fps.fps(jcloud, 512)[1]
    jxyz2 = fps.fps(jxyz1, 128)[1]
    results["ball_query_group"] = compare_grouping(
        "ball_query_group", ball_query.ball_query_group,
        ball_query.ball_query_group_plain,
        serve_cases + ((jcloud, jxyz1, 0.2, False, 32),
                       (jxyz1, jxyz2, 0.4, True, 64)), 0.0)
    results["ball_query_group_packed"] = compare_grouping(
        "ball_query_group_packed", ball_query.ball_query_group_packed,
        ball_query.ball_query_group_packed_plain, serve_cases, 0.0)

    # B2: the serving cloud's first level, the N-level path's chain
    # 8192 -> 1024 -> 256 -> 64 -> 16, each level on the last one's
    # picks, the stage profiler's fps1 / fps2 (below) and the joint
    # baseline's SA1 / SA2
    nlevel = torch.from_numpy(
        rng.rand(NLEVEL_B, NLEVEL_N, 3).astype(np.float32)).to(dev)
    chain, levels = [], [nlevel]
    for npoint in NLEVEL_SPEC["sa_npoints"]:
        chain.append((levels[-1], npoint))
        levels.append(fps.fps(levels[-1], npoint)[1])
    results["fps"] = compare_fps_single([(cloud, 512)] + chain
                                        + [(P64, 512), (Q1, 128),
                                           (jcloud, 512), (jxyz1, 128)])
    fps_ties_and_slices(dev)

    # B8 at SA1 and SA2 of the serving batch and of the bucket path's
    # (B=64), a few queries moved out of the cloud so that the zero-hit
    # fallback runs; every output equal
    def far(q):
        q = q.clone()
        q[:, :4] += 10.0
        return q

    b_cases = ((cloud, far(xyz1), 0.2), (xyz1, far(xyz2), 0.4),
               (P64, far(bxyz1), 0.2), (bxyz1, far(bxyz2), 0.4))
    results["ball_query_group_bucket"] = compare_grouping(
        "ball_query_group_bucket", ball_query.ball_query_group_bucket,
        ball_query.ball_query_group_bucket_plain,
        [(p, q, r, r > 0.3) for p, q, r in b_cases], 0.0, whole_cloud=True)
    for pts, q, r in b_cases:
        _, cnt, _ = ball_query.ball_query_group_bucket(r, 64, pts, q, False)
        if not ((cnt[:, :4] == 0).all() and (cnt[:, 4:] > 0).all()):
            raise AssertionError("ball_query_group_bucket: the moved "
                                 "queries must be the only ones with no hit")

    # B6: the large-cloud path's SA1 (32768 -> 512) and SA2 (512 -> 128)
    results["ball_query_idx"] = compare_idx(
        "ball_query_idx", ball_query.ball_query_idx,
        ball_query.ball_query_idx_plain,
        ((large, lxyz1, 0.2), (lxyz1, lxyz2, 0.4)))

    # B5: the stage profiler's bq1 (2048 -> 512, r 0.2) and bq2
    results["ball_query_point"] = compare_idx(
        "ball_query_point", ball_query.ball_query_point,
        ball_query.ball_query_point_plain, ((P64, Q1, 0.2), (Q1, Q2, 0.4)))

    # B5g at the same shapes (tests/test_pallas_tpu.py:89-90), four
    # queries per cloud moved out of it: every output equal
    def grouped_first(fn):
        def call(r, S, pts, q, emit_idx=True):
            idx, cnt, g = fn(r, S, pts, q)
            return g, cnt, idx
        return call

    gfar1, gfar2 = Q1.clone(), Q2.clone()
    gfar1[:, :4] += 10.0
    gfar2[:, :4] += 10.0
    g_cases = ((P64, gfar1, 0.2), (Q1, gfar2, 0.4))
    results["ball_query_point_grouped"] = compare_grouping(
        "ball_query_point_grouped",
        grouped_first(ball_query.ball_query_point_grouped),
        grouped_first(ball_query.ball_query_point_grouped_plain),
        [(p, q, r, True) for p, q, r in g_cases], 0.0)
    entries = []
    for pts, q, r in g_cases:
        out = ball_query.ball_query_point_grouped(r, 64, pts, q)
        if not (out[1][:, :4] == 0).all():
            raise AssertionError("ball_query_point_grouped: a moved query "
                                 "has a hit")
        entries.append(("ball_query_point_grouped",
                        lambda r=r, pts=pts, q=q: ball_query.
                        ball_query_point_grouped(r, 64, pts, q),
                        ball_query.ball_query_point_grouped_plain(
                            r, 64, pts, q)))

    # K3: FP2 and FP3 of the serving, bench (B=64) and large-cloud
    # paths, and the four FP stages of the N-level path
    results["three_nn"] = compare_nn(
        "three_nn", three_nn.three_nn, three_nn.three_nn_plain,
        ((xyz1, xyz2), (cloud, xyz1), (bxyz1, bxyz2), (P64, bxyz1),
         (lxyz1, lxyz2), (large, lxyz1))
        + tuple(zip(levels[-2::-1], levels[:0:-1])), 1e-6)

    # B7 at test_pallas_tpu.py:248's shape and at an M that is no
    # multiple of the kernel's 2048-candidate tile, with an exact tie
    # for query 0 across two lanes' slices (candidate 10 and its copy at
    # 600)
    srng = np.random.RandomState(9)
    s_cases = []
    for B, N, M in STREAM_SHAPES:
        a = torch.from_numpy(srng.rand(B, N, 3).astype(np.float32)).to(dev)
        b = torch.from_numpy(srng.rand(B, M, 3).astype(np.float32)).to(dev)
        b[:, 600] = b[:, 10]
        a[:, 0] = b[:, 10]
        s_cases.append((a, b))
    results["three_nn_stream"] = compare_nn(
        "three_nn_stream", three_nn.three_nn_stream,
        three_nn.three_nn_stream_plain, s_cases, 0.0)
    for a, b in s_cases:
        out = three_nn.three_nn_stream(a, b)
        if not ((out[1][:, 0, 0] == 10).all()
                and (out[1][:, 0, 1] == 600).all()):
            raise AssertionError("three_nn_stream: the cross-tile tie must "
                                 "go to the lower index")
        entries.append(("three_nn_stream",
                        lambda a=a, b=b: three_nn.three_nn_stream(a, b),
                        three_nn.three_nn_stream_plain(a, b)))

    # B9 at ab_threenn_packed.py's shape and inputs
    results["three_nn_packed"], plain = compare_nn_packed(P64, Q1)
    entries.append(("three_nn_packed",
                    lambda: three_nn.three_nn_packed(P64, Q1), plain))
    return results, entries


# ---------------------------------------------------------------- phase 3
def random_rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.randn(3, 3))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def articulated_frames(rng, B: int, N: int, K: int):
    """B frames of a K-part object whose parts 1..K-1 turn about the
    canonical z axis (revolute joints to part 0).  Each part is random
    NOCS points under a known similarity; the predictions are perfect:
    one-hot segmentation, exact NOCS, the true axis, the true joint
    association.  Returns (clouds, predictions, (R, s, t) ground truth)."""
    P = np.zeros((B, N, 3), np.float32)
    W = np.zeros((B, N, K), np.float32)
    nocs = np.zeros((B, N, 3 * K), np.float32)
    index = np.zeros((B, N, K), np.float32)
    axis = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (B, N, 1))
    gR = np.zeros((B, K, 3, 3))
    gs = np.zeros((B, K))
    gt = np.zeros((B, K, 3))
    for b in range(B):
        Rc = random_rotation(rng)
        s = rng.uniform(0.8, 1.2)
        t = rng.uniform(-0.5, 0.5, 3)
        labels = rng.randint(0, K, N)
        for j in range(K):
            Rj = Rc if j == 0 else Rc @ rot_z(rng.uniform(-1.2, 1.2))
            sj = s * rng.uniform(0.5, 1.0)
            tj = t + Rc @ rng.uniform(-0.3, 0.3, 3)
            sel = labels == j
            n = rng.rand(int(sel.sum()), 3)
            P[b, sel] = sj * n @ Rj.T + tj
            nocs[b, sel, 3 * j:3 * j + 3] = n
            W[b, sel, j] = 1.0
            index[b, sel, j] = 1.0
            gR[b, j], gs[b, j], gt[b, j] = Rj, sj, tj
    pred = {"W": W, "nocs_per_point": nocs, "joint_axis_per_point": axis,
            "index_per_point": index}
    return P, pred, (gR, gs, gt)


def rot_err_deg(R: np.ndarray, R_gt: np.ndarray) -> np.ndarray:
    tr = np.einsum("...ij,...ij->...", R, R_gt)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def pose_oracle(dev):
    import torch

    from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                          PoseFitConfig,
                                                          fit_frame_batch)

    K = 3
    P, pred, (gR, gs, gt) = articulated_frames(np.random.RandomState(1),
                                               ORACLE_FRAMES, N_POINTS, K)
    cfg = PoseFitConfig(n_parts=K, joint_types=("revolute", "revolute"))
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = PoseDraws.sample(ORACLE_FRAMES, cfg, gen, dev)
    t0 = time.perf_counter()
    out = fit_frame_batch({k: torch.from_numpy(v).to(dev)
                           for k, v in pred.items()},
                          torch.from_numpy(P).to(dev), draws, cfg)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    seconds = time.perf_counter() - t0
    for prefix in ("baseline", "nonlinear"):
        rot = rot_err_deg(out[f"{prefix}_R"], gR)
        s_rel = np.abs(out[f"{prefix}_s"] - gs) / gs
        t_err = np.abs(out[f"{prefix}_t"] - gt).max(-1)
        log(f"[pose] {prefix}: max rot err {rot.max():.4f} deg, max scale "
            f"rel err {s_rel.max():.2e}, max trans err {t_err.max():.2e} "
            f"over {ORACLE_FRAMES} frames x {K} parts")
        if not (rot.max() < 3.0 and s_rel.max() < 0.05 and t_err.max() < 0.05):
            raise AssertionError(f"pose oracle failed for {prefix}")
    log(f"[pose] fit_frame_batch B={ORACLE_FRAMES} N={N_POINTS} K={K} "
        f"niter 128/64 on the card: {seconds:.3f} s (first call)")


# ---------------------------------------------------------------- phase 4
def expected_launches(**per_call) -> dict:
    """Every kernel's launches in one call of a path: the named ones,
    zero for the rest."""
    from articulated_pose_tpu_torch.ops.kernels import KERNELS

    return {name: per_call.get(name, 0) for name in KERNELS}


def serve_requests(label, predictor, clouds, batch, per_batch, timer=None):
    """Serve len(clouds) // batch requests through serve_clouds with the
    launch counts set to 0 first; check each request's launches, shapes
    and finiteness; `timer` (utils/profiling.StepTimer) times each
    request as a stage named `label`.  Returns the path's launch
    counts."""
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.serving import serve_clouds

    K = predictor.config.n_max_parts
    N = clouds.shape[1]
    requests = len(clouds) // batch
    reset_launch_counts()
    latencies = []
    for r in range(requests):
        before = launch_counts()
        t0 = time.perf_counter()
        with (timer.stage(label) if timer else contextlib.nullcontext()):
            out = serve_clouds(predictor, clouds[r * batch:(r + 1) * batch],
                               batch)
        latencies.append(time.perf_counter() - t0)
        after = launch_counts()
        rise = {k: after[k] - before[k] for k in after}
        if rise != per_batch:
            raise AssertionError(f"[{label}] request {r}: kernel launches "
                                 f"{rise}, expected {per_batch}")
        shapes = {"R": (batch, K, 3, 3), "s": (batch, K), "t": (batch, K, 3),
                  "seg": (batch, N), "part_counts": (batch, K)}
        for k, shape in shapes.items():
            if out[k].shape != shape:
                raise AssertionError(f"{k} has shape {out[k].shape}, "
                                     f"expected {shape}")
        for k in ("R", "s", "t"):
            if not np.isfinite(out[k]).all():
                raise AssertionError(f"[{label}] request {r}: non-finite {k}")
        if (out["part_counts"].sum(-1) != N).any():
            raise AssertionError("part counts do not add up to N")
    counts = launch_counts()
    for r, lat in enumerate(latencies):
        log(f"[{label}] request {r}: {batch} clouds in {lat * 1e3:.1f} ms")
    steady = latencies[1:]
    log(f"[{label}] steady {batch * len(steady) / sum(steady):.1f} clouds/s "
        f"(requests 1..{requests - 1}, N={N}, K={K}, niter "
        f"{predictor.pose_cfg.niter_part}/{predictor.pose_cfg.niter_joint});"
        f" launches {counts}")
    return counts


def serve(dev):
    """Phase 4: the f32 serve, its forward against the CPU and the bf16
    trunk; then the packed bf16 serve.  Returns each path's counts."""
    import torch

    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.serving import PosePredictor

    cfg = NetworkConfig(category="eyeglasses", n_max_parts=3,
                        num_points=N_POINTS, batch_size=SERVE_BATCH)
    state = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    predictor = PosePredictor(cfg, state_dict=state, device=dev)
    clouds, _, _ = articulated_frames(np.random.RandomState(2),
                                      SERVE_REQUESTS * PACKED_BATCH, N_POINTS,
                                      3)
    paths = {"serve f32": serve_requests(
        "serve f32", predictor, clouds[:SERVE_REQUESTS * SERVE_BATCH],
        SERVE_BATCH, expected_launches(fps2=1, ball_query_group=2,
                                       three_nn=2, joint_fit=1))}

    # forward on the card against the same weights on the CPU, B=2
    x = torch.from_numpy(clouds[:2])
    with torch.no_grad():
        gpu = predictor.model(x.to(dev))
        cpu = build_model(cfg).eval()
        cpu.load_state_dict(state)
        ref = cpu(x)
    worst = max((gpu[k].cpu() - ref[k]).abs().max().item() for k in ref)
    log(f"[serve f32] forward card vs CPU (plain ops), B=2: max abs diff "
        f"{worst:.3g} over {len(ref)} outputs")
    if not worst < 1e-3:
        raise AssertionError("forward on the card disagrees with the CPU")

    # bf16 trunk (the bench's inference setting)
    bf16 = build_model(cfg.replace(compute_dtype="bfloat16"), device=dev)
    bf16.load_state_dict(state)
    with torch.no_grad():
        out = bf16(torch.from_numpy(clouds[:SERVE_BATCH]).to(dev))
        f32 = predictor.model(torch.from_numpy(clouds[:SERVE_BATCH]).to(dev))
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"bf16 forward: non-finite {k}")
    diff = max((out[k] - f32[k]).abs().max().item() for k in out)
    log(f"[serve f32] bf16 trunk forward B={SERVE_BATCH}: finite, max abs "
        f"diff to f32 {diff:.3g}")

    # the configuration bench.py times: bf16 trunk, packed ball query
    packed_cfg = cfg.replace(compute_dtype="bfloat16", ball_query_packed=True,
                             batch_size=PACKED_BATCH)
    packed = PosePredictor(packed_cfg, state_dict=state, device=dev)
    paths["serve packed bf16"] = serve_requests(
        "serve packed bf16", packed, clouds, PACKED_BATCH,
        expected_launches(fps2=1, ball_query_group_packed=2, three_nn=2,
                          joint_fit=1))
    with torch.no_grad():
        x = torch.from_numpy(clouds[:SERVE_BATCH]).to(dev)
        q = packed.model(x)
        exact = bf16(x)
    diff = max((q[k] - exact[k]).abs().max().item() for k in q)
    log(f"[serve packed bf16] forward B={SERVE_BATCH}: max abs diff to the "
        f"exact bf16 forward {diff:.3g}")
    return paths


# ------------------------------------------------------------ phases 5-7
def forward_launches(label, model, P, per_forward, forwards=1):
    """Run `forwards` forwards of P with the launch counts set to 0
    first; check each forward's launches, shapes and finiteness.
    Returns (last output, host-clock seconds per forward, counts)."""
    import torch

    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)

    reset_launch_counts()
    seconds = []
    for f in range(forwards):
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(P)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        after = launch_counts()
        rise = {k: after[k] - before[k] for k in after}
        if rise != per_forward:
            raise AssertionError(f"[{label}] forward {f}: kernel launches "
                                 f"{rise}, expected {per_forward}")
        for k, v in out.items():
            if v.shape[:2] != P.shape[:2] or not torch.isfinite(v).all():
                raise AssertionError(f"[{label}] forward {f}: {k} has shape "
                                     f"{tuple(v.shape)} or is not finite")
    return out, seconds, launch_counts()


def card_vs_cpu(label, make_model, state, P):
    """The f32 forward on the card against the same weights on the CPU:
    the kernels equal their plain versions, so the neighbourhoods are
    the same and only matmul summation order differs; 1e-3, the serve
    phase's bound."""
    import torch

    gpu_model = make_model(torch.float32).to(P.device)
    gpu_model.load_state_dict(state)
    cpu_model = make_model(torch.float32)
    cpu_model.load_state_dict(state)
    with torch.no_grad():
        gpu = gpu_model(P)
        ref = cpu_model(P.cpu())
    worst = max((gpu[k].cpu() - ref[k]).abs().max().item() for k in ref)
    log(f"[{label}] f32 forward card vs CPU (plain ops), B={P.shape[0]} "
        f"N={P.shape[1]}: max abs diff {worst:.3g} over {len(ref)} outputs")
    if not worst < 1e-3:
        raise AssertionError(f"[{label}] forward on the card disagrees with "
                             "the CPU")


def large_cloud(dev):
    """Phase 5: the large-cloud forward; returns the path's counts."""
    import torch

    from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
    from articulated_pose_tpu_torch.models.layers import init_weights
    from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec

    spec = BackboneSpec(ball_query_impl="stream")

    def model(dtype):
        m = ANCSHModel(n_max_parts=3, dtype=dtype, backbone_spec=spec)
        return m.eval()

    state = init_weights(model(torch.float32),
                         torch.Generator().manual_seed(3)).state_dict()
    bf16 = model(torch.bfloat16).to(dev)
    bf16.load_state_dict(state)
    P = torch.from_numpy(np.random.RandomState(4).rand(
        LARGE_B, LARGE_N, 3).astype(np.float32)).to(dev)
    _, seconds, counts = forward_launches(
        "large", bf16, P, expected_launches(fps2=1, ball_query_idx=2,
                                            three_nn=2), LARGE_FORWARDS)
    log(f"[large] bf16 forward B={LARGE_B} N={LARGE_N}: "
        + ", ".join(f"{t * 1e3:.1f}" for t in seconds)
        + f" ms (host clock, synchronised); launches {counts}")
    card_vs_cpu("large", model, state, P[:1])
    return counts


# ---------------------------------------------------------------- phase 6
def bucket_path(dev):
    """Phase 6: bench.py's forward + pose fit with the bucket ball query;
    returns the counts of the "bucket" and "bucket_xla" paths."""
    import torch

    from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
    from articulated_pose_tpu_torch.models.layers import init_weights
    from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                          PoseFitConfig,
                                                          fit_frame_batch)
    from articulated_pose_tpu_torch.serving import POSE_KEYS

    K, B = 3, BUCKET_BATCH

    def make(impl):
        def model(dtype):
            return ANCSHModel(n_max_parts=K, dtype=dtype,
                              backbone_spec=BackboneSpec(
                                  ball_query_impl=impl)).eval()
        return model

    bucket = make("bucket")
    state = init_weights(bucket(torch.float32),
                         torch.Generator().manual_seed(5)).state_dict()
    model = bucket(torch.bfloat16).to(dev)
    model.load_state_dict(state)
    clouds, _, _ = articulated_frames(np.random.RandomState(6),
                                      BUCKET_BATCHES * B, N_POINTS, K)
    clouds = torch.from_numpy(clouds).to(dev)
    cfg = PoseFitConfig(n_parts=K, niter_part=128, niter_joint=64,
                        joint_types=("revolute", "revolute"))
    draws = PoseDraws.sample(B, cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    per_batch = expected_launches(fps2=1, ball_query_group_bucket=2,
                                  three_nn=2, joint_fit=1)

    reset_launch_counts()
    latencies = []
    for b in range(BUCKET_BATCHES):
        P = clouds[b * B:(b + 1) * B]
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            pred = model(P)
            fits = fit_frame_batch({k: pred[k] for k in POSE_KEYS}, P, draws,
                                   cfg)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        after = launch_counts()
        rise = {k: after[k] - before[k] for k in after}
        if rise != per_batch:
            raise AssertionError(f"[bucket] batch {b}: kernel launches {rise}"
                                 f", expected {per_batch}")
        for k, shape in (("baseline_R", (B, K, 3, 3)), ("nonlinear_R",
                                                         (B, K, 3, 3)),
                         ("baseline_s", (B, K)), ("baseline_t", (B, K, 3))):
            v = fits[k]
            if tuple(v.shape) != shape or not torch.isfinite(v).all():
                raise AssertionError(f"[bucket] batch {b}: {k} has shape "
                                     f"{tuple(v.shape)} or is not finite")
    counts = {"bucket bf16": launch_counts()}
    for b, lat in enumerate(latencies):
        log(f"[bucket] batch {b}: {B} clouds, forward + pose fit in "
            f"{lat * 1e3:.1f} ms (host clock, synchronised)")
    steady = latencies[1:]
    log(f"[bucket] steady {B * len(steady) / sum(steady):.1f} clouds/s "
        f"(batches 1..{BUCKET_BATCHES - 1}, bf16, N={N_POINTS}, K={K}, niter "
        f"128/64); launches {counts['bucket bf16']}")

    card_vs_cpu("bucket", bucket, state, clouds[:2])

    # the exact tier on the same weights: another neighbour subset
    exact = make("xla")(torch.bfloat16).to(dev)
    exact.load_state_dict(state)
    with torch.no_grad():
        a, e = model(clouds[:B]), exact(clouds[:B])
    diff = max((a[k] - e[k]).abs().max().item() for k in a)
    log(f"[bucket] bf16 forward B={B}: max abs diff to the exact bf16 "
        f"forward {diff:.3g} (another neighbour subset; no bound)")

    # "bucket_xla": B8's indices, f32 offsets gathered after
    xla = make("bucket_xla")(torch.bfloat16).to(dev)
    xla.load_state_dict(state)
    out, seconds, counts["bucket_xla bf16"] = forward_launches(
        "bucket_xla", xla, clouds[:B], dict(per_batch, joint_fit=0))
    diff = max((out[k] - a[k]).abs().max().item() for k in out)
    log(f"[bucket_xla] bf16 forward B={B}: {seconds[0] * 1e3:.1f} ms, max "
        f"abs diff to the bucket forward {diff:.3g} (f32 against bf16 "
        f"offsets); launches {counts['bucket_xla bf16']}")
    return counts


# ---------------------------------------------------------------- phase 7
def nlevel_path(dev):
    """Phase 7: the four-level pyramid at N=8192; returns its counts."""
    import torch

    from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
    from articulated_pose_tpu_torch.models.layers import init_weights
    from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec

    spec = BackboneSpec(**NLEVEL_SPEC)

    def make(dtype):
        return ANCSHModel(n_max_parts=3, dtype=dtype,
                          backbone_spec=spec).eval()

    state = init_weights(make(torch.float32),
                         torch.Generator().manual_seed(7)).state_dict()
    P = torch.from_numpy(np.random.RandomState(8).rand(
        NLEVEL_B, NLEVEL_N, 3).astype(np.float32)).to(dev)
    levels = len(spec.sa_npoints)
    per_forward = expected_launches(fps=levels, ball_query_group=levels,
                                    three_nn=levels)
    counts = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = make(dtype).to(dev)
        model.load_state_dict(state)
        _, seconds, counts[f"N-level {name}"] = forward_launches(
            f"N-level {name}", model, P, per_forward, NLEVEL_FORWARDS)
        log(f"[N-level] {name} forward B={NLEVEL_B} N={NLEVEL_N}, "
            f"{levels} SA levels: "
            + ", ".join(f"{t * 1e3:.1f}" for t in seconds)
            + f" ms (host clock, synchronised); launches "
            f"{counts[f'N-level {name}']}")
    card_vs_cpu("N-level", make, state, P[:1])
    return counts


# ------------------------------------------------------------ phases 8-9
def profile_path(dev):
    """Phase 8: the stage profiler over every stage; returns its counts
    and its rows.  Each stage's device ops a call must cover the port's
    kernels it launched a call."""
    from articulated_pose_tpu_torch import profile_stages
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)

    reset_launch_counts()
    rows = profile_stages.run(batch=PROFILE_B, points=N_POINTS,
                              iters=PROFILE_ITERS, device=str(dev))
    counts = launch_counts()
    if [r["stage"] for r in rows] != list(profile_stages.STAGES):
        raise AssertionError("profile_stages did not run every stage")
    for r in rows:
        if not (r["wall_ms"] > 0 and r["device_ms"] > 0
                and r["device_ops"] >= max(1, sum(r["launches"].values()))):
            raise AssertionError(f"[profile] {r['stage']}: device work "
                                 f"missing from the trace ({r})")
    per_call = {r["stage"]: r["launches"] for r in rows}
    want = {"forward": {"fps2": 1, "ball_query_group": 2, "three_nn": 2},
            "fps1": {"fps": 1}, "fps2": {"fps": 1},
            "bq1": {"ball_query_point": 1}, "bq2": {"ball_query_point": 1},
            "threenn": {"three_nn": 1}}
    for stage, launches in want.items():
        if per_call[stage] != launches:
            raise AssertionError(f"[profile] {stage}: launches per call "
                                 f"{per_call[stage]}, expected {launches}")
    log(f"[profile] B={PROFILE_B} N={N_POINTS}, {PROFILE_ITERS} iterations "
        f"per stage; launches {counts}")
    return counts, rows


def kernel_entries(entries):
    """Phase 9: each kernel entry called once at phase 2's shapes; its
    outputs must equal the plain version's, but B9's distances, which may
    be one key quantum off.  Returns the path's counts."""
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)

    reset_launch_counts()
    got = [(name, call(), want) for name, call, want in entries]
    counts = launch_counts()
    for name, out, want in got:
        if name == "three_nn_packed":
            key_quanta_off(f"[entries] {name}", out[0], want[0])
            out, want = out[1:], want[1:]
        check_equal(f"[entries] {name}", out, want)
    log(f"[entries] {len(entries)} calls, outputs held against the plain "
        f"versions; launches {counts}")
    return counts


# --------------------------------------------------------------- phase 10
def train_frames(cfg, n: int, seed: int):
    """n labelled frames of the port's synthetic generator, as main.py's
    synthetic feed makes them (400 points a part, main.py:55-57)."""
    from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated

    spec = cfg.category_spec
    gen = SyntheticArticulated(n_parts=spec.n_parts, points_per_part=400,
                               joint_types=list(spec.joint_types), seed=0)
    rng = np.random.RandomState(seed)
    return [gen.frame(rng, num_points=cfg.num_points,
                      n_max_parts=cfg.n_max_parts,
                      nocs_type="AC" if cfg.is_mixed else "A")[0]
            for _ in range(n)]


def stack(frames) -> dict:
    return {k: np.stack([f[k] for f in frames]) for k in frames[0]}


def prefetch_check(frames, dev, batch: int = 4, epochs: int = 2) -> int:
    """Phase 10(a): device_prefetch's batches against the host batches
    they copy, bit for bit and in order: a shuffled BatchIterator over
    `frames` for `epochs` epochs, prefetched 2 batches ahead.  The copy
    stream starts behind a spin kernel (tens of ms), so every copy lands
    late: a batch the consuming stream read before its copy's event
    would hold stale memory.  The consuming stream clones each batch as
    it gets it, then again behind a spin of about a ms, by which time
    the host has let the batch go: memory handed to a later batch's copy
    while this stream still reads it would hold that batch.  Returns the
    number of batches checked."""
    import itertools

    import torch

    from articulated_pose_tpu_torch.data.batcher import (BatchIterator,
                                                         device_prefetch)

    def feed():
        return BatchIterator(len(frames), lambda i: frames[i], batch,
                             shuffle=True, seed=1)

    host = feed()
    want = [b for _ in range(epochs) for b in host]
    copy = torch.cuda.Stream(dev)
    with torch.cuda.stream(copy):
        torch.cuda._sleep(PREFETCH_COPY_SPIN)
    got = []
    card = feed()
    for b in device_prefetch(
            itertools.chain.from_iterable(itertools.repeat(card, epochs)),
            size=2, device=dev, stream=copy):
        first = {k: v.clone() for k, v in b.items()}
        torch.cuda._sleep(PREFETCH_READ_SPIN)
        got.append((first, {k: v.clone() for k, v in b.items()}))
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError(f"[prefetch] {len(got)} batches, expected "
                             f"{len(want)}")
    for i, ((first, later), w) in enumerate(zip(got, want)):
        for when, g in (("as it came", first), ("behind a spin", later)):
            if set(g) != set(w) or not all(
                    torch.equal(g[k].cpu(), torch.from_numpy(w[k]))
                    for k in w):
                raise AssertionError(f"[prefetch] batch {i}, read {when}, "
                                     f"differs from the host batch")
    log(f"[prefetch] device_prefetch: {len(got)} batches of {batch} "
        f"({epochs} epochs, 2 ahead, the copy stream started late) equal "
        f"the host batches in order, read as they came and behind a spin")
    return len(got)


def fit_and_read(label, cfg, frames, work_dir, steps, dev):
    """Trainer.fit over a BatchIterator of `frames` (one batch an epoch)
    for `steps` steps, every step logged; the launch counts set to 0
    first.  Checks every step's metrics finite with grads_finite true;
    returns (the per-step metric records, the launch counts)."""
    import torch

    from articulated_pose_tpu_torch.data.batcher import BatchIterator
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.train.trainer import Trainer

    model = build_model(cfg, torch.Generator().manual_seed(0))
    it = BatchIterator(len(frames), lambda i: frames[i], cfg.batch_size,
                       shuffle=True, seed=0)
    tr = Trainer(model, cfg, work_dir=str(work_dir), device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    tr.fit(it, max_steps=steps, log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    with open(tr.logger.path) as f:
        records = [json.loads(line) for line in f]
    if [r["step"] for r in records] != list(range(1, steps + 1)):
        raise AssertionError(f"[{label}] logged steps "
                             f"{[r['step'] for r in records]}")
    for r in records:
        if r["grads_finite"] != 1.0 or not all(
                np.isfinite(v) for v in r.values()):
            raise AssertionError(f"[{label}] step {r['step']}: {r}")
    want = expected_launches(fps2=steps, ball_query_group=2 * steps,
                             three_nn=2 * steps)
    if counts != want:
        raise AssertionError(f"[{label}] launches {counts}, expected {want}")
    log(f"[{label}] {steps} steps B={cfg.batch_size} N={cfg.num_points} "
        f"{cfg.compute_dtype}: total_loss {records[0]['total_loss']:.4f} -> "
        f"{records[-1]['total_loss']:.4f}, grad_norm "
        f"{records[0]['grad_norm']:.3f} -> {records[-1]['grad_norm']:.3f}, "
        f"{seconds:.2f} s (host clock, first step's build and warm-up "
        f"included); launches {counts}")
    return records, counts


def train_card_vs_cpu(cfg, state, batch, dev):
    """Phase 10(b): one train step on the card against the same step on
    the CPU, dropout off.  The kernels' outputs on this batch must equal
    the plain versions' bit for bit, and the losses agree to rtol 1e-5.

    The two forwards differ by ~1e-6 (cuBLAS's sum order), so a ReLU
    input or a near-tie of a max that close can route the other way, and
    a max routes a whole output's gradient (`train.routing`).  So the
    card's step runs twice.  With the CPU's routing imposed (its ReLU
    masks and max-pool selections), each leaf is held within 1e-3 of its
    scale (its largest CPU entry; for a dense bias ahead of a batch norm,
    whose exact gradient is 0, its layer's weight gradient's) plus 1e-7
    of the model's largest CPU gradient entry, the f32 rounding of sums
    whose terms cancel to about 0 (the last SA stage's batch-norm bias,
    ahead of a max pool whose consumers are batch-normed).  With its own
    routing, the choices that differ from the CPU's must be at most
    `TRAIN_FLIP_LIMIT` of all, and each leaf within
    `TRAIN_OWN_ROUTING_BOUND` of its scale plus the same floor."""
    import torch

    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.ops.kernels.ball_query import \
        ball_query_group
    from articulated_pose_tpu_torch.ops.kernels.fps import fps2
    from articulated_pose_tpu_torch.models.pointnet2 import SetAbstraction
    from articulated_pose_tpu_torch.ops.kernels.three_nn import three_nn
    from articulated_pose_tpu_torch.train.routing import (capture_routing,
                                                          count_flips,
                                                          grad_deviations,
                                                          impose_routing,
                                                          pre_bn_biases)
    from articulated_pose_tpu_torch.train.state import (TrainState,
                                                        loss_and_grads,
                                                        to_device)

    cfg = cfg.replace(dropout_rate=0.0, batch_size=batch["P"].shape[0])
    spec = build_model(cfg).backbone.spec
    cpu = torch.device("cpu")
    # the kernels on the path, on this batch: card against plain
    outs = {}
    for where in (dev, cpu):
        xyz = torch.from_numpy(batch["P"]).to(where)
        i1, x1, i2, x2 = fps2(xyz, spec.sa_npoints[0], spec.sa_npoints[1])
        g1 = ball_query_group(spec.sa_radii[0], spec.sa_nsamples[0], xyz, x1)
        g2 = ball_query_group(spec.sa_radii[1], spec.sa_nsamples[1], x1, x2,
                              emit_idx=True)
        outs[where] = [t.cpu() for t in (i1, x1, i2, x2, *g1[:2], *g2,
                                         *three_nn(x1, x2),
                                         *three_nn(xyz, x1))]
    check_equal("[train card vs CPU] kernel outputs", outs[dev], outs[cpu])

    def step(where, hooks_for):
        model = build_model(cfg, device=where)
        model.load_state_dict(state)
        model.joint_net.dropout_rate = 0.0
        hooks = hooks_for(model)
        st = TrainState(model, cfg)
        total, _, grads = loss_and_grads(st, to_device(batch, where))
        for h in hooks:
            h.remove()
        return total.item(), dict(zip(st.names, (g.cpu() for g in grads)))

    record, own = {}, {}
    ref_loss, want = step(cpu, lambda model: capture_routing(model, record))
    loss, plain = step(dev, lambda model: capture_routing(model, own))
    _, got = step(dev, lambda model: impose_routing(model, record))
    model = build_model(cfg)
    pools = {n for n, m in model.named_modules()
             if isinstance(m, SetAbstraction)}
    flips = {kind: count_flips({k: v for k, v in own.items()
                                if (k in pools) == is_pool}, record)
             for kind, is_pool in (("ReLU", False), ("max", True))}
    flipped = sum(f for f, _ in flips.values())
    choices = sum(n for _, n in flips.values())
    zero = pre_bn_biases(model)
    free = grad_deviations(plain, want, zero)
    held = grad_deviations(got, want, zero)
    show = lambda rows: ", ".join(f"{n} {r:.2e} ({d:.2e})"  # noqa: E731
                                  for r, n, d, _ in rows[:4])
    log(f"[train card vs CPU] B={cfg.batch_size} N={cfg.num_points} f32: "
        f"loss {loss:.6f} vs {ref_loss:.6f} (rel "
        f"{abs(loss - ref_loss) / abs(ref_loss):.2e}); choices routed "
        f"otherwise than on the CPU: "
        + ", ".join(f"{kind} {f} of {n}" for kind, (f, n) in flips.items())
        + f" ({flipped / choices:.2e}); largest gradient deviations "
        f"relative to the leaf's largest CPU entry (a pre-BN bias: its "
        f"weight's), absolute in brackets; own routing: {show(free)}; the "
        f"CPU's routing imposed: {show(held)}")
    if not abs(loss - ref_loss) <= 1e-5 * abs(ref_loss):
        raise AssertionError("train step: card loss disagrees with the CPU")
    if not flipped <= TRAIN_FLIP_LIMIT * choices:
        raise AssertionError(f"train step: {flipped} of {choices} choices "
                             f"routed otherwise than on the CPU, more than "
                             f"{TRAIN_FLIP_LIMIT:g} of them")
    floor = 1e-7 * max(w.abs().max().item() for w in want.values())
    for rows, bound, label in ((held, 1e-3, "with the CPU's routing"),
                               (free, TRAIN_OWN_ROUTING_BOUND,
                                "with its own routing")):
        for _, name, dev_, scale in rows:
            if not dev_ <= bound * scale + floor:
                raise AssertionError(
                    f"train step {label}: gradient {name} deviates "
                    f"{dev_:.3e} (scale {scale:.3e}, bound {bound:g}, floor "
                    f"{floor:.3e})")


def train_rate(cfg, frames, dev, steps: int = 20):
    """Phase 10(d): train steps/s and clouds/s on a batch already on the
    card, host clock around `steps` synchronised steps after 3 warm-up
    steps; the device idle share from the profiler over 5 more.
    Returns (steps/s, clouds/s, device ms a step, idle share)."""
    import torch

    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.timing import device_profile
    from articulated_pose_tpu_torch.train.state import (TrainState,
                                                        dropout_generator,
                                                        to_device, train_step)

    model = build_model(cfg, torch.Generator().manual_seed(0), device=dev)
    st = TrainState(model, cfg)
    batch = to_device(stack(frames), dev)
    gen = torch.Generator(device=dev)
    step = [0]

    def one():
        dropout_generator(gen, cfg.seed, step[0])
        step[0] += 1
        return train_step(st, batch, gen)

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = one()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    counts = launch_counts()
    want = expected_launches(fps2=steps, ball_query_group=2 * steps,
                             three_nn=2 * steps)
    if counts != want or not bool(m["grads_finite"]):
        raise AssertionError(f"[train rate] launches {counts} (expected "
                             f"{want}), grads_finite {m['grads_finite']}")
    device_ms, ops = device_profile(one, 5)
    if ops < sum(want.values()) // steps:
        raise AssertionError(f"[train rate] {ops} device ops a step in the "
                             f"trace, fewer than the step's kernels")
    idle = 1.0 - device_ms / (wall * 1e3)
    B = cfg.batch_size
    log(f"[train rate] B={B} N={cfg.num_points} {cfg.compute_dtype}: "
        f"{1 / wall:.2f} steps/s, {B / wall:.1f} clouds/s ({wall * 1e3:.2f} "
        f"ms a step, host clock over {steps} synchronised steps); device "
        f"{device_ms:.2f} ms and {ops} ops a step (torch.profiler, 5 "
        f"steps), idle share {idle:.3f}")
    return counts


def train_path(dev):
    """Phase 10: `main.py train`'s path in the port.  Returns each
    sub-path's launch counts."""
    import tempfile

    import torch

    from articulated_pose_tpu_torch.config import load_config
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.serving import PosePredictor

    yml = load_config(str(ROOT / "cfg" / "network_config.yml"))
    if (yml.category, yml.n_max_parts, yml.num_points, yml.batch_size) != (
            "eyeglasses", 3, TRAIN_N, TRAIN_B):
        raise AssertionError(f"cfg/network_config.yml changed: {yml}")
    f32 = yml.replace(compute_dtype="float32")
    frames = train_frames(f32, TRAIN_RATE_B[-1], seed=0)
    paths = {}
    with tempfile.TemporaryDirectory() as work:
        # (a) 30 steps on one batch, f32, through the trainer's feed
        prefetch_check(frames, dev)
        records, paths["train f32"] = fit_and_read(
            "train f32", f32, frames[:TRAIN_B], pathlib.Path(work) / "f32",
            TRAIN_STEPS, dev)
        first, last = records[0]["total_loss"], records[-1]["total_loss"]
        if not last < 0.8 * first:
            raise AssertionError(f"[train f32] total_loss {first} -> {last}:"
                                 " not below 0.8x the first in "
                                 f"{TRAIN_STEPS} steps")
        predictor = PosePredictor(f32, work_dir=str(pathlib.Path(work)
                                                    / "f32"), device=dev)
        reset_launch_counts()
        out = predictor(stack(frames[:TRAIN_B])["P"])
        paths["train checkpoint serve"] = launch_counts()
        want = expected_launches(fps2=1, ball_query_group=2, three_nn=2,
                                 joint_fit=1)
        if paths["train checkpoint serve"] != want:
            raise AssertionError(f"serving the trained checkpoint: launches "
                                 f"{paths['train checkpoint serve']}, "
                                 f"expected {want}")
        for k in ("R", "scale", "t"):
            if not np.isfinite(getattr(out, k)).all():
                raise AssertionError(f"serving the trained checkpoint: "
                                     f"non-finite {k}")
        seg = (out.segmentation == stack(frames[:TRAIN_B])["cls_gt"]).mean()
        log(f"[train f32] PosePredictor(work_dir=...) served {TRAIN_B} "
            f"clouds from the step-{TRAIN_STEPS} checkpoint: finite poses, "
            f"segmentation accuracy {seg:.3f} on the training batch; "
            f"launches {paths['train checkpoint serve']}")
        # (c) the yml as written: bf16 trunk
        _, paths["train bf16"] = fit_and_read(
            "train bf16", yml, frames[:TRAIN_B], pathlib.Path(work) / "bf16",
            TRAIN_BF16_STEPS, dev)
    # (b) one step, card against CPU, B=2
    state = build_model(f32, torch.Generator().manual_seed(1)).state_dict()
    train_card_vs_cpu(f32, state, stack(frames[:2]), dev)
    # (d) the step's rate at B=16 and B=32
    for B in TRAIN_RATE_B:
        paths[f"train rate B={B}"] = train_rate(f32.replace(batch_size=B),
                                                frames[:B], dev)
    return paths


# --------------------------------------------------------------- phase 11
def e2e_setup(category: str, seed: int, dev, steps: int = E2E_STEPS):
    """The e2e entry point's flags, part count, joint types, train config
    and card generator for one category of the sweep."""
    from articulated_pose_tpu_torch import e2e

    args = e2e.parse_args(["--category", category, "--seed", str(seed),
                           "--steps", str(steps), "--steps-per-call", "1",
                           "--test-frames", str(E2E_TEST_FRAMES)])
    K, joint_types = e2e.category_setup(args)
    return (args, K, joint_types, e2e.train_config(args, K),
            e2e.synthetic(args, K, joint_types, dev))


def synthetic_card_vs_cpu(dev):
    """Phase 11(a): DeviceSynthetic on the card against the same
    generator on the CPU, one set of draws (made on the card, moved to
    the CPU), B=32, N=1024: every label equal, P and the GT poses within
    E2E_FRAME_TOL (the card's sin, cos and sums round apart from the
    CPU's)."""
    import torch

    from articulated_pose_tpu_torch import e2e

    for category, seed in E2E_CATEGORIES:
        args, K, joint_types, _, card = e2e_setup(category, seed, dev)
        host = e2e.synthetic(args, K, joint_types, "cpu")
        draws = card.draw(torch.Generator(device=dev).manual_seed(seed),
                          args.batch)
        got, got_gt = card.frames(draws)
        want, want_gt = host.frames(draws.to("cpu"))
        labels = [k for k in want if k != "P"]
        check_equal(f"[synthetic {category}] labels",
                    [got[k].cpu() for k in labels], [want[k] for k in labels])
        devs = {k: (a.cpu() - b).abs().max().item() for k, (a, b) in
                {"P": (got["P"], want["P"]),
                 **{f"gt {k}": (got_gt[k], want_gt[k]) for k in want_gt}
                 }.items()}
        if not max(devs.values()) <= E2E_FRAME_TOL:
            raise AssertionError(f"[synthetic {category}] card vs CPU: {devs}")
        log(f"[synthetic {category}] K={K} B={args.batch} N={args.points} "
            f"(n_total {card.n_total}): {len(labels)} labels equal, max abs "
            f"diff " + ", ".join(f"{k} {v:.2e}" for k, v in devs.items())
            + f" (bound {E2E_FRAME_TOL:g})")


def synthetic_e2e(dev):
    """Phase 11(b, c): laptop, the e2e recipe (B=32, N=1024, f32, reference
    widths): E2E_STEPS fused steps with the data generated on the card,
    the launches checked after every step; then E2E_TEST_FRAMES held-out
    card frames through the eval forward, the pose fit (niter 1024/128)
    and evaluate_fits.  Returns each sub-path's launch counts."""
    import torch

    from articulated_pose_tpu_torch import e2e
    from articulated_pose_tpu_torch.data.device_synthetic import \
        make_fused_synthetic_train_step
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.timing import device_profile
    from articulated_pose_tpu_torch.train.state import TrainState

    args, K, joint_types, cfg, dg = e2e_setup("laptop", 2, dev)
    state = TrainState(build_model(cfg, torch.Generator().manual_seed(0),
                                   device=dev), cfg)
    fused = make_fused_synthetic_train_step(cfg, dg, args.batch,
                                            seed=e2e.DATA_KEY)
    paths = {}
    reset_launch_counts()
    for step in range(E2E_STEPS):
        m = fused(state, step)
        if step == 0:
            first = float(m["total_loss"])      # the one read mid-run
            t0 = time.perf_counter()
        want = expected_launches(fps2=step + 1, ball_query_group=2 * (step + 1),
                                 three_nn=2 * (step + 1))
        if launch_counts() != want:
            raise AssertionError(f"[synthetic e2e] after step {step + 1}: "
                                 f"launches {launch_counts()}, expected {want}")
    last = {k: float(v) for k, v in m.items()}
    wall = (time.perf_counter() - t0) / (E2E_STEPS - 1)
    paths["synthetic e2e train"] = launch_counts()
    if not (last["grads_finite"] == 1.0 and all(np.isfinite(v)
                                               for v in last.values())):
        raise AssertionError(f"[synthetic e2e] step {E2E_STEPS}: {last}")
    if not last["total_loss"] < 0.8 * first:
        raise AssertionError(f"[synthetic e2e] total_loss {first} -> "
                             f"{last['total_loss']}: not below 0.8x the first "
                             f"in {E2E_STEPS} steps")
    step = [E2E_STEPS]

    def one():
        fused(state, step[0])
        step[0] += 1

    device_ms, ops = device_profile(one, 5)
    idle = 1.0 - device_ms / (wall * 1e3)
    log(f"[synthetic e2e] laptop K={K} {E2E_STEPS} fused steps B={args.batch} "
        f"N={args.points} f32, batches generated on the card: total_loss "
        f"{first:.4f} -> {last['total_loss']:.4f}; {1 / wall:.2f} steps/s, "
        f"{args.batch / wall:.1f} clouds/s ({wall * 1e3:.2f} ms a step, host "
        f"clock over steps 2-{E2E_STEPS}, one read at the end); device "
        f"{device_ms:.2f} ms and {ops} ops a step (torch.profiler, 5 steps), "
        f"idle share {idle:.3f}; launches {paths['synthetic e2e train']}")

    reset_launch_counts()
    ev = e2e.evaluate(state, dg, e2e.pose_config(args, K, joint_types),
                      E2E_TEST_FRAMES, args.batch, dev)
    paths["synthetic e2e eval"] = launch_counts()
    batches = -(-E2E_TEST_FRAMES // args.batch)
    want = expected_launches(fps2=batches, ball_query_group=2 * batches,
                             three_nn=2 * batches, joint_fit=batches)
    if paths["synthetic e2e eval"] != want:
        raise AssertionError(f"[synthetic e2e eval] launches "
                             f"{paths['synthetic e2e eval']}, expected {want}")
    got = e2e.report_json(args, K, joint_types, ev, 0.0, 0, dev)
    with open(ROOT / "docs" / "e2e_laptop_report.json") as f:
        ref = json.load(f)
    for where, g, w in (("report", got, ref),
                        ("overall", got["overall"], ref["overall"]),
                        ("per_part", got["per_part"][0], ref["per_part"][0]),
                        ("per_joint", got["per_joint"][0],
                         ref["per_joint"][0])):
        missing = sorted(set(w) - set(g))
        if missing:
            raise AssertionError(f"[synthetic e2e eval] {where} lacks the JAX "
                                 f"report's keys {missing}")
    numbers = [v for d in (got["overall"], *got["per_part"],
                           *got["per_joint"]) for v in d.values()]
    if not np.isfinite(numbers + [got["seg_acc"]]).all():
        raise AssertionError(f"[synthetic e2e eval] non-finite report: {got}")
    o = got["overall"]
    log(f"[synthetic e2e eval] {E2E_TEST_FRAMES} held-out card frames after "
        f"{E2E_STEPS} steps (not held to the sweep): seg acc "
        f"{got['seg_acc']:.4f}, 5deg5cm {o['acc_5deg5cm']:.3f}, rot "
        f"{o['rot_err_deg_mean']:.2f} deg, mIoU {o['miou_mean']:.3f}, joint "
        f"axis {o['joint_axis_err_deg']:.2f} deg; forward + fit "
        f"{ev['fit_seconds']:.2f} s, evaluate_fits "
        f"{ev['evaluate_fits_seconds']:.2f} s (host clock); every value "
        f"finite, JAX's keys present; launches {paths['synthetic e2e eval']}")
    return paths


# --------------------------------------------------------------- phase 12
def run_cli(label: str, argv):
    """`articulated_pose_tpu_torch.main.main(argv)` in this process, its
    output captured and echoed, with the launch counts set to 0 just
    before.  Returns (stdout, host seconds, launch counts)."""
    import contextlib
    import io

    from articulated_pose_tpu_torch import main as cli
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)

    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv))
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[cli {label}] {line}")
    return out, seconds, counts


def check_launches(label: str, counts, **want):
    want = expected_launches(**want)
    if counts != want:
        raise AssertionError(f"[cli {label}] launches {counts}, expected "
                             f"{want}")


def check_report(label: str, path: pathlib.Path):
    """An eval report: JAX's top-level keys, every number finite."""
    with open(path) as f:
        report = json.load(f)
    if set(report) != CLI_REPORT_KEYS:
        raise AssertionError(f"[cli {label}] report keys {sorted(report)}, "
                             f"expected JAX's {sorted(CLI_REPORT_KEYS)}")
    numbers = [v for d in (report["overall"], *report["per_part"],
                           *report["per_joint"]) for v in d.values()]
    if not np.isfinite(numbers).all():
        raise AssertionError(f"[cli {label}] non-finite report: {report}")
    return report


def cli_demo_eval(work: pathlib.Path, common):
    """Phase 12(a, b): demo, then eval --synthetic in NPCS, NAOCS and with
    the GT joint association from a config file."""
    common = [*common, "--work_dir", str(work)]
    out, seconds, counts = run_cli("demo", ["demo", *common,
                                            "--max_steps", str(CLI_STEPS)])
    final = json.loads(out.split("final:")[1].strip())
    if not np.isfinite(final["total_loss"]):
        raise AssertionError(f"[cli demo] final loss {final}")
    check_launches("demo", counts, fps2=CLI_STEPS,
                   ball_query_group=2 * CLI_STEPS, three_nn=2 * CLI_STEPS)
    log(f"[cli demo] eyeglasses B={CLI_B} N={CLI_N} f32 reference widths: "
        f"{CLI_STEPS} steps in {final['elapsed_s']:.2f} s of Trainer.fit, "
        f"{CLI_STEPS / final['elapsed_s']:.2f} steps/s ({seconds:.2f} s for "
        f"the whole command, frames and model build included); launches "
        f"{counts}")
    paths = {"cli demo": counts}
    gt_yml = work / "gt_association.yml"
    gt_yml.write_text("use_gt_joint_association: true\n")
    batches = CLI_FRAMES // CLI_B
    for label, extra in (("eval NPCS", []), ("eval NAOCS", ["--nocs", "NAOCS"]),
                         ("eval GT association", ["--config", str(gt_yml)])):
        out, seconds, counts = run_cli(label, ["eval", "--synthetic",
                                               *common, *extra])
        if f"restored checkpoint step {CLI_STEPS}" not in out:
            raise AssertionError(f"[cli {label}] did not restore step "
                                 f"{CLI_STEPS}")
        check_launches(label, counts, fps2=batches,
                       ball_query_group=2 * batches, three_nn=2 * batches,
                       joint_fit=batches)
        o = check_report(label, work / "eval_all.json")["overall"]
        log(f"[cli {label}] {CLI_FRAMES} frames in {seconds:.2f} s (host "
            f"clock, the whole command; niter 128/64): 5deg5cm "
            f"{o['acc_5deg5cm']:.3f}, rot {o['rot_err_deg_mean']:.2f} deg; "
            f"JAX's report keys, every value finite; launches {counts}")
        paths[f"cli {label}"] = counts
    return paths


def cli_serve(work: pathlib.Path, common, dev):
    """Phase 12(c): serve --input (a short last batch) and serve
    --synthetic, each against serve_clouds on a PosePredictor of the same
    checkpoint."""
    from articulated_pose_tpu_torch import main as cli
    from articulated_pose_tpu_torch.serving import PosePredictor, serve_clouds

    common = [*common, "--work_dir", str(work)]
    args = cli.parse_args(["serve", *common, "--synthetic"])
    cfg, spec = cli.build_config(args)
    clouds = stack(train_frames(cfg, CLI_SERVE_CLOUDS, seed=5))["P"]
    np.save(work / "clouds.npy", clouds)
    # what serve --synthetic serves: the synthetic test split's clouds
    synthetic = np.concatenate(
        [b["P"] for b in cli.make_datasets(args, cfg, spec, "test")])
    predictor = PosePredictor(cfg, work_dir=str(work), device=dev)
    paths = {}
    for label, extra, clouds in (
            ("serve --input", ["--input", str(work / "clouds.npy")], clouds),
            ("serve --synthetic", ["--synthetic"], synthetic)):
        out_npz = work / "poses.npz"
        out, seconds, counts = run_cli(label, ["serve", *common, *extra,
                                               "--output", str(out_npz)])
        n = len(clouds)
        batches = -(-n // CLI_B)
        check_launches(label, counts, fps2=batches,
                       ball_query_group=2 * batches, three_nn=2 * batches,
                       joint_fit=batches)
        got = np.load(out_npz)
        want = serve_clouds(predictor, clouds, CLI_B)
        devs = {}
        for k in want:
            if got[k].shape != want[k].shape or got[k].shape[0] != n:
                raise AssertionError(f"[cli {label}] {k}: {got[k].shape} vs "
                                     f"{want[k].shape}")
            devs[k] = float(np.abs(got[k].astype(np.float64)
                                   - want[k]).max())
        if devs["seg"] or devs["part_counts"] or max(devs.values()) > 1e-5:
            raise AssertionError(f"[cli {label}] against serve_clouds: {devs}")
        log(f"[cli {label}] {n} clouds (batches of {CLI_B}, the last "
            f"{n - (batches - 1) * CLI_B}) in {seconds:.2f} s: "
            f"{n / seconds:.1f} clouds/s through the command (predictor "
            f"build and checkpoint load included); against serve_clouds: "
            f"max abs diff " + ", ".join(f"{k} {v:.1e}"
                                         for k, v in devs.items())
            + f"; launches {counts}")
        paths[f"cli {label}"] = counts
    return paths


def device_breakdown(fn, calls: int = 3, top: int = 6):
    """Device time of `fn` by kernel name from torch.profiler over
    `calls` calls after one warm-up: (device ms a call, [(name, ms a
    call, share)] of the `top` largest).  A trace can lose its first
    events, so this is a breakdown, not the step's device time (that is
    `timing.device_profile`'s)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    sums = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            sums[e.name] = sums.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(sums.values()) or 1.0
    rows = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return (total / calls / 1e3,
            [(name, us / calls / 1e3, us / total) for name, us in rows])


def joint_baseline_kernels(P):
    """Phase 12(d): B2 `fps` and B3 `ball_query_group` on the joint
    baseline's own batch, called as its SA1 and SA2 call them (SA1 emits
    no idx), with and without idx: every output equal to the plain
    version's."""
    from articulated_pose_tpu_torch.models.joint_regression import SA_STAGES
    from articulated_pose_tpu_torch.ops.kernels import ball_query, fps

    xyz, shapes = P[..., :3].float().contiguous(), []
    for npoint, r, S, _ in SA_STAGES:
        B, N, _ = xyz.shape
        got = fps.fps(xyz, npoint)
        check_equal(f"fps joint baseline B{B} N{N}->{npoint}", got,
                    fps.fps_plain(xyz, npoint))
        q = got[1]
        gp, cntp, idxp = ball_query.ball_query_group_plain(r, S, xyz, q)
        g, cnt, idx = ball_query.ball_query_group(r, S, xyz, q, emit_idx=True)
        g2, cnt2, _ = ball_query.ball_query_group(r, S, xyz, q,
                                                  emit_idx=False)
        check_equal(f"ball_query_group joint baseline B{B} N{N} "
                    f"M{npoint} S{S}", (g, cnt, idx, g2, cnt2),
                    (gp, cntp, idxp, gp, cntp))
        shapes.append(f"fps B{B} N{N}->{npoint}, ball_query_group M{npoint} "
                      f"S{S} r{r} (mean cnt {cnt.float().mean().item():.2f}, "
                      f"{int((cnt >= S).sum())} of {cnt.numel()} queries "
                      f"stop at S)")
        xyz = q
    log(f"[cli joint_baseline kernels] on the train batch's own cloud: "
        f"{'; '.join(shapes)}: every output equal to the plain version's")


def joint_baseline_rate(dev):
    """Phase 12(d): the joint-baseline train step on a batch on the card,
    B=16, N=1024: host clock around JB_RATE_STEPS synchronised steps
    after 3 warm-up steps; device ms, ops and idle share from the
    profiler over 5 more.  Returns the launch counts of the timed
    steps."""
    from articulated_pose_tpu_torch.config import load_config
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.timing import device_profile
    from articulated_pose_tpu_torch.train.joint_baseline import \
        JointBaselineTrainer
    from articulated_pose_tpu_torch.train.state import to_device

    import tempfile

    import torch

    cfg = load_config(category="eyeglasses", n_max_parts=3,
                      batch_size=CLI_B, num_points=CLI_N)
    with tempfile.TemporaryDirectory() as work:
        tr = JointBaselineTrainer(cfg, work, device=dev)
        batch = to_device(stack(train_frames(cfg, CLI_B, seed=7)), dev)
        for _ in range(3):
            tr.train_step(batch)
        joint_baseline_kernels(batch["P"])
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(JB_RATE_STEPS):
            m = tr.train_step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / JB_RATE_STEPS
        counts = launch_counts()
        check_launches("joint_baseline rate", counts, fps=2 * JB_RATE_STEPS,
                       ball_query_group=2 * JB_RATE_STEPS)
        if not np.isfinite(float(m["total_loss"])):
            raise AssertionError(f"[cli joint_baseline rate] {m}")
        device_ms, ops = device_profile(lambda: tr.train_step(batch), 5)
        traced_ms, rows = device_breakdown(lambda: tr.train_step(batch))
    idle = 1.0 - device_ms / (wall * 1e3)
    log(f"[cli joint_baseline rate] B={CLI_B} N={CLI_N} f32: "
        f"{wall * 1e3:.2f} ms a step, {1 / wall:.2f} steps/s, "
        f"{CLI_B / wall:.1f} clouds/s (host clock over {JB_RATE_STEPS} "
        f"synchronised steps); device {device_ms:.2f} ms and {ops} ops a "
        f"step (torch.profiler, 5 steps), idle share {idle:.3f}; launches "
        f"{counts}")
    log(f"[cli joint_baseline rate] the step's device time by kernel "
        f"(torch.profiler, 3 steps, {traced_ms:.2f} ms a step traced): "
        + "; ".join(f"{name[:70]} {ms:.3f} ms ({share:.1%})"
                    for name, ms, share in rows))
    return counts


def cli_joint_baseline(work: pathlib.Path, common, dev):
    """Phase 12(d): demo then eval --model joint_baseline, and the train
    step's rate."""
    jb = ["--model", "joint_baseline", *common, "--work_dir", str(work / "jb")]
    out, seconds, counts = run_cli("joint_baseline demo",
                                   ["demo", *jb, "--max_steps",
                                    str(CLI_STEPS)])
    batches = CLI_FRAMES // CLI_B
    check_launches("joint_baseline demo", counts,
                   fps=2 * (CLI_STEPS + batches),
                   ball_query_group=2 * (CLI_STEPS + batches))
    res = json.loads(out.split("joint_baseline:")[1].strip())
    if not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"[cli joint_baseline demo] {res}")
    paths = {"cli joint_baseline demo": counts}
    out, seconds, counts = run_cli("joint_baseline eval",
                                   ["eval", "--synthetic", *jb])
    check_launches("joint_baseline eval", counts, fps=2 * batches,
                   ball_query_group=2 * batches)
    with open(work / "jb" / "joint_baseline_eval.json") as f:
        saved = json.load(f)
    if f'"resumed_step": {CLI_STEPS}.0' not in out or set(saved) != {
            "joint_axis_err_deg", "joint_offset_err", "n_joints_evaluated"}:
        raise AssertionError(f"[cli joint_baseline eval] {out} {saved}")
    log(f"[cli joint_baseline] demo {CLI_STEPS} steps + eval of "
        f"{CLI_FRAMES} frames, then eval alone ({seconds:.2f} s): "
        f"joint_baseline_eval.json written, every value finite")
    paths["cli joint_baseline eval"] = counts
    paths["cli joint_baseline rate"] = joint_baseline_rate(dev)
    return paths


def pose_knobs(dev):
    """Phase 12(e): the four pose-fit knobs on phase 3's oracle frames,
    within phase 3's bounds; batch_joints=True against the loop on the
    same draws.  use_gt_association runs on frames whose joint head
    misleads: it gives part 0's points (which predict the x axis) to
    joint 1 and part 1's to joint 2, so that the head's vote for joint 1
    is x and the GT labels' is z; the knob's fit must keep phase 3's
    bounds and differ from the fit without it."""
    import dataclasses

    import torch

    from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                          PoseFitConfig,
                                                          fit_frame_batch)

    K = 3
    P, pred, (gR, gs, gt) = articulated_frames(np.random.RandomState(1),
                                               ORACLE_FRAMES, N_POINTS, K)
    labels = pred["index_per_point"].argmax(-1)           # GT joint labels
    misled = dict(pred)
    misled["index_per_point"] = np.eye(K, dtype=np.float32)[
        np.where(labels == 0, 1, 2)]
    misled["joint_axis_per_point"] = pred["joint_axis_per_point"].copy()
    misled["joint_axis_per_point"][labels == 0] = [1.0, 0.0, 0.0]

    def on_card(p):
        return {k: torch.from_numpy(v).to(dev) for k, v in p.items()}

    pred, misled = on_card(pred), on_card(misled)
    P = torch.from_numpy(P).to(dev)
    jc = torch.from_numpy(labels).to(dev)
    base = PoseFitConfig(n_parts=K, joint_types=("revolute", "revolute"))
    draws = PoseDraws.sample(ORACLE_FRAMES, base,
                             torch.Generator(device=dev).manual_seed(0), dev)
    fits = {}
    for name, knob, frame_pred, within in (
            ("use_gt_association=True", dict(use_gt_association=True),
             misled, True),
            ("head association", {}, misled, False),
            ("axis_agg=mean", dict(axis_agg="mean"), pred, True),
            ("batch_joints=True", dict(batch_joints=True), pred, True),
            ("hypo_estimator=lm", dict(hypo_estimator="lm"), pred, True),
            ("loop", {}, pred, True)):
        cfg = dataclasses.replace(base, **knob)
        t0 = time.perf_counter()
        out = fit_frame_batch(frame_pred, P, draws, cfg, joint_cls_gt=jc)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        seconds = time.perf_counter() - t0
        fits[name] = out
        rot = rot_err_deg(out["nonlinear_R"], gR)
        s_rel = np.abs(out["nonlinear_s"] - gs) / gs
        t_err = np.abs(out["nonlinear_t"] - gt).max(-1)
        if within and not (rot.max() < 3.0 and s_rel.max() < 0.05
                           and t_err.max() < 0.05):
            raise AssertionError(f"[pose knobs] {name}: rot {rot.max()}, "
                                 f"scale {s_rel.max()}, trans {t_err.max()}")
        log(f"[pose knobs] {name}"
            f"{' (misled head)' if frame_pred is misled else ''}: max rot "
            f"err {rot.max():.4f} deg, scale rel {s_rel.max():.2e}, trans "
            f"{t_err.max():.2e} ({seconds:.3f} s, B={ORACLE_FRAMES} "
            f"N={N_POINTS} K={K})")
    gt_fit, head_fit = fits["use_gt_association=True"], fits["head association"]
    moved = float(np.abs(gt_fit["nonlinear_R"] - head_fit["nonlinear_R"]).max())
    if not moved:
        raise AssertionError("[pose knobs] use_gt_association: the GT labels "
                             "did not move the fit")
    log(f"[pose knobs] use_gt_association against the head's association on "
        f"the misled frames: nonlinear_R moved by {moved:.3f} at most")
    loop, batched = fits["loop"], fits["batch_joints=True"]
    devs = {k: float(np.abs(loop[k] - batched[k]).max()) for k in loop}
    if max(devs.values()) > 1e-5:
        raise AssertionError(f"[pose knobs] batch_joints against the loop: "
                             f"{devs}")
    log(f"[pose knobs] batch_joints=True against the loop, same draws: "
        f"{'bit for bit' if not max(devs.values()) else devs}")


def cli_hdf5(work: pathlib.Path, common):
    """Phase 12(f): the reference-format path.  With h5py: export_hdf5 ->
    train --data_root (3 steps) -> test -> eval --from_pred.  Without
    it: `test --data_root` raises ImportError naming h5py."""
    from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated

    root, h5work = work / "h5data", work / "h5work"
    data = ["--data_root", str(root), "--work_dir", str(h5work)]
    try:
        import h5py  # noqa: F401
    except ImportError:
        try:
            run_cli("test --data_root", ["test", *common, *data])
        except ImportError as e:
            if "h5py" not in str(e):
                raise
            log(f"[cli hdf5] h5py does not import here: `test --data_root` "
                f"raises ImportError({str(e)!r}), as it should")
            return {}
        raise AssertionError("[cli hdf5] test --data_root ran without h5py")
    SyntheticArticulated(n_parts=3, points_per_part=400, seed=0).export_hdf5(
        str(root), "eyeglasses", n_instances=4, frames_per_instance=8)
    paths = {}
    _, _, paths["cli train --data_root"] = run_cli(
        "train --data_root", ["train", *common, *data, "--max_steps", "3"])
    _, _, paths["cli test --data_root"] = run_cli(
        "test --data_root", ["test", *common, *data])
    _, _, paths["cli eval --from_pred"] = run_cli(
        "eval --from_pred", ["eval", "--from_pred",
                             str(h5work / "test_pred"), *common,
                             "--work_dir", str(h5work)])
    check_report("eval --from_pred", h5work / "eval_from_pred_all.json")
    return paths


def cli_path(dev):
    """Phase 12: the command line (`python -m articulated_pose_tpu_torch`)
    in this process through main(argv), on the card.  Returns each
    sub-path's launch counts."""
    import tempfile

    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        # every command's shape flags; the work dir is each one's own
        common = ["--item", "eyeglasses", "--batch_size", str(CLI_B),
                  "--num_points", str(CLI_N), "--synthetic_frames",
                  str(CLI_FRAMES), "--device", str(dev)]
        paths.update(cli_demo_eval(work, common))
        paths.update(cli_serve(work, common, dev))
        paths.update(cli_joint_baseline(work, common, dev))
        pose_knobs(dev)
        paths.update(cli_hdf5(work, common))
    return paths


# --------------------------------------------------------------- phase 13
# the kernels that the models (models/pointnet2.py's names) and the
# timing tools call, as phase 13-16's paths call them
HELD_KERNELS = ("fps", "fps2", "ball_query_group", "ball_query_group_packed",
                "three_nn", "ball_query_point", "joint_fit")


@contextlib.contextmanager
def held_to_plain(label: str):
    """Within the block, each call of a kernel of HELD_KERNELS, by the
    models or through its module (`fps.fps(...)`, as `profile_stages` and
    `roofline` call them), also runs the kernel's plain version on the
    same inputs and raises unless they agree: 3-NN's indices equal and
    its distances within 1e-6 relative (phase 2's bound), every other
    output equal.  Yields {kernel: the shapes held}.  Launches made in
    the block belong to no path: run it outside a path's counted run.
    A replayed program (`compiled.py`) runs no Python, so it holds
    nothing: hold a program's first call at a shape, which runs it."""
    import torch

    from articulated_pose_tpu_torch.models import pointnet2
    from articulated_pose_tpu_torch.ops.kernels import (ball_query, fps,
                                                        joint_fit, three_nn)
    from articulated_pose_tpu_torch.pose import pipeline

    plain = {"fps": fps.fps_plain, "fps2": fps.fps2_plain,
             "joint_fit": pipeline.joint_fit_plain,
             "ball_query_group": ball_query.ball_query_group_plain,
             "ball_query_group_packed":
                 ball_query.ball_query_group_packed_plain,
             "three_nn": three_nn.three_nn_plain,
             "ball_query_point": ball_query.ball_query_point_plain}
    held = {}

    def checked(name, kernel):
        def call(*args, **kwargs):
            got = kernel(*args, **kwargs)
            if torch.cuda.is_current_stream_capturing():
                # a program's capture (compiled.py) queues the kernel and
                # runs nothing; its first run, just before, was held
                return got
            want = plain[name](*args, **kwargs)
            shape = " ".join(
                "x".join(map(str, a.shape)) if torch.is_tensor(a) else str(a)
                for a in args if not hasattr(a, "hypo_estimator"))
            if name == "three_nn":
                check_equal(f"[{label}] three_nn {shape} indices", got[1:],
                            want[1:])
                rel = ((got[0] - want[0]).abs()
                       / want[0].abs().clamp_min(1e-30)).max().item()
                if rel > 1e-6:
                    raise AssertionError(f"[{label}] three_nn {shape}: "
                                         f"distances off by {rel} relative")
            else:
                check_equal(f"[{label}] {name} {shape}",
                            [t for t in got if t is not None],
                            [t for t in want if t is not None])
            held.setdefault(name, set()).add(shape)
            return got
        return call

    kept = {(mod, name): getattr(mod, name)
            for mod in (pointnet2, fps, ball_query, three_nn, joint_fit,
                        pipeline)
            for name in HELD_KERNELS if hasattr(mod, name)}
    for (mod, name), fn in kept.items():
        setattr(mod, name, checked(name, fn))
    try:
        yield held
    finally:
        for (mod, name), fn in kept.items():
            setattr(mod, name, fn)


def log_held(label: str, held, counts) -> None:
    """Print what `held_to_plain` held; raise unless it held every kernel
    that the path's counted run (`counts`) launched."""
    missed = sorted(k for k, n in counts.items() if n and k not in held)
    if missed:
        raise AssertionError(f"[{label}] {missed} launched on the path but "
                             "never held against the plain version")
    log(f"[{label}] each kernel call held against its plain version on the "
        f"same inputs (3-NN distances within 1e-6 relative, all else "
        f"equal): " + "; ".join(f"{k} at {sorted(v)}"
                                for k, v in sorted(held.items())))


def equal_results(label: str, got, want) -> None:
    """Raise unless two PoseResults are equal, field by field."""
    for f in ("R", "scale", "t", "segmentation", "part_counts"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"[{label}] {f} differs")
    for k in want.raw:
        if not np.array_equal(got.raw[k], want.raw[k]):
            raise AssertionError(f"[{label}] raw {k} differs")


def sharded_serve(label, cfg, state, clouds, dev, per_batch):
    """Phase 13(a, b) for one configuration: a data=1 mesh against the
    unsharded predictor, then data=2 on [dev, dev], each shard against
    the unsharded predictor on its rows with its draws; three calls of
    each, timed.  Returns the data=2 path's launch counts."""
    import torch

    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.parallel.mesh import make_mesh
    from articulated_pose_tpu_torch.serving import PosePredictor

    plain = PosePredictor(cfg, state_dict=state, device=dev)
    one = PosePredictor(cfg, state_dict=state,
                        mesh=make_mesh("data=1", devices=[dev]))
    equal_results(f"{label} data=1", one(clouds), plain(clouds))
    two = PosePredictor(cfg, state_dict=state,
                        mesh=make_mesh("data=2", devices=[dev, dev]))
    with held_to_plain(f"mesh {label} data=2") as held:
        two(clouds)
    reset_launch_counts()
    got = two(clouds)
    counts = launch_counts()
    log_held(f"mesh {label} data=2", held, counts)
    want = expected_launches(**{k: 2 * v for k, v in per_batch.items()})
    if counts != want:
        raise AssertionError(f"[{label} data=2] launches {counts}, expected "
                             f"{want}")
    half = len(clouds) // 2
    for shard in range(2):
        rows = slice(shard * half, (shard + 1) * half)
        want_shard = plain(clouds[rows], draws=two.draws(half, shard))
        part = type(got)(**{f: getattr(got, f)[rows] for f in (
            "R", "scale", "t", "segmentation", "part_counts")},
            raw={k: v[rows] for k, v in got.raw.items()})
        equal_results(f"{label} data=2 shard {shard}", part, want_shard)
    rates = {}
    for name, pred in (("unsharded", plain), ("data=2", two)):
        pred(clouds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            pred(clouds)
        rates[name] = 3 * len(clouds) / (time.perf_counter() - t0)
    log(f"[mesh {label}] B={len(clouds)}: data=1 equal to the unsharded "
        f"predictor; data=2 on [{dev}, {dev}]: each shard of {half} equal "
        f"to the unsharded predictor on its rows with its draws; "
        f"{rates['data=2']:.1f} clouds/s sharded, {rates['unsharded']:.1f} "
        f"unsharded (host clock, 3 calls each after one); launches {counts}")
    return counts


def mesh_cli(dev):
    """Phase 13(c): serve --mesh data=1 through main(argv) equal to plain
    serve on one checkpoint; --mesh data=2 raises JAX's ValueError when
    the host has one card."""
    import tempfile

    import torch

    from articulated_pose_tpu_torch import main as cli
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.train.state import TrainState
    from articulated_pose_tpu_torch.train.trainer import Checkpointer

    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        common = ["--item", "eyeglasses", "--batch_size", str(CLI_B),
                  "--num_points", str(CLI_N), "--device", str(dev),
                  "--work_dir", str(work)]
        cfg, _ = cli.build_config(cli.parse_args(["serve", *common]))
        model = build_model(cfg, torch.Generator().manual_seed(3))
        Checkpointer(str(work / "model")).save(0, TrainState(model, cfg))
        clouds = stack(train_frames(cfg, CLI_SERVE_CLOUDS, seed=8))["P"]
        np.save(work / "clouds.npy", clouds)
        with held_to_plain("mesh cli serve --mesh data=1") as held:
            run_cli("serve --mesh data=1, kernels held", [
                "serve", *common, "--input", str(work / "clouds.npy"),
                "--output", str(work / "held.npz"), "--mesh", "data=1"])
        outs, paths = {}, {}
        for label, extra in (("serve", []), ("serve --mesh data=1",
                                             ["--mesh", "data=1"])):
            out_npz = work / f"{len(outs)}.npz"
            out, seconds, counts = run_cli(label, [
                "serve", *common, "--input", str(work / "clouds.npy"),
                "--output", str(out_npz), *extra])
            batches = -(-CLI_SERVE_CLOUDS // CLI_B)
            check_launches(label, counts, fps2=batches,
                           ball_query_group=2 * batches, three_nn=2 * batches,
                           joint_fit=batches)
            outs[label] = dict(np.load(out_npz))
            paths[f"mesh cli {label}"] = counts
        log_held("mesh cli serve --mesh data=1", held,
                 paths["mesh cli serve --mesh data=1"])
        last = out.strip().splitlines()[-1]
        if "mesh=data=1" not in last:
            raise AssertionError(f"[cli serve --mesh] last line {last!r}")
        a, b = outs["serve"], outs["serve --mesh data=1"]
        if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k])
                                           for k in a):
            raise AssertionError("serve --mesh data=1 differs from serve")
        cards = torch.cuda.device_count()
        if cards == 1:
            want = "mesh spec 'data=2' needs 2 devices, have 1"
            try:
                run_cli("serve --mesh data=2", [
                    "serve", *common, "--input", str(work / "clouds.npy"),
                    "--mesh", "data=2"])
            except ValueError as e:
                if str(e) != want:
                    raise AssertionError(f"serve --mesh data=2: {e!r}, "
                                         f"expected {want!r}") from e
            else:
                raise AssertionError("serve --mesh data=2 ran on one card")
    log(f"[mesh cli] serve --mesh data=1: poses.npz equal to serve's "
        f"({sorted(a)}); --mesh data=2 on {cards} card(s): "
        + ("JAX's ValueError" if cards == 1 else "not tried"))
    return paths


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def mesh_train_setup(dev, worlds: int = 1, steps: int = MESH_TRAIN_STEPS):
    """Phase 13(d)'s configuration (cfg/network_config.yml, f32, dropout
    off), model and `worlds` lists of `steps` batches, after checking the
    card's compute mode."""
    import torch

    from articulated_pose_tpu_torch.config import load_config
    from articulated_pose_tpu_torch.models.ancsh import build_model

    mode = compute_mode()
    log(f"[mesh train] compute mode {mode}")
    if mode != "Default":
        raise AssertionError(f"compute mode {mode!r}: the ranks need a "
                             "context each on the one card")
    cfg = load_config(str(ROOT / "cfg" / "network_config.yml")).replace(
        compute_dtype="float32", dropout_rate=0.0)
    model = build_model(cfg, torch.Generator().manual_seed(4))
    model.joint_net.dropout_rate = 0.0
    batches = [[stack(train_frames(cfg, TRAIN_B, seed=20 + w * steps + s))
                for s in range(steps)] for w in range(worlds)]
    return cfg, model, batches


def mesh_world(spec, cfg, model, batches, dev):
    """One world of `spec` over gloo, every rank on `dev`, on `batches`:
    each step against the single-process step on the card from the
    world's own state before it, with the world's routing imposed
    (`launch.single_rank_deviations`).  Returns (the ranks' results,
    each step's deviations, the world's seconds); raises if the ranks
    disagree or a gradient is not finite."""
    from articulated_pose_tpu_torch.parallel.launch import (
        TrainJob, run_ranks, single_rank_deviations, train_job)

    devices = [str(dev)] * (2 if spec == "data=2" else 4)
    job = TrainJob(mesh=spec, devices=devices, config=cfg, model=model,
                   batches=batches, capture=True)
    t0 = time.perf_counter()
    out = run_ranks(train_job, job, devices, timeout=300.0)
    seconds = time.perf_counter() - t0
    for r in out[1:]:
        if r["metrics"] != out[0]["metrics"]:
            raise AssertionError(f"[mesh train {spec}] ranks disagree")
    if not all(m["grads_finite"] for m in out[0]["metrics"]):
        raise AssertionError(f"[mesh train {spec}] non-finite gradients")
    return job, out, single_rank_deviations(job, out, dev), seconds


def step_text(devs) -> str:
    from articulated_pose_tpu_torch.parallel.launch import BOUNDS

    return "; ".join(
        f"{s + 1}: " + ", ".join(f"{k} {d[k]:.2e}" for k in BOUNDS)
        + f" (worst leaf {d['worst_leaf']}; the single process's own "
        f"choices differ at {d['flips']} ReLU or max and "
        f"{d['heatmap_flips']} heatmap sign(s))"
        for s, d in enumerate(devs))


def outside(devs) -> bool:
    from articulated_pose_tpu_torch.parallel.launch import BOUNDS

    return any(d[k] > bound for d in devs for k, bound in BOUNDS.items())


def without_heatmap_signs(job, out, dev):
    """The world's steps held as `single_rank_deviations` holds them but
    with the heatmap residuals' signs left to the single process."""
    from articulated_pose_tpu_torch.parallel.launch import \
        single_rank_deviations
    from articulated_pose_tpu_torch.train.routing import HEATMAP

    stripped = [dict(r, routing=[{k: v for k, v in step.items()
                                  if k != HEATMAP} for step in r["routing"]])
                for r in out]
    return single_rank_deviations(job, stripped, dev)


def mesh_train(dev):
    """Phase 13(d): the sharded train step over gloo, every rank on the
    card, each step held to `launch.BOUNDS`; the shards' kernels held
    against their plain versions first.  Returns each world's launch
    counts (summed over its ranks)."""
    import copy

    import torch

    from articulated_pose_tpu_torch.parallel.launch import BOUNDS
    from articulated_pose_tpu_torch.train.state import (TrainState,
                                                        forward_loss,
                                                        to_device,
                                                        train_step)

    cfg, model, (batches,) = mesh_train_setup(dev)
    # the kernels of each data shard's forward (B=8; the kernels' inputs
    # are the clouds alone, so 'model' does not change them)
    probe = TrainState(copy.deepcopy(model).to(dev), cfg)
    half = TRAIN_B // 2
    with held_to_plain("mesh train shards") as held, torch.no_grad():
        for b in batches:
            for rows in (slice(0, half), slice(half, TRAIN_B)):
                forward_loss(probe, to_device(
                    {k: v[rows] for k, v in b.items()}, dev), train=True)
    # the single process's step time on the same batches
    single = TrainState(copy.deepcopy(model).to(dev), cfg)
    on_card = [to_device(b, dev) for b in batches]
    train_step(single, on_card[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in on_card[1:]:
        train_step(single, b)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3 / (len(on_card) - 1)
    paths = {}
    for spec in MESH_WORLDS:
        world = 2 if spec == "data=2" else 4
        _, out, devs, seconds = mesh_world(spec, cfg, model, batches, dev)
        launches = {k: sum(r["launches"][k] for r in out)
                    for k in out[0]["launches"]}
        ms = np.mean([r["ms"][1:] for r in out])
        log(f"[mesh train {spec}] ranks on {[r['device'] for r in out]}; "
            f"rank 0's sharded weights {out[0]['sharded']}; against the "
            f"single-process step from the world's state, its routing "
            f"imposed, step by step: {step_text(devs)} (bounds {BOUNDS}); "
            f"{ms:.2f} ms a step (ranks' host clock, steps "
            f"2-{MESH_TRAIN_STEPS}, routing capture on; single process "
            f"{single_ms:.2f}); world {seconds:.1f} s; launches (all ranks) "
            f"{launches}")
        if outside(devs):
            raise AssertionError(f"[mesh train {spec}] outside its bounds")
        want = expected_launches(fps2=world * MESH_TRAIN_STEPS,
                                 ball_query_group=2 * world * MESH_TRAIN_STEPS,
                                 three_nn=2 * world * MESH_TRAIN_STEPS)
        if launches != want:
            raise AssertionError(f"[mesh train {spec}] launches {launches}, "
                                 f"expected {want}")
        log_held(f"mesh train {spec}", held, launches)
        paths[f"mesh train {spec}"] = launches
    return paths


def mesh_soak(dev, worlds: int, steps: int) -> int:
    """`--soak`: `worlds` worlds of each mesh of MESH_WORLDS, `steps`
    steps each, each step held as phase 13(d) holds it; a step where the
    heatmap's signs differed is also held without them imposed.  Returns
    the exit code: 1 if any step left its bounds."""
    from articulated_pose_tpu_torch.parallel.launch import BOUNDS

    cfg, model, batches = mesh_train_setup(dev, worlds, steps)
    worst = {spec: {k: 0.0 for k in BOUNDS} for spec in MESH_WORLDS}
    failed, flipped = [], 0
    for w in range(worlds):
        for spec in MESH_WORLDS:
            job, out, devs, seconds = mesh_world(spec, cfg, model,
                                                 batches[w], dev)
            log(f"[soak {spec} world {w + 1}] {seconds:.1f} s; "
                f"{step_text(devs)}")
            for d in devs:
                for k in BOUNDS:
                    worst[spec][k] = max(worst[spec][k], d[k])
            if outside(devs):
                failed.append(f"{spec} world {w + 1}")
            if any(d["heatmap_flips"] for d in devs):
                flipped += sum(1 for d in devs if d["heatmap_flips"])
                log(f"[soak {spec} world {w + 1}] the same steps without "
                    f"the heatmap's signs imposed: "
                    f"{step_text(without_heatmap_signs(job, out, dev))}")
    log(f"[soak] {worlds} worlds of each of {list(MESH_WORLDS)}, {steps} "
        f"steps each: {flipped} step(s) with a heatmap sign that the single "
        f"process takes otherwise; the largest deviations {worst} (bounds "
        f"{BOUNDS}); outside the bounds: {failed or 'none'}")
    return 1 if failed else 0


def more_picks_than_points(dev):
    """Phase 13(e): R6.  `fps` and `fps2` with more picks than points,
    equal to the plain versions; then the joint baseline's train step at
    N=256.  Returns its launch counts."""
    import tempfile

    import torch

    from articulated_pose_tpu_torch.config import load_config
    from articulated_pose_tpu_torch.ops.kernels import (fps, launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.train.joint_baseline import \
        JointBaselineTrainer
    from articulated_pose_tpu_torch.train.state import to_device

    rng = np.random.RandomState(13)
    for N in R6_N:
        xyz = torch.from_numpy(rng.rand(4, N, 3).astype(np.float32)).to(dev)
        got = fps.fps(xyz, 512)
        check_equal(f"fps N{N}->512", got, fps.fps_plain(xyz, 512))
        got2 = fps.fps2(xyz, 512, 128)
        check_equal(f"fps2 N{N}->512->128", got2,
                    fps.fps2_plain(xyz, 512, 128))
        if not (got[0][:, N:] == 0).all():
            raise AssertionError(f"fps N{N}: a pick past N is not 0")
    cfg = load_config(category="eyeglasses", n_max_parts=3,
                      batch_size=CLI_B, num_points=R6_JB_N)
    with tempfile.TemporaryDirectory() as work:
        tr = JointBaselineTrainer(cfg, work, device=dev)
        batch = to_device(stack(train_frames(cfg, CLI_B, seed=9)), dev)
        with held_to_plain("mesh R6 joint baseline") as held:
            losses = [float(tr.train_step(batch)["total_loss"])]
        reset_launch_counts()
        losses += [float(tr.train_step(batch)["total_loss"])
                   for _ in range(R6_JB_STEPS)]
        counts = launch_counts()
    check_launches("joint_baseline N=256", counts, fps=2 * R6_JB_STEPS,
                   ball_query_group=2 * R6_JB_STEPS)
    log_held("mesh R6 joint baseline", held, counts)
    if not np.isfinite(losses).all():
        raise AssertionError(f"joint baseline at N={R6_JB_N}: {losses}")
    log(f"[mesh R6] fps and fps2 at N {R6_N} with 512 (and 512 -> 128) "
        f"picks: equal to the plain versions, picks past N index 0; joint "
        f"baseline B={CLI_B} N={R6_JB_N} (SA1 picks 512): 1 + {R6_JB_STEPS} "
        f"steps, losses {', '.join(f'{x:.4f}' for x in losses)}; launches "
        f"{counts}")
    return counts


def mesh_path(dev):
    """Phase 13: the device mesh.  Returns each sub-path's launch
    counts."""
    import torch

    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model

    cfg = NetworkConfig(category="eyeglasses", n_max_parts=3,
                        num_points=N_POINTS, batch_size=SERVE_BATCH)
    state = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    clouds, _, _ = articulated_frames(np.random.RandomState(12),
                                      PACKED_BATCH, N_POINTS, 3)
    paths = {"mesh serve f32": sharded_serve(
        "serve f32", cfg, state, clouds[:SERVE_BATCH], dev,
        dict(fps2=1, ball_query_group=2, three_nn=2, joint_fit=1))}
    packed = cfg.replace(compute_dtype="bfloat16", ball_query_packed=True,
                         batch_size=PACKED_BATCH)
    paths["mesh serve packed bf16"] = sharded_serve(
        "serve packed bf16", packed, state, clouds, dev,
        dict(fps2=1, ball_query_group_packed=2, three_nn=2, joint_fit=1))
    paths.update(mesh_cli(dev))
    paths.update(mesh_train(dev))
    paths["mesh R6 joint baseline"] = more_picks_than_points(dev)
    return paths


# --------------------------------------------------------------- phase 14
REF_CLOUD_SEED = 7                  # tests/test_ckpt_parity.py's cloud
REF_CKPT_SEED = 1                   # and checkpoint
REF_BOUND = 2e-4                    # tests/test_ckpt_parity.py's bound
REF_SERVE_B = 16
REF_SERVE_N = 1024                  # cfg/network_config.yml's num_points
REF_SERVE_REQUESTS = 3
ASSET_VIEWS = 16
ASSET_IMAGE = 160
ASSET_SAMPLES = 30000               # mesh samples a part and view
ASSET_BOUND = 1e-5
# a two-part Shape2Motion tree (tests/test_tools.py's form): a lid on a
# base, hinged along x at the base's back edge
ASSET_MOTION = {
    "dof_name": "dof_rootd", "center": [0, 0, 0],
    "children": [{"dof_name": "dof_1", "center": [0.0, 0.2, 0.02],
                  "direction": [1, 0, 0], "motion_type": "rotation",
                  "children": None}]}
ASSET_BOXES = (((-0.3, -0.2, -0.02), (0.3, 0.2, 0.02)),        # base
               ((-0.3, -0.2, 0.02), (0.3, 0.2, 0.06)))         # lid


def box_mesh(lo, hi):
    """The 8 vertices and 12 triangles of an axis-aligned box."""
    v = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                  for z in (lo[2], hi[2])], np.float64)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]])
    return v, f


def gl_camera(azimuth: float, elevation: float, dist: float, target,
              fov: float = 60.0, near: float = 0.1, far: float = 10.0):
    """An OpenGL look-at view matrix (world -> camera, the camera looking
    down -z) and perspective projection."""
    target = np.asarray(target, np.float64)
    eye = target + dist * np.array([np.cos(elevation) * np.cos(azimuth),
                                    np.cos(elevation) * np.sin(azimuth),
                                    np.sin(elevation)])
    f = (target - eye) / np.linalg.norm(target - eye)
    s = np.cross(f, [0.0, 0.0, 1.0])
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[:3, 3] = -view[:3, :3] @ eye
    c = 1.0 / np.tan(np.radians(fov) / 2)
    proj = np.array([[c, 0, 0, 0], [0, c, 0, 0],
                     [0, 0, (far + near) / (near - far),
                      2 * far * near / (near - far)], [0, 0, -1, 0]])
    return view, proj


def zbuffer(parts_world, view, proj, size: int):
    """Depth and label images of per-part world points: each point goes
    to the pixel nearest its projection and each pixel keeps the nearest
    point.  A kept point is moved onto its pixel's ray at its own depth,
    so the back-projection must recover it exactly (the image grid's
    quantisation is not what the round trip measures).  Returns (depth
    (the camera z, negative ahead), label (-1: background), the kept
    points in the world frame, by part, in the preprocessor's
    row-major pixel order)."""
    H = W = size
    pts = np.concatenate(parts_world)
    part = np.concatenate([np.full(len(p), j) for j, p in
                           enumerate(parts_world)])
    cam = pts @ view[:3, :3].T + view[:3, 3]
    clip = cam @ proj[:, :3].T + proj[:, 3]
    col = np.rint((clip[:, 0] / clip[:, 3] + 1.0) * W / 2).astype(np.int64)
    row = np.rint(H - (clip[:, 1] / clip[:, 3] + 1.0) * H / 2).astype(np.int64)
    ok = (cam[:, 2] < 0) & (col >= 0) & (col < W) & (row >= 0) & (row < H)
    pix = (row * W + col)[ok]
    z = cam[ok, 2]
    order = np.lexsort((-z, pix))                # nearest first a pixel
    _, first = np.unique(pix[order], return_index=True)
    keep = order[first]
    pix, z, part = pix[keep], z[keep], part[ok][keep]
    depth = np.zeros(H * W)
    label = np.full(H * W, -1)
    depth[pix], label[pix] = z, part
    r, c = pix // W, pix % W
    u, v = c * 2.0 / W - 1.0, (H - r) * 2.0 / H - 1.0
    x = (u * -z - proj[0, 2] * z) / proj[0, 0]
    y = (v * -z - proj[1, 2] * z) / proj[1, 1]
    world = (np.stack([x, y, z], 1) - view[:3, 3]) @ view[:3, :3]
    return (depth.reshape(H, W), label.reshape(H, W),
            [world[part == j] for j in range(len(parts_world))])


def asset_frames(tmp: str, views: int = ASSET_VIEWS, num_points: int = 1024,
                 size: int = ASSET_IMAGE, n_max_parts: int = 3):
    """Phase 14(b) on the host: a Shape2Motion JSON and OBJ parts ->
    motion_json.write_urdf -> urdf.parse_urdf -> urdf_to_joint_specs and
    norm_info_from_objs -> sample_mesh_points per part at the part's
    articulated pose -> a depth and label image (`zbuffer`) a view ->
    preprocess_frame -> labeling.build_sample.  Returns (the frames
    stacked, the largest distance between a recovered canonical point
    and the point it came from)."""
    import os

    from articulated_pose_tpu_torch.data.labeling import build_sample
    from articulated_pose_tpu_torch.data.synthetic import sample_mesh_points
    from articulated_pose_tpu_torch.tools import motion_json, preprocess, urdf
    from articulated_pose_tpu_torch.utils import transforms as tr

    os.makedirs(os.path.join(tmp, "part_objs"), exist_ok=True)
    model = motion_json.parse_motion_json(ASSET_MOTION)
    meshes = [box_mesh(*b) for b in ASSET_BOXES]
    for link, (v, f) in zip(model.links, meshes):
        name = "none_motion" if link.parent is None else link.name
        with open(os.path.join(tmp, "part_objs", f"{name}.obj"), "w") as fh:
            fh.write("".join(f"v {a:.17g} {b:.17g} {c:.17g}\n"
                             for a, b, c in v))
            fh.write("".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f))
    syn = motion_json.write_urdf(model, tmp, obj_dir=tmp)[0]
    parsed = urdf.parse_urdf(syn)
    joints = urdf.urdf_to_joint_specs(parsed)
    norm = urdf.norm_info_from_objs(parsed["obj_name"])
    (joint,) = joints
    if not (np.allclose(joint.position, model.joints[0].position)
            and np.allclose(joint.axis, model.joints[0].axis)
            and joint.jtype == "revolute"):
        raise AssertionError(f"URDF joint {joint} is not the JSON's "
                             f"{model.joints[0]}")
    rng = np.random.RandomState(14)
    frames, worst = [], 0.0
    for k in range(views):
        angle = rng.uniform(0.3, 1.2)
        m2w = [np.eye(4), tr.rotation_about_line(joint.axis, joint.position,
                                                 angle)]
        canon = [sample_mesh_points(v, f, ASSET_SAMPLES, rng)
                 for v, f in meshes]
        world = [tr.apply_similarity(T, c) for T, c in zip(m2w, canon)]
        view, proj = gl_camera(2 * np.pi * k / views + 0.3,
                               rng.uniform(0.4, 0.8), 1.2, (0, 0, 0.03))
        depth, label, kept = zbuffer(world, view, proj, size)
        # camera_to_world negates the camera point (the reference's sign
        # convention, tools/preprocess_data.py:299-303): hand it the view
        # matrix that maps the world to the negated camera frame
        flip = np.diag([-1.0, -1.0, -1.0, 1.0])
        out = preprocess.preprocess_frame(depth, label, proj, flip @ view,
                                          m2w, len(meshes))
        if out is None:
            raise AssertionError(f"view {k}: a part has too few pixels")
        parts_cam, parts_canon = out
        for T, got, want in zip(m2w, parts_canon, kept):
            want = tr.apply_similarity(np.linalg.inv(T), want)
            worst = max(worst, float(np.abs(got - want).max()))
        frames.append(build_sample(parts_cam, parts_canon, joints, norm,
                                   num_points=num_points,
                                   n_max_parts=n_max_parts,
                                   rng=np.random.RandomState(k)))
    return {key: np.stack([f[key] for f in frames]) for key in frames[0]}, worst


def fps_picks64(P: np.ndarray, npoint: int):
    """float64 FPS (ops/numpy_ref's rule) with each pick's running
    min-distances: (picks (B, npoint), mind (B, npoint, N) before each
    pick)."""
    B, N, _ = P.shape
    picks = np.zeros((B, npoint), np.int64)
    minds = np.zeros((B, npoint, N))
    mind = np.full((B, N), 1e38)
    for j in range(1, npoint):
        last = P[np.arange(B), picks[:, j - 1]]
        mind = np.minimum(mind, ((P - last[:, None]) ** 2).sum(-1))
        minds[:, j] = mind
        picks[:, j] = mind.argmax(1)
    return picks, minds


def oracle_picks(P: np.ndarray, dev) -> int:
    """The card's FPS picks, ball-query neighbourhoods and 3-NN
    neighbours on the reference path's levels against the float64 oracle
    (ops/numpy_ref) on the same points; every pick that differs is
    printed with its margin.  Returns how many differ."""
    import torch

    from articulated_pose_tpu_torch.ops import numpy_ref
    from articulated_pose_tpu_torch.ops.kernels.ball_query import \
        ball_query_group
    from articulated_pose_tpu_torch.ops.kernels.fps import fps2
    from articulated_pose_tpu_torch.ops.kernels.three_nn import three_nn

    x0 = torch.from_numpy(P).to(dev)
    i1, x1, i2, x2 = fps2(x0, 512, 128)
    levels = [P.astype(np.float64), x1.cpu().double().numpy(),
              x2.cpu().double().numpy()]
    differ = 0
    for lvl, (xyz, got, npoint) in enumerate(
            ((levels[0], i1, 512), (levels[1], i2, 128)), start=1):
        want, minds = fps_picks64(xyz, npoint)
        got = got.cpu().numpy()
        for b, j in zip(*np.nonzero(got != want)):
            m = minds[b, j]
            log(f"[ref ckpt] FPS level {lvl} cloud {b} pick {j}: card "
                f"{got[b, j]}, float64 {want[b, j]}, margin "
                f"{m[want[b, j]] - m[got[b, j]]:.3g} (min d2)")
        differ += int((got != want).sum())
    for lvl, (r, pts, q, qd) in enumerate(((0.2, x0, x1, levels[:2]),
                                           (0.4, x1, x2, levels[1:])),
                                          start=1):
        _, cnt, idx = ball_query_group(r, 64, pts, q)
        want_idx, want_cnt = numpy_ref.query_ball_point(r, 64, *qd)
        cnt, idx = cnt.cpu().numpy(), idx.cpu().numpy()
        for b, m in zip(*np.nonzero((cnt != want_cnt)
                                    | (idx != want_idx).any(-1))):
            a = set(idx[b, m, :cnt[b, m]])
            w = set(want_idx[b, m, :want_cnt[b, m]])
            d2 = ((qd[0][b, sorted(a ^ w)] - qd[1][b, m]) ** 2).sum(-1)
            log(f"[ref ckpt] SA{lvl} ball query cloud {b} query {m}: "
                f"points {sorted(a ^ w)} differ, |d2 - r2| "
                f"{np.abs(d2 - r * r).tolist()}")
            differ += 1
    for name, (a, b) in (("FP2", (x1, x2)), ("FP3", (x0, x1))):
        _, idx = three_nn(a, b)
        an, bn = a.cpu().double().numpy(), b.cpu().double().numpy()
        _, want = numpy_ref.three_nn(an, bn)
        idx = idx.cpu().numpy()
        for c, n in zip(*np.nonzero((idx != want).any(-1))):
            d2 = ((bn[c] - an[c, n]) ** 2).sum(-1)
            log(f"[ref ckpt] {name} 3-NN cloud {c} point {n}: card "
                f"{idx[c, n].tolist()} (d2 {d2[idx[c, n]].tolist()}), "
                f"float64 {want[c, n].tolist()} (d2 "
                f"{d2[want[c, n]].tolist()})")
            differ += 1
    log(f"[ref ckpt] picks of the card's kernels against the float64 "
        f"oracle on the parity cloud: {differ} differ (FPS 512 -> 128, "
        f"SA1/SA2 ball queries, FP2/FP3 3-NN)")
    return differ


def reference_checkpoint(dev, tmp: pathlib.Path):
    """Phase 14(a): the reference graph's TF1 checkpoint (synthetic,
    full width) as a bundle and as an npz -> the port's model on the
    card, every head within REF_BOUND of the float64 TF graph; then
    served, and held against the plain kernels.  Returns (the
    predictor, the served clouds, each sub-path's launch counts)."""
    import torch

    from articulated_pose_tpu_torch.config import load_config
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.serving import PosePredictor
    from articulated_pose_tpu_torch.timing import card_line
    from articulated_pose_tpu_torch.utils import (ref_forward, tf_bundle,
                                                  tf_ckpt)
    from articulated_pose_tpu_torch.utils.profiling import StepTimer

    ckpt = ref_forward.synth_reference_checkpoint(
        np.random.RandomState(REF_CKPT_SEED))
    prefix = str(tmp / "tf_model.ckpt-100000")
    tf_bundle.write_bundle(prefix, ckpt)
    np.savez(tmp / "ckpt.npz", **ckpt)
    cfg = load_config(str(ROOT / "cfg" / "network_config.yml"),
                      compute_dtype="float32")
    model = build_model(cfg, device=dev)
    loaded = {}
    for name, path in (("bundle", prefix), ("npz", str(tmp / "ckpt.npz"))):
        sentinel = {k: torch.full_like(v, float("nan"))
                    for k, v in model.state_dict().items()}
        sd, report = tf_ckpt.load_reference_weights(path, sentinel)
        left = [k for k, v in sd.items() if not torch.isfinite(v).all()]
        log(f"[ref ckpt] {name}: {len(report['mapped'])} of {len(ckpt)} "
            f"variables mapped, {len(report['unmapped'])} unmapped, "
            f"{len(report['mismatched'])} mismatched; {len(sd) - len(left)} "
            f"of {len(sd)} state_dict entries overwritten")
        if (report["unmapped"] or report["mismatched"] or left
                or len(report["mapped"]) != len(ckpt)):
            raise AssertionError(f"[ref ckpt] {name}: {report['unmapped']} "
                                 f"{report['mismatched']} {left}")
        loaded[name] = sd
    for k, v in loaded["bundle"].items():
        if not torch.equal(v, loaded["npz"][k]):
            raise AssertionError(f"[ref ckpt] bundle and npz differ at {k}")
    sd = loaded["bundle"]
    model.load_state_dict(sd)

    P = np.random.RandomState(REF_CLOUD_SEED).rand(
        2, REF_SERVE_N, 3).astype(np.float32)
    out, seconds, counts = forward_launches(
        "ref ckpt", model, torch.from_numpy(P).to(dev),
        expected_launches(fps2=1, ball_query_group=2, three_nn=2))
    paths = {"ref ckpt forward": counts}
    t0 = time.perf_counter()
    ref = ref_forward.reference_forward(ckpt, P)
    log(f"[ref ckpt] float64 reference_forward B=2 N={REF_SERVE_N} on the "
        f"host: {time.perf_counter() - t0:.1f} s")
    worst = {k: float(np.abs(out[k].double().cpu().numpy() - ref[k]).max())
             for k in sorted(ref)}
    log(f"[ref ckpt] card forward vs float64 TF graph, max abs diff per "
        f"head: {json.dumps(worst)} (bound {REF_BOUND})")
    oracle_picks(P, dev)
    if set(worst) != set(out) or max(worst.values()) > REF_BOUND:
        raise AssertionError("[ref ckpt] the card's forward left the "
                             "reference graph's bound")

    predictor = PosePredictor(cfg, state_dict=sd, device=dev)
    clouds, _, _ = articulated_frames(np.random.RandomState(14),
                                      REF_SERVE_REQUESTS * REF_SERVE_B,
                                      REF_SERVE_N, cfg.n_max_parts)
    timer = StepTimer()
    paths["ref ckpt serve"] = serve_requests(
        "ref ckpt serve", predictor, clouds, REF_SERVE_B,
        expected_launches(fps2=1, ball_query_group=2, three_nn=2,
                          joint_fit=1), timer)
    log(f"[ref ckpt serve] on {card_line()}")
    log(f"[ref ckpt serve] StepTimer: {json.dumps(timer.summary())}")
    # a fresh predictor's first call runs the program (later ones replay)
    with held_to_plain("ref ckpt") as held:
        PosePredictor(cfg, state_dict=sd, device=dev)(clouds[:REF_SERVE_B])
    log_held("ref ckpt", held, paths["ref ckpt serve"])
    return predictor, clouds, paths


def optional_imports(tmp: pathlib.Path) -> None:
    """Phase 14(b)5: get_pose and write_frame_h5 run where PyYAML and
    h5py import and raise ImportError naming them where they do not."""
    from articulated_pose_tpu_torch.tools import preprocess

    def yml():
        d = tmp / "render" / "cat" / "0001" / "0"
        d.mkdir(parents=True, exist_ok=True)
        import yaml
        (d / "gt.yml").write_text(yaml.safe_dump({"frame_0": {
            "viewMat": np.eye(4).reshape(-1).tolist(),
            "projMat": np.eye(4).reshape(-1).tolist(),
            "obj": [[0, 0, 0, 0, [0.1, 0.2, 0.3], [0.0, 0.0, 0.0, 1.0]]]}}))
        m2w, _, _ = preprocess.get_pose(str(tmp), "cat", "0001", "0", "0",
                                        num_parts=2)
        return np.allclose(m2w[1][:3, 3], [0.1, 0.2, 0.3])

    def h5():
        path = str(tmp / "h5" / "0.h5")
        preprocess.write_frame_h5(path, [np.zeros((4, 3))], [np.ones((4, 3))])
        import h5py
        with h5py.File(path) as f:
            return f["gt_coords"]["0"][()].sum() == 12

    for module, needs, fn in (("yaml", "PyYAML", yml), ("h5py", "h5py", h5)):
        try:
            importlib.import_module(module)
        except ImportError:
            try:
                fn()
            except ImportError as e:
                if needs not in str(e):
                    raise
                log(f"[assets] without {module}: ImportError naming {needs}"
                    f" ({e})")
                continue
            raise AssertionError(f"[assets] {fn.__name__} ran without "
                                 f"{module}")
        if not fn():
            raise AssertionError(f"[assets] {fn.__name__} read back wrong")
        log(f"[assets] with {module}: {fn.__name__} wrote and read back")


def asset_path(predictor, dev, tmp: pathlib.Path):
    """Phase 14(b): assets -> frames (`asset_frames`) -> the predictor
    of (a) on the card.  Returns the path's launch counts."""
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)

    t0 = time.perf_counter()
    frames, worst = asset_frames(str(tmp / "asset"), ASSET_VIEWS,
                                 predictor.config.num_points)
    log(f"[assets] JSON -> URDF -> {ASSET_VIEWS} depth images "
        f"{ASSET_IMAGE}x{ASSET_IMAGE} -> preprocess_frame -> build_sample: "
        f"canonical points within {worst:.3g} of their samples (bound "
        f"{ASSET_BOUND}); {time.perf_counter() - t0:.1f} s on the host")
    if not worst <= ASSET_BOUND:
        raise AssertionError("[assets] the back-projection left its bound")
    reset_launch_counts()
    res = predictor(frames["P"])
    counts = launch_counts()
    want = expected_launches(fps2=1, ball_query_group=2, three_nn=2,
                             joint_fit=1)
    if counts != want:
        raise AssertionError(f"[assets] launches {counts}, expected {want}")
    B, N = frames["P"].shape[:2]
    finite = all(np.isfinite(x).all() for x in (res.R, res.scale, res.t))
    log(f"[assets] served {B} frames of the asset on the card: seg "
        f"{res.segmentation.shape}, labels "
        f"{np.unique(res.segmentation).tolist()}; GT labels "
        f"{np.unique(frames['cls_gt']).tolist()}; "
        f"fits finite: {finite}")
    if res.segmentation.shape != (B, N) or not finite:
        raise AssertionError("[assets] the served frames' fits are wrong")
    optional_imports(tmp)
    return counts


def viewers_and_profiler(predictor, clouds, dev, tmp: pathlib.Path):
    """Phase 14(c): the ball viewer (C++ against NumPy), vis, the
    profiler's trace and memory stats.  Returns the traced batch's
    launch counts."""
    import torch

    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.serving import forward_fit
    from articulated_pose_tpu_torch.utils import ball_viewer, profiling, vis

    colors = np.random.RandomState(0).rand(len(clouds[0]), 3) * 255
    imgs = [ball_viewer.render_points(clouds[0], colors, size=400,
                                      ballradius=6, xangle=0.3, yangle=-0.4,
                                      use_native=native)
            for native in (True, False)]
    px = float((imgs[0] != imgs[1]).any(-1).mean())
    log(f"[viewers] ball_viewer C++ against NumPy, 400x400: {px:.3%} of "
        f"pixels differ; {(imgs[0].any(-1)).mean():.1%} drawn")
    if px != 0.0 or not imgs[0].any():
        raise AssertionError("[viewers] the native renderer disagrees")
    try:
        importlib.import_module("matplotlib")
    except ImportError:
        try:
            vis.plot3d_pts([[clouds[0]]], save_path=str(tmp / "p.png"))
        except ImportError as e:
            if "matplotlib" not in str(e):
                raise
            log(f"[viewers] without matplotlib: vis raises ({e})")
        else:
            raise AssertionError("[viewers] vis ran without matplotlib")
    else:
        vis.plot3d_pts([[clouds[0]]], [["cloud"]], title="served",
                       save_path=str(tmp / "p.png"))
        log(f"[viewers] vis.plot3d_pts wrote {(tmp / 'p.png').stat().st_size}"
            f" bytes of PNG")
    torch.cuda.reset_peak_memory_stats()
    # the served batch's forward + fit as the predictor's program runs it
    # eagerly: a replay launches its kernels from the graph, naming none
    x = torch.as_tensor(clouds[:REF_SERVE_B], device=dev)
    d = predictor.draws(REF_SERVE_B)
    reset_launch_counts()
    with profiling.trace(str(tmp / "trace")), torch.no_grad():
        forward_fit(predictor.model, x, d.part, d.joint,
                    predictor.pose_cfg)
    counts = launch_counts()
    events = json.loads((tmp / "trace" / profiling.TRACE_FILE).read_text())
    cats = [(e.get("cat"), e.get("name")) for e in events["traceEvents"]]
    # the host's ranges (the trace repeats each on the card's timeline as
    # a "gpu_user_annotation")
    named = {k: cats.count(("user_annotation", f"kernel:{k}"))
             for k in ("fps2", "ball_query_group", "three_nn")}
    device = sum(c == "kernel" for c, _ in cats)
    log(f"[profiler] trace of one served batch's forward + fit, eager: "
        f"{len(cats)} events, {device} device kernels; launch ranges "
        f"{json.dumps(named)}")
    if any(named[k] != counts[k] for k in named):
        raise AssertionError(f"[profiler] the trace names {named}, the "
                             f"batch launched {counts}")
    stats = profiling.device_memory_stats()
    log(f"[profiler] device_memory_stats: peak allocated "
        f"{stats['cuda:0']['allocated_bytes.all.peak']} bytes, reserved "
        f"{stats['cuda:0']['reserved_bytes.all.peak']} bytes (B="
        f"{REF_SERVE_B}, N={REF_SERVE_N}, forward + fit)")
    return counts


def reference_assets(dev):
    """Phase 14.  Returns each sub-path's launch counts."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        predictor, clouds, paths = reference_checkpoint(dev, tmp)
        paths["ref assets"] = asset_path(predictor, dev, tmp)
        paths["ref trace"] = viewers_and_profiler(predictor, clouds, dev, tmp)
    return paths


# --------------------------------------------------------------- phase 15
AB_CATEGORY = "eyeglasses"
AB_SEED = 0                         # packed_eval's and bf16_grads' generator
AB_STEPS = 150
AB_B = 32
AB_N = 1024
AB_FRAMES = 32
AB_PACKED_B = 16                    # ab_packed_eval.py's default batch
AB_GRAD_B = 4
AB_MIN_SEG = 0.40                   # chance is 1/3 (150 steps read 0.51)
AB_ORACLE_ROT = 5.0                 # degrees, the oracle control's mean


def path_call(label: str, fn, *args, **kwargs):
    """fn(...) with the launch counts set to 0 just before; returns
    (its result, the launch counts, host seconds)."""
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)

    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    counts = launch_counts()
    seconds = time.perf_counter() - t0
    log(f"[{label}] {seconds:.1f} s; launches {counts}")
    return out, counts, seconds


def ab_forwards(label: str, counts, forwards: int, packed: bool = False,
                fits: int = 0):
    """Raise unless `counts` are `forwards` forwards' launches (1 fps2,
    2 ball queries (exact or packed) and 2 three_nn each) and `fits`
    fits' (1 joint_fit each)."""
    bq = "ball_query_group_packed" if packed else "ball_query_group"
    want = expected_launches(fps2=forwards, three_nn=2 * forwards,
                             joint_fit=fits, **{bq: 2 * forwards})
    if counts != want:
        raise AssertionError(f"[ab {label}] launches {counts}, expected "
                             f"{want} ({forwards} forwards)")


def ab_oracle() -> None:
    """Phase 15(a): ab.ransac_strength, 8 frames, the --r4 control and two
    arms, on the card."""
    from articulated_pose_tpu_torch.ab import ransac_strength

    args = ransac_strength.parser().parse_args(
        ["--frames", "8", "--r4", "--arms", "refit=4,niter_part=64"])
    rows, counts, _ = path_call("ab ransac_strength", ransac_strength.run,
                                args)
    tags = [t for t, _ in rows]
    if tags != ["PROD 128/64 refit6 (control)", "R4 refit=4",
                "R4 niter_part=64"]:
        raise AssertionError(f"[ab ransac_strength] arms {tags}")
    for tag, s in rows:
        if not (np.isfinite(list(s.values())).all() and s["n_parts"] == 24):
            raise AssertionError(f"[ab ransac_strength] {tag}: {s}")
    if not rows[0][1]["rot_mean"] < AB_ORACLE_ROT:
        raise AssertionError(f"[ab ransac_strength] control rot "
                             f"{rows[0][1]['rot_mean']} >= {AB_ORACLE_ROT}")


def ab_packed(work: str, dev) -> dict:
    """Phase 15(b): ab.packed_eval in f32 and bf16 on the phase's model,
    32 frames, B=16; each arm's kernel calls held to their plain
    versions once, on one batch (outside the counted runs)."""
    import torch

    from articulated_pose_tpu_torch.ab import packed_eval
    from articulated_pose_tpu_torch.ab.restore_eval import restore_state
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.train.state import TrainState

    paths = {}
    jt = ("revolute", "revolute")
    for dtype in ("float32", "bfloat16"):
        argv = ["--work", work, "--points", str(AB_N), "--test-frames",
                str(AB_FRAMES), "--batch", str(AB_PACKED_B), "--dtype", dtype,
                "--min-seg-acc", str(AB_MIN_SEG)]
        args = packed_eval.parser().parse_args(argv)
        res, counts, _ = path_call(f"ab packed_eval {dtype}",
                                   packed_eval.run, args)
        # per arm: the guard's forward, then one a batch
        forwards = 1 + AB_FRAMES // AB_PACKED_B
        want = expected_launches(
            fps2=2 * forwards, three_nn=4 * forwards,
            ball_query_group=2 * forwards,
            ball_query_group_packed=2 * forwards,
            joint_fit=2 * (forwards - 1))
        if counts != want:
            raise AssertionError(f"[ab packed_eval {dtype}] launches "
                                 f"{counts}, expected {want}")
        paths[f"ab packed_eval {dtype}"] = counts
        for arm, m in res.items():
            if not np.isfinite(list(m.values())).all():
                raise AssertionError(f"[ab packed_eval {dtype}] {arm}: {m}")
        one = packed_eval.parser().parse_args(
            argv[:4] + ["--test-frames", str(AB_PACKED_B)] + argv[6:])
        for arm, packed in packed_eval.ARMS:
            model = build_model(packed_eval.arm_config(one, packed),
                                torch.Generator().manual_seed(0), device=dev)
            state, _ = restore_state(
                TrainState(model, packed_eval.arm_config(one, packed)), work)
            label = f"ab packed_eval {dtype} {arm}"
            with held_to_plain(label) as held:
                packed_eval.run_eval(state, one, jt)
            bq = ("ball_query_group_packed" if packed
                  else "ball_query_group")
            log_held(label, held, {"fps2": 1, bq: 1, "three_nn": 1})
    return paths


def ab_grads(work: str) -> dict:
    """Phase 15(c): ab.bf16_grads at B=4, N=1024, depth 4, every arm, on
    the phase's model."""
    from articulated_pose_tpu_torch.ab import bf16_grads

    args = bf16_grads.parser().parse_args(
        ["--work", work, "--batch", str(AB_GRAD_B), "--points", str(AB_N),
         "--depth", "4"])
    out, counts, _ = path_call("ab bf16_grads", bf16_grads.run, args)
    ab_forwards("bf16_grads", counts,
                len(bf16_grads.ARMS) + len(bf16_grads.PARAM_ARMS))
    # the same batch through the f32 arm, its controls and the bf16 arm,
    # each kernel call held (the table goes to a buffer)
    with held_to_plain("ab bf16_grads") as held, \
            contextlib.redirect_stdout(io.StringIO()):
        bf16_grads.run(args, arms={k: bf16_grads.ARMS[k]
                                   for k in ("f32", "bf16")})
    log_held("ab bf16_grads", held, counts)
    if "backbone/sa1/mlp/conv0" not in out["modules"]:
        raise AssertionError("[ab bf16_grads] no backbone/sa1/mlp/conv0")
    arms = [a for a in bf16_grads.ARMS if a != "f32"] + list(
        bf16_grads.PARAM_ARMS)
    cos = [out[f"overall_cosine_{a}"] for a in arms]
    if not (np.isfinite(cos).all() and all(-1 - 1e-9 <= c <= 1 + 1e-9
                                           for c in cos)):
        raise AssertionError(f"[ab bf16_grads] overall cosines {cos}")
    return {"ab bf16_grads": counts}


def ab_knobs(work: str) -> dict:
    """Phase 15(d): ab.pose_knobs_trained on the phase's model, two arms,
    --time-iters 3, 32 frames (one batch)."""
    from articulated_pose_tpu_torch.ab import pose_knobs_trained

    args = pose_knobs_trained.parser().parse_args(
        ["--work", work, "--category", AB_CATEGORY, "--seed", str(AB_SEED),
         "--test-frames", str(AB_FRAMES), "--batch", str(AB_B),
         "--time-iters", "3", "--arms", "control,refit=3",
         "--min-seg-acc", str(AB_MIN_SEG)])
    out, counts, _ = path_call("ab pose_knobs_trained",
                               pose_knobs_trained.run, args)
    # each arm: a warm-up fit and 3 timed ones, then its batch's fit
    ab_forwards("pose_knobs_trained", counts, 1, fits=2 * (1 + 3 + 1))
    # the same prediction forward and the control's fit, each kernel
    # call held
    held_args = pose_knobs_trained.parser().parse_args(
        ["--work", work, "--category", AB_CATEGORY, "--seed", str(AB_SEED),
         "--test-frames", str(AB_FRAMES), "--batch", str(AB_B),
         "--arms", "control", "--min-seg-acc", str(AB_MIN_SEG)])
    with held_to_plain("ab pose_knobs_trained") as held, \
            contextlib.redirect_stdout(io.StringIO()):
        pose_knobs_trained.run(held_args)
    log_held("ab pose_knobs_trained", held, counts)
    rows = out["arms"]
    if len(rows) != 2 or not all(r["ms"] > 0 and np.isfinite(
            [r["rot"], r["trans"], r["acc_5deg5cm"]]).all() for r in rows):
        raise AssertionError(f"[ab pose_knobs_trained] arms {rows}")
    return {"ab pose_knobs_trained": counts}


def accuracy_tools(dev):
    """Phase 15: the accuracy tools of `articulated_pose_tpu_torch.ab` on
    the card.  Returns each sub-path's launch counts."""
    import copy
    import tempfile

    import torch

    from articulated_pose_tpu_torch.ab import pose_knobs_trained
    from articulated_pose_tpu_torch.data.device_synthetic import (
        DeviceSynthetic, make_fused_synthetic_train_step)
    from articulated_pose_tpu_torch.e2e import DATA_KEY
    from articulated_pose_tpu_torch.data.synthetic import \
        SyntheticArticulated
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.registry import get_category
    from articulated_pose_tpu_torch.train.state import TrainState
    from articulated_pose_tpu_torch.train.trainer import Checkpointer

    ab_oracle()
    cat = get_category(AB_CATEGORY)
    args = pose_knobs_trained.parser().parse_args(
        ["--points", str(AB_N), "--batch", str(AB_B)])
    cfg = pose_knobs_trained.train_config(args, cat.n_parts)
    state = TrainState(build_model(cfg, torch.Generator().manual_seed(0),
                                   device=dev), cfg)
    # the tools' generators take SyntheticArticulated's cameras (uniform
    # SO(3)), as the JAX scripts' do, so the phase trains on them too
    dg = DeviceSynthetic(
        SyntheticArticulated(n_parts=cat.n_parts, points_per_part=500,
                             joint_types=tuple(cat.joint_types),
                             seed=AB_SEED), num_points=AB_N, device=dev)
    # the first fused step on a copy of the init, each kernel call held
    probe = TrainState(copy.deepcopy(state.model), cfg)
    with held_to_plain("ab train") as held:
        make_fused_synthetic_train_step(cfg, dg, AB_B, seed=DATA_KEY)(probe,
                                                                      0)
    secs, counts, _ = path_call("ab train",
                                pose_knobs_trained.train_in_process, state,
                                dg, AB_STEPS, AB_B)
    ab_forwards("train", counts, AB_STEPS)
    log_held("ab train", held, counts)
    paths = {"ab train": counts}
    log(f"[ab train] {AB_CATEGORY} seed {AB_SEED}, {AB_STEPS} fused steps "
        f"B={AB_B} N={AB_N} f32 in {secs:.1f} s")
    with tempfile.TemporaryDirectory() as work:
        Checkpointer(f"{work}/model").save(AB_STEPS, state)
        paths.update(ab_packed(work, dev))
        paths.update(ab_grads(work))
        paths.update(ab_knobs(work))
    return paths


# --------------------------------------------------------------- phase 16
TOOLS_ITERS = 2                     # each timing tool's iterations
TOOLS_PROBE_ITERS = 5
TOOLS_CPU_B = 2                     # the card-vs-CPU count of a forward
TOOLS_TRAIN_B = 32                  # profile_train_stages' default
TOOLS_BATCHES = "64,128"            # ab.batch's default
TRAIN_STAGE_LAUNCHES = {"fps2": 1, "ball_query_group": 2, "three_nn": 2}


def tools_probe() -> dict:
    """Phase 16(a): probe_card, its FMA kernel held to float64."""
    from articulated_pose_tpu_torch import probe_card
    from articulated_pose_tpu_torch.ops.kernels.probe import PROBE_KERNELS

    out = probe_card.run(iters=TOOLS_PROBE_ITERS)
    c = out["ceilings"]
    if not (c["hbm_bytes_per_s"] > 0 and c["f32_flops"] > 0):
        raise AssertionError(f"[probe_card] ceilings {c}")
    log(f"[probe_card] FMA chain within {out['fma']['max_rel_err']:.3g} "
        "relative of float64; probe launches "
        + ", ".join(f"{k.name} {k.launches}" for k in PROBE_KERNELS))
    return out


def tools_roofline(dev) -> dict:
    """Phase 16(b): roofline at B=64 (bench.py's program, the fit, FPS,
    the SA1 ball query, FP1's 3-NN, the f32 train step at B=16), each
    stage's kernel calls as its count says; one forward (B=2) counted on
    the CPU and then, as a path of its own, on the card, the two counts
    equal; then each stage, and the B=2 forward, once with its kernel
    calls held.  Returns the two paths' launch counts."""
    import torch

    from articulated_pose_tpu_torch import roofline
    from articulated_pose_tpu_torch.programs import bench_model

    res, counts, _ = path_call("roofline", roofline.run, batch=PACKED_BATCH,
                               points=N_POINTS, train_batch=TRAIN_B,
                               train_points=TRAIN_N, device=str(dev))
    summed = {}
    for r in res["rows"]:
        if not (r["floor_ms"] > 0 and r["gflop"] > 0):
            raise AssertionError(f"[roofline] {r['stage']}: {r}")
        for k, n in r["kernels"].items():
            summed[k] = summed.get(k, 0) + n
    if {k: n for k, n in counts.items() if n} != summed:
        raise AssertionError(f"[roofline] launches {counts}, its counts "
                             f"{summed}")
    P = torch.from_numpy(np.random.RandomState(3).rand(
        TOOLS_CPU_B, N_POINTS, 3).astype(np.float32))
    cpu_model = bench_model(torch.device("cpu"))
    model, x = bench_model(dev), P.to(dev)
    with torch.no_grad():
        on_cpu = roofline.count(lambda: cpu_model(P))
        on_card, fwd_counts, _ = path_call(
            "roofline forward", roofline.count, lambda: model(x))
    if not roofline.same_counts(on_card, on_cpu):
        raise AssertionError(f"[roofline] one forward counts differently on "
                             f"the card ({on_card}) and the CPU ({on_cpu})")
    want = expected_launches(fps2=1, ball_query_group_packed=2, three_nn=2)
    if fwd_counts != want or on_card.kernels != {k: n for k, n in
                                                 want.items() if n}:
        raise AssertionError(f"[roofline forward] launches {fwd_counts}, "
                             f"counted {on_card.kernels}, expected {want}")
    log(f"[roofline] one forward (B={TOOLS_CPU_B}, N={N_POINTS}, bf16, "
        f"packed) counts the same on the card and the CPU: GEMM "
        f"{on_card.gemm / 1e9:.3f} GF, all {on_card.flops / 1e9:.3f} GF, "
        f"compulsory {on_card.compulsory_bytes / 1e6:.2f} MB, launched "
        f"{on_card.launched_bytes / 1e6:.2f} MB, {on_card.ops} ops, kernels "
        f"{on_card.kernels}")
    fns = roofline.stage_fns(PACKED_BATCH, N_POINTS, TRAIN_B, TRAIN_N, dev)
    with held_to_plain("roofline") as held:
        for name, (_, fn) in fns.items():
            with contextlib.nullcontext() if name == "train" \
                    else torch.no_grad():
                fn()
    log_held("roofline", held, counts)
    with held_to_plain("roofline forward") as held, torch.no_grad():
        model(x)
    log_held("roofline forward", held, fwd_counts)
    return {"roofline": counts, "roofline forward": fwd_counts}


def tools_session(dev, profile_rows, probe) -> dict:
    """Phase 16(c): roofline_session on phase 8's profile and (a)'s
    probe: every stage's floor at the published peaks at most its device
    ms; then the same stages' kernel calls held."""
    from articulated_pose_tpu_torch import profile_stages, roofline_session
    from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec

    res, counts, _ = path_call(
        "roofline_session", roofline_session.run, batch=PROFILE_B,
        points=N_POINTS, device=str(dev), profile_rows=profile_rows,
        probe=probe)
    for r in res["rows"]:
        if not (0 < r["share_published"] <= 1 and r["share_measured"] > 0):
            raise AssertionError(f"[roofline_session] {r['stage']}: floor "
                                 f"{r['floor_ms']} ms against "
                                 f"{r['device_ms']} ms on the device")
    with held_to_plain("roofline_session") as held:
        fns = profile_stages.stage_fns(
            PROFILE_B, N_POINTS, BackboneSpec(),
            profile_stages.STAGES, dev)
        for _, fn in fns.values():
            fn()
    log_held("roofline_session", held, counts)
    return counts


def tools_train_stages(dev) -> dict:
    """Phase 16(d): profile_train_stages at B=32, N=1024: its five stages
    in the JAX script's order, device time in each, 1 fps2, 2
    ball_query_group and 2 three_nn launches a call but in data gen;
    then one call of each stage with its kernel calls held."""
    from articulated_pose_tpu_torch import profile_train_stages
    from articulated_pose_tpu_torch.programs import train_setup

    rows, counts, _ = path_call(
        "profile_train_stages", profile_train_stages.run, batch=TOOLS_TRAIN_B,
        points=TRAIN_N, iters=TOOLS_ITERS, device=str(dev))
    if [r["stage"] for r in rows] != list(profile_train_stages.STAGES):
        raise AssertionError(f"[profile_train_stages] stages {rows}")
    for r in rows:
        want = {} if r["stage"] == "data gen" else TRAIN_STAGE_LAUNCHES
        if not (r["device_ms"] > 0 and r["launches"] == want):
            raise AssertionError(f"[profile_train_stages] {r}")
    state, batch, dg = train_setup(TOOLS_TRAIN_B, TRAIN_N, dev)
    with held_to_plain("profile_train_stages") as held:
        for fn in profile_train_stages.stage_fns(state, batch, dg).values():
            fn()
    log_held("profile_train_stages", held, counts)
    return counts


def tools_ab(dev) -> dict:
    """Phase 16(e-g): ab.overlap (its pipelined fits equal to the serial
    ones), ab.batch at B=64 and 128, ab.batch_joints (joint_fit alone); each
    forward's and fit's kernel calls held once at each batch size."""
    import torch

    from articulated_pose_tpu_torch.ab import batch, batch_joints, overlap
    from articulated_pose_tpu_torch.ab.common import BenchProgram

    paths = {}
    args = overlap.parser().parse_args(["--iters", str(TOOLS_ITERS)])
    res, counts, _ = path_call("ab overlap", overlap.run, args)
    # 2 x (fwd-only, serial, pipelined), each a warm-up and a timed call
    ab_forwards("overlap", counts, 3 * 2 * TOOLS_ITERS, packed=True,
                fits=3 * 2 * TOOLS_ITERS)
    paths["ab overlap"] = counts
    args = batch.parser().parse_args(["--iters", str(TOOLS_ITERS),
                                      "--batches", TOOLS_BATCHES])
    res, counts, _ = path_call("ab batch", batch.run, args)
    Bs = [int(b) for b in TOOLS_BATCHES.split(",")]
    # per B: a warm-up, two runs, and the profile's two calls
    ab_forwards("batch", counts, len(Bs) * (3 + 2 * TOOLS_ITERS),
                packed=True, fits=len(Bs) * (3 + 2 * TOOLS_ITERS))
    for r in res["rows"]:
        if not (r["device_ms"] > 0 and r["device_ops"] > 0):
            raise AssertionError(f"[ab batch] {r}")
    paths["ab batch"] = counts
    with held_to_plain("ab overlap, batch") as held, torch.inference_mode():
        for B in Bs:
            BenchProgram(B, N_POINTS, 1, dev).step(0)
    log_held("ab overlap, batch", held, paths["ab overlap"])
    log_held("ab overlap, batch", held, paths["ab batch"])
    args = batch_joints.parser().parse_args(["--iters", str(TOOLS_ITERS)])
    _, counts, _ = path_call("ab batch_joints", batch_joints.run, args)
    # a fit of each arm, then 4 windows of iters fits; one joint_fit a fit,
    # the joints grouped or not
    want = expected_launches(joint_fit=2 + 4 * TOOLS_ITERS)
    if counts != want:
        raise AssertionError(f"[ab batch_joints] the fit launched {counts}, "
                             f"expected {want}")
    return paths


def timing_tools(dev, profile_rows) -> dict:
    """Phase 16: the roofline and timing tools at short counts.  Returns
    each sub-path's launch counts."""
    probe = tools_probe()
    paths = tools_roofline(dev)
    paths.update({
        "roofline_session": tools_session(dev, profile_rows, probe),
        "profile_train_stages": tools_train_stages(dev)})
    paths.update(tools_ab(dev))
    return paths


# --------------------------------------------------------------- phase 17
COMPILED_CALLS = 3                  # fresh-cloud calls, each replayed
COMPILED_TRAIN_STEPS = 5
COMPILED_FUSED_B = 32               # the e2e recipe's batch
COMPILED_FUSED_STEPS = 5
COMPILED_TIME_ITERS = 10            # host-clock window of each timing
COMPILED_PROFILE_ITERS = 3          # torch.profiler window of each
# one train step from a common state, replayed against eager: the
# gradient's sums in another order (the gathers' backward adds with
# atomics, so the card's eager step does not repeat itself bit for bit)
COMPILED_GRAD_NORM_RTOL = 1e-5
COMPILED_MOMENT_BOUND = 1e-4        # of a leaf's largest entry, as the
                                    # gradients of tests/test_torch_train.py
COMPILED_PARAM_LRS = 2.05           # two Adam steps of opposite sign (a
                                    # ~0 gradient's sign is rounding's),
                                    # each at most 1.011 lr in steps 1-5


def tensor_leaves(tree, prefix: str = "") -> dict:
    """{path: tensor} of a tree of dicts, lists, tuples and tensors."""
    import torch

    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree} if torch.is_tensor(tree) else {}
    out = {}
    for k, v in items:
        out.update(tensor_leaves(v, f"{prefix}/{k}"))
    return out


def tree_difference(got, want) -> tuple:
    """(how many leaves differ, of how many; the largest absolute
    difference and its place) of two trees of tensors; equal means the
    same shape, dtype and bits, NaN where NaN."""
    import torch

    g, w = tensor_leaves(got), tensor_leaves(want)
    if set(g) != set(w):
        raise AssertionError(f"the trees hold other leaves: "
                             f"{sorted(set(g) ^ set(w))}")
    differ, worst, where = 0, 0.0, None
    for k in sorted(w):
        a, b = g[k], w[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{k}: {a.dtype}{tuple(a.shape)} against "
                                 f"{b.dtype}{tuple(b.shape)}")
        if torch.equal(a, b) or (
                a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))):
            continue
        differ += 1
        d = (a.double() - b.double()).abs().nan_to_num(nan=float("inf"))
        i = int(d.argmax())
        if float(d.flatten()[i]) >= worst:
            worst = float(d.flatten()[i])
            where = f"{k}{list(np.unravel_index(i, tuple(a.shape)))}"
    return differ, len(w), worst, where


def compiled_serve(label: str, predictor, clouds, batch: int, per_batch):
    """Phase 17(a, b) for one predictor: the shape's first call (run and
    captured), then COMPILED_CALLS calls of fresh clouds with the launch
    counts set to 0, each a replay of every shard's program, and each
    shard's outputs equal to the eager `forward_fit` on the same rows and
    draws.  Returns the replayed calls' launch counts."""
    import torch

    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.serving import forward_fit

    shards = predictor.batch_sharding.shards
    predictor(clouds[:batch])
    reset_launch_counts()
    outs = []
    for r in range(1, COMPILED_CALLS + 1):
        P = clouds[r * batch:(r + 1) * batch]
        outs.append((P, predictor._run(P)))
    counts = launch_counts()
    want = expected_launches(**{k: COMPILED_CALLS * shards * n
                                for k, n in per_batch.items()})
    if counts != want:
        raise AssertionError(f"[{label}] launches {counts}, expected {want}")
    for shard, program in enumerate(predictor._programs):
        replays = [c.replays for c in program.captured.values()]
        if replays != [COMPILED_CALLS]:
            raise AssertionError(f"[{label}] shard {shard}: replays of each "
                                 f"captured graph {replays}, expected "
                                 f"[{COMPILED_CALLS}]")
    for r, (P, got) in enumerate(outs):
        for shard in range(shards):
            rows = predictor.batch_sharding.rows(len(P), shard)
            x = torch.as_tensor(P[rows], device=predictor.device)
            d = predictor._default_draws[(len(x), shard)]
            with torch.no_grad():
                eager = forward_fit(predictor.model, x, d.part, d.joint,
                                    predictor.pose_cfg)
            differ, n, worst, where = tree_difference(got[shard], eager)
            if differ:
                raise AssertionError(
                    f"[{label}] call {r + 1} shard {shard}: {differ} of {n} "
                    f"outputs differ from the eager forward + fit, the "
                    f"largest by {worst} at {where}")
    entry = next(iter(predictor._programs[0].captured.values()))
    log(f"[{label}] {COMPILED_CALLS} calls of {batch} fresh clouds, each "
        f"shard's program ({shards}) replayed: every output of every shard "
        f"torch.equal to the eager forward_fit on the same rows and draws; "
        f"capture {entry.capture_s:.2f} s, graph pool {entry.pool_bytes} "
        f"bytes; launches {counts}")
    return counts


def state_tree(state) -> dict:
    """Every tensor of a train state: parameters, batch statistics, both
    moments, Adam's count and the step."""
    sd = state.state_dict()
    return {k: sd[k] for k in ("model", "mu", "nu", "count", "step")}


def step_deviations(label: str, got_m, want_m, got, want, zero, lr):
    """Phase 17(c, d)'s hold on one step of two arms from a common state:
    the forward is deterministic, so every loss, the batch statistics,
    Adam's count and the step are equal bit for bit; the gradient's sums
    may run in another order, so the grad norm is held to rtol
    COMPILED_GRAD_NORM_RTOL, each moment leaf to COMPILED_MOMENT_BOUND of
    its largest entry (the second moment, a square, to twice that; a
    pre-batch-norm bias, whose gradient is rounding, to its layer's
    weight's) and each parameter to COMPILED_PARAM_LRS learning rates.
    Returns the readings, each beside its bound."""
    from articulated_pose_tpu_torch.train.routing import grad_deviations

    losses = [k for k in want_m if k != "grad_norm"]
    stats = [k for k in want["model"] if "running" in k]
    equal = tree_difference(
        ({k: got_m[k] for k in losses}, {k: got["model"][k] for k in stats},
         got["count"], got["step"]),
        ({k: want_m[k] for k in losses}, {k: want["model"][k] for k in stats},
         want["count"], want["step"]))
    gn = abs(float(got_m["grad_norm"]) / float(want_m["grad_norm"]) - 1.0)
    worst = {}
    for key, bound in (("mu", COMPILED_MOMENT_BOUND),
                       ("nu", 2 * COMPILED_MOMENT_BOUND)):
        ratio, name, _, _ = grad_deviations(got[key], want[key], zero)[0]
        worst[key] = (ratio, name, bound)
    params = {k: got["model"][k] for k in got["mu"]}
    moved = max(((params[k] - want["model"][k]).abs().max().item() / lr, k)
                for k in params)
    out = {"unequal": equal[0], "grad_norm_rel": gn,
           "mu": worst["mu"][:2], "nu": worst["nu"][:2],
           "param_lrs": moved}
    log(f"[{label}] {equal[0]} of {equal[1]} losses, batch statistics and "
        f"counts differ; grad norm {gn:.3g} relative (bound "
        f"{COMPILED_GRAD_NORM_RTOL}); mu {worst['mu'][0]:.3g} of its leaf's "
        f"largest at {worst['mu'][1]}, nu {worst['nu'][0]:.3g} at "
        f"{worst['nu'][1]} (bounds {COMPILED_MOMENT_BOUND}, "
        f"{2 * COMPILED_MOMENT_BOUND}); parameters {moved[0]:.3g} lr at "
        f"{moved[1]} (bound {COMPILED_PARAM_LRS})")
    if (equal[0] or gn > COMPILED_GRAD_NORM_RTOL
            or any(r > b for r, _, b in worst.values())
            or moved[0] > COMPILED_PARAM_LRS):
        raise AssertionError(f"[{label}] left its bounds (largest unequal "
                             f"entry {equal[2]} at {equal[3]})")
    return out


def compiled_steps(label: str, arms, steps: int, lr: float):
    """Phase 17(c, d): `steps` steps of each arm, [(name, step(state, s),
    state)]: the captured program, the eager body, and the eager body
    again.  Before each step the two eager states take the captured one's
    values, so each step runs from a common state; after it the first
    arm and the third are each held against the second
    (`step_deviations`).  Returns (the captured steps' launch counts,
    the readings)."""
    from articulated_pose_tpu_torch.ops.kernels import launch_counts
    from articulated_pose_tpu_torch.train.routing import pre_bn_biases

    zero = pre_bn_biases(arms[0][2].model)
    counts = {k: 0 for k in launch_counts()}
    readings = []
    for s in range(steps):
        for _, _, st in arms[1:]:
            st.load_state_dict(arms[0][2].state_dict())
        before = launch_counts()
        metrics = [arms[0][1](arms[0][2], s)]
        for k, n in launch_counts().items():
            counts[k] += n - before[k]
        metrics += [run(st, s) for _, run, st in arms[1:]]
        trees = [state_tree(st) for _, _, st in arms]
        for i in (0, 2):
            readings.append({"step": s + 1, "arm": arms[i][0], **(
                step_deviations(f"{label}] [step {s + 1}, {arms[i][0]} "
                                f"against {arms[1][0]}", metrics[i],
                                metrics[1], trees[i], trees[1], zero, lr))})
    return counts, readings


def wall_ms(fn, iters: int) -> float:
    """ms a call of fn on the host clock around `iters` calls, the card
    synchronised before and after; one call first."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def eager_vs_replayed(label: str, batch: int, arms: dict, card: str) -> dict:
    """Phase 17(e): ms a call, clouds/s, device ms, device ops and idle
    share of each arm (eager, replayed), and the bytes one call allocates
    above what was allocated before it, each arm on its own line with the
    card's name and power limit.  Returns {arm: readings}."""
    import torch

    from articulated_pose_tpu_torch.timing import device_profile

    out = {}
    for arm, fn in arms.items():
        ms = wall_ms(fn, COMPILED_TIME_ITERS)
        dev_ms, ops = device_profile(fn, COMPILED_PROFILE_ITERS)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out[arm] = dict(ms=ms, clouds_per_s=batch / ms * 1e3,
                        device_ms=dev_ms, ops=ops, idle=1.0 - dev_ms / ms,
                        peak_bytes=peak)
        log(f"[compiled time] {label} {arm}: {ms:.3f} ms a call, "
            f"{batch / ms * 1e3:.1f} clouds/s (host clock, "
            f"{COMPILED_TIME_ITERS} synchronised calls); device {dev_ms:.3f} "
            f"ms and {ops} ops a call (torch.profiler, "
            f"{COMPILED_PROFILE_ITERS} calls), idle share "
            f"{1.0 - dev_ms / ms:.3f}; a call allocates {peak} bytes at its "
            f"peak; {card}")
    return out


def program_note(label: str, program) -> dict:
    """Print and return a captured program's graphs: capture seconds, pool
    bytes and replays of each."""
    graphs = [dict(capture_s=e.capture_s, pool_bytes=e.pool_bytes,
                   replays=e.replays) for e in program.captured.values()]
    log(f"[compiled] {label}: {len(graphs)} graph(s), " + "; ".join(
        f"capture {g['capture_s']:.2f} s, pool {g['pool_bytes']} bytes, "
        f"{g['replays']} replays" for g in graphs))
    return {"graphs": graphs}


def compiled_serving(dev, card: str):
    """Phase 17(a, b, e): bench.py's serve (B=64, bf16 trunk, packed ball
    query, niter 128/64), phase 4's f32 serve at B=16 and the f32 serve
    on a data=2 mesh of the one card, each held replay against eager;
    then eager against replayed times of the first two.  Returns (each
    path's launch counts, the readings)."""
    import torch

    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.parallel.mesh import make_mesh
    from articulated_pose_tpu_torch.serving import PosePredictor, forward_fit

    cfg = NetworkConfig(category="eyeglasses", n_max_parts=3,
                        num_points=N_POINTS, batch_size=SERVE_BATCH)
    state = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    clouds, _, _ = articulated_frames(np.random.RandomState(17),
                                      (COMPILED_CALLS + 1) * PACKED_BATCH,
                                      N_POINTS, 3)
    packed_cfg = cfg.replace(compute_dtype="bfloat16", ball_query_packed=True,
                             batch_size=PACKED_BATCH)
    exact = expected_launches(fps2=1, ball_query_group=2, three_nn=2,
                              joint_fit=1)
    packed = expected_launches(fps2=1, ball_query_group_packed=2, three_nn=2,
                               joint_fit=1)
    serving = {
        "compiled serve packed bf16": (
            PosePredictor(packed_cfg, state_dict=state, device=dev),
            PACKED_BATCH, packed),
        "compiled serve f32": (PosePredictor(cfg, state_dict=state,
                                             device=dev), SERVE_BATCH, exact),
        "compiled serve data=2": (
            PosePredictor(cfg, state_dict=state,
                          mesh=make_mesh("data=2", devices=[dev, dev])),
            SERVE_BATCH, exact)}
    paths, readings = {}, {}
    for label, (predictor, batch, per_batch) in serving.items():
        paths[label] = compiled_serve(label, predictor, clouds, batch,
                                      per_batch)
    for label in ("compiled serve packed bf16", "compiled serve f32"):
        predictor, batch, _ = serving[label]
        x = torch.as_tensor(clouds[:batch], device=dev)
        d = predictor._default_draws[(batch, 0)]
        args = (predictor.model, x, d.part, d.joint)
        with torch.no_grad():
            readings[label] = eager_vs_replayed(label, batch, {
                "eager": lambda: forward_fit(*args, predictor.pose_cfg),
                "replayed": lambda: predictor._programs[0](*args)}, card)
        readings[label].update(program_note(label, predictor._programs[0]))
    return paths, readings


def compiled_training(dev, card: str):
    """Phase 17(c, d, e): make_train_step(jit=True) on cfg/network_config.
    yml in f32 (B=16, N=1024, dropout on) and the fused synthetic step of
    the e2e recipe (laptop, B=32), each held replay against eager a step
    at a time; then eager against replayed times.  Returns (each path's
    launch counts, the readings)."""
    import copy

    import torch

    from articulated_pose_tpu_torch import e2e
    from articulated_pose_tpu_torch.config import load_config
    from articulated_pose_tpu_torch.data.device_synthetic import \
        make_fused_synthetic_train_step
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.train.state import (TrainState,
                                                        dropout_generator,
                                                        make_train_step,
                                                        to_device)

    f32 = load_config(str(ROOT / "cfg" / "network_config.yml")).replace(
        compute_dtype="float32")
    if not f32.dropout_rate > 0:
        raise AssertionError("[compiled train] the config has no dropout")
    batch = to_device(stack(train_frames(f32, TRAIN_B, seed=0)), dev)
    model = build_model(f32, torch.Generator().manual_seed(0), device=dev)
    jit = make_train_step(f32)
    eager = make_train_step(f32, jit=False)

    def arm(step_fn):
        gen = torch.Generator(device=dev)
        return lambda st, s: step_fn(st, batch,
                                     dropout_generator(gen, f32.seed, s))

    states = [TrainState(model, f32)] + [
        TrainState(copy.deepcopy(model), f32) for _ in range(2)]
    steps = [arm(jit), arm(eager), arm(eager)]
    paths, readings = {}, {}
    paths["compiled train"], readings["train steps"] = compiled_steps(
        "compiled train", list(zip(("replayed", "eager", "eager again"),
                                   steps, states)),
        COMPILED_TRAIN_STEPS, f32.init_learning_rate)

    args, _, _, ecfg, dg = e2e_setup("laptop", 2, dev)
    fmodel = build_model(ecfg, torch.Generator().manual_seed(0), device=dev)
    fstates = [TrainState(fmodel, ecfg)] + [
        TrainState(copy.deepcopy(fmodel), ecfg) for _ in range(2)]
    fused = [make_fused_synthetic_train_step(
        ecfg, dg, COMPILED_FUSED_B, seed=e2e.DATA_KEY, jit=j)
        for j in (True, False, False)]
    paths["compiled fused"], readings["fused steps"] = compiled_steps(
        "compiled fused", list(zip(("replayed", "eager", "eager again"),
                                   fused, fstates)),
        COMPILED_FUSED_STEPS, ecfg.init_learning_rate)
    for label, n in (("compiled train", COMPILED_TRAIN_STEPS),
                     ("compiled fused", COMPILED_FUSED_STEPS)):
        want = expected_launches(fps2=n, ball_query_group=2 * n,
                                 three_nn=2 * n)
        if paths[label] != want:
            raise AssertionError(f"[{label}] launches {paths[label]}, "
                                 f"expected {want}")

    def stepping(step_fn, st, first: int):
        count = [first]

        def call():
            step_fn(st, count[0])
            count[0] += 1
        return call

    for label, b, (step_jit, step_eager), (st_jit, st_eager), first, prog in (
            (f"train step B={TRAIN_B} N={TRAIN_N} f32", TRAIN_B,
             steps[:2], states[:2], COMPILED_TRAIN_STEPS, jit.program),
            (f"fused step B={COMPILED_FUSED_B} N={args.points} f32",
             COMPILED_FUSED_B, fused[:2], fstates[:2], COMPILED_FUSED_STEPS,
             fused[0].program)):
        readings[label] = eager_vs_replayed(label, b, {
            "eager": stepping(step_eager, st_eager, first),
            "replayed": stepping(step_jit, st_jit, first)}, card)
        readings[label].update(program_note(label, prog))
    return paths, readings


def compiled_programs(dev):
    """Phase 17.  Returns each sub-path's launch counts; writes every
    reading to chiprun_out/compiled_programs.json."""
    import torch

    from articulated_pose_tpu_torch.timing import card_line

    card = card_line()
    log(f"[compiled] torch {torch.__version__}, {card}")
    paths, serve_read = compiled_serving(dev, card)
    train_paths, train_read = compiled_training(dev, card)
    paths.update(train_paths)
    out = ROOT / "chiprun_out" / "compiled_programs.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(card=card, **serve_read, **train_read),
                              indent=1))
    log(f"[compiled] readings written to {out.relative_to(ROOT)}")
    return paths


PTV1_B, PTV1_N, PTV1_FRAMES = 16, 8192, 32
# the cell's nine k-NN searches: (M queries, N points, k)
PTV1_SEARCHES = ((8192, 8192, 8), (2048, 8192, 16), (2048, 2048, 16),
                 (512, 2048, 16), (512, 512, 16), (128, 512, 16),
                 (128, 128, 16), (32, 128, 16), (32, 32, 16))


def ptv1_knn_times(dev) -> dict:
    """The `knn` kernel at the cell's nine searches (B=16; the queries
    points of the cloud, as the backbone's are): held equal to its plain
    version, then its ms, the plain version's, torch.topk over
    torch.cdist's and the bound from roofline.knn_work.  Returns its
    entry of the kernels' JSON line (`kernel_result`)."""
    import torch

    from articulated_pose_tpu_torch import roofline, timing
    from articulated_pose_tpu_torch.ops.kernels import knn

    times, shapes, bounds, errs = [], [], [], []
    for M, N, k in PTV1_SEARCHES:
        xyz = torch.from_numpy(np.random.RandomState(N + M).rand(
            PTV1_B, N, 3).astype(np.float32)).to(dev)
        q = xyz[:, ::N // M].contiguous()
        got, want = knn.knn(k, xyz, q), knn.knn_plain(k, xyz, q)
        errs.append(check_equal(f"[ptv1 knn] {M} <- {N}, k={k}", got, want))
        times.append(time_both(
            lambda: knn.knn(k, xyz, q), lambda: knn.knn_plain(k, xyz, q),
            lambda: torch.topk(torch.cdist(q, xyz), k, largest=False)))
        work = roofline.knn_work(PTV1_B, M, N, k)
        bounds.append(timing.roofline_ms(work.flops, work.bytes))
        shapes.append([PTV1_B, M, N, k])
        log(f"[ptv1 knn] B={PTV1_B} {M} <- {N}, k={k} (lanes "
            f"{knn.knn_plan(PTV1_B, M, N)}): equal; {times[-1][4]}; bound "
            f"{max(bounds[-1]):.4f} ms")
        del xyz, q, got, want
        torch.cuda.empty_cache()
    return kernel_result(max(errs), times, shapes, bounds)


# the cell's five attention levels at B=16: (n points, C, k)
VA_LEVELS = ((8192, 32, 8), (2048, 64, 16), (512, 128, 16), (128, 256, 16),
             (32, 512, 16))


def vector_attention_held(got, want, dtype) -> dict:
    """The kernel's y against the plain layer's on the same inputs.  Only
    the order of f32 sums differs (the products over C and G, the sum over
    k), which moves y by a few f32 ulps of its terms: each element within
    1e-4 of y's largest ("near").  In bf16 such a sum may also round a
    value to the neighbouring bf16 at one of the layer's rounding points;
    the row's later values follow it, so a few per cent of the outputs
    may move further, each within 2^-6 of y's largest.  Raises outside
    that; returns the near share and the largest difference."""
    import torch

    torch.cuda.synchronize()
    if got.dtype != torch.float32 or got.shape != want.shape or \
            not torch.isfinite(got).all():
        raise AssertionError(f"vector_attention: y {got.dtype} "
                             f"{tuple(got.shape)}, finite "
                             f"{torch.isfinite(got).all().item()}")
    scale = want.abs().max().item()
    diff = (got - want).abs()
    near = (diff <= 1e-4 * scale).float().mean().item()
    worst = diff.max().item()
    out = dict(near_share=near, max_abs_err=worst, scale=scale)
    least = 1.0 if dtype == torch.float32 else 0.97
    if near < least or worst > 2 ** -6 * scale:
        raise AssertionError(f"vector_attention {tuple(got.shape)} {dtype}: "
                             f"{out}")
    return out


def vector_attention_layer(C: int, dtype, dev, seed: int = 0):
    """A PointTransformerLayer in eval mode on the card: Linear weights at
    their default initialisation from the seed, each batch norm's affine
    and running statistics drawn, so none is an identity."""
    import torch

    from articulated_pose_tpu_torch.models import point_transformer as pt

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        layer = pt.PointTransformerLayer(C, 8, dtype)
        with torch.no_grad():
            for bn in (layer.pos.bn, layer.w_bn, layer.w.bn):
                bn.weight.copy_(1 + 0.2 * torch.randn(bn.weight.shape))
                bn.bias.copy_(0.1 * torch.randn(bn.bias.shape))
                bn.running_mean.copy_(0.1 * torch.randn(bn.bias.shape))
                bn.running_var.copy_(0.5 + torch.rand(bn.bias.shape))
    return layer.to(dev).eval()


def vector_attention_times(dev, dtype_name: str = "bfloat16") -> dict:
    """Phase 20: the `vector_attention` kernel at the cell's five levels
    (B=16): held to the plain layer (`vector_attention_held`), then its
    ms, the plain layer's and the bound (roofline.vector_attention_work
    and _gamma_flops).  Returns its entry of the kernels' JSON line
    (`kernel_result`)."""
    import torch

    from articulated_pose_tpu_torch import roofline, timing
    from articulated_pose_tpu_torch.models import point_transformer as pt
    from articulated_pose_tpu_torch.ops.kernels import knn
    from articulated_pose_tpu_torch.ops.kernels import vector_attention as va

    dtype = getattr(torch, dtype_name)
    times, shapes, bounds, errs = [], [], [], []
    for n, C, k in VA_LEVELS:
        rng = np.random.RandomState(n + C)
        layer = vector_attention_layer(C, dtype, dev, seed=C)
        p = torch.from_numpy(rng.rand(PTV1_B, n, 3).astype(np.float32)
                             ).to(dev)
        x = torch.from_numpy(rng.randn(PTV1_B, n, C).astype(np.float32)
                             ).to(dev)
        nbr = knn.knn(k, p, p)[1]
        with torch.no_grad():
            q, key, v = (pt._linear(lin, x, dtype)
                         for lin in (layer.q, layer.k, layer.v))
            args = (layer, p, q, key, v, nbr)
            held = vector_attention_held(va.vector_attention(*args),
                                         va.vector_attention_plain(*args),
                                         dtype)
            errs.append(held["max_abs_err"])
            times.append(time_both(lambda: va.vector_attention(*args),
                                   lambda: va.vector_attention_plain(*args)))
        work = roofline.vector_attention_work(PTV1_B, n, k, C,
                                              q.element_size())
        gamma_ms = roofline.vector_attention_gamma_flops(
            PTV1_B, n, k, C, 8) / timing.TENSOR_PEAK_FLOPS * 1e3
        ops_ms, bytes_ms = timing.roofline_ms(work.flops, work.bytes)
        bounds.append((max(gamma_ms, ops_ms), bytes_ms))
        shapes.append([PTV1_B, n, C, k])
        log(f"[vector_attention] B={PTV1_B} n={n} C={C} k={k} {dtype_name}: "
            f"near share {held['near_share']:.5f}, max |diff| "
            f"{held['max_abs_err']:.3e} of {held['scale']:.3e}; "
            f"{times[-1][4]}; floors: gamma {gamma_ms:.4f} ms, theta and "
            f"the sum {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms")
        del layer, p, x, nbr, q, key, v, args
        torch.cuda.empty_cache()
    return kernel_result(max(errs), times, shapes, bounds)


JOINT_FIT_SHAPES = ((64, 2048), (16, 8192), (256, 2048))


def joint_fit_times(dev) -> dict:
    """The `joint_fit` kernel at the served cells' fits (K=3, H=64, the
    buffers of random heads): held equal to its plain version
    (pipeline.joint_fit_plain, every joint alone), then its ms, the plain
    version's and the bound from roofline.joint_fit_work.  Returns its
    entry of the kernels' JSON line (`kernel_result`)."""
    import torch

    from articulated_pose_tpu_torch import roofline, timing
    from articulated_pose_tpu_torch.ops.kernels.joint_fit import (
        joint_fit, launch_config)
    from articulated_pose_tpu_torch.pose import pipeline
    from articulated_pose_tpu_torch.programs import (bench_pose_config,
                                                     random_predictions)

    cfg = bench_pose_config()
    times, shapes, bounds, errs = [], [], [], []
    for B, N in JOINT_FIT_SHAPES:
        rng = np.random.RandomState(B + N)
        pred = random_predictions(rng, B, N, 3, dev)
        P = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32)).to(dev)
        cap = min(cfg.part_points, N)
        src, tgt, mask, _ = pipeline.build_part_buffers_sorted(
            pred["nocs_per_point"], P, pred["W"].argmax(-1), 3, cap)
        assocs = (pred["index_per_point"].argmax(-1).unsqueeze(1)
                  == torch.arange(1, 3, device=dev)[:, None]).float()
        axes = pipeline.vote_joint_axes(pred["joint_axis_per_point"], assocs)
        draws = pipeline.PoseDraws.sample(B, cfg, device=dev).joint
        args = (src, tgt, mask, axes, draws, cfg)
        got, want = joint_fit(*args), pipeline.joint_fit_plain(*args)
        errs.append(check_equal(f"[joint_fit] B={B} N={N}", got[:-1],
                                want[:-1]))
        times.append(time_both(lambda: joint_fit(*args),
                               lambda: pipeline.joint_fit_plain(*args)))
        work = roofline.joint_fit_work(
            B, 3, cap, cfg.niter_joint,
            launch_config(cfg, B, 3, cap).score_points)
        bounds.append(timing.roofline_ms(work.flops, work.bytes))
        shapes.append([B, N, 3, cfg.niter_joint])
        log(f"[joint_fit] B={B} N={N} K=3 H={cfg.niter_joint}: equal; "
            f"{times[-1][4]}; bound {max(bounds[-1]):.4f} ms")
    return kernel_result(max(errs), times, shapes, bounds)


def joint_order_counts() -> list:
    """The batch counts whose product orders `joint_orders` reads first:
    every count up to 64, a grid (x1.15) up to ORDERS_CHECKED_TO, two on
    each side of each step of the tables, and the fits' counts B and
    B x H (H = 64, 128) for B up to 512."""
    from articulated_pose_tpu_torch.ops.kernels.joint_fit import (
        MV_ORDERS, MVT_ORDERS, ORDERS_CHECKED_TO)

    counts = set(range(1, 65))
    n = 64
    while n < ORDERS_CHECKED_TO:
        n = int(n * 1.15) + 1
        counts.add(min(n, ORDERS_CHECKED_TO))
    for start, _ in MV_ORDERS + MVT_ORDERS:
        counts.update(range(max(1, start - 2), start + 3))
    for B in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
        counts.update((B, 64 * B, 128 * B))
    return sorted(c for c in counts if c <= ORDERS_CHECKED_TO)


def order_table(steps) -> tuple:
    """A table of (from, order) steps from (from, orders that match)
    steps: an order kept while it still matches, else the lowest that
    matches, None where none does; equal neighbours merged."""
    table = []
    for start, found in steps:
        keep = table[-1][1] if table else None
        order = keep if keep in found else (min(found) if found else None)
        if not table or order != keep:
            table.append((start, order))
    return tuple(table)


def joint_orders(dev) -> dict:
    """Re-read the product orders of `joint_fit`'s tables on this card
    (phase 19's second half): for each form, the dot3 orders that give
    torch's product bit for bit at `joint_order_counts`, each change
    between two counts bisected to the count where it happens; logged
    as runs of counts and as the table they give.  Fails where a table's
    order is not among those that match at a count read."""
    import torch

    from articulated_pose_tpu_torch.ops.kernels.joint_fit import (
        ORDERS_TOOLKIT, PRODUCT_FORMS, dot3_orders, dot_order, toolkit_of)

    here = toolkit_of(torch.__version__, torch.version.cuda)
    log(f"[joint orders] toolkit {here}, the tables read on "
        f"{ORDERS_TOOLKIT}: {'same' if here == ORDERS_TOOLKIT else 'other'}")
    counts = joint_order_counts()
    result = {"toolkit": list(here), "counts": len(counts), "tables": {},
              "off": {}}
    for form in PRODUCT_FORMS:
        read = {}

        def orders(n):
            if n not in read:
                read[n] = dot3_orders(n, form, dev,
                                      draws=max(2, min(64, 512 // n)),
                                      seed=n)
            return read[n]

        def steps_between(a, b):       # the counts in (a, b] where it changes
            if orders(a) == orders(b):
                return []
            if b - a == 1:
                return [b]
            m = (a + b) // 2
            return steps_between(a, m) + steps_between(m, b)

        steps = [(counts[0], orders(counts[0]))]
        for a, b in zip(counts, counts[1:]):
            steps += [(n, orders(n)) for n in steps_between(a, b)]
        table = order_table(steps)
        off = [[n, dot_order(n, form == "mvt"), list(found)]
               for n, found in sorted(read.items())
               if dot_order(n, form == "mvt") is not None
               and dot_order(n, form == "mvt") not in found]
        log(f"[joint orders] {form}: " + ", ".join(
            f"from {n} {list(found)}" for n, found in steps))
        log(f"[joint orders] {form} table read: {table}; "
            f"{len(read)} counts")
        result["tables"][form] = table
        result["off"][form] = off
    log(f"[joint orders] {json.dumps(result)}")
    if any(result["off"].values()):
        raise AssertionError(
            f"[joint orders] the tables' orders give other products than "
            f"torch's at (count, order, orders that match): "
            f"{json.dumps(result['off'])}")
    return result


def ptv1_serve(dev):
    """Phase 18: serve the Point Transformer configuration once through
    the command line, its config read by load_config."""
    import tempfile

    import torch

    from articulated_pose_tpu_torch.config import load_config
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.serving import PosePredictor
    from articulated_pose_tpu_torch.train.state import TrainState
    from articulated_pose_tpu_torch.train.trainer import Checkpointer

    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        path = work / "ptv1.yml"
        path.write_text("backbone: point_transformer\n"
                        "compute_dtype: bfloat16\n")
        cfg = load_config(str(path), num_points=PTV1_N, batch_size=PTV1_B)
        model = build_model(cfg, torch.Generator().manual_seed(0))
        Checkpointer(str(work / "model")).save(0, TrainState(model, cfg))
        out_npz = work / "poses.npz"
        _, seconds, counts = run_cli("serve ptv1", [
            "serve", "--config", str(path), "--synthetic",
            "--synthetic_frames", str(PTV1_FRAMES), "--num_points",
            str(PTV1_N), "--batch_size", str(PTV1_B), "--work_dir",
            str(work), "--output", str(out_npz)])
        batches = -(-PTV1_FRAMES // PTV1_B)
        check_launches("serve ptv1", counts, knn=9 * batches,
                       fps=4 * batches, three_nn=4 * batches,
                       joint_fit=batches, vector_attention=18 * batches)
        got = np.load(out_npz)
        if got["R"].shape != (PTV1_FRAMES, cfg.n_max_parts, 3, 3) or not \
                np.isfinite(got["R"]).all():
            raise AssertionError(f"[cli serve ptv1] R {got['R'].shape}, "
                                 f"finite {np.isfinite(got['R']).all()}")
        pred = PosePredictor(cfg, work_dir=str(work), device=dev)
        clouds = np.random.RandomState(0).rand(
            PTV1_B, PTV1_N, 3).astype(np.float32)
        for _ in range(3):               # eager, capture; then a replay
            pred(clouds)
        stages = pred.stage_ms()
        split = {"knn": 0.0, "attn": 0.0, "rest": 0.0}
        for name, ms in stages.items():
            if name.startswith("ptv1."):
                kind = name.rsplit(".", 1)[-1]
                split[kind if kind in split else "rest"] += ms
        log(f"[ptv1] serve --synthetic, {PTV1_FRAMES} clouds of {PTV1_N} in "
            f"{seconds:.2f} s through the command; launches {counts}; a "
            f"replayed call's device ms: backbone k-NN {split['knn']:.3f}, "
            f"attention {split['attn']:.3f}, the rest {split['rest']:.3f}, "
            f"heads {stages['forward']:.3f}, fit "
            f"{sum(v for k, v in stages.items() if k.startswith('fit.')):.3f}"
            f" ({len(stages)} stages)")
    return {"cli serve ptv1": counts}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "articulated_pose_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no articulated_pose_tpu_torch/csrc beside "
              f"{__file__}; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    # the checkout's package, never an installed copy
    sys.path.insert(0, str(ROOT))
    import articulated_pose_tpu_torch  # noqa: F401  (sets TF32 off)
    from articulated_pose_tpu_torch.ops.kernels import KERNELS
    from articulated_pose_tpu_torch.ops.kernels.build import (build_all,
                                                              nvcc_path)
    from articulated_pose_tpu_torch.ops.kernels.probe import PROBE_KERNELS
    from articulated_pose_tpu_torch.timing import card_line

    dev = torch.device("cuda")
    card = card_line()
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"nvcc: {nvcc}")
    for name in ("scipy", "h5py", "matplotlib", "yaml", "pybullet", "cv2"):
        try:
            importlib.import_module(name)
            found = "imports"
        except ImportError as e:
            found = f"does not import ({e})"
        log(f"[host] {name}: {found}")
    from articulated_pose_tpu_torch import native
    try:
        native.load()
        found = "builds and loads"
    except RuntimeError as e:
        found = f"does not build ({e})"
    log(f"[host] native library (labeling, ball renderer; g++): {found}")

    t0 = time.perf_counter()
    # the fourteen kernels and the card-limits probe's (phase 16)
    built = [*KERNELS.values(), *PROBE_KERNELS]
    seconds = build_all(built)
    logs = {k.source: k.build_log() for k in built}
    for source, log_text in sorted(logs.items()):
        log(f"[build] {source}: {seconds[source]:.2f} s")
        for line in ptxas_lines(log_text):
            log(f"[build]   {line}")
    log(f"[build] all sources in parallel: {time.perf_counter() - t0:.2f} s")
    if sys.argv[1:2] == ["--soak"]:
        worlds, steps = (int(x) for x in sys.argv[2:4])
        return mesh_soak(dev, worlds, steps)
    if sys.argv[1:2] == ["--compiled"]:
        with phase("17 compiled programs"):
            compiled_programs(dev)
        return 0
    if sys.argv[1:2] == ["--ptv1"]:
        with phase("18 Point Transformer"):
            ptv1_serve(dev)
            ptv1_knn_times(dev)
        return 0
    if sys.argv[1:2] == ["--joint-fit"]:
        with phase("19 joint_fit"):
            log(json.dumps({"joint_fit": joint_fit_times(dev)}))
        return 0
    if sys.argv[1:2] == ["--vector-attention"]:
        with phase("20 vector_attention"):
            log(json.dumps({"vector_attention": vector_attention_times(
                dev, *sys.argv[2:3])}))
        return 0
    if sys.argv[1:2] == ["--joint-orders"]:
        with phase("19 joint_fit product orders"):
            joint_orders(dev)
        return 0

    with phase("2 kernels"):
        kernels, entries = compare_kernels(dev)
    with phase("3 pose oracle"):
        pose_oracle(dev)
    with phase("4 serve"):
        paths = serve(dev)
    with phase("5 large cloud"):
        paths["large"] = large_cloud(dev)
    with phase("6 bucket"):
        paths.update(bucket_path(dev))
    with phase("7 N-level"):
        paths.update(nlevel_path(dev))
    with phase("8 profiler"):
        paths["profile_stages"], profile_rows = profile_path(dev)
    with phase("9 kernel entries"):
        paths["kernel entries"] = kernel_entries(entries)
    with phase("10 train"):
        paths.update(train_path(dev))
    with phase("11 synthetic e2e"):
        synthetic_card_vs_cpu(dev)
        paths.update(synthetic_e2e(dev))
    with phase("12 CLI"):
        paths.update(cli_path(dev))
    with phase("13 mesh"):
        paths.update(mesh_path(dev))
    with phase("14 reference assets"):
        paths.update(reference_assets(dev))
    with phase("15 accuracy tools"):
        paths.update(accuracy_tools(dev))
    with phase("16 roofline and timing tools"):
        paths.update(timing_tools(dev, profile_rows))
    with phase("17 compiled programs"):
        paths.update(compiled_programs(dev))
    with phase("18 Point Transformer"):
        paths.update(ptv1_serve(dev))
        kernels["knn"] = ptv1_knn_times(dev)
    with phase("19 joint_fit"):
        kernels["joint_fit"] = joint_fit_times(dev)
        joint_orders(dev)
    with phase("20 vector_attention"):
        kernels["vector_attention"] = vector_attention_times(dev)
    for name, k in kernels.items():
        k["launches"] = sum(c[name] for c in paths.values())
        if k["launches"] == 0:
            raise AssertionError(f"{name} was never launched by a path")
    log(f"[paths] launches per path: {json.dumps(paths)}")

    log(card)                       # as nvidia-smi prints it
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name].source_path,
         "replaces": KERNELS[name].replaces, **kernels[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
