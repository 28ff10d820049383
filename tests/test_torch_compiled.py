"""The captured programs (`compiled.py`) and JAX's step builders, on the
CPU.

The CPU has no graphs, so three things stand in for the card here:

- the host-read guard: each body that a program captures on the card
  (the served forward + fit, exact and packed, with the nonlinear fit;
  the train step with dropout on; the fused synthetic step; the eval
  step) runs under a TorchDispatchMode that fails on what a CUDA graph
  cannot hold: a read of a device value on the host, an op whose output
  shape depends on the data, or a copy between devices;
- `make_train_step(jit=False)` / `make_eval_step(jit=False)` against
  JAX's builders, at tests/test_torch_train.py's tolerances;
- the cache's bookkeeping through `StandInGraphs`, the test's stand-in
  for the card's graphs: its capture runs the body once, as a capture
  runs the Python, and its replay runs the body again and leaves the
  launch counts as they were, as a replay runs no Python.  With it the
  CPU takes the card's path through PosePredictor, Trainer.fit and the
  fused step, each equal to the eager run.
"""

import copy
import json

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from articulated_pose_tpu.train import state as jstate
from articulated_pose_tpu_torch.compiled import CardGraphs, compiled
from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.data import device_synthetic as ds
from articulated_pose_tpu_torch.data.batcher import BatchIterator
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.ops.kernels import (KERNELS, launch_counts,
                                                    reset_launch_counts)
from articulated_pose_tpu_torch.pose.pipeline import PoseDraws
from articulated_pose_tpu_torch.serving import PosePredictor, forward_fit
from articulated_pose_tpu_torch.train.routing import (grad_deviations,
                                                      impose_routing,
                                                      pre_bn_biases)
from articulated_pose_tpu_torch.train.state import (TrainState,
                                                    dropout_generator,
                                                    eval_step,
                                                    make_eval_step,
                                                    make_train_step,
                                                    to_device, train_step)
from articulated_pose_tpu_torch.train.trainer import Trainer
from articulated_pose_tpu_torch.utils import profiling
from test_torch_train import (DEV, jax_relu_masks,  # noqa: F401 (fixture)
                              jax_running_stats, jax_side, no_dropout,
                              port_leaves, port_state, running_stats)

N = 256                              # the guard's cloud
SERVE_B = 2


# ------------------------------------------------------------ the guard
# ops a CUDA graph cannot capture: each reads a device value on the host
# or gives an output whose shape depends on the data
HOST_READS = {"_local_scalar_dense", "is_nonzero", "nonzero", "equal",
              "masked_select", "item"}


class HostReadGuard(TorchDispatchMode):
    """Raises at the first op of HOST_READS, any `unique`, or a copy
    between devices; records the names of the ops it let through."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        if name in HOST_READS or name.lstrip("_").startswith("unique"):
            raise AssertionError(f"{name}: a host read or a data-dependent "
                                 "shape, which a graph cannot capture")
        if name.startswith("index") and len(args) > 1 and isinstance(
                args[1], (list, tuple)) and any(
                torch.is_tensor(i) and i.dtype == torch.bool
                for i in args[1]):
            raise AssertionError(f"{name} with a boolean mask: a "
                                 "data-dependent shape")
        if name == "_to_copy" and kwargs.get("device") is not None:
            if torch.device(kwargs["device"]) != args[0].device:
                raise AssertionError(f"a copy from {args[0].device} to "
                                     f"{kwargs['device']}")
        if name == "copy_" and args[0].device != args[1].device:
            raise AssertionError(f"a copy from {args[1].device} to "
                                 f"{args[0].device}")
        self.ops.add(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("read", [
    lambda x: x.sum().item(), lambda x: bool(x[0] > 0),
    lambda x: torch.nonzero(x), lambda x: torch.equal(x, x),
    lambda x: x[x > 0.5], lambda x: torch.unique(x),
    lambda x: x.to("meta")])
def test_the_guard_refuses_host_reads(read):
    x = torch.rand(8)
    with pytest.raises(AssertionError):
        with HostReadGuard():
            read(x)


def serve_setup(packed: bool):
    cfg = NetworkConfig(category="eyeglasses", n_max_parts=3, num_points=N,
                        batch_size=SERVE_B, backbone_preset="tiny",
                        ball_query_packed=packed,
                        compute_dtype="bfloat16" if packed else "float32")
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    pred = PosePredictor(cfg, state_dict=sd, device="cpu")
    P = torch.from_numpy(np.random.RandomState(0).rand(
        SERVE_B, N, 3).astype(np.float32))
    return pred, P


@pytest.mark.parametrize("packed", [False, True])
def test_served_forward_fit_reads_nothing_on_the_host(packed):
    pred, P = serve_setup(packed)
    d = pred.draws(SERVE_B)
    guard = HostReadGuard()
    with torch.no_grad(), guard:
        out = forward_fit(pred.model, P, d.part, d.joint, pred.pose_cfg)
    assert pred.use_nonlinear and "nonlinear_R" in out["fits"]
    assert "linalg_solve_ex" in guard.ops or "_linalg_solve_ex" in guard.ops


def train_setup(batch: int = 2, dropout: float = 0.5):
    cfg = NetworkConfig(category="eyeglasses", n_max_parts=3, num_points=N,
                        batch_size=batch, backbone_preset="tiny",
                        dropout_rate=dropout)
    model = build_model(cfg, torch.Generator().manual_seed(0))
    gen = SyntheticArticulated(n_parts=3, points_per_part=100, seed=0)
    data, _ = gen.batch(np.random.RandomState(0), batch, num_points=N)
    return cfg, model, to_device(data, DEV)


def test_train_step_reads_nothing_on_the_host():
    cfg, model, batch = train_setup()
    assert model.joint_net.dropout_rate > 0
    st = TrainState(model, cfg)
    g = dropout_generator(torch.Generator(), cfg.seed, 0)
    with HostReadGuard():
        m = make_train_step(cfg, jit=False)(st, batch, g)
    assert set(m) >= {"total_loss", "grads_finite", "grad_norm"}


def test_eval_step_reads_nothing_on_the_host():
    cfg, model, batch = train_setup()
    with HostReadGuard():
        make_eval_step(cfg, jit=False)(TrainState(model, cfg), batch)


def fused_setup():
    cfg = NetworkConfig(category="eyeglasses", n_max_parts=3, num_points=N,
                        batch_size=2, backbone_preset="tiny")
    gen = SyntheticArticulated(n_parts=3, points_per_part=200, seed=0)
    dg = ds.DeviceSynthetic(gen, num_points=N, device="cpu")
    return cfg, dg, build_model(cfg, torch.Generator().manual_seed(0))


def test_fused_step_reads_nothing_on_the_host():
    cfg, dg, model = fused_setup()
    fused = ds.make_fused_synthetic_train_step(cfg, dg, 2, jit=False)
    with HostReadGuard():
        fused(TrainState(model, cfg), 0)


# ------------------------------------------------------- against JAX's
def test_make_train_step_matches_jax(jax_side):
    """One step of `make_train_step(jit=False)` against JAX's
    `make_train_step(config, jit=False)` from the same state, dropout off,
    JAX's ReLU masks imposed (tests/test_torch_train.py): every loss and
    the grad norm within rtol 1e-5, the batch statistics within 1e-5 of
    their largest entry, the first moment (0.1 of the gradient) of each
    leaf within 1e-4 of its largest entry, a pre-batch-norm bias within
    1e-4 of its layer's weight's, the counts equal."""
    # JAX's step as the builder gives it with jit=False, compiled here only
    # to keep the test short
    step = jax.jit(jstate.make_train_step(jax_side["cfg"], jit=False))
    with fnn.intercept_methods(no_dropout):
        new, m = step(jax_side["state0"], jax_side["batch"],
                      jax.random.PRNGKey(0))
    st = port_state(jax_side["state0"])
    handles = impose_routing(st.model, jax_relu_masks(jax_side))
    pm = make_train_step(st.config, jit=False)(st, jax_side["batch"])
    for h in handles:
        h.remove()
    assert set(pm) == set(m)
    for k in m:
        np.testing.assert_allclose(float(pm[k]), float(m[k]), rtol=1e-5,
                                   err_msg=k)
    adam = new.opt_state.inner_state[0]
    assert int(st.opt.count) == int(adam.count) == 1
    assert int(st.step) == int(new.step) == 1
    got_bs = running_stats(st.model)
    for k, v in jax_running_stats(new.batch_stats).items():
        np.testing.assert_allclose(got_bs[k].numpy(), v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)
    want = port_leaves(adam.mu)
    got = dict(zip(st.names, (t.numpy() for t in st.opt.mu)))
    zero = pre_bn_biases(st.model)
    for _, name, err, scale in grad_deviations(got, want, zero):
        if name in zero:
            assert np.abs(got[name]).max() <= 1e-4 * scale, name
            continue
        assert err <= 1e-4 * scale + 1e-8, (name, err, scale)


def test_make_eval_step_matches_jax(jax_side):
    """`make_eval_step(jit=False)` against JAX's `make_eval_step(config,
    jit=False)`: the losses within rtol 1e-5, each prediction within 1e-4
    of its largest entry, nothing of the state changed."""
    jpred, jm = jstate.make_eval_step(jax_side["cfg"], jit=False)(
        jax_side["state0"], jax_side["batch"])
    st = port_state(jax_side["state0"])
    before = copy.deepcopy(st.model.state_dict())
    pred, m = make_eval_step(st.config, jit=False)(st, jax_side["batch"])
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for k, v in jpred.items():
        v = np.asarray(v)
        np.testing.assert_allclose(pred[k].numpy(), v, rtol=0,
                                   atol=1e-4 * max(np.abs(v).max(), 1e-30),
                                   err_msg=k)
    for k, v in st.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert int(st.step) == 0


def test_jit_false_is_the_eager_step():
    cfg = NetworkConfig()
    assert make_train_step(cfg, jit=False) is train_step
    assert make_eval_step(cfg, jit=False) is eval_step


# ---------------------------------------------------- the cache, stand-in
class StandInGraph:
    """A captured body: replay runs it again, the launch counts left as
    they were, and writes its outputs into the captured ones."""

    def __init__(self, graphs, body, outputs):
        self.graphs, self.body, self.outputs = graphs, body, outputs

    def replay(self):
        self.graphs.replays += 1
        counts = launch_counts()
        new = self.body()
        for k, n in counts.items():
            KERNELS[k].launches = n
        for a, b in zip(pytree.tree_leaves(self.outputs),
                        pytree.tree_leaves(new)):
            if torch.is_tensor(a):
                a.copy_(b)


class StandInEvent:
    """A timing event on the CPU: the order it was made in stands for its
    time, in ms."""

    def __init__(self, graphs):
        self.at = len(graphs.events)
        graphs.events.append(self)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


class StandInGraphs:
    """The card's graphs on the CPU: `applies` everywhere, warm-up on the
    calling thread, capture as StandInGraph, events as StandInEvent;
    `fail` makes the capture raise.  A capture changes nothing, as a
    graph's runs no kernel: it puts back the train states in `keep` and
    the generators it registers as they were.  Records each capture's
    generators and every event asked for, and counts the replays."""

    def __init__(self):
        self.fail = False
        self.keep = []
        self.captures = []
        self.events = []
        self.replays = 0

    def applies(self, device):
        return True

    def warm_up(self, device, body):
        return body()

    def capture(self, device, body, generators):
        states = [copy.deepcopy(st.state_dict()) for st in self.keep]
        seeds = [g.get_state() for g in generators]
        out = body()
        for st, sd in zip(self.keep, states):
            st.load_state_dict(sd)
        for g, seed in zip(generators, seeds):
            g.set_state(seed)
        self.captures.append(list(generators))
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return StandInGraph(self, body, out), out, 0

    def event(self, device):
        return StandInEvent(self)


@pytest.fixture
def stand_in(monkeypatch):
    """Every program made in the test captures through StandInGraphs."""
    graphs = StandInGraphs()
    for name in ("applies", "warm_up", "capture", "event"):
        monkeypatch.setattr(CardGraphs, name,
                            lambda self, *a, _n=name: getattr(graphs, _n)(*a))
    return graphs


def launching(name="fps2"):
    """A body that launches kernel `name` once, as its wrapper counts."""
    calls = []

    def fn(x, y, scale=2):
        KERNELS[name].launches += 1
        calls.append(1)
        return {"sum": x + y, "scaled": x * scale}

    return fn, calls


def test_one_capture_a_signature_and_a_second_for_a_second_shape(stand_in):
    fn, calls = launching()
    prog = compiled(fn)
    a = prog(torch.ones(3), torch.ones(3))
    b = prog(torch.full((3,), 2.0), torch.ones(3))
    assert len(prog.captured) == 1
    entry = next(iter(prog.captured.values()))
    assert entry.replays == 1
    assert torch.equal(b["sum"], torch.full((3,), 3.0))
    prog(torch.ones(4), torch.ones(4))
    assert len(prog.captured) == 2
    prog(torch.ones(3), torch.ones(3), 3)        # a by-value leaf
    assert len(prog.captured) == 3
    assert torch.equal(a["scaled"], torch.full((3,), 2.0))


def test_a_returned_result_survives_the_next_call(stand_in):
    fn, _ = launching()
    prog = compiled(fn)
    prog(torch.zeros(3), torch.zeros(3))
    first = prog(torch.ones(3), torch.ones(3))
    second = prog(torch.full((3,), 5.0), torch.ones(3))
    assert torch.equal(first["sum"], torch.full((3,), 2.0))
    assert torch.equal(second["sum"], torch.full((3,), 6.0))
    assert first["sum"].data_ptr() != second["sum"].data_ptr()


def test_each_replay_adds_the_captured_launches(stand_in):
    fn, calls = launching("three_nn")
    prog = compiled(fn)
    reset_launch_counts()
    prog(torch.ones(3), torch.ones(3))          # the run; the capture
    assert launch_counts()["three_nn"] == 1     # taken back
    assert len(calls) == 2
    for i in range(3):
        prog(torch.ones(3), torch.ones(3))
        assert launch_counts()["three_nn"] == 2 + i
    assert next(iter(prog.captured.values())).launches["three_nn"] == 1
    reset_launch_counts()


def test_a_capture_error_propagates(stand_in):
    fn, _ = launching()
    stand_in.fail = True
    prog = compiled(fn)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="capturing"):
        prog(torch.ones(3), torch.ones(3))
    assert not prog.captured
    assert launch_counts()["fps2"] == 1         # the run's, not the capture's
    with pytest.raises(RuntimeError, match="capturing"):
        prog(torch.ones(3), torch.ones(3))
    reset_launch_counts()


def test_generators_are_registered_and_objects_key_by_identity(stand_in):
    prog = compiled(lambda m, x, g: m(x) + torch.rand(x.shape, generator=g))
    g = torch.Generator()
    m1, m2 = torch.nn.Identity(), torch.nn.Identity()
    prog(m1, torch.zeros(2), g)
    prog(m1, torch.zeros(2), g)
    prog(m2, torch.zeros(2), g)
    assert len(prog.captured) == 2
    assert stand_in.captures == [[g], [g]]


def test_the_cpu_runs_the_body_as_it_is():
    fn, calls = launching()
    prog = compiled(fn)
    for _ in range(3):
        prog(torch.ones(3), torch.ones(3))
    assert len(calls) == 3 and not prog.captured


def test_arguments_name_one_device(stand_in):
    prog = compiled(lambda x, y: x + y)
    with pytest.raises(ValueError, match="one device"):
        prog(torch.ones(2), torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="know its device"):
        compiled(lambda n: n)(3)


@pytest.mark.parametrize("packed", [False, True])
def test_predictor_replays_equal_eager(stand_in, packed):
    """PosePredictor through the stand-in: a capture at the first call,
    replays after, every output equal to the eager forward + fit on the
    same clouds and draws, the caller's draws copied in."""
    pred, P = serve_setup(packed)
    clouds = np.random.RandomState(1).rand(4, SERVE_B, N, 3).astype(
        np.float32)
    d = pred.draws(SERVE_B)
    for c in clouds:
        got = pred._run(c)[0]
        with torch.no_grad():
            want = forward_fit(pred.model, torch.from_numpy(c), d.part,
                               d.joint, pred.pose_cfg)
        for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
            assert torch.equal(a, b)
    assert [e.replays for e in pred._programs[0].captured.values()] == [3]
    other = PoseDraws.sample(SERVE_B, pred.pose_cfg,
                             torch.Generator().manual_seed(9))
    got = pred(clouds[0], draws=other)
    want = PosePredictor(pred.config, state_dict=pred.model.state_dict(),
                         device="cpu")(clouds[0], draws=other)
    np.testing.assert_array_equal(got.R, want.R)
    np.testing.assert_array_equal(got.t, want.t)


def test_trainer_fit_replays_equal_eager(stand_in, tmp_path):
    """Trainer.fit through the stand-in: the dropout generator reseeded
    on the host before each replay, so 4 steps equal 4 eager steps bit
    for bit, metrics and state."""
    cfg, model, _ = train_setup(batch=2)
    cfg = cfg.replace(snapshot_interval=0, val_interval=0)
    gen = SyntheticArticulated(n_parts=3, points_per_part=100, seed=0)
    rng = np.random.RandomState(0)
    frames = [gen.frame(rng, num_points=N)[0] for _ in range(4)]
    def batches():
        return BatchIterator(4, lambda i: frames[i], 2, shuffle=True, seed=0)

    eager = TrainState(copy.deepcopy(model), cfg)
    tr = Trainer(model, cfg, work_dir=str(tmp_path), device="cpu")
    stand_in.keep.append(tr.state)
    tr.fit(batches(), n_epochs=2, log_every=1)
    g = torch.Generator()
    step = 0
    it = batches()
    for _ in range(2):
        for batch in it:
            train_step(eager, batch, dropout_generator(g, cfg.seed, step))
            step += 1
    assert int(tr.state.step) == step == 4
    for a, b in zip(pytree.tree_leaves(tr.state.state_dict()),
                    pytree.tree_leaves(eager.state_dict())):
        assert torch.equal(a, b)
    assert len(stand_in.captures) == 1 and stand_in.replays == 3


def test_fused_step_replays_equal_eager(stand_in):
    """The fused step through the stand-in, a window of 3 steps a call:
    each step a replay after the host reseeds both generators, the state
    equal to the eager fused step's bit for bit."""
    cfg, dg, model = fused_setup()
    states = [TrainState(model, cfg), TrainState(copy.deepcopy(model), cfg)]
    stand_in.keep.append(states[0])
    fused = ds.make_fused_synthetic_train_step(cfg, dg, 2, steps_per_call=3)
    eager = ds.make_fused_synthetic_train_step(cfg, dg, 2, steps_per_call=3,
                                               jit=False)
    m = [fused(states[0], 0), fused(states[0], 3)]
    w = [eager(states[1], 0), eager(states[1], 3)]
    for got, want in ((m, w), (states[0].state_dict(),
                               states[1].state_dict())):
        for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
            assert torch.equal(a, b)
    assert len(stand_in.captures) == 1
    assert len(stand_in.captures[0]) == 2       # data and dropout


# ---------------------------------------- spans, counters, stage events
SERVE_STAGES = ["forward", "fit.partition", "fit.ransac", "fit.joint"]


def user_spans(log_dir):
    """(name, start, end) of the trace's host ranges, in start order."""
    events = json.loads((log_dir / profiling.TRACE_FILE).read_text())
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"])
                   for e in events["traceEvents"]
                   if e.get("cat") == "user_annotation"),
                  key=lambda sp: sp[1])


def inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def test_a_capture_marks_the_served_stages_and_a_replay_reads_them(
        stand_in):
    """The capture asks for the start's event and the four stage marks'
    in order; the eager first run and the replays ask for none.  Before a
    replay there is nothing to read; after one, each stage's time."""
    pred, P = serve_setup(False)
    clouds = P.numpy()
    pred(clouds)
    program = pred._programs[0]
    entry = next(iter(program.captured.values()))
    assert [name for name, _ in entry.stages] == ["start"] + SERVE_STAGES
    assert len(stand_in.events) == 5 and program.captures == 1
    assert pred.stage_ms() == {}
    pred(clouds)
    pred(clouds)
    assert len(stand_in.events) == 5 and program.captures == 1
    assert pred.stage_ms() == {name: 1.0 for name in SERVE_STAGES}


def test_an_eager_call_marks_no_stage():
    """On the CPU a program runs its body as it is: no event is asked
    for and there is nothing to read."""
    pred, P = serve_setup(False)
    pred(P.numpy())
    pred(P.numpy())
    assert pred._programs[0].captures == 0 and pred.stage_ms() == {}


def test_a_served_call_spans_its_parts_in_order(stand_in, tmp_path):
    """Under a trace a call is "predictor.call call=<n>" holding the
    copy in, the program, every field's copies out queued, then the
    wait, in that order, each of the predictor's carrying the call's
    index; nothing joins the fields after the wait."""
    pred, P = serve_setup(False)
    clouds = P.numpy()
    pred(clouds)                                   # call 0, the capture
    with profiling.trace(str(tmp_path)):
        pred(clouds)
    spans = [sp for sp in user_spans(tmp_path)
             if not sp[0].startswith("kernel:")]
    names = [sp[0] for sp in spans]
    assert names == ["predictor.call call=1", "predictor.h2d",
                     "program.replay", "predictor.d2h call=1",
                     "predictor.wait call=1"]
    assert all(inside(sp, spans[0]) for sp in spans[1:])
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))
    assert pred.calls == 2


def test_the_predictor_counts_the_bytes_it_copies(stand_in):
    pred, P = serve_setup(False)
    clouds = P.numpy().astype(np.float64)
    out = [pred(clouds), pred(clouds)]
    arrays = [out[0].R, out[0].scale, out[0].t, out[0].segmentation,
              out[0].part_counts, *out[0].raw.values()]
    assert pred.calls == 2
    assert pred.d2h_bytes == 2 * sum(a.nbytes for a in arrays)


def test_the_fused_step_spans_its_reseeds_and_marks_its_stages(
        stand_in, tmp_path):
    """Each step's reseed is "fused.reseed step=<n>", followed by the
    program's capture or replay; the capture marks the draw and the
    step, which a replay reads."""
    cfg, dg, model = fused_setup()
    st = TrainState(model, cfg)
    stand_in.keep.append(st)
    fused = ds.make_fused_synthetic_train_step(cfg, dg, 2, steps_per_call=2)
    with profiling.trace(str(tmp_path)):
        fused(st, 0)
    names = [sp[0] for sp in user_spans(tmp_path)
             if not sp[0].startswith("kernel:")]
    assert names == ["fused.reseed step=0", "program.capture",
                     "fused.reseed step=1", "program.replay"]
    entry = next(iter(fused.program.captured.values()))
    assert [name for name, _ in entry.stages] == ["start", "datagen", "step"]
    assert fused.program.stage_ms() == {"datagen": 1.0, "step": 1.0}
