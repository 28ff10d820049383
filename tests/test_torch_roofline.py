"""The roofline accounting (`articulated_pose_tpu_torch/roofline.py`)
against the JAX package's forward, against the kernel bounds that
chip_smoke.py's phase 2 computed before it took them from roofline.py,
and rule by rule on small programs.

- GEMM FLOPs: the port's forward counts, exactly, 2·∏ over each
  `dot_general` of `jax.make_jaxpr` of JAX's `model.apply(...,
  train=False)` that multiplies by a parameter (a Dense kernel, through
  its casts), sub-jaxprs walked.  The distance expansions of JAX's XLA
  tiers (articulated_pose_tpu/ops/core.py:35-51) are `dot_general`s of
  the cloud alone, so they fall out: they are the kernels' work, which
  the kernels' work functions count.
- Compulsory bytes: the port's equal JAX's input + variables + output
  bytes, exactly.
- JAX's `cost_analysis()` totals are printed beside the port's, not
  held: the two count by different rules.

Tiny widths (tests/test_torch_models.py's), B=2, N=256, on the CPU.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

from articulated_pose_tpu.models.ancsh import ANCSHModel as JaxANCSHModel
from articulated_pose_tpu.models.pointnet2 import BackboneSpec as JaxSpec
from articulated_pose_tpu_torch import roofline
from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
from articulated_pose_tpu_torch.models.layers import init_weights
from articulated_pose_tpu_torch.models.pointnet2 import (TINY_WIDTHS,
                                                         BackboneSpec)
from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels import (ball_query, build, fps,
                                                    three_nn)
from test_torch_backbone import THREE_LEVEL

B, N = 2, 256
# (backbone widths, ball-query tier, packed, compute dtype)
CASES = {
    "exact": (TINY_WIDTHS, "xla", False, "float32"),
    "exact_bf16": (TINY_WIDTHS, "xla", False, "bfloat16"),
    "packed": (TINY_WIDTHS, "pallas", True, "bfloat16"),
    "bucket": (TINY_WIDTHS, "bucket", False, "float32"),
    "three_level": (THREE_LEVEL, "xla", False, "float32"),
}
# the casts and reshapes through which a Dense kernel reaches its dot
PASS_THROUGH = ("convert_element_type", "reshape", "transpose",
                "broadcast_in_dim", "copy", "squeeze", "expand_dims")


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def param_dot_flops(jaxpr, params) -> int:
    """2·∏ over the dot_generals of `jaxpr` with an operand derived from
    `params` (its vars), each dimension counted once: the batch and
    free dimensions of both operands and the contracted ones."""
    derived, total = set(params), 0
    for eqn in jaxpr.eqns:
        ins = [v for v in eqn.invars if isinstance(v, jcore.Var)]
        hit = any(v in derived for v in ins)
        if eqn.primitive.name == "dot_general":
            if hit:
                (_, rc), (_, rb) = eqn.params["dimension_numbers"]
                a, b = (v.aval.shape for v in eqn.invars)
                total += 2 * math.prod(a) * math.prod(
                    d for i, d in enumerate(b) if i not in rc and i not in rb)
            continue
        subs = list(_sub_jaxprs(eqn))
        for sub in subs:
            inner = {iv for ov, iv in zip(eqn.invars, sub.invars)
                     if isinstance(ov, jcore.Var) and ov in derived}
            total += param_dot_flops(sub, inner)
        if hit and not subs and eqn.primitive.name in PASS_THROUGH:
            derived.update(eqn.outvars)
    return total


def _models(case):
    widths, impl, packed, dtype = CASES[case]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jmodel = JaxANCSHModel(dtype=jdt, backbone_spec=JaxSpec(
        ball_query_impl=impl, ball_query_packed=packed, **widths))
    model = init_weights(ANCSHModel(dtype=tdt, backbone_spec=BackboneSpec(
        ball_query_impl=impl, ball_query_packed=packed, **widths)),
        torch.Generator().manual_seed(0)).eval()
    return jmodel, model


@pytest.fixture(scope="module")
def counted():
    """case -> (JAX's jaxpr, variables and output shapes, the port's
    Count of the same forward)."""
    P = np.random.RandomState(5).rand(B, N, 3).astype(np.float32)
    out = {}
    for case in CASES:
        jmodel, model = _models(case)
        x = jax.ShapeDtypeStruct((B, N, 3), jnp.float32)
        variables = jax.eval_shape(
            lambda p: jmodel.init(jax.random.PRNGKey(0), p, train=False), x)
        closed = jax.make_jaxpr(
            lambda v, p: jmodel.apply(v, p, train=False))(variables, x)
        outputs = jax.eval_shape(
            lambda v, p: jmodel.apply(v, p, train=False), variables, x)
        with torch.no_grad():
            count = roofline.count(lambda: model(torch.from_numpy(P)))
        out[case] = (closed, variables, outputs, count, jmodel, P)
    return out


def _nbytes(tree) -> int:
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("case", list(CASES))
def test_gemm_flops_equal_jax_parameter_dots(counted, case):
    closed, variables, _, count, jmodel, P = counted[case]
    n_params = len(jax.tree.leaves(variables))
    want = param_dot_flops(closed.jaxpr, closed.jaxpr.invars[:n_params])
    assert want > 0
    assert count.gemm == want
    dtype = CASES[case][3]
    assert set(count.gemm_flops) == {dtype}
    # XLA's own totals, beside the port's (not held: other rules)
    v = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), variables)
    cost = jax.jit(lambda v, p: jmodel.apply(v, p, train=False)).lower(
        v, jnp.asarray(P)).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    print(f"{case}: JAX cost_analysis flops {cost.get('flops', 0.0):.0f}, "
          f"bytes accessed {cost.get('bytes accessed', 0.0):.0f}; port "
          f"GEMM {count.gemm:.0f}, all {count.flops:.0f} FLOPs, launched "
          f"{count.launched_bytes:.0f} B")


@pytest.mark.parametrize("case", list(CASES))
def test_compulsory_bytes_equal_jax_inputs_variables_outputs(counted, case):
    _, variables, outputs, count, _, _ = counted[case]
    want = B * N * 3 * 4 + _nbytes(variables) + _nbytes(outputs)
    assert count.compulsory_bytes == want
    assert count.launched_bytes > count.compulsory_bytes


def test_forward_counts_its_kernels_once_each(counted):
    *_, count, _, _ = counted["packed"]
    assert count.kernels == {"fps2": 1, "ball_query_group_packed": 2,
                             "three_nn": 2}
    assert counted["three_level"][3].kernels == {"fps": 3,
                                                 "ball_query_group": 3,
                                                 "three_nn": 3}
    assert counted["bucket"][3].kernels == {"fps2": 1,
                                            "ball_query_group_bucket": 2,
                                            "three_nn": 2}


# ---------------------------------------- the kernels' work functions
# chip_smoke.py phase 2's formulas before it took them from roofline.py
# (the kernels' FLOPs: 9 a (query, point) pair, 5 a point's norm, 10 a
# 3-NN pair, 10 a point an FPS step, 30 a point for the quantiser), and
# its bytes: each input and output tensor once
def _old_fps2(B, N):
    return (B * (511 * N + 127 * 512) * 10,
            4 * (B * N * 3 + B * 512 * 3 + B * 128 * 3) + 4 * B * (512 + 128))


def _old_fps(B, N, npoint):
    return B * (npoint - 1) * N * 10, 4 * (B * N * 3 + B * npoint * 4)


def _old_grouping(B, N, M, S, emit, pairs, point_flops):
    return (pairs * 9 + B * N * point_flops + B * M * 5,
            4 * (B * N * 3 + B * M * 3 + B * M * S * 3 + B * M
                 + (B * M * S if emit else 0)))


def _old_idx(B, N, M, S, pairs):
    return (pairs * 9 + (B * N + B * M) * 5,
            4 * (B * N * 3 + B * M * 3 + B * M * S + B * M))


def _old_nn(B, N, M):
    return (B * N * M * 10 + B * (N + M) * 5,
            4 * (B * N * 3 + B * M * 3 + B * N * 3 + B * N * 3))


FPS2_SHAPES = [(16, 2048), (4, 32768)]
FPS_SHAPES = [(16, 2048, 512), (8, 8192, 1024), (8, 1024, 256),
              (8, 256, 64), (8, 64, 16), (64, 2048, 512), (64, 512, 128),
              (16, 1024, 512), (16, 512, 128)]
# (B, N, M, S, emit_idx) of SA1 and SA2 at the serving batch, bench.py's
# and the joint baseline's
GROUP_SHAPES = [(16, 2048, 512, 64, False), (16, 512, 128, 64, True),
                (64, 2048, 512, 64, False), (64, 512, 128, 64, True),
                (16, 1024, 512, 32, False), (16, 512, 128, 64, True)]
IDX_SHAPES = [(4, 32768, 512, 64), (4, 512, 128, 64), (64, 2048, 512, 64),
              (64, 512, 128, 64)]
NN_SHAPES = [(16, 512, 128), (16, 2048, 512), (64, 512, 128),
             (64, 2048, 512), (4, 512, 128), (4, 32768, 512), (8, 64, 16),
             (8, 8192, 1024), (4, 2048, 16384), (4, 2048, 3000)]
PAIRS = 123457


def _pair(work):
    return work.flops, work.bytes


@pytest.mark.parametrize("B,N", FPS2_SHAPES)
def test_fps2_work_is_phase_2s(B, N):
    assert _pair(roofline.fps2_work(B, N, 512, 128)) == _old_fps2(B, N)


@pytest.mark.parametrize("B,N,npoint", FPS_SHAPES)
def test_fps_work_is_phase_2s(B, N, npoint):
    assert _pair(roofline.fps_work(B, N, npoint)) == _old_fps(B, N, npoint)


@pytest.mark.parametrize("name,point_flops", [
    ("ball_query_group", 5), ("ball_query_group_packed", 35),
    ("ball_query_point_grouped", 5), ("ball_query_group_bucket", 5)])
@pytest.mark.parametrize("shape", GROUP_SHAPES)
def test_grouped_ball_query_work_is_phase_2s(name, point_flops, shape):
    B, N, M, S, emit = shape
    pairs = B * M * N if name.endswith("bucket") else PAIRS
    assert _pair(roofline.ball_query_work(name, B, N, M, S, emit, pairs)) \
        == _old_grouping(B, N, M, S, emit, pairs, point_flops)


@pytest.mark.parametrize("name", ["ball_query_idx", "ball_query_point"])
@pytest.mark.parametrize("shape", IDX_SHAPES)
def test_idx_ball_query_work_is_phase_2s(name, shape):
    B, N, M, S = shape
    assert _pair(roofline.ball_query_work(name, B, N, M, S, True, PAIRS)) \
        == _old_idx(B, N, M, S, PAIRS)


@pytest.mark.parametrize("shape", NN_SHAPES)
def test_three_nn_work_is_phase_2s(shape):
    assert _pair(roofline.three_nn_work(*shape)) == _old_nn(*shape)


def test_bound_is_phase_2s():
    w = roofline.fps2_work(16, 2048, 512, 128)
    ops, byt = roofline.bound(w)
    assert ops == w.flops / 67e12 * 1e3 and byt == w.bytes / 3.35e12 * 1e3


# ------------------------------------------ the kernel entries' hook
def _cloud(seed, b, n):
    return torch.from_numpy(np.random.RandomState(seed).rand(b, n, 3)
                            .astype(np.float32))


ENTRY_CALLS = {
    "fps2": lambda P, Q: fps.fps2(P, 32, 8),
    "fps": lambda P, Q: fps.fps(P, 32),
    "ball_query_group": lambda P, Q: ball_query.ball_query_group(
        0.3, 16, P, Q, emit_idx=False),
    "ball_query_group_packed": lambda P, Q:
        ball_query.ball_query_group_packed(0.3, 16, P, Q),
    "ball_query_point_grouped": lambda P, Q:
        ball_query.ball_query_point_grouped(0.3, 16, P, Q),
    "ball_query_idx": lambda P, Q: ball_query.ball_query_idx(0.3, 16, P, Q),
    "ball_query_point": lambda P, Q: ball_query.ball_query_point(
        0.3, 16, P, Q),
    "ball_query_group_bucket": lambda P, Q:
        ball_query.ball_query_group_bucket(0.3, 16, P, Q, False),
    "three_nn": lambda P, Q: three_nn.three_nn(P, Q),
    "three_nn_stream": lambda P, Q: three_nn.three_nn_stream(P, Q),
    "three_nn_packed": lambda P, Q: three_nn.three_nn_packed(P, Q),
}


@pytest.mark.parametrize("name", list(ENTRY_CALLS))
def test_entry_counts_its_work_function_and_nothing_inside(name):
    """Under a counter an entry counts its work function's FLOPs and
    bytes, and none of the plain version's ops it ran on the CPU; a
    first-S query counts the points its hits say it examined."""
    P, Q = _cloud(1, 2, 256), _cloud(2, 2, 32)
    count = roofline.count(lambda: ENTRY_CALLS[name](P, Q))
    assert count.ops == 0 and count.gemm == 0 and count.other_flops == 0
    assert count.kernels == {name: 1}
    if name == "fps2":
        want = roofline.fps2_work(2, 256, 32, 8)
    elif name == "fps":
        want = roofline.fps_work(2, 256, 32)
    elif name.startswith("three_nn"):
        want = roofline.three_nn_work(2, 256, 32)
    else:
        emit = name not in ("ball_query_group", "ball_query_group_bucket")
        if name.endswith("bucket"):
            pairs = 2 * 32 * 256
        else:
            idx, cnt = core.query_ball_point(0.3, 16, P, Q)
            pairs = roofline.scanned_points(idx, cnt, 256)[0]
            assert 0 < pairs < 2 * 32 * 256
        want = roofline.ball_query_work(name, 2, 256, 32, 16, emit, pairs)
    assert count.kernel_flops == want.flops
    assert count.launched_bytes == want.bytes
    assert build.COUNTERS == []


@pytest.mark.parametrize("name", ["ball_query_group",
                                  "ball_query_group_packed"])
def test_grouped_query_without_idx_counts_its_own_plain_hits(name):
    """A grouped first-S entry called without idx (the served forward's
    SA1) counts the points that its own plain version's hits say it
    examined: the same work as the call with idx, less the idx it does
    not write."""
    P, Q = _cloud(1, 2, 256), _cloud(2, 2, 32)
    entry = getattr(ball_query, name)
    without = roofline.count(lambda: entry(0.3, 16, P, Q, emit_idx=False))
    with_idx = roofline.count(lambda: entry(0.3, 16, P, Q, emit_idx=True))
    _, cnt, idx = getattr(ball_query, f"{name}_plain")(0.3, 16, P, Q)
    pairs = roofline.scanned_points(idx, cnt, 256)[0]
    want = roofline.ball_query_work(name, 2, 256, 32, 16, False, pairs)
    assert without.kernel_flops == want.flops == with_idx.kernel_flops
    assert without.launched_bytes == want.bytes
    assert with_idx.launched_bytes - without.launched_bytes == 4 * 2 * 32 * 16


def test_entries_outside_a_counter_are_the_wrappers():
    P, Q = _cloud(1, 2, 256), _cloud(2, 2, 32)
    got = three_nn.three_nn(P, Q)
    want = three_nn.three_nn_plain(P, Q)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert three_nn.three_nn.__wrapped__ is not None


# ----------------------------------------------- the counter's rules
def test_gemm_pointwise_reduction_and_views():
    a = torch.rand(8, 16)
    w = torch.rand(4, 16)
    count = roofline.count(lambda: (torch.nn.functional.linear(a, w).relu()
                                    .sum(-1), a.t()[0]))
    assert count.gemm_flops == {"float32": 2 * 8 * 4 * 16}
    # relu: 32 outputs; sum: 32 elements read
    assert count.other_flops == 32 + 32
    # a and w read, then the (8,) sum and the view of a returned; the
    # view's storage is an input: read, never written
    assert count.compulsory_bytes == 4 * (8 * 16 + 4 * 16 + 8)


def test_in_place_writes_of_inputs_are_compulsory_once():
    x = torch.rand(100)
    y = torch.rand(100)

    def program():
        x.add_(y)
        x.mul_(2.0)

    count = roofline.count(program)
    # x read and written, y read: once each
    assert count.compulsory_bytes == 3 * 400
    # add_: x and y; mul_: x
    assert count.launched_bytes == 3 * 400
    assert count.other_flops == 200 and count.ops == 2


def test_inference_mode_counts_as_no_grad():
    model = init_weights(ANCSHModel(backbone_spec=BackboneSpec(
        **TINY_WIDTHS)), torch.Generator().manual_seed(0)).eval()
    P = _cloud(3, 2, 128)
    with torch.no_grad():
        a = roofline.count(lambda: model(P))
    with torch.inference_mode():
        b = roofline.count(lambda: model(P))
    assert roofline.same_counts(a, b)


def test_floors_bind_by_the_larger():
    c = roofline.Count(gemm_flops={"bfloat16": 989e9, "float32": 67e9},
                       other_flops=0.0, kernel_flops=0.0, launched_bytes=0.0,
                       compulsory_bytes=3.35e9, ops=0, kernels={},
                       top_ops={})
    f = c.floors()
    # 1 ms of bf16 GEMMs + 1 ms of f32 against 1 ms of bytes
    assert f["ops_ms"] == pytest.approx(2.0)
    assert f["bytes_ms"] == pytest.approx(1.0)
    assert f["floor_ms"] == f["ops_ms"] and f["bound_by"] == "operations"
    f = c.floors(f32_flops=134e12, hbm=1.0e12)
    assert f["ops_ms"] == pytest.approx(1.5)
    assert f["bound_by"] == "bytes" and f["floor_ms"] == pytest.approx(3.35)


def test_cpu_run_counts_every_stage_at_tiny_widths(capsys):
    res = roofline.run(batch=2, points=128, train_batch=2, train_points=128,
                       device="cpu", spec=BackboneSpec(**TINY_WIDTHS),
                       train_spec=BackboneSpec(**TINY_WIDTHS))
    assert [r["stage"] for r in res["rows"]] == ["forward", "pose", "fps",
                                                 "ballq", "threenn", "train"]
    assert res["card"] is None
    rows = {r["stage"]: r for r in res["rows"]}
    assert rows["forward"]["kernels"] == {"fps2": 1,
                                          "ball_query_group_packed": 2,
                                          "three_nn": 2}
    assert rows["train"]["kernels"] == {"fps2": 1, "ball_query_group": 2,
                                        "three_nn": 2}
    # the train step reads and writes the parameters and both moments
    assert rows["train"]["compulsory_mb"] > rows["forward"]["compulsory_mb"]
    assert rows["pose"]["ops"] > 1000
    out = capsys.readouterr().out
    assert "pose fit (production cfg)" in out


def test_without_a_card_it_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="roofline: device cuda is not "
                       "available"):
        roofline.main([])
