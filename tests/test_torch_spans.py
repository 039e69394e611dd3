"""The port's named spans (``dpilqr_tpu_torch.utils.profiling.span``) on the
CPU: a shared no-op outside a profiler; under a ``torch.profiler`` session
the RHC loop's, the decomposed solve's, the trial layer's and the batched
driver's sections as nested host ranges, one ``.read`` range a
device-to-host read; the graph cache's lookup counters.  The ``cuda`` case
holds a replayed iteration's ranges against its kernels on the profiler's
one clock and skips without a card."""

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.parallel import rhc
from dpilqr_tpu_torch.parallel.mesh import stack_costs
from dpilqr_tpu_torch.utils import profiling
from test_torch_batched_graph import K, N, problem, rehearsal  # noqa: F401

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^dpilqr\.(rhc|distributed|mesh|batched)\.[a-z_]+$")


def _spans(prof):
    """The program's ranges of a finished session, in start order."""
    return sorted((e for e in prof.events() if e.name.startswith("dpilqr.")),
                  key=lambda e: e.time_range.start)


def _parent(e):
    """The innermost program range around ``e``."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("dpilqr."):
        p = p.cpu_parent
    return p


def _count(spans, name):
    return sum(e.name == name for e in spans)


def _fleet_cost(n, seed):
    x0, xf = dtt.random_setup(n, 4, rng=np.random.default_rng(seed), energy=10.0, n_d=2)
    cost = dtt.make_game_cost(xf, np.tile(np.eye(4), (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
                              np.tile(1e3 * np.eye(4), (n, 1, 1)), radius=0.5, device="cpu")
    return dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1), x0, cost


# --- Outside a profiler. --------------------------------------------------

def test_span_outside_a_profiler_is_one_shared_no_op(monkeypatch):
    def fail(name):
        raise AssertionError(f"record_function({name!r}) called outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", fail)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("dpilqr.rhc.step"), profiling.span("dpilqr.batched.read")
    assert a is b
    with a:
        with b:  # nests: the context holds no state
            pass


def test_span_under_a_profiler_is_a_host_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("dpilqr.batched.solve"):
            with profiling.span("dpilqr.batched.read"):
                torch.ones(3).sum().item()
    spans = _spans(prof)
    assert [e.name for e in spans] == ["dpilqr.batched.solve", "dpilqr.batched.read"]
    assert _parent(spans[1]) is spans[0]
    assert spans[0].time_range.start <= spans[1].time_range.start
    assert spans[1].time_range.end <= spans[0].time_range.end


# --- The closed loop under a profiler. --------------------------------------

@pytest.fixture(scope="module")
def loop():
    """A decomposed closed loop of 4 unicycles (auto K, 2 steps) profiled on
    the CPU, every solve's result kept: ``(spans, results, steps)``."""
    fleet, x0, cost = _fleet_cost(4, 3)
    results, solve = [], rhc.solve_distributed
    logged = []

    def kept(*a, **kw):
        results.append(solve(*a, **kw))
        return results[-1]

    rhc.solve_distributed = kept
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = dtt.solve_rhc(fleet, cost, x0, 8, radius=0.5, centralized=False,
                                step_size=1, dist_converge=1e-6, t_diverge=0.1,
                                config=dtt.SolverConfig(n_lqr_iter=4),
                                rng=np.random.default_rng(0), log_fn=logged.append,
                                device="cpu")
    finally:
        rhc.solve_distributed = solve
    assert len(out.steps) == len(logged) == 2
    return _spans(prof), results, out.steps


def test_loop_spans_nest_step_solve_driver_read(loop):
    spans, _, _ = loop
    chains = set()
    for e in spans:
        if e.name == "dpilqr.batched.read":
            chain, p = [], _parent(e)
            while p is not None:
                chain.append(p.name)
                p = _parent(p)
            chains.add(tuple(chain))
    assert ("dpilqr.batched.solve", "dpilqr.distributed.solve", "dpilqr.rhc.step",
            "dpilqr.rhc.episode") in chains
    for e in spans:
        if e.name == "dpilqr.rhc.step":
            assert _parent(e).name == "dpilqr.rhc.episode"
        if e.name in ("dpilqr.rhc.read", "dpilqr.rhc.advance", "dpilqr.rhc.commit",
                      "dpilqr.rhc.log_fn", "dpilqr.distributed.solve"):
            assert _parent(e).name in ("dpilqr.rhc.step", "dpilqr.rhc.redo"), e.name


def test_loop_reads_rhc_once_a_dispatched_step(loop):
    spans, results, steps = loop
    dispatched = _count(spans, "dpilqr.rhc.step")
    assert dispatched == len(results) == len(steps) + _count(spans, "dpilqr.rhc.redo")
    assert _count(spans, "dpilqr.rhc.read") == dispatched
    assert _count(spans, "dpilqr.rhc.log_fn") == len(steps)
    assert _count(spans, "dpilqr.rhc.episode") == _count(spans, "dpilqr.rhc.rollout") == 1
    # Auto K: the first solve's width is read from its graph on the host.
    assert _count(spans, "dpilqr.distributed.read") >= 1


def test_loop_reads_the_active_count_once_an_iteration_and_once_a_solve(loop):
    spans, results, _ = loop
    # 4 lanes fit one compaction width: a solve runs its longest lane's
    # iterations, each followed by one read, after the first count.
    assert all(r.iters.shape[0] < bt.COMPACTION_UNIT for r in results)
    want = sum(1 + int(r.iters.max()) for r in results)
    assert _count(spans, "dpilqr.batched.read") == want
    assert _count(spans, "dpilqr.batched.solve") == len(results)
    assert _count(spans, "dpilqr.batched.init") == len(results)


def test_recorded_names_keep_the_layer_prefix(loop):
    spans, _, _ = loop
    names = {e.name for e in spans}
    assert all(NAME.match(n) for n in names), names
    assert {"dpilqr.distributed.graph", "dpilqr.distributed.gather",
            "dpilqr.distributed.stitch", "dpilqr.distributed.rollout",
            "dpilqr.batched.stage", "dpilqr.batched.scatter"} <= names


# --- The trial layer. ----------------------------------------------------

@pytest.fixture(scope="module")
def trials():
    T, n = 2, 4
    sets = [_fleet_cost(n, 10 + t) for t in range(T)]
    fleet = sets[0][0]
    X_T = np.stack([np.broadcast_to(x0[None], (2, n, 4)) for _, x0, _ in sets])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dtt.solve_trials_sharded(fleet, stack_costs([c for *_, c in sets]), X_T,
                                 np.zeros((T, 8, n, 2)), 0.5, dtt.make_mesh(["cpu"]), K=4,
                                 config=dtt.SolverConfig(n_lqr_iter=3))
    return T, _spans(prof)


@pytest.mark.parametrize("outer,inner", [("dpilqr.mesh.gather", "dpilqr.mesh.graph"),
                                         ("dpilqr.mesh.stitch", "dpilqr.mesh.rollout")])
def test_trials_gather_and_stitch_hold_one_range_a_trial(trials, outer, inner):
    T, spans = trials
    (o,) = [e for e in spans if e.name == outer]
    assert _parent(o).name == "dpilqr.mesh.trials"
    assert [_parent(e) for e in spans if e.name == inner] == [o] * T


def test_trials_solve_one_batch_inside_the_chunks(trials):
    _, spans = trials
    (solve,) = [e for e in spans if e.name == "dpilqr.batched.solve"]
    assert _parent(solve).name == "dpilqr.mesh.chunks"
    assert _parent(_parent(solve)).name == "dpilqr.mesh.trials"
    assert _count(spans, "dpilqr.mesh.flatten") == 1


# --- The graph loop, rehearsed on the CPU. --------------------------------

def test_graph_loop_captures_a_width_once_and_reads_each_replay(problem, rehearsal):  # noqa: F811
    _, captures = rehearsal
    fleet, sub_cost, x0_s, U_s, mids = problem
    cfg = dtt.SolverConfig(n_lqr_iter=8, tol=1e-3, ls_probe=2)
    args = (fleet, cfg, sub_cost, x0_s, U_s, mids, torch.arange(x0_s.shape[0]) != 5, "cuda")
    for call in range(2):
        replays0 = sum(r.replays for r in captures)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            bt.solve_subproblems_batched(*args)
        spans = Counter(e.name for e in _spans(prof))
        replays = sum(r.replays for r in captures) - replays0
        assert spans["dpilqr.batched.capture"] == (len(captures) if call == 0 else 0)
        assert len(captures) > 1  # compaction fired: more than one width
        assert spans["dpilqr.batched.replay"] == replays > 0
        iterations = replays + spans["dpilqr.batched.capture"]
        assert spans["dpilqr.batched.read"] == iterations + 1
        assert spans["dpilqr.batched.load"] == spans["dpilqr.batched.stage"] == len(captures)
        assert spans["dpilqr.batched.compact"] == len(captures) - 1


def test_graph_cache_counts_hits_misses_and_evictions(problem, rehearsal, monkeypatch):  # noqa: F811
    fleet = problem[0]
    monkeypatch.setattr(bt, "GRAPH_CACHE_ENTRIES", 2)
    bt.reset_graph_cache_counts()

    def lookup(n_lqr_iter):
        bt.iteration_graph(fleet, dtt.SolverConfig(n_lqr_iter=n_lqr_iter, ls_probe=0), None,
                           4, N, K, 4, 2, torch.float64, torch.device("cpu"))

    for n_lqr_iter in (3, 4, 5, 5, 4, 3):
        lookup(n_lqr_iter)
    info = bt.graph_cache_info()
    # 3, 4, 5 miss (3 leaves), 5 and 4 hit, 3 misses again (5 leaves).
    assert (info["misses"], info["hits"], info["evictions"]) == (4, 2, 2)
    assert info["entries"] == 2
    bt.reset_graph_cache_counts()
    assert (bt.graph_cache_info()["misses"], bt.graph_cache_info()["hits"]) == (0, 0)


# --- Every name in the source. -------------------------------------------

def test_every_span_in_the_package_keeps_the_layer_prefix():
    names = []
    for path in (ROOT / "dpilqr_tpu_torch").rglob("*.py"):
        names += re.findall(r'\bspan\(\s*"([^"]*)"', path.read_text())
    assert len(names) >= 25
    bad = [n for n in names if not NAME.match(n)]
    assert not bad, bad
    reads = {n for n in names if n.endswith(".read")}
    assert reads == {"dpilqr.rhc.read", "dpilqr.distributed.read", "dpilqr.batched.read"}


# --- On the card. ---------------------------------------------------------

# In a child process: a second profiler session in one process misses the
# kernels of the program's ctypes-loaded library.
_CARD = r"""
import json
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.parallel.graph import interaction_graph
from dpilqr_tpu_torch.parallel.subproblems import (gather_controls, gather_cost,
                                                   gather_states, gather_subproblems)

dev = torch.device("cuda", 0)
n, K, N = 16, 4, 8
rng = np.random.default_rng(13)
x0 = np.zeros((n, 4))
x0[:, :2] = np.stack([np.arange(n) % 4, np.arange(n) // 4], -1) * 0.45
x0[:, 3] = rng.uniform(0.0, 0.3, n)
xf = x0.copy()
xf[:, :2] = x0[::-1, :2]
xf[:, 3] = 0.0
eye = np.tile(np.eye(4), (n, 1, 1))
cost = dtt.make_game_cost(xf, eye, np.tile(np.eye(2), (n, 1, 1)), 100 * eye, radius=0.5,
                          dtype=torch.float32, device=dev)
fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1)
X = torch.as_tensor(x0, dtype=torch.float32, device=dev)[None]
U = torch.as_tensor(rng.uniform(-0.1, 0.1, (N, n, 2)), dtype=torch.float32, device=dev)
batch = gather_subproblems(interaction_graph(X, 0.5, n_pos=cost.n_pos), K)
mids = torch.as_tensor(fleet.branch_index_array, dtype=torch.int32,
                       device=dev)[batch.member_idx]
args = (fleet, dtt.SolverConfig(n_lqr_iter=8, tol=1e-3),
        gather_cost(cost, batch, torch.float32), gather_states(X[0], batch),
        gather_controls(U, batch), mids, torch.ones(n, dtype=torch.bool, device=dev))
bt.solve_subproblems_batched(*args)  # captures every width
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    bt.solve_subproblems_batched(*args)
    torch.cuda.synchronize()
host, kernels = [], []
for e in prof.events():
    r = (e.name, e.time_range.start, e.time_range.end)
    if e.device_type == torch.autograd.DeviceType.CUDA:
        if not e.is_user_annotation and not e.name.startswith("dpilqr."):
            kernels.append(r)
    elif e.name in ("dpilqr.batched.replay", "dpilqr.batched.read"):
        host.append(r)
print(json.dumps({"host": sorted(host, key=lambda r: r[1]),
                  "kernels": sorted(kernels, key=lambda r: r[1])}))
"""


@pytest.mark.cuda
def test_cuda_replay_and_read_bracket_the_iterations_kernels():
    """Each replayed iteration's kernels (K1, K2, the accept kernel) start
    after its ``batched.replay`` opens and end before its ``batched.read``
    closes: the ranges and the kernels share the profiler's clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-c", _CARD], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    host, kernels = got["host"], got["kernels"]
    replays = [r for r in host if r[0] == "dpilqr.batched.replay"]
    assert replays
    # An iteration: a backward kernel, then K2, then the accept kernel.
    iterations, cur = [], None
    for name, a, b in kernels:
        if "backward_batched" in name:
            cur = [a, None]
        elif "accept_batched" in name and cur is not None:
            cur[1] = b
            iterations.append(cur)
            cur = None
    assert len(iterations) == len(replays)
    for (_, r0, _), (a, b) in zip(replays, iterations):
        (read,) = [h for h in host if h[0] == "dpilqr.batched.read" and h[1] >= r0][:1]
        assert r0 <= a, (r0, a)
        assert b <= read[2], (b, read)
