"""The batched solve's device-side loop (dpilqr_tpu_torch.ops.batched): the
accept step (``accept_batched_torch``, the plain version of
``csrc/accept_batched.cu``), K2's tail under its predicate, the loop that
replays one CUDA graph an iteration, and its cache key; float64, against
the JAX package (dpilqr_tpu.ops.pallas_batched) on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do.  Both sides get the same seeded numpy problem: 16 unicycles on a
jittered grid, subproblems of K=4 slots over N=8 steps, 16 alphas probed
8 at a time (so that the JAX iteration stages its line search, which it
does only for lane-aligned batches, and takes its ``lax.cond``).  Accept
decisions in float64 are exact, so J and the trajectories agree to
rtol 1e-12 (relative to max|.|) and the flags and counts are equal.

Without a card the graph loop is rehearsed with its launches bound to the
plain versions and a stand-in for the CUDA graph that replays them: bit
for bit the eager loop's result.  The ``cuda`` cases hold the kernels and
the captured graphs against the eager kernel path and skip without one.
"""

import types

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops import cuda_build as cb
from dpilqr_tpu_torch.ops.costs import GameCost
from dpilqr_tpu_torch.parallel import rhc
from dpilqr_tpu_torch.parallel.graph import interaction_graph
from dpilqr_tpu_torch.parallel.subproblems import (gather_controls, gather_cost,
                                                   gather_states, gather_subproblems)

torch.set_num_threads(1)

RTOL = 1e-12
n, K, N = 16, 4, 8
# Staged as the JAX iteration stages only lane-aligned batches: p * S and
# (n_alpha - p) * S multiples of 128.
STAGED = dict(n_ls_iter=16, ls_probe=8, n_lqr_iter=6, tol=1e-3)


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    import dpilqr_tpu as dtl
    from dpilqr_tpu.ops import pallas_batched as pj
    from dpilqr_tpu.ops.costs import GameCost as JCost

    def cost(c):
        return JCost(**{k: jnp.asarray(v.numpy()) for k, v in c._asdict().items()})

    def carry(c):
        return pj._BatchCarry(*(jnp.asarray(a.numpy()) for a in c))

    return types.SimpleNamespace(dtl=dtl, pj=pj, jnp=jnp, cost=cost, carry=carry,
                                 fleet=dtl.Fleet(("Unicycle4D",) * n, 0.1))


@pytest.fixture(scope="module")
def problem():
    """The gathered batch: ``(fleet, sub_cost, x0_s, U_s, mids)`` on the CPU."""
    rng = np.random.default_rng(13)
    side = 4
    x0 = np.zeros((n, 4))
    x0[:, :2] = (np.stack([np.arange(n) % side, np.arange(n) // side], -1) * 0.45
                 + rng.uniform(-0.05, 0.05, (n, 2)))
    x0[:, 3] = rng.uniform(0.0, 0.3, n)
    xf = x0.copy()
    xf[:, :2] = x0[::-1, :2]
    xf[:, 3] = 0.0
    eye = np.eye(4)
    cost = dtt.make_game_cost(xf, np.tile(eye, (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
                              np.tile(100 * eye, (n, 1, 1)), radius=0.5, device="cpu")
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1)
    X = torch.as_tensor(x0)[None]
    U = torch.as_tensor(rng.uniform(-0.1, 0.1, (N, n, 2)))
    batch = gather_subproblems(interaction_graph(X, 0.5, n_pos=cost.n_pos), K)
    sub_cost = gather_cost(cost, batch, torch.float64)
    mids = torch.as_tensor(fleet.branch_index_array, dtype=torch.int32)[batch.member_idx]
    return fleet, sub_cost, gather_states(X[0], batch), gather_controls(U, batch), mids


def _init(problem, cfg):
    fleet, sub_cost, x0_s, U_s, mids = problem
    S = x0_s.shape[0]
    return bt.init_batch_carry(fleet, cfg, sub_cost, x0_s, U_s, mids,
                               torch.ones(S, dtype=torch.bool), "torch")


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(np.abs(want[np.isfinite(want)]).max(initial=0.0), 1e-300)
        np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _port_iteration(problem, cfg, c):
    """The port's iteration, its accept step in place: the carry after it,
    the line search's costs and whether the tail was needed."""
    fleet, sub_cost, x0_s, _, mids = problem
    Kg, d = bt.backward_pass_batched(fleet, sub_cost, mids, c.X, c.U, c.mu, "torch")
    X5, U5, J_c = bt.line_search_batched(fleet, cfg, sub_cost, mids, c.X, c.U, Kg, d, c.J,
                                         c.active, "torch")
    p = cfg.ls_probe
    need = not bt._skip_tail((J_c[:p], c.J, c.active))
    c = bt.BatchCarry(*(a.clone() for a in c))
    counter = torch.zeros(2, dtype=torch.int32)
    bt.accept_batched_torch(cfg, X5, U5, J_c, x0_s, c, counter)
    assert int(counter[0]) == int(c.active.sum()) and int(counter[1]) == 0
    return c, J_c, need


def _edit(c, **fields):
    return c._replace(**{k: torch.as_tensor(v, dtype=getattr(c, k).dtype)
                         for k, v in fields.items()})


# Each case: a config and an edit of the carry from the warm start's rollout.
CASES = {
    # Lane 0 can only improve far below its start: no probe alpha reaches it.
    "tail needed": (STAGED, lambda c: _edit(c, J=torch.where(
        torch.arange(len(c.J)) == 0, c.J * 1e-3, c.J))),
    # Every lane improves at the first alpha: the tail is skipped.
    "tail not needed": (STAGED, lambda c: _edit(c, J=torch.full_like(c.J, 1e30))),
    # No lane can improve: the increase schedule, and failure past mu_max.
    "increase": (dict(STAGED, on_failed_ls="increase", mu_max=3.0),
                 lambda c: _edit(c, J=torch.full_like(c.J, -1.0),
                                 mu=torch.linspace(0.5, 2.0, len(c.J)))),
    # mu falls to mu_min and stays there.
    "mu_floor": (dict(STAGED, mu_floor=True),
                 lambda c: _edit(c, mu=torch.full_like(c.mu, 1.5e-6),
                                 delta=torch.full_like(c.delta, 0.5))),
    # Inactive lanes stay as they were.
    "inactive frozen": (STAGED, lambda c: _edit(c, active=torch.arange(len(c.J)) % 3 != 0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_accept_in_place_matches_jax_iteration(jx, problem, case):
    fields, edit = CASES[case]
    cfg = dtt.SolverConfig(**fields)
    c0 = edit(_init(problem, cfg))
    got, _, need = _port_iteration(problem, cfg, c0)
    fleet_t, sub_cost, x0_s, _, mids = problem
    want = jx.pj.batched_iteration(
        jx.fleet, jx.dtl.SolverConfig(**fields), jx.cost(sub_cost),
        jx.jnp.asarray(mids.numpy()), jx.jnp.asarray(x0_s.numpy()), jx.carry(c0),
        interpret=True)
    if case == "tail needed":
        assert need
    if case == "tail not needed":
        assert not need
    for name, a, b in zip(bt.BatchCarry._fields, got, want):
        _close(a, b)
    if case == "inactive frozen":
        frozen = ~c0.active
        for a, b in zip(got, c0):
            assert torch.equal(a[frozen], b[frozen])


def test_skipped_tail_is_the_jax_skip_branch(jx, problem):
    """Where no active lane needs the tail, its twin returns the JAX skip
    branch (zero candidates, J = +inf), and the iteration over it equals
    the JAX iteration that took that branch."""
    cfg = dtt.SolverConfig(**STAGED)
    fleet, sub_cost, x0_s, _, mids = problem
    c = _edit(_init(problem, cfg), J=torch.full((x0_s.shape[0],), 1e30))
    Kg, d = bt.backward_pass_batched(fleet, sub_cost, mids, c.X, c.U, c.mu, "torch")
    alphas = dtt.ops.line_search_alphas(16, torch.float64)
    J_probe = bt.forward_pass_batched_torch(fleet, sub_cost, mids, c.X, c.U, Kg, d,
                                            alphas[:8])[2]
    X5, U5, J = bt.forward_pass_batched_torch(fleet, sub_cost, mids, c.X, c.U, Kg, d,
                                              alphas[8:], tail=(J_probe, c.J, c.active))
    assert bool(torch.isinf(J).all()) and bool((J > 0).all())
    assert not X5.abs().any() and not U5.abs().any()
    got = _port_iteration(problem, cfg, c)[0]
    want = jx.pj.batched_iteration(
        jx.fleet, jx.dtl.SolverConfig(**STAGED), jx.cost(sub_cost),
        jx.jnp.asarray(mids.numpy()), jx.jnp.asarray(x0_s.numpy()), jx.carry(c),
        interpret=True)
    for a, b in zip(got, want):
        _close(a, b)


def test_tail_predicate_runs_the_tail_where_needed(problem):
    """With an active lane that improved at no probe alpha, the tail twin
    is the plain launch of the tail alphas."""
    fleet, sub_cost, x0_s, _, mids = problem
    c = _init(problem, dtt.SolverConfig())
    Kg, d = bt.backward_pass_batched(fleet, sub_cost, mids, c.X, c.U, c.mu, "torch")
    alphas = dtt.ops.line_search_alphas(10, torch.float64)
    args = (fleet, sub_cost, mids, c.X, c.U, Kg, d)
    J_probe = bt.forward_pass_batched_torch(*args, alphas[:2])[2]
    J = J_probe.min(0).values
    got = bt.forward_pass_batched_torch(*args, alphas[2:], tail=(J_probe, J, c.active))
    want = bt.forward_pass_batched_torch(*args, alphas[2:])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # An inactive lane needs nothing.
    none = torch.zeros_like(c.active)
    assert bt._skip_tail((J_probe, J, none))


def test_whole_batched_solve_matches_jax(jx, problem):
    fleet, sub_cost, x0_s, U_s, mids = problem
    cfg = dtt.SolverConfig(n_lqr_iter=6, tol=1e-3)
    S = x0_s.shape[0]
    got = bt.solve_subproblems_batched(fleet, cfg, sub_cost, x0_s, U_s, mids,
                                       torch.ones(S, dtype=torch.bool), "torch")
    want = jx.pj.solve_subproblems_batched(
        jx.fleet, jx.dtl.SolverConfig(n_lqr_iter=6, tol=1e-3), jx.cost(sub_cost),
        jx.jnp.asarray(x0_s.numpy()), jx.jnp.asarray(U_s.numpy()),
        jx.jnp.asarray(mids.numpy()), jx.jnp.ones(S, bool), interpret=True)
    assert int(got.iters.sum()) > S  # more than one iteration a subproblem
    for name in ("X", "U", "J", "iters", "converged", "failed_line_search"):
        _close(getattr(got, name), getattr(want, name))


# --- The graph cache's key. -----------------------------------------------

def _key(cfg=None, **kw):
    args = dict(S=16, N=8, K=4, nx_p=4, nu_p=2, n_specs=1, dtype=torch.float32,
                device="cuda:0", library=None)
    args.update(kw)
    return bt.graph_key(cfg or dtt.SolverConfig(), **args)


def test_graph_key_equal_inputs_give_one_key():
    assert _key() == _key()
    assert _key(dtt.SolverConfig(mu_init=0.5, sweep_backend="cuda")) == _key()
    assert hash(_key()) == hash(_key())


@pytest.mark.parametrize("change", [
    dict(S=32), dict(N=9), dict(K=8), dict(nx_p=6), dict(nu_p=3), dict(n_specs=2),
    dict(dtype=torch.float64), dict(device="cuda:1"), dict(library="// header"),
])
def test_graph_key_separates_shapes_and_builds(change):
    assert _key(**change) != _key()


@pytest.mark.parametrize("field,value", [
    ("ls_probe", 3), ("n_ls_iter", 12), ("tol", 1e-4), ("mu_min", 1e-5),
    ("mu_max", 100.0), ("delta_0", 3.0), ("mu_floor", True),
    ("on_failed_ls", "increase"), ("n_lqr_iter", 20),
])
def test_graph_key_separates_each_baked_scalar(field, value):
    assert _key(dtt.SolverConfig(**{field: value})) != _key()


# --- The graph loop, rehearsed on the CPU. --------------------------------

class _Replay:
    """A stand-in for a captured CUDA graph: replays the bound launches."""

    def __init__(self, launches):
        self.launches = list(launches)
        self.replays = 0

    def replay(self):
        self.replays += 1
        for b in self.launches:
            b.fn()


@pytest.fixture
def rehearsal(monkeypatch):
    """The graph loop on CPU tensors: each bound launch computes its plain
    version into the graph's buffers, ``_capture`` returns a ``_Replay``;
    the compaction unit is 2.  Yields the launches counted and the
    captures made."""
    inv = bt._inverse(bt.COLUMN_ORDER)
    counts, captures = {}, []

    def bound(kernel, fn):
        return cb.Bound(kernel, None, lambda *a: fn(), (), (), ())

    def bind_backward(kernel, fleet, cost, mids, ids, dt, X, U, mu, Kg, d, work, library):
        def fn():
            Kp, dp = bt.backward_pass_batched(fleet, cost, mids, X, U, mu, "torch")
            Kg.copy_(Kp.permute(bt.GAIN_ORDER))
            d.copy_(dp.permute(bt.D_ORDER))
        return bound(kernel, fn)

    def bind_forward(fleet, cost, tables, X, U, Kg, d, alphas, X5, U5, J, library,
                     max_rows=0, tail=None):
        mids = torch.zeros_like(tables[0])  # one model: every branch index 0

        def fn():
            x5, u5, j = bt.forward_pass_batched_torch(fleet, cost, mids, X, U, Kg, d,
                                                      alphas, tail=tail)
            X5.copy_(x5.permute(bt.COLUMN_ORDER))
            U5.copy_(u5.permute(bt.COLUMN_ORDER))
            J.copy_(j)
        return bound("forward_batched", fn)

    def bind_accept(cfg, X5, U5, J_c, x0, c, counter):
        return bound("accept_batched", lambda: bt.accept_batched_torch(
            cfg, X5.permute(inv), U5.permute(inv), J_c, x0, c, counter))

    def capture(launches, device):
        captures.append(_Replay(launches))
        return captures[-1], 0

    def tally(b):
        counts[b.kernel] = counts.get(b.kernel, 0) + 1

    def run(b, device):
        b.fn()
        tally(b)

    init = bt.init_batch_carry
    next_width = bt.next_width
    monkeypatch.setattr(bt, "_bind_backward", bind_backward)
    monkeypatch.setattr(bt, "_bind_forward", bind_forward)
    monkeypatch.setattr(bt, "_bind_accept", bind_accept)
    monkeypatch.setattr(bt, "_capture", capture)
    monkeypatch.setattr(bt, "run", run)
    monkeypatch.setattr(bt, "count", tally)
    monkeypatch.setattr(bt, "init_batch_carry", lambda *a: init(*a[:-1], "torch"))
    monkeypatch.setattr(bt, "next_width", lambda w, unit=2: next_width(w, unit))
    monkeypatch.setattr(bt, "_graphs", bt.OrderedDict())
    yield counts, captures


@pytest.mark.parametrize("ls_probe", [2, 0])
def test_graph_loop_rehearsal_is_the_eager_loop(problem, rehearsal, ls_probe):
    """The graph loop (buffers, loads, compaction into the next width's
    buffers, replays, one count read an iteration) gives the eager loop's
    bits; a second call replays the cached graphs without a new capture."""
    counts, captures = rehearsal
    fleet, sub_cost, x0_s, U_s, mids = problem
    cfg = dtt.SolverConfig(n_lqr_iter=8, tol=1e-3, ls_probe=ls_probe)
    S = x0_s.shape[0]
    args = (fleet, cfg, sub_cost, x0_s, U_s, mids, torch.arange(S) != 5)
    want = bt.solve_subproblems_batched(*args, "torch")
    got = bt.solve_subproblems_batched(*args, "cuda")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    info = bt.graph_cache_info()
    assert info["entries"] == len(captures) > 1  # compaction fired
    assert info["captured"] == len(captures) and info["bytes"] > 0
    iterations = sum(r.replays for r in captures) + len(captures)
    per = {"backward_batched": 1, "forward_batched": 2 if ls_probe else 1,
           "accept_batched": 1}
    assert counts == {k: v * iterations for k, v in per.items()}
    again = bt.solve_subproblems_batched(*args, "cuda")
    for a, b in zip(again, want):
        assert torch.equal(a, b)
    assert bt.graph_cache_info()["entries"] == len(captures)  # no new capture


def test_graph_cache_drops_the_least_recently_used(problem, rehearsal, monkeypatch):
    fleet, sub_cost, x0_s, U_s, mids = problem
    monkeypatch.setattr(bt, "GRAPH_CACHE_ENTRIES", 2)
    keys = []
    for n_lqr_iter in (3, 4, 5):
        cfg = dtt.SolverConfig(n_lqr_iter=n_lqr_iter, ls_probe=0)
        bt.iteration_graph(fleet, cfg, None, 4, N, K, 4, 2, torch.float64,
                           torch.device("cpu"))
        keys.append(bt.graph_key(cfg, 4, N, K, 4, 2, 1, torch.float64, "cpu", None))
    assert list(bt._graphs) == keys[1:]


# --- One host copy a step. -----------------------------------------------

def test_to_host_is_one_exact_copy(monkeypatch):
    copies = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: copies.append(1) or cpu(self, *a, **k))
    ts = (torch.tensor(1.2345678901, dtype=torch.float32),
          torch.tensor([0.1, np.inf, -3.0], dtype=torch.float64),
          torch.tensor([7, -2], dtype=torch.int32), torch.tensor([[True, False]]),
          torch.tensor(2**40, dtype=torch.int64))
    out = rhc._to_host(*ts)
    assert len(copies) == 1
    for a, b in zip(out, ts):
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())


# --- On the card. ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_accept_kernel_is_the_plain_version(cuda_device, problem, dtype, case):
    fields, edit = CASES[case]
    cfg = dtt.SolverConfig(**fields)
    fleet, sub_cost, x0_s, _, mids = problem
    c = edit(_init(problem, cfg))
    Kg, d = bt.backward_pass_batched(fleet, sub_cost, mids, c.X, c.U, c.mu, "torch")
    X5, U5, J_c = bt.line_search_batched(fleet, cfg, sub_cost, mids, c.X, c.U, Kg, d, c.J,
                                         c.active, "torch")

    def dev(t):
        return t.to(cuda_device, dtype if t.is_floating_point() else t.dtype)

    outs = []
    for fn in (bt.accept_batched_cuda, bt.accept_batched_torch):
        cc = bt.BatchCarry(*(dev(a) for a in c))
        counter = torch.zeros(2, dtype=torch.int32, device=cuda_device)
        fn(cfg, dev(X5), dev(U5), dev(J_c), dev(x0_s), cc, counter)
        outs.append((cc, counter))
    torch.cuda.synchronize()
    for a, b in zip((*outs[0][0], outs[0][1]), (*outs[1][0], outs[1][1])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_graph_solve_is_the_eager_kernel_solve(cuda_device, problem, monkeypatch,
                                                     dtype):
    fleet, sub_cost, x0_s, U_s, mids = problem
    cfg = dtt.SolverConfig(n_lqr_iter=8, tol=1e-3)
    args = (fleet, cfg, GameCost(*(a.to(cuda_device) for a in sub_cost)),
            *(a.to(cuda_device) for a in (x0_s.to(dtype), U_s.to(dtype), mids)),
            torch.ones(x0_s.shape[0], dtype=torch.bool, device=cuda_device))
    cb.reset_launch_counts()
    got = bt.solve_subproblems_batched(*args)
    torch.cuda.synchronize()
    assert cb.launch_counts["accept_batched"] > 0
    monkeypatch.setattr(bt, "_graph_stage", bt._eager_stage)
    want = bt.solve_subproblems_batched(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
