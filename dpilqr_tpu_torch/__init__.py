"""dpilqr_tpu_torch: distributed potential iLQR in PyTorch and CUDA.

The PyTorch/CUDA port of ``dpilqr_tpu`` (the JAX package beside it, which
stays the reference).  Module names mirror that package.  Both solves run
their sweeps as hand-written CUDA kernels for Hopper (``csrc/``) on CUDA
tensors, and as their plain PyTorch twins on CPU tensors: the decomposed
(DP-iLQR) solve inside the receding-horizon loop (``solve_distributed``,
``solve_rhc(centralized=False)``) and the centralized solve (``ilqr_solve``,
``make_solver``, ``solve_rhc(centralized=True)``).  Importing the package
imports neither JAX nor the JAX package, and builds nothing: the kernels
compile with ``nvcc`` on first use.

Entry points given numpy input and no ``device`` run on the card
(``default_device()`` raises where there is none); tensors keep their
device, and ``device="cpu"`` or CPU tensors ask for the CPU.  With
``t_kill`` the solves stop at a wall-clock deadline (``ilqr_solve_steppable``,
``solve_distributed_steppable``, ``solve_rhc(t_kill=)``); ``utils.sol`` holds
the speed-of-light accounting (work counts, the three ceiling probes,
``sol_report``).  ``solve_distributed_sharded`` splits one decomposed
solve's subproblem batch over the devices of ``make_mesh``, and
``solve_trials_sharded`` solves Monte-Carlo trials as one kernel batch over
them.  A custom model (``api.SymbolicModel``: a ``ModelSpec`` carrying its
sympy form) runs in the kernels through a right-hand side generated from
that form (``ops.codegen``); one given only a torch ``f`` runs on the CPU.
``api`` is the reference-shaped object facade (``UnicycleDynamics4D``,
``ilqrSolver``, ``solve_rhc`` on flat numpy arrays) and ``native.host`` the
g++-built host dynamics of ``native/bbdyn.cpp``; neither is imported here.
"""

from .config import DEFAULT_CONFIG, SolverConfig, default_device
from .models import (
    BIKE_5D,
    CAR_3D,
    DOUBLE_INT_4D,
    DOUBLE_INT_6D,
    GRAVITY,
    HUMAN_6D,
    HUMAN_LIN_6D,
    MODEL_BY_NAME,
    MODEL_REGISTRY,
    QUAD_6D,
    QUAD_12D,
    UNICYCLE_4D,
    Fleet,
    ModelSpec,
    get_model,
    homogeneous_fleet,
)
from .parallel import (
    DistributedResult,
    RhcResult,
    RhcStepInfo,
    graph_to_dict,
    interaction_graph,
    make_mesh,
    selfish_warmstart,
    solve_distributed,
    solve_distributed_sharded,
    solve_distributed_steppable,
    solve_rhc,
    solve_trials_sharded,
)
from .utils import (
    Rate,
    compute_energy,
    distance_to_goal,
    face_goal,
    normalize_energy,
    pairwise_distances,
    perturb_state,
    random_setup,
    randomize_locs,
)
from .ops import (
    GameCost,
    SolveResult,
    game_cost_from_numpy,
    ilqr_solve,
    ilqr_solve_steppable,
    make_game_cost,
    make_solver,
    proximity_cost,
    quadraticize_stage,
    quadraticize_terminal,
    rollout,
    stage_cost,
    terminal_cost,
)

__version__ = "0.1.0"
