from .graph import graph_to_dict, interaction_graph
from .subproblems import (
    SubproblemBatch,
    extract_owner,
    gather_controls,
    gather_cost,
    gather_states,
    gather_subproblems,
)
from .deadline import solve_distributed_steppable
from .distributed import DistributedResult, auto_subproblem_width, solve_distributed
from .rhc import RhcResult, RhcStepInfo, selfish_warmstart, solve_rhc
from .mesh import make_mesh, solve_distributed_sharded, solve_trials_sharded, stack_costs
