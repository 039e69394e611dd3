from .costs import (
    GameCost,
    game_cost_from_numpy,
    make_game_cost,
    proximity_cost,
    proximity_quadraticize,
    quadraticize_stage,
    quadraticize_terminal,
    stage_cost,
    terminal_cost,
)
from .ilqr import (
    SolveResult,
    ilqr_solve,
    ilqr_solve_steppable,
    line_search_alphas,
    make_solver,
    rollout,
)
