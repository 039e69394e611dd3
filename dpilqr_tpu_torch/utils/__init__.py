from .rate import Rate
from .geometry import (
    compute_energy,
    distance_to_goal,
    face_goal,
    normalize_energy,
    pair_indices,
    pairwise_distances,
    perturb_state,
    random_setup,
    randomize_locs,
)
