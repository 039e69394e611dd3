from .specs import (
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
    ModelSpec,
    SymbolicRHS,
    get_model,
)
from .integrate import euler_discretize, rk4_integrate, rk4_step
from .fleet import Fleet, homogeneous_fleet
