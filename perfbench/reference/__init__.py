"""Plain PyTorch reference of the decomposed potential-game iLQR.

Written from the published algorithm (labicon/dp-ilqr: ``control.py``,
``cost.py``, ``distributed.py``, ``bbdynamics.cpp``) and the numpy oracle's
reading of it, batched over subproblems with plain tensor operations.  It
imports nothing of the program under test: the harness hands it inputs it
made itself and the program's outputs to judge.
"""
