"""Legged-robot convex-MPC framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
ROS/C++ stack `zha0ming1e/legged_mpc_control` (Unitree A1/Go1 locomotion:
convex single-rigid-body MPC, gait scheduling, Raibert foothold planning,
Bezier swing trajectories, contact-gated Kalman state estimation,
Jacobian-transpose / whole-body low-level control).

Architecture: the reference's three real-time threads over a shared mutable
blackboard (reference: src/legged_ctrl/src/main.cpp:110-256) collapse into one
pure-functional control step compiled under `jax.jit`, batched over thousands
of scenarios with `vmap`, and sharded over device meshes with `shard_map`.
"""

__version__ = "0.1.0"

from legged_mpc_control_tpu import constants
