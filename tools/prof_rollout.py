"""Times the B=4096 batched closed-loop rollout at two Riccati iteration
counts, on the device JAX runs on:

    python tools/prof_rollout.py
"""
import time
import jax, jax.numpy as jnp
from legged_mpc_control_tpu import device
from legged_mpc_control_tpu.config import go1_params
from legged_mpc_control_tpu.mpc import gait
from legged_mpc_control_tpu.parallel import runner

B, dtype = 4096, jnp.float32
params = go1_params(dtype)
pattern = gait.trot_pattern(dtype)
print(device.device_info())
for it in (8, 6):
    roll = jax.jit(runner.make_batched_rollout(
        pattern, horizon=10, n_ticks=10, pdip_iters=it,
        solver="riccati", walk_velx=0.25))
    variants = [(runner.init_loop_batch(params, B, jax.random.PRNGKey(k),
                                        dtype=dtype), params) for k in range(2)]
    out = roll(*variants[0]); jax.block_until_ready(out)
    t0 = time.perf_counter()
    for i in range(4): out = roll(*variants[i % 2])
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / 4
    print(f"iters={it}: {B*10/dt:,.0f} ticks/s  vs_baseline={B*10/dt/409600:.3f}")
