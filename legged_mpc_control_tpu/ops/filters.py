"""Functional moving-window filters.

Replaces the reference's stateful `MovingWindowFilter` (O(1) compensated
moving average, reference: include/utils/MovingWindowFilter.hpp) with an
immutable ring-buffer pytree — the functional-state equivalent that composes
with `jit`/`vmap`/`scan`. Windows here are small (<= 50 taps) so a plain mean
over the buffer is exact enough; no Neumaier compensation needed.
"""

from typing import Any

import jax.numpy as jnp

from legged_mpc_control_tpu import pytree


@pytree.dataclass
class MovingWindowState:
    """Ring buffer state. `buf` has shape (window,) + value_shape."""
    buf: Any
    idx: jnp.ndarray          # scalar int32, next write position
    count: jnp.ndarray        # scalar int32, number of valid samples


def moving_window_init(window: int, value_shape=(), dtype=jnp.float32):
    return MovingWindowState(
        buf=jnp.zeros((window,) + tuple(value_shape), dtype=dtype),
        idx=jnp.zeros((), dtype=jnp.int32),
        count=jnp.zeros((), dtype=jnp.int32),
    )


def moving_window_update(state: MovingWindowState, value):
    """Push `value`; returns (new_state, average over valid samples)."""
    window = state.buf.shape[0]
    buf = state.buf.at[state.idx].set(value)
    count = jnp.minimum(state.count + 1, window)
    idx = (state.idx + 1) % window
    avg = jnp.sum(buf, axis=0) / count.astype(buf.dtype)
    return MovingWindowState(buf=buf, idx=idx, count=count), avg


def savgol_coeffs(window: int, order: int = 2, deriv: int = 0,
                  dt: float = 1.0):
    """Causal Savitzky-Golay coefficients: fit an `order`-degree polynomial
    to the last `window` samples and evaluate value (deriv=0) or derivative
    (deriv=1) at the NEWEST sample. The smoothing the reference's EKF
    submodule pulls from the gram_savitzky_golay library
    (reference: legged_ctrl CMakeLists.txt:124-136).

    Returns (window,) coefficients ordered oldest-first (numpy, computed at
    trace time)."""
    import math

    import numpy as np

    t = (np.arange(window) - (window - 1)) * dt       # newest sample at 0
    A = np.vander(t, order + 1, increasing=True)      # (W, order+1)
    # least-squares fit: coeffs of the polynomial = (A^T A)^-1 A^T y;
    # evaluating value/derivative at t=0 picks row `deriv` (times deriv!)
    pinv = np.linalg.solve(A.T @ A, A.T)              # (order+1, W)
    return pinv[deriv] * math.factorial(deriv)


@pytree.dataclass
class SavgolState:
    """Ring buffer for the causal SG filter (same layout as MovingWindow)."""
    buf: Any
    idx: jnp.ndarray
    count: jnp.ndarray


def savgol_init(window: int, value_shape=(), dtype=jnp.float32):
    return SavgolState(
        buf=jnp.zeros((window,) + tuple(value_shape), dtype=dtype),
        idx=jnp.zeros((), dtype=jnp.int32),
        count=jnp.zeros((), dtype=jnp.int32),
    )


def savgol_update(state: SavgolState, value, order: int = 2,
                  deriv: int = 0, dt: float = 1.0):
    """Push `value`; returns (new_state, SG-filtered output at the newest
    sample). Until the buffer fills, falls back to the raw value."""
    window = state.buf.shape[0]
    buf = state.buf.at[state.idx].set(value)
    count = jnp.minimum(state.count + 1, window)
    idx = (state.idx + 1) % window
    coeffs = jnp.asarray(savgol_coeffs(window, order, deriv, dt),
                         buf.dtype)
    # unroll the ring into oldest-first order: sample k ago sits at
    # (idx - 1 - k) mod window
    k = jnp.arange(window)
    order_idx = jnp.mod(idx - window + k, window)
    seq = buf[order_idx]                              # oldest ... newest
    shaped = coeffs.reshape((window,) + (1,) * (buf.ndim - 1))
    out = jnp.sum(seq * shaped, axis=0)
    out = jnp.where(count >= window, out, value)
    return SavgolState(buf=buf, idx=idx, count=count), out
