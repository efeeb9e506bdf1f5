"""gait.info fidelity: every mode-sequence gait's pattern table reproduces
the reference's stance sets at every phase (reference:
src/legged_ctrl/config/gait.info). Checked by sampling the cycle densely
and comparing the table lookup against an independent interval evaluation
of the published mode sequences."""

import jax.numpy as jnp
import numpy as np

from legged_mpc_control_tpu.mpc import gait

DTYPE = jnp.float32

# (modes, switching times) straight from gait.info
GAIT_INFO = {
    "standing_trot": (["LF_RH", "STANCE", "RF_LH", "STANCE"],
                      [0.0, 0.25, 0.3, 0.55, 0.6]),
    "flying_trot": (["LF_RH", "FLY", "RF_LH", "FLY"],
                    [0.0, 0.15, 0.2, 0.35, 0.4]),
    "pace": (["LF_LH", "FLY", "RF_RH", "FLY"],
             [0.0, 0.28, 0.30, 0.58, 0.60]),
    "standing_pace": (["LF_LH", "STANCE", "RF_RH", "STANCE"],
                      [0.0, 0.30, 0.35, 0.65, 0.70]),
    "dynamic_walk": (["LF_RF_RH", "RF_RH", "RF_LH_RH", "LF_RF_LH",
                      "LF_LH", "LF_LH_RH"],
                     [0.0, 0.2, 0.3, 0.5, 0.7, 0.8, 1.0]),
    "static_walk": (["LF_RF_RH", "RF_LH_RH", "LF_RF_LH", "LF_LH_RH"],
                    [0.0, 0.3, 0.6, 0.9, 1.2]),
    "amble": (["RF_LH", "LF_LH", "LF_RH", "RF_RH"],
              [0.0, 0.15, 0.40, 0.55, 0.80]),
    "lindyhop": (["LF_RH", "STANCE", "RF_LH", "STANCE", "LF_LH", "RF_RH",
                  "LF_LH", "STANCE", "RF_RH", "LF_LH", "RF_RH", "STANCE"],
                 [0.00, 0.35, 0.45, 0.80, 0.90, 1.125, 1.35, 1.70, 1.80,
                  2.025, 2.25, 2.60, 2.70]),
    "skipping": (["LF_RH", "FLY"] * 4 + ["RF_LH", "FLY"] * 4,
                 [0.00, 0.21, 0.30, 0.51, 0.60, 0.81, 0.90, 1.11, 1.20,
                  1.41, 1.50, 1.71, 1.80, 2.01, 2.10, 2.31, 2.40]),
    "pawup": (["RF_LH_RH"], [0.0, 2.0]),
}


def _stance_from_table(pat, leg, phase):
    """Stance flag from the pattern table at a raw phase in [0,1)."""
    sw = np.asarray(pat.switch_time[leg])
    seg = np.asarray(pat.seg_state[leg])
    n = int(pat.n_seg[leg])
    idx = int(np.sum(phase > sw[:n]))
    idx = min(idx, n - 1)
    return seg[idx] == gait.STANCE


def _stance_from_info(modes, times, leg, phase):
    """Independent evaluation of the gait.info mode sequence."""
    T = times[-1]
    t = phase * T
    for m, mode in enumerate(modes):
        if times[m] <= t < times[m + 1] or (m == len(modes) - 1):
            return leg in gait._MODE_STANCE[mode]
    raise AssertionError


def test_gait_info_mode_sequences():
    for name, (modes, times) in GAIT_INFO.items():
        pat = gait.named_pattern(name, DTYPE)
        T = times[-1]
        # sample strictly inside each mode interval (switch instants are
        # boundary-convention ties, not semantics)
        for m in range(len(modes)):
            for frac in (0.25, 0.5, 0.75):
                t = times[m] + frac * (times[m + 1] - times[m])
                phase = t / T
                for leg in range(4):
                    want = leg in gait._MODE_STANCE[modes[m]]
                    got = _stance_from_table(pat, leg, phase)
                    assert got == want, (name, modes[m], leg, phase)


def test_no_aliased_gaits():
    """dynamic_walk / static_walk are real gait.info sequences, not crawl
    aliases."""
    crawl = gait.crawl_pattern(DTYPE)
    for name in ("dynamic_walk", "static_walk"):
        pat = gait.named_pattern(name, DTYPE)
        same = (np.array_equal(np.asarray(pat.seg_state),
                               np.asarray(crawl.seg_state))
                and np.allclose(np.asarray(pat.switch_time),
                                np.asarray(crawl.switch_time)))
        assert not same, name


def test_predict_contact_matches_table():
    """predict_contact_state agrees with the table for the new many-segment
    gaits (MAX_SEG=12 path)."""
    import jax

    for name in ("dynamic_walk", "lindyhop", "skipping"):
        pat = gait.named_pattern(name, DTYPE)
        legs = jnp.arange(4, dtype=jnp.int32)
        st = jax.vmap(gait.gait_leg_init, in_axes=(None, 0, None))(
            pat, legs, DTYPE)
        for phase in (0.1, 0.33, 0.61, 0.87):
            pred = jax.vmap(
                gait.predict_contact_state, in_axes=(0, None, 0, None, None)
            )(st, pat, legs, jnp.asarray(phase, DTYPE),
              jnp.asarray(1.0, DTYPE))
            for leg in range(4):
                want = _stance_from_table(pat, leg, phase)
                assert bool(pred[leg] > 0.5) == want, (name, leg, phase)
