"""Gait engine: per-leg contact scheduling as pure phase arithmetic.

Functional re-design of the reference's per-leg SWING/STANCE finite state
machine (reference: src/legged_ctrl/src/utils/LeggedContactFSM.cpp). The FSM's
mutable members become an explicit `GaitLegState` pytree; every branch becomes
`jnp.where`, so the whole engine vmaps over legs and scenarios and lives
inside `jit`/`scan` without retracing.

A gait *pattern* is a padded per-leg segment table:
    seg_state[s]  in {0=SWING, 1=STANCE} for segment s
    switch_time[s] : phase at which segment s ends (non-decreasing, last = 1)
    n_seg          : number of valid segments (static table, padded to MAX_SEG)
The phase variable advances at `gait_counter_speed` cycles/second and wraps
per gait cycle exactly like the reference (phase -= 1.0 when the pattern index
wraps, LeggedContactFSM.cpp:218-221).
"""

from typing import Any

import jax.numpy as jnp

from legged_mpc_control_tpu import pytree
from legged_mpc_control_tpu.ops.bezier import swing_foot_pos

MAX_SEG = 12     # lindyhop's per-leg segmentation needs 9 (gait.info)
SWING = 0
STANCE = 1


@pytree.dataclass
class GaitPattern:
    """Per-leg segment tables, shape (4, MAX_SEG)."""
    seg_state: Any       # int32 (4, MAX_SEG)
    switch_time: Any     # float (4, MAX_SEG), padded with 1.0
    n_seg: Any           # int32 (4,)


def _pattern(per_leg, dtype=jnp.float32):
    """per_leg: list of 4 lists of (state, end_time) tuples."""
    seg = jnp.zeros((4, MAX_SEG), dtype=jnp.int32)
    sw = jnp.ones((4, MAX_SEG), dtype=dtype)
    n = jnp.zeros((4,), dtype=jnp.int32)
    for leg, segments in enumerate(per_leg):
        for s, (st, et) in enumerate(segments):
            seg = seg.at[leg, s].set(st)
            sw = sw.at[leg, s].set(et)
        # pad remaining slots with the last state so lookups past the end
        # stay sane; switch_time pad of 1.0 keeps them unreachable
        for s in range(len(segments), MAX_SEG):
            seg = seg.at[leg, s].set(segments[-1][0])
        n = n.at[leg].set(len(segments))
    return GaitPattern(seg_state=seg, switch_time=sw, n_seg=n)


def trot_pattern(dtype=jnp.float32) -> GaitPattern:
    """Default trot: legs FL,RR stance-first. reference:
    LeggedContactFSM.cpp:93-114 (`set_default_gait_pattern`)."""
    diag_a = [(STANCE, 0.5), (SWING, 1.0)]
    diag_b = [(SWING, 0.5), (STANCE, 1.0)]
    return _pattern([diag_a, diag_b, diag_b, diag_a], dtype)


def trot_with_stand_pattern(dtype=jnp.float32) -> GaitPattern:
    """reference: LeggedContactFSM.cpp:116-157."""
    return _pattern([
        [(STANCE, 0.6), (SWING, 1.0)],                     # FL
        [(STANCE, 0.1), (SWING, 0.5), (STANCE, 1.0)],      # FR
        [(STANCE, 0.1), (SWING, 0.5), (STANCE, 1.0)],      # RL
        [(STANCE, 0.6), (SWING, 1.0)],                     # RR
    ], dtype)


def crawl_pattern(dtype=jnp.float32) -> GaitPattern:
    """reference: LeggedContactFSM.cpp:158-199."""
    return _pattern([
        [(SWING, 0.25), (STANCE, 1.0)],                    # FL
        [(STANCE, 0.25), (SWING, 0.5), (STANCE, 1.0)],     # FR
        [(STANCE, 0.5), (SWING, 0.75), (STANCE, 1.0)],     # RL
        [(STANCE, 0.75), (SWING, 1.0)],                    # RR
    ], dtype)


def stand_pattern(dtype=jnp.float32) -> GaitPattern:
    """reference: LeggedContactFSM.cpp:201-212."""
    return _pattern([[(STANCE, 1.0)]] * 4, dtype)


# --- gait.info mode-sequence gaits -----------------------------------------
# The reference's OCS2 gait library defines gaits as sequences of support
# MODES with switching times (reference: config/gait.info). Mode names list
# the stance legs in OCS2 order LF, RF, LH, RH = our FL, FR, RL, RR.
_MODE_STANCE = {
    "STANCE": (0, 1, 2, 3), "FLY": (),
    "LF_RH": (0, 3), "RF_LH": (1, 2), "LF_LH": (0, 2), "RF_RH": (1, 3),
    "LF_RF": (0, 1), "LH_RH": (2, 3),
    "LF_RF_RH": (0, 1, 3), "RF_LH_RH": (1, 2, 3),
    "LF_RF_LH": (0, 1, 2), "LF_LH_RH": (0, 2, 3),
}


def _pattern_from_modes(modes, times, dtype=jnp.float32):
    """Convert a gait.info mode sequence into per-leg segment tables.

    modes: list of M mode names (keys of _MODE_STANCE); times: M+1
    switching times (gait.info `switchingTimes`). Times are normalized so
    one cycle spans phase [0, 1); adjacent same-state segments merge."""
    T = float(times[-1])
    per_leg = []
    for leg in range(4):
        segs = []
        for m, mode in enumerate(modes):
            st = STANCE if leg in _MODE_STANCE[mode] else SWING
            end = float(times[m + 1]) / T
            if segs and segs[-1][0] == st:
                segs[-1] = (st, end)
            else:
                segs.append((st, end))
        assert len(segs) <= MAX_SEG, (len(segs), leg)
        per_leg.append(segs)
    return _pattern(per_leg, dtype)


def flying_trot_pattern(dtype=jnp.float32) -> GaitPattern:
    """Diagonal pairs separated by full-flight phases — gait.info
    `flying_trot` mode sequence (reference: config/gait.info)."""
    return _pattern_from_modes(
        ["LF_RH", "FLY", "RF_LH", "FLY"], [0.0, 0.15, 0.2, 0.35, 0.4],
        dtype)


def standing_trot_gaitinfo_pattern(dtype=jnp.float32) -> GaitPattern:
    """gait.info `standing_trot`: diagonal pairs with all-stance dwells
    (reference: config/gait.info standing_trot)."""
    return _pattern_from_modes(
        ["LF_RH", "STANCE", "RF_LH", "STANCE"],
        [0.0, 0.25, 0.3, 0.55, 0.6], dtype)


def pace_pattern(dtype=jnp.float32) -> GaitPattern:
    """Lateral pairs with flight phases — gait.info `pace` mode sequence
    (left legs FL,RL stance first)."""
    return _pattern_from_modes(
        ["LF_LH", "FLY", "RF_RH", "FLY"], [0.0, 0.28, 0.30, 0.58, 0.60],
        dtype)


def standing_pace_pattern(dtype=jnp.float32) -> GaitPattern:
    """Pace with all-stance dwells — gait.info `standing_pace`."""
    return _pattern_from_modes(
        ["LF_LH", "STANCE", "RF_RH", "STANCE"],
        [0.0, 0.30, 0.35, 0.65, 0.70], dtype)


def dynamic_walk_pattern(dtype=jnp.float32) -> GaitPattern:
    """gait.info `dynamic_walk`: 4-beat walk with 2-foot support phases
    (reference: config/gait.info dynamic_walk)."""
    return _pattern_from_modes(
        ["LF_RF_RH", "RF_RH", "RF_LH_RH", "LF_RF_LH", "LF_LH", "LF_LH_RH"],
        [0.0, 0.2, 0.3, 0.5, 0.7, 0.8, 1.0], dtype)


def static_walk_pattern(dtype=jnp.float32) -> GaitPattern:
    """gait.info `static_walk`: always-3-foot-support crawl (distinct from
    the FSM's own `crawl`, LeggedContactFSM.cpp:158-199)."""
    return _pattern_from_modes(
        ["LF_RF_RH", "RF_LH_RH", "LF_RF_LH", "LF_LH_RH"],
        [0.0, 0.3, 0.6, 0.9, 1.2], dtype)


def amble_pattern(dtype=jnp.float32) -> GaitPattern:
    """gait.info `amble`: lateral-sequence 2-foot walk."""
    return _pattern_from_modes(
        ["RF_LH", "LF_LH", "LF_RH", "RF_RH"],
        [0.0, 0.15, 0.40, 0.55, 0.80], dtype)


def lindyhop_pattern(dtype=jnp.float32) -> GaitPattern:
    """gait.info `lindyhop`: the dance sequence (triple steps + dwells)."""
    return _pattern_from_modes(
        ["LF_RH", "STANCE", "RF_LH", "STANCE", "LF_LH", "RF_RH", "LF_LH",
         "STANCE", "RF_RH", "LF_LH", "RF_RH", "STANCE"],
        [0.00, 0.35, 0.45, 0.80, 0.90, 1.125, 1.35, 1.70, 1.80, 2.025,
         2.25, 2.60, 2.70], dtype)


def skipping_pattern(dtype=jnp.float32) -> GaitPattern:
    """gait.info `skipping`: repeated one-diagonal hops, then the other."""
    return _pattern_from_modes(
        ["LF_RH", "FLY"] * 4 + ["RF_LH", "FLY"] * 4,
        [0.00, 0.21, 0.30, 0.51, 0.60, 0.81, 0.90, 1.11, 1.20, 1.41,
         1.50, 1.71, 1.80, 2.01, 2.10, 2.31, 2.40], dtype)


def pawup_pattern(dtype=jnp.float32) -> GaitPattern:
    """gait.info `pawup`: hold three feet down, FL raised."""
    return _pattern_from_modes(["RF_LH_RH"], [0.0, 2.0], dtype)


def bound_pattern(dtype=jnp.float32) -> GaitPattern:
    """Front pair / rear pair alternate."""
    front = [(STANCE, 0.5), (SWING, 1.0)]
    rear = [(SWING, 0.5), (STANCE, 1.0)]
    return _pattern([front, front, rear, rear], dtype)


def pronk_pattern(dtype=jnp.float32) -> GaitPattern:
    """All four legs hop together."""
    leg = [(STANCE, 0.6), (SWING, 1.0)]
    return _pattern([leg] * 4, dtype)


# Named gait registry — the analogue of the reference's gait library
# (reference: config/gait.info:1-14: stance, trot, standing_trot,
# flying_trot, pace, standing_pace, dynamic_walk, static_walk, amble,
# lindyhop, skipping, pawup). gait.info-listed names map to
# mode-sequence-faithful tables built by `_pattern_from_modes`; the
# FSM-native gaits (LeggedContactFSM.cpp) keep their own names: `crawl`
# (:158-199) and `trot_with_stand` (:116-157). `bound`/`pronk` are extras.
NAMED_PATTERNS = {
    "stance": stand_pattern,
    "stand": stand_pattern,
    "trot": trot_pattern,
    "standing_trot": standing_trot_gaitinfo_pattern,
    "trot_with_stand": trot_with_stand_pattern,
    "flying_trot": flying_trot_pattern,
    "pace": pace_pattern,
    "standing_pace": standing_pace_pattern,
    "crawl": crawl_pattern,
    "static_walk": static_walk_pattern,
    "dynamic_walk": dynamic_walk_pattern,
    "amble": amble_pattern,
    "lindyhop": lindyhop_pattern,
    "skipping": skipping_pattern,
    "pawup": pawup_pattern,
    "bound": bound_pattern,
    "pronk": pronk_pattern,
}


def named_pattern(name: str, dtype=jnp.float32) -> GaitPattern:
    """Look up a gait by name (config tier 3 equivalent, gait.info)."""
    try:
        return NAMED_PATTERNS[name](dtype)
    except KeyError:
        raise ValueError(
            f"unknown gait '{name}'; known: {sorted(NAMED_PATTERNS)}")


@pytree.dataclass
class GaitLegState:
    """Functional state of one leg's contact FSM (vmap over legs).

    Mirrors the mutable members of `LeggedContactFSM`
    (reference: include/utils/LeggedContactFSM.h)."""
    phase: Any                 # gait phase, unwrapped within cycle
    state: Any                 # int32: SWING / STANCE
    pattern_idx: Any           # int32: current segment index
    cur_start: Any             # phase at which current segment started
    cur_end: Any               # phase at which current segment ends
    swing_start_pos: Any       # (3,) world foot pos at swing liftoff
    swing_end_pos: Any         # (3,) last commanded swing target
    target_pos: Any            # (3,) FSM_foot_pos_target_world
    target_vel: Any            # (3,) FSM_foot_vel_target_world
    terrain_height: Any        # z recorded at stance exit
    initialized: Any           # bool: not_first_call


def gait_leg_init(pattern: GaitPattern, leg: Any, dtype=jnp.float32):
    """Fresh FSM state for one leg (reference: LeggedContactFSM.cpp:5-36).

    `leg` is an int32 index array so this vmaps over legs."""
    z3 = jnp.zeros((3,), dtype=dtype)
    return GaitLegState(
        phase=jnp.zeros((), dtype=dtype),
        state=pattern.seg_state[leg, 0],
        pattern_idx=jnp.zeros((), dtype=jnp.int32),
        cur_start=jnp.zeros((), dtype=dtype),
        cur_end=pattern.switch_time[leg, 0],
        swing_start_pos=z3,
        swing_end_pos=z3,
        target_pos=z3,
        target_vel=z3,
        terrain_height=jnp.zeros((), dtype=dtype),
        initialized=jnp.zeros((), dtype=bool),
    )


def gait_leg_reset(s: GaitLegState, pattern: GaitPattern, leg):
    """Reset on entering stand mode (reference: LeggedContactFSM.cpp:16-36):
    stance foot holds position, swing foot jumps to its saved target."""
    was_swing = s.state == SWING
    return s.replace(
        phase=jnp.zeros_like(s.phase),
        state=pattern.seg_state[leg, 0],
        pattern_idx=jnp.zeros_like(s.pattern_idx),
        cur_start=jnp.zeros_like(s.cur_start),
        cur_end=pattern.switch_time[leg, 0],
        target_pos=jnp.where(was_swing, s.swing_end_pos, s.target_pos),
        target_vel=jnp.where(was_swing, jnp.zeros_like(s.target_vel),
                             s.target_vel),
        initialized=jnp.zeros_like(s.initialized),
    )


def _percent_in_state(s: GaitLegState):
    """reference: LeggedContactFSM.cpp:269-278."""
    pct = (s.phase - s.cur_start) / (s.cur_end - s.cur_start)
    return jnp.clip(pct, 0.0, 1.0)


def _common_enter(s: GaitLegState, pattern: GaitPattern, leg):
    """Advance the segment index; wrap phase when the cycle restarts.
    reference: LeggedContactFSM.cpp:214-229. (`<=` instead of the
    reference's `<` so a single-segment pattern — stand — also wraps its
    phase instead of growing unboundedly.)"""
    nxt = (s.pattern_idx + 1) % pattern.n_seg[leg]
    wrapped = nxt <= s.pattern_idx
    phase = jnp.where(wrapped, s.phase - 1.0, s.phase)
    return s.replace(
        pattern_idx=nxt,
        phase=phase,
        cur_start=phase,
        cur_end=pattern.switch_time[leg, nxt],
    )


def gait_leg_update(s: GaitLegState, pattern: GaitPattern, leg, dt,
                    gait_speed, foot_pos_cur, foot_pos_target,
                    foot_force_flag):
    """One FSM tick for one leg (reference: LeggedContactFSM.cpp:38-84).

    foot_force_flag: bool — foot force sensor above contact threshold
    (used for the early-contact transition at >90% swing).
    Returns the new GaitLegState.
    """
    # first-call latch: record targets (reference: :42-48)
    first = ~s.initialized
    s = s.replace(
        swing_start_pos=jnp.where(first, foot_pos_cur, s.swing_start_pos),
        swing_end_pos=jnp.where(first, foot_pos_target, s.swing_end_pos),
        target_pos=jnp.where(first, foot_pos_target, s.target_pos),
        target_vel=jnp.where(first, jnp.zeros_like(s.target_vel),
                             s.target_vel),
        initialized=jnp.ones_like(s.initialized),
    )

    # phase advance (reference: :50)
    s = s.replace(phase=s.phase + gait_speed * dt)

    # --- transitions (at most one per tick, like the reference) ---
    pct = _percent_in_state(s)
    seg_end = jnp.where(
        s.state == STANCE,
        s.phase >= s.cur_end,
        ((pct > 0.9) & foot_force_flag) | (pct >= 1.0))

    entered = _common_enter(s, pattern, leg)
    next_state = pattern.seg_state[leg, entered.pattern_idx]
    enter_swing = seg_end & (next_state == SWING)
    enter_stance = seg_end & (next_state == STANCE) & (s.state == SWING)
    # -> swing: record terrain height, latch liftoff position
    # (reference: :55-59, 86-90, 231-235)
    swing_entered = entered.replace(
        state=jnp.full_like(s.state, SWING),
        terrain_height=foot_pos_cur[2],
        swing_start_pos=foot_pos_cur,
    )
    # swing -> stance: hold touchdown position (reference: :61-71, 236-240)
    stance_entered = entered.replace(
        state=jnp.full_like(s.state, STANCE),
        target_pos=foot_pos_cur,
        target_vel=jnp.zeros_like(s.target_vel),
    )
    # stance -> stance (segment advance without state change, e.g. the
    # single-segment stand pattern): bookkeeping only, keep held target
    rebook = entered.replace(state=jnp.full_like(s.state, STANCE))

    def pick(conds_states, fallback):
        out = {}
        for name in fallback.__dataclass_fields__:
            v = getattr(fallback, name)
            for cond, st in reversed(conds_states):
                v = jnp.where(cond, getattr(st, name), v)
            out[name] = v
        return GaitLegState(**out)

    s = pick([(enter_swing, swing_entered),
              (enter_stance, stance_entered),
              (seg_end, rebook)], s)

    # --- in-state update ---
    # swing: Bezier toward target, velocity by finite difference
    # (reference: :242-254); stance: hold (reference: :256-267)
    pct = _percent_in_state(s)
    bez = swing_foot_pos(pct, s.swing_start_pos, foot_pos_target)
    in_swing = s.state == SWING
    new_target = jnp.where(in_swing, bez, s.target_pos)
    new_vel = jnp.where(in_swing, (new_target - s.target_pos) / dt,
                        s.target_vel)
    s = s.replace(
        swing_end_pos=jnp.where(in_swing, foot_pos_target, s.swing_end_pos),
        target_pos=new_target,
        target_vel=new_vel,
    )
    return s


def get_contact_state(s: GaitLegState):
    """1.0 if the FSM is in STANCE (bool as float)."""
    return (s.state == STANCE).astype(s.phase.dtype)


def predict_contact_state(s: GaitLegState, pattern: GaitPattern, leg,
                          dt_ahead, gait_speed):
    """Contact flag `dt_ahead` seconds into the future, from the static
    pattern table (reference: LeggedContactFSM.cpp:280-294). Note: like the
    reference, this ignores transient FSM perturbations (early contact)."""
    p = s.phase + gait_speed * dt_ahead
    # wrap to (0, 1]; the reference's `while (p > 1.0) p -= 1.0`
    p = jnp.where(p > 1.0, p - jnp.ceil(p - 1.0), p)
    sw = pattern.switch_time[leg]                     # (MAX_SEG,)
    nseg = pattern.n_seg[leg]
    valid = jnp.arange(MAX_SEG) < nseg
    # first valid segment with p <= switch_time
    idx = jnp.sum(((p > sw) & valid).astype(jnp.int32))
    idx = jnp.minimum(idx, nseg - 1)
    st = pattern.seg_state[leg, idx]
    return (st == STANCE).astype(s.phase.dtype)
