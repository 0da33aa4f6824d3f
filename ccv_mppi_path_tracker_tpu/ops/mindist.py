"""Nearest-reference-point distance for the path-tracking cost.

The reference scans all T local reference points for every rollout state —
an O(K*T^2) triple loop (calc_MinDistance, src/diff_drive_mppi.cpp:183-192)
capped by initializing ``min_distance = 100.0`` (:185).

Formulation: the **centered expanded form**. With c = ref[0] (the first
window point), xc = p - c and rc_j = ref_j - c:

    |p - ref_j|^2 = |xc|^2 + (|rc_j|^2 - 2 xc . rc_j)

Only the parenthesized term depends on j, so the min scan is two FMAs + one
min per reference point (|rc_j|^2 and 2*rc_j are precomputed once per window)
versus five ops for the difference form ``(x-rx)^2 + (y-ry)^2`` — a ~40% op
cut on what is, by op count, the largest group of the fused kernel.
|xc|^2 is added back once after the min, then the result is clamped to
[0, DIST_CAP^2] (the lower clamp absorbs the tiny negative residue the
expanded form can produce at d ~ 0; the upper is the reference's 100 m cap).

Numerics — why centering makes the expanded form safe. Uncentered, the
expanded form suffers catastrophic cancellation: the absolute error is
O(eps * (|p|^2 + |r|^2)), unbounded relative to small distances when the
*coordinates* are large. Centering at the first window point bounds both
operands by the window geometry: |xc| <= d + W and |rc_j| <= W, where d is
the true nearest distance and W = max_j |ref_j - ref_0| is the window span
(<= (T-1) * v_ref * dt, a few meters). The rounding analysis (inputs + two
FMAs + the |xc|^2 add-back) gives

    |d2_expanded - d2_exact| <= 10 * eps * max(|xc|^2, W^2)
                             <= 10 * eps * (d + 2W)^2

i.e. ~4e-5 m^2 in float32 at W = 6 m even when d ~ 0 (vs 2*eps*d^2 for the
difference form), and ~1e-13 in the float64 oracles. tests/test_ops.py
(test_expanded_form_error_bound) asserts this bound against an exact-f64
difference-form evaluation on adversarial near-zero-distance inputs. All
four parity arms (this op, the fused kernel, the NumPy oracle, the C++
oracle) compute the SAME centered expanded form, so their mutual agreement
is unchanged; the CLAUDE.md invariant contract (oracle agreement within the
parity suite's tolerances) is preserved, not re-negotiated.

Two execution regimes (same arithmetic, so results match):

- broadcast-min below _BCAST_LIMIT elements: one fused (.., R) broadcast +
  min-reduce, elementwise on purpose (a dot_general could route the cross
  term through reduced-precision matrix units, e.g. TF32 on the GPU).
- running-min scan over R for very large problems, bounding worst-case
  memory to one (...,) buffer; 3 vector ops per reference point. The two
  regimes share the exact per-element expression tree, so they remain
  bitwise-identical (tests/test_ops.py scan-vs-broadcast).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# min_distance initialization in the reference (src/diff_drive_mppi.cpp:185):
# distances are effectively capped at 100.0 m.
DIST_CAP = 100.0

# Above this (num positions x num refs) element count, use the scan form:
# XLA may materialize the (T, K, R) broadcast in device memory, whose traffic
# grows with K*T*R. Below it the broadcast is one fused kernel instead of R
# small sequential ones. The crossover has not been measured on the GPU yet
# (ROADMAP, speed queue). The two forms share
# the per-element arithmetic, and fmin is exactly associative/commutative —
# the only regime difference is XLA's reduction/contraction order, covered
# by the parity suite's tolerances.
_BCAST_LIMIT = 10**7


def center_ref(ref_xy: jax.Array):
    """Precompute the centered expanded-form reference constants.

    Returns (c, rc2, rn): the center (first window point, shape (2,)),
    2 * (ref - c) with shape (R, 2), and |ref - c|^2 with shape (R,).
    Shared by this op and the fused kernel's input packing
    (kernels/rollout_cost.py) so both arms consume identical constants.
    """
    c = ref_xy[..., 0, :]
    rc = ref_xy - ref_xy[..., 0:1, :]
    rn = rc[..., 0] * rc[..., 0] + rc[..., 1] * rc[..., 1]
    return c, 2.0 * rc, rn


def min_sq_distance(xy: jax.Array, ref_xy: jax.Array) -> jax.Array:
    """Min over reference points of squared distance, clamped to
    [0, DIST_CAP^2] (see module docstring for the expanded-form numerics).

    xy: (..., 2) rollout positions; ref_xy: (R, 2) reference points.
    Returns (...,) = clamp(min_j |xy - ref_j|^2).
    """
    cap = jnp.asarray(DIST_CAP * DIST_CAP, xy.dtype)
    zero = jnp.asarray(0.0, xy.dtype)
    n_pos = int(np.prod(xy.shape[:-1]))
    n_ref = ref_xy.shape[0]

    c, rc2, rn = center_ref(ref_xy)
    xc = xy - c
    pn = xc[..., 0] * xc[..., 0] + xc[..., 1] * xc[..., 1]

    if n_pos * n_ref <= _BCAST_LIMIT:
        # One fused broadcast + min-reduce. Deliberately elementwise (NOT a
        # dot_general): a matrix-unit contraction could run the cross term
        # in TF32 on the GPU, and the identical per-element expression tree
        # keeps this regime bitwise-equal to the scan regime below.
        t = rn - xc[..., 0:1] * rc2[:, 0] - xc[..., 1:2] * rc2[:, 1]
        m = jnp.min(t, axis=-1)
        return jnp.minimum(jnp.maximum(pn + m, zero), cap)

    # Derive the carry from xy (0*xy + inf) instead of jnp.full: under
    # shard_map the carry must inherit xy's device-varying type or the scan
    # carry types mismatch.
    init = xy[..., 0] * 0.0 + jnp.asarray(jnp.inf, xy.dtype)

    def body(carry, ref_row):
        rc2_j, rn_j = ref_row
        t = rn_j - xc[..., 0] * rc2_j[0] - xc[..., 1] * rc2_j[1]
        return jnp.minimum(carry, t), None

    # unroll=8: XLA fuses 8 reference points into ONE loop body, so the
    # (..., 2) positions are re-read from device memory once per 8 points
    # instead of once per point (+ 1/8th the carry round-trips).
    # Bitwise-identical to unroll=1.
    m, _ = jax.lax.scan(body, init, (rc2, rn), unroll=8)
    return jnp.minimum(jnp.maximum(pn + m, zero), cap)
