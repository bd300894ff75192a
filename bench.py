"""Benchmark harness — runs on a GPU and refuses any other device.

Measures the BASELINE.md headline metrics on the flagship config
(50k particles x 720 beams, 1024^2 map at 0.05 m, likelihood-field model):

- particle x beam likelihood evals/sec on one device
- full sensor-update + KLD-resample step latency

Three regimes are measured: *steady* (fully converged cloud — the state the
E2E demos reach and where a production localizer spends its life),
*tracking* (mid-convergence, wider yaw spread), and *spread*
(global-localization-scale cloud). The primary metric is the tracking
regime. The population is pinned at 50k (min == max) so every iteration
does full-size work regardless of the KLD bound. Prints ONE JSON line.

Run:  python bench.py
"""

import argparse
import json
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=50000)
    ap.add_argument("--beams", type=int, default=720)
    ap.add_argument("--map-cells", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()

    import jax

    from __graft_entry__ import _build_setup
    from badger_amcl import mcl
    from badger_amcl.utils.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    device = require_gpu()

    def timed_chain(step_fn, state, iters):
        """Device time per call by TWO-POINT chained measurement: the chain
        runs inside ONE jit'd fori_loop (each fn is state -> state, so the
        data dependency defeats loop-invariant hoisting), timed at iters and
        4*iters with a TRACED trip count (one compile), and the slope taken:
        the difference cancels any fixed per-call cost (dispatch, readback)
        while keeping the loop's own per-iteration overhead."""
        import jax.numpy as jnp

        @jax.jit
        def chain_loop(s, n):
            return jax.lax.fori_loop(0, n, lambda i, t: step_fn(t), s)

        lo, hi = jnp.int32(iters), jnp.int32(4 * iters)
        s = chain_loop(state, lo)
        jax.block_until_ready(s)

        def run(n):
            nonlocal s
            t0 = time.perf_counter()
            s = chain_loop(s, n)
            jax.block_until_ready(s)
            return time.perf_counter() - t0

        # interleave lo, hi, hi, lo: the pair averages cancel LINEAR drift
        # on top of the slope's fixed-cost cancel
        w_lo1, w_hi1, w_hi2, w_lo2 = run(lo), run(hi), run(hi), run(lo)
        return ((w_hi1 + w_hi2) - (w_lo1 + w_lo2)) / 2.0 / (3 * iters), s

    results = {}
    for regime, cov in (
        ("steady", (0.004, 0.004, 0.0004)),
        ("tracking", (0.02, 0.02, 0.002)),
        ("spread", (2.0, 2.0, 1.0)),
    ):
        omap, params, state, scan, scan_params, pool = _build_setup(
            args.particles, args.beams, args.map_cells,
            pose_cov=cov, min_particles=args.particles,
        )
        import jax.numpy as jnp

        @jax.jit
        def like_step(s):
            # poses perturbed by the output so no dispatch can be elided
            p = mcl.likelihood_only(s, omap, scan_params, scan)
            return s.replace(poses=s.poses + (p * 1e-12)[:, None])

        t_like, _ = timed_chain(like_step, state, args.iters)

        # Chaining real steps would collapse a spread cloud after the first
        # resample (later iterations measure tracking, not spread), so every
        # iteration runs the full step and then restores the regime's pose
        # cloud — perturbed by the step output to keep the data dependency.
        poses0 = state.poses

        def pinned_step(s):
            s2 = mcl.sensor_resample_step_jit(
                s, omap, scan_params, scan, pool, params)
            return s2.replace(
                poses=poses0 + jnp.mean(s2.poses) * 1e-12,
                weights=jnp.full_like(s2.weights, 1.0 / args.particles),
                n_active=jnp.int32(args.particles),
            )

        t_step, s_end = timed_chain(pinned_step, state, args.iters)
        results[regime] = {
            "likelihood_ms": t_like * 1e3,
            "step_ms": t_step * 1e3,
            "evals_per_sec": args.particles * args.beams / t_like,
        }

    primary = results["tracking"]["evals_per_sec"]
    out = {
        "metric": "particle_beam_likelihood_evals_per_sec_per_device",
        "value": primary,
        "unit": "evals/s",
        "extra": {
            "device": {"platform": device.platform, "kind": device.device_kind,
                       "count": len(jax.devices())},
            "particles": args.particles,
            "beams": args.beams,
            "map_cells": args.map_cells,
            "steady": results["steady"],
            "tracking": results["tracking"],
            "spread": results["spread"],
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
