#!/usr/bin/env python3
"""Where the time of the port's mock-library generation goes, on one card.

Builds `chip_smoke.py`'s north-star model on the card and prints:

1. `generate(n)` wall time with the fused (K1) and the staged window body,
   `--reps` runs each after a warm-up, host clock around synchronized runs;
2. a per-batch breakdown of one 65536-row batch (host clock around
   synchronized calls, median of `--reps`): θ draw + z-sort + run plan (for
   the whole run), window plan, SFZH, fused body, K1 launches alone, staged
   body;
3. K1 at the main path's first sub-chunk: CUDA-event time and its FLOPs
   (both products), hence its rate;
4. a `torch.profiler` trace of one `generate(n)`: device self time per
   kernel, and the device busy share, Σ device self time over the untraced
   wall time of the same run (one stream, so kernels do not overlap).

Run from the repository root on a machine with a card:

    python3 profile_torch.py [--n 1048576] [--reps 4]
"""

import argparse
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke

BATCH = 65536


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of `fn` between two synchronizations."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def end_to_end(gen, n: int, reps: int) -> None:
    for fused in (True, False):
        gen.generate(n=BATCH, seed=1, zsorted_fused=fused)  # warm-up
        walls = [host_ms(lambda: gen.generate(n=n, seed=0,
                                              zsorted_fused=fused), 1) / 1e3
                 for _ in range(reps)]
        print(f"[e2e] generate(n={n}) {'fused' if fused else 'staged'} body:"
              f" wall s {walls}; SEDs/s {[round(n / w) for w in walls]}",
              flush=True)


def breakdown(sim, gen, n: int, reps: int) -> dict:
    """Per-batch host-clock times; returns K1's arguments for sub-chunk 0."""
    from synference_tpu_torch.ops import fused_sed as k1

    t = {"draw+sort+plan (whole run)":
         host_ms(lambda: gen._draw_sorted(n, BATCH, seed=0), reps)}
    theta, sub, bs, kc, w_cols = gen._draw_sorted(n, BATCH, seed=0)
    batch = theta[:bs]
    t["window plan"] = host_ms(
        lambda: sim._plan_windows(batch, sub, kc, w_cols), reps)
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(batch, sub, kc, w_cols)
    t["SFZH"] = host_ms(lambda: sim._sfzh(sim.theta_dict(chunk)), reps)
    t["fused body"] = host_ms(lambda: sim._zsorted_run_raw(
        chunk, sub, w_cols, kc, k0, l0, fused=True), reps)
    calls = [a for *_, a in sim._window_calls(chunk, sub, w_cols, kc, k0, l0)]
    t[f"K1 alone ({len(calls)} launches)"] = host_ms(
        lambda: [k1.fused_window_photometry(**a) for a in calls], reps)
    t["staged body"] = host_ms(lambda: sim._zsorted_run_raw(
        chunk, sub, w_cols, kc, k0, l0, fused=False), reps)
    for name, ms in t.items():
        print(f"[batch] {name}: {ms:.3f} ms", flush=True)
    return calls[0]


def k1_rate(a: dict) -> None:
    from synference_tpu_torch.ops import fused_sed as k1

    ms = smoke.time_ms(lambda: k1.fused_window_photometry(**a), reps=100)
    b, c = a["sfzh"].shape
    w, kf = a["sed_w"].shape[1], a["kc"] * a["f8"]
    flop = 2 * b * c * w + 2 * b * w * kf
    print(f"[k1] B={b} C={c} W={w} kc*F8={kf}: {ms:.4f} ms, "
          f"{flop / 1e9:.3f} GFLOP, {flop / ms / 1e9:.2f} TFLOP/s", flush=True)


def device_profile(gen, n: int) -> None:
    wall = host_ms(lambda: gen.generate(n=n, seed=0), 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gen.generate(n=n, seed=0)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"[trace] generate(n={n}): device self time {total:.3f} ms, "
          f"untraced wall {wall:.3f} ms, busy share {total / wall:.4f}",
          flush=True)
    for e in dev[:12]:
        ms = e.self_device_time_total / 1e3
        print(f"[trace] {ms:9.3f} ms {ms / total:7.2%} x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2**20)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    smoke.check(torch.cuda.is_available(), "no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    import synference_tpu_torch as tt

    sim, gen = smoke.build_model(tt, torch.device("cuda"))
    end_to_end(gen, args.n, args.reps)
    k1_rate(breakdown(sim, gen, args.n, args.reps))
    device_profile(gen, args.n // 4)


if __name__ == "__main__":
    main()
