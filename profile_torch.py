#!/usr/bin/env python3
"""Where the time of the port's mock-library generation goes, on one card.

Builds `chip_smoke.py`'s north-star model on the card and prints:

1. `generate(n)` wall time with the fused (K1) and the staged window body,
   `--reps` runs each after a warm-up, host clock around synchronized runs;
2. a per-batch breakdown of one 65536-row batch (host clock around
   synchronized calls, median of `--reps`): θ draw + z-sort + run plan (for
   the whole run), window plan, SFZH, fused body, K1 alone (its one launch
   over the batch's 64 sub-chunks), staged body;
3. K1's one launch over that batch: CUDA-event time and its FLOPs (both
   products), hence its rate;
4. a `torch.profiler` trace of one `generate(n)`: device self time per
   kernel (the program's spans, `synference::*`, are in the trace too;
   `benchmark/program_trace.py` puts the device's idle down to them);
5. the same trace of the dense `photometry(θ)` on 65536 unsorted rows of
   `chip_smoke.py`'s headline model (K2 and what surrounds it);
6. the same trace of 10 `simulate(θ, want_spectra=True)` calls on the
   headline model's "roll" variant (K3, its row keys and sort, and the
   (B, L) slab passes around it);
7. the same trace of 20 training steps of the north-star NSF ensemble (69
   hidden units, 15 transforms, 8 members as batched weights, batch 2048 per
   member, fp32 with TF32 off) on features of a 2^17-row library: kernels
   launched per step, the top device operations; and
   the host-clock time of a step and of the validation pass;
8. the same trace of the batched MCMC of the NLE posterior at the
   north-star width (NSF 69 × 15 × 8 members modelling the 14 features
   given θ, 256 objects, 64 walkers): 8 steps (16 half-steps of 8192 rows
   per member) and kernels per half-step.

Run from the repository root on a machine with a card:

    python3 profile_torch.py [--n 1048576] [--reps 4]
"""

import argparse
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke

BATCH = 65536


def end_to_end(gen, n: int, reps: int) -> None:
    for fused in (True, False):
        gen.generate(n=BATCH, seed=1, zsorted_fused=fused)  # warm-up
        walls = [smoke.host_ms(lambda: gen.generate(n=n, seed=0,
                                              zsorted_fused=fused), 1) / 1e3
                 for _ in range(reps)]
        print(f"[e2e] generate(n={n}) {'fused' if fused else 'staged'} body:"
              f" wall s {walls}; SEDs/s {[round(n / w) for w in walls]}",
              flush=True)


def breakdown(sim, gen, n: int, reps: int) -> dict:
    """Per-batch host-clock times; returns K1's arguments for the batch."""
    from synference_tpu_torch.ops import fused_sed as k1

    t = {"draw+sort+plan (whole run)":
         smoke.host_ms(lambda: gen._draw_sorted(n, BATCH, seed=0), reps)}
    theta, sub, bs, kc, w_cols, (k0, l0) = gen._draw_sorted(n, BATCH, seed=0)
    batch, starts = theta[:bs], (k0[:bs // sub], l0[:bs // sub])
    t["window plan"] = smoke.host_ms(
        lambda: sim._plan_windows(batch, sub, kc, w_cols, starts=starts),
        reps)
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(batch, sub, kc, w_cols,
                                                       starts=starts)
    t["SFZH"] = smoke.host_ms(lambda: sim._sfzh(sim.theta_dict(chunk)), reps)
    t["fused body"] = smoke.host_ms(lambda: sim._zsorted_run_raw(
        chunk, sub, w_cols, kc, k0, l0, fused=True), reps)
    g = sim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
    t[f"K1 alone (1 launch, {len(k0)} sub-chunks)"] = smoke.host_ms(
        lambda: k1.fused_window_photometry_grouped(**g), reps)
    t["staged body"] = smoke.host_ms(lambda: sim._zsorted_run_raw(
        chunk, sub, w_cols, kc, k0, l0, fused=False), reps)
    for name, ms in t.items():
        print(f"[batch] {name}: {ms:.3f} ms", flush=True)
    return g


def k1_rate(a: dict) -> None:
    from synference_tpu_torch.ops import fused_sed as k1

    ms = smoke.time_ms(lambda: k1.fused_window_photometry_grouped(**a),
                       reps=20)
    b, c = a["sfzh"].shape
    w, kf = a["w_cols"], a["kc"] * a["f8"]
    flop = 2 * b * c * w + 2 * b * w * kf
    print(f"[k1] one launch, B={b} in sub-chunks of {a['sub']}, C={c} W={w} "
          f"kc*F8={kf}: {ms:.4f} ms, {flop / 1e9:.3f} GFLOP, "
          f"{flop / ms / 1e9:.2f} TFLOP/s", flush=True)


def device_profile(fn, what: str, reps: int = 1) -> None:
    """Trace `reps` calls of `fn`: device self time per kernel."""
    fn()  # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"[trace] {what} x{reps}: device self time {total:.3f} ms; "
          f"{sum(e.count for e in dev) / reps:.1f} device operations per "
          f"call", flush=True)
    for e in dev[:12]:
        ms = e.self_device_time_total / 1e3
        print(f"[trace] {ms:9.3f} ms {ms / total:7.2%} x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


def training_profile(tt, gen, dev, steps: int = 20) -> None:
    """One training step of the north-star NSF ensemble, traced."""
    from synference_tpu_torch.flows.base import build_flow

    lib = gen.generate(n=2**17, seed=0)
    fitter = tt.SBIFitter(lib["photometry"].T, lib["parameters"].T,
                          lib["parameter_names"], lib["filter_codes"],
                          device=dev)
    fitter.create_feature_array(tt.FeatureConfig(
        filter_codes=tuple(smoke.CODES), unit="asinh", depths_ab=(29.5,) * 7,
        n_scatters=1, include_errors=True))
    prior = fitter.create_priors()
    flow = build_flow(
        "nsf", theta_dim=len(fitter.parameter_names),
        context_dim=fitter.features.shape[1], device=dev,
        hidden_features=69, num_transforms=15,
        support_low=tuple(prior.low.cpu().numpy().astype(float)),
        support_high=tuple(prior.high.cpu().numpy().astype(float)))
    step, validate, state = smoke.training_parts(
        flow, fitter.feature_params, fitter.features, n_val=65536)
    step()
    print(f"[train] NSF 69x15 x{smoke.N_NETS}, batch 2048, "
          f"{state.flat.shape[1]} weights per member, fp32 (TF32 off): "
          f"{smoke.host_ms(step, 20):.3f} ms per step (host clock, median "
          f"of 20); validation pass over 65536 rows "
          f"{smoke.host_ms(validate, 5):.3f} ms; "
          f"host: {smoke.host_reading(dev)}", flush=True)
    device_profile(step, "training step", reps=steps)
    device_profile(validate, "validation pass, 65536 rows x 8 members",
                   reps=3)


def mcmc_profile(tt, gen, dev, steps: int = 8) -> None:
    """Batched MCMC of an NLE posterior at the north-star width, traced."""
    from synference_tpu_torch.flows.base import build_flow
    from synference_tpu_torch.mcmc import run_batched_mcmc

    lib = gen.generate(n=2**16, seed=0)
    fitter = tt.SBIFitter(lib["photometry"].T, lib["parameters"].T,
                          lib["parameter_names"], lib["filter_codes"],
                          device=dev)
    fitter.create_feature_array(tt.FeatureConfig(
        filter_codes=tuple(smoke.CODES), unit="asinh", depths_ab=(29.5,) * 7,
        n_scatters=1, include_errors=True))
    prior = fitter.create_priors()
    flow = build_flow("nsf", theta_dim=fitter.features.shape[1],
                      context_dim=len(fitter.parameter_names), device=dev,
                      hidden_features=69, num_transforms=15)
    params = flow.init(torch.Generator(device=dev).manual_seed(0),
                       fitter.features, fitter.feature_params,
                       n_members=smoke.N_NETS)
    post = tt.LikelihoodPosterior(flow, params, prior)
    xs = fitter.features[:256]

    def run():
        with torch.no_grad():
            run_batched_mcmc(post._loglike, prior, xs, n_walkers=64,
                             n_steps=steps, burn_in=0, thin=1)

    print(f"[mcmc] NLE NSF 69x15 x{smoke.N_NETS}, 256 objects x 64 walkers, "
          f"{steps} steps ({2 * steps} half-steps): "
          f"{smoke.host_ms(run, 3) / (2 * steps):.3f} ms per half-step "
          f"(host clock, median of 3 runs)", flush=True)
    device_profile(run, f"batched MCMC, {2 * steps} half-steps")


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

    dev = torch.device("cuda")
    sim, gen = smoke.build_model(tt, dev)
    end_to_end(gen, args.n, args.reps)
    k1_rate(breakdown(sim, gen, args.n, args.reps))
    device_profile(lambda: gen.generate(n=args.n // 4, seed=0),
                   f"generate(n={args.n // 4})")
    dense = smoke.headline_model(tt, dev, "auto")
    theta = smoke.headline_theta(dev)
    device_profile(lambda: dense.photometry(theta),
                   f"headline photometry({theta.shape[0]} unsorted rows)",
                   reps=10)
    del dense
    roll = smoke.headline_model(tt, dev, "roll")
    device_profile(lambda: roll.simulate(theta, want_spectra=True),
                   f"headline simulate({theta.shape[0]} unsorted rows, "
                   f"want_spectra=True), variant roll", reps=10)
    del roll
    training_profile(tt, gen, dev)
    mcmc_profile(tt, gen, dev)


if __name__ == "__main__":
    main()
