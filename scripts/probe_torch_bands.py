#!/usr/bin/env python3
"""Time K1 and K2 at many bands on an NVIDIA card.

At F8 > 8 bands both kernels run in thread-block clusters of
`cluster_size(F8)` band groups that share each galaxy tile's first
product. This script times, in one process on one card, the kernel at F8
beside the same kernel launched once on each 8-band slice of the tables:
the slices together do the work of a kernel that recomputes the first
product for every band group, as K1 and K2 did before the clusters. It
checks that the clustered output equals the slices' bit for bit.

Shapes are the paper-63 model's (`chip_smoke.py` phase 16), with random
tables made from a seed: K2 over B = 65536 rows, C = 768 cells, L = 6793
columns and 200 knots; K1 over 64 sub-chunks of 1024 rows, windows of
W = 4352 columns and kc = 12 knots. Bounds are computed as `chip_smoke.py`
computes them (H100 SXM datasheet peaks). K1's sub-chunks are z-sorted,
so their galaxies read one pass of knots, as on the main path. Also
prints how many clusters of each size the card keeps resident
(cudaOccupancyMaxActiveClusters).

    python3 scripts/probe_torch_bands.py [--f8 16 64] [--reps 5]
        [--repeat N]
    python3 scripts/probe_torch_bands.py --f8 8 --root DIR

`--f8 8` times each kernel alone at 8 bands; `--root` imports the package
from another checkout (a parent commit unpacked with `git archive`), so two
versions can be timed in one call on one card. `--repeat N` launches the
clustered kernel N more times and counts the launches whose bits differ
from the slices' (a race in the clusters' hand-off shows there). Prints
the card's name and power limit first; times are CUDA events.
"""

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

PEAK_BYTES_S, PEAK_FP32_FLOP_S, PEAK_BF16_FLOP_S = 3.35e12, 67e12, 989e12


def bound_ms(flops_fp32, flops_bf16, nbytes):
    return 1e3 * max(flops_fp32 / PEAK_FP32_FLOP_S
                     + flops_bf16 / PEAK_BF16_FLOP_S, nbytes / PEAK_BYTES_S)


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tables(g, c, n_l, n_knots, f8, dev):
    return dict(
        sed=torch.rand(c, n_l, generator=g, device=dev) * 1e20,
        curve=torch.rand(n_l, generator=g, device=dev),
        knot=torch.rand(n_l, n_knots * f8, generator=g, device=dev).to(
            torch.bfloat16),
        den=torch.rand(n_knots, f8, generator=g, device=dev) + 1.0)


def report(k1, name, launch, t, n_knots, f8, bnd, reps, repeat=0):
    if f8 == 8:
        ms = time_ms(lambda: launch(t, 8), reps)
        print(f"{name} F8=8: {ms:.4f} ms, share of its bound {bnd / ms:.3f} "
              f"(bound {bnd:.4f} ms)", flush=True)
        return True
    sliced = [k1.band_group_tables(t, g, n_knots)
              for g in range(f8 // 8)]
    out = launch(t, f8)
    parts = torch.cat([launch(s, 8) for s in sliced], dim=1)
    torch.cuda.synchronize()
    same = torch.equal(out, parts)
    if repeat:
        differ = 0
        for _ in range(repeat):
            differ += not torch.equal(launch(t, f8), parts)
        print(f"{name} F8={f8}: {differ} of {repeat} more launches differ "
              "from the slices", flush=True)
        same &= differ == 0
    ms = time_ms(lambda: launch(t, f8), reps)
    ms_slices = time_ms(lambda: [launch(s, 8) for s in sliced], reps)
    ms_one = time_ms(lambda: launch(sliced[0], 8), reps)
    print(f"{name} F8={f8}: clustered {ms:.4f} ms, share of its bound "
          f"{bnd / ms:.3f} (bound {bnd:.4f} ms); {f8 // 8} 8-band slices "
          f"{ms_slices:.4f} ms (one slice {ms_one:.4f} ms); clustered / "
          f"slices {ms / ms_slices:.3f}; bitwise equal to the slices: {same}",
          flush=True)
    return same


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--f8", type=int, nargs="+", default=[64])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--repeat", type=int, default=0,
                    help="launches of the clustered kernel to hold to the "
                         "slices' bits after the first")
    ap.add_argument("--root", default=None,
                    help="import synference_tpu_torch from this checkout")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_bands: needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from synference_tpu_torch.ops import _cuda
    from synference_tpu_torch.ops import fused_sed as k1

    print(f"kernels from {pathlib.Path(k1.__file__).parents[2]}", flush=True)
    lib = _cuda.load_library()
    if hasattr(lib, "k1_max_active_clusters"):
        import ctypes

        resident = []
        for n in range(1, 9):
            out = ctypes.c_int(0)
            err = lib.k1_max_active_clusters(n, ctypes.byref(out))
            resident.append(out.value if err == 0 else f"error {err}")
        print(f"resident clusters of 1..8 blocks: {resident}", flush=True)
    ok = True
    for f8 in args.f8:
        if f8 > 8:
            print(f"cluster_size({f8}) = {k1.cluster_size(f8)}", flush=True)
        ok &= run(k1, f8, args.reps, args.repeat)
    if not ok:
        raise SystemExit("probe_torch_bands: clustered output differs from "
                         "the 8-band slices")


def run(k1, f8, reps, repeat=0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    c, n_knots, delta = 768, 200, 4

    # K2 over the whole table, rows in any order
    b, n_l = 65536, 6793
    t = tables(g, c, n_l, n_knots, f8, dev)
    sfzh = torch.rand(b, c, generator=g, device=dev) * 1e9
    s = torch.as_tensor(rng.uniform(0, (n_knots - 1) * delta, b),
                        dtype=torch.float32, device=dev)
    tau = torch.rand(b, generator=g, device=dev)
    scale = torch.rand(b, generator=g, device=dev) + 0.5

    def k2(tab, f):
        return k1.fused_sed_photometry(sfzh, s, tau, scale, tab, n_knots,
                                       delta, f)

    ok = report(k1, "K2", k2, t, n_knots, f8, bound_ms(
        2.0 * b * c * n_l, 2.0 * b * n_l * 4 * f8,
        4 * (b * c + c * n_l + n_l + n_knots * f8 + 3 * b + b * f8)
        + 2 * n_l * n_knots * f8), reps, repeat)

    # K1: 64 z-sorted sub-chunks of 1024 rows, each with its own window;
    # a sub-chunk's galaxies read knots 0-5 of its window (one pass)
    sub, n_sub, w, kc = 1024, 64, 4352, 12
    k0 = np.sort(rng.integers(0, n_knots - kc + 1, n_sub))
    l0 = np.sort(rng.integers(0, n_l - w + 1, n_sub))
    s1 = torch.as_tensor(np.repeat(k0, sub) * delta
                         + np.sort(rng.uniform(delta, 4 * delta, n_sub * sub)),
                         dtype=torch.float32, device=dev)

    def k1g(tab, f):
        return k1.fused_window_photometry_grouped(
            sfzh, s1, tau, scale, tab, k0, l0, sub, w, kc, delta, f)

    bnd = n_sub * bound_ms(
        2.0 * sub * c * w, 2.0 * sub * w * kc * f8,
        4 * (sub * c + c * w + w + kc * f8 + 3 * sub + sub * f8)
        + 2 * w * kc * f8)
    ok &= report(k1, "K1", k1g, t, n_knots, f8, bnd, reps, repeat)
    return ok


if __name__ == "__main__":
    main()
