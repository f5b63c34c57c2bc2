#!/usr/bin/env python3
"""How close K1's and K2's first product comes to the exact answer on an
NVIDIA card, beside the fp32, 3xTF32, one-pass TF32 and bf16 products.

At five main-path shapes (K1 over a north-star batch of 64 z-sorted
sub-chunks, K2 on the headline model's 65536 unsorted rows, K2 at the
north-star width, K1 and K2 at the paper-63 width with F8 = 64), the script
holds each of these against the exact answer, the plain pipeline with the
first product taken in float64 and rounded to float32:

- "fp32": the plain version, TF32 off (cuBLAS float32);
- "kernel": K1 (one grouped launch) or K2 through its wrapper;
- "3xtf32": three TF32 matrix products on the card's tensor cores,
  (lo_a·hi_b + hi_a·lo_b) + hi_a·hi_b, from inputs split with `cvt.rna`
  semantics (hi rounded to TF32 to nearest, lo = a − hi);
- "tf32": one TF32 product of the float32 inputs (cuBLAS, TF32 on);
- "bf16": one product of the inputs rounded to bf16.

Statistics are relative differences on fluxes above 1e-3 of their row's
maximum, as in `chip_smoke.py::rel_stats`: p99, max, and the share of
fluxes off by more than 1e-5. The gate (`ops/fused_sed.py::exact_gate`) is
p99 < 1e-5, max < 1e-3 and a share at most twice the fp32 version's plus
1e-4. The kernel's time, the cuBLAS float32 first product's (the
yardstick, never called by the port) and the time of the route a user
calls there (K1: `photometry_zsorted_device(..., fused=True)` on the
batch, the library's window body; K2: `photometry()`) are CUDA events.

    python3 scripts/probe_torch_tf32x3.py [--orders 1 3] [--shapes ...]
        [--root DIR] [--out FILE] [--save DIR]

`--root` imports the package from another checkout (a parent commit
unpacked with `git archive`), so two versions of the kernels can be held to
the same references and timed in one call on one card; `--save` writes
each kernel output to a directory, so their bits can be compared. The
references, the split and the gate are always this checkout's
(`fused_window_photometry_reference` with `first_product=`,
`exact_first_product`, `tf32_split`, `exact_gate`); only the kernels come
from `--root`. Prints the card's name and power limit first. Needs a
card: exits with an error without one.
"""

import argparse
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ("k1_north_star", "k2_headline", "k2_north_star", "k1_paper63",
          "k2_paper63")
ROUTES = {"k1": "the fused window body on the batch",
          "k2": "photometry() on the batch"}


def products(ref):
    """Name -> first product (sfzh, sed_w) -> lnu, float32 output, from the
    plain pieces of this checkout's package `ref`."""
    def with_tf32(fn):
        def run(a, b):
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return fn(a, b)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return run

    def three(a, b):
        hi_a, lo_a = ref.tf32_split(a)
        hi_b, lo_b = ref.tf32_split(b)
        return (lo_a @ hi_b + hi_a @ lo_b) + hi_a @ hi_b

    return {"fp32": torch.matmul,
            "3xtf32": with_tf32(three),
            "tf32": with_tf32(torch.matmul),
            "bf16": lambda a, b: a.bfloat16().float() @ b.bfloat16().float()}


def load_package(root: pathlib.Path):
    """The package under test: this checkout's, or another checkout's
    loaded beside it as `probe_root_pkg` (its imports are relative)."""
    if root.resolve() == ROOT:
        import synference_tpu_torch
        return synference_tpu_torch
    init = root / "synference_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "probe_root_pkg", init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["probe_root_pkg"] = pkg
    spec.loader.exec_module(pkg)
    return pkg


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


def shape_cases(cs, tt, k1, ref, names, dev):
    """name -> (kernel(order), plain(fp, order), sfzh, sed, shape, route)
    at each shape, from the models `chip_smoke.py` drives; `route()` runs
    the path a user calls that launches the kernel there: the z-sorted
    window engine's fused body on the batch (K1) or `photometry()` (K2)."""
    cases = {}
    need_ns = any("north_star" in n for n in names)
    need_p63 = any("paper63" in n for n in names)
    if need_ns:
        sim, gen = cs.build_model(tt, dev)
    if "k1_north_star" in names:
        theta, sub, bs, kc, w_cols, _ = gen._draw_sorted(
            cs.N_LIBRARY, cs.BATCH, seed=0)
        mid = (theta.shape[0] // bs // 2) * bs
        chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(
            theta[mid:mid + bs], sub, kc, w_cols)
        g = sim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
        batch = theta[mid:mid + bs]
        cases["k1_north_star"] = grouped_case(
            k1, ref, g, lambda plan=(sub, kc, w_cols): sim.photometry_zsorted_device(
                batch, sub_chunk=plan[0], kc=plan[1], w_cols=plan[2],
                fused=True))
    if "k2_headline" in names:
        hsim = cs.headline_model(tt, dev, "auto")
        htheta = cs.headline_theta(dev)
        cases["k2_headline"] = dense_case(
            k1, ref, cs.k2_args(hsim, htheta),
            lambda: hsim.photometry(htheta))
    if "k2_north_star" in names:
        g = torch.Generator(device=dev).manual_seed(7)
        ntheta = gen.sample_parameters_device(cs.HEADLINE_BATCH, g)
        cases["k2_north_star"] = dense_case(
            k1, ref, cs.k2_args(sim, ntheta), lambda: sim.photometry(ntheta))
    if need_p63:
        grid = (sim.grid if need_ns else cs.build_model(tt, dev)[0].grid)
        emission = tt.EmissionConfig(reprocessed_types=("total",))
        auto = tt.BatchSEDSimulator(grid, tt.load_instrument_filters(),
                                    cs.PNAMES, sfh="lognormal",
                                    zdist="delta", emission=emission,
                                    device=dev)
        gen63 = tt.LibraryGenerator(auto, cs.PRIOR,
                                    unlog_keys=["log10_peak_age"],
                                    device=dev)
        theta = gen63.sample_parameters_device(
            cs.HEADLINE_BATCH, torch.Generator(device=dev).manual_seed(16))
        z = theta[:, cs.PNAMES.index("redshift")]
        sorted_theta = theta[torch.sort(z, stable=True).indices]
        if "k2_paper63" in names:
            cases["k2_paper63"] = dense_case(
                k1, ref, cs.k2_args(auto, theta),
                lambda: auto.photometry(theta))
        if "k1_paper63" in names:
            chunk, sub, kc, w_cols, k0, l0 = auto._plan_windows(sorted_theta,
                                                                1024)
            g = auto._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
            cases["k1_paper63"] = grouped_case(
                k1, ref, g, lambda: auto.photometry_zsorted_device(
                    sorted_theta, sub_chunk=1024, fused=True))
    return cases


def grouped_case(k1, ref, g, route):
    def kernel(order):
        return k1.fused_window_photometry_grouped(**dict(g, order=order))

    def plain(fp, order):
        return ref.fused_window_photometry_grouped_reference(
            **dict(g, order=order), first_product=fp)

    w = g["w_cols"]
    shape = (f"B={g['sfzh'].shape[0]} C={g['sfzh'].shape[1]} W={w} "
             f"kc={g['kc']} F8={g['f8']} sub={g['sub']} "
             f"({len(g['k0'])} sub-chunks)")
    return kernel, plain, g["sfzh"], g["tables"]["sed"][:, :w], shape, route


def dense_case(k1, ref, a, route):
    def kernel(order):
        t = dict(sed=a["sed_w"], curve=a["curve_w"], knot=a["knot_w"],
                 den=a["den_w"])
        return k1.fused_sed_photometry(
            a["sfzh"], a["s_rel"], a["tau_v"], a["scale"], t, a["kc"],
            a["delta"], a["f8"], order=order, fesc=a["fesc"])

    def plain(fp, order):
        return ref.fused_window_photometry_reference(
            **dict(a, order=order), first_product=fp)

    shape = (f"B={a['sfzh'].shape[0]} C={a['sfzh'].shape[1]} "
             f"L={a['sed_w'].shape[1]} n_knots={a['kc']} F8={a['f8']}")
    return kernel, plain, a["sfzh"], a["sed_w"], shape, route


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--orders", type=int, nargs="+", default=[1, 3])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=SHAPES)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save", default=None,
                    help="directory to save each kernel output in (.pt), "
                         "to compare two checkouts' bits")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_tf32x3: needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from synference_tpu_torch.ops import fused_sed as ref

    tt = load_package(pathlib.Path(args.root))
    k1 = importlib.import_module(f"{tt.__name__}.ops.fused_sed")
    cuda = importlib.import_module(f"{tt.__name__}.ops._cuda")
    _, secs, _ = cuda.build_library()
    print(f"package {pathlib.Path(tt.__file__).parent}; kernels built in "
          f"{secs:.1f} s", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cases = shape_cases(cs, tt, k1, ref, args.shapes, dev)
    print(f"models built in {time.perf_counter() - t0:.1f} s", flush=True)
    fps = products(ref)
    report = {}
    for name in args.shapes:
        kernel, plain, sfzh, sed, shape, route = cases[name]
        print(f"== {name}: {shape}", flush=True)
        for order in args.orders:
            ex = plain(ref.exact_first_product, order)
            outs = {k: plain(fp, order) for k, fp in fps.items()}
            outs["kernel"] = kernel(order)
            torch.cuda.synchronize()
            if args.save:
                pathlib.Path(args.save).mkdir(parents=True, exist_ok=True)
                torch.save(outs["kernel"].cpu(),
                           pathlib.Path(args.save) / f"{name}_o{order}.pt")
            rows = {k: ref.exact_gate(v, ex, outs["fp32"])
                    for k, v in outs.items()}
            for k in ("fp32", "kernel", "3xtf32", "tf32", "bf16"):
                st = rows[k]
                print(f"order {order} {k:>7} vs exact: p99={st['p99']:.3e} "
                      f"max={st['max']:.3e} share>1e-5={st['share']:.3e} "
                      f"gate {'pass' if st['ok'] else 'FAIL'}", flush=True)
            # the gate's readings with the fp32 plain version as the answer
            kp = ref.exact_gate(outs["kernel"], outs["fp32"], outs["fp32"])
            print(f"order {order}  kernel vs fp32 plain: p99={kp['p99']:.3e}"
                  f" max={kp['max']:.3e} share>1e-5={kp['share']:.3e}",
                  flush=True)
            rows["kernel_vs_fp32"] = kp
            report[f"{name}/order{order}"] = rows
            del outs, ex
        ms = time_ms(lambda: kernel(3), args.reps)
        fp_ms = time_ms(lambda: torch.matmul(sfzh, sed), args.reps)
        route_ms = time_ms(route, args.reps)
        print(f"{name}: kernel {ms:.4f} ms (order 3); cuBLAS fp32 first "
              f"product {fp_ms:.4f} ms; its route ({ROUTES[name[:2]]}) "
              f"{route_ms:.4f} ms (CUDA events)", flush=True)
        report[name] = {"shape": shape, "kernel_ms": ms,
                        "cublas_fp32_first_product_ms": fp_ms,
                        "route_ms": route_ms}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
