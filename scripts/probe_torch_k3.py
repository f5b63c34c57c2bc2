#!/usr/bin/env python3
"""Timing probes of the port's K3 kernel (`synference_tpu_torch/csrc/
shift_num.cu`) on one NVIDIA card: where its time goes.

Builds variants of the kernel by editing its source text (each edit must
match exactly once, so a probe that no longer fits the source fails loudly),
one nvcc process per variant, and times the kernel alone (CUDA events, no
row keys and no sort) at the headline shape: 65536 rows of 2048 columns,
the headline model's own sub-column table and shifts. Variants marked
"wrong" give wrong results by design and are for timing only:

- base: the kernel as committed;
- stages3-lt128: three ring stages of 64 x 128 instead of two of 64 x 256;
- copies-only (wrong): the flux ring and the table staging without the sums;
- sums-only (wrong): the sums on whatever the ring holds, no flux copies;
- no-flux-reads (wrong), no-table-reads (wrong): the sums without their
  shared-memory reads of the flux, or of the table;
- startup-only (wrong): the search for the rs groups and nothing else.

Beside them: `fw.sum()` as the card's achievable read rate over the same
slab, the row keys with their sort, and the whole wrapper call. A second
pass gives every row the same shift, so that the sorted order is the row
order and the flux is read front to back.

Run from the repository root on a machine with a card:

    python3 scripts/probe_torch_k3.py
"""

import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

SUMS_OFF = (r"const int j1 = min\(jw1, ph\);", "const int j1 = 0;")
VARIANTS = {
    "base": [],
    "stages3-lt128": [(r"constexpr int LT = 256;", "constexpr int LT = 128;"),
                      (r"constexpr int STAGES = 2;",
                       "constexpr int STAGES = 3;")],
    "copies-only (wrong)": [SUMS_OFF],
    "sums-only (wrong)": [(r"cp_async<VEC>\(dst \+ r \* LT \+ c, n > 0 \? "
                           r"src \+ c : p.fw, n\);", "")],
    "no-flux-reads (wrong)": [(r"v = fs\[r \* LT \+ idx\];", "v = 1.f;")],
    "no-table-reads (wrong)": [
        (r"const float4 t0 = ts\[j - pl\];",
         "const float4 t0 = make_float4(1.f, 2.f, 3.f, (float)j);"),
        (r"const float4 t1 = ts\[p.tb_cols \+ j - pl\];",
         "const float4 t1 = make_float4(4.f, 5.f, 6.f, (float)j);")],
    "startup-only (wrong)": [
        (r"const int n_steps = \(item_hi - item_lo\) \* n_chunks;",
         "const int n_steps = 0 * (item_hi - item_lo) * n_chunks;")],
}


def build_variants(nvcc: str, flags, tmp: pathlib.Path) -> dict:
    """name -> the variant's `k3_shift_num`, all compiled together."""
    source = (ROOT / "synference_tpu_torch/csrc/shift_num.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for pattern, replacement in edits:
            text, n = re.subn(pattern, replacement, text)
            if n != 1:
                raise SystemExit(f"probe {name!r}: {pattern!r} matched {n} "
                                 f"times in shift_num.cu")
        (tmp / f"v{i}.cu").write_text(text)
        procs[name] = (tmp / f"v{i}.so", subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", str(tmp / f"v{i}.so"),
             str(tmp / f"v{i}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, (path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"probe {name!r} did not build:\n{err}")
        fn = ctypes.CDLL(str(path)).k3_shift_num
        fn.argtypes = [p, i64, p, p, i32, p, p, i32, i32, i32, i32, i32, i32,
                       p]
        fn.restype = i32
        out[name] = fn
    return out


def main() -> None:
    smoke.check(torch.cuda.is_available(), "no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    import synference_tpu_torch as tt
    from synference_tpu_torch.ops import _cuda
    from synference_tpu_torch.ops import photometry_kernel as pk

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        kernels = build_variants(_cuda._nvcc(), _cuda.NVCC_FLAGS,
                                 pathlib.Path(tmp))
        sim = smoke.headline_model(tt, dev, "roll")
        theta = smoke.headline_theta(dev, seed=1)
        z = theta[:, smoke.PNAMES.index("redshift")]
        table = sim._subshift_table
        g = torch.Generator(device=dev).manual_seed(0)
        fw = torch.rand(theta.shape[0], sim.grid.n_wav, generator=g,
                        device=dev)
        b, n_l = fw.shape
        n_cols = table.shape[2]
        laid = pk.band_adjacent_table(table)
        stream = torch.cuda.current_stream().cuda_stream
        print(f"[probe] fw.sum() over the ({b}, {n_l}) slab: "
              f"{smoke.time_ms(lambda: fw.sum()):.4f} ms; bound "
              f"{smoke.k3_bounds(fw, table)['bound_ms']:.4f} ms", flush=True)
        shifts = {"headline shifts": pk.shift_decompose(
            sim._shift_of_z(z), sim._max_shift)}
        shifts["one shift for every row"] = torch.full_like(
            shifts["headline shifts"], 1001)
        for what, s4 in shifts.items():
            order, keys = pk.shift_row_order(s4, n_l, n_cols)
            out = torch.empty(b, table.shape[1], device=dev)
            order_ms = smoke.time_ms(
                lambda: pk.shift_row_order(s4, n_l, n_cols))
            call_ms = smoke.time_ms(
                lambda: pk.shift_photometry_num(fw, table, s4))
            print(f"[probe] {what}: row keys and sort {order_ms:.4f} ms, "
                  f"whole call {call_ms:.4f} ms", flush=True)
            for name, fn in kernels.items():
                def call():
                    return fn(fw.data_ptr(), fw.stride(0), laid.data_ptr(),
                              keys.data_ptr(), keys.element_size(),
                              order.data_ptr(), out.data_ptr(), b, n_l,
                              table.shape[1], n_cols, laid.shape[2], 4,
                              stream)
                smoke.check(call() == 0, f"probe {name!r} did not launch")
                torch.cuda.synchronize()
                print(f"[probe] {what}, kernel alone, {name}: "
                      f"{smoke.time_ms(call):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
