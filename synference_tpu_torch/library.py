"""Mock-library generation on the device.

Counterpart of the device-resident generation path of
`synference_tpu/library.py` (`LibraryGenerator.generate` →
`_generate_device`): θ is drawn by a stratified Latin hypercube on the
device, sorted by redshift, window-planned once for the whole run, and
simulated chunk by chunk through `BatchSEDSimulator.photometry_zsorted_device`,
or through the dense `photometry` when a window would be the whole table.
Only the finished θ and photometry arrays come back to the host.

The JAX package's other generation paths — HDF5 output and chunk resume,
spectra, mesh-sharded batch functions, and the window-body auto-probe —
raise NotImplementedError naming their ROADMAP item. The host (scipy QMC)
sampler and its engines, which also take generation with a fixed redshift,
are not ported (ROADMAP M5).
"""

from __future__ import annotations

import numpy as np
import torch

from .sed import BatchSEDSimulator

__all__ = ["auto_batch_size", "draw_from_hypercube", "LibraryGenerator"]


def auto_batch_size(n: int, spectra_width: int | None = None) -> int:
    """Generation chunk size when the caller doesn't pick one: at most 65536
    rows (scaled down with the output width when full spectra are kept),
    never padding a small request up to a huge chunk."""
    cap = 65536
    if spectra_width:
        cap = int(65536 * 2048 / max(spectra_width, 2048))
        cap = max(4096, (cap // 256) * 256)
    return int(min(cap, max(256, -(-n // 256) * 256)))


def _strip_log_prefix(key: str) -> str:
    for prefix in ("log10_", "log_"):
        if key.startswith(prefix):
            return key[len(prefix):]
    return key


def draw_from_hypercube(param_ranges: dict, n: int,
                        generator: torch.Generator,
                        unlog_keys: list | None = None) -> dict:
    """Draw n samples over named (lo, hi) ranges on the generator's device
    by a classic stratified Latin hypercube (per-dimension random
    permutation plus jitter). `unlog_keys` entries are sampled in log space,
    raised to 10**x, and lose their "log10_"/"log_" prefix. Returns
    {name: (n,) float32 tensor}.
    """
    unlog_keys = unlog_keys or []
    dev = generator.device
    out = {}
    for key, (lo, hi) in param_ranges.items():
        if not lo < hi:
            raise ValueError(f"range for {key!r} must have lo < hi")
        perm = torch.randperm(int(n), generator=generator, device=dev)
        # perm/n + u/n, not (perm+u)/n: above 2^24 the f32 add perm + u
        # would drop the jitter
        u = (perm.to(torch.float32) / n
             + torch.rand(int(n), generator=generator, device=dev) / n)
        vals = (lo + (hi - lo) * u).to(torch.float32)
        if key in unlog_keys:
            vals = (10.0 ** vals).to(torch.float32)
            key = _strip_log_prefix(key)
        out[key] = vals
    return out


class LibraryGenerator:
    """θ-prior + BatchSEDSimulator -> library dict (reference schema:
    "parameters" (P, N), "photometry" (F, N), names and units).

    Args:
        simulator: the port's BatchSEDSimulator.
        param_ranges: {name: (lo, hi)}; after un-logging, the names must
            cover `simulator.param_names`.
        unlog_keys: names sampled in log10 space.
        device: where θ is drawn; must be the simulator's device.
    """

    def __init__(self, simulator: BatchSEDSimulator, param_ranges: dict,
                 unlog_keys: list | None = None, *, device):
        self.device = torch.device(device)
        if self.device != simulator.device:
            raise ValueError(f"generator device {self.device} differs from "
                             f"the simulator's {simulator.device}")
        self.simulator = simulator
        self.param_ranges = dict(param_ranges)
        self.unlog_keys = list(unlog_keys or [])
        drawn = [_strip_log_prefix(k) if k in self.unlog_keys else k
                 for k in self.param_ranges]
        missing = [p for p in simulator.param_names if p not in drawn]
        if missing:
            raise ValueError(
                f"simulator params {missing} not covered by param_ranges")

    def sample_parameters_device(self, n: int, generator: torch.Generator):
        """(N, P) θ draws on the device in simulator.param_names order."""
        draws = draw_from_hypercube(self.param_ranges, n, generator,
                                    unlog_keys=self.unlog_keys)
        return torch.stack([draws[p] for p in self.simulator.param_names],
                           dim=1)

    @staticmethod
    def _choose_zsorted_fused(sim: BatchSEDSimulator, requested) -> bool:
        """The window body: True runs K1 (the fused body), False the staged
        body. Unlike the JAX package, an unsupported True raises, and there
        is no fallback and no probe."""
        if requested == "auto":
            raise NotImplementedError(
                "zsorted_fused='auto' (time both window bodies, keep the "
                "faster, persist the choice under a process-stable digest) is "
                "not ported yet (ROADMAP M5); pass True or False")
        if requested and not sim._window_mega_supported():
            raise ValueError(
                "zsorted_fused=True but the fused window body does not "
                "support this simulator (see _window_mega_supported)")
        return bool(requested)

    def generate(self, n: int, batch_size: int | None = None, seed: int = 0,
                 out_path: str | None = None, want_spectra: bool = False,
                 pmapped_fn=None, resume_path: str | None = None,
                 zsorted_fused: bool | str = True) -> dict:
        """Generate n mock SEDs on the device; returns the library dict.

        θ comes from a `torch.Generator` seeded with `seed` on the device:
        the same seed gives other (equally valid) draws than the JAX
        package's. Rows are sorted by redshift (library rows are
        exchangeable). `zsorted_fused` picks the window body per
        `_choose_zsorted_fused` (checked even when a sub-chunk's window
        would be the whole table and the batches take the dense path).
        """
        unported = {
            "out_path": out_path is not None,
            "resume_path": resume_path is not None,
            "want_spectra": want_spectra,
            "pmapped_fn": pmapped_fn is not None,
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(
                f"generate({', '.join(asked)}) is not ported yet (ROADMAP M5 "
                "for HDF5 output and resume; M9 for spectra; M14 for "
                "mesh-sharded batches)")
        sim = self.simulator
        if batch_size is None:
            batch_size = auto_batch_size(n)
        if n == 0:
            return self._library(np.zeros((0, len(sim.param_names)), np.float32),
                                 np.zeros((0, len(sim.filters)), np.float32))
        if "redshift" not in sim.param_names:
            raise NotImplementedError(
                "generation with a fixed redshift runs on the host sampler, "
                "which is not ported yet (ROADMAP M5)")
        fuse = self._choose_zsorted_fused(sim, zsorted_fused)
        theta, sub, bs, kc, w_cols = self._draw_sorted(n, batch_size, seed)
        if kc < sim._n_knots and w_cols < sim._l_sup:
            def chunk_fn(t):
                return sim.photometry_zsorted_device(
                    t, sub_chunk=sub, kc=kc, w_cols=w_cols, fused=fuse)
        else:  # the window is the whole table: the dense path
            chunk_fn = sim.photometry
        chunks = [chunk_fn(theta[i:i + bs])
                  for i in range(0, theta.shape[0], bs)]
        photometry = torch.cat(chunks, dim=0)[:n]
        return self._library(theta[:n].cpu().numpy(),
                             photometry.cpu().numpy())

    def _draw_sorted(self, n: int, batch_size: int, seed: int):
        """θ drawn on the device, sorted by redshift and padded to whole
        batches, with one window plan for every sub-chunk of the run (one
        readback). Returns (θ, sub-chunk rows, batch rows, kc, w_cols)."""
        sim = self.simulator
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        theta = self.sample_parameters_device(n, gen)
        iz = sim.param_names.index("redshift")
        theta = theta[torch.sort(theta[:, iz], stable=True).indices]
        sub = int(min(1024, batch_size))
        bs = int(np.ceil(batch_size / sub) * sub)
        n_pad = int(np.ceil(n / bs) * bs)
        if n_pad != n:  # pad with the last (highest-z) row: windows stay tight
            theta = torch.cat([theta, theta[-1:].expand(n_pad - n, -1)], dim=0)
        # the simulator's planner, over the whole run
        _, _, kc, w_cols, _, _ = sim._plan_windows(theta, sub)
        return theta, sub, bs, kc, w_cols

    def _library(self, theta: np.ndarray, photometry: np.ndarray) -> dict:
        sim = self.simulator
        return {
            "parameters": theta.T,  # (P, N) reference convention
            "parameter_names": list(sim.param_names),
            "photometry": photometry.T,  # (F, N)
            "filter_codes": list(sim.filters.codes),
            "photometry_units": "nJy",
        }
