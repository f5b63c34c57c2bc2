"""The lognormal × delta-Z SFZH in one kernel (`csrc/sfzh.cu`) and its plain
version.

No TPU kernel: the JAX package's `_sfzh` (`synference_tpu/sed.py:541`) is
XLA code. `BatchSEDSimulator._sfzh` takes this kernel for the north-star
model family (lognormal SFH, delta Z, no extra axes or particles, at most 64
ages) on the card; everything (B,)-wide (max_age, μ, τ, mass, the delta-Z
cells) stays in PyTorch, from `sfh.lognormal_shape` and `sfh.delta_cells`,
and the kernel does what is (B, A+1) or (B, A·Z) wide. Its bits equal the
plain version's on the card (`csrc/sfzh.cu`, "Bits"), so the window bodies
read the same inputs either way; `scan_chunk` mirrors the one choice of
torch's that those bits depend on.
"""

from __future__ import annotations

import torch

from .. import sfh
from ._cuda import refuse_autodiff

__all__ = ["lognormal_delta_sfzh", "lognormal_delta_sfzh_reference",
           "scan_chunk", "MAX_AGES"]

# the kernel holds a row's age bins in one warp, two a lane
MAX_AGES = 64

_U32 = 0xFFFFFFFF


def scan_chunk(num_rows: int, row_size: int) -> int | None:
    """The width of the chunks in which `torch.cumsum` scans each row of a
    contiguous (num_rows, row_size) float tensor on the card: 2·2^log_x,
    with ATen's `get_log_num_threads_x_inner_scan<uint32_t>`
    (`ATen/native/cuda/ScanUtils.cuh`), its unsigned wrap-around included
    (at row_size 64: 32 for 33-32768 rows, 1024 from 32769 rows on). None
    for one row, which torch scans with cub's device-wide scan instead."""
    if num_rows < 2:
        return None
    log_x = (row_size - 1).bit_length()  # least with 2**log_x >= row_size
    log_y = (num_rows - 1).bit_length()
    log_x = ((9 + ((log_x - log_y) & _U32)) & _U32) // 2
    return 2 << min(max(4, log_x), 9)


def lognormal_delta_sfzh_reference(max_age, mu, tau, mass, z_idx, z_frac,
                                   edges, n_met: int, marginal: bool = True):
    """The plain version: `BatchSEDSimulator._sfzh`'s PyTorch ops for a
    lognormal SFH and a delta Z, from the same (B,) prologue. Returns the
    (B, A·n_met) SFZH [Msun], age-major, and the (B, A) age marginal (None
    unless `marginal`)."""
    w_age = sfh.bin_weights(sfh.lognormal_cdf(
        sfh.edge_times(max_age, edges), mu[:, None], tau[:, None]))
    w_met = sfh.delta_weights(z_idx, z_frac, n_met)
    sfzh = (w_age[:, :, None] * w_met[:, None, :]) * mass.reshape(-1, 1, 1)
    b = sfzh.shape[0]
    return sfzh.reshape(b, -1), sfzh.sum(dim=2) if marginal else None


def _check(max_age, mu, tau, mass, z_idx, z_frac, edges, n_met):
    who = "lognormal_delta_sfzh"
    b, a = max_age.shape[0], edges.shape[0] - 1
    vectors = dict(max_age=max_age, mu=mu, tau=tau, mass=mass, z_idx=z_idx,
                   z_frac=z_frac)
    for name, t in dict(vectors, edges=edges).items():
        want = torch.int64 if name == "z_idx" else torch.float32
        if t.device != max_age.device or t.dtype != want or t.ndim != 1:
            raise ValueError(f"{who}: {name} must be a 1-D {want} tensor on "
                             f"{max_age.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if any(t.shape[0] != b for t in vectors.values()):
        raise ValueError(f"{who}: the (B,) inputs differ in length")
    if not 1 <= a <= MAX_AGES or n_met < 2:
        raise ValueError(f"{who}: needs 1 to {MAX_AGES} ages and at least 2 "
                         f"metallicities, got {a} and {n_met}")
    if scan_chunk(b, a) is None:
        raise ValueError(f"{who}: torch sums a batch of {b} row with cub's "
                         "device-wide scan, whose order the kernel does not "
                         "follow; take the plain version")


def lognormal_delta_sfzh(max_age, mu, tau, mass, z_idx, z_frac, edges,
                         n_met: int, marginal: bool = True):
    """(B, A·n_met) SFZH [Msun] and (B, A) age marginal (None unless
    `marginal`) of a lognormal SFH and a delta Z, one kernel per call.

    Args:
        max_age, mu, tau, mass: (B,) float32: the oldest-star age [yr], the
            lognormal's μ and τ (`sfh.lognormal_shape`), 10^log10_mass.
        z_idx, z_frac: (B,) int64 and float32 delta-Z cells
            (`sfh.delta_cells`).
        edges: (A+1,) float32 lookback age-bin edges [yr], A <= 64.
        n_met: Z, the grid's metallicities (at least 2).

    CPU tensors go through `lognormal_delta_sfzh_reference`. CUDA tensors
    launch the kernel (`csrc/sfzh.cu`) on the current stream, with the bits
    of the plain version there; inputs it does not take raise ValueError
    (among them a batch of one row: `scan_chunk`), a failed launch or an
    input that needs a gradient RuntimeError (`_cuda.refuse_autodiff`).
    Each launch adds one to `lognormal_delta_sfzh.launches`.
    """
    if max_age.device.type == "cpu":
        return lognormal_delta_sfzh_reference(
            max_age, mu, tau, mass, z_idx, z_frac, edges, n_met, marginal)
    who = "lognormal_delta_sfzh"
    if max_age.device.type != "cuda":
        raise ValueError(f"{who}: tensors on {max_age.device} are neither "
                         "CPU nor CUDA")
    refuse_autodiff(who, max_age, mu, tau, mass, z_frac, edges)
    _check(max_age, mu, tau, mass, z_idx, z_frac, edges, n_met)
    from ._cuda import load_library

    lib = load_library()
    max_age, mu, tau, mass, z_idx, z_frac, edges = (
        t.contiguous() for t in (max_age, mu, tau, mass, z_idx, z_frac,
                                 edges))
    b, a = max_age.shape[0], edges.shape[0] - 1
    sfzh = torch.empty((b, a * n_met), dtype=torch.float32,
                       device=max_age.device)
    age = (torch.empty((b, a), dtype=torch.float32, device=max_age.device)
           if marginal else None)
    stream = torch.cuda.current_stream(max_age.device).cuda_stream
    err = lib.sfzh_lognormal_delta(
        max_age.data_ptr(), mu.data_ptr(), tau.data_ptr(), mass.data_ptr(),
        z_idx.data_ptr(), z_frac.data_ptr(), edges.data_ptr(),
        sfzh.data_ptr(), None if age is None else age.data_ptr(), b, a,
        n_met, int(scan_chunk(b, a) < a), 1.0 / a, stream)
    if err:
        raise RuntimeError(
            f"SFZH kernel launch failed: {lib.k1_error_string(err).decode()}")
    lognormal_delta_sfzh.launches += 1
    return sfzh, age


lognormal_delta_sfzh.launches = 0
