// The SED -> photometry core shared by K1 (fused_window.cu) and K2
// (fused_sed.cu), for Hopper (sm_90a). Together they replace the TPU Pallas
// kernel `synference_tpu/ops/fused_sed.py::_mega_kernel`.
//
// One block owns TG = 128 galaxies and one group of 8 bands (blockIdx.y).
// At more than 8 bands the blocks of one galaxy tile form a thread-block
// cluster that computes the first product once (see "Band groups" below).
// Over its λ window of W columns (K1: a z-sorted sub-chunk's window, K2:
// the whole λ support) and its knot table of nk rows it computes
//
//   lnu[b,l]  = Σ_c sfzh[b,c] · sed[c,l]               (fp32 FMA, c ascending)
//   fw[b,l]   = bf16( lnu · (fesc + (1−fesc)·exp(−τ_V[b]·k[l])) )
//
// or, with a birth-cloud screen (Charlot & Fall 2000: the young cells, a
// prefix c < cy of the age-major cells, also sit behind τ_BC), in one
// accumulator:
//
//   lnu[b,l]  = (Σ_{c<cy} sfzh·sed) · exp(−τ_BC[b]·k[l]) + Σ_{c≥cy} sfzh·sed
//
// or, with a per-row escape fraction (Pacman emission: a second table, the
// incident light, escapes unscreened), in one accumulator:
//
//   fw[b,l]   = bf16( fesc[b]·Σ_c sfzh·inc[c,l]
//                     + (1−fesc[b])·exp(−τ_V[b]·k[l])·Σ_c sfzh·sed[c,l] )
//
//   acc[b,k,f] = Σ_l fw[b,l] · knot[l, k·F8 + f]         (bf16 in, fp32 sum)
//   out[b,f]  = interp(acc[b,·,f]; s[b]) / max(interp(den[·,f]; s[b]), 1e-30)
//               · scale[b]
//
// interp as in knot_interp.cuh over the block's nk knots.
//
// What bounds it on the H100: the first product, 2·C·W FLOPs per galaxy
// against a few hundred bytes of per-galaxy input, so fp32 FMA issue
// (67 TFLOP/s). It stays on the CUDA cores as one fp32 FMA chain per
// lnu[b,l] over cells in ascending order. Measured against the exact
// answer (the product in float64, rounded once to fp32;
// `fused_window_photometry_exact`), that chain passes the kernels' gate
// (`exact_gate`) at every main-path shape, and the tensor-core schemes do
// not: one-pass TF32 and bf16 by ~100 times, and 3xTF32 (hi = TF32(a)
// rounded to nearest, lo = a − hi, lo·hi + hi·lo + hi·hi) run through the
// card's own TF32 tensor-core path also fails it, p99 2.5e-5 at 768 cells
// (the tensor cores' accumulation, not the split: the same split with
// float32 sums passes on the CPU). scripts/probe_torch_tf32x3.py and
// PERF.md hold the readings. The operands stream from L2: a stage of 32
// cells brings 32 KB for 2·128·128·32 FLOPs, 0.031 bytes per FLOP, ~1.4
// TB/s at 45 TFLOP/s, within what L2 gives; so FMA issue stays the bound.
//
// Design.
// - First product: a 128 × 128 (galaxy × λ) block tile, two consumer
//   warpgroups (256 threads), an 8 × 8 register tile per thread.
// - Its operands come by TMA, issued by one thread of a producer
//   warpgroup, into a ring of NST stages of KB = 32 cells (16 KB of A and
//   16 KB of B a stage) under full and empty mbarriers: a consumer warp
//   waits only for the stage it reads, and no consumer thread spends an
//   instruction on a copy (the cp.async ring this replaces cost each thread
//   10 copies and a block barrier per 16 cells). `setmaxnreg` moves
//   registers from the producer (40) to the consumers (232), 1 block of 384
//   threads per SM (without it the consumers spill and run 8% slower).
//   Measured on an H100 and left out, each within 2%: 3 or 5 stages, one
//   stage release per warp, fragment loads a step ahead.
// - Both operands K-major, 32 cells (128 bytes) per row of a stage, in
//   TMA's 128-byte swizzle: A is sfzh itself, row-major [galaxy][cell] (for
//   K2 its rows gathered in the order the blocks visit them; a copy only
//   when C is not a multiple of 4, `k_major`); B the (L, C) transpose of
//   the spectra, made once per simulator ("sed_k", `k_major`). So a window
//   that starts at any λ, and a sub-chunk that starts at any row, is a TMA
//   row coordinate; a box's cell coordinate is always a multiple of 32
//   (with the window start as a column coordinate, K1's unaligned starts
//   stalled the ring on the card). Cells
//   and rows past a tensor's end come in as zeros and add exact zeros; the
//   screen sets the columns past the window to zero, and rows of a tile
//   past its sub-chunk are computed and dropped (each row of both products
//   depends on its own input row only).
// - A thread's 8 × 8 tile is galaxies ty + 16i and λ columns tx + 16j:
//   each takes 16-byte loads of 4 cells of one row, the swizzle spreads a
//   warp's 16 B rows over all banks, and 16 loads feed 256 FMAs.
// - Screen and bf16 rounding in registers, fw into shared memory.
// - Knot product on the tensor cores: mma.sync m16n8k16 bf16 with fp32
//   accumulation (the inputs are bf16 already, so only the summation order
//   differs from the plain version), one warp per 16 galaxies, against a
//   slab of 8 knots × 8 bands per λ chunk that 16-byte cp.async copies bring
//   in while the first product runs. The (128 × 64) fp32 accumulator lives
//   in shared memory between λ chunks.
// - Knot band: a galaxy reads the 4 knots k−1..k+2 around its own shift.
//   The block contracts the union of its galaxies' knots in passes of 8
//   knots that start 5 apart, so each galaxy's 4 knots lie in one pass and
//   it is finished at the end of that pass. One pass when rows arrive sorted
//   by shift (K1's z-sorted sub-chunks, K2's row order); wider spans take
//   more passes and stay exact.
// - No split over cells or λ, no atomics, no partial buffers: two runs give
//   the same bits, and the same bits as the cp.async core before it (the
//   same FMA chain and mma.sync steps).
//
// Birth cloud (`run<·, true>`, its own kernels). The FMA chain of each lnu
// element runs over the young prefix, is scaled by exp(−τ_BC[b]·k[l]) once
// it has taken cell cy − 1, and goes on over the old cells into the same
// accumulator (`first_product`): the first product stays 2·C·W FLOPs a row,
// with no second table and no second accumulator tile. The ring stage that
// holds cell cy runs as two cell ranges around the rescale, whole groups of
// 4 cells by 16-byte loads and a group cut by cy one cell at a time, so cy
// may be any cell (no padding; on the north-star grid cy = 300, group 3 of
// stage 9). The epilogue's ISM screen is unchanged. The one-screen kernels
// (`run<·, false>`) compile without any of it.
//
// Escape (`run<·, false, true>`, its own kernels; Pacman emission, fesc a
// column of θ). The ring streams each chunk's cells twice: n_kb stages of
// the reprocessed table (`b_map`), then n_kb stages of the incident table
// (`b2_map`), the same SFZH box as A both times, so the ring, its stages
// and the shared memory are the one-screen kernel's. Each lnu element's
// FMA chain runs over the reprocessed cells and is then scaled by
// (1−fesc[b])·exp(−τ_V[b]·k[l]) (`escape_split`); a second accumulator
// tile takes the incident cells' chain from zero, and the two meet in one
// FMA, lnu = fesc[b]·inc + lnu, so the epilogue only rounds: 4·C·W + 2·W
// FLOPs a row. Nothing is divided: fesc = 0 adds an exact zero (the
// one-screen kernel's bits), fesc = 1 zeroes the reprocessed part.
// Measured on an H100 and left out: one chain over the stacked cells
// [total | incident], the incident cells' A values scaled by fesc (no
// second tile): 1.5-2% slower at F8 8, and adding many small escaped
// terms to a large screened sum put 0.3% of the fluxes more than 1e-5
// off, twice the share cuBLAS's fp32 product puts there (`exact_gate`
// fails); and one ring stage of A with both tables (A loaded once): 48 KB
// a stage fits the lone block's shared memory twice, not four times. The
// lone escape kernels hold both tiles without a spill; a cluster's
// consumers (176 registers) spill (884 bytes stored against the
// one-screen cluster kernel's 104), with 16-, 8- or 4-byte operand loads
// alike, and run 1.22× the one-chain scheme at F8 64. They keep the two
// tiles: the same FMAs in the same order as a lone block's, so the bits
// of a cluster are still those of its 8-band slices.
//
// Band groups (F8 > 8). lnu and fw do not depend on the band, so the blocks
// of one galaxy tile that differ only in their band group (blockIdx.y) run
// as one cluster of n ≤ 8 blocks (`run<true>`, launched with
// cudaLaunchKernelEx and a (1, n, 1) cluster dimension; n is chosen by the
// caller, `cluster_size` in ops/fused_sed.py). The cluster walks the window
// in super-chunks of n λ chunks: block r computes the first product and
// screen of chunk r of the super-chunk into its own fw tile, exactly as a
// lone block does, and every block contracts all n fw tiles, in ascending
// λ, against its own band group's knot slab, reading its peers' tiles
// through distributed shared memory (16-byte loads of a fragment-major
// tile) and streaming the slab in 64-row halves (one in flight while the
// other is contracted). Each lnu element is computed once per cluster, and
// the knot product's accumulator sees the same mma.sync steps in the same
// order as in a lone block, so the output equals, bit for bit, the kernel
// run on each 8-band slice of the tables. F8 = 8 takes `run<false>`
// unclustered. A padding slot of the last cluster (more slots than band
// groups) computes its share of the first product and no bands.
//
// A cluster's block is warp-specialised three ways (512 threads, 1 block
// per SM): the producer; the two FMA warpgroups (first product and
// screen); and a knot team of one warpgroup that contracts super-chunk s
// while the FMA warpgroups compute s + 1. That overlap is what a lone
// block's knot phase does without (at F8 64 the knot phase is about a
// quarter of the kernel: 8 tiles of knots for every chunk of first
// product). Each block holds two fw tiles, and the hand-off is a pair of
// mbarriers per tile in every block, arrived on from the peers with
// release and waited on with acquire at cluster scope: fw_full[b] (one
// arrival per block once its tile b is written) and fw_empty[b] (one per
// knot team once it has read every tile b). The knot team keeps its
// accumulator (2 row tiles of 16 galaxies a warp) in registers over a
// pass. Registers by `setmaxnreg`: 176 for the FMA warpgroups, 24 for the
// producer, the knot team at its launch 128; the ring has NST_CL = 3 stages
// to leave room for the second fw tile.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knot_interp.cuh"

namespace sed_tile {

constexpr int TG = 128;    // galaxies per block
constexpr int TL = 128;    // λ columns per chunk
constexpr int KB = 32;     // cells per ring stage
constexpr int NST = 4;     // ring stages of a lone block
constexpr int NST_CL = 3;  // and of a cluster's block (two fw tiles)
constexpr int NC = 256;    // consumer threads: two warpgroups
constexpr int NT = NC + 128;  // and the producer warpgroup
constexpr int NT_CL = NT + 128;  // a cluster's block: and the knot team
constexpr int NCWARP = NC / 32;
constexpr int CONSUMER_REGS = 232;  // 2·128·232 + 128·40 = 384·168, the
constexpr int PRODUCER_REGS = 40;   // registers of 384 threads at launch
// A cluster's block: 2·128·176 + 128·24 + 128·128 (the knot team keeps its
// launch count) ≤ 512·128. Measured on an H100: with the knot team raised
// to 136 as well (the whole register file), about 2% of launches at F8 64
// gave one FMA warp's fluxes wrong; with this split none in 500, nor with
// 168/40 or with no `setmaxnreg` at all.
constexpr int CL_CONSUMER_REGS = 176;
constexpr int CL_PRODUCER_REGS = 24;
constexpr int FB = 8;     // bands per block (blockIdx.y walks band groups)
constexpr int NKP = 8;    // knots per pass
constexpr int NQ = 4;     // knots a galaxy reads (k−1..k+2)
constexpr int PASS_STEP = NKP - NQ + 1;  // passes overlap by 3 knots
constexpr int NJ = NKP * FB;  // knot-product columns per pass (64)
constexpr int LDF = TL + 8;   // fw row (bf16): fragment loads conflict-free
constexpr int LDJ = NJ + 8;   // knot slab row [λ][column] (bf16): ldmatrix
                              // rows 16-byte aligned and conflict-free
constexpr int LDACC = NJ + 8; // accumulator row: float2 stores conflict-free

constexpr size_t TILE_BYTES = sizeof(float) * KB * TG;  // A or B of a stage
constexpr size_t STAGE_BYTES = 2 * TILE_BYTES;
constexpr size_t RING_BYTES = NST * STAGE_BYTES;
constexpr size_t FW_BYTES = sizeof(__nv_bfloat16) * TG * LDF;
constexpr size_t ACC_BYTES = sizeof(float) * TG * LDACC;
// the cluster path's fragment-major fw tile
constexpr size_t FWF_BYTES = sizeof(__nv_bfloat16) * TG * TL;
constexpr size_t SLAB_BYTES = sizeof(__nv_bfloat16) * TL * LDJ;
constexpr size_t TAIL_BYTES = sizeof(int) * TG * 4 +
                              sizeof(int) * 2 * (TG / 32);
constexpr size_t SMEM_BYTES = RING_BYTES + FW_BYTES + ACC_BYTES +
                              SLAB_BYTES + TAIL_BYTES +
                              sizeof(uint64_t) * 2 * NST;
// a cluster's block: NST_CL stages, two fragment-major fw tiles, and the
// fw tiles' full and empty barriers
constexpr size_t SMEM_BYTES_CL = NST_CL * STAGE_BYTES + 2 * FWF_BYTES +
                                 ACC_BYTES + SLAB_BYTES + TAIL_BYTES +
                                 sizeof(uint64_t) * (2 * NST_CL + 4);
// a birth-cloud kernel's block also holds its galaxies' τ_BC past the end,
// an escape kernel's block their fesc
constexpr size_t BC_BYTES = sizeof(float) * TG;

static_assert(TG == 128 && TL == 128 && NC == 256,
              "the register tile maps 16 × 16 threads onto 128 × 128");
static_assert(TG == 16 * NCWARP, "one warp per 16 galaxies in the knot product");
static_assert(TL * NKP == 4 * NC, "the knot slab is 4 copies per thread");
static_assert(FWF_BYTES <= FW_BYTES, "both fw tile layouts fit the region");
static_assert(TILE_BYTES % 1024 == 0 && FW_BYTES % 16 == 0 &&
                  ACC_BYTES % 16 == 0 && SLAB_BYTES % 16 == 0,
              "alignment");
static_assert(SMEM_BYTES + BC_BYTES <= 232448 &&
                  SMEM_BYTES_CL + BC_BYTES <= 232448,
              "shared memory of one block");
static_assert(NC * CL_CONSUMER_REGS + 128 * (128 + CL_PRODUCER_REGS) <= 65536,
              "a cluster block's registers");

struct Args {
  CUtensorMap a_map;  // A: (rows, C) sfzh, K-major, in the blocks' order
  CUtensorMap b_map;  // B: (L, C) spectra with dλ/λ, K-major
  const int* order;   // K2: galaxy g of the sorted batch is row order[g]
  const float* s;     // (rows,) column shift; K1 subtracts k0·δ
  const float* tau_v;
  const float* scale;
  const float* curve;
  const __nv_bfloat16* knot;  // (·, ·) knot matrix, row stride ld_knot;
                              // 16-byte aligned rows of 8-band groups
  int64_t ld_knot;
  const float* den;   // (·, f8) den knots, row stride ld_den
  int64_t ld_den;
  const int* win;     // K1: (groups, 2) window starts (k0, l0); K2: null
  float* out;         // (rows, f8)
  int B, C, W, nk, f8, delta, order_interp;
  int group_rows, tiles_per_group;
  float fesc, s_max;
  const float* tau_bc;  // birth-cloud kernels: (rows,) τ_BC; else null
  int cy;               // and the young cells, the prefix 0 .. cy − 1 of C
  const float* fesc_row;  // escape kernels: (rows,) fesc; else null
  CUtensorMap b2_map;     // and B': (L, C) incident spectra with dλ/λ
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy; n = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The 256 consumer threads only (named barrier 1; the producer never
// reaches it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// A cluster block's knot team only (named barrier 2).
__device__ __forceinline__ void knot_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Orders this thread's shared-memory accesses before its later ones at
// cluster scope: the fw tiles' hand-off between the teams of a cluster.
__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A ring that stalls
// for ~10 s (2^34 cycles) is a fault: the kernel traps rather than hang the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const unsigned addr = smem_addr(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// Arrives, with release at cluster scope, on the barrier at `bar`'s offset
// in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  asm volatile(
      "{\n.reg .b32 r;\n"
      "mapa.shared::cluster.u32 r, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [r];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// mbar_wait with acquire at cluster scope: what the arriving blocks wrote
// before their release is visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const unsigned addr = smem_addr(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// One 2-D TMA box (KB cells × 128 rows) at (cell c0, row r0) into dst,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(r0)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's shared memory: the ring of NST (a cluster's block: NST_CL)
// stages [A | B] (1024-byte aligned, as the 128-byte swizzle needs); the fw
// tile (a cluster's block: two fragment-major tiles, fw and fw +
// FWF_BYTES); the knot product's accumulator; the knot slab; the galaxies'
// rows, knot intervals, fractions and dust depths; a reduction scratch; the
// ring's full and empty barriers (a cluster's block: then the fw tiles'
// full and empty barriers, two each); a birth-cloud kernel's block then
// its galaxies' τ_BC, an escape kernel's block there their fesc.
struct Smem {
  unsigned char* ring;
  __nv_bfloat16* fw;
  float* acc;
  __nv_bfloat16* slab;
  int* rows;
  int* k;
  float* t;
  float* tau;
  int* red;  // [2][TG / 32]
  uint64_t* full;
  uint64_t* empty;
  uint64_t* fw_full;   // [2], cluster only
  uint64_t* fw_empty;  // [2], cluster only
  float* tau_bc;       // [TG], birth-cloud kernels only
  float* fesc;         // [TG], escape kernels only (where τ_BC would be)
};

template <bool CLUSTER>
__device__ __forceinline__ Smem smem_layout() {
  // Dynamic shared memory starts 1024-byte aligned (the kernel has no
  // static shared memory; setup_tile traps otherwise). Offsets from it keep
  // the compiler's knowledge that these are shared addresses: LDS, not
  // generic loads, which made the first product 40% slower.
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr size_t ring = (CLUSTER ? NST_CL : NST) * STAGE_BYTES;
  constexpr size_t fw = CLUSTER ? 2 * FWF_BYTES : FW_BYTES;
  Smem s;
  s.ring = smem_raw;
  s.fw = reinterpret_cast<__nv_bfloat16*>(smem_raw + ring);
  s.acc = reinterpret_cast<float*>(smem_raw + ring + fw);
  s.slab = reinterpret_cast<__nv_bfloat16*>(smem_raw + ring + fw + ACC_BYTES);
  s.rows = reinterpret_cast<int*>(s.slab + TL * LDJ);
  s.k = s.rows + TG;
  s.t = reinterpret_cast<float*>(s.k + TG);
  s.tau = s.t + TG;
  s.red = reinterpret_cast<int*>(s.tau + TG);
  s.full = reinterpret_cast<uint64_t*>(s.red + 2 * (TG / 32));
  s.empty = s.full + (CLUSTER ? NST_CL : NST);
  s.fw_full = s.empty + (CLUSTER ? NST_CL : NST);
  s.fw_empty = s.fw_full + 2;
  s.tau_bc = reinterpret_cast<float*>(smem_raw +
                                      (CLUSTER ? SMEM_BYTES_CL : SMEM_BYTES));
  s.fesc = s.tau_bc;
  return s;
}

// The block's galaxy tile: its window group and start (k0, l0), and the
// first knots its galaxies read, band_lo .. band_top (band_top < 0: the
// tile holds no galaxy).
struct Tile {
  int k0, l0, band_lo, band_top;
  int a_row;  // the tile's first row of A
};

// Reads the tile's galaxies into shared memory (row, knot interval,
// fraction, dust depths, escape fraction), reduces the band of first knots
// they span and sets up the ring's barriers (and, in a cluster of n blocks,
// the fw tiles'). Every thread of the block calls it.
template <bool CLUSTER, bool BC, bool ESC>
__device__ __forceinline__ Tile setup_tile(const Args& p, const Smem& sm,
                                           int n) {
  const int tid = threadIdx.x;
  const int grp = blockIdx.x / p.tiles_per_group;
  const int tile = blockIdx.x % p.tiles_per_group;
  Tile t;
  t.k0 = p.win ? p.win[2 * grp] : 0;
  t.l0 = p.win ? p.win[2 * grp + 1] : 0;
  t.a_row = grp * p.group_rows + tile * TG;
  if (tid < TG) {
    const int loc = tile * TG + tid;
    const int idx = grp * p.group_rows + loc;
    const bool ok = loc < p.group_rows && idx < p.B;
    const int row = ok ? (p.order ? p.order[idx] : idx) : -1;
    int lo_min = 0x7fffffff, lo_max = -1, k = 0;
    float f = 0.f, tau = 0.f;
    if (ok) {
      const float s_rel = p.s[row] - (float)(t.k0 * p.delta);
      const float c = fminf(fmaxf(s_rel, 0.f), p.s_max) / (float)p.delta;
      k = (int)floorf(c);
      f = c - (float)k;
      tau = p.tau_v[row];
      lo_min = lo_max = max(k - 1, 0);  // first of the galaxy's knots
    }
    sm.rows[tid] = row;
    sm.k[tid] = k;
    sm.t[tid] = f;
    sm.tau[tid] = tau;
    if constexpr (BC) sm.tau_bc[tid] = ok ? p.tau_bc[row] : 0.f;
    if constexpr (ESC) sm.fesc[tid] = ok ? p.fesc_row[row] : 0.f;
    lo_min = __reduce_min_sync(0xffffffffu, lo_min);
    lo_max = __reduce_max_sync(0xffffffffu, lo_max);
    if (tid % 32 == 0) {
      sm.red[tid / 32] = lo_min;
      sm.red[TG / 32 + tid / 32] = lo_max;
    }
  }
  if (tid == NC) {
    if (smem_addr(sm.ring) % 1024) __trap();  // the swizzled ring's alignment
    for (int s = 0; s < (CLUSTER ? NST_CL : NST); ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NC);
    }
    if constexpr (CLUSTER) {
      for (int b = 0; b < 2; ++b) {
        mbar_init(&sm.fw_full[b], n);   // one arrival per block's consumers
        mbar_init(&sm.fw_empty[b], n);  // one per block's knot team
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  t.band_lo = sm.red[0];
  t.band_top = sm.red[TG / 32];
#pragma unroll
  for (int w = 1; w < TG / 32; ++w) {
    t.band_lo = min(t.band_lo, sm.red[w]);
    t.band_top = max(t.band_top, sm.red[TG / 32 + w]);
  }
  return t;
}

// The producer's loads of one λ chunk: n_kb stages of the galaxy tile's A
// box (rows from a_row) and the chunk's B box (rows from table column lb);
// ESC: then n_kb more of the same A boxes beside the incident table's B'
// boxes. `it` counts the ring's stages over the block's life, as the
// consumers count them.
template <int NS, bool ESC>
__device__ __forceinline__ void load_chunk(const Args& p, const Smem& sm,
                                           uint32_t& it, int n_kb, int a_row,
                                           int lb) {
  for (int kb = 0; kb < (ESC ? 2 * n_kb : n_kb); ++kb, ++it) {
    const uint32_t s = it % NS;
    mbar_wait(&sm.empty[s], ((it / NS) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], (uint32_t)STAGE_BYTES);
    unsigned char* st = sm.ring + s * STAGE_BYTES;
    if constexpr (ESC) {
      const bool inc = kb >= n_kb;
      const int c0 = (inc ? kb - n_kb : kb) * KB;
      tma_load(st, &p.a_map, c0, a_row, &sm.full[s]);
      tma_load(st + TILE_BYTES, inc ? &p.b2_map : &p.b_map, c0, lb,
               &sm.full[s]);
    } else {
      tma_load(st, &p.a_map, kb * KB, a_row, &sm.full[s]);
      tma_load(st + TILE_BYTES, &p.b_map, kb * KB, lb, &sm.full[s]);
    }
  }
}

// The FMAs of cells 4q .. 4q + 3 of a ring stage: 16-byte loads of this
// thread's 8 rows of A and of B, then 4 × 64 FMAs, cell by cell.
__device__ __forceinline__ void fma_group(float (&lnu)[8][8],
                                          const float4* a_s,
                                          const float4* b_s, int q, int tx,
                                          int ty) {
  float4 a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = a_s[(ty + 16 * i) * (KB / 4) + (q ^ (ty & 7))];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    b[j] = b_s[(tx + 16 * j) * (KB / 4) + (q ^ (tx & 7))];
#define SED_TILE_FMA(X)                                        \
  _Pragma("unroll") for (int i = 0; i < 8; ++i)                \
      _Pragma("unroll") for (int j = 0; j < 8; ++j) lnu[i][j] = \
          fmaf(a[i].X, b[j].X, lnu[i][j]);
  SED_TILE_FMA(x)
  SED_TILE_FMA(y)
  SED_TILE_FMA(z)
  SED_TILE_FMA(w)
#undef SED_TILE_FMA
}

// The birth-cloud screen of the young cells, once the FMA chain of every
// lnu element of this thread has taken cell cy − 1: lnu[i][j] ·=
// exp(−τ_BC[g]·k[l]) for its galaxies g = ty + 16i and the chunk's columns
// l = lw0 + tx + 16j of the window from l0 (columns past the window read
// k = 0; the screen drops them).
__device__ __forceinline__ void birth_cloud(float (&lnu)[8][8], const Smem& sm,
                                            const Args& p, int l0, int lw0,
                                            int tx, int ty) {
  float k_l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lw = lw0 + tx + 16 * j;
    k_l[j] = lw < p.W ? p.curve[l0 + lw] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float tau = sm.tau_bc[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) lnu[i][j] *= expf(-tau * k_l[j]);
  }
}

// The escape kernels' split, once the FMA chain of every lnu element of
// this thread has taken the reprocessed table's last cell: lnu[i][j] ·=
// (1 − fesc[g])·exp(−τ_V[g]·k[l]) for its galaxies g = ty + 16i and the
// chunk's columns l = lw0 + tx + 16j of the window from l0 (columns past
// the window read k = 0; the epilogue drops them).
__device__ __forceinline__ void escape_split(float (&lnu)[8][8],
                                             const Smem& sm, const Args& p,
                                             int l0, int lw0, int tx,
                                             int ty) {
  float k_l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lw = lw0 + tx + 16 * j;
    k_l[j] = lw < p.W ? p.curve[l0 + lw] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int g = ty + 16 * i;
    const float tau = sm.tau[g], keep = 1.f - sm.fesc[g];
#pragma unroll
    for (int j = 0; j < 8; ++j) lnu[i][j] *= keep * expf(-tau * k_l[j]);
  }
}

// The FMAs of one ring stage's cells c_lo .. c_hi − 1 in ascending order:
// whole groups of 4 cells by 16-byte loads as `first_product` takes them,
// the cells of a group cut by either end one at a time (the birth cloud's
// stage, which `first_product` splits at cell cy).
__device__ __forceinline__ void stage_cells(float (&lnu)[8][8],
                                            const float4* a_s,
                                            const float4* b_s, int c_lo,
                                            int c_hi, int tx, int ty) {
  const float* a1 = reinterpret_cast<const float*>(a_s);
  const float* b1 = reinterpret_cast<const float*>(b_s);
#pragma unroll 1
  for (int c = c_lo; c < c_hi;) {
    const int q = c >> 2;
    if ((c & 3) == 0 && c + 4 <= c_hi) {
      fma_group(lnu, a_s, b_s, q, tx, ty);
      c += 4;
    } else {
      const int e = c & 3;
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = a1[((ty + 16 * i) * (KB / 4) + (q ^ (ty & 7))) * 4 + e];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = b1[((tx + 16 * j) * (KB / 4) + (q ^ (tx & 7))) * 4 + e];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) lnu[i][j] = fmaf(a[i], b[j], lnu[i][j]);
      c += 1;
    }
  }
}

// lnu[i][j] of this consumer thread's 8 galaxies ty + 16i × 8 λ columns
// tx + 16j of the chunk: one FMA chain per element over cells in ascending
// order. A stage holds 128 rows of 32 cells of A and of B, 128 bytes a row
// in TMA's 128-byte swizzle (16-byte chunk q of row r at chunk q ^ (r % 8);
// r % 8 is ty % 8 or tx % 8 for every row a thread reads). Consumes n_kb
// ring stages of a ring of NS. BC: the chain is scaled by the birth cloud
// (`birth_cloud`, at the chunk's window columns from l0 + lw0) between
// cells cy − 1 and cy. ESC: 2·n_kb stages, the reprocessed cells' into
// lnu, then `escape_split`, then the incident cells' into a second tile,
// which joins lnu scaled by fesc at the end (header: "Escape").
template <int NS, bool BC, bool ESC = false>
__device__ __forceinline__ void first_product(float (&lnu)[8][8],
                                              const Smem& sm, uint32_t& it,
                                              int n_kb, int tx, int ty,
                                              const Args& p, int l0,
                                              int lw0) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) lnu[i][j] = 0.f;
  float inc[ESC ? 8 : 1][8];  // ESC: the incident cells' chain
  for (int kb = 0; kb < (ESC ? 2 * n_kb : n_kb); ++kb, ++it) {
    const uint32_t s = it % NS;
    mbar_wait(&sm.full[s], (it / NS) & 1);
    const float4* a_s =
        reinterpret_cast<const float4*>(sm.ring + s * STAGE_BYTES);
    const float4* b_s = a_s + TILE_BYTES / sizeof(float4);
    if constexpr (ESC) {
      if (kb >= n_kb) {  // the incident table's cells
        if (kb == n_kb) {
          escape_split(lnu, sm, p, l0, lw0, tx, ty);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) inc[i][j] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < KB / 4; ++q)  // cells 4q .. 4q + 3
          fma_group(inc, a_s, b_s, q, tx, ty);
        mbar_arrive(&sm.empty[s]);
        continue;
      }
    }
    if constexpr (BC) {
      if (kb == p.cy / KB) {  // the stage that holds cell cy
        stage_cells(lnu, a_s, b_s, 0, p.cy % KB, tx, ty);
        birth_cloud(lnu, sm, p, l0, lw0, tx, ty);
        stage_cells(lnu, a_s, b_s, p.cy % KB, KB, tx, ty);
        mbar_arrive(&sm.empty[s]);
        continue;
      }
    }
#pragma unroll
    for (int q = 0; q < KB / 4; ++q)  // cells 4q .. 4q + 3
      fma_group(lnu, a_s, b_s, q, tx, ty);
    mbar_arrive(&sm.empty[s]);  // this thread is done with the stage
  }
  // every cell young, cy = n_kb·KB: the stage of cell cy is past the end
  if constexpr (BC)
    if (p.cy >= n_kb * KB) birth_cloud(lnu, sm, p, l0, lw0, tx, ty);
  if constexpr (ESC) {  // lnu = fesc·inc + (1 − fesc)·exp(−τ_V k)·lnu
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float fe = sm.fesc[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) lnu[i][j] = fmaf(fe, inc[i][j], lnu[i][j]);
    }
  }
}

// The knots a pass contracts: the 4 of each galaxy it finishes (first
// knots pk0 .. min(band_top, pk0 + PASS_STEP − 1)), rounded up to whole
// pairs of 8-column n-tiles (an n-tile is one knot's 8 bands): 4, 6 or 8.
// The other columns of the pass are never read, so a cluster's knot team
// makes neither their slab rows nor their products (a tile of rows sorted
// by shift mostly needs 4).
__device__ __forceinline__ int pass_knots(const Tile& t, int pk0) {
  const int need = min(t.band_top - pk0, PASS_STEP - 1) + NQ;
  return min(NKP, (need + 1) & ~1);
}

// One k-step of 16 λ rows for M row tiles of 16 galaxies: d[m] += a[m]
// (the warp's fw fragments) · slab rows 16·ks .. 16·ks + 15, the columns
// of the first 2·NP knots; each B fragment is loaded once for the M tiles.
template <int M, int NP>
__device__ __forceinline__ void mma_kstep(float (&d)[M][NJ / 8][4],
                                          const uint32_t (&a)[M][4],
                                          const __nv_bfloat16* slab_s,
                                          int ks) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    // B fragments of n-tiles 2np and 2np+1 from the [λ][column] slab
    const unsigned addr = smem_addr(
        slab_s + (ks * 16 + (lane & 15)) * LDJ + (2 * np + (lane >> 4)) * 8);
    uint32_t b[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
        : "r"(addr));
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mma_bf16(d[m][2 * np], a[m], b[0], b[1]);
      mma_bf16(d[m][2 * np + 1], a[m], b[2], b[3]);
    }
  }
}

// A warp's (16 galaxies × 64 knot columns) accumulator tile, row tile mt:
// thread (gid, tig) holds rows r0 = 16·mt + gid and r0 + 8, columns
// 8·nt + 2·tig and + 1.
__device__ __forceinline__ void load_acc(float (&d)[NJ / 8][4],
                                         const float* acc_s, int mt) {
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * mt + (lane >> 2), tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NJ / 8; ++nt) {
    const float2 lo = *reinterpret_cast<const float2*>(
        acc_s + r0 * LDACC + nt * 8 + 2 * tig);
    const float2 hi = *reinterpret_cast<const float2*>(
        acc_s + (r0 + 8) * LDACC + nt * 8 + 2 * tig);
    d[nt][0] = lo.x;
    d[nt][1] = lo.y;
    d[nt][2] = hi.x;
    d[nt][3] = hi.y;
  }
}

__device__ __forceinline__ void store_acc(const float (&d)[NJ / 8][4],
                                          float* acc_s, int mt) {
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * mt + (lane >> 2), tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NJ / 8; ++nt) {
    *reinterpret_cast<float2*>(acc_s + r0 * LDACC + nt * 8 + 2 * tig) =
        make_float2(d[nt][0], d[nt][1]);
    *reinterpret_cast<float2*>(acc_s + (r0 + 8) * LDACC + nt * 8 + 2 * tig) =
        make_float2(d[nt][2], d[nt][3]);
  }
}

// acc_s[g][j] += fw_s[g][:] · slab_s[:][j] for the warp's 16 galaxies of a
// row-major fw tile and the columns of the pass's first 2·NP knots. The
// accumulator lives in shared memory between chunks: held in registers
// over the first product it made the consumers spill.
template <int NP>
__device__ __forceinline__ void knot_mma(float* acc_s,
                                         const __nv_bfloat16* fw_s,
                                         const __nv_bfloat16* slab_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + (lane >> 2), tig = lane & 3;
  float d[1][NJ / 8][4];
  load_acc(d[0], acc_s, warp);
  const uint32_t* fw32 = reinterpret_cast<const uint32_t*>(fw_s);
#pragma unroll
  for (int ks = 0; ks < TL / 16; ++ks) {
    const int col = ks * 8 + tig;  // in bf16 pairs
    uint32_t a[1][4];
    a[0][0] = fw32[r0 * (LDF / 2) + col];
    a[0][1] = fw32[(r0 + 8) * (LDF / 2) + col];
    a[0][2] = fw32[r0 * (LDF / 2) + col + 4];
    a[0][3] = fw32[(r0 + 8) * (LDF / 2) + col + 4];
    mma_kstep<1, NP>(d, a, slab_s, ks);
  }
  store_acc(d[0], acc_s, warp);
}

// Rows lw0 .. lw0 + ROWS − 1 of the window's knot slab [λ][knot·8 + band]
// for band group fb0 and knots pk0 .. pk0 + nkn − 1, one 16-byte copy per λ
// row and knot, by a team of NTH threads (this one `tid` of them); rows
// past the window and knots past nk are zero-filled.
template <int ROWS, int NTH = NC>
__device__ __forceinline__ void load_slab(__nv_bfloat16* slab_s,
                                          const Args& p, const Tile& t,
                                          int pk0, int nkn, int fb0, int lw0,
                                          int tid = threadIdx.x) {
  static_assert(ROWS * NKP % NTH == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * NKP / NTH; ++i) {
    const int e = tid + i * NTH;
    const int r = e % NKP, l = e / NKP;
    if (r >= nkn) continue;
    const bool ok = pk0 + r < p.nk && lw0 + l < p.W;
    const __nv_bfloat16* src =
        ok ? p.knot + (int64_t)(t.l0 + lw0 + l) * p.ld_knot +
                 (int64_t)(t.k0 + pk0 + r) * p.f8 + fb0
           : p.knot;
    cp_async16(slab_s + l * LDJ + r * FB, src, ok ? 16 : 0);
  }
}

// Index, in 32-bit words of the fragment-major fw tile, of the bf16 pair
// (galaxy g, columns c and c + 1), c even.
__device__ __forceinline__ int frag_word(int g, int c) {
  const int gid = g & 7, hi = (g >> 3) & 1;
  const int c16 = c & 15;
  const int lane = 4 * gid + ((c16 & 7) >> 1);
  return (((g >> 4) * (TL / 16) + (c >> 4)) * 32 + lane) * 4 +
         2 * (c16 >> 3) + hi;
}

// Dust screen, then bf16 (the knot product's input type), into the fw
// tile: row-major [g][LDF] for a lone block, fragment-major in a cluster.
// Columns past the window are zero (the B tile holds the table's next
// columns there). ESC: lnu is screened already (`escape_split`): bf16 only.
template <bool FRAG, bool ESC = false>
__device__ __forceinline__ void screen(const float (&lnu)[8][8],
                                       const Smem& sm, __nv_bfloat16* fw,
                                       const Args& p, int l0, int lw0,
                                       int tx, int ty) {
  float k_l[8];
  bool in[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lw = lw0 + tx + 16 * j;
    in[j] = lw < p.W;
    k_l[j] = in[j] ? p.curve[l0 + lw] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int g = ty + 16 * i;
    const float tau = sm.tau[g];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float att = 1.f;
      if constexpr (!ESC) {
        att = expf(-tau * k_l[j]);
        if (p.fesc != 0.f) att = p.fesc + (1.f - p.fesc) * att;
      }
      const __nv_bfloat16 v =
          in[j] ? __float2bfloat16_rn(ESC ? lnu[i][j] : lnu[i][j] * att)
                : __float2bfloat16_rn(0.f);
      const int c = tx + 16 * j;
      if constexpr (FRAG)
        fw[2 * frag_word(g, c & ~1) + (c & 1)] = v;
      else
        fw[g * LDF + c] = v;
    }
  }
}

// The galaxies whose 4 knots pass `pass` holds are finished: their fluxes
// in the block's 8 bands from the accumulator, by a team of NTH threads
// (this one `tid` of them).
template <int NTH = NC>
__device__ __forceinline__ void finish_pass(const Args& p, const Smem& sm,
                                            const Tile& t, int pass, int pk0,
                                            int fb0, int tid = threadIdx.x) {
  for (int e = tid; e < TG * FB; e += NTH) {
    const int g = e / FB, fl = e % FB, f = fb0 + fl;
    const int row = sm.rows[g];
    const int k = sm.k[g];
    if (row < 0 || (max(k - 1, 0) - t.band_lo) / PASS_STEP != pass) continue;
    const float* acc_g = sm.acc + g * LDACC + fl;
    const auto num_at = [&](int kk) { return acc_g[(kk - pk0) * FB]; };
    const auto den_at = [&](int kk) {
      return p.den[(int64_t)(t.k0 + kk) * p.ld_den + f];
    };
    const float num = knot_interp(num_at, k, sm.t[g], p.nk, p.order_interp);
    const float dn = knot_interp(den_at, k, sm.t[g], p.nk, p.order_interp);
    p.out[(int64_t)row * p.f8 + f] = num / fmaxf(dn, 1.0e-30f) * p.scale[row];
  }
}

// The cluster path (run<true>) from here on.
//
// Its fw tiles are stored fragment-major: the A fragment of mma.sync k-step
// ks for lane `lane` of row tile mt (rows 16mt + gid and + 8, bf16 pairs at
// columns 16ks + 2tig and + 8) is one 16-byte word at
// ((mt·8 + ks)·32 + lane)·16 bytes. A warp reads a k-step as 512 contiguous
// bytes, and a peer's tile comes over distributed shared memory in 16-byte
// loads.
// The knot product runs over halves of a λ chunk: 64 rows, KH k-steps.
constexpr int HALF = TL / 2;
constexpr int KH = HALF / 16;
constexpr int KT_WARPS = 4;            // the knot team's warps
constexpr int KT_TILES = TG / 16 / KT_WARPS;  // row tiles per knot warp
static_assert(HALF * NKP % 128 == 0, "whole slab copies per knot thread");

// A knot warp's product of half `half` (KH k-steps) of a fragment-major fw
// tile, which may lie in a peer block's shared memory, for its KT_TILES row
// tiles, over the columns of the pass's first 2·NP knots. A k-step's A
// fragments are one 16-byte load per row tile, loaded a k-step ahead.
template <int NP>
__device__ __forceinline__ void half_mma(float (&d)[KT_TILES][NJ / 8][4],
                                         const uint32_t* fwf, int half,
                                         int kw,
                                         const __nv_bfloat16* slab_s) {
  const int lane = threadIdx.x % 32;
  uint32_t a[2][KT_TILES][4];
  const auto load = [&](uint32_t (&x)[KT_TILES][4], int ks) {
#pragma unroll
    for (int m = 0; m < KT_TILES; ++m) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          fwf + (((KT_TILES * kw + m) * (TL / 16) + half * KH + ks) * 32 +
                 lane) * 4);
      x[m][0] = v.x;
      x[m][1] = v.y;
      x[m][2] = v.z;
      x[m][3] = v.w;
    }
  };
  load(a[0], 0);
#pragma unroll
  for (int ks = 0; ks < KH; ++ks) {
    if (ks + 1 < KH) load(a[(ks + 1) % 2], ks + 1);
    mma_kstep<KT_TILES, NP>(d, a[ks % 2], slab_s, ks);
  }
}

// The producer warpgroup: one thread issues the loads of the block's own
// chunk of every super-chunk (n = 1 alone: every chunk), the rest leave.
template <bool CLUSTER, bool ESC>
__device__ __forceinline__ void produce(const Args& p, const Smem& sm,
                                        const Tile& t, int n, int rank) {
  if (threadIdx.x != NC) return;
  constexpr int ns = CLUSTER ? NST_CL : NST;
  const int n_kb = (p.C + KB - 1) / KB;
  const int n_pass = (t.band_top - t.band_lo) / PASS_STEP + 1;
  uint32_t it = 0;
  for (int pass = 0; pass < n_pass; ++pass)
    for (int c0 = 0; c0 < p.W; c0 += n * TL)  // super-chunk
      if (rank < min(n, (p.W - c0 + TL - 1) / TL))
        load_chunk<ns, ESC>(p, sm, it, n_kb, t.a_row,
                            t.l0 + c0 + rank * TL);
}

// A lone block's two consumer warpgroups: TG galaxies of one window group,
// FB bands; per λ chunk the first product, the screen and the knot product
// over all NKP knots of the pass (contracting only `pass_knots` of them
// measured 1-2% slower here on an H100: the knot phase is a small part of
// a lone block's time).
template <bool BC, bool ESC>
__device__ __forceinline__ void consume(const Args& p, const Smem& sm,
                                        const Tile& t) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int fb0 = blockIdx.y * FB;
  const int n_kb = (p.C + KB - 1) / KB;
  const int n_pass = (t.band_top - t.band_lo) / PASS_STEP + 1;
  uint32_t it = 0;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int pk0 = t.band_lo + pass * PASS_STEP;  // first knot of the pass
    for (int e = threadIdx.x; e < TG * LDACC; e += NC) sm.acc[e] = 0.f;
    for (int c0 = 0; c0 < p.W; c0 += TL) {
      float lnu[8][8];
      // the chunk's knot slab, in flight during the first product
      load_slab<TL>(sm.slab, p, t, pk0, NKP, fb0, c0);
      cp_async_commit();
      first_product<NST, BC, ESC>(lnu, sm, it, n_kb, tx, ty, p, t.l0, c0);
      screen<false, ESC>(lnu, sm, sm.fw, p, t.l0, c0, tx, ty);
      cp_async_wait<0>();
      consumer_sync();  // fw written and every slab copy landed
      knot_mma<NKP / 2>(sm.acc, sm.fw, sm.slab);
      consumer_sync();  // fw and slab read; both may refill
    }
    finish_pass(p, sm, t, pass, pk0, fb0);
    consumer_sync();  // acc read before the next pass clears it
  }
}

// A cluster block's two consumer warpgroups: the first product and screen
// of the block's chunk of every super-chunk, into fw tile sc % 2 (sc counts
// super-chunks over the block's life). Tile b is written again only after
// every knot team of the cluster has arrived on fw_empty[b]; once written
// (or at a tail super-chunk with no chunk for this block), one thread
// arrives on fw_full[b] of every block of the cluster.
template <bool BC, bool ESC>
__device__ __forceinline__ void consume_cluster(const Args& p, const Smem& sm,
                                                const Tile& t, int n,
                                                int rank) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_kb = (p.C + KB - 1) / KB;
  const int n_pass = (t.band_top - t.band_lo) / PASS_STEP + 1;
  uint32_t it = 0, sc = 0;
  for (int pass = 0; pass < n_pass; ++pass) {
    for (int c0 = 0; c0 < p.W; c0 += n * TL, ++sc) {
      const int b = sc & 1;
      const bool mine = rank < min(n, (p.W - c0 + TL - 1) / TL);
      float lnu[8][8];
      if (mine)
        first_product<NST_CL, BC, ESC>(lnu, sm, it, n_kb, tx, ty, p, t.l0,
                                       c0 + rank * TL);
      if (sc >= 2) mbar_wait_cluster(&sm.fw_empty[b], ((sc >> 1) - 1) & 1);
      if (mine)
        screen<true, ESC>(lnu, sm, sm.fw + b * (FWF_BYTES / 2), p, t.l0,
                          c0 + rank * TL, tx, ty);
      fence_cluster();
      consumer_sync();  // the whole tile is written
      if (threadIdx.x == 0)
        for (int r = 0; r < n; ++r) mbar_arrive_remote(&sm.fw_full[b], r);
    }
  }
}

// A cluster block's knot team (warpgroup 3): for every super-chunk, once
// every block's fw tile sc % 2 is full, the knot product of all of them in
// ascending λ against the block's band group's knot slab, streamed in
// 64-row halves (one in flight while the other is contracted); then one
// thread arrives on fw_empty[sc % 2] of every block. Warp w holds row tiles
// KT_TILES·w .. + KT_TILES − 1 and their accumulators in registers over a
// pass, so the knot product of super-chunk s runs while the consumers
// compute the first product of s + 1. A padding slot (`bands` false) only
// takes part in the hand-off.
__device__ __forceinline__ void knot_team(const Args& p, const Smem& sm,
                                          const Tile& t, int n) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int kt = threadIdx.x - NT, kw = kt / 32;
  const int fb0 = blockIdx.y * FB;
  const bool bands = fb0 < p.f8;
  const int n_pass = (t.band_top - t.band_lo) / PASS_STEP + 1;
  const auto slab_buf = [&](int h) { return sm.slab + (h % 2) * HALF * LDJ; };
  uint32_t sc = 0;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int pk0 = t.band_lo + pass * PASS_STEP;  // first knot of the pass
    const int nkn = pass_knots(t, pk0);
    float d[KT_TILES][NJ / 8][4];
#pragma unroll
    for (int m = 0; m < KT_TILES; ++m)
#pragma unroll
      for (int nt = 0; nt < NJ / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[m][nt][q] = 0.f;
    for (int c0 = 0; c0 < p.W; c0 += n * TL, ++sc) {
      const int b = sc & 1;
      if (bands) {  // slab halves 0 and 1, in flight while tiles fill
        load_slab<HALF, 128>(slab_buf(0), p, t, pk0, nkn, fb0, c0, kt);
        load_slab<HALF, 128>(slab_buf(1), p, t, pk0, nkn, fb0, c0 + HALF,
                             kt);
      }
      cp_async_commit();
      mbar_wait_cluster(&sm.fw_full[b], (sc >> 1) & 1);
      if (bands) {
        const int n_half = 2 * min(n, (p.W - c0 + TL - 1) / TL);
        __nv_bfloat16* fw = sm.fw + b * (FWF_BYTES / 2);
        for (int h = 0; h < n_half; ++h) {
          cp_async_wait<0>();
          knot_sync();  // half h landed; half h − 1's buffer is free
          if (h > 0 && h + 1 < n_half)
            load_slab<HALF, 128>(slab_buf(h + 1), p, t, pk0, nkn, fb0,
                                 c0 + (h + 1) * HALF, kt);
          cp_async_commit();
          // half h of the super-chunk: half h % 2 of block h / 2's tile
          const uint32_t* fwf = reinterpret_cast<const uint32_t*>(
              cluster.map_shared_rank(fw, h / 2));
          if (nkn == 4)
            half_mma<2>(d, fwf, h % 2, kw, slab_buf(h));
          else if (nkn == 6)
            half_mma<3>(d, fwf, h % 2, kw, slab_buf(h));
          else
            half_mma<4>(d, fwf, h % 2, kw, slab_buf(h));
        }
      }
      fence_cluster();
      knot_sync();  // every warp is done with the tiles and the slab
      if (kt == 0)
        for (int r = 0; r < n; ++r) mbar_arrive_remote(&sm.fw_empty[b], r);
    }
    if (bands) {
#pragma unroll
      for (int m = 0; m < KT_TILES; ++m)
        store_acc(d[m], sm.acc, KT_TILES * kw + m);
      knot_sync();
      finish_pass<128>(p, sm, t, pass, pk0, fb0, kt);
    }
  }
}

// The whole block. CLUSTER false: a lone block (F8 = 8) of NT threads.
// CLUSTER true: one block of NT_CL threads of a cluster of n along y
// (F8 > 8) that shares the galaxy tile's first product with the cluster's
// band groups (header: "Band groups"). The tile, its passes and the window
// are the cluster's, so every block runs the same super-chunks; the blocks
// meet at a cluster barrier after setting up their barriers and before
// leaving (no block's shared memory goes while a peer may read it). BC: with
// the birth-cloud screen (header: "Birth cloud"); ESC: with a per-row
// escape fraction and the incident table (header: "Escape").
template <bool CLUSTER, bool BC = false, bool ESC = false>
__device__ __forceinline__ void run(const Args& p) {
  const Smem sm = smem_layout<CLUSTER>();
  int n = 1, rank = 0;
  if constexpr (CLUSTER) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const dim3 dims = cluster.dim_blocks();
    n = (int)(dims.x * dims.y * dims.z);
    rank = (int)cluster.block_rank();
  }
  const Tile t = setup_tile<CLUSTER, BC, ESC>(p, sm, n);
  if (t.band_top < 0) return;  // uniform per block and per cluster
  if constexpr (!CLUSTER) {
    if (threadIdx.x >= NC) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          PRODUCER_REGS));
      produce<false, ESC>(p, sm, t, 1, 0);
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          CONSUMER_REGS));
      consume<BC, ESC>(p, sm, t);
    }
  } else {
    cluster_arrive();  // every block's barriers are set up
    cluster_wait();
    if (threadIdx.x >= NT) {
      knot_team(p, sm, t, n);
    } else if (threadIdx.x >= NC) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          CL_PRODUCER_REGS));
      produce<true, ESC>(p, sm, t, n, rank);
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          CL_CONSUMER_REGS));
      consume_cluster<BC, ESC>(p, sm, t, n, rank);
    }
    cluster_arrive();
    cluster_wait();
  }
}

// Host side: a 2-D tensor map over `rows` rows of `cols` fp32 cells, row
// stride `ld` floats (a multiple of 4, base 16-byte aligned), read in boxes
// of KB cells × 128 rows with 128-byte swizzle; cells and rows past the
// ends come in as zeros. Returns a cudaError_t (0 = ok).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline int operand_map(CUtensorMap* map, const float* base, int64_t rows,
                       int64_t cols, int64_t ld) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), 12000,
        cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || !encode) {
      encode = nullptr;
      return (int)cudaErrorSymbolNotFound;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)KB, (cuuint32_t)TG};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Launch over `groups` window groups of `p.group_rows` rows and every band
// group, on `stream`: `kernel` (a __global__ wrapper of run<false, ·>, NT
// threads) for cluster = 1, else `cluster_kernel` (of run<true, ·>, NT_CL
// threads) in clusters of `cluster` blocks along y, the band groups padded
// up to whole clusters. With p.tau_bc set the two are the birth-cloud
// kernels (run<·, true>), with p.fesc_row set the escape kernels
// (run<·, false, true>); either takes BC_BYTES more shared memory.
// cluster must lie in [1, 8], the portable cluster sizes. The operand maps
// are made here: A (a_rows × C, row stride ld_a), B (n_l × C, row stride
// ld_b) and, for the escape kernels, B' (n_l × C, row stride ld_b2).
// Returns the launch's cudaError_t (0 = ok); a cluster launch the card
// refuses returns its error and runs nothing.
template <class Kernel>
inline int launch(Kernel kernel, Kernel cluster_kernel, Args p,
                  const float* a, int64_t a_rows, int64_t ld_a,
                  const float* b, int64_t n_l, int64_t ld_b,
                  const float* b2, int64_t ld_b2, int groups, int cluster,
                  cudaStream_t stream) {
  if (cluster < 1 || cluster > 8) return (int)cudaErrorInvalidValue;
  if (p.tau_bc && p.fesc_row) return (int)cudaErrorInvalidValue;
  if (p.fesc_row && !b2) return (int)cudaErrorInvalidValue;
  int merr = operand_map(&p.a_map, a, a_rows, p.C, ld_a);
  if (!merr) merr = operand_map(&p.b_map, b, n_l, p.C, ld_b);
  if (!merr && p.fesc_row) merr = operand_map(&p.b2_map, b2, n_l, p.C, ld_b2);
  if (merr) return merr;
  Kernel k = cluster == 1 ? kernel : cluster_kernel;
  const size_t smem = (cluster == 1 ? SMEM_BYTES : SMEM_BYTES_CL) +
                      (p.tau_bc || p.fesc_row ? BC_BYTES : 0);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  p.tiles_per_group = (p.group_rows + TG - 1) / TG;
  // same clip bound as `_knot_interp`: computed in double, rounded to float
  p.s_max = (float)((p.nk - 1) * (double)p.delta - 1.0e-3);
  const int band_groups = p.f8 / FB;  // f8 % FB == 0
  const dim3 grid(groups * p.tiles_per_group,
                  (band_groups + cluster - 1) / cluster * cluster);
  if (cluster == 1) {
    kernel<<<grid, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT_CL);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks of `cluster_kernel` the card keeps
// resident at once (cudaOccupancyMaxActiveClusters), into *out.
template <class Kernel>
inline int max_active_clusters(Kernel cluster_kernel, int cluster, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES_CL);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, cluster);
  cfg.blockDim = dim3(NT_CL);
  cfg.dynamicSmemBytes = SMEM_BYTES_CL;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, cluster_kernel, &cfg);
}

}  // namespace sed_tile
