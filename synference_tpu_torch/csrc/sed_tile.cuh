// The SED -> photometry core shared by K1 (fused_window.cu) and K2
// (fused_sed.cu), for Hopper (sm_90a).
//
// One block owns TG = 128 galaxies and one group of 8 bands (blockIdx.y).
// At more than 8 bands the blocks of one galaxy tile form a thread-block
// cluster that computes the first product once (see "Band groups" below).
// Over its λ window of W columns (K1: a z-sorted sub-chunk's window, K2:
// the whole λ support) and its knot table of nk rows it computes
//
//   lnu[b,l]  = Σ_c sfzh[b,c] · sed[c,l]               (fp32 FMA, c ascending)
//   fw[b,l]   = bf16( lnu · (fesc + (1−fesc)·exp(−τ_V[b]·k[l])) )
//   acc[b,k,f] = Σ_l fw[b,l] · knot[l, k·F8 + f]         (bf16 in, fp32 sum)
//   out[b,f]  = interp(acc[b,·,f]; s[b]) / max(interp(den[·,f]; s[b]), 1e-30)
//               · scale[b]
//
// interp as in knot_interp.cuh over the block's nk knots.
//
// What bounds it on the H100: the first product, 2·C·W FLOPs per galaxy
// against a few hundred bytes of per-galaxy input, so fp32 FMA issue. It
// stays on the CUDA cores as one fp32 FMA chain per lnu[b,l] over cells in
// ascending order: fw is rounded to bf16, and a TF32, 3xTF32 or split-bf16
// product moves enough of those roundings to break the 1e-5 bound the
// kernels are held to against their plain version.
//
// Design.
// - First product: a 128 × 128 (galaxy × λ) block tile, 256 threads, an
//   8 × 8 register tile per thread (4 shared loads of 16 bytes per 64 FMAs).
//   Cell slabs of CK = 16 stream through a 3-stage shared-memory ring filled
//   by cp.async with zero fill, one barrier per stage. The A tile comes
//   from a tile-major (C, ·) copy of sfzh that the wrapper makes (each
//   block's 128 galaxies contiguous per cell, in the order the block visits
//   them), by 16-byte copies; the B tile by 4-byte copies, so window
//   columns need no 16-byte alignment (K1's windows start at any column,
//   K2's 1006-column rows are not aligned; aligning the tiles down instead
//   costs K1 a 17th λ chunk per 2048-column window). A stage costs a thread
//   2 + 8 copies at fixed strides. Cells and columns outside the range are
//   zero-filled and add exact zeros. 2 blocks per SM (105 KB of shared
//   memory each).
// - Screen and bf16 rounding in registers, fw into shared memory (over the
//   ring, which is idle by then).
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
//   the same bits.
//
// Band groups (F8 > 8). lnu and fw do not depend on the band, so the blocks
// of one galaxy tile that differ only in their band group (blockIdx.y) run
// as one cluster of n ≤ 8 blocks (`run_cluster`, launched with
// cudaLaunchKernelEx and a (1, n, 1) cluster dimension; n is chosen by the
// caller, `cluster_size` in ops/fused_sed.py). The cluster walks the window
// in super-chunks of n λ chunks: block r computes the first product and
// screen of chunk r of the super-chunk into its own fw tile, exactly as a
// lone block does; after a cluster barrier every block contracts all n fw
// tiles, in ascending λ, against its own band group's knot slab, reading
// its peers' tiles through distributed shared memory (16-byte loads of a
// fragment-major tile) and streaming the slab in 64-row halves (one in
// flight while the other is contracted); a second cluster barrier frees
// the fw tiles for the next super-chunk. Each lnu element is computed once
// per cluster, and the knot product's accumulator sees the same mma.sync
// steps in the same order as in a lone block, so the output equals, bit
// for bit, the kernel run on each 8-band slice of the tables. F8 = 8 takes
// `run_block` unclustered. A padding slot of the last cluster (more slots
// than band groups) computes its share of the first product and no bands.
// Shared memory is the lone block's, so 2 blocks per SM still fit. The
// knot phase is not overlapped with the first product: at 64 bands it is
// about a quarter of the kernel's time.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knot_interp.cuh"

namespace sed_tile {

constexpr int TG = 128;   // galaxies per block
constexpr int TL = 128;   // λ columns per chunk
constexpr int CK = 16;    // cells per pipeline stage
constexpr int NST = 3;    // pipeline stages
constexpr int NT = 256;   // threads per block
constexpr int MIN_BLOCKS = 2;  // blocks per SM: at most 128 registers
constexpr int NWARP = NT / 32;
constexpr int FB = 8;     // bands per block (blockIdx.y walks band groups)
constexpr int NKP = 8;    // knots per pass
constexpr int NQ = 4;     // knots a galaxy reads (k−1..k+2)
constexpr int PASS_STEP = NKP - NQ + 1;  // passes overlap by 3 knots
constexpr int NJ = NKP * FB;  // knot-product columns per pass (64)
constexpr int LDA = TG + 4;   // A row [cell][galaxy]: 16-byte aligned
constexpr int LDB = TL;       // B row [cell][λ]
constexpr int LDF = TL + 8;   // fw row (bf16): fragment loads conflict-free
constexpr int LDJ = NJ + 8;   // knot slab row [λ][column] (bf16): ldmatrix
                              // rows 16-byte aligned and conflict-free
constexpr int LDACC = NJ + 8; // accumulator row: float2 stores conflict-free

constexpr int STAGE_FLOATS = CK * LDA + CK * LDB;
constexpr size_t RING_BYTES_PIPE = sizeof(float) * NST * STAGE_FLOATS;
constexpr size_t FW_BYTES = sizeof(__nv_bfloat16) * TG * LDF;
constexpr size_t RING_BYTES =
    RING_BYTES_PIPE > FW_BYTES ? RING_BYTES_PIPE : FW_BYTES;
constexpr size_t SLAB_BYTES = sizeof(__nv_bfloat16) * TL * LDJ;
constexpr size_t ACC_BYTES = sizeof(float) * TG * LDACC;
constexpr size_t SMEM_BYTES = RING_BYTES + SLAB_BYTES + ACC_BYTES +
                              sizeof(int) * TG * 2 + sizeof(float) * TG * 2 +
                              sizeof(int) * 2 * NWARP;

static_assert(TG == 128 && TL == 128 && NT == 256,
              "the register tile maps 16 × 16 threads onto 128 × 128");
static_assert(TG == 16 * NWARP, "one warp per 16 galaxies in the knot product");
static_assert(TL * NKP == 4 * NT, "the knot slab is 4 copies per thread");
static_assert(RING_BYTES % 16 == 0 && SLAB_BYTES % 16 == 0 &&
                  ACC_BYTES % 16 == 0,
              "alignment");

struct Args {
  const float* sfzh_t;  // (C, blocks·TG) tile-major copy of sfzh: block x
  int64_t ld_a;         // holds columns x·TG .. x·TG+TG−1 (zero padding)
  const int* order;   // K2: galaxy g of the sorted batch is row order[g]
  const float* s;     // (rows,) column shift; K1 subtracts k0·δ
  const float* tau_v;
  const float* scale;
  const float* sed;   // (C, ·) spectra with dλ/λ, row stride ld_sed
  int64_t ld_sed;
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
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte copy; n = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n));
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

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This thread's share of the loads of one λ chunk.
struct Loader {
  const float* a_src;  // its 4 galaxies of the tile-major sfzh, first cell
  const float* b_src;  // its sed column (clamped into the window), first cell
  int a_off, b_off;    // its first A / B element inside a stage
  int b_n;             // 4, or 0 for a column outside the window
  int a_c, b_c;        // its first cell in a stage (A, B)
};

constexpr int A_STEP = NT / (TG / 4);  // cells between a thread's A copies
constexpr int B_STEP = NT / TL;        // cells between a thread's B copies
static_assert(CK % A_STEP == 0 && CK % B_STEP == 0,
              "a stage is whole copies per thread");

// One pipeline stage: CK cells of the A tile [cell][galaxy] (this thread:
// 4 galaxies by one 16-byte copy, cells a_c, a_c+8) and of the B tile
// [cell][λ] (this thread: one column by 4-byte copies, cells b_c, b_c+2,
// ...).
__device__ __forceinline__ void load_stage(float* st, const Loader& ld,
                                           int64_t ld_a, int64_t ld_sed,
                                           int C, int c0) {
  const float* a = ld.a_src + c0 * ld_a;
  const float* b = ld.b_src + c0 * ld_sed;
  float* a_s = st + ld.a_off;
  float* b_s = st + ld.b_off;
  if (c0 + CK <= C) {
#pragma unroll
    for (int i = 0; i < CK / A_STEP; ++i)
      cp_async16(a_s + A_STEP * i * LDA, a + A_STEP * i * ld_a, 16);
#pragma unroll
    for (int i = 0; i < CK / B_STEP; ++i)
      cp_async4(b_s + B_STEP * i * LDB, b + B_STEP * i * ld_sed, ld.b_n);
  } else {  // the last, partial slab of cells
#pragma unroll
    for (int i = 0; i < CK / A_STEP; ++i) {
      const bool ok = c0 + ld.a_c + A_STEP * i < C;
      cp_async16(a_s + A_STEP * i * LDA, ok ? a + A_STEP * i * ld_a : ld.a_src,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < CK / B_STEP; ++i) {
      const bool ok = c0 + ld.b_c + B_STEP * i < C;
      cp_async4(b_s + B_STEP * i * LDB,
                ok ? b + B_STEP * i * ld_sed : ld.b_src, ok ? ld.b_n : 0);
    }
  }
}

// lnu[i][j] of this thread's 8 galaxies × 8 λ columns of the chunk: one
// FMA chain per element over cells in ascending order. Leaves no copy in
// flight.
__device__ __forceinline__ void first_product(float (&lnu)[8][8],
                                              float* ring, const Loader& ld,
                                              int64_t ld_a, int64_t ld_sed,
                                              int C, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) lnu[i][j] = 0.f;
  const int n_ct = (C + CK - 1) / CK;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_ct)
      load_stage(ring + s * STAGE_FLOATS, ld, ld_a, ld_sed, C, s * CK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_ct; ++kt) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage kt landed; stage kt−1 is free to refill
    const int nxt = kt + NST - 1;
    if (nxt < n_ct)
      load_stage(ring + (nxt % NST) * STAGE_FLOATS, ld, ld_a, ld_sed, C,
                 nxt * CK);
    cp_async_commit();
    const float* a_s = ring + (kt % NST) * STAGE_FLOATS;
    const float* b_s = a_s + CK * LDA;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + c * LDA + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a_s + c * LDA + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + c * LDB + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b_s + c * LDB + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) lnu[i][j] = fmaf(a[i], b[j], lnu[i][j]);
    }
  }
  cp_async_wait<0>();
}

// Galaxy / λ column of register-tile entry i / j (two runs of 4, 64 apart:
// the 16-byte shared loads of a warp stay conflict-free).
__device__ __forceinline__ int tile_idx(int i, int t) {
  return (i < 4 ? 0 : 64) + 4 * t + (i & 3);
}

// acc_s[g][j] += fw_s[g][:] · slab_s[:][j] for the warp's 16 galaxies and
// the pass's 64 knot columns.
__device__ __forceinline__ void knot_mma(float* acc_s,
                                         const __nv_bfloat16* fw_s,
                                         const __nv_bfloat16* slab_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 16 * warp + gid;
  float d[NJ / 8][4];
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
  const uint32_t* fw32 = reinterpret_cast<const uint32_t*>(fw_s);
#pragma unroll
  for (int ks = 0; ks < TL / 16; ++ks) {
    const int col = ks * 8 + tig;  // in bf16 pairs
    uint32_t a[4];
    a[0] = fw32[r0 * (LDF / 2) + col];
    a[1] = fw32[(r0 + 8) * (LDF / 2) + col];
    a[2] = fw32[r0 * (LDF / 2) + col + 4];
    a[3] = fw32[(r0 + 8) * (LDF / 2) + col + 4];
#pragma unroll
    for (int np = 0; np < NJ / 16; ++np) {
      // B fragments of n-tiles 2np and 2np+1 from the [λ][column] slab
      const unsigned addr = smem_addr(
          slab_s + (ks * 16 + (lane & 15)) * LDJ + (2 * np + (lane >> 4)) * 8);
      uint32_t b[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
          "[%4];\n"
          : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
          : "r"(addr));
      mma_bf16(d[2 * np], a, b[0], b[1]);
      mma_bf16(d[2 * np + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NJ / 8; ++nt) {
    *reinterpret_cast<float2*>(acc_s + r0 * LDACC + nt * 8 + 2 * tig) =
        make_float2(d[nt][0], d[nt][1]);
    *reinterpret_cast<float2*>(acc_s + (r0 + 8) * LDACC + nt * 8 + 2 * tig) =
        make_float2(d[nt][2], d[nt][3]);
  }
}

// The cluster path (run_cluster) from here on.
//
// Its fw tile is stored fragment-major: the A fragment of mma.sync k-step
// ks for lane `lane` of warp w (rows 16w + gid and + 8, bf16 pairs at
// columns 16ks + 2tig and + 8) is one 16-byte word at
// ((w·8 + ks)·32 + lane)·16 bytes. A warp reads a k-step as 512 contiguous
// bytes, and a peer's tile comes over distributed shared memory in 16-byte
// loads: 4-byte loads of the padded row-major tile made the cluster's knot
// product cost a third of the kernel at 64 bands.
constexpr size_t FWF_BYTES = sizeof(__nv_bfloat16) * TG * TL;
// The knot product runs over halves of a λ chunk: 64 rows, KH k-steps.
constexpr int HALF = TL / 2;
constexpr int KH = HALF / 16;
static_assert(FWF_BYTES <= RING_BYTES, "the fw tile lies over the ring");
static_assert(HALF * NKP % NT == 0, "a slab half is whole copies per thread");

// The warp's (16 galaxies × 64 knot columns) accumulator tile: thread
// (gid, tig) holds rows r0 = 16·warp + gid and r0 + 8, columns 8·nt + 2·tig
// and + 1.
__device__ __forceinline__ void load_acc(float (&d)[NJ / 8][4],
                                         const float* acc_s) {
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + (lane >> 2), tig = lane & 3;
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
                                          float* acc_s) {
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + (lane >> 2), tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NJ / 8; ++nt) {
    *reinterpret_cast<float2*>(acc_s + r0 * LDACC + nt * 8 + 2 * tig) =
        make_float2(d[nt][0], d[nt][1]);
    *reinterpret_cast<float2*>(acc_s + (r0 + 8) * LDACC + nt * 8 + 2 * tig) =
        make_float2(d[nt][2], d[nt][3]);
  }
}

// One k-step of 16 λ rows: d += a (the warp's fw fragment) · slab rows
// 16·ks .. 16·ks + 15, all 64 knot columns.
__device__ __forceinline__ void mma_kstep(float (&d)[NJ / 8][4],
                                          const uint32_t (&a)[4],
                                          const __nv_bfloat16* slab_s,
                                          int ks) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int np = 0; np < NJ / 16; ++np) {
    // B fragments of n-tiles 2np and 2np+1 from the [λ][column] slab
    const unsigned addr = smem_addr(
        slab_s + (ks * 16 + (lane & 15)) * LDJ + (2 * np + (lane >> 4)) * 8);
    uint32_t b[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
        : "r"(addr));
    mma_bf16(d[2 * np], a, b[0], b[1]);
    mma_bf16(d[2 * np + 1], a, b[2], b[3]);
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

// The warp's A fragments of half `half` of a fragment-major fw tile, which
// may lie in a peer block's shared memory: one 16-byte load per k-step.
__device__ __forceinline__ void half_fragments(uint32_t (&a)[KH][4],
                                               const uint32_t* fwf,
                                               int half) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < KH; ++ks) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        fwf + ((warp * (TL / 16) + half * KH + ks) * 32 + lane) * 4);
    a[ks][0] = v.x;
    a[ks][1] = v.y;
    a[ks][2] = v.z;
    a[ks][3] = v.w;
  }
}

// d += a half's fragments · its 64-row slab half.
__device__ __forceinline__ void mma_half(float (&d)[NJ / 8][4],
                                         const uint32_t (&a)[KH][4],
                                         const __nv_bfloat16* slab_s) {
#pragma unroll
  for (int ks = 0; ks < KH; ++ks) mma_kstep(d, a[ks], slab_s, ks);
}

// The block's shared memory: the first product's ring, over which the fw
// tile lies once the product is done; the knot slab; the accumulator; the
// galaxies' rows, knot intervals, fractions and dust depths; a reduction
// scratch.
struct Smem {
  float* ring;
  __nv_bfloat16* fw;
  __nv_bfloat16* slab;
  float* acc;
  int* rows;
  int* k;
  float* t;
  float* tau;
  int* red;  // [2][NWARP]
};

__device__ __forceinline__ Smem smem_layout() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s;
  s.ring = reinterpret_cast<float*>(smem_raw);
  s.fw = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  s.slab = reinterpret_cast<__nv_bfloat16*>(smem_raw + RING_BYTES);
  s.acc = reinterpret_cast<float*>(smem_raw + RING_BYTES + SLAB_BYTES);
  s.rows = reinterpret_cast<int*>(s.acc + TG * LDACC);
  s.k = s.rows + TG;
  s.t = reinterpret_cast<float*>(s.k + TG);
  s.tau = s.t + TG;
  s.red = reinterpret_cast<int*>(s.tau + TG);
  return s;
}

// The block's galaxy tile: its window group and start (k0, l0), and the
// first knots its galaxies read, band_lo .. band_top (band_top < 0: the
// tile holds no galaxy).
struct Tile {
  int k0, l0, band_lo, band_top;
};

// Reads the tile's galaxies into shared memory (row, knot interval,
// fraction, dust depth) and reduces the band of first knots they span.
__device__ __forceinline__ Tile setup_tile(const Args& p, const Smem& sm) {
  const int tid = threadIdx.x;
  const int grp = blockIdx.x / p.tiles_per_group;
  const int tile = blockIdx.x % p.tiles_per_group;
  Tile t;
  t.k0 = p.win ? p.win[2 * grp] : 0;
  t.l0 = p.win ? p.win[2 * grp + 1] : 0;
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
    lo_min = __reduce_min_sync(0xffffffffu, lo_min);
    lo_max = __reduce_max_sync(0xffffffffu, lo_max);
    if (tid % 32 == 0) {
      sm.red[tid / 32] = lo_min;
      sm.red[NWARP + tid / 32] = lo_max;
    }
  }
  __syncthreads();
  t.band_lo = sm.red[0];
  t.band_top = sm.red[NWARP];
#pragma unroll
  for (int w = 1; w < TG / 32; ++w) {
    t.band_lo = min(t.band_lo, sm.red[w]);
    t.band_top = max(t.band_top, sm.red[NWARP + w]);
  }
  return t;
}

// This thread's copies: galaxies 4·(tid%32).., cells tid/32, +8; λ column
// tid%128, cells tid/128, +2, ...
__device__ __forceinline__ Loader make_loader(const Args& p) {
  const int tid = threadIdx.x;
  Loader ld;
  ld.a_c = tid / (TG / 4);
  ld.a_src = p.sfzh_t + (int64_t)ld.a_c * p.ld_a + (int64_t)blockIdx.x * TG +
             4 * (tid % (TG / 4));
  ld.a_off = ld.a_c * LDA + 4 * (tid % (TG / 4));
  ld.b_c = tid / TL;
  ld.b_off = CK * LDA + ld.b_c * LDB + tid % TL;
  return ld;
}

// Points the loader's B copies at window column lw0 + tid%128 (zero fill
// past the window).
__device__ __forceinline__ void at_chunk(Loader& ld, const Args& p, int l0,
                                         int lw0) {
  const int lb = lw0 + threadIdx.x % TL;
  ld.b_n = lb < p.W ? 4 : 0;
  ld.b_src = p.sed + (int64_t)ld.b_c * p.ld_sed + l0 + (ld.b_n ? lb : 0);
}

// Rows lw0 .. lw0 + ROWS − 1 of the window's knot slab [λ][knot·8 + band]
// for band group fb0 and knots pk0 .. pk0 + 7, one 16-byte copy per λ row
// and knot; rows past the window and knots past nk are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_slab(__nv_bfloat16* slab_s,
                                          const Args& p, const Tile& t,
                                          int pk0, int fb0, int lw0) {
#pragma unroll
  for (int i = 0; i < ROWS * NKP / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e % NKP, l = e / NKP;
    const bool ok = pk0 + r < p.nk && lw0 + l < p.W;
    const __nv_bfloat16* src =
        ok ? p.knot + (int64_t)(t.l0 + lw0 + l) * p.ld_knot +
                 (int64_t)(t.k0 + pk0 + r) * p.f8 + fb0
           : p.knot;
    cp_async16(slab_s + l * LDJ + r * FB, src, ok ? 16 : 0);
  }
}

// Dust screen, then bf16 (the knot product's input type), into the
// fragment-major fw tile.
__device__ __forceinline__ void screen(const float (&lnu)[8][8],
                                       const Smem& sm, const Args& p, int l0,
                                       int lw0, int tx, int ty) {
  uint32_t* fwf = reinterpret_cast<uint32_t*>(sm.fw);
  float k_l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lw = lw0 + tile_idx(j, tx);
    k_l[j] = lw < p.W ? p.curve[l0 + lw] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int g = tile_idx(i, ty);
    const float tau = sm.tau[g];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t bits[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float att = expf(-tau * k_l[4 * h + j]);
        if (p.fesc != 0.f) att = p.fesc + (1.f - p.fesc) * att;
        bits[j] = __bfloat16_as_ushort(
            __float2bfloat16_rn(lnu[i][4 * h + j] * att));
      }
      // two bf16 pairs, the lower column in the lower bits
      const int c = tile_idx(4 * h, tx);
      fwf[frag_word(g, c)] = bits[0] | (bits[1] << 16);
      fwf[frag_word(g, c + 2)] = bits[2] | (bits[3] << 16);
    }
  }
}

// The galaxies whose 4 knots pass `pass` holds are finished: their fluxes
// in the block's 8 bands from the accumulator.
__device__ __forceinline__ void finish_pass(const Args& p, const Smem& sm,
                                            const Tile& t, int pass, int pk0,
                                            int fb0) {
  for (int e = threadIdx.x; e < TG * FB; e += NT) {
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

// The whole block: TG galaxies of one window group, FB bands. The lone
// block (F8 = 8) keeps its own straight-line code rather than the helpers
// above: built from them it takes one more register and spills, and runs 3%
// slower.
__device__ __forceinline__ void run_block(const Args& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* fw_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* slab_s =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + RING_BYTES);
  float* acc_s = reinterpret_cast<float*>(smem_raw + RING_BYTES + SLAB_BYTES);
  int* rows_s = reinterpret_cast<int*>(acc_s + TG * LDACC);
  int* k_s = rows_s + TG;
  float* t_s = reinterpret_cast<float*>(k_s + TG);
  float* tau_s = t_s + TG;
  int* red_s = reinterpret_cast<int*>(tau_s + TG);  // [2][NWARP]

  const int tid = threadIdx.x;
  const int grp = blockIdx.x / p.tiles_per_group;
  const int tile = blockIdx.x % p.tiles_per_group;
  const int fb0 = blockIdx.y * FB;
  const int k0 = p.win ? p.win[2 * grp] : 0;
  const int l0 = p.win ? p.win[2 * grp + 1] : 0;

  if (tid < TG) {
    const int loc = tile * TG + tid;
    const int idx = grp * p.group_rows + loc;
    const bool ok = loc < p.group_rows && idx < p.B;
    const int row = ok ? (p.order ? p.order[idx] : idx) : -1;
    int lo_min = 0x7fffffff, lo_max = -1, k = 0;
    float t = 0.f, tau = 0.f;
    if (ok) {
      const float s_rel = p.s[row] - (float)(k0 * p.delta);
      const float c = fminf(fmaxf(s_rel, 0.f), p.s_max) / (float)p.delta;
      k = (int)floorf(c);
      t = c - (float)k;
      tau = p.tau_v[row];
      lo_min = lo_max = max(k - 1, 0);  // first of the galaxy's knots
    }
    rows_s[tid] = row;
    k_s[tid] = k;
    t_s[tid] = t;
    tau_s[tid] = tau;
    lo_min = __reduce_min_sync(0xffffffffu, lo_min);
    lo_max = __reduce_max_sync(0xffffffffu, lo_max);
    if (tid % 32 == 0) {
      red_s[tid / 32] = lo_min;
      red_s[NWARP + tid / 32] = lo_max;
    }
  }
  __syncthreads();
  int band_lo = red_s[0], band_top = red_s[NWARP];
#pragma unroll
  for (int w = 1; w < TG / 32; ++w) {
    band_lo = min(band_lo, red_s[w]);
    band_top = max(band_top, red_s[NWARP + w]);
  }
  if (band_top < 0) return;  // no galaxy in this tile (uniform per block)

  // this thread's copies: galaxies 4·(tid%32).., cells tid/32, +8; λ
  // column tid%128, cells tid/128, +2, ...
  const int tx = tid % 16, ty = tid / 16;
  Loader ld;
  ld.a_c = tid / (TG / 4);
  ld.a_src = p.sfzh_t + (int64_t)ld.a_c * p.ld_a +
             (int64_t)blockIdx.x * TG + 4 * (tid % (TG / 4));
  ld.a_off = ld.a_c * LDA + 4 * (tid % (TG / 4));
  ld.b_c = tid / TL;
  ld.b_off = CK * LDA + ld.b_c * LDB + tid % TL;

  const int n_pass = (band_top - band_lo) / PASS_STEP + 1;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int pk0 = band_lo + pass * PASS_STEP;  // first knot of the pass
    for (int e = tid; e < TG * LDACC; e += NT) acc_s[e] = 0.f;
    for (int lw0 = 0; lw0 < p.W; lw0 += TL) {
      // the chunk's knot slab [λ][knot·8 + band], in flight during the
      // first product (one 16-byte copy per λ row and knot)
#pragma unroll
      for (int i = 0; i < TL * NKP / NT; ++i) {
        const int e = tid + i * NT;
        const int r = e % NKP, l = e / NKP;
        const bool ok = pk0 + r < p.nk && lw0 + l < p.W;
        const __nv_bfloat16* src =
            ok ? p.knot + (int64_t)(l0 + lw0 + l) * p.ld_knot +
                     (int64_t)(k0 + pk0 + r) * p.f8 + fb0
               : p.knot;
        cp_async16(slab_s + l * LDJ + r * FB, src, ok ? 16 : 0);
      }
      cp_async_commit();
      const int lb = lw0 + tid % TL;  // its window column
      ld.b_n = lb < p.W ? 4 : 0;
      ld.b_src = p.sed + (int64_t)ld.b_c * p.ld_sed + l0 + (ld.b_n ? lb : 0);
      float lnu[8][8];
      first_product(lnu, ring, ld, p.ld_a, p.ld_sed, p.C, tx, ty);
      __syncthreads();  // every warp is done with the ring; slab landed

      // dust screen, then bf16 (the knot product's input type)
      float k_l[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int lw = lw0 + tile_idx(j, tx);
        k_l[j] = lw < p.W ? p.curve[l0 + lw] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int g = tile_idx(i, ty);
        const float tau = tau_s[g];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bits[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float att = expf(-tau * k_l[4 * h + j]);
            if (p.fesc != 0.f) att = p.fesc + (1.f - p.fesc) * att;
            bits[j] = __bfloat16_as_ushort(
                __float2bfloat16_rn(lnu[i][4 * h + j] * att));
          }
          // four bf16, the lowest column in the lowest bits
          *reinterpret_cast<uint2*>(fw_s + g * LDF + tile_idx(4 * h, tx)) =
              make_uint2(bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16));
        }
      }
      __syncthreads();
      knot_mma(acc_s, fw_s, slab_s);
      __syncthreads();  // fw_s / slab_s read; both may refill
    }
    // galaxies whose 4 knots this pass holds are finished here
    for (int e = tid; e < TG * FB; e += NT) {
      const int g = e / FB, fl = e % FB, f = fb0 + fl;
      const int row = rows_s[g];
      const int k = k_s[g];
      if (row < 0 || (max(k - 1, 0) - band_lo) / PASS_STEP != pass)
        continue;
      const float* acc_g = acc_s + g * LDACC + fl;
      const auto num_at = [&](int kk) { return acc_g[(kk - pk0) * FB]; };
      const auto den_at = [&](int kk) {
        return p.den[(int64_t)(k0 + kk) * p.ld_den + f];
      };
      const float num = knot_interp(num_at, k, t_s[g], p.nk, p.order_interp);
      const float dn = knot_interp(den_at, k, t_s[g], p.nk, p.order_interp);
      p.out[(int64_t)row * p.f8 + f] =
          num / fmaxf(dn, 1.0e-30f) * p.scale[row];
    }
    __syncthreads();  // acc_s read before the next pass clears it
  }
}

// One block of a cluster of n along y (F8 > 8): the galaxy tile's first
// product shared by the cluster's band groups (header: "Band groups").
// Every barrier below is reached by every block of the cluster: the tile,
// its passes and the window are the cluster's.
//
// The knot product of a super-chunk walks its 2·n_tiles λ halves in
// ascending order. Slab halves alternate between the two halves of the slab
// buffer, one in flight while the other is contracted; a half's A
// fragments, usually a peer's, are read in four 16-byte loads before its
// mma.sync steps (reading the next half's ahead cost more registers than
// it hid).
__device__ __forceinline__ void run_cluster(const Args& p) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const dim3 dims = cluster.dim_blocks();
  const int n = (int)(dims.x * dims.y * dims.z);
  const int rank = (int)cluster.block_rank();
  const Smem sm = smem_layout();
  const Tile t = setup_tile(p, sm);
  if (t.band_top < 0) return;  // uniform per cluster: the same galaxies
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int fb0 = blockIdx.y * FB;
  const bool bands = fb0 < p.f8;  // false in a padding slot
  Loader ld = make_loader(p);
  // slab half h of the super-chunk, in buffer h % 2 of the slab region
  const auto slab_buf = [&](int h) { return sm.slab + (h % 2) * HALF * LDJ; };
  // A fragments of half h of the super-chunk: half h % 2 of the fw tile of
  // block h / 2
  const auto fragments = [&](uint32_t(&a)[KH][4], int h) {
    half_fragments(a, reinterpret_cast<const uint32_t*>(
                          cluster.map_shared_rank(sm.fw, h / 2)),
                   h % 2);
  };

  const int n_pass = (t.band_top - t.band_lo) / PASS_STEP + 1;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int pk0 = t.band_lo + pass * PASS_STEP;
    for (int e = tid; e < TG * LDACC; e += NT) sm.acc[e] = 0.f;
    for (int sc0 = 0; sc0 < p.W; sc0 += n * TL) {  // super-chunk
      const int n_tiles = min(n, (p.W - sc0 + TL - 1) / TL);
      if (bands) {  // halves 0 and 1, in flight during the first product
        load_slab<HALF>(slab_buf(0), p, t, pk0, fb0, sc0);
        load_slab<HALF>(slab_buf(1), p, t, pk0, fb0, sc0 + HALF);
      }
      if (rank < n_tiles) {  // this block's chunk: fw of columns lw0..
        const int lw0 = sc0 + rank * TL;
        at_chunk(ld, p, t.l0, lw0);
        float lnu[8][8];
        first_product(lnu, sm.ring, ld, p.ld_a, p.ld_sed, p.C, tx, ty);
        __syncthreads();  // every warp is done with the ring
        screen(lnu, sm, p, t.l0, lw0, tx, ty);
      }
      cp_async_commit();
      cp_async_wait<0>();
      cluster.sync();  // every fw tile of the super-chunk is written
      if (bands) {
        const int n_half = 2 * n_tiles;
        float d[NJ / 8][4];
        load_acc(d, sm.acc);
        uint32_t a[KH][4];
        for (int h = 0; h < n_half; ++h) {
          if (h > 0) {
            cp_async_wait<0>();
            __syncthreads();  // half h landed; half h − 1's buffer is free
            if (h + 1 < n_half)
              load_slab<HALF>(slab_buf(h + 1), p, t, pk0, fb0,
                              sc0 + (h + 1) * HALF);
            cp_async_commit();
          }
          fragments(a, h);
          mma_half(d, a, slab_buf(h));
        }
        store_acc(d, sm.acc);
      }
      cluster.sync();  // the peers are done with this block's fw tile
    }
    if (bands) finish_pass(p, sm, t, pass, pk0, fb0);
    __syncthreads();  // acc read before the next pass clears it
  }
}

// Launch over `groups` window groups of `p.group_rows` rows and every band
// group, on `stream`: `kernel` (a __global__ wrapper of run_block) for
// cluster = 1, else `cluster_kernel` (of run_cluster) in clusters of
// `cluster` blocks along y, the band groups padded up to whole clusters.
// cluster must lie in [1, 8], the portable cluster sizes. Returns the
// launch's cudaError_t (0 = ok); a cluster launch the card refuses returns
// its error and runs nothing.
template <class Kernel>
inline int launch(Kernel kernel, Kernel cluster_kernel, Args p, int groups,
                  int cluster, cudaStream_t stream) {
  if (cluster < 1 || cluster > 8) return (int)cudaErrorInvalidValue;
  Kernel k = cluster == 1 ? kernel : cluster_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  p.tiles_per_group = (p.group_rows + TG - 1) / TG;
  // same clip bound as `_knot_interp`: computed in double, rounded to float
  p.s_max = (float)((p.nk - 1) * (double)p.delta - 1.0e-3);
  const int band_groups = p.f8 / FB;  // f8 % FB == 0
  const dim3 grid(groups * p.tiles_per_group,
                  (band_groups + cluster - 1) / cluster * cluster);
  if (cluster == 1) {
    kernel<<<grid, NT, SMEM_BYTES, stream>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM_BYTES;
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
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, cluster);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, cluster_kernel, &cfg);
}

}  // namespace sed_tile
