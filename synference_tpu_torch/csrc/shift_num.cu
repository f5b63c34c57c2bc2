// K3: exact-shift photometry numerators for Hopper (sm_90a).
//
// Replaces both TPU Pallas numerator kernels of
// `synference_tpu/ops/photometry_kernel.py`: `_num_kernel` (through
// `pallas_photometry_num`, the "roll" variant) and `_num_kernel_bank`
// (through `pallas_photometry_num_bank`, the "bank" variant). Both compute,
// for each galaxy b with snapped shift s4_b = 8·m_b + rs_b,
//
//   num[b,f] = Σ_{l<L} fw[b,l] · table[rs_b, f, l + m_b]
//
// with fw the observed flux times dλ/λ and table[rs, f, j] the filter
// transmission at λ0·10^{(j + rs/8)Δ}. The TPU cannot slice a lane
// dimension at an arbitrary offset, so "roll" rotated the flux row with
// `pltpu.roll` and "bank" DMA'd one of 128 pre-rolled copies of the table;
// on the card an arbitrary-offset read of shared memory has no alignment
// rule, so one kernel reads table[rs, f, l + m] directly and serves both
// names.
//
// What bounds it on the H100: the flux slab. fw is (B, L) fp32 read once
// (537 MB at B = 65536, L = 2048: 0.16 ms at 3.35 TB/s) against F8·L FMAs
// per galaxy (2.1 GFLOP, 0.03 ms). The (8, F8, L + max_shift) table is
// 0.7 MB, so everything but the flux stream has to stay off the memory
// system: the table in shared memory, its values reused from registers.
//
// Design.
// - Rows in shift order. The wrapper sorts the rows by the key
//   rs·n_m + m (n_m = n_cols − L + 1 integer shifts) and passes the sorted
//   keys and the permutation; the kernel reads fw[order[g]] and writes
//   out[order[g]]. A tile of R = 64 consecutive sorted rows then has one rs
//   and a narrow span of m. The keys come from a one-line kernel
//   (`k3_shift_keys`), as int16 where they fit (half the radix passes of
//   the sort); the first row of each rs is found by a warp-wide search in
//   the kernel, so nothing comes back to the host.
// - Persistent blocks, one per SM, each with a contiguous run of tiles, so
//   a block keeps one rs slab of the table in shared memory for all its
//   tiles. The wrapper passes the table band-adjacent, (8, F8/4, ncp, 4):
//   the 8 bands of a column are two 16-byte shared-memory reads that
//   neighbouring lanes take from neighbouring addresses. Of a slab that
//   does not fit (the north-star grid's 10⁴ columns) each flux chunk takes
//   the column band [l0 + m_min, l0 + LT + m_max) of its tile, brought by
//   16-byte cp.async copies in the chunk's own copy group into one half of
//   the buffer while the other half is read; a band wider than a half
//   (a tile whose shifts span more than it holds) is staged in pieces by
//   plain loads between two barriers.
// - The flux as a stream: a ring of two R × LT (64 × 256) tiles filled by
//   16-byte cp.async copies with zero fill past L and past the tile's last
//   row, one barrier per stage: 64 KB per SM are in flight while the other
//   tile is summed (measured on an H100 against three stages of 64 × 128:
//   the wider chunk wins, the deeper ring does not). A flux slab whose
//   rows are not 16-byte aligned takes the same kernel with 4-byte copies
//   (VEC = 1). Row addresses, shifts and output rows of a tile are fetched
//   one tile ahead, so no step waits for them.
// - One shared-memory read of the table feeds four rows. A warp owns four
//   consecutive sorted rows and walks the table columns j its rows touch,
//   lane = j mod 32: per 32 columns it reads the 8 band values once and,
//   for each row, the flux at l = j − m_row (a 4-byte shared read, masked
//   at the chunk's edges): 6 shared reads per 32 FMAs.
// - Fixed summation order. A lane sums the columns j ≡ lane (mod 32) of a
//   row in ascending order whatever the other rows are, and the 32 lanes
//   are added by a fixed butterfly, so a row's bits depend on nothing but
//   that row, its shift and the table: not on the batch, the tile, the
//   staging mode or the copy width.
// - More than 8 bands: the pass is repeated per group of 8 bands.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_SUB = 8;   // sub-column shifts of the table
constexpr int NB = 8;      // bands per pass
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int RR = 4;          // rows per warp
constexpr int R = WARPS * RR;  // rows per tile
constexpr int LT = 256;        // flux columns per stage
constexpr int STAGES = 2;
constexpr int STAGE_FLOATS = R * LT;
constexpr int RING_BYTES = STAGES * STAGE_FLOATS * 4;
constexpr int LOAD_ROWS = R / WARPS;  // rows a warp copies per stage
static_assert(LT % 128 == 0, "a warp copies 128 floats of a row at a time");
// table columns that fit beside the ring in a block's 227 KB (less the
// static shared memory), a multiple of 32
constexpr int TB_MAX = (232448 - 1280 - RING_BYTES) / (NB * 4) / 32 * 32;

struct Args {
  const float* fw;  // (B, L) flux, row stride ld_fw
  int64_t ld_fw;
  const float4* tab;     // (N_SUB, f8/4, ncp) band-adjacent table
  const void* keys;      // (B,) sorted keys rs·n_m + m, int16 or int32
  const int64_t* order;  // (B,) sorted position -> row
  float* out;            // (B, f8)
  int B, L, f8, ncp, n_m, tb_cols;
};

struct Tile {
  int g, rs, row0, rows;  // band group, table row, first sorted row, count
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one copy of VEC floats, of which the first n bytes are read and the rest
// written as zeros
template <int VEC>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         int n) {
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ Tile locate(int item, int n_tiles, const int* offs,
                                       const int* tile0) {
  Tile t;
  t.g = item / n_tiles;
  const int ti = item - t.g * n_tiles;
  int rs = 0;  // the last rs whose first tile is not after ti
#pragma unroll
  for (int i = 1; i < N_SUB; ++i) rs += (ti >= tile0[i]);
  t.rs = rs;
  t.row0 = offs[rs] + (ti - tile0[rs]) * R;
  t.rows = min(R, offs[rs + 1] - t.row0);
  return t;
}

// The first sorted position whose key is not below `want`, by one warp: 32
// probes a round, so 65536 rows take 4 rounds of one load each.
template <typename KeyT>
__device__ __forceinline__ int lower_bound_warp(const KeyT* keys, int n,
                                                int want, int lane) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int part = (int)((int64_t)(hi - lo) * (lane + 1) / 32);
    const int pos = max(lo + part - 1, lo);  // ascending in lane, hi − 1 last
    const unsigned below =
        __ballot_sync(0xffffffffu, (int)keys[pos] < want);  // lanes 0..cnt−1
    const int cnt = __popc(below);
    const int last_below = __shfl_sync(0xffffffffu, pos, max(cnt - 1, 0));
    const int first_not = __shfl_sync(0xffffffffu, pos, min(cnt, 31));
    if (cnt > 0) lo = last_below + 1;
    if (cnt < 32) hi = first_not;
  }
  return lo;
}

// One halving step of `reduce_transpose`: lanes with bit W set keep the
// upper W sums and send the lower, the others the reverse.
template <int W>
__device__ __forceinline__ void reduce_step(float (&a)[RR * NB], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = up ? a[i] : a[i + W];
    const float keep = up ? a[i + W] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Adds a[v] over the 32 lanes for v < 32; lane v gets sum v. 31 shuffles,
// the same pairing of lanes for every v.
__device__ __forceinline__ float reduce_transpose(float (&a)[RR * NB],
                                                  int lane) {
  static_assert(RR * NB == 32, "one sum per lane");
  reduce_step<16>(a, lane);
  reduce_step<8>(a, lane);
  reduce_step<4>(a, lane);
  reduce_step<2>(a, lane);
  reduce_step<1>(a, lane);
  return a[0];
}

template <int VEC, typename KeyT>
__global__ void __launch_bounds__(THREADS, 1)
k3_shift_num_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float4* tab_s = reinterpret_cast<float4*>(smem + STAGES * STAGE_FLOATS);
  __shared__ int offs[N_SUB + 1];   // first sorted row of each rs
  __shared__ int tile0[N_SUB + 1];  // first tile of each rs

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const KeyT* keys = static_cast<const KeyT*>(p.keys);
  for (int rs = warp; rs <= N_SUB; rs += WARPS) {
    const int first = lower_bound_warp(keys, p.B, rs * p.n_m, lane);
    if (lane == 0) offs[rs] = first;
  }
  __syncthreads();
  if (tid == 0) {
    int t = 0;
    for (int rs = 0; rs < N_SUB; ++rs) {
      tile0[rs] = t;
      t += (offs[rs + 1] - offs[rs] + R - 1) / R;
    }
    tile0[N_SUB] = t;
  }
  __syncthreads();
  const int n_tiles = tile0[N_SUB];
  const int n_chunks = (p.L + LT - 1) / LT;
  const int64_t n_items = (int64_t)n_tiles * (p.f8 / NB);
  const int item_lo = (int)(n_items * blockIdx.x / gridDim.x);
  const int item_hi = (int)(n_items * (blockIdx.x + 1) / gridDim.x);
  const int n_steps = (item_hi - item_lo) * n_chunks;
  // a slab that fits stays in the whole buffer; else the buffer's halves
  // take the column bands of alternate steps
  const bool resident = p.tb_cols == p.ncp;
  const int cap = resident ? p.tb_cols : p.tb_cols / 64 * 32;
  const int quads = p.f8 / 4;
  auto plane = [&](int rs, int g, int h) {  // band group g's half h of rs
    return p.tab + ((int64_t)rs * quads + 2 * g + h) * p.ncp;
  };

  // loader: step by step through (item, chunk); a warp copies rows
  // warp + WARPS·k of the tile. What it needs of a tile is fetched one tile
  // ahead (loads only), so that no step waits for it.
  struct {
    int rows, rs, g, key_lo, key_hi, row[LOAD_ROWS];
  } ld = {}, ld_next = {};
  int ld_item = item_lo, ld_chunk = 0;
  auto fetch_rows = [&](int it) {
    if (it >= item_hi) return;
    const Tile t = locate(it, n_tiles, offs, tile0);
    ld_next.rows = t.rows, ld_next.rs = t.rs, ld_next.g = t.g;
    ld_next.key_lo = keys[t.row0];
    ld_next.key_hi = keys[t.row0 + t.rows - 1];
#pragma unroll
    for (int k = 0; k < LOAD_ROWS; ++k)
      ld_next.row[k] =
          (int)p.order[t.row0 + min(warp + WARPS * k, t.rows - 1)];
  };
  fetch_rows(item_lo);
  auto enqueue = [&](int q) {
    if (q < n_steps) {
      if (ld_chunk == 0) {
        ld = ld_next;
        fetch_rows(ld_item + 1);
      }
      float* dst = ring + (q % STAGES) * STAGE_FLOATS;
      const int l0 = ld_chunk * LT;
#pragma unroll
      for (int k = 0; k < LOAD_ROWS; ++k) {
        const int r = warp + WARPS * k;
        const float* src = p.fw + (int64_t)ld.row[k] * p.ld_fw + l0;
#pragma unroll
        for (int i = 0; i < LT / (32 * VEC); ++i) {
          const int c = (32 * i + lane) * VEC;
          const int n = r < ld.rows ? 4 * min(max(p.L - l0 - c, 0), VEC) : 0;
          cp_async<VEC>(dst + r * LT + c, n > 0 ? src + c : p.fw, n);
        }
      }
      if (!resident) {  // the step's band of the table rides with its flux
        const int base = ld.rs * p.n_m;
        const int lo = (l0 + ld.key_lo - base) & ~31;
        const int hi = (l0 + min(LT, p.L - l0) + ld.key_hi - base + 31) & ~31;
        if (hi - lo <= cap) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4* from = plane(ld.rs, ld.g, h) + lo;
            float4* to = tab_s + h * p.tb_cols + (q & 1) * cap;
            for (int i = tid; i < hi - lo; i += THREADS)
              cp_async<4>(reinterpret_cast<float*>(to + i),
                          reinterpret_cast<const float*>(from + i), 16);
          }
        }
      }
      if (++ld_chunk == n_chunks) {
        ld_chunk = 0;
        ++ld_item;
      }
    }
    cp_async_commit();
  };

  // consumer state: the warp's rows RR·warp .. RR·warp+RR−1 of the tile
  // (shifts and output row of the next tile are fetched a tile ahead too)
  Tile cur = {0, 0, 0, 0}, next = {0, 0, 0, 0};
  int chunk = 0, item = item_lo;
  int m[RR], tile_mlo = 0, tile_mhi = 0;
  int key_next[RR], key_lo_next = 0, key_hi_next = 0;
  int out_row = 0, out_row_next = 0;
  float acc[RR * NB];
  auto fetch_tile = [&](int it) {
    if (it >= item_hi) return;
    next = locate(it, n_tiles, offs, tile0);
#pragma unroll
    for (int r = 0; r < RR; ++r)  // absent rows (zero flux) repeat the last
      key_next[r] = keys[next.row0 + min(RR * warp + r, next.rows - 1)];
    key_lo_next = keys[next.row0];
    key_hi_next = keys[next.row0 + next.rows - 1];
    out_row_next =
        (int)p.order[next.row0 + min(RR * warp + lane / NB, next.rows - 1)];
  };
  fetch_tile(item_lo);
  int st_rs = -1, st_g = -1, st_lo = 0, st_hi = 0;  // the staged table band

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) enqueue(s);

  for (int q = 0; q < n_steps; ++q) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage q landed; stage q−1's buffers are free
    enqueue(q + STAGES - 1);

    if (chunk == 0) {
      cur = next;
      const int base = cur.rs * p.n_m;
#pragma unroll
      for (int r = 0; r < RR; ++r) m[r] = key_next[r] - base;
      tile_mlo = key_lo_next - base;
      tile_mhi = key_hi_next - base;
      out_row = out_row_next;
      fetch_tile(item + 1);
#pragma unroll
      for (int i = 0; i < RR * NB; ++i) acc[i] = 0.f;
    }
    const float* fs = ring + (q % STAGES) * STAGE_FLOATS + RR * warp * LT;
    const int l0 = chunk * LT;
    const int ltc = min(LT, p.L - l0);
    // the warp's table columns: rows are sorted, so m[0] is its least shift
    const int jw0 = (l0 + m[0]) & ~31;
    const int jw1 = RR * warp < cur.rows ? l0 + ltc + m[RR - 1] : 0;
    const int need_lo = resident ? 0 : (l0 + tile_mlo) & ~31;
    const int need_hi = resident ? p.ncp : (l0 + ltc + tile_mhi + 31) & ~31;
    float4* ts = tab_s + (resident ? 0 : (q & 1) * cap);
    if (!resident) {  // a band that fits came with the flux; else none is in
      const bool came = need_hi - need_lo <= cap;
      st_rs = came ? cur.rs : -1;
      st_g = cur.g, st_lo = need_lo, st_hi = need_hi;
    }
    for (int pl = need_lo; pl < need_hi; pl += cap) {
      const int ph = min(pl + cap, need_hi);
      if (st_rs != cur.rs || st_g != cur.g || st_lo != pl || st_hi < ph) {
        // every thread takes this branch alike; before the first piece of a
        // step the barrier above has already ended all reads of the band
        if (pl != need_lo) __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4* from = plane(cur.rs, cur.g, h) + pl;
          float4* to = ts + h * p.tb_cols;
#pragma unroll 4
          for (int i = tid; i < ph - pl; i += THREADS) to[i] = __ldg(from + i);
        }
        st_rs = cur.rs, st_g = cur.g, st_lo = pl, st_hi = ph;
        __syncthreads();
      }
      const int j1 = min(jw1, ph);
#pragma unroll 2
      for (int jb = max(jw0, pl); jb < j1; jb += 32) {
        const int j = jb + lane;
        const float4 t0 = ts[j - pl];
        const float4 t1 = ts[p.tb_cols + j - pl];
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const int idx = j - m[r] - l0;
          float v = 0.f;
          if ((unsigned)idx < (unsigned)ltc) v = fs[r * LT + idx];
          float* a = acc + r * NB;
          a[0] = fmaf(v, t0.x, a[0]);
          a[1] = fmaf(v, t0.y, a[1]);
          a[2] = fmaf(v, t0.z, a[2]);
          a[3] = fmaf(v, t0.w, a[3]);
          a[4] = fmaf(v, t1.x, a[4]);
          a[5] = fmaf(v, t1.y, a[5]);
          a[6] = fmaf(v, t1.z, a[6]);
          a[7] = fmaf(v, t1.w, a[7]);
        }
      }
    }

    if (++chunk == n_chunks) {  // the tile is done: lane = row·NB + band
      const float sum = reduce_transpose(acc, lane);
      if (RR * warp + lane / NB < cur.rows)
        p.out[(int64_t)out_row * p.f8 + cur.g * NB + lane % NB] = sum;
      chunk = 0;
      ++item;
    }
  }
  cp_async_wait<0>();
}

template <typename KeyT>
__global__ void k3_shift_keys_kernel(const int* __restrict__ s4,
                                     KeyT* __restrict__ keys, int B, int n_m) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int s = max(s4[b], 0);
  keys[b] = (KeyT)((s % N_SUB) * n_m + min(s / N_SUB, n_m - 1));
}

}  // namespace

extern "C" {

// Writes each row's key rs·n_m + min(m, n_m − 1) of s4 = 8m + rs (negative
// s4 count as 0), as int16 (`key_bytes` = 2) or int32 (4).
int k3_shift_keys(const int* s4, void* keys, int B, int n_m, int key_bytes,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (B + 255) / 256;
  if (key_bytes == 2)
    k3_shift_keys_kernel<<<grid, 256, 0, st>>>(s4, static_cast<int16_t*>(keys),
                                               B, n_m);
  else
    k3_shift_keys_kernel<<<grid, 256, 0, st>>>(s4, static_cast<int32_t*>(keys),
                                               B, n_m);
  return (int)cudaGetLastError();
}

// Launches the kernel on `stream`; returns the first CUDA error (0 = ok).
// `tab` is the band-adjacent table (N_SUB, f8/4, ncp, 4) with ncp a
// multiple of 32 and zeros past column n_cols − 1; `keys` the rows' keys
// rs·(n_cols − L + 1) + m in ascending order (int16 or int32 by
// `key_bytes`) and `order` the row of each sorted position. `vec` = 4 needs
// 16-byte aligned flux rows; `vec` = 1 takes any. Needs f8 a multiple of 8
// and n_cols >= L.
int k3_shift_num(const float* fw, int64_t ld_fw, const float* tab,
                 const void* keys, int key_bytes, const int64_t* order,
                 float* out, int B, int L, int f8, int n_cols, int ncp,
                 int vec, void* stream) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  Args p;
  p.fw = fw, p.ld_fw = ld_fw;
  p.tab = reinterpret_cast<const float4*>(tab);
  p.keys = keys, p.order = order, p.out = out;
  p.B = B, p.L = L, p.f8 = f8, p.ncp = ncp, p.n_m = n_cols - L + 1;
  p.tb_cols = ncp < TB_MAX ? ncp : TB_MAX;
  const int smem = RING_BYTES + p.tb_cols * NB * 4;
  // every rs adds at most one ragged tile
  const int64_t items = ((int64_t)(B + R - 1) / R + N_SUB) * (f8 / NB);
  const int grid = (int)(items < n_sm ? items : n_sm);
  void (*kernel)(Args) =
      vec == 4 ? (key_bytes == 2 ? k3_shift_num_kernel<4, int16_t>
                                 : k3_shift_num_kernel<4, int32_t>)
               : (key_bytes == 2 ? k3_shift_num_kernel<1, int16_t>
                                 : k3_shift_num_kernel<1, int32_t>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
