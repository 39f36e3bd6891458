// Local plane-fit flow, one thread per pixel.
//
// Replaces the two Pallas kernels behind local_flow_pallas
// (farms_tpu/ops/pallas/kernels.py:341), in their default, their
// correction (`t_center`, inc_center=False) and their halo (`halo`,
// `row_offset`: a row shard of parallel/halo.py) modes, and in the tile
// mode of the port's spatial engine (a 2-D tile of parallel/tiling.py):
// - `_local_flow_kernel_cached` (:434, k = 3 and 5) by the streamed
//   kernels local_flow_streamed<1> and <2>, whose filter radius is a
//   template constant;
// - `_local_flow_kernel` (:171, any odd k; the JAX package sends k >= 7
//   there) by local_flow_general, the general kernel: instances <3> and
//   <4> (k = 7 and 9) with the radius a template constant, <0> for any
//   other odd k with the radius at run time.
// Plain version and contract: local_flow_core in
// farms_tpu_torch/ops/dense_flow.py.
//
// Per pixel: the causal view of each (2R+1)^2 support cell folded over the
// stamp1 snapshot chain (newest value not in the center's future, ordered
// through the uint32 difference), the 9 candidate k x k windows scored by
// mean time difference with the first in-bounds minimum winning in scan
// order, the winner's 3x3 normal equations solved by adjugate with
// det >= det_threshold, and the winner's inlier count
// (|a*u + b*v - yv| < dtdp/2 over eligible cells). Reference:
// computeLocalFlow vFlow.cpp:841-949, computeGrads vFlow.cpp:1214-1381.
// Sums are left folds in the same cell order as the plain version; built
// with -fmad=false the kernels and the plain version agree bitwise on one
// device. Stamp arithmetic is done in uint32 (signed overflow is undefined
// in C++), and stamps pass 2^31 after 35.8 min. Threads run along y, the
// contiguous axis, so staging and output stores coalesce.
//
// What bounds them on the card: per-thread latency, not bytes (one read of
// each surface, five output maps) or arithmetic. A pixel visits 11 k^2
// support cells (9 k^2 for the scores, k^2 each for the winner's sums and
// inliers), but only (2R+1)^2 of them are distinct.
// - The streamed kernels (k = 3, 5) fold each distinct cell once, as the
//   JAX kernel computes each offset's quantities once: the chain (oldest
//   first, then the center in default mode) streams through a ring of
//   NSTAGE shared-memory slots, one surface each, filled by cp.async a few
//   surfaces ahead (zero-filled outside the band, the plain version's
//   pad), and each thread folds every staged surface into one register per
//   off-center offset (24 at k = 3, 80 at k = 5). Then d per offset stays
//   in registers, eligibility and "touched" in two bit masks, and u, v and
//   yv = d * neg_ts are recomputed at use. The winner's cells are picked
//   with unrolled predicated selects on the run-time winner id (indexing a
//   register array with it would send the array to local memory); the
//   bit masks are shifted once to the winner's first cell. Shared memory
//   no longer grows with the chain, so any chain length runs, and small
//   blocks (8 x 32 at k = 3, 4 x 32 at k = 5) put several blocks on every
//   SM.
// - The general kernel (k >= 7) folds each distinct cell once too, but
//   its 168 (k = 7) to 288 (k = 9) folded values per pixel exceed a
//   thread's 255 registers, so they live in shared memory: one 32-bit slot
//   per support offset and thread, the folded stamp itself (d, eligibility
//   and "touched" follow from it and the center stamp at use), laid out
//   [offset][thread] so that a warp's accesses fall in 32 banks. The chain
//   streams through a cp.async ring of two batches of GB surfaces (the
//   next batch in flight while a thread folds this one, one support row of
//   registers at a time, so a slot is read and written once per batch);
//   the center stamp is read once from global memory. The 9 scores are
//   left folds over the slots in row-major cell order, and the winner's
//   cells are read back by run-time offset. Neither the ring nor the slots
//   depend on the chain, so every chain length runs. Blocks are small (4 x
//   32 at k = 7, 2 x 32 at k = 9: two of 107 / 99 KB on an SM, 800 and
//   1600 blocks at 320 x 320), and k = 7 and 9 fold the whole support at
//   once. Past k = 9 (the radius at run time; 4 x 32 threads) the slots
//   of the whole (2R+1)^2 support would crowd the SM, so the support is
//   cut into slabs of rows, as many as let three blocks share an SM
//   (registers allow no more; fewer past k = 57), folded top to bottom,
//   the chain streamed once per slab: the 9 running scores carry across
//   slabs (rows in increasing order keep each left fold's order), and so
//   do the 9 candidates' normal-equation sums, which this instance folds
//   in the same pass (each candidate over its own cells); the inlier
//   count (in any order) takes the slab still held first and refolds
//   another only where a thread of the block needs its rows. Only the
//   winner is solved. The kernel decides its own tile, slabs and shared
//   memory (farms_local_flow_shape reports them).
//
// The halo and tile modes change only addressing, not the work or what
// bounds it: the inputs are bands of `halo` >= R exchanged rows above and
// below the shard's `rows` core rows and, in tile mode, of `col_halo` >= R
// exchanged columns left and right of its `cols` core columns, so staging
// reads band row halo + r and band column col_halo + c, which the tile's
// R-cell halo keeps inside the band (the band already holds zeros past the
// sensor edge, the values the whole-sensor zero fill gives); coordinates
// and the window border checks use the global row row_offset + r and
// column col_offset + c against the semantic sensor W x H, never the band
// or the array; band_cols is the stride. On the same values a band's or a
// tile's outputs equal the whole-sensor kernel's cells bitwise. Without a
// halo an axis is the array's: halo = row_offset = 0 and rows = W, or
// col_halo = col_offset = 0 and cols = band_cols = the array height.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int TY = 32;              // tile columns (y, contiguous; one warp)
constexpr int NSTAGE = 4;           // ring slots of the streamed kernels
constexpr size_t SMEM_MAX = 232448; // shared memory a block may use (227 KB)
// the most a block may use where two or three share an SM: 228 KB an SM,
// 1 KB of it reserved for each block
constexpr size_t SMEM_HALF = 233472 / 2 - 1024;
constexpr size_t SMEM_THIRD = 233472 / 3 - 1024;

__device__ __forceinline__ float pinf() { return __int_as_float(0x7f800000); }

// ---------------------------------------------------------------------
// The streamed kernels (k = 3 and 5)
// ---------------------------------------------------------------------

// Geometry of the k = 2F + 1 instance.
template <int F>
struct Streamed {
  static constexpr int K = 2 * F + 1;         // window side
  static constexpr int R = 2 * F;             // support radius
  static constexpr int SIDE = 2 * R + 1;      // support side
  static constexpr int NC = SIDE * SIDE;      // support cells
  static constexpr int MID = NC / 2;          // the pixel's own cell
  static constexpr int ROWS = F == 1 ? 8 : 4; // tile rows
  static constexpr int SY = TY + 2 * R;
  static constexpr int PLANE = (ROWS + 2 * R) * SY;
};

// Start copying the tile plus its R-row, R-column halo of one surface
// (a [band_rows, band_cols] band; row0, col0: the band row and column of
// the slot's first cell) into a ring slot, zero outside the band, and
// commit the copies as one group (an empty group where src is null, so
// that every thread counts the same groups).
template <int F>
__device__ __forceinline__ void stage(uint32_t* dst, const int32_t* src,
                                      int row0, int col0, int tid,
                                      int band_rows, int band_cols) {
  using G = Streamed<F>;
  if (src != nullptr) {
    for (int i = tid; i < G::PLANE; i += G::ROWS * TY) {
      const int gb = row0 + i / G::SY;       // band row
      const int gy = col0 + i % G::SY;       // band column
      const bool in =
          gb >= 0 && gb < band_rows && gy >= 0 && gy < band_cols;
      farms::cp_async4(dst + i, in ? src + (size_t)gb * band_cols + gy : src,
                       in ? 4 : 0);
    }
  }
  farms::commit();
}

// Bits s.. of a 128-bit mask m[1]:m[0], for 0 <= s < 64.
__device__ __forceinline__ uint64_t shr(const uint64_t (&m)[2], int s) {
  return s == 0 ? m[0] : (m[0] >> s) | (m[1] << (64 - s));
}

template <int F>
__global__ void __launch_bounds__(Streamed<F>::ROWS * TY)
local_flow_streamed(const int32_t* __restrict__ chain, int S, int nfold,
                    const int32_t* __restrict__ center, int band_rows,
                    int rows, int halo, int row_offset, int band_cols,
                    int cols, int col_halo, int col_offset, int W, int H,
                    int min_evts, float det_threshold, float neg_ts,
                    int32_t* __restrict__ accept_out,
                    float* __restrict__ a_out, float* __restrict__ b_out,
                    float* __restrict__ dtdp_out,
                    int32_t* __restrict__ cand_out) {
  using G = Streamed<F>;
  constexpr int K = G::K, R = G::R, SIDE = G::SIDE, NC = G::NC;
  constexpr int MID = G::MID;
  static_assert(NC <= 128 && (2 * F) * SIDE + 2 * F < 64,
                "the masks hold 128 offsets, a shifted window 64");
  __shared__ uint32_t ring[NSTAGE][G::PLANE];

  const int r0 = blockIdx.y * G::ROWS;  // first core row of the tile
  const int y0 = blockIdx.x * TY;
  const int tid = threadIdx.y * TY + threadIdx.x;
  const int row0 = halo + r0 - R;       // band row of the slot's first row
  const int col0 = col_halo + y0 - R;   // and its band column
  const size_t XH = (size_t)band_rows * band_cols;
  const int r = r0 + threadIdx.y;
  const int c = y0 + threadIdx.x;       // core column
  const bool live = r < rows && c < cols;
  const uint32_t tc =
      live ? (uint32_t)center[(size_t)(halo + r) * band_cols + col_halo + c]
           : 0u;

  // ---- the causal fold: surface s is the chain's s-th (oldest first)
  // or, at s == S in default mode, the center ----
  auto surface = [&](int s) -> const int32_t* {
    return s >= nfold ? nullptr : s < S ? chain + (size_t)s * XH : center;
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s)
    stage<F>(ring[s], surface(s), row0, col0, tid, band_rows, band_cols);
  uint32_t vis[NC];
  for (int s = 0; s < nfold; ++s) {
    farms::wait<NSTAGE - 2>();  // this thread's copies of surface s
    __syncthreads();  // everyone's; and slot (s - 1) % NSTAGE is read
    const int next = s + NSTAGE - 1;
    stage<F>(ring[next % NSTAGE], surface(next), row0, col0, tid, band_rows,
             band_cols);
    const uint32_t* t =
        ring[s % NSTAGE] + (threadIdx.y + R) * G::SY + threadIdx.x + R;
    if (s == 0) {
#pragma unroll
      for (int o = 0; o < NC; ++o)
        if (o != MID) vis[o] = t[(o / SIDE - R) * G::SY + o % SIDE - R];
    } else {
#pragma unroll
      for (int o = 0; o < NC; ++o) {
        if (o == MID) continue;
        const uint32_t sh = t[(o / SIDE - R) * G::SY + o % SIDE - R];
        if ((int32_t)(tc - sh) >= 0) vis[o] = sh;  // not in the future
      }
    }
  }

  // ---- each offset's quantities, once: d in registers, eligibility and
  // "touched" as bits (u = v = 0 at the pixel's own cell, as if touched)
  float d[NC];
  uint64_t eli[2] = {0u, 0u}, tch[2] = {0u, 0u};
#pragma unroll
  for (int o = 0; o < NC; ++o) {
    bool e, t;
    if (o == MID) {
      d[o] = 0.0f;
      e = (tc != 0u) && (tc != 1u);  // stamp1 not in {0, 1}
      t = true;
    } else {
      uint32_t v = vis[o];
      t = v != 0u;                   // stamp1: 0 <=> never written
      if (v == 0u) v = 1u;           // Event(0,0,0,0) initializer
      float dd = (float)(int32_t)(tc - v);
      if (dd < 0.0f) dd = dd + 4294967296.0f;  // mod-2^32 future penalty
      d[o] = dd;
      e = (v != 1u) && (dd < 2147483648.0f);
    }
    eli[o / 64] |= (uint64_t)e << (o % 64);
    tch[o / 64] |= (uint64_t)t << (o % 64);
  }

  const int px = row_offset + r;  // global row
  const int py = col_offset + c;  // global column
  const float pxf = (float)px;
  const float pyf = (float)py;
  const float n = (float)(K * K);

  // ---- scores of the 9 candidate windows, first strict minimum ----
  float best = pinf();
  int bc = 0;
#pragma unroll
  for (int ci = 0; ci < 9; ++ci) {
    const int a = (ci / 3 - 1) * F;
    const int b = (ci % 3 - 1) * F;
    float ssum = 0.0f;
#pragma unroll
    for (int wx = -F; wx <= F; ++wx) {
#pragma unroll
      for (int wy = -F; wy <= F; ++wy) {
        const float v = d[(a + wx + R) * SIDE + b + wy + R];
        ssum = (wx == -F && wy == -F) ? v : ssum + v;
      }
    }
    const float score = ssum / n;
    // full-window in-bounds requirement (vFlow.cpp:889)
    const bool vm = px + (a - F) >= 0 && px + (a + F) <= W - 1 &&
                    py + (b - F) >= 0 && py + (b + F) <= H - 1;
    const float sm = vm ? score : pinf();
    if (sm < best) {
      best = sm;
      bc = ci;
    }
  }
  const bool local_ok = best < pinf();

  // ---- the winner's normal equations (candidate 0 if none fits); its
  // cells' bits sit at the bit of its first cell plus a constant ----
  const int wa = (bc / 3 - 1) * F;
  const int wb = (bc % 3 - 1) * F;
  const int first = (wa - F + R) * SIDE + wb - F + R;
  const uint64_t we = shr(eli, first);
  const uint64_t wt = shr(tch, first);
  float dw[K * K];
  float su = 0.f, sv = 0.f, suu = 0.f, svv = 0.f, suv = 0.f;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int wx = -F; wx <= F; ++wx) {
#pragma unroll
    for (int wy = -F; wy <= F; ++wy) {
      const int cw = (wx + F) * K + wy + F;
      float dc = d[(wx - F + R) * SIDE + wy - F + R];  // candidate 0
#pragma unroll
      for (int ci = 1; ci < 9; ++ci) {
        const int a = (ci / 3 - 1) * F;
        const int b = (ci % 3 - 1) * F;
        if (bc == ci) dc = d[(a + wx + R) * SIDE + b + wy + R];
      }
      dw[cw] = dc;
      const bool t = (wt >> ((wx + F) * SIDE + wy + F)) & 1u;
      const float u = t ? (float)(wa + wx) : -pxf;  // untouched: 0 - p
      const float v = t ? (float)(wb + wy) : -pyf;
      const float yv = dc * neg_ts;
      if (cw == 0) {
        su = u;
        sv = v;
        suu = u * u;
        svv = v * v;
        suv = u * v;
        b0 = u * yv;
        b1 = v * yv;
        b2 = yv;
      } else {
        su = su + u;
        sv = sv + v;
        suu = suu + u * u;
        svv = svv + v * v;
        suv = suv + u * v;
        b0 = b0 + u * yv;
        b1 = b1 + v * yv;
        b2 = b2 + yv;
      }
    }
  }

  // ---- closed-form 3x3 adjugate solve (vFlow.cpp:1307-1341) ----
  const float det = suu * (svv * n - sv * sv) - suv * (suv * n - sv * su) +
                    su * (suv * sv - svv * su);
  const bool det_ok = det >= det_threshold;  // vFlow.cpp:1323
  const float safe = det_ok ? det : 1.0f;
  const float adj00 = svv * n - sv * sv;
  const float adj01 = su * sv - suv * n;
  const float adj02 = suv * sv - svv * su;
  const float adj11 = suu * n - su * su;
  const float adj12 = su * suv - suu * sv;
  const float ac = (adj00 * b0 + adj01 * b1 + adj02 * b2) / safe;
  const float bcf = (adj01 * b0 + adj11 * b1 + adj12 * b2) / safe;
  const float dtdp = sqrtf(ac * ac + bcf * bcf);

  // ---- inlier count with the winner's plane (vFlow.cpp:1360-1366) ----
  const float half = dtdp * 0.5f;
  int inl = 0;
#pragma unroll
  for (int wx = -F; wx <= F; ++wx) {
#pragma unroll
    for (int wy = -F; wy <= F; ++wy) {
      const int bit = (wx + F) * SIDE + wy + F;
      const bool t = (wt >> bit) & 1u;
      const bool e = (we >> bit) & 1u;
      const float u = t ? (float)(wa + wx) : -pxf;
      const float v = t ? (float)(wb + wy) : -pyf;
      const float yv = dw[(wx + F) * K + wy + F] * neg_ts;
      inl += (fabsf(ac * u + bcf * v - yv) < half && e) ? 1 : 0;
    }
  }

  if (!live) return;
  const size_t o = (size_t)r * cols + c;
  accept_out[o] = (local_ok && det_ok && inl >= min_evts) ? 1 : 0;
  a_out[o] = ac;
  b_out[o] = bcf;
  dtdp_out[o] = dtdp;
  cand_out[o] = local_ok ? bc : -1;
}

template <int F>
int launch_streamed(const void* chain, int S, int fold_center,
                    const void* center, int band_rows, int rows, int halo,
                    int row_offset, int band_cols, int cols, int col_halo,
                    int col_offset, int W, int H, int min_evts,
                    float det_threshold, float neg_ts, void* accept, void* a,
                    void* b, void* dtdp, void* cand, void* stream) {
  constexpr int ROWS = Streamed<F>::ROWS;
  const dim3 block(TY, ROWS);
  const dim3 grid((cols + TY - 1) / TY, (rows + ROWS - 1) / ROWS);
  local_flow_streamed<F><<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(chain), S, fold_center ? S + 1 : S,
      static_cast<const int32_t*>(center), band_rows, rows, halo, row_offset,
      band_cols, cols, col_halo, col_offset, W, H, min_evts, det_threshold,
      neg_ts,
      static_cast<int32_t*>(accept), static_cast<float*>(a),
      static_cast<float*>(b), static_cast<float*>(dtdp),
      static_cast<int32_t*>(cand));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The general kernel (k >= 7)
// ---------------------------------------------------------------------

constexpr int GB = 4;           // surfaces per batch of the general ring
constexpr int GSLOTS = 2 * GB;  // its ring slots: two batches

// Tile rows of the general kernel's instance of radius F: 4 x 32 threads
// at k = 7 and 2 x 32 at k = 9 (two blocks of 107 / 99 KB share an SM);
// at a run-time radius (F = 0) 4, or 1 past k = 179 (general_layout).
template <int F>
struct General {
  static constexpr int ROWS = F == 4 ? 2 : 4;
  static constexpr int NT = ROWS * TY;
  // columns a thread folds per register chunk: a whole support row where
  // the radius is a template constant
  static constexpr int CH = F ? 4 * F + 1 : 16;
};

// Shared bytes of one block of `rows` tile rows at radius f: the ring
// (GSLOTS surfaces of rows + slab_rows - 1 rows by TY + 2R columns) and
// the slots (slab_rows x (2R + 1) support offsets per thread).
constexpr size_t general_smem(int rows, int f, int slab_rows) {
  return ((size_t)GSLOTS * (rows + slab_rows - 1) * (TY + 4 * f) +
          (size_t)slab_rows * (4 * f + 1) * rows * TY) *
         sizeof(uint32_t);
}
static_assert(general_smem(General<3>::ROWS, 3, 13) <= SMEM_HALF &&
                  general_smem(General<4>::ROWS, 4, 17) <= SMEM_HALF,
              "k = 7 and 9 run in one slab, two blocks to an SM");

// Tile rows and support rows per slab of instance F at radius f: the most
// support rows whose block fits the first of these limits that one row
// fits. k = 7 and 9 take SMEM_HALF (two blocks to an SM, the whole support
// in one slab). A run-time radius takes 4 tile rows and SMEM_THIRD (three
// blocks to an SM, as many as its registers allow), past k = 57 SMEM_HALF,
// past k = 87 all of SMEM_MAX, and past k = 179 one tile row with all of
// it. False where not even that fits.
template <int F>
bool general_layout(int f, int& tile_rows, int& slab_rows) {
  constexpr size_t limits[] = {SMEM_THIRD, SMEM_HALF, SMEM_MAX, SMEM_MAX};
  for (int t = F ? 1 : 0; t < (F ? 2 : 4); ++t) {
    tile_rows = t == 3 ? 1 : General<F>::ROWS;
    for (slab_rows = 4 * f + 1; slab_rows >= 1; --slab_rows)
      if (general_smem(tile_rows, f, slab_rows) <= limits[t]) return true;
  }
  return false;
}

// d, eligibility and "touched" of a support cell
struct Cell {
  float d;
  bool eli, tch;
};

// The 8 sums of a window's normal equations, each a left fold over its
// cells in row-major order (the first cell starts them).
struct Normal {
  float su, sv, suu, svv, suv, b0, b1, b2;
  __device__ __forceinline__ void add(bool first, float u, float v,
                                      float yv) {
    if (first) {
      su = u;
      sv = v;
      suu = u * u;
      svv = v * v;
      suv = u * v;
      b0 = u * yv;
      b1 = v * yv;
      b2 = yv;
    } else {
      su = su + u;
      sv = sv + v;
      suu = suu + u * u;
      svv = svv + v * v;
      suv = suv + u * v;
      b0 = b0 + u * yv;
      b1 = b1 + v * yv;
      b2 = b2 + yv;
    }
  }
};

// The off-center cell whose folded stamp1 value is vis, seen from center
// stamp tc.
__device__ __forceinline__ Cell cell_of(uint32_t vis, uint32_t tc) {
  Cell c;
  c.tch = vis != 0u;                     // stamp1: 0 <=> never written
  if (vis == 0u) vis = 1u;               // Event(0,0,0,0) initializer
  float d = (float)(int32_t)(tc - vis);
  if (d < 0.0f) d = d + 4294967296.0f;   // mod-2^32 future penalty
  c.d = d;
  c.eli = (vis != 1u) && (d < 2147483648.0f);
  return c;
}

// Radius F (0: f_run at run time, with blockDim.y tile rows). The
// support's 2R + 1 rows are cut into slabs of slab_rows rows (one slab,
// all rows, where F is a template constant); the chain streams once per
// slab, and once more for each other slab that holds rows of a winner of
// the block.
template <int F>
__global__ void __launch_bounds__(General<F>::NT)
local_flow_general(const int32_t* __restrict__ chain, int S, int nfold,
                   const int32_t* __restrict__ center, int band_rows,
                   int rows, int halo, int row_offset, int band_cols,
                   int cols, int col_halo, int col_offset, int W, int H,
                   int f_run, int slab_rows, int min_evts,
                   float det_threshold, float neg_ts,
                   int32_t* __restrict__ accept_out,
                   float* __restrict__ a_out, float* __restrict__ b_out,
                   float* __restrict__ dtdp_out,
                   int32_t* __restrict__ cand_out) {
  using G = General<F>;
  constexpr int CH = G::CH;
  const int ROWS = F ? G::ROWS : (int)blockDim.y;
  const int NT = ROWS * TY;
  const int f = F ? F : f_run;
  const int R = 2 * f;
  const int SIDE = 2 * R + 1;
  const int SR = F ? SIDE : slab_rows;       // support rows per slab
  const int nslab = F ? 1 : (SIDE + SR - 1) / SR;
  const int SY = TY + 2 * R;
  const int PLANE = (ROWS + SR - 1) * SY;    // one ring slot
  extern __shared__ uint32_t smem[];
  uint32_t* ring = smem;                     // GSLOTS slots
  // the slots, [SR * SIDE][NT]: one folded stamp per support offset and
  // thread, a warp's 32 threads in 32 banks; this thread's at stride NT
  uint32_t* mine = smem + GSLOTS * PLANE + threadIdx.y * TY + threadIdx.x;

  const int r0 = blockIdx.y * ROWS;  // first core row of the tile
  const int y0 = blockIdx.x * TY;
  const int tid = threadIdx.y * TY + threadIdx.x;
  const size_t XH = (size_t)band_rows * band_cols;
  const int r = r0 + threadIdx.y;
  const int c = y0 + threadIdx.x;  // core column
  const bool live = r < rows && c < cols;
  const uint32_t tc =
      live ? (uint32_t)center[(size_t)(halo + r) * band_cols + col_halo + c]
           : 0u;

  // Start copying support rows [x_lo, x_hi) of the tile of surface s (the
  // chain's s-th, oldest first, or at s == S the center) into ring slot
  // i, zero outside the band.
  auto stage = [&](int i, int s, int x_lo, int x_hi) {
    const int32_t* src = s < S ? chain + (size_t)s * XH : center;
    uint32_t* dst = ring + i * PLANE;
    const int row0 = halo + r0 + x_lo;       // band row of the slot's row 0
    const int col0 = col_halo + y0 - R;      // and its band column
    const int n = (ROWS + x_hi - x_lo - 1) * SY;
    for (int e = tid; e < n; e += NT) {
      const int gb = row0 + e / SY;
      const int gy = col0 + e % SY;
      const bool in =
          gb >= 0 && gb < band_rows && gy >= 0 && gy < band_cols;
      farms::cp_async4(dst + e, in ? src + (size_t)gb * band_cols + gy : src,
                       in ? 4 : 0);
    }
  };

  // The causal fold of support rows [x_lo, x_hi) into the slots: the
  // nfold surfaces stream through the ring in batches of GB, the next
  // batch in flight while this one folds.
  auto fold = [&](int x_lo, int x_hi) {
    const int nbatch = (nfold + GB - 1) / GB;
    __syncthreads();  // the ring's last readers are done
    for (int g = 0; g < GB && g < nfold; ++g) stage(g, g, x_lo, x_hi);
    farms::commit();
    for (int bt = 0; bt < nbatch; ++bt) {
      farms::wait<0>();  // this thread's copies of batch bt
      __syncthreads();   // everyone's; and the other half is read
      const int next = (bt + 1) * GB;
      if (next < nfold) {
        for (int g = 0; g < GB && next + g < nfold; ++g)
          stage(((bt + 1) & 1) * GB + g, next + g, x_lo, x_hi);
        farms::commit();
      }
      const int ng = min(GB, nfold - bt * GB);
      const uint32_t* half =
          ring + (bt & 1) * GB * PLANE + threadIdx.y * SY + threadIdx.x;
      for (int ox = x_lo; ox < x_hi; ++ox) {
        const uint32_t* t = half + (ox - x_lo) * SY;  // at offset oy = -R
        uint32_t* slot = mine + (ox - x_lo) * SIDE * NT;
        for (int j0 = 0; j0 < SIDE; j0 += CH) {
          uint32_t v[CH];
#pragma unroll
          for (int j = 0; j < CH; ++j)
            if (F || j0 + j < SIDE)
              v[j] = bt == 0 ? t[j0 + j] : slot[(j0 + j) * NT];
          for (int g = bt == 0 ? 1 : 0; g < ng; ++g) {
#pragma unroll
            for (int j = 0; j < CH; ++j) {
              if (F || j0 + j < SIDE) {
                const uint32_t sh = t[g * PLANE + j0 + j];
                if ((int32_t)(tc - sh) >= 0) v[j] = sh;  // not in the future
              }
            }
          }
#pragma unroll
          for (int j = 0; j < CH; ++j)
            if (F || j0 + j < SIDE) slot[(j0 + j) * NT] = v[j];
        }
      }
    }
  };

  // Support cell (ox, oy), held by the slab whose first row is x_lo.
  auto at = [&](int x_lo, int ox, int oy) -> Cell {
    if (ox == 0 && oy == 0)   // stamp1 not in {0, 1}; u = v = 0
      return Cell{0.0f, (tc != 0u) && (tc != 1u), true};
    return cell_of(mine[((ox - x_lo) * SIDE + oy + R) * NT], tc);
  };
  auto slab = [&](int j, int& x_lo, int& x_hi) {
    x_lo = -R + j * SR;
    x_hi = min(x_lo + SR, R + 1);
  };

  const int px = row_offset + r;  // global row
  const int py = col_offset + c;  // global column
  const float pxf = (float)px;
  const float pyf = (float)py;
  const float n = (float)((2 * f + 1) * (2 * f + 1));

  // ---- scores of the 9 candidate windows: each a left fold in its
  // row-major cell order, which the slabs' increasing rows keep. At k = 7
  // the support's rows unroll, so each cell is loaded once and which
  // candidates take it is known at compile time; at k = 9 its columns
  // unroll (its rows, and the winner's rows below, stay rolled: unrolled,
  // the compiler hoists a whole support's or window's loads and k = 9
  // spills at 255 registers). At a run-time radius each candidate visits
  // its own cells of the slab, and folds its normal-equation sums in the
  // same order, so that no slab is streamed again for them ----
  float ssum[9];
  Normal cand[9];  // at a run-time radius only
  for (int j = 0; j < nslab; ++j) {
    int x_lo, x_hi;
    slab(j, x_lo, x_hi);
    fold(x_lo, x_hi);
    if (F) {
#pragma unroll(F == 3 ? 13 : 1)
      for (int ox = x_lo; ox < x_hi; ++ox) {
#pragma unroll
        for (int oy = -R; oy <= R; ++oy) {
          const float d = at(x_lo, ox, oy).d;
#pragma unroll
          for (int ci = 0; ci < 9; ++ci) {
            const int wx = ox - (ci / 3 - 1) * f;
            const int wy = oy - (ci % 3 - 1) * f;
            if (wx >= -f && wx <= f && wy >= -f && wy <= f)
              ssum[ci] = (wx == -f && wy == -f) ? d : ssum[ci] + d;
          }
        }
      }
    } else {
#pragma unroll
      for (int ci = 0; ci < 9; ++ci) {
        const int a = (ci / 3 - 1) * f;
        const int b = (ci % 3 - 1) * f;
        const int hi = min(x_hi, a + f + 1);
        for (int ox = max(x_lo, a - f); ox < hi; ++ox) {
          for (int oy = b - f; oy <= b + f; ++oy) {
            const Cell cl = at(x_lo, ox, oy);
            const bool first = ox == a - f && oy == b - f;
            ssum[ci] = first ? cl.d : ssum[ci] + cl.d;
            cand[ci].add(first, cl.tch ? (float)ox : -pxf,  // untouched: 0 - p
                         cl.tch ? (float)oy : -pyf, cl.d * neg_ts);
          }
        }
      }
    }
  }
  // first strict minimum
  float best = pinf();
  int bc = 0;
#pragma unroll
  for (int ci = 0; ci < 9; ++ci) {
    const int a = (ci / 3 - 1) * f;
    const int b = (ci % 3 - 1) * f;
    const float score = ssum[ci] / n;
    // full-window in-bounds requirement (vFlow.cpp:889)
    const bool vm = px + (a - f) >= 0 && px + (a + f) <= W - 1 &&
                    py + (b - f) >= 0 && py + (b + f) <= H - 1;
    const float sm = vm ? score : pinf();
    if (sm < best) {
      best = sm;
      bc = ci;
    }
  }
  const bool local_ok = best < pinf();

  // The winner's cells (candidate 0 if none fits) in support rows
  // [x_lo, x_hi), the slab the slots hold, in row-major order:
  // visit(first, u, v, yv, eli) for each, read by run-time offset.
  const int wa = (bc / 3 - 1) * f;
  const int wb = (bc % 3 - 1) * f;
  auto winner = [&](int x_lo, int x_hi, auto&& visit) {
#pragma unroll 1
    for (int wx = -f; wx <= f; ++wx) {
      const int ox = wa + wx;
      if (nslab > 1 && (ox < x_lo || ox >= x_hi)) continue;
#pragma unroll
      for (int wy = -f; wy <= f; ++wy) {
        const Cell cl = at(x_lo, ox, wb + wy);
        const float u = cl.tch ? (float)ox : -pxf;  // untouched: 0 - p
        const float v = cl.tch ? (float)(wb + wy) : -pyf;
        visit(wx == -f && wy == -f, u, v, cl.d * neg_ts, cl.eli);
      }
    }
  };

  // ---- the winner's normal equations: folded with the scores at a
  // run-time radius, else from its cells in the one slab ----
  Normal eq = {};
  if (F == 0) {
    eq = cand[0];
#pragma unroll
    for (int ci = 1; ci < 9; ++ci)
      if (bc == ci) eq = cand[ci];
  } else {
    winner(-R, R + 1, [&](bool first, float u, float v, float yv, bool) {
      eq.add(first, u, v, yv);
    });
  }
  const float su = eq.su, sv = eq.sv, suu = eq.suu, svv = eq.svv;
  const float suv = eq.suv, b0 = eq.b0, b1 = eq.b1, b2 = eq.b2;

  // ---- closed-form 3x3 adjugate solve (vFlow.cpp:1307-1341) ----
  const float det = suu * (svv * n - sv * sv) - suv * (suv * n - sv * su) +
                    su * (suv * sv - svv * su);
  const bool det_ok = det >= det_threshold;  // vFlow.cpp:1323
  const float safe = det_ok ? det : 1.0f;
  const float adj00 = svv * n - sv * sv;
  const float adj01 = su * sv - suv * n;
  const float adj02 = suv * sv - svv * su;
  const float adj11 = suu * n - su * su;
  const float adj12 = su * suv - suu * sv;
  const float ac = (adj00 * b0 + adj01 * b1 + adj02 * b2) / safe;
  const float bcf = (adj01 * b0 + adj11 * b1 + adj12 * b2) / safe;
  const float dtdp = sqrtf(ac * ac + bcf * bcf);

  // ---- inlier count with the winner's plane (vFlow.cpp:1360-1366); hits
  // add up in any order, so the slab the slots still hold (the last) comes
  // first, and another is refolded only where a thread of the block has
  // winner rows in it ----
  const float half = dtdp * 0.5f;
  int inl = 0;
  for (int i = 0; i < nslab; ++i) {
    const int j = (i + nslab - 1) % nslab;
    int x_lo, x_hi;
    slab(j, x_lo, x_hi);
    if (i > 0) {
      if (!__syncthreads_or(wa - f < x_hi && wa + f >= x_lo)) continue;
      fold(x_lo, x_hi);
    }
    winner(x_lo, x_hi, [&](bool, float u, float v, float yv, bool eli) {
      inl += (fabsf(ac * u + bcf * v - yv) < half && eli) ? 1 : 0;
    });
  }

  if (!live) return;
  const size_t o = (size_t)r * cols + c;
  accept_out[o] = (local_ok && det_ok && inl >= min_evts) ? 1 : 0;
  a_out[o] = ac;
  b_out[o] = bcf;
  dtdp_out[o] = dtdp;
  cand_out[o] = local_ok ? bc : -1;
}

template <int F>
int launch_general(const void* chain, int S, int fold_center,
                   const void* center, int band_rows, int rows, int halo,
                   int row_offset, int band_cols, int cols, int col_halo,
                   int col_offset, int W, int H, int f, int min_evts,
                   float det_threshold, float neg_ts, void* accept, void* a,
                   void* b, void* dtdp, void* cand, void* stream) {
  int tile, slab_rows;
  if (!general_layout<F>(f, tile, slab_rows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = general_smem(tile, f, slab_rows);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_flow_general<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(TY, tile);
  const dim3 grid((cols + TY - 1) / TY, (rows + tile - 1) / tile);
  local_flow_general<F><<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(chain), S, fold_center ? S + 1 : S,
      static_cast<const int32_t*>(center), band_rows, rows, halo, row_offset,
      band_cols, cols, col_halo, col_offset, W, H, f, slab_rows, min_evts,
      det_threshold, neg_ts,
      static_cast<int32_t*>(accept), static_cast<float*>(a),
      static_cast<float*>(b), static_cast<float*>(dtdp),
      static_cast<int32_t*>(cand));
  return (int)cudaGetLastError();
}

// The shape that instance F of the general kernel takes at radius f (see
// farms_local_flow_shape).
template <int F>
int general_shape(int f, int* tile_rows, int* slab_rows, int* shared_bytes) {
  if (!general_layout<F>(f, *tile_rows, *slab_rows))
    return (int)cudaErrorInvalidValue;
  *shared_bytes = (int)general_smem(*tile_rows, f, *slab_rows);
  return 0;
}

template <int F>
int streamed_shape(int* tile_rows, int* slab_rows, int* shared_bytes) {
  *tile_rows = Streamed<F>::ROWS;
  *slab_rows = 0;
  *shared_bytes = (int)(NSTAGE * Streamed<F>::PLANE * sizeof(uint32_t));
  return 0;
}

}  // namespace

// C entry point. chain: int32 [S, band_rows, band_cols]; center:
// [band_rows, band_cols]; the outputs: [rows, cols]; all contiguous on the
// current device, with band_rows = rows + 2 * halo and band_cols = cols +
// 2 * col_halo (each halo 0, or at least the support radius 2F), and
// row_offset, col_offset the band's first core row and column in the
// sensor; W x H is the semantic sensor of the border checks. fold_center 0
// selects correction mode. The kernel picks its instance, tile and slabs
// from filter_size alone (farms_local_flow_shape); no size depends on S,
// so every chain length runs. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for an even k, k < 3, or inconsistent band
// geometry).
extern "C" int farms_local_flow(const void* chain, int S, int fold_center,
                                const void* center, int band_rows, int rows,
                                int halo, int row_offset, int band_cols,
                                int cols, int col_halo, int col_offset, int W,
                                int H, int filter_size, int min_evts,
                                float det_threshold, float neg_ts,
                                void* accept, void* a, void* b, void* dtdp,
                                void* cand, void* stream) {
  const int F = filter_size / 2;
  if (filter_size < 3 || filter_size % 2 == 0 || S < 1 || rows < 1 ||
      cols < 1 || band_rows != rows + 2 * halo ||
      band_cols != cols + 2 * col_halo || (halo != 0 && halo < 2 * F) ||
      (col_halo != 0 && col_halo < 2 * F))
    return (int)cudaErrorInvalidValue;
  if (filter_size == 3)
    return launch_streamed<1>(chain, S, fold_center, center, band_rows, rows,
                              halo, row_offset, band_cols, cols, col_halo,
                              col_offset, W, H, min_evts, det_threshold,
                              neg_ts, accept, a, b, dtdp, cand, stream);
  if (filter_size == 5)
    return launch_streamed<2>(chain, S, fold_center, center, band_rows, rows,
                              halo, row_offset, band_cols, cols, col_halo,
                              col_offset, W, H, min_evts, det_threshold,
                              neg_ts, accept, a, b, dtdp, cand, stream);
  if (filter_size == 7)
    return launch_general<3>(chain, S, fold_center, center, band_rows, rows,
                             halo, row_offset, band_cols, cols, col_halo,
                             col_offset, W, H, F, min_evts, det_threshold,
                             neg_ts, accept, a, b, dtdp, cand, stream);
  if (filter_size == 9)
    return launch_general<4>(chain, S, fold_center, center, band_rows, rows,
                             halo, row_offset, band_cols, cols, col_halo,
                             col_offset, W, H, F, min_evts, det_threshold,
                             neg_ts, accept, a, b, dtdp, cand, stream);
  return launch_general<0>(chain, S, fold_center, center, band_rows, rows,
                           halo, row_offset, band_cols, cols, col_halo,
                           col_offset, W, H, F, min_evts, det_threshold,
                           neg_ts, accept, a, b, dtdp, cand, stream);
}

// The local-flow kernel's shape at filter_size, as farms_local_flow
// launches it: tile_rows (a block is 32 x tile_rows threads), the general
// kernel's support rows per slab (0 for the streamed k = 3 and 5 kernels)
// and shared_bytes, a block's shared memory (the streamed kernels' static
// ring; the general kernel's dynamic ring and slots). None depends on the
// chain. Returns 0, or cudaErrorInvalidValue for an even k, k < 3, or a k
// whose support row alone does not fit.
extern "C" int farms_local_flow_shape(int filter_size, int* tile_rows,
                                      int* slab_rows, int* shared_bytes) {
  if (filter_size < 3 || filter_size % 2 == 0)
    return (int)cudaErrorInvalidValue;
  switch (filter_size) {
    case 3: return streamed_shape<1>(tile_rows, slab_rows, shared_bytes);
    case 5: return streamed_shape<2>(tile_rows, slab_rows, shared_bytes);
    case 7: return general_shape<3>(3, tile_rows, slab_rows, shared_bytes);
    case 9: return general_shape<4>(4, tile_rows, slab_rows, shared_bytes);
    default:
      return general_shape<0>(filter_size / 2, tile_rows, slab_rows,
                              shared_bytes);
  }
}
