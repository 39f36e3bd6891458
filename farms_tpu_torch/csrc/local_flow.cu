// Local plane-fit flow, one thread per pixel.
//
// Replaces the two Pallas kernels behind local_flow_pallas
// (farms_tpu/ops/pallas/kernels.py:341), in their default, their
// correction (`t_center`, inc_center=False) and their halo (`halo`,
// `row_offset`: a row shard of parallel/halo.py) modes:
// - `_local_flow_kernel_cached` (:434, k = 3 and 5) by the streamed
//   kernels local_flow_streamed<1> and <2>, whose filter radius is a
//   template constant;
// - `_local_flow_kernel` (:171, any odd k; the JAX package sends k >= 7
//   there) by local_flow_kernel, the general kernel, whose radius and tile
//   rows come at run time.
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
// - The general kernel (k >= 7) stages its tile plus a 2R halo of every
//   surface in shared memory at once and recomputes each visited cell's
//   quantities from it: unrolling per-offset registers does not scale past
//   k = 5. Its tile has 16 rows, or fewer where the wrapper finds that a
//   long chain or a large k would not fit 227 KB (ops/kernels.py
//   local_flow_tile_rows; 18 surfaces at k = 7 and 16 rows take 89 KB).
//   Only the winner is solved.
//
// The halo mode changes only addressing, not the work or what bounds it:
// the inputs are bands of `halo` >= R exchanged rows above and below the
// shard's `rows` core rows, so staging reads band row halo + r, which the
// tile's R-row halo keeps inside the band (the band already holds zeros
// past the sensor edge, the values the whole-sensor zero fill gives);
// coordinates and the window border checks use the global row
// row_offset + r against the semantic sensor W x H, never the band or the
// array; Ha, the array height, is the stride. On the same values a band's
// outputs equal the whole-sensor kernel's rows bitwise. Without a halo the
// band is the sensor: halo = row_offset = 0, rows = W, Ha = H.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int TX = 16;     // the general kernel's most tile rows (x)
constexpr int TY = 32;     // tile columns (y, contiguous; one warp)
constexpr int NSTAGE = 4;  // ring slots of the streamed kernels

__device__ __forceinline__ float pinf() { return __int_as_float(0x7f800000); }

// ---------------------------------------------------------------------
// The general kernel (k >= 7)
// ---------------------------------------------------------------------

struct Cell {
  float d, u, v, yv;
  bool eli;
};

// Causal-view quantities of support cell (ox, oy) for the thread's pixel.
// `tile` holds S + 1 staged surfaces (chain oldest first, then center),
// each SX x SY; `pos` is the pixel's position in one staged surface. The
// fold runs over the first `nfold` of them: S + 1 (the center folds in) or
// S (correction mode: the chain ends at the post-scatter surface and the
// center plane holds each pixel's own center stamp).
__device__ __forceinline__ Cell cell(const uint32_t* tile, int nfold,
                                     int plane, int sy, int pos, uint32_t tc,
                                     int ox, int oy, float pxf, float pyf,
                                     float neg_ts) {
  Cell c;
  if (ox == 0 && oy == 0) {
    c.d = 0.0f;
    c.eli = (tc != 0u) && (tc != 1u);  // stamp1 not in {0, 1}
    c.u = 0.0f;
    c.v = 0.0f;
  } else {
    const int q = pos + ox * sy + oy;
    uint32_t vis = tile[q];
    for (int s = 1; s < nfold; ++s) {
      const uint32_t sh = tile[s * plane + q];
      if ((int32_t)(tc - sh) >= 0) vis = sh;  // not in the center's future
    }
    const bool tch = vis != 0u;            // stamp1: 0 <=> never written
    if (vis == 0u) vis = 1u;               // Event(0,0,0,0) initializer
    float d = (float)(int32_t)(tc - vis);
    if (d < 0.0f) d = d + 4294967296.0f;   // mod-2^32 future penalty
    c.d = d;
    c.eli = (vis != 1u) && (d < 2147483648.0f);
    c.u = tch ? (float)ox : -pxf;          // untouched: coordinates 0 - p
    c.v = tch ? (float)oy : -pyf;
  }
  c.yv = c.d * neg_ts;
  return c;
}

// Radius F and blockDim.y tile rows, both at run time.
__global__ void __launch_bounds__(TX * TY)
local_flow_kernel(const int32_t* __restrict__ chain, int S, int nfold,
                  const int32_t* __restrict__ center, int band_rows, int rows,
                  int halo, int row_offset, int W, int H, int Ha, int F,
                  int min_evts, float det_threshold, float neg_ts,
                  int32_t* __restrict__ accept_out,
                  float* __restrict__ a_out, float* __restrict__ b_out,
                  float* __restrict__ dtdp_out,
                  int32_t* __restrict__ cand_out) {
  const int tx = (int)blockDim.y;
  const int R = 2 * F;
  const int SX = tx + 2 * R;
  const int SY = TY + 2 * R;
  const int PLANE = SX * SY;
  extern __shared__ uint32_t tile[];

  const int r0 = blockIdx.y * tx;  // first core row of the tile
  const int y0 = blockIdx.x * TY;
  const int tid = threadIdx.y * TY + threadIdx.x;
  const size_t XH = (size_t)band_rows * Ha;

  for (int s = 0; s <= S; ++s) {
    const int32_t* src = s < S ? chain + (size_t)s * XH : center;
    uint32_t* dst = tile + s * PLANE;
    for (int i = tid; i < PLANE; i += tx * TY) {
      const int gb = halo + r0 - R + i / SY;  // band row
      const int gy = y0 - R + i % SY;
      dst[i] = (gb >= 0 && gb < band_rows && gy >= 0 && gy < Ha)
                   ? (uint32_t)src[(size_t)gb * Ha + gy]
                   : 0u;
    }
  }
  __syncthreads();

  const int r = r0 + threadIdx.y;
  const int py = y0 + threadIdx.x;
  if (r >= rows || py >= Ha) return;
  const int px = row_offset + r;  // global row
  const int pos = (threadIdx.y + R) * SY + threadIdx.x + R;
  const uint32_t tc = tile[S * PLANE + pos];
  const float pxf = (float)px;
  const float pyf = (float)py;
  const float n = (float)((2 * F + 1) * (2 * F + 1));

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
        const float d = cell(tile, nfold, PLANE, SY, pos, tc, a + wx, b + wy,
                             pxf, pyf, neg_ts).d;
        ssum = (wx == -F && wy == -F) ? d : ssum + d;
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

  // ---- the winner's normal equations (candidate 0 if none fits) ----
  const int wa = (bc / 3 - 1) * F;
  const int wb = (bc % 3 - 1) * F;
  float su = 0.f, sv = 0.f, suu = 0.f, svv = 0.f, suv = 0.f;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int wx = -F; wx <= F; ++wx) {
#pragma unroll
    for (int wy = -F; wy <= F; ++wy) {
      const Cell c = cell(tile, nfold, PLANE, SY, pos, tc, wa + wx, wb + wy,
                          pxf, pyf, neg_ts);
      if (wx == -F && wy == -F) {
        su = c.u;
        sv = c.v;
        suu = c.u * c.u;
        svv = c.v * c.v;
        suv = c.u * c.v;
        b0 = c.u * c.yv;
        b1 = c.v * c.yv;
        b2 = c.yv;
      } else {
        su = su + c.u;
        sv = sv + c.v;
        suu = suu + c.u * c.u;
        svv = svv + c.v * c.v;
        suv = suv + c.u * c.v;
        b0 = b0 + c.u * c.yv;
        b1 = b1 + c.v * c.yv;
        b2 = b2 + c.yv;
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
      const Cell c = cell(tile, nfold, PLANE, SY, pos, tc, wa + wx, wb + wy,
                          pxf, pyf, neg_ts);
      inl += (fabsf(ac * c.u + bcf * c.v - c.yv) < half && c.eli) ? 1 : 0;
    }
  }

  const size_t o = (size_t)r * Ha + py;
  accept_out[o] = (local_ok && det_ok && inl >= min_evts) ? 1 : 0;
  a_out[o] = ac;
  b_out[o] = bcf;
  dtdp_out[o] = dtdp;
  cand_out[o] = local_ok ? bc : -1;
}

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
// (a [band_rows, Ha] band) into a ring slot, zero outside the band, and
// commit the copies as one group (an empty group where src is null, so
// that every thread counts the same groups).
template <int F>
__device__ __forceinline__ void stage(uint32_t* dst, const int32_t* src,
                                      int row0, int y0, int tid,
                                      int band_rows, int Ha) {
  using G = Streamed<F>;
  if (src != nullptr) {
    for (int i = tid; i < G::PLANE; i += G::ROWS * TY) {
      const int gb = row0 + i / G::SY;       // band row
      const int gy = y0 - G::R + i % G::SY;
      const bool in = gb >= 0 && gb < band_rows && gy >= 0 && gy < Ha;
      farms::cp_async4(dst + i, in ? src + (size_t)gb * Ha + gy : src,
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
                    int rows, int halo, int row_offset, int W, int H, int Ha,
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
  const size_t XH = (size_t)band_rows * Ha;
  const int r = r0 + threadIdx.y;
  const int py = y0 + threadIdx.x;
  const bool live = r < rows && py < Ha;
  const uint32_t tc =
      live ? (uint32_t)center[(size_t)(halo + r) * Ha + py] : 0u;

  // ---- the causal fold: surface s is the chain's s-th (oldest first)
  // or, at s == S in default mode, the center ----
  auto surface = [&](int s) -> const int32_t* {
    return s >= nfold ? nullptr : s < S ? chain + (size_t)s * XH : center;
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s)
    stage<F>(ring[s], surface(s), row0, y0, tid, band_rows, Ha);
  uint32_t vis[NC];
  for (int s = 0; s < nfold; ++s) {
    farms::wait<NSTAGE - 2>();  // this thread's copies of surface s
    __syncthreads();  // everyone's; and slot (s - 1) % NSTAGE is read
    const int next = s + NSTAGE - 1;
    stage<F>(ring[next % NSTAGE], surface(next), row0, y0, tid, band_rows,
             Ha);
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
      const int c = (wx + F) * K + wy + F;
      float dc = d[(wx - F + R) * SIDE + wy - F + R];  // candidate 0
#pragma unroll
      for (int ci = 1; ci < 9; ++ci) {
        const int a = (ci / 3 - 1) * F;
        const int b = (ci % 3 - 1) * F;
        if (bc == ci) dc = d[(a + wx + R) * SIDE + b + wy + R];
      }
      dw[c] = dc;
      const bool t = (wt >> ((wx + F) * SIDE + wy + F)) & 1u;
      const float u = t ? (float)(wa + wx) : -pxf;  // untouched: 0 - p
      const float v = t ? (float)(wb + wy) : -pyf;
      const float yv = dc * neg_ts;
      if (c == 0) {
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
  const size_t o = (size_t)r * Ha + py;
  accept_out[o] = (local_ok && det_ok && inl >= min_evts) ? 1 : 0;
  a_out[o] = ac;
  b_out[o] = bcf;
  dtdp_out[o] = dtdp;
  cand_out[o] = local_ok ? bc : -1;
}

template <int F>
int launch_streamed(const void* chain, int S, int fold_center,
                    const void* center, int band_rows, int rows, int halo,
                    int row_offset, int W, int H, int Ha, int min_evts,
                    float det_threshold, float neg_ts, void* accept, void* a,
                    void* b, void* dtdp, void* cand, void* stream) {
  constexpr int ROWS = Streamed<F>::ROWS;
  const dim3 block(TY, ROWS);
  const dim3 grid((Ha + TY - 1) / TY, (rows + ROWS - 1) / ROWS);
  local_flow_streamed<F><<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(chain), S, fold_center ? S + 1 : S,
      static_cast<const int32_t*>(center), band_rows, rows, halo, row_offset,
      W, H, Ha, min_evts, det_threshold, neg_ts,
      static_cast<int32_t*>(accept), static_cast<float*>(a),
      static_cast<float*>(b), static_cast<float*>(dtdp),
      static_cast<int32_t*>(cand));
  return (int)cudaGetLastError();
}

int launch_general(const void* chain, int S, int fold_center,
                   const void* center, int band_rows, int rows, int halo,
                   int row_offset, int W, int H, int Ha, int F, int tile_rows,
                   int min_evts, float det_threshold, float neg_ts,
                   void* accept, void* a, void* b, void* dtdp, void* cand,
                   void* stream) {
  const int R = 2 * F;
  const size_t smem = (size_t)(S + 1) * (tile_rows + 2 * R) * (TY + 2 * R) *
                      sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_flow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(TY, tile_rows);
  const dim3 grid((Ha + TY - 1) / TY, (rows + tile_rows - 1) / tile_rows);
  local_flow_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(chain), S, fold_center ? S + 1 : S,
      static_cast<const int32_t*>(center), band_rows, rows, halo, row_offset,
      W, H, Ha, F, min_evts, det_threshold, neg_ts,
      static_cast<int32_t*>(accept), static_cast<float*>(a),
      static_cast<float*>(b), static_cast<float*>(dtdp),
      static_cast<int32_t*>(cand));
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. chain: int32 [S, band_rows, Ha]; center: [band_rows, Ha];
// the outputs: [rows, Ha]; all contiguous on the current device, with
// band_rows = rows + 2 * halo (halo 0, or at least the support radius 2F)
// and row_offset the band's first core row in the sensor; W x H is the
// semantic sensor of the border checks. fold_center 0 selects correction
// mode. k = 3 and 5 run their streamed instances (any S; their tile rows
// are fixed and tile_rows is not read); any other odd k runs the general
// kernel with tile_rows in 1..16, the wrapper's choice, so that
// (S + 1) * (tile_rows + 2R) * (32 + 2R) * 4 bytes fit shared memory.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for an even k,
// k < 3, tile_rows out of range or inconsistent band geometry).
extern "C" int farms_local_flow(const void* chain, int S, int fold_center,
                                const void* center, int band_rows, int rows,
                                int halo, int row_offset, int W, int H,
                                int Ha, int filter_size, int tile_rows,
                                int min_evts, float det_threshold,
                                float neg_ts, void* accept, void* a, void* b,
                                void* dtdp, void* cand, void* stream) {
  const int F = filter_size / 2;
  if (filter_size < 3 || filter_size % 2 == 0 || S < 1 || rows < 1 ||
      Ha < 1 || band_rows != rows + 2 * halo || (halo != 0 && halo < 2 * F))
    return (int)cudaErrorInvalidValue;
  if (filter_size == 3)
    return launch_streamed<1>(chain, S, fold_center, center, band_rows, rows,
                              halo, row_offset, W, H, Ha, min_evts,
                              det_threshold, neg_ts, accept, a, b, dtdp,
                              cand, stream);
  if (filter_size == 5)
    return launch_streamed<2>(chain, S, fold_center, center, band_rows, rows,
                              halo, row_offset, W, H, Ha, min_evts,
                              det_threshold, neg_ts, accept, a, b, dtdp,
                              cand, stream);
  if (tile_rows < 1 || tile_rows > TX) return (int)cudaErrorInvalidValue;
  return launch_general(chain, S, fold_center, center, band_rows, rows, halo,
                        row_offset, W, H, Ha, F, tile_rows, min_evts,
                        det_threshold, neg_ts, accept, a, b, dtdp, cand,
                        stream);
}
