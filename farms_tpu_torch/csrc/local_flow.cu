// Local plane-fit flow, one thread per pixel.
//
// Replaces the Pallas kernel `_local_flow_kernel_cached`
// (farms_tpu/ops/pallas/kernels.py:434, called from local_flow_pallas
// :341) for filter sizes k = 3 and k = 5, one template instance each.
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
//
// What bounds it on the card: arithmetic and shared-memory reads. Each
// pixel revisits its support cells ~3 k^2 times (scores, winner sums,
// inliers); the device-memory traffic is one read of each surface plus
// five output maps. So the block stages its tile plus a 2R halo of every
// surface in shared memory once (zero outside the sensor, the pad the
// plain version uses), and each visit recomputes the cell's quantities
// from shared memory instead of caching per-offset maps in registers.
// Threads run along y, the contiguous axis, so staging and output stores
// coalesce. Only the winner is solved. Sums are left folds in the same
// cell order as the plain version; built with -fmad=false the two agree
// bitwise on one device. Stamp arithmetic is done in uint32 (signed
// overflow is undefined in C++), and stamps pass 2^31 after 35.8 min.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 16;   // tile rows (x)
constexpr int TY = 32;   // tile columns (y, contiguous; one warp)

struct Cell {
  float d, u, v, yv;
  bool eli;
};

// Causal-view quantities of support cell (ox, oy) for the thread's pixel.
// `tile` holds S + 1 staged surfaces (chain oldest first, then center),
// each SX x SY; `pos` is the pixel's position in one staged surface.
template <int R>
__device__ __forceinline__ Cell cell(const uint32_t* tile, int S, int plane,
                                     int sy, int pos, uint32_t tc, int ox,
                                     int oy, float pxf, float pyf,
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
    for (int s = 1; s <= S; ++s) {
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

template <int F>
__global__ void __launch_bounds__(TX * TY)
local_flow_kernel(const int32_t* __restrict__ chain, int S,
                  const int32_t* __restrict__ center, int W, int H,
                  int min_evts, float det_threshold, float neg_ts,
                  int32_t* __restrict__ accept_out,
                  float* __restrict__ a_out, float* __restrict__ b_out,
                  float* __restrict__ dtdp_out,
                  int32_t* __restrict__ cand_out) {
  constexpr int R = 2 * F;
  constexpr int SX = TX + 2 * R;
  constexpr int SY = TY + 2 * R;
  constexpr int PLANE = SX * SY;
  extern __shared__ uint32_t tile[];

  const int x0 = blockIdx.y * TX;
  const int y0 = blockIdx.x * TY;
  const int tid = threadIdx.y * TY + threadIdx.x;
  const size_t WH = (size_t)W * H;

  for (int s = 0; s <= S; ++s) {
    const int32_t* src = s < S ? chain + (size_t)s * WH : center;
    uint32_t* dst = tile + s * PLANE;
    for (int i = tid; i < PLANE; i += TX * TY) {
      const int gx = x0 - R + i / SY;
      const int gy = y0 - R + i % SY;
      dst[i] = (gx >= 0 && gx < W && gy >= 0 && gy < H)
                   ? (uint32_t)src[(size_t)gx * H + gy]
                   : 0u;
    }
  }
  __syncthreads();

  const int px = x0 + threadIdx.y;
  const int py = y0 + threadIdx.x;
  if (px >= W || py >= H) return;
  const int pos = (threadIdx.y + R) * SY + threadIdx.x + R;
  const uint32_t tc = tile[S * PLANE + pos];
  const float pxf = (float)px;
  const float pyf = (float)py;
  const float n = (float)((2 * F + 1) * (2 * F + 1));

  // ---- scores of the 9 candidate windows, first strict minimum ----
  float best = __int_as_float(0x7f800000);  // +inf
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
        const float d = cell<R>(tile, S, PLANE, SY, pos, tc, a + wx, b + wy,
                                pxf, pyf, neg_ts).d;
        ssum = (wx == -F && wy == -F) ? d : ssum + d;
      }
    }
    const float score = ssum / n;
    // full-window in-bounds requirement (vFlow.cpp:889)
    const bool vm = px + (a - F) >= 0 && px + (a + F) <= W - 1 &&
                    py + (b - F) >= 0 && py + (b + F) <= H - 1;
    const float sm = vm ? score : __int_as_float(0x7f800000);
    if (sm < best) {
      best = sm;
      bc = ci;
    }
  }
  const bool local_ok = best < __int_as_float(0x7f800000);

  // ---- the winner's normal equations (candidate 0 if none fits) ----
  const int wa = (bc / 3 - 1) * F;
  const int wb = (bc % 3 - 1) * F;
  float su = 0.f, sv = 0.f, suu = 0.f, svv = 0.f, suv = 0.f;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int wx = -F; wx <= F; ++wx) {
#pragma unroll
    for (int wy = -F; wy <= F; ++wy) {
      const Cell c = cell<R>(tile, S, PLANE, SY, pos, tc, wa + wx, wb + wy,
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
      const Cell c = cell<R>(tile, S, PLANE, SY, pos, tc, wa + wx, wb + wy,
                             pxf, pyf, neg_ts);
      inl += (fabsf(ac * c.u + bcf * c.v - c.yv) < half && c.eli) ? 1 : 0;
    }
  }

  const size_t o = (size_t)px * H + py;
  accept_out[o] = (local_ok && det_ok && inl >= min_evts) ? 1 : 0;
  a_out[o] = ac;
  b_out[o] = bcf;
  dtdp_out[o] = dtdp;
  cand_out[o] = local_ok ? bc : -1;
}

template <int F>
cudaError_t launch(const int32_t* chain, int S, const int32_t* center, int W,
                   int H, int min_evts, float det_threshold, float neg_ts,
                   int32_t* accept, float* a, float* b, float* dtdp,
                   int32_t* cand, cudaStream_t stream) {
  constexpr int R = 2 * F;
  const size_t smem = (size_t)(S + 1) * (TX + 2 * R) * (TY + 2 * R) *
                      sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_flow_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(TY, TX);
  const dim3 grid((H + TY - 1) / TY, (W + TX - 1) / TX);
  local_flow_kernel<F><<<grid, block, smem, stream>>>(
      chain, S, center, W, H, min_evts, det_threshold, neg_ts, accept, a, b,
      dtdp, cand);
  return cudaGetLastError();
}

}  // namespace

// C entry point. chain: int32 [S, W, H]; center and the outputs: [W, H],
// all contiguous on the current device. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a filter size without a template instance).
extern "C" int farms_local_flow(const void* chain, int S, const void* center,
                                int W, int H, int filter_size, int min_evts,
                                float det_threshold, float neg_ts,
                                void* accept, void* a, void* b, void* dtdp,
                                void* cand, void* stream) {
  const auto c = static_cast<const int32_t*>(chain);
  const auto t = static_cast<const int32_t*>(center);
  const auto acc = static_cast<int32_t*>(accept);
  const auto fa = static_cast<float*>(a);
  const auto fb = static_cast<float*>(b);
  const auto fd = static_cast<float*>(dtdp);
  const auto cd = static_cast<int32_t*>(cand);
  const auto st = static_cast<cudaStream_t>(stream);
  if (filter_size == 3)
    return launch<1>(c, S, t, W, H, min_evts, det_threshold, neg_ts, acc, fa,
                     fb, fd, cd, st);
  if (filter_size == 5)
    return launch<2>(c, S, t, W, H, min_evts, det_threshold, neg_ts, acc, fa,
                     fb, fd, cd, st);
  return (int)cudaErrorInvalidValue;
}
