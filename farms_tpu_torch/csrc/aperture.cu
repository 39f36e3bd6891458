// Multi-scale aperture pooling, one thread per pixel.
//
// Replaces the Pallas kernel `_scales_kernel`
// (farms_tpu/ops/pallas/kernels.py:640, called from aperture_pallas :693).
// Plain version and contract: dense_aperture in
// farms_tpu_torch/ops/dense_flow.py; the 4-field integral image
// (gate, len*gate, vx*gate, vy*gate; a float64 double cumsum with a zero
// first row and column, see build_integral) is built by the wrapper with
// the same torch ops as the plain version.
//
// Per pixel and scale s: 4-corner box sums of each field over the window
// clamped to the sensor (x to [0, W], y to [0, y_clip], which carries the
// reference's y-clamped-by-width quirk, vFlow.cpp:998-1000), taken in
// float64 and rounded once to f32; then the count, mean length and mean
// vx/vy; the strict first maximum of the mean length wins
// (vFlow.cpp:1052-1059); the center flow and scale 0 are the fallback when
// that maximum is <= 0 (vFlow.cpp:1086-1094).
//
// What bounds it on the card: loads. Each pixel reads num_scales x 4 x 4
// integral values at scattered rows. A shared-memory slab of a 16 x 32
// tile with its 2M+2 halo would be ~250 KB at M = 50, above the 227 KB a
// block may use, so the corners are read straight from device memory with
// clamped indices; the whole 320 x 320 integral (3.3 MB) stays in L2, and
// neighboring threads of a warp read neighboring columns. Box sums
// associate as ((A - B) - C) + D like the plain version; built with
// -fmad=false the two agree bitwise on one device.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 8;    // tile rows (x)
constexpr int TY = 32;   // tile columns (y, contiguous; one warp)

__global__ void __launch_bounds__(TX * TY)
aperture_kernel(const double* __restrict__ integ, int W, int H, int y_clip,
                int n_scales, int jump, const float* __restrict__ flow_vx,
                const float* __restrict__ flow_vy, float* __restrict__ tvx,
                float* __restrict__ tvy, int32_t* __restrict__ scale_out) {
  const int px = blockIdx.y * TX + threadIdx.y;
  const int py = blockIdx.x * TY + threadIdx.x;
  if (px >= W || py >= H) return;
  const int Ly = H + 1;                       // integral row length
  const size_t plane = (size_t)(W + 1) * Ly;  // one field

  float best_ml = -1.0f, best_vx = 0.0f, best_vy = 0.0f;
  int best_s = 0;
  for (int si = 0; si < n_scales; ++si) {
    const int s = si * jump;
    const int xh = min(max(px + s + 1, 0), W);
    const int xl = min(max(px - s, 0), W);
    const int yh = min(max(py + s + 1, 0), y_clip);
    const int yl = min(max(py - s, 0), y_clip);
    float box[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const double* I = integ + f * plane;
      box[f] = (float)(I[(size_t)xh * Ly + yh] - I[(size_t)xl * Ly + yh] -
                       I[(size_t)xh * Ly + yl] + I[(size_t)xl * Ly + yl]);
    }
    const float cnt = box[0];
    const bool has = cnt > 0.5f;
    const float safe = has ? cnt : 1.0f;
    const float ml = has ? box[1] / safe : 0.0f;
    if (ml > best_ml) {                       // strict: first max wins
      best_ml = ml;
      best_vx = box[2] / safe;
      best_vy = box[3] / safe;
      best_s = s;
    }
  }
  const size_t o = (size_t)px * H + py;
  const bool pooled = best_ml > 0.0f;
  tvx[o] = pooled ? best_vx : flow_vx[o];
  tvy[o] = pooled ? best_vy : flow_vy[o];
  scale_out[o] = pooled ? best_s : 0;
}

}  // namespace

// C entry point. integ: float64 [4, W+1, H+1]; flow_vx/flow_vy and the
// outputs: [W, H]; all contiguous on the current device. Returns the
// launch's cudaError_t.
extern "C" int farms_aperture(const void* integ, int W, int H, int y_clip,
                              int n_scales, int jump, const void* flow_vx,
                              const void* flow_vy, void* tvx, void* tvy,
                              void* scale, void* stream) {
  const dim3 block(TY, TX);
  const dim3 grid((H + TY - 1) / TY, (W + TX - 1) / TX);
  aperture_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(integ), W, H, y_clip, n_scales, jump,
      static_cast<const float*>(flow_vx), static_cast<const float*>(flow_vy),
      static_cast<float*>(tvx), static_cast<float*>(tvy),
      static_cast<int32_t*>(scale));
  return (int)cudaGetLastError();
}
