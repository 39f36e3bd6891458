// Multi-scale aperture pooling, one thread per pixel, and the float64
// integral image it reads.
//
// Replaces the Pallas kernel `_scales_kernel`
// (farms_tpu/ops/pallas/kernels.py:640, called from aperture_pallas :693),
// in its default and its band (`halo`, `integ`) modes, and the integral
// that aperture_pallas builds before it.
// Plain versions and contracts: dense_aperture and build_integral in
// farms_tpu_torch/ops/dense_flow.py.
//
// The integral (farms_integral, two launches): the 4 gated fields (gate =
// len > 0, len*gate, vx*gate, vy*gate), formed in f32 and widened to
// float64, summed down each column (integral_x: one thread per field and
// column), then along each row in place (integral_y: one warp per field
// and 32 rows), each a sequential left fold from 0.0 in the plain
// version's order, with the zero first row and column written in place.
// What bounds it: latency, not its 4.5 MB of traffic. The plain order
// leaves 4 x (W + H) independent chains of dependent float64 adds, too
// few to fill the card; each block keeps the next chunks of its inputs in
// flight (a cp.async ring of shared memory) while it sums one. What it
// saves is the ten eager torch ops and their float64 round trips.
//
// The pool (aperture_kernel), per pixel and scale s: 4-corner box sums of
// each field over the window
// clamped to the sensor (x to [0, W], y to [0, y_clip], which carries the
// reference's y-clamped-by-width quirk, vFlow.cpp:998-1000), taken in
// float64 and rounded once to f32; then the count, mean length and mean
// vx/vy; the strict first maximum of the mean length wins
// (vFlow.cpp:1052-1059); the center flow and scale 0 are the fallback when
// that maximum is <= 0 (vFlow.cpp:1086-1094).
//
// What bounds the pool on the card: loads. Each pixel reads num_scales x 4 x 4
// integral values at scattered rows. A shared-memory slab of a 16 x 32
// tile with its 2M+2 halo would be ~250 KB at M = 50, above the 227 KB a
// block may use, so the corners are read straight from device memory with
// clamped indices; the whole 320 x 320 integral (3.3 MB) stays in L2, and
// neighboring threads of a warp read neighboring columns. Box sums
// associate as ((A - B) - C) + D like the plain version; built with
// -fmad=false the two agree bitwise on one device.
//
// Band mode (a row shard of parallel/halo.py) changes only addressing:
// the integral is a float64 band of rows + 2 * halo + 1 rows with
// halo >= max_window + 1 rows of global integral values above and below
// the shard's core rows (assemble_integral_band), so core row r reads
// corner rows halo + r + s + 1 and halo + r - s. The band holds 0 above
// the sensor and the sensor's total row below it, which realizes the
// reference's x clamp; the clamp to the integral's extent below is that
// clamp on a whole-sensor integral (halo 0) and never binds on a band.
// At 4 bands of 80 rows a band is (80 + 103) x 321 x 8 x 4 B = 1.9 MB,
// which stays in L2 like the whole integral.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int TX = 8;    // tile rows (x)
constexpr int TY = 32;   // tile columns (y, contiguous; one warp)

__global__ void __launch_bounds__(TX * TY)
aperture_kernel(const double* __restrict__ integ, int integ_rows, int rows,
                int halo, int Ha, int y_clip, int n_scales, int jump,
                const float* __restrict__ flow_vx,
                const float* __restrict__ flow_vy, float* __restrict__ tvx,
                float* __restrict__ tvy, int32_t* __restrict__ scale_out) {
  const int r = blockIdx.y * TX + threadIdx.y;
  const int py = blockIdx.x * TY + threadIdx.x;
  if (r >= rows || py >= Ha) return;
  const int Ly = Ha + 1;                           // integral row length
  const size_t plane = (size_t)integ_rows * Ly;    // one field
  const int px = halo + r;                         // the pixel's integral row
  const int x_hi = integ_rows - 1;

  float best_ml = -1.0f, best_vx = 0.0f, best_vy = 0.0f;
  int best_s = 0;
  for (int si = 0; si < n_scales; ++si) {
    const int s = si * jump;
    const int xh = min(max(px + s + 1, 0), x_hi);
    const int xl = min(max(px - s, 0), x_hi);
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
  const size_t o = (size_t)r * Ha + py;
  const bool pooled = best_ml > 0.0f;
  tvx[o] = pooled ? best_vx : flow_vx[o];
  tvy[o] = pooled ? best_vy : flow_vy[o];
  scale_out[o] = pooled ? best_s : 0;
}

constexpr int SCAN = 32;   // threads of an integral block (one warp)
constexpr int NSTAGE = 4;  // ring slots of the integral kernels

// Down each column: thread (field f, integral column j) writes rows 0..rows
// of column j; j = 0 is the zero column. The sum is a chain of dependent
// adds, so the inputs of the next NSTAGE - 1 chunks of SCAN rows are in
// flight (cp.async) while a chunk is summed. A thread reads only the
// shared-memory words it copied, so it needs no barrier.
__global__ void __launch_bounds__(SCAN)
integral_x(const float* __restrict__ flow_len,
           const float* __restrict__ flow_vx,
           const float* __restrict__ flow_vy, int rows, int cols,
           double* __restrict__ integ) {
  __shared__ float ring[NSTAGE][2][SCAN][SCAN];  // len, and vx or vy
  const int lane = threadIdx.x;
  const int j = blockIdx.x * SCAN + lane;
  const int f = blockIdx.y;
  if (j > cols) return;
  const int L = cols + 1;
  double* I = integ + (size_t)f * (rows + 1) * L + j;
  I[0] = 0.0;
  if (j == 0) {
    for (int i = 1; i <= rows; ++i) I[(size_t)i * L] = 0.0;
    return;
  }
  const float* vel = f == 2 ? flow_vx : flow_vy;
  auto stage = [&](int c) {  // rows c * SCAN .. of column j into its slot
    if (c * SCAN < rows) {
      for (int u = 0; u < SCAN; ++u) {
        const int i = c * SCAN + u;
        const size_t p = i < rows ? (size_t)i * cols + j - 1 : 0;
        const int n = i < rows ? 4 : 0;
        farms::cp_async4(&ring[c % NSTAGE][0][u][lane], flow_len + p, n);
        if (f >= 2)
          farms::cp_async4(&ring[c % NSTAGE][1][u][lane], vel + p, n);
      }
    }
    farms::commit();
  };
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) stage(c);
  double acc = 0.0;
  for (int c = 0; c * SCAN < rows; ++c) {
    farms::wait<NSTAGE - 2>();
    stage(c + NSTAGE - 1);  // into the slot of chunk c - 1, read already
    // the chunk's field values first, off the chain of dependent adds
    const float(*in)[SCAN][SCAN] = ring[c % NSTAGE];
    double val[SCAN];
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const float len = in[0][u][lane];
      const float gate = len > 0.0f ? 1.0f : 0.0f;
      val[u] = (double)(f == 0   ? gate
                        : f == 1 ? len * gate
                                 : in[1][u][lane] * gate);
    }
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      if (c * SCAN + u < rows) {
        acc = acc + val[u];
        I[(size_t)(c * SCAN + u + 1) * L] = acc;
      }
    }
  }
}

// Along each row, in place: warp (field f, rows i0..i0+31) scans a 32 x 32
// tile at a time, lane q carrying row i0 + q's sum from tile to tile; the
// next NSTAGE - 1 tiles are in flight (cp.async) during a tile's scan.
__global__ void __launch_bounds__(SCAN)
integral_y(double* __restrict__ integ, int rows, int cols) {
  __shared__ double ring[NSTAGE][SCAN][SCAN + 1];
  const int f = blockIdx.y;
  const int i0 = 1 + blockIdx.x * SCAN;  // row 0 is the zero row
  const int L = cols + 1;
  const int lane = threadIdx.x;
  double* I = integ + (size_t)f * (rows + 1) * L;
  const int nrow = min(SCAN, rows + 1 - i0);
  auto stage = [&](int c) {  // columns 1 + c * SCAN .. of the block's rows
    const int j = 1 + c * SCAN + lane;
    if (j - lane <= cols) {
      for (int q = 0; q < SCAN; ++q) {
        const bool in = q < nrow && j <= cols;
        farms::cp_async8(&ring[c % NSTAGE][q][lane],
                         in ? I + (size_t)(i0 + q) * L + j : I, in ? 8 : 0);
      }
    }
    farms::commit();
  };
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) stage(c);
  double acc = 0.0;                      // the zero first column
  for (int c = 0; 1 + c * SCAN <= cols; ++c) {
    farms::wait<NSTAGE - 2>();
    __syncwarp();  // every lane's copies; and tile c - 1 is written back
    stage(c + NSTAGE - 1);
    double(*t)[SCAN + 1] = ring[c % NSTAGE];
    const int ncol = min(SCAN, cols - c * SCAN);
    if (lane < nrow) {  // loads, the chain of dependent adds, stores
      double row[SCAN];
#pragma unroll
      for (int k = 0; k < SCAN; ++k) row[k] = t[lane][k];
#pragma unroll
      for (int k = 0; k < SCAN; ++k) {
        if (k < ncol) {
          acc = acc + row[k];
          row[k] = acc;
        }
      }
#pragma unroll
      for (int k = 0; k < SCAN; ++k) t[lane][k] = row[k];
    }
    __syncwarp();
    const int j = 1 + c * SCAN + lane;
#pragma unroll
    for (int q = 0; q < SCAN; ++q)
      if (q < nrow && j <= cols) I[(size_t)(i0 + q) * L + j] = t[q][lane];
  }
}

}  // namespace

// C entry point. integ: float64 [4, integ_rows, Ha + 1], the whole
// integral (integ_rows = W + 1, halo 0) or a shard's band (integ_rows =
// rows + 2 * halo + 1); flow_vx/flow_vy and the outputs: [rows, Ha]; all
// contiguous on the current device. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for inconsistent geometry).
extern "C" int farms_aperture(const void* integ, int integ_rows, int rows,
                              int halo, int Ha, int y_clip, int n_scales,
                              int jump, const void* flow_vx,
                              const void* flow_vy, void* tvx, void* tvy,
                              void* scale, void* stream) {
  if (rows < 1 || Ha < 1 || halo < 0 || integ_rows != rows + 2 * halo + 1)
    return (int)cudaErrorInvalidValue;
  const dim3 block(TY, TX);
  const dim3 grid((Ha + TY - 1) / TY, (rows + TX - 1) / TX);
  aperture_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(integ), integ_rows, rows, halo, Ha, y_clip,
      n_scales, jump, static_cast<const float*>(flow_vx),
      static_cast<const float*>(flow_vy), static_cast<float*>(tvx),
      static_cast<float*>(tvy), static_cast<int32_t*>(scale));
  return (int)cudaGetLastError();
}

// C entry point of the integral. flow_len/flow_vx/flow_vy: f32 [rows,
// cols]; integ: float64 [4, rows + 1, cols + 1]; all contiguous on the
// current device. Returns the first failed launch's cudaError_t
// (cudaErrorInvalidValue for an empty shape).
extern "C" int farms_integral(const void* flow_len, const void* flow_vx,
                              const void* flow_vy, int rows, int cols,
                              void* integ, void* stream) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  integral_x<<<dim3((cols + SCAN) / SCAN, 4), SCAN, 0, s>>>(
      static_cast<const float*>(flow_len), static_cast<const float*>(flow_vx),
      static_cast<const float*>(flow_vy), rows, cols,
      static_cast<double*>(integ));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  integral_y<<<dim3((rows + SCAN - 1) / SCAN, 4), SCAN, 0, s>>>(
      static_cast<double*>(integ), rows, cols);
  return (int)cudaGetLastError();
}
