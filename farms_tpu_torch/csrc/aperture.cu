// Multi-scale aperture pooling and the float64 integral image it reads.
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
// What bounds the pool on the card: not its bytes but the chain of each
// block's scale steps. Read straight from device memory, each pixel would
// take num_scales x 4 fields x 4 corners of float64: 144 MB a pass at
// 320 x 320 and 11 scales, against 3.3 MB of distinct integral, at about
// L2's rate. This design cuts both kinds of repetition:
// - The winner is decided by the count and length fields alone, so the
//   scan reads only those; the vx and vy fields are read once, at the
//   winning scale's four corners, and divided by that scale's count
//   (the same values and operations as when every scale computed them,
//   so the same bits, NaN included).
// - A block pools a tile of tx x 32 pixels, two a thread (rows tr and
//   tr + tx / 2). For each corner kind (the high row corner px + s + 1 or
//   the low one px - s, by the high or low column corner) the tile's
//   corners at scale s form a tx x 32 rectangle of the integral that moves
//   by (+-jump, +-jump) from one scale to the next. Each kind keeps its
//   rectangle's (count, length) pairs in a slab of shared memory, a torus
//   of px x py slots (Slabs): a cell keeps its slot while it stays in the
//   rectangle, so a scale copies in only the strip its rectangle gains,
//   jump rows at its leading edge and jump columns of the other rows (the
//   whole rectangle where the jump reaches the tile's rows or passes 16).
//   A slot holds the cell the reading thread would have read: the clamp
//   is applied to the copy's address (TMA would fill with zeros, not
//   clamp).
// - The torus is jump rows and columns larger than the tile, so the strip
//   of scale s + 1 lands in slots that scale s does not read. A thread
//   loads its strip cells of all 4 kinds into registers before it pools
//   scale s and stores them after; one barrier a scale. (cp.async of 8
//   bytes was slower, most of all on the quirk's clamped columns, where
//   every lane of a warp copies the same cell.)
// - The tile's rows are chosen at launch: the fewest whose grid fits the
//   SMs in one wave (26 rows, 130 blocks, at 320 x 320 on 132 SMs). A
//   block's 11 steps are a chain of dependent loads, float64 adds, a
//   division and a barrier at a few warps a scheduler; more, smaller
//   blocks an SM or a deeper prefetch did not shorten it.
// At 320 x 320 and jump 5 the L2 reads fall to about 29 MB of slab
// copies and at most 6.6 MB of winner corners a pass. Box sums associate as
// ((A - B) - C) + D like the plain version; built with -fmad=false the
// two agree bitwise on one device.
//
// Band mode (a row shard of parallel/halo.py) changes only addressing:
// the integral is a float64 band of rows + 2 * halo + 1 rows with
// halo >= max_window + 1 rows of global integral values above and below
// the shard's core rows (assemble_integral_band), so core row r reads
// corner rows halo + r + s + 1 and halo + r - s. The band holds 0 above
// the sensor and the sensor's total row below it, which realizes the
// reference's x clamp; the clamp to the integral's extent below is that
// clamp on a whole-sensor integral (halo 0) and never binds on a band.
//
// Tile mode (a 2-D tile of the port's spatial engine, parallel/tiling.py)
// does the same in y: the band also holds col_halo >= max_window + 1
// columns left and right of the tile's cols core columns (row length cols
// + 2 * col_halo + 1), so core column c reads corner columns col_halo + c
// + s + 1 and col_halo + c - s. The band is built pre-clamped in y
// (assemble_integral_tile): 0 before the sensor, and past y_clip (the
// reference's y clamp, the quirk's included) the values of column y_clip.
// The y clamp is then the band's last column and, like the x clamp, never
// binds on a tile's pixels, so the slabs address the band's columns with
// a plain offset; whole-sensor and row-band launches (col_halo 0) run the
// same code on the same addresses as before.
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int TY = 32;          // tile columns (y, contiguous; one warp)
constexpr int TX_MIN = 8;       // tile rows (x): even, chosen at launch
constexpr int TX_MAX = 32;
constexpr int NT_MAX = TX_MAX / 2 * TY;  // threads of a pool block

// The slabs of a tile of tx rows at a jump: jx, jy the cells a rectangle
// gains in each axis from one scale to the next where cells carry over
// (jump < tx and jump <= 16), else jx = tx, jy = 0 (nothing carries and
// each scale copies its whole rectangle); each corner kind's torus of px
// x py double2 slots, jx rows and jy columns more than the tile (the
// columns rounded up to 8, so that a warp's 32 slots wrap without a bank
// conflict). At most 4 x 48 x 48 x 16 B = 144 KB a block.
struct Slabs {
  int jx, jy, px, py;
};

__host__ __device__ inline Slabs slabs_for(int tx, int jump) {
  const bool carry = jump < tx && jump <= 16;
  Slabs g;
  g.jx = carry ? jump : tx;
  g.jy = carry ? jump : 0;
  g.px = tx + g.jx;
  g.py = (TY + g.jy + 7) / 8 * 8;
  return g;
}

constexpr int SLAB_BYTES_MAX = 4 * 48 * 48 * 16;

inline int slab_bytes(const Slabs& g) {
  return 4 * g.px * g.py * (int)sizeof(double2);
}

// Tile rows for rows x Ha pixels on n_sm SMs: the fewest (even) whose
// grid fits the SMs in one wave, within [TX_MIN, TX_MAX].
inline int tile_rows(int rows, int Ha, int n_sm) {
  const int col_tiles = (Ha + TY - 1) / TY;
  const int row_tiles = n_sm / col_tiles > 1 ? n_sm / col_tiles : 1;
  int tx = (rows + row_tiles - 1) / row_tiles;
  tx += tx & 1;
  return tx < TX_MIN ? TX_MIN : tx > TX_MAX ? TX_MAX : tx;
}

__device__ __forceinline__ int wrap(int v, int p) {
  return v >= p ? v - p : v;
}

__global__ void __launch_bounds__(NT_MAX, 1)
aperture_kernel(const double* __restrict__ integ, int integ_rows, int rows,
                int halo, int cols, int col_halo, int y_clip, int n_scales,
                int jump,
                const float* __restrict__ flow_vx,
                const float* __restrict__ flow_vy, float* __restrict__ tvx,
                float* __restrict__ tvy, int32_t* __restrict__ scale_out) {
  // [corner kind][px][py] (count, length); kind bit 0: the low row
  // corner, bit 1: the low column corner
  extern __shared__ double2 slab[];
  const int ry = blockDim.y, TX = 2 * ry, nt = ry * TY;
  const Slabs g = slabs_for(TX, jump);
  const int tr = threadIdx.y, tc = threadIdx.x, tid = tr * TY + tc;
  const int r0 = blockIdx.y * TX, c0 = blockIdx.x * TY;
  const int Ly = cols + 2 * col_halo + 1; // integral row length
  const int plane = integ_rows * Ly;      // one field (< 2^31, checked)
  const double* const I0 = integ;         // count
  const double* const I1 = integ + plane; // length
  const int x_hi = integ_rows - 1;
  char* const base = reinterpret_cast<char*>(slab);
  // slab geometry in bytes; a low corner's cursor moves back by adding
  // the complement of the step, then wrapping
  const int row_b = g.py * 16, area_b = g.px * row_b;
  const int dx_b = g.jx * row_b, dy_b = g.jy * 16;
  const int dxl_b = area_b - dx_b, dyl_b = row_b - dy_b;

  // The cursors of one scale: the byte offsets of its rectangles' first
  // slot row (high and low row corners) and column. 0 at scale 0.
  struct Cur {
    int xh, xl, yh, yl;
  };
  auto advance = [&](Cur c) {
    c.xh = wrap(c.xh + dx_b, area_b);
    c.xl = wrap(c.xl + dxl_b, area_b);
    c.yh = wrap(c.yh + dy_b, row_b);
    c.yl = wrap(c.yl + dyl_b, row_b);
    return c;
  };
  // A copied cell: its (count, length) pairs at the 4 corner kinds and
  // their slab offsets.
  struct Cell {
    double2 v[4];
    int d[4];
  };
  // Load cell (a, b) of scale si's rectangles, counted from their leading
  // edges (the row and column they move toward), under scale si's
  // cursors c.
  auto fetch = [&](Cell& t, int si, int a, int b, const Cur& c) {
    const int s = si * jump;
    const int xh = min(max(halo + r0 + s + TX - a, 0), x_hi) * Ly;
    const int xl = min(max(halo + r0 - s + a, 0), x_hi) * Ly;
    const int yh = min(max(col_halo + c0 + s + TY - b, 0), y_clip);
    const int yl = min(max(col_halo + c0 - s + b, 0), y_clip);
    const int sxh = wrap((TX - 1 - a) * row_b + c.xh, area_b);
    const int sxl = wrap(a * row_b + c.xl, area_b);
    const int syh = wrap((TY - 1 - b) * 16 + c.yh, row_b);
    const int syl = wrap(b * 16 + c.yl, row_b);
    const int o0 = xh + yh, o1 = xl + yh, o2 = xh + yl, o3 = xl + yl;
    t.v[0] = make_double2(__ldg(I0 + o0), __ldg(I1 + o0));
    t.v[1] = make_double2(__ldg(I0 + o1), __ldg(I1 + o1));
    t.v[2] = make_double2(__ldg(I0 + o2), __ldg(I1 + o2));
    t.v[3] = make_double2(__ldg(I0 + o3), __ldg(I1 + o3));
    t.d[0] = sxh + syh;
    t.d[1] = area_b + sxl + syh;
    t.d[2] = 2 * area_b + sxh + syl;
    t.d[3] = 3 * area_b + sxl + syl;
  };
  auto put = [&](const Cell& t) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<double2*>(base + t.d[k]) = t.v[k];
  };

  // This thread's cells of a strip, tid and tid + nt: the strip is n1
  // cells of jx whole rows, then jy columns of the other rows.
  const int n1 = g.jx * TY, n_strip = n1 + (TX - g.jx) * g.jy;
  int ca[2], cb[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int e = tid + q * nt;
    ca[q] = e < n1 ? e / TY : g.jy ? g.jx + (e - n1) / g.jy : 0;
    cb[q] = e < n1 ? e % TY : g.jy ? (e - n1) % g.jy : 0;
  }
  Cur cur{0, 0, 0, 0};
  Cell t0, t1;
  if (n_scales > 0) {         // scale 0's whole rectangles
    fetch(t0, 0, tid / TY, tid % TY, cur);
    fetch(t1, 0, (tid + nt) / TY, (tid + nt) % TY, cur);
    put(t0);
    put(t1);
  }
  __syncthreads();

  float best_ml[2] = {-1.0f, -1.0f}, best_safe[2] = {1.0f, 1.0f};
  int best_si[2] = {0, 0};
  // this thread's read offsets in bytes at the scale pooled: the slot
  // rows of its two pixels' high and low row corners, the slot columns of
  // the high and low column corners
  int rh0 = tr * row_b, rh1 = (tr + ry) * row_b, rl0 = rh0, rl1 = rh1;
  int ch = tc * 16, cl = ch;
  for (int si = 0; si < n_scales; ++si) {
    // scale si + 1's strip: loaded now, stored once scale si is pooled
    cur = advance(cur);
    const bool more = si + 1 < n_scales;
    const bool f0 = more && tid < n_strip, f1 = more && tid + nt < n_strip;
    if (f0) fetch(t0, si + 1, ca[0], cb[0], cur);
    if (f1) fetch(t1, si + 1, ca[1], cb[1], cur);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int rh = p ? rh1 : rh0, rl = p ? rl1 : rl0;
      const double2 A = *reinterpret_cast<const double2*>(base + rh + ch);
      const double2 B =
          *reinterpret_cast<const double2*>(base + area_b + rl + ch);
      const double2 C =
          *reinterpret_cast<const double2*>(base + 2 * area_b + rh + cl);
      const double2 D =
          *reinterpret_cast<const double2*>(base + 3 * area_b + rl + cl);
      const float cnt = (float)(((A.x - B.x) - C.x) + D.x);
      const float len = (float)(((A.y - B.y) - C.y) + D.y);
      const bool has = cnt > 0.5f;
      const float safe = has ? cnt : 1.0f;
      const float ml = has ? len / safe : 0.0f;
      if (ml > best_ml[p]) {                  // strict: first max wins
        best_ml[p] = ml;
        best_safe[p] = safe;
        best_si[p] = si;
      }
    }
    if (f0) put(t0);
    if (f1) put(t1);
    __syncthreads();
    rh0 = wrap(rh0 + dx_b, area_b);
    rh1 = wrap(rh1 + dx_b, area_b);
    rl0 = wrap(rl0 + dxl_b, area_b);
    rl1 = wrap(rl1 + dxl_b, area_b);
    ch = wrap(ch + dy_b, row_b);
    cl = wrap(cl + dyl_b, row_b);
  }

  const int py = c0 + tc;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int r = r0 + tr + p * ry;
    if (r >= rows || py >= cols) continue;
    const size_t o = (size_t)r * cols + py;
    if (!(best_ml[p] > 0.0f)) {               // the fallback
      tvx[o] = flow_vx[o];
      tvy[o] = flow_vy[o];
      scale_out[o] = 0;
      continue;
    }
    // vx and vy at the winning scale's corners, as the plain version reads
    const int s = best_si[p] * jump, px = halo + r, qy = col_halo + py;
    const int xh = min(max(px + s + 1, 0), x_hi) * Ly;
    const int xl = min(max(px - s, 0), x_hi) * Ly;
    const int yh = min(max(qy + s + 1, 0), y_clip);
    const int yl = min(max(qy - s, 0), y_clip);
    const double* Ix = integ + 2 * (size_t)plane;
    const double* Iy = integ + 3 * (size_t)plane;
    const float bx = (float)(Ix[xh + yh] - Ix[xl + yh] - Ix[xh + yl] +
                             Ix[xl + yl]);
    const float by = (float)(Iy[xh + yh] - Iy[xl + yh] - Iy[xh + yl] +
                             Iy[xl + yl]);
    tvx[o] = bx / best_safe[p];
    tvy[o] = by / best_safe[p];
    scale_out[o] = s;
  }
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

// The SM count of the current device, read once per device; allows the
// pool its largest slabs at the same first use. 0 on failure (err set).
int pool_sms(cudaError_t& err) {
  static int n_sm[64];
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return 0;
  if (device >= 64) {
    err = cudaErrorInvalidDevice;
    return 0;
  }
  if (!n_sm[device]) {
    err = cudaFuncSetAttribute(aperture_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SLAB_BYTES_MAX);
    if (err != cudaSuccess) return 0;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return 0;
    n_sm[device] = n;
  }
  return n_sm[device];
}

}  // namespace

// C entry point. integ: float64 [4, integ_rows, cols + 2 * col_halo + 1],
// the whole integral (integ_rows = W + 1, halo = col_halo = 0, cols = the
// array height), a shard's band (integ_rows = rows + 2 * halo + 1,
// col_halo 0) or a tile's band (col_halo > 0 too, pre-clamped in y, with
// y_clip its last column); flow_vx/flow_vy and the outputs: [rows, cols];
// all contiguous on the current device. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for inconsistent geometry).
extern "C" int farms_aperture(const void* integ, int integ_rows, int rows,
                              int halo, int cols, int col_halo, int y_clip,
                              int n_scales, int jump, const void* flow_vx,
                              const void* flow_vy, void* tvx, void* tvy,
                              void* scale, void* stream) {
  const int Ly = cols + 2 * col_halo + 1;
  if (rows < 1 || cols < 1 || halo < 0 || col_halo < 0 || jump < 0 ||
      integ_rows != rows + 2 * halo + 1 || y_clip < 0 || y_clip >= Ly ||
      (long long)integ_rows * Ly > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const int n_sm = pool_sms(e);
  if (!n_sm) return (int)e;
  const int tx = tile_rows(rows, cols, n_sm);
  const dim3 block(TY, tx / 2);
  const dim3 grid((cols + TY - 1) / TY, (rows + tx - 1) / tx);
  aperture_kernel<<<grid, block, slab_bytes(slabs_for(tx, jump)),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(integ), integ_rows, rows, halo, cols,
      col_halo, y_clip, n_scales, jump, static_cast<const float*>(flow_vx),
      static_cast<const float*>(flow_vy), static_cast<float*>(tvx),
      static_cast<float*>(tvy), static_cast<int32_t*>(scale));
  return (int)cudaGetLastError();
}

// How the pool runs on rows x Ha pixels (a tile's core columns in tile
// mode) at a jump on the current device:
// its tile (tile_rows x tile_cols pixels, two a thread), each corner
// kind's slab (slab_rows x slab_cols slots), the strip a later scale
// copies (strip_rows whole rows and strip_cols columns of the others)
// and a block's shared bytes. Returns a cudaError_t
// (cudaErrorInvalidValue for a bad geometry).
extern "C" int farms_aperture_shape(int rows, int Ha, int jump,
                                    int* tile_rows_out, int* tile_cols,
                                    int* slab_rows, int* slab_cols,
                                    int* strip_rows, int* strip_cols,
                                    int* shared_bytes) {
  if (rows < 1 || Ha < 1 || jump < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const int n_sm = pool_sms(e);
  if (!n_sm) return (int)e;
  const int tx = tile_rows(rows, Ha, n_sm);
  const Slabs g = slabs_for(tx, jump);
  *tile_rows_out = tx;
  *tile_cols = TY;
  *slab_rows = g.px;
  *slab_cols = g.py;
  *strip_rows = g.jx;
  *strip_cols = g.jy;
  *shared_bytes = slab_bytes(g);
  return 0;
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
