// Multi-scale aperture pooling and the float64 integral image it reads.
//
// Replaces the Pallas kernel `_scales_kernel`
// (farms_tpu/ops/pallas/kernels.py:640, called from aperture_pallas :693),
// in its default and its band (`halo`, `integ`) modes, and the integral
// that aperture_pallas builds before it.
// Plain versions and contracts: dense_aperture and build_integral in
// farms_tpu_torch/ops/dense_flow.py.
//
// The integral (farms_integral, one launch of integral_kernel): the 4
// gated fields (gate = len > 0, len*gate, vx*gate, vy*gate), formed in
// f32 and widened to float64, summed down each column, then along each
// row, each a sequential left fold from 0.0 in the plain version's order,
// with the zero first row and column. What bounds it is not its 4.5 MB of
// traffic but its chain: rows + cols dependent float64 adds (8 cycles
// each on an H100), as the order leaves no chain to split. The design
// keeps each fold lane on its chain:
// - One launch, two roles, handed out by an atomic ticket in the order
//   blocks start: column blocks (STRIP integral columns x 4 fields, a
//   fold lane each) sum down the rows and store the column sums in
//   place; row blocks (BAND rows x 4 fields) sum those along the rows.
//   Column blocks wait on no other block and all start before any row
//   block, so the grid finishes on any number of SMs. A row block starts
//   once every strip is done: a per-stream counter of finished strips,
//   raised with a gpu-scope release by each column block and read with
//   an acquire against the call's strip count. The last row block to
//   finish sets the stream's ticket and strip counters back to 0, so every
//   launch starts from 0 and takes no value from the host that changes
//   from call to call: a CUDA graph may replay one captured launch. While
//   thread 0 takes the ticket, the producers already copy the first
//   chunks of strip blockIdx.x (the role a block mostly gets).
// - Each block is warps around a ring of SLOTS shared-memory slots
//   (mbarriers): two producers fill a slot of STEPS fold steps, the fold
//   warp (alone on its scheduler) sums it in place, two storers write it
//   out. Column producers copy flow_len, vx and vy once for all 4 fields
//   (cp.async, RAW chunks ahead) and form the gated f32 values and their
//   widening there; row producers copy a tile of column sums (cp.async of
//   8 bytes), one step of 32 lanes a copy, and the storers write rows
//   with whole warps. The fold loads a half slot ahead of the half it
//   sums, so that shared memory's latency hides under 16 adds.
// - Where its time goes on an H100 (320 x 320; measured by
//   scripts/torch_integral_timeline.py): the column and row chains at
//   about 0.45 us a slot of 32 steps rather than 32 adds' 0.13 (the
//   SM's store rate and shared memory, shared by five warps, are
//   suspected), 1.9 us of hand-off (last column sums stored, released,
//   seen, first tile copied) and 0.9 us to the first chunk.
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
#include <mutex>

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

constexpr int FIELDS = 4;      // gate, len * gate, vx * gate, vy * gate
constexpr int STRIP = 8;       // integral columns of a column block
constexpr int BAND = 8;        // integral rows of a row block
constexpr int STEPS = 32;      // fold steps of a ring slot: rows of a
                               // column chunk, columns of a row tile
constexpr int HALF = STEPS / 2;
constexpr int SLOTS = 6;       // ring slots of a block
constexpr int RAW = 3;         // column blocks: a producer's input chunks
                               // in flight
// A block's warps by job. Warp w runs on scheduler w % 4: warp 0 folds
// alone on its scheduler, producers 0 and 1 (warps 1 and 3) have one
// each (their f32 -> float64 conversions are the slow part of a chunk),
// storers 0 and 1 (warps 2 and 6) share one; warps 4, 5 and 7 have no
// job. Producer or storer w fills or empties half w of every slot: fold
// steps w * HALF .. (a column block) or fold lanes w * HALF .. (a row
// block).
constexpr int ROLE_WARPS = 8;
constexpr int PRODUCERS = 2;
constexpr int STORERS = 2;
constexpr int STREAM_SLOTS = 64;  // streams of a device with own counters
constexpr int LANES = 32;         // fold lanes: FIELDS x STRIP, FIELDS x BAND
static_assert(FIELDS * STRIP == LANES && FIELDS * BAND == LANES, "");
static_assert(LANES / STRIP == 4 && STEPS % 8 == 0, "producer lanes");
static_assert(PRODUCERS == 2 && STORERS == 2 && HALF % BAND == 0,
              "a producer or storer a half, whole fields of a row block");

// Per stream slot, counted within one launch and 0 between launches: the
// tickets taken (a block's role is its ticket), the column strips
// finished and the row blocks finished.
__device__ unsigned long long g_tickets[STREAM_SLOTS];
__device__ unsigned long long g_strips_done[STREAM_SLOTS];
__device__ unsigned long long g_exits[STREAM_SLOTS];

// A slot is [fold lane][fold step], rows of PITCH doubles: 16-byte
// aligned, and 8 lanes' rows fall in 8 distinct 16-byte bank groups, so
// the fold and the column storers move a lane's steps two at a time; a
// column producer's store (8 lanes x 4 steps) and a row producer's or
// storer's access (one step of 32 lanes) meet every bank pair once a
// half-warp.
constexpr int PITCH = STEPS + 2;

struct IntegralShared {
  double ring[SLOTS][LANES * PITCH];
  float raw[PRODUCERS][RAW][3][HALF][STRIP];  // column blocks' inputs
  uint64_t full[SLOTS], done[SLOTS], empty[SLOTS];
  int role;
};

// A warp's producer or storer index, -1 if it has not that job.
__device__ __forceinline__ int producer_of(int warp) {
  return warp == 1 ? 0 : warp == 3 ? 1 : -1;
}
__device__ __forceinline__ int storer_of(int warp) {
  return warp == 2 ? 0 : warp == 6 ? 1 : -1;
}

// Keeps a warp's shared-memory loads above this point, issued together,
// rather than each next to the store that uses it.
__device__ __forceinline__ void after_loads() {
  asm volatile("" ::: "memory");
}

// The storer warps' own barrier (named barrier 1).
__device__ __forceinline__ void storers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(STORERS * 32) : "memory");
}

// Slot s as [fold lane][fold step].
using SlotRows = double (*)[PITCH];
__device__ __forceinline__ SlotRows slot_of(IntegralShared& sh, int s) {
  return reinterpret_cast<SlotRows>(sh.ring[s]);
}

// HALF steps of a lane's row from p (16-byte aligned) into registers.
__device__ __forceinline__ void load_half(const double* p, double* v) {
  const double2* r = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int h = 0; h < HALF / 2; ++h) {
    const double2 x = r[h];
    v[2 * h] = x.x;
    v[2 * h + 1] = x.y;
  }
}

// The parity of the round of slot uses that use k (the k-th slot filled)
// belongs to: a wait for use k waits on it.
__device__ __forceinline__ unsigned round_parity(int k) {
  return (k / SLOTS) & 1;
}

// The fold warp over n slots in order, each lane's chain carried from slot
// to slot, each sum stored in place of its value; done[s] once a slot is
// summed. A slot is taken in two halves, and each half's values are
// loaded before the half ahead of it is summed, so that the loads' latency
// (long while other warps keep shared memory busy) hides under 16 adds.
__device__ __forceinline__ void fold_warp(IntegralShared& sh, int n,
                                          int lane) {
  double acc = 0.0;
  double a[HALF], b[HALF];
  auto load = [&](double* dst, int i) {  // half i: slot i / 2, half i % 2
    const int k = i / 2, s = k % SLOTS;
    if (i % 2 == 0) farms::mbar_wait(&sh.full[s], round_parity(k));
    load_half(slot_of(sh, s)[lane] + i % 2 * HALF, dst);
  };
  auto sum = [&](const double* src, int i) {
    const int k = i / 2, s = k % SLOTS;
    double2* r = reinterpret_cast<double2*>(slot_of(sh, s)[lane] +
                                            i % 2 * HALF);
#pragma unroll
    for (int h = 0; h < HALF / 2; ++h) {
      const double x = acc + src[2 * h];
      acc = x + src[2 * h + 1];
      r[h] = make_double2(x, acc);
    }
    if (i % 2) farms::mbar_arrive(&sh.done[s]);
  };
  if (n > 0) load(a, 0);
  for (int i = 0; i < 2 * n; i += 2) {
    load(b, i + 1);
    sum(a, i);
    if (i + 2 < 2 * n) load(a, i + 2);
    sum(b, i + 1);
  }
}

// Column producer pw's copies of chunk k of strip's inputs into its raw
// stage k % RAW: lane (row u, column c) of the chunk's half pw, rows u =
// lane / STRIP + 4t; each warp copy is 4 rows of STRIP floats of each of
// flow_len, vx and vy (zeros past the sensor and for the zero column).
__device__ __forceinline__ void stage_chunk(
    IntegralShared& sh, int strip, int pw, int k, int lane,
    const float* __restrict__ flow_len, const float* __restrict__ flow_vx,
    const float* __restrict__ flow_vy, int rows, int cols) {
  const int n_chunks = (rows + STEPS - 1) / STEPS;
  if (k < n_chunks) {
    const int c = lane % STRIP, u0 = lane / STRIP;
    const int j = strip * STRIP + c;  // integral column, input column j - 1
    const bool col_ok = j >= 1 && j <= cols;
    const int i0 = k * STEPS + pw * HALF + u0;  // input row of t = 0
    float(*r)[HALF][STRIP] = sh.raw[pw][k % RAW];
    const size_t row4 = (size_t)4 * cols;
    size_t q = col_ok ? (size_t)i0 * cols + j - 1 : 0;
#pragma unroll
    for (int t = 0; t < HALF / 4; ++t) {
      const bool ok = col_ok && i0 + 4 * t < rows;
      const int n = ok ? 4 : 0;
      const size_t qq = ok ? q : 0;
      farms::cp_async4(&r[0][u0 + 4 * t][c], flow_len + qq, n);
      farms::cp_async4(&r[1][u0 + 4 * t][c], flow_vx + qq, n);
      farms::cp_async4(&r[2][u0 + 4 * t][c], flow_vy + qq, n);
      q += row4;
    }
  }
  farms::commit();
}

// Column block `strip`: integral columns strip * STRIP .. (column 0 is
// the zero column), rows 0 .. rows of all 4 fields. `staged`: the
// producers' first RAW - 1 chunks are in flight already.
__device__ __forceinline__ void integral_columns(
    IntegralShared& sh, int strip, bool staged,
    const float* __restrict__ flow_len, const float* __restrict__ flow_vx,
    const float* __restrict__ flow_vy, int rows, int cols,
    double* __restrict__ integ, int slot) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t L = (size_t)cols + 1, plane = (rows + 1) * L;
  const int n_chunks = (rows + STEPS - 1) / STEPS;
  if (producer_of(warp) >= 0) {  // half pw of every chunk
    const int pw = producer_of(warp);
    const int c = lane % STRIP, u0 = lane / STRIP;
    if (!staged)
#pragma unroll
      for (int k = 0; k < RAW - 1; ++k)
        stage_chunk(sh, strip, pw, k, lane, flow_len, flow_vx, flow_vy,
                    rows, cols);
    for (int k = 0; k < n_chunks; ++k) {
      stage_chunk(sh, strip, pw, k + RAW - 1, lane, flow_len, flow_vx,
                  flow_vy, rows, cols);  // into chunk k - 1's stage
      farms::wait<RAW - 1>();
      const int s = k % SLOTS;
      const float(*in)[HALF][STRIP] = sh.raw[pw][k % RAW];
      float x[3][HALF / 4];
#pragma unroll
      for (int t = 0; t < HALF / 4; ++t)
#pragma unroll
        for (int a = 0; a < 3; ++a) x[a][t] = in[a][u0 + 4 * t][c];
      after_loads();
      farms::mbar_wait(&sh.empty[s], round_parity(k) ^ 1);
      double(*out)[PITCH] = slot_of(sh, s);
#pragma unroll
      for (int t = 0; t < HALF / 4; ++t) {
        const int u = pw * HALF + u0 + 4 * t;
        const bool on = x[0][t] > 0.0f;
        const float gate = on ? 1.0f : 0.0f;
        out[c][u] = on ? 1.0 : 0.0;  // (double)gate
        out[STRIP + c][u] = (double)(x[0][t] * gate);
        out[2 * STRIP + c][u] = (double)(x[1][t] * gate);
        out[3 * STRIP + c][u] = (double)(x[2][t] * gate);
      }
      farms::mbar_arrive(&sh.full[s]);
    }
  } else if (warp == 0) {  // fold: lane (field lane / STRIP, column)
    fold_warp(sh, n_chunks, lane);
  } else if (storer_of(warp) >= 0) {  // the fold's lanes; steps sw * HALF
                                      // .. of every chunk
    const int sw = storer_of(warp);
    const int j = strip * STRIP + lane % STRIP;
    const bool ok = j <= cols;
    double* I = integ + (lane / STRIP) * plane + j;
    if (ok && sw == 0) I[0] = 0.0;  // the zero row
    for (int k = 0; k < n_chunks; ++k) {
      const int s = k % SLOTS;
      farms::mbar_wait(&sh.done[s], round_parity(k));
      double v[HALF];
      load_half(slot_of(sh, s)[lane] + sw * HALF, v);
      after_loads();
      farms::mbar_arrive(&sh.empty[s]);  // the half is in registers
      const int i0 = k * STEPS + sw * HALF;  // its first step's row - 1
      double* Ik = I + (size_t)(1 + i0) * L;
      const int n = min(HALF, rows - i0);
      if (ok && n == HALF) {
#pragma unroll
        for (int u = 0; u < HALF; ++u) {
          *Ik = v[u];
          Ik += L;
        }
      } else if (ok) {
#pragma unroll
        for (int u = 0; u < HALF; ++u)
          if (u < n) Ik[u * L] = v[u];
      }
    }
    // count the strip done: the storers' stores are ordered before the
    // release by their barrier
    storers_sync();
    if (sw == 0 && lane == 0) farms::add_release(&g_strips_done[slot], 1);
  }
}

// Row block `band`: integral rows 1 + band * BAND .., columns 1 .. cols
// of all 4 fields, over the column sums in place, once all `n_strips`
// column strips are done.
__device__ __forceinline__ void integral_rows(
    IntegralShared& sh, int band, int rows, int cols,
    double* __restrict__ integ, int slot, unsigned long long n_strips) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t L = (size_t)cols + 1, plane = (rows + 1) * L;
  const int i0 = 1 + band * BAND;
  const int n_tiles = (cols + STEPS - 1) / STEPS;
  const int nrow = min(BAND, rows + 1 - i0);
  // this lane's column of tile 0 in field 0, row i0
  double* const I = integ + (size_t)i0 * L + 1 + lane;
  if (producer_of(warp) >= 0) {  // lane = a tile column; fold lanes pw *
                                 // HALF .. of every tile
    const int pw = producer_of(warp);
    if (lane == 0) {
      // a column block that never finishes (a fault) ends the kernel with
      // an error, not a hang
      const long long t0 = clock64();
      while (farms::load_relaxed(&g_strips_done[slot]) < n_strips)
        if (clock64() - t0 > (1LL << 34)) __trap();
      farms::fence_acq_rel();  // with the relaxed load: an acquire
    }
    __syncwarp();  // orders every lane's copies after it
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % SLOTS;
      farms::mbar_wait(&sh.empty[s], round_parity(t) ^ 1);
      const bool col_ok = 1 + t * STEPS + lane <= cols;
      double(*d)[PITCH] = slot_of(sh, s);
#pragma unroll
      for (int g = 0; g < HALF / BAND; ++g) {
        const int f = pw * HALF / BAND + g;
        const double* q = I + t * STEPS + f * plane;
#pragma unroll
        for (int r = 0; r < BAND; ++r) {
          const bool ok = col_ok && r < nrow;
          farms::cp_async8(&d[f * BAND + r][lane], ok ? q : integ,
                           ok ? 8 : 0);
          q += L;
        }
      }
      farms::arrive_copies(&sh.full[s]);
    }
  } else if (warp == 0) {  // fold: lane (field lane / BAND, row), from
                           // the zero first column
    fold_warp(sh, n_tiles, lane);
  } else if (storer_of(warp) >= 0) {  // lane = a tile column, whole rows
                                      // a store; fold lanes sw * HALF ..
    const int sw = storer_of(warp);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % SLOTS;
      farms::mbar_wait(&sh.done[s], round_parity(t));
      double v[HALF];
#pragma unroll
      for (int x = 0; x < HALF; ++x)
        v[x] = slot_of(sh, s)[sw * HALF + x][lane];
      after_loads();
      farms::mbar_arrive(&sh.empty[s]);  // the half is in registers
      if (1 + t * STEPS + lane <= cols) {
#pragma unroll
        for (int g = 0; g < HALF / BAND; ++g) {
          double* q = I + t * STEPS + (sw * HALF / BAND + g) * plane;
#pragma unroll
          for (int r = 0; r < BAND; ++r) {
            if (r < nrow) *q = v[g * BAND + r];
            q += L;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(ROLE_WARPS * 32)
integral_kernel(const float* __restrict__ flow_len,
                const float* __restrict__ flow_vx,
                const float* __restrict__ flow_vy, int rows, int cols,
                double* __restrict__ integ, int slot) {
  extern __shared__ __align__(16) unsigned char integral_smem[];
  IntegralShared& sh = *reinterpret_cast<IntegralShared*>(integral_smem);
  const int n_strips = (cols + STRIP) / STRIP;
  const int pw = producer_of(threadIdx.x / 32);
  // A block's role is its ticket, known after a trip to L2: meanwhile the
  // producers copy the first chunks of strip blockIdx.x, the role blocks
  // mostly get (dropped where it is not).
  const bool guess = blockIdx.x < n_strips;
  if (guess && pw >= 0)
#pragma unroll
    for (int k = 0; k < RAW - 1; ++k)
      stage_chunk(sh, blockIdx.x, pw, k, threadIdx.x % 32, flow_len, flow_vx,
                  flow_vy, rows, cols);
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(&g_tickets[slot], 1ULL);
    if (t >= gridDim.x) __trap();  // counters another launch left raised
    sh.role = (int)t;
    for (int s = 0; s < SLOTS; ++s) {
      farms::mbar_init(&sh.full[s], 2 * 32);   // both producer warps
      farms::mbar_init(&sh.done[s], 32);       // the fold warp
      farms::mbar_init(&sh.empty[s], 2 * 32);  // both storer warps
    }
    farms::mbar_init_fence();
  }
  __syncthreads();
  const int role = sh.role;
  const bool staged = guess && role == (int)blockIdx.x;
  if (guess && !staged && pw >= 0) farms::wait<0>();  // drop the guess
  if (role < n_strips) {
    integral_columns(sh, role, staged, flow_len, flow_vx, flow_vy, rows,
                     cols, integ, slot);
  } else {
    integral_rows(sh, role - n_strips, rows, cols, integ, slot, n_strips);
    // The last row block to finish sets the slot's counters back to 0 for
    // the next launch on the stream. By then every block has taken its
    // ticket and every column block has counted its strip (each row
    // block saw all of them), and each row block's last read of the
    // counters returned before it counts itself finished.
    __syncthreads();
    if (threadIdx.x == 0 &&
        atomicAdd(&g_exits[slot], 1ULL) == gridDim.x - n_strips - 1) {
      g_tickets[slot] = 0;
      g_strips_done[slot] = 0;
      g_exits[slot] = 0;
    }
  }
}

// The stream that holds each counter slot of each device (< 64, as for
// the pool).
struct StreamCounters {
  cudaStream_t stream;
  bool used;
};
std::mutex counters_mu;
StreamCounters counters[64][STREAM_SLOTS];
bool integral_smem_set[64];  // the kernel's dynamic shared memory allowed

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
// current device. One launch on `stream`. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for an empty shape,
// cudaErrorLaunchOutOfResources past STREAM_SLOTS streams on a device).
extern "C" int farms_integral(const void* flow_len, const void* flow_vx,
                              const void* flow_vy, int rows, int cols,
                              void* integ, void* stream) {
  if (rows < 1 || cols < 1 || rows > 0x7fffffff - BAND ||
      cols > 0x7fffffff - STRIP)
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> lock(counters_mu);
  if (!integral_smem_set[device]) {
    e = cudaFuncSetAttribute(integral_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sizeof(IntegralShared));
    if (e != cudaSuccess) return (int)e;
    integral_smem_set[device] = true;
  }
  StreamCounters* table = counters[device];
  int slot = -1;
  for (int i = 0; i < STREAM_SLOTS && slot < 0; ++i)
    if (table[i].used && table[i].stream == s) slot = i;
  for (int i = 0; i < STREAM_SLOTS && slot < 0; ++i)
    if (!table[i].used) {
      table[i] = StreamCounters{s, true};
      slot = i;
    }
  if (slot < 0) return (int)cudaErrorLaunchOutOfResources;
  const int n_strips = (cols + STRIP) / STRIP;
  const int n_blocks = n_strips + (rows + BAND - 1) / BAND;
  integral_kernel<<<n_blocks, ROLE_WARPS * 32, sizeof(IntegralShared), s>>>(
      static_cast<const float*>(flow_len), static_cast<const float*>(flow_vx),
      static_cast<const float*>(flow_vy), rows, cols,
      static_cast<double*>(integ), slot);
  return (int)cudaGetLastError();
}
