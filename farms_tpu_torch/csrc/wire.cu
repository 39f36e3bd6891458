// The device-to-host wire decoded into the seven per-lane output columns,
// on the card.
//
// Replaces no TPU kernel: the JAX package decodes the wire on the host
// (decode_wire_columns in farms_tpu/pipeline/engine.py), and so did the
// port. The plain version and contract: decode_wire_columns in
// farms_tpu_torch/ops/dense_flow.py, which a CPU engine runs.
//
// A lane's wire is its four flow components (vx, vy and the true flow's
// tvx, tvy: f16 halves of two int32 words, or four f32 words) and its aux
// byte (valid flag in bit 7, scale id in bits 0-6). Out, a row each of a
// float32 [7, n] block: r_true, theta_true, vx, vy, r_local, theta_local
// and scale (int32 bits, the scale id times the window jump).
// - f16 halves widen exactly; a NaN keeps its sign and payload, as
//   NumPy's widening keeps them (not quieted).
// - r = sqrt(x*x + y*y), each operation rounded once (__fmul_rn,
//   __fadd_rn, __fsqrt_rn): bit for bit NumPy's f32 arithmetic. A NaN
//   result is the quieted NaN of x, else of y. (IEEE 754 leaves the choice
//   between two NaN operands open, and NumPy's builds differ in it.)
// - theta = atan2f(y, x) in f32: within atan2f's ulp bound (CUDA Math
//   API), its NaNs and signed zeros C99's.
// - Invalid lanes keep their raw vx and vy, with 0 in r_local and
//   theta_local.
//
// What bounds it on the card: bytes, 9 read and 28 written a lane (a
// 1,048,576-lane wire is 38.8 MB, 11.6 us at 3.35 TB/s); the arithmetic
// (two square roots and at most two atan2f a lane) hides under them. The
// design: a thread takes four adjacent lanes, so each of the wire's words
// rows is one 16-byte load, the aux bytes one 4-byte load and each output
// row one 16-byte store, with neighbouring threads on neighbouring
// addresses; it computes and stores a row at a time, so it holds its
// words and four values, few registers. Where the wire's step width, the
// output's offset or row stride, or a pointer is not aligned to four
// lanes, the same per-lane function runs a lane a thread. On an H100 SXM
// a 1,048,576-lane wire takes about 17 us, some two thirds of the bound
// (PERF.md's kernel table); the block size and register caps move it by
// less than 3 %.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;            // lanes a thread on the vector path

// One f16 half (the low 16 bits of h) widened to f32, exactly.
__device__ __forceinline__ float widen(uint32_t h) {
  const uint32_t sign = (h & 0x8000u) << 16;
  const uint32_t mag = h & 0x7fffu;
  uint32_t bits;
  if (mag >= 0x7c00u) {           // Inf or NaN: payload kept
    bits = 0x7f800000u | ((mag & 0x3ffu) << 13);
  } else if (mag >= 0x0400u) {    // normal: exponent rebiased by 127 - 15
    bits = (mag << 13) + 0x38000000u;
  } else {                        // subnormal or zero: mag x 2^-24, exact
    bits = __float_as_uint(
        __fmul_rn(__uint2float_rn(mag), 5.9604644775390625e-8f));
  }
  return __uint_as_float(sign | bits);
}

__device__ __forceinline__ float quiet(float v) {
  return __uint_as_float(__float_as_uint(v) | 0x00400000u);
}

__device__ __forceinline__ float magnitude(float x, float y) {
  const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
  return isnan(x) ? quiet(x) : isnan(y) ? quiet(y) : r;
}

// Flow component c (0 vx, 1 vy, 2 tvx, 3 tvy) of a lane from its C wire
// words (C = 2: the f16 pairs vx | vy << 16 and tvx | tvy << 16; C = 4:
// the four f32 words).
template <int C>
__device__ __forceinline__ float component(const uint32_t (&w)[C], int c) {
  if constexpr (C == 2)
    return widen(c % 2 ? w[c / 2] >> 16 : w[c / 2] & 0xffffu);
  else
    return __uint_as_float(w[c]);
}

// Output row r (0 r_true, 1 theta_true, 2 vx, 3 vy, 4 r_local,
// 5 theta_local, 6 scale as int32 bits) of a lane.
template <int C>
__device__ __forceinline__ float column(const uint32_t (&w)[C],
                                        uint32_t aux, int jump, int r) {
  const bool valid = (aux & 0x80u) != 0;
  switch (r) {
    case 0: return magnitude(component(w, 2), component(w, 3));
    case 1: return atan2f(component(w, 3), component(w, 2));
    case 2: return component(w, 0);
    case 3: return component(w, 1);
    case 4: return valid ? magnitude(component(w, 0), component(w, 1)) : 0.0f;
    case 5: return valid ? atan2f(component(w, 1), component(w, 0)) : 0.0f;
    default: return __int_as_float(static_cast<int>(aux & 0x7fu) * jump);
  }
}

// Four adjacent lanes a thread: lanes i .. i + 3 of one step (k % 4 == 0),
// stored at columns offset + i .. of out's rows (offset, stride and the
// pointers aligned to 16 bytes). A row at a time, so that a thread holds
// only its words and one row's four values.
template <int C>
__global__ void __launch_bounds__(THREADS)
decode_wire_vec(const int32_t* __restrict__ main,
                const uint32_t* __restrict__ aux4, long long k,
                long long count, int jump, float* __restrict__ out,
                long long stride, long long offset) {
  const long long i =
      VEC * (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x);
  if (i >= count) return;
  const long long s = i / k;
  const long long l = i - s * k;
  int4 q[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    q[c] = __ldcs(reinterpret_cast<const int4*>(main + (s * C + c) * k + l));
  const uint32_t a = __ldcs(aux4 + (s * k + l) / VEC);
  uint32_t w[VEC][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    w[0][c] = q[c].x;
    w[1][c] = q[c].y;
    w[2][c] = q[c].z;
    w[3][c] = q[c].w;
  }
  float* dst = out + offset + i;
  const bool whole = i + VEC <= count;
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      v[j] = column<C>(w[j], (a >> (8 * j)) & 0xffu, jump, r);
    if (whole) {
      *reinterpret_cast<float4*>(dst + r * stride) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {                      // the last lanes: the wire holds all four
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (i + j < count) dst[r * stride + j] = v[j];
    }
  }
}

// A lane a thread, any alignment.
template <int C>
__global__ void __launch_bounds__(THREADS)
decode_wire_lane(const int32_t* __restrict__ main,
                 const uint8_t* __restrict__ aux, long long k,
                 long long count, int jump, float* __restrict__ out,
                 long long stride, long long offset) {
  const long long i =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= count) return;
  const long long s = i / k;
  const long long l = i - s * k;
  uint32_t w[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    w[c] = static_cast<uint32_t>(__ldcs(main + (s * C + c) * k + l));
  const uint32_t a = __ldcs(aux + s * k + l);
#pragma unroll
  for (int r = 0; r < 7; ++r)
    out[r * stride + offset + i] = column<C>(w, a, jump, r);
}

template <int C>
void launch(const void* main, const void* aux, long long k, long long count,
            int jump, void* out, long long stride, long long offset,
            cudaStream_t stream) {
  const auto aligned = [](const void* p, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(p) % to == 0;
  };
  const int32_t* m = static_cast<const int32_t*>(main);
  float* o = static_cast<float*>(out);
  if (k % VEC == 0 && offset % VEC == 0 && stride % VEC == 0 &&
      aligned(main, 16) && aligned(aux, 4) && aligned(out, 16)) {
    const long long threads = (count + VEC - 1) / VEC;
    decode_wire_vec<C><<<(threads + THREADS - 1) / THREADS, THREADS, 0,
                         stream>>>(m, static_cast<const uint32_t*>(aux), k,
                                   count, jump, o, stride, offset);
  } else {
    decode_wire_lane<C><<<(count + THREADS - 1) / THREADS, THREADS, 0,
                          stream>>>(m, static_cast<const uint8_t*>(aux), k,
                                    count, jump, o, stride, offset);
  }
}

}  // namespace

// C entry point. main: int32 [steps, rows, lanes] (rows 2: the f16 wire,
// 4: the f32 wire), aux: uint8 [steps, lanes], out: float32 [7, stride],
// all contiguous on the current device. Decodes wire lanes 0 .. count - 1
// (lane s * lanes + l is step s's lane l) into out's columns offset ..
// offset + count - 1. One launch on `stream` (none for count 0). Returns
// the launch's cudaError_t (cudaErrorInvalidValue for a bad shape).
extern "C" int farms_decode_wire(const void* main, const void* aux, int rows,
                                 int lanes, int count, int jump, void* out,
                                 int stride, int offset, void* stream) {
  if ((rows != 2 && rows != 4) || lanes < 1 || count < 0 || offset < 0 ||
      static_cast<long long>(offset) + count > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 2)
    launch<2>(main, aux, lanes, count, jump, out, stride, offset, s);
  else
    launch<4>(main, aux, lanes, count, jump, out, stride, offset, s);
  return static_cast<int>(cudaGetLastError());
}
