// Blockwise int8 quantization for Hopper (sm_90a): K4a quantizes, K4b
// dequantizes.
//
// Replaces the TPU kernels of src/repro/kernels/quant/kernel.py:
// _quant_kernel (launched by quantize_int8_pallas) and _dequant_kernel
// (launched by dequantize_int8_pallas). They compute, per block of
// BLOCK values of the flattened input,
//   scale = max|x| / 127 + 1e-30,   q = clip(round(x / scale), -127, 127)
// and back, q * scale in f32, rounded to the output type. The port's
// AdamW stores its moments this way (int8 moments); every step
// dequantizes m and v of each leaf and quantizes them again.
//
// Layout: x (n,) f32 or bf16, read as nblk = ceil(n / BLOCK) blocks of
// BLOCK = 256 values (the AdamW block), the values past n read as zeros
// (no padded copy of x is made); q (nblk, BLOCK) int8 and scale (nblk,)
// f32. Dequantize writes the first n values of q * scale, f32 or bf16.
//
// Bit-equal to the plain version (and to jnp): the scale and every
// quotient are true IEEE divisions (nvcc's default -prec-div=true; the
// file refuses --use_fast_math), rintf rounds half to even as jnp.round
// does, and the maximum is exact in any order. A NaN anywhere in a
// block makes its scale NaN, as jnp.max and torch.amax do.
//
// Where the TPU kernel differs: its grid walks tiles of rows_per_tile
// blocks held in VMEM. Here:
//  - K4a: one warp per block, eight warps to a thread block. Each lane
//    loads its 8 contiguous values at once (two 16-byte loads of f32,
//    one of bf16), the block's max is a __shfl_xor_sync butterfly, and
//    each lane stores its 8 int8 values with one 8-byte store. Lane 0
//    writes the scale.
//  - K4b: each thread handles DEQ_UNROLL quads of 4 consecutive output
//    values (a quad shares one scale), the
//    quads of a thread block's threads side by side, so each load of q
//    (4 bytes a thread) and each store (16 bytes f32, 8 bytes bf16) is
//    contiguous across a warp. All of a thread's loads are issued before
//    its stores. (Eight or sixteen values a thread, each thread's own
//    run, left its stores strided: 1.89 and 2.89 ms at the path shape
//    on an H100, against a 1.21 ms bound.)
//
// What bounds it on the card: bytes. Quantize reads x once and writes q
// and the scales (5 bytes per f32 value); dequantize the reverse. The
// arithmetic (one division per value) is far below the byte time.
#include "common.cuh"

#if defined(__USE_FAST_MATH__)
#error "quant.cu must not be built with --use_fast_math: its divisions must be IEEE"
#endif

namespace repro {
namespace {

constexpr int BLOCK = 256;               // values per scale
constexpr int EPL = BLOCK / 32;          // K4a: values per lane
constexpr int WARPS = 8;                 // K4a: blocks (warps) per thread block
constexpr int THREADS = 256;
constexpr int DEQ_UNROLL = 4;            // K4b: quads of 4 values per thread
constexpr unsigned FULL = 0xffffffffu;

constexpr int pack_align(int bytes) { return bytes < 16 ? bytes : 16; }

// N values of T, loaded or stored as one aligned unit where N·sizeof(T)
// is 1..16 bytes, and as 16-byte units above that.
template <typename T, int N>
struct alignas(pack_align(N * sizeof(T))) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, long long n, long long nblk) {
  const long long blk = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (blk >= nblk) return;                       // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const long long base = blk * BLOCK + static_cast<long long>(lane) * EPL;

  float v[EPL];
  if (base + EPL <= n) {
    const Pack<T, EPL> p = *reinterpret_cast<const Pack<T, EPL>*>(x + base);
#pragma unroll
    for (int i = 0; i < EPL; ++i) v[i] = to_f32(p.v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) v[i] = base + i < n ? to_f32(x[base + i]) : 0.f;
  }

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) amax = nan_max(amax, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = nan_max(amax, __shfl_xor_sync(FULL, amax, off));
  const float s = amax / 127.0f + 1e-30f;

  Pack<int8_t, EPL> out;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const float r = fminf(fmaxf(rintf(v[i] / s), -127.f), 127.f);
    out.v[i] = static_cast<int8_t>(static_cast<int>(r));
  }
  *reinterpret_cast<Pack<int8_t, EPL>*>(q + base) = out;   // q holds nblk·BLOCK
  if (lane == 0) scale[blk] = s;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  T* __restrict__ out, long long n) {
  const long long first = static_cast<long long>(blockIdx.x) * THREADS * DEQ_UNROLL + threadIdx.x;
  const long long nquads = (n + 3) / 4;    // q holds nblk·BLOCK >= 4·nquads values
  Pack<int8_t, 4> qv[DEQ_UNROLL];
  float s[DEQ_UNROLL];
#pragma unroll
  for (int u = 0; u < DEQ_UNROLL; ++u) {
    const long long c = first + static_cast<long long>(u) * THREADS;
    if (c < nquads) {
      qv[u] = *reinterpret_cast<const Pack<int8_t, 4>*>(q + 4 * c);
      s[u] = scale[4 * c / BLOCK];
    }
  }
#pragma unroll
  for (int u = 0; u < DEQ_UNROLL; ++u) {
    const long long c = first + static_cast<long long>(u) * THREADS;
    if (c >= nquads) break;
    Pack<T, 4> o;
#pragma unroll
    for (int i = 0; i < 4; ++i) o.v[i] = from_f32<T>(static_cast<float>(qv[u].v[i]) * s[u]);
    const long long i0 = 4 * c;
    if (i0 + 4 <= n) {
      *reinterpret_cast<Pack<T, 4>*>(out + i0) = o;
    } else {
      for (int i = 0; i < 4 && i0 + i < n; ++i) out[i0 + i] = o.v[i];
    }
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, int8_t* q, float* scale, long long n,
                            long long nblk, cudaStream_t st) {
  const long long grid = (nblk + WARPS - 1) / WARPS;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_kernel<T><<<static_cast<unsigned>(grid), THREADS, 0, st>>>(
      static_cast<const T*>(x), q, scale, n, nblk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequantize(const int8_t* q, const float* scale, void* out,
                              long long n, cudaStream_t st) {
  const long long quads = (n + 3) / 4;
  const long long grid = (quads + THREADS * DEQ_UNROLL - 1) / (THREADS * DEQ_UNROLL);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  dequantize_kernel<T><<<static_cast<unsigned>(grid), THREADS, 0, st>>>(
      q, scale, static_cast<T*>(out), n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x (n,) f32 (x_dtype 0) or bf16 (1) -> q (nblk, 256) int8, scale (nblk,) f32
extern "C" int quant_quantize(const void* x, void* q, void* scale, int x_dtype,
                              long long n, long long nblk, void* stream) {
  if (n <= 0 || nblk != (n + repro::BLOCK - 1) / repro::BLOCK) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qt = static_cast<int8_t*>(q);
  float* sf = static_cast<float*>(scale);
  if (x_dtype == 0) return repro::launch_quantize<float>(x, qt, sf, n, nblk, st);
  if (x_dtype == 1) return repro::launch_quantize<__nv_bfloat16>(x, qt, sf, n, nblk, st);
  return cudaErrorInvalidValue;
}

// q (nblk, 256) int8, scale (nblk,) f32 -> out (n,) f32 (out_dtype 0) or bf16 (1)
extern "C" int quant_dequantize(const void* q, const void* scale, void* out, int out_dtype,
                                long long n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  if (out_dtype == 0) return repro::launch_dequantize<float>(qt, sf, out, n, st);
  if (out_dtype == 1) return repro::launch_dequantize<__nv_bfloat16>(qt, sf, out, n, st);
  return cudaErrorInvalidValue;
}
