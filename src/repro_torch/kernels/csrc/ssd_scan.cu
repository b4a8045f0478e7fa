// Mamba2 SSD scan for Hopper (sm_90a): the chunked state-space-duality
// scan of one prompt, carrying the recurrent state through the sequence.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan_pallas). It computes the same
// function: for each (b, head), with dA = dt·A and cum its running sum
// inside a tile of tokens,
//   y[t]  = Σ_{s≤t} (C[t]·B[s]) exp(cum[t] − cum[s]) dt[s] x[s]
//         + exp(cum[t]) C[t]·h            (h: state entering the tile)
//   h    <- h exp(cum[last]) + Σ_s exp(cum[last] − cum[s]) dt[s] x[s] B[s]ᵀ
// and returns y (B,S,H,P) f32 and the state after the last token
// (B,H,P,N) f32. SSD is exact for any tile length up to rounding, so the
// kernel walks tiles of TILE tokens whatever chunk the caller names.
//
// Layout: x (B,S,H,P) and B, C (B,S,N) f32 or bf16 (one dtype); dt
// (B,S,H) and A (H,) f32; all math in f32.
// N % 4 == 0, N <= 256. Any S >= 0: rows past S are loaded as zeros
// (dt = 0, so they neither decay nor feed the state) and never stored.
//
// Where the TPU kernel differs: its grid walks the chunks in order on one
// core, with a (head tile, P, N) state in VMEM; it masks s > t with
// jnp.where after forming the exponentials. Here:
//  - one block per (b, head, slice of PSLICE head dims) walks the whole
//    sequence in a loop and keeps its (PSLICE, N) f32 state in shared
//    memory (16.5 KB at N = 128); B·H·P/PSLICE = 160 blocks at the
//    mamba2-2.7b prefill (B = 1, H = 80, P = 64), two to an SM;
//  - exp is taken only of cum[t] − cum[s] with s ≤ t, as one difference
//    (never exp(cum[t])·exp(−cum[s])): every argument is ≤ 0, so nothing
//    overflows and no inf meets a zero;
//  - C·Bᵀ (shared by all heads, ngroups = 1) is recomputed per block.
//
// What bounds it on the card: at the mamba2 shape the work over the 67
// TFLOP/s of the CUDA cores (the function needs 1.34 GFLOP, 4PN per token
// and head; this kernel's 64-token tiles do about 2.2), not the ≈ 19 MB
// it moves. This first version runs f32 FMAs on the CUDA cores, with
// shared-memory operands read as 16-byte quads or broadcasts; tensor
// cores for C·Bᵀ and the state update, C·Bᵀ shared across heads, and
// more blocks are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int TILE = 64;               // tokens per step of the sequence loop
constexpr int PSLICE = 32;             // head dims per block
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// acc + c * v, elementwise
__device__ __forceinline__ float4 fma4(float4 acc, float c, float4 v) {
  return make_float4(fmaf(c, v.x, acc.x), fmaf(c, v.y, acc.y),
                     fmaf(c, v.z, acc.z), fmaf(c, v.w, acc.w));
}

__host__ __device__ constexpr size_t smem_floats(int N) {
  // sB, sC (TILE x NP), state (PSLICE x NP), scores (TILE x TILE),
  // x (TILE x PSLICE), cum, w, dt (TILE each); NP = N + 4
  return 2 * static_cast<size_t>(TILE) * (N + 4) + static_cast<size_t>(PSLICE) * (N + 4) +
         TILE * TILE + TILE * PSLICE + 3 * TILE;
}

template <typename XT>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const XT* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const XT* __restrict__ Bm,
                const XT* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ hout, int S, int H, int P, int N) {
  // Row stride NP = N + 4 floats: a warp reading one quad from each of 8
  // rows (C·Bᵀ, C·h) hits 32 distinct banks.
  const int NP = N + 4, NQ = N / 4;
  const int p0 = blockIdx.x * PSLICE, head = blockIdx.y, b = blockIdx.z;
  const int ps = min(PSLICE, P - p0);
  const int tid = threadIdx.x;

  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);
  float* sC = sB + TILE * NP;
  float* sh = sC + TILE * NP;          // the carried state (PSLICE, N)
  float* sM = sh + PSLICE * NP;        // scores (TILE, TILE), s <= t only
  float* sx = sM + TILE * TILE;        // x (TILE, PSLICE)
  float* scum = sx + TILE * PSLICE;
  float* sw = scum + TILE;             // exp(cum[last] - cum[s]) dt[s]
  float* sdt = sw + TILE;
  __shared__ float s_decay;            // exp(cum[last])

  const float a = A[head];
  const size_t row = static_cast<size_t>(H) * P;           // token stride of x, y
  const XT* xb = x + static_cast<size_t>(b) * S * row + static_cast<size_t>(head) * P + p0;
  float* yb = y + static_cast<size_t>(b) * S * row + static_cast<size_t>(head) * P + p0;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + head;
  const XT* Bb = Bm + static_cast<size_t>(b) * S * N;
  const XT* Cb = Cm + static_cast<size_t>(b) * S * N;

  for (int i = tid; i < PSLICE * NP; i += THREADS) sh[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int nt = min(TILE, S - t0);                       // real rows of the tile
    // 1. the tile's B, C, x and dt, as f32, zero past the last real row
    for (int i = tid; i < TILE * NQ; i += THREADS) {
      const int t = i / NQ, q = i - t * NQ;
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f), cv = bv;
      if (t < nt) {
        bv = load4(Bb + static_cast<size_t>(t0 + t) * N + 4 * q);
        cv = load4(Cb + static_cast<size_t>(t0 + t) * N + 4 * q);
      }
      store4(sB + t * NP + 4 * q, bv);
      store4(sC + t * NP + 4 * q, cv);
    }
    for (int i = tid; i < TILE * ps; i += THREADS) {
      const int t = i / ps, p = i - t * ps;
      sx[t * PSLICE + p] = t < nt ? to_f32(xb[static_cast<size_t>(t0 + t) * row + p]) : 0.f;
    }
    if (tid < TILE) sdt[tid] = tid < nt ? dtb[static_cast<size_t>(t0 + tid) * H] : 0.f;
    __syncthreads();

    // 2. cum = running sum of dt·A over the tile (one warp, two tokens a
    //    lane, shuffle scan); the state's weights and decay
    if (tid < 32) {
      const float d0 = sdt[2 * tid] * a, d1 = sdt[2 * tid + 1] * a;
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(FULL, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (tid == 0) excl = 0.f;
      scum[2 * tid] = excl + d0;
      scum[2 * tid + 1] = excl + d0 + d1;
      __syncwarp();
      const float last = scum[nt - 1];
      for (int t = tid; t < TILE; t += 32)
        sw[t] = t < nt ? expf(last - scum[t]) * sdt[t] : 0.f;
      if (tid == 0) s_decay = expf(last);
    }
    __syncthreads();

    // 3. scores M[t][s] = (C[t]·B[s]) exp(cum[t] - cum[s]) dt[s], s <= t:
    //    the pairs s > t are never formed, so their exp never overflows
    for (int i = tid; i < TILE * TILE; i += THREADS) {
      const int t = i / TILE, s = i - t * TILE;
      if (s > t || t >= nt) continue;
      const float* cr = sC + t * NP;
      const float* br = sB + s * NP;
      float acc = 0.f;
      for (int q = 0; q < NQ; ++q) acc += dot4(load4(cr + 4 * q), load4(br + 4 * q));
      sM[i] = acc * expf(scum[t] - scum[s]) * sdt[s];
    }
    __syncthreads();

    // 4. y[t][p] = Σ_{s<=t} M[t][s] x[s][p] + exp(cum[t]) C[t]·h[p]
    for (int i = tid; i < nt * ps; i += THREADS) {
      const int t = i / ps, p = i - t * ps;
      const float* mr = sM + t * TILE;
      float intra = 0.f;
      for (int s = 0; s <= t; ++s) intra = fmaf(mr[s], sx[s * PSLICE + p], intra);
      const float* cr = sC + t * NP;
      const float* hr = sh + p * NP;
      float inter = 0.f;
      for (int q = 0; q < NQ; ++q) inter += dot4(load4(cr + 4 * q), load4(hr + 4 * q));
      yb[static_cast<size_t>(t0 + t) * row + p] = intra + inter * expf(scum[t]);
    }
    __syncthreads();

    // 5. h[p] <- h[p] exp(cum[last]) + Σ_s w[s] x[s][p] B[s]; each thread
    //    owns one quad of the state
    const float decay = s_decay;
    for (int i = tid; i < ps * NQ; i += THREADS) {
      const int p = i / NQ, q = i - p * NQ;
      float4 hv = scale4(load4(sh + p * NP + 4 * q), decay);
      for (int s = 0; s < nt; ++s)
        hv = fma4(hv, sw[s] * sx[s * PSLICE + p], load4(sB + s * NP + 4 * q));
      store4(sh + p * NP + 4 * q, hv);
    }
    __syncthreads();
  }

  __syncthreads();                     // also for S = 0: the zeroed state
  float* hb = hout + (static_cast<size_t>(b) * H + head) * static_cast<size_t>(P) * N +
              static_cast<size_t>(p0) * N;
  for (int i = tid; i < ps * N; i += THREADS) {
    const int p = i / N, n = i - p * N;
    hb[static_cast<size_t>(p) * N + n] = sh[p * NP + n];
  }
}

template <typename XT>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* C, float* y, float* h, int batch, int S, int H,
                   int P, int N, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(N);
  auto kernel = ssd_scan_kernel<XT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PSLICE - 1) / PSLICE, H, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const XT*>(x), dt, A, static_cast<const XT*>(Bm),
      static_cast<const XT*>(C), y, h, S, H, P, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x_dtype (x, B, C): 0 = float32, 1 = bfloat16; dt and A are float32.
// y (B,S,H,P) and h (B,H,P,N) are float32. Returns cudaGetLastError()
// after the launch.
extern "C" int ssd_scan_forward(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* C, void* y, void* h,
                                int x_dtype, int batch, int S, int H, int P, int N,
                                void* stream) {
  if (N % 4 != 0 || N <= 0 || N > 256 || P <= 0 || H <= 0 || batch <= 0 || S < 0 ||
      H > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  if (x_dtype == 0) return repro::launch<float>(x, dtf, af, Bm, C, yf, hf, batch, S, H, P, N, st);
  if (x_dtype == 1)
    return repro::launch<__nv_bfloat16>(x, dtf, af, Bm, C, yf, hf, batch, S, H, P, N, st);
  return cudaErrorInvalidValue;
}
