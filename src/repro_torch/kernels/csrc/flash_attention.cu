// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention_bhsd). It computes the same
// function: softmax(q kᵀ / sqrt(hd), causal / sliding-window mask,
// optional tanh softcap) v, with an online softmax in f32 (m, l, acc)
// and q head h reading kv head h / (Hq / Hkv). q is scaled by 1/sqrt(hd)
// before the product on the CUDA-core path, as the TPU kernel does; the
// tensor-core path scales the f32 scores, which is the same up to f32
// rounding and keeps q exact in bf16. A row whose keys are all masked
// gives 0, not NaN: p = exp(s - m) * mask and l >= 1e-30.
//
// Layout: q (B,S,Hq,hd), k/v (B,S,Hkv,hd), out (B,S,Hq,hd), all
// contiguous, f32 or bf16; softmax and sums in f32. hd <= 256 and
// hd % 4 == 0.
//
// What bounds it on the card: at the model's prefill shapes (S <= 512,
// hd = 128, Hq = 16) the card's floor is the bytes (6 MB of q/k/v/out at
// S = 512: 1.9 us), with the causal half's 1.1 GFLOP close behind on the
// bf16 tensor cores (1.1 us). So the products must run on the tensor
// cores, and K/V must be read from device memory about once. Two paths,
// chosen by the input's dtype and head dim:
//  - bf16 with hd 64 or 128 (the model's prefill): mma.sync m16n8k16 on
//    the tensor cores with f32 accumulators (fa_fwd_mma_kernel, below);
//  - f32 (which must meet 2e-5, out of reach of bf16 or TF32 products)
//    and other head dims: f32 FMAs on the CUDA cores (fa_fwd_kernel).
// What both do about it:
//  - one block per (64-row q tile, b·hq); the TPU's sequential KV grid
//    axis becomes a loop inside the block, bounded to the tiles the
//    causal and window masks keep instead of predicating them away;
//  - K/V tiles are staged once per block in shared memory and read by
//    all 64 q rows; the softmax state never leaves registers;
//  - the ragged edge (S not a multiple of 64) is masked in the kernel:
//    K/V rows past S are zero-filled and masked, q rows past S are not
//    written.
// The CUDA-core path stages K/V tiles of 32 rows as f32 (tiles of 32x256
// need the dynamic shared memory opt-in above 48 KB); 4 threads share a
// q row, each holding a quarter of q and of the output accumulator in
// registers (interleaved 16-byte quads, so a warp's shared-memory reads
// hit distinct banks), and a score is two xor-shuffles away from its
// partial sums. wgmma, TMA and warp specialisation are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per shared-memory tile
constexpr int LANES = 4;               // threads per query row
constexpr int THREADS = BQ * LANES;    // 256

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              int S, int Hq, int Hkv, int hd, int causal, int window,
              float scale, float softcap) {
  constexpr int NQ = HD / (4 * LANES);          // quads per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // (BK, hd)
  float* Vs = Ks + BK * hd;                     // (BK, hd)

  const int tid = threadIdx.x;
  const int row = tid / LANES, lane = tid % LANES;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int qi = q0 + row;
  const int nquad = hd / 4;
  const long q_row = static_cast<long>(Hq) * hd;
  const long kv_row = static_cast<long>(Hkv) * hd;
  const T* kb = k + static_cast<long>(b) * S * kv_row + static_cast<long>(hk) * hd;
  const T* vb = v + static_cast<long>(b) * S * kv_row + static_cast<long>(hk) * hd;

  float4 qf[NQ], acc[NQ];
  const T* qp = q + (static_cast<long>(b) * S + qi) * q_row + static_cast<long>(h) * hd;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const int quad = lane + LANES * j;
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    qf[j] = (qi < S && quad < nquad) ? scale4(load4(qp + 4 * quad), scale)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF, l = 0.f;

  // keys any row of this tile can see: [kv_lo, kv_hi)
  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int t = kv_lo / BK; t * BK < kv_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();                             // previous tile consumed
    for (int idx = tid; idx < BK * nquad; idx += THREADS) {
      const int r = idx / nquad, cq = idx % nquad, kj = k0 + r;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kj < S) {
        kk = load4(kb + kj * kv_row + 4 * cq);
        vv = load4(vb + kj * kv_row + 4 * cq);
      }
      store4(Ks + r * hd + 4 * cq, kk);
      store4(Vs + r * hd + 4 * cq, vv);
    }
    __syncthreads();

    float s[BK];
    unsigned keep = 0u;
    float m_new = m;
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int quad = lane + LANES * j;
        if (quad < nquad) part += dot4(qf[j], load4(Ks + r * hd + 4 * quad));
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + r;
      const bool ok = kj < S && (!causal || kj <= qi) &&
                      (window <= 0 || kj > qi - window);
      s[r] = ok ? apply_softcap(part, softcap) : NEG_INF;
      keep |= static_cast<unsigned>(ok) << r;
      m_new = fmaxf(m_new, s[r]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc[j] = scale4(acc[j], corr);
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      const float p = ((keep >> r) & 1u) ? expf(s[r] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int quad = lane + LANES * j;
        if (quad < nquad) acc[j] = axpy4(acc[j], 1.f, p, load4(Vs + r * hd + 4 * quad));
      }
    }
    m = m_new;
  }

  if (qi < S) {
    const float lc = fmaxf(l, 1e-30f);
    T* op = o + (static_cast<long>(b) * S + qi) * q_row + static_cast<long>(h) * hd;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int quad = lane + LANES * j;
      if (quad < nquad)
        store4(op + 4 * quad, make_float4(acc[j].x / lc, acc[j].y / lc,
                                          acc[j].z / lc, acc[j].w / lc));
    }
  }
}

// ---------------------------------------------------------------------
// bf16 path on the tensor cores (hd 64 or 128): mma.sync m16n8k16 with
// f32 accumulators. A block is 4 warps over 64 q rows, 16 rows a warp;
// each thread holds its two rows' (m, l) and a 16 x hd slice of the
// output in the mma accumulator layout. Per 64-key tile: S = Q Kᵀ from
// Q fragments in registers and K in shared memory, scaled and capped in
// f32, masked, online softmax in the log2 domain, then P times V, with V
// stored transposed in shared memory so its B fragments are 32-bit
// reads. The TPU kernel multiplies f32 P by V turned f32; here P is split
// into a bf16 high part and a bf16 residual, each multiplied by V (exact
// in bf16) in its own mma. The pair holds 16 of P's 24 bits (relative
// error <= 2^-18), which leaves the bf16 output within half a bf16 step of
// the f32 result plus 2^-16 max|v|; P rounded to bf16 once would not.
// Rows of K and of Vᵀ are padded by 8 elements so a warp's fragment reads
// fall in 32 distinct banks.

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (lo, hi) as bf16 pairs: hi2 = bf16(x), lo2 = bf16(x - hi2), elementwise
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& hi2,
                                           uint32_t& lo2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 hf = __bfloat1622float2(h);
  hi2 = *reinterpret_cast<const uint32_t*>(&h);
  lo2 = pack_bf16(lo - hf.x, hi - hf.y);
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv,
                  int causal, int window, float scale, float softcap) {
  constexpr int TK = 64;                 // keys per tile
  constexpr int KSTR = HD + 8;           // padded row of K in shared memory
  constexpr int VSTR = TK + 8;           // padded row of Vᵀ in shared memory
  constexpr int NKS = HD / 16;           // k-steps of Q Kᵀ over the head dim
  constexpr int NN = TK / 8;             // n-tiles of S
  constexpr int NO = HD / 8;             // n-tiles of O
  __shared__ __align__(16) __nv_bfloat16 Ks[TK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD * VSTR];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const long q_row = static_cast<long>(Hq) * HD;
  const long kv_row = static_cast<long>(Hkv) * HD;
  const __nv_bfloat16* kb = k + static_cast<long>(b) * S * kv_row + static_cast<long>(hk) * HD;
  const __nv_bfloat16* vb = v + static_cast<long>(b) * S * kv_row + static_cast<long>(hk) * HD;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;     // this thread's two rows

  // Q as A fragments: reg 0/2 row r0, reg 1/3 row r1; columns 2t, 2t+8
  uint32_t qa[NKS][4];
  const __nv_bfloat16* qp0 = q + (static_cast<long>(b) * S + r0) * q_row + static_cast<long>(h) * HD;
  const __nv_bfloat16* qp1 = qp0 + 8 * q_row;
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = r0 < S ? ld32(qp0 + c) : 0u;
    qa[ks][1] = r1 < S ? ld32(qp1 + c) : 0u;
    qa[ks][2] = r0 < S ? ld32(qp0 + c + 8) : 0u;
    qa[ks][3] = r1 < S ? ld32(qp1 + c + 8) : 0u;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // log2 domain

  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (kv_lo / TK) * TK; k0 < kv_hi; k0 += TK) {
    __syncthreads();                                   // previous tile consumed
    for (int idx = tid; idx < TK * (HD / 8); idx += MMA_THREADS) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8, kj = k0 + r;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (kj < S) {
        kk = *reinterpret_cast<const uint4*>(kb + kj * kv_row + c);
        vv = *reinterpret_cast<const uint4*>(vb + kj * kv_row + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * KSTR + c) = kk;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * VSTR + r] = ve[i];
    }
    __syncthreads();

    float s[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (n * 8 + g) * KSTR + 2 * t;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
        mma_bf16(s[n], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    }

    // scale, cap and mask in f32; row maxima over the quad of threads
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = kj < S && (!causal || kj <= row) &&
                        (window <= 0 || kj > row - window);
        s[n][e] = ok ? apply_softcap(s[n][e] * scale, softcap) * LOG2E : NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, s[n][e]); else mx1 = fmaxf(mx1, s[n][e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= c0; acc[n][1] *= c0;
      acc[n][2] *= c1; acc[n][3] *= c1;
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] == NEG_INF ? 0.f : exp2f(s[n][e] - (e < 2 ? mx0 : mx1));
        s[n][e] = p;
        if (e < 2) l0 += p; else l1 += p;
      }
    }
    m0 = mx0;
    m1 = mx1;

    // O += P V: the S accumulators of n-tiles 2j, 2j+1 are the A fragment
    // of keys 16j..16j+15, as a bf16 high part and a bf16 residual
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* e = &s[2 * j + i / 2][2 * (i % 2)];
        split_bf16(e[0], e[1], ph[i], pl[i]);
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vr = Vt + (n * 8 + g) * VSTR + j * 16 + 2 * t;
        const uint32_t b0 = ld32(vr), b1 = ld32(vr + 8);
        mma_bf16(acc[n], ph, b0, b1);
        mma_bf16(acc[n], pl, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* op0 = o + (static_cast<long>(b) * S + r0) * q_row + static_cast<long>(h) * HD + 2 * t;
  __nv_bfloat16* op1 = op0 + 8 * q_row;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(op0 + n * 8) = pack_bf16(acc[n][0] * i0, acc[n][1] * i0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(op1 + n * 8) = pack_bf16(acc[n][2] * i1, acc[n][3] * i1);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Hq, int Hkv, int causal, int window,
                       float scale, float softcap, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * Hq);
  fa_fwd_mma_kernel<HD><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, Hq, Hkv, causal, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Hq, int Hkv, int hd, int causal,
                   int window, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = 2ull * BK * hd * sizeof(float);
  auto kernel = fa_fwd_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * Hq);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      S, Hq, Hkv, hd, causal, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Hq, int Hkv, int hd, int causal,
                        int window, float scale, float softcap, cudaStream_t st) {
  if (hd <= 64) return launch<T, 64>(q, k, v, o, B, S, Hq, Hkv, hd, causal, window, scale, softcap, st);
  if (hd <= 128) return launch<T, 128>(q, k, v, o, B, S, Hq, Hkv, hd, causal, window, scale, softcap, st);
  if (hd <= 256) return launch<T, 256>(q, k, v, o, B, S, Hq, Hkv, hd, causal, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means none; softcap <= 0
// means none. Returns cudaGetLastError() after the launch.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int dtype, int B, int S, int Hq, int Hkv, int hd,
                          int causal, int window, float scale, float softcap,
                          void* stream) {
  if (hd % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::dispatch_hd<float>(q, k, v, o, B, S, Hq, Hkv, hd, causal, window, scale, softcap, st);
  if (dtype == 1 && hd == 64)
    return repro::launch_mma<64>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, softcap, st);
  if (dtype == 1 && hd == 128)
    return repro::launch_mma<128>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, softcap, st);
  if (dtype == 1)
    return repro::dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, hd, causal, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
