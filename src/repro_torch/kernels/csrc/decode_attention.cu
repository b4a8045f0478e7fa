// Flash-decoding for Hopper (sm_90a): one query token per row against
// its KV cache, with a per-row cache length.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_dec_kernel, launched by decode_attention_bhgd). It computes the same
// function: for each (b, kv head) the G query heads that share the kv
// head attend to cache rows [lo, cache_len[b]), lo = cache_len[b] -
// window with a window and 0 without, with q scaled by 1/sqrt(hd) before
// the product, the tanh softcap, and an online softmax in f32. Unlike
// the TPU kernel, whose cache_len is one scalar in SMEM, cache_len is a
// (B,) int32 device tensor, so the serving engine's per-row positions
// reach the kernel. It is clamped to [0, S], so a stale length of an
// idle slot stays in bounds. The output has the cache's dtype, as the
// plain decode_attention does.
//
// Layout: q (B,1,Hq,hd) f32 or bf16, caches (B,S,Hkv,hd) f32 or bf16,
// out (B,1,Hq,hd) in the cache dtype. hd <= 256, hd % 4 == 0, G <= 8.
//
// What bounds it on the card: the bytes of the cache rows it reads (each
// k/v element is used by G = Hq/Hkv query heads only, far below the
// card's ~295 operations per byte), so it is a streaming read. What the
// design does about it:
//  - one block of 8 warps per (b, kv head); the block walks the cache
//    only up to cache_len[b], so rows past the fill line cost nothing;
//  - each warp takes chunks of 4 consecutive rows in turn; a lane loads
//    one or two 16-byte quads of each k and v row, so a warp reads a
//    whole row in one coalesced transaction and keeps 8 rows in flight;
//  - the G query heads reuse each loaded row from registers; a score is
//    a 5-step xor-shuffle reduction;
//  - the warps' partial (m, l, acc) merge once through shared memory
//    with the log-sum-exp rule.
// With B·Hkv = 32 blocks on 132 SMs the card is far from full; splitting
// the cache length across blocks (split-K with an LSE merge) is later
// work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;              // cache rows per warp per step
constexpr int GT = 8;                  // most q heads per kv head; g < G guards the rest

template <typename TC, int HD>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const void* __restrict__ q, int q_bf16,
              const TC* __restrict__ kc, const TC* __restrict__ vc,
              const int* __restrict__ cache_len, TC* __restrict__ o,
              int S, int Hq, int Hkv, int hd, int G, int window,
              float scale, float softcap) {
  constexpr int QPL = (HD + 127) / 128;          // quads per lane
  extern __shared__ float smem[];

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nquad = hd / 4;
  const int clen = min(max(cache_len[b], 0), S);
  const int lo = window > 0 ? max(0, clen - window) : 0;

  float4 qf[GT][QPL], acc[GT][QPL];
  float m[GT], l[GT];
  const long q_off = (static_cast<long>(b) * Hq + static_cast<long>(hk) * G) * hd;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < QPL; ++t) {
      const int quad = lane + 32 * t;
      acc[g][t] = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < G && quad < nquad) {
        const long off = q_off + static_cast<long>(g) * hd + 4 * quad;
        x = q_bf16 ? load4(static_cast<const __nv_bfloat16*>(q) + off)
                   : load4(static_cast<const float*>(q) + off);
      }
      qf[g][t] = scale4(x, scale);
    }
  }

  const long row = static_cast<long>(Hkv) * hd;
  const TC* kb = kc + static_cast<long>(b) * S * row + static_cast<long>(hk) * hd;
  const TC* vb = vc + static_cast<long>(b) * S * row + static_cast<long>(hk) * hd;

  for (int base = lo + warp * UNROLL; base < clen; base += WARPS * UNROLL) {
    float4 kk[UNROLL][QPL], vv[UNROLL][QPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int t = 0; t < QPL; ++t) {
        const int quad = lane + 32 * t;
        kk[u][t] = vv[u][t] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (base + u < clen && quad < nquad) {
          kk[u][t] = load4(kb + (base + u) * row + 4 * quad);
          vv[u][t] = load4(vb + (base + u) * row + 4 * quad);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= G) break;                          // warp-uniform
      float s[UNROLL];
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < QPL; ++t) part += dot4(qf[g][t], kk[u][t]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u] = base + u < clen ? apply_softcap(part, softcap) : NEG_INF;
        m_new = fmaxf(m_new, s[u]);
      }
      const float corr = expf(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int t = 0; t < QPL; ++t) acc[g][t] = scale4(acc[g][t], corr);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = base + u < clen ? expf(s[u] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int t = 0; t < QPL; ++t) acc[g][t] = axpy4(acc[g][t], 1.f, p, vv[u][t]);
      }
      m[g] = m_new;
    }
  }

  // merge the warps' partial softmax states: acc (WARPS,G,hd), m, l (WARPS,G)
  float* s_acc = smem;
  float* s_m = s_acc + WARPS * G * hd;
  float* s_l = s_m + WARPS * G;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int t = 0; t < QPL; ++t) {
      const int quad = lane + 32 * t;
      if (quad < nquad) store4(s_acc + (warp * G + g) * hd + 4 * quad, acc[g][t]);
    }
    if (lane == 0) {
      s_m[warp * G + g] = m[g];
      s_l[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  TC* op = o + q_off;
  for (int idx = threadIdx.x; idx < G * hd; idx += THREADS) {
    const int g = idx / hd, d = idx % hd;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_m[w * G + g]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(s_m[w * G + g] - mx);
      den += s_l[w * G + g] * c;
      num += s_acc[(w * G + g) * hd + d] * c;
    }
    store1(op + idx, num / fmaxf(den, 1e-30f));
  }
}

template <typename TC, int HD>
cudaError_t launch(const void* q, int q_bf16, const void* k, const void* v,
                   const int* clen, void* o, int B, int S, int Hq, int Hkv,
                   int hd, int window, float scale, float softcap,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G > GT) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (static_cast<size_t>(WARPS) * G * hd + 2 * WARPS * G);
  auto kernel = decode_kernel<TC, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * Hkv, THREADS, smem, stream>>>(
      q, q_bf16, static_cast<const TC*>(k), static_cast<const TC*>(v), clen,
      static_cast<TC*>(o), S, Hq, Hkv, hd, G, window, scale, softcap);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t dispatch_hd(const void* q, int q_bf16, const void* k, const void* v,
                        const int* clen, void* o, int B, int S, int Hq, int Hkv,
                        int hd, int window, float scale, float softcap, cudaStream_t st) {
  if (hd <= 64) return launch<TC, 64>(q, q_bf16, k, v, clen, o, B, S, Hq, Hkv, hd, window, scale, softcap, st);
  if (hd <= 128) return launch<TC, 128>(q, q_bf16, k, v, clen, o, B, S, Hq, Hkv, hd, window, scale, softcap, st);
  if (hd <= 256) return launch<TC, 256>(q, q_bf16, k, v, clen, o, B, S, Hq, Hkv, hd, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// q_dtype / c_dtype: 0 = float32, 1 = bfloat16. cache_len: (B,) int32 on
// the device. window <= 0 means none; softcap <= 0 means none. Returns
// cudaGetLastError() after the launch.
extern "C" int decode_forward(const void* q, const void* k, const void* v,
                              const void* cache_len, void* o, int q_dtype,
                              int c_dtype, int B, int S, int Hq, int Hkv, int hd,
                              int window, float scale, float softcap, void* stream) {
  if (hd % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0 || q_dtype < 0 || q_dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* clen = static_cast<const int*>(cache_len);
  if (c_dtype == 0)
    return repro::dispatch_hd<float>(q, q_dtype, k, v, clen, o, B, S, Hq, Hkv, hd, window, scale, softcap, st);
  if (c_dtype == 1)
    return repro::dispatch_hd<__nv_bfloat16>(q, q_dtype, k, v, clen, o, B, S, Hq, Hkv, hd, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
