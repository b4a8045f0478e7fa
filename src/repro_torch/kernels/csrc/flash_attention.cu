// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel :28, launched by flash_attention_bhsd :82, pallas_call
// :102). It computes the same function: softmax(q kᵀ / sqrt(hd), causal /
// sliding-window mask, optional tanh softcap) v, with an online softmax
// in f32 (m, l, acc) and q head h reading kv head h / (Hq / Hkv). A row
// whose keys are all masked gives 0, not NaN (l >= 1e-30). q rows past S
// are not written.
//
// Layout: q (B,S,Hq,hd), k/v (B,S,Hkv,hd), out (B,S,Hq,hd), all
// contiguous, f32 or bf16; softmax and sums in f32. hd <= 256 and
// hd % 4 == 0. Two paths, chosen by dtype and head dim:
//  - bf16 with hd 64 or 128 (the model's prefill): wgmma fed by TMA
//    (fa_fwd_wgmma_kernel, below);
//  - f32 (which must meet 2e-5, out of reach of bf16 or TF32 products)
//    and other head dims: f32 FMAs on the CUDA cores (fa_fwd_kernel): 4
//    threads a q row, K/V staged as f32 in tiles of 32 rows, q scaled by
//    1/sqrt(hd) before the product as the TPU kernel does.
//
// What bounds the bf16 path at the model's prefill shapes (B = 1, Hq 16,
// Hkv 8, hd 128, S = 8..1024 by the engine's buckets): not bytes (6 MB
// and 1.9 us at S = 512) nor the tensor cores' rate (1.1 GFLOP, 1.1 us),
// but latency. At S = 512 the grid is 8 q tiles x 16 heads = 128 CTAs,
// one wave on 132 SMs, and the time is the last q tile's walk over its 8
// key tiles, one after another. So the design shortens each step of that
// walk and hides what it can behind it:
//  - one CTA per (64-row q tile, q head) with one consumer warpgroup and
//    one producer warp; the q tiles with the most key tiles launch first
//    (at S = 1024, 256 CTAs, two an SM);
//  - K/V reach shared memory by TMA, in a ring of 3 stages with an
//    mbarrier pair each: the producer thread keeps tiles in flight while
//    the warpgroup computes. The tensor maps are 4-D over (hd, Hkv, S, B)
//    of the contiguous tensor, in 128-byte-swizzled boxes of 64 columns x
//    64 rows of one head and batch: rows past S arrive as zeros and a box
//    never reads into the next batch, which is how ragged lengths are
//    handled. The maps are encoded on the host for every call (three
//    cuTensorMapEncodeTiled; chip_smoke.py times the wrapper's host cost),
//    the function taken once through the runtime's entry-point query
//    (cudaGetDriverEntryPoint), so the library links no -lcuda;
//  - S = Q Kᵀ is wgmma m64n64k16 with Q's A fragments in registers
//    (loaded once) and K K-major from the swizzled boxes; O += P V is
//    wgmma m64nHDk16 with P from registers and V read MN-major straight
//    from its TMA boxes (no transpose of V anywhere). P is not rounded to
//    bf16 once, which the TPU kernel (P in f32) would not do: it is split
//    into a bf16 high part and a bf16 residual, two wgmma per 16 keys,
//    which keeps bf16 outputs within half a bf16 step of the f32 result
//    plus 2^-16 max|v|;
//  - tile j's Q Kᵀ starts before tile j - 1's P V, and tile j's
//    softmax (scale, cap, masks only in the tiles that need them, log2
//    domain, ex2.approx) runs while that P V does; P is repacked once it
//    is done. Deeper overlap (tile j + 1's Q Kᵀ during tile j's softmax)
//    made ptxas serialize every wgmma;
//  - the causal and window bounds limit each q tile's walk to the key
//    tiles it can see; the output leaves through shared memory in 16-byte
//    stores along whole rows.
// ptxas -v (nvcc 12.9, sm_90a): the wgmma kernel takes 193 registers at
// hd 128 (195 with a softcap) and 138 at hd 64, with no spills; with
// 160 threads and 112 KB of shared memory at hd 128, two CTAs fit an SM.
#include <cuda.h>

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
// bf16 path on the tensor cores (hd 64 or 128): wgmma fed by TMA (see the
// note at the top).

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TK = 64;                               // keys per K/V tile
constexpr uint32_t BOX_BYTES = 64 * 64 * 2;          // 64 rows x 64 bf16 columns
constexpr int WG = 128;                              // threads of a warpgroup
constexpr int STAGES = 3;                            // K/V tiles in the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

// arrive once and expect `bytes` of asynchronous copies on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA: one box of 64 head-dim columns x 64 rows of one head and batch of
// a (B,S,H,hd) tensor into shared memory, 128-byte swizzled; rows past S
// arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(head), "r"(row), "r"(batch) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled operand at
// `addr` (1024-byte aligned swizzle atoms of 8 rows): `lbo` is the byte
// stride between 64-column boxes along a MN-major operand's contiguous
// dimension (unused for K-major), `sbo` between 8-row groups
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keep the compiler from touching registers an asynchronous wgmma owns
// across the point where this stands (its reads and writes stay on their
// side of the preceding wgmma_wait).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i / 4][i % 4]) :: "memory");
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// D (64 x 64, f32) (+)= A (64 x 16, registers) * B (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
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

// S = Q Kᵀ for one 64-key tile: hd / 16 steps of m64n64k16, Q from
// registers, K K-major in shared memory (a step moves 32 bytes along a
// 128-byte row, or to the next 64-column box)
template <int HD>
__device__ __forceinline__ void start_qk(float (&s)[32], const uint32_t (&qa)[HD / 16][4],
                                         uint32_t k_smem) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_rs_n64_k(s, qa[kk], sw128_desc(k_smem + off, 16, 1024), kk > 0);
  }
}

// byte offset of (row r, column c) in a tile of 64-column boxes as TMA
// writes them, 128-byte swizzled
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (c / 64) * BOX_BYTES + r * 128 + ((((c % 64) / 8) ^ (r % 8)) << 4) + (c % 8) * 2;
}

// O += P V for one 64-key tile: P from registers as a bf16 high part and
// a bf16 residual, V read MN-major from its TMA boxes (16 keys a step)
template <int HD>
__device__ __forceinline__ void start_pv(float (&acc)[HD / 2], const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4], uint32_t v_smem) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    const uint64_t d = sw128_desc(v_smem + kk * 16 * 128, BOX_BYTES, 1024);
    if constexpr (HD == 128) {
      wgmma_rs_n128(acc, ph[kk], d);
      wgmma_rs_n128(acc, pl[kk], d);
    } else {
      wgmma_rs_n64(acc, ph[kk], d);
      wgmma_rs_n64(acc, pl[kk], d);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's scores to softmax weights, in place. s is the wgmma
// accumulator: s[4n + e] is row r0 (e < 2) or r0 + 8, key k0 + 8n + 2t +
// (e & 1). Without a cap the scores stay raw and sl = scale·log2 e enters
// the exponent's FMA; with one (sl = scale) they are scaled, capped and
// taken to the log2 domain first, in f32. Keys a row may not see (lo[i]
// < kj < hi[i] is seen) are masked only in tiles that hold some. m: the
// running row maxima (log2 domain); l: the thread's partial row sums; c:
// the factors that rescale the output.
template <bool CAP>
__device__ __forceinline__ void tile_softmax(float (&s)[32], int k0, int t, bool masked,
                                             const int (&lo)[2], const int (&hi)[2], float sl,
                                             float softcap, float (&m)[2], float (&l)[2],
                                             float (&c)[2]) {
  if (CAP) {
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = apply_softcap(s[j] * sl, softcap) * LOG2E;
  }
  if (masked) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1, kj = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
      if (kj <= lo[i] || kj >= hi[i]) s[j] = NEG_INF;
    }
  }
  float mx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) x[n] = fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]);
#pragma unroll
    for (int w = 4; w > 0; w /= 2)
#pragma unroll
      for (int n = 0; n < w; ++n) x[n] = fmaxf(x[n], x[n + w]);
    mx[i] = x[0];
  }
  float mref[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float mn = fmaxf(m[i], CAP || mx[i] == NEG_INF ? mx[i] : mx[i] * sl);
    c[i] = ex2(m[i] - mn);
    l[i] *= c[i];
    m[i] = mn;
    mref[i] = mn == NEG_INF ? 0.f : mn;      // a row with no key yet: every p is 0
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = (j >> 1) & 1;
    s[j] = CAP ? ex2(s[j] - mref[i]) : ex2(fmaf(s[j], sl, -mref[i]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) x[n] = s[4 * n + 2 * i] + s[4 * n + 2 * i + 1];
#pragma unroll
    for (int w = 4; w > 0; w /= 2)
#pragma unroll
      for (int n = 0; n < w; ++n) x[n] += x[n + w];
    l[i] += x[0];
  }
}

// The weights as A fragments of 16 keys each: a bf16 high part and a
// bf16 residual
__device__ __forceinline__ void split_p(const float (&s)[32], uint32_t (&ph)[4][4],
                                        uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a)
      split_bf16(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1], ph[kk][a], pl[kk][a]);
}

template <int HD>
__device__ __forceinline__ void rescale(float (&acc)[HD / 2], const float (&c)[2]) {
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] *= c[(j >> 1) & 1];
}

// One CTA per (64-row q tile, q head): a consumer warpgroup and a
// producer warp. The q tiles with the most key tiles go first.
template <int HD, bool CAP>
__global__ void __launch_bounds__(WG + 32)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv, int causal,
                    int window, float scale, float softcap) {
  constexpr uint32_t TILE = (HD / 64) * BOX_BYTES;   // one 64-row tile of q, k or v
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;   // the q tile
  const uint32_t ring = sq + TILE;                   // STAGES x (K tile, V tile)
  const uint32_t qbar = smem_u32(&bars[0]);
  const uint32_t full = qbar + 8, empty = full + 8 * STAGES;

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / (Hq / Hkv);
  // the key tiles any row of this q tile can see (causal and window bounds)
  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / TK, ntiles = (kv_hi + TK - 1) / TK - t_lo;
  auto key0 = [&](int j) { return (t_lo + j) * TK; };
  // K and V tile j into ring stage j % STAGES
  auto load_kv = [&](int j) {
    const int st = j % STAGES;
    const uint32_t dst = ring + st * 2 * TILE;
    mbar_expect_tx(full + 8 * st, 2 * TILE);
    for (int c = 0; c < HD / 64; ++c) {
      tma_load(dst + c * BOX_BYTES, &tk, full + 8 * st, 64 * c, hk, key0(j), b);
      tma_load(dst + TILE + c * BOX_BYTES, &tv, full + 8 * st, 64 * c, hk, key0(j), b);
    }
  };

  if (threadIdx.x == WG) {
    // the producer sets up the barriers and sends Q and the first K/V
    // tiles on their way before the CTA syncs
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    mbar_init(qbar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(qbar, TILE);
    for (int c = 0; c < HD / 64; ++c) tma_load(sq + c * BOX_BYTES, &tq, qbar, 64 * c, h, q0, b);
    for (int j = 0; j < min(ntiles, STAGES); ++j) load_kv(j);
  }
  __syncthreads();
  if (threadIdx.x >= WG) {
    // then the other K/V tiles, each as its ring slot frees up
    if (threadIdx.x == WG) {
      for (int j = STAGES; j < ntiles; ++j) {
        mbar_wait(empty + 8 * (j % STAGES), ((j / STAGES) & 1) ^ 1);
        load_kv(j);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g;                   // this thread's rows r0, r0 + 8
  const float sl = CAP ? scale : scale * LOG2E;
  int lo[2], hi[2];                                    // row i sees keys lo < kj < hi
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    hi[i] = causal ? min(S, r0 + 8 * i + 1) : S;
    lo[i] = window > 0 ? r0 + 8 * i - window : -1;
  }
  auto masked = [&](int j) {                           // does tile j hide any key from a row?
    const int k0 = key0(j);
    return k0 + TK > S || (causal && k0 + TK - 1 > q0) ||
           (window > 0 && k0 <= q0 + BQ - 1 - window);
  };
  float acc[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, c[2];
  float s[32];
  uint32_t ph[4][4], pl[4][4];

  mbar_wait(qbar, 0);
  uint32_t qa[HD / 16][4];                             // Q as A fragments, per 16 columns
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const uint32_t addr =
          sq + sw128_offset(warp * 16 + g + 8 * (a & 1), 16 * kk + 2 * t + 8 * (a >> 1));
      asm volatile("ld.shared.b32 %0, [%1];" : "=r"(qa[kk][a]) : "r"(addr) : "memory");
    }

  // tile 0's scores and weights
  mbar_wait(full, 0);
  start_qk<HD>(s, qa, ring);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  tile_softmax<CAP>(s, key0(0), t, masked(0), lo, hi, sl, softcap, m, l, c);
  split_p(s, ph, pl);
  // tile j: its Q Kᵀ runs while the output is rescaled; then tile j - 1's
  // P V runs while tile j's softmax does, in its f32 score registers; once
  // that P V is done, tile j's weights become P
  for (int j = 1; j < ntiles; ++j) {
    const int st = j % STAGES, pst = (j - 1) % STAGES;
    mbar_wait(full + 8 * st, (j / STAGES) & 1);
    start_qk<HD>(s, qa, ring + st * 2 * TILE);
    wgmma_commit();
    rescale<HD>(acc, c);
    start_pv<HD>(acc, ph, pl, ring + pst * 2 * TILE + TILE);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(s);
    tile_softmax<CAP>(s, key0(j), t, masked(j), lo, hi, sl, softcap, m, l, c);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(ph);
    reg_fence(pl);
    mbar_arrive(empty + 8 * pst);
    split_p(s, ph, pl);
  }
  // the last tile's P V
  rescale<HD>(acc, c);
  start_pv<HD>(acc, ph, pl, ring + ((ntiles - 1) % STAGES) * 2 * TILE + TILE);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = __frcp_rn(fmaxf(l[i], 1e-30f));            // a row with no visible key gives 0
  }
  // the output tile through the q tile's shared memory (Q has been in
  // registers since the start), then out in 16-byte pieces along whole
  // rows; rows past S are not written
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t v = pack_bf16(acc[4 * n + 2 * i] * l[i], acc[4 * n + 2 * i + 1] * l[i]);
      // row warp * 16 + g + 8i (g modulo 8), 16-byte chunk n of the row
      const uint32_t dst = sq + (n / 8) * BOX_BYTES + (warp * 16 + g + 8 * i) * 128 +
                           (((n % 8) ^ g) << 4) + 4 * t;
      asm volatile("st.shared.b32 [%0], %1;" :: "r"(dst), "r"(v) : "memory");
    }
  }
  asm volatile("bar.sync 1, %0;" :: "n"(WG) : "memory");
  const long q_row = static_cast<long>(Hq) * HD;
  __nv_bfloat16* ob = o + (static_cast<long>(b) * S + q0) * q_row + static_cast<long>(h) * HD;
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    const int idx = k * WG + tid, r = idx / (HD / 8), col = (idx % (HD / 8)) * 8;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(sq + sw128_offset(r, col)) : "memory");
    if (q0 + r < S) *reinterpret_cast<uint4*>(ob + r * q_row + col) = v;
  }
}

// cuTensorMapEncodeTiled, taken from libcuda through the runtime's
// entry-point query so that the library links no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous (B,S,H,hd) bf16 tensor as 4-D (hd, H, S,
// B), innermost first, in boxes of 64 columns x 64 rows of one head and
// batch: a box past S zero-fills its rows and never reads the next batch.
CUresult encode_bshd(EncodeTiled encode, CUtensorMap* map, const void* base, int B, int S,
                     int H, int hd) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * H * hd, 2ull * S * H * hd};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD, bool CAP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S, int Hq,
                 int Hkv, int causal, int window, float scale, float softcap,
                 cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult res = encode_bshd(encode, &tq, q, B, S, Hq, HD);
  if (res == CUDA_SUCCESS) res = encode_bshd(encode, &tk, k, B, S, Hkv, HD);
  if (res == CUDA_SUCCESS) res = encode_bshd(encode, &tv, v, B, S, Hkv, HD);
  if (res != CUDA_SUCCESS) return static_cast<int>(res);
  auto kernel = fa_fwd_wgmma_kernel<HD, CAP>;
  const size_t smem = (1 + 2 * STAGES) * (HD / 64) * BOX_BYTES + 1024;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  kernel<<<grid, WG + 32, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Hq,
                                          Hkv, causal, window, scale, softcap);
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
    return softcap > 0.f ? repro::launch_wgmma<64, true>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, softcap, st)
                       : repro::launch_wgmma<64, false>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, softcap, st);
  if (dtype == 1 && hd == 128)
    return softcap > 0.f ? repro::launch_wgmma<128, true>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, softcap, st)
                       : repro::launch_wgmma<128, false>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, softcap, st);
  if (dtype == 1)
    return repro::dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, hd, causal, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
