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
//  - bf16 with hd 64, 128 or 256 (the models' prefill: internlm2 and most
//    of the zoo at 128, musicgen at 64, gemma-7b and gemma2-9b at 256):
//    wgmma fed by TMA (fa_fwd_wgmma_kernel, below);
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
//    (loaded once; at hd 256 they would be 64 registers a thread beside
//    O's 128, so there wgmma reads Q from its shared-memory boxes, A and B
//    both through descriptors) and K K-major from the swizzled boxes; O +=
//    P V is wgmma m64nHDk16 with P from registers and V read MN-major straight
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
// At hd 256 (gemma) a 64-row tile of q, k or v is four boxes (32 KB): the
// q tile and 3 K/V stages take 230,400 bytes of shared memory, one CTA an
// SM (2 stages, 164,864 bytes, took 17-26% longer at gemma's shapes on an
// H100 SXM at 700 W).
// O += P V is m64n256k16 over the whole head dim, and the softcap's tanh
// there is a polynomial (cap_scores): tanhf of a quotient, as hd <= 128
// computes it, kept the softmax longer than P V. A key tile's tensor work
// (Q Kᵀ 2.1 MFLOP, P V 4.2 with the residual) reads 128 KB of shared
// memory beside the 64 KB that TMA writes, so shared memory bounds a tile
// as closely as the tensor cores do.
// ptxas -v (nvcc 12.9, sm_90a): the wgmma kernel takes 223 registers at
// hd 256 (255 with a softcap), 193 at hd 128 (195) and 138 at hd 64, with
// no spills; with 160 threads and 112 KB of shared memory at hd 128, two
// CTAs fit an SM.
#include "hopper.cuh"

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
// bf16 path on the tensor cores (hd 64, 128, 256): wgmma fed by TMA (see the
// note at the top), built from hopper.cuh's barriers, TMA loads and wgmma.

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TK = 64;                               // keys per K/V tile
// K/V tiles in the ring; at hd 256 a stage (K + V) is 64 KB, so 3 stages
// and the q tile take 230,400 bytes of the 232,448 a block may have
constexpr int STAGES = 3;
// Q's A fragments stay in registers up to hd 128 (32 a thread); at hd 256
// they would be 64, and with O (128), S (32) and P (32) pass the 255 a
// thread may have, so wgmma reads Q from its shared-memory boxes instead
template <int HD>
__host__ __device__ constexpr bool q_from_smem() { return HD > 128; }
template <int HD>
__host__ __device__ constexpr int qa_steps() { return q_from_smem<HD>() ? 1 : HD / 16; }

// S = Q Kᵀ for one 64-key tile: hd / 16 steps of m64n64k16, K K-major in
// shared memory (a step moves 32 bytes along a 128-byte row, or to the
// next 64-column box); Q from registers (qa) or, at hd 256, K-major from
// the q tile's boxes at the same offsets (q_smem)
template <int HD>
__device__ __forceinline__ void start_qk(float (&s)[32], const uint32_t (&qa)[qa_steps<HD>()][4],
                                         uint32_t q_smem, uint32_t k_smem) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    const uint64_t kd = sw128_desc(k_smem + off, 16, 1024);
    if constexpr (q_from_smem<HD>())
      wgmma_ss_n64_k(s, sw128_desc(q_smem + off, 16, 1024), kd, kk > 0);
    else
      wgmma_rs_n64_k(s, qa[kk], kd, kk > 0);
  }
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
    if constexpr (HD == 256) {
      wgmma_rs_n256(acc, ph[kk], d);
      wgmma_rs_n256(acc, pl[kk], d);
    } else if constexpr (HD == 128) {
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

// A tile's scores, capped and taken to the log2 domain in place:
// softcap·tanh(s·sl / softcap)·log2 e. tanh is an odd polynomial in y
// (least squares in y², within 1e-7 of tanh, relative, for |y| <= 0.75:
// scores up to 0.75 softcap) when every score of the warp lies in that
// range, else tanhf; the scale and the division by softcap are one product
__device__ __forceinline__ void cap_scores(float (&s)[32], float sl, float softcap) {
  const float inv = sl / softcap, cl = softcap * LOG2E;
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    s[j] *= inv;
    amax = fmaxf(amax, fabsf(s[j]));
  }
  if (__all_sync(0xffffffffu, amax <= 0.75f)) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float z = s[j] * s[j];
      float p = fmaf(0.0017231611f, z, -0.0076317866f);
      p = fmaf(p, z, 0.0214339f);
      p = fmaf(p, z, -0.05388652f);
      p = fmaf(p, z, 0.1333259f);
      p = fmaf(p, z, -0.33333308f);
      p = fmaf(p, z, 1.f);
      s[j] = cl * (s[j] * p);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = cl * tanhf(s[j]);
  }
}

// One tile's scores to softmax weights, in place. s is the wgmma
// accumulator: s[4n + e] is row r0 (e < 2) or r0 + 8, key k0 + 8n + 2t +
// (e & 1). Without a cap the scores stay raw and sl = scale·log2 e enters
// the exponent's FMA; with one (sl = scale) they are scaled, capped and
// taken to the log2 domain first, in f32. Keys a row may not see (lo[i]
// < kj < hi[i] is seen) are masked only in tiles that hold some. m: the
// running row maxima (log2 domain); l: the thread's partial row sums; c:
// the factors that rescale the output. POLY caps through cap_scores (the
// hd-256 instances), else through apply_softcap's tanhf of a quotient.
template <bool CAP, bool POLY>
__device__ __forceinline__ void tile_softmax(float (&s)[32], int k0, int t, bool masked,
                                             const int (&lo)[2], const int (&hi)[2], float sl,
                                             float softcap, float (&m)[2], float (&l)[2],
                                             float (&c)[2]) {
  if (CAP && POLY) {
    cap_scores(s, sl, softcap);
  } else if (CAP) {
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
  uint32_t qa[qa_steps<HD>()][4];                      // Q as A fragments, per 16 columns
  if constexpr (!q_from_smem<HD>()) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const uint32_t addr =
            sq + sw128_offset(warp * 16 + g + 8 * (a & 1), 16 * kk + 2 * t + 8 * (a >> 1));
        asm volatile("ld.shared.b32 %0, [%1];" : "=r"(qa[kk][a]) : "r"(addr) : "memory");
      }
  }

  // tile 0's scores and weights
  mbar_wait(full, 0);
  start_qk<HD>(s, qa, sq, ring);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  tile_softmax<CAP, HD == 256>(s, key0(0), t, masked(0), lo, hi, sl, softcap, m, l, c);
  split_p(s, ph, pl);
  // tile j: its Q Kᵀ runs while the output is rescaled; then tile j - 1's
  // P V runs while tile j's softmax does, in its f32 score registers; once
  // that P V is done, tile j's weights become P
  for (int j = 1; j < ntiles; ++j) {
    const int st = j % STAGES, pst = (j - 1) % STAGES;
    mbar_wait(full + 8 * st, (j / STAGES) & 1);
    start_qk<HD>(s, qa, sq, ring + st * 2 * TILE);
    wgmma_commit();
    rescale<HD>(acc, c);
    start_pv<HD>(acc, ph, pl, ring + pst * 2 * TILE + TILE);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(s);
    tile_softmax<CAP, HD == 256>(s, key0(j), t, masked(j), lo, hi, sl, softcap, m, l, c);
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
  // the output tile through the q tile's shared memory (Q is read no
  // more: its wgmma are done in every warp once the barrier passes), then
  // out in 16-byte pieces along whole rows; rows past S are not written
  if constexpr (q_from_smem<HD>()) asm volatile("bar.sync 1, %0;" :: "n"(WG) : "memory");
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
  if (dtype == 1 && hd == 256)
    return softcap > 0.f ? repro::launch_wgmma<256, true>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, softcap, st)
                       : repro::launch_wgmma<256, false>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, softcap, st);
  if (dtype == 1)
    return repro::dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, hd, causal, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
