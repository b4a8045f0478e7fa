// Mamba2 SSD scan for Hopper (sm_90a): the chunked state-space-duality
// scan of one prompt, carrying the recurrent state through the sequence.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel :28, launched by ssd_scan_pallas :74, pallas_call :91). It
// computes the same function: for each (b, head), with dA = dt·A and cum
// its running sum inside a chunk of tokens,
//   y[t]  = Σ_{s≤t} (C[t]·B[s]) exp(cum[t] − cum[s]) dt[s] x[s]
//         + exp(cum[t]) C[t]·h            (h: state entering the chunk)
//   h    <- h exp(cum[last]) + Σ_s exp(cum[last] − cum[s]) dt[s] x[s] B[s]ᵀ
// and returns y (B,S,H,P) f32 and the state after the last token
// (B,H,P,N) f32. SSD is exact for any chunk length up to rounding, so the
// kernels walk chunks of 64 tokens whatever chunk the caller names.
//
// Layout: x (B,S,H,P) and B, C (B,S,N) f32 or bf16 (one dtype); dt
// (B,S,H) and A (H,) f32. Any S >= 0: rows past S are loaded as zeros
// (dt = 0, so they neither decay nor feed the state) and never stored.
// exp is taken only of cum[t] − cum[s] with s ≤ t, as one difference
// (never exp(cum[t])·exp(−cum[s])): every argument is ≤ 0, so nothing
// overflows and no inf meets a zero. Where the TPU kernel differs: its
// grid walks the chunks in order on one core with the state in VMEM;
// here the chunks run in parallel and the state passes between them in
// a pass of its own. Two paths, chosen by the C entry by dtype and shape
// (tensor_core_path, below):
//
// 1. bf16 x/B/C with P % 16 == 0 and N 64 or 128 (mamba2-2.7b's prefill:
//    P = 64, N = 128, H = 80, ngroups = 1): two launches on the tensor
//    cores, each block one warpgroup, x, B and C brought to shared memory
//    by TMA in 128-byte-swizzled boxes of 64 rows (rows past S and head
//    dims past P arrive as zeros), every product a wgmma with A from
//    registers:
//     - states (ssd_state_kernel): a block per (64 state columns, 64 head
//       dims, head, batch) walks the 64-token chunks in order, the next
//       four chunks' boxes in flight in a ring. Per chunk: cum by a
//       shuffle scan in each warp, w[s] = exp(cum[last] − cum[s]) dt[s],
//       the chunk's own state S_c = (w∘x)ᵀ·B (m64n64k16 over its tokens,
//       B read MN-major); the state entering it goes to an f32 scratch in
//       the accumulator's own order and h <- h·exp(cum[last]) + S_c in
//       registers. The last h is the final state.
//     - output (ssd_output_kernel): a block per (chunk, head, 64 head
//       dims): C·h_inᵀ (m64n64, K = N) scaled by exp(cum[t]) per row,
//       CB = C·Bᵀ (B read K-major from the same box as the state pass),
//       M = CB·exp(cum[t] − cum[s])·dt[s] for s ≤ t formed in CB's
//       accumulator registers, and M·x (K = 64 tokens, x read MN-major)
//       added to the same sum; y in f32.
//    At S ≤ 64 one launch (ssd_single_kernel) whose blocks do either role
//    on the one chunk, no state entering it.
//    Numerics: B and C are bf16 and their products exact. The f32
//    operands — w∘x, M and h_in — enter the tensor cores as three bf16
//    terms, three wgmma each (24 significant bits, f32's); the first
//    term's products are summed in one accumulator and the two smaller
//    terms' in another, and CB's k-steps are dealt round three, each pair
//    added on the CUDA cores: a tensor-core step truncates the sum it adds
//    to, and the fewer full-size steps one accumulator takes, the closer
//    the result stays to f32 sums. cum, the decays and the state stay in
//    f32, and cum[last] is read at the last real row (an ulp of cum is a
//    relative error of every decay). With two terms, or CB in one
//    accumulator, every per-layer check held but mamba2's logits left
//    their limit at an 8-token prompt.
//    What bounds it: bytes. At B = 1, S = 512, H = 80, P = 64, N = 128
//    the function reads x, B, C, dt (5.7 MB) and writes y and h (13.1 MB):
//    18.8 MB, 0.0056 ms at 3.35 TB/s, against 1.34 GFLOP (4PN per token
//    and head), 0.0014 ms on the bf16 tensor cores. The scratch (21 MB at
//    S = 512, written once and read once) stays mostly in the 50 MB L2;
//    what is left is the chain of chunks each state block walks and the
//    latency of each block's loads.
//
// 2. Any other input (f32, the JAX tests' shapes): the CUDA-core kernel,
//    ssd_scan_cuda_core_kernel, in f32 FMAs:
//  - one block per (b, head, slice of PSLICE head dims) walks the whole
//    sequence in a loop and keeps its (PSLICE, N) f32 state in shared
//    memory (16.5 KB at N = 128); N % 4 == 0, N <= 256;
//  - C·Bᵀ is recomputed per block, with shared-memory operands read as
//    16-byte quads or broadcasts; bound by shared-memory bandwidth.
#include "hopper.cuh"

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
ssd_scan_cuda_core_kernel(const XT* __restrict__ x, const float* __restrict__ dt,
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
cudaError_t launch_cuda_core(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* C, float* y, float* h, int batch, int S, int H,
                   int P, int N, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(N);
  auto kernel = ssd_scan_cuda_core_kernel<XT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PSLICE - 1) / PSLICE, H, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const XT*>(x), dt, A, static_cast<const XT*>(Bm),
      static_cast<const XT*>(C), y, h, S, H, P, N);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------
// bf16 path on the tensor cores (see the note at the top)

constexpr int CL = 64;                 // tokens per chunk
constexpr int PT = 64;                 // head dims per block: one TMA box
constexpr int TERMS = 3;               // bf16 terms of an f32 operand
constexpr int STAGES = 4;              // chunks in flight in the state pass's ring

// A chunk's dt and cum = the running sum of dt·A, computed by every warp
// on its own (a shuffle scan, no shared memory): lane l holds tokens 2l
// and 2l + 1; dt = 0 past the chunk's last real row.
struct ChunkScan {
  float d0, d1, c0, c1;
};

__device__ __forceinline__ float2 load_dt(const float* __restrict__ dtc, int H, int nt) {
  const int lane = threadIdx.x % 32;
  return make_float2(2 * lane < nt ? dtc[static_cast<size_t>(2 * lane) * H] : 0.f,
                     2 * lane + 1 < nt ? dtc[static_cast<size_t>(2 * lane + 1) * H] : 0.f);
}

__device__ __forceinline__ ChunkScan chunk_scan(float2 d, float a) {
  const int lane = threadIdx.x % 32;
  ChunkScan k;
  k.d0 = d.x;
  k.d1 = d.y;
  const float a0 = k.d0 * a, a1 = k.d1 * a;
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.f;
  k.c0 = excl + a0;
  k.c1 = excl + a0 + a1;
  return k;
}

__device__ __forceinline__ float ld_shared_bf16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr) : "memory");
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// float offset of the state entering chunk c of one (batch, head, 64 head
// dims) in the scratch: 64 x N floats in the accumulator's order (below)
__device__ __forceinline__ size_t state_offset(int b, int c, int head, int pt, int nc, int H,
                                               int PS, int N) {
  return ((((static_cast<size_t>(b) * nc + c) * H + head) * PS + pt) * PT) * N;
}

// An m64n64 accumulator: thread tid's float4 j holds rows r, r + 8 (r =
// 16·warp + lane/4) at columns 8j + 2·(lane%4) and the one after. The
// scratch keeps float4 j of a tile's 64 state columns 64q.. at index
// (8q + j)·WG + tid, coalesced for the writer and the reader; this
// writes one such float4 into the (P, N) state of a head, rows past P not
// at all.
__device__ __forceinline__ void store_state4(float* __restrict__ hh, int P, int N, int pt,
                                             int col0, int tid, float4 v) {
  const int lane = tid % 32;
  const int r = PT * pt + (tid / 32) * 16 + lane / 4, col = col0 + 2 * (lane % 4);
  if (r < P)
    *reinterpret_cast<float2*>(hh + static_cast<size_t>(r) * N + col) = make_float2(v.x, v.y);
  if (r + 8 < P)
    *reinterpret_cast<float2*>(hh + static_cast<size_t>(r + 8) * N + col) = make_float2(v.z, v.w);
}

// Pass 1: the states. One block per (64 state columns 64q.., 64 head dims
// PT·pt.., head, batch) walks the chunks in order, the x and B boxes of
// the next STAGES chunks in flight by TMA. Per chunk: w[s] = exp(cum[last]
// − cum[s]) dt[s]; the chunk's own state S_c = (w∘x)ᵀ·B, an m64n64k16
// chain over its 64 tokens with A from registers (TERMS bf16 terms; the
// first term into one accumulator, the rest into another, added on the
// CUDA cores) and B read MN-major; then h_in[c] = h goes to the scratch
// (c ≥ 1) and h <- h·exp(cum[last]) + S_c, in f32 registers. The last h
// is the final state.
__device__ __forceinline__ void state_body(const CUtensorMap* tx, const CUtensorMap* tb,
                                           const float* __restrict__ dt,
                                           const float* __restrict__ A,
                                           float* __restrict__ states, float* __restrict__ hout,
                                           int q, int pt, int head, int b, int S, int H, int P,
                                           int N, int nc, uint32_t ring, uint32_t full) {
  const int PS = (P + PT - 1) / PT, stages = min(STAGES, nc);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  auto load = [&](int c) {                           // chunk c into ring stage c % stages
    const uint32_t xs = ring + (c % stages) * 2 * BOX_BYTES, bar = full + 8 * (c % stages);
    mbar_expect_tx(bar, 2 * BOX_BYTES);
    tma_load(xs, tx, bar, PT * pt, head, c * CL, b);
    tma_load(xs + BOX_BYTES, tb, bar, 64 * q, 0, c * CL, b);
  };
  if (tid == 0) {
    prefetch_map(tx);
    prefetch_map(tb);
    for (int st = 0; st < stages; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 0; c < stages; ++c) load(c);
  }
  const float a = A[head];
  const float* dth = dt + static_cast<size_t>(b) * S * H + head;
  float2 dnext = load_dt(dth, H, min(CL, S));
  float h[32];
  zero(h);
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    const ChunkScan k = chunk_scan(dnext, a);
    if (c + 1 < nc) dnext = load_dt(dth + static_cast<size_t>(c + 1) * CL * H, H,
                                    min(CL, S - (c + 1) * CL));
    // cum at the chunk's last real row, not at row 63: past it dt = 0, but
    // the scan sums those zeros in another order, and an ulp of cum is a
    // relative error of every exp(cum[last] − cum[s]) and of the decay
    const int lr = min(CL, S - c * CL) - 1;
    const float l0 = __shfl_sync(FULL, k.c0, lr / 2), l1 = __shfl_sync(FULL, k.c1, lr / 2);
    const float last = lr % 2 ? l1 : l0;
    const float w0 = expf(last - k.c0) * k.d0, w1 = expf(last - k.c1) * k.d1;
    const uint32_t xs = ring + (c % stages) * 2 * BOX_BYTES, bs = xs + BOX_BYTES;
    mbar_wait(full + 8 * (c % stages), (c / stages) & 1);

    // A fragments of (w∘x)ᵀ in TERMS bf16 terms: row p = 16·warp + g (+8
    // for a odd), tokens 16kk + 2t (+8 for a ≥ 2) and the one after
    uint32_t wx[4][4][TERMS];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = 16 * kk + 8 * half + 2 * t;
        const float ws0 = __shfl_sync(FULL, w0, s / 2), ws1 = __shfl_sync(FULL, w1, s / 2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int p = warp * 16 + g + 8 * i;
          split_terms(ws0 * ld_shared_bf16(xs + sw128_offset(s, p)),
                      ws1 * ld_shared_bf16(xs + sw128_offset(s + 1, p)), wx[kk][2 * half + i]);
        }
      }
    float big[32], small[32];
    zero(big);
    zero(small);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = sw128_desc(bs + kk * 16 * 128, BOX_BYTES, 1024);
#pragma unroll
      for (int term = 0; term < TERMS; ++term) {
        const uint32_t af[4] = {wx[kk][0][term], wx[kk][1][term], wx[kk][2][term],
                                wx[kk][3][term]};
        if (term == 0)
          wgmma_rs_n64(big, af, d);
        else
          wgmma_rs_n64(small, af, d);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(big);
    reg_fence(small);
    __syncthreads();                                 // every thread is done with the stage
    if (tid == 0 && c + stages < nc) load(c + stages);
    if (c > 0) {
      float4* st = reinterpret_cast<float4*>(states + state_offset(b, c, head, pt, nc, H, PS, N));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        st[(8 * q + j) * WG + tid] =
            make_float4(h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3]);
    }
    const float decay = expf(last);
#pragma unroll
    for (int i = 0; i < 32; ++i) h[i] = h[i] * decay + (big[i] + small[i]);
  }
  float* hh = hout + (static_cast<size_t>(b) * H + head) * P * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    store_state4(hh, P, N, pt, 64 * q + 8 * j, tid,
                 make_float4(h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3]));
}

// Pass 2: y of chunk c for 64 head dims of one head. C·h_inᵀ (no state
// enters chunk 0) scaled by exp(cum[t]), then M·x with M = (C·Bᵀ)
// exp(cum[t] − cum[s]) dt[s], s ≤ t; the first bf16 term of h_in and of M
// into one accumulator, the rest into another, added on the CUDA cores.
template <int N>
__device__ __forceinline__ void output_body(const CUtensorMap* tx, const CUtensorMap* tb,
                                            const CUtensorMap* tc,
                                            const float* __restrict__ dt,
                                            const float* __restrict__ A,
                                            const float* __restrict__ states,
                                            float* __restrict__ y, int c, int pt, int head, int b,
                                            int S, int H, int P, int nc, uint32_t smem,
                                            uint32_t bar) {
  constexpr uint32_t TILE_BYTES = (N / 64) * BOX_BYTES;   // 64 rows of B, C or the state
  const int PS = (P + PT - 1) / PT;
  const int c0 = c * CL, nt = min(CL, S - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const uint32_t cs = smem, bs = cs + TILE_BYTES, xs = bs + TILE_BYTES;
  const uint32_t hs = xs + BOX_BYTES;                  // h_in's TERMS tiles (TILE_BYTES each)
  if (tid == 0) {
    prefetch_map(tx);
    prefetch_map(tb);
    prefetch_map(tc);
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar, BOX_BYTES + 2 * TILE_BYTES);
    tma_load(xs, tx, bar, PT * pt, head, c0, b);
    for (int k = 0; k < N / 64; ++k) {
      tma_load(bs + k * BOX_BYTES, tb, bar, 64 * k, 0, c0, b);
      tma_load(cs + k * BOX_BYTES, tc, bar, 64 * k, 0, c0, b);
    }
  }
  if (c > 0) {
    // h_in as TERMS bf16 tiles, K-major (rows p, columns n) in the
    // swizzled layout the descriptors read; written by threads, read by
    // wgmma
    const float4* sp = reinterpret_cast<const float4*>(states +
                                                       state_offset(b, c, head, pt, nc, H, PS, N));
    const int r = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float4 v = sp[j * WG + tid];
      uint32_t t0[TERMS], t1[TERMS];
      split_terms(v.x, v.y, t0);
      split_terms(v.z, v.w, t1);
#pragma unroll
      for (int term = 0; term < TERMS; ++term) {
        st_shared_u32(hs + term * TILE_BYTES + sw128_offset(r, 8 * j + 2 * t), t0[term]);
        st_shared_u32(hs + term * TILE_BYTES + sw128_offset(r + 8, 8 * j + 2 * t), t1[term]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  const ChunkScan k =
      chunk_scan(load_dt(dt + (static_cast<size_t>(b) * S + c0) * H + head, H, nt), A[head]);
  // cum of this thread's rows r0 = 16·warp + g and r0 + 8
  float cr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int src = (warp * 16 + g + 8 * i) / 2;
    const float v0 = __shfl_sync(FULL, k.c0, src), v1 = __shfl_sync(FULL, k.c1, src);
    cr[i] = g % 2 ? v1 : v0;
  }
  __syncthreads();
  mbar_wait(bar, 0);

  uint32_t ca[N / 16][4];                              // C as A fragments, per 16 columns
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const uint32_t addr =
          cs + sw128_offset(warp * 16 + g + 8 * (a & 1), 16 * kk + 2 * t + 8 * (a >> 1));
      asm volatile("ld.shared.b32 %0, [%1];" : "=r"(ca[kk][a]) : "r"(addr) : "memory");
    }
  // CB = C·Bᵀ, its k-steps dealt round three accumulators and summed on
  // the CUDA cores: each tensor-core step truncates the sum it adds to,
  // and eight steps into one accumulator put mamba2's logits past their
  // limit (see the note at the top)
  float sc[32], big[32], small[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t d = sw128_desc(bs + (kk / 4) * BOX_BYTES + (kk % 4) * 32, 16, 1024);
    if (kk % 3 == 0)
      wgmma_rs_n64_k(sc, ca[kk], d, kk > 2);
    else if (kk % 3 == 1)
      wgmma_rs_n64_k(big, ca[kk], d, kk > 2);
    else
      wgmma_rs_n64_k(small, ca[kk], d, kk > 2);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(sc);
  reg_fence(big);
  reg_fence(small);
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] += big[j] + small[j];
  wgmma_fence();
  if (c > 0) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
#pragma unroll
      for (int term = 0; term < TERMS; ++term) {
        const uint64_t d = sw128_desc(hs + term * TILE_BYTES + off, 16, 1024);
        if (term == 0)
          wgmma_rs_n64_k(big, ca[kk], d, kk > 0);
        else
          wgmma_rs_n64_k(small, ca[kk], d, kk > 0 || term > 1);
      }
    }
    wgmma_commit();
  }
  // M in CB's registers: sc[4n + e] is row r0 + 8 (e ≥ 2), token 8n + 2t
  // + (e & 1); exp only where s ≤ t
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int src = 4 * n + t;
    const float cs0 = __shfl_sync(FULL, k.c0, src), cs1 = __shfl_sync(FULL, k.c1, src);
    const float ds0 = __shfl_sync(FULL, k.d0, src), ds1 = __shfl_sync(FULL, k.d1, src);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e / 2, s = 8 * n + 2 * t + (e & 1), r = warp * 16 + g + 8 * i;
      const float cs_ = e & 1 ? cs1 : cs0, ds_ = e & 1 ? ds1 : ds0;
      sc[4 * n + e] = s <= r ? sc[4 * n + e] * expf(cr[i] - cs_) * ds_ : 0.f;
    }
  }
  uint32_t mt[4][4][TERMS];                            // M as A fragments, per 16 tokens
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) split_terms(sc[8 * kk + 2 * a], sc[8 * kk + 2 * a + 1], mt[kk][a]);
  if (c > 0) {
    wgmma_wait<0>();
    reg_fence(big);
    reg_fence(small);
    const float er[2] = {expf(cr[0]), expf(cr[1])};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      big[j] *= er[(j >> 1) & 1];
      small[j] *= er[(j >> 1) & 1];
    }
  } else {
    zero(big);
    zero(small);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d = sw128_desc(xs + kk * 16 * 128, BOX_BYTES, 1024);
#pragma unroll
    for (int term = 0; term < TERMS; ++term) {
      const uint32_t af[4] = {mt[kk][0][term], mt[kk][1][term], mt[kk][2][term], mt[kk][3][term]};
      if (term == 0)
        wgmma_rs_n64(big, af, d);
      else
        wgmma_rs_n64(small, af, d);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(big);
  reg_fence(small);

  // y in f32, rows past S and head dims past P not written
  const size_t row = static_cast<size_t>(H) * P;
  float* yb = y + (static_cast<size_t>(b) * S + c0) * row + static_cast<size_t>(head) * P + PT * pt;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i, col = 8 * n + 2 * t;
      if (r < nt && PT * pt + col < P)
        *reinterpret_cast<float2*>(yb + r * row + col) =
            make_float2(big[4 * n + 2 * i] + small[4 * n + 2 * i],
                        big[4 * n + 2 * i + 1] + small[4 * n + 2 * i + 1]);
    }
}

// The dynamic shared memory is declared 16-byte aligned and each kernel
// rounds its base up to 1024 bytes (the swizzle atom) within 1 KB of
// slack: a 1024-byte aligned declaration would raise the CUDA-core
// kernel's base in this file too, past its 48 KB without the opt-in at
// N = 32.
__device__ __forceinline__ uint32_t smem_base(const uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// grid (N / 64 · head-dim tiles, H, B), one warpgroup a block
template <int N>
__global__ void __launch_bounds__(WG)
ssd_state_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 float* __restrict__ states, float* __restrict__ hout, int S, int H, int P,
                 int nc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int PS = (P + PT - 1) / PT;
  state_body(&tx, &tb, dt, A, states, hout, blockIdx.x / PS, blockIdx.x % PS, blockIdx.y,
             blockIdx.z, S, H, P, N, nc, smem_base(smem_raw), smem_u32(full));
}

// grid (chunks, H · head-dim tiles, B), one warpgroup a block
template <int N>
__global__ void __launch_bounds__(WG)
ssd_output_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tc, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ states,
                  float* __restrict__ y, int S, int H, int P, int nc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  const int PS = (P + PT - 1) / PT;
  output_body<N>(&tx, &tb, &tc, dt, A, states, y, blockIdx.x, blockIdx.y % PS, blockIdx.y / PS,
                 blockIdx.z, S, H, P, nc, smem_base(smem_raw), smem_u32(&bar));
}

// S ≤ 64: grid ((N / 64 + 1) · head-dim tiles, H, B); the first N / 64 ·
// tiles blocks of a head write its final state, the others its output
template <int N>
__global__ void __launch_bounds__(WG)
ssd_single_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tc, const float* __restrict__ dt,
                  const float* __restrict__ A, float* __restrict__ y, float* __restrict__ hout,
                  int S, int H, int P) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  const int PS = (P + PT - 1) / PT, role = blockIdx.x;
  if (role < (N / 64) * PS)
    state_body(&tx, &tb, dt, A, nullptr, hout, role / PS, role % PS, blockIdx.y, blockIdx.z, S,
               H, P, N, 1, smem_base(smem_raw), smem_u32(&bar));
  else
    output_body<N>(&tx, &tb, &tc, dt, A, nullptr, y, 0, role - (N / 64) * PS, blockIdx.y,
                   blockIdx.z, S, H, P, 1, smem_base(smem_raw), smem_u32(&bar));
}

// The tensor cores take bf16 x/B/C with P % 16 == 0, N 64 or 128 and at
// most 65535 blocks of 64 head dims across the heads; any other input
// runs the CUDA-core kernel.
bool tensor_core_path(int x_dtype, int H, int P, int N) {
  return x_dtype == 1 && P % 16 == 0 && (N == 64 || N == 128) &&
         static_cast<long long>(H) * ((P + PT - 1) / PT) <= 65535;
}

// floats of scratch the tensor-core path needs: the state entering each
// chunk when there is more than one
size_t scratch_floats(int B, int S, int H, int P, int N) {
  const size_t nc = (S + CL - 1) / CL, PS = (P + PT - 1) / PT;
  return nc > 1 ? B * nc * H * PS * PT * N : 0;
}

template <int N>
int launch_tensor_cores(const void* x, const float* dt, const float* A, const void* Bm,
                        const void* C, float* y, float* h, float* scratch, size_t scratch_bytes,
                        int B, int S, int H, int P, cudaStream_t st) {
  constexpr uint32_t TILE_BYTES = (N / 64) * BOX_BYTES;
  if (S == 0) {                                  // no token: the zero state
    const cudaError_t err =
        cudaMemsetAsync(h, 0, sizeof(float) * static_cast<size_t>(B) * H * P * N, st);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tx, tb, tc;
  CUresult res = encode_bshd(encode, &tx, x, B, S, H, P);
  if (res == CUDA_SUCCESS) res = encode_bshd(encode, &tb, Bm, B, S, 1, N);
  if (res == CUDA_SUCCESS) res = encode_bshd(encode, &tc, C, B, S, 1, N);
  if (res != CUDA_SUCCESS) return static_cast<int>(res);
  const int nc = (S + CL - 1) / CL, PS = (P + PT - 1) / PT;
  const size_t out_smem = (2 + TERMS) * TILE_BYTES + BOX_BYTES + 1024;
  cudaError_t err;
  if (nc == 1) {
    const size_t smem = 2 * TILE_BYTES + BOX_BYTES + 1024;    // ≥ one state stage
    if ((err = allow_smem(ssd_single_kernel<N>, smem)) != cudaSuccess) return err;
    ssd_single_kernel<N><<<dim3((N / 64 + 1) * PS, H, B), WG, smem, st>>>(tx, tb, tc, dt, A, y,
                                                                           h, S, H, P);
    return cudaGetLastError();
  }
  if (scratch == nullptr || scratch_bytes < sizeof(float) * scratch_floats(B, S, H, P, N))
    return cudaErrorInvalidValue;
  const size_t state_smem = (nc < STAGES ? nc : STAGES) * 2 * BOX_BYTES + 1024;
  if ((err = allow_smem(ssd_state_kernel<N>, state_smem)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_output_kernel<N>, out_smem)) != cudaSuccess) return err;
  ssd_state_kernel<N><<<dim3((N / 64) * PS, H, B), WG, state_smem, st>>>(tx, tb, dt, A, scratch,
                                                                         h, S, H, P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_output_kernel<N><<<dim3(nc, H * PS, B), WG, out_smem, st>>>(tx, tb, tc, dt, A, scratch, y,
                                                                 S, H, P, nc);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x_dtype (x, B, C): 0 = float32, 1 = bfloat16; dt and A are float32.
// y (B,S,H,P) and h (B,H,P,N) are float32. The CUDA-core kernel alone,
// on any input it takes: what ssd_scan_forward runs off the tensor-core
// path (chip_smoke.py also times it on that path's inputs, as the kernel
// the tensor-core path replaced). Returns cudaGetLastError().
extern "C" int ssd_scan_cuda_core_forward(const void* x, const void* dt, const void* A,
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
  if (x_dtype == 0)
    return repro::launch_cuda_core<float>(x, dtf, af, Bm, C, yf, hf, batch, S, H, P, N, st);
  if (x_dtype == 1)
    return repro::launch_cuda_core<__nv_bfloat16>(x, dtf, af, Bm, C, yf, hf, batch, S, H, P, N,
                                                  st);
  return cudaErrorInvalidValue;
}

// Bytes of f32 scratch ssd_scan_forward needs for these inputs: on the
// tensor-core path B · ceil(S/64) · H · ceil(P/64) · 64 · N floats when
// S > 64 (the state entering each chunk), else 0; -1 when the inputs take
// the CUDA-core kernel, which needs none.
extern "C" long long ssd_scan_scratch_bytes(int x_dtype, int batch, int S, int H, int P,
                                            int N) {
  if (batch <= 0 || S < 0 || H <= 0 || !repro::tensor_core_path(x_dtype, H, P, N)) return -1;
  return static_cast<long long>(sizeof(float) * repro::scratch_floats(batch, S, H, P, N));
}

// ssd_scan_forward picks the path: the tensor cores where
// tensor_core_path holds (x, B and C 16-byte aligned, which TMA needs),
// with the scratch that ssd_scan_scratch_bytes sizes (scratch_bytes is
// checked against it); else the CUDA-core kernel, with no scratch.
// Returns cudaGetLastError() after the last launch, or the failed
// cuTensorMapEncodeTiled's code.
extern "C" int ssd_scan_forward(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* C, void* y, void* h,
                                void* scratch, long long scratch_bytes, int x_dtype, int batch,
                                int S, int H, int P, int N, void* stream) {
  if (!repro::tensor_core_path(x_dtype, H, P, N))
    return ssd_scan_cuda_core_forward(x, dt, A, Bm, C, y, h, x_dtype, batch, S, H, P, N, stream);
  if (P <= 0 || H <= 0 || batch <= 0 || S < 0 || H > 65535 || batch > 65535 ||
      scratch_bytes < 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
       reinterpret_cast<uintptr_t>(C)) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  float* sf = static_cast<float*>(scratch);
  const size_t sb = static_cast<size_t>(scratch_bytes);
  return N == 64 ? repro::launch_tensor_cores<64>(x, dtf, af, Bm, C, yf, hf, sf, sb, batch, S, H,
                                                  P, st)
                 : repro::launch_tensor_cores<128>(x, dtf, af, Bm, C, yf, hf, sf, sb, batch, S,
                                                   H, P, st);
}
