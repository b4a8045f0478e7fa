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
// plain decode_attention does; a row with no visible key comes out 0.
//
// Layout: q (B,1,Hq,hd) f32 or bf16, caches (B,S,Hkv,hd) f32 or bf16,
// out (B,1,Hq,hd) in the cache dtype. hd <= 256, hd % 4 == 0, G <= 16.
//
// What bounds it on the card: the bytes of the cache rows it reads. Each
// k/v element serves G = Hq/Hkv query heads only, far below the card's
// ~295 operations per byte, so it is a streaming read, and what sets its
// time is how many bytes are in flight across the SMs. The TPU kernel
// walks a row's cache in kv_block segments one after another, carrying
// (m, l, acc) in scratch; a grid of one block per (b, kv head) does the
// same here and leaves most SMs idle while the longest row streams
// through one SM. So the cache length is split over blocks (split-K):
//  - split pass: a block per (kv head, b, split), the split slowest so
//    the first splits, which every row with keys needs, reach the SMs
//    first, owns split_rows consecutive cache rows of one (b, kv head); a
//    block whose rows lie wholly outside [lo, clen) returns at once and
//    writes nothing. Each of its 8 warps takes chunks of UNROLL
//    consecutive rows (8 at hd <= 128 and G <= 8: 64 rows a block in one
//    step; 4 otherwise, where the G heads' q and acc take the registers): a
//    lane loads one or two 16-byte quads of each k and v row, so a warp
//    reads a whole row in one coalesced transaction and keeps 2 x UNROLL
//    rows in flight; the G query heads reuse each loaded row from
//    registers; a score is a 5-step xor-shuffle reduction. The warps'
//    (m, l, acc) merge through shared memory into the split's partial
//    state, written in f32 to a scratch of shape (B, Hkv, nsplit, G,
//    hd + 2): acc, then m, then l;
//  - merge pass: a block per (b, kv head) reads the partials of only the
//    splits that meet [lo, clen), recomputed from cache_len, and merges
//    them with the log-sum-exp rule (repro/models/attention.py's
//    decode_attention_context_parallel): M = max m_j, out = sum acc_j
//    e^(m_j - M) / max(sum l_j e^(m_j - M), 1e-30), 0 for an empty row.
//    It is a programmatic dependent launch (Hopper's griddepcontrol), so
//    its blocks are set up while the split pass drains and wait on the
//    card, not on the host, for the partials.
// G is a template parameter rounded up to 1, 2, 4, 8 or 16 (glm4-9b's 32
// q heads over 2 kv heads). At G = 16 a lane holds 16 heads' q and acc,
// 128 registers at hd 128 and 256 at hd 256, so hd 256 spills to local
// memory (correct, slower; ptxas -v prints it in the build log), and the
// warps' states need WARPS x G x hd floats of shared memory: 64 KB at hd
// 128, 128 KB at hd 256, under the 227 KB a block may take.
// split_rows is the caller's, a function of the shapes only
// (decode_attention/ops.py::split_rows), so the host never reads
// cache_len. split_rows = S is the one-split schedule (a block per
// (b, kv head), the grid this kernel had before its split).
#include "common.cuh"

namespace repro {
namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <typename TC, int HD, int GT>
__global__ void __launch_bounds__(THREADS, (HD <= 128 && GT <= 2) ? 2 : 1)
decode_split_kernel(const void* __restrict__ q, int q_bf16,
                    const TC* __restrict__ kc, const TC* __restrict__ vc,
                    const int* __restrict__ cache_len, float* __restrict__ part,
                    int S, int Hq, int Hkv, int hd, int G, int rows, int nsplit,
                    int window, float scale, float softcap) {
  constexpr int QPL = (HD + 127) / 128;          // quads per lane
  constexpr int UNROLL = (QPL == 1 && GT <= 8) ? 8 : 4;  // cache rows per warp per step
  extern __shared__ float smem[];

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int clen = min(max(cache_len[b], 0), S);
  const int lo = window > 0 ? max(0, clen - window) : 0;
  const int r0 = split * rows;
  const int first = max(r0, lo), end = min(r0 + rows, clen);
  if (first >= end) return;                      // block-uniform: no row to read

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nquad = hd / 4;
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

  const long rstride = static_cast<long>(Hkv) * hd;     // one cache row, all kv heads
  const TC* kb = kc + static_cast<long>(b) * S * rstride + static_cast<long>(hk) * hd;
  const TC* vb = vc + static_cast<long>(b) * S * rstride + static_cast<long>(hk) * hd;

  for (int base = first + warp * UNROLL; base < end; base += WARPS * UNROLL) {
    float4 kk[UNROLL][QPL], vv[UNROLL][QPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int t = 0; t < QPL; ++t) {
        const int quad = lane + 32 * t;
        kk[u][t] = vv[u][t] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (base + u < end && quad < nquad) {
          kk[u][t] = load4(kb + (base + u) * rstride + 4 * quad);
          vv[u][t] = load4(vb + (base + u) * rstride + 4 * quad);
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
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < QPL; ++t) dot += dot4(qf[g][t], kk[u][t]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = base + u < end ? apply_softcap(dot, softcap) : NEG_INF;
        m_new = fmaxf(m_new, s[u]);
      }
      const float corr = expf(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int t = 0; t < QPL; ++t) acc[g][t] = scale4(acc[g][t], corr);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = base + u < end ? expf(s[u] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int t = 0; t < QPL; ++t) acc[g][t] = axpy4(acc[g][t], 1.f, p, vv[u][t]);
      }
      m[g] = m_new;
    }
  }

  // merge the warps' states, acc (WARPS,G,hd), m, l (WARPS,G), into the
  // split's partial; a warp with no row holds m = NEG_INF, l = 0, acc = 0
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
  float* pp = part + ((static_cast<long>(b) * Hkv + hk) * nsplit + split) * G * (hd + 2);
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
    float* pg = pp + g * (hd + 2);
    pg[d] = num;
    if (d == 0) {
      pg[hd] = mx;
      pg[hd + 1] = den;
    }
  }
  // this block's partial is written: once every block is here (or has
  // returned), the merge pass may start its launch; it still waits for
  // this grid's writes (griddepcontrol.wait) before it reads them
  asm volatile("griddepcontrol.launch_dependents;");
}

// One block per (b, kv head): the LSE merge of the splits that met
// [lo, clen), in split order, into the output in the cache dtype.
template <typename TC>
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(const float* __restrict__ part, const int* __restrict__ cache_len,
                    TC* __restrict__ o, int S, int Hkv, int hd, int G, int rows,
                    int nsplit, int window) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int clen = min(max(cache_len[b], 0), S);
  const int lo = window > 0 ? max(0, clen - window) : 0;
  const int j0 = lo / rows, j1 = clen > lo ? (clen - 1) / rows + 1 : j0;
  const float* pb = part + (static_cast<long>(b) * Hkv + hk) * nsplit * G * (hd + 2);
  TC* op = o + (static_cast<long>(b) * Hkv + hk) * G * hd;
  const int stride = G * (hd + 2);
  // launched as a programmatic dependent of the split pass: wait for its
  // partials (a no-op when launched in plain stream order)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int idx = threadIdx.x; idx < G * hd; idx += THREADS) {
    const int g = idx / hd, d = idx % hd;
    const float* pg = pb + g * (hd + 2);
    float mx = NEG_INF;
    for (int j = j0; j < j1; ++j) mx = fmaxf(mx, pg[j * stride + hd]);
    float den = 0.f, num = 0.f;
    for (int j = j0; j < j1; ++j) {
      const float c = expf(pg[j * stride + hd] - mx);
      den += pg[j * stride + hd + 1] * c;
      num += pg[j * stride + d] * c;
    }
    store1(op + idx, num / fmaxf(den, 1e-30f));
  }
}

struct Args {
  const void* q;
  int q_bf16;
  const void *k, *v;
  const int* clen;
  void* o;
  float* part;
  int B, S, Hq, Hkv, hd, G, rows, window;
  float scale, softcap;
  cudaStream_t stream;
};

template <typename TC, int HD, int GT>
cudaError_t launch(const Args& a) {
  const int nsplit = max(1, (a.S + a.rows - 1) / a.rows);
  const size_t smem = sizeof(float) * (static_cast<size_t>(WARPS) * a.G * a.hd + 2 * WARPS * a.G);
  auto kernel = decode_split_kernel<TC, HD, GT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // split slowest: the blocks of the first splits, which every row with
  // keys needs, are handed to the SMs first
  kernel<<<dim3(a.Hkv, a.B, nsplit), THREADS, smem, a.stream>>>(
      a.q, a.q_bf16, static_cast<const TC*>(a.k), static_cast<const TC*>(a.v), a.clen, a.part,
      a.S, a.Hq, a.Hkv, a.hd, a.G, a.rows, nsplit, a.window, a.scale, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge pass as a programmatic dependent launch: its blocks are
  // set up while the split pass drains
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_merge_kernel<TC>, static_cast<const float*>(a.part),
                           a.clen, static_cast<TC*>(a.o), a.S, a.Hkv, a.hd, a.G, a.rows,
                           nsplit, a.window);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TC, int HD>
cudaError_t dispatch_groups(const Args& a) {
  if (a.G <= 1) return launch<TC, HD, 1>(a);
  if (a.G <= 2) return launch<TC, HD, 2>(a);
  if (a.G <= 4) return launch<TC, HD, 4>(a);
  if (a.G <= 8) return launch<TC, HD, 8>(a);
  if (a.G <= 16) return launch<TC, HD, 16>(a);
  return cudaErrorInvalidValue;
}

template <typename TC>
cudaError_t dispatch_hd(const Args& a) {
  if (a.hd <= 64) return dispatch_groups<TC, 64>(a);
  if (a.hd <= 128) return dispatch_groups<TC, 128>(a);
  if (a.hd <= 256) return dispatch_groups<TC, 256>(a);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// q_dtype / c_dtype: 0 = float32, 1 = bfloat16. cache_len: (B,) int32 on
// the device. scratch: B * Hkv * nsplit * G * (hd + 2) floats, nsplit =
// ceil(S / split_rows) (at least 1). window <= 0 means none; softcap <= 0
// means none. Two launches on one stream, the split pass and the merge
// pass; returns cudaGetLastError() after them.
extern "C" int decode_forward(const void* q, const void* k, const void* v,
                              const void* cache_len, void* o, void* scratch, int q_dtype,
                              int c_dtype, int B, int S, int Hq, int Hkv, int hd,
                              int split_rows, int window, float scale, float softcap,
                              void* stream) {
  if (hd % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0 || q_dtype < 0 || q_dtype > 1 ||
      split_rows <= 0 || B > 65535 || (S + split_rows - 1) / split_rows > 65535)
    return cudaErrorInvalidValue;
  const repro::Args a{q, q_dtype, k, v, static_cast<const int*>(cache_len), o,
                      static_cast<float*>(scratch), B, S, Hq, Hkv, hd, Hq / Hkv,
                      split_rows, window, scale, softcap, static_cast<cudaStream_t>(stream)};
  if (c_dtype == 0) return repro::dispatch_hd<float>(a);
  if (c_dtype == 1) return repro::dispatch_hd<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
